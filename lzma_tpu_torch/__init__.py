"""lzma_tpu_torch — the device block codec of ``lzma_tpu`` in PyTorch and CUDA.

A second package beside the JAX one.  It imports ``torch`` and never
``jax``, and nothing of ``lzma_tpu``: what it needs of that package's
jax-free modules it keeps as its own copies under the same names
(``core``, ``format``, ``parallel.blocks``, ``bench``), held equal to the
originals by the tests, so both packages write and read the same
containers.

- ``ops``      the lane-parallel codec: lazy and optimal-parse tokenizers,
               classify + bit lowering, range encoder and decoder (plain
               PyTorch versions beside the CUDA kernels that replace the
               TPU's Pallas kernels)
- ``runtime``  builds ``csrc/*.cu`` with ``nvcc`` and loads it with ctypes
- ``csrc``     the hand-written Hopper (sm_90a) kernels
"""

__version__ = "0.1.0"
