"""lzma_tpu_torch — the device block codec of ``lzma_tpu`` in PyTorch and CUDA.

A second package beside the JAX one.  It imports ``torch`` and never
``jax``; the jax-free parts of ``lzma_tpu`` (``core``, ``format``,
``parallel.blocks``, ``bench``) are imported, not copied, so both
packages share one container format, one probability layout and one set
of parameters.

- ``ops``      the lane-parallel codec: lazy tokenizer, classify + bit
               lowering, range encoder and decoder (plain PyTorch
               versions beside the CUDA kernels that replace the TPU's
               Pallas kernels)
- ``runtime``  builds ``csrc/*.cu`` with ``nvcc`` and loads it with ctypes
- ``csrc``     the hand-written Hopper (sm_90a) kernels
"""

__version__ = "0.1.0"
