"""lzma_tpu_torch — the device codec of ``lzma_tpu`` in PyTorch and CUDA.

A second package beside the JAX one.  It imports ``torch`` and never
``jax``, and nothing of ``lzma_tpu``: what it needs of that package's
jax-free modules it keeps as its own copies under the same names
(``core``, ``format``, ``parallel.blocks``, ``bench``,
``utils.dicttrain``), held equal to the originals by the tests, so both
packages write and read the same `.lzma` streams and LZTB containers.

- ``ops``      the lane-parallel codec: lazy and optimal-parse tokenizers,
               classify + bit lowering, range encoder and decoder (plain
               PyTorch versions beside the CUDA kernels that replace the
               TPU's Pallas kernels and its compiled classify scan)
- ``runtime``  builds ``csrc/*.cu`` with ``nvcc`` and loads it with ctypes
- ``csrc``     the hand-written Hopper (sm_90a) kernels
- ``cli``      the LzmaAlone command line on the device codec
               (``python -m lzma_tpu_torch``)
- ``entry``    the lane encode step and its example batch

``compress``/``decompress`` are the front door, on the card unless the
caller passes ``device="cpu"``.
"""

from .format.properties import LzmaParams, decode_props  # noqa: F401

__version__ = "0.1.0"


def compress(data: bytes, params: LzmaParams | None = None,
             container: str = "lztb", block_size: int = 1 << 20,
             preset_len: int = 0, dictionary: bytes = b"", train_dict=0,
             backend: str = "device", device="cuda") -> bytes:
    """Compress in memory into the block-parallel LZTB container, as
    ``lzma_tpu.compress(container="lztb", backend="device")``: the
    optimal parse, every block a lane.  `preset_len` shares the input's
    first bytes with every block after block 0 (LZTB v2); `dictionary`
    primes every block with a stored dictionary (LZTB v3); `train_dict=N`
    trains an N-byte one from the input.  `container` and `backend` are
    there only so that calls written for ``lzma_tpu.compress`` run
    unchanged: each takes one value ("lztb", "device"), and the default
    container is LZTB, where the reference's is "alone".  The port has
    only the device backend, which writes no `.lzma` file
    (``ops.api.encode_alone`` does); ``params="auto"`` and
    ``train_dict="auto"`` need the host codec and are not ported."""
    if backend != "device":
        raise ValueError(f"unknown backend: {backend!r} (the port has only "
                         'backend="device")')
    if params == "auto" or train_dict == "auto":
        raise NotImplementedError(
            '"auto" parameters and dictionaries need the host codec')
    if container == "alone":
        raise ValueError('backend="device" encodes the block-parallel LZTB '
                         'container; pass container="lztb"')
    if container != "lztb":
        raise ValueError(f"unknown container: {container!r}")
    if train_dict:
        if dictionary:
            raise ValueError("pass either dictionary= or train_dict=, not both")
        from .utils.dicttrain import train_dictionary

        dictionary = train_dictionary(data, train_dict)
    from .ops import api

    return api.encode_blocks(data, params or LzmaParams(),
                             block_size=block_size, preset_len=preset_len,
                             dictionary=dictionary, parse="optimal",
                             device=device)


def decompress(data: bytes, device="cuda") -> bytes:
    """Decompress a `.lzma` (LZMA_Alone) file or an LZTB container,
    told apart by the LZTB magic, on the device decoder."""
    from .ops import api

    if data[:4] == b"LZTB":
        return api.decode_blocks(data, device=device)
    return api.decode_alone(data, device=device)
