"""lzma_tpu_torch — the device codec of ``lzma_tpu`` in PyTorch and CUDA.

A second package beside the JAX one.  It imports ``torch`` and never
``jax``, and nothing of ``lzma_tpu``: what it needs of that package's
jax-free modules it keeps as its own copies under the same names
(``core``, ``format``, ``parallel.blocks``, ``bench``,
``utils.{autotune,crc,dicttrain}``), held equal to the originals by the
tests, so both packages write and read the same `.lzma` streams and LZTB
containers and choose the same parameters.

- ``ops``      the lane-parallel codec: lazy and optimal-parse tokenizers,
               classify + bit lowering, range encoder and decoder (plain
               PyTorch versions beside the CUDA kernels that replace the
               TPU's Pallas kernels and its compiled classify scan)
- ``runtime``  builds ``csrc/*.cu`` with ``nvcc`` and the hybrid's host
               encoder (``runtime/src/host_encoder.cpp``) with ``g++``,
               and loads both with ctypes
- ``csrc``     the hand-written Hopper (sm_90a) kernels
- ``utils``    trained and auto-sized dictionaries, lc/lp/pb selection,
               CRC-32, the decision trace, profiling
- ``bench``    the benchmark data, the text corpus, the `b` command's
               rating loop (``bench.harness``) and the kernels' A/B
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
             num_threads: int = 0, preset_len: int = 0,
             dictionary: bytes = b"", train_dict=0, backend: str = "device",
             device="cuda", **kw) -> bytes:
    """Compress in memory into the block-parallel LZTB container, as
    ``lzma_tpu.compress(container="lztb", backend=...)``.
    backend="device": the optimal parse on the card, every block a lane.
    backend="hybrid": the card's multi-tier candidate lists and the
    reference's optimal parse on the host, `num_threads` threads (all
    cores at 0; ``ops.hybrid.encode_blocks_hybrid_optimal``).
    `preset_len` shares the input's first bytes with every block after
    block 0 (LZTB v2); `dictionary` primes every block with a stored
    dictionary (LZTB v3); `train_dict=N` trains an N-byte one from the
    input.  `container` is there only so that calls written for
    ``lzma_tpu.compress`` run unchanged: it takes one value, "lztb", the
    default here, where the reference's is "alone" (``ops.api.encode_alone``
    writes a `.lzma` file).  Keyword arguments are ``LzmaParams`` fields
    (``dict_size=``, ``lc=``, ...) in place of `params`.
    ``params="auto"`` picks lc/lp/pb by measured cost on a spread sample
    of the input (``utils.autotune.select_params``; the keyword fields are
    its baseline), and ``train_dict="auto"`` trains a dictionary and sizes
    it against its storage cost, possibly to none
    (``utils.dicttrain.select_dictionary``); both size their candidates
    with the host encoder (``runtime.native``), and raise where it cannot
    be built."""
    if backend not in ("device", "hybrid"):
        raise ValueError(f"unknown backend: {backend!r} (the port has "
                         '"device" and "hybrid")')
    if container == "alone":
        raise ValueError(f'backend="{backend}" encodes the block-parallel '
                         'LZTB container; pass container="lztb"')
    if container != "lztb":
        raise ValueError(f"unknown container: {container!r}")
    if train_dict and dictionary:
        raise ValueError("pass either dictionary= or train_dict=, not both")
    if params == "auto":
        from .utils.autotune import select_params

        params = select_params(data, LzmaParams(**kw) if kw else None,
                               block_size=block_size)
        kw = {}
    params = params or (LzmaParams(**kw) if kw else None)
    if train_dict == "auto":
        from .utils.dicttrain import select_dictionary

        dictionary = select_dictionary(data, params, block_size=block_size)
    elif train_dict:
        from .utils.dicttrain import train_dictionary

        dictionary = train_dictionary(data, train_dict)
    if backend == "hybrid":
        from .ops.hybrid import encode_blocks_hybrid_optimal

        return encode_blocks_hybrid_optimal(
            data, params, block_size=block_size, num_threads=num_threads,
            preset_len=preset_len, dictionary=dictionary, device=device)
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
