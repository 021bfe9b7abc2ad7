"""7-Zip-compatible benchmark ratings (LzmaBench.java:226-302).

The port's own copy of ``lzma_tpu/bench/rating.py``, held equal to it by
the tests."""

from __future__ import annotations

_SUB_BITS = 8


def _log_size(size: int) -> int:
    for i in range(_SUB_BITS, 32):
        for j in range(1 << _SUB_BITS):
            if size <= (1 << i) + (j << (i - _SUB_BITS)):
                return (i << _SUB_BITS) + j
    return 32 << _SUB_BITS


def _mult_div(value: int, elapsed_ms: float) -> int:
    if elapsed_ms <= 0:
        elapsed_ms = 1
    return int(value * 1000 / elapsed_ms)


def compress_rating(dict_size: int, elapsed_ms: float, size: int) -> int:
    """size * (1060 + t^2*10/2^16) / time (LzmaBench.java:252-257)."""
    t = _log_size(dict_size) - (18 << _SUB_BITS)
    num_commands_per_byte = 1060 + ((t * t * 10) >> (2 * _SUB_BITS))
    return _mult_div(size * num_commands_per_byte, elapsed_ms)


def decompress_rating(elapsed_ms: float, out_size: int, in_size: int) -> int:
    """in*220 + out*20 per byte (LzmaBench.java:259-262)."""
    return _mult_div(in_size * 220 + out_size * 20, elapsed_ms)


def total_rating(
    dict_size: int,
    enc_ms: float,
    enc_size: int,
    dec_ms: float,
    dec_in: int,
    dec_out: int,
) -> int:
    return (
        compress_rating(dict_size, enc_ms, enc_size)
        + decompress_rating(dec_ms, dec_out, dec_in)
    ) // 2


def speed_kb_s(size: int, elapsed_ms: float) -> int:
    return _mult_div(size, elapsed_ms) // 1024
