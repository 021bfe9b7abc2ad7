"""Deterministic LZ-structured synthetic benchmark data.

The port's own copy of ``lzma_tpu/bench/datagen.py``: the reference
benchmark's generator (LzmaBench.java:15-128), a multiply-with-carry PRNG
feeding a bit reader that emits a literal/match mixture.  Byte-identical
to the original for the same size.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


class MwcRandom:
    """Two-stream multiply-with-carry PRNG (LzmaBench.java:15-33)."""

    def __init__(self):
        self.a1 = 362436069
        self.a2 = 521288629

    def next(self) -> int:
        self.a1 = (36969 * (self.a1 & 0xFFFF) + (self.a1 >> 16)) & _M32
        self.a2 = (18000 * (self.a2 & 0xFFFF) + (self.a2 >> 16)) & _M32
        return ((self.a1 << 16) ^ self.a2) & _M32


class BitRandom:
    """Bit-window view over MwcRandom (LzmaBench.java:35-61)."""

    def __init__(self):
        self.rg = MwcRandom()
        self.value = 0
        self.num_bits = 0

    def bits(self, n: int) -> int:
        if self.num_bits > n:
            result = self.value & ((1 << n) - 1)
            self.value >>= n
            self.num_bits -= n
            return result
        n -= self.num_bits
        result = (self.value << n) & _M32
        self.value = self.rg.next()
        result |= self.value & ((1 << n) - 1)
        self.value >>= n
        self.num_bits = 32 - n
        return result


def generate_bench_data(size: int) -> bytes:
    """LZ-structured stream (LzmaBench.java:104-127)."""
    rg = BitRandom()
    buf = bytearray(size)
    pos = 0
    rep0 = 1

    def log_rand_bits(n: int) -> int:
        ln = rg.bits(n)
        return rg.bits(ln)

    def offset() -> int:
        if rg.bits(1) == 0:
            return log_rand_bits(4)
        return (log_rand_bits(4) << 10) | rg.bits(10)

    while pos < size:
        if rg.bits(1) == 0 or pos < 1:
            buf[pos] = rg.bits(8)
            pos += 1
        else:
            if rg.bits(3) == 0:
                ln = 1 + rg.bits(1 + rg.bits(2))
            else:
                while True:
                    rep0 = offset()
                    if rep0 < pos:
                        break
                rep0 += 1
                ln = 2 + rg.bits(2 + rg.bits(2))
            for _ in range(ln):
                if pos >= size:
                    break
                buf[pos] = buf[pos - rep0]
                pos += 1
    return bytes(buf)
