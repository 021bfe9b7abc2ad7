"""Self-validating benchmark loop (LzmaBenchmark, LzmaBench.java:304-403).

The port's own copy of ``lzma_tpu/bench/harness.py`` (held equal to it by
the tests): encode/decode passes over deterministic LZ-structured data
with CRC-32 checks (two decodes per encode, like the reference),
reporting KB/s and 7-Zip MIPS ratings per pass and on average.  The
loop and the report are the original's.  Its default codec differs: the
port has no scalar codec, so with no `encode_fn`/`decode_fn` the harness
rates the device codec (``ops.api.encode_stream``/``decode_stream``, one
lane) on `device`, the card unless the caller names another.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..format.properties import LzmaParams
from ..ops import api
from ..utils.crc import crc32
from .datagen import generate_bench_data
from .rating import compress_rating, decompress_rating, speed_kb_s

ADDITIONAL_SIZE = 1 << 21  # LzmaBench.java:12


@dataclass
class BenchResult:
    passes: list = field(default_factory=list)  # (enc_ms, dec_ms, bench_size, comp_size)
    dict_size: int = 0
    buffer_size: int = 0

    def report(self, out=print):
        out("\n       Compressing                Decompressing\n")
        te = td = tb = tc = 0
        for enc_ms, dec_ms, bench_size, comp_size in self.passes:
            out(self._line(enc_ms, dec_ms, bench_size, comp_size))
            te += enc_ms
            td += dec_ms
            tb += bench_size
            tc += comp_size
        out("---------------------------------------------------")
        # average decode totals over bufferSize*numPasses output bytes and
        # the summed compressed size (LzmaBench.java:397-400)
        n = max(len(self.passes), 1)
        out(self._line(te, td, tb, tc, out_size=self.buffer_size * n,
                       suffix="    Average"))

    def _line(self, enc_ms, dec_ms, bench_size, comp_size, out_size=None,
              suffix=""):
        out_size = self.buffer_size if out_size is None else out_size
        er = compress_rating(self.dict_size, enc_ms, bench_size) // 1_000_000
        dr = decompress_rating(dec_ms, out_size, comp_size) // 1_000_000
        return (
            f"{speed_kb_s(bench_size, enc_ms):6d} KB/s  {er:6d} MIPS"
            f"     {speed_kb_s(out_size, dec_ms):6d} KB/s  {dr:6d} MIPS{suffix}"
        )


def run_benchmark(
    num_passes: int = 10,
    dict_size: int = 1 << 21,
    params: LzmaParams | None = None,
    encode_fn=None,
    decode_fn=None,
    out=print,
    device="cuda",
) -> BenchResult:
    """Benchmark loop.  encode_fn(data)->bytes / decode_fn(comp, out_size)
    ->bytes default to the device codec on `device` (ops.api.encode_stream
    and decode_stream); pass the hybrid's encode to rate it."""
    if dict_size < (1 << 18):
        raise ValueError("benchmark dictionary must be >= 2^18")
    params = params or LzmaParams(dict_size=dict_size)
    buffer_size = dict_size + ADDITIONAL_SIZE
    data = generate_bench_data(buffer_size)
    digest = crc32(data)

    if encode_fn is None:
        def encode_fn(d):
            return api.encode_stream(d, params, device=device)

    if decode_fn is None:
        def decode_fn(comp, out_size):
            return api.decode_stream(comp, params, out_size, device=device)

    result = BenchResult(dict_size=dict_size, buffer_size=buffer_size)
    comp_ref = None
    for _ in range(num_passes):
        # warm-up exclusion: like the reference (CProgressInfo.ApprovedStart,
        # LzmaBench.java:208-224, 337-338, 385), the timed region starts when
        # dict_size input bytes have been consumed; benchSize is the rest.
        approved = {"t": None, "in": 0}

        def on_progress(in_size, out_size):
            if in_size >= dict_size and approved["t"] is None:
                approved["t"] = time.perf_counter()
                approved["in"] = in_size

        t0 = time.perf_counter()
        try:
            comp = encode_fn(data, progress=on_progress)
        except TypeError:  # backend without progress support: time it whole
            comp = encode_fn(data)
        t_end = time.perf_counter()
        if approved["t"] is not None:
            enc_ms = (t_end - approved["t"]) * 1000
            bench_size = buffer_size - approved["in"]
        else:
            enc_ms = (t_end - t0) * 1000
            bench_size = buffer_size
        if comp_ref is None:
            comp_ref = comp
        elif len(comp) != len(comp_ref):
            raise AssertionError("encoding is non-deterministic across passes")
        dec_ms = 0.0
        for _ in range(2):  # double decode, like LzmaBench.java:371-384
            t0 = time.perf_counter()
            out_bytes = decode_fn(comp, buffer_size)
            dec_ms = (time.perf_counter() - t0) * 1000
            if crc32(out_bytes) != digest:
                raise AssertionError("benchmark CRC mismatch after decode")
        result.passes.append((enc_ms, dec_ms, bench_size, len(comp)))
    result.report(out=out)
    return result
