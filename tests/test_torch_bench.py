"""The benchmark `b` and its copies against lzma_tpu's, on the CPU.

lzma_tpu_torch.bench.rating, bench.harness (BenchResult's report lines,
run_benchmark's passes and its refusals) and utils.crc are the port's own
copies of lzma_tpu's and must give the originals' numbers and lines.  The
CPU cannot run the real loop (a pass is dict + 2 MiB through the plain
decoder), so the loop runs on stub codecs here and on the card in
chip_smoke.py; the CLI's `b` must reach the device codec's functions (or
the hybrid's) and print the report.  The device_dp_ratio pin (slow: the
JAX package's optimal parse of 256 KiB on the CPU) ties chip_smoke.py's
dp-ratio phase to the JAX container.
"""

import hashlib
import os
import sys
import zlib

import pytest

jax = pytest.importorskip("jax")

from lzma_tpu.bench import harness as jharness  # noqa: E402
from lzma_tpu.bench import rating as jrating  # noqa: E402
from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.format.properties import LzmaParams as JParams  # noqa: E402
from lzma_tpu.utils import crc as jcrc  # noqa: E402
from lzma_tpu_torch import cli as tcli  # noqa: E402
from lzma_tpu_torch.bench import harness as tharness  # noqa: E402
from lzma_tpu_torch.bench import rating as trating  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402
from lzma_tpu_torch.ops import hybrid as thybrid  # noqa: E402
from lzma_tpu_torch.utils import crc as tcrc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = [0, 1, 255, 256, 257, 1 << 18, (1 << 18) + 1, 3 << 20, 1 << 21,
         (1 << 21) + 12345, 1 << 23, 1 << 26, (1 << 31) - 1, 1 << 32]
TIMES = [-1.0, 0.0, 0.001, 0.5, 1.0, 17.25, 1000.0, 123456.7]


def test_rating_matches_the_original():
    assert trating._SUB_BITS == jrating._SUB_BITS
    for size in SIZES:
        assert trating._log_size(size) == jrating._log_size(size)
        for ms in TIMES:
            assert trating.compress_rating(size, ms, 1 << 21) == \
                jrating.compress_rating(size, ms, 1 << 21)
            assert trating.decompress_rating(ms, size, size // 3) == \
                jrating.decompress_rating(ms, size, size // 3)
            assert trating.speed_kb_s(size, ms) == jrating.speed_kb_s(size, ms)
            assert trating.total_rating(1 << 21, ms, size, ms * 2, size // 3,
                                        size) == \
                jrating.total_rating(1 << 21, ms, size, ms * 2, size // 3, size)


def test_crc32_matches_the_original():
    for data in (b"", b"a", bytes(range(256)) * 33, text_part()[:70_000],
                 bytearray(b"xyz"), memoryview(b"123456789")):
        assert tcrc.crc32(data) == jcrc.crc32(data)
    assert tcrc.crc32(b"123456789") == 0xCBF43926


def test_report_lines_match_the_original():
    passes = [(812.4, 731.9, 4194304, 1712345), (790.0, 0.0, 3000000, 1712345),
              (1.0, 2.5, 0, 0)]
    for dict_size in (1 << 18, 1 << 21, 1 << 23):
        lines = {}
        for name, mod in (("jax", jharness), ("port", tharness)):
            res = mod.BenchResult(passes=list(passes), dict_size=dict_size,
                                  buffer_size=dict_size + mod.ADDITIONAL_SIZE)
            out = []
            res.report(out=out.append)
            lines[name] = out
        assert lines["port"] == lines["jax"]
        assert len(lines["port"]) == len(passes) + 3
    assert tharness.ADDITIONAL_SIZE == jharness.ADDITIONAL_SIZE


def _stub_codec(calls):
    def encode(d):
        calls.append("e")
        return zlib.compress(d, 1)

    def decode(comp, out_size):   # bytes past zlib's stream are ignored
        calls.append("d")
        return zlib.decompressobj().decompress(comp)[:out_size]

    return encode, decode


def test_run_benchmark_matches_the_original_on_stub_codecs():
    results, lines, calls = {}, {}, {}
    for name, mod in (("jax", jharness), ("port", tharness)):
        calls[name] = []
        enc, dec = _stub_codec(calls[name])
        out = []
        results[name] = mod.run_benchmark(2, 1 << 18, encode_fn=enc,
                                          decode_fn=dec, out=out.append)
        lines[name] = out
    j, t = results["jax"], results["port"]
    assert (t.dict_size, t.buffer_size) == (j.dict_size, j.buffer_size) == \
        (1 << 18, (1 << 18) + (1 << 21))
    assert [p[2:] for p in t.passes] == [p[2:] for p in j.passes]
    assert t.passes[0][2] == t.buffer_size   # no progress hook: timed whole
    assert len(lines["port"]) == len(lines["jax"]) == 2 + 3
    assert calls["port"] == calls["jax"] == ["e", "d", "d"] * 2


@pytest.mark.parametrize("fault", ["small-dict", "crc", "nondeterministic"])
def test_run_benchmark_raises_where_the_original_does(fault):
    for mod in (jharness, tharness):
        enc, dec = _stub_codec([])
        kw = dict(encode_fn=enc, decode_fn=dec, out=lambda s: None)
        if fault == "small-dict":
            with pytest.raises(ValueError, match="2\\^18"):
                mod.run_benchmark(1, (1 << 18) - 1, **kw)
            continue
        if fault == "crc":
            kw["decode_fn"] = lambda comp, n: dec(comp, n)[:-1] + b"\x00"
        else:
            pads = iter([1, 2])
            kw["encode_fn"] = lambda d: enc(d) + bytes(next(pads))
        with pytest.raises(AssertionError):
            mod.run_benchmark(2, 1 << 18, **kw)


def _cli_stubs(monkeypatch, calls):
    enc, dec = _stub_codec(calls)

    def encode_stream(d, params, device="cuda"):
        calls.append(("encode_stream", params.dict_size, device))
        return enc(d)

    def decode_stream(comp, params, out_size, device="cuda"):
        calls.append(("decode_stream", params.dict_size, device))
        return dec(comp, out_size)

    def encode_hybrid(d, params=None, device="cuda"):
        calls.append(("hybrid", params.dict_size, device))
        return enc(d)

    monkeypatch.setattr(tapi, "encode_stream", encode_stream)
    monkeypatch.setattr(tapi, "decode_stream", decode_stream)
    monkeypatch.setattr(thybrid, "encode_stream_hybrid_optimal", encode_hybrid)


@pytest.mark.parametrize("args,enc_name,dict_size,passes", [
    (["b", "2"], "encode_stream", 1 << 21, 2),
    (["b", "-d18", "1", "-backendtpu"], "encode_stream", 1 << 18, 1),
    (["b", "1", "-backendhybrid"], "hybrid", 1 << 21, 1),
], ids=["tpu-2", "tpu-d18", "hybrid"])
def test_cli_b_rates_the_device_codec(monkeypatch, capsys, args, enc_name,
                                      dict_size, passes):
    calls = []
    _cli_stubs(monkeypatch, calls)
    assert tcli.main(args, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Compressing                Decompressing" in out
    assert out.count(" KB/s ") == 2 * (passes + 1)
    assert "Average" in out
    named = [c for c in calls if isinstance(c, tuple)]
    assert named == [(enc_name, dict_size, "cpu"),
                     ("decode_stream", dict_size, "cpu"),
                     ("decode_stream", dict_size, "cpu")] * passes


@pytest.mark.parametrize("args", [
    ["b", "-backendscalar"], ["b", "-backendnative"], ["b", "-d17"],
    ["b", "1", "-a1"]], ids=lambda a: " ".join(a))
def test_cli_b_refuses_what_the_port_lacks(monkeypatch, capsys, args):
    _cli_stubs(monkeypatch, [])
    assert tcli.main(args, device="cpu") == 1
    assert "error:" in capsys.readouterr().out
    assert tcli.main(["b", "x"], device="cpu") == 1
    assert tcli.main(["b", "0"], device="cpu") == 1
    assert "Incorrect command" in capsys.readouterr().out


@pytest.mark.slow
def test_smoke_dp_ratio_pin_is_the_jax_container():
    """chip_smoke.py's dp-ratio phase holds the card to BENCH_r05's
    device_dp_ratio (bench.py:556-563) through these pins: the JAX
    package's optimal-parse container of the first 256 KiB of the text
    corpus.  Slow: ~30 s of JAX on the CPU alone, so it stays out of the
    tier-1 run."""
    from lzma_tpu.ops import api as japi

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as smoke
    finally:
        sys.path.remove(ROOT)
    data = text_part()[: smoke.DP_RATIO_SIZE]
    blob = japi.encode_blocks(data, JParams(dict_size=1 << 16, fast_bytes=32),
                              block_size=smoke.DP_RATIO_BLOCK, parse="optimal")
    assert len(blob) == smoke.DP_RATIO_BYTES
    assert round(len(data) / len(blob), 3) == smoke.DP_RATIO
    assert hashlib.sha256(blob).hexdigest() == smoke.PIN_DP_RATIO_SHA256
