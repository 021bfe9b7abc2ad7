"""The device trace dump (encode_batch(trace=)) against lzma_tpu's, on
the CPU: every lane's decision lines and the candidate lists at each
decision, line for line (tests/test_trace.py's device cases)."""

import io
import logging

import pytest

pytest.importorskip("jax")

from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.format.properties import LzmaParams as JParams  # noqa: E402
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu.utils.trace import CodecTrace as JTrace  # noqa: E402
from lzma_tpu_torch.format.properties import LzmaParams  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402
from lzma_tpu_torch.utils.trace import CodecTrace, enable_trace, logger  # noqa: E402

DATA = generate_bench_data(2000)
TEXT = text_part()[:2000]


def _jp(p):
    return JParams(lc=p.lc, lp=p.lp, pb=p.pb, dict_size=p.dict_size,
                   fast_bytes=p.fast_bytes)


def _lines(fn, trace_cls):
    log = logging.getLogger(f"test.torch.trace.{trace_cls.__module__}")
    log.setLevel(logging.DEBUG)
    stream = io.StringIO()
    h = logging.StreamHandler(stream)
    h.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(h)
    try:
        fn(trace_cls(log))
    finally:
        log.removeHandler(h)
    return stream.getvalue().splitlines()


TRACE_CASES = {
    # tests/test_trace.py:103-172's device cases
    "unique-bytes-lazy": ([bytes(range(200))], "lazy", b""),
    "repeat-lazy": ([bytes(range(200)) * 2], "lazy", b""),
    "optimal": ([(b"abcdefgh" * 40 + bytes(range(100)))[:400]], "optimal", b""),
    "optimal-match-lists": ([bytes(range(200)) * 2], "optimal", b""),
    "two-lanes-preset-lazy": ([DATA[:900], DATA[900:1700]], "lazy", TEXT[:300]),
}


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_trace_dump_matches_jax(name):
    blocks, parse, preset = TRACE_CASES[name]
    p = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    want = _lines(lambda t: jde.encode_batch(blocks, _jp(p), parse=parse,
                                             preset=preset, trace=t), JTrace)
    got = _lines(lambda t: tde.encode_batch(blocks, p, parse=parse,
                                            preset=preset, trace=t,
                                            device="cpu"), CodecTrace)
    assert got == want
    assert any("matches=" in ln for ln in got)


def test_trace_dump_follows_the_encode_params():
    """The dumped decisions are the ones coded: at lc0 lp2 pb0 the optimal
    parse prices with those bits, so its tokens are the probed encode's.
    The reference's dump prices at lc3 lp0 pb2 whatever the encode's
    (device_encoder.py:675-676): its lines here are the port's at those
    defaults, not the decisions it codes."""
    p = LzmaParams(lc=0, lp=2, pb=0, dict_size=1 << 12, fast_bytes=32)
    block = TEXT[:1500]
    with tde.probing() as probe:
        lines = _lines(lambda t: tde.encode_batch([block], p, parse="optimal",
                                                  trace=t, device="cpu"),
                       CodecTrace)
    t_pos, t_len, t_valid = probe["lowered"][:3]
    n = int(t_valid.sum())
    toks = [ln for ln in lines if ln.startswith("pos=") and "matches=" not in ln]
    assert [int(ln.split()[0][4:]) for ln in toks] == t_pos[0, :n].tolist()
    assert [int(ln.rsplit("len=", 1)[1]) for ln in toks] == t_len[0, :n].tolist()
    ref = _lines(lambda t: jde.encode_batch([block], _jp(p), parse="optimal",
                                            trace=t), JTrace)
    at_defaults = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    assert ref != lines
    assert ref == _lines(lambda t: tde.encode_batch(
        [block], at_defaults, parse="optimal", trace=t, device="cpu"),
        CodecTrace)


def test_enable_trace_routes_the_port_logger():
    stream = io.StringIO()
    h = enable_trace(stream)
    try:
        assert h in logger.handlers and CodecTrace().enabled
        tde.encode_batch([bytes(range(40))], LzmaParams(), trace=CodecTrace(),
                         device="cpu")
    finally:
        logger.removeHandler(h)
        logger.setLevel(logging.NOTSET)
    assert "lane=0 tokens=40" in stream.getvalue()
    assert "lzma_tpu_torch.codec" in stream.getvalue()
