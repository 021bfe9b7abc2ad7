"""The port's automatic choices against lzma_tpu's, on the CPU.

lzma_tpu_torch.utils.autotune.select_params (lc/lp/pb by measured cost)
and utils.dicttrain.select_dictionary (a trained dictionary sized against
its storage cost) must choose what lzma_tpu's functions choose on the
same input, since every byte after a container's header follows from
that choice; their sizes come from the host encoder, whose preset entry
(native.encode_stream(preset=)) must write lzma_tpu.runtime.native's
bytes.  The front door's params="auto", train_dict="auto" and LzmaParams
keyword fields must write lzma_tpu.compress(container="lztb",
backend="device")'s container, and chip_smoke.py's auto-phase pins are
the JAX package's choices.  Tests that need g++ skip without it.
"""

import dataclasses
import hashlib
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import lzma_tpu  # noqa: E402
import lzma_tpu_torch  # noqa: E402
from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.format.properties import LzmaParams as JParams  # noqa: E402
from lzma_tpu.runtime import native as jnative  # noqa: E402
from lzma_tpu.utils import autotune as jauto  # noqa: E402
from lzma_tpu.utils import dicttrain as jdict  # noqa: E402
from lzma_tpu_torch.format.properties import LzmaParams  # noqa: E402
from lzma_tpu_torch.runtime import native  # noqa: E402
from lzma_tpu_torch.utils import autotune as tauto  # noqa: E402
from lzma_tpu_torch.utils import dicttrain as tdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def host():
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def _jp(p):
    return None if p is None else JParams(**dataclasses.asdict(p))


def _words(n):
    """Word-aligned binary: little-endian uint32 counters with noise in
    their low bits, where a literal's position predicts it."""
    rng = np.random.default_rng(5)
    return (np.arange(n, dtype=np.uint32) * 7
            + rng.integers(0, 4, n, dtype=np.uint32)).tobytes()


def _vocab(n_words):
    """Blocks drawn from one vocabulary of random 48-byte words: redundancy
    across blocks that a stored dictionary captures."""
    rng = np.random.default_rng(7)
    vocab = [rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
             for _ in range(120)]
    return b"".join(vocab[i] + bytes(rng.integers(97, 123, 3, dtype=np.uint8))
                    for i in rng.integers(0, len(vocab), n_words))


PARAMS_CASES = {
    "text": (text_part()[:40_000], None, dict(block_size=1 << 13)),
    "words": (_words(20_000), None, dict(block_size=1 << 13)),
    "periodic": (bytes(range(37)) * 1000, LzmaParams(dict_size=1 << 12), {}),
    "empty": (b"", LzmaParams(lc=1), {}),
    "one-byte": (b"x", None, {}),
    "block-size-0": (generate_bench_data(30_000), None, dict(block_size=0)),
    "samples-list": ([text_part()[:9000], _words(3000)], None,
                     dict(block_size=4096, sample_blocks=3, sample_size=2048)),
    "candidates-margin": (_words(20_000), LzmaParams(lc=0, lp=0, pb=0),
                          dict(block_size=1 << 13, margin=0.05,
                               candidates=((1, 1, 1), (0, 2, 0), (3, 0, 2)))),
}


@pytest.mark.parametrize("name", sorted(PARAMS_CASES))
def test_select_params_matches_jax(host, name):
    data, params, kw = PARAMS_CASES[name]
    want = jauto.select_params(data, _jp(params), **kw)
    got = tauto.select_params(data, params, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "words":   # the tuner moves off the baseline here
        assert (want.lc, want.lp, want.pb) != (3, 0, 2)


def test_default_candidates_are_the_originals():
    assert tauto.DEFAULT_CANDIDATES == jauto.DEFAULT_CANDIDATES


@pytest.mark.parametrize("name,data,params,kw", [
    ("dictionary", _vocab(1500), LzmaParams(dict_size=1 << 16),
     dict(block_size=1 << 13, max_size=1 << 13)),
    ("none", np.random.default_rng(3).integers(0, 256, 50_000, dtype=np.uint8)
     .tobytes(), None, dict(block_size=1 << 14, max_size=1 << 12)),
    ("train-kw", _vocab(1500), None,
     dict(block_size=1 << 12, max_size=1 << 12, sample_blocks=5, k=16, d=4)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_select_dictionary_matches_jax(host, name, data, params, kw):
    want = jdict.select_dictionary(data, _jp(params), **kw)
    got = tdict.select_dictionary(data, params, **kw)
    assert got == want
    assert (len(got) > 0) == (name != "none")


@pytest.mark.parametrize("preset,kw", [
    (b"", {}),
    (text_part()[50_000:54_000], {}),
    (text_part()[50_000:54_000], dict(lc=0, lp=2, pb=0, match_finder="hc4")),
    (generate_bench_data(3000), dict(write_eos=True, fast_bytes=5,
                                     match_finder="bt2")),
], ids=["no-preset", "preset", "preset-hc4", "preset-eos-bt2"])
def test_encode_stream_preset_matches_jax(host, preset, kw):
    p = LzmaParams(dict_size=1 << 14, **kw)
    for data in (text_part()[:12_000], b""):
        want = jnative.encode_stream(data, _jp(p), preset=preset)
        assert native.encode_stream(data, p, preset=preset) == want


def test_selection_raises_without_the_host_encoder(monkeypatch):
    """No scalar codec to fall back on: the choice raises, the build's
    error as its cause; an empty input needs no sizes."""
    def fail():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "_LIB", [])
    monkeypatch.setattr(native, "build", fail)
    assert tauto.select_params(b"", LzmaParams(lc=1)).lc == 1
    for fn in (tauto.select_params, tdict.select_dictionary):
        with pytest.raises(RuntimeError) as err:
            fn(b"abc" * 100)
        assert "g++ not found" in str(err.value.__cause__)


# ------------------------------------------------------------ front door
FRONT = _vocab(80) + text_part()[:1200]    # 5 KiB, 1 KiB blocks


# params="auto" picks lc0 lp0 pb0 here; the other cases take that triple
# too, so that JAX compiles the lanes' shapes once
@pytest.mark.parametrize("kw", [
    dict(params="auto", dict_size=1 << 12),
    dict(dict_size=1 << 12, lc=0, lp=0, pb=0),
    dict(train_dict="auto", params=LzmaParams(dict_size=1 << 12, lc=0, pb=0)),
], ids=["params-auto", "field-kw", "train-dict-auto"])
def test_compress_auto_matches_jax_device_backend(host, kw):
    jkw = dict(kw)
    if isinstance(kw.get("params"), LzmaParams):
        jkw["params"] = _jp(kw["params"])
    ref = lzma_tpu.compress(FRONT, container="lztb", backend="device",
                            block_size=1024, **jkw)
    got = lzma_tpu_torch.compress(FRONT, block_size=1024, device="cpu", **kw)
    assert got == ref
    assert lzma_tpu.decompress(got) == FRONT


def _smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_smoke_auto_pins_are_the_jax_choices(host):
    """chip_smoke.py's auto phase holds the card run's choices to
    PIN_AUTO_PARAMS and PIN_AUTO_DICT_SHA256: the JAX package's choices
    on the first AUTO_SIZE bytes of the main input (text_part() first)."""
    smoke = _smoke()
    text = text_part()
    assert len(text) >= smoke.AUTO_SIZE
    data = text[: smoke.AUTO_SIZE]
    p = jauto.select_params(data, JParams(), block_size=smoke.AUTO_BLOCK)
    assert (p.lc, p.lp, p.pb) == smoke.PIN_AUTO_PARAMS
    assert dataclasses.asdict(tauto.select_params(
        data, LzmaParams(), block_size=smoke.AUTO_BLOCK)) == dataclasses.asdict(p)
    dct = jdict.select_dictionary(data, JParams(), block_size=smoke.AUTO_BLOCK)
    assert hashlib.sha256(dct).hexdigest() == smoke.PIN_AUTO_DICT_SHA256
    assert len(dct) == smoke.AUTO_DICT_LEN
