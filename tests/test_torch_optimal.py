"""lzma_tpu_torch's optimal-parse tokenizer and containers against
lzma_tpu's, on the CPU.

tokenize_optimal (n_iter 2, the production tiers) must give lzma_tpu's
tokens exactly; encode_blocks(parse="optimal") and the preset-primed
(LZTB v2/v3) forms must write lzma_tpu's containers byte for byte, and
the stdlib lzma module must read every block.
"""

import lzma

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.format import properties as jprops  # noqa: E402
from lzma_tpu.ops import api as japi  # noqa: E402
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.bench.corpus import text_part  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.format import properties as tprops  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402
from lzma_tpu_torch.parallel import blocks as tblk  # noqa: E402


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _lanes(n, seed, short):
    """Bench data, text, bench data with an incompressible tail, text
    repeats; lane 2 cut to `short` bytes."""
    rng = np.random.default_rng(seed)
    bench = np.frombuffer(generate_bench_data(2 * n), np.uint8)
    text = np.frombuffer(text_part()[seed * n:(seed + 2) * n], np.uint8)
    mixed = bench[n:].copy()
    mixed[n // 2:] = rng.integers(0, 256, n - n // 2)
    rows = [bench[:n], text[:n], mixed, np.tile(text[: n // 8], 8)]
    lens = np.full(4, n, np.int32)
    lens[2] = short
    return np.stack(rows), lens


# ------------------------------------------------------- pipeline
def test_tokenize_optimal_matches_jax():
    data, lens = _lanes(2048, seed=2, short=1800)
    kw = dict(lc=3, lp=0, pb=2, fb=32)
    # the settings the JAX package's encoder passes (device_encoder.py:579)
    want = jp.tokenize_optimal(jnp.asarray(data), jnp.asarray(lens),
                               jnp.int32(2048), tiers_key=jp.DP_TIERS,
                               n_iter=2, **kw)
    with tde.probing() as probe:
        got = tp.tokenize_optimal(T(data), T(lens), 2048, **kw)
    for name, g, r in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    secs = probe["seconds"]
    assert len(secs["dp_parse"]) == 2 and len(secs["classify"]) == 2
    # the price model in five sibling stages, each once a round
    assert "model" not in secs
    assert all(len(secs[k]) == 2 for k in tp.MODEL_STAGES)
    assert probe["dp_inputs"][0].shape == (4, 2048, 29)
    # outside the block nothing is recorded
    tp.tokenize_optimal(T(data[:1, :256]), T(lens[:1] // 8), 256, **kw)
    assert len(probe["seconds"]["dp_parse"]) == 2


@pytest.mark.parametrize("scan,band", [("band", True), ("band2", "pallas2_interpret"),
                                       ("naive", False)])
def test_tokenize_optimal_scans_match_jax(scan, band):
    """Each scan of the port against its JAX counterpart (band=True,
    "pallas2" in interpret mode, False), token for token, as
    test_device_parser.py holds the JAX scans to each other.  On the CPU
    "band2" runs K4's plain version."""
    data, lens = _lanes(512, seed=4, short=300)
    data, lens = data[:3], lens[:3]
    kw = dict(lc=3, lp=0, pb=2, fb=16)
    want = jp.tokenize_optimal(jnp.asarray(data), jnp.asarray(lens),
                               jnp.int32(512), tiers_key=jp.DP_TIERS,
                               n_iter=2, band=band, **kw)
    got = tp.tokenize_optimal(T(data), T(lens), 512, scan=scan, **kw)
    for name, g, r in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    with pytest.raises(ValueError):
        tp.tokenize_optimal(T(data), T(lens), 512, scan="pallas", **kw)


OPT_CASES = {
    "bench-3-lanes": (3, 5000, dict(dict_size=1 << 12), 2048),
    "text-lc0-pb0-fb16": (4, 6000, dict(lc=0, lp=0, pb=0, dict_size=1 << 13,
                                        fast_bytes=16), 2048),
    "text-lp2-fb64": (5, 3000, dict(lc=1, lp=2, pb=1, dict_size=1 << 11,
                                    fast_bytes=64), 1300),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_encode_blocks_optimal_matches_jax(name):
    seed, n, kw, block = OPT_CASES[name]
    data = (generate_bench_data(n) if seed == 3
            else text_part()[seed * 100000:seed * 100000 + n])
    ref = japi.encode_blocks(data, jprops.LzmaParams(**kw), block_size=block,
                             parse="optimal")
    params = tprops.LzmaParams(**kw)
    got = tapi.encode_blocks(data, params, block_size=block, parse="optimal",
                             device="cpu")
    assert got == ref
    frame = tblk.parse_container(got)
    offsets, sizes = frame.stream_extents(len(got))
    for i, size in enumerate(sizes):
        alone = (params.encode_props() + size.to_bytes(8, "little")
                 + got[offsets[i]:offsets[i + 1]])
        part = data[i * block:i * block + size]
        assert lzma.decompress(alone, format=lzma.FORMAT_ALONE) == part


# ------------------------------------------------------- presets
def test_preset_encode_matches_jax():
    params = tprops.LzmaParams(dict_size=1 << 12)
    data = generate_bench_data(5000)
    blocks = [data[1000:2000], data[2000:3500], data[3500:3600]]
    preset = data[:700]
    ref = jde.encode_batch(blocks, jprops.LzmaParams(dict_size=1 << 12),
                           use_pallas=True, preset=preset)
    assert tde.encode_batch(blocks, params, preset=preset, device="cpu") == ref
    # preset-primed lanes keep the lazy parse
    assert tde.encode_batch(blocks, params, preset=preset, parse="optimal",
                            device="cpu") == ref


@pytest.mark.parametrize("kind,parse", [("preset", "lazy"), ("preset", "optimal"),
                                        ("dictionary", "lazy"),
                                        ("dictionary", "optimal")])
def test_encode_blocks_v2_v3_match_jax(kind, parse):
    data = generate_bench_data(2500)
    kw = (dict(preset_len=400) if kind == "preset"
          else dict(dictionary=text_part()[:600]))
    ref = japi.encode_blocks(data, jprops.LzmaParams(dict_size=1 << 12),
                             block_size=1024, use_pallas=True, parse=parse, **kw)
    got = tapi.encode_blocks(data, tprops.LzmaParams(dict_size=1 << 12),
                             block_size=1024, parse=parse, device="cpu", **kw)
    assert got == ref
    assert got[4] == (2 if kind == "preset" else 3)
    assert tapi.decode_blocks(got, device="cpu") == data
