"""lzma_tpu_torch's optimal parse against lzma_tpu's, on the CPU.

Each stage of the optimal-parse pipeline (candidate lists, seed, price
model, the DP scan's plain version, extraction) is fed the same numpy
inputs as its counterpart in lzma_tpu.ops; the codec is integer-only, so
every array must be exactly equal (tolerance zero).  The port's own
copies of lzma_tpu's jax-free modules are held to the originals here
too.  (The whole tokenizer and the containers: test_torch_optimal.py.)
"""

import functools
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.bench.corpus import text_part as j_text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data as j_gen  # noqa: E402
from lzma_tpu.core import constants as jc  # noqa: E402
from lzma_tpu.core import prices as jprices  # noqa: E402
from lzma_tpu.core.layout import ProbLayout as JLayout  # noqa: E402
from lzma_tpu.format import properties as jprops  # noqa: E402
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu.parallel import blocks as jblk  # noqa: E402
from lzma_tpu.utils import dicttrain as jdict  # noqa: E402
from lzma_tpu_torch.bench.corpus import text_part  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.core import constants as tc  # noqa: E402
from lzma_tpu_torch.core import prices as tprices  # noqa: E402
from lzma_tpu_torch.core.layout import ProbLayout  # noqa: E402
from lzma_tpu_torch.format import properties as tprops  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402
from lzma_tpu_torch.parallel import blocks as tblk  # noqa: E402
from lzma_tpu_torch.utils import dicttrain as tdict  # noqa: E402

TIERS = dict(jp.DP_TIERS)


def T(a):
    """A numpy (or JAX) array as a CPU tensor, copied."""
    return torch.from_numpy(np.array(a, copy=True))


def eq(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=msg)


def _lanes(n, seed, short=None):
    """Bench data, text, bench data with an incompressible tail, text
    repeats; `short` cuts lane 2's length."""
    rng = np.random.default_rng(seed)
    bench = np.frombuffer(generate_bench_data(2 * n), np.uint8)
    text = np.frombuffer(text_part()[seed * n:(seed + 2) * n], np.uint8)
    mixed = bench[n:].copy()
    mixed[n // 2:] = rng.integers(0, 256, n - n // 2)
    rows = [bench[:n], text[:n], mixed, np.tile(text[: n // 8], 8)]
    lens = np.full(4, n, np.int32)
    if short is not None:
        lens[2] = short
    return np.stack(rows), lens


def _jax_pipeline(data, lens, fb, lc=3, lp=0, pb=2):
    """The first round of jax tokenize_optimal's pipeline, as numpy."""
    N = data.shape[1]
    dj, lj = jnp.asarray(data), jnp.asarray(lens)
    cl, cd, counts, rank, Tt = jax.jit(jax.vmap(
        lambda d, n: jm._rmq_search(d, n, N, fb, m_cap=jp.DP_M_CAP,
                                    m_cap_order="rr", **TIERS)))(dj, lj)
    ld, dd = jp._select_dp_pairs(cl, cd, counts, jp.DEFAULT_M_DP)
    tp_, tl, td, tv, _ = jax.vmap(
        lambda c, e, k, n, d: jp._seed_from_lists(c, e, k, n, data=d,
                                                  ext_from=fb, min_len=4)
    )(cl, cd, counts, lj, dj)
    meta = jde.classify_tokens(dj, tp_, tl, td, tv)
    ctx, bits, totals = jde.lower_tokens(dj, meta, tp_, tl, td, tv, lc, lp, pb,
                                         10 * N + 128)
    layout = JLayout(lc, lp, pb, pos_bits=pb)
    probs = jp.empirical_probs(ctx, bits, totals, layout.size)
    r0pos = jp.rep0_trace(tp_, td, tv, N)
    replen = jax.vmap(lambda r, t, rp, n: jm.rep_match_lens_rmq(r, t, rp, n, fb)
                      )(rank, Tt, r0pos, lj)
    model = jp.build_price_model(dj, probs, lc, lp, pb, fb, r0pos=r0pos)
    frm, choice = jp.dp_parse_band(dj, lj, ld, dd, model, fb, pb, False,
                                   r0pos=r0pos, replen=replen)
    toks = jp.extract_tokens(frm, choice, lj)
    out = dict(cl=cl, cd=cd, counts=counts, rank=rank, T=Tt, ld=ld, dd=dd,
               seed=(tp_, tl, td, tv), ctx=ctx, bits=bits, totals=totals,
               probs=probs, r0pos=r0pos, replen=replen, model=model,
               frm=frm, choice=choice, toks=toks)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def case():
    """4 lanes x 2 KiB (one ragged), fb 32, lc3 lp0 pb2, through JAX."""
    data, lens = _lanes(2048, seed=1, short=1500)
    return data, lens, _jax_pipeline(data, lens, 32)


# ------------------------------------------------------- vendored copies
def test_vendored_layout_constants_and_prices_match():
    for lc in (0, 3, 8):
        for lp in (0, 2, 4):
            for pb in (0, 2, 4):
                for pos_bits in sorted({pb, 4}):
                    assert ProbLayout(lc, lp, pb, pos_bits).__dict__ == \
                        JLayout(lc, lp, pb, pos_bits).__dict__
    for name in ("NEXT_STATE_LITERAL", "NEXT_STATE_MATCH", "NEXT_STATE_SHORTREP",
                 "NEXT_STATE_LONGREP"):
        eq(getattr(tc, name), getattr(jc, name), name)
    for name in ("MATCH_MAX_LEN", "NUM_FULL_DISTANCES", "END_POS_MODEL_INDEX",
                 "ALIGN_TABLE_SIZE", "NUM_LEN_TO_POS_STATES", "NUM_STATES"):
        assert getattr(tc, name) == getattr(jc, name), name
    eq(tprices.PRICE_TABLE, jprices.PRICE_TABLE)
    assert tprices.BIT_MODEL_TOTAL == jprices.BIT_MODEL_TOTAL


def test_vendored_properties_match():
    for kw in (dict(), dict(lc=0, lp=4, pb=0, dict_size=1 << 12),
               dict(lc=8, lp=0, pb=4, dict_size=(1 << 29) - 3, fast_bytes=273)):
        t, j = tprops.LzmaParams(**kw), jprops.LzmaParams(**kw)
        assert t.encode_props() == j.encode_props()
        assert tprops.decode_props(t.encode_props()).__dict__ == \
            jprops.decode_props(j.encode_props()).__dict__
        t.validated_for_encode()
    for bad in (dict(lc=9), dict(pb=5), dict(fast_bytes=4), dict(dict_size=0)):
        with pytest.raises(ValueError):
            tprops.LzmaParams(**bad).validated_for_encode()
    with pytest.raises(ValueError):
        tprops.decode_props(bytes([225, 0, 0, 1, 0]))
    assert tprops.MAX_EXPANSION == jprops.MAX_EXPANSION
    for size, payload in ((0, 0), (1 << 16, 0), (8192 * 5 + (1 << 16), 5),
                          (-1, 0)):
        tprops.validate_alone_size(size, payload)
        jprops.validate_alone_size(size, payload)
    for size, payload in (((1 << 16) + 1, 0), (8192 * 5 + (1 << 16) + 1, 5)):
        with pytest.raises(ValueError, match="impossible"):   # CorruptStreamError
            tprops.validate_alone_size(size, payload)
        with pytest.raises(ValueError, match="impossible"):
            jprops.validate_alone_size(size, payload)


def test_vendored_container_matches():
    tpar, jpar = tprops.LzmaParams(dict_size=1 << 12), jprops.LzmaParams(dict_size=1 << 12)
    streams = [b"abc", b"", b"\x00" * 7]
    for kw in (dict(), dict(preset_len=100), dict(dict_stream=b"xyz", dict_len=40)):
        blob = tblk.build_container(tpar, 512, 1500, streams, **kw)
        assert blob == jblk.build_container(jpar, 512, 1500, streams, **kw)
        f, g = tblk.parse_container(blob), jblk.parse_container(blob)
        assert (f.block_size, f.total_size, f.comp_sizes, f.payload_offset,
                f.preset_len, f.dict_len, f.dict_comp) == \
               (g.block_size, g.total_size, g.comp_sizes, g.payload_offset,
                g.preset_len, g.dict_len, g.dict_comp)
        assert f.stream_extents(len(blob)) == g.stream_extents(len(blob))
        assert tblk.read_header(io.BytesIO(blob))[1:] == \
            jblk.read_header(io.BytesIO(blob))[1:]
    assert tblk.split_blocks(b"x" * 10, 4) == jblk.split_blocks(b"x" * 10, 4)
    assert (tblk.DEFAULT_BLOCK_SIZE, tblk.MAX_EXPANSION) == \
        (jblk.DEFAULT_BLOCK_SIZE, jblk.MAX_EXPANSION)
    # the file codec's batch ceiling and the CLI's training sample
    from lzma_tpu.parallel import filestream as jfs
    from lzma_tpu_torch import cli as tcli
    from lzma_tpu_torch.parallel import filestream as tfs

    assert tfs.DEFAULT_BATCH_BYTES == tcli.TRAIN_SAMPLE_BYTES == \
        jfs.DEFAULT_BATCH_BYTES
    for total, size in ((100, 0), (8192 * 16 + (1 << 16), 16),
                        (8192 * 16 + (1 << 16) + 1, 16)):
        f = io.BytesIO(b"\x00" * size)
        outcome = []
        for mod in (tfs, jfs):
            try:
                mod.check_total_size_plausible(total, f)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    assert tblk.validated_preset_len(900, 512, 700) == 512
    with pytest.raises(ValueError):
        tblk.validated_dictionary(b"d", preset_len=3)
    for bad in (b"LZTX" + blob[4:], blob[:10], blob[:4] + b"\x07" + blob[5:]):
        with pytest.raises(ValueError):   # CorruptStreamError is a ValueError
            tblk.parse_container(bad)


def test_vendored_dicttrain_matches():
    corpus = generate_bench_data(60_000) + text_part()[:20_000]
    for size, kw in ((1 << 12, {}), (1000, dict(k=16, d=4)),
                     (1 << 16, dict(table_bits=12)), (5, {})):
        assert tdict.train_dictionary(corpus, size, **kw) == \
            jdict.train_dictionary(corpus, size, **kw)
    samples = [corpus[:3000], corpus[5000:9000]]
    assert tdict.train_dictionary(samples, 2048) == \
        jdict.train_dictionary(samples, 2048)
    assert tdict.train_dictionary(b"abc", 100) == b"abc"
    assert tdict.train_dictionary(bytes(range(256)) * 4, 64) == \
        jdict.train_dictionary(bytes(range(256)) * 4, 64)
    with pytest.raises(ValueError):
        tdict.train_dictionary(corpus, 0)


def test_vendored_bench_data_matches():
    for n in (0, 1, 1000, 70000):
        assert generate_bench_data(n) == j_gen(n)
    assert text_part() == j_text_part()


# ------------------------------------------------------- search
@pytest.mark.parametrize("fb,short", [(32, 700), (273, 700), (5, 1)],
                         ids=["32-12-rr", "273-12-rr", "5-12-rr"])
def test_rmq_search_matches_jax(fb, short):
    """The search at the optimal route's statics: the port's fixed tiers
    and cap are the JAX package's DP_TIERS (k2 and k3 at their default
    1), DP_M_CAP and "rr"."""
    assert dict((f"k{span}", k) for span, k in tm.DP_TIERS) == \
        dict(k2=1, k3=1, **TIERS)
    assert (tm.DP_M_CAP, "rr") == (jp.DP_M_CAP, jp.DP_M_CAP_ORDER)
    data, lens = _lanes(1024, seed=fb, short=short)
    ref = jax.jit(jax.vmap(lambda d, n: jm._rmq_search(
        d, n, 1000, fb, m_cap=jp.DP_M_CAP, m_cap_order="rr", **TIERS)))(
        jnp.asarray(data), jnp.asarray(lens))
    got = tm._rmq_search(T(data), T(lens), 1000, fb)
    for name, g, r in zip(("lens", "dists", "counts", "rank", "T"), got, ref):
        eq(g, r, name)


def test_rmq_search_tiny_block_and_short_lanes():
    rng = np.random.default_rng(5)
    data = np.stack([np.zeros(256, np.uint8), np.full(256, 7, np.uint8),
                     rng.integers(0, 3, 256).astype(np.uint8)])
    lens = np.array([3, 255, 200], np.int32)
    ref = jax.vmap(lambda d, n: jm._rmq_search(d, n, 256, 32, m_cap=12,
                                               m_cap_order="rr", **TIERS))(
        jnp.asarray(data), jnp.asarray(lens))
    got = tm._rmq_search(T(data), T(lens), 256, 32)
    for g, r in zip(got, ref):
        eq(g, r)


def test_lcp_query_general_p(case):
    data, lens, ref = case
    rng = np.random.default_rng(3)
    p = rng.integers(-3, data.shape[1] + 3, (4, 2048, 2)).astype(np.int32)
    q = rng.integers(-3, data.shape[1], (4, 2048, 2)).astype(np.int32)
    want = jax.vmap(lambda r, t, a, b: jm._lcp_query(r, t, a, b, 2048))(
        ref["rank"], ref["T"], p, q)
    eq(tm._lcp_query(T(ref["rank"]).long(), T(ref["T"]), T(q).long(), 2048,
                     p=T(p).long()), want)


def test_rep_match_lens_matches_jax(case):
    data, lens, ref = case
    r0 = np.stack([np.full(2048, 7), np.arange(2048) % 97,
                   np.full(2048, 5000), ref["r0pos"][3]]).astype(np.int32)
    want = jax.vmap(lambda r, t, rp, n: jm.rep_match_lens_rmq(r, t, rp, n, 32))(
        ref["rank"], ref["T"], r0, jnp.asarray(lens))
    eq(tm.rep_match_lens_rmq(T(ref["rank"]).long(), T(ref["T"]), T(r0), T(lens),
                             32), want)
    eq(tm.rep_match_lens_rmq(T(ref["rank"]).long(), T(ref["T"]), T(ref["r0pos"]),
                             T(lens), 32), ref["replen"])


def test_select_pairs_and_seed_match_jax(case):
    data, lens, ref = case
    cl, cd, counts = T(ref["cl"]).long(), T(ref["cd"]).long(), T(ref["counts"]).long()
    assert tp.M_DP == jp.DEFAULT_M_DP
    ld, dd = tp._select_dp_pairs(cl, cd, counts)
    eq(ld, ref["ld"], "ld")
    eq(dd, ref["dd"], "dd")
    seed = tp._seed_from_lists(cl, cd, counts, T(lens))
    for g, r in zip(seed, ref["seed"]):
        eq(g, r, "seed")


# ------------------------------------------------------- price model
@pytest.mark.parametrize("lc,lp,pb", [(3, 0, 2), (0, 0, 0), (1, 2, 1)])
def test_empirical_probs_and_price_model_match_jax(lc, lp, pb):
    assert tp.EMP_ALPHA == jp.EMP_ALPHA
    rng = np.random.default_rng(lc * 9 + lp * 3 + pb)
    S = JLayout(lc, lp, pb, pos_bits=pb).size
    L, B = 3, 600_000
    ctx = rng.integers(-1, S, (L, B)).astype(np.int32)
    ctx[0, :550_000] = 5            # one slot past the int32 numerator's range
    bits = rng.integers(0, 2, (L, B)).astype(np.int32)
    bits[0, :550_000] = 0
    totals = np.array([B, 1000, 0], np.int32)
    probs = jp.empirical_probs(jnp.asarray(ctx), jnp.asarray(bits),
                               jnp.asarray(totals), S)
    eq(tp.empirical_probs(T(ctx), T(bits), T(totals), S), probs)

    data, lens = _lanes(512, seed=lc + 2 * pb)
    probs = rng.integers(32, 2017, (4, S)).astype(np.int32)
    r0pos = rng.integers(0, 300, (4, 512)).astype(np.int32)
    want = jp.build_price_model(jnp.asarray(data), jnp.asarray(probs), lc, lp,
                                pb, 32, r0pos=jnp.asarray(r0pos))
    got = tp.build_price_model(T(data), T(probs), lc, lp, pb, T(r0pos))
    assert sorted(got) == sorted(want)
    for name in want:
        eq(got[name], want[name], name)


def test_pair_dist_cost_matches_jax(case):
    data, lens, ref = case
    rng = np.random.default_rng(4)
    dd = ref["dd"].copy()
    dd[0, :64] = rng.integers(100, 1 << 30, (64, 4))   # far distances too
    valid = (ref["ld"] >= 2) & (dd >= 0)
    model = {k: T(v) for k, v in ref["model"].items()}
    eq(tp._pair_dist_cost(model, T(dd), T(valid)),
       jp._pair_dist_cost(ref["model"], jnp.asarray(dd), jnp.asarray(valid)))


def test_rep0_trace_matches_jax(case):
    data, lens, ref = case
    tp_, tl, td, tv = ref["seed"]
    eq(tp.rep0_trace(T(tp_), T(td), T(tv), 2048), ref["r0pos"])
    rng = np.random.default_rng(6)
    td2 = np.where(rng.random(td.shape) < 0.3, -1, td)
    eq(tp.rep0_trace(T(tp_), T(td2), T(tv), 2048),
       jp.rep0_trace(jnp.asarray(tp_), jnp.asarray(td2), jnp.asarray(tv), 2048))


# ------------------------------------------------------- DP scan
def test_model_and_dp_round_match_jax(case):
    """The port's whole first round (classify, lower, probabilities,
    trace, model, packing, plain scan) from the JAX seed tokens."""
    data, lens, ref = case
    packed, tables = tp._round_inputs(
        T(data), T(lens), tuple(T(a) for a in ref["seed"]), T(ref["ld"]),
        T(ref["dd"]), (T(ref["rank"]).long(), T(ref["T"])), 3, 0, 2, 32)
    frm, choice = tp.dp_parse_band(packed, tables, T(lens), 32, 2)
    eq(frm, ref["frm"], "from")
    eq(choice, ref["choice"], "choice")
    toks = tp.extract_tokens(frm, choice, T(lens))
    for name, g, r in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                          toks, ref["toks"]):
        eq(g, r, name)


@functools.cache
def _small(fb):
    """4 lanes x 256 positions (one ragged) through the JAX pipeline, the
    JAX arguments of its scans and the port's packed inputs."""
    data, lens = _lanes(256, seed=fb, short=180)
    ref = _jax_pipeline(data, lens, fb)
    model = {k: jnp.asarray(v) for k, v in ref["model"].items()}
    args = (jnp.asarray(data), jnp.asarray(lens), jnp.asarray(ref["ld"]),
            jnp.asarray(ref["dd"]), model, fb, 2, False)
    kw = dict(r0pos=jnp.asarray(ref["r0pos"]), replen=jnp.asarray(ref["replen"]))
    packed, tables = tp.dp_inputs(T(data), T(ref["ld"]), T(ref["dd"]),
                                  {k: T(v) for k, v in ref["model"].items()},
                                  fb, T(ref["r0pos"]), T(ref["replen"]))
    return lens, ref, args, kw, (packed, tables, T(lens), fb, 2)


@pytest.mark.parametrize("fb", [5, 32])
def test_dp_parse_band_matches_jax_band_and_pallas(fb):
    lens, ref, args, kw, port_args = _small(fb)
    pallas = jp.dp_parse_pallas(*args, **kw, interpret=True)
    got = tp.dp_parse_band(*port_args)
    for g, b, p in zip(got, (ref["frm"], ref["choice"]), pallas):
        eq(g, b)
        eq(g, p)


def test_dp_parse_band_matches_jax_pallas2():
    """K4's plain version (the port's dp_parse_band) against K4's reference,
    dp_parse_pallas2 in interpret mode, at fb 32 (the scan-pair test of
    test_torch_optimal.py covers fb 16)."""
    lens, ref, args, kw, port_args = _small(32)
    pallas2 = jp.dp_parse_pallas2(*args, **kw, interpret=True)
    for g, p in zip(tp.dp_parse_band(*port_args), pallas2):
        eq(g, p)


def test_dp_parse_naive_matches_jax(case):
    """The naive plane scan: price, from, choice and kind planes, each
    (L, N + fb + 1), equal to JAX dp_parse's on the same inputs."""
    data, lens, ref = case
    model = {k: jnp.asarray(v) for k, v in ref["model"].items()}
    want = jp.dp_parse(jnp.asarray(data), jnp.asarray(lens), jnp.asarray(ref["ld"]),
                       jnp.asarray(ref["dd"]), model, 32, 2, False,
                       r0pos=jnp.asarray(ref["r0pos"]),
                       replen=jnp.asarray(ref["replen"]))
    packed, tables = tp.dp_inputs(T(data), T(ref["ld"]), T(ref["dd"]),
                                  {k: T(v) for k, v in ref["model"].items()},
                                  32, T(ref["r0pos"]), T(ref["replen"]))
    got = tp.dp_parse(packed, tables, T(lens), 32, 2)
    for name, g, w in zip(("price", "from", "choice", "rkind"), got, want):
        assert g.shape == (4, 2048 + 33), name
        eq(g, w, name)


def test_extract_tokens_matches_jax(case):
    data, lens, ref = case
    rng = np.random.default_rng(8)
    lens2 = lens.copy()
    lens2[0] = 1000                      # a path from an inner node
    choice = np.where(rng.random(ref["choice"].shape) < 0.5, ref["choice"], 7)
    want = jp.extract_tokens(jnp.asarray(ref["frm"]), jnp.asarray(choice),
                             jnp.asarray(lens2))
    got = tp.extract_tokens(T(ref["frm"]), T(choice), T(lens2))
    for g, r in zip(got, want):
        eq(g, r)
