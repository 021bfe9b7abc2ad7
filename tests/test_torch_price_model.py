"""The optimal rounds' price model (K18's contract) on the CPU.

``device_parser._price_model_plain``, the plain version K18
(``cuda_model.price_model_cuda``) is held to on the card, takes a
round's slot counts n, n1 and gives the price planes, the distance
tables and the DP tables' row.  It is held to the JAX package's
``empirical_probs`` + ``build_price_model`` on the same numpy-seeded
(ctx, bit) streams, with exact equality, at lc3 lp0 pb2, lc0 lp2 pb0 and
lc8 lp4 pb4, fb 5, 32 and 273, over 2-4 lanes: the planes against JAX's
``PRICE_TABLE`` lookups of its probabilities, the tables field by field
against JAX's dict, the row against ``_dp_tables`` of JAX's values.  One
lane's slots carry counts whose int32 numerator wraps past 2^31 (a
negative quotient, clamped) and past 2^32 (a small positive one).

``csrc/price_model.cuh``, K18's closed forms, is built by g++ into a
serial host loop (a lane's slots before the literal coders priced first,
then each table entry from them; the planes slot by slot) and held to
the plain version at the same cases; its price table and arena layout
equal ``core/prices.PRICE_TABLE`` and ``ProbLayout``.  Those tests skip
without g++.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.core.layout import ProbLayout  # noqa: E402
from lzma_tpu_torch.core.prices import PRICE_TABLE  # noqa: E402
from lzma_tpu_torch.ops import cuda_model  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402
from lzma_tpu_torch.ops.device_encoder import pair_counts  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
PARAMS = [(3, 0, 2), (0, 2, 0), (8, 4, 4)]
FBS = [5, 32, 273]
DIST = ("ps_price", "dfull", "align_price")
#: the slot whose counts wrap the numerator, and its two counts (n0 past
#: 2^31 / 4096 and past 2^32 / 4096)
WRAP_SLOT = 3


def _streams(lc, lp, pb, lanes, seed, B=6000):
    """(ctx, bits, totals) of `lanes` lanes: most pairs on the slots before
    the literal coders (each slot its own bias toward 1), the rest over
    the whole arena, some ctx -1 (not coded), totals below B; lane 1
    empty where there are more than 2 lanes."""
    rng = np.random.default_rng(seed)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    S = layout.size
    head = rng.integers(0, layout.literal, (lanes, B))
    any_ = rng.integers(-1, S, (lanes, B))
    ctx = np.where(rng.random((lanes, B)) < 0.7, head, any_).astype(np.int32)
    bias = rng.random(S)
    bits = (rng.random((lanes, B)) < bias[np.maximum(ctx, 0)]).astype(np.int32)
    totals = rng.integers(B // 2, B + 1, lanes).astype(np.int32)
    if lanes > 2:
        totals[1] = 0
    return ctx, bits, totals


def _wrap_streams():
    """Two lanes at lc3 lp0 pb2: lane 0's slot WRAP_SLOT coded 600,000
    times as 0 (n0 past 524,280: the numerator wraps negative) and slot
    WRAP_SLOT + 1 1,100,000 times (past 1,048,568: it wraps past 2^32 to
    a small positive quotient), its slot WRAP_SLOT + 2 half ones."""
    S = ProbLayout(3, 0, 2, pos_bits=2).size
    B = 1_800_000
    rng = np.random.default_rng(5)
    ctx = rng.integers(-1, S, (2, B)).astype(np.int32)
    bits = rng.integers(0, 2, (2, B)).astype(np.int32)
    ctx[0, :600_000] = WRAP_SLOT
    bits[0, :600_000] = 0
    ctx[0, 600_000:1_700_000] = WRAP_SLOT + 1
    bits[0, 600_000:1_700_000] = 0
    bits[0, 600_000:600_100] = 1
    ctx[0, 1_700_000:] = WRAP_SLOT + 2
    totals = np.array([B, 4000], np.int32)
    return ctx, bits, totals


def _jax_model(ctx, bits, totals, lc, lp, pb, fb):
    """JAX's probabilities, planes and price-model dict of the streams."""
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    probs = jp.empirical_probs(jnp.asarray(ctx), jnp.asarray(bits),
                               jnp.asarray(totals), S)
    data = jnp.zeros((ctx.shape[0], 8), jnp.uint8)
    model = jp.build_price_model(data, probs, lc, lp, pb, fb)
    pt = np.asarray(PRICE_TABLE)
    p = np.asarray(probs)
    planes = (pt[p >> 2], pt[(2048 - p) >> 2])
    return p, planes, {k: np.asarray(v) for k, v in model.items()}


def _counts(ctx, bits, totals, S):
    return pair_counts(torch.from_numpy(ctx), torch.from_numpy(bits),
                       torch.from_numpy(totals), S)


def _check(got, planes, model, fb, what):
    ep0, ep1, ps, dfull, align, row = got
    for name, g, w in (("EP0", ep0, planes[0]), ("EP1", ep1, planes[1]),
                       ("ps_price", ps, model["ps_price"]),
                       ("dfull", dfull, model["dfull"]),
                       ("align_price", align, model["align_price"])):
        assert tuple(g.shape) == w.shape, (what, name)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {name}")
    want_row = tp._dp_tables({k: torch.tensor(v) for k, v in model.items()},
                             fb)
    assert row.dtype == torch.int32
    assert torch.equal(row, want_row), what


@pytest.mark.parametrize("fb", FBS)
@pytest.mark.parametrize("lc,lp,pb", PARAMS)
def test_plain_price_model_equals_jax(lc, lp, pb, fb):
    """_price_model_plain of the counts = JAX's empirical_probs +
    build_price_model, planes, tables field by field and the row."""
    lanes = 2 if lc == 8 else 3 + (fb == 32)
    ctx, bits, totals = _streams(lc, lp, pb, lanes, seed=lc * 31 + pb * 7 + fb)
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    n, n1 = _counts(ctx, bits, totals, S)
    got = tp._price_model_plain(n, n1, lc, lp, pb, fb)
    assert [t.dtype for t in got] == [torch.int64] * 5 + [torch.int32]
    _, planes, model = _jax_model(ctx, bits, totals, lc, lp, pb, fb)
    _check(got, planes, model, fb, f"lc{lc} lp{lp} pb{pb} fb{fb}")
    # the flag tables and rep_sel of JAX's dict, as the row holds them
    n_ps, W = 1 << pb, fb - 1
    parts = tp._split_tables(got[5], n_ps, W)
    names = ("lt_match", "lt_rep", "im0", "im1", "r0l0", "r0l1", "ir0", "ir1",
             "rep_sel")
    for name, part in zip(names, parts):
        want = model[name]
        if name.startswith("lt_"):
            want = want[:, :, :W]
        elif name in ("im0", "im1", "r0l0", "r0l1"):
            want = want.transpose(0, 2, 1)
        np.testing.assert_array_equal(part.numpy(), want, err_msg=name)


def test_plain_price_model_wraps_the_numerator_as_jax():
    """A lane whose counts wrap the int32 numerator past 2^31 and past
    2^32: the same probabilities, planes and tables as JAX's."""
    ctx, bits, totals = _wrap_streams()
    S = ProbLayout(3, 0, 2, pos_bits=2).size
    n, n1 = _counts(ctx, bits, totals, S)
    assert int(n[0, WRAP_SLOT] - n1[0, WRAP_SLOT]) > 524_280
    assert int(n[0, WRAP_SLOT + 1] - n1[0, WRAP_SLOT + 1]) > 1_048_568
    probs, planes, model = _jax_model(ctx, bits, totals, 3, 0, 2, 32)
    # past 2^31 the quotient is negative (clamped to 32); past 2^32 it is
    # a small positive one, far from the true probability near 2048
    assert probs[0, WRAP_SLOT] == 32
    assert 32 < probs[0, WRAP_SLOT + 1] < 1024
    np.testing.assert_array_equal(tp.probs_from_counts(n, n1).numpy(), probs)
    _check(tp._price_model_plain(n, n1, 3, 0, 2, 32), planes, model, 32,
           "wrap")


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_the_device():
    ctx, bits, totals = _streams(3, 0, 2, 2, seed=3)
    S = ProbLayout(3, 0, 2, pos_bits=2).size
    n, n1 = _counts(ctx, bits, totals, S)
    got = cuda_model.price_model_cuda(n, n1, 3, 0, 2, 32)
    want = tp._price_model_plain(n, n1, 3, 0, 2, 32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_model.price_model_cuda(n.to("meta"), n1.to("meta"), 3, 0, 2, 32)


def test_rounds_price_through_the_wrapper(monkeypatch):
    """tokenize_optimal prices each round through price_model_cuda, in
    stage build_price_model; stage empirical_probs stays, empty."""
    from lzma_tpu_torch.ops.device_encoder import probing

    calls = []
    real = cuda_model.price_model_cuda

    def spy(*args):
        calls.append(args[2:])
        return real(*args)

    monkeypatch.setattr(cuda_model, "price_model_cuda", spy)
    rng = np.random.default_rng(2)
    data = torch.from_numpy(np.tile(rng.integers(0, 4, 300), 2).astype(np.uint8)
                            .reshape(2, 300))
    lens = torch.tensor([300, 250])
    with probing() as probe:
        tp.tokenize_optimal(data, lens, 300, lc=3, lp=0, pb=2, fb=32)
    assert calls == [(3, 0, 2, 32)] * tp.N_ITER
    secs = probe["seconds"]
    assert all(len(secs[k]) == tp.N_ITER for k in tp.MODEL_STAGES)


# ------------------------------------------------- price_model.cuh by g++
HOST_MODEL = r"""
#include <cstdint>
#include <vector>
#include "price_model.cuh"

using namespace price_model;

extern "C" void table_host(int* pt) {
  for (int j = 0; j < kPriceEntries; ++j) pt[j] = price_entry(j);
}

extern "C" void layout_host(int lc, int lp, int pb, int* out) {
  const Layout y = make_layout(lc, lp, pb);
  const int v[] = {y.is_match, y.is_rep, y.is_rep_g0, y.is_rep_g1,
                   y.is_rep_g2, y.is_rep0_long, y.pos_slot, y.spec_pos,
                   y.align, y.len_coder, y.rep_len_coder, y.literal, y.size,
                   y.len_mid, y.len_high};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
}

// K18 a lane at a time, as a block of its first range: the slots before
// the literal coders priced, then every table entry; the planes slot by
// slot, as its other blocks
extern "C" void model_host(const int* n, const int* n1, int lanes, int64_t S,
                           int lc, int lp, int pb, int fb, int* ep0, int* ep1,
                           int* dist, int* rows) {
  int pt[kPriceEntries];
  table_host(pt);
  const Layout y = make_layout(lc, lp, pb);
  const int T = row_entries(pb, fb);
  std::vector<int> e0(y.literal), e1(y.literal);
  for (int l = 0; l < lanes; ++l) {
    const int64_t at = l * S;
    for (int s = 0; s < y.literal; ++s) {
      const int p = prob_of(n[at + s], n1[at + s]);
      e0[s] = price0(pt, p);
      e1[s] = price1(pt, p);
    }
    const Prices e{e0.data(), e1.data()};
    for (int k = 0; k < kDistEntries; ++k)
      dist[l * kDistEntries + k] = dist_entry(e, y, k);
    for (int k = 0; k < T; ++k) rows[l * T + k] = row_entry(e, y, fb - 1, k);
  }
  for (int64_t s = 0; s < lanes * S; ++s) {
    const int p = prob_of(n[s], n1[s]);
    ep0[s] = price0(pt, p);
    ep1[s] = price1(pt, p);
  }
}
"""


@pytest.fixture(scope="module")
def host_model(tmp_path_factory):
    """csrc/price_model.cuh built by g++ into a serial host loop."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("model_host")
    src, lib = work / "model_host.cpp", work / "libmodel_host.so"
    src.write_text(HOST_MODEL)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _host(host, n, n1, lc, lp, pb, fb):
    n, n1 = (np.ascontiguousarray(t.numpy().astype(np.int32)) for t in (n, n1))
    L, S = n.shape
    ep0, ep1 = np.full((L, S), -7, np.int32), np.full((L, S), -7, np.int32)
    dist = np.full((L, cuda_model.DIST_ENTRIES), -7, np.int32)
    rows = np.full((L, tp.table_size(pb, fb)), -7, np.int32)
    host.model_host(_ptr(n), _ptr(n1), L, ctypes.c_int64(S), lc, lp, pb, fb,
                    _ptr(ep0), _ptr(ep1), _ptr(dist), _ptr(rows))
    return ep0, ep1, dist, rows


def test_host_table_and_layout_equal_the_port(host_model):
    pt = np.zeros(512, np.int32)
    host_model.table_host(_ptr(pt))
    np.testing.assert_array_equal(pt, np.asarray(PRICE_TABLE))
    names = ("is_match", "is_rep", "is_rep_g0", "is_rep_g1", "is_rep_g2",
             "is_rep0_long", "pos_slot", "spec_pos", "align", "len_coder",
             "rep_len_coder", "literal", "size", "len_mid", "len_high")
    for lc, lp, pb in PARAMS + [(4, 0, 4), (0, 0, 1)]:
        out = np.zeros(15, np.int32)
        host_model.layout_host(lc, lp, pb, _ptr(out))
        y = ProbLayout(lc, lp, pb, pos_bits=pb)
        assert out.tolist() == [getattr(y, k) for k in names], (lc, lp, pb)


@pytest.mark.parametrize("fb", FBS)
@pytest.mark.parametrize("lc,lp,pb", PARAMS)
def test_host_model_equals_the_plain_version(host_model, lc, lp, pb, fb):
    lanes = 2 if lc == 8 else 3
    ctx, bits, totals = _streams(lc, lp, pb, lanes, seed=lc + pb + fb)
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    n, n1 = _counts(ctx, bits, totals, S)
    want = tp._price_model_plain(n, n1, lc, lp, pb, fb)
    ep0, ep1, dist, rows = _host(host_model, n, n1, lc, lp, pb, fb)
    np.testing.assert_array_equal(ep0, want[0].numpy())
    np.testing.assert_array_equal(ep1, want[1].numpy())
    np.testing.assert_array_equal(
        dist, torch.cat([t.reshape(lanes, -1) for t in want[2:5]], 1).numpy())
    np.testing.assert_array_equal(rows, want[5].numpy())


def test_host_model_wraps_the_numerator(host_model):
    ctx, bits, totals = _wrap_streams()
    S = ProbLayout(3, 0, 2, pos_bits=2).size
    n, n1 = _counts(ctx, bits, totals, S)
    want = tp._price_model_plain(n, n1, 3, 0, 2, 32)
    got = _host(host_model, n, n1, 3, 0, 2, 32)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[5:]):
        np.testing.assert_array_equal(g, w.numpy())
