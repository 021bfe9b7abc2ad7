"""The optimal round's rep0 trace (K20's contract) and its DP pairs with
the seed's longest pair (K21's), on the CPU.

``cuda_inputs.rep0_trace_cuda`` (K20) and ``cuda_search.list_pairs_cuda``
(K21) take their plain versions for CPU tensors: ``device_parser.
rep0_trace`` is held here to JAX's ``rep0_trace`` on lanes without a
match, a match at position 0, matches whose t_pos is clamped to N - 1
and invalid match tokens; ``device_parser._list_pairs_plain`` to JAX's
``_select_dp_pairs`` (m_dp 4) and to the head of its
``_seed_from_lists`` (the pair it hands the lazy path) on lists of
counts 0, 1, M_DP, M_DP + 1 and full, lengths below 2 among the first
entries, and a longest pair at SEED_MIN_LEN - 1 and at SEED_MIN_LEN.
Then ``csrc/rep0.cuh`` and ``csrc/search_list.cuh``'s K21 forms, built by
g++ into serial host loops (K20's in its kernel's shape: tiles of slots,
runs joined in order, a binary search of the places), give the plain
versions' traces and pairs, and K20's status word is set exactly where
the plain precondition ``check_rep0_order`` raises (no g++ skips those).
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

from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu.ops import device_parser as jp  # noqa: E402
from lzma_tpu_torch.ops import cuda_inputs, cuda_search  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------ rep0 trace
def _token_lanes(N=64, T_=40, seed=0):
    """(t_pos, t_dist, t_valid) (8, T_) for lanes of N positions: no match
    (literals only); a match at position 0; a match past N - 1 (its t_pos
    clamped to N - 1); invalid match tokens between valid ones;
    no valid token; and three drawn streams (ascending positions,
    literals, matches and invalid slots, garbage past the last token)."""
    rng = np.random.default_rng(seed)
    L = 8
    t_pos = rng.integers(0, N + 5, (L, T_))
    t_dist = rng.integers(-2, 30, (L, T_))
    t_valid = np.zeros((L, T_), bool)

    def lane(i, toks):
        for k, (p, d, v) in enumerate(toks):
            t_pos[i, k], t_dist[i, k], t_valid[i, k] = p, d, v

    lane(0, [(p, -1, True) for p in range(0, N, 3)])
    lane(1, [(0, 5, True), (4, -1, True), (9, -1, True)])
    lane(2, [(3, 7, True), (N - 5, 11, True), (N + 2, 13, True)])
    lane(3, [(2, 4, True), (5, 9, False), (6, -1, True), (8, 3, False),
             (10, 6, True), (12, 2, False)])
    for i in range(5, L):
        pos, k = int(rng.integers(0, 4)), 0
        while pos < N + 2 and k < T_:
            valid = rng.random() < 0.85
            d = -1 if rng.random() < 0.4 else int(rng.integers(0, 50))
            t_pos[i, k], t_dist[i, k], t_valid[i, k] = pos, d, valid
            pos += int(rng.integers(1, 6))
            k += 1
    return t_pos, t_dist, t_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_rep0_trace_equals_jax(seed):
    N = 64
    t_pos, t_dist, t_valid = _token_lanes(N, seed=seed)
    want = jp.rep0_trace(jnp.asarray(t_pos), jnp.asarray(t_dist),
                         jnp.asarray(t_valid), N)
    got = tp.rep0_trace(T(t_pos), T(t_dist), T(t_valid), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].eq(0).all() and got[4].eq(0).all()
    assert got[1].eq(5).all()
    assert got[2, N - 1] == 13 and got[2, N - 2] == 11
    tp.check_rep0_order(T(t_pos), T(t_valid))
    before = cuda_inputs.REP0_LAUNCHES
    assert torch.equal(cuda_inputs.rep0_trace_cuda(T(t_pos), T(t_dist),
                                                   T(t_valid), N), got)
    assert cuda_inputs.REP0_LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_inputs.rep0_trace_cuda(*(T(a).to("meta") for a in
                                      (t_pos, t_dist, t_valid)), N)


def _out_of_order():
    """Token lanes K20 refuses, each beside the lane that it breaks:
    equal valid positions, a descent, a valid position below 0; and
    lanes it takes although an invalid token breaks the order."""
    t_pos, t_dist, t_valid = _token_lanes(seed=3)
    bad = []
    for p, v in [(9, True), (2, True), (-1, True), (1, False), (-3, False)]:
        lane_pos, lane_valid = t_pos[1].copy(), t_valid[1].copy()
        lane_pos[3], lane_valid[3] = p, v
        bad.append((lane_pos, lane_valid, v))
    return t_pos, t_dist, t_valid, bad


def test_check_rep0_order_raises_on_broken_lanes():
    t_pos, t_dist, t_valid, bad = _out_of_order()
    tp.check_rep0_order(T(t_pos), T(t_valid))
    for lane_pos, lane_valid, refused in bad:
        p, v = t_pos.copy(), t_valid.copy()
        p[6], v[6] = lane_pos, lane_valid
        if refused:
            with pytest.raises(ValueError, match="strictly ascending"):
                tp.check_rep0_order(T(p), T(v))
        else:
            tp.check_rep0_order(T(p), T(v))


# ------------------------------------------------------------ list pairs
def _lists(seed=0, L=3, N=40, W=12):
    """K11-shaped lists (L, N, W): ascending lengths at each position,
    counts 0, 1, M_DP, M_DP + 1 and W among them, 0 past the count;
    lengths below 2 among the first entries; and a longest pair at
    SEED_MIN_LEN - 1 and at SEED_MIN_LEN."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, W + 1, (L, N))
    counts[0, :6] = [0, 1, 4, 5, W, 2]
    cl = np.zeros((L, N, W), np.int64)
    cd = np.zeros((L, N, W), np.int64)
    for i in range(L):
        for j in range(N):
            c = counts[i, j]
            cl[i, j, :c] = np.sort(rng.choice(np.arange(0, 60), c,
                                              replace=False))
            cd[i, j, :c] = rng.integers(0, 5000, c)
    cl[1, 0, :2], counts[1, 0] = [2, 3], 2          # longest at 3
    cl[1, 1, :2], counts[1, 1] = [2, 4], 2          # longest at 4
    cl[1, 2, :5], counts[1, 2] = [0, 1, 2, 3, 4], 5  # deeper, at 4
    cl[1, 3, :1], counts[1, 3] = [1], 1             # below 2 and alone
    return cl, cd, counts


def _jax_seed_pairs(cl, cd, counts, monkeypatch):
    """The pair jax _seed_from_lists (min_len SEED_MIN_LEN) hands its lazy
    path, lane by lane: (bl, bd) (L, N)."""
    seen = []

    def path(bl, bd, *args, **kw):
        seen.append((np.asarray(bl), np.asarray(bd)))
        return jnp.zeros(bl.shape, bool)

    monkeypatch.setattr(jm, "greedy_path", path)
    monkeypatch.setattr(jm, "_compact", lambda *args, **kw: None)
    for i in range(cl.shape[0]):
        jp._seed_from_lists(jnp.asarray(cl[i]), jnp.asarray(cd[i]),
                            jnp.asarray(counts[i]), cl.shape[1],
                            min_len=tp.SEED_MIN_LEN)
    return np.stack([b for b, _ in seen]), np.stack([d for _, d in seen])


@pytest.mark.parametrize("seed", [0, 1])
def test_list_pairs_equal_jax(seed, monkeypatch):
    assert tp.M_DP == jp.DEFAULT_M_DP == 4
    cl, cd, counts = _lists(seed)
    ld, dd, bl, bd = tp._list_pairs_plain(T(cl), T(cd), T(counts))
    w_ld, w_dd = jp._select_dp_pairs(jnp.asarray(cl), jnp.asarray(cd),
                                     jnp.asarray(counts), 4)
    np.testing.assert_array_equal(ld.numpy(), np.asarray(w_ld))
    np.testing.assert_array_equal(dd.numpy(), np.asarray(w_dd))
    w_bl, w_bd = _jax_seed_pairs(cl, cd, counts, monkeypatch)
    np.testing.assert_array_equal(bl.numpy(), w_bl)
    np.testing.assert_array_equal(bd.numpy(), w_bd)
    assert bl[1, 0] == 0 and bl[1, 1] == 4 and bl[1, 2] == 4
    assert dd[1, 3, 0] == -1 and ld[1, 2, 3] == 4
    got = cuda_search.list_pairs_cuda(T(cl), T(cd), T(counts))
    assert all(torch.equal(g, w) for g, w in zip(got, (ld, dd, bl, bd)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_search.list_pairs_cuda(*(T(a).to("meta") for a in
                                      (cl, cd, counts)))


# ------------------------------------------- rep0.cuh, K21's forms by g++
HOST_LOOPS = r"""
#include <cstdint>
#include <vector>
#include "rep0.cuh"
#include "search_list.cuh"

// K20 in its kernel's shape: each lane's tiles of `tile` slots, a tile's
// Agg the join of its runs of `per` slots; the tiles' exclusive
// prefixes; then each tile's slots pushed after its prefix into places
// and values, the positions from the prefix's place to the tile's
// filled by a binary search of the places, the last tile's tail to n_pos.
// Returns the status word: 1 where an order broke.
extern "C" int rep0_host(const int64_t* pos, const int64_t* dist,
                         const uint8_t* valid, int n_lanes, int n_tok,
                         int64_t n_pos, int tile, int per, int64_t* r0pos) {
  int status = 0;
  const int n_tiles = (n_tok + tile - 1) / tile;
  std::vector<int64_t> place(tile), value(tile);
  for (int l = 0; l < n_lanes; ++l) {
    const int64_t* p = pos + static_cast<int64_t>(l) * n_tok;
    const int64_t* d = dist + static_cast<int64_t>(l) * n_tok;
    const uint8_t* v = valid + static_cast<int64_t>(l) * n_tok;
    int64_t* out = r0pos + l * n_pos;
    std::vector<rep0::Agg> pre(n_tiles + 1, rep0::empty());
    for (int k = 0; k < n_tiles; ++k) {
      rep0::Agg t = rep0::empty();
      for (int r = 0; r < tile; r += per) {
        rep0::Agg run = rep0::empty();
        for (int i = r; i < r + per && i < tile; ++i) {
          const int j = k * tile + i;
          if (j < n_tok) run = rep0::push(run, p[j], d[j], v[j] != 0);
        }
        t = rep0::join(t, run);
      }
      pre[k + 1] = rep0::join(pre[k], t);
    }
    for (int k = 0; k < n_tiles; ++k) {
      rep0::Agg a = pre[k];
      for (int i = 0; i < tile; ++i) {
        const int j = k * tile + i;
        if (j < n_tok) a = rep0::push(a, p[j], d[j], v[j] != 0);
        place[i] = rep0::place(a, n_pos);
        value[i] = rep0::value(a);
      }
      status |= pre[k + 1].bad;
      const int64_t p0 = rep0::place(pre[k], n_pos);
      const int64_t p1 = rep0::place(pre[k + 1], n_pos);
      for (int64_t q = p0; q < p1; ++q) {
        int lo = -1, hi = tile - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (place[mid] <= q) lo = mid; else hi = mid - 1;
        }
        out[q] = lo < 0 ? rep0::value(pre[k]) : value[lo];
      }
    }
    for (int64_t q = rep0::place(pre[n_tiles], n_pos); q < n_pos; ++q)
      out[q] = rep0::value(pre[n_tiles]);
  }
  return status;
}

// K21 a position at a time.
extern "C" void pairs_host(const int64_t* cl, const int64_t* cd,
                           const int64_t* counts, int width, int64_t n_pos,
                           int m_dp, int64_t* ld, int64_t* dd, int64_t* bl,
                           int64_t* bd) {
  for (int64_t q = 0; q < n_pos; ++q) {
    const int64_t* hl = cl + q * width;
    const int64_t* hd = cd + q * width;
    const int last = search_list::last_entry(counts[q], width);
    search_list::list_pairs(hl, hd, hl[last], hd[last], counts[q], m_dp,
                            ld + q * m_dp, dd + q * m_dp, bl + q, bd + q);
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/rep0.cuh and search_list.cuh built by g++ into host loops."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("rep0_pairs_host")
    src, lib = work / "host.cpp", work / "libhost.so"
    src.write_text(HOST_LOOPS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.rep0_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rep0_host.restype = ctypes.c_int
    lib.pairs_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 4
    return lib


def _host_rep0(host, t_pos, t_valid, t_dist, N, tile, per):
    p, d = T(t_pos).long().contiguous(), T(t_dist).long().contiguous()
    v = T(t_valid).bool().contiguous()
    out = torch.full((p.shape[0], N), -7, dtype=torch.int64)
    status = host.rep0_host(p.data_ptr(), d.data_ptr(), v.data_ptr(),
                            p.shape[0], p.shape[1], N, tile, per,
                            out.data_ptr())
    return status, out


@pytest.mark.parametrize("tile,per", [(1, 1), (3, 2), (8, 4), (2048, 8)])
def test_rep0_closed_forms_equal_the_plain_trace(host, tile, per):
    for seed in (0, 1, 2):
        N = 64
        t_pos, t_dist, t_valid = _token_lanes(N, seed=seed)
        status, out = _host_rep0(host, t_pos, t_valid, t_dist, N, tile, per)
        assert status == 0
        assert torch.equal(out, tp.rep0_trace(T(t_pos), T(t_dist),
                                              T(t_valid), N))
    # tokens but no positions past them, and no tokens at all
    status, out = _host_rep0(host, t_pos[:, :0], t_valid[:, :0],
                             t_dist[:, :0], N, tile, per)
    assert status == 0 and out.eq(0).all()


def test_rep0_status_is_the_plain_precondition(host):
    t_pos, t_dist, t_valid, bad = _out_of_order()
    for lane_pos, lane_valid, refused in bad:
        p, v = t_pos.copy(), t_valid.copy()
        p[6], v[6] = lane_pos, lane_valid
        for tile, per in ((1, 1), (3, 2), (2048, 8)):
            status, _ = _host_rep0(host, p, v, t_dist, 64, tile, per)
            assert status == int(refused)
        try:
            tp.check_rep0_order(T(p), T(v))
        except ValueError:
            assert refused
        else:
            assert not refused


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_list_pair_closed_forms_equal_the_plain_pairs(host, seed):
    lists = [T(a) for a in _lists(seed)]
    L, N, W = lists[0].shape
    want = tp._list_pairs_plain(*lists)
    got = [torch.empty((L, N, 4), dtype=torch.int64) for _ in range(2)] + [
        torch.empty((L, N), dtype=torch.int64) for _ in range(2)]
    host.pairs_host(*(a.data_ptr() for a in lists), W, L * N, 4,
                    *(g.data_ptr() for g in got))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
