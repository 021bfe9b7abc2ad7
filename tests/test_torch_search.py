"""The optimal parse's candidate search, factored for its CUDA kernels
(K9 search keys, K10 suffix table, K11 match lists), on the CPU.

The plain versions lzma_tpu_torch's kernels are held to on the card
(``device_matcher._search_keys_plain``, ``_suffix_table_plain``,
``_match_lists_plain``) against the JAX package: the order their keys give
and the table equal ``_suffix_rank_lcp``'s, the tier candidates equal
``_tier_candidates``', and the lists equal ``_rmq_search``'s, exactly, at
fb 5, 20, 32 and 273, "rr" and "near", caps 0, 5 and 12, tuple ranks, and
lanes of length 0, 3 and all zeros.  Then ``csrc/search_list.cuh``, the
kernels' per-position closed forms, built by g++ into serial host loops,
gives the plain versions' keys, consecutive LCPs and lists on the same
inputs (no g++ skips those).
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
from lzma_tpu_torch.bench.corpus import text_part  # noqa: E402
from lzma_tpu_torch.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu_torch.ops import cuda_search  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402
from lzma_tpu_torch.ops.device_parser import SEARCH_STAGES  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
W = 512
DICT = 400   # below W: the window drops the farthest candidates

#: (fb, tier ks, m_cap, m_cap_order): the optimal route's search at three
#: depths and cuts, the hybrid's (uncapped), and tuple ranks cut "rr"
CASES = {
    "fb5-hybrid-near-uncapped": (5, dict(k4=12, k6=4, k8=6, k16=3, k32=2), 0,
                                 "near"),
    "fb32-dp-rr12": (32, tm.DP_TIER_KS, 12, "rr"),
    "fb273-dp-near12": (273, tm.DP_TIER_KS, 12, "near"),
    "fb20-tuples-rr5": (20, dict(k2=2, k3=0, k4=(1, 2, 4, 8), k8=(1, 3),
                                 k16=(2,), k32=1), 5, "rr"),
}


def _lanes():
    """Six lanes of W bytes: bench data, text cut 24 bytes short, all
    zeros, three symbols with n = 3, an empty lane, text repeats."""
    rng = np.random.default_rng(7)
    bench = np.frombuffer(generate_bench_data(W), np.uint8)
    text = np.frombuffer(text_part()[:2 * W], np.uint8)
    rows = [bench, text[W:], np.zeros(W, np.uint8),
            rng.integers(0, 3, W).astype(np.uint8), text[:W],
            np.tile(text[:W // 8], 8)]
    return np.stack(rows), np.array([W, W - 24, W, 3, 0, W], np.int32)


DATA, LENS = _lanes()


def _full_ks(ks):
    return dict(dict(tm.TIER_DEFAULTS), **ks)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One case's plain pieces on the CPU and JAX's _rmq_search."""
    fb, ks, m_cap, order = CASES[request.param]
    full = _full_ks(ks)
    ref = jax.jit(jax.vmap(lambda d, n: jm._rmq_search(
        d, n, DICT, fb, m_cap=m_cap, m_cap_order=order, **full)))(
        jnp.asarray(DATA), jnp.asarray(LENS))
    return dict(name=request.param, fb=fb, ks=ks, m_cap=m_cap, order=order,
                ref=[np.asarray(r) for r in ref])


def _plain(fb, ks, m_cap, order):
    """The port's search through its plain pieces, as _rmq_search runs
    them.  Returns (suffix keys, tier keys, rank, T, lens, dists, counts,
    the sorted tiers)."""
    data, n = torch.from_numpy(DATA.copy()), torch.from_numpy(LENS).long()
    ranks = tm.tier_ranks(ks)
    spans = [s for s, r in ranks if r]
    skeys, tkeys = tm._search_keys_plain(data, n, fb, spans)
    if fb <= 32:
        order_ = tm._sort_packed(skeys)
        rank, T = tm._suffix_table_plain(data, n, order_, fb)
    else:
        assert skeys == []
        rank, T = tm._suffix_rank_lcp(
            data, n, fb, cuda_search.search_keys_cuda(data, n, 32, [])[0])
    sorts = [torch.sort(k, dim=1, stable=True) for k in tkeys]
    sk, so = [s.values for s in sorts], [s.indices for s in sorts]
    lists = tm._match_lists_plain(list(sk), list(so), ranks, rank, T, n, DICT,
                                  m_cap, order)
    return skeys, tkeys, rank, T, *lists, (sk, so)


def test_plain_pieces_equal_jax_rmq_search(case):
    """rank, T, lens, dists and counts of the factored plain versions equal
    JAX's _rmq_search, and so does the port's _rmq_search."""
    got = _plain(case["fb"], case["ks"], case["m_cap"], case["order"])
    names = ("lens", "dists", "counts", "rank", "T")
    for name, g, r in zip(names, (*got[4:7], got[2], got[3]), case["ref"]):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    whole = tm._rmq_search(torch.from_numpy(DATA.copy()),
                           torch.from_numpy(LENS), DICT, case["fb"],
                           case["ks"], case["m_cap"], case["order"])
    for name, g, r in zip(names, whole, case["ref"]):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_suffix_keys_give_the_suffix_order(case):
    """The stable order of K9's packed suffix keys (ceil(nw / 2) of them,
    an odd word alone at fb 20) is JAX's suffix order, its rank's
    inverse, and K10's table from it is JAX's; past fb 32 there are no
    keys and the prefix doubling hands K10 the LCP."""
    fb = case["fb"]
    data, n = torch.from_numpy(DATA.copy()), torch.from_numpy(LENS).long()
    rank_j, T_j = case["ref"][3], case["ref"][4]
    keys, tiers = tm._search_keys_plain(data, n, fb, [])
    assert tiers == []
    if fb > 32:
        assert keys == []
        rank, T = tm._suffix_rank_lcp(
            data, n, fb, cuda_search.search_keys_cuda(data, n, 32, [])[0])
    else:
        nw = -(-fb // 4)
        assert len(keys) == -(-nw // 2)
        assert all(k.dtype == torch.int64 for k in keys)
        order = tm._sort_packed(keys)
        np.testing.assert_array_equal(order.numpy(), np.argsort(rank_j, axis=1))
        rank, T = tm._suffix_table_plain(data, n, order, fb)
    np.testing.assert_array_equal(rank.numpy(), rank_j)
    np.testing.assert_array_equal(T.numpy(), T_j)


def test_tier_keys_give_jax_tier_candidates():
    """Each tier's int32 key, stably sorted, gives JAX's _tier_candidates
    columns (the hybrid's tiers with tuple ranks)."""
    ks = dict(k2=2, k3=1, k4=(1, 3), k6=2, k8=6, k16=(1, 2), k32=2)
    ref = np.asarray(jax.vmap(lambda d, k: jm._tier_candidates(
        d, k, jnp.arange(W, dtype=jnp.int32), W, **ks))(
        jnp.asarray(DATA), jnp.asarray(LENS)))
    data, n = torch.from_numpy(DATA.copy()), torch.from_numpy(LENS).long()
    ranks = tm.tier_ranks(ks)
    _, keys = tm._search_keys_plain(data, n, 32, [s for s, _ in ranks])
    assert all(k.dtype == torch.int32 for k in keys)
    cols = []
    for (span, r), key in zip(ranks, keys):
        s = torch.sort(key, dim=1, stable=True)
        cols += tm._neighbor_step(s.values, s.indices, r)
    np.testing.assert_array_equal(torch.stack(cols, dim=2).numpy(), ref)


def test_list_columns_orders():
    ranks = tm.tier_ranks(dict(k2=2, k3=0, k4=(1, 5), k8=1))
    cols, rr, width = cuda_search.list_columns(ranks, 3, "rr")
    assert rr and width == 3
    assert cols == [(0, 1), (1, 1), (2, 1), (0, 2), (1, 5)]
    cols, rr, width = cuda_search.list_columns(ranks, 0, "rr")
    assert not rr and width == 5
    assert cols == [(0, 1), (0, 2), (1, 1), (1, 5), (2, 1)]
    assert cuda_search.list_columns(ranks, 9, "near")[1:] == (False, 5)
    assert cuda_search.list_columns(ranks, 4, "near")[1:] == (False, 4)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions and count no
    launch; another device raises."""
    before = (cuda_search.KEYS_LAUNCHES, cuda_search.TABLE_LAUNCHES,
              cuda_search.LIST_LAUNCHES)
    data, n = torch.from_numpy(DATA.copy()), torch.from_numpy(LENS).long()
    got = cuda_search.search_keys_cuda(data, n, 32, [4, 8])
    want = tm._search_keys_plain(data, n, 32, [4, 8])
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                  want[0] + want[1]))
    order = tm._sort_packed(got[0])
    assert all(torch.equal(a, b) for a, b in zip(
        cuda_search.suffix_table_cuda(data, n, order, 32),
        tm._suffix_table_plain(data, n, order, 32)))
    assert (cuda_search.KEYS_LAUNCHES, cuda_search.TABLE_LAUNCHES,
            cuda_search.LIST_LAUNCHES) == before
    with pytest.raises(ValueError):
        cuda_search.search_keys_cuda(data.to("meta"), n.to("meta"), 32, [4])


def test_search_stages_are_probed():
    """An optimal encode inside probing() records the search's stages."""
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.ops.device_encoder import encode_batch, probing

    blocks = [bytes(DATA[0, :512]), bytes(DATA[5, :300])]
    with probing() as probe:
        encode_batch(blocks, LzmaParams(), parse="optimal", device="cpu")
    assert all(len(probe["seconds"][k]) == 1 for k in SEARCH_STAGES)
    assert "search" not in probe["seconds"]


# ------------------------------------------------- search_list.cuh by g++
HOST_LOOPS = r"""
#include <cstdint>
#include <vector>
#include "search_list.cuh"

using namespace search_list;

static void window(const uint8_t* row, int64_t max_n, int64_t p, uint8_t* w) {
  for (int b = 0; b < kWindow; ++b) w[b] = row[(p + b) % max_n];
}

extern "C" void keys_host(const uint8_t* data, const int64_t* n, int lanes,
                          int64_t max_n, int nw, int mask, int64_t* suffix,
                          int32_t* tiers) {
  const int64_t plane = lanes * max_n;
  int nt = 0;
  for (int i = 0; i < kSpans; ++i) nt += mask >> i & 1;
  for (int l = 0; l < lanes; ++l) {
    for (int64_t p = 0; p < max_n; ++p) {
      uint8_t w[kWindow];
      window(data + l * max_n, max_n, p, w);
      const int64_t at = l * max_n + p;
      for (int k = 0; k < (nw + 1) / 2; ++k)
        suffix[k * plane + at] = suffix_key(w, k, nw, p, n[l]);
      int32_t out[kSpans];
      tier_keys(w, p, n[l], mask, out);
      for (int i = 0, s = 0; i < kSpans; ++i)
        if (mask >> i & 1) tiers[s++ * plane + at] = out[i];
    }
  }
}

extern "C" void cl_host(const uint8_t* data, const int64_t* n,
                        const int64_t* order, int lanes, int64_t max_n, int nw,
                        int depth, int32_t* cl) {
  for (int l = 0; l < lanes; ++l) {
    const int64_t* o = order + l * max_n;
    for (int64_t i = 0; i < max_n; ++i) {
      int c = 0;
      if (i > 0) {
        uint32_t a[kWords], b[kWords];
        window_words(data + l * max_n, max_n, o[i], nw, a);
        window_words(data + l * max_n, max_n, o[i - 1], nw, b);
        c = consecutive_lcp_words(a, o[i], b, o[i - 1], n[l], nw, depth);
      }
      cl[l * max_n + i] = c;
    }
  }
}

// K11's two grids serially: each tier's inverse words (inverse_word;
// packed as the kernel packs them unless unpacked is set), then blocks of
// `block` positions, each position's candidates gathered tier by tier
// (tier_candidates) into its row, its list and merge (list_position).  A
// register list's lens and dists rows are staged `pitch` words apart, the
// candidate row in the position's own staged rows where m int32 fit them
// (else in a row of its own), and the staged rows are written back as
// the block's `block` threads write them;
// row_list: the kept candidates in each position's dists row even where a
// register list would hold them.
extern "C" void lists_host(const int32_t* const* sorted,
                           const int64_t* const* order, int nt,
                           const int32_t* tcols, const int32_t* start,
                           const int32_t* max_rank, int m, int rr, int width,
                           const int64_t* rank, const int32_t* T, int levels,
                           const int64_t* n, int64_t dict_size, int lanes,
                           int64_t max_n, int block, int row_list,
                           int unpacked, int64_t* lens, int64_t* dists,
                           int64_t* counts) {
  const int stride = width | 1, pitch = 2 * stride + 1;
  const bool own = !row_list && 2 * pitch >= m;
  int top = 0;
  for (int t = 0; t < nt; ++t) top = max_rank[t] > top ? max_rank[t] : top;
  const int rbits = place_bits(max_n);
  const bool packed = !unpacked && inverse_packed(max_n, top);
  for (int l = 0; l < lanes; ++l) {
    const int64_t at0 = l * max_n;
    std::vector<std::vector<uint32_t>> inv(nt, std::vector<uint32_t>(max_n));
    for (int t = 0; t < nt; ++t)
      for (int64_t i = 0; i < max_n; ++i)
        inv[t][order[t][at0 + i]] =
            inverse_word(sorted[t] + at0, i, max_rank[t], rbits, packed);
    const Lane ln{rank + at0, T + at0 * levels, max_n, n[l], dict_size};
    for (int64_t p0 = 0; p0 < max_n; p0 += block) {
      const int np = static_cast<int>(max_n - p0 < block ? max_n - p0 : block);
      const int64_t at = at0 + p0;
      std::vector<int64_t> staged(block * pitch, -5);
      std::vector<int32_t> rows(block * m, -6);
      for (int i = 0; i < np; ++i) {
        int32_t* row = own ? reinterpret_cast<int32_t*>(&staged[i * pitch])
                           : &rows[i * m];
        for (int t = 0; t < nt; ++t)
          tier_candidates(sorted[t] + at0, order[t] + at0, inv[t][p0 + i],
                          rbits, packed, tcols + 2 * start[t],
                          start[t + 1] - start[t], row);
        if (row_list) {
          counts[at + i] = list_position<0>(ln, p0 + i, row, m, rr != 0,
                                            width, width,
                                            lens + (at + i) * width,
                                            dists + (at + i) * width);
          continue;
        }
        int64_t* lrow = &staged[i * pitch];
        counts[at + i] =
            width <= 16
                ? list_position<16>(ln, p0 + i, row, m, rr != 0, width, width,
                                    lrow, lrow + stride)
                : list_position<32>(ln, p0 + i, row, m, rr != 0, width, width,
                                    lrow, lrow + stride);
      }
      if (row_list) continue;
      for (int first = 0; first < block; ++first) {  // as a block's threads
        copy_rows(staged.data(), pitch, lens + at * width, width, np, width,
                  first, block);
        copy_rows(staged.data() + stride, pitch, dists + at * width, width, np,
                  width, first, block);
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_search(tmp_path_factory):
    """csrc/search_list.cuh built by g++ into serial host loops."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("search_host")
    src, lib = work / "search_host.cpp", work / "libsearch_host.so"
    src.write_text(HOST_LOOPS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def test_host_keys_equal_the_plain_keys(host_search):
    data = np.ascontiguousarray(DATA)
    n = LENS.astype(np.int64)
    N, max_n = data.shape
    for depth in (5, 32):
        nw = -(-depth // 4)
        spans = list(tm.TIER_SPANS) if depth == 32 else [2, 4, 8]
        mask = sum(1 << tm.TIER_SPANS.index(s) for s in spans)
        suffix = np.zeros(((nw + 1) // 2, N, max_n), np.int64)
        tiers = np.zeros((len(spans), N, max_n), np.int32)
        host_search.keys_host(_ptr(data), _ptr(n), N, ctypes.c_longlong(max_n),
                              nw, mask, _ptr(suffix), _ptr(tiers))
        want = tm._search_keys_plain(torch.from_numpy(data.copy()),
                                     torch.from_numpy(n), depth, spans)
        np.testing.assert_array_equal(suffix, torch.stack(want[0]).numpy())
        np.testing.assert_array_equal(tiers, torch.stack(want[1]).numpy())


@pytest.mark.parametrize("depth", [5, 20, 32])
def test_host_consecutive_lcp_equals_the_plain_table(host_search, depth):
    data = np.ascontiguousarray(DATA)
    n = LENS.astype(np.int64)
    N, max_n = data.shape
    td, tn = torch.from_numpy(data.copy()), torch.from_numpy(n)
    order = tm._sort_packed(tm._search_keys_plain(td, tn, depth, [])[0])
    order_np = np.ascontiguousarray(order.numpy())
    cl = np.zeros((N, max_n), np.int32)
    host_search.cl_host(_ptr(data), _ptr(n), _ptr(order_np), N,
                        ctypes.c_longlong(max_n), -(-depth // 4), depth, _ptr(cl))
    _, T = tm._suffix_table_plain(td, tn, order, depth)
    np.testing.assert_array_equal(cl, T[:, 0].numpy())


#: positions a list block of the host's passes: K11's own (kListThreads
#: 128), and a small one that cuts the lanes into many blocks
HOST_BLOCKS = {"kernel": 128, "small": 5}


def _host_lists(host_search, sk, so, ranks, rank, T, n, m_cap, order,
                row_list, block, unpacked=0):
    """search_list.cuh's closed forms in K11's two grids (lists_host) on
    the sorted tiers sk, so, rank and T: (lens, dists, counts)."""
    cols, rr, width = cuda_search.list_columns(ranks, m_cap, order)
    grouped, start, top = cuda_search.tier_columns(cols, len(sk))
    N, max_n = rank.shape
    sorted_np = [np.ascontiguousarray(s.numpy()) for s in sk]
    order_np = [np.ascontiguousarray(o.numpy()) for o in so]
    ptrs = (ctypes.c_void_p * len(sk))(*(a.ctypes.data for a in sorted_np))
    optrs = (ctypes.c_void_p * len(so))(*(a.ctypes.data for a in order_np))
    col_np = np.ascontiguousarray(np.array(grouped, np.int32).reshape(-1))
    start_np = np.array(start, np.int32)
    top_np = np.array(top, np.int32)
    rank_np = np.ascontiguousarray(rank.numpy())
    T_np = np.ascontiguousarray(T.numpy())
    n_np = np.ascontiguousarray(n.numpy().astype(np.int64))
    got = [np.full((N, max_n, width), -7, np.int64) for _ in range(2)]
    got_counts = np.zeros((N, max_n), np.int64)
    host_search.lists_host(
        ptrs, optrs, len(sk), _ptr(col_np), _ptr(start_np), _ptr(top_np),
        len(cols), int(rr), width, _ptr(rank_np), _ptr(T_np), T.shape[1],
        _ptr(n_np), ctypes.c_longlong(DICT), N, ctypes.c_longlong(max_n),
        block, row_list, unpacked, _ptr(got[0]), _ptr(got[1]),
        _ptr(got_counts))
    return got[0], got[1], got_counts


@pytest.mark.parametrize("unpacked", [0, 1], ids=["packed", "keys"])
@pytest.mark.parametrize("block", list(HOST_BLOCKS))
@pytest.mark.parametrize("row_list", [0, 1], ids=["registers", "row"])
def test_host_lists_equal_the_plain_lists(case, host_search, row_list, block,
                                          unpacked):
    """search_list.cuh's inverse words (each place's run of equal keys
    packed above it, or its place alone), gather (tier by tier into a
    candidate row, which shares the staged lens and dists rows where it
    fits; from the packed runs, or comparing keys), dedup and cap (a
    register list where it fits and the row list everywhere) and merge,
    fed the plain version's sorted tiers, rank and T, give
    _match_lists_plain's lists."""
    skeys, tkeys, rank, T, lens, dists, counts, (sk, so) = _plain(
        case["fb"], case["ks"], case["m_cap"], case["order"])
    got = _host_lists(host_search, sk, so, tm.tier_ranks(case["ks"]), rank, T,
                      torch.from_numpy(LENS).long(), case["m_cap"],
                      case["order"], row_list, HOST_BLOCKS[block], unpacked)
    for g, w in zip(got, (lens, dists, counts)):
        np.testing.assert_array_equal(g, w.numpy())


#: the list cases at K11's edges: (tier ks, m_cap, m_cap_order): 35
#: columns cut "rr" past 32 (the row list) and "near" at 17, DP_TIERS' 29
#: columns cut to 5 (the candidate row past the staged rows), and a rank
#: too far for the inverse words to pack their runs
EDGE_LISTS = {
    "wide-rr34": (dict(k4=20, k8=10, k16=5), 34, "rr"),
    "wide-near17": (dict(k4=20, k8=10, k16=5), 17, "near"),
    "dp-rr5-own-row": (None, 5, "rr"),
    "far-rank-keys": (dict(k4=(1, 2, 1 << 26), k8=2), 12, "rr"),
}


@pytest.mark.parametrize("name", list(EDGE_LISTS))
@pytest.mark.parametrize("widths", [[1], [2, 1], [3, 3, 2], [W] * 3],
                         ids=lambda w: f"max_n{max(w)}")
def test_host_lists_at_the_kernel_edges(host_search, name, widths):
    """Lanes of 1, 2 and 3 places (and of W), past 32 columns and a
    candidate row of its own: the host's grids at both block sizes equal
    _match_lists_plain."""
    ks, m_cap, order = EDGE_LISTS[name]
    ks = tm.DP_TIER_KS if ks is None else ks
    max_n = max(widths)
    data = torch.from_numpy(np.ascontiguousarray(
        DATA[[0, 5, 1][:len(widths)], :max_n]))
    n = torch.tensor(widths, dtype=torch.int64)
    n[0] = min(int(n[0]), max_n)
    ranks = tm.tier_ranks(ks)
    spans = [s for s, r in ranks if r]
    skeys, tkeys = tm._search_keys_plain(data, n, 32, spans)
    rank, T = tm._suffix_table_plain(data, n, tm._sort_packed(skeys), 32)
    sorts = [torch.sort(k, dim=1, stable=True) for k in tkeys]
    sk, so = [x.values for x in sorts], [x.indices for x in sorts]
    want = tm._match_lists_plain(list(sk), list(so), ranks, rank, T, n, DICT,
                                 m_cap, order)
    for block in HOST_BLOCKS.values():
        for row_list, unpacked in ((0, 0), (1, 0), (0, 1)):
            got = _host_lists(host_search, sk, so, ranks, rank, T, n, m_cap,
                              order, row_list, block, unpacked)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())


def test_k11_tier_columns():
    """Each tier's (rank, column) pairs keep the take order's index."""
    ranks = tm.tier_ranks(dict(k2=2, k3=0, k4=(1, 5), k8=1))
    cols, _, _ = cuda_search.list_columns(ranks, 3, "rr")
    grouped, start, top = cuda_search.tier_columns(cols, 3)
    assert grouped == [(1, 0), (2, 3), (1, 1), (5, 4), (1, 2)]
    assert start == [0, 2, 4, 5]
    assert top == [2, 5, 1]
