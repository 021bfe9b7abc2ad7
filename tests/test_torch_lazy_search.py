"""The lazy search, factored for its CUDA kernels (K15 doubling groups,
K16 descent LCP, K17 best matches), on the CPU.

The plain versions lzma_tpu_torch's kernels are held to on the card
(``device_matcher._doubling_groups_plain``, ``_descent_lcp_plain``,
``_best_matches_plain``) against the JAX package: the 273-deep suffix
rank and table they build equal ``_suffix_rank_lcp``'s, the descent's LCP
is its table's first level, the best matches equal
``find_best_matches_rmq``'s and the tokens ``tokenize``'s, exactly, on
lanes with runs past 273 bytes, a period-20 pattern, a data word equal to
a position's mark, n below max_n, n = 0, and at max_n 1, 2, 3 and 33
(where the descent's indices wrap and clamp).  Each doubling level's ids
equal a numpy restatement (the dense rank of the level's keys).  Then
``csrc/lazy_search.cuh``, the kernels' closed forms, built by g++ into
serial host loops (a doubling level flagged by its sorted key, the best
matches from tiles of 1, 5 and 256 places staged with the places before
them), gives the plain versions' ids, keys, LCPs and matches on the same
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
from lzma_tpu_torch.ops import cuda_lazy, cuda_search  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
W = 2048
DEPTH = tm.MATCH_MAX
DICT = 1500   # below W: the window drops the farthest candidates
MARK_AT = 0x32


def _wide():
    """Eight lanes of W bytes: bench data; text with n = W - 300; runs of
    one byte past 273; a period-20 pattern; a lane of n = 40 whose bytes
    at 10 hold 80 00 00 32, the mark of position 0x32 (past n), followed
    by the 28 bytes after position 0x32 + 4, so that a data suffix and a
    marked one share their 32-byte key; an empty lane (n = 0); random
    bytes with n = 1000; all zeros."""
    rng = np.random.default_rng(17)
    bench = np.frombuffer(generate_bench_data(W), np.uint8)
    text = np.frombuffer(text_part()[:W], np.uint8)
    runs = np.concatenate([np.full(700, 97), rng.integers(0, 256, 148),
                           np.full(400, 98), rng.integers(0, 4, 300),
                           np.full(500, 97)]).astype(np.uint8)
    period = np.tile(rng.integers(0, 256, 20), W // 20 + 1)[:W].astype(np.uint8)
    mark = rng.integers(0, 256, W).astype(np.uint8)
    mark[10:14] = (0x80, 0, 0, MARK_AT)
    mark[14:42] = mark[MARK_AT + 4:MARK_AT + 32]
    rows = [bench, text, runs, period, mark,
            rng.integers(0, 256, W).astype(np.uint8),
            rng.integers(0, 256, W).astype(np.uint8), np.zeros(W, np.uint8)]
    lens = np.array([W, W - 300, W, W, 40, 0, 1000, W], np.int32)
    return np.stack(rows), lens


def _narrow(max_n):
    """Three lanes of max_n bytes: zeros, random bytes, a period-2
    pattern cut one short (n = max_n - 1)."""
    rng = np.random.default_rng(max_n)
    rows = [np.zeros(max_n, np.uint8),
            rng.integers(0, 256, max_n).astype(np.uint8),
            np.tile(np.array([7, 9], np.uint8), max_n)[:max_n]]
    return np.stack(rows), np.array([max_n, max_n, max_n - 1], np.int32)


SHAPES = {"w2048": _wide(), **{f"max_n{m}": _narrow(m) for m in (1, 2, 3, 33)}}


def _torch(data, lens):
    return torch.from_numpy(data.copy()), torch.from_numpy(lens).long()


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    """One shape's lanes and JAX's 273-deep rank and table."""
    data, lens = SHAPES[request.param]
    max_n = data.shape[1]
    pos = jnp.arange(max_n, dtype=jnp.int32)
    rank, T = jax.jit(jax.vmap(lambda d, n: jm._suffix_rank_lcp(
        d, n, pos, max_n, DEPTH)))(jnp.asarray(data), jnp.asarray(lens))
    return dict(name=request.param, data=data, lens=lens,
                rank=np.asarray(rank), T=np.asarray(T))


def _pieces(data, lens):
    """The plain pieces as _suffix_rank_lcp runs them past depth 32: the
    suffix order from K9's 32-byte keys, every doubling level's (order,
    ids, key), the descent's LCP, rank and T."""
    d, n = _torch(data, lens)
    max_n = d.shape[1]
    keys = tm._search_keys_plain(d, n, 32, [])[0]
    order = tm._sort_packed(keys)
    levels = []
    g, key = tm._doubling_groups_plain(order, d, n, next_span=32)
    levels.append((order, g, key))
    span = 32
    while span < DEPTH:
        order = torch.sort(key, dim=1, stable=True).indices
        g, key = tm._doubling_groups_plain(
            order, d, n, g, span, 2 * span if 2 * span < DEPTH else 0)
        levels.append((order, g, key))
        span *= 2
    grps = [x[1] for x in levels]
    cl = tm._descent_lcp_plain(order, grps, d, n, DEPTH)
    rank, T = tm._suffix_table_plain(d, n, order, DEPTH, cl)
    return dict(levels=levels, order=order, cl=cl, rank=rank, T=T,
                max_n=max_n)


def _dense_rank(*keys):
    """Each lane's dense rank of the key tuples (lexicographic, the first
    key primary)."""
    out = np.zeros(keys[0].shape, np.int64)
    for i in range(keys[0].shape[0]):
        rows = np.stack([k[i] for k in keys], axis=1)
        out[i] = np.unique(rows, axis=0, return_inverse=True)[1].reshape(-1)
    return out


def _words(data, lens):
    """The 8 prefix words of every position, word 0 marked past n."""
    N, max_n = data.shape
    pos = np.arange(max_n)
    b = [np.roll(data.astype(np.int64), -i, axis=1) for i in range(32)]
    words = [(b[4 * w] << 24) | (b[4 * w + 1] << 16) | (b[4 * w + 2] << 8)
             | b[4 * w + 3] for w in range(8)]
    words[0] = np.where(pos[None] < lens[:, None], words[0],
                        0x80000000 ^ pos[None])
    return words


def test_plain_pieces_equal_jax_suffix_table(shape):
    """rank and T from the doubling, the descent and K10 equal JAX's; the
    descent's LCP is the table's first level; the port's
    _suffix_rank_lcp gives the same."""
    got = _pieces(shape["data"], shape["lens"])
    np.testing.assert_array_equal(got["rank"].numpy(), shape["rank"])
    np.testing.assert_array_equal(got["T"].numpy(), shape["T"])
    np.testing.assert_array_equal(got["cl"].numpy(), shape["T"][:, 0])
    d, n = _torch(shape["data"], shape["lens"])
    rank, T = tm._suffix_rank_lcp(
        d, n, DEPTH, cuda_search.search_keys_cuda(d, n, 32, [])[0])
    np.testing.assert_array_equal(rank.numpy(), shape["rank"])
    np.testing.assert_array_equal(T.numpy(), shape["T"])


def test_doubling_levels_are_dense_ranks(shape):
    """Level 0's ids are the dense rank of the 8 marked words (a data word
    equal to a mark shares its group), level t + 1's the dense rank of
    (ids_t[i], ids_t[i + span]), spans 32, 64, 128, 256; each key is
    ids * max_n + ids[i + next span]."""
    data, lens = shape["data"], shape["lens"]
    got = _pieces(data, lens)
    max_n = got["max_n"]
    want = _dense_rank(*_words(data, lens))
    span = 32
    for t, (_, g, key) in enumerate(got["levels"]):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"level {t}")
        if key is None:
            assert t == len(got["levels"]) - 1
        else:
            np.testing.assert_array_equal(
                key.numpy(), want * max_n + np.roll(want, -span, axis=1))
        want = _dense_rank(want, np.roll(want, -span, axis=1))
        span *= 2
    assert len(got["levels"]) == 5
    if shape["name"] == "w2048":
        # the lane whose data word is the mark of MARK_AT: both suffixes in
        # one 32-byte group, apart at 64 bytes
        lv = got["levels"]
        assert lv[0][1][4, 10] == lv[0][1][4, MARK_AT]
        assert lv[1][1][4, 10] != lv[1][1][4, MARK_AT]


@pytest.mark.parametrize("fb", [5, 32, 273])
def test_best_matches_equal_jax(shape, fb):
    """_best_matches_plain on the plain table and the hash key's stable
    sort, and the port's find_best_matches_rmq whole, equal JAX's
    find_best_matches_rmq (lengths past fb kept, up to 273 and n -
    pos)."""
    data, lens = shape["data"], shape["lens"]
    dict_size = min(DICT, data.shape[1])
    want = jax.jit(jax.vmap(lambda d, n: jm.find_best_matches_rmq(
        d, n, dict_size, fb, 4)))(jnp.asarray(data), jnp.asarray(lens))
    want = [np.asarray(w) for w in want]
    d, n = _torch(data, lens)
    h = tm._search_keys_plain(d, n, 32, [4])[1][0]
    s = torch.sort(h, dim=1, stable=True)
    got = tm._best_matches_plain(
        s.values, s.indices, torch.tensor(shape["rank"], dtype=torch.int64),
        torch.tensor(shape["T"]), n, dict_size, fb, 4)
    whole = tm.find_best_matches_rmq(d, n, dict_size, fb, 4)
    for g, w_ in ((got, want), (whole, want)):
        np.testing.assert_array_equal(g[0].numpy(), w_[0], err_msg="best_len")
        np.testing.assert_array_equal(g[1].numpy(), w_[1], err_msg="best_dist")
    if fb == 273 and shape["name"] == "w2048":
        assert int(whole[0].max()) == 273


def test_tokenize_equals_jax():
    """The port's lazy tokenize whole equals JAX's on the wide lanes, from
    position 0 and from 256 (a preset's end), fb 32, two candidates."""
    data, lens = SHAPES["w2048"]
    d, n = _torch(data, lens)
    for start in (0, 256):
        want = jax.jit(jax.vmap(lambda x, k: jm.tokenize(
            x, k, DICT, 32, 2, start=start)))(jnp.asarray(data),
                                              jnp.asarray(lens))
        got = tm.tokenize(d, n, DICT, 32, 2, start=start)
        for name, g, w_ in zip(("t_pos", "t_len", "t_dist", "t_valid", "ntok"),
                               got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                          err_msg=f"{name} from {start}")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions and count no
    launch; another device raises."""
    before = (cuda_lazy.GROUP_LAUNCHES, cuda_lazy.DESCENT_LAUNCHES,
              cuda_lazy.BEST_LAUNCHES)
    data, lens = SHAPES["max_n33"]
    d, n = _torch(data, lens)
    got = _pieces(data, lens)
    order, g0, key0 = got["levels"][0]
    first = tm._sort_packed(tm._search_keys_plain(d, n, 32, [])[0])
    w = cuda_lazy.doubling_groups_cuda(first, d, n, next_span=32)
    assert torch.equal(w[0], g0) and torch.equal(w[1], key0)
    grps = [x[1] for x in got["levels"]]
    assert torch.equal(cuda_lazy.descent_lcp_cuda(got["order"], grps, d, n,
                                                  DEPTH), got["cl"])
    h = cuda_search.search_keys_cuda(d, n, 32, [4])[1][0]
    s = torch.sort(h, dim=1, stable=True)
    args = (s.values, s.indices, got["rank"], got["T"], n, 20, 8, 4)
    assert all(torch.equal(a, b) for a, b in zip(
        cuda_lazy.best_matches_cuda(*args), tm._best_matches_plain(*args)))
    assert (cuda_lazy.GROUP_LAUNCHES, cuda_lazy.DESCENT_LAUNCHES,
            cuda_lazy.BEST_LAUNCHES) == before
    with pytest.raises(ValueError):
        cuda_lazy.doubling_groups_cuda(first.to("meta"), d.to("meta"),
                                       n.to("meta"))
    with pytest.raises(ValueError):
        cuda_lazy.best_matches_cuda(s.values.to("meta"), s.indices.to("meta"),
                                    *args[2:])


def test_lazy_stages_are_probed():
    """A lazy encode inside probing() records each of LAZY_STAGES (the
    doubling's sorts and levels several times), no "tokenize" stage."""
    from lzma_tpu_torch.format.properties import LzmaParams
    from lzma_tpu_torch.ops.device_encoder import encode_batch, probing

    data, _ = SHAPES["w2048"]
    blocks = [bytes(data[0, :512]), bytes(data[1, :300])]
    with probing() as probe:
        encode_batch(blocks, LzmaParams(), parse="lazy", device="cpu")
    secs = probe["seconds"]
    assert {k: len(secs[k]) for k in tm.LAZY_STAGES} == dict(
        lazy_keys=1, lazy_sort=6, lazy_groups=5, lazy_lcp=1, suffix_table=1,
        best_matches=1, path=1, compact=1)
    assert "tokenize" not in secs


# ------------------------------------------------ lazy_search.cuh by g++
HOST_LOOPS = r"""
#include <cstdint>
#include <vector>
#include "lazy_search.cuh"

using namespace lazy_search;

// one doubling level, a lane at a time: flags (the 32-byte level's marked
// words, else the sorted key), their running count, the scatter, then
// the next key
extern "C" void groups_host(const int64_t* order, const uint8_t* data,
                            const int64_t* n, const int64_t* sorted_key,
                            int64_t next_span, int lanes, int64_t max_n,
                            int64_t* ids, int64_t* key) {
  const int m = static_cast<int>(max_n);
  for (int l = 0; l < lanes; ++l) {
    const int64_t at = l * max_n;
    const int64_t* o = order + at;
    int64_t id = -1;
    for (int i = 0; i < m; ++i) {
      bool fresh = true;
      if (i > 0) {
        if (sorted_key == nullptr) {
          uint32_t a[kWords], b[kWords];
          marked_words(data + at, m, n[l], static_cast<int>(o[i]), a);
          marked_words(data + at, m, n[l], static_cast<int>(o[i - 1]), b);
          fresh = words_differ(a, b);
        } else {
          fresh = key_differs(sorted_key[at + i], sorted_key[at + i - 1]);
        }
      }
      id += fresh;
      ids[at + o[i]] = id;
    }
    if (next_span > 0) {
      const int s = static_cast<int>(next_span % max_n);
      for (int i = 0; i < m; ++i) key[at + i] = next_key(ids + at, m, s, i);
    }
  }
}

extern "C" void descent_host(const int64_t* order, const int64_t* const* levels,
                             int n_levels, const uint8_t* data,
                             const int64_t* n, int depth, int lanes,
                             int64_t max_n, int64_t* cl) {
  for (int l = 0; l < lanes; ++l) {
    const int64_t at = l * max_n;
    const int64_t* g[kMaxLevels];
    for (int t = 0; t < n_levels; ++t) g[t] = levels[t] + at;
    const int64_t* o = order + at;
    for (int64_t i = 0; i < max_n; ++i)
      cl[at + i] = deep_lcp(g, n_levels, data + at, max_n, n[l], i, o[i],
                            o[(i + max_n - 1) % max_n], depth);
  }
}

extern "C" void best_host(const int32_t* sorted, const int64_t* order,
                          const int64_t* rank, const int32_t* T, int levels,
                          const int64_t* n, int64_t dict_size, int fb, int k,
                          int lanes, int64_t max_n, int tile,
                          int64_t* best_len, int64_t* best_dist) {
  // a tile of places and the k before it staged at a time, as a block
  const int m = static_cast<int>(max_n);
  std::vector<int32_t> key(tile + k), pos(tile + k), rnk(tile + k);
  for (int l = 0; l < lanes; ++l) {
    const int64_t at = l * max_n;
    const Table tb{T + at * levels, m, n[l], dict_size};
    for (int j0 = 0; j0 < m; j0 += tile) {
      const int first = j0 - k;
      for (int x = 0; x < tile + k; ++x) {
        const int r = first + x;
        key[x] = pos[x] = rnk[x] = -7;
        if (r >= 0 && r < m) {
          key[x] = sorted[at + r];
          pos[x] = static_cast<int>(order[at + r]);
          rnk[x] = static_cast<int>(rank[at + pos[x]]);
        }
      }
      const Staged st{key.data(), pos.data(), rnk.data(), first};
      for (int j = j0; j < j0 + tile && j < m; ++j) {
        int64_t bl, bd;
        best_staged(st, tb, j, k, fb, &bl, &bd);
        best_len[at + pos[j - first]] = bl;
        best_dist[at + pos[j - first]] = bd;
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_lazy(tmp_path_factory):
    """csrc/lazy_search.cuh built by g++ into serial host loops."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("lazy_host")
    src, lib = work / "lazy_host.cpp", work / "liblazy_host.so"
    src.write_text(HOST_LOOPS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _np(t):
    return np.ascontiguousarray(t.numpy())


def _L(x):
    return ctypes.c_longlong(x)


@pytest.mark.parametrize("name", list(SHAPES))
def test_host_groups_and_descent_equal_the_plain_pieces(host_lazy, name):
    """groups_host gives every doubling level's ids and key (the 32-byte
    level by marked words, a doubling level by its sorted key, the
    previous key in this level's order), descent_host the descent's LCP,
    on the plain orders and levels."""
    data, lens = SHAPES[name]
    got = _pieces(data, lens)
    N, max_n = data.shape
    d, n = np.ascontiguousarray(data), lens.astype(np.int64)
    prev_key = None
    for t, (order, g, key) in enumerate(got["levels"]):
        ids = np.full((N, max_n), -7, np.int64)
        k = np.full((N, max_n), -7, np.int64)
        nxt = 0 if key is None else (32 << t)
        sk = (None if prev_key is None else
              np.ascontiguousarray(np.take_along_axis(prev_key, _np(order), 1)))
        host_lazy.groups_host(_ptr(_np(order)), _ptr(d), _ptr(n),
                              None if sk is None else _ptr(sk), _L(nxt), N,
                              _L(max_n), _ptr(ids), _ptr(k))
        np.testing.assert_array_equal(ids, g.numpy(), err_msg=f"level {t}")
        if key is not None:
            np.testing.assert_array_equal(k, key.numpy(), err_msg=f"key {t}")
            prev_key = _np(key)
    levels = [_np(x[1]) for x in got["levels"][:-1]]
    ptrs = (ctypes.c_void_p * len(levels))(*(a.ctypes.data for a in levels))
    cl = np.full((N, max_n), -7, np.int64)
    host_lazy.descent_host(_ptr(_np(got["order"])), ptrs, len(levels), _ptr(d),
                           _ptr(n), DEPTH, N, _L(max_n), _ptr(cl))
    np.testing.assert_array_equal(cl, got["cl"].numpy())


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("fb,k", [(5, 4), (32, 4), (273, 1), (273, 16)])
def test_host_best_matches_equal_the_plain_matches(host_lazy, name, fb, k):
    """best_host, tiles of 1, 5 and 256 places staged with their k places
    before, gives the plain matches."""
    data, lens = SHAPES[name]
    got = _pieces(data, lens)
    N, max_n = data.shape
    d, n = _torch(data, lens)
    dict_size = min(DICT, max_n)
    h = tm._search_keys_plain(d, n, 32, [4])[1][0]
    s = torch.sort(h, dim=1, stable=True)
    want = tm._best_matches_plain(s.values, s.indices, got["rank"], got["T"],
                                  n, dict_size, fb, k)
    T = _np(got["T"])
    for tile in (1, 5, 256):
        bl = np.full((N, max_n), -7, np.int64)
        bd = np.full((N, max_n), -7, np.int64)
        host_lazy.best_host(_ptr(_np(s.values)), _ptr(_np(s.indices)),
                            _ptr(_np(got["rank"])), _ptr(T), T.shape[1],
                            _ptr(n.numpy()), _L(dict_size), fb, k, N,
                            _L(max_n), tile, _ptr(bl), _ptr(bd))
        np.testing.assert_array_equal(bl, want[0].numpy(), err_msg=f"{tile}")
        np.testing.assert_array_equal(bd, want[1].numpy(), err_msg=f"{tile}")
