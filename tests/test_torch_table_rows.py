"""K10's and K12's closed forms as their kernels use them, on the CPU.

``csrc/search_list.cuh`` and ``csrc/dp_input_row.cuh`` built by g++ into
serial host loops (no g++ skips them):

- K10's table: T[0] from each place's window staged as 32-bit words
  (``window_words``: 16-byte aligned chunks, their words joined by a
  funnel shift, a window
  that crosses max_n byte by byte), levels 1-11 a level at a time, and
  the levels past them by the column-stripe form (``stripe_step``,
  ``stripe_entry``) where max_n is a multiple of 2,048, else a pass a
  level (``level_entry``), as ``cuda_search.upper_route`` chooses: equal
  to ``_suffix_table_plain``'s rank and T and to the JAX package's
  ``_suffix_rank_lcp``, every entry (the wrapped ones too);
- the word-staged consecutive LCP equal to the byte form (a serial
  restatement here, over ``suffix_word``) on every pair of places, the
  windows at every alignment, crossing max_n, at max_n 1, 2, 3 and 33
  and depths 1, 5, 31 and 32;
- K12's rows (``dp_input_row::row``) equal to ``_dp_inputs_plain``'s at
  lc + lp 0 to 5 and lc8 lp4, and with prices past 16 bits.
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
from lzma_tpu_torch.core.layout import ProbLayout  # noqa: E402
from lzma_tpu_torch.ops import cuda_search  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402
from lzma_tpu_torch.ops import device_parser as tp  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lzma_tpu_torch", "csrc")
#: the H100's opt-in shared bytes a block (upper_route's limit)
H100_SMEM = 232_448

HOST = r"""
#include <vector>

#include "dp_input_row.cuh"
#include "search_list.cuh"

using namespace search_list;

// K10 serially: rank, T[0] from the windows' words (or cl), levels
// 1..min(levels - 1, 11) a level at a time, the rest by stripes of `cols`
// columns (cols > 0; max_n a multiple of kTableTile) or a level at a
// time.  row_off: the byte each lane's row starts at in `data` (rows
// `pitch` bytes apart), so that the windows meet every alignment.
extern "C" void table_host(const uint8_t* data, int64_t pitch, int row_off,
                           const int64_t* n, const int64_t* order,
                           const int64_t* cl, int lanes, int64_t max_n,
                           int depth, int levels, int cols, int64_t* rank,
                           int32_t* T) {
  const int nw = ((depth < 32 ? depth : 32) + 3) / 4;
  for (int l = 0; l < lanes; ++l) {
    const uint8_t* row = data + l * pitch + row_off;
    const int64_t* ord = order + l * max_n;
    int32_t* TL = T + l * levels * max_n;
    for (int64_t i = 0; i < max_n; ++i) rank[l * max_n + ord[i]] = i;
    for (int64_t i = 0; i < max_n; ++i) {
      if (cl != nullptr) {
        TL[i] = static_cast<int32_t>(cl[l * max_n + i]);
        continue;
      }
      uint32_t a[kWords], b[kWords];
      window_words(row, max_n, ord[i], nw, a);
      if (i == 0) {
        TL[i] = 0;
        continue;
      }
      window_words(row, max_n, ord[i - 1], nw, b);
      TL[i] = consecutive_lcp_words(a, ord[i], b, ord[i - 1], n[l], nw, depth);
    }
    const int top = levels - 1 < kTableTileLevels ? levels - 1 : kTableTileLevels;
    for (int k = 0; k < top; ++k)
      for (int64_t j = 0; j < max_n; ++j)
        TL[(k + 1) * max_n + j] = level_entry(TL + k * max_n, j, k, max_n);
    if (cols > 0) {
      const int rows = static_cast<int>(max_n / kTableTile);
      for (int c0 = 0; c0 < kTableTile; c0 += cols) {
        std::vector<int32_t> cur(rows * cols), nxt(rows * cols);
        for (int t = 0; t < rows; ++t)
          for (int c = 0; c < cols; ++c)
            cur[t * cols + c] = TL[kTableTileLevels * max_n +
                                   static_cast<int64_t>(t) * kTableTile + c0 + c];
        for (int k = kTableTileLevels + 1; k < levels; ++k) {
          const int step = stripe_step(k, rows);
          for (int t = 0; t < rows; ++t)
            for (int c = 0; c < cols; ++c) {
              nxt[t * cols + c] = stripe_entry(cur.data(), cols, t, c, step, rows);
              TL[k * max_n + static_cast<int64_t>(t) * kTableTile + c0 + c] =
                  nxt[t * cols + c];
            }
          cur.swap(nxt);
        }
      }
    } else {
      for (int k = top; k < levels - 1; ++k)
        for (int64_t j = 0; j < max_n; ++j)
          TL[(k + 1) * max_n + j] = level_entry(TL + k * max_n, j, k, max_n);
    }
  }
}

// The byte form of the consecutive LCP: the equal leading bytes of two
// suffixes' nw prefix words (word 0 marked past n), clamped to depth.
// wa, wb: their windows.
static int consecutive_lcp(const uint8_t* wa, int64_t pa, const uint8_t* wb,
                           int64_t pb, int64_t n, int nw, int depth) {
  int cl = 0;
  for (int k = 0; k < nw; ++k) {
    const uint32_t x = suffix_word(wa, k, pa, n) ^ suffix_word(wb, k, pb, n);
    if (x != 0) {
      cl += clz32(x) >> 3;
      break;
    }
    cl += 4;
  }
  return cl < depth ? cl : depth;
}

// The consecutive LCP of every pair (pa, pb) of places of one row, by
// the byte windows (each byte at (o + b) mod max_n) and by the staged
// words: into bytes_out and words_out, max_n x max_n each.  Returns how
// many staged words differ from word_at's of the byte windows.
extern "C" int lcp_pairs_host(const uint8_t* row, int64_t max_n, int64_t n,
                               int depth, int32_t* bytes_out,
                               int32_t* words_out) {
  const int nw = ((depth < 32 ? depth : 32) + 3) / 4;
  int bad = 0;
  for (int64_t pa = 0; pa < max_n; ++pa)
    for (int64_t pb = 0; pb < max_n; ++pb) {
      uint8_t wa[kWindow], wb[kWindow];
      for (int b = 0; b < 4 * nw; ++b) {
        wa[b] = row[(pa + b) % max_n];
        wb[b] = row[(pb + b) % max_n];
      }
      uint32_t xa[kWords], xb[kWords];
      window_words(row, max_n, pa, nw, xa);
      window_words(row, max_n, pb, nw, xb);
      for (int k = 0; k < nw; ++k) bad += xa[k] != word_at(wa, k);
      bytes_out[pa * max_n + pb] = consecutive_lcp(wa, pa, wb, pb, n, nw, depth);
      words_out[pa * max_n + pb] =
          consecutive_lcp_words(xa, pa, xb, pb, n, nw, depth);
    }
  return bad;
}

// K12's rows serially, each by dp_input_row::row.
extern "C" void rows_host(const uint8_t* data, const int64_t* ld,
                          const int64_t* dd, const int64_t* r0pos,
                          const int64_t* rank, const int32_t* T, int levels,
                          const int64_t* lens, const int32_t* ep0,
                          const int32_t* ep1, int64_t S, int64_t lit_base,
                          const int32_t* tables, int n_lanes, int64_t n_pos,
                          int m, int lc, int lp, int32_t* out) {
  const int C = 6 * m + 5;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int64_t base = lane * n_pos;
    dp_input_row::Lane ln;
    ln.data = data + base;
    ln.ld = ld + base * m;
    ln.dd = dd + base * m;
    ln.r0pos = r0pos + base;
    ln.ep0 = ep0 + lane * S + lit_base;
    ln.ep1 = ep1 + lane * S + lit_base;
    ln.tables = tables + lane * dp_input_row::kTableInts;
    ln.sfx = search_list::Lane{};
    ln.sfx.rank = rank + base;
    ln.sfx.T = T + base * levels;
    ln.sfx.max_n = n_pos;
    ln.n_pos = n_pos;
    ln.len = lens[lane];
    ln.m = m;
    ln.lc = lc;
    ln.lp = lp;
    ln.pairs16 = false;
    for (int64_t i = 0; i < n_pos; ++i)
      dp_input_row::row(ln, i, out + (base + i) * C);
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/search_list.cuh and dp_input_row.cuh built by g++ into serial
    host loops."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain")
    work = tmp_path_factory.mktemp("table_rows_host")
    src, lib = work / "table_rows_host.cpp", work / "libtable_rows_host.so"
    src.write_text(HOST)
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


_L = ctypes.c_longlong


def _lanes(max_n, seed):
    """Two lanes of max_n bytes: bench data (n = max_n) and text with
    runs of a repeated block (n = max_n - 37, at least 0)."""
    rng = np.random.default_rng(seed)
    bench = np.frombuffer(generate_bench_data(max_n), np.uint8)
    text = np.frombuffer((text_part() * (1 + max_n // 100_000))[:max_n],
                         np.uint8).copy()
    cut = rng.integers(0, max(1, max_n - 64))
    text[cut:cut + 64] = text[:64][:len(text[cut:cut + 64])]
    return np.stack([bench, text]), np.array([max_n, max(0, max_n - 37)],
                                             np.int64)


def _host_table(host, data, n, order, depth, cols, row_off, cl=None):
    N, max_n = data.shape
    levels = cuda_search.levels_of(max_n)
    pitch = max_n + 8
    buf = np.zeros(N * pitch + 32, np.uint8)
    for l in range(N):
        buf[l * pitch + row_off:l * pitch + row_off + max_n] = data[l]
    order_np = np.ascontiguousarray(order.numpy())
    cl_np = None if cl is None else np.ascontiguousarray(cl.numpy())
    rank = np.full((N, max_n), -7, np.int64)
    T = np.full((N, levels, max_n), -7, np.int32)
    host.table_host(_ptr(buf), _L(pitch), row_off, _ptr(n), _ptr(order_np),
                    None if cl_np is None else _ptr(cl_np), N, _L(max_n),
                    depth, levels, cols, _ptr(rank), _ptr(T))
    return rank, T


#: max_n: no level past the tile (2,048 x 1 and 2; 2,049), the column
#: stripes (2,048 x 8: rows 8; x 3: rows 3, a step that wraps), and a
#: pass a level (6,000)
TABLE_WIDTHS = [2048, 4096, 2049, 16384, 6144, 6000]


@pytest.mark.parametrize("max_n", TABLE_WIDTHS)
def test_host_table_equals_the_plain_table_and_jax(host, max_n):
    data, n = _lanes(max_n, max_n)
    depth = 32
    td, tn = torch.from_numpy(data.copy()), torch.from_numpy(n)
    order = tm._sort_packed(tm._search_keys_plain(td, tn, depth, [])[0])
    want_rank, want_T = tm._suffix_table_plain(td, tn, order, depth)
    route, cols = cuda_search.upper_route(max_n, H100_SMEM)
    assert route == ("stripes" if max_n in (16384, 6144) else
                     "levels" if max_n == 6000 else "tile")
    rank, T = _host_table(host, data, n, order, depth, cols, max_n % 4)
    np.testing.assert_array_equal(rank, want_rank.numpy())
    np.testing.assert_array_equal(T, want_T.numpy())
    pos = jnp.arange(max_n, dtype=jnp.int32)
    j_rank, j_T = jax.jit(jax.vmap(
        lambda d, k: jm._suffix_rank_lcp(d, k, pos, max_n, depth)))(
            jnp.asarray(data), jnp.asarray(n.astype(np.int32)))
    np.testing.assert_array_equal(rank, np.asarray(j_rank))
    np.testing.assert_array_equal(T, np.asarray(j_T))


@pytest.mark.parametrize("cols", [8, 16, 32])
def test_host_stripes_of_every_width_equal_the_plain_table(host, cols):
    """The stripe form at each width upper_route may take (8 and 16 for
    taller lanes), on 2,048 x 8 places with the LCP given (the lazy
    search's route past depth 32) and computed at depth 13."""
    max_n = 16384
    data, n = _lanes(max_n, cols)
    td, tn = torch.from_numpy(data.copy()), torch.from_numpy(n)
    rng = np.random.default_rng(cols)
    order = torch.from_numpy(np.stack([rng.permutation(max_n)
                                       for _ in range(2)]))
    cl = torch.from_numpy(rng.integers(0, 274, (2, max_n)))
    for depth, given in ((273, cl), (13, None)):
        want_rank, want_T = tm._suffix_table_plain(td, tn, order, depth, given)
        rank, T = _host_table(host, data, n, order, depth, cols, 3, given)
        np.testing.assert_array_equal(rank, want_rank.numpy())
        np.testing.assert_array_equal(T, want_T.numpy())


def test_upper_route_sizes_the_stripes():
    """32 columns while two levels of a stripe fit 64 KiB, then 16 and 8;
    past the card's limit at 8 columns, and at widths that are not a
    multiple of 2,048, a pass a level."""
    assert cuda_search.upper_route(1 << 18, H100_SMEM) == ("stripes", 32)
    assert cuda_search.upper_route(1 << 19, H100_SMEM) == ("stripes", 32)
    assert cuda_search.upper_route(1 << 20, H100_SMEM) == ("stripes", 16)
    assert cuda_search.upper_route(1 << 21, H100_SMEM) == ("stripes", 8)
    assert cuda_search.upper_route(1 << 22, H100_SMEM) == ("stripes", 8)
    assert cuda_search.upper_route(1 << 23, H100_SMEM) == ("levels", 0)
    assert cuda_search.upper_route((1 << 23) + 1, H100_SMEM) == ("levels", 0)
    assert cuda_search.upper_route(4096, H100_SMEM) == ("tile", 0)


@pytest.mark.parametrize("max_n", [1, 2, 3, 33])
@pytest.mark.parametrize("depth", [1, 5, 31, 32])
def test_host_word_lcp_equals_the_byte_lcp(host, max_n, depth):
    """Every pair of places, the row at each of the four alignments, n
    below max_n (the mark) and at it; a window of max_n < 32 wraps more
    than once."""
    rng = np.random.default_rng(max_n * 100 + depth)
    raw = rng.integers(0, 3, max_n).astype(np.uint8)
    for off in range(4):
        buf = np.zeros(max_n + 32, np.uint8)
        buf[off:off + max_n] = raw
        row = ctypes.c_void_p(buf.ctypes.data + off)
        for n in {max_n, max_n // 2}:
            by = np.zeros((max_n, max_n), np.int32)
            wo = np.zeros((max_n, max_n), np.int32)
            assert host.lcp_pairs_host(row, _L(max_n), _L(n), depth,
                                       _ptr(by), _ptr(wo)) == 0
            np.testing.assert_array_equal(wo, by)
            assert by.max() <= depth


W = 1024
M = 4
#: (lc, lp, pb): lc + lp 0 to 5, and lc8 lp4
ROW_PRESETS = [(0, 0, 0), (1, 0, 2), (2, 0, 2), (3, 0, 2), (0, 4, 2),
               (3, 2, 1), (8, 4, 4)]


def _row_args(lc, lp, pb, fb, seed):
    """_dp_inputs_plain's arguments on two lanes (bench data, text with n
    700): random pairs, a rep0 trace with sources before the block, the
    lanes' own suffix table at depth fb, probabilities in the coder's
    band (the table at depth min(fb, 32))."""
    rng = np.random.default_rng(seed)
    bench = np.frombuffer(generate_bench_data(W), np.uint8)
    text = np.frombuffer(text_part()[:W], np.uint8)
    data = np.stack([bench, text])
    lens = np.array([W, 700], np.int64)
    ld = rng.integers(0, fb + 1, (2, W, M))
    dd = np.where(rng.random((2, W, M)) < 0.5, rng.integers(-1, 128, (2, W, M)),
                  rng.integers(128, 1 << 30, (2, W, M)))
    r0pos = rng.integers(0, W + 300, (2, W))
    td, tn = torch.from_numpy(data.copy()), torch.from_numpy(lens)
    depth = min(fb, 32)
    order = tm._sort_packed(tm._search_keys_plain(td, tn, depth, [])[0])
    rank, T = tm._suffix_table_plain(td, tn, order, depth)
    S = ProbLayout(lc, lp, pb, pos_bits=pb).size
    planes = tp._price_planes(torch.from_numpy(
        rng.integers(32, 2017, (2, S))), torch.int32)
    tables = tp.price_tables(*planes, lc, lp, pb)
    return (td, torch.from_numpy(ld), torch.from_numpy(dd),
            torch.from_numpy(r0pos), (rank, T), tn, planes,
            (tables["ps_price"], tables["dfull"], tables["align_price"]), lc,
            lp, pb, fb)


def _host_rows(host, args):
    data, ld, dd, r0pos, (rank, T), lens, planes, tables, lc, lp, pb, _ = args
    arr = [np.ascontiguousarray(t.numpy().astype(np.int64)) for t in
           (ld, dd, r0pos, rank, lens)]
    d = np.ascontiguousarray(data.numpy())
    ep = [np.ascontiguousarray(p.numpy().astype(np.int32)) for p in planes]
    tab = np.ascontiguousarray(np.concatenate(
        [t.reshape(t.shape[0], -1).numpy() for t in tables], axis=1
    ).astype(np.int32))
    t_np = np.ascontiguousarray(T.numpy())
    L, N = d.shape
    got = np.full((L, N, 6 * M + 5), -7, np.int32)
    host.rows_host(_ptr(d), *(_ptr(a) for a in arr[:4]), _ptr(t_np),
                   t_np.shape[1], _ptr(arr[4]), _ptr(ep[0]), _ptr(ep[1]),
                   _L(ep[0].shape[1]),
                   _L(ProbLayout(lc, lp, pb, pos_bits=pb).literal), _ptr(tab),
                   L, _L(N), M, lc, lp, _ptr(got))
    return got


@pytest.mark.parametrize("lc,lp,pb", ROW_PRESETS,
                         ids=lambda v: str(v))
def test_host_rows_equal_the_plain_rows(host, lc, lp, pb):
    fb = 32 if lc + lp < 5 else 273
    args = _row_args(lc, lp, pb, fb, seed=lc * 10 + lp)
    want = tp._dp_inputs_plain(*args).numpy()
    np.testing.assert_array_equal(_host_rows(host, args), want)


def test_host_rows_price_past_16_bits_as_the_plain_rows(host):
    """The literal slots and the distance tables are read as int32: a
    table entry of 70,000 and a plane entry of 2^16 give the plain
    version's rows."""
    args = list(_row_args(3, 0, 2, 32, seed=4))
    dfull = args[7][1].clone()
    dfull[0, 2, 17] = 70_000
    args[7] = (args[7][0], dfull, args[7][2])
    ep1 = args[6][1].clone()
    ep1[1, ProbLayout(3, 0, 2, pos_bits=2).literal + 17] = 1 << 16
    args[6] = (args[6][0], ep1)
    want = tp._dp_inputs_plain(*args).numpy()
    assert want.max() >= 70_000
    np.testing.assert_array_equal(_host_rows(host, args), want)
