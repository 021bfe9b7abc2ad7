// The optimal parse's candidate search around its sorts: the sort keys
// (K9), the suffix rank and sparse LCP min table (K10) and the
// per-position match lists (K11), on the per-position closed forms of
// search_list.cuh.
//
// They replace the jitted JAX device code of lzma_tpu/ops/
// device_matcher.py that XLA compiles for the device (it has no
// pallas_call; under jax.jit at device_parser.py:1595 and
// device_matcher.py:550), which the plain versions in
// lzma_tpu_torch/ops/device_matcher.py restate:
//   K9  search_keys: _tier_candidates' hashes (:309-342) and
//       _suffix_rank_lcp's prefix words (:436-448) -- the suffix
//       lexsort's packed int64 keys (depth <= 32) and the used tiers'
//       int32 hash keys, (n_keys, n_lanes, max_n) each;
//   K10 suffix_table: the rest of _suffix_rank_lcp after its sort
//       (:420-525) -- rank (n_lanes, max_n) int64 and the table T
//       (n_lanes, levels, max_n) int32, T[0] the consecutive LCP (at
//       depth <= 32 from the prefix words, else given), T[k+1][j] =
//       min(T[k][j], T[k][(j - 2^k) mod max_n]);
//   K11 match_lists: _neighbor_candidates (:286-306), the dedup and cap
//       and the merge of _rmq_search (:578-681), _lcp_query (:528-547) --
//       lens and dists (n_lanes, max_n, width) int64, counts (n_lanes,
//       max_n) int64.
// The sorts between them stay torch.sort, as the reference leaves them
// to XLA's sort.
//
// What bounds them on this card: the bytes.  K9 reads each lane's bytes
// once and writes its keys (60 B a position at fb 32 and the optimal
// parse's seven tiers); K10 reads the order and writes rank and the
// table's levels (4 B a level a position); K11 reads a few planes a tier
// at each position's place in the tier's order (the sort's values and
// indices near it), rank and two table entries a candidate at random,
// and writes the lists (16 B a list slot).  What the designs do:
//   K9  a block stages its positions' bytes and the 31 after them in
//       shared memory once; every thread reads its window there;
//   K10 grid 1 scatters rank and writes T[0], a thread a place of the
//       order, each window read once into shared memory and compared
//       with the one before it; grid 2 builds levels 1..kTileLevels of a
//       tile of kTile places from T[0] and a window of kHalo before it
//       in shared memory (one pass over T[0], the levels written once);
//       each wider level is one pass of its own;
//   K11 grid 1 writes each tier's inverse order (a position's place);
//       grid 2 runs a thread a position with its kept candidates in
//       registers (a list of at most 16 or 32), or, past 32, in its
//       dists row, which the merge then overwrites in place.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "search_list.cuh"

namespace {

using search_list::kSpans;
using search_list::kWindow;
using search_list::Lane;

constexpr int kThreads = 256;
constexpr int kListThreads = 128;
constexpr int kTile = 2048;      // K10: places a block builds in shared memory
constexpr int kHalo = 2048;      // and the places before them it reads
constexpr int kTileLevels = 11;  // levels 1..11 there: 2^11 - 1 <= kHalo
constexpr int kTileThreads = 512;

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t m) {
  i %= m;
  return i < 0 ? i + m : i;
}

// ------------------------------------------------------------------ K9
// A block a tile of kThreads positions of a lane.
__global__ void __launch_bounds__(kThreads)
keys_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
            int n_lanes, int64_t max_n, int n_tiles, int nw, int nk,
            int mask, int64_t* __restrict__ suffix,
            int* __restrict__ tiers) {
  __shared__ uint8_t win[kThreads + kWindow];
  const int lane = blockIdx.x / n_tiles;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x % n_tiles) * kThreads;
  const uint8_t* row = data + lane * max_n;
  for (int i = threadIdx.x; i < kThreads + kWindow; i += kThreads) {
    int64_t q = p0 + i;
    if (q >= max_n) q %= max_n;
    win[i] = row[q];
  }
  __syncthreads();
  const int64_t p = p0 + threadIdx.x;
  if (p >= max_n) return;
  const uint8_t* w = win + threadIdx.x;
  const int64_t nn = n[lane];
  const int64_t plane = static_cast<int64_t>(n_lanes) * max_n;
  const int64_t at = lane * max_n + p;
  for (int k = 0; k < nk; ++k) {
    suffix[k * plane + at] = search_list::suffix_key(w, k, nw, p, nn);
  }
  int32_t keys[kSpans];
  search_list::tier_keys(w, p, nn, mask, keys);
  int slot = 0;
#pragma unroll
  for (int i = 0; i < kSpans; ++i) {
    if (mask >> i & 1) tiers[slot++ * plane + at] = keys[i];
  }
}

// ----------------------------------------------------------------- K10
// Grid 1: rank[order[i]] = i and T[0][i], a thread a place i.  cl (the
// consecutive LCP, int64) where given, else from the prefix words.
__global__ void __launch_bounds__(kThreads)
table_base_kernel(const uint8_t* __restrict__ data,
                  const int64_t* __restrict__ n,
                  const int64_t* __restrict__ order,
                  const int64_t* __restrict__ cl, int64_t max_n,
                  int n_tiles, int nw, int depth, int levels,
                  int64_t* __restrict__ rank, int* __restrict__ T) {
  __shared__ uint8_t win[kThreads][kWindow];
  const int lane = blockIdx.x / n_tiles;
  const int64_t i = static_cast<int64_t>(blockIdx.x % n_tiles) * kThreads +
                      threadIdx.x;
  const bool live = i < max_n;
  const int64_t* ord = order + lane * max_n;
  int* T0 = T + lane * static_cast<int64_t>(levels) * max_n;
  const int64_t o = live ? ord[i] : 0;
  if (live) rank[lane * max_n + o] = i;
  if (cl != nullptr) {
    if (live) T0[i] = static_cast<int>(cl[lane * max_n + i]);
    return;
  }
  const uint8_t* row = data + lane * max_n;
  if (live) {
    for (int b = 0; b < 4 * nw; ++b) win[threadIdx.x][b] = row[wrap(o + b, max_n)];
  }
  __syncthreads();
  if (!live) return;
  int c = 0;
  if (i > 0) {
    const int64_t q = ord[i - 1];
    uint8_t own[kWindow];
    const uint8_t* prev = win[threadIdx.x > 0 ? threadIdx.x - 1 : 0];
    if (threadIdx.x == 0) {
      for (int b = 0; b < 4 * nw; ++b) own[b] = row[wrap(q + b, max_n)];
      prev = own;
    }
    c = search_list::consecutive_lcp(win[threadIdx.x], o, prev, q, n[lane], nw,
                                     depth);
  }
  T0[i] = c;
}

// Grid 2: levels 1..top of a tile of kTile places, from T[0] over the
// tile and the kHalo places before it (wrapping), in shared memory.
__global__ void __launch_bounds__(kTileThreads)
table_tile_kernel(int64_t max_n, int n_tiles, int levels, int top,
                  int* __restrict__ T) {
  __shared__ int buf[2][kTile + kHalo];
  const int lane = blockIdx.x / n_tiles;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x % n_tiles) * kTile;
  int* TL = T + lane * static_cast<int64_t>(levels) * max_n;
  for (int i = threadIdx.x; i < kTile + kHalo; i += kTileThreads) {
    buf[0][i] = TL[wrap(j0 - kHalo + i, max_n)];
  }
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < top; ++k) {
    const int s = 1 << k;
    for (int i = threadIdx.x; i < kTile + kHalo; i += kTileThreads) {
      const int v = buf[cur][i];
      buf[cur ^ 1][i] = i >= s ? min(v, buf[cur][i - s]) : v;
    }
    __syncthreads();
    cur ^= 1;
    int* Tk = TL + (k + 1) * max_n;
    for (int i = threadIdx.x; i < kTile; i += kTileThreads) {
      if (j0 + i < max_n) Tk[j0 + i] = buf[cur][kHalo + i];
    }
  }
}

// Grid 3: level k + 1 from level k, a thread a place.
__global__ void __launch_bounds__(kThreads)
table_level_kernel(int64_t max_n, int n_tiles, int levels, int k,
                   int* __restrict__ T) {
  const int lane = blockIdx.x / n_tiles;
  const int64_t j = static_cast<int64_t>(blockIdx.x % n_tiles) * kThreads +
                      threadIdx.x;
  if (j >= max_n) return;
  int* Tk = T + (lane * static_cast<int64_t>(levels) + k) * max_n;
  const int a = Tk[j], b = Tk[wrap(j - (1LL << k), max_n)];
  Tk[max_n + j] = min(a, b);
}

// ----------------------------------------------------------------- K11
struct Tiers {
  const int* sorted[kSpans];
  const int64_t* order[kSpans];
};

// Grid 1: inv[t][lane][order_t[lane][i]] = i.
__global__ void __launch_bounds__(kThreads)
inverse_kernel(Tiers tiers, int n_lanes, int64_t max_n, int n_tiles,
               int* __restrict__ inv) {
  const int g = blockIdx.x / n_tiles;  // tier * n_lanes + lane
  const int t = g / n_lanes, lane = g % n_lanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x % n_tiles) * kThreads +
                      threadIdx.x;
  if (i >= max_n) return;
  const int64_t at = lane * max_n;
  inv[static_cast<int64_t>(g) * max_n + tiers.order[t][at + i]] =
      static_cast<int>(i);
}

// Grid 2: a thread a position; kCap > 0: the kept candidates in a
// RegList of kCap, else in the position's dists row.
template <int kCap>
__global__ void __launch_bounds__(kListThreads)
lists_kernel(Tiers tiers, int n_tiers, const int* __restrict__ inv,
             const int* __restrict__ cols, int m, int rr, int cap,
             const int64_t* __restrict__ rank, const int* __restrict__ T,
             int levels, const int64_t* __restrict__ n, int64_t dict_size,
             int n_lanes, int64_t max_n, int n_tiles, int width,
             int64_t* __restrict__ lens, int64_t* __restrict__ dists,
             int64_t* __restrict__ counts) {
  const int lane = blockIdx.x / n_tiles;
  const int64_t p = static_cast<int64_t>(blockIdx.x % n_tiles) *
                      kListThreads + threadIdx.x;
  if (p >= max_n) return;
  const int64_t at = lane * max_n;
  Lane ln;
  int64_t r[kSpans];
  for (int t = 0; t < n_tiers; ++t) {
    ln.sorted[t] = tiers.sorted[t] + at;
    ln.order[t] = tiers.order[t] + at;
    r[t] = inv[(static_cast<int64_t>(t) * n_lanes + lane) * max_n + p];
  }
  ln.rank = rank + at;
  ln.T = T + lane * static_cast<int64_t>(levels) * max_n;
  ln.max_n = max_n;
  ln.n = n[lane];
  ln.dict_size = dict_size;
  int64_t* lrow = lens + (at + p) * width;
  int64_t* drow = dists + (at + p) * width;
  int count;
  if constexpr (kCap > 0) {
    search_list::RegList<kCap> list;
    const int len = search_list::gather(ln, cols, m, rr != 0, cap, r, list);
    count = search_list::merge(ln, p, list, len, width, lrow, drow);
  } else {
    search_list::RowList list{drow};
    const int len = search_list::gather(ln, cols, m, rr != 0, cap, r, list);
    count = search_list::merge(ln, p, list, len, width, lrow, drow);
  }
  counts[at + p] = count;
}

int blocks_of(int64_t items, int per, int groups, int* n_tiles) {
  const int64_t tiles = (items + per - 1) / per;
  if (tiles * groups > INT_MAX) return -1;
  *n_tiles = static_cast<int>(tiles);
  return static_cast<int>(tiles * groups);
}

Tiers tiers_of(const void* const* sorted, const void* const* order,
               int n_tiers) {
  Tiers t{};
  for (int i = 0; i < n_tiers; ++i) {
    t.sorted[i] = static_cast<const int*>(sorted[i]);
    t.order[i] = static_cast<const int64_t*>(order[i]);
  }
  return t;
}

}  // namespace

// K9.  data: (n_lanes, max_n) uint8; n: (n_lanes,) int64; nw: the
// suffix order's prefix words (0 for none), nk = ceil(nw / 2) packed
// int64 planes into suffix (nk, n_lanes, max_n); mask: the tier spans
// (bit i: search_list::span_of(i)), one int32 plane each, in span order,
// into tiers (popcount(mask), n_lanes, max_n).  Returns the first CUDA
// error of the launch (0 on success).
extern "C" int lzt_search_keys(const uint8_t* data, const int64_t* n,
                               int n_lanes, int64_t max_n, int nw,
                               int mask, int64_t* suffix, int* tiers,
                               void* stream) {
  int n_tiles = 0;
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_tiles);
  if (n_lanes <= 0 || max_n <= 0 || nw < 0 || nw > 8 || mask < 0 ||
      mask >= (1 << kSpans) || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keys_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, n, n_lanes, max_n, n_tiles, nw, (nw + 1) / 2, mask, suffix, tiers);
  return static_cast<int>(cudaGetLastError());
}

// K10.  data, n: as K9's; order: (n_lanes, max_n) int64, the suffix
// order; cl: (n_lanes, max_n) int64 consecutive LCP by place, or null to
// compute it from nw = ceil(min(depth, 32) / 4) prefix words clamped to
// depth; levels = max(1, bit_length(max_n - 1)); rank: (n_lanes, max_n)
// int64; T: (n_lanes, levels, max_n) int32.  Returns the first CUDA
// error of the launches (0 on success).
extern "C" int lzt_suffix_table(const uint8_t* data, const int64_t* n,
                                const int64_t* order, const int64_t* cl,
                                int n_lanes, int64_t max_n, int depth,
                                int levels, int64_t* rank, int* T,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0, n_big = 0;
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_tiles);
  const int big = blocks_of(max_n, kTile, n_lanes, &n_big);
  if (n_lanes <= 0 || max_n <= 0 || depth <= 0 || levels < 1 || blocks < 0 ||
      big < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nw = ((depth < 32 ? depth : 32) + 3) / 4;
  table_base_kernel<<<blocks, kThreads, 0, s>>>(
      data, n, order, cl, max_n, n_tiles, nw, depth, levels, rank, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int top = levels - 1 < kTileLevels ? levels - 1 : kTileLevels;
  if (top > 0) {
    table_tile_kernel<<<big, kTileThreads, 0, s>>>(max_n, n_big, levels, top, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int k = top; k < levels - 1; ++k) {
    table_level_kernel<<<blocks, kThreads, 0, s>>>(max_n, n_tiles, levels, k, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K11.  sorted, order: n_tiers device pointers to each used tier's sort
// values (int32) and indices (int64), (n_lanes, max_n) each; inv:
// scratch (n_tiers, n_lanes, max_n) int32; cols: (m, 2) int32 device
// pairs (tier, rank) in the order candidates are taken; rr: keep-first
// until cap (the round-robin cut), else the cap largest; width: the
// lists' width (cap); rank, T, levels: K10's; n: (n_lanes,) int64; lens,
// dists: (n_lanes, max_n, width) int64; counts: (n_lanes, max_n) int64.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int lzt_match_lists(const void* const* sorted,
                               const void* const* order, int n_tiers,
                               int* inv, const int* cols, int m, int rr,
                               int width, const int64_t* rank, const int* T,
                               int levels, const int64_t* n,
                               int64_t dict_size, int n_lanes,
                               int64_t max_n, int64_t* lens,
                               int64_t* dists, int64_t* counts,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0, n_list = 0;
  const int blocks = blocks_of(max_n, kThreads, n_tiers * n_lanes, &n_tiles);
  const int list_blocks = blocks_of(max_n, kListThreads, n_lanes, &n_list);
  if (n_lanes <= 0 || max_n <= 0 || n_tiers <= 0 || n_tiers > kSpans ||
      m <= 0 || width <= 0 || width > m || levels < 1 || blocks < 0 ||
      list_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tiers tiers = tiers_of(sorted, order, n_tiers);
  inverse_kernel<<<blocks, kThreads, 0, s>>>(tiers, n_lanes, max_n, n_tiles, inv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (width <= 16) {
    lists_kernel<16><<<list_blocks, kListThreads, 0, s>>>(
        tiers, n_tiers, inv, cols, m, rr, width, rank, T, levels, n,
        dict_size, n_lanes, max_n, n_list, width, lens, dists, counts);
  } else if (width <= 32) {
    lists_kernel<32><<<list_blocks, kListThreads, 0, s>>>(
        tiers, n_tiers, inv, cols, m, rr, width, rank, T, levels, n,
        dict_size, n_lanes, max_n, n_list, width, lens, dists, counts);
  } else {
    lists_kernel<0><<<list_blocks, kListThreads, 0, s>>>(
        tiers, n_tiers, inv, cols, m, rr, width, rank, T, levels, n,
        dict_size, n_lanes, max_n, n_list, width, lens, dists, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
