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
// table's levels (4 B a level a position: 18 levels, 604 MB of its 747
// at main8M's 32 lanes of 256 KiB); K11 reads each tier's planes
// and a few indices near each position's place in the tier's order,
// rank and two table entries a candidate at random, and writes the lists
// (16 B a list slot); its inverse orders are 4-B stores at random.  What the designs do:
//   K9  a block stages its positions' bytes and the 31 after them in
//       shared memory once; every thread reads its window there;
//   K10 grid 1 scatters rank and writes T[0], a thread a place of the
//       order: its window staged in shared memory as big-endian words
//       (16-byte aligned loads, words joined by a funnel shift; only a window
//       that crosses max_n goes byte by byte, with a running index, so
//       no per-byte remainder is left) and compared word by word with
//       the one before it; grid 2 builds levels 1..kTileLevels of a
//       tile of kTile places from T[0] and a window of kHalo before it
//       in shared memory (one pass over T[0], the levels written once);
//       the levels past the tile, where max_n is a multiple of kTile,
//       are a sparse table over the max_n / kTile rows of each column
//       (level k's stride 2^k is a whole number of rows): grid 3 takes
//       a stripe of up to 32 adjacent columns of level 11 into shared
//       memory once and builds and writes every wider level there
//       (coalesced rows, each level written once); other widths, and
//       lanes whose stripe of 8 columns passes the shared memory, take
//       a pass a wider level (each reading the level below twice);
//       the route is cuda_search.upper_route's, chosen by shape;
//   K11 grid 1 writes each tier's inverse order (a position's place,
//       and packed above it the run of equal keys just before that
//       place), a (tier, lane) at a time so its scattered stores meet in
//       L2; grid 2 runs a thread a position, lane by lane: tier by tier
//       its place and the candidates just before it (the few indices its
//       run says are there, in L2) into a candidate row in shared memory
//       at each column's take-order index; its kept candidates in registers (a
//       list of at most 16 or 32) with compile-time indices, two table
//       reads a candidate, the merge into the block's lens and dists rows
//       staged in shared memory, which the block writes out by
//       consecutive threads; past 32 the list lives in the position's
//       dists row.

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
constexpr int kTile = search_list::kTableTile;  // K10: places a tile block builds
constexpr int kHalo = 2048;      // and the places before them it reads
constexpr int kTileLevels = search_list::kTableTileLevels;  // 2^11 - 1 <= kHalo
constexpr int kTileThreads = 512;
constexpr int kStripeThreads = 256;

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
// consecutive LCP, int64) where given, else from the prefix words: each
// thread's window as nw big-endian words in shared memory (thread 0 also
// stages its predecessor's, in the last row), compared with the one
// before it.  A row's pitch of kWords + 1 words keeps a warp's stores on
// distinct banks.
__global__ void __launch_bounds__(kThreads)
table_base_kernel(const uint8_t* __restrict__ data,
                  const int64_t* __restrict__ n,
                  const int64_t* __restrict__ order,
                  const int64_t* __restrict__ cl, int64_t max_n,
                  int n_tiles, int nw, int depth, int levels,
                  int64_t* __restrict__ rank, int* __restrict__ T) {
  __shared__ uint32_t win[kThreads + 1][search_list::kWords + 1];
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
  const int64_t q = live && i > 0 ? ord[i - 1] : 0;
  if (live) search_list::window_words(row, max_n, o, nw, win[threadIdx.x]);
  if (threadIdx.x == 0 && live && i > 0) {
    search_list::window_words(row, max_n, q, nw, win[kThreads]);
  }
  __syncthreads();
  if (!live) return;
  T0[i] = i > 0 ? search_list::consecutive_lcp_words(
                      win[threadIdx.x], o,
                      win[threadIdx.x > 0 ? threadIdx.x - 1 : kThreads], q,
                      n[lane], nw, depth)
                : 0;
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
    // one wrap at most where max_n >= kHalo (j0 < max_n)
    int64_t j = j0 - kHalo + i;
    if (max_n >= kHalo) {
      j = j < 0 ? j + max_n : j >= max_n ? j - max_n : j;
    } else {
      j = wrap(j, max_n);
    }
    buf[0][i] = TL[j];
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

// Grid 3a (max_n = rows * kTile): levels kTileLevels + 1 .. levels - 1 of
// a stripe of `cols` (a power of two) adjacent columns, all rows: level
// kTileLevels's stripe into shared memory once, then each wider level
// from the one below it there (search_list::stripe_entry), each written
// once as it is made (a warp's stores on consecutive columns).
__global__ void __launch_bounds__(kStripeThreads)
table_stripe_kernel(int64_t max_n, int rows, int cols_log, int n_stripes,
                    int levels, int* __restrict__ T) {
  extern __shared__ int stripe[];  // two levels of rows x cols
  const int cols = 1 << cols_log;
  const int lane = blockIdx.x / n_stripes;
  const int c0 = (blockIdx.x % n_stripes) << cols_log;
  int* TL = T + lane * static_cast<int64_t>(levels) * max_n + c0;
  const int cells = rows << cols_log;
  int* cur = stripe;
  int* nxt = stripe + cells;
  const int* Tb = TL + kTileLevels * max_n;
  for (int e = threadIdx.x; e < cells; e += kStripeThreads) {
    cur[e] = Tb[static_cast<int64_t>(e >> cols_log) * kTile + (e & (cols - 1))];
  }
  __syncthreads();
  for (int k = kTileLevels + 1; k < levels; ++k) {
    int* Tk = TL + k * max_n;
    const int step = search_list::stripe_step(k, rows);
    for (int e = threadIdx.x; e < cells; e += kStripeThreads) {
      const int t = e >> cols_log, c = e & (cols - 1);
      const int v = search_list::stripe_entry(cur, cols, t, c, step, rows);
      nxt[e] = v;
      Tk[static_cast<int64_t>(t) * kTile + c] = v;
    }
    __syncthreads();
    int* was = cur;
    cur = nxt;
    nxt = was;
  }
}

// Grid 3b (other widths): level k + 1 from level k, a thread a place.
__global__ void __launch_bounds__(kThreads)
table_level_kernel(int64_t max_n, int n_tiles, int levels, int k,
                   int* __restrict__ T) {
  const int lane = blockIdx.x / n_tiles;
  const int64_t j = static_cast<int64_t>(blockIdx.x % n_tiles) * kThreads +
                      threadIdx.x;
  if (j >= max_n) return;
  int* Tk = T + (lane * static_cast<int64_t>(levels) + k) * max_n;
  Tk[max_n + j] = search_list::level_entry(Tk, j, k, max_n);
}

// ----------------------------------------------------------------- K11
// Each used tier's sort values and indices (a lane's at lane * max_n),
// where its (rank, column) pairs start in the grouped column list, its
// largest rank; the inverse words' place bits and whether they are packed
// (search_list::inverse_word).
struct Tiers {
  const int* sorted[kSpans];
  const int64_t* order[kSpans];
  int start[kSpans + 1];
  int max_rank[kSpans];
  int rbits;
  bool packed;
};

// Grid 1: inv[t][lane][order_t[lane][i]] = the inverse word of place i
// (i, and packed above it the run of equal keys just before i), tiers
// slowest: the scattered stores of one (tier, lane) land in its 4 max_n
// bytes, which stay in L2 while they are written.
__global__ void __launch_bounds__(kThreads)
inverse_kernel(Tiers tiers, int n_lanes, int64_t max_n, int n_tiles,
               int* __restrict__ inv) {
  __shared__ Tiers s_tiers;  // a copy indexed at run time (no local copy)
  if (threadIdx.x == 0) s_tiers = tiers;
  __syncthreads();
  const int g = blockIdx.x / n_tiles;  // tier * n_lanes + lane
  const int t = g / n_lanes, lane = g % n_lanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x % n_tiles) * kThreads +
                      threadIdx.x;
  if (i >= max_n) return;
  const int64_t at0 = lane * max_n;
  inv[static_cast<int64_t>(g) * max_n + s_tiers.order[t][at0 + i]] =
      static_cast<int>(search_list::inverse_word(
          s_tiers.sorted[t] + at0, i, s_tiers.max_rank[t], s_tiers.rbits,
          s_tiers.packed));
}

// Grid 2: a block kListThreads positions of a lane (lanes slowest: one
// lane's tier planes, rank and table stay in L2), a thread a position.
// Tier by tier, its inverse word (read by consecutive threads) and its
// candidates at that tier's ranks (the indices just before its place;
// the keys too where the words are not packed) into its candidate row in
// shared memory, at each column's index in the take order; the dedup and cap from that row in the take order,
// with compile-time indices; the merge.  kCap > 0: the list in registers,
// the block's lens and dists rows staged in shared memory (`pitch` words
// a position: its lens row, then its dists row `stride` words on), the
// candidate row in the position's own staged rows where m int32 fit them,
// and the block's rows written out by consecutive threads on consecutive
// words; kCap 0: the list in the position's dists row, the merge straight
// into its rows.
template <int kCap>
__global__ void __launch_bounds__(kListThreads)
lists_kernel(Tiers tiers, int n_tiers, const int* __restrict__ inv,
             const int* __restrict__ tcols, int m, int rr, int width,
             const int64_t* __restrict__ rank, const int* __restrict__ T,
             int levels, const int64_t* __restrict__ n, int64_t dict_size,
             int n_lanes, int64_t max_n, int n_tiles,
             int64_t* __restrict__ lens, int64_t* __restrict__ dists,
             int64_t* __restrict__ counts) {
  extern __shared__ int64_t s_rows[];
  __shared__ Tiers s_tiers;  // a copy indexed at run time (no local copy)
  if (threadIdx.x == 0) s_tiers = tiers;
  __syncthreads();
  const int lane = blockIdx.x / n_tiles;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x % n_tiles) * kListThreads;
  const int np = static_cast<int>(min(static_cast<int64_t>(kListThreads),
                                      max_n - p0));
  const int64_t at0 = lane * max_n + p0;
  const int tid = threadIdx.x;
  const int stride = width | 1, pitch = 2 * stride + 1;
  int32_t* row;
  if constexpr (kCap > 0) {
    row = 2 * pitch >= m ? reinterpret_cast<int32_t*>(s_rows + tid * pitch)
                         : reinterpret_cast<int32_t*>(
                               s_rows + kListThreads * pitch) + tid * m;
  } else {
    row = reinterpret_cast<int32_t*>(s_rows) + tid * m;
  }
  if (tid < np) {
    const int64_t p = p0 + tid;
    for (int t = 0; t < n_tiers; ++t) {
      const uint32_t word = static_cast<uint32_t>(
          inv[(static_cast<int64_t>(t) * n_lanes + lane) * max_n + p]);
      const int c0 = s_tiers.start[t];
      search_list::tier_candidates(
          s_tiers.sorted[t] + lane * max_n, s_tiers.order[t] + lane * max_n,
          word, s_tiers.rbits, s_tiers.packed, tcols + 2 * c0,
          s_tiers.start[t + 1] - c0, row);
    }
    const search_list::Lane ln{rank + lane * max_n,
                               T + lane * static_cast<int64_t>(levels) * max_n,
                               max_n, n[lane], dict_size};
    int64_t* lrow = kCap > 0 ? s_rows + tid * pitch : lens + (at0 + tid) * width;
    int64_t* drow = kCap > 0 ? lrow + stride : dists + (at0 + tid) * width;
    counts[at0 + tid] = search_list::list_position<kCap>(
        ln, p, row, m, rr != 0, width, width, lrow, drow);
  }
  if constexpr (kCap > 0) {
    __syncthreads();
    search_list::copy_rows(s_rows, pitch, lens + at0 * width, width, np,
                           width, tid, kListThreads);
    search_list::copy_rows(s_rows + stride, pitch, dists + at0 * width, width,
                           np, width, tid, kListThreads);
  }
}

// Shared bytes of a K11 list block: kCap > 0 the staged rows, and the
// candidate rows where they do not fit them; kCap 0 the candidate rows.
int list_smem_bytes(int cap_bound, int m, int width) {
  const int pitch = 2 * (width | 1) + 1;
  const int rows = cap_bound > 0 ? kListThreads * pitch * 8 : 0;
  const bool own = cap_bound > 0 && 2 * pitch >= m;
  return rows + (own ? 0 : kListThreads * m * 4);
}

template <int kCap>
int launch_lists(const Tiers& tiers, int n_tiers, const int* inv,
                 const int* tcols, int m, int rr, int width,
                 const int64_t* rank, const int* T, int levels,
                 const int64_t* n, int64_t dict_size, int n_lanes,
                 int64_t max_n, int n_tiles, int blocks, int64_t* lens,
                 int64_t* dists, int64_t* counts, cudaStream_t s) {
  const int smem = list_smem_bytes(kCap, m, width);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lists_kernel<kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lists_kernel<kCap><<<blocks, kListThreads, smem, s>>>(
      tiers, n_tiers, inv, tcols, m, rr, width, rank, T, levels, n, dict_size,
      n_lanes, max_n, n_tiles, lens, dists, counts);
  return static_cast<int>(cudaGetLastError());
}

int blocks_of(int64_t items, int per, int groups, int* n_tiles) {
  const int64_t tiles = (items + per - 1) / per;
  if (tiles * groups > INT_MAX) return -1;
  *n_tiles = static_cast<int>(tiles);
  return static_cast<int>(tiles * groups);
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
// depth; levels = max(1, bit_length(max_n - 1)); stripe_cols: the levels
// past the tile's by column stripes of that many columns (a power of two,
// 8..32, max_n a multiple of kTile; stripe_smem bytes of shared memory a
// block), or 0 by a pass a level (cuda_search.upper_route); rank:
// (n_lanes, max_n) int64; T: (n_lanes, levels, max_n) int32.  Returns
// the first CUDA error of the launches (0 on success).
extern "C" int lzt_suffix_table(const uint8_t* data, const int64_t* n,
                                const int64_t* order, const int64_t* cl,
                                int n_lanes, int64_t max_n, int depth,
                                int levels, int stripe_cols, int64_t* rank,
                                int* T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0, n_big = 0;
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_tiles);
  const int big = blocks_of(max_n, kTile, n_lanes, &n_big);
  const int top = levels - 1 < kTileLevels ? levels - 1 : kTileLevels;
  const bool stripes = stripe_cols > 0;
  int cols_log = 0;
  while ((1 << cols_log) < stripe_cols) ++cols_log;
  if (n_lanes <= 0 || max_n <= 0 || depth <= 0 || levels < 1 || blocks < 0 ||
      big < 0 || (stripes && ((1 << cols_log) != stripe_cols ||
                              stripe_cols < 8 || stripe_cols > 32 ||
                              max_n % kTile != 0 ||
                              max_n / kTile * stripe_cols > INT_MAX / 8 ||
                              static_cast<int64_t>(kTile / stripe_cols) *
                                      n_lanes > INT_MAX))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nw = ((depth < 32 ? depth : 32) + 3) / 4;
  table_base_kernel<<<blocks, kThreads, 0, s>>>(
      data, n, order, cl, max_n, n_tiles, nw, depth, levels, rank, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (top > 0) {
    table_tile_kernel<<<big, kTileThreads, 0, s>>>(max_n, n_big, levels, top, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (top >= levels - 1) return 0;
  if (stripes) {
    const int rows = static_cast<int>(max_n / kTile);
    const int per_lane = kTile >> cols_log;
    const int smem = 2 * rows * stripe_cols * 4;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(table_stripe_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    table_stripe_kernel<<<per_lane * n_lanes, kStripeThreads, smem, s>>>(
        max_n, rows, cols_log, per_lane, levels, T);
    return static_cast<int>(cudaGetLastError());
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
// scratch (n_tiers, n_lanes, max_n) int32; tcols: m (rank, column) int32
// device pairs grouped by tier, the column a pair's index in the order
// candidates are taken, tier t's at [start[t], start[t + 1]) (start:
// n_tiers + 1 host ints; max_rank: each tier's largest rank, n_tiers host
// ints); rr: keep-first until cap (the round-robin cut),
// else the cap largest; width: the lists' width (cap); rank, T, levels:
// K10's; n: (n_lanes,) int64; lens, dists: (n_lanes, max_n, width) int64;
// counts: (n_lanes, max_n) int64.  Returns the first CUDA error of the
// launches (0 on success).
extern "C" int lzt_match_lists(const void* const* sorted,
                               const void* const* order, int n_tiers,
                               int* inv, const int* tcols, const int* start,
                               const int* max_rank, int m, int rr, int width, const int64_t* rank,
                               const int* T, int levels, const int64_t* n,
                               int64_t dict_size, int n_lanes, int64_t max_n,
                               int64_t* lens, int64_t* dists, int64_t* counts,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0, n_list = 0;
  const int blocks = blocks_of(max_n, kThreads, n_tiers * n_lanes, &n_tiles);
  const int list_blocks = blocks_of(max_n, kListThreads, n_lanes, &n_list);
  bool ok = n_lanes > 0 && max_n > 0 && max_n <= INT_MAX && n_tiers > 0 &&
            n_tiers <= kSpans && m > 0 && width > 0 && width <= m &&
            levels >= 1 && blocks >= 0 && list_blocks >= 0 &&
            start[0] == 0 && start[n_tiers] == m;
  Tiers tiers{};
  int top = 0;
  for (int i = 0; ok && i < n_tiers; ++i) {
    tiers.sorted[i] = static_cast<const int*>(sorted[i]);
    tiers.order[i] = static_cast<const int64_t*>(order[i]);
    tiers.start[i] = start[i];
    tiers.max_rank[i] = max_rank[i];
    top = max_rank[i] > top ? max_rank[i] : top;
    ok = start[i] <= start[i + 1] && max_rank[i] >= 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  tiers.start[n_tiers] = m;
  tiers.rbits = search_list::place_bits(max_n);
  tiers.packed = search_list::inverse_packed(max_n, top);
  inverse_kernel<<<blocks, kThreads, 0, s>>>(tiers, n_lanes, max_n, n_tiles,
                                             inv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* launch = width <= 16   ? &launch_lists<16>
                 : width <= 32 ? &launch_lists<32>
                               : &launch_lists<0>;
  return launch(tiers, n_tiers, inv, tcols, m, rr, width, rank, T, levels, n,
                dict_size, n_lanes, max_n, n_list, list_blocks, lens, dists,
                counts, s);
}

// ----------------------------------------------------------------- K21
// The optimal round's DP pairs and the seed's longest pair from K11's
// lists in one pass (replaces lzma_tpu/ops/device_parser.py
// _select_dp_pairs :1529 and the head of _seed_from_lists :1551, jitted
// under jax.jit at device_parser.py:1595; no pallas_call).  Its bytes
// bound it: a position's count, the sectors of its lists' first kDpMax
// entries and of their last, read once, and 2 m_dp + 2 int64 written.  A
// thread a position, its outputs written as 16-byte words.

namespace {

constexpr int kPairThreads = 256;
constexpr int kDpMax = 4;  // device_parser.M_DP: the pairs a position

__global__ void __launch_bounds__(kPairThreads)
    pairs_kernel(const int64_t* __restrict__ cl, const int64_t* __restrict__ cd,
                 const int64_t* __restrict__ counts, int width, int64_t n_pos,
                 int64_t* __restrict__ ld, int64_t* __restrict__ dd,
                 int64_t* __restrict__ bl, int64_t* __restrict__ bd) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kPairThreads +
                    threadIdx.x;
  if (p >= n_pos) return;
  const int64_t count = __ldg(counts + p);
  const int64_t* row_l = cl + p * width;
  const int64_t* row_d = cd + p * width;
  int64_t hl[kDpMax], hd[kDpMax];
#pragma unroll
  for (int k = 0; k < kDpMax; ++k) {
    hl[k] = __ldg(row_l + k);
    hd[k] = __ldg(row_d + k);
  }
  const int last = search_list::last_entry(count, width);
  int64_t ol[kDpMax], od[kDpMax];
  search_list::list_pairs(hl, hd, __ldg(row_l + last), __ldg(row_d + last),
                          count, kDpMax, ol, od, bl + p, bd + p);
  longlong2* wl = reinterpret_cast<longlong2*>(ld + p * kDpMax);
  longlong2* wd = reinterpret_cast<longlong2*>(dd + p * kDpMax);
  wl[0] = make_longlong2(ol[0], ol[1]);
  wl[1] = make_longlong2(ol[2], ol[3]);
  wd[0] = make_longlong2(od[0], od[1]);
  wd[1] = make_longlong2(od[2], od[3]);
}

}  // namespace

// cl, cd: (n_pos, width) int64 lists, contiguous, width > m_dp; counts:
// (n_pos,) int64; ld, dd: (n_pos, m_dp) int64 outputs and bl, bd:
// (n_pos,) int64, contiguous and 16-byte aligned.  m_dp must be kDpMax.
// Returns the launch's CUDA error (0 on success).
extern "C" int lzt_list_pairs(const int64_t* cl, const int64_t* cd,
                              const int64_t* counts, int width, int m_dp,
                              int64_t n_pos, int64_t* ld, int64_t* dd,
                              int64_t* bl, int64_t* bd, void* stream) {
  if (n_pos <= 0) return 0;
  const int64_t blocks = (n_pos + kPairThreads - 1) / kPairThreads;
  if (m_dp != kDpMax || width <= m_dp || blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pairs_kernel<<<static_cast<int>(blocks), kPairThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(cl, cd, counts, width,
                                                      n_pos, ld, dd, bl, bd);
  return static_cast<int>(cudaGetLastError());
}
