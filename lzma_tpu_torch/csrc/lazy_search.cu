// The lazy search's prefix doubling and best matches: the group ids of a
// doubling level (K15), the consecutive LCP at full depth by the binary
// descent (K16) and each position's best match (K17), on the closed
// forms of lazy_search.cuh.
//
// They replace the jitted JAX device code of lzma_tpu/ops/
// device_matcher.py that XLA compiles for the device (no pallas_call;
// find_best_matches_rmq is jax.jit at :151, and device_encoder runs it
// under jax.vmap), which the plain versions in lzma_tpu_torch/ops/
// device_matcher.py restate:
//   K15 doubling_groups: _suffix_rank_lcp's prefix doubling (:465-490) --
//       a level's ids (n_lanes, max_n) int64 from its sort's order, a
//       new group where a suffix's keys differ from the one before it
//       (the 8 prefix words at the 32-byte level, else the previous
//       level's ids at i and i + span), then the next sort's key
//       (n_lanes, max_n) int64;
//   K16 descent_lcp: the consecutive LCP at full depth (:491-518) -- the
//       descent over the group levels, the <=32-byte refinement, cl
//       (n_lanes, max_n) int64, which K10 (search.cu) turns into the
//       sparse min table;
//   K17 best_matches: find_best_matches_rmq after its lexsort (:171-213)
//       with _lcp_query (:528) -- best_len, best_dist (n_lanes, max_n)
//       int64.
// The sorts between them stay torch.sort, as the reference leaves them
// to XLA's sort.
//
// What bounds them on this card: the bytes, most of them at random.  K15
// reads the order and, at the 32-byte level, each suffix's 32-byte
// window (the lane's bytes stay in L2), else the level's sorted key; it
// writes the ids (scattered to the positions) and the next key.  K16
// reads the first 32-byte windows of each suffix pair the order gives,
// and two ids a level and 8 more words only where those agree.  K17
// reads k neighbours' keys and positions beside its own, their ranks and
// two table entries a candidate, and writes two values a position.  What
// the designs do:
//   K15 two grids a level.  Grid A, decoupled look-back (Merrill and
//       Garland, 2016; K14's in path.cu): a block takes a ticket in
//       lane-major order, so a tile's predecessors have always started,
//       and its tile of kTile places, a thread each.  Each thread reads
//       its place of the order once and flags a new group: at the
//       32-byte level by its suffix's 8 marked words, read as words from
//       16-byte loads (window_words; byte by byte only for a window that
//       crosses max_n), against the place before's, which a shuffle
//       brings from the next lane down (a warp's first lane reads it from
//       shared memory, the tile's first thread builds one window more); at
//       a doubling level by the sorted key against the place before's,
//       read coalesced (no read of the previous ids: the key holds both;
//       the order and the key as streaming loads).
//       The block scans its flags, looks back along its lane for its
//       first id (a warp reads 32 predecessors at a time), publishes its
//       sum and scatters each place's id to its position.  Grid B, a
//       thread a place: the next key.  Places and spans are 32-bit inside
//       a lane and every wrap a conditional subtract (the span taken mod
//       max_n once a call); lane bases are 64-bit.
//   K16 a thread a sorted place: the two suffixes from the order
//       (streaming loads); in a lane past 508 places their first 32-byte
//       windows, read as words (window_words: up to three 16-byte loads
//       a window and a funnel shift, no remainder), and where those
//       differ (most places of the main path's lanes) the LCP is
//       theirs and no id is read, since every level's ids differ there
//       too; else the descent's two ids a level, then the refinement's
//       two windows at its length (byte by byte only where a word's
//       index reaches 2 max_n, lanes of at most 508 places), all in
//       32-bit ints.  The random id reads were most of it once the
//       remainders went (kernel_split k16_no_descent, PERF.md).
//   K17 a block a tile of kThreads sorted places and the k places before
//       it: it stages their keys, positions and the positions' ranks in
//       shared memory (the rank read once a place, the random read a
//       candidate needed), then a thread a place takes its candidates
//       from the stage, stops at the first key that differs (the order
//       is sorted) and reads two table entries a candidate in the window.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lazy_search.cuh"

namespace {

using lazy_search::kMaxCandidates;
using lazy_search::kMaxLevels;
using lazy_search::kWords;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 512;   // K15: places a tile, a thread each
constexpr int kWarps = kTile / 32;
constexpr int kThreads = 256;
constexpr long long kMaxPlaces = 1LL << 30;  // K16: a lane's places, 32-bit
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

// Exclusive sum of v over a block of kTile threads; *total gets the
// block's sum.  `sums`: kWarps ints of shared memory.
__device__ int block_scan(int v, int* sums, int* total) {
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = ln < kWarps ? sums[ln] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (ln >= o) s += y;
    }
    if (ln < kWarps) sums[ln] = s;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? sums[w - 1] : 0);
  *total = sums[kWarps - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ void publish(unsigned long long* p, int sum,
                                        unsigned long long flag) {
  atomicExch(p, (static_cast<unsigned long long>(sum) << 2) | flag);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// One lane group's doubling level.  The 32-byte level reads data and n;
// a doubling level sorted_key, the level's key in its order.  state: each
// tile's published sum, (sum << 2) | kAggregate or kPrefix; ticket: the
// tiles' order.
struct Level {
  const int64_t* order;
  const uint8_t* data;
  const int64_t* n;
  const int64_t* sorted_key;
  int max_n, n_tiles;
  unsigned long long* state;
  unsigned* ticket;
  int64_t* ids;
};

// ----------------------------------------------------------------- K15
// Grid A: each place's flag, the tile's scan and look-back, the ids
// scattered to their positions.  kWordLevel: the 32-byte level.
template <bool kWordLevel>
__global__ void __launch_bounds__(kTile) groups_kernel(Level v) {
  __shared__ int sums[kWarps];
  __shared__ uint32_t edge[kWarps][kWords];  // each warp's last words
  __shared__ int shared_ticket, shared_base;
  if (threadIdx.x == 0) shared_ticket = static_cast<int>(atomicAdd(v.ticket, 1u));
  __syncthreads();
  const int lane = shared_ticket / v.n_tiles;
  const int t = shared_ticket % v.n_tiles;
  const int i = t * kTile + static_cast<int>(threadIdx.x);
  const bool live = i < v.max_n;
  const int64_t at = static_cast<int64_t>(lane) * v.max_n;
  const int64_t* ord = v.order + at;
  // the order and the sorted key are read once: as streaming loads
  // (evict first), which leave L2 to the ids' scatter
  const int o = live ? static_cast<int>(__ldcs(
                           reinterpret_cast<const long long*>(ord + i)))
                     : 0;
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  bool fresh = true;
  if constexpr (kWordLevel) {
    const uint8_t* row = v.data + at;
    const int64_t nl = v.n[lane];
    uint32_t w[kWords], pw[kWords];
    if (live) {
      lazy_search::marked_words(row, v.max_n, nl, o, w);
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = 0;
    }
    if (ln == 31) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) edge[wp][k] = w[k];
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) pw[k] = __shfl_up_sync(kFull, w[k], 1);
    __syncthreads();
    if (ln == 0 && wp > 0) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) pw[k] = edge[wp - 1][k];
    }
    if (threadIdx.x == 0 && i > 0 && live) {
      lazy_search::marked_words(row, v.max_n, nl, static_cast<int>(ord[i - 1]), pw);
    }
    if (live && i > 0) fresh = lazy_search::words_differ(w, pw);
  } else {
    const int64_t* sk = v.sorted_key + at;
    const int64_t own =
        live ? __ldcs(reinterpret_cast<const long long*>(sk + i)) : 0;
    int64_t before = __shfl_up_sync(kFull, own, 1);
    if (ln == 0 && live && i > 0) before = sk[i - 1];
    if (live && i > 0) fresh = lazy_search::key_differs(own, before);
  }
  const int f = live && fresh;
  int total;
  const int excl = block_scan(f, sums, &total);
  if (threadIdx.x < 32) {  // the look-back, a warp
    unsigned long long* st = v.state + static_cast<int64_t>(lane) * v.n_tiles;
    int before = 0;
    if (t == 0) {
      if (ln == 0) publish(st, total, kPrefix);
    } else {
      if (ln == 0) publish(st + t, total, kAggregate);
      for (int q = t - 1;; q -= 32) {
        const int x = q - ln;
        unsigned long long s = 0;
        if (x >= 0) {
          do {
            s = peek(st + x);
          } while ((s & 3) == 0);
        }
        const unsigned pre = __ballot_sync(kFull, x >= 0 && (s & 3) == kPrefix);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        int add = x >= 0 && ln <= stop ? static_cast<int>(s >> 2) : 0;
        for (int d = 16; d > 0; d >>= 1) add += __shfl_down_sync(kFull, add, d);
        before += __shfl_sync(kFull, add, 0);
        if (pre) break;
      }
      if (ln == 0) publish(st + t, before + total, kPrefix);
    }
    if (ln == 0) shared_base = before;
  }
  __syncthreads();
  if (live) v.ids[at + o] = static_cast<int64_t>(shared_base + excl + f - 1);
}

// Grid B: the next sort's key, a thread a place; shift = next span mod
// max_n.
__global__ void __launch_bounds__(kThreads)
key_kernel(const int64_t* __restrict__ ids, int max_n, int shift, int n_blocks,
           int64_t* __restrict__ key) {
  const int lane = blockIdx.x / n_blocks;
  const int i = (blockIdx.x % n_blocks) * kThreads + static_cast<int>(threadIdx.x);
  if (i >= max_n) return;
  const int64_t at = static_cast<int64_t>(lane) * max_n;
  key[at + i] = lazy_search::next_key(ids + at, max_n, shift, i);
}

// ----------------------------------------------------------------- K16
struct Levels {
  const int64_t* g[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
descent_kernel(const int64_t* __restrict__ order, Levels levels, int n_levels,
               const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
               int depth, int max_n, int n_blocks, int64_t* __restrict__ cl) {
  const int lane = blockIdx.x / n_blocks;
  const int i = (blockIdx.x % n_blocks) * kThreads + static_cast<int>(threadIdx.x);
  if (i >= max_n) return;
  const int64_t at = static_cast<int64_t>(lane) * max_n;
  const int64_t* g[kMaxLevels];
  for (int t = 0; t < n_levels; ++t) g[t] = levels.g[t] + at;
  const int64_t* ord = order + at;
  const int a = static_cast<int>(__ldcs(ord + i));
  const int b = static_cast<int>(ord[i == 0 ? max_n - 1 : i - 1]);
  __stcs(cl + at + i, static_cast<int64_t>(lazy_search::deep_lcp(
                          g, n_levels, data + at, max_n, __ldg(n + lane), i,
                          a, b, depth)));
}

// ----------------------------------------------------------------- K17
// A block a tile of kThreads places of the hash key's order and the
// k places before it (the halo), staged, then a thread a place.
__global__ void __launch_bounds__(kThreads)
best_kernel(const int* __restrict__ sorted, const int64_t* __restrict__ order,
            const int64_t* __restrict__ rank, const int* __restrict__ T,
            int levels, const int64_t* __restrict__ n, int64_t dict_size,
            int fb, int k, int max_n, int n_blocks,
            int64_t* __restrict__ best_len, int64_t* __restrict__ best_dist) {
  __shared__ int32_t key_s[kThreads + kMaxCandidates];
  __shared__ int32_t pos_s[kThreads + kMaxCandidates];
  __shared__ int32_t rank_s[kThreads + kMaxCandidates];
  const int lane = blockIdx.x / n_blocks;
  const int j0 = (blockIdx.x % n_blocks) * kThreads;
  const int64_t at = static_cast<int64_t>(lane) * max_n;
  const int first = j0 - k;
  for (int x = threadIdx.x; x < kThreads + k; x += kThreads) {
    const int r = first + x;
    if (r >= 0 && r < max_n) {
      const int p = static_cast<int>(order[at + r]);
      key_s[x] = sorted[at + r];
      pos_s[x] = p;
      rank_s[x] = static_cast<int>(rank[at + p]);
    }
  }
  __syncthreads();
  const int j = j0 + static_cast<int>(threadIdx.x);
  if (j >= max_n) return;
  const lazy_search::Staged st{key_s, pos_s, rank_s, first};
  const lazy_search::Table tb{T + at * levels, max_n, n[lane], dict_size};
  int64_t bl, bd;
  lazy_search::best_staged(st, tb, j, k, fb, &bl, &bd);
  const int p = pos_s[threadIdx.x + k];
  best_len[at + p] = bl;
  best_dist[at + p] = bd;
}

int blocks_of(int64_t items, int per, int groups, int* n_tiles) {
  const int64_t tiles = (items + per - 1) / per;
  if (tiles * groups > INT_MAX) return -1;
  *n_tiles = static_cast<int>(tiles);
  return static_cast<int>(tiles * groups);
}

}  // namespace

// Scratch bytes of lzt_doubling_groups: the tiles' look-back words
// (uint64), then the ticket (uint32); zeroed by lzt_doubling_groups.
extern "C" long long lzt_doubling_groups_scratch(int n_lanes,
                                                 long long max_n) {
  return 8LL * n_lanes * ((max_n + kTile - 1) / kTile) + 16;
}

// K15.  order: (n_lanes, max_n) int64, the level's stable sort;
// sorted_key null: the 32-byte level from data (n_lanes, max_n) uint8 and
// n (n_lanes,) int64; else sorted_key (n_lanes, max_n) int64, the
// level's key in its order (the previous call's key, sorted).  ids:
// (n_lanes, max_n) int64; next_span > 0: key (n_lanes, max_n) int64, the
// next sort's.  Returns the first CUDA error of the launches (0 on
// success).
extern "C" int lzt_doubling_groups(const int64_t* order, const uint8_t* data,
                                   const int64_t* n, const int64_t* sorted_key,
                                   long long next_span, int n_lanes,
                                   long long max_n, void* scratch,
                                   int64_t* ids, int64_t* key, void* stream) {
  int n_tiles = 0, n_blocks = 0;
  const int tiles = blocks_of(max_n, kTile, n_lanes, &n_tiles);
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_blocks);
  if (n_lanes <= 0 || max_n <= 0 || max_n > INT_MAX - kTile || tiles < 0 ||
      blocks < 0 || next_span < 0 ||
      (sorted_key == nullptr && (data == nullptr || n == nullptr)) ||
      (next_span > 0 && key == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, lzt_doubling_groups_scratch(n_lanes, max_n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* state = static_cast<unsigned long long*>(scratch);
  const Level v{order, data, n, sorted_key, static_cast<int>(max_n), n_tiles,
                state, reinterpret_cast<unsigned*>(
                           state + static_cast<int64_t>(n_lanes) * n_tiles),
                ids};
  if (sorted_key == nullptr) {
    groups_kernel<true><<<tiles, kTile, 0, s>>>(v);
  } else {
    groups_kernel<false><<<tiles, kTile, 0, s>>>(v);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || next_span == 0) return static_cast<int>(err);
  key_kernel<<<blocks, kThreads, 0, s>>>(ids, static_cast<int>(max_n),
                                         static_cast<int>(next_span % max_n),
                                         n_blocks, key);
  return static_cast<int>(cudaGetLastError());
}

// K16.  order: (n_lanes, max_n) int64, the final order; levels: n_levels
// host-held device pointers to the group levels the descent reads (level
// t the (32 << t)-byte ids, (n_lanes, max_n) int64); data, n: the lanes;
// cl: (n_lanes, max_n) int64.  Returns the first CUDA error of the launch
// (0 on success).
extern "C" int lzt_descent_lcp(const int64_t* order, const void* const* levels,
                               int n_levels, const uint8_t* data,
                               const int64_t* n, int depth, int n_lanes,
                               long long max_n, int64_t* cl, void* stream) {
  int n_blocks = 0;
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_blocks);
  if (n_lanes <= 0 || max_n <= 0 || max_n > kMaxPlaces || blocks < 0 ||
      n_levels < 0 || n_levels > kMaxLevels || depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels g{};
  for (int t = 0; t < n_levels; ++t) g.g[t] = static_cast<const int64_t*>(levels[t]);
  descent_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      order, g, n_levels, data, n, depth, static_cast<int>(max_n), n_blocks,
      cl);
  return static_cast<int>(cudaGetLastError());
}

// K17.  sorted, order: (n_lanes, max_n) the hash key's stable sort values
// (int32) and indices (int64); rank (n_lanes, max_n) int64 and T
// (n_lanes, levels, max_n) int32, the suffix table; n (n_lanes,) int64;
// k: the neighbours a position takes (1..16).  best_len, best_dist:
// (n_lanes, max_n) int64.  Returns the first CUDA error of the launch (0
// on success).
extern "C" int lzt_best_matches(const int* sorted, const int64_t* order,
                                const int64_t* rank, const int* T, int levels,
                                const int64_t* n, long long dict_size, int fb,
                                int k, int n_lanes, long long max_n,
                                int64_t* best_len, int64_t* best_dist,
                                void* stream) {
  int n_blocks = 0;
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_blocks);
  if (n_lanes <= 0 || max_n <= 0 || max_n > INT_MAX - kThreads || blocks < 0 ||
      levels < 1 || k < 1 || k > kMaxCandidates) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  best_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted, order, rank, T, levels, n, dict_size, fb, k,
      static_cast<int>(max_n), n_blocks, best_len, best_dist);
  return static_cast<int>(cudaGetLastError());
}
