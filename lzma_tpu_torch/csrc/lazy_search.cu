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
// window, else the previous ids at two places a suffix; it writes a flag
// a place, the ids (scattered to the positions) and the key.  K16 reads
// two ids a level and 8 words a suffix pair at indices the order gives.
// K17 reads k neighbours' keys and positions beside its own, their
// ranks and two table entries a candidate, and writes two values a
// position.  What the designs do:
//   K15 K14's shape (path.cu): grid 1 a block a tile of kTile places,
//       each thread's suffix keys (its window, or its pair of ids) staged
//       in shared memory for the next thread, writes each place's flag
//       and the tile's count; grid 2 a block a lane scans the counts into
//       offsets; grid 3 a block a tile scans its flags and scatters each
//       place's id to its position; grid 4 the next key, a thread a place;
//   K16, K17 a thread a sorted place.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lazy_search.cuh"

namespace {

using lazy_search::kMaxLevels;
using lazy_search::kWindow;

constexpr int kTile = 1024;  // K15: places a tile, a thread each
constexpr int kThreads = 256;

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t m) {
  i %= m;
  return i < 0 ? i + m : i;
}

// Exclusive sum of v over a block of kTile threads (32 warps); *total
// gets the block's sum.  `sums`: 32 ints of shared memory.
__device__ int block_scan(int v, int* sums, int* total) {
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = sums[ln];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (ln >= o) s += y;
    }
    sums[ln] = s;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? sums[w - 1] : 0);
  *total = sums[31];
  __syncthreads();
  return excl;
}

// One lane group's doubling level.
struct Level {
  const int64_t* order;
  const uint8_t* data;  // the 32-byte level: the lanes' bytes and n
  const int64_t* n;
  const int64_t* g;     // else the previous level's ids and its span
  int64_t span, next_span, max_n;
  int n_tiles;
  uint8_t* flags;
  int* counts;
  int64_t* ids;
  int64_t* key;
};

// ----------------------------------------------------------------- K15
// Grid 1: each place's flag (a new group) and the tile's count.
__global__ void __launch_bounds__(kTile) flags_kernel(Level v) {
  // each thread's keys for the next one: its window (the 32-byte level)
  // or its pair of ids
  __shared__ __align__(16) uint8_t stage[kTile * kWindow];
  __shared__ int sums[32];
  auto win = reinterpret_cast<uint8_t(*)[kWindow]>(stage);
  auto pairs = reinterpret_cast<lazy_search::Pair*>(stage);
  const int lane = blockIdx.x / v.n_tiles;
  const int t = blockIdx.x % v.n_tiles;
  const int64_t i = static_cast<int64_t>(t) * kTile + threadIdx.x;
  const bool live = i < v.max_n;
  const int64_t* ord = v.order + lane * v.max_n;
  const int64_t o = live ? ord[i] : 0;
  // the place before the tile's first, as the reference's roll by 1
  const int64_t q = ord[wrap(static_cast<int64_t>(t) * kTile - 1, v.max_n)];
  bool fresh = true;
  if (v.g == nullptr) {
    const uint8_t* row = v.data + lane * v.max_n;
    if (live) {
      for (int b = 0; b < kWindow; ++b) win[threadIdx.x][b] = row[wrap(o + b, v.max_n)];
    }
    __syncthreads();
    if (live && i > 0) {
      uint8_t own[kWindow];
      const uint8_t* prev = win[threadIdx.x > 0 ? threadIdx.x - 1 : 0];
      if (threadIdx.x == 0) {
        for (int b = 0; b < kWindow; ++b) own[b] = row[wrap(q + b, v.max_n)];
        prev = own;
      }
      fresh = lazy_search::words_differ(win[threadIdx.x], o, prev,
                                        threadIdx.x > 0 ? ord[i - 1] : q,
                                        v.n[lane]);
    }
  } else {
    const int64_t* g = v.g + lane * v.max_n;
    if (live) pairs[threadIdx.x] = lazy_search::pair_at(g, v.max_n, v.span, o);
    __syncthreads();
    if (live && i > 0) {
      const lazy_search::Pair prev =
          threadIdx.x > 0 ? pairs[threadIdx.x - 1]
                          : lazy_search::pair_at(g, v.max_n, v.span, q);
      fresh = lazy_search::pairs_differ(pairs[threadIdx.x], prev);
    }
  }
  if (live) v.flags[lane * v.max_n + i] = fresh;
  int total;
  block_scan(live && fresh, sums, &total);
  if (threadIdx.x == 0) v.counts[lane * v.n_tiles + t] = total;
}

// Grid 2, a block a lane: the tiles' counts become their exclusive
// offsets.
__global__ void __launch_bounds__(kTile) offsets_kernel(Level v) {
  __shared__ int sums[32];
  int* c = v.counts + blockIdx.x * v.n_tiles;
  int carry = 0;
  for (int base = 0; base < v.n_tiles; base += kTile) {
    const int i = base + threadIdx.x;
    const int x = i < v.n_tiles ? c[i] : 0;
    int total;
    const int excl = block_scan(x, sums, &total);
    if (i < v.n_tiles) c[i] = carry + excl;
    carry += total;
  }
}

// Grid 3: ids[order[i]] = (the flags at places 0..i) - 1.
__global__ void __launch_bounds__(kTile) scatter_kernel(Level v) {
  __shared__ int sums[32];
  const int lane = blockIdx.x / v.n_tiles;
  const int t = blockIdx.x % v.n_tiles;
  const int64_t i = static_cast<int64_t>(t) * kTile + threadIdx.x;
  const bool live = i < v.max_n;
  const int64_t at = lane * v.max_n;
  const int f = live ? v.flags[at + i] : 0;
  int total;
  const int excl = block_scan(f, sums, &total);
  if (live) {
    v.ids[at + v.order[at + i]] =
        static_cast<int64_t>(v.counts[lane * v.n_tiles + t]) + excl + f - 1;
  }
}

// Grid 4: the next sort's key, a thread a place.
__global__ void __launch_bounds__(kThreads) key_kernel(Level v, int n_blocks) {
  const int lane = blockIdx.x / n_blocks;
  const int64_t i = static_cast<int64_t>(blockIdx.x % n_blocks) * kThreads +
                    threadIdx.x;
  if (i >= v.max_n) return;
  const int64_t at = lane * v.max_n;
  v.key[at + i] = lazy_search::next_key(v.ids + at, v.max_n, v.next_span, i);
}

// ----------------------------------------------------------------- K16
struct Levels {
  const int64_t* g[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
descent_kernel(const int64_t* __restrict__ order, Levels levels, int n_levels,
               const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
               int depth, int64_t max_n, int n_blocks, int64_t* __restrict__ cl) {
  const int lane = blockIdx.x / n_blocks;
  const int64_t i = static_cast<int64_t>(blockIdx.x % n_blocks) * kThreads +
                    threadIdx.x;
  if (i >= max_n) return;
  const int64_t at = lane * max_n;
  const int64_t* g[kMaxLevels];
  for (int t = 0; t < n_levels; ++t) g[t] = levels.g[t] + at;
  const int64_t* ord = order + at;
  cl[at + i] = lazy_search::deep_lcp(g, n_levels, data + at, max_n, n[lane], i,
                                     ord[i], ord[wrap(i - 1, max_n)], depth);
}

// ----------------------------------------------------------------- K17
__global__ void __launch_bounds__(kThreads)
best_kernel(const int* __restrict__ sorted, const int64_t* __restrict__ order,
            const int64_t* __restrict__ rank, const int* __restrict__ T,
            int levels, const int64_t* __restrict__ n, int64_t dict_size,
            int fb, int k, int64_t max_n, int n_blocks,
            int64_t* __restrict__ best_len, int64_t* __restrict__ best_dist) {
  const int lane = blockIdx.x / n_blocks;
  const int64_t j = static_cast<int64_t>(blockIdx.x % n_blocks) * kThreads +
                    threadIdx.x;
  if (j >= max_n) return;
  const int64_t at = lane * max_n;
  search_list::Lane ln{};
  ln.rank = rank + at;
  ln.T = T + lane * static_cast<int64_t>(levels) * max_n;
  ln.max_n = max_n;
  ln.n = n[lane];
  ln.dict_size = dict_size;
  const int64_t* ord = order + at;
  int64_t bl, bd;
  lazy_search::best_match(ln, sorted + at, ord, j, k, fb, &bl, &bd);
  const int64_t p = ord[j];
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

// Scratch bytes of lzt_doubling_groups: a flag a place (uint8), then the
// tiles' counts (int32) from a 16-byte boundary.
extern "C" long long lzt_doubling_groups_scratch(int n_lanes,
                                                 long long max_n) {
  const long long flags = (static_cast<long long>(n_lanes) * max_n + 15) / 16 * 16;
  return flags + 4LL * n_lanes * ((max_n + kTile - 1) / kTile);
}

// K15.  order: (n_lanes, max_n) int64, the level's stable sort; g null:
// the 32-byte level from data (n_lanes, max_n) uint8 and n (n_lanes,)
// int64; else g (n_lanes, max_n) int64, the previous level's ids, and
// its span.  ids: (n_lanes, max_n) int64; next_span > 0: key (n_lanes,
// max_n) int64, the next sort's.  Returns the first CUDA error of the
// launches (0 on success).
extern "C" int lzt_doubling_groups(const int64_t* order, const uint8_t* data,
                                   const int64_t* n, const int64_t* g,
                                   long long span, long long next_span,
                                   int n_lanes, long long max_n, void* scratch,
                                   int64_t* ids, int64_t* key, void* stream) {
  int n_tiles = 0, n_blocks = 0;
  const int tiles = blocks_of(max_n, kTile, n_lanes, &n_tiles);
  const int blocks = blocks_of(max_n, kThreads, n_lanes, &n_blocks);
  if (n_lanes <= 0 || max_n <= 0 || tiles < 0 || blocks < 0 || span < 0 ||
      next_span < 0 || (g == nullptr && (data == nullptr || n == nullptr)) ||
      (next_span > 0 && key == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* flags = static_cast<uint8_t*>(scratch);
  int* counts = reinterpret_cast<int*>(
      flags + (static_cast<long long>(n_lanes) * max_n + 15) / 16 * 16);
  const Level v{order, data, n, g, span, next_span, max_n, n_tiles, flags,
                counts, ids, key};
  flags_kernel<<<tiles, kTile, 0, s>>>(v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  offsets_kernel<<<n_lanes, kTile, 0, s>>>(v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<tiles, kTile, 0, s>>>(v);
  err = cudaGetLastError();
  if (err != cudaSuccess || next_span == 0) return static_cast<int>(err);
  key_kernel<<<blocks, kThreads, 0, s>>>(v, n_blocks);
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
  if (n_lanes <= 0 || max_n <= 0 || blocks < 0 || n_levels < 0 ||
      n_levels > kMaxLevels || depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels g{};
  for (int t = 0; t < n_levels; ++t) g.g[t] = static_cast<const int64_t*>(levels[t]);
  descent_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      order, g, n_levels, data, n, depth, max_n, n_blocks, cl);
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
  if (n_lanes <= 0 || max_n <= 0 || blocks < 0 || levels < 1 || k < 1 ||
      k > lazy_search::kMaxCandidates) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  best_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted, order, rank, T, levels, n, dict_size, fb, k, max_n, n_blocks,
      best_len, best_dist);
  return static_cast<int>(cudaGetLastError());
}
