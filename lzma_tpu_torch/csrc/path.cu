// The parse path's marking (K13) and compaction (K14).
//
// They replace jitted JAX device code that XLA compiles for the device
// (no pallas_call; under jax.jit at lzma_tpu/ops/device_parser.py:1595,
// tokenize_optimal, and in device_matcher.tokenize):
//   K13 the pointer doubling of lzma_tpu/ops/device_parser.py:1417
//       extract_tokens (the DP path, backward from node lens over from)
//       and of device_matcher.py:217 greedy_path (the lazy path, forward
//       from `start` over pos -> min(pos + adv, max_n), the sentinel
//       max_n pointing to itself): each lane's nodes reached from one
//       start node by following one pointer a node, kept in 1..lens
//       (extract) or below n (greedy) -- mark (n_lanes, n_out) bool, as
//       lzma_tpu_torch/ops/device_parser.py _extract_mark and
//       device_matcher.py _greedy_mark;
//   K14 extract_tokens' compaction and device_matcher.py:269 _compact: a
//       lane's marked nodes in order, each a token in extract's form
//       (from[j], j - from[j], choice[j]) or _compact's (j, best_len[j]
//       or 1, best_dist[j] or -1 by _decide's take), (0, 1, -1) past the
//       lane's count -- t_pos, t_len, t_dist (n_lanes, n_out) int64,
//       t_valid (n_lanes, n_out) bool, ntok (n_lanes,) int64, as
//       _extract_compact and _compact_taken.
//
// What bounds them on this card: the bytes (the pointers and the mark
// read a few times, the tokens written once), and for K13 the walk's
// dependence: a path is up to n_out hops long, one after the other.
// K13 cuts the lane into tiles of kTile nodes.  The routes' pointers run
// one way (a DP edge goes back 1..fb nodes, the lazy advance forward 1
// or a match length; a node that is not reached points to itself), so
// a walk enters each tile at most once.  Three grids:
//   1. exits: a block a tile doubles its pointers in shared memory
//      (kRounds rounds, a pointer that leaves the tile is kept) to each
//      node's exit: the first node outside the tile on its walk, or a
//      node inside it where the walk stays (a fixed point);
//   2. walk: a thread a lane follows the exits from the start node,
//      one hop a tile, and records each tile's entry node; an exit into
//      a tile the walk has passed sets a status bit (the wrapper raises),
//      as does a pointer outside the lane;
//   3. mark: a block a tile doubles its pointers again (two buffers: a
//      round's pointers must be exactly 2^r hops long) and carries the
//      reached set from its entry as the plain version does (the same set
//      within the tile), and writes the tile's marks.
// K14, three grids: each tile's mark count (a block a tile), each lane's
// exclusive scan of them and its count (a block a lane), then a block a
// tile scans its marks, writes each marked node's token at its slot and
// fills the slots [lo, hi) of its own range that lie past the lane's
// count.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;       // nodes a tile
constexpr int kThreads = 1024;
constexpr int kPer = kTile / kThreads;      // nodes a thread, contiguous
constexpr int kRounds = kTileLog + 1;       // doublings: 2^kTileLog hops
constexpr int kWalkThreads = 32;
constexpr int kOutOfRange = 1, kPassed = 2; // status bits

// One lane group's graph.  Backward (extract): from (n_lanes, n_nodes)
// int32, the start lens[lane], kept 0 < j <= lens.  Forward (greedy):
// adv (n_lanes, n_nodes - 1) int64, node n_nodes - 1 the sentinel, the
// start `start`, kept j < n[lane].
struct Graph {
  const int* from;
  const int64_t* lens;
  const int64_t* adv;
  const int64_t* n;
  int64_t start, n_nodes, n_out;
  int n_lanes, n_tiles, forward;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t next_of(const Graph& g, int lane,
                                           int64_t j) {
  if (!g.forward) return __ldg(g.from + lane * g.n_nodes + j);
  const int64_t max_n = g.n_nodes - 1;
  if (j >= max_n) return max_n;
  const int64_t nx = j + __ldg(g.adv + lane * max_n + j);
  return nx < max_n ? nx : max_n;
}

__device__ __forceinline__ bool kept(const Graph& g, int64_t j, int64_t len) {
  return g.forward ? j < len : j > 0 && j <= len;
}

// A tile's pointers, relative to lo, into p; a pointer outside the lane
// sets the status bit and becomes a fixed point.
__device__ void load_tile(const Graph& g, int lane, int64_t lo, int cnt,
                          int* p, int* status) {
  bool bad = false;
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    const int64_t f = next_of(g, lane, lo + k);
    const bool out = f < 0 || f >= g.n_nodes;
    bad = bad || out;
    p[k] = static_cast<int>((out ? lo + k : f) - lo);
  }
  if (bad && status) atomicOr(status, kOutOfRange);
}

// One doubling: a pointer inside the tile takes its target's pointer; a
// pointer that left the tile is kept.  Reads of a pointer another thread
// writes in the same round see either value; both lie on the walk at or
// before its exit, so the rounds only go faster.
__device__ __forceinline__ void jump(int* p, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    const int q = p[k];
    if (q >= 0 && q < cnt) p[k] = p[q];
  }
}

// ------------------------------------------------------------------ K13
__global__ void __launch_bounds__(kThreads)
exits_kernel(Graph g, int* exits, int* entry, int* status) {
  __shared__ int p[kTile];
  const int lane = blockIdx.x / g.n_tiles;
  const int t = blockIdx.x % g.n_tiles;
  const int64_t lo = static_cast<int64_t>(t) << kTileLog;
  const int cnt = static_cast<int>(lmin(kTile, g.n_nodes - lo));
  load_tile(g, lane, lo, cnt, p, status);
  if (threadIdx.x == 0) entry[lane * g.n_tiles + t] = -1;
  __syncthreads();
  for (int r = 0; r < kRounds; ++r) {
    jump(p, cnt);
    __syncthreads();
  }
  int* out = exits + lane * g.n_nodes + lo;
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    out[k] = static_cast<int>(lo + p[k]);
  }
}

__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(Graph g, const int* exits, int* entry, int* status) {
  const int lane = blockIdx.x * kWalkThreads + threadIdx.x;
  if (lane >= g.n_lanes) return;
  int64_t cur = g.forward ? g.start : g.lens[lane];
  if (cur < 0 || cur >= g.n_nodes) {
    atomicOr(status, kOutOfRange);
    return;
  }
  const int* ex = exits + lane * g.n_nodes;
  int* en = entry + lane * g.n_tiles;
  int64_t t = cur >> kTileLog;
  for (;;) {
    en[t] = static_cast<int>(cur);
    const int64_t nx = ex[cur];
    const int64_t tn = nx >> kTileLog;
    if (tn == t) break;                     // the walk stays in tile t
    if (g.forward ? tn < t : tn > t) {      // back into a passed tile
      atomicOr(status, kPassed);
      break;
    }
    cur = nx;
    t = tn;
  }
}

__global__ void __launch_bounds__(kThreads)
mark_kernel(Graph g, const int* entry, uint8_t* mark) {
  __shared__ int p[2][kTile];
  __shared__ uint8_t reach[kTile];
  const int lane = blockIdx.x / g.n_tiles;
  const int t = blockIdx.x % g.n_tiles;
  const int64_t lo = static_cast<int64_t>(t) << kTileLog;
  const int cnt = static_cast<int>(lmin(kTile, g.n_nodes - lo));
  const int n_out = static_cast<int>(lmin(cnt, g.n_out - lo));
  uint8_t* out = mark + lane * g.n_out + lo;
  const int e = entry[lane * g.n_tiles + t];
  if (e < 0) {                              // the walk does not enter
    for (int k = threadIdx.x; k < n_out; k += kThreads) out[k] = 0;
    return;
  }
  load_tile(g, lane, lo, cnt, p[0], nullptr);
  for (int k = threadIdx.x; k < cnt; k += kThreads) reach[k] = lo + k == e;
  __syncthreads();
  // Round r adds the nodes 2^r hops past the reached ones, so its
  // pointers must be exactly 2^r hops long (else the reached set has
  // holes): each round's pointers are read from one buffer and written
  // to the other.  A node reached within the round only adds more of the
  // walk.
  for (int r = 0; r < kRounds; ++r) {
    const int* cur = p[r & 1];
    int* nxt = p[~r & 1];
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const int q = cur[k];
      const bool in = q >= 0 && q < cnt;
      if (reach[k] && in) reach[q] = 1;
      nxt[k] = in ? cur[q] : q;
    }
    __syncthreads();
  }
  const int64_t len = g.forward ? g.n[lane] : g.lens[lane];
  for (int k = threadIdx.x; k < n_out; k += kThreads) {
    out[k] = reach[k] && kept(g, lo + k, len);
  }
}

// ------------------------------------------------------------------ K14
// A lane group's marks and what their tokens are made of.  Extract's
// form: from, choice (n_lanes, width) int32.  _compact's: best_len,
// best_dist (n_lanes, width) int64 and take (n_lanes, width) bool.
struct Tokens {
  const uint8_t* mark;
  const int* from;
  const int* choice;
  const int64_t* best_len;
  const int64_t* best_dist;
  const uint8_t* take;
  int64_t width;
  int n_lanes, n_tiles, forward;
  int64_t *t_pos, *t_len, *t_dist, *ntok;
  uint8_t* t_valid;
};

// Exclusive sum of v over the block (kThreads, 32 warps); *total gets
// the block's sum.  `sums`: 32 ints of shared memory.
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

__global__ void __launch_bounds__(kThreads)
tile_counts_kernel(Tokens k, int* counts) {
  __shared__ int sums[32];
  const int lane = blockIdx.x / k.n_tiles;
  const int t = blockIdx.x % k.n_tiles;
  const int64_t lo = static_cast<int64_t>(t) << kTileLog;
  const int cnt = static_cast<int>(lmin(kTile, k.width - lo));
  const uint8_t* m = k.mark + lane * k.width + lo;
  const int first = threadIdx.x * kPer;
  int v = 0;
  for (int i = first; i < first + kPer; ++i) {
    if (i < cnt) v += m[i] != 0;
  }
  int total;
  block_scan(v, sums, &total);
  if (threadIdx.x == 0) counts[lane * k.n_tiles + t] = total;
}

// A block a lane: the tiles' counts become their exclusive offsets, and
// the lane's sum its ntok.
__global__ void __launch_bounds__(kThreads)
lane_scan_kernel(Tokens k, int* counts) {
  __shared__ int sums[32];
  int* c = counts + blockIdx.x * k.n_tiles;
  int carry = 0;
  for (int base = 0; base < k.n_tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < k.n_tiles ? c[i] : 0;
    int total;
    const int excl = block_scan(v, sums, &total);
    if (i < k.n_tiles) c[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) k.ntok[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(Tokens k, const int* offsets) {
  __shared__ int sums[32];
  const int lane = blockIdx.x / k.n_tiles;
  const int t = blockIdx.x % k.n_tiles;
  const int64_t lo = static_cast<int64_t>(t) << kTileLog;
  const int cnt = static_cast<int>(lmin(kTile, k.width - lo));
  const int64_t row = lane * k.width;
  const uint8_t* m = k.mark + row + lo;
  const int first = threadIdx.x * kPer;
  int v = 0;
  for (int i = first; i < first + kPer; ++i) {
    if (i < cnt) v += m[i] != 0;
  }
  int total;
  int64_t slot = offsets[lane * k.n_tiles + t] + block_scan(v, sums, &total);
  for (int i = first; i < first + kPer && i < cnt; ++i) {
    if (!m[i]) continue;
    const int64_t j = lo + i;
    int64_t pos, len, dist;
    if (k.forward) {
      const bool match = k.take[row + j] != 0;
      pos = j;
      len = match ? k.best_len[row + j] : 1;
      dist = match ? k.best_dist[row + j] : -1;
    } else {
      pos = k.from[row + j];
      len = j - pos;
      dist = k.choice[row + j];
    }
    k.t_pos[row + slot] = pos;
    k.t_len[row + slot] = len;
    k.t_dist[row + slot] = dist;
    ++slot;
  }
  const int64_t ntok = k.ntok[lane];
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const int64_t s = lo + i;
    const bool valid = s < ntok;
    k.t_valid[row + s] = valid;
    if (!valid) {
      k.t_pos[row + s] = 0;
      k.t_len[row + s] = 1;
      k.t_dist[row + s] = -1;
    }
  }
}

int tiles_of(int64_t n) { return static_cast<int>((n + kTile - 1) >> kTileLog); }

}  // namespace

// Scratch bytes of lzt_path_mark for n_lanes lanes of n_nodes nodes:
// the status word (16 bytes), the tiles' entries and the nodes' exits
// (int32).  The status word is its first 4 bytes.
extern "C" long long lzt_path_mark_scratch(int n_lanes, long long n_nodes) {
  return 16 + 4LL * n_lanes * (tiles_of(n_nodes) + n_nodes);
}

// K13.  forward 0: from (n_lanes, n_nodes) int32, lens (n_lanes,)
// int64, n_out = n_nodes.  forward 1: adv (n_lanes, n_nodes - 1) int64,
// n (n_lanes,) int64, start in [0, n_nodes), n_out = n_nodes - 1.  mark
// (n_lanes, n_out) bool.  Returns the first CUDA error of the launches
// (0 on success); the status word says 1 for a pointer or start outside
// the lane, 2 for a walk that goes back into a tile it left.
extern "C" int lzt_path_mark(const int* from, const int64_t* lens,
                             const int64_t* adv, const int64_t* n,
                             long long start, int forward, int n_lanes,
                             long long n_nodes, void* scratch, uint8_t* mark,
                             void* stream) {
  if (n_lanes <= 0 || n_nodes <= forward || n_nodes >= INT_MAX ||
      static_cast<int64_t>(tiles_of(n_nodes)) * n_lanes > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* status = static_cast<int*>(scratch);
  const int n_tiles = tiles_of(n_nodes);
  int* entry = reinterpret_cast<int*>(static_cast<char*>(scratch) + 16);
  int* exits = entry + static_cast<int64_t>(n_lanes) * n_tiles;
  const Graph g{from, lens, adv, n, start, n_nodes, n_nodes - forward,
                n_lanes, n_tiles, forward};
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  exits_kernel<<<n_tiles * n_lanes, kThreads, 0, s>>>(g, exits, entry, status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_kernel<<<(n_lanes + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                s>>>(g, exits, entry, status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_kernel<<<n_tiles * n_lanes, kThreads, 0, s>>>(g, entry, mark);
  return static_cast<int>(cudaGetLastError());
}

// Scratch bytes of lzt_path_compact: the tiles' counts, then offsets
// (int32).
extern "C" long long lzt_path_compact_scratch(int n_lanes, long long width) {
  return 4LL * n_lanes * tiles_of(width);
}

// K14.  mark (n_lanes, width) bool; forward 0: from, choice (n_lanes,
// width) int32; forward 1: best_len, best_dist (n_lanes, width) int64,
// take (n_lanes, width) bool.  t_pos, t_len, t_dist (n_lanes, width)
// int64, t_valid (n_lanes, width) bool, ntok (n_lanes,) int64.  Returns
// the first CUDA error of the launches (0 on success).
extern "C" int lzt_path_compact(const uint8_t* mark, const int* from,
                                const int* choice, const int64_t* best_len,
                                const int64_t* best_dist, const uint8_t* take,
                                int forward, int n_lanes, long long width,
                                void* scratch, int64_t* t_pos, int64_t* t_len,
                                int64_t* t_dist, uint8_t* t_valid,
                                int64_t* ntok, void* stream) {
  if (n_lanes <= 0 || width <= 0 || width >= INT_MAX ||
      static_cast<int64_t>(tiles_of(width)) * n_lanes > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = tiles_of(width);
  int* counts = static_cast<int*>(scratch);
  const Tokens k{mark, from, choice, best_len, best_dist, take, width,
                 n_lanes, n_tiles, forward, t_pos, t_len, t_dist, ntok,
                 t_valid};
  tile_counts_kernel<<<n_tiles * n_lanes, kThreads, 0, s>>>(k, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_scan_kernel<<<n_lanes, kThreads, 0, s>>>(k, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<n_tiles * n_lanes, kThreads, 0, s>>>(k, counts);
  return static_cast<int>(cudaGetLastError());
}
