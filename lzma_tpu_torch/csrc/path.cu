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
// What bounds them on this card.  K14 by its bytes: 25 B a slot written
// (three int64 planes and t_valid), the marks and the two values a
// marked node's token is made of read once.  K13's bytes are few (the
// pointers read, a byte a node written); what holds it is the walk's
// dependence: a path is up to n_out hops long, one after the other, and
// its wrapper must read a status back before it returns.
//
// K13.  The routes' pointers run one way (a DP edge goes back 1..fb
// nodes, the lazy advance forward 1 or a match length; a node that is
// not reached points to itself) and a hop is at most 273 nodes long, so a
// walk enters a tile of kTile nodes only through the kDoor nodes on the
// side it comes from: the tile's door.  Likewise a segment of kSeg nodes
// within a tile.  In a tile, u numbers the nodes in the walk's order
// (u < 0 is past the tile, the door is the top kDoor).  Five grids, each
// compiled for the walk's way:
//   1. door: a block a tile, a warp a segment.  Each warp reads its
//      pointers once (a window of 32 nodes a load, coalesced) and goes up
//      its segment a window at a time: a node whose pointer leaves the
//      segment keeps it, one whose pointer lands below the window takes
//      that node's value from shared memory, one inside the window waits
//      on that lane and takes its value by pointer jumping over the lanes
//      (a shuffle a round, while any lane waits).  So each node gets its
//      segment's exit, with no doubling rounds over the tile.  Written
//      out: the door nodes' tile exits (a step a segment), the tile's
//      door map, each segment's door nodes' segment exits, and each
//      node's next place in the tile, 16 bits (no plane of a node's
//      exit);
//   2. group (lanes of more than kGroup tiles only): a block a group of
//      kGroup tiles composes their door maps in shared memory: each door
//      node of the group's first tile follows them to where it leaves
//      the group;
//   3. lane (the same lanes): a block a lane follows the group maps from
//      the start, a chunk of them in shared memory at a time: each
//      group's entry;
//   4. entry: a block a group follows its tiles' door maps in shared
//      memory from the group's entry: each tile's entry;
//   5. mark: a block of 4 warps a tile the walk enters reads grid 1's
//      next places of its nodes (16 bits a node: no pointer is read
//      twice) and its segments' door exits into shared memory, follows
//      them from its entry to each segment's entry, then a thread a
//      segment walks its segment a hop at a time and the block writes the
//      marks.
// A walk that lands in a tile outside its door (a hop longer than the
// door, which no route makes) is followed one pointer at a time there.
// A step against the walk's way or a pointer outside the lane sets a
// status flag; the flags live in pinned host memory the kernels write
// through its mapping, so the call's one readback is the stream's
// synchronise in the C entry, with no memset and no copy.
//
// K14, one grid with decoupled look-back (Merrill and Garland, 2016):
// tiles take a ticket in lane-major order, so a tile's predecessors have
// always started.  A tile reads its marks as 16-byte chunks, counts and
// scans them, publishes its count, looks back along its lane for its
// first slot (a warp reads 32 predecessors at a time) and publishes its
// sum.  It stages its tokens in shared memory a plane at a time and
// writes each plane's run of slots as 16-byte stores.  The same block
// then fills the previous lane's slots of its tile range: t_valid, and
// (0, 1, -1) past that lane's count, which its last tile has published
// (an earlier ticket); extra blocks fill the last lane.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ K13
constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;      // nodes a tile
constexpr int kSegLog = 9;
constexpr int kSeg = 1 << kSegLog;        // nodes a warp scans
constexpr int kSegs = kTile / kSeg;       // warps a tile
constexpr int kTileThreads = 32 * kSegs;
constexpr int kWins = kSeg / 32;          // windows of 32 nodes a segment
constexpr int kDoor = 288;                // >= 273, the longest hop
constexpr int kGroupLog = 7;
constexpr int kGroup = 1 << kGroupLog;    // tiles a group
constexpr int kGroupThreads = kDoor + 32; // a door node each, and the start
constexpr int kWalkThreads = 512;
constexpr int kMarkThreads = 128;         // grid 5's block: 4 warps
constexpr int kBad = -1;                  // a walk that steps against its way
static_assert(kSeg >= kDoor, "a segment holds its door");

// One lane group's graph.  Backward (extract): from (n_lanes, n_nodes)
// int32, the start lens[lane], kept 0 < j <= lens.  Forward (greedy):
// adv (n_lanes, n_nodes - 1) int64, node n_nodes - 1 the sentinel, the
// start `start`, kept j < n[lane].  status: [0] a pointer or the start
// outside the lane, [1] a step against the walk's way.  Node numbers fit
// an int (n_nodes < INT_MAX - kTile).  The device code takes the walk's
// way as a template argument F (forward).
struct Graph {
  const int* from;
  const int64_t* lens;
  const int64_t* adv;
  const int64_t* n;
  int* status;
  int64_t start;
  int n_nodes, n_out, n_lanes, n_tiles, n_groups;
};

template <bool F>
__device__ __forceinline__ int64_t next_of(const Graph& g, int lane, int j) {
  if (!F) return __ldg(g.from + static_cast<int64_t>(lane) * g.n_nodes + j);
  const int max_n = g.n_nodes - 1;
  if (j >= max_n) return max_n;
  const int64_t nx =
      j + __ldg(g.adv + static_cast<int64_t>(lane) * max_n + j);
  return nx < max_n ? nx : max_n;
}

__device__ __forceinline__ bool in_lane(const Graph& g, int64_t x) {
  return x >= 0 && x < g.n_nodes;
}

template <bool F>
__device__ __forceinline__ int64_t start_of(const Graph& g, int lane) {
  return F ? g.start : g.lens[lane];
}

__device__ __forceinline__ int tile_of(int x) { return x >> kTileLog; }

// Node j's place in tile t in the walk's order: u < 0 lies past the
// tile, the door is u in [kTile - kDoor, kTile).
template <bool F>
__device__ __forceinline__ int u_of(int t, int j) {
  const int lo = t << kTileLog;
  return F ? lo + kTile - 1 - j : j - lo;
}

template <bool F>
__device__ __forceinline__ int node_at(int t, int u) {
  const int lo = t << kTileLog;
  return F ? lo + kTile - 1 - u : lo + u;
}

// The pointers of the warp's segment s, p[w] for the node at u = s kSeg +
// 32 w + lane: the node itself where its pointer lies outside the lane
// (a fixed point; `check` sets the status flag), kBad where the node
// does not exist.  Every load is issued before any is used.
template <bool F>
__device__ __forceinline__ void load_segment(const Graph& g, int lane, int t,
                                             int s, int (&p)[kWins],
                                             bool check) {
  const int ln = threadIdx.x & 31;
  bool out = false;
#pragma unroll
  for (int w = 0; w < kWins; ++w) {
    const int j = node_at<F>(t, s * kSeg + 32 * w + ln);
    int f = kBad;
    if (j < g.n_nodes) {
      const int64_t nx = next_of<F>(g, lane, j);
      const bool bad = !in_lane(g, nx);
      out = out || bad;
      f = bad ? j : static_cast<int>(nx);
    }
    p[w] = f;
  }
  if (check && out) g.status[0] = 1;
}

// ex[u] over the warp's segment: where the walk from the node at u leaves
// the segment (a node below it, in or past the tile), the fixed point it
// stays at, or kBad where it first steps against its way.  The windows go
// up from the segment's bottom; a pointer into its own window waits on
// that lane (state -2 - lane) and takes its state by pointer jumping, a
// shuffle a round, while any lane waits (a chain there is at most 31
// hops: five rounds at most).
template <bool F>
__device__ __forceinline__ void segment_scan(int t, int s,
                                             const int (&p)[kWins],
                                             int* ex) {
  const int ln = threadIdx.x & 31;
  const int base = s * kSeg;
#pragma unroll
  for (int w = 0; w < kWins; ++w) {
    const int wb = base + 32 * w;
    const int u = wb + ln;
    const int f = p[w];
    int st = f;
    if (f != kBad && f != node_at<F>(t, u)) {
      const int q = u_of<F>(t, f);
      if (q >= u) {
        st = kBad;
      } else if (q >= wb) {
        st = -2 - (q - wb);
      } else if (q >= base) {
        st = ex[q];
      }
    }
    while (__any_sync(kFull, st <= -2)) {
      const int o = __shfl_sync(kFull, st, st <= -2 ? -2 - st : ln);
      if (st <= -2) st = o;
    }
    ex[u] = st;
    __syncwarp();
  }
}

// Where the walk from the tile's node at u leaves the tile (a node past
// it), the fixed point it stays at, or kBad: a step a segment.
template <bool F>
__device__ __forceinline__ int tile_exit(int t, const int* ex, int u) {
  int x = ex[u];
  for (;;) {
    if (x == kBad) return kBad;
    const int q = u_of<F>(t, x);
    if (q < 0) return x;
    const int y = ex[q];
    if (y == x) return x;
    x = y;
  }
}

// Where the walk from node x of tile t leaves t: its door map entry where
// x is a door node (map: tile t's), else the pointers one at a time (a
// hop longer than the door, which no route makes).  A pointer that leaves
// t is returned as it is: the caller checks its side.
template <bool F>
__device__ int exit_from(const Graph& g, int lane, int t, int x,
                         const int* map) {
  const int d = u_of<F>(t, x) - (kTile - kDoor);
  if (d >= 0) return map[d];
  for (;;) {
    const int64_t f = next_of<F>(g, lane, x);
    if (!in_lane(g, f) || f == x) return x;
    if (tile_of(static_cast<int>(f)) != t) return static_cast<int>(f);
    if (F ? f < x : f > x) return kBad;
    x = static_cast<int>(f);
  }
}

// A walk that leaves tile t at x: 1 into a tile on the walk's side, 0
// staying in t (x a fixed point there), -1 kBad or a tile on the other
// side.
template <bool F>
__device__ __forceinline__ int step(int t, int x) {
  if (x == kBad) return -1;
  const int tx = tile_of(x);
  if (tx == t) return 0;
  return (F ? tx > t : tx < t) ? 1 : -1;
}

// The walk that leaves tile t at x, followed through the tiles [t0, t1)
// (tile k's door map at maps + (k - m0) kDoor): the node where it leaves
// them, the fixed point it stays at, or kBad.  entry, where given, gets
// each tile's entry node at entry[tile].
template <bool F>
__device__ int walk_tiles(const Graph& g, int lane, int t, int x, int t0,
                          int t1, const int* maps, int m0, int* entry) {
  for (;;) {
    const int k = step<F>(t, x);
    if (k == 0) return x;
    if (k < 0) return kBad;
    const int tn = tile_of(x);
    if (tn < t0 || tn >= t1) return x;
    if (entry != nullptr) entry[tn] = x;
    x = exit_from<F>(g, lane, tn, x, maps + (tn - m0) * kDoor);
    t = tn;
  }
}

// n ints (a multiple of 4, 16-byte aligned) from src to dst by the
// block, four 16-byte loads a thread in flight.
__device__ __forceinline__ void load_maps(const int* src, int n, int* dst) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  const int n4 = n / 4, step = blockDim.x;
  int k = threadIdx.x;
  for (; k + 3 * step < n4; k += 4 * step) {
    const int4 a = __ldg(s + k), b = __ldg(s + k + step),
               c = __ldg(s + k + 2 * step), e = __ldg(s + k + 3 * step);
    d[k] = a;
    d[k + step] = b;
    d[k + 2 * step] = c;
    d[k + 3 * step] = e;
  }
  for (; k < n4; k += step) d[k] = __ldg(s + k);
}

__device__ __forceinline__ int group_end(const Graph& g, int t0) {
  return t0 + kGroup < g.n_tiles ? t0 + kGroup : g.n_tiles;
}

// A segment exit as grid 5 reads it, 16 bits: its place u in the tile,
// -1 past the tile, kBadU for kBad.
constexpr int16_t kBadU = 0x7FFF;

template <bool F>
__device__ __forceinline__ int16_t seg_exit_u(int t, int x) {
  if (x == kBad) return kBadU;
  const int q = u_of<F>(t, x);
  return static_cast<int16_t>(q < 0 ? -1 : q);
}

// Grid 1.  door: (n_lanes, n_tiles, kDoor) the tiles' door maps; segx:
// (n_lanes, n_tiles, kSegs, kDoor) each segment's door nodes' segment
// exits as seg_exit_u gives them (grid 5 follows them to each segment's
// entry); next_u: (n_lanes, n_tiles, kTile) each node's next node in the
// tile as its place u, -1 where the walk stops there (it leaves the
// tile, stays or steps against its way): grid 5 walks these, 2 bytes a
// node, and reads no pointer again.
template <bool F>
__global__ void __launch_bounds__(kTileThreads)
door_kernel(Graph g, int* door, int16_t* segx, int16_t* next_u,
            int* start_exit) {
  __shared__ int ex[kTile];
  const int lane = blockIdx.x / g.n_tiles;
  const int t = blockIdx.x % g.n_tiles;
  const int s = threadIdx.x >> 5;
  const int64_t tile = static_cast<int64_t>(lane) * g.n_tiles + t;
  int p[kWins];
  load_segment<F>(g, lane, t, s, p, true);
  {
    int16_t* nu = next_u + tile * kTile;
#pragma unroll
    for (int w = 0; w < kWins; ++w) {
      const int u = s * kSeg + 32 * w + (threadIdx.x & 31);
      const int q = p[w] == kBad ? -1 : u_of<F>(t, p[w]);
      nu[u] = static_cast<int16_t>(q >= 0 && q < u ? q : -1);
    }
  }
  segment_scan<F>(t, s, p, ex);
  __syncthreads();
  int* out = door + tile * kDoor;
  for (int d = threadIdx.x; d < kDoor; d += kTileThreads) {
    out[d] = tile_exit<F>(t, ex, kTile - kDoor + d);
  }
  int16_t* sx = segx + tile * kSegs * kDoor;
  for (int k = threadIdx.x; k < kSegs * kDoor; k += kTileThreads) {
    sx[k] = seg_exit_u<F>(t, ex[(k / kDoor) * kSeg + kSeg - kDoor + k % kDoor]);
  }
  if (threadIdx.x == 0) {
    const int64_t st = start_of<F>(g, lane);
    if (in_lane(g, st) && tile_of(static_cast<int>(st)) == t) {
      start_exit[lane] =
          tile_exit<F>(t, ex, u_of<F>(t, static_cast<int>(st)));
    }
  }
}

template <bool F>
__global__ void __launch_bounds__(kGroupThreads)
group_kernel(Graph g, const int* door, const int* start_exit, int* gmap,
             int* gexit) {
  extern __shared__ int4 smem4[];
  int* maps = reinterpret_cast<int*>(smem4);
  const int lane = blockIdx.x / g.n_groups;
  const int gi = blockIdx.x % g.n_groups;
  const int t0 = gi << kGroupLog;
  const int t1 = group_end(g, t0);
  load_maps(door + (static_cast<int64_t>(lane) * g.n_tiles + t0) * kDoor,
            (t1 - t0) * kDoor, maps);
  __syncthreads();
  const int te = F ? t0 : t1 - 1;  // the walk's first tile
  const int d = threadIdx.x;
  if (d < kDoor) {
    gmap[(static_cast<int64_t>(lane) * g.n_groups + gi) * kDoor + d] =
        walk_tiles<F>(g, lane, te, maps[(te - t0) * kDoor + d], t0, t1, maps,
                      t0, nullptr);
  } else if (d == kDoor) {
    const int64_t st = start_of<F>(g, lane);
    const int ts = tile_of(static_cast<int>(st));
    if (in_lane(g, st) && ts >= t0 && ts < t1) {
      gexit[lane] = walk_tiles<F>(g, lane, ts, start_exit[lane], t0, t1, maps,
                                  t0, nullptr);
    }
  }
}

template <bool F>
__global__ void __launch_bounds__(kWalkThreads)
lane_kernel(Graph g, const int* door, const int* gmap, const int* gexit,
            int* gentry) {
  extern __shared__ int4 smem4[];
  int* maps = reinterpret_cast<int*>(smem4);
  __shared__ int want;  // the chunk of group maps the walk needs, or -1
  const int lane = blockIdx.x;
  const int ng = g.n_groups;
  int* ge = gentry + static_cast<int64_t>(lane) * ng;
  for (int k = threadIdx.x; k < ng; k += kWalkThreads) ge[k] = -1;
  const int64_t st = start_of<F>(g, lane);
  if (!in_lane(g, st)) {
    if (threadIdx.x == 0) g.status[0] = 1;
    return;
  }
  const int* lane_door = door + static_cast<int64_t>(lane) * g.n_tiles * kDoor;
  int gc = tile_of(static_cast<int>(st)) >> kGroupLog;  // thread 0's walk:
  int x = gexit[lane];  // its group, and where it leaves it
  int chunk = -1;
  __syncthreads();
  if (threadIdx.x == 0) ge[gc] = static_cast<int>(st);
  for (;;) {
    if (threadIdx.x == 0) {
      int need = -1;
      for (;;) {
        if (x == kBad) {
          g.status[1] = 1;
          break;
        }
        const int gx = tile_of(x) >> kGroupLog;
        if (gx == gc) break;  // a fixed point: the walk ends
        if (F ? gx < gc : gx > gc) {
          g.status[1] = 1;
          break;
        }
        ge[gx] = x;
        const int t0 = gx << kGroupLog;
        const int t1 = group_end(g, t0);
        const int te = F ? t0 : t1 - 1;
        const int d =
            tile_of(x) == te ? u_of<F>(te, x) - (kTile - kDoor) : -1;
        if (d < 0) {  // not a door node of the group: tile by tile
          const int e = exit_from<F>(g, lane, tile_of(x), x,
                                     lane_door + tile_of(x) * kDoor);
          x = walk_tiles<F>(g, lane, tile_of(x), e, t0, t1, lane_door, 0,
                            nullptr);
          gc = gx;
          continue;
        }
        if ((gx >> kGroupLog) != chunk) {
          need = gx >> kGroupLog;
          break;
        }
        x = maps[(gx & (kGroup - 1)) * kDoor + d];
        gc = gx;
      }
      want = need;
    }
    __syncthreads();
    const int c = want;
    if (c < 0) return;
    chunk = c;
    const int g0 = c << kGroupLog;
    const int g1 = g0 + kGroup < ng ? g0 + kGroup : ng;
    load_maps(gmap + (static_cast<int64_t>(lane) * ng + g0) * kDoor,
              (g1 - g0) * kDoor, maps);
    __syncthreads();
  }
}

template <bool F>
__global__ void __launch_bounds__(kWalkThreads)
entry_kernel(Graph g, const int* door, const int* start_exit,
             const int* gentry, int* entry) {
  extern __shared__ int4 smem4[];
  int* maps = reinterpret_cast<int*>(smem4);
  const int lane = blockIdx.x / g.n_groups;
  const int gi = blockIdx.x % g.n_groups;
  const int t0 = gi << kGroupLog;
  const int t1 = group_end(g, t0);
  int* en = entry + static_cast<int64_t>(lane) * g.n_tiles;
  for (int k = t0 + threadIdx.x; k < t1; k += kWalkThreads) en[k] = -1;
  const int64_t st = start_of<F>(g, lane);
  if (!in_lane(g, st)) {
    if (g.n_groups == 1 && threadIdx.x == 0) g.status[0] = 1;
    return;
  }
  const bool first = (tile_of(static_cast<int>(st)) >> kGroupLog) == gi;
  const int e = first ? static_cast<int>(st)
              : g.n_groups > 1
                  ? gentry[static_cast<int64_t>(lane) * g.n_groups + gi]
                  : -1;
  if (e < 0) return;
  load_maps(door + (static_cast<int64_t>(lane) * g.n_tiles + t0) * kDoor,
            (t1 - t0) * kDoor, maps);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = tile_of(e);
    en[t] = e;
    const int x = first ? start_exit[lane]
                        : exit_from<F>(g, lane, t, e, maps + (t - t0) * kDoor);
    if (walk_tiles<F>(g, lane, t, x, t0, t1, maps, t0, en) == kBad) {
      g.status[1] = 1;
    }
  }
}

// Grid 5.  A tile the walk enters: its next places (grid 1's) and its
// segments' door exits into shared memory; each segment's entry by them
// (a step a segment; an entry off every segment's door, which no route
// makes but the start's tile may, walks the tile in one run); then a
// thread a segment walks it (kSegs walks at once in one warp, a shared
// load a hop) and the block writes the marks.  Small blocks, so that many
// tiles' walks are in flight on an SM.
template <bool F>
__global__ void __launch_bounds__(kMarkThreads)
mark_kernel(Graph g, const int* entry, const int16_t* segx,
            const int16_t* next_u, uint8_t* mark) {
  __shared__ __align__(16) int16_t nu[kTile];
  __shared__ __align__(16) int16_t sx[kSegs * kDoor];
  __shared__ __align__(16) uint8_t reach[kTile];
  __shared__ int seg_in[kSegs];
  __shared__ int whole;
  const int lane = blockIdx.x / g.n_tiles;
  const int t = blockIdx.x % g.n_tiles;
  const int lo = t << kTileLog;
  uint8_t* out = mark + static_cast<int64_t>(lane) * g.n_out;
  const int64_t tile = static_cast<int64_t>(lane) * g.n_tiles + t;
  const int e = entry[tile];
  if (e < 0) {  // the walk does not enter
    const int hi = lo + kTile < g.n_out ? lo + kTile : g.n_out;
    for (int j = lo + threadIdx.x; j < hi; j += kMarkThreads) out[j] = 0;
    return;
  }
  load_maps(reinterpret_cast<const int*>(segx + tile * kSegs * kDoor),
            kSegs * kDoor / 2, reinterpret_cast<int*>(sx));
  load_maps(reinterpret_cast<const int*>(next_u + tile * kTile), kTile / 2,
            reinterpret_cast<int*>(nu));
  for (int k = threadIdx.x; k < kTile / 16; k += kMarkThreads) {
    reinterpret_cast<uint4*>(reach)[k] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x < kSegs) seg_in[threadIdx.x] = -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int q = u_of<F>(t, e), in_one = 0;
    while (q >= 0) {
      const int sg = q >> kSegLog;
      seg_in[sg] = q;
      const int d = q - (sg * kSeg + kSeg - kDoor);
      if (d < 0) {
        in_one = 1;
        break;
      }
      const int y = sx[sg * kDoor + d];
      // kBad, a fixed point in this segment, or past the tile: it ends
      if (y == kBadU || y >= sg * kSeg) break;
      q = y;
    }
    whole = in_one;
  }
  __syncthreads();
  if (threadIdx.x < (whole ? 1 : kSegs)) {
    int q = whole ? u_of<F>(t, e) : seg_in[threadIdx.x];
    const int floor = whole ? 0 : threadIdx.x * kSeg;
    while (q >= floor) {
      reach[q] = 1;
      q = nu[q];
    }
  }
  __syncthreads();
  const int64_t len = F ? g.n[lane] : g.lens[lane];
  for (int u = threadIdx.x; u < kTile; u += kMarkThreads) {
    const int j = node_at<F>(t, u);
    if (j < g.n_out) {
      out[j] = reach[u] && (F ? j < len : j > 0 && j <= len);
    }
  }
}

// ------------------------------------------------------------------ K14
constexpr int kCTileLog = 12;
constexpr int kCTile = 1 << kCTileLog;  // nodes (and slots) a tile
constexpr int kCThreads = 256;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

// A lane group's marks and what their tokens are made of.  Extract's
// form: from, choice (n_lanes, width) int32.  _compact's: best_len,
// best_dist (n_lanes, width) int64 and take (n_lanes, width) bool.
// state: each tile's published sum, (sum << 2) | kAggregate or kPrefix;
// ticket: the tiles' order.
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
  unsigned long long* state;
  unsigned* ticket;
};

// Exclusive sum of v over the block (kCThreads); *total gets the sum.
__device__ int block_scan(int v, int* sums, int* total) {
  constexpr int kWarps = kCThreads / 32;
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

// The 16 marks of a chunk as bits (a nonzero byte is a mark).
__device__ __forceinline__ unsigned chunk_bits(uint4 v) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned w = words[i];
    const unsigned nz = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
    bits |= (((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) |
             ((nz >> 28) & 8u)) << (4 * i);
  }
  return bits;
}

__device__ __forceinline__ void publish(unsigned long long* p, int64_t sum,
                                        unsigned long long flag) {
  atomicExch(p, (static_cast<unsigned long long>(sum) << 2) | flag);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// dst[0, n) = src[0, n) (or = fill where src is null), as 16-byte stores
// where dst is 16-byte aligned, else 8-byte ones at the two ends.
__device__ __forceinline__ void write_run(int64_t* dst, const int64_t* src,
                                          int64_t fill, int64_t n) {
  if (n <= 0) return;
  const int64_t head = (reinterpret_cast<uintptr_t>(dst) & 15) ? 1 : 0;
  const int64_t pairs = (n - head) / 2;
  longlong2* d2 = reinterpret_cast<longlong2*>(dst + head);
  for (int64_t i = threadIdx.x; i < pairs; i += kCThreads) {
    d2[i] = src ? make_longlong2(src[head + 2 * i], src[head + 2 * i + 1])
                : make_longlong2(fill, fill);
  }
  if (threadIdx.x == 0) {
    if (head) dst[0] = src ? src[0] : fill;
    const int64_t tail = head + 2 * pairs;
    if (tail < n) dst[tail] = src ? src[tail] : fill;
  }
}

// t_valid's bytes [lo, hi) of a row: slot < ntok, 16-byte stores inside
// the range's aligned chunks, bytes at its two ends.
__device__ __forceinline__ void write_valid(uint8_t* row, int64_t lo,
                                            int64_t hi, int64_t ntok) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(row + lo);
  const uintptr_t a1 = reinterpret_cast<uintptr_t>(row + hi);
  uintptr_t c0 = (a0 + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t c1 = a1 & ~static_cast<uintptr_t>(15);
  if (c0 > c1) c0 = c1 = a1;
  for (int64_t i = threadIdx.x; i < static_cast<int64_t>(c0 - a0) +
                                        static_cast<int64_t>(a1 - c1);
       i += kCThreads) {
    const int64_t head = c0 - a0;
    const int64_t s = i < head ? lo + i : lo + (c1 - a0) + (i - head);
    row[s] = s < ntok;
  }
  for (int64_t i = threadIdx.x; i < static_cast<int64_t>(c1 - c0) / 16;
       i += kCThreads) {
    const int64_t s0 = lo + static_cast<int64_t>(c0 - a0) + 16 * i;
    const int64_t cnt = ntok - s0 < 0 ? 0 : ntok - s0 > 16 ? 16 : ntok - s0;
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t m = cnt - 4 * k < 0 ? 0 : cnt - 4 * k > 4 ? 4 : cnt - 4 * k;
      w[k] = m == 0 ? 0u : 0x01010101u >> (8 * (4 - m));
    }
    reinterpret_cast<uint4*>(c0)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(kCThreads) compact_kernel(Tokens k) {
  __shared__ int64_t stage[kCTile];
  __shared__ int sums[32];
  __shared__ int64_t shared_ticket, shared_base, shared_ntok;
  if (threadIdx.x == 0) shared_ticket = atomicAdd(k.ticket, 1u);
  __syncthreads();
  const int64_t tk = shared_ticket;
  const int64_t lane = tk / k.n_tiles;
  const int64_t t = tk % k.n_tiles;
  const int64_t lo = t << kCTileLog;
  const int64_t hi = lo + kCTile < k.width ? lo + kCTile : k.width;
  if (lane < k.n_lanes) {
    // this tile's marks: 16-byte chunks of the byte range, thread i the
    // i-th (the last thread also the one past kCTile / 16, where the
    // range is not aligned)
    const int64_t row = lane * k.width;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(k.mark + row + lo);
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(k.mark + row + hi);
    const int64_t c0 = a0 >> 4, n_chunks = ((a1 + 15) >> 4) - c0;
    const int64_t mine = threadIdx.x < kCThreads - 1 ? 1 : 2;
    unsigned long long bits = 0;
    for (int64_t i = 0; i < mine; ++i) {
      const int64_t c = threadIdx.x + i;
      if (c >= n_chunks) break;
      const uintptr_t at = static_cast<uintptr_t>(c0 + c) << 4;
      unsigned b = chunk_bits(*reinterpret_cast<const uint4*>(at));
      if (at < a0) b &= 0xFFFFu << (a0 - at);
      if (at + 16 > a1) b &= 0xFFFFu >> (at + 16 - a1);
      bits |= static_cast<unsigned long long>(b) << (16 * i);
    }
    int total;
    const int off = block_scan(__popcll(bits), sums, &total);
    if (threadIdx.x < 32) {  // the look-back, a warp
      const int ln = threadIdx.x;
      unsigned long long* st = k.state + lane * k.n_tiles;
      int64_t excl = 0;
      if (t == 0) {
        if (ln == 0) publish(st, total, kPrefix);
      } else {
        if (ln == 0) publish(st + t, total, kAggregate);
        for (int64_t q = t - 1;; q -= 32) {
          const int64_t i = q - ln;
          unsigned long long v = 0;
          if (i >= 0) {
            do {
              v = peek(st + i);
            } while ((v & 3) == 0);
          }
          const unsigned pre = __ballot_sync(kFull, i >= 0 && (v & 3) == kPrefix);
          const int stop = pre ? __ffs(pre) - 1 : 31;
          int64_t add = i >= 0 && ln <= stop ? static_cast<int64_t>(v >> 2) : 0;
          for (int o = 16; o > 0; o >>= 1) add += __shfl_down_sync(kFull, add, o);
          excl += __shfl_sync(kFull, add, 0);
          if (pre) break;
        }
        if (ln == 0) publish(st + t, excl + total, kPrefix);
      }
      if (ln == 0) {
        shared_base = excl;
        if (t == k.n_tiles - 1) k.ntok[lane] = excl + total;
      }
    }
    __syncthreads();
    const int64_t first = shared_base;
    // the tile's tokens, a plane at a time: staged at their offsets, then
    // written out as a run of slots
    int64_t* planes[3] = {k.t_pos, k.t_len, k.t_dist};
    for (int plane = 0; plane < 3; ++plane) {
      int at = off;
      unsigned long long b = bits;
      while (b) {
        const int bit = __ffsll(b) - 1;
        b &= b - 1;
        const int64_t j =
            static_cast<int64_t>(((static_cast<uintptr_t>(c0 + threadIdx.x) << 4) +
                                  bit) - reinterpret_cast<uintptr_t>(k.mark + row));
        int64_t v;
        if (k.forward) {
          const bool match = k.take[row + j] != 0;
          v = plane == 0 ? j
              : plane == 1 ? (match ? k.best_len[row + j] : 1)
                           : (match ? k.best_dist[row + j] : -1);
        } else {
          const int64_t f = k.from[row + j];
          v = plane == 0 ? f : plane == 1 ? j - f : k.choice[row + j];
        }
        stage[at++] = v;
      }
      __syncthreads();
      write_run(planes[plane] + row + first, stage, 0, total);
      __syncthreads();
    }
  }
  if (lane >= 1) {  // the previous lane's fill over this tile's slots
    const int64_t fl = lane - 1;
    if (threadIdx.x == 0) {
      const unsigned long long* st = k.state + fl * k.n_tiles + k.n_tiles - 1;
      unsigned long long v;
      do {
        v = peek(st);
      } while ((v & 3) != kPrefix);
      shared_ntok = static_cast<int64_t>(v >> 2);
    }
    __syncthreads();
    const int64_t ntok = shared_ntok;
    const int64_t row = fl * k.width;
    write_valid(k.t_valid + row, lo, hi, ntok);
    const int64_t f0 = ntok > lo ? ntok : lo;
    write_run(k.t_pos + row + f0, nullptr, 0, hi - f0);
    write_run(k.t_len + row + f0, nullptr, 1, hi - f0);
    write_run(k.t_dist + row + f0, nullptr, -1, hi - f0);
  }
}

int64_t tiles_of(int64_t n, int log) { return (n + (1LL << log) - 1) >> log; }

constexpr int kMapBytes = kGroup * kDoor * 4;  // a group's door maps

// The walk grids' shared memory: up to a group's door maps (set once a
// device).
template <bool F>
cudaError_t allow_maps_of() {
  cudaError_t err = cudaFuncSetAttribute(
      group_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMapBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        lane_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMapBytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        entry_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMapBytes);
  }
  return err;
}

cudaError_t allow_maps() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = allow_maps_of<false>();
  if (err == cudaSuccess) err = allow_maps_of<true>();
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename K>
int occupancy(K fn, int threads, int smem) {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                       smem) == cudaSuccess
             ? blocks
             : -1;
}

// K13's scratch, 16-byte aligned pieces: each lane's start exit and
// start group exit, the tiles' door maps, segment door exits and next
// places, the groups' maps and entries, the tiles' entries.
struct MarkScratch {
  int *start_exit, *gexit, *door;
  int16_t *segx, *next_u;
  int *gmap, *gentry, *entry;
};

int64_t mark_layout(int n_lanes, int64_t n_nodes, char* base,
                    MarkScratch* s) {
  const int64_t nt = tiles_of(n_nodes, kTileLog);
  const int64_t ng = tiles_of(nt, kGroupLog);
  int64_t off = 0;
  auto take = [&](int64_t ints) {
    int* p = base ? reinterpret_cast<int*>(base + off) : nullptr;
    off += (4 * ints + 15) / 16 * 16;
    return p;
  };
  MarkScratch m;
  m.start_exit = take(n_lanes);
  m.gexit = take(n_lanes);
  m.door = take(n_lanes * nt * kDoor);
  m.segx = reinterpret_cast<int16_t*>(take(n_lanes * nt * kSegs * kDoor / 2));
  m.next_u = reinterpret_cast<int16_t*>(take(n_lanes * nt * kTile / 2));
  m.gmap = take(ng > 1 ? n_lanes * ng * kDoor : 0);
  m.gentry = take(ng > 1 ? n_lanes * ng : 0);
  m.entry = take(n_lanes * nt);
  if (s) *s = m;
  return off;
}

template <bool F>
void launch_mark(const Graph& g, const MarkScratch& m, uint8_t* mark,
                 cudaStream_t s) {
  const int nt = g.n_tiles, ng = g.n_groups, L = g.n_lanes;
  const int map_bytes = (nt < kGroup ? nt : kGroup) * kDoor * 4;
  door_kernel<F><<<nt * L, kTileThreads, 0, s>>>(g, m.door, m.segx,
                                                 m.next_u, m.start_exit);
  if (ng > 1) {
    group_kernel<F><<<ng * L, kGroupThreads, map_bytes, s>>>(
        g, m.door, m.start_exit, m.gmap, m.gexit);
    lane_kernel<F><<<L, kWalkThreads, map_bytes, s>>>(g, m.door, m.gmap,
                                                      m.gexit, m.gentry);
  }
  entry_kernel<F><<<ng * L, kWalkThreads, map_bytes, s>>>(
      g, m.door, m.start_exit, m.gentry, m.entry);
  mark_kernel<F><<<nt * L, kMarkThreads, 0, s>>>(g, m.entry, m.segx,
                                                 m.next_u, mark);
}

}  // namespace

// Scratch bytes of lzt_path_mark for n_lanes lanes of n_nodes nodes.
extern "C" long long lzt_path_mark_scratch(int n_lanes, long long n_nodes) {
  return mark_layout(n_lanes, n_nodes, nullptr, nullptr);
}

// The device pointer of a page of mapped pinned host memory (K13's
// status flags), in *device.  Returns the CUDA error (0 on success).
extern "C" int lzt_path_mapped(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

// K13.  forward 0: from (n_lanes, n_nodes) int32, lens (n_lanes,)
// int64, n_out = n_nodes.  forward 1: adv (n_lanes, n_nodes - 1) int64,
// n (n_lanes,) int64, start in [0, n_nodes), n_out = n_nodes - 1.  mark
// (n_lanes, n_out) bool.  status: the device pointer (lzt_path_mapped)
// of two int32 flags in mapped pinned host memory, zero on entry: [0] set
// for a pointer or start outside the lane, [1] for a walk that steps
// against its way (back into a tile it has left).  The call synchronises
// the stream, so the flags are final on the host when it returns.
// Returns the first CUDA error (0 on success).
extern "C" int lzt_path_mark(const int* from, const int64_t* lens,
                             const int64_t* adv, const int64_t* n,
                             long long start, int forward, int n_lanes,
                             long long n_nodes, void* scratch, int* status,
                             uint8_t* mark, void* stream) {
  const int64_t nt = tiles_of(n_nodes, kTileLog);
  const int64_t ng = tiles_of(nt, kGroupLog);
  if (n_lanes <= 0 || n_nodes <= forward || n_nodes >= INT_MAX - kTile ||
      nt * n_lanes > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_maps();
  if (err != cudaSuccess) return static_cast<int>(err);
  MarkScratch m;
  mark_layout(n_lanes, n_nodes, static_cast<char*>(scratch), &m);
  const Graph g{from, lens, adv, n, status, start,
                static_cast<int>(n_nodes), static_cast<int>(n_nodes - forward),
                n_lanes, static_cast<int>(nt), static_cast<int>(ng)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (forward) {
    launch_mark<true>(g, m, mark, s);
  } else {
    launch_mark<false>(g, m, mark, s);
  }
  err = cudaGetLastError();
  // the call's one readback: the flags are the host's once the stream is done
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

// Scratch bytes of lzt_path_compact: the tiles' published sums, then
// the ticket counter; zeroed by lzt_path_compact itself.
extern "C" long long lzt_path_compact_scratch(int n_lanes, long long width) {
  return 8LL * n_lanes * tiles_of(width, kCTileLog) + 16;
}

// K14.  mark (n_lanes, width) bool; forward 0: from, choice (n_lanes,
// width) int32; forward 1: best_len, best_dist (n_lanes, width) int64,
// take (n_lanes, width) bool.  t_pos, t_len, t_dist (n_lanes, width)
// int64, t_valid (n_lanes, width) bool, ntok (n_lanes,) int64, every
// element written.  Returns the first CUDA error (0 on success).
extern "C" int lzt_path_compact(const uint8_t* mark, const int* from,
                                const int* choice, const int64_t* best_len,
                                const int64_t* best_dist, const uint8_t* take,
                                int forward, int n_lanes, long long width,
                                void* scratch, int64_t* t_pos, int64_t* t_len,
                                int64_t* t_dist, uint8_t* t_valid,
                                int64_t* ntok, void* stream) {
  const int64_t nt = tiles_of(width, kCTileLog);
  if (n_lanes <= 0 || width <= 0 || width >= INT_MAX ||
      nt * (n_lanes + 1) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = lzt_path_compact_scratch(n_lanes, width);
  cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* state = static_cast<unsigned long long*>(scratch);
  const Tokens k{mark, from, choice, best_len, best_dist, take, width,
                 n_lanes, static_cast<int>(nt), forward, t_pos, t_len, t_dist,
                 ntok, t_valid, state,
                 reinterpret_cast<unsigned*>(state + n_lanes * nt)};
  // a block a tile, and the last lane's fill: n_tiles more
  compact_kernel<<<nt * (n_lanes + 1), kCThreads, 0, s>>>(k);
  return static_cast<int>(cudaGetLastError());
}

// K13's and K14's grids' blocks an SM on this card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; K13's on the DP path):
// 0 door, 1 group, 2 lane, 3 entry (these three with a whole group's door
// maps), 4 mark, 5 compact; -1 for another grid or a failed query.
extern "C" int lzt_path_occupancy(int grid) {
  if (grid >= 1 && grid <= 3 && allow_maps() != cudaSuccess) return -1;
  switch (grid) {
    case 0: return occupancy(door_kernel<false>, kTileThreads, 0);
    case 1: return occupancy(group_kernel<false>, kGroupThreads, kMapBytes);
    case 2: return occupancy(lane_kernel<false>, kWalkThreads, kMapBytes);
    case 3: return occupancy(entry_kernel<false>, kWalkThreads, kMapBytes);
    case 4: return occupancy(mark_kernel<false>, kMarkThreads, 0);
    case 5: return occupancy(compact_kernel, kCThreads, 0);
    default: return -1;
  }
}
