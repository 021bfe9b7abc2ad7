// The LZMA state machine and rep-distance MTF over per-lane token streams
// (K6), as a parallel scan over each lane's tokens, and the whole of
// classify_tokens around it (K19).
//
// K6 replaces the carry of lzma_tpu/ops/device_encoder.py classify_tokens,
// a lax.scan that JAX compiles for the device (it has no pallas_call): the
// same contract as the plain version lzma_tpu_torch/ops/device_encoder.py
// _classify_carry -- for every token row of every lane its scan case (0
// fresh match, 1..4 rep0..rep3, 5 literal), the state before it and rep0
// before it, in the (T, N) layout of the token rows (lzt_classify).
//
// K19 (lzt_classify_tokens) is classify_tokens whole, the plain version
// _classify_tokens_plain (_classify_rows, _classify_carry and
// _classify_finish): the same scan grids read t_dist, t_len and t_valid in
// their (N, T) layout through their strides (no transposed rows), and the
// last grid, after its rescan, writes the seven (N, T) int64 planes
// (kind, rep_idx, state_before, match_mode, match_byte, prev_byte,
// lit_byte; classify_meta.cuh's closed forms), a thread a token, the
// lane's bytes read through L1/L2.  Its bound is its bytes: 25 B of token
// planes read, 3 data bytes and 56 B written a token slot.
//
// What bounds it on this card: the bytes -- dist, len and valid read,
// case, state and r0 written, ~21 B a row -- once the carry is no longer
// one dependent chain a lane.  It is not: the carry is associative.
//   - The reps before a token are the four most recent distinct
//     distances of the lane's earlier valid non-literal tokens (EOS_DIST
//     counts as one), padded with 0: the lane's (0,0,0,0) start and the
//     MTF's first-equal rule make those zeros padding.  A segment's
//     summary is its own list (at most 4, most recent first); a prefix A
//     then a segment B give the first 4 of dedupe(B ++ A).
//   - The state before a token is the composition of the earlier
//     tokens' state maps (12 entries, nibbles of a uint64).  A token's
//     map depends on its kind -- literal, match, rep, shortRep -- and
//     match or rep depends on the reps before it, so the maps are
//     scanned after the lists, not with them.
//   - An invalid row holds the carry: the identity of both.  So every
//     row, a lane's tail past its last valid token included, is written
//     by the same rescan.
// Five grids, one call; a block takes a tile of rows x lanes, a thread a
// chunk of kChunk consecutive rows of one lane:
//   1. tile_lists: each chunk's list, scanned across the block's chunks
//      of a lane; the tile's list per lane;
//   2. lane_scan: each lane's tile lists, exclusive (a block a lane);
//   3. tile_maps: each chunk's exact reps (its tile's prefix and the
//      chunks before it in the tile), then its map, rescanning with the
//      real cases; the maps scanned across the block; the tile's map;
//   4. lane_scan: each lane's tile maps, exclusive;
//   5. tile_rows: each chunk rescanned from its reps and state, writing
//      case, state and r0.
// Three passes over the rows (5, 9 and 21 B a row) against the 21 of a
// single pass: the two scans' dependence (a token's kind needs its reps)
// buys grids that need no look-back and no ordering between blocks.
// Access: a tile is rows [t0, t0 + R) x lanes [n0, n0 + W), W the lanes
// (a power of two, at most 32) and R = 256 / W * kChunk rows, so a tile
// is 4,096 rows of one lane at N = 1 and 128 rows of 32 lanes at N = 32,
// a contiguous span of the (T, N) arrays either way; it is staged into
// shared memory (one pad word every 32, so that a thread's chunk and a
// warp's row both read distinct banks) and written back from there.

#include <cstdint>
#include <cuda_runtime.h>

#include "classify_meta.cuh"

namespace {

constexpr int kEosDist = -2;     // device_encoder.EOS_DIST: a match
constexpr int kEmpty = -1;       // an unused list entry (never a distance)
constexpr int kThreads = 256;    // a tile's block, a chunk a thread
constexpr int kChunk = 16;       // rows of a lane a thread takes
constexpr int kTileElems = kThreads * kChunk;
constexpr int kTilePad = kTileElems + kTileElems / 32;
constexpr uint64_t kIdentity = 0xBA9876543210ULL;  // the identity state map

struct Tiles {
  int lw;     // log2 W, the lanes of a tile
  int rows;   // R, the rows of a tile
  int n_tr;   // tiles down a lane
  int n_lt;   // tiles across the lanes
};

Tiles tiles_of(int n_tok, int n_lanes) {
  int lw = 0;
  while ((1 << lw) < n_lanes && lw < 5) ++lw;
  const int rows = (kThreads >> lw) * kChunk;
  return {lw, rows, (n_tok + rows - 1) / rows,
          (n_lanes + (1 << lw) - 1) >> lw};
}

__device__ __forceinline__ int padded(int f) { return f + (f >> 5); }

// The token planes a scan reads, each through its element strides (row,
// lane): K6's contiguous (T, N) rows, K19's (N, T) planes as given.
template <typename TI>
struct Src {
  const TI* dist;
  const TI* len;
  const uint8_t* valid;
  long long dr, dl;  // dist's strides
  long long lr, ll;  // len's
  long long vr, vl;  // valid's
  bool rows_fast;    // rows are dist's unit stride: stage a lane's run
};

__device__ __forceinline__ int case_of(int d, int4 r) {
  const bool lit = d < 0 && d != kEosDist;
  const int m = d == r.x ? 1 : d == r.y ? 2 : d == r.z ? 3 : d == r.w ? 4 : 0;
  return lit ? 5 : m;
}

// The MTF of a valid token of case c (a literal moves nothing).
__device__ __forceinline__ void mtf(int4& r, int c, int d) {
  const bool moves = c != 5;
  const bool s1 = moves && c != 1;
  const bool s2 = moves && (c == 0 || c >= 3);
  const bool s3 = moves && (c == 0 || c == 4);
  r.w = s3 ? r.z : r.w;
  r.z = s2 ? r.y : r.z;
  r.y = s1 ? r.x : r.y;
  r.x = moves ? d : r.x;  // a rep's dist is the rep it matched
}

// A prefix's list, then a later segment's: the first 4 of dedupe(b ++ a).
__device__ __forceinline__ int4 join_lists(int4 a, int4 b) {
  int4 o = b;
  const int xs[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = xs[k];
    const bool keep = x != kEmpty && x != b.x && x != b.y && x != b.z &&
                      x != b.w;
    // a's entries are distinct, so only b's are checked; o's entries
    // are a prefix: x goes to its first empty one
    if (keep) {
      if (o.x == kEmpty) o.x = x;
      else if (o.y == kEmpty) o.y = x;
      else if (o.z == kEmpty) o.z = x;
      else if (o.w == kEmpty) o.w = x;
    }
  }
  return o;
}

// A prefix's map, then a later segment's: b after a.
__device__ __forceinline__ uint64_t join_maps(uint64_t a, uint64_t b) {
  uint64_t o = 0;
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    const int x = static_cast<int>((a >> (4 * s)) & 15);
    o |= ((b >> (4 * x)) & 15) << (4 * s);
  }
  return o;
}

__device__ __forceinline__ int apply_map(uint64_t m, int s) {
  return static_cast<int>((m >> (4 * s)) & 15);
}

struct ListOp {
  using T = int4;
  __device__ static T identity() { return make_int4(kEmpty, kEmpty, kEmpty, kEmpty); }
  __device__ static T join(T a, T b) { return join_lists(a, b); }
};

struct MapOp {
  using T = uint64_t;
  __device__ static T identity() { return kIdentity; }
  __device__ static T join(T a, T b) { return join_maps(a, b); }
};

// Inclusive scan of x over the block's threads at positions
// tid, tid - stride, tid - 2 stride, ... (`at` of them before tid),
// n positions a scan; Hillis-Steele through buf (blockDim.x entries).
template <class Op>
__device__ typename Op::T block_scan(typename Op::T x, typename Op::T* buf,
                                     int at, int n, int stride) {
  const int tid = threadIdx.x;
  buf[tid] = x;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    const typename Op::T y = at >= off ? Op::join(buf[tid - off * stride], x) : x;
    __syncthreads();
    buf[tid] = y;
    x = y;
    __syncthreads();
  }
  return x;
}

// The block's tile: its origin, and this thread's lane and chunk.
struct Tile {
  long long t0;  // first row
  int n0;        // first lane
  int w, c;      // this thread's lane in the tile, chunk in the lane
  int lane;      // n0 + w
  int per;       // chunks a lane in the tile (256 / W)
  long long blk; // the tile's index (tr * n_lt + lt)
  long long tr;  // the tile's place down the lanes
};

__device__ __forceinline__ Tile tile_here(Tiles g) {
  Tile t;
  t.blk = blockIdx.x;
  t.tr = t.blk / g.n_lt;
  const int lt = static_cast<int>(t.blk - t.tr * g.n_lt);
  t.t0 = t.tr * g.rows;
  t.n0 = lt << g.lw;
  t.w = threadIdx.x & ((1 << g.lw) - 1);
  t.c = threadIdx.x >> g.lw;
  t.lane = t.n0 + t.w;
  t.per = kThreads >> g.lw;
  return t;
}

// Rows of the tile into shared memory: dist (its low 32 bits, as the rows
// K6 takes hold it) and a flag byte (bit 0 valid, bit 1 len < 2, bit 2 a
// literal's distance at its full width; 0 outside the arrays, an invalid
// row).  Where rows are the unit stride a thread's consecutive f walk a
// lane's run of rows, else the lanes of a row.
template <bool kLen, typename TI>
__device__ __forceinline__ void stage(Tiles g, const Tile& t, const Src<TI>& src,
                                      int* sd, uint8_t* sf, int n_tok,
                                      int n_lanes) {
  const int w_mask = (1 << g.lw) - 1;
  const int lr = 12 - g.lw;  // log2 of the tile's rows (kTileElems = 4096)
  for (int f = threadIdx.x; f < kTileElems; f += kThreads) {
    const int at = src.rows_fast ? (((f & ((1 << lr) - 1)) << g.lw) | (f >> lr))
                                 : f;
    const long long row = t.t0 + (at >> g.lw);
    const int lane = t.n0 + (at & w_mask);
    int d = 0, fl = 0;
    if (row < n_tok && lane < n_lanes) {
      const TI dw = __ldg(src.dist + row * src.dr + lane * src.dl);
      d = static_cast<int>(dw);
      fl = __ldg(src.valid + row * src.vr + lane * src.vl) ? 1 : 0;
      if (kLen) {
        fl |= static_cast<int>(__ldg(src.len + row * src.lr + lane * src.ll)) < 2
                  ? 2 : 0;
        fl |= classify_meta::is_literal(static_cast<int64_t>(dw)) ? 4 : 0;
      }
    }
    sd[padded(at)] = d;
    sf[padded(at)] = static_cast<uint8_t>(fl);
  }
  __syncthreads();
}

// This thread's chunk's own list: the MTF from an empty list.
__device__ __forceinline__ int4 chunk_list(Tiles g, const Tile& t,
                                           const int* sd, const uint8_t* sf) {
  int4 r = ListOp::identity();
  const int f0 = (t.c * kChunk << g.lw) + t.w;
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int p = padded(f0 + (i << g.lw));
    const int d = sd[p];
    if (sf[p] & 1) mtf(r, case_of(d, r), d);
  }
  return r;
}

__device__ __forceinline__ int4 pad_reps(int4 r) {
  return make_int4(r.x == kEmpty ? 0 : r.x, r.y == kEmpty ? 0 : r.y,
                   r.z == kEmpty ? 0 : r.z, r.w == kEmpty ? 0 : r.w);
}

// ---------------------------------------------------------------- grid 1
template <typename TI>
__global__ void __launch_bounds__(kThreads)
    tile_lists_kernel(Tiles g, Src<TI> src, int4* __restrict__ tile_list,
                      int n_tok, int n_lanes) {
  __shared__ int sd[kTilePad];
  __shared__ uint8_t sf[kTilePad];
  __shared__ int4 buf[kThreads];
  const Tile t = tile_here(g);
  stage<false>(g, t, src, sd, sf, n_tok, n_lanes);
  const int4 r = block_scan<ListOp>(chunk_list(g, t, sd, sf), buf, t.c,
                                    t.per, 1 << g.lw);
  if (t.c == t.per - 1 && t.lane < n_lanes) {
    tile_list[t.tr * n_lanes + t.lane] = r;
  }
}

// ------------------------------------------------------------ grids 2, 4
// Each lane's tile summaries (n_tr of them, stride n_lanes) replaced by
// their exclusive prefix; a block a lane.
template <class Op>
__global__ void __launch_bounds__(kThreads)
    lane_scan_kernel(typename Op::T* __restrict__ s, int n_tr, int n_lanes) {
  using T = typename Op::T;
  __shared__ T buf[kThreads];
  const int lane = blockIdx.x;
  const int per = (n_tr + kThreads - 1) / kThreads;
  const int begin = min(static_cast<int>(threadIdx.x) * per, n_tr);
  const int end = min(begin + per, n_tr);
  T agg = Op::identity();
  for (int i = begin; i < end; ++i) {
    agg = Op::join(agg, s[static_cast<long long>(i) * n_lanes + lane]);
  }
  block_scan<Op>(agg, buf, threadIdx.x, kThreads, 1);
  T pre = threadIdx.x > 0 ? buf[threadIdx.x - 1] : Op::identity();
  for (int i = begin; i < end; ++i) {
    T& x = s[static_cast<long long>(i) * n_lanes + lane];
    const T here = x;
    x = pre;
    pre = Op::join(pre, here);
  }
}

// ---------------------------------------------------------------- grid 3
// The byte-lane state vector of 4 states after one valid token: a
// literal, or a match / rep / shortRep taking s < 7 to lo, s >= 7 to hi.
__device__ __forceinline__ uint32_t step4(uint32_t x, bool lit, uint32_t lo,
                                          uint32_t dhi) {
  const uint32_t ge4 = ((x + 0x7C7C7C7Cu) >> 7) & 0x01010101u;
  const uint32_t ge7 = ((x + 0x79797979u) >> 7) & 0x01010101u;
  const uint32_t ge10 = ((x + 0x76767676u) >> 7) & 0x01010101u;
  const uint32_t l = (x - 3u * (ge4 + ge10)) & (ge4 * 0xFFu);
  const uint32_t n = lo * 0x01010101u + ge7 * dhi;
  return lit ? l : n;
}

template <typename TI>
__global__ void __launch_bounds__(kThreads)
    tile_maps_kernel(Tiles g, Src<TI> src,
                     const int4* __restrict__ tile_list,
                     uint64_t* __restrict__ tile_map,
                     int4* __restrict__ chunk_reps,
                     uint64_t* __restrict__ chunk_map, int n_tok,
                     int n_lanes) {
  __shared__ int sd[kTilePad];
  __shared__ uint8_t sf[kTilePad];
  __shared__ int4 lbuf[kThreads];
  __shared__ uint64_t mbuf[kThreads];
  const Tile t = tile_here(g);
  const int stride = 1 << g.lw;
  stage<true>(g, t, src, sd, sf, n_tok, n_lanes);
  block_scan<ListOp>(chunk_list(g, t, sd, sf), lbuf, t.c, t.per, stride);
  const int4 before = t.c > 0 ? lbuf[threadIdx.x - stride] : ListOp::identity();
  const int4 prefix = t.lane < n_lanes ? tile_list[t.tr * n_lanes + t.lane]
                                       : ListOp::identity();
  int4 r = pad_reps(join_lists(prefix, before));
  const long long slot = t.blk * kThreads + threadIdx.x;
  chunk_reps[slot] = r;

  // the chunk's map over 12 states, 4 to a register's bytes
  uint32_t x0 = 0x03020100u, x1 = 0x07060504u, x2 = 0x0B0A0908u;
  const int f0 = (t.c * kChunk << g.lw) + t.w;
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int p = padded(f0 + (i << g.lw));
    const int d = sd[p];
    const int fl = sf[p];
    const int c = case_of(d, r);
    const bool lit = c == 5;
    // match (7, 10), rep (8, 11), shortRep (9, 11)
    const uint32_t lo = c == 0 ? 7u : (fl & 2) ? 9u : 8u;
    const uint32_t dhi = c == 0 ? 3u : (fl & 2) ? 2u : 3u;
    if (fl & 1) {
      x0 = step4(x0, lit, lo, dhi);
      x1 = step4(x1, lit, lo, dhi);
      x2 = step4(x2, lit, lo, dhi);
      mtf(r, c, d);
    }
  }
  uint64_t m = 0;
  const uint32_t xs[3] = {x0, x1, x2};
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    m |= static_cast<uint64_t>((xs[s >> 2] >> (8 * (s & 3))) & 15u) << (4 * s);
  }
  const uint64_t incl = block_scan<MapOp>(m, mbuf, t.c, t.per, stride);
  chunk_map[slot] = t.c > 0 ? mbuf[threadIdx.x - stride] : kIdentity;
  if (t.c == t.per - 1 && t.lane < n_lanes) {
    tile_map[t.tr * n_lanes + t.lane] = incl;
  }
}

// ---------------------------------------------------------------- grid 5
// The tile staged and each chunk rescanned from its reps and state: sd
// takes each row's r0, sf its case (bits 0-2) and whether its distance is
// a literal's (bit 3), ss its state.
template <typename TI>
__device__ __forceinline__ void rescan(Tiles g, const Tile& t,
                                       const Src<TI>& src,
                                       const uint64_t* __restrict__ tile_map,
                                       const int4* __restrict__ chunk_reps,
                                       const uint64_t* __restrict__ chunk_map,
                                       int* sd, uint8_t* sf, uint8_t* ss,
                                       int n_tok, int n_lanes) {
  stage<true>(g, t, src, sd, sf, n_tok, n_lanes);
  const long long slot = t.blk * kThreads + threadIdx.x;
  int4 r = chunk_reps[slot];
  const int s_tile = t.lane < n_lanes
                         ? apply_map(tile_map[t.tr * n_lanes + t.lane], 0)
                         : 0;
  int state = apply_map(chunk_map[slot], s_tile);
  const int f0 = (t.c * kChunk << g.lw) + t.w;
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int p = padded(f0 + (i << g.lw));
    const int d = sd[p];
    const int fl = sf[p];
    const int c = case_of(d, r);
    sd[p] = r.x;
    sf[p] = static_cast<uint8_t>(c | ((fl & 4) << 1));
    ss[p] = static_cast<uint8_t>(state);
    const bool high = state >= 7;
    const int lit_state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
    const int rep_state = high ? 11 : (fl & 2) ? 9 : 8;
    const int next = c == 5 ? lit_state : c == 0 ? (high ? 10 : 7) : rep_state;
    if (fl & 1) {
      state = next;
      mtf(r, c, d);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    tile_rows_kernel(Tiles g, Src<int> src,
                     const uint64_t* __restrict__ tile_map,
                     const int4* __restrict__ chunk_reps,
                     const uint64_t* __restrict__ chunk_map,
                     int* __restrict__ case_r, int* __restrict__ state_r,
                     int* __restrict__ r0_r, int n_tok, int n_lanes) {
  __shared__ int sd[kTilePad];     // dist, then r0
  __shared__ uint8_t sf[kTilePad]; // flags, then case
  __shared__ uint8_t ss[kTilePad]; // state
  const Tile t = tile_here(g);
  rescan(g, t, src, tile_map, chunk_reps, chunk_map, sd, sf, ss, n_tok,
         n_lanes);
  const int w_mask = (1 << g.lw) - 1;
  for (int f = threadIdx.x; f < kTileElems; f += kThreads) {
    const long long row = t.t0 + (f >> g.lw);
    const int lane = t.n0 + (f & w_mask);
    if (row < n_tok && lane < n_lanes) {
      const long long e = row * n_lanes + lane;
      const int p = padded(f);
      case_r[e] = sf[p] & 7;
      state_r[e] = ss[p];
      r0_r[e] = sd[p];
    }
  }
}

// K19's last grid: the rescan, then each token's seven values
// (classify_meta::finish) into the (N, T) planes of out, plane after
// plane, a warp's threads on consecutive rows of a lane.  pos: t_pos
// through its strides (row, lane); data: the lanes' bytes, a lane every
// data_stride.
__global__ void __launch_bounds__(kThreads)
    tile_finish_kernel(Tiles g, Src<long long> src,
                       const long long* __restrict__ pos, long long pr,
                       long long pl, const uint8_t* __restrict__ data,
                       long long data_stride, long long max_n,
                       const uint64_t* __restrict__ tile_map,
                       const int4* __restrict__ chunk_reps,
                       const uint64_t* __restrict__ chunk_map,
                       long long* __restrict__ out, int n_tok, int n_lanes) {
  __shared__ int sd[kTilePad];     // dist, then r0
  __shared__ uint8_t sf[kTilePad]; // flags, then case and literal
  __shared__ uint8_t ss[kTilePad]; // state
  const Tile t = tile_here(g);
  rescan(g, t, src, tile_map, chunk_reps, chunk_map, sd, sf, ss, n_tok,
         n_lanes);
  const long long plane = static_cast<long long>(n_lanes) * n_tok;
  const int lr = 12 - g.lw;
  for (int f = threadIdx.x; f < kTileElems; f += kThreads) {
    const int rl = f & ((1 << lr) - 1);
    const int w = f >> lr;
    const long long row = t.t0 + rl;
    const int lane = t.n0 + w;
    if (row < n_tok && lane < n_lanes) {
      const int p = padded((rl << g.lw) | w);
      const int cs = sf[p];
      int64_t v[classify_meta::kPlanes];
      classify_meta::finish(cs & 7, (cs & 8) != 0, ss[p], sd[p],
                            __ldg(pos + row * pr + lane * pl),
                            data + lane * data_stride, max_n, v);
      long long* o = out + static_cast<long long>(lane) * n_tok + row;
#pragma unroll
      for (int k = 0; k < classify_meta::kPlanes; ++k) o[k * plane] = v[k];
    }
  }
}

struct Scratch {
  int4* tile_list;
  int4* chunk_reps;
  uint64_t* tile_map;
  uint64_t* chunk_map;
};

long long scratch_layout(Tiles g, int n_lanes, void* base, Scratch* out) {
  const long long n_tile = static_cast<long long>(g.n_tr) * n_lanes;
  const long long n_chunk =
      static_cast<long long>(g.n_tr) * g.n_lt * kThreads;
  char* p = static_cast<char*>(base);
  if (out) {
    out->tile_list = reinterpret_cast<int4*>(p);
    out->chunk_reps = reinterpret_cast<int4*>(p + 16 * n_tile);
    out->tile_map = reinterpret_cast<uint64_t*>(p + 16 * (n_tile + n_chunk));
    out->chunk_map = reinterpret_cast<uint64_t*>(
        p + 16 * (n_tile + n_chunk) + 8 * n_tile);
  }
  return 24 * (n_tile + n_chunk);
}

}  // namespace

// Bytes of the scratch lzt_classify takes for (n_tok, n_lanes) rows.
extern "C" long long lzt_classify_scratch(int n_tok, int n_lanes) {
  if (n_tok <= 0 || n_lanes <= 0) return 0;
  return scratch_layout(tiles_of(n_tok, n_lanes), n_lanes, nullptr, nullptr);
}

namespace {

// The four scan grids K6 and K19 share: the tiles' lists, their lane
// scan, the chunks' reps and maps, their lane scan.
template <typename TI>
int scan_grids(Tiles g, const Src<TI>& src, const Scratch& w, int nb,
               int n_tok, int n_lanes, cudaStream_t s) {
  tile_lists_kernel<TI><<<nb, kThreads, 0, s>>>(g, src, w.tile_list, n_tok,
                                                n_lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_scan_kernel<ListOp><<<n_lanes, kThreads, 0, s>>>(w.tile_list, g.n_tr,
                                                        n_lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_maps_kernel<TI><<<nb, kThreads, 0, s>>>(g, src, w.tile_list,
                                               w.tile_map, w.chunk_reps,
                                               w.chunk_map, n_tok, n_lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_scan_kernel<MapOp><<<n_lanes, kThreads, 0, s>>>(w.tile_map, g.n_tr,
                                                       n_lanes);
  return static_cast<int>(cudaGetLastError());
}

// The grid of (n_tok, n_lanes) rows: its tiles, its scratch laid out, its
// blocks (0 where the grid would be too large).
int grid_of(int n_tok, int n_lanes, void* scratch, Tiles* g, Scratch* w) {
  *g = tiles_of(n_tok, n_lanes);
  scratch_layout(*g, n_lanes, scratch, w);
  const long long blocks = static_cast<long long>(g->n_tr) * g->n_lt;
  return blocks > 0x7FFFFFFFLL ? 0 : static_cast<int>(blocks);
}

}  // namespace

// dist, len: (n_tok, n_lanes) int32; valid: (n_tok, n_lanes) bytes 0/1;
// scratch: lzt_classify_scratch(n_tok, n_lanes) bytes, 16-byte aligned;
// case_r, state_r, r0_r: (n_tok, n_lanes) int32 outputs.  Returns the
// first CUDA error of the five launches (0 on success).
extern "C" int lzt_classify(const int* dist, const int* len,
                            const uint8_t* valid, void* scratch, int* case_r,
                            int* state_r, int* r0_r, int n_tok, int n_lanes,
                            void* stream) {
  if (n_tok <= 0 || n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tiles g;
  Scratch w;
  const int nb = grid_of(n_tok, n_lanes, scratch, &g, &w);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Src<int> src{dist, len, valid, n_lanes, 1, n_lanes, 1, n_lanes, 1,
                     false};
  const int err = scan_grids(g, src, w, nb, n_tok, n_lanes, s);
  if (err) return err;
  tile_rows_kernel<<<nb, kThreads, 0, s>>>(g, src, w.tile_map, w.chunk_reps,
                                           w.chunk_map, case_r, state_r, r0_r,
                                           n_tok, n_lanes);
  return static_cast<int>(cudaGetLastError());
}

// K19.  data: (n_lanes, max_n) bytes, a lane every data_stride; pos, len,
// dist: int64 and valid: bytes 0/1, (n_lanes, n_tok) through strides[8]
// (elements: pos's row and lane strides, then len's, dist's, valid's);
// scratch: lzt_classify_scratch(n_tok, n_lanes) bytes, 16-byte aligned;
// out: (7, n_lanes, n_tok) int64, contiguous.  Returns the first CUDA
// error of the five launches (0 on success).
extern "C" int lzt_classify_tokens(const uint8_t* data, long long data_stride,
                                   long long max_n, const long long* pos,
                                   const long long* len, const long long* dist,
                                   const uint8_t* valid,
                                   const long long* strides, void* scratch,
                                   long long* out, int n_tok, int n_lanes,
                                   void* stream) {
  if (n_tok <= 0 || n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tiles g;
  Scratch w;
  const int nb = grid_of(n_tok, n_lanes, scratch, &g, &w);
  if (nb == 0 || max_n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Src<long long> src{dist, len, valid, strides[4], strides[5],
                           strides[2], strides[3], strides[6], strides[7],
                           strides[4] == 1};
  const int err = scan_grids(g, src, w, nb, n_tok, n_lanes, s);
  if (err) return err;
  tile_finish_kernel<<<nb, kThreads, 0, s>>>(
      g, src, pos, strides[0], strides[1], data, data_stride, max_n,
      w.tile_map, w.chunk_reps, w.chunk_map, out, n_tok, n_lanes);
  return static_cast<int>(cudaGetLastError());
}
