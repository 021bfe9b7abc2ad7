// The bit lowering (K7) and its slot counts (K8), both from the per-token
// closed forms of lower_token.cuh.
//
// K7 replaces lzma_tpu/ops/device_encoder.py lower_tokens, a jax.jit
// function that XLA compiles for the device (it has no pallas_call): the
// same contract as the plain version lzma_tpu_torch/ops/device_encoder.py
// _lower_tokens_plain -- ctx and bit (n_lanes, max_bits) int32, a lane's
// pairs at [0, total) in token order, ctx CTX_DIRECT (-1) and bit 0 from
// total to max_bits, total (n_lanes,) int32.  A lane whose total passes
// max_bits, or whose tokens past the literal/shortRep slots number more
// than T / 2 + 2, sets a status bit instead (the wrapper raises the plain
// version's ValueError); such a lane's streams are not written at all.
//
// K8 replaces what the optimal parse's rounds make of it:
// lzma_tpu/ops/device_parser.py empirical_probs(lower_tokens(...))
// (device_parser.py:1669-1671 and :88) up to the probabilities -- the
// contract of _lower_counts_plain: for each lane and probability slot
// s < S, n (the lowered pairs with ctx == s) and n1 (those of them with
// bit 1), (n_lanes, S) int32; the direct bits (ctx -1) are not counted;
// total and the status bits as K7's.  The counts depend on a pair's slot
// and bit only, never on its offset, so K8 needs no scan and writes no
// stream.
//
// What bounds them on this card.  K7: the bytes -- the token and meta
// planes read (int64, ~80 B a token), the two int32 planes written over
// every slot (8 B a slot, ~10 slots a position, most of them fill).  K8:
// not the bytes (the planes read once, n and n1 written once) but the
// latency of each tile's rounds (load, classify, scan: most of its time
// on the main path, PERF.md), then the pairs' shared adds, and on the hot
// slots (is_match, the literal trees' top nodes, is_rep) their
// contention.
//
// K7, four grids, one call; a block of grids 1 and 4 takes a tile of
// kTile tokens of one lane, kRounds rounds of one token a thread:
//   1. tile_sums: each token's bit count and long flag from the closed
//      forms (only the planes they read), summed over the tile;
//   2. lane_scan: each lane's tile sums, exclusive (a block a lane); the
//      lane's total and long count, and the status bits;
//   3. fill: [total, max_bits) of each lane, a block a kFillChunk-slot
//      chunk, consecutive threads on consecutive 16-byte words;
//   4. emit: each round's counts scanned across the block, each token's
//      pairs put into a shared-memory stage at its scanned offset (kStage
//      pairs at a time), and the stage written out by consecutive threads
//      to consecutive 16-byte words of the rows; a tile with no pairs
//      (past its lane's last valid token) ends at once.
// K8, two grids, one call:
//   1. count: a block a tile of kTile tokens of one lane, as K7's (a
//      tile with no valid token ends at once); each of its kRounds
//      rounds' counted pairs (the direct bits left out) scanned across
//      the block, each token's pairs packed (slot << 1 | bit) into a
//      shared-memory stage at its scanned offset (kStage at a time),
//      then the whole block walks the stage stride 1, converged, adding
//      each pair into the tile's histogram -- in shared memory, one
//      32-bit word a slot, (count << 16) | ones, where S words fit beside
//      the stage in the block's opt-in shared memory, else straight into
//      n and n1 in device memory -- a pair at a time (a warp's equal
//      slots summed first was slower); a shared histogram's nonzero
//      slots are added into n and n1 at the tile's end; each tile's bit
//      and long counts into its lane's sums;
//   2. count_finish: the lanes' totals and the status bits.
// Blocks run lanes fastest, so a tile's neighbours in the other lanes
// run beside it: the classify finish's transposed planes (a lane's
// tokens N elements apart) are read through the same L2 sectors.  Every
// input plane is read through its own element strides, in place.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "lower_token.cuh"

namespace {

using lower_token::Geo;
using lower_token::Layout;
using lower_token::Token;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;   // tokens of a lane a K7 block
constexpr int kStage = 4096;                // pairs a K7 block stages at once
constexpr int kFillChunk = kThreads * 64;   // slots a K7 fill block
constexpr int kCountBlocks = 4;             // K8 count blocks an SM holds
constexpr int kPlanes = 10;                 // int64 planes, then valid

// kind, rep_idx, state, match_mode, match_byte, prev_byte, lit_byte (the
// meta), then t_pos, t_len, t_dist: (n_lanes, n_tok) int64 at
// p + lane * s0 + t * s1; valid bytes 0/1 likewise.
struct Planes {
  const long long* p[kPlanes];
  long long s0[kPlanes], s1[kPlanes];
  const uint8_t* valid;
  long long v0, v1;
};

__device__ __forceinline__ long long at(const Planes& in, int i, int lane,
                                        long long t) {
  return __ldg(in.p[i] + lane * in.s0[i] + t * in.s1[i]);
}

__device__ __forceinline__ bool valid_at(const Planes& in, int lane,
                                         long long t, int n_tok) {
  return t < n_tok && __ldg(in.valid + lane * in.v0 + t * in.v1) != 0;
}

__device__ __forceinline__ Token load(const Planes& in, int lane, long long t,
                                      long long pos_base) {
  Token k;
  k.kind = static_cast<int>(at(in, 0, lane, t));
  k.rep_idx = static_cast<int>(at(in, 1, lane, t));
  k.state = static_cast<int>(at(in, 2, lane, t));
  k.match_mode = static_cast<int>(at(in, 3, lane, t));
  k.match_byte = static_cast<int>(at(in, 4, lane, t));
  k.prev_byte = static_cast<int>(at(in, 5, lane, t));
  k.lit_byte = static_cast<int>(at(in, 6, lane, t));
  k.coded_pos = static_cast<int>(at(in, 7, lane, t) - pos_base);
  k.len = static_cast<int>(at(in, 8, lane, t));
  k.dist = static_cast<int>(at(in, 9, lane, t));
  return k;
}

// The planes lower_token::geometry reads (kind, rep_idx, len, dist); the
// rest stay 0.
__device__ __forceinline__ Token load_geo(const Planes& in, int lane,
                                          long long t) {
  Token k{};
  k.kind = static_cast<int>(at(in, 0, lane, t));
  k.rep_idx = static_cast<int>(at(in, 1, lane, t));
  k.len = static_cast<int>(at(in, 8, lane, t));
  k.dist = static_cast<int>(at(in, 9, lane, t));
  return k;
}

// Exclusive scan of x over the block's threads in thread order; *total
// gets the block's sum.  `ws` holds kWarps entries.
template <class T>
__device__ T block_excl_scan(T x, T* ws, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? ws[lane] : T(0);
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const T y = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) ws[lane] = w;
  }
  __syncthreads();
  const T before = warp > 0 ? ws[warp - 1] : T(0);
  *total = ws[kWarps - 1];
  __syncthreads();  // ws is free again for the next scan
  return before + incl - x;
}

// ------------------------------------------------------------- K7 grid 1
__global__ void __launch_bounds__(kThreads)
    tile_sums_kernel(Planes in, int n_lanes, int n_tok, int n_tiles,
                     long long* __restrict__ tile_bits,
                     int* __restrict__ tile_long) {
  __shared__ int ws[kWarps];
  const int lane = static_cast<int>(blockIdx.x % n_lanes);
  const int tile = static_cast<int>(blockIdx.x / n_lanes);
  int bits = 0, longs = 0;
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int t = tile * kTile + r * kThreads + threadIdx.x;
    if (valid_at(in, lane, t, n_tok)) {
      const Geo g = lower_token::geometry(load_geo(in, lane, t));
      bits += g.nbits;
      longs += lower_token::is_long(g) ? 1 : 0;
    }
  }
  int sum_bits, sum_long;
  block_excl_scan(bits, ws, &sum_bits);
  block_excl_scan(longs, ws, &sum_long);
  if (threadIdx.x == 0) {
    tile_bits[static_cast<long long>(lane) * n_tiles + tile] = sum_bits;
    tile_long[static_cast<long long>(lane) * n_tiles + tile] = sum_long;
  }
}

// ------------------------------------------------------------- K7 grid 2
// Each lane's tile sums replaced by their exclusive prefix; the lane's
// total (int64 and the int32 output) and the status bits: 1 a total past
// max_bits, 2 more long tokens than long_cap.
__global__ void __launch_bounds__(kThreads)
    lane_scan_kernel(long long* __restrict__ tile_bits,
                     const int* __restrict__ tile_long, int n_tiles,
                     long long max_bits, long long long_cap,
                     long long* __restrict__ lane_total,
                     int* __restrict__ total_out, int* __restrict__ status) {
  __shared__ long long ws[kWarps];
  const int lane = blockIdx.x;
  long long* s = tile_bits + static_cast<long long>(lane) * n_tiles;
  const int* l = tile_long + static_cast<long long>(lane) * n_tiles;
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int begin = min(static_cast<int>(threadIdx.x) * per, n_tiles);
  const int end = min(begin + per, n_tiles);
  long long agg = 0, longs = 0;
  for (int i = begin; i < end; ++i) {
    agg += s[i];
    longs += l[i];
  }
  long long total, n_long;
  long long pre = block_excl_scan(agg, ws, &total);
  block_excl_scan(longs, ws, &n_long);
  for (int i = begin; i < end; ++i) {
    const long long here = s[i];
    s[i] = pre;
    pre += here;
  }
  if (threadIdx.x == 0) {
    lane_total[lane] = total;
    total_out[lane] = static_cast<int>(total);
    if (total > max_bits) atomicOr(status, 1);
    if (n_long > long_cap) atomicOr(status, 2);
  }
}

// ---------------------------------------------------------- K7 grids 3-4
// The block writes n pairs at element `off` of the rows c_row and b_row
// (16-byte aligned alike): the stage's s_ctx[0, n) and s_bit[0, n), or
// where s_ctx is null the fill (kCtxDirect, 0).  Consecutive threads
// write consecutive 16-byte words; the elements before the first aligned
// word and after the last, an element a thread.
__device__ void store_run(int* c_row, int* b_row, long long off, long long n,
                          const int* s_ctx, const int* s_bit) {
  constexpr int kFillCtx = lower_token::kCtxDirect;
  int* c = c_row + off;
  int* b = b_row + off;
  const long long head =
      min(n, static_cast<long long>(
                 (0 - (reinterpret_cast<uintptr_t>(c) >> 2)) & 3u));
  const long long n4 = (n - head) >> 2;
  const long long tail = head + 4 * n4;  // at most 3 elements past it
  auto one = [&](long long i) {
    c[i] = s_ctx ? s_ctx[i] : kFillCtx;
    b[i] = s_ctx ? s_bit[i] : 0;
  };
  if (threadIdx.x < head) one(threadIdx.x);
  if (tail + threadIdx.x < n) one(tail + threadIdx.x);
  int4* c4 = reinterpret_cast<int4*>(c + head);
  int4* b4 = reinterpret_cast<int4*>(b + head);
  for (long long w = threadIdx.x; w < n4; w += kThreads) {
    if (s_ctx) {
      const int i = static_cast<int>(head + 4 * w);
      c4[w] = make_int4(s_ctx[i], s_ctx[i + 1], s_ctx[i + 2], s_ctx[i + 3]);
      b4[w] = make_int4(s_bit[i], s_bit[i + 1], s_bit[i + 2], s_bit[i + 3]);
    } else {
      c4[w] = make_int4(kFillCtx, kFillCtx, kFillCtx, kFillCtx);
      b4[w] = make_int4(0, 0, 0, 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fill_kernel(int n_chunks, long long max_bits,
                const long long* __restrict__ lane_total,
                int* __restrict__ ctx, int* __restrict__ bits) {
  const int lane = static_cast<int>(blockIdx.x / n_chunks);
  const long long chunk = blockIdx.x % n_chunks;
  const long long total = lane_total[lane];
  const long long start = max(chunk * kFillChunk, total);
  const long long end = min((chunk + 1) * kFillChunk, max_bits);
  if (total > max_bits || start >= end) return;
  store_run(ctx + static_cast<long long>(lane) * max_bits,
            bits + static_cast<long long>(lane) * max_bits, start,
            end - start, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(Planes in, Layout L, long long pos_base, int n_lanes,
                int n_tok, int n_tiles, long long max_bits,
                const long long* __restrict__ tile_off,
                const long long* __restrict__ lane_total,
                int* __restrict__ ctx, int* __restrict__ bits) {
  __shared__ int ws[kWarps];
  __shared__ __align__(16) int s_ctx[kStage];
  __shared__ __align__(16) int s_bit[kStage];
  const int lane = static_cast<int>(blockIdx.x % n_lanes);
  const int tile = static_cast<int>(blockIdx.x / n_lanes);
  const long long total = lane_total[lane];
  if (total > max_bits) return;  // the whole block: it raises
  const long long* offs = tile_off + static_cast<long long>(lane) * n_tiles;
  long long base = offs[tile];
  if ((tile + 1 < n_tiles ? offs[tile + 1] : total) == base) return;
  int* c_row = ctx + static_cast<long long>(lane) * max_bits;
  int* b_row = bits + static_cast<long long>(lane) * max_bits;
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int t = tile * kTile + r * kThreads + threadIdx.x;
    const bool v = valid_at(in, lane, t, n_tok);
    Token k{};
    Geo g{};
    if (v) {
      k = load(in, lane, t, pos_base);
      g = lower_token::geometry(k);
    }
    int round_bits;
    const int ex = block_excl_scan(v ? g.nbits : 0, ws, &round_bits);
    // the round's pairs [lo, lo + kStage) at a time (most rounds: once)
#pragma unroll 1
    for (int lo = 0; lo < round_bits; lo += kStage) {
      if (v && ex < lo + kStage && ex + g.nbits > lo) {
        lower_token::emit(k, g, L, [&](int j, int c, int b) {
          const int i = ex + j - lo;
          if (i >= 0 && i < kStage) {
            s_ctx[i] = c;
            s_bit[i] = b;
          }
        });
      }
      __syncthreads();
      store_run(c_row, b_row, base + lo, min(kStage, round_bits - lo), s_ctx,
                s_bit);
      __syncthreads();
    }
    base += round_bits;
  }
}

// ------------------------------------------------------------- K8 grid 1
// A K8 histogram: one tile's S slots in shared memory, a 32-bit word a
// slot, (count << 16) | ones (a tile's pairs, at most kTile * kMaxB, fit
// 16 bits); or its lane's rows of n and n1 themselves.
static_assert(kTile * lower_token::kMaxB < (1 << 16),
              "a tile's pairs of one slot fit a 16-bit count");
template <bool kShared>
struct Hist {
  unsigned* words;
  int* n;
  int* n1;

  __device__ __forceinline__ void add(int s, unsigned cnt,
                                      unsigned ones) const {
    if constexpr (kShared) {
      atomicAdd(words + s, (cnt << 16) | ones);
    } else {
      atomicAdd(n + s, static_cast<int>(cnt));
      if (ones) atomicAdd(n1 + s, static_cast<int>(ones));
    }
  }
};

// A staged pair (its word w) into the histogram, an add a pair (a warp's
// equal slots summed first, __match_any_sync, was slower once the walk is
// converged: PERF.md, bench/kernel_split.py k8_warp_sum).
template <bool kShared>
__device__ __forceinline__ void count_pair(const Hist<kShared>& h, uint32_t w) {
  h.add(lower_token::pair_slot(w), 1, lower_token::pair_bit(w));
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kCountBlocks)
    count_kernel(Planes in, Layout L, long long pos_base, int n_lanes,
                 int n_tok, int S, unsigned long long* __restrict__ lane_sums,
                 int* __restrict__ n_out, int* __restrict__ n1_out) {
  extern __shared__ __align__(16) unsigned words[];
  __shared__ long long ws[kWarps];
  __shared__ int wsi[kWarps];
  __shared__ uint32_t stage[kStage];
  const int lane = static_cast<int>(blockIdx.x % n_lanes);
  const long long t0 = static_cast<long long>(blockIdx.x / n_lanes) * kTile;
  unsigned live = 0;  // bit r: this thread's token of round r is valid
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (valid_at(in, lane, t0 + r * kThreads + threadIdx.x, n_tok)) {
      live |= 1u << r;
    }
  }
  if (!__syncthreads_or(live != 0)) return;  // no valid token: no pair
  const Hist<kShared> h{words, n_out + static_cast<long long>(lane) * S,
                        n1_out + static_cast<long long>(lane) * S};
  if constexpr (kShared) {
    for (int s = threadIdx.x; s < S; s += kThreads) words[s] = 0;
    __syncthreads();
  }
  long long n_bits = 0, n_long = 0;
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const bool v = live >> r & 1u;
    Token k{};
    Geo g{};
    if (v) {
      k = load(in, lane, t0 + r * kThreads + threadIdx.x, pos_base);
      g = lower_token::geometry(k);
      n_bits += g.nbits;
      n_long += lower_token::is_long(g) ? 1 : 0;
    }
    const int mine = v ? lower_token::counted(g) : 0;
    int round_pairs;
    const int ex = block_excl_scan(mine, wsi, &round_pairs);
    // the round's counted pairs kStage at a time (most rounds: once):
    // staged at their scanned offsets, then walked by the whole block
#pragma unroll 1
    for (int lo = 0; lo < round_pairs; lo += kStage) {
      if (mine && ex < lo + kStage && ex + mine > lo) {
        lower_token::stage_counted(k, g, L, ex, lo, kStage, stage);
      }
      __syncthreads();
      const int n_staged = min(kStage, round_pairs - lo);
      for (int i = threadIdx.x; i < n_staged; i += kThreads) {
        count_pair(h, stage[i]);
      }
      __syncthreads();
    }
  }
  long long sum_bits, sum_long;
  block_excl_scan(n_bits, ws, &sum_bits);  // its syncs end the adds too
  block_excl_scan(n_long, ws, &sum_long);
  if (threadIdx.x == 0) {
    atomicAdd(lane_sums + 2 * lane, static_cast<unsigned long long>(sum_bits));
    atomicAdd(lane_sums + 2 * lane + 1,
              static_cast<unsigned long long>(sum_long));
  }
  if constexpr (kShared) {
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const unsigned w = words[s];
      if (w >> 16) {
        atomicAdd(h.n + s, static_cast<int>(w >> 16));
        const int ones = static_cast<int>(w & 0xFFFFu);
        if (ones) atomicAdd(h.n1 + s, ones);
      }
    }
  }
}

// ------------------------------------------------------------- K8 grid 2
__global__ void __launch_bounds__(kThreads)
    count_finish_kernel(const unsigned long long* __restrict__ lane_sums,
                        int n_lanes, long long max_bits, long long long_cap,
                        int* __restrict__ total_out, int* __restrict__ status) {
  for (int lane = blockIdx.x * kThreads + threadIdx.x; lane < n_lanes;
       lane += gridDim.x * kThreads) {
    const long long total = static_cast<long long>(lane_sums[2 * lane]);
    total_out[lane] = static_cast<int>(total);
    if (total > max_bits) atomicOr(status, 1);
    if (static_cast<long long>(lane_sums[2 * lane + 1]) > long_cap) {
      atomicOr(status, 2);
    }
  }
}

// Scratch: the status word (16 bytes), the tiles' bit sums and offsets
// (int64), the lanes' totals (int64), the tiles' long counts (int32).
struct Scratch {
  int* status;
  long long* tile_bits;
  long long* lane_total;
  int* tile_long;
};

long long scratch_layout(int n_lanes, int n_tiles, void* base, Scratch* out) {
  const long long n_tile = static_cast<long long>(n_lanes) * n_tiles;
  char* p = static_cast<char*>(base);
  if (out) {
    out->status = reinterpret_cast<int*>(p);
    out->tile_bits = reinterpret_cast<long long*>(p + 16);
    out->lane_total = reinterpret_cast<long long*>(p + 16 + 8 * n_tile);
    out->tile_long =
        reinterpret_cast<int*>(p + 16 + 8 * n_tile + 8LL * n_lanes);
  }
  return 16 + 12 * n_tile + 8LL * n_lanes;
}

int tiles_of(int n_tok) { return (n_tok + kTile - 1) / kTile; }

Planes planes_of(const void* const* planes, const long long* strides) {
  Planes in;
  for (int i = 0; i < kPlanes; ++i) {
    in.p[i] = static_cast<const long long*>(planes[i]);
    in.s0[i] = strides[2 * i];
    in.s1[i] = strides[2 * i + 1];
  }
  in.valid = static_cast<const uint8_t*>(planes[kPlanes]);
  in.v0 = strides[2 * kPlanes];
  in.v1 = strides[2 * kPlanes + 1];
  return in;
}

Layout layout_of(const int* layout) {
  Layout L;
  static_assert(sizeof(Layout) == lower_token::kLayoutInts * sizeof(int),
                "Layout is kLayoutInts ints");
  std::memcpy(&L, layout, sizeof(Layout));
  return L;
}

}  // namespace

// Bytes of the scratch lzt_lower takes for (n_lanes, n_tok) tokens; the
// status word is its first 4 bytes.
extern "C" long long lzt_lower_scratch(int n_lanes, int n_tok) {
  if (n_lanes <= 0 || n_tok <= 0) return 16;
  return scratch_layout(n_lanes, tiles_of(n_tok), nullptr, nullptr);
}

// planes: kPlanes device pointers to int64 (n_lanes, n_tok) planes, then
// valid's (bytes 0/1); strides: their element strides (s0, s1), 2 a
// plane, valid's last; layout: lower_token::kLayoutInts ints; scratch:
// lzt_lower_scratch bytes, 16-byte aligned; ctx, bits: (n_lanes,
// max_bits) int32, 16-byte aligned; total: (n_lanes,) int32.  Returns the
// first CUDA error of the launches (0 on success); the status word says
// whether the lowering fits (0) or which check failed (bits 1, 2).
extern "C" int lzt_lower(const void* const* planes, const long long* strides,
                         const int* layout, long long pos_base, int n_lanes,
                         int n_tok, long long max_bits, void* scratch,
                         int* ctx, int* bits, int* total, void* stream) {
  if (n_lanes <= 0 || n_tok <= 0 || max_bits < 0 ||
      (reinterpret_cast<uintptr_t>(ctx) | reinterpret_cast<uintptr_t>(bits)) &
          15u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes in = planes_of(planes, strides);
  const Layout L = layout_of(layout);
  const int n_tiles = tiles_of(n_tok);
  Scratch w;
  scratch_layout(n_lanes, n_tiles, scratch, &w);
  const long long blocks = static_cast<long long>(n_tiles) * n_lanes;
  const long long n_chunks = (max_bits + kFillChunk - 1) / kFillChunk;
  if (blocks > INT_MAX || n_chunks * n_lanes > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(w.status, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sums_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      in, n_lanes, n_tok, n_tiles, w.tile_bits, w.tile_long);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_scan_kernel<<<n_lanes, kThreads, 0, s>>>(
      w.tile_bits, w.tile_long, n_tiles, max_bits, n_tok / 2 + 2,
      w.lane_total, total, w.status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks > 0) {
    fill_kernel<<<static_cast<int>(n_chunks * n_lanes), kThreads, 0, s>>>(
        static_cast<int>(n_chunks), max_bits, w.lane_total, ctx, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  emit_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      in, L, pos_base, n_lanes, n_tok, n_tiles, max_bits, w.tile_bits,
      w.lane_total, ctx, bits);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the scratch lzt_lower_counts takes for n_lanes lanes: the
// status word (16 bytes), then each lane's bit and long sums (uint64).
extern "C" long long lzt_lower_counts_scratch(int n_lanes) {
  return 16 + 16LL * (n_lanes > 0 ? n_lanes : 0);
}

// planes, strides, layout, pos_base, n_tok, max_bits: as lzt_lower's;
// arena_size: S, the slots a lane; smem_bytes: 0 to count in device
// memory, else the shared bytes of a block's histogram (4 S rounded up to
// 16: ops/cuda_lower.py count_smem_bytes); scratch:
// lzt_lower_counts_scratch bytes, 16-byte aligned; n, n1: (n_lanes, S)
// int32; total: (n_lanes,) int32.  Returns the first CUDA error (0 on
// success); the status word as lzt_lower's.
extern "C" int lzt_lower_counts(const void* const* planes,
                                const long long* strides, const int* layout,
                                long long pos_base, int n_lanes, int n_tok,
                                long long max_bits, int arena_size,
                                int smem_bytes, void* scratch, int* n, int* n1,
                                int* total, void* stream) {
  const bool shared = smem_bytes > 0;
  if (n_lanes <= 0 || n_tok <= 0 || max_bits < 0 || arena_size <= 0 ||
      (shared && smem_bytes != (4 * arena_size + 15) / 16 * 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes in = planes_of(planes, strides);
  const Layout L = layout_of(layout);
  int* status = static_cast<int*>(scratch);
  auto* lane_sums = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + 16);
  const size_t out_bytes = sizeof(int) * static_cast<size_t>(n_lanes) *
                           static_cast<size_t>(arena_size);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(lzt_lower_counts_scratch(n_lanes)), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(n, 0, out_bytes, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(n1, 0, out_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(tiles_of(n_tok)) * n_lanes;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (shared) {
    err = cudaFuncSetAttribute(count_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    count_kernel<true><<<static_cast<int>(blocks), kThreads, smem_bytes, s>>>(
        in, L, pos_base, n_lanes, n_tok, arena_size, lane_sums, n, n1);
  } else {
    count_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        in, L, pos_base, n_lanes, n_tok, arena_size, lane_sums, n, n1);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int finish_blocks = (n_lanes + kThreads - 1) / kThreads;
  count_finish_kernel<<<finish_blocks, kThreads, 0, s>>>(
      lane_sums, n_lanes, max_bits, n_tok / 2 + 2, total, status);
  return static_cast<int>(cudaGetLastError());
}
