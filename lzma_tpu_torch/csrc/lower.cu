// The bit lowering (K7): every valid token's (ctx, bit) pairs written at
// its offset in flat per-lane streams, the rest of each stream filled.
//
// Replaces lzma_tpu/ops/device_encoder.py lower_tokens, a jax.jit
// function that XLA compiles for the device (it has no pallas_call): the
// same contract as the plain version lzma_tpu_torch/ops/device_encoder.py
// _lower_tokens_plain -- ctx and bit (n_lanes, max_bits) int32, a lane's
// pairs at [0, total) in token order, ctx CTX_DIRECT (-1) and bit 0 from
// total to max_bits, total (n_lanes,) int32.  A lane whose total passes
// max_bits, or whose tokens past the literal/shortRep slots number more
// than T / 2 + 2, sets a status bit instead (the wrapper raises the plain
// version's ValueError); such a lane's streams are not written at all.
//
// What bounds it on this card: the bytes -- the token and meta planes
// read (int64, ~80 B a token), the two int32 planes written over every
// slot (8 B a slot, ~10 slots a position) -- once each token's offset is
// known, and a token's offset is an exclusive sum of the bit counts
// before it in its lane.  Four grids, one call; a block takes a tile of
// kTile tokens of one lane, kRounds rounds of one token a thread:
//   1. tile_sums: each token's bit count and long flag from the closed
//      forms (lower_token.cuh), summed over the tile;
//   2. lane_scan: each lane's tile sums, exclusive (a block a lane); the
//      lane's total and long count, and the status bits;
//   3. emit: each token's count again, scanned across the block round by
//      round, and its pairs written at tile offset + scan, a thread a
//      token: neighbouring threads write neighbouring tokens' pairs;
//   4. fill: [total, max_bits) of each lane, a block a 4,096-slot chunk.
// Recomputing a token's geometry in grid 3 costs registers, not bytes.
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
constexpr int kTile = kThreads * kRounds;   // tokens of a lane a block
constexpr int kFillChunk = kThreads * 16;   // slots a fill block
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
                                        int t) {
  return __ldg(in.p[i] + lane * in.s0[i] + t * in.s1[i]);
}

__device__ __forceinline__ bool valid_at(const Planes& in, int lane, int t,
                                         int n_tok) {
  return t < n_tok && __ldg(in.valid + lane * in.v0 + t * in.v1) != 0;
}

__device__ __forceinline__ Token load(const Planes& in, int lane, int t,
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

// ---------------------------------------------------------------- grid 1
__global__ void __launch_bounds__(kThreads)
    tile_sums_kernel(Planes in, long long pos_base, int n_lanes, int n_tok,
                     int n_tiles, long long* __restrict__ tile_bits,
                     int* __restrict__ tile_long) {
  __shared__ int ws[kWarps];
  const int lane = static_cast<int>(blockIdx.x % n_lanes);
  const int tile = static_cast<int>(blockIdx.x / n_lanes);
  int bits = 0, longs = 0;
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int t = tile * kTile + r * kThreads + threadIdx.x;
    if (valid_at(in, lane, t, n_tok)) {
      const Geo g = lower_token::geometry(load(in, lane, t, pos_base));
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

// ---------------------------------------------------------------- grid 2
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

// ---------------------------------------------------------------- grid 3
__global__ void __launch_bounds__(kThreads)
    emit_kernel(Planes in, Layout L, long long pos_base, int n_lanes,
                int n_tok, int n_tiles, long long max_bits,
                const long long* __restrict__ tile_off,
                const long long* __restrict__ lane_total,
                int* __restrict__ ctx, int* __restrict__ bits) {
  __shared__ int ws[kWarps];
  const int lane = static_cast<int>(blockIdx.x % n_lanes);
  const int tile = static_cast<int>(blockIdx.x / n_lanes);
  if (lane_total[lane] > max_bits) return;  // the whole block: it raises
  long long base = tile_off[static_cast<long long>(lane) * n_tiles + tile];
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
    if (v) {
      const long long off = base + ex;
      lower_token::emit(k, g, L, [&](int j, int c, int b) {
        c_row[off + j] = c;
        b_row[off + j] = b;
      });
    }
    base += round_bits;
  }
}

// ---------------------------------------------------------------- grid 4
__global__ void __launch_bounds__(kThreads)
    fill_kernel(int n_lanes, long long max_bits,
                const long long* __restrict__ lane_total,
                int* __restrict__ ctx, int* __restrict__ bits) {
  const int lane = static_cast<int>(blockIdx.x % n_lanes);
  const long long chunk = blockIdx.x / n_lanes;
  const long long total = lane_total[lane];
  const long long start = chunk * kFillChunk;
  const long long end = min(start + kFillChunk, max_bits);
  if (total > max_bits || end <= total) return;
  int* c_row = ctx + static_cast<long long>(lane) * max_bits;
  int* b_row = bits + static_cast<long long>(lane) * max_bits;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    if (i >= total) {
      c_row[i] = lower_token::kCtxDirect;
      b_row[i] = 0;
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
// max_bits) int32; total: (n_lanes,) int32.  Returns the first CUDA
// error of the launches (0 on success); the status word says whether
// the lowering fits (0) or which check failed (bits 1, 2).
extern "C" int lzt_lower(const void* const* planes, const long long* strides,
                         const int* layout, long long pos_base, int n_lanes,
                         int n_tok, long long max_bits, void* scratch,
                         int* ctx, int* bits, int* total, void* stream) {
  if (n_lanes <= 0 || n_tok <= 0 || max_bits < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Planes in;
  for (int i = 0; i < kPlanes; ++i) {
    in.p[i] = static_cast<const long long*>(planes[i]);
    in.s0[i] = strides[2 * i];
    in.s1[i] = strides[2 * i + 1];
  }
  in.valid = static_cast<const uint8_t*>(planes[kPlanes]);
  in.v0 = strides[2 * kPlanes];
  in.v1 = strides[2 * kPlanes + 1];
  Layout L;
  static_assert(sizeof(Layout) == lower_token::kLayoutInts * sizeof(int),
                "Layout is kLayoutInts ints");
  std::memcpy(&L, layout, sizeof(Layout));

  const int n_tiles = tiles_of(n_tok);
  Scratch w;
  scratch_layout(n_lanes, n_tiles, scratch, &w);
  const long long blocks = static_cast<long long>(n_tiles) * n_lanes;
  const long long fill_blocks =
      (max_bits + kFillChunk - 1) / kFillChunk * n_lanes;
  if (blocks > INT_MAX || fill_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(w.status, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sums_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      in, pos_base, n_lanes, n_tok, n_tiles, w.tile_bits, w.tile_long);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_scan_kernel<<<n_lanes, kThreads, 0, s>>>(
      w.tile_bits, w.tile_long, n_tiles, max_bits, n_tok / 2 + 2,
      w.lane_total, total, w.status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      in, L, pos_base, n_lanes, n_tok, n_tiles, max_bits, w.tile_bits,
      w.lane_total, ctx, bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fill_blocks > 0) {
    fill_kernel<<<static_cast<int>(fill_blocks), kThreads, 0, s>>>(
        n_lanes, max_bits, w.lane_total, ctx, bits);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
