// The optimal rounds' rep0 trace (K20): rep0 in effect at every position
// of every lane, from the round's token stream.
//
// Replaces lzma_tpu/ops/device_parser.py rep0_trace (:1458), jitted JAX
// device code under jax.jit at device_parser.py:1595 (no pallas_call),
// whose plain version lzma_tpu_torch/ops/device_parser.py rep0_trace is
// two (L, N + 1) int64 scatters, a cummax and a gather: r0pos[p] is the
// distance of the last valid match token whose t_pos, clamped to N - 1,
// is at most p, and 0 before the first.
//
// What bounds it on this card: the bytes -- t_pos and t_dist (int64) and
// t_valid read a token slot (17 B), r0pos written a position (8 B); the
// kernel reads an invalid slot's valid byte alone.  The
// design fills from the token side (rep0.cuh): where a lane's valid
// tokens lie at strictly ascending t_pos >= 0, as K14's compactions give
// them, the positions from one valid token's clamped place to the next
// one's hold the rep0 after the first, so no position is scattered to and
// read back.  Three grids, one call:
//   1. tiles: a block a tile of kTile token slots of a lane, staged in
//      shared memory; each thread's run of kPer slots summed (rep0::Agg),
//      the runs joined across the block in order (a warp by shuffles, then
//      the warps' totals); the tile's Agg;
//   2. lanes: each lane's tile Aggs' exclusive prefixes (a block a lane);
//   3. fill: a tile with no valid token ends at once (the lane's last
//      writes the tail past the last valid token's place); any other
//      again staged, its runs' prefixes from the tile's and a block scan,
//      each slot's place and rep0 after it in shared memory; then the
//      block writes the positions from the prefix's place to the tile's
//      last place, each by a binary search of the slots' places
//      (coalesced 8-byte stores), and the lane's last tile its tail to N.
// A valid t_pos below 0 or not above the one before it sets the status
// word (the wrapper raises the plain precondition's ValueError).

#include <cstdint>
#include <cuda_runtime.h>

#include "rep0.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                   // token slots a thread sums
constexpr int kTile = kThreads * kPer;    // token slots a block

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ rep0::Agg shfl_up(const rep0::Agg& a, int d) {
  rep0::Agg o;
  o.first = __shfl_up_sync(0xFFFFFFFFu, a.first, d);
  o.last = __shfl_up_sync(0xFFFFFFFFu, a.last, d);
  o.mpos = __shfl_up_sync(0xFFFFFFFFu, a.mpos, d);
  o.mdist = __shfl_up_sync(0xFFFFFFFFu, a.mdist, d);
  o.bad = __shfl_up_sync(0xFFFFFFFFu, a.bad, d);
  return o;
}

// An ordered scan of x over the block's threads: each thread's exclusive
// and inclusive prefix and the block's total.  A warp scans by shuffles;
// the warps' totals (tot: kWarps entries) are joined in order.  Called
// once a kernel (tot is not reused).
struct Scan {
  rep0::Agg excl, incl, total;
};

__device__ Scan block_scan(rep0::Agg x, rep0::Agg* tot) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const rep0::Agg y = shfl_up(x, d);
    if (lane >= d) x = rep0::join(y, x);
  }
  const rep0::Agg ex = shfl_up(x, 1);
  if (lane == 31) tot[w] = x;
  __syncthreads();
  Scan s;
  rep0::Agg pre = rep0::empty();
  for (int i = 0; i < kWarps; ++i) {
    if (i == w) {
      s.excl = lane == 0 ? pre : rep0::join(pre, ex);
      s.incl = rep0::join(pre, x);
    }
    pre = rep0::join(pre, tot[i]);
  }
  s.total = pre;
  return s;
}

struct Tokens {
  const long long* pos;
  const long long* dist;
  const uint8_t* valid;
  long long pr, pl, dr, dl, vr, vl;  // strides (slot, lane), elements
};

// The tile's token slots into shared memory (invalid past n_tok).  An
// invalid slot's position and distance are never read: push() skips it,
// and a warp of invalid slots (a lane's tail past its last token) reads
// its valid bytes alone.
__device__ __forceinline__ void stage(const Tokens& tk, int lane, long long t0,
                                      int n_tok, long long* sp, long long* sd,
                                      uint8_t* sv) {
  for (int f = threadIdx.x; f < kTile; f += kThreads) {
    const long long j = t0 + f;
    uint8_t v = 0;
    long long p = 0, d = -1;
    if (j < n_tok) v = __ldg(tk.valid + j * tk.vr + lane * tk.vl) ? 1 : 0;
    if (v) {
      p = __ldg(tk.pos + j * tk.pr + lane * tk.pl);
      d = __ldg(tk.dist + j * tk.dr + lane * tk.dl);
    }
    sp[f] = p;
    sd[f] = d;
    sv[f] = v;
  }
  __syncthreads();
}

// This thread's run of kPer slots, after `a`.
__device__ __forceinline__ rep0::Agg run(rep0::Agg a, const long long* sp,
                                         const long long* sd,
                                         const uint8_t* sv) {
  const int f0 = threadIdx.x * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    a = rep0::push(a, sp[f0 + i], sd[f0 + i], sv[f0 + i] != 0);
  }
  return a;
}

// ---------------------------------------------------------------- grid 1
__global__ void __launch_bounds__(kThreads)
    tiles_kernel(Tokens tk, int n_tok, int n_tiles, rep0::Agg* tile_agg) {
  __shared__ long long sp[kTile];
  __shared__ long long sd[kTile];
  __shared__ uint8_t sv[kTile];
  __shared__ rep0::Agg tot[kWarps];
  const int lane = blockIdx.x / n_tiles;
  const int k = blockIdx.x - lane * n_tiles;
  stage(tk, lane, static_cast<long long>(k) * kTile, n_tok, sp, sd, sv);
  const Scan sc = block_scan(run(rep0::empty(), sp, sd, sv), tot);
  if (threadIdx.x == 0) {
    tile_agg[static_cast<long long>(lane) * n_tiles + k] = sc.total;
  }
}

// ---------------------------------------------------------------- grid 2
// Each lane's tile Aggs' exclusive prefixes into tile_pre; a block a lane.
__global__ void __launch_bounds__(kThreads)
    lanes_kernel(const rep0::Agg* __restrict__ tile_agg,
                 rep0::Agg* __restrict__ tile_pre, int n_tiles) {
  __shared__ rep0::Agg tot[kWarps];
  const long long at = static_cast<long long>(blockIdx.x) * n_tiles;
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int begin = min(static_cast<int>(threadIdx.x) * per, n_tiles);
  const int end = min(begin + per, n_tiles);
  rep0::Agg agg = rep0::empty();
  for (int i = begin; i < end; ++i) agg = rep0::join(agg, tile_agg[at + i]);
  rep0::Agg pre = block_scan(agg, tot).excl;
  for (int i = begin; i < end; ++i) {
    tile_pre[at + i] = pre;
    pre = rep0::join(pre, tile_agg[at + i]);
  }
}

// ---------------------------------------------------------------- grid 3
__global__ void __launch_bounds__(kThreads)
    fill_kernel(Tokens tk, int n_tok, int n_tiles, long long n_pos,
                const rep0::Agg* __restrict__ tile_agg,
                const rep0::Agg* __restrict__ tile_pre, int* status,
                long long* __restrict__ r0pos) {
  __shared__ long long sp[kTile];  // t_pos, then each slot's rep0 after it
  __shared__ long long sd[kTile];  // t_dist, then each slot's place
  __shared__ uint8_t sv[kTile];
  __shared__ rep0::Agg tot[kWarps];
  const int lane = blockIdx.x / n_tiles;
  const int k = blockIdx.x - lane * n_tiles;
  const long long at = static_cast<long long>(lane) * n_tiles + k;
  const rep0::Agg pre = tile_pre[at];
  long long* out = r0pos + static_cast<long long>(lane) * n_pos;
  if (tile_agg[at].first == rep0::kNone) {
    // no valid token: no position of its own; the lane's last tile
    // writes the tail from the last valid token's place
    if (k == n_tiles - 1) {
      const long long v = rep0::value(pre);
      for (long long p = rep0::place(pre, n_pos) + threadIdx.x; p < n_pos;
           p += kThreads) {
        out[p] = v;
      }
    }
    return;
  }
  stage(tk, lane, static_cast<long long>(k) * kTile, n_tok, sp, sd, sv);
  const Scan sc = block_scan(run(rep0::empty(), sp, sd, sv), tot);
  rep0::Agg a = rep0::join(pre, sc.excl);
  const int f0 = threadIdx.x * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    a = rep0::push(a, sp[f0 + i], sd[f0 + i], sv[f0 + i] != 0);
    sp[f0 + i] = rep0::value(a);
    sd[f0 + i] = rep0::place(a, n_pos);
  }
  const rep0::Agg end = rep0::join(pre, sc.total);
  if (threadIdx.x == 0 && end.bad) atomicOr(status, 1);
  __syncthreads();
  const long long p0 = rep0::place(pre, n_pos);
  const long long p1 = rep0::place(end, n_pos);
  const long long v0 = rep0::value(pre);
  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
    // the last slot whose place is at most p (places ascend)
    int lo = -1, hi = kTile - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (sd[mid] <= p) lo = mid; else hi = mid - 1;
    }
    out[p] = lo < 0 ? v0 : sp[lo];
  }
  if (k == n_tiles - 1) {
    const long long v1 = rep0::value(end);
    for (long long p = p1 + threadIdx.x; p < n_pos; p += kThreads) out[p] = v1;
  }
}

}  // namespace

// Bytes of the scratch lzt_rep0_trace takes for n_lanes lanes of n_tok
// token slots: the status word, then the tiles' Aggs and their prefixes.
extern "C" long long lzt_rep0_scratch(int n_lanes, int n_tok) {
  const long long n_tiles = (static_cast<long long>(n_tok) + kTile - 1) / kTile;
  return 16 + 2 * static_cast<long long>(sizeof(rep0::Agg)) * n_lanes * n_tiles;
}

// pos, dist: int64 and valid: bytes 0/1, (n_lanes, n_tok) through
// strides[6] (elements: pos's slot and lane strides, then dist's,
// valid's); scratch: lzt_rep0_scratch bytes, 16-byte aligned (its first
// int is the status word, nonzero where the order broke); r0pos:
// (n_lanes, n_pos) int64, contiguous.  Returns the first CUDA error of
// the launches (0 on success).
extern "C" int lzt_rep0_trace(const long long* pos, const long long* dist,
                              const uint8_t* valid, const long long* strides,
                              int n_lanes, int n_tok, long long n_pos,
                              void* scratch, long long* r0pos, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lanes <= 0 || n_pos <= 0) return 0;
  int* status = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tok <= 0) {
    return static_cast<int>(cudaMemsetAsync(
        r0pos, 0, sizeof(long long) * n_lanes * n_pos, s));
  }
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(n_lanes) * n_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  rep0::Agg* agg = reinterpret_cast<rep0::Agg*>(static_cast<char*>(scratch) + 16);
  rep0::Agg* pre = agg + blocks;
  const Tokens tk{pos, dist, valid, strides[0], strides[1], strides[2],
                  strides[3], strides[4], strides[5]};
  const int nb = static_cast<int>(blocks);
  tiles_kernel<<<nb, kThreads, 0, s>>>(tk, n_tok, n_tiles, agg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lanes_kernel<<<n_lanes, kThreads, 0, s>>>(agg, pre, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_kernel<<<nb, kThreads, 0, s>>>(tk, n_tok, n_tiles, n_pos, agg, pre,
                                      status, r0pos);
  return static_cast<int>(cudaGetLastError());
}
