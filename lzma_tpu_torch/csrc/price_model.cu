// The optimal rounds' price model (K18), on the closed forms of
// price_model.cuh.
//
// K18 replaces the position-free half of the price model of the JAX
// package's optimal parse, jitted JAX device code that XLA compiles for
// the device (it has no pallas_call; under jax.jit at
// lzma_tpu/ops/device_parser.py:1595, tokenize_optimal, called at :1671
// and :1676): empirical_probs' arithmetic after its scatter-adds (:88-108:
// n0, the int32 numerator, the floor division, the clamp to 32..2016,
// 1024 for unseen slots) and build_price_model (:154-269: EP0 and EP1
// from PRICE_TABLE, the length tables, pos_slot, dfull, align, the flag
// tables and rep_sel), as _dp_tables lays out what the scans read.  The
// plain version is lzma_tpu_torch/ops/device_parser.py
// _price_model_plain.  From the slot counts n, n1 (n_lanes, S) int32 (K8,
// lower.cu) it writes, int32:
//   ep0, ep1 (n_lanes, S): each slot's price of a 0 and of a 1 (K12 reads
//       the literal coders' slots);
//   dist (n_lanes, 784): ps_price (4, 64), dfull (4, 128), align_price
//       (16), which K12 reads;
//   rows (n_lanes, T): the DP tables' row, T = 2 n_ps (fb - 1) + 48 n_ps
//       + 72, which K3 and K4 read.
//
// What bounds it on this card: nothing but its launch.  It reads n and n1
// once and writes the planes once (16 bytes a slot), and writes 4 (784 +
// T) bytes a lane: 3.9 MB on the main path's 32 lanes at lc3 (about
// 1.2 us at 3.35 TB/s).  The op chain it replaces was some 400 small
// launches a call.  What the design does: one launch of two block ranges.
//   The first n_lanes blocks take a lane each: they price the slots
//       before the lane's literal coders (at most 1,846, pb 4) straight
//       from n and n1 into shared memory, so that they wait on nothing,
//       then a thread an entry walks its bit tree there (only the fb - 1
//       length columns the row keeps), the distance tables and the row
//       written coalesced.
//   The rest walk the planes, four slots a thread from 16-byte loads of n
//       and n1 and 16-byte stores of ep0 and ep1 where the four are
//       aligned (else one slot at a time).
// Each block builds the 512-entry price table in shared memory first.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "price_model.cuh"

namespace {

using price_model::kDistEntries;
using price_model::kPriceEntries;

constexpr int kThreads = 256;
constexpr int kPlaneBlocksPerSM = 8;

struct Args {
  const int* n;      // (n_lanes, S)
  const int* n1;
  int* ep0;          // (n_lanes, S)
  int* ep1;
  int* dist;         // (n_lanes, kDistEntries)
  int* rows;         // (n_lanes, row)
  int64_t slots;     // n_lanes * S
  int64_t S;
  int n_lanes, row, W;
  bool vec;          // n, n1, ep0, ep1 16-byte aligned
  price_model::Layout y;
};

__device__ __forceinline__ void price_pair(const int* pt, int n, int n1,
                                           int* e0, int* e1) {
  const int p = price_model::prob_of(n, n1);
  *e0 = price_model::price0(pt, p);
  *e1 = price_model::price1(pt, p);
}

// A lane's tables: its slots before the literal coders priced into
// shared memory, then a thread an entry.
__device__ void lane_tables(const Args& a, int lane, const int* pt, int* e0,
                            int* e1) {
  const int64_t at = static_cast<int64_t>(lane) * a.S;
  for (int s = threadIdx.x; s < a.y.literal; s += kThreads) {
    price_pair(pt, __ldg(a.n + at + s), __ldg(a.n1 + at + s), e0 + s, e1 + s);
  }
  __syncthreads();
  const price_model::Prices e{e0, e1};
  int* dist = a.dist + static_cast<int64_t>(lane) * kDistEntries;
  for (int k = threadIdx.x; k < kDistEntries; k += kThreads) {
    dist[k] = price_model::dist_entry(e, a.y, k);
  }
  int* row = a.rows + static_cast<int64_t>(lane) * a.row;
  for (int k = threadIdx.x; k < a.row; k += kThreads) {
    row[k] = price_model::row_entry(e, a.y, a.W, k);
  }
}

// The planes, grid-stride over the flat (n_lanes * S) slots from block
// `first` of `blocks`.
__device__ void planes(const Args& a, int64_t first, int64_t blocks,
                       const int* pt) {
  const int64_t stride = blocks * kThreads;
  const int64_t t0 = first * kThreads + threadIdx.x;
  int64_t done = 0;
  if (a.vec) {
    const int64_t quads = a.slots >> 2;
    const int4* n4 = reinterpret_cast<const int4*>(a.n);
    const int4* m4 = reinterpret_cast<const int4*>(a.n1);
    int4* p4 = reinterpret_cast<int4*>(a.ep0);
    int4* q4 = reinterpret_cast<int4*>(a.ep1);
    for (int64_t v = t0; v < quads; v += stride) {
      const int4 c = __ldcs(n4 + v), o = __ldcs(m4 + v);
      int4 x, z;
      price_pair(pt, c.x, o.x, &x.x, &z.x);
      price_pair(pt, c.y, o.y, &x.y, &z.y);
      price_pair(pt, c.z, o.z, &x.z, &z.z);
      price_pair(pt, c.w, o.w, &x.w, &z.w);
      p4[v] = x;
      q4[v] = z;
    }
    done = quads << 2;
  }
  for (int64_t s = done + t0; s < a.slots; s += stride) {
    price_pair(pt, a.n[s], a.n1[s], a.ep0 + s, a.ep1 + s);
  }
}

__global__ void __launch_bounds__(kThreads) model_kernel(Args a) {
  extern __shared__ int smem[];
  int* pt = smem;
  for (int j = threadIdx.x; j < kPriceEntries; j += kThreads) {
    pt[j] = price_model::price_entry(j);
  }
  __syncthreads();
  if (static_cast<int>(blockIdx.x) < a.n_lanes) {
    lane_tables(a, blockIdx.x, pt, smem + kPriceEntries,
                smem + kPriceEntries + a.y.literal);
  } else {
    planes(a, blockIdx.x - a.n_lanes, gridDim.x - a.n_lanes, pt);
  }
}

}  // namespace

// K18.  n, n1: (n_lanes, S) int32, S = the arena of (lc, lp, pb); fb the
// scan's fast bytes (2..273).  ep0, ep1: (n_lanes, S) int32; dist:
// (n_lanes, 784) int32; rows: (n_lanes, T) int32, T =
// price_model::row_entries(pb, fb).  Returns the first CUDA error of the
// launch (0 on success).
extern "C" int lzt_price_model(const int* n, const int* n1, int n_lanes,
                               long long S, int lc, int lp, int pb, int fb,
                               int* ep0, int* ep1, int* dist, int* rows,
                               void* stream) {
  if (n_lanes <= 0 || lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 ||
      pb > 4 || fb < 2 || fb > 273) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const price_model::Layout y = price_model::make_layout(lc, lp, pb);
  if (S != y.size) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(n_lanes) * S;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = aligned(n) && aligned(n1) && aligned(ep0) && aligned(ep1);
  const int64_t per = static_cast<int64_t>(kThreads) * (vec ? 4 : 1);
  const int64_t want = (slots + per - 1) / per;
  const int64_t cap = static_cast<int64_t>(kPlaneBlocksPerSM) * sms;
  const int64_t plane_blocks = want < cap ? want : cap;
  if (n_lanes + plane_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{n, n1, ep0, ep1, dist, rows, slots, S, n_lanes,
               price_model::row_entries(pb, fb), fb - 1, vec, y};
  const size_t smem = sizeof(int) * (kPriceEntries + 2 * y.literal);
  model_kernel<<<static_cast<int>(n_lanes + plane_blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
