// The optimal parse's DP rows (K12), on the per-position closed form of
// dp_input_row.cuh.
//
// K12 replaces the per-position half of the price model of the JAX
// package's optimal parse, jitted JAX device code that XLA compiles for
// the device (it has no pallas_call; under jax.jit at
// lzma_tpu/ops/device_parser.py:1595, tokenize_optimal):
// build_price_model's lit_cost (device_parser.py:154) and, at :1500,
// matched_lit_cost; _pair_dist_cost (:272); _pack_inputs (:774); and
// device_matcher.py:684 rep_match_lens_rmq (_lcp_query, :528).  The
// plain version is lzma_tpu_torch/ops/device_parser.py _dp_inputs_plain:
// each position's int32 row of C = 6M + 5 entries, (n_lanes, n_pos, C),
// the layout K3 and K4 read through dp_rows.cuh, written once (no int64
// row and no cast on the card).  Rows past a lane's length are written
// too, as the reference writes them.
//
// What bounds it on this card: the bytes.  It writes 4C bytes a
// position (116 at M = 4) and reads ld and dd (16M), r0pos (8), the
// byte and its neighbours, and, where the rep0 source is in the block,
// the source's rank and two table entries; the literal walks read 16
// price-plane entries a position, which shared memory holds where two
// blocks still fit an SM with a lane's literal coders staged (lc + lp <=
// 3 at M = 4 on the H100: 768 << (lc + lp) slots a plane), else device
// memory (L2): at lc + lp 4 and 5 the slots fit one block an SM, which
// was slower than reading L2 (lzma_tpu_torch/bench/row_placement.py).
// What the design does:
//   a block takes kChunk positions of one lane; it stages the lane's
//   distance tables (784 int32) and, in the "shared" placement, the
//   literal coders' slots of both planes in shared memory once, then
//   runs tiles of kThreads positions, a thread a position: its row goes
//   into a shared-memory stage (stride C, odd, so the stage's banks do
//   not collide) and the block writes the tile's rows, contiguous in
//   the output, by consecutive threads on consecutive 4-byte words.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_input_row.cuh"

namespace {

using dp_input_row::kTableInts;

constexpr int kThreads = 256;            // positions a tile
constexpr int kChunk = kThreads * 32;    // positions a block

struct Args {
  const uint8_t* data;      // (n_lanes, n_pos)
  const int64_t* ld;        // (n_lanes, n_pos, m)
  const int64_t* dd;
  const int64_t* r0pos;     // (n_lanes, n_pos)
  const int64_t* rank;      // (n_lanes, n_pos)
  const int* T;             // (n_lanes, levels, n_pos)
  const int64_t* lens;      // (n_lanes,)
  const int* ep0;           // (n_lanes, S)
  const int* ep1;
  const int* tables;        // (n_lanes, kTableInts)
  int64_t S, lit_base, lit_slots, n_pos;
  int n_lanes, levels, m, lc, lp, n_chunks;
  int* out;                 // (n_lanes, n_pos, 6m + 5)
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads) rows_kernel(Args a) {
  extern __shared__ int smem[];
  const int C = 6 * a.m + 5;
  int* stage = smem;
  int* tab = stage + kThreads * C;
  int* lit = tab + kTableInts;  // the literal slots of ep0, then of ep1
  const int lane = blockIdx.x / a.n_chunks;
  const int64_t first = static_cast<int64_t>(blockIdx.x % a.n_chunks) * kChunk;
  const int64_t last = first + kChunk < a.n_pos ? first + kChunk : a.n_pos;
  const int tid = threadIdx.x;

  const int* tsrc = a.tables + static_cast<int64_t>(lane) * kTableInts;
  for (int k = tid; k < kTableInts; k += kThreads) tab[k] = tsrc[k];
  const int* e0 = a.ep0 + lane * a.S + a.lit_base;
  const int* e1 = a.ep1 + lane * a.S + a.lit_base;
  if (kShared) {
    for (int64_t k = tid; k < a.lit_slots; k += kThreads) {
      lit[k] = __ldg(e0 + k);
      lit[a.lit_slots + k] = __ldg(e1 + k);
    }
    e0 = lit;
    e1 = lit + a.lit_slots;
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(lane) * a.n_pos;
  dp_input_row::Lane ln;
  ln.data = a.data + base;
  ln.ld = a.ld + base * a.m;
  ln.dd = a.dd + base * a.m;
  ln.r0pos = a.r0pos + base;
  ln.ep0 = e0;
  ln.ep1 = e1;
  ln.tables = tab;
  ln.sfx = search_list::Lane{};
  ln.sfx.rank = a.rank + base;
  ln.sfx.T = a.T + base * a.levels;
  ln.sfx.max_n = a.n_pos;
  ln.n_pos = a.n_pos;
  ln.len = a.lens[lane];
  ln.m = a.m;
  ln.lc = a.lc;
  ln.lp = a.lp;

  for (int64_t p0 = first; p0 < last; p0 += kThreads) {
    const int rows = last - p0 < kThreads ? static_cast<int>(last - p0)
                                          : kThreads;
    if (tid < rows) dp_input_row::row(ln, p0 + tid, stage + tid * C);
    __syncthreads();
    int* dst = a.out + (base + p0) * C;
    for (int k = tid; k < rows * C; k += kThreads) dst[k] = stage[k];
    __syncthreads();
  }
}

}  // namespace

// Shared bytes of a K12 block: the row stage (kThreads rows of 6m + 5
// int32), the distance tables and, in the "shared" placement, both
// planes' literal slots.
extern "C" long long lzt_dp_inputs_smem(int m, long long lit_slots,
                                        int shared) {
  return 4LL * (kThreads * (6LL * m + 5) + kTableInts +
                (shared ? 2 * lit_slots : 0));
}

// K12.  data (n_lanes, n_pos) uint8; ld, dd (n_lanes, n_pos, m) int64;
// r0pos, rank (n_lanes, n_pos) int64; T (n_lanes, levels, n_pos) int32;
// lens (n_lanes,) int64; ep0, ep1 (n_lanes, S) int32, the literal coders
// at [lit_base, lit_base + lit_slots); tables (n_lanes, 784) int32:
// ps_price, dfull, align_price; lc, lp; shared: 1 to stage the literal
// slots in shared memory (lzt_dp_inputs_smem(m, lit_slots, 1) within
// the card's opt-in limit); out (n_lanes, n_pos, 6m + 5) int32.
// Returns the first CUDA error of the launch (0 on success).
extern "C" int lzt_dp_inputs(const uint8_t* data, const int64_t* ld,
                             const int64_t* dd, const int64_t* r0pos,
                             const int64_t* rank, const int* T, int levels,
                             const int64_t* lens, const int* ep0,
                             const int* ep1, long long S, long long lit_base,
                             long long lit_slots, const int* tables,
                             int n_lanes, long long n_pos, int m, int lc,
                             int lp, int shared, int* out, void* stream) {
  const int64_t chunks = (n_pos + kChunk - 1) / kChunk;
  if (n_lanes <= 0 || n_pos <= 0 || m <= 0 || levels < 1 || lc < 0 ||
      lc > 8 || lp < 0 || lp > 4 || lit_base < 0 ||
      lit_base + lit_slots > S || chunks * n_lanes > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{data, ld, dd, r0pos, rank, T, lens, ep0, ep1, tables, S, lit_base,
         lit_slots, n_pos, n_lanes, levels, m, lc, lp,
         static_cast<int>(chunks), out};
  const long long smem = lzt_dp_inputs_smem(m, lit_slots, shared);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(chunks * n_lanes);
  cudaError_t err;
  if (shared) {
    err = cudaFuncSetAttribute(rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_kernel<true><<<blocks, kThreads, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(rows_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_kernel<false><<<blocks, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
