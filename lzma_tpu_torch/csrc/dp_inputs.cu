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
// price slots a position.  What holds it back (PERF.md, K12's split):
// replen's chain of three dependent random reads (r0pos, then the
// source's rank, then two entries of a 1 MB level plane of T), and how
// much of the rows' other reads L1 keeps, as a block's shared memory is
// carved out of the SM's L1.  What the design does:
//   a grid of kBlocksPerSM blocks an SM (32 warps to hide the chains;
//   64 registers a thread) walks the lanes' chunks of kChunk positions in
//   lane-major order, and the SM's shared memory is carved out to what
//   those blocks need (32 KB a block at M = 4), the rest left to L1.  A
//   block stages a chunk's lane's distance tables in shared memory and
//   runs tiles of kThreads positions, a thread a position, which issues
//   its row's rep0 reads before it prices the pairs and the literals.
//   The literal walks read the two int32 planes through L1 (staged in
//   shared memory, the slots were no faster).  A row goes into a shared-memory stage (stride C, odd: no bank
//   conflicts), which the block writes out as 16-byte words (the stage
//   placed so that its words align with the output's; a few 4-byte words
//   at the ends).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_input_row.cuh"

namespace {

using dp_input_row::kTableInts;

constexpr int kThreads = 256;            // positions a tile
constexpr int kChunk = kThreads * 8;     // positions a block takes at a time
constexpr int kBlocksPerSM = 4;          // blocks of the grid an SM

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
  int64_t S, lit_base, n_pos;
  int n_lanes, levels, m, lc, lp, n_chunks, n_items;
  bool pairs16;
  int* out;                 // (n_lanes, n_pos, 6m + 5)
};

// Words of a block's shared memory: the row stage (kThreads rows and 4
// words to align it), then the distance tables.
__host__ __device__ constexpr long long stage_words(int m) {
  return kThreads * (6LL * m + 5) + 4;
}

// Chunk `chunk` (kChunk positions) of lane `lane`: the lane's tables
// staged, then its tiles' rows.
__device__ __forceinline__ void rows_chunk(const Args& a, int lane, int chunk,
                                           int* smem) {
  const int C = 6 * a.m + 5;
  int* stage = smem;
  int* tab = smem + stage_words(a.m);
  const int64_t first = static_cast<int64_t>(chunk) * kChunk;
  const int64_t last = first + kChunk < a.n_pos ? first + kChunk : a.n_pos;
  const int tid = threadIdx.x;
  const int* tsrc = a.tables + static_cast<int64_t>(lane) * kTableInts;
  for (int k = tid; k < kTableInts; k += kThreads) tab[k] = __ldg(tsrc + k);
  __syncthreads();

  const int64_t base = static_cast<int64_t>(lane) * a.n_pos;
  dp_input_row::Lane ln;
  ln.data = a.data + base;
  ln.ld = a.ld + base * a.m;
  ln.dd = a.dd + base * a.m;
  ln.r0pos = a.r0pos + base;
  ln.ep0 = a.ep0 + lane * a.S + a.lit_base;
  ln.ep1 = a.ep1 + lane * a.S + a.lit_base;
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
  ln.pairs16 = a.pairs16;

  for (int64_t p0 = first; p0 < last; p0 += kThreads) {
    const int rows = last - p0 < kThreads ? static_cast<int>(last - p0)
                                          : kThreads;
    // the tile's words in the output start at g; stage word pad + k is
    // output word g + k, so a stage word is 16-byte aligned where its
    // output word is
    const int64_t g = (base + p0) * C;
    const int pad = static_cast<int>(g & 3);
    if (tid < rows) dp_input_row::row(ln, p0 + tid, stage + pad + tid * C);
    __syncthreads();
    const int words = rows * C;
    const int head = min((4 - pad) & 3, words);
    int* dst = a.out + g;
    if (tid < head) dst[tid] = stage[pad + tid];
    const int vecs = (words - head) >> 2;
    const int4* src4 = reinterpret_cast<const int4*>(stage + pad + head);
    int4* dst4 = reinterpret_cast<int4*>(dst + head);
    for (int k = tid; k < vecs; k += kThreads) dst4[k] = src4[k];
    const int done = head + 4 * vecs;
    if (tid < words - done) dst[done + tid] = stage[pad + done + tid];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) rows_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    rows_chunk(a, item / a.n_chunks, item % a.n_chunks, smem);
    __syncthreads();
  }
}

// The kernel's shared bytes a block, and an SM's shared memory carved out
// for kBlocksPerSM such blocks only: the rest of the SM's 256 KB is L1.
cudaError_t configure(long long smem) {
  const int carveout = static_cast<int>(
      (100LL * kBlocksPerSM * (smem + 1024) + 233471) / 233472);
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(rows_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              carveout < 100 ? carveout : 100);
}

}  // namespace

// Shared bytes of a K12 block for rows of m pairs: the row stage
// (kThreads rows of 6m + 5 int32 and 4 words to align it) and the
// distance tables.
extern "C" long long lzt_dp_inputs_smem(int m) {
  return 4LL * (stage_words(m) + kTableInts);
}

// Blocks of K12 an SM runs for rows of m pairs: kBlocksPerSM, or fewer
// where the runtime fits fewer (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// -1 where the runtime refuses.
extern "C" int lzt_dp_inputs_occupancy(int m) {
  const long long smem = lzt_dp_inputs_smem(m);
  int blocks = 0;
  if (configure(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, rows_kernel, kThreads, static_cast<size_t>(smem)) !=
          cudaSuccess) {
    return -1;
  }
  return blocks < kBlocksPerSM ? blocks : kBlocksPerSM;
}

// K12.  data (n_lanes, n_pos) uint8; ld, dd (n_lanes, n_pos, m) int64;
// r0pos, rank (n_lanes, n_pos) int64; T (n_lanes, levels, n_pos) int32;
// lens (n_lanes,) int64; ep0, ep1 (n_lanes, S) int32, the literal coders
// at [lit_base, lit_base + lit_slots); tables (n_lanes, 784) int32:
// ps_price, dfull, align_price; lc, lp; out (n_lanes, n_pos, 6m + 5)
// int32.  Returns the first CUDA error of the launch (0 on success).
extern "C" int lzt_dp_inputs(const uint8_t* data, const int64_t* ld,
                             const int64_t* dd, const int64_t* r0pos,
                             const int64_t* rank, const int* T, int levels,
                             const int64_t* lens, const int* ep0,
                             const int* ep1, long long S, long long lit_base,
                             long long lit_slots, const int* tables,
                             int n_lanes, long long n_pos, int m, int lc,
                             int lp, int* out, void* stream) {
  const int64_t chunks = (n_pos + kChunk - 1) / kChunk;
  if (n_lanes <= 0 || n_pos <= 0 || m <= 0 || levels < 1 || lc < 0 ||
      lc > 8 || lp < 0 || lp > 4 || lit_base < 0 ||
      lit_base + lit_slots > S || chunks * n_lanes > INT_MAX ||
      n_pos > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool pairs16 = m % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(ld) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dd) % 16 == 0;
  const int items = static_cast<int>(chunks * n_lanes);
  Args a{data, ld, dd, r0pos, rank, T, lens, ep0, ep1, tables, S, lit_base,
         n_pos, n_lanes, levels, m, lc, lp, static_cast<int>(chunks), items,
         pairs16, out};
  const long long smem = lzt_dp_inputs_smem(m);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) err = configure(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // kBlocksPerSM blocks an SM walk the lane-major chunks, and an SM keeps
  // no more shared memory than they need: the rest is L1
  const int blocks = items < kBlocksPerSM * sms ? items : kBlocksPerSM * sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rows_kernel<<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
