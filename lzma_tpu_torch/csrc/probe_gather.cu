// Gathers and scatters on Hopper: the counterpart of the TPU probes
// tools/probe_gather.py probe_native (its pl.pallas_call at :32),
// probe_onehot (:66), probe_scatter (:95) and tools/probe_gather2.py
// probe_chain (:43) and probe_taa (:72).
//
// The TPU probes asked whether a per-lane dynamic gather lowers, what
// the one-hot masked form the kernels used instead costs at each width,
// and what one dependent gather+scatter pair costs as the lane count
// grows.  Here:
//   native   a thread per lane indexes its row directly: acc +=
//            row[(idx + t) % w].  The row is in shared memory (the
//            block's lanes' rows copied in first) or in device memory.
//            The loads do not depend on each other, so what bounds it
//            is the load issue rate, not a chain.
//   onehot   the TPU's form taken literally: a warp per lane reads every
//            column of its row in shared memory, selects the one at the
//            index and sums the warp by shuffles; width/32 loads a thread
//            a step.
//   scatter  the TPU's one-hot scatter: a warp per lane reads and writes
//            back every column through a select, then sums the row.
//   chain    g dependent gather+scatter pairs a step, a thread per lane:
//            v = row[(idx + t + v) % w] & 1023; row[...] = v + 1.  What
//            bounds it is the latency of one pair (index arithmetic, a
//            load, a store) in shared or device memory.
//   taa      one gather a lane, to check what it returns.
// A block of the thread-per-lane forms holds `lpb` lanes, as many rows
// as fit the block's shared memory (the wrapper,
// lzma_tpu_torch/probes/probe_gather.py, chooses it, the same for both
// placements); in shared memory kStage threads copy the rows in and the
// first lpb run the lanes.  A lane's start index is taken modulo the
// width, as a floor (Python's %), so any int32 is a valid index.  The
// `volatile` in the one-hot forms keeps every column's load and store,
// as the TPU's masked operations do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kStage = 256;   // threads a block that stages rows

__device__ __forceinline__ int floor_mod(int a, int w) {
  const int r = a % w;
  return r < 0 ? r + w : r;
}

// copy the block's lanes' rows [lane0, lane0 + lpb) of src into shared
// memory, as many as there are lanes, with every thread of the block
__device__ __forceinline__ void stage_rows(int* dst, const int* src, int lane0,
                                           int lpb, int n, int width) {
  const int rows = n - lane0 < lpb ? n - lane0 : lpb;
  const size_t total = static_cast<size_t>(rows) * width;
  const int* from = src + static_cast<size_t>(lane0) * width;
  for (size_t k = threadIdx.x; k < total; k += blockDim.x) dst[k] = from[k];
  __syncthreads();
}

template <bool kShared>
__global__ void native_kernel(const int* __restrict__ arr,
                              const int* __restrict__ idx,
                              int* __restrict__ out, int n, int width,
                              int iters, int lpb) {
  extern __shared__ __align__(16) int srows[];
  const int lane0 = blockIdx.x * lpb;
  if constexpr (kShared) stage_rows(srows, arr, lane0, lpb, n, width);
  const int lane = lane0 + threadIdx.x;
  if (threadIdx.x >= lpb || lane >= n) return;
  const int* row = kShared ? srows + threadIdx.x * width
                           : arr + static_cast<size_t>(lane) * width;
  int j = floor_mod(idx[lane], width);
  int acc = 0;
  for (int t = 0; t < iters; ++t) {
    acc += row[j];
    j = j + 1 == width ? 0 : j + 1;
  }
  out[lane] = acc;
}

// a warp per lane, its row in shared memory
__global__ void onehot_kernel(const int* __restrict__ arr,
                              const int* __restrict__ idx,
                              int* __restrict__ out, int width, int iters) {
  extern __shared__ __align__(16) int srows[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int* src = arr + static_cast<size_t>(lane) * width;
  for (int c = tid; c < width; c += kWarp) srows[c] = src[c];
  __syncwarp();
  volatile int* row = srows;
  int j = floor_mod(idx[lane], width);
  int acc = 0;
  for (int t = 0; t < iters; ++t) {
    int v = 0;
    for (int c = tid; c < width; c += kWarp) {
      const int x = row[c];
      v += c == j ? x : 0;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
    }
    acc += v;
    j = j + 1 == width ? 0 : j + 1;
  }
  if (tid == 0) out[lane] = acc;
}

__global__ void scatter_kernel(const int* __restrict__ arr,
                               const int* __restrict__ idx,
                               int* __restrict__ out, int width, int iters) {
  extern __shared__ __align__(16) int srows[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int* src = arr + static_cast<size_t>(lane) * width;
  volatile int* row = srows;
  for (int c = tid; c < width; c += kWarp) row[c] = src[c];
  int j = floor_mod(idx[lane], width);
  for (int t = 0; t < iters; ++t) {
    // each thread owns the columns c = tid (mod 32): no other thread
    // touches them until the sum
    for (int c = tid; c < width; c += kWarp) {
      const int x = row[c];
      row[c] = c == j ? t : x;
    }
    j = j + 1 == width ? 0 : j + 1;
  }
  __syncwarp();
  int v = 0;
  for (int c = tid; c < width; c += kWarp) v += row[c];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  }
  if (tid == 0) out[lane] = v;
}

// `work` holds the rows the chain updates: in device memory the
// wrapper's copy of arr, in shared memory the rows staged from it.
template <bool kShared, int kG>
__global__ void chain_kernel(int* __restrict__ work,
                             const int* __restrict__ idx,
                             int* __restrict__ out, int n, int width,
                             int iters, int lpb) {
  extern __shared__ __align__(16) int srows[];
  const int lane0 = blockIdx.x * lpb;
  if constexpr (kShared) stage_rows(srows, work, lane0, lpb, n, width);
  const int lane = lane0 + threadIdx.x;
  if (threadIdx.x >= lpb || lane >= n) return;
  int* row = kShared ? srows + threadIdx.x * width
                     : work + static_cast<size_t>(lane) * width;
  const int i0 = floor_mod(idx[lane], width);  // then i0 + t + v >= 0
  int v = 0;
  for (int t = 0; t < iters; ++t) {
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int ii = (i0 + t + v) % width;
      v = row[ii] & 1023;
      row[ii] = v + 1;
    }
  }
  out[lane] = v;
}

// an index outside the row gives 0
__global__ void taa_kernel(const int* __restrict__ arr,
                           const int* __restrict__ idx, int* __restrict__ out,
                           int n, int width) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int j = idx[lane];
  out[lane] = j >= 0 && j < width ? arr[static_cast<size_t>(lane) * width + j] : 0;
}

template <typename K>
int set_smem(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

// probe_native over n lanes (lpb <= 32 a block): shared != 0 stages each
// block's lpb rows in shared memory.  Returns a CUDA error.
extern "C" int lzt_probe_native(int shared, const int* arr, const int* idx,
                                int* out, int n, int width, int iters, int lpb,
                                void* stream) {
  const int blocks = (n + lpb - 1) / lpb;
  const int smem = shared ? lpb * width * 4 : 0;
  auto k = shared ? native_kernel<true> : native_kernel<false>;
  if (shared) {
    if (int err = set_smem(k, smem)) return err;
  }
  if (blocks > 0) {
    k<<<blocks, shared ? kStage : lpb, smem, static_cast<cudaStream_t>(stream)>>>(
        arr, idx, out, n, width, iters, lpb);
  }
  return static_cast<int>(cudaGetLastError());
}

// probe_onehot (scatter = 0) or probe_scatter (scatter = 1): a warp
// per lane, its row (width x 4 bytes) in shared memory.
extern "C" int lzt_probe_onehot(int scatter, const int* arr, const int* idx,
                                int* out, int n, int width, int iters,
                                void* stream) {
  const int smem = width * 4;
  auto k = scatter ? scatter_kernel : onehot_kernel;
  if (int err = set_smem(k, smem)) return err;
  if (n > 0) {
    k<<<n, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(arr, idx, out,
                                                               width, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// probe_chain with g in {1, 2, 4} pairs a step; `work` (n, width) is
// updated in place where shared == 0 and read where shared != 0.
// Returns a CUDA error, or -1 for another g.
extern "C" int lzt_probe_chain(int shared, int g, int* work, const int* idx,
                               int* out, int n, int width, int iters, int lpb,
                               void* stream) {
  using ChainFn = void (*)(int*, const int*, int*, int, int, int, int);
  ChainFn k = nullptr;
  if (g == 1) k = shared ? chain_kernel<true, 1> : chain_kernel<false, 1>;
  if (g == 2) k = shared ? chain_kernel<true, 2> : chain_kernel<false, 2>;
  if (g == 4) k = shared ? chain_kernel<true, 4> : chain_kernel<false, 4>;
  if (k == nullptr) return -1;
  const int blocks = (n + lpb - 1) / lpb;
  const int smem = shared ? lpb * width * 4 : 0;
  if (shared) {
    if (int err = set_smem(k, smem)) return err;
  }
  if (blocks > 0) {
    k<<<blocks, shared ? kStage : lpb, smem, static_cast<cudaStream_t>(stream)>>>(
        work, idx, out, n, width, iters, lpb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lzt_probe_taa(const int* arr, const int* idx, int* out, int n,
                             int width, void* stream) {
  if (n > 0) {
    taa_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        arr, idx, out, n, width);
  }
  return static_cast<int>(cudaGetLastError());
}
