// Per-lane copies into shared memory on Hopper: the counterpart of the
// TPU probes tools/probe_dma.py probe1 (its pl.pallas_call at :53),
// probe2 (:92), probe3 (:116) and tools/probe_dma2.py run (:38) over
// its kernels kA-kE.
//
// The TPU probes asked whether a DMA of each lane's window, at a
// dynamic (row, column) offset from device memory into VMEM, lowers in
// Mosaic, inside a loop too, and in which form.  On Hopper the question
// is which copy engine takes which offset.  One block of 128 threads
// stages the (8, 128) int32 tile, row i from src[i, o_i : o_i + 128]
// of an (8, 1024) source, by one of:
//   plain     loads and stores, a thread per column;
//   async4    cp.async of 4 bytes, a thread per column;
//   async16   cp.async of 16 bytes (cp.async.cg), 32 chunks a row;
//   bulk      TMA bulk copies (cp.async.bulk ... mbarrier::complete_tx),
//             one per row, all on one mbarrier with expect_tx.
// probe_copy runs `rounds` rounds, row i at o_i + round * 128, summing
// the staged tiles (probe1: one round; probe2: two, the mbarrier's phase
// flipping each round).  probe_dma2 runs the five bulk forms of the TPU
// bisection: A the whole tile (one bulk copy a row on one barrier; a 2D
// tensor map is not used), B a copy a lane at the static offset 8i,
// issued and waited one at a time with a barrier each, C the same at the
// dynamic offsets, D a copy a lane at 8i issued by the lane's own thread
// on its own barrier, E the dynamic offsets on one barrier for all
// eight.  probe_scalar (probe3) adds the tile's element (3, 5), read
// from shared memory by every thread, to the tile.
//
// The hazard: cp.async of 16 bytes and the bulk copy need 16-byte-aligned
// global and shared addresses (and the bulk copy a size that is a
// multiple of 16); a misaligned one faults and poisons the CUDA context.
// The wrapper (lzma_tpu_torch/probes/probe_dma.py) therefore decides on
// the host which rows each form may copy and passes them as `mask`;
// this file never sees a misaligned row, and leaves the output rows of
// the others untouched.  Each barrier wait gives up after about a second
// and sets *err, so a fault in the byte count cannot hang the card.
//
// What bounds it: 4 KB move once, so the bound is nanoseconds; a launch
// of one block is bound by the host's submission.  So thread 0 counts
// the SM clock (clock64) from the first copy's issue to the barrier
// after the last wait and writes it to *cycles: the copy form's own
// latency, which the wrapper's table reports.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 8;          // lanes (rows of the tile)
constexpr int kM = 1024;       // the source row
constexpr int kC = 128;        // the window a lane stages
constexpr int kThreads = kC;   // a thread per column
constexpr uint32_t kRowBytes = kC * 4;
constexpr long long kTimeoutCycles = 1LL << 31;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once (the barrier's one expected arrival) and expect `bytes`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase of parity `parity` to complete; false if
// it has not after kTimeoutCycles.
__device__ __forceinline__ bool mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return true;
    if (clock64() - start > kTimeoutCycles) return false;
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(kRowBytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

enum CopyForm { kPlain = 0, kAsync4 = 1, kAsync16 = 2, kBulk = 3 };

template <int kForm>
__global__ void copy_kernel(const int* __restrict__ src,
                            const int* __restrict__ offs, int rounds,
                            int mask, int* __restrict__ out,
                            int* __restrict__ err,
                            long long* __restrict__ cycles) {
  __shared__ __align__(128) int stage[kN][kC];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  if constexpr (kForm == kBulk) {
    if (tid == 0) {
      mbar_init(&bar);
      mbar_fence_init();
    }
    __syncthreads();
  }
  // the offsets in shared memory first: the clock times the copies
  // alone, as the TPU probe's offsets were already on chip
  __shared__ int o[kN];
  if (tid < kN) o[tid] = offs[tid];
  int acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0;
  __syncthreads();
  bool ok = true;
  const long long t0 = clock64();
  for (int it = 0; it < rounds; ++it) {
    auto row = [&](int i) { return src + i * kM + o[i] + it * kC; };
    if constexpr (kForm == kPlain) {
      for (int i = 0; i < kN; ++i) {
        if ((mask >> i) & 1) stage[i][tid] = row(i)[tid];
      }
    } else if constexpr (kForm == kAsync4) {
      for (int i = 0; i < kN; ++i) {
        if ((mask >> i) & 1) async4(&stage[i][tid], row(i) + tid);
      }
      async_wait_all();
    } else if constexpr (kForm == kAsync16) {
      const int chunk = tid % 32;  // 16 B: four ints
      for (int i = tid / 32; i < kN; i += kThreads / 32) {
        if ((mask >> i) & 1) async16(&stage[i][chunk * 4], row(i) + chunk * 4);
      }
      async_wait_all();
    } else {
      if (tid == 0) {
        mbar_expect(&bar, __popc(mask) * kRowBytes);
        for (int i = 0; i < kN; ++i) {
          if ((mask >> i) & 1) bulk_copy(stage[i], row(i), &bar);
        }
      }
      ok = mbar_wait(&bar, it & 1) && ok;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] += stage[i][tid];
    __syncthreads();  // every read done before the next round's copies
  }
  if (tid == 0) *cycles = clock64() - t0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if ((mask >> i) & 1) out[i * kC + tid] = acc[i];
  }
  if (!ok) *err = 1;
}

enum Dma2Form { kA = 0, kB = 1, kCDyn = 2, kD = 3, kE = 4 };

template <int kForm>
__global__ void dma2_kernel(const int* __restrict__ src,
                            const int* __restrict__ offs, int mask,
                            int* __restrict__ out, int* __restrict__ err,
                            long long* __restrict__ cycles) {
  __shared__ __align__(128) int stage[kN][kC];
  __shared__ __align__(8) uint64_t bars[kN];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kN; ++i) mbar_init(&bars[i]);
    mbar_fence_init();
  }
  __shared__ int o[kN];   // the offsets on chip before the clock starts
  if (tid < kN) o[tid] = offs[tid];
  __syncthreads();
  auto row = [&](int i) {
    if constexpr (kForm == kA) return src + i * kM;
    if constexpr (kForm == kCDyn || kForm == kE) return src + i * kM + o[i];
    return src + i * kM + 8 * i;
  };
  bool ok = true;
  const long long t0 = clock64();
  if constexpr (kForm == kA || kForm == kE) {
    // one barrier for every copy
    if (tid == 0) {
      mbar_expect(&bars[0], __popc(mask) * kRowBytes);
      for (int i = 0; i < kN; ++i) {
        if ((mask >> i) & 1) bulk_copy(stage[i], row(i), &bars[0]);
      }
    }
    ok = mbar_wait(&bars[0], 0);
  } else if constexpr (kForm == kD) {
    // the lane's own thread, the lane's own barrier
    if (tid < kN && ((mask >> tid) & 1)) {
      mbar_expect(&bars[tid], kRowBytes);
      bulk_copy(stage[tid], row(tid), &bars[tid]);
      ok = mbar_wait(&bars[tid], 0);
    }
  } else {
    // B, C: one copy at a time, each waited before the next (the TPU's
    // start(); wait())
    if (tid == 0) {
      for (int i = 0; i < kN; ++i) {
        if (!((mask >> i) & 1)) continue;
        mbar_expect(&bars[i], kRowBytes);
        bulk_copy(stage[i], row(i), &bars[i]);
        ok = mbar_wait(&bars[i], 0) && ok;
      }
    }
  }
  __syncthreads();
  if (tid == 0) *cycles = clock64() - t0;
  for (int i = 0; i < kN; ++i) {
    if ((mask >> i) & 1) out[i * kC + tid] = stage[i][tid];
  }
  if (!ok) *err = 1;
}

// the tile staged by plain loads, then every thread reads (3, 5): the
// clock spans the read and the add
__global__ void scalar_kernel(const int* __restrict__ x, int* __restrict__ out,
                              long long* __restrict__ cycles) {
  __shared__ int tile[kN][kC];
  const int tid = threadIdx.x;
  for (int i = 0; i < kN; ++i) tile[i][tid] = x[i * kC + tid];
  __syncthreads();
  const long long t0 = clock64();
  const int s = tile[3][5];
  int sum[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) sum[i] = tile[i][tid] + s;
  __syncthreads();
  if (tid == 0) *cycles = clock64() - t0;
#pragma unroll
  for (int i = 0; i < kN; ++i) out[i * kC + tid] = sum[i];
}

using CopyFn = void (*)(const int*, const int*, int, int, int*, int*,
                        long long*);
using Dma2Fn = void (*)(const int*, const int*, int, int*, int*, long long*);

}  // namespace

// probe1 (rounds 1) / probe2 (rounds 2) in form 0 plain, 1 async4,
// 2 async16, 3 bulk, over the rows set in `mask`; the SM cycles of the
// staging go to *cycles.  Returns a CUDA error, or -1 for another form.
extern "C" int lzt_probe_copy(int form, const int* src, const int* offs,
                              int rounds, int mask, int* out, int* err,
                              long long* cycles, void* stream) {
  CopyFn fn = nullptr;
  switch (form) {
    case kPlain: fn = copy_kernel<kPlain>; break;
    case kAsync4: fn = copy_kernel<kAsync4>; break;
    case kAsync16: fn = copy_kernel<kAsync16>; break;
    case kBulk: fn = copy_kernel<kBulk>; break;
    default: return -1;
  }
  fn<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, offs, rounds, mask, out, err, cycles);
  return static_cast<int>(cudaGetLastError());
}

// probe_dma2's form 0-4 (A-E) over the rows set in `mask`.
extern "C" int lzt_probe_dma2(int form, const int* src, const int* offs,
                              int mask, int* out, int* err, long long* cycles,
                              void* stream) {
  Dma2Fn fn = nullptr;
  switch (form) {
    case kA: fn = dma2_kernel<kA>; break;
    case kB: fn = dma2_kernel<kB>; break;
    case kCDyn: fn = dma2_kernel<kCDyn>; break;
    case kD: fn = dma2_kernel<kD>; break;
    case kE: fn = dma2_kernel<kE>; break;
    default: return -1;
  }
  fn<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, offs, mask, out, err, cycles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lzt_probe_scalar(const int* x, int* out, long long* cycles,
                                void* stream) {
  scalar_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, cycles);
  return static_cast<int>(cudaGetLastError());
}

// The SM clock's rate in kHz (cudaDevAttrClockRate), or minus a CUDA
// error: what turns the kernels' cycles into time.
extern "C" int lzt_probe_clock_khz(int device) {
  int khz = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device);
  return err == cudaSuccess ? khz : -static_cast<int>(err);
}
