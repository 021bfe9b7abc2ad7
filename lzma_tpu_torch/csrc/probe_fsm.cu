// The cost of one synthetic decode step on Hopper: the counterpart of
// the TPU probes tools/probe_fsm_cost.py v1 (its pl.pallas_call at :75),
// v2 (:135), v_i16 (:165) and tools/probe_fsm_cost2.py make (:89).
//
// The TPU probes asked what a decode step costs when every gather and
// scatter is a one-hot masked operation over the lane's whole arena or
// window, as a function of the lane count.  Here one thread runs one
// lane's step `iters` times and indexes its arena, window and input
// directly.  Each step is a dependent chain: the arena index depends on
// the last step's bit, the window index on the probability just read.
// What bounds it is that chain's latency, so the lanes are kLanes
// threads of one warp a block and, up to the card's 132 SMs, the time
// a step takes does not depend on the lane count.  The placement is a
// template parameter, the question of K5 against K1: the lane's arena,
// window and input in shared memory (a block holds kLanes lanes, 8 at
// 28,160 B a lane for v1 in the 227 KB a block may have) or in device
// memory (a scratch buffer the wrapper allocates, n x lane bytes).
//
// Forms (the wrapper lzma_tpu_torch/probes/probe_fsm_cost.py and
// probe_fsm_cost2.py holds each to its plain PyTorch version):
//   v1    int32 arena (S) read and updated by the >>5 rule, int32 window
//         (W) read at (pos - p) & (W-1) and written at pos & (W-1), one
//         input byte at pos % C (the input holds 1s: the TPU probe's
//         one-hot input gather summed to 1); out = bit + pos
//   v2    two probabilities to an int32 word, the window and the input
//         in words, a 4-byte write accumulator flushed every 4th step
//   i16   the arena step alone, in int16; out = bit
//   make  v1's step without the input (the window takes bb + p), then
//         kRegs carried registers and kSelects chained selects, unrolled;
//         the loop a fixed trip or a `while` on a block-wide vote
//         (__syncthreads_or, the counterpart of jnp.any in the TPU
//         probe's loop condition)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kS = 2688;   // the arena at lc0 (tools/probe_fsm_cost.py S)
constexpr int kW = 4096;   // the window (dict 4 KiB)
constexpr int kC = 1024;   // the staged input
constexpr int kLanes = 8;  // lanes (threads) a block

constexpr int kV1Bytes = kS * 4 + kW * 4 + kC;      // 28,160
constexpr int kV2Bytes = kS / 2 * 4 + kW + kC;      // 10,496
constexpr int kI16Bytes = kS * 2;                   // 5,376
constexpr int kMakeBytes = kS * 4 + kW * 4;         // 27,136

// The lane's memory: its slice of the block's dynamic shared memory, or
// of the device scratch buffer.
template <bool kShared>
__device__ __forceinline__ uint8_t* lane_base(uint8_t* scratch, int lane,
                                              int lane_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (kShared) return smem + threadIdx.x * lane_bytes;
  return scratch + static_cast<size_t>(lane) * lane_bytes;
}

__device__ __forceinline__ int adapt(int p, int bit) {
  return bit == 0 ? p + ((2048 - p) >> 5) : p - (p >> 5);
}

// The digest a lane writes when the caller asks for it: its n words
// from p, then `extra` more values, each times its index + 1, summed
// modulo 2^32.  It checks the memory the steps left behind, which the
// probes' own result (a bit and a count) hardly shows.
template <typename T>
__device__ __forceinline__ void write_digest(int* digest, int lane, const T* p,
                                             int n, const uint32_t* extra = nullptr,
                                             int n_extra = 0) {
  uint32_t acc = 0;
  for (int i = 0; i < n; ++i) {
    acc += static_cast<uint32_t>(p[i]) * static_cast<uint32_t>(i + 1);
  }
  for (int i = 0; i < n_extra; ++i) {
    acc += extra[i] * static_cast<uint32_t>(n + i + 1);
  }
  digest[lane] = static_cast<int>(acc);
}

template <bool kShared>
__global__ void v1_kernel(const int* __restrict__ seed, int* __restrict__ out,
                          int* __restrict__ digest, uint8_t* scratch, int n,
                          int iters) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= n) return;
  int* probs = reinterpret_cast<int*>(lane_base<kShared>(scratch, lane, kV1Bytes));
  int* win = probs + kS;
  uint8_t* in = reinterpret_cast<uint8_t*>(win + kW);
  for (int i = 0; i < kS; ++i) probs[i] = 1024;
  for (int i = 0; i < kW; ++i) win[i] = 0;
  for (int i = 0; i < kC; ++i) in[i] = 1;
  const int sd = seed[lane];
  int bit = 0, pos = 0;
  for (int t = 0; t < iters; ++t) {
    const int idx = (sd * 131 + t * 7 + bit * 3) % kS;
    const int p = probs[idx];
    probs[idx] = adapt(p, bit);
    const int ib = in[pos % kC];
    const int bb = win[(pos - p) & (kW - 1)];
    win[pos & (kW - 1)] = bb + ib;
    bit = (p + bb) & 1;
    ++pos;
  }
  out[lane] = bit + pos;
  if (digest) write_digest(digest, lane, probs, kS + kW);
}

template <bool kShared>
__global__ void v2_kernel(const int* __restrict__ seed, int* __restrict__ out,
                          int* __restrict__ digest, uint8_t* scratch, int n,
                          int iters) {
  constexpr int kSH = kS / 2, kWH = kW / 4, kCH = kC / 4;
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= n) return;
  int* probs = reinterpret_cast<int*>(lane_base<kShared>(scratch, lane, kV2Bytes));
  int* win = probs + kSH;
  int* in = win + kWH;
  for (int i = 0; i < kSH; ++i) probs[i] = 1024 | (1024 << 16);
  for (int i = 0; i < kWH; ++i) win[i] = 0;
  for (int i = 0; i < kCH; ++i) in[i] = 1;
  const int sd = seed[lane];
  int bit = 0, pos = 0;
  uint32_t accum = 0;
  for (int t = 0; t < iters; ++t) {
    const int idx = (sd * 131 + t * 7 + bit * 3) % kS;
    const int wi = idx >> 1;
    const bool half = (idx & 1) != 0;
    const int word = probs[wi];
    const int p = (half ? word >> 16 : word) & 0xFFFF;
    const int np = adapt(p, bit);
    probs[wi] = half ? (word & 0xFFFF) | (np << 16) : (word & ~0xFFFF) | np;
    const int ipos = pos % kC;
    const int ib = (in[ipos >> 2] >> ((ipos & 3) * 8)) & 0xFF;
    const int gpos = (pos - p) & (kW - 1);
    const int bb = (win[gpos >> 2] >> ((gpos & 3) * 8)) & 0xFF;
    const uint32_t byte = static_cast<uint32_t>(bb + ib) & 0xFFu;
    accum |= byte << ((pos & 3) * 8);
    if ((pos & 3) == 3) {
      win[(pos >> 2) & (kWH - 1)] = static_cast<int>(accum);
      accum = 0;
    }
    bit = (p + bb) & 1;
    ++pos;
  }
  out[lane] = bit + pos;
  if (digest) write_digest(digest, lane, probs, kSH + kWH, &accum, 1);
}

template <bool kShared>
__global__ void i16_kernel(const int* __restrict__ seed, int* __restrict__ out,
                           int* __restrict__ digest, uint8_t* scratch, int n,
                           int iters) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= n) return;
  int16_t* probs = reinterpret_cast<int16_t*>(
      lane_base<kShared>(scratch, lane, kI16Bytes));
  for (int i = 0; i < kS; ++i) probs[i] = 1024;
  const int sd = seed[lane];
  int bit = 0;
  for (int t = 0; t < iters; ++t) {
    const int idx = (sd * 131 + t * 7 + bit * 3) % kS;
    const int16_t p = probs[idx];
    probs[idx] = static_cast<int16_t>(adapt(p, bit));
    bit = p & 1;
  }
  out[lane] = bit;
  if (digest) write_digest(digest, lane, probs, kS);
}

template <bool kShared, bool kWhile, int kSelects, int kRegs>
__global__ void make_kernel(const int* __restrict__ seed, int* __restrict__ out,
                            int* __restrict__ digest, uint8_t* scratch, int n,
                            int iters) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const bool active = lane < n;
  // the while form's vote needs every thread of the block, so a thread
  // past the last lane stays and votes 0
  if (!kWhile && !active) return;
  int* probs = nullptr;
  int* win = nullptr;
  int sd = 0;
  if (active) {
    probs = reinterpret_cast<int*>(lane_base<kShared>(scratch, lane, kMakeBytes));
    win = probs + kS;
    for (int i = 0; i < kS; ++i) probs[i] = 1024;
    for (int i = 0; i < kW; ++i) win[i] = 0;
    sd = seed[lane];
  }
  int regs[kRegs > 0 ? kRegs : 1];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) regs[r] = r + 1;
  int bit = 0, pos = 0;

  auto step = [&](int t) {
    const int idx = (sd * 131 + t * 7 + bit * 3) % kS;
    const int p = probs[idx];
    probs[idx] = adapt(p, bit);
    const int bb = win[(pos - p) & (kW - 1)];
    win[pos & (kW - 1)] = bb + p;
    int x = bb;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      // a chained select network stand-in, as in the TPU probe
      x = (x & 1) == 0 ? x + regs[r] : x - regs[r];
      regs[r] = (x & 3) == 0 ? regs[r] + 1 : regs[r];
    }
#pragma unroll
    for (int s = 0; s < kSelects; ++s) x = (x & 1) == 0 ? x + 3 : x >> 1;
    bit = (p + x) & 1;
    ++pos;
  };

  if constexpr (kWhile) {
    int t = 0;
    while (__syncthreads_or(active && pos < iters) && t < iters) {
      if (active) step(t);
      ++t;
    }
  } else {
    for (int t = 0; t < iters; ++t) step(t);
  }
  if (!active) return;
  out[lane] = bit + pos;
  if (digest) {
    uint32_t extra[kRegs > 0 ? kRegs : 1];
#pragma unroll
    for (int r = 0; r < kRegs; ++r) extra[r] = static_cast<uint32_t>(regs[r]);
    write_digest(digest, lane, probs, kS + kW, extra, kRegs);
  }
}

using ProbeFn = void (*)(const int*, int*, int*, uint8_t*, int, int);

template <bool kShared, bool kWhile>
ProbeFn make_for(int selects, int regs) {
  if (selects == 0 && regs == 0) return make_kernel<kShared, kWhile, 0, 0>;
  if (selects == 0 && regs == 24) return make_kernel<kShared, kWhile, 0, 24>;
  if (selects == 120 && regs == 0) return make_kernel<kShared, kWhile, 120, 0>;
  if (selects == 120 && regs == 24) return make_kernel<kShared, kWhile, 120, 24>;
  if (selects == 150 && regs == 0) return make_kernel<kShared, kWhile, 150, 0>;
  if (selects == 150 && regs == 24) return make_kernel<kShared, kWhile, 150, 24>;
  return nullptr;
}

template <bool kShared>
ProbeFn kernel_for(int form, int loop_while, int selects, int regs) {
  switch (form) {
    case 0: return v1_kernel<kShared>;
    case 1: return v2_kernel<kShared>;
    case 2: return i16_kernel<kShared>;
    case 3: return loop_while ? make_for<kShared, true>(selects, regs)
                              : make_for<kShared, false>(selects, regs);
    default: return nullptr;
  }
}

}  // namespace

// Bytes one lane needs for `form` (0 v1, 1 v2, 2 i16, 3 make), or -1.
extern "C" int lzt_probe_fsm_lane_bytes(int form) {
  switch (form) {
    case 0: return kV1Bytes;
    case 1: return kV2Bytes;
    case 2: return kI16Bytes;
    case 3: return kMakeBytes;
    default: return -1;
  }
}

extern "C" int lzt_probe_fsm_lanes_per_block() { return kLanes; }

// One launch of `form` over n lanes, `iters` steps each.  shared != 0
// puts each lane in shared memory (scratch unused), else in `scratch`
// (n x lane bytes of device memory).  make takes loop_while (0 fixed
// trip, 1 while), selects (0, 120, 150) and regs (0, 24).  digest, where
// not null, gets each lane's sum of its memory after the steps (and of
// make's carried registers).  Returns a CUDA error, or -1 for a form or
// option the library has no kernel for.
extern "C" int lzt_probe_fsm(int form, int shared, int loop_while,
                             int selects, int regs, const int* seed, int* out,
                             int* digest, uint8_t* scratch, int n, int iters,
                             void* stream) {
  ProbeFn fn = shared ? kernel_for<true>(form, loop_while, selects, regs)
                      : kernel_for<false>(form, loop_while, selects, regs);
  const int lane_bytes = lzt_probe_fsm_lane_bytes(form);
  if (fn == nullptr || lane_bytes < 0) return -1;
  const int smem = shared ? kLanes * lane_bytes : 0;
  if (shared) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kLanes - 1) / kLanes;
  if (blocks > 0) {
    fn<<<blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        seed, out, digest, scratch, n, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
