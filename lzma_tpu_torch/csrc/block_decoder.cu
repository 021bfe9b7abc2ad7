// LZMA decoder over N independent raw streams with each lane's whole
// block resident in shared memory, one lane per block.
//
// Replaces the TPU kernel lzma_tpu/ops/pallas_decoder.py decode_pallas
// (its pl.pallas_call), which keeps the probability arena, the
// compressed input and the whole decoded window of every lane in VMEM.
// Here a CTA loads its lane's stream (max_in bytes), sets its int16
// arena to 1024 and primes its window (max_out bytes: the preset, then
// zeros) in dynamic shared memory; one thread runs the decode there
// (lzma_decode.cuh decode_lane, the same body as K1, so the outcome per
// lane is that of the plain version lzma_tpu_torch/ops/device_decoder.py
// _decode_fsm, error rules included; its two speeds, branch-free bits
// and probabilities loaded ahead are K1's); then the CTA writes the
// window to device memory once.
//
// What bounds it on this card: the same serial chain of bit decodes as
// K1, one lane a CTA; what it changes is where each step's probability
// load and store and each copied byte go: shared memory instead of
// device memory through L1/L2.  Its envelope is the TPU kernel's: a lane
// must fit the card's opt-in shared memory per block (227 KB on the
// H100), which the wrapper checks (ops/cuda_decoder.py resident_layout);
// beyond it the wrapper raises.  The layout, by offsets the wrapper
// passes: the arena at 0, the window at win_off, the input at in_off,
// each rounded up to 16 bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "lzma_decode.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void block_decode_kernel(const uint8_t* __restrict__ comp,
                                    const int* __restrict__ comp_lens,
                                    const int* __restrict__ out_sizes,
                                    const uint8_t* __restrict__ preset,
                                    int preset_len, uint8_t* __restrict__ out,
                                    bool* __restrict__ ok,
                                    int* __restrict__ out_pos_res,
                                    int max_in, int dict_size, int lc, int lp,
                                    int pb, int max_out, int win_off,
                                    int in_off, LztLayout L) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* p = reinterpret_cast<uint16_t*>(smem);
  uint8_t* win = smem + win_off;
  uint8_t* in = smem + in_off;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* src = comp + static_cast<size_t>(lane) * max_in;

  for (int k = tid; k < L.size; k += kThreads) p[k] = 1024;
  for (int k = tid; k < max_out; k += kThreads) {
    win[k] = k < preset_len ? preset[k] : 0;
  }
  for (int k = tid; k < max_in; k += kThreads) in[k] = src[k];
  __syncthreads();

  if (tid == 0) {
    const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int in_len = comp_lens[lane];
    SmemIn input{s0 + in_off, in_len, min(in_len, max_in),
                 max_in > 0 ? in[max_in - 1] : 0u};
    decode_lane(input, Arena<true>{s0}, SmemWin{s0 + win_off}, max_out,
                preset_len, out_sizes[lane], dict_size, lc, lp, pb, L,
                ok + lane, out_pos_res + lane);
  }
  __syncthreads();

  uint8_t* o = out + static_cast<size_t>(lane) * max_out;
  for (int k = tid; k < max_out; k += kThreads) o[k] = win[k];
}

}  // namespace

extern "C" int lzt_block_decode(const uint8_t* comp, const int* comp_lens,
                                const int* out_sizes, const uint8_t* preset,
                                int preset_len, uint8_t* out, bool* ok,
                                int* out_pos, int n_lanes, int max_in,
                                int dict_size, int lc, int lp, int pb,
                                int max_out, int win_off, int in_off,
                                int smem_bytes, LztLayout layout,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    block_decode_kernel<<<n_lanes, kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        comp, comp_lens, out_sizes, preset, preset_len, out, ok, out_pos,
        max_in, dict_size, lc, lp, pb, max_out, win_off, in_off, layout);
  }
  return static_cast<int>(cudaGetLastError());
}
