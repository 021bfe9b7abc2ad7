// LZMA decoder over N independent raw streams, one lane each.
//
// Replaces the TPU kernel lzma_tpu/ops/pallas_ring.py decode_pallas_ring
// (its pl.pallas_call).  The decode itself is lzma_decode.cuh
// decode_lane, shared with block_decoder.cu (K5); the outcome per lane
// (bytes, ok, final output position) is that of the plain version,
// lzma_tpu_torch/ops/device_decoder.py _decode_fsm.  The TPU kernel's
// ring window existed because VMEM could not hold the output; here the
// lane's own output row in device memory is its window (a main-path
// lane of 256 KiB is over the card's shared memory).
//
// What bounds it on this card: each lane is one dependent chain of bit
// decodes (a probability load, a multiply, a compare, a store, a
// renormalising input byte), one lane a block so that no two lanes share
// a warp and diverge.  The first version spent ~100 ns a decoded bit on
// the chain's branches and checks with its arena and input in device
// memory.  This design (lzma_decode.cuh ring_block):
//   - decodes in the two-speed body: fast symbols without per-bit or
//     per-byte checks, branch-free bits, the next probability loaded
//     ahead in every tree; the checked body for the tails;
//   - keeps the arena in shared memory when it fits beside the input
//     ring (kShared; 15 KB at lc3 lp0), else in device memory (lc8 lp4's
//     6.3 MB); the wrapper picks the placement from the arena's size and
//     the card's opt-in limit (cuda_ring.arena_placement), and a lane
//     never takes the other one;
//   - stages the stream into a ring of two 4 KiB tiles in shared memory
//     by cp.async, a producer warp keeping it filled while thread 0
//     decodes;
//   - sets the arena and copies the preset with all 64 threads.

#include <cstdint>
#include <cuda_runtime.h>

#include "lzma_decode.cuh"

namespace {

template <bool kShared>
__global__ void __launch_bounds__(kRingThreads)
    ring_decode_kernel(const uint8_t* __restrict__ comp,
                       const int* __restrict__ comp_lens,
                       const int* __restrict__ out_sizes,
                       const uint8_t* __restrict__ preset, int preset_len,
                       uint16_t* __restrict__ probs,
                       uint8_t* __restrict__ out, bool* __restrict__ ok,
                       int* __restrict__ out_pos_res, int max_in,
                       int dict_size, int lc, int lp, int pb, int max_out,
                       LztLayout L) {
  const int lane = blockIdx.x;
  uint8_t* o = out + static_cast<size_t>(lane) * max_out;
  ring_block<kShared>(
      comp + static_cast<size_t>(lane) * max_in, comp_lens[lane], max_in,
      preset, preset_len,
      kShared ? nullptr : probs + static_cast<size_t>(lane) * L.size, o, L,
      [&](RingIn& in, Arena<kShared> arena, DevWin win) {
        decode_lane(in, arena, win, max_out, preset_len, out_sizes[lane],
                    dict_size, lc, lp, pb, L, ok + lane, out_pos_res + lane);
      });
}

template <bool kShared>
int launch(const uint8_t* comp, const int* comp_lens, const int* out_sizes,
           const uint8_t* preset, int preset_len, uint16_t* probs,
           uint8_t* out, bool* ok, int* out_pos, int n_lanes, int max_in,
           int dict_size, int lc, int lp, int pb, int max_out,
           LztLayout layout, cudaStream_t stream) {
  const int smem_bytes = static_cast<int>(ring_smem_bytes(kShared, layout.size));
  cudaError_t err = cudaFuncSetAttribute(
      ring_decode_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    ring_decode_kernel<kShared><<<n_lanes, kRingThreads, smem_bytes, stream>>>(
        comp, comp_lens, out_sizes, preset, preset_len, probs, out, ok,
        out_pos, max_in, dict_size, lc, lp, pb, max_out, layout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shared != 0 puts the arena in shared memory (probs unused), else in
// `probs` (n_lanes x layout.size uint16); the block's dynamic shared
// memory follows (ring_smem_bytes).  A device arena without `probs` is
// refused (cudaErrorInvalidValue).
extern "C" int lzt_ring_decode(const uint8_t* comp, const int* comp_lens,
                               const int* out_sizes, const uint8_t* preset,
                               int preset_len, uint16_t* probs, uint8_t* out,
                               bool* ok, int* out_pos, int n_lanes, int max_in,
                               int dict_size, int lc, int lp, int pb,
                               int max_out, int shared, LztLayout layout,
                               void* stream) {
  if (!shared && probs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared ? launch<true>(comp, comp_lens, out_sizes, preset, preset_len,
                               probs, out, ok, out_pos, n_lanes, max_in,
                               dict_size, lc, lp, pb, max_out, layout, s)
                : launch<false>(comp, comp_lens, out_sizes, preset,
                                preset_len, probs, out, ok, out_pos, n_lanes,
                                max_in, dict_size, lc, lp, pb, max_out, layout,
                                s);
}
