// LZMA decoder over N independent raw streams, one lane each.
//
// Replaces the TPU kernel lzma_tpu/ops/pallas_ring.py decode_pallas_ring
// (its pl.pallas_call).  The decode itself is lzma_decode.cuh
// decode_lane, shared with block_decoder.cu (K5); the outcome per lane
// (bytes, ok, final output position) is that of the plain version,
// lzma_tpu_torch/ops/device_decoder.py _decode_fsm.  The TPU kernel's
// ring window existed because VMEM could not hold the output; here the
// lane's own output row in device memory is its window.
//
// What bounds it on this card: each lane is one dependent chain of
// bit decodes (a probability load, a multiply, a compare, a store), so
// the kernel runs as N threads of the 132 SMs, one lane per block so that
// no two lanes share a warp and diverge.  The lane's arena (uint16, up
// to 6 MB at lc8/lp4) and window are in device memory, so each bit's
// probability update is a load and a store there.  K5 keeps them in
// shared memory where they fit.

#include <cstdint>
#include <cuda_runtime.h>

#include "lzma_decode.cuh"

namespace {

__global__ void ring_decode_kernel(const uint8_t* __restrict__ comp,
                                   const int* __restrict__ comp_lens,
                                   const int* __restrict__ out_sizes,
                                   const uint8_t* __restrict__ preset,
                                   int preset_len,
                                   uint16_t* __restrict__ probs,
                                   uint8_t* __restrict__ out,
                                   bool* __restrict__ ok,
                                   int* __restrict__ out_pos_res,
                                   int n_lanes, int max_in, int dict_size,
                                   int lc, int lp, int pb, int max_out,
                                   LztLayout L) {
  const int lane = blockIdx.x;
  if (lane >= n_lanes || threadIdx.x != 0) return;
  uint16_t* p = probs + static_cast<size_t>(lane) * L.size;
  for (int i = 0; i < L.size; ++i) p[i] = 1024;
  uint8_t* o = out + static_cast<size_t>(lane) * max_out;
  for (int i = 0; i < preset_len; ++i) o[i] = preset[i];
  decode_lane(comp + static_cast<size_t>(lane) * max_in, comp_lens[lane],
              max_in, p, o, max_out, preset_len, out_sizes[lane], dict_size,
              lc, lp, pb, L, ok + lane, out_pos_res + lane);
}

}  // namespace

extern "C" int lzt_ring_decode(const uint8_t* comp, const int* comp_lens,
                               const int* out_sizes, const uint8_t* preset,
                               int preset_len, uint16_t* probs, uint8_t* out,
                               bool* ok, int* out_pos, int n_lanes, int max_in,
                               int dict_size, int lc, int lp, int pb,
                               int max_out, LztLayout layout, void* stream) {
  if (n_lanes > 0) {
    ring_decode_kernel<<<n_lanes, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        comp, comp_lens, out_sizes, preset, preset_len, probs, out, ok,
        out_pos, n_lanes, max_in, dict_size, lc, lp, pb, max_out, layout);
  }
  return static_cast<int>(cudaGetLastError());
}
