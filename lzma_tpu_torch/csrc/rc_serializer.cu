// Adaptive binary range encoder over per-lane (ctx, bit) streams.
//
// Replaces the TPU kernel lzma_tpu/ops/pallas_serializer.py
// serialize_pallas (its pl.pallas_call): the same contract as the plain
// version lzma_tpu_torch/ops/device_encoder.py serialize -- identical
// bytes and lengths -- without the TPU's workarounds (packed probability
// pairs, one-hot gathers, DMA tiles, the staging ring).  The body is the
// reference's shiftLow coder (RangeEncoder.java:73-87, RangeEnc in
// lzma_tpu/runtime/src/lzma_core.cpp): a 64-bit `low` with cache and
// cache_size, so the carry flag and drain counter of the lane-parallel
// version go away and bytes go straight into the lane's output row.
//
// What bounds it on this card: each lane is one dependent chain (one
// probability read-modify-write and a compare per bit), so the kernel
// runs as N independent threads of the 132 SMs, one lane per block so
// that no two lanes share a warp and diverge.  The arena (uint16 per
// lane) is in device memory, so each bit's probability update is a load
// and a store there: ~150 ns a bit measured on an H100 80GB HBM3 at
// 700 W, the order of an L2 round trip.  A later PR puts the arena in
// shared memory (14.6 KB at lc3) and runs more lanes per block.
//
// ctx >= 0: adaptive bit at that arena slot; ctx == -1: direct bit; any
// other ctx inside `totals` consumes a step and codes nothing.  A lane
// whose output would pass max_out stops writing and reports consumed = -1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Enc {
  uint64_t low;
  uint32_t range;
  uint32_t cache;
  uint64_t cache_size;
  long long pos;
  bool overflow;
  uint8_t* out;
  int max_out;

  __device__ void put(uint32_t byte) {
    if (pos < max_out) {
      out[pos] = static_cast<uint8_t>(byte);
    } else {
      overflow = true;
    }
    ++pos;
  }

  __device__ void shift_low() {
    if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
      const uint32_t carry = static_cast<uint32_t>(low >> 32);
      uint32_t temp = cache;
      do {
        put((temp + carry) & 0xFFu);
        temp = 0xFFu;
      } while (--cache_size != 0);
      cache = static_cast<uint32_t>(low >> 24) & 0xFFu;
    }
    ++cache_size;
    low = (low & 0x00FFFFFFull) << 8;
  }
};

__global__ void rc_serialize_kernel(const int* __restrict__ ctx,
                                    const int* __restrict__ bits,
                                    const int* __restrict__ totals,
                                    uint16_t* __restrict__ probs,
                                    uint8_t* __restrict__ out,
                                    int* __restrict__ lens,
                                    int* __restrict__ consumed,
                                    int n_lanes, int n_bits, int arena_size,
                                    int max_out) {
  const int lane = blockIdx.x;
  if (lane >= n_lanes || threadIdx.x != 0) return;
  const int* cx = ctx + static_cast<size_t>(lane) * n_bits;
  const int* bt = bits + static_cast<size_t>(lane) * n_bits;
  uint16_t* p = probs + static_cast<size_t>(lane) * arena_size;
  for (int i = 0; i < arena_size; ++i) p[i] = 1024;

  Enc e{0, 0xFFFFFFFFu, 0, 1, 0, false,
        out + static_cast<size_t>(lane) * max_out, max_out};
  const int total = totals[lane];
  for (int i = 0; i < total; ++i) {
    const int j = i < n_bits ? i : n_bits - 1;
    const int c = cx[j];
    const int b = bt[j];
    if (c >= 0) {
      const uint32_t pr = p[c];
      const uint32_t bound = (e.range >> 11) * pr;
      if (b == 0) {
        e.range = bound;
        p[c] = static_cast<uint16_t>(pr + ((2048u - pr) >> 5));
      } else {
        e.low += bound;
        e.range -= bound;
        p[c] = static_cast<uint16_t>(pr - (pr >> 5));
      }
    } else if (c == -1) {
      e.range >>= 1;
      if (b == 1) e.low += e.range;
    } else {
      continue;  // padding: a step with no bit
    }
    if (e.range < (1u << 24)) {
      e.range <<= 8;
      e.shift_low();
    }
  }
  for (int k = 0; k < 5; ++k) e.shift_low();
  lens[lane] = static_cast<int>(e.pos);
  consumed[lane] = e.overflow ? -1 : total;
}

}  // namespace

extern "C" int lzt_rc_serialize(const int* ctx, const int* bits,
                                const int* totals, uint16_t* probs,
                                uint8_t* out, int* lens, int* consumed,
                                int n_lanes, int n_bits, int arena_size,
                                int max_out, void* stream) {
  if (n_lanes > 0) {
    rc_serialize_kernel<<<n_lanes, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        ctx, bits, totals, probs, out, lens, consumed, n_lanes, n_bits,
        arena_size, max_out);
  }
  return static_cast<int>(cudaGetLastError());
}
