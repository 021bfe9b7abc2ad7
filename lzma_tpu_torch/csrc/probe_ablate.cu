// Ablation of K1's decode body: the Hopper counterpart of the TPU
// probes tools/probe_ring_ablate.py ablate (its pl.pallas_call at :177)
// and tools/probe_packed_ablate.py ablate (:165).
//
// The TPU probes ran "the genuine decode_pallas_ring body" with one part
// stubbed at a time, to find what a decode step costs.  On this card the
// genuine body is lzma_decode.cuh decode_lane, which K1
// (ring_decoder.cu) and K5 (block_decoder.cu) call; this kernel is K1's
// kernel, one lane a block with the arena and window in device memory,
// instantiated with decode_lane's knock-out flags.  Variants (the ids
// the wrapper lzma_tpu_torch/probes/probe_ring_ablate.py passes):
//   0 realrow   the exact body (error rules on), bits counted
//   1 full      the body with the lane kept alive (error exits off)
//   2 noctx     every bit at the index (out_pos*7 + bits) mod the
//               arena's size, stepped without a division; trees and
//               state run
//   3 noarena   every probability 1024, never stored
//   4 noinput   renormalisation shifts in 0
//   5 nowin     back() gives 0, no byte stored
//   6 noring    no byte stored (back() still reads)
//   7 notrans   one is_match bit a byte, no trees, no state change
//   8 barebit   one bit a byte at the index 8 * out_pos mod the arena's
//               size, stepped without a division
// notrans and barebit are not knock-outs at a site of decode_lane but
// a loop of their own here (one_bit_lane) over its range coder RcT.
// Every variant but realrow keeps its lanes alive, so a lane decodes to
// |size| bytes whatever it reads (the TPU probes did the same); their
// output is garbage and is used for timing only.  realrow and full on a
// valid stream give K1's bytes, ok flags and output positions.  Every
// variant writes, a lane, the bits it decodes, the bytes its matches
// copy and the SM cycles (clock64) its decode took (counts (N, 3)): a
// knock-out decodes another path than full, and its lanes differ, so
// its time is compared lane by lane, a step (a bit or a copied byte), a
// bit or a byte.
//
// What bounds it: one dependent chain of bit decodes a lane (the
// probability's load, a multiply, a compare, the store, a renormalising
// input load), one lane a block; the bytes it moves are a few per output
// byte.  The knock-outs measure what each part of that chain costs.

#include <cstdint>
#include <cuda_runtime.h>

#include "lzma_decode.cuh"

namespace {

// The one-bit loops' flags, above decode_lane's kKo* (which RcT reads).
constexpr int kOneBitCtx = 1 << 8;   // notrans
constexpr int kOneBitBare = 1 << 9;  // barebit

// notrans and barebit: one bit a byte, emitted as the byte before it
// plus the bit (decode_lane's back(rep0) with rep0 = 0), no trees and no
// state change, to the lane's bound.  notrans decodes at the is_match
// context of state 0; barebit at 8k for byte k (decode_lane's made-up
// index), wrapped by a compare.  Writes what decode_lane<kKoAlive |
// kKoCount> writes.
template <int KO>
__device__ void one_bit_lane(const uint8_t* in, int in_len, int max_in,
                             uint16_t* p, uint8_t* o, int max_out, int size,
                             int pb, const LztLayout& L, bool* ok,
                             int* out_pos_res, int* counts) {
  RcT<KO> rc{0xFFFFFFFFu, 0, 5, 0, in, in_len, max_in};
  for (int i = 0; i < 5; ++i) {
    rc.code = (rc.code << 8) | (i < rc.in_len ? rc.in[i] : 0u);
  }
  const int bound = min(size < 0 ? -size : size, max_out);
  const int pb_mask = (1 << pb) - 1;
  int out_pos = 0, idx = 0;
  while (out_pos < bound) {
    uint16_t* pr = p + L.is_match + (out_pos & pb_mask);
    if constexpr (KO & kOneBitBare) {
      pr = p + idx;
      idx += 8;
      if (idx >= L.size) idx -= L.size;
    }
    const uint32_t b = static_cast<uint32_t>(rc.bit(pr));
    o[out_pos] = static_cast<uint8_t>(o[out_pos > 0 ? out_pos - 1 : 0] + b);
    ++out_pos;
  }
  *ok = true;
  *out_pos_res = out_pos;
  counts[0] = out_pos;
  counts[1] = 0;
}

template <int KO>
__global__ void ablate_kernel(const uint8_t* __restrict__ comp,
                              const int* __restrict__ comp_lens,
                              const int* __restrict__ out_sizes,
                              uint16_t* __restrict__ probs,
                              uint8_t* __restrict__ out,
                              bool* __restrict__ ok,
                              int* __restrict__ out_pos_res,
                              int* __restrict__ counts, int n_lanes,
                              int max_in, int dict_size, int lc, int lp,
                              int pb, int max_out, LztLayout L) {
  const int lane = blockIdx.x;
  if (lane >= n_lanes || threadIdx.x != 0) return;
  uint16_t* p = probs + static_cast<size_t>(lane) * L.size;
  for (int i = 0; i < L.size; ++i) p[i] = 1024;
  const long long t0 = clock64();
  const uint8_t* in = comp + static_cast<size_t>(lane) * max_in;
  uint8_t* o = out + static_cast<size_t>(lane) * max_out;
  if constexpr (KO & (kOneBitCtx | kOneBitBare)) {
    one_bit_lane<KO>(in, comp_lens[lane], max_in, p, o, max_out,
                     out_sizes[lane], pb, L, ok + lane, out_pos_res + lane,
                     counts + 3 * lane);
  } else {
    decode_lane<KO>(in, comp_lens[lane], max_in, p, o, max_out, 0,
                    out_sizes[lane], dict_size, lc, lp, pb, L, ok + lane,
                    out_pos_res + lane, counts + 3 * lane);
  }
  counts[3 * lane + 2] = static_cast<int>(clock64() - t0);
}

using AblateFn = void (*)(const uint8_t*, const int*, const int*, uint16_t*,
                          uint8_t*, bool*, int*, int*, int, int, int, int,
                          int, int, int, LztLayout);

constexpr int kLive = kKoAlive | kKoCount;

AblateFn variant_kernel(int variant) {
  switch (variant) {
    case 0: return ablate_kernel<kKoCount>;
    case 1: return ablate_kernel<kLive>;
    case 2: return ablate_kernel<kLive | kKoNoCtx>;
    case 3: return ablate_kernel<kLive | kKoNoArena>;
    case 4: return ablate_kernel<kLive | kKoNoInput>;
    case 5: return ablate_kernel<kLive | kKoNoWin>;
    case 6: return ablate_kernel<kLive | kKoNoRing>;
    case 7: return ablate_kernel<kLive | kOneBitCtx>;
    case 8: return ablate_kernel<kLive | kOneBitBare>;
    default: return nullptr;
  }
}

}  // namespace

// Launch variant `variant` over n_lanes lanes; `out` must be zeroed by
// the caller.  Returns a CUDA error, or -1 for an unknown variant.
extern "C" int lzt_probe_ablate(int variant, const uint8_t* comp,
                                const int* comp_lens, const int* out_sizes,
                                uint16_t* probs, uint8_t* out, bool* ok,
                                int* out_pos, int* counts, int n_lanes,
                                int max_in, int dict_size, int lc, int lp,
                                int pb, int max_out, LztLayout layout,
                                void* stream) {
  AblateFn fn = variant_kernel(variant);
  if (fn == nullptr) return -1;
  if (n_lanes > 0) {
    fn<<<n_lanes, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        comp, comp_lens, out_sizes, probs, out, ok, out_pos, counts, n_lanes,
        max_in, dict_size, lc, lp, pb, max_out, layout);
  }
  return static_cast<int>(cudaGetLastError());
}
