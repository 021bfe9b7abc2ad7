// Ablation of K1's decode body: the Hopper counterpart of the TPU
// probes tools/probe_ring_ablate.py ablate (its pl.pallas_call at :177)
// and tools/probe_packed_ablate.py ablate (:165).
//
// The TPU probes ran "the genuine decode_pallas_ring body" with one part
// stubbed at a time, to find what a decode step costs.  On this card the
// genuine body is lzma_decode.cuh decode_lane, which K1
// (ring_decoder.cu) and K5 (block_decoder.cu) call; this kernel is K1's
// block (lzma_decode.cuh ring_block: the input staged in shared memory,
// the arena where cuda_ring.arena_placement puts it, the window in
// device memory), instantiated with decode_lane's knock-out flags.
// Variants (the ids the wrapper lzma_tpu_torch/probes/probe_ring_ablate.py
// passes):
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
//   9 barereg   barebit with the byte before kept in a register instead
//               of read back from the row it was just stored to
//  10 barefast  barereg with the fast body's bit (branch-free, its
//               probability loaded a bit ahead)
//  11 barechain  barefast storing no byte: the bit's chain alone
//  12 smemwin   full with the window in shared memory (rows up to the
//               card's shared memory less K1's): the same path and
//               bytes as full, so full - smemwin is what the window in
//               device memory costs
//  13 spans     realrow with clock64 spans by kind of symbol
//               (lzma_decode.cuh kSpan*) in counts[:, 3:8]; the clock
//               reads lengthen its time
//  14 ldgin     realrow reading the row straight from device memory
//               (through the read-only cache, K5's margin rule) instead
//               of K1's staged ring: the same path and bytes as realrow,
//               so ldgin - realrow is what the ring buys
// notrans and the bare bits are not knock-outs at a site of decode_lane
// but a loop of their own here (one_bit_lane) over its coder: the
// checked bit (the first version's) or, for barefast, the fast one.
// Every variant but realrow, spans and ldgin keeps its lanes alive, so a
// lane decodes to |size| bytes whatever it reads (the TPU probes did the
// same); their output is garbage and is used for timing only.  realrow,
// spans, ldgin and full on a valid stream give K1's bytes, ok flags and
// output positions (realrow, spans and ldgin on any stream).  Every
// variant writes, a lane, the bits it decodes, the bytes its matches
// copy and the SM cycles (clock64) its decode took (counts (N, 8), the
// last five columns spans's and 0 elsewhere): a
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

// The one-bit loops' flags, above decode_lane's kKo*.
constexpr int kOneBitCtx = 1 << 8;    // notrans
constexpr int kOneBitBare = 1 << 9;   // barebit
constexpr int kOneBitReg = 1 << 10;   // barereg
constexpr int kOneBitFast = 1 << 11;  // barefast
constexpr int kOneBitChain = 1 << 12; // barechain (with kOneBitFast)
constexpr int kOneBit = kOneBitCtx | kOneBitBare | kOneBitReg | kOneBitFast;
constexpr int kWinSmem = 1 << 13;     // smemwin
constexpr int kLdgIn = 1 << 14;       // ldgin
// counts a lane: bits, copied bytes, cycles, then kSpans spans
constexpr int kCounts = 3 + kSpans;

// notrans and the bare bits: one bit a byte, emitted as the byte before
// it plus the bit (decode_lane's back(rep0) with rep0 = 0), no trees and
// no state change, to the lane's bound.  notrans decodes at the is_match
// context of state 0; the bare bits at 8k for byte k (decode_lane's
// made-up index), wrapped by a compare.  Writes what decode_lane<kKoAlive
// | kKoCount> writes.
template <int KO, class Ar>
__device__ void one_bit_lane(RingIn& in, Ar a, DevWin w, int max_out,
                             int size, int pb, const LztLayout& L, bool* ok,
                             int* out_pos_res, int* counts) {
  constexpr int kCoder = KO & (kKoAlive | kKoNoArena | kKoNoInput);
  Lane<kCoder, RingIn, Ar, DevWin> s{in, a, w, L};
  s.range = 0xFFFFFFFFu;
  s.code = 0;
  s.in_pos = 5;
  s.overrun = 0;
  s.start();
  const int bound = min(size < 0 ? -size : size, max_out);
  const int pb_mask = (1 << pb) - 1;
  int out_pos = 0, idx = 0, in_fast = -1;
  uint32_t prev = 0;
  uint32_t pr = s.ld(0);
  while (out_pos < bound) {
    if (s.in_pos >= in_fast) in_fast = in.refill(s.in_pos);
    int i = L.is_match + (out_pos & pb_mask);
    if constexpr (KO & (kOneBitBare | kOneBitReg | kOneBitFast)) {
      i = idx;
      idx += 8;
      if (idx >= L.size) idx -= L.size;
    }
    uint32_t b;
    if constexpr (KO & kOneBitFast) {
      // the next bit's probability loads before this one's store (the
      // indexes differ: L.size > 8)
      const uint32_t pn = s.ld(idx);
      b = s.in_pos < in_fast ? s.fbit(pr, i) : s.cbit(i);
      pr = pn;
    } else {
      b = s.cbit(i);
    }
    if constexpr (KO & (kOneBitReg | kOneBitFast)) {
      prev = (prev + b) & 0xFFu;
    } else {
      prev = w.load(out_pos > 0 ? out_pos - 1 : 0) + b;
    }
    if constexpr (!(KO & kOneBitChain)) w.store(out_pos, prev);
    ++out_pos;
  }
  in.finish();
  *ok = true;
  *out_pos_res = out_pos;
  counts[0] = out_pos;
  counts[1] = 0;
}

// ldgin's input: the row in device memory, read by __ldg; a fast symbol
// may start while kInMargin of its bytes remain (SmemIn's rule).
struct LdgIn {
  const uint8_t* row;
  int in_len, lim;
  uint32_t last;
  __device__ __forceinline__ uint32_t at(int i) const { return __ldg(row + i); }
  __device__ __forceinline__ int refill(int) { return lim - kInMargin + 1; }
  __device__ __forceinline__ void finish() {}
};

template <int KO, bool kShared>
__global__ void __launch_bounds__(kRingThreads)
    ablate_kernel(const uint8_t* __restrict__ comp,
                  const int* __restrict__ comp_lens,
                  const int* __restrict__ out_sizes,
                  uint16_t* __restrict__ probs, uint8_t* __restrict__ out,
                  bool* __restrict__ ok, int* __restrict__ out_pos_res,
                  int* __restrict__ counts, int max_in, int dict_size, int lc,
                  int lp, int pb, int max_out, LztLayout L) {
  const int lane = blockIdx.x;
  uint8_t* o = out + static_cast<size_t>(lane) * max_out;
  ring_block<kShared>(
      comp + static_cast<size_t>(lane) * max_in, comp_lens[lane], max_in,
      nullptr, 0,
      kShared ? nullptr : probs + static_cast<size_t>(lane) * L.size, o, L,
      [&](RingIn& in, Arena<kShared> arena, DevWin win) {
        int* c = counts + kCounts * lane;
        if constexpr (KO & kLdgIn) {
          in.finish();  // the producer warp stages nothing more
          const uint8_t* row = comp + static_cast<size_t>(lane) * max_in;
          const int in_len = comp_lens[lane];
          LdgIn g{row, in_len, min(in_len, max_in),
                  in_len > max_in && max_in > 0 ? row[max_in - 1] : 0u};
          const long long t0 = clock64();
          decode_lane<KO & ~kLdgIn>(g, arena, win, max_out, 0,
                                    out_sizes[lane], dict_size, lc, lp, pb, L,
                                    ok + lane, out_pos_res + lane, c);
          c[2] = static_cast<int>(clock64() - t0);
          return;
        }
        if constexpr (KO & kWinSmem) {
          // the window after the arena, zeroed; written back at the end
          const uint32_t wb = arena.base + (2u * L.size + 15u) / 16u * 16u;
          for (int k = 0; k < max_out; ++k) sts_u8(wb + k, 0);
          const long long t0 = clock64();
          decode_lane<KO & ~kWinSmem>(in, arena, SmemWin{wb}, max_out, 0,
                                      out_sizes[lane], dict_size, lc, lp, pb,
                                      L, ok + lane, out_pos_res + lane, c);
          c[2] = static_cast<int>(clock64() - t0);
          for (int k = 0; k < max_out; ++k) win.store(k, lds_u8(wb + k));
          return;
        }
        const long long t0 = clock64();
        if constexpr (KO & kOneBit) {
          one_bit_lane<KO>(in, arena, win, max_out, out_sizes[lane], pb, L,
                           ok + lane, out_pos_res + lane, c);
        } else {
          decode_lane<KO>(in, arena, win, max_out, 0, out_sizes[lane],
                          dict_size, lc, lp, pb, L, ok + lane,
                          out_pos_res + lane, c);
        }
        c[2] = static_cast<int>(clock64() - t0);
      });
}

using AblateFn = void (*)(const uint8_t*, const int*, const int*, uint16_t*,
                          uint8_t*, bool*, int*, int*, int, int, int, int,
                          int, int, LztLayout);

constexpr int kLive = kKoAlive | kKoCount;

template <bool kShared>
AblateFn variant_kernel(int variant) {
  switch (variant) {
    case 0: return ablate_kernel<kKoCount, kShared>;
    case 1: return ablate_kernel<kLive, kShared>;
    case 2: return ablate_kernel<kLive | kKoNoCtx, kShared>;
    case 3: return ablate_kernel<kLive | kKoNoArena, kShared>;
    case 4: return ablate_kernel<kLive | kKoNoInput, kShared>;
    case 5: return ablate_kernel<kLive | kKoNoWin, kShared>;
    case 6: return ablate_kernel<kLive | kKoNoRing, kShared>;
    case 7: return ablate_kernel<kLive | kOneBitCtx, kShared>;
    case 8: return ablate_kernel<kLive | kOneBitBare, kShared>;
    case 9: return ablate_kernel<kLive | kOneBitReg, kShared>;
    case 10: return ablate_kernel<kLive | kOneBitFast, kShared>;
    case 11: return ablate_kernel<kLive | kOneBitFast | kOneBitChain, kShared>;
    case 12:
      if constexpr (kShared) return ablate_kernel<kLive | kWinSmem, true>;
      return nullptr;
    case 13: return ablate_kernel<kKoCount | kKoSpans, kShared>;
    case 14: return ablate_kernel<kKoCount | kLdgIn, kShared>;
    default: return nullptr;
  }
}

}  // namespace

// Launch variant `variant` over n_lanes lanes; `out` must be zeroed by
// the caller.  shared is K1's (cuda_ring.arena_placement), and so is the
// block's dynamic shared memory (ring_smem_bytes; smemwin adds max_out
// rounded up to 16 B and needs the shared arena); probs (n_lanes x
// layout.size uint16) is used when the arena is in device memory.
// Returns a CUDA error, or -1 for an unknown variant or a device arena
// without probs.
extern "C" int lzt_probe_ablate(int variant, const uint8_t* comp,
                                const int* comp_lens, const int* out_sizes,
                                uint16_t* probs, uint8_t* out, bool* ok,
                                int* out_pos, int* counts, int n_lanes,
                                int max_in, int dict_size, int lc, int lp,
                                int pb, int max_out, int shared,
                                LztLayout layout, void* stream) {
  AblateFn fn = shared ? variant_kernel<true>(variant)
                       : variant_kernel<false>(variant);
  if (fn == nullptr || (!shared && probs == nullptr)) return -1;
  const int smem_bytes = static_cast<int>(
      ring_smem_bytes(shared != 0, layout.size) +
      (variant == 12 ? (max_out + 15LL) / 16 * 16 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    fn<<<n_lanes, kRingThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        comp, comp_lens, out_sizes, probs, out, ok, out_pos, counts, max_in,
        dict_size, lc, lp, pb, max_out, layout);
  }
  return static_cast<int>(cudaGetLastError());
}
