// The LZMA decode of one lane, shared by the decoder kernels
// (ring_decoder.cu, K1, whose lane works in device memory, and
// block_decoder.cu, K5, whose lane works in shared memory).
//
// decode_lane is the scalar decoder of lzma_tpu/runtime/src/lzma_core.cpp
// (RangeDecT, decode_block): the 5-byte range-decoder init, 11-bit
// adaptive bits with the >>5 update, direct bits, the literal / length /
// slot / reverse trees, the 12-state machine, the rep0-3 MTF, match copy
// and the distance, size and overrun checks.  Its outcome per lane
// (bytes, ok, final output position) is that of the lane-parallel FSM
// lzma_tpu_torch/ops/device_decoder.py _decode_fsm, the plain version of
// both kernels, including its error rules:
//   - a copy whose distance is >= the output position or >= dict_size,
//   - a negative distance that is not the end marker of an EOS lane,
//   - output past the lane's bound (the passing byte is counted),
//   - more than 40 renormalization bytes read past the stream's end
//     (the step that crosses it still completes, as in the FSM).
// The pointers are generic: the caller decides where the arena, the
// window and the input live.
//
// decode_lane<KO> takes a set of knock-out flags (kKo*, below) for the
// ablation probe csrc/probe_ablate.cu, the counterpart of the TPU's
// tools/probe_ring_ablate.py and probe_packed_ablate.py.  Each flag is
// tested with `if constexpr` at one site of the body, and the default, 0,
// is the decoder above: K1 and K5 instantiate decode_lane<0> and compile
// what they did before the flags existed.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Offsets of the flat probability arena (lzma_tpu/core/layout.py
// ProbLayout with pos_bits = pb), passed by value from the wrapper.  It
// names the C entries' parameters, so it lives outside the unnamed
// namespace (which would give the entries internal linkage).
struct LztLayout {
  int is_match, is_rep, is_rep_g0, is_rep_g1, is_rep_g2, is_rep0_long;
  int pos_slot, spec_pos, align, len_coder, rep_len_coder, literal, size;
  int pos_bits, len_choice, len_choice2, len_low, len_mid, len_high;
};

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kLiteralCoderSize = 0x300;
constexpr int kMaxOverrun = 40;

// Knock-out flags of decode_lane.  Every knock-out keeps the lane alive
// (kKoAlive): no error rule ends it, a copy reads its window at any
// distance (back() clamps the index) and stops at the bound, so a lane
// decodes until out_pos reaches its size whatever it decodes.
constexpr int kKoAlive = 1;     // error exits off
constexpr int kKoNoArena = 2;   // each probability read as 1024, never stored
constexpr int kKoNoInput = 4;   // renormalisation shifts in 0
constexpr int kKoNoWin = 8;     // back() gives 0; emit counts, stores nothing
constexpr int kKoNoRing = 16;   // emit counts, stores nothing (back() reads)
constexpr int kKoNoCtx = 32;    // every bit at a made-up index (site())
constexpr int kKoCount = 64;    // count bits decoded and bytes copied

template <int KO>
struct RcT {
  uint32_t range;
  uint32_t code;
  int in_pos;
  int overrun;
  const uint8_t* in;
  int in_len;
  int max_in;

  __device__ void normalize() {
    if (range < kTop) {
      uint32_t byte = 0;
      if (in_pos < in_len) {
        if constexpr (!(KO & kKoNoInput)) {
          byte = in[in_pos < max_in ? in_pos : max_in - 1];
        }
      } else {
        ++overrun;
      }
      ++in_pos;
      range <<= 8;
      code = (code << 8) | byte;
    }
  }

  __device__ int bit(uint16_t* prob) {
    uint32_t pr = 1024u;
    if constexpr (!(KO & kKoNoArena)) pr = *prob;
    const uint32_t bound = (range >> 11) * pr;
    int b;
    if (code < bound) {
      range = bound;
      if constexpr (!(KO & kKoNoArena)) {
        *prob = static_cast<uint16_t>(pr + ((2048u - pr) >> 5));
      }
      b = 0;
    } else {
      range -= bound;
      code -= bound;
      if constexpr (!(KO & kKoNoArena)) {
        *prob = static_cast<uint16_t>(pr - (pr >> 5));
      }
      b = 1;
    }
    normalize();
    return b;
  }

  __device__ int direct() {
    const uint32_t rd = range >> 1;
    // the reference's uint32 sign trick: 1 - ((code - rd) >> 31)
    const int b = 1 - static_cast<int>((code - rd) >> 31);
    if (b) code -= rd;
    range = rd;
    normalize();
    return b;
  }

  // a kept-alive lane never fails
  __device__ bool failed() const {
    if constexpr (KO & kKoAlive) return false;
    return overrun > kMaxOverrun;
  }
};

// Every decode step is followed by the overrun check; a failed lane
// stops at once (the FSM marks it ERROR in the same step).  site()
// gives the probability a bit decodes at (knocked out by kKoNoCtx) and
// counts the bit (kKoCount).
#define DEC_BIT(dst, prob)         \
  do {                             \
    (dst) = rc.bit(site(prob));    \
    if (rc.failed()) goto fail;    \
  } while (0)
#define DEC_DIRECT(dst)            \
  do {                             \
    (dst) = rc.direct();           \
    if constexpr (KO & kKoCount) ++n_dec; \
    if (rc.failed()) goto fail;    \
  } while (0)
// A literal bit: the FSM completes its step before it marks the lane
// failed, so an overrun on a literal's last bit still emits the byte.
#define LIT_BIT(prob)                                 \
  do {                                                \
    b = rc.bit(site(prob));                           \
    sym = (sym << 1) | static_cast<uint32_t>(b);      \
    if (rc.failed()) {                                \
      if (sym >= 0x100u) emit(sym & 0xFFu);           \
      goto fail;                                      \
    }                                                 \
  } while (0)

// Decode one lane.  `p` holds the arena set to 1024 and `o` the window
// of max_out bytes, primed with the P preset bytes (the rest as the
// caller left it); `in` is the lane's padded stream of max_in bytes, of
// which in_len are the stream.  size > 0 is the absolute end position;
// size = -cap marks an EOS lane.  Writes ok and the final output
// position, and under kKoCount the bits decoded to counts[0] and the
// bytes copied by matches to counts[1].
template <int KO = 0>
__device__ __forceinline__ void decode_lane(
    const uint8_t* in, int in_len, int max_in, uint16_t* p, uint8_t* o,
    int max_out, int P, int size, int dict_size, int lc, int lp, int pb,
    const LztLayout& L, bool* ok, int* out_pos_res, int* counts = nullptr) {
  constexpr bool kAlive = (KO & kKoAlive) != 0;
  RcT<KO> rc{0xFFFFFFFFu, 0, 5, 0, in, in_len, max_in};
  for (int i = 0; i < 5; ++i) {
    rc.code = (rc.code << 8) | (i < rc.in_len ? rc.in[i] : 0u);
  }

  const bool eos = size < 0;       // EOS lane: ends at the end marker
  // a kept-alive lane ends at its bound, so that bound stays in its row
  const int bound = kAlive ? min(eos ? -size : size, max_out)
                           : (eos ? -size : size);
  const int dict_check = dict_size > 1 ? dict_size : 1;
  const int pb_mask = (1 << pb) - 1;
  const int lp_mask = (1 << lp) - 1;

  int out_pos = P;
  int state = 0;
  int rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
  uint32_t prev = P ? o[P - 1] : 0u;
  bool good = false;
  int b;
  int n_dec = 0, n_copy = 0;  // bits decoded, bytes copied (kKoCount)

  // noctx's made-up index, (out_pos*7 + the bits decoded) mod the arena's
  // size, stepped by increments wrapped by a compare: no division on the
  // chain (L.size > 7)
  int ctx = 0;
  if constexpr (KO & kKoNoCtx) ctx = (P * 7) % L.size;

  auto back = [&](int dist) -> uint32_t {
    if constexpr (KO & kKoNoWin) return 0u;
    long long i = static_cast<long long>(out_pos) - dist - 1;
    i = i < 0 ? 0 : (i > max_out - 1 ? max_out - 1 : i);
    return o[i];
  };
  // a byte that passes the bound is still written (at most at the last
  // column) and counted before the lane fails, as in the FSM
  auto emit = [&](uint32_t byte) {
    if constexpr (!(KO & (kKoNoWin | kKoNoRing))) {
      o[out_pos < max_out ? out_pos : max_out - 1] = static_cast<uint8_t>(byte);
    }
    ++out_pos;
    if constexpr (KO & kKoNoCtx) {
      ctx += 7;
      if (ctx >= L.size) ctx -= L.size;
    }
  };
  auto site = [&](uint16_t* prob) -> uint16_t* {
    if constexpr (KO & kKoCount) ++n_dec;
    if constexpr (KO & kKoNoCtx) {
      if (++ctx == L.size) ctx = 0;
      return p + ctx;
    }
    return prob;
  };

  for (;;) {
    const int coded = out_pos - P;
    const int pos_state = coded & pb_mask;
    int len = 0;
    DEC_BIT(b, &p[L.is_match + (state << L.pos_bits) + pos_state]);
    if (b == 0) {
      // ---- literal (matched mode after a match) ----
      uint16_t* lit = p + L.literal +
          (((coded & lp_mask) << lc) + static_cast<int>(prev >> (8 - lc))) *
              kLiteralCoderSize;
      uint32_t sym = 1;
      if (state >= 7) {
        uint32_t mb = back(rep0);
        do {
          const uint32_t mbit = (mb >> 7) & 1u;
          mb <<= 1;
          LIT_BIT(&lit[((1u + mbit) << 8) + sym]);
          if (mbit != static_cast<uint32_t>(b)) break;
        } while (sym < 0x100u);
      }
      while (sym < 0x100u) LIT_BIT(&lit[sym]);
      prev = sym & 0xFFu;
      emit(prev);
      if (!kAlive && out_pos > bound) goto fail;
      state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
    } else {
      DEC_BIT(b, &p[L.is_rep + state]);
      int len_base;
      if (b == 0) {
        // ---- fresh match: shift the rep history now ----
        rep3 = rep2;
        rep2 = rep1;
        rep1 = rep0;
        len_base = L.len_coder;
      } else {
        DEC_BIT(b, &p[L.is_rep_g0 + state]);
        if (b == 0) {
          DEC_BIT(b, &p[L.is_rep0_long + (state << L.pos_bits) + pos_state]);
          if (b == 0) {  // short rep: one byte at rep0
            state = state < 7 ? 9 : 11;
            len = 1;
          }
        } else {
          DEC_BIT(b, &p[L.is_rep_g1 + state]);
          if (b == 0) {
            const int d = rep1;
            rep1 = rep0;
            rep0 = d;
          } else {
            DEC_BIT(b, &p[L.is_rep_g2 + state]);
            int d;
            if (b == 0) {
              d = rep2;
            } else {
              d = rep3;
              rep3 = rep2;
            }
            rep2 = rep1;
            rep1 = rep0;
            rep0 = d;
          }
        }
        len_base = L.rep_len_coder;
      }

      if (len == 0) {
        // ---- length: choice, choice2, then a low/mid/high tree ----
        int top, base_len;
        uint16_t* tree;
        DEC_BIT(b, &p[len_base + L.len_choice]);
        if (b == 0) {
          tree = p + len_base + L.len_low + (pos_state << 3);
          top = 8;
          base_len = 0;
        } else {
          DEC_BIT(b, &p[len_base + L.len_choice2]);
          if (b == 0) {
            tree = p + len_base + L.len_mid + (pos_state << 3);
            top = 8;
            base_len = 8;
          } else {
            tree = p + len_base + L.len_high;
            top = 256;
            base_len = 16;
          }
        }
        int m = 1;
        while (m < top) {
          DEC_BIT(b, &tree[m]);
          m = (m << 1) | b;
        }
        len = base_len + (m - top) + 2;

        if (len_base == L.len_coder) {
          // ---- distance of a fresh match ----
          state = state < 7 ? 7 : 10;
          const int lps = len - 2 < 3 ? len - 2 : 3;
          uint16_t* slot_tree = p + L.pos_slot + lps * 64;
          int s = 1;
          while (s < 64) {
            DEC_BIT(b, &slot_tree[s]);
            s = (s << 1) | b;
          }
          const int slot = s - 64;
          if (slot < 4) {
            rep0 = slot;
          } else {
            const int direct_bits = (slot >> 1) - 1;
            const uint32_t base = (2u | (static_cast<uint32_t>(slot) & 1u))
                                  << direct_bits;
            uint32_t rev = 0;
            if (slot < 14) {
              uint16_t* rt = p + L.spec_pos + base - slot - 1;
              int mm = 1;
              for (int i = 0; i < direct_bits; ++i) {
                DEC_BIT(b, &rt[mm]);
                mm = (mm << 1) | b;
                rev |= static_cast<uint32_t>(b) << i;
              }
              rep0 = static_cast<int>(base + rev);
            } else {
              uint32_t acc = 0;
              for (int i = 0; i < direct_bits - 4; ++i) {
                DEC_DIRECT(b);
                acc = (acc << 1) | static_cast<uint32_t>(b);
              }
              int mm = 1;
              for (int i = 0; i < 4; ++i) {
                DEC_BIT(b, &p[L.align + mm]);
                mm = (mm << 1) | b;
                rev |= static_cast<uint32_t>(b) << i;
              }
              const int dist = static_cast<int>(base + (acc << 4) + rev);
              if (dist == -1 && eos) {  // end marker
                good = true;
                break;
              }
              if (!kAlive && dist < 0) goto fail;
              rep0 = dist;
            }
          }
        } else {
          state = state < 7 ? 8 : 11;
        }
      }
      // ---- entering the copy: the distance must lie in the window ----
      if (!kAlive && (rep0 >= out_pos || rep0 >= dict_check)) goto fail;
      for (int k = 0; k < len; ++k) {
        prev = back(rep0);
        emit(prev);
        if constexpr (KO & kKoCount) ++n_copy;
        if constexpr (kAlive) {
          if (out_pos >= bound) break;
        } else {
          if (out_pos > bound) goto fail;
        }
      }
    }
    // a kept-alive lane ends at its bound even where it is an EOS lane
    if ((!eos || kAlive) && out_pos >= bound) {
      good = true;
      break;
    }
  }
fail:
  *ok = good;
  *out_pos_res = out_pos;
  if constexpr (KO & kKoCount) {
    counts[0] = n_dec;
    counts[1] = n_copy;
  }
}

#undef DEC_BIT
#undef DEC_DIRECT
#undef LIT_BIT

}  // namespace
