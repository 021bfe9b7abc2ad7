// The LZMA decode of one lane, shared by the decoder kernels
// (ring_decoder.cu, K1, whose window is the lane's output row in device
// memory, and block_decoder.cu, K5, whose lane lives in shared memory),
// and K1's block: its staged input and its arena placement.
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
//
// One body, two speeds.  A symbol (a literal, a match with its length
// and distance, a rep) reads at most kInMargin input bytes (one a bit,
// kSymbolMaxBits bits in the longest) and writes at most kMatchMaxLen
// output bytes.  While the lane has that much margin before the end of
// its input and before its bound and its row, no per-bit or per-byte
// check can fire inside the symbol, so the fast symbol (fast_symbol)
// has none: no overrun count, no clamp on an input or window index, no
// bound check on a copied byte.  It keeps the checks that belong to a
// symbol: the distance check on entering a copy, the end marker of an
// EOS lane, and the test that the lane has reached its end.  Its bits
// are branch-free (range, code and the probability updated by selects,
// the renormalisation a predicated shift of the next input byte, read
// every bit), and in every tree both children of the next level are
// loaded while the current bit decodes, then one is picked by the bit;
// the fixed-depth trees (literal 8, length 3 or 8, slot 6, align 4) are
// unrolled.  A tree never reads an address before the store to it that
// precedes it in program order: a level's children are other nodes than
// the level's own.  When the margin runs out, the lane goes on in the
// checked symbol (checked_symbol), the first version's body, from the
// same state; a check that can fire is only ever in that unchanged code,
// which gives the FSM's outcome on failures, truncations and tails.
//
// decode_lane<KO> takes a set of knock-out flags (kKo*, below) for the
// ablation probe csrc/probe_ablate.cu, the counterpart of the TPU's
// tools/probe_ring_ablate.py and probe_packed_ablate.py.  Each flag is
// tested with `if constexpr` at its sites, and the default, 0, is the
// decoder above: K1 and K5 instantiate decode_lane<0>.

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
constexpr int kMatchMaxLen = 273;
// The longest symbol: is_match, is_rep, the two length choices, the
// 8-bit high length tree, the 6-bit slot tree, slot 63's 26 direct bits
// and the 4-bit align tree.  A bit renormalises at most once (an
// adaptive bit leaves range >= 2^24 >> 11 * 31, a direct bit range / 2),
// reading one byte, so a symbol reads at most kInMargin bytes.
constexpr int kSymbolMaxBits = 1 + 1 + 2 + 8 + 6 + 26 + 4;
constexpr int kInMargin = kSymbolMaxBits;

// Knock-out flags of decode_lane.  Every knock-out keeps the lane alive
// (kKoAlive): no error rule ends it, a copy reads its window at any
// distance (the index is clamped) and stops at the bound, so a lane
// decodes until out_pos reaches its size whatever it decodes.
constexpr int kKoAlive = 1;     // error exits off
constexpr int kKoNoArena = 2;   // each probability read as 1024, never stored
constexpr int kKoNoInput = 4;   // renormalisation shifts in 0
constexpr int kKoNoWin = 8;     // the window reads 0; nothing stored
constexpr int kKoNoRing = 16;   // no byte stored (the window still reads)
constexpr int kKoNoCtx = 32;    // every bit at a made-up index (site())
constexpr int kKoCount = 64;    // count bits decoded and bytes copied
constexpr int kKoSpans = 128;   // clock64 spans by kind of symbol (kSpan*)

// The spans of kKoSpans: SM cycles in fast plain literals, fast matched
// literals, fast matches and reps less their copies, fast copies, and
// checked symbols (counts[3 + kind]).
constexpr int kSpanPlain = 0, kSpanMatched = 1, kSpanMatch = 2,
              kSpanCopy = 3, kSpanChecked = 4, kSpans = 5;

// Symbol outcomes.
constexpr int kGoOn = 0;
constexpr int kEnd = 1;    // the end marker of an EOS lane
constexpr int kFail = 2;

__device__ __forceinline__ uint32_t lds_u8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_u8(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_u16(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ __forceinline__ int ldv_s32(uint32_t a) {
  int v;
  asm volatile("ld.volatile.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void stv_s32(uint32_t a, int v) {
  asm volatile("st.volatile.shared.s32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
// A shared address read back through a volatile load, so that the
// compiler keeps it in a register: left alone it recomputes a shared
// base (an S2R of the CTA's window) at its uses (rc_serializer.cu).
__device__ __forceinline__ uint32_t pinned(uint32_t a, uint32_t slot) {
  stv_s32(slot, static_cast<int>(a));
  return static_cast<uint32_t>(ldv_s32(slot));
}

// The uint16 arena: in shared memory, addressed by a 32-bit shared
// address held in a register, or in device memory.
template <bool kShared>
struct Arena;
template <>
struct Arena<true> {
  uint32_t base;
  __device__ __forceinline__ uint32_t load(int i) const {
    return lds_u16(base + 2u * i);
  }
  __device__ __forceinline__ void store(int i, uint32_t v) const {
    sts_u16(base + 2u * i, v);
  }
};
template <>
struct Arena<false> {
  uint16_t* p;
  __device__ __forceinline__ uint32_t load(int i) const { return p[i]; }
  __device__ __forceinline__ void store(int i, uint32_t v) const {
    p[i] = static_cast<uint16_t>(v);
  }
};

// The window: the lane's output row in device memory (K1) or in shared
// memory (K5).
struct DevWin {
  uint8_t* o;
  __device__ __forceinline__ uint32_t load(int i) const { return o[i]; }
  __device__ __forceinline__ void store(int i, uint32_t v) const {
    o[i] = static_cast<uint8_t>(v);
  }
};
struct SmemWin {
  uint32_t base;
  __device__ __forceinline__ uint32_t load(int i) const {
    return lds_u8(base + i);
  }
  __device__ __forceinline__ void store(int i, uint32_t v) const {
    sts_u8(base + i, v);
  }
};

// The input of K5: the whole padded stream in shared memory.  lim =
// min(in_len, max_in) bytes are the stream's; a read at i in [lim,
// in_len) (a length past the row) gives the row's last byte, `last`, as
// the plain version's clamped index does.  refill() gives the input
// position below which a fast symbol may start.
struct SmemIn {
  uint32_t base;
  int in_len, lim;
  uint32_t last;
  __device__ __forceinline__ uint32_t at(int i) const { return lds_u8(base + i); }
  __device__ __forceinline__ int refill(int) { return lim - kInMargin + 1; }
  __device__ __forceinline__ void finish() {}
};

// ---------------------------------------------------------------------
// K1's staged input: the lane's stream comes into a ring of two tiles of
// kInTile bytes in shared memory by 4-byte cp.async, double-buffered: a
// producer warp stages tile k + 1 while the decoding thread reads tile
// k.  Tiles are counted in ring coordinates r = in_pos + shift, where
// shift = the row's base & 3 (a 4-byte copy needs a 4-byte aligned
// source; the bytes before the row in tile 0 are never read).  Control
// words in shared memory: cur, the tile the decoder reads (published
// when it enters a tile, which frees the slot of the tile before it;
// kDone when the lane ends), and ready, the last tile staged.
constexpr int kInTileLog = 12;
constexpr int kInTile = 1 << kInTileLog;   // bytes a tile (cuda_ring.IN_TILE)
constexpr int kRingMask = 2 * kInTile - 1;
constexpr int kDone = 0x7FFFFFFF;
constexpr int kCtrlBytes = 16;             // cur, ready, the pinned base

// The dynamic shared memory of K1's block (ring_block): the control
// words, the two tiles and, when the arena is in shared memory, its
// uint16s rounded up to 16 B (cuda_ring.smem_bytes).
inline long long ring_smem_bytes(bool shared_arena, int arena_size) {
  return kCtrlBytes + 2LL * kInTile +
         (shared_arena ? (2LL * arena_size + 15) / 16 * 16 : 0);
}

struct RingIn {
  uint32_t ring, ctrl;
  int shift, in_len, lim, end_r, cur, ready;
  uint32_t last;
  __device__ __forceinline__ uint32_t at(int i) const {
    return lds_u8(ring + ((i + shift) & kRingMask));
  }
  // At a symbol's start: publish the tile in_pos is in, wait until the
  // bytes a symbol may read from in_pos are staged, and give the input
  // position below which a fast symbol may start: its bytes are staged
  // and it stays in this tile (so that the next tile is published on
  // entering it).  A lane with no input (lim <= 0) has no tile to wait
  // for: its checked symbols read `last` or count an overrun.
  __device__ __forceinline__ int refill(int in_pos) {
    const int r = in_pos + shift;
    const int c = r >> kInTileLog;
    if (c > cur) {
      cur = c;
      stv_s32(ctrl, c);
    }
    const int need =
        lim > 0 ? (min(r + kInMargin, end_r) - 1) >> kInTileLog : -1;
    if (need > ready) {
      do {
        ready = ldv_s32(ctrl + 4);
      } while (ready < need);
      __threadfence_block();
    }
    const int staged_end = min(end_r, (ready + 1) << kInTileLog);
    return min(staged_end - kInMargin + 1, (cur + 1) << kInTileLog) - shift;
  }
  __device__ __forceinline__ void finish() { stv_s32(ctrl, kDone); }
};

__device__ __forceinline__ void async4(uint32_t dst, const uint8_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Tile k of the ring by the producer warp: its whole 4-byte words by
// cp.async, the bytes of a last partial word by plain loads; then waits
// for them.  abase is the row's base less shift (4-byte aligned).
__device__ __forceinline__ void stage_in_tile(uint32_t ring,
                                              const uint8_t* abase, int k,
                                              int end_r, int lane) {
  const int first = k << kInTileLog;
  const int stop = min(first + kInTile, end_r);
  const int words_end = first + ((stop - first) & ~3);
  for (int q = first + 4 * lane; q < words_end; q += 128) {
    async4(ring + (q & kRingMask), abase + q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (lane < stop - words_end) {
    const int q = words_end + lane;
    sts_u8(ring + (q & kRingMask), abase[q]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __threadfence_block();
  __syncwarp();
}

// ---------------------------------------------------------------------
// The state of one lane's decode and its two symbol bodies.
template <int KO, class In, class Ar, class Win>
struct Lane {
  static constexpr bool kAlive = (KO & kKoAlive) != 0;

  In& in;
  Ar a;
  Win w;
  const LztLayout& L;
  int P, max_out, bound, dict_check, lc, pb_mask, lp_mask;
  bool eos;

  uint32_t range, code;
  int in_pos, overrun;
  int out_pos, state, rep0, rep1, rep2, rep3;
  uint32_t prev;
  int n_dec, n_copy;  // bits decoded, bytes copied (kKoCount)
  long long span[kSpans];  // kKoSpans
  int kind;                // the last fast symbol's kSpan*
  long long copy_t;        // its copy's cycles
  // noctx's made-up index, (out_pos*7 + the bits decoded) mod the
  // arena's size, stepped by increments wrapped by a compare (L.size > 7)
  int ctx;

  // ---- probabilities, bytes and the noctx index, by the flags
  __device__ __forceinline__ uint32_t ld(int i) const {
    if constexpr (KO & kKoNoArena) return 1024u;
    return a.load(i);
  }
  __device__ __forceinline__ void st(int i, uint32_t v) const {
    if constexpr (!(KO & kKoNoArena)) a.store(i, v);
  }
  __device__ __forceinline__ int site(int i) {
    if constexpr (KO & kKoCount) ++n_dec;
    if constexpr (KO & kKoNoCtx) {
      if (++ctx == L.size) ctx = 0;
      return ctx;
    }
    return i;
  }
  __device__ __forceinline__ void ctx_bytes(int n) {
    if constexpr (KO & kKoNoCtx) {
      ctx += 7 * n;
      while (ctx >= L.size) ctx -= L.size;
    }
  }
  __device__ __forceinline__ uint32_t win_at(int i) const {
    if constexpr (KO & kKoNoWin) return 0u;
    return w.load(i);
  }
  __device__ __forceinline__ void win_put(int i, uint32_t v) const {
    if constexpr (!(KO & (kKoNoWin | kKoNoRing))) w.store(i, v);
  }

  // ---- the fast bits: no check, no branch
  __device__ __forceinline__ void fnorm(uint32_t nb) {
    const bool need = range < kTop;
    range = need ? range << 8 : range;
    code = need ? (code << 8) | nb : code;
    in_pos += need ? 1 : 0;
  }
  __device__ __forceinline__ uint32_t next_byte() const {
    if constexpr (KO & kKoNoInput) return 0u;
    return in.at(in_pos);
  }
  // an adaptive bit at arena index i whose probability pr was loaded ahead
  __device__ __forceinline__ uint32_t fbit(uint32_t pr, int i) {
    const uint32_t nb = next_byte();
    if constexpr (KO & (kKoNoCtx | kKoCount)) {
      const int s = site(i);
      if constexpr (KO & kKoNoCtx) {
        i = s;
        pr = ld(i);
      }
    }
    const uint32_t bnd = (range >> 11) * pr;
    const bool one = code >= bnd;
    range = one ? range - bnd : bnd;
    code = one ? code - bnd : code;
    st(i, one ? pr - (pr >> 5) : pr + ((2048u - pr) >> 5));
    fnorm(nb);
    return one ? 1u : 0u;
  }
  __device__ __forceinline__ uint32_t fdirect() {
    if constexpr (KO & kKoCount) ++n_dec;
    const uint32_t nb = next_byte();
    range >>= 1;
    const uint32_t t = code - range;
    // the reference's uint32 sign trick: 1 - ((code - rd) >> 31)
    const uint32_t b = 1u - (t >> 31);
    code = b ? t : code;
    fnorm(nb);
    return b;
  }
  // A forward tree of D levels at arena index t (nodes t + 1 ..), its
  // root's probability loaded: both children of the next level load
  // while a level decodes.  Returns the node index m, 2^D <= m < 2^(D+1).
  template <int D>
  __device__ __forceinline__ uint32_t ftree(int t, uint32_t pr) {
    uint32_t m = 1;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      uint32_t p0 = 0, p1 = 0;
      if (k + 1 < D) {
        p0 = ld(t + 2 * m);
        p1 = ld(t + 2 * m + 1);
      }
      const uint32_t b = fbit(pr, t + m);
      m = 2 * m + b;
      pr = b ? p1 : p0;
    }
    return m;
  }
  // A reverse tree of n levels (n <= 5) at arena index t: the same walk
  // of nodes; the bits make the value low bit first.  Unrolled where n is
  // a constant at the call (align's 4).
  __device__ __forceinline__ uint32_t frev(int t, int n) {
    uint32_t m = 1, rev = 0;
    uint32_t pr = ld(t + 1);
#pragma unroll
    for (int k = 0; k < n; ++k) {
      uint32_t p0 = 0, p1 = 0;
      if (k + 1 < n) {
        p0 = ld(t + 2 * m);
        p1 = ld(t + 2 * m + 1);
      }
      const uint32_t b = fbit(pr, t + m);
      m = 2 * m + b;
      rev |= b << k;
      pr = b ? p1 : p0;
    }
    return rev;
  }

  // A matched literal: 8 levels at arena index lit, its match byte mb;
  // both candidates of the next level load while a level decodes.
  // Returns the node index, 256 <= sym < 512.
  __device__ __forceinline__ uint32_t fmatched(int lit, uint32_t mb) {
    uint32_t offs = 0x100u;
    uint32_t mm = mb << 1;
    uint32_t bitv = offs;
    offs &= mm;
    uint32_t sym = 1;
    int idx = static_cast<int>(offs + bitv + 1);
    uint32_t pr = ld(lit + idx);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t mn = mm << 1;
      const uint32_t o0 = offs ^ bitv, o1 = offs;
      const int i0 = static_cast<int>((o0 & mn) + o0 + 2 * sym);
      const int i1 = static_cast<int>((o1 & mn) + o1 + 2 * sym + 1);
      uint32_t p0 = 0, p1 = 0;
      if (k < 7) {
        p0 = ld(lit + i0);
        p1 = ld(lit + i1);
      }
      const uint32_t b = fbit(pr, lit + idx);
      sym = 2 * sym + b;
      const uint32_t on = b ? o1 : o0;
      bitv = on;
      offs = on & mn;
      mm = mn;
      idx = b ? i1 : i0;
      pr = b ? p1 : p0;
    }
    return sym;
  }

  // The copy of len bytes at rep0 (checked on entry): every source byte
  // lies before out_pos (byte k is at out_pos - d + k mod d, d = rep0 +
  // 1), so a batch of 8 loads issues before its 8 stores.  A kept-alive
  // lane clamps d into [1, out_pos] and the index at 0.
  __device__ __forceinline__ void fcopy(int len) {
    long long t0 = 0;
    if constexpr (KO & kKoSpans) t0 = clock64();
    int d = rep0 + 1;
    if constexpr (kAlive) d = max(1, min(d, out_pos));
    const int src = out_pos - d;
    int j = 0;
    for (int k = 0; k < len; k += 8) {
      uint32_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        int i = src + j;
        if constexpr (kAlive) i = max(i, 0);
        v[u] = k + u < len ? win_at(i) : 0u;
        j = j + 1 == d ? 0 : j + 1;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k + u < len) {
          win_put(out_pos + k + u, v[u]);
          prev = v[u];
        }
      }
    }
    out_pos += len;
    ctx_bytes(len);
    if constexpr (KO & kKoCount) n_copy += len;
    if constexpr (KO & kKoSpans) copy_t = clock64() - t0;
  }

  // One symbol with a margin of kInMargin input bytes and kMatchMaxLen
  // output bytes.
  __device__ __forceinline__ int fast_symbol() {
    const int coded = out_pos - P;
    const int pos_state = coded & pb_mask;
    const int im = L.is_match + (state << L.pos_bits) + pos_state;
    const int lit = L.literal +
        (((coded & lp_mask) << lc) + static_cast<int>(prev >> (8 - lc))) *
            kLiteralCoderSize;
    const bool matched = state >= 7;
    // loaded ahead: is_match, is_rep, the match byte of a matched
    // literal and a plain literal's root
    uint32_t mb = 0;
    if (matched) {
      int i = out_pos - rep0 - 1;
      if constexpr (kAlive) i = min(max(i, 0), max_out - 1);
      mb = win_at(i);
    }
    const uint32_t p_im = ld(im);
    const uint32_t p_rep = ld(L.is_rep + state);
    const uint32_t p_lit1 = ld(lit + 1);
    if (fbit(p_im, im) == 0) {
      // ---- literal: a plain one is an 8-level tree; a matched one
      // walks in LzmaDec.c's offs/bit form (offs 0x100 until its first
      // mismatch, then 0: the plain tree's nodes)
      uint32_t sym;
      if (!matched) {
        sym = ftree<8>(lit, p_lit1);
      } else {
        sym = fmatched(lit, mb);
      }
      if constexpr (KO & kKoSpans) kind = matched ? kSpanMatched : kSpanPlain;
      prev = sym & 0xFFu;
      win_put(out_pos, prev);
      ++out_pos;
      ctx_bytes(1);
      state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
      return kGoOn;
    }
    if constexpr (KO & kKoSpans) kind = kSpanMatch;
    int len = 0, len_base;
    const int g0 = L.is_rep_g0 + state;
    const uint32_t p_g0 = ld(g0);
    if (fbit(p_rep, L.is_rep + state) == 0) {
      // ---- fresh match: shift the rep history now
      rep3 = rep2;
      rep2 = rep1;
      rep1 = rep0;
      len_base = L.len_coder;
    } else {
      const int r0l = L.is_rep0_long + (state << L.pos_bits) + pos_state;
      const uint32_t p_r0l = ld(r0l), p_g1 = ld(L.is_rep_g1 + state);
      if (fbit(p_g0, g0) == 0) {
        if (fbit(p_r0l, r0l) == 0) {  // short rep: one byte at rep0
          state = state < 7 ? 9 : 11;
          len = 1;
        }
      } else {
        const uint32_t p_g2 = ld(L.is_rep_g2 + state);
        if (fbit(p_g1, L.is_rep_g1 + state) == 0) {
          const int d = rep1;
          rep1 = rep0;
          rep0 = d;
        } else {
          int d;
          if (fbit(p_g2, L.is_rep_g2 + state) == 0) {
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
      // ---- length: choice, choice2, then a low/mid/high tree, each
      // next root loaded while the choice before it decodes
      const int ch = len_base + L.len_choice, ch2 = len_base + L.len_choice2;
      const int low = len_base + L.len_low + (pos_state << 3);
      const int mid = len_base + L.len_mid + (pos_state << 3);
      const int high = len_base + L.len_high;
      const uint32_t p_ch = ld(ch), p_ch2 = ld(ch2), p_low = ld(low + 1);
      if (fbit(p_ch, ch) == 0) {
        len = static_cast<int>(ftree<3>(low, p_low)) - 8 + 2;
      } else {
        const uint32_t p_mid = ld(mid + 1), p_high = ld(high + 1);
        if (fbit(p_ch2, ch2) == 0) {
          len = static_cast<int>(ftree<3>(mid, p_mid)) - 8 + 8 + 2;
        } else {
          len = static_cast<int>(ftree<8>(high, p_high)) - 256 + 16 + 2;
        }
      }

      if (len_base == L.len_coder) {
        // ---- distance of a fresh match
        state = state < 7 ? 7 : 10;
        const int lps = len - 2 < 3 ? len - 2 : 3;
        const int slot_tree = L.pos_slot + lps * 64;
        const int slot =
            static_cast<int>(ftree<6>(slot_tree, ld(slot_tree + 1))) - 64;
        if (slot < 4) {
          rep0 = slot;
        } else {
          const int direct_bits = (slot >> 1) - 1;
          const uint32_t base = (2u | (static_cast<uint32_t>(slot) & 1u))
                                << direct_bits;
          if (slot < 14) {
            rep0 = static_cast<int>(
                base + frev(L.spec_pos + static_cast<int>(base) - slot - 1,
                            direct_bits));
          } else {
            uint32_t acc = 0;
            for (int i = 0; i < direct_bits - 4; ++i) {
              acc = (acc << 1) | fdirect();
            }
            const int dist =
                static_cast<int>(base + (acc << 4) + frev(L.align, 4));
            if (dist == -1 && eos) return kEnd;  // end marker
            if (!kAlive && dist < 0) return kFail;
            rep0 = dist;
          }
        }
      } else {
        state = state < 7 ? 8 : 11;
      }
    }
    // ---- entering the copy: the distance must lie in the window
    if (!kAlive && (rep0 >= out_pos || rep0 >= dict_check)) return kFail;
    fcopy(len);
    return kGoOn;
  }

  // ---- the checked body (the first version's): every bit checks the
  // overrun, every window index is clamped, every byte the bound
  __device__ __forceinline__ uint32_t in_byte(int i) const {
    return i < in.lim ? in.at(i) : in.last;
  }
  __device__ __forceinline__ void cnorm() {
    if (range < kTop) {
      uint32_t byte = 0;
      if (in_pos < in.in_len) {
        if constexpr (!(KO & kKoNoInput)) byte = in_byte(in_pos);
      } else {
        ++overrun;
      }
      ++in_pos;
      range <<= 8;
      code = (code << 8) | byte;
    }
  }
  __device__ __forceinline__ uint32_t cbit(int i) {
    i = site(i);
    const uint32_t pr = ld(i);
    const uint32_t bnd = (range >> 11) * pr;
    uint32_t b;
    if (code < bnd) {
      range = bnd;
      st(i, pr + ((2048u - pr) >> 5));
      b = 0;
    } else {
      range -= bnd;
      code -= bnd;
      st(i, pr - (pr >> 5));
      b = 1;
    }
    cnorm();
    return b;
  }
  __device__ __forceinline__ uint32_t cdirect() {
    if constexpr (KO & kKoCount) ++n_dec;
    const uint32_t rd = range >> 1;
    const uint32_t b = 1u - ((code - rd) >> 31);
    if (b) code -= rd;
    range = rd;
    cnorm();
    return b;
  }
  // a kept-alive lane never fails
  __device__ __forceinline__ bool failed() const {
    if constexpr (kAlive) return false;
    return overrun > kMaxOverrun;
  }
  __device__ __forceinline__ uint32_t back(int dist) const {
    long long i = static_cast<long long>(out_pos) - dist - 1;
    i = i < 0 ? 0 : (i > max_out - 1 ? max_out - 1 : i);
    return win_at(static_cast<int>(i));
  }
  // a byte that passes the bound is still written (at most at the last
  // column) and counted before the lane fails, as in the FSM
  __device__ __forceinline__ void emit(uint32_t byte) {
    win_put(out_pos < max_out ? out_pos : max_out - 1, byte);
    ++out_pos;
    ctx_bytes(1);
  }

#define DEC_BIT(dst, idx)        \
  do {                           \
    (dst) = cbit(idx);           \
    if (failed()) return kFail;  \
  } while (0)
#define DEC_DIRECT(dst)          \
  do {                           \
    (dst) = cdirect();           \
    if (failed()) return kFail;  \
  } while (0)
// A literal bit: the FSM completes its step before it marks the lane
// failed, so an overrun on a literal's last bit still emits the byte.
#define LIT_BIT(idx)                                  \
  do {                                                \
    b = cbit(idx);                                    \
    sym = (sym << 1) | b;                             \
    if (failed()) {                                   \
      if (sym >= 0x100u) emit(sym & 0xFFu);           \
      return kFail;                                   \
    }                                                 \
  } while (0)

  __device__ __forceinline__ int checked_symbol() {
    const int coded = out_pos - P;
    const int pos_state = coded & pb_mask;
    int len = 0;
    uint32_t b;
    DEC_BIT(b, L.is_match + (state << L.pos_bits) + pos_state);
    if (b == 0) {
      // ---- literal (matched mode after a match) ----
      const int lit = L.literal +
          (((coded & lp_mask) << lc) + static_cast<int>(prev >> (8 - lc))) *
              kLiteralCoderSize;
      uint32_t sym = 1;
      if (state >= 7) {
        uint32_t mb = back(rep0);
        do {
          const uint32_t mbit = (mb >> 7) & 1u;
          mb <<= 1;
          LIT_BIT(lit + static_cast<int>(((1u + mbit) << 8) + sym));
          if (mbit != b) break;
        } while (sym < 0x100u);
      }
      while (sym < 0x100u) LIT_BIT(lit + static_cast<int>(sym));
      prev = sym & 0xFFu;
      emit(prev);
      if (!kAlive && out_pos > bound) return kFail;
      state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
      return kGoOn;
    }
    DEC_BIT(b, L.is_rep + state);
    int len_base;
    if (b == 0) {
      rep3 = rep2;
      rep2 = rep1;
      rep1 = rep0;
      len_base = L.len_coder;
    } else {
      DEC_BIT(b, L.is_rep_g0 + state);
      if (b == 0) {
        DEC_BIT(b, L.is_rep0_long + (state << L.pos_bits) + pos_state);
        if (b == 0) {
          state = state < 7 ? 9 : 11;
          len = 1;
        }
      } else {
        DEC_BIT(b, L.is_rep_g1 + state);
        if (b == 0) {
          const int d = rep1;
          rep1 = rep0;
          rep0 = d;
        } else {
          DEC_BIT(b, L.is_rep_g2 + state);
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
      int top, base_len, tree;
      DEC_BIT(b, len_base + L.len_choice);
      if (b == 0) {
        tree = len_base + L.len_low + (pos_state << 3);
        top = 8;
        base_len = 0;
      } else {
        DEC_BIT(b, len_base + L.len_choice2);
        if (b == 0) {
          tree = len_base + L.len_mid + (pos_state << 3);
          top = 8;
          base_len = 8;
        } else {
          tree = len_base + L.len_high;
          top = 256;
          base_len = 16;
        }
      }
      int m = 1;
      while (m < top) {
        DEC_BIT(b, tree + m);
        m = (m << 1) | static_cast<int>(b);
      }
      len = base_len + (m - top) + 2;

      if (len_base == L.len_coder) {
        state = state < 7 ? 7 : 10;
        const int lps = len - 2 < 3 ? len - 2 : 3;
        const int slot_tree = L.pos_slot + lps * 64;
        int s = 1;
        while (s < 64) {
          DEC_BIT(b, slot_tree + s);
          s = (s << 1) | static_cast<int>(b);
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
            const int rt = L.spec_pos + static_cast<int>(base) - slot - 1;
            int mm = 1;
            for (int i = 0; i < direct_bits; ++i) {
              DEC_BIT(b, rt + mm);
              mm = (mm << 1) | static_cast<int>(b);
              rev |= b << i;
            }
            rep0 = static_cast<int>(base + rev);
          } else {
            uint32_t acc = 0;
            for (int i = 0; i < direct_bits - 4; ++i) {
              DEC_DIRECT(b);
              acc = (acc << 1) | b;
            }
            int mm = 1;
            for (int i = 0; i < 4; ++i) {
              DEC_BIT(b, L.align + mm);
              mm = (mm << 1) | static_cast<int>(b);
              rev |= b << i;
            }
            const int dist = static_cast<int>(base + (acc << 4) + rev);
            if (dist == -1 && eos) return kEnd;
            if (!kAlive && dist < 0) return kFail;
            rep0 = dist;
          }
        }
      } else {
        state = state < 7 ? 8 : 11;
      }
    }
    if (!kAlive && (rep0 >= out_pos || rep0 >= dict_check)) return kFail;
    for (int k = 0; k < len; ++k) {
      prev = back(rep0);
      emit(prev);
      if constexpr (KO & kKoCount) ++n_copy;
      if constexpr (kAlive) {
        if (out_pos >= bound) break;
      } else {
        if (out_pos > bound) return kFail;
      }
    }
    return kGoOn;
  }

#undef DEC_BIT
#undef DEC_DIRECT
#undef LIT_BIT

  // The 5-byte init (the plain version's: bytes past in_len are 0).
  __device__ __forceinline__ void start() {
    for (int i = 0; i < 5; ++i) {
      code = (code << 8) | (i < in.in_len ? in_byte(i) : 0u);
    }
  }

  // Symbols to the lane's end, each fast while the margins allow.
  __device__ __forceinline__ bool run() {
    const int out_fast = min(bound, max_out) - kMatchMaxLen + 1;
    int in_fast = -1;
    for (;;) {
      if (in_pos >= in_fast) in_fast = in.refill(in_pos);
      const bool fast = in_pos < in_fast && out_pos < out_fast;
      long long t0 = 0;
      if constexpr (KO & kKoSpans) {
        t0 = clock64();
        copy_t = 0;
      }
      const int r = fast ? fast_symbol() : checked_symbol();
      if constexpr (KO & kKoSpans) {
        const long long dt = clock64() - t0;
        span[fast ? kind : kSpanChecked] += dt - (fast ? copy_t : 0);
        if (fast) span[kSpanCopy] += copy_t;
      }
      if (r != kGoOn) return r == kEnd;
      // a kept-alive lane ends at its bound even where it is an EOS lane
      if ((!eos || kAlive) && out_pos >= bound) return true;
    }
  }
};

// Decode one lane.  The arena `a` holds 1024s and the window `w` max_out
// bytes, primed with the P preset bytes (the rest as the caller left
// it); `in` gives the lane's stream.  size > 0 is the absolute end
// position; size = -cap marks an EOS lane.  Writes ok and the final
// output position, under kKoCount the bits decoded to counts[0] and the
// bytes copied by matches to counts[1], and under kKoSpans the spans to
// counts[3 + kSpan*].
template <int KO = 0, class In, class Ar, class Win>
__device__ __forceinline__ void decode_lane(
    In& in, Ar a, Win w, int max_out, int P, int size, int dict_size, int lc,
    int lp, int pb, const LztLayout& L, bool* ok, int* out_pos_res,
    int* counts = nullptr) {
  constexpr bool kAlive = (KO & kKoAlive) != 0;
  const bool eos = size < 0;
  Lane<KO, In, Ar, Win> s{in, a, w, L};
  s.P = P;
  s.max_out = max_out;
  // a kept-alive lane ends at its bound, so that bound stays in its row
  s.bound = kAlive ? min(eos ? -size : size, max_out) : (eos ? -size : size);
  s.dict_check = dict_size > 1 ? dict_size : 1;
  s.lc = lc;
  s.pb_mask = (1 << pb) - 1;
  s.lp_mask = (1 << lp) - 1;
  s.eos = eos;
  s.range = 0xFFFFFFFFu;
  s.code = 0;
  s.in_pos = 5;
  s.overrun = 0;
  s.out_pos = P;
  s.state = 0;
  s.rep0 = s.rep1 = s.rep2 = s.rep3 = 0;
  s.prev = P ? w.load(P - 1) : 0u;
  s.n_dec = s.n_copy = 0;
  for (int k = 0; k < kSpans; ++k) s.span[k] = 0;
  s.ctx = 0;
  if constexpr (KO & kKoNoCtx) s.ctx = (P * 7) % L.size;
  s.start();
  const bool good = s.run();
  in.finish();
  *ok = good;
  *out_pos_res = s.out_pos;
  if constexpr (KO & kKoCount) {
    counts[0] = s.n_dec;
    counts[1] = s.n_copy;
  }
  if constexpr (KO & kKoSpans) {
    for (int k = 0; k < kSpans; ++k) counts[3 + k] = static_cast<int>(s.span[k]);
  }
}

// ---------------------------------------------------------------------
// K1's block: the lane's arena (in shared memory when kSharedArena, else
// at `probs` in device memory), its input ring, and its output row `o`
// as the window.  All threads set the arena to 1024 and copy the preset;
// warp 1 stages the input's first two tiles, then, while thread 0
// decodes (body(in, arena, win)), keeps the ring filled.  The dynamic
// shared memory: the control words, the ring, then the arena.
constexpr int kRingThreads = 64;

template <bool kSharedArena, class Body>
__device__ __forceinline__ void ring_block(const uint8_t* row, int in_len,
                                           int max_in, const uint8_t* preset,
                                           int preset_len, uint16_t* probs,
                                           uint8_t* o, const LztLayout& L,
                                           Body body) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ctrl = s0, ring = s0 + kCtrlBytes;
  const int lim = min(in_len, max_in);
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3u);
  const uint8_t* abase = row - shift;
  const int end_r = lim + shift;
  const int n_tiles = lim > 0 ? (end_r + kInTile - 1) >> kInTileLog : 0;

  if (tid >= 32 && n_tiles > 0) {
    for (int k = 0; k < min(n_tiles, 2); ++k) {
      stage_in_tile(ring, abase, k, end_r, tid - 32);
    }
  }
  if constexpr (kSharedArena) {
    uint16_t* p = reinterpret_cast<uint16_t*>(smem + kCtrlBytes + 2 * kInTile);
    for (int k = tid; k < L.size; k += kRingThreads) p[k] = 1024;
  } else {
    for (int k = tid; k < L.size; k += kRingThreads) probs[k] = 1024;
  }
  for (int k = tid; k < preset_len; k += kRingThreads) o[k] = preset[k];
  if (tid == 0) {
    stv_s32(ctrl, 0);
    stv_s32(ctrl + 4, min(n_tiles, 2) - 1);
  }
  __syncthreads();

  if (tid == 0) {
    const uint32_t base = pinned(s0, ctrl + 8);
    RingIn in{base + kCtrlBytes, base, shift, in_len, lim, end_r, 0,
              min(n_tiles, 2) - 1,
              in_len > max_in && max_in > 0 ? row[max_in - 1] : 0u};
    Arena<kSharedArena> arena;
    if constexpr (kSharedArena) {
      arena.base = base + kCtrlBytes + 2 * kInTile;
    } else {
      arena.p = probs;
    }
    body(in, arena, DevWin{o});
  } else if (tid >= 32) {
    const int lane = tid - 32;
    for (int k = 2; k < n_tiles; ++k) {
      // tile k takes the slot of tile k - 2: wait until the decoder is
      // in tile k - 1 (or done)
      int cur = 0;
      if (lane == 0) {
        while ((cur = ldv_s32(ctrl)) < k - 1) __nanosleep(256);
      }
      cur = __shfl_sync(0xFFFFFFFFu, cur, 0);
      if (cur == kDone) break;
      stage_in_tile(ring, abase, k, end_r, lane);
      if (lane == 0) stv_s32(ctrl + 4, k);
    }
  }
}

}  // namespace
