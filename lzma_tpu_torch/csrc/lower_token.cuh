// One token of the bit lowering (K7, csrc/lower.cu): its bit count and
// its (ctx, bit) pairs from closed forms, in the slot order of
// lzma_tpu_torch/ops/device_encoder.py _lower_tokens_plain (emit_slot):
// is_match; the literal or matched-literal tree; is_rep; the rep
// selector bits; the length choice and tree; the pos_slot tree; the
// spec_pos reverse tree, or the direct bits and the align reverse tree.
//
// Plain C++ under LZT_HD, so that a host compiler can build it too (the
// CPU tests hold it to the plain version through a g++ build).  All
// distance arithmetic is uint32_t: the EOS marker's wire distance
// 0xFFFFFFFF has slot 63 and footer 30, base_val 3 << 30 and reduced
// 0x3FFFFFFF, which the plain version reaches by int32 wrap-around.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define LZT_HD __host__ __device__ __forceinline__
#else
#define LZT_HD inline
#endif

namespace lower_token {

constexpr int kLit = 0;        // device_encoder.K_LIT
constexpr int kRep = 2;        // device_encoder.K_REP (K_MATCH is the rest)
constexpr int kEosDist = -2;   // device_encoder.EOS_DIST
constexpr int kMaxB = 50;      // device_encoder.MAXB: pairs a token, at most
constexpr int kCtxDirect = -1; // device_encoder.CTX_DIRECT
constexpr int kLiteralCoderSize = 0x300;
constexpr int kPosSlotTreeSize = 64;

// ProbLayout(lc, lp, pb, pos_bits=pb)'s offsets, then lc, lp, pb: the
// order of ops/cuda_lower.py LAYOUT_FIELDS.
struct Layout {
  int is_match, is_rep, is_rep_g0, is_rep_g1, is_rep_g2, is_rep0_long;
  int pos_slot, spec_pos, align, len_coder, rep_len_coder, literal;
  int len_choice, len_choice2, len_low, len_mid, len_high;
  int lc, lp, pb;
};
constexpr int kLayoutInts = 20;

// A valid token's inputs: the meta planes, the coded position's low 32
// bits (t_pos - pos_base), len and dist (int32 values in the reference).
struct Token {
  int kind, rep_idx, state, match_mode, match_byte, prev_byte, lit_byte;
  int coded_pos, len, dist;
};

// The closed forms of _lower_tokens_plain's per-token geometry.
struct Geo {
  bool lit, rep, srep, spec, huge;
  int nbits, rbits, band, band_v, band_bits, slot, footer;
  uint32_t base_val, reduced;
};

LZT_HD int bit_length_minus1(uint32_t x) {  // x > 0
#if defined(__CUDA_ARCH__)
  return 31 - __clz(static_cast<int>(x));
#else
  return 31 - __builtin_clz(x);
#endif
}

// The low k bits of v reversed (k in 0..5).
LZT_HD uint32_t bitrev_low(uint32_t v, int k) {
  uint32_t out = 0;
  for (int j = 0; j < k; ++j) out |= ((v >> j) & 1u) << (k - 1 - j);
  return out;
}

LZT_HD Geo geometry(const Token& k) {
  Geo g;
  g.lit = k.kind == kLit;
  g.rep = k.kind == kRep;
  const bool match = !g.lit && !g.rep;
  const int l_sym = k.len - 2 > 0 ? k.len - 2 : 0;
  g.band = l_sym < 8 ? 0 : l_sym < 16 ? 1 : 2;
  g.band_v = l_sym - (g.band == 0 ? 0 : g.band == 1 ? 8 : 16);
  g.band_bits = g.band == 2 ? 8 : 3;
  const int dlen = g.band == 0 ? 4 : g.band == 1 ? 5 : 10;
  g.rbits = k.rep_idx < 2 ? 2 : 3;
  g.srep = g.rep && k.len < 2;

  const bool eos = k.dist == kEosDist;
  const uint32_t d = eos ? 0xFFFFFFFFu
                         : static_cast<uint32_t>(k.dist > 0 ? k.dist : 0);
  if (eos) {
    g.slot = 63;
  } else if (d < 4) {
    g.slot = static_cast<int>(d);
  } else {
    const int nb = bit_length_minus1(d);  // >= 2
    g.slot = (nb << 1) | static_cast<int>((d >> (nb - 1)) & 1u);
  }
  g.footer = (g.slot >> 1) - 1 > 0 ? (g.slot >> 1) - 1 : 0;  // <= 30
  g.base_val = (2u | static_cast<uint32_t>(g.slot & 1)) << g.footer;
  g.reduced = d - g.base_val;
  g.spec = match && g.slot >= 4 && g.slot < 14;
  g.huge = match && g.slot >= 14;

  const int len_s = g.rep ? 2 + g.rbits : 2;
  const int tail_s = len_s + dlen + 6;
  g.nbits = g.lit ? 9
            : g.rep ? len_s + dlen
                    : tail_s + (g.spec || g.huge ? g.footer : 0);
  if (g.srep) g.nbits = 4;
  return g;
}

// Whether a valid token is coded past the literal/shortRep slots (the
// plain version's "long" class, at most T // 2 + 2 a lane).
LZT_HD bool is_long(const Geo& g) { return !(g.lit || g.srep); }

// The pairs of a valid token that have a probability slot (K8 counts
// them): all but a huge match's footer - 4 direct bits.
LZT_HD int counted(const Geo& g) {
  return g.nbits - (g.huge ? g.footer - 4 : 0);
}

// A counted pair (ctx c >= 0, bit b) as one word, and back.
LZT_HD uint32_t pack_pair(int c, int b) {
  return (static_cast<uint32_t>(c) << 1) | static_cast<uint32_t>(b & 1);
}
LZT_HD int pair_slot(uint32_t w) { return static_cast<int>(w >> 1); }
LZT_HD int pair_bit(uint32_t w) { return static_cast<int>(w & 1u); }

// Every (ctx, bit) pair of a valid token, in slot order: put(j, ctx, bit)
// for j = 0 .. nbits - 1.  Slots at or past kMaxB keep the direct ctx
// and bit 0, as the plain version's cap leaves them (no token reaches
// it: the most is 48, the EOS marker's).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Put>
LZT_HD void emit(const Token& k, const Geo& g, const Layout& L, Put&& put) {
  int j = 0;
  auto out = [&](int c, int b) {
    if (j < kMaxB) {
      put(j, c, b);
    } else {
      put(j, kCtxDirect, 0);
    }
    ++j;
  };
  const int st = k.state;
  const int ps = k.coded_pos & ((1 << L.pb) - 1);
  out(L.is_match + (st << L.pb) + ps, g.lit ? 0 : 1);
  if (g.lit) {
    const int lit_sub =
        L.literal + (((k.coded_pos & ((1 << L.lp) - 1)) << L.lc) +
                     (k.prev_byte >> (8 - L.lc))) *
                        kLiteralCoderSize;
    const int x = k.lit_byte ^ k.match_byte;
    for (int kk = 0; kk < 8; ++kk) {
      const int m = (1 << kk) | (k.lit_byte >> (8 - kk));
      const int b = (k.lit_byte >> (7 - kk)) & 1;
      const int mbit = (k.match_byte >> (7 - kk)) & 1;
      const bool matched = k.match_mode > 0 && (x >> (8 - kk)) == 0;
      out(lit_sub + (matched ? ((1 + mbit) << 8) + m : m), b);
    }
    return;
  }
  out(L.is_rep + st, g.rep ? 1 : 0);
  if (g.rep) {
    // r0 -> [g0 0, rep0long 1]; r1 -> [1, 0]; r2 -> [1, 1, 0];
    // r3 -> [1, 1, 1]; a shortRep's four slots end after two of them
    const int nsel = g.srep ? 2 : g.rbits;
    for (int kk = 0; kk < nsel; ++kk) {
      if (kk == 0) {
        out(L.is_rep_g0 + st, k.rep_idx == 0 ? 0 : 1);
      } else if (kk == 1) {
        if (k.rep_idx == 0) {
          out(L.is_rep0_long + (st << L.pb) + ps, g.srep ? 0 : 1);
        } else {
          out(L.is_rep_g1 + st, k.rep_idx == 1 ? 0 : 1);
        }
      } else {
        out(L.is_rep_g2 + st, k.rep_idx == 2 ? 0 : 1);
      }
    }
    if (g.srep) return;
  }
  // the length: choice, choice2 past the low band, then the band's tree
  // MSB-first (after j bits the node is (1 << j) | (v >> (nb - j)))
  const int len_base = g.rep ? L.rep_len_coder : L.len_coder;
  out(len_base + L.len_choice, g.band == 0 ? 0 : 1);
  if (g.band > 0) out(len_base + L.len_choice2, g.band == 1 ? 0 : 1);
  const int tree = g.band == 0   ? len_base + L.len_low + (ps << 3)
                   : g.band == 1 ? len_base + L.len_mid + (ps << 3)
                                 : len_base + L.len_high;
  for (int jj = 0; jj < g.band_bits; ++jj) {
    out(tree + ((1 << jj) | (g.band_v >> (g.band_bits - jj))),
        (g.band_v >> (g.band_bits - 1 - jj)) & 1);
  }
  if (g.rep) return;
  // the pos_slot tree, 6 bits MSB-first, by the length's state
  const int lps = k.len - 2 < 3 ? k.len - 2 : 3;
  const int slot_tree = L.pos_slot + lps * kPosSlotTreeSize;
  for (int jj = 0; jj < 6; ++jj) {
    out(slot_tree + ((1 << jj) | (g.slot >> (6 - jj))),
        (g.slot >> (5 - jj)) & 1);
  }
  if (g.spec) {
    // the spec_pos reverse tree: footer (<= 5) bits LSB-first
    const int base = L.spec_pos + static_cast<int>(g.base_val) - g.slot - 1;
    for (int jj = 0; jj < g.footer; ++jj) {
      out(base + static_cast<int>((1u << jj) | bitrev_low(g.reduced, jj)),
          static_cast<int>((g.reduced >> jj) & 1u));
    }
  } else if (g.huge) {
    // footer - 4 direct bits MSB-first, then the 4-bit align reverse tree
    const int nd = g.footer - 4;
    for (int jj = 0; jj < nd; ++jj) {
      out(kCtxDirect, static_cast<int>((g.reduced >> (g.footer - 1 - jj)) & 1u));
    }
    const uint32_t av = g.reduced & 15u;
    for (int ja = 0; ja < 4; ++ja) {
      out(L.align + static_cast<int>((1u << ja) | bitrev_low(av, ja)),
          static_cast<int>((av >> ja) & 1u));
    }
  }
}

// Token k's counted pairs, packed, at stage[q - lo] for the q-th of them
// (q from `first`, the token's offset among the round's counted pairs)
// where lo <= q < lo + n: the part of the round's pairs that a stage of
// n words holds.
LZT_HD void stage_counted(const Token& k, const Geo& g, const Layout& L,
                          int first, int lo, int n, uint32_t* stage) {
  int q = first - lo;
  emit(k, g, L, [&](int, int c, int b) {
    if (c < 0) return;
    if (q >= 0 && q < n) stage[q] = pack_pair(c, b);
    ++q;
  });
}

}  // namespace lower_token
