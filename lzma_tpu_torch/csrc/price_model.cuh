// The closed forms of the optimal rounds' price model (csrc/price_model.cu,
// K18), in the order of lzma_tpu_torch/ops/device_parser.py's plain
// version (_price_model_plain):
//   the price table's entry j (core/prices.py PRICE_TABLE, ProbPrices.java
//       8-18), so that a block builds the table where it needs it;
//   a slot's empirical probability from its counts n and n1
//       (probs_from_counts: EMP_ALPHA pseudo-counts toward 1/2, the
//       numerator wrapped in int32 and the quotient floored as the
//       reference's int32 floor division gives it, clamped to 32..2016,
//       1024 where the slot was never coded) and its two bit prices
//       (_price_planes);
//   the arena's offsets for (lc, lp, pb) (core/layout.py ProbLayout with
//       pos_bits = pb);
//   the MSB-first and LSB-first bit-tree prices (_tree_price,
//       _rev_tree_price: only the active levels, which are the ones the
//       plain version does not mask to 0);
//   an entry of the distance tables (ps_price, dfull, align_price: 784
//       a lane, K12's order) and an entry of the DP scan's row
//       (_dp_tables: ltm, ltr (n_ps, fb - 1), im0, im1, r0l0, r0l1
//       (n_ps, 12), ir0, ir1 (12), rep_sel (4, 12)), both from a lane's
//       prices of the slots before the literal coders.
//
// Plain C++ under LZT_HD (search_list.cuh's), so that a host compiler can
// build it too (the CPU tests hold it to the plain version through a g++
// build).  Counts, probabilities and prices are int; every price of a
// table fits int32, as in the reference.

#pragma once

#include <cstdint>

#include "search_list.cuh"

namespace price_model {

constexpr int kBitModelTotal = 2048;   // core/prices.BIT_MODEL_TOTAL
constexpr int kAlpha = 16;             // device_parser.EMP_ALPHA
constexpr int kPriceEntries = 512;     // PRICE_TABLE's length
constexpr int kStates = 12;
constexpr int kLiteralCoderSize = 0x300;
// a lane's distance tables: ps_price (4, 64), dfull (4, 128), align (16)
constexpr int kPsEntries = 4 * 64;
constexpr int kFullEntries = 4 * 128;
constexpr int kDistEntries = kPsEntries + kFullEntries + 16;

// Entry j of the price table: the piecewise -log2 of bucket j in 1/64
// bits; j in [2^t, 2^(t + 1)) is level 8 - t, entry 0 is 0.
LZT_HD int price_entry(int j) {
  if (j <= 0) return 0;
  const int t = 31 - search_list::clz32(static_cast<uint32_t>(j));
  return ((8 - t) << 6) + ((((2 << t) - j) << 6) >> t);
}

// The floor of num / den for den > 0 (C's / truncates toward zero).
LZT_HD int floor_div(int num, int den) {
  const int q = num / den;
  return (num % den != 0 && num < 0) ? q - 1 : q;
}

// A slot's probability from its count n and its count of ones n1: the
// numerator BIT_MODEL_TOTAL * (2 n0 + alpha) wraps in int32 (computed in
// uint32, which wraps by definition), then floors.
LZT_HD int prob_of(int n, int n1) {
  if (n <= 0) return 1024;
  const uint32_t twice = 2u * static_cast<uint32_t>(n - n1) + kAlpha;
  const int num = static_cast<int>(static_cast<uint32_t>(kBitModelTotal) * twice);
  const int p = floor_div(num, 2 * n + 2 * kAlpha);
  return p < 32 ? 32 : p > 2016 ? 2016 : p;
}

// The price of a 0 and of a 1 at a slot of probability p, from the price
// table pt.
LZT_HD int price0(const int* pt, int p) { return pt[p >> 2]; }
LZT_HD int price1(const int* pt, int p) { return pt[(kBitModelTotal - p) >> 2]; }

// The arena's offsets (ProbLayout(lc, lp, pb, pos_bits=pb)); len_mid and
// len_high relative to a length coder's base (len_choice 0, len_choice2
// 1, len_low 2).
struct Layout {
  int n_ps;
  int is_match, is_rep, is_rep_g0, is_rep_g1, is_rep_g2, is_rep0_long;
  int pos_slot, spec_pos, align, len_coder, rep_len_coder, literal, size;
  int len_mid, len_high;
};

LZT_HD Layout make_layout(int lc, int lp, int pb) {
  Layout y{};
  y.n_ps = 1 << pb;
  int off = 0;
  y.is_match = off;
  off += kStates * y.n_ps;
  y.is_rep = off;
  off += kStates;
  y.is_rep_g0 = off;
  off += kStates;
  y.is_rep_g1 = off;
  off += kStates;
  y.is_rep_g2 = off;
  off += kStates;
  y.is_rep0_long = off;
  off += kStates * y.n_ps;
  y.pos_slot = off;
  off += 4 * 64;
  y.spec_pos = off;
  off += 128 - 14;
  y.align = off;
  off += 16;
  y.len_mid = 2 + y.n_ps * 8;
  y.len_high = 2 + y.n_ps * 16;
  const int len_size = y.len_high + 256;
  y.len_coder = off;
  off += len_size;
  y.rep_len_coder = off;
  off += len_size;
  y.literal = off;
  off += kLiteralCoderSize << (lc + lp);
  y.size = off;
  return y;
}

// Entries of one lane's DP row (device_parser.table_size).
LZT_HD int row_entries(int pb, int fb) {
  const int n_ps = 1 << pb;
  return 2 * n_ps * (fb - 1) + 4 * n_ps * kStates + 72;
}

// A lane's prices of the slots before its literal coders: e0[s], e1[s].
struct Prices {
  const int* e0;
  const int* e1;
};

// MSB-first: the nbits of v down the tree rooted at base + 1.
LZT_HD int tree_price(const Prices& e, int base, int nbits, int v) {
  int cost = 0, m = 1;
  for (int j = 0; j < nbits; ++j) {
    const int b = (v >> (nbits - 1 - j)) & 1;
    cost += b ? e.e1[base + m] : e.e0[base + m];
    m = (m << 1) | b;
  }
  return cost;
}

// LSB-first (reverse): the nbits of v from its lowest.
LZT_HD int rev_tree_price(const Prices& e, int base, int nbits, int v) {
  int cost = 0, m = 1;
  for (int j = 0; j < nbits; ++j) {
    const int b = v & 1;
    cost += b ? e.e1[base + m] : e.e0[base + m];
    m = (m << 1) | b;
    v >>= 1;
  }
  return cost;
}

// Length symbol s (0..271) at pos state ps of the length coder at base:
// the choice bits, then the low, mid or high tree.
LZT_HD int len_price(const Prices& e, const Layout& y, int base, int ps,
                     int s) {
  if (s < 8) return e.e0[base] + tree_price(e, base + 2 + (ps << 3), 3, s);
  if (s < 16) {
    return e.e1[base] + e.e0[base + 1] +
           tree_price(e, base + y.len_mid + (ps << 3), 3, s - 8);
  }
  return e.e1[base] + e.e1[base + 1] +
         tree_price(e, base + y.len_high, 8, s - 16);
}

// The pos_slot tree's price of slot at length state lps.
LZT_HD int slot_price(const Prices& e, const Layout& y, int lps, int slot) {
  return tree_price(e, y.pos_slot + lps * 64, 6, slot);
}

// The full price of a distance d < 128 at length state lps: its slot,
// then the reverse tree of its footer bits under spec_pos (none below 4).
LZT_HD int full_price(const Prices& e, const Layout& y, int lps, int d) {
  const int nb = 31 - search_list::clz32(static_cast<uint32_t>(d > 1 ? d : 1));
  const int slot = d < 4 ? d : (nb << 1) | ((d >> (nb > 1 ? nb - 1 : 0)) & 1);
  const int footer = (slot >> 1) - 1 > 0 ? (slot >> 1) - 1 : 0;
  const int base_val = (2 | (slot & 1)) << footer;
  const int spec = slot >= 4 ? rev_tree_price(e, y.spec_pos + base_val - slot - 1,
                                              footer, d - base_val)
                             : 0;
  return slot_price(e, y, lps, slot) + spec;
}

// Entry k < kDistEntries of a lane's distance tables: ps_price[lps][slot],
// then dfull[lps][d], then align_price[a].
LZT_HD int dist_entry(const Prices& e, const Layout& y, int k) {
  if (k < kPsEntries) return slot_price(e, y, k >> 6, k & 63);
  k -= kPsEntries;
  if (k < kFullEntries) return full_price(e, y, k >> 7, k & 127);
  return rev_tree_price(e, y.align, 4, k - kFullEntries);
}

// Entry k < row_entries(pb, fb) of a lane's DP row (_dp_tables' layout):
// ltm, ltr [ps][s] for s < W = fb - 1; im0, im1, r0l0, r0l1 [ps][state];
// ir0, ir1 [state]; rep_sel [rep][state], the is_rep_g0/g1/g2 chain.
LZT_HD int row_entry(const Prices& e, const Layout& y, int W, int k) {
  const int lens = y.n_ps * W;
  if (k < 2 * lens) {
    const int base = k < lens ? y.len_coder : y.rep_len_coder;
    const int q = k < lens ? k : k - lens;
    return len_price(e, y, base, q / W, q % W);
  }
  k -= 2 * lens;
  const int flags = y.n_ps * kStates;
  if (k < 4 * flags) {
    const int which = k / flags, q = k % flags;
    const int ctx = (which < 2 ? y.is_match : y.is_rep0_long) +
                    (q % kStates) * y.n_ps + q / kStates;
    return (which & 1) ? e.e1[ctx] : e.e0[ctx];
  }
  k -= 4 * flags;
  if (k < kStates) return e.e0[y.is_rep + k];
  if (k < 2 * kStates) return e.e1[y.is_rep + k - kStates];
  k -= 2 * kStates;
  const int rep = k / kStates, s = k % kStates;
  if (rep == 0) return e.e0[y.is_rep_g0 + s];
  const int g1 = rep == 1 ? e.e0[y.is_rep_g1 + s] : e.e1[y.is_rep_g1 + s];
  const int g2 = rep == 1 ? 0
                 : rep == 2 ? e.e0[y.is_rep_g2 + s] : e.e1[y.is_rep_g2 + s];
  return e.e1[y.is_rep_g0 + s] + g1 + g2;
}

}  // namespace price_model
