// The per-position closed form of the optimal parse's DP row (K12,
// csrc/dp_inputs.cu), in the order of lzma_tpu_torch/ops/
// device_parser.py's plain version _dp_inputs_plain:
//   ld (M), dd (M)                  the position's candidate pairs, copied;
//   the distance prices (M x 4)     _pair_dist_cost, pair-major, one a
//                                   len-to-pos state: the exact spec-tree
//                                   price below 128 (dfull), above it the
//                                   pos_slot price + 64 a direct bit + the
//                                   align tree; kInf for an invalid pair;
//   lit, mlit                       lit_cost and matched_lit_cost: the
//                                   8-step literal tree walks over the
//                                   lane's price planes, the matched walk's
//                                   byte data[clamp(i - r0pos - 1, 0, N - 1)]
//                                   (data[0] for a source before the block,
//                                   as the reference prices it);
//   r0pos                           copied;
//   replen                          rep_match_lens_rmq: the LCP of i and
//                                   its rep0 source by two reads of the
//                                   suffix table (search_list::lcp_query,
//                                   K11's closed form), capped at lens - i;
//                                   0 for a source before the block;
//   sr_eq                           the shortRep byte equality.
//
// replen's reads are a chain of three dependent random reads (the trace,
// then the source's rank and byte, then two table entries); row() issues
// them first, so that they are in flight while the pairs and the literal
// walks are priced.
//
// Plain C++ under LZT_HD, so that a host compiler can build it too (the
// CPU tests hold it to the plain version through a g++ build).  The
// plain version's int64 arithmetic fits int32 for every price (a price
// is a sum of at most 8 + 12 entries of PRICE_TABLE, each below 2^10).

#pragma once

#include <cstdint>

#include "search_list.cuh"

namespace dp_input_row {

constexpr int32_t kInf = 0x0FFFFFFF;   // device_parser.INF
constexpr int kLitCoder = 0x300;       // LITERAL_CODER_SIZE
// A lane's distance tables, int32, in this order: ps_price (4 x 64),
// dfull (4 x 128), align_price (16).
constexpr int kPs = 0, kDfull = 4 * 64, kAlign = kDfull + 4 * 128;
constexpr int kTableInts = kAlign + 16;

// What one lane's rows read.  ep0 and ep1 point at the price of a 0 and
// of a 1 at the literal coders' first slot (layout.literal) of the
// lane's planes, tables at its distance tables, in whatever memory holds
// them.
struct Lane {
  const uint8_t* data;     // (n_pos,)
  const int64_t* ld;       // (n_pos, m)
  const int64_t* dd;       // (n_pos, m)
  const int64_t* r0pos;    // (n_pos,)
  const int32_t* ep0;
  const int32_t* ep1;
  const int32_t* tables;   // kTableInts
  search_list::Lane sfx;   // rank, T and max_n = n_pos (lcp_query's)
  int64_t n_pos, len;
  int m, lc, lp;
  bool pairs16;            // ld, dd 16-byte aligned and m even: 16-byte loads
};

// The price of the pair (ld, dd) at len-to-pos state lps.
LZT_HD int32_t dist_price(const int32_t* tables, int64_t ld, int64_t dd,
                          int lps) {
  if (ld < 2 || dd < 0) return kInf;
  if (dd < 128) return tables[kDfull + lps * 128 + static_cast<int>(dd)];
  const uint32_t d = static_cast<uint32_t>(dd);
  const int nb = 31 - search_list::clz32(d);   // bit_length(d) - 1
  const int slot = (nb << 1) | static_cast<int>((d >> (nb - 1)) & 1);
  const int footer = (slot >> 1) - 1;
  return tables[kPs + lps * 64 + slot] + (footer - 4) * 64 +
         tables[kAlign + (d & 15)];
}

// The literal sub-coder of position i after byte prev, from the literal
// coders' first slot.
LZT_HD int64_t lit_sub(int64_t i, int prev, int lc, int lp) {
  return ((((i & ((1LL << lp) - 1)) << lc) + (prev >> (8 - lc))) *
          kLitCoder);
}

// Normal-mode literal price of `byte` at sub-coder sub.
LZT_HD int32_t lit_price(const int32_t* ep0, const int32_t* ep1, int64_t sub,
                         int byte) {
  int32_t cost = 0;
  int m = 1;
  for (int k = 0; k < 8; ++k) {
    const int b = (byte >> (7 - k)) & 1;
    cost += b ? ep1[sub + m] : ep0[sub + m];
    m = (m << 1) | b;
  }
  return cost;
}

// Matched-mode literal price of `byte` against match byte mbyte.
LZT_HD int32_t matched_lit_price(const int32_t* ep0, const int32_t* ep1,
                                 int64_t sub, int byte, int mbyte) {
  const int x = byte ^ mbyte;
  int32_t cost = 0;
  int m = 1;
  for (int k = 0; k < 8; ++k) {
    const int b = (byte >> (7 - k)) & 1;
    const int mbit = (mbyte >> (7 - k)) & 1;
    const bool prefix_eq = (x >> (8 - k)) == 0;
    const int64_t cx = sub + (prefix_eq ? ((1 + mbit) << 8) + m : m);
    cost += b ? ep1[cx] : ep0[cx];
    m = (m << 1) | b;
  }
  return cost;
}

// Pair j of a row of m pairs: its length, distance and four prices.
LZT_HD void pair(const int32_t* tables, int64_t ld, int64_t dd, int m, int j,
                 int32_t* out) {
  out[j] = static_cast<int32_t>(ld);
  out[m + j] = static_cast<int32_t>(dd);
  for (int lps = 0; lps < 4; ++lps) {
    out[2 * m + 4 * j + lps] = dist_price(tables, ld, dd, lps);
  }
}

// Position i's row, 6m + 5 int32, into out.
LZT_HD void row(const Lane& ln, int64_t i, int32_t* out) {
  const int m = ln.m;
  const int64_t r0 = ln.r0pos[i];
  const int64_t src = i - r0 - 1;
  const int64_t at = src < 0 ? 0 : src > ln.n_pos - 1 ? ln.n_pos - 1 : src;
  const int mbyte = ln.data[at];
  const int64_t lcp =
      src >= 0 ? search_list::lcp_query(ln.sfx, ln.sfx.rank[i], src) : 0;
  const int byte = ln.data[i];
  const int prev = i > 0 ? ln.data[i - 1] : 0;
  const int64_t* ld = ln.ld + i * m;
  const int64_t* dd = ln.dd + i * m;
  int j = 0;
#if defined(__CUDA_ARCH__)
  if (ln.pairs16) {
    for (; j < m; j += 2) {
      const longlong2 lv = __ldg(reinterpret_cast<const longlong2*>(ld + j));
      const longlong2 dv = __ldg(reinterpret_cast<const longlong2*>(dd + j));
      pair(ln.tables, lv.x, dv.x, m, j, out);
      pair(ln.tables, lv.y, dv.y, m, j + 1, out);
    }
  }
#endif
  for (; j < m; ++j) pair(ln.tables, ld[j], dd[j], m, j, out);
  const int64_t sub = lit_sub(i, prev, ln.lc, ln.lp);
  int32_t* tail = out + 6 * m;
  tail[0] = lit_price(ln.ep0, ln.ep1, sub, byte);
  tail[1] = matched_lit_price(ln.ep0, ln.ep1, sub, byte, mbyte);
  tail[2] = static_cast<int32_t>(r0);
  const int64_t room = ln.len - i > 0 ? ln.len - i : 0;
  tail[3] = static_cast<int32_t>(lcp < room ? lcp : room);
  tail[4] = src >= 0 && byte == mbyte;
}

}  // namespace dp_input_row
