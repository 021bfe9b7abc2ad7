// The closed forms of the lazy search (csrc/lazy_search.cu, K15-K17), in
// the order of lzma_tpu_torch/ops/device_matcher.py's plain versions:
//   K15 whether a suffix starts a new group of the prefix doubling against
//       the suffix before it in the level's order: by the 8 prefix words
//       (word 0 marked past n) at the 32-byte level, else by the previous
//       level's ids at i and i + span (_doubling_groups_plain);
//   K16 the consecutive LCP of two suffixes at full depth: the binary
//       descent over the group levels, then the <=32-byte refinement by
//       prefix words, each index wrapped once and clamped
//       (_descent_lcp_plain);
//   K17 a position's best match among its hash-sort neighbours
//       (_best_matches_plain).
//
// Plain C++ under LZT_HD, as search_list.cuh is written (whose
// suffix_word and lcp_query these reuse), so that a host compiler can
// build it too (the CPU tests hold it to the plain versions through a g++
// build).  Words are uint32_t, as the reference's; positions, group ids
// and keys are int64_t.

#pragma once

#include <cstdint>

#include "search_list.cuh"

namespace lazy_search {

using search_list::kMark;
using search_list::kWindow;

constexpr int kMaxLevels = 8;      // group levels a descent reads
constexpr int kMaxCandidates = 16; // hash neighbours a position takes
constexpr int kWords = 8;          // the 32-byte level's prefix words

// ----------------------------------------------------------------- K15
// The 32-byte level: the 8 prefix words of suffixes pa and pb, word 0
// marked 0x80000000 ^ pos past n, compared exactly (a data word may
// equal a mark).  wa, wb: their kWindow-byte windows (wrapping at max_n).
LZT_HD bool words_differ(const uint8_t* wa, int64_t pa, const uint8_t* wb,
                         int64_t pb, int64_t n) {
  bool differ = false;
  for (int k = 0; k < kWords; ++k) {
    differ = differ || search_list::suffix_word(wa, k, pa, n) !=
                           search_list::suffix_word(wb, k, pb, n);
  }
  return differ;
}

// A doubling level's key of suffix i: the previous level's ids at i and
// at (i + span) mod max_n.
struct Pair {
  int64_t hi, lo;
};

LZT_HD Pair pair_at(const int64_t* g, int64_t max_n, int64_t span,
                    int64_t i) {
  return Pair{g[i], g[(i + span) % max_n]};
}

LZT_HD bool pairs_differ(Pair a, Pair b) { return a.hi != b.hi || a.lo != b.lo; }

// The next sort's key of place i from this level's ids: ids[i] * max_n
// + ids[(i + span) mod max_n] (ids < max_n, so the key is unique to the
// pair and keeps its order).
LZT_HD int64_t next_key(const int64_t* ids, int64_t max_n, int64_t span,
                        int64_t i) {
  return ids[i] * max_n + ids[(i + span) % max_n];
}

// ----------------------------------------------------------------- K16
// One wrap past the end, then the clamp an out-of-range gather index
// gets in the reference (_wrap_once).
LZT_HD int64_t wrap_once(int64_t i, int64_t max_n) {
  if (i >= max_n) i -= max_n;
  return i < max_n ? i : max_n - 1;
}

// The big-endian word of the bytes q, q + 1, q + 2, q + 3 of a lane,
// wrapping at max_n (a word of the rolled byte planes).
LZT_HD uint32_t word_at(const uint8_t* row, int64_t max_n, int64_t q) {
  uint32_t w = 0;
  for (int j = 0; j < 4; ++j) w = w << 8 | row[(q + j) % max_n];
  return w;
}

// The descent over the group levels g[0..n_levels) (level t: the
// (32 << t)-byte groups), the widest first: where suffixes a + l and
// b + l share a level's group, l advances by its bytes.
LZT_HD int64_t descend(const int64_t* const* g, int n_levels, int64_t max_n,
                       int64_t a, int64_t b) {
  int64_t l = 0;
  for (int t = n_levels - 1; t >= 0; --t) {
    const int64_t ia = wrap_once(a + l, max_n), ib = wrap_once(b + l, max_n);
    if (g[t][ia] == g[t][ib]) l += int64_t{32} << t;
  }
  return l;
}

// The <=32-byte refinement after the descent: the equal leading bytes of
// 8 words, word w at index a + l + 4w (and b's), each wrapped once and
// clamped on its own; word 0 is the marked one at its index.
LZT_HD int refine(const uint8_t* row, int64_t max_n, int64_t n, int64_t a,
                  int64_t b, int64_t l) {
  int rem = 0;
  for (int w = 0; w < kWords; ++w) {
    const int64_t ia = wrap_once(a + l + 4 * w, max_n);
    const int64_t ib = wrap_once(b + l + 4 * w, max_n);
    uint32_t xa = word_at(row, max_n, ia), xb = word_at(row, max_n, ib);
    if (w == 0) {
      if (ia >= n) xa = kMark ^ static_cast<uint32_t>(ia);
      if (ib >= n) xb = kMark ^ static_cast<uint32_t>(ib);
    }
    const uint32_t x = xa ^ xb;
    if (x != 0) return rem + (search_list::clz32(x) >> 3);
    rem += 4;
  }
  return rem;
}

// The consecutive LCP at place i of the final order (its suffix a, the
// one before it b), clamped to depth; 0 at place 0.
LZT_HD int64_t deep_lcp(const int64_t* const* g, int n_levels,
                        const uint8_t* row, int64_t max_n, int64_t n,
                        int64_t i, int64_t a, int64_t b, int depth) {
  if (i == 0) return 0;
  const int64_t l = descend(g, n_levels, max_n, a, b);
  const int64_t cl = l + refine(row, max_n, n, a, b, l);
  return cl < depth ? cl : depth;
}

// ----------------------------------------------------------------- K17
// The best match of the position at place j of the hash key's stable
// order: its candidates are the positions at places j - 1 .. j - k where
// the key there is its own (else none, -1).  A candidate in the window
// (before the position, at most dict_size back) has the exact LCP (the
// suffix table's, at most n - pos); selection is by min(LCP, fb), the
// nearest on ties, and the chosen length is the uncapped LCP (0 below
// kMinMatch).  With no candidate in the window the distance is the
// smallest of all k (clamped at 0), as the reference's selection gives.
// ln: the lane's rank and table (search_list::Lane's rank, T, max_n, n,
// dict_size).
LZT_HD void best_match(const search_list::Lane& ln, const int32_t* sorted,
                       const int64_t* order, int64_t j, int k, int fb,
                       int64_t* best_len, int64_t* best_dist) {
  const int64_t p = order[j];
  const int64_t rp = ln.rank[p];
  const int64_t room = ln.n - p > 0 ? ln.n - p : 0;
  int64_t sel[kMaxCandidates], dist[kMaxCandidates], lf[kMaxCandidates];
  int64_t top = -1;
  for (int c = 0; c < k; ++c) {
    const int64_t r = j - (c + 1);
    const int64_t q = r >= 0 && sorted[r] == sorted[j] ? order[r] : -1;
    const bool in = q >= 0 && p - q <= ln.dict_size && q < p;
    int64_t len = 0;
    if (in) {
      len = search_list::lcp_query(ln, rp, q);
      if (len > room) len = room;
    }
    lf[c] = len;
    sel[c] = in ? (len < fb ? len : fb) : -1;
    dist[c] = p - q - 1;
    if (sel[c] > top) top = sel[c];
  }
  int64_t bd = int64_t{1} << 30;
  for (int c = 0; c < k; ++c) {
    if (sel[c] == top && dist[c] < bd) bd = dist[c];
  }
  int64_t bl = 0;
  for (int c = 0; c < k; ++c) {
    if (sel[c] == top && dist[c] == bd && lf[c] > bl) bl = lf[c];
  }
  *best_len = top >= search_list::kMinMatch ? bl : 0;
  *best_dist = bd > 0 ? bd : 0;
}

}  // namespace lazy_search
