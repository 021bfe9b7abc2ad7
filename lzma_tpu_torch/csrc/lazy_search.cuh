// The closed forms of the lazy search (csrc/lazy_search.cu, K15-K17), in
// the order of lzma_tpu_torch/ops/device_matcher.py's plain versions:
//   K15 whether a suffix starts a new group of the prefix doubling against
//       the suffix before it in the level's order: by the 8 prefix words
//       (word 0 marked past n) at the 32-byte level, read as 32-bit words
//       (search_list::window_words), else by the level's sorted key,
//       which holds the previous level's ids at i and i + span as one
//       number; then the next sort's key (_doubling_groups_plain);
//   K16 the consecutive LCP of two suffixes at full depth: the binary
//       descent over the group levels, then the <=32-byte refinement by
//       prefix words, each index wrapped once and clamped
//       (_descent_lcp_plain): where no word reaches 2 max_n (every lane
//       past 508 places) two 32-byte windows read as words, else a byte
//       at a time; in a lane past 508 places the first 32-byte keys
//       first, and no id read where they differ (the levels are the
//       doubling's: equal ids exactly where the keys are equal);
//   K17 a position's best match among its hash-sort neighbours, from a
//       tile's staged keys, positions and ranks (_best_matches_plain).
//
// Plain C++ under LZT_HD, as search_list.cuh is written (whose
// window_words and clz32 these reuse), so that a host compiler can build
// it too (the CPU tests hold it to the plain versions through a g++
// build).  Words are uint32_t, as the reference's; group ids and keys are
// int64_t; K15's and K17's places and positions inside a lane are int
// (a lane holds fewer than 2^31 places), table offsets int64_t.

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
// i + s wrapped at max_n, for 0 <= i < max_n and 0 <= s < max_n (a span
// taken mod max_n once a call): a conditional subtract.
LZT_HD int wrap_add(int i, int s, int max_n) {
  const int j = i + s;
  return j >= max_n ? j - max_n : j;
}

// The 32-byte level's key of the suffix at o < max_n of a lane's row:
// its 8 big-endian prefix words, wrapping at max_n, word 0 marked
// 0x80000000 ^ o where o >= n.
LZT_HD void marked_words(const uint8_t* row, int max_n, int64_t n, int o,
                         uint32_t* w) {
  search_list::window_words(row, max_n, o, kWords, w);
  if (o >= n) w[0] = kMark ^ static_cast<uint32_t>(o);
}

// Whether two suffixes' marked words differ (compared exactly: a data
// word may equal a mark).
LZT_HD bool words_differ(const uint32_t* a, const uint32_t* b) {
  bool differ = false;
LZT_UNROLL
  for (int k = 0; k < kWords; ++k) differ = differ || a[k] != b[k];
  return differ;
}

// A doubling level's flag at a place past the first of its order: its
// key (the previous level's ids at i and at i + span, as ids[i] * max_n +
// ids[i + span], which next_key built and the sort kept beside the order)
// differs from the place before's.  Ids are below max_n, so two keys are
// equal exactly where both ids are: the reference's two gathers a place.
LZT_HD bool key_differs(int64_t key, int64_t before) { return key != before; }

// The next sort's key of place i from this level's ids: ids[i] * max_n
// + ids[(i + span) mod max_n], s = span mod max_n (ids < max_n, so the
// key is unique to the pair and keeps its order).
LZT_HD int64_t next_key(const int64_t* ids, int max_n, int s, int i) {
  return ids[i] * max_n + ids[wrap_add(i, s, max_n)];
}

// ----------------------------------------------------------------- K16
// One wrap past the end, then the clamp an out-of-range gather index
// gets in the reference (_wrap_once).
LZT_HD int64_t wrap_once(int64_t i, int64_t max_n) {
  if (i >= max_n) i -= max_n;
  return i < max_n ? i : max_n - 1;
}

LZT_HD int wrap_once(int i, int max_n) {
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
// b + l share a level's group, l advances by its bytes.  Places are
// below max_n < 2^30 and l below 2^9, so every index is a 32-bit int.
LZT_HD int descend(const int64_t* const* g, int n_levels, int max_n, int a,
                   int b) {
  int l = 0;
  for (int t = n_levels - 1; t >= 0; --t) {
    const int ia = wrap_once(a + l, max_n), ib = wrap_once(b + l, max_n);
    if (g[t][ia] == g[t][ib]) l += 32 << t;
  }
  return l;
}

// The <=32-byte refinement after the descent: the equal leading bytes of
// 8 words, word w at index a + l + 4w (and b's), each wrapped once and
// clamped on its own; word 0 is the marked one at its index.  The path
// for words that reach 2 max_n (then a clamped index breaks the window),
// a byte and a remainder at a time.
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

// Whether the refinement's last word of both suffixes starts below
// 2 max_n: then each word's index, wrapped once, is its index mod max_n
// and no clamp applies, so the 8 words are the continuous 32-byte window
// (wrapping at max_n) at a + l wrapped once.
LZT_HD bool words_inside(int max_n, int a, int b, int l) {
  const int last = l + 4 * (kWords - 1);
  return a + last < 2 * max_n && b + last < 2 * max_n;
}

// refine where words_inside holds: the two windows read as words
// (search_list::window_words: 16-byte loads joined by a funnel shift; a
// window that crosses max_n byte by byte) and compared a word at a time
// (consecutive_lcp_words, word 0 marked past n), 32-bit indices.
LZT_HD int refine_words(const uint8_t* row, int max_n, int64_t n, int a,
                        int b, int l) {
  int ia = a + l, ib = b + l;
  if (ia >= max_n) ia -= max_n;
  if (ib >= max_n) ib -= max_n;
  uint32_t wa[kWords], wb[kWords];
  search_list::window_words(row, max_n, ia, kWords, wa);
  search_list::window_words(row, max_n, ib, kWords, wb);
  return search_list::consecutive_lcp_words(wa, ia, wb, ib, n, kWords,
                                            kWindow);
}

// A lane wider than this many places keeps every index of the descent
// and the refinement below 2 max_n (a + 480 + 28 < 2 max_n): none is
// clamped, each word's index is its index mod max_n.
constexpr int kWideLane = 508;

// The consecutive LCP at place i of the final order (its suffix a, the
// one before it b), clamped to depth; 0 at place 0.  A lane's places are
// below 2^30 (max_n), so the descent and the usual refinement run on
// 32-bit ints.  In a wide lane the first 32 bytes come first: where the
// two suffixes' 32-byte marked keys differ, every level's ids differ at
// a and b (the levels are the doubling's, whose ids are equal exactly
// where their keys are, and each level's key starts with that one), so
// the descent would stay at 0 and the LCP is those words' alone; no id
// is read.  Else the descent, then the refinement at its length.
LZT_HD int deep_lcp(const int64_t* const* g, int n_levels, const uint8_t* row,
                    int max_n, int64_t n, int i, int a, int b, int depth) {
  if (i == 0) return 0;
  const int head = max_n > kWideLane ? refine_words(row, max_n, n, a, b, 0)
                                     : kWindow;
  if (head < kWindow) return head < depth ? head : depth;
  const int l = descend(g, n_levels, max_n, a, b);
  const int r = words_inside(max_n, a, b, l)
                    ? refine_words(row, max_n, n, a, b, l)
                    : refine(row, max_n, n, a, b, l);
  return l + r < depth ? l + r : depth;
}

// ----------------------------------------------------------------- K17
// A tile of the hash key's stable order as a block stages it: for each
// staged place, its key, its position and that position's rank in the
// suffix order (rank[order[r]], read once a place).  Place j of the lane
// sits at stage index j - first.
struct Staged {
  const int32_t* key;
  const int32_t* pos;
  const int32_t* rank;
  int first;
};

// The lane's table and what bounds a candidate (search_list::Lane's,
// with 32-bit places).
struct Table {
  const int32_t* T;  // (levels, max_n) int32
  int max_n;
  int64_t n, dict_size;
};

// Exact LCP of the suffixes at ranks rp and rq by two reads of the sparse
// min table (search_list::lcp_query); 0 where the ranks are equal.
LZT_HD int lcp_ranks(const Table& tb, int rp, int rq) {
  const int a = (rp < rq ? rp : rq) + 1;
  const int b = rp < rq ? rq : rp;
  const int w = b - a + 1;
  if (w < 1) return 0;
  const int k = 31 - search_list::clz32(static_cast<uint32_t>(w));
  const int32_t* Tk = tb.T + static_cast<int64_t>(k) * tb.max_n;
  int a2 = a + (1 << k) - 1;
  if (a2 > tb.max_n - 1) a2 = tb.max_n - 1;
  const int32_t v1 = Tk[b], v2 = Tk[a2];
  return v1 < v2 ? v1 : v2;
}

// One candidate into the selection: the largest min(LCP, fb) (-1 for a
// candidate out of the window), then the nearest, then the longest, as
// the reference's three reductions over the k candidates rank them.
LZT_HD void take(int sel, int dist, int len, int* top, int* bd, int* bl) {
  if (sel > *top || (sel == *top && (dist < *bd || (dist == *bd && len > *bl)))) {
    *top = sel;
    *bd = dist;
    *bl = len;
  }
}

// The best match of the position at place j of the hash key's stable
// order: its candidates are the positions at places j - 1 .. j - k
// where the key there is its own (else none, position -1).  The order is
// sorted, so the candidates are a run of places just before j: the
// loop stops at the first key that differs, and the k - m places past a
// run of m < k stand for one candidate of position -1 (distance p, out
// of the window).  A candidate in the window (before the position, at
// most dict_size back) has the exact LCP (the table's, at most n - pos);
// selection is by min(LCP, fb), the nearest on ties, and the chosen
// length is the uncapped LCP (0 below kMinMatch).  With no candidate in
// the window the distance is the smallest of all k (clamped at 0), as
// the reference's selection gives.
LZT_HD void best_staged(const Staged& st, const Table& tb, int j, int k,
                        int fb, int64_t* best_len, int64_t* best_dist) {
  const int s = j - st.first;
  const int32_t own = st.key[s];
  const int p = st.pos[s], rp = st.rank[s];
  const int64_t room = tb.n - p > 0 ? tb.n - p : 0;
  int top = -2, bd = 1 << 30, bl = 0;
  int c = 1;
  for (; c <= k && c <= j; ++c) {
    if (st.key[s - c] != own) break;
    const int q = st.pos[s - c];
    const bool in = q < p && p - q <= tb.dict_size;
    int len = 0;
    if (in) {
      len = lcp_ranks(tb, rp, st.rank[s - c]);
      if (len > room) len = static_cast<int>(room);
    }
    take(in ? (len < fb ? len : fb) : -1, p - q - 1, in ? len : 0, &top, &bd,
         &bl);
  }
  if (c <= k) take(-1, p, 0, &top, &bd, &bl);
  *best_len = top >= search_list::kMinMatch ? bl : 0;
  *best_dist = bd > 0 ? bd : 0;
}

}  // namespace lazy_search
