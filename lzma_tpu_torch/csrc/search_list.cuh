// The per-position closed forms of the optimal parse's candidate search
// (csrc/search.cu, K9-K11), in the order of
// lzma_tpu_torch/ops/device_matcher.py's plain versions:
//   K9  a position's sort keys from its 32-byte window: the suffix
//       order's packed prefix words (_search_keys_plain, as _pack_keys
//       packs them) and the tier hashes (_tier_hashes) as int32 keys;
//   K10 each place's window as big-endian 32-bit words (16-byte aligned
//       chunks of the lane's row, their words joined by a funnel shift; a
//       window that crosses max_n byte by byte with a running index),
//       the consecutive LCP of
//       two suffixes by those words (_suffix_table_plain at depth <= 32),
//       and an entry of a table level wider than the tile: from the
//       level below at j and j - 2^k (one wrap), or, where max_n is a
//       multiple of kTableTile, from the same column of the level below
//       (its column-stripe form);
//   K11 a position's candidates at each tier's ranks (_neighbor_step)
//       into its candidate row, their dedup and cap (_dedup_cap: "rr"
//       keep-first in round-robin tier order, else the nearest), the
//       exact lengths by two reads of the sparse min table (_lcp_query),
//       and the merge that keeps strictly increasing lengths at ascending
//       distance (_match_lists_plain);
//   K21 a position's DP pairs and the seed's longest pair from its list
//       (device_parser._list_pairs_plain: _select_dp_pairs and the head
//       of _seed_from_lists).
//
// Plain C++ under LZT_HD, so that a host compiler can build it too (the
// CPU tests hold it to the plain versions through a g++ build).  Hash
// arithmetic is uint32_t, as the reference's; positions and lane offsets
// are int64_t (a lane's table passes 2^31 entries at 8 Mi positions).

#pragma once

#include <cstdint>
#include <cstring>

#ifndef LZT_HD
#if defined(__CUDACC__)
#define LZT_HD __host__ __device__ __forceinline__
#else
#define LZT_HD inline
#endif
#endif

#if defined(__CUDACC__)
#define LZT_UNROLL _Pragma("unroll")
#else
#define LZT_UNROLL
#endif

namespace search_list {

constexpr int kSpans = 7;          // device_matcher.TIER_SPANS: 2 3 4 6 8 16 32
constexpr int kWindow = 32;        // bytes a position's keys read
constexpr uint32_t kMark = 0x80000000u;
constexpr int64_t kBig = 1LL << 30;
constexpr int kMinMatch = 2;       // device_matcher.MIN_MATCH
constexpr uint32_t kMul0 = 2654435761u, kMul1 = 2246822519u,
                   kMul2 = 3266489917u, kMul3 = 668265263u;

LZT_HD int span_of(int i) {
  return i < 3 ? i + 2 : i == 3 ? 6 : i == 4 ? 8 : i == 5 ? 16 : 32;
}

LZT_HD int clz32(uint32_t x) {  // x != 0
#if defined(__CUDA_ARCH__)
  return __clz(static_cast<int>(x));
#else
  return __builtin_clz(x);
#endif
}

// ------------------------------------------------------------------ K9
// w: the kWindow bytes at pos, pos + 1, ... (wrapping at the lane's
// max_n, as the reference's rolls do).

// Big-endian word k of the window.
LZT_HD uint32_t word_at(const uint8_t* w, int k) {
  return (static_cast<uint32_t>(w[4 * k]) << 24) |
         (static_cast<uint32_t>(w[4 * k + 1]) << 16) |
         (static_cast<uint32_t>(w[4 * k + 2]) << 8) |
         static_cast<uint32_t>(w[4 * k + 3]);
}

// Word k of the suffix order's keys: word 0 marked 0x80000000 ^ pos
// where pos >= n.
LZT_HD uint32_t suffix_word(const uint8_t* w, int k, int64_t pos, int64_t n) {
  return k == 0 && pos >= n ? kMark ^ static_cast<uint32_t>(pos)
                            : word_at(w, k);
}

// Packed key k of nw words: (w[2k] - 2^31) * 2^32 + w[2k + 1], or
// w[2k] alone where 2k + 1 == nw.
LZT_HD int64_t suffix_key(const uint8_t* w, int k, int nw, int64_t pos,
                          int64_t n) {
  const int64_t hi = suffix_word(w, 2 * k, pos, n);
  if (2 * k + 1 >= nw) return hi;
  return (hi - (1LL << 31)) * (1LL << 32) +
         static_cast<int64_t>(suffix_word(w, 2 * k + 1, pos, n));
}

// The tier hashes of the spans in `mask` (bit i: span_of(i)), each
// marked 0x80000000 ^ pos where pos + span - 1 >= n, as int32 keys h ^
// 0x80000000 (h - 2^31, whose signed order is h's unsigned order), into
// out[i]; the other entries of out are 0.
LZT_HD void tier_keys(const uint8_t* w, int64_t pos, int64_t n, int mask,
                      int32_t* out) {
  uint32_t h[kSpans];
  h[0] = w[0] | (static_cast<uint32_t>(w[1]) << 8);
  h[1] = h[0] | (static_cast<uint32_t>(w[2]) << 16);
  h[2] = w[0] * kMul0 ^ w[1] * kMul1 ^ w[2] * kMul2 ^ w[3] * kMul3;
  // the longer hashes extend the 4-, 8- and 16-byte ones byte by byte
  uint32_t x = h[2];
  for (int i = 4; i < 6; ++i) x = x * kMul0 ^ w[i] * kMul1;
  h[3] = x;
  for (int i = 6; i < 8; ++i) x = x * kMul0 ^ w[i] * kMul1;
  h[4] = x;
  h[5] = h[6] = 0;
  if (mask & 0x60) {
    for (int i = 8; i < 16; ++i) x = x * kMul0 ^ w[i] * kMul1;
    h[5] = x;
    if (mask & 0x40) {
      for (int i = 16; i < 32; ++i) x = x * kMul0 ^ w[i] * kMul1;
      h[6] = x;
    }
  }
LZT_UNROLL
  for (int i = 0; i < kSpans; ++i) {
    const uint32_t v = pos + span_of(i) - 1 < n
                           ? h[i] : kMark ^ static_cast<uint32_t>(pos);
    out[i] = mask >> i & 1 ? static_cast<int32_t>(v ^ kMark) : 0;
  }
}

// ----------------------------------------------------------------- K10
constexpr int kWords = kWindow / 4;   // a window's prefix words
constexpr int kTableTile = 2048;      // places a tile of levels 1..11
constexpr int kTableTileLevels = 11;  // 2^11 - 1 <= the tile's halo

// The equal leading bytes of two suffixes' nw prefix words
// (window_words', big-endian: word 0 is marked past n here), clamped to
// depth.
LZT_HD int consecutive_lcp_words(const uint32_t* wa, int64_t pa,
                                 const uint32_t* wb, int64_t pb, int64_t n,
                                 int nw, int depth) {
  int cl = 0;
LZT_UNROLL
  for (int k = 0; k < kWords; ++k) {
    if (k < nw) {
      uint32_t a = wa[k], b = wb[k];
      if (k == 0) {
        if (pa >= n) a = kMark ^ static_cast<uint32_t>(pa);
        if (pb >= n) b = kMark ^ static_cast<uint32_t>(pb);
      }
      const uint32_t x = a ^ b;
      if (x != 0) {
        cl += clz32(x) >> 3;
        break;
      }
      cl += 4;
    }
  }
  return cl < depth ? cl : depth;
}

// The four little-endian words of the 16-byte aligned chunk at p.
LZT_HD void aligned_chunk(const uint8_t* p, uint32_t* w) {
#if defined(__CUDA_ARCH__)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
#else
  memcpy(w, p, 16);
#endif
}

// Bytes s / 8 .. s / 8 + 3 of the little-endian pair (lo, hi), s in 0..31.
LZT_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, s);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> s);
#endif
}

LZT_HD uint32_t bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// The nw big-endian words (word_at's) of the window at place o < max_n
// of a lane's row, wrapping at max_n, into out.  A window that ends
// within the row reads the 16-byte aligned chunks that hold its bytes
// (no chunk past the one holding its last byte), shifts them down to its
// first word and joins each pair of words by a funnel shift; one that
// crosses max_n takes its bytes one by one with a running index.
LZT_HD void window_words(const uint8_t* row, int64_t max_n, int64_t o, int nw,
                         uint32_t* out) {
  if (o + 4 * nw <= max_n) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(row + o);
    const uint8_t* base =
        reinterpret_cast<const uint8_t*>(at & ~uintptr_t{15});
    const int off = static_cast<int>(at & 15);
    const int chunks = (off + 4 * nw + 15) >> 4;
    uint32_t w[13];
LZT_UNROLL
    for (int c = 0; c < 3; ++c) {
      if (c < chunks) {
        aligned_chunk(base + 16 * c, w + 4 * c);
      } else {
        w[4 * c] = w[4 * c + 1] = w[4 * c + 2] = w[4 * c + 3] = 0;
      }
    }
    w[12] = 0;
    // down by off / 4 words, by selects on fixed indices
LZT_UNROLL
    for (int j = 0; j < 12; ++j) {
      if (off & 4) w[j] = w[j + 1];
    }
LZT_UNROLL
    for (int j = 0; j < 11; ++j) {
      if (off & 8) w[j] = w[j + 2];
    }
    const int s = (off & 3) * 8;
LZT_UNROLL
    for (int k = 0; k < kWords; ++k) {
      if (k < nw) out[k] = bswap32(funnel_r(w[k], w[k + 1], s));
    }
    return;
  }
  int64_t q = o;
  for (int k = 0; k < nw; ++k) {
    uint32_t x = 0;
    for (int b = 0; b < 4; ++b) {
      x = (x << 8) | row[q];
      if (++q == max_n) q = 0;
    }
    out[k] = x;
  }
}

// Level k + 1's entry j of a lane's table from level k (Tk): the min of
// Tk at j and at j - 2^k, wrapped once (2^k < max_n below the top
// level).
LZT_HD int32_t level_entry(const int32_t* Tk, int64_t j, int k,
                           int64_t max_n) {
  int64_t q = j - (int64_t{1} << k);
  if (q < 0) q += max_n;
  const int32_t a = Tk[j], b = Tk[q];
  return a < b ? a : b;
}

// The column-stripe form past the tile, where max_n = rows * kTableTile:
// level k > kTableTileLevels's entry at place t * kTableTile + c is the
// min of level k - 1's at rows t and t - 2^(k - 12) (mod rows) of the
// same column c.  The rows a level steps back (2^(k - 12) mod rows):
LZT_HD int stripe_step(int k, int rows) {
  int64_t s = 1;
  for (int i = kTableTileLevels + 1; i < k; ++i) s = (2 * s) % rows;
  return static_cast<int>(s % rows);
}

// The entry at row t, column c of a stripe of `cols` columns from the
// level below's stripe `prev` (row-major, rows x cols), stepping back
// `step` rows.
LZT_HD int32_t stripe_entry(const int32_t* prev, int cols, int t, int c,
                            int step, int rows) {
  int u = t - step;
  if (u < 0) u += rows;
  const int32_t a = prev[t * cols + c], b = prev[u * cols + c];
  return a < b ? a : b;
}

// ----------------------------------------------------------------- K11
// One lane's suffix rank and (levels, max_n) min table; n and the
// dictionary size.
struct Lane {
  const int64_t* rank;
  const int32_t* T;
  int64_t max_n, n, dict_size;
};

// A tier's inverse word for place i of its stable order (key: the tier's
// sort values): i, and where packed, from bit rbits up, d = how many of
// the places just before i hold i's key, at most dmax (the tier's largest
// rank): its candidate at rank j <= dmax is there iff j <= d.
LZT_HD uint32_t inverse_word(const int32_t* key, int64_t i, int dmax,
                             int rbits, bool packed) {
  if (!packed) return static_cast<uint32_t>(i);
  const int32_t own = key[i];
  int d = 0;
  while (d < dmax && d < i && key[i - d - 1] == own) ++d;
  return static_cast<uint32_t>(i) | (static_cast<uint32_t>(d) << rbits);
}

// The candidates of the position whose inverse word in a tier is `word`
// (its place r; key, ord: the tier's sort values and indices), one for
// each of the tier's k (rank j, column c) pairs in tcols: the position
// at place r - j where r >= j and the key there is r's, else -1
// (_neighbor_step's roll: a rank past max_n has r < j everywhere), into
// row[c].  Packed, the word's d says which ranks are there, and no key
// is read.
LZT_HD void tier_candidates(const int32_t* key, const int64_t* ord,
                            uint32_t word, int rbits, bool packed,
                            const int32_t* tcols, int k, int32_t* row) {
  if (packed) {
    const int64_t r = word & ((uint64_t{1} << rbits) - 1);
    const int64_t d = word >> rbits;
    for (int i = 0; i < k; ++i) {
      const int j = tcols[2 * i];
      row[tcols[2 * i + 1]] = j <= d ? static_cast<int32_t>(ord[r - j]) : -1;
    }
    return;
  }
  const int64_t r = word;
  const int32_t own = key[r];
  for (int i = 0; i < k; ++i) {
    const int j = tcols[2 * i];
    row[tcols[2 * i + 1]] =
        r >= j && key[r - j] == own ? static_cast<int32_t>(ord[r - j]) : -1;
  }
}

// The inverse words' layout for lanes of max_n places and ranks up to
// max_rank: the place's bits, and whether the run counts fit above them.
// The program's tiers (DP_TIERS', the hybrid's) have ranks of at most
// 12, packed in lanes of up to 2^28 places; the unpacked form keeps the
// contract, which takes any ranks, as the plain version does.
LZT_HD int place_bits(int64_t max_n) {
  int b = 1;
  while ((int64_t{1} << b) < max_n) ++b;
  return b;
}
LZT_HD bool inverse_packed(int64_t max_n, int max_rank) {
  int dbits = 1;
  while ((int64_t{1} << dbits) <= max_rank) ++dbits;
  return place_bits(max_n) + dbits <= 32;
}

// Rows [0, n) of e int64 words: row i's words from src + i * s_stride
// into dst + i * d_stride, the words k = first, first + step, ... of the
// n * e (a block's threads: first its thread, step its size).
LZT_HD void copy_rows(const int64_t* src, int64_t s_stride, int64_t* dst,
                      int64_t d_stride, int n, int e, int first, int step) {
  if (e <= 0) return;
  const int di = step / e, dw = step - di * e;  // a step in rows and words
  int i = first / e, w = first - i * e;
  for (int k = first; k < n * e; k += step) {
    dst[i * d_stride + w] = src[i * s_stride + w];
    i += di;
    w += dw;
    if (w >= e) {
      w -= e;
      ++i;
    }
  }
}

// A list of candidate positions kept in descending order.  RegList's
// entries are registers when every loop over them unrolls (kCap a
// constant), -1 where unused; RowList keeps them in a caller's int64 row.
template <int kCap>
struct RegList {
  static constexpr int kBound = kCap;
  int32_t a[kCap];
  LZT_HD RegList() {
LZT_UNROLL
    for (int i = 0; i < kCap; ++i) a[i] = -1;
  }
  LZT_HD int64_t get(int i) const { return a[i]; }
  LZT_HD void set(int i, int64_t v) { a[i] = static_cast<int32_t>(v); }
};

struct RowList {
  static constexpr int kBound = 0;  // loops run to the list's length
  int64_t* a;
  LZT_HD int64_t get(int i) const { return a[i]; }
  LZT_HD void set(int i, int64_t v) { a[i] = v; }
};

// Insert v >= 0 into the descending list of `len` entries, at most cap:
// a value already there is skipped, and a full list drops its smallest
// (v itself where it is the smallest).
template <class L>
LZT_HD void insert(L& list, int& len, int cap, int64_t v) {
  const int bound = L::kBound ? L::kBound : len;
  int at = 0;
  bool seen = false;
LZT_UNROLL
  for (int i = 0; i < bound; ++i) {
    if (i < len) {
      const int64_t x = list.get(i);
      seen = seen || x == v;
      at += x > v;
    }
  }
  if (seen || at >= cap) return;
  const int last = len < cap ? len : cap - 1;  // the slot that gets filled
  if (L::kBound) {
LZT_UNROLL
    for (int i = L::kBound - 1; i > 0; --i) {
      if (i <= last && i > at) list.set(i, list.get(i - 1));
    }
LZT_UNROLL
    for (int i = 0; i < L::kBound; ++i) {
      if (i == at) list.set(i, v);
    }
  } else {
    for (int i = last; i > at; --i) list.set(i, list.get(i - 1));
    list.set(at, v);
  }
  if (len < cap) ++len;
}

// A register list kept in arrival order (every value kept until cap,
// none dropped by value): v >= 0 joins at the front unless it is there
// already (the unused entries are -1) or the list holds cap.
template <class L>
LZT_HD void push(L& list, int& len, int cap, int64_t v) {
  bool seen = false;
LZT_UNROLL
  for (int i = 0; i < L::kBound; ++i) seen = seen || list.get(i) == v;
  if (seen || len >= cap) return;
LZT_UNROLL
  for (int i = L::kBound - 1; i > 0; --i) list.set(i, list.get(i - 1));
  if (L::kBound) list.set(0, v);
  ++len;
}

// A register list's entries in descending order (a bitonic network; the
// unused -1 entries go last).
template <class L>
LZT_HD void sort_desc(L& list) {
LZT_UNROLL
  for (int k = 2; k <= L::kBound; k <<= 1) {
LZT_UNROLL
    for (int j = k >> 1; j > 0; j >>= 1) {
LZT_UNROLL
      for (int i = 0; i < L::kBound; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int64_t x = list.get(i), y = list.get(l);
          if ((x < y) == ((i & k) == 0)) {
            list.set(i, y);
            list.set(l, x);
          }
        }
      }
    }
  }
}

// The kept candidates of a position, descending, into `list` from its row
// of m candidates in the take order (the round-robin order for "rr",
// else the column order); returns their count.  rr: keep-first until cap
// are kept; otherwise the cap largest of all.  A register list that
// drops none by value (rr, or cap >= m) takes them in arrival order and
// sorts once at the end (faster than `insert` alone: PERF.md,
// bench/kernel_split.py k11_insert_only).
template <class L>
LZT_HD int gather_row(const int32_t* row, int m, bool rr, int cap, L& list) {
  const bool arrival = L::kBound > 0 && (rr || cap >= m);
  int len = 0;
  for (int c = 0; c < m; ++c) {
    const int32_t v = row[c];
    if (v < 0) continue;
    if (arrival) push(list, len, cap, v); else insert(list, len, cap, v);
    if (rr && len == cap) break;
  }
  if (arrival) sort_desc(list);
  return len;
}

// Exact LCP of suffix p (rank rp) and candidate c >= 0 by two reads of
// the sparse min table (_lcp_query); 0 where c's rank is p's.
LZT_HD int64_t lcp_query(const Lane& ln, int64_t rp, int64_t c) {
  const int64_t rq = ln.rank[c < ln.max_n ? c : ln.max_n - 1];
  const int64_t a = (rp < rq ? rp : rq) + 1;
  const int64_t b = rp < rq ? rq : rp;
  const int64_t w = b - a + 1;
  if (w < 1) return 0;
  const int k = 31 - clz32(static_cast<uint32_t>(w));
  const int32_t* Tk = ln.T + static_cast<int64_t>(k) * ln.max_n;
  int64_t a2 = a + (1LL << k) - 1;
  if (a2 > ln.max_n - 1) a2 = ln.max_n - 1;
  const int32_t v1 = Tk[b], v2 = Tk[a2];
  return v1 < v2 ? v1 : v2;
}

// Position p's merged list from its `len` kept candidates: each one in
// the dictionary window gets its exact length (at most n - p) and
// distance p - c - 1; a pair is kept where its length is at least
// kMinMatch and longer than every nearer candidate's.  Writes the kept
// pairs to lens and dists [0, count) and zeros to [count, width);
// returns count.  A RowList may be dists itself: a pair is written at or
// before the entry it was read from.
template <class L>
LZT_HD int merge(const Lane& ln, int64_t p, const L& list, int len, int width,
                 int64_t* lens, int64_t* dists) {
  const int64_t rp = ln.rank[p];
  const int64_t room = ln.n - p > 0 ? ln.n - p : 0;
  int64_t runmax = 0;
  int count = 0;
  const int bound = L::kBound ? L::kBound : len;
LZT_UNROLL
  for (int j = 0; j < bound; ++j) {
    if (j < len) {
      const int64_t c = list.get(j);
      if (c < p && p - c <= ln.dict_size) {
        int64_t l = lcp_query(ln, rp, c);
        if (l > room) l = room;
        const int64_t d = p - c - 1;
        if (l >= kMinMatch && l > runmax && d < kBig) {
          lens[count] = l;
          dists[count] = d;
          ++count;
        }
        if (l > runmax) runmax = l;
      }
    }
  }
  for (int j = count; j < width; ++j) {
    lens[j] = 0;
    dists[j] = 0;
  }
  return count;
}

// Position p's list from its candidate row: the kept candidates, then
// the merge into lens and dists (width entries each).  kCap > 0: the
// list in registers (kCap >= cap); 0: in dists itself.  The row may share
// memory with lens and dists (it is read before they are written) where
// kCap > 0.  Returns the count.
template <int kCap>
LZT_HD int list_position(const Lane& ln, int64_t p, const int32_t* row,
                         int m, bool rr, int cap, int width, int64_t* lens,
                         int64_t* dists) {
  if constexpr (kCap > 0) {
    RegList<kCap> list;
    const int len = gather_row(row, m, rr, cap, list);
    return merge(ln, p, list, len, width, lens, dists);
  } else {
    RowList list{dists};
    const int len = gather_row(row, m, rr, cap, list);
    return merge(ln, p, list, len, width, lens, dists);
  }
}

// ----------------------------------------------------------------- K21
constexpr int kSeedMinLen = 4;  // device_parser.SEED_MIN_LEN

// The list entry a position's longest pair is at: count - 1, 0 for an
// empty list (kept inside the width: the lists never count past it).
LZT_HD int last_entry(int64_t count, int width) {
  return count < 1 ? 0 : count > width ? width - 1 : static_cast<int>(count - 1);
}

// A position's m_dp DP pairs (ld, dd) from its list's first m_dp entries
// (head_l, head_d) and its last (last_l, last_d): dd = -1 where the
// length is below 2, and the last entry in slot m_dp - 1 where the list
// is deeper than m_dp; and the seed's pair (bl, bd), the last entry where
// the list is not empty and its length is at least kSeedMinLen, else 0.
LZT_HD void list_pairs(const int64_t* head_l, const int64_t* head_d,
                       int64_t last_l, int64_t last_d, int64_t count,
                       int m_dp, int64_t* ld, int64_t* dd, int64_t* bl,
                       int64_t* bd) {
  for (int k = 0; k < m_dp; ++k) {
    ld[k] = head_l[k];
    dd[k] = head_l[k] >= 2 ? head_d[k] : -1;
  }
  if (count > m_dp) {
    ld[m_dp - 1] = last_l;
    dd[m_dp - 1] = last_d;
  }
  const bool has = count > 0 && last_l >= kSeedMinLen;
  *bl = has ? last_l : 0;
  *bd = has ? last_d : 0;
}

}  // namespace search_list
