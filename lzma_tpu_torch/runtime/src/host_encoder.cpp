// The host half of the hybrid encode: an LZMA encoder over candidate lists
// or token streams, multithreaded over blocks.
//
// The encoder half of lzma_tpu/runtime/src/lzma_core.cpp, copied with its
// behaviour unchanged: the static tables, the probability layout and the
// range encoder, the match finders (BT2/BT4/HC4/FAST4 and CAND, the
// precomputed candidate lists), the optimal and lazy parsers with symbol
// emission, and the token serializer.  The decoder half is left out.  Five
// C entries: lzt_encode (one raw stream; the trained dictionary of an LZTB
// v3 container), lzt_encode_pre (one raw stream after a preset: the sizing
// of a trained dictionary's candidates), lzt_encode_bound,
// lzt_encode_token_blocks (the hybrid's lazy half) and
// lzt_encode_candidate_blocks (its optimal half).  Output is
// byte-identical to the original library's (tests/test_torch_hybrid.py).
//
// Reference behavior pinned against (semantics, not code):
//   range coder      RangeEncoder.java:23-87
//   match finders    BinTree.java:59-356
//   optimal parse    Encoder.java:275-811
//   symbol emission  Encoder.java:818-1024

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>
#if defined(__linux__)
#include <sys/mman.h>
#endif

namespace {
// Hint the kernel to back a large allocation with huge pages BEFORE the
// pages are first touched (reserve -> madvise -> fault-in): the match
// finder's son[]/hash[] are multi-MB arrays walked in random order, so
// dTLB misses are a first-order cost of the tree search on big
// dictionaries.  No-op when THP is unavailable; harmless when the
// region is small.
inline void hint_huge(void* p, size_t bytes) {
#if defined(__linux__) && defined(MADV_HUGEPAGE)
  if (bytes < (2u << 20) || p == nullptr) return;
  uintptr_t a = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
  uintptr_t e = ((uintptr_t)p + bytes) & ~(uintptr_t)4095;
  if (e > a) madvise((void*)a, e - a, MADV_HUGEPAGE);
#else
  (void)p;
  (void)bytes;
#endif
}

template <typename T>
inline void assign_huge(std::vector<T>& v, size_t n, T fill) {
  if (n > v.capacity()) {
    std::vector<T>().swap(v);
    v.reserve(n);
    hint_huge(v.data(), n * sizeof(T));
  }
  v.assign(n, fill);
}
}  // namespace

namespace {

// ----------------------------------------------------------------- constants
constexpr int kNumStates = 12;
constexpr int kNumPosStatesBitsMax = 4;
constexpr int kNumPosStatesMax = 1 << kNumPosStatesBitsMax;
constexpr int kMatchMinLen = 2;
constexpr int kMatchMaxLen = 273;
constexpr int kNumLenToPosStates = 4;
constexpr int kNumPosSlotBits = 6;
constexpr int kNumAlignBits = 4;
constexpr int kAlignTableSize = 1 << kNumAlignBits;
constexpr int kAlignMask = kAlignTableSize - 1;
constexpr int kStartPosModelIndex = 4;
constexpr int kEndPosModelIndex = 14;
constexpr int kNumFullDistances = 1 << (kEndPosModelIndex / 2);
constexpr int kNumOpts = 1 << 12;
constexpr int kNumRepDistances = 4;
constexpr uint32_t kTopValue = 1u << 24;
constexpr int kNumBitModelTotalBits = 11;
constexpr uint32_t kBitModelTotal = 1u << kNumBitModelTotalBits;
constexpr int kNumMoveBits = 5;
constexpr uint16_t kProbInit = kBitModelTotal >> 1;
constexpr uint32_t kInfinityPrice = 0x0FFFFFFF;
constexpr int kNumLenSymbols = 272;

// state machine (Base.java:16-36)
inline int next_lit(int s) { return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6); }
inline int next_match(int s) { return s < 7 ? 7 : 10; }
inline int next_srep(int s) { return s < 7 ? 9 : 11; }
inline int next_lrep(int s) { return s < 7 ? 8 : 11; }
inline int len_to_pos_state(int len) {
  int v = len - kMatchMinLen;
  return v < kNumLenToPosStates ? v : kNumLenToPosStates - 1;
}

// --------------------------------------------------------- static tables
struct Tables {
  uint32_t crc[256];
  uint8_t fast_pos[1 << 11];
  uint32_t prices[kBitModelTotal >> 2];
  Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t r = i;
      for (int j = 0; j < 8; j++) r = (r >> 1) ^ ((r & 1) ? 0xEDB88320u : 0);
      crc[i] = r;
    }
    fast_pos[0] = 0;
    fast_pos[1] = 1;
    int c = 2;
    for (int slot = 2; slot < 22; slot++) {
      int k = 1 << ((slot >> 1) - 1);
      for (int j = 0; j < k; j++, c++) fast_pos[c] = (uint8_t)slot;
    }
    // piecewise-log table (ProbPrices.java:8-18)
    constexpr int kNumBits = kNumBitModelTotalBits - 2;
    for (int i = kNumBits - 1; i >= 0; i--) {
      int start = 1 << (kNumBits - i - 1), end = 1 << (kNumBits - i);
      for (int j = start; j < end; j++)
        prices[j] = (uint32_t)((i << 6) + (((end - j) << 6) >> (kNumBits - i - 1)));
    }
  }
};
const Tables T;

inline uint32_t price_of(uint32_t prob, int bit) {
  return T.prices[(((prob - bit) ^ (uint32_t)(-bit)) & (kBitModelTotal - 1)) >> 2];
}
inline uint32_t price0(uint32_t p) { return T.prices[p >> 2]; }
inline uint32_t price1(uint32_t p) { return T.prices[(kBitModelTotal - p) >> 2]; }

inline int get_pos_slot(uint32_t pos) {
  if (pos < (1u << 11)) return T.fast_pos[pos];
  if (pos < (1u << 21)) return T.fast_pos[pos >> 10] + 20;
  return T.fast_pos[pos >> 20] + 40;
}
inline int get_pos_slot2(uint32_t pos) {
  if (pos < (1u << 17)) return T.fast_pos[pos >> 6] + 12;
  if (pos < (1u << 27)) return T.fast_pos[pos >> 16] + 32;
  return T.fast_pos[pos >> 26] + 52;
}

// ------------------------------------------------------------ prob layout
// Mirrors lzma_tpu/core/layout.py exactly.
struct Layout {
  int lc, lp, pb;
  int is_match, is_rep, is_rep_g0, is_rep_g1, is_rep_g2, is_rep0_long;
  int pos_slot, spec_pos, align_;
  int len_coder, rep_len_coder, literal, size;
  explicit Layout(int lc_, int lp_, int pb_) : lc(lc_), lp(lp_), pb(pb_) {
    int off = 0;
    is_match = off; off += kNumStates << kNumPosStatesBitsMax;
    is_rep = off; off += kNumStates;
    is_rep_g0 = off; off += kNumStates;
    is_rep_g1 = off; off += kNumStates;
    is_rep_g2 = off; off += kNumStates;
    is_rep0_long = off; off += kNumStates << kNumPosStatesBitsMax;
    pos_slot = off; off += kNumLenToPosStates * 64;
    spec_pos = off; off += kNumFullDistances - kEndPosModelIndex;
    align_ = off; off += kAlignTableSize;
    len_coder = off; off += 514;
    rep_len_coder = off; off += 514;
    literal = off; off += 0x300 << (lc + lp);
    size = off;
  }
  int pos_state_mask() const { return (1 << pb) - 1; }
  int lit_sub(uint32_t pos, uint8_t prev) const {
    int ctx = (int)(((pos & ((1u << lp) - 1)) << lc) + (prev >> (8 - lc)));
    return literal + ctx * 0x300;
  }
};
// len coder internal offsets (relative)
constexpr int kLenChoice = 0, kLenChoice2 = 1, kLenLow = 2;
constexpr int kLenMid = kLenLow + kNumPosStatesMax * 8;
constexpr int kLenHigh = kLenMid + kNumPosStatesMax * 8;

// ------------------------------------------------------------ range coder
class RangeEnc {
 public:
  std::vector<uint8_t>* out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;

  void shift_low() {
    uint32_t low_hi = (uint32_t)(low >> 32);
    if (low_hi != 0 || low < 0xFF000000ull) {
      uint8_t b = (uint8_t)(cache + low_hi);
      out->push_back(b);
      uint8_t filler = (uint8_t)(0xFF + low_hi);
      while (--cache_size) out->push_back(filler);
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = (low & 0xFFFFFF) << 8;
  }
  inline void encode_bit(uint16_t* probs, int idx, int bit) {
    // Branchless select on the bit value: literal/data bits are
    // high-entropy, so a data-dependent branch here mispredicts ~half
    // the time on the hottest path of the whole encoder.
    uint32_t prob = probs[idx];
    uint32_t bound = (range >> kNumBitModelTotalBits) * prob;
    uint32_t mask = (uint32_t)0 - (uint32_t)bit;
    low += (uint64_t)(bound & mask);
    range = bound + ((range - (bound << 1)) & mask);
    uint32_t p0 = prob + ((kBitModelTotal - prob) >> kNumMoveBits);
    uint32_t p1 = prob - (prob >> kNumMoveBits);
    probs[idx] = (uint16_t)(p0 ^ ((p0 ^ p1) & mask));
    if (range < kTopValue) {
      range <<= 8;
      shift_low();
    }
  }
  void encode_direct(uint32_t v, int nbits) {
    for (int i = nbits - 1; i >= 0; i--) {
      range >>= 1;
      if ((v >> i) & 1) low += range;
      if (range < kTopValue) {
        range <<= 8;
        shift_low();
      }
    }
  }
  void encode_tree(uint16_t* probs, int base, int nbits, int symbol) {
    int m = 1;
    for (int i = nbits - 1; i >= 0; i--) {
      int bit = (symbol >> i) & 1;
      encode_bit(probs, base + m, bit);
      m = (m << 1) | bit;
    }
  }
  void encode_tree_rev(uint16_t* probs, int base, int nbits, int symbol) {
    int m = 1;
    for (int i = 0; i < nbits; i++) {
      int bit = symbol & 1;
      symbol >>= 1;
      encode_bit(probs, base + m, bit);
      m = (m << 1) | bit;
    }
  }
  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

// read_cb(ctx, buf, cap) -> bytes read (0 = EOF, <0 = error)
typedef int64_t (*lzt_read_cb)(void*, uint8_t*, int64_t);
// write_cb(ctx, buf, len) -> len on success, anything else = error
typedef int64_t (*lzt_write_cb)(void*, const uint8_t*, int64_t);

// ---------------------------------------------------------- match finders
// Exact BT2/BT4 (BinTree.java:152-356) + HC4 chain walker, in-memory block.
class MatchFinder {
 public:
  enum Kind { BT2, BT4, HC4, FAST4, CAND };
  // CAND: precomputed candidate lists (the hybrid-optimal pipeline,
  // lzma_tpu/ops/device_matcher.find_match_lists).  For buffer position p
  // the ascending (len, dist) pairs live at cand_len/cand_dist
  // [cand_off[p], cand_off[p+1]); find_matches copies them (clamped to
  // len_limit) and skip() is pure position advance — no tree work at all.
  const int32_t* cand_len = nullptr;
  const int32_t* cand_dist = nullptr;
  const int64_t* cand_off = nullptr;
  const uint8_t* buf;
  int32_t n, pos = 0;
  int match_max_len, cut_value;
  int32_t cyclic_size, cyclic_pos = 0;
  Kind kind;
  int num_direct_bytes, min_match_check;
  uint32_t hash_mask = 0;
  int fix_hash_size;
  std::vector<int32_t> hash, son;
  static constexpr int kHash2Size = 1 << 10, kHash3Size = 1 << 16;
  static constexpr int kHash3Offset = kHash2Size;

  // --- streaming mode (the reference's InWindow: ReadBlock refills from
  // the stream, MoveBlock compacts in place, Normalize rebases tree links
  // every ~2^30 positions — InWindow.java:24-63, BinTree.java:358-375).
  // Positions stay GLOBAL stream offsets; `buf` is kept as the shifted
  // base pointer owned.data() - win_start so all flat-mode indexing code
  // works unchanged.
  bool stream_mode = false;
  bool eof = true;
  bool read_error = false;
  lzt_read_cb rcb = nullptr;
  void* rctx = nullptr;
  std::vector<uint8_t> owned;
  int32_t win_start = 0;  // global position of owned[0]
  int32_t keep_before = 0, keep_after = 0;
// Position-rebase threshold; tests override it (-DLZT_NORMALIZE_LIMIT=...)
// to exercise normalize() without gigabyte streams.
#ifndef LZT_NORMALIZE_LIMIT
#define LZT_NORMALIZE_LIMIT (1 << 30)
#endif
  static constexpr int32_t kNormalizeLimit = LZT_NORMALIZE_LIMIT;

  MatchFinder(const uint8_t* b, int32_t len, int32_t dict, int mml, Kind k)
      : buf(b), n(len), match_max_len(mml), kind(k) {
    // FAST4's shallow chain is the measured speed/ratio knee (MEASUREMENTS.md).
    cut_value = k == FAST4   ? 4
                : k == HC4   ? 8 + (mml >> 2)
                             : 16 + (mml >> 1);
    // When dict >= len the window never wraps, so the cyclic buffer only
    // needs len+1 slots — identical match behavior (match_min_pos stays 0,
    // cyclic_pos == pos in both sizings), but son[] shrinks from
    // O(dict) to O(len): a 64 MB dict on a 1 MB block allocates 2 MB,
    // not 512 MB.  Hash sizing stays dict-derived (hash values must be
    // bit-identical to the reference's).
    cyclic_size = (dict < len ? dict : len) + 1;
    if (k == CAND) {
      num_direct_bytes = 0;
      min_match_check = 2;
      fix_hash_size = 0;
      // no hash/son: candidates are precomputed
      son.assign(1, 0);
      return;
    }
    if (k == BT2) {
      num_direct_bytes = 2;
      min_match_check = 3;
      fix_hash_size = 0;
      hash.assign(1 << 16, 0);
    } else if (k == FAST4) {
      // Speed-profile hash-chain finder (ours — no reference analogue):
      // one multiplicative 4-byte hash, no 2/3-byte sub-hash tables; short
      // matches are covered by the rep distances in the greedy/lazy parse.
      num_direct_bytes = 0;
      min_match_check = 4;
      fix_hash_size = 0;
      uint32_t hs = (uint32_t)dict - 1;
      hs |= hs >> 1; hs |= hs >> 2; hs |= hs >> 4; hs |= hs >> 8;
      hs >>= 1;
      hs |= 0xFFFF;
      if (hs > (1u << 24)) hs >>= 1;
      hash_mask = hs;
      assign_huge(hash, (size_t)hs + 1, 0);
    } else {
      num_direct_bytes = 0;
      min_match_check = 4;
      fix_hash_size = kHash2Size + kHash3Size;
      uint32_t hs = (uint32_t)dict - 1;
      hs |= hs >> 1; hs |= hs >> 2; hs |= hs >> 4; hs |= hs >> 8;
      hs >>= 1;
      hs |= 0xFFFF;
      if (hs > (1u << 24)) hs >>= 1;
      hash_mask = hs;
      assign_huge(hash, (size_t)hs + 1 + fix_hash_size, 0);
    }
    assign_huge(son, k == HC4 || k == FAST4 ? (size_t)cyclic_size
                                            : (size_t)cyclic_size * 2, 0);
  }

  // 4-byte multiplicative hash for the FAST4 chain (Fibonacci constant).
  inline uint32_t hash4_fast(int32_t p) const {
    uint32_t v;
    std::memcpy(&v, buf + p, 4);
    return (v * 2654435761u >> 8) & hash_mask;
  }

  // Streaming constructor: the window is fed by read_cb; the cyclic buffer
  // is dict-sized (the stream length is unknown, so the never-wraps clamp
  // of the flat constructor does not apply — this matches the reference's
  // dict-sized BinTree exactly, BinTree.java:93-134).
  MatchFinder(lzt_read_cb cb, void* ctx, int32_t dict, int mml, Kind k)
      : MatchFinder(nullptr, 0, dict, mml, k) {
    // delegate computed hash sizing/cut from a zero-length flat view, then
    // rebuild the window geometry for streaming
    cyclic_size = dict + 1;
    assign_huge(son, kind == HC4 || kind == FAST4 ? (size_t)cyclic_size
                                                  : (size_t)cyclic_size * 2, 0);
    stream_mode = true;
    eof = false;
    rcb = cb;
    rctx = ctx;
    keep_before = cyclic_size + kNumOpts + 512;
    keep_after = match_max_len + 1024;
    size_t chunk = 1 << 20;
    assign_huge(owned, (size_t)keep_before + (size_t)keep_after + chunk,
                (uint8_t)0);
    win_start = 0;
    n = 0;
    buf = owned.data();
    refill();
  }

  void refill() {
    // compact: keep [pos - keep_before, n) at the front of `owned`
    int32_t keepb = pos - win_start < keep_before ? pos - win_start : keep_before;
    int32_t new_start = pos - keepb;
    if (new_start > win_start && new_start <= n) {
      std::memmove(owned.data(), owned.data() + (size_t)(new_start - win_start),
                   (size_t)(n - new_start));
      win_start = new_start;
    }
    while (!eof) {
      size_t filled = (size_t)(n - win_start);
      size_t cap = owned.size() - filled;
      if (cap == 0) break;
      int64_t got = rcb(rctx, owned.data() + filled, (int64_t)cap);
      if (got < 0) {
        read_error = true;
        eof = true;
        break;
      }
      if (got == 0) {
        eof = true;
        break;
      }
      n += (int32_t)got;
    }
    // shifted base: buf[global_pos] == owned[global_pos - win_start]
    // signed shift: win_start may be negative after a normalize() rebase
    buf = (const uint8_t*)((intptr_t)owned.data() - (intptr_t)win_start);
  }

  // Rebase all positions so they never overflow int32 (BinTree.Normalize,
  // BinTree.java:358-375): subtract `sub` from every live link; dead links
  // (<= sub, i.e. outside the window) clamp to 0, the empty marker.
  void normalize() {
    int32_t sub = pos - cyclic_size - 1;
    if (sub <= 0) return;
    auto reduce = [sub](std::vector<int32_t>& v) {
      for (auto& x : v) x = x <= sub ? 0 : x - sub;
    };
    reduce(hash);
    reduce(son);
    pos -= sub;
    n -= sub;
    win_start -= sub;
    // signed shift: win_start may be negative after a normalize() rebase
    buf = (const uint8_t*)((intptr_t)owned.data() - (intptr_t)win_start);
  }

  inline int32_t available() const { return n - pos; }
  inline uint8_t get_byte(int off) const { return buf[pos + off]; }

  // First mismatch index in [i, limit) between a[] and b[]; limit if equal.
  static inline int first_diff(const uint8_t* a, const uint8_t* b, int i,
                               int limit) {
    while (i + 8 <= limit) {
      uint64_t x, y;
      std::memcpy(&x, a + i, 8);
      std::memcpy(&y, b + i, 8);
      uint64_t diff = x ^ y;
      if (diff) return std::min(i + (int)(__builtin_ctzll(diff) >> 3), limit);
      i += 8;
    }
    while (i < limit && a[i] == b[i]) i++;
    return i;
  }

  inline int match_len(int index, int32_t dist, int limit) const {
    int32_t avail = n - (pos + index);
    if (limit > avail) limit = (int)avail;
    const uint8_t* a = buf + pos + index;
    return first_diff(a, a - dist - 1, 0, limit);
  }

  inline void advance() {
    if (++cyclic_pos >= cyclic_size) cyclic_pos = 0;
    pos++;
    if (stream_mode) {  // predictable not-taken branch on the flat hot path
      if (pos >= kNormalizeLimit) normalize();
      if (!eof && n - pos < keep_after) refill();
    }
  }

  // CAND fast path, inlineable: the general find_matches carries every
  // finder kind and never inlines, and the per-position call overhead
  // alone was ~20% of the hybrid-optimal host time (22M calls on the
  // frozen-corpus profile, tools/prof_driver.cpp `cand` mode).  Copies
  // the precomputed ascending pairs, clamped to len_limit and guarded
  // against out-of-window distances (device bugs must not corrupt
  // streams).
  inline int find_matches_cand(int32_t* out) {
    int len_limit;
    if (pos + match_max_len <= n) {
      len_limit = match_max_len;
    } else {
      len_limit = (int)(n - pos);
      if (len_limit < min_match_check) {
        advance();
        return 0;
      }
    }
    int count_out = 0;
    int prev_len = 1;
    const int64_t end = cand_off[pos + 1];
    for (int64_t i = cand_off[pos]; i < end; i++) {
      int len = cand_len[i];
      int32_t dist = cand_dist[i];
      if (dist < 0 || dist + 1 > pos) continue;
      if (len > len_limit) len = len_limit;
      if (len <= prev_len) continue;
      out[count_out * 2] = len;
      out[count_out * 2 + 1] = dist;
      count_out++;
      prev_len = len;
      if (len == len_limit) break;
    }
    advance();
    return count_out;
  }

  // returns count of (len,dist) pairs in out[2*i], out[2*i+1]
  int find_matches(int32_t* out) {
    if (kind == CAND) return find_matches_cand(out);
    int len_limit;
    if (pos + match_max_len <= n) {
      len_limit = match_max_len;
    } else {
      len_limit = (int)(n - pos);
      if (len_limit < min_match_check) {
        advance();
        return 0;
      }
    }
    int32_t match_min_pos = pos > cyclic_size ? pos - cyclic_size : 0;
    int count_out = 0;
    int max_len = 1;
    uint32_t hash_value;
    int32_t cur_match;

    if (kind == FAST4) {
      uint32_t hv = hash4_fast(pos);
      cur_match = hash[hv];
      hash[hv] = pos;
      son[cyclic_pos] = cur_match;
      if (pos + 5 < n) __builtin_prefetch(&hash[hash4_fast(pos + 1)]);
      max_len = 3;  // chain candidates are 4-byte hashes; reps cover 2..3
      int cnt = cut_value;
      while (cur_match > match_min_pos && cnt-- > 0) {
        int32_t delta = pos - cur_match;
        if (max_len < len_limit &&
            buf[cur_match + max_len] == buf[pos + max_len]) {
          int len = first_diff(buf + pos, buf + cur_match, 0, len_limit);
          if (len > max_len) {
            max_len = len;
            out[count_out * 2] = len;
            out[count_out * 2 + 1] = delta - 1;
            count_out++;
            if (len == len_limit) break;
          }
        }
        int32_t cyc = delta <= cyclic_pos ? cyclic_pos - delta
                                          : cyclic_pos - delta + cyclic_size;
        cur_match = son[cyc];
        if (cur_match > match_min_pos) {
          int32_t d2 = pos - cur_match;
          int32_t c2 = d2 <= cyclic_pos ? cyclic_pos - d2
                                        : cyclic_pos - d2 + cyclic_size;
          __builtin_prefetch(&son[c2]);
          __builtin_prefetch(buf + cur_match + max_len);
        }
      }
      advance();
      return count_out;
    }

    if (kind != BT2) {
      uint32_t temp = T.crc[buf[pos]] ^ buf[pos + 1];
      uint32_t h2 = temp & (kHash2Size - 1);
      temp ^= (uint32_t)buf[pos + 2] << 8;
      uint32_t h3 = temp & (kHash3Size - 1);
      hash_value = (temp ^ (T.crc[buf[pos + 3]] << 5)) & hash_mask;
      cur_match = hash[fix_hash_size + hash_value];
      if (pos + 4 < n) {  // hide the next position's hash-head miss
        uint32_t t2 = T.crc[buf[pos + 1]] ^ buf[pos + 2];
        t2 ^= (uint32_t)buf[pos + 3] << 8;
        __builtin_prefetch(
            &hash[fix_hash_size + ((t2 ^ (T.crc[buf[pos + 4]] << 5)) & hash_mask)]);
      }
      int32_t cm2 = hash[h2];
      int32_t cm3 = hash[kHash3Offset + h3];
      hash[h2] = pos;
      hash[kHash3Offset + h3] = pos;
      if (cm2 > match_min_pos && buf[cm2] == buf[pos]) {
        max_len = 2;
        out[count_out * 2] = 2;
        out[count_out * 2 + 1] = pos - cm2 - 1;
        count_out++;
      }
      if (cm3 > match_min_pos && buf[cm3] == buf[pos]) {
        if (cm3 == cm2) count_out--;
        max_len = 3;
        out[count_out * 2] = 3;
        out[count_out * 2 + 1] = pos - cm3 - 1;
        count_out++;
        cm2 = cm3;
      }
      if (count_out != 0 && cm2 == cur_match) {
        count_out--;
        max_len = 1;
      }
    } else {
      hash_value = (uint32_t)buf[pos] ^ ((uint32_t)buf[pos + 1] << 8);
      cur_match = hash[fix_hash_size + hash_value];
    }
    hash[fix_hash_size + hash_value] = pos;

    if (kind == HC4) {
      son[cyclic_pos] = cur_match;
      int cnt = cut_value;
      while (cur_match > match_min_pos && cnt-- > 0) {
        int32_t delta = pos - cur_match;
        if (max_len < len_limit && buf[cur_match + max_len] == buf[pos + max_len]) {
          int len = first_diff(buf + pos, buf + cur_match, 0, len_limit);
          if (len > max_len) {
            max_len = len;
            out[count_out * 2] = len;
            out[count_out * 2 + 1] = delta - 1;
            count_out++;
            if (len == len_limit) break;
          }
        }
        int32_t cyc = delta <= cyclic_pos ? cyclic_pos - delta
                                          : cyclic_pos - delta + cyclic_size;
        cur_match = son[cyc];
        if (cur_match > match_min_pos) {
          int32_t d2 = pos - cur_match;
          int32_t c2 = d2 <= cyclic_pos ? cyclic_pos - d2
                                        : cyclic_pos - d2 + cyclic_size;
          __builtin_prefetch(&son[c2]);
          __builtin_prefetch(buf + cur_match + max_len);
        }
      }
      advance();
      return count_out;
    }

    int32_t ptr0 = (cyclic_pos << 1) + 1, ptr1 = cyclic_pos << 1;
    int len0 = num_direct_bytes, len1 = num_direct_bytes;
    if (num_direct_bytes != 0 && cur_match > match_min_pos) {
      if (buf[cur_match + num_direct_bytes] != buf[pos + num_direct_bytes]) {
        max_len = num_direct_bytes;
        out[count_out * 2] = num_direct_bytes;
        out[count_out * 2 + 1] = pos - cur_match - 1;
        count_out++;
      }
    }
    int cnt = cut_value;
    for (;;) {
      if (cur_match <= match_min_pos || cnt-- == 0) {
        son[ptr0] = 0;
        son[ptr1] = 0;
        break;
      }
      int32_t delta = pos - cur_match;
      int32_t cyc = (delta <= cyclic_pos ? cyclic_pos - delta
                                         : cyclic_pos - delta + cyclic_size)
                    << 1;
      int len = std::min(len0, len1);
      if (buf[cur_match + len] == buf[pos + len]) {
        len = first_diff(buf + pos, buf + cur_match, len + 1, len_limit);
        if (max_len < len) {
          max_len = len;
          out[count_out * 2] = len;
          out[count_out * 2 + 1] = delta - 1;
          count_out++;
          if (len == len_limit) {
            son[ptr1] = son[cyc];
            son[ptr0] = son[cyc + 1];
            break;
          }
        }
      }
      if (buf[cur_match + len] < buf[pos + len]) {
        son[ptr1] = cur_match;
        ptr1 = cyc + 1;
        cur_match = son[ptr1];
        len1 = len;
      } else {
        son[ptr0] = cur_match;
        ptr0 = cyc;
        cur_match = son[ptr0];
        len0 = len;
      }
      if (cur_match > match_min_pos) {
        // Overlap the next hop's two dependent misses with this iteration.
        int32_t d2 = pos - cur_match;
        int32_t c2 = (d2 <= cyclic_pos ? cyclic_pos - d2
                                       : cyclic_pos - d2 + cyclic_size)
                     << 1;
        __builtin_prefetch(&son[c2]);
        __builtin_prefetch(buf + cur_match + std::min(len0, len1));
      }
    }
    advance();
    return count_out;
  }

  void skip(int num) {
    if (kind == CAND) {
      // pure position advance: CAND has no tree/hash state and never
      // streams, so the cyclic bookkeeping is dead weight here
      pos += num;
      return;
    }
    do {
      int len_limit;
      if (pos + match_max_len <= n) {
        len_limit = match_max_len;
      } else {
        len_limit = (int)(n - pos);
        if (len_limit < min_match_check) {
          advance();
          continue;
        }
      }
      int32_t match_min_pos = pos > cyclic_size ? pos - cyclic_size : 0;
      uint32_t hash_value;
      if (kind == FAST4) {
        uint32_t hv = hash4_fast(pos);
        son[cyclic_pos] = hash[hv];
        hash[hv] = pos;
        if (pos + 5 < n) __builtin_prefetch(&hash[hash4_fast(pos + 1)], 1);
        advance();
        continue;
      }
      if (kind != BT2) {
        uint32_t temp = T.crc[buf[pos]] ^ buf[pos + 1];
        hash[temp & (kHash2Size - 1)] = pos;
        temp ^= (uint32_t)buf[pos + 2] << 8;
        hash[kHash3Offset + (temp & (kHash3Size - 1))] = pos;
        hash_value = (temp ^ (T.crc[buf[pos + 3]] << 5)) & hash_mask;
        if (pos + 4 < n) {
          uint32_t t2 = T.crc[buf[pos + 1]] ^ buf[pos + 2];
          t2 ^= (uint32_t)buf[pos + 3] << 8;
          __builtin_prefetch(
              &hash[fix_hash_size + ((t2 ^ (T.crc[buf[pos + 4]] << 5)) & hash_mask)], 1);
        }
      } else {
        hash_value = (uint32_t)buf[pos] ^ ((uint32_t)buf[pos + 1] << 8);
      }
      int32_t cur_match = hash[fix_hash_size + hash_value];
      hash[fix_hash_size + hash_value] = pos;
      if (kind == HC4) {
        son[cyclic_pos] = cur_match;
        advance();
        continue;
      }
      int32_t ptr0 = (cyclic_pos << 1) + 1, ptr1 = cyclic_pos << 1;
      int len0 = num_direct_bytes, len1 = num_direct_bytes;
      int cnt = cut_value;
      for (;;) {
        if (cur_match <= match_min_pos || cnt-- == 0) {
          son[ptr0] = 0;
          son[ptr1] = 0;
          break;
        }
        int32_t delta = pos - cur_match;
        int32_t cyc = (delta <= cyclic_pos ? cyclic_pos - delta
                                           : cyclic_pos - delta + cyclic_size)
                      << 1;
        int len = std::min(len0, len1);
        if (buf[cur_match + len] == buf[pos + len]) {
          len = first_diff(buf + pos, buf + cur_match, len + 1, len_limit);
          if (len == len_limit) {
            son[ptr1] = son[cyc];
            son[ptr0] = son[cyc + 1];
            break;
          }
        }
        if (buf[cur_match + len] < buf[pos + len]) {
          son[ptr1] = cur_match;
          ptr1 = cyc + 1;
          cur_match = son[ptr1];
          len1 = len;
        } else {
          son[ptr0] = cur_match;
          ptr0 = cyc;
          cur_match = son[ptr0];
          len0 = len;
        }
        if (cur_match > match_min_pos) {
          int32_t d2 = pos - cur_match;
          int32_t c2 = (d2 <= cyclic_pos ? cyclic_pos - d2
                                         : cyclic_pos - d2 + cyclic_size)
                       << 1;
          __builtin_prefetch(&son[c2]);
          __builtin_prefetch(buf + cur_match + std::min(len0, len1));
        }
      }
      advance();
    } while (--num != 0);
  }
};

// ------------------------------------------------------------- encoder
// Node price lives OUTSIDE this struct (Encoder::opt_price): the DP's
// hot loops scan/relax prices across hundreds of future nodes per
// position, and a dense 4-byte price array keeps that traffic at one
// cache line per 16 nodes instead of one 44-byte struct stride each —
// the cold path fields below are only touched on an actual improvement.
struct Optimal {
  int state;
  bool prev1_is_char, prev2;
  int pos_prev2, back_prev2;
  int pos_prev, back_prev;
  int32_t backs0, backs1, backs2, backs3;
  void make_char() { back_prev = -1; prev1_is_char = false; }
  void make_short_rep() { back_prev = 0; prev1_is_char = false; }
  bool is_short_rep() const { return back_prev == 0; }
};

struct EncParams {
  int lc = 3, lp = 0, pb = 2;
  uint32_t dict_size = 1u << 22;
  int fb = 32;
  int mf = 1;        // 0=bt2 1=bt4 2=hc4 3=fast4
  int eos = 0;
  int optimal = 1;   // hash-chain finders force lazy
};

class Encoder {
 public:
  Layout L;
  EncParams P;
  std::vector<uint16_t> probs;
  RangeEnc rc;
  MatchFinder* mf = nullptr;
  int state = 0;
  uint8_t prev_byte = 0;
  int32_t rep_dist[kNumRepDistances] = {0, 0, 0, 0};
  uint32_t now_pos = 0;
  int additional_offset = 0;
  int optimum_end = 0, optimum_cur = 0;
  bool longest_found = false;
  int longest_len = 0;
  int32_t longest_dist = 0;
  int32_t md[2 * (kMatchMaxLen + 1)];
  int num_pairs = 0;
  int match_price_count = 0, align_price_count = 0;
  int pos_state_mask;
  std::vector<Optimal> opt;
  std::vector<uint32_t> opt_price;
  // Scratch for the vectorized relax passes: relax_range() records which
  // lengths improved; the caller then walks only the (sparse) marks to
  // write the cold path fields.  Indexed by LENGTH (<= kMatchMaxLen).
  uint8_t relax_marks[kMatchMaxLen + 16];
  uint32_t pos_slot_prices[kNumLenToPosStates << kNumPosSlotBits];
  uint32_t dist_prices[kNumLenToPosStates * kNumFullDistances];
  uint32_t align_prices[kAlignTableSize];
  uint32_t len_prices[kNumLenSymbols << 4], rep_len_prices[kNumLenSymbols << 4];
  int len_counters[16], rep_len_counters[16];
  int len_table_size;
  int dist_table_size;

  explicit Encoder(const EncParams& p)
      : L(p.lc, p.lp, p.pb), P(p), opt(kNumOpts), opt_price(kNumOpts) {
    pos_state_mask = L.pos_state_mask();
    len_table_size = P.fb + 1 - kMatchMinLen;
    int log = 0;
    while (P.dict_size > (1u << log)) log++;
    dist_table_size = log * 2;
    if (P.mf >= 2 && P.optimal == 1) P.optimal = 2;  // hash-chain finders: lazy
  }
  ~Encoder() { delete mf; }

  uint32_t tree_price(int base, int nbits, int symbol) {
    uint32_t price = 0;
    int m = 1;
    for (int i = nbits - 1; i >= 0; i--) {
      int bit = (symbol >> i) & 1;
      price += price_of(probs[base + m], bit);
      m = (m << 1) + bit;
    }
    return price;
  }
  uint32_t rev_tree_price(int base, int nbits, int symbol) {
    uint32_t price = 0;
    int m = 1;
    for (int i = 0; i < nbits; i++) {
      int bit = symbol & 1;
      symbol >>= 1;
      price += price_of(probs[base + m], bit);
      m = (m << 1) | bit;
    }
    return price;
  }

  void update_len_table(bool is_rep, int ps) {
    int base = is_rep ? L.rep_len_coder : L.len_coder;
    uint32_t* prices = is_rep ? rep_len_prices : len_prices;
    int* counters = is_rep ? rep_len_counters : len_counters;
    int n = len_table_size;
    int st = ps * kNumLenSymbols;
    uint32_t a0 = price0(probs[base + kLenChoice]);
    uint32_t a1 = price1(probs[base + kLenChoice]);
    uint32_t b0 = a1 + price0(probs[base + kLenChoice2]);
    uint32_t b1 = a1 + price1(probs[base + kLenChoice2]);
    int i = 0;
    for (; i < 8; i++) {
      if (i >= n) { counters[ps] = n; return; }
      prices[st + i] = a0 + tree_price(base + kLenLow + (ps << 3), 3, i);
    }
    for (; i < 16; i++) {
      if (i >= n) { counters[ps] = n; return; }
      prices[st + i] = b0 + tree_price(base + kLenMid + (ps << 3), 3, i - 8);
    }
    for (; i < n; i++)
      prices[st + i] = b1 + tree_price(base + kLenHigh, 8, i - 16);
    counters[ps] = n;
  }

  void encode_len(bool is_rep, int symbol, int ps) {
    int base = is_rep ? L.rep_len_coder : L.len_coder;
    if (symbol < 8) {
      rc.encode_bit(probs.data(), base + kLenChoice, 0);
      rc.encode_tree(probs.data(), base + kLenLow + (ps << 3), 3, symbol);
    } else {
      rc.encode_bit(probs.data(), base + kLenChoice, 1);
      if (symbol < 16) {
        rc.encode_bit(probs.data(), base + kLenChoice2, 0);
        rc.encode_tree(probs.data(), base + kLenMid + (ps << 3), 3, symbol - 8);
      } else {
        rc.encode_bit(probs.data(), base + kLenChoice2, 1);
        rc.encode_tree(probs.data(), base + kLenHigh, 8, symbol - 16);
      }
    }
    int* counters = is_rep ? rep_len_counters : len_counters;
    if (--counters[ps] == 0) update_len_table(is_rep, ps);
  }
  inline uint32_t len_price(bool is_rep, int symbol, int ps) const {
    return (is_rep ? rep_len_prices : len_prices)[ps * kNumLenSymbols + symbol];
  }

  uint32_t literal_price(int sub, bool match_mode, uint8_t match_byte,
                         uint8_t symbol) {
    uint32_t price = 0;
    uint32_t context = 1;
    int i = 7;
    if (match_mode) {
      for (; i >= 0; i--) {
        int match_bit = (match_byte >> i) & 1;
        int bit = (symbol >> i) & 1;
        price += price_of(probs[sub + ((1 + match_bit) << 8) + context], bit);
        context = (context << 1) | bit;
        if (match_bit != bit) { i--; break; }
      }
    }
    for (; i >= 0; i--) {
      int bit = (symbol >> i) & 1;
      price += price_of(probs[sub + context], bit);
      context = (context << 1) | bit;
    }
    return price;
  }

  void encode_literal(int sub, uint8_t symbol) {
    uint32_t context = 1;
    for (int i = 7; i >= 0; i--) {
      int bit = (symbol >> i) & 1;
      rc.encode_bit(probs.data(), sub + context, bit);
      context = (context << 1) | bit;
    }
  }
  void encode_literal_matched(int sub, uint8_t match_byte, uint8_t symbol) {
    uint32_t context = 1;
    bool same = true;
    for (int i = 7; i >= 0; i--) {
      int bit = (symbol >> i) & 1;
      uint32_t st = context;
      if (same) {
        int match_bit = (match_byte >> i) & 1;
        st += (1 + match_bit) << 8;
        same = match_bit == bit;
      }
      rc.encode_bit(probs.data(), sub + st, bit);
      context = (context << 1) | bit;
    }
  }

  void fill_dist_prices() {
    uint32_t temp[kNumFullDistances];
    for (int i = kStartPosModelIndex; i < kNumFullDistances; i++) {
      int slot = get_pos_slot((uint32_t)i);
      int footer = (slot >> 1) - 1;
      int base_val = (2 | (slot & 1)) << footer;
      temp[i] = rev_tree_price(L.spec_pos + base_val - slot - 1, footer, i - base_val);
    }
    for (int lps = 0; lps < kNumLenToPosStates; lps++) {
      int tree = L.pos_slot + lps * 64;
      int st = lps << kNumPosSlotBits;
      for (int slot = 0; slot < dist_table_size; slot++)
        pos_slot_prices[st + slot] = tree_price(tree, 6, slot);
      for (int slot = kEndPosModelIndex; slot < dist_table_size; slot++)
        pos_slot_prices[st + slot] += (uint32_t)(((slot >> 1) - 1 - kNumAlignBits) << 6);
      int st2 = lps * kNumFullDistances;
      int i = 0;
      for (; i < kStartPosModelIndex; i++) dist_prices[st2 + i] = pos_slot_prices[st + i];
      for (; i < kNumFullDistances; i++)
        dist_prices[st2 + i] = pos_slot_prices[st + get_pos_slot((uint32_t)i)] + temp[i];
    }
    match_price_count = 0;
  }
  void fill_align_prices() {
    for (int i = 0; i < kAlignTableSize; i++)
      align_prices[i] = rev_tree_price(L.align_, kNumAlignBits, i);
    align_price_count = 0;
  }

  // Minimum sweep length for the vectorized relax: below this the
  // two-pass (select-sweep + mark-walk) form costs more than the
  // predictable scalar loop (measured on the CAND profile driver at
  // fb=32, where typical sweeps are 4-8 lengths: all-vector was ~8%
  // SLOWER end-to-end).  Long sweeps — fb>=128 parses, long rep runs —
  // are where the 16-lane AVX sweep pays.
  static constexpr int kRelaxVecMin = 24;

  // Branch-free relax of opt_price[cur + l] for l in [lo, hi] against
  // base + tab[l - 2], marking improvements.  With no early exit and a
  // select instead of a store-branch the compiler vectorizes the sweep
  // (8-16 lengths per instruction); the cold Optimal fields are written
  // afterwards only where a mark landed.  Exact: each length touches a
  // distinct node and the predicate (strict <) is unchanged, so the
  // result is bit-identical to the scalar loop.
  inline void relax_range(int cur, int lo, int hi, uint32_t base,
                          const uint32_t* tab) {
    uint32_t* op = &opt_price[cur];
    uint8_t* mk = relax_marks;
    for (int l = lo; l <= hi; l++) {
      uint32_t calp = base + tab[l - 2];
      uint32_t prev = op[l];
      bool imp = calp < prev;
      op[l] = imp ? calp : prev;
      mk[l] = (uint8_t)imp;
    }
  }
  // Walk the improved lengths from a relax_range pass, skipping runs of
  // 8 unimproved lengths with one word test (improvements are sparse
  // once the DP warms up).
  template <class F>
  inline void for_marked(int lo, int hi, F&& f) {
    int l = lo;
    while (l <= hi) {
      if (l + 8 <= hi + 1) {
        uint64_t w;
        std::memcpy(&w, relax_marks + l, 8);
        if (w == 0) {
          l += 8;
          continue;
        }
      }
      if (relax_marks[l]) f(l);
      ++l;
    }
  }

  // Relax lengths [lo, hi]: vector two-pass for long sweeps, the plain
  // scalar compare-store loop below kRelaxVecMin.  `improve(l)` writes
  // the cold path fields for an improved length.
  template <class F>
  inline void relax_sweep(int cur, int lo, int hi, uint32_t base,
                          const uint32_t* tab, F&& improve) {
    if (hi - lo >= kRelaxVecMin) {
      relax_range(cur, lo, hi, base, tab);
      for_marked(lo, hi, improve);
      return;
    }
    uint32_t* op = &opt_price[cur];
    for (int l = lo; l <= hi; l++) {
      uint32_t calp = base + tab[l - 2];
      if (calp < op[l]) {
        op[l] = calp;
        improve(l);
      }
    }
  }

  inline uint32_t rep_len1_price(int st, int ps) {
    return price0(probs[L.is_rep_g0 + st]) +
           price0(probs[L.is_rep0_long + (st << kNumPosStatesBitsMax) + ps]);
  }
  uint32_t pure_rep_price(int rep_index, int st, int ps) {
    uint32_t price;
    if (rep_index == 0) {
      price = price0(probs[L.is_rep_g0 + st]);
      price += price1(probs[L.is_rep0_long + (st << kNumPosStatesBitsMax) + ps]);
    } else {
      price = price1(probs[L.is_rep_g0 + st]);
      if (rep_index == 1) {
        price += price0(probs[L.is_rep_g1 + st]);
      } else {
        price += price1(probs[L.is_rep_g1 + st]);
        price += price_of(probs[L.is_rep_g2 + st], rep_index - 2);
      }
    }
    return price;
  }
  inline uint32_t rep_price(int rep_index, int len, int st, int ps) {
    return len_price(true, len - kMatchMinLen, ps) + pure_rep_price(rep_index, st, ps);
  }
  inline uint32_t pos_len_price(uint32_t dist, int len, int ps) {
    uint32_t price;
    int lps = len_to_pos_state(len);
    if (dist < kNumFullDistances)
      price = dist_prices[lps * kNumFullDistances + dist];
    else
      price = pos_slot_prices[(lps << kNumPosSlotBits) + get_pos_slot2(dist)] +
              align_prices[dist & kAlignMask];
    return price + len_price(false, len - kMatchMinLen, ps);
  }

  int read_match_distances() {
    // call-site dispatch so the tiny CAND list copy inlines here (the
    // general find_matches never inlines; see find_matches_cand)
    num_pairs = mf->kind == MatchFinder::CAND ? mf->find_matches_cand(md)
                                              : mf->find_matches(md);
    int length = 0;
    if (num_pairs > 0) {
      length = md[(num_pairs - 1) * 2];
      if (length == P.fb)
        length += mf->match_len(length - 1, md[(num_pairs - 1) * 2 + 1],
                                kMatchMaxLen - length);
    }
    additional_offset++;
    return length;
  }
  void move_pos(int num) {
    if (num > 0) {
      mf->skip(num);
      additional_offset += num;
    }
  }

  // (pos, len) decision; pos==-1 literal, pos<4 rep index, else dist+4
  std::pair<int, int> backward(int cur) {
    optimum_end = cur;
    int pos_mem = opt[cur].pos_prev;
    int back_mem = opt[cur].back_prev;
    do {
      if (opt[cur].prev1_is_char) {
        opt[pos_mem].make_char();
        opt[pos_mem].pos_prev = pos_mem - 1;
        if (opt[cur].prev2) {
          opt[pos_mem - 1].prev1_is_char = false;
          opt[pos_mem - 1].pos_prev = opt[cur].pos_prev2;
          opt[pos_mem - 1].back_prev = opt[cur].back_prev2;
        }
      }
      int pos_prev = pos_mem;
      int back_cur = back_mem;
      back_mem = opt[pos_prev].back_prev;
      pos_mem = opt[pos_prev].pos_prev;
      opt[pos_prev].back_prev = back_cur;
      opt[pos_prev].pos_prev = cur;
      cur = pos_prev;
    } while (cur > 0);
    optimum_cur = opt[0].pos_prev;
    return {opt[0].back_prev, optimum_cur};
  }

  std::pair<int, int> get_optimum(uint32_t position) {
    if (optimum_end != optimum_cur) {
      int len_res = opt[optimum_cur].pos_prev - optimum_cur;
      int len_pos = opt[optimum_cur].back_prev;
      optimum_cur = opt[optimum_cur].pos_prev;
      return {len_pos, len_res};
    }
    optimum_cur = optimum_end = 0;
    int len_main;
    if (longest_found) {
      len_main = longest_len;
      longest_found = false;
    } else {
      len_main = read_match_distances();
    }
    int pairs = num_pairs;
    int num_avail = (int)mf->available() + 1;
    if (num_avail < 2) return {-1, 1};
    if (num_avail > kMatchMaxLen) num_avail = kMatchMaxLen;

    int32_t reps[kNumRepDistances];
    int rep_lens[kNumRepDistances];
    int rep_max_index = 0;
    for (int i = 0; i < kNumRepDistances; i++) {
      reps[i] = rep_dist[i];
      rep_lens[i] = mf->match_len(-1, reps[i], kMatchMaxLen);
      if (rep_lens[i] > rep_lens[rep_max_index]) rep_max_index = i;
    }
    if (rep_lens[rep_max_index] >= P.fb) {
      int len_res = rep_lens[rep_max_index];
      move_pos(len_res - 1);
      return {rep_max_index, len_res};
    }
    if (len_main >= P.fb) {
      int pos = md[(pairs - 1) * 2 + 1] + kNumRepDistances;
      move_pos(len_main - 1);
      return {pos, len_main};
    }
    uint8_t current_byte = mf->get_byte(-1);
    uint8_t match_byte = mf->get_byte(-rep_dist[0] - 2);
    if (len_main < 2 && current_byte != match_byte && rep_lens[rep_max_index] < 2)
      return {-1, 1};

    opt[0].state = state;
    int ps = (int)(position & pos_state_mask);
    int im = L.is_match + (state << kNumPosStatesBitsMax) + ps;
    opt_price[1] = price0(probs[im]) +
                   literal_price(L.lit_sub(position, prev_byte), state >= 7,
                                 match_byte, current_byte);
    opt[1].make_char();
    uint32_t match_price = price1(probs[im]);
    uint32_t rep_match_price = match_price + price1(probs[L.is_rep + state]);
    if (match_byte == current_byte) {
      uint32_t srp = rep_match_price + rep_len1_price(state, ps);
      if (srp < opt_price[1]) {
        opt_price[1] = srp;
        opt[1].make_short_rep();
      }
    }
    int len_end = len_main >= rep_lens[rep_max_index] ? len_main : rep_lens[rep_max_index];
    if (len_end < 2) return {opt[1].back_prev, 1};
    opt[1].pos_prev = 0;
    opt[0].backs0 = reps[0];
    opt[0].backs1 = reps[1];
    opt[0].backs2 = reps[2];
    opt[0].backs3 = reps[3];
    for (int len = len_end; len >= 2; len--) opt_price[len] = kInfinityPrice;

    {
      const uint32_t* rlp = &rep_len_prices[ps * kNumLenSymbols];
      for (int i = 0; i < kNumRepDistances; i++) {
        int rep_len = rep_lens[i];
        if (rep_len < 2) continue;
        uint32_t price = rep_match_price + pure_rep_price(i, state, ps);
        relax_sweep(0, 2, rep_len, price, rlp, [&](int l) {
          Optimal& o = opt[l];
          o.pos_prev = 0;
          o.back_prev = i;
          o.prev1_is_char = false;
        });
      }
    }

    uint32_t normal_match_price = match_price + price0(probs[L.is_rep + state]);
    int len = rep_lens[0] >= 2 ? rep_lens[0] + 1 : 2;
    if (len <= len_main) {
      const uint32_t* lp = &len_prices[ps * kNumLenSymbols];
      int offs = 0;
      while (len > md[offs * 2]) offs++;
      // per-pair segments, vectorized like the cur-loop match relax
      for (int seg_lo = len;;) {
        int32_t distance = md[offs * 2 + 1];
        int seg_hi = md[offs * 2];
        int l = seg_lo;
        for (; l <= seg_hi && l < 5; l++) {
          int lps = len_to_pos_state(l);
          uint32_t dp_s =
              (uint32_t)distance < kNumFullDistances
                  ? dist_prices[lps * kNumFullDistances + distance]
                  : pos_slot_prices[(lps << kNumPosSlotBits) +
                                    get_pos_slot2(distance)] +
                        align_prices[distance & kAlignMask];
          uint32_t calp = normal_match_price + dp_s + lp[l - 2];
          if (calp < opt_price[l]) {
            opt_price[l] = calp;
            Optimal& o = opt[l];
            o.pos_prev = 0;
            o.back_prev = distance + kNumRepDistances;
            o.prev1_is_char = false;
          }
        }
        if (l <= seg_hi) {
          uint32_t base =
              normal_match_price +
              ((uint32_t)distance < kNumFullDistances
                   ? dist_prices[3 * kNumFullDistances + distance]
                   : pos_slot_prices[(3 << kNumPosSlotBits) +
                                     get_pos_slot2(distance)] +
                         align_prices[distance & kAlignMask]);
          relax_sweep(0, l, seg_hi, base, lp, [&](int li) {
            Optimal& o = opt[li];
            o.pos_prev = 0;
            o.back_prev = distance + kNumRepDistances;
            o.prev1_is_char = false;
          });
        }
        offs++;
        if (offs == pairs) break;
        seg_lo = seg_hi + 1;
      }
    }

    int cur = 0;
    for (;;) {
      cur++;
      if (cur == len_end) return backward(cur);
      int new_len = read_match_distances();
      pairs = num_pairs;
      if (new_len >= P.fb) {
        longest_len = new_len;
        longest_found = true;
        return backward(cur);
      }
      position++;
      int pos_prev = opt[cur].pos_prev;
      int st;
      if (opt[cur].prev1_is_char) {
        pos_prev--;
        if (opt[cur].prev2) {
          st = opt[opt[cur].pos_prev2].state;
          st = opt[cur].back_prev2 < kNumRepDistances ? next_lrep(st) : next_match(st);
        } else {
          st = opt[pos_prev].state;
        }
        st = next_lit(st);
      } else {
        st = opt[pos_prev].state;
      }
      if (pos_prev == cur - 1) {
        st = opt[cur].is_short_rep() ? next_srep(st) : next_lit(st);
      } else {
        int pos;
        if (opt[cur].prev1_is_char && opt[cur].prev2) {
          pos_prev = opt[cur].pos_prev2;
          pos = opt[cur].back_prev2;
          st = next_lrep(st);
        } else {
          pos = opt[cur].back_prev;
          st = pos < kNumRepDistances ? next_lrep(st) : next_match(st);
        }
        const Optimal& op = opt[pos_prev];
        if (pos < kNumRepDistances) {
          if (pos == 0) {
            reps[0] = op.backs0; reps[1] = op.backs1; reps[2] = op.backs2; reps[3] = op.backs3;
          } else if (pos == 1) {
            reps[0] = op.backs1; reps[1] = op.backs0; reps[2] = op.backs2; reps[3] = op.backs3;
          } else if (pos == 2) {
            reps[0] = op.backs2; reps[1] = op.backs0; reps[2] = op.backs1; reps[3] = op.backs3;
          } else {
            reps[0] = op.backs3; reps[1] = op.backs0; reps[2] = op.backs1; reps[3] = op.backs2;
          }
        } else {
          reps[0] = pos - kNumRepDistances;
          reps[1] = op.backs0; reps[2] = op.backs1; reps[3] = op.backs2;
        }
      }
      opt[cur].state = st;
      opt[cur].backs0 = reps[0];
      opt[cur].backs1 = reps[1];
      opt[cur].backs2 = reps[2];
      opt[cur].backs3 = reps[3];
      uint32_t cur_price = opt_price[cur];

      current_byte = mf->get_byte(-1);
      match_byte = mf->get_byte(-reps[0] - 2);
      ps = (int)(position & pos_state_mask);
      im = L.is_match + (st << kNumPosStatesBitsMax) + ps;
      uint32_t cur_and_1 =
          cur_price + price0(probs[im]) +
          literal_price(L.lit_sub(position, mf->get_byte(-2)), st >= 7,
                        match_byte, current_byte);
      Optimal& next_opt = opt[cur + 1];
      bool next_is_char = false;
      if (cur_and_1 < opt_price[cur + 1]) {
        opt_price[cur + 1] = cur_and_1;
        next_opt.pos_prev = cur;
        next_opt.make_char();
        next_is_char = true;
      }
      match_price = cur_price + price1(probs[im]);
      rep_match_price = match_price + price1(probs[L.is_rep + st]);
      if (match_byte == current_byte &&
          !(next_opt.pos_prev < cur && next_opt.back_prev == 0)) {
        uint32_t srp = rep_match_price + rep_len1_price(st, ps);
        if (srp <= opt_price[cur + 1]) {
          opt_price[cur + 1] = srp;
          next_opt.pos_prev = cur;
          next_opt.make_short_rep();
          next_is_char = true;
        }
      }
      int num_avail_full = (int)mf->available() + 1;
      if (num_avail_full > kNumOpts - 1 - cur) num_avail_full = kNumOpts - 1 - cur;
      num_avail = num_avail_full;
      if (num_avail < 2) continue;
      if (num_avail > P.fb) num_avail = P.fb;

      if (!next_is_char && match_byte != current_byte) {
        int t = std::min(num_avail_full - 1, P.fb);
        int len_test2 = mf->match_len(0, reps[0], t);
        if (len_test2 >= 2) {
          int st2 = next_lit(st);
          int ps_next = (int)((position + 1) & pos_state_mask);
          uint32_t nrmp =
              cur_and_1 +
              price1(probs[L.is_match + (st2 << kNumPosStatesBitsMax) + ps_next]) +
              price1(probs[L.is_rep + st2]);
          int offset = cur + 1 + len_test2;
          while (len_end < offset) opt_price[++len_end] = kInfinityPrice;
          uint32_t calp = nrmp + rep_price(0, len_test2, st2, ps_next);
          if (calp < opt_price[offset]) {
            opt_price[offset] = calp;
            Optimal& o = opt[offset];
            o.pos_prev = cur + 1;
            o.back_prev = 0;
            o.prev1_is_char = true;
            o.prev2 = false;
          }
        }
      }

      int start_len = 2;
      const uint32_t* rlp = &rep_len_prices[ps * kNumLenSymbols];
      for (int rep_index = 0; rep_index < kNumRepDistances; rep_index++) {
        int len_test = mf->match_len(-1, reps[rep_index], num_avail);
        if (len_test < 2) continue;
        int len_test_temp = len_test;
        // hoist the length-invariant part (Encoder.java:565 does the same)
        uint32_t rep_base_price = rep_match_price + pure_rep_price(rep_index, st, ps);
        while (len_end < cur + len_test) opt_price[++len_end] = kInfinityPrice;
        relax_sweep(cur, 2, len_test, rep_base_price, rlp, [&](int l) {
          Optimal& o = opt[cur + l];
          o.pos_prev = cur;
          o.back_prev = rep_index;
          o.prev1_is_char = false;
        });
        len_test = len_test_temp;
        if (rep_index == 0) start_len = len_test + 1;

        if (len_test < num_avail_full) {
          int t = std::min(num_avail_full - 1 - len_test, P.fb);
          int len_test2 = mf->match_len(len_test, reps[rep_index], t);
          if (len_test2 >= 2) {
            int st2 = next_lrep(st);
            int ps_next = (int)((position + len_test) & pos_state_mask);
            uint32_t calcp =
                rep_match_price + rep_price(rep_index, len_test, st, ps) +
                price0(probs[L.is_match + (st2 << kNumPosStatesBitsMax) + ps_next]) +
                literal_price(
                    L.lit_sub(position + len_test, mf->get_byte(len_test - 2)), true,
                    mf->get_byte(len_test - 1 - (reps[rep_index] + 1)),
                    mf->get_byte(len_test - 1));
            st2 = next_lit(st2);
            int ps_next2 = (int)((position + len_test + 1) & pos_state_mask);
            uint32_t nmp = calcp + price1(probs[L.is_match + (st2 << kNumPosStatesBitsMax) + ps_next2]);
            uint32_t nrmp = nmp + price1(probs[L.is_rep + st2]);
            int offset = len_test + 1 + len_test2;
            while (len_end < cur + offset) opt_price[++len_end] = kInfinityPrice;
            uint32_t calp = nrmp + rep_price(0, len_test2, st2, ps_next2);
            if (calp < opt_price[cur + offset]) {
              opt_price[cur + offset] = calp;
              Optimal& o = opt[cur + offset];
              o.pos_prev = cur + len_test + 1;
              o.back_prev = 0;
              o.prev1_is_char = true;
              o.prev2 = true;
              o.pos_prev2 = cur;
              o.back_prev2 = rep_index;
            }
          }
        }
      }

      if (new_len > num_avail) {
        new_len = num_avail;
        pairs = 0;
        while (new_len > md[pairs * 2]) pairs++;
        md[pairs * 2] = new_len;
        pairs++;
      }
      if (new_len >= start_len) {
        normal_match_price = match_price + price0(probs[L.is_rep + st]);
        while (len_end < cur + new_len) opt_price[++len_end] = kInfinityPrice;
        const uint32_t* lp = &len_prices[ps * kNumLenSymbols];
        int offs = 0;
        while (start_len > md[offs * 2]) offs++;
        // Per-pair segments: lengths (prev bound, md[offs*2]] all use the
        // pair's distance, and the distance price is length-invariant
        // once len_to_pos_state saturates (len >= 5) — so the bulk of
        // each segment is one vectorized relax sweep; only lens 2..4 and
        // the segment-boundary two-step lookahead stay scalar.  (Inside
        // the DP the md list always ends exactly at new_len: the fb
        // extension in read_match_distances only fires at len == fb,
        // which exits the DP before reaching here.)
        for (int seg_lo = start_len;;) {
          int32_t cur_back = md[offs * 2 + 1];
          int seg_hi = md[offs * 2];
          int l = seg_lo;
          for (; l <= seg_hi && l < 5; l++) {
            int lps = len_to_pos_state(l);
            uint32_t dp_s =
                (uint32_t)cur_back < kNumFullDistances
                    ? dist_prices[lps * kNumFullDistances + cur_back]
                    : pos_slot_prices[(lps << kNumPosSlotBits) +
                                      get_pos_slot2(cur_back)] +
                          align_prices[cur_back & kAlignMask];
            uint32_t calp = normal_match_price + dp_s + lp[l - 2];
            if (calp < opt_price[cur + l]) {
              opt_price[cur + l] = calp;
              Optimal& o = opt[cur + l];
              o.pos_prev = cur;
              o.back_prev = cur_back + kNumRepDistances;
              o.prev1_is_char = false;
            }
          }
          uint32_t seg_base = 0;
          if (l <= seg_hi || seg_hi >= 5) {
            seg_base =
                normal_match_price +
                ((uint32_t)cur_back < kNumFullDistances
                     ? dist_prices[3 * kNumFullDistances + cur_back]
                     : pos_slot_prices[(3 << kNumPosSlotBits) +
                                       get_pos_slot2(cur_back)] +
                           align_prices[cur_back & kAlignMask]);
          }
          if (l <= seg_hi) {
            relax_sweep(cur, l, seg_hi, seg_base, lp, [&](int li) {
              Optimal& o = opt[cur + li];
              o.pos_prev = cur;
              o.back_prev = cur_back + kNumRepDistances;
              o.prev1_is_char = false;
            });
          }
          {
            int len_test = seg_hi;
            // price of the pair's full length — base for the lookahead
            // (recomputed; identical to the relaxed value)
            uint32_t calp;
            if (len_test >= 5) {
              calp = seg_base + lp[len_test - 2];
            } else {
              int lps = len_to_pos_state(len_test);
              calp = normal_match_price + lp[len_test - 2] +
                     ((uint32_t)cur_back < kNumFullDistances
                          ? dist_prices[lps * kNumFullDistances + cur_back]
                          : pos_slot_prices[(lps << kNumPosSlotBits) +
                                            get_pos_slot2(cur_back)] +
                                align_prices[cur_back & kAlignMask]);
            }
            if (len_test < num_avail_full) {
              int t = std::min(num_avail_full - 1 - len_test, P.fb);
              int len_test2 = mf->match_len(len_test, cur_back, t);
              if (len_test2 >= 2) {
                int st2 = next_match(st);
                int ps_next = (int)((position + len_test) & pos_state_mask);
                uint32_t calcp =
                    calp +
                    price0(probs[L.is_match + (st2 << kNumPosStatesBitsMax) + ps_next]) +
                    literal_price(
                        L.lit_sub(position + len_test, mf->get_byte(len_test - 2)),
                        true, mf->get_byte(len_test - (cur_back + 1) - 1),
                        mf->get_byte(len_test - 1));
                st2 = next_lit(st2);
                int ps_next2 = (int)((position + len_test + 1) & pos_state_mask);
                uint32_t nmp = calcp + price1(probs[L.is_match + (st2 << kNumPosStatesBitsMax) + ps_next2]);
                uint32_t nrmp = nmp + price1(probs[L.is_rep + st2]);
                int offset = len_test + 1 + len_test2;
                while (len_end < cur + offset) opt_price[++len_end] = kInfinityPrice;
                uint32_t calp2 = nrmp + rep_price(0, len_test2, st2, ps_next2);
                if (calp2 < opt_price[cur + offset]) {
                  opt_price[cur + offset] = calp2;
                  Optimal& o = opt[cur + offset];
                  o.pos_prev = cur + len_test + 1;
                  o.back_prev = 0;
                  o.prev1_is_char = true;
                  o.prev2 = true;
                  o.pos_prev2 = cur;
                  o.back_prev2 = cur_back + kNumRepDistances;
                }
              }
            }
          }
          offs++;
          if (offs == pairs) break;
          seg_lo = seg_hi + 1;
        }
      }
    }
  }

  // one-position-lookahead parse (mirrors LzmaEncoder._get_lazy)
  std::pair<int, int> get_lazy(uint32_t position) {
    (void)position;
    int len_main;
    int32_t main_dist;
    if (longest_found) {
      len_main = longest_len;
      main_dist = longest_dist;
      longest_found = false;
    } else {
      len_main = read_match_distances();
      main_dist = num_pairs > 0 ? md[(num_pairs - 1) * 2 + 1] : 0;
    }
    int num_avail = (int)mf->available() + 1;
    if (num_avail < 2) return {-1, 1};

    int best_rep_len = 0, best_rep_idx = 0;
    for (int i = 0; i < kNumRepDistances; i++) {
      int l = mf->match_len(-1, rep_dist[i], kMatchMaxLen);
      if (l > best_rep_len) {
        best_rep_len = l;
        best_rep_idx = i;
      }
    }
    int cand_len, cand_pos;
    int32_t cand_dist;
    if (best_rep_len >= 2 && best_rep_len + 1 >= len_main) {
      cand_len = best_rep_len;
      cand_pos = best_rep_idx;
      cand_dist = -1;
    } else if (len_main >= 2) {
      cand_len = len_main;
      cand_pos = main_dist + kNumRepDistances;
      cand_dist = main_dist;
    } else {
      uint8_t cur = mf->get_byte(-1);
      uint8_t mb = mf->get_byte(-rep_dist[0] - 2);
      return cur == mb ? std::pair<int, int>{0, 1} : std::pair<int, int>{-1, 1};
    }
    if (cand_len >= P.fb || num_avail <= 2) {
      move_pos(cand_len - 1);
      return {cand_pos, cand_len};
    }
    int next_len = read_match_distances();
    int32_t next_dist = num_pairs > 0 ? md[(num_pairs - 1) * 2 + 1] : 0;
    if (next_len > cand_len ||
        (next_len == cand_len && cand_dist >= 0 &&
         (int64_t)next_dist * 64 < cand_dist)) {
      longest_found = true;
      longest_len = next_len;
      longest_dist = next_dist;
      uint8_t cur = mf->get_byte(-2);
      uint8_t mb = mf->get_byte(-rep_dist[0] - 3);
      return cur == mb ? std::pair<int, int>{0, 1} : std::pair<int, int>{-1, 1};
    }
    move_pos(cand_len - 2);
    return {cand_pos, cand_len};
  }

  std::pair<int, int> get_greedy(uint32_t position) {
    (void)position;
    int len_main;
    if (longest_found) {
      len_main = longest_len;
      longest_found = false;
    } else {
      len_main = read_match_distances();
    }
    int num_avail = (int)mf->available() + 1;
    if (num_avail < 2) return {-1, 1};

    int best_rep_len = 0, best_rep_idx = 0;
    for (int i = 0; i < kNumRepDistances; i++) {
      int l = mf->match_len(-1, rep_dist[i], kMatchMaxLen);
      if (l > best_rep_len) {
        best_rep_len = l;
        best_rep_idx = i;
      }
    }
    if (best_rep_len >= 2 && best_rep_len + 1 >= len_main) {
      move_pos(best_rep_len - 1);
      return {best_rep_idx, best_rep_len};
    }
    if (len_main >= 2) {
      int32_t dist = md[(num_pairs - 1) * 2 + 1];
      move_pos(len_main - 1);
      return {dist + kNumRepDistances, len_main};
    }
    uint8_t cur_byte = mf->get_byte(-1);
    uint8_t match_byte = mf->get_byte(-rep_dist[0] - 2);
    if (cur_byte == match_byte) return {0, 1};
    return {-1, 1};
  }

  void emit_literal() {
    uint8_t cur_byte = mf->get_byte(-additional_offset);
    int sub = L.lit_sub(now_pos, prev_byte);
    if (state < 7) {
      encode_literal(sub, cur_byte);
    } else {
      uint8_t match_byte = mf->get_byte(-rep_dist[0] - 1 - additional_offset);
      encode_literal_matched(sub, match_byte, cur_byte);
    }
    prev_byte = cur_byte;
    state = next_lit(state);
  }

  void emit_rep(int pos, int length, int ps, int complex_state) {
    rc.encode_bit(probs.data(), L.is_rep + state, 1);
    if (pos == 0) {
      rc.encode_bit(probs.data(), L.is_rep_g0 + state, 0);
      rc.encode_bit(probs.data(), L.is_rep0_long + complex_state, length == 1 ? 0 : 1);
    } else {
      rc.encode_bit(probs.data(), L.is_rep_g0 + state, 1);
      if (pos == 1) {
        rc.encode_bit(probs.data(), L.is_rep_g1 + state, 0);
      } else {
        rc.encode_bit(probs.data(), L.is_rep_g1 + state, 1);
        rc.encode_bit(probs.data(), L.is_rep_g2 + state, pos - 2);
      }
    }
    if (length == 1) {
      state = next_srep(state);
    } else {
      encode_len(true, length - kMatchMinLen, ps);
      state = next_lrep(state);
    }
    int32_t distance = rep_dist[pos];
    for (int i = pos; i > 0; i--) rep_dist[i] = rep_dist[i - 1];
    rep_dist[0] = distance;
  }

  void emit_match(int pos4, int length, int ps) {
    rc.encode_bit(probs.data(), L.is_rep + state, 0);
    state = next_match(state);
    encode_len(false, length - kMatchMinLen, ps);
    uint32_t pos = (uint32_t)(pos4 - kNumRepDistances);
    int slot = get_pos_slot(pos);
    rc.encode_tree(probs.data(), L.pos_slot + len_to_pos_state(length) * 64, 6, slot);
    if (slot >= kStartPosModelIndex) {
      int footer = (slot >> 1) - 1;
      uint32_t base_val = (uint32_t)(2 | (slot & 1)) << footer;
      uint32_t reduced = pos - base_val;
      if (slot < kEndPosModelIndex) {
        rc.encode_tree_rev(probs.data(), L.spec_pos + (int)base_val - slot - 1, footer,
                           (int)reduced);
      } else {
        rc.encode_direct(reduced >> kNumAlignBits, footer - kNumAlignBits);
        rc.encode_tree_rev(probs.data(), L.align_, kNumAlignBits, (int)(reduced & kAlignMask));
        align_price_count++;
      }
    }
    for (int i = kNumRepDistances - 1; i > 0; i--) rep_dist[i] = rep_dist[i - 1];
    rep_dist[0] = (int32_t)pos;
    match_price_count++;
  }

  void write_end_marker(int ps) {
    if (!P.eos) return;
    rc.encode_bit(probs.data(), L.is_match + (state << kNumPosStatesBitsMax) + ps, 1);
    rc.encode_bit(probs.data(), L.is_rep + state, 0);
    state = next_match(state);
    encode_len(false, 0, ps);
    rc.encode_tree(probs.data(), L.pos_slot + len_to_pos_state(kMatchMinLen) * 64, 6, 63);
    uint32_t reduced = (1u << 30) - 1;
    rc.encode_direct(reduced >> kNumAlignBits, 30 - kNumAlignBits);
    rc.encode_tree_rev(probs.data(), L.align_, kNumAlignBits, (int)(reduced & kAlignMask));
  }

  MatchFinder::Kind finder_kind() const {
    return P.mf == 0   ? MatchFinder::BT2
           : P.mf == 2 ? MatchFinder::HC4
           : P.mf == 3 ? MatchFinder::FAST4
                       : MatchFinder::BT4;
  }

  // `data` spans preset||payload; only data[preset_len..n) is coded.  The
  // preset primes the dictionary: matches and literal context may reach
  // into it, position contexts start at 0 at the first coded byte, and
  // the first byte is NOT force-coded as a literal (history exists).
  void encode(const uint8_t* data, size_t n, std::vector<uint8_t>* out,
              size_t preset_len = 0) {
    delete mf;
    mf = new MatchFinder(data, (int32_t)n, (int32_t)P.dict_size, P.fb,
                         finder_kind());
    run_encode(out, preset_len, preset_len ? data[preset_len - 1] : 0,
               [] { return true; });
  }

  // Hybrid-optimal encode: the device supplies per-position ascending
  // (len, dist) candidate lists; the OPTIMAL parser runs over them with
  // zero finder work (skip is pure advance).  Contract matched:
  // BinTree.fillMatches list semantics (BinTree.java:152-273).
  void encode_cand(const uint8_t* data, size_t n, const int32_t* cl,
                   const int32_t* cd, const int64_t* coff,
                   std::vector<uint8_t>* out, size_t preset_len = 0) {
    delete mf;
    mf = new MatchFinder(data, (int32_t)n, (int32_t)P.dict_size, P.fb,
                         MatchFinder::CAND);
    mf->cand_len = cl;
    mf->cand_dist = cd;
    mf->cand_off = coff;
    run_encode(out, preset_len, preset_len ? data[preset_len - 1] : 0,
               [] { return true; });
  }

  // Streaming encode: input refills through the finder's read callback
  // (InWindow.ReadBlock semantics), output drains through write_cb at the
  // additional_offset==0 seam (the reference's 4096-byte progress seam,
  // Encoder.java:929-933) so resident memory is O(dict), not O(input).
  // Bit-identical to the flat path byte-for-byte.  Returns bytes written
  // or -10 (write failed) / -11 (read failed).
  int64_t encode_streaming(lzt_read_cb rcb, void* rctx, lzt_write_cb wcb,
                           void* wctx) {
    delete mf;
    mf = new MatchFinder(rcb, rctx, (int32_t)P.dict_size, P.fb, finder_kind());
    std::vector<uint8_t> out;
    out.reserve(1 << 21);
    bool write_failed = false;
    int64_t written = 0;
    auto drain = [&](bool force) {
      if (write_failed) return false;
      if (force || out.size() >= (1u << 20)) {
        if (!out.empty() &&
            wcb(wctx, out.data(), (int64_t)out.size()) != (int64_t)out.size())
          write_failed = true;
        written += (int64_t)out.size();
        out.clear();
      }
      return !write_failed && !mf->read_error;
    };
    run_encode(&out, 0, 0, [&] { return drain(false); });
    if (mf->read_error) return -11;
    drain(true);
    if (write_failed) return -10;
    return written;
  }

  // Shared encode loop; `seam()` runs whenever the coder catches up with
  // the match finder (additional_offset == 0) and aborts the loop when it
  // returns false.
  template <class Seam>
  void run_encode(std::vector<uint8_t>* out, size_t preset_len,
                  uint8_t prev_init, Seam&& seam) {
    probs.assign(L.size, kProbInit);
    rc = RangeEnc();
    rc.out = out;
    if (preset_len > 0 && (size_t)mf->available() >= preset_len)
      mf->skip((int)preset_len);  // insert the preset positions
    state = 0;
    prev_byte = prev_init;
    for (int i = 0; i < kNumRepDistances; i++) rep_dist[i] = 0;
    now_pos = 0;
    additional_offset = 0;
    optimum_end = optimum_cur = 0;
    longest_found = false;
    match_price_count = align_price_count = 0;
    fill_dist_prices();
    fill_align_prices();
    for (int ps = 0; ps < (1 << P.pb); ps++) {
      update_len_table(false, ps);
      update_len_table(true, ps);
    }

    if (preset_len == 0 && mf->available() > 0) {
      read_match_distances();
      rc.encode_bit(probs.data(), L.is_match + (state << kNumPosStatesBitsMax), 0);
      state = next_lit(state);
      uint8_t cur_byte = mf->get_byte(-additional_offset);
      encode_literal(L.lit_sub(0, prev_byte), cur_byte);
      prev_byte = cur_byte;
      additional_offset--;
      now_pos = 1;
    }
    if (mf->available() > 0) {
      for (;;) {
        std::pair<int, int> d = P.optimal == 1 ? get_optimum(now_pos)
                                : P.optimal == 2 ? get_lazy(now_pos)
                                                 : get_greedy(now_pos);
        int ps = (int)(now_pos & pos_state_mask);
        int complex_state = (state << kNumPosStatesBitsMax) + ps;
        if (d.first == -1 && d.second == 1) {
          rc.encode_bit(probs.data(), L.is_match + complex_state, 0);
          emit_literal();
        } else {
          rc.encode_bit(probs.data(), L.is_match + complex_state, 1);
          if (d.first < kNumRepDistances) {
            emit_rep(d.first, d.second, ps, complex_state);
          } else {
            emit_match(d.first, d.second, ps);
          }
          prev_byte = mf->get_byte(d.second - 1 - additional_offset);
        }
        additional_offset -= d.second;
        now_pos += (uint32_t)d.second;
        if (additional_offset == 0) {
          if (P.optimal == 1) {
            if (match_price_count >= (1 << 7)) fill_dist_prices();
            if (align_price_count >= kAlignTableSize) fill_align_prices();
          }
          if (!seam()) return;
          if (mf->available() == 0) break;
        }
      }
    }
    write_end_marker((int)(now_pos & pos_state_mask));
    rc.flush();
  }
};

// ------------------------------------------------------- token serializer
// Serializes a precomputed parse (token stream) into an LZMA bitstream.
// This is the host half of the hybrid TPU pipeline: the device's
// sort-based matcher produces (pos, len, dist) tokens at GB/s
// (lzma_tpu/ops/device_matcher.py) and this class performs the inherently
// bit-serial tail — LZMA state machine, rep-distance MTF, literal
// modeling, range coding — at memory speed.  Byte-identical to the
// all-device serializer given the same tokens.
class TokenEncoder {
 public:
  Layout L;
  std::vector<uint16_t> probs;
  RangeEnc rc;
  int state = 0;
  uint8_t prev_byte = 0;
  int32_t rep[4] = {0, 0, 0, 0};
  int pos_state_mask;
  const uint8_t* data = nullptr;
  // preset dictionary window (two-buffer form, like decode_block): token
  // positions stay block-relative; history reads below 0 hit the preset
  const uint8_t* preset = nullptr;
  size_t preset_len = 0;

  TokenEncoder(int lc, int lp, int pb) : L(lc, lp, pb) {
    pos_state_mask = L.pos_state_mask();
  }

  inline uint8_t hist_byte(int64_t i) const {
    return i >= 0 ? data[i] : preset[(int64_t)preset_len + i];
  }

  void encode_len_tok(int base, int symbol, int ps) {
    if (symbol < 8) {
      rc.encode_bit(probs.data(), base + kLenChoice, 0);
      rc.encode_tree(probs.data(), base + kLenLow + (ps << 3), 3, symbol);
    } else if (symbol < 16) {
      rc.encode_bit(probs.data(), base + kLenChoice, 1);
      rc.encode_bit(probs.data(), base + kLenChoice2, 0);
      rc.encode_tree(probs.data(), base + kLenMid + (ps << 3), 3, symbol - 8);
    } else {
      rc.encode_bit(probs.data(), base + kLenChoice, 1);
      rc.encode_bit(probs.data(), base + kLenChoice2, 1);
      rc.encode_tree(probs.data(), base + kLenHigh, 8, symbol - 16);
    }
  }

  void literal(uint32_t pos) {
    int ps = (int)(pos & pos_state_mask);
    rc.encode_bit(probs.data(), L.is_match + (state << kNumPosStatesBitsMax) + ps, 0);
    uint8_t cur = data[pos];
    int sub = L.lit_sub(pos, prev_byte);
    if (state < 7) {
      uint32_t context = 1;
      for (int i = 7; i >= 0; i--) {
        int bit = (cur >> i) & 1;
        rc.encode_bit(probs.data(), sub + context, bit);
        context = (context << 1) | bit;
      }
    } else {
      uint8_t mb = hist_byte((int64_t)pos - rep[0] - 1);
      uint32_t context = 1;
      bool same = true;
      for (int i = 7; i >= 0; i--) {
        int bit = (cur >> i) & 1;
        uint32_t st = context;
        if (same) {
          int match_bit = (mb >> i) & 1;
          st += (1 + match_bit) << 8;
          same = match_bit == bit;
        }
        rc.encode_bit(probs.data(), sub + st, bit);
        context = (context << 1) | bit;
      }
    }
    prev_byte = cur;
    state = next_lit(state);
  }

  void match(uint32_t pos, int length, int32_t dist) {
    if (length == 1 && dist != rep[0]) {
      // a len-1 token is only expressible as shortRep (dist == rep0);
      // any other distance degrades to a literal — same bytes, valid
      literal(pos);
      return;
    }
    int ps = (int)(pos & pos_state_mask);
    rc.encode_bit(probs.data(), L.is_match + (state << kNumPosStatesBitsMax) + ps, 1);
    int rep_idx = dist == rep[0] ? 0
                  : dist == rep[1] ? 1
                  : dist == rep[2] ? 2
                  : dist == rep[3] ? 3 : -1;
    if (rep_idx >= 0) {
      rc.encode_bit(probs.data(), L.is_rep + state, 1);
      if (rep_idx == 0 && length == 1) {
        // shortRep: a single byte repeated from rep0 (Encoder.java:952-957)
        rc.encode_bit(probs.data(), L.is_rep_g0 + state, 0);
        rc.encode_bit(probs.data(),
                      L.is_rep0_long + (state << kNumPosStatesBitsMax) + ps, 0);
        state = next_srep(state);
        prev_byte = data[pos];
        return;
      }
      if (rep_idx == 0) {
        rc.encode_bit(probs.data(), L.is_rep_g0 + state, 0);
        rc.encode_bit(probs.data(),
                      L.is_rep0_long + (state << kNumPosStatesBitsMax) + ps, 1);
      } else {
        rc.encode_bit(probs.data(), L.is_rep_g0 + state, 1);
        if (rep_idx == 1) {
          rc.encode_bit(probs.data(), L.is_rep_g1 + state, 0);
        } else {
          rc.encode_bit(probs.data(), L.is_rep_g1 + state, 1);
          rc.encode_bit(probs.data(), L.is_rep_g2 + state, rep_idx - 2);
        }
        int32_t d = rep[rep_idx];
        for (int i = rep_idx; i > 0; i--) rep[i] = rep[i - 1];
        rep[0] = d;
      }
      encode_len_tok(L.rep_len_coder, length - kMatchMinLen, ps);
      state = next_lrep(state);
    } else {
      rc.encode_bit(probs.data(), L.is_rep + state, 0);
      state = next_match(state);
      encode_len_tok(L.len_coder, length - kMatchMinLen, ps);
      int slot = get_pos_slot((uint32_t)dist);
      rc.encode_tree(probs.data(), L.pos_slot + len_to_pos_state(length) * 64, 6, slot);
      if (slot >= kStartPosModelIndex) {
        int footer = (slot >> 1) - 1;
        uint32_t base_val = (uint32_t)(2 | (slot & 1)) << footer;
        uint32_t reduced = (uint32_t)dist - base_val;
        if (slot < kEndPosModelIndex) {
          rc.encode_tree_rev(probs.data(), L.spec_pos + (int)base_val - slot - 1,
                             footer, (int)reduced);
        } else {
          rc.encode_direct(reduced >> kNumAlignBits, footer - kNumAlignBits);
          rc.encode_tree_rev(probs.data(), L.align_, kNumAlignBits,
                             (int)(reduced & kAlignMask));
        }
      }
      for (int i = 3; i > 0; i--) rep[i] = rep[i - 1];
      rep[0] = dist;
    }
    prev_byte = data[pos + length - 1];
  }

  // tokens: (pos, len, dist) triplets; dist < 0 => literal run of 1 byte.
  void encode(const uint8_t* d, const int32_t* t_pos, const int32_t* t_len,
              const int32_t* t_dist, int64_t num_tokens,
              std::vector<uint8_t>* out, const uint8_t* pre = nullptr,
              size_t pre_len = 0) {
    data = d;
    preset = pre;
    preset_len = pre_len;
    probs.assign(L.size, kProbInit);
    rc = RangeEnc();
    rc.out = out;
    state = 0;
    prev_byte = pre_len ? pre[pre_len - 1] : 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
    for (int64_t i = 0; i < num_tokens; i++) {
      if (t_dist[i] < 0) {
        literal((uint32_t)t_pos[i]);
      } else {
        match((uint32_t)t_pos[i], t_len[i], t_dist[i]);
      }
    }
    rc.flush();
  }
};

}  // namespace

// =================================================================== C API
extern "C" {

// Encode one raw LZMA stream.  Returns stream length or negative error.
// out_cap must be >= worst case (use lzt_encode_bound).
int64_t lzt_encode(const uint8_t* data, int64_t n, int lc, int lp, int pb,
                   uint32_t dict_size, int fb, int mf, int eos, int optimal,
                   uint8_t* out, int64_t out_cap) {
  if (n < 0 || n > (int64_t)0x7FF00000) return -1;  // int32 window positions
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4) return -1;
  if (fb < 5 || fb > kMatchMaxLen) return -1;
  if (dict_size < 1 || dict_size > (1u << 29)) return -1;
  EncParams p;
  p.lc = lc; p.lp = lp; p.pb = pb;
  p.dict_size = dict_size;
  p.fb = fb; p.mf = mf; p.eos = eos; p.optimal = optimal;
  std::vector<uint8_t> buf;
  buf.reserve((size_t)n + (size_t)n / 8 + 256);
  Encoder enc(p);
  enc.encode(data, (size_t)n, &buf);
  if ((int64_t)buf.size() > out_cap) return -6;
  std::memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

int64_t lzt_encode_bound(int64_t n) { return n + n / 8 + 4096; }

// Encode payload with a preset dictionary.  `buf` holds preset||payload
// contiguously (total_n bytes); the first preset_len bytes are preset.
// The preset primes the dictionary window (matches and literal context
// may reach into it); only the payload bytes are coded.
int64_t lzt_encode_pre(const uint8_t* buf, int64_t total_n, int64_t preset_len,
                       int lc, int lp, int pb, uint32_t dict_size, int fb,
                       int mf, int eos, int optimal, uint8_t* out,
                       int64_t out_cap) {
  if (total_n < 0 || total_n > (int64_t)0x7FF00000) return -1;  // int32 positions
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4) return -1;
  if (fb < 5 || fb > kMatchMaxLen) return -1;
  if (dict_size < 1 || dict_size > (1u << 29)) return -1;
  if (preset_len < 0 || preset_len > total_n) return -1;
  EncParams p;
  p.lc = lc; p.lp = lp; p.pb = pb;
  p.dict_size = dict_size;
  p.fb = fb; p.mf = mf; p.eos = eos; p.optimal = optimal;
  std::vector<uint8_t> sink;
  sink.reserve((size_t)(total_n - preset_len) + (size_t)(total_n - preset_len) / 8 + 256);
  Encoder enc(p);
  enc.encode(buf, (size_t)total_n, &sink, (size_t)preset_len);
  if ((int64_t)sink.size() > out_cap) return -6;
  std::memcpy(out, sink.data(), sink.size());
  return (int64_t)sink.size();
}

// Serialize precomputed token streams (hybrid TPU pipeline).  Blocks laid
// out back-to-back: block i's tokens are tok_counts[i] triplets starting
// at tok_offsets[i] in the flat t_* arrays; its data at data+i*block_size.
// Writes concatenated LZMA streams + per-block sizes.  Threaded.
int64_t lzt_encode_token_blocks(const uint8_t* data, int64_t n,
                                int64_t block_size, int lc, int lp, int pb,
                                const int32_t* t_pos, const int32_t* t_len,
                                const int32_t* t_dist,
                                const int64_t* tok_offsets,
                                const int64_t* tok_counts, int64_t num_blocks,
                                int num_threads, uint8_t* out, int64_t out_cap,
                                uint32_t* sizes, const uint8_t* preset = nullptr,
                                int64_t preset_len = 0, int preset_first = 0) {
  std::vector<std::vector<uint8_t>> streams((size_t)num_blocks);
  std::atomic<int64_t> next(0);
  int threads = std::max(1, (int)std::min<int64_t>(num_threads, num_blocks));
  auto worker = [&]() {
    TokenEncoder enc(lc, lp, pb);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= num_blocks) break;
      int64_t off = i * block_size;
      // v2: block 0 is the preset SOURCE and encodes plain; v3
      // (preset_first, stored trained dictionary) primes every block
      bool primed = preset_len && (preset_first || i > 0);
      const uint8_t* pre = primed ? preset : nullptr;
      size_t plen = primed ? (size_t)preset_len : 0;
      enc.encode(data + off, t_pos + tok_offsets[i], t_len + tok_offsets[i],
                 t_dist + tok_offsets[i], tok_counts[i], &streams[(size_t)i],
                 pre, plen);
    }
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < threads; i++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  int64_t total = 0;
  for (int64_t i = 0; i < num_blocks; i++) {
    sizes[i] = (uint32_t)streams[(size_t)i].size();
    total += (int64_t)streams[(size_t)i].size();
  }
  if (total > out_cap) return -6;
  int64_t off = 0;
  for (int64_t i = 0; i < num_blocks; i++) {
    std::memcpy(out + off, streams[(size_t)i].data(), streams[(size_t)i].size());
    off += (int64_t)streams[(size_t)i].size();
  }
  return total;
}

// Hybrid-optimal block encode: per block i the primed buffer is
// preset||block (preset_first/v3: every block; v2: blocks 1..n-1) and its
// per-position candidate table starts at coff + pos_base[i] (absolute
// pair indices into cl/cd).  Returns total payload bytes or negative.
int64_t lzt_encode_candidate_blocks(
    const uint8_t* data, int64_t n, int64_t block_size, int lc, int lp,
    int pb, uint32_t dict_size, int fb, const int32_t* cl, const int32_t* cd,
    const int64_t* coff, const int64_t* pos_base, int64_t num_blocks,
    int num_threads, uint8_t* out, int64_t out_cap, uint32_t* sizes,
    const uint8_t* preset, int64_t preset_len, int preset_first) {
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4) return -1;
  if (fb < 5 || fb > kMatchMaxLen) return -1;
  if (dict_size < 1 || dict_size > (1u << 29)) return -1;
  if (num_blocks <= 0) return 0;
  std::vector<std::vector<uint8_t>> streams((size_t)num_blocks);
  std::atomic<int64_t> next(0);
  int threads = std::max(1, (int)std::min<int64_t>(num_threads, num_blocks));
  auto worker = [&]() {
    EncParams p;
    p.lc = lc; p.lp = lp; p.pb = pb;
    p.dict_size = dict_size;
    p.fb = fb; p.mf = 1; p.eos = 0; p.optimal = 1;
    Encoder enc(p);
    std::vector<uint8_t> primed;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= num_blocks) break;
      int64_t off = i * block_size;
      int64_t len = std::min(block_size, n - off);
      bool use_pre = preset_len > 0 && (preset_first || i > 0);
      const int64_t* my_off = coff + pos_base[i];
      if (use_pre) {
        primed.resize((size_t)(preset_len + len));
        std::memcpy(primed.data(), preset, (size_t)preset_len);
        std::memcpy(primed.data() + preset_len, data + off, (size_t)len);
        enc.encode_cand(primed.data(), (size_t)(preset_len + len), cl, cd,
                        my_off, &streams[(size_t)i], (size_t)preset_len);
      } else {
        enc.encode_cand(data + off, (size_t)len, cl, cd, my_off,
                        &streams[(size_t)i]);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < threads; i++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  int64_t total = 0;
  for (int64_t i = 0; i < num_blocks; i++) {
    sizes[i] = (uint32_t)streams[(size_t)i].size();
    total += (int64_t)streams[(size_t)i].size();
  }
  if (total > out_cap) return -6;
  int64_t woff = 0;
  for (int64_t i = 0; i < num_blocks; i++) {
    std::memcpy(out + woff, streams[(size_t)i].data(), streams[(size_t)i].size());
    woff += (int64_t)streams[(size_t)i].size();
  }
  return total;
}

}  // extern "C"
