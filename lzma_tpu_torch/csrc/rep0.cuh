// The closed forms of the rep0 trace (csrc/rep0.cu, K20), the optimal
// rounds' rep0 in effect at every position (lzma_tpu_torch/ops/
// device_parser.py rep0_trace): r0pos[p] is the distance of the last
// valid match token (t_dist >= 0) whose position, clamped to N - 1, is at
// most p, and 0 before the first.
//
// The kernel fills from the token side, which holds where a lane's valid
// tokens lie at strictly ascending t_pos >= 0 (K14's compactions give
// them so): the positions from one valid token's clamped place up to the
// next one's take the rep0 after the first.  A run of tokens is summed up
// by an Agg: its first and last valid position, its last valid match's
// position and distance, and whether the order broke inside it; runs
// join in order.  A broken order sets the kernel's status word and the
// wrapper raises.
//
// Plain C++ under LZT_HD (search_list.cuh's), so that a host compiler can
// build it too (the CPU tests hold it to the plain version through a g++
// build).

#pragma once

#include <cstdint>

#ifndef LZT_HD
#if defined(__CUDACC__)
#define LZT_HD __host__ __device__ __forceinline__
#else
#define LZT_HD inline
#endif
#endif

namespace rep0 {

constexpr int64_t kNone = -1;  // no valid token (no match) in the run

struct Agg {
  int64_t first;  // t_pos of the run's first valid token
  int64_t last;   // of its last valid token
  int64_t mpos;   // of its last valid match token
  int64_t mdist;  // that match's distance
  int bad;        // a valid t_pos below 0, or not above the one before it
};

LZT_HD Agg empty() { return Agg{kNone, kNone, kNone, 0, 0}; }

// A token counts as a match where it is valid and its distance is >= 0.
LZT_HD bool is_match(bool valid, int64_t dist) { return valid && dist >= 0; }

// A position clamped to the last of the lane's n positions.
LZT_HD int64_t clamp_pos(int64_t pos, int64_t n) {
  return pos < n - 1 ? pos : n - 1;
}

// The run a, then one token.
LZT_HD Agg push(Agg a, int64_t pos, int64_t dist, bool valid) {
  if (!valid) return a;
  a.bad |= pos < 0 || (a.last != kNone && pos <= a.last) ? 1 : 0;
  if (a.first == kNone) a.first = pos;
  a.last = pos;
  if (dist >= 0) {
    a.mpos = pos;
    a.mdist = dist;
  }
  return a;
}

// The run a, then the run b.
LZT_HD Agg join(Agg a, Agg b) {
  Agg o = b;
  o.bad = a.bad | b.bad |
          (a.last != kNone && b.first != kNone && b.first <= a.last ? 1 : 0);
  if (b.first == kNone) {
    o.first = a.first;
    o.last = a.last;
  } else if (a.first != kNone) {
    o.first = a.first;
  }
  if (b.mpos == kNone) {
    o.mpos = a.mpos;
    o.mdist = a.mdist;
  }
  return o;
}

// The place from which a run's end holds (its last valid token's clamped
// position, 0 where it has none) and the rep0 it leaves (its last match's
// distance, 0 where it has none).
LZT_HD int64_t place(const Agg& a, int64_t n) {
  return a.last == kNone ? 0 : clamp_pos(a.last, n);
}
LZT_HD int64_t value(const Agg& a) { return a.mpos == kNone ? 0 : a.mdist; }

}  // namespace rep0
