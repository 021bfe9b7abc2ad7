// The per-token closed forms of the classify finish (csrc/classify.cu's
// last grid, K19), in the order of lzma_tpu_torch/ops/device_encoder.py's
// plain version (_classify_finish): from a token's scan case, its state
// and rep0 before it (the carry's) and its position, the seven int64
// values classify_tokens returns for it -- kind, rep_idx, state_before,
// match_mode, match_byte, prev_byte and lit_byte.
//
// The byte reads clamp their index into the lane, as the plain version's
// clamps do (t_pos - 1 at 0, t_pos at max_n - 1, t_pos - rep0 - 1 into
// [0, max_n - 1]); where the plain version's gather would still fall
// outside the lane (t_pos past max_n, or below 0), the torch gather
// raises and the JAX reference clamps, as these forms do.
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

namespace classify_meta {

constexpr int64_t kLit = 0;      // device_encoder.K_LIT
constexpr int64_t kMatch = 1;    // K_MATCH
constexpr int64_t kRep = 2;      // K_REP
constexpr int64_t kEosDist = -2; // device_encoder.EOS_DIST: a match
constexpr int kPlanes = 7;       // the values a token gets

// A token's distance is a literal's: negative and not the end marker.
LZT_HD bool is_literal(int64_t dist) { return dist < 0 && dist != kEosDist; }

// An index clamped into a lane of max_n bytes (max_n > 0).
LZT_HD int64_t clamp_index(int64_t i, int64_t max_n) {
  return i < 0 ? 0 : i > max_n - 1 ? max_n - 1 : i;
}

// The seven values of a token: c its scan case (0 fresh match, 1..4
// rep0..rep3, 5 literal), lit whether its distance is a literal's, state
// and r0 the carry before it, pos its t_pos; lane the lane's max_n bytes.
// out: kind, rep_idx, state_before, match_mode, match_byte, prev_byte,
// lit_byte.
LZT_HD void finish(int c, bool lit, int state, int r0, int64_t pos,
                   const uint8_t* lane, int64_t max_n, int64_t* out) {
  const bool rep = c >= 1 && c <= 4;
  out[0] = lit ? kLit : rep ? kRep : kMatch;
  out[1] = rep ? c - 1 : 3;
  out[2] = state;
  out[3] = state >= 7 && lit ? 1 : 0;
  out[4] = lane[clamp_index(pos - static_cast<int64_t>(r0) - 1, max_n)];
  out[5] = pos > 0 ? lane[clamp_index(pos - 1, max_n)] : 0;
  out[6] = lane[clamp_index(pos, max_n)];
}

}  // namespace classify_meta
