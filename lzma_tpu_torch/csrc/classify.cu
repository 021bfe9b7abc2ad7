// The LZMA state machine and rep-distance MTF over per-lane token streams
// (K6).
//
// Replaces the carry of lzma_tpu/ops/device_encoder.py classify_tokens, a
// lax.scan that JAX compiles for the device (it has no pallas_call): the
// same contract as the plain version lzma_tpu_torch/ops/device_encoder.py
// _classify_carry -- for every token of every lane its scan case (0 fresh
// match, 1..4 rep0..rep3, 5 literal), the state before it and rep0 before
// it, in the (T, N) layout of the token rows.  The gathers around the
// carry (prev, literal and match bytes) stay vectorized in PyTorch
// (_classify_finish).
//
// What bounds it on this card: a lane is one dependent chain -- the state
// and the four reps carried from token to token -- so a lane's time is
// the latency of a step, not its bytes, and a lane is one thread.  The
// design:
//   - one thread a lane, 32 lanes a block, serial over the lane's tokens
//     up to its last valid one; the state and rep0-3 live in registers,
//     the transitions are the closed forms of the 12-state machine
//     (Base.java's StateUpdate*), the MTF a chain of selects;
//   - the token rows are (T, N): at a step the lanes of a warp read one
//     line of each row; the next token's operands are loaded before the
//     current step's chain;
//   - an invalid token holds the carry (the plain version's case 6);
//     where a lane's tokens end differs by lane, so a first grid finds
//     each lane's last valid token (an atomicMax only where a valid
//     token is followed by an invalid one), and a last grid fills every
//     lane's tail past it from the carry the serial grid left, in
//     parallel.  Three grids, one call.
// A step is ~25-40 dependent instructions; its stores are off the chain.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEosDist = -2;     // device_encoder.EOS_DIST: a match
constexpr int kLanes = 32;       // lanes (threads) a block of the carry
constexpr int kFillThreads = 256;
constexpr int kMaxFillBlocks = 4096;

__device__ __forceinline__ int case_of(int d, int r0, int r1, int r2,
                                       int r3) {
  const bool lit = d < 0 && d != kEosDist;
  const int m = d == r0 ? 1 : d == r1 ? 2 : d == r2 ? 3 : d == r3 ? 4 : 0;
  return lit ? 5 : m;
}

// ends[lane] = 1 + the lane's last valid token (0 where it has none).
__global__ void lane_ends_kernel(const uint8_t* __restrict__ valid,
                                 int* __restrict__ ends, int n_tok,
                                 int n_lanes) {
  const long long total = static_cast<long long>(n_tok) * n_lanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    if (!valid[e]) continue;
    const long long i = e / n_lanes;
    if (i + 1 < n_tok && valid[e + n_lanes]) continue;
    atomicMax(&ends[e - i * n_lanes], static_cast<int>(i + 1));
  }
}

// One thread a lane over its tokens 0 .. ends[lane] - 1; the final carry
// (state, r0, r1, r2, r3) goes to carry[k * n_lanes + lane].
__global__ void __launch_bounds__(kLanes)
    carry_kernel(const int* __restrict__ dist, const int* __restrict__ len,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ ends, int* __restrict__ case_r,
                 int* __restrict__ state_r, int* __restrict__ r0_r,
                 int* __restrict__ carry, int n_lanes) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= n_lanes) return;
  const int end = ends[lane];
  int state = 0, r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  long long at = lane;
  int d = 0, l = 0, v = 0;
  if (end > 0) {
    d = __ldg(dist + at);
    l = __ldg(len + at);
    v = __ldg(valid + at);
  }
  for (int i = 0; i < end; ++i) {
    const long long next = at + n_lanes;
    int dn = 0, ln = 0, vn = 0;
    if (i + 1 < end) {
      dn = __ldg(dist + next);
      ln = __ldg(len + next);
      vn = __ldg(valid + next);
    }
    state_r[at] = state;
    r0_r[at] = r0;
    const int c = case_of(d, r0, r1, r2, r3);
    case_r[at] = c;
    // the transition of this token's case, held where it is invalid
    const bool high = state >= 7;
    const int lit_state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
    const int rep_state = l < 2 ? (high ? 11 : 9) : (high ? 11 : 8);
    const int match_state = high ? 10 : 7;
    const int next_state = c == 5 ? lit_state
                           : c == 0 ? match_state : rep_state;
    const bool moves = v && c != 5;  // a match or rep: the reps move
    const int s1 = moves && c != 1;
    const int s2 = moves && (c == 0 || c >= 3);
    const int s3 = moves && (c == 0 || c == 4);
    r3 = s3 ? r2 : r3;
    r2 = s2 ? r1 : r2;
    r1 = s1 ? r0 : r1;
    r0 = moves ? d : r0;  // a rep's dist is the rep it matched
    state = v ? next_state : state;
    d = dn;
    l = ln;
    v = vn;
    at = next;
  }
  carry[lane] = state;
  carry[n_lanes + lane] = r0;
  carry[2 * n_lanes + lane] = r1;
  carry[3 * n_lanes + lane] = r2;
  carry[4 * n_lanes + lane] = r3;
}

// Every token at or past its lane's end: the held carry.
__global__ void tail_kernel(const int* __restrict__ dist,
                            const int* __restrict__ ends,
                            const int* __restrict__ carry,
                            int* __restrict__ case_r,
                            int* __restrict__ state_r,
                            int* __restrict__ r0_r, int n_tok,
                            int n_lanes) {
  const long long total = static_cast<long long>(n_tok) * n_lanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long i = e / n_lanes;
    const int lane = static_cast<int>(e - i * n_lanes);
    if (i < __ldg(ends + lane)) continue;
    const int r0 = __ldg(carry + n_lanes + lane);
    state_r[e] = __ldg(carry + lane);
    r0_r[e] = r0;
    case_r[e] = case_of(__ldg(dist + e), r0, __ldg(carry + 2 * n_lanes + lane),
                        __ldg(carry + 3 * n_lanes + lane),
                        __ldg(carry + 4 * n_lanes + lane));
  }
}

}  // namespace

// dist, len: (n_tok, n_lanes) int32; valid: (n_tok, n_lanes) bytes 0/1;
// ends: (n_lanes,) int32 and carry: (5, n_lanes) int32 scratch; case_r,
// state_r, r0_r: (n_tok, n_lanes) int32 outputs.  Returns the first CUDA
// error of the three launches (0 on success).
extern "C" int lzt_classify(const int* dist, const int* len,
                            const uint8_t* valid, int* ends, int* carry,
                            int* case_r, int* state_r, int* r0_r, int n_tok,
                            int n_lanes, void* stream) {
  if (n_tok <= 0 || n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ends, 0, sizeof(int) * n_lanes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(n_tok) * n_lanes;
  const int fill_blocks = static_cast<int>(
      std::min<long long>((total + kFillThreads - 1) / kFillThreads,
                          kMaxFillBlocks));
  lane_ends_kernel<<<fill_blocks, kFillThreads, 0, s>>>(valid, ends, n_tok,
                                                        n_lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<<<(n_lanes + kLanes - 1) / kLanes, kLanes, 0, s>>>(
      dist, len, valid, ends, case_r, state_r, r0_r, carry, n_lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_kernel<<<fill_blocks, kFillThreads, 0, s>>>(dist, ends, carry, case_r,
                                                   state_r, r0_r, n_tok,
                                                   n_lanes);
  return static_cast<int>(cudaGetLastError());
}
