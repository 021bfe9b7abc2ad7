// The optimal-parse DP scan over block positions, one lane per block.
//
// Replaces the TPU kernel lzma_tpu/ops/device_parser.py dp_parse_pallas
// (its pl.pallas_call): the same contract as the plain version
// lzma_tpu_torch/ops/device_parser.py dp_parse_band -- identical
// (from, choice) planes -- without the TPU's workarounds (lanes-last
// layouts, one-hot masked selects in place of gathers, 8-position chunks
// staged through VMEM, band rolls by concatenation).
//
// Inputs, per lane: the packed rows of device_parser.dp_inputs (N rows of
// C = 6M + 5 int32: ld[M], dd[M], dcost[M][4], lit, mlit, r0pos, replen,
// sr_eq) and one table row (ltm, ltr [n_ps][W]; im0, im1, r0l0, r0l1
// [n_ps][12]; ir0, ir1 [12]; rep_sel [4][12]), W = fb - 1.
//
// What bounds it on this card: each position depends on the previous
// one (node i's state and reps come from its best predecessor, which the
// relax of earlier positions decided), so the scan is a serial chain of
// N steps per lane.  The bytes it must move (the packed rows, ~1 GB at
// 32 lanes x 256 KiB) take ~0.3 ms at 3.35 TB/s; the step's latency is
// the time, and with one lane a block that latency is the step's
// instructions issued in order by a warp.  On an H100 80GB HBM3 (700 W,
// the main path's 32 x 262,144 positions) the first version took ~1.5 us
// a step: a device-memory load of the next row inside the step (+60%
// when put back), five run-time `%` (+25%), thread 0's finalize then the
// relax between two barriers.  With those gone and one warp doing both
// halves of a step in turn, clock64 spans gave ~1,570 cycles a step,
// ~940 finalizing node i and ~590 relaxing it, ~50 in the barrier.  So
// this design:
//   - splits the step over warps that run at once: the last warp
//     finalizes node i+1 while the others relax node i, one
//     __syncthreads a step.  Node i+1's inputs are final by then: slot
//     i+1 had its last relax in step i-1, and the literal/shortRep edge
//     out of node i is held in the finalize warp's registers and applied
//     at node i+1 (it wins only when strictly cheaper, as the plain
//     version relaxes it last);
//   - relaxes a length on 4 lanes, a lane a pair, at fb <= 65 (kSplit 4;
//     the length's best by two shuffle rounds on (price, pair), the
//     first pair winning a tie), on one thread a length above;
//   - hands node i's relax terms (the match and rep bases, the reps) to
//     the relax warps through a two-entry buffer in shared memory;
//   - stages rows by tiles of kTile rows, double-buffered, with 4-byte
//     cp.async (dp_rows.cuh, shared with K4): one wait a tile, issued a
//     tile ahead;
//   - indexes the rings (future band B >= fb + 2, history H >= fb + 1,
//     powers of two) by masks: no division anywhere in the loop;
//   - computes the relax and the finalize without branches, M a
//     compile-time bound.
// The step is then ~870 cycles, the two warps' halves about even.
// Tie order is the plain version's: into slot s every match/rep edge from
// nodes s-fb..s-2 in node order (pairs m = 0..M-1, then the rep0 source,
// strict `<`, the first equal rep index), then the literal/shortRep edge
// from s-1; shortRep beats the literal only when strictly cheaper.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_rows.cuh"

namespace {

constexpr int kInf = 0x0FFFFFFF;
constexpr int kLit = -1;
constexpr int kMatch = 4;
constexpr int kShortRep = 5;
constexpr int kNodeVals = 16;         // a node's relax terms (9 used)
constexpr int kMaxPairs = 16;  // M a row at most (cuda_parser.MAX_PAIRS)
constexpr int kSplitFb = 65;   // fb a lane a pair takes (cuda_parser.SPLIT_FB)

__device__ __forceinline__ int next_lit(int s) {
  return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
}

// The block: threads [0, n_relax) relax, kSplit a length 2..fb (n_relax
// = kSplit * W rounded up to warps); the last warp finalizes.  kMaxM
// bounds the pairs a row holds at compile time (M_DP = 4 on the route).
// kSplit 4 (fb <= 65, M <= 4): a lane a pair, the length's best by a
// shuffle reduction; kSplit 1: a thread a length, its pairs in turn.
template <int kMaxM, int kSplit>
__global__ void dp_parse_kernel(const int* __restrict__ packed,
                                const int* __restrict__ tables,
                                const int* __restrict__ lens,
                                int* __restrict__ out_from,
                                int* __restrict__ out_choice, int n_pos,
                                int C, int M, int fb, int pb, int tab_size,
                                int b_mask, int h_mask) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int n_relax = nth - 32;
  const bool finalizer = tid >= n_relax;
  const int W = fb - 1, B = b_mask + 1, H = h_mask + 1;
  const int n_ps = 1 << pb;

  int* tab = smem;                 // tab_size
  int* bp = tab + tab_size;        // B: price
  int* bf = bp + B;                // B: from offset (node - from)
  int* bc = bf + B;                // B: choice (distance, -1 literal)
  int* bk = bc + B;                // B: kind
  int* hst = bk + B;               // H: state
  int* hrp = hst + H;              // 4H: reps
  int* nv = hrp + 4 * H;           // 2 x kNodeVals: node i's relax terms
  int* rows = nv + 2 * kNodeVals;  // 2 tiles of kTile rows

  const int* ltm = tab;
  const int* ltr = ltm + n_ps * W;
  const int* im0 = ltr + n_ps * W;
  const int* im1 = im0 + n_ps * 12;
  const int* r0l0 = im1 + n_ps * 12;
  const int* r0l1 = r0l0 + n_ps * 12;
  const int* ir0 = r0l1 + n_ps * 12;
  const int* ir1 = ir0 + 12;
  const int* sel = ir1 + 12;

  const int* src = packed + static_cast<size_t>(lane) * n_pos * C;
  const int* lane_tab = tables + static_cast<size_t>(lane) * tab_size;
  int* o_from = out_from + static_cast<size_t>(lane) * (n_pos + 1);
  int* o_choice = out_choice + static_cast<size_t>(lane) * (n_pos + 1);
  const int len = lens[lane];
  const int tile_ints = kTile * C;

  if (n_pos > 0) stage_tile(rows, src, 0, n_pos, C, tid, nth);
  for (int k = tid; k < tab_size; k += nth) tab[k] = lane_tab[k];
  for (int k = tid; k < B; k += nth) {
    bp[k] = k == 0 ? 0 : kInf;
    bf[k] = 0;
    bc[k] = -1;
    bk[k] = kLit;
  }
  for (int k = tid; k < 5 * H; k += nth) hst[k] = 0;  // hst and hrp
  async_wait();
  __syncthreads();

  // row j of the lane, in its tile
  auto row_at = [&](int j) -> const int* {
    return rows + ((j >> kTileLog) & 1) * tile_ints + (j & (kTile - 1)) * C;
  };

  // ---------------------------------------------------------------- finalize
  // The finalize warp's state: node j-1 and the literal/shortRep edge out
  // of it into node j, every lane alike.
  int st1 = 0, q0 = 0, q1 = 0, q2 = 0, q3 = 0;
  int lit_p = kInf, lit_c = -1, lit_k = kLit;

  // Node j from slot j (final) and the held edge; writes its outputs, its
  // history entry and its relax terms (nv[j & 1]), retires slot j-1, and
  // holds the edge out of it.
  auto finalize = [&](int j) {
    // row j's literal terms, loaded first (row n_pos does not exist)
    const int* row = row_at(min(j, n_pos - 1));
    const bool live = j < len;
    const int lit = live ? row[6 * M] : 0, mlit = live ? row[6 * M + 1] : 0;
    const int r0p = live ? row[6 * M + 2] : 0;
    const bool sr_eq = live && row[6 * M + 4] > 0;
    const int s = j & b_mask;
    const int pp = bp[s], pd = bf[s], pc = bc[s], pk = bk[s];
    const bool lw = lit_p < pp;
    const int p_j = lw ? lit_p : pp;
    const int d_j = lw ? 1 : pd;
    const int c_j = lw ? lit_c : pc;
    const int k_j = lw ? lit_k : pk;
    // the predecessor is node j-1 for a step of 1 (and for an unreached
    // node, as the plain version's clamp gives), else its history entry
    const bool near = lw || pd < 2;
    const int hs = (j - max(pd, 2)) & h_mask;
    const int sp = near ? st1 : hst[hs];
    const int a0 = near ? q0 : hrp[4 * hs], a1 = near ? q1 : hrp[4 * hs + 1];
    const int a2 = near ? q2 : hrp[4 * hs + 2], a3 = near ? q3 : hrp[4 * hs + 3];
    const bool is_rep = k_j >= 0 && k_j < 4;
    const bool is_m = k_j == kMatch;
    const bool low = sp < 7;
    int st = k_j == kLit ? next_lit(sp)
             : k_j == kShortRep ? (low ? 9 : 11)
             : is_rep ? (low ? 8 : 11) : (low ? 7 : 10);
    const int kk = min(max(k_j, 0), 3);
    const int picked = kk == 0 ? a0 : (kk == 1 ? a1 : (kk == 2 ? a2 : a3));
    int r0 = is_rep ? picked : (is_m ? c_j : a0);
    int r1 = ((is_rep && kk >= 1) || is_m) ? a0 : a1;
    int r2 = ((is_rep && kk >= 2) || is_m) ? a1 : a2;
    int r3 = ((is_rep && kk >= 3) || is_m) ? a2 : a3;
    if (j == 0) st = r0 = r1 = r2 = r3 = 0;

    // node j's flag prices: the one lookup by state
    const int ps = j & (n_ps - 1);
    const int ix = ps * 12 + st;
    const int f_im0 = im0[ix], f_im1 = im1[ix];
    const int f_r0l0 = r0l0[ix], f_r0l1 = r0l1[ix];
    const int f_ir0 = ir0[st], f_ir1 = ir1[st];
    const int sel0 = sel[st];
    const int rep_head = p_j + f_im1 + f_ir1;

    // the literal / shortRep edge -> node j+1, held until node j+1
    {
      const int cand_l = p_j + f_im0 + (st >= 7 ? mlit : lit);
      const bool sr_ok = sr_eq && r0 == r0p;
      const int cand_sr = sr_ok ? rep_head + sel0 + f_r0l0 : kInf;
      const bool use_sr = cand_sr < cand_l;
      lit_p = live ? (use_sr ? cand_sr : cand_l) : kInf;
      lit_c = live && use_sr ? r0 : -1;
      lit_k = live && use_sr ? kShortRep : kLit;
    }

    // every lane of the warp stores the same values: no branch
    {
      o_from[j] = j - d_j;
      o_choice[j] = c_j;
      int* v = nv + (j & 1) * kNodeVals;
      v[0] = p_j + f_im1 + f_ir0;             // match base
      v[1] = rep_head + sel0 + f_r0l1;         // rep0 base
      v[2] = rep_head + sel[12 + st];
      v[3] = rep_head + sel[24 + st];
      v[4] = rep_head + sel[36 + st];
      v[5] = r0;
      v[6] = r1;
      v[7] = r2;
      v[8] = r3;
      const int hw = j & h_mask;
      hst[hw] = st;
      hrp[4 * hw] = r0;
      hrp[4 * hw + 1] = r1;
      hrp[4 * hw + 2] = r2;
      hrp[4 * hw + 3] = r3;
      if (j > 0) {
        // slot j-1 was read in the previous step; it becomes node j-1+B,
        // beyond this step's relax window j+1..j-1+fb
        const int sr = (j - 1) & b_mask;
        bp[sr] = kInf;
        bf[sr] = 0;
        bc[sr] = -1;
        bk[sr] = kLit;
      }
    }

    st1 = st;
    q0 = r0;
    q1 = r1;
    q2 = r2;
    q3 = r3;
  };

  // ------------------------------------------------------------------- relax
  const int l = tid / kSplit + 2;  // a relax thread's length
  const int pm = tid % kSplit;     // kSplit 4: its pair
  const bool relaxes = !finalizer && l <= fb;
  const int lw2 = min(l, fb) - 2;  // its column of ltm, ltr
  const int lps = min(lw2, 3);     // its len-to-pos state

  // Node i's edges of this thread's length into slot i+l: pairs m =
  // 0..M-1 then the rep0 source, strict `<`, without branches.
  auto relax = [&](int i) {
    const int* row = row_at(i);
    const int* v = nv + (i & 1) * kNodeVals;
    const int sl = (i + l) & b_mask;
    const int cur = relaxes ? bp[sl] : kInf;
    const int ps = i & (n_ps - 1);
    const int rem = len - i;
    const bool act = relaxes && i < len;
    const int lt_m = ltm[ps * W + lw2];
    const int lt_r = ltr[ps * W + lw2];
    const int mbase = v[0], rb0 = v[1], rb1 = v[2], rb2 = v[3], rb3 = v[4];
    const int r0 = v[5], r1 = v[6], r2 = v[7], r3 = v[8];
    int best = kInf, bdist = 0, bkind = kMatch;
    // pair m's edge of this length: its price, or kInf where it cannot
    // relax; its distance and kind
    auto pair = [&](int m, int& cost, int& d, int& kind) {
      const int ldc = min(row[m], rem);
      d = row[M + m];
      const bool ok = act && ldc >= 2 && d >= 0 && l <= ldc;
      // the first equal rep index wins
      kind = d == r0 ? 0 : (d == r1 ? 1 : (d == r2 ? 2 : (d == r3 ? 3 : kMatch)));
      const int rb = kind == 0 ? rb0 : (kind == 1 ? rb1 : (kind == 2 ? rb2 : rb3));
      const int c = kind != kMatch ? rb + lt_r : mbase + row[2 * M + 4 * m + lps] + lt_m;
      cost = ok ? min(c, kInf) : kInf;
    };
    if constexpr (kSplit == 4) {
      // (cost, m) packed so that the least key is the cheapest pair and,
      // on a tie, the first; a price never reaches 2^29
      int key = (kInf << 2) | pm, d = 0, kind = kMatch;
      if (pm < M) {
        int cost;
        pair(pm, cost, d, kind);
        key = (cost << 2) | pm;
      }
      key = min(key, __shfl_xor_sync(0xffffffffu, key, 1));
      key = min(key, __shfl_xor_sync(0xffffffffu, key, 2));
      const int win = (tid & 31 & ~3) | (key & 3);
      const int wd = __shfl_sync(0xffffffffu, d, win);
      const int wkind = __shfl_sync(0xffffffffu, kind, win);
      if ((key >> 2) < kInf) {
        best = key >> 2;
        bdist = wd;
        bkind = wkind;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          int cost, d, kind;
          pair(m, cost, d, kind);
          const bool better = cost < best;
          best = better ? cost : best;
          bdist = better ? d : bdist;
          bkind = better ? kind : bkind;
        }
      }
    }
    const int r0p = row[6 * M + 2];
    const int rlc = min(row[6 * M + 3], rem);
    const int cost0 = rb0 + lt_r;
    const bool better0 = act && rlc >= 2 && l <= rlc && r0 == r0p && cost0 < best;
    best = better0 ? cost0 : best;
    bdist = better0 ? r0p : bdist;
    bkind = better0 ? 0 : bkind;
    if (pm == 0 && best < cur) {
      bp[sl] = best;
      bf[sl] = l;
      bc[sl] = max(bdist, 0);
      bk[sl] = bkind;
    }
  };

  // node 0, then step i: node i+1 finalized while node i relaxes
  if (finalizer) finalize(0);
  __syncthreads();
  for (int i = 0; i < n_pos; ++i) {
    const int t = i >> kTileLog;
    if ((i & (kTile - 1)) == 0 && ((t + 1) << kTileLog) < n_pos) {
      stage_tile(rows + ((t + 1) & 1) * tile_ints, src, t + 1, n_pos, C, tid,
                 nth);
    }
    if (finalizer) {
      finalize(i + 1);
    } else {
      relax(i);
    }
    // the tile of row i+2 (read by the next step's finalize), issued at
    // its predecessor's first step, has landed
    if (((i + 2) & (kTile - 1)) == 0) async_wait();
    __syncthreads();
  }
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int kMaxM, int kSplit>
int launch(const int* packed, const int* tables, const int* lens,
           int* out_from, int* out_choice, int n_lanes, int n_pos, int C,
           int M, int fb, int pb, int tab_size, int b, int h, int smem_bytes,
           cudaStream_t stream) {
  const int threads = ((kSplit * (fb - 1) + 31) / 32) * 32 + 32;
  cudaError_t err = cudaFuncSetAttribute(
      dp_parse_kernel<kMaxM, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    dp_parse_kernel<kMaxM, kSplit><<<n_lanes, threads, smem_bytes, stream>>>(
        packed, tables, lens, out_from, out_choice, n_pos, C, M, fb, pb,
        tab_size, b - 1, h - 1);
  }
  return static_cast<int>(cudaGetLastError());
}

bool plan_ok(int C, int M, int fb, int tab_size, int b, int h,
             int smem_bytes) {
  const long long need =
      4LL * (static_cast<long long>(tab_size) + 4 * b + 5 * h +
             2 * kNodeVals + 2LL * kTile * C);
  return is_pow2(b) && is_pow2(h) && b >= fb + 2 && h >= fb + 1 &&
         need == smem_bytes && M >= 1 && M <= kMaxPairs;
}

}  // namespace

// smem_bytes, b and h are cuda_parser.dp_parse_plan's: the launch is
// refused (cudaErrorInvalidValue) unless they are the layout above.
extern "C" int lzt_dp_parse(const int* packed, const int* tables,
                            const int* lens, int* out_from, int* out_choice,
                            int n_lanes, int n_pos, int C, int M, int fb,
                            int pb, int tab_size, int b, int h,
                            int smem_bytes, void* stream) {
  if (!plan_ok(C, M, fb, tab_size, b, h, smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LZT_DP_ARGS                                                        \
  packed, tables, lens, out_from, out_choice, n_lanes, n_pos, C, M, fb, pb, \
      tab_size, b, h, smem_bytes, s
  if (M > 4) return launch<kMaxPairs, 1>(LZT_DP_ARGS);
  if (fb > kSplitFb) return launch<4, 1>(LZT_DP_ARGS);
  return launch<4, 4>(LZT_DP_ARGS);
#undef LZT_DP_ARGS
}
