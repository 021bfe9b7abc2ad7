// The optimal-parse DP scan with the node state carried in the band, one
// lane per block.
//
// Replaces the TPU kernel lzma_tpu/ops/device_parser.py dp_parse_pallas2
// (its pl.pallas_call).  Same inputs and the same (from, choice) planes as
// dp_parse.cu (K3) and as the plain version
// lzma_tpu_torch/ops/device_parser.py dp_parse_band; the packed rows and
// the table row are laid out as there (device_parser.dp_inputs).
//
// What bounds it on this card: as in K3, each position depends on the
// previous ones, so the scan is a serial chain of N steps per lane and
// its time is the step's latency, not the ~1 GB of packed rows (0.3 ms
// at 3.35 TB/s for 32 lanes x 256 KiB).  What differs from K3 is the
// step.  K3 finalizes node i+1 on a warp of its own (a chain of
// dependent shared-memory reads through the history band) while the
// other warps relax node i.  Here every slot of the future band carries
// its node's state and rep set, written when the edge is relaxed from
// the already-final source node, so there is no history band and no
// finalize: at step i slot i is final, and every thread reads it and
// looks up node i's flag prices itself.  The step is K3's relax half
// with those lookups in front, and its cost is that half's latency, so
// the design is K3's:
//   - rows by tiles of kTile rows, double-buffered, 4-byte cp.async
//     (dp_rows.cuh, shared with K3), one wait a tile, issued a tile
//     ahead: no load of a row inside the step;
//   - the literal/shortRep edge into slot i+1, and node i's outputs, on
//     a warp of its own (every lane alike), beside the relax warps: a
//     lane of a relax warp would make that warp run both in turn;
//   - a length on 4 lanes, a lane a pair, at fb <= 65 with at most 4
//     pairs a row (kSplit 4; the length's best by two shuffle rounds on
//     (price, pair), the first pair winning a tie), on one thread a
//     length above;
//   - the future band B >= fb + 1 a power of two, indexed by masks;
//   - the relax without branches, M a compile-time bound.
// The slot that length fb writes at step i (node i+fb) held a node that
// is final and read by then (B >= fb + 1), and length fb is its first
// writer in this life, so it writes it whole (the winner or the empty
// node) and no reset is needed.
// Ties break as in K3 and the plain version: pairs m = 0..M-1, then the
// rep0 source, with a strict `<`; the rep index is the first equal of
// r0..r3; shortRep wins only when strictly cheaper.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_rows.cuh"

namespace {

constexpr int kInf = 0x0FFFFFFF;
constexpr int kMatch = 4;
constexpr int kMaxPairs = 16;  // M a row at most (cuda_parser.MAX_PAIRS)
constexpr int kSplitFb = 65;   // fb a lane a pair takes (cuda_parser.SPLIT_FB)

__device__ __forceinline__ int next_lit(int s) {
  return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
}

// The block: threads [0, n_relax) relax, kSplit a length 2..fb (n_relax
// = kSplit * (fb - 1) rounded up to warps); the last warp relaxes the
// literal/shortRep edge and writes node i's outputs.
template <int kMaxM, int kSplit>
__global__ void dp_parse2_kernel(const int* __restrict__ packed,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ lens,
                                 int* __restrict__ out_from,
                                 int* __restrict__ out_choice, int n_pos,
                                 int C, int M, int fb, int pb, int tab_size,
                                 int b_mask) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const bool lit_warp = tid >= nth - 32;
  const int W = fb - 1, B = b_mask + 1;
  const int n_ps = 1 << pb;

  int* tab = smem;                 // tab_size
  int* bp = tab + tab_size;        // B: price
  int* bf = bp + B;                // B: from offset (node - from)
  int* bc = bf + B;                // B: choice (distance, -1 literal)
  int* bst = bc + B;               // B: state
  int* brp = bst + B;              // 4B: reps, slot-major
  int* rows = brp + 4 * B;         // 2 tiles of kTile rows

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
    bst[k] = 0;
  }
  for (int k = tid; k < 4 * B; k += nth) brp[k] = 0;
  async_wait();
  __syncthreads();

  const int l = tid / kSplit + 2;  // a relax thread's length
  const int pm = tid % kSplit;     // kSplit 4: its pair
  const bool relaxes = !lit_warp && l <= fb;
  const int lw2 = min(l, fb) - 2;  // its column of ltm, ltr
  const int lps = min(lw2, 3);     // its len-to-pos state

  for (int i = 0; i < n_pos; ++i) {
    const int t = i >> kTileLog;
    if ((i & (kTile - 1)) == 0 && ((t + 1) << kTileLog) < n_pos) {
      stage_tile(rows + ((t + 1) & 1) * tile_ints, src, t + 1, n_pos, C, tid,
                 nth);
    }
    // row i of the lane, in its tile
    const int* row =
        rows + ((i >> kTileLog) & 1) * tile_ints + (i & (kTile - 1)) * C;
    const int s0 = i & b_mask;
    const int ps = i & (n_ps - 1);
    const int ix = ps * 12;
    const bool live = i < len;

    // --- node i is final in its slot: every thread reads it ---
    const int p_i = bp[s0];
    const int st = bst[s0];
    const int r0 = brp[4 * s0], r1 = brp[4 * s0 + 1];
    const int r2 = brp[4 * s0 + 2], r3 = brp[4 * s0 + 3];
    const int f_im1 = im1[ix + st];
    const int rep_head = p_i + f_im1 + ir1[st];

    if (lit_warp) {
      // node i's outputs and the literal / shortRep edge -> slot i+1,
      // state and reps carried; every lane stores the same values
      o_from[i] = i - bf[s0];
      o_choice[i] = bc[s0];
      const int s1 = (i + 1) & b_mask;
      const int lcost = st >= 7 ? row[6 * M + 1] : row[6 * M];
      const int cand_l = p_i + im0[ix + st] + lcost;
      const bool sr_ok = row[6 * M + 4] > 0 && r0 == row[6 * M + 2];
      const int cand_sr = sr_ok ? rep_head + sel[st] + r0l0[ix + st] : kInf;
      const bool use_sr = cand_sr < cand_l;
      const int cand1 = use_sr ? cand_sr : cand_l;
      if (live && cand1 < bp[s1]) {
        bp[s1] = cand1;
        bf[s1] = 1;
        bc[s1] = use_sr ? r0 : -1;
        bst[s1] = use_sr ? (st < 7 ? 9 : 11) : next_lit(st);
        brp[4 * s1] = r0;
        brp[4 * s1 + 1] = r1;
        brp[4 * s1 + 2] = r2;
        brp[4 * s1 + 3] = r3;
      }
    } else {
      // --- match / rep relax: this thread's length l -> slot i+l ---
      const int sl = (i + l) & b_mask;
      const int cur = bp[sl];
      const int rem = len - i;
      const bool act = relaxes && live;
      const int lt_m = ltm[ps * W + lw2];
      const int lt_r = ltr[ps * W + lw2];
      const int mbase = p_i + f_im1 + ir0[st];
      const int rb0 = rep_head + sel[st] + r0l1[ix + st];
      const int rb1 = rep_head + sel[12 + st];
      const int rb2 = rep_head + sel[24 + st];
      const int rb3 = rep_head + sel[36 + st];
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
        const int c = kind != kMatch ? rb + lt_r
                                     : mbase + row[2 * M + 4 * m + lps] + lt_m;
        cost = ok ? min(c, kInf) : kInf;
      };
      if constexpr (kSplit == 4) {
        // (cost, m) packed so that the least key is the cheapest pair
        // and, on a tie, the first; a price never reaches 2^29
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
      const bool better0 =
          act && rlc >= 2 && l <= rlc && r0 == r0p && cost0 < best;
      best = better0 ? cost0 : best;
      bdist = better0 ? r0p : bdist;
      bkind = better0 ? 0 : bkind;
      // l == fb: the slot held node i+fb-B until now; node i+fb's first
      // writer sets it whole, the empty node where nothing won
      if (relaxes && pm == 0 && (best < cur || l == fb)) {
        const bool won = best < kInf;
        const bool is_m = bkind == kMatch;
        const int kk = is_m ? 0 : bkind;
        bp[sl] = won ? best : kInf;
        bf[sl] = won ? l : 0;
        bc[sl] = won ? max(bdist, 0) : -1;
        bst[sl] = won ? (is_m ? (st < 7 ? 7 : 10) : (st < 7 ? 8 : 11)) : 0;
        brp[4 * sl] = won ? bdist : 0;
        brp[4 * sl + 1] = won ? ((is_m || kk >= 1) ? r0 : r1) : 0;
        brp[4 * sl + 2] = won ? ((is_m || kk >= 2) ? r1 : r2) : 0;
        brp[4 * sl + 3] = won ? ((is_m || kk >= 3) ? r2 : r3) : 0;
      }
    }
    // the tile of row i+1 (read by the next step), issued at its
    // predecessor's first step, has landed
    if (((i + 1) & (kTile - 1)) == 0) async_wait();
    __syncthreads();
  }

  if (tid == 0) {
    const int sn = n_pos & b_mask;
    o_from[n_pos] = n_pos - bf[sn];
    o_choice[n_pos] = bc[sn];
  }
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int split_of(int fb, int M) { return fb <= kSplitFb && M <= 4 ? 4 : 1; }

bool plan_ok(int C, int M, int fb, int tab_size, int threads, int b,
             int smem_bytes) {
  const int relax = (split_of(fb, M) * (fb - 1) + 31) / 32 * 32;
  const long long need =
      4LL * (static_cast<long long>(tab_size) + 8 * b + 2LL * kTile * C);
  return is_pow2(b) && b >= fb + 1 && threads == relax + 32 &&
         need == smem_bytes && M >= 1 && M <= kMaxPairs && C == 6 * M + 5;
}

template <int kMaxM, int kSplit>
int launch(const int* packed, const int* tables, const int* lens,
           int* out_from, int* out_choice, int n_lanes, int n_pos, int C,
           int M, int fb, int pb, int tab_size, int threads, int b,
           int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dp_parse2_kernel<kMaxM, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    dp_parse2_kernel<kMaxM, kSplit><<<n_lanes, threads, smem_bytes, stream>>>(
        packed, tables, lens, out_from, out_choice, n_pos, C, M, fb, pb,
        tab_size, b - 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threads, b and smem_bytes are cuda_parser.dp_parse2_plan's: the launch
// is refused (cudaErrorInvalidValue) unless they are the layout above.
extern "C" int lzt_dp_parse2(const int* packed, const int* tables,
                             const int* lens, int* out_from, int* out_choice,
                             int n_lanes, int n_pos, int C, int M, int fb,
                             int pb, int tab_size, int threads, int b,
                             int smem_bytes, void* stream) {
  if (!plan_ok(C, M, fb, tab_size, threads, b, smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LZT_DP2_ARGS                                                       \
  packed, tables, lens, out_from, out_choice, n_lanes, n_pos, C, M, fb, pb, \
      tab_size, threads, b, smem_bytes, s
  if (M > 4) return launch<kMaxPairs, 1>(LZT_DP2_ARGS);
  if (fb > kSplitFb) return launch<4, 1>(LZT_DP2_ARGS);
  return launch<4, 4>(LZT_DP2_ARGS);
#undef LZT_DP2_ARGS
}
