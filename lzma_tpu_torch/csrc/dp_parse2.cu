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
// step.  K3 finalizes node i on thread 0 (a chain of dependent
// shared-memory reads through the history band) between two barriers.
// Here every slot of the future band carries its node's state and rep
// set, written when the edge is relaxed from the already-final source
// node, so:
//   - there is no history band and no finalize: a step reads slot i,
//     which is final, and every thread reads it and looks up node i's
//     flag prices itself;
//   - thread 0 relaxes the literal/shortRep edge into slot i+1 while the
//     other threads relax lengths 2..fb into slots i+2..i+fb (the column
//     sets are disjoint, so no two threads write one slot in a step);
//   - the slot that node i-1 left becomes node i+fb, and the thread of
//     length fb is its first writer in that life, so it writes it whole
//     (the winner or the empty node) and no reset is needed;
//   - one barrier a step, which also covers the prefetch of row i+1 into
//     the second row buffer;
//   - ring indices advance by compare-and-wrap, not `%`.
// Ties break as in K3 and the plain version: pairs m = 0..M-1, then the
// rep0 source, with a strict `<`; the rep index is the first equal of
// r0..r3; shortRep wins only when strictly cheaper.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 0x0FFFFFFF;
constexpr int kMatch = 4;

__device__ __forceinline__ int next_lit(int s) {
  return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
}

__global__ void dp_parse2_kernel(const int* __restrict__ packed,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ lens,
                                 int* __restrict__ out_from,
                                 int* __restrict__ out_choice, int n_pos,
                                 int C, int M, int fb, int pb, int tab_size) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int W = fb - 1, B = fb + 1;
  const int n_ps = 1 << pb;

  int* tab = smem;                 // tab_size
  int* bp = tab + tab_size;        // B: price
  int* bf = bp + B;                // B: from offset (node - from)
  int* bc = bf + B;                // B: choice (distance, -1 literal)
  int* bst = bc + B;               // B: state
  int* brp = bst + B;              // 4B: reps, slot-major
  int* rows = brp + 4 * B;         // 2C: current and next packed row

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

  for (int k = tid; k < tab_size; k += nth) tab[k] = lane_tab[k];
  for (int k = tid; k < B; k += nth) {
    bp[k] = k == 0 ? 0 : kInf;
    bf[k] = 0;
    bc[k] = -1;
    bst[k] = 0;
  }
  for (int k = tid; k < 4 * B; k += nth) brp[k] = 0;
  if (n_pos > 0) {
    for (int k = tid; k < C; k += nth) rows[k] = src[k];
  }
  __syncthreads();

  const int l = tid + 2;           // this thread's relax length
  int s0 = 0;                      // slot of node i
  for (int i = 0; i < n_pos; ++i) {
    const int* row = rows + (i & 1) * C;
    if (i + 1 < n_pos) {
      int* next = rows + ((i + 1) & 1) * C;
      const int* nsrc = src + static_cast<size_t>(i + 1) * C;
      for (int k = tid; k < C; k += nth) next[k] = nsrc[k];
    }
    const int ps = i & (n_ps - 1);
    const bool live = i < len;

    // --- node i is final in its slot: every thread reads it ---
    const int p_i = bp[s0];
    const int st = bst[s0];
    const int r0 = brp[4 * s0], r1 = brp[4 * s0 + 1];
    const int r2 = brp[4 * s0 + 2], r3 = brp[4 * s0 + 3];
    const int f_im1 = im1[ps * 12 + st];
    const int f_ir1 = ir1[st];
    const int rep_head = p_i + f_im1 + f_ir1;

    if (tid == 0) {
      o_from[i] = i - bf[s0];
      o_choice[i] = bc[s0];
      // --- literal / shortRep edge -> slot i+1, state and reps carried ---
      if (live) {
        const int lcost = st >= 7 ? row[6 * M + 1] : row[6 * M];
        const int cand_l = p_i + im0[ps * 12 + st] + lcost;
        const bool sr_ok = row[6 * M + 4] > 0 && r0 == row[6 * M + 2];
        const int cand_sr =
            sr_ok ? rep_head + sel[st] + r0l0[ps * 12 + st] : kInf;
        const bool use_sr = cand_sr < cand_l;
        const int cand1 = use_sr ? cand_sr : cand_l;
        const int s1 = s0 + 1 == B ? 0 : s0 + 1;
        if (cand1 < bp[s1]) {
          bp[s1] = cand1;
          bf[s1] = 1;
          bc[s1] = use_sr ? r0 : -1;
          bst[s1] = use_sr ? (st < 7 ? 9 : 11) : next_lit(st);
          brp[4 * s1] = r0;
          brp[4 * s1 + 1] = r1;
          brp[4 * s1 + 2] = r2;
          brp[4 * s1 + 3] = r3;
        }
      }
    }

    // --- match / rep relax: this thread's length l -> slot i+l ---
    if (l <= fb) {
      int best = kInf, bdist = 0, bkind = kMatch;
      if (live) {
        const int rem = max(len - i, 0);
        const int mbase = p_i + f_im1 + ir0[st];
        const int rb[4] = {rep_head + sel[st] + r0l1[ps * 12 + st],
                           rep_head + sel[12 + st], rep_head + sel[24 + st],
                           rep_head + sel[36 + st]};
        const int reps[4] = {r0, r1, r2, r3};
        const int lps = min(l - 2, 3);
        const int lt_m = ltm[ps * W + l - 2];
        const int lt_r = ltr[ps * W + l - 2];
        for (int m = 0; m < M; ++m) {
          const int ldc = min(row[m], rem);
          const int dd = row[M + m];
          if (ldc < 2 || dd < 0 || l > ldc) continue;
          int rix = -1;
          for (int r = 3; r >= 0; --r) {
            if (dd == reps[r]) rix = r;  // first equal index wins
          }
          const int cost = rix >= 0 ? rb[rix] + lt_r
                                    : mbase + row[2 * M + 4 * m + lps] + lt_m;
          if (cost < best) {
            best = cost;
            bdist = dd;
            bkind = rix >= 0 ? rix : kMatch;
          }
        }
        const int r0p = row[6 * M + 2];
        const int rlc = min(row[6 * M + 3], rem);
        if (r0 == r0p && rlc >= 2 && l <= rlc) {
          const int cost0 = rb[0] + lt_r;
          if (cost0 < best) {
            best = cost0;
            bdist = r0p;
            bkind = 0;
          }
        }
      }
      const int s = s0 + l < B ? s0 + l : s0 + l - B;
      if (best < bp[s] || l == fb) {
        // l == fb: the slot held node i-1 until this step; node i+fb's
        // first writer sets it whole, the empty node where nothing won
        const bool won = best < kInf;
        const bool is_m = bkind == kMatch;
        const int kk = is_m ? 0 : bkind;
        bp[s] = won ? best : kInf;
        bf[s] = won ? l : 0;
        bc[s] = won ? max(bdist, 0) : -1;
        bst[s] = won ? (is_m ? (st < 7 ? 7 : 10) : (st < 7 ? 8 : 11)) : 0;
        brp[4 * s] = won ? bdist : 0;
        brp[4 * s + 1] = won ? ((is_m || kk >= 1) ? r0 : r1) : 0;
        brp[4 * s + 2] = won ? ((is_m || kk >= 2) ? r1 : r2) : 0;
        brp[4 * s + 3] = won ? ((is_m || kk >= 3) ? r2 : r3) : 0;
      }
    }
    s0 = s0 + 1 == B ? 0 : s0 + 1;
    __syncthreads();
  }

  if (tid == 0) {
    o_from[n_pos] = n_pos - bf[s0];
    o_choice[n_pos] = bc[s0];
  }
}

}  // namespace

extern "C" int lzt_dp_parse2(const int* packed, const int* tables,
                             const int* lens, int* out_from, int* out_choice,
                             int n_lanes, int n_pos, int C, int M, int fb,
                             int pb, int tab_size, void* stream) {
  const int threads = ((fb - 1 + 31) / 32) * 32;
  const size_t smem = sizeof(int) * (static_cast<size_t>(tab_size) +
                                     8 * (fb + 1) + 2 * C);
  cudaError_t err = cudaFuncSetAttribute(
      dp_parse2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    dp_parse2_kernel<<<n_lanes, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        packed, tables, lens, out_from, out_choice, n_pos, C, M, fb, pb,
        tab_size);
  }
  return static_cast<int>(cudaGetLastError());
}
