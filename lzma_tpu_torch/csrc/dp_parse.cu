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
// 32 lanes x 256 KiB) take ~0.3 ms at 3.35 TB/s and the arithmetic less;
// the chain's latency, a few hundred cycles a step, is what the time is
// made of.  The design keeps that chain in shared memory and registers:
//   - one CTA per lane; threads own relax lengths l = 2..fb (one warp at
//     fb 32, W rounded up to 32 lanes of threads);
//   - the future band (price, from offset, choice, kind of nodes
//     i..i+fb) and the history band (state, reps of nodes i-1..i-fb) are
//     ring buffers in shared memory indexed by node mod B / mod H, so the
//     band never moves;
//   - the lane's price tables are copied into shared memory once;
//   - the next position's row is prefetched into a second row buffer
//     while the current one is relaxed.
// A step is: thread 0 finalizes node i (state, reps, emits (i - from,
// choice), relaxes the literal/shortRep edge to i+1 and retires slot i);
// barrier; each thread relaxes its length over the M pairs and then the
// rep0 source with a strict < (the first source wins a tie); barrier.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 0x0FFFFFFF;
constexpr int kLit = -1;
constexpr int kMatch = 4;
constexpr int kShortRep = 5;

__device__ __forceinline__ int next_lit(int s) {
  return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);
}

__global__ void dp_parse_kernel(const int* __restrict__ packed,
                                const int* __restrict__ tables,
                                const int* __restrict__ lens,
                                int* __restrict__ out_from,
                                int* __restrict__ out_choice, int n_pos,
                                int C, int M, int fb, int pb, int tab_size) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int W = fb - 1, B = fb + 1, H = fb;
  const int n_ps = 1 << pb;

  int* tab = smem;                 // tab_size
  int* bp = tab + tab_size;        // B: price
  int* bf = bp + B;                // B: from offset (i - from)
  int* bc = bf + B;                // B: choice (distance, -1 literal)
  int* bk = bc + B;                // B: kind
  int* hst = bk + B;               // H: state
  int* hrp = hst + H;              // 4H: reps
  int* rows = hrp + 4 * H;         // 2C: current and next packed row
  int* sh = rows + 2 * C;          // per-step values of node i

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
    bk[k] = kLit;
  }
  for (int k = tid; k < 5 * H; k += nth) hst[k] = 0;  // hst and hrp
  if (n_pos > 0) {
    for (int k = tid; k < C; k += nth) rows[k] = src[k];
  }
  __syncthreads();

  for (int i = 0; i < n_pos; ++i) {
    const int* row = rows + (i & 1) * C;
    if (i + 1 < n_pos) {
      int* next = rows + ((i + 1) & 1) * C;
      const int* nsrc = src + static_cast<size_t>(i + 1) * C;
      for (int k = tid; k < C; k += nth) next[k] = nsrc[k];
    }
    const int ps = i & (n_ps - 1);
    const bool live = i < len;

    if (tid == 0) {
      // --- finalize node i from its predecessor ---
      const int s0 = i % B;
      const int p_i = bp[s0], d_i = bf[s0], c_i = bc[s0], k_i = bk[s0];
      const int h = min(max(d_i - 1, 0), H - 1);
      int hs = (i - 1 - h) % H;
      if (hs < 0) hs += H;
      const int st_prev = hst[hs];
      const int* rp = hrp + 4 * hs;
      const bool is_rep = k_i >= 0 && k_i < 4;
      const bool is_m = k_i == kMatch;
      int st;
      if (k_i == kLit) {
        st = next_lit(st_prev);
      } else if (k_i == kShortRep) {
        st = st_prev < 7 ? 9 : 11;
      } else if (is_rep) {
        st = st_prev < 7 ? 8 : 11;
      } else {
        st = st_prev < 7 ? 7 : 10;
      }
      const int kk = min(max(k_i, 0), 3);
      int r0 = is_rep ? rp[kk] : (is_m ? c_i : rp[0]);
      int r1 = ((is_rep && kk >= 1) || is_m) ? rp[0] : rp[1];
      int r2 = ((is_rep && kk >= 2) || is_m) ? rp[1] : rp[2];
      int r3 = ((is_rep && kk >= 3) || is_m) ? rp[2] : rp[3];
      if (i == 0) st = r0 = r1 = r2 = r3 = 0;
      o_from[i] = i - d_i;
      o_choice[i] = c_i;

      const int f_im1 = im1[ps * 12 + st];
      const int f_ir1 = ir1[st];
      const int sel0 = sel[st];

      // --- literal / shortRep edge -> node i+1 ---
      if (live) {
        const int lcost = st >= 7 ? row[6 * M + 1] : row[6 * M];
        const int cand_l = p_i + im0[ps * 12 + st] + lcost;
        const bool sr_ok = row[6 * M + 4] > 0 && r0 == row[6 * M + 2];
        const int cand_sr =
            sr_ok ? p_i + f_im1 + f_ir1 + sel0 + r0l0[ps * 12 + st] : kInf;
        const bool use_sr = cand_sr < cand_l;
        const int cand1 = use_sr ? cand_sr : cand_l;
        const int s1 = (i + 1) % B;
        if (cand1 < bp[s1]) {
          bp[s1] = cand1;
          bf[s1] = 1;
          bc[s1] = use_sr ? r0 : -1;
          bk[s1] = use_sr ? kShortRep : kLit;
        }
      }

      // what the relax threads need from node i
      const int rep_head = p_i + f_im1 + f_ir1;
      sh[0] = p_i + f_im1 + ir0[st];                  // match base
      sh[1] = rep_head + sel0 + r0l1[ps * 12 + st];   // rep0 base
      sh[2] = rep_head + sel[12 + st];
      sh[3] = rep_head + sel[24 + st];
      sh[4] = rep_head + sel[36 + st];
      sh[5] = r0;
      sh[6] = r1;
      sh[7] = r2;
      sh[8] = r3;

      // --- node i enters the history, its slot becomes node i+B ---
      const int hw = i % H;
      hst[hw] = st;
      hrp[4 * hw] = r0;
      hrp[4 * hw + 1] = r1;
      hrp[4 * hw + 2] = r2;
      hrp[4 * hw + 3] = r3;
      bp[s0] = kInf;
      bf[s0] = 0;
      bc[s0] = -1;
      bk[s0] = kLit;
    }
    __syncthreads();

    // --- match / rep relax: this thread's length l -> node i+l ---
    const int l = tid + 2;
    if (live && l <= fb) {
      const int rem = max(len - i, 0);
      const int mbase = sh[0];
      const int rb[4] = {sh[1], sh[2], sh[3], sh[4]};
      const int reps[4] = {sh[5], sh[6], sh[7], sh[8]};
      const int lps = min(l - 2, 3);
      const int lt_m = ltm[ps * W + l - 2];
      const int lt_r = ltr[ps * W + l - 2];
      int best = kInf, bdist = 0, bkind = kMatch;
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
      if (reps[0] == r0p && rlc >= 2 && l <= rlc) {
        const int cost0 = rb[0] + lt_r;
        if (cost0 < best) {
          best = cost0;
          bdist = r0p;
          bkind = 0;
        }
      }
      const int s = (i + l) % B;
      if (best < bp[s]) {
        bp[s] = best;
        bf[s] = l;
        bc[s] = max(bdist, 0);
        bk[s] = bkind;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    const int s = n_pos % B;
    o_from[n_pos] = n_pos - bf[s];
    o_choice[n_pos] = bc[s];
  }
}

}  // namespace

extern "C" int lzt_dp_parse(const int* packed, const int* tables,
                            const int* lens, int* out_from, int* out_choice,
                            int n_lanes, int n_pos, int C, int M, int fb,
                            int pb, int tab_size, void* stream) {
  const int threads = ((fb - 1 + 31) / 32) * 32;
  const size_t smem = sizeof(int) * (static_cast<size_t>(tab_size) +
                                     4 * (fb + 1) + 5 * fb + 2 * C + 16);
  cudaError_t err = cudaFuncSetAttribute(
      dp_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    dp_parse_kernel<<<n_lanes, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        packed, tables, lens, out_from, out_choice, n_pos, C, M, fb, pb,
        tab_size);
  }
  return static_cast<int>(cudaGetLastError());
}
