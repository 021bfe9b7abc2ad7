// The DP scans' packed rows staged into shared memory by tiles (K3
// dp_parse.cu, K4 dp_parse2.cu).
//
// A lane's rows (device_parser.dp_inputs: C int32 a position) are copied
// a tile of kTile rows at a time into one of two buffers, by 4-byte
// cp.async: a lane's base, lane * n_pos * C * 4 bytes, is not 16-byte
// aligned for every n_pos, and nothing is read past the lane.  A scan
// issues tile t + 1 at the first step of tile t and waits once a tile,
// before the barrier of the step whose successor first reads it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 6;
constexpr int kTile = 1 << kTileLog;  // rows a tile (cuda_parser.TILE_ROWS)

__device__ __forceinline__ void async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [t * kTile, min((t + 1) * kTile, n_pos)) of the lane into `buf`,
// one group of 4-byte copies a thread.
__device__ __forceinline__ void stage_tile(int* buf, const int* src, int t,
                                           int n_pos, int C, int tid,
                                           int nth) {
  const int first = t << kTileLog;
  const int n = min(kTile, n_pos - first) * C;
  const int* s = src + static_cast<size_t>(first) * C;
  for (int k = tid; k < n; k += nth) async4(buf + k, s + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace
