// Adaptive binary range encoder over per-lane (ctx, bit) streams.
//
// Replaces the TPU kernel lzma_tpu/ops/pallas_serializer.py
// serialize_pallas (its pl.pallas_call): the same contract as the plain
// version lzma_tpu_torch/ops/device_encoder.py serialize -- identical
// bytes and lengths -- without the TPU's workarounds (packed probability
// pairs, one-hot gathers, DMA tiles, the staging ring).  The body is the
// reference's shiftLow coder (RangeEncoder.java:73-87, RangeEnc in
// lzma_tpu/runtime/src/lzma_core.cpp): a 64-bit `low` with cache and
// cache_size, so the carry flag and drain counter of the lane-parallel
// version go away and bytes go straight into the lane's output row.
//
// What bounds it on this card: each lane is one dependent chain (one
// probability read-modify-write and a compare per bit), so a lane's time
// is the latency of a bit, not its bytes, and a lane is one thread.  On
// an H100 80GB HBM3 (700 W, the main path's 32 lanes, 960,434 pairs in
// the longest) the first version took ~150 ns a pair with the uint16
// arena and each pair loaded from device memory on the chain; with both
// in shared memory ~120 ns, which the generated code explained: a
// branch a kind of step, the shared window's base recomputed (an S2R)
// on every pair, and each just-loaded value moved between registers at
// once.  This design:
//   - keeps the arena in shared memory when it fits beside the tiles
//     (kShared; 14.6 KB at lc3, up to lc + lp = 7 under the card's
//     227 KB), else in device memory; the wrapper picks the placement
//     from the arena's size and the card's opt-in limit
//     (cuda_serializer.arena_placement) and the kernel never takes the
//     other one; all 32 threads of the block initialise it;
//   - stages the (ctx, bit) pairs by tiles of kTile pairs into shared
//     memory, double-buffered, by 4-byte cp.async from the whole warp (a
//     lane's base, lane * n_bits * 4 bytes, is not 16-byte aligned for
//     every n_bits): one wait a tile, issued a tile ahead, while thread 0
//     codes the current tile;
//   - loads pair j+1's probability before pair j's store (taking pair
//     j's value when both share a slot) and pair j+2's ctx and bit, so
//     the loads overlap the coder's arithmetic;
//   - codes a step without branches but the renormalisation, holds the
//     shared base in a register (read once through a volatile load) and
//     unrolls the loop so that the values rotate without moves.
// That is ~50 ns a pair.  Output bytes are direct stores, off the chain.
//
// ctx >= 0: adaptive bit at that arena slot; ctx == -1: direct bit; any
// other ctx inside `totals` consumes a step and codes nothing.  A lane
// whose output would pass max_out reports consumed = -1; its bytes past
// max_out overwrite the last byte of its row, as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTileLog = 10;
constexpr int kTile = 1 << kTileLog;  // pairs a tile (cuda_serializer.TILE)

struct Enc {
  uint64_t low;
  uint32_t range;
  uint32_t cache;
  uint32_t cache_size;
  int pos;
  bool overflow;
  uint8_t* out;
  int max_out;

  // Bytes past max_out all land on the row's last byte, as in the plain
  // version (its write index is clamped to max_out - 1).
  __device__ void put(uint32_t byte) {
    if (pos >= max_out) overflow = true;
    if (max_out > 0) {
      out[pos < max_out ? pos : max_out - 1] = static_cast<uint8_t>(byte);
    }
    ++pos;
  }

  __device__ void shift_low() {
    if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
      const uint32_t carry = static_cast<uint32_t>(low >> 32);
      uint32_t temp = cache;
      do {
        put((temp + carry) & 0xFFu);
        temp = 0xFFu;
      } while (--cache_size != 0);
      cache = static_cast<uint32_t>(low >> 24) & 0xFFu;
    }
    ++cache_size;
    low = (low & 0x00FFFFFFull) << 8;
  }

  // One step without branches but the renormalisation: c >= 0 an
  // adaptive bit with probability pr, c == -1 a direct bit, else nothing.
  // Returns pr updated for bit b (meaningful when c >= 0).
  __device__ __forceinline__ uint32_t step(int c, int b, uint32_t pr) {
    const bool adaptive = c >= 0, direct = c == -1, one = b != 0;
    const uint32_t bound = (range >> 11) * pr;
    const uint32_t half = range >> 1;
    low += adaptive ? (one ? bound : 0u) : (direct && b == 1 ? half : 0u);
    range = adaptive ? (one ? range - bound : bound) : (direct ? half : range);
    if (range < (1u << 24)) {
      range <<= 8;
      shift_low();
    }
    return one ? pr - (pr >> 5) : pr + ((2048u - pr) >> 5);
  }
};

// The uint16 arena: in shared memory, addressed by a 32-bit shared
// address held in a register (the loads and stores keep program order),
// or in device memory.
template <bool kShared>
struct Arena;

template <>
struct Arena<true> {
  uint32_t base;
  __device__ __forceinline__ uint32_t load(int c) const {
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(base + 2u * c));
    return v;
  }
  __device__ __forceinline__ void store(int c, uint32_t v) const {
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(base + 2u * c),
                 "h"(static_cast<uint16_t>(v)));
  }
};

template <>
struct Arena<false> {
  uint16_t* p;
  __device__ __forceinline__ uint32_t load(int c) const { return p[c]; }
  __device__ __forceinline__ void store(int c, uint32_t v) const {
    p[c] = static_cast<uint16_t>(v);
  }
};

__device__ __forceinline__ int lds32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void async4(uint32_t dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Pairs [t * kTile, min((t + 1) * kTile, n)) of the lane: ctx into the
// tile's first kTile ints at shared address buf, bits into the next
// kTile; one group a thread.
__device__ __forceinline__ void stage_tile(uint32_t buf, const int* cx,
                                           const int* bt, int t, int n,
                                           int tid) {
  const int first = t << kTileLog;
  const int cnt = min(kTile, n - first);
  for (int k = tid; k < cnt; k += kThreads) {
    async4(buf + 4u * k, cx + first + k);
    async4(buf + 4u * (kTile + k), bt + first + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    rc_serialize_kernel(const int* __restrict__ ctx,
                        const int* __restrict__ bits,
                        const int* __restrict__ totals,
                        uint16_t* __restrict__ probs,
                        uint8_t* __restrict__ out, int* __restrict__ lens,
                        int* __restrict__ consumed, int n_bits,
                        int arena_size, int max_out) {
  extern __shared__ __align__(16) int smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  // two tiles of 2 kTile ints, then the arena where it is shared.  The
  // tiles' shared address passes once through the first word of the
  // tiles and a volatile shared load (before any tile lands there), so
  // that the compiler keeps it in a register: left alone it recomputes
  // it (an S2R of the CTA's shared window) on every pair.
  const uint32_t first = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (tid == 0) smem[0] = static_cast<int>(first);
  __syncwarp();
  uint32_t tiles;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(tiles) : "r"(first));
  __syncwarp();
  uint16_t* p = kShared ? reinterpret_cast<uint16_t*>(smem + 4 * kTile)
                        : probs + static_cast<size_t>(lane) * arena_size;
  Arena<kShared> arena;
  if constexpr (kShared) {
    arena.base = tiles + 4u * 4 * kTile;
  } else {
    arena.p = p;
  }
  const int* cx = ctx + static_cast<size_t>(lane) * n_bits;
  const int* bt = bits + static_cast<size_t>(lane) * n_bits;
  const int total = totals[lane];
  // pairs read from the rows; past n_bits the last pair repeats, as the
  // plain version clamps its index
  const int n_rows = min(total, n_bits);
  const int n_tiles = (n_rows + kTile - 1) >> kTileLog;

  if (n_tiles > 0) stage_tile(tiles, cx, bt, 0, n_rows, tid);
  for (int k = tid; k < arena_size; k += kThreads) p[k] = 1024;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  Enc e{0, 0xFFFFFFFFu, 0, 1, 0, false,
        out + static_cast<size_t>(lane) * max_out, max_out};
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_tile(tiles + 4u * 2 * kTile * ((t + 1) & 1), cx, bt, t + 1,
                 n_rows, tid);
    }
    if (tid == 0) {
      const uint32_t sc = tiles + 4u * 2 * kTile * (t & 1);
      const uint32_t sb = sc + 4u * kTile;
      const int n = min(kTile, n_rows - (t << kTileLog));
      // pair j codes while pair j+1's probability and pair j+2 load;
      // the probability is read before pair j's store and takes its
      // value when both pairs share a slot
      int c = lds32(sc), b = lds32(sb);
      const int j1 = min(1, n - 1);
      int cn = lds32(sc + 4u * j1), bn = lds32(sb + 4u * j1);
      uint32_t pr = arena.load(max(c, 0));
      // unrolled, so that the values rotate through registers without
      // moves, a move of a just-loaded value being a wait for the load
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int j2 = min(j + 2, n - 1);
        const int c2 = lds32(sc + 4u * j2), b2 = lds32(sb + 4u * j2);
        uint32_t prn = arena.load(max(cn, 0));
        const uint32_t upd = e.step(c, b, pr);
        if (c >= 0) {
          arena.store(c, upd);
          if (cn == c) prn = upd;
        }
        c = cn;
        b = bn;
        cn = c2;
        bn = b2;
        pr = prn;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }
  if (tid != 0) return;
  if (total > n_rows && n_bits > 0) {
    const int c = cx[n_bits - 1], b = bt[n_bits - 1];
    for (int i = n_rows; i < total; ++i) {
      const uint32_t upd = e.step(c, b, arena.load(max(c, 0)));
      if (c >= 0) arena.store(c, upd);
    }
  }
  for (int k = 0; k < 5; ++k) e.shift_low();
  lens[lane] = e.pos;
  consumed[lane] = e.overflow ? -1 : total;
}

template <bool kShared>
int launch(const int* ctx, const int* bits, const int* totals,
           uint16_t* probs, uint8_t* out, int* lens, int* consumed,
           int n_lanes, int n_bits, int arena_size, int max_out,
           int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rc_serialize_kernel<kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes > 0) {
    rc_serialize_kernel<kShared><<<n_lanes, kThreads, smem_bytes,
                                         stream>>>(
        ctx, bits, totals, probs, out, lens, consumed, n_bits, arena_size,
        max_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shared != 0 puts the arena in shared memory (probs unused), else in
// `probs` (n_lanes x arena_size uint16).  smem_bytes is
// cuda_serializer.smem_bytes's: the launch is refused
// (cudaErrorInvalidValue) unless it is the layout above.
extern "C" int lzt_rc_serialize(const int* ctx, const int* bits,
                                const int* totals, uint16_t* probs,
                                uint8_t* out, int* lens, int* consumed,
                                int n_lanes, int n_bits, int arena_size,
                                int max_out, int shared, int smem_bytes,
                                void* stream) {
  const long long tiles = 4LL * 4 * kTile;
  const long long need =
      tiles + (shared ? (2LL * arena_size + 15) / 16 * 16 : 0);
  if (need != smem_bytes || (!shared && probs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared ? launch<true>(ctx, bits, totals, probs, out, lens, consumed,
                               n_lanes, n_bits, arena_size, max_out,
                               smem_bytes, s)
                : launch<false>(ctx, bits, totals, probs, out, lens,
                                consumed, n_lanes, n_bits, arena_size,
                                max_out, smem_bytes, s);
}
