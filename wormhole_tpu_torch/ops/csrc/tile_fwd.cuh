// Device code of the tile forward margins, shared by tile_fwd.cu (the
// forward alone) and tile_step.cu (the forward as phase 1 of a train step).
//
// For every packed pair word of one crec2 block it computes
//
//     margin[s*8192 + rhi*128 + rlo] += bf16(w[t*16384 + hi*128 + lo])
//
// accumulated in f32, where word fields are lo = bits 0..6, hi = 7..15,
// rlo = 16..22, rhi = 23..28, and words with hi >= 128 (the pad word
// 511 << 7) add nothing. w is rounded to bf16 round-to-nearest-even, as the
// TPU kernel's operand is (wormhole_tpu/ops/tilemm.py `_build_fwd` :581).
//
// Determinism ("partial slabs", no float atomics):
//   pass 1 (tile_fwd_partial): one CTA per (subblock, chunk of
//     tiles_per_chunk tiles) keeps a private 8192-row slab in shared
//     memory. Warp k owns rows [k*1024, (k+1)*1024) and walks the chunk's
//     words in (tile, slot) order, 32 lanes at a time; lanes holding the
//     same row are merged by __match_any_sync and the group's leader adds
//     the values in lane order. Only the owning warp ever touches a row, so
//     each row is summed sequentially in word order. The slab is written to
//     `partial`.
//   pass 2 (fwd_combine_row): one thread per row sums its chunk slabs in
//     chunk order.
// The result is the same bits on every run.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wh {

constexpr int TILE = 16384;          // buckets per tile (128 x 128)
constexpr int RSUB = 8192;           // rows per subblock (64 x 128)
constexpr int FWD_WARPS = 8;         // warps per pass-1 CTA
constexpr int FWD_ROW_SHIFT = 10;    // RSUB / FWD_WARPS = 1024 rows per warp
constexpr int UNROLL = 8;            // 32-word batches in flight per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PAD_WORD = 511u << 7;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int word_row(unsigned word) {
  return (int)((((word >> 23) & 63u) << 7) | ((word >> 16) & 127u));
}

__device__ __forceinline__ unsigned word_hi(unsigned word) {
  return (word >> 7) & 511u;
}

__device__ __forceinline__ int word_bucket(unsigned word) {
  return (int)((word_hi(word) << 7) | (word & 127u));
}

__global__ void __launch_bounds__(FWD_WARPS * 32)
tile_fwd_partial(const int32_t* __restrict__ pw, const float* __restrict__ w,
                 float* __restrict__ partial, int T, int SG, int GS, int C,
                 int tiles_per_chunk, int nchunk) {
  __shared__ float slab[RSUB];
  __shared__ float stage[FWD_WARPS][32];
  const int chunk = blockIdx.x;
  const int s = blockIdx.y;
  const int g = s / GS, j = s % GS;
  const long long N = (long long)GS * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r = threadIdx.x; r < RSUB; r += blockDim.x) slab[r] = 0.f;
  __syncthreads();

  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(T, t0 + tiles_per_chunk);
  for (int t = t0; t < t1; ++t) {
    const int32_t* seg = pw + ((long long)t * SG + g) * N + (long long)j * C;
    const float* wt = w + (long long)t * TILE;
    for (int c0 = 0; c0 < C; c0 += 32 * UNROLL) {
      int row[UNROLL];
      float val[UNROLL];
      bool mine[UNROLL];
      // issue every load of the batch before any use: UNROLL gathers in
      // flight per warp hide the L2 latency of w
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        const unsigned word = c < C ? (unsigned)__ldg(seg + c) : PAD_WORD;
        row[u] = word_row(word);
        mine[u] = word_hi(word) < 128u && (row[u] >> FWD_ROW_SHIFT) == warp;
        val[u] = mine[u] ? __ldg(wt + word_bucket(word)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (__ballot_sync(FULL, mine[u]) == 0u) continue;   // warp-uniform
        const unsigned grp = __match_any_sync(FULL, mine[u] ? row[u] : -1);
        stage[warp][lane] = bf16_round(val[u]);
        __syncwarp();
        if (mine[u] && (__ffs(grp) - 1) == lane) {
          float acc = slab[row[u]];
          for (unsigned m = grp; m; m &= m - 1u)
            acc += stage[warp][__ffs(m) - 1];
          slab[row[u]] = acc;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* out = partial + ((long long)s * nchunk + chunk) * RSUB;
  for (int r = threadIdx.x; r < RSUB; r += blockDim.x) out[r] = slab[r];
}

// Pass 2 for one block row i (subblock i / 8192): its chunk slabs summed in
// chunk order.
__device__ __forceinline__ float fwd_combine_row(
    const float* __restrict__ partial, long long i, int nchunk) {
  const long long s = i / RSUB, r = i % RSUB;
  const float* p = partial + s * nchunk * RSUB + r;
  float acc = 0.f;
  for (int c = 0; c < nchunk; ++c) acc += p[(long long)c * RSUB];
  return acc;
}

// Launch pass 1 on `st`; returns cudaGetLastError() (0 = success).
inline int launch_fwd_partial(const int32_t* pw, const float* w,
                              float* partial, int T, int SG, int GS, int C,
                              int tiles_per_chunk, cudaStream_t st) {
  const int nchunk = (T + tiles_per_chunk - 1) / tiles_per_chunk;
  tile_fwd_partial<<<dim3(nchunk, SG * GS), FWD_WARPS * 32, 0, st>>>(
      pw, w, partial, T, SG, GS, C, tiles_per_chunk, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace wh
