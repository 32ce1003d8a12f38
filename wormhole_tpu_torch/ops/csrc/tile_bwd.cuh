// Device code of the tile backward, shared by tile_bwd.cu (the split
// path's gradient) and tile_step.cu (phase 2 of the fused train step).
//
// For every packed pair word of one crec2 block it computes
//
//     grad[t*16384 + hi*128 + lo] += bf16(dual[s*8192 + rhi*128 + rlo])
//
// accumulated in f32 (the TPU's rounding of the dual: tilemm.py:641, and
// :1228 in the fused kernel). Pad words (hi >= 128) add nothing. The words
// of tile t lie at pw[t, g, :] for g = 0..SG-1, with subblock s = g*GS +
// slot / C, so the kernel never depends on the TPU's `fuse` (K) re-view.
//
// Two launches. gather_dual writes each word's bf16 dual value into a
// word-ordered array `dv` (0 for pad words), one thread per word: the
// random dual reads run at full occupancy there, instead of as a dependent
// load inside the per-tile loop, where they made the kernel latency-bound
// (PERF.md). The per-tile kernel then reads words and values side by side.
//
// Determinism: one CTA owns one tile and keeps its 16384 buckets in a
// 64 KB shared-memory slab. Warp k owns buckets [1024k, 1024k + 1024) and
// walks the tile's words in (group, slot) order; it queues the words it
// owns, in that order, and merges 32 queued words at a time: lanes holding
// the same bucket are merged by __match_any_sync and the group's leader
// adds the values in lane order. So every bucket is summed sequentially in
// word order, with no float atomics, and the same code gives the same bits
// in tile_bwd.cu and in the fused step.

#pragma once

#include "tile_fwd.cuh"

namespace wh {

// 16 warps: with the dual pre-pass, 8 and 16 warps per CTA run the gradient
// alike and 32 slower, since every warp reads all of the tile's words
// (scripts/torch_tile_bwd_sweep.py); 16 give the fused update's FTRL
// epilogue, which streams the w/z/cg planes, twice the threads
constexpr int BWD_WARPS = 16;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_BUCKET_SHIFT = 10;   // TILE / BWD_WARPS = 1024 per warp
constexpr int BWD_SMEM = TILE * (int)sizeof(float);

__device__ __forceinline__ __nv_bfloat16 load_dual(const float* p) {
  return __float2bfloat16_rn(__ldg(p));
}

__device__ __forceinline__ __nv_bfloat16 load_dual(const __nv_bfloat16* p) {
  return *p;
}

// dv[i] = bf16(dual[row of word i]) over all T*SG*N words of pw, 0 for pad
// words. Word i lies in group g = (i / N) % SG, subblock g*GS + (i % N) / C.
template <typename DualT>
__global__ void gather_dual(const int32_t* __restrict__ pw,
                            const DualT* __restrict__ dual,
                            __nv_bfloat16* __restrict__ dv, long long nwords,
                            int SG, int GS, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nwords) return;
  const unsigned word = (unsigned)__ldg(pw + i);
  const long long N = (long long)GS * C;
  __nv_bfloat16 v = __float2bfloat16_rn(0.f);
  if (word_hi(word) < 128u) {
    const long long s = ((i / N) % SG) * GS + (i % N) / C;
    v = load_dual(dual + s * RSUB + word_row(word));
  }
  dv[i] = v;
}

template <typename DualT>
inline int launch_gather_dual(const int32_t* pw, const DualT* dual,
                              __nv_bfloat16* dv, int T, int SG, int GS,
                              int C, cudaStream_t st) {
  const long long nwords = (long long)T * SG * GS * C;
  gather_dual<DualT><<<(unsigned)((nwords + 255) / 256), 256, 0, st>>>(
      pw, dual, dv, nwords, SG, GS, C);
  return (int)cudaGetLastError();
}

constexpr int BWD_QUEUE = 64;          // per-warp queue of owned words

// Per-warp queues in shared memory: each warp appends the (bucket, value)
// of the words it owns, in word order, and merges them 32 at a time.
struct BwdQueues {
  int bucket[BWD_WARPS][BWD_QUEUE];
  float val[BWD_WARPS][BWD_QUEUE];
};

// Add the queue's first n (<= 32) entries into the slab: lanes holding the
// same bucket are merged by __match_any_sync and the group's leader adds
// the values in lane (= word) order.
__device__ __forceinline__ void bwd_flush(BwdQueues& q, int warp, int lane,
                                          int n, float* slab) {
  const bool live = lane < n;
  const int b = live ? q.bucket[warp][lane] : -1;
  const unsigned grp = __match_any_sync(FULL, b);
  if (live && (__ffs(grp) - 1) == lane) {
    float acc = slab[b];
    for (unsigned m = grp; m; m &= m - 1u) acc += q.val[warp][__ffs(m) - 1];
    slab[b] = acc;
  }
  __syncwarp();
}

// Accumulate tile t's gradient into `slab` (TILE floats of shared memory)
// from the words and their gathered values `dv`. A warp walks all of the
// tile's words but queues only the ones it owns (ballot + popcount, in word
// order) and runs the match-and-add once per 32 queued words, so the merge
// work is per owned word, not per word read. Ends with a __syncthreads, so
// the slab is complete for every thread.
__device__ __forceinline__ void bwd_tile_slab(
    const int32_t* __restrict__ pw, const __nv_bfloat16* __restrict__ dv,
    int t, int SG, int GS, int C, float* slab, BwdQueues& q) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int N = GS * C;
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) slab[b] = 0.f;
  __syncthreads();
  int fill = 0;                                     // warp-uniform
  for (int g = 0; g < SG; ++g) {
    const long long off = ((long long)t * SG + g) * N;
    const int32_t* seg = pw + off;
    const __nv_bfloat16* vseg = dv + off;
    for (int c0 = 0; c0 < N; c0 += 32 * UNROLL) {
      int bucket[UNROLL];
      float val[UNROLL];
      bool mine[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        const unsigned word = c < N ? (unsigned)__ldg(seg + c) : PAD_WORD;
        bucket[u] = word_bucket(word);
        mine[u] = word_hi(word) < 128u &&
                  (bucket[u] >> BWD_BUCKET_SHIFT) == warp;
        val[u] = mine[u] ? __bfloat162float(vseg[c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned m = __ballot_sync(FULL, mine[u]);
        if (mine[u]) {
          const int pos = fill + __popc(m & lanes_below);
          q.bucket[warp][pos] = bucket[u];
          q.val[warp][pos] = val[u];
        }
        fill += __popc(m);
        if (fill >= 32) {                           // warp-uniform
          __syncwarp();
          bwd_flush(q, warp, lane, 32, slab);
          // move the tail (fill - 32 < 32 entries) to the queue's front
          int b_tail = 0;
          float v_tail = 0.f;
          if (lane < fill - 32) {
            b_tail = q.bucket[warp][32 + lane];
            v_tail = q.val[warp][32 + lane];
          }
          __syncwarp();
          if (lane < fill - 32) {
            q.bucket[warp][lane] = b_tail;
            q.val[warp][lane] = v_tail;
          }
          __syncwarp();
          fill -= 32;
        }
      }
    }
  }
  __syncwarp();
  if (fill > 0) bwd_flush(q, warp, lane, fill, slab);
  __syncthreads();
}

// grad (T*16384,) f32: one CTA per tile, its slab written out.
__global__ void __launch_bounds__(BWD_THREADS)
tile_bwd_grad(const int32_t* __restrict__ pw,
              const __nv_bfloat16* __restrict__ dv, float* __restrict__ grad,
              int SG, int GS, int C) {
  extern __shared__ float slab[];
  __shared__ BwdQueues q;
  const int t = blockIdx.x;
  bwd_tile_slab(pw, dv, t, SG, GS, C, slab, q);
  float* out = grad + (long long)t * TILE;
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) out[b] = slab[b];
}

// Launch gather_dual and tile_bwd_grad on `st` (dv is scratch of one bf16
// per word); returns cudaGetLastError() after each launch.
template <typename DualT>
inline int launch_bwd_grad(const int32_t* pw, const DualT* dual,
                           __nv_bfloat16* dv, float* grad, int T, int SG,
                           int GS, int C, cudaStream_t st) {
  int e = launch_gather_dual(pw, dual, dv, T, SG, GS, C, st);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      tile_bwd_grad, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  tile_bwd_grad<<<T, BWD_THREADS, BWD_SMEM, st>>>(pw, dv, grad, SG, GS, C);
  return (int)cudaGetLastError();
}

}  // namespace wh
