// Design sweep of the tile backward (csrc/tile_bwd.cuh) on Hopper: the
// shipped queue-merge loop, run with W warps per CTA and the dual read
// either inside the per-tile loop (a dependent random load) or from the
// word-ordered pre-pass (gather_dual). GATHER = 2 is a probe that reads no
// dual at all (every value 1), to show what the dual read costs. Built and
// timed by scripts/torch_tile_bwd_sweep.py; not part of the package.

#include "../wormhole_tpu_torch/ops/csrc/tile_bwd.cuh"

using namespace wh;

namespace {

template <int W>
struct Queues {
  int bucket[W][64];
  float val[W][64];
};

// GATHER: 0 = pre-pass values `dv`, 1 = dual read in the loop, 2 = probe.
template <int W, int GATHER>
__global__ void __launch_bounds__(W * 32)
sweep_bwd(const int32_t* __restrict__ pw, const float* __restrict__ dual,
          const __nv_bfloat16* __restrict__ dv, float* __restrict__ grad,
          int SG, int GS, int C) {
  constexpr int SHIFT = W == 8 ? 11 : (W == 16 ? 10 : 9);
  extern __shared__ float slab[];
  __shared__ Queues<W> q;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int N = GS * C;
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) slab[b] = 0.f;
  __syncthreads();
  int fill = 0;
  for (int g = 0; g < SG; ++g) {
    const long long off = ((long long)t * SG + g) * N;
    for (int c0 = 0; c0 < N; c0 += 32 * UNROLL) {
      int bucket[UNROLL];
      float val[UNROLL];
      bool mine[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        const unsigned word = c < N ? (unsigned)__ldg(pw + off + c) : PAD_WORD;
        bucket[u] = word_bucket(word);
        mine[u] = word_hi(word) < 128u && (bucket[u] >> SHIFT) == warp;
        val[u] = 0.f;
        if (mine[u]) {
          if (GATHER == 0) {
            val[u] = __bfloat162float(dv[off + c]);
          } else if (GATHER == 1) {
            const long long s = (long long)g * GS + c / C;
            val[u] = __bfloat162float(
                load_dual(dual + s * RSUB + word_row(word)));
          } else {
            val[u] = 1.f;
          }
        }
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
        if (fill >= 32) {
          __syncwarp();
          const int b = q.bucket[warp][lane];
          const unsigned grp = __match_any_sync(FULL, b);
          if ((__ffs(grp) - 1) == lane) {
            float acc = slab[b];
            for (unsigned k = grp; k; k &= k - 1u)
              acc += q.val[warp][__ffs(k) - 1];
            slab[b] = acc;
          }
          __syncwarp();
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
  if (fill > 0) {
    const bool live = lane < fill;
    const int b = live ? q.bucket[warp][lane] : -1;
    const unsigned grp = __match_any_sync(FULL, b);
    if (live && (__ffs(grp) - 1) == lane) {
      float acc = slab[b];
      for (unsigned k = grp; k; k &= k - 1u) acc += q.val[warp][__ffs(k) - 1];
      slab[b] = acc;
    }
  }
  __syncthreads();
  float* out = grad + (long long)t * TILE;
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) out[b] = slab[b];
}

template <int W, int GATHER>
int launch(const int32_t* pw, const float* dual, __nv_bfloat16* dv,
           float* grad, int T, int SG, int GS, int C, cudaStream_t st) {
  if (GATHER == 0) {
    const int e = launch_gather_dual(pw, dual, dv, T, SG, GS, C, st);
    if (e != 0) return e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      sweep_bwd<W, GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  sweep_bwd<W, GATHER><<<T, W * 32, BWD_SMEM, st>>>(pw, dual, dv, grad, SG,
                                                    GS, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wh_bwd_sweep(int variant, const int32_t* pw, const float* dual,
                            __nv_bfloat16* dv, float* grad, int T, int SG,
                            int GS, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<8, 1>(pw, dual, dv, grad, T, SG, GS, C, st);
    case 1: return launch<16, 1>(pw, dual, dv, grad, T, SG, GS, C, st);
    case 2: return launch<32, 1>(pw, dual, dv, grad, T, SG, GS, C, st);
    case 3: return launch<16, 2>(pw, dual, dv, grad, T, SG, GS, C, st);
    case 4: return launch<8, 0>(pw, dual, dv, grad, T, SG, GS, C, st);
    case 5: return launch<16, 0>(pw, dual, dv, grad, T, SG, GS, C, st);
    case 6: return launch<32, 0>(pw, dual, dv, grad, T, SG, GS, C, st);
  }
  return -1;
}
