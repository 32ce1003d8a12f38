// Elementwise train-step math shared by every kernel that needs it: the four
// loss duals with the zero-dual nudge, and the FTRL slot update with its
// per-bin weight-delta sum.
//
// The fused step (tile_step.cu) runs this math inside its phases and the
// split path runs it through the small elementwise launches wh_loss_dual and
// wh_ftrl_push, so both paths execute the same device functions. The build
// passes --fmad=false (ops/_ext.py): no multiply-add is ever contracted into
// an FMA, so every product is rounded to f32 before its add, in every kernel
// that includes this file. That is what the JAX package's `opaque_one`
// guards pin for Mosaic and XLA (wormhole_tpu/ops/loss.py:22), and what
// keeps fused and split bitwise equal.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wh {

// loss ids, in the order of wormhole_tpu_torch/ops/loss.py LOSS_IDS
enum Loss { LOGIT = 0, HINGE = 1, SQUARE_HINGE = 2, SQUARE = 3 };

// d objv / d margin for one row (wormhole_tpu/ops/loss.py:44-92): labels are
// 0/1 floats mapped to y in {-1, +1}, mask is the row weight (0 for pads).
__device__ __forceinline__ float loss_dual(int loss, float m, float lab,
                                           float msk) {
  const float y = lab > 0.5f ? 1.f : -1.f;
  switch (loss) {
    case LOGIT: {
      const float x = -y * m;                       // σ(-y·m)
      const float sig = 1.f / (1.f + expf(-x));
      return -y * sig * msk;
    }
    case HINGE: {
      const float active = (1.f - y * m > 0.f) ? 1.f : 0.f;
      return -y * active * msk;
    }
    case SQUARE_HINGE: {
      const float t = fmaxf(1.f - y * m, 0.f);
      return -2.f * y * t * msk;
    }
    default:                                        // SQUARE
      return (m - lab) * msk;
  }
}

// The zero-dual nudge (wormhole_tpu/learners/store.py:117): an exactly-zero
// dual of a real row becomes a signed 1e-30 so the row still touches its
// buckets. Applied when the handle is not exact-dense.
__device__ __forceinline__ float nudge_zero_dual(float d, float lab,
                                                 float msk) {
  if (d == 0.f && msk > 0.f) return lab > 0.5f ? -1e-30f : 1e-30f;
  return d;
}

struct Ftrl {
  float alpha, beta, lambda1, lambda2;
};

// FTRLHandle.update (wormhole_tpu/learners/handles.py:108) on one bucket:
// cg' = sqrt(cg² + g²); σ = (cg' - cg)/α; z' = (z + g) - σ·w;
// w' = prox(-z', (β + cg')/α) with the L1L2 shrink (penalty.py solve).
__device__ __forceinline__ void ftrl_update(const Ftrl& p, float w, float z,
                                            float cg, float g, float* w_new,
                                            float* z_new, float* cg_new) {
  const float c = sqrtf(cg * cg + g * g);
  const float sigma = (c - cg) / p.alpha;
  const float zn = (z + g) - sigma * w;
  const float v = -zn;
  const float mag = fmaxf(fabsf(v) - p.lambda1, 0.f);
  const float shrunk = v > 0.f ? mag : (v < 0.f ? -mag : 0.f);
  const float eta = (p.beta + c) / p.alpha;
  *w_new = shrunk / (eta + p.lambda2);
  *z_new = zn;
  *cg_new = c;
}

// The FTRL update of one bin of n buckets, in place on its w/z/cg plane
// slices, from the bin's gradient (shared memory in the fused step, device
// memory in the split push: the same loop either way), by one warp: lane l
// takes buckets l, l + 32, ..., loading four of them before it updates
// them, so a lane has four buckets' plane reads in flight. Writes the bin's
// Σ(w' - w)² to *wdelta2_out: each lane adds its buckets' terms in bucket
// order, and the lanes' sums are added by one butterfly, so both paths
// round alike.
__device__ __forceinline__ void ftrl_warp(const Ftrl& p,
                                          const float* __restrict__ grad,
                                          float* __restrict__ w,
                                          float* __restrict__ z,
                                          float* __restrict__ cg,
                                          float* wdelta2_out, int n) {
  constexpr int B = 4;                             // buckets in flight
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int b0 = lane; b0 < n; b0 += 32 * B) {
    float w0[B], z0[B], c0[B], g0[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int b = b0 + 32 * u;
      if (b < n) {
        w0[u] = w[b];
        z0[u] = z[b];
        c0[u] = cg[b];
        g0[u] = grad[b];
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int b = b0 + 32 * u;
      if (b < n) {
        float wn, zn, cn;
        ftrl_update(p, w0[u], z0[u], c0[u], g0[u], &wn, &zn, &cn);
        w[b] = wn;
        z[b] = zn;
        cg[b] = cn;
        const float d = wn - w0[u];
        acc += d * d;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) *wdelta2_out = acc;
}

}  // namespace wh
