// The wide&deep step's MLP boundary on Hopper (sm_90a): row-tile CTAs that
// keep every activation and cotangent in shared memory.
//
// Replaces the boundary phase (`_mlp`, wormhole_tpu/ops/tilemm.py:1622-1652)
// of `_make_wd_step_kernel` (:1590): from the (rows, 1+k) f32 pulls [w,
// pooled_1..k] it computes margin = w + MLP(pooled), the loss dual, the push
// rows [dual, g_pooled_1..k, mask] and the MLP's parameter gradients. The TPU
// ran it in VMEM; here one CTA owns a span of consecutive rows (the caller's
// `span`, tilemm.WD_SPAN_ROWS) and walks it R rows at a time (R = 32·TR),
// so nothing but the pulls, the labels and mask, the margins, the push rows
// and one partial per span touches device memory:
//
//   1. the packed weights [W0, b0, W1, b1, ...] go to shared memory once per
//      CTA, and the span's parameter-gradient sums start at 0.f there (each
//      where it fits beside the tile; otherwise the weights are read through
//      L1 and the sums kept in the span's row of device memory);
//   2. per tile of R rows: the pulls, coalesced, into column-major shared
//      buffers [col][R+4] (the pad of 4 floats puts 8 consecutive columns in
//      8 different 16-byte bank groups);
//   3. the forward, layer by layer: thread (lane, warp) owns TR consecutive
//      rows × TC columns and sums z[b] = ((0 + h_0·W[0,b]) + h_1·W[1,b]) +
//      ... + bias[b] in input order, ReLU between layers, the last layer's
//      single output the deep margin; the weights are warp-uniform
//      (broadcast) loads, the activations one TR-float vector load a lane;
//   4. margin = w + deep, the dual (wh::loss_dual), then the backward layer
//      by layer: the parameter sums of layer l (h_lᵀ·gz_{l+1}, each
//      thread a TA×TB block of (a, b), adding the tile's rows in order onto
//      the span's running sums; the bias adds gz_{l+1} alone), then gh_l[a] =
//      Σ_b W_l[a,b]·gz_{l+1}[b] in b order, written over h_l in place
//      (masked by h_l > 0 for l > 0: the ReLU's vjp);
//   5. the push rows [dual, gh_0, mask], coalesced, f32 (the split path) or
//      bf16 (the fused step's grid for the pushes).
// Then wd_combine adds the spans' partials in span order. Every product is
// rounded before its add (--fmad=false, ops/_ext.py), so each row's margin
// and push row are the same bits as before this design and as the ordered
// plain version (tilemm.wd_boundary_ordered_plain), and the parameter
// gradients, rows in order within a span and spans in order, are the same
// bits whatever R, threads or weight placement a launch picks.
//
// Widths whose tile fits no CTA's shared memory even at 32 rows (Σ_{l<L}
// s_l above about 1,600 columns, e.g. hidden (1024, 512, 256)) run the same
// code with a 128-row tile in a device-memory region of each CTA (the grid
// then two CTAs a multiprocessor, each walking several spans): the same
// order of sums, so the same bits. Any widths and depth run.
//
// What bounds it: operations. About 9,300 multiply-adds a row at k 16 and
// hidden (64, 32) (forward, input vjp, parameter sums), 1.83 GFLOP per
// 98,304-row block: 0.055 ms at the H100's f32 rate without FMA contraction
// (0.027 with it). Its own bytes, the pulls, the push rows, the margins and
// labels (about 15 MB), take 0.005 ms. No tensor cores: TF32 would keep
// about 3 digits and break the bitwise contracts above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_math.cuh"

// Phase hooks, empty in the package: the design sweep defines them to add
// each phase's time to a counter (scripts/torch_wd_boundary_sweep.cu).
#ifndef WD_PHASE
#define WD_PHASE_START
#define WD_PHASE(i)
#endif

namespace wh {

constexpr int WD_INLINE_LAYERS = 8;
constexpr int WD_SMEM_MAX = 232448;       // a block's shared memory (227 KB)
constexpr int WD_GT_TR = 4;               // rows a lane, device-memory tiles

// The layer widths: s[0] = k, ..., s[L] = 1, by value for up to
// WD_INLINE_LAYERS layers, else read from the device copy ds; layer l's
// weights at off(l) of the packed vector, (s_l + 1) × s_{l+1} row-major (the
// last row the bias); hc = Σ_{l<L} s_l, the tile's activation columns.
struct WdDims {
  int L, P, hc;
  int s[WD_INLINE_LAYERS + 1];
  const int* ds;
  __device__ __forceinline__ int w(int l) const {
    return ds != nullptr ? ds[l] : s[l];
  }
  __device__ int off(int l) const {
    int o = 0;
    for (int j = 0; j < l; ++j) o += (w(j) + 1) * w(j + 1);
    return o;
  }
};

// WdDims from the host widths sizes[0..L] (sizes[0] = k, sizes[L] = 1), a
// device copy of them (read only when L > WD_INLINE_LAYERS) and the
// parameter count P; false when they disagree, or P or the tile's columns
// leave int.
inline bool wd_dims(const int* sizes, const int* dsizes, int L, long long P,
                    int k, WdDims* d) {
  if (sizes == nullptr || L < 1 || sizes[0] != k || sizes[L] != 1 ||
      (L > WD_INLINE_LAYERS && dsizes == nullptr))
    return false;
  long long off = 0, hc = 0;
  for (int l = 0; l < L; ++l) {
    if (sizes[l] < 1) return false;
    off += (long long)(sizes[l] + 1) * sizes[l + 1];
    hc += sizes[l];
  }
  if (off != P || P > 0x7fffffff || (2 + hc) * (32 * 4 + 4) > 0x7fffffff)
    return false;
  d->L = L;
  d->P = (int)P;
  d->hc = (int)hc;
  d->ds = L > WD_INLINE_LAYERS ? dsizes : nullptr;
  for (int l = 0; l <= L && l <= WD_INLINE_LAYERS; ++l) d->s[l] = sizes[l];
  return true;
}

// A launch's layout: rows a tile (32·tr), weights in shared memory, the
// span's parameter sums in shared memory, the tile in device memory (gt).
struct WdCfg {
  int tr, wsmem, asmem, gt;
};

__host__ __device__ inline int wd_p4(int p) { return (p + 3) & ~3; }

// Floats of a tile: [wide][deep/dual][h_0 .. h_{L-1}], each a column of
// 32·tr + 4 rows
__host__ __device__ inline long long wd_tile_floats(const WdDims& d, int tr) {
  return (long long)(2 + d.hc) * (32 * tr + 4);
}

// Shared bytes of a CTA: [weights][parameter sums][the tile unless gt]
inline long long wd_smem_bytes(const WdDims& d, const WdCfg& c) {
  return 4LL * ((c.wsmem ? wd_p4(d.P) : 0) + (c.asmem ? wd_p4(d.P) : 0) +
                (c.gt ? 0 : wd_tile_floats(d, c.tr)));
}

// The package's pick: the largest tile that fits in shared memory, with the
// weights there where they fit beside it, else read through L1, and the
// span's sums there where they fit, else in device memory. Where no tile
// fits, a 128-row tile in a device-memory region of its CTA (the same code
// and order of sums), with the weights and sums in shared memory where they
// fit. At hidden (300, 40) a 128-row tile with both in device memory beat
// 32-row tiles with both in shared memory 1.8x, and at hidden (1024, 512,
// 256) 128-row tiles in device memory beat 32-row ones 1.8x
// (scripts/torch_wd_boundary_sweep.py).
inline WdCfg wd_pick(const WdDims& d, int want_grad) {
  for (int tr = 4; tr >= 1; tr /= 2) {
    const WdCfg cs[3] = {{tr, 1, want_grad, 0}, {tr, 0, want_grad, 0},
                         {tr, 0, 0, 0}};
    for (const WdCfg& c : cs)
      if (wd_smem_bytes(d, c) <= WD_SMEM_MAX) return c;
  }
  const WdCfg cs[3] = {{WD_GT_TR, 1, want_grad, 1}, {WD_GT_TR, 1, 0, 1},
                       {WD_GT_TR, 0, want_grad, 1}};
  for (const WdCfg& c : cs)
    if (wd_smem_bytes(d, c) <= WD_SMEM_MAX) return c;
  return WdCfg{WD_GT_TR, 0, 0, 1};
}

// CTAs of a launch over nspan spans: one a span, or where the tile lives in
// device memory at most two a multiprocessor, each walking spans
// blockIdx.x, blockIdx.x + grid, ... (each span's sums its own row of the
// partials, so the grid changes no bits).
inline long long wd_grid(const WdCfg& c, long long nspan) {
  if (!c.gt) return nspan;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return nspan < 2LL * sms ? nspan : 2LL * sms;
}

// Floats of the device-memory tiles a launch needs: 0 where the tile fits
// in shared memory.
inline long long wd_tiles_floats(const WdDims& d, const WdCfg& c,
                                 long long rows, int span) {
  if (!c.gt || rows <= 0) return 0;
  return wd_grid(c, (rows + span - 1) / span) * wd_tile_floats(d, c.tr);
}

template <int TR>
__device__ __forceinline__ void wd_ld(const float* p, float (&v)[TR]) {
  if constexpr (TR == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (TR == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int TR>
__device__ __forceinline__ void wd_st(float* p, const float (&v)[TR]) {
  if constexpr (TR == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (TR == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// What a row-tile product does with its sums.
enum WdEpi { EPI_RELU, EPI_DEEP, EPI_MASK, EPI_STORE };

// out[c][r] = Σ_{j<J} A[j][r] · w(j, c) (+ bias[c] when FWD), summed from 0.f
// in j order, for the tile's R = 32·TR rows and c < C. Lane l owns rows
// l·TR .. l·TR+TR-1, warp w the column groups w, w + NW, ... of TC columns.
// FWD: w(j, c) = W[j·C + c], the bias row W[J·C + c]; else w(j, c) =
// W[c·J + j] (the transposed read of the backward). Columns past C read
// column C-1 and are dropped. A and out may be device memory this kernel
// wrote (a device-memory tile), so they are not __restrict__: that would
// let the compiler read them through the non-coherent cache.
template <int TR, int TC, bool FWD, int EPI>
__device__ __forceinline__ void wd_gemm(const float* A, const float* W,
                                        int J, int C, float* out, int rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, r0 = lane * TR;
  for (int c0 = warp * TC; c0 < C; c0 += nw * TC) {
    const float* wp[TC];
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      const int c = min(c0 + u, C - 1);
      wp[u] = FWD ? W + c : W + c * J;
    }
    float acc[TC][TR];
#pragma unroll
    for (int u = 0; u < TC; ++u)
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[u][t] = 0.f;
    const float* a = A + r0;
#pragma unroll 2
    for (int j = 0; j < J; ++j, a += rs) {
      float av[TR];
      wd_ld<TR>(a, av);
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        const float w = FWD ? wp[u][j * C] : wp[u][j];
#pragma unroll
        for (int t = 0; t < TR; ++t) acc[u][t] = acc[u][t] + av[t] * w;
      }
    }
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      const int c = c0 + u;
      if (c >= C) break;
      float v[TR];
      if constexpr (FWD) {
        const float b = wp[u][J * C];
#pragma unroll
        for (int t = 0; t < TR; ++t) v[t] = acc[u][t] + b;
      }
      float* o = out + c * rs + r0;
      if constexpr (EPI == EPI_RELU) {
#pragma unroll
        for (int t = 0; t < TR; ++t) v[t] = v[t] > 0.f ? v[t] : 0.f;
        wd_st<TR>(o, v);
      } else if constexpr (EPI == EPI_DEEP) {
        wd_st<TR>(o, v);
      } else if constexpr (EPI == EPI_MASK) {
        float h[TR];
        wd_ld<TR>(o, h);
#pragma unroll
        for (int t = 0; t < TR; ++t) v[t] = h[t] > 0.f ? acc[u][t] : 0.f;
        wd_st<TR>(o, v);
      } else {
#pragma unroll
        for (int t = 0; t < TR; ++t) v[t] = acc[u][t];
        wd_st<TR>(o, v);
      }
    }
  }
}

// Columns a thread takes in a row-tile product: the fewest (a power of two,
// at most 8) that still give every warp a group.
template <int TR, bool FWD, int EPI>
__device__ __forceinline__ void wd_gemm_any(const float* A, const float* W,
                                            int J, int C, float* out,
                                            int rs) {
  const int nw = blockDim.x >> 5;
  if (C > 4 * nw)
    wd_gemm<TR, 8, FWD, EPI>(A, W, J, C, out, rs);
  else if (C > 2 * nw)
    wd_gemm<TR, 4, FWD, EPI>(A, W, J, C, out, rs);
  else if (C > nw)
    wd_gemm<TR, 2, FWD, EPI>(A, W, J, C, out, rs);
  else
    wd_gemm<TR, 1, FWD, EPI>(A, W, J, C, out, rs);
}

// acc[a·sb + b] += Σ_{r<nr} H[a][r]·G[b][r], the rows in order, for a <
// sa, b < sb; then acc[sa·sb + b] += Σ_r G[b][r]. A warp takes blocks of
// (8·TA) × (4·TB): lane (ai, bi) = (l & 7, l >> 3) owns a = ai + 8i, b =
// bi + 4j, so the 8 lanes of a 16-byte load phase read 8 consecutive
// columns of H and one of G. nr is a multiple of 4; rows past the tile's
// last carry gz = +0 (their dual is 0), so they add nothing: a sum that
// starts at +0 never becomes -0. H, G and acc may be device memory this
// kernel wrote, so none is __restrict__ (see wd_gemm).
template <int TA, int TB>
__device__ __forceinline__ void wd_params(const float* H, const float* G,
                                          int sa, int sb, float* acc, int nr,
                                          int rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, ai = lane & 7, bi = lane >> 3;
  const int na = (sa + 8 * TA - 1) / (8 * TA);
  const int nb = (sb + 4 * TB - 1) / (4 * TB);
  for (int blk = warp; blk < na * nb; blk += nw) {
    const int a0 = (blk / nb) * 8 * TA + ai, b0 = (blk % nb) * 4 * TB + bi;
    const float* hp[TA];
    const float* gp[TB];
    float s[TA][TB];
#pragma unroll
    for (int i = 0; i < TA; ++i) hp[i] = H + min(a0 + 8 * i, sa - 1) * rs;
#pragma unroll
    for (int j = 0; j < TB; ++j) gp[j] = G + min(b0 + 4 * j, sb - 1) * rs;
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int a = a0 + 8 * i, b = b0 + 4 * j;
        s[i][j] = (a < sa && b < sb) ? acc[a * sb + b] : 0.f;
      }
    for (int r = 0; r < nr; r += 4) {
      float4 h[TA], g[TB];
#pragma unroll
      for (int i = 0; i < TA; ++i)
        h[i] = *reinterpret_cast<const float4*>(hp[i] + r);
#pragma unroll
      for (int j = 0; j < TB; ++j)
        g[j] = *reinterpret_cast<const float4*>(gp[j] + r);
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          float x = s[i][j];
          x = x + h[i].x * g[j].x;
          x = x + h[i].y * g[j].y;
          x = x + h[i].z * g[j].z;
          x = x + h[i].w * g[j].w;
          s[i][j] = x;
        }
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int a = a0 + 8 * i, b = b0 + 4 * j;
        if (a < sa && b < sb) acc[a * sb + b] = s[i][j];
      }
  }
  // the bias: thread b adds its column's rows in order
  for (int b = threadIdx.x; b < sb; b += blockDim.x) {
    float x = acc[sa * sb + b];
    const float* g = G + b * rs;
    for (int r = 0; r < nr; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(g + r);
      x = x + v.x;
      x = x + v.y;
      x = x + v.z;
      x = x + v.w;
    }
    acc[sa * sb + b] = x;
  }
}

// The largest (TA, TB), at most 16 outputs a thread, that still gives every
// warp a block of layer sa × sb.
__device__ __forceinline__ void wd_params_any(const float* H, const float* G,
                                              int sa, int sb, float* acc,
                                              int nr, int rs) {
  const int nw = blockDim.x >> 5;
  auto blocks = [&](int ta, int tb) {
    return ((sa + 8 * ta - 1) / (8 * ta)) * ((sb + 4 * tb - 1) / (4 * tb));
  };
  if (blocks(4, 4) >= nw)
    wd_params<4, 4>(H, G, sa, sb, acc, nr, rs);
  else if (blocks(2, 4) >= nw)
    wd_params<2, 4>(H, G, sa, sb, acc, nr, rs);
  else if (blocks(1, 4) >= nw)
    wd_params<1, 4>(H, G, sa, sb, acc, nr, rs);
  else if (blocks(1, 2) >= nw)
    wd_params<1, 2>(H, G, sa, sb, acc, nr, rs);
  else
    wd_params<1, 1>(H, G, sa, sb, acc, nr, rs);
}

// CTAs of NW warps walk the spans of `span` rows (blockIdx.x, blockIdx.x +
// gridDim.x, ...), each in tiles of R = 32·TR rows held in shared memory, or
// with GT in the CTA's region of `tiles` (wd_tile_floats floats each). part
// (spans, P) gets each span's parameter sums (want_grad); margins (rows,)
// and the push rows dvf (f32) or dvb (bf16), (rows, k+2).
template <int TR, int NW, bool GT>
__global__ void __launch_bounds__(NW * 32, 2)
    wd_tile(const float* __restrict__ pulls,
            const float* __restrict__ labels,
            const float* __restrict__ mask,
            const float* __restrict__ params, WdDims d, int wsmem, int asmem,
            float* tiles, float* __restrict__ part,
            float* __restrict__ margins, __nv_bfloat16* __restrict__ dvb,
            float* __restrict__ dvf, long long rows, int span, int loss,
            int want_grad) {
  constexpr int R = 32 * TR, RS = R + 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = NW * 32, k = d.w(0), L = d.L;
  const int P = d.P, ch = k + 1, cho = k + 2;
  float* sp = smem;
  const float* W = params;
  if (wsmem) {
    for (int p = tid; p < P; p += nt) sp[p] = params[p];
    W = sp;
    sp += wd_p4(P);
  }
  float* sacc = sp;
  if (want_grad && asmem) sp += wd_p4(P);
  float* tb = GT ? tiles + (long long)blockIdx.x * wd_tile_floats(d, TR) : sp;
  float* wide = tb;
  float* D = tb + RS;
  float* H0 = tb + 2 * RS;
  const long long nspan = (rows + span - 1) / span;
  WD_PHASE_START

  for (long long sid = blockIdx.x; sid < nspan; sid += gridDim.x) {
    float* acc = asmem ? sacc : part + sid * P;
    if (want_grad)
      for (int p = tid; p < P; p += nt) acc[p] = 0.f;
    __syncthreads();
    WD_PHASE(0)
    const long long s0 = sid * span, s1 = min(rows, s0 + span);
    for (long long r0 = s0; r0 < s1; r0 += R) {
      const int n = (int)min((long long)R, s1 - r0);
      // the tile's pulls: wide in its column, pooled into h_0; rows past n 0
      const float* src = pulls + r0 * ch;
      for (int i = tid; i < R * ch; i += nt) {
        const int r = i / ch, c = i - r * ch;
        const float v = r < n ? src[i] : 0.f;
        if (c == 0)
          wide[r] = v;
        else
          H0[(c - 1) * RS + r] = v;
      }
      __syncthreads();
      WD_PHASE(1)
      // forward
      {
        float* h = H0;
        for (int l = 0; l < L; ++l) {
          const int sa = d.w(l), sb = d.w(l + 1);
          const float* Wl = W + d.off(l);
          float* hn = h + sa * RS;
          if (l + 1 < L)
            wd_gemm_any<TR, true, EPI_RELU>(h, Wl, sa, sb, hn, RS);
          else
            wd_gemm_any<TR, true, EPI_DEEP>(h, Wl, sa, sb, D, RS);
          __syncthreads();
          h = hn;
        }
      }
      WD_PHASE(2)
      // margin and dual
      for (int r = tid; r < R; r += nt) {
        if (r < n) {
          const float m = wide[r] + D[r];
          margins[r0 + r] = m;
          if (want_grad)
            D[r] = loss_dual(loss, m, labels[r0 + r], mask[r0 + r]);
        } else {
          D[r] = 0.f;
        }
      }
      __syncthreads();
      if (!want_grad) continue;
      WD_PHASE(3)
      // backward: layer l's parameter sums, then gh_l over h_l in place
      {
        const int nr = (n + 3) & ~3;
        float* hl = H0 + (d.hc - d.w(L - 1)) * RS;
        const float* g = D;
        for (int l = L - 1; l >= 0; --l) {
          const int sa = d.w(l), sb = d.w(l + 1);
          const float* Wl = W + d.off(l);
          wd_params_any(hl, g, sa, sb, acc + d.off(l), nr, RS);
          __syncthreads();
          WD_PHASE(4)
          if (l > 0)
            wd_gemm_any<TR, false, EPI_MASK>(g, Wl, sb, sa, hl, RS);
          else
            wd_gemm_any<TR, false, EPI_STORE>(g, Wl, sb, sa, hl, RS);
          __syncthreads();
          WD_PHASE(5)
          g = hl;
          if (l > 0) hl -= d.w(l - 1) * RS;
        }
      }
      // push rows [dual, gh_0, mask], coalesced
      const long long o = r0 * cho;
      for (int i = tid; i < n * cho; i += nt) {
        const int r = i / cho, c = i - r * cho;
        const float v = c == 0 ? D[r]
                        : c == cho - 1 ? mask[r0 + r]
                                       : H0[(c - 1) * RS + r];
        if (dvf != nullptr) dvf[o + i] = v;
        if (dvb != nullptr) dvb[o + i] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      WD_PHASE(6)
    }
    if (want_grad && asmem) {
      float* dst = part + sid * P;
      for (int p = tid; p < P; p += nt) dst[p] = acc[p];
    }
    WD_PHASE(7)
  }
}

// grad[p] = Σ_s part[s][p], spans in order from 0.f; 16 loads in flight.
__global__ void wd_combine(const float* __restrict__ part,
                           float* __restrict__ grad, int P, int nspan) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float acc = 0.f;
  int s = 0;
  for (; s + 16 <= nspan; s += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = part[(long long)(s + u) * P + p];
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = acc + v[u];
  }
  for (; s < nspan; ++s) acc = acc + part[(long long)s * P + p];
  grad[p] = acc;
}

template <int TR, int NW, bool GT>
int launch_wd_tile(const float* pulls, const float* labels, const float* mask,
                   const float* params, const WdDims& d, const WdCfg& c,
                   float* tiles, float* part, float* margins,
                   __nv_bfloat16* dvb, float* dvf, long long rows, int span,
                   int loss, int want_grad, cudaStream_t st) {
  const long long smem = wd_smem_bytes(d, WdCfg{TR, c.wsmem, c.asmem, GT});
  int err = (int)cudaFuncSetAttribute(
      wd_tile<TR, NW, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  const long long nspan = (rows + span - 1) / span;
  const unsigned grid = (unsigned)wd_grid(WdCfg{TR, c.wsmem, c.asmem, GT},
                                          nspan);
  wd_tile<TR, NW, GT><<<grid, NW * 32, (size_t)smem, st>>>(
      pulls, labels, mask, params, d, c.wsmem, c.asmem, tiles, part, margins,
      dvb, dvf, rows, span, loss, want_grad);
  return (int)cudaGetLastError();
}

inline int launch_wd_combine(const float* part, float* gparams, int P,
                             long long rows, int span, cudaStream_t st) {
  const int nspan = (int)((rows + span - 1) / span);
  wd_combine<<<(P + 127) / 128, 128, 0, st>>>(part, gparams, P, nspan);
  return (int)cudaGetLastError();
}

// The boundary of `rows` rows with tiles of 32·c.tr rows, 8 warps a CTA and
// spans of `span` rows (a multiple of 32·c.tr): margins, the push rows (dvf
// or dvb) and, with want_grad, gparams (P,) through part (spans, P); with
// c.gt the tiles in `tiles` (wd_tiles_floats floats).
inline int launch_wd_boundary(const float* pulls, const float* labels,
                              const float* mask, const float* params,
                              const WdDims& d, const WdCfg& c, float* tiles,
                              float* part, float* margins,
                              __nv_bfloat16* dvb, float* dvf, float* gparams,
                              long long rows, int span, int loss,
                              int want_grad, cudaStream_t st) {
  if (rows <= 0) return 0;
  if ((c.gt && tiles == nullptr) || span % (32 * c.tr) != 0)
    return (int)cudaErrorInvalidValue;
  int err;
  if (c.gt && c.tr == WD_GT_TR)
    err = launch_wd_tile<WD_GT_TR, 8, true>(pulls, labels, mask, params, d,
                                            c, tiles, part, margins, dvb,
                                            dvf, rows, span, loss, want_grad,
                                            st);
  else if (!c.gt && c.tr == 4)
    err = launch_wd_tile<4, 8, false>(pulls, labels, mask, params, d, c,
                                      tiles, part, margins, dvb, dvf, rows,
                                      span, loss, want_grad, st);
  else if (!c.gt && c.tr == 2)
    err = launch_wd_tile<2, 8, false>(pulls, labels, mask, params, d, c,
                                      tiles, part, margins, dvb, dvf, rows,
                                      span, loss, want_grad, st);
  else if (!c.gt && c.tr == 1)
    err = launch_wd_tile<1, 8, false>(pulls, labels, mask, params, d, c,
                                      tiles, part, margins, dvb, dvf, rows,
                                      span, loss, want_grad, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || !want_grad) return err;
  return launch_wd_combine(part, gparams, d.P, rows, span, st);
}

}  // namespace wh
