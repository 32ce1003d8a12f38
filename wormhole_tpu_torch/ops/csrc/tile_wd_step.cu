// The wide&deep train step on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_make_wd_step_kernel` (:1590, built
// by `_build_wd_step_fused` :1662, pallas_call :1705): wh_wd_step. The TPU
// ran the MLP forward and its vjp inside that kernel's boundary phase
// (:1622-1652); here they are hand-written too (tile_wd.cuh).
// wh_wd_boundary exports the same boundary alone, which the split path and
// the eval margin launch after forward_pulls, so split and fused run the
// same device code and agree bitwise (slots, MLP, accumulators, metrics).
//
// The phases are back-to-back launches on one stream:
//   1. the pulls (tile_multi.cuh launch_pulls_tile: the row index, then one
//      segmented sum) over ch_in = 1+k channels [w, v_1..v_k] into a (rows,
//      1+k) f32 grid, each (row, channel) summed in word order;
//   2. wd_tile: one CTA a span of rows, walked in tiles of R rows whose
//      activations and cotangents stay in shared memory: the MLP forward
//      (h @ W + b, ReLU between layers; deep = the one output), margin =
//      wide + deep, the dual, the vjp down to the pooled input and the
//      span's parameter-gradient sums; it writes the margins and the bf16
//      push grid [dual, g_pooled_1..k, mask];
//   3. wd_combine: each parameter's gradient, the spans' sums added in span
//      order: deterministic, no atomics;
//   4. the pushes (tile_multi.cuh launch_pushes_tile: the bucket index,
//      then one segmented sum) over ch_out = k+2 channels; the bucket index
//      reuses the pulls' perm buffer, dead once phase 1 has run.
// The layer widths come by value (WdDims; deeper MLPs than
// WD_INLINE_LAYERS read a device copy) and wd_pick sizes R from them so a
// CTA's tile fits the shared memory, with the weights read through L1 when
// they do not fit beside it; where no tile fits, each CTA keeps its 128-row
// tile in its own region of device memory (wh_wd_tiles sizes it), with the
// same code and order of sums. Any widths and depth run.
//
// What bounds it: bytes. Per full-width block at k = 16: the words twice,
// the sectors of the (nb, 17) f32 pull table (285 MB) the block reaches and
// the (nb, 18) f32 pushes (302 MB). The MLP is about 1.8 GFLOP per
// 98,304-row block for forward and backward, 0.055 ms at the f32 peak
// without FMA contraction. The two indexes and the pulls grid are this
// design's extra traffic.

#include "tile_math.cuh"
#include "tile_multi.cuh"
#include "tile_wd.cuh"

extern "C" {

// Floats of the device-memory tiles the boundary of `rows` rows needs for
// these widths (sizes: L+1 host ints, dsizes a device copy), 0 when a tile
// fits in shared memory, -1 when the widths disagree with P or k.
long long wh_wd_tiles(const int* sizes, const int* dsizes, int L,
                      long long P, int k, long long rows, int span,
                      int want_grad) {
  wh::WdDims d;
  if (!wh::wd_dims(sizes, dsizes, L, P, k, &d) || span < 1) return -1;
  return wh::wd_tiles_floats(d, wh::wd_pick(d, want_grad), rows, span);
}

// (margins (S*8192,), pushes (T*16384, k+2), gparams (P,)) from pw (T, SG,
// GS*C) i32, the pull table w (T*16384, 1+k) f32, the f32 labels/mask rows
// and the flat f32 MLP parameters [W0, b0, W1, b1, ...] (P floats) with
// layer widths `sizes` (L+1 host ints, sizes[0] = k, sizes[L] = 1) and
// their device copy dsizes. Scratch: the pulls' row index pull_index
// (S*8192 + 1 + S*nrun*8192 + S*8192/1024, nrun = ceil(T / tiles_per_run))
// and the pushes' bucket index push_index (T*16384 + 1 + T) int32, one perm
// (T*SG*GS*C) int32 for both, pulls (S*8192, 1+k) f32, tiles
// (wh_wd_tiles floats; null when 0), gpart (ceil(rows / span), P) f32 and
// dvb (rows, k+2) bf16. Returns cudaGetLastError() after each launch,
// cudaErrorInvalidValue for a null scratch or widths that disagree with P
// or k.
int wh_wd_step(const int32_t* pw, const float* w, const float* labels,
               const float* mask, const float* params, const int* sizes,
               const int* dsizes, int L, long long P, int* pull_index,
               float* pulls, float* tiles, float* gpart, float* margins,
               __nv_bfloat16* dvb, float* gparams, int* push_index,
               int* perm, float* pushes, int T, int SG, int GS, int C, int k,
               int tiles_per_run, int span, int loss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wh::WdDims d;
  if (!wh::wd_dims(sizes, dsizes, L, P, k, &d) || gpart == nullptr ||
      dvb == nullptr || gparams == nullptr || span < 1)
    return (int)cudaErrorInvalidValue;
  const wh::WdCfg cfg = wh::wd_pick(d, 1);
  if (cfg.gt && tiles == nullptr) return (int)cudaErrorInvalidValue;
  int err = wh::launch_pulls_tile(pw, w, pull_index, perm, pulls, T, SG, GS,
                                  C, k + 1, tiles_per_run, st);
  if (err != 0) return err;
  const long long rows = (long long)SG * GS * wh::RSUB;
  err = wh::launch_wd_boundary(pulls, labels, mask, params, d, cfg, tiles,
                               gpart, margins, dvb, nullptr, gparams, rows,
                               span, loss, 1, st);
  if (err != 0) return err;
  return wh::launch_pushes_tile(pw, dvb, push_index, perm, pushes, T, SG, GS,
                                C, k + 2, st);
}

// The boundary alone from (rows, 1+k) f32 pulls: margins, and with
// want_grad the f32 push rows dvf (rows, k+2) and gparams (P,) through
// gpart (ceil(rows / span), P); tiles as for wh_wd_step.
int wh_wd_boundary(const float* pulls, const float* labels,
                   const float* mask, const float* params, const int* sizes,
                   const int* dsizes, int L, long long P, int k,
                   float* tiles, float* gpart, float* margins, float* dvf,
                   float* gparams, long long rows, int span, int loss,
                   int want_grad, void* stream) {
  wh::WdDims d;
  if (!wh::wd_dims(sizes, dsizes, L, P, k, &d) || span < 1 ||
      (want_grad && (gpart == nullptr || dvf == nullptr ||
                     gparams == nullptr)))
    return (int)cudaErrorInvalidValue;
  return wh::launch_wd_boundary(pulls, labels, mask, params, d,
                                wh::wd_pick(d, want_grad), tiles, gpart,
                                margins, nullptr, dvf, gparams, rows, span,
                                loss, want_grad,
                                static_cast<cudaStream_t>(stream));
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
