// The crec2 train step on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two variants of wormhole_tpu/ops/tilemm.py
// `_make_step_kernel` (:1160):
//   - wh_step_grad:   `_build_step_grad` (:1328, pallas_call :1348), the
//     grad-emitting step (margins, grad), with the optional pre-aggregated
//     spill-margin grid and the zero-dual nudge;
//   - wh_step_update: `_build_step_update` (:1373, pallas_call :1399), the
//     step that applies FTRLHandle.update to the w/z/cg planes in place, so
//     the (nb,) gradient never exists in device memory.
// It also exports the split path's elementwise launches of the same math
// (wh_loss_dual, wh_ftrl_push), so split and fused run the same device
// functions (tile_math.cuh) and agree bitwise.
//
// The TPU ran the step as one two-phase grid. Hopper blocks run in no order,
// so the phase boundary is a grid-wide dependency; here the phases are
// back-to-back launches on one stream:
//   1. the forward (tile_fwd.cuh: the tile pass, then fwd_rows) with the
//      step's boundary as the epilogue of fwd_rows: the CTA that owns a row
//      sums it in word order, adds the spill grid, computes the dual
//      (+ nudge) and writes the margin and the bf16 dual grid, so the
//      margins are written once and no boundary launch remains;
//   2. the tile backward (tile_bwd.cuh: the word-ordered dual gather, then
//      one CTA per tile) with an epilogue: the gradient
//      written out (grad step) or the FTRL update on the tile's w/z/cg
//      plane slices (update step), from the gradient in shared memory.
// wh_tile_fwd runs the same fwd_rows code with the margin store as its
// epilogue, so the split chain's margins are the fused step's bits.
// A cooperative single launch with a grid sync is the later alternative.
//
// What bounds it: bytes. Per full-width criteo block (2^22 buckets, 98,304
// rows), the grad step moves pw (17.3 MB), w (16.8 MB), labels, mask and
// margins (0.4 MB each) and grad (16.8 MB); the update step moves pw, the
// w/z/cg planes in and out (100.7 MB), labels, mask and margins. The
// forward's packed values (17.3 MB written and read, tile_fwd.cuh), the
// bf16 dual grid (0.2 MB) and the word-ordered dual values (8.6 MB) are
// extra traffic of this design.

#include "tile_bwd.cuh"
#include "tile_math.cuh"

namespace {

using wh::BWD_SMEM;
using wh::BWD_THREADS;
using wh::BWD_WARPS;
using wh::TILE;

// The boundary of both step variants as the forward's epilogue, on each
// row's final sum: the spill grid's single f32 add, the dual [+ nudge], the
// margin and the bf16 dual grid the backward's gather_dual reads.
struct StepBoundary {
  const float* spill;
  const float* labels;
  const float* mask;
  float* margins;
  __nv_bfloat16* dual;
  int loss, exact_dense;
  __device__ __forceinline__ void operator()(int s, int r, float m) const {
    const long long i = (long long)s * wh::RSUB + r;
    if (spill != nullptr) m = m + spill[i];
    margins[i] = m;
    float d = wh::loss_dual(loss, m, labels[i], mask[i]);
    if (!exact_dense) d = wh::nudge_zero_dual(d, labels[i], mask[i]);
    dual[i] = __float2bfloat16_rn(d);
  }
};

__global__ void __launch_bounds__(BWD_THREADS)
step_bwd_ftrl(const int32_t* __restrict__ pw,
              const __nv_bfloat16* __restrict__ dv, float* __restrict__ w,
              float* __restrict__ z, float* __restrict__ cg,
              float* __restrict__ wdelta2, int SG, int GS, int C,
              wh::Ftrl p) {
  extern __shared__ float slab[];
  __shared__ wh::BwdQueues q;
  __shared__ float red[BWD_WARPS];
  const int t = blockIdx.x;
  wh::bwd_tile_slab(pw, dv, t, SG, GS, C, slab, q);
  const long long o = (long long)t * TILE;
  wh::ftrl_tile(p, slab, w + o, z + o, cg + o, wdelta2 + t, red, TILE);
}

__global__ void __launch_bounds__(BWD_THREADS)
ftrl_push_kernel(const float* __restrict__ grad, float* __restrict__ w,
                 float* __restrict__ z, float* __restrict__ cg,
                 float* __restrict__ wdelta2, wh::Ftrl p) {
  __shared__ float red[BWD_WARPS];
  const long long o = (long long)blockIdx.x * TILE;
  wh::ftrl_tile(p, grad + o, w + o, z + o, cg + o, wdelta2 + blockIdx.x,
                red, TILE);
}

__global__ void loss_dual_kernel(const float* __restrict__ margins,
                                 const float* __restrict__ labels,
                                 const float* __restrict__ mask,
                                 float* __restrict__ dual, long long rows,
                                 int loss, int exact_dense) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float d = wh::loss_dual(loss, margins[i], labels[i], mask[i]);
  if (!exact_dense) d = wh::nudge_zero_dual(d, labels[i], mask[i]);
  dual[i] = d;
}

// Phase 1 of both step variants: the forward and the boundary.
int fwd_and_boundary(const int32_t* pw, const float* w, const float* labels,
                     const float* mask, const float* spill, unsigned* scratch,
                     float* margins, __nv_bfloat16* dual, int T, int SG,
                     int GS, int C, int R, int loss, int exact_dense,
                     cudaStream_t st) {
  return wh::launch_fwd<wh::ROW_WARPS, wh::ROW_U>(
      pw, w, scratch, T, SG, GS, C, R,
      StepBoundary{spill, labels, mask, margins, dual, loss, exact_dense},
      st);
}

}  // namespace

extern "C" {

// (margins (S*8192,), grad (T*16384,)) from pw (T, SG, GS*C) i32, w
// (T*16384,) f32 and the f32 labels/mask rows; `spill` is the (S*8192,)
// spill-margin grid or null; R rows a forward CTA. scratch (the forward's,
// as in wh_tile_fwd), dual (S*8192,) bf16 and dv (one bf16 per word of pw)
// are scratch too. Returns cudaGetLastError() after each launch.
int wh_step_grad(const int32_t* pw, const float* w, const float* labels,
                 const float* mask, const float* spill, unsigned* scratch,
                 float* margins, __nv_bfloat16* dual, __nv_bfloat16* dv,
                 float* grad, int T, int SG, int GS, int C, int R, int loss,
                 int exact_dense, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = fwd_and_boundary(pw, w, labels, mask, spill, scratch, margins,
                             dual, T, SG, GS, C, R, loss, exact_dense, st);
  if (err != 0) return err;
  return wh::launch_bwd_grad(pw, (const __nv_bfloat16*)dual, dv, grad, T,
                             SG, GS, C, st);
}

// margins, and the FTRL update in place on the w/z/cg planes (each
// (T*16384,) f32; w is also the forward's operand); scratch, dual and dv
// are scratch as in wh_step_grad. wdelta2 (T,) f32 receives each tile's
// Σ(w' - w)². No nudge: FTRL is exact-dense.
int wh_step_update(const int32_t* pw, float* w, float* z, float* cg,
                   const float* labels, const float* mask, unsigned* scratch,
                   float* margins, __nv_bfloat16* dual, __nv_bfloat16* dv,
                   float* wdelta2, int T, int SG, int GS, int C, int R,
                   int loss, float alpha, float beta, float lambda1,
                   float lambda2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = fwd_and_boundary(pw, w, labels, mask, nullptr, scratch, margins,
                             dual, T, SG, GS, C, R, loss, 1, st);
  if (err != 0) return err;
  err = wh::launch_gather_dual(pw, (const __nv_bfloat16*)dual, dv, T, SG, GS,
                               C, st);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      step_bwd_ftrl, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  step_bwd_ftrl<<<T, BWD_THREADS, BWD_SMEM, st>>>(
      pw, dv, w, z, cg, wdelta2, SG, GS, C,
      wh::Ftrl{alpha, beta, lambda1, lambda2});
  return (int)cudaGetLastError();
}

// The split path's dual: (rows,) f32 from f32 margins/labels/mask.
int wh_loss_dual(const float* margins, const float* labels,
                 const float* mask, float* dual, long long rows, int loss,
                 int exact_dense, void* stream) {
  loss_dual_kernel<<<(unsigned)((rows + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      margins, labels, mask, dual, rows, loss, exact_dense);
  return (int)cudaGetLastError();
}

// The split path's FTRL push: the update in place on the w/z/cg planes from
// grad (T*16384,), each tile's Σ(w' - w)² into wdelta2 (T,).
int wh_ftrl_push(const float* grad, float* w, float* z, float* cg,
                 float* wdelta2, int T, float alpha, float beta,
                 float lambda1, float lambda2, void* stream) {
  ftrl_push_kernel<<<T, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, w, z, cg, wdelta2, wh::Ftrl{alpha, beta, lambda1, lambda2});
  return (int)cudaGetLastError();
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
