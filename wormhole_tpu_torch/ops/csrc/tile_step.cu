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
//   2. the backward (tile_bwd.cuh: bin_vals over the bf16 dual grid, then
//      bin_sums, a warp per 512-bucket bin) with an epilogue: the gradient
//      written out (grad step) or the FTRL update on the bin's w/z/cg plane
//      slices (update step), from the bin's gradient in shared memory.
// wh_tile_fwd and wh_tile_bwd run the same code with the margin and
// gradient stores as their epilogues, and wh_ftrl_push runs the update over
// the same (tile, bin) partition with the same reduction, so the split
// chain's margins, gradient, slots and Σ(Δw)² partials are the fused steps'
// bits. The forward's scratch serves the backward too: the forward has
// finished with it when bin_vals overwrites it.
// A cooperative single launch with a grid sync is the later alternative.
//
// What bounds it: bytes. Per full-width criteo block (2^22 buckets, 98,304
// rows), the grad step moves pw (17.3 MB), w (16.8 MB), labels, mask and
// margins (0.4 MB each) and grad (16.8 MB); the update step moves pw, the
// w/z/cg planes in and out (100.7 MB), labels, mask and margins. Each
// phase's packed values (17.3 MB written and read) and the bf16 dual grid
// (0.2 MB) are extra traffic of this design.

#include "tile_bwd.cuh"

namespace {

using wh::TILE;

constexpr int PUSH_WARPS = 8;        // bins (warps) an ftrl_push_kernel CTA

// The boundary of both step variants as the forward's epilogue, on each
// row's final sum: the spill grid's single f32 add, the dual [+ nudge], the
// margin and the bf16 dual grid the backward's bin_vals reads.
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

// The split path's push over the fused update's partition: warp i updates
// buckets [i*512, i*512 + 512) (bin i % 32 of tile i / 32) with the fused
// epilogue's loop and reduction, so its slots and Σ(Δw)² partials are the
// fused step's bits.
__global__ void __launch_bounds__(PUSH_WARPS * 32)
ftrl_push_kernel(const float* __restrict__ grad, float* __restrict__ w,
                 float* __restrict__ z, float* __restrict__ cg,
                 float* __restrict__ wdelta2, long long spans, wh::Ftrl p) {
  const long long i = (long long)blockIdx.x * PUSH_WARPS + (threadIdx.x >> 5);
  if (i >= spans) return;
  const long long o = i * wh::BIN_KEYS;
  wh::ftrl_warp(p, grad + o, w + o, z + o, cg + o, wdelta2 + i,
                wh::BIN_KEYS);
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
                     long long scratch_words, float* margins,
                     __nv_bfloat16* dual, int T, int SG, int GS, int C,
                     int R, int loss, int exact_dense, cudaStream_t st) {
  return wh::launch_fwd<wh::ROW_WARPS, wh::ROW_U>(
      pw, w, scratch, scratch_words, T, SG, GS, C, R,
      StepBoundary{spill, labels, mask, margins, dual, loss, exact_dense},
      st);
}

}  // namespace

extern "C" {

// (margins (S*8192,), grad (T*16384,)) from pw (T, SG, GS*C) i32, w
// (T*16384,) f32 and the f32 labels/mask rows; `spill` is the (S*8192,)
// spill-margin grid or null; R rows a forward CTA, `spans` the backward's
// bins a tile (wh::NBIN). scratch (scratch_words u32, large enough for both
// passes: tilemm._span_scratch) and dual (S*8192,) bf16 are scratch too.
// Returns cudaGetLastError() after each launch.
int wh_step_grad(const int32_t* pw, const float* w, const float* labels,
                 const float* mask, const float* spill, unsigned* scratch,
                 long long scratch_words, float* margins,
                 __nv_bfloat16* dual, float* grad, int T, int SG, int GS,
                 int C, int R, int spans, int loss, int exact_dense,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = fwd_and_boundary(pw, w, labels, mask, spill, scratch,
                             scratch_words, margins, dual, T, SG, GS, C, R,
                             loss, exact_dense, st);
  if (err != 0) return err;
  return wh::launch_bwd<wh::BwdBins>(pw, (const __nv_bfloat16*)dual, scratch,
                                     scratch_words, T, SG, GS, C, spans,
                                     wh::BwdGrad<wh::BwdBins>{grad}, st);
}

// margins, and the FTRL update in place on the w/z/cg planes (each
// (T*16384,) f32; w is also the forward's operand); scratch and dual are
// scratch as in wh_step_grad. wdelta2 (T*spans,) f32 receives each bin's
// Σ(w' - w)² (spans = wh::NBIN bins of 512 buckets a tile). No nudge: FTRL
// is exact-dense.
int wh_step_update(const int32_t* pw, float* w, float* z, float* cg,
                   const float* labels, const float* mask, unsigned* scratch,
                   long long scratch_words, float* margins,
                   __nv_bfloat16* dual, float* wdelta2, int T, int SG,
                   int GS, int C, int R, int spans, int loss, float alpha,
                   float beta, float lambda1, float lambda2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = fwd_and_boundary(pw, w, labels, mask, nullptr, scratch,
                             scratch_words, margins, dual, T, SG, GS, C, R,
                             loss, 1, st);
  if (err != 0) return err;
  return wh::launch_bwd<wh::BwdBins>(
      pw, (const __nv_bfloat16*)dual, scratch, scratch_words, T, SG, GS, C,
      spans,
      wh::BwdFtrl<wh::BwdBins>{w, z, cg, wdelta2,
                               {alpha, beta, lambda1, lambda2}},
      st);
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
// grad (T*16384,), each bin's Σ(w' - w)² into wdelta2 (T*spans,), over the
// fused update's (tile, bin) partition; `spans` must be wh::NBIN.
int wh_ftrl_push(const float* grad, float* w, float* z, float* cg,
                 float* wdelta2, int T, int spans, float alpha, float beta,
                 float lambda1, float lambda2, void* stream) {
  if (spans != wh::NBIN) return (int)cudaErrorInvalidValue;
  const long long n = (long long)T * spans;
  ftrl_push_kernel<<<(unsigned)((n + PUSH_WARPS - 1) / PUSH_WARPS),
                     PUSH_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, w, z, cg, wdelta2, n, wh::Ftrl{alpha, beta, lambda1, lambda2});
  return (int)cudaGetLastError();
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
