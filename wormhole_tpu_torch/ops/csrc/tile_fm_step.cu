// The factorization-machine train step on Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_make_fm_step_kernel` (:1439, built
// by `_build_fm_step_fused` :1502, pallas_call :1546): wh_fm_step, with and
// without the spill grid. It also exports the boundary math alone
// (wh_fm_boundary), which the split path and the eval margin launch after
// forward_pulls, so split and fused run the same device code and agree
// bitwise.
//
// The TPU ran the step as one two-phase grid. Hopper blocks run in no order,
// so the phases are back-to-back launches on one stream, as in tile_step.cu:
//   1. the pulls (tile_multi.cuh launch_pulls_tile: the row index, then one
//      segmented sum) over ch = k+2 channels [w, v_1..v_k, Σv²] into a
//      (rows, k+2) f32 grid, each (row, channel) summed in word order;
//   2. fm_boundary: reads the grid plus the spill grid (one f32 add, as the
//      split path adds it in torch), computes fm_margin_math's margin lin +
//      ½(Σ s_j² − q) in the JAX channel order, the dual, and writes the
//      bf16 push grid [dual, dual·s_1..dual·s_k, mask] (and, with spill,
//      its f32 rows for the torch spill scatter);
//   3. the pushes (tile_multi.cuh launch_pushes_tile: the bucket index,
//      then one segmented sum) over the same k+2 channels. Its index
//      reuses the pulls' perm buffer, dead once phase 1 has run.
//
// What bounds it: bytes. Per full-width block at k = 8: the words (17.3 MB)
// twice, the sectors of the (nb, 10) f32 pull table the block reaches and
// the (nb, 10) f32 pushes (168 MB), labels, mask and margins. The two
// indexes, the pulls grid and the bf16 push grid are this design's extra
// traffic.

#include "tile_math.cuh"
#include "tile_multi.cuh"

namespace {

template <class Src>
__global__ void fm_boundary(Src src, const float* __restrict__ labels,
                            const float* __restrict__ mask,
                            float* __restrict__ margins,
                            __nv_bfloat16* __restrict__ dvb,
                            float* __restrict__ dvf, long long rows, int k,
                            int loss, int want_dual) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const float lin = src(i, 0);
  float s = src(i, 1);
  float ss = s * s;
  for (int j = 1; j < k; ++j) {
    s = src(i, 1 + j);
    ss = ss + s * s;
  }
  const float m = lin + 0.5f * (ss - src(i, 1 + k));
  margins[i] = m;
  if (!want_dual) return;
  const float msk = mask[i];
  const float d = wh::loss_dual(loss, m, labels[i], msk);
  const int ch = k + 2;
  float* fo = dvf == nullptr ? nullptr : dvf + i * ch;
  __nv_bfloat16* bo = dvb == nullptr ? nullptr : dvb + i * ch;
  for (int c = 0; c < ch; ++c) {
    const float v = c == 0 ? d : (c <= k ? d * src(i, c) : msk);
    if (fo != nullptr) fo[c] = v;
    if (bo != nullptr) bo[c] = __float2bfloat16_rn(v);
  }
}

}  // namespace

extern "C" {

// (margins (S*8192,), pushes (T*16384, k+2)) from pw (T, SG, GS*C) i32, the
// pull table w (T*16384, k+2) f32, the f32 labels/mask rows and `spill`, the
// (S*8192, k+2) spill-pull grid or null. Scratch: the pulls' row index
// pull_index (S*8192 + 1 + S*nrun*8192 + S*8192/1024, nrun = ceil(T /
// tiles_per_run)) and the pushes' bucket index push_index (T*16384 + 1 + T)
// int32, one perm (T*SG*GS*C) int32 for both, pulls (S*8192, k+2) f32 and
// dvb (S*8192, k+2) bf16; dvf (S*8192, k+2) f32 receives the push rows when
// not null. Returns cudaGetLastError() after each launch,
// cudaErrorInvalidValue for a null scratch.
int wh_fm_step(const int32_t* pw, const float* w, const float* labels,
               const float* mask, const float* spill, int* pull_index,
               float* pulls, float* margins, __nv_bfloat16* dvb, float* dvf,
               int* push_index, int* perm, float* pushes, int T, int SG,
               int GS, int C, int k, int tiles_per_run, int loss,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ch = k + 2;
  int err = wh::launch_pulls_tile(pw, w, pull_index, perm, pulls, T, SG, GS,
                                  C, ch, tiles_per_run, st);
  if (err != 0) return err;
  const long long rows = (long long)SG * GS * wh::RSUB;
  fm_boundary<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      wh::RowPulls{pulls, spill, ch}, labels, mask, margins, dvb, dvf, rows,
      k, loss, 1);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return wh::launch_pushes_tile(pw, dvb, push_index, perm, pushes, T, SG, GS,
                                C, ch, st);
}

// The boundary alone from (rows, k+2) f32 pulls: margins, and with
// want_dual the f32 push rows dvf (rows, k+2).
int wh_fm_boundary(const float* pulls, const float* labels, const float* mask,
                   float* margins, float* dvf, long long rows, int k,
                   int loss, int want_dual, void* stream) {
  fm_boundary<<<(unsigned)((rows + 255) / 256), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      wh::RowPulls{pulls, nullptr, k + 2}, labels, mask, margins, nullptr,
      dvf, rows, k, loss, want_dual);
  return (int)cudaGetLastError();
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
