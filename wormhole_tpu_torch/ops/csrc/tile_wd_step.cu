// The wide&deep train step on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_make_wd_step_kernel` (:1590, built
// by `_build_wd_step_fused` :1662, pallas_call :1705): wh_wd_step. The TPU
// ran the MLP forward and its vjp inside that kernel's boundary phase
// (:1622-1652); here they are hand-written too. wh_wd_boundary exports the
// same boundary alone, which the split path and the eval margin launch
// after forward_pulls, so split and fused run the same device code and
// agree bitwise (slots, MLP, accumulators, metrics).
//
// The phases are back-to-back launches on one stream:
//   1. the pulls (tile_multi.cuh launch_pulls_tile: the row index, then one
//      segmented sum) over ch_in = 1+k channels [w, v_1..v_k] into a (rows,
//      1+k) f32 grid, each (row, channel) summed in word order;
//   2. wd_rows: one thread per row reads its pulls, runs the MLP forward
//      (h @ W + b, ReLU between layers; deep = the one output),
//      margin = wide + deep, the dual, and the vjp down to the pooled
//      input. It writes the bf16 push grid [dual, g_pooled_1..k, mask]
//      and keeps every layer's input activation and output cotangent, in
//      column-major scratch, for:
//   3. wd_param_partial + wd_param_combine: each parameter's gradient,
//      Σ_rows activation·cotangent, as per-chunk partial sums over 512-row
//      chunks, then one fixed-order combine: deterministic, no atomics;
//   4. the pushes (tile_multi.cuh launch_pushes_tile: the bucket index,
//      then one segmented sum) over ch_out = k+2 channels; the bucket index
//      reuses the pulls' perm buffer, dead once phase 1 has run.
// The weights sit in shared memory when they fit in 48 KB (3,201 floats,
// 12.8 KB, at k 16 and hidden (64, 32)); otherwise the kernels read them
// through L2. Any hidden widths run; there is no size-based fallback.
//
// What bounds it: bytes. Per full-width block at k = 16: the words twice,
// the sectors of the (nb, 17) f32 pull table (285 MB) the block reaches and
// the (nb, 18) f32 pushes (302 MB). The MLP is about 1.8 GFLOP per
// 98,304-row block for forward and backward, 0.027 ms at the f32 peak. The
// two indexes, the pulls grid and the MLP's activation scratch are this
// design's extra traffic.

#include "tile_math.cuh"
#include "tile_multi.cuh"

namespace {

constexpr int WD_CHUNK_ROWS = 512;   // rows per parameter-gradient partial
constexpr int WD_SMEM_MAX = 48 * 1024;

// Layer l's weight offset in the flat parameter vector [W0, b0, W1, b1, ...]
__device__ __forceinline__ int layer_off(const int* sizes, int l) {
  int off = 0;
  for (int j = 0; j < l; ++j) off += sizes[j] * sizes[j + 1] + sizes[j + 1];
  return off;
}

// Column-major scratch: layer l's input activation h_l starts at column
// hcol(l) = Σ_{j<l} s_j; its output cotangent gz_{l+1} at gcol(l) =
// Σ_{j<l} s_{j+1}.
__device__ __forceinline__ int hcol(const int* sizes, int l) {
  int c = 0;
  for (int j = 0; j < l; ++j) c += sizes[j];
  return c;
}

__device__ __forceinline__ int gcol(const int* sizes, int l) {
  int c = 0;
  for (int j = 0; j < l; ++j) c += sizes[j + 1];
  return c;
}

template <class Src>
__global__ void wd_rows(Src src, const float* __restrict__ labels,
                        const float* __restrict__ mask,
                        const float* __restrict__ params,
                        const int* __restrict__ sizes, int L, int P,
                        int use_smem, float* __restrict__ acts,
                        float* __restrict__ gz, float* __restrict__ margins,
                        __nv_bfloat16* __restrict__ dvb,
                        float* __restrict__ dvf, long long rows, int loss,
                        int want_grad) {
  extern __shared__ float sp[];
  if (use_smem) {
    for (int p = threadIdx.x; p < P; p += blockDim.x) sp[p] = params[p];
    __syncthreads();
  }
  const float* prm = use_smem ? sp : params;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int k = sizes[0];
  // forward: h_0 = the pooled pulls; z_{l+1} = h_l @ W_l + b_l
  for (int a = 0; a < k; ++a) acts[(long long)a * rows + i] = src(i, 1 + a);
  float deep = 0.f;
  for (int l = 0; l < L; ++l) {
    const int sa = sizes[l], sb = sizes[l + 1];
    const float* W = prm + layer_off(sizes, l);
    const float* B = W + sa * sb;
    const float* h = acts + (long long)hcol(sizes, l) * rows + i;
    float* hn = acts + (long long)hcol(sizes, l + 1) * rows + i;
    for (int b = 0; b < sb; ++b) {
      float acc = 0.f;
      for (int a = 0; a < sa; ++a) acc += h[(long long)a * rows] * W[a * sb + b];
      const float z = acc + B[b];
      if (l + 1 < L)
        hn[(long long)b * rows] = z > 0.f ? z : 0.f;
      else if (b == 0)
        deep = z;
    }
  }
  const float m = src(i, 0) + deep;
  margins[i] = m;
  if (!want_grad) return;
  const float msk = mask[i];
  const float d = wh::loss_dual(loss, m, labels[i], msk);
  const int ch = k + 2;
  float* fo = dvf == nullptr ? nullptr : dvf + i * ch;
  __nv_bfloat16* bo = dvb == nullptr ? nullptr : dvb + i * ch;
  // backward: gz_L = [dual]; gh_l = W_l gz_{l+1}; gz_l = gh_l · [h_l > 0]
  float* gL = gz + (long long)gcol(sizes, L - 1) * rows + i;
  for (int b = 0; b < sizes[L]; ++b) gL[(long long)b * rows] = b == 0 ? d : 0.f;
  for (int l = L - 1; l >= 0; --l) {
    const int sa = sizes[l], sb = sizes[l + 1];
    const float* W = prm + layer_off(sizes, l);
    const float* g = gz + (long long)gcol(sizes, l) * rows + i;
    const float* h = acts + (long long)hcol(sizes, l) * rows + i;
    float* gp = l > 0 ? gz + (long long)gcol(sizes, l - 1) * rows + i
                      : nullptr;
    for (int a = 0; a < sa; ++a) {
      float acc = 0.f;
      for (int b = 0; b < sb; ++b) acc += W[a * sb + b] * g[(long long)b * rows];
      if (l > 0) {
        gp[(long long)a * rows] = h[(long long)a * rows] > 0.f ? acc : 0.f;
      } else {
        if (fo != nullptr) fo[1 + a] = acc;
        if (bo != nullptr) bo[1 + a] = __float2bfloat16_rn(acc);
      }
    }
  }
  if (fo != nullptr) {
    fo[0] = d;
    fo[ch - 1] = msk;
  }
  if (bo != nullptr) {
    bo[0] = __float2bfloat16_rn(d);
    bo[ch - 1] = __float2bfloat16_rn(msk);
  }
}

// Parameter p's gradient over the rows of one chunk: W_l[a, b] takes
// h_l[a]·gz_{l+1}[b], b_l[b] takes gz_{l+1}[b]. Warp w takes the parameters
// p = w, w + warps, ...; lane i sums rows r0 + i, r0 + i + 32, ... in row
// order, so a warp's loads are consecutive rows of one column, then a fixed
// butterfly adds the lanes.
__global__ void wd_param_partial(const int* __restrict__ sizes, int L, int P,
                                 const float* __restrict__ acts,
                                 const float* __restrict__ gz,
                                 float* __restrict__ part, long long rows) {
  const long long r0 = (long long)blockIdx.x * WD_CHUNK_ROWS;
  const long long r1 = min(rows, r0 + WD_CHUNK_ROWS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < P; p += blockDim.x >> 5) {
    int l = 0, off = 0;
    while (off + sizes[l] * sizes[l + 1] + sizes[l + 1] <= p) {
      off += sizes[l] * sizes[l + 1] + sizes[l + 1];
      ++l;
    }
    const int sa = sizes[l], sb = sizes[l + 1];
    const int e = p - off;
    const bool bias = e >= sa * sb;
    const int a = bias ? 0 : e / sb;
    const int b = bias ? e - sa * sb : e % sb;
    const float* g = gz + (long long)(gcol(sizes, l) + b) * rows;
    const float* h = acts + (long long)(hcol(sizes, l) + a) * rows;
    float acc = 0.f;
    if (bias) {
      for (long long r = r0 + lane; r < r1; r += 32) acc += g[r];
    } else {
      for (long long r = r0 + lane; r < r1; r += 32) acc += h[r] * g[r];
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(wh::FULL, acc, o);
    if (lane == 0) part[(long long)blockIdx.x * P + p] = acc;
  }
}

__global__ void wd_param_combine(const float* __restrict__ part,
                                 float* __restrict__ grad, int P,
                                 int nchunk) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float acc = 0.f;
  for (int c = 0; c < nchunk; ++c) acc += part[(long long)c * P + p];
  grad[p] = acc;
}

template <class Src>
int boundary(Src src, const float* labels, const float* mask,
             const float* params, const int* sizes, int L, int P, float* acts,
             float* gz, float* gpart, float* margins, __nv_bfloat16* dvb,
             float* dvf, float* gparams, long long rows, int loss,
             int want_grad, cudaStream_t st) {
  const int use_smem = P * (int)sizeof(float) <= WD_SMEM_MAX;
  const int smem = use_smem ? P * (int)sizeof(float) : 0;
  wd_rows<<<(unsigned)((rows + 127) / 128), 128, smem, st>>>(
      src, labels, mask, params, sizes, L, P, use_smem, acts, gz, margins,
      dvb, dvf, rows, loss, want_grad);
  int err = (int)cudaGetLastError();
  if (err != 0 || !want_grad) return err;
  const int nchunk = (int)((rows + WD_CHUNK_ROWS - 1) / WD_CHUNK_ROWS);
  wd_param_partial<<<nchunk, 256, 0, st>>>(sizes, L, P, acts, gz, gpart,
                                           rows);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  wd_param_combine<<<(P + 255) / 256, 256, 0, st>>>(gpart, gparams, P,
                                                     nchunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (margins (S*8192,), pushes (T*16384, k+2), gparams (P,)) from pw (T, SG,
// GS*C) i32, the pull table w (T*16384, 1+k) f32, the f32 labels/mask rows
// and the flat f32 MLP parameters [W0, b0, W1, b1, ...] (P floats) with
// layer sizes `sizes` (L+1 device ints, sizes[0] = k, sizes[L] = 1).
// Scratch: the pulls' row index pull_index (S*8192 + 1 + S*nrun*8192 +
// S*8192/1024, nrun = ceil(T / tiles_per_run)) and the pushes' bucket index
// push_index (T*16384 + 1 + T) int32, one perm (T*SG*GS*C) int32 for both,
// pulls (S*8192, 1+k) f32, acts (Σ_{l<L} s_l, rows) f32, gz (Σ_{l<L}
// s_{l+1}, rows) f32, gpart (ceil(rows/512), P) f32 and dvb (rows, k+2)
// bf16. Returns cudaGetLastError() after each launch, cudaErrorInvalidValue
// for a null scratch.
int wh_wd_step(const int32_t* pw, const float* w, const float* labels,
               const float* mask, const float* params, const int* sizes,
               int L, int P, int* pull_index, float* pulls, float* acts,
               float* gz, float* gpart, float* margins, __nv_bfloat16* dvb,
               float* gparams, int* push_index, int* perm, float* pushes,
               int T, int SG, int GS, int C, int k, int tiles_per_run,
               int loss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = wh::launch_pulls_tile(pw, w, pull_index, perm, pulls, T, SG, GS,
                                  C, k + 1, tiles_per_run, st);
  if (err != 0) return err;
  const long long rows = (long long)SG * GS * wh::RSUB;
  err = boundary(wh::RowPulls{pulls, nullptr, k + 1}, labels, mask, params,
                 sizes, L, P, acts, gz, gpart, margins, dvb, nullptr,
                 gparams, rows, loss, 1, st);
  if (err != 0) return err;
  return wh::launch_pushes_tile(pw, dvb, push_index, perm, pushes, T, SG, GS,
                                C, k + 2, st);
}

// The boundary alone from (rows, 1+k) f32 pulls: margins, and with
// want_grad the f32 push rows dvf (rows, k+2) and gparams (P,).
int wh_wd_boundary(const float* pulls, const float* labels,
                   const float* mask, const float* params, const int* sizes,
                   int L, int P, int k, float* acts, float* gz, float* gpart,
                   float* margins, float* dvf, float* gparams,
                   long long rows, int loss, int want_grad, void* stream) {
  return boundary(wh::RowPulls{pulls, nullptr, k + 1}, labels, mask, params,
                  sizes, L, P, acts, gz, gpart, margins, nullptr, dvf,
                  gparams, rows, loss, want_grad,
                  static_cast<cudaStream_t>(stream));
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
