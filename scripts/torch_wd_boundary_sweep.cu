// Design variants of the wide&deep MLP boundary
// (scripts/torch_wd_boundary_sweep.py), beside the shipped
// wh::launch_wd_boundary of wormhole_tpu_torch/ops/csrc/tile_wd.cuh:
//
//   tile    the shipped design (a CTA a span of rows, walked in tiles of
//           32·TR rows whose activations and cotangents stay in shared
//           memory, then the combine of the spans' sums) at other tile
//           rows, warps a CTA, tile placements (shared memory or a
//           device-memory region a CTA, gt), weight placements (shared
//           memory or L1) and spans: each row's margin and push row the
//           same bits whatever the settings, the parameter gradients the
//           same bits for the same span; each phase of its CTAs adds its
//           time to wd_phase_ns (sweep_phases reads them);
//   rowthread the design it replaced, kept as a reference row: one thread
//           a row writing every layer's activation and cotangent to
//           column-major device-memory scratch, then one warp a parameter
//           re-reading two columns of each 512-row chunk, then a combine
//           (each row's sums in the same order, so margins and push rows
//           are the same bits).
//
// Not part of the package.

// each phase of a wd_tile CTA adds its %globaltimer ns (thread 0, at the
// barrier that ends it) to wd_phase_ns; sweep_phases reads and clears them
__device__ unsigned long long wd_phase_ns[8];
__device__ __forceinline__ unsigned long long wd_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define WD_PHASE_START unsigned long long wd_t0 = wd_now();
#define WD_PHASE(i)                                     \
  if (threadIdx.x == 0) {                               \
    const unsigned long long wd_t = wd_now();           \
    atomicAdd(&wd_phase_ns[i], wd_t - wd_t0);           \
    wd_t0 = wd_t;                                       \
  }

#include "../wormhole_tpu_torch/ops/csrc/tile_multi.cuh"
#include "../wormhole_tpu_torch/ops/csrc/tile_wd.cuh"

namespace rowthread {

using namespace wh;

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


}  // namespace rowthread

namespace {

// The variant's layout: the tile in shared memory or (GT) in device memory,
// the weights where wsmem says, the span's sums in shared memory where they
// fit; {0, ...} where it does not fit.
wh::WdCfg variant_cfg(const wh::WdDims& d, int tr, int gt, int wsmem) {
  wh::WdCfg c{tr, wsmem, 1, gt};
  if (wh::wd_smem_bytes(d, c) > wh::WD_SMEM_MAX) c.asmem = 0;
  if (wh::wd_smem_bytes(d, c) > wh::WD_SMEM_MAX) c.tr = 0;
  return c;
}

template <int TR, int NW, bool GT>
int tile_variant(const float* pulls, const float* labels, const float* mask,
                 const float* params, const wh::WdDims& d, int wsmem,
                 float* tiles, float* part, float* margins, float* dvf,
                 float* gparams, long long rows, int span, int loss,
                 cudaStream_t st) {
  const wh::WdCfg c = variant_cfg(d, TR, GT, wsmem);
  if (c.tr == 0 || (GT && tiles == nullptr))
    return (int)cudaErrorInvalidValue;
  int err = wh::launch_wd_tile<TR, NW, GT>(pulls, labels, mask, params, d,
                                           c, tiles, part, margins, nullptr,
                                           dvf, rows, span, loss, 1, st);
  if (err != 0) return err;
  return wh::launch_wd_combine(part, gparams, d.P, rows, span, st);
}

}  // namespace

extern "C" {

// Floats of the device-memory tiles of variant (tr, gt) over `rows` rows:
// 0 without gt, -1 for bad widths (sizes: L+1 host ints, L <= 8).
long long sweep_tiles(int tr, int gt, const int* sizes, int L, long long P,
                      long long rows, int span) {
  wh::WdDims d;
  if (!wh::wd_dims(sizes, nullptr, L, P, sizes[0], &d)) return -1;
  return wh::wd_tiles_floats(d, wh::WdCfg{tr, 0, 0, gt}, rows, span);
}

// The shipped design at TR (1, 2, 4), NW (4, 8) warps, the tile in shared
// memory or (gt) in `tiles`, and the weights in shared memory (wsmem) or
// read through L1 (the span's sums in shared memory where they fit beside
// the rest, else in part), over spans of `span` rows: margins, f32 push
// rows dvf and gparams through part (ceil(rows / span), P). sizes: L+1
// host ints, L <= 8.
int sweep_tile(int tr, int nw, int gt, int wsmem, const float* pulls,
               const float* labels, const float* mask, const float* params,
               const int* sizes, int L, long long P, float* tiles,
               float* part, float* margins, float* dvf, float* gparams,
               long long rows, int span, int loss, void* stream) {
  wh::WdDims d;
  if (!wh::wd_dims(sizes, nullptr, L, P, sizes[0], &d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WD_CASE(TR, NW, GT)                                                 \
  if (tr == TR && nw == NW && gt == GT)                                     \
    return tile_variant<TR, NW, GT>(pulls, labels, mask, params, d, wsmem,  \
                                    tiles, part, margins, dvf, gparams,     \
                                    rows, span, loss, st);
  WD_CASE(4, 8, 0)
  WD_CASE(2, 8, 0)
  WD_CASE(1, 8, 0)
  WD_CASE(4, 4, 0)
  WD_CASE(2, 4, 0)
  WD_CASE(4, 8, 1)
  WD_CASE(2, 8, 1)
  WD_CASE(1, 8, 1)
#undef WD_CASE
  return (int)cudaErrorInvalidValue;
}

// Copies the phase counters of the instrumented variants (timed = 1) to
// host `out` (8 ns sums) and clears them.
int sweep_phases(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, wd_phase_ns, sizeof(wd_phase_ns));
  if (err != 0) return err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(wd_phase_ns, zero, sizeof(zero));
}

// The row-thread design: sizes are L+1 device ints; acts (Σ_{l<L} s_l,
// rows), gz (Σ_{l<L} s_{l+1}, rows) and gpart (ceil(rows / 512), P) f32
// scratch.
int sweep_rowthread(const float* pulls, const float* labels,
                    const float* mask, const float* params, const int* sizes,
                    int L, int P, int k, float* acts, float* gz,
                    float* gpart, float* margins, float* dvf,
                    float* gparams, long long rows, int loss, void* stream) {
  return rowthread::boundary(wh::RowPulls{pulls, nullptr, k + 1}, labels,
                             mask, params, sizes, L, P, acts, gz, gpart,
                             margins, nullptr, dvf, gparams, rows, loss, 1,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
