// Design variants of the tile forward (scripts/torch_tile_fwd_sweep.py),
// beside the shipped wh::launch_fwd of csrc/tile_fwd.cuh:
//
//   filter  one launch of row-span CTAs, each reading ALL of its subblock's
//           words and keeping those of its rows (the design first tried):
//           per window each warp filters a chunk into a queue, gathers
//           bf16(w) from device memory, bins the words by owner warp and
//           merges them with __match_any_sync, in word order (bitwise equal
//           to the plain version);
//   chunk   variant (c): chunk CTAs of 4 tiles owning all 8192 rows of a
//           subblock (the filter kernel with R = 8192 and 4 tiles a CTA),
//           the words binned by owner warp, each chunk's row sums written
//           to a partial slab and the slabs summed in chunk order by a
//           second launch. Not word order: held to the plain version
//           within 4·nnz·2^-24·Σ|w| per row.

// Built with -DWH_FWD_PHASES: the shipped design's fwd_rows adds its phase
// times into wh::fwd_phase_ns (sweep_phases reads and clears them).
#define WH_FWD_PHASES
#include "../wormhole_tpu_torch/ops/csrc/tile_fwd.cuh"

namespace sweep {

using namespace wh;

// The filter kernel's shared memory at R rows a CTA: the row sums, each
// warp's queue (u32 bucket, then packed value; u16 row) and the bins.
template <int NW, int U4>
constexpr int filter_smem(int R) {
  return ((R + 3) / 4) * 16 + NW * (128 * U4) * 10;
}

// CTA (x, s, z): rows [x*R, x*R + R) of subblock s = g*GS + j, over tiles
// [z*TZ, z*TZ + TZ) (all tiles, gridDim.z = 1, in the filter variant).
// epi(s, row in subblock, z, sum) receives each row's final sum.
template <int NW, int U4, class Epi>
__global__ void __launch_bounds__(NW * 32)
filter_rows(const int32_t* __restrict__ pw, const float* __restrict__ w,
            int T, int SG, int GS, int C, int R, int TZ, Epi epi) {
  static_assert(NW >= 2 && NW <= 32 && (NW & (NW - 1)) == 0, "NW");
  constexpr int CH = 128 * U4;                 // words a warp per window
  constexpr int WIN = NW * CH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  unsigned* queue = reinterpret_cast<unsigned*>(smem + ((R + 3) / 4) * 16);
  unsigned* bins = queue + NW * CH;
  unsigned short* qrow = reinterpret_cast<unsigned short*>(bins + WIN);
  __shared__ int cnt[NW][NW + 1];              // [warp][bin] this window
  __shared__ int cur[NW][NW + 1];              // [warp][bin] place cursors

  const int s = blockIdx.y, g = s / GS, j = s % GS;
  const int r0 = blockIdx.x * R;
  const int rn = min(R, RSUB - r0);            // rows of this CTA
  if (rn <= 0) return;
  const int tz0 = blockIdx.z * TZ;
  const int n = (min(T, tz0 + TZ) - tz0) * C;  // words of the stream
  const long long N = (long long)GS * C, W = (long long)SG * N;
  const int32_t* seg0 = pw + (long long)tz0 * W + g * N + (long long)j * C;
  const float* wz = w + (long long)tz0 * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // word x is kept when (x - lo) < span as u32: its row field (bits 16..28;
  // bits 29..31 are 0) lies in [r0, r0 + rn), the low half untouched
  const unsigned lo = (unsigned)r0 << 16, span = (unsigned)rn << 16;
  unsigned* q = queue + warp * CH;
  unsigned short* qr = qrow + warp * CH;

  for (int d = threadIdx.x; d < rn; d += blockDim.x) acc[d] = 0.f;
  if (lane < NW) cnt[warp][lane] = 0;

  // this warp's chunk of the window at w0: CH words from c0, in tile t at
  // offset off (C is a multiple of 128, so a 128-word group never crosses
  // a segment)
  int4 v[U4];
  auto load = [&](int w0, int& t, int& off) {
    const int c0 = w0 + warp * CH;
    t = c0 / C;
    off = c0 - t * C;
    int tt = t, oo = off;
#pragma unroll
    for (int u = 0; u < U4; ++u) {
      if (c0 + u * 128 < n) {
        v[u] = __ldg(reinterpret_cast<const int4*>(
            seg0 + (long long)tt * W + oo) + lane);
      } else {
        v[u] = make_int4(PAD_WORD, PAD_WORD, PAD_WORD, PAD_WORD);
      }
      oo += 128;
      if (oo == C) {
        oo = 0;
        ++tt;
      }
    }
  };
  int t, off;
  load(0, t, off);
  __syncthreads();

  for (int w0 = 0; w0 < n; w0 += WIN) {
    // 1. filter: the kept words of this warp's chunk, in word order
    //    ((group, lane, word) = word order), queued as (t << 14 | bucket)
    int kept = 0;
#pragma unroll
    for (int u = 0; u < U4; ++u) {
      const unsigned x[4] = {(unsigned)v[u].x, (unsigned)v[u].y,
                             (unsigned)v[u].z, (unsigned)v[u].w};
      bool k[4];
      unsigned m[4];
      int before = 0, total = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k[e] = (x[e] - lo) < span && (x[e] & 0xC000u) == 0u;   // hi < 128
        m[e] = __ballot_sync(FULL, k[e]);
        before += __popc(m[e] & below);
        total += __popc(m[e]);
      }
      int p = kept + before;
      const unsigned tb = (unsigned)t << 14;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k[e]) {
          q[p] = tb | (x[e] & 0x3FFFu);
          qr[p] = (unsigned short)((x[e] - lo) >> 16);
          ++p;
        }
      }
      kept += total;
      off += 128;
      if (off == C) {
        off = 0;
        ++t;
      }
    }
    if (w0 + WIN < n) load(w0 + WIN, t, off);   // in flight from here on
    __syncwarp();
    // gather bf16(w) of the kept words, then pack and count them per bin
    for (int i0 = 0; i0 < kept; i0 += 128) {
      float val[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * 32 + lane;
        val[e] = i < kept ? __ldg(wz + q[i]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * 32 + lane;
        if (i < kept) {
          const unsigned r = qr[i];
          q[i] = ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(val[e]))
                  << 16) | r;
          atomicAdd(&cnt[warp][r & (NW - 1)], 1);
        }
      }
    }
    __syncthreads();

    // 2. bin: lane b < NW reads bin b's counts; bin b's words start after
    //    bins 0..b-1 and after warps 0..warp-1's words of bin b
    int tot = 0, mine = 0;
    if (lane < NW) {
#pragma unroll 4
      for (int k = 0; k < NW; ++k) {
        const int c = cnt[k][lane];
        tot += c;
        if (k < warp) mine += c;
      }
    }
    int start = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, start, o);
      if (lane >= o) start += y;
    }
    start -= tot;                                // exclusive
    if (lane < NW) cur[warp][lane] = start + mine;
    const int my_start = __shfl_sync(FULL, start, warp);
    const int my_tot = __shfl_sync(FULL, tot, warp);
    __syncwarp();
    for (int i0 = 0; i0 < kept; i0 += 32) {
      const int i = i0 + lane;
      const bool live = i < kept;
      const unsigned e = live ? q[i] : 0u;
      const int bin = live ? (int)(e & (NW - 1)) : -1;
      const unsigned grp = __match_any_sync(FULL, bin);
      const int leader = __ffs(grp) - 1;
      int p = 0;
      if (live && lane == leader) {
        p = cur[warp][bin];
        cur[warp][bin] = p + __popc(grp);
      }
      p = __shfl_sync(FULL, p, leader);
      if (live) bins[p + __popc(grp & below)] = e;
    }
    __syncthreads();

    // 3. merge bin `warp` into its rows' sums, in word order
    if (lane < NW) cnt[warp][lane] = 0;          // counts read; next window
    const unsigned* b = bins + my_start;
    for (int i0 = 0; i0 < my_tot; i0 += 32) {
      const int i = i0 + lane;
      const bool live = i < my_tot;
      const int row = live ? (int)(b[i] & 0xFFFFu) : -1;
      const unsigned grp = __match_any_sync(FULL, row);
      if (live && lane == __ffs(grp) - 1) {
        float a = acc[row];
        for (unsigned mm = grp; mm; mm &= mm - 1u)
          a += __uint_as_float(b[i0 + __ffs(mm) - 1] & 0xFFFF0000u);
        acc[row] = a;
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < rn; d += blockDim.x)
    epi(s, r0 + d, (int)blockIdx.z, acc[d]);
}


struct FilterMargins {        // the filter variant: each row's margin
  float* margins;
  __device__ __forceinline__ void operator()(int s, int r, int,
                                             float m) const {
    margins[(long long)s * RSUB + r] = m;
  }
};

struct PartialSlab {          // variant (c): chunk z's sums of subblock s
  float* partial;
  int nz;
  __device__ __forceinline__ void operator()(int s, int r, int z,
                                             float m) const {
    partial[((long long)s * nz + z) * RSUB + r] = m;
  }
};

__global__ void combine(const float* __restrict__ partial,
                        float* __restrict__ margins, long long rows, int nz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const float* p = partial + (i / RSUB) * nz * RSUB + i % RSUB;
  float acc = 0.f;
  for (int z = 0; z < nz; ++z) acc += p[(long long)z * RSUB];
  margins[i] = acc;
}

template <class Epi>
int launch_filter(const int32_t* pw, const float* w, int T, int SG, int GS,
                  int C, int R, int TZ, const Epi& epi, cudaStream_t st) {
  constexpr int NW = 16, U4 = 8;
  const int smem = filter_smem<NW, U4>(R);
  cudaError_t e = cudaFuncSetAttribute(
      filter_rows<NW, U4, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((RSUB + R - 1) / R, SG * GS, (T + TZ - 1) / TZ);
  filter_rows<NW, U4, Epi><<<grid, NW * 32, smem, st>>>(pw, w, T, SG, GS, C,
                                                        R, TZ, epi);
  return (int)cudaGetLastError();
}

}  // namespace sweep

extern "C" {

// variant: 0 filter (R rows a CTA), 1 chunk + combine (tiles_per_cta tiles
// a CTA; partial is scratch of S * ceil(T / tiles_per_cta) * 8192 f32),
// 2.. the shipped design at (warps, 16-byte loads a lane in flight) =
// 2: (16, 16), 3: (16, 8) (shipped), 4: (8, 16), R rows a CTA, windows of
// at most cap words (0: as many as shared memory holds); scratch as
// wh_tile_fwd's (scratch_words u32).
int sweep_fwd(int variant, const int32_t* pw, const float* w,
              unsigned* scratch, long long scratch_words, float* partial,
              float* margins, int T, int SG, int GS, int C, int R,
              int tiles_per_cta, int cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const wh::FwdMargins out{margins};
  switch (variant) {
    case 0:
      return sweep::launch_filter(pw, w, T, SG, GS, C, R, T,
                                  sweep::FilterMargins{margins}, st);
    case 1: {
      const int nz = (T + tiles_per_cta - 1) / tiles_per_cta;
      int err = sweep::launch_filter(pw, w, T, SG, GS, C, wh::RSUB,
                                     tiles_per_cta,
                                     sweep::PartialSlab{partial, nz}, st);
      if (err != 0) return err;
      const long long rows = (long long)SG * GS * wh::RSUB;
      sweep::combine<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
          partial, margins, rows, nz);
      return (int)cudaGetLastError();
    }
    case 2:
      return wh::launch_fwd<16, 16>(pw, w, scratch, scratch_words, T, SG,
                                    GS, C, R, out, st, cap);
    case 3:
      return wh::launch_fwd<16, 8>(pw, w, scratch, scratch_words, T, SG,
                                   GS, C, R, out, st, cap);
    case 4:
      return wh::launch_fwd<8, 16>(pw, w, scratch, scratch_words, T, SG,
                                   GS, C, R, out, st, cap);
  }
  return (int)cudaErrorInvalidValue;
}

// Copies the phase sums of every fwd_rows launch since the last call (ns,
// over all CTAs) into out[6] and clears them; returns a CUDA error or 0.
int sweep_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, wh::fwd_phase_ns,
                                       sizeof(unsigned long long) * 6);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(wh::fwd_phase_ns, zero, sizeof(zero));
}

}  // extern "C"
