// Device code of the tile backward, shared by tile_bwd.cu (the split path's
// gradient) and tile_step.cu (phase 2 of both fused train steps).
//
// For every packed pair word of one crec2 block it computes
//
//     grad[t*16384 + hi*128 + lo] += bf16(dual[s*8192 + rhi*128 + rlo])
//
// accumulated in f32 from 0.f, left to right in word order: (tile, group,
// slot), so a tile's subblocks in order, as tilemm.backward_grad_plain sums.
// Pad words (hi >= 128) add nothing. The words of tile t lie at pw[t, g, :]
// for g = 0..SG-1, with subblock s = g*GS + slot / C, so the kernel never
// depends on the TPU's `fuse` (K) re-view. The dual is rounded to bf16 as
// the TPU's operand is (tilemm.py:641, and :1228 in the fused kernel).
//
// Bins. A tile's 16384 buckets are cut into 32 bins of 512; one warp owns a
// bin outright and sums each of its buckets from 0.f in word order. No
// float atomics and no partial slabs, so every run gives the same bits,
// equal to the plain version's, and the split path and both fused steps
// run this same code. Two launches:
//   1. bin_vals, one warp per 1024-word chunk of a segment: every word read
//      once, its row's dual gathered (the split path's f32 dual rounded to
//      bf16, or the fused steps' bf16 dual grid read as is: L2-resident
//      either way), and one packed u32 (bf16 dual << 16 | bucket in tile)
//      written per valid word, the chunk sorted stably by bin, with the bin
//      starts per chunk. A 32-word group's lanes of one bin are found with
//      6 ballots (one a bit of the bin), not __match_any_sync;
//   2. bin_sums, one warp per (tile, bin), 8 a CTA: it copies its run of
//      each of the tile's chunks, chunks in order, a lane a chunk (about 18
//      words each at full width), into its buffer: its words in word order.
//      It merges them 32 a round into its 512 sums in shared memory: the
//      lanes of one bucket are found with 9 ballots and the lowest adds
//      their values in lane order. Its epilogue writes the bin's gradient
//      (BwdGrad) or, in the fused update step (tile_step.cu), runs the FTRL
//      update on the bin's slice of the w/z/cg planes in place (BwdFtrl).
// Nothing waits on a CTA barrier: a bin's words are few (about 420 at full
// width, 0.8 a bucket), and a design that sorted a 4096-bucket span's words
// across a CTA spent its time in the sort's fixed costs and barriers
// (scripts/torch_tile_bwd_sweep.py, PERF.md).

#pragma once

#include "tile_fwd.cuh"
#include "tile_math.cuh"

namespace wh {

// A backward's settings: 2^SHIFT buckets a bin, VW warps (chunks) a bin_vals
// CTA, SW warps (bins) a bin_sums CTA, CAP words a bin warp's buffer (at
// least a chunk's 1024), L loads a lane in flight copying its run.
template <int SHIFT_, int VW_, int SW_, int CAP_, int L_>
struct BinCfg {
  static constexpr int SHIFT = SHIFT_, VW = VW_, SW = SW_, CAP = CAP_;
  static constexpr int L = L_;
  static constexpr int KEYS = 1 << SHIFT;          // buckets a bin
  static constexpr int NBIN = TILE >> SHIFT;       // bins a tile
  static constexpr int BITS = 15 - SHIFT;          // a bin id and the pad
  static_assert(SHIFT >= 5 && SHIFT <= 13 && CAP >= 1024, "BinCfg");
};

// The shipped backward (scripts/torch_tile_bwd_sweep.py)
using BwdBins = BinCfg<9, 8, 8, 1024, 4>;
constexpr int NBIN = BwdBins::NBIN;    // bins a tile (tilemm.BWD_SPANS)
constexpr int BIN_KEYS = BwdBins::KEYS;

// bf16 bits of a dual value: the f32 dual rounded, or the bf16 grid as is
__device__ __forceinline__ unsigned dual_bits(const float* p) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(p)));
}

__device__ __forceinline__ unsigned dual_bits(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(__ldg(p));
}

// Warp `item` of the grid takes chunk ch of segment (t, s), item = (s*T +
// t)*nch + ch, so a CTA's warps gather from one subblock's dual. It writes
// the packed values of the chunk's valid words to their place in vals (laid
// out as pw), sorted stably by bin, and the bin starts to offs[q*(NBIN+1) +
// bin], the chunk's valid words to offs[q*(NBIN+1) + NBIN], q = (t*S +
// s)*nch + ch: a tile's chunks subblock by subblock. A running count per
// bin carries the ranks across 32-word groups.
template <class Cfg, typename DualT>
__global__ void __launch_bounds__(Cfg::VW * 32)
bin_vals(const int32_t* __restrict__ pw, const DualT* __restrict__ dual,
         unsigned* __restrict__ vals, unsigned short* __restrict__ offs,
         int T, int SG, int GS, int C) {
  constexpr int NB = Cfg::NBIN;
  __shared__ unsigned stage_all[Cfg::VW][1024];
  __shared__ int cnt_all[Cfg::VW][NB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = SG * GS, nch = (C + 1023) / 1024;
  const long long item = (long long)blockIdx.x * Cfg::VW + warp;
  if (item >= (long long)T * S * nch) return;          // warp-uniform
  const unsigned below = (1u << lane) - 1u;
  const int ch = (int)(item % nch);
  const long long st = item / nch;                     // s*T + t
  const int s = (int)(st / T);
  const long long t = st - (long long)s * T;
  const long long q = (t * S + s) * nch + ch;
  const int nk = min(32, C / 32 - ch * 32);            // 32-word groups
  const long long o = (t * SG + s / GS) * GS * C + (long long)(s % GS) * C +
                      ch * 1024;
  const DualT* dsub = dual + (long long)s * RSUB;
  unsigned* stage = stage_all[warp];
  int* cnt = cnt_all[warp];
  for (int b = lane; b < NB; b += 32) cnt[b] = 0;
  __syncwarp();
  unsigned val[32];
  int pos[32];
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 8) {
    if (k0 >= nk) break;                               // warp-uniform
    unsigned word[8], vb[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      word[u] = k0 + u < nk ? (unsigned)__ldcs(pw + o + (k0 + u) * 32 + lane)
                            : PAD_WORD;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      vb[u] = (word[u] & 0xC000u) == 0u ? dual_bits(dsub + (word[u] >> 16))
                                        : 0u;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u;
      const bool valid = (word[u] & 0xC000u) == 0u;    // hi < 128
      const int bin = valid ? (int)((word[u] & 0x3FFFu) >> Cfg::SHIFT) : NB;
      unsigned peers = FULL;                           // lanes of this bin
#pragma unroll
      for (int b = 0; b < Cfg::BITS; ++b) {
        const unsigned m = __ballot_sync(FULL, (bin >> b) & 1);
        peers &= (bin >> b) & 1 ? m : ~m;
      }
      const int base = valid ? cnt[bin] : 0;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) cnt[bin] = base + __popc(peers);
      __syncwarp();
      val[k] = (vb[u] << 16) | (word[u] & 0x3FFFu);
      pos[k] = valid ? base + __popc(peers & below) : -1;
    }
  }
  // bin starts: an exclusive scan of the counts, 32 bins at a time
  unsigned short* out = offs + q * (NB + 1);
  int run = 0;
  for (int b0 = 0; b0 < NB; b0 += 32) {
    const int b = b0 + lane;
    const int v = b < NB ? cnt[b] : 0;
    const int incl = warp_incl(v, lane);
    __syncwarp();
    if (b < NB) {
      cnt[b] = run + incl - v;
      out[b] = (unsigned short)(run + incl - v);
    }
    run += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) out[NB] = (unsigned short)run;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < nk && pos[k] >= 0)
      stage[cnt[(val[k] & 0x3FFFu) >> Cfg::SHIFT] + pos[k]] = val[k];
  __syncwarp();
  for (int i = lane; i < run; i += 32) vals[o + i] = stage[i];
}

// A bin warp's buffered words (n, in word order) into its sums: 32 words a
// round; the lanes of one bucket are found with SHIFT ballots, and the
// lowest of them adds their values in lane (= word) order.
template <class Cfg>
__device__ __forceinline__ void bin_merge(const unsigned* buf, int n,
                                          float* acc, int lane) {
  for (int i0 = 0; i0 < n; i0 += 32) {
    const bool live = i0 + lane < n;
    const unsigned e = live ? buf[i0 + lane] : 0u;
    const int d = (int)(e & (Cfg::KEYS - 1));
    unsigned peers = __ballot_sync(FULL, live);
#pragma unroll
    for (int b = 0; b < Cfg::SHIFT; ++b) {
      const unsigned m = __ballot_sync(FULL, (d >> b) & 1);
      peers &= (d >> b) & 1 ? m : ~m;
    }
    if (live && lane == __ffs(peers) - 1) {
      float a = acc[d];
      for (unsigned m = peers; m; m &= m - 1u)
        a += __uint_as_float(buf[i0 + __ffs(m) - 1] & 0xFFFF0000u);
      acc[d] = a;
    }
    __syncwarp();
  }
}

// Warp (t, bin) of the grid: buckets [bin*KEYS, bin*KEYS + KEYS) of tile t.
// Its run of each of the tile's chunks, chunks in word order, a lane a
// chunk, into its buffer (merged and emptied whenever the next run would
// not fit), then epi(t, bin, sums in shared memory), whose loop over the
// bin's buckets is its own.
template <class Cfg, class Epi>
__global__ void __launch_bounds__(Cfg::SW * 32)
bin_sums(const unsigned* __restrict__ vals,
         const unsigned short* __restrict__ offs, int T, int SG, int GS,
         int C, Epi epi) {
  constexpr int NB = Cfg::NBIN, L = Cfg::L;
  __shared__ float acc_all[Cfg::SW][Cfg::KEYS];
  __shared__ unsigned buf_all[Cfg::SW][Cfg::CAP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * Cfg::SW + warp;
  if (wid >= (long long)T * NB) return;                // warp-uniform
  const int bin = (int)(wid % NB);
  const long long t = wid / NB;
  float* acc = acc_all[warp];
  unsigned* buf = buf_all[warp];
  for (int d = lane; d < Cfg::KEYS; d += 32) acc[d] = 0.f;
  const int S = SG * GS, nch = (C + 1023) / 1024, nq = S * nch;
  const long long N = (long long)GS * C, W = (long long)SG * N;
  const unsigned short* oq = offs + t * nq * (NB + 1) + bin;
  int fill = 0;                                        // warp-uniform
  for (int g0 = 0; g0 < nq; g0 += 32) {
    const int q = g0 + lane;
    int a = 0, n = 0;
    if (q < nq) {
      a = __ldg(oq + (long long)q * (NB + 1));
      n = __ldg(oq + (long long)q * (NB + 1) + 1) - a;
    }
    for (int j0 = 0; j0 < 32;) {
      // the runs of chunks j0.. that fit the buffer after `fill`
      const int incl = warp_incl(lane >= j0 ? n : 0, lane);
      const unsigned fit =
          __ballot_sync(FULL, lane >= j0 && fill + incl <= Cfg::CAP);
      const int j1 = fit ? 32 - __clz(fit) : j0;
      if (lane >= j0 && lane < j1 && n > 0) {
        const int cs = q / nch;
        const unsigned* src = vals + t * W + (cs / GS) * N +
                              (long long)(cs % GS) * C +
                              (long long)(q - cs * nch) * 1024 + a;
        unsigned* dst = buf + fill + incl - n;
        for (int i = 0; i < n; i += L) {
          unsigned v[L];
#pragma unroll
          for (int e = 0; e < L; ++e)
            v[e] = i + e < n ? __ldg(src + i + e) : 0u;
#pragma unroll
          for (int e = 0; e < L; ++e)
            if (i + e < n) dst[i + e] = v[e];
        }
      }
      if (j1 > j0) fill += __shfl_sync(FULL, incl, j1 - 1);
      j0 = j1;
      if (j0 < 32) {                                   // the buffer is full
        __syncwarp();
        bin_merge<Cfg>(buf, fill, acc, lane);
        fill = 0;
      }
    }
  }
  __syncwarp();
  bin_merge<Cfg>(buf, fill, acc, lane);
  __syncwarp();
  epi(t, bin, acc);
}

// Launch bin_vals and bin_sums on `st` with epilogue epi(t, bin, sums).
// dual is the block's (S*8192,) f32 dual or bf16 dual grid; scratch
// (scratch_words u32) holds the packed values (one u32 per word of pw), then
// the bin starts (T * S * ceil(C/1024) * (NBIN + 1) u16). `spans`, the
// caller's bins a tile, must be Cfg::NBIN. Returns cudaGetLastError() after
// each launch (0 = success), or cudaErrorInvalidValue for operands it cannot
// take.
template <class Cfg, class DualT, class Epi>
inline int launch_bwd(const int32_t* pw, const DualT* dual, unsigned* scratch,
                      long long scratch_words, int T, int SG, int GS, int C,
                      int spans, const Epi& epi, cudaStream_t st) {
  if (scratch == nullptr || spans != Cfg::NBIN || C % 128 != 0 ||
      C >= 65536 || T < 1 || SG < 1 || GS < 1 ||
      scratch_words < span_scratch_words(T, SG, GS, C, Cfg::NBIN))
    return (int)cudaErrorInvalidValue;
  const long long S = (long long)SG * GS;
  const long long chunks = T * S * ((C + 1023) / 1024);
  unsigned* vals = scratch;
  unsigned short* offs =
      reinterpret_cast<unsigned short*>(scratch + T * S * C);
  bin_vals<Cfg, DualT><<<(unsigned)((chunks + Cfg::VW - 1) / Cfg::VW),
                         Cfg::VW * 32, 0, st>>>(pw, dual, vals, offs, T, SG,
                                                GS, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long bins = T * (long long)Cfg::NBIN;
  bin_sums<Cfg, Epi><<<(unsigned)((bins + Cfg::SW - 1) / Cfg::SW),
                       Cfg::SW * 32, 0, st>>>(vals, offs, T, SG, GS, C, epi);
  return (int)cudaGetLastError();
}

// The gradient alone: each bucket's sum, written once.
template <class Cfg>
struct BwdGrad {
  float* grad;
  __device__ __forceinline__ void operator()(long long t, int bin,
                                             const float* sums) const {
    float* out = grad + t * TILE + bin * Cfg::KEYS;
    for (int d = threadIdx.x & 31; d < Cfg::KEYS; d += 32) out[d] = sums[d];
  }
};

// The fused update step's epilogue (tile_step.cu): the FTRL update of bin
// `bin` of tile t, in place on its w/z/cg plane slices, from the bin's
// gradient in shared memory; its Σ(w' - w)² goes to wdelta2[t * NBIN +
// bin].
template <class Cfg>
struct BwdFtrl {
  float* w;
  float* z;
  float* cg;
  float* wdelta2;
  Ftrl p;
  __device__ __forceinline__ void operator()(long long t, int bin,
                                             const float* grad) const {
    const long long o = t * TILE + bin * Cfg::KEYS;
    ftrl_warp(p, grad, w + o, z + o, cg + o, wdelta2 + t * Cfg::NBIN + bin,
              Cfg::KEYS);
  }
};

}  // namespace wh
