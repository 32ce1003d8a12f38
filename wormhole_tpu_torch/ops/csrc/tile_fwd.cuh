// Device code of the tile forward margins, shared by tile_fwd.cu (the
// forward alone) and tile_step.cu (the forward as phase 1 of a train step,
// with the step's boundary as its epilogue).
//
// For every packed pair word of one crec2 block it computes
//
//     margin[s*8192 + rhi*128 + rlo] += bf16(w[t*16384 + hi*128 + lo])
//
// accumulated in f32, where word fields are lo = bits 0..6, hi = 7..15,
// rlo = 16..22, rhi = 23..28, and words with hi >= 128 (the pad word
// 511 << 7) add nothing. w is rounded to bf16 round-to-nearest-even, as the
// TPU kernel's operand is (wormhole_tpu/ops/tilemm.py `_build_fwd` :581).
//
// Row spans. CTA (x, s) of fwd_rows owns rows [x*R, x*R + R) of subblock s
// outright and sums each of them from 0.f, left to right, in word order:
// the (tile, slot) order of the subblock's T segments, the order
// tilemm.forward_margins_plain sums in. No float atomics and no partial
// slabs: every run gives the same bits, equal to the plain version's. Two
// launches:
//   1. fwd_tile_vals, one CTA per tile: the tile's w slice in shared
//      memory, every word of the tile read once; each valid word's packed
//      value (bf16(w) << 16 | row) is written back, each 1024-word chunk of
//      a segment sorted stably by span, with the span starts per chunk.
//      The w gather is a shared-memory read, and no CTA of 2. has to find
//      its rows among other rows' words (a CTA that filtered its whole
//      subblock spent its time in that filter, PERF.md).
//   2. fwd_rows, per window of up to `cap` words (shared memory):
//      a. copies the span's run of every chunk, chunks in order, into the
//         window's queue: the span's words in word order;
//      b. sorts the queue stably by owner thread in two levels of
//         per-thread chunks, so no lanes need ranking against each other:
//         by warp (local row % NW), then within the warp's bin by lane;
//      c. each thread adds its bin, in order, into its rows' f32 sums,
//         which live across windows.
//      After the last window the epilogue gets each row's final sum: the
//      margin store (tile_fwd.cu) or the train step's boundary
//      (tile_step.cu).
//
// Traffic per full-width criteo block (2^22 buckets, 12 subblocks, cap
// 1408, 98,304 rows; 11 spans of 745 rows on an H100's 132 SMs), against
// the byte bound's 34.5 MB (17.3 MB of words, 16.8 MB of w, 0.39 MB of
// margins): 1. reads the words and w once and writes the packed values
// (17.3 MB) and the span starts (0.15 MB); 2. reads the packed values once
// and writes the margins. The shared-memory sort of 2. and the latency of
// its sequential per-thread loops, not the bytes, set the time (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wh {

constexpr int TILE = 16384;          // buckets per tile (128 x 128)
constexpr int RSUB = 8192;           // rows per subblock (64 x 128)
constexpr int UNROLL = 8;            // 32-word batches in flight per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PAD_WORD = 511u << 7;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int word_row(unsigned word) {
  return (int)((((word >> 23) & 63u) << 7) | ((word >> 16) & 127u));
}

__device__ __forceinline__ unsigned word_hi(unsigned word) {
  return (word >> 7) & 511u;
}

__device__ __forceinline__ int word_bucket(unsigned word) {
  return (int)((word_hi(word) << 7) | (word & 127u));
}

// The shipped forward (scripts/torch_tile_fwd_sweep.py)
constexpr int VAL_WARPS = 8;         // warps a fwd_tile_vals CTA
constexpr int ROW_WARPS = 16;        // warps a fwd_rows CTA: its row bins
constexpr int ROW_U = 8;             // 16-byte loads a lane in flight
constexpr int SMEM_MAX = 232448;     // shared memory a CTA may hold (227 KB)

// Phase times of fwd_rows for scripts/torch_tile_fwd_sweep.cu, which
// builds with -DWH_FWD_PHASES: thread 0 of each CTA adds the %globaltimer
// nanoseconds of each phase (the window's counts, the copy, level 1's counts
// and scans, its placement, level 2, the sums) into fwd_phase_ns. Other
// builds compile the marks to nothing.
#ifdef WH_FWD_PHASES
__device__ unsigned long long fwd_phase_ns[6];
__device__ __forceinline__ unsigned long long fwd_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FWD_PHASE_START unsigned long long fwd_t0 = fwd_now();
#define FWD_PHASE(i)                                        \
  if (threadIdx.x == 0) {                                   \
    const unsigned long long fwd_t = fwd_now();             \
    atomicAdd(&fwd_phase_ns[i], fwd_t - fwd_t0);            \
    fwd_t0 = fwd_t;                                         \
  }
#else
#define FWD_PHASE_START
#define FWD_PHASE(i)
#endif

// Inclusive prefix over the warp of one int a lane.
__device__ __forceinline__ int warp_incl(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// ---------------------------------------------------------------------------
// 1. the tile pass
// ---------------------------------------------------------------------------

// CTA t: tile t's w slice (64 KB) in shared memory, then every word of tile
// t, all subblocks, read once, a warp taking one 1024-word chunk (32
// groups) of one segment at a time. Each valid word's packed value
// (bf16(w[bucket]) << 16 | row in subblock) goes to the chunk's place in
// vals (laid out as pw), the chunk's words sorted stably by span: span x =
// row / R, as __umulhi(row, magic) with magic = ceil(2^32 / R), exact for
// row, R < 2^13. offs[q*(NR+1) + x] (u16) gets where span x starts in
// chunk q = (s*T + t)*nch + ch, and offs[q*(NR+1) + NR] the chunk's valid
// words. Within a group, lanes of one span are ranked by __match_any_sync;
// across groups, a running count per span.
__global__ void __launch_bounds__(VAL_WARPS * 32)
fwd_tile_vals(const int32_t* __restrict__ pw, const float* __restrict__ w,
              unsigned* __restrict__ vals, unsigned short* __restrict__ offs,
              int T, int SG, int GS, int C, int NR, unsigned magic) {
  extern __shared__ __align__(16) float wt[];   // TILE, stages, counts
  const int t = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned* stage = reinterpret_cast<unsigned*>(wt + TILE) + warp * 1024;
  int* cnt = reinterpret_cast<int*>(wt + TILE + VAL_WARPS * 1024) +
             warp * (NR + 1);
  const float4* wt4 = reinterpret_cast<const float4*>(w + (long long)t * TILE);
  for (int i = tid; i < TILE / 4; i += VAL_WARPS * 32)
    reinterpret_cast<float4*>(wt)[i] = __ldcs(wt4 + i);
  __syncthreads();
  const int S = SG * GS, nch = (C + 1023) / 1024;
  const long long N = (long long)GS * C;
  for (int item = warp; item < S * nch; item += VAL_WARPS) {
    const int s = item / nch, ch = item - s * nch;
    const int nk = min(32, C / 32 - ch * 32);
    const long long o = ((long long)t * SG + s / GS) * N +
                        (long long)(s % GS) * C + ch * 1024;
    for (int x = lane; x < NR; x += 32) cnt[x] = 0;
    __syncwarp();
    unsigned val[32];
    int pos[32];
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 8) {
      if (k0 >= nk) break;                           // warp-uniform
      unsigned word[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        word[u] = k0 + u < nk ? (unsigned)__ldcs(pw + o + (k0 + u) * 32 + lane)
                              : PAD_WORD;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + u;
        const bool valid = (word[u] & 0xC000u) == 0u;  // hi < 128
        const unsigned row = word[u] >> 16;
        const int x = valid ? (int)__umulhi(row, magic) : -1;
        val[k] = ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(
                     wt[word[u] & 0x3FFFu])) << 16) | row;
        const unsigned grp = __match_any_sync(FULL, x);
        const int leader = __ffs(grp) - 1;
        int b = 0;
        if (valid && lane == leader) {
          b = cnt[x];
          cnt[x] = b + __popc(grp);
        }
        b = __shfl_sync(FULL, b, leader);
        pos[k] = valid ? b + __popc(grp & below) : -1;
        __syncwarp();
      }
    }
    // span starts: an exclusive scan of the counts, 32 spans at a time
    unsigned short* out =
        offs + ((long long)(s * T + t) * nch + ch) * (NR + 1);
    int run = 0;
    for (int x0 = 0; x0 < NR; x0 += 32) {
      const int x = x0 + lane;
      const int v = x < NR ? cnt[x] : 0;
      const int incl = warp_incl(v, lane);
      if (x < NR) {
        cnt[x] = run + incl - v;
        out[x] = (unsigned short)(run + incl - v);
      }
      run += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) out[NR] = (unsigned short)run;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < nk && pos[k] >= 0)
        stage[cnt[__umulhi(val[k] & 0x1FFFu, magic)] + pos[k]] = val[k];
    __syncwarp();
    for (int i = lane; i < run; i += 32) vals[o + i] = stage[i];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// 2. the row spans
// ---------------------------------------------------------------------------

// Shared memory of fwd_rows<NW> at R rows a CTA and windows of cap words:
// the row sums, the sort's counters, and the window's queue and bins.
template <int NW>
__host__ __device__ constexpr int fwd_rows_smem(int R, int cap) {
  return ((R + 3) / 4) * 16 +
         ((NW * 32 * 17 * 4 > NW * 32 * 33 * 2 ? NW * 32 * 17 * 4
                                                : NW * 32 * 33 * 2) +
          15) / 16 * 16 +
         2 * cap * 4;
}

// CTA (x, s): rows [x*R, x*R + R) of subblock s = g*GS + j, from the tile
// pass's packed values and span starts, in windows of at most `cap` words;
// warp k takes cpw chunks of a window. The span's local row d belongs to
// thread (warp d % NW, lane (d / NW) % 32): its bin. epi(s, row in
// subblock, sum) receives each row's final sum.
template <int NW, int U, class Epi>
__global__ void __launch_bounds__(NW * 32)
fwd_rows(const unsigned* __restrict__ vals,
         const unsigned short* __restrict__ offs, int T, int SG, int GS,
         int C, int R, int cpw, int cap, Epi epi) {
  constexpr int NT = NW * 32;
  constexpr int SH1 = NW == 16 ? 4 : NW == 8 ? 3 : NW == 32 ? 5 : -1;
  static_assert(SH1 > 0, "NW");
  extern __shared__ __align__(16) unsigned char rows_smem[];
  float* acc = reinterpret_cast<float*>(rows_smem);
  unsigned char* cnt_base = rows_smem + ((R + 3) / 4) * 16;
  int* cnt1 = reinterpret_cast<int*>(cnt_base);               // [NT][17]
  unsigned short* cnt2 = reinterpret_cast<unsigned short*>(cnt_base);
  unsigned* queue = reinterpret_cast<unsigned*>(
      cnt_base + fwd_rows_smem<NW>(0, 0));
  unsigned* bins = queue + cap;
  __shared__ int red[NW];
  __shared__ int wtot[NW][8];                  // warp totals, packed pairs
  __shared__ int gt[8];

  const int NR = gridDim.x, nch = (C + 1023) / 1024, nq = T * nch;
  const int x = blockIdx.x, s = blockIdx.y;
  const int r0 = x * R;
  const int rn = min(R, RSUB - r0);            // rows of this CTA
  if (rn <= 0) return;
  const long long N = (long long)GS * C, W = (long long)SG * N;
  const unsigned* vseg0 = vals + (s / GS) * N + (long long)(s % GS) * C;
  const unsigned short* oq = offs + (long long)s * nq * (NR + 1) + x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int d = tid; d < rn; d += NT) acc[d] = 0.f;
  FWD_PHASE_START

  for (int q0 = 0; q0 < nq;) {
    // a. warp k takes cpw (<= 32) chunks of the window, a lane each: the
    //    chunk's run of span words; the window takes the warps whose words
    //    fit cap (a prefix)
    const int q = q0 + warp * cpw + lane;
    int qa = 0, n = 0;
    if (lane < cpw && q < nq) {
      qa = __ldg(oq + (long long)q * (NR + 1));
      n = __ldg(oq + (long long)q * (NR + 1) + 1) - qa;
    }
    const int qincl = warp_incl(n, lane);
    const int c = __shfl_sync(FULL, qincl, 31);
    if (lane == 0) red[warp] = c;
    __syncthreads();
    FWD_PHASE(0)
    int base = 0, kept = 0, taken = 0;
    for (int k = 0; k < NW; ++k) {
      const int v = red[k];
      if (k == warp) base = kept;
      if (kept + v > cap) break;
      kept += v;
      ++taken;
    }
    q0 += taken * cpw;
    //    the runs into the queue in word order: lane l copies its chunk's
    //    run (contiguous in vals; chunks start 4 KB aligned) with aligned
    //    16-byte loads, U in flight, to the warp's base plus the runs of
    //    the lanes below; each as (bf16 << 16 | local row)
    if (warp < taken && n > 0) {
      const int tq = q / nch;
      const uint4* src = reinterpret_cast<const uint4*>(
          vseg0 + tq * W + (long long)(q - tq * nch) * 1024);
      const int d0 = base + qincl - n - qa;       // queue[d0 + j], j in run
      const int j1 = qa + n;
      for (int v0 = qa >> 2; v0 * 4 < j1; v0 += U) {
        uint4 v[U];
#pragma unroll
        for (int e = 0; e < U; ++e)
          v[e] = (v0 + e) * 4 < j1 ? __ldg(src + v0 + e)
                                   : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const unsigned x4[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = (v0 + e) * 4 + h;
            if (j >= qa && j < j1)
              queue[d0 + j] = (x4[h] & 0xFFFF0000u) |
                              ((x4[h] & 0x1FFFu) - (unsigned)r0);
          }
        }
      }
    }
    __syncthreads();
    FWD_PHASE(1)

    // b. a stable sort of the window by owner thread, in two levels of
    //    per-thread chunks (no cross-lane ordering needed): level 1 by
    //    warp (d % NW): thread t's chunk counted, cursors bin-major, placed
    const int c0 = kept * tid / NT, c1 = kept * (tid + 1) / NT;
    int* my1 = cnt1 + tid * 17;
    // the chunk's counts in registers, one byte a bin (a chunk holds at
    // most cap / NT < 256 words)
    unsigned c8[NW / 4];
#pragma unroll
    for (int h = 0; h < NW / 4; ++h) c8[h] = 0u;
    for (int i = c0; i < c1; ++i) {
      const unsigned b = queue[i] & (NW - 1);
#pragma unroll
      for (int h = 0; h < NW / 4; ++h)
        c8[h] += (b >> 2) == (unsigned)h ? 1u << ((b & 3u) * 8) : 0u;
    }
    int pk[NW / 2], incl[NW / 2];
#pragma unroll
    for (int h = 0; h < NW / 2; ++h) {
      pk[h] = (int)((c8[h / 2] >> ((h & 1) * 16)) & 0xFFu) |
              (int)(((c8[h / 2] >> ((h & 1) * 16 + 8)) & 0xFFu) << 16);
      incl[h] = warp_incl(pk[h], lane);
      if (lane == 31) wtot[warp][h] = incl[h];
    }
    __syncthreads();
    FWD_PHASE(2)
    if (tid < NW / 2) {
      int run = 0;
      for (int k = 0; k < NW; ++k) {
        const int v = wtot[k][tid];
        wtot[k][tid] = run;
        run += v;
      }
      gt[tid] = run;
    }
    __syncthreads();
    int kb[NW], ktot[NW];
    {
      int run = 0;
#pragma unroll
      for (int h = 0; h < NW / 2; ++h) {
        const int g2 = gt[h];
        ktot[2 * h] = g2 & 0xFFFF;
        ktot[2 * h + 1] = g2 >> 16;
      }
#pragma unroll
      for (int b = 0; b < NW; ++b) {
        kb[b] = run;
        run += ktot[b];
      }
#pragma unroll
      for (int h = 0; h < NW / 2; ++h) {
        const int ex = incl[h] - pk[h] + wtot[warp][h];
        my1[2 * h] = kb[2 * h] + (ex & 0xFFFF);
        my1[2 * h + 1] = kb[2 * h + 1] + (ex >> 16);
      }
    }
    for (int i = c0; i < c1; ++i) {
      const unsigned e = queue[i];
      bins[my1[e & (NW - 1)]++] = e;
    }
    __syncthreads();
    FWD_PHASE(3)

    //    level 2, in warp b's bin: by lane ((d / NW) % 32), lane chunks
    int B = 0, TB = 0;
#pragma unroll
    for (int b = 0; b < NW; ++b)
      if (b == warp) {
        B = kb[b];
        TB = ktot[b];
      }
    unsigned short* my2 = cnt2 + (warp * 32 + lane) * 33;
    const int l0 = B + TB * lane / 32, l1 = B + TB * (lane + 1) / 32;
#pragma unroll
    for (int k = 0; k < 32; ++k) my2[k] = 0;
    for (int i = l0; i < l1; ++i) ++my2[(bins[i] >> SH1) & 31];
    __syncwarp();
    unsigned short* col = cnt2 + warp * 32 * 33 + lane;   // key `lane`
    int tot = 0;
    for (int l = 0; l < 32; ++l) tot += col[l * 33];
    const int kbase = warp_incl(tot, lane) - tot;
    {
      int run = B + kbase;
      for (int l = 0; l < 32; ++l) {
        const int v = col[l * 33];
        col[l * 33] = (unsigned short)(run - B);
        run += v;
      }
    }
    __syncwarp();
    for (int i = l0; i < l1; ++i) {
      const unsigned e = bins[i];
      queue[B + my2[(e >> SH1) & 31]++] = e;
    }
    __syncwarp();
    FWD_PHASE(4)

    // c. this thread's bin, in word order, into its rows' sums
    const int d0 = warp + NW * lane;             // its first row
    float a0 = d0 < rn ? acc[d0] : 0.f;
    float a1 = d0 + NT < rn ? acc[d0 + NT] : 0.f;
    for (int i = B + kbase; i < B + kbase + tot; ++i) {
      const unsigned e = queue[i];
      const int d = (int)(e & 0xFFFFu);
      const float v = __uint_as_float(e & 0xFFFF0000u);
      if (d == d0) {
        a0 += v;
      } else if (d == d0 + NT) {
        a1 += v;
      } else {
        acc[d] += v;
      }
    }
    if (d0 < rn) acc[d0] = a0;
    if (d0 + NT < rn) acc[d0 + NT] = a1;
    __syncthreads();
    FWD_PHASE(5)
  }
  for (int d = tid; d < rn; d += NT) epi(s, r0 + d, acc[d]);
}

// u32 words of the scratch of a tile pass that sorts each 1024-word chunk
// into NX spans (the forward's row spans, the backward's bins): one packed
// value per word of pw, then the u16 span starts of every chunk.
__host__ __device__ inline long long span_scratch_words(int T, int SG,
                                                        int GS, int C,
                                                        int NX) {
  const long long S = (long long)SG * GS, nch = (C + 1023) / 1024;
  return (long long)T * S * C + (S * T * nch * (NX + 1) + 1) / 2;
}

// Launch 1. and 2. on `st` with R rows a CTA. scratch (scratch_words u32)
// holds vals (one u32 per word of pw) then the chunk offsets (S * T *
// ceil(C/1024) * (ceil(8192/R) + 1) u16). A window holds as many words as
// the shared memory left over from the row sums and counters; each warp's
// chunks are sized so that one window covers the subblock when its words
// fit; cap_limit > 0 caps a window lower (the design sweep). Returns
// cudaGetLastError() after each launch (0 = success), or
// cudaErrorInvalidValue for a missing or too small scratch or a bad span.
template <int NW, int U, class Epi>
inline int launch_fwd(const int32_t* pw, const float* w, unsigned* scratch,
                      long long scratch_words, int T, int SG, int GS, int C,
                      int R, const Epi& epi, cudaStream_t st,
                      int cap_limit = 0) {
  if (scratch == nullptr || R < 2 || R > RSUB || C % 128 != 0 ||
      C >= 65536)
    return (int)cudaErrorInvalidValue;
  const int NR = (RSUB + R - 1) / R, S = SG * GS, nch = (C + 1023) / 1024;
  if (scratch_words < span_scratch_words(T, SG, GS, C, NR))
    return (int)cudaErrorInvalidValue;
  unsigned* vals = scratch;
  unsigned short* offs =
      reinterpret_cast<unsigned short*>(scratch + (long long)T * S * C);
  const unsigned magic =
      (unsigned)(((1ull << 32) + (unsigned long long)R - 1) / R);
  const int vsmem = (TILE + VAL_WARPS * 1024 + VAL_WARPS * (NR + 1)) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_tile_vals, cudaFuncAttributeMaxDynamicSharedMemorySize, vsmem);
  if (e != cudaSuccess) return (int)e;
  fwd_tile_vals<<<T, VAL_WARPS * 32, vsmem, st>>>(pw, w, vals, offs, T, SG,
                                                  GS, C, NR, magic);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int cap = ((SMEM_MAX - 1024 - fwd_rows_smem<NW>(R, 0)) / 8) & ~31;
  if (cap_limit > 0) cap = min(cap, cap_limit & ~31);
  const int nq = T * nch;
  const int cpw = min(min((nq + NW - 1) / NW, cap / 1024), 32);
  if (cpw < 1) return (int)cudaErrorInvalidValue;
  const int smem = fwd_rows_smem<NW>(R, cap);
  e = cudaFuncSetAttribute(fwd_rows<NW, U, Epi>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fwd_rows<NW, U, Epi><<<dim3(NR, S), NW * 32, smem, st>>>(
      vals, offs, T, SG, GS, C, R, cpw, cap, epi);
  return (int)cudaGetLastError();
}

// The forward alone: each row's sum is its margin.
struct FwdMargins {
  float* margins;
  __device__ __forceinline__ void operator()(int s, int r, float m) const {
    margins[(long long)s * RSUB + r] = m;
  }
};

}  // namespace wh
