// Design variants of the tile backward (scripts/torch_tile_bwd_sweep.py),
// beside the shipped wh::launch_bwd of csrc/tile_bwd.cuh:
//
//   bins    the shipped design (bin_vals, then a warp per bin of a tile
//           summing its buckets in word order) at other bin sizes, warps a
//           CTA, buffer (window) sizes and loads a lane in flight: bitwise
//           equal to the plain version whatever the settings;
//   spans   the design as first laid out: a tile pass sorting each chunk by
//           bucket span (one ballot a span), then one CTA per (span of
//           16384 / P buckets, tile) that copies its span's runs, sorts them
//           stably by owner warp (level 1) and either by lane (level 2)
//           with each thread summing its own buckets, or merges each warp's
//           bin 32 words a round with __match_any_sync: the row spans of
//           csrc/tile_fwd.cuh turned to buckets (bitwise equal too). Its
//           phases add their %globaltimer time to span_phase_ns
//           (sweep_phases reads and clears them);
//   ftrl    the update step's backward (the FTRL update as the epilogue)
//           at bins of 512 and 256 buckets;
//   queue   the design before both, kept as a reference row: a pre-pass
//           writing each word's bf16 dual in word order, then one 512-thread
//           CTA per tile with a 64 KB bucket slab, every warp reading all of
//           the tile's words and queueing the ones it owns, merged 32 at a
//           time by __match_any_sync (also word order).
//
// Not part of the package.

#include "../wormhole_tpu_torch/ops/csrc/tile_bwd.cuh"

namespace sweep {

using namespace wh;

// ---------------------------------------------------------------------------
// spans: the span design
// ---------------------------------------------------------------------------

__device__ unsigned long long span_phase_ns[6];
__device__ __forceinline__ unsigned long long span_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SPAN_PHASE_START unsigned long long span_t0 = span_now();
#define SPAN_PHASE(i)                                       \
  if (threadIdx.x == 0) {                                   \
    const unsigned long long span_t = span_now();           \
    atomicAdd(&span_phase_ns[i], span_t - span_t0);         \
    span_t0 = span_t;                                       \
  }

constexpr int SV_WARPS = 8;          // chunks (warps) a bucket_vals CTA

// A span CTA's settings: NW warps (its level-1 bins), U 16-byte loads a lane
// in flight and CG lanes a chunk copying the span's runs, and whether a warp
// merges its bin (MERGE) or sorts it by lane (level 2).
template <int NW_, int U_, int CG_, bool MERGE_>
struct SpanCfg {
  static constexpr int NW = NW_, U = U_, CG = CG_;
  static constexpr bool MERGE = MERGE_;
};

// Bytes of the level-1 (17 ints a thread) or level-2 (33 u16 a thread)
// counters.
template <class Cfg>
__host__ __device__ constexpr int span_counter_bytes() {
  return ((Cfg::NW * 32 * 17 * 4 > Cfg::NW * 32 * 33 * 2
               ? Cfg::NW * 32 * 17 * 4
               : Cfg::NW * 32 * 33 * 2) +
          15) / 16 * 16;
}

template <class Cfg>
__host__ __device__ constexpr int span_sums_smem(int R, int cap) {
  return ((R + 3) / 4) * 16 + span_counter_bytes<Cfg>() + 2 * cap * 4;
}

// Warp `item` of the grid takes chunk ch of segment (t, s), item = (s*T +
// t)*nch + ch, and sorts its valid words stably by bucket span x = bucket >>
// (14 - log2 P): P ballots a 32-word group count them, and the same ballots
// rank each word in its span; offs[q*(P+1) + x] gets where span x starts,
// q = (t*S + s)*nch + ch.
template <int P, typename DualT>
__global__ void __launch_bounds__(SV_WARPS * 32)
bucket_vals(const int32_t* __restrict__ pw, const DualT* __restrict__ dual,
            unsigned* __restrict__ vals, unsigned short* __restrict__ offs,
            int T, int SG, int GS, int C) {
  static_assert(P >= 1 && P <= 16 && (P & (P - 1)) == 0, "P");
  constexpr int SH = P == 1 ? 14 : P == 2 ? 13 : P == 4 ? 12 : P == 8 ? 11
                                                                     : 10;
  const int S = SG * GS, nch = (C + 1023) / 1024;
  const long long item =
      (long long)blockIdx.x * SV_WARPS + (threadIdx.x >> 5);
  if (item >= (long long)T * S * nch) return;          // warp-uniform
  const int lane = threadIdx.x & 31;
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
  unsigned word[32];
  int run[P];
#pragma unroll
  for (int x = 0; x < P; ++x) run[x] = 0;
  // the chunk's words, counted by span
#pragma unroll
  for (int k = 0; k < 32; ++k)
    word[k] = k < nk ? (unsigned)__ldcs(pw + o + k * 32 + lane) : PAD_WORD;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int x = (word[k] & 0xC000u) == 0u                // hi < 128
                      ? (int)((word[k] & 0x3FFFu) >> SH) : P;
#pragma unroll
    for (int y = 0; y < P; ++y) run[y] += __popc(__ballot_sync(FULL, x == y));
  }
  // span starts: an exclusive scan of the counts (warp-uniform registers)
  int total = 0;
#pragma unroll
  for (int y = 0; y < P; ++y) {
    const int c = run[y];
    run[y] = total;
    total += c;
  }
  if (lane <= P) {
    int v = total;
#pragma unroll
    for (int y = 0; y < P; ++y)
      if (lane == y) v = run[y];
    offs[q * (P + 1) + lane] = (unsigned short)v;
  }
  // each valid word's dual gathered, 8 in flight, and its packed value
  // placed after the words of its span before it
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 8) {
    unsigned vb[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned w = word[k0 + u];
      vb[u] = (w & 0xC000u) == 0u ? dual_bits(dsub + (w >> 16)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned w = word[k0 + u];
      const bool valid = (w & 0xC000u) == 0u;
      const int x = valid ? (int)((w & 0x3FFFu) >> SH) : P;
      int pos = 0;
#pragma unroll
      for (int y = 0; y < P; ++y) {
        const unsigned m = __ballot_sync(FULL, x == y);
        if (x == y) pos = run[y] + __popc(m & below);
        run[y] += __popc(m);
      }
      if (valid) vals[o + pos] = (vb[u] << 16) | (w & 0x3FFFu);
    }
  }
}

// CTA (x, t): buckets [x*R, x*R + R) of tile t, in windows of at most cap
// words; warp k takes cpw chunks of a window, CG lanes copying a chunk's
// run. Bucket d of the span belongs to warp d % NW (level 1) and, with the
// level-2 sort, lane (d / NW) % 32.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::NW * 32)
span_sums(const unsigned* __restrict__ vals,
          const unsigned short* __restrict__ offs, float* __restrict__ grad,
          int SG, int GS, int C, int R, int cpw, int cap) {
  constexpr int NW = Cfg::NW, U = Cfg::U, CG = Cfg::CG;
  constexpr int NT = NW * 32;
  constexpr int SH1 = NW == 16 ? 4 : NW == 8 ? 3 : -1;  // wtot: NW / 2 <= 8
  static_assert(SH1 > 0, "NW");
  static_assert(CG >= 1 && CG <= 32 && (CG & (CG - 1)) == 0, "CG");
  extern __shared__ __align__(16) unsigned char span_smem[];
  float* acc = reinterpret_cast<float*>(span_smem);
  unsigned char* cnt_base = span_smem + ((R + 3) / 4) * 16;
  int* cnt1 = reinterpret_cast<int*>(cnt_base);               // [NT][17]
  unsigned short* cnt2 = reinterpret_cast<unsigned short*>(cnt_base);
  unsigned* queue =
      reinterpret_cast<unsigned*>(cnt_base + span_counter_bytes<Cfg>());
  unsigned* bins = queue + cap;
  __shared__ int red[NW];
  __shared__ int wtot[NW][8];                  // warp totals, packed pairs
  __shared__ int gt[8];

  const int NX = gridDim.x, nch = (C + 1023) / 1024;
  const int nq = SG * GS * nch;                 // chunks of the tile
  const int x = blockIdx.x, u = blockIdx.y;
  const int r0 = x * R;
  const int rn = R;                            // buckets of this CTA
  const long long N = (long long)GS * C, W = (long long)SG * N;
  const unsigned short* oq = offs + (long long)u * nq * (NX + 1) + x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int d = tid; d < rn; d += NT) acc[d] = 0.f;
  SPAN_PHASE_START

  for (int q0 = 0; q0 < nq;) {
    // a. warp k takes cpw (<= 32) chunks of the window, a lane each: the
    //    chunk's run of span words; the window takes the warps whose words
    //    fit cap (a prefix)
    const int qw = q0 + warp * cpw;              // the warp's first chunk
    int qa = 0, n = 0;
    if (lane < cpw && qw + lane < nq) {
      qa = __ldg(oq + (long long)(qw + lane) * (NX + 1));
      n = __ldg(oq + (long long)(qw + lane) * (NX + 1) + 1) - qa;
    }
    const int qincl = warp_incl(n, lane);
    const int c = __shfl_sync(FULL, qincl, 31);
    if (lane == 0) red[warp] = c;
    __syncthreads();
    SPAN_PHASE(0)
    int base = 0, kept = 0, taken = 0;
    for (int k = 0; k < NW; ++k) {
      const int v = red[k];
      if (k == warp) base = kept;
      if (kept + v > cap) break;
      kept += v;
      ++taken;
    }
    q0 += taken * cpw;
    //    the runs into the queue in word order: CG lanes copy one chunk's
    //    run (contiguous in vals; chunks start 512-byte aligned) with
    //    aligned 16-byte loads, U a lane in flight, to the warp's base plus
    //    the runs of the chunks below; each as (bf16 << 16 | local key)
    if (warp < taken) {                          // warp-uniform
      const int d0 = base + qincl - n - qa;      // queue[d0 + j], j in run
      const int ncp = min(cpw, nq - qw);         // the warp's chunks
      for (int j0 = 0; j0 < ncp; j0 += 32 / CG) {
        const int jl = j0 + lane / CG;           // < 32
        const int ca = __shfl_sync(FULL, qa, jl);
        const int cn = __shfl_sync(FULL, n, jl);
        const int cd = __shfl_sync(FULL, d0, jl);
        if (jl >= ncp || cn == 0) continue;
        const int cq = qw + jl, cs = cq / nch;   // its subblock
        const uint4* src = reinterpret_cast<const uint4*>(
            vals + u * W + (cs / GS) * N + (long long)(cs % GS) * C +
            (long long)(cq - cs * nch) * 1024);
        const int j1 = ca + cn;
        for (int v0 = (ca >> 2) + lane % CG; v0 * 4 < j1; v0 += CG * U) {
          uint4 v[U];
#pragma unroll
          for (int e = 0; e < U; ++e)
            v[e] = (v0 + e * CG) * 4 < j1 ? __ldg(src + v0 + e * CG)
                                          : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int e = 0; e < U; ++e) {
            const unsigned x4[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int j = (v0 + e * CG) * 4 + h;
              if (j >= ca && j < j1)
                queue[cd + j] = (x4[h] & 0xFFFF0000u) |
                                ((x4[h] & 0x3FFFu) - (unsigned)r0);
            }
          }
        }
      }
    }
    __syncthreads();
    SPAN_PHASE(1)

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
    SPAN_PHASE(2)
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
    SPAN_PHASE(3)
    int B = 0, TB = 0;                           // the warp's bin
#pragma unroll
    for (int b = 0; b < NW; ++b)
      if (b == warp) {
        B = kb[b];
        TB = ktot[b];
      }
    if constexpr (Cfg::MERGE) {
      // c. the warp's bin, 32 words a round in word order: lanes holding
      //    one bucket are merged by __match_any_sync, and the lowest of them
      //    adds their values into its sum in lane (= word) order
      for (int i0 = B; i0 < B + TB; i0 += 32) {
        const int d = i0 + lane < B + TB ? (int)(bins[i0 + lane] & 0xFFFFu)
                                         : -1;
        const unsigned grp = __match_any_sync(FULL, d);
        if (d >= 0 && lane == __ffs(grp) - 1) {
          float a = acc[d];
          for (unsigned m = grp; m; m &= m - 1u)
            a += __uint_as_float(bins[i0 + __ffs(m) - 1] & 0xFFFF0000u);
          acc[d] = a;
        }
        __syncwarp();
      }
      __syncthreads();
      SPAN_PHASE(5)
      continue;
    }

    //    level 2, in warp b's bin: by lane ((d / NW) % 32), lane chunks
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
    SPAN_PHASE(4)

    // c. this thread's bin, in word order, into its keys' sums
    const int d0 = warp + NW * lane;             // its first key
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
    SPAN_PHASE(5)
  }
  float* out = grad + (long long)u * TILE + r0;
  for (int d = tid; d < rn; d += NT) out[d] = acc[d];
}

template <class Cfg, int P>
int launch_spans(const int32_t* pw, const float* dual, unsigned* scratch,
                 long long scratch_words, float* grad, int T, int SG, int GS,
                 int C, int cap_limit, cudaStream_t st) {
  const int R = TILE / P, S = SG * GS, nch = (C + 1023) / 1024;
  if (scratch_words < span_scratch_words(T, SG, GS, C, P))
    return (int)cudaErrorInvalidValue;
  const long long chunks = (long long)T * S * nch;
  unsigned* vals = scratch;
  unsigned short* offs =
      reinterpret_cast<unsigned short*>(scratch + (long long)T * S * C);
  bucket_vals<P, float><<<(unsigned)((chunks + SV_WARPS - 1) / SV_WARPS),
                          SV_WARPS * 32, 0, st>>>(pw, dual, vals, offs, T,
                                                  SG, GS, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int cap = ((SMEM_MAX - 1024 - span_sums_smem<Cfg>(R, 0)) / 8) & ~31;
  if (cap_limit > 0) cap = min(cap, cap_limit & ~31);
  const int nq = S * nch;
  const int cpw = min(min((nq + Cfg::NW - 1) / Cfg::NW, cap / 1024), 32);
  const int smem = span_sums_smem<Cfg>(R, cap);
  e = cudaFuncSetAttribute(span_sums<Cfg>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  span_sums<Cfg><<<dim3(P, T), Cfg::NW * 32, smem, st>>>(
      vals, offs, grad, SG, GS, C, R, cpw, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// queue: the design before both
// ---------------------------------------------------------------------------

constexpr int QW = 16;                    // the queue design's warps a CTA
constexpr int QUEUE = 64;                 // its per-warp queue of owned words

// dv[i] = bf16(dual[row of word i]) over all words of pw, 0 for pad words
__global__ void gather_dual(const int32_t* __restrict__ pw,
                            const float* __restrict__ dual,
                            __nv_bfloat16* __restrict__ dv, long long nwords,
                            int SG, int GS, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nwords) return;
  const unsigned word = (unsigned)__ldg(pw + i);
  const long long N = (long long)GS * C;
  __nv_bfloat16 v = __float2bfloat16_rn(0.f);
  if (word_hi(word) < 128u) {
    const long long s = ((i / N) % SG) * GS + (i % N) / C;
    v = __float2bfloat16_rn(__ldg(dual + s * RSUB + word_row(word)));
  }
  dv[i] = v;
}

struct Queues {
  int bucket[QW][QUEUE];
  float val[QW][QUEUE];
};

// the queue's first n (<= 32) entries into the slab, lanes of one bucket
// merged by __match_any_sync and added by the group's leader in lane order
__device__ __forceinline__ void flush(Queues& q, int warp, int lane, int n,
                                      float* slab) {
  const bool live = lane < n;
  const int b = live ? q.bucket[warp][lane] : -1;
  const unsigned grp = __match_any_sync(FULL, b);
  if (live && (__ffs(grp) - 1) == lane) {
    float acc = slab[b];
    for (unsigned m = grp; m; m &= m - 1u) acc += q.val[warp][__ffs(m) - 1];
    slab[b] = acc;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(QW * 32)
queue_grad(const int32_t* __restrict__ pw,
           const __nv_bfloat16* __restrict__ dv, float* __restrict__ grad,
           int SG, int GS, int C) {
  extern __shared__ float slab[];
  __shared__ Queues q;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int N = GS * C;
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) slab[b] = 0.f;
  __syncthreads();
  int fill = 0;                                     // warp-uniform
  for (int g = 0; g < SG; ++g) {
    const long long off = ((long long)t * SG + g) * N;
    for (int c0 = 0; c0 < N; c0 += 32 * UNROLL) {
      int bucket[UNROLL];
      float val[UNROLL];
      bool mine[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        const unsigned word = c < N ? (unsigned)__ldg(pw + off + c) : PAD_WORD;
        bucket[u] = word_bucket(word);
        mine[u] = word_hi(word) < 128u && (bucket[u] >> 10) == warp;
        val[u] = mine[u] ? __bfloat162float(dv[off + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned m = __ballot_sync(FULL, mine[u]);
        if (mine[u]) {
          const int pos = fill + __popc(m & lanes_below);
          q.bucket[warp][pos] = bucket[u];
          q.val[warp][pos] = val[u];
        }
        fill += __popc(m);
        if (fill >= 32) {
          __syncwarp();
          flush(q, warp, lane, 32, slab);
          int b_tail = 0;
          float v_tail = 0.f;
          if (lane < fill - 32) {
            b_tail = q.bucket[warp][32 + lane];
            v_tail = q.val[warp][32 + lane];
          }
          __syncwarp();
          if (lane < fill - 32) {
            q.bucket[warp][lane] = b_tail;
            q.val[warp][lane] = v_tail;
          }
          __syncwarp();
          fill -= 32;
        }
      }
    }
  }
  __syncwarp();
  if (fill > 0) flush(q, warp, lane, fill, slab);
  __syncthreads();
  float* out = grad + (long long)t * TILE;
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) out[b] = slab[b];
}

int launch_queue(const int32_t* pw, const float* dual, __nv_bfloat16* dv,
                 float* grad, int T, int SG, int GS, int C, cudaStream_t st) {
  const long long nwords = (long long)T * SG * GS * C;
  gather_dual<<<(unsigned)((nwords + 255) / 256), 256, 0, st>>>(
      pw, dual, dv, nwords, SG, GS, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = TILE * (int)sizeof(float);
  e = cudaFuncSetAttribute(queue_grad,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  queue_grad<<<T, QW * 32, smem, st>>>(pw, dv, grad, SG, GS, C);
  return (int)cudaGetLastError();
}

}  // namespace sweep

extern "C" {

// variant: 0 the queue design (dv: one bf16 per word of pw); 1..7 and
// 11..14 the bins design at (buckets a bin, warps a bin_vals CTA, warps a
// bin_sums CTA, buffer words, loads a lane in flight) = 1: (256, 8, 8, 1024,
// 4), 2: (128, 8, 8, 1024, 4), 3: (512, 8, 8, 1024, 4) (shipped), 4: (256,
// 4, 4, 1024, 4), 5: (256, 8, 4, 2048, 4), 6: (256, 8, 8, 1024, 2), 7: (256,
// 8, 8, 1024, 8), 11: (512, 4, 4, 1024, 4), 12: (1024, 4, 4, 1024, 4), 13:
// (512, 4, 4, 2048, 4), 14: (512, 8, 4, 1024, 4); 8..10 the span design at
// 4 spans of 4096 buckets with (warps, 16-byte loads a lane in flight, lanes
// a chunk's copy, merge or level-2 sort) = 8: (16, 8, 16, level 2) (as
// first laid out), 9: (16, 8, 16, merge), 10: (8, 8, 16, merge), windows of
// at most 6,144 words. scratch (scratch_words u32) as wh_tile_bwd's, sized
// for the variant's bins or spans.
int sweep_bwd(int variant, const int32_t* pw, const float* dual,
              unsigned* scratch, long long scratch_words, __nv_bfloat16* dv,
              float* grad, int T, int SG, int GS, int C, void* stream) {
  using wh::BinCfg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = scratch_words;
#define BINS(...)                                                           \
  wh::launch_bwd<BinCfg<__VA_ARGS__>>(                                      \
      pw, dual, scratch, n, T, SG, GS, C, BinCfg<__VA_ARGS__>::NBIN,        \
      wh::BwdGrad<BinCfg<__VA_ARGS__>>{grad}, st)
  switch (variant) {
    case 0:
      return sweep::launch_queue(pw, dual, dv, grad, T, SG, GS, C, st);
    case 1: return BINS(8, 8, 8, 1024, 4);
    case 2: return BINS(7, 8, 8, 1024, 4);
    case 3: return BINS(9, 8, 8, 1024, 4);
    case 4: return BINS(8, 4, 4, 1024, 4);
    case 5: return BINS(8, 8, 4, 2048, 4);
    case 6: return BINS(8, 8, 8, 1024, 2);
    case 7: return BINS(8, 8, 8, 1024, 8);
    case 11: return BINS(9, 4, 4, 1024, 4);
    case 12: return BINS(10, 4, 4, 1024, 4);
    case 13: return BINS(9, 4, 4, 2048, 4);
    case 14: return BINS(9, 8, 4, 1024, 4);
    case 8:
      return sweep::launch_spans<sweep::SpanCfg<16, 8, 16, false>, 4>(
          pw, dual, scratch, n, grad, T, SG, GS, C, 6144, st);
    case 9:
      return sweep::launch_spans<sweep::SpanCfg<16, 8, 16, true>, 4>(
          pw, dual, scratch, n, grad, T, SG, GS, C, 6144, st);
    case 10:
      return sweep::launch_spans<sweep::SpanCfg<8, 8, 16, true>, 4>(
          pw, dual, scratch, n, grad, T, SG, GS, C, 6144, st);
  }
#undef BINS
  return (int)cudaErrorInvalidValue;
}

// The update step's backward (bin_vals, then bin_sums with the FTRL
// epilogue, in place on the w/z/cg planes) at bins of 512 buckets (variant
// 0, shipped) or 256 (1). wdelta2 holds T * 64 floats.
int sweep_ftrl(int variant, const int32_t* pw, const float* dual,
               unsigned* scratch, long long scratch_words, float* w,
               float* z, float* cg, float* wdelta2, int T, int SG, int GS,
               int C, void* stream) {
  using B9 = wh::BinCfg<9, 8, 8, 1024, 4>;
  using B8 = wh::BinCfg<8, 8, 8, 1024, 4>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const wh::Ftrl p{0.1f, 1.f, 0.5f, 0.1f};
  if (variant == 0)
    return wh::launch_bwd<B9>(pw, dual, scratch, scratch_words, T, SG, GS,
                              C, B9::NBIN,
                              wh::BwdFtrl<B9>{w, z, cg, wdelta2, p}, st);
  return wh::launch_bwd<B8>(pw, dual, scratch, scratch_words, T, SG, GS, C,
                            B8::NBIN, wh::BwdFtrl<B8>{w, z, cg, wdelta2, p},
                            st);
}

// Copies the phase sums of every span_sums launch since the last call (ns,
// over all CTAs) into out[6] and clears them; returns a CUDA error or 0.
int sweep_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sweep::span_phase_ns,
                                       sizeof(unsigned long long) * 6);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(sweep::span_phase_ns, zero, sizeof(zero));
}

}  // extern "C"
