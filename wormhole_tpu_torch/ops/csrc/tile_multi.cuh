// Device code of the multi-channel tile pulls and pushes, shared by
// tile_multi.cu (forward_pulls / backward_pushes alone) and the fused FM and
// wide&deep steps (tile_fm_step.cu, tile_wd_step.cu).
//
// Pulls (rows, ch) f32: for every packed pair word of one crec2 block
//
//     pulls[s*8192 + row, c] += bf16(w[t*16384 + bucket, c])   c < ch
//
// Pushes (nb, ch) f32: for every pair word
//
//     pushes[t*16384 + bucket, c] += bf16(dvals[s*8192 + row, c])
//
// Both accumulate in f32; pad words (hi >= 128) add nothing. Per channel
// these are tile_fwd's and tile_bwd's functions.
//
// Pulls: shared memory is the constraint. A whole subblock's row slab is
// 32·ch KB (320 KB at ch 10), past the 227 KB a CTA may hold, so the pulls
// split the channels into groups of PULL_CG = 4, a 128 KB (8192 rows x 4)
// slab per CTA, grid (tile chunks, subblocks, channel groups), with
// tile_fwd's warp-owned rows and __match_any_sync merge. Every word is read
// once per channel group (3x at ch 10, 5x at ch 17). The partial-slab
// scratch is (S, nchunk, 8192, ch) f32; the caller picks nchunk so that
// nchunk·ch <= 128, about 50 MB at full width whatever ch is (tile_fwd's 64
// chunks at ch 1 would be 430 MB at ch 17).
//
// Pushes: no slab. A tile's bucket slab would be 64·ch KB (1,152 KB at
// ch 18), and splitting the channels over CTAs makes each CTA re-read all
// of the tile's words (PERF.md). Instead a CSR index of the block's words
// by bucket, built once per call whatever ch is, and one segmented sum over
// all channels that writes each output once (see push_index below). The
// values come from a (rows, ch) bf16 row grid (3.5 MB at ch 18, resident in
// the 50 MB L2).
//
// Determinism: each (row, channel) of the pulls is summed in word order by
// the one warp that owns it and chunk slabs are combined in chunk order;
// each (bucket, channel) of the pushes is summed in word order by one
// thread. No float atomics, so every run gives the same bits.

#pragma once

#include "tile_fwd.cuh"

namespace wh {

constexpr int PULL_CG = 4;                        // channels per pulls CTA
constexpr int PULL_SMEM = RSUB * PULL_CG * (int)sizeof(float);   // 128 KB

// Pass 1 of the pulls: CTA (chunk, s, group) sums its chunk's tiles into a
// private slab of 8192 rows x PULL_CG channels ([row * PULL_CG + c]), then
// writes it to partial[s][chunk][row][c0 + c].
__global__ void __launch_bounds__(FWD_WARPS * 32)
tile_pulls_partial(const int32_t* __restrict__ pw, const float* __restrict__ w,
                   float* __restrict__ partial, int T, int SG, int GS, int C,
                   int ch, int tiles_per_chunk, int nchunk) {
  extern __shared__ float slab[];
  __shared__ float stage[FWD_WARPS][32][PULL_CG];
  const int chunk = blockIdx.x;
  const int s = blockIdx.y;
  const int c0 = blockIdx.z * PULL_CG;
  const int ncg = min(PULL_CG, ch - c0);
  const int g = s / GS, j = s % GS;
  const long long N = (long long)GS * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r = threadIdx.x; r < RSUB * PULL_CG; r += blockDim.x) slab[r] = 0.f;
  __syncthreads();

  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(T, t0 + tiles_per_chunk);
  for (int t = t0; t < t1; ++t) {
    const int32_t* seg = pw + ((long long)t * SG + g) * N + (long long)j * C;
    const float* wt = w + (long long)t * TILE * ch + c0;
    for (int cc = 0; cc < C; cc += 32 * UNROLL) {
      int row[UNROLL];
      float val[UNROLL][PULL_CG];
      bool mine[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = cc + u * 32 + lane;
        const unsigned word = c < C ? (unsigned)__ldg(seg + c) : PAD_WORD;
        row[u] = word_row(word);
        mine[u] = word_hi(word) < 128u && (row[u] >> FWD_ROW_SHIFT) == warp;
        const float* wp = wt + (long long)word_bucket(word) * ch;
#pragma unroll
        for (int q = 0; q < PULL_CG; ++q)
          val[u][q] = (mine[u] && q < ncg) ? __ldg(wp + q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (__ballot_sync(FULL, mine[u]) == 0u) continue;   // warp-uniform
        const unsigned grp = __match_any_sync(FULL, mine[u] ? row[u] : -1);
#pragma unroll
        for (int q = 0; q < PULL_CG; ++q)
          stage[warp][lane][q] = bf16_round(val[u][q]);
        __syncwarp();
        if (mine[u] && (__ffs(grp) - 1) == lane) {
          for (int q = 0; q < ncg; ++q) {
            float acc = slab[row[u] * PULL_CG + q];
            for (unsigned m = grp; m; m &= m - 1u)
              acc += stage[warp][__ffs(m) - 1][q];
            slab[row[u] * PULL_CG + q] = acc;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* out = partial + ((long long)s * nchunk + chunk) * RSUB * ch + c0;
  for (int e = threadIdx.x; e < RSUB * PULL_CG; e += blockDim.x) {
    const int r = e / PULL_CG, q = e % PULL_CG;
    if (q < ncg) out[(long long)r * ch + q] = slab[e];
  }
}

// Pass 2 for block row i, channel c: its chunk slabs summed in chunk order.
__device__ __forceinline__ float pulls_combine(
    const float* __restrict__ partial, long long i, int c, int nchunk,
    int ch) {
  const long long s = i / RSUB, r = i % RSUB;
  const float* p = partial + (s * nchunk * RSUB + r) * ch + c;
  float acc = 0.f;
  for (int k = 0; k < nchunk; ++k) acc += p[(long long)k * RSUB * ch];
  return acc;
}

// The pulls of row i as the boundary kernels read them: pass 2's combine,
// plus the pre-aggregated f32 spill grid (rows, ch) when given.
struct PartialPulls {
  const float* partial;
  const float* spill;
  int nchunk, ch;
  __device__ __forceinline__ float operator()(long long i, int c) const {
    float p = pulls_combine(partial, i, c, nchunk, ch);
    if (spill != nullptr) p = p + spill[i * ch + c];
    return p;
  }
};

// The pulls of row i read from a (rows, ch) f32 grid (the split path).
struct RowPulls {
  const float* pulls;
  int ch;
  __device__ __forceinline__ float operator()(long long i, int c) const {
    return pulls[i * ch + c];
  }
};

inline int launch_pulls_partial(const int32_t* pw, const float* w,
                                float* partial, int T, int SG, int GS, int C,
                                int ch, int tiles_per_chunk,
                                cudaStream_t st) {
  const int nchunk = (T + tiles_per_chunk - 1) / tiles_per_chunk;
  cudaError_t e = cudaFuncSetAttribute(
      tile_pulls_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PULL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int groups = (ch + PULL_CG - 1) / PULL_CG;
  tile_pulls_partial<<<dim3(nchunk, SG * GS, groups), FWD_WARPS * 32,
                       PULL_SMEM, st>>>(pw, w, partial, T, SG, GS, C, ch,
                                        tiles_per_chunk, nchunk);
  return (int)cudaGetLastError();
}

// The push values' bf16 row grid from f32 rows (the split path's rounding;
// the fused steps' boundaries write the grid themselves).
__global__ void round_rows_bf16(const float* __restrict__ x,
                                __nv_bfloat16* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16_rn(x[i]);
}

// Pushes, as a bucket index and one segmented sum (no slab, no channel
// groups). Three launches on one stream:
//   1. push_tile_counts: the valid words of each tile (index[nb + 1 + t]);
//   2. push_index: one CTA per tile builds the tile's part of a CSR by
//      bucket: start[b] (the global offset of bucket b's words; start[nb]
//      is the total) and perm[i], the block row s*8192 + row of the i-th
//      word in (bucket, word) order. The placement is stable, so each
//      bucket's words stay in word order (see push_index);
//   3. push_segsum: one thread per output (bucket, channel pair when ch
//      is even), consecutive threads on consecutive outputs, sums bf16
//      dvb[perm[i], c] over i in [start[b], start[b+1]) from 0.f and writes
//      pushes[b, c] once. A pair per thread (bf16x2 loads, float2 stores)
//      halves the threads' index arithmetic and the load and store
//      instructions (PERF.md).
// The index depends on neither ch nor the values; the value grid dvb (rows,
// ch) bf16 (3.5 MB at ch 18) stays in L2 for the gathers. Each (bucket,
// channel) is summed left to right in word order, as the plain version
// (tilemm.backward_pushes_plain) sums.

constexpr int IDX_THREADS = 512;
constexpr int IDX_WARPS = IDX_THREADS / 32;
constexpr int BIN_SHIFT = 10;              // TILE / IDX_WARPS buckets a bin
constexpr int IDX_WIN = 20480;            // words a push_index window
constexpr int IDX_SMEM_MAX =               // 104 KB: two CTAs an SM
    TILE * (int)sizeof(int) + IDX_WIN * (int)sizeof(unsigned short);
constexpr int SEG_THREADS = 256;
constexpr int SEG_BUCKETS = 256;           // buckets per segmented-sum CTA

// The sum over a CTA of one int per thread, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();                                  // red may be in use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int tot = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) tot += red[k];
  return tot;
}

// Exclusive prefix over the warp of one int per lane; *total gets the sum.
__device__ __forceinline__ int warp_exclusive(int v, int lane, int* total) {
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  *total = __shfl_sync(FULL, inc, 31);
  return inc - v;
}

// tile_cnt[t] = the valid words of tile t (W = SG*GS*C words each, a
// multiple of 128, so a tile's words are 16-byte aligned).
__global__ void __launch_bounds__(IDX_THREADS)
push_tile_counts(const int32_t* __restrict__ pw, int* __restrict__ tile_cnt,
                 int W) {
  __shared__ int red[IDX_WARPS];
  const int4* seg = reinterpret_cast<const int4*>(pw) +
                    (long long)blockIdx.x * (W / 4);
  int n = 0;
  for (int i = threadIdx.x; i < W / 4; i += blockDim.x) {
    const int4 q = __ldg(seg + i);
    n += (word_hi((unsigned)q.x) < 128u) + (word_hi((unsigned)q.y) < 128u) +
         (word_hi((unsigned)q.z) < 128u) + (word_hi((unsigned)q.w) < 128u);
  }
  n = block_sum(n, red);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = n;
}

// CTA t: start[t*16384 + b] for its buckets, and perm over its words.
//
// A single warp walking all ~16.9 K words in order would be a chain of
// ~530 dependent steps. So the stable placement runs in two levels, each
// a chain of ~33 steps per warp, all 16 warps at once, over windows of
// `win` words (the whole tile at full width; any W runs, window by window,
// in order):
//   1. bins: warp w takes the w-th contiguous chunk of the window and
//      places each valid word's offset in the window, stably, into the
//      shared staging grouped by bin = bucket >> 10, after the (bin, chunk)
//      counts of the chunks before it;
//   2. buckets: warp k walks bin k's staged words (still in word order)
//      and places each at its bucket's cursor. Only warp k touches the
//      cursors of bin k's buckets.
// In each step a warp takes 32 words in order, groups equal keys (the bin,
// then the bucket) with __match_any_sync, and the group's leader advances
// the key's cursor by the group's size; a lane's place is the cursor plus
// the lanes below it in its group. The staging stays in shared memory: in
// device memory its scattered stores and reads made the index slower
// (PERF.md).
__global__ void __launch_bounds__(IDX_THREADS)
push_index(const int32_t* __restrict__ pw, const int* __restrict__ tile_cnt,
           int* __restrict__ start, int* __restrict__ perm, int T, int SG,
           int GS, int C, int win) {
  extern __shared__ int cur[];             // TILE cursors, then the staging
  unsigned short* stg = reinterpret_cast<unsigned short*>(cur + TILE);
  __shared__ int red[IDX_WARPS];
  __shared__ int bin_cur[IDX_WARPS][IDX_WARPS + 1];   // [bin][chunk]
  __shared__ int bin_start[IDX_WARPS + 1];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int N = GS * C, W = SG * N;
  const int32_t* seg = pw + (long long)t * W;

  int base = 0;                                     // words of tiles < t
  for (int u = threadIdx.x; u < t; u += blockDim.x) base += tile_cnt[u];
  base = block_sum(base, red);
  for (int b = threadIdx.x; b < TILE; b += blockDim.x) cur[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const unsigned word = (unsigned)__ldg(seg + i);
    if (word_hi(word) < 128u) atomicAdd(&cur[word_bucket(word)], 1);
  }
  __syncthreads();

  // bucket starts: warp k scans bin k's 1024 buckets, 32 at a time, after
  // the bins below it
  constexpr int SPAN = TILE / IDX_WARPS;
  int* wc = cur + warp * SPAN;
  int part = 0;
  for (int j = lane; j < SPAN; j += 32) part += wc[j];
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  int run = base, tot = base;
  for (int k = 0; k < IDX_WARPS; ++k) {
    run += k < warp ? red[k] : 0;
    tot += red[k];
  }
  if (t == T - 1 && threadIdx.x == 0) start[(long long)T * TILE] = tot;
  int* st = start + (long long)t * TILE + warp * SPAN;
  for (int j0 = 0; j0 < SPAN; j0 += 32) {
    const int cnt = wc[j0 + lane];
    int sum;
    const int off = run + warp_exclusive(cnt, lane, &sum);
    st[j0 + lane] = off;
    wc[j0 + lane] = off;                            // now the cursor
    run += sum;
  }

  const int chunk = win / IDX_WARPS;                // a multiple of 32
  for (int w0 = 0; w0 < W; w0 += win) {
    const int c0 = min(W, w0 + warp * chunk), c1 = min(W, c0 + chunk);
    if (threadIdx.x < IDX_WARPS * IDX_WARPS)
      bin_cur[threadIdx.x / IDX_WARPS][threadIdx.x % IDX_WARPS] = 0;
    __syncthreads();
    for (int i = c0 + lane; i < c1; i += 32) {
      const unsigned word = (unsigned)__ldg(seg + i);
      if (word_hi(word) < 128u)
        atomicAdd(&bin_cur[word_bucket(word) >> BIN_SHIFT][warp], 1);
    }
    __syncthreads();
    // (bin, chunk) offsets in bin-major order: lane l of warp 0 takes
    // chunks 8(l & 1) .. 8(l & 1) + 7 of bin l / 2
    if (warp == 0) {
      int* o = &bin_cur[lane >> 1][8 * (lane & 1)];
      int v[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = o[q];
        sum += v[q];
      }
      int total;
      int off = warp_exclusive(sum, lane, &total);
      if ((lane & 1) == 0) bin_start[lane >> 1] = off;
      if (lane == 0) bin_start[IDX_WARPS] = total;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        o[q] = off;
        off += v[q];
      }
    }
    __syncthreads();

    // level 1: this warp's chunk into the bins, in order
    for (int c2 = c0; c2 < c1; c2 += 32 * UNROLL) {
      unsigned word[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = c2 + u * 32 + lane;
        word[u] = i < c1 ? (unsigned)__ldg(seg + i) : PAD_WORD;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (c2 + u * 32 >= c1) break;               // warp-uniform
        const bool valid = word_hi(word[u]) < 128u;
        const int bin = word_bucket(word[u]) >> BIN_SHIFT;
        const unsigned grp = __match_any_sync(FULL, valid ? bin : -1);
        const int leader = __ffs(grp) - 1;
        int pos = 0;
        if (valid && lane == leader) {
          pos = bin_cur[bin][warp];
          bin_cur[bin][warp] = pos + __popc(grp);
        }
        pos = __shfl_sync(FULL, pos, leader);
        if (valid)
          stg[pos + __popc(grp & lanes_below)] =
              (unsigned short)(c2 + u * 32 + lane - w0);
      }
    }
    __syncthreads();

    // level 2: bin `warp`'s words into their buckets, in order
    const int j1 = bin_start[warp + 1];
    for (int j0 = bin_start[warp]; j0 < j1; j0 += 32 * UNROLL) {
      int idx[UNROLL];
      unsigned word[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        idx[u] = j < j1 ? w0 + stg[j] : -1;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        word[u] = idx[u] >= 0 ? (unsigned)__ldg(seg + idx[u]) : PAD_WORD;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool live = idx[u] >= 0;
        const int b = word_bucket(word[u]);
        const unsigned grp = __match_any_sync(FULL, live ? b : -1);
        const int leader = __ffs(grp) - 1;
        int pos = 0;
        if (live && lane == leader) {
          pos = cur[b];
          cur[b] = pos + __popc(grp);
        }
        pos = __shfl_sync(FULL, pos, leader);
        if (live) {
          const int g = idx[u] / N;
          const int s = g * GS + (idx[u] - g * N) / C;
          perm[pos + __popc(grp & lanes_below)] =
              s * RSUB + word_row(word[u]);
        }
      }
    }
  }
}

// A segmented-sum thread's V adjacent channels: bf16x2 loads and float2
// stores when ch is even (rows then start on 4-byte boundaries), else one.
template <int V>
struct SegIO;
template <>
struct SegIO<1> {
  using In = __nv_bfloat16;
  using Out = float;
  static __device__ __forceinline__ float2 load(const In* p) {
    return make_float2(__bfloat162float(__ldg(p)), 0.f);
  }
  static __device__ __forceinline__ Out out(float2 a) { return a.x; }
};
template <>
struct SegIO<2> {
  using In = __nv_bfloat162;
  using Out = float2;
  static __device__ __forceinline__ float2 load(const In* p) {
    return __bfloat1622float2(__ldg(p));
  }
  static __device__ __forceinline__ Out out(float2 a) { return a; }
};

// pushes[b, V*u .. V*u + V) for the CTA's SEG_BUCKETS buckets, u < ch / V:
// thread x takes the outputs x, x + 256, ... of the CTA's contiguous
// (buckets x ch/V) range, each channel of bucket b summed in word order.
template <int V>
__global__ void __launch_bounds__(SEG_THREADS)
push_segsum(const int* __restrict__ start, const int* __restrict__ perm,
            const __nv_bfloat16* __restrict__ dvb,
            float* __restrict__ pushes, int nb, int ch) {
  using IO = SegIO<V>;
  __shared__ int sst[SEG_BUCKETS + 1];
  const int b0 = blockIdx.x * SEG_BUCKETS;
  const int nbk = min(SEG_BUCKETS, nb - b0);
  for (int j = threadIdx.x; j <= nbk; j += blockDim.x)
    sst[j] = __ldg(start + b0 + j);
  __syncthreads();
  const int units = ch / V;                         // outputs a bucket
  const typename IO::In* vals = reinterpret_cast<const typename IO::In*>(dvb);
  typename IO::Out* out =
      reinterpret_cast<typename IO::Out*>(pushes + (long long)b0 * ch);
  const int step_b = SEG_THREADS / units;
  const int step_u = SEG_THREADS - step_b * units;
  int bl = threadIdx.x / units, u = threadIdx.x - bl * units;
  for (int e = threadIdx.x; e < nbk * units; e += SEG_THREADS) {
    const int i1 = sst[bl + 1];
    float2 acc = make_float2(0.f, 0.f);
    for (int i = sst[bl]; i < i1; ++i) {
      const float2 v = IO::load(vals + (long long)__ldg(perm + i) * units + u);
      acc.x += v.x;
      acc.y += v.y;
    }
    out[e] = IO::out(acc);
    bl += step_b;
    u += step_u;
    if (u >= units) {
      u -= units;
      ++bl;
    }
  }
}

// The bucket index alone: index (T*16384 + 1 + T) int32, whose first
// T*16384 + 1 entries are `start` and whose last T the tile counts, and
// perm (T*SG*GS*C) int32.
inline int launch_push_index(const int32_t* pw, int* index, int* perm, int T,
                             int SG, int GS, int C, cudaStream_t st) {
  if (index == nullptr || perm == nullptr)
    return (int)cudaErrorInvalidValue;
  const int W = SG * GS * C;
  int* tile_cnt = index + (long long)T * TILE + 1;
  push_tile_counts<<<T, IDX_THREADS, 0, st>>>(pw, tile_cnt, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(push_index,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           IDX_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const int unit = IDX_WARPS * 32;
  const int win = min(IDX_WIN, (W + unit - 1) / unit * unit);
  const int smem = TILE * (int)sizeof(int) + win * (int)sizeof(unsigned short);
  push_index<<<T, IDX_THREADS, smem, st>>>(pw, tile_cnt, index, perm, T, SG,
                                           GS, C, win);
  return (int)cudaGetLastError();
}

// pushes (T*16384, ch) f32 over a ready bf16 row grid `dvb` (rows, ch):
// the bucket index into the scratch `index` and `perm`
// (launch_push_index), then the segmented sum.
inline int launch_pushes_tile(const int32_t* pw, const __nv_bfloat16* dvb,
                              int* index, int* perm, float* pushes, int T,
                              int SG, int GS, int C, int ch,
                              cudaStream_t st) {
  int err = launch_push_index(pw, index, perm, T, SG, GS, C, st);
  if (err != 0) return err;
  const int nb = T * TILE;
  const int grid = (nb + SEG_BUCKETS - 1) / SEG_BUCKETS;
  if (ch % 2 == 0)
    push_segsum<2><<<grid, SEG_THREADS, 0, st>>>(index, perm, dvb, pushes, nb,
                                                 ch);
  else
    push_segsum<1><<<grid, SEG_THREADS, 0, st>>>(index, perm, dvb, pushes, nb,
                                                 ch);
  return (int)cudaGetLastError();
}

}  // namespace wh
