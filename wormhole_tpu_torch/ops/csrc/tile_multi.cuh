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
// Both run as a CSR index of the block's valid words and one segmented sum
// over all channels that writes each output once. No slab: a subblock's row
// slab (32·ch KB) and a tile's bucket slab (64·ch KB) pass the 227 KB a CTA
// may hold at the widths the models use, and splitting the channels over
// CTAs makes each CTA re-read the words (PERF.md). The index depends on
// neither ch nor the values, so it is built once per call:
//   - pulls: by block row (pull_index below). A row's words lie in every
//     tile, so the index runs over (subblock, run of tiles) CTAs: counts per
//     (run, row), a prefix over (row, run), then a stable placement;
//     perm[i] is the table row t*16384 + bucket of the i-th word;
//   - pushes: by bucket (push_index below), one CTA per tile, whose words
//     hold all of the tile's buckets; perm[i] is the block row.
// The segmented sums gather their operand rows through perm: the (nb, ch)
// f32 pull table (168 MB at ch 10, larger than the 50 MB L2) and the
// (rows, ch) bf16 push grid (3.5 MB at ch 18, resident in L2).
//
// Determinism: the placement is stable, so each key's words stay in word
// order ((tile, group, slot) order), and one thread sums each (key,
// channel) from 0.f left to right in that order, as the plain versions do
// (tilemm.forward_pulls_plain, backward_pushes_plain). No float atomics, so
// every run gives the same bits, and the kernels equal their plain versions
// bitwise.

#pragma once

#include "tile_fwd.cuh"

namespace wh {

// The pulls of row i as the boundary kernels read them, from the (rows, ch)
// f32 grid the pulls wrote, plus the pre-aggregated f32 spill grid (rows,
// ch) when given: the one f32 add the split path runs in torch.
struct RowPulls {
  const float* pulls;
  const float* spill;
  int ch;
  __device__ __forceinline__ float operator()(long long i, int c) const {
    float p = pulls[i * ch + c];
    if (spill != nullptr) p = p + spill[i * ch + c];
    return p;
  }
};

// The push values' bf16 row grid from f32 rows (the split path's rounding;
// the fused steps' boundaries write the grid themselves).
__global__ void round_rows_bf16(const float* __restrict__ x,
                                __nv_bfloat16* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16_rn(x[i]);
}

constexpr int IDX_THREADS = 512;
constexpr int IDX_WARPS = IDX_THREADS / 32;
constexpr int IDX_WIN = 20480;            // words a placement window
constexpr int IDX_SMEM_MAX =               // 104 KB: two CTAs an SM
    TILE * (int)sizeof(int) + IDX_WIN * (int)sizeof(unsigned short);
constexpr int PRE_ROWS = 1024;             // rows a pull_row_prefix CTA
constexpr int SEG_THREADS = 256;
constexpr int SEG_BUCKETS = 256;           // buckets per push_segsum CTA

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

// The stable placement both indexes share. A CTA's n words are numbered in
// word order; src.word(i) loads word i, src.key(word) is its key (< 16 <<
// Src::BIN_SHIFT), src.value(i, word) what perm receives, and cur[key]
// holds the key's next place in perm. Each valid word goes to
// perm[cur[key]++] in word order.
//
// A single warp walking ~20 K words in order would be a chain of ~640
// dependent steps. So the placement runs in two levels, each a chain of
// ~40 steps per warp, all 16 warps at once, over windows of `win` words
// (any n runs, window by window, in order):
//   1. bins: warp w takes the w-th contiguous chunk of the window and
//      places each valid word's offset in the window, stably, into the
//      shared staging grouped by bin = key >> BIN_SHIFT, after the (bin,
//      chunk) counts of the chunks before it;
//   2. keys: warp k walks bin k's staged words (still in word order) and
//      places each at its key's cursor. Only warp k touches the cursors of
//      bin k's keys.
// In each step a warp takes 32 words in order, groups equal keys (the bin,
// then the key) with __match_any_sync, and the group's leader advances the
// key's cursor by the group's size; a lane's place is the cursor plus the
// lanes below it in its group. The staging stays in shared memory: in
// device memory its scattered stores and reads made the index slower
// (PERF.md).
template <class Src>
__device__ __forceinline__ void place_stable(
    const Src& src, int n, int win, int* cur, unsigned short* stg,
    int (*bin_cur)[IDX_WARPS + 1], int* bin_start, int* __restrict__ perm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int chunk = win / IDX_WARPS;                // a multiple of 32
  for (int w0 = 0; w0 < n; w0 += win) {
    const int c0 = min(n, w0 + warp * chunk), c1 = min(n, c0 + chunk);
    if (threadIdx.x < IDX_WARPS * IDX_WARPS)
      bin_cur[threadIdx.x / IDX_WARPS][threadIdx.x % IDX_WARPS] = 0;
    __syncthreads();
    for (int i = c0 + lane; i < c1; i += 32) {
      const unsigned word = src.word(i);
      if (word_hi(word) < 128u)
        atomicAdd(&bin_cur[src.key(word) >> Src::BIN_SHIFT][warp], 1);
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
        word[u] = i < c1 ? src.word(i) : PAD_WORD;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (c2 + u * 32 >= c1) break;               // warp-uniform
        const bool valid = word_hi(word[u]) < 128u;
        const int bin = src.key(word[u]) >> Src::BIN_SHIFT;
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

    // level 2: bin `warp`'s words at their keys' cursors, in order
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
        word[u] = idx[u] >= 0 ? src.word(idx[u]) : PAD_WORD;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool live = idx[u] >= 0;
        const int key = src.key(word[u]);
        const unsigned grp = __match_any_sync(FULL, live ? key : -1);
        const int leader = __ffs(grp) - 1;
        int pos = 0;
        if (live && lane == leader) {
          pos = cur[key];
          cur[key] = pos + __popc(grp);
        }
        pos = __shfl_sync(FULL, pos, leader);
        if (live)
          perm[pos + __popc(grp & lanes_below)] = src.value(idx[u], word[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pulls, as a row index and one segmented sum. Four launches on one stream:
//   1. pull_counts: CTA (run, s) counts the valid words of subblock s in
//      its run of tiles_per_run tiles, per row (8192 shared counters), into
//      cnt[s][run][row];
//   2. pull_row_prefix: one thread a block row turns its counts into the
//      row's offset in each run: the words of the rows before it in its
//      1024-row chunk, plus its words in the runs before; chunk_tot gets
//      each chunk's words;
//   3. pull_index: CTA (run, s) sets its rows' cursors (the chunk totals
//      before each chunk, plus 2.'s offsets), writes start[] from run 0,
//      and places its words stably (place_stable). Runs are in tile order,
//      which is word order, so each row's words stay in word order;
//   4. pull_segsum: one thread per output (row, channel pair when ch is
//      even), consecutive threads on consecutive outputs, sums
//      bf16(w[perm[i], c]) over i in [start[r], start[r+1]) from 0.f and
//      writes pulls[r, c] once.
// The index scratch `index` holds start (rows + 1), cnt (S x nrun x 8192)
// and chunk_tot (rows / 1024) int32 (7.9 MB at full width); perm one int32
// per pair word (17.3 MB).

// The words of subblock s = g*GS + j in tiles t0.. as the placement reads
// them: a run of C-word segments, one per tile, W words apart.
struct PullWords {
  static constexpr int BIN_SHIFT = 9;      // RSUB / IDX_WARPS rows a bin
  const int32_t* seg;                      // tile t0's segment
  long long W;
  int C, t0;
  __device__ __forceinline__ unsigned word(int i) const {
    const int q = i / C;
    return (unsigned)__ldg(seg + q * W + (i - q * C));
  }
  __device__ __forceinline__ int key(unsigned w) const { return word_row(w); }
  __device__ __forceinline__ int value(int i, unsigned w) const {
    return (t0 + i / C) * TILE + word_bucket(w);
  }
};

__global__ void __launch_bounds__(IDX_THREADS)
pull_counts(const int32_t* __restrict__ pw, int* __restrict__ cnt, int T,
            int SG, int GS, int C, int tiles_per_run) {
  __shared__ int c[RSUB];
  const int run = blockIdx.x, s = blockIdx.y, nrun = gridDim.x;
  const int g = s / GS, j = s % GS;
  const long long N = (long long)GS * C;
  for (int r = threadIdx.x; r < RSUB; r += blockDim.x) c[r] = 0;
  __syncthreads();
  const int t1 = min(T, (run + 1) * tiles_per_run);
  for (int t = run * tiles_per_run; t < t1; ++t) {
    // segments start on multiples of C words (C % 128 == 0): 16 B aligned
    const int4* seg = reinterpret_cast<const int4*>(
        pw + ((long long)t * SG + g) * N + (long long)j * C);
    for (int i = threadIdx.x; i < C / 4; i += blockDim.x) {
      const int4 q = __ldg(seg + i);
      const unsigned w4[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                              (unsigned)q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (word_hi(w4[u]) < 128u) atomicAdd(&c[word_row(w4[u])], 1);
    }
  }
  __syncthreads();
  int* out = cnt + ((long long)s * nrun + run) * RSUB;
  for (int r = threadIdx.x; r < RSUB; r += blockDim.x) out[r] = c[r];
}

__global__ void __launch_bounds__(PRE_ROWS)
pull_row_prefix(int* __restrict__ cnt, int* __restrict__ chunk_tot,
                int nrun) {
  __shared__ int red[PRE_ROWS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * PRE_ROWS + threadIdx.x;
  int* p = cnt + (r / RSUB) * nrun * RSUB + r % RSUB;
  int tot = 0;
  for (int k = 0; k < nrun; ++k) tot += p[(long long)k * RSUB];
  int wsum;
  const int pre = warp_exclusive(tot, lane, &wsum);
  if (lane == 0) red[warp] = wsum;
  __syncthreads();
  if (warp == 0) {
    int all;
    const int off = warp_exclusive(red[lane], lane, &all);
    red[lane] = off;
    if (lane == 0) chunk_tot[blockIdx.x] = all;
  }
  __syncthreads();
  int acc = red[warp] + pre;
  for (int k = 0; k < nrun; ++k) {
    const int v = p[(long long)k * RSUB];
    p[(long long)k * RSUB] = acc;
    acc += v;
  }
}

__global__ void __launch_bounds__(IDX_THREADS)
pull_index(const int32_t* __restrict__ pw, const int* __restrict__ cnt,
           const int* __restrict__ chunk_tot, int* __restrict__ start,
           int* __restrict__ perm, int T, int SG, int GS, int C,
           int tiles_per_run, int win) {
  extern __shared__ int cur[];             // RSUB cursors, then the staging
  unsigned short* stg = reinterpret_cast<unsigned short*>(cur + RSUB);
  __shared__ int bin_cur[IDX_WARPS][IDX_WARPS + 1];   // [bin][chunk]
  __shared__ int bin_start[IDX_WARPS + 1];
  constexpr int CHUNKS = RSUB / PRE_ROWS;  // row chunks a subblock
  __shared__ int cbase[CHUNKS];
  const int run = blockIdx.x, s = blockIdx.y;
  const int nrun = gridDim.x, S = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = s / GS, j = s % GS;
  const long long N = (long long)GS * C, W = SG * N;

  // the words of the row chunks before each of this subblock's chunks
  if (warp == 0) {
    int before = 0;
    for (int k0 = 0; k0 < S * CHUNKS; k0 += 32) {
      const int k = k0 + lane;
      int sum;
      const int off = before + warp_exclusive(
          k < S * CHUNKS ? __ldg(chunk_tot + k) : 0, lane, &sum);
      if (k >= s * CHUNKS && k < (s + 1) * CHUNKS) cbase[k - s * CHUNKS] = off;
      before += sum;
    }
    if (lane == 0 && run == 0 && s == S - 1)
      start[(long long)S * RSUB] = before;
  }
  __syncthreads();
  const int* pc = cnt + ((long long)s * nrun + run) * RSUB;
  for (int r = threadIdx.x; r < RSUB; r += blockDim.x) {
    const int v = cbase[r / PRE_ROWS] + __ldg(pc + r);
    cur[r] = v;
    if (run == 0) start[(long long)s * RSUB + r] = v;
  }
  __syncthreads();

  const int t0 = run * tiles_per_run;
  const int n = (min(T, t0 + tiles_per_run) - t0) * C;
  const PullWords src{pw + t0 * W + g * N + (long long)j * C, W, C, t0};
  place_stable(src, n, win, cur, stg, bin_cur, bin_start, perm);
}

// The row index alone: index (rows + 1 + S*nrun*8192 + rows/1024) int32,
// whose first rows + 1 entries are `start`, and perm (T*SG*GS*C) int32,
// with nrun = ceil(T / tiles_per_run).
inline int launch_pull_index(const int32_t* pw, int* index, int* perm, int T,
                             int SG, int GS, int C, int tiles_per_run,
                             cudaStream_t st) {
  if (index == nullptr || perm == nullptr || tiles_per_run < 1)
    return (int)cudaErrorInvalidValue;
  const int S = SG * GS, nrun = (T + tiles_per_run - 1) / tiles_per_run;
  const long long rows = (long long)S * RSUB;
  int* cnt = index + rows + 1;
  int* chunk_tot = cnt + (long long)S * nrun * RSUB;
  pull_counts<<<dim3(nrun, S), IDX_THREADS, 0, st>>>(pw, cnt, T, SG, GS, C,
                                                     tiles_per_run);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pull_row_prefix<<<(unsigned)(rows / PRE_ROWS), PRE_ROWS, 0, st>>>(
      cnt, chunk_tot, nrun);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(pull_index,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           IDX_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const int unit = IDX_WARPS * 32;
  const int most = min(T, tiles_per_run) * C;       // words a CTA
  const int win = min(IDX_WIN, (most + unit - 1) / unit * unit);
  const int smem = RSUB * (int)sizeof(int) + win * (int)sizeof(unsigned short);
  pull_index<<<dim3(nrun, S), IDX_THREADS, smem, st>>>(
      pw, cnt, chunk_tot, index, perm, T, SG, GS, C, tiles_per_run, win);
  return (int)cudaGetLastError();
}

// A pull_segsum thread's V adjacent channels of one f32 table row, each
// rounded to bf16: a float2 load when ch is even (rows then start on 8-byte
// boundaries), else one float.
template <int V>
struct PullIO;
template <>
struct PullIO<1> {
  using In = float;
  using Out = float;
  static __device__ __forceinline__ float2 load(const In* p) {
    return make_float2(bf16_round(__ldg(p)), 0.f);
  }
  static __device__ __forceinline__ Out out(float2 a) { return a.x; }
};
template <>
struct PullIO<2> {
  using In = float2;
  using Out = float2;
  static __device__ __forceinline__ float2 load(const In* p) {
    const float2 v = __ldg(p);
    return make_float2(bf16_round(v.x), bf16_round(v.y));
  }
  static __device__ __forceinline__ Out out(float2 a) { return a; }
};

// pulls[r, V*u .. V*u + V): thread e takes output e = r * (ch / V) + u and
// sums row r's words in word order, four gathers in flight at a time (the
// adds stay in order).
template <int V>
__global__ void __launch_bounds__(SEG_THREADS)
pull_segsum(const int* __restrict__ start, const int* __restrict__ perm,
            const float* __restrict__ w, float* __restrict__ pulls,
            long long rows, int ch) {
  using IO = PullIO<V>;
  const int units = ch / V;                         // outputs a row
  const long long e = (long long)blockIdx.x * SEG_THREADS + threadIdx.x;
  if (e >= rows * units) return;
  const long long r = e / units;
  const int u = (int)(e - r * units);
  const typename IO::In* tab = reinterpret_cast<const typename IO::In*>(w);
  const int i1 = __ldg(start + r + 1);
  int i = __ldg(start + r);
  float2 acc = make_float2(0.f, 0.f);
  for (; i + 4 <= i1; i += 4) {
    float2 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = IO::load(tab + (long long)__ldg(perm + i + q) * units + u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc.x += v[q].x;
      acc.y += v[q].y;
    }
  }
  for (; i < i1; ++i) {
    const float2 v = IO::load(tab + (long long)__ldg(perm + i) * units + u);
    acc.x += v.x;
    acc.y += v.y;
  }
  reinterpret_cast<typename IO::Out*>(pulls)[e] = IO::out(acc);
}

// pulls (S*8192, ch) f32 from pw and the f32 table w (T*16384, ch): the row
// index into the scratch `index` and `perm` (launch_pull_index), then the
// segmented sum.
inline int launch_pulls_tile(const int32_t* pw, const float* w, int* index,
                             int* perm, float* pulls, int T, int SG, int GS,
                             int C, int ch, int tiles_per_run,
                             cudaStream_t st) {
  if (pulls == nullptr) return (int)cudaErrorInvalidValue;
  int err = launch_pull_index(pw, index, perm, T, SG, GS, C, tiles_per_run,
                              st);
  if (err != 0) return err;
  const long long rows = (long long)SG * GS * RSUB;
  const int V = ch % 2 == 0 ? 2 : 1;
  const long long n = rows * (ch / V);
  const unsigned grid = (unsigned)((n + SEG_THREADS - 1) / SEG_THREADS);
  if (V == 2)
    pull_segsum<2><<<grid, SEG_THREADS, 0, st>>>(index, perm, w, pulls, rows,
                                                 ch);
  else
    pull_segsum<1><<<grid, SEG_THREADS, 0, st>>>(index, perm, w, pulls, rows,
                                                 ch);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Pushes, as a bucket index and one segmented sum. Three launches on one
// stream:
//   1. push_tile_counts: the valid words of each tile (index[nb + 1 + t]);
//   2. push_index: one CTA per tile builds the tile's part of a CSR by
//      bucket: start[b] (the global offset of bucket b's words; start[nb]
//      is the total) and perm[i], the block row s*8192 + row of the i-th
//      word in (bucket, word) order (place_stable);
//   3. push_segsum: one thread per output (bucket, channel pair when ch
//      is even), consecutive threads on consecutive outputs, sums bf16
//      dvb[perm[i], c] over i in [start[b], start[b+1]) from 0.f and writes
//      pushes[b, c] once. A pair per thread (bf16x2 loads, float2 stores)
//      halves the threads' index arithmetic and the load and store
//      instructions (PERF.md).
// The value grid dvb (rows, ch) bf16 (3.5 MB at ch 18) stays in L2 for the
// gathers.

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

// A tile's W words as the placement reads them: contiguous.
struct PushWords {
  static constexpr int BIN_SHIFT = 10;     // TILE / IDX_WARPS buckets a bin
  const int32_t* seg;
  int N, C, GS;
  __device__ __forceinline__ unsigned word(int i) const {
    return (unsigned)__ldg(seg + i);
  }
  __device__ __forceinline__ int key(unsigned w) const {
    return word_bucket(w);
  }
  __device__ __forceinline__ int value(int i, unsigned w) const {
    const int g = i / N;
    const int s = g * GS + (i - g * N) / C;
    return s * RSUB + word_row(w);
  }
};

// CTA t: start[t*16384 + b] for its buckets (after the tiles before it),
// and perm over its words (place_stable, the whole tile at full width).
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
  place_stable(PushWords{seg, N, C, GS}, W, win, cur, stg, bin_cur,
               bin_start, perm);
}

// A push_segsum thread's V adjacent channels: bf16x2 loads and float2
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
