// Design sweep of the pulls' segmented sum (scripts/torch_pull_sweep.py):
// variants of csrc/tile_multi.cuh's pull_segsum over the same row index,
// each summing every (row, channel) from 0.f in word order, so every variant
// equals the shipped kernel bitwise.
//
//   0  shipped: pull_segsum<V> (a thread per output, 4 gathers in flight)
//   1  a thread per output, one gather at a time (push_segsum's loop)
//   2  a thread per output, 8 gathers in flight
//   3  a thread per channel (V = 1) also at even ch, 4 gathers in flight
//   4  a warp per row: lane c < ch takes channel c (ch <= 32), 4 gathers

#include "../wormhole_tpu_torch/ops/csrc/tile_multi.cuh"

namespace {

template <int V, int U>
__global__ void __launch_bounds__(wh::SEG_THREADS)
seg_thread(const int* __restrict__ start, const int* __restrict__ perm,
           const float* __restrict__ w, float* __restrict__ pulls,
           long long rows, int ch) {
  using IO = wh::PullIO<V>;
  const int units = ch / V;
  const long long e = (long long)blockIdx.x * wh::SEG_THREADS + threadIdx.x;
  if (e >= rows * units) return;
  const long long r = e / units;
  const int u = (int)(e - r * units);
  const typename IO::In* tab = reinterpret_cast<const typename IO::In*>(w);
  const int i1 = __ldg(start + r + 1);
  int i = __ldg(start + r);
  float2 acc = make_float2(0.f, 0.f);
  for (; i + U <= i1; i += U) {
    float2 v[U];
#pragma unroll
    for (int q = 0; q < U; ++q)
      v[q] = IO::load(tab + (long long)__ldg(perm + i + q) * units + u);
#pragma unroll
    for (int q = 0; q < U; ++q) {
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

__global__ void __launch_bounds__(wh::SEG_THREADS)
seg_warp(const int* __restrict__ start, const int* __restrict__ perm,
         const float* __restrict__ w, float* __restrict__ pulls,
         long long rows, int ch) {
  const long long r =
      ((long long)blockIdx.x * wh::SEG_THREADS + threadIdx.x) >> 5;
  const int c = threadIdx.x & 31;
  if (r >= rows || c >= ch) return;
  const int i1 = __ldg(start + r + 1);
  int i = __ldg(start + r);
  float acc = 0.f;
  for (; i + 4 <= i1; i += 4) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = wh::bf16_round(
          __ldg(w + (long long)__ldg(perm + i + q) * ch + c));
#pragma unroll
    for (int q = 0; q < 4; ++q) acc += v[q];
  }
  for (; i < i1; ++i)
    acc += wh::bf16_round(__ldg(w + (long long)__ldg(perm + i) * ch + c));
  pulls[r * ch + c] = acc;
}

unsigned blocks(long long n) {
  return (unsigned)((n + wh::SEG_THREADS - 1) / wh::SEG_THREADS);
}

}  // namespace

extern "C" int sweep_segsum(int variant, const int* start, const int* perm,
                            const float* w, float* pulls, long long rows,
                            int ch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pair = ch % 2 == 0;
  const unsigned g1 = blocks(rows * ch), g2 = blocks(rows * (ch / 2));
  const int T = wh::SEG_THREADS;
  switch (variant) {
    case 0:
      if (pair)
        wh::pull_segsum<2><<<g2, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      else
        wh::pull_segsum<1><<<g1, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      break;
    case 1:
      if (pair)
        seg_thread<2, 1><<<g2, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      else
        seg_thread<1, 1><<<g1, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      break;
    case 2:
      if (pair)
        seg_thread<2, 8><<<g2, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      else
        seg_thread<1, 8><<<g1, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      break;
    case 3:
      seg_thread<1, 4><<<g1, T, 0, st>>>(start, perm, w, pulls, rows, ch);
      break;
    case 4:
      if (ch > 32) return (int)cudaErrorInvalidValue;
      seg_warp<<<blocks(rows * 32), T, 0, st>>>(start, perm, w, pulls, rows,
                                               ch);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
