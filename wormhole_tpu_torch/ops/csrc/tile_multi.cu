// Multi-channel tile pulls and pushes on Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py
//   - `_fwd_multi_kernel` (:703, built by `_build_fwd_multi` :801,
//     pallas_call :811): wh_tile_pulls, the pooled pulls (rows, ch);
//   - `_bwd_multi_kernel` (:741, built by `_build_bwd_multi` :832,
//     pallas_call :844): wh_tile_pushes, the channel pushes (nb, ch).
// The device code and its design (the pulls' channel groups and chunk
// count, the pushes' bucket index and segmented sum) live in
// tile_multi.cuh, which the fused FM and wide&deep steps share, so split and
// fused sum alike.
//
// What bounds them: bytes. Per full-width criteo block (2^22 buckets,
// 98,304 rows) the pulls must read the pair words (17.3 MB) and the (nb, ch)
// f32 table once (168 MB at ch 10) and write (rows, ch) f32 (3.9 MB); the
// pushes read the words and the (rows, ch) values and write (nb, ch) f32
// (302 MB at ch 18). The TPU ran both as one-hot MXU matmuls, one channel
// block of lanes each; Hopper gathers and scatters directly.
//
// The pulls are still the simple first kernel: each channel group re-reads
// the words, and the chunk slabs add a (S, nchunk, 8192, ch) f32 round
// trip. The pushes read the words three times and add the index's scratch
// (perm and start, about 35 MB at full width) to the bytes above.

#include "tile_multi.cuh"

namespace {

__global__ void tile_pulls_combine(const float* __restrict__ partial,
                                   float* __restrict__ pulls, long long n,
                                   int nchunk, int ch) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  pulls[e] = wh::pulls_combine(partial, e / ch, (int)(e % ch), nchunk, ch);
}

}  // namespace

extern "C" {

// pulls (S*8192, ch) f32 from pw (T, SG, GS*C) i32 and w (T*16384, ch) f32
// (rounded to bf16 in the kernel). partial is scratch of (S, nchunk, 8192,
// ch) f32 with nchunk = ceil(T / tiles_per_chunk). Returns
// cudaGetLastError() after each launch (0 = success).
int wh_tile_pulls(const int32_t* pw, const float* w, float* partial,
                  float* pulls, int T, int SG, int GS, int C, int ch,
                  int tiles_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = wh::launch_pulls_partial(pw, w, partial, T, SG, GS, C, ch,
                                     tiles_per_chunk, st);
  if (err != 0) return err;
  const int nchunk = (T + tiles_per_chunk - 1) / tiles_per_chunk;
  const long long n = (long long)SG * GS * wh::RSUB * ch;
  tile_pulls_combine<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partial, pulls, n, nchunk, ch);
  return (int)cudaGetLastError();
}

// pushes (T*16384, ch) f32 from pw and the f32 value rows (S*8192, ch),
// rounded to bf16 into the scratch grid dvb (S*8192, ch) first. index
// (T*16384 + 1 + T) and perm (T*SG*GS*C) int32 are scratch for the bucket
// index.
int wh_tile_pushes(const int32_t* pw, const float* dvals, __nv_bfloat16* dvb,
                   int* index, int* perm, float* pushes, int T, int SG,
                   int GS, int C, int ch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)SG * GS * wh::RSUB * ch;
  wh::round_rows_bf16<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dvals, dvb, n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return wh::launch_pushes_tile(pw, dvb, index, perm, pushes, T, SG, GS, C,
                                ch, st);
}

// The pushes' bucket index alone (a CSR of pw's valid words by bucket):
// index[0..T*16384] the bucket starts, index[T*16384 + 1 + t] tile t's
// valid words, perm[start[b]..start[b+1]) bucket b's block rows in word
// order (perm holds T*SG*GS*C int32).
int wh_push_index(const int32_t* pw, int* index, int* perm, int T, int SG,
                  int GS, int C, void* stream) {
  return wh::launch_push_index(pw, index, perm, T, SG, GS, C,
                               static_cast<cudaStream_t>(stream));
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
