// Multi-channel tile pulls and pushes on Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py
//   - `_fwd_multi_kernel` (:703, built by `_build_fwd_multi` :801,
//     pallas_call :811): wh_tile_pulls, the pooled pulls (rows, ch);
//   - `_bwd_multi_kernel` (:741, built by `_build_bwd_multi` :832,
//     pallas_call :844): wh_tile_pushes, the channel pushes (nb, ch).
// The device code and its design (for each, a CSR index of the block's
// words, by row for the pulls and by bucket for the pushes, and one
// segmented sum over all channels) live in tile_multi.cuh, which the fused
// FM and wide&deep steps share, so split and fused sum alike.
//
// What bounds them: bytes. Per full-width criteo block (2^22 buckets,
// 98,304 rows) the pulls must read the pair words (17.3 MB), the sectors of
// the (nb, ch) f32 table the block reaches (about 119 MB at ch 10) and
// write (rows, ch) f32 (3.9 MB); the pushes read the words and the (rows,
// ch) values and write (nb, ch) f32 (302 MB at ch 18). The TPU ran both as
// one-hot MXU matmuls, one channel block of lanes each; Hopper gathers
// directly, through the index. Each index reads the words a few times and
// writes its perm (one int32 per valid word) and starts: that, and the
// table sectors a gather fetches more than once, are the extra traffic.

#include "tile_multi.cuh"

extern "C" {

// pulls (S*8192, ch) f32 from pw (T, SG, GS*C) i32 and w (T*16384, ch) f32
// (rounded to bf16 in the kernel). index (S*8192 + 1 + S*nrun*8192 +
// S*8192/1024) and perm (T*SG*GS*C) int32 are scratch for the row index,
// nrun = ceil(T / tiles_per_run). Returns cudaGetLastError() after each
// launch (0 = success), cudaErrorInvalidValue for a null scratch.
int wh_tile_pulls(const int32_t* pw, const float* w, int* index, int* perm,
                  float* pulls, int T, int SG, int GS, int C, int ch,
                  int tiles_per_run, void* stream) {
  return wh::launch_pulls_tile(pw, w, index, perm, pulls, T, SG, GS, C, ch,
                               tiles_per_run,
                               static_cast<cudaStream_t>(stream));
}

// The pulls' row index alone (a CSR of pw's valid words by block row):
// index[0..S*8192] the row starts, perm[start[r]..start[r+1]) row r's table
// rows t*16384 + bucket in word order.
int wh_pull_index(const int32_t* pw, int* index, int* perm, int T, int SG,
                  int GS, int C, int tiles_per_run, void* stream) {
  return wh::launch_pull_index(pw, index, perm, T, SG, GS, C, tiles_per_run,
                               static_cast<cudaStream_t>(stream));
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
