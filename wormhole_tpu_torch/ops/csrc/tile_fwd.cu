// Tile forward margins on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_fwd_kernel` (:309, built by
// `_build_fwd` :573). The device code and its determinism design live in
// tile_fwd.cuh, which tile_step.cu shares as phase 1 of the train step.
//
// What bounds it: bytes. The TPU kernel turned the gather into one-hot MXU
// matmuls (~350 GFLOP of bf16 per 98,304-row criteo block) because the TPU
// has no fast gather. Hopper has one, and w (16.8 MB f32 at 2^22 buckets)
// fits the 50 MB L2, so this kernel is a direct gather: it must move the
// pair words (17.3 MB), w once (16.8 MB) and the margins (0.39 MB).
//
// A simple kernel first: no TMA/wgmma, no tuning. Every warp reads all of
// its chunk's words (8x redundant L1 reads); later work can remove that.

#include "tile_fwd.cuh"

namespace {

__global__ void tile_fwd_combine(const float* __restrict__ partial,
                                 float* __restrict__ margins, long long rows,
                                 int nchunk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  margins[i] = wh::fwd_combine_row(partial, i, nchunk);
}

}  // namespace

extern "C" {

// margins (S*8192,) f32 from pw (T, SG, GS*C) i32 and w (T*16384,) f32.
// partial is scratch of (S, nchunk, 8192) f32 with
// nchunk = ceil(T / tiles_per_chunk). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after each launch
// (0 = success).
int wh_tile_fwd(const int32_t* pw, const float* w, float* partial,
                float* margins, int T, int SG, int GS, int C,
                int tiles_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = wh::launch_fwd_partial(pw, w, partial, T, SG, GS, C,
                                   tiles_per_chunk, st);
  if (err != 0) return err;
  const int nchunk = (T + tiles_per_chunk - 1) / tiles_per_chunk;
  const long long rows = (long long)SG * GS * wh::RSUB;
  tile_fwd_combine<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      partial, margins, rows, nchunk);
  return (int)cudaGetLastError();
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
