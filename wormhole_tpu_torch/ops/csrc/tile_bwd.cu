// Tile backward gradient on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_bwd_kernel` (:527, the K == 1
// branch of `_build_bwd` :601, pallas_call :642) and computes the function
// of `_bwd_kernel_fused` (:474, pallas_call :613) too: the K-tile chain is a
// TPU re-view of the same pair bytes, and this kernel reads the bytes as they
// are, so one kernel serves every TileSpec, fuse > 1 included. The device
// code and its determinism design live in tile_bwd.cuh, which the fused
// train step (tile_step.cu) shares, so split and fused sum every bucket in
// the same order.
//
// What bounds it: bytes. Per full-width criteo block (2^22 buckets, 98,304
// rows) it must read the pair words (17.3 MB) and the f32 dual (0.39 MB)
// and write the gradient (16.8 MB): about 0.010 ms at 3.35 TB/s. The TPU ran
// it as one-hot MXU matmuls; Hopper scatters into shared memory instead.
//
// Design: one CTA per tile keeps the tile's 16384 buckets in a 64 KB slab,
// so a CTA owns its buckets outright and writes them once. At 2^22 buckets
// that is 256 CTAs, about 2 per SM, and every warp reads all of its tile's
// words (16x redundant L1 reads). The random dual reads run first, in a
// pre-pass at full occupancy that writes each word's bf16 dual in word
// order (8.6 MB of scratch at full width): inside the per-tile loop they
// made the kernel latency-bound (PERF.md).

#include "tile_bwd.cuh"

extern "C" {

// grad (T*16384,) f32 from pw (T, SG, GS*C) i32 and the f32 dual rows
// (SG*GS*8192,), rounded to bf16 in the kernel; dv is scratch of one bf16
// per word of pw. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after each launch (0 = success).
int wh_tile_bwd(const int32_t* pw, const float* dual, __nv_bfloat16* dv,
                float* grad, int T, int SG, int GS, int C, void* stream) {
  return wh::launch_bwd_grad(pw, dual, dv, grad, T, SG, GS, C,
                             static_cast<cudaStream_t>(stream));
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
