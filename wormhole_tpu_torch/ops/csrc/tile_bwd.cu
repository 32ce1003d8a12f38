// Tile backward gradient on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_bwd_kernel` (:527, the K == 1
// branch of `_build_bwd` :601, pallas_call :642) and computes the function
// of `_bwd_kernel_fused` (:474, pallas_call :613) too: the K-tile chain is a
// TPU re-view of the same pair bytes, and this kernel reads the bytes as they
// are, so one kernel serves every TileSpec, fuse > 1 included. The device
// code and its design live in tile_bwd.cuh, which the fused train steps
// (tile_step.cu) share, so split and fused sum every bucket in the same
// order.
//
// What bounds it: bytes. Per full-width criteo block (2^22 buckets, 98,304
// rows) it must read the pair words (17.3 MB) and the f32 dual (0.39 MB)
// and write the gradient (16.8 MB): about 0.010 ms at 3.35 TB/s. The TPU ran
// it as one-hot MXU matmuls; Hopper gathers the dual directly. The design
// reads the words once, writes and reads one packed value per word (17.3 MB
// of scratch each way), and gives each 512-bucket bin of a tile its own
// warp, which owns its buckets outright, reads only its words and writes
// each bucket once (the slab design it replaces had every warp of a tile's
// CTA read all of the tile's words, PERF.md).

#include "tile_bwd.cuh"

extern "C" {

// grad (T*16384,) f32 from pw (T, SG, GS*C) i32 and the f32 dual rows
// (SG*GS*8192,), rounded to bf16 in the kernel, with `spans` bins a tile;
// scratch (scratch_words u32) holds one u32 per word of pw, then the bin
// starts (tilemm._span_scratch). Launches on `stream`, does not
// synchronise, returns cudaGetLastError() after each launch (0 = success),
// cudaErrorInvalidValue for a missing or too small scratch or a span count
// other than wh::NBIN (32 bins of 512 buckets a tile).
int wh_tile_bwd(const int32_t* pw, const float* dual, unsigned* scratch,
                long long scratch_words, float* grad, int T, int SG, int GS,
                int C, int spans, void* stream) {
  return wh::launch_bwd<wh::BwdBins>(pw, dual, scratch, scratch_words, T, SG,
                                     GS, C, spans,
                                     wh::BwdGrad<wh::BwdBins>{grad},
                                     static_cast<cudaStream_t>(stream));
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
