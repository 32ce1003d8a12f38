// Tile forward margins on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces wormhole_tpu/ops/tilemm.py `_fwd_kernel` (:309, built by
// `_build_fwd` :573). The device code and its design live in tile_fwd.cuh,
// which tile_step.cu shares as phase 1 of the train step: a tile pass, then
// one launch of row-span CTAs, each owning its rows outright and summing
// each row in word order, so the margins equal tilemm.forward_margins_plain
// bitwise.
//
// What bounds it. The byte bound is the pair words (17.3 MB), w once
// (16.8 MB) and the margins (0.39 MB) per full-width criteo block. The TPU
// kernel turned the gather into one-hot MXU matmuls because the TPU has no
// fast gather; Hopper has one, and w fits the 50 MB L2, so this kernel is a
// direct gather, from a tile's w slice in shared memory. Its two launches
// read the words and w once, and write and read one packed value per word
// (17.3 MB) (tile_fwd.cuh, PERF.md).

#include "tile_fwd.cuh"

extern "C" {

// margins (S*8192,) f32 from pw (T, SG, GS*C) i32 and w (T*16384,) f32,
// with R rows a CTA; scratch (scratch_words u32) holds one u32 per word of
// pw, then S * T * ceil(C/1024) * (ceil(8192/R) + 1) u16 of span starts.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after each launch (0 = success), cudaErrorInvalidValue
// for a missing or too small scratch.
int wh_tile_fwd(const int32_t* pw, const float* w, unsigned* scratch,
                long long scratch_words, float* margins, int T, int SG,
                int GS, int C, int R, void* stream) {
  return wh::launch_fwd<wh::ROW_WARPS, wh::ROW_U>(
      pw, w, scratch, scratch_words, T, SG, GS, C, R,
      wh::FwdMargins{margins}, static_cast<cudaStream_t>(stream));
}

const char* wh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
