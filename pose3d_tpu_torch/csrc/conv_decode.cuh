// The widths of the fused 1x1-conv decode (conv_decode.cu) and its
// backward (conv_decode_bwd.cu), and the forward's logits product. A CTA
// of the forward holds a tile of kTilePixels feature rows (kFeat bf16
// each) and a joint's weight slab (kDepth x kFeat, the rows of the conv's
// (out, in) matrix that belong to the joint) in shared memory at a pitch
// of kLd, and its 8 warps (4 x 2, 32 x 32 logits each) compute the tile's
// kTilePixels x kDepth logits of the joint with ldmatrix + mma.sync
// m16n8k16 (bf16 in, f32 accumulate). The backward recomputes the same
// logits on wgmma, which sums the 256 products in another order: its
// logits differ from the forward's by f32 rounding (a few ulps of |l|), so
// its p / s = exp(l - m) / s, with m and s from the forward, carries that
// relative error; chip_smoke.py holds its outputs to a float64 run.

#pragma once

#include "common.cuh"
#include "softargmax.cuh"

namespace pose3d {

constexpr int kFeat = 256;        // C: feature channels, the logits' K
constexpr int kDepth = 64;        // D: a joint's channels, a slab's N
constexpr int kTilePixels = 128;  // a CTA's pixels, the logits' M
constexpr int kDecodeWarpsM = 4;
constexpr int kDecodeWarpsN = 2;
constexpr int kDecodeWarps = kDecodeWarpsM * kDecodeWarpsN;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kWarpRows = kTilePixels / kDecodeWarpsM;  // 32
constexpr int kWarpCols = kDepth / kDecodeWarpsN;       // 32
constexpr int kFragM = kWarpRows / 16;
constexpr int kFragN = kWarpCols / 8;
// shared-memory row pitch in bf16 elements: 16 bytes of skew per row keep
// the 8 rows of an ldmatrix on distinct banks
constexpr int kLd = kFeat + 8;
constexpr int kSlabElems = kDepth * kLd;
constexpr int kTileElems = kTilePixels * kLd;
constexpr int kChunks = kFeat / 8;  // 16-byte copies per row

static_assert(kFragN % 2 == 0 && kFeat % 16 == 0, "tiling");

using LogitAcc = float[kFragM][kFragN][4];

// cp.async of the feature rows p0, ..., p0 + kTilePixels - 1 of one
// sample's (pixels x kFeat) features into dst; rows past the last pixel
// repeat it (their results are masked). All threads call it.
__device__ __forceinline__ void load_feature_tile(bf16* dst, const bf16* __restrict__ f, int p0,
                                                  int pixels) {
  for (int i = threadIdx.x; i < kTilePixels * kChunks; i += kDecodeThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    cp_async16(dst + r * kLd + c, f + size_t(min(p0 + r, pixels - 1)) * kFeat + c);
  }
}

// cp.async of joint `joint`'s weight slab into dst. All threads call it.
__device__ __forceinline__ void load_slab(bf16* dst, const bf16* __restrict__ weight, int joint) {
  const bf16* src = weight + size_t(joint) * kDepth * kFeat;
  for (int i = threadIdx.x; i < kDepth * kChunks; i += kDecodeThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    cp_async16(dst + r * kLd + c, src + size_t(r) * kFeat + c);
  }
}

// acc = warp (wm, wn)'s 32 x 32 block of tile @ slab^T (rows 32 wm + ...,
// depth columns 32 wn + ...). The m16n8 accumulators: acc[m][n][i] is row
// 32 wm + 16 m + lane / 4 + 8 (i / 2), column 32 wn + 8 n + 2 (lane % 4) +
// i % 2.
__device__ __forceinline__ void slab_logits(const bf16* tile, const bf16* slab, int wm, int wn,
                                            int lane, LogitAcc& acc) {
  // ldmatrix row addresses of this lane: feature rows lane % 16 (+ 16 m)
  // at k offset (lane / 16) * 8; weight rows (lane / 16) * 8 + lane % 8
  // (+ 16 h) at k offset ((lane / 8) % 2) * 8 (non-transposed: N x K rows
  // give the column fragments)
  const unsigned a_lane =
      smem_u32(tile) + ((wm * kWarpRows + lane % 16) * kLd + (lane / 16) * 8) * 2;
  const unsigned w_lane =
      smem_u32(slab) +
      ((wn * kWarpCols + (lane / 16) * 8 + lane % 8) * kLd + ((lane / 8) % 2) * 8) * 2;
#pragma unroll
  for (int m = 0; m < kFragM; ++m)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kFeat / 16; ++k) {
    unsigned af[kFragM][4], bfr[kFragN / 2][4];
#pragma unroll
    for (int m = 0; m < kFragM; ++m) ldsm_x4(af[m], a_lane + (m * 16 * kLd + k * 16) * 2);
#pragma unroll
    for (int h = 0; h < kFragN / 2; ++h) ldsm_x4(bfr[h], w_lane + (h * 16 * kLd + k * 16) * 2);
#pragma unroll
    for (int m = 0; m < kFragM; ++m)
#pragma unroll
      for (int n = 0; n < kFragN; ++n)
        mma_bf16(acc[m][n], af[m], bfr[n / 2][(n % 2) * 2], bfr[n / 2][(n % 2) * 2 + 1]);
  }
}

}  // namespace pose3d
