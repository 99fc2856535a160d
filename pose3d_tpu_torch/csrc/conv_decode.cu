// The direct model's final 1x1 conv fused into its volumetric soft-argmax,
// for Hopper (sm_90a): feats (B, H, W, 256) bf16 NHWC (the deconv head's
// output), weight (J * 64, 256) bf16 (the conv's (out, in) matrix, N x K),
// bias (J * 64) f32; logits = feats @ weight^T + bias in f32, then for
// each (sample, joint) a softmax over the joint's 64 x H x W logits,
// maximum subtracted, and the expected column, row and depth index: out
// (B, J, 3) f32 [Ex, Ey, Ez]. The logits never reach device memory. The
// wrapper (ops/conv_decode.py) scales them to coordinates. The backward is
// conv_decode_bwd.cu.
//
// Replaces pose3d_tpu/ops/pallas_conv_decode.py:98 _fwd_kernel (via
// _expectations_fused_fwd :186, entry conv_soft_argmax_3d_fused :277).
//
// What bounds it on this card: operations. 2 * B * H * W * 256 * J * 64
// flops (146 GFLOP at B = 64, H = W = 64, J = 17: 0.148 ms at 989 TFLOP/s)
// against 134 MB of features (0.040 ms at 3.35 TB/s).
//
// Why not the TPU's design: the TPU takes a whole sample per grid step
// (grid = (B,), 64 steps), its 128-lane pair slabs with a padded 18th
// joint whose bias is -1e30. Here 64 CTAs would fill 64 of 132 SMs, and
// a joint of 64 channels is a natural MMA width, so there is no pad joint
// and no sentinel. The design: a CTA per (sample, tile of 128 pixels)
// holds its 128 x 256 feature tile in shared memory and streams the J
// weight slabs (64 x 256 bf16 each, L2-resident) through a two-slab
// cp.async ring; 8 warps compute a slab's 128 x 64 logits
// (conv_decode.cuh), add the bias and reduce their logits to a softmax partial
// (softargmax.cuh) in registers and warp shuffles. At the end the CTA
// folds each joint's 8 warp partials in warp order into its tile partial,
// and merge_kernel folds the tiles in tile order. Two launches, no
// atomics: two calls are bitwise equal.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing (the wrapper allocates the partials and the output),
// and returns cudaGetLastError().

#include "conv_decode.cuh"

namespace {

using namespace pose3d;

constexpr size_t kSmemTiles = size_t(kTileElems + 2 * kSlabElems) * sizeof(bf16);
static_assert(kSmemTiles % 16 == 0, "the warp partials start aligned");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (n_tiles, B), kDecodeThreads threads; part: (B * J, n_tiles, 5).
__global__ void __launch_bounds__(kDecodeThreads, 1)
decode_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ weight,
              const float* __restrict__ bias, float* __restrict__ part, int pixels, int width,
              int joints) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = a_s + kTilePixels * kLd;  // two slabs
  float* wp = reinterpret_cast<float*>(smem + kSmemTiles);  // (J, warps, 5)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kDecodeWarpsN;
  const int wn = warp % kDecodeWarpsN;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = tile * kTilePixels;

  // the feature tile; rows past the last pixel repeat it and are masked
  load_feature_tile(a_s, feats + size_t(b) * pixels * kFeat, p0, pixels);
  load_slab(w_s, weight, 0);
  cp_async_commit();
  if (joints > 1) load_slab(w_s + kSlabElems, weight, 1);
  cp_async_commit();

  const int g = lane / 4;
  const int q = lane % 4;
  float rx[kFragM][2], ry[kFragM][2];
  bool ok[kFragM][2];
#pragma unroll
  for (int m = 0; m < kFragM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = p0 + wm * kWarpRows + m * 16 + g + h * 8;
      ok[m][h] = pix < pixels;
      rx[m][h] = float(pix % width);
      ry[m][h] = float(pix / width);
    }

  for (int j = 0; j < joints; ++j) {
    cp_async_wait<1>();  // slab j (and, for j = 0, the feature tile) has landed
    __syncthreads();
    LogitAcc acc;
    slab_logits(a_s, w_s + (j % 2) * kSlabElems, wm, wn, lane, acc);
    __syncthreads();  // every warp is done with this slab's buffer
    if (j + 2 < joints) load_slab(w_s + (j % 2) * kSlabElems, weight, j + 2);
    cp_async_commit();  // an empty group past the end keeps the count

    // bias, then this warp's 32 x 32 logits -> a softmax partial
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kFragN; ++n) {
      const int d = wn * kWarpCols + n * 8 + 2 * q;
      const float2 bv = *reinterpret_cast<const float2*>(bias + j * kDepth + d);
#pragma unroll
      for (int m = 0; m < kFragM; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[m][n][i] += (i % 2) ? bv.y : bv.x;
          if (ok[m][i / 2]) mx = fmaxf(mx, acc[m][n][i]);
        }
    }
    Partial pt;
    pt.m = warp_max(mx);
    if (pt.m != -INFINITY) {  // else every row of the warp is past the last pixel
#pragma unroll
      for (int n = 0; n < kFragN; ++n)
#pragma unroll
        for (int m = 0; m < kFragM; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (ok[m][i / 2]) {
              const float e = exp2f((acc[m][n][i] - pt.m) * kLog2e);  // m * log2e unrounded
              pt.s += e;
              pt.sx = fmaf(e, rx[m][i / 2], pt.sx);
              pt.sy = fmaf(e, ry[m][i / 2], pt.sy);
              pt.sz = fmaf(e, float(wn * kWarpCols + n * 8 + 2 * q + i % 2), pt.sz);
            }
      pt.s = warp_sum(pt.s);
      pt.sx = warp_sum(pt.sx);
      pt.sy = warp_sum(pt.sy);
      pt.sz = warp_sum(pt.sz);
    }
    if (lane == 0) pt.store(wp + (j * kDecodeWarps + warp) * kPartial);
  }

  __syncthreads();
  const int n_tiles = gridDim.x;
  for (int j = threadIdx.x; j < joints; j += kDecodeThreads) {
    Partial t;
    for (int w = 0; w < kDecodeWarps; ++w)
      t.merge(Partial::load(wp + (j * kDecodeWarps + w) * kPartial));
    t.store(part + ((size_t(b) * joints + j) * n_tiles + tile) * kPartial);
  }
}

}  // namespace

// feats: (batch, height, width, channels) bf16; weight: (joints * depth,
// channels) bf16; bias: (joints * depth) f32; every pointer contiguous and
// 16-byte aligned. partials: (batch * joints, ceil(height * width /
// tile_pixels), 5) f32 scratch; out: (batch, joints, 3) f32; stats:
// (batch, joints, 2) f32 [m, s], or null where no backward follows. channels,
// depth and tile_pixels are the caller's idea of the kernel's widths: a
// mismatch, a batch past the grid's limit or more joints than shared
// memory holds partials for returns cudaErrorInvalidValue. Two launches in
// a row on the calling thread's current device; the first error ends the
// sequence and is returned.
extern "C" cudaError_t conv_decode_launch(const void* feats, const void* weight, const void* bias,
                                          void* partials, void* out, void* stats, int batch,
                                          int height, int width, int channels, int joints,
                                          int depth, int tile_pixels, void* stream) {
  const size_t smem = kSmemTiles + size_t(joints) * kDecodeWarps * kPartial * sizeof(float);
  if (channels != kFeat || depth != kDepth || tile_pixels != kTilePixels || batch < 1 ||
      batch > 65535 || height < 1 || width < 1 || joints < 1 || smem > size_t(kSmemLimit))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const int pixels = height * width;
  const int n_tiles = (pixels + kTilePixels - 1) / kTilePixels;
  auto* part = static_cast<float*>(partials);
  decode_kernel<<<dim3(n_tiles, batch), kDecodeThreads, smem, s>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), part, pixels, width, joints);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = batch * joints;
  merge_kernel<kMergeThreads><<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      part, n_tiles, n, static_cast<float*>(out), static_cast<float*>(stats));
  return cudaGetLastError();
}
