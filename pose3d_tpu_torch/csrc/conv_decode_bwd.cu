// The backward of the fused 1x1-conv decode (conv_decode.cu), for Hopper
// (sm_90a). From the gradient g (B, J, 3) f32 of the expectations [Ex, Ey,
// Ez], the expectations e and the forward's per-joint maximum m and sum s
// (softargmax.cuh), with the logits l = feats @ W^T + b recomputed as the
// forward computes them and p / s = exp(l - m) / s:
//
//   dslab  = p / s * (gx (xi - Ex) + gy (yi - Ey) + gz (d - Ez))   f32
//   dfeats = sum_j bf16(dslab_j) @ W_j      f32 sums, written bf16 once
//   dW_j   = sum_tiles bf16(dslab_j)^T @ feats    f32 sums, written bf16
//   db_j   = sum_tiles column sums of dslab_j     f32
//
// feats (B, H, W, 256) bf16 NHWC, W (J * 64, 256) bf16, b (J * 64) f32;
// dfeats in the feats' layout. The products take bf16 operands, so dslab
// is rounded to bf16 before each; db sums it unrounded.
//
// Replaces pose3d_tpu/ops/pallas_conv_decode.py:124 _bwd_kernel (the
// pallas_call at :238 in _fused_vjp_bwd :225).
//
// What bounds it on this card: operations. Three products of 2 * B * H *
// W * 256 * J * 64 flops each (the recompute, dfeats and dW: 146 GFLOP
// each at B = 64, H = W = 64, J = 17; 0.44 ms at 989 TFLOP/s), against
// 134 MB of features read and 134 MB of dfeats written (0.08 ms).
//
// Why not the TPU's design: the TPU walks the batch in order on one core
// (grid (B,)) and keeps dW and db in VMEM across its steps. Here blocks
// run side by side, and a partial of the whole dW (1.1 MB f32) per CTA of
// 128 pixels would be 2.3 GB. So three launches, no atomics, bitwise
// repeatable:
//
// A (dfeats_kernel): a CTA per (sample, 128-pixel tile), as the forward.
//   For each joint it recomputes the tile's 128 x 64 logits (the slabs
//   stream through a two-slab cp.async ring), forms dslab in registers,
//   rounds it to bf16 into shared memory and adds dslab @ W_j to a 128 x
//   256 f32 accumulator held in registers (8 warps, 32 x 128 each, 128
//   registers a thread); it writes dfeats once.
// B (dweight_kernel): a CTA per (joint, group of tiles). W_j stays in
//   shared memory; the group's feature tiles stream through two cp.async
//   buffers; per tile it recomputes the joint's logits and dslab, adds
//   bf16(dslab)^T @ feats to a 64 x 256 f32 accumulator (8 warps, 32 x 64
//   each) and dslab's column sums to db; it writes one partial per
//   (group, joint). The wrapper picks the groups: about four CTAs an SM.
// C (fold_kernel): folds the groups' partials in group order and casts
//   dW to bf16.
//
// So it computes four products where the TPU computes three (the logits
// twice): the price of keeping dslab (1.1 GB in f32 at B = 64) out of
// device memory.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing (the wrapper allocates the outputs and the partials),
// and returns cudaGetLastError().

#include "conv_decode.cuh"

namespace {

using namespace pose3d;

constexpr int kLdS = kDepth + 8;  // pitch of the bf16 dslab tile (kTilePixels x kDepth)
constexpr int kDslabElems = kTilePixels * kLdS;
// A: dfeats, warp (wm, wn) of the 4 x 2 owns rows 32 wm.. and columns 128 wn..
constexpr int kDfCols = kFeat / kDecodeWarpsN;
constexpr int kDfFragN = kDfCols / 8;
// B: dW_j, warp (wm, wn) of 2 x 4 owns depth rows 32 wm.. and columns 64 wn..
constexpr int kDwWarpsN = 4;
constexpr int kDwRows = kDepth / (kDecodeWarps / kDwWarpsN);
constexpr int kDwCols = kFeat / kDwWarpsN;
constexpr int kDwFragM = kDwRows / 16;
constexpr int kDwFragN = kDwCols / 8;

constexpr size_t kSmemA = size_t(kTileElems + 2 * kSlabElems + kDslabElems) * sizeof(bf16);
constexpr size_t kSmemB = size_t(2 * kTileElems + kSlabElems + kDslabElems) * sizeof(bf16) +
                          size_t(kDecodeWarpsM) * kDepth * sizeof(float);
constexpr int kFoldThreads = 256;

static_assert(kSmemA <= size_t(kSmemLimit) && kSmemB <= size_t(kSmemLimit), "shared memory");
static_assert(kDwRows == 32 && kDfFragN % 2 == 0 && kDwFragN % 2 == 0, "tiling");

// dslab of warp (wm, wn)'s 32 x 32 logits of joint j on the tile at pixel
// p0 -> bf16 into ds; rows past the last pixel give 0. Where kColSums, the
// unrounded values are also added to colsum[n][i], the thread's columns 32
// wn + 8 n + 2 (lane % 4) + i.
template <bool kColSums>
__device__ __forceinline__ void form_dslab(const LogitAcc& acc, const float* __restrict__ bias_j,
                                           const GradCoef& c, int p0, int pixels, int width,
                                           int wm, int wn, int lane, bf16* ds,
                                           float (&colsum)[kFragN][2]) {
  const int g = lane / 4;
  const int q = lane % 4;
#pragma unroll
  for (int n = 0; n < kFragN; ++n) {
    const int d = wn * kWarpCols + n * 8 + 2 * q;
    const float2 bv = *reinterpret_cast<const float2*>(bias_j + d);
#pragma unroll
    for (int m = 0; m < kFragM; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * kWarpRows + m * 16 + g + h * 8;
        const int pix = p0 + row;
        float v0 = 0.f, v1 = 0.f;
        if (pix < pixels) {
          const float xi = float(pix % width);
          const float yi = float(pix / width);
          v0 = c.grad(acc[m][n][2 * h] + bv.x, xi, yi, float(d));
          v1 = c.grad(acc[m][n][2 * h + 1] + bv.y, xi, yi, float(d + 1));
        }
        if (kColSums) {
          colsum[n][0] += v0;
          colsum[n][1] += v1;
        }
        store2(ds + row * kLdS + d, v0, v1);
      }
  }
}

// grid (n_tiles, B), kDecodeThreads threads: launch A.
__global__ void __launch_bounds__(kDecodeThreads, 1)
dfeats_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ weight,
              const float* __restrict__ bias, const float* __restrict__ g,
              const float* __restrict__ e, const float* __restrict__ stats,
              bf16* __restrict__ dfeats, int pixels, int width, int joints) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = a_s + kTileElems;  // two slabs
  bf16* ds = w_s + 2 * kSlabElems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kDecodeWarpsN;
  const int wn = warp % kDecodeWarpsN;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTilePixels;

  load_feature_tile(a_s, feats + size_t(b) * pixels * kFeat, p0, pixels);
  load_slab(w_s, weight, 0);
  cp_async_commit();
  if (joints > 1) load_slab(w_s + kSlabElems, weight, 1);
  cp_async_commit();

  float df[kFragM][kDfFragN][4];
#pragma unroll
  for (int m = 0; m < kFragM; ++m)
#pragma unroll
    for (int n = 0; n < kDfFragN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) df[m][n][i] = 0.f;
  // ldmatrix row addresses of this lane: dslab rows lane % 16 (+ 16 m) at
  // depth offset (lane / 16) * 8; slab rows (depth) lane % 16 at feature
  // column 128 wn + (lane / 16) * 8 (+ 16 h), transposed: K x N rows give
  // the column fragments
  const unsigned ds_lane =
      smem_u32(ds) + ((wm * kWarpRows + lane % 16) * kLdS + (lane / 16) * 8) * 2;
  const unsigned wt_lane = ((lane % 16) * kLd + wn * kDfCols + (lane / 16) * 8) * 2;
  float unused[kFragN][2];

  for (int j = 0; j < joints; ++j) {
    cp_async_wait<1>();  // slab j (and, for j = 0, the feature tile) has landed
    __syncthreads();
    const bf16* slab = w_s + (j % 2) * kSlabElems;
    {
      LogitAcc acc;
      slab_logits(a_s, slab, wm, wn, lane, acc);
      form_dslab<false>(acc, bias + j * kDepth, GradCoef::load(g, e, stats, b * joints + j), p0,
                        pixels, width, wm, wn, lane, ds, unused);
    }
    __syncthreads();  // the tile's dslab is whole
    const unsigned wt = smem_u32(slab) + wt_lane;
#pragma unroll
    for (int k = 0; k < kDepth / 16; ++k) {
      unsigned af[kFragM][4];
#pragma unroll
      for (int m = 0; m < kFragM; ++m) ldsm_x4(af[m], ds_lane + (m * 16 * kLdS + k * 16) * 2);
#pragma unroll
      for (int h = 0; h < kDfFragN / 2; ++h) {
        unsigned bfr[4];
        ldsm_x4_trans(bfr, wt + (k * 16 * kLd + h * 16) * 2);
#pragma unroll
        for (int m = 0; m < kFragM; ++m) {
          mma_bf16(df[m][2 * h], af[m], bfr[0], bfr[1]);
          mma_bf16(df[m][2 * h + 1], af[m], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with dslab and this slab's buffer
    if (j + 2 < joints) load_slab(w_s + (j % 2) * kSlabElems, weight, j + 2);
    cp_async_commit();  // an empty group past the end keeps the count
  }

  const int gr = lane / 4;
  const int q = lane % 4;
  bf16* out = dfeats + size_t(b) * pixels * kFeat;
#pragma unroll
  for (int m = 0; m < kFragM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = p0 + wm * kWarpRows + m * 16 + gr + h * 8;
      if (pix >= pixels) continue;
#pragma unroll
      for (int n = 0; n < kDfFragN; ++n)
        store2(out + size_t(pix) * kFeat + wn * kDfCols + n * 8 + 2 * q, df[m][n][2 * h],
               df[m][n][2 * h + 1]);
    }
}

// grid (J, groups), kDecodeThreads threads: launch B. Group `grp` takes
// tiles [grp * total / groups, (grp + 1) * total / groups) of the batch's
// tiles, tile t being sample t / n_tiles, pixels from (t % n_tiles) *
// kTilePixels. part_w: (groups, J * kDepth, kFeat); part_b: (groups, J *
// kDepth).
__global__ void __launch_bounds__(kDecodeThreads, 1)
dweight_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ weight,
               const float* __restrict__ bias, const float* __restrict__ g,
               const float* __restrict__ e, const float* __restrict__ stats,
               float* __restrict__ part_w, float* __restrict__ part_b, int pixels, int width,
               int joints, int n_tiles, int total) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* f_s = reinterpret_cast<bf16*>(smem);  // two feature tiles
  bf16* w_s = f_s + 2 * kTileElems;
  bf16* ds = w_s + kSlabElems;
  float* red = reinterpret_cast<float*>(ds + kDslabElems);  // (kDecodeWarpsM, kDepth)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kDecodeWarpsN;  // the logits' 4 x 2
  const int wn = warp % kDecodeWarpsN;
  const int dm = warp / kDwWarpsN;      // dW's 2 x 4
  const int dn = warp % kDwWarpsN;
  const int j = blockIdx.x;
  const int grp = blockIdx.y;
  const int t0 = int(static_cast<long long>(grp) * total / gridDim.y);
  const int t1 = int(static_cast<long long>(grp + 1) * total / gridDim.y);
  auto load_tile = [&](int t, bf16* dst) {
    load_feature_tile(dst, feats + size_t(t / n_tiles) * pixels * kFeat,
                      (t % n_tiles) * kTilePixels, pixels);
  };

  load_slab(w_s, weight, j);
  if (t0 < t1) load_tile(t0, f_s);
  cp_async_commit();
  if (t0 + 1 < t1) load_tile(t0 + 1, f_s + kTileElems);
  cp_async_commit();

  float dw[kDwFragM][kDwFragN][4];
#pragma unroll
  for (int m = 0; m < kDwFragM; ++m)
#pragma unroll
    for (int n = 0; n < kDwFragN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dw[m][n][i] = 0.f;
  float colsum[kFragN][2] = {};
  // ldmatrix row addresses of this lane: dslab^T's A fragments from the
  // (pixel x depth) tile, transposed: pixel rows lane % 8 + (lane / 16) *
  // 8 at depth column 32 dm + ((lane / 8) % 2) * 8 (+ 16 m); feature rows
  // (pixels) lane % 16 at column 64 dn + (lane / 16) * 8 (+ 16 h),
  // transposed
  const unsigned ds_lane =
      smem_u32(ds) +
      ((lane % 8 + (lane / 16) * 8) * kLdS + dm * kDwRows + ((lane / 8) % 2) * 8) * 2;
  const unsigned ft_lane = ((lane % 16) * kLd + dn * kDwCols + (lane / 16) * 8) * 2;

  for (int t = t0; t < t1; ++t) {
    cp_async_wait<1>();  // tile t (and, for t0, the slab) has landed
    __syncthreads();
    const bf16* ft = f_s + ((t - t0) % 2) * kTileElems;
    {
      LogitAcc acc;
      slab_logits(ft, w_s, wm, wn, lane, acc);
      form_dslab<true>(acc, bias + j * kDepth,
                       GradCoef::load(g, e, stats, (t / n_tiles) * joints + j),
                       (t % n_tiles) * kTilePixels, pixels, width, wm, wn, lane, ds, colsum);
    }
    __syncthreads();  // the tile's dslab is whole
    const unsigned fb = smem_u32(ft) + ft_lane;
#pragma unroll 2
    for (int k = 0; k < kTilePixels / 16; ++k) {
      unsigned af[kDwFragM][4];
#pragma unroll
      for (int m = 0; m < kDwFragM; ++m)
        ldsm_x4_trans(af[m], ds_lane + (k * 16 * kLdS + m * 16) * 2);
#pragma unroll
      for (int h = 0; h < kDwFragN / 2; ++h) {
        unsigned bfr[4];
        ldsm_x4_trans(bfr, fb + (k * 16 * kLd + h * 16) * 2);
#pragma unroll
        for (int m = 0; m < kDwFragM; ++m) {
          mma_bf16(dw[m][2 * h], af[m], bfr[0], bfr[1]);
          mma_bf16(dw[m][2 * h + 1], af[m], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with dslab and this tile's buffer
    if (t + 2 < t1) load_tile(t + 2, f_s + ((t - t0) % 2) * kTileElems);
    cp_async_commit();  // an empty group past the end keeps the count
  }

  const int gr = lane / 4;
  const int q = lane % 4;
  float* pw = part_w + (size_t(grp) * joints + j) * kDepth * kFeat;
#pragma unroll
  for (int m = 0; m < kDwFragM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = dm * kDwRows + m * 16 + gr + h * 8;
#pragma unroll
      for (int n = 0; n < kDwFragN; ++n)
        *reinterpret_cast<float2*>(pw + d * kFeat + dn * kDwCols + n * 8 + 2 * q) =
            make_float2(dw[m][n][2 * h], dw[m][n][2 * h + 1]);
    }
  // db: the column sums over the lanes of a column (lane / 4), then over
  // the four row warps in order
#pragma unroll
  for (int n = 0; n < kFragN; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = colsum[n][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gr == 0) red[wm * kDepth + wn * kWarpCols + n * 8 + 2 * q + i] = v;
    }
  __syncthreads();
  if (threadIdx.x < kDepth) {
    float s = 0.f;
    for (int w = 0; w < kDecodeWarpsM; ++w) s += red[w * kDepth + threadIdx.x];
    part_b[(size_t(grp) * joints + j) * kDepth + threadIdx.x] = s;
  }
}

// launch C: dw[i] = bf16(sum over groups of part_w), db[i] = the same of
// part_b, each in group order.
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(const float* __restrict__ part_w,
                                                            const float* __restrict__ part_b,
                                                            int groups, int n_w, int n_b,
                                                            bf16* __restrict__ dw,
                                                            float* __restrict__ db) {
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;
  if (i < n_w) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += part_w[size_t(k) * n_w + i];
    dw[i] = __float2bfloat16(s);
  } else if (i < n_w + n_b) {
    const int k0 = i - n_w;
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += part_b[size_t(k) * n_b + k0];
    db[k0] = s;
  }
}

}  // namespace

// feats: (batch, height, width, channels) bf16; weight: (joints * depth,
// channels) bf16; bias: (joints * depth) f32; g, e: (batch, joints, 3) f32,
// the gradient of the expectations and the expectations; stats: the
// forward's (batch, joints, 2) f32 [m, s]; dfeats: the feats' shape, bf16;
// dweight: the weight's shape, bf16; dbias: (joints * depth) f32;
// partials: (groups, joints * depth * (channels + 1)) f32 scratch. Every
// pointer contiguous and 16-byte aligned. channels, depth and tile_pixels
// are the caller's idea of the kernel's widths: a mismatch, a batch past
// the grid's limit or groups outside [1, the batch's tiles] returns
// cudaErrorInvalidValue. Three launches in a row on the calling thread's
// current device; the first error ends the sequence and is returned.
extern "C" cudaError_t conv_decode_bwd_launch(const void* feats, const void* weight,
                                              const void* bias, const void* g, const void* e,
                                              const void* stats, void* dfeats, void* dweight,
                                              void* dbias, void* partials, int groups, int batch,
                                              int height, int width, int channels, int joints,
                                              int depth, int tile_pixels, void* stream) {
  const int pixels = height * width;
  const int n_tiles = (pixels + kTilePixels - 1) / kTilePixels;
  if (channels != kFeat || depth != kDepth || tile_pixels != kTilePixels || batch < 1 ||
      batch > 65535 || height < 1 || width < 1 || joints < 1 || joints > 65535 || groups < 1 ||
      groups > batch * n_tiles || groups > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dfeats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemA));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dweight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemB));
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const bf16*>(feats);
  const auto* w = static_cast<const bf16*>(weight);
  const auto* bs = static_cast<const float*>(bias);
  const auto* gp = static_cast<const float*>(g);
  const auto* ep = static_cast<const float*>(e);
  const auto* st = static_cast<const float*>(stats);
  dfeats_kernel<<<dim3(n_tiles, batch), kDecodeThreads, kSmemA, s>>>(
      f, w, bs, gp, ep, st, static_cast<bf16*>(dfeats), pixels, width, joints);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_w = joints * kDepth * kFeat;
  const int n_b = joints * kDepth;
  auto* part_w = static_cast<float*>(partials);
  float* part_b = part_w + size_t(groups) * n_w;
  dweight_kernel<<<dim3(joints, groups), kDecodeThreads, kSmemB, s>>>(
      f, w, bs, gp, ep, st, part_w, part_b, pixels, width, joints, n_tiles, batch * n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_kernel<<<(n_w + n_b + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, s>>>(
      part_w, part_b, groups, n_w, n_b, static_cast<bf16*>(dweight), static_cast<float*>(dbias));
  return cudaGetLastError();
}
