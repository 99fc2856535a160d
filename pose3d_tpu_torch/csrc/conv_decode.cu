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
// against 134 MB of features (0.040 ms at 3.35 TB/s). The J weight slabs
// (557 KB) stay in L2; each tile of 128 pixels reads them all once, 1.1 GB
// a call from L2 at the main shapes.
//
// Why not the TPU's design: the TPU takes a whole sample per grid step
// (grid = (B,), 64 steps), its 128-lane pair slabs with a padded 18th
// joint whose bias is -1e30. Here 64 CTAs would fill 64 of 132 SMs, and a
// joint of 64 channels is a natural wgmma width, so there is no pad joint
// and no sentinel. The design, built as the backward's launch A is: a
// persistent CTA an SM walks the (sample, 128-pixel) tiles with two
// consumer warpgroups of 64 pixels each and no producer warpgroup (a third
// warpgroup would cap every thread at 168 registers). Its thread 0 loads
// each tile's features by TMA (zeros past the sample's last pixel) once
// the last tile is done with the buffer, and feeds the J weight slabs (64
// x 256, 32 KB) by TMA through a 5-stage mbarrier ring that runs on into
// the next tile (the tile and the five stages fill the 227 KB). Per joint
// each warpgroup computes its 64 x 64 logits with wgmma (conv_decode.cuh
// issue_logits: the backward's sequence on the same layouts, so its
// recompute is bitwise these logits), waits for them, hands the slab back
// and reduces them in registers and warp shuffles to the warp's softmax
// partial (maximum, exp2, s, sx, sy, sz) while the other warpgroup's
// product runs. Lane j % 32 of each warp keeps the warp's partial of joint
// j in registers; at the end of the tile each warpgroup writes its warps'
// over its half of the feature buffer (read by no product any more), and
// the warps fold each joint's 8 warp partials by shuffles in a fixed order
// (warpgroup 0's warps, then warpgroup 1's) into the tile partial (B * J,
// n_tiles, 5). merge_kernel (softargmax.cuh) folds the tiles in tile
// order. Two launches, no atomics: two calls are bitwise equal.
//
// Measured on the way (experiments/decode_fwd_ablation.py, H100 80GB HBM3,
// 700 W): the products and the slab stream alone take 0.37 ms, 38% of the
// tensor peak (the backward's launch A runs its products at the same
// share); with the partials 0.51. A warpgroup issuing joint j + 1's
// product before joint j's partial (two accumulators) ran at 0.56, and so
// did the warpgroups taking turns on the tensor cores by named barriers; a
// 3-stage ring with two feature buffers (the next tile's features loaded a
// tile ahead) ran at 0.53; CTAs starting their tiles at different joints
// moved it by 2% or less. Replaced: the first version, a CTA per (sample,
// tile) on ldmatrix + mma.sync m16n8k16 with a two-slab cp.async ring, two
// block barriers a joint and the epilogue in series with the products
// (0.92 ms).
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing (the wrapper allocates the partials and the output),
// and returns cudaGetLastError().

#include "conv_decode.cuh"

namespace {

using namespace pose3d;  // rt: conv_decode.cuh's alias of pose3d::rowtile

constexpr int kStages = 5;                       // the slab ring
constexpr int kThreads = rt::kConsumers * 128;   // two warpgroups, no producer warpgroup
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJoints = 128;                  // lane l keeps joints l, l + 32, ...
constexpr int kLanePartials = kMaxJoints / 32;
constexpr size_t kSmem = 1024 + size_t(kStages) * rt::kStageBytes + rt::kActBytes +
                         8 * (2 * kStages + 1);
static_assert(kSmem <= size_t(kSmemLimit), "shared memory");
static_assert(size_t(kMaxJoints) * 4 * kPartial * sizeof(float) <= size_t(rt::kWgActBytes),
              "a warpgroup's half of a tile buffer holds its warps' partials");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The bias of depth columns 8c + 2q and + 1 of one joint.
__device__ __forceinline__ void load_bias(float2 (&bv)[8], const float* __restrict__ bias_j,
                                          int q) {
#pragma unroll
  for (int c = 0; c < 8; ++c) bv[c] = *reinterpret_cast<const float2*>(bias_j + 8 * c + 2 * q);
}

// A warp's softmax partial of one joint over its 16 pixel rows (ra, ra + 8
// of each thread) and 64 depths, from the warpgroup's logits acc, whose
// product has completed; the bias is added in place: acc[4c + 2h + i] is
// row ra + 8h, depth 8c + 2q + i. Rows that are not pixels count for
// nothing; a warp with no pixel gives the empty partial (m = -inf, sums 0).
__device__ __forceinline__ Partial joint_partial(float (&acc)[32], const float2 (&bv)[8],
                                                 const Rows& rows, int q) {
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * c + 2 * h] += bv[c].x;
      acc[4 * c + 2 * h + 1] += bv[c].y;
      if (rows.ok[h]) mx = fmaxf(mx, fmaxf(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]));
    }
  Partial pt;
  pt.m = warp_max(mx);
  float ps[2] = {0.f, 0.f}, pz = 0.f;  // pz: sum of e (8c + i); the 2q is added below
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // m * log2e unrounded; a row that is not a pixel selects 0 (its
        // exponent may be +inf where the warp has no pixel)
        const float e = rows.ok[h] ? ex2((acc[4 * c + 2 * h + i] - pt.m) * kLog2e) : 0.f;
        ps[h] += e;
        pz = fmaf(e, float(8 * c + i), pz);
      }
  const float s = ps[0] + ps[1];
  pt.s = warp_sum(s);
  pt.sx = warp_sum(fmaf(ps[0], rows.xi[0], ps[1] * rows.xi[1]));
  pt.sy = warp_sum(fmaf(ps[0], rows.yi[0], ps[1] * rows.yi[1]));
  pt.sz = warp_sum(fmaf(s, float(2 * q), pz));
  return pt;
}

// grid: persistent, kThreads threads: n_tiles (sample, 128-pixel) tiles,
// tiles_per_sample a sample; part: (B * J, tiles_per_sample, 5).
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const __grid_constant__ CUtensorMap feat_map,
              const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
              float* __restrict__ part, int pixels, int width, int joints, int tiles_per_sample,
              int n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring_p = align1024(smem_raw);
  unsigned char* feat = ring_p + kStages * rt::kStageBytes;  // the tile's features
  const uint32_t bars = smem_u32(feat + rt::kActBytes);
  const uint32_t feat_full = bars + 16 * kStages;
  if (threadIdx.x == 0) {
    rt::mbar_init(feat_full, 1);
    rt::ring_init<kStages>(bars);
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int gw = threadIdx.x / 32;  // the warp's place in the fold
  const int warp = gw % 4, lane = threadIdx.x % 32;
  const int ra = 16 * warp + lane / 4, q = lane % 4;
  const bool feeder = threadIdx.x == 0;
  const int my_tiles = (n_tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  auto tile_of = [&](int it, int* b, int* p0) {  // this CTA's it-th tile
    const int tile = int(blockIdx.x) + it * int(gridDim.x);
    *b = tile / tiles_per_sample;
    *p0 = (tile % tiles_per_sample) * kTilePixels;
  };
  auto load_tile = [&](int it) {
    int b, p0;
    tile_of(it, &b, &p0);
    load_feature_tile(smem_u32(feat), &feat_map, feat_full, p0, b);
  };
  if (feeder && my_tiles > 0) load_tile(0);

  rt::Ring<kStages> ring{smem_u32(ring_p), bars, 0};
  SlabFeed<kStages> slabs{{smem_u32(ring_p), bars, 0}, &w_map, joints, my_tiles * joints};
  // warp 0 waits while its thread 0 feeds the ring up to the chunk it takes
  auto acquire = [&]() {
    if (feeder) slabs.feed(ring.next);
    __syncwarp();
    return ring.acquire();
  };
  float acc[32];
  Partial mine[kLanePartials];  // lane l: the warp's partials of joints l, l + 32, ...

  for (int it = 0; it < my_tiles; ++it) {
    int b, p0;
    tile_of(it, &b, &p0);
    const uint32_t fa = smem_u32(feat) + wg * rt::kWgActBytes;
    const Rows rows(p0 + wg * rt::kWgRows, ra, pixels, width);
    float2 bv[8];
    rt::mbar_wait(feat_full, it & 1);
    // per joint: the product, its slab back to the ring, the softmax
    // partial (the other warpgroup's product runs meanwhile)
#pragma unroll 1
    for (int j = 0; j < joints; ++j) {
      load_bias(bv, bias + j * kDepth, q);  // under the product
      issue_logits(acc, fa, acquire());
      rt::wgmma_wait<0>();
      ring.release(ring.next - 1);
      rt::fence_acc(acc);
      const Partial pt = joint_partial(acc, bv, rows, q);
#pragma unroll
      for (int k = 0; k < kLanePartials; ++k)
        if (j == lane + 32 * k) mine[k] = pt;
    }

    // every product of this warpgroup's tile rows has completed: its warps'
    // partials go over its half of the feature buffer, (joint, warp, 5)
    auto scratch = [&](int w) {  // warp w's (of the block) scratch
      return reinterpret_cast<float*>(feat + (w / 4) * rt::kWgActBytes) + (w % 4) * kPartial;
    };
#pragma unroll
    for (int k = 0; k < kLanePartials; ++k) {
      const int j = lane + 32 * k;
      if (j < joints) mine[k].store(scratch(gw) + j * 4 * kPartial);
      mine[k] = Partial();
    }
    rt::fence_proxy_async();  // these writes before the buffer's next TMA load
    __syncthreads();
    // warp gw folds joints gw + 8g (+ 32 r), g = lane / 8, each from its 8
    // warp partials on lanes 8g ... 8g + 7, in warp order
    for (int jf = gw; jf < joints; jf += 4 * kWarps) {
      const int j = jf + kWarps * (lane / 8);
      Partial p;
      if (j < joints) p = Partial::load(scratch(lane % 8) + j * 4 * kPartial);
      merge_lane(p, 1);
      merge_lane(p, 2);
      merge_lane(p, 4);
      if (lane % 8 == 0 && j < joints)
        p.store(part + ((size_t(b) * joints + j) * tiles_per_sample + p0 / kTilePixels) *
                           kPartial);
    }
    __syncthreads();  // the fold has read the scratch: the buffer takes the next tile
    if (feeder && it + 1 < my_tiles) load_tile(it + 1);
  }
}

}  // namespace

// feats: (batch, height, width, channels) bf16; weight: (joints * depth,
// channels) bf16; bias: (joints * depth) f32; every pointer contiguous and
// 16-byte aligned. partials: (batch * joints, ceil(height * width /
// tile_pixels), 5) f32 scratch; out: (batch, joints, 3) f32; stats:
// (batch, joints, 2) f32 [m, s], or null where no backward follows. channels,
// depth and tile_pixels are the caller's idea of the kernel's widths: a
// mismatch, a batch past 65535 or more than kMaxJoints (128) joints returns
// cudaErrorInvalidValue. Two launches in a row on the calling thread's
// current device; the first error ends the sequence and is returned.
extern "C" cudaError_t conv_decode_launch(const void* feats, const void* weight, const void* bias,
                                          void* partials, void* out, void* stats, int batch,
                                          int height, int width, int channels, int joints,
                                          int depth, int tile_pixels, void* stream) {
  const int pixels = height * width;
  const int tiles_per_sample = (pixels + kTilePixels - 1) / kTilePixels;
  if (channels != kFeat || depth != kDepth || tile_pixels != kTilePixels || batch < 1 ||
      batch > 65535 || height < 1 || width < 1 || joints < 1 || joints > kMaxJoints ||
      static_cast<long long>(batch) * tiles_per_sample > (1 << 30))
    return cudaErrorInvalidValue;
  CUtensorMap m_feat, m_w;
  cudaError_t err = pixel_map(&m_feat, static_cast<const bf16*>(feats), batch, pixels);
  if (err == cudaSuccess)
    err = tile_map(&m_w, static_cast<const bf16*>(weight), joints * kDepth, kFeat, kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
  const int n_tiles = batch * tiles_per_sample;
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(n_tiles, &grid);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partials);
  decode_kernel<<<grid, kThreads, kSmem, s>>>(m_feat, m_w, static_cast<const float*>(bias), part,
                                              pixels, width, joints, tiles_per_sample, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = batch * joints;
  merge_kernel<kMergeThreads><<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      part, tiles_per_sample, n, static_cast<float*>(out), static_cast<float*>(stats));
  return cudaGetLastError();
}
