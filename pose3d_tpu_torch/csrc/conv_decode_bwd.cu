// The backward of the fused 1x1-conv decode (conv_decode.cu), for Hopper
// (sm_90a). From the gradient g (B, J, 3) f32 of the expectations [Ex, Ey,
// Ez], the expectations e and the forward's per-joint maximum m and sum s
// (softargmax.cuh), with the logits l = feats @ W^T + b recomputed and
// p / s = exp(l - m) / s:
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
// each at B = 64, H = W = 64, J = 17; 0.443 ms at 989 TFLOP/s), against
// 134 MB of features read and 134 MB of dfeats written (0.08 ms). This
// design computes the logits twice, four products: 0.59 ms at the peak.
//
// Why not the TPU's design: the TPU walks the batch in order on one core
// (grid (B,)) and keeps dW and db in VMEM across its steps. Here blocks
// run side by side, and a partial of the whole dW (1.1 MB f32) per CTA of
// 128 pixels would be 2.3 GB. Nor does one recompute shared by dfeats and
// dW fit: all of W (17 x 64 x 256 bf16, 557 KB) is past the 227 KB of
// shared memory a block can have, and dslab written to device memory (570
// MB in bf16 at B = 64, written and read) costs more than the second
// recompute (0.15 ms at the peak). So three launches, no atomics, bitwise
// repeatable:
//
// A (dfeats_kernel), a persistent CTA an SM walking (sample, 128-pixel)
//   tiles, two warpgroups of 64 pixels each and no producer warpgroup:
//   ptxas budgets registers for the launch bound, so a third warpgroup
//   caps every thread at 168, where the 128-register dfeats accumulator
//   beside the logits' made ptxas serialise the wgmmas (1.5 ms; 0.72 ms
//   at 256 threads and up to 255 registers, H100 80GB HBM3, 700 W). Its
//   thread 0 loads each tile's features by TMA (zeros past the sample's
//   last pixel) and feeds the J weight slabs W_j (64 x 256, 32 KB) by TMA
//   through a 4-stage mbarrier ring. Per joint each warpgroup computes the
//   logits (wgmma m64n64k16, A the feature tile, B the slab K-major),
//   forms dslab in the accumulator registers, rounds it to bf16 into a
//   swizzled A buffer, and adds dslab @ W_j (m64n256k16, B the same slab
//   N-major, taken with the transpose flag) to a 64 x 256 f32
//   accumulator; joint j + 1's logits run while joint j's product does.
//   dfeats is staged over the feature tile and leaves by TMA stores.
// B (dweight_kernel), a CTA per (joint, group of 64-pixel chunks), on the
//   row-tile engine's three warpgroups: W_j stays in shared memory; the
//   producer warp streams the group's chunks by TMA through a 4-stage
//   ring. One chunk serves as A of the logits (K-major)
//   and as B of dW_j += dslab^T @ feats (N-major, transpose flag); dslab^T
//   is A with the transpose flag. The warpgroups split the work by N:
//   warpgroup w computes depth columns [32w, 32w + 32) of the logits
//   (m64n32k16) into a shared dslab buffer (three, in turn), and, once
//   both halves are in (one barrier of the two warpgroups a chunk), dW_j's
//   channels [128w, 128w + 128) (m64n128k16). It writes one partial per
//   (group, joint); the wrapper picks about four waves of CTAs.
// C (fold_kernel): folds the groups' partials in group order and casts
//   dW to bf16.
//
// Launch A's recompute of the logits is the forward's (conv_decode.cu)
// product: conv_decode.cuh's issue_logits on the same swizzled operands,
// so its logits are bitwise the forward's, and p / s = exp(l - m) / s is
// taken over the logits that m and s came from. chip_smoke.py still holds
// the outputs to a float64 run.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing (the wrapper allocates the outputs and the partials),
// and returns cudaGetLastError().

#include "conv_decode.cuh"
#include "rowtile_sm90.cuh"

namespace {

using namespace pose3d;  // rt: conv_decode.cuh's alias of pose3d::rowtile

constexpr int kStages = 4;
constexpr int kChunkPixels = 64;  // launch B's chunk: one wgmma M (ops/conv_decode.py CHUNK_PIXELS)
constexpr int kDsBytes = rt::kWgRows * kDepth * 2;    // a 64 x 64 bf16 dslab: 8 KB
constexpr int kDsBufs = 3;                            // launch B's dslab buffers
constexpr int kHalfDepth = kDepth / rt::kConsumers;   // launch B's logits columns a warpgroup
constexpr int kHalfFeat = kFeat / rt::kConsumers;     // launch B's dW columns a warpgroup
constexpr int kFoldThreads = 256;
constexpr int kThreadsA = rt::kConsumers * 128;  // launch A: no producer warpgroup
constexpr size_t kSmemA = 1024 + size_t(kStages) * rt::kStageBytes + rt::kActBytes +
                          2 * rt::kConsumers * kDsBytes + 8 * (2 * kStages + 2);
constexpr size_t kSmemB = 1024 + rt::kStageBytes + size_t(kStages) * rt::kStageBytes +
                          kDsBufs * kDsBytes + 4 * rt::kConsumers * 4 * kHalfDepth +
                          8 * (2 * kStages + 1);
static_assert(kSmemA <= size_t(kSmemLimit) && kSmemB <= size_t(kSmemLimit), "shared memory");
static_assert(kChunkPixels == rt::kWgRows, "a chunk is one wgmma M");

// One (sample, joint)'s gradient g, expectations e and forward statistics
// [m, s], as loaded (ahead of their use: the loads' latency then overlaps
// the products in flight).
struct CoefIn {
  float gx, gy, gz, ex, ey, ez, m, s;

  static __device__ __forceinline__ CoefIn load(const float* __restrict__ g,
                                                const float* __restrict__ e,
                                                const float* __restrict__ stats, int i) {
    return {g[i * 3], g[i * 3 + 1], g[i * 3 + 2], e[i * 3], e[i * 3 + 1], e[i * 3 + 2],
            stats[i * 2], stats[i * 2 + 1]};
  }
};

// The same at this thread's two rows: dslab at depth d of row h is
// exp2((l - m) log2 e) / s * (t[h] + gz (d - ez)), with t[h] = gx (xi -
// ex) + gy (yi - ey) (GradCoef's terms, folded per row so that six
// registers carry them through the dslab pass).
struct RowCoef {
  float m, inv_s, gz, ez, t[2];

  __device__ __forceinline__ RowCoef(const CoefIn& c, const Rows& rows) {
    m = c.m;
    inv_s = __frcp_rn(c.s);  // 1 / s, correctly rounded, without a division's call
    gz = c.gz;
    ez = c.ez;
#pragma unroll
    for (int h = 0; h < 2; ++h) t[h] = fmaf(c.gx, rows.xi[h] - c.ex, c.gy * (rows.yi[h] - c.ey));
  }

  // dslab of logit l in row h at a depth d whose d - ez is dz
  __device__ __forceinline__ float grad(float l, int h, float dz) const {
    return ex2((l - m) * kLog2e) * inv_s * fmaf(gz, dz, t[h]);
  }
};

// The bias of depth columns d0 + 8j + 2q and + 1, j < kBlocks, of one joint.
template <int kBlocks>
__device__ __forceinline__ void load_bias(float2 (&bv)[kBlocks], const float* __restrict__ bias_j,
                                          int d0, int q) {
#pragma unroll
  for (int j = 0; j < kBlocks; ++j)
    bv[j] = *reinterpret_cast<const float2*>(bias_j + d0 + 8 * j + 2 * q);
}

// dslab of a 64 x N logits accumulator (N = 8 kBlocks columns: depth d0 +
// 8j + 2q and + 1, biases bv) -> bf16 into the swizzled 64 x 64 buffer ds,
// at the accumulator's rows and depth columns; rows that are not pixels
// give 0.
// Where kColSums, the unrounded values are also added to colsum[2j + i].
template <int kBlocks, bool kColSums>
__device__ __forceinline__ void form_dslab(const float (&acc)[4 * kBlocks], unsigned char* ds,
                                           const float2 (&bv)[kBlocks], const RowCoef& c,
                                           const Rows& rows, int d0, int ra, int q,
                                           float (&colsum)[2 * kBlocks]) {
#pragma unroll
  for (int j = 0; j < kBlocks; ++j) {
    const int d = d0 + 8 * j + 2 * q;
    const float dz0 = float(d) - c.ez, dz1 = float(d + 1) - c.ez;  // once for both rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = 0.f, v1 = 0.f;
      if (rows.ok[h]) {
        v0 = c.grad(acc[4 * j + 2 * h] + bv[j].x, h, dz0);
        v1 = c.grad(acc[4 * j + 2 * h + 1] + bv[j].y, h, dz1);
      }
      if (kColSums) {
        colsum[2 * j] += v0;
        colsum[2 * j + 1] += v1;
      }
      rt::st_shared2(ds + rt::swz(ra + 8 * h, d / 8) + 4 * q, v0, v1);
    }
  }
}

// grid: persistent, kThreadsA threads: launch A over n_tiles (sample,
// 128-pixel) tiles, tiles_per_sample a sample. No producer warpgroup:
// thread 0 also feeds the slab ring and loads each tile's features, so
// that the block's 256 threads may hold 255 registers each (a third
// warpgroup caps them at 168, where ptxas serialised the wgmmas).
__global__ void __launch_bounds__(kThreadsA, 1)
dfeats_kernel(const __grid_constant__ CUtensorMap feat_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap dfeat_map, const float* __restrict__ bias,
              const float* __restrict__ g, const float* __restrict__ e,
              const float* __restrict__ stats, int pixels, int width, int joints,
              int tiles_per_sample, int n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring_p = align1024(smem_raw);
  unsigned char* feat = ring_p + kStages * rt::kStageBytes;
  unsigned char* ds = feat + rt::kActBytes;  // buffer k of warpgroup w: + (2w + k) * kDsBytes
  const uint32_t bars = smem_u32(ds + 2 * rt::kConsumers * kDsBytes);
  const uint32_t feat_full = bars + 16 * kStages, feat_empty = feat_full + 8;
  if (threadIdx.x == 0) {
    rt::mbar_init(feat_full, 1);
    rt::mbar_init(feat_empty, rt::kConsumers);
    rt::ring_init<kStages>(bars);
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ra = 16 * warp + lane / 4, q = lane % 4;
  const bool issuer = threadIdx.x % 128 == 0;
  const bool feeder = threadIdx.x == 0;
  const int my_tiles = (n_tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  rt::Ring<kStages> ring{smem_u32(ring_p), bars, 0};
  SlabFeed<kStages> slabs{{smem_u32(ring_p), bars, 0}, &w_map, joints, my_tiles * joints};
  // warp 0 waits while its thread 0 feeds the ring up to the chunk it takes
  auto acquire = [&]() {
    if (feeder) slabs.feed(ring.next);
    __syncwarp();
    return ring.acquire();
  };
  unsigned char* fa = feat + wg * rt::kWgActBytes;
  const uint32_t fa_s = smem_u32(fa);
  unsigned char* dsw = ds + 2 * wg * kDsBytes;  // this warpgroup's two dslab buffers
  float df[128], al[32], unused[16];  // unused: launch A sums no columns
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = tile / tiles_per_sample;
    const int p0 = (tile % tiles_per_sample) * kTilePixels;
    const int r0 = p0 + wg * rt::kWgRows;
    const Rows rows(r0, ra, pixels, width);
    if (feeder) {  // both warpgroups' stores have read the last tile's features
      rt::mbar_wait(feat_empty, (it & 1) ^ 1);
      load_feature_tile(smem_u32(feat), &feat_map, feat_full, p0, b);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 128; ++i) df[i] = 0.f;
    rt::mbar_wait(feat_full, it & 1);

    // joint 0's logits and dslab; then per joint j: joint j + 1's logits
    // and joint j's dfeats product in flight together, joint j + 1's
    // dslab formed while the tensor cores finish j's product
    float2 bv[8];
    load_bias(bv, bias, 0, q);
    CoefIn cin = CoefIn::load(g, e, stats, b * joints);
    uint32_t cur_s = acquire();
    issue_logits(al, fa_s, cur_s);
    rt::wgmma_wait<0>();
    rt::fence_acc(al);
    form_dslab<8, false>(al, dsw, bv, RowCoef(cin, rows), rows, 0, ra, q, unused);
    rt::fence_proxy_async();
    rt::wg_sync(wg);
#pragma unroll 1
    for (int j = 0; j < joints; ++j) {
      uint32_t nxt_s = 0;
      if (j + 1 < joints) {  // joint j + 1's bias and coefficients load under the products
        load_bias(bv, bias + (j + 1) * kDepth, 0, q);
        cin = CoefIn::load(g, e, stats, b * joints + j + 1);
        nxt_s = acquire();
        issue_logits(al, fa_s, nxt_s);
      }
      rt::issue_wide64(df, smem_u32(dsw + (j % 2) * kDsBytes), cur_s, true);
      if (j + 1 < joints) {
        rt::wgmma_wait<1>();  // joint j + 1's logits and joint j - 1's product are done
        if (j > 0) ring.release(ring.next - 3);
        rt::fence_acc(al);
        form_dslab<8, false>(al, dsw + ((j + 1) % 2) * kDsBytes, bv, RowCoef(cin, rows), rows,
                             0, ra, q, unused);
        rt::fence_proxy_async();
        rt::wg_sync(wg);
      }
      cur_s = nxt_s;
    }
    rt::wgmma_wait<0>();
    if (joints > 1) ring.release(ring.next - 2);
    ring.release(ring.next - 1);
    rt::fence_acc(df);

    // dfeats over this warpgroup's rows of the feature tile (its last
    // reader, joint J - 1's logits, has completed), then TMA stores; the
    // next tile's features load once both warpgroups' stores have read it
    rt::stage_acc<false>(df, fa, nullptr, ra, q);
    rt::fence_proxy_async();
    rt::wg_sync(wg);
    if (issuer) {
      if (r0 < pixels)
        for (int kb = 0; kb < kFeat / rt::kBox; ++kb)
          rt::tma_store3(&dfeat_map, fa_s + kb * rt::kKBlockBytes, kb * rt::kBox, r0, b);
      rt::tma_store_commit();
      rt::tma_store_wait_read();
      rt::mbar_arrive(feat_empty);
    }
  }
  if (issuer) rt::tma_store_wait();
}

// grid (J, groups), rt::kThreads threads: launch B. Group `grp` takes
// chunks [grp * total / groups, (grp + 1) * total / groups) of the batch's
// 64-pixel chunks, chunk t being sample t / chunks_per_sample, pixels from
// (t % chunks_per_sample) * 64. part_w: (groups, J * kDepth, kFeat);
// part_b: (groups, J * kDepth).
__global__ void __launch_bounds__(rt::kThreads, 1)
dweight_kernel(const __grid_constant__ CUtensorMap feat_map,
               const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
               const float* __restrict__ g, const float* __restrict__ e,
               const float* __restrict__ stats, float* __restrict__ part_w,
               float* __restrict__ part_b, int pixels, int width, int joints,
               int chunks_per_sample, int total) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* wsm = align1024(smem_raw);
  unsigned char* ring_p = wsm + rt::kStageBytes;
  unsigned char* ds = ring_p + kStages * rt::kStageBytes;  // kDsBufs buffers
  float* red = reinterpret_cast<float*>(ds + kDsBufs * kDsBytes);  // (2, 4 warps, 32)
  const uint32_t bars = smem_u32(red + rt::kConsumers * 4 * kHalfDepth);
  const uint32_t w_full = bars + 16 * kStages;
  const int j = blockIdx.x;
  const int grp = blockIdx.y;
  const int t0 = int(static_cast<long long>(grp) * total / gridDim.y);
  const int n = int(static_cast<long long>(grp + 1) * total / gridDim.y) - t0;
  if (threadIdx.x == 0) {
    rt::mbar_init(w_full, 1);
    rt::ring_init<kStages>(bars);
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  rt::Ring<kStages> ring{smem_u32(ring_p), bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      rt::mbar_expect_tx(w_full, rt::kStageBytes);
      for (int kb = 0; kb < kFeat / rt::kBox; ++kb)
        rt::tma_load(smem_u32(wsm) + kb * rt::kKBlockBytes, &w_map, w_full, kb * rt::kBox,
                     j * kDepth);
      for (int i = 0; i < n; ++i) {
        const int t = t0 + i;
        uint32_t bar;
        const uint32_t dst = ring.claim(&bar);
        for (int kb = 0; kb < kFeat / rt::kBox; ++kb)
          rt::tma_load3(dst + kb * rt::kKBlockBytes, &feat_map, bar, kb * rt::kBox,
                        (t % chunks_per_sample) * kChunkPixels, t / chunks_per_sample);
      }
    }
  } else {
    rt::regs_inc<rt::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int ra = 16 * warp + lane / 4, q = lane % 4;
    float2 bv[4];  // this warpgroup's depth columns of b_j
    load_bias(bv, bias + j * kDepth, wg * kHalfDepth, q);
    CoefIn cin = CoefIn::load(g, e, stats, (t0 / chunks_per_sample) * joints + j);
    int cin_sample = t0 / chunks_per_sample;
    // this warpgroup's rows of the slab (depth 32 wg ...) as the logits' B,
    // and its columns of a chunk (channels 128 wg ...) as dW's B
    const uint32_t w_half = smem_u32(wsm) + wg * kHalfDepth * 128;
    const uint32_t b_off = wg * (kHalfFeat / rt::kBox) * rt::kKBlockBytes;
    float dw[64], al[16], colsum[8] = {};
#pragma unroll
    for (int i = 0; i < 64; ++i) dw[i] = 0.f;

    // the logits' depth columns of this warpgroup for a chunk
    const uint64_t dwh = rt::desc_a(w_half);
    auto issue = [&](uint32_t chunk) {
#pragma unroll
      for (int i = 0; i < 16; ++i) al[i] = 0.f;  // overwritten: free until here
      const uint64_t dc = rt::desc_a(chunk);
      rt::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kFeat / 16; ++k) {
        const uint32_t off = (k / 4) * rt::kKBlockBytes + (k % 4) * 32;
        rt::wgmma_m64n32<0, 0>(al, rt::desc_off(dc, off), rt::desc_off(dwh, off), k);
      }
      rt::wgmma_commit();
    };
    // chunk i's dslab, this warpgroup's half, into buffer i % kDsBufs
    auto form = [&](int i) {
      const int t = t0 + i;
      if (t / chunks_per_sample != cin_sample) {  // a new sample: once in 64 chunks at 64 x 64
        cin_sample = t / chunks_per_sample;
        cin = CoefIn::load(g, e, stats, cin_sample * joints + j);
      }
      const Rows rows((t % chunks_per_sample) * kChunkPixels, ra, pixels, width);
      form_dslab<4, true>(al, ds + (i % kDsBufs) * kDsBytes, bv, RowCoef(cin, rows), rows,
                          wg * kHalfDepth, ra, q, colsum);
    };

    // chunk 0's logits and dslab; then per chunk i: chunk i + 1's logits and
    // chunk i's dW product in flight together, chunk i + 1's dslab formed
    // while the tensor cores finish i's product; one barrier of both
    // warpgroups a chunk
    rt::mbar_wait(w_full, 0);
    uint32_t cur_s = ring.acquire();
    issue(cur_s);
    rt::wgmma_wait<0>();
    rt::fence_acc(al);
    form(0);
    rt::fence_proxy_async();
    rt::consumers_sync();  // both halves of chunk 0's dslab are in
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      uint32_t nxt_s = 0;
      if (i + 1 < n) {
        nxt_s = ring.acquire();
        issue(nxt_s);
      }
      // dW_j[:, this warpgroup's channels] += dslab^T (A, M-major: transpose
      // flag) @ the chunk's channels (B, N-major: transpose flag)
      const uint64_t da = rt::smem_desc(smem_u32(ds + (i % kDsBufs) * kDsBytes),
                                        rt::kBoxBytes, 1024);
      const uint64_t db = rt::desc_b(cur_s + b_off);
      rt::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunkPixels / 16; ++k)
        rt::wgmma_m64n128<1, 1>(dw, rt::desc_off(da, k * 2048), rt::desc_off(db, k * 2048), 1);
      rt::wgmma_commit();
      if (i + 1 < n) {
        // chunk i + 1's logits and chunk i - 1's product are done; buffer
        // (i + 1) % 3 was last read by chunk i - 2's products, which both
        // warpgroups finished before the last barrier
        rt::wgmma_wait<1>();
        if (i > 0) ring.release(i - 1);
        rt::fence_acc(al);
        form(i + 1);
        rt::fence_proxy_async();
        rt::consumers_sync();
      }
      cur_s = nxt_s;
    }
    rt::wgmma_wait<0>();
    if (n > 1) ring.release(n - 2);
    ring.release(n - 1);
    rt::fence_acc(dw);

    // the partials: dW_j's rows (depth) ra, ra + 8, this warpgroup's
    // channels; db's column sums over the lanes of a column, then over the
    // four warps in order
    float* pw = part_w + (size_t(grp) * joints + j) * kDepth * kFeat + wg * kHalfFeat;
#pragma unroll
    for (int c = 0; c < kHalfFeat / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(pw + (ra + 8 * h) * kFeat + 8 * c + 2 * q) =
            make_float2(dw[4 * c + 2 * h], dw[4 * c + 2 * h + 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = colsum[i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[(wg * 4 + warp) * kHalfDepth + 8 * (i / 2) + 2 * q + i % 2] = v;
    }
    rt::consumers_sync();
    if (threadIdx.x < kDepth) {
      const int w = threadIdx.x / kHalfDepth, d = threadIdx.x % kHalfDepth;
      float s = 0.f;
      for (int k = 0; k < 4; ++k) s += red[(w * 4 + k) * kHalfDepth + d];
      part_b[(size_t(grp) * joints + j) * kDepth + threadIdx.x] = s;
    }
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
// the grid's limit or groups outside [1, the batch's 64-pixel chunks]
// returns cudaErrorInvalidValue. Three launches in a row on the calling
// thread's current device; the first error ends the sequence and is
// returned.
extern "C" cudaError_t conv_decode_bwd_launch(const void* feats, const void* weight,
                                              const void* bias, const void* g, const void* e,
                                              const void* stats, void* dfeats, void* dweight,
                                              void* dbias, void* partials, int groups, int batch,
                                              int height, int width, int channels, int joints,
                                              int depth, int tile_pixels, void* stream) {
  const int pixels = height * width;
  const int tiles_per_sample = (pixels + kTilePixels - 1) / kTilePixels;
  const int chunks_per_sample = (pixels + kChunkPixels - 1) / kChunkPixels;
  if (channels != kFeat || depth != kDepth || tile_pixels != kTilePixels || batch < 1 ||
      batch > 65535 || height < 1 || width < 1 || joints < 1 || joints > 65535 || groups < 1 ||
      static_cast<long long>(batch) * chunks_per_sample > (1 << 30) ||
      groups > batch * chunks_per_sample || groups > 65535)
    return cudaErrorInvalidValue;
  const auto* f = static_cast<const bf16*>(feats);
  CUtensorMap m_feat, m_dfeat, m_w;
  cudaError_t err = pixel_map(&m_feat, f, batch, pixels);
  if (err == cudaSuccess)
    err = pixel_map(&m_dfeat, static_cast<const bf16*>(dfeats), batch, pixels);
  if (err == cudaSuccess)
    err = tile_map(&m_w, static_cast<const bf16*>(weight), joints * kDepth, kFeat, kDepth);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dfeats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemA));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dweight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemB));
  const int n_tiles = batch * tiles_per_sample;
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(n_tiles, &grid);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bs = static_cast<const float*>(bias);
  const auto* gp = static_cast<const float*>(g);
  const auto* ep = static_cast<const float*>(e);
  const auto* st = static_cast<const float*>(stats);
  dfeats_kernel<<<grid, kThreadsA, kSmemA, s>>>(m_feat, m_w, m_dfeat, bs, gp, ep, st, pixels,
                                                   width, joints, tiles_per_sample, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_w = joints * kDepth * kFeat;
  const int n_b = joints * kDepth;
  auto* part_w = static_cast<float*>(partials);
  float* part_b = part_w + size_t(groups) * n_w;
  dweight_kernel<<<dim3(joints, groups), rt::kThreads, kSmemB, s>>>(
      m_feat, m_w, bs, gp, ep, st, part_w, part_b, pixels, width, joints, chunks_per_sample,
      batch * chunks_per_sample);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_kernel<<<(n_w + n_b + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, s>>>(
      part_w, part_b, groups, n_w, n_b, static_cast<bf16*>(dweight), static_cast<float*>(dbias));
  return cudaGetLastError();
}
