// The backward of one temporal-lifter sub-block, for training, on Hopper
// (sm_90a). The forward (stblock.cu, kSave) saved x (the input), x1 (the
// residual stream after the projection) and att (the attention output);
// from those and dout this computes dx and the 12 weight and bias
// gradients, as pose3d_tpu/ops/pallas_stblock_train.py::_subblock_bwd does:
//   recompute y = bf16(LN_1(x)), qkv = bf16(y @ W_qkv + b_qkv),
//             y2 = bf16(LN_2(x1)), h = y2 @ W1 + b1 (f32), hg = bf16(gelu(bf16(h)));
//   dh = bf16((dout @ W2^T) * gelu'(h));  dy2 = dh @ W1^T;
//   dx1 = dout + LN_2 backward(dy2);  datt = bf16(dx1) @ Wp^T;
//   dqkv = attention backward (f32);  dy = bf16(dqkv) @ W_qkv^T;
//   dx = bf16(dx1 + LN_1 backward(dy));
//   dW2 = hg^T dout, dW1 = y2^T dh, dWp = att^T bf16(dx1), dWqkv = y^T bf16(dqkv),
//   and the bias / LayerNorm gradients as column sums over the rows.
// The attention backward is per (sequence, head), per-frame (17 joints) for
// the spatial half, per joint over the clip's T frames for the temporal
// slab, and per joint-major sequence of L contiguous rows; everything else
// ignores which rows share a sequence.
//
// Replaces the backward TPU kernels of pallas_stblock_train.py:
// _spatial_bwd_kernel :359 (via _spatial_bwd_impl :483),
// _temporal_bwd_kernel :388 (via _temporal_bwd_impl :527: one joint-major
// sequence per grid cell) and _temporal_slab_bwd_kernel :424 (via
// _temporal_slab_bwd_impl :570). The TPU kernels do all of it per grid
// cell and accumulate the weight gradients across cells, which is exact
// there because the TPU's grid runs in order. Here blocks run in no order,
// and an SM holds neither the weights nor a cell's backward live set, so
// the backward is a sequence of 21 launches through a global workspace
// that the wrapper allocates.
//
// What bounds it on this card. ~4 x 1.57 MFLOP per row of matrix products
// (recomputed qkv and fc1, then six products of the forward's size), 0.313
// ms at 16 clips x 243 frames on the tensor cores; its bytes, each operand
// once (174 MB), take 0.052 ms. What a launch sequence really costs is the
// workspace traffic between launches: the first design moved 3.57 GB a
// call at that shape, of which ~1.4 GB were four f32 intermediates (h,
// dqkv and the two dy) that each came back only for an epilogue or a
// column sum. This sequence keeps those in registers or shared memory and
// moves 2.25 GB (slab) or 2.27 GB (spatial, one db_qkv partial per frame),
// 0.67 ms at 3.35 TB/s, in 21 launches. Its products run on wgmma fed by
// TMA (rowtile_sm90.cuh's primitives: one thread streams 128-byte-swizzled
// boxes through an mbarrier ring to two consumer warpgroups of 64 rows
// each, one CTA an SM, persistent grids):
// - the recomputed qkv: subblock_sm90.cuh's qkv_kernel, the forward's own
//   launch (LN_1 + y W_qkv + b_qkv), so the recomputed qkv is the
//   forward's bitwise; LayerNorm row passes (one warp a row) store y and
//   y2, which the weight gradients read;
// - gemm_kernel: 128 x 256 output tiles, K in 64-wide chunks of 48 KB
//   stages (both warpgroups' 64 x 64 A boxes and a 64 x 256 or 256 x 64 B
//   chunk), four stages, f32 out from the accumulators. datt = bf16(dx1)
//   Wp^T reads Wp K-major as it is stored. The weight gradients contract
//   over the rows and read both row operands as stored: A = X^T M-major and
//   B = G N-major, both taken with the transpose flag, so no transposed
//   copy exists. A weight has only 2-8 such tiles, so the rows (1033
//   chunks at 66,096 rows) are cut into a fixed number of K slices, tiles
//   x slices <= kWgradItems work items, whose f32 partials a second pass
//   sums in a fixed order;
// - mlp_bwd_kernel: per 128-row tile, y2 and dout (64 KB each) by TMA into
//   shared memory, then per 64 hidden columns a W1 chunk (256 x 64,
//   N-major) and a W2 chunk (64 x 256 rows, read K-major as W2^T) through
//   a 3-stage ring that the consumers' first threads feed (no producer
//   warpgroup): h = y2 W1 + b1 and dout W2^T (m64n64, 16 k-steps each),
//   then the epilogue: hg = bf16(gelu(bf16(h))) and dh = bf16(dout W2^T
//   gelu'(h)), both stored 16 bytes a lane, and each warp's column sums of
//   the bf16 dh (db1's partials; h never reaches device memory). Its two
//   polynomials an element (~60 instructions), not its products, set its
//   pace. Four consumer warpgroups in two pairs take alternate chunks, one
//   accumulator pair each (512 threads at 128 registers), so four warps a
//   scheduler run the epilogue where two warpgroups holding two chunks'
//   pairs each (255 registers) issued it at ~0.4 instructions a clock a
//   scheduler; the section's note says what else that took;
// - ln_gemm_kernel: dy2 = dh W1^T (K = 1024) and dy = bf16(dqkv) W_qkv^T
//   (K = 768) per 128-row tile of all 256 columns (m64n256, W read K-major
//   as stored, a 3-stage ring of 48 KB), the f32 tile staged from the two
//   warpgroups' accumulators in shared memory (each warp its own 16 rows,
//   8 at a time, XOR-swizzled), the LayerNorm backward run on it one warp a
//   row (LN_2's: dx1 f32 and bf16; LN_1's: dx), the rows' operands
//   loaded four rows ahead, and the tile's column sums (dbp, dg2, db2,
//   db2f; dg1, db1) added over its 8 warps in order;
// - the attention backward, one CTA per (sequence, head), its rounding
//   points unchanged (e now on the SFU's ex2, as the forward's attention
//   kernel takes it, where expf took ten instructions): at L > 64 (the
//   slab, the joint-major sequences) attention_bwd_wg_kernel, two
//   warpgroups on wgmma (64-query tiles
//   against 64-key blocks, then 64-key tiles against 64-query blocks; ds
//   and e from the accumulators into register A fragments), ~101 KB of
//   shared memory at L = 256, so two CTAs share an SM where the mma.sync
//   kernel (127 KB) sat alone; at L <= 64 (the spatial half's 17 joints)
//   attention_bwd_kernel on mma.sync in 16-row tiles, its head tiles now
//   64 bytes a row with an XOR swizzle of the 16-byte chunks (ldmatrix
//   without bank conflicts, no padding);
// - the column partials of the bias and LayerNorm gradients (db1's per
//   warp of a row tile, the LayerNorms' per row tile, db_qkv's per
//   sequence) are summed in order, as are the split-K partials. No
//   atomics: two calls on the same inputs give bitwise equal gradients.
// The first design moved the workspace in 26 launches; the second (21
// launches, this sequence's traffic) ran every product on mma.sync through
// ldmatrix from cp.async rings (128 x 128 GEMM tiles of 4 warps) and the
// attention backward alone on its SM: 2.99 ms (slab) and 2.25 ms (spatial)
// on an H100 80GB HBM3 at 700 W; PERF.md has the new times and the
// per-launch split.
// Rounding points are the JAX backward's: gelu' of the f32 h, dh rounded
// to bf16 before db1 sums it, dx1 kept f32 (rounded only for dWp and datt),
// dqkv f32 for db_qkv (rounded for dWqkv and dy), and in the attention
// backward e = exp(min(s, 80)) with no row max (on the SFU's ex2, as the
// forward's attention kernel), r = 1/sum(e), dv = bf16(e)^T
// bf16(r do), ds = bf16(t - c e) with t = da e and c = r sum(t), dq = (ds
// k)(r scale), dk = ds^T bf16(bf16(r) q) scale.
//
// The launcher encodes its TMA maps on the host per call, runs on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (or the first error of a map or a launch).

#include <algorithm>

#include "attention_sm90.cuh"
#include "subblock_sm90.cuh"

namespace {

using namespace pose3d;
namespace rt = pose3d::rowtile;
namespace sb = pose3d::subblock;

constexpr int kJoints = 17;
constexpr int kHeads = 8;
constexpr int kDimHead = kDim / kHeads;

// Layout of one sub-block in the flat weight operand, and of the flat f32
// gradient: ops/stblock.py::_LAYOUT, as in stblock.cu.
constexpr int kOffLn1G = 0;
constexpr int kOffLn1B = kOffLn1G + kDim;
constexpr int kOffWQkv = kOffLn1B + kDim;
constexpr int kOffBQkv = kOffWQkv + kDim * kQkv;
constexpr int kOffWProj = kOffBQkv + kQkv;
constexpr int kOffBProj = kOffWProj + kDim * kDim;
constexpr int kOffLn2G = kOffBProj + kDim;
constexpr int kOffLn2B = kOffLn2G + kDim;
constexpr int kOffW1 = kOffLn2B + kDim;
constexpr int kOffB1 = kOffW1 + kDim * kMlp;
constexpr int kOffW2 = kOffB1 + kMlp;
constexpr int kOffB2 = kOffW2 + kMlp * kDim;
constexpr int kBlockElems = kOffB2 + kDim;

// The sub-block's traits for subblock_sm90.cuh (stblock.cu's Layout): one
// LN before qkv, biases on qkv and the projection.
struct Traits {
  static constexpr bool kDoubleLn = false, kQkvBias = true, kProjBias = true;
  static constexpr int kLn1G = kOffLn1G, kLn1B = kOffLn1B, kLnbG = 0, kLnbB = 0;
  static constexpr int kWQkv = kOffWQkv, kBQkv = kOffBQkv, kWProj = kOffWProj,
                       kBProj = kOffBProj;
  static constexpr int kLn2G = kOffLn2G, kLn2B = kOffLn2B, kW1 = kOffW1, kB1 = kOffB1,
                       kW2 = kOffW2, kB2 = kOffB2, kElems = kBlockElems;
};

constexpr float kInvSqrt2 = 0.7071067690849304f;

// For N elements x: hg = gelu(bf16(x)), subblock_sm90.cuh's gelu (erf_poly
// at the FMA form of x / sqrt2), and gp = gelu'(x), the exact derivative of
// gelu_poly (pallas_stblock_train._gelu_grad): 0.5 (1 + erf(u)) + 0.5 x
// erf'(u) / sqrt2 at u = x / sqrt2, erf(u) = uc P(uc^2) with uc the
// clamped u, erf'(u) = P(s) + 2 s P'(s), 0 where |u| >= 3 (_erf_grad's
// strict <). Inside the clamp uc = u, so one P(s) serves erf and erf'. Each
// Horner step is taken for all N elements in turn: 3N independent chains,
// where element by element the scheduler kept 2 in flight, and this is the
// MLP backward's ALU work.
template <int N>
__device__ __forceinline__ void gelu_and_grad(const float (&x)[N], float (&hg)[N],
                                              float (&gp)[N]) {
  // erf_poly's P(s) and the P'(s) of its derivative (pallas_lifter._ERF_C,
  // _ERF_D), highest power first
  constexpr float kP[9] = {4.7283642828e-08f,  -2.1986137083e-06f, 4.5123548106e-05f,
                           -5.4564336601e-04f, 4.4038703607e-03f,  -2.5570011680e-02f,
                           1.1177045202e-01f,  -3.7577772172e-01f, 1.1283599228e+00f};
  constexpr float kD[8] = {3.7826913512617466e-07f, -1.5390296539408155e-05f,
                           2.7074129320681095e-04f, -2.72821681573987e-03f,
                           1.7615482211112976e-02f, -7.67100378870964e-02f,
                           2.2354090213775635e-01f, -3.757777214050293e-01f};
  float xb[N], tc[N], st[N], pt[N], u[N], uc[N], su[N], pu[N], du[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    xb[i] = round_bf16(x[i]);
    const float qv = xb[i] * kInvSqrt2;
    tc[i] = fminf(fmaxf(fmaf(fmaf(-qv, kSqrt2, xb[i]), kInvSqrt2, qv), -3.f), 3.f);
    st[i] = tc[i] * tc[i];
    u[i] = x[i] * kInvSqrt2;
    uc[i] = fminf(fmaxf(u[i], -3.f), 3.f);
    su[i] = uc[i] * uc[i];
    pt[i] = pu[i] = kP[0];
    du[i] = kD[0];
  }
#pragma unroll
  for (int k = 1; k < 9; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      pt[i] = pt[i] * st[i] + kP[k];
      pu[i] = pu[i] * su[i] + kP[k];
      if (k < 8) du[i] = du[i] * su[i] + kD[k];
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hg[i] = xb[i] * 0.5f * (1.f + tc[i] * pt[i]);
    const float derf = fabsf(u[i]) < 3.f ? pu[i] + 2.f * su[i] * du[i] : 0.f;
    gp[i] = 0.5f * (1.f + uc[i] * pu[i]) + 0.5f * x[i] * kInvSqrt2 * derf;
  }
}

// The regions of a persistent kernel's shared memory: 1 KB aligned (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).
__device__ __forceinline__ unsigned char* align1k(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ------------------------------------------------------------------ GEMM

constexpr int kTileN = 256;                               // output columns of a tile
constexpr int kABytes = rt::kConsumers * rt::kBoxBytes;   // both warpgroups' A boxes: 16 KB
constexpr int kGemmStageBytes = kABytes + rt::kStageBytes;  // + the B chunk: 48 KB
constexpr int kGemmStages = 4;
constexpr size_t kGemmSmem = 1024 + size_t(kGemmStages) * kGemmStageBytes + 16 * kGemmStages;
static_assert(kGemmSmem <= size_t(kSmemLimit), "the GEMM's ring");
constexpr int kWgradItems = 132;  // split-K: work items of a weight gradient

// C (M x N, f32) = A (M x K) @ B (K x N) over K chunks of 64, in 128 x 256
// tiles; work item t of a persistent CTA's walk is K slice t / tiles of
// tile t % tiles (row tile (t % tiles) / n_tiles), slice z covering chunks
// [z per, min((z + 1) per, chunks)) and writing c + z c_slice. kTransA: A
// is stored K x M (a map of boxes 64 K-rows x 64 M-columns), taken
// M-major; else M x K (boxes 64 rows x 64 K-columns), K-major. kTransB: B
// is stored K x N (boxes 64 x 64), taken N-major; else N x K (one box of
// 256 N-rows x 64 K-columns), K-major. Rows past M (and K past the maps'
// end) arrive as zeros; rows past M are not stored.
struct GemmArgs {
  int n_tiles, tiles, slices, chunks, per;
  int M;
  float* c;
  int ldc;
  size_t c_slice;
};

template <bool kTransA, bool kTransB>
__global__ void __launch_bounds__(rt::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring_p = align1k(smem_raw);
  const uint32_t bars = smem_u32(ring_p + kGemmStages * kGemmStageBytes);
  if (threadIdx.x == 0) rt::ring_init<kGemmStages>(bars);
  __syncthreads();
  const int items = p.tiles * p.slices;
  const int wg = threadIdx.x / 128;
  rt::Ring<kGemmStages, kGemmStageBytes> ring{smem_u32(ring_p), bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int z = t / p.tiles, tile = t % p.tiles;
        const int m0 = tile / p.n_tiles * rt::kTileRows, n0 = tile % p.n_tiles * kTileN;
        const int c1 = min((z + 1) * p.per, p.chunks);
        for (int kc = z * p.per; kc < c1; ++kc) {
          uint32_t bar;
          const uint32_t dst = ring.claim(&bar);
          const int k0 = kc * rt::kBox;
#pragma unroll
          for (int w = 0; w < rt::kConsumers; ++w) {
            if (kTransA) rt::tma_load(dst + w * rt::kBoxBytes, &a_map, bar, m0 + w * rt::kWgRows, k0);
            else rt::tma_load(dst + w * rt::kBoxBytes, &a_map, bar, k0, m0 + w * rt::kWgRows);
          }
          if (kTransB) {
#pragma unroll
            for (int b = 0; b < kTileN / rt::kBox; ++b)
              rt::tma_load(dst + kABytes + b * rt::kBoxBytes, &b_map, bar, n0 + b * rt::kBox, k0);
          } else {
            rt::tma_load(dst + kABytes, &b_map, bar, k0, n0);
          }
        }
      }
    }
  } else {
    rt::regs_inc<rt::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int ra = 16 * warp + lane / 4, q = lane % 4;
    float acc[128];
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int z = t / p.tiles, tile = t % p.tiles;
      const int m0 = tile / p.n_tiles * rt::kTileRows, n0 = tile % p.n_tiles * kTileN;
      const int n = min((z + 1) * p.per, p.chunks) - z * p.per;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const uint32_t s = ring.acquire();
        const uint32_t a = s + wg * rt::kBoxBytes, b = s + kABytes;
        rt::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // 16 K-rows of an M- or N-major box are 2 KB on; 16 K-columns of
          // a K-major one, 32 bytes
          const uint64_t da = kTransA ? rt::desc_b(a + j * 2048) : rt::desc_a(a + j * 32);
          const uint64_t db = kTransB ? rt::desc_b(b + j * 2048) : rt::desc_a(b + j * 32);
          rt::wgmma_m64n256<kTransA, kTransB>(acc, da, db, i | j);
        }
        rt::wgmma_commit();
        if (i > 0) {
          rt::wgmma_wait<1>();
          ring.release(ring.next - 2);
        }
      }
      rt::wgmma_wait<0>();
      ring.release(ring.next - 1);
      rt::fence_acc(acc);
      // acc[4j + 2h + i]: row ra + 8h, column 8j + 2q + i of the warpgroup's 64 x 256
      float* c = p.c + size_t(z) * p.c_slice;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wg * rt::kWgRows + ra + 8 * h;
        if (r >= p.M) continue;
        float* row = c + size_t(r) * p.ldc + n0 + 2 * q;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <bool kTransA, bool kTransB>
cudaError_t gemm(const CUtensorMap& a, const CUtensorMap& b, const GemmArgs& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kTransA, kTransB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGemmSmem));
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(p.tiles * p.slices, &grid);
  if (err != cudaSuccess) return err;
  gemm_kernel<kTransA, kTransB><<<grid, rt::kThreads, kGemmSmem, s>>>(a, b, p);
  return cudaGetLastError();
}

// --------------------------------------------------------- row passes

constexpr int kRowWarps = 8;

// dst = bf16(LN(src) * g + b), one warp per row of 256
__global__ void __launch_bounds__(kRowWarps * 32)
ln_rows_kernel(const bf16* __restrict__ src, const bf16* __restrict__ g,
               const bf16* __restrict__ b, bf16* __restrict__ dst, int rows) {
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r < rows) layer_norm_row(src + size_t(r) * kDim, dst + size_t(r) * kDim, g, b,
                               threadIdx.x & 31);
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8f(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The LayerNorm backward of one row, one warp, 8 columns a lane, from the
// lane's src values v (the LayerNorm's input, row r; xhat and r recomputed
// from it), its dy values at dy8 and its resid values res: dya = dy g,
// res += r (dya - mean(dya) - xhat mean(dya xhat)). kLn2: resid is dout,
// res goes out as f32 (dx1) and bf16; else resid is dx1 and res goes out
// as bf16 (dx). The row's terms of the column sums are added to acc: kLn2
// dx1, dy xhat, dy (dbp, dg2, db2, adjacent in the weights' layout) and
// dout (db2f); else dy xhat, dy (dg1, db1).
template <bool kLn2>
__device__ __forceinline__ void ln_bwd_row(float (&v)[8], const float* dy8, const float (&gg)[8],
                                           float (&res)[8], float* __restrict__ out32,
                                           bf16* __restrict__ out16, size_t o,
                                           float (&acc)[kLn2 ? 4 : 2][8]) {
  constexpr int kSums = kLn2 ? 4 : 2;
  constexpr int kG = kLn2 ? 1 : 0;  // where dy xhat and dy go
  float d[8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += v[j];
  const float mu = warp_sum(sum) * (1.f / kDim);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = v[j] - mu;
    sq += t * t;
  }
  const float rstd = rsqrtf(warp_sum(sq) * (1.f / kDim) + kLnEps);
  load8f(dy8, d);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = (v[j] - mu) * rstd;  // xhat
    acc[kG][j] += d[j] * v[j];
    acc[kG + 1][j] += d[j];
    d[j] *= gg[j];  // dya
    s1 += d[j];
    s2 += d[j] * v[j];
  }
  const float m1 = warp_sum(s1) * (1.f / kDim);
  const float m2 = warp_sum(s2) * (1.f / kDim);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (kLn2) acc[kSums - 1][j] += res[j];
    res[j] += rstd * (d[j] - m1 - v[j] * m2);
    if (kLn2) acc[0][j] += res[j];
  }
  if (kLn2) store8f(out32 + o, res);
  store8(out16 + o, res);
}

// ------------------------------------------- the MLP recompute and dh

// A persistent CTA an SM walks 128-row tiles with four consumer warpgroups
// in two pairs: pair p (warpgroups 2p and 2p + 1, rows 0-63 and 64-127 of
// the tile) takes hidden chunks p, p + 2, ..., 14 + p of 64 columns. A
// warpgroup holds one chunk's accumulator pair (2 x 32 f32 a thread), so
// four fit in the register file (512 threads, 128 registers a thread), and
// four warps a scheduler run the epilogue, the ALU's work (two polynomials
// an element), while the other pair's products run on the tensor cores.
// Per chunk c a warpgroup issues h = y2 W1[:, 64c, +64) (issue_h: a tall W1
// chunk, N-major) and g = dout (W2[64c, +64), :])^T (issue_g: a wide W2
// chunk, read K-major), one commit group each; once h is done it hands
// W1's stage back and forms hg = bf16(gelu(bf16(h + b1))), stores it and
// leaves gelu'(h + b1) in h's registers (mlp_gelu) while g's product runs;
// once g is done it hands W2's stage back, stores dh = bf16(g gelu') and
// each warp's column sums of it (mlp_dh: db1's partials, one a warp of a
// row tile at part[(tile x 8 + warp) x 1024 + column]; h never reaches
// device memory).
//
// y2 and dout (the A operands, 64 KB each) stay for the whole tile; each
// row half's arrive by TMA on a barrier that both pairs' warpgroups of
// those rows wait on. Pair 1's warpgroup loads the half's next rows once
// both have passed their last products of the tile (a barrier of two
// arrivals a row half), so the load runs under the last epilogues.
//
// The weights go through a 3-stage ring in the order the chunks are read:
// entry i (32 a tile: chunk c's W1 at 2c, its W2 at 2c + 1) in stage i % 3.
// Thread 0 loads entries 0-2; entry i + 3 is loaded by the first thread of
// the warpgroup of rows half i % 2 of the pair that read entry i, once both
// of that pair have handed its stage back (the stage's empty barrier counts
// two) and met at a named barrier of the pair's 256 threads. Without that
// barrier the loading thread spun on its partner's hand-back, the two
// warpgroups drifted apart and each waited on the other: 0.52 ms a call
// at 16 clips, against 0.37 with it (H100). As the pairs read alternate
// pairs of entries, one full barrier a stage could run two phases ahead of
// a pair waiting on it, and the parity wait would pass early: each stage
// has a full barrier for each pair, whose phases count that pair's entries
// alone, their parities kept by a warpgroup in three bits.
//
// The warpgroup index comes from a shuffle of lane 0's, warp-uniform as
// the compiler sees it; a k-step's operand descriptors are the chunk's
// plus a constant (rt::desc_off); db1's column sums are a reduce-scatter
// (mlp_dh). Each cut instructions that compete with the epilogue's for
// issue: 0.37 -> 0.35 -> 0.33 ms (H100). The stores of hg and dh then
// took a quarter of the call: a lane held two adjacent columns of each
// 8-column block, so a warp's 4-byte stores wrote 16 bytes of 8 rows each.
// The 4 lanes of a quad now trade their column pairs (quad_transpose) so
// that each stores a block's 8 columns, 16 bytes: 0.33 -> 0.29 ms. Four
// warpgroups that split each chunk's columns instead (m64n32, all four on
// every chunk in one ring order, the next chunk's products beside the
// epilogue) gave the same bits in 0.35 ms: twice the wgmma an element.
constexpr int kMlpStages = 3;
constexpr int kMlpChunks = kMlp / rt::kBox;      // 16
constexpr int kMlpPairs = 2;                     // pairs of consumer warpgroups
constexpr int kMlpTileEntries = 2 * kMlpChunks;  // ring entries a tile
// barriers: a full one a (pair, stage), an empty one a stage, and a full
// and a free one a row half
constexpr int kMlpBars = kMlpPairs * kMlpStages + kMlpStages + 2 * rt::kConsumers;
constexpr size_t kMlpSmem = 1024 + 2 * size_t(rt::kActBytes) +
                            size_t(kMlpStages) * rt::kStageBytes + 8 * kMlpBars;
static_assert(kMlpSmem <= size_t(kSmemLimit), "y2, dout and the weight ring");
constexpr int kMlpPartRows = rt::kConsumers * 4;  // db1 partials of a tile: one a warp of rows
constexpr int kMlpThreads = kMlpPairs * rt::kConsumers * 128;  // 512: 128 registers a thread

// acc = y2 (the warpgroup's rows at a) @ the tall W1 chunk at b, one commit
// group. The first k-step overwrites acc; zeroing it first tells the
// compiler so, which frees its registers from its last read to here. A
// k-step's descriptors are the chunk's plus an offset (rt::desc_off), ~4
// instructions a wgmma where each built its own took ~12.
__device__ __forceinline__ void issue_h(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t da = rt::desc_a(a), db = rt::desc_b(b);
  rt::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 16; ++j)
    rt::wgmma_m64n64(acc, rt::desc_off(da, (j / 4) * rt::kKBlockBytes + (j % 4) * 32),
                     rt::desc_off(db, j * 2048), j);
  rt::wgmma_commit();
}

// acc = dout (the warpgroup's rows at a) @ (the wide W2 chunk at b)^T, one
// commit group.
__device__ __forceinline__ void issue_g(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t da = rt::desc_a(a), db = rt::desc_a(b);
  rt::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t k = (j / 4) * rt::kKBlockBytes + (j % 4) * 32;
    rt::wgmma_m64n64<0, 0>(acc, rt::desc_off(da, k), rt::desc_off(db, k), j);
  }
  rt::wgmma_commit();
}

// The 4 x 4 transpose of 32-bit words across the lanes of a quad (q = lane
// % 4): lane q ends with word q of each lane k in w[k].
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t s = hi ? w[i] : w[2 + i];
    const uint32_t r = __shfl_xor_sync(0xffffffffu, s, 2);
    if (hi) w[i] = r;
    else w[2 + i] = r;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t s = odd ? w[2 * i] : w[2 * i + 1];
    const uint32_t r = __shfl_xor_sync(0xffffffffu, s, 1);
    if (odd) w[2 * i] = r;
    else w[2 * i + 1] = r;
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Words w[k] of 4 blocks' packed columns (lane k's) transposed across the
// quad and stored 16 bytes a lane: lane q the 8 columns of block q at p + 8q.
__device__ __forceinline__ void store_quad(bf16* p, uint32_t (&w)[4], int q, bool live) {
  quad_transpose(w, q);
  if (live) *reinterpret_cast<uint4*>(p + 8 * q) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Hidden columns [64c, 64c + 64) of the warpgroup's rows ra and ra + 8
// (h[4j + 2k + i]: row ra + 8k, column 8j + 2q + i), one 8-column block at
// a time: hg = bf16(gelu(bf16(h + b1))) stored, 4 blocks at a time by
// store_quad, gelu'(h + b1) left in h. b1 points at the chunk's column 2q,
// hg at its column 0 in row ra; live: whether rows ra and ra + 8 exist.
__device__ __forceinline__ void mlp_gelu(float (&h)[32], const bf16* __restrict__ b1,
                                         bf16* __restrict__ hg, const bool (&live)[2], int q) {
  uint32_t w[2][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bv = load2(b1 + 8 * j);
    float x[4], g[4], gp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = h[4 * j + e] + (e % 2 ? bv.y : bv.x);
    gelu_and_grad(x, g, gp);
#pragma unroll
    for (int k = 0; k < 2; ++k) w[k][j % 4] = pack2(g[2 * k], g[2 * k + 1]);
    if (j % 4 == 3)
#pragma unroll
      for (int k = 0; k < 2; ++k) store_quad(hg + 8 * k * kMlp + 32 * (j / 4), w[k], q, live[k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[4 * j + e] = gp[e];
  }
}

// A step of mlp_dh's reduce-scatter over the kN blocks a lane holds: it
// keeps the upper half where `up`, else the lower, sends the other half to
// lane ^ off and adds to each kept block what that lane sends of it.
template <int kN>
__device__ __forceinline__ void scatter_step(float (&cs)[8][2], bool up, int off) {
#pragma unroll
  for (int j = 0; j < kN / 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float keep = up ? cs[j + kN / 2][i] : cs[j][i];
      const float send = up ? cs[j][i] : cs[j + kN / 2][i];
      cs[j][i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
}

// The same columns' dh = bf16(g gelu') stored (dh as hg), and the warp's
// column sums of it over its 16 rows at part, the chunk's column 2q of the
// warp's partial. A column's sum is the shuffle tree over the lanes of its
// q (xor 4, 8, 16) of the lanes' two rows, taken as a reduce-scatter: each
// step sends half the columns still held and adds the partner's half, so
// lane l ends with block 4 (l / 4 % 2) + 2 (l / 8 % 2) + l / 16 and stores
// it: 14 shuffles where a tree per column took 48, the same sums in the
// same order.
__device__ __forceinline__ void mlp_dh(const float (&gp)[32], const float (&g)[32],
                                       bf16* __restrict__ dh, float* __restrict__ part, int lane,
                                       const bool (&live)[2]) {
  float cs[8][2];
  uint32_t w[2][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float d0 = round_bf16(g[4 * j + 2 * k] * gp[4 * j + 2 * k]);
      const float d1 = round_bf16(g[4 * j + 2 * k + 1] * gp[4 * j + 2 * k + 1]);
      cs[j][0] += live[k] ? d0 : 0.f;
      cs[j][1] += live[k] ? d1 : 0.f;
      w[k][j % 4] = pack2(d0, d1);
    }
    if (j % 4 == 3)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        store_quad(dh + 8 * k * kMlp + 32 * (j / 4), w[k], lane % 4, live[k]);
  }
  scatter_step<8>(cs, lane & 4, 4);
  scatter_step<4>(cs, lane & 8, 8);
  scatter_step<2>(cs, lane & 16, 16);
  const int jb = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) + (lane >> 4);
  *reinterpret_cast<float2*>(part + 8 * jb) = make_float2(cs[0][0], cs[0][1]);
}

__global__ void __launch_bounds__(kMlpThreads, 1)
mlp_bwd_kernel(const __grid_constant__ CUtensorMap y2_map,
               const __grid_constant__ CUtensorMap dout_map,
               const __grid_constant__ CUtensorMap w1_map,
               const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ b1,
               bf16* __restrict__ hg, bf16* __restrict__ dh, float* __restrict__ part,
               int n_rows) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  unsigned char* y2s = base;  // [row half][4 K blocks][64 rows][128 B]
  unsigned char* douts = base + rt::kActBytes;
  const uint32_t ring = smem_u32(base + 2 * rt::kActBytes);
  const uint32_t full_bars = ring + kMlpStages * rt::kStageBytes;  // (pair p, stage s): 3p + s
  const uint32_t empty_bars = full_bars + 8 * kMlpPairs * kMlpStages;
  const uint32_t row_bars = empty_bars + 8 * kMlpStages;  // the halves' full, then free ones
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMlpPairs * kMlpStages; ++i) rt::mbar_init(full_bars + 8 * i, 1);
    for (int s = 0; s < kMlpStages; ++s) rt::mbar_init(empty_bars + 8 * s, rt::kConsumers);
    for (int w = 0; w < rt::kConsumers; ++w) {
      rt::mbar_init(row_bars + 8 * w, 1);
      rt::mbar_init(row_bars + 8 * (rt::kConsumers + w), kMlpPairs);
    }
    rt::mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = (n_rows + rt::kTileRows - 1) / rt::kTileRows;
  // warp-uniform as the compiler sees it (a shuffle from lane 0), so the
  // operand descriptors and ring addresses that follow from it live in
  // uniform registers: as threadIdx.x / 128 each wgmma's descriptors went
  // through per-thread registers, ~15 instructions a wgmma
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int pair = wg / rt::kConsumers, half = wg % rt::kConsumers;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ra = 16 * warp + lane / 4, q = lane % 4;
  const bool issuer = threadIdx.x % 128 == 0;
  const uint32_t y2a = smem_u32(y2s + half * rt::kWgActBytes);
  const uint32_t douta = smem_u32(douts + half * rt::kWgActBytes);
  const uint32_t rows_full = row_bars + 8 * half;
  const uint32_t rows_free = row_bars + 8 * (rt::kConsumers + half);
  // entry i into its stage, on the full barrier of the pair that reads it,
  // once the stage's last entry has been handed back
  auto feed = [&](int i) {
    if (blockIdx.x + (i / kMlpTileEntries) * gridDim.x >= n_tiles) return;  // past the last tile
    const int s = i % kMlpStages, c = (i % kMlpTileEntries) / 2;
    rt::mbar_wait(empty_bars + 8 * s, ((i / kMlpStages) & 1) ^ 1);
    const uint32_t bar = full_bars + 8 * (c % kMlpPairs * kMlpStages + s);
    const uint32_t dst = ring + s * rt::kStageBytes;
    rt::mbar_expect_tx(bar, rt::kStageBytes);
    if (i % 2 == 0) {
      rt::tma_load(dst, &w1_map, bar, c * rt::kBox, 0);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        rt::tma_load(dst + b * rt::kBoxBytes, &w2_map, bar, b * rt::kBox, c * rt::kBox);
    }
  };
  uint32_t phases = 0;  // bit s: the parity of the pair's next entry in stage s
  auto acquire = [&](int i) {
    const int s = i % kMlpStages;
    rt::mbar_wait(full_bars + 8 * (pair * kMlpStages + s), (phases >> s) & 1);
    phases ^= 1u << s;
    return ring + s * rt::kStageBytes;
  };
  auto release = [&](int i) {
    if (issuer) rt::mbar_arrive(empty_bars + 8 * (i % kMlpStages));
  };
  // the pair's 256 threads (named barriers 1 and 2): both have handed a
  // stage back, so its refill waits for no one
  auto pair_sync = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + pair) : "memory"); };
  auto load_rows = [&](int tile) {
    const int row = tile * rt::kTileRows + half * rt::kWgRows;
    rt::mbar_expect_tx(rows_full, 2 * rt::kWgActBytes);
#pragma unroll
    for (int kb = 0; kb < kDim / rt::kBox; ++kb) {
      rt::tma_load(y2a + kb * rt::kKBlockBytes, &y2_map, rows_full, kb * rt::kBox, row);
      rt::tma_load(douta + kb * rt::kKBlockBytes, &dout_map, rows_full, kb * rt::kBox, row);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kMlpStages; ++i) feed(i);
  if (pair == kMlpPairs - 1 && issuer) load_rows(blockIdx.x);
  float h[32], g[32];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int r0 = tile * rt::kTileRows + half * rt::kWgRows;
    const bool live[2] = {r0 + ra < n_rows, r0 + ra + 8 < n_rows};
    const size_t o = size_t(r0 + ra) * kMlp;  // row ra
    float* pw = part + (size_t(tile) * kMlpPartRows + half * 4 + warp) * kMlp + 2 * q;
    rt::mbar_wait(rows_full, it & 1);
#pragma unroll 1
    for (int c = pair; c < kMlpChunks; c += kMlpPairs) {
      const int e = it * kMlpTileEntries + 2 * c;  // W1's entry; W2's is e + 1
      issue_h(h, y2a, acquire(e));
      issue_g(g, douta, acquire(e + 1));
      rt::wgmma_wait<1>();  // h is done; g's product runs on
      release(e);
      pair_sync();
      if (issuer && half == 0) feed(e + 3);
      rt::fence_acc(h);
      mlp_gelu(h, b1 + c * rt::kBox + 2 * q, hg + o + c * rt::kBox, live, q);
      rt::wgmma_wait<0>();
      release(e + 1);
      pair_sync();
      if (issuer && half == 1) feed(e + 4);
      rt::fence_acc(g);
      if (issuer && c + kMlpPairs >= kMlpChunks) {  // the tile's last products have read the rows
        rt::mbar_arrive(rows_free);
        if (pair == kMlpPairs - 1 && tile + gridDim.x < n_tiles) {
          rt::mbar_wait(rows_free, it & 1);
          load_rows(tile + gridDim.x);
        }
      }
      mlp_dh(h, g, dh + o + c * rt::kBox, pw + c * rt::kBox, lane, live);
    }
  }
}

// ------------------------------------- W^T products with a LayerNorm backward

// dy (128 rows x all 256 columns, f32) = A (rows x K) @ W^T, W stored (256,
// K) row-major (W1 for dy2 = dh W1^T, W_qkv for dy = dqkv W_qkv^T), then the
// LayerNorm backward of each row. A persistent CTA an SM walks the row
// tiles; the producer streams each tile's K in chunks of 64: both
// warpgroups' A boxes (64 x 64, K-major) and W's 256 x 64 box (K-major,
// read as W^T's B) in 48 KB stages of a 3-stage ring, which the next tile's
// first chunks fill during this tile's epilogue. Each warp stages its 16
// rows of the accumulators 8 at a time in its own 8 KB of shared memory
// (row i at i KB, float j of a row at j ^ (8 i): a conflict-free float2
// store from the accumulator layout, a 32-byte read a lane along a row),
// runs ln_bwd_row on them, four rows' src and resid loads issued together
// (a prefetch of the tile's rows into L2 by the producer, under the
// products, made both launches slower: experiments/stblock_bwd_ab.py
// ln_pf), and stages its column sums over its rows, which the tile's 8
// warps add in order into part[tile][kSums][256] (held in registers over
// all of a CTA's tiles, they took 32 registers that the products need, and
// spilled). All 16 rows staged at once (128 KB) left room for two stages
// only, and the ring, not the tensor cores, set the pace.
constexpr int kLnStages = 3;
constexpr int kLnStageBytes = kABytes + rt::kStageBytes;  // 48 KB
constexpr int kLnWarps = rt::kConsumers * 4;
constexpr int kStgRows = 8;  // rows a warp stages at once: its 16 in two halves
constexpr size_t kStgBytes = size_t(kLnWarps) * kStgRows * kDim * 4;
constexpr size_t kLnSmem = 1024 + size_t(kLnStages) * kLnStageBytes + kStgBytes + 16 * kLnStages;
static_assert(kLnSmem <= size_t(kSmemLimit), "the ring and the staged dy rows");
constexpr int kLnAhead = 4;  // rows whose operands are loaded together

template <bool kLn2>
__global__ void __launch_bounds__(rt::kThreads, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
               int K, const bf16* __restrict__ src, const bf16* __restrict__ ln_g,
               const void* __restrict__ resid, float* __restrict__ out32,
               bf16* __restrict__ out16, float* __restrict__ part, int n_rows) {
  constexpr int kSums = kLn2 ? 4 : 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring_p = align1k(smem_raw);
  float* stg = reinterpret_cast<float*>(ring_p + kLnStages * kLnStageBytes);
  const uint32_t bars = smem_u32(stg + kLnWarps * kStgRows * kDim);
  if (threadIdx.x == 0) rt::ring_init<kLnStages>(bars);
  __syncthreads();
  const int n_tiles = (n_rows + rt::kTileRows - 1) / rt::kTileRows;
  const int chunks = K / rt::kBox;
  const int wg = threadIdx.x / 128;
  rt::Ring<kLnStages, kLnStageBytes> ring{smem_u32(ring_p), bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile * rt::kTileRows;
        for (int kc = 0; kc < chunks; ++kc) {
          uint32_t bar;
          const uint32_t dst = ring.claim(&bar);
#pragma unroll
          for (int w = 0; w < rt::kConsumers; ++w)
            rt::tma_load(dst + w * rt::kBoxBytes, &a_map, bar, kc * rt::kBox,
                         m0 + w * rt::kWgRows);
          rt::tma_load(dst + kABytes, &w_map, bar, kc * rt::kBox, 0);
        }
      }
    }
  } else {
    rt::regs_inc<rt::kConsumerRegs>();
    const int cw = threadIdx.x / 32;  // the consumer warp: rows 16 cw ... of a tile
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    float* my = stg + cw * kStgRows * kDim;
    float acc[128];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      // the first k-step overwrites acc; zeroing it tells the compiler so,
      // which frees its registers for the epilogue
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < chunks; ++kc) {
        const uint32_t s = ring.acquire();
        rt::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rt::wgmma_m64n256<0, 0>(acc, rt::desc_a(s + wg * rt::kBoxBytes + j * 32),
                                  rt::desc_a(s + kABytes + j * 32), kc | j);
        rt::wgmma_commit();
        if (kc > 0) {
          rt::wgmma_wait<1>();
          ring.release(ring.next - 2);
        }
      }
      rt::wgmma_wait<0>();
      ring.release(ring.next - 1);
      rt::fence_acc(acc);

      // acc[4j + 2h + i] is the warp's row g + 8h, column 8j + 2q + i: row
      // g + 8h goes to staging row g of the warp's half h
      const int row0 = tile * rt::kTileRows + cw * 16;
      float sums[kSums][8] = {};
      float gg[8];
      load8(ln_g + lane * 8, gg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<float2*>(my + g * kDim + 8 * (j ^ g) + 2 * q) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        __syncwarp();
#pragma unroll 1
        for (int i0 = 0; i0 < kStgRows; i0 += kLnAhead) {
          // the rows' operands, packed until used (bf16: 4 registers a row)
          uint4 xv[kLnAhead], rv[kLnAhead][kLn2 ? 1 : 2];
#pragma unroll
          for (int u = 0; u < kLnAhead; ++u) {
            const int r = row0 + 8 * h + i0 + u;
            const size_t o = size_t(r) * kDim + lane * 8;
            if (r < n_rows) {
              xv[u] = *reinterpret_cast<const uint4*>(src + o);
              if (kLn2) {
                rv[u][0] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(resid) + o);
              } else {
#pragma unroll
                for (int k = 0; k < (kLn2 ? 1 : 2); ++k)
                  rv[u][k] = reinterpret_cast<const uint4*>(static_cast<const float*>(resid) + o)[k];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kLnAhead; ++u) {
            const int i = i0 + u, r = row0 + 8 * h + i;
            if (r < n_rows) {  // the same for the whole warp
              float v[8], res[8];
              sb::unpack8(xv[u], v);
              if (kLn2) {
                sb::unpack8(rv[u][0], res);
              } else {
#pragma unroll
                for (int k = 0; k < (kLn2 ? 1 : 2); ++k) {
                  res[4 * k] = __uint_as_float(rv[u][k].x);
                  res[4 * k + 1] = __uint_as_float(rv[u][k].y);
                  res[4 * k + 2] = __uint_as_float(rv[u][k].z);
                  res[4 * k + 3] = __uint_as_float(rv[u][k].w);
                }
              }
              ln_bwd_row<kLn2>(v, my + i * kDim + 8 * (lane ^ i), gg, res, out32, out16,
                               size_t(r) * kDim + lane * 8, sums);
            }
          }
        }
        __syncwarp();  // every lane has read the rows before the next stores
      }
      // the warp's column sums over its 16 rows into its staging rows, then
      // the tile's 8 warps added in order: part[tile][kSums][256]
#pragma unroll
      for (int k = 0; k < kSums; ++k) store8f(my + k * kDim + lane * 8, sums[k]);
      rt::consumers_sync();
      for (int i = threadIdx.x; i < kSums * kDim; i += kLnWarps * 32) {
        float t = 0.f;
        for (int w = 0; w < kLnWarps; ++w) t += stg[w * kStgRows * kDim + i];
        part[size_t(tile) * kSums * kDim + i] = t;
      }
      rt::consumers_sync();  // every warp has read the sums before the next tile's stores
    }
  }
}

// ---------------------------------------------------- column sums

// out[i] = sum over z < slices of part[z * stride + i], four columns a
// thread (16-byte loads; count, stride and both pointers multiples of four
// floats). Thread (c, j) of a (256 / ways) x ways block sums slices [j per,
// (j + 1) per) in order, and the ways' sums are added in order j = 0, 1,
// ...; ways depends on the shape only, so two calls sum in the same order.
// Few slices (the split-K weight gradients) take one way; many (a partial
// per sequence, per row tile or per warp of one) 32, and thousands 128, so
// that a column's loads are spread over as many threads.
__global__ void __launch_bounds__(256)
sum_slices_kernel(const float* __restrict__ part, int slices, int stride, int count,
                  float* __restrict__ out) {
  __shared__ float4 red[256];
  const int ways = blockDim.y;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int per = (slices + ways - 1) / ways;
  const int z1 = min(slices, (threadIdx.y + 1) * per);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < count) {
#pragma unroll 4
    for (int z = threadIdx.y * per; z < z1; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(part + size_t(z) * stride + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  if (ways == 1) {
    if (i < count) *reinterpret_cast<float4*>(out + i) = s;
    return;
  }
  red[threadIdx.y * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < count) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < ways; ++w) {
      const float4 v = red[w * blockDim.x + threadIdx.x];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) = t;
  }
}

cudaError_t sum_slices(const float* part, int slices, int stride, int count, float* out,
                       cudaStream_t s) {
  const int ways = slices >= 2048 ? 128 : slices >= 64 ? 32 : 1;
  const dim3 block(256 / ways, ways);
  const int threads = count / 4;
  sum_slices_kernel<<<(threads + block.x - 1) / block.x, block, 0, s>>>(part, slices, stride,
                                                                        count, out);
  return cudaGetLastError();
}

// The K slices of an m x n weight gradient over `rows` rows: the most that
// keep tiles x slices <= kWgradItems, each a whole number of chunks, none
// empty; writes the chunks a slice takes to *per.
int wgrad_slices(int m, int n, int rows, int* per) {
  const int tiles = (m / rt::kTileRows) * (n / kTileN);
  const int chunks = (rows + rt::kBox - 1) / rt::kBox;
  const int want = std::max(1, std::min(chunks, kWgradItems / tiles));
  *per = (chunks + want - 1) / want;
  return (chunks + *per - 1) / *per;
}

// out (m x n, f32) = X^T @ G over all `rows` rows: x_map over X (rows x m)
// and g_map over G (rows x n), bf16, boxes of 64 x 64; partials in part,
// summed in order.
cudaError_t weight_grad(const CUtensorMap& x_map, int m, const CUtensorMap& g_map, int n, int rows,
                        float* part, float* out, cudaStream_t s) {
  int per = 0;
  const int slices = wgrad_slices(m, n, rows, &per);
  const int n_tiles = n / kTileN;
  const GemmArgs p{n_tiles, (m / rt::kTileRows) * n_tiles, slices,
                   (rows + rt::kBox - 1) / rt::kBox, per, m, part, n, size_t(m) * n};
  cudaError_t err = gemm<true, true>(x_map, g_map, p, s);
  if (err != cudaSuccess) return err;
  return sum_slices(part, slices, m * n, m * n, out, s);
}

// Floats of the split-K partials: tiles x slices <= max(kWgradItems, tiles)
// work items of 128 x 256, tiles <= 8.
constexpr size_t kPartFloats = size_t(std::max(kWgradItems, 8)) * rt::kTileRows * kTileN;

// ------------------------------------------------- attention backward

struct SeqRows {  // row of token t of sequence s: (s / inner_n) outer + (s % inner_n) inner + t step
  long long outer, inner, step;
  int inner_n;
};

constexpr float kAttnScale = 0.17677669529663687f;  // 32^-0.5
constexpr int kBwdMaxLen = 256;  // the longest sequence the attention backward takes

constexpr int kBwdWarps = 8;  // the most warps of one (sequence, head) block

// Element (r, c) of a head tile in shared memory: rows of 32 bf16 (64
// bytes, no padding), the row's 16-byte chunk c / 8 stored at chunk (c / 8)
// ^ ((r / 2) % 4), so the 8 rows an ldmatrix reads at one chunk hit 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int hidx(int r, int c) {
  return r * kDimHead + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// Shared memory of one (sequence, head): Q, K, V, bf16(do), bf16(bf16(r) q)
// and bf16(r do), each L rows padded to whole 16-row tiles, then c per
// query (f32), then each warp's column sums of dq, dk and dv.
size_t attn_bwd_smem(int L) {
  const int rows = (L + 15) / 16 * 16;
  return size_t(rows) * (6 * kDimHead * 2 + 4) + size_t(kBwdWarps) * 3 * kDimHead * 4;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScaleLog2 = kAttnScale * kLog2e;
constexpr float kClampLog2 = kScoreClamp * kLog2e;

// e = exp(min(s scale, 80)) where live, else 0, as the forward's attention
// kernel (attention.cu) takes it: 2^(min(s scale log2 e, 80 log2 e)) on
// the SFU's ex2, one multiply, a min and the ex2 (expf took ten
// instructions). It is taken in every case and multiplied by 1 or 0 (e is
// finite: at most exp(80)), so no branch splits a tile's scores: one around
// each exponential left a single one in flight at a time.
__device__ __forceinline__ float score_exp(float s, bool live) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(fminf(s * kScaleLog2, kClampLog2)));
  return __fmul_rn(e, live ? 1.f : 0.f);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Scores and dA of one 16-row tile (A fragments a_s, a_d: two k16 steps of
// dh = 32) against the 16 rows at b_s, b_d of the B operands (stored
// [row][dim], read as the n side; n_off: this lane's element offsets of
// its row at the two k steps): s = a_s . b_s, da = a_d . b_d.
__device__ __forceinline__ void tile_products(const unsigned (&a_s)[2][4],
                                              const unsigned (&a_d)[2][4], const bf16* b_s,
                                              const bf16* b_d, const int (&n_off)[2],
                                              float (&s)[2][4], float (&da)[2][4]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = da[nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    unsigned f[4];
    ldsm_x4(f, smem_u32(b_s + n_off[kk]));
    mma_bf16(s[0], a_s[kk], f[0], f[1]);
    mma_bf16(s[1], a_s[kk], f[2], f[3]);
    ldsm_x4(f, smem_u32(b_d + n_off[kk]));
    mma_bf16(da[0], a_d[kk], f[0], f[1]);
    mma_bf16(da[1], a_d[kk], f[2], f[3]);
  }
}

// acc (16 x 32, four n8 blocks) += P (16 x 16, A fragment) @ the 16 rows
// at b x 32 (stored [row][dim], read with .trans; a_off: this lane's
// element offsets at the two 16-column halves)
__device__ __forceinline__ void pv_product(const unsigned (&p)[4], const bf16* b,
                                           const int (&a_off)[2], float (&acc)[4][4]) {
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    unsigned f[4];
    ldsm_x4_trans(f, smem_u32(b + a_off[d]));
    mma_bf16(acc[2 * d], p, f[0], f[1]);
    mma_bf16(acc[2 * d + 1], p, f[2], f[3]);
  }
}

// One block per (sequence, head), dh = 32, on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate), one warp a 16-row tile, up to 8; the
// launcher takes it for L <= 64 (the spatial half's 17 joints), where the
// wgmma kernel's 64-row tiles would be mostly padding.
// Pass 1, warp by warp over 16-query tiles: sweep the keys once for
// sum(e) and sum(da e) (r and c), then again for ds = bf16(t - c e) and
// dq = (ds k)(r scale); ds goes from the accumulators straight into the A
// operand, as P does in attention.cu. Pass 2, over 16-key tiles: the
// transposed tiles s^T = k q^T and da^T = v do^T, then dv += bf16(e)^T
// bf16(r do) and dk += ds^T bf16(bf16(r) q), times scale. Padded rows are
// zero; a query past L gets e = 0. Each pass recomputes e from the scores,
// so nothing of size L x L is stored. dqkv leaves as bf16 only; db_qkv's
// partial of the block, the column sums of the f32 dq, dk and dv over the
// sequence's rows (each warp's tiles in order, its lanes by shuffles, then
// the warps in order), goes to part[sequence][768] at the head's columns.
__global__ void __launch_bounds__(kBwdWarps * 32, 2)
attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ datt,
                     bf16* __restrict__ dqkv16, float* __restrict__ part, int L, SeqRows sr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (L + 15) / 16 * 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * kDimHead;
  bf16* vs = ks + rows * kDimHead;
  bf16* dos = vs + rows * kDimHead;
  bf16* rqs = dos + rows * kDimHead;
  bf16* rdos = rqs + rows * kDimHead;
  float* cs = reinterpret_cast<float*>(rdos + rows * kDimHead);
  float* red = cs + rows;  // [warp][dq, dk, dv][32]
  const int seq = blockIdx.x;
  const int hq = blockIdx.y * kDimHead;
  const long long base = (seq / sr.inner_n) * sr.outer + (seq % sr.inner_n) * sr.inner;
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < rows * (kDimHead / 8); i += blockDim.x) {
    const int r = i / (kDimHead / 8);
    const int c = (i % (kDimHead / 8)) * 8;
    const int e = hidx(r, c);
    if (r < L) {
      const long long row = base + r * sr.step;
      const bf16* src = qkv + row * kQkv + hq + c;
      copy16(qs + e, src);
      copy16(ks + e, src + kDim);
      copy16(vs + e, src + 2 * kDim);
      float t[8];
      load8f(datt + row * kDim + hq + c, t);
      store8(dos + e, t);
    } else {
      bf16* const bufs[6] = {qs, ks, vs, dos, rqs, rdos};
#pragma unroll
      for (int b = 0; b < 6; ++b) *reinterpret_cast<uint4*>(bufs[b] + e) = zero16;
    }
  }
  for (int i = L + threadIdx.x; i < rows; i += blockDim.x) cs[i] = 0.f;
  __syncthreads();

  const int g = lane / 4;
  const int q4 = lane % 4;
  // this lane's ldmatrix rows within a 16-row tile (a multiple of 16 rows
  // from the buffer's start, so the swizzle depends on the lane only): A
  // fragments (and the .trans B of pv_product) at row lane % 16, chunk
  // lane / 16 (+ 2 for the second k step); n-side B at row (lane / 16) 8 +
  // lane % 8, chunk (lane / 8) % 2 (+ 2)
  int a_off[2], n_off[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a_off[kk] = hidx(lane % 16, (lane / 16) * 8 + kk * 16);
    n_off[kk] = hidx((lane / 16) * 8 + lane % 8, ((lane / 8) % 2) * 8 + kk * 16);
  }
  const int tile = 16 * kDimHead;  // elements of a 16-row tile
  // this lane's column sums: columns nb * 8 + 2 q4 (+ 1) over its rows
  float cq[4][2] = {}, ck[4][2] = {}, cv[4][2] = {};

  for (int qt = warp; qt < rows / 16; qt += n_warps) {
    unsigned qa[2][4], da_a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldsm_x4(qa[kk], smem_u32(qs + qt * tile + a_off[kk]));
      ldsm_x4(da_a[kk], smem_u32(dos + qt * tile + a_off[kk]));
    }
    float sum_e[2] = {0.f, 0.f}, sum_t[2] = {0.f, 0.f};
    for (int kb = 0; kb < rows / 16; ++kb) {
      float s[2][4], da[2][4];
      tile_products(qa, da_a, ks + kb * tile, vs + kb * tile, n_off, s, da);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb * 16 + nb * 8 + 2 * q4 + (i & 1);
          const float e = score_exp(s[nb][i], key < L);
          sum_e[i / 2] += e;
          sum_t[i / 2] += __fmul_rn(da[nb][i], e);
        }
    }
    float r[2], c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum_e[h] += __shfl_xor_sync(0xffffffffu, sum_e[h], 1);
      sum_e[h] += __shfl_xor_sync(0xffffffffu, sum_e[h], 2);
      sum_t[h] += __shfl_xor_sync(0xffffffffu, sum_t[h], 1);
      sum_t[h] += __shfl_xor_sync(0xffffffffu, sum_t[h], 2);
      r[h] = 1.f / sum_e[h];
      c[h] = r[h] * sum_t[h];
    }
    float dq[4][4] = {};
    for (int kb = 0; kb < rows / 16; ++kb) {
      float s[2][4], da[2][4];
      tile_products(qa, da_a, ks + kb * tile, vs + kb * tile, n_off, s, da);
      unsigned p[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb * 16 + nb * 8 + 2 * q4 + (i & 1);
          const float e = score_exp(s[nb][i], key < L);
          ds[i] = __fsub_rn(__fmul_rn(da[nb][i], e), __fmul_rn(c[i / 2], e));
        }
        p[2 * nb] = pack_bf16x2(ds[0], ds[1]);
        p[2 * nb + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      pv_product(p, ks + kb * tile, a_off, dq);
    }
    // dq rows qt*16 + g (+ 8): scale, store; r, c and the pass-2 operands
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_i = qt * 16 + g + 8 * h;
      if (row_i >= L) continue;
      const long long row = base + row_i * sr.step;
      const float rs = r[h] * kAttnScale;
      const float rb = round_bf16(r[h]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = nb * 8 + 2 * q4;
        const float v0 = dq[nb][2 * h] * rs, v1 = dq[nb][2 * h + 1] * rs;
        cq[nb][0] += v0;
        cq[nb][1] += v1;
        store2(dqkv16 + row * kQkv + hq + col, v0, v1);
        const int e = hidx(row_i, col);
        const float2 qv = load2(qs + e);
        store2(rqs + e, rb * qv.x, rb * qv.y);
        const float2 dv = *reinterpret_cast<const float2*>(datt + row * kDim + hq + col);
        store2(rdos + e, r[h] * dv.x, r[h] * dv.y);
      }
      if (q4 == 0) cs[row_i] = c[h];
    }
  }
  __syncthreads();

  for (int kt = warp; kt < rows / 16; kt += n_warps) {
    unsigned ka[2][4], va[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldsm_x4(ka[kk], smem_u32(ks + kt * tile + a_off[kk]));
      ldsm_x4(va[kk], smem_u32(vs + kt * tile + a_off[kk]));
    }
    float dk[4][4] = {}, dv[4][4] = {};
    for (int qb = 0; qb < rows / 16; ++qb) {
      float s[2][4], da[2][4];  // rows: keys of this tile; columns: queries
      tile_products(ka, va, qs + qb * tile, dos + qb * tile, n_off, s, da);
      unsigned pe[4], pds[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float e[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int query = qb * 16 + nb * 8 + 2 * q4 + (i & 1);
          // past L: e = 0 and c = 0, so ds = 0
          e[i] = score_exp(s[nb][i], query < L);
          ds[i] = __fsub_rn(__fmul_rn(da[nb][i], e[i]), __fmul_rn(cs[query], e[i]));
        }
        pe[2 * nb] = pack_bf16x2(e[0], e[1]);
        pe[2 * nb + 1] = pack_bf16x2(e[2], e[3]);
        pds[2 * nb] = pack_bf16x2(ds[0], ds[1]);
        pds[2 * nb + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      pv_product(pe, rdos + qb * tile, a_off, dv);
      pv_product(pds, rqs + qb * tile, a_off, dk);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_j = kt * 16 + g + 8 * h;
      if (row_j >= L) continue;
      const long long row = base + row_j * sr.step;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = nb * 8 + 2 * q4;
        const float k0 = dk[nb][2 * h] * kAttnScale, k1 = dk[nb][2 * h + 1] * kAttnScale;
        const float v0 = dv[nb][2 * h], v1 = dv[nb][2 * h + 1];
        ck[nb][0] += k0;
        ck[nb][1] += k1;
        cv[nb][0] += v0;
        cv[nb][1] += v1;
        store2(dqkv16 + row * kQkv + kDim + hq + col, k0, k1);
        store2(dqkv16 + row * kQkv + 2 * kDim + hq + col, v0, v1);
      }
    }
  }

  // the lanes of one q4 hold the same columns: sum the warp's rows, then
  // the warps in order
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cq[nb][i] += __shfl_xor_sync(0xffffffffu, cq[nb][i], off);
        ck[nb][i] += __shfl_xor_sync(0xffffffffu, ck[nb][i], off);
        cv[nb][i] += __shfl_xor_sync(0xffffffffu, cv[nb][i], off);
      }
  if (g == 0)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = nb * 8 + 2 * q4 + i;
        red[(warp * 3 + 0) * kDimHead + col] = cq[nb][i];
        red[(warp * 3 + 1) * kDimHead + col] = ck[nb][i];
        red[(warp * 3 + 2) * kDimHead + col] = cv[nb][i];
      }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * kDimHead; i += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < n_warps; ++w) t += red[w * 3 * kDimHead + i];
    const int which = i / kDimHead;  // 0: q, 1: k, 2: v
    part[size_t(seq) * kQkv + which * kDim + hq + i % kDimHead] = t;
  }
}

// ------------------------------- attention backward on wgmma (L > 64)

// Sequences longer than one 64-row tile (the temporal slab and the
// joint-major sequences) take this kernel; shorter ones (the spatial
// half's 17 joints) attention_bwd_kernel, whose 16-row tiles waste less on
// them. One CTA per (sequence, head), two warpgroups, ~101 KB of shared
// memory at L = 256, at most 128 registers a thread: two CTAs share an SM.
// Q, K, V and bf16(do) of the head are stored in 64-byte rows in the
// 64-byte swizzle that the wgmma descriptors name (attention_sm90.cuh's
// head_desc), each buffer padded with zero rows to whole 64-row tiles.
// The arithmetic and its rounding points are attention_bwd_kernel's:
// - phase 1, query-major, a warpgroup's 64-query tile at a time: S = Q K^T
//   and dA = dO V^T against each 64-key block (m64n64k16, both operands
//   K-major from shared memory), e = exp(min(s scale, 80)) (0 past L), the
//   row sums of e and of da e (r, c); then again for ds = bf16(t - c e),
//   which goes from the accumulators into the A fragments of dq += ds K
//   (m64n32k16, K taken N-major with the transpose flag); dq (r scale) is
//   stored, and bf16(bf16(r) q), bf16(r do) and c go to shared memory;
// - phase 2, key-major, a 64-key tile at a time: S^T = K Q^T and dA^T = V
//   dO^T against each 64-query block, e and ds as above with each query's
//   c, then dv += bf16(e)^T bf16(r do) and dk += ds^T bf16(bf16(r) q) from
//   register fragments; dk scale and dv are stored.
// Each warp adds its tiles' column sums of the f32 dq, dk and dv (its rows
// by shuffles) into its own shared slot; the 8 slots are added in order
// into part[sequence][768] at the head's columns.
constexpr int kAwTile = 64;                       // query or key rows of a warpgroup's tile
constexpr int kHeadRow = kDimHead * 2;            // 64 bytes: a head row, the swizzle span
constexpr int kAwTileBytes = kAwTile * kHeadRow;  // 4 KB
constexpr int kAwThreads = rt::kConsumers * 128;
constexpr int kAwWarps = kAwThreads / 32;
constexpr int kAwMinLen = kAwTile + 1;  // the shortest sequence this kernel takes

size_t attn_bwd_wg_smem(int L) {
  const int rows = (L + kAwTile - 1) / kAwTile * kAwTile;
  return 1024 + size_t(rows) * (6 * kHeadRow + 4) + size_t(kAwWarps) * 3 * kDimHead * 4;
}
static_assert(2 * (1024 + kBwdMaxLen * (6 * kHeadRow + 4) + kAwWarps * 3 * kDimHead * 4 + 1024) <=
                  228 * 1024,
              "two CTAs of the longest sequence share an SM");

// s = A (64 rows x 32 at a, K-major) @ B^T (64 rows x 32 at b), and da = C
// (at c) @ D^T (at d): two k-steps each, then waits for them.
__device__ __forceinline__ void head_scores(float (&s)[32], float (&da)[32], uint32_t a,
                                            uint32_t b, uint32_t c, uint32_t d) {
  using attn::head_desc;
  const uint64_t da_ = head_desc<kDimHead>(a), db_ = head_desc<kDimHead>(b),
                 dc_ = head_desc<kDimHead>(c), dd_ = head_desc<kDimHead>(d);
  rt::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    rt::wgmma_m64n64<0, 0>(s, da_ + 2 * k, db_ + 2 * k, k);
    rt::wgmma_m64n64<0, 0>(da, dc_ + 2 * k, dd_ + 2 * k, k);
  }
  rt::wgmma_commit();
  rt::wgmma_wait<0>();
  rt::fence_acc(s);
  rt::fence_acc(da);
}

// This warp's column sums of one tile (columns 8j + 2q + i; rows by
// shuffles over the lanes of one q) added into its shared slot.
__device__ __forceinline__ void add_col_sums(float (&cs)[4][2], float* slot, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) cs[j][i] += __shfl_xor_sync(0xffffffffu, cs[j][i], off);
      if (lane < 4) slot[8 * j + 2 * lane + i] += cs[j][i];
    }
}

__global__ void __launch_bounds__(kAwThreads, 2)
attention_bwd_wg_kernel(const bf16* __restrict__ qkv, const float* __restrict__ datt,
                        bf16* __restrict__ dqkv16, float* __restrict__ part, int L, SeqRows sr) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int rows = (L + kAwTile - 1) / kAwTile * kAwTile;
  const int tiles = rows / kAwTile;
  const uint32_t tb = uint32_t(rows) * kHeadRow;  // bytes of one buffer
  unsigned char* qs = base;
  unsigned char* ks = base + tb;
  unsigned char* vs = base + 2 * tb;
  unsigned char* dos = base + 3 * tb;
  unsigned char* rqs = base + 4 * tb;
  unsigned char* rdos = base + 5 * tb;
  float* cs = reinterpret_cast<float*>(base + 6 * tb);
  float* red = cs + rows;  // [warp][dq, dk, dv][32]
  const uint32_t qs_s = smem_u32(qs), ks_s = smem_u32(ks), vs_s = smem_u32(vs),
                 dos_s = smem_u32(dos), rqs_s = smem_u32(rqs), rdos_s = smem_u32(rdos);
  const int seq = blockIdx.x;
  const int hq = blockIdx.y * kDimHead;
  const long long row_base = (seq / sr.inner_n) * sr.outer + (seq % sr.inner_n) * sr.inner;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const int ra = 16 * (warp % 4) + lane / 4, q = lane % 4;

  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < rows * (kDimHead / 8); i += kAwThreads) {
    const int r = i / (kDimHead / 8), c = (i % (kDimHead / 8)) * 8;
    const uint32_t o = attn::head_offset<kDimHead>(r, c);
    if (r < L) {
      const long long row = row_base + r * sr.step;
      const bf16* src = qkv + row * kQkv + hq + c;
      *reinterpret_cast<uint4*>(qs + o) = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(ks + o) = *reinterpret_cast<const uint4*>(src + kDim);
      *reinterpret_cast<uint4*>(vs + o) = *reinterpret_cast<const uint4*>(src + 2 * kDim);
      float t[8];
      load8f(datt + row * kDim + hq + c, t);
      store8(reinterpret_cast<bf16*>(dos + o), t);
    } else {
      unsigned char* const bufs[6] = {qs, ks, vs, dos, rqs, rdos};
#pragma unroll
      for (int b = 0; b < 6; ++b) *reinterpret_cast<uint4*>(bufs[b] + o) = zero16;
    }
  }
  for (int i = threadIdx.x; i < rows; i += kAwThreads)
    if (i >= L) cs[i] = 0.f;
  for (int i = threadIdx.x; i < kAwWarps * 3 * kDimHead; i += kAwThreads) red[i] = 0.f;
  rt::fence_proxy_async();  // generic stores, read by wgmma
  __syncthreads();

  float s[32], da[32];
  // phase 1: a warpgroup's 64-query tiles
  for (int qt = wg; qt < tiles; qt += rt::kConsumers) {
    const uint32_t qa = qs_s + qt * kAwTileBytes, doa = dos_s + qt * kAwTileBytes;
    float se[2] = {0.f, 0.f}, st[2] = {0.f, 0.f};
#pragma unroll 1
    for (int kb = 0; kb < tiles; ++kb) {
      head_scores(s, da, qa, ks_s + kb * kAwTileBytes, doa, vs_s + kb * kAwTileBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb * kAwTile + 8 * j + 2 * q + (i & 1);
          const float e = score_exp(s[4 * j + i], key < L);
          se[i / 2] += e;
          st[i / 2] += __fmul_rn(da[4 * j + i], e);
        }
    }
    float r[2], c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      se[h] += __shfl_xor_sync(0xffffffffu, se[h], 1);
      se[h] += __shfl_xor_sync(0xffffffffu, se[h], 2);
      st[h] += __shfl_xor_sync(0xffffffffu, st[h], 1);
      st[h] += __shfl_xor_sync(0xffffffffu, st[h], 2);
      r[h] = 1.f / se[h];
      c[h] = r[h] * st[h];
    }
    float dq[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dq[i] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < tiles; ++kb) {
      head_scores(s, da, qa, ks_s + kb * kAwTileBytes, doa, vs_s + kb * kAwTileBytes);
      unsigned p[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // fragment register u of k-step k: columns 16k + 8(u / 2) + 2q, + 1 of row ra + 8(u % 2)
          const int j = 2 * k + u / 2, h = u % 2;
          float ds[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = kb * kAwTile + 8 * j + 2 * q + i;
            const float e = score_exp(s[4 * j + 2 * h + i], key < L);
            ds[i] = __fsub_rn(__fmul_rn(da[4 * j + 2 * h + i], e), __fmul_rn(c[h], e));
          }
          p[k][u] = pack_bf16x2(ds[0], ds[1]);
        }
      rt::wgmma_fence();
      attn::issue_rows<kDimHead, kAwTile>(dq, p, ks_s + kb * kAwTileBytes);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
    }
    rt::fence_acc(dq);
    // dq rows ra (+ 8) of the tile: scale, store; r, c and phase 2's operands
    float csum[4][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_i = qt * kAwTile + ra + 8 * h;
      if (row_i >= L) continue;
      const long long row = row_base + row_i * sr.step;
      const float rs = r[h] * kAttnScale;
      const float rb = round_bf16(r[h]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * q;
        const float v0 = dq[4 * j + 2 * h] * rs, v1 = dq[4 * j + 2 * h + 1] * rs;
        csum[j][0] += v0;
        csum[j][1] += v1;
        store2(dqkv16 + row * kQkv + hq + col, v0, v1);
        const uint32_t o = attn::head_offset<kDimHead>(row_i, col);
        const float2 qv = load2(reinterpret_cast<const bf16*>(qs + o));
        store2(reinterpret_cast<bf16*>(rqs + o), rb * qv.x, rb * qv.y);
        const float2 dv = *reinterpret_cast<const float2*>(datt + row * kDim + hq + col);
        store2(reinterpret_cast<bf16*>(rdos + o), r[h] * dv.x, r[h] * dv.y);
      }
      if (q == 0) cs[row_i] = c[h];
    }
    add_col_sums(csum, red + (warp * 3 + 0) * kDimHead, lane);
  }
  rt::fence_proxy_async();  // bf16(bf16(r) q) and bf16(r do), read by wgmma
  __syncthreads();

  // phase 2: a warpgroup's 64-key tiles
  for (int kt = wg; kt < tiles; kt += rt::kConsumers) {
    const uint32_t ka = ks_s + kt * kAwTileBytes, va = vs_s + kt * kAwTileBytes;
    float dk[16], dv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll 1
    for (int qb = 0; qb < tiles; ++qb) {
      // rows: keys of this tile; columns: queries
      head_scores(s, da, ka, qs_s + qb * kAwTileBytes, va, dos_s + qb * kAwTileBytes);
      unsigned pe[4][4], pd[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 2 * k + u / 2, h = u % 2;
          float e[2], ds[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int query = qb * kAwTile + 8 * j + 2 * q + i;
            // past L: e = 0 and c = 0, so ds = 0
            e[i] = score_exp(s[4 * j + 2 * h + i], query < L);
            ds[i] = __fsub_rn(__fmul_rn(da[4 * j + 2 * h + i], e[i]), __fmul_rn(cs[query], e[i]));
          }
          pe[k][u] = pack_bf16x2(e[0], e[1]);
          pd[k][u] = pack_bf16x2(ds[0], ds[1]);
        }
      rt::wgmma_fence();
      attn::issue_rows<kDimHead, kAwTile>(dv, pe, rdos_s + qb * kAwTileBytes);
      attn::issue_rows<kDimHead, kAwTile>(dk, pd, rqs_s + qb * kAwTileBytes);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
    }
    rt::fence_acc(dk);
    rt::fence_acc(dv);
    float sk[4][2] = {}, sv[4][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_j = kt * kAwTile + ra + 8 * h;
      if (row_j >= L) continue;
      const long long row = row_base + row_j * sr.step;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * q;
        const float k0 = dk[4 * j + 2 * h] * kAttnScale, k1 = dk[4 * j + 2 * h + 1] * kAttnScale;
        const float v0 = dv[4 * j + 2 * h], v1 = dv[4 * j + 2 * h + 1];
        sk[j][0] += k0;
        sk[j][1] += k1;
        sv[j][0] += v0;
        sv[j][1] += v1;
        store2(dqkv16 + row * kQkv + kDim + hq + col, k0, k1);
        store2(dqkv16 + row * kQkv + 2 * kDim + hq + col, v0, v1);
      }
    }
    add_col_sums(sk, red + (warp * 3 + 1) * kDimHead, lane);
    add_col_sums(sv, red + (warp * 3 + 2) * kDimHead, lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * kDimHead; i += kAwThreads) {
    float t = 0.f;
    for (int w = 0; w < kAwWarps; ++w) t += red[w * 3 * kDimHead + i];
    const int which = i / kDimHead;  // 0: q, 1: k, 2: v
    part[size_t(seq) * kQkv + which * kDim + hq + i % kDimHead] = t;
  }
}

// The workspace, carved in this order, each region 256-byte aligned (TMA
// maps take 16). The column partials hold, in turn, db1's (per warp of a
// row tile), LN_2's (per row tile), db_qkv's (per sequence) and LN_1's (per
// row tile).
struct Workspace {
  bf16 *y, *y2, *qkv, *hg, *dh, *dx1b, *dqkvb;
  float *dx1, *datt, *part, *colpart;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

size_t col_part_floats(size_t rows, size_t n_seq) {
  const size_t tiles = (rows + rt::kTileRows - 1) / rt::kTileRows;
  const size_t mlp = tiles * kMlpPartRows * kMlp;
  const size_t ln = tiles * 4 * kDim;
  return std::max(std::max(mlp, ln), n_seq * kQkv);
}

size_t carve(Workspace* w, unsigned char* base, size_t rows, size_t n_seq) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t b16 = sizeof(bf16), b32 = sizeof(float);
  Workspace t;
  t.y = reinterpret_cast<bf16*>(take(rows * kDim * b16));
  t.y2 = reinterpret_cast<bf16*>(take(rows * kDim * b16));
  t.qkv = reinterpret_cast<bf16*>(take(rows * kQkv * b16));
  t.hg = reinterpret_cast<bf16*>(take(rows * kMlp * b16));
  t.dh = reinterpret_cast<bf16*>(take(rows * kMlp * b16));
  t.dx1b = reinterpret_cast<bf16*>(take(rows * kDim * b16));
  t.dqkvb = reinterpret_cast<bf16*>(take(rows * kQkv * b16));
  t.dx1 = reinterpret_cast<float*>(take(rows * kDim * b32));
  t.datt = reinterpret_cast<float*>(take(rows * kDim * b32));
  t.part = reinterpret_cast<float*>(take(kPartFloats * b32));
  t.colpart = reinterpret_cast<float*>(take(col_part_floats(rows, n_seq) * b32));
  if (w) *w = t;
  return off;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The TMA maps of one call: the row operands in boxes of 64 rows x 64
// columns (read K-major as A, or M- and N-major by the weight gradients),
// and W_qkv and W_proj in 256 x 64 boxes (read K-major as W^T); W1's tall
// and W2's boxes are the forward's (sb::Maps).
struct RowMaps {
  CUtensorMap y, y2, att, dout, hg, dh, dx1b, dqkvb, w_qkv_t, w_proj_t;
};

cudaError_t make_row_maps(RowMaps* m, const Workspace& ws, const bf16* att, const bf16* dout,
                          const bf16* w, int rows) {
  const int box = rt::kBox;
  cudaError_t err = tile_map(&m->y, ws.y, rows, kDim, box);
  if (err == cudaSuccess) err = tile_map(&m->y2, ws.y2, rows, kDim, box);
  if (err == cudaSuccess) err = tile_map(&m->att, att, rows, kDim, box);
  if (err == cudaSuccess) err = tile_map(&m->dout, dout, rows, kDim, box);
  if (err == cudaSuccess) err = tile_map(&m->hg, ws.hg, rows, kMlp, box);
  if (err == cudaSuccess) err = tile_map(&m->dh, ws.dh, rows, kMlp, box);
  if (err == cudaSuccess) err = tile_map(&m->dx1b, ws.dx1b, rows, kDim, box);
  if (err == cudaSuccess) err = tile_map(&m->dqkvb, ws.dqkvb, rows, kQkv, box);
  if (err == cudaSuccess) err = tile_map(&m->w_qkv_t, w + kOffWQkv, kDim, kQkv, kDim);
  if (err == cudaSuccess) err = tile_map(&m->w_proj_t, w + kOffWProj, kDim, kDim, kDim);
  return err;
}

}  // namespace

#define POSE3D_TRY(call)                  \
  do {                                    \
    const cudaError_t e_ = (call);        \
    if (e_ != cudaSuccess) return e_;     \
  } while (0)

// Bytes of the workspace stblock_train_bwd_launch needs for n_rows rows in
// sequences of L (n_rows / L sequences).
extern "C" long long stblock_train_bwd_workspace(int n_rows, int L) {
  if (n_rows < 0 || L < 1) return -1;
  return static_cast<long long>(carve(nullptr, nullptr, n_rows, n_rows / L));
}

// x, x1, att, dout, dx: (rows, 256) bf16, the same bytes as the spatial
// rows or the (n_clips, T, 17 * 256) slab; weights: block_elems bf16 in the
// layout above; dw: block_elems f32, every gradient in the weights' layout;
// workspace: stblock_train_bwd_workspace(rows, L) bytes, 256-byte aligned;
// every pointer on a 16-byte boundary (TMA's rule).
// layout = 0 (kSpatial): the spatial half, n_outer frames of L = 17
// joints; 1 (kSlab): the slab, n_outer clips of L frames; 2 (kSequences):
// n_outer joint-major sequences of L rows, (n_outer, L, 256). block_elems
// is the caller's idea of the layout's size: a mismatch, another layout or
// L > kBwdMaxLen returns cudaErrorInvalidValue. Launches in a row on `stream`; the
// first error ends the sequence and is returned. Launches on the calling
// thread's current device, which must hold the operands.
enum Layout { kSpatial = 0, kSlab = 1, kSequences = 2 };

extern "C" cudaError_t stblock_train_bwd_launch(const void* x, const void* x1, const void* att,
                                                const void* dout, const void* weights,
                                                void* workspace, void* dx, void* dw,
                                                int n_outer, int L, int layout,
                                                int block_elems, void* stream) {
  const int per_outer = layout == kSlab ? kJoints : 1;  // sequences per n_outer
  if (n_outer < 0 || L < 1 || block_elems != kBlockElems || layout < kSpatial ||
      layout > kSequences || (layout == kSpatial && L != kJoints) ||
      static_cast<long long>(n_outer) * L * per_outer > (1 << 26) || L > kBwdMaxLen)
    return cudaErrorInvalidValue;
  const int rows = n_outer * L * per_outer;
  if (rows == 0) return cudaSuccess;
  const int n_seq = n_outer * per_outer;
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* x1b = static_cast<const bf16*>(x1);
  const bf16* doutb = static_cast<const bf16*>(dout);
  const bf16* w = static_cast<const bf16*>(weights);
  float* g = static_cast<float*>(dw);
  Workspace ws;
  carve(&ws, static_cast<unsigned char*>(workspace), rows, n_seq);
  sb::Maps fm;  // the forward's: W_qkv, the qkv scratch, W1 (tall), W2
  RowMaps m;
  POSE3D_TRY(sb::make_maps<Traits>(&fm, w, ws.qkv, rows));
  POSE3D_TRY(make_row_maps(&m, ws, static_cast<const bf16*>(att), doutb, w, rows));
  const int row_blocks = (rows + kRowWarps - 1) / kRowWarps;
  const int tiles = sb::n_tiles(rows);
  int grid = 0;
  POSE3D_TRY(persistent_grid(tiles, &grid));

  // recompute: y and y2 (the weight gradients read them), qkv (the
  // forward's launch: LN_1 again, the product and the bias)
  ln_rows_kernel<<<row_blocks, kRowWarps * 32, 0, s>>>(xb, w + kOffLn1G, w + kOffLn1B, ws.y, rows);
  POSE3D_TRY(cudaGetLastError());
  ln_rows_kernel<<<row_blocks, kRowWarps * 32, 0, s>>>(x1b, w + kOffLn2G, w + kOffLn2B, ws.y2,
                                                       rows);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY((sb::launch_qkv<Traits, false>(fm, xb, w, nullptr, nullptr, rows, s)));

  // MLP half: hg and dh with db1's partials, then dy2 = dh W1^T with LN_2's
  // backward: dx1 (f32 and bf16); dbp, dg2, db2, db2f
  POSE3D_TRY(set_smem(mlp_bwd_kernel, kMlpSmem));
  mlp_bwd_kernel<<<grid, kMlpThreads, kMlpSmem, s>>>(m.y2, m.dout, fm.w1, fm.w2, w + kOffB1,
                                                      ws.hg, ws.dh, ws.colpart, rows);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY(sum_slices(ws.colpart, tiles * kMlpPartRows, kMlp, kMlp, g + kOffB1, s));
  POSE3D_TRY(set_smem(ln_gemm_kernel<true>, kLnSmem));
  ln_gemm_kernel<true><<<grid, rt::kThreads, kLnSmem, s>>>(
      m.dh, fm.w1, kMlp, x1b, w + kOffLn2G, doutb, ws.dx1, ws.dx1b, ws.colpart, rows);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY(sum_slices(ws.colpart, tiles, 4 * kDim, 3 * kDim, g + kOffBProj, s));
  POSE3D_TRY(sum_slices(ws.colpart + 3 * kDim, tiles, 4 * kDim, kDim, g + kOffB2, s));
  POSE3D_TRY(weight_grad(m.hg, kMlp, m.dout, kDim, rows, ws.part, g + kOffW2, s));
  POSE3D_TRY(weight_grad(m.y2, kDim, m.dh, kMlp, rows, ws.part, g + kOffW1, s));
  POSE3D_TRY(weight_grad(m.att, kDim, m.dx1b, kDim, rows, ws.part, g + kOffWProj, s));

  // attention half: datt = bf16(dx1) Wp^T
  POSE3D_TRY((gemm<false, false>(
      m.dx1b, m.w_proj_t, GemmArgs{1, tiles, 1, kDim / rt::kBox, kDim / rt::kBox, rows, ws.datt,
                                   kDim, 0}, s)));
  // sequence s, token t: row (s / inner_n) outer + (s % inner_n) inner + t step
  const SeqRows sr = layout == kSlab
                         ? SeqRows{static_cast<long long>(L) * kJoints, 1, kJoints, kJoints}
                         : SeqRows{L, 0, 1, 1};
  if (L >= kAwMinLen) {
    const size_t smem = attn_bwd_wg_smem(L);
    POSE3D_TRY(set_smem(attention_bwd_wg_kernel, smem));
    attention_bwd_wg_kernel<<<dim3(n_seq, kHeads), kAwThreads, smem, s>>>(
        ws.qkv, ws.datt, ws.dqkvb, ws.colpart, L, sr);
  } else {
    const size_t smem = attn_bwd_smem(L);
    POSE3D_TRY(set_smem(attention_bwd_kernel, smem));
    const int warps = min(kBwdWarps, (L + 15) / 16);  // one 16-row tile per warp and pass
    attention_bwd_kernel<<<dim3(n_seq, kHeads), warps * 32, smem, s>>>(
        ws.qkv, ws.datt, ws.dqkvb, ws.colpart, L, sr);
  }
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY(sum_slices(ws.colpart, n_seq, kQkv, kQkv, g + kOffBQkv, s));
  POSE3D_TRY(weight_grad(m.y, kDim, m.dqkvb, kQkv, rows, ws.part, g + kOffWQkv, s));
  // dy = bf16(dqkv) W_qkv^T with LN_1's backward: dx; dg1, db1
  POSE3D_TRY(set_smem(ln_gemm_kernel<false>, kLnSmem));
  ln_gemm_kernel<false><<<grid, rt::kThreads, kLnSmem, s>>>(
      m.dqkvb, m.w_qkv_t, kQkv, xb, w + kOffLn1G, ws.dx1, nullptr, static_cast<bf16*>(dx),
      ws.colpart, rows);
  POSE3D_TRY(cudaGetLastError());
  return sum_slices(ws.colpart, tiles, 2 * kDim, 2 * kDim, g + kOffLn1G, s);
}
