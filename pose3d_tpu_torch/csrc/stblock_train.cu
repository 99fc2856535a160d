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
// that the wrapper allocates:
// - LayerNorm rows (one warp a row) for the recomputed y and y2, and a
//   tiled mma.sync GEMM (128 x 128 tiles of 4 warps, a 4-slice cp.async
//   ring; martinez.cu's tile) whose operands may each be stored
//   transposed, so that the W^T products read the weights as they are and
//   the weight gradients read the row operands as they are (ldmatrix.trans
//   where needed): the recomputed qkv, datt = bf16(dx1) Wp^T and the
//   weight gradients;
// - mlp_bwd_kernel: the fc1 recompute and dout W2^T side by side, a block
//   per 128-row tile (held in shared memory) over all 1024 hidden columns,
//   h = y2 W1 + b1 kept in registers, hg and dh stored bf16, db1's column
//   partials of the tile;
// - ln_gemm_kernel: dy2 = dh W1^T and dy = bf16(dqkv) W_qkv^T per 128-row
//   tile of all 256 columns, the f32 product staged in shared memory and
//   the LayerNorm backward (LN_2's: dx1; LN_1's: dx) run on it with its
//   column partials (dbp, dg2, db2, db2f; dg1, db1);
// - the attention backward: one block per (sequence, head), Q, K, V and
//   dO of that head in shared memory, on the tensor cores: a pass over
//   16-query tiles (r, c, dq), then one over 16-key tiles (dk, dv), each
//   recomputing the scores, so nothing of size L x L is stored; it stores
//   dqkv as bf16 and its own column partials of the f32 dq, dk, dv;
// - the weight gradients contract over ALL rows (66,096 at 16 clips x 243
//   frames): a split-K GEMM writes a fixed number of row slices as f32
//   partials, and a second pass sums them in a fixed order; the bias and
//   LayerNorm gradients are summed in order from the partials their
//   producers wrote (per row tile, per sequence). No atomics: two calls on
//   the same inputs give bitwise equal gradients.
// Rounding points are the JAX backward's: gelu' of the f32 h, dh rounded
// to bf16 before db1 sums it, dx1 kept f32 (rounded only for dWp and datt),
// dqkv f32 for db_qkv (rounded for dWqkv and dy), and in the attention
// backward e = exp(min(s, 80)) with no row max, r = 1/sum(e), dv = bf16(e)^T
// bf16(r do), ds = bf16(t - c e) with t = da e and c = r sum(t), dq = (ds
// k)(r scale), dk = ds^T bf16(bf16(r) q) scale.
//
// What bounds it on this card. ~4 x 1.57 MFLOP per row of matrix products
// (recomputed qkv and fc1, then six products of the forward's size), 0.313
// ms at 16 clips x 243 frames on the tensor cores; its bytes, each operand
// once (174 MB), take 0.052 ms. What a launch sequence really costs is the
// workspace traffic between launches: this file's first design moved
// 3.57 GB a call at that shape, 1.07 ms at 3.35 TB/s before any stall,
// of which ~1.4 GB were four f32 intermediates (h, dqkv and the two dy)
// that each came back only for an epilogue or a column sum. This design
// keeps those in registers or shared memory and moves 2.22 GB (slab) or
// 2.24 GB (spatial, one db_qkv partial per frame), in 21 launches where
// the first design took 26. PERF.md has its times and its per-launch split.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <algorithm>

#include "common.cuh"

namespace {

using namespace pose3d;

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

constexpr float kInvSqrt2 = 0.7071067690849304f;

// d/dx of erf_poly: 0 where |x| >= 3 (pallas_lifter._erf_grad's strict <)
__device__ __forceinline__ float erf_grad_poly(float x) {
  if (!(fabsf(x) < 3.f)) return 0.f;
  const float s = x * x;
  float p = 4.7283642828e-08f;
  p = p * s + -2.1986137083e-06f;
  p = p * s + 4.5123548106e-05f;
  p = p * s + -5.4564336601e-04f;
  p = p * s + 4.4038703607e-03f;
  p = p * s + -2.5570011680e-02f;
  p = p * s + 1.1177045202e-01f;
  p = p * s + -3.7577772172e-01f;
  p = p * s + 1.1283599228e+00f;
  float d = 3.7826913512617466e-07f;
  d = d * s + -1.5390296539408155e-05f;
  d = d * s + 2.7074129320681095e-04f;
  d = d * s + -2.72821681573987e-03f;
  d = d * s + 1.7615482211112976e-02f;
  d = d * s + -7.67100378870964e-02f;
  d = d * s + 2.2354090213775635e-01f;
  d = d * s + -3.757777214050293e-01f;
  return p + 2.f * s * d;
}

// the exact derivative of gelu_poly (pallas_stblock_train._gelu_grad)
__device__ __forceinline__ float gelu_grad_poly(float x) {
  const float u = x * kInvSqrt2;
  return 0.5f * (1.f + erf_poly(u)) + 0.5f * x * kInvSqrt2 * erf_grad_poly(u);
}

// ------------------------------------------------------------------ GEMM

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kGemmThreads = 128;  // 2 x 2 warps of 64 x 64 outputs
constexpr int kLdRow = kBK + 8;    // a slice stored [128][32]: A (m, k) or B^T (n, k)
constexpr int kLdCol = kBM + 8;    // a slice stored [32][128]: A^T (k, m) or B (k, n)
constexpr int kSliceMax = kBM * kLdRow;
constexpr int kStageElems = 2 * kSliceMax;
constexpr size_t kGemmSmem = size_t(kStages) * kStageElems * sizeof(bf16);
static_assert(kBK * kLdCol <= kSliceMax, "a column slice fits the slot");
static_assert(kGemmSmem <= kSmemLimit, "exceeds the per-block shared memory");
constexpr int kTargetCtas = 264;  // split-K: about two CTAs per SM in all

enum Epi {
  kEpiF32,       // c32 = acc (per K slice at c32 + z * c_slice)
  kEpiBiasBf16,  // c16 = bf16(acc + bias)
};

// C (M x N) = A (M x K) @ B (K x N), bf16 in, f32 accumulate. kAT: A is
// stored K x M (lda its row pitch), else M x K; kBT: B is stored N x K,
// else K x N. N is a multiple of kBN; K slice z covers rows [z k_chunk,
// (z + 1) k_chunk) of the contraction.
struct GemmArgs {
  const bf16* a;
  const bf16* b;
  int M, N, K, lda, ldb, k_chunk;
  float* c32;
  bf16* c16;
  int ldc;
  size_t c_slice;
  const bf16* bias;
};

// Starts the copies of contraction rows [k0, k0 + kBK) (clipped at kend,
// and rows past M, zero-filled) of both operands into one ring slot.
template <bool kAT, bool kBT>
__device__ __forceinline__ void load_stage(bf16* slot, const GemmArgs& p, int m0, int n0,
                                           int k0, int kend) {
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  bf16* as = slot;
  bf16* bs = slot + kSliceMax;
  for (int i = threadIdx.x; i < kBM * kBK / 8; i += kGemmThreads) {
    bf16* d;
    const bf16* s = nullptr;
    if (!kAT) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      d = as + r * kLdRow + c;
      if (m0 + r < p.M && k0 + c < kend) s = p.a + size_t(m0 + r) * p.lda + k0 + c;
    } else {
      const int r = i / (kBM / 8), c = (i % (kBM / 8)) * 8;
      d = as + r * kLdCol + c;
      if (k0 + r < kend && m0 + c < p.M) s = p.a + size_t(k0 + r) * p.lda + m0 + c;
    }
    if (s) cp_async16(d, s);
    else *reinterpret_cast<uint4*>(d) = zero16;
  }
  for (int i = threadIdx.x; i < kBN * kBK / 8; i += kGemmThreads) {
    bf16* d;
    const bf16* s = nullptr;
    if (!kBT) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      d = bs + r * kLdCol + c;
      if (k0 + r < kend) s = p.b + size_t(k0 + r) * p.ldb + n0 + c;
    } else {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      d = bs + r * kLdRow + c;
      if (k0 + c < kend) s = p.b + size_t(n0 + r) * p.ldb + k0 + c;
    }
    if (s) cp_async16(d, s);
    else *reinterpret_cast<uint4*>(d) = zero16;
  }
}

template <bool kAT, bool kBT, int kEpi>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(kbeg + p.k_chunk, p.K);
  const int n_slices = (kend - kbeg + kBK - 1) / kBK;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) load_stage<kAT, kBT>(ring + s * kStageElems, p, m0, n0, kbeg + s * kBK, kend);
    cp_async_commit();
  }
  float acc[4][8][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // ldmatrix row addresses of this lane, in bytes from a slot's A and B
  // parts. Fragments: A (m16 x k16) is matrices (m 0-7, k 0-7), (m 8-15,
  // k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15); B (k16 x n16) is (k 0-7, n
  // 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15). A slice stored
  // the other way round is read with .trans.
  const unsigned a_lane =
      kAT ? (((lane / 16) * 8 + lane % 8) * kLdCol + wm * 64 + ((lane / 8) % 2) * 8) * 2
          : ((wm * 64 + lane % 16) * kLdRow + (lane / 16) * 8) * 2;
  const unsigned b_lane =
      kBT ? ((wn * 64 + (lane / 16) * 8 + lane % 8) * kLdRow + ((lane / 8) % 2) * 8) * 2
          : ((lane % 16) * kLdCol + wn * 64 + (lane / 16) * 8) * 2;
  for (int ks = 0; ks < n_slices; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = ks + kStages - 1;
    if (next < n_slices)
      load_stage<kAT, kBT>(ring + (next % kStages) * kStageElems, p, m0, n0, kbeg + next * kBK,
                           kend);
    cp_async_commit();

    const unsigned as = smem_u32(ring + (ks % kStages) * kStageElems);
    const unsigned bs = as + kSliceMax * 2;
#pragma unroll
    for (int u = 0; u < kBK / 16; ++u) {
      unsigned b[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (kBT) ldsm_x4(b[h], bs + b_lane + (h * 16 * kLdRow + u * 16) * 2);
        else ldsm_x4_trans(b[h], bs + b_lane + (u * 16 * kLdCol + h * 16) * 2);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        unsigned af[4];
        if (kAT) ldsm_x4_trans(af, as + a_lane + (u * 16 * kLdCol + m * 16) * 2);
        else ldsm_x4(af, as + a_lane + (m * 16 * kLdRow + u * 16) * 2);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma_bf16(acc[m][n], af, b[n / 2][(n % 2) * 2], b[n / 2][(n % 2) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4;
  const int q = lane % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n0 + wn * 64 + n * 8 + 2 * q;
    const float2 bv = kEpi == kEpiBiasBf16 ? load2(p.bias + c) : make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 64 + m * 16 + g + half * 8;
        if (r >= p.M) continue;
        const float v0 = acc[m][n][2 * half];
        const float v1 = acc[m][n][2 * half + 1];
        const size_t o = size_t(r) * p.ldc + c;
        if (kEpi == kEpiF32)
          *reinterpret_cast<float2*>(p.c32 + blockIdx.z * p.c_slice + o) = make_float2(v0, v1);
        else
          store2(p.c16 + o, v0 + bv.x, v1 + bv.y);
      }
    }
  }
}

template <bool kAT, bool kBT, int kEpi>
cudaError_t gemm(const GemmArgs& p, int slices, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kAT, kBT, kEpi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGemmSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / kBN, (p.M + kBM - 1) / kBM, slices);
  gemm_kernel<kAT, kBT, kEpi><<<grid, kGemmThreads, kGemmSmem, stream>>>(p);
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

// The LayerNorm backward of one row, one warp, 8 columns a lane: xhat and
// r recomputed from src (the LayerNorm's input, row r), dya = dy g, res =
// resid + r (dya - mean(dya) - xhat mean(dya xhat)). kLn2: resid is dout
// (bf16), res goes out as f32 (dx1) and bf16; else resid is dx1 (f32) and
// res goes out as bf16 (dx). The row's terms of the column sums are added
// to acc: kLn2 dx1, dy xhat, dy (dbp, dg2, db2, adjacent in the weights'
// layout) and dout (db2f); else dy xhat, dy (dg1, db1).
template <bool kLn2>
__device__ __forceinline__ void ln_bwd_row(const bf16* __restrict__ src, const float* dy,
                                           const float (&gg)[8], const void* __restrict__ resid,
                                           float* __restrict__ out32, bf16* __restrict__ out16,
                                           size_t r, int lane, float (&acc)[kLn2 ? 4 : 2][8]) {
  constexpr int kSums = kLn2 ? 4 : 2;
  constexpr int kG = kLn2 ? 1 : 0;  // where dy xhat and dy go
  const size_t o = r * kDim + lane * 8;
  float v[8], d[8], res[8];
  load8(src + o, v);
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
  load8f(dy + lane * 8, d);
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
  if (kLn2) load8(static_cast<const bf16*>(resid) + o, res);
  else load8f(static_cast<const float*>(resid) + o, res);
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

// One block per 128-row tile computes two products of K = 256 for all 1024
// hidden columns, 128 at a time, in the K order of a plain 16-deep mma
// chain: acc1 = y2 @ W1[:, tile] and acc2 = dout @ W2[tile, :]^T. Its
// epilogue forms h = acc1 + b1 in registers and stores hg =
// bf16(gelu(bf16(h))) and dh = bf16(acc2 gelu'(h)); h never reaches device
// memory. db1's partial of the row tile (the column sums of the bf16 dh
// over its rows, each warp's 32 rows by shuffles, then the 4 row warps in
// order) goes to part[tile][1024]. The row tile's y2 and dout stay in
// shared memory while W1 and W2 stream through a cp.async ring, so each
// operand crosses from L2 once a block (0.58 GB a call at 16 clips x 243
// frames, where blocks of 128 hidden columns that reload their row tile
// move 1.3 GB). 16 warps, 4 (rows) x 4 (columns) of 32 x 32 outputs per
// product, one block an SM.
constexpr int kMlpBM = 128;
constexpr int kMlpBN = 128;
constexpr int kMlpStages = 4;
constexpr int kMlpThreads = 512;
constexpr int kMlpSteps = (kMlp / kMlpBN) * (kDim / kBK);  // ring slices of a block
constexpr int kLdMlpA = kDim + 8;   // y2 and dout rows: [128][256]
constexpr int kLdB1 = kMlpBN + 8;   // W1 slice [32][128]: (k, n)
constexpr int kMlpA = kMlpBM * kLdMlpA;
constexpr int kMlpB1 = kBK * kLdB1;
constexpr int kMlpB2 = kMlpBN * kLdRow;  // W2 slice [128][32]: (n, k)
constexpr int kMlpStageElems = kMlpB1 + kMlpB2;
constexpr size_t kMlpRed = size_t(4) * kMlp * sizeof(float);  // db1 sums of the 4 row warps
constexpr size_t kMlpSmem =
    (size_t(2) * kMlpA + size_t(kMlpStages) * kMlpStageElems) * sizeof(bf16) + kMlpRed;
static_assert(kMlpSmem <= kSmemLimit, "the row tiles, the weight ring and the db1 sums");

// W1[:, n0 + 128) and W2[n0 + 128, :] at contraction rows [k0, k0 + 32)
__device__ __forceinline__ void mlp_load_weights(bf16* slot, const bf16* __restrict__ w1,
                                                 const bf16* __restrict__ w2, int n0, int k0) {
  for (int i = threadIdx.x; i < kBK * (kMlpBN / 8); i += kMlpThreads) {
    const int r = i / (kMlpBN / 8), c = (i % (kMlpBN / 8)) * 8;
    cp_async16(slot + r * kLdB1 + c, w1 + size_t(k0 + r) * kMlp + n0 + c);
  }
  bf16* b2 = slot + kMlpB1;
  for (int i = threadIdx.x; i < kMlpBN * (kBK / 8); i += kMlpThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    cp_async16(b2 + r * kLdRow + c, w2 + size_t(n0 + r) * kDim + k0 + c);
  }
}

__global__ void __launch_bounds__(kMlpThreads, 1)
mlp_bwd_kernel(const bf16* __restrict__ y2, const bf16* __restrict__ dout,
               const bf16* __restrict__ w1, const bf16* __restrict__ b1,
               const bf16* __restrict__ w2, bf16* __restrict__ hg, bf16* __restrict__ dh,
               float* __restrict__ part, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [y2, dout][128][kLdMlpA]
  bf16* ring = as + 2 * kMlpA;
  float* red = reinterpret_cast<float*>(ring + kMlpStages * kMlpStageElems);  // [4][1024]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int m0 = blockIdx.x * kMlpBM;

  // the row tiles (one commit group, rows past the end zero), then the
  // first slices of the weights
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < 2 * kMlpBM * (kDim / 8); i += kMlpThreads) {
    const int a = i / (kMlpBM * (kDim / 8));  // 0: y2, 1: dout
    const int t = i % (kMlpBM * (kDim / 8));
    const int r = t / (kDim / 8), c = (t % (kDim / 8)) * 8;
    bf16* d = as + a * kMlpA + r * kLdMlpA + c;
    if (m0 + r < rows) cp_async16(d, (a ? dout : y2) + size_t(m0 + r) * kDim + c);
    else *reinterpret_cast<uint4*>(d) = zero16;
  }
  cp_async_commit();
  constexpr int kSlices = kDim / kBK;
  for (int s = 0; s < kMlpStages - 1; ++s) {
    mlp_load_weights(ring + s * kMlpStageElems, w1, w2, (s / kSlices) * kMlpBN,
                     (s % kSlices) * kBK);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane, in bytes (as in gemm_kernel): A
  // rows at (lane % 16, (lane / 16) * 8); W1 (k, n) read with .trans; W2
  // (n, k) read as the B^T operand
  const unsigned a_lane =
      smem_u32(as) + ((wm * 32 + lane % 16) * kLdMlpA + (lane / 16) * 8) * 2;
  const unsigned b1_lane = ((lane % 16) * kLdB1 + wn * 32 + (lane / 16) * 8) * 2;
  const unsigned b2_lane =
      (kMlpB1 + (wn * 32 + (lane / 16) * 8 + lane % 8) * kLdRow + ((lane / 8) % 2) * 8) * 2;
  const int g = lane / 4;
  const int q = lane % 4;
  float acc1[2][4][4] = {}, acc2[2][4][4] = {};
  for (int step = 0; step < kMlpSteps; ++step) {
    cp_async_wait<kMlpStages - 2>();
    __syncthreads();
    const int next = step + kMlpStages - 1;
    if (next < kMlpSteps)
      mlp_load_weights(ring + (next % kMlpStages) * kMlpStageElems, w1, w2,
                       (next / kSlices) * kMlpBN, (next % kSlices) * kBK);
    cp_async_commit();
    const int k0 = (step % kSlices) * kBK;
    const unsigned base = smem_u32(ring + (step % kMlpStages) * kMlpStageElems);
#pragma unroll
    for (int u = 0; u < kBK / 16; ++u) {
      unsigned f1[2][4], f2[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ldsm_x4_trans(f1[h], base + b1_lane + (u * 16 * kLdB1 + h * 16) * 2);
        ldsm_x4(f2[h], base + b2_lane + (h * 16 * kLdRow + u * 16) * 2);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        unsigned a1[4], a2[4];
        ldsm_x4(a1, a_lane + (m * 16 * kLdMlpA + k0 + u * 16) * 2);
        ldsm_x4(a2, a_lane + (kMlpA + m * 16 * kLdMlpA + k0 + u * 16) * 2);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mma_bf16(acc1[m][n], a1, f1[n / 2][(n % 2) * 2], f1[n / 2][(n % 2) * 2 + 1]);
          mma_bf16(acc2[m][n], a2, f2[n / 2][(n % 2) * 2], f2[n / 2][(n % 2) * 2 + 1]);
        }
      }
    }
    if (step % kSlices != kSlices - 1) continue;

    // the epilogue of hidden columns [n0, n0 + 128)
    const int n0 = (step / kSlices) * kMlpBN;
    float csum[4][2] = {};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + wn * 32 + n * 8 + 2 * q;
      const float2 bv = load2(b1 + c);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + wm * 32 + m * 16 + g + half * 8;
          const float h0 = acc1[m][n][2 * half] + bv.x;
          const float h1 = acc1[m][n][2 * half + 1] + bv.y;
          acc1[m][n][2 * half] = acc1[m][n][2 * half + 1] = 0.f;
          const float d0 = round_bf16(acc2[m][n][2 * half] * gelu_grad_poly(h0));
          const float d1 = round_bf16(acc2[m][n][2 * half + 1] * gelu_grad_poly(h1));
          acc2[m][n][2 * half] = acc2[m][n][2 * half + 1] = 0.f;
          if (r >= rows) continue;
          const size_t o = size_t(r) * kMlp + c;
          store2(hg + o, gelu_poly(round_bf16(h0)), gelu_poly(round_bf16(h1)));
          store2(dh + o, d0, d1);
          csum[n][0] += d0;
          csum[n][1] += d1;
        }
      }
    }
    // the lanes of one q hold the same columns: sum the warp's rows
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          csum[n][i] += __shfl_xor_sync(0xffffffffu, csum[n][i], off);
        if (g == 0) red[wm * kMlp + n0 + wn * 32 + n * 8 + 2 * q + i] = csum[n][i];
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int c = threadIdx.x; c < kMlp; c += kMlpThreads) {
    float t = 0.f;
    for (int w = 0; w < 4; ++w) t += red[w * kMlp + c];
    part[size_t(blockIdx.x) * kMlp + c] = t;
  }
}

// ------------------------------------- W^T products with a LayerNorm backward

// dy (128 rows x all 256 columns) = A (rows x K) @ W^T, W stored (256, K)
// row-major (W1 for dy2 = dh W1^T, W_qkv for dy = dqkv W_qkv^T), in the K
// order of a plain 16-deep mma chain; then, on the f32 tile staged in
// shared memory, the LayerNorm backward of each row (ln_bwd_row: one warp
// a row, as a row pass would) and the tile's partial of its column sums
// (each warp's rows in order, then the 8 warps in order) at
// part[tile][kSums][256]. The f32 dy never reaches device memory. 16
// warps, 4 (rows) x 4 (columns) of 32 x 64 outputs, one block an SM: each
// block streams all of W from L2, so the taller the tile the fewer times.
constexpr int kLnBM = 128;
constexpr int kLnStages = 4;
constexpr int kLnWarps = 16;
constexpr int kLnThreads = kLnWarps * 32;
constexpr int kLnA = kLnBM * kLdRow;          // A slice [128][32]
constexpr int kLnStageElems = kLnA + kDim * kLdRow;  // + W slice [256][32]: (n, k)
constexpr int kLdDy = kDim + 8;  // f32 pitch: a half-warp's float2 stores of rows g hit distinct banks
constexpr size_t kLnSmem = size_t(kLnStages) * kLnStageElems * sizeof(bf16);
constexpr size_t kLnSmemEpi = size_t(kLnBM) * kLdDy * 4 + size_t(kLnWarps) * 4 * kDim * 4;
constexpr size_t kLnSmemAll = kLnSmem > kLnSmemEpi ? kLnSmem : kLnSmemEpi;
static_assert(kLnSmemAll <= kSmemLimit, "the ring, or the staged dy tile and the column sums");

__device__ __forceinline__ void ln_load_stage(bf16* slot, const bf16* __restrict__ a,
                                              const bf16* __restrict__ w, int rows, int K,
                                              int m0, int k0) {
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (kLnBM + kDim) * (kBK / 8); i += kLnThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    bf16* d = slot + r * kLdRow + c;
    if (r >= kLnBM) cp_async16(d, w + size_t(r - kLnBM) * K + k0 + c);
    else if (m0 + r < rows) cp_async16(d, a + size_t(m0 + r) * K + k0 + c);
    else *reinterpret_cast<uint4*>(d) = zero16;
  }
}

template <bool kLn2>
__global__ void __launch_bounds__(kLnThreads, 1)
ln_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, int K,
               const bf16* __restrict__ src, const bf16* __restrict__ ln_g,
               const void* __restrict__ resid, float* __restrict__ out32,
               bf16* __restrict__ out16, float* __restrict__ part, int rows) {
  constexpr int kSums = kLn2 ? 4 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int m0 = blockIdx.x * kLnBM;
  const int n_slices = K / kBK;

  for (int s = 0; s < kLnStages - 1; ++s) {
    ln_load_stage(ring + s * kLnStageElems, a, w, rows, K, m0, s * kBK);
    cp_async_commit();
  }
  float acc[2][8][4] = {};
  const unsigned a_lane = ((wm * 32 + lane % 16) * kLdRow + (lane / 16) * 8) * 2;
  const unsigned b_lane =
      (kLnA + (wn * 64 + (lane / 16) * 8 + lane % 8) * kLdRow + ((lane / 8) % 2) * 8) * 2;
  for (int ks = 0; ks < n_slices; ++ks) {
    cp_async_wait<kLnStages - 2>();
    __syncthreads();
    const int next = ks + kLnStages - 1;
    if (next < n_slices)
      ln_load_stage(ring + (next % kLnStages) * kLnStageElems, a, w, rows, K, m0, next * kBK);
    cp_async_commit();
    const unsigned base = smem_u32(ring + (ks % kLnStages) * kLnStageElems);
#pragma unroll
    for (int u = 0; u < kBK / 16; ++u) {
      unsigned b[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h) ldsm_x4(b[h], base + b_lane + (h * 16 * kLdRow + u * 16) * 2);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        unsigned af[4];
        ldsm_x4(af, base + a_lane + (m * 16 * kLdRow + u * 16) * 2);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma_bf16(acc[m][n], af, b[n / 2][(n % 2) * 2], b[n / 2][(n % 2) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  float* dy = reinterpret_cast<float*>(smem);  // [64][kLdDy]
  float* red = dy + kLnBM * kLdDy;             // [16 warps][kSums][256]
  const int g = lane / 4;
  const int q = lane % 4;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(dy + (wm * 32 + m * 16 + g + half * 8) * kLdDy + wn * 64 +
                                   n * 8 + 2 * q) =
            make_float2(acc[m][n][2 * half], acc[m][n][2 * half + 1]);
  __syncthreads();

  float sums[kSums][8] = {};
  float gg[8];
  load8(ln_g + lane * 8, gg);
  const int n_rows = min(kLnBM, rows - m0);
#pragma unroll 2
  for (int r = warp; r < n_rows; r += kLnWarps)
    ln_bwd_row<kLn2>(src, dy + r * kLdDy, gg, resid, out32, out16, size_t(m0 + r), lane, sums);
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(warp * kSums + k) * kDim + lane * 8 + j] = sums[k][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kSums * kDim; i += kLnThreads) {
    float t = 0.f;
    for (int w = 0; w < kLnWarps; ++w) t += red[w * kSums * kDim + i];
    part[size_t(blockIdx.x) * kSums * kDim + i] = t;
  }
}

// ---------------------------------------------------- column sums

// out[i] = sum over z < slices of part[z * stride + i]. Thread (c, j) of a
// (256 / ways) x ways block sums slices [j per, (j + 1) per) in order, and
// the ways' sums are added in order j = 0, 1, ...; ways depends on the
// shape only, so two calls sum in the same order. Few slices (the split-K
// weight gradients) take one way; many (a partial per row tile or per
// sequence) take 32, so that a column's loads are spread over 32 threads.
__global__ void __launch_bounds__(256)
sum_slices_kernel(const float* __restrict__ part, int slices, int stride, int count,
                  float* __restrict__ out) {
  __shared__ float red[256];
  const int ways = blockDim.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int per = (slices + ways - 1) / ways;
  const int z1 = min(slices, (threadIdx.y + 1) * per);
  float s = 0.f;
  if (i < count) {
#pragma unroll 4
    for (int z = threadIdx.y * per; z < z1; ++z) s += part[size_t(z) * stride + i];
  }
  if (ways == 1) {
    if (i < count) out[i] = s;
    return;
  }
  red[threadIdx.y * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < count) {
    float t = 0.f;
    for (int w = 0; w < ways; ++w) t += red[w * blockDim.x + threadIdx.x];
    out[i] = t;
  }
}

cudaError_t sum_slices(const float* part, int slices, int stride, int count, float* out,
                       cudaStream_t s) {
  const int ways = slices >= 64 ? 32 : 1;
  const dim3 block(256 / ways, ways);
  sum_slices_kernel<<<(count + block.x - 1) / block.x, block, 0, s>>>(part, slices, stride,
                                                                      count, out);
  return cudaGetLastError();
}

// out (M x N, f32) = a^T @ b over all `rows` rows: a stored rows x M, b
// stored rows x N (bf16), split over a fixed number of row slices given
// the shapes, partials in `part`, summed in order.
cudaError_t weight_grad(const bf16* a, int M, const bf16* b, int N, int rows, float* part,
                        float* out, cudaStream_t s) {
  const int tiles = (M / kBM) * (N / kBN);
  const int want = min((kTargetCtas + tiles - 1) / tiles, (rows + 255) / 256);
  const int chunk = ((rows + want - 1) / want + kBK - 1) / kBK * kBK;
  const int slices = (rows + chunk - 1) / chunk;
  GemmArgs p{a, b, M, N, rows, M, N, chunk, part, nullptr, N, size_t(M) * N, nullptr};
  cudaError_t err = gemm<true, false, kEpiF32>(p, slices, s);
  if (err != cudaSuccess) return err;
  return sum_slices(part, slices, M * N, M * N, out, s);
}

// Floats of the split-K partials: slices x tiles <= kTargetCtas + tiles.
constexpr size_t kPartFloats = size_t(kTargetCtas + 16) * kBM * kBN;

// ------------------------------------------------- attention backward

struct SeqRows {  // row of token t of sequence s: (s / inner_n) outer + (s % inner_n) inner + t step
  long long outer, inner, step;
  int inner_n;
};

constexpr float kAttnScale = 0.17677669529663687f;  // 32^-0.5
constexpr int kBwdMaxLen = 256;  // the longest sequence attention_bwd_kernel takes
constexpr int kLdA = kDimHead + 8;  // shared row pitch: 16 bytes of skew

constexpr int kBwdWarps = 8;  // the most warps of one (sequence, head) block

// Shared memory of one (sequence, head): Q, K, V, bf16(do), bf16(bf16(r) q)
// and bf16(r do), each L rows padded to whole 16-row tiles at pitch kLdA,
// then c per query (f32), then each warp's column sums of dq, dk and dv.
size_t attn_bwd_smem(int L) {
  const int rows = (L + 15) / 16 * 16;
  return size_t(rows) * (6 * kLdA * 2 + 4) + size_t(kBwdWarps) * 3 * kDimHead * 4;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Scores and dA of one 16-row tile (A fragments a_s, a_d: two k16 steps of
// dh = 32) against the 16 rows at `rows_b` of the B operands (b_s, b_d,
// stored [row][dim], read as the n side): s = a_s . b_s, da = a_d . b_d.
__device__ __forceinline__ void tile_products(const unsigned (&a_s)[2][4],
                                              const unsigned (&a_d)[2][4], const bf16* b_s,
                                              const bf16* b_d, int n_off, float (&s)[2][4],
                                              float (&da)[2][4]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = da[nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    unsigned f[4];
    ldsm_x4(f, smem_u32(b_s + n_off + kk * 16));
    mma_bf16(s[0], a_s[kk], f[0], f[1]);
    mma_bf16(s[1], a_s[kk], f[2], f[3]);
    ldsm_x4(f, smem_u32(b_d + n_off + kk * 16));
    mma_bf16(da[0], a_d[kk], f[0], f[1]);
    mma_bf16(da[1], a_d[kk], f[2], f[3]);
  }
}

// acc (16 x 32, four n8 blocks) += P (16 x 16, A fragment) @ B rows
// [row0, row0 + 16) x 32 (stored [row][dim], read with .trans)
__device__ __forceinline__ void pv_product(const unsigned (&p)[4], const bf16* b, int a_off,
                                           float (&acc)[4][4]) {
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    unsigned f[4];
    ldsm_x4_trans(f, smem_u32(b + a_off + d * 16));
    mma_bf16(acc[2 * d], p, f[0], f[1]);
    mma_bf16(acc[2 * d + 1], p, f[2], f[3]);
  }
}

// One block per (sequence, head), L <= 256, dh = 32, on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), up to 8 warps: the block
// needs ~127 KB of shared memory at L = 243, so it is alone on its SM, and
// its warps are all the SM has to hide latency with.
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
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ datt,
                     bf16* __restrict__ dqkv16, float* __restrict__ part, int L, SeqRows sr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (L + 15) / 16 * 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * kLdA;
  bf16* vs = ks + rows * kLdA;
  bf16* dos = vs + rows * kLdA;
  bf16* rqs = dos + rows * kLdA;
  bf16* rdos = rqs + rows * kLdA;
  float* cs = reinterpret_cast<float*>(rdos + rows * kLdA);
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
    if (r < L) {
      const long long row = base + r * sr.step;
      const bf16* src = qkv + row * kQkv + hq + c;
      copy16(qs + r * kLdA + c, src);
      copy16(ks + r * kLdA + c, src + kDim);
      copy16(vs + r * kLdA + c, src + 2 * kDim);
      float t[8];
      load8f(datt + row * kDim + hq + c, t);
      store8(dos + r * kLdA + c, t);
    } else {
      bf16* const bufs[6] = {qs, ks, vs, dos, rqs, rdos};
#pragma unroll
      for (int b = 0; b < 6; ++b) *reinterpret_cast<uint4*>(bufs[b] + r * kLdA + c) = zero16;
    }
  }
  __syncthreads();

  const int g = lane / 4;
  const int q4 = lane % 4;
  const int a_off = (lane % 16) * kLdA + (lane / 16) * 8;
  const int n_off = ((lane / 16) * 8 + lane % 8) * kLdA + ((lane / 8) % 2) * 8;
  // this lane's column sums: columns nb * 8 + 2 q4 (+ 1) over its rows
  float cq[4][2] = {}, ck[4][2] = {}, cv[4][2] = {};

  for (int qt = warp; qt < rows / 16; qt += n_warps) {
    unsigned qa[2][4], da_a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldsm_x4(qa[kk], smem_u32(qs + qt * 16 * kLdA + a_off + kk * 16));
      ldsm_x4(da_a[kk], smem_u32(dos + qt * 16 * kLdA + a_off + kk * 16));
    }
    float sum_e[2] = {0.f, 0.f}, sum_t[2] = {0.f, 0.f};
    for (int kb = 0; kb < rows / 16; ++kb) {
      float s[2][4], da[2][4];
      tile_products(qa, da_a, ks + kb * 16 * kLdA, vs + kb * 16 * kLdA, n_off, s, da);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb * 16 + nb * 8 + 2 * q4 + (i & 1);
          const float e = key < L ? expf(fminf(s[nb][i] * kAttnScale, kScoreClamp)) : 0.f;
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
      tile_products(qa, da_a, ks + kb * 16 * kLdA, vs + kb * 16 * kLdA, n_off, s, da);
      unsigned p[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb * 16 + nb * 8 + 2 * q4 + (i & 1);
          const float e = key < L ? expf(fminf(s[nb][i] * kAttnScale, kScoreClamp)) : 0.f;
          ds[i] = __fsub_rn(__fmul_rn(da[nb][i], e), __fmul_rn(c[i / 2], e));
        }
        p[2 * nb] = pack_bf16x2(ds[0], ds[1]);
        p[2 * nb + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      pv_product(p, ks + kb * 16 * kLdA, a_off, dq);
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
        const float2 qv = load2(qs + row_i * kLdA + col);
        store2(rqs + row_i * kLdA + col, rb * qv.x, rb * qv.y);
        const float2 dv = *reinterpret_cast<const float2*>(datt + row * kDim + hq + col);
        store2(rdos + row_i * kLdA + col, r[h] * dv.x, r[h] * dv.y);
      }
      if (q4 == 0) cs[row_i] = c[h];
    }
  }
  __syncthreads();

  for (int kt = warp; kt < rows / 16; kt += n_warps) {
    unsigned ka[2][4], va[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldsm_x4(ka[kk], smem_u32(ks + kt * 16 * kLdA + a_off + kk * 16));
      ldsm_x4(va[kk], smem_u32(vs + kt * 16 * kLdA + a_off + kk * 16));
    }
    float dk[4][4] = {}, dv[4][4] = {};
    for (int qb = 0; qb < rows / 16; ++qb) {
      float s[2][4], da[2][4];  // rows: keys of this tile; columns: queries
      tile_products(ka, va, qs + qb * 16 * kLdA, dos + qb * 16 * kLdA, n_off, s, da);
      unsigned pe[4], pds[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float e[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int query = qb * 16 + nb * 8 + 2 * q4 + (i & 1);
          e[i] = query < L ? expf(fminf(s[nb][i] * kAttnScale, kScoreClamp)) : 0.f;
          ds[i] = query < L ? __fsub_rn(__fmul_rn(da[nb][i], e[i]), __fmul_rn(cs[query], e[i]))
                            : 0.f;
        }
        pe[2 * nb] = pack_bf16x2(e[0], e[1]);
        pe[2 * nb + 1] = pack_bf16x2(e[2], e[3]);
        pds[2 * nb] = pack_bf16x2(ds[0], ds[1]);
        pds[2 * nb + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      pv_product(pe, rdos + qb * 16 * kLdA, a_off, dv);
      pv_product(pds, rqs + qb * 16 * kLdA, a_off, dk);
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

// The workspace, carved in this order, each region 256-byte aligned. The
// column partials hold, in turn, db1's, LN_2's, db_qkv's (per sequence) and
// LN_1's (per 128-row tile).
struct Workspace {
  bf16 *y, *y2, *qkv, *hg, *dh, *dx1b, *dqkvb;
  float *dx1, *datt, *part, *colpart;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

size_t col_part_floats(size_t rows, size_t n_seq) {
  const size_t mlp = (rows + kMlpBM - 1) / kMlpBM * kMlp;
  const size_t ln = (rows + kLnBM - 1) / kLnBM * 4 * kDim;
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
// workspace: stblock_train_bwd_workspace(rows, L) bytes, 256-byte aligned.
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
      static_cast<long long>(n_outer) * L * per_outer > (1 << 26) ||
      attn_bwd_smem(L) > size_t(kSmemLimit) || L > kBwdMaxLen)
    return cudaErrorInvalidValue;
  const int rows = n_outer * L * per_outer;
  if (rows == 0) return cudaSuccess;
  const int n_seq = n_outer * per_outer;
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* x1b = static_cast<const bf16*>(x1);
  const bf16* attb = static_cast<const bf16*>(att);
  const bf16* doutb = static_cast<const bf16*>(dout);
  const bf16* w = static_cast<const bf16*>(weights);
  float* g = static_cast<float*>(dw);
  Workspace ws;
  carve(&ws, static_cast<unsigned char*>(workspace), rows, n_seq);
  const int row_blocks = (rows + kRowWarps - 1) / kRowWarps;
  const int ln_tiles = (rows + kLnBM - 1) / kLnBM;

  // recompute: y, y2, qkv
  ln_rows_kernel<<<row_blocks, kRowWarps * 32, 0, s>>>(xb, w + kOffLn1G, w + kOffLn1B, ws.y, rows);
  POSE3D_TRY(cudaGetLastError());
  ln_rows_kernel<<<row_blocks, kRowWarps * 32, 0, s>>>(x1b, w + kOffLn2G, w + kOffLn2B, ws.y2,
                                                       rows);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY((gemm<false, false, kEpiBiasBf16>(
      {ws.y, w + kOffWQkv, rows, kQkv, kDim, kDim, kQkv, kDim, nullptr, ws.qkv, kQkv, 0,
       w + kOffBQkv}, 1, s)));

  // MLP half: hg and dh with db1's partials, then dy2 = dh W1^T with LN_2's
  // backward: dx1 (f32 and bf16); dbp, dg2, db2, db2f
  POSE3D_TRY(set_smem(mlp_bwd_kernel, kMlpSmem));
  const int mlp_tiles = (rows + kMlpBM - 1) / kMlpBM;
  mlp_bwd_kernel<<<mlp_tiles, kMlpThreads, kMlpSmem, s>>>(
      ws.y2, doutb, w + kOffW1, w + kOffB1, w + kOffW2, ws.hg, ws.dh, ws.colpart, rows);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY(sum_slices(ws.colpart, mlp_tiles, kMlp, kMlp, g + kOffB1, s));
  POSE3D_TRY(set_smem(ln_gemm_kernel<true>, kLnSmemAll));
  ln_gemm_kernel<true><<<ln_tiles, kLnThreads, kLnSmemAll, s>>>(
      ws.dh, w + kOffW1, kMlp, x1b, w + kOffLn2G, doutb, ws.dx1, ws.dx1b, ws.colpart, rows);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY(sum_slices(ws.colpart, ln_tiles, 4 * kDim, 3 * kDim, g + kOffBProj, s));
  POSE3D_TRY(sum_slices(ws.colpart + 3 * kDim, ln_tiles, 4 * kDim, kDim, g + kOffB2, s));
  POSE3D_TRY(weight_grad(ws.hg, kMlp, doutb, kDim, rows, ws.part, g + kOffW2, s));
  POSE3D_TRY(weight_grad(ws.y2, kDim, ws.dh, kMlp, rows, ws.part, g + kOffW1, s));
  POSE3D_TRY(weight_grad(attb, kDim, ws.dx1b, kDim, rows, ws.part, g + kOffWProj, s));

  // attention half
  POSE3D_TRY((gemm<false, true, kEpiF32>(  // datt = bf16(dx1) Wp^T
      {ws.dx1b, w + kOffWProj, rows, kDim, kDim, kDim, kDim, kDim, ws.datt, nullptr, kDim, 0,
       nullptr}, 1, s)));
  // sequence s, token t: row (s / inner_n) outer + (s % inner_n) inner + t step
  const SeqRows sr = layout == kSlab
                         ? SeqRows{static_cast<long long>(L) * kJoints, 1, kJoints, kJoints}
                         : SeqRows{L, 0, 1, 1};
  const size_t smem = attn_bwd_smem(L);
  POSE3D_TRY(set_smem(attention_bwd_kernel, smem));
  const int warps = min(kBwdWarps, (L + 15) / 16);  // one 16-row tile per warp and pass
  attention_bwd_kernel<<<dim3(n_seq, kHeads), warps * 32, smem, s>>>(
      ws.qkv, ws.datt, ws.dqkvb, ws.colpart, L, sr);
  POSE3D_TRY(cudaGetLastError());
  POSE3D_TRY(sum_slices(ws.colpart, n_seq, kQkv, kQkv, g + kOffBQkv, s));
  POSE3D_TRY(weight_grad(ws.y, kDim, ws.dqkvb, kQkv, rows, ws.part, g + kOffWQkv, s));
  // dy = bf16(dqkv) W_qkv^T with LN_1's backward: dx; dg1, db1
  POSE3D_TRY(set_smem(ln_gemm_kernel<false>, kLnSmemAll));
  ln_gemm_kernel<false><<<ln_tiles, kLnThreads, kLnSmemAll, s>>>(
      ws.dqkvb, w + kOffWQkv, kQkv, xb, w + kOffLn1G, ws.dx1, nullptr, static_cast<bf16*>(dx),
      ws.colpart, rows);
  POSE3D_TRY(cudaGetLastError());
  return sum_slices(ws.colpart, ln_tiles, 2 * kDim, 2 * kDim, g + kOffLn1G, s);
}
