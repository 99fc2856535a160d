// The fused Martinez residual block for Hopper (sm_90a):
//   h   = bf16(relu(s1 * (x @ W1) + b1))
//   out = bf16(f32(x) + relu(s2 * (h @ W2) + b2))
// on (B, 1024) bf16 rows; W1, W2 (1024, 1024) bf16 in flax's (in, out)
// layout, row-major; s, b f32 (1024,), BatchNorm folded; products
// accumulate in f32. Rounding as in the JAX kernel: h to bf16, the second
// product's activation in f32, one rounding after the residual add.
// Inference only, as the JAX kernel.
//
// Replaces pose3d_tpu/ops/pallas_martinez.py:34 _block_kernel (via
// fused_residual_block :45, entry martinez_infer_fused :120).
//
// What bounds it on this card. 4 * 1024^2 flops per row against 4 KB of
// rows in and out: ~1,000 flops per byte of HBM, far above the H100's ~295
// bf16 flops per byte, so the tensor cores bound it (34.4 GFLOP, 0.035 ms
// at B = 8192).
//
// Why not the TPU's design. The TPU kernel keeps both 2 MB weight matrices
// and its tile's intermediate in VMEM. An SM's 227 KB of shared memory
// holds neither matrix, and a row-tile kernel that streams all 4 MB of
// weights through every tile (the lifter trunk's first design) is bounded by
// that L2 stream: ~1 GB per block call at B = 8192 with 32-row tiles.
//
// The design: two output-stationary tiled GEMMs per block, one launch
// each: (1) GEMM 1 + scale/shift + ReLU into a bf16 h scratch that the
// wrapper allocates, which is exact, since the JAX kernel rounds h to bf16
// at that very point; (2) GEMM 2 + scale/shift + ReLU + the f32 residual
// add. A CTA of 4 warps (2 x 2, 64 x 64 outputs each, 128 f32
// accumulators a thread) computes a 128 x 128 output tile over K = 1024 in
// slices of 32, two CTAs to an SM: a kStages-deep cp.async ring holds both
// operands' slices, ldmatrix feeds mma.sync m16n8k16 (bf16 in, f32
// accumulate). Per slice a CTA reads 16 KB for 1 MFLOP, 64 flops per byte
// of L2. (128 x 256 tiles of 8 warps, and K slices of 64, were no faster
// on the H100.) The 8 column tiles of a row tile are neighbours in the grid,
// so a row tile is read from HBM about once; both weight matrices stay in
// the 50 MB L2. Rows past B in the last row tile repeat row B - 1 and are
// not stored. The epilogue multiplies and adds without FMA contraction,
// as the plain version's separate multiply and add round, and goes
// through shared memory: the output tile (and for GEMM 2 the residual
// tile, loaded there first) sits in the ring's space, so that global
// memory is read and written in whole 16-byte runs.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace pose3d;

constexpr int kWidth = 1024;  // F: the row width and both sides of W1, W2
constexpr int kBM = 128;      // rows of an output tile
constexpr int kBN = 128;      // columns of an output tile
constexpr int kBK = 32;       // K per pipeline slice
constexpr int kStages = 4;    // slices in the cp.async ring
constexpr int kGemmWarpsM = 2;
constexpr int kGemmWarpsN = 2;
constexpr int kGemmThreads = 32 * kGemmWarpsM * kGemmWarpsN;
constexpr int kWarpRows = kBM / kGemmWarpsM;  // 64
constexpr int kWarpCols = kBN / kGemmWarpsN;  // 64
constexpr int kFragM = kWarpRows / 16;        // m16 tiles per warp
constexpr int kFragN = kWarpCols / 8;         // n8 tiles per warp
// shared-memory row pitches in bf16 elements: 16 bytes of skew per row
// keep the 8 rows of an ldmatrix on distinct banks
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kBN + 8;
constexpr int kSliceA = kBM * kLdA;  // A (rows x K) slice, then W (K x columns)
constexpr int kSliceElems = kSliceA + kBK * kLdB;
constexpr int kLdOut = kBN + 8;  // the epilogue's output tile, over the ring
constexpr size_t kSmemBytes = size_t(kStages) * kSliceElems * sizeof(bf16);
constexpr int kKSlices = kWidth / kBK;
constexpr int kCopiesA = kBM * (kBK / 8) / kGemmThreads;  // 16-byte copies per thread
constexpr int kCopiesB = kBK * (kBN / 8) / kGemmThreads;
constexpr int kCopiesOut = kBM * (kBN / 8) / kGemmThreads;
constexpr int kMaxRows = 65535 * kBM;  // gridDim.y's limit

static_assert(kSmemBytes <= kSmemLimit, "exceeds the per-block shared memory");
static_assert((kSliceA * sizeof(bf16)) % 16 == 0 && (kSliceElems * sizeof(bf16)) % 128 == 0,
              "slice alignment");
static_assert(kCopiesA * kGemmThreads == kBM * (kBK / 8) &&
                  kCopiesB * kGemmThreads == kBK * (kBN / 8),
              "whole copies per thread");
static_assert(kWidth % kBN == 0 && kWidth % kBK == 0 && kFragN % 2 == 0, "tiling");
static_assert(size_t(kBM) * kLdOut * sizeof(bf16) <= kSmemBytes &&
                  kCopiesOut * kGemmThreads == kBM * (kBN / 8),
              "the output tile fits over the ring");

// Starts the cp.async copies of K slice [k0, k0 + kBK): A rows [row0,
// row0 + kBM) (past the last row: the last row again) and W rows
// [k0, k0 + kBK) x columns [col0, col0 + kBN).
__device__ __forceinline__ void load_slice(bf16* slice, const bf16* __restrict__ a,
                                           const bf16* __restrict__ w, int row0, int n_rows,
                                           int col0, int k0) {
#pragma unroll
  for (int j = 0; j < kCopiesA; ++j) {
    const int i = threadIdx.x + j * kGemmThreads;
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    const int row = min(row0 + r, n_rows - 1);
    cp_async16(slice + r * kLdA + c, a + size_t(row) * kWidth + k0 + c);
  }
  bf16* ws = slice + kSliceA;
#pragma unroll
  for (int j = 0; j < kCopiesB; ++j) {
    const int i = threadIdx.x + j * kGemmThreads;
    const int r = i / (kBN / 8);
    const int c = (i % (kBN / 8)) * 8;
    cp_async16(ws + r * kLdB + c, w + size_t(k0 + r) * kWidth + col0 + c);
  }
}

// out = bf16(relu(scale * (a @ w) + shift)), or with kResidual
// out = bf16(f32(residual) + relu(scale * (a @ w) + shift)); one CTA per
// kBM x kBN output tile, blockIdx.x the column tile.
template <bool kResidual>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_bn_relu_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    const bf16* __restrict__ residual, bf16* __restrict__ out, int n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kGemmWarpsN;
  const int wn = warp % kGemmWarpsN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  for (int s = 0; s < kStages - 1; ++s) {
    load_slice(ring + s * kSliceElems, a, w, row0, n_rows, col0, s * kBK);
    cp_async_commit();
  }

  float acc[kFragM][kFragN][4];
#pragma unroll
  for (int m = 0; m < kFragM; ++m)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // ldmatrix row addresses of this lane, in bytes from a slice's A and W
  // parts: A rows lane % 16 (+ 16 m) at k offset (lane / 16) * 8; W rows
  // lane % 16 at column offset (lane / 16) * 8 (+ 16 h), read with .trans
  const unsigned a_lane = ((wm * kWarpRows + lane % 16) * kLdA + (lane / 16) * 8) * 2;
  const unsigned w_lane = ((lane % 16) * kLdB + wn * kWarpCols + (lane / 16) * 8) * 2;
  for (int ks = 0; ks < kKSlices; ++ks) {
    // slice ks has landed for every thread; every thread is done with
    // slice ks - 1, whose slot the next copies overwrite
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = ks + kStages - 1;
    if (next < kKSlices)
      load_slice(ring + (next % kStages) * kSliceElems, a, w, row0, n_rows, col0, next * kBK);
    cp_async_commit();  // an empty group past the end keeps the count

    const unsigned as = smem_u32(ring + (ks % kStages) * kSliceElems);
    const unsigned ws = as + kSliceA * 2;
#pragma unroll
    for (int u = 0; u < kBK / 16; ++u) {
      unsigned b[kFragN / 2][4];  // [16-column pair h][b0, b1 of n8 tile 2h, of 2h + 1]
#pragma unroll
      for (int h = 0; h < kFragN / 2; ++h)
        ldsm_x4_trans(b[h], ws + w_lane + (u * 16 * kLdB + h * 16) * 2);
#pragma unroll
      for (int m = 0; m < kFragM; ++m) {
        unsigned af[4];
        ldsm_x4(af, as + a_lane + (m * 16 * kLdA + u * 16) * 2);
#pragma unroll
        for (int n = 0; n < kFragN; ++n)
          mma_bf16(acc[m][n], af, b[n / 2][(n % 2) * 2], b[n / 2][(n % 2) * 2 + 1]);
      }
    }
  }

  // The ring is free once every thread is past its last slice; the output
  // tile (kBM x kLdOut) takes its place, for GEMM 2 loaded with the
  // residual tile first.
  cp_async_wait<0>();
  __syncthreads();
  bf16* tile = ring;
  if constexpr (kResidual) {
#pragma unroll
    for (int j = 0; j < kCopiesOut; ++j) {
      const int i = threadIdx.x + j * kGemmThreads;
      const int r = i / (kBN / 8);
      const int c = (i % (kBN / 8)) * 8;
      const int row = min(row0 + r, n_rows - 1);
      cp_async16(tile + r * kLdOut + c, residual + size_t(row) * kWidth + col0 + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // m16n8 accumulators: (row g, columns 2q, 2q + 1) and (row g + 8, ...);
  // each thread rewrites only the tile elements of its own accumulators
  const int g = lane / 4;
  const int q = lane % 4;
#pragma unroll
  for (int n = 0; n < kFragN; ++n) {
    const int c = wn * kWarpCols + n * 8 + 2 * q;
    const float2 sc = *reinterpret_cast<const float2*>(scale + col0 + c);
    const float2 sh = *reinterpret_cast<const float2*>(shift + col0 + c);
#pragma unroll
    for (int m = 0; m < kFragM; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bf16* at = tile + (wm * kWarpRows + m * 16 + g + half * 8) * kLdOut + c;
        float v0 = fmaxf(__fadd_rn(__fmul_rn(acc[m][n][2 * half], sc.x), sh.x), 0.f);
        float v1 = fmaxf(__fadd_rn(__fmul_rn(acc[m][n][2 * half + 1], sc.y), sh.y), 0.f);
        if constexpr (kResidual) {
          const float2 r = load2(at);
          v0 = __fadd_rn(r.x, v0);
          v1 = __fadd_rn(r.y, v1);
        }
        store2(at, v0, v1);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCopiesOut; ++j) {
    const int i = threadIdx.x + j * kGemmThreads;
    const int r = i / (kBN / 8);
    const int c = (i % (kBN / 8)) * 8;
    if (row0 + r < n_rows)
      copy16(out + size_t(row0 + r) * kWidth + col0 + c, tile + r * kLdOut + c);
  }
}

template <bool kResidual>
cudaError_t launch_gemm(const bf16* a, const bf16* w, const float* scale, const float* shift,
                        const bf16* residual, bf16* out, int n_rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bn_relu_kernel<kResidual>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(kWidth / kBN, (n_rows + kBM - 1) / kBM);
  gemm_bn_relu_kernel<kResidual><<<grid, kGemmThreads, kSmemBytes, stream>>>(
      a, w, scale, shift, residual, out, n_rows);
  return cudaGetLastError();
}

}  // namespace

// x, h, out: (n_rows, 1024) bf16, h a scratch; w1, w2: (1024, 1024) bf16,
// (in, out) row-major; s1, b1, s2, b2: (1024,) f32. Every pointer starts on
// a 16-byte boundary. width is the caller's idea of the kernel's row width:
// a mismatch returns cudaErrorInvalidValue. Two launches in a row; the
// first error ends the sequence and is returned. Launches on the calling
// thread's current device, which must hold the operands.
extern "C" cudaError_t martinez_launch(const void* x, const void* w1, const void* s1,
                                       const void* b1, const void* w2, const void* s2,
                                       const void* b2, void* h, void* out, int n_rows,
                                       int width, void* stream) {
  if (n_rows < 0 || n_rows > kMaxRows || width != kWidth) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(h);
  cudaError_t err = launch_gemm<false>(xb, static_cast<const bf16*>(w1),
                                       static_cast<const float*>(s1),
                                       static_cast<const float*>(b1), nullptr, hb, n_rows, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<true>(hb, static_cast<const bf16*>(w2), static_cast<const float*>(s2),
                           static_cast<const float*>(b2), xb, static_cast<bf16*>(out),
                           n_rows, s);
}
