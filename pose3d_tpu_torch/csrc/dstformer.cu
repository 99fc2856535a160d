// DSTformer's sub-blocks at their published widths for Hopper (sm_90a):
// one pre-LN sub-block of MotionBERT's DSTformer (dim 512, 8 heads x 64,
// MLP ratio 2, LayerNorm eps 1e-6), spatial or temporal, on frame-major
// (clip, frame, joint) bf16 rows, as five launches:
//   1. ln_qkv:        qkv = bf16(bf16(LN_1(x)) Wqkv^T + bqkv)        (rows, 1536)
//   2. attention:     o   = MHSA over the joints of a frame (spatial) or
//                           the frames of a joint (temporal)        (rows, 512)
//   3. proj_residual: x1  = bf16(x + (o Wproj^T + bproj))
//   4. ln_fc1_gelu:   h   = bf16(gelu(bf16(LN_2(x1)) W1^T + b1))    (rows, 1024)
//   5. fc2_residual:  out = bf16(x1 + (h W2^T + b2))
// Weights are the nn.Linear parameters as they lie, (out, in) row-major
// bf16; LayerNorm scales and biases bf16. Inference only.
//
// Replaces no TPU kernel: the JAX package has no DSTformer. It was added
// because the module route ran each sub-block as PyTorch matmuls with
// LayerNorm, bias, GELU, the residual adds and the frame/joint-major
// transposes as PyTorch passes of their own over 512-wide rows, about 46%
// of the motionbert.video cell's device time.
//
// What bounds it on this card: operations, only just. A row takes 4.19
// MFLOP of products (2 x 512 x (1536 + 512 + 1024 + 1024)); at 16 clips
// (66,096 rows) that is 277 GFLOP of products, 0.280 ms at 989 TFLOP/s, and
// the attention adds 0.6 (spatial) or 8.5 MFLOP a row. The launches move,
// per row, 1 KB in and 3 KB out (ln_qkv), 3 + 1 KB (attention), 2 + 1 KB
// (proj_residual), 1 + 2 KB (ln_fc1_gelu), 3 + 1 KB (fc2_residual): 17 KB,
// 1.12 GB at 16 clips, 0.335 ms at 3.35 TB/s. The products run at or above
// the card's ~295 flops a byte in ln_qkv and ln_fc1_gelu and below it in
// proj_residual and fc2_residual: no launch can leave its loads and stores
// exposed, and there is no HBM pass of its own for a LayerNorm, a bias, the
// GELU, a residual or a layout.
//
// Why not the 256-wide engine of subblock_sm90.cuh, which runs whole
// sub-blocks in 128-row tiles: at width 512 a 128 x 512 f32 accumulator is
// the whole register file, and the projection's input tile and x1 at 128 x
// 512 bf16 are 128 KB each. So the products stay GEMM-shaped and the passes
// go into their prologues and epilogues.
//
// The design: launches 1, 3, 4 and 5 are one persistent GEMM template
// (gemm_kernel) on rowtile_sm90.cuh's primitives, one CTA an SM, three
// warpgroups:
// - A resident A tile: 128 KB of shared memory holds a tile's whole rows,
//   128 rows of K = 512 (launches 1, 3, 4) or 64 rows of K = 1024 (launch
//   5), loaded by TMA (128-byte swizzle, K-major) and used for every output
//   column. Launches 1 and 4 normalise it in place before the first
//   product: eight threads a row, the row in registers, f32 statistics in
//   two passes, bf16(gamma (rstd (x - mean)) + beta) written back, so the
//   LayerNorm's output exists only in shared memory, rounded to bf16 as
//   the module route rounds it.
// - The producer warpgroup (setmaxnreg down) has one thread stream the
//   weights in 64 x 128 chunks (16 KB, K-major boxes of the (out, in)
//   matrix: wgmma takes B K-major, so no transposed copy exists) through a
//   ring of mbarrier-guarded stages, and the next tile's A once both
//   consumers' products of the last one have completed; the first chunks
//   of the next tile load beside it.
// - Two consumer warpgroups take the tile's 128-column output chunks in
//   turns (even, odd), each a whole kRows x 128 chunk (m64n128k16, two
//   64-row halves at K = 512: 128 f32 accumulators a thread). A pair of
//   named barriers orders their products: a warpgroup issues its chunk's
//   products once the other has issued its own, so that one warpgroup's
//   epilogue runs under the other's products. K is only 512 or 1024 (32 or
//   64 wgmmas a chunk), so an exposed epilogue would cost a large share.
// - The epilogue runs in the accumulator registers, in f32: + bias (from
//   shared memory), then the GELU (exact erf, as PyTorch's) or + the
//   residual (its bf16 pairs read in the accumulator's layout, prefetched
//   into L2 when the chunk's products start), then one rounding to bf16;
//   four lanes of a quad exchange their words (a 4 x 4 transpose by two
//   rounds of shuffles) so that each holds 8 consecutive columns of one
//   row, and store 16 bytes. Rows past the end are neither read nor
//   written; TMA fills them with zeros in the A tile.
// Launch 2 is attention.cu's launch_attention (rows 3-4 of the kernel
// table) at head width 64 on the same rows: the spatial sub-block's
// sequences are 17 contiguous rows (attention_kernel), the temporal one's
// each joint's frames in place, 17 rows apart (attention_wg_kernel through
// its 4-D TMA map, the SeqLayout of the temporal slab), so neither layout
// is ever transposed.
//
// Rounding points: each LayerNorm's output and each launch's output, in
// bf16. That is the module route's (nn.LayerNorm, F.linear with its bias,
// F.gelu and the residual adds, each rounding to bf16) less three: the
// fc1 product's before the GELU, and the proj and fc2 products' before
// their residual adds. Fewer roundings bring the answer nearer the f32
// model's: on the motionbert.video seed with the widest gap found, the
// cell's widest gap reads 0.150 with these roundings and 0.169 with the
// module route's (the plain versions, bf16 on an H100); rms ~7% lower. The
// plain versions in ops/dstformer.py round at the same points. No atomics:
// two calls are bitwise equal.
//
// The launchers encode the TMA maps on the host per call and pass them as
// __grid_constant__ parameters, run on the caller's stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include "attention.cuh"
#include "rowtile_sm90.cuh"

namespace {

using pose3d::bf16;
using pose3d::smem_u32;
namespace rt = pose3d::rowtile;

constexpr int kWidth = 512;       // C: the rows' width
constexpr int kHeads = 8;
constexpr int kHeadDim = kWidth / kHeads;
constexpr int kQkvCols = 3 * kWidth;
constexpr int kHidden = 2 * kWidth;  // the MLP's width (ratio 2)
constexpr float kEps = 1e-6f;        // MotionBERT's LayerNorm eps
constexpr int kChunkN = 128;         // output columns of a consumer's chunk
constexpr int kStageBytes = 64 * kChunkN * 2;  // a 64 (K) x 128 (N) weight chunk: 16 KB
constexpr int kABytes = 128 * 1024;  // the resident A tile
constexpr int kMaxRows = 1 << 24;
constexpr int kOrderBar = 4;  // named barriers kOrderBar + wg: "your turn to issue"
constexpr int kBarBytes = 256;

enum class Epi { kBias, kGelu, kResidual };

// The plan of one launch: K (the A tile's width) and N (the output's).
template <int kK, int kN>
struct Plan {
  static constexpr int kRows = kABytes / (2 * kK);  // 128 at K = 512, 64 at K = 1024
  static constexpr int kSub = kRows / rt::kWgRows;  // 64-row halves of a chunk's product
  static constexpr int kKBlocks = kK / rt::kBox;    // 64-column blocks of A: weight chunks a job
  static constexpr int kKBlockBytes = kRows * 128;  // one TMA box of A
  static constexpr int kJobs = kN / kChunkN;        // output chunks a tile
  static constexpr int kBiasBytes = kN * 4;
  static constexpr int kStages =
      (pose3d::kSmemLimit - 1024 - kABytes - kBiasBytes - kBarBytes) / kStageBytes;
  static constexpr size_t kSmem =
      1024 + size_t(kABytes) + size_t(kStages) * kStageBytes + kBiasBytes + kBarBytes;
  static_assert(kJobs % rt::kConsumers == 0, "the consumers take a tile's chunks in turns");
  static_assert(kStages >= 4 && kSmem <= size_t(pose3d::kSmemLimit), "shared memory");
  static_assert(16 * kStages + 16 <= kBarBytes, "the barriers fit");
};
static_assert(Plan<512, kQkvCols>::kStages == 5 && Plan<1024, kWidth>::kStages == 5 &&
                  Plan<512, kWidth>::kRows == 128 && Plan<1024, kWidth>::kRows == 64,
              "the note's plan");

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ unsigned pack(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ float2 unpack(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// PyTorch's exact GELU on CUDA: x * 0.5 * (1 + erf(x * sqrt(1/2))), in f32.
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752440f));
}

// A 4 x 4 transpose of 32-bit words across the four lanes of a quad: lane q
// holds w[u] = M[q][u] and ends with w[u] = M[u][q]. Two rounds, each
// exchanging the half of the words whose index bit differs from the lane's.
__device__ __forceinline__ void quad_transpose(unsigned (&w)[4], int q) {
#pragma unroll
  for (int bit = 2; bit > 0; bit >>= 1) {
    const bool hi = q & bit;
    const int i1 = bit == 2 ? 1 : 2;  // the word indices with the bit clear: 0 and i1
    const unsigned s0 = hi ? w[0] : w[bit], s1 = hi ? w[i1] : w[i1 + bit];
    const unsigned r0 = __shfl_xor_sync(0xffffffffu, s0, bit);
    const unsigned r1 = __shfl_xor_sync(0xffffffffu, s1, bit);
    if (hi) {
      w[0] = r0;
      w[i1] = r1;
    } else {
      w[bit] = r0;
      w[i1 + bit] = r1;
    }
  }
}

// LayerNorm of a 128 x 512 A tile in place, by one warpgroup: eight
// threads a row (thread c8 holds 16-byte chunk c8 of every 64-column
// block, a conflict-free phase of the swizzle), sixteen rows a pass.
__device__ __forceinline__ void layer_norm_tile(unsigned char* a, const bf16* __restrict__ gamma,
                                                const bf16* __restrict__ beta, int t) {
  constexpr int kBlocks = kWidth / rt::kBox;
  constexpr int kBlockBytes = 128 * 128;
  const int c8 = t % 8;
#pragma unroll 1
  for (int r = t / 8; r < 128; r += 16) {
    float v[kBlocks][8];
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb)
      pose3d::load8(reinterpret_cast<const bf16*>(a + kb * kBlockBytes + rt::swz(r, c8)), v[kb]);
    float sum = 0.f;
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[kb][e];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const float mean = sum * (1.f / kWidth);
    float sq = 0.f;
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[kb][e] - mean;
        sq += d * d;
      }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    sq += __shfl_xor_sync(0xffffffffu, sq, 4);
    const float rstd = rsqrtf(sq * (1.f / kWidth) + kEps);
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb) {
      float g[8], b[8];
      pose3d::load8(gamma + kb * rt::kBox + c8 * 8, g);
      pose3d::load8(beta + kb * rt::kBox + c8 * 8, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[kb][e] = g[e] * (rstd * (v[kb][e] - mean)) + b[e];
      pose3d::store8(reinterpret_cast<bf16*>(a + kb * kBlockBytes + rt::swz(r, c8)), v[kb]);
    }
  }
}

// out (n_rows, kN) = epilogue(A W^T + bias) on the rows of A (n_rows, kK),
// through a_map (boxes of 64 columns x kRows rows) and w_map (the (kN, kK)
// weight, boxes of 64 x 128); kLn normalises each A tile first (gamma,
// beta); kEpi adds the bias alone, applies the GELU, or adds res (n_rows,
// kN). Tile t of a persistent CTA's walk (blockIdx.x, + gridDim.x, ...) is
// rows [t kRows, (t + 1) kRows), every column.
template <int kK, int kN, bool kLn, Epi kEpi>
__global__ void __launch_bounds__(rt::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
            const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
            const bf16* __restrict__ bias, const bf16* __restrict__ res, bf16* __restrict__ out,
            int n_rows) {
  using P = Plan<kK, kN>;
  static_assert(!kLn || kK == kWidth, "a LayerNorm prologue normalises 512-wide rows");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* a_p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_p = a_p + kABytes;
  float* bias_s = reinterpret_cast<float*>(ring_p + P::kStages * kStageBytes);
  const uint32_t bars = smem_u32(bias_s + kN);
  const uint32_t a_full = bars + 16 * P::kStages, a_empty = a_full + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      rt::mbar_init(bars + 8 * s, 1);                  // full: the producer's arrival
      rt::mbar_init(bars + 8 * (P::kStages + s), 1);  // empty: the one consumer of the chunk
    }
    rt::mbar_init(a_full, 1);
    rt::mbar_init(a_empty, rt::kConsumers);
    rt::mbar_fence_init();
  }
  for (int c = threadIdx.x; c < kN; c += blockDim.x) bias_s[c] = __bfloat162float(bias[c]);
  __syncthreads();

  const int n_tiles = (n_rows + P::kRows - 1) / P::kRows;
  const int wg = threadIdx.x / 128;
  const uint32_t a_s = smem_u32(a_p);
  rt::Ring<P::kStages, kStageBytes> ring{smem_u32(ring_p), bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      constexpr int kAAfter = (P::kStages < P::kKBlocks ? P::kStages : P::kKBlocks) - 1;
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        for (int c = 0; c < P::kJobs; ++c)
          for (int kb = 0; kb < P::kKBlocks; ++kb) {
            uint32_t bar;
            const uint32_t dst = ring.claim(&bar);
            rt::tma_load(dst, &w_map, bar, kb * rt::kBox, c * kChunkN);
            if (c == 0 && kb == kAAfter) {
              // the tile's A, once both consumers' products of the last
              // tile have completed; its first weight chunks are in flight
              rt::mbar_wait(a_empty, (it & 1) ^ 1);
              rt::mbar_expect_tx(a_full, kABytes);
              for (int k = 0; k < P::kKBlocks; ++k)
                rt::tma_load(a_s + k * P::kKBlockBytes, &a_map, a_full, k * rt::kBox,
                             t * P::kRows);
            }
          }
      }
    }
    return;
  }

  rt::regs_inc<rt::kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int tid = threadIdx.x % 128;
  const int my_tiles =
      n_tiles > int(blockIdx.x) ? (n_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1 : 0;
  const int n_jobs = my_tiles * P::kJobs;
  float acc[P::kSub][64];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int row0 = t * P::kRows;
    for (int c = wg; c < P::kJobs; c += rt::kConsumers) {
      const int job = it * P::kJobs + c;
      const int col0 = c * kChunkN;
      if (c == wg) {  // this warpgroup's first chunk of the tile: A has to be there
        rt::mbar_wait(a_full, it & 1);
        if constexpr (kLn) {
          if (wg == 0) {  // the other warpgroup's turn comes after this one's products
            layer_norm_tile(a_p, gamma, beta, tid);
            rt::fence_proxy_async();
            rt::wg_sync(0);
          }
        }
      }
      if constexpr (kEpi == Epi::kResidual) {
        // the chunk's residual rows (256 bytes each) into L2 under its products
        for (int i = tid; i < 2 * P::kRows; i += 128) {
          const int r = row0 + i / 2;
          if (r < n_rows) prefetch_l2(res + size_t(r) * kN + col0 + (i % 2) * 64);
        }
      }
#pragma unroll
      for (int m = 0; m < P::kSub; ++m)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;  // nothing live across the prologue
      if (job > 0) bar_sync(kOrderBar + wg);  // the other warpgroup has issued its chunk
      ring.next = job * P::kKBlocks;
#pragma unroll 1
      for (int kb = 0; kb < P::kKBlocks; ++kb) {
        const uint32_t b = ring.acquire();
        rt::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int m = 0; m < P::kSub; ++m)
            rt::wgmma_m64n128<0, 0>(
                acc[m], rt::desc_a(a_s + kb * P::kKBlockBytes + m * rt::kKBlockBytes + s * 32),
                rt::desc_a(b + s * 32), kb | s);
        rt::wgmma_commit();
        if (kb > 0) {
          rt::wgmma_wait<1>();
          ring.release(ring.next - 2);
        }
      }
      if (job + 1 < n_jobs) bar_arrive(kOrderBar + (wg ^ 1));
      rt::wgmma_wait<0>();
      ring.release(ring.next - 1);
#pragma unroll
      for (int m = 0; m < P::kSub; ++m) rt::fence_acc(acc[m]);
      // this warpgroup's last chunk of the tile: A is free for the next one
      if (c + rt::kConsumers >= P::kJobs && tid == 0) rt::mbar_arrive(a_empty);

      // acc[m][4j + 2h + i]: row 64m + 16 warp + lane / 4 + 8h, column
      // col0 + 8j + 2q + i. Four j at a time: bias, the GELU or the
      // residual, rounding, in the accumulator layout; the quad's transpose
      // then gives lane q the 8 columns col0 + 8(jb + q) .. + 7 of its row.
#pragma unroll
      for (int jb = 0; jb < 16; jb += 4) {
        float2 bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          bv[u] = *reinterpret_cast<const float2*>(bias_s + col0 + 8 * (jb + u) + 2 * q);
#pragma unroll
        for (int m = 0; m < P::kSub; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 64 * m + 16 * warp + lane / 4 + 8 * h;
            unsigned w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = jb + u;
              float v0 = __fadd_rn(acc[m][4 * j + 2 * h], bv[u].x);
              float v1 = __fadd_rn(acc[m][4 * j + 2 * h + 1], bv[u].y);
              if constexpr (kEpi == Epi::kGelu) {
                v0 = gelu_erf(v0);
                v1 = gelu_erf(v1);
              }
              if constexpr (kEpi == Epi::kResidual) {
                if (r < n_rows) {
                  const float2 a = unpack(__ldg(reinterpret_cast<const unsigned*>(
                      res + size_t(r) * kN + col0 + 8 * j + 2 * q)));
                  v0 = __fadd_rn(a.x, v0);
                  v1 = __fadd_rn(a.y, v1);
                }
              }
              w[u] = pack(v0, v1);
            }
            quad_transpose(w, q);
            if (r < n_rows) {
              const size_t off = size_t(r) * kN + col0 + 8 * (jb + q);
              *reinterpret_cast<uint4*>(out + off) = make_uint4(w[0], w[1], w[2], w[3]);
            }
          }
      }
    }
  }
}

template <int kK, int kN, bool kLn, Epi kEpi>
cudaError_t launch_gemm(const void* a, const void* w, const void* gamma, const void* beta,
                        const void* bias, const void* res, void* out, int n_rows, int width,
                        cudaStream_t stream) {
  using P = Plan<kK, kN>;
  if (width != kWidth || n_rows < 0 || n_rows > kMaxRows) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(res) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, w_map;
  cudaError_t err = pose3d::tile_map(&a_map, static_cast<const bf16*>(a), n_rows, kK, P::kRows);
  if (err == cudaSuccess)
    err = pose3d::tile_map(&w_map, static_cast<const bf16*>(w), kN, kK, kChunkN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<kK, kN, kLn, kEpi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(P::kSmem));
  int grid = 0;
  if (err == cudaSuccess) err = pose3d::persistent_grid((n_rows + P::kRows - 1) / P::kRows, &grid);
  if (err != cudaSuccess) return err;
  gemm_kernel<kK, kN, kLn, kEpi><<<grid, rt::kThreads, P::kSmem, stream>>>(
      a_map, w_map, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(res), static_cast<bf16*>(out),
      n_rows);
  return cudaGetLastError();
}

}  // namespace

// Every launcher: (n_rows, ·) bf16 rows, contiguous, each pointer on a
// 16-byte boundary (TMA's rule; a map refuses another); weights (out, in)
// and vectors as the nn.Linear and nn.LayerNorm parameters; width is the
// caller's idea of the kernels' row width: a mismatch returns
// cudaErrorInvalidValue. Each launches on the calling thread's current
// device, which must hold the operands.

// qkv (n_rows, 1536) = bf16(bf16(LN(x; gamma, beta)) w^T + b); x (n_rows, 512).
extern "C" cudaError_t dstformer_ln_qkv_launch(const void* x, const void* gamma,
                                               const void* beta, const void* w, const void* b,
                                               void* qkv, int n_rows, int width,
                                               void* stream) {
  return launch_gemm<kWidth, kQkvCols, true, Epi::kBias>(
      x, w, gamma, beta, b, qkv, qkv, n_rows, width, static_cast<cudaStream_t>(stream));
}

// x1 (n_rows, 512) = bf16(x + (o w^T + b)); o, x (n_rows, 512).
extern "C" cudaError_t dstformer_proj_residual_launch(const void* o, const void* w,
                                                      const void* b, const void* x, void* x1,
                                                      int n_rows, int width, void* stream) {
  return launch_gemm<kWidth, kWidth, false, Epi::kResidual>(
      o, w, nullptr, nullptr, b, x, x1, n_rows, width, static_cast<cudaStream_t>(stream));
}

// h (n_rows, 1024) = bf16(gelu(bf16(LN(x1; gamma, beta)) w^T + b)).
extern "C" cudaError_t dstformer_ln_fc1_gelu_launch(const void* x1, const void* gamma,
                                                    const void* beta, const void* w,
                                                    const void* b, void* h, int n_rows,
                                                    int width, void* stream) {
  return launch_gemm<kWidth, kHidden, true, Epi::kGelu>(
      x1, w, gamma, beta, b, h, h, n_rows, width, static_cast<cudaStream_t>(stream));
}

// out (n_rows, 512) = bf16(x1 + (h w^T + b)); h (n_rows, 1024).
extern "C" cudaError_t dstformer_fc2_residual_launch(const void* h, const void* w,
                                                     const void* b, const void* x1, void* out,
                                                     int n_rows, int width, void* stream) {
  return launch_gemm<kHidden, kWidth, false, Epi::kResidual>(
      h, w, nullptr, nullptr, b, x1, out, n_rows, width, static_cast<cudaStream_t>(stream));
}

// o (rows, 512) = MHSA of qkv (rows, 1536), rows frame-major (clips,
// frames, joints): axis 0 over the joints of each frame, 1 over the frames
// of each joint, read and written in place through the sequence layouts.
extern "C" cudaError_t dstformer_attention_launch(const void* qkv, void* o, int clips,
                                                  int frames, int joints, int axis, int width,
                                                  void* stream) {
  if (width != kWidth || clips < 0 || frames < 1 || joints < 1 || (axis != 0 && axis != 1))
    return cudaErrorInvalidValue;
  const long long q3 = kQkvCols, c = kWidth, frame = joints, clip = 1LL * frames * joints;
  const auto in = static_cast<const bf16*>(qkv);
  const auto out = static_cast<bf16*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  if (axis == 0)
    return pose3d::launch_attention(in, out, clips * frames, joints, kHeads, kHeadDim, 1,
                                    {frame * q3, 0, q3}, {frame * c, 0, c}, s);
  return pose3d::launch_attention(in, out, clips * joints, frames, kHeads, kHeadDim, joints,
                                  {clip * q3, q3, frame * q3}, {clip * c, c, frame * c}, s);
}
