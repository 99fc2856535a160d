// Device code shared by the port's Hopper kernels (sm_90a): bf16 helpers,
// the LayerNorm row and the polynomial GELU of the JAX kernels, and the
// row-tile GEMM engine of the fused transformer kernels.
//
// The GEMM engine. A CTA holds a tile of kRowsPad rows x 256 in shared
// memory and multiplies it by a weight matrix that does not fit there:
// the weights stream from L2 through a kRing-slot cp.async ring in chunks
// of kTileK rows x kTileN columns, in the order the products consume them,
// and warp w computes columns [32w, 32w + 32) of each 256-column pass for
// all kRowsPad rows with ldmatrix + mma.sync (m16n8k16, bf16 in, f32
// accumulate). One transformer sub-block's products, in stream order: 3
// qkv passes, the projection, then for each 512-wide half of the MLP
// hidden its 2 W1 passes and its W2 rows (BlockOffsets says where each
// matrix lies in a block of the flat weight operand; matrices are (in,
// out), row-major).
//
// Shared-memory plan of a tile (the column regions of `big`): the residual
// stream x (kRowsPad x kLdX), and one kRowsPad x kLdBig buffer that holds
// in turn the LN output (in v's columns) and q|k|v, the attention output
// (over q), then the LN_2 output beside one half of the MLP hidden.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace pose3d {

using bf16 = __nv_bfloat16;

constexpr int kDim = 256;
constexpr int kQkv = 3 * kDim;
constexpr int kMlp = 4 * kDim;
constexpr int kMlpHalf = kMlp / 2;

constexpr float kLnEps = 1e-5f;
constexpr float kScoreClamp = 80.f;
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

constexpr int kRowsPad = 80;  // rows of a tile, a whole number of MMA tiles
constexpr int kMTiles = kRowsPad / 16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// shared-memory row pitches in bf16 elements: 16 bytes of skew per row
// keep the 8 rows of an ldmatrix on distinct banks
constexpr int kLdX = kDim + 8;
constexpr int kLdBig = kQkv + 8;
constexpr int kColQ = 0;             // q, then the attention output, then LN_2(x)
constexpr int kColK = kDim;          // k, then MLP hidden (first half of a half)
constexpr int kColV = 2 * kDim;      // LN(x) as the qkv input, then v
constexpr int kColHidden = kDim;     // 512 hidden columns of the current half

constexpr int kWarpN = 32;
constexpr int kNB = kWarpN / 8;  // n8 MMA blocks per warp
constexpr int kTileN = kWarps * kWarpN;
constexpr int kTileK = 32;
constexpr int kRing = 3;
constexpr int kLdW = kTileN + 8;
constexpr int kChunkElems = kTileK * kLdW;
constexpr int kKChunks256 = kDim / kTileK;       // chunks of a K=256 pass
constexpr int kKChunksHalf = kMlpHalf / kTileK;  // chunks of a K=512 pass
constexpr int kChunksQkv = (kQkv / kTileN) * kKChunks256;
constexpr int kChunksProj = kKChunks256;
constexpr int kChunksHalf = (kMlpHalf / kTileN) * kKChunks256 + kKChunksHalf;
constexpr int kChunksPerBlock = kChunksQkv + kChunksProj + 2 * kChunksHalf;

constexpr size_t kSmemX = size_t(kRowsPad) * kLdX * sizeof(bf16);
constexpr size_t kSmemBig = size_t(kRowsPad) * kLdBig * sizeof(bf16);
constexpr size_t kSmemRing = size_t(kRing) * kChunkElems * sizeof(bf16);
static_assert(kSmemX % 128 == 0 && kSmemBig % 128 == 0, "buffer alignment");
static_assert(kRing >= 2 && kTileN == kDim, "one pass is one 256-column tile");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// x = bf16(x + bf16(v)) on 2 adjacent elements: the bf16 residual add.
__device__ __forceinline__ void residual_add2(bf16* x, float v0, float v1) {
  const float2 r = load2(x);
  store2(x, r.x + round_bf16(v0), r.y + round_bf16(v1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// erf(x) ~= clamp(x) * P(clamp(x)^2): the JAX kernels' degree-8 polynomial
// (pallas_lifter.py _ERF_C, clamp 3.0), max |err| 2.7e-5.
__device__ __forceinline__ float erf_poly(float x) {
  const float xc = fminf(fmaxf(x, -3.f), 3.f);
  const float s = xc * xc;
  float p = 4.7283642828e-08f;
  p = p * s + -2.1986137083e-06f;
  p = p * s + 4.5123548106e-05f;
  p = p * s + -5.4564336601e-04f;
  p = p * s + 4.4038703607e-03f;
  p = p * s + -2.5570011680e-02f;
  p = p * s + 1.1177045202e-01f;
  p = p * s + -3.7577772172e-01f;
  p = p * s + 1.1283599228e+00f;
  return xc * p;
}

__device__ __forceinline__ float gelu_poly(float x) {
  return x * 0.5f * (1.f + erf_poly(x / kSqrt2));
}

// One row of 256: dst = bf16(LN(src) * g + b), f32 statistics, biased
// variance. One warp per row, 8 elements a lane; src and dst may alias.
__device__ __forceinline__ void layer_norm_row(const bf16* src, bf16* dst,
                                               const bf16* __restrict__ g,
                                               const bf16* __restrict__ b,
                                               int lane) {
  float v[8];
  load8(src + lane * 8, v);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += v[j];
  const float mu = warp_sum(sum) * (1.f / kDim);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = v[j] - mu;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) * (1.f / kDim) + kLnEps);
  float gg[8], bb[8];
  load8(g + lane * 8, gg);
  load8(b + lane * 8, bb);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (v[j] - mu) * rstd * gg[j] + bb[j];
  store8(dst + lane * 8, v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. .trans delivers each matrix transposed.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) @ b (16x8, column fragments), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the four matrices of one block lie in the flat weight operand,
// in elements from the block's start, and the block's size.
struct BlockOffsets {
  int w_qkv, w_proj, w1, w2, block_elems;
};

// The weights as one stream of (kTileK x kTileN) chunks through the shared
// ring, in the order the products consume them: chunks [first, first +
// total) of the sequence that runs block after block, kChunksPerBlock
// each. Every thread of the block issues its share of each chunk's 16-byte
// copies and commits one cp.async group per chunk (empty past the end), so
// that cp.async.wait_group counts chunks.
struct WeightStream {
  const bf16* weights;
  bf16* ring;
  BlockOffsets off;
  int first;      // the stream's first chunk
  int total;      // chunks in the stream
  int issued;     // chunks issued so far
  int consumed;   // chunks consumed so far

  __device__ void issue() {
    const int c = issued++;
    if (c < total) {
      const int g = first + c;
      const bf16* w = weights + size_t(g / kChunksPerBlock) * off.block_elems;
      int j = g % kChunksPerBlock;
      const bf16* src;
      int n;  // row pitch of the source matrix
      if (j < kChunksQkv) {
        n = kQkv;
        src = w + off.w_qkv + size_t(j % kKChunks256) * kTileK * n + (j / kKChunks256) * kTileN;
      } else if ((j -= kChunksQkv) < kChunksProj) {
        n = kDim;
        src = w + off.w_proj + size_t(j) * kTileK * n;
      } else {
        j -= kChunksProj;
        const int half = j / kChunksHalf;
        j %= kChunksHalf;
        if (j < kChunksHalf - kKChunksHalf) {  // W1[:, half columns], pass by pass
          n = kMlp;
          src = w + off.w1 + size_t(j % kKChunks256) * kTileK * n + half * kMlpHalf +
                (j / kKChunks256) * kTileN;
        } else {  // W2[half rows, :]
          j -= kChunksHalf - kKChunksHalf;
          n = kDim;
          src = w + off.w2 + size_t(half * kMlpHalf + j * kTileK) * n;
        }
      }
      bf16* dst = ring + (c % kRing) * kChunkElems;
      for (int i = threadIdx.x; i < kTileK * (kTileN / 8); i += kThreads) {
        const int r = i / (kTileN / 8);
        const int col = (i % (kTileN / 8)) * 8;
        cp_async16(dst + r * kLdW + col, src + size_t(r) * n + col);
      }
    }
    cp_async_commit();
  }

  // Waits for the next chunk (for every thread), then keeps kRing - 1
  // chunks in flight. The barrier also retires the slot read last, which
  // the new issue overwrites. Called by all threads of the block.
  __device__ const bf16* next() {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    issue();
    return ring + (consumed++ % kRing) * kChunkElems;
  }
};

using Acc = float[kMTiles][kNB][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nb][i] = 0.f;
}

// acc += A(kRowsPad x K, shared, pitch lda) @ (the stream's next K / kTileK
// chunks: K rows of one 256-column pass). Warp w owns columns
// [32w, 32w + 32): per k-step of 16, five ldmatrix.x4 of A, two
// ldmatrix.x4.trans of W and twenty m16n8k16 MMAs. All threads call it.
template <int K>
__device__ __forceinline__ void mma_pass(const bf16* A, int lda, WeightStream& ws,
                                         int warp, int lane, Acc& acc) {
  // ldmatrix row addresses of this lane: A rows lane % 16 (+ 16 m) at k
  // offset (lane / 16) * 8; W rows lane % 16 (+ 16 u) at column offset
  // 32 w + (lane / 16) * 8 (+ 16 h)
  const unsigned a_base = smem_u32(A + (lane % 16) * lda + (lane / 16) * 8);
  const unsigned w_lane = ((lane % 16) * kLdW + warp * kWarpN + (lane / 16) * 8) * 2;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const unsigned wt = smem_u32(ws.next()) + w_lane;
#pragma unroll
    for (int u = 0; u < kTileK / 16; ++u) {
      unsigned b[2][4];  // [16-column half h][b0, b1 of n8 block 2h, b0, b1 of 2h + 1]
#pragma unroll
      for (int h = 0; h < 2; ++h) ldsm_x4_trans(b[h], wt + (u * 16 * kLdW + h * 16) * 2);
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        unsigned a[4];
        ldsm_x4(a, a_base + (m * 16 * lda + k0 + u * 16) * 2);
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          mma_bf16(acc[m][nb], a, b[nb / 2][(nb % 2) * 2], b[nb / 2][(nb % 2) * 2 + 1]);
      }
    }
  }
}

// Hands each accumulated pair (+ bias, if given: kTileN values in global
// memory for this pass) to epi(row, col, v0, v1), for the rows below
// `rows` only; col is the pass-local column of v0, v1 belongs to col + 1.
template <typename Epi>
__device__ __forceinline__ void epilogue(const Acc& acc, const bf16* __restrict__ bias,
                                         int warp, int lane, int rows, Epi epi) {
  const int g = lane / 4;  // m16n8 accumulators: (row g, cols 2q, 2q + 1), (row g + 8, ...)
  const int q = lane % 4;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    const int col = warp * kWarpN + nb * 8 + 2 * q;
    const float2 bv = bias ? load2(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      const int r0 = m * 16 + g;
      if (r0 < rows) epi(r0, col, acc[m][nb][0] + bv.x, acc[m][nb][1] + bv.y);
      if (r0 + 8 < rows) epi(r0 + 8, col, acc[m][nb][2] + bv.x, acc[m][nb][3] + bv.y);
    }
  }
}

// Zeroes rows [rows, kRowsPad) of a (kRowsPad x ld) shared buffer. Every
// phase writes real rows only, so pad rows stay zero once zeroed.
__device__ __forceinline__ void zero_pad_rows(bf16* buf, int ld, int rows) {
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < (kRowsPad - rows) * (ld / 8); idx += kThreads)
    reinterpret_cast<uint4*>(buf + rows * ld)[idx] = zero16;
}

// The MLP half of a sub-block on a tile: y = LN_2(x) into q's columns,
// then h_half = bf16(gelu(bf16(y @ W1[:, half] + b1))) beside y and
// acc2 += h_half @ W2[half, :] for each 512-wide half; x += bf16(acc2 +
// b2). Starts and ends on a barrier. All threads call it.
__device__ __forceinline__ void mlp_residual(bf16* xs, bf16* big, WeightStream& ws,
                                             const bf16* ln_g, const bf16* ln_b,
                                             const bf16* b1, const bf16* b2, int rows,
                                             int warp, int lane) {
  for (int r = warp; r < rows; r += kWarps)
    layer_norm_row(xs + r * kLdX, big + r * kLdBig + kColQ, ln_g, ln_b, lane);
  __syncthreads();
  Acc acc, acc2;
  zero(acc2);
  for (int half = 0; half < 2; ++half) {
    for (int pass = 0; pass < kMlpHalf / kTileN; ++pass) {
      zero(acc);
      mma_pass<kDim>(big + kColQ, kLdBig, ws, warp, lane, acc);
      const int n0 = half * kMlpHalf + pass * kTileN;
      bf16* dst = big + kColHidden + pass * kTileN;
      epilogue(acc, b1 + n0, warp, lane, rows, [&](int r, int c, float v0, float v1) {
        store2(dst + r * kLdBig + c, gelu_poly(round_bf16(v0)), gelu_poly(round_bf16(v1)));
      });
    }
    __syncthreads();
    mma_pass<kMlpHalf>(big + kColHidden, kLdBig, ws, warp, lane, acc2);
    __syncthreads();  // the next half overwrites the hidden columns
  }
  epilogue(acc2, b2, warp, lane, rows, [&](int r, int c, float v0, float v1) {
    residual_add2(xs + r * kLdX + c, v0, v1);
  });
  __syncthreads();
}

}  // namespace pose3d
