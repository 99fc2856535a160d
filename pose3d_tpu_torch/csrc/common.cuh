// Device code shared by the port's Hopper kernels (sm_90a): the widths of
// the transformer blocks, bf16 helpers, the LayerNorm row and the
// polynomial GELU of the JAX kernels, and the ldmatrix / mma.sync / cp.async
// primitives of the kernels that run on them (attention.cu,
// stblock_train.cu; the NHWC soft-argmax forward streams by cp.async). The
// row-tile products of the sub-block forwards, the lifter trunk, the conv
// decodes and the Martinez block run on rowtile_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace pose3d {

using bf16 = __nv_bfloat16;

constexpr int kDim = 256;
constexpr int kQkv = 3 * kDim;
constexpr int kMlp = 4 * kDim;

constexpr float kLnEps = 1e-5f;
constexpr float kScoreClamp = 80.f;
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

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

}  // namespace pose3d
