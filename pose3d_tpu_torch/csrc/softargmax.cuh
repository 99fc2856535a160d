// Per-joint softmax expectations from tile partials, shared by the
// volumetric soft-argmax kernel (softargmax.cu) and the fused 1x1-conv
// decode (conv_decode.cu).
//
// A joint's softmax runs over its whole D x H x W volume (262,144 logits at
// the main shapes), which no SM holds. So each CTA reduces one tile of
// pixels to a partial: its maximum m and, relative to it, s = sum exp(x -
// m) and sx, sy, sz, the same sums weighted by the pixel's x (column), y
// (row) and the depth index. merge_kernel then folds a joint's tile
// partials in tile order, rescaling each to the running maximum, and
// writes [Ex, Ey, Ez] = [sx, sy, sz] / s and, where asked, the joint's
// final m and s. The fixed order makes two calls bitwise equal; there are
// no atomics.
//
// The backwards (softargmax.cu, conv_decode_bwd.cu) take those m and s:
// each element's p / s = exp(x - m) / s in one read of its input, with no
// second pass for the maximum, and dx = p / s * (gx (xi - Ex) + gy (yi -
// Ey) + gz (d - Ez)) for the gradient g = [gx, gy, gz] of [Ex, Ey, Ez].
//
// Partials are float[5] {m, s, sx, sy, sz}, laid out (B * J, n_tiles, 5);
// statistics float[2] {m, s}, (B * J, 2).

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace pose3d {

constexpr int kPartial = 5;  // floats per partial: m, s, sx, sy, sz
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU: exp2f's value wherever it is not subnormal (it flushes
// those to 0), without exp2f's subnormal handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Partial {
  float m = -INFINITY, s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;

  // this = this (+) o, each rescaled to the larger maximum; a partial with
  // no element (m = -inf) adds nothing
  __device__ __forceinline__ void merge(const Partial& o) {
    if (o.m == -INFINITY) return;
    if (m == -INFINITY) {
      *this = o;
      return;
    }
    const float nm = fmaxf(m, o.m);
    const float a = exp2f((m - nm) * kLog2e);
    const float b = exp2f((o.m - nm) * kLog2e);
    s = s * a + o.s * b;
    sx = sx * a + o.sx * b;
    sy = sy * a + o.sy * b;
    sz = sz * a + o.sz * b;
    m = nm;
  }

  // the five fields at p[0], p[stride], ..., p[4 * stride]
  __device__ __forceinline__ void store_strided(float* p, int stride) const {
    p[0] = m;
    p[stride] = s;
    p[2 * stride] = sx;
    p[3 * stride] = sy;
    p[4 * stride] = sz;
  }

  __device__ __forceinline__ void store(float* p) const { store_strided(p, 1); }

  static __device__ __forceinline__ Partial load_strided(const float* p, int stride) {
    Partial r;
    r.m = p[0];
    r.s = p[stride];
    r.sx = p[2 * stride];
    r.sy = p[3 * stride];
    r.sz = p[4 * stride];
    return r;
  }

  static __device__ __forceinline__ Partial load(const float* p) { return load_strided(p, 1); }
};

// acc = acc (+) the partial of lane (lane ^ offset), for a shuffle tree in
// a fixed order; every lane of the warp calls it
__device__ __forceinline__ void merge_lane(Partial& acc, int offset) {
  Partial o;
  o.m = __shfl_xor_sync(0xffffffffu, acc.m, offset);
  o.s = __shfl_xor_sync(0xffffffffu, acc.s, offset);
  o.sx = __shfl_xor_sync(0xffffffffu, acc.sx, offset);
  o.sy = __shfl_xor_sync(0xffffffffu, acc.sy, offset);
  o.sz = __shfl_xor_sync(0xffffffffu, acc.sz, offset);
  acc.merge(o);
}

constexpr int kMergeThreads = 128;

// One thread per (sample, joint), kThreads_ a block, grid ceil(n /
// kThreads_): folds its n_tiles partials in order and writes out[i * 3 +
// {0, 1, 2}] = [Ex, Ey, Ez] and, unless stats is null, stats[i * 2 + {0,
// 1}] = [m, s]. A template, so that each source including this file
// instantiates it without a duplicate symbol at link time.
template <int kThreads_>
__global__ void __launch_bounds__(kThreads_) merge_kernel(const float* __restrict__ part,
                                                          int n_tiles, int n,
                                                          float* __restrict__ out,
                                                          float* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Partial acc;
  for (int t = 0; t < n_tiles; ++t) acc.merge(Partial::load(part + (size_t(i) * n_tiles + t) * kPartial));
  const float inv = 1.f / acc.s;
  out[size_t(i) * 3 + 0] = acc.sx * inv;
  out[size_t(i) * 3 + 1] = acc.sy * inv;
  out[size_t(i) * 3 + 2] = acc.sz * inv;
  if (stats) {
    stats[size_t(i) * 2] = acc.m;
    stats[size_t(i) * 2 + 1] = acc.s;
  }
}

// The backward's coefficients of one (sample, joint) i, from the gradient
// g and the expectations e ((B * J, 3) f32 each) and the statistics.
struct GradCoef {
  float gx, gy, gz, ex, ey, ez, m, inv_s;

  static __device__ __forceinline__ GradCoef load(const float* __restrict__ g,
                                                  const float* __restrict__ e,
                                                  const float* __restrict__ stats, int i) {
    GradCoef c;
    c.gx = g[i * 3];
    c.gy = g[i * 3 + 1];
    c.gz = g[i * 3 + 2];
    c.ex = e[i * 3];
    c.ey = e[i * 3 + 1];
    c.ez = e[i * 3 + 2];
    c.m = stats[i * 2];
    c.inv_s = 1.f / stats[i * 2 + 1];
    return c;
  }

  // dx of the logit x at column xi, row yi and depth index d
  __device__ __forceinline__ float grad(float x, float xi, float yi, float d) const {
    const float p = exp2f((x - m) * kLog2e) * inv_s;
    return p * fmaf(gx, xi - ex, fmaf(gy, yi - ey, gz * (d - ez)));
  }
};

}  // namespace pose3d
