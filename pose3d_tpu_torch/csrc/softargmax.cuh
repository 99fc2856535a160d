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
// writes [Ex, Ey, Ez] = [sx, sy, sz] / s. The fixed order makes two calls
// bitwise equal; there are no atomics.
//
// Partials are float[5] {m, s, sx, sy, sz}, laid out (B * J, n_tiles, 5).

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace pose3d {

constexpr int kPartial = 5;  // floats per partial: m, s, sx, sy, sz
constexpr float kLog2e = 1.4426950408889634f;

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

constexpr int kMergeThreads = 128;

// One thread per (sample, joint), kThreads_ a block, grid ceil(n /
// kThreads_): folds its n_tiles partials in order and writes out[i * 3 +
// {0, 1, 2}] = [Ex, Ey, Ez]. A template, so that each source including
// this file instantiates it without a duplicate symbol at link time.
template <int kThreads_>
__global__ void __launch_bounds__(kThreads_) merge_kernel(const float* __restrict__ part,
                                                          int n_tiles, int n,
                                                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Partial acc;
  for (int t = 0; t < n_tiles; ++t) acc.merge(Partial::load(part + (size_t(i) * n_tiles + t) * kPartial));
  const float inv = 1.f / acc.s;
  out[size_t(i) * 3 + 0] = acc.sx * inv;
  out[size_t(i) * 3 + 1] = acc.sy * inv;
  out[size_t(i) * 3 + 2] = acc.sz * inv;
}

}  // namespace pose3d
