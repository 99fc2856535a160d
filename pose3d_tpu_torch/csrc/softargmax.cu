// Volumetric soft-argmax straight off NHWC logits, for Hopper (sm_90a):
// logits (B, H, W, J * D), bf16 or f32, channel j * D + d; for each
// (sample, joint) a softmax over the joint's D x H x W volume, maximum
// subtracted, and the expected column, row and depth index: out (B, J, 3)
// f32 [Ex, Ey, Ez]. The wrapper (ops/softargmax.py) scales them to
// coordinates. The backward takes the gradient g of [Ex, Ey, Ez] and
// writes dx, the logits' gradient, in their dtype and layout.
//
// Replaces pose3d_tpu/ops/pallas_softargmax.py:138 _kernel_nhwc_fwd (via
// _simple_fwd_call :268) and :183 _kernel_nhwc_pair_fwd (via
// _expectations_nhwc_fwd :303), and the backwards :164 _kernel_nhwc_bwd
// (via _simple_bwd_call :286) and :220 _kernel_nhwc_pair_bwd (via
// _nhwc_vjp_bwd :352); entry soft_argmax_3d_nhwc_pallas :395. The TPU's
// one-joint / joint-pair / odd-tail split exists for its 128-lane blocks;
// these kernels take any J and any D that holds whole 16-byte vectors.
//
// What bounds them on this card: bytes. The forward reads the logits once
// (570 MB in bf16 at B = 64, H = W = D = 64, J = 17: 0.17 ms at 3.35
// TB/s) and does one exp per logit; the backward reads them once and
// writes dx once (0.34 ms).
//
// Why not the TPU's design: the TPU holds one joint's whole volume (1 MB
// in f32) in VMEM, takes its maximum, then its sums. No SM holds that, and
// a second read for the maximum would double the bytes. The design: a CTA
// per (sample, tile of kTilePixels pixels) reads the tile's pixels, whose
// J * D channels are contiguous, in 16-byte vectors; thread (v, r) of the
// (J*D / vector, rows) block owns channel vector v (which lies in one
// joint) for the pixels r, r + rows, ..., and keeps an online softmax of
// its elements: a running maximum, with s, sx, sy, sz rescaled when it
// grows. The CTA folds each joint's threads into one tile partial
// (softargmax.cuh), in a fixed order; merge_kernel folds the tiles and,
// for the backward, keeps each joint's maximum m and sum s. Two launches,
// no atomics: two calls are bitwise equal. The backward is one launch on
// the same grid: each thread turns its vectors into dx = exp(x - m) / s *
// (the joint's coefficients, softargmax.cuh GradCoef), one read and one
// write of each element.
//
// The legacy layout: softargmax_volume_launch replaces :36 _kernel (via
// _expectations_fwd :58; entry soft_argmax_3d_pallas :423), the same
// expectations of N contiguous (d, h, w) volumes, W fastest: element k of a
// volume sits at column k % w, row (k / w) % h, depth k / (h w). Bytes
// bound it too (the same 570 MB at the main shapes), and for the same
// reason it does not keep a volume in one CTA as the TPU does: a CTA per
// (volume, tile of kVolumeTileBytes contiguous bytes) reads them in 16-byte
// vectors, neighbouring threads on neighbouring vectors, every vector of
// the tile in flight at once; each thread keeps the online softmax of its
// vectors (a vector lies in one row, so it shares y and z), the CTA folds
// its threads in a fixed order (a shuffle tree, then the warps in order),
// and merge_kernel folds a volume's tiles in order. No atomics: two calls
// are bitwise equal. The JAX package's backward of this layout is XLA
// (_vjp_bwd :101), and so is the port's (ops/softargmax.py).
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing (the wrapper allocates the partials, the statistics and the
// outputs), and return cudaGetLastError().

#include <climits>

#include "common.cuh"
#include "softargmax.cuh"

namespace {

using namespace pose3d;

constexpr int kTilePixels = 128;  // pixels of a CTA's tile
constexpr int kTargetThreads = 512;
constexpr int kUnroll = 4;        // pixel vectors in flight per thread

template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[kN]) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[kN]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), u);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&f)[kN]) {
    const float4 u = __ldcs(reinterpret_cast<const float4*>(p));
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[kN]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};

// grid (n_tiles, B), block (J * D / V, rows): see the header comment.
// part: (B * J, n_tiles, 5) tile partials.
template <typename T>
__global__ void __launch_bounds__(1024) tile_kernel(const T* __restrict__ logits,
                                                    float* __restrict__ part, int pixels,
                                                    int width, int joints, int depth) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float red[];  // (5, rows, vectors)
  const int n_vec = blockDim.x;
  const int rows = blockDim.y;
  const int v = threadIdx.x;
  const int r = threadIdx.y;
  const int channels = n_vec * V;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = tile * kTilePixels;
  const int p1 = min(p0 + kTilePixels, pixels);
  const float d0 = float((v * V) % depth);
  const T* base = logits + size_t(b) * pixels * channels + v * V;

  Partial acc;
  for (int p = p0 + r; p < p1; p += rows * kUnroll) {
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * rows < p1) Vec<T>::load(base + size_t(p + u * rows) * channels, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q >= p1) break;
      float mx = f[u][0];
#pragma unroll
      for (int i = 1; i < V; ++i) mx = fmaxf(mx, f[u][i]);
      if (mx > acc.m) {
        const float a = exp2f((acc.m - mx) * kLog2e);  // 0 while acc is empty
        acc.s *= a;
        acc.sx *= a;
        acc.sy *= a;
        acc.sz *= a;
        acc.m = mx;
      }
      float ps = 0.f, pz = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float e = exp2f((f[u][i] - acc.m) * kLog2e);  // m * log2e unrounded
        ps += e;
        pz = fmaf(e, float(i), pz);
      }
      acc.s += ps;
      acc.sx = fmaf(ps, float(q % width), acc.sx);
      acc.sy = fmaf(ps, float(q / width), acc.sy);
      acc.sz += fmaf(ps, d0, pz);
    }
  }

  const int stride = rows * n_vec;
  acc.store_strided(red + r * n_vec + v, stride);
  __syncthreads();
  const int j = r * n_vec + v;  // one thread per joint folds its vectors
  if (j < joints) {
    const int per_joint = depth / V;
    Partial t;
    for (int rr = 0; rr < rows; ++rr)
      for (int vv = j * per_joint; vv < (j + 1) * per_joint; ++vv)
        t.merge(Partial::load_strided(red + rr * n_vec + vv, stride));
    const int n_tiles = gridDim.x;
    t.store(part + ((size_t(b) * joints + j) * n_tiles + tile) * kPartial);
  }
}

// grid (n_tiles, B), block (J * D / V, rows), as tile_kernel: dx of each
// element of the tile from g, e ((B * J, 3) f32) and stats ((B * J, 2)).
template <typename T>
__global__ void __launch_bounds__(1024) bwd_kernel(const T* __restrict__ logits,
                                                   const float* __restrict__ g,
                                                   const float* __restrict__ e,
                                                   const float* __restrict__ stats,
                                                   T* __restrict__ dx, int pixels, int width,
                                                   int joints, int depth) {
  constexpr int V = Vec<T>::kN;
  const int n_vec = blockDim.x;
  const int rows = blockDim.y;
  const int v = threadIdx.x;
  const int channels = n_vec * V;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTilePixels;
  const int p1 = min(p0 + kTilePixels, pixels);
  const float d0 = float((v * V) % depth);
  const GradCoef c = GradCoef::load(g, e, stats, b * joints + (v * V) / depth);
  const size_t base = size_t(b) * pixels * channels + v * V;

  for (int p = p0 + threadIdx.y; p < p1; p += rows * kUnroll) {
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * rows < p1) Vec<T>::load(logits + base + size_t(p + u * rows) * channels, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q >= p1) break;
      const float xi = float(q % width);
      const float yi = float(q / width);
#pragma unroll
      for (int i = 0; i < V; ++i) f[u][i] = c.grad(f[u][i], xi, yi, d0 + float(i));
      Vec<T>::store(dx + base + size_t(q) * channels, f[u]);
    }
  }
}

// The block shape of both kernels: (vectors a pixel, pixel rows), or
// dim3(0) where the vectors do not fit one block.
template <typename T>
dim3 block_shape(int joints, int depth) {
  constexpr int V = Vec<T>::kN;
  const int n_vec = joints * depth / V;
  if (depth % V != 0 || n_vec > 1024) return dim3(0);
  return dim3(n_vec, n_vec < kTargetThreads ? kTargetThreads / n_vec : 1);  // n_vec * rows <= 1024
}

template <typename T>
cudaError_t launch(const T* logits, float* part, float* out, float* stats, int batch, int height,
                   int width, int joints, int depth, cudaStream_t stream) {
  const dim3 block = block_shape<T>(joints, depth);
  if (block.x == 0) return cudaErrorInvalidValue;
  const int pixels = height * width;
  const int n_tiles = (pixels + kTilePixels - 1) / kTilePixels;
  const size_t smem = size_t(kPartial) * block.x * block.y * sizeof(float);
  tile_kernel<T><<<dim3(n_tiles, batch), block, smem, stream>>>(logits, part, pixels, width,
                                                                 joints, depth);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = batch * joints;
  merge_kernel<kMergeThreads><<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
      part, n_tiles, n, out, stats);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const T* logits, const float* g, const float* e, const float* stats, T* dx,
                       int batch, int height, int width, int joints, int depth,
                       cudaStream_t stream) {
  const dim3 block = block_shape<T>(joints, depth);
  if (block.x == 0) return cudaErrorInvalidValue;
  const int pixels = height * width;
  const int n_tiles = (pixels + kTilePixels - 1) / kTilePixels;
  bwd_kernel<T><<<dim3(n_tiles, batch), block, 0, stream>>>(logits, g, e, stats, dx, pixels,
                                                             width, joints, depth);
  return cudaGetLastError();
}

constexpr int kVolumeThreads = 256;
constexpr int kVolumeTileBytes = 16384;  // a CTA's tile of a (d, h, w) volume
constexpr int kVolumeUnroll = kVolumeTileBytes / 16 / kVolumeThreads;  // vectors a thread
static_assert(kVolumeUnroll * 16 * kVolumeThreads == kVolumeTileBytes, "whole vectors a thread");

// this = this (+) the partial of lane (lane ^ offset), for a shuffle tree
__device__ __forceinline__ void merge_lane(Partial& acc, int offset) {
  Partial o;
  o.m = __shfl_xor_sync(0xffffffffu, acc.m, offset);
  o.s = __shfl_xor_sync(0xffffffffu, acc.s, offset);
  o.sx = __shfl_xor_sync(0xffffffffu, acc.sx, offset);
  o.sy = __shfl_xor_sync(0xffffffffu, acc.sy, offset);
  o.sz = __shfl_xor_sync(0xffffffffu, acc.sz, offset);
  acc.merge(o);
}

// The shape of one (depth, height, width) volume as the tile kernel walks
// it: a thread's vectors lie kVolumeThreads vectors apart, a stride of
// step_z planes, step_y rows and step_x columns, so that it finds each
// vector's column, row and depth by additions (no division per vector).
struct VolumeShape {
  int volume;  // elements of one volume, a whole number of vectors
  int n_tiles, height, width;
  int step_x, step_y, step_z;
};

// grid n * n_tiles, block kVolumeThreads: CTA (volume, tile) reduces the
// tile's vectors (fewer in a volume's last tile) to part[(volume *
// n_tiles + tile) * 5]. width % V == 0, so that a vector lies in one row.
template <typename T>
__global__ void __launch_bounds__(kVolumeThreads)
volume_tile_kernel(const T* __restrict__ logits, float* __restrict__ part, VolumeShape vs) {
  constexpr int V = Vec<T>::kN;
  constexpr int kTileVecs = kVolumeTileBytes / 16;
  __shared__ float red[kVolumeThreads / 32][kPartial];
  const long long vol = blockIdx.x / vs.n_tiles;
  const int tile = blockIdx.x % vs.n_tiles;
  const int v0 = tile * kTileVecs;
  const int count = min(kTileVecs, vs.volume / V - v0);  // vectors of this tile
  const T* base = logits + vol * vs.volume;

  float f[kVolumeUnroll][V];
#pragma unroll
  for (int u = 0; u < kVolumeUnroll; ++u) {
    const int i = threadIdx.x + u * kVolumeThreads;
    if (i < count) Vec<T>::load(base + static_cast<long long>(v0 + i) * V, f[u]);
  }
  // column x, row y and depth z of this thread's first vector's first element
  const int k0 = (v0 + static_cast<int>(threadIdx.x)) * V;
  const int row0 = k0 / vs.width;
  int x = k0 - row0 * vs.width;
  int z = row0 / vs.height;
  int y = row0 - z * vs.height;
  Partial acc;
#pragma unroll
  for (int u = 0; u < kVolumeUnroll; ++u) {
    const int i = threadIdx.x + u * kVolumeThreads;
    if (i >= count) break;
    float mx = f[u][0];
#pragma unroll
    for (int e = 1; e < V; ++e) mx = fmaxf(mx, f[u][e]);
    if (mx > acc.m) {
      const float a = exp2f((acc.m - mx) * kLog2e);  // 0 while acc is empty
      acc.s *= a;
      acc.sx *= a;
      acc.sy *= a;
      acc.sz *= a;
      acc.m = mx;
    }
    float ps = 0.f, px = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float p = exp2f((f[u][e] - acc.m) * kLog2e);  // m * log2e unrounded
      ps += p;
      px = fmaf(p, float(e), px);
    }
    acc.s += ps;
    acc.sx += fmaf(ps, float(x), px);
    acc.sy = fmaf(ps, float(y), acc.sy);
    acc.sz = fmaf(ps, float(z), acc.sz);
    // on to the thread's next vector: each of x, y wraps at most once
    x += vs.step_x;
    const int carry = x >= vs.width;
    x -= carry * vs.width;
    y += vs.step_y + carry;
    if (y >= vs.height) {
      y -= vs.height;
      ++z;
    }
    z += vs.step_z;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) merge_lane(acc, offset);
  if (lane == 0) acc.store(red[warp]);
  __syncthreads();
  if (threadIdx.x == 0) {
    Partial t;
    for (int w = 0; w < kVolumeThreads / 32; ++w) t.merge(Partial::load(red[w]));
    t.store(part + (vol * vs.n_tiles + tile) * kPartial);
  }
}

template <typename T>
cudaError_t launch_volume(const T* logits, float* part, float* out, int n, int depth, int height,
                          int width, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const long long volume = static_cast<long long>(depth) * height * width;
  const long long tile_elems = kVolumeTileBytes / sizeof(T);
  const long long n_tiles = (volume + tile_elems - 1) / tile_elems;
  constexpr int kStep = kVolumeThreads * V;  // elements between a thread's vectors
  if (width % V != 0 || volume > INT_MAX - kStep || n_tiles * n > INT_MAX)
    return cudaErrorInvalidValue;
  const int step_rows = kStep / width;
  const VolumeShape vs{static_cast<int>(volume), static_cast<int>(n_tiles), height, width,
                       kStep % width, step_rows % height, step_rows / height};
  volume_tile_kernel<T><<<static_cast<unsigned>(n_tiles * n), kVolumeThreads, 0, stream>>>(
      logits, part, vs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (n + kMergeThreads - 1) / kMergeThreads;
  merge_kernel<kMergeThreads><<<blocks, kMergeThreads, 0, stream>>>(
      part, static_cast<int>(n_tiles), n, out, nullptr);
  return cudaGetLastError();
}

bool bad_shape(int batch, int height, int width, int joints, int depth, int tile_pixels) {
  return tile_pixels != kTilePixels || batch < 1 || batch > 65535 || height < 1 || width < 1 ||
         joints < 1 || depth < 1;
}

}  // namespace

// logits: (batch, height, width, joints * depth), bf16 (is_bf16 = 1) or f32
// (is_bf16 = 0), contiguous, 16-byte aligned; partials: (batch * joints,
// ceil(height * width / tile_pixels), 5) f32 scratch; out: (batch, joints,
// 3) f32; stats: (batch, joints, 2) f32 [m, s], or null where no backward
// follows. tile_pixels is the caller's idea of the kernel's tile: a
// mismatch, a depth that is not a whole number of 16-byte vectors, more
// than 1024 vectors a pixel or a batch past the grid's limit returns
// cudaErrorInvalidValue. Two launches in a row on the calling thread's
// current device; the first error ends the sequence and is returned.
extern "C" cudaError_t softargmax_nhwc_launch(const void* logits, int is_bf16, void* partials,
                                              void* out, void* stats, int batch, int height,
                                              int width, int joints, int depth, int tile_pixels,
                                              void* stream) {
  if (bad_shape(batch, height, width, joints, depth, tile_pixels)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partials);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<float*>(stats);
  if (is_bf16)
    return launch(static_cast<const bf16*>(logits), part, o, st, batch, height, width, joints,
                  depth, s);
  return launch(static_cast<const float*>(logits), part, o, st, batch, height, width, joints,
                depth, s);
}

// The backward: logits as above; g, e: (batch, joints, 3) f32, the
// gradient of the expectations and the expectations; stats: the forward's
// (batch, joints, 2) [m, s]; dx: the logits' shape and dtype, contiguous,
// 16-byte aligned. The same checks as the forward; one launch.
extern "C" cudaError_t softargmax_nhwc_bwd_launch(const void* logits, int is_bf16, const void* g,
                                                  const void* e, const void* stats, void* dx,
                                                  int batch, int height, int width, int joints,
                                                  int depth, int tile_pixels, void* stream) {
  if (bad_shape(batch, height, width, joints, depth, tile_pixels)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* ep = static_cast<const float*>(e);
  const auto* st = static_cast<const float*>(stats);
  if (is_bf16)
    return launch_bwd(static_cast<const bf16*>(logits), gp, ep, st, static_cast<bf16*>(dx), batch,
                      height, width, joints, depth, s);
  return launch_bwd(static_cast<const float*>(logits), gp, ep, st, static_cast<float*>(dx), batch,
                    height, width, joints, depth, s);
}

// logits: (n, depth, height, width), bf16 (is_bf16 = 1) or f32 (is_bf16 =
// 0), contiguous, 16-byte aligned; partials: (n, ceil(depth * height *
// width * element bytes / tile_bytes), 5) f32 scratch; out: (n, 3) f32 [Ex,
// Ey, Ez]. tile_bytes is the caller's idea of the kernel's tile: a
// mismatch, a width that is not a whole number of 16-byte vectors, a
// volume of more than INT_MAX elements or more than INT_MAX CTAs returns
// cudaErrorInvalidValue. Two launches in a row
// on the calling thread's current device; the first error ends the
// sequence and is returned.
extern "C" cudaError_t softargmax_volume_launch(const void* logits, int is_bf16, void* partials,
                                                void* out, int n, int depth, int height,
                                                int width, int tile_bytes, void* stream) {
  if (tile_bytes != kVolumeTileBytes || n < 0 || depth < 1 || height < 1 || width < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partials);
  auto* o = static_cast<float*>(out);
  if (is_bf16)
    return launch_volume(static_cast<const bf16*>(logits), part, o, n, depth, height, width, s);
  return launch_volume(static_cast<const float*>(logits), part, o, n, depth, height, width, s);
}
