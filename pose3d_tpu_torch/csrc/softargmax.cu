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
// What bounds it on this card: bytes, for the forward and the backward
// alike. The forward reads the logits once (570 MB in bf16 at B = 64, H =
// W = D = 64, J = 17: 0.17 ms at 3.35 TB/s) and does one exp per logit;
// the backward reads them once and writes dx once (0.34 ms).
//
// Why not the TPU's design: the TPU holds one joint's whole volume (1 MB
// in f32) in VMEM, takes its maximum, then its sums. No SM holds that, and
// a second read for the maximum would double the bytes. So each joint's
// softmax is reduced in partials: a thread keeps an online softmax of the
// elements it reads (a running maximum, with s, sx, sy, sz rescaled when
// it grows), a CTA folds each joint's threads into one partial per tile of
// kTilePixels pixels (softargmax.cuh), and merge_kernel folds the tiles in
// tile order and, for the backward, keeps each joint's maximum m and sum
// s. Two launches, no atomics: two calls are bitwise equal.
//
// The forward (nhwc_stream_kernel) keeps enough bytes in flight on every
// SM whatever its threads are computing: a persistent grid (the CTAs that
// fit) walks the (sample, tile) tiles; thread t of the (J * D / vector) x
// rows block owns channel vector t % (J * D / vector), which lies in one
// joint, of the pixel rows t / (J * D / vector), + rows, ... of each tile,
// and streams them, from one tile on into the next, through a ring of its
// own in shared memory: kFwdDepth (8) 16-byte cp.async copies in flight a
// thread (122 KB an SM at the main shapes), each waited for with
// cp.async.wait_group and read by the thread that copied it, so that no
// barrier couples a thread's loads to the others' compute. Neighbouring
// threads copy neighbouring vectors. exp2 runs on the SFU (ex2.approx.ftz,
// exp2f's value without its subnormal handling). A tile's end folds each
// joint's threads by one warp, each lane taking partials in turn and then
// a shuffle tree, in a fixed order: no thread folds a joint alone while
// the others wait. Measured on the way (H100 80GB HBM3, 700 W;
// experiments/decode_fwd_ablation.py): the first version lost 0.14 ms to
// its compute, which held the loads back (loads issued 4 at a time, then
// waited on; exp2f), not to its fold (~0.015 ms); a ring of 32 KB bulk
// copies fed by thread 0 behind mbarriers (cp.async.bulk) ran no faster
// (0.31 ms; bulk copies alone read at 3.1 TB/s), a stage being held from
// its copy's issue to its last reader, which left too few copies in
// flight. Replaced: a CTA per (sample, tile), 2048 at the main
// shapes, each thread loading 4 vectors and then computing on them, and
// one thread per joint folding its 24 partials in series (0.369 ms: 46% of
// the HBM rate, H100 80GB HBM3, 700 W).
//
// The backward (bwd_kernel) is one launch of a CTA per (sample, tile):
// each thread turns its vectors into dx = exp(x - m) / s * (the joint's
// coefficients, softargmax.cuh GradCoef), one read and one write of each
// element.
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

constexpr int kTilePixels = 128;  // pixels of a tile: a partial of 11a, a CTA of 11b
constexpr int kTargetThreads = 512;  // 11b's block
constexpr int kUnroll = 4;           // 11b: pixel vectors in flight per thread
constexpr int kFwdThreads = 1024;    // 11a's block
constexpr int kFwdDepth = 8;         // 11a: vectors in flight a thread (cp.async groups)

template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[kN]) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), f);
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
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
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

// The forward's walk: CTA k takes the tiles k, k + gridDim.x, ... of the
// batch's (sample, kTilePixels-pixel) tiles; thread t of the block takes
// vector v = t % n_vec of the pixels p0 + r, p0 + r + rows, ... (r = t /
// n_vec) of each, its stream of 16-byte vectors from one tile on into the
// next.
struct Walk {
  int pixels, width, joints, depth;
  int n_vec, rows;  // the block: (vectors a pixel) x pixel rows
  int tiles_per_sample, n_tiles, my_tiles;

  // the CTA's tile it: its sample b and its pixels [p0, p1)
  __device__ __forceinline__ void tile(int it, int* b, int* p0, int* p1) const {
    const int t = int(blockIdx.x) + it * int(gridDim.x);
    *b = t / tiles_per_sample;
    *p0 = (t % tiles_per_sample) * kTilePixels;
    *p1 = min(*p0 + kTilePixels, pixels);
  }
};

// A thread's prefetch cursor: the next vector of its stream to copy (tile
// it of the CTA, k-th of the thread's pixel rows there); it == my_tiles
// once the stream has ended.
struct Cursor {
  int it = 0, k = 0, n = 0;
  const unsigned char* row = nullptr;  // the tile's first pixel row of this thread's vector

  // the thread's vectors in tile it (rows r, r + rows, ... below p1 - p0)
  static __device__ __forceinline__ int count(const Walk& w, int it, int r, int* b, int* p0) {
    int p1;
    w.tile(it, b, p0, &p1);
    return r < p1 - *p0 ? (p1 - *p0 - r + w.rows - 1) / w.rows : 0;
  }

  // skips to the first tile from it on that has a vector of this thread
  __device__ __forceinline__ void settle(const Walk& w, const unsigned char* logits, int r, int v) {
    for (; it < w.my_tiles; ++it) {
      int b, p0;
      n = count(w, it, r, &b, &p0);
      if (n > 0) {
        row = logits + ((size_t(b) * w.pixels + p0 + r) * w.n_vec + v) * 16;
        return;
      }
    }
  }

  // copies the vector at the cursor into dst (16 bytes of shared memory)
  // and moves on; no copy once the stream has ended
  __device__ __forceinline__ void fetch(const Walk& w, const unsigned char* logits, int r, int v,
                                        void* dst) {
    if (it >= w.my_tiles) return;
    cp_async16(dst, row + size_t(k) * w.rows * w.n_vec * 16);
    if (++k == n) {
      ++it;
      k = 0;
      settle(w, logits, r, v);
    }
  }
};

// grid: persistent (the CTAs that fit on the card), block (J * D / V) x rows
// threads as one dimension: see the header comment. part: (B * J,
// tiles_per_sample, 5) tile partials.
template <typename T>
__global__ void __launch_bounds__(1024, 1) nhwc_stream_kernel(const T* __restrict__ logits,
                                                              float* __restrict__ part,
                                                              Walk walk) {
  constexpr int V = Vec<T>::kN;
  Walk w = walk;
  w.my_tiles = (w.n_tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  extern __shared__ __align__(16) uint4 slots[];  // (kFwdDepth, threads): each thread's ring
  const int threads = w.n_vec * w.rows;
  float* red = reinterpret_cast<float*>(slots + kFwdDepth * threads);  // (5, threads)
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int v = t % w.n_vec;
  const int r = t / w.n_vec;
  const float d0 = float((v * V) % w.depth);
  const auto* src = reinterpret_cast<const unsigned char*>(logits);
  const bool whole_warp = threads - 32 * warp >= 32;  // the last warp may be short

  // kFwdDepth vectors in flight a thread, one cp.async group each (empty
  // groups past the stream's end keep the count)
  Cursor pf;
  pf.settle(w, src, r, v);
#pragma unroll
  for (int i = 0; i < kFwdDepth; ++i) {
    pf.fetch(w, src, r, v, slots + i * threads + t);
    cp_async_commit();
  }
  int i = 0;  // vectors taken
  for (int it = 0; it < w.my_tiles; ++it) {
    int b, p0;
    const int n = Cursor::count(w, it, r, &b, &p0);
    const int y0 = (p0 + r) / w.width;
    float y = float(y0), x = float(p0 + r - y0 * w.width);  // whole numbers: exact in f32
    const float step_x = float(w.rows % w.width), step_y = float(w.rows / w.width);
    const float fwidth = float(w.width);
    Partial acc;
    for (int k = 0; k < n; ++k, ++i) {
      cp_async_wait<kFwdDepth - 1>();  // this thread's vector i has landed
      uint4* slot = slots + (i % kFwdDepth) * threads + t;
      float f[V];
      Vec<T>::unpack(*slot, f);
      float mx = f[0];
#pragma unroll
      for (int e = 1; e < V; ++e) mx = fmaxf(mx, f[e]);
      if (mx > acc.m) {
        const float a = ex2((acc.m - mx) * kLog2e);  // 0 while acc is empty
        acc.s *= a;
        acc.sx *= a;
        acc.sy *= a;
        acc.sz *= a;
        acc.m = mx;
      }
      float ps = 0.f, pz = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float p = ex2((f[e] - acc.m) * kLog2e);  // m * log2e unrounded
        ps += p;
        pz = fmaf(p, float(e), pz);
      }
      acc.s += ps;
      acc.sx = fmaf(ps, x, acc.sx);
      acc.sy = fmaf(ps, y, acc.sy);
      acc.sz += fmaf(ps, d0, pz);
      x += step_x;  // on to pixel row r + (k + 1) rows: x wraps at most once
      y += step_y;
      if (x >= fwidth) {
        x -= fwidth;
        y += 1.f;
      }
      // the slot, read (its values are in use above), takes vector i + depth
      pf.fetch(w, src, r, v, slot);
      cp_async_commit();
    }

    // the tile partial of joint j: its rows x (D / V) threads' partials,
    // merged by one warp (lane l takes partials l, l + 32, ... in turn,
    // then a shuffle tree); whole warps only
    acc.store_strided(red + t, threads);
    __syncthreads();
    const int per_joint = w.depth / V;
    const int count = per_joint * w.rows;
    for (int j = warp; j < w.joints && whole_warp; j += threads / 32) {
      Partial p;
      for (int q = lane; q < count; q += 32)
        p.merge(Partial::load_strided(
            red + (q / per_joint) * w.n_vec + j * per_joint + q % per_joint, threads));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) merge_lane(p, o);
      if (lane == 0)
        p.store(part + ((size_t(b) * w.joints + j) * w.tiles_per_sample + p0 / kTilePixels) *
                           kPartial);
    }
    __syncthreads();  // the fold has read red
  }
  cp_async_wait<0>();  // no copy outlives the kernel (past the end they are empty groups)
}

// grid (n_tiles, B), block (J * D / V, rows) (block_shape): dx of each
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

// The block shape of both kernels, 11a's as one dimension: (vectors a
// pixel, pixel rows), or dim3(0) where the vectors do not fit one block.
template <typename T>
dim3 block_shape(int joints, int depth, int target = kTargetThreads) {
  constexpr int V = Vec<T>::kN;
  const int n_vec = joints * depth / V;
  if (depth % V != 0 || n_vec > 1024) return dim3(0);
  return dim3(n_vec, n_vec < target ? target / n_vec : 1);  // n_vec * rows <= 1024
}

template <typename T>
cudaError_t launch(const T* logits, float* part, float* out, float* stats, int batch, int height,
                   int width, int joints, int depth, cudaStream_t stream) {
  const dim3 block = block_shape<T>(joints, depth, kFwdThreads);
  if (block.x == 0) return cudaErrorInvalidValue;
  const int pixels = height * width;
  const int tiles_per_sample = (pixels + kTilePixels - 1) / kTilePixels;
  if (static_cast<long long>(batch) * tiles_per_sample > (1 << 30)) return cudaErrorInvalidValue;
  const int threads = block.x * block.y;
  const size_t smem = (size_t(kFwdDepth) * 16 + kPartial * 4) * threads;
  cudaError_t err = cudaFuncSetAttribute(nhwc_stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nhwc_stream_kernel<T>, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = batch * tiles_per_sample;
  const int grid = min(n_tiles, max(1, per_sm) * sms);
  const Walk w{pixels, width, joints, depth, int(block.x), int(block.y), tiles_per_sample,
               n_tiles, 0};
  nhwc_stream_kernel<T><<<grid, threads, smem, stream>>>(logits, part, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = batch * joints;
  merge_kernel<kMergeThreads><<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
      part, tiles_per_sample, n, out, stats);
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
