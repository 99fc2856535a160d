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
// What bounds it on this card: operations. 4 * 1024^2 flops a row, 34.4
// GFLOP at B = 8192: 0.035 ms at 989 TFLOP/s. A call moves x, h twice,
// the residual and out from and to HBM, ~88 MB with the weights: 0.026 ms
// at 3.35 TB/s, so the tensor cores bound it, and only just.
//
// The L2 stream. A tiled GEMM reads each row tile once per column tile and
// each weight slab once per row tile: at B = 8192 with 128 x 128 tiles, A
// 134 MB + W 134 MB = ~0.27 GB a GEMM from L2; with 128 x 256 tiles, A 67
// MB + W 134 MB = ~0.2 GB, ~11.5 TB/s at the full tensor rate (17.4 us a
// GEMM). Measured (experiments/martinez_ablation.py, H100 80GB HBM3, 700
// W): both GEMMs' stream alone, through this kernel's tiles and ring, takes
// 0.045-0.052 ms: 7.8-9.0 TB/s into the SMs. A 2-CTA cluster along M whose
// W chunks came by one TMA multicast for both CTAs halved W's share (67
// MB) but slowed the stream (0.062 ms against 0.052) and the kernel (0.083
// against 0.071): the SMs' intake sets the pace, not L2's reads, and a
// stage shared by two CTAs stays held until both release it. It was left
// out.
//
// Why h goes through device memory. The TPU kernel keeps both 2 MB weight
// matrices and its tile's intermediate in VMEM. An SM's 227 KB holds
// neither matrix; a CTA that kept a 64-row tile's whole h (128 KB) would
// stream all 4 MB of W1 and W2 through every tile, 0.5 GB of L2 reads a
// call at B = 8192. So each block is two launches: (1) GEMM 1 + scale,
// shift, ReLU into a bf16 h scratch that the wrapper allocates, which is
// exact, since the JAX kernel rounds h to bf16 at that very point; (2)
// GEMM 2 + scale, shift, ReLU + the f32 residual add.
//
// The design: each launch is a persistent grid, one CTA an SM, on
// rowtile_sm90.cuh's primitives. A CTA is three warpgroups and computes
// 128 x kN output tiles: kN the widest of 256, 128 and 64 whose tiles fill
// 90% of the SMs (n_tile; on 132 SMs m64n256k16 from B = 3713, m64n64k16
// up to B = 1792, where more CTAs share the weight stream). The producer
// warpgroup (setmaxnreg down) has one thread walk the CTA's tiles (tile t:
// row tile t / (1024 / kN), so the CTAs in flight share row tiles) and
// stream K in chunks of 64 by TMA (128-byte swizzle) into a ring of
// mbarrier-guarded stages: a stage holds the two consumer warpgroups' 64 x
// 64 A boxes (K-major) and a 64 x kN W chunk (kN / 64 boxes, N-major,
// taken with the transpose flag, so no transposed copy of W1 or W2
// exists); 48 KB a stage at kN = 256, three stages. Rows past B arrive as
// zeros (TMA's fill) and are not stored, so no row is repeated. The two consumer
// warpgroups (setmaxnreg up) each own 64 rows, 128 f32 accumulators a
// thread, and hand each chunk's stage back as soon as its four wgmmas
// complete; the other warpgroup's keep the tensor cores busy meanwhile.
//
// The epilogue runs in the accumulator registers: scale, shift (every
// column's, in shared memory, loaded once a CTA) and ReLU without FMA
// contraction (__fmul_rn, __fadd_rn: the plain version rounds the product
// and the sum apart), then, in GEMM 2, the residual added from the
// swizzled position each thread writes; loads kBatch column groups ahead
// of the stores. The bf16 tile goes into an epilogue buffer of its own (64
// KB at kN = 256, apart from the ring, so the next tile's chunks load
// while this one is stored) and out by TMA stores. Each warpgroup's first
// thread refills its half of the buffer with the next tile's residual
// tile by TMA once the last tile's stores have read it (kRefillAt chunks
// into the K loop), so it lands under the products. 217 KB of shared
// memory at kN = 256. No atomics: two calls are bitwise equal.
//
// What holds it back (the same ablation): without the epilogue's
// arithmetic the kernel runs at the stream's pace (0.048 ms against the
// stream's 0.047); the epilogue adds ~0.017 ms that nothing overlaps, as
// both consumer warpgroups share each tile.
//
// Replaced: the first version, two output-stationary launches of 128 x 128
// tiles on 4 warps, ldmatrix + mma.sync m16n8k16 fed by a 4-deep cp.async
// ring with a block-wide barrier per 32-wide K slice, two CTAs an SM:
// 0.128 ms at B = 8192.
//
// The launcher encodes the TMA maps on the host per call (five; 1.5-7 us
// of host time against the first version's launcher at B = 64) and passes
// them as __grid_constant__ parameters, runs on the caller's stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().

#include "rowtile_sm90.cuh"

namespace {

using namespace pose3d;
namespace rt = pose3d::rowtile;

constexpr int kWidth = 1024;                   // F: the row width and both sides of W1, W2
constexpr int kRows = rt::kTileRows;           // 128 rows of an output tile
constexpr int kChunks = kWidth / rt::kBox;     // 16 K chunks of 64 a tile
constexpr int kABytes = rt::kConsumers * rt::kBoxBytes;  // both warpgroups' A boxes: 16 KB
constexpr int kRefillAt = 4;    // the K chunk at which the epilogue buffer refills
constexpr int kBatch = 4;       // 8-column groups whose epilogue loads issue together
constexpr int kMaxRows = 1 << 24;
constexpr int kScaleBytes = 2 * kWidth * 4;  // (scale, shift) of every column, interleaved
constexpr int kBarBytes = 256;

// The shared memory of a 128 x kN tile's launch: 1 KB of alignment slack,
// the ring, the epilogue buffer, the scales and shifts, the barriers.
template <int kN>
struct Tiling {
  static constexpr int kBoxes = kN / rt::kBox;  // W boxes of a stage, output boxes of a warpgroup
  static constexpr int kStageBytes = kABytes + kBoxes * rt::kBoxBytes;
  static constexpr int kWgOutBytes = kBoxes * rt::kBoxBytes;  // a warpgroup's 64 x kN tile
  static constexpr int kOutBytes = rt::kConsumers * kWgOutBytes;
  static constexpr int kFit =
      (kSmemLimit - 1024 - kOutBytes - kScaleBytes - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmem =
      1024 + size_t(kStages) * kStageBytes + kOutBytes + kScaleBytes + kBarBytes;
  static constexpr int kAcc = kN / 2;  // f32 accumulators a thread: 64 x kN on 128 threads
  static_assert(kStages >= 3 && kSmem <= size_t(kSmemLimit), "shared memory");
  static_assert(16 * kStages + 8 * rt::kConsumers <= kBarBytes, "the barriers fit");
};
static_assert(Tiling<256>::kStages == 3 && Tiling<256>::kSmem == 222464 &&
                  Tiling<128>::kStages == 5 && Tiling<64>::kStages == 8,
              "the note's plan");

// acc (+)= A (64 x 64 at a, K-major) @ a 64 x kN W chunk at b (N-major),
// 4 k-steps; the first of a tile (accumulate false) overwrites acc. Issues
// and commits only.
template <int kN>
__device__ __forceinline__ void issue_chunk(float (&acc)[kN / 2], uint32_t a, uint32_t b,
                                            bool accumulate) {
  rt::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t da = rt::desc_a(a + j * 32), db = rt::desc_b(b + j * 2048);
    if constexpr (kN == 256) rt::wgmma_m64n256(acc, da, db, accumulate || j);
    else if constexpr (kN == 128) rt::wgmma_m64n128(acc, da, db, accumulate || j);
    else rt::wgmma_m64n64(acc, da, db, accumulate || j);
  }
  rt::wgmma_commit();
}

// out = bf16(relu(scale * (a @ w) + shift)), or with kResidual
// out = bf16(f32(residual) + relu(scale * (a @ w) + shift)), on 128 x kN
// tiles, tile t of a persistent CTA's walk (blockIdx.x, + gridDim.x, ...)
// at row tile t / (1024 / kN), column tile t % (1024 / kN): a, residual
// and out (n_rows, 1024) bf16 through their TMA maps (boxes of 64 x 64), w
// (1024, 1024).
template <int kN, bool kResidual>
__global__ void __launch_bounds__(rt::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
            const __grid_constant__ CUtensorMap res_map,
            const __grid_constant__ CUtensorMap out_map, const float* __restrict__ scale,
            const float* __restrict__ shift, int n_rows) {
  using T = Tiling<kN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring_p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* out_p = ring_p + T::kStages * T::kStageBytes;
  float* ss = reinterpret_cast<float*>(out_p + T::kOutBytes);  // ss[2c], ss[2c + 1]: column c's
  const uint32_t bars = smem_u32(out_p + T::kOutBytes + kScaleBytes);
  const uint32_t refill = bars + 16 * T::kStages;  // full barrier of each warpgroup's buffer
  if (threadIdx.x == 0) {
    rt::ring_init<T::kStages>(bars);
    for (int w = 0; w < rt::kConsumers; ++w) rt::mbar_init(refill + 8 * w, 1);
    rt::mbar_fence_init();
  }
  for (int c = threadIdx.x; c < kWidth; c += blockDim.x) {
    ss[2 * c] = scale[c];
    ss[2 * c + 1] = shift[c];
  }
  __syncthreads();

  const int col_tiles = kWidth / kN;
  const int n_tiles = (n_rows + kRows - 1) / kRows * col_tiles;
  const int wg = threadIdx.x / 128;
  rt::Ring<T::kStages, T::kStageBytes> ring{smem_u32(ring_p), bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int row0 = t / col_tiles * kRows, col0 = t % col_tiles * kN;
        for (int kc = 0; kc < kChunks; ++kc) {
          uint32_t bar;
          const uint32_t dst = ring.claim(&bar);
#pragma unroll
          for (int w = 0; w < rt::kConsumers; ++w)
            rt::tma_load(dst + w * rt::kBoxBytes, &a_map, bar, kc * rt::kBox,
                         row0 + w * rt::kWgRows);
#pragma unroll
          for (int b = 0; b < T::kBoxes; ++b)
            rt::tma_load(dst + kABytes + b * rt::kBoxBytes, &w_map, bar, col0 + b * rt::kBox,
                         kc * rt::kBox);
        }
      }
    }
  } else {
    rt::regs_inc<rt::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int ra = 16 * warp + lane / 4, q = lane % 4;
    const bool issuer = threadIdx.x % 128 == 0;
    unsigned char* buf = out_p + wg * T::kWgOutBytes;  // this warpgroup's epilogue buffer
    const uint32_t buf_s = smem_u32(buf);
    const uint32_t full = refill + 8 * wg;
    float acc[T::kAcc];
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const int row0 = t / col_tiles * kRows + wg * rt::kWgRows, col0 = t % col_tiles * kN;
#pragma unroll 1
      for (int kc = 0; kc < kChunks; ++kc) {
        if (kc == kRefillAt && issuer) {
          // the last tile's stores have read the buffer: it takes this
          // tile's residual
          rt::tma_store_wait_read();
          if constexpr (kResidual) {
            rt::mbar_expect_tx(full, T::kWgOutBytes);
#pragma unroll
            for (int b = 0; b < T::kBoxes; ++b)
              rt::tma_load(buf_s + b * rt::kBoxBytes, &res_map, full, col0 + b * rt::kBox, row0);
          }
        }
        const uint32_t s = ring.acquire();
        issue_chunk<kN>(acc, s + wg * rt::kBoxBytes, s + kABytes, kc > 0);
        rt::wgmma_wait<0>();  // the other warpgroup's products keep the tensor cores busy
        ring.release(ring.next - 1);
      }
      rt::fence_acc(acc);
      if constexpr (kResidual) rt::mbar_wait(full, it & 1);  // the residual tile has landed
      else rt::wg_sync(wg);  // the issuer has seen the last stores read the buffer

      // acc[4j + 2h + i] is row ra + 8h, column 8j + 2q + i of the tile;
      // its bf16 lies in box j / 8 of the buffer, 16-byte chunk j % 8 of
      // the row. kBatch column groups at a time: their loads (scale and
      // shift of columns c, c + 1; the residual) issue together, then their
      // stores, which the compiler keeps after them (a store may alias).
      auto at = [&](int j, int h) {
        return buf + (j / 8) * rt::kBoxBytes + rt::swz(ra + 8 * h, j % 8) + 4 * q;
      };
#pragma unroll
      for (int jb = 0; jb < kN / 8; jb += kBatch) {
        float4 st[kBatch];
        float2 res[kBatch][2];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          st[u] = *reinterpret_cast<const float4*>(ss + 2 * (col0 + 8 * (jb + u) + 2 * q));
          if constexpr (kResidual) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              res[u][h] = load2(reinterpret_cast<const bf16*>(at(jb + u, h)));
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = jb + u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = fmaxf(__fadd_rn(__fmul_rn(acc[4 * j + 2 * h], st[u].x), st[u].y), 0.f);
            float v1 = fmaxf(__fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], st[u].z), st[u].w), 0.f);
            if constexpr (kResidual) {
              v0 = __fadd_rn(res[u][h].x, v0);
              v1 = __fadd_rn(res[u][h].y, v1);
            }
            rt::st_shared2(at(j, h), v0, v1);
          }
        }
      }
      rt::fence_proxy_async();
      rt::wg_sync(wg);
      if (issuer) {
#pragma unroll
        for (int b = 0; b < T::kBoxes; ++b)
          rt::tma_store(&out_map, buf_s + b * rt::kBoxBytes, col0 + b * rt::kBox, row0);
        rt::tma_store_commit();
      }
    }
    if (issuer) rt::tma_store_wait();
  }
}

// The maps of one launch: A, W, the residual (GEMM 2) and the output.
struct Maps {
  CUtensorMap a, w, res, out;
};

// The N tile for n_rows rows on sms SMs: the widest whose tiles fill at
// least 90% of the SMs, else the narrowest (more CTAs share the weight
// stream).
int n_tile(int n_rows, int sms) {
  const int row_tiles = (n_rows + kRows - 1) / kRows;
  for (int n = 256; n > 64; n /= 2)
    if (10 * row_tiles * (kWidth / n) >= 9 * sms) return n;
  return 64;
}

template <int kN, bool kResidual>
cudaError_t launch(const Maps& m, const float* scale, const float* shift, int n_rows, int sms,
                   cudaStream_t stream) {
  using T = Tiling<kN>;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kN, kResidual>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_rows + kRows - 1) / kRows * (kWidth / kN);
  gemm_kernel<kN, kResidual><<<n_tiles < sms ? n_tiles : sms, rt::kThreads, T::kSmem, stream>>>(
      m.a, m.w, m.res, m.out, scale, shift, n_rows);
  return cudaGetLastError();
}

template <bool kResidual>
cudaError_t launch_gemm(const Maps& m, const float* scale, const float* shift, int n_rows,
                        int sms, cudaStream_t s) {
  switch (n_tile(n_rows, sms)) {
    case 256: return launch<256, kResidual>(m, scale, shift, n_rows, sms, s);
    case 128: return launch<128, kResidual>(m, scale, shift, n_rows, sms, s);
    default: return launch<64, kResidual>(m, scale, shift, n_rows, sms, s);
  }
}

}  // namespace

// x, h, out: (n_rows, 1024) bf16, h a scratch; w1, w2: (1024, 1024) bf16,
// (in, out) row-major; s1, b1, s2, b2: (1024,) f32. Every pointer starts on
// a 16-byte boundary (TMA's rule; a map refuses another). width is the
// caller's idea of the kernel's row width: a mismatch returns
// cudaErrorInvalidValue. Two launches in a row; the first error (of a map's
// encoding, an attribute, a launch) ends the sequence and is returned.
// Launches on the calling thread's current device, which must hold the
// operands.
extern "C" cudaError_t martinez_launch(const void* x, const void* w1, const void* s1,
                                       const void* b1, const void* w2, const void* s2,
                                       const void* b2, void* h, void* out, int n_rows,
                                       int width, void* stream) {
  if (n_rows < 0 || n_rows > kMaxRows || width != kWidth) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* hb = static_cast<const bf16*>(h);
  Maps g1, g2;
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  cudaError_t err = tile_map(&g1.a, xb, n_rows, kWidth, rt::kWgRows);
  if (err == cudaSuccess) err = tile_map(&g1.w, w1b, kWidth, kWidth, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&g1.out, hb, n_rows, kWidth, rt::kWgRows);
  if (err == cudaSuccess) err = tile_map(&g2.w, w2b, kWidth, kWidth, rt::kBox);
  if (err == cudaSuccess)
    err = tile_map(&g2.out, static_cast<const bf16*>(out), n_rows, kWidth, rt::kWgRows);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  g1.res = g1.a;  // GEMM 1 reads no residual
  g2.a = g1.out;  // GEMM 2 reads h
  g2.res = g1.a;  // and adds x
  err = launch_gemm<false>(g1, static_cast<const float*>(s1), static_cast<const float*>(b1),
                           n_rows, sms, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<true>(g2, static_cast<const float*>(s2), static_cast<const float*>(b2),
                           n_rows, sms, s);
}
