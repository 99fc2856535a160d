// The row-wise launches of one pre-LN transformer sub-block on the row-tile
// engine (rowtile_sm90.cuh), shared by the temporal lifter's sub-blocks
// (stblock.cu) and the ViT lifter's trunk (lifter_trunk.cu):
//   qkv_kernel:  y = LN_1(x) (or LN_b(bf16(LN_a(x))), the trunk's double
//                LN); qkv = bf16(y @ W_qkv (+ b_qkv)) -> a global scratch;
//   (the attention of attention.cu runs between them)
//   rest_kernel: x1 = x + bf16(o @ W_proj (+ b_proj)); y2 = LN_2(x1);
//                h = bf16(gelu(bf16(y2 @ W1 + b1)));
//                out = x1 + bf16(h @ W2 + b2)
// on flat (rows, 256) bf16 rows, in 128-row tiles that ignore frame and
// sequence boundaries, one persistent CTA an SM. A row's sums do not depend
// on the tile or the position it lands in (no atomics).
//
// A traits struct T gives the weight layout of one block of the caller's
// flat operand (element offsets: kLn1G/kLn1B the first LN, kLnbG/kLnbB the
// second where kDoubleLn, kWQkv, kBQkv where kQkvBias, kWProj, kBProj where
// kProjBias, kLn2G, kLn2B, kW1, kB1, kW2, kB2) and which of the three
// variations it takes. qkv_kernel can also add a PE table to its input rows
// first (pe[row % kPeRows], rounded to bf16) and store that sum, the
// residual stream, for rest_kernel: the trunk's first block.
//
// Shared memory of a 128-row tile (1 KB of alignment slack, the ring of 32
// KB stages, the 64 KB A operand, the mbarriers):
// - qkv_kernel: A holds y. Each 256-column pass of q|k|v goes from the
//   accumulators (+ bias, bf16) to a 64 KB staging buffer in the swizzled
//   box layout and leaves by TMA stores, which overlap the next pass's
//   products; the staging takes a stage of the ring: 3 stages, 230,448
//   bytes.
// - rest_kernel: A holds the attention tile, then p = bf16(o @ W_proj (+
//   b_proj)), then y2. x1 never takes shared memory of its own: a row pass
//   (each warp its 16 rows, 16-byte loads and stores) forms x1 = x + p,
//   stores it to global (x1 for training, else out), normalises it with
//   warp reductions and writes y2 over p. The MLP runs the hidden in 16
//   chunks of 64 columns: h goes to one of two 16 KB hidden buffers while
//   the previous chunk's h @ W2[chunk, :] accumulates in registers (64 x
//   256 f32 a warpgroup: 128 registers a thread). The result is staged in
//   A and added to x1 in a last row pass. 4 stages: 230,464 bytes.
//
// The launch helpers run on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (or the error of a refused
// configuration).

#pragma once

#include "rowtile_sm90.cuh"

namespace pose3d {
namespace subblock {

namespace rt = pose3d::rowtile;

constexpr int kPeRows = 17;    // the PE table's period: the joints of a frame
constexpr int kQkvStages = 3;  // qkv_kernel's ring: its output staging takes the fourth
constexpr int kRestStages = 4;
constexpr int kHidBytes = rt::kWgRows * 128;        // a warpgroup's 64 x 64 hidden chunk
constexpr int kHidBuf = rt::kConsumers * kHidBytes;  // one of the two hidden buffers
constexpr int kMlpChunks = kMlp / rt::kBox;          // 16
constexpr size_t kSmemQkv = 1024 + size_t(kQkvStages) * rt::kStageBytes + 2 * rt::kActBytes +
                            16 * kQkvStages;
constexpr size_t kSmemRest = 1024 + size_t(kRestStages) * rt::kStageBytes + rt::kActBytes +
                             2 * kHidBuf + 16 * kRestStages;
static_assert(kSmemQkv == 230448 && kSmemRest == 230464, "the plan in the note above");
static_assert(kSmemQkv <= kSmemLimit && kSmemRest <= kSmemLimit,
              "exceeds the per-block shared memory");

// The regions of a tile's shared memory, 1 KB aligned (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): the ring, the A operand, then
// qkv_kernel's output staging (kActBytes) or rest_kernel's two hidden
// buffers, then the mbarriers.
struct Smem {
  unsigned char* ring;
  unsigned char* act;
  unsigned char* extra;
  uint32_t bars;
};

template <int kStages>
__device__ __forceinline__ Smem carve(unsigned char* raw, int extra_bytes) {
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Smem s;
  s.ring = base;
  s.act = base + kStages * rt::kStageBytes;
  s.extra = s.act + rt::kActBytes;
  s.bars = smem_u32(s.extra + extra_bytes);
  return s;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }

__device__ __forceinline__ void st16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// Warp w's 16 rows of a warpgroup's 64 (those past the tile's `rows` as
// zeros): lane l its 16 bytes at column 8l of each.
__device__ __forceinline__ void load_rows(uint4 (&v)[16], const bf16* src, int r0,
                                          int rows, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * warp + i;
    v[i] = r < rows ? ld16(src + size_t(r0 + r) * kDim + 8 * lane) : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// v = LN(v) * g + b in place for one 256-wide row held 8 elements a lane
// (common.cuh's layer_norm_row): f32 statistics, biased variance.
__device__ __forceinline__ void ln8(float (&v)[8], const float (&g)[8], const float (&b)[8]) {
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
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (v[j] - mu) * rstd * g[j] + b[j];
}

// The same with g and b packed bf16 until used (4 registers each, not 8):
// the double LN holds two pairs.
__device__ __forceinline__ void ln8(float (&v)[8], uint4 gp, uint4 bp) {
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
  float g[8], b[8];
  unpack8(gp, g);
  unpack8(bp, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (v[j] - mu) * rstd * g[j] + b[j];
}

using rt::st_shared2;
using rt::stage_acc;

// common.cuh's gelu_poly with its x / sqrt(2) as a multiply and two FMAs:
// the division's value (the residual x - q·sqrt(2) is exact in an FMA),
// without the division's ~10 instructions and slow-path branch, which cost
// rest_kernel a third of its time.
__device__ __forceinline__ float gelu(float x) {
  constexpr float kInvSqrt2 = 0.70710678118654752f;
  const float q = x * kInvSqrt2;
  return x * 0.5f * (1.f + erf_poly(fmaf(fmaf(-q, kSqrt2, x), kInvSqrt2, q)));
}

// h = bf16(gelu(bf16(acc + b1))) of a 64 x 64 hidden chunk into its
// swizzled buffer hb, as the A operand of the W2 product.
__device__ __forceinline__ void gelu_hidden(const float (&acc)[32], unsigned char* hb,
                                            const bf16* __restrict__ b1, int ra, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bv = load2(b1 + 8 * j + 2 * q);
    st_shared2(hb + rt::swz(ra, j) + 4 * q, gelu(round_bf16(acc[4 * j] + bv.x)),
               gelu(round_bf16(acc[4 * j + 1] + bv.y)));
    st_shared2(hb + rt::swz(ra + 8, j) + 4 * q, gelu(round_bf16(acc[4 * j + 2] + bv.x)),
               gelu(round_bf16(acc[4 * j + 3] + bv.y)));
  }
}

// Row passes: warp w walks its own 16 rows of the warpgroup's 64 (the rows
// its wgmma reads and writes), lane l columns 8l ... 8l + 7, which lie in
// 16-byte chunk l % 8 of K block l / 8 of the swizzled A layout. The row
// loads are issued together, so their latency is paid once.

// LN + qkv on 128-row tiles: x (n_rows, 256) -> q|k|v (n_rows, 768) bf16,
// stored by TMA through `out` (boxes of 64 x 64) from a staging buffer.
// Where kPe, the rows are x + pe[row % kPeRows] (bf16), and that sum is
// stored to x_out.
template <class T, bool kPe>
__global__ void __launch_bounds__(rt::kThreads, 1)
qkv_kernel(const __grid_constant__ CUtensorMap w_qkv, const __grid_constant__ CUtensorMap out,
           const bf16* __restrict__ x, const bf16* __restrict__ weights,
           const bf16* __restrict__ pe, bf16* __restrict__ x_out, int n_rows) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = carve<kQkvStages>(smem_raw, rt::kActBytes);
  if (threadIdx.x == 0) rt::ring_init<kQkvStages>(sm.bars);
  __syncthreads();
  const int n_tiles = (n_rows + rt::kTileRows - 1) / rt::kTileRows;
  const int wg = threadIdx.x / 128;
  rt::Ring<kQkvStages> ring{smem_u32(sm.ring), sm.bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int pass = 0; pass < kQkv / kDim; ++pass)
          for (int kc = 0; kc < kDim / rt::kBox; ++kc)
            rt::load_wide(ring, &w_qkv, pass * kDim, kc * rt::kBox);
    }
  } else {
    rt::regs_inc<rt::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int ra = 16 * warp + lane / 4, q = lane % 4;
    const bool issuer = threadIdx.x % 128 == 0;
    unsigned char* a = sm.act + wg * rt::kWgActBytes;
    unsigned char* stage = sm.extra + wg * rt::kWgActBytes;
    const uint32_t stage_s = smem_u32(stage);
    float acc[128];  // one array for every pass: HGMMA takes it as one register block
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = tile * rt::kTileRows + wg * rt::kWgRows;
      const int rows = min(rt::kWgRows, max(0, n_rows - r0));
      // y = LN(x) into A (a missing row normalises zeros, or the PE: no
      // shuffle sits in a divergent branch)
      float g[8], b[8];  // the single LN's parameters
      if constexpr (!T::kDoubleLn) {
        load8(weights + T::kLn1G + 8 * lane, g);
        load8(weights + T::kLn1B + 8 * lane, b);
      }
      uint4 xv[16];
      load_rows(xv, x, r0, rows, warp, lane);
      if constexpr (kPe) {  // x = bf16(x + pe), the residual stream, to x_out
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = 16 * warp + i;
          float v[8], p[8];
          unpack8(xv[i], v);
          unpack8(ld16(pe + ((r0 + r) % kPeRows) * kDim + 8 * lane), p);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += p[j];
          xv[i] = pack8(v);
          if (r < rows) st16(x_out + size_t(r0 + r) * kDim + 8 * lane, xv[i]);
        }
      }
      if constexpr (T::kDoubleLn) {
        // LN_b(bf16(LN_a(x))), the second LN in registers on the row the
        // warp holds; the four parameter rows stay packed
        const uint4 ga = ld16(weights + T::kLn1G + 8 * lane);
        const uint4 ba = ld16(weights + T::kLn1B + 8 * lane);
        const uint4 gb = ld16(weights + T::kLnbG + 8 * lane);
        const uint4 bb = ld16(weights + T::kLnbB + 8 * lane);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float v[8];
          unpack8(xv[i], v);
          ln8(v, ga, ba);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = round_bf16(v[j]);
          ln8(v, gb, bb);
          st16(reinterpret_cast<bf16*>(a + rt::a_offset(16 * warp + i, 8 * lane)), pack8(v));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float v[8];
          unpack8(xv[i], v);
          ln8(v, g, b);
          st16(reinterpret_cast<bf16*>(a + rt::a_offset(16 * warp + i, 8 * lane)), pack8(v));
        }
      }
      rt::fence_proxy_async();
      rt::wg_sync(wg);
      if constexpr (T::kDoubleLn) {
        // the first pass overwrites acc; zeroing it (a few moves) tells the
        // compiler so, which frees its registers for the double LN above
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      }
      for (int pass = 0; pass < kQkv / kDim; ++pass) {
        rt::gemm_wide<kDim / rt::kBox>(acc, smem_u32(a), ring);
        if (issuer) rt::tma_store_wait_read();  // the last pass's stores have read the staging
        rt::wg_sync(wg);
        stage_acc<T::kQkvBias>(acc, stage, weights + T::kBQkv + pass * kDim, ra, q);
        rt::fence_proxy_async();
        rt::wg_sync(wg);
        if (issuer && rows > 0) {
          for (int bx = 0; bx < kDim / rt::kBox; ++bx)
            rt::tma_store(&out, stage_s + bx * rt::kKBlockBytes, pass * kDim + bx * rt::kBox, r0);
          rt::tma_store_commit();
        }
      }
    }
    if (issuer) rt::tma_store_wait();
  }
}

// Projection + residual, LN_2 + MLP + residual on 128-row tiles: x, attn
// (n_rows, 256) -> out; kSave also keeps x1 in x1_out (serving parks x1 in
// out, which the last residual overwrites: the same thread reads and
// writes each element). x must not alias out.
template <class T, bool kSave>
__global__ void __launch_bounds__(rt::kThreads, 1)
rest_kernel(const __grid_constant__ CUtensorMap w_proj, const __grid_constant__ CUtensorMap w1,
            const __grid_constant__ CUtensorMap w2, const bf16* __restrict__ x,
            const bf16* __restrict__ weights, const bf16* __restrict__ attn, bf16* out,
            bf16* x1_out, int n_rows) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = carve<kRestStages>(smem_raw, 2 * kHidBuf);
  if (threadIdx.x == 0) rt::ring_init<kRestStages>(sm.bars);
  __syncthreads();
  const int n_tiles = (n_rows + rt::kTileRows - 1) / rt::kTileRows;
  const int wg = threadIdx.x / 128;
  rt::Ring<kRestStages> ring{smem_u32(sm.ring), sm.bars, 0};
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      // per tile, in consumption order: W_proj by 64 rows; W1's first 64
      // columns; then W1's next 64 columns beside W2's previous 64 rows
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int kc = 0; kc < kDim / rt::kBox; ++kc)
          rt::load_wide(ring, &w_proj, 0, kc * rt::kBox);
        rt::load_tall(ring, &w1, 0);
        for (int h = 0; h < kMlpChunks; ++h) {
          if (h + 1 < kMlpChunks) rt::load_tall(ring, &w1, (h + 1) * rt::kBox);
          rt::load_wide(ring, &w2, 0, h * rt::kBox);
        }
      }
    }
  } else {
    rt::regs_inc<rt::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int ra = 16 * warp + lane / 4, q = lane % 4;
    unsigned char* a = sm.act + wg * rt::kWgActBytes;
    const uint32_t a_s = smem_u32(a);
    unsigned char* hid = sm.extra + wg * kHidBytes;  // buffer k at hid + k * kHidBuf
    bf16* x1 = kSave ? x1_out : out;
    // one 64 x 256 accumulator for the projection and the W2 product: HGMMA
    // takes it as one block of 128 registers, and two such blocks do not fit
    float acc[128], acch[32];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = tile * rt::kTileRows + wg * rt::kWgRows;
      const int rows = min(rt::kWgRows, max(0, n_rows - r0));
      uint4 xv[16];
      load_rows(xv, attn, r0, rows, warp, lane);  // the attention rows into A
#pragma unroll
      for (int i = 0; i < 16; ++i)
        st16(reinterpret_cast<bf16*>(a + rt::a_offset(16 * warp + i, 8 * lane)), xv[i]);
      rt::fence_proxy_async();
      rt::wg_sync(wg);
      load_rows(xv, x, r0, rows, warp, lane);  // x, in flight during the projection

      // p = bf16(o @ W_proj (+ b_proj)) into A; then, row by row, x1 =
      // bf16(x + p) to global and y2 = LN_2(x1) into A in its place
      rt::gemm_wide<kDim / rt::kBox>(acc, a_s, ring);
      stage_acc<T::kProjBias>(acc, a, weights + T::kBProj, ra, q);
      __syncwarp();
      {
        float g[8], b[8];
        load8(weights + T::kLn2G + 8 * lane, g);
        load8(weights + T::kLn2B + 8 * lane, b);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = 16 * warp + i;
          bf16* pa = reinterpret_cast<bf16*>(a + rt::a_offset(r, 8 * lane));
          float v[8], pv[8];
          unpack8(xv[i], v);
          unpack8(ld16(pa), pv);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = round_bf16(v[j] + pv[j]);
          if (r < rows) st16(x1 + size_t(r0 + r) * kDim + 8 * lane, pack8(v));
          ln8(v, g, b);
          st16(pa, pack8(v));
        }
      }
      rt::fence_proxy_async();
      rt::wg_sync(wg);

      // the MLP, 64 hidden columns at a time: chunk h + 1's W1 product and
      // chunk h's W2 product in flight together; the GELU of h + 1 runs
      // while the tensor cores finish h's
      rt::issue_tall(acch, a_s, ring.acquire());
      rt::wgmma_wait<0>();
      ring.release(ring.next - 1);
      rt::fence_acc(acch);
      gelu_hidden(acch, hid, weights + T::kB1, ra, q);
      rt::fence_proxy_async();
      rt::wg_sync(wg);
      int w_prev = -1;
#pragma unroll 1
      for (int h = 0; h + 1 < kMlpChunks; ++h) {
        const int t_chunk = ring.next;
        rt::issue_tall(acch, a_s, ring.acquire());
        const int w_chunk = ring.next;
        rt::issue_wide64(acc, smem_u32(hid + (h % 2) * kHidBuf), ring.acquire(), h > 0);
        rt::wgmma_wait<1>();  // W1 chunk h + 1 and W2 chunk h - 1 are done
        ring.release(t_chunk);
        if (h > 0) ring.release(w_prev);
        rt::fence_acc(acch);
        gelu_hidden(acch, hid + ((h + 1) % 2) * kHidBuf, weights + T::kB1 + (h + 1) * rt::kBox,
                    ra, q);
        rt::fence_proxy_async();
        rt::wg_sync(wg);
        w_prev = w_chunk;
      }
      const int w_last = ring.next;
      rt::issue_wide64(acc, smem_u32(hid + ((kMlpChunks - 1) % 2) * kHidBuf), ring.acquire(),
                       true);
      rt::wgmma_wait<0>();
      ring.release(w_prev);
      ring.release(w_last);
      rt::fence_acc(acc);

      // out = x1 + bf16(h @ W2 + b2): staged in A (every wgmma reading it
      // has completed), added row by row to x1 where this thread stored it
      stage_acc<true>(acc, a, weights + T::kB2, ra, q);
      __syncwarp();
      load_rows(xv, x1, r0, rows, warp, lane);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = 16 * warp + i;
        float v[8], sv[8];
        unpack8(xv[i], v);
        unpack8(ld16(reinterpret_cast<const bf16*>(a + rt::a_offset(r, 8 * lane))), sv);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += sv[j];
        if (r < rows) st16(out + size_t(r0 + r) * kDim + 8 * lane, pack8(v));
      }
      // the next tile's attention rows overwrite this warp's rows of A only
      // after the warp has read them back (program order)
    }
  }
}

// The TMA maps of one block's launches: its four weight matrices (W1 in
// tall 256 x 64 boxes, the others in 64 x 64 boxes) at w, and the qkv
// scratch of n_rows rows that qkv_kernel stores to.
struct Maps {
  CUtensorMap w_qkv, qkv, w_proj, w1, w2;
};

template <class T>
cudaError_t make_maps(Maps* m, const bf16* w, bf16* qkv, int n_rows) {
  static_assert(T::kWQkv * 2 % 16 == 0 && T::kWProj * 2 % 16 == 0 && T::kW1 * 2 % 16 == 0 &&
                    T::kW2 * 2 % 16 == 0 && T::kElems * 2 % 16 == 0,
                "every weight matrix of every block starts on a 16-byte boundary (TMA)");
  cudaError_t err = tile_map(&m->w_qkv, w + T::kWQkv, kDim, kQkv, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&m->qkv, qkv, n_rows, kQkv, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&m->w_proj, w + T::kWProj, kDim, kDim, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&m->w1, w + T::kW1, kDim, kMlp, kDim);
  if (err == cudaSuccess) err = tile_map(&m->w2, w + T::kW2, kMlp, kDim, rt::kBox);
  return err;
}

inline int n_tiles(int n_rows) { return (n_rows + rt::kTileRows - 1) / rt::kTileRows; }

template <class T, bool kPe>
cudaError_t launch_qkv(const Maps& m, const bf16* x, const bf16* w, const bf16* pe, bf16* x_out,
                       int n_rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel<T, kPe>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemQkv));
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(n_tiles(n_rows), &grid);
  if (err != cudaSuccess) return err;
  qkv_kernel<T, kPe><<<grid, rt::kThreads, kSmemQkv, stream>>>(m.w_qkv, m.qkv, x, w, pe,
                                                                x_out, n_rows);
  return cudaGetLastError();
}

template <class T, bool kSave>
cudaError_t launch_rest(const Maps& m, const bf16* x, const bf16* w, const bf16* attn, bf16* out,
                        bf16* x1, int n_rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rest_kernel<T, kSave>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemRest));
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(n_tiles(n_rows), &grid);
  if (err != cudaSuccess) return err;
  rest_kernel<T, kSave><<<grid, rt::kThreads, kSmemRest, stream>>>(m.w_proj, m.w1, m.w2, x, w,
                                                                    attn, out, x1, n_rows);
  return cudaGetLastError();
}

}  // namespace subblock
}  // namespace pose3d
