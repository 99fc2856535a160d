// The two halves of the temporal lifter's SpatioTemporalBlock for Hopper
// (sm_90a): one pre-LN transformer sub-block
//   y = LN_1(x); qkv = bf16(y @ W_qkv + b_qkv);
//   o = 8-head x 32 attention (per frame over its 17 joints, or per joint
//       over the clip's T frames);
//   x1 = x + bf16(o @ W_proj + b_proj);  y2 = LN_2(x1);
//   h = bf16(gelu(bf16(y2 @ W1 + b1)));  out = x1 + bf16(h @ W2 + b2)
// on flat (rows, 256) bf16 token rows, frame-major: row (c·T + t)·17 + j is
// joint j of frame t of clip c. Rounding as in the JAX kernels: f32
// accumulation and LayerNorm statistics, bf16 activations (qkv, the
// attention output, the residual stream), bf16(gelu_poly(bf16(·))) for the
// hidden (common.cuh's polynomial GELU), the clamped softmax of
// attention.cuh.
//
// Replaces three TPU kernels of pose3d_tpu/ops/pallas_stblock.py, and their
// training forwards in pallas_stblock_train.py, with one launch sequence:
// (1) qkv_kernel: LN_1 + qkv on 128-row tiles -> a global qkv scratch;
// (2) the attention kernel of attention.cu, one block per (sequence, head)
//     -> a global attention scratch;
// (3) rest_kernel: projection + residual, LN_2 + MLP + residual on 128-row
//     tiles.
// Phases (1) and (3) are row-wise: their tiles ignore frame and sequence
// boundaries, and a row's sums do not depend on the tile or the position it
// lands in (no atomics), so any layout of the same tokens gives the same bits.
// - _spatial_kernel (spatial_block_fused): frames are contiguous sequences
//   of L = 17 rows, so the spatial half is stblock_sequences_launch with
//   L = 17, its attention the launch that serves packed_flat_attention.
// - _temporal_slab_kernel (temporal_slab_fused): stblock_temporal_launch,
//   the attention reading joint j of clip c at rows c·T·17 + t·17 + j.
// - _temporal_kernel (temporal_block_fused :161, joint-major (L, 256)
//   sequences): stblock_sequences_launch; each sequence reads its rows in
//   the slab's order, so the two layouts of the same tokens give the same
//   bits.
// The training forwards (pallas_stblock_train.py _spatial_fwd_kernel :348,
// _temporal_fwd_kernel :379, _temporal_slab_fwd_kernel :407) are the same
// launchers given an x1 pointer, which selects rest_kernel<kSave>: it stores
// x1 there; the attention scratch is the backward's att.
//
// What bounds it on this card. At 16 clips x 243 frames (66,096 rows) the
// four products are 2 · 66,096 · 786,432 = 104 GFLOP, 0.105 ms at 989
// TFLOP/s; the three launches move ~0.37 GB through HBM (x twice, qkv and
// the attention output written and read, out once), 0.11 ms at 3.35 TB/s;
// every tile streams the sub-block's 1.57 MB of weights from L2 (0.81 GB a
// call at 517 tiles). The first design (common.cuh's 80-row engine:
// ldmatrix + mma.sync, 8 warps, a block-wide barrier per weight chunk,
// LayerNorm and epilogues between barriers) ran at ~12% of the tensor
// rate: without its weight loads it lost 18% of its time, without its MMAs
// 10% (chip_smoke.py --forward-split on an H100 80GB HBM3 at 700 W), so
// latency and serialisation inside the one CTA an SM set its pace. This
// design (rowtile_sm90.cuh) keeps the tensor cores fed instead: a producer
// warp streams 32 KB weight chunks by TMA into a 3- or 4-stage mbarrier
// ring, two consumer warpgroups run wgmma on 64 rows each with one chunk's
// group in flight while the next is issued, and the grid is persistent
// (one CTA an SM walking tiles), so a tile's loads and stores overlap the
// next tile's first chunks.
//
// Shared memory of a 128-row tile (1 KB of alignment slack, the ring of 32
// KB stages, the 64 KB A operand, the mbarriers):
// - qkv_kernel: A holds y = LN_1(x). Each 256-column pass of q|k|v goes
//   from the accumulators (+ bias, bf16) to a 64 KB staging buffer in the
//   swizzled box layout and leaves by TMA stores, which overlap the next
//   pass's products; the staging takes a stage of the ring: 3 stages,
//   230,448 bytes.
// - rest_kernel: A holds the attention tile, then p = bf16(o @ W_proj +
//   b_proj), then y2. x1 never takes shared memory of its own: a row pass
//   (each warp its 16 rows, 16-byte loads and stores) forms x1 = x + p,
//   stores it to global (x1 for training, else out), normalises it with
//   warp reductions and writes y2 over p. The MLP runs the hidden in 16
//   chunks of 64 columns: h = bf16(gelu(bf16(y2 @ W1[:, chunk] + b1))) goes
//   to one of two 16 KB hidden buffers while the previous chunk's h @
//   W2[chunk, :] accumulates in registers (64 x 256 f32 a warpgroup: 128
//   registers a thread). The result is staged in A and added to x1 in a
//   last row pass. 4 stages: 230,464 bytes.
// A fused spatial kernel on this engine does not fit: a 128-row tile holds
// 7 whole frames (119 rows), but their q|k|v (128 x 768 bf16, 192 KB) with
// y (64 KB) is 256 KB before the ring, past the 227 KB a block can have.
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (or the error of a tensor map
// that could not be built, or of a refused configuration).

#include "attention.cuh"
#include "rowtile_sm90.cuh"

namespace {

using namespace pose3d;
namespace rt = pose3d::rowtile;

constexpr int kHeads = 8;
constexpr int kDimHead = kDim / kHeads;

// Layout of one sub-block in the flat weight operand; must match
// ops/stblock.py::_LAYOUT (the launchers check the total), which follows
// pallas_stblock.pack_spatial_weights / pack_temporal_weights.
// Matrices are (in, out), row-major.
constexpr int kOffLn1G = 0;
constexpr int kOffLn1B = kOffLn1G + kDim;
constexpr int kOffWQkv = kOffLn1B + kDim;
constexpr int kOffBQkv = kOffWQkv + kDim * kQkv;
constexpr int kOffWProj = kOffBQkv + kQkv;
constexpr int kOffBProj = kOffWProj + kDim * kDim;
constexpr int kOffLn2G = kOffBProj + kDim;
constexpr int kOffLn2B = kOffLn2G + kDim;
constexpr int kOffW1 = kOffLn2B + kDim;
constexpr int kOffB1 = kOffW1 + kDim * kMlp;
constexpr int kOffW2 = kOffB1 + kMlp;
constexpr int kOffB2 = kOffW2 + kMlp * kDim;
constexpr int kBlockElems = kOffB2 + kDim;
static_assert(kOffWQkv * 2 % 16 == 0 && kOffWProj * 2 % 16 == 0 && kOffW1 * 2 % 16 == 0 &&
                  kOffW2 * 2 % 16 == 0 && kBlockElems * 2 % 16 == 0,
              "every weight matrix of every block starts on a 16-byte boundary (TMA)");

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

__device__ __forceinline__ void st_shared2(unsigned char* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The accumulator layout of m64nNk16 (per warpgroup): warp w, lane l holds
// rows ra = 16w + l/4 and ra + 8, columns 8j + 2(l%4) and + 1, in
// acc[4j], acc[4j + 1] (row ra) and acc[4j + 2], acc[4j + 3] (row ra + 8).

// bf16(acc + bias) of a 64 x 256 accumulator into 128-byte-swizzled boxes of
// 64 columns, kKBlockBytes apart: a warpgroup's A layout, and TMA's.
__device__ __forceinline__ void stage_acc(const float (&acc)[128], unsigned char* dst,
                                          const bf16* __restrict__ bias, int ra, int q) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 bv = load2(bias + 8 * j + 2 * q);
    unsigned char* p = dst + (j / 8) * rt::kKBlockBytes + 4 * q;
    st_shared2(p + rt::swz(ra, j % 8), acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
    st_shared2(p + rt::swz(ra + 8, j % 8), acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
  }
}

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

// LN_1 + qkv on 128-row tiles: x (n_rows, 256) -> q|k|v (n_rows, 768) bf16,
// stored by TMA through `out` (boxes of 64 x 64) from a staging buffer.
__global__ void __launch_bounds__(rt::kThreads, 1)
qkv_kernel(const __grid_constant__ CUtensorMap w_qkv, const __grid_constant__ CUtensorMap out,
           const bf16* __restrict__ x, const bf16* __restrict__ weights, int n_rows) {
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
      // y = LN_1(x) into A (a missing row normalises zeros: no shuffle
      // sits in a divergent branch)
      float g[8], b[8];
      load8(weights + kOffLn1G + 8 * lane, g);
      load8(weights + kOffLn1B + 8 * lane, b);
      uint4 xv[16];
      load_rows(xv, x, r0, rows, warp, lane);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float v[8];
        unpack8(xv[i], v);
        ln8(v, g, b);
        st16(reinterpret_cast<bf16*>(a + rt::a_offset(16 * warp + i, 8 * lane)), pack8(v));
      }
      rt::fence_proxy_async();
      rt::wg_sync(wg);
      for (int pass = 0; pass < kQkv / kDim; ++pass) {
        rt::gemm_wide<kDim / rt::kBox>(acc, smem_u32(a), ring);
        if (issuer) rt::tma_store_wait_read();  // the last pass's stores have read the staging
        rt::wg_sync(wg);
        stage_acc(acc, stage, weights + kOffBQkv + pass * kDim, ra, q);
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
// writes each element).
template <bool kSave>
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

      // p = bf16(o @ W_proj + b_proj) into A; then, row by row, x1 = bf16(x +
      // p) to global and y2 = LN_2(x1) into A in its place
      rt::gemm_wide<kDim / rt::kBox>(acc, a_s, ring);
      stage_acc(acc, a, weights + kOffBProj, ra, q);
      __syncwarp();
      {
        float g[8], b[8];
        load8(weights + kOffLn2G + 8 * lane, g);
        load8(weights + kOffLn2B + 8 * lane, b);
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
      gelu_hidden(acch, hid, weights + kOffB1, ra, q);
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
        gelu_hidden(acch, hid + ((h + 1) % 2) * kHidBuf, weights + kOffB1 + (h + 1) * rt::kBox,
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
      stage_acc(acc, a, weights + kOffB2, ra, q);
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

int n_tiles(int n_rows) { return (n_rows + rt::kTileRows - 1) / rt::kTileRows; }

cudaError_t launch_qkv(const CUtensorMap& w_qkv, const CUtensorMap& out, const bf16* x,
                       const bf16* w, int n_rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemQkv));
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(n_tiles(n_rows), &grid);
  if (err != cudaSuccess) return err;
  qkv_kernel<<<grid, rt::kThreads, kSmemQkv, stream>>>(w_qkv, out, x, w, n_rows);
  return cudaGetLastError();
}

template <bool kSave>
cudaError_t launch_rest(const CUtensorMap& w_proj, const CUtensorMap& w1, const CUtensorMap& w2,
                        const bf16* x, const bf16* w, const bf16* attn, bf16* out, bf16* x1,
                        int n_rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rest_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemRest));
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(n_tiles(n_rows), &grid);
  if (err != cudaSuccess) return err;
  rest_kernel<kSave><<<grid, rt::kThreads, kSmemRest, stream>>>(w_proj, w1, w2, x, w, attn, out,
                                                                 x1, n_rows);
  return cudaGetLastError();
}

// The sub-block's three launches on n_rows rows that hold n_seq sequences
// of L rows, laid out for the attention as `in` (qkv) and `o` (attn) say; a
// non-null x1 selects the kSave kernel.
cudaError_t launch_sequences(const void* x, const void* weights, void* qkv, void* attn, void* x1,
                             void* out, int n_rows, int n_seq, int L, int inner_n, SeqLayout in,
                             SeqLayout o, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(weights);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  // W1 in tall 256 x 64 boxes, the other maps in 64 x 64 boxes
  CUtensorMap m_qkv, m_out, m_proj, m_w1, m_w2;
  cudaError_t err = tile_map(&m_qkv, wb + kOffWQkv, kDim, kQkv, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&m_out, qkvb, n_rows, kQkv, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&m_proj, wb + kOffWProj, kDim, kDim, rt::kBox);
  if (err == cudaSuccess) err = tile_map(&m_w1, wb + kOffW1, kDim, kMlp, kDim);
  if (err == cudaSuccess) err = tile_map(&m_w2, wb + kOffW2, kMlp, kDim, rt::kBox);
  if (err == cudaSuccess) err = launch_qkv(m_qkv, m_out, xb, wb, n_rows, s);
  if (err == cudaSuccess)
    err = launch_attention(qkvb, attnb, n_seq, L, kHeads, kDimHead, inner_n, in, o, s);
  if (err != cudaSuccess) return err;
  if (x1 == nullptr)
    return launch_rest<false>(m_proj, m_w1, m_w2, xb, wb, attnb, static_cast<bf16*>(out),
                              nullptr, n_rows, s);
  return launch_rest<true>(m_proj, m_w1, m_w2, xb, wb, attnb, static_cast<bf16*>(out),
                           static_cast<bf16*>(x1), n_rows, s);
}

}  // namespace

// x, out: (n_clips, T, 17 * 256) bf16, the frame-major slab; qkv:
// (n_clips * T * 17, 768) and attn: (n_clips * T * 17, 256) bf16 scratch.
// Three launches in a row (see above); the first error ends the sequence
// and is returned. x1 is null for serving; the training forward passes
// it, shaped like x, and keeps attn as its att residual. block_elems is
// the caller's idea of the layout's size: a mismatch returns
// cudaErrorInvalidValue. Launches on the calling thread's current device,
// which must hold the operands.
extern "C" cudaError_t stblock_temporal_launch(const void* x, const void* weights, void* qkv,
                                               void* attn, void* x1, void* out, int n_clips,
                                               int T, int block_elems, void* stream) {
  constexpr int kJoints = 17;
  if (n_clips < 0 || T < 1 || static_cast<long long>(n_clips) * T * kJoints > (1 << 30) ||
      block_elems != kBlockElems)
    return cudaErrorInvalidValue;
  if (n_clips == 0) return cudaSuccess;
  // sequence (c, j): rows c·T·17 + t·17 + j for t < T
  const long long frame = static_cast<long long>(kJoints);
  return launch_sequences(x, weights, qkv, attn, x1, out, n_clips * T * kJoints,
                          n_clips * kJoints, T, kJoints, {T * frame * kQkv, kQkv, frame * kQkv},
                          {T * frame * kDim, kDim, frame * kDim}, stream);
}

// x, out: (n_seqs, L, 256) bf16, contiguous sequences: sequence s is rows
// s·L ... s·L + L - 1 (the spatial half: n_seqs frames of L = 17 joints;
// the joint-major temporal half: n_seqs joints of L frames); qkv: (n_seqs *
// L, 768) and attn: (n_seqs * L, 256) bf16 scratch. The same three
// launches as stblock_temporal_launch, and the same meaning of x1 and of
// the returned error; an L whose K and V do not fit in shared memory
// returns cudaErrorInvalidValue.
extern "C" cudaError_t stblock_sequences_launch(const void* x, const void* weights, void* qkv,
                                                void* attn, void* x1, void* out, int n_seqs,
                                                int L, int block_elems, void* stream) {
  if (n_seqs < 0 || L < 1 || static_cast<long long>(n_seqs) * L > (1 << 30) ||
      block_elems != kBlockElems)
    return cudaErrorInvalidValue;
  if (n_seqs == 0) return cudaSuccess;
  const long long len = L;
  return launch_sequences(x, weights, qkv, attn, x1, out, n_seqs * L, n_seqs, L, 1,
                          {len * kQkv, 0, kQkv}, {len * kDim, 0, kDim}, stream);
}
