// Multi-head self-attention over [q | k | v] rows for Hopper (sm_90a).
//
// Replaces two TPU kernels of pose3d_tpu/ops/pallas_attention.py:
// _packed_kernel (entered through packed_flat_attention: n sequences of
// seq <= 64 rows packed into one block-diagonal product, to fill the TPU's
// 128-wide matrix unit) and _seq_kernel (entered through seq_attention: one
// L-row sequence per grid cell, L = 243 on the temporal axis). On this card
// the packing has no purpose: both are the same function on the same bytes
// ((n, L, 3·dim) contiguous rows are (n·L, 3·dim) flat rows), so
// launch_attention serves both wrappers of ops/attention.py, the lifter
// trunk (L = 17) and the sub-blocks of stblock.cu (the spatial half's L =
// 17, the temporal half's L = T in the slab and the joint-major layouts).
// Two routes, split at kAttnSplitLen (attention.cuh, 64):
// - L <= 64: attention_kernel, one block per (sequence, head) on mma.sync;
// - L > 64: attention_wg_kernel, 64-query wgmma tiles fed by TMA maps of
//   both sequence layouts.
//
// What bounds it on this card. Per token it reads 3·dim bf16 and writes
// dim, and does 4·L·dim flops: at L = 17 that is ~9 flops a byte, far below
// the H100's ~295 bf16 tensor flops per byte of HBM; at L = 243 ~120, still
// below it. So it is bound by bytes: at 272 sequences x 243 x (8 x 32) a
// call reads 101.5 MB and writes 33.8 MB, 0.040 ms at 3.35 TB/s. Beside the
// bytes, the exp of every score (L^2 per head, 128.5 M at that shape, 142.6
// M over whole 16-key blocks) runs on the SFU, whose 16 results a clock an
// SM take 0.031-0.034 ms: the two floors are close, so a kernel has to keep
// loads, products and exps in flight at once.
//
// attention_kernel (L <= 64, on pre-Hopper primitives) keeps latency
// hidden rather than bytes low (qkv is read once, the output written once):
// - Q never enters shared memory: each warp loads the A fragments of its
//   16-row query tiles straight from device memory into registers. Shared
//   memory holds K and V only, and three 8-warp blocks share an SM, held
//   there by the register file at 80 registers a thread.
// - K and V land by cp.async in kAttnStages commit groups of key blocks;
//   a warp multiplies the keys of a group as soon as it has landed.
// - Only the last, ragged 16-key block is masked.
// - e = 2^(min(s·scale·log2 e, 80·log2 e)) on the SFU's ex2 with the scale
//   folded into one multiply: the same exp(min(s·scale, 80)) to well
//   within the rounding of bf16(e).
// Each warp takes query tiles warp, warp + warps, ...; a block has
// min(8, tiles) warps (L = 17: 2 warps). At L = 243 this design ran at
// 38% of its byte bound (0.105 ms on an H100 80GB HBM3 at 700 W): each
// 16-row query tile re-read all of K and V through ldmatrix (1.11 GB of
// shared-memory reads a call), its Q came from device memory 4 bytes at a
// time, each block paid its own K/V prologue, and a warp's products and
// exps ran one after the other.
//
// attention_wg_kernel (L > 64) is flash_attention.cu's query-major engine
// (14a) on attention_sm90.cuh's head tiles, with the clamped softmax:
// - a persistent CTA an SM walks work items of 128 query rows of one
//   (sequence, head): a producer warpgroup (setmaxnreg down) whose one
//   thread issues each item's Q tile by TMA into one of two slots, then
//   its K and V tiles of 128 keys into a 160 KB mbarrier ring (10 stages
//   at dh = 32); it waits only for free slots and stages, so the next
//   items' loads run under this one's work. Two consumer warpgroups
//   (setmaxnreg up) own 64 query rows each and share every K/V stage: K
//   and V are read from shared memory once a 64-query tile, a quarter as
//   often as by 16-row tiles.
// - the operands are TMA maps over the sequence layout as it lies (q, k
//   and v at columns h·dh, dim + h·dh and 2·dim + h·dh of the [q|k|v]
//   rows): contiguous (N, L, 3·dim) rows a 3-D map (columns, rows,
//   sequences), the slab's sequence (c, j) a 4-D map (columns, frames 17
//   rows apart, joints, clips). Rows past L arrive as zeros and no box
//   reads into the next sequence.
// - S = Q K^T on wgmma with both operands from shared memory; e goes from
//   the accumulators to bf16 A fragments in registers, and P V runs with
//   V taken N-major through the transpose flag. The clamped softmax has no
//   row max, so nothing is rescaled between key tiles: the loop only adds
//   e·V and the f32 row sums. Tile j's S and tile j - 1's P V go out
//   together, and tile j's exps run while P V is on the tensor cores; the
//   other warpgroup's exps fill the rest.
// - an item's first S goes out beside the last item's last P V and runs
//   under its epilogue (each item's first P V overwrites the accumulators,
//   so no register of a product in flight is written by another
//   instruction); each thread stores its output rows at their head
//   columns, writing nothing past L.
// Measured at 272 x 243 x 8 x 32 (H100 80GB HBM3, 700 W;
// experiments/attention_fwd_ab.py, experiments/attention_phase_stamps.py):
// 0.088-0.094 ms, of which the exps take about half the cycles of an item.
// Slower, each measured: the output staged over Q and stored by TMA (its
// proxy fence, barrier and store ~530 cycles an item, against ~180 for the
// threads' own stores); the first S of each item not issued early
// (0.099-0.103); a 64 KB ring (0.099); each stage's S in two 64-key halves
// taking turns with their exps (ptxas serialised the products: C7513;
// 0.109-0.116); 64-key stages on two 256-thread CTAs an SM, thread 0
// feeding the ring (0.136; one CTA an SM 0.213); the second warpgroup
// started 1000-3000 cycles late (no change).
// Rounding points as attention_kernel's: f32 scores; e =
// ex2(min(s·dh^-0.5·log2 e, 80·log2 e)); each thread's f32 row sums of the
// unrounded e in key order, its quad's four added in a fixed order;
// bf16(e) into P V, accumulated in f32; out = bf16(acc · (1/sum)). No
// atomics: two calls are bitwise equal, and so are the slab and the
// joint-major layouts on the same tokens (the same tiles, other maps).
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "attention.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace pose3d;
namespace rt = pose3d::rowtile;

constexpr int kAttnStages = 4;  // cp.async commit groups of K and V
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLog2 = kScoreClamp * kLog2e;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Waits until at most `pending` of this thread's cp.async groups are in
// flight (pending < kAttnStages; wait_group takes an immediate).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}
static_assert(kAttnStages == 4, "cp_async_wait_upto covers 4 groups");

// One 16-key block of one 16-row query tile on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate). No row max is kept, so nothing is
// rescaled between key blocks: e from the f32 scores goes to bf16 as the A
// operand of P V straight from the score accumulators (their C layout is
// the A layout), and its f32 row sums divide the output at the end. kMask:
// keys at or past L get e = 0 (the zero rows that pad K and V to whole
// tiles keep every product finite).
template <int DH, bool kMask>
__device__ __forceinline__ void key_block(const unsigned (&qa)[DH / 16][4], unsigned ks,
                                          unsigned vs, int kb, int L, int q4,
                                          float (&acc)[DH / 8][4], float& sum0, float& sum1) {
  constexpr int ld = attn_ld(DH);
  constexpr float kScaleLog2 =
      (DH == 16 ? 0.25f : DH == 32 ? 0.17677669529663687f : 0.125f) * kLog2e;
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned kf[4];
    ldsm_x4(kf, ks + (kb * 16 * ld + kk * 16) * 2);
    mma_bf16(s[0], qa[kk], kf[0], kf[1]);
    mma_bf16(s[1], qa[kk], kf[2], kf[3]);
  }
  unsigned pa[4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = exp2_approx(fminf(s[nb][i] * kScaleLog2, kClampLog2));
      if (kMask && kb * 16 + nb * 8 + 2 * q4 + (i & 1) >= L) e[i] = 0.f;
    }
    sum0 += e[0] + e[1];
    sum1 += e[2] + e[3];
    __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
    pa[2 * nb] = *reinterpret_cast<unsigned*>(&lo);
    pa[2 * nb + 1] = *reinterpret_cast<unsigned*>(&hi);
  }
#pragma unroll
  for (int d = 0; d < DH / 16; ++d) {
    unsigned vf[4];
    ldsm_x4_trans(vf, vs + (kb * 16 * ld + d * 16) * 2);
    mma_bf16(acc[2 * d], pa, vf[0], vf[1]);
    mma_bf16(acc[2 * d + 1], pa, vf[2], vf[3]);
  }
}

// The 16-key blocks [b, e) of one query tile: the full ones unmasked, the
// ragged last one (if it lies in the range) masked.
template <int DH>
__device__ __forceinline__ void key_blocks(const unsigned (&qa)[DH / 16][4], unsigned ks,
                                           unsigned vs, int b, int e, int L, int q4,
                                           float (&acc)[DH / 8][4], float& sum0,
                                           float& sum1) {
  const int full = L / 16;
  for (int kb = b; kb < min(e, full); ++kb)
    key_block<DH, false>(qa, ks, vs, kb, L, q4, acc, sum0, sum1);
  if (full >= b && full < e) key_block<DH, true>(qa, ks, vs, full, L, q4, acc, sum0, sum1);
}

template <int DH>
__global__ void __launch_bounds__(kAttnThreads, DH == 64 ? 2 : 3)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int heads,
                 int inner_n, SeqLayout in, SeqLayout o) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = attn_ld(DH);
  const int rows = attn_rows(L);
  const int n_kb = rows / 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + rows * ld;
  const int seq = blockIdx.x;
  const int head = blockIdx.y;
  const int dim = heads * DH;
  const bf16* src = qkv + (seq / inner_n) * in.outer + (seq % inner_n) * in.inner + head * DH;
  bf16* dst = out + (seq / inner_n) * o.outer + (seq % inner_n) * o.inner + head * DH;
  const int n_threads = blockDim.x;
  const int n_warps = n_threads >> 5;

  // K and V by cp.async, one commit group per stage of key blocks; the
  // rows that pad the last block are zeroed by plain stores, which the
  // barrier after each wait also publishes
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int j = 0; j < kAttnStages; ++j) {
    const int r0 = j * n_kb / kAttnStages * 16;
    const int r1 = (j + 1) * n_kb / kAttnStages * 16;
    for (int i = threadIdx.x; i < (r1 - r0) * (DH / 8) * 2; i += n_threads) {
      const int half = i / ((r1 - r0) * (DH / 8));  // 0: K, 1: V
      const int t = i % ((r1 - r0) * (DH / 8));
      const int r = r0 + t / (DH / 8);
      const int c = (t % (DH / 8)) * 8;
      bf16* d = (half ? vs : ks) + r * ld + c;
      if (r < L) cp_async16(d, src + r * in.row + (half + 1) * dim + c);
      else *reinterpret_cast<uint4*>(d) = zero16;
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / 4;  // accumulator rows g and g + 8, columns 2q and 2q + 1
  const int q4 = lane % 4;
  // ldmatrix lane offsets: the .trans V operand takes row lane % 16 at
  // column (lane / 16) * 8; the K^T operand takes key (lane / 16) * 8 +
  // lane % 8 at column ((lane / 8) % 2) * 8
  const unsigned k_lane =
      smem_u32(ks + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8);
  const unsigned v_lane = smem_u32(vs + (lane % 16) * ld + (lane / 16) * 8);

  // the A fragments of query tile qt from device memory: registers (row g,
  // column 2q), (g + 8, 2q), (g, 2q + 8), (g + 8, 2q + 8) of each k16 step,
  // rows past L zero
  auto load_q = [&](int qt, unsigned (&qa)[DH / 16][4]) {
    const int r = qt * 16 + g;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r + (i & 1) * 8;
        const int col = kk * 16 + 2 * q4 + (i >> 1) * 8;
        qa[kk][i] = row < L ? __ldg(reinterpret_cast<const unsigned*>(src + row * in.row + col))
                            : 0u;
      }
  };
  // the four lanes of a quad hold partial sums of the same two rows
  auto finish = [&](int qt, float (&acc)[DH / 8][4], float sum0, float sum1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.f / sum0;
    const float inv1 = 1.f / sum1;
    const int r0 = qt * 16 + g;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      const int col = nb * 8 + 2 * q4;
      if (r0 < L) store2(dst + r0 * o.row + col, acc[nb][0] * inv0, acc[nb][1] * inv0);
      if (r0 + 8 < L)
        store2(dst + (r0 + 8) * o.row + col, acc[nb][2] * inv1, acc[nb][3] * inv1);
    }
  };

  // the first tile of each warp meets the key stages as they land (every
  // warp has one, so every thread reaches each barrier)
  {
    unsigned qa[DH / 16][4];
    load_q(warp, qa);
    float acc[DH / 8][4] = {};
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kAttnStages; ++j) {
      cp_async_wait_upto(kAttnStages - 1 - j);
      __syncthreads();
      key_blocks<DH>(qa, k_lane, v_lane, j * n_kb / kAttnStages, (j + 1) * n_kb / kAttnStages,
                     L, q4, acc, sum0, sum1);
    }
    finish(warp, acc, sum0, sum1);
  }
  for (int qt = warp + n_warps; qt < n_kb; qt += n_warps) {
    unsigned qa[DH / 16][4];
    load_q(qt, qa);
    float acc[DH / 8][4] = {};
    float sum0 = 0.f, sum1 = 0.f;
    key_blocks<DH>(qa, k_lane, v_lane, 0, n_kb, L, q4, acc, sum0, sum1);
    finish(qt, acc, sum0, sum1);
  }
}

template <int DH>
cudaError_t launch_dh(const bf16* qkv, bf16* out, int n_seq, int L, int heads, int inner_n,
                      SeqLayout in, SeqLayout o, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(L, DH);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int warps = min(kAttnWarps, attn_rows(L) / 16);
  attention_kernel<DH><<<dim3(n_seq, heads), warps * 32, smem, stream>>>(
      qkv, out, L, heads, inner_n, in, o);
  return cudaGetLastError();
}

// ------------------------------------------------ L > kAttnSplitLen

constexpr int kWgQRows = rt::kTileRows;  // query rows of a work item: 64 a consumer warpgroup
constexpr int kWgKeys = 128;             // keys of a K/V stage
constexpr int kWgRingBytes = 160 * 1024;  // the K/V ring: 20, 10 or 5 stages at dh 16, 32, 64
constexpr int kWgSlots = 2;  // Q tiles: this item's and the next one's
static_assert(kWgKeys == kWgQRows, "one box shape serves Q, K and V");

template <int DH>
struct WgTiles {
  static constexpr int kRowBytes = DH * 2;             // a head row: its swizzle span
  static constexpr int kKvBytes = kWgKeys * kRowBytes;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;      // K, then V
  static constexpr int kStages = kWgRingBytes / kStageBytes;
  static constexpr int kQBytes = kWgQRows * kRowBytes;  // a work item's Q tile
  static constexpr int kWgBytes = rt::kWgRows * kRowBytes;  // a warpgroup's 64 rows of it
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kWgSlots * kQBytes + 16 * (kStages + kWgSlots);
  static_assert(kKvBytes % 1024 == 0 && kWgBytes % 1024 == 0,
                "every tile starts on a whole swizzle pattern");
  static_assert(kSmem <= kSmemLimit, "the ring and the slots fit in shared memory");
};

// Box (col, row) of sequence s: a 3-D map's plane s, or a 4-D map's (s %
// inner_n, s / inner_n).
template <int kRank>
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int s, int inner_n) {
  if constexpr (kRank == 3) rt::tma_load3(dst, map, bar, col, row, s);
  else rt::tma_load4(dst, map, bar, col, row, s % inner_n, s / inner_n);
}

// One key tile's raw scores s become e = 2^min(s·sl, 80·log2 e) in place
// (keys at or past `valid` 0), and this thread's row sums l0, l1 take
// them in key order.
template <int N>
__device__ __forceinline__ void clamped_exp(float (&s)[N / 2], float sl, int valid, int q4,
                                            float& l0, float& l1) {
  if (valid < N) attn::mask_keys<N>(s, valid, q4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * j + i] = attn::ex2(fminf(s[4 * j + i] * sl, kClampLog2));
    l0 += s[4 * j] + s[4 * j + 1];
    l1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

// The attention of the work items of a persistent CTA: qkv_map's boxes
// are 128 rows of one head's columns.
template <int DH, int kRank>
__global__ void __launch_bounds__(rt::kThreads, 1)
attention_wg_kernel(const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out,
                    SeqLayout o, int L, int heads, int inner_n, int n_items) {
  using T = WgTiles<DH>;
  constexpr int kN = kWgKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = attn::align1024(smem_raw);
  const uint32_t ring_s = smem_u32(base);
  const uint32_t slot_s = ring_s + T::kStages * T::kStageBytes;
  const uint32_t bars = slot_s + kWgSlots * T::kQBytes;
  if (threadIdx.x == 0) {
    rt::ring_init<T::kStages>(bars);
    rt::ring_init<kWgSlots>(bars + 16 * T::kStages);
  }
  __syncthreads();
  rt::Ring<T::kStages, T::kStageBytes> ring{ring_s, bars, 0};
  rt::Ring<kWgSlots, T::kQBytes> slots{slot_s, bars + 16 * T::kStages, 0};
  const int n_qt = (L + kWgQRows - 1) / kWgQRows, n_kt = (L + kN - 1) / kN;
  const int dim = heads * DH;
  const int wg = threadIdx.x / 128;
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128) {
      // each item's Q tile into the next slot, then its K and V tiles, in
      // the order the consumers take them
      for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
        const attn::Work w(t, n_qt, heads);
        const int col = w.h * DH;
        uint32_t bar;
        const uint32_t slot = slots.claim(&bar);
        load_box<kRank>(slot, &qkv_map, bar, col, w.tile * kWgQRows, w.n, inner_n);
        for (int kt = 0; kt < n_kt; ++kt) {
          const uint32_t st = ring.claim(&bar);
          load_box<kRank>(st, &qkv_map, bar, dim + col, kt * kN, w.n, inner_n);
          load_box<kRank>(st + T::kKvBytes, &qkv_map, bar, 2 * dim + col, kt * kN, w.n,
                          inner_n);
        }
      }
    }
    return;
  }
  rt::regs_inc<rt::kConsumerRegs>();
  const int lane = threadIdx.x % 32, q4 = lane % 4;
  const int ra = 16 * (threadIdx.x / 32 % 4) + lane / 4;  // rows ra, ra + 8 of the warpgroup's
  constexpr float sl = attn::head_scale<DH>() * kLog2e;
  float acc[DH / 2], s[kN / 2];
  unsigned p[kN / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  // An item's first S goes out beside the last item's last P V, and runs
  // under its epilogue; the first item's goes out here. P V overwrites acc
  // on an item's first tile, so no register of a product in flight is
  // written by another instruction. After the last item a phantom S (its
  // own first tile again) keeps the code the same.
  uint32_t qa = slots.acquire() + wg * T::kWgBytes;
  uint32_t kv = ring.acquire();
  rt::wgmma_fence();
  attn::issue_scores<DH, kN>(s, attn::head_desc<DH>(qa), kv);
  rt::wgmma_commit();
  for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
    const attn::Work w(t, n_qt, heads);
    const uint64_t da = attn::head_desc<DH>(qa);
    float l0 = 0.f, l1 = 0.f;
    rt::wgmma_wait<0>();
    rt::fence_acc(s);
    clamped_exp<kN>(s, sl, L, q4, l0, l1);
    attn::to_frags<kN>(s, p);
#pragma unroll 1
    for (int kt = 1; kt < n_kt; ++kt) {
      const uint32_t next = ring.acquire();
      rt::wgmma_fence();
      attn::issue_scores<DH, kN>(s, da, next);
      rt::wgmma_commit();
      attn::issue_rows<DH, kN>(acc, p, kv + T::kKvBytes, kt > 1);  // the last tile's P V
      rt::wgmma_commit();
      rt::wgmma_wait<1>();  // S has landed; P V runs under the exps
      rt::fence_acc(s);
      clamped_exp<kN>(s, sl, L - kt * kN, q4, l0, l1);
      rt::wgmma_wait<0>();
      rt::fence_acc(acc);
      rt::fence_acc(s);
      ring.release(ring.next - 2);
      attn::to_frags<kN>(s, p);
      kv = next;
    }
    const bool more = t + static_cast<int>(gridDim.x) < n_items;
    if (more) slots.release(slots.next - 1);  // every S of this item has landed
    const uint32_t qn = more ? slots.acquire() + wg * T::kWgBytes : qa;
    const uint32_t kn = more ? ring.acquire() : kv;
    const uint64_t dn = attn::head_desc<DH>(qn);
    rt::wgmma_fence();
    attn::issue_rows<DH, kN>(acc, p, kv + T::kKvBytes, n_kt > 1);
    rt::wgmma_commit();
    attn::issue_scores<DH, kN>(s, dn, kn);  // the next item's first S
    rt::wgmma_commit();
    // out = bf16(acc / sum), each thread its rows' columns: the sums and
    // the rows' addresses while the last P V runs
    l0 = attn::quad_sum(l0);
    l1 = attn::quad_sum(l1);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int r = w.tile * kWgQRows + wg * rt::kWgRows + ra;
    bf16* ob = out + (w.n / inner_n) * o.outer + (w.n % inner_n) * o.inner + w.h * DH;
    rt::wgmma_wait<1>();
    rt::fence_acc(acc);
    if (more) ring.release(ring.next - 2);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      if (r < L) store2(ob + r * o.row + c, acc[4 * j] * i0, acc[4 * j + 1] * i0);
      if (r + 8 < L) store2(ob + (r + 8) * o.row + c, acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
    }
    qa = qn;
    kv = kn;
  }
  rt::wgmma_wait<0>();  // the phantom S
  rt::fence_acc(s);
}

// The TMA map of `width` columns of n_seq sequences of L rows at m, laid
// out as `lay`, in boxes of DH columns x box_rows rows: 3-D (columns,
// rows, sequences) where inner_n is 1, else 4-D (columns, rows, s %
// inner_n, s / inner_n).
template <int DH>
cudaError_t seq_map(CUtensorMap* map, const bf16* m, long long width, int n_seq, int L,
                    int inner_n, SeqLayout lay, int box_rows) {
  constexpr cuuint64_t b = sizeof(bf16);
  if (inner_n == 1) {
    const cuuint64_t dims[3] = {cuuint64_t(width), cuuint64_t(L), cuuint64_t(n_seq)};
    const cuuint64_t strides[2] = {cuuint64_t(lay.row) * b, cuuint64_t(lay.outer) * b};
    return attn::head_box_map<DH>(map, m, 3, dims, strides, box_rows);
  }
  const cuuint64_t dims[4] = {cuuint64_t(width), cuuint64_t(L), cuuint64_t(inner_n),
                              cuuint64_t(n_seq / inner_n)};
  const cuuint64_t strides[3] = {cuuint64_t(lay.row) * b, cuuint64_t(lay.inner) * b,
                                 cuuint64_t(lay.outer) * b};
  return attn::head_box_map<DH>(map, m, 4, dims, strides, box_rows);
}

template <int DH, int kRank>
cudaError_t launch_wg_rank(const CUtensorMap& qkv_map, bf16* out, SeqLayout o, int L, int heads,
                           int inner_n, int items, cudaStream_t stream) {
  using T = WgTiles<DH>;
  int grid;
  cudaError_t err = cudaFuncSetAttribute(attention_wg_kernel<DH, kRank>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess) err = persistent_grid(items, &grid);
  if (err != cudaSuccess) return err;
  attention_wg_kernel<DH, kRank><<<grid, rt::kThreads, T::kSmem, stream>>>(qkv_map, out, o, L,
                                                                          heads, inner_n, items);
  return cudaGetLastError();
}

bool strided16(SeqLayout l) { return l.outer % 8 == 0 && l.inner % 8 == 0 && l.row % 8 == 0; }

template <int DH>
cudaError_t launch_wg(const bf16* qkv, bf16* out, int n_seq, int L, int heads, int inner_n,
                      SeqLayout in, SeqLayout o, cudaStream_t stream) {
  const long long items =
      static_cast<long long>(n_seq) * heads * ((L + kWgQRows - 1) / kWgQRows);
  if (items > 0x7fffffffLL || n_seq % inner_n || !strided16(in) ||
      reinterpret_cast<uintptr_t>(qkv) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err =
      seq_map<DH>(&map, qkv, 3LL * heads * DH, n_seq, L, inner_n, in, kWgQRows);
  if (err != cudaSuccess) return err;
  const int n = static_cast<int>(items);
  return inner_n == 1 ? launch_wg_rank<DH, 3>(map, out, o, L, heads, inner_n, n, stream)
                      : launch_wg_rank<DH, 4>(map, out, o, L, heads, inner_n, n, stream);
}

}  // namespace

namespace pose3d {

cudaError_t launch_attention(const bf16* qkv, bf16* out, int n_seq, int L, int heads,
                             int dh, int inner_n, SeqLayout in, SeqLayout o,
                             cudaStream_t stream) {
  if (n_seq < 0 || L < 1 || heads < 1 || heads > 65535 || inner_n < 1 ||
      attn_smem_bytes(L, dh) > size_t(kSmemLimit))
    return cudaErrorInvalidValue;
  if (n_seq == 0) return cudaSuccess;
  if (L > kAttnSplitLen) {
    switch (dh) {
      case 16: return launch_wg<16>(qkv, out, n_seq, L, heads, inner_n, in, o, stream);
      case 32: return launch_wg<32>(qkv, out, n_seq, L, heads, inner_n, in, o, stream);
      case 64: return launch_wg<64>(qkv, out, n_seq, L, heads, inner_n, in, o, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 16: return launch_dh<16>(qkv, out, n_seq, L, heads, inner_n, in, o, stream);
    case 32: return launch_dh<32>(qkv, out, n_seq, L, heads, inner_n, in, o, stream);
    case 64: return launch_dh<64>(qkv, out, n_seq, L, heads, inner_n, in, o, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pose3d

// qkv: (n_seq * seq, 3 * heads * dh) bf16 rows, head h of q, k, v at
// columns h*dh, heads*dh + h*dh, 2*heads*dh + h*dh; out: (n_seq * seq,
// heads * dh) bf16. Both contiguous and 16-byte aligned. A head width
// other than 16, 32 or 64, or a sequence whose K and V do not fit in
// shared memory, returns cudaErrorInvalidValue. Launches on the calling
// thread's current device, which must hold the operands.
extern "C" cudaError_t attention_launch(const void* qkv, void* out, int n_seq, int seq,
                                        int heads, int dh, void* stream) {
  const long long dim = static_cast<long long>(heads) * dh;
  return pose3d::launch_attention(static_cast<const pose3d::bf16*>(qkv),
                                  static_cast<pose3d::bf16*>(out), n_seq, seq, heads, dh, 1,
                                  {seq * 3 * dim, 0, 3 * dim}, {seq * dim, 0, dim},
                                  static_cast<cudaStream_t>(stream));
}
