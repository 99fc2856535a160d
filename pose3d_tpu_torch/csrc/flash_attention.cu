// Flash attention for Hopper (sm_90a): non-causal softmax attention
// softmax(q k^T * dh^-0.5) v per (sequence, head), with no mask, bias or
// segment ids, and its gradients, in three kernels and no atomics, so that
// a gradient is bitwise the same from call to call.
//
// Replaces the three TPU kernels of jax's
// jax/experimental/pallas/ops/tpu/flash_attention.py that the JAX package's
// TemporalLifter(flash=True) reaches (pose3d_tpu/models/temporal.py:84):
// - flash_fwd_kernel (14a): _flash_attention_impl's pallas_call (:758) over
//   _flash_attention_kernel (:331): O and the softmax residuals. Here the
//   residual is one f32 log-sum-exp a row (JAX keeps its l and m apart);
// - flash_dq_kernel (14c): _flash_attention_bwd_dq's pallas_call (:1456) over
//   _flash_attention_dq_kernel (:1146): dQ (JAX's dS output, which ab=None
//   discards, is not formed). It also computes D = rowsum(dO * O), which
//   JAX computes outside its kernels (flash_attention.py:273-275), from the
//   O and dO tiles it loads, and writes it for 14b: 14c launches first;
// - flash_dkv_kernel (14b): _flash_attention_bwd_dkv's pallas_call (:1121)
//   over _flash_attention_dkv_kernel (:796): dK and dV, on 14c's D.
// A TPU grid walks its K/V axis in order and carries the row max and sum in
// scratch from step to step; here a block loops over the K/V (or Q) tiles
// itself and carries them in registers. The TPU kernel needs the K/V length
// to be a multiple of 128; these take any lengths and mask the partial last
// tile.
//
// What bounds them on this card. At the long-clip path's shape (2 clips x
// 2048 frames: 34 sequences x 8 heads, dh = 32) the forward does two
// products, 146 GFLOP (0.148 ms at 989 TFLOP/s), and one exponential per
// score, 1.14 G, which the SFU's 16 a clock an SM take ~0.27 ms at 1.98 GHz;
// it moves ~145 MB (0.043 ms at 3.35 TB/s). At dh = 32 the exponentials,
// not the tensor cores, set the floor; each backward kernel recomputes them
// beside its products (dQ: S, dP, dQ, 0.22 ms; dK/dV: S, dP, dV, dK, 0.30
// ms, just above its exponentials). So
// the SFU has to stay busy while the tensor cores run the products, and
// nothing else may cost as much as an exponential.
//
// 14a and 14c: one query-major engine on rowtile_sm90.cuh's primitives.
// Their first versions (mma.sync m16n8k16 with every B fragment through
// ldmatrix, 64-key tiles by cp.async with two block-wide barriers a tile, a
// mask on every score, 0.91 and 0.94 ms + 0.33 for D as a PyTorch op) ran
// each warp's products and exponentials one after the other. Now:
// - a persistent CTA an SM walks work tiles of 128 query rows of one
//   (sequence, head): a producer warpgroup (setmaxnreg down) whose one
//   thread issues each work tile's Q (14c: Q, dO, O) by TMA into one of two
//   slots, then its K and V tiles (128 keys; 64 in 14c, whose S and dP
//   accumulators share the registers) into a 4-stage ring, every slot and
//   stage guarded by a full and an empty mbarrier; it waits only for free
//   stages, so the next work tile's loads run under this one's epilogue.
//   Two consumer warpgroups (setmaxnreg up) own 64 query rows each. No
//   barrier spans the block after set-up.
// - each view is a 3-D TMA map (head columns, rows, sequences) over the
//   strided (N, L, heads * dh) rows: rows past a sequence's end arrive as
//   zeros and no box reads into the next sequence. A box row is one head,
//   dh * 2 bytes, in the swizzle of that span (32 B at dh = 16, 64 B at 32,
//   128 B at 64), which the wgmma descriptors name (head_desc).
// - S = Q K^T and 14c's dP = dO V^T are wgmma with both operands from
//   shared memory, K-major; P (14a) and dS (14c) go from the f32
//   accumulators to bf16 A fragments in registers (their layouts match) and
//   feed wgmma with A from registers against the V (14a) or K (14c) tile,
//   taken N-major with the transpose flag: no transposed copy exists.
// - overlap: 14a issues tile j's S and tile j - 1's P V together, and runs
//   tile j's softmax while P V is on the tensor cores; 14c issues tile j -
//   1's dS K, then tile j's S and dP, and runs tile j's exponentials while
//   dP is on the tensor cores. The other warpgroup's exponentials fill the
//   rest. Slower, each measured (PERF.md §6): 14c's next S issued
//   before its exponentials, a third consumer warpgroup, 96-key tiles
//   (ptxas serialised the products for want of registers: 168 a thread at
//   384 threads, 128 at 512, whatever setmaxnreg asks); an 8-stage ring;
//   dS staged in shared memory for an all-shared-memory dS K; the
//   warpgroups taking turns at issuing products or at the exponentials,
//   on named barriers or mbarriers.
// - a score costs one FFMA (s * scale * log2 e - m, or - lse) and one
//   ex2.approx; the mask runs only on the tile that holds Lk, behind a
//   branch uniform over the block; 128-key tiles halve the forward's row
//   max shuffles and rescales a key.
// Rounding points as before: P and dS rounded to bf16 once before their
// product; f32 accumulation; O scaled by 1/l in f32 and rounded once; lse =
// (m + log2 l) * ln 2 in f32; D an f32 sum of f32 products.
//
// 14b is that engine turned round, key-major: a work tile is 128 keys of
// one (sequence, head), whose K and V tiles come by TMA into a slot, 64
// keys a consumer warpgroup; the producer streams the Q and dO tiles of 64
// query rows through the ring, and its warp's lanes copy those rows' lse
// and D beside each stage by cp.async, arriving on the stage's barrier
// when they land (the f32 (n, heads, Lq) rows are 4 Lq bytes apart, which
// a TMA map refuses at odd Lq; plain loads made the producer wait a round
// trip a stage). Four products a tile: S^T = K Q^T and dP^T = V dO^T from
// shared memory, dV += bf16(P^T) dO and dK += bf16(dS^T) Q with P^T and
// dS^T as register A operands; tile j's exponentials run under its dP^T,
// its dV product under the forming of dS, its dK product beside tile j +
// 1's S^T and dP^T, its stage handed back once dV and dK retire. A work
// tile owns its keys and sums its query tiles in order. Its first version
// (mma.sync with every B fragment through ldmatrix, 64-row cp.async tiles,
// two block-wide barriers a tile; 1.14 ms) ran each warp's products and
// exponentials one after the other.
//
// Layout: q, k and v are strided (N, L, heads * dh) views, head h at
// columns [h * dh, (h + 1) * dh), rows `row` elements apart and sequences
// `seq` apart: the [q | k | v] rows of one qkv projection, or k and v from
// separate [k | v] rows of another length. dq has q's strides, dk and dv
// k's; o and dO are contiguous (N, Lq, heads * dh); the log-sum-exp and D
// are contiguous f32 (N, heads, Lq). The launchers run on the caller's
// stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() (or cudaErrorInvalidValue for what they refuse).

#include <type_traits>

#include "attention_sm90.cuh"

namespace {

using namespace pose3d;
using namespace pose3d::attn;
namespace rt = rowtile;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Rows {
  long long seq, row;  // element strides between sequences and between rows
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ------------------------------------------------ the query-major engine

constexpr int kQRows = rt::kTileRows;  // query rows of a work tile: 64 a consumer warpgroup
constexpr int kSlots = 2;              // work tiles whose Q (dO, O) tiles are in shared memory
constexpr int kStages = 4;             // K/V tiles in flight

template <int DH, bool kDq>
struct Tiles {
  static constexpr int kRowBytes = DH * 2;            // a head row: its swizzle span
  static constexpr int kKeys = kDq ? 64 : 128;        // keys a K/V tile
  static constexpr int kKvBytes = kKeys * kRowBytes;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;    // K, then V
  static constexpr int kQBytes = kQRows * kRowBytes;  // one Q, dO or O tile
  static constexpr int kSlotBytes = (kDq ? 3 : 1) * kQBytes;
  static constexpr int kWgBytes = rt::kWgRows * kRowBytes;  // a warpgroup's 64 rows of one
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kSlots * kSlotBytes + 16 * (kStages + kSlots);
  static_assert(kKvBytes % 1024 == 0 && kWgBytes % 1024 == 0,
                "every tile starts on a whole swizzle pattern");
  static_assert(kSmem <= kSmemLimit, "the ring and the slots fit in shared memory");
};

// The online softmax of one tile's raw scores s (keys past `valid` masked):
// the row maxes m (log2 units, of s * sl) move to cover the tile; a0 and a1
// = ex2(m_old - m_new) rescale what was summed before; s becomes ex2(s * sl
// - m), one FFMA and one ex2 a score; the row sums l (this thread's
// columns; the quad's are summed at the end) take the tile's.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float sl, int valid, int q4,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& a0, float& a1) {
  if (valid < N) mask_keys<N>(s, valid, q4);
  float r0[4], r1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) r0[u] = r1[u] = -inf();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    r0[j % 4] = fmaxf(r0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
    r1[j % 4] = fmaxf(r1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float x0 = quad_max(fmaxf(fmaxf(r0[0], r0[1]), fmaxf(r0[2], r0[3])));
  const float x1 = quad_max(fmaxf(fmaxf(r1[0], r1[1]), fmaxf(r1[2], r1[3])));
  const float n0 = fmaxf(m0, x0 * sl), n1 = fmaxf(m1, x1 * sl);  // finite: a tile has a key
  a0 = ex2(m0 - n0);  // 0 on the first tile
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], sl, -n0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl, -n0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl, -n1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl, -n1));
    t0[j % 4] += s[4 * j] + s[4 * j + 1];
    t1[j % 4] += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + ((t0[0] + t0[1]) + (t0[2] + t0[3]));
  l1 = l1 * a1 + ((t1[0] + t1[1]) + (t1[2] + t1[3]));
}

// f32 sum of f32 products over this thread's quarter of row r of two tiles
// (dO and O): columns [q4 * DH / 4, (q4 + 1) * DH / 4).
template <int DH>
__device__ __forceinline__ float row_dot(const unsigned char* a, const unsigned char* b, int r,
                                         int q4) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < DH / 4; e += 2) {
    const uint32_t off = head_offset<DH>(r, q4 * (DH / 4) + e);
    const float2 x = load2(reinterpret_cast<const bf16*>(a + off));
    const float2 y = load2(reinterpret_cast<const bf16*>(b + off));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <int DH, bool kDq>
using KvRing = rt::Ring<kStages, Tiles<DH, kDq>::kStageBytes>;
template <int DH, bool kDq>
using SlotRing = rt::Ring<kSlots, Tiles<DH, kDq>::kSlotBytes>;

// The producer's thread: for each work tile of the CTA, its Q tile (14c:
// Q, dO and O) into the next slot, then its K and V tiles, in the order
// the consumers take them; it waits only for free slots and stages.
template <int DH, bool kDq>
__device__ void produce(KvRing<DH, kDq>& ring, SlotRing<DH, kDq>& slots, const CUtensorMap* q_map,
                        const CUtensorMap* do_map, const CUtensorMap* o_map,
                        const CUtensorMap* k_map, const CUtensorMap* v_map, int n_qt, int n_kt,
                        int heads, int n_items) {
  using T = Tiles<DH, kDq>;
  for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
    const Work w(t, n_qt, heads);
    const int col = w.h * DH, row = w.tile * kQRows;
    uint32_t bar;
    const uint32_t slot = slots.claim(&bar);
    rt::tma_load3(slot, q_map, bar, col, row, w.n);
    if constexpr (kDq) {
      rt::tma_load3(slot + T::kQBytes, do_map, bar, col, row, w.n);
      rt::tma_load3(slot + 2 * T::kQBytes, o_map, bar, col, row, w.n);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const uint32_t st = ring.claim(&bar);
      rt::tma_load3(st, k_map, bar, col, kt * T::kKeys, w.n);
      rt::tma_load3(st + T::kKvBytes, v_map, bar, col, kt * T::kKeys, w.n);
    }
  }
}

// 14a: O and the log-sum-exp of the work tiles of a persistent CTA.
template <int DH>
__global__ void __launch_bounds__(rt::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int heads, int n_items) {
  using T = Tiles<DH, false>;
  constexpr int kN = T::kKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring_s = smem_u32(align1024(smem_raw));
  const uint32_t slot_s = ring_s + kStages * T::kStageBytes;
  const uint32_t bars = slot_s + kSlots * T::kSlotBytes;
  if (threadIdx.x == 0) {
    rt::ring_init<kStages>(bars);
    rt::ring_init<kSlots>(bars + 16 * kStages);
  }
  __syncthreads();
  KvRing<DH, false> ring{ring_s, bars, 0};
  SlotRing<DH, false> slots{slot_s, bars + 16 * kStages, 0};
  const int n_qt = (Lq + kQRows - 1) / kQRows, n_kt = (Lk + kN - 1) / kN;
  const int wg = threadIdx.x / 128;
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128)
      produce<DH, false>(ring, slots, &q_map, nullptr, nullptr, &k_map, &v_map, n_qt, n_kt,
                         heads, n_items);
    return;
  }
  rt::regs_inc<rt::kConsumerRegs>();
  const int lane = threadIdx.x % 32, q4 = lane % 4;
  const int ra = 16 * (threadIdx.x / 32 % 4) + lane / 4;  // rows ra, ra + 8 of the warpgroup's
  constexpr float sl = head_scale<DH>() * kLog2e;
  const int dim = heads * DH;
  for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
    const Work w(t, n_qt, heads);
    const uint64_t da = head_desc<DH>(slots.acquire() + wg * T::kWgBytes);
    float acc[DH / 2], s[kN / 2];
    unsigned p[kN / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m0 = -inf(), m1 = -inf(), l0 = 0.f, l1 = 0.f, a0, a1;
    uint32_t kv = ring.acquire();
    rt::wgmma_fence();
    issue_scores<DH, kN>(s, da, kv);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    rt::fence_acc(s);
    online_softmax<kN>(s, sl, Lk, q4, m0, m1, l0, l1, a0, a1);  // acc is 0: a0, a1 unused
    to_frags<kN>(s, p);
#pragma unroll 1
    for (int kt = 1; kt < n_kt; ++kt) {
      const uint32_t next = ring.acquire();
      rt::wgmma_fence();
      issue_scores<DH, kN>(s, da, next);
      rt::wgmma_commit();
      issue_rows<DH, kN>(acc, p, kv + T::kKvBytes);  // the last tile's P V
      rt::wgmma_commit();
      rt::wgmma_wait<1>();  // S has landed; P V runs under the softmax
      rt::fence_acc(s);
      online_softmax<kN>(s, sl, Lk - kt * kN, q4, m0, m1, l0, l1, a0, a1);
      rt::wgmma_wait<0>();
      rt::fence_acc(acc);
      rt::fence_acc(s);
      ring.release(ring.next - 2);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
      }
      to_frags<kN>(s, p);
      kv = next;
    }
    rt::wgmma_fence();
    issue_rows<DH, kN>(acc, p, kv + T::kKvBytes);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    rt::fence_acc(acc);
    ring.release(ring.next - 1);
    slots.release(slots.next - 1);

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const int r = w.tile * kQRows + wg * rt::kWgRows + ra;
    bf16* ob = o + static_cast<long long>(w.n) * Lq * dim + w.h * DH;
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      const long long at = static_cast<long long>(r) * dim + c;
      if (r < Lq) store2(ob + at, acc[4 * j] * i0, acc[4 * j + 1] * i0);
      if (r + 8 < Lq) store2(ob + at + 8LL * dim, acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
    }
    if (q4 == 0) {
      float* lb = lse + (static_cast<long long>(w.n) * heads + w.h) * Lq;
      if (r < Lq) lb[r] = (m0 + __log2f(l0)) * kLn2;
      if (r + 8 < Lq) lb[r + 8] = (m1 + __log2f(l1)) * kLn2;
    }
  }
}

// 14c: dQ = scale * Σ_keys bf16(P ∘ (dO V^T - D)) K of the work tiles of a
// persistent CTA, P recomputed from the log-sum-exp, and D = rowsum(dO ∘
// O) of their rows, which it also writes.
template <int DH>
__global__ void __launch_bounds__(rt::kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap o_map, const float* __restrict__ lse,
                float* __restrict__ delta, bf16* __restrict__ dq, Rows qs, int Lq, int Lk,
                int heads, int n_items) {
  using T = Tiles<DH, true>;
  constexpr int kN = T::kKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t ring_s = smem_u32(base);
  const uint32_t slot_s = ring_s + kStages * T::kStageBytes;
  const uint32_t bars = slot_s + kSlots * T::kSlotBytes;
  if (threadIdx.x == 0) {
    rt::ring_init<kStages>(bars);
    rt::ring_init<kSlots>(bars + 16 * kStages);
  }
  __syncthreads();
  KvRing<DH, true> ring{ring_s, bars, 0};
  SlotRing<DH, true> slots{slot_s, bars + 16 * kStages, 0};
  const int n_qt = (Lq + kQRows - 1) / kQRows, n_kt = (Lk + kN - 1) / kN;
  const int wg = threadIdx.x / 128;
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x == rt::kConsumers * 128)
      produce<DH, true>(ring, slots, &q_map, &do_map, &o_map, &k_map, &v_map, n_qt, n_kt, heads,
                        n_items);
    return;
  }
  rt::regs_inc<rt::kConsumerRegs>();
  const int lane = threadIdx.x % 32, q4 = lane % 4;
  const int ra = 16 * (threadIdx.x / 32 % 4) + lane / 4;
  constexpr float sl = head_scale<DH>() * kLog2e;
  for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
    const Work w(t, n_qt, heads);
    const uint32_t qa = slots.acquire() + wg * T::kWgBytes;
    const uint64_t dq_a = head_desc<DH>(qa), do_a = head_desc<DH>(qa + T::kQBytes);
    // D of rows ra and ra + 8 from the dO and O tiles
    const unsigned char* tile = base + (qa - ring_s);
    const float d0 = quad_sum(row_dot<DH>(tile + T::kQBytes, tile + 2 * T::kQBytes, ra, q4));
    const float d1 = quad_sum(row_dot<DH>(tile + T::kQBytes, tile + 2 * T::kQBytes, ra + 8, q4));
    const int r = w.tile * kQRows + wg * rt::kWgRows + ra;
    const long long stat = (static_cast<long long>(w.n) * heads + w.h) * Lq;
    // rows past Lq: Q and dO arrive as zeros, so their dS is 0 whatever these are
    const float e0 = r < Lq ? lse[stat + r] * kLog2e : 0.f;
    const float e1 = r + 8 < Lq ? lse[stat + r + 8] * kLog2e : 0.f;
    float acc[DH / 2], s[kN / 2], dp[kN / 2];
    unsigned ds[kN / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    // Tile kt: its S and dP went out after the last tile's dS K; the
    // exponentials of S run under dP. The first and last tiles are peeled
    // (first: no stage to hand back; more: the next tile's S and dP go
    // out): with either as a branch in the loop ptxas serialised the
    // products (C7514, C7515).
    uint32_t kv = ring.acquire();
    rt::wgmma_fence();
    issue_scores<DH, kN>(s, dq_a, kv);  // S = Q K^T
    rt::wgmma_commit();
    issue_scores<DH, kN>(dp, do_a, kv + T::kKvBytes);  // dP = dO V^T
    rt::wgmma_commit();
    auto step = [&](int kt, auto first, auto more) {
      rt::wgmma_wait<1>();
      rt::fence_acc(s);
      const int valid = Lk - kt * kN;
      if (valid < kN) mask_keys<kN>(s, valid, q4);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[4 * j + i] = ex2(fmaf(s[4 * j + i], sl, i < 2 ? -e0 : -e1));
      rt::wgmma_wait<0>();
      rt::fence_acc(dp);
      rt::fence_acc(acc);
      if constexpr (!decltype(first)::value) ring.release(ring.next - 2);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[4 * j + i] *= dp[4 * j + i] - (i < 2 ? d0 : d1);
      to_frags<kN>(s, ds);
      rt::wgmma_fence();
      issue_rows<DH, kN>(acc, ds, kv);  // dQ += dS K
      rt::wgmma_commit();
      if constexpr (decltype(more)::value) {
        kv = ring.acquire();
        issue_scores<DH, kN>(s, dq_a, kv);
        rt::wgmma_commit();
        issue_scores<DH, kN>(dp, do_a, kv + T::kKvBytes);
        rt::wgmma_commit();
      }
    };
    if (n_kt == 1) {
      step(0, std::true_type{}, std::false_type{});
    } else {
      step(0, std::true_type{}, std::true_type{});
#pragma unroll 1
      for (int kt = 1; kt + 1 < n_kt; ++kt) step(kt, std::false_type{}, std::true_type{});
      step(n_kt - 1, std::false_type{}, std::false_type{});
    }
    rt::wgmma_wait<0>();
    rt::fence_acc(acc);
    ring.release(ring.next - 1);
    slots.release(slots.next - 1);

    constexpr float sc = head_scale<DH>();
    bf16* gb = dq + w.n * qs.seq + w.h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      if (r < Lq) store2(gb + r * qs.row + c, acc[4 * j] * sc, acc[4 * j + 1] * sc);
      if (r + 8 < Lq) store2(gb + (r + 8) * qs.row + c, acc[4 * j + 2] * sc, acc[4 * j + 3] * sc);
    }
    if (q4 == 0) {
      if (r < Lq) delta[stat + r] = d0;
      if (r + 8 < Lq) delta[stat + r + 8] = d1;
    }
  }
}

// ------------------------------------------------ 14b: the key-major kernel

constexpr int kFeedLanes = 32;  // the producer warp: every lane fills a stage's lse and D

// 14b's tiles: a work tile is 128 keys of one (sequence, head), its K and V
// in one of two slots; each ring stage holds one tile of kQueries query
// rows: the Q tile, the dO tile, and (beside the stages, one slice a stage)
// their log-sum-exp and D.
template <int DH>
struct KeyTiles {
  static constexpr int kQueries = 64;                   // query rows a stage
  static constexpr int kStages = 4;                     // stages of the Q/dO ring
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kTileBytes = kQueries * kRowBytes;  // one Q or dO tile
  static constexpr int kStageBytes = 2 * kTileBytes;       // Q, then dO: what TMA brings
  static constexpr int kStatBytes = 2 * kQueries * 4;      // lse, then D
  static constexpr int kKvBytes = kQRows * kRowBytes;      // one K or V tile of 128 keys
  static constexpr int kSlotBytes = 2 * kKvBytes;          // K, then V
  static constexpr int kWgBytes = rt::kWgRows * kRowBytes;  // a warpgroup's 64 keys of one
  static constexpr int kSmem = 1024 + kStages * (kStageBytes + kStatBytes) +
                               kSlots * kSlotBytes + 16 * (kStages + kSlots);
  static_assert(kTileBytes % 1024 == 0 && kWgBytes % 1024 == 0,
                "every tile starts on a whole swizzle pattern");
  static_assert(kQueries % kFeedLanes == 0, "the lanes split a stage's rows evenly");
  static_assert(kSmem <= kSmemLimit, "the ring and the slots fit in shared memory");
};

template <int DH>
using QRing = rt::Ring<KeyTiles<DH>::kStages, KeyTiles<DH>::kStageBytes>;
template <int DH>
using KvSlots = rt::Ring<kSlots, KeyTiles<DH>::kSlotBytes>;

// 4 bytes at src into shared memory at dst by cp.async, zeros where !valid
// (src must still be a readable address).
__device__ __forceinline__ void copy4_async(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on bar once this thread's cp.async copies so far have landed;
// noinc: it counts toward the barrier's expected arrivals.
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Arms bar for `bytes` more transaction bytes, without an arrival.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// 14b's producer warp: for each work tile of the CTA, lane 0 issues its K
// and V tiles into the next slot; then for each query tile, once its stage
// is free, lane 0 arms the stage's full barrier for the Q and dO tiles and
// issues them by TMA, and every lane copies its rows' lse and D into the
// stage's slice by cp.async (a TMA map needs 16-byte row strides, and the
// (n, heads, Lq) f32 rows are 4 Lq bytes apart) and arrives when they land:
// kFeedLanes arrivals and the tiles' bytes complete the stage. Rows past Lq
// get 0: their Q and dO rows arrive as zeros, so any finite lse and D give
// them dS = 0 and a dV term of 0.
template <int DH>
__device__ void feed_keys(QRing<DH>& ring, KvSlots<DH>& slots, uint32_t stats,
                          const CUtensorMap* q_map, const CUtensorMap* do_map,
                          const CUtensorMap* k_map, const CUtensorMap* v_map,
                          const float* __restrict__ lse, const float* __restrict__ delta, int Lq,
                          int n_kt, int n_qt, int heads, int n_items) {
  using T = KeyTiles<DH>;
  constexpr int kN = T::kQueries;
  const int lane = threadIdx.x % 32;
  for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
    const Work w(t, n_kt, heads);
    const int col = w.h * DH;
    if (lane == 0) {
      uint32_t bar;
      const uint32_t slot = slots.claim(&bar);
      rt::tma_load3(slot, k_map, bar, col, w.tile * kQRows, w.n);
      rt::tma_load3(slot + T::kKvBytes, v_map, bar, col, w.tile * kQRows, w.n);
    }
    const long long stat = (static_cast<long long>(w.n) * heads + w.h) * Lq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int s = ring.next % T::kStages;
      rt::mbar_wait(ring.empty(s), ((ring.next / T::kStages) & 1) ^ 1);
      ++ring.next;
      const uint32_t full = ring.full(s), st = stats + s * T::kStatBytes;
      if (lane == 0) {  // armed before lane 0's own arrival, so before the stage can complete
        const uint32_t dst = ring.ring + s * T::kStageBytes;
        expect_bytes(full, T::kStageBytes);
        rt::tma_load3(dst, q_map, full, col, qt * kN, w.n);
        rt::tma_load3(dst + T::kTileBytes, do_map, full, col, qt * kN, w.n);
      }
#pragma unroll
      for (int u = 0; u < kN / kFeedLanes; ++u) {
        const int i = lane + u * kFeedLanes, r = qt * kN + i;
        const long long at = stat + (r < Lq ? r : 0);
        copy4_async(st + 4 * i, lse + at, r < Lq);
        copy4_async(st + 4 * (kN + i), delta + at, r < Lq);
      }
      copies_arrive(full);
    }
  }
}

// 14b: dV = Σ_q bf16(P)^T dO and dK = scale · Σ_q bf16(P ∘ (dO V^T - D))^T
// Q of the work tiles of a persistent CTA, P recomputed from 14a's
// log-sum-exp, on 14c's D. Each consumer warpgroup owns 64 keys and forms
// the (keys x queries) products S^T = K Q^T and dP^T = V dO^T, both
// operands from shared memory; P^T and dS^T go to bf16 A fragments in
// registers against the dO and Q tiles, taken N-major with the transpose
// flag. The lse and D of a column (a query) come from the stage's slice.
template <int DH>
__global__ void __launch_bounds__(rt::kThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 Rows kvs, int Lq, int Lk, int heads, int n_items) {
  using T = KeyTiles<DH>;
  constexpr int kN = T::kQueries;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t ring_s = smem_u32(base);
  const uint32_t slot_s = ring_s + T::kStages * T::kStageBytes;
  unsigned char* stat_base = base + T::kStages * T::kStageBytes + kSlots * T::kSlotBytes;
  const float* stats = reinterpret_cast<const float*>(stat_base);
  const uint32_t bars = slot_s + kSlots * T::kSlotBytes + T::kStages * T::kStatBytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      rt::mbar_init(bars + 8 * s, kFeedLanes);
      rt::mbar_init(bars + 8 * (T::kStages + s), rt::kConsumers);
    }
    rt::ring_init<kSlots>(bars + 16 * T::kStages);
  }
  __syncthreads();
  QRing<DH> ring{ring_s, bars, 0};
  KvSlots<DH> slots{slot_s, bars + 16 * T::kStages, 0};
  const int n_kt = (Lk + kQRows - 1) / kQRows, n_qt = (Lq + kN - 1) / kN;
  const int wg = threadIdx.x / 128;
  if (wg == rt::kConsumers) {
    rt::regs_dec<rt::kProducerRegs>();
    if (threadIdx.x < rt::kConsumers * 128 + kFeedLanes)
      feed_keys<DH>(ring, slots, smem_u32(stat_base), &q_map, &do_map, &k_map, &v_map, lse,
                    delta, Lq, n_kt, n_qt, heads, n_items);
    return;
  }
  rt::regs_inc<rt::kConsumerRegs>();
  const int lane = threadIdx.x % 32, q4 = lane % 4;
  const int ra = 16 * (threadIdx.x / 32 % 4) + lane / 4;  // keys ra, ra + 8 of the warpgroup's
  constexpr float sl = head_scale<DH>() * kLog2e;
  for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
    const Work w(t, n_kt, heads);
    const uint32_t ka = slots.acquire() + wg * T::kWgBytes;
    const uint64_t k_a = head_desc<DH>(ka), v_a = head_desc<DH>(ka + T::kKvBytes);
    float dka[DH / 2], dva[DH / 2], s[kN / 2], dp[kN / 2];
    unsigned p[kN / 16][4], ds[kN / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
    // Query tile qt: its S^T and dP^T went out with the last tile's dK
    // product; the exponentials of S^T run under dP^T. The last tile is
    // peeled: with a branch on the tile in the loop ptxas serialised the
    // products (14c, C7514, C7515).
    auto slice = [&] {  // the lse and D of the stage acquired last, as column pairs
      return reinterpret_cast<const float2*>(stats + (ring.next - 1) % T::kStages * 2 * kN);
    };
    uint32_t qd = ring.acquire();
    const float2* st = slice();
    rt::wgmma_fence();
    issue_scores<DH, kN>(s, k_a, qd);  // S^T = K Q^T
    rt::wgmma_commit();
    issue_scores<DH, kN>(dp, v_a, qd + T::kTileBytes);  // dP^T = V dO^T
    rt::wgmma_commit();
    auto step = [&](auto more) {
      rt::wgmma_wait<1>();  // S^T has landed
      rt::fence_acc(s);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {  // columns 8j + 2 q4 and + 1: two queries
        const float2 e = st[4 * j + q4];
        const float e0 = e.x * kLog2e, e1 = e.y * kLog2e;
        s[4 * j] = ex2(fmaf(s[4 * j], sl, -e0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl, -e1));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl, -e0));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl, -e1));
      }
      rt::wgmma_wait<0>();
      rt::fence_acc(dp);
      to_frags<kN>(s, p);
      rt::wgmma_fence();
      issue_rows<DH, kN>(dva, p, qd + T::kTileBytes);  // dV += P^T dO, under dS's forming
      rt::wgmma_commit();
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 d = st[kN / 2 + 4 * j + q4];
        s[4 * j] *= dp[4 * j] - d.x;
        s[4 * j + 1] *= dp[4 * j + 1] - d.y;
        s[4 * j + 2] *= dp[4 * j + 2] - d.x;
        s[4 * j + 3] *= dp[4 * j + 3] - d.y;
      }
      to_frags<kN>(s, ds);
      rt::wgmma_fence();
      issue_rows<DH, kN>(dka, ds, qd);  // dK += dS^T Q
      rt::wgmma_commit();
      if constexpr (decltype(more)::value) {
        qd = ring.acquire();
        st = slice();
        issue_scores<DH, kN>(s, k_a, qd);
        rt::wgmma_commit();
        issue_scores<DH, kN>(dp, v_a, qd + T::kTileBytes);
        rt::wgmma_commit();
        rt::wgmma_wait<2>();  // dV and dK have retired: their Q and dO stage is free
        rt::fence_acc(dka);
        rt::fence_acc(dva);
        ring.release(ring.next - 2);
      } else {
        rt::wgmma_wait<0>();
        rt::fence_acc(dka);
        rt::fence_acc(dva);
        ring.release(ring.next - 1);
      }
    };
#pragma unroll 1
    for (int qt = 0; qt + 1 < n_qt; ++qt) step(std::true_type{});
    step(std::false_type{});
    slots.release(slots.next - 1);

    constexpr float sc = head_scale<DH>();
    const int r = w.tile * kQRows + wg * rt::kWgRows + ra;
    bf16* kb = dk + w.n * kvs.seq + w.h * DH;
    bf16* vb = dv + w.n * kvs.seq + w.h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      if (r < Lk) {
        store2(kb + r * kvs.row + c, dka[4 * j] * sc, dka[4 * j + 1] * sc);
        store2(vb + r * kvs.row + c, dva[4 * j], dva[4 * j + 1]);
      }
      if (r + 8 < Lk) {
        store2(kb + (r + 8) * kvs.row + c, dka[4 * j + 2] * sc, dka[4 * j + 3] * sc);
        store2(vb + (r + 8) * kvs.row + c, dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------ host

// The work tiles of the persistent kernels: n * heads * ceil(rows / 128),
// rows being Lq (14a, 14c) or Lk (14b).
bool work_of(int n, int heads, int rows, int& items) {
  const long long total = static_cast<long long>(n) * heads * ((rows + kQRows - 1) / kQRows);
  if (total > 0x7fffffffLL) return false;
  items = static_cast<int>(total);
  return true;
}

bool valid(int n, int Lq, int Lk, int heads, int dh, Rows qs, Rows kvs) {
  const bool aligned = qs.seq % 8 == 0 && qs.row % 8 == 0 && kvs.seq % 8 == 0 &&
                       kvs.row % 8 == 0;
  return n >= 0 && Lq >= 1 && Lk >= 1 && heads >= 1 && aligned &&
         (dh == 16 || dh == 32 || dh == 64);
}

// The TMA map of one head's columns of a strided (n, len, heads * DH) bf16
// view at m, rows r.row elements apart and sequences r.seq apart: a box is
// DH columns (one head) x box_rows rows of one sequence (head_box_map);
// rows past len arrive as zeros.
template <int DH>
cudaError_t head_map(CUtensorMap* map, const bf16* m, int n, int len, int heads, Rows r,
                     int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(heads) * DH, cuuint64_t(len), cuuint64_t(n)};
  const cuuint64_t strides[2] = {cuuint64_t(r.row) * sizeof(bf16),
                                 cuuint64_t(r.seq) * sizeof(bf16)};
  return head_box_map<DH>(map, m, 3, dims, strides, box_rows);
}

template <int DH>
cudaError_t fwd_dh(const bf16* q, const bf16* k, const bf16* v, Rows qs, Rows kvs, bf16* o,
                   float* lse, int n, int Lq, int Lk, int heads, cudaStream_t stream) {
  using T = Tiles<DH, false>;
  int items, grid;
  if (!work_of(n, heads, Lq, items)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess) err = persistent_grid(items, &grid);
  CUtensorMap qm, km, vm;
  if (err == cudaSuccess) err = head_map<DH>(&qm, q, n, Lq, heads, qs, kQRows);
  if (err == cudaSuccess) err = head_map<DH>(&km, k, n, Lk, heads, kvs, T::kKeys);
  if (err == cudaSuccess) err = head_map<DH>(&vm, v, n, Lk, heads, kvs, T::kKeys);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DH><<<grid, rt::kThreads, T::kSmem, stream>>>(qm, km, vm, o, lse, Lq, Lk,
                                                                 heads, items);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dq_dh(const bf16* q, const bf16* k, const bf16* v, Rows qs, Rows kvs,
                  const bf16* dout, const bf16* o, const float* lse, float* delta, bf16* dq,
                  int n, int Lq, int Lk, int heads, cudaStream_t stream) {
  using T = Tiles<DH, true>;
  int items, grid;
  if (!work_of(n, heads, Lq, items)) return cudaErrorInvalidValue;
  const Rows os{static_cast<long long>(Lq) * heads * DH, static_cast<long long>(heads) * DH};
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess) err = persistent_grid(items, &grid);
  CUtensorMap qm, km, vm, dom, om;
  if (err == cudaSuccess) err = head_map<DH>(&qm, q, n, Lq, heads, qs, kQRows);
  if (err == cudaSuccess) err = head_map<DH>(&km, k, n, Lk, heads, kvs, T::kKeys);
  if (err == cudaSuccess) err = head_map<DH>(&vm, v, n, Lk, heads, kvs, T::kKeys);
  if (err == cudaSuccess) err = head_map<DH>(&dom, dout, n, Lq, heads, os, kQRows);
  if (err == cudaSuccess) err = head_map<DH>(&om, o, n, Lq, heads, os, kQRows);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<DH><<<grid, rt::kThreads, T::kSmem, stream>>>(qm, km, vm, dom, om, lse, delta,
                                                                dq, qs, Lq, Lk, heads, items);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dkv_dh(const bf16* q, const bf16* k, const bf16* v, Rows qs, Rows kvs,
                   const bf16* dout, const float* lse, const float* delta, bf16* dk, bf16* dv,
                   int n, int Lq, int Lk, int heads, cudaStream_t stream) {
  using T = KeyTiles<DH>;
  int items, grid;
  if (!work_of(n, heads, Lk, items)) return cudaErrorInvalidValue;
  const Rows os{static_cast<long long>(Lq) * heads * DH, static_cast<long long>(heads) * DH};
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess) err = persistent_grid(items, &grid);
  CUtensorMap qm, km, vm, dom;
  if (err == cudaSuccess) err = head_map<DH>(&qm, q, n, Lq, heads, qs, T::kQueries);
  if (err == cudaSuccess) err = head_map<DH>(&km, k, n, Lk, heads, kvs, kQRows);
  if (err == cudaSuccess) err = head_map<DH>(&vm, v, n, Lk, heads, kvs, kQRows);
  if (err == cudaSuccess) err = head_map<DH>(&dom, dout, n, Lq, heads, os, T::kQueries);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<DH><<<grid, rt::kThreads, T::kSmem, stream>>>(qm, km, vm, dom, lse, delta, dk,
                                                                 dv, kvs, Lq, Lk, heads, items);
  return cudaGetLastError();
}

using B = const pose3d::bf16*;

}  // namespace

// q (k, v): strided (n, Lq (Lk), heads * dh) bf16 views, rows q_row (kv_row)
// elements apart and sequences q_seq (kv_seq) apart, every stride a
// multiple of 8 elements and every pointer 16-byte aligned; o: contiguous
// (n, Lq, heads * dh) bf16; lse: contiguous (n, heads, Lq) f32. Launches on
// the calling thread's current device, which must hold the operands.
extern "C" cudaError_t flash_fwd_launch(const void* q, const void* k, const void* v,
                                        long long q_seq, long long q_row, long long kv_seq,
                                        long long kv_row, void* o, void* lse, int n, int Lq,
                                        int Lk, int heads, int dh, void* stream) {
  const Rows qs{q_seq, q_row}, kvs{kv_seq, kv_row};
  if (!valid(n, Lq, Lk, heads, dh, qs, kvs)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* out = static_cast<pose3d::bf16*>(o);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return fwd_dh<16>(B(q), B(k), B(v), qs, kvs, out, l, n, Lq, Lk, heads, s);
    case 32: return fwd_dh<32>(B(q), B(k), B(v), qs, kvs, out, l, n, Lq, Lk, heads, s);
    default: return fwd_dh<64>(B(q), B(k), B(v), qs, kvs, out, l, n, Lq, Lk, heads, s);
  }
}

// As flash_fwd_launch; dout and o: contiguous (n, Lq, heads * dh) bf16;
// lse: contiguous (n, heads, Lq) f32; writes dq (q's strides) and delta =
// rowsum(dout * o), contiguous (n, heads, Lq) f32, which
// flash_bwd_dkv_launch then reads.
extern "C" cudaError_t flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                           long long q_seq, long long q_row, long long kv_seq,
                                           long long kv_row, const void* dout, const void* o,
                                           const void* lse, void* delta, void* dq, int n,
                                           int Lq, int Lk, int heads, int dh, void* stream) {
  const Rows qs{q_seq, q_row}, kvs{kv_seq, kv_row};
  if (!valid(n, Lq, Lk, heads, dh, qs, kvs)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(delta);
  auto* out = static_cast<pose3d::bf16*>(dq);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return dq_dh<16>(B(q), B(k), B(v), qs, kvs, B(dout), B(o), l, d, out, n, Lq, Lk, heads, s);
    case 32:
      return dq_dh<32>(B(q), B(k), B(v), qs, kvs, B(dout), B(o), l, d, out, n, Lq, Lk, heads, s);
    default:
      return dq_dh<64>(B(q), B(k), B(v), qs, kvs, B(dout), B(o), l, d, out, n, Lq, Lk, heads, s);
  }
}

// As flash_bwd_dq_launch, whose delta it reads; dk and dv have k's strides.
extern "C" cudaError_t flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            long long q_seq, long long q_row, long long kv_seq,
                                            long long kv_row, const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int n, int Lq,
                                            int Lk, int heads, int dh, void* stream) {
  const Rows qs{q_seq, q_row}, kvs{kv_seq, kv_row};
  if (!valid(n, Lq, Lk, heads, dh, qs, kvs)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<const float*>(delta);
  auto* ok = static_cast<pose3d::bf16*>(dk);
  auto* ov = static_cast<pose3d::bf16*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return dkv_dh<16>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, ok, ov, n, Lq, Lk, heads, s);
    case 32:
      return dkv_dh<32>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, ok, ov, n, Lq, Lk, heads, s);
    default:
      return dkv_dh<64>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, ok, ov, n, Lq, Lk, heads, s);
  }
}
