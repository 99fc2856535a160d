// Multi-head self-attention over [q | k | v] rows for Hopper (sm_90a).
//
// Replaces two TPU kernels of pose3d_tpu/ops/pallas_attention.py:
// _packed_kernel (entered through packed_flat_attention: n sequences of
// seq <= 64 rows packed into one block-diagonal product, to fill the TPU's
// 128-wide matrix unit) and _seq_kernel (entered through seq_attention: one
// L-row sequence per grid cell, L = 243 on the temporal axis). On this card
// the packing has no purpose: both are the same function on the same bytes
// ((n, L, 3·dim) contiguous rows are (n·L, 3·dim) flat rows), so one kernel
// serves both wrappers of ops/attention.py, one block per (sequence, head).
//
// What bounds it on this card. Per token it reads 3·dim bf16 and writes
// dim, and does 4·L·dim flops: at L = 17 that is ~9 flops a byte, far below
// the H100's ~295 bf16 tensor flops per byte of HBM; at L = 243 ~120, still
// below it. So it is bound by bytes: at 272 sequences x 243 x (8 x 32) a
// call reads 101.5 MB and writes 33.8 MB, 0.040 ms at 3.35 TB/s. Beside the
// bytes, the exp of every score (L^2 per head, 142.6 M at that shape) runs
// on the SFU, whose 16 results a clock an SM take ~0.038 ms: the two floors
// are close, so the kernel has to keep loads, products and exps in flight
// at once.
//
// The design keeps latency hidden rather than bytes low (qkv is read once,
// the output written once):
// - Q never enters shared memory: each warp loads the A fragments of its
//   16-row query tiles straight from device memory into registers. Shared
//   memory holds K and V only (2 x 256 x 40 x 2 = 41 KB at L = 243), and
//   three 8-warp blocks share an SM, held there by the register file at
//   80 registers a thread (four blocks at 64 spilled and ran 4% slower):
//   24 warps where the first design had 12.
// - K and V land by cp.async in kAttnStages commit groups of key blocks;
//   a warp multiplies the keys of a group as soon as it has landed, while
//   the later groups are still in flight.
// - Only the last, ragged 16-key block (keys 240-255 at L = 243) is
//   masked; the full blocks run without a compare per element.
// - e = 2^(min(s·scale·log2 e, 80·log2 e)) on the SFU's ex2 with the scale
//   folded into one multiply: the same exp(min(s·scale, 80)) to well
//   within the rounding of bf16(e).
// Each warp takes query tiles warp, warp + warps, ...; a block has
// min(8, tiles) warps, so that every warp has a first tile (L = 17: 2
// warps). Scores stay in registers: nothing of size L x L is stored.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "attention.cuh"

namespace {

using namespace pose3d;

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

}  // namespace

namespace pose3d {

cudaError_t launch_attention(const bf16* qkv, bf16* out, int n_seq, int L, int heads,
                             int dh, int inner_n, SeqLayout in, SeqLayout o,
                             cudaStream_t stream) {
  if (n_seq < 0 || L < 1 || heads < 1 || heads > 65535 || inner_n < 1 ||
      attn_smem_bytes(L, dh) > size_t(kSmemLimit))
    return cudaErrorInvalidValue;
  if (n_seq == 0) return cudaSuccess;
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
