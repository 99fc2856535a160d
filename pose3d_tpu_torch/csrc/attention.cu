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
// below it. So it is bound by bytes, and the design reads qkv once: Q, K
// and V of the block's head go to shared memory, each warp takes 16-row
// query tiles through all keys with ldmatrix + mma.sync, and the output
// leaves once. The exp per score (L^2 per head) runs on the SFU beside
// them. Packing several short sequences into one block (seq 17 pads each
// to 32 rows) is later work.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "attention.cuh"

namespace {

using namespace pose3d;

// Q K^T and P V of one 16-row query tile on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate), 16 keys at a time. No row max is
// kept, so nothing is rescaled between key blocks: e = exp(min(s, 80))
// from the f32 scores goes to bf16 as the A operand of P V straight from
// the score accumulators (their C layout is the A layout), and the f32
// row sums of e divide the output at the end. Keys past L get e = 0; the
// zero rows that pad Q, K and V to whole tiles keep every product finite.
template <int DH>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int heads,
                 int inner_n, SeqLayout in, SeqLayout o) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = attn_ld(DH);
  constexpr float kScale = DH == 16 ? 0.25f : DH == 32 ? 0.17677669529663687f : 0.125f;
  const int rows = attn_rows(L);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * ld;
  bf16* vs = ks + rows * ld;
  const int seq = blockIdx.x;
  const int head = blockIdx.y;
  const int dim = heads * DH;
  const bf16* src = qkv + (seq / inner_n) * in.outer + (seq % inner_n) * in.inner;
  bf16* dst = out + (seq / inner_n) * o.outer + (seq % inner_n) * o.inner;

  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < rows * (DH / 8); i += kAttnThreads) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    bf16* q = qs + r * ld + c;
    bf16* k = ks + r * ld + c;
    bf16* v = vs + r * ld + c;
    if (r < L) {
      const bf16* row = src + r * in.row + head * DH + c;
      copy16(q, row);
      copy16(k, row + dim);
      copy16(v, row + 2 * dim);
    } else {
      *reinterpret_cast<uint4*>(q) = zero16;
      *reinterpret_cast<uint4*>(k) = zero16;
      *reinterpret_cast<uint4*>(v) = zero16;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / 4;  // accumulator rows g and g + 8, columns 2q and 2q + 1
  const int q4 = lane % 4;
  // ldmatrix lane offsets: A and .trans B operands take row lane % 16 at
  // column (lane / 16) * 8; the K^T operand takes key (lane / 16) * 8 +
  // lane % 8 at column ((lane / 8) % 2) * 8
  const int a_off = (lane % 16) * ld + (lane / 16) * 8;
  const int k_off = ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
  for (int qt = warp; qt < rows / 16; qt += kAttnWarps) {
    unsigned qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldsm_x4(qa[kk], smem_u32(qs + qt * 16 * ld + a_off + kk * 16));
    float acc[DH / 8][4] = {};
    float sum0 = 0.f, sum1 = 0.f;
    for (int kb = 0; kb < rows / 16; ++kb) {
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        unsigned kf[4];
        ldsm_x4(kf, smem_u32(ks + kb * 16 * ld + k_off + kk * 16));
        mma_bf16(s[0], qa[kk], kf[0], kf[1]);
        mma_bf16(s[1], qa[kk], kf[2], kf[3]);
      }
      unsigned pa[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int key = kb * 16 + nb * 8 + 2 * q4;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = key + (i & 1) < L ? expf(fminf(s[nb][i] * kScale, kScoreClamp)) : 0.f;
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
        ldsm_x4_trans(vf, smem_u32(vs + kb * 16 * ld + a_off + d * 16));
        mma_bf16(acc[2 * d], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * d + 1], pa, vf[2], vf[3]);
      }
    }
    // the four lanes of a quad hold the partial sums of the same two rows
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.f / sum0;
    const float inv1 = 1.f / sum1;
    const int r0 = qt * 16 + g;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      const int col = head * DH + nb * 8 + 2 * q4;
      if (r0 < L) store2(dst + r0 * o.row + col, acc[nb][0] * inv0, acc[nb][1] * inv0);
      if (r0 + 8 < L)
        store2(dst + (r0 + 8) * o.row + col, acc[nb][2] * inv1, acc[nb][3] * inv1);
    }
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
  attention_kernel<DH><<<dim3(n_seq, heads), kAttnThreads, smem, stream>>>(
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
