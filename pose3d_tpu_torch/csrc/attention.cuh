// Multi-head self-attention of one (sequence, head): the attention kernel
// of attention.cu (also the temporal sub-block's, through
// launch_attention) and the per-query form that the spatial sub-block
// kernel of stblock.cu runs in shared memory. The math of
// pose3d_tpu/ops/pallas_attention.py's masked_heads_attention: f32 scores
// s = q.k * dh^-0.5, e = exp(min(s, 80)) with no row max, the normalizer
// summed from the f32 e, bf16(e) into the AV product, the divide folded
// into the output. A key position past the sequence never enters the sum.

#pragma once

#include "common.cuh"

namespace pose3d {

constexpr int kAttnWarps = 8;  // the most warps of one (sequence, head) block
constexpr int kAttnThreads = kAttnWarps * 32;

// K and V of one head (Q stays in registers), each seq rows padded to whole
// 16-row MMA tiles, at a pitch of dh + 8 bf16 (16 bytes of skew keep the 8
// rows of an ldmatrix on distinct banks): ops/attention.py::smem_bytes
// computes the same.
__host__ __device__ constexpr int attn_ld(int dh) { return dh + 8; }
__host__ __device__ constexpr int attn_rows(int seq) { return (seq + 15) / 16 * 16; }
__host__ __device__ constexpr size_t attn_smem_bytes(int seq, int dh) {
  return size_t(2) * attn_rows(seq) * attn_ld(dh) * 2;
}

// One query row of one head against L keys: q (global or shared memory),
// K and V rows in shared memory at pitch ld, e_s a per-warp f32 scratch of
// L entries in shared memory, dst the dh outputs. Lane l scores keys l,
// l + 32, ...; for the AV product lane l owns output dim l (dh 32), dims
// 2l and 2l + 1 (dh 64), or dim l % 16 over every other key (dh 16). One
// warp calls it; dst may be q itself (q is read before dst is written).
template <int DH>
__device__ __forceinline__ void attend_row(const bf16* q, const bf16* k, const bf16* v,
                                           int ld, int L, float* e_s, bf16* dst, int lane) {
  static_assert(DH == 16 || DH == 32 || DH == 64, "head widths 16, 32, 64");
  constexpr float kScale = DH == 16 ? 0.25f : DH == 32 ? 0.17677669529663687f : 0.125f;
  float qf[DH];
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    float t[8];
    load8(q + 8 * c, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[8 * c + i] = t[i];
  }
  float part = 0.f;
  for (int j = lane; j < L; j += 32) {
    const bf16* kr = k + j * ld;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      float t[8];
      load8(kr + 8 * c, t);
#pragma unroll
      for (int i = 0; i < 8; ++i) s = fmaf(qf[8 * c + i], t[i], s);
    }
    const float e = expf(fminf(s * kScale, kScoreClamp));
    part += e;
    e_s[j] = round_bf16(e);
  }
  const float inv = 1.f / warp_sum(part);
  __syncwarp();
  if constexpr (DH == 64) {
    float ox = 0.f, oy = 0.f;
    for (int j = 0; j < L; ++j) {
      const float e = e_s[j];
      const float2 vv = load2(v + j * ld + 2 * lane);
      ox = fmaf(e, vv.x, ox);
      oy = fmaf(e, vv.y, oy);
    }
    store2(dst + 2 * lane, ox * inv, oy * inv);
  } else if constexpr (DH == 32) {
    float o = 0.f;
    for (int j = 0; j < L; ++j) o = fmaf(e_s[j], __bfloat162float(v[j * ld + lane]), o);
    dst[lane] = __float2bfloat16(o * inv);
  } else {
    const int d = lane & 15;
    float o = 0.f;
    for (int j = lane >> 4; j < L; j += 2)
      o = fmaf(e_s[j], __bfloat162float(v[j * ld + d]), o);
    o += __shfl_xor_sync(0xffffffffu, o, 16);
    if (lane < 16) dst[d] = __float2bfloat16(o * inv);
  }
  __syncwarp();  // the next row overwrites e_s
}

// Attention over n_seq sequences of L rows of [q | k | v] (heads x dh
// each), one block per (sequence, head). Sequence s starts at
// (s / inner_n) * outer + (s % inner_n) * inner elements of qkv (of out),
// and its rows lie row elements apart: the flat (n·L, 3·dim) rows of
// attention.cu, or the (C, T, 17, 3·dim) joint sequences of the temporal
// slab. Every offset must keep 16-byte alignment. Launches on `stream`,
// returns cudaGetLastError() (or the error of a refused configuration).
struct SeqLayout {
  long long outer, inner, row;
};

cudaError_t launch_attention(const bf16* qkv, bf16* out, int n_seq, int L, int heads,
                             int dh, int inner_n, SeqLayout in, SeqLayout o,
                             cudaStream_t stream);

}  // namespace pose3d
