// Multi-head self-attention of one (sequence, head): attention.cu's two
// routes behind launch_attention, which the lifter trunk (lifter_trunk.cu)
// and the sub-blocks (stblock.cu) launch too. The math of
// pose3d_tpu/ops/pallas_attention.py's masked_heads_attention: f32 scores
// s = q.k * dh^-0.5, e = exp(min(s, 80)) with no row max, the normalizer
// summed from the f32 e, bf16(e) into the AV product, the divide folded
// into the output. A key position past the sequence never enters the sum.
// Sequences of L <= kAttnSplitLen rows take attention_kernel (mma.sync,
// 16-row query tiles, Q in registers); longer ones attention_wg_kernel
// (wgmma on 64-query tiles fed by TMA). ops/attention.py's SPLIT_LEN is
// the same length.

#pragma once

#include "common.cuh"

namespace pose3d {

constexpr int kAttnSplitLen = 64;  // the longest L of attention_kernel
constexpr int kAttnWarps = 8;      // the most warps of one (sequence, head) block
constexpr int kAttnThreads = kAttnWarps * 32;

// attention_kernel's K and V of one head (Q stays in registers), each seq
// rows padded to whole 16-row MMA tiles, at a pitch of dh + 8 bf16 (16
// bytes of skew keep the 8 rows of an ldmatrix on distinct banks):
// ops/attention.py::smem_bytes computes the same. Both routes take the L
// this allows.
__host__ __device__ constexpr int attn_ld(int dh) { return dh + 8; }
__host__ __device__ constexpr int attn_rows(int seq) { return (seq + 15) / 16 * 16; }
__host__ __device__ constexpr size_t attn_smem_bytes(int seq, int dh) {
  return size_t(2) * attn_rows(seq) * attn_ld(dh) * 2;
}

// Attention over n_seq sequences of L rows of [q | k | v] (heads x dh
// each). Sequence s starts at (s / inner_n) * outer + (s % inner_n) *
// inner elements of qkv (of out), and its rows lie row elements apart: the
// flat (n·L, 3·dim) rows of attention.cu, or the (C, T, 17, 3·dim) joint
// sequences of the temporal slab; where inner_n > 1, n_seq is a multiple
// of it. Every offset must keep 16-byte alignment. Launches on `stream`,
// returns cudaGetLastError() (or the error of a refused configuration).
struct SeqLayout {
  long long outer, inner, row;
};

cudaError_t launch_attention(const bf16* qkv, bf16* out, int n_seq, int L, int heads,
                             int dh, int inner_n, SeqLayout in, SeqLayout o,
                             cudaStream_t stream);

}  // namespace pose3d
