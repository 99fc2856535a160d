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
// qkv_kernel and rest_kernel live in subblock_sm90.cuh, which the lifter
// trunk (lifter_trunk.cu) shares; this file gives them its layout (one LN,
// biases on qkv and the projection). Shared memory of a 128-row tile (1 KB
// of alignment slack, the ring of 32 KB stages, the 64 KB A operand, the
// mbarriers):
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
#include "subblock_sm90.cuh"

namespace {

using namespace pose3d;
namespace sb = pose3d::subblock;

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

// The sub-block's traits for subblock_sm90.cuh: one LN before qkv, biases
// on qkv and the projection.
struct Layout {
  static constexpr bool kDoubleLn = false, kQkvBias = true, kProjBias = true;
  static constexpr int kLn1G = kOffLn1G, kLn1B = kOffLn1B, kLnbG = 0, kLnbB = 0;
  static constexpr int kWQkv = kOffWQkv, kBQkv = kOffBQkv, kWProj = kOffWProj,
                       kBProj = kOffBProj;
  static constexpr int kLn2G = kOffLn2G, kLn2B = kOffLn2B, kW1 = kOffW1, kB1 = kOffB1,
                       kW2 = kOffW2, kB2 = kOffB2, kElems = kBlockElems;
};

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
  sb::Maps m;
  cudaError_t err = sb::make_maps<Layout>(&m, wb, qkvb, n_rows);
  if (err == cudaSuccess)
    err = sb::launch_qkv<Layout, false>(m, xb, wb, nullptr, nullptr, n_rows, s);
  if (err == cudaSuccess)
    err = launch_attention(qkvb, attnb, n_seq, L, kHeads, kDimHead, inner_n, in, o, s);
  if (err != cudaSuccess) return err;
  if (x1 == nullptr)
    return sb::launch_rest<Layout, false>(m, xb, wb, attnb, static_cast<bf16*>(out), nullptr,
                                          n_rows, s);
  return sb::launch_rest<Layout, true>(m, xb, wb, attnb, static_cast<bf16*>(out),
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
