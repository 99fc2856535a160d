// The two halves of the temporal lifter's SpatioTemporalBlock for Hopper
// (sm_90a): one pre-LN transformer sub-block
//   y = LN_1(x); qkv = bf16(y @ W_qkv + b_qkv);
//   o = 8-head x 32 attention (per frame over its 17 joints, or per joint
//       over the clip's T frames);
//   x += bf16(o @ W_proj + b_proj);  y = LN_2(x);
//   h = bf16(gelu(bf16(y @ W1 + b1)));  x += bf16(h @ W2 + b2)
// on flat (rows, 256) bf16 token rows, frame-major: row (c·T + t)·17 + j is
// joint j of frame t of clip c. Rounding as in the JAX kernels: f32
// accumulation and LayerNorm statistics, bf16 activations, the polynomial
// GELU and the clamped softmax of common.cuh / attention.cuh.
//
// Replaces two TPU kernels of pose3d_tpu/ops/pallas_stblock.py:
// - _spatial_kernel (spatial_block_fused): stblock_spatial_launch, ONE
//   kernel. A CTA holds 4 whole frames (68 rows of the 80-row tile) from
//   input to output, as csrc/lifter_trunk.cu does for the lifter; each
//   (frame, head) is one warp's 17x17 attention in shared memory.
// - _temporal_slab_kernel (temporal_slab_fused): stblock_temporal_launch,
//   THREE kernels in a row. A joint's sequence is T = 243 rows whose q|k|v
//   (243 x 768 bf16, 373 KB) does not fit in a CTA's shared memory, so:
//   (1) LN_1 + qkv on 80-row tiles -> a global qkv scratch; (2) the
//   attention kernel of attention.cu, one block per (clip, joint, head),
//   reading that head's K and V (T x 32) into shared memory -> a global
//   attention scratch; (3) projection + residual, LN_2 + MLP + residual on
//   80-row tiles. Phases (1) and (3) do not care which rows share a
//   sequence, so their tiles ignore frame boundaries. The wrapper
//   allocates both scratches.
// - _temporal_kernel (temporal_block_fused :161, one joint-major (L, 256)
//   sequence per grid cell): stblock_sequences_launch, the same three
//   launches on n joint-major sequences of L rows each, contiguous. Only
//   the attention's layout differs: sequence s is rows s·L ... s·L + L - 1.
//   Each sequence reads its rows in the same order as the slab's, so the
//   two layouts of the same tokens give the same bits.
//
// What bounds it on this card. 1.57 MFLOP per token of dense products
// against 1 KB of activations in and out: far above the H100's ~295 bf16
// flops per byte of HBM, so the tensor cores should bound it. But the
// weights (1.57 MB a sub-block) do not fit in shared memory, and every CTA
// streams all of them from L2 for its 68 or 80 rows (the GEMM engine of
// common.cuh): as for the lifter trunk, the L2 stream sets the pace. What
// a CTA can keep in shared memory caps the tile and so that ratio.
//
// The training forwards (pallas_stblock_train.py _spatial_fwd_kernel :348,
// _temporal_fwd_kernel :379, _temporal_slab_fwd_kernel :407) are the same
// launchers given residual pointers, which select the kSave kernels: they
// also store x1 and att, which the backward (stblock_train.cu) reads. Both
// are in shared memory already when the kernel reaches them, so the cost
// is two stores of the tile's rows. Serving passes null and runs the
// kernels it always ran.
//
// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError().

#include "attention.cuh"

namespace {

using namespace pose3d;

constexpr int kJoints = 17;
constexpr int kHeads = 8;
constexpr int kDimHead = kDim / kHeads;

constexpr int kFrames = 4;                       // FRAMES_PER_CTA
constexpr int kSpatialRows = kFrames * kJoints;  // 68 real rows per spatial CTA
static_assert(kSpatialRows <= kRowsPad, "a frame tile fits the row tile");

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

constexpr size_t kSmemScores = size_t(kWarps) * 32 * sizeof(float);  // e_s, 17 used
constexpr size_t kSmemBytes = kSmemX + kSmemBig + kSmemRing + kSmemScores;
static_assert(kSmemBytes <= kSmemLimit, "exceeds the per-block shared memory");

// What one launch of sub_block_kernel does with its tile.
enum class Part {
  kWhole,  // the whole sub-block with per-frame attention: x -> out
  kQkv,    // LN_1 + qkv: x -> out = (rows, 768) q|k|v
  kRest,   // projection + residual, MLP + residual: x, attn -> out
};

// kSave (training forwards): also store x1, the residual stream after the
// projection, and for kWhole the attention output, to global memory.
template <Part P, bool kSave = false>
__global__ void __launch_bounds__(kThreads, 1)
sub_block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ weights,
                 const bf16* __restrict__ attn, bf16* __restrict__ out, int n_rows,
                 bf16* __restrict__ x1_out, bf16* __restrict__ att_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);   // residual stream
  bf16* big = xs + kRowsPad * kLdX;           // see common.cuh
  bf16* ring = big + kRowsPad * kLdBig;       // weight chunks in flight
  float* es = reinterpret_cast<float*>(ring + kRing * kChunkElems);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kTile = P == Part::kWhole ? kSpatialRows : kRowsPad;
  const size_t row0 = size_t(blockIdx.x) * kTile;
  const int rows = min(kTile, static_cast<int>(n_rows - row0));
  // the sub-block's chunks: all, the qkv passes only, or all but those
  constexpr int kFirst = P == Part::kRest ? kChunksQkv : 0;
  constexpr int kLast = P == Part::kQkv ? kChunksQkv : kChunksPerBlock;
  WeightStream ws{weights, ring, {kOffWQkv, kOffWProj, kOffW1, kOffW2, kBlockElems},
                  kFirst, kLast - kFirst, 0, 0};
  for (int i = 0; i < kRing - 1; ++i) ws.issue();  // overlaps the tile load

  if (P != Part::kQkv) {
    for (int idx = threadIdx.x; idx < rows * (kDim / 8); idx += kThreads) {
      const int r = idx / (kDim / 8);
      const int c = (idx % (kDim / 8)) * 8;
      copy16(xs + r * kLdX + c, x + (row0 + r) * kDim + c);
    }
    zero_pad_rows(xs, kLdX, rows);
  }
  if (P == Part::kRest) {
    for (int idx = threadIdx.x; idx < rows * (kDim / 8); idx += kThreads) {
      const int r = idx / (kDim / 8);
      const int c = (idx % (kDim / 8)) * 8;
      copy16(big + r * kLdBig + kColQ + c, attn + (row0 + r) * kDim + c);
    }
  }
  zero_pad_rows(big, kLdBig, rows);
  __syncthreads();

  Acc acc;
  if (P != Part::kRest) {
    // y = LN_1(x) into v's columns
    for (int r = warp; r < rows; r += kWarps) {
      const bf16* src = P == Part::kQkv ? x + (row0 + r) * kDim : xs + r * kLdX;
      layer_norm_row(src, big + r * kLdBig + kColV, weights + kOffLn1G, weights + kOffLn1B,
                     lane);
    }
    __syncthreads();

    // q | k | v = bf16(y @ W_qkv + b_qkv), pass by pass; the v pass
    // overwrites y, so every warp finishes reading y before any writes
    for (int pass = 0; pass < kQkv / kTileN; ++pass) {
      zero(acc);
      mma_pass<kDim>(big + kColV, kLdBig, ws, warp, lane, acc);
      if (pass == kQkv / kTileN - 1) __syncthreads();
      bf16* dst = big + pass * kTileN;
      epilogue(acc, weights + kOffBQkv + pass * kTileN, warp, lane, rows,
               [&](int r, int c, float v0, float v1) { store2(dst + r * kLdBig + c, v0, v1); });
    }
    __syncthreads();

    if (P == Part::kQkv) {
      for (int idx = threadIdx.x; idx < rows * (kQkv / 8); idx += kThreads) {
        const int r = idx / (kQkv / 8);
        const int c = (idx % (kQkv / 8)) * 8;
        copy16(out + (row0 + r) * kQkv + c, big + r * kLdBig + c);
      }
      return;
    }

    // per (frame, head): 17 queries x 17 keys; query i's output overwrites
    // its own q columns of this head, which no other query reads
    float* e_s = es + warp * 32;
    for (int p = warp; p < (rows / kJoints) * kHeads; p += kWarps) {
      bf16* f = big + (p / kHeads) * kJoints * kLdBig + (p % kHeads) * kDimHead;
      for (int i = 0; i < kJoints; ++i)
        attend_row<kDimHead>(f + i * kLdBig + kColQ, f + kColK, f + kColV, kLdBig, kJoints,
                             e_s, f + i * kLdBig + kColQ, lane);
    }
    __syncthreads();
    if (kSave) {
      for (int idx = threadIdx.x; idx < rows * (kDim / 8); idx += kThreads) {
        const int r = idx / (kDim / 8);
        const int c = (idx % (kDim / 8)) * 8;
        copy16(att_out + (row0 + r) * kDim + c, big + r * kLdBig + kColQ + c);
      }
    }
  }

  // x += bf16(o @ W_proj + b_proj)
  zero(acc);
  mma_pass<kDim>(big + kColQ, kLdBig, ws, warp, lane, acc);
  epilogue(acc, weights + kOffBProj, warp, lane, rows, [&](int r, int c, float v0, float v1) {
    residual_add2(xs + r * kLdX + c, v0, v1);
  });
  __syncthreads();
  if (kSave) {
    for (int idx = threadIdx.x; idx < rows * (kDim / 8); idx += kThreads) {
      const int r = idx / (kDim / 8);
      const int c = (idx % (kDim / 8)) * 8;
      copy16(x1_out + (row0 + r) * kDim + c, xs + r * kLdX + c);
    }
  }

  mlp_residual(xs, big, ws, weights + kOffLn2G, weights + kOffLn2B, weights + kOffB1,
               weights + kOffB2, rows, warp, lane);

  for (int idx = threadIdx.x; idx < rows * (kDim / 8); idx += kThreads) {
    const int r = idx / (kDim / 8);
    const int c = (idx % (kDim / 8)) * 8;
    copy16(out + (row0 + r) * kDim + c, xs + r * kLdX + c);
  }
}

template <Part P, bool kSave = false>
cudaError_t launch_part(const bf16* x, const bf16* w, const bf16* attn, bf16* out, int n_rows,
                        cudaStream_t stream, bf16* x1_out = nullptr,
                        bf16* att_out = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(sub_block_kernel<P, kSave>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  constexpr int kTile = P == Part::kWhole ? kSpatialRows : kRowsPad;
  sub_block_kernel<P, kSave><<<(n_rows + kTile - 1) / kTile, kThreads, kSmemBytes, stream>>>(
      x, w, attn, out, n_rows, x1_out, att_out);
  return cudaGetLastError();
}

// The temporal sub-block's three launches on n_rows rows that hold n_seq
// sequences of L rows, laid out for the attention as `in` (qkv) and `o`
// (attn) say; a non-null x1 selects the kSave kernels.
cudaError_t launch_sequences(const void* x, const void* weights, void* qkv, void* attn, void* x1,
                             void* out, int n_rows, int n_seq, int L, int inner_n, SeqLayout in,
                             SeqLayout o, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(weights);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  cudaError_t err = launch_part<Part::kQkv>(xb, wb, nullptr, qkvb, n_rows, s);
  if (err != cudaSuccess) return err;
  err = launch_attention(qkvb, attnb, n_seq, L, kHeads, kDimHead, inner_n, in, o, s);
  if (err != cudaSuccess) return err;
  if (x1 == nullptr)
    return launch_part<Part::kRest>(xb, wb, attnb, static_cast<bf16*>(out), n_rows, s);
  return launch_part<Part::kRest, true>(xb, wb, attnb, static_cast<bf16*>(out), n_rows, s,
                                        static_cast<bf16*>(x1), nullptr);
}

}  // namespace

// x, out: (n_frames * 17, 256) bf16 rows; weights: block_elems bf16 in the
// layout above. frames_per_cta and block_elems are the caller's idea of
// the kernel's constants: a mismatch returns cudaErrorInvalidValue. A last
// tile of fewer than 4 frames runs with its missing frames as zero rows,
// which no real frame sees. x1 and att are null for serving; the training
// forward passes both, shaped like x, and the kSave kernel also stores the
// residuals there. Passing only one is cudaErrorInvalidValue. Launches on
// the calling thread's current device, which must hold the operands.
extern "C" cudaError_t stblock_spatial_launch(const void* x, const void* weights, void* out,
                                              void* x1, void* att, int n_frames,
                                              int frames_per_cta, int block_elems,
                                              void* stream) {
  if (n_frames < 0 || n_frames > (1 << 30) / kJoints || frames_per_cta != kFrames ||
      block_elems != kBlockElems || (x1 == nullptr) != (att == nullptr))
    return cudaErrorInvalidValue;
  if (n_frames == 0) return cudaSuccess;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(weights);
  const auto s = static_cast<cudaStream_t>(stream);
  if (x1 == nullptr)
    return launch_part<Part::kWhole>(xb, wb, nullptr, static_cast<bf16*>(out),
                                     n_frames * kJoints, s);
  return launch_part<Part::kWhole, true>(xb, wb, nullptr, static_cast<bf16*>(out),
                                         n_frames * kJoints, s, static_cast<bf16*>(x1),
                                         static_cast<bf16*>(att));
}

// x, out: (n_clips, T, 17 * 256) bf16, the frame-major slab (the spatial
// kernel's rows, reshaped); qkv: (n_clips * T * 17, 768) and attn:
// (n_clips * T * 17, 256) bf16 scratch. Three launches in a row (see
// above); the first error ends the sequence and is returned. x1 is null
// for serving; the training forward passes it, shaped like x, and keeps
// attn as its att residual.
extern "C" cudaError_t stblock_temporal_launch(const void* x, const void* weights, void* qkv,
                                               void* attn, void* x1, void* out, int n_clips,
                                               int T, int block_elems, void* stream) {
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

// x, out: (n_seqs, L, 256) bf16, joint-major: sequence s is rows s·L ...
// s·L + L - 1; qkv: (n_seqs * L, 768) and attn: (n_seqs * L, 256) bf16
// scratch. The same three launches as stblock_temporal_launch, and the same
// meaning of x1 and of the returned error; an L whose K and V do not fit in
// shared memory returns cudaErrorInvalidValue.
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
