// Fused trunk of the default JointTransformerLifter for Hopper (sm_90a).
//
// Replaces the TPU kernel pose3d_tpu/ops/pallas_lifter.py::_trunk_kernel
// (entered through _trunk / lifter_forward_fused): both pre-LN transformer
// blocks of the reference MyViT, from the embedded tokens (the PE is added
// here) to the trunk output, on flat (B*17, 256) bf16 rows. Per block:
//   y = LN_b(LN_a(x)); qkv = bf16(y @ W_qkv);
//   per frame and head (4 x 64): s = q k^T / 8, e = exp(min(s, 80)),
//     o = bf16((bf16(e) @ v) / sum(e));
//   x += bf16(o @ W_proj);  y = LN_2(x);
//   h = bf16(gelu(bf16(y @ W1 + b1)));  x += bf16(h @ W2 + b2).
// The rounding points are those of the JAX kernel: activations bf16 (each
// LN's output too), f32 accumulation, f32 LayerNorm statistics and
// softmax, GELU on the clamped degree-8 polynomial erf of the JAX kernel
// (same coefficients).
//
// What bounds it on this card: operations. At B = 8192 (139,264 rows) the
// eight products are 2 · 139,264 · 786,432 · 2 = 438 GFLOP, 0.443 ms at
// 989 TFLOP/s, against 142 MB of tokens in and rows out (0.042 ms at 3.35
// TB/s).
//
// The first design kept a 4-frame tile (68 rows, padded to 80) in shared
// memory through both blocks and ran its products on common.cuh's 80-row
// engine: ldmatrix + mma.sync, a 3-slot cp.async ring of 32 x 256 weight
// chunks with a block-wide barrier per chunk, the LayerNorms, the scalar
// 17 x 17 attention and the epilogues in series between those barriers.
// It streamed all 3.1 MB of weights from L2 per 68 rows (6.44 GB a call)
// and took 3.97 ms (chip_smoke.py on an H100 80GB HBM3 at 700 W), the
// pace that engine set on the temporal sub-blocks too (~12% of the tensor
// rate).
//
// This design runs each block as the three launches of the temporal
// sub-block forward (subblock_sm90.cuh on rowtile_sm90.cuh, and the
// attention of attention.cu): 128-row tiles that ignore frame boundaries,
// a persistent grid, a producer warp streaming 32 KB weight chunks by TMA
// through an mbarrier ring, two consumer warpgroups on wgmma. Its traits
// give the trunk's layout and its three differences from the sub-block:
// the double LN (LN_a rounded to bf16, then LN_b, in the registers of the
// row the warp holds), no qkv bias and no projection bias. The first
// block's qkv_kernel adds pe[row % 17] to the token rows in its row pass
// and stores bf16(tokens + pe), the residual stream, for its rest_kernel.
// The price is HBM traffic: q|k|v (214 MB at B = 8192), the attention
// output and the residual stream go through device memory, ~1.9 GB a call
// in all (0.57 ms at 3.35 TB/s), where the first design kept them on chip;
// the weights' L2 stream falls to 3.1 MB per 128 rows (3.4 GB a call).
//
// One C call makes all 3 x n_blocks launches on the caller's stream, does
// not synchronise, allocates nothing (the wrapper allocates the scratch)
// and returns the first error (cudaGetLastError(), or that of a tensor
// map or a refused configuration).

#include "attention.cuh"
#include "subblock_sm90.cuh"

namespace {

using namespace pose3d;
namespace sb = pose3d::subblock;

constexpr int kJoints = 17;
constexpr int kHeads = 4;
constexpr int kDimHead = kDim / kHeads;
// The batch granularity of the wrapper's contract (FRAMES_PER_CTA, the
// first design's frame tile), which LifterService's buckets and the tests
// pin; the row tiles of this design do not need it.
constexpr int kFrames = 4;
static_assert(kJoints == sb::kPeRows, "the PE table has a row per joint");

// Layout of one block in the flat weight operand; must match
// ops/lifter.py::_BLOCK_LAYOUT (the launcher checks the total).
// Matrices are (in, out), row-major.
constexpr int kOffLnaG = 0;
constexpr int kOffLnaB = kOffLnaG + kDim;
constexpr int kOffLnbG = kOffLnaB + kDim;
constexpr int kOffLnbB = kOffLnbG + kDim;
constexpr int kOffWQkv = kOffLnbB + kDim;
constexpr int kOffWProj = kOffWQkv + kDim * kQkv;
constexpr int kOffLn2G = kOffWProj + kDim * kDim;
constexpr int kOffLn2B = kOffLn2G + kDim;
constexpr int kOffW1 = kOffLn2B + kDim;
constexpr int kOffB1 = kOffW1 + kDim * kMlp;
constexpr int kOffW2 = kOffB1 + kMlp;
constexpr int kOffB2 = kOffW2 + kMlp * kDim;
constexpr int kBlockElems = kOffB2 + kDim;

// The trunk's traits for subblock_sm90.cuh: the double LN, no qkv or
// projection bias (their offsets are never read).
struct Layout {
  static constexpr bool kDoubleLn = true, kQkvBias = false, kProjBias = false;
  static constexpr int kLn1G = kOffLnaG, kLn1B = kOffLnaB, kLnbG = kOffLnbG, kLnbB = kOffLnbB;
  static constexpr int kWQkv = kOffWQkv, kBQkv = 0, kWProj = kOffWProj, kBProj = 0;
  static constexpr int kLn2G = kOffLn2G, kLn2B = kOffLn2B, kW1 = kOffW1, kB1 = kOffB1,
                       kW2 = kOffW2, kB2 = kOffB2, kElems = kBlockElems;
};

}  // namespace

// tokens, out: (n_frames * 17, 256) bf16; pe: (17, 256) bf16; weights:
// n_blocks * block_elems bf16 in the layout above; scratch of the same
// dtype: resid (n_frames * 17, 256), the residual stream between blocks,
// qkv (n_frames * 17, 768) and attn (n_frames * 17, 256). Every pointer 16-
// byte aligned and contiguous; tokens is only read. frames_per_cta and
// block_elems are the caller's idea of the kernel's constants: a mismatch,
// or n_frames not a multiple of frames_per_cta, returns
// cudaErrorInvalidValue. Launches on the calling thread's current device,
// which must hold the operands: per block qkv_kernel, the attention,
// rest_kernel, out and resid taking turns as the block's output so that the
// last block writes out.
extern "C" cudaError_t lifter_trunk_launch(const void* tokens, const void* pe,
                                           const void* weights, void* resid, void* qkv,
                                           void* attn, void* out, int n_frames, int n_blocks,
                                           int frames_per_cta, int block_elems, void* stream) {
  if (n_frames < 0 || n_frames % kFrames != 0 || n_blocks < 1 ||
      static_cast<long long>(n_frames) * kJoints > (1 << 30) || frames_per_cta != kFrames ||
      block_elems != kBlockElems)
    return cudaErrorInvalidValue;
  if (n_frames == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_rows = n_frames * kJoints;
  const auto* wb = static_cast<const bf16*>(weights);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* outb = static_cast<bf16*>(out);
  auto* residb = static_cast<bf16*>(resid);
  const bf16* x = static_cast<const bf16*>(tokens);
  for (int blk = 0; blk < n_blocks; ++blk) {
    const bf16* w = wb + size_t(blk) * kBlockElems;
    bf16* dst = (n_blocks - 1 - blk) % 2 == 0 ? outb : residb;
    // the first block's residual stream, bf16(tokens + pe), goes to the
    // buffer that is not its output
    bf16* x0 = blk == 0 ? (dst == outb ? residb : outb) : nullptr;
    sb::Maps m;
    cudaError_t err = sb::make_maps<Layout>(&m, w, qkvb, n_rows);
    if (err == cudaSuccess)
      err = blk == 0 ? sb::launch_qkv<Layout, true>(m, x, w, static_cast<const bf16*>(pe), x0,
                                                    n_rows, s)
                     : sb::launch_qkv<Layout, false>(m, x, w, nullptr, nullptr, n_rows, s);
    if (err == cudaSuccess)
      err = launch_attention(qkvb, attnb, n_frames, kJoints, kHeads, kDimHead, 1,
                             {kJoints * kQkv, 0, kQkv}, {kJoints * kDim, 0, kDim}, s);
    if (err == cudaSuccess)
      err = sb::launch_rest<Layout, false>(m, blk == 0 ? x0 : x, w, attnb, dst, nullptr,
                                           n_rows, s);
    if (err != cudaSuccess) return err;
    x = dst;
  }
  return cudaGetLastError();
}

extern "C" const char* pose3d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
