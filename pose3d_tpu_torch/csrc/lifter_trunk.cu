// Fused trunk of the default JointTransformerLifter for Hopper (sm_90a).
//
// Replaces the TPU kernel pose3d_tpu/ops/pallas_lifter.py::_trunk_kernel
// (entered through _trunk / lifter_forward_fused): both pre-LN transformer
// blocks of the reference MyViT, from the embedded tokens (the PE is added
// here) to the trunk output, on flat (B*17, 256) bf16 rows. Per block:
//   y = LN_b(LN_a(x)); qkv = bf16(y @ W_qkv);
//   per frame and head: s = q k^T / 8, e = exp(min(s, 80)),
//     o = bf16((bf16(e) @ v) / sum(e));
//   x += bf16(o @ W_proj);  y = LN_2(x);
//   h = bf16(gelu(bf16(y @ W1 + b1)));  x += bf16(h @ W2 + b2).
// The rounding points are those of the JAX kernel: activations bf16, f32
// accumulation, f32 LayerNorm statistics and softmax, GELU on the clamped
// degree-8 polynomial erf of the JAX kernel (same coefficients).
//
// What bounds it on this card. The weights (3.1 MB of bf16 for two blocks)
// do not fit in shared memory, so every CTA streams all of them from L2,
// and the L2 traffic is 3.1 MB per frame tile: with FRAMES_PER_CTA = 4
// (68 rows, padded to 80 for the 16-row MMA tiles), 6.3 GB at B=8192 for
// 0.55 TFLOP of padded MMA work. What a CTA can keep in shared memory (227
// KB) caps the tile and so sets that ratio. On an H100 SXM (700 W) a
// 32x256 weight chunk took ~1,500 cycles whether a CTA held 2 frames or 4,
// so the L2 stream, not the tensor cores, sets the pace.
//
// What the design does about it. The tile's activations never leave
// shared memory between the input and the output: the residual stream x
// (80x256), and one 80x768 buffer that holds in turn the LN output and
// q|k|v (the LN output in v's columns, overwritten by the last qkv pass),
// the attention output (written over q, row by row, as each query is
// done), then the LN_2 output beside one 512-column half of the MLP
// hidden. The W2 product of the two halves accumulates in registers. The
// weights stream through a 3-slot cp.async ring in 32x256 chunks, two
// chunks ahead of the MMAs and across product boundaries, so that each
// weight element is read once per CTA; warp w computes columns
// [32w, 32w + 32) of each 256-column pass for all 80 rows with
// ldmatrix + mma.sync (m16n8k16, bf16 in, f32 accumulate). Attention needs
// no mask: one warp per (frame, head) computes the 17x17 scores directly.
// Sharing weight chunks across a thread-block cluster (TMA multicast),
// wgmma and a warp-specialised producer are later work.
//
// The launcher runs on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace pose3d;

constexpr int kJoints = 17;
constexpr int kHeads = 4;
constexpr int kDimHead = kDim / kHeads;

constexpr int kFrames = 4;                       // FRAMES_PER_CTA
constexpr int kRows = kFrames * kJoints;         // 68 real rows per CTA
static_assert(kRows <= kRowsPad, "a frame tile fits the row tile");

constexpr float kScale = 0.125f;                 // kDimHead ** -0.5

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

constexpr size_t kSmemBytes = kSmemX + kSmemBig + kSmemRing;
static_assert(kSmemBytes <= kSmemLimit, "exceeds the per-block shared memory");

// Attention of one (frame, head): 17 queries x 17 keys, no mask needed.
// Lane j < 17 holds key row j; every lane holds value dims 2*lane and
// 2*lane+1 of all 17 rows. Scores f32, e = exp(min(s, 80)) with no row
// max, the normalizer summed from the f32 e, bf16(e) into the AV product,
// the divide folded into the output (pallas_attention.masked_heads_attention).
// Query i's output overwrites q_i in place: no later query reads q_i, and
// the warp's shuffles order every lane's reads of q_i before the write.
__device__ __forceinline__ void attention_frame_head(bf16* big, int frame, int head,
                                                     int lane) {
  bf16* base = big + frame * kJoints * kLdBig + head * kDimHead;
  const int key = lane < kJoints ? lane : 0;  // idle lanes shadow row 0
  __nv_bfloat162 kreg[kDimHead / 2];
  const __nv_bfloat162* krow =
      reinterpret_cast<const __nv_bfloat162*>(base + key * kLdBig + kColK);
#pragma unroll
  for (int d = 0; d < kDimHead / 2; ++d) kreg[d] = krow[d];
  __nv_bfloat162 vreg[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j)
    vreg[j] = *reinterpret_cast<const __nv_bfloat162*>(base + j * kLdBig + kColV + 2 * lane);

  for (int i = 0; i < kJoints; ++i) {
    const __nv_bfloat162* qrow =
        reinterpret_cast<const __nv_bfloat162*>(base + i * kLdBig + kColQ);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kDimHead / 2; ++d) {
      const float2 q = __bfloat1622float2(qrow[d]);
      const float2 k = __bfloat1622float2(kreg[d]);
      s = fmaf(q.x, k.x, s);
      s = fmaf(q.y, k.y, s);
    }
    const float e = lane < kJoints ? expf(fminf(s * kScale, kScoreClamp)) : 0.f;
    const float inv = 1.f / warp_sum(e);
    const float eb = round_bf16(e);
    float ox = 0.f, oy = 0.f;
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
      const float ej = __shfl_sync(0xffffffffu, eb, j);
      const float2 v = __bfloat1622float2(vreg[j]);
      ox = fmaf(ej, v.x, ox);
      oy = fmaf(ej, v.y, oy);
    }
    store2(base + i * kLdBig + kColQ + 2 * lane, ox * inv, oy * inv);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lifter_trunk_kernel(const bf16* __restrict__ tokens, const bf16* __restrict__ pe,
                    const bf16* __restrict__ weights, bf16* __restrict__ out,
                    int n_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);   // residual stream
  bf16* big = xs + kRowsPad * kLdX;           // see the column regions above
  bf16* ring = big + kRowsPad * kLdBig;       // weight chunks in flight
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  WeightStream ws{weights, ring, {kOffWQkv, kOffWProj, kOffW1, kOffW2, kBlockElems}, 0,
                  n_blocks * kChunksPerBlock, 0, 0};
  for (int i = 0; i < kRing - 1; ++i) ws.issue();  // overlaps the token load
  const size_t row0 = size_t(blockIdx.x) * kRows;

  // x = bf16(tokens + pe[row % 17]); the pad rows of both buffers are
  // zeroed once and never written again (the phases touch real rows only)
  for (int idx = threadIdx.x; idx < kRows * (kDim / 8); idx += kThreads) {
    const int r = idx / (kDim / 8);
    const int c = (idx % (kDim / 8)) * 8;
    float v[8], p[8];
    load8(tokens + (row0 + r) * kDim + c, v);
    load8(pe + (r % kJoints) * kDim + c, p);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += p[j];
    store8(xs + r * kLdX + c, v);
  }
  zero_pad_rows(xs, kLdX, kRows);
  zero_pad_rows(big, kLdBig, kRows);
  __syncthreads();

  Acc acc;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const bf16* w = weights + size_t(blk) * kBlockElems;

    // y = LN_b(LN_a(x)), the block's pre-LN then the attention's own LN,
    // into v's columns
    for (int r = warp; r < kRows; r += kWarps) {
      bf16* y = big + r * kLdBig + kColV;
      layer_norm_row(xs + r * kLdX, y, w + kOffLnaG, w + kOffLnaB, lane);
      layer_norm_row(y, y, w + kOffLnbG, w + kOffLnbB, lane);
    }
    __syncthreads();

    // q | k | v = bf16(y @ W_qkv), pass by pass; the v pass overwrites y,
    // so every warp finishes reading y before any writes
    for (int pass = 0; pass < kQkv / kTileN; ++pass) {
      zero(acc);
      mma_pass<kDim>(big + kColV, kLdBig, ws, warp, lane, acc);
      if (pass == kQkv / kTileN - 1) __syncthreads();
      bf16* dst = big + pass * kTileN;
      epilogue(acc, nullptr, warp, lane, kRows, [&](int r, int c, float v0, float v1) {
        store2(dst + r * kLdBig + c, v0, v1);
      });
    }
    __syncthreads();

    for (int p = warp; p < kFrames * kHeads; p += kWarps)
      attention_frame_head(big, p / kHeads, p % kHeads, lane);
    __syncthreads();

    // x += bf16(o @ W_proj)
    zero(acc);
    mma_pass<kDim>(big + kColQ, kLdBig, ws, warp, lane, acc);
    epilogue(acc, nullptr, warp, lane, kRows, [&](int r, int c, float v0, float v1) {
      residual_add2(xs + r * kLdX + c, v0, v1);
    });
    __syncthreads();

    mlp_residual(xs, big, ws, w + kOffLn2G, w + kOffLn2B, w + kOffB1, w + kOffB2, kRows,
                 warp, lane);
  }

  for (int idx = threadIdx.x; idx < kRows * (kDim / 8); idx += kThreads) {
    const int r = idx / (kDim / 8);
    const int c = (idx % (kDim / 8)) * 8;
    copy16(out + (row0 + r) * kDim + c, xs + r * kLdX + c);
  }
}

}  // namespace

// tokens, out: (n_frames * 17, 256) bf16; pe: (17, 256) bf16; weights:
// n_blocks * block_elems bf16 in the layout above. frames_per_cta and
// block_elems are the caller's idea of the kernel's constants: a mismatch
// returns cudaErrorInvalidValue instead of computing garbage. Launches on
// the calling thread's current device, which must hold the operands.
extern "C" cudaError_t lifter_trunk_launch(const void* tokens, const void* pe,
                                           const void* weights, void* out,
                                           int n_frames, int n_blocks,
                                           int frames_per_cta, int block_elems,
                                           void* stream) {
  if (n_frames < 0 || n_frames % kFrames != 0 || n_blocks < 1 ||
      frames_per_cta != kFrames || block_elems != kBlockElems)
    return cudaErrorInvalidValue;
  if (n_frames == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(lifter_trunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  lifter_trunk_kernel<<<n_frames / kFrames, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tokens), static_cast<const bf16*>(pe),
      static_cast<const bf16*>(weights), static_cast<bf16*>(out), n_blocks);
  return cudaGetLastError();
}

extern "C" const char* pose3d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
