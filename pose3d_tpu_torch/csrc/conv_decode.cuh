// The widths of the fused 1x1-conv decode (conv_decode.cu, kernel 13a) and
// its backward (conv_decode_bwd.cu, 13b), and the device code both run:
// the logits product, the slab stream that feeds it, the pixel coordinates
// of a thread's accumulator rows, and the TMA map of the features.
//
// The logits of one joint over a 128-pixel tile: each of two warpgroups
// holds 64 feature rows (kFeat bf16 each) in shared memory, K-major in
// 128-byte-swizzled boxes of 64 channels as TMA lays them out, and the
// joint's weight slab (kDepth x kFeat, the rows of the conv's (out, in)
// matrix that belong to the joint) arrives by TMA in one 32 KB stage of a
// ring (rowtile_sm90.cuh); issue_logits computes the warpgroup's 64 x 64
// logits with 16 wgmma m64n64k16 (bf16 in, f32 accumulate), the slab taken
// K-major. Both kernels call it on the same layouts, so the forward's
// logits and the backward's recompute are the same instructions on the
// same operands, summed in one order: bitwise equal. The backward's p / s
// = exp(l - m) / s, with m and s from the forward, therefore sees the
// logits the forward's m and s were taken over. (The forward's first
// version, ldmatrix + mma.sync m16n8k16, summed them in another order, and
// the backward's p / s carried a few ulps of |l| of relative error.)

#pragma once

#include "common.cuh"
#include "rowtile_sm90.cuh"
#include "softargmax.cuh"

namespace pose3d {

namespace rt = rowtile;

constexpr int kFeat = 256;        // C: feature channels, the logits' K
constexpr int kDepth = 64;        // D: a joint's channels, a slab's N
constexpr int kTilePixels = 128;  // pixels of a tile: two warpgroups' 64 rows

static_assert(kFeat == 4 * rt::kBox && kDepth == rt::kBox &&
                  kTilePixels == rt::kTileRows,
              "a slab is one wide chunk, a depth row one swizzled 128-byte row");

// The pixel coordinates of this thread's two accumulator rows, ra and ra + 8
// of the 64 from pixel p0 of one sample; ok says a row is a real pixel.
struct Rows {
  float xi[2], yi[2];
  bool ok[2];

  __device__ __forceinline__ Rows(int p0, int ra, int pixels, int width) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + ra + 8 * h;
      ok[h] = p < pixels;
      xi[h] = float(p % width);
      yi[h] = float(p / width);
    }
  }
};

// acc = a warpgroup's 64 x 64 logits: A (64 x 256, K-major at a) @ the
// slab at w (64 depth rows x 256, K-major: no transpose); issues and
// commits only.
__device__ __forceinline__ void issue_logits(float (&acc)[32], uint32_t a, uint32_t w) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;  // overwritten: free until here
  const uint64_t da = rt::desc_a(a), dw = rt::desc_a(w);
  rt::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kFeat / 16; ++k) {
    const uint32_t off = (k / 4) * rt::kKBlockBytes + (k % 4) * 32;
    rt::wgmma_m64n64<0, 0>(acc, rt::desc_off(da, off), rt::desc_off(dw, off), k);
  }
  rt::wgmma_commit();
}

// A persistent CTA's slab stream as its thread 0 feeds it: chunk c is the
// slab of joint c % joints (of the CTA's tile c / joints), loaded by TMA
// into stage c % S once both warpgroups have released chunk c - S.
template <int S>
struct SlabFeed {
  rt::Ring<S> ring;  // the producer's view
  const CUtensorMap* map;
  int joints, total;

  __device__ __forceinline__ void issue() {
    const int c = ring.next;
    rt::load_wide(ring, map, 0, (c % joints) * kDepth);
  }

  // Loads every chunk up to c, waiting for stages where it must, then those
  // after it whose stages are already free.
  __device__ __forceinline__ void feed(int c) {
    while (ring.next <= c && ring.next < total) issue();
    while (ring.next < total &&
           rt::mbar_test(ring.empty(ring.next % S), ((ring.next / S) & 1) ^ 1))
      issue();
  }
};

// The 128-pixel tile at pixel p0 of sample b into the two warpgroups' A
// buffers at dst (kActBytes), by TMA, completing on bar: rows past the
// sample's last pixel arrive as zeros. One thread calls it.
__device__ __forceinline__ void load_feature_tile(uint32_t dst, const CUtensorMap* map,
                                                  uint32_t bar, int p0, int b) {
  rt::mbar_expect_tx(bar, rt::kActBytes);
#pragma unroll
  for (int w = 0; w < rt::kConsumers; ++w)
#pragma unroll
    for (int kb = 0; kb < kFeat / rt::kBox; ++kb)
      rt::tma_load3(dst + w * rt::kWgActBytes + kb * rt::kKBlockBytes, map, bar,
                   kb * rt::kBox, p0 + w * rt::kWgRows, b);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The TMA map of (batch, pixels, kFeat) bf16 rows at f, in boxes of 64
// pixels x 64 channels of one sample, 128-byte swizzle: rows past a
// sample's last pixel load as zeros and are not stored.
inline cudaError_t pixel_map(CUtensorMap* map, const bf16* f, int batch, int pixels) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(f) % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cuuint64_t(kFeat), cuuint64_t(pixels), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(kFeat) * sizeof(bf16),
                                 cuuint64_t(pixels) * kFeat * sizeof(bf16)};
  const cuuint32_t box[3] = {cuuint32_t(rt::kBox), cuuint32_t(rt::kWgRows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(f), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace pose3d
