// Head tiles on wgmma for Hopper (sm_90a): the primitives that the
// attention kernels on wgmma share: flash attention (flash_attention.cu,
// kernels 14a-14c), the attention forward at L > kAttnSplitLen
// (attention.cu's attention_wg_kernel, also the temporal sub-blocks') and
// the sub-block attention backward at L > 64 (stblock_train.cu's
// attention_bwd_wg_kernel).
//
// A head tile is rows of one head's DH columns, DH * 2 bytes a row, as a
// TMA box lays them in shared memory: in the swizzle of that span (32 B at
// DH = 16, 64 B at 32, 128 B at 64). head_desc names that layout to wgmma,
// head_offset to the threads, head_box_map to TMA. Scores S = A B^T take
// both operands K-major from such tiles (issue_scores); P V takes P from
// registers, in the accumulator layout turned into A fragments (to_frags),
// and V N-major through the transpose flag (issue_rows): no transposed
// copy exists.

#pragma once

#include "rowtile_sm90.cuh"

namespace pose3d {
namespace attn {

template <int DH>
__host__ __device__ constexpr float head_scale() {
  return DH == 16 ? 0.25f : DH == 32 ? 0.17677669529663687f : 0.125f;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Work tile t of a persistent CTA's walk (blockIdx.x, + gridDim.x, ...):
// rows [tile * 128, tile * 128 + 128) of head h of sequence n, of n_tiles a
// head: query rows in 14a, 14c and attention.cu, keys in 14b.
struct Work {
  int n, h, tile;
  __device__ Work(int t, int n_tiles, int heads)
      : n(t / n_tiles / heads), h(t / n_tiles % heads), tile(t % n_tiles) {}
};

// A wgmma descriptor of a tile of DH-element rows at addr, in the swizzle
// of the row's span, as TMA lays out the maps below (layout type 1: 128 B,
// 2: 64 B, 3: 32 B): 8-row groups 8 rows apart (SBO); LBO unused, every
// operand's contiguous extent being one swizzle row. K-major (rows are M
// or N), a k-step of 16 columns is 32 bytes along the row; N-major (rows
// are K), a k-step of 16 rows is 16 rows on.
template <int DH>
__device__ __forceinline__ uint64_t head_desc(uint32_t addr) {
  constexpr uint64_t kSbo = 8 * DH * 2, kLayout = DH == 64 ? 1 : DH == 32 ? 2 : 3;
  return uint64_t((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((kSbo >> 4) << 32) | (kLayout << 62);
}

// Byte offset of element (r, c) of such a tile: 16-byte chunk bits XOR the
// row-group bits above them, as TMA swizzles.
template <int DH>
__device__ __forceinline__ uint32_t head_offset(int r, int c) {
  const uint32_t o = uint32_t(r) * (DH * 2) + uint32_t(c) * 2;
  return o ^ ((o >> 3) & uint32_t((DH * 2 / 16 - 1) << 4));
}

// d (+)= A (64 x 16: this thread's bf16 fragment a, in registers) @ B (16
// x N, shared, N-major: the transpose flag); bf16 in, f32 accumulate;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const unsigned (&a)[4], uint64_t b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const unsigned (&a)[4], uint64_t b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t b,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// s = A (a warpgroup's 64 rows x DH at descriptor da, K-major) @ the N-row
// tile at b, transposed (K-major: rows of DH), DH / 16 k-steps; the first
// overwrites s. Issues only: the caller fences before and commits after.
template <int DH, int N>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint64_t da, uint32_t b) {
  const uint64_t db = head_desc<DH>(b);
#pragma unroll
  for (int k = 0; k < DH / 16; ++k) {
    if constexpr (N == 128) rowtile::wgmma_m64n128<0, 0>(s, da + 2 * k, db + 2 * k, k);
    else if constexpr (N == 64) rowtile::wgmma_m64n64<0, 0>(s, da + 2 * k, db + 2 * k, k);
    else rowtile::wgmma_m64n32<0, 0>(s, da + 2 * k, db + 2 * k, k);
  }
}

// acc += P (64 x N: this thread's bf16 fragments p) @ the N-row tile at b
// (N x DH, N-major), N / 16 k-steps of 16 rows; scale 0 overwrites acc
// instead. Issues only.
template <int DH, int N>
__device__ __forceinline__ void issue_rows(float (&acc)[DH / 2], const unsigned (&p)[N / 16][4],
                                           uint32_t b, int scale = 1) {
  const uint64_t db = head_desc<DH>(b);
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    const int sd = k == 0 ? scale : 1;
    if constexpr (DH == 16) wgmma_rs_n16(acc, p[k], db + 2 * DH * k, sd);
    else if constexpr (DH == 32) wgmma_rs_n32(acc, p[k], db + 2 * DH * k, sd);
    else wgmma_rs_n64(acc, p[k], db + 2 * DH * k, sd);
  }
}

// The accumulator layout of m64nNk16 (rowtile_sm90.cuh): this thread holds
// rows ra and ra + 8 of its warpgroup's 64, columns 8j + 2(l % 4) and + 1,
// in s[4j], s[4j + 1] (row ra) and s[4j + 2], s[4j + 3] (row ra + 8). A
// k-step kk of the A fragment layout takes the columns [16kk, 16kk + 16):
// registers (ra, 2q), (ra + 8, 2q), (ra, 2q + 8), (ra + 8, 2q + 8), the
// accumulator's blocks 2kk and 2kk + 1.
template <int N>
__device__ __forceinline__ void to_frags(const float (&s)[N / 2], unsigned (&p)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[k][r] = pack_bf16(s[8 * k + 2 * r], s[8 * k + 2 * r + 1]);
}

// Keys at or past `valid` of a tile of N get -inf (their exponential is
// 0); the caller branches here only on the tile that holds the last key.
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N / 2], int valid, int q4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (8 * j + 2 * q4 + i >= valid) s[4 * j + i] = s[4 * j + 2 + i] = -inf();
}

// The TMA map of head boxes over a bf16 tensor at m of `rank` (3 to 5)
// dimensions, columns first: dims[i] elements along dimension i,
// strides[i - 1] bytes between neighbours along dimension i (multiples of
// 16, in any order). A box is DH columns (one head) x box_rows of
// dimension 1 x one of each outer dimension, in the swizzle of its DH *
// 2-byte rows (head_desc); elements past a dimension's end arrive as
// zeros, and a store writes none there.
template <int DH>
cudaError_t head_box_map(CUtensorMap* map, const bf16* m, int rank, const cuuint64_t* dims,
                         const cuuint64_t* strides, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t box[5] = {cuuint32_t(DH), cuuint32_t(box_rows), 1, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = DH == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<bf16*>(m),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace pose3d
