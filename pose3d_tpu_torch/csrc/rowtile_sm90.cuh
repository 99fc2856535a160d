// The row-tile engine of the sub-block forward kernels and the lifter trunk
// (csrc/subblock_sm90.cuh, run by stblock.cu and lifter_trunk.cu) for
// Hopper (sm_90a): the product of a 128-row tile of activations, held in
// shared memory, by a weight matrix that does not fit there, on wgmma fed
// by TMA. It took the place of common.cuh's 80-row engine (ldmatrix +
// mma.sync, a cp.async ring with a block-wide barrier per chunk), on which
// both first ran; that engine is gone. The conv decodes (conv_decode.cu,
// conv_decode_bwd.cu) and the Martinez block (martinez.cu, whose ring
// stages carry A beside W: Ring's kBytes) build on its primitives too.
//
// Roles. A block is three warpgroups, one CTA an SM:
// - the producer warpgroup (setmaxnreg down to kProducerRegs): one thread
//   walks the weights chunk by chunk, in the order the products consume
//   them, and issues each chunk as TMA loads (cp.async.bulk.tensor.2d,
//   128-byte swizzle) into a ring of 32 KB stages, each guarded by a full
//   and an empty mbarrier. It waits for nothing but a free stage;
//   no barrier spans the block after set-up.
// - two consumer warpgroups (setmaxnreg up to kConsumerRegs), each owning
//   64 rows of the tile: wgmma.mma_async m64nNk16 (bf16 in, f32
//   accumulate), A from shared memory K-major, B straight from the stage,
//   whose rows are the weights' (in, out) rows: N-major, taken with the
//   transpose flag, so no transposed copy exists. A warpgroup keeps one
//   chunk's wgmma group in flight while it issues the next, and hands a
//   stage back (one arrival on its empty barrier) once the group that
//   read it has completed.
// Epilogues run in the consumers' registers, in the wgmma accumulator
// layout, and write bf16 into the same 128-byte-swizzled layout that the
// next product reads as A, or that a TMA store writes out (manual
// swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8), as TMA lays
// out a box).
//
// Chunks (every one 32 KB, so every stage expects the same bytes):
// - wide: 64 rows x 256 columns of a matrix, four 64 x 64 boxes
//   (m64n256k16: LBO = one box, 8 KB, between 64-column blocks; SBO = 1 KB
//   between 8-row groups of K);
// - tall: 256 rows x 64 columns, one 256 x 64 box (m64n64k16).

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace pose3d {
namespace rowtile {

constexpr int kTileRows = 128;                   // rows of a tile
constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kWgRows = kTileRows / kConsumers;  // 64: one wgmma's M
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStageBytes = 32768;
constexpr int kBox = 64;                  // a box's columns: one 128-byte swizzle row
constexpr int kBoxBytes = kBox * kBox * 2;  // 8 KB
constexpr int kKBlockBytes = kWgRows * 128;  // 64 K-columns of a warpgroup's A: 8 KB
constexpr int kWgActBytes = 4 * kKBlockBytes;  // a warpgroup's 64 x 256 A operand: 32 KB
constexpr int kActBytes = kConsumers * kWgActBytes;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file holds both roles");
static_assert(4 * kBoxBytes == kStageBytes && kDim * kBox * 2 == kStageBytes,
              "a wide and a tall chunk fill one stage");

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

constexpr long long kHangCycles = 1ll << 36;  // ~37 s at 1.86 GHz

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts kHangCycles traps, so that a broken pipeline fails its launch
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// The 128 threads of consumer warpgroup wg (named barriers 1, 2, ...).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The 256 threads of both consumer warpgroups (named barrier kConsumers + 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumers + 1), "n"(kConsumers * 128) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------- TMA

// Box (col, row) of `map` into shared memory at dst; completes bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// Box (col, row, plane) of a rank-3 map into shared memory at dst; rows
// past the map's end arrive as zeros (and count their bytes).
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// Shared memory at src to box (col, row, plane) of a rank-3 map; rows past
// the map's end are not written.
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, uint32_t src, int col, int row,
                                           int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// Box (col, row, p, q) of a rank-4 map into shared memory at dst; rows
// past the map's end arrive as zeros (and count their bytes).
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col, int row, int p, int q) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(p), "r"(q)
      : "memory");
}

// Shared memory at src (128-byte-swizzled rows, as the map's box) to box
// (col, row) of `map`; rows past the map's end are not written. One
// thread issues it; cp.async.bulk groups track it.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until the committed stores are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major A: 8-row groups 1 KB apart (LBO unused by a swizzled K-major
// operand); N-major B in a chunk: 64-column blocks a box apart, 8-row
// groups of K 1 KB apart.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return smem_desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return smem_desc(addr, kBoxBytes, 1024);
}

// d + off bytes (a multiple of 16, the sum within shared memory), added in
// an asm volatile statement right where it is used: the compiler keeps one
// base descriptor live in a k-step loop, not a register pair per k-step
// hoisted out of it (conv_decode_bwd.cu, whose accumulators leave little
// room).
__device__ __forceinline__ uint64_t desc_off(uint64_t d, uint32_t off) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(r) : "l"(d), "l"(uint64_t(off >> 4)));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins an accumulator's registers at this point of the program: reads of
// it after a wgmma_wait stay after it, writes before a wgmma stay before.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, shared) @ B (16 x 256, shared); bf16 in, f32
// accumulate; scale_d 0 overwrites d. kTransA 0: A K-major, 1: M-major;
// kTransB 1 (the default): B N-major, 0: K-major.
template <int kTransA = 0, int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// As wgmma_m64n256, N = 64.
template <int kTransA = 0, int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// As wgmma_m64n256, N = 128.
template <int kTransA = 0, int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// As wgmma_m64n256, N = 32.
template <int kTransA = 0, int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// ---------------------------------------------------------------- layout

// Byte offset of 16-byte chunk c of row r in 128-byte-swizzled rows.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r) * 128 + (uint32_t(c ^ (r & 7)) << 4);
}

// Byte offset of element (r, k) of a warpgroup's K-major A operand: K in
// blocks of 64 columns, kKBlockBytes apart.
__device__ __forceinline__ uint32_t a_offset(int r, int k) {
  return (k / 64) * kKBlockBytes + swz(r, (k % 64) / 8) + (k % 8) * 2;
}

__device__ __forceinline__ void st_shared2(unsigned char* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The accumulator layout of m64nNk16 (per warpgroup): warp w, lane l holds
// rows ra = 16w + l/4 and ra + 8, columns 8j + 2(l%4) and + 1, in
// acc[4j], acc[4j + 1] (row ra) and acc[4j + 2], acc[4j + 3] (row ra + 8).

// bf16(acc (+ bias where kBias)) of a 64 x 256 accumulator into
// 128-byte-swizzled boxes of 64 columns, kKBlockBytes apart: a warpgroup's
// A layout, and TMA's.
template <bool kBias>
__device__ __forceinline__ void stage_acc(const float (&acc)[128], unsigned char* dst,
                                          const bf16* __restrict__ bias, int ra, int q) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 bv = kBias ? load2(bias + 8 * j + 2 * q) : make_float2(0.f, 0.f);
    unsigned char* p = dst + (j / 8) * kKBlockBytes + 4 * q;
    st_shared2(p + swz(ra, j % 8), acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
    st_shared2(p + swz(ra + 8, j % 8), acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
  }
}

// ---------------------------------------------------------------- the ring

// One side's view of a ring of kStages stages of kBytes each: stages at
// `ring`, full barrier s at bars + 8s, empty barrier s at bars + 8 (kStages
// + s); chunk c of the stream lives in stage c % kStages, in round c /
// kStages. Every stage expects kBytes (the default: one wide or tall chunk).
template <int kStages, int kBytes = kStageBytes>
struct Ring {
  uint32_t ring, bars;
  int next;  // chunks taken so far

  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }

  // Consumer: waits for chunk `next` to land; returns its stage's address.
  __device__ uint32_t acquire() {
    const int s = next % kStages;
    mbar_wait(full(s), (next / kStages) & 1);
    ++next;
    return ring + s * kBytes;
  }

  // Consumer: chunk c's stage is free again (one arrival a warpgroup, by its
  // first thread, after the wgmma group that read it has completed).
  __device__ void release(int c) const {
    if (threadIdx.x % 128 == 0) mbar_arrive(empty(c % kStages));
  }

  // Producer: waits for a free stage for chunk `next`; returns its address
  // and arms its full barrier for one chunk's bytes.
  __device__ uint32_t claim(uint32_t* bar) {
    const int s = next % kStages;
    mbar_wait(empty(s), ((next / kStages) & 1) ^ 1);
    ++next;
    *bar = full(s);
    mbar_expect_tx(*bar, kBytes);
    return ring + s * kBytes;
  }
};

// Sets up a ring's barriers: one producer arrival (with the chunk's bytes)
// fills a stage, one arrival of each consumer warpgroup empties it. Thread
// 0 calls it; a __syncthreads() must follow.
template <int kStages>
__device__ __forceinline__ void ring_init(uint32_t bars) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (kStages + s), kConsumers);
  }
  mbar_fence_init();
}

// A wide chunk: rows [row, row + 64) x columns [col, col + 256) of map.
template <int S>
__device__ __forceinline__ void load_wide(Ring<S>& r, const CUtensorMap* map, int col, int row) {
  uint32_t bar;
  const uint32_t dst = r.claim(&bar);
#pragma unroll
  for (int b = 0; b < 4; ++b) tma_load(dst + b * kBoxBytes, map, bar, col + b * kBox, row);
}

// A tall chunk: rows [0, 256) x columns [col, col + 64) of map.
template <int S>
__device__ __forceinline__ void load_tall(Ring<S>& r, const CUtensorMap* map, int col) {
  uint32_t bar;
  const uint32_t dst = r.claim(&bar);
  tma_load(dst, map, bar, col, 0);
}

// acc = A (a warpgroup's 64 x 64·kChunks, K-major at a) @ the stream's next
// kChunks wide chunks (K rows 64 at a time, 256 columns). One chunk's four
// wgmmas stay in flight while the next chunk's are issued.
template <int kChunks, int S>
__device__ __forceinline__ void gemm_wide(float (&acc)[128], uint32_t a, Ring<S>& r) {
#pragma unroll 1
  for (int kc = 0; kc < kChunks; ++kc) {
    const uint32_t b = r.acquire();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_m64n256(acc, desc_a(a + kc * kKBlockBytes + j * 32), desc_b(b + j * 2048),
                    kc | j);
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();
      r.release(r.next - 2);
    }
  }
  wgmma_wait<0>();
  r.release(r.next - 1);
  fence_acc(acc);
}

// acc = A (64 x 256 at a) @ a tall chunk at b (m64n64, 16 k-steps); issues
// and commits only.
__device__ __forceinline__ void issue_tall(float (&acc)[32], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 16; ++j)
    wgmma_m64n64(acc, desc_a(a + (j / 4) * kKBlockBytes + (j % 4) * 32), desc_b(b + j * 2048),
                 j);
  wgmma_commit();
}

// acc (+)= A (64 x 64 at a) @ a wide chunk at b (m64n256, 4 k-steps; scale
// 0 on the first overwrites acc); issues and commits only.
__device__ __forceinline__ void issue_wide64(float (&acc)[128], uint32_t a, uint32_t b,
                                             bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_m64n256(acc, desc_a(a + j * 32), desc_b(b + j * 2048), accumulate || j);
  wgmma_commit();
}

}  // namespace rowtile

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, found through the runtime's driver entry point,
// so the library links no libcuda. The encoder needs a current context: on
// a thread where no runtime call has run yet (the autograd engine's, when a
// kernel's backward is its first work) the device's primary context is not
// current, and it failed with CUDA_ERROR_INVALID_CONTEXT; cudaSetDevice on
// the current device makes it current first.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t tensor_map_encoder(EncodeTiled* out) {
  int dev = 0;
  cudaError_t ctx = cudaGetDevice(&dev);
  if (ctx == cudaSuccess) ctx = cudaSetDevice(dev);
  if (ctx != cudaSuccess) return ctx;
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// The TMA map of a (rows x cols) row-major bf16 matrix at m, in boxes of
// box_rows x 64 columns, 128-byte swizzle. m must lie on a 16-byte
// boundary (cols·2 is a multiple of 16 for every matrix here).
inline cudaError_t tile_map(CUtensorMap* map, const bf16* m, int rows, int cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(m) % 16 || (cols * sizeof(bf16)) % 16)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {cuuint32_t(rowtile::kBox), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(m),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks of a persistent grid over n_tiles tiles on the current device.
inline cudaError_t persistent_grid(int n_tiles, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *grid = n_tiles < sms ? n_tiles : sms;
  return cudaSuccess;
}

}  // namespace pose3d
