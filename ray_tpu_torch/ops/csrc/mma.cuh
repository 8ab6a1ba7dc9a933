// Primitives of the flash-attention kernels (sm_90a): the common
// constants and strides, bf16 packing, and for the dQ kernel cp.async
// copies into shared memory, ldmatrix fragment loads and the bf16
// mma.sync m16n8k16 with f32 accumulation. The forward and dK/dV kernels
// use hopper.cuh's TMA and wgmma, which builds on this header.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): the A operand
// (16 x 16, row-major) is four registers holding rows g and g + 8 at
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B (16 x 8) is two registers at
// rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; the C accumulator
// (16 x 8) holds rows g and g + 8 at columns 2t, 2t + 1. So the C
// fragments of two neighbouring 8-column tiles are, packed to bf16, the A
// fragment of the 16-column chunk they make up.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides of dims 0, 1, 2; dim 3 is contiguous
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. The .trans form hands out their transposes.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loads from a row-major bf16 tile in shared memory whose rows
// are `ST` elements apart.
//
// B fragments where the tile is B transposed (tile rows are B's columns,
// as K is for Q.K^T): columns [n0, n0 + 8) of B, rows [k0, k0 + 32);
// r[0], r[1] cover rows k0..k0+15 and r[2], r[3] rows k0+16..k0+31.
template <int ST>
__device__ __forceinline__ void lds_b_nt(uint32_t (&r)[4],
                                         const __nv_bfloat16* tile, int n0,
                                         int k0, int lane) {
  ldsm_x4(r, tile + (n0 + (lane & 7)) * ST + k0 + (lane >> 3) * 8);
}

// B fragments where the tile is B itself (tile rows are B's rows, as V is
// for P.V): rows [k0, k0 + 16) of B, columns [n0, n0 + 16); r[0], r[1]
// cover columns n0..n0+7 and r[2], r[3] columns n0+8..n0+15.
template <int ST>
__device__ __forceinline__ void lds_b_t(uint32_t (&r)[4],
                                        const __nv_bfloat16* tile, int k0,
                                        int n0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_trans(r, tile + (k0 + (mi & 1) * 8 + (lane & 7)) * ST + n0 +
                       (mi >> 1) * 8);
}

}  // namespace
