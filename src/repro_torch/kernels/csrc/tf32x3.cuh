// Helpers shared by the 3xTF32 tensor-core kernels (shift_conv.cu and, through
// tf32x3_tile.cuh, ddmm.cu and sddmm.cu): cp.async copies into shared memory
// (spdmm.cu and knn.cu use these too), the split
// of an fp32 value into two TF32 parts, and one mma.sync.m16n8k8 TF32
// product.
//
// 3xTF32: a = hi + lo with hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a -
// hi) (a - hi is exact); a product a*b is taken as lo*hi + hi*lo + hi*hi,
// dropping lo*lo and the rounding of lo (~2^-22 of the product): fp32-level
// accuracy from the TF32 tensor cores, where one TF32 product keeps ~2^-11.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async with zero fill: ``ok == false`` copies no bytes and writes 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// c += a · b on one m16n8k8 tile.  Fragments (g = lane / 4, t = lane % 4):
// A (16 x 8, row-major) a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// B (8 x 8, col-major) b0 (k = t, n = g), b1 (t+4, g); C c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
