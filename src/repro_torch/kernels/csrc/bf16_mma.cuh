// Helpers shared by the bf16 tensor-core kernels of flash attention
// (flash_attention.cu and flash_attention_bwd.cu): cp.async copies into
// shared memory, ldmatrix fragment loads, one mma.sync.m16n8k16 bf16
// product with an fp32 accumulator, and the rounding of fp32 pairs into
// bf16x2 parts.
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..); B (16 x 8, col-major) b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..,
// n = g); C c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).  So the C
// fragments of two n8 tiles side by side are the A fragment of a 16 x 16
// operand: a product's result feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte cp.async; ``ok == false`` copies nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4-byte cp.async, zero fill as above
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// subtract a bf16x2 from two floats (exact: they are its rounding's source)
__device__ __forceinline__ void take_bf16(float (&r)[2], uint32_t part) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&part);
  r[0] -= __low2float(v);
  r[1] -= __high2float(v);
}
// the A fragment of a 16 x 16 operand from the C fragments ``c`` of its two
// n8 halves, in ``N`` bf16 parts: part k is the rounding of what parts 0..
// k-1 leave of each value (each remainder is exact in fp32)
template <int N>
__device__ __forceinline__ void a_parts(uint32_t (&parts)[N][4],
                                        const float (&c)[2][4]) {
  float rest[4][2] = {{c[0][0], c[0][1]},
                      {c[0][2], c[0][3]},
                      {c[1][0], c[1][1]},
                      {c[1][2], c[1][3]}};
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      parts[k][i] = pack_bf16(rest[i][0], rest[i][1]);
      take_bf16(rest[i], parts[k][i]);
    }
}

}  // namespace
