// Device helpers shared by the tensor-core kernels: the 3xTF32 split, the
// m16n8k8 TF32 mma.sync, and cp.async copies with zero fill.
//
// 3xTF32 keeps fp32 accuracy on TF32 tensor cores: each operand a is split
// into hi = tf32(a) and lo = tf32(a - hi), and a*b is accumulated in fp32 as
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (the lo*lo term is below fp32's
// rounding).  Plain TF32 keeps about three decimal digits.
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (PTX ISA), with g = lane / 4 and t = lane % 4:
//   A (16x8):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8x8):   b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8):  c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct Split {
  uint32_t hi, lo;
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero), by an integer add and a mask: on sm_90 the cvt
// compiles to a compare, a select and the same add and mask, guarding inf
// and NaN, which the kernels' finite operands do not need
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// c += a * b on one 16x8x8 TF32 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b on one 16x8x8 TF32 tile, from zero
__device__ __forceinline__ void mma_from_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += a * b in 3xTF32 (the two small cross terms first, then hi * hi),
// the tile's products summed from zero on the tensor cores and added to c
// in fp32 on the CUDA cores.  The tensor cores' accumulator does not round
// to nearest: carried over a long reduction it drifts (5.8e-5 over 2,048
// terms of unit-variance sums on the H100, 2.6e-6 this way), where adding
// each 8-term step to c in fp32 keeps the drift to that of one step
__device__ __forceinline__ void mma3_add(float (&c)[4],
                                         const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4], Split b0,
                                         Split b1) {
  float d[4];
  mma_from_zero(d, a_lo, b0.hi, b1.hi);
  mma(d, a_hi, b0.lo, b1.lo);
  mma(d, a_hi, b0.hi, b1.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in (no
// global byte is read then); both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
