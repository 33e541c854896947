// Warp-level primitives of the bf16 flash-attention kernels: the m16n8k16
// tensor-core product, quad reductions for the online softmax, and bf16
// packing.  bf16 values travel as raw 16-bit patterns (unsigned short) in
// shared memory, two to a 32-bit register in the mma fragments.
#pragma once

#include <cuda_bf16.h>

namespace fa {

// c (16x8 f32) += a (16x16 bf16, row-major) . b (16x8 bf16, col-major).
// Fragments of lane 4g + t (PTX ISA, mma.m16n8k16), low half = lower index:
//   a[0] = A[g][2t, 2t+1]     a[1] = A[g+8][2t, 2t+1]
//   a[2] = A[g][2t+8, 2t+9]   a[3] = A[g+8][2t+8, 2t+9]
//   b[0] = B[2t, 2t+1][g]     b[1] = B[2t+8, 2t+9][g]
//   c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned* a,
                                               const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Max and sum over the four lanes of a quad (lanes 4g .. 4g+3 hold the
// same two rows of every fragment); every lane gets the same result.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// The 32-bit word holding p[i] and p[i + 1] (i even, p 4-byte aligned).
__device__ __forceinline__ unsigned ld32(const unsigned short* p, long long i) {
  return *reinterpret_cast<const unsigned*>(p + i);
}

__device__ __forceinline__ void st32(unsigned short* p, long long i,
                                     unsigned v) {
  *reinterpret_cast<unsigned*>(p + i) = v;
}

}  // namespace fa
