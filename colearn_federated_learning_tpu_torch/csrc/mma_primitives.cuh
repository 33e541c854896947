// Warp-level primitives of the bf16 flash-attention kernels: the m16n8k16
// tensor-core product, ldmatrix fragment loads, cp.async copies, quad
// reductions for the online softmax, and bf16 packing.  bf16 values travel
// as raw 16-bit patterns (unsigned short) in shared memory, two to a 32-bit
// register in the mma fragments.
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes), and r[i] receives
// matrix i's elements [g][2t, 2t+1] of lane 4g + t.  With trans, r[i]
// receives [2t, 2t+1][g] instead, the fragment of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without passing through registers, cached in
// L2 only; with valid false nothing is read and 16 zero bytes are written.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; with valid false, 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Close the group of copies this thread has started since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// Store v as the 32-bit word holding p[i] and p[i + 1] (i even, p 4-byte
// aligned).
__device__ __forceinline__ void st32(unsigned short* p, long long i,
                                     unsigned v) {
  *reinterpret_cast<unsigned*>(p + i) = v;
}

}  // namespace fa
