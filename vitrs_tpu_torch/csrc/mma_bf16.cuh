// Device helpers shared by the port's attention kernels (flash_fwd.cu,
// flash_bwd.cu): conversions between the storage types and fp32, and the
// bf16 tensor-core product mma.sync.m16n8k16 with the packing of its
// fragments.  Each .cu file is built into its own library, so these are
// plain inline device functions.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B 16x8 : b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C 16x8 : c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// So the accumulators of two neighbouring 8-column tiles of C, rounded to
// bf16 and packed in pairs, are the A fragment of one 16-deep chunk.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vitrs {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of chunk kk from the accumulators of C tiles 2kk and 2kk+1
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace vitrs
