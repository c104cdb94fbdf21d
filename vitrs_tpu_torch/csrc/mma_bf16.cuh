// Device helpers shared by the port's hand-written kernels (flash_fwd.cu,
// flash_bwd.cu, fused_head_ce.cu): conversions between the storage types
// and fp32, the bf16 tensor-core product mma.sync.m16n8k16 with the packing
// of its fragments, and the rope rotation and window band of the attention
// kernels.  Each .cu file is built into its own library, so these are plain
// inline device functions.
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

// RoPE, half-split pairing: dim c of a head pairs with dim c + D/2.  The
// angle's cos and sin come from the fp32 (positions, D/2) table of
// ops/rope.py (pass -s for the inverse rotation).  Each product and sum is
// rounded on its own, as PyTorch's separate elementwise ops round them (no
// fused multiply-add), so a rotated value is bit-identical to the plain
// version's before both round it to the storage type.
__device__ __forceinline__ void rope_pair(float& x1, float& x2, float c, float s) {
  const float y1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  const float y2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
  x1 = y1;
  x2 = y2;
}

// Column c of a row of a head of 2 half columns, rotated: x points at the
// row, cs and sn at the table row of its position; c pairs with c + half
// (or c - half).  kScaled: cos and sin times `scale`, as `rope_row8`.  The
// rotated value before its rounding to the storage type, the same bits as
// the pair's rotation in `rope_row8` and the plain versions.
template <bool kScaled, typename T>
__device__ __forceinline__ float rope_elem(const T* x, int c, int half, const float* cs,
                                           const float* sn, float scale = 1.f) {
  const int p = c < half ? c : c - half;
  float x1 = to_f(x[p]), x2 = to_f(x[p + half]);
  float cc = cs[p], ss = sn[p];
  if constexpr (kScaled) {
    cc = __fmul_rn(cc, scale);
    ss = __fmul_rn(ss, scale);
  }
  rope_pair(x1, x2, cc, ss);
  return c < half ? x1 : x2;
}

// Eight pairs of one row of a bf16 head of 2 kHalf columns: x points at
// column c of the row (c a multiple of 8 below kHalf), cs and sn at column c
// of the table row of its position.  Columns c..c+7 and c+kHalf..c+kHalf+7
// rotated, rounded to bf16 and packed into lo and hi.  kScaled: the rotation
// by cos and sin times `scale` (each product rounded on its own), which
// folds a softmax scale into q as the kernels' plain versions do.
template <int kHalf, bool kScaled = false>
__device__ __forceinline__ void rope_row8(const bf16* x, const float* cs, const float* sn,
                                          uint4& lo, uint4& hi, float scale = 1.f) {
  const uint4 x1 = *reinterpret_cast<const uint4*>(x);
  const uint4 x2 = *reinterpret_cast<const uint4*>(x + kHalf);
  const bf16* e1 = reinterpret_cast<const bf16*>(&x1);
  const bf16* e2 = reinterpret_cast<const bf16*>(&x2);
  uint32_t* l32 = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* h32 = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    float a0 = __bfloat162float(e1[e]), a1 = __bfloat162float(e1[e + 1]);
    float b0 = __bfloat162float(e2[e]), b1 = __bfloat162float(e2[e + 1]);
    if constexpr (kScaled) {
      rope_pair(a0, b0, __fmul_rn(cs[e], scale), __fmul_rn(sn[e], scale));
      rope_pair(a1, b1, __fmul_rn(cs[e + 1], scale), __fmul_rn(sn[e + 1], scale));
    } else {
      rope_pair(a0, b0, cs[e], sn[e]);
      rope_pair(a1, b1, cs[e + 1], sn[e + 1]);
    }
    l32[e / 2] = pack_f32(a0, a1);
    h32[e / 2] = pack_f32(b0, b1);
  }
}

// Eight bf16 values times `scale`, rounded back to bf16
__device__ __forceinline__ uint4 scale_bf16x8(uint4 x, float scale) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  uint4 y;
  uint32_t* y32 = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    y32[e] = pack_f32(__bfloat162float(x2[e].x) * scale, __bfloat162float(x2[e].y) * scale);
  return y;
}

// The band of sliding-window attention: key j is visible from the query at
// absolute position p when j <= p (causal) and, for window > 0, j > p - window.
__device__ __forceinline__ bool in_band(int j, int p, int window) {
  return j <= p && (window == 0 || j > p - window);
}

// First kv tile (of `tile` rows) that a block of queries whose first
// absolute position is p0 must visit: the tile holding key p0 - window + 1,
// or 0 without a window.
__device__ __forceinline__ int band_start(int p0, int window, int tile) {
  if (window == 0 || p0 - window + 1 <= 0) return 0;
  return (p0 - window + 1) / tile * tile;
}

}  // namespace vitrs
