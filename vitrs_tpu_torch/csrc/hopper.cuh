// Hopper (sm_90a) building blocks shared by the flash kernels (flash_fwd.cu,
// flash_bwd.cu): tiles copied by the tensor memory accelerator (TMA) into
// shared memory with completion on mbarriers, 4-byte cp.async, and warpgroup
// products (wgmma m64n64k16, bf16 in, fp32 accumulate) reading swizzled
// tiles through shared-memory descriptors.  Every tile here is 64 rows of 64
// bf16 (one head of D = 64), 8 KB.  Each .cu file is built into its own
// library, so these are plain inline functions.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace vitrs {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 64 x 64 bf16 tile in shared memory has 128-byte rows under the 128-byte
// swizzle (16-byte chunk c of row r at r * 128 + (c ^ r % 8) * 16), written
// so by the tensor memory accelerator (TMA) from a 4-D tensor map (d, head,
// t, b) of the (B, T, W) matrix, one 64-row box per tile: rows past seq_len
// read as zeros.  Its base is 1024-byte aligned, so it is also the layout
// wgmma's 128-byte-swizzle descriptors read.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA writes to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 4 bytes global -> shared, asynchronously; live = false writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile: start address, leading
// offset 16 B (unused by these layouts), stride 1024 B between 8-row groups,
// 128-byte swizzle.  K-major operands (K, the q/do tiles of S and dP) step
// 16 columns by +32 B; MN-major ones (B of dV, dK, dQ, P.V) step 16 rows by
// +2 KB.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
__device__ __forceinline__ void fence_acc(float (&x)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}

// The accumulator of m64n64 (per thread, warp w of the warpgroup, g = lane
// / 4, t = lane % 4): d[nt][0..1] at row 16w + g, columns 8nt + 2t, +1;
// d[nt][2..3] at row 16w + g + 8 -- mma.sync's C layout repeated over 8
// column tiles, so acc_to_a turns two column tiles into one 16-deep A
// fragment.
#define WG_D(d)                                                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),  \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),             \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),             \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),             \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),             \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_REGS                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A . B, A (64 x 16) and B (16 x 64) both K-major in shared memory;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d += A . B, A (64 x 16) in registers (mma.sync's A fragment per warp), B
// (16 x 64) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// acc = A . B^T over D = 64: A and B 64-row K-major tiles
__device__ __forceinline__ void product_rows(float (&acc)[8][4], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc, desc(sa + kk * 32), desc(sb + kk * 32), kk);
}

// acc += X . B over 64 rows of the tile B: X (64 x 64, fp32 accumulators of
// another product) rounded to bf16 as the A operand, B read MN-major
__device__ __forceinline__ void product_cols(float (&acc)[8][4], const uint32_t (&xa)[4][4],
                                             uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, xa[kk], desc(sb + kk * 2048));
}

__device__ __forceinline__ void to_a(uint32_t (&xa)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(xa[kk], x[2 * kk], x[2 * kk + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// Dynamic shared memory starts 1024-byte aligned for the swizzle (a kernel
// requests 1 KB of slack for it).
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// thread 0 sets up `n` barriers of one arrival each; the block then syncs
__device__ __forceinline__ void init_barriers(uint32_t bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (so the library links no libcuda), or nullptr.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The TMA map of a bf16 (B, T, heads * 64) matrix with batch and time strides
// sb, st (elements) as 4-D (d, head, t, b), one 64 x 64 swizzled tile per
// box; t runs to seq_len, so rows at or past it read as zeros.  False if the
// encoder refuses it: the base and both strides must be 16-byte multiples.
inline bool tile_map(CUtensorMap* map, const void* ptr, int heads, int seq_len, int batch,
                     long long st, long long sb) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {64 * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace vitrs
