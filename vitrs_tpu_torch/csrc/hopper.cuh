// Hopper (sm_90a) building blocks shared by the flash kernels (flash_fwd.cu,
// flash_bwd.cu) and K8 (fused_head_ce.cu): tiles copied by the tensor memory
// accelerator (TMA) into shared memory with completion on mbarriers, 4-byte
// cp.async, and warpgroup products (wgmma m64nNk16, bf16 in, fp32
// accumulate) reading swizzled tiles through shared-memory descriptors.  A
// flash tile is 64 rows of one head of D bf16 columns (`HeadTile<D>`, D =
// 32 or a multiple of 64; the flash kernels at D <= 16 use none of this,
// their rows being too short for TMA).  Each .cu file is built into its own
// library (the flash sources once per head dim), so these are plain inline
// functions.

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

// The shared-memory tile of 64 rows of one head of D bf16 columns.  Its
// rows are cut into swizzle atoms of kAtomCols columns: at D >= 64, D / 64
// atoms of 64 x 64 (8 KB, 128-byte rows under the 128-byte swizzle: 16-byte
// chunk c of row r at r * 128 + (c ^ r % 8) * 16), one after another; at
// D = 32 one atom of 64 x 32 (4 KB, 64-byte rows under the 64-byte swizzle:
// chunk c of row r at r * 64 + (c ^ (r / 2) % 4) * 16; a 128-byte box would
// read the next head's columns).  The tensor memory accelerator (TMA) writes
// it from a 4-D tensor map (column in the atom, atom, t, b) of the (B, T, W)
// matrix, one 64-row box per atom (`tma_head`): rows past seq_len read as
// zeros.  Its base is 1024-byte aligned, so it is also the layout wgmma's
// swizzled descriptors read (`HeadTile::desc`).
template <int D>
struct HeadTile {
  static_assert(D == 32 || (D % 64 == 0 && D <= 1024), "head dims 32 and multiples of 64");
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kAtomCols;      // 128 or 64
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kAtomBytes = 64 * kRowBytes;    // 8 KB or 4 KB
  static constexpr int kBytes = kAtoms * kAtomBytes;   // 64 * D * 2
  static constexpr int kSteps = D / 16;                // k-steps of a product over D

  // byte offset of (row, col) in the tile
  __device__ static __forceinline__ int offset(int row, int col) {
    const int c = col % kAtomCols;
    const int sw = kRowBytes == 128 ? (row & 7) : ((row >> 1) & 3);
    return (col / kAtomCols) * kAtomBytes + row * kRowBytes +
           ((((c >> 3) ^ sw) << 4) | ((c & 7) << 1));
  }
  // wgmma shared-memory descriptor: start address, leading offset 16 B
  // (unused: an operand never spans two atoms), stride 8 rows, and the
  // swizzle (1: 128-byte, 2: 64-byte).  K-major operands step 16 columns by
  // `kstep`; MN-major ones step 16 rows by 16 * kRowBytes.
  __device__ static __forceinline__ uint64_t desc(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(8 * kRowBytes >> 4) << 32) |
           (static_cast<uint64_t>(kRowBytes == 128 ? 1 : 2) << 62);
  }
  // byte offset of k-step kk (columns 16 kk .. 16 kk + 15) of a K-major tile
  __device__ static __forceinline__ uint32_t kstep(int kk) {
    return (kk * 16 / kAtomCols) * kAtomBytes + (kk * 16 % kAtomCols) * 2;
  }
};

// one box (64 rows of one atom) of the tensor map into shared memory
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int atom, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(atom), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// rows row .. row + 63 of head `head` (all its atoms) into the tile at dst;
// HeadTile<D>::kBytes land on `bar`
template <int D>
__device__ __forceinline__ void tma_head(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row, int b) {
  using H = HeadTile<D>;
#pragma unroll
  for (int a = 0; a < H::kAtoms; ++a)
    tma_tile(dst + a * H::kAtomBytes, map, bar, head * H::kAtoms + a, row, b);
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
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

// The accumulator of m64n32 (float[4][4]): the same layout over 4 column
// tiles.
#define WG_D16(d)                                                                            \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),  \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),             \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define WG_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= A . B at n = 32, A (64 x 16) and B (16 x 32) both K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss32(float (&d)[4][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D16(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d += A . B at n = 32, A in registers, B (16 x 32) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs32(float (&d)[4][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// The 32 accumulators of column tiles o .. o + 7 of a wider m64
// accumulator float[N][4] (columns 8 o .. 8 o + 63)
#define WG_D_AT(d, o)                                                                        \
  "+f"(d[o][0]), "+f"(d[o][1]), "+f"(d[o][2]), "+f"(d[o][3]), "+f"(d[o + 1][0]),             \
      "+f"(d[o + 1][1]), "+f"(d[o + 1][2]), "+f"(d[o + 1][3]), "+f"(d[o + 2][0]),            \
      "+f"(d[o + 2][1]), "+f"(d[o + 2][2]), "+f"(d[o + 2][3]), "+f"(d[o + 3][0]),            \
      "+f"(d[o + 3][1]), "+f"(d[o + 3][2]), "+f"(d[o + 3][3]), "+f"(d[o + 4][0]),            \
      "+f"(d[o + 4][1]), "+f"(d[o + 4][2]), "+f"(d[o + 4][3]), "+f"(d[o + 5][0]),            \
      "+f"(d[o + 5][1]), "+f"(d[o + 5][2]), "+f"(d[o + 5][3]), "+f"(d[o + 6][0]),            \
      "+f"(d[o + 6][1]), "+f"(d[o + 6][2]), "+f"(d[o + 6][3]), "+f"(d[o + 7][0]),            \
      "+f"(d[o + 7][1]), "+f"(d[o + 7][2]), "+f"(d[o + 7][3])

// d[kO .. kO + 7] += A . B at n = 64, A (64 x 16) in registers (mma.sync's
// A fragment per warp), B (16 x 64) MN-major in shared memory
template <int kO, int N>
__device__ __forceinline__ void wgmma_rs_at(float (&d)[N][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(kO + 8 <= N, "accumulator columns");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D_AT(d, kO)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[kO .. kO + 7] += A . B at n = 64, A (64 x 16) K-major and B (16 x 64)
// MN-major, both in shared memory
template <int kO, int N>
__device__ __forceinline__ void wgmma_ss_mn_at(float (&d)[N][4], uint64_t da, uint64_t db) {
  static_assert(kO + 8 <= N, "accumulator columns");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_D_AT(d, kO)
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// acc = A . B^T over D: A and B 64-row K-major tiles of one head of D
template <int D>
__device__ __forceinline__ void product_rows(float (&acc)[8][4], uint32_t sa, uint32_t sb) {
  using H = HeadTile<D>;
#pragma unroll
  for (int kk = 0; kk < H::kSteps; ++kk)
    wgmma_ss(acc, H::desc(sa + H::kstep(kk)), H::desc(sb + H::kstep(kk)), kk);
}

// acc = A . B^T over D for 32 rows of B: A a 64-row tile, B rows
// r0 .. r0 + 31 of one (r0 a multiple of 8)
template <int D>
__device__ __forceinline__ void product_rows32(float (&acc)[4][4], uint32_t sa, uint32_t sb,
                                               int r0) {
  using H = HeadTile<D>;
  const uint32_t sb0 = sb + r0 * H::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < H::kSteps; ++kk)
    wgmma_ss32(acc, H::desc(sa + H::kstep(kk)), H::desc(sb0 + H::kstep(kk)), kk);
}

// One k-step of an m64 accumulator of 8 N8 columns against the 64-column
// atoms A, A + 1, .. of B (128-byte swizzle, MN-major, 8 KB apart from sb):
// A from registers (xa), or with kSmem from the descriptor da.
template <bool kSmem, int N8, int A = 0>
__device__ __forceinline__ void atoms_step(float (&acc)[N8][4], const uint32_t (&xa)[4],
                                           uint64_t da, uint32_t sb) {
  if constexpr (8 * A < N8) {
    const uint64_t db = HeadTile<64>::desc(sb + A * HeadTile<64>::kBytes);
    if constexpr (kSmem)
      wgmma_ss_mn_at<8 * A>(acc, da, db);
    else
      wgmma_rs_at<8 * A>(acc, xa, db);
    atoms_step<kSmem, N8, A + 1>(acc, xa, da, sb);
  }
}

// acc (64 x D) += X . B over 64 rows of the tile B (one head of D, read
// MN-major): X (64 x 64, fp32 accumulators of another product) rounded to
// bf16 as the A operand, one wgmma a k-step and a 64-column atom (n = 32 at
// D = 32)
template <int D>
__device__ __forceinline__ void product_cols(float (&acc)[D / 8][4], const uint32_t (&xa)[4][4],
                                             uint32_t sb) {
  using H = HeadTile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 32)
      wgmma_rs32(acc, xa[kk], H::desc(sb + kk * 16 * H::kRowBytes));
    else
      atoms_step<false>(acc, xa[kk], 0, sb + kk * 16 * H::kRowBytes);
  }
}

// acc (64 x 8 N8) += X . B[:, 64 a0 ..]: X a 64 x 64 bf16 tile in shared
// memory (128-byte swizzle, K-major), B 64 rows of a head of D >= 128 read
// MN-major from its atom a0 on
template <int D, int N8>
__device__ __forceinline__ void product_cols_ss(float (&acc)[N8][4], uint32_t sx, uint32_t sb,
                                                int a0) {
  using H = HeadTile<D>;
  using X = HeadTile<64>;
  static_assert(D >= 128, "two warpgroups split D >= 128 only");
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    atoms_step<true>(acc, none, X::desc(sx + X::kstep(kk)),
                     sb + a0 * H::kAtomBytes + kk * 16 * H::kRowBytes);
}

template <int N>
__device__ __forceinline__ void to_a(uint32_t (&xa)[N / 2][4], const float (&x)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) acc_to_a(xa[kk], x[2 * kk], x[2 * kk + 1]);
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

// The TMA map of a bf16 (B, T, heads * D) matrix with batch and time strides
// sb, st (elements) as 4-D (column in the atom, atom, t, b), one 64-row
// swizzled atom of `HeadTile<D>` per box; t runs to seq_len, so rows at or
// past it read as zeros.  False if the encoder refuses it: the base and
// both strides must be 16-byte multiples.
template <int D>
inline bool tile_map(CUtensorMap* map, const void* ptr, int heads, int seq_len, int batch,
                     long long st, long long sb) {
  using H = HeadTile<D>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H::kAtomCols),
                              static_cast<cuuint64_t>(heads) * H::kAtoms,
                              static_cast<cuuint64_t>(seq_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(H::kRowBytes),
                                 static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(H::kAtomCols), 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                H::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace vitrs
