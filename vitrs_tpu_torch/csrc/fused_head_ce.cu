// K8: the GPT head matmul with the cross-entropy statistics folded into its
// epilogue, written for Hopper (sm_90a).
//
// Replaces vitrs_tpu/ops/fused_head_ce.py _head_ce_fwd (kernel _kernel):
//   logits = x . w^T            x (R, C), w (Vp, C) the padded tied head,
//                               fp32 accumulation of the input-type products,
//                               written rounded to the input type;
//   lse    = logsumexp over the first real_vocab columns of the fp32 tile;
//   picked = the target column of the fp32 tile.
// So in bf16 the loss differs slightly from the two-op path, whose K5 reads
// the rounded logits; each is held to its own plain version.
//
// What is not carried over: the TPU grid sweeps the vocab sequentially per
// 2048-row panel (BLOCK_R = 2048), carrying an online (max, sumexp, picked)
// in VMEM from one grid step to the next.  At R = 8192-16384 that is 4-8
// panels against the H100's 132 SMs, and Hopper blocks cannot carry state
// from one to the next.  Here each (row tile, vocab tile) writes its rows'
// partial (max, sumexp) over its vocab columns; the owner of a row's target
// column writes picked directly.  A second, small launch merges the partials
// into lse (and writes NaN as picked for a target outside [0, real_vocab),
// as K5 does).
//
// What bounds it on the H100: at R = 8192, C = 768, Vp = 50304 the product
// is 2 R C Vp = 633 GFLOP, 0.640 ms at 989 TFLOP/s bf16, against 0.27 ms
// for its bytes (824 MB of bf16 logits written, 77 MB of w read): compute.
// The bf16 instance is a warp-specialised persistent GEMM with the CE
// statistics as its epilogue:
//   * one block an SM, 384 threads: a producer warpgroup (one thread issues
//     TMA copies; setmaxnreg gives its registers to the others) and two
//     consumer warpgroups.  The blocks walk the (row tile, vocab tile) grid
//     with the row tiles fastest, in groups of 8192 rows, so the tiles in
//     flight share a few vocab tiles of w and the group's x (12.6 MB at C =
//     768) stays in the 50 MB L2: w is read from device memory about once
//     a group;
//   * x and w arrive by TMA (2-D maps over the strided views, 64-wide k steps
//     of one 128-byte swizzled row, rows past R or Vp and columns past C as
//     zeros) into a ring of kStages stages with a full and an empty mbarrier
//     each; the producer runs ahead across tile boundaries;
//   * the products are wgmma m64n{kBN}k16 (fp32 accumulate), both operands
//     K-major from shared memory: at kBN = 256 a warpgroup reads 10 KB of
//     shared memory per 262,144 multiply-adds, against 4 KB per 65,536 for
//     m64n64;
//   * ping-pong: each consumer takes whole 64 x kBN tiles in turn, and the
//     products take turns (a turn barrier a consumer), so that one's
//     epilogue runs beside the other's products;
//   * the epilogue works on the fp32 accumulators: the logits rounded to
//     bf16 into a swizzled staging buffer per consumer, then written by TMA
//     stores (clipped at R and Vp) that run on behind the next products;
//     each row's max and sum of exp over its real columns from quad
//     shuffles and ex2, in four independent chains a row; the target by
//     its column, read before the products.
// Measured on the H100 (utils/head_ce_variants.py, PERF.md): the products
// alone run at about 800 TFLOP/s and the epilogue adds about 40% to them;
// hiding it by ping-pong gains a few percent over cooperative consumers
// (both on the two halves of one 128-row tile, whose epilogues leave the
// tensor cores idle), which the variants keep; staged TMA stores beat
// direct 4-byte stores by 1.5x.
// The fp32 instance (a cross-check against the plain version at fp32
// accuracy) does its products with FMA, 64 x 64 tiles, 4 x 4 outputs a
// thread.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper.cuh"

// d (+)= A . B for m64n{N}k16, A (64 x 16) and B (16 x N) K-major in shared
// memory; accumulate = 0 overwrites d.  d[nt][0..1] sit at row 16 warp + g,
// columns 8 nt + 2 t, +1; d[nt][2..3] eight rows lower (hopper.cuh WG_D).
// Outside the anonymous namespace, so that the widths a build does not use
// draw no unused-function warning.
namespace vitrs_k8 {

#define HC_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HC_R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HC_R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define HC_R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HC_R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define HC_R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HC_R6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define HC_R7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HC_D(d, i)                                                                         \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3]), "+f"(d[i + 1][0]),           \
      "+f"(d[i + 1][1]), "+f"(d[i + 1][2]), "+f"(d[i + 1][3]), "+f"(d[i + 2][0]),          \
      "+f"(d[i + 2][1]), "+f"(d[i + 2][2]), "+f"(d[i + 2][3]), "+f"(d[i + 3][0]),          \
      "+f"(d[i + 3][1]), "+f"(d[i + 3][2]), "+f"(d[i + 3][3])
#define HC_WGMMA(N, LIST, A, B, P, ...)                                                    \
  template <>                                                                              \
  struct Wgmma<N> {                                                                        \
    static __device__ __forceinline__ void mma(float (&d)[N / 8][4], uint64_t da,         \
                                               uint64_t db, int accumulate) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                        \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" LIST       \
                   "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                              \
                   : __VA_ARGS__                                                           \
                   : "l"(da), "l"(db), "r"(accumulate)                                     \
                   : "memory");                                                            \
    }                                                                                      \
  };
template <int N>
struct Wgmma;
HC_WGMMA(128, HC_R0 ", " HC_R1 ", " HC_R2 ", " HC_R3, 64, 65, 66, HC_D(d, 0), HC_D(d, 4),
         HC_D(d, 8), HC_D(d, 12))
HC_WGMMA(192, HC_R0 ", " HC_R1 ", " HC_R2 ", " HC_R3 ", " HC_R4 ", " HC_R5, 96, 97, 98,
         HC_D(d, 0), HC_D(d, 4), HC_D(d, 8), HC_D(d, 12), HC_D(d, 16), HC_D(d, 20))
HC_WGMMA(256, HC_R0 ", " HC_R1 ", " HC_R2 ", " HC_R3 ", " HC_R4 ", " HC_R5 ", " HC_R6 ", " HC_R7,
         128, 129, 130, HC_D(d, 0), HC_D(d, 4), HC_D(d, 8), HC_D(d, 12), HC_D(d, 16),
         HC_D(d, 20), HC_D(d, 24), HC_D(d, 28))

}  // namespace vitrs_k8

namespace {

using namespace vitrs;
using vitrs_k8::Wgmma;

struct Args {
  const void* x;        // (rows, C) rows of x_ld elements (fp32: contiguous)
  const void* w;        // (Vp, C) rows of w_ld elements (fp32: contiguous)
  const long long* targets;  // (rows,)
  void* logits;         // (rows, Vp), the input type
  float* part_m;        // (rows, n_tiles) partial max of each vocab tile
  float* part_s;        // (rows, n_tiles) partial sum of exp(x - part_m)
  float* lse;           // (rows,)
  float* picked;        // (rows,)
  int rows, C, Vp, real_vocab, n_tiles;
};

// merge (m2, s2) into (m, s): sums of exp(x - m) over two sets
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// ---------------------------------------------------------------------------
// bf16 instance: warp-specialised persistent wgmma GEMM, CE epilogue.
// ---------------------------------------------------------------------------
constexpr int kBN = 256;          // vocab columns of a tile
constexpr int kStages = 4;        // depth of the TMA ring
constexpr bool kPingPong = true;  // consumers on tiles of their own in turn (false:
                                  // cooperative, on the two halves of one tile)
constexpr int kBK = 64;           // k step: one 128-byte swizzled row of bf16
constexpr int kWgRows = 64;       // rows of a warpgroup's wgmma
constexpr int kBM = kPingPong ? kWgRows : 2 * kWgRows;  // rows of a tile
constexpr int kXBytes = kBM * kBK * 2, kWBytes = kBN * kBK * 2;
constexpr int kStage = kXBytes + kWBytes;
constexpr int kOut = kWgRows * kBN * 2;  // a warpgroup's staged bf16 logits
constexpr int kSub = kWgRows * 128;      // one 64 x 64 staged sub-tile
constexpr int kThreads = 384;            // producer + two consumer warpgroups

// Dynamic shared memory: the ring's stages (x tile, then w tile), the two
// staging buffers, a full and an empty barrier per stage and a turn barrier
// per consumer; 1 KB of slack for the 1024-byte alignment of the swizzle.
__host__ __device__ constexpr int tile_smem() {
  return 1024 + kStages * kStage + 2 * kOut + 16 * kStages + 16;
}
static_assert(kBN % 64 == 0 && kBN <= 256, "wgmma N: whole 64-column sub-tiles");
static_assert(tile_smem() <= 232448, "the ring and staging exceed shared memory");

// keeps the compiler from moving accesses of the accumulator across the
// asynchronous products that write it
__device__ __forceinline__ void hold(float (&x)[kBN / 8][4]) {
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}

__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the box of a 2-D map at (col, row) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// shared memory into the box of a 2-D map at (col, row), clipped at its edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(col), "r"(row)
               : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// the 128 threads of consumer warpgroup c (named barrier 1 + c)
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// acc = this warpgroup's 64 rows (x at byte xoff of each stage) times the
// tile's w, over the k steps q0 .. q0 + ksteps - 1 of the ring; each stage is
// released as soon as the products that read it are done, one group behind
// the products in flight.  Ping-pong: one arrival on `turn` once the last
// stage has arrived and its products are issued, so that the other consumer
// starts on its tile while these run.
__device__ __forceinline__ void product(float (&acc)[kBN / 8][4], uint32_t base, uint32_t xoff,
                                        uint32_t full, uint32_t empty, uint32_t turn, int q0,
                                        int ksteps, int tid) {
  hold(acc);
  for (int k = 0; k < ksteps; ++k) {
    const int q = q0 + k, st = q % kStages;
    const uint32_t sx = base + st * kStage;
    mbar_wait(full + 8 * st, (q / kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<kBN>::mma(acc, HeadTile<64>::desc(sx + xoff + kk * 32),
                      HeadTile<64>::desc(sx + kXBytes + kk * 32), k > 0 || kk > 0);
    wg_commit();
    if (kPingPong && k == ksteps - 1 && tid == 0) mbar_arrive(turn);
    if (k > 0) {
      wg_wait<1>();
      if (tid == 0) mbar_arrive(empty + 8 * ((q - 1) % kStages));
    }
  }
  wg_wait<0>();
  hold(acc);
  if (tid == 0) mbar_arrive(empty + 8 * ((q0 + ksteps - 1) % kStages));
}

// The tile's logits, rounded to bf16, into consumer c's staging buffer at
// `so` (kBN / 64 swizzled 64 x 64 sub-tiles, conflict-free 4-byte stores),
// then out by TMA stores that run on behind the next tile's products.
__device__ __forceinline__ void store_tile(const float (&acc)[kBN / 8][4], const CUtensorMap* out,
                                           uint32_t so, int c, int m0, int n0, const Args& a,
                                           int tid) {
  const int r = (tid >> 5) * 16 + ((tid & 31) >> 2), t4 = tid & 3;
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  wg_sync(c);  // the previous tile's stores have read the buffer
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    const uint32_t p = so + (nt >> 3) * kSub + r * 128 + (((nt & 7) ^ (r & 7)) << 4) + 4 * t4;
    st_shared(p, pack_f32(acc[nt][0], acc[nt][1]));
    st_shared(p + 8 * 128, pack_f32(acc[nt][2], acc[nt][3]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(c);
  if (tid == 0 && m0 < a.rows) {
    for (int j = 0; j < kBN / 64 && n0 + 64 * j < a.Vp; ++j)
      tma_store(out, so + j * kSub, n0 + 64 * j, m0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// The target of `row` when it is a real column, else -1 (no pick; the merge
// writes NaN for a target outside [0, real_vocab)).  Read before the tile's
// products, so that its latency hides behind them.
__device__ __forceinline__ int target_of(const Args& a, int row) {
  if (row >= a.rows) return -1;
  const long long tgt = a.targets[row];
  return tgt >= 0 && tgt < a.real_vocab ? static_cast<int>(tgt) : -1;
}

// picked[row] from the thread whose columns hold the row's target tgt (kH: 0
// for the thread's upper row, 2 for the lower)
template <int kH>
__device__ __forceinline__ void pick(const float (&acc)[kBN / 8][4], const Args& a, int row,
                                     int tgt, int n0, int t4) {
  const int d = tgt - n0 - 2 * t4;  // 8 nt + e for this thread's columns
  if (tgt < 0 || d < 0 || d >= kBN || (d & 6)) return;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
    if (8 * nt == (d & ~7)) a.picked[row] = (d & 1) ? acc[nt][kH + 1] : acc[nt][kH];
}

// Per row of the tile: picked, and the partial max and sum of exp over the
// real columns (vocab tile vt) from the fp32 accumulators; a quad of lanes
// holds a row (rows r0 and r0 + 8 of this thread, targets tg0 and tg1).  Pad
// columns are set to -inf in acc first.
__device__ __forceinline__ void tile_stats(float (&acc)[kBN / 8][4], const Args& a, int r0,
                                           int tg0, int tg1, int n0, int vt, int tid) {
  const int t4 = tid & 3, r1 = r0 + 8;
  pick<0>(acc, a, r0, tg0, n0, t4);
  pick<2>(acc, a, r1, tg1, n0, t4);
  if (n0 + kBN > a.real_vocab) {
    const int lim = a.real_vocab - n0 - 2 * t4;  // column 8 nt + e is real below it
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * nt + e >= lim) acc[nt][e] = acc[nt][2 + e] = -INFINITY;
  }
  // four independent partial maxima and sums a row, so that two warps a
  // scheduler keep the special function unit busy instead of waiting out
  // one long chain of dependent adds
  float m0[4], m1[4], p0[4], p1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m0[j] = m1[j] = -INFINITY, p0[j] = p1[j] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    m0[nt & 3] = fmaxf(m0[nt & 3], fmaxf(acc[nt][0], acc[nt][1]));
    m1[nt & 3] = fmaxf(m1[nt & 3], fmaxf(acc[nt][2], acc[nt][3]));
  }
  float mx0 = quad_max(fmaxf(fmaxf(m0[0], m0[1]), fmaxf(m0[2], m0[3])));
  float mx1 = quad_max(fmaxf(fmaxf(m1[0], m1[1]), fmaxf(m1[2], m1[3])));
  // a row with no real column here keeps a finite reference: ex2 gives 0
  const float nl0 = mx0 == -INFINITY ? 0.f : -mx0 * kLog2e;
  const float nl1 = mx1 == -INFINITY ? 0.f : -mx1 * kLog2e;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    p0[nt & 3] += ex2(fmaf(acc[nt][0], kLog2e, nl0)) + ex2(fmaf(acc[nt][1], kLog2e, nl0));
    p1[nt & 3] += ex2(fmaf(acc[nt][2], kLog2e, nl1)) + ex2(fmaf(acc[nt][3], kLog2e, nl1));
  }
  const float s0 = quad_sum((p0[0] + p0[1]) + (p0[2] + p0[3]));
  const float s1 = quad_sum((p1[0] + p1[1]) + (p1[2] + p1[3]));
  if (t4 == 0) {
    if (r0 < a.rows) {
      a.part_m[(long long)r0 * a.n_tiles + vt] = mx0;
      a.part_s[(long long)r0 * a.n_tiles + vt] = s0;
    }
    if (r1 < a.rows) {
      a.part_m[(long long)r1 * a.n_tiles + vt] = mx1;
      a.part_s[(long long)r1 * a.n_tiles + vt] = s1;
    }
  }
}

// Tile t of the (row tile, vocab tile) grid: the vocab tiles are swept by
// groups of kGroupRows rows, the row tiles fastest within a group, so that
// the tiles in flight share a few vocab tiles of w and the group's rows of x
// (12.6 MB at C = 768) stay in L2; w is read from device memory once a group.
constexpr int kGroupRows = 8192;
constexpr int kGroup = kGroupRows / kBM;   // row tiles a group

__device__ __forceinline__ void tile_at(int t, int m_tiles, int n_tiles, int& mt, int& vt) {
  const int g = t / (kGroup * n_tiles), l = t - g * kGroup * n_tiles;
  const int rows = min(kGroup, m_tiles - g * kGroup);   // row tiles of group g
  mt = g * kGroup + l % rows;
  vt = l / rows;
}

// Tensor maps of x, w and the logits (kernel parameters, as TMA needs)
struct Maps {
  CUtensorMap x, w, out;
};

__global__ void __launch_bounds__(kThreads, 1)
    head_ce_wgmma(const __grid_constant__ Maps maps, Args a, int m_tiles) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);  // stage st at base + st kStage: x, then w
  const uint32_t staged = base + kStages * kStage;
  const uint32_t full = staged + 2 * kOut, empty = full + 8 * kStages;
  const uint32_t turn = empty + 8 * kStages;  // ping-pong: consumer c's products done
  const int tiles = m_tiles * a.n_tiles, ksteps = (a.C + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init_count(full + 8 * s, 1);
      mbar_init_count(empty + 8 * s, kPingPong ? 1 : 2);  // one arrival a consumer
    }
    mbar_init_count(turn, 1);
    mbar_init_count(turn + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    // producer: one thread keeps the ring full, k step by k step of this
    // block's tiles (t = blockIdx.x, + gridDim.x, ...)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int q = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, vt;
        tile_at(t, m_tiles, a.n_tiles, mt, vt);
        for (int k = 0; k < ksteps; ++k, ++q) {
          const int st = q % kStages;
          const uint32_t sx = base + st * kStage, bar = full + 8 * st;
          mbar_wait(empty + 8 * st, ((q / kStages) & 1) ^ 1);
          mbar_expect(bar, kStage);
          tma_load(sx, &maps.x, bar, k * kBK, mt * kBM);
          tma_load(sx + kXBytes, &maps.w, bar, k * kBK, vt * kBN);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    float acc[kBN / 8][4];
    int i = 0;  // the block's tile count: tile i's k steps are ring steps i ksteps ..
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      if (kPingPong && (i & 1) != c) continue;
      int mt, vt;
      tile_at(t, m_tiles, a.n_tiles, mt, vt);
      const int m0 = mt * kBM + (kPingPong ? 0 : c * kWgRows), n0 = vt * kBN;
      const int r0 = m0 + (tid >> 5) * 16 + ((tid & 31) >> 2);  // this thread's rows: r0, r0 + 8
      const int tg0 = target_of(a, r0), tg1 = target_of(a, r0 + 8);
      const uint32_t xoff = kPingPong ? 0 : c * kWgRows * kBK * 2;
      // ping-pong: the products of the tiles take turns, so a consumer
      // starts only once the other has issued the products of tile i - 1
      // (its ((i - 1) / 2)-th): the two never wait on one ring stage in
      // rounds far enough apart that the barrier's parity repeats, and each
      // one's epilogue runs beside the other's products
      if (kPingPong && i > 0) mbar_wait(turn + 8 * (1 - c), ((i - 1) >> 1) & 1);
      product(acc, base, xoff, full, empty, turn + 8 * c, i * ksteps, ksteps, tid);
      store_tile(acc, &maps.out, staged + c * kOut, c, m0, n0, a, tid);
      tile_stats(acc, a, r0, tg0, tg1, n0, vt, tid);
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The TMA map of a bf16 (rows, cols) matrix with `ld` elements between rows,
// one (box_rows, 64) box under the 128-byte swizzle; boxes past the edges
// read as zeros and store clipped.  False if the encoder refuses it: the base
// and ld must be 16-byte multiples.
bool map_2d(CUtensorMap* map, const void* ptr, int cols, int rows, long long ld, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile kernel's shared-memory limit, set once per device (a call costs
// host time), and in *sms the device's SMs: one block each.
cudaError_t configure(int* sms) {
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(head_ce_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tile_smem());
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

cudaError_t launch_wgmma(const Args& a, long long x_ld, long long w_ld, cudaStream_t s) {
  Maps maps = {};
  if (!map_2d(&maps.x, a.x, a.C, a.rows, x_ld, kBM) ||
      !map_2d(&maps.w, a.w, a.C, a.Vp, w_ld, kBN) ||
      !map_2d(&maps.out, a.logits, a.Vp, a.rows, a.Vp, kWgRows))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return err;
  const int m_tiles = (a.rows + kBM - 1) / kBM, tiles = m_tiles * a.n_tiles;
  head_ce_wgmma<<<tiles < sms ? tiles : sms, kThreads, tile_smem(), s>>>(maps, a, m_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 instance: FMA, 64 x 64 tiles, 256 threads of 4 x 4 outputs; k chunks
// of 16 staged transposed in shared memory.
// ---------------------------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(256) head_ce_fma(Args a) {
  __shared__ float xs[kFK][kFM + 4];
  __shared__ float ws[kFK][kFN + 4];
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* X = static_cast<const float*>(a.x);
  const float* W = static_cast<const float*>(a.w);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.C; k0 += kFK) {
    __syncthreads();
    {
      const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 4;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < a.rows)
        xv = *reinterpret_cast<const float4*>(X + (long long)(m0 + r) * a.C + k0 + c);
      const float4 wv = *reinterpret_cast<const float4*>(W + (long long)(n0 + r) * a.C + k0 + c);
      xs[c][r] = xv.x; xs[c + 1][r] = xv.y; xs[c + 2][r] = xv.z; xs[c + 3][r] = xv.w;
      ws[c][r] = wv.x; ws[c + 1][r] = wv.y; ws[c + 2][r] = wv.z; ws[c + 3][r] = wv.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float xr[4], wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = xs[kk][ty * 4 + i];
        wr[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
  }
  float* L = static_cast<float*>(a.logits);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const bool live = row < a.rows;
    const long long tgt = live ? a.targets[row] : -1;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (live) {
        L[(long long)row * a.Vp + col] = acc[i][j];
        if (col < a.real_vocab && col == tgt) a.picked[row] = acc[i][j];
      }
      if (col < a.real_vocab) mx = fmaxf(mx, acc[i][j]);
    }
    // the 16 threads of a row are 16 neighbouring lanes (tx)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + tx * 4 + j < a.real_vocab) s += expf(acc[i][j] - mx);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tx == 0 && live) {
      const long long idx = (long long)row * a.n_tiles + blockIdx.y;
      a.part_m[idx] = mx;
      a.part_s[idx] = s;
    }
  }
}

// one warp per row: lse from the row's partials; NaN as picked for a
// target outside [0, real_vocab)
__global__ void __launch_bounds__(256) head_ce_merge(Args a) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= a.rows) return;
  float m = -INFINITY, s = 0.f;
  for (int i = lane; i < a.n_tiles; i += 32) {
    const long long idx = (long long)row * a.n_tiles + i;
    merge(m, s, a.part_m[idx], a.part_s[idx]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (lane == 0) {
    a.lse[row] = m + logf(s);
    const long long tgt = a.targets[row];
    if (tgt < 0 || tgt >= a.real_vocab) a.picked[row] = NAN;
  }
}

}  // namespace

// The vocab tile of each instance: the partials hold ceil(Vp / tile) columns.
extern "C" int vitrs_head_ce_tile(int dtype) { return dtype == 1 ? kBN : kFN; }

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (wgmma instance).
// x (rows, C) and w (Vp, C) with x_ld and w_ld elements between rows: bf16
// reads them by TMA, so their bases and ld must be 16-byte multiples; fp32
// takes contiguous rows (ld == C) and a Vp that fills its 64-column tiles.
// C a multiple of 32; logits (rows, Vp) contiguous in the input type;
// part_m, part_s (rows, ceil(Vp / tile)) fp32 scratch; lse, picked (rows,)
// fp32.  Launches two kernels on `stream` without synchronising; returns
// the first launch error.
extern "C" int vitrs_head_ce_fwd(int dtype, const void* x, const void* w,
                                 const long long* targets, int rows, int C, int Vp,
                                 int real_vocab, long long x_ld, long long w_ld, void* logits,
                                 float* part_m, float* part_s, float* lse, float* picked,
                                 void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || C <= 0 || C % 32 != 0 || real_vocab <= 0 ||
      real_vocab > Vp || x_ld < C || w_ld < C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && (Vp % kFN != 0 || x_ld != C || w_ld != C))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = vitrs_head_ce_tile(dtype);
  Args a{x, w, targets, logits, part_m, part_s, lse, picked, rows, C, Vp, real_vocab,
         (Vp + tile - 1) / tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_wgmma(a, x_ld, w_ld, s);
  } else {
    head_ce_fma<<<dim3((rows + kFM - 1) / kFM, Vp / kFN), 256, 0, s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  head_ce_merge<<<(rows + 7) / 8, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resources of a kernel as compiled: 0 the bf16 tile kernel, 1 the merge;
// out = {registers per thread, local (spill) bytes per thread, static shared
// bytes, dynamic shared bytes per block, threads per block, blocks a launch
// at most (the tile kernel's persistent grid on the current device; the
// merge: 0, its grid follows the rows)}.
extern "C" int vitrs_head_ce_attrs(int kernel, int* out) {
  const void* fn = nullptr;
  int dyn = 0, threads = 256, blocks = 0;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(head_ce_wgmma);
    dyn = tile_smem();
    threads = kThreads;
    const cudaError_t err = configure(&blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (kernel == 1) {
    fn = reinterpret_cast<const void*>(head_ce_merge);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = dyn;
  out[4] = threads;
  out[5] = blocks;
  return 0;
}
