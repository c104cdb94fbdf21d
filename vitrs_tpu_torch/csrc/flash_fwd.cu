// K1-fwd, K3-fwd and K4: the flash-attention forward, written for Hopper
// (sm_90a), built once per head dim D in {32, 64, 128, 256} (-DVITRS_HEAD_DIM,
// ops/_build.py).
//
// Replaces these Pallas forwards, which compute one function at three
// geometries:
//   K1-fwd  vitrs_tpu/ops/flash_attention.py  _fwd_single_kernel (one tile,
//           T <= 512; launched by _fwd_single) and _fwd_kernel (online
//           softmax over 512-wide kv tiles; launched by _fwd): MHA;
//   K3-fwd  vitrs_tpu/ops/flash_attention_gqa.py  _fwd_single and _fwd (the
//           same tile kernels at GQA geometry): q at C width, k/v at
//           kv_dim = kv_heads * D width;
//   K4      vitrs_tpu/ops/flash_prefill.py  flash_prefill_qkv (the same tile
//           kernel as a rectangle): tq chunk queries at absolute positions
//           q_off .. q_off+tq-1 against a kv cache, MHA or GQA.
// It computes what they compute, not their block structure:
//   * q, k and v are read in place through separate pointers and strides
//     (views into the packed qkv, or a q view and the kv caches); query
//     head h reads channels h*D of q and kv head h / (num_heads/kv_heads)
//     of k and v (the Llama/GQA grouping; MHA is kv_heads == num_heads), so
//     K/V are never expanded to num_heads in device memory;
//   * one thread block per (q tile of 64 rows, query head, batch); a loop
//     over kv tiles inside the block replaces the TPU's sequential grid
//     axis, and in causal mode it stops at the block's causal frontier
//     (row + q_off), so cache slots beyond seq_len are never read;
//   * q is pre-scaled by sm_scale and rounded to the input type, as the
//     Pallas bodies do; scores, the running max m, the running sum l and the
//     output accumulator stay in fp32; p rounds to the input type for P.V;
//   * the ragged end is masked against seq_len and tq instead of padding;
//   * the queries may lie past the keys' end: the wrapper passes the causal
//     frontier seq_len = min(keys, q_off + tq), so on the ring's past block
//     that the band cuts (parallel/ring_attention.py: 1023 rows at q_off
//     1023 against 1023 keys on the 8K window) the frontier falls inside the
//     block's rows; a row that sees no key (its band starts past seq_len)
//     gives out 0 and lse -inf.  Under rope the wrapper refuses it;
//   * sliding window (window > 0, causal only): query at position p sees
//     keys in (p - window, p]; the kv loop starts at the first tile the
//     block's band reaches (band_start) as well as stopping at its causal
//     frontier, so a block visits about (window + 64) / 64 tiles instead of
//     all tiles up to the diagonal, and tiles the band's lower edge crosses
//     are masked per element (the Pallas kernels' _tile_overlaps_band and
//     _band_crosses_tile);
//   * rope (rope_cos != nullptr): q and k arrive unrotated; q is rotated at
//     positions q_off + row with sm_scale folded into its cos and sin, k at
//     its key index, both rounded to the input type (the Pallas order,
//     flash_attention.py _fwd_kernel).  The table is the compact fp32
//     (positions, D/2) cos/sin of ops/rope.py (D < 256: the JAX kernels
//     have no rope at D = 256, and the port routes it densely, as the JAX
//     package does on the CPU); the Pallas kernels' 256-lane
//     bf16 table and +-1 permutation matmul are TPU layout, not carried over;
//   * out is written in the input type and lse = m + log(l) compact at
//     (B, NH, tq) fp32 (the Pallas kernels broadcast it over 128 lanes).
// TPU-shaped parts that are not carried over: the 128-lane head groups and
// kv blocks, the phantom-lane padding of small kv widths (pad_gqa_weight),
// the split-cell grid (_q_split) and the VMEM budgets.  The GQA Pallas grid
// shares each kv block across its query group in VMEM; here the R query
// heads of a group are R blocks that read the same k/v rows, which the 50 MB
// L2 serves.
//
// The bf16 instance, for Hopper (the Hopper pieces are in hopper.cuh):
//   * one warpgroup (128 threads) per q tile of 64 rows at every D.  q is loaded with
//     16-byte loads, rotated (rope, sm_scale folded into cos and sin) and
//     rounded in registers, and stored once into a swizzled shared tile;
//   * K and V tiles arrive by TMA (cp.async.bulk.tensor through 4-D tensor
//     maps over the strided views, completion on mbarriers) into a ring of
//     kStages stages in dynamic shared memory, with the swizzle that wgmma
//     reads and no padding (one TMA box per 64-column atom of a row: 1, 2
//     or 4 at D = 64, 128, 256; at D = 32 one 64-byte atom under the
//     64-byte swizzle); thread 0 keeps the next tile in
//     flight while the current tile's products run.  The maps' time extent
//     is seq_len, the causal frontier under K4, so rows past it arrive as
//     zeros: a NaN in a cache tail never meets P.V (0 x NaN);
//   * S = Q.K^T and O += P.V run on wgmma (fp32 accumulate): S on m64n64k16
//     over D / 16 k-steps, Q and K both read K-major from shared memory; O
//     on one m64n64k16 a 64-column atom of V (m64n32k16 at D = 32), P turned
//     from the S accumulator into register A operands against V read
//     MN-major; every
//     product is waited for before its accumulator is touched again, so
//     ptxas keeps the wgmma pipeline (no C7515);
//   * p = 2^(s log2 e - m log2 e) on ex2.approx, alpha likewise; lse =
//     m + ln l stays in natural log, as the backward reads it;
//   * only tiles on the causal diagonal, the band's lower edge or the ragged
//     end mask per element; causal q tiles launch heaviest first;
//   * out leaves through the Q tile, in 16-byte stores of whole rows;
//   * under rope, a pre-pass launch writes k rotated and rounded into
//     (B, seq_len, kv_dim) scratch from the wrapper, so TMA copies plain
//     tiles.
// What bounds it on the H100: per (q row, key) pair it does 2 x D
// multiply-adds on the tensor cores and one exp on the special function
// unit, which at D = 64 take about as long as each other (a 64 x 64 tile:
// 8 wgmma of about 32 cycles against 4096 exps at 16 a cycle).  Measured
// (utils/fwd_variants.py, PERF.md), neither is the limit: dropping the exps,
// the P.V product or even the S product saves 3-20% each, and halving the
// K/V traffic (two warpgroups sharing each tile) saves nothing.  Each
// warpgroup's chain per tile (wait, S, softmax, P.V, wait) is latency, so
// the design buys blocks an SM: a 2-deep ring and 94 registers fit five
// (42 KB each).  Rotating each staged K tile in shared memory instead of the
// pre-pass redoes the rotation for every q tile that reads it and ran 4-5x
// slower at T = 8192.  Blocks an SM follow D (kMinBlocks): the O
// accumulator is D / 2 floats a thread and the ring 5 tiles of 128 D bytes,
// so 5 blocks fit at D <= 64, 2 at D = 128 (81 KB each) and 1 at D = 256
// (161 KB, about 200 registers).
// The fp32 instance (a cross-check of the bf16 one against the plain
// PyTorch version at fp32 accuracy) does its products with FMA, one thread
// per q row (D / 64 threads at D > 64, each owning 64 columns, so its q and
// accumulator stay 64 registers), and rotates q and k as it stages them.  Times on the card are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace vitrs;

#ifndef VITRS_HEAD_DIM
#error "build with -DVITRS_HEAD_DIM=D (ops/_build.load(name, D))"
#endif

constexpr int kHeadDim = VITRS_HEAD_DIM;  // D of this library; the wrapper checks it
constexpr int kHalf = kHeadDim / 2;  // rope pairs dim c with dim c + kHalf
constexpr bool kRopeOk = kHeadDim != 256;  // rope instances exist below D = 256
constexpr int kBlockM = 64;    // q rows per thread block
constexpr int kBlockN = 64;    // kv rows per shared-memory tile (wgmma path)
// FMA path: kv rows per staged tile (its K and V stay within 32 KB of
// static shared memory), and threads per q row, each owning kFmaPart columns
constexpr int kFmaBlockN = kHeadDim == 256 ? 16 : 32;
constexpr int kFmaSplit = kHeadDim <= 64 ? 1 : kHeadDim / 64;
constexpr int kFmaPart = kHeadDim / kFmaSplit;
using Tile = HeadTile<kHeadDim>;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long long q_sb, q_st;  // batch and time strides, in elements
  long long k_sb, k_st;
  long long v_sb, v_st;
  long long o_sb, o_st;
  int num_heads;
  int group;     // query heads per kv head: num_heads / kv_heads
  int tq;        // query rows
  int seq_len;   // keys 0 .. seq_len-1 exist
  int q_off;     // absolute position of query row 0
  int causal;
  int window;    // > 0: the causal band (p - window, p]; 0: none
  float sm_scale;
  const float* rope_cos;  // (positions, kHalf) fp32, or nullptr: no rope
  const float* rope_sin;
};

// exclusive end of the keys any row of the block at q rows [m0, m0+kBlockM) sees
__device__ __forceinline__ int kv_end_of(const Args& a, int m0) {
  int end = a.seq_len;
  if (a.causal) end = min(end, m0 + kBlockM + a.q_off);
  return end;
}

// kBand: the instance for window > 0 (causal).  The band is a template
// argument, as rope is, so the instances without it are the plain causal
// kernel: no start bound, no edge test, no window compare.

// first kv tile (of `tile` rows) any row of that block sees
template <bool kBand>
__device__ __forceinline__ int kv_start_of(const Args& a, int m0, int tile) {
  return kBand ? band_start(m0 + a.q_off, a.window, tile) : 0;
}

template <bool kBand>
__device__ __forceinline__ bool visible(const Args& a, int j, int q_pos) {
  if (kBand) return j < a.seq_len && in_band(j, q_pos, a.window);
  return j < a.seq_len && (!a.causal || j <= q_pos);
}

// ---------------------------------------------------------------------------
// FMA instance: one thread per q row, kv tiles of kFmaBlockN rows in smem.
// ---------------------------------------------------------------------------
template <typename T, bool kRope, bool kBand>
__global__ void __launch_bounds__(kBlockM * kFmaSplit) flash_fwd_fma(Args a) {
  __shared__ float ks[kFmaBlockN][kHeadDim];
  __shared__ float vs[kFmaBlockN][kHeadDim];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int row = m0 + threadIdx.x / kFmaSplit;
  const int part = threadIdx.x % kFmaSplit, c0 = part * kFmaPart;  // this thread's columns
  const bool live = row < a.tq;
  const int q_pos = row + a.q_off;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)row * a.q_st
                + h * kHeadDim + c0;
  const int hk = h / a.group;  // this query head's kv head
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * kHeadDim;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * kHeadDim;

  float q[kFmaPart], acc[kFmaPart];
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) {
    q[d] = live ? to_f(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  if constexpr (kRope) {
    // rotate at q_pos with sm_scale folded into cos and sin, then round
    const float* cr = a.rope_cos + (long long)(live ? q_pos : 0) * kHalf;
    const float* sr = a.rope_sin + (long long)(live ? q_pos : 0) * kHalf;
    if constexpr (kFmaSplit == 1) {
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        rope_pair(q[d], q[d + kHalf], __fmul_rn(cr[d], a.sm_scale),
                  __fmul_rn(sr[d], a.sm_scale));
        q[d] = to_f(from_f<T>(q[d]));
        q[d + kHalf] = to_f(from_f<T>(q[d + kHalf]));
      }
    } else {
      // column c's partner c + kHalf sits kFmaSplit / 2 lanes away
      const bool upper = part >= kFmaSplit / 2;
      const int tc = c0 % kHalf;
#pragma unroll
      for (int d = 0; d < kFmaPart; ++d) {
        const float other = __shfl_xor_sync(0xffffffffu, q[d], kFmaSplit / 2);
        float x1 = upper ? other : q[d], x2 = upper ? q[d] : other;
        rope_pair(x1, x2, __fmul_rn(cr[tc + d], a.sm_scale), __fmul_rn(sr[tc + d], a.sm_scale));
        q[d] = to_f(from_f<T>(upper ? x2 : x1));
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < kFmaPart; ++d) q[d] = to_f(from_f<T>(q[d] * a.sm_scale));
  }
  float m = -INFINITY, l = 0.f;
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of<kBand>(a, m0, kFmaBlockN); n0 < kv_end; n0 += kFmaBlockN) {
    __syncthreads();
    if constexpr (kRope) {
      for (int i = threadIdx.x; i < kFmaBlockN * kHalf; i += blockDim.x) {
        const int r = i / kHalf, c = i % kHalf, j = n0 + r;
        float x1 = 0.f, x2 = 0.f;
        if (j < a.seq_len) {
          x1 = to_f(kp[(long long)j * a.k_st + c]);
          x2 = to_f(kp[(long long)j * a.k_st + c + kHalf]);
          rope_pair(x1, x2, a.rope_cos[(long long)j * kHalf + c],
                    a.rope_sin[(long long)j * kHalf + c]);
        }
        ks[r][c] = to_f(from_f<T>(x1));
        ks[r][c + kHalf] = to_f(from_f<T>(x2));
      }
    } else {
      for (int i = threadIdx.x; i < kFmaBlockN * kHeadDim; i += blockDim.x) {
        const int r = i / kHeadDim, c = i % kHeadDim, j = n0 + r;
        ks[r][c] = j < a.seq_len ? to_f(kp[(long long)j * a.k_st + c]) : 0.f;
      }
    }
    for (int i = threadIdx.x; i < kFmaBlockN * kHeadDim; i += blockDim.x) {
      const int r = i / kHeadDim, c = i % kHeadDim, j = n0 + r;
      vs[r][c] = j < a.seq_len ? to_f(vp[(long long)j * a.v_st + c]) : 0.f;
    }
    __syncthreads();
    float s[kFmaBlockN];
    float mt = m;
#pragma unroll
    for (int jj = 0; jj < kFmaBlockN; ++jj) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < kFmaPart; ++d) x = fmaf(q[d], ks[jj][c0 + d], x);
      // the row's threads are neighbours in one warp
#pragma unroll
      for (int off = 1; off < kFmaSplit; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      s[jj] = visible<kBand>(a, n0 + jj, q_pos) ? x : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    // a row that sees no key yet keeps a finite reference: exp() gives 0
    const float ref = (mt == -INFINITY) ? 0.f : mt;
    const float alpha = expf(m - ref);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kFmaPart; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kFmaBlockN; ++jj) {
      const float p = expf(s[jj] - ref);
      l += p;
      const float pr = to_f(from_f<T>(p));
#pragma unroll
      for (int d = 0; d < kFmaPart; ++d) acc[d] = fmaf(pr, vs[jj][c0 + d], acc[d]);
    }
    m = mt;
  }
  if (!live) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* op = static_cast<T*>(a.out) + b * a.o_sb + (long long)row * a.o_st + h * kHeadDim + c0;
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) op[d] = from_f<T>(acc[d] * inv);
  if (part == 0)
    a.lse[((long long)b * a.num_heads + h) * a.tq + row] = l > 0.f ? m + logf(l) : -INFINITY;
}

// ---------------------------------------------------------------------------
// bf16 instance: wgmma on K/V tiles staged by TMA in a ring (hopper.cuh).
// ---------------------------------------------------------------------------

constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kTile = Tile::kBytes;  // bytes of one bf16 tile in smem (64 rows of D)
// blocks an SM the registers are budgeted for: the O accumulator is D / 2
// floats a thread, and the shared memory below allows 2 blocks at D = 128
constexpr int kMinBlocks = kHeadDim <= 64 ? 5 : (kHeadDim == 128 ? 2 : 1);
constexpr int kRopeLanes = kHalf / 8;   // threads a row of the rope pre-pass

// Dynamic shared memory: per stage a K tile and a V tile, then the Q tile,
// then one mbarrier per stage; 1 KB of slack for the 1024-byte alignment of
// the swizzle.
__host__ __device__ constexpr int fwd_smem() {
  return 1024 + (2 * kStages + 1) * kTile + kStages * 8;
}

// Tensor maps of the K and V tiles (kernel parameters, as TMA needs)
struct Maps {
  CUtensorMap k;   // k, or the pre-pass's rotated copy under rope
  CUtensorMap v;
};

// Under rope, the pre-pass: k rows 0..seq_len-1 rotated at their key index
// and rounded to bf16 into contiguous (B, seq_len, kv_dim) scratch, D / 16
// threads a row (each 8 pairs: columns c..c+7 with c+D/2..c+D/2+7).
__global__ void __launch_bounds__(256) flash_fwd_rope_k(Args a, bf16* k_rot, int batch) {
  const int kv_heads = a.num_heads / a.group;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kRopeLanes;
  if (r >= (long long)batch * a.seq_len * kv_heads) return;
  const int c = (threadIdx.x % kRopeLanes) * 8;
  const int h = r % kv_heads;
  const long long bt = r / kv_heads;
  const int t = bt % a.seq_len, b = bt / a.seq_len;
  uint4 lo, hi;
  rope_row8<kHalf>(static_cast<const bf16*>(a.k) + b * a.k_sb + (long long)t * a.k_st + h * kHeadDim + c,
            a.rope_cos + (long long)t * kHalf + c, a.rope_sin + (long long)t * kHalf + c, lo, hi);
  bf16* dst = k_rot + r * kHeadDim + c;
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + kHalf) = hi;
}

template <bool kRope, bool kBand>
__global__ void __launch_bounds__(128, kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);   // stage st: K at + 2 st kTile, V after it
  const uint32_t sq = base + 2 * kStages * kTile;
  const uint32_t bars = sq + kTile;
  uint8_t* const q_tile = smem + (sq - smem_u32(smem));
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // this query head's kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  const int kv_start = kv_start_of<kBand>(a, m0, kBlockN);
  const int n_it = (kv_end_of(a, m0) - kv_start + kBlockN - 1) / kBlockN;
  init_barriers(bars, kStages);
  // thread 0 starts kv tile it's K and V copies into stage it % kStages
  auto issue = [&](int it) {
    if (it < n_it && tid == 0) {
      const int st = it % kStages, n0 = kv_start + it * kBlockN;
      const uint32_t s0 = base + 2 * st * kTile, bar = bars + 8 * st;
      mbar_expect(bar, 2 * kTile);
      tma_head<kHeadDim>(s0, &maps.k, bar, hk, n0, b);
      tma_head<kHeadDim>(s0 + kTile, &maps.v, bar, hk, n0, b);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) issue(st);

  // Q, pre-scaled (under rope: rotated at its positions with sm_scale folded
  // into cos and sin) and rounded to bf16, into the swizzled Q tile that
  // S = Q.K^T reads.  Two threads a row, each D / 32 pairs of 16-byte chunks
  // (columns c..c+7 with c+D/2..c+D/2+7, the pairs rope rotates), so the
  // loads are coalesced.  (Q as wgmma's register A operand instead read wrong
  // values from the second kv tile on: PERF.md.)
  {
    const int r = tid >> 1, row = m0 + r;
    const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + (long long)row * a.q_st +
                    h * kHeadDim;
#pragma unroll
    for (int j = 0; j < kHeadDim / 32; ++j) {
      const int c = ((tid & 1) * (kHeadDim / 32) + j) * 8;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (row < a.tq) {
        if constexpr (kRope) {
          const long long p = (long long)(row + a.q_off) * kHalf + c;
          rope_row8<kHalf, true>(Q + c, a.rope_cos + p, a.rope_sin + p, lo, hi, a.sm_scale);
        } else {
          lo = scale_bf16x8(*reinterpret_cast<const uint4*>(Q + c), a.sm_scale);
          hi = scale_bf16x8(*reinterpret_cast<const uint4*>(Q + c + kHalf), a.sm_scale);
        }
      }
      *reinterpret_cast<uint4*>(q_tile + Tile::offset(r, c)) = lo;
      *reinterpret_cast<uint4*>(q_tile + Tile::offset(r, c + kHalf)) = hi;
    }
  }
  // the generic-proxy stores, before wgmma (the async proxy) reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float o[kHeadDim / 8][4];
  zero(o);
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows r0, r1
  float l_a = 0.f, l_b = 0.f;              // this thread's share of the running sums

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, n0 = kv_start + it * kBlockN;
    const uint32_t sk = base + 2 * st * kTile, sv = sk + kTile;
    mbar_wait(bars + 8 * st, (it / kStages) & 1);

    // S = Q K^T for 64 rows x 64 keys
    float s[kBlockN / 8][4];
    wg_fence();
    product_rows<kHeadDim>(s, sq, sk);
    wg_commit();
    // every warp is past tile it - 1's products: refill its stage while
    // this tile's run
    __syncthreads();
    if (it > 0) issue(it + kStages - 1);
    wg_wait<0>();
    fence_acc(s);

    // mask the causal diagonal, the band's lower edge and the ragged end
    const bool edge = (n0 + kBlockN > a.seq_len) ||
                      (a.causal && n0 + kBlockN - 1 > m0 + a.q_off) ||
                      (kBand && n0 <= m0 + kBlockM - 1 + a.q_off - a.window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          const int row = ((i & 2) ? r1 : r0) + a.q_off;
          if (!visible<kBand>(a, col, row)) s[nt][i] = -INFINITY;
        }
      }
    }

    // online softmax, rows r0 (a) and r1 (b); a quad of lanes shares a row.
    // A row that sees no key yet keeps a finite reference: ex2 gives 0.
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float nl_a = (mx_a == -INFINITY) ? 0.f : -mx_a * kLog2e;  // -ref log2 e
    const float nl_b = (mx_b == -INFINITY) ? 0.f : -mx_b * kLog2e;
    const float alpha_a = ex2(fmaf(m_a, kLog2e, nl_a));
    const float alpha_b = ex2(fmaf(m_b, kLog2e, nl_b));
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt) {
      o[nt][0] *= alpha_a;
      o[nt][1] *= alpha_a;
      o[nt][2] *= alpha_b;
      o[nt][3] *= alpha_b;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = ex2(fmaf(s[nt][0], kLog2e, nl_a));
      s[nt][1] = ex2(fmaf(s[nt][1], kLog2e, nl_a));
      s[nt][2] = ex2(fmaf(s[nt][2], kLog2e, nl_b));
      s[nt][3] = ex2(fmaf(s[nt][3], kLog2e, nl_b));
      l_a += s[nt][0] + s[nt][1];
      l_b += s[nt][2] + s[nt][3];
    }

    // O += P V: P rounded to bf16 as register A operands, V read MN-major
    uint32_t pa[kBlockN / 16][4];
    to_a(pa, s);
    fence_acc(o);
    wg_fence();
    product_cols<kHeadDim>(o, pa, sv);
    wg_commit();
    wg_wait<0>();
    fence_acc(o);
  }

  // out through the Q tile (every warp is past its last product), so that
  // the stores to device memory are 16-byte chunks of whole rows
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    const int row = warp * 16 + g, col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(q_tile + Tile::offset(row, col)) =
        pack_f32(o[nt][0] * inv_a, o[nt][1] * inv_a);
    *reinterpret_cast<uint32_t*>(q_tile + Tile::offset(row + 8, col)) =
        pack_f32(o[nt][2] * inv_b, o[nt][3] * inv_b);
  }
  __syncthreads();
  {
    const int r = tid >> 1, row = m0 + r;
    if (row < a.tq) {
      bf16* O = static_cast<bf16*>(a.out) + b * a.o_sb + (long long)row * a.o_st + h * kHeadDim;
#pragma unroll
      for (int j = 0; j < kHeadDim / 16; ++j) {
        const int c = ((tid & 1) * (kHeadDim / 16) + j) * 8;
        *reinterpret_cast<uint4*>(O + c) =
            *reinterpret_cast<const uint4*>(q_tile + Tile::offset(r, c));
      }
    }
  }
  if (t == 0) {
    float* L = a.lse + ((long long)b * a.num_heads + h) * a.tq;
    if (r0 < a.tq) L[r0] = l_a > 0.f ? m_a + logf(l_a) : -INFINITY;
    if (r1 < a.tq) L[r1] = l_b > 0.f ? m_b + logf(l_b) : -INFINITY;
  }
}

// The bf16 instance: under rope the pre-pass into k_rot, then the main
// kernel over tensor maps of k (or k_rot) and v.
template <bool kRope, bool kBand>
cudaError_t launch_wgmma(const Args& a, int batch, void* k_rot, cudaStream_t s) {
  const int kv_heads = a.num_heads / a.group;
  const void* k = a.k;
  long long k_sb = a.k_sb, k_st = a.k_st;
  if (kRope) {
    const long long threads = (long long)kRopeLanes * batch * a.seq_len * kv_heads;
    flash_fwd_rope_k<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
        a, static_cast<bf16*>(k_rot), batch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k = k_rot;
    k_st = (long long)kv_heads * kHeadDim;
    k_sb = a.seq_len * k_st;
  }
  Maps maps = {};
  if (!tile_map<kHeadDim>(&maps.k, k, kv_heads, a.seq_len, batch, k_st, k_sb) ||
      !tile_map<kHeadDim>(&maps.v, a.v, kv_heads, a.seq_len, batch, a.v_st, a.v_sb))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma<kRope, kBand>;
  // the shared-memory limit, set once per device (a call costs host time
  // that short launches notice)
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem());
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const unsigned tiles = (a.tq + kBlockM - 1) / kBlockM;
  kernel<<<dim3(batch * a.num_heads, tiles), 128, fwd_smem(), s>>>(maps, a);
  return cudaGetLastError();
}

template <bool kRope, bool kBand>
cudaError_t launch(int dtype, int batch, void* k_rot, cudaStream_t s, const Args& a) {
  if (dtype == 1) return launch_wgmma<kRope, kBand>(a, batch, k_rot, s);
  const dim3 grid((a.tq + kBlockM - 1) / kBlockM, a.num_heads, batch);
  flash_fwd_fma<float, kRope, kBand><<<grid, kBlockM * kFmaSplit, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (wgmma instance).
// q rows 0..tq-1 sit at absolute positions q_off..q_off+tq-1 and attend keys
// 0..seq_len-1 (causal: key j <= q_off + row, and j > q_off + row - window
// for window > 0); kv_heads must divide num_heads; every head is
// vitrs_flash_fwd_head_dim() wide.  rope_cos/rope_sin: the fp32
// (positions, D/2) rope table covering positions up to
// max(seq_len, q_off + tq) - 1, or both null for no rotation (D < 256
// only).  k_rot: bf16 scratch of batch * seq_len * kv_heads * D elements
// for the rotated k
// when dtype is 1 under rope, else null.  bf16: k and v are read by TMA, so
// their bases and batch and time strides must be 16-byte multiples.
// Launches on `stream` without synchronising; returns the first launch
// error.
extern "C" int vitrs_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                               void* out, float* lse, void* k_rot, long long q_sb,
                               long long q_st, long long k_sb, long long k_st, long long v_sb,
                               long long v_st, long long o_sb, long long o_st, int batch,
                               int num_heads, int kv_heads, int tq, int seq_len, int q_off,
                               int causal, int window, float sm_scale,
                               const float* rope_cos, const float* rope_sin, void* stream) {
  const bool rope = rope_cos != nullptr, band = window > 0;
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || num_heads % kv_heads != 0 || tq <= 0 ||
      seq_len <= 0 || batch <= 0 || window < 0 || (window > 0 && !causal) ||
      (rope != (rope_sin != nullptr)) || ((k_rot != nullptr) != (dtype == 1 && rope)) ||
      (rope && !kRopeOk))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    out,  lse,       q_sb,
         q_st, k_sb, k_st, v_sb, v_st,      o_sb,
         o_st, num_heads, num_heads / kv_heads, tq, seq_len, q_off, causal, window,
         sm_scale, rope_cos, rope_sin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rope and the band are template arguments, so the instances without
  // them carry none of their registers or branches
  cudaError_t err = cudaErrorInvalidValue;
  if (rope) {
    if constexpr (kRopeOk)
      err = band ? launch<true, true>(dtype, batch, k_rot, s, a)
                 : launch<true, false>(dtype, batch, k_rot, s, a);
  } else {
    err = band ? launch<false, true>(dtype, batch, k_rot, s, a)
               : launch<false, false>(dtype, batch, k_rot, s, a);
  }
  return static_cast<int>(err);
}

// the head dim this library was built for
extern "C" int vitrs_flash_fwd_head_dim() { return kHeadDim; }

// Resources of a bf16 kernel as compiled: kernel 0 the rope pre-pass, 1 the
// main kernel (rope, band: its instance); out = {registers per thread,
// local (spill) bytes per thread, static shared bytes, dynamic shared bytes
// per block, threads per block}.
extern "C" int vitrs_flash_fwd_attrs(int kernel, int rope, int band, int* out) {
  const void* fn = nullptr;
  int dyn = 0, threads = 128;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(flash_fwd_rope_k);
    threads = 256;
  } else if (kernel == 1 && rope) {
    if constexpr (kRopeOk)
      fn = band ? reinterpret_cast<const void*>(flash_fwd_wgmma<true, true>)
                : reinterpret_cast<const void*>(flash_fwd_wgmma<true, false>);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    dyn = fwd_smem();
  } else if (kernel == 1) {
    fn = band ? reinterpret_cast<const void*>(flash_fwd_wgmma<false, true>)
              : reinterpret_cast<const void*>(flash_fwd_wgmma<false, false>);
    dyn = fwd_smem();
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
  return 0;
}
