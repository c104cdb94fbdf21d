// K1-fwd, K3-fwd and K4: the flash-attention forward, written for Hopper
// (sm_90a), built once per head dim (-DVITRS_HEAD_DIM, ops/_build.py): D in
// {32, 64, 128, 256}, every multiple of 128 from 384 to 1024, and one build
// at D = 16 that serves every head dim D <= 16 (1, 2, 4, 8, 16: the true D
// arrives at run time and a row is padded to 16 columns), since those five
// would otherwise be five builds of one kernel on the smoke's clock.
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
//     (positions, D/2) cos/sin of ops/rope.py (D <= 128 and even: the JAX
//     kernels have no rope at D >= 256, and the port routes it densely, as
//     the JAX package does on the CPU); the Pallas kernels' 256-lane
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
// The bf16 instance at 32 <= D <= 256, for Hopper (the Hopper pieces are
// in hopper.cuh):
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
// At D >= 384 (flash_fwd_sliced) the O accumulator of all of D would be
// D / 2 floats a thread (192 at 384) and Q plus a 2-stage K/V ring 240 KB at
// 384, past the 227 KB a block may hold.  So a block (a third grid axis)
// writes one 128-column slice of out: it computes the full S = Q.K^T and
// the softmax, Q resident in shared memory and K streamed through a 2-stage
// ring one 64-column atom (8 KB) a stage, S accumulating over the atoms;
// the stage of a kv tile's last atom also brings the slice's 128 columns
// of V (16 KB) for P.V.  Shared memory is 128 D + 49,152 bytes plus 1 KB of
// alignment slack (97 KB at 384, 113 KB at 512, 177 KB at 1024); the O
// accumulator is 64 floats a thread at every D.  Every slice recomputes the
// same S (D / 128 times the S products: 3x at 384, 4x at 512), the design's
// price for a block that fits; all compute the same m and l bit for bit and
// slice 0 writes lse.
// At D <= 16 (flash_fwd_small, the D = 16 build) a row is 2 to 32 bytes,
// below TMA's 16-byte box at D < 8, and wgmma's tiles are at least 16
// columns deep.  So each warp of a 64-row block runs mma.sync m16n8k16 on
// tiles staged with plain loads into zero-filled 16-column shared tiles
// (K rows rotated at their key index as they are staged; V transposed):
// S = Q.K^T is one k-step (the zero columns add nothing, and a cache tail's
// NaN is never loaded), O += P.V one n8 tile at D <= 8 and two at 16, and
// only the D real columns are written.  What bounds it: each (query, key)
// pair costs one exponential on the special function unit against 4 D
// flops, so the exps (16 a clock an SM: about 3.7e12 pairs a second on 132
// SMs at about 1.75 GHz) bound it, not the tensor cores' 989 TFLOP/s,
// which would match that pair rate only at D = 67; the FMA pipes alone (128
// a clock an SM, 16 FMAs a pair at D = 8) could not keep up with the exps
// at D = 8 either, which is why the products stay on the tensor cores.
// The fp32 instance (a cross-check of the bf16 one against the plain
// PyTorch version at fp32 accuracy) does its products with FMA, one thread
// per q row (D / 64 threads at 64 < D <= 256 and 16 beyond, so its q and
// accumulator stay small), kv tiles of 4096 / D rows past D = 128 (K and V
// within 32 KB of static shared memory), and rotates q and k as it stages
// them; at D <= 16 the columns past D are zeros.  Times on the card are in
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
// The D = 16 build serves every head dim D <= 16 (1, 2, 4, 8, 16): its
// kernels read D from Args::head_dim and pad a row to 16 columns.
constexpr bool kSmall = kHeadDim == 16;
// D >= 384: the bf16 forward streams K in 64-column atoms, and each block
// writes one kSlice-column slice of out.
constexpr bool kSliced = kHeadDim >= 384;
static_assert(kSmall || kHeadDim == 32 || kHeadDim == 64 || kHeadDim == 128 ||
                  kHeadDim == 256 || (kHeadDim % 128 == 0 && kHeadDim <= 1024),
              "head dims 16 (serving D <= 16), 32, 64, 128, 256 and multiples of 128 to 1024");
constexpr int kHalf = kHeadDim / 2;  // rope pairs dim c with dim c + kHalf (D >= 32)
constexpr bool kRopeOk = kHeadDim <= 128;  // rope instances exist at D <= 128
constexpr int kBlockM = 64;    // q rows per thread block
constexpr int kBlockN = 64;    // kv rows per shared-memory tile (tensor-core paths)
// FMA path: kv rows per staged tile (its K and V stay within 32 KB of
// static shared memory), and threads per q row, each owning kFmaPart columns
constexpr int kFmaBlockN = kHeadDim <= 128 ? 32 : 4096 / kHeadDim;
constexpr int kFmaSplit = kHeadDim <= 64 ? 1 : (kHeadDim <= 256 ? kHeadDim / 64 : 16);
constexpr int kFmaPart = kHeadDim / kFmaSplit;

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
  const float* rope_cos;  // (positions, D/2) fp32, or nullptr: no rope
  const float* rope_sin;
  int head_dim;  // D: kHeadDim, or at most 16 in the D = 16 build
};

// the call's head dim: a constant except in the D = 16 build
__device__ __forceinline__ int head_dim_of(const Args& a) {
  return kSmall ? a.head_dim : kHeadDim;
}

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
// FMA instance: one thread per q row (kFmaSplit threads at D > 64), kv tiles
// of kFmaBlockN rows in smem; columns past the call's head dim are zeros.
// ---------------------------------------------------------------------------
template <typename T, bool kRope, bool kBand>
__global__ void __launch_bounds__(kBlockM * kFmaSplit) flash_fwd_fma(Args a) {
  __shared__ float ks[kFmaBlockN][kHeadDim];
  __shared__ float vs[kFmaBlockN][kHeadDim];
  const int hd = head_dim_of(a), half = hd / 2;
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int row = m0 + threadIdx.x / kFmaSplit;
  const int part = threadIdx.x % kFmaSplit, c0 = part * kFmaPart;  // this thread's columns
  const bool live = row < a.tq;
  const int q_pos = row + a.q_off;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)row * a.q_st + h * hd;
  const int hk = h / a.group;  // this query head's kv head
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * hd;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * hd;

  // q, pre-scaled (under rope rotated at q_pos with sm_scale folded into
  // cos and sin), rounded
  float q[kFmaPart], acc[kFmaPart];
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) {
    const int c = c0 + d;
    float x = 0.f;
    if (live && c < hd) {
      if constexpr (kRope) {
        const long long p = (long long)q_pos * half;
        x = rope_elem<true>(qp, c, half, a.rope_cos + p, a.rope_sin + p, a.sm_scale);
      } else {
        x = to_f(qp[c]) * a.sm_scale;
      }
    }
    q[d] = to_f(from_f<T>(x));
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of<kBand>(a, m0, kFmaBlockN); n0 < kv_end; n0 += kFmaBlockN) {
    __syncthreads();
    // k (rotated at its key index under rope, rounded) and v
    for (int i = threadIdx.x; i < kFmaBlockN * kHeadDim; i += blockDim.x) {
      const int r = i / kHeadDim, c = i % kHeadDim, j = n0 + r;
      float kx = 0.f, vx = 0.f;
      if (j < a.seq_len && c < hd) {
        const T* kr = kp + (long long)j * a.k_st;
        if constexpr (kRope) {
          const long long p = (long long)j * half;
          kx = to_f(from_f<T>(rope_elem<false>(kr, c, half, a.rope_cos + p, a.rope_sin + p)));
        } else {
          kx = to_f(kr[c]);
        }
        vx = to_f(vp[(long long)j * a.v_st + c]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
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
  T* op = static_cast<T*>(a.out) + b * a.o_sb + (long long)row * a.o_st + h * hd + c0;
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d)
    if (c0 + d < hd) op[d] = from_f<T>(acc[d] * inv);
  if (part == 0)
    a.lse[((long long)b * a.num_heads + h) * a.tq + row] = l > 0.f ? m + logf(l) : -INFINITY;
}

// One online-softmax step of the tensor-core instances over a tile of 64
// keys at n0: s holds this thread's scores of rows r0 and r0 + 8, columns
// n0 + 8 nt + 2t + e (the accumulator layout of wgmma m64n64 and of
// mma.sync m16n8 over 8 column tiles).  Masks the causal diagonal, the
// band's lower edge and the ragged end, updates the running max m and this
// thread's share of the running sum l of both rows, rescales the output
// accumulator o, and turns s into p (ex2.approx).  A row that sees no key
// yet keeps a finite reference: ex2 gives 0.
template <bool kBand, int N8>
__device__ __forceinline__ void softmax_step(const Args& a, float (&s)[kBlockN / 8][4],
                                             float (&o)[N8][4], float (&m)[2], float (&l)[2],
                                             int m0, int n0, int r0, int t) {
  const int r1 = r0 + 8;
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
  // a quad of lanes shares a row
  float mx_a = m[0], mx_b = m[1];
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
    mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  const float nl_a = (mx_a == -INFINITY) ? 0.f : -mx_a * kLog2e;  // -ref log2 e
  const float nl_b = (mx_b == -INFINITY) ? 0.f : -mx_b * kLog2e;
  const float alpha_a = ex2(fmaf(m[0], kLog2e, nl_a));
  const float alpha_b = ex2(fmaf(m[1], kLog2e, nl_b));
  m[0] = mx_a;
  m[1] = mx_b;
  l[0] *= alpha_a;
  l[1] *= alpha_b;
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
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
    l[0] += s[nt][0] + s[nt][1];
    l[1] += s[nt][2] + s[nt][3];
  }
}

// The end of the online softmax: l, this thread's share of the running
// sums of rows r0 and r0 + 8, summed over the quad; returns 1 / l (0 for a
// row that saw no key)
__device__ __forceinline__ void finish_rows(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
}

// lse = m + ln l of rows r0 and r0 + 8 (after finish_rows), or -inf for a
// row that saw no key, compact at (B, NH, tq); lane t == 0 of each quad
__device__ __forceinline__ void store_lse(const Args& a, const float (&m)[2], const float (&l)[2],
                                          int b, int h, int r0, int t) {
  if (t != 0) return;
  float* L = a.lse + ((long long)b * a.num_heads + h) * a.tq;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (r0 + 8 * i < a.tq) L[r0 + 8 * i] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
}

#if VITRS_HEAD_DIM == 16
// ---------------------------------------------------------------------------
// bf16 instance at D <= 16: mma.sync m16n8k16 on tiles staged with plain
// loads (a row of 2 to 32 bytes is below TMA's 16-byte box), zero-padded to
// 16 columns so S = Q.K^T is one k-step and O += P.V one or two n8 tiles.
// ---------------------------------------------------------------------------
constexpr int kRow = 24;    // bf16 a row of a staged 16-column tile (48 bytes:
                            // a warp's fragment reads hit 32 distinct banks)
constexpr int kVRow = 72;   // bf16 a row of the transposed V tile (64 keys + 8)

template <bool kRope, bool kBand>
__global__ void __launch_bounds__(128) flash_fwd_small(Args a) {
  __shared__ __align__(16) bf16 qs[kBlockM][kRow];
  __shared__ __align__(16) bf16 ks[kBlockN][kRow];
  __shared__ __align__(16) bf16 vt[16][kVRow];
  const int hd = a.head_dim, half = hd / 2;
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // this query head's kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * hd;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * hd;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * hd;

  // q, pre-scaled (under rope rotated at its position with sm_scale folded
  // into cos and sin) and rounded; zeros past hd and tq
  for (int i = tid; i < kBlockM * 16; i += 128) {
    const int r = i >> 4, c = i & 15, row = m0 + r;
    float x = 0.f;
    if (row < a.tq && c < hd) {
      const bf16* qr = Q + (long long)row * a.q_st;
      if constexpr (kRope) {
        const long long p = (long long)(row + a.q_off) * half;
        x = rope_elem<true>(qr, c, half, a.rope_cos + p, a.rope_sin + p, a.sm_scale);
      } else {
        x = to_f(qr[c]) * a.sm_scale;
      }
    }
    qs[r][c] = __float2bfloat16_rn(x);
  }
  __syncthreads();
  uint32_t qa[4];   // this warp's 16 rows as mma.sync's A fragment
  {
    const int r = warp * 16 + g;
    qa[0] = *reinterpret_cast<const uint32_t*>(&qs[r][2 * t]);
    qa[1] = *reinterpret_cast<const uint32_t*>(&qs[r + 8][2 * t]);
    qa[2] = *reinterpret_cast<const uint32_t*>(&qs[r][2 * t + 8]);
    qa[3] = *reinterpret_cast<const uint32_t*>(&qs[r + 8][2 * t + 8]);
  }
  float o[2][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of<kBand>(a, m0, kBlockN); n0 < kv_end; n0 += kBlockN) {
    __syncthreads();   // every warp is past the last tile's reads
    // k (rotated at its key index under rope) into rows, v transposed
    for (int i = tid; i < kBlockN * 16; i += 128) {
      const int r = i >> 4, c = i & 15, j = n0 + r;
      float kx = 0.f, vx = 0.f;
      if (j < a.seq_len && c < hd) {
        const bf16* kr = K + (long long)j * a.k_st;
        if constexpr (kRope) {
          const long long p = (long long)j * half;
          kx = rope_elem<false>(kr, c, half, a.rope_cos + p, a.rope_sin + p);
        } else {
          kx = to_f(kr[c]);
        }
        vx = to_f(V[(long long)j * a.v_st + c]);
      }
      ks[r][c] = __float2bfloat16_rn(kx);
      vt[c][r] = __float2bfloat16_rn(vx);
    }
    __syncthreads();
    // S = Q K^T: 16 rows x 64 keys a warp, one k-step
    float s[kBlockN / 8][4];
    zero(s);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const bf16* kr = ks[nt * 8 + g];
      mma_bf16(s[nt], qa, *reinterpret_cast<const uint32_t*>(kr + 2 * t),
               *reinterpret_cast<const uint32_t*>(kr + 2 * t + 8));
    }
    softmax_step<kBand>(a, s, o, m, l, m0, n0, r0, t);
    // O += P V: P rounded to bf16 as A fragments, 4 k-steps of 16 keys
    uint32_t pa[kBlockN / 16][4];
    to_a(pa, s);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const bf16* v0 = vt[g] + 16 * kk + 2 * t;
      mma_bf16(o[0], pa[kk], *reinterpret_cast<const uint32_t*>(v0),
               *reinterpret_cast<const uint32_t*>(v0 + 8));
      if (hd > 8) {   // columns 8..15
        const bf16* v1 = v0 + 8 * kVRow;
        mma_bf16(o[1], pa[kk], *reinterpret_cast<const uint32_t*>(v1),
                 *reinterpret_cast<const uint32_t*>(v1 + 8));
      }
    }
  }
  float inv[2];
  finish_rows(l, inv);
  bf16* O = static_cast<bf16*>(a.out) + b * a.o_sb + h * hd;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * (i & 2), col = 8 * j + 2 * t + (i & 1);
      if (row < a.tq && col < hd)
        O[(long long)row * a.o_st + col] = __float2bfloat16_rn(o[j][i] * inv[i >> 1]);
    }
  store_lse(a, m, l, b, h, r0, t);
}

template <bool kRope, bool kBand>
cudaError_t launch_bf16(const Args& a, int batch, void* k_rot, cudaStream_t s) {
  const unsigned tiles = (a.tq + kBlockM - 1) / kBlockM;
  flash_fwd_small<kRope, kBand><<<dim3(batch * a.num_heads, tiles), 128, 0, s>>>(a);
  return cudaGetLastError();
}

#else
// ---------------------------------------------------------------------------
// bf16 instance: wgmma on K/V tiles staged by TMA in a ring (hopper.cuh).
// ---------------------------------------------------------------------------

constexpr int kStages = 2;      // depth of the K/V ring
using Tile = HeadTile<kHeadDim>;
using Atom = HeadTile<64>;      // one 64-column atom of a tile
constexpr int kTile = Tile::kBytes;  // bytes of one bf16 tile in smem (64 rows of D)
// the output columns of a block: all of D, or a slice at D >= 384
constexpr int kSlice = kSliced ? 128 : kHeadDim;
constexpr int kAtoms = kHeadDim < 64 ? 1 : kHeadDim / 64;
// a stage of the ring: a K tile and a V tile, or (sliced) one 64-column
// atom of K and the kSlice columns of V that the block's slice reads
constexpr int kStageBytes = kSliced ? Atom::kBytes + 64 * kSlice * 2 : 2 * kTile;
// blocks an SM the registers are budgeted for: the O accumulator is kSlice
// / 2 floats a thread, and the shared memory below allows 2 blocks at D = 128
constexpr int kMinBlocks = kHeadDim <= 64 ? 5 : (kHeadDim == 128 ? 2 : 1);
constexpr int kRopeLanes = kHalf / 8;   // threads a row of the rope pre-pass

// Dynamic shared memory: the stages of the ring, then the Q tile, then
// one mbarrier per stage; 1 KB of slack for the 1024-byte alignment of
// the swizzle.
__host__ __device__ constexpr int fwd_smem() {
  return 1024 + kStages * kStageBytes + kTile + kStages * 8;
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
  if constexpr (kRopeOk) {
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
}

// Q, pre-scaled (under rope: rotated at its positions with sm_scale folded
// into cos and sin) and rounded to bf16, into the swizzled Q tile that
// S = Q.K^T reads.  Two threads a row, each D / 32 pairs of 16-byte chunks
// (columns c..c+7 with c+D/2..c+D/2+7, the pairs rope rotates), so the
// loads are coalesced.  (Q as wgmma's register A operand instead read wrong
// values from the second kv tile on: PERF.md.)
template <bool kRope>
__device__ __forceinline__ void stage_q(const Args& a, uint8_t* q_tile, int b, int h, int m0) {
  const int tid = threadIdx.x, r = tid >> 1, row = m0 + r;
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
  // the generic-proxy stores, before wgmma (the async proxy) reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// out (columns c0 .. c0 + kSlice - 1 of head h), lse (with `write_lse`):
// the accumulators times 1 / l go through the Q tile (every warp is past
// its last product), so that the stores to device memory are 16-byte
// chunks of whole rows
__device__ __forceinline__ void store_out(const Args& a, uint8_t* q_tile,
                                          float (&o)[kSlice / 8][4], float (&m)[2],
                                          float (&l)[2], int b, int h, int m0, int c0,
                                          bool write_lse) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float inv[2];
  finish_rows(l, inv);
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < kSlice / 8; ++nt) {
    const int row = warp * 16 + g, col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(q_tile + Tile::offset(row, col)) =
        pack_f32(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_tile + Tile::offset(row + 8, col)) =
        pack_f32(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
  __syncthreads();
  const int r = tid >> 1, row = m0 + r;
  if (row < a.tq) {
    bf16* O = static_cast<bf16*>(a.out) + b * a.o_sb + (long long)row * a.o_st + h * kHeadDim + c0;
#pragma unroll
    for (int j = 0; j < kSlice / 16; ++j) {
      const int c = ((tid & 1) * (kSlice / 16) + j) * 8;
      *reinterpret_cast<uint4*>(O + c) = *reinterpret_cast<const uint4*>(q_tile + Tile::offset(r, c));
    }
  }
  if (write_lse) store_lse(a, m, l, b, h, m0 + warp * 16 + g, t);
}

template <bool kRope, bool kBand>
__global__ void __launch_bounds__(128, kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);   // stage st: K at + 2 st kTile, V after it
  const uint32_t sq = base + kStages * kStageBytes;
  const uint32_t bars = sq + kTile;
  uint8_t* const q_tile = smem + (sq - smem_u32(smem));
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // this query head's kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const int kv_start = kv_start_of<kBand>(a, m0, kBlockN);
  const int n_it = (kv_end_of(a, m0) - kv_start + kBlockN - 1) / kBlockN;
  init_barriers(bars, kStages);
  // thread 0 starts kv tile it's K and V copies into stage it % kStages
  auto issue = [&](int it) {
    if (it < n_it && tid == 0) {
      const int st = it % kStages, n0 = kv_start + it * kBlockN;
      const uint32_t s0 = base + st * kStageBytes, bar = bars + 8 * st;
      mbar_expect(bar, 2 * kTile);
      tma_head<kHeadDim>(s0, &maps.k, bar, hk, n0, b);
      tma_head<kHeadDim>(s0 + kTile, &maps.v, bar, hk, n0, b);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) issue(st);
  stage_q<kRope>(a, q_tile, b, h, m0);

  float o[kSlice / 8][4];   // kSlice = kHeadDim: this kernel runs at D <= 256
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows r0, r0 + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, n0 = kv_start + it * kBlockN;
    const uint32_t sk = base + st * kStageBytes, sv = sk + kTile;
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

    softmax_step<kBand>(a, s, o, m, l, m0, n0, r0, t);

    // O += P V: P rounded to bf16 as register A operands, V read MN-major
    uint32_t pa[kBlockN / 16][4];
    to_a(pa, s);
    fence_acc(o);
    wg_fence();
    product_cols<kSlice>(o, pa, sv);
    wg_commit();
    wg_wait<0>();
    fence_acc(o);
  }
  store_out(a, q_tile, o, m, l, b, h, m0, 0, true);
}

// D >= 384, where the O accumulator of all of D would be D / 2 floats a
// thread and a K/V tile pair 2 x 64 x D x 2 bytes: a block (blockIdx.z =
// slice) computes the full S = Q.K^T and the softmax, and O for kSlice
// columns of D only.  Q stays in shared memory; K streams through the ring
// one 64-column atom a stage (S accumulates over the atoms), and the
// stage of a kv tile's last atom also brings the slice's kSlice columns of
// V for P.V.  Every slice computes the same S, m and l bit for bit; slice
// 0 writes lse.
template <bool kBand>
__global__ void __launch_bounds__(128, 1)
    flash_fwd_sliced(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);   // stage st at + st kStageBytes
  const uint32_t sq = base + kStages * kStageBytes;
  const uint32_t bars = sq + kTile;
  uint8_t* const q_tile = smem + (sq - smem_u32(smem));
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // this query head's kv head
  const int slice = blockIdx.z;
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;

  const int kv_start = kv_start_of<kBand>(a, m0, kBlockN);
  const int n_it = (kv_end_of(a, m0) - kv_start + kBlockN - 1) / kBlockN * kAtoms;
  init_barriers(bars, kStages);
  // iteration it: kv tile it / kAtoms, K atom it % kAtoms, in stage it % kStages
  auto issue = [&](int it) {
    if (it < n_it && tid == 0) {
      const int st = it % kStages, at = it % kAtoms, n0 = kv_start + it / kAtoms * kBlockN;
      const uint32_t s0 = base + st * kStageBytes, bar = bars + 8 * st;
      const bool last = at == kAtoms - 1;
      mbar_expect(bar, last ? kStageBytes : Atom::kBytes);
      tma_tile(s0, &maps.k, bar, hk * kAtoms + at, n0, b);
      if (last) {
#pragma unroll
        for (int v = 0; v < kSlice / 64; ++v)
          tma_tile(s0 + (1 + v) * Atom::kBytes, &maps.v, bar,
                   hk * kAtoms + slice * (kSlice / 64) + v, n0, b);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) issue(st);
  stage_q<false>(a, q_tile, b, h, m0);

  float o[kSlice / 8][4];
  zero(o);
  float s[kBlockN / 8][4];
  zero(s);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, at = it % kAtoms, n0 = kv_start + it / kAtoms * kBlockN;
    const uint32_t sk = base + st * kStageBytes;
    mbar_wait(bars + 8 * st, (it / kStages) & 1);

    // S (+)= Q[:, atom] K[:, atom]^T, 4 k-steps (the first of a tile overwrites)
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, Atom::desc(sq + at * Atom::kBytes + Atom::kstep(kk)),
               Atom::desc(sk + Atom::kstep(kk)), at > 0 || kk > 0);
    wg_commit();
    // every warp is past iteration it - 1's products: refill its stage
    __syncthreads();
    if (it > 0) issue(it + kStages - 1);
    wg_wait<0>();
    fence_acc(s);
    if (at != kAtoms - 1) continue;

    softmax_step<kBand>(a, s, o, m, l, m0, n0, r0, t);
    uint32_t pa[kBlockN / 16][4];
    to_a(pa, s);
    fence_acc(o);
    wg_fence();
    product_cols<kSlice>(o, pa, sk + Atom::kBytes);
    wg_commit();
    wg_wait<0>();
    fence_acc(o);
  }
  store_out(a, q_tile, o, m, l, b, h, m0, slice * kSlice, slice == 0);
}

// this head dim's main bf16 kernel
template <bool kRope, bool kBand>
auto main_kernel() {
  if constexpr (kSliced)
    return flash_fwd_sliced<kBand>;
  else
    return flash_fwd_wgmma<kRope, kBand>;
}

// The bf16 instance: under rope the pre-pass into k_rot, then the main
// kernel over tensor maps of k (or k_rot) and v.
template <bool kRope, bool kBand>
cudaError_t launch_bf16(const Args& a, int batch, void* k_rot, cudaStream_t s) {
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
  auto kernel = main_kernel<kRope, kBand>();
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
  kernel<<<dim3(batch * a.num_heads, tiles, kHeadDim / kSlice), 128, fwd_smem(), s>>>(maps, a);
  return cudaGetLastError();
}
#endif

template <bool kRope, bool kBand>
cudaError_t launch(int dtype, int batch, void* k_rot, cudaStream_t s, const Args& a) {
  if (dtype == 1) return launch_bf16<kRope, kBand>(a, batch, k_rot, s);
  const dim3 grid((a.tq + kBlockM - 1) / kBlockM, a.num_heads, batch);
  flash_fwd_fma<float, kRope, kBand><<<grid, kBlockM * kFmaSplit, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (tensor-core instance).
// q rows 0..tq-1 sit at absolute positions q_off..q_off+tq-1 and attend keys
// 0..seq_len-1 (causal: key j <= q_off + row, and j > q_off + row - window
// for window > 0); kv_heads must divide num_heads; every head is head_dim
// wide: vitrs_flash_fwd_head_dim(), or in its D = 16 build any power of two
// up to 16.  rope_cos/rope_sin: the fp32 (positions, head_dim/2) rope table
// covering positions up to max(seq_len, q_off + tq) - 1, or both null for no
// rotation (head_dim <= 128 and even only).  k_rot: bf16 scratch of batch *
// seq_len * kv_heads * head_dim elements for the rotated k when dtype is 1
// under rope at head_dim >= 32, else null.  bf16 at head_dim >= 32: k and v
// are read by TMA, so their bases and batch and time strides must be
// 16-byte multiples.  Launches on `stream` without synchronising; returns
// the first launch error.
extern "C" int vitrs_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                               void* out, float* lse, void* k_rot, long long q_sb,
                               long long q_st, long long k_sb, long long k_st, long long v_sb,
                               long long v_st, long long o_sb, long long o_st, int batch,
                               int num_heads, int kv_heads, int head_dim, int tq, int seq_len,
                               int q_off, int causal, int window, float sm_scale,
                               const float* rope_cos, const float* rope_sin, void* stream) {
  const bool rope = rope_cos != nullptr, band = window > 0;
  const bool dim_ok = kSmall ? (head_dim >= 1 && head_dim <= 16 && (head_dim & (head_dim - 1)) == 0)
                             : head_dim == kHeadDim;
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || num_heads % kv_heads != 0 || tq <= 0 ||
      seq_len <= 0 || batch <= 0 || window < 0 || (window > 0 && !causal) ||
      (rope != (rope_sin != nullptr)) ||
      ((k_rot != nullptr) != (dtype == 1 && rope && !kSmall)) || !dim_ok ||
      (rope && (!kRopeOk || head_dim % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.o_sb = o_sb;
  a.o_st = o_st;
  a.num_heads = num_heads;
  a.group = num_heads / kv_heads;
  a.tq = tq;
  a.seq_len = seq_len;
  a.q_off = q_off;
  a.causal = causal;
  a.window = window;
  a.sm_scale = sm_scale;
  a.rope_cos = rope_cos;
  a.rope_sin = rope_sin;
  a.head_dim = head_dim;
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

// the head dim this library was built for (16: every head dim up to 16)
extern "C" int vitrs_flash_fwd_head_dim() { return kHeadDim; }

// Resources of a bf16 kernel as compiled: kernel 0 the rope pre-pass (none
// at D <= 16, which rotates k as it stages it), 1 the main kernel (rope,
// band: its instance); out = {registers per thread, local (spill) bytes per
// thread, static shared bytes, dynamic shared bytes per block, threads per
// block}.
extern "C" int vitrs_flash_fwd_attrs(int kernel, int rope, int band, int* out) {
  const void* fn = nullptr;
  int dyn = 0, threads = 128;
  if ((rope && !kRopeOk) || kernel < 0 || kernel > 1 || (kernel == 0 && kSmall))
    return static_cast<int>(cudaErrorInvalidValue);
#if VITRS_HEAD_DIM == 16
  if (rope)
    fn = band ? reinterpret_cast<const void*>(flash_fwd_small<true, true>)
              : reinterpret_cast<const void*>(flash_fwd_small<true, false>);
  else
    fn = band ? reinterpret_cast<const void*>(flash_fwd_small<false, true>)
              : reinterpret_cast<const void*>(flash_fwd_small<false, false>);
#else
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(flash_fwd_rope_k);
    threads = 256;
  } else {
    if (rope) {
      if constexpr (kRopeOk)
        fn = band ? reinterpret_cast<const void*>(main_kernel<true, true>())
                  : reinterpret_cast<const void*>(main_kernel<true, false>());
    } else {
      fn = band ? reinterpret_cast<const void*>(main_kernel<false, true>())
                : reinterpret_cast<const void*>(main_kernel<false, false>());
    }
    dyn = fwd_smem();
  }
#endif
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
