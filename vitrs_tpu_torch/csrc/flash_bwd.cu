// K2 and K3-bwd: the flash-attention backward, written for Hopper (sm_90a),
// built once per head dim (-DVITRS_HEAD_DIM, ops/_build.py): D in {32, 64,
// 128, 256}, every multiple of 128 from 384 to 1024, and one build at D =
// 16 that serves every head dim D <= 16 (the true D arrives at run time;
// rows are padded to 16 columns), as flash_fwd.cu.
//
// Replaces the Pallas backward kernels, one function at two geometries:
//   K2      vitrs_tpu/ops/flash_attention.py  _bwd_single_kernel (one tile;
//           launched by _bwd_single), _bwd_combined_kernel, _bwd_dkv_kernel
//           and _bwd_dq_kernel (multi-tile; launched by _bwd_parts): MHA;
//   K3-bwd  vitrs_tpu/ops/flash_attention_gqa.py  _bwd_single and
//           _bwd_parts (the same tile kernels at GQA geometry): k/v, dk and
//           dv at kv_dim = kv_heads * D width, dk/dv summed over each kv
//           head's group of R = num_heads / kv_heads query heads in the
//           kernel.
// It computes what they compute from the forward's out and compact lse,
// recomputing the probabilities instead of storing them, with the numerics of
// the multi-tile bodies (_bwd_body):
//   s = q^ . k^T in fp32, q^ = q * sm_scale rounded to the input type;
//   p  = exp(s - lse), 0 where masked;  di = rowsum(o * do) in fp32;
//   ds = p * (do . v^T - di) * sm_scale;
//   dv += p(rounded)^T . do;  dk += ds(rounded)^T . q (unscaled q);
//   dq += ds(rounded) . k;  dq, dk, dv written in the input type.
// When sm_scale is a power of two (1/8 at D = 64, 1/16 at D = 256), q * sm_scale is exact in
// bf16, so q^ . k^T equals sm_scale * (q . k^T) bit for bit: the bf16
// kernels then read q itself and scale s in fp32, and q^ is never formed.
// Sliding window (window > 0, causal only): p is 0 outside the band
// (i - window, i]; the dK/dV kernel's q loop ends at the last q tile whose
// band reaches its kv tile, the dQ kernel's kv loop starts at the first
// tile its band reaches, as the Pallas kernels skip tiles with
// _tile_overlaps_band.  Rope (rope_cos != nullptr): q and k are rotated
// by the fp32 table and rounded to the input type before any product, and
// dq (scaled) and dk are rotated back by -theta in fp32 just before they are
// stored, as the Pallas epilogues do (flash_attention.py l.892-893,
// 968-980); under GQA the dK/dV block sums its group's query heads first
// and rotates the sum once (the rotation is linear, so that is exact).
// The block may be a rectangle: tq query rows at positions q_off .. q_off +
// tq - 1 against tk keys at 0 .. tk - 1, with q_off past the keys' end
// allowed (the ring's past block that the band cuts,
// parallel/ring_attention.py: 1023 rows at q_off 1023 against 1023 keys on
// the 8K window), neither length nor q_off a multiple of 64.  q, o, dout,
// lse, di and dq live in the query-row space, k, v, dk and dv in the
// key-row space; visibility compares key j with position q_off + i.  The
// dK/dV kernel's q loop starts at the q tile holding the first row whose
// position reaches its kv tile (max(0, n0 - q_off) floored to 64), the dQ
// kernel's kv loop ends at min(tk, q_off + m0 + 64); every bound is formed
// once a block, so at q_off = 0, tq = tk the loops are those of the square
// block.  A row that sees no key gets zero gradients; keys past the causal
// frontier get zero dk and dv.  Rope takes the square block only, at an
// even D <= 128 (the JAX kernels have no rope at D >= 256; the port routes
// it densely).
// TPU-shaped choices are not carried over: no 128-lane head groups, no
// (B, H, T, 128) lane-broadcast lse, no padded T, no VMEM admission estimate
// choosing between a combined and a split kernel, no phantom kv lanes.
//
// Three launches, FlashAttention-2's split, with no atomics, so dq, dk and
// dv are the same bits from run to run whatever order the blocks run in:
//   1. pre-pass   di = rowsum(o * do), eight threads (16 bytes each) to a
//                 row.  bf16 under rope, it also writes q and k rotated and
//                 rounded into scratch (B, T, C) and (B, T, kv_dim), so the
//                 main loops read plain tiles (about 50 MB at B=2, T=8192);
//                 when sm_scale is not a power of two, also q^ (B, T, C).
//   2. dK/dV      one block per (kv tile of 64 rows, kv head, batch); a loop
//                 over the R query heads of the group and, inside it, over
//                 the q tiles that see the tile (in causal mode from the
//                 diagonal down) accumulates dk and dv in registers, so they
//                 leave summed over the group, at kv width.  At D <= 64 the
//                 block is one warpgroup; at D >= 128, where dk and dv alone
//                 would take D floats a thread, two warpgroups: each owns
//                 half of D's columns of dk and dv, computes S^T and dP^T
//                 for half of the tile's q rows, and hands P^T and dS^T to
//                 the other through two bf16 tiles in shared memory
//                 (FlashAttention-3's split at head dim 256);
//   3. dQ         one block (a warpgroup) per (q tile of 64 rows, query
//                 head, batch); a loop over the kv tiles (of kv head h / R)
//                 up to the diagonal accumulates dq.  Causal q tiles launch
//                 heaviest first.  (Blocks of several warpgroups, the query
//                 heads of one kv head sharing each staged K/V tile, ran
//                 slower at every GQA shape measured: registers then allow
//                 one block an SM against four, and the L2 serves the
//                 re-reads.)
// Splitting dq from dk/dv recomputes S and dP (7 tile products per pair
// against 5) but needs no atomics.  The ragged ends are masked against tq
// and tk (tiles past them are zero-filled as they are copied).
//
// The Hopper building blocks (TMA tiles, mbarriers, wgmma descriptors and
// products, ex2) are in hopper.cuh, shared with the forward.
//
// What bounds it on the H100: at T = 1024, D = 64 the five products (2.5x
// the forward's) make it compute-bound (bound 0.033 ms at B=8, NH=12, 32
// GFLOP), but the tensor cores only get there when copies overlap them and
// operands reach them without passing through registers.  So the bf16
// instance:
//   * runs every product on wgmma (m64n64k16, fp32 accumulate): S^T = K.q^T
//     and dP^T = V.do^T (dK/dV), S = q.K^T and dP = do.V^T (dQ) with both
//     operands read K-major from shared memory; dV += P^T.do, dK += dS^T.q
//     and dQ += dS.K with P^T, dS^T or dS turned from the accumulators into
//     register A operands and B read MN-major from the same tiles;
//   * stages tiles in rings in dynamic shared memory (3 deep in dK/dV, 2 in
//     dQ, whose smaller footprint then fits four blocks an SM): one thread
//     starts each tile's copy with TMA (cp.async.bulk.tensor through a 4-D
//     tensor map, completion on the stage's mbarrier, rows past tq or tk
//     read as zeros), so the next tiles are in flight while tile m's
//     products run and no other thread spends instructions on the copies;
//     lse and di rows take 4-byte cp.async.  Tiles use the 128-byte swizzle
//     that both TMA writes and wgmma reads, no padding;
//   * computes p = 2^(s * sm_scale * log2 e - lse * log2 e) with ex2.approx;
//     an interior tile (inside the band and the causal frontier) skips the
//     mask.
// Measured on an H100 (PERF.md): 180-320 TFLOP/s on the five-product count,
// 19-33% of the bound.  What holds dK/dV back now is the chain inside each
// q tile (S^T -> p -> dV, dP^T -> dS -> dK, then a wait) and its 179
// registers, two blocks an SM: utils/bwd_variants.py's ablations put a
// third of its time on the dK product's tail.
// At D = 128 and 256 the products run over D / 16 k-steps and their dV, dK,
// dQ sides on one m64n64k16 a 64-column atom (m64n32k16 at D = 32); the
// dK/dV ring is 3 deep (2 at D = 256: K, V and two stages of q and do are
// 192 KB), and D = 256 takes a power-of-two sm_scale only (its q^ tiles
// would not fit; the model's 1/16 is one).
// At D >= 384 (flash_bwd_dkv_sliced, flash_bwd_dq_sliced) dk and dv of 64
// kv rows would be 2 D floats a thread even split over two warpgroups, and
// K, V, q and do tiles 4 x 64 x D x 2 bytes (192 KB at 384): a block (a
// third grid axis) accumulates one 64-column slice of dk and dv, or of dq,
// in registers (as the D = 64 kernels do), and recomputes S^T and dP^T (S
// and dP) over the full D, streamed through a 2-stage ring one 64-column
// atom of each operand a stage; the stage of a tile's last atom also
// brings the slice's columns of do and q (dK/dV) or K (dQ) for the
// products into the slice.  Shared memory does not grow with D (98 KB for
// dK/dV, 81 KB for dQ: two blocks an SM); the price is D / 64 times the S
// and dP products (6x at 384, 8x at 512), a simple design that is right
// first.  No rope there (the JAX kernels assert on it); q^ is formed by the
// pre-pass as at D < 256.
// At D <= 16 (flash_bwd_dkv_small, flash_bwd_dq_small) each warp of a
// 64-row block runs mma.sync m16n8k16 on tiles staged with plain loads into
// zero-filled 16-column shared tiles (rows, or transposed where a product
// reads them as its B operand): S^T, dP^T, S and dP are one k-step; q and k
// are rotated (rope) and q^ formed as they are staged, so the pre-pass only
// computes di (one thread a row).  Bounded, as the forward, by the
// exponentials (one a (query, key) pair, in each of the two kernels).
// The fp32 instance (a cross-check against the plain PyTorch version at fp32
// accuracy) uses FMA with 2 (D <= 64), D / 32 (D <= 256) or 16 threads per
// row, one at D <= 16, each owning a slice of D, and rotates q and k itself
// as it stages them.

#include <cuda_runtime.h>
#include <math.h>

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
// D >= 384: dK/dV and dQ blocks of one 64-column slice, S and dP streamed
// over D in atoms
constexpr bool kSliced = kHeadDim >= 384;
static_assert(kSmall || kHeadDim == 32 || kHeadDim == 64 || kHeadDim == 128 ||
                  kHeadDim == 256 || (kHeadDim % 128 == 0 && kHeadDim <= 1024),
              "head dims 16 (serving D <= 16), 32, 64, 128, 256 and multiples of 128 to 1024");
constexpr int kBlock = 64;      // rows per q or kv tile
constexpr int kHalf = kHeadDim / 2;  // also rope's pairing: dim c with c + kHalf
constexpr bool kRopeOk = kHeadDim <= 128;  // rope instances exist at D <= 128
constexpr bool kQhatOk = kHeadDim != 256;  // q^ instances (sm_scale not a power of two)
// FMA path: threads per row, each owning kFmaPart columns; rows per staged
// tile (its three tiles stay within 24 KB of static shared memory)
constexpr int kFmaSplit = kSmall ? 1 : (kHeadDim <= 64 ? 2 : (kHeadDim <= 256 ? kHeadDim / 32 : 16));
constexpr int kFmaPart = kHeadDim / kFmaSplit;
constexpr int kFmaTile = kHeadDim <= 64 ? 32 : 2048 / kHeadDim;
constexpr int kDkvGroups = kHeadDim <= 64 ? 1 : 2;   // warpgroups of a dK/dV block (D <= 256)
constexpr int kStagesKV = kHeadDim == 256 ? 2 : 3;   // depth of the dK/dV kernel's q/do ring
constexpr int kStagesQ = 2;     // depth of the dQ kernel's K/V ring (4 blocks an SM fit at D <= 64)
constexpr int kDqMinBlocks = kHeadDim <= 64 ? 4 : (kHeadDim == 128 ? 2 : 1);
// threads a row of the pre-pass's di job: one 16-byte vector each, at most
// a warp (one thread a row, scalar loads, at D <= 16)
__host__ __device__ constexpr int prep_lanes(int vec) {
  return kSmall ? 1 : (kHeadDim / vec < 32 ? kHeadDim / vec : 32);
}

// Tensor maps of the bf16 instance's tiles (kernel parameters, as TMA needs)
struct Maps {
  CUtensorMap q;     // q, or its rotated copy under rope
  CUtensorMap qh;    // q^ (unset when s is scaled in fp32)
  CUtensorMap dout;
  CUtensorMap k;     // k, or its rotated copy under rope
  CUtensorMap v;
};

struct Args {
  const void* q;      // q, k, v: views into the packed (B, T, 3C) qkv (bf16
  const void* k;      // under rope: the pre-pass's rotated copies)
  const void* v;
  const void* o;      // forward output (B, T, C)
  const void* dout;   // its gradient (B, T, C)
  const float* lse;   // (B, NH, T)
  float* di;          // (B, NH, T) scratch, written by the pre-pass
  void* dq;           // (B, T, C)
  void* dk;           // (B, T, kv_dim) each
  void* dv;
  const void* qh;     // bf16: q^ (B, T, C) contiguous, or nullptr (s scaled in fp32)
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;  // batch, time strides (elements)
  long long o_sb, o_st, do_sb, do_st;
  long long dq_sb, dq_st;    // strides of dq
  long long dkv_sb, dkv_st;  // strides of dk and dv
  int num_heads;
  int group;          // query heads per kv head: num_heads / kv_heads
  int tq;             // query rows (q, o, dout, lse, di, dq)
  int tk;             // key rows (k, v, dk, dv)
  int q_off;          // query row i sits at position q_off + i against key 0
  int causal;
  int window;         // > 0: the causal band (i - window, i]; 0: none
  float sm_scale;
  const float* rope_cos;  // (positions, D/2) fp32, or nullptr: no rope
  const float* rope_sin;
  int head_dim;       // D: kHeadDim, or at most 16 in the D = 16 build
};

// the call's head dim: a constant except in the D = 16 build
__device__ __forceinline__ int head_dim_of(const Args& a) {
  return kSmall ? a.head_dim : kHeadDim;
}

__device__ __forceinline__ long long row_of(const Args& a, int b, int h) {
  return ((long long)b * a.num_heads + h) * a.tq;
}

__device__ __forceinline__ bool visible(const Args& a, int q_row, int kv_row) {
  return q_row < a.tq && kv_row < a.tk &&
         (!a.causal || in_band(kv_row, q_row + a.q_off, a.window));
}

// whether every (q row, kv row) pair of the q tile at m0 and the kv tile at
// n0 (kBlock rows each) is visible: such a tile needs no per-element mask
__device__ __forceinline__ bool tile_full(const Args& a, int m0, int n0) {
  if (m0 + kBlock > a.tq || n0 + kBlock > a.tk) return false;
  const int p0 = m0 + a.q_off;   // the tile's first query position
  return !a.causal ||
         (p0 >= n0 + kBlock - 1 && (a.window == 0 || p0 + kBlock - 1 - n0 < a.window));
}

// the q rows whose band reaches kv rows [n0, n0 + kBlock): from the q tile
// holding the first row at or past n0 (causal), to the exclusive end of the
// rows whose window still reaches the tile's last key; an empty range when
// no row does (q_end_of <= q_start_of)
__device__ __forceinline__ int q_start_of(const Args& a, int n0) {
  return a.causal ? max(0, n0 - a.q_off) / kBlock * kBlock : 0;
}
__device__ __forceinline__ int q_end_of(const Args& a, int n0) {
  if (!a.causal || a.window == 0) return a.tq;
  return min(a.tq, n0 + kBlock + a.window - 1 - a.q_off);
}

// the kv rows the q rows [m0, m0 + kBlock) see: from the first tile (of
// `tile` rows) their band reaches to the causal frontier of the last row
__device__ __forceinline__ int kv_start_of(const Args& a, int m0, int tile) {
  return a.causal ? band_start(m0 + a.q_off, a.window, tile) : 0;
}
__device__ __forceinline__ int kv_end_of(const Args& a, int m0) {
  return a.causal ? min(a.tk, m0 + a.q_off + kBlock) : a.tk;
}

// The tensor-core kernels' probabilities, in place: p = 2^(s s_mul - lse
// log2 e), 0 where the pair is hidden (a tile inside the band and the
// causal frontier, `tile_full`, skips the mask); then dS = p (dP - di)
// sm_scale in place of dP.  The dK/dV kernels hold S^T (probs_t, grads_t):
// this thread's kv rows j0 and j0 + 8 and q columns q0 + 8 nt + 2t + e of
// the q tile at m0, whose lse log2 e and di are l2[nt][e] and dd[nt][e];
// the dQ kernels S (probs, grads): q rows r0 and r0 + 8 (lse log2 e l2_a,
// l2_b; di di_a, di_b) and kv columns n0 + 8 nt + 2t + e.
template <int N>
__device__ __forceinline__ void probs_t(const Args& a, float (&s)[N][4],
                                        const float (&l2)[N][2], float s_mul, int m0, int q0,
                                        int n0, int j0, int t) {
  if (tile_full(a, m0, n0)) {
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = ex2(fmaf(s[nt][i], s_mul, -l2[nt][i & 1]));
  } else {
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = q0 + nt * 8 + 2 * t + (i & 1);
        const float p = ex2(fmaf(s[nt][i], s_mul, -l2[nt][i & 1]));
        s[nt][i] = visible(a, m0 + qc, (i & 2) ? j0 + 8 : j0) ? p : 0.f;
      }
  }
}

template <int N>
__device__ __forceinline__ void grads_t(const Args& a, float (&dp)[N][4], const float (&s)[N][4],
                                        const float (&dd)[N][2]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dp[nt][i] = s[nt][i] * (dp[nt][i] - dd[nt][i & 1]) * a.sm_scale;
}

__device__ __forceinline__ void probs(const Args& a, float (&s)[8][4], float l2_a, float l2_b,
                                      float s_mul, int m0, int n0, int r0, int t) {
  if (tile_full(a, m0, n0)) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = ex2(fmaf(s[nt][i], s_mul, (i & 2) ? -l2_b : -l2_a));
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * t + (i & 1);
        const bool second = (i & 2) != 0;
        const float p = ex2(fmaf(s[nt][i], s_mul, second ? -l2_b : -l2_a));
        s[nt][i] = visible(a, second ? r0 + 8 : r0, col) ? p : 0.f;
      }
  }
}

__device__ __forceinline__ void grads(const Args& a, float (&dp)[8][4], const float (&s)[8][4],
                                      float di_a, float di_b) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[nt][i] = s[nt][i] * (dp[nt][i] - ((i & 2) ? di_b : di_a)) * a.sm_scale;
}

// ---------------------------------------------------------------------------
// Launch 1, the pre-pass.  blockIdx.y picks the job: 0 di (prep_lanes
// threads a row); 1 the q rows (rotated and/or q^); 2 the k rows (rotated).
// Jobs 1 and 2 are bf16 only.
// ---------------------------------------------------------------------------
struct Prep {
  bf16* q_rot;   // (B, T, C) or nullptr
  bf16* k_rot;   // (B, T, kv_dim) or nullptr
  bf16* q_hat;   // (B, T, C) or nullptr
  int batch;
};

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_prep(Args a, Prep p) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int kLanes = prep_lanes(kVec);    // threads per row: 8 bf16, 16 fp32 at D = 64
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int T_ = blockIdx.y == 2 ? a.tk : a.tq;   // job 2 runs over the k rows
  if (kSmall && blockIdx.y == 0) {
    // one thread a row of head_dim <= 16 columns, scalar loads
    const int hd = a.head_dim;
    const long long r = i;
    if (r >= (long long)p.batch * T_ * a.num_heads) return;
    const int h = r % a.num_heads;
    const long long bt = r / a.num_heads;
    const int t = bt % T_, b = bt / T_;
    const T* o = static_cast<const T*>(a.o) + b * a.o_sb + t * a.o_st + h * hd;
    const T* d = static_cast<const T*>(a.dout) + b * a.do_sb + t * a.do_st + h * hd;
    float s = 0.f;
    for (int c = 0; c < hd; ++c) s = fmaf(to_f(o[c]), to_f(d[c]), s);
    a.di[row_of(a, b, h) + t] = s;
    return;
  }
  if (blockIdx.y == 0) {
    const long long rows = (long long)p.batch * T_ * a.num_heads;
    const long long r = i / kLanes;
    const int c = i % kLanes;
    const bool live = r < rows;
    const int h = live ? r % a.num_heads : 0;
    const long long bt = live ? r / a.num_heads : 0;
    const int t = bt % T_, b = bt / T_;
    float s = 0.f;
    if (live) {
#pragma unroll
      for (int vc = c; vc < kHeadDim / kVec; vc += kLanes) {
        const uint4 ov = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(a.o) + b * a.o_sb + t * a.o_st + h * kHeadDim + vc * kVec);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(a.dout) + b * a.do_sb + t * a.do_st + h * kHeadDim + vc * kVec);
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(to_f(oe[e]), to_f(de[e]), s);
      }
    }
    // the kLanes threads of a row are neighbours in one warp
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (live && c == 0) a.di[row_of(a, b, h) + t] = s;
    return;
  }
  if constexpr (sizeof(T) == 2 && !kSmall) {
    const bool q_job = blockIdx.y == 1;
    const int heads = q_job ? a.num_heads : a.num_heads / a.group;
    const long long rows = (long long)p.batch * T_ * heads;
    const bool rope = a.rope_cos != nullptr;
    // rope: a thread rotates columns c..c+7 with c+D/2..c+D/2+7
    const int per_row = rope ? kHalf / 8 : kHeadDim / 8;
    const long long r = i / per_row;
    if (r >= rows) return;
    const int c = (i % per_row) * 8;
    const int h = r % heads;
    const long long bt = r / heads;
    const int t = bt % T_, b = bt / T_;
    const bf16* src = static_cast<const bf16*>(q_job ? a.q : a.k) +
                      b * (q_job ? a.q_sb : a.k_sb) + t * (q_job ? a.q_st : a.k_st) +
                      h * kHeadDim + c;
    const long long dst = bt * heads * kHeadDim + h * kHeadDim + c;  // contiguous (B, T, W)
    if (rope) {
      uint4 lo, hi;
      rope_row8<kHalf>(src, a.rope_cos + (long long)t * kHalf + c, a.rope_sin + (long long)t * kHalf + c,
                lo, hi);
      bf16* rot = q_job ? p.q_rot : p.k_rot;
      *reinterpret_cast<uint4*>(rot + dst) = lo;
      *reinterpret_cast<uint4*>(rot + dst + kHalf) = hi;
      if (q_job && p.q_hat != nullptr) {
        *reinterpret_cast<uint4*>(p.q_hat + dst) = scale_bf16x8(lo, a.sm_scale);
        *reinterpret_cast<uint4*>(p.q_hat + dst + kHalf) = scale_bf16x8(hi, a.sm_scale);
      }
    } else {
      *reinterpret_cast<uint4*>(p.q_hat + dst) =
          scale_bf16x8(*reinterpret_cast<const uint4*>(src), a.sm_scale);
    }
  }
}

// The FMA instance's rotation of a row split over kFmaSplit threads: this
// thread (part `part` of its row) holds dims part * kFmaPart + d of `x`;
// the pair of dim c < D/2, c + D/2, sits kFmaSplit / 2 lanes away.  Rotated
// by the table row `pos` (inverse: by -theta).  Every thread of the warp
// must call it.
__device__ __forceinline__ void rope_split(float (&x)[kFmaPart], int part, const Args& a,
                                           int pos, bool inverse) {
  const bool upper = part >= kFmaSplit / 2;
  const int tc = (part * kFmaPart) % kHalf;   // the table column of x[0]
  const float* cr = a.rope_cos + (long long)pos * kHalf + tc;
  const float* sr = a.rope_sin + (long long)pos * kHalf + tc;
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) {
    const float other = __shfl_xor_sync(0xffffffffu, x[d], kFmaSplit / 2);
    float x1 = upper ? other : x[d], x2 = upper ? x[d] : other;
    rope_pair(x1, x2, cr[d], inverse ? -sr[d] : sr[d]);
    x[d] = upper ? x2 : x1;
  }
}

// The same at D <= 16, where one thread holds a whole row of head_dim = 2H
// columns (H a power of two, so the pairs' registers are fixed at compile
// time)
template <int H>
__device__ __forceinline__ void rope_row_h(float (&x)[kFmaPart], const Args& a, int pos,
                                           bool inverse) {
#pragma unroll
  for (int d = 0; d < H; ++d) {
    const float c = a.rope_cos[(long long)pos * H + d], s = a.rope_sin[(long long)pos * H + d];
    rope_pair(x[d], x[d + H], c, inverse ? -s : s);
  }
}

__device__ __forceinline__ void rope_row(float (&x)[kFmaPart], int part, const Args& a, int pos,
                                         bool inverse) {
  if constexpr (kSmall) {
    switch (a.head_dim / 2) {
      case 8: rope_row_h<8>(x, a, pos, inverse); break;
      case 4: rope_row_h<4>(x, a, pos, inverse); break;
      case 2: rope_row_h<2>(x, a, pos, inverse); break;
      case 1: rope_row_h<1>(x, a, pos, inverse); break;
      default: break;
    }
  } else {
    rope_split(x, part, a, pos, inverse);
  }
}

// element c of row `row` of a head of hd columns at x (a row stride st),
// rotated at table row `row` under rope, before rounding; 0 past hd or n
template <typename T, bool kRope>
__device__ __forceinline__ float row_elem(const T* x, long long st, int row, int n, int c, int hd,
                                          const Args& a) {
  if (row >= n || c >= hd) return 0.f;
  const T* xr = x + (long long)row * st;
  if constexpr (kRope) {
    const int half = hd / 2;
    const long long p = (long long)row * half;
    return rope_elem<false>(xr, c, half, a.rope_cos + p, a.rope_sin + p);
  } else {
    return to_f(xr[c]);
  }
}

// the dot product of a row split over its kFmaSplit threads (neighbours in
// one warp), summed across them
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kFmaSplit; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// FMA instance (fp32): kFmaSplit threads per row, each owning kFmaPart
// columns of D; the dot products over D are finished with shuffles between
// them.  Columns past the call's head dim (D <= 16) are zeros.
// ---------------------------------------------------------------------------
template <typename T, bool kRope>
__global__ void __launch_bounds__(kFmaSplit * kBlock) flash_bwd_dkv_fma(Args a) {
  __shared__ float qh[kFmaTile][kHeadDim];   // q^ (scaled, rounded)
  __shared__ float qu[kFmaTile][kHeadDim];   // q
  __shared__ float ds_[kFmaTile][kHeadDim];  // do
  __shared__ float lse_s[kFmaTile], di_s[kFmaTile];
  const int hd = head_dim_of(a);
  const int b = blockIdx.z, hk = blockIdx.y, n0 = blockIdx.x * kBlock;
  const int j = n0 + threadIdx.x / kFmaSplit, part = threadIdx.x % kFmaSplit;
  const int c0 = part * kFmaPart;
  const bool live = j < a.tk;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * hd;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * hd;

  float kr[kFmaPart], vr[kFmaPart], dk[kFmaPart], dv[kFmaPart];
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) {
    kr[d] = to_f(from_f<T>(row_elem<T, kRope>(K, a.k_st, j, a.tk, c0 + d, hd, a)));
    vr[d] = row_elem<T, false>(V, a.v_st, j, a.tk, c0 + d, hd, a);
    dk[d] = dv[d] = 0.f;
  }
  const int m_start = q_start_of(a, n0), m_end = q_end_of(a, n0);
  // the query heads of this kv head; dk and dv sum over all of them
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * hd;
    const T* DO = static_cast<const T*>(a.dout) + b * a.do_sb + h * hd;
    const long long L = row_of(a, b, h);
    for (int m0 = m_start; m0 < m_end; m0 += kFmaTile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kFmaTile * kHeadDim; i += blockDim.x) {
        const int r = i / kHeadDim, c = i % kHeadDim, row = m0 + r;
        const float x = to_f(from_f<T>(row_elem<T, kRope>(Q, a.q_st, row, a.tq, c, hd, a)));
        qu[r][c] = x;
        qh[r][c] = to_f(from_f<T>(x * a.sm_scale));
        ds_[r][c] = row_elem<T, false>(DO, a.do_st, row, a.tq, c, hd, a);
      }
      if (threadIdx.x < kFmaTile) {
        const int row = m0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.tq ? a.lse[L + row] : 0.f;
        di_s[threadIdx.x] = row < a.tq ? a.di[L + row] : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < kFmaTile; ++ii) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kFmaPart; ++d) {
          s = fmaf(qh[ii][c0 + d], kr[d], s);
          dp = fmaf(ds_[ii][c0 + d], vr[d], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const float p = visible(a, m0 + ii, j) ? expf(s - lse_s[ii]) : 0.f;
        const float dsv = p * (dp - di_s[ii]) * a.sm_scale;
        const float pr = to_f(from_f<T>(p)), dsr = to_f(from_f<T>(dsv));
#pragma unroll
        for (int d = 0; d < kFmaPart; ++d) {
          dv[d] = fmaf(pr, ds_[ii][c0 + d], dv[d]);
          dk[d] = fmaf(dsr, qu[ii][c0 + d], dk[d]);
        }
      }
    }
  }
  if constexpr (kRope) rope_row(dk, part, a, live ? j : 0, true);
  if (!live) return;
  T* DK = static_cast<T*>(a.dk) + b * a.dkv_sb + (long long)j * a.dkv_st + hk * hd + c0;
  T* DV = static_cast<T*>(a.dv) + b * a.dkv_sb + (long long)j * a.dkv_st + hk * hd + c0;
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) {
    if (c0 + d >= hd) continue;
    DK[d] = from_f<T>(dk[d]);
    DV[d] = from_f<T>(dv[d]);
  }
}

template <typename T, bool kRope>
__global__ void __launch_bounds__(kFmaSplit * kBlock) flash_bwd_dq_fma(Args a) {
  __shared__ float ks[kFmaTile][kHeadDim];
  __shared__ float vs[kFmaTile][kHeadDim];
  const int hd = head_dim_of(a);
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlock;
  const int i = m0 + threadIdx.x / kFmaSplit, part = threadIdx.x % kFmaSplit;
  const int c0 = part * kFmaPart;
  const bool live = i < a.tq;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * hd;
  const T* DO = static_cast<const T*>(a.dout) + b * a.do_sb + h * hd;
  const int hk = h / a.group;  // this query head's kv head
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * hd;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * hd;
  const long long L = row_of(a, b, h);

  // q rotated (under rope) and rounded, then q^ = q * sm_scale rounded
  float qr[kFmaPart], dor[kFmaPart], dq[kFmaPart];
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d) {
    const float x = to_f(from_f<T>(row_elem<T, kRope>(Q, a.q_st, i, a.tq, c0 + d, hd, a)));
    qr[d] = to_f(from_f<T>(x * a.sm_scale));
    dor[d] = row_elem<T, false>(DO, a.do_st, i, a.tq, c0 + d, hd, a);
    dq[d] = 0.f;
  }
  const float lse = live ? a.lse[L + i] : 0.f;
  const float di = live ? a.di[L + i] : 0.f;
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of(a, m0, kFmaTile); n0 < kv_end; n0 += kFmaTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kFmaTile * kHeadDim; e += blockDim.x) {
      const int r = e / kHeadDim, c = e % kHeadDim, row = n0 + r;
      ks[r][c] = to_f(from_f<T>(row_elem<T, kRope>(K, a.k_st, row, a.tk, c, hd, a)));
      vs[r][c] = row_elem<T, false>(V, a.v_st, row, a.tk, c, hd, a);
    }
    __syncthreads();
    for (int jj = 0; jj < kFmaTile; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kFmaPart; ++d) {
        s = fmaf(qr[d], ks[jj][c0 + d], s);
        dp = fmaf(dor[d], vs[jj][c0 + d], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const float p = visible(a, i, n0 + jj) ? expf(s - lse) : 0.f;
      const float dsr = to_f(from_f<T>(p * (dp - di) * a.sm_scale));
#pragma unroll
      for (int d = 0; d < kFmaPart; ++d) dq[d] = fmaf(dsr, ks[jj][c0 + d], dq[d]);
    }
  }
  if constexpr (kRope) rope_row(dq, part, a, live ? i : 0, true);
  if (!live) return;
  T* DQ = static_cast<T*>(a.dq) + b * a.dq_sb + (long long)i * a.dq_st + h * hd + c0;
#pragma unroll
  for (int d = 0; d < kFmaPart; ++d)
    if (c0 + d < hd) DQ[d] = from_f<T>(dq[d]);
}

#if VITRS_HEAD_DIM == 16
// ---------------------------------------------------------------------------
// bf16 instance at D <= 16: mma.sync m16n8k16 a warp (16 rows of a 64-row
// block) on operands staged with plain loads into zero-filled 16-column
// tiles, rows or transposed, as each product reads them.  S^T, dP^T, S and
// dP are one k-step each; dV, dK and dQ one n8 tile at D <= 8, two at 16.
// q^ = q * sm_scale rounded is formed as q is staged (whatever sm_scale:
// with a power of two it is exact, the plain version's fp32 scaling).
// ---------------------------------------------------------------------------
constexpr int kRow = 24;    // bf16 a row of a staged 16-column tile (48 bytes:
                            // a warp's fragment reads hit 32 distinct banks)
constexpr int kTRow = 72;   // bf16 a row of a transposed tile (64 rows + 8)

// mma.sync's A fragment of rows r and r + 8, columns 2t .. 2t + 9, of a
// zero-padded 16-column operand whose element (row, col) is f(row, col)
template <typename F>
__device__ __forceinline__ void frag_a(uint32_t (&x)[4], int r, int t, F f) {
  x[0] = pack_f32(f(r, 2 * t), f(r, 2 * t + 1));
  x[1] = pack_f32(f(r + 8, 2 * t), f(r + 8, 2 * t + 1));
  x[2] = pack_f32(f(r, 2 * t + 8), f(r, 2 * t + 9));
  x[3] = pack_f32(f(r + 8, 2 * t + 8), f(r + 8, 2 * t + 9));
}

// B fragment words of n8 column tile `row8` (rows row8 .. row8 + 7 of a
// row-major staged tile: S's and dP's keys or queries) at k-step offset k0
__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// dst (+)= A . tile^T over one k-step, for the 8 n8 tiles of a 64-row tile
__device__ __forceinline__ void rows_product(float (&d)[8][4], const uint32_t (&x)[4],
                                             bf16 (*tile)[kRow], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const bf16* r = tile[nt * 8 + g] + 2 * t;
    mma_bf16(d[nt], x, word(r), word(r + 8));
  }
}

// acc (16 rows x hd) += X . B, X the 16 x 64 A fragments xa (4 k-steps of
// 16), B (64 x 16) stored transposed in bt (column c of B is row c of bt)
__device__ __forceinline__ void cols_product(float (&acc)[2][4], const uint32_t (&xa)[4][4],
                                             bf16 (*bt)[kTRow], int g, int t, int hd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* c0 = bt[g] + 16 * kk + 2 * t;
    mma_bf16(acc[0], xa[kk], word(c0), word(c0 + 8));
    if (hd > 8) {   // columns 8..15
      const bf16* c1 = c0 + 8 * kTRow;
      mma_bf16(acc[1], xa[kk], word(c1), word(c1 + 8));
    }
  }
}

// rows r0, r0 + 8 of a 16-column accumulator into a bf16 (rows, head of hd)
// matrix; under kRope first rotated back by -theta at their positions
// through the fp32 buffer buf (the pairs (c, c + hd/2) lie in other lanes)
template <bool kRope>
__device__ __forceinline__ void store_small(bf16* base, long long stride, float (&acc)[2][4],
                                            float (*buf)[17], int m0, int r0, int n, int t,
                                            int hd, const Args& a) {
  if constexpr (kRope) {
    const int rl = r0 - m0, half = hd / 2;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) buf[rl + 4 * (i & 2)][8 * j + 2 * t + (i & 1)] = acc[j][i];
    __syncthreads();
    for (int e = threadIdx.x; e < kBlock * half; e += blockDim.x) {
      const int r = e / half, c = e % half, row = m0 + r;
      if (row >= n) continue;
      float x1 = buf[r][c], x2 = buf[r][c + half];
      const long long idx = (long long)row * half + c;
      rope_pair(x1, x2, a.rope_cos[idx], -a.rope_sin[idx]);
      base[(long long)row * stride + c] = __float2bfloat16_rn(x1);
      base[(long long)row * stride + c + half] = __float2bfloat16_rn(x2);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * (i & 2), col = 8 * j + 2 * t + (i & 1);
        if (row < n && col < hd) base[(long long)row * stride + col] = __float2bfloat16_rn(acc[j][i]);
      }
  }
}

template <bool kRope>
__global__ void __launch_bounds__(128) flash_bwd_dkv_small(Args a) {
  __shared__ __align__(16) bf16 qh_s[kBlock][kRow];   // q^ rows (S^T = K q^^T)
  __shared__ __align__(16) bf16 do_s[kBlock][kRow];   // do rows (dP^T = V do^T)
  __shared__ __align__(16) bf16 qt_s[16][kTRow];      // q transposed (dK += dS^T q)
  __shared__ __align__(16) bf16 dot_s[16][kTRow];     // do transposed (dV += P^T do)
  __shared__ float lse_s[kBlock], di_s[kBlock];
  __shared__ float buf[kRope ? kBlock : 1][17];
  const int hd = a.head_dim;
  const int kv_heads = a.num_heads / a.group;
  const int b = blockIdx.x / kv_heads, hk = blockIdx.x % kv_heads, n0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = n0 + warp * 16 + g;  // this thread's kv rows: j0 and j0 + 8
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * hd;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * hd;
  // this warp's 16 kv rows of K (rotated, rounded) and V as A fragments
  uint32_t ka[4], va[4];
  frag_a(ka, j0, t, [&](int j, int c) {
    return to_f(__float2bfloat16_rn(row_elem<bf16, kRope>(K, a.k_st, j, a.tk, c, hd, a)));
  });
  frag_a(va, j0, t, [&](int j, int c) { return row_elem<bf16, false>(V, a.v_st, j, a.tk, c, hd, a); });

  float dk[2][4], dv[2][4];
  zero(dk);
  zero(dv);
  const int m_start = q_start_of(a, n0), m_end = q_end_of(a, n0);
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * hd;
    const bf16* DO = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * hd;
    const long long L = row_of(a, b, h);
    for (int m0 = m_start; m0 < m_end; m0 += kBlock) {
      __syncthreads();   // every warp is past the last q tile's reads
      for (int i = tid; i < kBlock * 16; i += 128) {
        const int r = i >> 4, c = i & 15, row = m0 + r;
        const bf16 x = __float2bfloat16_rn(row_elem<bf16, kRope>(Q, a.q_st, row, a.tq, c, hd, a));
        const bf16 dy = __float2bfloat16_rn(row_elem<bf16, false>(DO, a.do_st, row, a.tq, c, hd, a));
        qh_s[r][c] = __float2bfloat16_rn(__bfloat162float(x) * a.sm_scale);
        qt_s[c][r] = x;
        do_s[r][c] = dy;
        dot_s[c][r] = dy;
      }
      {
        const int r = tid & 63, row = m0 + r;
        (tid < 64 ? lse_s : di_s)[r] = row < a.tq ? (tid < 64 ? a.lse : a.di)[L + row] : 0.f;
      }
      __syncthreads();
      // S^T = K q^^T and dP^T = V do^T: 16 kv rows x 64 q columns a warp
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      rows_product(s, ka, qh_s, g, t);
      rows_product(dp, va, do_s, g, t);
      // P^T and dS^T; this thread's q columns: nt * 8 + 2t + e
      float l2[8][2], dd[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l2[nt][e] = lse_s[nt * 8 + 2 * t + e] * kLog2e;
          dd[nt][e] = di_s[nt * 8 + 2 * t + e];
        }
      probs_t(a, s, l2, kLog2e, m0, 0, n0, j0, t);
      grads_t(a, dp, s, dd);
      // dV += P^T do, dK += dS^T q
      uint32_t pa[4][4], da[4][4];
      to_a(pa, s);
      to_a(da, dp);
      cols_product(dv, pa, dot_s, g, t, hd);
      cols_product(dk, da, qt_s, g, t, hd);
    }
  }
  bf16* DK = static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * hd;
  bf16* DV = static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * hd;
  store_small<kRope>(DK, a.dkv_st, dk, buf, n0, j0, a.tk, t, hd, a);
  store_small<false>(DV, a.dkv_st, dv, buf, n0, j0, a.tk, t, hd, a);
}

template <bool kRope>
__global__ void __launch_bounds__(128) flash_bwd_dq_small(Args a) {
  __shared__ __align__(16) bf16 ks[kBlock][kRow];    // K rows (S = q^ K^T)
  __shared__ __align__(16) bf16 vs[kBlock][kRow];    // V rows (dP = do V^T)
  __shared__ __align__(16) bf16 kt[16][kTRow];       // K transposed (dQ += dS K)
  __shared__ float buf[kRope ? kBlock : 1][17];
  const int hd = a.head_dim;
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // its kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's q rows: r0 and r1
  const int r1 = r0 + 8;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * hd;
  const bf16* DO = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * hd;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * hd;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * hd;
  // this warp's 16 rows of q^ (q rotated and rounded, times sm_scale,
  // rounded) and do as A fragments
  uint32_t qa[4], doa[4];
  frag_a(qa, r0, t, [&](int i, int c) {
    const float x = __bfloat162float(__float2bfloat16_rn(row_elem<bf16, kRope>(Q, a.q_st, i, a.tq, c, hd, a)));
    return to_f(__float2bfloat16_rn(x * a.sm_scale));
  });
  frag_a(doa, r0, t, [&](int i, int c) { return row_elem<bf16, false>(DO, a.do_st, i, a.tq, c, hd, a); });
  const long long L = row_of(a, b, h);
  const float l2_a = r0 < a.tq ? a.lse[L + r0] * kLog2e : 0.f;
  const float l2_b = r1 < a.tq ? a.lse[L + r1] * kLog2e : 0.f;
  const float di_a = r0 < a.tq ? a.di[L + r0] : 0.f;
  const float di_b = r1 < a.tq ? a.di[L + r1] : 0.f;

  float dq[2][4];
  zero(dq);
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of(a, m0, kBlock); n0 < kv_end; n0 += kBlock) {
    __syncthreads();   // every warp is past the last kv tile's reads
    for (int i = tid; i < kBlock * 16; i += 128) {
      const int r = i >> 4, c = i & 15, row = n0 + r;
      const bf16 x = __float2bfloat16_rn(row_elem<bf16, kRope>(K, a.k_st, row, a.tk, c, hd, a));
      ks[r][c] = x;
      kt[c][r] = x;
      vs[r][c] = __float2bfloat16_rn(row_elem<bf16, false>(V, a.v_st, row, a.tk, c, hd, a));
    }
    __syncthreads();
    // S = q^ K^T and dP = do V^T: 16 q rows x 64 kv columns a warp
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    rows_product(s, qa, ks, g, t);
    rows_product(dp, doa, vs, g, t);
    probs(a, s, l2_a, l2_b, kLog2e, m0, n0, r0, t);
    grads(a, dp, s, di_a, di_b);
    // dQ += dS K
    uint32_t da[4][4];
    to_a(da, dp);
    cols_product(dq, da, kt, g, t, hd);
  }
  store_small<kRope>(static_cast<bf16*>(a.dq) + b * a.dq_sb + h * hd, a.dq_st, dq, buf, m0, r0,
                     a.tq, t, hd, a);
}

template <bool kRope, bool kQhat>
cudaError_t launch_bf16(const Args& a, int batch, int kv_heads, cudaStream_t s) {
  const unsigned kv_tiles = (a.tk + kBlock - 1) / kBlock, tiles = (a.tq + kBlock - 1) / kBlock;
  flash_bwd_dkv_small<kRope><<<dim3(batch * kv_heads, kv_tiles), 128, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_small<kRope><<<dim3(batch * a.num_heads, tiles), 128, 0, s>>>(a);
  return cudaGetLastError();
}
#else
// ---------------------------------------------------------------------------
// bf16 instance: wgmma, a cp.async ring, swizzled tiles.
// ---------------------------------------------------------------------------

using Tile = HeadTile<kHeadDim>;
constexpr int kTile = Tile::kBytes;  // bytes of one bf16 tile in smem (64 rows of D)

// Rotate the accumulators of a 64 x D tile (this thread's rows r0, r1 =
// r0 + 8; column nt * 8 + 2t + e pairs with the same column of tile
// nt + D / 16) back by -theta at the rows' positions; rows >= n are left
// alone.
__device__ __forceinline__ void unrotate_c(float (&acc)[kHeadDim / 8][4], int r0, int r1, int n,
                                           int t, const Args& a) {
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 16; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 2) ? r1 : r0;
      if (r >= n) continue;
      const long long idx = (long long)r * kHalf + nt * 8 + 2 * t + (i & 1);
      rope_pair(acc[nt][i], acc[nt + kHeadDim / 16][i], a.rope_cos[idx], -a.rope_sin[idx]);
    }
  }
}

// rows r0 and r1 = r0 + 8 of an accumulator 8 N8 columns wide into a bf16
// matrix
template <int N8>
__device__ __forceinline__ void store_rows(bf16* base, long long stride, const float (&acc)[N8][4],
                                           int r0, int r1, int n, int t) {
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * stride + c) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r1 < n)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r1 * stride + c) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// Dynamic shared memory, 1024-byte aligned for the swizzle (1 KB of slack
// is requested for it).
//   dK/dV: K, V, then per stage q, do (and q^); at D >= 128 the P^T and
//          dS^T tiles (64 x 64 bf16 each); per stage lse, di; then
//          kStagesKV + 1 mbarriers (one per stage, one for K and V).
//   dQ:    q (or q^), do; per stage K, V; then kStagesQ + 1 mbarriers (one
//          per stage, one for the q and do tiles).
template <bool kQhat>
__host__ __device__ constexpr int dkv_tiles() { return 2 + kStagesKV * (kQhat ? 3 : 2); }
constexpr int kShared = kDkvGroups == 2 ? 2 * 8192 : 0;   // P^T and dS^T
template <bool kQhat>
__host__ __device__ constexpr int dkv_smem() {
  return 1024 + dkv_tiles<kQhat>() * kTile + kShared + kStagesKV * 2 * kBlock * 4 +
         (kStagesKV + 1) * 8;
}
__host__ __device__ constexpr int dq_smem() {
  return 1024 + (2 + 2 * kStagesQ) * kTile + (kStagesQ + 1) * 8;
}

template <bool kRope, bool kQhat>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkv_wgmma(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t sK = base, sV = base + kTile;
  constexpr int kPer = kQhat ? 3 : 2;   // tiles per stage: q, do (, q^)
  float* stats = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) +
                                          dkv_tiles<kQhat>() * kTile);
  const uint32_t bars = smem_u32(stats + kStagesKV * 2 * kBlock);  // stage barriers, then K/V's
  const int kv_heads = a.num_heads / a.group;
  const int b = blockIdx.x / kv_heads, hk = blockIdx.x % kv_heads, n0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = n0 + warp * 16 + g;  // this thread's kv rows: j0 and j0 + 8
  const int j1 = j0 + 8;

  const int m_start = q_start_of(a, n0), m_end = q_end_of(a, n0);
  const int n_m = (max(0, m_end - m_start) + kBlock - 1) / kBlock;   // q tiles per query head
  const int n_it = a.group * n_m;

  init_barriers(bars, kStagesKV + 1);
  if (tid == 0) {
    mbar_expect(bars + 8 * kStagesKV, 2 * kTile);
    tma_head<kHeadDim>(sK, &maps.k, bars + 8 * kStagesKV, hk, n0, b);
    tma_head<kHeadDim>(sV, &maps.v, bars + 8 * kStagesKV, hk, n0, b);
  }
  // iteration it: query head hk * group + it / n_m, q tile m_start + (it % n_m) * 64,
  // in stage it % kStagesKV.  Thread 0 starts the tiles' TMA copies; every
  // thread copies one lse or di value.
  auto issue = [&](int it) {
    if (it < n_it) {
      const int st = it % kStagesKV;
      const int h = hk * a.group + it / n_m, m0 = m_start + (it % n_m) * kBlock;
      if (tid == 0) {
        const uint32_t s0 = base + (2 + st * kPer) * kTile, bar = bars + 8 * st;
        mbar_expect(bar, kPer * kTile);
        tma_head<kHeadDim>(s0, &maps.q, bar, h, m0, b);
        tma_head<kHeadDim>(s0 + kTile, &maps.dout, bar, h, m0, b);
        if constexpr (kQhat) tma_head<kHeadDim>(s0 + 2 * kTile, &maps.qh, bar, h, m0, b);
      }
      // threads 0-63 copy lse, 64-127 di
      const int r = tid & 63, row = m0 + r;
      const bool live = row < a.tq;
      const float* src = (tid < 64 ? a.lse : a.di) + row_of(a, b, h) + (live ? row : 0);
      cp_async4(smem_u32(stats + (st * 2 + (tid >> 6)) * kBlock + r), src, live);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStagesKV - 1; ++s) issue(s);

  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
  zero(dk);
  zero(dv);
  const float s_mul = (kQhat ? 1.f : a.sm_scale) * kLog2e;
  mbar_wait(bars + 8 * kStagesKV, 0);   // K and V

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStagesKV;
    cp_async_wait<kStagesKV - 2>();           // this thread's lse/di copy of tile it
    mbar_wait(bars + 8 * st, (it / kStagesKV) & 1);   // its q, do (, q^) tiles
    __syncthreads();       // lse/di visible to all; stage (it - 1) % kStagesKV is free
    const int m0 = m_start + (it % n_m) * kBlock;
    const uint32_t sq = base + (2 + st * kPer) * kTile, sdo = sq + kTile;
    const uint32_t sqs = kQhat ? sq + 2 * kTile : sq;   // the q operand of S^T
    const float* lse_s = stats + st * 2 * kBlock;
    const float* di_s = lse_s + kBlock;

    // S^T = K q^T (or K q^^T) and dP^T = V do^T: 64 kv rows x 64 q columns
    float s[8][4], dp[8][4];
    wg_fence();
    product_rows<kHeadDim>(s, sK, sqs);
    wg_commit();
    product_rows<kHeadDim>(dp, sV, sdo);
    wg_commit();
    issue(it + kStagesKV - 1);   // into the stage iteration it - 1 read, while the products run

    // this thread's q columns: nt * 8 + 2t + e
    float l2[8][2], dd[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l2[nt][e] = lse_s[nt * 8 + 2 * t + e] * kLog2e;
        dd[nt][e] = di_s[nt * 8 + 2 * t + e];
      }

    wg_wait<1>();
    fence_acc(s);
    probs_t(a, s, l2, s_mul, m0, 0, n0, j0, t);
    // dV += P^T do
    uint32_t pa[4][4];
    to_a(pa, s);
    wg_fence();
    fence_acc(dv);
    product_cols<kHeadDim>(dv, pa, sdo);
    wg_commit();

    wg_wait<1>();          // dP^T done (dV may still run)
    fence_acc(dp);
    grads_t(a, dp, s, dd);
    // dK += dS^T q
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    fence_acc(dk);
    product_cols<kHeadDim>(dk, da, sq);
    wg_commit();
    wg_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
  }

  if constexpr (kRope) unrotate_c(dk, j0, j1, a.tk, t, a);
  store_rows(static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * kHeadDim, a.dkv_st, dk, j0, j1,
             a.tk, t);
  store_rows(static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * kHeadDim, a.dkv_st, dv, j0, j1,
             a.tk, t);
}

// dK/dV at D >= 128: two warpgroups a block.  dk and dv of 64 kv rows x D
// would be D floats a thread in one warpgroup (128 at D = 128, 256 at 256:
// past the register file), so warpgroup w owns columns [w D/2, (w+1) D/2)
// of both; the S^T and dP^T of each q tile are split by q rows instead: w
// computes them for rows [32w, 32w + 32) (m64n32k16 over D), forms P^T and
// dS^T for those rows and writes them, rounded to bf16, into the shared
// P^T and dS^T tiles (64 kv rows x 64 q rows, the 128-byte swizzle); after
// a block barrier each warpgroup runs dV += P^T do and dK += dS^T q for its
// columns with both operands from shared memory.  Under rope (D = 128) dk's
// pairs (c, c + 64) lie in the two warpgroups, so the epilogue rotates it
// back through shared memory.
template <bool kRope, bool kQhat>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_wgmma2(const __grid_constant__ Maps maps, Args a) {
  using X = HeadTile<64>;   // the P^T and dS^T tiles
  constexpr int kCols = kHeadDim / 2;   // this warpgroup's columns of dk and dv
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t sK = base, sV = base + kTile;
  constexpr int kPer = kQhat ? 3 : 2;   // tiles per stage: q, do (, q^)
  const uint32_t sP = base + dkv_tiles<kQhat>() * kTile, sDS = sP + X::kBytes;
  float* stats = reinterpret_cast<float*>(smem + (sDS + X::kBytes - smem_u32(smem)));
  const uint32_t bars = smem_u32(stats + kStagesKV * 2 * kBlock);  // stage barriers, then K/V's
  uint8_t* const p_tile = smem + (sP - smem_u32(smem));
  uint8_t* const ds_tile = smem + (sDS - smem_u32(smem));
  const int kv_heads = a.num_heads / a.group;
  const int b = blockIdx.x / kv_heads, hk = blockIdx.x % kv_heads, n0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16 + g;        // this thread's kv rows in the tile: kr, kr + 8
  const int j0 = n0 + kr, j1 = j0 + 8;
  const int q0 = 32 * wg;              // this warpgroup's q rows of a tile (S^T, dP^T)

  const int m_start = q_start_of(a, n0), m_end = q_end_of(a, n0);
  const int n_m = (max(0, m_end - m_start) + kBlock - 1) / kBlock;   // q tiles per query head
  const int n_it = a.group * n_m;

  init_barriers(bars, kStagesKV + 1);
  if (tid == 0) {
    mbar_expect(bars + 8 * kStagesKV, 2 * kTile);
    tma_head<kHeadDim>(sK, &maps.k, bars + 8 * kStagesKV, hk, n0, b);
    tma_head<kHeadDim>(sV, &maps.v, bars + 8 * kStagesKV, hk, n0, b);
  }
  // as flash_bwd_dkv_wgmma's: thread 0 starts the tiles' TMA copies, the
  // first warpgroup copies lse and di
  auto issue = [&](int it) {
    if (it < n_it) {
      const int st = it % kStagesKV;
      const int h = hk * a.group + it / n_m, m0 = m_start + (it % n_m) * kBlock;
      if (tid == 0) {
        const uint32_t s0 = base + (2 + st * kPer) * kTile, bar = bars + 8 * st;
        mbar_expect(bar, kPer * kTile);
        tma_head<kHeadDim>(s0, &maps.q, bar, h, m0, b);
        tma_head<kHeadDim>(s0 + kTile, &maps.dout, bar, h, m0, b);
        if constexpr (kQhat) tma_head<kHeadDim>(s0 + 2 * kTile, &maps.qh, bar, h, m0, b);
      }
      if (tid < 128) {   // threads 0-63 copy lse, 64-127 di
        const int r = tid & 63, row = m0 + r;
        const bool live = row < a.tq;
        const float* src = (tid < 64 ? a.lse : a.di) + row_of(a, b, h) + (live ? row : 0);
        cp_async4(smem_u32(stats + (st * 2 + (tid >> 6)) * kBlock + r), src, live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStagesKV - 1; ++s) issue(s);

  float dk[kCols / 8][4], dv[kCols / 8][4];
  zero(dk);
  zero(dv);
  const float s_mul = (kQhat ? 1.f : a.sm_scale) * kLog2e;
  mbar_wait(bars + 8 * kStagesKV, 0);   // K and V

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStagesKV;
    cp_async_wait<kStagesKV - 2>();           // this thread's lse/di copy of tile it
    mbar_wait(bars + 8 * st, (it / kStagesKV) & 1);   // its q, do (, q^) tiles
    // lse/di visible to all; stage (it - 1) % kStagesKV and the P^T / dS^T
    // tiles are free (both warpgroups are past iteration it - 1's products)
    __syncthreads();
    const int m0 = m_start + (it % n_m) * kBlock;
    const uint32_t sq = base + (2 + st * kPer) * kTile, sdo = sq + kTile;
    const uint32_t sqs = kQhat ? sq + 2 * kTile : sq;   // the q operand of S^T
    const float* lse_s = stats + st * 2 * kBlock;
    const float* di_s = lse_s + kBlock;

    // S^T = K q^T (or K q^^T) and dP^T = V do^T: 64 kv rows x this
    // warpgroup's 32 q rows
    float s[4][4], dp[4][4];
    wg_fence();
    product_rows32<kHeadDim>(s, sK, sqs, q0);
    wg_commit();
    product_rows32<kHeadDim>(dp, sV, sdo, q0);
    wg_commit();
    issue(it + kStagesKV - 1);   // into the stage iteration it - 1 read, while the products run

    // this thread's q columns: q0 + nt * 8 + 2t + e
    float l2[4][2], dd[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l2[nt][e] = lse_s[q0 + nt * 8 + 2 * t + e] * kLog2e;
        dd[nt][e] = di_s[q0 + nt * 8 + 2 * t + e];
      }

    wg_wait<1>();
    fence_acc(s);
    probs_t(a, s, l2, s_mul, m0, q0, n0, j0, t);
    wg_wait<0>();
    fence_acc(dp);
    grads_t(a, dp, s, dd);
    // P^T and dS^T, rounded to bf16, into the shared tiles for both warpgroups
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = q0 + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(p_tile + X::offset(kr, col)) = pack_f32(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(p_tile + X::offset(kr + 8, col)) =
          pack_f32(s[nt][2], s[nt][3]);
      *reinterpret_cast<uint32_t*>(ds_tile + X::offset(kr, col)) = pack_f32(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(ds_tile + X::offset(kr + 8, col)) =
          pack_f32(dp[nt][2], dp[nt][3]);
    }
    // the generic-proxy stores, before wgmma (the async proxy) reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // dV += P^T do and dK += dS^T q over this warpgroup's columns
    wg_fence();
    fence_acc(dv);
    fence_acc(dk);
    product_cols_ss<kHeadDim>(dv, sP, sdo, wg * kCols / 64);
    product_cols_ss<kHeadDim>(dk, sDS, sq, wg * kCols / 64);
    wg_commit();
    wg_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
  }

  const int c0 = wg * kCols;   // this warpgroup's first column
  bf16* const DK = static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * kHeadDim;
  if constexpr (kRope) {
    // dk rotated back by -theta at its keys' positions: each pair (c, c +
    // D/2) through a 64 x D fp32 buffer over the ring (every copy into it
    // has landed and every product reading it is done)
    __syncthreads();
    float* buf = reinterpret_cast<float*>(smem + (base - smem_u32(smem)));
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const int c = c0 + nt * 8 + 2 * t;
      buf[kr * kHeadDim + c] = dk[nt][0];
      buf[kr * kHeadDim + c + 1] = dk[nt][1];
      buf[(kr + 8) * kHeadDim + c] = dk[nt][2];
      buf[(kr + 8) * kHeadDim + c + 1] = dk[nt][3];
    }
    __syncthreads();
    for (int e = tid; e < kBlock * kHalf; e += 256) {
      const int r = e / kHalf, c = e % kHalf, j = n0 + r;
      if (j >= a.tk) continue;
      float x1 = buf[r * kHeadDim + c], x2 = buf[r * kHeadDim + c + kHalf];
      const long long idx = (long long)j * kHalf + c;
      rope_pair(x1, x2, a.rope_cos[idx], -a.rope_sin[idx]);
      DK[(long long)j * a.dkv_st + c] = __float2bfloat16_rn(x1);
      DK[(long long)j * a.dkv_st + c + kHalf] = __float2bfloat16_rn(x2);
    }
  } else {
    store_rows(DK + c0, a.dkv_st, dk, j0, j1, a.tk, t);
  }
  store_rows(static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * kHeadDim + c0, a.dkv_st, dv, j0, j1,
             a.tk, t);
}

template <bool kRope, bool kQhat>
__global__ void __launch_bounds__(128, kDqMinBlocks)
    flash_bwd_dq_wgmma(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t sq = base, sdo = base + kTile;
  const uint32_t skv = base + 2 * kTile;   // stage st: K at + 2 st kTile, V after it
  const uint32_t bars = skv + 2 * kStagesQ * kTile;  // stage barriers, then the q/do tiles'
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // its kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's q rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  init_barriers(bars, kStagesQ + 1);
  if (tid == 0) {
    const uint32_t bar = bars + 8 * kStagesQ;
    mbar_expect(bar, 2 * kTile);
    tma_head<kHeadDim>(sq, kQhat ? &maps.qh : &maps.q, bar, h, m0, b);
    tma_head<kHeadDim>(sdo, &maps.dout, bar, h, m0, b);
  }
  const long long L = row_of(a, b, h);
  const float l2_a = r0 < a.tq ? a.lse[L + r0] * kLog2e : 0.f;
  const float l2_b = r1 < a.tq ? a.lse[L + r1] * kLog2e : 0.f;
  const float di_a = r0 < a.tq ? a.di[L + r0] : 0.f;
  const float di_b = r1 < a.tq ? a.di[L + r1] : 0.f;

  const int kv_start = kv_start_of(a, m0, kBlock);
  const int n_it = (max(0, kv_end_of(a, m0) - kv_start) + kBlock - 1) / kBlock;
  auto issue = [&](int it) {
    if (it < n_it && tid == 0) {
      const int st = it % kStagesQ, n0 = kv_start + it * kBlock;
      const uint32_t s0 = skv + 2 * st * kTile, bar = bars + 8 * st;
      mbar_expect(bar, 2 * kTile);
      tma_head<kHeadDim>(s0, &maps.k, bar, hk, n0, b);
      tma_head<kHeadDim>(s0 + kTile, &maps.v, bar, hk, n0, b);
    }
  };
#pragma unroll
  for (int s = 0; s < kStagesQ - 1; ++s) issue(s);

  float dq[kHeadDim / 8][4];
  zero(dq);
  const float s_mul = (kQhat ? 1.f : a.sm_scale) * kLog2e;
  mbar_wait(bars + 8 * kStagesQ, 0);   // q (or q^) and do
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStagesQ;
    mbar_wait(bars + 8 * st, (it / kStagesQ) & 1);
    __syncthreads();       // stage (it - 1) % kStagesQ is free
    const int n0 = kv_start + it * kBlock;
    const uint32_t sk = skv + 2 * st * kTile, sv = sk + kTile;

    // S = q K^T (or q^ K^T) and dP = do V^T: 64 q rows x 64 kv columns
    float s[8][4], dp[8][4];
    wg_fence();
    product_rows<kHeadDim>(s, sq, sk);
    wg_commit();
    product_rows<kHeadDim>(dp, sdo, sv);
    wg_commit();
    issue(it + kStagesQ - 1);
    wg_wait<1>();
    fence_acc(s);
    probs(a, s, l2_a, l2_b, s_mul, m0, n0, r0, t);
    wg_wait<0>();
    fence_acc(dp);
    grads(a, dp, s, di_a, di_b);
    // dQ += dS K
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    fence_acc(dq);
    product_cols<kHeadDim>(dq, da, sk);
    wg_commit();
    wg_wait<0>();
    fence_acc(dq);
  }

  if constexpr (kRope) unrotate_c(dq, r0, r1, a.tq, t, a);
  store_rows(static_cast<bf16*>(a.dq) + b * a.dq_sb + h * kHeadDim, a.dq_st, dq, r0, r1,
             a.tq, t);
}


// ---------------------------------------------------------------------------
// D >= 384: dK, dV and dQ a 64-column slice a block (blockIdx.z), the
// contraction of S and dP streamed over D in 64-column atoms.
// ---------------------------------------------------------------------------
using Atom = HeadTile<64>;
constexpr int kAtoms = kHeadDim >= 64 ? kHeadDim / 64 : 1;
constexpr int kStagesL = 2;    // depth of the sliced kernels' rings
// a dK/dV stage: atoms of K, V, q (q^ when kQhat) and do, and at a q tile's
// last atom also the slice's atoms of do and q (dV's and dK's B operands)
constexpr int kDkvStage = 6 * Atom::kBytes;
// a dQ stage: atoms of q (or q^), do, K and V, and at a kv tile's last atom
// also the slice's atom of K (dQ's B operand)
constexpr int kDqStage = 5 * Atom::kBytes;
__host__ __device__ constexpr int dkv_sliced_smem() {
  return 1024 + kStagesL * kDkvStage + 2 * 2 * kBlock * 4 + kStagesL * 8;
}
__host__ __device__ constexpr int dq_sliced_smem() {
  return 1024 + kStagesL * kDqStage + kStagesL * 8;
}

// acc (+)= A . B^T over one 64-column atom: A and B 64-row K-major atoms
// (the first k-step overwrites acc when `first`)
__device__ __forceinline__ void atom_rows(float (&acc)[8][4], uint32_t sa, uint32_t sb, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(acc, Atom::desc(sa + Atom::kstep(kk)), Atom::desc(sb + Atom::kstep(kk)),
             !first || kk > 0);
}

// dK/dV of 64 kv rows x the slice's 64 columns, one warpgroup.  Iteration
// it is q tile it / kAtoms of the group's query heads (as flash_bwd_dkv_wgmma
// walks them) and atom it % kAtoms: S^T and dP^T accumulate over the atoms,
// and at the last one P^T and dS^T are formed and dV += P^T do, dK +=
// dS^T q run on the slice's columns.  lse and di of a q tile arrive by
// cp.async with its first atom, into the half of `stats` of the tile's
// parity.
template <bool kQhat>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkv_sliced(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);
  float* stats = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + kStagesL * kDkvStage);
  const uint32_t bars = smem_u32(stats + 2 * 2 * kBlock);
  const int kv_heads = a.num_heads / a.group;
  const int b = blockIdx.x / kv_heads, hk = blockIdx.x % kv_heads, n0 = blockIdx.y * kBlock;
  const int slice = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = n0 + warp * 16 + g;  // this thread's kv rows: j0 and j0 + 8
  const int j1 = j0 + 8;

  const int m_start = q_start_of(a, n0), m_end = q_end_of(a, n0);
  const int n_m = (max(0, m_end - m_start) + kBlock - 1) / kBlock;   // q tiles per query head
  const int n_it = a.group * n_m * kAtoms;

  init_barriers(bars, kStagesL);
  auto issue = [&](int it) {
    if (it < n_it) {
      const int st = it % kStagesL, tile = it / kAtoms, at = it % kAtoms;
      const int h = hk * a.group + tile / n_m, m0 = m_start + (tile % n_m) * kBlock;
      if (tid == 0) {
        const uint32_t s0 = base + st * kDkvStage, bar = bars + 8 * st;
        const bool last = at == kAtoms - 1;
        mbar_expect(bar, (last ? 6 : 4) * Atom::kBytes);
        tma_tile(s0, &maps.k, bar, hk * kAtoms + at, n0, b);
        tma_tile(s0 + Atom::kBytes, &maps.v, bar, hk * kAtoms + at, n0, b);
        tma_tile(s0 + 2 * Atom::kBytes, kQhat ? &maps.qh : &maps.q, bar, h * kAtoms + at, m0, b);
        tma_tile(s0 + 3 * Atom::kBytes, &maps.dout, bar, h * kAtoms + at, m0, b);
        if (last) {
          tma_tile(s0 + 4 * Atom::kBytes, &maps.dout, bar, h * kAtoms + slice, m0, b);
          tma_tile(s0 + 5 * Atom::kBytes, &maps.q, bar, h * kAtoms + slice, m0, b);
        }
      }
      if (at == 0) {   // threads 0-63 copy lse, 64-127 di
        const int r = tid & 63, row = m0 + r;
        const bool live = row < a.tq;
        const float* src = (tid < 64 ? a.lse : a.di) + row_of(a, b, h) + (live ? row : 0);
        cp_async4(smem_u32(stats + ((tile & 1) * 2 + (tid >> 6)) * kBlock + r), src, live);
      }
    }
    cp_async_commit();
  };
  issue(0);

  float dk[8][4], dv[8][4], s[8][4], dp[8][4];
  zero(dk);
  zero(dv);
  zero(s);
  zero(dp);
  const float s_mul = (kQhat ? 1.f : a.sm_scale) * kLog2e;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStagesL, tile = it / kAtoms, at = it % kAtoms;
    const int m0 = m_start + (tile % n_m) * kBlock;
    cp_async_wait<0>();          // this thread's lse/di copies so far
    mbar_wait(bars + 8 * st, (it / kStagesL) & 1);
    __syncthreads();             // lse/di visible to all; stage (it - 1) % kStagesL is free
    const uint32_t s0 = base + st * kDkvStage;

    // S^T (+)= K q^T (or K q^^T) and dP^T (+)= V do^T over this atom
    fence_acc(s);
    fence_acc(dp);
    wg_fence();
    atom_rows(s, s0, s0 + 2 * Atom::kBytes, at == 0);
    wg_commit();
    atom_rows(dp, s0 + Atom::kBytes, s0 + 3 * Atom::kBytes, at == 0);
    wg_commit();
    issue(it + kStagesL - 1);    // into the stage iteration it - 1 read
    if (at != kAtoms - 1) {
      wg_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      continue;
    }

    // this thread's q columns: nt * 8 + 2t + e
    const float* lse_s = stats + (tile & 1) * 2 * kBlock;
    const float* di_s = lse_s + kBlock;
    float l2[8][2], dd[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l2[nt][e] = lse_s[nt * 8 + 2 * t + e] * kLog2e;
        dd[nt][e] = di_s[nt * 8 + 2 * t + e];
      }
    wg_wait<1>();
    fence_acc(s);
    probs_t(a, s, l2, s_mul, m0, 0, n0, j0, t);
    // dV += P^T do[:, slice]
    uint32_t pa[4][4];
    to_a(pa, s);
    wg_fence();
    fence_acc(dv);
    product_cols<64>(dv, pa, s0 + 4 * Atom::kBytes);
    wg_commit();
    wg_wait<1>();          // dP^T done (dV may still run)
    fence_acc(dp);
    grads_t(a, dp, s, dd);
    // dK += dS^T q[:, slice]
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    fence_acc(dk);
    product_cols<64>(dk, da, s0 + 5 * Atom::kBytes);
    wg_commit();
    wg_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
  }
  const int c0 = hk * kHeadDim + slice * 64;
  store_rows(static_cast<bf16*>(a.dk) + b * a.dkv_sb + c0, a.dkv_st, dk, j0, j1, a.tk, t);
  store_rows(static_cast<bf16*>(a.dv) + b * a.dkv_sb + c0, a.dkv_st, dv, j0, j1, a.tk, t);
}

// dQ of 64 q rows x the slice's 64 columns, one warpgroup: iteration it is
// kv tile it / kAtoms and atom it % kAtoms; S and dP accumulate over the
// atoms, and at the last one dQ += dS K[:, slice].
template <bool kQhat>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dq_sliced(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t bars = base + kStagesL * kDqStage;
  const int b = blockIdx.x / a.num_heads, slice = blockIdx.z;
  const int h = blockIdx.x % a.num_heads, hk = h / a.group;   // and its kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's q rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  init_barriers(bars, kStagesL);
  const long long L = row_of(a, b, h);
  const float l2_a = r0 < a.tq ? a.lse[L + r0] * kLog2e : 0.f;
  const float l2_b = r1 < a.tq ? a.lse[L + r1] * kLog2e : 0.f;
  const float di_a = r0 < a.tq ? a.di[L + r0] : 0.f;
  const float di_b = r1 < a.tq ? a.di[L + r1] : 0.f;

  const int kv_start = kv_start_of(a, m0, kBlock);
  const int n_it = (max(0, kv_end_of(a, m0) - kv_start) + kBlock - 1) / kBlock * kAtoms;
  auto issue = [&](int it) {
    if (it < n_it && tid == 0) {
      const int st = it % kStagesL, at = it % kAtoms, n0 = kv_start + it / kAtoms * kBlock;
      const uint32_t s0 = base + st * kDqStage, bar = bars + 8 * st;
      const bool last = at == kAtoms - 1;
      mbar_expect(bar, (last ? 5 : 4) * Atom::kBytes);
      tma_tile(s0, kQhat ? &maps.qh : &maps.q, bar, h * kAtoms + at, m0, b);
      tma_tile(s0 + Atom::kBytes, &maps.dout, bar, h * kAtoms + at, m0, b);
      tma_tile(s0 + 2 * Atom::kBytes, &maps.k, bar, hk * kAtoms + at, n0, b);
      tma_tile(s0 + 3 * Atom::kBytes, &maps.v, bar, hk * kAtoms + at, n0, b);
      if (last) tma_tile(s0 + 4 * Atom::kBytes, &maps.k, bar, hk * kAtoms + slice, n0, b);
    }
  };
  issue(0);

  float dq[8][4], s[8][4], dp[8][4];
  zero(dq);
  zero(s);
  zero(dp);
  const float s_mul = (kQhat ? 1.f : a.sm_scale) * kLog2e;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStagesL, at = it % kAtoms, n0 = kv_start + it / kAtoms * kBlock;
    mbar_wait(bars + 8 * st, (it / kStagesL) & 1);
    __syncthreads();       // stage (it - 1) % kStagesL is free
    const uint32_t s0 = base + st * kDqStage;

    // S (+)= q K^T (or q^ K^T) and dP (+)= do V^T over this atom
    fence_acc(s);
    fence_acc(dp);
    wg_fence();
    atom_rows(s, s0, s0 + 2 * Atom::kBytes, at == 0);
    wg_commit();
    atom_rows(dp, s0 + Atom::kBytes, s0 + 3 * Atom::kBytes, at == 0);
    wg_commit();
    issue(it + kStagesL - 1);
    if (at != kAtoms - 1) {
      wg_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      continue;
    }
    wg_wait<1>();
    fence_acc(s);
    probs(a, s, l2_a, l2_b, s_mul, m0, n0, r0, t);
    wg_wait<0>();
    fence_acc(dp);
    grads(a, dp, s, di_a, di_b);
    // dQ += dS K[:, slice]
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    fence_acc(dq);
    product_cols<64>(dq, da, s0 + 4 * Atom::kBytes);
    wg_commit();
    wg_wait<0>();
    fence_acc(dq);
  }
  store_rows(static_cast<bf16*>(a.dq) + b * a.dq_sb + h * kHeadDim + slice * 64, a.dq_st, dq, r0,
             r1, a.tq, t);
}

// this head dim's dK/dV kernel: one warpgroup at D <= 64, two at 128 and
// 256, a 64-column slice from 384
template <bool kRope, bool kQhat>
auto dkv_kernel() {
  if constexpr (kSliced)
    return flash_bwd_dkv_sliced<kQhat>;
  else if constexpr (kDkvGroups == 1)
    return flash_bwd_dkv_wgmma<kRope, kQhat>;
  else
    return flash_bwd_dkv_wgmma2<kRope, kQhat>;
}

template <bool kRope, bool kQhat>
auto dq_kernel() {
  if constexpr (kSliced)
    return flash_bwd_dq_sliced<kQhat>;
  else
    return flash_bwd_dq_wgmma<kRope, kQhat>;
}

template <bool kQhat>
__host__ __device__ constexpr int dkv_smem_of() {
  return kSliced ? dkv_sliced_smem() : dkv_smem<kQhat>();
}
__host__ __device__ constexpr int dq_smem_of() { return kSliced ? dq_sliced_smem() : dq_smem(); }
constexpr int kDkvThreads = kSliced ? 128 : 128 * kDkvGroups;

template <bool kRope, bool kQhat>
cudaError_t launch_wgmma(const Args& a, int batch, int kv_heads, cudaStream_t s) {
  const long long C = (long long)a.num_heads * kHeadDim;
  Maps maps = {};
  if (!tile_map<kHeadDim>(&maps.q, a.q, a.num_heads, a.tq, batch, a.q_st, a.q_sb) ||
      !tile_map<kHeadDim>(&maps.dout, a.dout, a.num_heads, a.tq, batch, a.do_st, a.do_sb) ||
      !tile_map<kHeadDim>(&maps.k, a.k, kv_heads, a.tk, batch, a.k_st, a.k_sb) ||
      !tile_map<kHeadDim>(&maps.v, a.v, kv_heads, a.tk, batch, a.v_st, a.v_sb) ||
      (kQhat && !tile_map<kHeadDim>(&maps.qh, a.qh, a.num_heads, a.tq, batch, C, a.tq * C)))
    return cudaErrorInvalidValue;
  const unsigned kv_tiles = (a.tk + kBlock - 1) / kBlock, tiles = (a.tq + kBlock - 1) / kBlock;
  const unsigned slices = kSliced ? kAtoms : 1;
  auto dkv = dkv_kernel<kRope, kQhat>();
  auto dq = dq_kernel<kRope, kQhat>();
  cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dkv_smem_of<kQhat>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_of());
  if (err != cudaSuccess) return err;
  dkv<<<dim3(batch * kv_heads, kv_tiles, slices), kDkvThreads, dkv_smem_of<kQhat>(), s>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<dim3(batch * a.num_heads, tiles, slices), 128, dq_smem_of(), s>>>(maps, a);
  return cudaGetLastError();
}

// the bf16 kernels of an instance this head dim has (D = 256: no rope, no
// q^; D >= 384: no rope)
template <bool kRope, bool kQhat>
cudaError_t launch_bf16(const Args& m, int batch, int kv_heads, cudaStream_t s) {
  if constexpr ((kRope && !kRopeOk) || (kQhat && !kQhatOk))
    return cudaErrorInvalidValue;
  else
    return launch_wgmma<kRope, kQhat>(m, batch, kv_heads, s);
}
#endif

bool power_of_two(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (tensor-core instance).
// q, o, dout, lse and dq have tq rows at positions q_off .. q_off+tq-1; k,
// v, dk and dv have tk rows at 0 .. tk-1 (causal: key j is visible from
// query row i when j <= q_off + i, and j > q_off + i - window for window >
// 0).  di is fp32 scratch of batch * num_heads * tq floats; dq is
// (B, tq, C), dk and dv (B, tk, kv_heads * D), every head head_dim wide:
// vitrs_flash_bwd_head_dim(), or in its D = 16 build any power of two up
// to 16; kv_heads must divide num_heads.  window > 0 (causal only): the
// band of the forward.  rope_cos/rope_sin: the fp32 (positions >= tq,
// head_dim/2) rope table, or both null; rope takes the square block only
// (tq == tk, q_off == 0), at an even head_dim <= 128.  bf16 scratch at
// head_dim >= 32, contiguous: q_rot (B, tq, C) and k_rot (B, tk, kv_dim)
// under rope, else null; q_hat (B, tq, C) when sm_scale is not a power of
// two (at D = 256 bf16 takes a power of two), else null; fp32, and bf16
// at head_dim <= 16 (whose kernels rotate and scale as they stage), take
// none.  Launches three kernels on `stream` without synchronising; returns
// the first launch error.
extern "C" int vitrs_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const float* lse, float* di,
                               void* dq, void* dk, void* dv, void* q_rot, void* k_rot,
                               void* q_hat, long long q_sb, long long q_st, long long k_sb,
                               long long k_st, long long v_sb, long long v_st, long long o_sb,
                               long long o_st, long long do_sb, long long do_st,
                               long long dq_sb, long long dq_st, long long dkv_sb,
                               long long dkv_st, int batch, int num_heads, int kv_heads,
                               int head_dim, int tq, int tk, int q_off, int causal, int window,
                               float sm_scale, const float* rope_cos, const float* rope_sin,
                               void* stream) {
  const bool rope = rope_cos != nullptr;
  const bool dim_ok = kSmall ? (head_dim >= 1 && head_dim <= 16 && (head_dim & (head_dim - 1)) == 0)
                             : head_dim == kHeadDim;
  const bool scratch_ok =
      dtype == 1 && !kSmall
          ? ((q_rot != nullptr) == rope && (k_rot != nullptr) == rope &&
             (q_hat != nullptr) == !power_of_two(sm_scale))
          : (q_rot == nullptr && k_rot == nullptr && q_hat == nullptr);
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || num_heads % kv_heads != 0 || !dim_ok ||
      window < 0 || (window > 0 && !causal) || (rope != (rope_sin != nullptr)) || !scratch_ok ||
      tq <= 0 || tk <= 0 || q_off < 0 || (rope && (q_off != 0 || tq != tk)) || batch <= 0 ||
      (rope && (!kRopeOk || head_dim % 2 != 0)) || (q_hat != nullptr && !kQhatOk))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.qh = nullptr;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.o_sb = o_sb;
  a.o_st = o_st;
  a.do_sb = do_sb;
  a.do_st = do_st;
  a.dq_sb = dq_sb;
  a.dq_st = dq_st;
  a.dkv_sb = dkv_sb;
  a.dkv_st = dkv_st;
  a.num_heads = num_heads;
  a.group = num_heads / kv_heads;
  a.tq = tq;
  a.tk = tk;
  a.q_off = q_off;
  a.causal = causal;
  a.window = window;
  a.sm_scale = sm_scale;
  a.rope_cos = rope_cos;
  a.rope_sin = rope_sin;
  a.head_dim = head_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // 1. the pre-pass (its k job runs under rope only, where tk == tq, so
  // the q rows' threads cover it)
  const long long rows = (long long)batch * tq * num_heads;
  long long threads = rows * (dtype == 1 ? prep_lanes(8) : prep_lanes(4));
  int jobs = 1;
  if (dtype == 1 && (rope || q_hat != nullptr) && !kSmall) {
    jobs = rope ? 3 : 2;
    const long long q_threads = rows * (rope ? kHalf / 8 : kHeadDim / 8);
    if (q_threads > threads) threads = q_threads;
  }
  const dim3 prep_grid(static_cast<unsigned>((threads + 255) / 256), jobs);
  Prep p{static_cast<bf16*>(q_rot), static_cast<bf16*>(k_rot), static_cast<bf16*>(q_hat),
         batch};
  if (dtype == 1)
    flash_bwd_prep<bf16><<<prep_grid, 256, 0, s>>>(a, p);
  else
    flash_bwd_prep<float><<<prep_grid, 256, 0, s>>>(a, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (dtype == 1) {
    // 2-3. the main kernels read the rotated copies and q^ (D >= 32)
    Args m = a;
    m.qh = q_hat;
    if (rope && !kSmall) {
      const long long C = (long long)num_heads * kHeadDim, kvd = (long long)kv_heads * kHeadDim;
      m.q = q_rot;
      m.q_sb = tq * C;
      m.q_st = C;
      m.k = k_rot;
      m.k_sb = tk * kvd;
      m.k_st = kvd;
    }
    if (q_hat != nullptr)
      err = rope ? launch_bf16<true, true>(m, batch, kv_heads, s)
                 : launch_bf16<false, true>(m, batch, kv_heads, s);
    else
      err = rope ? launch_bf16<true, false>(m, batch, kv_heads, s)
                 : launch_bf16<false, false>(m, batch, kv_heads, s);
    return static_cast<int>(err);
  }
  // rope is a template argument, so the instances without it carry none of
  // its registers or branches
  const dim3 kv_grid((tk + kBlock - 1) / kBlock, kv_heads, batch);
  const dim3 q_grid((tq + kBlock - 1) / kBlock, num_heads, batch);
  constexpr int kFmaThreads = kFmaSplit * kBlock;
  if (rope) {
    if constexpr (kRopeOk) flash_bwd_dkv_fma<float, true><<<kv_grid, kFmaThreads, 0, s>>>(a);
  } else {
    flash_bwd_dkv_fma<float, false><<<kv_grid, kFmaThreads, 0, s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rope) {
    if constexpr (kRopeOk) flash_bwd_dq_fma<float, true><<<q_grid, kFmaThreads, 0, s>>>(a);
  } else {
    flash_bwd_dq_fma<float, false><<<q_grid, kFmaThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the head dim this library was built for (16: every head dim up to 16)
extern "C" int vitrs_flash_bwd_head_dim() { return kHeadDim; }

namespace {

// the kernel function of attrs' (kernel, rope, qhat), or nullptr where this
// head dim has no such instance (D <= 16 forms q^ whatever qhat says)
template <bool kRope, bool kQhat>
const void* kernel_fn(int kernel) {
  if constexpr ((kRope && !kRopeOk) || (kQhat && !kQhatOk)) {
    return nullptr;
  } else {
#if VITRS_HEAD_DIM == 16
    if (kernel == 1) return reinterpret_cast<const void*>(flash_bwd_dkv_small<kRope>);
    return reinterpret_cast<const void*>(flash_bwd_dq_small<kRope>);
#else
    if (kernel == 1) return reinterpret_cast<const void*>(dkv_kernel<kRope, kQhat>());
    return reinterpret_cast<const void*>(dq_kernel<kRope, kQhat>());
#endif
  }
}

}  // namespace

// Resources of one bf16 kernel as compiled: kernel 0 the pre-pass, 1 dK/dV
// (two warpgroups at D = 128 and 256), 2 dQ; out = {registers per thread,
// local (spill) bytes per thread, static shared bytes, dynamic shared bytes
// per block, threads per block}.
extern "C" int vitrs_flash_bwd_attrs(int kernel, int rope, int qhat, int* out) {
  cudaFuncAttributes fa;
  const void* fn = nullptr;
  int dyn = 0, threads = 128;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(flash_bwd_prep<bf16>);
    threads = 256;
  } else if (kernel == 1 || kernel == 2) {
    fn = rope ? (qhat ? kernel_fn<true, true>(kernel) : kernel_fn<true, false>(kernel))
              : (qhat ? kernel_fn<false, true>(kernel) : kernel_fn<false, false>(kernel));
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#if VITRS_HEAD_DIM != 16
    dyn = kernel == 2 ? dq_smem_of() : (qhat ? dkv_smem_of<true>() : dkv_smem_of<false>());
    threads = kernel == 1 ? kDkvThreads : 128;
#endif
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = dyn;
  out[4] = threads;
  return 0;
}
