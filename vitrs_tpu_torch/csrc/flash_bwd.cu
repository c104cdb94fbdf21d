// K2 and K3-bwd: the flash-attention backward, written for Hopper (sm_90a).
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
// When sm_scale is a power of two (1/8 at D = 64), q * sm_scale is exact in
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
//   2. dK/dV      one block (a warpgroup) per (kv tile of 64 rows, kv head,
//                 batch); a loop over the R query heads of the group and,
//                 inside it, over the q tiles that see the tile (in causal
//                 mode from the diagonal down) accumulates dk and dv in
//                 registers, so they leave summed over the group, at kv
//                 width;
//   3. dQ         one block (a warpgroup) per (q tile of 64 rows, query
//                 head, batch); a loop over the kv tiles (of kv head h / R)
//                 up to the diagonal accumulates dq.  Causal q tiles launch
//                 heaviest first.  (Blocks of several warpgroups, the query
//                 heads of one kv head sharing each staged K/V tile, ran
//                 slower at every GQA shape measured: registers then allow
//                 one block an SM against four, and the L2 serves the
//                 re-reads.)
// Splitting dq from dk/dv recomputes S and dP (7 tile products per pair
// against 5) but needs no atomics.  The ragged end is masked against seq_len
// (tiles past it are zero-filled as they are copied).
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
//     tensor map, completion on the stage's mbarrier, rows past seq_len
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
// The fp32 instance (a cross-check against the plain PyTorch version at fp32
// accuracy) uses FMA with two threads per row, each owning half of D, and
// rotates q and k itself as it stages them.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace vitrs;

constexpr int kHeadDim = 64;    // D of every GPT-2 preset; the wrapper checks it
constexpr int kBlock = 64;      // rows per q or kv tile
constexpr int kFmaTile = 32;    // rows per staged tile, FMA path
constexpr int kHalf = kHeadDim / 2;  // also rope's pairing: dim c with c + kHalf
constexpr int kTile = kBlock * kHeadDim * 2;  // bytes of one bf16 tile in smem
constexpr int kStagesKV = 3;    // depth of the dK/dV kernel's q/do ring
constexpr int kStagesQ = 2;     // depth of the dQ kernel's K/V ring (4 blocks an SM fit)
constexpr float kLog2e = 1.4426950408889634f;

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
  int seq_len;
  int causal;
  int window;         // > 0: the causal band (i - window, i]; 0: none
  float sm_scale;
  const float* rope_cos;  // (positions, kHalf) fp32, or nullptr: no rope
  const float* rope_sin;
};

__device__ __forceinline__ long long row_of(const Args& a, int b, int h) {
  return ((long long)b * a.num_heads + h) * a.seq_len;
}

__device__ __forceinline__ bool visible(const Args& a, int q_row, int kv_row) {
  return q_row < a.seq_len && kv_row < a.seq_len &&
         (!a.causal || in_band(kv_row, q_row, a.window));
}

// whether every (q row, kv row) pair of the q tile at m0 and the kv tile at
// n0 (kBlock rows each) is visible: such a tile needs no per-element mask
__device__ __forceinline__ bool tile_full(const Args& a, int m0, int n0) {
  if (m0 + kBlock > a.seq_len || n0 + kBlock > a.seq_len) return false;
  return !a.causal ||
         (m0 >= n0 + kBlock - 1 && (a.window == 0 || m0 + kBlock - 1 - n0 < a.window));
}

// exclusive end of the q rows whose band reaches kv rows [n0, n0 + kBlock)
__device__ __forceinline__ int q_end_of(const Args& a, int n0) {
  if (!a.causal || a.window == 0) return a.seq_len;
  return min(a.seq_len, n0 + kBlock + a.window - 1);
}

// ---------------------------------------------------------------------------
// Launch 1, the pre-pass.  blockIdx.y picks the job: 0 di; 1 the q rows
// (rotated and/or q^); 2 the k rows (rotated).  Jobs 1 and 2 are bf16 only.
// ---------------------------------------------------------------------------
struct Prep {
  bf16* q_rot;   // (B, T, C) or nullptr
  bf16* k_rot;   // (B, T, kv_dim) or nullptr
  bf16* q_hat;   // (B, T, C) or nullptr
  int batch;
};

__device__ __forceinline__ uint4 scale_bf16x8(uint4 x, float scale) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  uint4 y;
  uint32_t* y32 = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    y32[e] = pack_f32(__bfloat162float(x2[e].x) * scale, __bfloat162float(x2[e].y) * scale);
  return y;
}

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_prep(Args a, Prep p) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int kLanes = kHeadDim / kVec;     // threads per row: 8 bf16, 16 fp32
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int T_ = a.seq_len;
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
      const uint4 ov = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.o) + b * a.o_sb + t * a.o_st + h * kHeadDim + c * kVec);
      const uint4 dv = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.dout) + b * a.do_sb + t * a.do_st + h * kHeadDim + c * kVec);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s = fmaf(to_f(oe[e]), to_f(de[e]), s);
    }
    // the kLanes threads of a row are neighbours in one warp
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (live && c == 0) a.di[row_of(a, b, h) + t] = s;
    return;
  }
  if constexpr (sizeof(T) == 2) {
    const bool q_job = blockIdx.y == 1;
    const int heads = q_job ? a.num_heads : a.num_heads / a.group;
    const long long rows = (long long)p.batch * T_ * heads;
    const bool rope = a.rope_cos != nullptr;
    const int per_row = rope ? 4 : 8;  // rope: a thread rotates columns c..c+7 with c+32..c+39
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
      rope_row8(src, a.rope_cos + (long long)t * kHalf + c, a.rope_sin + (long long)t * kHalf + c,
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

// The FMA instance's rotation of a row split over a thread pair: this
// thread holds dims c0 + d (c0 = 0 or 32) of `x`, its partner (lane ^ 1)
// the other half.  Rotated by the table row `pos` (inverse: by -theta).
// Every thread of the warp must call it.
__device__ __forceinline__ void rope_split(float (&x)[kHalf], int half, const Args& a,
                                           int pos, bool inverse) {
  const float* cr = a.rope_cos + (long long)pos * kHalf;
  const float* sr = a.rope_sin + (long long)pos * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    const float other = __shfl_xor_sync(0xffffffffu, x[d], 1);
    float x1 = half ? other : x[d], x2 = half ? x[d] : other;
    rope_pair(x1, x2, cr[d], inverse ? -sr[d] : sr[d]);
    x[d] = half ? x2 : x1;
  }
}

// ---------------------------------------------------------------------------
// FMA instance (fp32): two threads per row, each owning half of D; the dot
// products over D are finished with one shuffle between the pair.
// ---------------------------------------------------------------------------
template <typename T, bool kRope>
__global__ void __launch_bounds__(2 * kBlock) flash_bwd_dkv_fma(Args a) {
  __shared__ float qh[kFmaTile][kHeadDim];   // q^ (scaled, rounded)
  __shared__ float qu[kFmaTile][kHeadDim];   // q
  __shared__ float ds_[kFmaTile][kHeadDim];  // do
  __shared__ float lse_s[kFmaTile], di_s[kFmaTile];
  const int b = blockIdx.z, hk = blockIdx.y, n0 = blockIdx.x * kBlock;
  const int j = n0 + (threadIdx.x >> 1), half = threadIdx.x & 1;
  const int c0 = half * kHalf;
  const bool live = j < a.seq_len;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + (long long)j * a.k_st + hk * kHeadDim;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + (long long)j * a.v_st + hk * kHeadDim;

  float kr[kHalf], vr[kHalf], dk[kHalf], dv[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    kr[d] = live ? to_f(K[c0 + d]) : 0.f;
    vr[d] = live ? to_f(V[c0 + d]) : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  if constexpr (kRope) {
    rope_split(kr, half, a, live ? j : 0, false);
#pragma unroll
    for (int d = 0; d < kHalf; ++d) kr[d] = to_f(from_f<T>(kr[d]));
  }
  const int m_start = a.causal ? n0 : 0, m_end = q_end_of(a, n0);
  // the query heads of this kv head; dk and dv sum over all of them
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * kHeadDim;
    const T* DO = static_cast<const T*>(a.dout) + b * a.do_sb + h * kHeadDim;
    const long long L = row_of(a, b, h);
    for (int m0 = m_start; m0 < m_end; m0 += kFmaTile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kFmaTile * kHalf; i += blockDim.x) {
        const int r = i / kHalf, c = i % kHalf, row = m0 + r;
        float x1 = 0.f, x2 = 0.f;
        if (row < a.seq_len) {
          x1 = to_f(Q[(long long)row * a.q_st + c]);
          x2 = to_f(Q[(long long)row * a.q_st + c + kHalf]);
          if constexpr (kRope)
            rope_pair(x1, x2, a.rope_cos[(long long)row * kHalf + c],
                      a.rope_sin[(long long)row * kHalf + c]);
        }
        x1 = to_f(from_f<T>(x1));
        x2 = to_f(from_f<T>(x2));
        qu[r][c] = x1;
        qu[r][c + kHalf] = x2;
        qh[r][c] = to_f(from_f<T>(x1 * a.sm_scale));
        qh[r][c + kHalf] = to_f(from_f<T>(x2 * a.sm_scale));
      }
      for (int i = threadIdx.x; i < kFmaTile * kHeadDim; i += blockDim.x) {
        const int r = i / kHeadDim, c = i % kHeadDim, row = m0 + r;
        ds_[r][c] = row < a.seq_len ? to_f(DO[(long long)row * a.do_st + c]) : 0.f;
      }
      if (threadIdx.x < kFmaTile) {
        const int row = m0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.seq_len ? a.lse[L + row] : 0.f;
        di_s[threadIdx.x] = row < a.seq_len ? a.di[L + row] : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < kFmaTile; ++ii) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHalf; ++d) {
          s = fmaf(qh[ii][c0 + d], kr[d], s);
          dp = fmaf(ds_[ii][c0 + d], vr[d], dp);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float p = visible(a, m0 + ii, j) ? expf(s - lse_s[ii]) : 0.f;
        const float dsv = p * (dp - di_s[ii]) * a.sm_scale;
        const float pr = to_f(from_f<T>(p)), dsr = to_f(from_f<T>(dsv));
#pragma unroll
        for (int d = 0; d < kHalf; ++d) {
          dv[d] = fmaf(pr, ds_[ii][c0 + d], dv[d]);
          dk[d] = fmaf(dsr, qu[ii][c0 + d], dk[d]);
        }
      }
    }
  }
  if constexpr (kRope) rope_split(dk, half, a, live ? j : 0, true);
  if (!live) return;
  T* DK = static_cast<T*>(a.dk) + b * a.dkv_sb + (long long)j * a.dkv_st + hk * kHeadDim + c0;
  T* DV = static_cast<T*>(a.dv) + b * a.dkv_sb + (long long)j * a.dkv_st + hk * kHeadDim + c0;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    DK[d] = from_f<T>(dk[d]);
    DV[d] = from_f<T>(dv[d]);
  }
}

template <typename T, bool kRope>
__global__ void __launch_bounds__(2 * kBlock) flash_bwd_dq_fma(Args a) {
  __shared__ float ks[kFmaTile][kHeadDim];
  __shared__ float vs[kFmaTile][kHeadDim];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlock;
  const int i = m0 + (threadIdx.x >> 1), half = threadIdx.x & 1;
  const int c0 = half * kHalf;
  const bool live = i < a.seq_len;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)i * a.q_st + h * kHeadDim;
  const T* DO = static_cast<const T*>(a.dout) + b * a.do_sb + (long long)i * a.do_st + h * kHeadDim;
  const int hk = h / a.group;  // this query head's kv head
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * kHeadDim;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * kHeadDim;
  const long long L = row_of(a, b, h);

  float qr[kHalf], dor[kHalf], dq[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = live ? to_f(Q[c0 + d]) : 0.f;
    dor[d] = live ? to_f(DO[c0 + d]) : 0.f;
    dq[d] = 0.f;
  }
  if constexpr (kRope) {
    rope_split(qr, half, a, live ? i : 0, false);
#pragma unroll
    for (int d = 0; d < kHalf; ++d) qr[d] = to_f(from_f<T>(qr[d]));
  }
#pragma unroll
  for (int d = 0; d < kHalf; ++d) qr[d] = to_f(from_f<T>(qr[d] * a.sm_scale));
  const float lse = live ? a.lse[L + i] : 0.f;
  const float di = live ? a.di[L + i] : 0.f;
  const int kv_end = a.causal ? min(a.seq_len, m0 + kBlock) : a.seq_len;
  const int kv_start = a.causal ? band_start(m0, a.window, kFmaTile) : 0;
  for (int n0 = kv_start; n0 < kv_end; n0 += kFmaTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kFmaTile * kHalf; e += blockDim.x) {
      const int r = e / kHalf, c = e % kHalf, row = n0 + r;
      float x1 = 0.f, x2 = 0.f;
      if (row < a.seq_len) {
        x1 = to_f(K[(long long)row * a.k_st + c]);
        x2 = to_f(K[(long long)row * a.k_st + c + kHalf]);
        if constexpr (kRope)
          rope_pair(x1, x2, a.rope_cos[(long long)row * kHalf + c],
                    a.rope_sin[(long long)row * kHalf + c]);
      }
      ks[r][c] = to_f(from_f<T>(x1));
      ks[r][c + kHalf] = to_f(from_f<T>(x2));
    }
    for (int e = threadIdx.x; e < kFmaTile * kHeadDim; e += blockDim.x) {
      const int r = e / kHeadDim, c = e % kHeadDim, row = n0 + r;
      vs[r][c] = row < a.seq_len ? to_f(V[(long long)row * a.v_st + c]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kFmaTile; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        s = fmaf(qr[d], ks[jj][c0 + d], s);
        dp = fmaf(dor[d], vs[jj][c0 + d], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = visible(a, i, n0 + jj) ? expf(s - lse) : 0.f;
      const float dsr = to_f(from_f<T>(p * (dp - di) * a.sm_scale));
#pragma unroll
      for (int d = 0; d < kHalf; ++d) dq[d] = fmaf(dsr, ks[jj][c0 + d], dq[d]);
    }
  }
  if constexpr (kRope) rope_split(dq, half, a, live ? i : 0, true);
  if (!live) return;
  T* DQ = static_cast<T*>(a.dq) + b * a.dq_sb + (long long)i * a.dq_st + h * kHeadDim + c0;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) DQ[d] = from_f<T>(dq[d]);
}
// ---------------------------------------------------------------------------
// bf16 instance: wgmma, a cp.async ring, swizzled tiles.
// ---------------------------------------------------------------------------

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
// 16 columns by +32 B; MN-major ones (B of dV, dK, dQ) step 16 rows by +2 KB.
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
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_ss(acc, desc(sa + kk * 32), desc(sb + kk * 32), kk);
}

// acc += X . B over 64 rows of the tile B: X (64 x 64, fp32 accumulators of
// another product) rounded to bf16 as the A operand, B read MN-major
__device__ __forceinline__ void product_cols(float (&acc)[8][4], const uint32_t (&xa)[4][4],
                                             uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_rs(acc, xa[kk], desc(sb + kk * 2048));
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

// Rotate the accumulators of a 64 x 64 tile (this thread's rows r0, r1 =
// r0 + 8; column nt * 8 + 2t + e pairs with the same column of tile nt + 4)
// back by -theta at the rows' positions; rows >= n are left alone.
__device__ __forceinline__ void unrotate_c(float (&acc)[8][4], int r0, int r1, int n, int t,
                                           const Args& a) {
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 16; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 2) ? r1 : r0;
      if (r >= n) continue;
      const long long idx = (long long)r * kHalf + nt * 8 + 2 * t + (i & 1);
      rope_pair(acc[nt][i], acc[nt + 4][i], a.rope_cos[idx], -a.rope_sin[idx]);
    }
  }
}

// rows r0 and r1 = r0 + 8 of a 64-wide accumulator into a bf16 matrix
__device__ __forceinline__ void store_rows(bf16* base, long long stride, const float (&acc)[8][4],
                                           int r0, int r1, int n, int t) {
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
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
//   dK/dV: K, V, then per stage q, do (and q^); per stage lse, di; then
//          kStagesKV + 1 mbarriers (one per stage, one for K and V).
//   dQ:    q (or q^), do; per stage K, V; then kStagesQ + 1 mbarriers (one
//          per stage, one for the q and do tiles).
template <bool kQhat>
__host__ __device__ constexpr int dkv_tiles() { return 2 + kStagesKV * (kQhat ? 3 : 2); }
template <bool kQhat>
__host__ __device__ constexpr int dkv_smem() {
  return 1024 + dkv_tiles<kQhat>() * kTile + kStagesKV * 2 * kBlock * 4 + (kStagesKV + 1) * 8;
}
__host__ __device__ constexpr int dq_smem() {
  return 1024 + (2 + 2 * kStagesQ) * kTile + (kStagesQ + 1) * 8;
}

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

  const int m_start = a.causal ? n0 : 0, m_end = q_end_of(a, n0);
  const int n_m = (m_end - m_start + kBlock - 1) / kBlock;   // q tiles per query head
  const int n_it = a.group * n_m;

  init_barriers(bars, kStagesKV + 1);
  if (tid == 0) {
    mbar_expect(bars + 8 * kStagesKV, 2 * kTile);
    tma_tile(sK, &maps.k, bars + 8 * kStagesKV, hk, n0, b);
    tma_tile(sV, &maps.v, bars + 8 * kStagesKV, hk, n0, b);
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
        tma_tile(s0, &maps.q, bar, h, m0, b);
        tma_tile(s0 + kTile, &maps.dout, bar, h, m0, b);
        if constexpr (kQhat) tma_tile(s0 + 2 * kTile, &maps.qh, bar, h, m0, b);
      }
      // threads 0-63 copy lse, 64-127 di
      const int r = tid & 63, row = m0 + r;
      const bool live = row < a.seq_len;
      const float* src = (tid < 64 ? a.lse : a.di) + row_of(a, b, h) + (live ? row : 0);
      cp_async4(smem_u32(stats + (st * 2 + (tid >> 6)) * kBlock + r), src, live);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStagesKV - 1; ++s) issue(s);

  float dk[8][4], dv[8][4];
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
    product_rows(s, sK, sqs);
    wg_commit();
    product_rows(dp, sV, sdo);
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
    // P^T in place; a tile inside the band and the causal frontier skips the mask
    if (tile_full(a, m0, n0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = ex2(fmaf(s[nt][i], s_mul, -l2[nt][i & 1]));
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = nt * 8 + 2 * t + (i & 1);
          const float p = ex2(fmaf(s[nt][i], s_mul, -l2[nt][i & 1]));
          s[nt][i] = visible(a, m0 + qc, (i & 2) ? j1 : j0) ? p : 0.f;
        }
    }
    // dV += P^T do
    uint32_t pa[4][4];
    to_a(pa, s);
    wg_fence();
    fence_acc(dv);
    product_cols(dv, pa, sdo);
    wg_commit();

    wg_wait<1>();          // dP^T done (dV may still run)
    fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[nt][i] = s[nt][i] * (dp[nt][i] - dd[nt][i & 1]) * a.sm_scale;
    // dK += dS^T q
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    fence_acc(dk);
    product_cols(dk, da, sq);
    wg_commit();
    wg_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
  }

  if constexpr (kRope) unrotate_c(dk, j0, j1, a.seq_len, t, a);
  store_rows(static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * kHeadDim, a.dkv_st, dk, j0, j1,
             a.seq_len, t);
  store_rows(static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * kHeadDim, a.dkv_st, dv, j0, j1,
             a.seq_len, t);
}

template <bool kRope, bool kQhat>
__global__ void __launch_bounds__(128, 4)
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
    tma_tile(sq, kQhat ? &maps.qh : &maps.q, bar, h, m0, b);
    tma_tile(sdo, &maps.dout, bar, h, m0, b);
  }
  const long long L = row_of(a, b, h);
  const float l2_a = r0 < a.seq_len ? a.lse[L + r0] * kLog2e : 0.f;
  const float l2_b = r1 < a.seq_len ? a.lse[L + r1] * kLog2e : 0.f;
  const float di_a = r0 < a.seq_len ? a.di[L + r0] : 0.f;
  const float di_b = r1 < a.seq_len ? a.di[L + r1] : 0.f;

  const int kv_end = a.causal ? min(a.seq_len, m0 + kBlock) : a.seq_len;
  const int kv_start = a.causal ? band_start(m0, a.window, kBlock) : 0;
  const int n_it = (kv_end - kv_start + kBlock - 1) / kBlock;
  auto issue = [&](int it) {
    if (it < n_it && tid == 0) {
      const int st = it % kStagesQ, n0 = kv_start + it * kBlock;
      const uint32_t s0 = skv + 2 * st * kTile, bar = bars + 8 * st;
      mbar_expect(bar, 2 * kTile);
      tma_tile(s0, &maps.k, bar, hk, n0, b);
      tma_tile(s0 + kTile, &maps.v, bar, hk, n0, b);
    }
  };
#pragma unroll
  for (int s = 0; s < kStagesQ - 1; ++s) issue(s);

  float dq[8][4];
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
    product_rows(s, sq, sk);
    wg_commit();
    product_rows(dp, sdo, sv);
    wg_commit();
    issue(it + kStagesQ - 1);
    wg_wait<1>();
    fence_acc(s);
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
          s[nt][i] = visible(a, second ? r1 : r0, col) ? p : 0.f;
        }
    }
    wg_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[nt][i] = s[nt][i] * (dp[nt][i] - ((i & 2) ? di_b : di_a)) * a.sm_scale;
    // dQ += dS K
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    fence_acc(dq);
    product_cols(dq, da, sk);
    wg_commit();
    wg_wait<0>();
    fence_acc(dq);
  }

  if constexpr (kRope) unrotate_c(dq, r0, r1, a.seq_len, t, a);
  store_rows(static_cast<bf16*>(a.dq) + b * a.dq_sb + h * kHeadDim, a.dq_st, dq, r0, r1,
             a.seq_len, t);
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (so the library links no libcuda), or nullptr.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
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
// box; false if the encoder refuses it.
bool tile_map(CUtensorMap* map, const void* ptr, int heads, int seq_len, int batch, long long st,
              long long sb) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {kHeadDim * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kHeadDim, 1, kBlock, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kRope, bool kQhat>
cudaError_t launch_wgmma(const Args& a, int batch, int kv_heads, cudaStream_t s) {
  const long long C = (long long)a.num_heads * kHeadDim;
  Maps maps = {};
  if (!tile_map(&maps.q, a.q, a.num_heads, a.seq_len, batch, a.q_st, a.q_sb) ||
      !tile_map(&maps.dout, a.dout, a.num_heads, a.seq_len, batch, a.do_st, a.do_sb) ||
      !tile_map(&maps.k, a.k, kv_heads, a.seq_len, batch, a.k_st, a.k_sb) ||
      !tile_map(&maps.v, a.v, kv_heads, a.seq_len, batch, a.v_st, a.v_sb) ||
      (kQhat && !tile_map(&maps.qh, a.qh, a.num_heads, a.seq_len, batch, C, a.seq_len * C)))
    return cudaErrorInvalidValue;
  const unsigned tiles = (a.seq_len + kBlock - 1) / kBlock;
  auto dkv = flash_bwd_dkv_wgmma<kRope, kQhat>;
  auto dq = flash_bwd_dq_wgmma<kRope, kQhat>;
  cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dkv_smem<kQhat>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem());
  if (err != cudaSuccess) return err;
  dkv<<<dim3(batch * kv_heads, tiles), 128, dkv_smem<kQhat>(), s>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<dim3(batch * a.num_heads, tiles), 128, dq_smem(), s>>>(maps, a);
  return cudaGetLastError();
}

bool power_of_two(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (wgmma instance).
// di is fp32 scratch of batch * num_heads * seq_len floats; dq is (B, T, C),
// dk and dv (B, T, kv_heads * D); kv_heads must divide num_heads.  window
// > 0 (causal only): the band of the forward.  rope_cos/rope_sin: the fp32
// (positions >= seq_len, 32) rope table, or both null.  bf16 scratch,
// contiguous: q_rot (B, T, C) and k_rot (B, T, kv_dim) under rope, else
// null; q_hat (B, T, C) when sm_scale is not a power of two, else null;
// fp32 takes none.  Launches three kernels on `stream` without
// synchronising; returns the first launch error.
extern "C" int vitrs_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const float* lse, float* di,
                               void* dq, void* dk, void* dv, void* q_rot, void* k_rot,
                               void* q_hat, long long q_sb, long long q_st, long long k_sb,
                               long long k_st, long long v_sb, long long v_st, long long o_sb,
                               long long o_st, long long do_sb, long long do_st,
                               long long dq_sb, long long dq_st, long long dkv_sb,
                               long long dkv_st, int batch, int num_heads, int kv_heads,
                               int seq_len, int causal, int window, float sm_scale,
                               const float* rope_cos, const float* rope_sin, void* stream) {
  const bool rope = rope_cos != nullptr;
  const bool scratch_ok =
      dtype == 1 ? ((q_rot != nullptr) == rope && (k_rot != nullptr) == rope &&
                    (q_hat != nullptr) == !power_of_two(sm_scale))
                 : (q_rot == nullptr && k_rot == nullptr && q_hat == nullptr);
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      window < 0 || (window > 0 && !causal) || (rope != (rope_sin != nullptr)) || !scratch_ok ||
      seq_len <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,      k,      v,      o,     dout,  lse,   di,     dq,        dk,
         dv,     nullptr, q_sb,  q_st,  k_sb,  k_st,  v_sb,   v_st,      o_sb,
         o_st,   do_sb,  do_st,  dq_sb, dq_st, dkv_sb, dkv_st, num_heads, num_heads / kv_heads,
         seq_len, causal, window, sm_scale, rope_cos, rope_sin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // 1. the pre-pass
  const long long rows = (long long)batch * seq_len * num_heads;
  long long threads = rows * (dtype == 1 ? 8 : 16);
  int jobs = 1;
  if (dtype == 1 && (rope || q_hat != nullptr)) {
    jobs = rope ? 3 : 2;
    const long long q_threads = rows * (rope ? 4 : 8);
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
    // 2-3. the main kernels read the rotated copies and q^
    Args m = a;
    m.qh = q_hat;
    if (rope) {
      const long long C = (long long)num_heads * kHeadDim, kvd = (long long)kv_heads * kHeadDim;
      m.q = q_rot;
      m.q_sb = seq_len * C;
      m.q_st = C;
      m.k = k_rot;
      m.k_sb = seq_len * kvd;
      m.k_st = kvd;
    }
    if (q_hat != nullptr)
      err = rope ? launch_wgmma<true, true>(m, batch, kv_heads, s)
                 : launch_wgmma<false, true>(m, batch, kv_heads, s);
    else
      err = rope ? launch_wgmma<true, false>(m, batch, kv_heads, s)
                 : launch_wgmma<false, false>(m, batch, kv_heads, s);
    return static_cast<int>(err);
  }
  // rope is a template argument, so the instances without it carry none of
  // its registers or branches
  const unsigned tiles = (seq_len + kBlock - 1) / kBlock;
  const dim3 kv_grid(tiles, kv_heads, batch), q_grid(tiles, num_heads, batch);
  if (rope)
    flash_bwd_dkv_fma<float, true><<<kv_grid, 2 * kBlock, 0, s>>>(a);
  else
    flash_bwd_dkv_fma<float, false><<<kv_grid, 2 * kBlock, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rope)
    flash_bwd_dq_fma<float, true><<<q_grid, 2 * kBlock, 0, s>>>(a);
  else
    flash_bwd_dq_fma<float, false><<<q_grid, 2 * kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resources of one bf16 kernel as compiled: kernel 0 the pre-pass, 1 dK/dV,
// 2 dQ; out = {registers per thread,
// local (spill) bytes per thread, static shared bytes, dynamic shared bytes
// per block, threads per block}.
extern "C" int vitrs_flash_bwd_attrs(int kernel, int rope, int qhat, int* out) {
  cudaFuncAttributes fa;
  const void* fn = nullptr;
  int dyn = 0, threads = 128;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(flash_bwd_prep<bf16>);
    threads = 256;
  } else if (kernel == 1) {
    fn = rope ? (qhat ? reinterpret_cast<const void*>(flash_bwd_dkv_wgmma<true, true>)
                      : reinterpret_cast<const void*>(flash_bwd_dkv_wgmma<true, false>))
              : (qhat ? reinterpret_cast<const void*>(flash_bwd_dkv_wgmma<false, true>)
                      : reinterpret_cast<const void*>(flash_bwd_dkv_wgmma<false, false>));
    dyn = qhat ? dkv_smem<true>() : dkv_smem<false>();
  } else if (kernel == 2) {
    fn = rope ? (qhat ? reinterpret_cast<const void*>(flash_bwd_dq_wgmma<true, true>)
                      : reinterpret_cast<const void*>(flash_bwd_dq_wgmma<true, false>))
              : (qhat ? reinterpret_cast<const void*>(flash_bwd_dq_wgmma<false, true>)
                      : reinterpret_cast<const void*>(flash_bwd_dq_wgmma<false, false>));
    dyn = dq_smem();
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
