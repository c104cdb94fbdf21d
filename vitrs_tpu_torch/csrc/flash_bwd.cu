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
//   q^ = q * sm_scale rounded to the input type;  s = q^ . k^T in fp32;
//   p  = exp(s - lse), 0 where masked;  di = rowsum(o * do) in fp32;
//   ds = p * (do . v^T - di) * sm_scale;
//   dv += p(rounded)^T . do;  dk += ds(rounded)^T . q (unscaled q);
//   dq += ds(rounded) . k;  dq, dk, dv written in the input type.
// (The single-tile Pallas body scales s instead of q; the two agree to fp32
// rounding.)
// Sliding window (window > 0, causal only): p is 0 outside the band
// (i - window, i]; the dK/dV kernel's q loop ends at the last q tile whose
// band reaches its kv tile, the dQ kernel's kv loop starts at the first
// tile its band reaches, as the Pallas kernels skip tiles with
// _tile_overlaps_band.
// Rope (rope_cos != nullptr): q and k are rotated from the fp32 table as
// they are loaded and rounded to the input type (q^ is then the rotated q
// times sm_scale, rounded again), and dq (scaled) and dk are rotated back
// by -theta in fp32 just before they are stored, as the Pallas epilogues
// do (flash_attention.py l.892-893, 968-980).  Under GQA the dK/dV block
// sums its group's query heads in registers first and rotates the sum
// once: the rotation is linear, so that is exact.  TPU-shaped choices are not carried over: no 128-lane head
// groups, no (B, H, T, 128) lane-broadcast lse, no padded T, no VMEM
// admission estimate choosing between a combined and a split kernel, no
// phantom kv lanes.
//
// Three launches, FlashAttention-2's split:
//   1. flash_bwd_di   di = rowsum(o * do) per (batch, query head, row), fp32;
//   2. dK/dV kernel   one block per (kv tile of 64 rows, kv head, batch); a
//                     loop over the R query heads of the kv head's group and,
//                     inside it, over the q tiles that see the tile (in
//                     causal mode from the diagonal down) accumulates dk and
//                     dv in registers, so they leave the kernel already
//                     summed over the group, at kv width;
//   3. dQ kernel      one block per (q tile of 64 rows, query head, batch);
//                     a loop over the kv tiles (of kv head h / R) up to the
//                     diagonal accumulates dq.
// Splitting dq from dk/dv recomputes p twice but needs no atomics, so the
// result does not depend on the order blocks run in; the group sum needs
// none either, and no (B, T, C)-wide dk/dv ever exists.  The ragged end is
// masked against seq_len.  dq has its own strides, dk and dv theirs (they
// are kv_dim wide under GQA).
//
// What bounds it on the H100: like the forward, attention at T = 1024,
// D = 64 is compute-bound; the backward does 2.5x the forward's products.
// The bf16 instance runs all five products per tile (S, dP, dV, dK and dQ)
// on the tensor cores with mma.sync m16n8k16 in the FlashAttention-2
// register layout.  The dK/dV kernel computes the transposed tiles
// S^T = K . q^^T and dP^T = V . do^T, so that each warp's 16 kv rows are the
// A operand held in registers and P^T and dS^T go from the accumulators
// straight into the A operand of dV += P^T . do and dK += dS^T . q without
// touching shared memory; the dQ kernel is the forward's layout with dS in
// place of P.  Tiles are staged in shared memory with rows padded to 72
// elements (no bank conflicts on fragment reads).  Plain 16-byte loads, no
// pipelining, accurate expf: wgmma, TMA and cp.async are later work.  The
// fp32 instance (a cross-check against the plain PyTorch version at fp32
// accuracy) uses FMA with two threads per row, each owning half of D.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace vitrs;

constexpr int kHeadDim = 64;    // D of every GPT-2 preset; the wrapper checks it
constexpr int kBlock = 64;      // rows per q or kv tile, mma path
constexpr int kLd = kHeadDim + 8;  // padded smem row: 72 bf16 = 144 B
constexpr int kFmaTile = 32;    // rows per staged tile, FMA path
constexpr int kHalf = kHeadDim / 2;  // also rope's pairing: dim c with c + kHalf

struct Args {
  const void* q;      // q, k, v: views into the packed (B, T, 3C) qkv
  const void* k;
  const void* v;
  const void* o;      // forward output (B, T, C)
  const void* dout;   // its gradient (B, T, C)
  const float* lse;   // (B, NH, T)
  float* di;          // (B, NH, T) scratch, written by launch 1
  void* dq;           // (B, T, C)
  void* dk;           // (B, T, kv_dim) each
  void* dv;
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
// Launch 1: di = rowsum(o * do), one thread per (batch, row, head).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void flash_bwd_di(Args a, int batch) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)batch * a.seq_len * a.num_heads;
  if (idx >= total) return;
  const int h = idx % a.num_heads;
  const long long bt = idx / a.num_heads;
  const int t = bt % a.seq_len;
  const int b = bt / a.seq_len;
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + t * a.o_st + h * kHeadDim;
  const T* d = static_cast<const T*>(a.dout) + b * a.do_sb + t * a.do_st + h * kHeadDim;
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < kHeadDim; ++c) s = fmaf(to_f(o[c]), to_f(d[c]), s);
  a.di[row_of(a, b, h) + t] = s;
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
// bf16 instance: tensor cores, 4 warps x 16 rows per block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A fragments of 16 rows (r0 = row of g, r1 = r0 + 8) x 64 columns of a
// row-major bf16 matrix, read from global memory; rows >= n read as 0.
// kRope: rotated at the row's position and rounded to bf16 (column c < 32
// of fragment kk pairs with column c + 32 of fragment kk + 2).  scaled:
// then multiplied by `scale` in fp32 and rounded to bf16 (q^).
template <bool kRope>
__device__ __forceinline__ void load_a(uint32_t (&fa)[kHeadDim / 16][4], const bf16* base,
                                       long long stride, int r0, int r1, int n, int t,
                                       float scale, bool scaled, const Args& a) {
  if constexpr (!kRope) {
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r1 : r0;
        const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
        uint32_t x = 0u;
        if (r < n) {
          const __nv_bfloat162 v2 =
              *reinterpret_cast<const __nv_bfloat162*>(base + (long long)r * stride + c);
          x = scaled ? pack_f32(__bfloat162float(v2.x) * scale, __bfloat162float(v2.y) * scale)
                     : *reinterpret_cast<const uint32_t*>(&v2);
        }
        fa[kk][i] = x;
      }
    }
    return;
  }
  float f[kHeadDim / 16][4][2];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r1 : r0;
      const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      f[kk][i][0] = f[kk][i][1] = 0.f;
      if (r < n) {
        const __nv_bfloat162 v2 =
            *reinterpret_cast<const __nv_bfloat162*>(base + (long long)r * stride + c);
        f[kk][i][0] = __bfloat162float(v2.x);
        f[kk][i][1] = __bfloat162float(v2.y);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 32; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r1 : r0;
      if (r >= n) continue;
      const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      const long long row = (long long)r * kHalf;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rope_pair(f[kk][i][e], f[kk + 2][i][e], a.rope_cos[row + c + e],
                  a.rope_sin[row + c + e]);
        f[kk][i][e] = round_bf16(f[kk][i][e]);
        f[kk + 2][i][e] = round_bf16(f[kk + 2][i][e]);
      }
    }
  }
  const float sc = scaled ? scale : 1.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fa[kk][i] = pack_f32(f[kk][i][0] * sc, f[kk][i][1] * sc);
  }
}

// Rotate the accumulators of a 16 x 64 C tile (rows r0, r1 = r0 + 8;
// column nt * 8 + 2t + e pairs with the same column of tile nt + 4) back by
// -theta at the rows' positions; rows >= n are left alone.
__device__ __forceinline__ void unrotate_c(float (&acc)[kHeadDim / 8][4], int r0, int r1, int n,
                                           int t, const Args& a) {
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

// acc[nt] += A (16 x 64, fragments fa) . X^T, X = 64 rows of smem tile xs:
// B[k][n] = xs[n][k], a row read (the forward's S = Q K^T pattern)
__device__ __forceinline__ void mma_rows(float (&acc)[kBlock / 8][4],
                                         const uint32_t (&fa)[kHeadDim / 16][4],
                                         const bf16 (*xs)[kLd], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      const bf16* xr = &xs[nt * 8 + g][kk * 16 + 2 * t];
      mma_bf16(acc[nt], fa[kk], *reinterpret_cast<const uint32_t*>(xr),
               *reinterpret_cast<const uint32_t*>(xr + 8));
    }
  }
}

// acc[nt] += P (16 x 64, accumulators p) . X, X = smem tile xs (64 x 64):
// B[k][n] = xs[k][n], a column read (the forward's O += P V pattern)
__device__ __forceinline__ void mma_cols(float (&acc)[kHeadDim / 8][4],
                                         const float (&p)[kBlock / 8][4],
                                         const bf16 (*xs)[kLd], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    uint32_t pa[4];
    acc_to_a(pa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt) {
      const bf16* xc = &xs[kk * 16 + 2 * t][nt * 8 + g];
      mma_bf16(acc[nt], pa, pack_raw(xc[0], xc[kLd]), pack_raw(xc[8 * kLd], xc[9 * kLd]));
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// 64 rows x 64 bf16 from global (row stride `stride`) into smem; rows
// >= n are zero.  hs != nullptr: also write q^ (the row times scale,
// rounded) into hs.  kRope: rows rotated at their positions r0 + r and
// rounded first.
template <bool kRope>
__device__ __forceinline__ void stage(bf16 (*xs)[kLd], bf16 (*hs)[kLd], const bf16* base,
                                      long long stride, int r0, int n, float scale,
                                      const Args& a) {
  if constexpr (kRope) {
    for (int i = threadIdx.x; i < kBlock * (kHalf / 8); i += blockDim.x) {
      const int r = i >> 2, c = (i & 3) * 8, row = r0 + r;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (row < n)
        rope_row8(base + (long long)row * stride + c, a.rope_cos + (long long)row * kHalf + c,
                  a.rope_sin + (long long)row * kHalf + c, lo, hi);
      *reinterpret_cast<uint4*>(&xs[r][c]) = lo;
      *reinterpret_cast<uint4*>(&xs[r][c + kHalf]) = hi;
      if (hs != nullptr) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const uint4 x = part ? hi : lo;
          const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
          uint4 y;
          uint32_t* y32 = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y32[e] = pack_f32(__bfloat162float(x2[e].x) * scale,
                              __bfloat162float(x2[e].y) * scale);
          *reinterpret_cast<uint4*>(&hs[r][c + part * kHalf]) = y;
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < kBlock * (kHeadDim / 8); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8, row = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) x = *reinterpret_cast<const uint4*>(base + (long long)row * stride + c);
    *reinterpret_cast<uint4*>(&xs[r][c]) = x;
    if (hs != nullptr) {
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      uint4 y;
      uint32_t* y32 = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y32[e] = pack_f32(__bfloat162float(x2[e].x) * scale, __bfloat162float(x2[e].y) * scale);
      *reinterpret_cast<uint4*>(&hs[r][c]) = y;
    }
  }
}

template <bool kRope>
__global__ void __launch_bounds__(128) flash_bwd_dkv_mma(Args a) {
  __shared__ __align__(16) bf16 qs[kBlock][kLd];   // q
  __shared__ __align__(16) bf16 qhs[kBlock][kLd];  // q^
  __shared__ __align__(16) bf16 dos[kBlock][kLd];  // do
  __shared__ float lse_s[kBlock], di_s[kBlock];
  const int b = blockIdx.z, hk = blockIdx.y, n0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = n0 + warp * 16 + g;  // this thread's kv rows: j0 and j0 + 8
  const int j1 = j0 + 8;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * kHeadDim;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * kHeadDim;

  uint32_t ka[kHeadDim / 16][4], va[kHeadDim / 16][4];
  load_a<kRope>(ka, K, a.k_st, j0, j1, a.seq_len, t, 1.f, false, a);
  load_a<false>(va, V, a.v_st, j0, j1, a.seq_len, t, 1.f, false, a);
  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
  zero(dk);
  zero(dv);

  const int m_start = a.causal ? n0 : 0, m_end = q_end_of(a, n0);
  // the query heads of this kv head; dk and dv sum over all of them
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * kHeadDim;
    const bf16* DO = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * kHeadDim;
    const long long L = row_of(a, b, h);
    for (int m0 = m_start; m0 < m_end; m0 += kBlock) {
      __syncthreads();
      stage<kRope>(qs, qhs, Q, a.q_st, m0, a.seq_len, a.sm_scale, a);
      stage<false>(dos, nullptr, DO, a.do_st, m0, a.seq_len, 1.f, a);
      if (threadIdx.x < kBlock) {
        const int row = m0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.seq_len ? a.lse[L + row] : 0.f;
        di_s[threadIdx.x] = row < a.seq_len ? a.di[L + row] : 0.f;
      }
      __syncthreads();

      // S^T = K q^^T and dP^T = V do^T: 16 kv rows x 64 q columns per warp
      float s[kBlock / 8][4], dp[kBlock / 8][4];
      zero(s);
      zero(dp);
      mma_rows(s, ka, qhs, g, t);
      mma_rows(dp, va, dos, g, t);

      // P^T and dS^T in place: s[nt][i] is (kv row j0 or j1, q column);
      // a tile inside the band and the causal frontier skips the mask
      if (tile_full(a, m0, n0)) {
#pragma unroll
        for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qc = nt * 8 + 2 * t + (i & 1);
            const float p = expf(s[nt][i] - lse_s[qc]);
            s[nt][i] = p;
            dp[nt][i] = p * (dp[nt][i] - di_s[qc]) * a.sm_scale;
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qc = nt * 8 + 2 * t + (i & 1);
            const int j = (i & 2) ? j1 : j0;
            const float p = visible(a, m0 + qc, j) ? expf(s[nt][i] - lse_s[qc]) : 0.f;
            s[nt][i] = p;
            dp[nt][i] = p * (dp[nt][i] - di_s[qc]) * a.sm_scale;
          }
        }
      }

      // dV += P^T do and dK += dS^T q
      mma_cols(dv, s, dos, g, t);
      mma_cols(dk, dp, qs, g, t);
    }
  }

  if constexpr (kRope) unrotate_c(dk, j0, j1, a.seq_len, t, a);
  bf16* DK = static_cast<bf16*>(a.dk) + b * a.dkv_sb + hk * kHeadDim;
  bf16* DV = static_cast<bf16*>(a.dv) + b * a.dkv_sb + hk * kHeadDim;
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (j0 < a.seq_len) {
      *reinterpret_cast<__nv_bfloat162*>(DK + (long long)j0 * a.dkv_st + c) =
          __floats2bfloat162_rn(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(DV + (long long)j0 * a.dkv_st + c) =
          __floats2bfloat162_rn(dv[nt][0], dv[nt][1]);
    }
    if (j1 < a.seq_len) {
      *reinterpret_cast<__nv_bfloat162*>(DK + (long long)j1 * a.dkv_st + c) =
          __floats2bfloat162_rn(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<__nv_bfloat162*>(DV + (long long)j1 * a.dkv_st + c) =
          __floats2bfloat162_rn(dv[nt][2], dv[nt][3]);
    }
  }
}

template <bool kRope>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma(Args a) {
  __shared__ __align__(16) bf16 ks[kBlock][kLd];
  __shared__ __align__(16) bf16 vs[kBlock][kLd];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's q rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int hk = h / a.group;  // this query head's kv head
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * kHeadDim;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * kHeadDim;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * kHeadDim;
  const bf16* DO = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * kHeadDim;
  const long long L = row_of(a, b, h);

  uint32_t qa[kHeadDim / 16][4], da[kHeadDim / 16][4];
  load_a<kRope>(qa, Q, a.q_st, r0, r1, a.seq_len, t, a.sm_scale, true, a);
  load_a<false>(da, DO, a.do_st, r0, r1, a.seq_len, t, 1.f, false, a);
  const float lse_a = r0 < a.seq_len ? a.lse[L + r0] : 0.f;
  const float lse_b = r1 < a.seq_len ? a.lse[L + r1] : 0.f;
  const float di_a = r0 < a.seq_len ? a.di[L + r0] : 0.f;
  const float di_b = r1 < a.seq_len ? a.di[L + r1] : 0.f;
  float dq[kHeadDim / 8][4];
  zero(dq);

  const int kv_end = a.causal ? min(a.seq_len, m0 + kBlock) : a.seq_len;
  const int kv_start = a.causal ? band_start(m0, a.window, kBlock) : 0;
  for (int n0 = kv_start; n0 < kv_end; n0 += kBlock) {
    __syncthreads();
    stage<kRope>(ks, nullptr, K, a.k_st, n0, a.seq_len, 1.f, a);
    stage<false>(vs, nullptr, V, a.v_st, n0, a.seq_len, 1.f, a);
    __syncthreads();

    // S = q^ K^T and dP = do V^T: 16 q rows x 64 kv columns per warp
    float s[kBlock / 8][4], dp[kBlock / 8][4];
    zero(s);
    zero(dp);
    mma_rows(s, qa, ks, g, t);
    mma_rows(dp, da, vs, g, t);
    // a tile inside the band and the causal frontier skips the mask
    if (tile_full(a, m0, n0)) {
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool second = (i & 2) != 0;
          const float p = expf(s[nt][i] - (second ? lse_b : lse_a));
          dp[nt][i] = p * (dp[nt][i] - (second ? di_b : di_a)) * a.sm_scale;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          const bool second = (i & 2) != 0;
          const int row = second ? r1 : r0;
          const float p =
              visible(a, row, col) ? expf(s[nt][i] - (second ? lse_b : lse_a)) : 0.f;
          dp[nt][i] = p * (dp[nt][i] - (second ? di_b : di_a)) * a.sm_scale;
        }
      }
    }
    // dQ += dS K
    mma_cols(dq, dp, ks, g, t);
  }

  if constexpr (kRope) unrotate_c(dq, r0, r1, a.seq_len, t, a);
  bf16* DQ = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * kHeadDim;
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < a.seq_len)
      *reinterpret_cast<__nv_bfloat162*>(DQ + (long long)r0 * a.dq_st + c) =
          __floats2bfloat162_rn(dq[nt][0], dq[nt][1]);
    if (r1 < a.seq_len)
      *reinterpret_cast<__nv_bfloat162*>(DQ + (long long)r1 * a.dq_st + c) =
          __floats2bfloat162_rn(dq[nt][2], dq[nt][3]);
  }
}

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (tensor-core instance).
// di is fp32 scratch of batch * num_heads * seq_len floats; dq is (B, T, C),
// dk and dv (B, T, kv_heads * D); kv_heads must divide num_heads.  window
// > 0 (causal only): the band of the forward.  rope_cos/rope_sin: the fp32
// (positions >= seq_len, 32) rope table, or both null.  Launches three
// kernels on `stream` without synchronising; returns the first launch
// error.
extern "C" int vitrs_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const float* lse, float* di,
                               void* dq, void* dk, void* dv, long long q_sb, long long q_st,
                               long long k_sb, long long k_st, long long v_sb, long long v_st,
                               long long o_sb, long long o_st, long long do_sb,
                               long long do_st, long long dq_sb, long long dq_st,
                               long long dkv_sb, long long dkv_st, int batch, int num_heads,
                               int kv_heads, int seq_len, int causal, int window,
                               float sm_scale, const float* rope_cos, const float* rope_sin,
                               void* stream) {
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      window < 0 || (window > 0 && !causal) ||
      ((rope_cos == nullptr) != (rope_sin == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,     k,     v,      o,      dout,      lse,   di,    dq,   dk,   dv,
         q_sb,  q_st,  k_sb,   k_st,   v_sb,      v_st,  o_sb,  o_st, do_sb, do_st,
         dq_sb, dq_st, dkv_sb, dkv_st, num_heads, num_heads / kv_heads,
         seq_len, causal, window, sm_scale, rope_cos, rope_sin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)batch * seq_len * num_heads;
  const unsigned di_blocks = static_cast<unsigned>((rows + 255) / 256);
  const unsigned tiles = (seq_len + kBlock - 1) / kBlock;
  const dim3 kv_grid(tiles, kv_heads, batch), q_grid(tiles, num_heads, batch);
  if (dtype == 1) {
    flash_bwd_di<bf16><<<di_blocks, 256, 0, s>>>(a, batch);
  } else {
    flash_bwd_di<float><<<di_blocks, 256, 0, s>>>(a, batch);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // rope is a template argument, so the instances without it carry none of
  // its registers or branches
  const bool rope = rope_cos != nullptr;
  if (dtype == 1) {
    if (rope)
      flash_bwd_dkv_mma<true><<<kv_grid, 128, 0, s>>>(a);
    else
      flash_bwd_dkv_mma<false><<<kv_grid, 128, 0, s>>>(a);
  } else {
    if (rope)
      flash_bwd_dkv_fma<float, true><<<kv_grid, 2 * kBlock, 0, s>>>(a);
    else
      flash_bwd_dkv_fma<float, false><<<kv_grid, 2 * kBlock, 0, s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 1) {
    if (rope)
      flash_bwd_dq_mma<true><<<q_grid, 128, 0, s>>>(a);
    else
      flash_bwd_dq_mma<false><<<q_grid, 128, 0, s>>>(a);
  } else {
    if (rope)
      flash_bwd_dq_fma<float, true><<<q_grid, 2 * kBlock, 0, s>>>(a);
    else
      flash_bwd_dq_fma<float, false><<<q_grid, 2 * kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
