// K1-fwd, K3-fwd and K4: the flash-attention forward, written for Hopper
// (sm_90a).
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
//   * sliding window (window > 0, causal only): query at position p sees
//     keys in (p - window, p]; the kv loop starts at the first tile the
//     block's band reaches (band_start) as well as stopping at its causal
//     frontier, so a block visits about (window + 64) / 64 tiles instead of
//     all tiles up to the diagonal, and tiles the band's lower edge crosses
//     are masked per element (the Pallas kernels' _tile_overlaps_band and
//     _band_crosses_tile);
//   * rope (rope_cos != nullptr): q and k arrive unrotated and are rotated
//     as they are loaded, q at positions q_off + row with sm_scale folded
//     into its cos and sin, k at its key index, both rounded to the input
//     type (the Pallas order, flash_attention.py _fwd_kernel); the rotated
//     rows never reach device memory.  The table is the compact fp32
//     (positions, 32) cos/sin of ops/rope.py; the Pallas kernels' 256-lane
//     bf16 table and +-1 permutation matmul are TPU layout, not carried over;
//   * out is written in the input type and lse = m + log(l) compact at
//     (B, NH, tq) fp32 (the Pallas kernels broadcast it over 128 lanes).
// TPU-shaped parts that are not carried over: the 128-lane head groups and
// kv blocks, the phantom-lane padding of small kv widths (pad_gqa_weight),
// the split-cell grid (_q_split) and the VMEM budgets.  The GQA Pallas grid
// shares each kv block across its query group in VMEM; here the R query
// heads of a group are R blocks that read the same k/v rows, which the 50 MB
// L2 serves (sharing a staged tile across the group in shared memory is
// later work).
//
// What bounds it on the H100: at the serving and training shapes (T =
// 128..8192, D = 64) attention is compute-bound; per (q row, key) pair it
// does 2 x 64 multiply-adds and one exp.  The bf16 instance therefore runs
// both products on the tensor cores with mma.sync m16n8k16 (fp32
// accumulate) in the FlashAttention-2 register layout: each warp owns 16 q
// rows, S = Q.K^T and O += P.V stay in registers, and P goes from the S
// accumulator straight into the A operand of P.V without touching shared
// memory.  K and V tiles are staged in shared memory with rows padded to 72
// elements so that the fragment reads are free of bank conflicts.  Loads
// are plain 16-byte loads without double buffering, and the exp is the
// accurate expf: making it fast (cp.async or TMA pipelining, wgmma, exp2
// with a folded log2 e) is later work.  The fp32 instance (a cross-check of
// the bf16 one against the plain PyTorch version at fp32 accuracy) does its
// products with FMA, one thread per q row.  Times on the card are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace vitrs;

constexpr int kHeadDim = 64;   // D of every GPT-2 preset; the wrapper checks it
constexpr int kHalf = kHeadDim / 2;  // rope pairs dim c with dim c + kHalf
constexpr int kBlockM = 64;    // q rows per thread block
constexpr int kBlockN = 64;    // kv rows per shared-memory tile (mma path)
constexpr int kPad = 8;        // smem row = 72 bf16 = 144 B
constexpr int kFmaBlockN = 32; // kv rows per tile (FMA path)

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
__global__ void __launch_bounds__(kBlockM) flash_fwd_fma(Args a) {
  __shared__ float ks[kFmaBlockN][kHeadDim];
  __shared__ float vs[kFmaBlockN][kHeadDim];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int row = m0 + threadIdx.x;
  const bool live = row < a.tq;
  const int q_pos = row + a.q_off;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)row * a.q_st
                + h * kHeadDim;
  const int hk = h / a.group;  // this query head's kv head
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * kHeadDim;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * kHeadDim;

  float q[kHeadDim], acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    q[d] = live ? to_f(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  if constexpr (kRope) {
    // rotate at q_pos with sm_scale folded into cos and sin, then round
    const float* cr = a.rope_cos + (long long)(live ? q_pos : 0) * kHalf;
    const float* sr = a.rope_sin + (long long)(live ? q_pos : 0) * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      rope_pair(q[d], q[d + kHalf], __fmul_rn(cr[d], a.sm_scale),
                __fmul_rn(sr[d], a.sm_scale));
      q[d] = to_f(from_f<T>(q[d]));
      q[d + kHalf] = to_f(from_f<T>(q[d + kHalf]));
    }
  } else {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = to_f(from_f<T>(q[d] * a.sm_scale));
  }
  float m = -INFINITY, l = 0.f;
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of<kBand>(a, m0, kFmaBlockN); n0 < kv_end; n0 += kFmaBlockN) {
    __syncthreads();
    if constexpr (kRope) {
      for (int i = threadIdx.x; i < kFmaBlockN * kHalf; i += kBlockM) {
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
      for (int i = threadIdx.x; i < kFmaBlockN * kHeadDim; i += kBlockM) {
        const int r = i / kHeadDim, c = i % kHeadDim, j = n0 + r;
        ks[r][c] = j < a.seq_len ? to_f(kp[(long long)j * a.k_st + c]) : 0.f;
      }
    }
    for (int i = threadIdx.x; i < kFmaBlockN * kHeadDim; i += kBlockM) {
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
      for (int d = 0; d < kHeadDim; ++d) x = fmaf(q[d], ks[jj][d], x);
      s[jj] = visible<kBand>(a, n0 + jj, q_pos) ? x : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    // a row that sees no key yet keeps a finite reference: exp() gives 0
    const float ref = (mt == -INFINITY) ? 0.f : mt;
    const float alpha = expf(m - ref);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kFmaBlockN; ++jj) {
      const float p = expf(s[jj] - ref);
      l += p;
      const float pr = to_f(from_f<T>(p));
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(pr, vs[jj][d], acc[d]);
    }
    m = mt;
  }
  if (!live) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* op = static_cast<T*>(a.out) + b * a.o_sb + (long long)row * a.o_st + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) op[d] = from_f<T>(acc[d] * inv);
  a.lse[((long long)b * a.num_heads + h) * a.tq + row] =
      l > 0.f ? m + logf(l) : -INFINITY;
}

// ---------------------------------------------------------------------------
// bf16 instance: tensor cores through mma.sync.m16n8k16, 4 warps x 16 rows
// (fragment layouts in mma_bf16.cuh).
// ---------------------------------------------------------------------------

template <bool kRope, bool kBand>
__global__ void __launch_bounds__(128) flash_fwd_mma_bf16(Args a) {
  __shared__ __align__(16) bf16 ks[kBlockN][kHeadDim + kPad];
  __shared__ __align__(16) bf16 vs[kBlockN][kHeadDim + kPad];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * kHeadDim;
  const int hk = h / a.group;  // this query head's kv head
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * kHeadDim;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * kHeadDim;

  // Q as A fragments, pre-scaled (under rope: rotated with the scale folded
  // into cos and sin) and rounded to bf16.  Column c < 32 of fragment kk
  // pairs with column c + 32 of fragment kk + 2, in the same register.
  float qf[kHeadDim / 16][4][2];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r1 : r0;
      const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      qf[kk][i][0] = qf[kk][i][1] = 0.f;
      if (r < a.tq) {
        const __nv_bfloat162 v2 =
            *reinterpret_cast<const __nv_bfloat162*>(Q + (long long)r * a.q_st + c);
        qf[kk][i][0] = __bfloat162float(v2.x);
        qf[kk][i][1] = __bfloat162float(v2.y);
      }
    }
  }
  if constexpr (kRope) {
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 32; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r1 : r0;
        if (r >= a.tq) continue;
        const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
        const long long row = (long long)(r + a.q_off) * kHalf;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rope_pair(qf[kk][i][e], qf[kk + 2][i][e],
                    __fmul_rn(a.rope_cos[row + c + e], a.sm_scale),
                    __fmul_rn(a.rope_sin[row + c + e], a.sm_scale));
      }
    }
  }
  const float sc = kRope ? 1.f : a.sm_scale;
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = pack_f32(qf[kk][i][0] * sc, qf[kk][i][1] * sc);
  }

  float o[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows r0, r1
  float l_a = 0.f, l_b = 0.f;              // this thread's share of the running sums

  const int kv_end = kv_end_of(a, m0);
  for (int n0 = kv_start_of<kBand>(a, m0, kBlockN); n0 < kv_end; n0 += kBlockN) {
    __syncthreads();
    if constexpr (kRope) {
      // k rotated at its key index and rounded to bf16, 8 pairs a thread
      for (int i = threadIdx.x; i < kBlockN * (kHalf / 8); i += blockDim.x) {
        const int r = i >> 2, c = (i & 3) * 8, j = n0 + r;
        uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
        if (j < a.seq_len)
          rope_row8(K + (long long)j * a.k_st + c, a.rope_cos + (long long)j * kHalf + c,
                    a.rope_sin + (long long)j * kHalf + c, lo, hi);
        *reinterpret_cast<uint4*>(&ks[r][c]) = lo;
        *reinterpret_cast<uint4*>(&ks[r][c + kHalf]) = hi;
      }
      for (int i = threadIdx.x; i < kBlockN * (kHeadDim / 8); i += blockDim.x) {
        const int r = i >> 3, c = (i & 7) * 8, j = n0 + r;
        uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
        if (j < a.seq_len) vv4 = *reinterpret_cast<const uint4*>(V + (long long)j * a.v_st + c);
        *reinterpret_cast<uint4*>(&vs[r][c]) = vv4;
      }
    } else {
      for (int i = threadIdx.x; i < kBlockN * (kHeadDim / 8); i += blockDim.x) {
        const int r = i >> 3, c = (i & 7) * 8, j = n0 + r;
        uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
        if (j < a.seq_len) {
          kv4 = *reinterpret_cast<const uint4*>(K + (long long)j * a.k_st + c);
          vv4 = *reinterpret_cast<const uint4*>(V + (long long)j * a.v_st + c);
        }
        *reinterpret_cast<uint4*>(&ks[r][c]) = kv4;
        *reinterpret_cast<uint4*>(&vs[r][c]) = vv4;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const bf16* kr = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

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

    // online softmax, rows r0 (a) and r1 (b); a quad of lanes shares a row
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float ref_a = (mx_a == -INFINITY) ? 0.f : mx_a;
    const float ref_b = (mx_b == -INFINITY) ? 0.f : mx_b;
    const float alpha_a = expf(m_a - ref_a), alpha_b = expf(m_b - ref_b);
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
      s[nt][0] = expf(s[nt][0] - ref_a);
      s[nt][1] = expf(s[nt][1] - ref_a);
      s[nt][2] = expf(s[nt][2] - ref_b);
      s[nt][3] = expf(s[nt][3] - ref_b);
      l_a += s[nt][0] + s[nt][1];
      l_b += s[nt][2] + s[nt][3];
    }

    // O += P V: the S accumulators of key tiles 2kk and 2kk+1 are the A
    // fragment of key chunk kk
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < kHeadDim / 8; ++nt) {
        const bf16* vc = &vs[kk * 16 + 2 * t][nt * 8 + g];
        constexpr int R = kHeadDim + kPad;
        mma_bf16(o[nt], pa, pack_raw(vc[0], vc[R]), pack_raw(vc[8 * R], vc[9 * R]));
      }
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  bf16* O = static_cast<bf16*>(a.out) + b * a.o_sb + h * kHeadDim;
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < a.tq)
      *reinterpret_cast<__nv_bfloat162*>(O + (long long)r0 * a.o_st + c) =
          __floats2bfloat162_rn(o[nt][0] * inv_a, o[nt][1] * inv_a);
    if (r1 < a.tq)
      *reinterpret_cast<__nv_bfloat162*>(O + (long long)r1 * a.o_st + c) =
          __floats2bfloat162_rn(o[nt][2] * inv_b, o[nt][3] * inv_b);
  }
  if (t == 0) {
    float* L = a.lse + ((long long)b * a.num_heads + h) * a.tq;
    if (r0 < a.tq) L[r0] = l_a > 0.f ? m_a + logf(l_a) : -INFINITY;
    if (r1 < a.tq) L[r1] = l_b > 0.f ? m_b + logf(l_b) : -INFINITY;
  }
}

template <bool kRope, bool kBand>
void launch(int dtype, dim3 grid, cudaStream_t s, const Args& a) {
  if (dtype == 1)
    flash_fwd_mma_bf16<kRope, kBand><<<grid, 128, 0, s>>>(a);
  else
    flash_fwd_fma<float, kRope, kBand><<<grid, kBlockM, 0, s>>>(a);
}

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (tensor-core instance).
// q rows 0..tq-1 sit at absolute positions q_off..q_off+tq-1 and attend keys
// 0..seq_len-1 (causal: key j <= q_off + row, and j > q_off + row - window
// for window > 0); kv_heads must divide num_heads.  rope_cos/rope_sin: the
// fp32 (positions, 32) rope table covering positions up to
// max(seq_len, q_off + tq) - 1, or both null for no rotation.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int vitrs_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                               void* out, float* lse, long long q_sb, long long q_st,
                               long long k_sb, long long k_st, long long v_sb,
                               long long v_st, long long o_sb, long long o_st, int batch,
                               int num_heads, int kv_heads, int tq, int seq_len, int q_off,
                               int causal, int window, float sm_scale,
                               const float* rope_cos, const float* rope_sin, void* stream) {
  if (kv_heads <= 0 || num_heads % kv_heads != 0 || tq <= 0 || window < 0 ||
      (window > 0 && !causal) || ((rope_cos == nullptr) != (rope_sin == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    out,  lse,       q_sb,
         q_st, k_sb, k_st, v_sb, v_st,      o_sb,
         o_st, num_heads, num_heads / kv_heads, tq, seq_len, q_off, causal, window,
         sm_scale, rope_cos, rope_sin};
  const dim3 grid((tq + kBlockM - 1) / kBlockM, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rope and the band are template arguments, so the instances without
  // them carry none of their registers or branches
  const bool rope = rope_cos != nullptr, band = window > 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rope && band)
    launch<true, true>(dtype, grid, s, a);
  else if (rope)
    launch<true, false>(dtype, grid, s, a);
  else if (band)
    launch<false, true>(dtype, grid, s, a);
  else
    launch<false, false>(dtype, grid, s, a);
  return static_cast<int>(cudaGetLastError());
}
