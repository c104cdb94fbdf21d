// K1-fwd: flash-attention forward over packed qkv, written for Hopper (sm_90a).
//
// Replaces the two Pallas forward kernels of vitrs_tpu/ops/flash_attention.py:
//   _fwd_single_kernel (one tile, T <= 512; driver _fwd_single) and
//   _fwd_kernel        (online softmax over 512-wide kv tiles; driver _fwd).
// It computes what they compute, not their block structure:
//   * q, k and v are read in place from the packed (B, T, 3C) activation
//     through separate pointers and strides (head h at channels h*D of each
//     third), so nothing is split, transposed or padded in device memory;
//   * one thread block per (q tile of 64 rows, head, batch); a loop over kv
//     tiles inside the block replaces the TPU's sequential grid axis, and in
//     causal mode it stops at the diagonal;
//   * q is pre-scaled by sm_scale and rounded to the input type, as both
//     Pallas bodies do; scores, the running max m, the running sum l and the
//     output accumulator stay in fp32; p rounds to the input type for P.V;
//   * the ragged end is masked against seq_len instead of padding T;
//   * out is written in the input type and lse = m + log(l) compact at
//     (B, NH, T) fp32 (the Pallas kernels broadcast it over 128 lanes).
// q_off is the absolute position of query row 0 (0 for self-attention),
// kept so that the continuation-prefill kernel (flash_prefill.py) can reuse
// this one.
//
// What bounds it on the H100: at the serving shapes (T = 128..1024, D = 64)
// attention is compute-bound; per (q row, key) pair it does 2 x 64
// multiply-adds and one exp.  The bf16 instance therefore runs both
// products on the tensor cores with mma.sync m16n8k16 (fp32 accumulate) in
// the FlashAttention-2 register layout: each warp owns 16 q rows, S = Q.K^T
// and O += P.V stay in registers, and P goes from the S accumulator straight
// into the A operand of P.V without touching shared memory.  K and V tiles
// are staged in shared memory with rows padded to 72 elements so that the
// fragment reads are free of bank conflicts.  Loads are plain 16-byte loads
// without double buffering, and the exp is the accurate expf: making it
// fast (cp.async or TMA pipelining, wgmma, exp2 with a folded log2 e) is
// later work.  The fp32 instance (a cross-check of the bf16 one against the
// plain PyTorch version at fp32 accuracy) does its products with FMA, one
// thread per q row.  Times on the card are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;   // D of every GPT-2 preset; the wrapper checks it
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
  int tq;        // query rows
  int seq_len;   // keys 0 .. seq_len-1 exist
  int q_off;     // absolute position of query row 0
  int causal;
  float sm_scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// exclusive end of the keys any row of the block at q rows [m0, m0+kBlockM) sees
__device__ __forceinline__ int kv_end_of(const Args& a, int m0) {
  int end = a.seq_len;
  if (a.causal) end = min(end, m0 + kBlockM + a.q_off);
  return end;
}

// ---------------------------------------------------------------------------
// FMA instance: one thread per q row, kv tiles of kFmaBlockN rows in smem.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kBlockM) flash_fwd_fma(Args a) {
  __shared__ float ks[kFmaBlockN][kHeadDim];
  __shared__ float vs[kFmaBlockN][kHeadDim];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int row = m0 + threadIdx.x;
  const bool live = row < a.tq;
  const int q_pos = row + a.q_off;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)row * a.q_st
                + h * kHeadDim;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * kHeadDim;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * kHeadDim;

  float q[kHeadDim], acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    q[d] = live ? to_f(from_f<T>(to_f(qp[d]) * a.sm_scale)) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int kv_end = kv_end_of(a, m0);
  for (int n0 = 0; n0 < kv_end; n0 += kFmaBlockN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFmaBlockN * kHeadDim; i += kBlockM) {
      const int r = i / kHeadDim, c = i % kHeadDim, j = n0 + r;
      const bool ok = j < a.seq_len;
      ks[r][c] = ok ? to_f(kp[(long long)j * a.k_st + c]) : 0.f;
      vs[r][c] = ok ? to_f(vp[(long long)j * a.v_st + c]) : 0.f;
    }
    __syncthreads();
    float s[kFmaBlockN];
    float mt = m;
#pragma unroll
    for (int jj = 0; jj < kFmaBlockN; ++jj) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) x = fmaf(q[d], ks[jj][d], x);
      const int j = n0 + jj;
      const bool ok = j < a.seq_len && (!a.causal || j <= q_pos);
      s[jj] = ok ? x : -INFINITY;
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
// bf16 instance: tensor cores through mma.sync.m16n8k16, 4 warps x 16 rows.
// Fragment layout (g = lane / 4, t = lane % 4):
//   A 16x16: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B 16x8 : b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C 16x8 : c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(128) flash_fwd_mma_bf16(Args a) {
  __shared__ __align__(16) bf16 ks[kBlockN][kHeadDim + kPad];
  __shared__ __align__(16) bf16 vs[kBlockN][kHeadDim + kPad];
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * kHeadDim;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + h * kHeadDim;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + h * kHeadDim;

  // Q as A fragments, pre-scaled and rounded to bf16
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r1 : r0;
      const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (r < a.tq) {
        const __nv_bfloat162 v2 =
            *reinterpret_cast<const __nv_bfloat162*>(Q + (long long)r * a.q_st + c);
        x0 = __bfloat162float(v2.x) * a.sm_scale;
        x1 = __bfloat162float(v2.y) * a.sm_scale;
      }
      qa[kk][i] = pack_f32(x0, x1);
    }
  }

  float o[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows r0, r1
  float l_a = 0.f, l_b = 0.f;              // this thread's share of the running sums

  const int kv_end = kv_end_of(a, m0);
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();
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

    // mask the causal diagonal and the ragged end
    const bool edge = (n0 + kBlockN > a.seq_len) ||
                      (a.causal && n0 + kBlockN - 1 > m0 + a.q_off);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          const int row = ((i & 2) ? r1 : r0) + a.q_off;
          if (col >= a.seq_len || (a.causal && col > row)) s[nt][i] = -INFINITY;
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
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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

}  // namespace

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (tensor-core instance).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vitrs_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                               void* out, float* lse, long long q_sb, long long q_st,
                               long long k_sb, long long k_st, long long v_sb,
                               long long v_st, long long o_sb, long long o_st, int batch,
                               int num_heads, int tq, int seq_len, int q_off, int causal,
                               float sm_scale, void* stream) {
  Args a{q,    k,    v,    out,  lse,       q_sb, q_st,    k_sb,   k_st,   v_sb,
         v_st, o_sb, o_st, num_heads, tq, seq_len, q_off, causal, sm_scale};
  const dim3 grid((tq + kBlockM - 1) / kBlockM, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_fwd_mma_bf16<<<grid, 128, 0, s>>>(a);
  } else if (dtype == 0) {
    flash_fwd_fma<float><<<grid, kBlockM, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
