// K5 and K6: fused large-vocab cross-entropy, forward and backward, written
// for Hopper (sm_90a).
//
// K5 replaces the Pallas forward of vitrs_tpu/ops/fused_ce.py (_ce_fwd, body
// _fwd_kernel): per row of the (R, Vp) logits, the fp32 logsumexp over the
// first real_vocab columns (pad columns masked out) and the target's logit,
// in one read of the row.  Row loss = lse - picked.
// K6 replaces the Pallas backward (_ce_bwd_dlogits, body _bwd_kernel):
// dlogits = (softmax masked to real_vocab - onehot(target)) * g, recomputed
// from the saved lse and written in the logits' type; pad columns get 0 and
// g is the per-row upstream gradient.  The JAX package leaves this kernel off
// because XLA fuses its jnp backward into the head matmuls; eager PyTorch
// has no such fusion, so the port runs it.
//
// What bounds them on the H100: both are streams over the logits (R = 8192,
// Vp = 50304 bf16: 824 MB per pass) with a few flops per element, so device
// memory bandwidth.  K5 reads the logits once; K6 reads them once and writes
// dlogits once.  One block of 256 threads per row; each thread moves 16
// bytes per load (8 bf16 or 4 fp32), neighbouring threads on neighbouring
// addresses.  K5 keeps an online (max, sum of exp) pair per thread in fp32
// and merges the pairs across the block with shuffles and shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// merge (m2, s2) into (m, s): sums of exp(x - m) over two sets
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd(const T* logits, long long stride,
                                                   const long long* targets, int real_vocab,
                                                   int n_cols, float* lse, float* picked) {
  constexpr int kVec = 16 / sizeof(T);
  const int row = blockIdx.x;
  const T* x = logits + (long long)row * stride;
  float m = -INFINITY, s = 0.f;
  for (int c = threadIdx.x * kVec; c < real_vocab; c += kThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float v[kVec];
    float mt = m;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v[i] = c + i < real_vocab ? to_f(e[i]) : -INFINITY;
      mt = fmaxf(mt, v[i]);
    }
    // mt is finite: column c < real_vocab is
    float st = s * expf(m - mt);
#pragma unroll
    for (int i = 0; i < kVec; ++i) st += expf(v[i] - mt);
    m = mt;
    s = st;
  }
  // across the warp, then across the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float ms[kThreads / 32], ss[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ms[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, ms[w], ss[w]);
    lse[row] = m + logf(s);
    const long long tgt = targets[row];
    picked[row] = (tgt >= 0 && tgt < real_vocab) ? to_f(x[tgt]) : NAN;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd(const T* logits, T* dlogits,
                                                   long long stride,
                                                   const long long* targets,
                                                   const float* lse, const float* g,
                                                   int real_vocab, int n_cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int row = blockIdx.x;
  const T* x = logits + (long long)row * stride;
  T* dx = dlogits + (long long)row * stride;
  const float l = lse[row], gr = g[row];
  const long long tgt = targets[row];
  for (int c = threadIdx.x * kVec; c < n_cols; c += kThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int col = c + i;
      const float p = col < real_vocab ? expf(to_f(e[i]) - l) : 0.f;
      const float onehot = col == tgt ? 1.f : 0.f;
      o[i] = from_f<T>((p - onehot) * gr);
    }
    *reinterpret_cast<uint4*>(dx + c) = out;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  logits and dlogits are (rows, n_cols)
// with row stride `stride` elements; n_cols and stride are multiples of
// 16 bytes' worth of elements and the pointers 16-byte aligned (the wrapper
// checks).  Launch on `stream` without synchronising; return
// cudaGetLastError().
extern "C" int vitrs_ce_fwd(int dtype, const void* logits, long long stride,
                            const long long* targets, int rows, int real_vocab, int n_cols,
                            float* lse, float* picked, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    ce_fwd<bf16><<<rows, kThreads, 0, s>>>(static_cast<const bf16*>(logits), stride, targets,
                                           real_vocab, n_cols, lse, picked);
  } else if (dtype == 0) {
    ce_fwd<float><<<rows, kThreads, 0, s>>>(static_cast<const float*>(logits), stride, targets,
                                            real_vocab, n_cols, lse, picked);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vitrs_ce_bwd(int dtype, const void* logits, void* dlogits, long long stride,
                            const long long* targets, const float* lse, const float* g,
                            int rows, int real_vocab, int n_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    ce_bwd<bf16><<<rows, kThreads, 0, s>>>(static_cast<const bf16*>(logits),
                                           static_cast<bf16*>(dlogits), stride, targets, lse,
                                           g, real_vocab, n_cols);
  } else if (dtype == 0) {
    ce_bwd<float><<<rows, kThreads, 0, s>>>(static_cast<const float*>(logits),
                                            static_cast<float*>(dlogits), stride, targets,
                                            lse, g, real_vocab, n_cols);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
