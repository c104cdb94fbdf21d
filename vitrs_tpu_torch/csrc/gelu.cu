// GELU, forward and backward, tanh and exact (erf) forms, written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package computes GELU as plain jnp
// (vitrs_tpu/ops/basic.py, gelu / gelu_erf and the custom VJPs' local
// gradients), and on the TPU XLA fuses each into one pass over the
// activation.  Eager PyTorch runs every operation as a kernel of its own:
// about 9 bf16 passes for the tanh forward, 7 fp32 passes for the exact one
// and about 20 fp32 passes for either backward, each reading and writing the
// whole (rows, 4C) activation.  This source is that one pass.
//
// What bounds it on the H100: bytes (the bf16 tanh forward comes nearest
// to instructions, below).  The forward reads x and writes y, the backward
// reads x and dy and writes dx: 4 / 6 bytes an element in bf16, 8 / 12 in
// fp32, against about 45 fp32 instructions an element (tanhf /
// erff / expf included), close to the card's ratio.  So each byte is moved
// once: 16-byte loads and stores (8 bf16 or 4 fp32 values a thread an
// access), neighbouring threads on neighbouring addresses, a grid-stride
// loop (its grid below), and a scalar loop for the last n % 8 (bf16) or n % 4
// (fp32) values.
//
// Arithmetic: the function of the eager chain, not a cheaper one.
//   * tanh forward: every step of ops/basic.gelu rounded to x's dtype, as
//     the eager bf16 kernels round each result (the JAX op's dtype rule):
//     c = ((0.044715 x) x) x, u = s (x + c), t = tanh(u), y = (0.5 x)(1 + t).
//     0.5 x is exact whenever 1 + t is not 1 (a bf16 x halves exactly down
//     to 2^-125), and where 1 + t is 1 the product rounds 0.5 x itself; so
//     that one step is left unrounded.  bf16 values are rounded two at a
//     time (one cvt.rn.bf16x2.f32).
//   * erf forward: in fp32, rounded once, as ops/basic.gelu_erf.
//   * backward: in fp32 in the order of gelu_grad_local /
//     gelu_erf_grad_local, times dy, rounded once to x's dtype.
// Every fp32 step is a round-to-nearest intrinsic, so the compiler contracts
// nothing into an FMA that the eager kernels did not form, and tanhf, erff
// and expf are the accurate library functions the eager kernels call (no
// approximate instructions, no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

// One grid for every instance: at most kMaxBlocks blocks (32 an H100 SM,
// more than fit at once) stride over n one 16-byte vector a thread at a
// time, so that one warp's loads overlap another's arithmetic (the bf16
// tanh forward rounds seven times an element and is the one nearest to
// being bound by instructions).
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

// the Python constants of ops/basic.py, rounded to fp32 as the eager
// kernels round a scalar operand
constexpr float kCoef = 0.044715f;                      // GELU_COEF
constexpr float kCoef3 = (float)(3.0 * 0.044715);       // 3.0 * GELU_COEF
constexpr float kS = (float)0.7978845608028654;         // sqrt(2 / pi)
constexpr float kInvSqrt2 = (float)0.7071067811865476;  // INV_SQRT2
constexpr float kInvSqrt2Pi = (float)0.3989422804014327;  // INV_SQRT_2PI

template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

// round two fp32 values to T's precision (a no-op for fp32)
template <typename T>
__device__ __forceinline__ void rnd2(float& a, float& b) {
  if constexpr (kBf16<T>) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    a = __low2float(p);
    b = __high2float(p);
  }
}

template <typename T, bool ERF>
__device__ __forceinline__ void fwd2(float& a, float& b) {
  if constexpr (ERF) {
    const float ea = erff(__fmul_rn(a, kInvSqrt2));
    const float eb = erff(__fmul_rn(b, kInvSqrt2));
    a = __fmul_rn(__fmul_rn(0.5f, a), __fadd_rn(1.f, ea));
    b = __fmul_rn(__fmul_rn(0.5f, b), __fadd_rn(1.f, eb));
  } else {
    float ca = __fmul_rn(kCoef, a), cb = __fmul_rn(kCoef, b);
    rnd2<T>(ca, cb);
    ca = __fmul_rn(ca, a);
    cb = __fmul_rn(cb, b);
    rnd2<T>(ca, cb);
    ca = __fmul_rn(ca, a);
    cb = __fmul_rn(cb, b);
    rnd2<T>(ca, cb);
    float ua = __fadd_rn(a, ca), ub = __fadd_rn(b, cb);
    rnd2<T>(ua, ub);
    ua = __fmul_rn(kS, ua);
    ub = __fmul_rn(kS, ub);
    rnd2<T>(ua, ub);
    float ta = tanhf(ua), tb = tanhf(ub);
    rnd2<T>(ta, tb);
    ta = __fadd_rn(1.f, ta);
    tb = __fadd_rn(1.f, tb);
    rnd2<T>(ta, tb);
    a = __fmul_rn(__fmul_rn(0.5f, a), ta);
    b = __fmul_rn(__fmul_rn(0.5f, b), tb);
  }
}

// d gelu(x) / dx in fp32, in the eager order
template <bool ERF>
__device__ __forceinline__ float local_grad(float x) {
  if constexpr (ERF) {
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, erff(__fmul_rn(x, kInvSqrt2))));
    const float pdf = __fmul_rn(kInvSqrt2Pi, expf(__fmul_rn(__fmul_rn(-0.5f, x), x)));
    return __fadd_rn(cdf, __fmul_rn(x, pdf));
  } else {
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(kCoef, x), x), x);
    const float t = tanhf(__fmul_rn(kS, __fadd_rn(x, c)));
    const float sech2 = __fsub_rn(1.f, __fmul_rn(t, t));
    const float left = __fmul_rn(0.5f, __fadd_rn(1.f, t));
    const float slope = __fadd_rn(1.f, __fmul_rn(__fmul_rn(kCoef3, x), x));
    const float right =
        __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(x, 0.5f), sech2), kS), slope);
    return __fadd_rn(left, right);
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (kBf16<T>) {
    return __bfloat162float(v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (kBf16<T>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* out, float a, float b) {
  if constexpr (kBf16<T>) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  } else {
    out[0] = a;
    out[1] = b;
  }
}

// one 16-byte vector of x -> one of y
template <typename T, bool ERF>
__device__ __forceinline__ uint4 fwd_vec(uint4 xr) {
  const T* e = reinterpret_cast<const T*>(&xr);
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < 16 / int(sizeof(T)); k += 2) {
    float a = to_f(e[k]), b = to_f(e[k + 1]);
    fwd2<T, ERF>(a, b);
    store2(o + k, a, b);
  }
  return res;
}

// one 16-byte vector each of x and dy -> one of dx
template <typename T, bool ERF>
__device__ __forceinline__ uint4 bwd_vec(uint4 xr, uint4 gr) {
  const T* xe = reinterpret_cast<const T*>(&xr);
  const T* ge = reinterpret_cast<const T*>(&gr);
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < 16 / int(sizeof(T)); k += 2) {
    store2(o + k, __fmul_rn(local_grad<ERF>(to_f(xe[k])), to_f(ge[k])),
           __fmul_rn(local_grad<ERF>(to_f(xe[k + 1])), to_f(ge[k + 1])));
  }
  return res;
}

template <typename T, bool ERF>
__global__ void __launch_bounds__(kThreads)
    vitrs_gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  for (long long i = first; i < nv; i += stride) {
    y4[i] = fwd_vec<T, ERF>(__ldg(x4 + i));
  }
  for (long long i = nv * V + first; i < n; i += stride) {
    float a = to_f(x[i]), b = a;
    fwd2<T, ERF>(a, b);
    y[i] = from_f<T>(a);
  }
}

template <typename T, bool ERF>
__global__ void __launch_bounds__(kThreads)
    vitrs_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          T* __restrict__ dx, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* g4 = reinterpret_cast<const uint4*>(dy);
  uint4* d4 = reinterpret_cast<uint4*>(dx);
  for (long long i = first; i < nv; i += stride) {
    d4[i] = bwd_vec<T, ERF>(__ldg(x4 + i), __ldg(g4 + i));
  }
  for (long long i = nv * V + first; i < n; i += stride) {
    dx[i] = from_f<T>(__fmul_rn(local_grad<ERF>(to_f(x[i])), to_f(dy[i])));
  }
}

// blocks of kThreads, one 16-byte vector of T a thread, that cover n values
// (at least one), capped at kMaxBlocks
template <typename T>
int blocks_for(long long n) {
  const long long per_block = (long long)(16 / sizeof(T)) * kThreads;
  const long long b = (n + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b < kMaxBlocks ? b : kMaxBlocks));
}

template <typename T>
void launch_fwd(const void* x, void* y, long long n, int erf, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (erf) {
    vitrs_gelu_fwd_kernel<T, true><<<blocks_for<T>(n), kThreads, 0, s>>>(xt, yt, n);
  } else {
    vitrs_gelu_fwd_kernel<T, false><<<blocks_for<T>(n), kThreads, 0, s>>>(xt, yt, n);
  }
}

template <typename T>
void launch_bwd(const void* x, const void* dy, void* dx, long long n, int erf,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dt = static_cast<T*>(dx);
  if (erf) {
    vitrs_gelu_bwd_kernel<T, true><<<blocks_for<T>(n), kThreads, 0, s>>>(xt, gt, dt, n);
  } else {
    vitrs_gelu_bwd_kernel<T, false><<<blocks_for<T>(n), kThreads, 0, s>>>(xt, gt, dt, n);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; erf: 1 = the exact form, 0 = tanh.
// x, y (dy, dx) contiguous and 16-byte aligned, n values each (the wrapper
// checks).  Launch on `stream` without synchronising; return
// cudaGetLastError().
extern "C" int vitrs_gelu_fwd(const void* x, void* y, long long n, int dtype, int erf,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fwd<float>(x, y, n, erf, s);
  } else if (dtype == 1) {
    launch_fwd<bf16>(x, y, n, erf, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vitrs_gelu_bwd(const void* x, const void* dy, void* dx, long long n,
                              int dtype, int erf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(x, dy, dx, n, erf, s);
  } else if (dtype == 1) {
    launch_bwd<bf16>(x, dy, dx, n, erf, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
