// K7: fused AdamW over the flat fp32 parameter vector, written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel of vitrs_tpu/ops/fused_adamw.py (adamw_pallas,
// body _adamw_kernel): in place, for every element,
//   m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g;
//   p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
// with the bias corrections bc = 1 - exp(t log b) as the Pallas body forms
// them (fused_adamw.py:37-38).  g is fp32 or bf16, read as fp32.  The TPU
// kernel pads the vector to (rows, 128) blocks; here a grid-stride loop
// covers any n, four elements per thread per step, and a scalar loop takes
// the ragged tail.
//
// What bounds it on the H100: 7 streams of 4 bytes per element (read p, g,
// m, v; write p, m, v) and about 15 flops, so device memory bandwidth; at
// n = 124,439,808 that is 3.5 GB per step.  Each thread moves 16 bytes per
// stream per step (float4).  Every operation is written with the
// round-to-nearest intrinsics, in the order of the Pallas body, so that the
// compiler does not contract products into FMAs and the kernel gives what
// the plain PyTorch version gives, operation by operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Hyper {
  float lr, b1, c1, b2, c2, eps, wd, bc1, bc2;  // c = 1 - b, bc = bias correction
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mhat = __fdiv_rn(m, h.bc1);
  const float vhat = __fdiv_rn(v, h.bc2);
  const float step = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
                               __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, step));
}

template <typename G>
__global__ void adamw(float* p, const G* g, float* m, float* v, long long n, Hyper h,
                      float t, float log_b1, float log_b2, int vec) {
  h.bc1 = __fsub_rn(1.f, expf(__fmul_rn(t, log_b1)));
  h.bc2 = __fsub_rn(1.f, expf(__fmul_rn(t, log_b2)));
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if (vec) {
    head = n / 4 * 4;
    for (long long i = first; i < n / 4; i += stride) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      float gg[4];
      if constexpr (sizeof(G) == 4) {
        const float4 g4 = reinterpret_cast<const float4*>(g)[i];
        gg[0] = g4.x; gg[1] = g4.y; gg[2] = g4.z; gg[3] = g4.w;
      } else {
        const uint2 raw = reinterpret_cast<const uint2*>(g)[i];
        const G* e = reinterpret_cast<const G*>(&raw);
        for (int k = 0; k < 4; ++k) gg[k] = to_f(e[k]);
      }
      update(pp.x, gg[0], mm.x, vv.x, h);
      update(pp.y, gg[1], mm.y, vv.y, h);
      update(pp.z, gg[2], mm.z, vv.z, h);
      update(pp.w, gg[3], mm.w, vv.w, h);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
  }
  for (long long i = head + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    update(pp, to_f(g[i]), mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// g_dtype: 0 = float32, 1 = bfloat16.  vec = 1 when p, m, v and g are
// 16-byte (g bf16: 8-byte) aligned, so that the float4 path may run.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vitrs_adamw(int g_dtype, float* p, const void* g, float* m, float* v,
                           long long n, float t, float lr, float b1, float c1, float log_b1,
                           float b2, float c2, float log_b2, float eps, float wd, int vec,
                           int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{lr, b1, c1, b2, c2, eps, wd, 0.f, 0.f};
  if (g_dtype == 0) {
    adamw<float><<<blocks, 256, 0, s>>>(p, static_cast<const float*>(g), m, v, n, h, t,
                                        log_b1, log_b2, vec);
  } else if (g_dtype == 1) {
    adamw<bf16><<<blocks, 256, 0, s>>>(p, static_cast<const bf16*>(g), m, v, n, h, t,
                                       log_b1, log_b2, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
