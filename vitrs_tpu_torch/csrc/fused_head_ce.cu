// K8: the GPT head matmul with the cross-entropy statistics folded into its
// epilogue, written for Hopper (sm_90a).
//
// Replaces vitrs_tpu/ops/fused_head_ce.py _head_ce_fwd (kernel _kernel):
//   logits = x . w^T            x (R, C), w (Vp, C) the padded tied head,
//                               fp32 accumulation of the input-type products,
//                               written rounded to the input type;
//   lse    = logsumexp over the first real_vocab columns of the fp32 tile;
//   picked = the target column of the fp32 tile.
// So in bf16 the loss differs slightly from the two-op path, whose K5 reads
// the rounded logits; each is held to its own plain version.
//
// What is not carried over: the TPU grid sweeps the vocab sequentially per
// 2048-row panel (BLOCK_R = 2048), carrying an online (max, sumexp, picked)
// in VMEM from one grid step to the next.  At R = 8192-16384 that is 4-8
// blocks against the H100's 132 SMs, and Hopper blocks cannot carry state
// from one to the next.  Here the grid is 2-D over (row tile, vocab tile):
// each block computes one logits tile, writes it, and writes its rows'
// partial (max, sumexp) over its vocab tile; the owner of a row's target
// column writes picked directly.  A second, small launch merges the
// partials into lse (and writes NaN as picked for a target outside
// [0, real_vocab), as K5 does).  Row tiles run fastest along the grid, so
// the blocks in flight share a few vocab tiles of w and all of x (12.6 MB at
// R = 8192, C = 768) stays in the 50 MB L2: w is read from device memory
// about once.
//
// What bounds it on the H100: at R = 8192, C = 768, Vp = 50304 the product
// is 2 R C Vp = 633 GFLOP, 0.640 ms at 989 TFLOP/s bf16, against 0.27 ms
// for its bytes (824 MB of bf16 logits written, 77 MB of w read): compute.
// The bf16 instance runs the product on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulate): 128 x 128 block tiles, 8 warps of 64 x 32,
// k chunks of 32 staged in shared memory with rows padded to 40 elements
// (conflict-free fragment reads), plain 16-byte loads without double
// buffering.  That is a simple GEMM, expected well behind cuBLAS: wgmma,
// TMA and a pipelined persistent schedule are later work.  The fp32
// instance (a cross-check against the plain version at fp32 accuracy) does
// its products with FMA, 64 x 64 tiles, 4 x 4 outputs a thread.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace vitrs;

struct Args {
  const void* x;        // (rows, C) row-major
  const void* w;        // (Vp, C) row-major
  const long long* targets;  // (rows,)
  void* logits;         // (rows, Vp), the input type
  float* part_m;        // (rows, n_tiles) partial max of each vocab tile
  float* part_s;        // (rows, n_tiles) partial sum of exp(x - part_m)
  float* lse;           // (rows,)
  float* picked;        // (rows,)
  int rows, C, Vp, real_vocab, n_tiles;
};

// merge (m2, s2) into (m, s): sums of exp(x - m) over two sets
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// ---------------------------------------------------------------------------
// bf16 instance: tensor cores, 128 x 128 tiles, 8 warps (2 along rows x 4
// along the vocab), each 64 x 32 = 4 x 4 mma tiles.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32, kLd = kBK + 8;

__global__ void __launch_bounds__(256) head_ce_mma(Args a) {
  __shared__ __align__(16) bf16 xs[kBM][kLd];
  __shared__ __align__(16) bf16 ws[kBN][kLd];
  __shared__ float red_m[4][kBM], red_s[4][kBM];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const bf16* X = static_cast<const bf16*>(a.x);
  const bf16* W = static_cast<const bf16*>(a.w);

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  for (int k0 = 0; k0 < a.C; k0 += kBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += blockDim.x) {
      const int r = i >> 2, c = (i & 3) * 8;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < a.rows)
        xv = *reinterpret_cast<const uint4*>(X + (long long)(m0 + r) * a.C + k0 + c);
      *reinterpret_cast<uint4*>(&xs[r][c]) = xv;
      *reinterpret_cast<uint4*>(&ws[r][c]) =
          *reinterpret_cast<const uint4*>(W + (long long)(n0 + r) * a.C + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r][c + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* wr = &ws[wn * 32 + ni * 8 + g][c];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }

  // epilogue: store the tile rounded to bf16; per row, the fp32 max and sum
  // of exp over this warp's 32 columns (pad columns >= real_vocab left out),
  // then over the block's 128 through shared memory
  bf16* L = static_cast<bf16*>(a.logits);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 64 + mi * 16 + g + 8 * h, row = m0 + rl;
      const bool live = row < a.rows;
      const long long tgt = live ? a.targets[row] : -1;
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (live) {
          *reinterpret_cast<__nv_bfloat162*>(L + (long long)row * a.Vp + col) =
              __floats2bfloat162_rn(v0, v1);
          if (col < a.real_vocab && col == tgt) a.picked[row] = v0;
          if (col + 1 < a.real_vocab && col + 1 == tgt) a.picked[row] = v1;
        }
        if (col < a.real_vocab) mx = fmaxf(mx, v0);
        if (col + 1 < a.real_vocab) mx = fmaxf(mx, v1);
      }
      mx = quad_max(mx);
      float s = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * t;
          if (col < a.real_vocab) s += expf(acc[mi][ni][2 * h] - mx);
          if (col + 1 < a.real_vocab) s += expf(acc[mi][ni][2 * h + 1] - mx);
        }
      }
      s = quad_sum(s);
      if (t == 0) {
        red_m[wn][rl] = mx;
        red_s[wn][rl] = s;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + threadIdx.x < a.rows) {
    float m = red_m[0][threadIdx.x], s = red_s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < 4; ++w) merge(m, s, red_m[w][threadIdx.x], red_s[w][threadIdx.x]);
    const long long idx = (long long)(m0 + threadIdx.x) * a.n_tiles + blockIdx.y;
    a.part_m[idx] = m;
    a.part_s[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// fp32 instance: FMA, 64 x 64 tiles, 256 threads of 4 x 4 outputs; k chunks
// of 16 staged transposed in shared memory.
// ---------------------------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(256) head_ce_fma(Args a) {
  __shared__ float xs[kFK][kFM + 4];
  __shared__ float ws[kFK][kFN + 4];
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* X = static_cast<const float*>(a.x);
  const float* W = static_cast<const float*>(a.w);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.C; k0 += kFK) {
    __syncthreads();
    {
      const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 4;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < a.rows)
        xv = *reinterpret_cast<const float4*>(X + (long long)(m0 + r) * a.C + k0 + c);
      const float4 wv = *reinterpret_cast<const float4*>(W + (long long)(n0 + r) * a.C + k0 + c);
      xs[c][r] = xv.x; xs[c + 1][r] = xv.y; xs[c + 2][r] = xv.z; xs[c + 3][r] = xv.w;
      ws[c][r] = wv.x; ws[c + 1][r] = wv.y; ws[c + 2][r] = wv.z; ws[c + 3][r] = wv.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float xr[4], wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = xs[kk][ty * 4 + i];
        wr[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
  }
  float* L = static_cast<float*>(a.logits);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const bool live = row < a.rows;
    const long long tgt = live ? a.targets[row] : -1;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (live) {
        L[(long long)row * a.Vp + col] = acc[i][j];
        if (col < a.real_vocab && col == tgt) a.picked[row] = acc[i][j];
      }
      if (col < a.real_vocab) mx = fmaxf(mx, acc[i][j]);
    }
    // the 16 threads of a row are 16 neighbouring lanes (tx)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + tx * 4 + j < a.real_vocab) s += expf(acc[i][j] - mx);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tx == 0 && live) {
      const long long idx = (long long)row * a.n_tiles + blockIdx.y;
      a.part_m[idx] = mx;
      a.part_s[idx] = s;
    }
  }
}

// one warp per row: lse from the row's partials; NaN as picked for a
// target outside [0, real_vocab)
__global__ void __launch_bounds__(256) head_ce_merge(Args a) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= a.rows) return;
  float m = -INFINITY, s = 0.f;
  for (int i = lane; i < a.n_tiles; i += 32) {
    const long long idx = (long long)row * a.n_tiles + i;
    merge(m, s, a.part_m[idx], a.part_s[idx]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (lane == 0) {
    a.lse[row] = m + logf(s);
    const long long tgt = a.targets[row];
    if (tgt < 0 || tgt >= a.real_vocab) a.picked[row] = NAN;
  }
}

}  // namespace

// The vocab tile of each instance: the partials hold Vp / tile columns.
extern "C" int vitrs_head_ce_tile(int dtype) { return dtype == 1 ? kBN : kFN; }

// dtype: 0 = float32 (FMA instance), 1 = bfloat16 (tensor-core instance).
// x (rows, C) and w (Vp, C) row-major and contiguous, 16-byte aligned, C a
// multiple of 32, Vp a multiple of the instance's vocab tile; logits
// (rows, Vp) in the input type; part_m, part_s (rows, Vp / tile) fp32
// scratch; lse, picked (rows,) fp32.  Launches two kernels on `stream`
// without synchronising; returns the first launch error.
extern "C" int vitrs_head_ce_fwd(int dtype, const void* x, const void* w,
                                 const long long* targets, int rows, int C, int Vp,
                                 int real_vocab, void* logits, float* part_m, float* part_s,
                                 float* lse, float* picked, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || C % 32 != 0 || real_vocab <= 0 ||
      real_vocab > Vp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = vitrs_head_ce_tile(dtype);
  if (Vp % tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, targets, logits, part_m, part_s, lse, picked, rows, C, Vp, real_vocab,
         Vp / tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    head_ce_mma<<<dim3((rows + kBM - 1) / kBM, Vp / kBN), 256, 0, s>>>(a);
  } else {
    head_ce_fma<<<dim3((rows + kFM - 1) / kFM, Vp / kFN), 256, 0, s>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_ce_merge<<<(rows + 7) / 8, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
