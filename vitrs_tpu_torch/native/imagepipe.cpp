// Host-side image decode/augment pipeline (native component).
//
// The reference's only host-side native work is arena I/O and scalar loops
// (SURVEY.md §2 native-component accounting); the TPU rebuild needs a real
// feeder: the TPU consumes batches faster than Python can crop/flip/normalize
// them, so the augment path is C++ with a pthread pool, called from Python
// via ctypes on plain buffers (no Python objects touched off-GIL).
//
// Determinism contract: every sample's augmentation randomness derives from
// splitmix64(seed, epoch, dataset_index) — a counter-based generator — so a
// resumed run (same seed/epoch/cursor) reproduces the exact same pixels
// regardless of thread scheduling (SURVEY.md §5.3 deterministic resume).
//
// Augmentations (CIFAR-style training recipe):
//   pad-with-reflect(crop_pad) -> random crop -> random horizontal flip
//   -> normalize ((x/255 - mean) / std) -> float32 NHWC
// crop_pad = 0 and flip = 0 give the deterministic eval transform.
//
// The PyTorch port's copy adds vitrs_augment_batch_u8: the same crop and
// flip with uint8 output and no normalisation (the train step normalises
// on the device), which the JAX package computes in NumPy; ABI 2.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// per-sample deterministic RNG stream
struct SampleRng {
  uint64_t state;
  SampleRng(uint64_t seed, uint64_t epoch, uint64_t index) {
    state = splitmix64(seed ^ splitmix64(epoch ^ splitmix64(index)));
  }
  uint64_t next() { return state = splitmix64(state); }
  // uniform integer in [0, n)
  uint32_t below(uint32_t n) { return n ? (uint32_t)(next() % n) : 0; }
};

// reflect-101 index into [0, n)
inline int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct Job {
  const uint8_t* images;   // (num_total, H, W, C) uint8
  const int64_t* indices;  // (n,) dataset indices to fetch
  float* out;              // (n, H, W, C) float32, or
  uint8_t* out_u8;         // (n, H, W, C) uint8 (no normalisation)
  int n, H, W, C;
  int crop_pad;            // reflect-pad then random-crop window
  int flip;                // 1 = random horizontal flip
  uint64_t seed, epoch;
  const float* mean;       // per-channel
  const float* stdv;       // per-channel
  std::atomic<int> next{0};
};

void worker(Job* job) {
  const int H = job->H, W = job->W, C = job->C, pad = job->crop_pad;
  std::vector<float> inv_std(C);
  if (job->stdv)
    for (int c = 0; c < C; ++c) inv_std[c] = 1.0f / job->stdv[c];
  for (;;) {
    int i = job->next.fetch_add(1, std::memory_order_relaxed);
    if (i >= job->n) return;
    const int64_t idx = job->indices[i];
    const uint8_t* src = job->images + (size_t)idx * H * W * C;
    float* dst = job->out ? job->out + (size_t)i * H * W * C : nullptr;
    uint8_t* dst_u8 =
        job->out_u8 ? job->out_u8 + (size_t)i * H * W * C : nullptr;
    SampleRng rng(job->seed, job->epoch, (uint64_t)idx);
    int dy = 0, dx = 0, do_flip = 0;
    if (pad > 0) {
      dy = (int)rng.below(2 * pad + 1) - pad;
      dx = (int)rng.below(2 * pad + 1) - pad;
    }
    if (job->flip) do_flip = (int)(rng.next() & 1);
    for (int y = 0; y < H; ++y) {
      const int sy = reflect(y + dy, H);
      for (int x = 0; x < W; ++x) {
        int sx = x + dx;
        if (do_flip) sx = W - 1 - sx;
        sx = reflect(sx, W);
        const uint8_t* p = src + ((size_t)sy * W + sx) * C;
        if (dst_u8) {
          std::memcpy(dst_u8 + ((size_t)y * W + x) * C, p, (size_t)C);
          continue;
        }
        float* q = dst + ((size_t)y * W + x) * C;
        for (int c = 0; c < C; ++c) {
          q[c] = ((float)p[c] * (1.0f / 255.0f) - job->mean[c]) * inv_std[c];
        }
      }
    }
  }
}

int run(Job& job, int nthreads) {
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt > job.n) nt = job.n;
  std::vector<std::thread> threads;
  threads.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker, &job);
  worker(&job);
  for (auto& th : threads) th.join();
  return 0;
}

}  // namespace

extern "C" {

// Fetch + augment a batch. Returns 0 on success.
int vitrs_augment_batch(const uint8_t* images, const int64_t* indices, int n,
                        int H, int W, int C, float* out, int crop_pad,
                        int flip, uint64_t seed, uint64_t epoch,
                        const float* mean, const float* stdv, int nthreads) {
  if (!images || !indices || !out || !mean || !stdv || n <= 0) return 1;
  Job job;
  job.images = images;
  job.indices = indices;
  job.out = out;
  job.out_u8 = nullptr;
  job.n = n;
  job.H = H;
  job.W = W;
  job.C = C;
  job.crop_pad = crop_pad;
  job.flip = flip;
  job.seed = seed;
  job.epoch = epoch;
  job.mean = mean;
  job.stdv = stdv;
  return run(job, nthreads);
}

// The geometry-only twin: crop + flip, uint8 in -> uint8 out, the same
// per-sample randomness. Returns 0 on success.
int vitrs_augment_batch_u8(const uint8_t* images, const int64_t* indices,
                           int n, int H, int W, int C, uint8_t* out,
                           int crop_pad, int flip, uint64_t seed,
                           uint64_t epoch, int nthreads) {
  if (!images || !indices || !out || n <= 0) return 1;
  Job job;
  job.images = images;
  job.indices = indices;
  job.out = nullptr;
  job.out_u8 = out;
  job.n = n;
  job.H = H;
  job.W = W;
  job.C = C;
  job.crop_pad = crop_pad;
  job.flip = flip;
  job.seed = seed;
  job.epoch = epoch;
  job.mean = nullptr;
  job.stdv = nullptr;
  return run(job, nthreads);
}

// Version/ABI probe for the ctypes binding.
int vitrs_imagepipe_abi() { return 2; }

}  // extern "C"
