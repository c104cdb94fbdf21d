// Native checkpoint I/O — the host-side analogue of the reference's arena
// reader (train_vit.rs:89-143 seek(1024) + read_exact of num_parameters f32s
// and the save/load stubs at train_vit.rs:715-735, completed here).
//
// Multi-threaded pread/pwrite over chunk ranges: checkpoint payloads at
// GPT-2-124M scale are ~0.5 GB and a single read() leaves NVMe/page-cache
// bandwidth on the table.  Called from Python via ctypes on plain buffers.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kChunk = 8ll << 20;  // 8 MiB per I/O op

bool pread_range(int fd, uint8_t* dst, int64_t offset, int64_t len) {
  while (len > 0) {
    ssize_t r = pread(fd, dst, (size_t)(len < kChunk ? len : kChunk), offset);
    if (r <= 0) return false;
    dst += r;
    offset += r;
    len -= r;
  }
  return true;
}

bool pwrite_range(int fd, const uint8_t* src, int64_t offset, int64_t len) {
  while (len > 0) {
    ssize_t w = pwrite(fd, src, (size_t)(len < kChunk ? len : kChunk), offset);
    if (w <= 0) return false;
    src += w;
    offset += w;
    len -= w;
  }
  return true;
}

template <typename Fn>
int parallel_ranges(int64_t total, int nthreads, Fn fn) {
  int nt = nthreads > 0 ? nthreads : 1;
  int64_t per = (total + nt - 1) / nt;
  if (per < kChunk) nt = (int)((total + kChunk - 1) / kChunk);
  if (nt < 1) nt = 1;
  per = (total + nt - 1) / nt;
  std::vector<std::thread> threads;
  std::vector<int> ok((size_t)nt, 1);
  for (int t = 0; t < nt; ++t) {
    int64_t off = t * per;
    int64_t len = off + per <= total ? per : (total > off ? total - off : 0);
    if (len <= 0) break;
    threads.emplace_back([&, t, off, len]() { ok[(size_t)t] = fn(off, len) ? 1 : 0; });
  }
  for (auto& th : threads) th.join();
  for (size_t t = 0; t < ok.size(); ++t)
    if (!ok[t]) return 1;
  return 0;
}

}  // namespace

extern "C" {

// Read [offset, offset+nbytes) of `path` into out. Returns 0 on success.
int vitrs_read_range(const char* path, int64_t offset, int64_t nbytes,
                     uint8_t* out, int nthreads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 2;
  int rc = parallel_ranges(nbytes, nthreads, [&](int64_t off, int64_t len) {
    return pread_range(fd, out + off, offset + off, len);
  });
  close(fd);
  return rc;
}

// Write `nbytes` from src at [offset, ...) of `path` (file must exist and be
// pre-sized by the caller, e.g. via ftruncate/vitrs_alloc_file).
int vitrs_write_range(const char* path, int64_t offset, int64_t nbytes,
                      const uint8_t* src, int nthreads) {
  int fd = open(path, O_WRONLY);
  if (fd < 0) return 2;
  int rc = parallel_ranges(nbytes, nthreads, [&](int64_t off, int64_t len) {
    return pwrite_range(fd, src + off, offset + off, len);
  });
  close(fd);
  return rc;
}

// Create/resize a file to `size` bytes. Returns 0 on success.
int vitrs_alloc_file(const char* path, int64_t size) {
  int fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return 2;
  int rc = ftruncate(fd, size) == 0 ? 0 : 3;
  close(fd);
  return rc;
}

int64_t vitrs_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return (int64_t)st.st_size;
}

int vitrs_ckptio_abi() { return 1; }

}  // extern "C"
