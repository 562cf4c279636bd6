// Native relation IO: parallel raw-u32 file reader/writer + checksums.
//
// The reference loads relations with single-threaded fread into 64B-aligned
// buffers (phj.cpp:2077-2111) and verifies them with per-thread key
// checksums reduced to a global sum (write.cpp:1635-1645, hj.h:28-29).
// Multi-hundred-million-row relations make the host IO path part of the
// measured pipeline, so the loader/writer here stripe the file across
// threads with pread/pwrite; the checksum is the same u64 wraparound sum of
// u32 words the reference computes.
//
// Exposed via ctypes (native/__init__.py); numpy fromfile/tofile is the
// portable fallback (relation.py).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMinStripe = 8u << 20;  // don't spawn threads under 8 MB

int for_each_stripe(uint64_t bytes, int threads,
                    const std::function<int(uint64_t, uint64_t)>& fn) {
  if (threads < 2 || bytes <= kMinStripe) return fn(0, bytes);
  uint64_t stripe = (bytes + threads - 1) / threads;
  stripe = (stripe + 4095) & ~uint64_t(4095);  // page-align stripes
  std::vector<std::thread> pool;
  std::vector<int> rcs((bytes + stripe - 1) / stripe, 0);
  for (uint64_t i = 0, off = 0; off < bytes; ++i, off += stripe) {
    uint64_t len = std::min(stripe, bytes - off);
    pool.emplace_back([&, i, off, len] { rcs[i] = fn(off, len); });
  }
  for (auto& t : pool) t.join();
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

}  // namespace

extern "C" {

// Read n uint32 words from path into dst.  Returns 0 on success, -1 on
// open failure, -2 on short read / wrong file size.
int hjk_read_u32(const char* path, uint32_t* dst, uint64_t n, int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < n * 4) {
    close(fd);
    return -2;
  }
  int rc = for_each_stripe(n * 4, threads, [&](uint64_t off, uint64_t len) {
    char* p = reinterpret_cast<char*>(dst) + off;
    uint64_t done = 0;
    while (done < len) {
      ssize_t r = pread(fd, p + done, len - done, off + done);
      if (r < 0 && errno == EINTR) continue;  // signal mid-read: retry
      if (r <= 0) return -2;
      done += (uint64_t)r;
    }
    return 0;
  });
  close(fd);
  return rc;
}

// Write n uint32 words to path.  Returns 0 on success, -1 on open
// failure, -3 on short write.
int hjk_write_u32(const char* path, const uint32_t* src, uint64_t n,
                  int threads) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (ftruncate(fd, (off_t)(n * 4)) != 0) {
    close(fd);
    return -3;
  }
  int rc = for_each_stripe(n * 4, threads, [&](uint64_t off, uint64_t len) {
    const char* p = reinterpret_cast<const char*>(src) + off;
    uint64_t done = 0;
    while (done < len) {
      ssize_t w = pwrite(fd, p + done, len - done, off + done);
      if (w < 0 && errno == EINTR) continue;  // signal mid-write: retry
      if (w <= 0) return -3;
      done += (uint64_t)w;
    }
    return 0;
  });
  close(fd);
  return rc;
}

// u64 wraparound sum of u32 words (write.cpp:1635-1645 checksum semantics),
// parallel tree reduction.
uint64_t hjk_checksum_u32(const uint32_t* a, uint64_t n, int threads) {
  if (threads < 2 || n < (kMinStripe / 4)) {
    uint64_t s = 0;
    for (uint64_t i = 0; i < n; ++i) s += a[i];
    return s;
  }
  std::vector<std::thread> pool;
  std::vector<uint64_t> sums(threads, 0);
  uint64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    uint64_t beg = std::min(n, (uint64_t)t * chunk);
    uint64_t end = std::min(n, beg + chunk);
    pool.emplace_back([&, t, beg, end] {
      uint64_t s = 0;
      for (uint64_t i = beg; i < end; ++i) s += a[i];
      sums[t] = s;
    });
  }
  for (auto& t : pool) t.join();
  uint64_t s = 0;
  for (uint64_t v : sums) s += v;
  return s;
}

}  // extern "C"
