// U2S record store — native reader.
//
// TPU-native replacement for the reference's LMDB + lz4 + msgpack C stack
// (reference data/data.py:45-178 reads LMDB values that are lz4-compressed
// msgpack blobs). Instead of an LMDB B-tree we use a single mmap'd file with
// a flat index: the training access pattern is read-only, key-addressed,
// whole-value — a hash map over an mmap is both simpler and faster, and the
// OS page cache does the caching LMDB would.
//
// File layout (little-endian):
//   [0..4)   magic "U2S1"
//   [4..8)   u32 flags (bit0: index compressed — reserved, 0 for now)
//   [8..16)  u64 n_records
//   [16..24) u64 index_offset
//   [24..)   payloads (raw or LZ4-block-compressed)
//   index at index_offset, n_records entries:
//     u64 offset | u64 stored_len | u64 raw_len | u8 codec | u16 key_len | key
//   codec: 0 = raw, 1 = LZ4 block
//
// Exposed via a C ABI for ctypes (no pybind11 in the image). Batch reads
// decompress on a std::thread pool so the Python input pipeline can overlap
// decode with host→device transfer.
//
// Build: see uc2_torch/data/native_build.py (g++ -O3 -shared -fPIC, links
// system liblz4).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {
// liblz4 (system library; declared here to avoid needing dev headers)
int LZ4_decompress_safe(const char* src, char* dst, int srcSize, int dstCap);
int LZ4_compress_default(const char* src, char* dst, int srcSize, int dstCap);
int LZ4_compressBound(int inputSize);
}

namespace {

struct Entry {
  uint64_t offset;
  uint64_t stored_len;
  uint64_t raw_len;
  uint8_t codec;
};

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::unordered_map<std::string, Entry> index;
  std::unique_ptr<ThreadPool> pool;
};

uint64_t rd_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

int decode_one(const Store* s, const Entry& e, uint8_t* out, int64_t cap) {
  if ((int64_t)e.raw_len > cap) return -2;
  const uint8_t* src = s->base + e.offset;
  if (e.codec == 0) {
    std::memcpy(out, src, e.raw_len);
    return (int)e.raw_len;
  }
  int n = LZ4_decompress_safe(reinterpret_cast<const char*>(src),
                              reinterpret_cast<char*>(out),
                              (int)e.stored_len, (int)cap);
  return n < 0 ? -3 : n;
}

}  // namespace

extern "C" {

void* u2s_open(const char* path, int n_threads) {
  auto* s = new Store();
  s->fd = ::open(path, O_RDONLY);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  struct stat st;
  fstat(s->fd, &st);
  s->size = st.st_size;
  s->base = static_cast<const uint8_t*>(
      mmap(nullptr, s->size, PROT_READ, MAP_SHARED, s->fd, 0));
  if (s->base == MAP_FAILED || s->size < 24 ||
      std::memcmp(s->base, "U2S1", 4) != 0) {
    if (s->base != MAP_FAILED) munmap(const_cast<uint8_t*>(
        reinterpret_cast<const uint8_t*>(s->base)), s->size);
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  uint64_t n = rd_u64(s->base + 8);
  uint64_t idx = rd_u64(s->base + 16);
  const uint8_t* p = s->base + idx;
  s->index.reserve(n * 2);
  for (uint64_t i = 0; i < n; ++i) {
    Entry e;
    e.offset = rd_u64(p);
    e.stored_len = rd_u64(p + 8);
    e.raw_len = rd_u64(p + 16);
    e.codec = p[24];
    uint16_t klen = rd_u16(p + 25);
    std::string key(reinterpret_cast<const char*>(p + 27), klen);
    p += 27 + klen;
    s->index.emplace(std::move(key), e);
  }
  if (n_threads > 0) s->pool = std::make_unique<ThreadPool>(n_threads);
  return s;
}

void u2s_close(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return;
  s->pool.reset();
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

int64_t u2s_num_records(void* h) {
  return static_cast<Store*>(h)->index.size();
}

// -1 if missing
int64_t u2s_raw_len(void* h, const char* key) {
  auto* s = static_cast<Store*>(h);
  auto it = s->index.find(key);
  return it == s->index.end() ? -1 : (int64_t)it->second.raw_len;
}

// returns decoded length, or <0 on error
int64_t u2s_get(void* h, const char* key, uint8_t* out, int64_t cap) {
  auto* s = static_cast<Store*>(h);
  auto it = s->index.find(key);
  if (it == s->index.end()) return -1;
  return decode_one(s, it->second, out, cap);
}

// Parallel batch fetch: keys[i] -> outs[i] (each with capacity caps[i]).
// results[i] = decoded length or <0. Returns 0.
int u2s_batch_get(void* h, const char** keys, int n, uint8_t** outs,
                  const int64_t* caps, int64_t* results) {
  auto* s = static_cast<Store*>(h);
  if (!s->pool || n <= 2) {
    for (int i = 0; i < n; ++i) results[i] = u2s_get(h, keys[i], outs[i],
                                                     caps[i]);
    return 0;
  }
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    s->pool->submit([&, i] {
      results[i] = u2s_get(h, keys[i], outs[i], caps[i]);
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return 0;
}

// Collator support: pack n ragged row-major byte blobs into a padded batch
// buffer (dst row i at dst + i*stride, first nbytes[i] bytes copied, the
// rest left as the caller pre-initialized them). The big collate cost is
// the [nbb, 2048] fp32 feature copies — memcpy fanned across a thread pool
// (reference moves this work into DataLoader worker processes,
// pretrain.py:90; here it's one process + threads).
namespace {
ThreadPool* g_pack_pool = nullptr;
std::mutex g_pack_mu;
ThreadPool* pack_pool(int n_threads) {
  std::lock_guard<std::mutex> lk(g_pack_mu);
  if (!g_pack_pool && n_threads > 1) g_pack_pool = new ThreadPool(n_threads);
  return g_pack_pool;
}
}  // namespace

int u2s_pack(const uint8_t** srcs, const int64_t* nbytes, int n,
             uint8_t* dst, int64_t stride, int n_threads) {
  ThreadPool* pool = pack_pool(n_threads);
  if (!pool || n <= 2) {
    for (int i = 0; i < n; ++i)
      if (nbytes[i] > 0) std::memcpy(dst + i * stride, srcs[i], nbytes[i]);
    return 0;
  }
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      if (nbytes[i] > 0) std::memcpy(dst + i * stride, srcs[i], nbytes[i]);
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return 0;
}

// Writer-side compression helpers (used by the Python writer via ctypes).
int u2s_lz4_bound(int n) { return LZ4_compressBound(n); }
int u2s_lz4_compress(const uint8_t* src, int n, uint8_t* dst, int cap) {
  return LZ4_compress_default(reinterpret_cast<const char*>(src),
                              reinterpret_cast<char*>(dst), n, cap);
}
int u2s_lz4_decompress(const uint8_t* src, int n, uint8_t* dst, int cap) {
  return LZ4_decompress_safe(reinterpret_cast<const char*>(src),
                             reinterpret_cast<char*>(dst), n, cap);
}

}  // extern "C"
