// Native trajectory log writer — the host-side IO runtime of the framework.
//
// Role parity: the reference ships trajectory logging through 8 Python
// multiprocessing workers calling np.savez_compressed (experience.py:352-489).
// Here the writer is a C++ thread pool with zlib-compressed chunked records,
// so host IO never contends with the Python thread feeding the device's step
// stream. Exposed to Python via a C ABI (ctypes; see native/__init__.py),
// with a pure-numpy fallback when the shared object is unavailable. The
// JAX package carries the same source; the two write the same bytes.
//
// File format (".itraj"): per record
//   [u32 magic 'ITRJ'] [u32 name_len] [name bytes]
//   [u32 ndim] [u64 dims...] [u32 dtype_code] [u64 raw_len] [u64 comp_len]
//   [compressed bytes]
// Readers: native/__init__.py read_trajectory().

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::string name;
  std::vector<uint64_t> dims;
  uint32_t dtype_code;  // 0=f32 1=f64 2=i32 3=i64 4=u8 5=bool
  std::vector<uint8_t> data;
};

struct Job {
  std::string path;
  std::vector<Array> arrays;
};

class WriterPool {
 public:
  explicit WriterPool(int n_threads) : stop_(false), pending_(0) {
    for (int i = 0; i < n_threads; ++i)
      threads_.emplace_back([this] { Loop(); });
  }

  ~WriterPool() { Shutdown(); }

  void Submit(Job&& job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push_back(std::move(job));
      ++pending_;
    }
    cv_.notify_one();
  }

  void Drain() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  void Shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
  }

  int64_t written() const { return written_.load(); }

 private:
  void Loop() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (jobs_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(jobs_.front());
        jobs_.pop_front();
      }
      WriteFile(job);
      {
        std::lock_guard<std::mutex> lk(mu_);
        --pending_;
      }
      done_cv_.notify_all();
    }
  }

  void WriteFile(const Job& job) {
    std::string tmp = job.path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return;
    for (const auto& a : job.arrays) {
      uLongf comp_cap = compressBound(a.data.size());
      std::vector<uint8_t> comp(comp_cap);
      uLongf comp_len = comp_cap;
      if (compress2(comp.data(), &comp_len, a.data.data(), a.data.size(), 4) != Z_OK)
        continue;
      uint32_t magic = 0x4A525449;  // 'ITRJ'
      uint32_t name_len = static_cast<uint32_t>(a.name.size());
      uint32_t ndim = static_cast<uint32_t>(a.dims.size());
      uint64_t raw_len = a.data.size();
      uint64_t clen = comp_len;
      std::fwrite(&magic, 4, 1, f);
      std::fwrite(&name_len, 4, 1, f);
      std::fwrite(a.name.data(), 1, name_len, f);
      std::fwrite(&ndim, 4, 1, f);
      std::fwrite(a.dims.data(), 8, ndim, f);
      std::fwrite(&a.dtype_code, 4, 1, f);
      std::fwrite(&raw_len, 8, 1, f);
      std::fwrite(&clen, 8, 1, f);
      std::fwrite(comp.data(), 1, comp_len, f);
    }
    std::fclose(f);
    std::rename(tmp.c_str(), job.path.c_str());  // atomic publish
    ++written_;
  }

  std::vector<std::thread> threads_;
  std::deque<Job> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  bool stop_;
  int pending_;
  std::atomic<int64_t> written_{0};
};

thread_local Job* g_building = nullptr;

}  // namespace

extern "C" {

void* trajlog_create(int n_threads) { return new WriterPool(n_threads); }

void trajlog_destroy(void* pool) { delete static_cast<WriterPool*>(pool); }

void trajlog_begin(void* /*pool*/, const char* path) {
  delete g_building;
  g_building = new Job();
  g_building->path = path;
}

// dtype codes: 0=f32 1=f64 2=i32 3=i64 4=u8 5=bool
void trajlog_add_array(void* /*pool*/, const char* name, const void* data,
                       const uint64_t* dims, uint32_t ndim, uint32_t dtype_code,
                       uint64_t nbytes) {
  if (!g_building) return;
  Array a;
  a.name = name;
  a.dims.assign(dims, dims + ndim);
  a.dtype_code = dtype_code;
  a.data.assign(static_cast<const uint8_t*>(data),
                static_cast<const uint8_t*>(data) + nbytes);
  g_building->arrays.push_back(std::move(a));
}

void trajlog_commit(void* pool) {
  if (!g_building) return;
  static_cast<WriterPool*>(pool)->Submit(std::move(*g_building));
  delete g_building;
  g_building = nullptr;
}

void trajlog_drain(void* pool) { static_cast<WriterPool*>(pool)->Drain(); }

int64_t trajlog_written(void* pool) {
  return static_cast<WriterPool*>(pool)->written();
}

}  // extern "C"
