// Native data loader: threaded JPEG decode + bilinear resize + normalize,
// and a parallel row-gather for epoch assembly.
//
// The reference feeds images through forked python DataLoader workers doing
// cv2.imread + resize per item (H36_dataset.py:78-131, train_1.py:51-52).
// This replaces that host pipeline: a C++ worker
// pool decodes JPEGs straight into the caller's pinned batch buffer in the
// reference's layout ((N, S, S, 3) float32 in [0,1), the resize-S + /256
// convention of H36_dataset.py:129-131), with no Python in the decode path.
//
// Exposed via a plain C ABI consumed by ctypes
// (pose3d_tpu_torch/data/native_loader.py). Build:
// pose3d_tpu_torch/native/build.sh, run by
// `python -m pose3d_tpu_torch.data.native_build`.

#include <cstdio>   // must precede jpeglib.h (it uses FILE unqualified)

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to tightly packed RGB8. Returns false on failure.
bool DecodeJpeg(const char* path, std::vector<uint8_t>* rgb, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize RGB8 (h,w) -> float32 (s,s,3) scaled by 1/256.
void ResizeNormalize(const uint8_t* src, int w, int h, int s, float* dst) {
  const float sx = float(w) / s, sy = float(h) / s;
  for (int y = 0; y < s; ++y) {
    // cv2-compatible half-pixel sampling
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : int(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : int(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = src + (size_t(y0) * w + x0) * 3;
      const uint8_t* p01 = src + (size_t(y0) * w + x1) * 3;
      const uint8_t* p10 = src + (size_t(y1) * w + x0) * 3;
      const uint8_t* p11 = src + (size_t(y1) * w + x1) * 3;
      float* out = dst + (size_t(y) * s + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + wx * (p01[c] - p00[c]);
        float bot = p10[c] + wx * (p11[c] - p10[c]);
        out[c] = (top + wy * (bot - top)) * (1.0f / 256.0f);
      }
    }
  }
}

class WorkerPool {
 public:
  explicit WorkerPool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      threads_.emplace_back([this] { Run(); });
    }
  }
  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        fn = std::move(queue_.front());
        queue_.pop();
      }
      fn();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> queue_;
  std::vector<std::thread> threads_;
  bool stop_;
};

struct Loader {
  int image_size;
  WorkerPool pool;
  Loader(int s, int n_threads) : image_size(s), pool(n_threads) {}
};

}  // namespace

extern "C" {

void* pl_create(int image_size, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  return new Loader(image_size, n_threads);
}

void pl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// Decode n JPEGs into out (n, S, S, 3) float32. Returns the number of
// successfully decoded images; failed slots are zero-filled.
int pl_decode_batch(void* handle, const char** paths, int n, float* out) {
  auto* loader = static_cast<Loader*>(handle);
  const int s = loader->image_size;
  const size_t item = size_t(s) * s * 3;
  std::atomic<int> ok{0};
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    loader->pool.Submit([&, i] {
      std::vector<uint8_t> rgb;
      int w = 0, h = 0;
      float* dst = out + size_t(i) * item;
      if (DecodeJpeg(paths[i], &rgb, &w, &h)) {
        ResizeNormalize(rgb.data(), w, h, s, dst);
        ok.fetch_add(1);
      } else {
        memset(dst, 0, item * sizeof(float));
      }
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return ok.load();
}

// Decode n JPEGs into out (n, S, S, 3) uint8 (no normalization — the /256
// happens on device, quartering host->HBM transfer volume).
int pl_decode_batch_u8(void* handle, const char** paths, int n, uint8_t* out) {
  auto* loader = static_cast<Loader*>(handle);
  const int s = loader->image_size;
  const size_t item = size_t(s) * s * 3;
  std::atomic<int> ok{0};
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    loader->pool.Submit([&, i] {
      std::vector<uint8_t> rgb;
      int w = 0, h = 0;
      uint8_t* dst = out + size_t(i) * item;
      if (DecodeJpeg(paths[i], &rgb, &w, &h)) {
        // bilinear resize straight to uint8
        const float sx = float(w) / s, sy = float(h) / s;
        for (int y = 0; y < s; ++y) {
          float fy = (y + 0.5f) * sy - 0.5f;
          int y0 = fy < 0 ? 0 : int(fy);
          int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
          float wy = fy - y0;
          if (wy < 0) wy = 0;
          for (int x = 0; x < s; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            int x0 = fx < 0 ? 0 : int(fx);
            int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
            float wx = fx - x0;
            if (wx < 0) wx = 0;
            const uint8_t* p00 = rgb.data() + (size_t(y0) * w + x0) * 3;
            const uint8_t* p01 = rgb.data() + (size_t(y0) * w + x1) * 3;
            const uint8_t* p10 = rgb.data() + (size_t(y1) * w + x0) * 3;
            const uint8_t* p11 = rgb.data() + (size_t(y1) * w + x1) * 3;
            uint8_t* o = dst + (size_t(y) * s + x) * 3;
            for (int c = 0; c < 3; ++c) {
              float top = p00[c] + wx * (p01[c] - p00[c]);
              float bot = p10[c] + wx * (p11[c] - p10[c]);
              o[c] = uint8_t(top + wy * (bot - top) + 0.5f);
            }
          }
        }
        ok.fetch_add(1);
      } else {
        memset(dst, 0, item);
      }
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return ok.load();
}

// Parallel row gather: dst[i] = src[idx[i]] for float32 rows.
void pl_gather_f32(const float* src, const int64_t* idx, int64_t n_idx,
                   int64_t row_elems, float* dst, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  const size_t row_bytes = size_t(row_elems) * sizeof(float);
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n_idx, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) {
        memcpy(dst + i * row_elems, src + idx[i] * row_elems, row_bytes);
      }
    });
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
