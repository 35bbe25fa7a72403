// Native data loader: threaded JPEG decode -> center-crop -> bilinear resize.
//
// The PyTorch port's own copy of native/loader.cc, with the same C ABI
// (lg_loader_create / destroy / load / load_buffers, lg_decode_file): a
// persistent worker pool decoding whole batches in parallel with no Python
// GIL involvement, the host-side counterpart of the reference's tf.data C++
// runtime (reference dataset.py:19-27), consumed via ctypes
// (littlegan_tpu_torch/data/native_loader.py).
//
// Built at first use by native_loader.py into littlegan_tpu_torch/build/
// (g++ -O3 -march=native -std=c++17 -shared -fPIC ... -ljpeg -lpthread).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------- jpeg decode ----

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG byte buffer to packed RGB/gray. Returns true on success and
// fills width/height; the pixel vector is resized internally.
bool decode_jpeg(const uint8_t* data, size_t len, int channels,
                 std::vector<uint8_t>* pixels, int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  // NOTE: explicit jpeg_destroy_decompress on every path, no RAII guard —
  // libjpeg errors longjmp back here, and longjmp over frames with live
  // non-trivial destructors is undefined behavior.
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int c = cinfo.output_components;
  try {
    pixels->resize(static_cast<size_t>(w) * h * c);
  } catch (const std::bad_alloc&) {
    // corrupt header claiming a gigapixel image: fail the FILE without
    // leaking libjpeg's internal memory pool (destroy before unwinding)
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() + static_cast<size_t>(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *width = w;
  *height = h;
  return true;
}

// --------------------------------------------------- crop + bilinear resize --

// BYTE-EXACT port of Pillow's 8-bit BILINEAR resampling (Resample.c): the
// same double-precision triangle taps, the same int32 fixed-point coefficient
// quantization (PRECISION_BITS), the same uint8 intermediate between the
// horizontal and vertical passes, and the same clip8 rounding. This is what
// makes the native decode path byte-identical to the PIL fallback on
// non-square inputs (e.g. the official 178x218 aligned CelebA archive) —
// asserted in tests/test_data.py.
constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

static inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

struct FilterTaps {
  std::vector<int> start;    // first source index per output pixel
  std::vector<int> count;    // taps per output pixel
  std::vector<int32_t> weights;  // fixed-point, packed per output pixel
  int max_taps = 0;
};

FilterTaps build_triangle_taps(int in_size, int out_size) {
  FilterTaps taps;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support = 1
  taps.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  taps.start.resize(out_size);
  taps.count.resize(out_size);
  taps.weights.assign(static_cast<size_t>(out_size) * taps.max_taps, 0);
  std::vector<double> k(taps.max_taps);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > in_size) hi = in_size;
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double x = (j + 0.5 - center) / filterscale;
      if (x < 0) x = -x;
      k[j - lo] = (x < 1.0) ? 1.0 - x : 0.0;
      total += k[j - lo];
    }
    for (int j = 0; j < hi - lo; ++j) {
      if (total != 0.0) k[j] /= total;
      // Pillow normalize_coeffs_8bpc: round-half-away-from-zero into int32
      const double v = k[j] * (1 << kPrecisionBits);
      taps.weights[static_cast<size_t>(i) * taps.max_taps + j] =
          static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
    taps.start[i] = lo;
    taps.count[i] = hi - lo;
  }
  return taps;
}

void crop_resize(const uint8_t* src, int w, int h, int channels, int dim,
                 uint8_t* dst) {
  const int s = (w < h) ? w : h;
  const int x0 = (w - s) / 2, y0 = (h - s) / 2;
  if (s == dim) {  // fast path: already target size after crop
    for (int y = 0; y < dim; ++y) {
      std::memcpy(dst + static_cast<size_t>(y) * dim * channels,
                  src + (static_cast<size_t>(y + y0) * w + x0) * channels,
                  static_cast<size_t>(dim) * channels);
    }
    return;
  }
  const FilterTaps hx = build_triangle_taps(s, dim);
  const FilterTaps& vy = hx;  // square crop: both axes use identical taps
  // pass 1: horizontal (s rows x dim cols), uint8 intermediate — Pillow
  // quantizes between passes for 8bpc images; keeping f32 here would break
  // byte-parity with the PIL fallback
  std::vector<uint8_t> tmp(static_cast<size_t>(s) * dim * channels);
  for (int y = 0; y < s; ++y) {
    const uint8_t* row = src + (static_cast<size_t>(y + y0) * w + x0) * channels;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * dim * channels;
    for (int x = 0; x < dim; ++x) {
      const int32_t* wgt = hx.weights.data() + static_cast<size_t>(x) * hx.max_taps;
      for (int ch = 0; ch < channels; ++ch) {
        int acc = 1 << (kPrecisionBits - 1);
        for (int t = 0; t < hx.count[x]; ++t) {
          acc += wgt[t] * row[(hx.start[x] + t) * channels + ch];
        }
        trow[x * channels + ch] = clip8(acc);
      }
    }
  }
  // pass 2: vertical
  for (int y = 0; y < dim; ++y) {
    const int32_t* wgt = vy.weights.data() + static_cast<size_t>(y) * vy.max_taps;
    uint8_t* out = dst + static_cast<size_t>(y) * dim * channels;
    for (int x = 0; x < dim; ++x) {
      for (int ch = 0; ch < channels; ++ch) {
        int acc = 1 << (kPrecisionBits - 1);
        for (int t = 0; t < vy.count[y]; ++t) {
          acc += wgt[t] * tmp[(static_cast<size_t>(vy.start[y] + t) * dim + x) * channels + ch];
        }
        out[x * channels + ch] = clip8(acc);
      }
    }
  }
}

// ---------------------------------------------------------------- threads ----

class WorkerPool {
 public:
  explicit WorkerPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Run(); });
    }
  }
  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
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
  std::vector<std::thread> workers_;
  bool stop_;
};

struct Loader {
  explicit Loader(int threads) : pool(threads) {}
  WorkerPool pool;
};

bool load_one(const char* path, int dim, int channels, uint8_t* out) try {
  // RAII close: the buffer allocation below can throw bad_alloc for a huge
  // file — the fd must not leak into the catch (a dataset of many corrupt
  // entries would otherwise exhaust descriptors across epochs)
  std::unique_ptr<FILE, int (*)(FILE*)> f(std::fopen(path, "rb"), std::fclose);
  if (!f) return false;
  std::fseek(f.get(), 0, SEEK_END);
  const long size = std::ftell(f.get());
  std::fseek(f.get(), 0, SEEK_SET);
  if (size <= 0) {  // unseekable/empty: ftell -1 would become SIZE_MAX below
    return false;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  const bool read_ok = std::fread(buf.data(), 1, buf.size(), f.get()) == buf.size();
  f.reset();
  if (!read_ok) return false;
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!decode_jpeg(buf.data(), buf.size(), channels, &pixels, &w, &h)) return false;
  crop_resize(pixels.data(), w, h, channels, dim, out);
  return true;
} catch (const std::exception&) {
  // e.g. bad_alloc from a corrupt header claiming a gigapixel image: count
  // the file as failed instead of std::terminate-ing the whole process from
  // an exception escaping a worker thread
  return false;
}

}  // namespace

extern "C" {

void* lg_loader_create(int threads) { return new Loader(threads > 0 ? threads : 1); }

void lg_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// Decode `n` files in parallel into `out` (n * dim * dim * channels bytes,
// NHWC). Returns the number of files that FAILED (0 = all good); failed
// slots are zero-filled.
int lg_loader_load(void* handle, const char** paths, int n, int dim,
                   int channels, uint8_t* out) {
  Loader* loader = static_cast<Loader*>(handle);
  std::atomic<int> failures(0);
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  const size_t item = static_cast<size_t>(dim) * dim * channels;
  for (int i = 0; i < n; ++i) {
    loader->pool.Submit([&, i] {
      uint8_t* dst = out + item * i;
      if (!load_one(paths[i], dim, channels, dst)) {
        std::memset(dst, 0, item);
        failures.fetch_add(1);
      }
      {
        // increment under the mutex: incrementing outside would let the
        // waiter observe done==n and destroy mu/cv while this worker is
        // still acquiring them
        std::lock_guard<std::mutex> lk(mu);
        if (done.fetch_add(1) + 1 == n) cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return failures.load();
}

// Decode `n` in-memory JPEG buffers in parallel into `out` (same layout and
// failure contract as lg_loader_load). This is the zip-archive ingestion
// path: Python reads member bytes out of the archive (cheap, IO-bound) and
// the pool decodes them without the GIL — no extraction to 200k files
// needed for the official img_align_celeba.zip.
int lg_loader_load_buffers(void* handle, const uint8_t** bufs,
                           const size_t* lens, int n, int dim, int channels,
                           uint8_t* out) {
  Loader* loader = static_cast<Loader*>(handle);
  std::atomic<int> failures(0);
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  const size_t item = static_cast<size_t>(dim) * dim * channels;
  for (int i = 0; i < n; ++i) {
    loader->pool.Submit([&, i] {
      uint8_t* dst = out + item * i;
      bool ok = false;
      try {
        std::vector<uint8_t> pixels;
        int w = 0, h = 0;
        if (decode_jpeg(bufs[i], lens[i], channels, &pixels, &w, &h)) {
          crop_resize(pixels.data(), w, h, channels, dim, dst);
          ok = true;
        }
      } catch (const std::exception&) {
        ok = false;  // bad_alloc from a corrupt gigapixel header
      }
      if (!ok) {
        std::memset(dst, 0, item);
        failures.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (done.fetch_add(1) + 1 == n) cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return failures.load();
}

// Single-image decode (no pool) — handy for tools/tests.
int lg_decode_file(const char* path, int dim, int channels, uint8_t* out) {
  return load_one(path, dim, channels, out) ? 0 : 1;
}

}  // extern "C"
