// Native multithreaded image-decode pipeline for the data layer: the
// port's copy of selfocc_tpu/native/loader.cpp, unchanged below this
// comment.
//
// The reference's per-sample hot loop decodes up to 24 full-resolution JPEGs
// on the Python side (SURVEY §3 hot loop #5: mmcv imread in
// dataset_one_frame_sweeps_dist.py:305-313). This library replaces it with a
// persistent C++ thread pool doing libjpeg/libpng decode + top-left crop +
// optional bilinear resize + optional (mean, std, BGR->RGB) normalization,
// writing float32 HWC directly into caller-provided numpy buffers (zero
// Python-side copies). Exposed through ctypes
// (selfocc_tpu_torch/native/__init__.py) with a cv2 fallback when the shared
// object cannot be built.
//
// Build: on first import of selfocc_tpu_torch.native, g++ -O3 -march=native
// -fPIC -std=c++17 -Wall -shared ... -ljpeg -lpng -lpthread into
// selfocc_tpu_torch/_build/libselfocc_loader.so (no pybind11, no nvcc).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>
#include <png.h>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- decoding
struct Image {
  std::vector<uint8_t> data;  // HWC, RGB order, 8-bit
  int h = 0, w = 0, c = 0;
  bool ok = false;
};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

Image decode_jpeg(const uint8_t* buf, size_t len) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.c = 3;
  img.data.resize(size_t(img.h) * img.w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data.data() + size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

struct PngReadCtx {
  const uint8_t* buf;
  size_t len, pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (ctx->pos + n > ctx->len) {
    png_error(png, "png: read past end");
  }
  std::memcpy(out, ctx->buf + ctx->pos, n);
  ctx->pos += n;
}

Image decode_png(const uint8_t* buf, size_t len) {
  Image img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  PngReadCtx ctx{buf, len, 0};
  png_set_read_fn(png, &ctx, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  img.c = 3;
  img.data.resize(size_t(img.h) * img.w * 3);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; ++y)
    rows[y] = img.data.data() + size_t(y) * img.w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  return img;
}

Image decode_file(const char* path) {
  Image img;
  FILE* f = std::fopen(path, "rb");
  if (!f) return img;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len <= 4) {
    std::fclose(f);
    return img;
  }
  std::vector<uint8_t> buf(len);
  size_t got = std::fread(buf.data(), 1, len, f);
  std::fclose(f);
  if (got != size_t(len)) return img;
  if (buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf.data(), len);
  if (buf[0] == 0x89 && buf[1] == 'P') return decode_png(buf.data(), len);
  return img;
}

// ------------------------------------------------------ crop/resize/convert
// out: float32 HWC, out_h x out_w x 3. Pipeline: top-left crop to
// (crop_h, crop_w) [matching the reference's img[:H, :W] crop], bilinear
// resize to (out_h, out_w) when different, channel order swap (RGB->BGR by
// default to match cv2/mmcv), then (x - mean) / std.
void postprocess(const Image& img, int crop_h, int crop_w, int out_h,
                 int out_w, bool to_bgr, const float* mean, const float* std_,
                 float pad_val, float* out) {
  const int ch = crop_h > 0 ? std::min(crop_h, img.h) : img.h;
  const int cw = crop_w > 0 ? std::min(crop_w, img.w) : img.w;
  const int oh = out_h > 0 ? out_h : ch;
  const int ow = out_w > 0 ? out_w : cw;
  const bool resize = (oh != ch) || (ow != cw);
  const float sy = resize ? float(ch) / oh : 1.0f;
  const float sx = resize ? float(cw) / ow : 1.0f;

  for (int y = 0; y < oh; ++y) {
    float fy = resize ? (y + 0.5f) * sy - 0.5f : float(y);
    int y0 = int(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, ch - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < ow; ++x) {
      float fx = resize ? (x + 0.5f) * sx - 0.5f : float(x);
      int x0 = int(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, cw - 1);
      x0 = std::max(x0, 0);
      float* dst = out + (size_t(y) * ow + x) * 3;
      for (int c = 0; c < 3; ++c) {
        int sc = to_bgr ? 2 - c : c;  // decoded buffer is RGB
        float v;
        if (y < ch && x < cw) {
          auto at = [&](int yy, int xx) {
            return float(img.data[(size_t(yy) * img.w + xx) * 3 + sc]);
          };
          v = (1 - wy) * ((1 - wx) * at(y0, x0) + wx * at(y0, x1)) +
              wy * ((1 - wx) * at(y1, x0) + wx * at(y1, x1));
        } else {
          v = pad_val;
        }
        if (mean) v = (v - mean[c]) / std_[c];
        dst[c] = v;
      }
    }
  }
}

// --------------------------------------------------------------- threadpool
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { this->run(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(std::move(fn));
      ++pending_;
    }
    cv_.notify_one();
  }
  void wait_all() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

 private:
  void run() {
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
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  int pending_ = 0;
  bool stop_;
};

}  // namespace

// -------------------------------------------------------------------- C API
extern "C" {

void* loader_create(int num_threads) {
  return new ThreadPool(num_threads > 0 ? num_threads
                                        : std::thread::hardware_concurrency());
}

void loader_destroy(void* h) { delete static_cast<ThreadPool*>(h); }

// Decode a batch of images into a pre-allocated float32 buffer of shape
// (n, out_h, out_w, 3). paths: array of n C strings. mean/std: 3 floats each
// or NULL for raw pixel values. Returns the number of successfully decoded
// images.
int loader_decode_batch(void* h, const char** paths, int n, int crop_h,
                        int crop_w, int out_h, int out_w, int to_bgr,
                        const float* mean, const float* std_, float pad_val,
                        float* out) {
  auto* pool = static_cast<ThreadPool*>(h);
  std::atomic<int> ok{0};
  const size_t stride = size_t(out_h > 0 ? out_h : crop_h) *
                        size_t(out_w > 0 ? out_w : crop_w) * 3;
  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    float* dst = out + size_t(i) * stride;
    pool->submit([=, &ok] {
      Image img = decode_file(path);
      if (!img.ok) return;
      postprocess(img, crop_h, crop_w, out_h, out_w, to_bgr != 0, mean, std_,
                  pad_val, dst);
      ok.fetch_add(1);
    });
  }
  pool->wait_all();
  return ok.load();
}

// Probe an image's dimensions without full decode post-processing.
int loader_image_shape(const char* path, int* h, int* w) {
  Image img = decode_file(path);
  if (!img.ok) return 0;
  *h = img.h;
  *w = img.w;
  return 1;
}

}  // extern "C"
