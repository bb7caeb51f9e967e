// Native data-loader runtime of the PyTorch port: threaded PNG decode ->
// box-resize -> [-1,1] float32 HWC, exposed over a C ABI for ctypes (an
// own copy of the JAX package's diff3d_tpu/native/decoder.cpp, the same
// decode and the same error codes).
//
// A persistent worker pool decodes whole view-batches without touching the
// Python GIL, so host-side input processing overlaps device compute.
// Bound in diff3d_tpu_torch/native/__init__.py; the PIL path of
// diff3d_tpu_torch/data/srn.py remains as the fallback.
//
// Decode semantics:
//   * 8/16-bit gray/palette/RGB/RGBA PNGs -> 8-bit RGB(A).
//   * box-filter (area-average) resize to size x size: the exact 2x2 mean
//     for the SRN 128->64 case, a fractional-weight area average
//     otherwise.  For RGBA sources the average is alpha-weighted
//     (premultiplied), then the alpha channel is dropped, as PIL's resize
//     followed by `[..., :3]` does.
//   * out = pixel/255 * 2 - 1, float32, HWC.

#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = 1;
constexpr int kErrNotPng = 2;
constexpr int kErrDecode = 3;
constexpr int kErrArgs = 4;

// ---------------------------------------------------------------- decode
struct Image {
  int w = 0, h = 0, ch = 3;   // ch: 3 (RGB) or 4 (RGBA)
  std::vector<uint8_t> px;    // w*h*ch
};

int decode_png_rgb(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return kErrOpen;
  uint8_t sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return kErrNotPng;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {  // libpng error path
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return kErrDecode;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  // Normalise every PNG flavour to 8-bit RGB.
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  out->w = static_cast<int>(png_get_image_width(png, info));
  out->h = static_cast<int>(png_get_image_height(png, info));
  out->ch = static_cast<int>(png_get_channels(png, info));
  if (out->ch != 3 && out->ch != 4) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return kErrDecode;
  }
  out->px.resize(static_cast<size_t>(out->w) * out->h * out->ch);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->px.data() + static_cast<size_t>(y) * out->w * out->ch;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// --------------------------------------------------------------- resize
// Area-average (box filter) resize to dst x dst, writing float32 RGB HWC
// in [-1, 1].  RGBA sources use alpha-weighted (premultiplied) averaging
// — PIL's RGBA resize semantics — then drop alpha.
void box_resize_normalize(const Image& img, int dst, float* out) {
  const bool has_alpha = img.ch == 4;
  const int ch = img.ch;
  const double sx = static_cast<double>(img.w) / dst;
  const double sy = static_cast<double>(img.h) / dst;
  for (int oy = 0; oy < dst; ++oy) {
    const double y0 = oy * sy, y1 = (oy + 1) * sy;
    const int iy0 = static_cast<int>(y0);
    const int iy1 = std::min(static_cast<int>(std::ceil(y1)), img.h);
    for (int ox = 0; ox < dst; ++ox) {
      const double x0 = ox * sx, x1 = (ox + 1) * sx;
      const int ix0 = static_cast<int>(x0);
      const int ix1 = std::min(static_cast<int>(std::ceil(x1)), img.w);
      double acc[3] = {0, 0, 0}, wsum = 0;
      for (int iy = iy0; iy < iy1; ++iy) {
        const double wy =
            std::min<double>(y1, iy + 1) - std::max<double>(y0, iy);
        const uint8_t* row =
            img.px.data() + (static_cast<size_t>(iy) * img.w + ix0) * ch;
        for (int ix = ix0; ix < ix1; ++ix, row += ch) {
          const double wx =
              std::min<double>(x1, ix + 1) - std::max<double>(x0, ix);
          // alpha-weighted area weight (PIL premultiplied semantics)
          const double w = wx * wy * (has_alpha ? row[3] / 255.0 : 1.0);
          acc[0] += w * row[0];
          acc[1] += w * row[1];
          acc[2] += w * row[2];
          wsum += w;
        }
      }
      float* px = out + (static_cast<size_t>(oy) * dst + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const double v = wsum > 0 ? acc[c] / wsum : 0.0;
        px[c] = static_cast<float>(v / 255.0 * 2.0 - 1.0);
      }
    }
  }
}

int decode_one(const char* path, int size, float* out) {
  Image img;
  if (int err = decode_png_rgb(path, &img)) return err;
  box_resize_normalize(img, size, out);
  return 0;
}

// ------------------------------------------------------------- thread pool
class Pool {
 public:
  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { Run(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Decodes paths[0..n) into out (n * size*size*3 floats).  Returns the
  // first nonzero per-image error code, or 0.
  int DecodeBatch(const char** paths, int n, int size, float* out) {
    std::atomic<int> remaining(n), first_err(0);
    std::mutex done_mu;
    std::condition_variable done_cv;
    {
      std::unique_lock<std::mutex> lk(mu_);
      for (int i = 0; i < n; ++i) {
        const char* p = paths[i];
        float* dst = out + static_cast<size_t>(i) * size * size * 3;
        jobs_.push([p, size, dst, &remaining, &first_err, &done_mu,
                    &done_cv] {
          int err = decode_one(p, size, dst);
          if (err) {
            int expected = 0;
            first_err.compare_exchange_strong(expected, err);
          }
          // Decrement under done_mu: the caller holds it while checking
          // the predicate, so it cannot observe remaining==0 and destroy
          // the stack-allocated mutex/cv while this worker still uses them.
          {
            std::unique_lock<std::mutex> dlk(done_mu);
            if (remaining.fetch_sub(1) == 1) done_cv.notify_all();
          }
        });
      }
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> dlk(done_mu);
    done_cv.wait(dlk, [&] { return remaining.load() == 0; });
    return first_err.load();
  }

 private:
  void Run() {
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
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> jobs_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

}  // namespace

extern "C" {

int d3d_version() { return 1; }

// Single image: decode+resize+normalize into out[size*size*3].
int d3d_decode(const char* path, int size, float* out) {
  if (!path || size <= 0 || !out) return kErrArgs;
  return decode_one(path, size, out);
}

void* d3d_pool_create(int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  return new Pool(n_threads);
}

void d3d_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int d3d_pool_decode(void* pool, const char** paths, int n, int size,
                    float* out) {
  if (!pool || !paths || n <= 0 || size <= 0 || !out) return kErrArgs;
  return static_cast<Pool*>(pool)->DecodeBatch(paths, n, size, out);
}

}  // extern "C"
