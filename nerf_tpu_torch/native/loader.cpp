// nerf_tpu_torch native runtime: multithreaded image loading / preprocessing.
//
// The port's copy of the JAX package's native loader (nerf_tpu/native/
// loader.cpp): a C++ thread pool decodes PNG (libpng) / JPEG (libjpeg)
// frames in parallel and writes float32 RGB directly into a caller-provided
// buffer, composited on white and resized bilinearly. Beside it, a raw
// decode returns one image's 8-bit samples as stored (no composite), the
// counterpart of the imageio.imread that the JAX light-stage loader calls.
//
// Differences from the JAX package's copy, none in the C contract:
//   - interlaced (Adam7) PNGs are de-interlaced (png_set_interlace_handling);
//   - libjpeg's errors return to the caller (setjmp) instead of ending the
//     process, so a file that is neither PNG nor JPEG fails like a missing one;
//   - samples are divided by 255 (correctly rounded, as numpy's float32
//     division) instead of multiplied by its rounded inverse.
// 16-bit PNG samples keep their high byte (png_set_strip_16), as in the JAX
// package's copy.
//
// C API (ctypes):
//   int ntpu_load_images(const char** paths, int n_images,
//                        int out_h, int out_w,      // 0,0 = native size
//                        int white_bkgd,            // composite RGBA on white
//                        float* out,                // [n, H, W, 3]
//                        int n_threads);            // 0 = hw concurrency
//   returns 0 on success, else the 1-based index of the first failed image.
//   int ntpu_image_dims(const char* path, int* dims);   // dims = {h, w}
//   unsigned char* ntpu_decode_u8(const char* path, int* dims);
//     // [h, w, c] uint8 as stored (c: 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA;
//     // palettes expand to RGB or RGBA), dims = {h, w, c}; NULL on failure.
//   void ntpu_free(unsigned char* p);                   // frees that buffer

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <cctype>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct RawImage {
  std::vector<unsigned char> px;  // H*W*C
  int h = 0, w = 0, channels = 0;
};

struct DecodedImage {
  std::vector<float> rgba;  // H*W*4, [0,1]
  int h = 0, w = 0, channels = 0;
};

// rgba: expand to 8-bit RGBA (the float path); else keep the stored channels
bool decode_png(const char* path, bool rgba, RawImage* img) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  unsigned char sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  std::vector<png_bytep> rows;  // before setjmp: a longjmp skips no destructor
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  // normalize to 8-bit samples
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (rgba) {
    if (color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_RGB ||
        color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_PALETTE)
      png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
  }
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  int c = png_get_channels(png, info);

  img->px.resize(size_t(h) * w * c);
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = img->px.data() + size_t(y) * w * c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  img->h = int(h);
  img->w = int(w);
  img->channels = c;
  return true;
}

struct JpegError {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1);
}

void jpeg_quiet(j_common_ptr) {}

// rgb: convert to RGB (the float path); else gray stays one channel
bool decode_jpeg(const char* path, bool rgb, RawImage* img) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  jerr.mgr.output_message = jpeg_quiet;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  cinfo.out_color_space =
      (!rgb && cinfo.jpeg_color_space == JCS_GRAYSCALE) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  int c = cinfo.output_components;
  img->px.resize(size_t(h) * w * c);
  while (int(cinfo.output_scanline) < h) {
    unsigned char* rp = img->px.data() + size_t(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  img->h = h;
  img->w = w;
  img->channels = c;
  return true;
}

bool decode_raw(const char* path, bool expand, RawImage* img) {
  const char* dot = std::strrchr(path, '.');
  std::string ext = dot ? dot + 1 : "";
  for (auto& ch : ext) ch = char(std::tolower(static_cast<unsigned char>(ch)));
  if (ext == "png") return decode_png(path, expand, img);
  if (ext == "jpg" || ext == "jpeg") return decode_jpeg(path, expand, img);
  // try png then jpeg
  return decode_png(path, expand, img) || decode_jpeg(path, expand, img);
}

bool decode(const char* path, DecodedImage* img) {
  RawImage raw;
  if (!decode_raw(path, true, &raw)) return false;
  img->h = raw.h;
  img->w = raw.w;
  img->channels = raw.channels;
  img->rgba.assign(size_t(raw.h) * raw.w * 4, 1.0f);
  size_t n = size_t(raw.h) * raw.w;
  for (size_t i = 0; i < n; ++i)
    for (int k = 0; k < raw.channels; ++k)
      img->rgba[i * 4 + k] = float(raw.px[i * raw.channels + k]) / 255.0f;
  return true;
}

// bilinear sample of an RGBA image (align_corners=False convention, matching
// torch's F.interpolate used by the reference, blender.py:81-83)
inline void sample_bilinear(const DecodedImage& img, float sy, float sx,
                            float* out4) {
  float fy = sy - 0.5f, fx = sx - 0.5f;
  int y0 = int(std::floor(fy)), x0 = int(std::floor(fx));
  float wy = fy - y0, wx = fx - x0;
  int y1 = y0 + 1, x1 = x0 + 1;
  y0 = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
  y1 = y1 < 0 ? 0 : (y1 >= img.h ? img.h - 1 : y1);
  x0 = x0 < 0 ? 0 : (x0 >= img.w ? img.w - 1 : x0);
  x1 = x1 < 0 ? 0 : (x1 >= img.w ? img.w - 1 : x1);
  const float* p00 = img.rgba.data() + (size_t(y0) * img.w + x0) * 4;
  const float* p01 = img.rgba.data() + (size_t(y0) * img.w + x1) * 4;
  const float* p10 = img.rgba.data() + (size_t(y1) * img.w + x0) * 4;
  const float* p11 = img.rgba.data() + (size_t(y1) * img.w + x1) * 4;
  for (int c = 0; c < 4; ++c) {
    float top = p00[c] * (1 - wx) + p01[c] * wx;
    float bot = p10[c] * (1 - wx) + p11[c] * wx;
    out4[c] = top * (1 - wy) + bot * wy;
  }
}

void postprocess(const DecodedImage& img, int out_h, int out_w,
                 bool white_bkgd, float* out) {
  int H = out_h > 0 ? out_h : img.h;
  int W = out_w > 0 ? out_w : img.w;
  bool resize = (H != img.h) || (W != img.w);
  float sy_scale = float(img.h) / H, sx_scale = float(img.w) / W;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      float px[4];
      if (resize) {
        sample_bilinear(img, (y + 0.5f) * sy_scale, (x + 0.5f) * sx_scale, px);
      } else {
        std::memcpy(px, img.rgba.data() + (size_t(y) * img.w + x) * 4,
                    sizeof(px));
      }
      float a = px[3];
      float* dst = out + (size_t(y) * W + x) * 3;
      if (white_bkgd) {
        // rgb*a + (1-a): reference blender.py:71
        dst[0] = px[0] * a + (1.0f - a);
        dst[1] = px[1] * a + (1.0f - a);
        dst[2] = px[2] * a + (1.0f - a);
      } else {
        dst[0] = px[0];
        dst[1] = px[1];
        dst[2] = px[2];
      }
    }
  }
}

}  // namespace

extern "C" {

int ntpu_load_images(const char** paths, int n_images, int out_h, int out_w,
                     int white_bkgd, float* out, int n_threads) {
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  size_t frame_stride = 0;  // set after first decode defines H, W
  // out_h/out_w==0 means native size: require it from the first image
  int H = out_h, W = out_w;
  if (H == 0 || W == 0) {
    DecodedImage first;
    if (!decode(paths[0], &first)) return 1;
    H = out_h > 0 ? out_h : first.h;
    W = out_w > 0 ? out_w : first.w;
    postprocess(first, H, W, white_bkgd, out);
  }
  frame_stride = size_t(H) * W * 3;
  int start = (out_h == 0 || out_w == 0) ? 1 : 0;
  next.store(start);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_images) return;
      DecodedImage img;
      if (!decode(paths[i], &img)) {
        // keep the lowest failed index, whichever thread finds it first
        int seen = failed.load();
        while ((seen == 0 || i + 1 < seen) &&
               !failed.compare_exchange_weak(seen, i + 1)) {
        }
        continue;
      }
      postprocess(img, H, W, white_bkgd, out + frame_stride * i);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

// single-image probe: returns 0 on success and writes (h, w) to dims[2]
int ntpu_image_dims(const char* path, int* dims) {
  RawImage img;
  if (!decode_raw(path, false, &img)) return 1;
  dims[0] = img.h;
  dims[1] = img.w;
  return 0;
}

unsigned char* ntpu_decode_u8(const char* path, int* dims) {
  RawImage img;
  if (!decode_raw(path, false, &img)) return nullptr;
  unsigned char* buf = static_cast<unsigned char*>(std::malloc(img.px.size()));
  if (!buf) return nullptr;
  std::memcpy(buf, img.px.data(), img.px.size());
  dims[0] = img.h;
  dims[1] = img.w;
  dims[2] = img.channels;
  return buf;
}

void ntpu_free(unsigned char* p) { std::free(p); }

}  // extern "C"
