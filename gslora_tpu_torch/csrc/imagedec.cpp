// Batched JPEG/PNG decoder of gslora_tpu_torch: a thread pool decodes a
// batch of image files straight into the caller's float32 (n, 3, H, W)
// array, /255, with libjpeg and libpng (the codecs PIL wraps, so pixels
// equal PIL's to the bit when no resize is involved). Bound to Python with
// ctypes by gslora_tpu_torch/native; built with
// g++ -O2 -std=c++17 -fPIC -pthread ... -ljpeg -lpng -lz.
//
// Contract: an image whose size is not (W, H), that is unreadable, or that
// is neither JPEG nor PNG is not decoded (ok[i] = 0); the caller decodes
// it with PIL, which owns every resize.
//
// C ABI:
//   id_decode_batch(paths[n], n, out, H, W, threads, ok) -> 0

#include <atomic>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>  // after <cstdio>: it uses size_t and FILE
#include <png.h>

namespace {

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_fail(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1);
}

// Decode a JPEG of exactly want_w x want_h into packed RGB; the size is
// read from the header first, so an image that needs a resize costs no
// pixel decode.
bool decode_jpeg(const unsigned char* data, size_t len, int want_w,
                 int want_h, std::vector<unsigned char>& rgb) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_fail;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK ||
      static_cast<int>(cinfo.image_width) != want_w ||
      static_cast<int>(cinfo.image_height) != want_h) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
  rgb.resize(stride * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  bool sized = static_cast<int>(cinfo.output_width) == want_w &&
               static_cast<int>(cinfo.output_height) == want_h;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return sized;
}

// The same for a PNG, through libpng's simplified API.
bool decode_png(const unsigned char* data, size_t len, int want_w,
                int want_h, std::vector<unsigned char>& rgb) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return false;
  if (static_cast<int>(image.width) != want_w ||
      static_cast<int>(image.height) != want_h) {
    png_image_free(&image);
    return false;
  }
  image.format = PNG_FORMAT_RGB;
  rgb.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, rgb.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

bool read_file(const char* path, std::vector<unsigned char>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size <= 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

// Decode one file into out (float CHW, /255): 1 on success, 0 where the
// caller must decode it itself.
int decode_one(const char* path, float* out, int64_t H, int64_t W) {
  std::vector<unsigned char> file, rgb;
  if (!read_file(path, file) || file.size() < 8) return 0;
  bool ok = false;
  if (file[0] == 0xFF && file[1] == 0xD8) {
    ok = decode_jpeg(file.data(), file.size(), static_cast<int>(W),
                     static_cast<int>(H), rgb);
  } else if (file[0] == 0x89 && file[1] == 'P' && file[2] == 'N' &&
             file[3] == 'G') {
    ok = decode_png(file.data(), file.size(), static_cast<int>(W),
                    static_cast<int>(H), rgb);
  }
  if (!ok) return 0;
  const int64_t plane = H * W;
  for (int64_t y = 0; y < H; ++y) {
    const unsigned char* row = rgb.data() + y * W * 3;
    for (int64_t x = 0; x < W; ++x) {
      for (int64_t c = 0; c < 3; ++c) {
        out[c * plane + y * W + x] = row[3 * x + c] / 255.0f;
      }
    }
  }
  return 1;
}

}  // namespace

extern "C" {

int id_decode_batch(const char** paths, int64_t n, float* out, int64_t H,
                    int64_t W, int threads, unsigned char* ok) {
  if (n <= 0) return 0;
  int nt = threads < 1 ? 1 : (threads > 64 ? 64 : threads);
  if (nt > n) nt = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  const int64_t stride = 3 * H * W;
  auto worker = [&]() {
    for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      ok[i] = static_cast<unsigned char>(
          decode_one(paths[i], out + i * stride, H, W));
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
