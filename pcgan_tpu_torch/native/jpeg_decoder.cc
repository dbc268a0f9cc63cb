// Host JPEG decoder of pcgan_tpu_torch (counterpart of
// pcgan_tpu/native/jpeg_decoder.cc, with the same status codes and the same
// scale_num DCT scaling, plus a header-only probe).
//
// A C++ thread pool decodes a batch of files straight into one caller-owned
// (n, h, w, 3) u8 buffer: one ctypes call per batch, which releases the GIL.
// A full-scale decode to RGB8 is bit-identical to
// PIL.Image.open().convert("RGB") for baseline and progressive JPEGs (Pillow
// wraps the same libjpeg ISLOW IDCT and fancy upsampling); greyscale sources
// expand to RGB as PIL's convert does. What the fast path cannot serve
// bit-exactly (CMYK, another size than the expected canvas, a corrupt
// stream) is reported per image through `status`, and the Python caller
// handles that image (pcgan_tpu_torch/data/utkface.py).
//
// Build: g++ -O2 -shared -fPIC jpeg_decoder.cc -ljpeg -lpthread
// (at first use, by pcgan_tpu_torch/native/__init__.py).

#include <cstddef>  // jpeglib.h uses size_t/FILE but includes neither:
#include <cstdio>   // they must come first
#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// libjpeg's default error_exit calls exit(); route it to longjmp instead.
struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jump, 1);
}

void silent_output(j_common_ptr) {}  // no stderr output for recoverable warnings

enum Status {
  PCGAN_OK = 0,
  PCGAN_E_OPEN = 1,    // file missing or unreadable
  PCGAN_E_DECODE = 2,  // corrupt, or not a JPEG
  PCGAN_E_DIMS = 3,    // decoded size != expected canvas (caller resizes)
  PCGAN_E_COLOR = 4,   // CMYK/YCCK source (caller converts)
};

int decode_one(const char* path, uint8_t* out, int oh, int ow,
               int scale_num) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return PCGAN_E_OPEN;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {  // any fatal libjpeg error lands here
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return PCGAN_E_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    // libjpeg cannot convert CMYK to RGB; the caller does
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return PCGAN_E_COLOR;
  }
  cinfo.out_color_space = JCS_RGB;  // grey -> RGB expansion is supported
  if (scale_num > 0 && scale_num != 8) {
    // DCT-domain downscale by scale_num/8: the IDCT's cost follows the
    // output size
    cinfo.scale_num = static_cast<unsigned>(scale_num);
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != ow ||
      static_cast<int>(cinfo.output_height) != oh ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return PCGAN_E_DIMS;
  }
  const size_t stride = static_cast<size_t>(ow) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rows[1] = {out + stride * cinfo.output_scanline};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return PCGAN_OK;
}

}  // namespace

extern "C" {

// Decode one JPEG file into `out` (h*w*3 RGB8) at scale_num/8 (8 = full;
// 0 is full as well). Returns a Status code.
int pcgan_decode_file(const char* path, uint8_t* out, int h, int w,
                      int scale_num) {
  return decode_one(path, out, h, w, scale_num);
}

// Decode `n` files into `out` (n*h*w*3, image i at offset i*h*w*3) with
// `nthreads` worker threads that take images from an atomic cursor (images
// vary in cost, so a static split would straggle). Image i's Status lands in
// `status[i]`; the slot of a failed image is left untouched. Returns the
// number of failures (0: the whole batch was decoded).
int pcgan_decode_batch(const char** paths, int n, uint8_t* out, int h, int w,
                       int nthreads, int* status, int scale_num) {
  const size_t img = static_cast<size_t>(h) * w * 3;
  std::atomic<int> next(0), failures(0);
  int t = nthreads < 1 ? 1 : nthreads;
  if (t > n) t = n;
  std::vector<std::thread> workers;
  workers.reserve(t);
  for (int k = 0; k < t; ++k) {
    workers.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        const int s = decode_one(paths[i], out + img * i, h, w, scale_num);
        status[i] = s;
        if (s != PCGAN_OK) failures.fetch_add(1, std::memory_order_relaxed);
      }
    });
  }
  for (auto& w_ : workers) w_.join();
  return failures.load();
}

// Read only the header of one JPEG file: its width, height and libjpeg
// colour space (J_COLOR_SPACE: 1 grey, 2 RGB, 3 YCbCr, 4 CMYK, 5 YCCK).
// No pixel is decoded. Returns PCGAN_OK, PCGAN_E_OPEN or PCGAN_E_DECODE.
int pcgan_probe_file(const char* path, int* width, int* height,
                     int* color_space) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return PCGAN_E_OPEN;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return PCGAN_E_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *width = static_cast<int>(cinfo.image_width);
  *height = static_cast<int>(cinfo.image_height);
  *color_space = static_cast<int>(cinfo.jpeg_color_space);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return PCGAN_OK;
}

// Linked libjpeg ABI version (62/70/80), for diagnostics.
int pcgan_jpeg_abi(void) { return JPEG_LIB_VERSION; }

// libjpeg-turbo's version as MMMmmmppp (2001005 = 2.1.5) from the headers
// it was built against, 0 for another libjpeg.
int pcgan_jpeg_turbo_version(void) {
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  return LIBJPEG_TURBO_VERSION_NUMBER;
#else
  return 0;
#endif
}

}  // extern "C"
