// Copy of yoloret_tpu/native/dataloader.cc for yoloret_tpu_torch (built by yoloret_tpu_torch/ops/_build.py); every line below is the original's.
// Native data-loader core for yoloret-tpu.
//
// The reference leans on TensorFlow's C++ runtime for its input pipeline
// (tf.data JPEG decode + resize, TFRecord IO with masked CRC32C —
// reference: code/yolo3/data.py). This framework's host pipeline uses this
// small library instead: threaded JPEG decode (libjpeg) fused with a
// bilinear resize to the fixed staging square, plus CRC32C for TFRecord
// framing. Exposed via ctypes (yoloret_tpu/native/__init__.py).
//
// Build: g++ -O3 -march=native -shared -fPIC dataloader.cc -ljpeg -lpthread
//        -o libyoloret_native.so

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven; byte-identical to the TFRecord framing.
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[256];
static bool crc_init_done = false;

static void crc_init() {
  if (crc_init_done) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    kCrcTable[i] = crc;
  }
  crc_init_done = true;
}

uint32_t yt_crc32c(const uint8_t* data, uint64_t n) {
#ifdef __SSE4_2__
  // Hardware CRC32C (SSE4.2): 8 bytes per instruction.
  uint64_t crc = 0xFFFFFFFFu;
  uint64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t chunk;
    memcpy(&chunk, data + i, 8);
    crc = __builtin_ia32_crc32di(crc, chunk);
  }
  uint32_t crc32 = (uint32_t)crc;
  for (; i < n; ++i) crc32 = __builtin_ia32_crc32qi(crc32, data[i]);
  return crc32 ^ 0xFFFFFFFFu;
#else
  crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; ++i)
    crc = kCrcTable[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
#endif
}

uint32_t yt_masked_crc(const uint8_t* data, uint64_t n) {
  uint32_t crc = yt_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// JPEG decode + bilinear resize to a fixed square, normalized float32 RGB.
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode `data` (JPEG bytes) and bilinearly resize to staging x staging.
// out: staging*staging*3 floats in [0,1]. Returns 0 on success and fills
// orig_h/orig_w.
int yt_decode_resize_mem(const uint8_t* data, uint64_t len, int staging,
                         float* out, int* orig_h, int* orig_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  // libjpeg can cheaply decode at 1/2, 1/4, 1/8 scale: pick the smallest
  // scale that still covers the staging square (big speed win for large
  // photos feeding a 320x320 staging canvas).
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 2; denom /= 2) {
    if ((int)cinfo.image_width / denom >= staging &&
        (int)cinfo.image_height / denom >= staging) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int stride = w * cinfo.output_components;
  pixels.resize((size_t)h * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  *orig_h = (int)cinfo.image_height;
  *orig_w = (int)cinfo.image_width;
  const int comps = cinfo.output_components;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Bilinear resize (half-pixel centers) to staging x staging, f32 [0,1].
  const float sy = (float)h / staging, sx = (float)w / staging;
  const float inv255 = 1.0f / 255.0f;
  for (int oy = 0; oy < staging; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - (float)y0;
    if (wy < 0) wy = 0;
    for (int ox = 0; ox < staging; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - (float)x0;
      if (wx < 0) wx = 0;
      float* dst = out + ((size_t)oy * staging + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        int cc = comps == 3 ? c : 0;  // grayscale broadcast
        float p00 = pixels[((size_t)y0 * w + x0) * comps + cc];
        float p01 = pixels[((size_t)y0 * w + x1) * comps + cc];
        float p10 = pixels[((size_t)y1 * w + x0) * comps + cc];
        float p11 = pixels[((size_t)y1 * w + x1) * comps + cc];
        float top = p00 + (p01 - p00) * wx;
        float bot = p10 + (p11 - p10) * wx;
        dst[c] = (top + (bot - top) * wy) * inv255;
      }
    }
  }
  return 0;
}

// uint8 output variant: same decode+resize, no normalization — feeding
// uint8 to the accelerator quarters host->device transfer.
int yt_decode_resize_mem_u8(const uint8_t* data, uint64_t len, int staging,
                            uint8_t* out, int* orig_h, int* orig_w) {
  std::vector<float> tmp((size_t)staging * staging * 3);
  int rc = yt_decode_resize_mem(data, len, staging, tmp.data(), orig_h, orig_w);
  if (rc != 0) return rc;
  const size_t n = (size_t)staging * staging * 3;
  for (size_t i = 0; i < n; ++i) {
    float v = tmp[i] * 255.0f + 0.5f;
    out[i] = v <= 0.f ? 0 : (v >= 255.f ? 255 : (uint8_t)v);
  }
  return 0;
}

// Random-JPEG-quality augmentation fused into the loader. The reference
// applies tf.image.random_jpeg_quality AFTER the resize, at network
// scale (reference: code/yolo3/utils.py:228-231) — so: scaled decode +
// resize to the staging square, re-encode that square in memory at
// `quality`, decode it back. All three codec passes run at <= staging
// resolution, so the cost is bounded by the staging size instead of the
// source photo size (the previous PIL path re-encoded the full-res
// original: 3x slower on real photos and at the wrong scale).
int yt_decode_resize_q_mem_u8(const uint8_t* data, uint64_t len, int staging,
                              int quality, uint8_t* out, int* orig_h,
                              int* orig_w) {
  int rc = yt_decode_resize_mem_u8(data, len, staging, out, orig_h, orig_w);
  if (rc != 0 || quality <= 0) return rc;

  // Re-encode the staging square at `quality` (libjpeg defaults: 4:2:0,
  // baseline — the same settings PIL's JPEG save uses).
  jpeg_compress_struct c;
  JpegErr cerr_;
  c.err = jpeg_std_error(&cerr_.mgr);
  cerr_.mgr.error_exit = jpeg_err_exit;
  unsigned char* buf = nullptr;
  unsigned long buflen = 0;
  if (setjmp(cerr_.jb)) {
    jpeg_destroy_compress(&c);
    if (buf) free(buf);
    return 5;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, &buf, &buflen);
  c.image_width = (JDIMENSION)staging;
  c.image_height = (JDIMENSION)staging;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(out + (size_t)c.next_scanline * staging * 3);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);

  // Decode the artifacts back; dimensions match staging by construction
  // so this is a straight scanline copy (no resize pass).
  jpeg_decompress_struct d;
  JpegErr derr;
  d.err = jpeg_std_error(&derr.mgr);
  derr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(derr.jb)) {
    jpeg_destroy_decompress(&d);
    free(buf);
    return 6;
  }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, buf, buflen);
  jpeg_read_header(&d, TRUE);
  d.out_color_space = JCS_RGB;
  jpeg_start_decompress(&d);
  if ((int)d.output_width != staging || (int)d.output_height != staging ||
      d.output_components != 3) {
    jpeg_destroy_decompress(&d);
    free(buf);
    return 7;
  }
  while (d.output_scanline < d.output_height) {
    uint8_t* row = out + (size_t)d.output_scanline * staging * 3;
    jpeg_read_scanlines(&d, &row, 1);
  }
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  free(buf);
  return 0;
}

int yt_decode_resize_q_file_u8(const char* path, int staging, int quality,
                               uint8_t* out, int* orig_h, int* orig_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 3;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)n);
  if (fread(buf.data(), 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    return 4;
  }
  fclose(f);
  return yt_decode_resize_q_mem_u8(buf.data(), (uint64_t)n, staging, quality,
                                   out, orig_h, orig_w);
}

int yt_decode_resize_file_u8(const char* path, int staging, uint8_t* out,
                             int* orig_h, int* orig_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 3;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)n);
  if (fread(buf.data(), 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    return 4;
  }
  fclose(f);
  return yt_decode_resize_mem_u8(buf.data(), (uint64_t)n, staging, out,
                                 orig_h, orig_w);
}

int yt_decode_resize_file(const char* path, int staging, float* out,
                          int* orig_h, int* orig_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 3;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)n);
  if (fread(buf.data(), 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    return 4;
  }
  fclose(f);
  return yt_decode_resize_mem(buf.data(), (uint64_t)n, staging, out, orig_h,
                              orig_w);
}

// Threaded batch decode: paths[i] -> out + i*staging*staging*3,
// hw[2*i]=orig_h, hw[2*i+1]=orig_w. Returns number of failures.
int yt_decode_resize_batch(const char** paths, int n, int staging, float* out,
                           int* hw, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + (size_t)i * staging * staging * 3;
      int rc = yt_decode_resize_file(paths[i], staging, dst, &hw[2 * i],
                                     &hw[2 * i + 1]);
      if (rc != 0) {
        memset(dst, 0, sizeof(float) * (size_t)staging * staging * 3);
        hw[2 * i] = hw[2 * i + 1] = 1;
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : n;
  pool.reserve((size_t)nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
