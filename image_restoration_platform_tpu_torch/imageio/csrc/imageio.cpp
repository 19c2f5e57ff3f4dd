// imageio — native host codec stage for the TPU restoration pipeline.
//
// TPU-native replacement for the reference's sharp/libvips dependency
// (reference: server-node/src/middleware/imagePreprocess.js, uploadValidation.js,
// SURVEY.md section 2.2). Provides, behind a plain C ABI consumed via ctypes:
//   - magic-byte container sniffing (jpeg/png/webp)
//   - JPEG/PNG/WebP decode to interleaved RGB8 into caller-owned buffers
//     (zero-copy into numpy -> pinned host staging for device transfer)
//   - JPEG encode with quality + 4:4:4 chroma + sRGB ICC attach + EXIF strip
//   - PNG / WebP encode
//   - JPEG EXIF orientation parsing (auto-orient policy lives host-side)
//
// Build: g++ -O3 -shared -fPIC imageio.cpp -ljpeg -lpng -lwebp -o libirpimageio.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>
#include <webp/encode.h>

extern "C" {

enum IrpFormat : int {
  IRP_FMT_UNKNOWN = 0,
  IRP_FMT_JPEG = 1,
  IRP_FMT_PNG = 2,
  IRP_FMT_WEBP = 3,
};

enum IrpStatus : int {
  IRP_OK = 0,
  IRP_ERR_DECODE = -1,
  IRP_ERR_FORMAT = -2,
  IRP_ERR_ALLOC = -3,
  IRP_ERR_ENCODE = -4,
  IRP_ERR_BOUNDS = -5,
};

// ---------------------------------------------------------------- sniffing

int irp_sniff(const uint8_t* buf, size_t len) {
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF) return IRP_FMT_JPEG;
  static const uint8_t png_sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  if (len >= 8 && memcmp(buf, png_sig, 8) == 0) return IRP_FMT_PNG;
  if (len >= 12 && memcmp(buf, "RIFF", 4) == 0 && memcmp(buf + 8, "WEBP", 4) == 0)
    return IRP_FMT_WEBP;
  return IRP_FMT_UNKNOWN;
}

// ------------------------------------------------------------ EXIF parsing

static uint16_t rd16(const uint8_t* p, bool be) {
  return be ? (uint16_t)((p[0] << 8) | p[1]) : (uint16_t)((p[1] << 8) | p[0]);
}
static uint32_t rd32(const uint8_t* p, bool be) {
  return be ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3]
            : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) | ((uint32_t)p[1] << 8) | p[0];
}

// Returns the EXIF orientation tag (1..8) of a JPEG stream, or 1 (top-left)
// when absent/unparseable. Scans APP1 "Exif\0\0" -> TIFF IFD0 tag 0x0112.
int irp_jpeg_orientation(const uint8_t* buf, size_t len) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 1;
  size_t off = 2;
  while (off + 4 <= len) {
    if (buf[off] != 0xFF) break;
    uint8_t marker = buf[off + 1];
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) { off += 2; continue; }
    if (marker == 0xDA || marker == 0xD9) break;  // SOS / EOI: no headers past here
    if (off + 4 > len) break;
    uint16_t seglen = (uint16_t)((buf[off + 2] << 8) | buf[off + 3]);
    if (seglen < 2 || off + 2 + seglen > len) break;
    if (marker == 0xE1 && seglen >= 2 + 6 + 8) {
      const uint8_t* p = buf + off + 4;
      size_t plen = seglen - 2;
      if (plen >= 6 && memcmp(p, "Exif\0\0", 6) == 0) {
        const uint8_t* tiff = p + 6;
        size_t tlen = plen - 6;
        if (tlen >= 8) {
          bool be;
          if (tiff[0] == 'M' && tiff[1] == 'M') be = true;
          else if (tiff[0] == 'I' && tiff[1] == 'I') be = false;
          else return 1;
          uint32_t ifd = rd32(tiff + 4, be);
          if (ifd + 2 <= tlen) {
            uint16_t count = rd16(tiff + ifd, be);
            for (uint16_t i = 0; i < count; i++) {
              size_t e = ifd + 2 + (size_t)i * 12;
              if (e + 12 > tlen) break;
              uint16_t tag = rd16(tiff + e, be);
              if (tag == 0x0112) {
                uint16_t val = rd16(tiff + e + 8, be);
                return (val >= 1 && val <= 8) ? val : 1;
              }
            }
          }
        }
      }
    }
    off += 2 + seglen;
  }
  return 1;
}

// ------------------------------------------------------------- JPEG decode

struct JpegErr {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int irp_decode_info(const uint8_t* buf, size_t len, int* w, int* h, int* channels,
                    int* orientation) {
  int fmt = irp_sniff(buf, len);
  *orientation = 1;
  if (fmt == IRP_FMT_JPEG) {
    struct jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) { jpeg_destroy_decompress(&cinfo); return IRP_ERR_DECODE; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      return IRP_ERR_DECODE;
    }
    *w = (int)cinfo.image_width;
    *h = (int)cinfo.image_height;
    *channels = 3;
    *orientation = irp_jpeg_orientation(buf, len);
    jpeg_destroy_decompress(&cinfo);
    return fmt;
  }
  if (fmt == IRP_FMT_PNG) {
    png_image image;
    memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, buf, len)) return IRP_ERR_DECODE;
    *w = (int)image.width;
    *h = (int)image.height;
    *channels = 3;
    png_image_free(&image);
    return fmt;
  }
  if (fmt == IRP_FMT_WEBP) {
    int ww = 0, hh = 0;
    if (!WebPGetInfo(buf, len, &ww, &hh)) return IRP_ERR_DECODE;
    *w = ww;
    *h = hh;
    *channels = 3;
    return fmt;
  }
  return IRP_ERR_FORMAT;
}

// Decode into caller-owned RGB8 buffer of exactly w*h*3 bytes (from decode_info).
int irp_decode(const uint8_t* buf, size_t len, uint8_t* out, int w, int h) {
  int fmt = irp_sniff(buf, len);
  if (fmt == IRP_FMT_JPEG) {
    struct jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) { jpeg_destroy_decompress(&cinfo); return IRP_ERR_DECODE; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if ((int)cinfo.output_width != w || (int)cinfo.output_height != h ||
        cinfo.output_components != 3) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return IRP_ERR_BOUNDS;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row = out + (size_t)cinfo.output_scanline * w * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return IRP_OK;
  }
  if (fmt == IRP_FMT_PNG) {
    png_image image;
    memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, buf, len)) return IRP_ERR_DECODE;
    if ((int)image.width != w || (int)image.height != h) {
      png_image_free(&image);
      return IRP_ERR_BOUNDS;
    }
    image.format = PNG_FORMAT_RGB;
    // 16-bit sources: the simplified API assumes 16-bit data is LINEAR and
    // gamma-encodes it into the 8-bit output (observed up to 73/255 shift on
    // sRGB-encoded 16-bit files). Real camera/scanner 16-bit PNGs carry
    // display-encoded values; this flag makes the 8-bit conversion a plain
    // depth downscale. Raw 16-bit ingest lives in irp_decode_png16.
    image.flags |= PNG_IMAGE_FLAG_16BIT_sRGB;
    if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) {
      png_image_free(&image);
      return IRP_ERR_DECODE;
    }
    return IRP_OK;
  }
  if (fmt == IRP_FMT_WEBP) {
    if (WebPDecodeRGBInto(buf, len, out, (size_t)w * h * 3, w * 3) == nullptr)
      return IRP_ERR_DECODE;
    return IRP_OK;
  }
  return IRP_ERR_FORMAT;
}

// ------------------------------------------------------- 16-bit PNG decode
//
// High-bit-depth ingest for the spectral deconvolution path (ops/deblur.py):
// a defocus disk's ring nulls sit below the 8-bit quantization floor, so the
// disk channel is only usable on >=10-bit inputs. The simplified png_image
// API offers 16-bit output only in LINEAR formats (gamma-converted); the
// deconvolution wants the file's raw code values, so this uses the classic
// libpng read path.

// Source bit depth of a PNG byte stream (8/16; IHDR byte 24), or an error.
int irp_png_bit_depth(const uint8_t* buf, size_t len) {
  if (irp_sniff(buf, len) != IRP_FMT_PNG || len < 25) return IRP_ERR_FORMAT;
  return (int)buf[24];
}

struct PngMemSrc {
  const uint8_t* buf;
  size_t len;
  size_t off;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngMemSrc* src = (PngMemSrc*)png_get_io_ptr(png);
  if (src->off + n > src->len) png_error(png, "png: read past end");
  memcpy(out, src->buf + src->off, n);
  src->off += n;
}

// Decode ANY PNG into caller-owned host-endian RGB16 (w*h*3 uint16, from
// decode_info): raw code values, 8-bit sources promoted v*257, palette and
// gray expanded, alpha stripped, interlace handled.
int irp_decode_png16(const uint8_t* buf, size_t len, uint16_t* out, int w, int h) {
  if (irp_sniff(buf, len) != IRP_FMT_PNG) return IRP_ERR_FORMAT;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return IRP_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return IRP_ERR_DECODE;
  }
  png_bytep* rows = (png_bytep*)malloc(sizeof(png_bytep) * (size_t)h);
  if (!rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    return IRP_ERR_ALLOC;
  }
  PngMemSrc src = {buf, len, 0};
  int status = IRP_ERR_DECODE;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(rows);
    return status;
  }
  png_set_read_fn(png, &src, png_mem_read);
  png_read_info(png, info);
  if ((int)png_get_image_width(png, info) != w || (int)png_get_image_height(png, info) != h) {
    status = IRP_ERR_BOUNDS;
    png_error(png, "size mismatch");
  }
  int ct = png_get_color_type(png, info);
  if (ct == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (ct == PNG_COLOR_TYPE_GRAY || ct == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_expand_16(png);      // 1/2/4/8-bit samples -> 16-bit (v * 257)
  png_set_strip_alpha(png);
  {                            // PNG samples are big-endian; swap on LE hosts
    const uint16_t probe = 1;
    if (*(const uint8_t*)&probe == 1) png_set_swap(png);
  }
  (void)png_set_interlace_handling(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != (size_t)w * 6) png_error(png, "unexpected rowbytes");
  for (int y = 0; y < h; y++) rows[y] = (png_bytep)(out + (size_t)y * w * 3);
  png_read_image(png, rows);
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);
  return IRP_OK;
}

// --------------------------------------------------------------- sRGB ICC

// Minimal valid sRGB-compatible ICC v2 display profile built at runtime:
// desc/wtpt/rXYZ/gXYZ/bXYZ + shared parametric-free 1024-entry TRC curve.
// Enough for downstream consumers to identify the payload as sRGB; the
// reference attaches libvips' bundled sRGB profile (imagePreprocess.js:63).
static void put32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8); p[3] = (uint8_t)v;
}

static uint32_t s15f16(double v) {
  long x = (long)(v * 65536.0 + (v >= 0 ? 0.5 : -0.5));
  return (uint32_t)x;
}

static size_t build_srgb_icc(uint8_t** out_buf) {
  const int CURVE_N = 1024;
  struct Tag { const char* sig; uint32_t off, size; };
  // layout: header(128) + tagtable
  const int NTAGS = 8;
  size_t tagtable = 4 + NTAGS * 12;
  size_t desc_size = 12 + 67 + 11 + 12;     // textDescriptionType, padded
  desc_size = (desc_size + 3) & ~3u;
  size_t xyz_size = 20;
  size_t curv_size = 12 + CURVE_N * 2;
  curv_size = (curv_size + 3) & ~3u;
  size_t wtpt_off = 128 + tagtable;
  size_t desc_off = wtpt_off + xyz_size;
  size_t rxyz_off = desc_off + desc_size;
  size_t gxyz_off = rxyz_off + xyz_size;
  size_t bxyz_off = gxyz_off + xyz_size;
  size_t trc_off = bxyz_off + xyz_size;
  size_t total = trc_off + curv_size;

  uint8_t* p = (uint8_t*)calloc(1, total);
  if (!p) return 0;
  // --- header
  put32(p + 0, (uint32_t)total);
  memcpy(p + 4, "irpT", 4);                 // CMM
  put32(p + 8, 0x02400000);                 // version 2.4
  memcpy(p + 12, "mntr", 4);                // device class: display
  memcpy(p + 16, "RGB ", 4);                // color space
  memcpy(p + 20, "XYZ ", 4);                // PCS
  memcpy(p + 36, "acsp", 4);                // magic
  // D50 illuminant
  put32(p + 68, s15f16(0.9642));
  put32(p + 72, s15f16(1.0));
  put32(p + 76, s15f16(0.8249));
  // --- tag table
  uint8_t* t = p + 128;
  put32(t, NTAGS);
  t += 4;
  auto wtag = [&](const char* sig, size_t off, size_t size) {
    memcpy(t, sig, 4);
    put32(t + 4, (uint32_t)off);
    put32(t + 8, (uint32_t)size);
    t += 12;
  };
  wtag("wtpt", wtpt_off, xyz_size);
  wtag("desc", desc_off, desc_size);
  wtag("rXYZ", rxyz_off, xyz_size);
  wtag("gXYZ", gxyz_off, xyz_size);
  wtag("bXYZ", bxyz_off, xyz_size);
  wtag("rTRC", trc_off, curv_size);
  // ICC permits tag offsets to alias: g/b TRC point at the same curve data
  // (sRGB uses identical TRCs per channel), so strict CMSes see all three
  // required TRC tags.
  wtag("gTRC", trc_off, curv_size);
  wtag("bTRC", trc_off, curv_size);

  auto put_xyz = [&](size_t off, double X, double Y, double Z) {
    memcpy(p + off, "XYZ ", 4);
    put32(p + off + 8, s15f16(X));
    put32(p + off + 12, s15f16(Y));
    put32(p + off + 16, s15f16(Z));
  };
  // D50-adapted sRGB primaries
  put_xyz(wtpt_off, 0.9642, 1.0, 0.8249);
  put_xyz(rxyz_off, 0.4360, 0.2225, 0.0139);
  put_xyz(gxyz_off, 0.3851, 0.7169, 0.0971);
  put_xyz(bxyz_off, 0.1431, 0.0606, 0.7139);
  // desc
  memcpy(p + desc_off, "desc", 4);
  const char* name = "sRGB IEC61966-2.1";
  put32(p + desc_off + 8, (uint32_t)strlen(name) + 1);
  memcpy(p + desc_off + 12, name, strlen(name));
  // rTRC: curveType with sRGB-like tone curve
  memcpy(p + trc_off, "curv", 4);
  put32(p + trc_off + 8, CURVE_N);
  for (int i = 0; i < CURVE_N; i++) {
    double x = (double)i / (CURVE_N - 1);
    double y = x <= 0.04045 ? x / 12.92 : __builtin_pow((x + 0.055) / 1.055, 2.4);
    uint16_t v = (uint16_t)(y * 65535.0 + 0.5);
    p[trc_off + 12 + i * 2] = (uint8_t)(v >> 8);
    p[trc_off + 12 + i * 2 + 1] = (uint8_t)v;
  }
  *out_buf = p;
  return total;
}

// ----------------------------------------------------------------- resize

// Separable Lanczos3 resample of interleaved RGB8 (the host-side stage the
// reference delegates to libvips, imagePreprocess.js:48-53). Weights are
// precomputed per output coordinate; accumulation in f32. Device-side resizes
// (bucket->bucket, SR) use the MXU matmul formulation in ops/resize.py; this
// host path exists for arbitrary user shapes, where per-shape XLA compiles
// would dominate latency.
static double lanczos3(double x) {
  if (x < 0) x = -x;
  if (x < 1e-9) return 1.0;
  if (x >= 3.0) return 0.0;
  double px = 3.14159265358979323846 * x;
  return 3.0 * __builtin_sin(px) * __builtin_sin(px / 3.0) / (px * px);
}

struct ResizeTaps {
  int* start;     // [out] first source index
  float* weights; // [out * taps]
  int taps;
};

static bool build_taps(int in_size, int out_size, ResizeTaps* rt) {
  double scale = (double)in_size / out_size;
  double fscale = scale > 1.0 ? scale : 1.0;
  double support = 3.0 * fscale;
  int taps = (int)(2.0 * support + 2.0);
  rt->taps = taps;
  rt->start = (int*)malloc(sizeof(int) * out_size);
  rt->weights = (float*)malloc(sizeof(float) * (size_t)out_size * taps);
  if (!rt->start || !rt->weights) return false;
  for (int o = 0; o < out_size; o++) {
    double center = (o + 0.5) * scale - 0.5;
    int first = (int)__builtin_floor(center - support);
    if (first < 0) first = 0;
    rt->start[o] = first;
    double sum = 0.0;
    for (int t = 0; t < taps; t++) {
      int i = first + t;
      double w = 0.0;
      if (i < in_size) {
        w = lanczos3((center - i) / fscale);
      }
      rt->weights[(size_t)o * taps + t] = (float)w;
      sum += w;
    }
    if (sum != 0.0) {
      for (int t = 0; t < taps; t++) rt->weights[(size_t)o * taps + t] /= (float)sum;
    }
  }
  return true;
}

int irp_resize_rgb8(const uint8_t* src, int in_w, int in_h, uint8_t* dst, int out_w,
                    int out_h) {
  if (in_w <= 0 || in_h <= 0 || out_w <= 0 || out_h <= 0) return IRP_ERR_BOUNDS;
  ResizeTaps tx{nullptr, nullptr, 0}, ty{nullptr, nullptr, 0};
  float* tmp = nullptr;  // [in_h, out_w, 3] f32 after horizontal pass
  int rc = IRP_OK;
  if (!build_taps(in_w, out_w, &tx) || !build_taps(in_h, out_h, &ty)) {
    rc = IRP_ERR_ALLOC;
    goto done;
  }
  tmp = (float*)malloc(sizeof(float) * (size_t)in_h * out_w * 3);
  if (!tmp) { rc = IRP_ERR_ALLOC; goto done; }

  for (int y = 0; y < in_h; y++) {
    const uint8_t* row = src + (size_t)y * in_w * 3;
    float* trow = tmp + (size_t)y * out_w * 3;
    for (int o = 0; o < out_w; o++) {
      float r = 0, g = 0, b = 0;
      int first = tx.start[o];
      const float* w = tx.weights + (size_t)o * tx.taps;
      for (int t = 0; t < tx.taps; t++) {
        int i = first + t;
        if (i >= in_w) break;
        const uint8_t* p = row + (size_t)i * 3;
        r += w[t] * p[0];
        g += w[t] * p[1];
        b += w[t] * p[2];
      }
      trow[o * 3 + 0] = r;
      trow[o * 3 + 1] = g;
      trow[o * 3 + 2] = b;
    }
  }
  for (int o = 0; o < out_h; o++) {
    uint8_t* drow = dst + (size_t)o * out_w * 3;
    int first = ty.start[o];
    const float* w = ty.weights + (size_t)o * ty.taps;
    for (int x = 0; x < out_w * 3; x++) {
      float acc = 0;
      for (int t = 0; t < ty.taps; t++) {
        int i = first + t;
        if (i >= in_h) break;
        acc += w[t] * tmp[(size_t)i * out_w * 3 + x];
      }
      int v = (int)(acc + 0.5f);
      drow[x] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
done:
  free(tx.start);
  free(tx.weights);
  free(ty.start);
  free(ty.weights);
  free(tmp);
  return rc;
}

// --------------------------------------------------------------- encoding

void irp_free(uint8_t* p) { free(p); }

// JPEG encode: quality q, optional 4:4:4 chroma (imagePreprocess.js:57-64),
// optional sRGB ICC APP2 attach. EXIF is never written (strip-by-construction).
int irp_encode_jpeg(const uint8_t* rgb, int w, int h, int quality, int chroma444,
                    int attach_srgb_icc, uint8_t** out, size_t* out_len) {
  struct jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;

  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return IRP_ERR_ENCODE;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.optimize_coding = TRUE;  // mozjpeg-style smaller files
  if (chroma444) {
    for (int i = 0; i < cinfo.num_components; i++) {
      cinfo.comp_info[i].h_samp_factor = 1;
      cinfo.comp_info[i].v_samp_factor = 1;
    }
  }
  jpeg_start_compress(&cinfo, TRUE);

  if (attach_srgb_icc) {
    uint8_t* icc = nullptr;
    size_t icc_len = build_srgb_icc(&icc);
    if (icc && icc_len > 0 && icc_len < 65000) {
      // single-chunk ICC APP2 marker: "ICC_PROFILE\0" + seq/total
      size_t hdr = 14;
      uint8_t* marker = (uint8_t*)malloc(hdr + icc_len);
      if (marker) {
        memcpy(marker, "ICC_PROFILE", 12);
        marker[12] = 1;
        marker[13] = 1;
        memcpy(marker + hdr, icc, icc_len);
        jpeg_write_marker(&cinfo, JPEG_APP0 + 2, marker, (unsigned int)(hdr + icc_len));
        free(marker);
      }
    }
    if (icc) free(icc);
  }

  while (cinfo.next_scanline < cinfo.image_height) {
    const uint8_t* row = rgb + (size_t)cinfo.next_scanline * w * 3;
    JSAMPROW rows[1] = {const_cast<JSAMPROW>(row)};
    jpeg_write_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = (uint8_t*)mem;
  *out_len = (size_t)mem_len;
  return IRP_OK;
}

// JPEG encode from pre-subsampled YCbCr 4:2:0 planes (jpeg_write_raw_data).
// Serving rationale: the tiled-SR output leaves the device as Y + quarter-res
// Cb/Cr planes (1.5 B/px instead of 3 B/px RGB), halving the device->host
// transfer that dominates the 2K->4K wall time; this entry point feeds those
// planes straight into libjpeg's raw pipeline with no host colorspace work.
// y is [h, w]; cb/cr are [(h+1)/2, (w+1)/2], JPEG full-range BT.601.
int irp_encode_jpeg_raw420(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                           int w, int h, int quality, int attach_srgb_icc,
                           uint8_t** out, size_t* out_len) {
  struct jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  uint8_t* ypad = nullptr;
  uint8_t* cbpad = nullptr;
  uint8_t* crpad = nullptr;

  // libjpeg's raw-data path consumes full iMCU rows: pad each plane to DCT
  // block multiples (16 luma / 8 chroma) by edge replication.
  const int wp = (w + 15) & ~15;
  const int hp = (h + 15) & ~15;
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  const int cwp = wp / 2, chp = hp / 2;

  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    free(ypad); free(cbpad); free(crpad);
    return IRP_ERR_ENCODE;
  }
  ypad = (uint8_t*)malloc((size_t)wp * hp);
  cbpad = (uint8_t*)malloc((size_t)cwp * chp);
  crpad = (uint8_t*)malloc((size_t)cwp * chp);
  if (!ypad || !cbpad || !crpad) {
    free(ypad); free(cbpad); free(crpad);
    return IRP_ERR_ALLOC;
  }
  for (int r = 0; r < hp; r++) {
    const uint8_t* src = y + (size_t)(r < h ? r : h - 1) * w;
    uint8_t* dst = ypad + (size_t)r * wp;
    memcpy(dst, src, w);
    memset(dst + w, src[w - 1], wp - w);
  }
  for (int r = 0; r < chp; r++) {
    const uint8_t* sb = cb + (size_t)(r < ch ? r : ch - 1) * cw;
    const uint8_t* sr_ = cr + (size_t)(r < ch ? r : ch - 1) * cw;
    uint8_t* db = cbpad + (size_t)r * cwp;
    uint8_t* dr = crpad + (size_t)r * cwp;
    memcpy(db, sb, cw);
    memcpy(dr, sr_, cw);
    memset(db + cw, sb[cw - 1], cwp - cw);
    memset(dr + cw, sr_[cw - 1], cwp - cw);
  }

  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.raw_data_in = TRUE;
  cinfo.comp_info[0].h_samp_factor = 2;
  cinfo.comp_info[0].v_samp_factor = 2;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  // optimize_coding buffers coefficients host-side; keep it for parity with
  // irp_encode_jpeg's output size behavior
  cinfo.optimize_coding = TRUE;
  jpeg_start_compress(&cinfo, TRUE);

  if (attach_srgb_icc) {
    uint8_t* icc = nullptr;
    size_t icc_len = build_srgb_icc(&icc);
    if (icc && icc_len > 0 && icc_len < 65000) {
      size_t hdr = 14;
      uint8_t* marker = (uint8_t*)malloc(hdr + icc_len);
      if (marker) {
        memcpy(marker, "ICC_PROFILE", 12);
        marker[12] = 1;
        marker[13] = 1;
        memcpy(marker + hdr, icc, icc_len);
        jpeg_write_marker(&cinfo, JPEG_APP0 + 2, marker, (unsigned int)(hdr + icc_len));
        free(marker);
      }
    }
    if (icc) free(icc);
  }

  JSAMPROW yrows[16], cbrows[8], crrows[8];
  JSAMPARRAY planes[3] = {yrows, cbrows, crrows};
  while (cinfo.next_scanline < cinfo.image_height) {
    int base = (int)cinfo.next_scanline;
    for (int i = 0; i < 16; i++) {
      int r = base + i;
      yrows[i] = ypad + (size_t)(r < hp ? r : hp - 1) * wp;
    }
    for (int i = 0; i < 8; i++) {
      int r = base / 2 + i;
      cbrows[i] = cbpad + (size_t)(r < chp ? r : chp - 1) * cwp;
      crrows[i] = crpad + (size_t)(r < chp ? r : chp - 1) * cwp;
    }
    jpeg_write_raw_data(&cinfo, planes, 16);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  free(ypad); free(cbpad); free(crpad);
  *out = (uint8_t*)mem;
  *out_len = (size_t)mem_len;
  return IRP_OK;
}

int irp_encode_png(const uint8_t* rgb, int w, int h, uint8_t** out, size_t* out_len) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  image.width = (png_uint_32)w;
  image.height = (png_uint_32)h;
  image.format = PNG_FORMAT_RGB;
  png_alloc_size_t size = 0;
  if (!png_image_write_to_memory(&image, nullptr, &size, 0, rgb, 0, nullptr))
    return IRP_ERR_ENCODE;
  uint8_t* buf = (uint8_t*)malloc(size);
  if (!buf) return IRP_ERR_ALLOC;
  if (!png_image_write_to_memory(&image, buf, &size, 0, rgb, 0, nullptr)) {
    free(buf);
    return IRP_ERR_ENCODE;
  }
  *out = buf;
  *out_len = (size_t)size;
  return IRP_OK;
}

int irp_encode_webp(const uint8_t* rgb, int w, int h, float quality, uint8_t** out,
                    size_t* out_len) {
  uint8_t* mem = nullptr;
  size_t n = WebPEncodeRGB(rgb, w, h, w * 3, quality, &mem);
  if (n == 0 || mem == nullptr) return IRP_ERR_ENCODE;
  // copy into malloc'd memory so irp_free (free) is uniform
  uint8_t* buf = (uint8_t*)malloc(n);
  if (!buf) { WebPFree(mem); return IRP_ERR_ALLOC; }
  memcpy(buf, mem, n);
  WebPFree(mem);
  *out = buf;
  *out_len = n;
  return IRP_OK;
}

}  // extern "C"
