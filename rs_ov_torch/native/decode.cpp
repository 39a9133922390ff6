// Native image decode for the eval data path (PNG via libpng, JPEG via
// libjpeg): a copy of the JAX package's decoder, so that both packages read
// the same bytes into the same pixels. PIL remains the fallback for
// anything these refuse (16-bit PNGs, exotic color types, other formats).
// Two-call API so the caller (numpy via ctypes, rs_ov_torch/native) owns
// every allocation: decode_header sniffs the format and the size, then
// decode_rgb / decode_gray fill the caller's buffer.

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared first
#include <cstring>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kFmtUnknown = -1;
constexpr int kFmtPng = 1;
constexpr int kFmtJpeg = 2;

bool is_png(const uint8_t* buf, int64_t n) {
  return n >= 8 && png_sig_cmp(buf, 0, 8) == 0;
}

bool is_jpeg(const uint8_t* buf, int64_t n) {
  return n >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

struct MemReader {
  const uint8_t* data;
  png_size_t size;
  png_size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t want) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + want > r->size) {
    png_error(png, "read past end");
  }
  std::memcpy(out, r->data + r->pos, want);
  r->pos += want;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// mode 0 = RGB [h*w*3]; mode 1 = gray/labels [h*w] (palette indices kept
// raw, RGB collapsed to channel 0 — the PIL-path label semantics).
int decode_png(const uint8_t* buf, int64_t n, uint8_t* dst, int64_t* h,
               int64_t* w, int mode, bool header_only) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  MemReader reader{buf, static_cast<png_size_t>(n), 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  *h = height;
  *w = width;
  if (header_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  if (bit_depth == 16) {  // 16-bit labels/images: PIL fallback path
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }

  if (mode == 0) {
    // RGB contract: expand palette/gray, strip alpha
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
  } else {
    // label contract: palette stays indices; 1/2/4-bit packs to 8
    if (bit_depth < 8) png_set_packing(png);
    if (color == PNG_COLOR_TYPE_GRAY_ALPHA || color == PNG_COLOR_TYPE_RGB_ALPHA)
      png_set_strip_alpha(png);
  }
  int passes = png_set_interlace_handling(png);
  png_read_update_info(png, info);
  png_size_t rowbytes = png_get_rowbytes(png, info);
  int out_ch = (mode == 0) ? 3 : static_cast<int>(rowbytes / width);
  if (mode == 0 && rowbytes != width * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  if (mode == 1 && out_ch != 1 && out_ch != 3 && out_ch != 4) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }

  if (mode == 1 && out_ch > 1) {
    if (passes > 1) {
      // ADAM7 passes merge in place per row; a single scratch row would
      // mix rows. Rare (no converter writes interlaced) -> PIL fallback.
      png_destroy_read_struct(&png, &info, nullptr);
      return -2;
    }
    // RGB(A)-coded labels: decode rows to scratch, keep channel 0
    png_bytep row = new png_byte[rowbytes];
    for (int p = 0; p < passes; ++p) {
      for (png_uint_32 y = 0; y < height; ++y) {
        png_read_row(png, row, nullptr);
        if (p == passes - 1) {
          for (png_uint_32 x = 0; x < width; ++x)
            dst[y * width + x] = row[x * out_ch];
        }
      }
    }
    delete[] row;
  } else {
    const png_size_t stride = (mode == 0) ? width * 3 : width;
    for (int p = 0; p < passes; ++p) {
      for (png_uint_32 y = 0; y < height; ++y) {
        png_read_row(png, dst + y * stride, nullptr);
      }
    }
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int decode_jpeg(const uint8_t* buf, int64_t n, uint8_t* dst, int64_t* h,
                int64_t* w, int mode, bool header_only) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  if (header_only) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = (mode == 0) ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  const int64_t stride = (*w) * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Sniff format + dimensions. Returns kFmtPng/kFmtJpeg, or kFmtUnknown.
int decode_header(const uint8_t* buf, int64_t n, int64_t* h, int64_t* w) {
  if (is_png(buf, n))
    return decode_png(buf, n, nullptr, h, w, 0, true) == 0 ? kFmtPng
                                                           : kFmtUnknown;
  if (is_jpeg(buf, n))
    return decode_jpeg(buf, n, nullptr, h, w, 0, true) == 0 ? kFmtJpeg
                                                            : kFmtUnknown;
  return kFmtUnknown;
}

// dst: [h*w*3] uint8 RGB. Returns 0 ok, -2 "use the PIL fallback", -1 error.
int decode_rgb(const uint8_t* buf, int64_t n, uint8_t* dst,
               int64_t* h, int64_t* w) {
  if (is_png(buf, n)) return decode_png(buf, n, dst, h, w, 0, false);
  if (is_jpeg(buf, n)) return decode_jpeg(buf, n, dst, h, w, 0, false);
  return kFmtUnknown;
}

// dst: [h*w] uint8 labels (palette indices / gray / RGB channel 0).
int decode_gray(const uint8_t* buf, int64_t n, uint8_t* dst,
                int64_t* h, int64_t* w) {
  if (is_png(buf, n)) return decode_png(buf, n, dst, h, w, 1, false);
  if (is_jpeg(buf, n)) return decode_jpeg(buf, n, dst, h, w, 1, false);
  return kFmtUnknown;
}

}  // extern "C"
