// Native IO core for rife_tpu_torch: PNG/JPEG/WebP decode+encode (a copy of
// rife_tpu/native/rife_io.cpp; the port imports nothing of rife_tpu).
//
// The counterpart of the reference's vendored C codecs (stb_image.h,
// stb_image_write.h, webp_image.h — see the reference's
// src/main.cpp:123-229): a thin, GIL-free C API over the
// system libpng/libjpeg/libwebp, driven from Python via ctypes in the
// load/save pipeline stages.  All functions return 0 on success, negative on
// error; decoded/encoded buffers are malloc'd and released with rife_free().
//
// Behavioral parity with the reference:
//  * decode always yields 3-channel RGB (reference forces 3ch, main.cpp:167)
//  * WebP encodes lossless (webp_image.h:63-78)
//  * JPEG encodes quality 100 (main.cpp:215)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <png.h>
#include <jpeglib.h>
#include <webp/decode.h>
#include <webp/encode.h>

extern "C" {

void rife_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

int rife_decode_png(const unsigned char* data, size_t size,
                    unsigned char** out, int* w, int* h) {
    png_image image;
    memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, size)) return -1;
    image.format = PNG_FORMAT_RGB;
    size_t stride = PNG_IMAGE_ROW_STRIDE(image);
    unsigned char* buf = (unsigned char*)malloc(PNG_IMAGE_SIZE(image));
    if (!buf) { png_image_free(&image); return -2; }
    if (!png_image_finish_read(&image, nullptr, buf, (png_int_32)stride, nullptr)) {
        free(buf);
        png_image_free(&image);
        return -3;
    }
    *out = buf;
    *w = (int)image.width;
    *h = (int)image.height;
    return 0;
}

int rife_encode_png(const unsigned char* rgb, int w, int h,
                    unsigned char** out, size_t* out_size) {
    png_image image;
    memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    image.width = (png_uint_32)w;
    image.height = (png_uint_32)h;
    image.format = PNG_FORMAT_RGB;
    // two-pass: query size, then write
    png_alloc_size_t size = 0;
    if (!png_image_write_to_memory(&image, nullptr, &size, 0, rgb, 3 * w, nullptr))
        return -1;
    unsigned char* buf = (unsigned char*)malloc(size);
    if (!buf) return -2;
    if (!png_image_write_to_memory(&image, buf, &size, 0, rgb, 3 * w, nullptr)) {
        free(buf);
        return -3;
    }
    *out = buf;
    *out_size = size;
    return 0;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = (JpegErr*)cinfo->err;
    longjmp(err->jb, 1);
}

int rife_decode_jpeg(const unsigned char* data, size_t size,
                     unsigned char** out, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    unsigned char* buf = nullptr;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        free(buf);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)size);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    int width = cinfo.output_width, height = cinfo.output_height;
    buf = (unsigned char*)malloc((size_t)width * height * 3);
    if (!buf) { jpeg_destroy_decompress(&cinfo); return -2; }
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = buf + (size_t)cinfo.output_scanline * width * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *w = width;
    *h = height;
    return 0;
}

int rife_encode_jpeg(const unsigned char* rgb, int w, int h, int quality,
                     unsigned char** out, size_t* out_size) {
    jpeg_compress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    unsigned char* buf = nullptr;
    unsigned long size = 0;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_compress(&cinfo);
        free(buf);
        return -1;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &buf, &size);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        const unsigned char* row = rgb + (size_t)cinfo.next_scanline * w * 3;
        jpeg_write_scanlines(&cinfo, (JSAMPARRAY)&row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    *out = buf;  // libjpeg mallocs; caller frees with rife_free
    *out_size = (size_t)size;
    return 0;
}

// ---------------------------------------------------------------------------
// WebP
// ---------------------------------------------------------------------------

int rife_decode_webp(const unsigned char* data, size_t size,
                     unsigned char** out, int* w, int* h) {
    int width = 0, height = 0;
    if (!WebPGetInfo(data, size, &width, &height)) return -1;
    unsigned char* buf = (unsigned char*)malloc((size_t)width * height * 3);
    if (!buf) return -2;
    if (!WebPDecodeRGBInto(data, size, buf, (size_t)width * height * 3, width * 3)) {
        free(buf);
        return -3;
    }
    *out = buf;
    *w = width;
    *h = height;
    return 0;
}

int rife_encode_webp(const unsigned char* rgb, int w, int h,
                     unsigned char** out, size_t* out_size) {
    uint8_t* buf = nullptr;
    size_t size = WebPEncodeLosslessRGB(rgb, w, h, 3 * w, &buf);
    if (size == 0 || !buf) return -1;
    *out = buf;  // WebP uses its own allocator compatible with free()
    *out_size = size;
    return 0;
}

}  // extern "C"
