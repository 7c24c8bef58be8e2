// The port's native image codec core (host code, C interface for ctypes).
//
// The serial bit loops of the image formats: JPEG's Huffman entropy coding
// (baseline and progressive decode, baseline encode), the sample arithmetic
// of libjpeg-turbo's default paths (the integer IDCT / FDCT, fancy
// upsampling, plain downsampling, the fixed-point colour conversions,
// rounding quantisation), the LZW decoders of GIF and TIFF, and the
// run-length decoders of BMP (RLE8 / RLE4), TGA and TIFF (PackBits).
//
// Every function returns SL_OK, or one of the codes below with a message in
// ``err`` (``errlen`` bytes, NUL-terminated).

#pragma once

#include <stddef.h>
#include <stdint.h>

#define SL_OK 0
#define SL_UNSUPPORTED 1  // a valid file of a variant the codec does not decode
#define SL_CORRUPT 2      // not a valid file
#define SL_NO_ROOM 3      // the output buffer is too small
#define SL_TRUNCATED 4    // the data ends before the image does (no EOI)
#define SL_UNIDENTIFIED 5 // a JPEG Pillow's open refuses (12-bit, 2 components, ...)
#define SL_BROKEN 6       // a JPEG libjpeg stops decoding (hierarchical, ...)
#define SL_TRUNCATED_FAILS 7  // truncated, and libjpeg reading on past the end stops
#define SL_PILLOW_BROKEN 8    // decoded as OpenCV reads it; Pillow's reading stops
                              // (arithmetic data past the 64 KiB it hands libjpeg)

#ifdef __cplusplus
extern "C" {
#endif

// JPEG header up to the frame: info = {width, height, components,
// colour space (0 grey, 1 YCbCr, 2 RGB)}.
int sl_jpeg_info(const uint8_t* data, size_t n, int* info, char* err, int errlen);

// Decode to (height, width, components) uint8: grey, RGB after the
// YCbCr -> RGB conversion, or CMYK (YCCK converted) as libjpeg outputs them.
// Besides SL_OK: SL_TRUNCATED, SL_TRUNCATED_FAILS and SL_PILLOW_BROKEN,
// after which the output is OpenCV's reading (none for SL_TRUNCATED_FAILS).
int sl_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen);

// The RGB of npix CMYK pixels as libjpeg outputs them: Pillow's reading
// (opencv = 0: inverted "CMYK;I" then cmyk2rgb, 4 bytes RGBA a pixel) or
// OpenCV's (opencv = 1: its CMYK-to-BGR, 3 bytes a pixel).
void sl_cmyk_convert(const uint8_t* cmyk, size_t npix, int opencv, uint8_t* out);

// Encode (height, width, components) uint8 (1: grey, 3: RGB) as a baseline
// JFIF JPEG: standard tables scaled to ``quality``, the first component
// sampled h0 x v0 (1x1, 2x1 or 2x2), the others 1x1.
int sl_jpeg_encode(const uint8_t* pix, int width, int height, int components, int quality,
                   int h0, int v0, uint8_t* out, size_t cap, size_t* out_len, char* err,
                   int errlen);

// GIF's LZW (the image's sub-blocks already joined): up to npix indices.
int sl_gif_lzw(const uint8_t* data, size_t n, int min_code_size, uint8_t* out, size_t npix,
               size_t* written, char* err, int errlen);

// TIFF's LZW (MSB first, early change), one strip or tile.
int sl_tiff_lzw(const uint8_t* data, size_t n, uint8_t* out, size_t cap, size_t* written,
                char* err, int errlen);

// BMP's RLE8 (rle4 = 0) or RLE4 (rle4 = 1) from byte ``pos`` of the whole
// file, as Pillow's BmpRleDecoder reads it: width * height palette indices,
// rows in file order. Data that ends before the image is SL_CORRUPT.
int sl_bmp_rle(const uint8_t* data, size_t n, size_t pos, uint32_t width, uint32_t height,
               int rle4, uint8_t* out, char* err, int errlen);

// TGA's run-length packets from byte ``pos``: npix pixels of bpp bytes. A
// repeat packet that crosses the end of a row of ``width`` pixels, and data
// that ends before the image, are SL_CORRUPT.
int sl_tga_rle(const uint8_t* data, size_t n, size_t pos, size_t npix, int bpp, size_t width,
               uint8_t* out, char* err, int errlen);

// TIFF's PackBits, one strip or tile: up to cap bytes.
int sl_packbits(const uint8_t* data, size_t n, uint8_t* out, size_t cap, size_t* written,
                char* err, int errlen);

#ifdef __cplusplus
}
#endif
