// The port's AVIF core (host code, C interface for ctypes): an AV1 intra
// decoder for the still pictures Pillow 12.1.0 writes through libavif 1.3.0
// and aom 3.12.1, and libavif's conversion to RGB as Pillow's build runs it
// (libyuv 1909's fixed-point BT.601 full-range arithmetic with its bilinear
// chroma upsampling).
//
// The decoder reads the OBUs of one AVIF item: a sequence header (reduced or
// full) and one shown KEY_FRAME (frame OBU, or frame header and tile
// groups) of 8-bit samples, 4:2:0 colour or monochrome. It implements the
// intra tools (every partition, the intra modes with angle deltas, edge
// filtering and upsampling, smooth and Paeth, CfL, filter intra, palette),
// segmentation, delta q and delta lf, uniform and explicit tiles, every
// intra transform (DCT 4-64, ADST 4-16, flipped ADST, identity) and the
// deblocking filter. What it does not decode is refused with SL_UNSUPPORTED
// and its name: 10- and 12-bit samples, 4:4:4 and 4:2:2, lossless frames,
// CDEF, loop restoration, superres, film grain, quantizer matrices, intra
// block copy, and inter or intra-only frames.
//
// Every function returns SL_OK or an error code with a message in ``err``.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef SL_OK
#define SL_OK 0
#define SL_UNSUPPORTED 1
#define SL_CORRUPT 2
#define SL_NO_ROOM 3
#define SL_TRUNCATED 4
#endif

#ifdef __cplusplus
extern "C" {
#endif

// The frame size of an AV1 item: info = {width, height, monochrome,
// bit depth, subsampling x, subsampling y, full range, matrix coefficients}.
int sl_av1_info(const uint8_t* obus, size_t size, int32_t* info, char* err, size_t errlen);

// Decodes an AV1 item into planes: y (width x height), u and v ((width + 1)
// / 2 x (height + 1) / 2; untouched for a monochrome item), each row-major
// with no padding.
int sl_av1_decode(const uint8_t* obus, size_t size, uint8_t* y, uint8_t* u, uint8_t* v,
                  char* err, size_t errlen);

// The symbol decoder alone (8.2), the inverse of sl_av1_write_symbols: reads
// ``count`` symbols from one tile's bytes, symbol i from the CDF ``cdfs +
// offsets[i]`` of ``sizes[i]`` symbols (adapted in place), or a literal of
// 8 bits where the size is 0.
int sl_av1_read_symbols(const uint8_t* data, size_t size, const int32_t* sizes, const int32_t* offsets,
                        int count, uint16_t* cdfs, int32_t* symbols);

// libyuv's I420 to RGBA with the BT.601 full-range (JPEG) constants and
// bilinear chroma upsampling, as libavif 1.3.0 calls it for an 8-bit 4:2:0
// image; alpha is set to 255.
void sl_avif_yuv420_to_rgba(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width,
                            int height, uint8_t* rgba);

#ifdef __cplusplus
}
#endif
