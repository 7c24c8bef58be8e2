// The port's AVIF core (host code, C interface for ctypes): an AV1 intra
// decoder for the still pictures Pillow 12.1.0 (libavif 1.3.0, aom 3.12.1)
// and OpenCV 5.0.0 (libavif 1.4.2, aom 3.14.1) write at any of their
// settings, and libavif's conversions to RGB as both readers run them
// (libyuv's fixed-point arithmetic with its bilinear chroma upsampling,
// libavif's copy of the identity matrix and its single-precision path).
//
// The decoder reads the OBUs of one AVIF item: a sequence header (reduced or
// full) and one shown KEY_FRAME (frame OBU, or frame header and tile
// groups) of 8-, 10- or 12-bit samples, 4:2:0, 4:2:2 or 4:4:4 colour or
// monochrome. It implements the intra tools (every partition, the intra
// modes with angle deltas, edge filtering and upsampling, smooth and Paeth,
// CfL, filter intra, palette), segmentation, delta q and delta lf, uniform
// and explicit tiles, every intra transform (DCT 4-64, ADST 4-16, flipped
// ADST, identity) with quantizer matrices, lossless blocks (the
// Walsh-Hadamard transform), intra block copy, the loop filters
// (deblocking, CDEF and loop restoration: Wiener and self-guided) and film
// grain on the output. What it does not decode is refused with
// SL_UNSUPPORTED and its name: 4:4:0, superres, and inter or intra-only
// frames.
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

// The frame an AV1 item codes: info = {width, height, monochrome, bit depth,
// subsampling x, subsampling y, full range, matrix coefficients,
// base_q_idx, tile columns, tile rows, the four loop filter levels, the
// loop filter sharpness, the bit of the item where color_range lies (-1
// where the sequence header does not code it), using_qmatrix, qm_y, qm_u,
// qm_v, apply_grain}.
int sl_av1_info(const uint8_t* obus, size_t size, int32_t* info, char* err, size_t errlen);

// Decodes an AV1 item into planes: y (width x height), u and v ((width +
// subsampling x) >> subsampling x by (height + subsampling y) >> subsampling
// y; untouched for a monochrome item), each row-major with no padding, of
// uint8_t samples at 8 bits and uint16_t at 10 and 12; film grain applied
// where the frame asks for it.
int sl_av1_decode(const uint8_t* obus, size_t size, void* y, void* u, void* v, char* err, size_t errlen);

// The symbol decoder alone (8.2), the inverse of sl_av1_write_symbols: reads
// ``count`` symbols from one tile's bytes, symbol i from the CDF ``cdfs +
// offsets[i]`` of ``sizes[i]`` symbols (adapted in place), or a literal of
// 8 bits where the size is 0.
int sl_av1_read_symbols(const uint8_t* data, size_t size, const int32_t* sizes, const int32_t* offsets,
                        int count, uint16_t* cdfs, int32_t* symbols);

// libyuv's YUV to RGBA as libavif 1.3.0 calls it for 8-bit planes, alpha
// set to 255: I420 and I422 with bilinear chroma upsampling, or I444, with
// the constants of matrix coefficients 1 (BT.709) or the BT.601 ones (any
// other), full or limited range; and the identity matrix (0) of a
// full-range 4:4:4 image, which libavif copies as G, B, R. SL_UNSUPPORTED
// for the identity matrix on any other.
int sl_avif_yuv_to_rgba(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
                        int subsampling_x, int subsampling_y, int matrix, int full_range, uint8_t* rgba);

// libavif's conversion of planes of uint16_t samples of ``depth`` bits (8 to
// 12) to RGBA, alpha at its maximum, of these kinds: 0, libavif's own
// single-precision path to 8-bit RGBA (uint8_t); 1, the same to RGBA of
// ``depth`` bits (uint16_t); 2, libyuv's 10- and 12-bit rows with bilinear
// chroma upsampling (uint8_t); 3, those rows with the nearest chroma sample.
// A monochrome item (kinds 0 and 1) reads only ``y``. SL_UNSUPPORTED for
// the identity matrix.
int sl_avif_yuv16_to_rgba(const uint16_t* y, const uint16_t* u, const uint16_t* v, int width, int height, int depth,
                          int subsampling_x, int subsampling_y, int monochrome, int matrix, int full_range, int kind,
                          void* rgba);

// Decodes as sl_av1_decode does and fills ``counts`` (CNT_COUNT int32s,
// sl_av1_post.h) with what the decode ran: the restoration types, unit
// shift and units of each kind, the CDEF blocks by strength, the skipped
// 64x64s, the CfL, lossless and chroma palette blocks, and the chroma
// transform sizes.
int sl_av1_decode_counts(const uint8_t* obus, size_t size, int32_t* counts, char* err, size_t errlen);

// The names of sl_av1_decode_counts's counts in their order, each followed
// by a comma.
const char* sl_av1_count_names(void);

// The Wiener filter of loop restoration (7.17.4) over one whole plane of
// 8-bit samples whose edges repeat: ``taps`` holds the vertical filter's
// three outer coefficients, then the horizontal filter's.
int sl_av1_wiener(const uint8_t* src, int width, int height, const int8_t* taps, uint8_t* dst);

#ifdef __cplusplus
}
#endif
