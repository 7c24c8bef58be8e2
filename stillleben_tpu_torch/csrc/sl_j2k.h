// The port's JPEG 2000 core (host code, C interface for ctypes): the
// codestream (ISO/IEC 15444-1 Annex A) both ways, written at the shape
// Pillow 12.1.0 writes by default through OpenJPEG 2.5.4, read at every
// shape its save writes.
//
// Encoding is OpenJPEG's encoder as Pillow's ``Jpeg2KImagePlugin._save``
// drives it with no options: one tile, the reversible 5/3 wavelet at
// min(5, floor(log2(min(W, H)))) levels, no colour transform, LRCP with one
// layer holding every coding pass, maximal precincts, 64x64 code-blocks of
// style 0, no quantisation with two guard bits, OpenJPEG's COM marker. The
// bytes equal OpenJPEG's.
//
// Decoding reads a codestream of 1-4 components of 8 or 16 bits, signed or
// not, bitwise as OpenJPEG 2.5.4 does: either wavelet (5/3, or 9/7 in
// OpenJPEG's single precision) at any number of levels, with or without
// the colour transform (RCT or ICT), any code-block size of style 0,
// quality layers, precincts, the five progression orders and POC, tiles
// and image offsets, tile-parts in any order, PLT, PLM, TLM and COM
// markers. Every other stream is refused with SL_UNSUPPORTED and the name
// of what it needs: a code-block style other than 0, SOP/EPH markers, COC,
// QCC, RGN, PPM, PPT, derived quantisation, other precisions, sub-sampled
// components, a POC that leaves out a component's highest resolution.
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

// The codestream (SOC to EOC) of ``width`` x ``height`` pixels of
// ``components`` (1-4) interleaved samples, uint8 at ``depth`` 8 or uint16
// at ``depth`` 16, into a buffer that ``sl_j2k_free`` releases.
int sl_j2k_encode(const void* pixels, int width, int height, int components, int depth,
                  uint8_t** out, size_t* out_size, char* err, int errlen);

void sl_j2k_free(uint8_t* buffer);

// The main header of a codestream: info = (width, height, components,
// precision, levels, colour transform, a bit per signed component, the
// image's x and y offsets); the width and height are the SIZ's less its
// offsets.
int sl_j2k_info(const uint8_t* data, size_t size, int32_t* info, char* err, int errlen);

// The samples of a codestream: ``out`` gets height x width x components
// uint16 values, interleaved, each in 0 .. 2^precision - 1 (a signed
// sample plus 2^(precision - 1)).
int sl_j2k_decode(const uint8_t* data, size_t size, uint16_t* out, char* err, int errlen);

#ifdef __cplusplus
}
#endif
