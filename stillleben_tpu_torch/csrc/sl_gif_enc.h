// The port's GIF encoder core (host code, C interface for ctypes).
//
// What Pillow 12's ``save`` does to write a GIF, below its Python layer:
// the median-cut quantiser (``Image.convert("P", palette=ADAPTIVE)`` of an
// RGB image: Quant.c method 0, kmeans 0), the fast-octree quantiser
// (``Image.quantize`` of an RGBA image: QuantOctree.c, method 2) and the
// LZW encoder of GifEncode.c with its 255-byte sub-blocks. Each gives
// Pillow's bytes for the same input.
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

// Median cut of ``npix`` RGB pixels (3 bytes each) to at most 256
// entries: ``palette`` gets *palette_len RGB entries (room for 256),
// ``index`` one entry per pixel.
int sl_quant_median(const uint8_t* rgb, uint32_t npix, uint8_t* palette, int* palette_len,
                    uint8_t* index, char* err, int errlen);

// Fast octree of ``npix`` RGBA pixels (4 bytes each) to 256 entries:
// ``palette`` gets *palette_len (= 256) RGBA entries, ``index`` one entry
// per pixel.
int sl_quant_octree(const uint8_t* rgba, uint32_t npix, uint8_t* palette, int* palette_len,
                    uint8_t* index, char* err, int errlen);

// GIF's LZW (minimum code size 8) of a (height, width) image of 8-bit
// indices, rows in interlaced order when ``interlace`` is 1: the data
// sub-blocks as Pillow's encoder writes them (without the minimum code
// size before them or the terminator after them), into a buffer of the
// library's that ``sl_gif_enc_free`` releases.
int sl_gif_lzw_encode(const uint8_t* index, int width, int height, int interlace,
                      uint8_t** out, size_t* out_size, char* err, int errlen);

void sl_gif_enc_free(uint8_t* p);

#ifdef __cplusplus
}
#endif
