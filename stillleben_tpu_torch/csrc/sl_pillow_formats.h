// The bit loops of Pillow 12's rarer readers (host code, C interface for
// ctypes), linked into the plain formats' core: Sun raster's run-length
// decoder (SunRleDecode.c), MSP v2's run-length rows (MspImagePlugin's
// MspDecoder), one FLI/FLC frame's chunks (FliDecode.c) and BLP's DXT1,
// DXT3 and DXT5 blocks as BlpImagePlugin's Python decoders read them (565
// endpoints shifted without bit replication, ``//`` interpolation).
//
// The run-length decoders keep Pillow's semantics where the data ends or
// runs past a row: each returns what Pillow's decoder would return, and
// Python raises Pillow's exception from it.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// SunRleDecode.c over the whole run-length data: ``rows`` lines of
// ``line_bytes`` bytes (no row padding) into ``out``. Returns 1 when every
// line is decoded, 0 when the data ends first; *consumed is what the
// decoder took (the rest is an incomplete code).
int sl_sun_rle_decode(const uint8_t* data, size_t size, int line_bytes, int rows, uint8_t* out,
                      size_t* consumed);

// MspDecoder: ``rows`` rows whose encoded lengths are ``rowmap``, read one
// after the other from ``data``; a row of length 0 is ``blank_bytes`` of
// 0xFF. The concatenated output goes into a buffer ``sl_plain_free``
// releases. Returns 0, or 1 where row *bad_row is cut short by the data
// (Pillow's "Truncated MSP file"), 2 where a run's count or value lies past
// the row's end ("Corrupted MSP file").
int sl_msp_rle_decode(const uint8_t* data, size_t size, const uint16_t* rowmap, int rows,
                      int blank_bytes, uint8_t** out, size_t* out_size, int* bad_row);

// One call of FliDecode.c on ``size`` bytes at a frame's start: the frame
// into ``out`` (height rows of width bytes, as they stand before the call).
// Returns what Pillow's decoder returns: -1 when the frame is done (then
// *errcode is 0 or Pillow's error: -1 overrun, -2 broken, -3 unrecognized),
// else the bytes consumed before it needs more data.
long sl_fli_decode(const uint8_t* data, size_t size, int width, int height, uint8_t* out,
                   int* errcode);

// BlpImagePlugin's decode_dxt1 / decode_dxt3 / decode_dxt5 (``kind`` 1, 3
// or 5) of ``block_rows`` rows of ``blocks`` blocks each: out gets
// 4 x block_rows lines of 4 x blocks pixels of 4 bytes (RGBA), or of 3 for
// DXT1 without ``alpha``.
void sl_blp_dxt_decode(const uint8_t* data, int kind, int alpha, int blocks, int block_rows,
                       uint8_t* out);

#ifdef __cplusplus
}
#endif
