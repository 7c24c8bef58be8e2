// The port's core for five plain image formats (host code, C interface for
// ctypes): QOI, PCX (and DCX, which holds PCX frames), SGI, IM and DDS.
//
// The bit loops that Pillow 12's readers and writers of these formats run
// below their Python layer: QOI's encoder and decoder (the QOI
// specification, in the order Pillow's Python codec runs it), PCX's
// run-length encoder and decoder (PcxEncode.c / PcxDecode.c), SGI's
// run-length decoder at 1 and 2 bytes per sample (SgiRleDecode.c) and the
// block decoders of DDS (BcnDecode.c: BC1-BC7 as the DirectX block
// specifications define them). IM needs no loop of its own.
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

// QOI's chunks (without the 14-byte header, with the 8-byte end marker) of
// ``width`` x ``height`` pixels of ``channels`` (3 or 4) bytes each, as
// Pillow's QoiEncoder writes them, into a buffer that ``sl_plain_free``
// releases.
int sl_qoi_encode(const uint8_t* pixels, int width, int height, int channels, uint8_t** out,
                  size_t* out_size, char* err, int errlen);

// The pixels of QOI chunks as Pillow's QoiDecoder reads them: ``out`` gets
// width x height x channels bytes. SL_TRUNCATED where the data ends first.
int sl_qoi_decode(const uint8_t* data, size_t size, int width, int height, int channels,
                  uint8_t* out, char* err, int errlen);

// PCX's run-length coding of ``height`` rows of ``planes`` x
// ``bytes_per_line`` bytes (each plane's line unpadded), each plane's line
// padded with zeros to an even stride as PcxEncode.c writes it, into a
// buffer that ``sl_plain_free`` releases.
int sl_pcx_encode(const uint8_t* rows, int bytes_per_line, int planes, int height, uint8_t** out,
                  size_t* out_size, char* err, int errlen);

// PcxDecode.c: ``height`` rows of ``row_bytes`` bytes from the run-length
// data, in file order and before the row's unpacking. SL_CORRUPT where a
// run crosses a row's end (Pillow's overrun), SL_TRUNCATED where the data
// ends first.
int sl_pcx_decode(const uint8_t* data, size_t size, int row_bytes, int height, uint8_t* out,
                  char* err, int errlen);

// SgiRleDecode.c: the run-length image after the 512-byte header
// (``data`` is the whole file). ``out`` gets ysize rows of xsize x zsize x
// bpc bytes in file order (bottom row first), samples interleaved; *rows
// is the number of rows decoded before the data's own end (Pillow keeps
// the rest of the image black). SL_CORRUPT for an offset, a length or a
// run outside the data.
int sl_sgi_rle_decode(const uint8_t* data, size_t size, int xsize, int ysize, int zsize, int bpc,
                      uint8_t* out, int* rows, char* err, int errlen);

// BcnDecode.c: ``n`` (1-7) is the BCn format, ``sign`` selects BC5S and
// BC6HS. ``out`` gets the whole blocks' pixels, (4 x ceil(height / 4)) rows
// of (4 x ceil(width / 4)) pixels: one byte each for BC4, four (RGBA) for
// the others (BC5's and BC6H's alpha byte as the decoder leaves it).
// SL_TRUNCATED where the data holds fewer blocks.
int sl_bcn_decode(const uint8_t* data, size_t size, int n, int sign, int width, int height,
                  uint8_t* out, char* err, int errlen);

void sl_plain_free(uint8_t* p);

#ifdef __cplusplus
}
#endif
