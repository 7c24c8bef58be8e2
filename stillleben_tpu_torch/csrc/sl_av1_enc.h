// The port's AV1 still-image encoder (host code, C interface for ctypes):
// the AV1 item of an AVIF file as the port writes it for Pillow's defaults
// (quality 75). It codes 8-bit 4:2:0 colour or a monochrome (alpha) plane
// as one shown KEY_FRAME under a reduced still-picture sequence header
// (aom 3.12.1's, byte for byte), with the tools of Pillow's default files:
// 64x64 superblocks, filter intra and the intra edge filter on, no CDEF, no
// loop restoration, no quantizer matrices, no delta q, the deblocking
// filter on, and libavif's tile layout. Its block decisions are its own: a
// rate-distortion search with integer costs (the rate from the adapted
// CDFs), the same on every host and for any number of threads.
//
// The reconstruction is the decoder's (sl_av1_recon.h): what the encoder
// returns as its reconstruction is what any AV1 decoder reads from its
// bytes.
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

// Encodes planes y (width x height) and, unless ``monochrome``, u and v
// ((width + 1) / 2 x (height + 1) / 2), each row-major with no padding, at
// ``base_q_idx``. ``*out`` receives the item's OBUs (a temporal delimiter,
// the sequence header and one frame OBU; free it with sl_av1_enc_free);
// ``recon_*`` (same shapes, or NULL) receive the reconstruction.
int sl_av1_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
                  int monochrome, int base_q_idx, uint8_t* recon_y, uint8_t* recon_u,
                  uint8_t* recon_v, uint8_t** out, size_t* out_size, char* err, int errlen);

void sl_av1_enc_free(uint8_t* p);

// libavif 1.3.0's RGB to YUV 4:2:0 as Pillow's save runs it for BT.601
// full range (its built-in path: single-precision Kr/Kb arithmetic per
// pixel, the chroma of each 2x2 block averaged): ``rgb`` holds ``channels``
// (3 or 4) bytes a pixel; y, u and v as in sl_av1_encode.
void sl_av1_rgb_to_yuv420(const uint8_t* rgb, int width, int height, int channels, uint8_t* y,
                          uint8_t* u, uint8_t* v);

// The range encoder alone, for its round trip: codes ``count`` symbols,
// symbol i from the CDF ``cdfs + offsets[i]`` of ``sizes[i]`` symbols (the
// decoder's layout: N - 1 cumulative values, 32768, a counter), adapting
// each CDF in place as the decoder does; a size of 0 codes ``symbols[i]``
// as a literal of 8 bits. Writes the bytes into ``out`` (room for
// ``room``); returns their number, or -1 without room.
int sl_av1_write_symbols(const int32_t* symbols, const int32_t* sizes, const int32_t* offsets,
                         int count, uint16_t* cdfs, uint8_t* out, int room);

#ifdef __cplusplus
}
#endif
