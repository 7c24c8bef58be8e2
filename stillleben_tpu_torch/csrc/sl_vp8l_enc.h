// libwebp 1.6.0's lossless (VP8L) encoder as its alpha encoder calls it
// (host code, C interface for ctypes).
//
// alpha_enc.c's EncodeLossless: the plane in the green byte of ARGB pixels
// whose alpha, red and blue are 0, VP8LEncodeStream at method 4, quality 32
// (8 x effort 4) and exact, no VP8L header. The stream is libwebp's bit for
// bit: the ALPH chunk of a lossy WebP with transparency holds it after its
// header byte.
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
#include <vector>

// The stream of a (height, width) uint8 plane, row-major.
std::vector<uint8_t> SlVp8lEncodePlane(const uint8_t* plane, int width, int height);

extern "C" {
#endif

// The same into a buffer of the library's that ``sl_webp_enc_free``
// releases.
int sl_vp8l_encode_plane(const uint8_t* plane, int width, int height, uint8_t** out,
                         size_t* out_size, char* err, int errlen);

#ifdef __cplusplus
}
#endif
