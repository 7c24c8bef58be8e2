// The port's WebP encoder (host code, C interface for ctypes).
//
// One configuration: the one Pillow's ``save`` hands libwebp for a lossy
// WebP (WEBP_PRESET_DEFAULT at quality 80, method 4: sns 50, filter
// strength 60, sharpness 0, the normal loop filter, 4 segments, 1 token
// partition, 1 pass, no autofilter, no preprocessing, exact 0; the alpha
// plane losslessly compressed with the fast filter choice). The VP8 chunk
// and the container are libwebp's bytes; the alpha plane is a VP8L stream
// of the port's own (the decoded alpha is exact).
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

// Encodes (height, width, channels) uint8 RGB (channels 3) or RGBA
// (channels 4, row-major) as a WebP file into a buffer of the library's
// that ``sl_webp_enc_free`` releases. A side over 16383 fails with
// libwebp's error 5 and its message.
int sl_webp_encode(const uint8_t* pixels, int width, int height, int channels, uint8_t** out,
                   size_t* out_size, char* err, int errlen);

void sl_webp_enc_free(uint8_t* p);

// The planes the VP8 encoder starts from: libwebp's RGB(A) -> YUV 4:2:0
// import, and then (``cleanup`` 1) its clean-up of the fully transparent
// area. y: width*height, u and v: ((width+1)/2)*((height+1)/2), a:
// width*height (written where *has_alpha is 1).
int sl_webp_enc_planes(const uint8_t* pixels, int width, int height, int channels, int cleanup,
                       uint8_t* y, uint8_t* u, uint8_t* v, uint8_t* a, int* has_alpha);

#ifdef __cplusplus
}
#endif
