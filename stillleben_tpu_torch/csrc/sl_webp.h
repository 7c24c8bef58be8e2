// The port's WebP decoder (host code, C interface for ctypes).
//
// The RIFF container (simple VP8 / VP8L files and VP8X with ALPH, ANIM and
// ANMF), the VP8 lossy decoder (RFC 6386: boolean decoder, intra
// prediction, dequantisation, inverse WHT / DCT, simple and normal loop
// filters), libwebp's output stage (the "fancy" 4:2:0 chroma upsampler and
// the 14-bit fixed-point YUV -> RGB), the VP8L lossless decoder (prefix
// codes, meta codes, LZ77, colour cache, the four transforms) and the ALPH
// plane (raw or VP8L levels, the three unfilters). Frame 0 of an animation
// is composed as libwebp's WebPAnimDecoder composes it: on a canvas that is
// transparent black outside the frame's rectangle.
//
// Two readings of a file, selected by ``cv2``:
//  0: Pillow's (the file goes through libwebp's demuxer and
//     WebPAnimDecoder; the frame's chunks are what the decoder sees),
//  1: OpenCV's (a still image goes through WebPDecode of the whole file;
//     a file under 32 bytes is refused; an animation as Pillow's).
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

// The container: info = {canvas width, canvas height, alpha (Pillow's mode
// is RGBA), frame 0's x offset, y offset, width, height, lossless, frames}.
int sl_webp_info(const uint8_t* data, size_t n, int cv2, int* info, char* err, int errlen);

// What OpenCV's imread reads before it checks the size: size = {width,
// height} of WebPGetFeatures over the first 32 bytes; an animation must
// also pass the demuxer.
int sl_webp_header_cv2(const uint8_t* data, size_t n, int* size, char* err, int errlen);

// Frame 0 as (canvas height, canvas width, 4) RGBA into ``out``, which the
// caller zero-fills (the canvas outside the frame stays transparent black).
int sl_webp_decode(const uint8_t* data, size_t n, int cv2, uint8_t* out, char* err,
                   int errlen);

#ifdef __cplusplus
}
#endif
