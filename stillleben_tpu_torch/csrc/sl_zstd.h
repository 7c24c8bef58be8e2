// Zstandard decompression for TIFF's ZSTD strips (host code, C interface
// for ctypes), linked into the plain formats' core: RFC 8878 frames.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// The frames in ``size`` bytes decompressed into ``out`` (at most
// ``capacity`` bytes; *written gets the count). Returns 0, or an error
// code of sl_plain_formats.h with a message in ``err``: 1 for what is
// refused by name (a dictionary), 2 for damaged data.
int sl_zstd_decompress(const uint8_t* data, size_t size, uint8_t* out, size_t capacity,
                       size_t* written, char* err, int errlen);

#ifdef __cplusplus
}
#endif
