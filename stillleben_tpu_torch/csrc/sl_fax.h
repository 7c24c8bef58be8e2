// CCITT bilevel decoding for TIFF (host code, C interface for ctypes),
// linked into the plain formats' core: modified Huffman run-length rows
// (TIFF compression 2), Group 3 (3: T.4 one- and two-dimensional rows
// behind EOLs) and Group 4 (4: T.6), as libtiff 4.7's tif_fax3.c decodes
// a strip or a tile. The macros of its tif_fax3.h are followed step for
// step: the bit accumulator that pads the data's end with zeros, the
// EOL search, the run arrays whose clamping the fill leaves in the
// reference line, and the cleanup of a row whose runs do not add up.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// ``rows`` rows of ``width`` pixels from ``size`` bytes read most
// significant bit first (the caller reverses FillOrder 2 data): ``mode`` 2
// (modified Huffman, rows byte-aligned), 3 (Group 3; ``t4options`` bit 0:
// two-dimensional rows) or 4 (Group 4). ``out`` gets rows x ceil(width / 8)
// bytes, a black pixel a 1 bit (libtiff's fill). Returns 0, or 1 where the
// data ends before the last row (libtiff's -1; as libtiff 4.7 does, Group 3
// forgives it, the rows after left white, and Group 4 once a row is done),
// or 2 where a row's runs overflow libtiff's run arrays; *rows_done counts
// the rows filled.
int sl_fax_decode(const uint8_t* data, size_t size, int mode, int width, int rows,
                  int t4options, uint8_t* out, int* rows_done);

#ifdef __cplusplus
}
#endif
