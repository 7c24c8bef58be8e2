// Pillow 12's Sun RLE, MSP v2, FLI/FLC and BLP DXT loops; see
// sl_pillow_formats.h. Built into the plain formats' core:
// g++ -O3 -shared -fPIC -std=c++17 sl_plain_formats.cpp sl_pillow_formats.cpp.

#include "sl_pillow_formats.h"

#include <stdlib.h>
#include <string.h>

#include <vector>

namespace {

inline int i16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t i32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

// FliDecode.c's error codes (Pillow's IMAGING_CODEC_*)
constexpr int OVERRUN = -1, BROKEN = -2, UNKNOWN = -3;

// One subchunk's body; returns 0, an error code, or 1 for COPY's "not
// enough data" (the decoder then returns the bytes before the subchunk).
int fli_chunk(int type, const uint8_t* data, const uint8_t* end, int xsize, int ysize,
              uint8_t* out) {
  auto oob = [&](const uint8_t* p, long n) { return p + n > end; };
  switch (type) {
    case 4:
    case 11:
    case 18:  // the palettes (Python reads them) and PSTAMP
      return 0;
    case 7: {  // SS2: word delta
      int lines = i16(data);
      data += 2;
      int l = 0, y = 0;
      for (; l < lines && y < ysize; l++, y++) {
        uint8_t* row = out + long(y) * xsize;
        if (oob(data, 2)) return OVERRUN;
        int packets = i16(data);
        data += 2;
        while (packets & 0x8000) {
          if (packets & 0x4000) {
            y += 65536 - packets;
            if (y >= ysize) return OVERRUN;
            row = out + long(y) * xsize;
          } else {
            row[xsize - 1] = uint8_t(packets);
          }
          if (oob(data, 2)) return OVERRUN;
          packets = i16(data);
          data += 2;
        }
        int p = 0, x = 0;
        for (; p < packets; p++) {
          if (oob(data, 2)) return OVERRUN;
          x += data[0];
          if (data[1] >= 128) {
            if (oob(data, 4)) return OVERRUN;
            int i = 256 - data[1];
            if (x + i + i > xsize) break;
            for (int j = 0; j < i; j++) {
              row[x++] = data[2];
              row[x++] = data[3];
            }
            data += 4;
          } else {
            int i = 2 * data[1];
            if (x + i > xsize) break;
            if (oob(data, 2 + i)) return OVERRUN;
            memcpy(row + x, data + 2, i);
            data += 2 + i;
            x += i;
          }
        }
        if (p < packets) break;
      }
      return l < lines ? OVERRUN : 0;
    }
    case 12: {  // LC: byte delta
      int y = i16(data), ymax = y + i16(data + 2);
      data += 4;
      for (; y < ymax && y < ysize; y++) {
        uint8_t* row = out + long(y) * xsize;
        if (oob(data, 1)) return OVERRUN;
        int packets = *data++;
        int p = 0, x = 0, i = 0;
        for (; p < packets; p++, x += i) {
          if (oob(data, 2)) return OVERRUN;
          x += data[0];
          if (data[1] & 0x80) {
            i = 256 - data[1];
            if (x + i > xsize) break;
            if (oob(data, 3)) return OVERRUN;
            memset(row + x, data[2], i);
            data += 3;
          } else {
            i = data[1];
            if (x + i > xsize) break;
            if (oob(data, 2 + i)) return OVERRUN;
            memcpy(row + x, data + 2, i);
            data += i + 2;
          }
        }
        if (p < packets) break;
      }
      return y < ymax ? OVERRUN : 0;
    }
    case 13:  // BLACK
      memset(out, 0, size_t(xsize) * ysize);
      return 0;
    case 15: {  // BRUN: byte run length
      for (int y = 0; y < ysize; y++) {
        uint8_t* row = out + long(y) * xsize;
        data += 1;  // the packet count, ignored
        int x = 0, i = 0;
        for (; x < xsize; x += i) {
          if (oob(data, 2)) return OVERRUN;
          if (data[0] & 0x80) {
            i = 256 - data[0];
            if (x + i > xsize) break;
            if (oob(data, i + 1)) return OVERRUN;
            memcpy(row + x, data + 1, i);
            data += i + 1;
          } else {
            i = data[0];
            if (x + i > xsize) break;
            memset(row + x, data[1], i);
            data += 2;
          }
        }
        if (x != xsize) return OVERRUN;
      }
      return 0;
    }
    case 16: {  // COPY
      if (long(xsize) * ysize > 0x7fffffffL) return OVERRUN;
      if (data + long(xsize) * ysize > end) return 1;
      memcpy(out, data, size_t(xsize) * ysize);
      return 0;
    }
    default:
      return UNKNOWN;
  }
}

inline void rgb565(int c, int* rgb) {  // unpack_565: no bit replication
  rgb[0] = ((c >> 11) & 0x1F) << 3;
  rgb[1] = ((c >> 5) & 0x3F) << 2;
  rgb[2] = (c & 0x1F) << 3;
}

}  // namespace

extern "C" {

int sl_sun_rle_decode(const uint8_t* data, size_t size, int line_bytes, int rows, uint8_t* out,
                      size_t* consumed) {
  std::vector<uint8_t> line(size_t(line_bytes) + 1);
  const uint8_t* ptr = data;
  long bytes = long(size);
  int x = 0, y = 0;
  while (bytes > 0) {
    int n, extra = 0, extra_data = 0;
    if (ptr[0] == 0x80) {
      if (bytes < 2) break;
      n = ptr[1];
      if (n == 0) {  // a literal 0x80
        n = 1;
        line[x] = 0x80;
        ptr += 2;
        bytes -= 2;
      } else {  // a run of n + 1, which may run on over the next lines
        if (bytes < 3) break;
        n += 1;
        if (x + n > line_bytes) {
          extra = (n - (line_bytes - x)) & 0xFF;
          n = line_bytes - x;
          extra_data = ptr[2];
        }
        memset(line.data() + x, ptr[2], n);
        ptr += 3;
        bytes -= 3;
      }
    } else {
      n = 1;
      line[x] = ptr[0];
      ptr += 1;
      bytes -= 1;
    }
    for (;;) {
      x += n;
      if (x >= line_bytes) {
        memcpy(out + long(y) * line_bytes, line.data(), line_bytes);
        x = 0;
        if (++y >= rows) {
          *consumed = size_t(ptr - data);
          return 1;
        }
      }
      if (extra == 0 || x > 0) break;
      n = extra >= line_bytes ? line_bytes : extra;
      memset(line.data() + x, extra_data, n);
      extra -= n;
    }
  }
  *consumed = size_t(ptr - data);
  return 0;
}

int sl_msp_rle_decode(const uint8_t* data, size_t size, const uint16_t* rowmap, int rows,
                      int blank_bytes, uint8_t** out, size_t* out_size, int* bad_row) {
  std::vector<uint8_t> img;
  size_t pos = 0;
  *bad_row = -1;
  int rc = 0;
  for (int r = 0; r < rows && rc == 0; r++) {
    size_t len = rowmap[r];
    if (len == 0) {
      img.insert(img.end(), size_t(blank_bytes), 0xFF);
      continue;
    }
    if (pos + len > size) {
      rc = 1;
      *bad_row = r;
      break;
    }
    const uint8_t* row = data + pos;
    pos += len;
    size_t idx = 0;
    while (idx < len) {
      int runtype = row[idx++];
      if (runtype == 0) {
        if (idx + 2 > len) {
          rc = 2;
          *bad_row = r;
          break;
        }
        img.insert(img.end(), size_t(row[idx]), row[idx + 1]);
        idx += 2;
      } else {
        size_t end = idx + runtype < len ? idx + runtype : len;
        img.insert(img.end(), row + idx, row + end);
        idx += runtype;
      }
    }
  }
  *out = static_cast<uint8_t*>(malloc(img.size() ? img.size() : 1));
  if (!*out) return 3;
  if (!img.empty()) memcpy(*out, img.data(), img.size());
  *out_size = img.size();
  return rc;
}

long sl_fli_decode(const uint8_t* data, size_t size, int width, int height, uint8_t* out,
                   int* errcode) {
  long bytes = long(size);
  *errcode = 0;
  if (bytes < 4) return 0;
  const uint8_t* ptr = data;
  if (((bytes + 1) & ~1L) < long(i32(ptr))) return 0;  // one pad byte may follow a frame
  if (bytes < 8) {
    *errcode = OVERRUN;
    return -1;
  }
  if (i16(ptr + 4) != 0xF1FA) {
    *errcode = UNKNOWN;
    return -1;
  }
  int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) {
      *errcode = OVERRUN;
      return -1;
    }
    int rc = fli_chunk(i16(ptr + 4), ptr + 6, ptr + bytes, width, height, out);
    if (rc == 1) return long(ptr - data);
    if (rc < 0) {
      *errcode = rc;
      return -1;
    }
    uint32_t advance = i32(ptr);
    if (advance == 0) {
      *errcode = BROKEN;
      return -1;
    }
    if (long(advance) > bytes) {
      *errcode = OVERRUN;
      return -1;
    }
    ptr += advance;
    bytes -= long(advance);
  }
  return -1;
}

void sl_blp_dxt_decode(const uint8_t* data, int kind, int alpha, int blocks, int block_rows,
                       uint8_t* out) {
  const int bpp = (kind == 1 && !alpha) ? 3 : 4;
  const long stride = long(blocks) * 4 * bpp;
  const int block_bytes = kind == 1 ? 8 : 16;
  for (int by = 0; by < block_rows; by++) {
    for (int bx = 0; bx < blocks; bx++) {
      const uint8_t* b = data + (long(by) * blocks + bx) * block_bytes;
      const uint8_t* colour = kind == 1 ? b : b + 8;
      int c0 = i16(colour), c1 = i16(colour + 2);
      uint32_t code = i32(colour + 4);
      int p[4][4];  // the four colours (and DXT1's alpha)
      rgb565(c0, p[0]);
      rgb565(c1, p[1]);
      p[0][3] = p[1][3] = p[2][3] = p[3][3] = 255;
      bool four = kind != 1 || c0 > c1;
      for (int k = 0; k < 3; k++) {
        if (four) {
          p[2][k] = (2 * p[0][k] + p[1][k]) / 3;
          p[3][k] = (2 * p[1][k] + p[0][k]) / 3;
        } else {
          p[2][k] = (p[0][k] + p[1][k]) / 2;
          p[3][k] = 0;
        }
      }
      if (!four) p[3][3] = 0;
      uint32_t a_lo = kind == 5 ? (b[2] | (b[3] << 8)) : 0;
      uint32_t a_hi = kind == 5 ? i32(b + 4) : 0;
      for (int j = 0; j < 4; j++) {
        uint8_t* o = out + (long(by) * 4 + j) * stride + long(bx) * 4 * bpp;
        for (int i = 0; i < 4; i++, o += bpp) {
          int t = 4 * j + i;
          const int* c = p[(code >> (2 * t)) & 3];
          int a = c[3];
          if (kind == 3) {
            int v = b[t / 2];
            a = (i & 1 ? v >> 4 : v & 0xF) * 17;
          } else if (kind == 5) {
            int idx = 3 * t, ac;
            if (idx <= 12)
              ac = (a_lo >> idx) & 7;
            else if (idx == 15)
              ac = (a_lo >> 15) | ((a_hi << 1) & 6);
            else
              ac = (a_hi >> (idx - 16)) & 7;
            int a0 = b[0], a1 = b[1];
            if (ac == 0)
              a = a0;
            else if (ac == 1)
              a = a1;
            else if (a0 > a1)
              a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
            else if (ac == 6)
              a = 0;
            else if (ac == 7)
              a = 255;
            else
              a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
          }
          o[0] = uint8_t(c[0]);
          o[1] = uint8_t(c[1]);
          o[2] = uint8_t(c[2]);
          if (bpp == 4) o[3] = uint8_t(a);
        }
      }
    }
  }
}

}  // extern "C"
