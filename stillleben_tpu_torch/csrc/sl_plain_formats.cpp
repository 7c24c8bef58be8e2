// The port's core for QOI, PCX, SGI and DDS; see sl_plain_formats.h.
//
// QOI follows Pillow 12's Python codec (QoiImagePlugin.py), PCX PcxEncode.c
// and PcxDecode.c, SGI SgiRleDecode.c, and the BCn blocks the DirectX block
// specifications (BC1-BC5: the 565 endpoints with bit replication, the
// three- and four-colour BC1 modes, BC3's six- and eight-level alpha;
// BC6H: the 14 modes, their endpoint transform and unquantisation, then
// half floats clamped to 0..1 and scaled to 8 bits as Pillow does; BC7:
// the 8 modes with their partitions, anchors, p-bits and rotations).
// Build: g++ -O3 -shared -fPIC -std=c++17 sl_plain_formats.cpp.

#include "sl_plain_formats.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  int code;
  Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

[[noreturn]] void corrupt(const std::string& m) { throw Error(SL_CORRUPT, m); }
[[noreturn]] void truncated(const std::string& m) { throw Error(SL_TRUNCATED, m); }

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.what());
  return e.code;
}

int hand_out(const std::vector<uint8_t>& v, uint8_t** out, size_t* out_size) {
  *out = static_cast<uint8_t*>(malloc(v.size() ? v.size() : 1));
  if (!*out) throw Error(SL_NO_ROOM, "out of memory");
  memcpy(*out, v.data(), v.size());
  *out_size = v.size();
  return SL_OK;
}

// ---------------------------------------------------------------------------
// QOI
// ---------------------------------------------------------------------------

struct Px {
  uint8_t r, g, b, a;
  bool operator==(const Px& o) const { return r == o.r && g == o.g && b == o.b && a == o.a; }
};

inline int qoi_hash(const Px& p) { return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11) % 64; }

inline int delta(int left, int right) {  // QoiEncoder._delta
  int d = (left - right) & 255;
  return d >= 128 ? d - 256 : d;
}

void qoi_encode(const uint8_t* pix, int w, int h, int ch, std::vector<uint8_t>& out) {
  Px seen[64];
  bool known[64] = {};
  seen[0] = Px{0, 0, 0, 0};  // the encoder's index starts as {0: (0, 0, 0, 0)}
  known[0] = true;
  Px prev{0, 0, 0, 255};
  int run = 0;
  const size_t n = size_t(w) * h;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* q = pix + i * ch;
    Px p{q[0], q[1], q[2], uint8_t(ch == 4 ? q[3] : 255)};
    if (p == prev) {
      if (++run == 62) {
        out.push_back(uint8_t(0xC0 | (run - 1)));
        run = 0;
      }
    } else {
      if (run) {
        out.push_back(uint8_t(0xC0 | (run - 1)));
        run = 0;
      }
      int hv = qoi_hash(p);
      if (known[hv] && seen[hv] == p) {
        out.push_back(uint8_t(hv));
      } else {
        seen[hv] = p;
        known[hv] = true;
        if (prev.a == p.a) {
          int dr = delta(p.r, prev.r), dg = delta(p.g, prev.g), db = delta(p.b, prev.b);
          if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
            out.push_back(uint8_t(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2)));
          } else {
            int dgr = delta(dr, dg), dgb = delta(db, dg);
            if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
              out.push_back(uint8_t(0x80 | (dg + 32)));
              out.push_back(uint8_t((dgr + 8) << 4 | (dgb + 8)));
            } else {
              out.insert(out.end(), {0xFE, p.r, p.g, p.b});
            }
          }
        } else {
          out.insert(out.end(), {0xFF, p.r, p.g, p.b, p.a});
        }
      }
    }
    prev = p;
  }
  if (run) out.push_back(uint8_t(0xC0 | (run - 1)));
  out.insert(out.end(), {0, 0, 0, 0, 0, 0, 0, 1});
}

void qoi_decode(const uint8_t* d, size_t size, int w, int h, int ch, uint8_t* out) {
  Px seen[64];
  bool known[64] = {};
  Px prev{0, 0, 0, 255};
  const size_t total = size_t(w) * h * ch;
  size_t pos = 0, filled = 0;
  auto need = [&](size_t k) {
    if (pos + k > size) truncated("QOI data ends before the image");
  };
  auto put = [&](const Px& p) {
    const uint8_t v[4] = {p.r, p.g, p.b, p.a};
    for (int c = 0; c < ch && filled < total; ++c) out[filled++] = v[c];
  };
  while (filled < total) {
    need(1);
    const uint8_t byte = d[pos++];
    Px v;
    if (byte == 0xFE) {
      need(3);
      v = Px{d[pos], d[pos + 1], d[pos + 2], prev.a};
      pos += 3;
    } else if (byte == 0xFF) {
      need(4);
      v = Px{d[pos], d[pos + 1], d[pos + 2], d[pos + 3]};
      pos += 4;
    } else {
      const int op = byte >> 6;
      if (op == 0) {
        v = known[byte & 63] ? seen[byte & 63] : Px{0, 0, 0, 0};
      } else if (op == 1) {
        v = Px{uint8_t(prev.r + ((byte >> 4) & 3) - 2), uint8_t(prev.g + ((byte >> 2) & 3) - 2),
               uint8_t(prev.b + (byte & 3) - 2), prev.a};
      } else if (op == 2) {
        need(1);
        const uint8_t second = d[pos++];
        const int dg = (byte & 63) - 32;
        v = Px{uint8_t(prev.r + dg + ((second >> 4) - 8)), uint8_t(prev.g + dg),
               uint8_t(prev.b + dg + ((second & 15) - 8)), prev.a};
      } else {  // a run repeats the previous pixel and leaves the index alone
        for (int k = (byte & 63) + 1; k > 0; --k) put(prev);
        continue;
      }
    }
    prev = v;
    seen[qoi_hash(v)] = v;
    known[qoi_hash(v)] = true;
    put(v);
  }
}

// ---------------------------------------------------------------------------
// PCX
// ---------------------------------------------------------------------------

void pcx_encode(const uint8_t* rows, int bpl, int planes, int height, std::vector<uint8_t>& out) {
  const int padding = bpl % 2;
  const int line = bpl * planes;
  for (int y = 0; y < height; ++y) {
    const uint8_t* buf = rows + size_t(y) * line;
    int x = 1, count = 1;
    int last = buf[0];
    auto flush = [&]() {
      if (count == 1 && last < 0xC0) {
        out.push_back(uint8_t(last));
      } else if (count > 0) {
        out.push_back(uint8_t(0xC0 | count));
        out.push_back(uint8_t(last));
      }
    };
    do {
      while (x % bpl) {
        if (count == 63) {  // a full run
          out.push_back(0xFF);
          out.push_back(uint8_t(last));
          count = 0;
        }
        const int cur = buf[x];
        if (cur == last) {
          ++x;
          ++count;
        } else {
          flush();
          last = cur;
          count = 1;
          ++x;
        }
      }
      flush();  // the end of a plane's line: its run ends there
      for (int i = 0; i < padding; ++i) out.push_back(0);
      if (x < line) {
        count = 1;
        last = buf[x];
        ++x;
      }
    } while (x < line);
  }
}

void pcx_decode(const uint8_t* d, size_t size, int row_bytes, int height, uint8_t* out) {
  size_t pos = 0;
  int x = 0;
  bool overrun = false;
  std::vector<uint8_t> buf(row_bytes, 0);
  for (int y = 0; y < height;) {
    if (pos >= size) truncated("image file is truncated");
    if ((d[pos] & 0xC0) == 0xC0) {
      if (pos + 1 >= size) truncated("image file is truncated");
      int n = d[pos] & 0x3F;
      while (n > 0) {
        if (x >= row_bytes) {
          overrun = true;
          break;
        }
        buf[x++] = d[pos + 1];
        --n;
      }
      pos += 2;
    } else {
      buf[x++] = d[pos++];
    }
    if (x >= row_bytes) {
      memcpy(out + size_t(y) * row_bytes, buf.data(), row_bytes);
      x = 0;
      ++y;
    }
  }
  if (overrun) corrupt("buffer overrun when reading image file");
}

// ---------------------------------------------------------------------------
// SGI run-length rows
// ---------------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

// expandrow / expandrow2: 0 at the row's terminator, 1 where the row's
// length runs out on a byte that is not one (the decoder stops there), -1
// for a run outside the row or the data
int sgi_row(uint8_t* dest, const uint8_t* src, long n, int z, int xsize, const uint8_t* end,
            int bpc) {
  int x = 0;
  for (; n > 0; --n) {
    if (src + (bpc - 1) > end) return -1;
    const uint8_t pixel = src[bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (bpc == 1 ? src + count > end : src + 2 * count > end) return -1;
      while (count--) {
        memcpy(dest, src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (bpc == 1 ? src > end : src + 2 > end) return -1;
      while (count--) {
        memcpy(dest, src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

int sgi_rle(const uint8_t* file, size_t size, int xsize, int ysize, int zsize, int bpc,
            uint8_t* out) {
  const size_t header = 512;
  if (size < header) corrupt("SGI data ends inside its header");
  const size_t bufsize = size - header;
  const uint8_t* ptr = file + header;
  const size_t tablen = size_t(zsize) * ysize;
  if (bufsize < 8 * tablen) corrupt("buffer overrun when reading image file");
  const size_t row_bytes = size_t(xsize) * zsize * bpc;
  std::vector<uint8_t> buf(row_bytes, 0);  // kept from row to row, as the decoder's is
  const uint8_t* end = ptr + bufsize - 1;
  for (int row = 0; row < ysize; ++row) {
    for (int c = 0; c < zsize; ++c) {
      const size_t t = size_t(row) + size_t(c) * ysize;
      uint32_t offset = be32(ptr + 4 * t), length = be32(ptr + 4 * (tablen + t));
      if (offset < header) corrupt("buffer overrun when reading image file");
      offset -= header;
      if (uint64_t(offset) + length > bufsize) corrupt("buffer overrun when reading image file");
      const int status = sgi_row(buf.data() + c * bpc, ptr + offset, long(length), zsize, xsize,
                                 end, bpc);
      if (status == -1) corrupt("buffer overrun when reading image file");
      if (status == 1) return row;
    }
    memcpy(out + size_t(row) * row_bytes, buf.data(), row_bytes);
  }
  return ysize;
}

// ---------------------------------------------------------------------------
// BCn blocks
// ---------------------------------------------------------------------------

struct Rgba {
  uint8_t r, g, b, a;
};

inline uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

Rgba decode_565(uint16_t x) {
  int r = (x & 0xF800) >> 8, g = (x & 0x7E0) >> 3, b = (x & 0x1F) << 3;
  return Rgba{uint8_t(r | r >> 5), uint8_t(g | g >> 6), uint8_t(b | b >> 5), 255};
}

// BC1's colour block; BC2 and BC3 always take its four-colour mode
void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = le16(src), c1 = le16(src + 2);
  const uint32_t lut = le32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = Rgba{uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3),
                255};
    p[3] = Rgba{uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3),
                255};
  } else {
    p[2] = Rgba{uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) dst[i] = p[3 & (lut >> (2 * i))];
}

// BC3's alpha block (BC4's and BC5's channels); ``sign``: BC5S, whose
// signed endpoints are taken as v + 128
void bc3_alpha(uint8_t* dst, int stride, const uint8_t* src, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = int8_t(src[0]) + 128;
    a1 = int8_t(src[1]) + 128;
  }
  uint8_t a[8] = {uint8_t(a0), uint8_t(a1)};
  if (a0 > a1) {
    for (int i = 1; i < 7; ++i) a[i + 1] = uint8_t(((7 - i) * a0 + i * a1) / 7);
  } else {
    for (int i = 1; i < 5; ++i) a[i + 1] = uint8_t(((5 - i) * a0 + i * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  const uint32_t lut1 = src[2] | src[3] << 8 | src[4] << 16;
  const uint32_t lut2 = src[5] | src[6] << 8 | src[7] << 16;
  for (int i = 0; i < 8; ++i) dst[stride * i] = a[7 & (lut1 >> (3 * i))];
  for (int i = 0; i < 8; ++i) dst[stride * (8 + i)] = a[7 & (lut2 >> (3 * i))];
}

inline int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

inline int get_bits(const uint8_t* src, int bit, int count) {
  int v = 0;
  for (int i = 0; i < count; ++i) v |= get_bit(src, bit + i) << i;
  return v;
}

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

// the 2-subset partitions (bit i: pixel i's subset) and the 3-subset ones
// (two bits per pixel), shared by BC6H (the first 32) and BC7
const uint16_t kPartition2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
const uint32_t kPartition3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254};
// the anchor pixel of subset 1 among two subsets, and of subsets 1 and 2
// among three (subset 0's is pixel 0)
const uint8_t kAnchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                              15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                              15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                              6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                               3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                               8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                               3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                               15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                               15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                               15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

int subset_of(int ns, int partition, int pixel) {
  if (ns == 2) return (kPartition2[partition] >> pixel) & 1;
  if (ns == 3) return (kPartition3[partition] >> (2 * pixel)) & 3;
  return 0;
}

bool is_anchor(int ns, int partition, int pixel) {
  if (pixel == 0) return true;
  if (ns == 2) return pixel == kAnchor2[partition];
  if (ns == 3) return pixel == kAnchor3a[partition] || pixel == kAnchor3b[partition];
  return false;
}

// BC7: subsets, partition bits, rotation bits, index-selection bit,
// colour bits, alpha bits, per-endpoint p-bits, shared p-bits, index bits,
// secondary index bits
struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline uint8_t expand_bits(int v, int bits) {
  v <<= 8 - bits;
  return uint8_t(v | v >> bits);
}

void decode_bc7(Rgba* col, const uint8_t* src) {
  if (!src[0]) {  // no mode bit in the first byte (mode 8, reserved): opaque black
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  const int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  const int nep = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c) {
    for (int e = 0; e < nep; ++e) {
      ep[e][c] = get_bits(src, bit, m.cb);
      bit += m.cb;
    }
  }
  for (int e = 0; e < nep; ++e) {
    if (m.ab) {
      ep[e][3] = get_bits(src, bit, m.ab);
      bit += m.ab;
    }
  }
  if (!m.ab) {
    for (int e = 0; e < nep; ++e) ep[e][3] = 0;
  }
  int cbits = m.cb, abits = m.ab;
  if (m.epb || m.spb) {
    ++cbits;
    if (m.ab) ++abits;
    for (int e = 0; e < nep; ++e) {
      int p;
      if (m.epb) {
        p = get_bit(src, bit + e);
      } else {
        p = get_bit(src, bit + e / 2);
      }
      for (int c = 0; c < 3; ++c) ep[e][c] = ep[e][c] << 1 | p;
      if (m.ab) ep[e][3] = ep[e][3] << 1 | p;
    }
    bit += m.epb ? nep : m.ns;
  }
  Rgba e8[6];
  for (int e = 0; e < nep; ++e) {
    e8[e].r = expand_bits(ep[e][0], cbits);
    e8[e].g = expand_bits(ep[e][1], cbits);
    e8[e].b = expand_bits(ep[e][2], cbits);
    e8[e].a = m.ab ? expand_bits(ep[e][3], abits) : 255;
  }
  int idx1[16], idx2[16] = {};
  for (int i = 0; i < 16; ++i) {
    const int n = m.ib - (is_anchor(m.ns, partition, i) ? 1 : 0);
    idx1[i] = get_bits(src, bit, n);
    bit += n;
  }
  if (m.ib2) {
    for (int i = 0; i < 16; ++i) {
      const int n = m.ib2 - (i == 0 ? 1 : 0);
      idx2[i] = get_bits(src, bit, n);
      bit += n;
    }
  }
  for (int i = 0; i < 16; ++i) {
    const int s = subset_of(m.ns, partition, i);
    const Rgba& a = e8[2 * s];
    const Rgba& b = e8[2 * s + 1];
    int wc, wa;
    if (!m.ib2) {
      wc = wa = weights(m.ib)[idx1[i]];
    } else if (index_sel) {
      wc = weights(m.ib2)[idx2[i]];
      wa = weights(m.ib)[idx1[i]];
    } else {
      wc = weights(m.ib)[idx1[i]];
      wa = weights(m.ib2)[idx2[i]];
    }
    Rgba o{uint8_t(((64 - wc) * a.r + wc * b.r + 32) >> 6),
           uint8_t(((64 - wc) * a.g + wc * b.g + 32) >> 6),
           uint8_t(((64 - wc) * a.b + wc * b.b + 32) >> 6),
           uint8_t(((64 - wa) * a.a + wa * b.a + 32) >> 6)};
    if (rotation == 1) std::swap(o.r, o.a);
    if (rotation == 2) std::swap(o.g, o.a);
    if (rotation == 3) std::swap(o.b, o.a);
    col[i] = o;
  }
}

// BC6H: subsets, transformed endpoints, partition bits, endpoint bits and
// the delta bits of red, green and blue
struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// Where each bit after the mode bits goes, as (component << 4 | bit): the
// components are r, g, b of endpoints w, x, y, z (w, x: subset 0's; y, z:
// subset 1's), so 0x74 is gy[4]. These are the field layouts of the
// specification's BC6H mode table, mode by mode (modes 1-2 after 2 mode
// bits, 3-14 after 5).
const uint8_t kBc6Layout[14][75] = {
    {116, 132, 180, 0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,
     22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,
     164, 112, 113, 114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,
     84,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0,   1,   2,   3,   4,   5,   6,   176, 177, 132, 16,  17,  18,  19,  20,  21,
     22,  133, 178, 116, 32,  33,  34,  35,  36,  37,  38,  179, 181, 180, 48,  49,  50,  51,  52,
     53,  112, 113, 114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,
     84,  85,  128, 129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,  10,  112, 113,
     114, 115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,  82,  83,  42,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  10,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  26,  160, 161, 162, 163, 80,  81,  82,  83,  42,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  176, 178, 144, 145, 146, 147, 116, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  10,  132, 112, 113,
     114, 115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  42,  128,
     129, 130, 131, 96,  97,  98,  99,  177, 178, 144, 145, 146, 147, 180, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   132, 16,  17,  18,  19,  20,  21,  22,  23,  24,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  40,  180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   164, 132, 16,  17,  18,  19,  20,  21,  22,  23,  178,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  179, 180, 48,  49,  50,  51,  52,  53,  112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   176, 132, 16,  17,  18,  19,  20,  21,  22,  23,  117,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  165, 180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   177, 132, 16,  17,  18,  19,  20,  21,  22,  23,  133,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  181, 180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  85,  128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   164, 176, 177, 132, 16,  17,  18,  19,  20,  21,  117, 133, 178,
     116, 32,  33,  34,  35,  36,  37,  165, 179, 181, 180, 48,  49,  50,  51,  52,  53,  112, 113,
     114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,  84,  85,  128,
     129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
     64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10,
     64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10,
     64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10,
     64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}};

inline int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (bits - 1);
  }
  v = int16_t(v & 0xFFFF);  // the endpoint as a 16-bit signed number
  if (bits >= 16) return v;
  const bool neg = v < 0;
  int x = neg ? -v : v;
  if (x != 0) x = x >= (1 << (bits - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (bits - 1);
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  const int sign = h >> 15, exp = (h >> 10) & 31, mant = h & 1023;
  float v;
  if (exp == 0) {
    v = float(mant) / 1024.0f / 16384.0f;
  } else if (exp == 31) {
    v = mant ? __builtin_nanf("") : __builtin_inff();
  } else {
    v = (1.0f + float(mant) / 1024.0f);
    v = exp >= 15 ? v * float(1 << (exp - 15)) : v / float(1 << (15 - exp));
  }
  return sign ? -v : v;
}

// the interpolated value as a half float, scaled to 8 bits (clamped to 0..1)
uint8_t bc6_to_8bit(int v, bool sign) {
  uint16_t h;
  if (sign) {
    h = v < 0 ? uint16_t(0x8000 | ((-v) * 31) / 32) : uint16_t((v * 31) / 32);
  } else {
    h = uint16_t((v * 31) / 64);
  }
  const float f = half_to_float(h);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void decode_bc6(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1F, bit, nbits, ib;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
    nbits = 75;
    ib = 3;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    bit = 5;
    nbits = 72;
    ib = 3;
  } else {
    mode = 10 + (mode >> 2);
    bit = 5;
    nbits = 60;
    ib = 4;
  }
  if (mode >= 14) {  // the four reserved modes
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {};
  for (int i = 0; i < nbits; ++i) {
    const int d = kBc6Layout[mode][i];
    ep[d >> 4] |= get_bit(src, bit + i) << (d & 15);
  }
  bit += nbits;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int nep = m.ns == 2 ? 12 : 6;
  const int delta_bits[3] = {m.rb, m.gb, m.bb};
  if (sign) {
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
  }
  if (sign || m.tr) {
    for (int i = 3; i < nep; ++i) ep[i] = sign_extend(ep[i], delta_bits[i % 3]);
  }
  if (m.tr) {  // the deltas, masked to the endpoint's bits and not extended again
    const int mask = (1 << m.epb) - 1;
    for (int i = 3; i < nep; ++i) ep[i] = (ep[i] + ep[i % 3]) & mask;
  }
  int u[12];
  for (int i = 0; i < nep; ++i) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const bool anchor = i == 0 || (m.ns == 2 && i == kAnchor2[partition]);
    const int n = ib - (anchor ? 1 : 0);
    const int idx = get_bits(src, bit, n);
    bit += n;
    const int s = subset_of(m.ns, partition, i);
    const int* a = u + 6 * s;
    const int* b = a + 3;
    const int wt = w[idx];
    uint8_t c8[3];
    for (int c = 0; c < 3; ++c) c8[c] = bc6_to_8bit((a[c] * (64 - wt) + b[c] * wt) >> 6, sign);
    col[i] = Rgba{c8[0], c8[1], c8[2], 0};
  }
}

void bcn(const uint8_t* d, size_t size, int n, bool sign, int w, int h, uint8_t* out) {
  const int bw = (w + 3) / 4, bh = (h + 3) / 4;
  const int block = (n == 1 || n == 4) ? 8 : 16;
  const int px = n == 4 ? 1 : 4;
  if (size < size_t(bw) * bh * block) truncated("image file is truncated");
  const size_t stride = size_t(bw) * 4 * px;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const uint8_t* src = d + (size_t(by) * bw + bx) * block;
      Rgba col[16] = {};
      uint8_t lum[16] = {};
      switch (n) {
        case 1:
          bc1_color(col, src, false);
          break;
        case 2:
          bc1_color(col, src + 8, true);
          for (int i = 0; i < 16; ++i) {
            const int av = 0xF & (src[i >> 1] >> ((4 * i) & 7));
            col[i].a = uint8_t(av << 4 | av);
          }
          break;
        case 3:
          bc1_color(col, src + 8, true);
          bc3_alpha(&col[0].a, 4, src, false);
          break;
        case 4:
          bc3_alpha(lum, 1, src, false);
          break;
        case 5:
          bc3_alpha(&col[0].r, 4, src, sign);
          bc3_alpha(&col[0].g, 4, src + 8, sign);
          if (sign) {
            for (int i = 0; i < 16; ++i) col[i].b = 128;  // BC5S's blue: signed zero
          }
          break;
        case 6:
          decode_bc6(col, src, sign);
          break;
        default:
          decode_bc7(col, src);
      }
      for (int i = 0; i < 16; ++i) {
        uint8_t* o = out + (size_t(by) * 4 + i / 4) * stride + (size_t(bx) * 4 + i % 4) * px;
        if (px == 1) {
          o[0] = lum[i];
        } else {
          o[0] = col[i].r;
          o[1] = col[i].g;
          o[2] = col[i].b;
          o[3] = col[i].a;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int sl_qoi_encode(const uint8_t* pixels, int width, int height, int channels, uint8_t** out,
                  size_t* out_size, char* err, int errlen) {
  try {
    std::vector<uint8_t> v;
    v.reserve(size_t(width) * height * (channels + 1) / 2 + 8);
    qoi_encode(pixels, width, height, channels, v);
    return hand_out(v, out, out_size);
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_qoi_decode(const uint8_t* data, size_t size, int width, int height, int channels,
                  uint8_t* out, char* err, int errlen) {
  try {
    qoi_decode(data, size, width, height, channels, out);
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_pcx_encode(const uint8_t* rows, int bytes_per_line, int planes, int height, uint8_t** out,
                  size_t* out_size, char* err, int errlen) {
  try {
    std::vector<uint8_t> v;
    v.reserve(size_t(bytes_per_line + 1) * planes * height + 16);
    pcx_encode(rows, bytes_per_line, planes, height, v);
    return hand_out(v, out, out_size);
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_pcx_decode(const uint8_t* data, size_t size, int row_bytes, int height, uint8_t* out,
                  char* err, int errlen) {
  try {
    pcx_decode(data, size, row_bytes, height, out);
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_sgi_rle_decode(const uint8_t* data, size_t size, int xsize, int ysize, int zsize, int bpc,
                      uint8_t* out, int* rows, char* err, int errlen) {
  try {
    *rows = sgi_rle(data, size, xsize, ysize, zsize, bpc, out);
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_bcn_decode(const uint8_t* data, size_t size, int n, int sign, int width, int height,
                  uint8_t* out, char* err, int errlen) {
  try {
    if (n < 1 || n > 7) throw Error(SL_UNSUPPORTED, "BCn format " + std::to_string(n));
    bcn(data, size, n, sign != 0, width, height, out);
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

void sl_plain_free(uint8_t* p) { free(p); }

}  // extern "C"
