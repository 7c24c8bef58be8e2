// The port's native image codec core; see sl_image.h.
//
// The JPEG arithmetic follows libjpeg-turbo's default paths, whose SIMD
// versions compute the same numbers: jidctint.c (ISLOW IDCT), jdsample.c
// (fancy h2v1 / h1v2 / h2v2 upsampling, replication otherwise), jdcolor.c
// (fixed-point YCbCr -> RGB), jccolor.c, jcsample.c (h2v1 / h2v2 averaging
// with the alternating bias), jfdctint.c and jcdctmgr.c (rounded division
// by the scaled quantiser), jcparam.c's quality scaling and jstdhuff.c's
// tables. Build: g++ -O3 -shared -fPIC -std=c++17 sl_image.cpp.

#include "sl_image.h"

#include <stdio.h>
#include <string.h>

#include <algorithm>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  int code;
  Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

[[noreturn]] void corrupt(const std::string& m) { throw Error(SL_CORRUPT, m); }
[[noreturn]] void unsupported(const std::string& m) { throw Error(SL_UNSUPPORTED, m); }

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.what());
  return e.code;
}

// zigzag position -> natural (row-major) position; 16 extra entries absorb
// a corrupt run past the end of a block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// integer DCTs (CONST_BITS 13, PASS1_BITS 2)
// ---------------------------------------------------------------------------

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c's ISLOW IDCT as libjpeg-turbo's SIMD version (jidctint-sse2 /
// -avx2) computes it, which libjpeg-turbo decodes with on x86: the
// dequantised coefficients, the workspace and the sums of two 16-bit
// values are 16-bit words (wrapping); the products are pairs of 16-bit
// multiplies summed in 32 bits; each pass ends in a saturating pack. On a
// valid file no word overflows and this is jidctint.c's arithmetic exactly;
// on damaged data (coefficients decoded from zeros past a cut) the words
// wrap as the libraries' do.
inline int32_t w16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
inline int32_t add32(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub32(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }
inline int32_t sat16(int32_t v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }

// one 1-D pass over 8 words; out[k] before its descale
inline void idct_1d(const int32_t* in, int32_t* out) {
  const int32_t F029 = FIX_0_298631336, F039 = FIX_0_390180644, F054 = FIX_0_541196100,
                F076 = FIX_0_765366865, F089 = FIX_0_899976223, F117 = FIX_1_175875602,
                F150 = FIX_1_501321110, F184 = FIX_1_847759065, F196 = FIX_1_961570560,
                F205 = FIX_2_053119869, F256 = FIX_2_562915447, F307 = FIX_3_072711026;
  // even part
  int32_t z2 = in[2], z3 = in[6];
  int32_t tmp3 = add32(z2 * (F054 + F076), z3 * F054);
  int32_t tmp2 = add32(z2 * F054, z3 * (F054 - F184));
  int32_t tmp0 = int32_t(uint32_t(w16(in[0] + in[4])) << 13);
  int32_t tmp1 = int32_t(uint32_t(w16(in[0] - in[4])) << 13);
  int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  // odd part
  int32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  int32_t z3o = w16(t0 + t2), z4o = w16(t1 + t3);
  int32_t Z3 = add32(z3o * (F117 - F196), z4o * F117);
  int32_t Z4 = add32(z3o * F117, z4o * (F117 - F039));
  int32_t o0 = add32(add32(t0 * (F029 - F089), t3 * -F089), Z3);
  int32_t o3 = add32(add32(t0 * -F089, t3 * (F150 - F089)), Z4);
  int32_t o1 = add32(add32(t1 * (F205 - F256), t2 * -F256), Z4);
  int32_t o2 = add32(add32(t1 * -F256, t2 * (F307 - F256)), Z3);
  out[0] = add32(tmp10, o3);
  out[7] = sub32(tmp10, o3);
  out[1] = add32(tmp11, o2);
  out[6] = sub32(tmp11, o2);
  out[2] = add32(tmp12, o1);
  out[5] = sub32(tmp12, o1);
  out[3] = add32(tmp13, o0);
  out[4] = sub32(tmp13, o0);
}

// dequantise and inverse-transform one block into 8 rows of out
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  bool ac_zero = true;  // the SIMD pass 1 takes a block whose rows 1-7 are zero as DC only
  for (int k = 8; k < 64 && ac_zero; k++) ac_zero = coef[k] == 0;
  int32_t col[8], res[8];
  for (int c = 0; c < 8; c++) {
    if (ac_zero) {
      int32_t dc = w16(w16(int32_t(coef[c]) * q[c]) << 2);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; r++) col[r] = w16(int32_t(coef[8 * r + c]) * q[8 * r + c]);
    idct_1d(col, res);
    for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(add32(res[r], 1 << 10) >> 11);
  }
  for (int r = 0; r < 8; r++) {
    idct_1d(ws + 8 * r, res);
    uint8_t* o = out + r * stride;
    for (int k = 0; k < 8; k++) {
      int32_t v = add32(res[k], 1 << 17) >> 18;
      o[k] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
}

// jfdctint.c: one block of (sample - 128) values, in place; output scaled by 8
void fdct_islow(int* d) {
  for (int r = 0; r < 8; r++) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) << 2);
    p[4] = int((tmp10 - tmp11) << 2);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, 11));
    p[6] = int(descale(z1 - tmp12 * FIX_1_847759065, 11));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, 11));
    p[5] = int(descale(tmp5 + z2 + z4, 11));
    p[3] = int(descale(tmp6 + z2 + z3, 11));
    p[1] = int(descale(tmp7 + z1 + z4, 11));
  }
  for (int c = 0; c < 8; c++) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32],
            tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, 2));
    p[32] = int(descale(tmp10 - tmp11, 2));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, 15));
    p[48] = int(descale(z1 - tmp12 * FIX_1_847759065, 15));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, 15));
    p[40] = int(descale(tmp5 + z2 + z4, 15));
    p[24] = int(descale(tmp6 + z2 + z3, 15));
    p[8] = int(descale(tmp7 + z1 + z4, 15));
  }
}

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------

struct HuffSpec {
  uint8_t bits[17] = {0};  // bits[l]: codes of length l
  uint8_t vals[256] = {0};
  int count = 0;
};

// jstdhuff.c
const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChr[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValsAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValsAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffSpec make_spec(const uint8_t* bits, const uint8_t* vals) {
  HuffSpec s;
  memcpy(s.bits, bits, 17);
  for (int l = 1; l <= 16; l++) s.count += bits[l];
  memcpy(s.vals, vals, s.count);
  return s;
}

// canonical codes of a spec, in the order of its values
void canonical_codes(const HuffSpec& s, std::vector<int>& code, std::vector<int>& size) {
  code.clear();
  size.clear();
  int c = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < s.bits[l]; i++) {
      size.push_back(l);
      code.push_back(c++);
    }
    if (c > (1 << l)) corrupt("JPEG: bad Huffman table");
    c <<= 1;
  }
}

struct HuffDec {
  bool present = false;
  int maxcode[18];
  int valoffset[17];
  uint8_t vals[256];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 = longer code
  void build(const HuffSpec& s) {
    std::vector<int> code, size;
    canonical_codes(s, code, size);
    memcpy(vals, s.vals, 256);
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (s.bits[l]) {
        valoffset[l] = p - code[p];
        p += s.bits[l];
        maxcode[l] = code[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    memset(look, 0, sizeof(look));
    for (int i = 0; i < s.count; i++) {
      if (size[i] > 9) continue;
      int shift = 9 - size[i];
      for (int j = 0; j < (1 << shift); j++)
        look[(code[i] << shift) | j] = uint16_t((size[i] << 8) | s.vals[i]);
    }
    present = true;
  }
};

// ---------------------------------------------------------------------------
// JPEG decoder
// ---------------------------------------------------------------------------

// where the entropy data of a segment resumes after its RSTn marker: the
// marker at or after p (any bytes before it are skipped, as libjpeg's
// next_marker skips them); found is whether it is the expected one
size_t seek_restart(const uint8_t* d, size_t n, size_t p, int expected, bool& found) {
  while (p + 1 < n) {
    if (d[p] == 0xFF && d[p + 1] != 0 && d[p + 1] != 0xFF) break;
    p++;
  }
  found = p + 1 < n && d[p + 1] == 0xD0 + expected;
  return found ? p + 2 : p;
}

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;  // a marker ends the entropy data: zeros follow
  bool ran_out = false;    // the data ended inside the entropy data
  bool insufficient = false;
  int fake = 0;            // how many of the buffered bits stand in for missing data
  size_t marker_pos = 0;

  BitReader(const uint8_t* d_, size_t n_, size_t p) : d(d_), n(n_), pos(p) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos >= n) ran_out = true;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) p++;
          if (p < n && d[p] == 0) {
            pos = p + 1;
          } else {
            at_marker = true;
            marker_pos = pos;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      if (at_marker || ran_out) fake += 8;
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  // consuming a zero that stands in for data that is not there marks the
  // rest of the segment as missing (libjpeg's insufficient_data)
  inline void consume(int k) {
    nbits -= k;
    if (nbits < fake) {
      fake = nbits;
      insufficient = true;
    }
  }
  inline int bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    consume(k);
    return int((acc >> nbits) & ((uint64_t(1) << k) - 1));
  }
  inline int peek9() {
    if (nbits < 16) fill();
    return int((acc >> (nbits - 9)) & 511);
  }
  int decode(const HuffDec& h) {
    int v = h.look[peek9()];
    if (v) {
      consume(v >> 8);
      return v & 255;
    }
    int code = bits(1), l = 1;
    while (code > h.maxcode[l]) {
      code = (code << 1) | bits(1);
      if (++l > 16) return 0;  // libjpeg warns and returns 0
    }
    return h.vals[code + h.valoffset[l]];
  }
  // the restart: drop the buffered bits, consume the RSTn marker
  void restart(int expected) {
    acc = 0;
    nbits = fake = 0;
    bool found;
    size_t p = seek_restart(d, n, at_marker ? marker_pos : pos, expected, found);
    if (found) {
      pos = p;
      at_marker = false;
      insufficient = false;  // kept when the marker is not there (libjpeg's process_restart)
    } else {
      // resync: leave the marker to the marker reader, decode zeros
      pos = marker_pos = p;
      at_marker = true;
    }
  }
  size_t end() const { return at_marker ? marker_pos : pos; }
};

// jaricom.c: the QM coder's probability states (T.81 Table D.2):
// Qe_Value, Next_Index_LPS, Next_Index_MPS, Switch_MPS
const uint16_t kAri[114][4] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},    {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0},    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},   {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},   {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0},   {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},   {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},   {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0},   {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},   {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},   {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},   {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},   {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},   {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0},   {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},   {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},   {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0},   {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},   {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},   {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1},   {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},   {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},   {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0},   {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},  {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0},  {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1},
    {0x5a1d, 113, 113, 0}};  // T.851's fixed estimate of 0.5 (the sign and refinement bits)

// jdarith.c: the QM decoder over one segment of entropy data; a marker
// (or the end of the data) supplies zeros from there on, as libjpeg does
struct ArithReader {
  const uint8_t* d;
  size_t n, pos;
  bool at_marker = false, ran_out = false;
  size_t marker_pos = 0;
  size_t furthest = 0;  // one past the last byte read (n + 1: a byte past the end)
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read first; -1: a bad code, decode nothing
  // past the end of the data the QM decoder reads zeros and goes on; each
  // MCU's decoder checks ct for a bad code itself
  static constexpr bool insufficient = false;

  ArithReader(const uint8_t* d_, size_t n_, size_t p) : d(d_), n(n_), pos(p) {}

  int byte() {
    if (at_marker) return 0;
    if (pos >= n) {
      ran_out = at_marker = true;
      marker_pos = n;
      furthest = n + 1;
      return 0;
    }
    int v = d[pos++];
    furthest = std::max(furthest, pos);
    if (v != 0xFF) return v;
    size_t p = pos;
    while (p < n && d[p] == 0xFF) p++;
    furthest = std::max(furthest, p + 1);  // the marker's code byte (or past the end)
    if (p < n && d[p] == 0) {
      pos = p + 1;
      return 0xFF;
    }
    if (p >= n) ran_out = true;
    at_marker = true;
    marker_pos = pos - 1;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const uint16_t* e = kAri[sv & 0x7F];
    int64_t qe = e[0];
    int nl = e[1] | (e[3] << 7), nm = e[2];
    int64_t temp = a - qe;
    a = temp;
    temp <<= (ct & 63);
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart(int expected) {
    bool found;
    size_t p = seek_restart(d, n, at_marker ? marker_pos : pos, expected, found);
    furthest = std::max(furthest, found ? p : p + 1 < n ? p + 2 : n + 1);
    pos = marker_pos = p;
    at_marker = !found;
    c = a = 0;
    ct = -16;
  }
  size_t end() const { return at_marker ? marker_pos : pos; }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;              // the stored block grid (whole MCUs)
  int wib = 0, hib = 0;            // width / height in blocks
  int ds_w = 0, ds_h = 0;          // downsampled width / height
  std::vector<int16_t> coef;       // bw * bh blocks of 64, natural order
  std::vector<uint8_t> samples;    // lossless: ds_w * ds_h samples
  uint16_t q[64];                  // the quantiser latched at the first scan
  bool latched = false;
  int coef_bits[64];               // progressive: each coefficient's last Al, -1 unsent
  int prev_bits[10];               // coef_bits[0..9] before the component's last scan
  int dc_pred = 0;
};

// why a file is refused: Pillow's open raises (UnidentifiedImageError), or
// libjpeg stops while decoding (Pillow: "broken data stream")
[[noreturn]] void unidentified(const std::string& m) { throw Error(SL_UNIDENTIFIED, m); }
[[noreturn]] void broken(const std::string& m) { throw Error(SL_BROKEN, m); }

enum { CS_GREY, CS_YCC, CS_RGB, CS_CMYK, CS_YCCK };

struct Jpeg {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, precision = 8, ncomp = 0;
  bool progressive = false, arith = false, lossless = false;
  bool seen_sof = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  int dc_max_symbol[4] = {0, 0, 0, 0};
  uint8_t dac_l[16], dac_u[16], dac_k[16];  // arithmetic conditioning (DAC)
  int restart_interval = 0;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int eobrun = 0;
  int scan_number = 0;
  int last_good_imcu = 0;  // libjpeg's last_good_iMCU_row
  // what libjpeg refuses in a header Pillow's open takes: libjpeg stops
  // once Pillow has found the first scan ("broken data stream"); without
  // a scan, Pillow's open does not identify the file
  std::string refusal;
  bool truncated = false;  // no EOI: Pillow refuses the file, OpenCV reads none
  // Pillow hands libjpeg the file 64 KiB at a time (ImageFile.MAXBLOCK): its
  // n-th call sees the bytes before n * 64 KiB, and a call ends only where
  // libjpeg suspends, which the arithmetic decoder cannot. A scan whose
  // arithmetic decoding reads past the bytes of the call that read its
  // header stops libjpeg in Pillow's reading ("broken data stream"), not in
  // OpenCV's, whose file source reads on.
  static constexpr size_t kPillowBlock = 65536;
  size_t pillow_call = 0;
  bool pillow_broken = false;

  Jpeg(const uint8_t* d_, size_t n_) : d(d_), n(n_) {
    for (int t = 0; t < 16; t++) {  // jdmaster.c's defaults
      dac_l[t] = 0;
      dac_u[t] = 1;
      dac_k[t] = 5;
    }
  }

  int u16(size_t p) const {
    if (p + 2 > n) corrupt("JPEG: truncated marker segment");
    return (d[p] << 8) | d[p + 1];
  }

  int colour_space() const {  // jdapimin.c default_decompress_parms
    if (ncomp == 1) return CS_GREY;
    if (ncomp == 4) return adobe && adobe_transform != 0 ? CS_YCCK : CS_CMYK;
    if (jfif) return CS_YCC;
    if (adobe) return adobe_transform == 0 ? CS_RGB : CS_YCC;
    if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B') return CS_RGB;
    return CS_YCC;
  }

  // next marker at or after p (skips fill bytes and garbage); returns its
  // code and sets p past it
  int next_marker(size_t& p) const {
    while (p + 1 < n) {
      if (d[p] == 0xFF) {
        size_t q = p + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] != 0) {
          p = q + 1;
          return d[q];
        }
        p = q;
      } else {
        p++;
      }
    }
    return -1;
  }

  void read_sof(size_t p, int len, int marker) {
    if (seen_sof) corrupt("JPEG: two frame headers");
    if (len < 6) corrupt("JPEG: bad frame header");
    precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    // Pillow's open takes 8-bit frames of 1, 3 or 4 components only
    if (precision != 8) unidentified(std::to_string(precision) + "-bit JPEG");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      unidentified(std::to_string(ncomp) + "-component JPEG");
    switch (marker) {  // libjpeg decodes these processes and no others
      case 0xC0: case 0xC1: break;
      case 0xC2: progressive = true; break;
      case 0xC3: lossless = true; break;
      case 0xC9: arith = true; break;
      case 0xCA: arith = progressive = true; break;
      case 0xCB: refusal = "lossless arithmetic-coded JPEG (SOF11)"; break;
      default: refusal = "hierarchical JPEG (SOF" + std::to_string(marker - 0xC0) + ")";
    }
    if (width <= 0 || height <= 0) corrupt("JPEG: empty image or DNL height");
    if (len < 6 + 3 * ncomp) corrupt("JPEG: bad frame header");
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt("JPEG: bad sampling factors or table index");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    int unit = lossless ? 1 : 8;  // a data unit: a block, or one sample
    mcux = (width + unit * max_h - 1) / (unit * max_h);
    mcuy = (height + unit * max_v - 1) / (unit * max_v);
    for (Component& c : comps) {
      c.ds_w = int((int64_t(width) * c.h + max_h - 1) / max_h);
      c.ds_h = int((int64_t(height) * c.v + max_v - 1) / max_v);
      c.wib = int((int64_t(width) * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hib = int((int64_t(height) * c.v + 8 * max_v - 1) / (8 * max_v));
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    seen_sof = true;
  }

  void read_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3 || pq > 1) corrupt("JPEG: bad quantisation table");
      p++;
      if (p + (pq ? 128 : 64) > end) corrupt("JPEG: truncated quantisation table");
      for (int k = 0; k < 64; k++) {
        qt[tq][kNatural[k]] = uint16_t(pq ? u16(p + 2 * k) : d[p + k]);
      }
      p += pq ? 128 : 64;
      qt_present[tq] = true;
    }
  }

  void read_dht(size_t p, size_t end) {
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) corrupt("JPEG: bad Huffman table index");
      if (p + 17 > end) corrupt("JPEG: truncated Huffman table");
      HuffSpec s;
      for (int l = 1; l <= 16; l++) {
        s.bits[l] = d[p + l];
        s.count += s.bits[l];
      }
      if (s.count > 256 || p + 17 + s.count > end) corrupt("JPEG: bad Huffman table");
      memcpy(s.vals, d + p + 17, s.count);
      if (tc == 0) {
        dc_max_symbol[th] = 0;
        for (int i = 0; i < s.count; i++)
          dc_max_symbol[th] = std::max<int>(dc_max_symbol[th], s.vals[i]);
      }
      (tc ? ac : dc)[th].build(s);
      p += 17 + s.count;
    }
  }

  // jdmarker.c get_dac
  void read_dac(size_t p, size_t end) {
    for (; p + 1 < end; p += 2) {
      int index = d[p], val = d[p + 1];
      if (index >= 32) corrupt("JPEG: bad DAC index");
      if (index >= 16) {
        dac_k[index - 16] = uint8_t(val);
      } else {
        dac_l[index] = uint8_t(val & 15);
        dac_u[index] = uint8_t(val >> 4);
        if (dac_l[index] > dac_u[index]) corrupt("JPEG: bad DAC value");
      }
    }
    if (p != end) corrupt("JPEG: bad DAC length");
  }

  // a marker segment between the frame and a scan (or between two scans)
  void read_tables(int m, size_t body, size_t end) {
    if (m == 0xDB) read_dqt(body, end);
    else if (m == 0xC4) read_dht(body, end);
    else if (m == 0xCC) read_dac(body, end);
    else if (m == 0xDD) restart_interval = u16(body);
  }

  // the header: every marker up to the first scan (or only the frame)
  size_t pos = 2;
  void parse_headers(bool stop_at_sof) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    while (true) {
      // a file whose markers end before its first scan: Pillow's open does
      // not identify it (or, cut inside a segment, raises that its read is
      // truncated); OpenCV reads nothing
      int m = next_marker(pos);
      if (m < 0) unidentified("JPEG: no image data");
      if (m == 0xD9) unidentified("JPEG: no image data before EOI");
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (pos + 2 > n || pos + u16(pos) > n)
        throw Error(SL_TRUNCATED_FAILS, "JPEG: image file is truncated");
      int len = u16(pos);
      size_t body = pos + 2, end = pos + len;
      if (len < 2) corrupt("JPEG: bad marker segment");
      if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(body, len - 2, m);
        if (stop_at_sof) return;
      } else if (m == 0xC8 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD)) {
        refusal = "JPEG extension marker " + std::to_string(m);  // JPG, DHP, EXP, JPGn
      } else if (m == 0xE0 && len >= 7 && !memcmp(d + body, "JFIF\0", 5)) {
        jfif = true;
      } else if (m == 0xEE && len >= 14 && !memcmp(d + body, "Adobe", 5)) {
        adobe = true;
        adobe_transform = d[body + 11];
      } else if (m == 0xDA) {
        pos = body;  // at the scan header's body
        if (!seen_sof) corrupt("JPEG: scan before the frame header");
        if (!refusal.empty()) broken(refusal);
        return;
      } else {
        read_tables(m, body, end);
      }
      pos = end;
    }
  }

  // ---- scans ----
  struct ScanComp {
    Component* c;
    const HuffDec* dc;
    const HuffDec* ac;
    int dc_ctx = 0;  // arithmetic: the DC statistics' conditioning
  };

  int16_t* block(Component& c, int bx, int by) {
    return c.coef.data() + (size_t(by) * c.bw + bx) * 64;
  }

  void decode_scan() {
    size_t p = pos;
    int len = u16(p - 2);
    int ns = d[p];
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("JPEG: bad scan header");
    std::vector<ScanComp> sc;
    for (int i = 0; i < ns; i++) {
      int id = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps)
        if (k.id == id) c = &k;
      if (!c) corrupt("JPEG: scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (!arith && (c->td > 3 || c->ta > 3)) corrupt("JPEG: bad table index");
      sc.push_back({c, &dc[c->td & 3], &ac[c->ta & 3]});
    }
    int units = 0;  // jdinput.c per_scan_setup: at most 10 blocks (samples) an MCU
    for (ScanComp& c : sc) units += c.c->h * c.c->v;
    if (ns > 1 && units > 10) broken("JPEG: more than 10 data units in an MCU");
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
    int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
    scan_number++;
    size_t data = p + 4 + 2 * ns;
    if (lossless) return decode_lossless_scan(sc, ss, se, ah, al, data);
    if (progressive) {
      bool bad = ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
                 (ah != 0 && ah != al + 1);
      if (bad) corrupt("JPEG: bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      corrupt("JPEG: bad sequential scan parameters");
    }
    for (ScanComp& s : sc) {
      Component& c = *s.c;
      if (c.coef.empty()) {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
      if (progressive) {  // jdphuff.c / jdarith.c start_pass
        for (int k = std::min(ss, 1); k <= 9; k++)
          c.prev_bits[k] = scan_number > 1 ? c.coef_bits[k] : 0;
      }
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qt_present[c.tq]) corrupt("JPEG: a quantisation table is missing");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if (!arith && ((need_dc && !s.dc->present) || (need_ac && !s.ac->present)))
        corrupt("JPEG: a Huffman table is missing");
      if (!arith && need_dc && dc_max_symbol[c.td] > 15) corrupt("JPEG: bad DC Huffman table");
      c.dc_pred = 0;
    }
    eobrun = 0;
    if (arith) return decode_arith_scan(sc, ss, se, ah, al, data);
    BitReader br(d, n, data);
    for_each_mcu(sc, [](int64_t) {}, br,
                 [&](ScanComp& s, int16_t* b) {
                   if (!progressive) decode_baseline(br, s, b);
                   else if (ss == 0 && ah == 0) b[0] = int16_t(dc_first(br, s) * (1 << al));
                   else if (ss == 0) { if (br.bits(1)) b[0] |= int16_t(1 << al); }
                   else if (ah == 0) ac_first(br, s, b, ss, se, al);
                   else ac_refine(br, s, b, ss, se, al);
                 });
    truncated |= br.ran_out;
    pos = br.end();
  }

  // the MCUs of a DCT scan (one block each when it is not interleaved), with
  // the restarts, and libjpeg's last_good_iMCU_row: the iMCU row of the last
  // MCU that began before the data ran out
  template <class Reader, class Restart, class Block>
  void for_each_mcu(std::vector<ScanComp>& sc, Restart on_restart, Reader& rd, Block blk) {
    bool single = sc.size() == 1;
    int mw = single ? sc[0].c->wib : mcux, mh = single ? sc[0].c->hib : mcuy;
    int rows_per_imcu = single ? sc[0].c->v : 1;
    int64_t total = int64_t(mw) * mh, todo = restart_interval, rst = 0;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval && todo == 0) {
        rd.restart(int(rst));
        on_restart(rst);
        rst = (rst + 1) & 7;
        todo = restart_interval;
        eobrun = 0;
        for (ScanComp& s : sc) {
          s.c->dc_pred = 0;
          s.dc_ctx = 0;
        }
      }
      todo--;
      int mx = int(m % mw), my = int(m / mw);
      if (!rd.insufficient) {  // else libjpeg leaves the rest of the segment as it is
        for (ScanComp& s : sc) {
          Component& c = *s.c;
          int nbx = single ? 1 : c.h, nby = single ? 1 : c.v;
          for (int by = 0; by < nby; by++)
            for (int bx = 0; bx < nbx; bx++)
              blk(s, single ? block(c, mx, my) : block(c, mx * c.h + bx, my * c.v + by));
        }
        last_good_imcu = my / rows_per_imcu;
      }
    }
  }

  int dc_first(BitReader& br, ScanComp& s) {
    int t = br.decode(*s.dc);
    int diff = t ? extend(br.bits(t), t) : 0;
    s.c->dc_pred += diff;
    return s.c->dc_pred;
  }

  void decode_baseline(BitReader& br, ScanComp& s, int16_t* b) {
    b[0] = int16_t(dc_first(br, s));
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(*s.ac), r = rs >> 4, t = rs & 15;
      if (t) {
        k += r;
        b[kNatural[k]] = int16_t(extend(br.bits(t), t));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void ac_first(BitReader& br, ScanComp& s, int16_t* b, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(*s.ac), r = rs >> 4, t = rs & 15;
      if (t) {
        k += r;
        b[kNatural[k]] = int16_t(extend(br.bits(t), t) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += br.bits(r);
        break;
      }
    }
  }

  void ac_refine(BitReader& br, ScanComp& s, int16_t* b, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    auto correct = [&](int16_t& c) {
      if (br.bits(1) && (c & p1) == 0) c = int16_t(c >= 0 ? c + p1 : c + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(*s.ac), r = rs >> 4, t = rs & 15, val = 0;
        if (t) {
          val = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& c = b[kNatural[k]];
          if (c != 0) {
            correct(c);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (val) b[kNatural[k]] = int16_t(val);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& c = b[kNatural[k]];
        if (c != 0) correct(c);
      }
      eobrun--;
    }
  }

  // ---- arithmetic coding (jdarith.c) ----
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;

  void decode_arith_scan(std::vector<ScanComp>& sc, int ss, int se, int ah, int al, size_t data) {
    bool dc_scan = !progressive || (ss == 0 && ah == 0), ac_scan = !progressive || ss > 0;
    auto reset_stats = [&] {
      for (ScanComp& s : sc) {
        if (dc_scan) memset(dc_stats[s.c->td], 0, 64);
        if (ac_scan) memset(ac_stats[s.c->ta], 0, 256);
      }
    };
    reset_stats();
    ArithReader ar(d, n, data);
    for_each_mcu(sc, [&](int64_t) { reset_stats(); }, ar, [&](ScanComp& s, int16_t* b) {
      if (!progressive) {
        if (ar.ct == -1) return;
        int v;
        if (!arith_dc(ar, s, v)) return;
        b[0] = int16_t(v);
        arith_ac(ar, s, b, 1, 63, 0);
      } else if (ss == 0 && ah == 0) {
        if (ar.ct == -1) return;
        int v;
        if (!arith_dc(ar, s, v)) return;
        b[0] = int16_t(uint16_t(unsigned(v) << al));
      } else if (ss == 0) {
        if (ar.decode(&fixed_bin)) b[0] = int16_t(b[0] | (1 << al));
      } else if (ah == 0) {
        if (ar.ct == -1) return;
        arith_ac(ar, s, b, ss, se, al);
      } else {
        if (ar.ct == -1) return;
        arith_ac_refine(ar, s, b, ss, se, al);
      }
    });
    truncated |= ar.ran_out;
    pos = ar.end();
    pillow_call = std::max(pillow_call, (data + kPillowBlock - 1) / kPillowBlock);
    if (ar.furthest > std::min(n, pillow_call * kPillowBlock)) pillow_broken = true;
  }

  // F.19: one DC difference, added to the prediction (kept to 16 bits as
  // libjpeg keeps it); false on a bad code
  bool arith_dc(ArithReader& ar, ScanComp& s, int& out) {
    int tbl = s.c->td;
    uint8_t* st = dc_stats[tbl] + s.dc_ctx;
    if (ar.decode(st) == 0) {
      s.dc_ctx = 0;
    } else {
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // "bad arithmetic code": decode nothing to the restart
            return false;
          }
          st += 1;
        }
      }
      if (m < int((1L << dac_l[tbl]) >> 1)) s.dc_ctx = 0;
      else if (m > int((1L << dac_u[tbl]) >> 1)) s.dc_ctx = 12 + sign * 4;
      else s.dc_ctx = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      s.c->dc_pred = (s.c->dc_pred + v) & 0xFFFF;
    }
    out = s.c->dc_pred;
    return true;
  }

  // F.20: the AC coefficients ss..se of a block (sequential or first scan)
  void arith_ac(ArithReader& ar, ScanComp& s, int16_t* b, int ss, int se, int al) {
    int tbl = s.c->ta;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
      int sign = ar.decode(&fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      b[kNatural[k]] = int16_t(unsigned(v) << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, ScanComp& s, int16_t* b, int ss, int se, int al) {
    int tbl = s.c->ta;
    int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (b[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t& c = b[kNatural[k]];
        if (c) {
          if (ar.decode(st + 2)) c = int16_t(c < 0 ? c + m1 : c + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          c = int16_t(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  // ---- lossless (jdlhuff.c, jddiffct.c, jdpred.c) ----
  void decode_lossless_scan(std::vector<ScanComp>& sc, int psv, int se, int ah, int pt,
                            size_t data) {
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt >= precision)
      broken("JPEG: bad lossless scan parameters");
    for (ScanComp& s : sc) {
      if (!s.dc->present) corrupt("JPEG: a Huffman table is missing");
      if (s.c->samples.empty()) s.c->samples.assign(size_t(s.c->ds_w) * s.c->ds_h, 0);
    }
    bool single = sc.size() == 1;
    int per_row = single ? sc[0].c->ds_w : mcux;  // MCUs in an MCU row
    int total = mcuy;                             // iMCU rows: max_v sample rows each
    if (restart_interval % per_row) broken("JPEG: lossless restart interval not whole rows");
    int ns = int(sc.size());
    // per component of the scan: v rows of differences, v rows of samples
    std::vector<std::vector<int>> diff(ns), undiff(ns);
    std::vector<int> dw(ns);
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i].c;
      dw[i] = single ? c.ds_w : per_row * c.h;
      diff[i].assign(size_t(c.v) * dw[i], 0);
      undiff[i].assign(size_t(c.v) * c.ds_w, 0);
    }
    std::vector<bool> first_row(ncomp, true);  // jdpred.c: predict from 2^(P-Pt-1)
    auto reset_predictors = [&] { std::fill(first_row.begin(), first_row.end(), true); };
    BitReader br(d, n, data);
    int rows_to_go = restart_interval / per_row, rst = 0;
    int init = 1 << (precision - pt - 1);
    for (int r = 0; r < total; r++) {
      int mcu_rows = single ? (r < total - 1 ? sc[0].c->v : last_row_height(*sc[0].c)) : 1;
      for (int y = 0; y < mcu_rows; y++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            br.restart(rst);
            rst = (rst + 1) & 7;
            reset_predictors();
            rows_to_go = restart_interval / per_row;
          }
        }
        if (br.insufficient) {  // the rest of the segment: zero differences
          for (int i = 0; i < ns; i++) {
            auto row = diff[i].begin() + size_t(y) * dw[i];
            std::fill(row, row + size_t(single ? 1 : sc[i].c->v) * dw[i], 0);
          }
          reset_predictors();
        } else {
          for (int x = 0; x < per_row; x++)
            for (int i = 0; i < ns; i++) {
              Component& c = *sc[i].c;
              int nx = single ? 1 : c.h, ny = single ? 1 : c.v;
              for (int yy = 0; yy < ny; yy++)
                for (int xx = 0; xx < nx; xx++) {
                  int s = br.decode(*sc[i].dc);
                  if (s) s = s == 16 ? 32768 : extend(br.bits(s), s);
                  diff[i][size_t(y + yy) * dw[i] + x * nx + xx] = s;
                }
            }
        }
        if (restart_interval) rows_to_go--;
      }
      // undifference and scale each row of the iMCU row
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i].c;
        int ci = int(&c - comps.data());
        int rows = r == total - 1 ? last_row_height(c) : c.v;
        for (int row = 0, prev = c.v - 1; row < rows; prev = row, row++) {
          const int* df = diff[i].data() + size_t(row) * dw[i];
          const int* up = undiff[i].data() + size_t(prev) * c.ds_w;
          int* out = undiff[i].data() + size_t(row) * c.ds_w;
          undifference(first_row[ci] ? 0 : psv, df, up, out, c.ds_w, init);
          first_row[ci] = false;
          uint8_t* o = c.samples.data() + size_t(r * c.v + row) * c.ds_w;
          for (int x = 0; x < c.ds_w; x++) o[x] = uint8_t(out[x] << pt);
        }
      }
    }
    truncated |= br.ran_out;
    pos = br.end();
  }

  static int last_row_height(const Component& c) {
    int t = c.ds_h % c.v;
    return t ? t : c.v;
  }

  // jdpred.c: one row; psv 0 is the first row's rule (Ra, from 2^(P-Pt-1))
  static void undifference(int psv, const int* df, const int* up, int* out, int w, int init) {
    if (psv == 0 || psv == 1) {
      int ra = (df[0] + (psv == 0 ? init : up[0])) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) out[x] = ra = (df[x] + ra) & 0xFFFF;
      return;
    }
    int rb = up[0];
    int ra = (df[0] + rb) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < w; x++) {
      int rc = rb;
      rb = up[x];
      int p;
      switch (psv) {
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      out[x] = ra = (df[x] + p) & 0xFFFF;
    }
  }

  void decode_all() {
    parse_headers(false);
    // libjpeg-turbo converts no colour in lossless mode: it stops before the
    // first scan where YCbCr -> RGB or YCCK -> CMYK would be needed
    int cs = colour_space();
    if (lossless && (cs == CS_YCC || cs == CS_YCCK)) broken("lossless JPEG in YCbCr or YCCK");
    while (true) {
      decode_scan();
      int m;
      while (true) {
        m = next_marker(pos);
        if (m < 0) truncated = true;
        if (m < 0 || m == 0xD9) return;
        if (m >= 0xD0 && m <= 0xD7) continue;
        if (pos + 2 > n || pos + u16(pos) > n) return read_cut_segment(m);
        int len = u16(pos);
        size_t body = pos + 2, end = pos + len;
        if (len < 2) corrupt("JPEG: bad marker segment");
        if (m == 0xDA) {
          pos = body;
          break;
        }
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
          corrupt("JPEG: two frame headers");
        read_tables(m, body, end);
        pos = end;
      }
    }
  }

  // the data ends inside the marker segment at pos (between two scans):
  // Pillow's reading is truncated; libjpeg reads on through the fake EOI
  // markers (FF D9 FF D9 ...) its file source supplies past the end, which
  // a table or scan header may take for its contents
  bool cut_segment_fails = false;
  void read_cut_segment(int m) {
    truncated = true;
    std::vector<uint8_t> pad(d + pos, d + n);
    while (pad.size() < 65540) {
      pad.push_back(0xFF);
      pad.push_back(0xD9);
    }
    const uint8_t* data = d;
    size_t size = n;
    d = pad.data();
    n = pad.size();
    try {
      int len = u16(0);
      if (m == 0xDA || len < 2) corrupt("JPEG: cut scan header");
      read_tables(m, 2, size_t(len));
    } catch (const Error&) {
      cut_segment_fails = true;
    }
    d = data;
    n = size;
  }

  // ---- samples ----
  // jdcoefct.c smoothing_ok: whether libjpeg smooths this progressive
  // image's blocks, with the coefficient bits it latches (latch[ci][0..9]
  // now, latch[ci][10..19] before each component's last scan)
  bool smoothing_ok(std::vector<int>& latch) {
    if (!progressive) return false;
    bool useful = false;
    latch.assign(size_t(ncomp) * 20, 0);
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comps[ci];
      if (!c.latched) return false;
      for (int k = 0; k < 10; k++)
        if (c.q[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      int* l = latch.data() + 20 * ci;
      l[0] = c.coef_bits[0];
      for (int k = 1; k < 10; k++) {
        l[10 + k] = scan_number > 1 ? c.prev_bits[k] : -1;
        l[k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): a block's low
  // coefficients that are still zero and not known to be exact are
  // estimated from the DC values of its 5x5 neighbourhood of blocks; with
  // no AC coefficient known at all, the DC itself is interpolated
  void smooth_block(const Component& c, const int* cb, int bx, int by, int16_t* ws) {
    int total = mcuy, last = total - 1;
    int imcu = by / c.v, block_row = by % c.v;
    int block_rows = imcu < last ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
    int ibr = imcu * block_rows + block_row, ibrs = block_rows * total;
    int prev = ibr > 0 ? by - 1 : by, next = ibr < ibrs - 1 ? by + 1 : by;
    int rows[5] = {ibr > 1 ? by - 2 : prev, prev, by, next, ibr < ibrs - 2 ? by + 2 : next};
    int64_t DC[26];
    for (int r = 0; r < 5; r++)
      for (int k = 0; k < 5; k++) {
        int x = std::min(std::max(bx + k - 2, 0), c.wib - 1);
        DC[1 + 5 * r + k] = c.coef[(size_t(rows[r]) * c.bw + x) * 64];
      }
    bool change_dc = true;
    for (int k = 1; k <= 9; k++) change_dc &= cb[k] == -1;
    const uint16_t* q = c.q;
    int64_t Q00 = q[0];
    auto est = [&](int k, int pos, int64_t qv, int64_t sum) {
      int al = cb[k];
      if (al == 0 || ws[pos] != 0) return;
      int64_t num = Q00 * sum;
      int pred;
      if (num >= 0) {
        pred = int(((qv << 7) + num) / (qv << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((qv << 7) - num) / (qv << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = int16_t(pred);
    };
    const int64_t* D = DC;
    if (change_dc) {
      est(1, 1, q[1], -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
                          3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] +
                          13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]);
      est(2, 8, q[8], -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] +
                          38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] -
                          13 * D[19] + D[20] + D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]);
      est(3, 16, q[16], D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] -
                            5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]);
      est(4, 9, q[9], -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]);
      est(5, 2, q[2], 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] +
                          7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]);
      est(6, 3, q[3], D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
      est(7, 10, q[10], D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
      est(8, 17, q[17], D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
      est(9, 24, q[24], D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
      int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
                           6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] +
                           42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] +
                           6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] -
                           6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
      int pred = num >= 0 ? int(((Q00 << 7) + num) / (Q00 << 8))
                          : -int(((Q00 << 7) - num) / (Q00 << 8));
      ws[0] = int16_t(pred);
    } else {
      est(1, 1, q[1], -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
      est(2, 8, q[8], -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
      est(3, 16, q[16], -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
      est(4, 9, q[9], D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] +
                          D[4] - D[6] + 10 * D[7] - 10 * D[9]);
      est(5, 2, q[2], -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
    }
  }

  // one component's samples (stride in *stride): the IDCT of every stored
  // block (smoothed first where libjpeg smooths), or the lossless samples
  std::vector<uint8_t> plane(Component& c, const std::vector<int>& latch, int* stride) {
    if (lossless) {
      *stride = c.ds_w;
      if (c.samples.empty()) c.samples.assign(size_t(c.ds_w) * c.ds_h, 0);
      return c.samples;
    }
    *stride = c.bw * 8;
    int st = *stride;
    // a component no scan covered is all zero coefficients: mid grey
    std::vector<uint8_t> out(size_t(st) * c.bh * 8, 128);
    if (c.coef.empty()) return out;
    if (latch.empty()) {
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(block(c, bx, by), c.q, out.data() + size_t(by) * 8 * st + bx * 8, st);
      return out;
    }
    int ci = int(&c - comps.data());
    int16_t ws[64];
    for (int by = 0; by < c.hib; by++) {
      const int* cb = latch.data() + 20 * ci + (by / c.v > last_good_imcu ? 10 : 0);
      for (int bx = 0; bx < c.wib; bx++) {
        memcpy(ws, block(c, bx, by), sizeof(ws));
        smooth_block(c, cb, bx, by, ws);
        idct_islow(ws, c.q, out.data() + size_t(by) * 8 * st + bx * 8, st);
      }
    }
    return out;
  }

  // jdsample.c: output row y of a component upsampled to the image's size
  // (a row of src, or written into buf); rows and columns past the
  // component's downsampled size repeat its last one. A lossless image
  // (one-sample data units) takes no fancy upsampling.
  const uint8_t* up_row(const Component& c, const uint8_t* src, int stride, int y, uint8_t* buf,
                        int* colsum) const {
    int W = width, dw = c.ds_w;
    int hx = max_h / c.h, vy = max_v / c.v;
    bool fancy = !lossless;
    auto row = [&](int j) {
      return src + size_t(std::min(std::max(j, 0), c.ds_h - 1)) * stride;
    };
    if (hx == 1 && vy == 1) return row(y);
    if (fancy && hx == 2 && vy == 1 && dw > 2) {
      const uint8_t* in = row(y);
      for (int i = 0; i < dw; i++) {
        int v3 = in[i] * 3, l = in[std::max(i - 1, 0)], r = in[std::min(i + 1, dw - 1)];
        buf[2 * i] = uint8_t((v3 + l + 1) >> 2);
        buf[2 * i + 1] = uint8_t((v3 + r + 2) >> 2);
      }
      return buf;
    }
    int j = y >> 1, o = (y & 1) ? j + 1 : j - 1;
    if (fancy && hx == 1 && vy == 2) {
      const uint8_t *in0 = row(j), *in1 = row(o);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++) buf[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      return buf;
    }
    if (fancy && hx == 2 && vy == 2 && dw > 2) {
      const uint8_t *in0 = row(j), *in1 = row(o);
      for (int i = 0; i < dw; i++) colsum[i + 1] = in0[i] * 3 + in1[i];
      colsum[0] = colsum[1];
      colsum[dw + 1] = colsum[dw];
      for (int i = 1; i <= dw; i++) {
        int t3 = colsum[i] * 3;
        buf[2 * i - 2] = uint8_t((t3 + colsum[i - 1] + 8) >> 4);
        buf[2 * i - 1] = uint8_t((t3 + colsum[i + 1] + 7) >> 4);
      }
      return buf;
    }
    // replication (int_upsample, h2v1 / h2v2 / h1v2 without fancy upsampling)
    const uint8_t* in = row(y / vy);
    for (int x = 0; x < W; x++) buf[x] = in[x / hx];
    return buf;
  }

  // (height, width, ncomp) samples: grey, RGB, or CMYK as libjpeg outputs
  // a 4-component file (YCCK converted, CMYK as stored)
  void output(uint8_t* out) {
    for (Component& c : comps)
      if (max_h % c.h || max_v % c.v) broken("JPEG with fractional sampling ratios");
    std::vector<int> latch;
    if (!smoothing_ok(latch)) latch.clear();
    std::vector<std::vector<uint8_t>> planes, bufs;
    std::vector<std::vector<int>> colsums;
    std::vector<int> strides(ncomp);
    for (int k = 0; k < ncomp; k++) {
      Component& c = comps[k];
      planes.push_back(plane(c, latch, &strides[k]));
      bufs.emplace_back(size_t(2 * c.ds_w + width + 2));
      colsums.emplace_back(size_t(c.ds_w + 2));
    }
    int W = width;
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int x = i - 128;
      cr_r[i] = (91881 * x + 32768) >> 16;
      cb_b[i] = (116130 * x + 32768) >> 16;
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
    auto lim = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    int cs = colour_space();
    const uint8_t* r[4];
    for (int y = 0; y < height; y++) {
      for (int k = 0; k < ncomp; k++)
        r[k] = up_row(comps[k], planes[k].data(), strides[k], y, bufs[k].data(),
                      colsums[k].data());
      uint8_t* o = out + size_t(y) * W * ncomp;
      if (ncomp == 1) {
        memcpy(o, r[0], W);
      } else if (cs == CS_RGB || cs == CS_CMYK) {
        for (int x = 0; x < W; x++)
          for (int k = 0; k < ncomp; k++) o[ncomp * x + k] = r[k][x];
      } else {  // YCbCr -> RGB, or YCCK -> CMYK (jdcolor.c ycck_cmyk_convert)
        bool ycck = cs == CS_YCCK;
        for (int x = 0; x < W; x++) {
          int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          int R = yy + cr_r[cr], G = yy + ((cb_g[cb] + cr_g[cr]) >> 16), B = yy + cb_b[cb];
          uint8_t* px = o + ncomp * x;
          if (ycck) {
            px[0] = lim(255 - R);
            px[1] = lim(255 - G);
            px[2] = lim(255 - B);
            px[3] = r[3][x];
          } else {
            px[0] = lim(R);
            px[1] = lim(G);
            px[2] = lim(B);
          }
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// JPEG encoder
// ---------------------------------------------------------------------------

// jcparam.c
const uint16_t kStdLum[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                              58, 60, 55, 14, 13,  16,  24,  40,  57, 69, 56, 14, 17,
                              22, 29, 51, 87, 80,  62,  18,  22,  37, 56, 68, 109, 103,
                              77, 24, 35, 55, 64,  81,  104, 113, 92, 49, 64, 78,  87,
                              103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint16_t kStdChr[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct BitWriter {
  uint8_t* out;
  size_t cap, len = 0;
  uint64_t acc = 0;
  int nbits = 0;
  void byte(int b) {
    if (len >= cap) throw Error(SL_NO_ROOM, "JPEG: output buffer too small");
    out[len++] = uint8_t(b);
  }
  void raw(const uint8_t* p, size_t k) {
    for (size_t i = 0; i < k; i++) byte(p[i]);
  }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 255);
  }
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      int b = int((acc >> (nbits - 8)) & 255);
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {  // jchuff.c flush_bits: pad with ones
    put(0x7F, 7);
    acc = 0;
    nbits = 0;
  }
};

struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
  void build(const HuffSpec& s) {
    std::vector<int> c, z;
    canonical_codes(s, c, z);
    memset(size, 0, sizeof(size));
    for (int i = 0; i < s.count; i++) {
      code[s.vals[i]] = uint32_t(c[i]);
      size[s.vals[i]] = uint8_t(z[i]);
    }
  }
};

void write_dht(BitWriter& w, const HuffSpec& s, int index) {
  w.byte(0xFF);
  w.byte(0xC4);
  w.u16(2 + 1 + 16 + s.count);
  w.byte(index);
  w.raw(s.bits + 1, 16);
  w.raw(s.vals, s.count);
}

void encode_jpeg(const uint8_t* pix, int W, int H, int nc, int quality, int h0, int v0,
                 BitWriter& w) {
  if (nc != 1 && nc != 3) corrupt("JPEG encode takes 1 or 3 components");
  if (W <= 0 || H <= 0 || W > 65535 || H > 65535) corrupt("JPEG encode: bad image size");
  // a grey image keeps the sampling it is given in its frame header (as
  // libjpeg writes it); its one component is full size all the same
  // quantisers (jpeg_set_quality, force_baseline)
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long((t ? kStdChr : kStdLum)[i]) * scale + 50) / 100;
      qt[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
  int hs[3] = {h0, 1, 1}, vs[3] = {v0, 1, 1};
  int max_h = h0, max_v = v0;
  int mcux = (W + 8 * max_h - 1) / (8 * max_h), mcuy = (H + 8 * max_v - 1) / (8 * max_v);

  // colour conversion (jccolor.c rgb_ycc_convert), full-size planes
  std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>(size_t(W) * H));
  if (nc == 1) {
    memcpy(full[0].data(), pix, size_t(W) * H);
  } else {
    const int64_t half = 1 << 15, off = int64_t(128) << 16;
    for (size_t i = 0; i < size_t(W) * H; i++) {
      int64_t r = pix[3 * i], g = pix[3 * i + 1], b = pix[3 * i + 2];
      full[0][i] = uint8_t((19595 * r + 38470 * g + 7471 * b + half) >> 16);
      full[1][i] = uint8_t((-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16);
      full[2][i] = uint8_t((32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16);
    }
  }

  // downsample (jcsample.c; edges replicated as jcprepct.c pads them) and
  // transform + quantise every block (jcdctmgr.c)
  struct Comp { int h, v, wib, hib, bw, bh; std::vector<int16_t> coef; };
  std::vector<Comp> cs(nc);
  int rows_full = (H + max_v - 1) / max_v * max_v;  // whole row groups
  for (int ci = 0; ci < nc; ci++) {
    Comp& c = cs[ci];
    c.h = hs[ci];
    c.v = vs[ci];
    c.wib = int((int64_t(W) * c.h + 8 * max_h - 1) / (8 * max_h));
    c.hib = int((int64_t(H) * c.v + 8 * max_v - 1) / (8 * max_v));
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    int hx = max_h / c.h, vy = max_v / c.v;
    int cols = c.wib * 8, rows_ds = rows_full / vy, rows = c.bh * 8;
    auto src = [&](int x, int y) -> int {
      return full[ci][size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)];
    };
    std::vector<uint8_t> ds(size_t(cols) * rows);
    for (int y = 0; y < rows; y++) {
      int yy = std::min(y, rows_ds - 1);
      int bias = (hx == 2 && vy == 2) ? 1 : 0;
      for (int x = 0; x < cols; x++) {
        int v;
        if (hx == 1 && vy == 1) {
          v = src(x, yy);
        } else if (hx == 2 && vy == 1) {
          v = (src(2 * x, yy) + src(2 * x + 1, yy) + bias) >> 1;
          bias ^= 1;
        } else if (hx == 2 && vy == 2) {
          v = (src(2 * x, 2 * yy) + src(2 * x + 1, 2 * yy) + src(2 * x, 2 * yy + 1) +
               src(2 * x + 1, 2 * yy + 1) + bias) >> 2;
          bias ^= 3;
        } else {
          int sum = 0;
          for (int j = 0; j < vy; j++)
            for (int i = 0; i < hx; i++) sum += src(hx * x + i, vy * yy + j);
          v = (sum + hx * vy / 2) / (hx * vy);
        }
        ds[size_t(y) * cols + x] = uint8_t(v);
      }
    }
    const uint16_t* q = qt[ci ? 1 : 0];
    c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++) {
        int16_t* out = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
        if (bx >= c.wib || by >= c.hib) continue;  // dummy: filled below
        int blk[64];
        for (int r = 0; r < 8; r++)
          for (int k = 0; k < 8; k++)
            blk[8 * r + k] = int(ds[size_t(by * 8 + r) * cols + bx * 8 + k]) - 128;
        fdct_islow(blk);
        for (int i = 0; i < 64; i++) {
          int div = q[i] << 3, t = blk[i];
          int a = ((t < 0 ? -t : t) + (div >> 1)) / div;
          out[i] = int16_t(t < 0 ? -a : a);
        }
      }
    // jccoefct.c dummy blocks: zero AC, the DC of the block before them
    // in the MCU (right edge), or of the MCU's last block of the row above
    // (bottom edge)
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (int y = 0; y < c.v; y++) {
          int by = my * c.v + y;
          for (int x = 0; x < c.h; x++) {
            int bx = mx * c.h + x;
            if (bx < c.wib && by < c.hib) continue;
            int16_t* out = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
            const int16_t* from;
            if (by < c.hib) from = out - 64;
            else from = c.coef.data() + (size_t(by - 1) * c.bw + mx * c.h + c.h - 1) * 64;
            out[0] = from[0];
          }
        }
  }

  // headers (jcmarker.c)
  HuffSpec dcs[2] = {make_spec(kBitsDcLum, kValsDc), make_spec(kBitsDcChr, kValsDc)};
  HuffSpec acs[2] = {make_spec(kBitsAcLum, kValsAcLum), make_spec(kBitsAcChr, kValsAcChr)};
  HuffEnc dce[2], ace[2];
  for (int t = 0; t < 2; t++) {
    dce[t].build(dcs[t]);
    ace[t].build(acs[t]);
  }
  static const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                                     1,    1,    0,    0,    1, 0,  1,   0,   0};
  w.raw(soi_app0, sizeof(soi_app0));
  int ntab = nc == 1 ? 1 : 2;
  for (int t = 0; t < ntab; t++) {
    w.byte(0xFF);
    w.byte(0xDB);
    w.u16(67);
    w.byte(t);
    for (int k = 0; k < 64; k++) w.byte(qt[t][kNatural[k]]);
  }
  w.byte(0xFF);
  w.byte(0xC0);
  w.u16(8 + 3 * nc);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(nc);
  for (int ci = 0; ci < nc; ci++) {
    w.byte(ci + 1);
    w.byte((hs[ci] << 4) | vs[ci]);
    w.byte(ci ? 1 : 0);
  }
  for (int t = 0; t < ntab; t++) {
    write_dht(w, dcs[t], t);
    write_dht(w, acs[t], 0x10 | t);
  }
  w.byte(0xFF);
  w.byte(0xDA);
  w.u16(6 + 2 * nc);
  w.byte(nc);
  for (int ci = 0; ci < nc; ci++) {
    w.byte(ci + 1);
    w.byte(ci ? 0x11 : 0x00);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  // entropy coding (jchuff.c encode_one_block)
  int last_dc[3] = {0, 0, 0};
  auto encode_block = [&](const int16_t* b, int ci) {
    const HuffEnc& de = dce[ci ? 1 : 0];
    const HuffEnc& ae = ace[ci ? 1 : 0];
    int t = b[0] - last_dc[ci], t2 = t;
    last_dc[ci] = b[0];
    if (t < 0) {
      t = -t;
      t2--;
    }
    int nb = 0;
    while (t) {
      nb++;
      t >>= 1;
    }
    w.put(de.code[nb], de.size[nb]);
    if (nb) w.put(uint32_t(t2), nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      t = b[kNatural[k]];
      if (t == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        w.put(ae.code[0xF0], ae.size[0xF0]);
        r -= 16;
      }
      t2 = t;
      if (t < 0) {
        t = -t;
        t2--;
      }
      nb = 1;
      while ((t >>= 1)) nb++;
      int i = (r << 4) + nb;
      w.put(ae.code[i], ae.size[i]);
      w.put(uint32_t(t2), nb);
      r = 0;
    }
    if (r > 0) w.put(ae.code[0], ae.size[0]);
  };
  if (nc == 1) {
    const Comp& c = cs[0];
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++) encode_block(c.coef.data() + (size_t(by) * c.bw + bx) * 64, 0);
  } else {
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (int ci = 0; ci < nc; ci++) {
          const Comp& c = cs[ci];
          for (int y = 0; y < c.v; y++)
            for (int x = 0; x < c.h; x++)
              encode_block(c.coef.data() + (size_t(my * c.v + y) * c.bw + mx * c.h + x) * 64, ci);
        }
  }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
}

// ---------------------------------------------------------------------------
// LZW
// ---------------------------------------------------------------------------

struct LzwTable {
  uint16_t prefix[4096];
  uint8_t suffix[4096], first[4096];
  uint16_t length[4096];
  uint8_t stack[4097];
};

}  // namespace

extern "C" {

int sl_jpeg_info(const uint8_t* data, size_t n, int* info, char* err, int errlen) {
  try {
    Jpeg j(data, n);
    j.parse_headers(true);
    if (!j.seen_sof) corrupt("JPEG: no frame header");
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    info[3] = j.colour_space();
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    Jpeg j(data, n);
    j.decode_all();
    if (j.cut_segment_fails) {
      if (err && errlen > 0) snprintf(err, errlen, "JPEG: image file is truncated");
      return SL_TRUNCATED_FAILS;
    }
    j.output(out);
    if (j.pillow_broken) {
      if (err && errlen > 0) snprintf(err, errlen, "JPEG: arithmetic data past Pillow's block");
      return SL_PILLOW_BROKEN;
    }
    if (j.truncated) {
      if (err && errlen > 0) snprintf(err, errlen, "JPEG: image file is truncated");
      return SL_TRUNCATED;
    }
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::exception& e) {
    return fail(Error(SL_CORRUPT, std::string("JPEG: ") + e.what()), err, errlen);
  }
}

void sl_cmyk_convert(const uint8_t* cmyk, size_t npix, int opencv, uint8_t* out) {
  for (size_t i = 0; i < npix; i++, cmyk += 4) {
    int k = cmyk[3];
    if (opencv) {  // icvCvt_CMYK2BGR_8u_C4C3R: k - (255 - c) * k / 256, BGR
      for (int c = 0; c < 3; c++) out[3 * i + 2 - c] = uint8_t(k - (((255 - cmyk[c]) * k) >> 8));
    } else {  // "CMYK;I" (255 - v) then Convert.c cmyk2rgb with nk = 255 - (255 - k)
      for (int c = 0; c < 3; c++) {
        int t = (255 - cmyk[c]) * k + 128;
        out[4 * i + c] = uint8_t(k - (((t >> 8) + t) >> 8));
      }
      out[4 * i + 3] = 255;
    }
  }
}

int sl_jpeg_encode(const uint8_t* pix, int width, int height, int components, int quality,
                   int h0, int v0, uint8_t* out, size_t cap, size_t* out_len, char* err,
                   int errlen) {
  try {
    if (!((h0 == 1 && v0 == 1) || (h0 == 2 && v0 == 1) || (h0 == 2 && v0 == 2)))
      unsupported("JPEG encode: sampling must be 1x1, 2x1 or 2x2");
    BitWriter w{out, cap};
    encode_jpeg(pix, width, height, components, quality, h0, v0, w);
    *out_len = w.len;
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_gif_lzw(const uint8_t* data, size_t n, int min_code_size, uint8_t* out, size_t npix,
               size_t* written, char* err, int errlen) {
  try {
    if (min_code_size < 1 || min_code_size > 11) corrupt("GIF: bad LZW code size");
    std::vector<LzwTable> tab(1);
    LzwTable& t = tab[0];
    int clear = 1 << min_code_size, eoi = clear + 1;
    for (int i = 0; i < clear; i++) {
      t.suffix[i] = t.first[i] = uint8_t(i);
      t.length[i] = 1;
    }
    int size = min_code_size + 1, next = clear + 2, prev = -1;
    size_t o = 0, bitpos = 0, nbits = n * 8;
    while (o < npix && bitpos + size <= nbits) {
      int code = 0;
      for (int i = 0; i < size; i++, bitpos++)
        code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << i;
      if (code == clear) {
        size = min_code_size + 1;
        next = clear + 2;
        prev = -1;
        continue;
      }
      if (code == eoi) break;
      int cur = code;
      if (prev < 0) {
        if (code >= clear) corrupt("GIF: bad first LZW code");
        out[o++] = uint8_t(code);
        prev = code;
        continue;
      }
      uint8_t firstc;
      if (code < next && code != clear && code != eoi) {
        firstc = t.first[code];
      } else if (code == next) {
        firstc = t.first[prev];
      } else {
        corrupt("GIF: bad LZW code");
      }
      if (next < 4096) {
        t.prefix[next] = uint16_t(prev);
        t.suffix[next] = firstc;
        t.first[next] = t.first[prev];
        t.length[next] = uint16_t(t.length[prev] + 1);
        next++;
        if (next == (1 << size) && size < 12) size++;
      }
      // emit the string of cur, back to front
      int len = t.length[cur], c = cur, k = len;
      while (k > 0) {
        t.stack[--k] = t.suffix[c];
        c = t.prefix[c];
      }
      for (int i = 0; i < len && o < npix; i++) out[o++] = t.stack[i];
      prev = cur;
    }
    *written = o;
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_tiff_lzw(const uint8_t* data, size_t n, uint8_t* out, size_t cap, size_t* written,
                char* err, int errlen) {
  try {
    std::vector<LzwTable> tab(1);
    LzwTable& t = tab[0];
    for (int i = 0; i < 256; i++) {
      t.suffix[i] = t.first[i] = uint8_t(i);
      t.length[i] = 1;
    }
    if (n >= 2 && data[0] == 0 && (data[1] & 1))
      unsupported("TIFF: old-style (LSB-first) LZW is not supported");
    int size = 9, next = 258, prev = -1;
    size_t o = 0, bitpos = 0, nbits = n * 8;
    while (o < cap && bitpos + size <= nbits) {
      int code = 0;
      for (int i = 0; i < size; i++, bitpos++)
        code = (code << 1) | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
      if (code == 257) break;
      if (code == 256) {
        size = 9;
        next = 258;
        prev = -1;
        continue;
      }
      if (prev < 0) {
        if (code > 255) corrupt("TIFF: bad first LZW code");
        out[o++] = uint8_t(code);
        prev = code;
        continue;
      }
      uint8_t firstc;
      if (code < next) firstc = t.first[code];
      else if (code == next) firstc = t.first[prev];
      else corrupt("TIFF: bad LZW code");
      if (next < 4096) {
        t.prefix[next] = uint16_t(prev);
        t.suffix[next] = firstc;
        t.first[next] = t.first[prev];
        t.length[next] = uint16_t(t.length[prev] + 1);
        next++;
        if (next == (1 << size) - 1 && size < 12) size++;
      }
      int len = t.length[code], c = code, k = len;
      while (k > 0) {
        t.stack[--k] = t.suffix[c];
        c = t.prefix[c];
      }
      for (int i = 0; i < len && o < cap; i++) out[o++] = t.stack[i];
      prev = code;
    }
    *written = o;
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_bmp_rle(const uint8_t* data, size_t n, size_t pos, uint32_t width, uint32_t height,
               int rle4, uint8_t* out, char* err, int errlen) {
  try {
    // ``len`` counts what Pillow's decoder appends; only the first ``dest``
    // bytes are kept (``out`` holds them, zeroed here), so a long delta or
    // end-of-line pad costs no memory.
    const size_t dest = size_t(width) * height;
    memset(out, 0, dest);
    size_t len = 0, x = 0;
    auto put = [&](uint8_t v) {
      if (len < dest) out[len] = v;
      len++;
    };
    while (len < dest) {
      if (pos + 2 > n) break;
      size_t count = data[pos];
      uint8_t byte = data[pos + 1];
      pos += 2;
      if (count) {
        if (x + count > width) count = std::min(count, width > x ? width - x : size_t(0));
        for (size_t i = 0; i < count; i++) put(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte);
        x += count;
      } else if (byte == 0) {  // end of line
        len += (width - len % width) % width;
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta: Pillow reads two bytes, then the next two
        if (pos + 2 > n) break;
        size_t right = 0, up = 0;
        if (pos + 4 <= n) {
          right = data[pos + 2];
          up = data[pos + 3];
        }
        pos += 4;
        len += right + up * width;
        x = len % width;
      } else {  // absolute run
        size_t want = rle4 ? byte / 2 : byte, got = std::min(want, n > pos ? n - pos : size_t(0));
        for (size_t i = 0; i < got; i++) {
          uint8_t b = data[pos + i];
          if (rle4) {
            put(b >> 4);
            put(b & 15);
          } else {
            put(b);
          }
        }
        pos += got;
        if (got < want) break;
        x += byte;
        if (pos % 2) pos++;
      }
    }
    if (len < dest) corrupt("BMP: not enough image data in the RLE stream");
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_tga_rle(const uint8_t* data, size_t n, size_t pos, size_t npix, int bpp, size_t width,
               uint8_t* out, char* err, int errlen) {
  try {
    const size_t want = npix * bpp, row = width * bpp;
    size_t len = 0;
    auto put = [&](const uint8_t* src, size_t k) {  // what fits of k bytes
      size_t m = std::min(k, want - std::min(want, len));
      if (m) memcpy(out + len, src, m);
      len += k;
    };
    while (len < want && pos < n) {
      uint8_t head = data[pos++];
      size_t count = (head & 0x7F) + 1;
      size_t avail = std::min(size_t(bpp), n - pos);
      if (head & 0x80) {
        if (len % row + count * bpp > row)
          corrupt("TGA: a run-length packet crosses the end of a row");
        for (size_t i = 0; i < count; i++) put(data + pos, avail);
        pos += bpp;
      } else {
        put(data + pos, std::min(count * bpp, n - pos));
        pos += count * bpp;
      }
    }
    if (len < want) corrupt("TGA: not enough image data in the RLE stream");
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

int sl_packbits(const uint8_t* data, size_t n, uint8_t* out, size_t cap, size_t* written,
                char* err, int errlen) {
  try {
    size_t pos = 0, len = 0;
    while (pos < n && len < cap) {
      uint8_t c = data[pos++];
      if (c < 128) {
        size_t k = std::min(std::min(size_t(c) + 1, n - pos), cap - len);
        memcpy(out + len, data + pos, k);
        len += k;
        pos += size_t(c) + 1;
      } else if (c > 128) {
        if (pos < n) {
          size_t k = std::min(size_t(257 - c), cap - len);
          memset(out + len, data[pos], k);
          len += k;
        }
        pos++;
      }
    }
    *written = len;
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

}  // extern "C"
