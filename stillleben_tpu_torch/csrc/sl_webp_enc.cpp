// The port's WebP encoder; see sl_webp_enc.h.
//
// The VP8 chunk follows libwebp 1.6's lossy encoder at method 4, stage by
// stage: picture_csp_enc.c (RGB(A) -> YUV 4:2:0 with the gamma-linear
// chroma average, alpha-weighted where a 2x2 block is not opaque) and
// picture_tools_enc.c (WebPCleanupTransparentArea); analysis_enc.c (the
// DCT-histogram susceptibility and the k-means segments); quant_enc.c
// (segment quantisers, matrices and lambdas, the rate-distortion choice of
// the intra-16, intra-4 and chroma modes, the chroma DC error diffusion);
// filter_enc.c (the loop-filter strength); iterator_enc.c; cost_enc.c and
// dsp/cost.c (rates); frame_enc.c (the token loop and the probability
// refresh); token_enc.c, tree_enc.c, syntax_enc.c and bit_writer_utils.c
// (the bitstream and the container); dsp/enc.c (transforms, predictions,
// distortions) in its C versions, which its SIMD versions equal.
// The alpha plane follows alpha_enc.c and utils/filters_utils.c (the
// filter estimate, the trials, the raw fallback); its VP8L stream is
// libwebp's lossless encoder (sl_vp8l_enc.cpp).
// Build: g++ -O3 -shared -fPIC -std=c++17 (no -ffast-math: the quantiser
// search computes pow() in double, as libwebp does).

#include "sl_webp_enc.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <vector>

#include "sl_vp8_tables.h"
#include "sl_vp8l_enc.h"

namespace {

struct Error : std::runtime_error {
  int code;
  Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

inline int clip(int v, int m, int M) { return v < m ? m : v > M ? M : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

typedef int64_t score_t;
const score_t MAX_COST = 0x7fffffffffffffLL;
const int BPS = 32;
const int NUM_MB_SEGMENTS = 4, NUM_TYPES = 4, NUM_BANDS = 8, NUM_CTX = 3, NUM_PROBAS = 11;
const int MAX_LEVEL = 2047, MAX_VARIABLE_LEVEL = 67;
const int QFIX = 17;
inline uint32_t BIAS(uint32_t b) { return b << (QFIX - 8); }
inline int QUANTDIV(uint32_t n, uint32_t iQ, uint32_t B) { return (int)((n * iQ + B) >> QFIX); }

// The configuration Pillow's save gives libwebp (WEBP_PRESET_DEFAULT).
const float kQuality = 80.f;
const int kMethod = 4, kSnsStrength = 50, kFilterStrength = 60, kFilterSharpness = 0;
const int kSegments = 4;

// ===========================================================================
// Costs (cost_enc.c, dsp/cost.c)
// ===========================================================================

// libwebp's cost of a boolean event, in 1/256 bit: kEntropyCost[p] for a 0
// coded with probability p/256 (a 1 costs kEntropyCost[255 - p]). The values
// are libwebp's (VP8EntropyCost), not a closed form of -log2.
const uint16_t kEntropyCost[256] = {
    1792, 1792, 1792, 1536, 1536, 1408, 1366, 1280, 1280, 1216, 1178, 1152, 1110, 1076, 1061, 1024,
    1024, 992, 968, 951, 939, 911, 896, 878, 871, 854, 838, 820, 811, 794, 786, 768,
    768, 752, 740, 732, 720, 709, 704, 690, 683, 672, 666, 655, 647, 640, 631, 622,
    615, 607, 598, 592, 586, 576, 572, 564, 559, 555, 547, 541, 534, 528, 522, 512,
    512, 504, 500, 494, 488, 483, 477, 473, 467, 461, 458, 452, 448, 443, 438, 434,
    427, 424, 419, 415, 410, 406, 403, 399, 394, 390, 384, 384, 377, 374, 370, 366,
    362, 359, 355, 351, 347, 342, 342, 336, 333, 330, 326, 323, 320, 316, 312, 308,
    305, 302, 299, 296, 293, 288, 287, 283, 280, 277, 274, 272, 268, 266, 262, 256,
    256, 256, 251, 248, 245, 242, 240, 237, 234, 232, 228, 226, 223, 221, 218, 216,
    214, 211, 208, 205, 203, 201, 198, 196, 192, 191, 188, 187, 183, 181, 179, 176,
    175, 171, 171, 168, 165, 163, 160, 159, 156, 154, 152, 150, 148, 146, 144, 142,
    139, 138, 135, 133, 131, 128, 128, 125, 123, 121, 119, 117, 115, 113, 111, 110,
    107, 105, 103, 102, 100, 98, 96, 94, 92, 91, 89, 86, 86, 83, 82, 80,
    77, 76, 74, 73, 71, 69, 67, 66, 64, 63, 61, 59, 57, 55, 54, 52,
    51, 49, 47, 46, 44, 43, 41, 40, 38, 36, 35, 33, 32, 30, 29, 27,
    25, 24, 22, 21, 19, 18, 16, 15, 13, 12, 10, 9, 7, 6, 4, 3,
};

inline int BitCost(int bit, uint8_t proba) {
  return !bit ? kEntropyCost[proba] : kEntropyCost[255 - proba];
}

// libwebp's fixed rates of the chroma modes (DC, TM, VE, HE). They are not
// the chroma tree's costs under kEntropyCost; libwebp decides with these.
const uint16_t kFixedCostsUV[4] = {302, 984, 439, 642};

// For each level 1..67: the tree probabilities p[2..10] a level is coded with
// (bit i of [0] is p[2 + i]) and the bit coded with each ([1]).
uint16_t kLevelCodes[MAX_VARIABLE_LEVEL][2];
// The part of a level's rate that no probability state changes: its sign
// and its extra bits. libwebp's table equals that sum but at levels 9 and
// 10, where it holds 640.
uint16_t kLevelFixedCosts[MAX_LEVEL + 1];
// The intra-16 mode rates (with the intra-16 flag) and the intra-4 rates
// for each (top, left) context, from the mode trees' fixed probabilities.
uint16_t kFixedCostsI16[4];
uint16_t kFixedCostsI4[10][10][10];
std::once_flag tables_once;

int I4ModeCost(int m, const uint8_t* p) {
  int c = BitCost(m != B_DC_PRED, p[0]);
  if (m == B_DC_PRED) return c;
  c += BitCost(m != B_TM_PRED, p[1]);
  if (m == B_TM_PRED) return c;
  c += BitCost(m != B_VE_PRED, p[2]);
  if (m == B_VE_PRED) return c;
  c += BitCost(m >= B_LD_PRED, p[3]);
  if (m < B_LD_PRED) {
    c += BitCost(m != B_HE_PRED, p[4]);
    if (m != B_HE_PRED) c += BitCost(m != B_RD_PRED, p[5]);
  } else {
    c += BitCost(m != B_LD_PRED, p[6]);
    if (m != B_LD_PRED) {
      c += BitCost(m != B_VL_PRED, p[7]);
      if (m != B_VL_PRED) c += BitCost(m != B_HD_PRED, p[8]);
    }
  }
  return c;
}

void InitCostTables() {
  // Level codes: the path of the token tree below p[1] for each level.
  for (int v = 1; v <= MAX_VARIABLE_LEVEL; ++v) {
    int pattern, bits;
    if (v == 1) pattern = 0x001, bits = 0x000;
    else if (v == 2) pattern = 0x007, bits = 0x001;
    else if (v <= 4) pattern = 0x00f, bits = (v == 3) ? 0x005 : 0x00d;
    else if (v <= 10) pattern = 0x033, bits = (v <= 6) ? 0x003 : 0x023;
    else if (v <= 34) pattern = 0x0d3, bits = (v <= 18) ? 0x013 : 0x093;
    else pattern = 0x153, bits = (v <= 66) ? 0x053 : 0x153;
    kLevelCodes[v - 1][0] = (uint16_t)pattern;
    kLevelCodes[v - 1][1] = (uint16_t)bits;
  }
  // Fixed level costs: the sign bit, then the category's extra bits.
  static const int kCatBase[6] = {5, 7, 11, 19, 35, 67};
  static const uint8_t kCat1[] = {159, 0}, kCat2[] = {165, 145, 0};
  const uint8_t* const cats[6] = {kCat1, kCat2, kCat3, kCat4, kCat5, kCat6};
  kLevelFixedCosts[0] = 0;
  for (int v = 1; v <= MAX_LEVEL; ++v) {
    int cost = 256;
    for (int k = 5; k >= 0; --k) {
      if (v < kCatBase[k]) continue;
      const uint8_t* const tab = cats[k];
      int n = 0;
      while (tab[n]) ++n;
      const int r = v - kCatBase[k];
      for (int i = 0; i < n; ++i) cost += BitCost((r >> (n - 1 - i)) & 1, tab[i]);
      break;
    }
    kLevelFixedCosts[v] = (uint16_t)cost;
  }
  kLevelFixedCosts[9] = kLevelFixedCosts[10] = 640;
  // Intra-16: the flag (1 at 145), then the mode tree (156; 163 or 128).
  for (int m = 0; m < 4; ++m) {
    const int tm_or_h = (m == TM_PRED || m == H_PRED);
    kFixedCostsI16[m] = (uint16_t)(BitCost(1, 145) + BitCost(tm_or_h, 156) +
                                   (tm_or_h ? BitCost(m == TM_PRED, 128)
                                            : BitCost(m == V_PRED, 163)));
  }
  for (int t = 0; t < 10; ++t)
    for (int l = 0; l < 10; ++l)
      for (int m = 0; m < 10; ++m) kFixedCostsI4[t][l][m] = (uint16_t)I4ModeCost(m, kBModesProba[t][l]);
}

inline int LevelCost(const uint16_t* table, int level) {
  return kLevelFixedCosts[level] + table[(level > MAX_VARIABLE_LEVEL) ? MAX_VARIABLE_LEVEL : level];
}

// ===========================================================================
// Boolean encoder (bit_writer_utils.c)
// ===========================================================================

struct BitWriter {
  int32_t range = 255 - 1;
  int32_t value = 0;
  int run = 0;
  int nb_bits = -8;
  std::vector<uint8_t> buf;

  void Flush() {
    const int s = 8 + nb_bits;
    const int32_t bits = value >> s;
    value -= bits << s;
    nb_bits -= 8;
    if ((bits & 0xff) != 0xff) {
      if ((bits & 0x100) && !buf.empty()) buf.back()++;
      if (run > 0) {
        const uint8_t v = (bits & 0x100) ? 0x00 : 0xff;
        for (; run > 0; --run) buf.push_back(v);
      }
      buf.push_back((uint8_t)(bits & 0xff));
    } else {
      run++;  // a 0xff waits for a carry
    }
  }
  // range is kept minus one; renormalise it back to [127, 254].
  void Renorm() {
    int shift = 0;
    while (((range + 1) << shift) < 128) ++shift;
    range = ((range + 1) << shift) - 1;
    value <<= shift;
    nb_bits += shift;
    if (nb_bits > 0) Flush();
  }
  int PutBit(int bit, int prob) {
    const int split = (range * prob) >> 8;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    if (range < 127) Renorm();
    return bit;
  }
  int PutBitUniform(int bit) {
    const int split = range >> 1;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    if (range < 127) Renorm();
    return bit;
  }
  void PutBits(uint32_t v, int nb) {
    for (uint32_t mask = 1u << (nb - 1); mask; mask >>= 1) PutBitUniform(v & mask);
  }
  void PutSignedBits(int v, int nb) {
    if (!PutBitUniform(v != 0)) return;
    if (v < 0) PutBits(((-v) << 1) | 1, nb + 1);
    else PutBits(v << 1, nb + 1);
  }
  void Finish() {
    PutBits(0, 9 - nb_bits);
    nb_bits = 0;
    Flush();
  }
};

// ===========================================================================
// RGB(A) -> YUVA 4:2:0 (picture_csp_enc.c) and the transparent area
// (picture_tools_enc.c)
// ===========================================================================

const int YUV_FIX = 16, YUV_HALF = 1 << (YUV_FIX - 1);
const int kGammaFix = 12, kGammaScale = (1 << kGammaFix) - 1, kGammaTabFix = 7;
const int kGammaTabScale = 1 << kGammaTabFix, kGammaTabRounder = kGammaTabScale >> 1;
const int kGammaTabSize = 1 << (kGammaFix - kGammaTabFix);
const int kAlphaFix = 19;
int kLinearToGammaTab[kGammaTabSize + 1];
uint16_t kGammaToLinearTab[256];
uint32_t kInvAlpha[4 * 0xff + 1];

void InitGammaTables() {
  const double kGamma = 0.80;
  const double scale = (double)(1 << kGammaTabFix) / kGammaScale;
  const double norm = 1. / 255.;
  for (int v = 0; v <= 255; ++v)
    kGammaToLinearTab[v] = (uint16_t)(pow(norm * v, kGamma) * kGammaScale + .5);
  for (int v = 0; v <= kGammaTabSize; ++v)
    kLinearToGammaTab[v] = (int)(255. * pow(scale * v, 1. / kGamma) + .5);
  kInvAlpha[0] = 0;
  for (int a = 1; a <= 4 * 0xff; ++a) kInvAlpha[a] = (1u << kAlphaFix) / a;
}

inline uint32_t GammaToLinear(uint8_t v) { return kGammaToLinearTab[v]; }

inline int Interpolate(int v) {
  const int tab_pos = v >> (kGammaTabFix + 2);
  const int x = v & ((kGammaTabScale << 2) - 1);
  const int v0 = kLinearToGammaTab[tab_pos];
  const int v1 = kLinearToGammaTab[tab_pos + 1];
  return v1 * x + v0 * ((kGammaTabScale << 2) - x);
}

// A linear sum to a gamma value at YUV_FIX + 2 precision.
inline int LinearToGamma(uint32_t base_value, int shift) {
  const int y = Interpolate(base_value << shift);
  return (y + kGammaTabRounder) >> kGammaTabFix;
}

inline int RGBToY(int r, int g, int b) {
  const int luma = 16839 * r + 33059 * g + 6420 * b;
  return (luma + YUV_HALF + (16 << YUV_FIX)) >> YUV_FIX;
}
inline int ClipUV(int uv, int rounding) {
  uv = (uv + rounding + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2);
  return ((uv & ~0xff) == 0) ? uv : (uv < 0) ? 0 : 255;
}
inline int RGBToU(int r, int g, int b) { return ClipUV(-9719 * r - 19081 * g + 28800 * b, YUV_HALF << 2); }
inline int RGBToV(int r, int g, int b) { return ClipUV(28800 * r - 24116 * g - 4684 * b, YUV_HALF << 2); }

struct Picture {
  int width = 0, height = 0;
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v, a;  // a is empty without transparency
};

// The gamma-linear sum of a 2x2 block (step: the pixel step; 0 for the
// odd last column, whose one pixel counts twice).
inline int Sum4(const uint8_t* p, int step, int stride) {
  return LinearToGamma(GammaToLinear(p[0]) + GammaToLinear(p[step]) + GammaToLinear(p[stride]) +
                           GammaToLinear(p[stride + step]),
                       0);
}
inline int Sum2(const uint8_t* p, int stride) {
  return LinearToGamma(GammaToLinear(p[0]) + GammaToLinear(p[stride]), 1);
}
inline int LinearToGammaWeighted(const uint8_t* src, const uint8_t* a, uint32_t total_a, int step,
                                 int stride) {
  const uint32_t sum = a[0] * GammaToLinear(src[0]) + a[step] * GammaToLinear(src[step]) +
                       a[stride] * GammaToLinear(src[stride]) +
                       a[stride + step] * GammaToLinear(src[stride + step]);
  return LinearToGamma((sum * kInvAlpha[total_a]) >> (kAlphaFix - 2), 0);
}

// One row of chroma from two rows of pixels (stride 0 for the last odd row).
void RowsToUV(const uint8_t* rgb, int channels, int stride, int width, bool weighted, uint8_t* u,
              uint8_t* v) {
  const uint8_t* r = rgb;
  const uint8_t* g = rgb + 1;
  const uint8_t* b = rgb + 2;
  const uint8_t* al = rgb + 3;
  const int step = channels;
  int i, j;
  for (i = 0, j = 0; i < (width >> 1); ++i, j += 2 * step) {
    int rr, gg, bb;
    const uint32_t sa = weighted ? (uint32_t)al[j] + al[j + stride] + al[j + step] + al[j + step + stride] : 0;
    if (!weighted || sa == 4 * 0xff || sa == 0) {
      rr = Sum4(r + j, step, stride);
      gg = Sum4(g + j, step, stride);
      bb = Sum4(b + j, step, stride);
    } else {
      rr = LinearToGammaWeighted(r + j, al + j, sa, step, stride);
      gg = LinearToGammaWeighted(g + j, al + j, sa, step, stride);
      bb = LinearToGammaWeighted(b + j, al + j, sa, step, stride);
    }
    u[i] = (uint8_t)RGBToU(rr, gg, bb);
    v[i] = (uint8_t)RGBToV(rr, gg, bb);
  }
  if (width & 1) {
    int rr, gg, bb;
    const uint32_t sa = weighted ? 2u * (al[j] + al[j + stride]) : 0;
    if (!weighted || sa == 4 * 0xff || sa == 0) {
      rr = Sum2(r + j, stride);
      gg = Sum2(g + j, stride);
      bb = Sum2(b + j, stride);
    } else {
      rr = LinearToGammaWeighted(r + j, al + j, sa, 0, stride);
      gg = LinearToGammaWeighted(g + j, al + j, sa, 0, stride);
      bb = LinearToGammaWeighted(b + j, al + j, sa, 0, stride);
    }
    u[i] = (uint8_t)RGBToU(rr, gg, bb);
    v[i] = (uint8_t)RGBToV(rr, gg, bb);
  }
}

bool RowsOpaque(const uint8_t* alpha, int channels, int stride, int width, int rows) {
  for (int y = 0; y < rows; ++y)
    for (int x = 0; x < width; ++x)
      if (alpha[y * stride + x * channels] != 0xff) return false;
  return true;
}

Picture ImportRGBA(const uint8_t* pix, int width, int height, int channels) {
  Picture pic;
  pic.width = width;
  pic.height = height;
  pic.y_stride = width;
  pic.uv_stride = (width + 1) >> 1;
  const int uv_h = (height + 1) >> 1;
  const int stride = width * channels;
  bool has_alpha = false;
  if (channels == 4) has_alpha = !RowsOpaque(pix + 3, 4, stride, width, height);
  pic.y.resize((size_t)width * height);
  pic.u.resize((size_t)pic.uv_stride * uv_h);
  pic.v.resize((size_t)pic.uv_stride * uv_h);
  if (has_alpha) pic.a.resize((size_t)width * height);
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = pix + (size_t)y * stride;
    uint8_t* dy = pic.y.data() + (size_t)y * width;
    for (int x = 0; x < width; ++x) dy[x] = (uint8_t)RGBToY(row[x * channels], row[x * channels + 1], row[x * channels + 2]);
    if (has_alpha) {
      uint8_t* da = pic.a.data() + (size_t)y * width;
      for (int x = 0; x < width; ++x) da[x] = row[x * channels + 3];
    }
  }
  for (int y = 0; y < (height >> 1); ++y) {
    const uint8_t* row = pix + (size_t)2 * y * stride;
    const bool weighted = has_alpha && !RowsOpaque(row + 3, channels, stride, width, 2);
    RowsToUV(row, channels, stride, width, weighted, pic.u.data() + (size_t)y * pic.uv_stride,
             pic.v.data() + (size_t)y * pic.uv_stride);
  }
  if (height & 1) {
    const int y = height >> 1;
    const uint8_t* row = pix + (size_t)2 * y * stride;
    const bool weighted = has_alpha && !RowsOpaque(row + 3, channels, stride, width, 1);
    RowsToUV(row, channels, 0, width, weighted, pic.u.data() + (size_t)y * pic.uv_stride,
             pic.v.data() + (size_t)y * pic.uv_stride);
  }
  return pic;
}

void Flatten(uint8_t* ptr, int v, int stride, int size) {
  for (int y = 0; y < size; ++y, ptr += stride) memset(ptr, v, size);
}

// Fully transparent samples of a partly transparent block take the mean
// luma of its visible ones; returns whether the block is fully transparent.
bool SmoothenBlock(const uint8_t* a_ptr, int a_stride, uint8_t* y_ptr, int y_stride, int width,
                   int height) {
  int sum = 0, count = 0;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      if (a_ptr[y * a_stride + x] != 0) {
        ++count;
        sum += y_ptr[y * y_stride + x];
      }
  if (count > 0 && count < width * height) {
    const uint8_t avg = (uint8_t)(sum / count);
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x)
        if (a_ptr[y * a_stride + x] == 0) y_ptr[y * y_stride + x] = avg;
  }
  return count == 0;
}

void CleanupTransparentArea(Picture& pic) {
  if (pic.a.empty()) return;
  const int SIZE = 8, SIZE2 = 4;
  const int width = pic.width, height = pic.height;
  uint8_t* y_ptr = pic.y.data();
  uint8_t* u_ptr = pic.u.data();
  uint8_t* v_ptr = pic.v.data();
  const uint8_t* a_ptr = pic.a.data();
  int values[3] = {0, 0, 0};
  int x, y;
  for (y = 0; y + SIZE <= height; y += SIZE) {
    int need_reset = 1;
    for (x = 0; x + SIZE <= width; x += SIZE) {
      if (SmoothenBlock(a_ptr + x, width, y_ptr + x, pic.y_stride, SIZE, SIZE)) {
        if (need_reset) {
          values[0] = y_ptr[x];
          values[1] = u_ptr[x >> 1];
          values[2] = v_ptr[x >> 1];
          need_reset = 0;
        }
        Flatten(y_ptr + x, values[0], pic.y_stride, SIZE);
        Flatten(u_ptr + (x >> 1), values[1], pic.uv_stride, SIZE2);
        Flatten(v_ptr + (x >> 1), values[2], pic.uv_stride, SIZE2);
      } else {
        need_reset = 1;
      }
    }
    if (x < width) SmoothenBlock(a_ptr + x, width, y_ptr + x, pic.y_stride, width - x, SIZE);
    a_ptr += SIZE * width;
    y_ptr += SIZE * pic.y_stride;
    u_ptr += SIZE2 * pic.uv_stride;
    v_ptr += SIZE2 * pic.uv_stride;
  }
  if (y < height) {
    const int sub_height = height - y;
    for (x = 0; x + SIZE <= width; x += SIZE)
      SmoothenBlock(a_ptr + x, width, y_ptr + x, pic.y_stride, SIZE, sub_height);
    if (x < width) SmoothenBlock(a_ptr + x, width, y_ptr + x, pic.y_stride, width - x, sub_height);
  }
}

// ===========================================================================
// Transforms, predictions and distortions (dsp/enc.c, C versions)
// ===========================================================================

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
const int kScanUV[8] = {0 + 0 * BPS, 4 + 0 * BPS, 0 + 4 * BPS, 4 + 4 * BPS,
                        8 + 0 * BPS, 12 + 0 * BPS, 8 + 4 * BPS, 12 + 4 * BPS};
// The histogram's blocks: luma, then U and V at U_OFF.
const int kDspScan[16 + 4 + 4] = {
    0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
    8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
    0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS, 0 + 0 * BPS, 4 + 0 * BPS,
    0 + 4 * BPS,  4 + 4 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 8 + 4 * BPS,  12 + 4 * BPS};

const int Y_OFF = 0, U_OFF = 16, V_OFF = 16 + 8;
const int YUV_SIZE = BPS * 16;
const int PRED_SIZE = 32 * BPS + 16 * BPS + 8 * BPS;
const int I16DC16 = 0, I16TM16 = 16, I16VE16 = 16 * BPS, I16HE16 = 16 * BPS + 16;
const int C8DC8 = 2 * 16 * BPS, C8TM8 = C8DC8 + 16, C8VE8 = 2 * 16 * BPS + 8 * BPS, C8HE8 = C8VE8 + 16;
const int I4DC4 = 3 * 16 * BPS, I4TM4 = I4DC4 + 4, I4VE4 = I4DC4 + 8, I4HE4 = I4DC4 + 12,
          I4RD4 = I4DC4 + 16, I4VR4 = I4DC4 + 20, I4LD4 = I4DC4 + 24, I4VL4 = I4DC4 + 28,
          I4HD4 = 3 * 16 * BPS + 4 * BPS, I4HU4 = I4HD4 + 4, I4TMP = I4HD4 + 8;
const int kI16ModeOffsets[4] = {I16DC16, I16TM16, I16VE16, I16HE16};
const int kUVModeOffsets[4] = {C8DC8, C8TM8, C8VE8, C8HE8};
const int kI4ModeOffsets[10] = {I4DC4, I4TM4, I4VE4, I4HE4, I4RD4, I4VR4, I4LD4, I4VL4, I4HD4, I4HU4};

// The encoder's forward DCT (its roundings are libwebp's, not RFC 6386's).
void FTransform(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1], d2 = src[2] - ref[2], d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
    out[4 + i] = (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0));
    out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
    out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}
void FTransform2(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  FTransform(src, ref, out);
  FTransform(src + 4, ref + 4, out + 16);
}

void FTransformWHT(const int16_t* in, int16_t* out) {
  int32_t tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0 * 16] + in[2 * 16], a1 = in[1 * 16] + in[3 * 16];
    const int a2 = in[1 * 16] - in[3 * 16], a3 = in[0 * 16] - in[2 * 16];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    const int b0 = a0 + a1, b1 = a3 + a2, b2 = a3 - a2, b3 = a0 - a1;
    out[0 + i] = (int16_t)(b0 >> 1);
    out[4 + i] = (int16_t)(b1 >> 1);
    out[8 + i] = (int16_t)(b2 >> 1);
    out[12 + i] = (int16_t)(b3 >> 1);
  }
}

// The decoder's inverse WHT: the 16 DCs into out[0], out[16], ...
void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

inline int MUL1(int a) { return ((a * 20091) >> 16) + a; }
inline int MUL2(int a) { return (a * 35468) >> 16; }

void ITransformOne(const uint8_t* ref, const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]), d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]), d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0 + i * BPS] = clip8(ref[0 + i * BPS] + ((a + d) >> 3));
    dst[1 + i * BPS] = clip8(ref[1 + i * BPS] + ((b + c) >> 3));
    dst[2 + i * BPS] = clip8(ref[2 + i * BPS] + ((b - c) >> 3));
    dst[3 + i * BPS] = clip8(ref[3 + i * BPS] + ((a - d) >> 3));
  }
}
void ITransform(const uint8_t* ref, const int16_t* in, uint8_t* dst, int do_two) {
  ITransformOne(ref, in, dst);
  if (do_two) ITransformOne(ref + 4, in + 16, dst + 4);
}

void Fill(uint8_t* dst, int value, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, value, size);
}
void VerticalPred(uint8_t* dst, const uint8_t* top, int size) {
  if (top != nullptr) {
    for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, top, size);
  } else {
    Fill(dst, 127, size);
  }
}
void HorizontalPred(uint8_t* dst, const uint8_t* left, int size) {
  if (left != nullptr) {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, left[j], size);
  } else {
    Fill(dst, 129, size);
  }
}
void TrueMotion(uint8_t* dst, const uint8_t* left, const uint8_t* top, int size) {
  if (left != nullptr) {
    if (top != nullptr) {
      for (int y = 0; y < size; ++y, dst += BPS)
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left[y] - left[-1]);
    } else {
      HorizontalPred(dst, left, size);
    }
  } else {
    // without left samples TM is VE (129 where there is no top either)
    if (top != nullptr) VerticalPred(dst, top, size);
    else Fill(dst, 129, size);
  }
}
void DCMode(uint8_t* dst, const uint8_t* left, const uint8_t* top, int size, int round, int shift) {
  int DC = 0;
  if (top != nullptr) {
    for (int j = 0; j < size; ++j) DC += top[j];
    if (left != nullptr) {
      for (int j = 0; j < size; ++j) DC += left[j];
    } else {
      DC += DC;
    }
    DC = (DC + round) >> shift;
  } else if (left != nullptr) {
    for (int j = 0; j < size; ++j) DC += left[j];
    DC += DC;
    DC = (DC + round) >> shift;
  } else {
    DC = 0x80;
  }
  Fill(dst, DC, size);
}

void Intra16Preds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  DCMode(I16DC16 + dst, left, top, 16, 16, 5);
  VerticalPred(I16VE16 + dst, top, 16);
  HorizontalPred(I16HE16 + dst, left, 16);
  TrueMotion(I16TM16 + dst, left, top, 16);
}
void IntraChromaPreds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  for (int ch = 0; ch < 2; ++ch) {  // U, then V (8 to the right)
    DCMode(C8DC8 + dst, left, top, 8, 8, 4);
    VerticalPred(C8VE8 + dst, top, 8);
    HorizontalPred(C8HE8 + dst, left, 8);
    TrueMotion(C8TM8 + dst, left, top, 8);
    dst += 8;
    if (top != nullptr) top += 8;
    if (left != nullptr) left += 16;
  }
}

inline uint8_t AVG3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t AVG2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

// The ten intra-4 predictions; left samples are top[-5..-2], top-left
// top[-1], top top[0..3] and top-right top[4..7].
void Intra4Preds(uint8_t* base, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  uint8_t* dst;
  {  // DC
    uint32_t dc = 4;
    for (int i = 0; i < 4; ++i) dc += top[i] + top[-5 + i];
    Fill(base + I4DC4, dc >> 3, 4);
  }
  dst = base + I4TM4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) DST(x, y) = clip8(top[x] + top[-2 - y] - X);
  dst = base + I4VE4;
  {
    const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
    for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
  }
  dst = base + I4HE4;
  memset(dst + 0 * BPS, AVG3(X, I, J), 4);
  memset(dst + 1 * BPS, AVG3(I, J, K), 4);
  memset(dst + 2 * BPS, AVG3(J, K, L), 4);
  memset(dst + 3 * BPS, AVG3(K, L, L), 4);
  dst = base + I4RD4;
  DST(0, 3) = AVG3(J, K, L);
  DST(0, 2) = DST(1, 3) = AVG3(I, J, K);
  DST(0, 1) = DST(1, 2) = DST(2, 3) = AVG3(X, I, J);
  DST(0, 0) = DST(1, 1) = DST(2, 2) = DST(3, 3) = AVG3(A, X, I);
  DST(1, 0) = DST(2, 1) = DST(3, 2) = AVG3(B, A, X);
  DST(2, 0) = DST(3, 1) = AVG3(C, B, A);
  DST(3, 0) = AVG3(D, C, B);
  dst = base + I4VR4;
  DST(0, 0) = DST(1, 2) = AVG2(X, A);
  DST(1, 0) = DST(2, 2) = AVG2(A, B);
  DST(2, 0) = DST(3, 2) = AVG2(B, C);
  DST(3, 0) = AVG2(C, D);
  DST(0, 3) = AVG3(K, J, I);
  DST(0, 2) = AVG3(J, I, X);
  DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
  DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
  DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
  DST(3, 1) = AVG3(B, C, D);
  dst = base + I4LD4;
  DST(0, 0) = AVG3(A, B, C);
  DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
  DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
  DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
  DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
  DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
  DST(3, 3) = AVG3(G, H, H);
  dst = base + I4VL4;
  DST(0, 0) = AVG2(A, B);
  DST(1, 0) = DST(0, 2) = AVG2(B, C);
  DST(2, 0) = DST(1, 2) = AVG2(C, D);
  DST(3, 0) = DST(2, 2) = AVG2(D, E);
  DST(0, 1) = AVG3(A, B, C);
  DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
  DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
  DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
  DST(3, 2) = AVG3(E, F, G);
  DST(3, 3) = AVG3(F, G, H);
  dst = base + I4HD4;
  DST(0, 0) = DST(2, 1) = AVG2(I, X);
  DST(0, 1) = DST(2, 2) = AVG2(J, I);
  DST(0, 2) = DST(2, 3) = AVG2(K, J);
  DST(0, 3) = AVG2(L, K);
  DST(3, 0) = AVG3(A, B, C);
  DST(2, 0) = AVG3(X, A, B);
  DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
  DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
  DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
  DST(1, 3) = AVG3(L, K, J);
  dst = base + I4HU4;
  DST(0, 0) = AVG2(I, J);
  DST(2, 0) = DST(0, 1) = AVG2(J, K);
  DST(2, 1) = DST(0, 2) = AVG2(K, L);
  DST(1, 0) = AVG3(I, J, K);
  DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
  DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
  DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
}
#undef DST

int GetSSE(const uint8_t* a, const uint8_t* b, int w, int h) {
  int count = 0;
  for (int y = 0; y < h; ++y, a += BPS, b += BPS)
    for (int x = 0; x < w; ++x) {
      const int diff = (int)a[x] - b[x];
      count += diff * diff;
    }
  return count;
}

// Weighted sum of the absolute Hadamard coefficients of a 4x4 block.
int TTransform(const uint8_t* in, const uint16_t* w) {
  int sum = 0;
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += BPS) {
    const int a0 = in[0] + in[2], a1 = in[1] + in[3], a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i, ++w) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    const int b0 = a0 + a1, b1 = a3 + a2, b2 = a3 - a2, b3 = a0 - a1;
    sum += w[0] * abs(b0);
    sum += w[4] * abs(b1);
    sum += w[8] * abs(b2);
    sum += w[12] * abs(b3);
  }
  return sum;
}
int Disto4x4(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  return abs(TTransform(b, w) - TTransform(a, w)) >> 5;
}
int Disto16x16(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  int D = 0;
  for (int y = 0; y < 16 * BPS; y += 4 * BPS)
    for (int x = 0; x < 16; x += 4) D += Disto4x4(a + x + y, b + x + y, w);
  return D;
}

const int MAX_COEFF_THRESH = 31;

// The susceptibility of a block set to quantisation: 2 * 255 * (largest bin
// of |coefficient| / 8) / (count of the fullest bin), from the encoder's DCT.
int CollectAlpha(const uint8_t* ref, const uint8_t* pred, int start_block, int end_block) {
  int distribution[MAX_COEFF_THRESH + 1] = {0};
  for (int j = start_block; j < end_block; ++j) {
    int16_t out[16];
    FTransform(ref + kDspScan[j], pred + kDspScan[j], out);
    for (int k = 0; k < 16; ++k) {
      const int v = abs(out[k]) >> 3;
      ++distribution[v > MAX_COEFF_THRESH ? MAX_COEFF_THRESH : v];
    }
  }
  int max_value = 0, last_non_zero = 1;
  for (int k = 0; k <= MAX_COEFF_THRESH; ++k) {
    const int value = distribution[k];
    if (value > 0) {
      if (value > max_value) max_value = value;
      last_non_zero = k;
    }
  }
  return (max_value > 1) ? 2 * 255 * last_non_zero / max_value : 0;
}

// ===========================================================================
// Quantisation matrices (quant_enc.c)
// ===========================================================================

struct Matrix {
  uint16_t q[16];
  uint16_t iq[16];
  uint32_t bias[16];
  uint32_t zthresh[16];
  uint16_t sharpen[16];
};

const uint8_t kBiasMatrices[3][2] = {{96, 110}, {96, 108}, {110, 115}};
const int SHARPEN_BITS = 11;
const uint8_t kFreqSharpening[16] = {0, 30, 60, 90, 30, 60, 90, 90, 60, 90, 90, 90, 90, 90, 90, 90};
const uint16_t kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7, 20, 17, 10, 4, 9, 7, 4, 2};

// Returns the average quantiser.
int ExpandMatrix(Matrix* m, int type) {
  for (int i = 0; i < 2; ++i) {
    const int is_ac_coeff = (i > 0);
    const int bias = kBiasMatrices[type][is_ac_coeff];
    m->iq[i] = (uint16_t)((1 << QFIX) / m->q[i]);
    m->bias[i] = BIAS(bias);
    m->zthresh[i] = ((1 << QFIX) - 1 - m->bias[i]) / m->iq[i];
  }
  for (int i = 2; i < 16; ++i) {
    m->q[i] = m->q[1];
    m->iq[i] = m->iq[1];
    m->bias[i] = m->bias[1];
    m->zthresh[i] = m->zthresh[1];
  }
  int sum = 0;
  for (int i = 0; i < 16; ++i) {
    m->sharpen[i] = (type == 0) ? (uint16_t)((kFreqSharpening[i] * m->q[i]) >> SHARPEN_BITS) : 0;
    sum += m->q[i];
  }
  return (sum + 8) >> 4;
}

int QuantizeBlock(int16_t in[16], int16_t out[16], const Matrix* mtx) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n];
    const int sign = (in[j] < 0);
    const uint32_t coeff = (sign ? -in[j] : in[j]) + mtx->sharpen[j];
    if (coeff > mtx->zthresh[j]) {
      const uint32_t Q = mtx->q[j], iQ = mtx->iq[j], B = mtx->bias[j];
      int level = QUANTDIV(coeff, iQ, B);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      in[j] = (int16_t)(level * (int)Q);
      out[n] = (int16_t)level;
      if (level) last = n;
    } else {
      out[n] = 0;
      in[j] = 0;
    }
  }
  return last >= 0;
}
int Quantize2Blocks(int16_t in[32], int16_t out[32], const Matrix* mtx) {
  int nz = QuantizeBlock(in, out, mtx) << 0;
  nz |= QuantizeBlock(in + 16, out + 16, mtx) << 1;
  return nz;
}

// ===========================================================================
// The encoder
// ===========================================================================

struct SegmentInfo {
  Matrix y1, y2, uv;
  int alpha, beta, quant, fstrength, max_edge, min_disto;
  int lambda_i16, lambda_i4, lambda_uv, lambda_mode, tlambda;
};

struct MBInfo {
  uint8_t type;  // 0 = i4x4, 1 = i16x16
  uint8_t uv_mode;
  uint8_t segment;
  uint8_t alpha;
};

typedef uint8_t ProbaArray[NUM_CTX][NUM_PROBAS];
typedef uint32_t StatsArray[NUM_CTX][NUM_PROBAS];
typedef uint16_t CostArray[NUM_CTX][MAX_VARIABLE_LEVEL + 1];

struct Proba {
  uint8_t segments[3];
  uint8_t coeffs[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint32_t stats[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint16_t level_cost[NUM_TYPES][NUM_BANDS][NUM_CTX][MAX_VARIABLE_LEVEL + 1];
  const uint16_t* remapped_costs[NUM_TYPES][16][NUM_CTX];
  int dirty;
};

struct ModeScore {
  score_t D, SD;
  score_t H, R, score;
  int16_t y_dc_levels[16];
  int16_t y_ac_levels[16][16];
  int16_t uv_levels[4 + 4][16];
  int mode_i16;
  uint8_t modes_i4[16];
  int mode_uv;
  uint32_t nz;
  int8_t derr[2][3];
};

typedef int8_t DError[2][2];

struct Residual {
  int first;
  int last;
  const int16_t* coeffs;
  int coeff_type;
  ProbaArray* prob;
  StatsArray* stats;
  const uint16_t* const (*costs)[NUM_CTX];
};

struct Encoder;

struct Iterator {
  int x, y;
  uint8_t* yuv_in;
  uint8_t* yuv_out;
  uint8_t* yuv_out2;
  uint8_t* yuv_p;
  Encoder* enc;
  MBInfo* mb;
  uint8_t* preds;
  uint32_t* nz;
  uint8_t i4_boundary[37];
  uint8_t* i4_top;
  int i4;
  int top_nz[9];
  int left_nz[9];
  int count_down;
  DError left_derr;
  DError* top_derr;
  uint8_t* y_left;
  uint8_t* u_left;
  uint8_t* v_left;
  uint8_t* y_top;
  uint8_t* uv_top;
  uint8_t yuv_left_mem[17 + 16 + 16 + 8 + 32];
  uint8_t yuv_mem[3 * YUV_SIZE + PRED_SIZE + 32];
};

struct Encoder {
  const Picture* pic;
  // headers
  int filter_simple, filter_level, filter_sharpness;
  int num_segments, update_map;
  int profile;
  int mb_w, mb_h, preds_w;
  BitWriter bw;      // partition 0
  BitWriter part;    // the token partition
  std::vector<uint16_t> tokens;
  SegmentInfo dqm[NUM_MB_SEGMENTS];
  int base_quant;
  int uv_alpha;
  int dq_y1_dc, dq_y2_dc, dq_y2_ac, dq_uv_dc, dq_uv_ac;
  Proba proba;
  int max_i4_header_bits;
  std::vector<MBInfo> mb_info;
  std::vector<uint8_t> preds_mem;
  uint8_t* preds;
  std::vector<uint32_t> nz_mem;
  uint32_t* nz;
  std::vector<uint8_t> top_mem;
  uint8_t* y_top;
  uint8_t* uv_top;
  std::vector<int8_t> top_derr_mem;
  DError* top_derr;
};

// ---------------------------------------------------------------------------
// The iterator (iterator_enc.c)

void InitLeft(Iterator* it) {
  it->y_left[-1] = it->u_left[-1] = it->v_left[-1] = (it->y > 0) ? 129 : 127;
  memset(it->y_left, 129, 16);
  memset(it->u_left, 129, 8);
  memset(it->v_left, 129, 8);
  it->left_nz[8] = 0;
  memset(it->left_derr, 0, sizeof(it->left_derr));
}

void InitTop(Iterator* it) {
  Encoder* const enc = it->enc;
  memset(enc->y_top, 127, 2 * enc->mb_w * 16);
  memset(enc->nz, 0, enc->mb_w * sizeof(*enc->nz));
  memset(enc->top_derr, 0, enc->mb_w * sizeof(DError));
}

void IteratorSetRow(Iterator* it, int y) {
  Encoder* const enc = it->enc;
  it->x = 0;
  it->y = y;
  it->preds = enc->preds + y * 4 * enc->preds_w;
  it->nz = enc->nz;
  it->mb = enc->mb_info.data() + y * enc->mb_w;
  it->y_top = enc->y_top;
  it->uv_top = enc->uv_top;
  InitLeft(it);
}

void IteratorReset(Iterator* it) {
  Encoder* const enc = it->enc;
  IteratorSetRow(it, 0);
  it->count_down = enc->mb_w * enc->mb_h;
  InitTop(it);
}

void IteratorInit(Encoder* enc, Iterator* it) {
  it->enc = enc;
  it->yuv_in = it->yuv_mem;
  it->yuv_out = it->yuv_in + YUV_SIZE;
  it->yuv_out2 = it->yuv_out + YUV_SIZE;
  it->yuv_p = it->yuv_out2 + YUV_SIZE;
  it->y_left = it->yuv_left_mem + 1;
  it->u_left = it->y_left + 16 + 16;
  it->v_left = it->u_left + 16;
  it->top_derr = enc->top_derr;
  IteratorReset(it);
}

int IteratorNext(Iterator* it) {
  if (++it->x == it->enc->mb_w) {
    IteratorSetRow(it, ++it->y);
  } else {
    it->preds += 4;
    it->mb += 1;
    it->nz += 1;
    it->y_top += 16;
    it->uv_top += 16;
  }
  return 0 < --it->count_down;
}

void ImportBlock(const uint8_t* src, int src_stride, uint8_t* dst, int w, int h, int size) {
  int i;
  for (i = 0; i < h; ++i) {
    memcpy(dst, src, w);
    if (w < size) memset(dst + w, dst[w - 1], size - w);
    dst += BPS;
    src += src_stride;
  }
  for (i = h; i < size; ++i) {
    memcpy(dst, dst - BPS, size);
    dst += BPS;
  }
}

void ImportLine(const uint8_t* src, int src_stride, uint8_t* dst, int len, int total_len) {
  int i;
  for (i = 0; i < len; ++i, src += src_stride) dst[i] = *src;
  for (; i < total_len; ++i) dst[i] = dst[len - 1];
}

// The macroblock's source samples; with tmp_32, also the source's own
// boundary samples (the analysis pretends the reconstruction is lossless).
void IteratorImport(Iterator* it, uint8_t* tmp_32) {
  const Encoder* const enc = it->enc;
  const int x = it->x, y = it->y;
  const Picture* const pic = enc->pic;
  const uint8_t* const ysrc = pic->y.data() + (y * pic->y_stride + x) * 16;
  const uint8_t* const usrc = pic->u.data() + (y * pic->uv_stride + x) * 8;
  const uint8_t* const vsrc = pic->v.data() + (y * pic->uv_stride + x) * 8;
  const int w = std::min(pic->width - x * 16, 16);
  const int h = std::min(pic->height - y * 16, 16);
  const int uv_w = (w + 1) >> 1;
  const int uv_h = (h + 1) >> 1;

  ImportBlock(ysrc, pic->y_stride, it->yuv_in + Y_OFF, w, h, 16);
  ImportBlock(usrc, pic->uv_stride, it->yuv_in + U_OFF, uv_w, uv_h, 8);
  ImportBlock(vsrc, pic->uv_stride, it->yuv_in + V_OFF, uv_w, uv_h, 8);

  if (tmp_32 == nullptr) return;

  if (x == 0) {
    InitLeft(it);
  } else {
    if (y == 0) {
      it->y_left[-1] = it->u_left[-1] = it->v_left[-1] = 127;
    } else {
      it->y_left[-1] = ysrc[-1 - pic->y_stride];
      it->u_left[-1] = usrc[-1 - pic->uv_stride];
      it->v_left[-1] = vsrc[-1 - pic->uv_stride];
    }
    ImportLine(ysrc - 1, pic->y_stride, it->y_left, h, 16);
    ImportLine(usrc - 1, pic->uv_stride, it->u_left, uv_h, 8);
    ImportLine(vsrc - 1, pic->uv_stride, it->v_left, uv_h, 8);
  }

  it->y_top = tmp_32 + 0;
  it->uv_top = tmp_32 + 16;
  if (y == 0) {
    memset(tmp_32, 127, 32);
  } else {
    ImportLine(ysrc - pic->y_stride, 1, tmp_32, w, 16);
    ImportLine(usrc - pic->uv_stride, 1, tmp_32 + 16, uv_w, 8);
    ImportLine(vsrc - pic->uv_stride, 1, tmp_32 + 16 + 8, uv_w, 8);
  }
}

void IteratorSaveBoundary(Iterator* it) {
  Encoder* const enc = it->enc;
  const int x = it->x, y = it->y;
  const uint8_t* const ysrc = it->yuv_out + Y_OFF;
  const uint8_t* const uvsrc = it->yuv_out + U_OFF;
  if (x < enc->mb_w - 1) {  // left
    for (int i = 0; i < 16; ++i) it->y_left[i] = ysrc[15 + i * BPS];
    for (int i = 0; i < 8; ++i) {
      it->u_left[i] = uvsrc[7 + i * BPS];
      it->v_left[i] = uvsrc[15 + i * BPS];
    }
    // top-left (before 'top'!)
    it->y_left[-1] = it->y_top[15];
    it->u_left[-1] = it->uv_top[0 + 7];
    it->v_left[-1] = it->uv_top[8 + 7];
  }
  if (y < enc->mb_h - 1) {  // top
    memcpy(it->y_top, ysrc + 15 * BPS, 16);
    memcpy(it->uv_top, uvsrc + 7 * BPS, 8 + 8);
  }
}

inline int BIT(uint32_t nz, int n) { return (nz >> n) & 1; }

void IteratorNzToBytes(Iterator* it) {
  const uint32_t tnz = it->nz[0], lnz = it->nz[-1];
  int* const top_nz = it->top_nz;
  int* const left_nz = it->left_nz;
  top_nz[0] = BIT(tnz, 12);
  top_nz[1] = BIT(tnz, 13);
  top_nz[2] = BIT(tnz, 14);
  top_nz[3] = BIT(tnz, 15);
  top_nz[4] = BIT(tnz, 18);
  top_nz[5] = BIT(tnz, 19);
  top_nz[6] = BIT(tnz, 22);
  top_nz[7] = BIT(tnz, 23);
  top_nz[8] = BIT(tnz, 24);
  left_nz[0] = BIT(lnz, 3);
  left_nz[1] = BIT(lnz, 7);
  left_nz[2] = BIT(lnz, 11);
  left_nz[3] = BIT(lnz, 15);
  left_nz[4] = BIT(lnz, 17);
  left_nz[5] = BIT(lnz, 19);
  left_nz[6] = BIT(lnz, 21);
  left_nz[7] = BIT(lnz, 23);
  // left_nz[8] (the DC's) is carried along the row on its own
}

void IteratorBytesToNz(Iterator* it) {
  uint32_t nz = 0;
  const int* const top_nz = it->top_nz;
  const int* const left_nz = it->left_nz;
  nz |= (top_nz[0] << 12) | (top_nz[1] << 13);
  nz |= (top_nz[2] << 14) | (top_nz[3] << 15);
  nz |= (top_nz[4] << 18) | (top_nz[5] << 19);
  nz |= (top_nz[6] << 22) | (top_nz[7] << 23);
  nz |= (top_nz[8] << 24);  // the top DC bit goes on, for intra-4 too
  nz |= (left_nz[0] << 3) | (left_nz[1] << 7);
  nz |= (left_nz[2] << 11);
  nz |= (left_nz[4] << 17) | (left_nz[6] << 21);
  *it->nz = nz;
}

const uint8_t kTopLeftI4[16] = {17, 21, 25, 29, 13, 17, 21, 25, 9, 13, 17, 21, 5, 9, 13, 17};

void IteratorStartI4(Iterator* it) {
  const Encoder* const enc = it->enc;
  it->i4 = 0;
  it->i4_top = it->i4_boundary + kTopLeftI4[0];
  for (int i = 0; i < 17; ++i) it->i4_boundary[i] = it->y_left[15 - i];  // left
  for (int i = 0; i < 16; ++i) it->i4_boundary[17 + i] = it->y_top[i];   // top
  if (it->x < enc->mb_w - 1) {  // top-right
    for (int i = 16; i < 16 + 4; ++i) it->i4_boundary[17 + i] = it->y_top[i];
  } else {  // on the far right: the last top sample, four times
    for (int i = 16; i < 16 + 4; ++i) it->i4_boundary[17 + i] = it->i4_boundary[17 + 15];
  }
  IteratorNzToBytes(it);
}

int IteratorRotateI4(Iterator* it, const uint8_t* yuv_out) {
  const uint8_t* const blk = yuv_out + kScan[it->i4];
  uint8_t* const top = it->i4_top;
  for (int i = 0; i <= 3; ++i) top[-4 + i] = blk[i + 3 * BPS];  // future top samples
  if ((it->i4 & 3) != 3) {
    for (int i = 0; i <= 2; ++i) top[i] = blk[3 + (2 - i) * BPS];  // future left samples
  } else {  // the right column keeps the top-right samples
    for (int i = 0; i <= 3; ++i) top[i] = top[i + 4];
  }
  ++it->i4;
  if (it->i4 == 16) return 0;
  it->i4_top = it->i4_boundary + kTopLeftI4[it->i4];
  return 1;
}

void SetIntra16Mode(const Iterator* it, int mode) {
  uint8_t* preds = it->preds;
  for (int y = 0; y < 4; ++y, preds += it->enc->preds_w) memset(preds, mode, 4);
  it->mb->type = 1;
}
void SetIntra4Mode(const Iterator* it, const uint8_t* modes) {
  uint8_t* preds = it->preds;
  for (int y = 4; y > 0; --y, preds += it->enc->preds_w, modes += 4) memcpy(preds, modes, 4);
  it->mb->type = 0;
}

void MakeLuma16Preds(const Iterator* it) {
  Intra16Preds(it->yuv_p, it->x ? it->y_left : nullptr, it->y ? it->y_top : nullptr);
}
void MakeChroma8Preds(const Iterator* it) {
  IntraChromaPreds(it->yuv_p, it->x ? it->u_left : nullptr, it->y ? it->uv_top : nullptr);
}

// ---------------------------------------------------------------------------
// Analysis (analysis_enc.c): segments from the susceptibilities

const int MAX_ALPHA = 255;
const int MAX_ITERS_K_MEANS = 6;

void SetSegmentAlphas(Encoder* enc, const int centers[NUM_MB_SEGMENTS], int mid) {
  const int nb = enc->num_segments;
  int min = centers[0], max = centers[0];
  if (nb > 1) {
    for (int n = 0; n < nb; ++n) {
      if (min > centers[n]) min = centers[n];
      if (max < centers[n]) max = centers[n];
    }
  }
  if (max == min) max = min + 1;
  for (int n = 0; n < nb; ++n) {
    const int alpha = 255 * (centers[n] - mid) / (max - min);
    const int beta = 255 * (centers[n] - min) / (max - min);
    enc->dqm[n].alpha = clip(alpha, -127, 127);
    enc->dqm[n].beta = clip(beta, 0, 255);
  }
}

void AssignSegments(Encoder* enc, const int alphas[MAX_ALPHA + 1]) {
  const int nb = std::min(enc->num_segments, NUM_MB_SEGMENTS);
  int centers[NUM_MB_SEGMENTS];
  int weighted_average = 0;
  int map[MAX_ALPHA + 1];
  int a, n, k;
  int accum[NUM_MB_SEGMENTS], dist_accum[NUM_MB_SEGMENTS];

  for (n = 0; n <= MAX_ALPHA && alphas[n] == 0; ++n) {
  }
  const int min_a = n;
  for (n = MAX_ALPHA; n > min_a && alphas[n] == 0; --n) {
  }
  const int max_a = n;
  const int range_a = max_a - min_a;

  for (k = 0, n = 1; k < nb; ++k, n += 2) centers[k] = min_a + (n * range_a) / (2 * nb);

  for (k = 0; k < MAX_ITERS_K_MEANS; ++k) {
    for (n = 0; n < nb; ++n) accum[n] = dist_accum[n] = 0;
    n = 0;
    for (a = min_a; a <= max_a; ++a) {
      if (alphas[a]) {
        while (n + 1 < nb && abs(a - centers[n + 1]) < abs(a - centers[n])) n++;
        map[a] = n;
        dist_accum[n] += a * alphas[a];
        accum[n] += alphas[a];
      }
    }
    int displaced = 0;
    weighted_average = 0;
    int total_weight = 0;
    for (n = 0; n < nb; ++n) {
      if (accum[n]) {
        const int new_center = (dist_accum[n] + accum[n] / 2) / accum[n];
        displaced += abs(centers[n] - new_center);
        centers[n] = new_center;
        weighted_average += new_center * accum[n];
        total_weight += accum[n];
      }
    }
    weighted_average = (weighted_average + total_weight / 2) / total_weight;
    if (displaced < 5) break;
  }

  for (n = 0; n < enc->mb_w * enc->mb_h; ++n) {
    MBInfo* const mb = &enc->mb_info[n];
    const int alpha = mb->alpha;
    mb->segment = (uint8_t)map[alpha];
    mb->alpha = (uint8_t)centers[map[alpha]];
  }
  SetSegmentAlphas(enc, centers, weighted_average);
}

int MBAnalyzeBestIntra16Mode(Iterator* it) {
  int best_alpha = -1, best_mode = 0;
  MakeLuma16Preds(it);
  for (int mode = 0; mode < 2; ++mode) {  // DC and TM
    const int alpha = CollectAlpha(it->yuv_in + Y_OFF, it->yuv_p + kI16ModeOffsets[mode], 0, 16);
    if (alpha > best_alpha) {
      best_alpha = alpha;
      best_mode = mode;
    }
  }
  SetIntra16Mode(it, best_mode);
  return best_alpha;
}

int MBAnalyzeBestUVMode(Iterator* it) {
  int best_alpha = -1, smallest_alpha = 0, best_mode = 0;
  MakeChroma8Preds(it);
  for (int mode = 0; mode < 2; ++mode) {
    const int alpha = CollectAlpha(it->yuv_in + U_OFF, it->yuv_p + kUVModeOffsets[mode], 16, 16 + 4 + 4);
    if (alpha > best_alpha) best_alpha = alpha;
    if (mode == 0 || alpha < smallest_alpha) {
      smallest_alpha = alpha;
      best_mode = mode;
    }
  }
  it->mb->uv_mode = (uint8_t)best_mode;
  return best_alpha;
}

void Analyze(Encoder* enc) {
  int alphas[MAX_ALPHA + 1] = {0};
  int uv_alpha_sum = 0;
  Iterator it;
  IteratorInit(enc, &it);
  uint8_t tmp[32];
  do {
    IteratorImport(&it, tmp);
    SetIntra16Mode(&it, 0);
    it.mb->segment = 0;
    int best_alpha = MBAnalyzeBestIntra16Mode(&it);
    const int best_uv_alpha = MBAnalyzeBestUVMode(&it);
    best_alpha = (3 * best_alpha + best_uv_alpha + 2) >> 2;
    best_alpha = clip(MAX_ALPHA - best_alpha, 0, MAX_ALPHA);
    alphas[best_alpha]++;
    it.mb->alpha = (uint8_t)best_alpha;
    uv_alpha_sum += best_uv_alpha;
  } while (IteratorNext(&it));
  enc->uv_alpha = uv_alpha_sum / (enc->mb_w * enc->mb_h);
  AssignSegments(enc, alphas);
}

// ---------------------------------------------------------------------------
// Segment parameters (quant_enc.c, filter_enc.c)

const double SNS_TO_DQ = 0.9;
const int MID_ALPHA = 64, MIN_ALPHA = 30, MAX_ALPHA_UV = 100;
const int MAX_DQ_UV = 6, MIN_DQ_UV = -4;
const int FSTRENGTH_CUTOFF = 2;

// The loop-filter level that smooths an edge step of 'delta' (sharpness 0).
int FilterStrengthFromDelta(int delta) { return delta < 64 ? delta : 63; }

double QualityToCompression(double c) {
  const double linear_c = (c < 0.75) ? c * (2. / 3.) : 2. * c - 1.;
  return pow(linear_c, 1 / 3.);
}

void SetupFilterStrength(Encoder* enc) {
  const int level0 = 5 * kFilterStrength;
  for (int i = 0; i < NUM_MB_SEGMENTS; ++i) {
    SegmentInfo* const m = &enc->dqm[i];
    const int qstep = kAcTable[clip(m->quant, 0, 127)] >> 2;
    const int base_strength = FilterStrengthFromDelta(qstep);
    const int f = base_strength * level0 / (256 + m->beta);
    m->fstrength = (f < FSTRENGTH_CUTOFF) ? 0 : (f > 63) ? 63 : f;
  }
  enc->filter_level = enc->dqm[0].fstrength;
  enc->filter_simple = 0;
  enc->filter_sharpness = kFilterSharpness;
}

void SimplifySegments(Encoder* enc) {
  int map[NUM_MB_SEGMENTS] = {0, 1, 2, 3};
  const int num_segments = std::min(enc->num_segments, NUM_MB_SEGMENTS);
  int num_final_segments = 1;
  for (int s1 = 1; s1 < num_segments; ++s1) {
    const SegmentInfo* const S1 = &enc->dqm[s1];
    int found = 0, s2;
    for (s2 = 0; s2 < num_final_segments; ++s2) {
      const SegmentInfo* const S2 = &enc->dqm[s2];
      if (S1->quant == S2->quant && S1->fstrength == S2->fstrength) {
        found = 1;
        break;
      }
    }
    map[s1] = s2;
    if (!found) {
      if (num_final_segments != s1) enc->dqm[num_final_segments] = enc->dqm[s1];
      ++num_final_segments;
    }
  }
  if (num_final_segments < num_segments) {
    int i = enc->mb_w * enc->mb_h;
    while (i-- > 0) enc->mb_info[i].segment = (uint8_t)map[enc->mb_info[i].segment];
    enc->num_segments = num_final_segments;
    for (i = num_final_segments; i < num_segments; ++i) enc->dqm[i] = enc->dqm[num_final_segments - 1];
  }
}

void SetupMatrices(Encoder* enc) {
  const int tlambda_scale = (kMethod >= 4) ? kSnsStrength : 0;
  for (int i = 0; i < enc->num_segments; ++i) {
    SegmentInfo* const m = &enc->dqm[i];
    const int q = m->quant;
    m->y1.q[0] = kDcTable[clip(q + enc->dq_y1_dc, 0, 127)];
    m->y1.q[1] = kAcTable[clip(q, 0, 127)];
    m->y2.q[0] = kDcTable[clip(q + enc->dq_y2_dc, 0, 127)] * 2;
    m->y2.q[1] = std::max(8, kAcTable[clip(q + enc->dq_y2_ac, 0, 127)] * 155 / 100);
    m->uv.q[0] = kDcTable[clip(q + enc->dq_uv_dc, 0, 117)];
    m->uv.q[1] = kAcTable[clip(q + enc->dq_uv_ac, 0, 127)];

    const int q_i4 = ExpandMatrix(&m->y1, 0);
    const int q_i16 = ExpandMatrix(&m->y2, 1);
    const int q_uv = ExpandMatrix(&m->uv, 2);

    m->lambda_i4 = (3 * q_i4 * q_i4) >> 7;
    m->lambda_i16 = (3 * q_i16 * q_i16);
    m->lambda_uv = (3 * q_uv * q_uv) >> 6;
    m->lambda_mode = (1 * q_i4 * q_i4) >> 7;
    m->tlambda = (tlambda_scale * q_i4) >> 5;
    for (int* v : {&m->lambda_i4, &m->lambda_i16, &m->lambda_uv, &m->lambda_mode, &m->tlambda})
      if (*v < 1) *v = 1;
    m->min_disto = 20 * m->y1.q[0];
    m->max_edge = 0;
  }
}

void SetSegmentParams(Encoder* enc, float quality) {
  const int num_segments = enc->num_segments;
  const double amp = SNS_TO_DQ * kSnsStrength / 100. / 128.;
  const double Q = quality / 100.;
  const double c_base = QualityToCompression(Q);
  for (int i = 0; i < num_segments; ++i) {
    const double expn = 1. - amp * enc->dqm[i].alpha;
    const double c = pow(c_base, expn);
    const int q = (int)(127. * (1. - c));
    enc->dqm[i].quant = clip(q, 0, 127);
  }
  enc->base_quant = enc->dqm[0].quant;
  for (int i = num_segments; i < NUM_MB_SEGMENTS; ++i) enc->dqm[i].quant = enc->base_quant;

  int dq_uv_ac = (enc->uv_alpha - MID_ALPHA) * (MAX_DQ_UV - MIN_DQ_UV) / (MAX_ALPHA_UV - MIN_ALPHA);
  dq_uv_ac = dq_uv_ac * kSnsStrength / 100;
  dq_uv_ac = clip(dq_uv_ac, MIN_DQ_UV, MAX_DQ_UV);
  int dq_uv_dc = -4 * kSnsStrength / 100;
  dq_uv_dc = clip(dq_uv_dc, -15, 15);

  enc->dq_y1_dc = 0;
  enc->dq_y2_dc = 0;
  enc->dq_y2_ac = 0;
  enc->dq_uv_dc = dq_uv_dc;
  enc->dq_uv_ac = dq_uv_ac;

  SetupFilterStrength(enc);
  if (num_segments > 1) SimplifySegments(enc);
  SetupMatrices(enc);
}

int GetProba(int a, int b) {
  const int total = a + b;
  return (total == 0) ? 255 : (255 * a + total / 2) / total;
}

void SetSegmentProbas(Encoder* enc) {
  int p[NUM_MB_SEGMENTS] = {0};
  for (int n = 0; n < enc->mb_w * enc->mb_h; ++n) ++p[enc->mb_info[n].segment];
  if (enc->num_segments > 1) {
    uint8_t* const probas = enc->proba.segments;
    probas[0] = (uint8_t)GetProba(p[0] + p[1], p[2] + p[3]);
    probas[1] = (uint8_t)GetProba(p[0], p[1]);
    probas[2] = (uint8_t)GetProba(p[2], p[3]);
    enc->update_map = (probas[0] != 255) || (probas[1] != 255) || (probas[2] != 255);
    if (!enc->update_map) {
      for (int n = 0; n < enc->mb_w * enc->mb_h; ++n) enc->mb_info[n].segment = 0;
    }
  } else {
    enc->update_map = 0;
  }
}

void AdjustFilterStrength(Encoder* enc) {
  int max_level = 0;
  for (int s = 0; s < NUM_MB_SEGMENTS; s++) {
    SegmentInfo* const dqm = &enc->dqm[s];
    const int delta = (dqm->max_edge * dqm->y2.q[1]) >> 3;  // accounts for the inverse WHT
    const int level = FilterStrengthFromDelta(delta);
    if (level > dqm->fstrength) dqm->fstrength = level;
    if (max_level < dqm->fstrength) max_level = dqm->fstrength;
  }
  enc->filter_level = max_level;
}

// ---------------------------------------------------------------------------
// Level costs (cost_enc.c)

void CalculateLevelCosts(Proba* proba) {
  if (!proba->dirty) return;
  for (int ctype = 0; ctype < NUM_TYPES; ++ctype) {
    for (int band = 0; band < NUM_BANDS; ++band) {
      for (int ctx = 0; ctx < NUM_CTX; ++ctx) {
        const uint8_t* const p = proba->coeffs[ctype][band][ctx];
        uint16_t* const table = proba->level_cost[ctype][band][ctx];
        const int cost0 = (ctx > 0) ? BitCost(1, p[0]) : 0;
        const int cost_base = BitCost(1, p[1]) + cost0;
        table[0] = (uint16_t)(BitCost(0, p[1]) + cost0);
        for (int v = 1; v <= MAX_VARIABLE_LEVEL; ++v) {
          int pattern = kLevelCodes[v - 1][0];
          int bits = kLevelCodes[v - 1][1];
          int cost = 0;
          for (int i = 2; pattern; ++i) {
            if (pattern & 1) cost += BitCost(bits & 1, p[i]);
            bits >>= 1;
            pattern >>= 1;
          }
          table[v] = (uint16_t)(cost_base + cost);
        }
      }
    }
    for (int n = 0; n < 16; ++n)
      for (int ctx = 0; ctx < NUM_CTX; ++ctx)
        proba->remapped_costs[ctype][n][ctx] = proba->level_cost[ctype][kBands[n]][ctx];
  }
  proba->dirty = 0;
}

void InitResidual(int first, int coeff_type, Encoder* enc, Residual* res) {
  res->coeff_type = coeff_type;
  res->prob = enc->proba.coeffs[coeff_type];
  res->stats = enc->proba.stats[coeff_type];
  res->costs = enc->proba.remapped_costs[coeff_type];
  res->first = first;
}

void SetResidualCoeffs(const int16_t* coeffs, Residual* res) {
  res->last = -1;
  for (int n = 15; n >= 0; --n) {
    if (coeffs[n]) {
      res->last = n;
      break;
    }
  }
  res->coeffs = coeffs;
}

int GetResidualCost(int ctx0, const Residual* res) {
  int n = res->first;
  const int p0 = res->prob[n][ctx0][0];
  const uint16_t* t = res->costs[n][ctx0];
  int cost = (ctx0 == 0) ? BitCost(1, p0) : 0;
  if (res->last < 0) return BitCost(0, p0);
  for (; n < res->last; ++n) {
    const int v = abs(res->coeffs[n]);
    const int ctx = (v >= 2) ? 2 : v;
    cost += LevelCost(t, v);
    t = res->costs[n + 1][ctx];
  }
  {
    const int v = abs(res->coeffs[n]);
    cost += LevelCost(t, v);
    if (n < 15) {
      const int b = kBands[n + 1];
      const int ctx = (v == 1) ? 1 : 2;
      const int last_p0 = res->prob[b][ctx][0];
      cost += BitCost(0, last_p0);
    }
  }
  return cost;
}

int GetCostLuma4(Iterator* it, const int16_t levels[16]) {
  const int x = (it->i4 & 3), y = (it->i4 >> 2);
  Residual res;
  InitResidual(0, 3, it->enc, &res);
  const int ctx = it->top_nz[x] + it->left_nz[y];
  SetResidualCoeffs(levels, &res);
  return GetResidualCost(ctx, &res);
}

int GetCostLuma16(Iterator* it, const ModeScore* rd) {
  Residual res;
  int R = 0;
  IteratorNzToBytes(it);
  InitResidual(0, 1, it->enc, &res);
  SetResidualCoeffs(rd->y_dc_levels, &res);
  R += GetResidualCost(it->top_nz[8] + it->left_nz[8], &res);
  InitResidual(1, 0, it->enc, &res);
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int ctx = it->top_nz[x] + it->left_nz[y];
      SetResidualCoeffs(rd->y_ac_levels[x + y * 4], &res);
      R += GetResidualCost(ctx, &res);
      it->top_nz[x] = it->left_nz[y] = (res.last >= 0);
    }
  }
  return R;
}

int GetCostUV(Iterator* it, const ModeScore* rd) {
  Residual res;
  int R = 0;
  IteratorNzToBytes(it);
  InitResidual(0, 2, it->enc, &res);
  for (int ch = 0; ch <= 2; ch += 2) {
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int ctx = it->top_nz[4 + ch + x] + it->left_nz[4 + ch + y];
        SetResidualCoeffs(rd->uv_levels[ch * 2 + x + y * 2], &res);
        R += GetResidualCost(ctx, &res);
        it->top_nz[4 + ch + x] = it->left_nz[4 + ch + y] = (res.last >= 0);
      }
    }
  }
  return R;
}

// ---------------------------------------------------------------------------
// Mode decision (quant_enc.c, RD_OPT_BASIC)

const int FLATNESS_LIMIT_I16 = 0, FLATNESS_LIMIT_I4 = 3, FLATNESS_LIMIT_UV = 2;
const int FLATNESS_PENALTY = 140;
const int RD_DISTO_MULT = 256;
inline int MULT_8B(int a, int b) { return (a * b + 128) >> 8; }

bool IsFlat(const int16_t* levels, int num_blocks, int thresh) {
  int score = 0;
  while (num_blocks-- > 0) {
    for (int i = 1; i < 16; ++i) {  // AC only
      score += (levels[i] != 0);
      if (score > thresh) return false;
    }
    levels += 16;
  }
  return true;
}

bool IsFlatSource16(const uint8_t* src) {
  for (int i = 0; i < 16; ++i, src += BPS)
    for (int x = 0; x < 16; ++x)
      if (src[x] != src[-i * BPS]) return false;
  return true;
}

void InitScore(ModeScore* rd) {
  rd->D = rd->SD = rd->R = rd->H = 0;
  rd->nz = 0;
  rd->score = MAX_COST;
}
void CopyScore(ModeScore* dst, const ModeScore* src) {
  dst->D = src->D;
  dst->SD = src->SD;
  dst->R = src->R;
  dst->H = src->H;
  dst->nz = src->nz;
  dst->score = src->score;
}
void AddScore(ModeScore* dst, const ModeScore* src) {
  dst->D += src->D;
  dst->SD += src->SD;
  dst->R += src->R;
  dst->H += src->H;
  dst->nz |= src->nz;
  dst->score += src->score;
}
inline void SetRDScore(int lambda, ModeScore* rd) {
  rd->score = (rd->R + rd->H) * lambda + RD_DISTO_MULT * (rd->D + rd->SD);
}

int ReconstructIntra16(Iterator* it, ModeScore* rd, uint8_t* yuv_out, int mode) {
  const uint8_t* const ref = it->yuv_p + kI16ModeOffsets[mode];
  const uint8_t* const src = it->yuv_in + Y_OFF;
  const SegmentInfo* const dqm = &it->enc->dqm[it->mb->segment];
  int nz = 0;
  int16_t tmp[16][16], dc_tmp[16];
  for (int n = 0; n < 16; n += 2) FTransform2(src + kScan[n], ref + kScan[n], tmp[n]);
  FTransformWHT(tmp[0], dc_tmp);
  nz |= QuantizeBlock(dc_tmp, rd->y_dc_levels, &dqm->y2) << 24;
  for (int n = 0; n < 16; n += 2) {
    tmp[n][0] = tmp[n + 1][0] = 0;  // the DCs went to the WHT
    nz |= Quantize2Blocks(tmp[n], rd->y_ac_levels[n], &dqm->y1) << n;
  }
  TransformWHT(dc_tmp, tmp[0]);
  for (int n = 0; n < 16; n += 2) ITransform(ref + kScan[n], tmp[n], yuv_out + kScan[n], 1);
  return nz;
}

int ReconstructIntra4(Iterator* it, int16_t levels[16], const uint8_t* src, uint8_t* yuv_out, int mode) {
  const uint8_t* const ref = it->yuv_p + kI4ModeOffsets[mode];
  const SegmentInfo* const dqm = &it->enc->dqm[it->mb->segment];
  int16_t tmp[16];
  FTransform(src, ref, tmp);
  const int nz = QuantizeBlock(tmp, levels, &dqm->y1);
  ITransform(ref, tmp, yuv_out, 0);
  return nz;
}

// Chroma DC error diffusion: 7/16 of a block's DC error goes down, 8/16 right.
const int C1 = 7, C2 = 8, DSHIFT = 4, DSCALE = 1;

int QuantizeSingle(int16_t* v, const Matrix* mtx) {
  int V = *v;
  const int sign = (V < 0);
  if (sign) V = -V;
  if (V > (int)mtx->zthresh[0]) {
    const int qV = QUANTDIV(V, mtx->iq[0], mtx->bias[0]) * mtx->q[0];
    const int err = (V - qV);
    *v = (int16_t)(sign ? -qV : qV);
    return (sign ? -err : err) >> DSCALE;
  }
  *v = 0;
  return (sign ? -V : V) >> DSCALE;
}

void CorrectDCValues(const Iterator* it, const Matrix* mtx, int16_t tmp[][16], ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    const int8_t* const top = it->top_derr[it->x][ch];
    const int8_t* const left = it->left_derr[ch];
    int16_t(*const c)[16] = &tmp[ch * 4];
    int err0, err1, err2, err3;
    c[0][0] += (C1 * top[0] + C2 * left[0]) >> (DSHIFT - DSCALE);
    err0 = QuantizeSingle(&c[0][0], mtx);
    c[1][0] += (C1 * top[1] + C2 * err0) >> (DSHIFT - DSCALE);
    err1 = QuantizeSingle(&c[1][0], mtx);
    c[2][0] += (C1 * err0 + C2 * left[1]) >> (DSHIFT - DSCALE);
    err2 = QuantizeSingle(&c[2][0], mtx);
    c[3][0] += (C1 * err1 + C2 * err2) >> (DSHIFT - DSCALE);
    err3 = QuantizeSingle(&c[3][0], mtx);
    rd->derr[ch][0] = (int8_t)err1;
    rd->derr[ch][1] = (int8_t)err2;
    rd->derr[ch][2] = (int8_t)err3;
  }
}

void StoreDiffusionErrors(Iterator* it, const ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    int8_t* const top = it->top_derr[it->x][ch];
    int8_t* const left = it->left_derr[ch];
    left[0] = rd->derr[ch][0];
    left[1] = (int8_t)(3 * rd->derr[ch][2] >> 2);
    top[0] = rd->derr[ch][1];
    top[1] = (int8_t)(rd->derr[ch][2] - left[1]);
  }
}

int ReconstructUV(Iterator* it, ModeScore* rd, uint8_t* yuv_out, int mode) {
  const uint8_t* const ref = it->yuv_p + kUVModeOffsets[mode];
  const uint8_t* const src = it->yuv_in + U_OFF;
  const SegmentInfo* const dqm = &it->enc->dqm[it->mb->segment];
  int nz = 0;
  int16_t tmp[8][16];
  for (int n = 0; n < 8; n += 2) FTransform2(src + kScanUV[n], ref + kScanUV[n], tmp[n]);
  CorrectDCValues(it, &dqm->uv, tmp, rd);
  for (int n = 0; n < 8; n += 2) nz |= Quantize2Blocks(tmp[n], rd->uv_levels[n], &dqm->uv) << n;
  for (int n = 0; n < 8; n += 2) ITransform(ref + kScanUV[n], tmp[n], yuv_out + kScanUV[n], 1);
  return nz << 16;
}

void StoreMaxDelta(SegmentInfo* dqm, const int16_t DCs[16]) {
  const int v0 = abs(DCs[1]), v1 = abs(DCs[2]), v2 = abs(DCs[4]);
  int max_v = (v1 > v0) ? v1 : v0;
  max_v = (v2 > max_v) ? v2 : max_v;
  if (max_v > dqm->max_edge) dqm->max_edge = max_v;
}

void PickBestIntra16(Iterator* it, ModeScore* rd) {
  const int kNumBlocks = 16;
  SegmentInfo* const dqm = &it->enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_i16;
  const int tlambda = dqm->tlambda;
  const uint8_t* const src = it->yuv_in + Y_OFF;
  ModeScore rd_tmp;
  ModeScore* rd_cur = &rd_tmp;
  ModeScore* rd_best = rd;
  bool is_flat = IsFlatSource16(it->yuv_in + Y_OFF);

  rd->mode_i16 = -1;
  for (int mode = 0; mode < 4; ++mode) {
    uint8_t* const tmp_dst = it->yuv_out2 + Y_OFF;
    rd_cur->mode_i16 = mode;
    rd_cur->nz = ReconstructIntra16(it, rd_cur, tmp_dst, mode);
    rd_cur->D = GetSSE(src, tmp_dst, 16, 16);
    rd_cur->SD = tlambda ? MULT_8B(tlambda, Disto16x16(src, tmp_dst, kWeightY)) : 0;
    rd_cur->H = kFixedCostsI16[mode];
    rd_cur->R = GetCostLuma16(it, rd_cur);
    if (is_flat) {
      is_flat = IsFlat(rd_cur->y_ac_levels[0], kNumBlocks, FLATNESS_LIMIT_I16);
      if (is_flat) {
        rd_cur->D *= 2;
        rd_cur->SD *= 2;
      }
    }
    SetRDScore(lambda, rd_cur);
    if (mode == 0 || rd_cur->score < rd_best->score) {
      std::swap(rd_cur, rd_best);
      std::swap(it->yuv_out, it->yuv_out2);
    }
  }
  if (rd_best != rd) memcpy(rd, rd_best, sizeof(*rd));
  SetRDScore(dqm->lambda_mode, rd);
  SetIntra16Mode(it, rd->mode_i16);
  // a blocky macroblock (only DCs) with a fair distortion: remember its
  // largest DC step for the filter strength
  if ((rd->nz & 0x100ffff) == 0x1000000 && rd->D > dqm->min_disto) StoreMaxDelta(dqm, rd->y_dc_levels);
}

const uint16_t* GetCostModeI4(Iterator* it, const uint8_t modes[16]) {
  const int preds_w = it->enc->preds_w;
  const int x = (it->i4 & 3), y = it->i4 >> 2;
  const int left = (x == 0) ? it->preds[y * preds_w - 1] : modes[it->i4 - 1];
  const int top = (y == 0) ? it->preds[-preds_w + x] : modes[it->i4 - 4];
  return kFixedCostsI4[top][left];
}

int PickBestIntra4(Iterator* it, ModeScore* rd) {
  const Encoder* const enc = it->enc;
  const SegmentInfo* const dqm = &enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_i4;
  const int tlambda = dqm->tlambda;
  const uint8_t* const src0 = it->yuv_in + Y_OFF;
  uint8_t* const best_blocks = it->yuv_out2 + Y_OFF;
  int total_header_bits = 0;
  ModeScore rd_best;

  if (enc->max_i4_header_bits == 0) return 0;

  InitScore(&rd_best);
  rd_best.H = 211;  // BitCost(0, 145): the intra-4 flag
  SetRDScore(dqm->lambda_mode, &rd_best);
  IteratorStartI4(it);
  do {
    const int kNumBlocks = 1;
    ModeScore rd_i4;
    int best_mode = -1;
    const uint8_t* const src = src0 + kScan[it->i4];
    const uint16_t* const mode_costs = GetCostModeI4(it, rd->modes_i4);
    uint8_t* best_block = best_blocks + kScan[it->i4];
    uint8_t* tmp_dst = it->yuv_p + I4TMP;

    InitScore(&rd_i4);
    Intra4Preds(it->yuv_p, it->i4_top);
    for (int mode = 0; mode < 10; ++mode) {
      ModeScore rd_tmp;
      int16_t tmp_levels[16];
      rd_tmp.nz = ReconstructIntra4(it, tmp_levels, src, tmp_dst, mode) << it->i4;
      rd_tmp.D = GetSSE(src, tmp_dst, 4, 4);
      rd_tmp.SD = tlambda ? MULT_8B(tlambda, Disto4x4(src, tmp_dst, kWeightY)) : 0;
      rd_tmp.H = mode_costs[mode];
      if (mode > 0 && IsFlat(tmp_levels, kNumBlocks, FLATNESS_LIMIT_I4)) {
        rd_tmp.R = FLATNESS_PENALTY * kNumBlocks;
      } else {
        rd_tmp.R = 0;
      }
      SetRDScore(lambda, &rd_tmp);
      if (best_mode >= 0 && rd_tmp.score >= rd_i4.score) continue;  // early out
      rd_tmp.R += GetCostLuma4(it, tmp_levels);
      SetRDScore(lambda, &rd_tmp);
      if (best_mode < 0 || rd_tmp.score < rd_i4.score) {
        CopyScore(&rd_i4, &rd_tmp);
        best_mode = mode;
        std::swap(tmp_dst, best_block);
        memcpy(rd_best.y_ac_levels[it->i4], tmp_levels, sizeof(rd_best.y_ac_levels[it->i4]));
      }
    }
    SetRDScore(dqm->lambda_mode, &rd_i4);
    AddScore(&rd_best, &rd_i4);
    if (rd_best.score >= rd->score) return 0;
    total_header_bits += (int)rd_i4.H;
    if (total_header_bits > enc->max_i4_header_bits) return 0;
    if (best_block != best_blocks + kScan[it->i4]) {
      for (int j = 0; j < 4; ++j) memcpy(best_blocks + kScan[it->i4] + j * BPS, best_block + j * BPS, 4);
    }
    rd->modes_i4[it->i4] = (uint8_t)best_mode;
    it->top_nz[it->i4 & 3] = it->left_nz[it->i4 >> 2] = (rd_i4.nz ? 1 : 0);
  } while (IteratorRotateI4(it, best_blocks));

  CopyScore(rd, &rd_best);
  SetIntra4Mode(it, rd->modes_i4);
  std::swap(it->yuv_out, it->yuv_out2);
  memcpy(rd->y_ac_levels, rd_best.y_ac_levels, sizeof(rd->y_ac_levels));
  return 1;
}

void PickBestUV(Iterator* it, ModeScore* rd) {
  const int kNumBlocks = 8;
  const SegmentInfo* const dqm = &it->enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_uv;
  const uint8_t* const src = it->yuv_in + U_OFF;
  uint8_t* tmp_dst = it->yuv_out2 + U_OFF;
  uint8_t* dst0 = it->yuv_out + U_OFF;
  uint8_t* dst = dst0;
  ModeScore rd_best;

  rd->mode_uv = -1;
  InitScore(&rd_best);
  for (int mode = 0; mode < 4; ++mode) {
    ModeScore rd_uv;
    rd_uv.nz = ReconstructUV(it, &rd_uv, tmp_dst, mode);
    rd_uv.D = GetSSE(src, tmp_dst, 16, 8);
    rd_uv.SD = 0;  // no texture distortion: it flattens chroma
    rd_uv.H = kFixedCostsUV[mode];
    rd_uv.R = GetCostUV(it, &rd_uv);
    if (mode > 0 && IsFlat(rd_uv.uv_levels[0], kNumBlocks, FLATNESS_LIMIT_UV)) {
      rd_uv.R += FLATNESS_PENALTY * kNumBlocks;
    }
    SetRDScore(lambda, &rd_uv);
    if (mode == 0 || rd_uv.score < rd_best.score) {
      CopyScore(&rd_best, &rd_uv);
      rd->mode_uv = mode;
      memcpy(rd->uv_levels, rd_uv.uv_levels, sizeof(rd->uv_levels));
      memcpy(rd->derr, rd_uv.derr, sizeof(rd_uv.derr));
      std::swap(dst, tmp_dst);
    }
  }
  it->mb->uv_mode = (uint8_t)rd->mode_uv;
  AddScore(rd, &rd_best);
  if (dst != dst0) {
    for (int j = 0; j < 8; ++j) memcpy(dst0 + j * BPS, dst + j * BPS, 16);
  }
  StoreDiffusionErrors(it, rd);
}

// The macroblock's modes and levels. No macroblock is skipped: the token
// loop codes every one, and the frame has no skip probability.
void Decimate(Iterator* it, ModeScore* rd) {
  InitScore(rd);
  MakeLuma16Preds(it);
  MakeChroma8Preds(it);
  PickBestIntra16(it, rd);
  PickBestIntra4(it, rd);  // method >= 2
  PickBestUV(it, rd);
}

// ---------------------------------------------------------------------------
// Tokens (token_enc.c) and probabilities (frame_enc.c)

const uint32_t FIXED_PROBA_BIT = 1u << 14;

inline int TOKEN_ID(int t, int b, int ctx) { return NUM_PROBAS * (ctx + NUM_CTX * (b + NUM_BANDS * t)); }

inline int RecordStats(int bit, uint32_t* stats) {
  uint32_t p = *stats;
  if (p >= 0xfffe0000u) p = ((p + 1u) >> 1) & 0x7fff7fffu;  // halve before an overflow
  p += 0x00010000u + bit;
  *stats = p;
  return bit;
}

inline uint32_t AddToken(std::vector<uint16_t>& b, uint32_t bit, uint32_t proba_idx, uint32_t* stats) {
  b.push_back((uint16_t)((bit << 15) | proba_idx));
  RecordStats(bit, stats);
  return bit;
}

inline void AddConstantToken(std::vector<uint16_t>& b, uint32_t value, uint32_t proba) {
  b.push_back((uint16_t)((value << 15) | FIXED_PROBA_BIT | proba));
}

int RecordCoeffTokens(int ctx, const Residual* res, std::vector<uint16_t>& tokens) {
  const int16_t* const coeffs = res->coeffs;
  const int coeff_type = res->coeff_type;
  const int last = res->last;
  int n = res->first;
  uint32_t base_id = TOKEN_ID(coeff_type, n, ctx);
  uint32_t* s = res->stats[n][ctx];
  if (!AddToken(tokens, last >= 0, base_id + 0, s + 0)) return 0;

  while (n < 16) {
    const int c = coeffs[n++];
    const int sign = c < 0;
    const uint32_t v = sign ? -c : c;
    if (!AddToken(tokens, v != 0, base_id + 1, s + 1)) {
      base_id = TOKEN_ID(coeff_type, kBands[n], 0);
      s = res->stats[kBands[n]][0];
      continue;
    }
    if (!AddToken(tokens, v > 1, base_id + 2, s + 2)) {
      base_id = TOKEN_ID(coeff_type, kBands[n], 1);
      s = res->stats[kBands[n]][1];
    } else {
      if (!AddToken(tokens, v > 4, base_id + 3, s + 3)) {
        if (AddToken(tokens, v != 2, base_id + 4, s + 4)) AddToken(tokens, v == 4, base_id + 5, s + 5);
      } else if (!AddToken(tokens, v > 10, base_id + 6, s + 6)) {
        if (!AddToken(tokens, v > 6, base_id + 7, s + 7)) {
          AddConstantToken(tokens, v == 6, 159);
        } else {
          AddConstantToken(tokens, v >= 9, 165);
          AddConstantToken(tokens, !(v & 1), 145);
        }
      } else {
        int mask;
        const uint8_t* tab;
        uint32_t residue = v - 3;
        if (residue < (8 << 1)) {  // cat 3
          AddToken(tokens, 0, base_id + 8, s + 8);
          AddToken(tokens, 0, base_id + 9, s + 9);
          residue -= (8 << 0);
          mask = 1 << 2;
          tab = kCat3;
        } else if (residue < (8 << 2)) {  // cat 4
          AddToken(tokens, 0, base_id + 8, s + 8);
          AddToken(tokens, 1, base_id + 9, s + 9);
          residue -= (8 << 1);
          mask = 1 << 3;
          tab = kCat4;
        } else if (residue < (8 << 3)) {  // cat 5
          AddToken(tokens, 1, base_id + 8, s + 8);
          AddToken(tokens, 0, base_id + 10, s + 9);  // libwebp counts p[10]'s bit in p[9]'s stats
          residue -= (8 << 2);
          mask = 1 << 4;
          tab = kCat5;
        } else {  // cat 6
          AddToken(tokens, 1, base_id + 8, s + 8);
          AddToken(tokens, 1, base_id + 10, s + 9);
          residue -= (8 << 3);
          mask = 1 << 10;
          tab = kCat6;
        }
        while (mask) {
          AddConstantToken(tokens, !!(residue & mask), *tab++);
          mask >>= 1;
        }
      }
      base_id = TOKEN_ID(coeff_type, kBands[n], 2);
      s = res->stats[kBands[n]][2];
    }
    AddConstantToken(tokens, sign, 128);
    if (n == 16 || !AddToken(tokens, n <= last, base_id + 0, s + 0)) return 1;  // EOB
  }
  return 1;
}

void RecordTokens(Iterator* it, const ModeScore* rd, std::vector<uint16_t>& tokens) {
  Residual res;
  Encoder* const enc = it->enc;
  IteratorNzToBytes(it);
  if (it->mb->type == 1) {  // i16x16
    const int ctx = it->top_nz[8] + it->left_nz[8];
    InitResidual(0, 1, enc, &res);
    SetResidualCoeffs(rd->y_dc_levels, &res);
    it->top_nz[8] = it->left_nz[8] = RecordCoeffTokens(ctx, &res, tokens);
    InitResidual(1, 0, enc, &res);
  } else {
    InitResidual(0, 3, enc, &res);
  }
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int ctx = it->top_nz[x] + it->left_nz[y];
      SetResidualCoeffs(rd->y_ac_levels[x + y * 4], &res);
      it->top_nz[x] = it->left_nz[y] = RecordCoeffTokens(ctx, &res, tokens);
    }
  }
  InitResidual(0, 2, enc, &res);
  for (int ch = 0; ch <= 2; ch += 2) {
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int ctx = it->top_nz[4 + ch + x] + it->left_nz[4 + ch + y];
        SetResidualCoeffs(rd->uv_levels[ch * 2 + x + y * 2], &res);
        it->top_nz[4 + ch + x] = it->left_nz[4 + ch + y] = RecordCoeffTokens(ctx, &res, tokens);
      }
    }
  }
  IteratorBytesToNz(it);
}

int CalcTokenProba(int nb, int total) { return nb ? (255 - nb * 255 / total) : 255; }

int BranchCost(int nb, int total, int proba) {
  return nb * BitCost(1, proba) + (total - nb) * BitCost(0, proba);
}

// New probabilities where an update pays for itself.
void FinalizeTokenProbas(Proba* proba) {
  int has_changed = 0;
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const uint32_t stats = proba->stats[t][b][c][p];
          const int nb = (stats >> 0) & 0xffff;
          const int total = (stats >> 16) & 0xffff;
          const int update_proba = kCoeffsUpdateProba[t][b][c][p];
          const int old_p = kCoeffsProba0[t][b][c][p];
          const int new_p = CalcTokenProba(nb, total);
          const int old_cost = BranchCost(nb, total, old_p) + BitCost(0, update_proba);
          const int new_cost = BranchCost(nb, total, new_p) + BitCost(1, update_proba) + 8 * 256;
          const int use_new_p = (old_cost > new_cost);
          if (use_new_p) {
            proba->coeffs[t][b][c][p] = (uint8_t)new_p;
            has_changed |= (new_p != old_p);
          } else {
            proba->coeffs[t][b][c][p] = (uint8_t)old_p;
          }
        }
  proba->dirty = has_changed;
}

const int MIN_COUNT = 96;  // macroblocks between two probability refreshes, at least

void TokenLoop(Encoder* enc) {
  int max_count = (enc->mb_w * enc->mb_h) >> 3;
  if (max_count < MIN_COUNT) max_count = MIN_COUNT;
  Proba* const proba = &enc->proba;
  Iterator it;
  IteratorInit(enc, &it);
  // SetLoopParams
  SetSegmentParams(enc, kQuality);
  SetSegmentProbas(enc);
  CalculateLevelCosts(proba);
  memset(proba->stats, 0, sizeof(proba->stats));
  enc->tokens.clear();
  int cnt = max_count;
  do {
    ModeScore info;
    IteratorImport(&it, nullptr);
    if (--cnt < 0) {
      FinalizeTokenProbas(proba);
      CalculateLevelCosts(proba);
      cnt = max_count;
    }
    Decimate(&it, &info);
    RecordTokens(&it, &info, enc->tokens);
    IteratorSaveBoundary(&it);
  } while (IteratorNext(&it));
  FinalizeTokenProbas(proba);
  for (uint16_t token : enc->tokens) {
    const int bit = (token >> 15) & 1;
    if (token & FIXED_PROBA_BIT) enc->part.PutBit(bit, token & 0x3fffu);
    else enc->part.PutBit(bit, (&proba->coeffs[0][0][0][0])[token & 0x3fffu]);
  }
  enc->part.Finish();
  AdjustFilterStrength(enc);
}

// ---------------------------------------------------------------------------
// Partition 0 (syntax_enc.c, tree_enc.c)

void PutSegmentHeader(BitWriter* bw, const Encoder* enc) {
  if (bw->PutBitUniform(enc->num_segments > 1)) {
    bw->PutBitUniform(enc->update_map);
    if (bw->PutBitUniform(1)) {  // update the segment data, as absolute values
      bw->PutBitUniform(1);
      for (int s = 0; s < NUM_MB_SEGMENTS; ++s) bw->PutSignedBits(enc->dqm[s].quant, 7);
      for (int s = 0; s < NUM_MB_SEGMENTS; ++s) bw->PutSignedBits(enc->dqm[s].fstrength, 6);
    }
    if (enc->update_map) {
      for (int s = 0; s < 3; ++s) {
        if (bw->PutBitUniform(enc->proba.segments[s] != 255u)) bw->PutBits(enc->proba.segments[s], 8);
      }
    }
  }
}

void PutFilterHeader(BitWriter* bw, const Encoder* enc) {
  bw->PutBitUniform(enc->filter_simple);
  bw->PutBits(enc->filter_level, 6);
  bw->PutBits(enc->filter_sharpness, 3);
  bw->PutBitUniform(0);  // no loop-filter deltas
}

void PutQuant(BitWriter* bw, const Encoder* enc) {
  bw->PutBits(enc->base_quant, 7);
  bw->PutSignedBits(enc->dq_y1_dc, 4);
  bw->PutSignedBits(enc->dq_y2_dc, 4);
  bw->PutSignedBits(enc->dq_y2_ac, 4);
  bw->PutSignedBits(enc->dq_uv_dc, 4);
  bw->PutSignedBits(enc->dq_uv_ac, 4);
}

void WriteProbas(BitWriter* bw, const Proba* probas) {
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const uint8_t p0 = probas->coeffs[t][b][c][p];
          const int update = (p0 != kCoeffsProba0[t][b][c][p]);
          if (bw->PutBit(update, kCoeffsUpdateProba[t][b][c][p])) bw->PutBits(p0, 8);
        }
  bw->PutBitUniform(0);  // no skip probability
}

int PutI4Mode(BitWriter* bw, int mode, const uint8_t* prob) {
  if (bw->PutBit(mode != B_DC_PRED, prob[0])) {
    if (bw->PutBit(mode != B_TM_PRED, prob[1])) {
      if (bw->PutBit(mode != B_VE_PRED, prob[2])) {
        if (!bw->PutBit(mode >= B_LD_PRED, prob[3])) {
          if (bw->PutBit(mode != B_HE_PRED, prob[4])) bw->PutBit(mode != B_RD_PRED, prob[5]);
        } else {
          if (bw->PutBit(mode != B_LD_PRED, prob[6])) {
            if (bw->PutBit(mode != B_VL_PRED, prob[7])) bw->PutBit(mode != B_HD_PRED, prob[8]);
          }
        }
      }
    }
  }
  return mode;
}

void CodeIntraModes(Encoder* enc) {
  BitWriter* const bw = &enc->bw;
  Iterator it;
  IteratorInit(enc, &it);
  do {
    const MBInfo* const mb = it.mb;
    const uint8_t* preds = it.preds;
    if (enc->update_map) {
      const int s = mb->segment;
      const uint8_t* p = enc->proba.segments;
      if (bw->PutBit(s >= 2, p[0])) p += 1;
      bw->PutBit(s & 1, p[1]);
    }
    if (bw->PutBit(mb->type != 0, 145)) {  // i16x16
      const int mode = preds[0];
      if (bw->PutBit(mode == TM_PRED || mode == H_PRED, 156)) bw->PutBit(mode == TM_PRED, 128);
      else bw->PutBit(mode == V_PRED, 163);
    } else {
      const uint8_t* top_pred = preds - enc->preds_w;
      for (int y = 0; y < 4; ++y) {
        int left = preds[-1];
        for (int x = 0; x < 4; ++x) left = PutI4Mode(bw, preds[x], kBModesProba[top_pred[x]][left]);
        top_pred = preds;
        preds += enc->preds_w;
      }
    }
    const int uv_mode = mb->uv_mode;
    if (bw->PutBit(uv_mode != DC_PRED, 142)) {
      if (bw->PutBit(uv_mode != V_PRED, 114)) bw->PutBit(uv_mode != H_PRED, 183);
    }
  } while (IteratorNext(&it));
}

void GeneratePartition0(Encoder* enc) {
  BitWriter* const bw = &enc->bw;
  bw->PutBitUniform(0);  // colorspace
  bw->PutBitUniform(0);  // clamp type
  PutSegmentHeader(bw, enc);
  PutFilterHeader(bw, enc);
  bw->PutBits(0, 2);  // one token partition
  PutQuant(bw, enc);
  bw->PutBitUniform(0);  // no proba update
  WriteProbas(bw, &enc->proba);
  CodeIntraModes(enc);
  bw->Finish();
}

inline void PutLE32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = v >> 24;
}

// The VP8 chunk's payload (frame header, partition 0, the token partition).
std::vector<uint8_t> EncodeVP8(const Picture& pic) {
  std::call_once(tables_once, [] {
    InitCostTables();
    InitGammaTables();
  });
  std::unique_ptr<Encoder> holder(new Encoder());
  Encoder* const enc = holder.get();
  enc->pic = &pic;
  enc->mb_w = (pic.width + 15) >> 4;
  enc->mb_h = (pic.height + 15) >> 4;
  enc->preds_w = 4 * enc->mb_w + 1;
  const int preds_h = 4 * enc->mb_h + 1;
  enc->preds_mem.assign((size_t)enc->preds_w * preds_h, 0);
  enc->preds = enc->preds_mem.data() + 1 + enc->preds_w;
  enc->nz_mem.assign(enc->mb_w + 1, 0);
  enc->nz = enc->nz_mem.data() + 1;
  enc->top_mem.assign((size_t)2 * enc->mb_w * 16, 0);
  enc->y_top = enc->top_mem.data();
  enc->uv_top = enc->y_top + enc->mb_w * 16;
  enc->top_derr_mem.assign((size_t)enc->mb_w * sizeof(DError), 0);
  enc->top_derr = reinterpret_cast<DError*>(enc->top_derr_mem.data());
  enc->mb_info.assign((size_t)enc->mb_w * enc->mb_h, MBInfo{1, 0, 0, 0});
  enc->profile = 0;  // the normal loop filter
  enc->max_i4_header_bits = 256 * 16 * 16;  // partition_limit 0
  // default probabilities
  memset(enc->proba.segments, 255u, sizeof(enc->proba.segments));
  memcpy(enc->proba.coeffs, kCoeffsProba0, sizeof(kCoeffsProba0));
  enc->proba.dirty = 1;
  enc->num_segments = kSegments;
  enc->update_map = kSegments > 1;
  enc->filter_simple = 1;
  enc->filter_level = 0;
  enc->filter_sharpness = 0;
  // the boundary's intra-4 modes are DC
  for (int i = -1; i < 4 * enc->mb_w; ++i) enc->preds[i - enc->preds_w] = B_DC_PRED;
  for (int i = 0; i < 4 * enc->mb_h; ++i) enc->preds[i * enc->preds_w - 1] = B_DC_PRED;
  enc->nz[-1] = 0;

  Analyze(enc);
  TokenLoop(enc);
  GeneratePartition0(enc);

  const size_t size0 = enc->bw.buf.size();
  if (size0 >= (1u << 19)) throw Error(SL_UNSUPPORTED, "encoding error 6: Partition #0 is too big to fit 512k");
  std::vector<uint8_t> out(10);
  const uint32_t bits = 0 | (enc->profile << 1) | (1 << 4) | ((uint32_t)size0 << 5);
  out[0] = bits & 0xff;
  out[1] = (bits >> 8) & 0xff;
  out[2] = (bits >> 16) & 0xff;
  out[3] = 0x9d;
  out[4] = 0x01;
  out[5] = 0x2a;
  out[6] = pic.width & 0xff;
  out[7] = pic.width >> 8;
  out[8] = pic.height & 0xff;
  out[9] = pic.height >> 8;
  out.insert(out.end(), enc->bw.buf.begin(), enc->bw.buf.end());
  out.insert(out.end(), enc->part.buf.begin(), enc->part.buf.end());
  return out;
}

// ===========================================================================
// The alpha plane (alpha_enc.c, utils/filters_utils.c)
// ===========================================================================

enum { FILTER_NONE = 0, FILTER_HORIZONTAL, FILTER_VERTICAL, FILTER_GRADIENT, FILTER_LAST };

inline int GradientPredictor(int a, int b, int c) {
  const int g = a + b - c;
  return ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
}

// libwebp's quick guess at the filter: the spread of the residuals of every
// other sample of every other row, under each filter.
int EstimateBestFilter(const uint8_t* data, int width, int height) {
  const int SMAX = 16;
  int bins[FILTER_LAST][SMAX];
  memset(bins, 0, sizeof(bins));
  for (int j = 2; j < height - 1; j += 2) {
    const uint8_t* const p = data + j * width;
    int mean = p[0];
    for (int i = 2; i < width - 1; i += 2) {
      const int diff0 = abs(p[i] - mean) >> 4;
      const int diff1 = abs(p[i] - p[i - 1]) >> 4;
      const int diff2 = abs(p[i] - p[i - width]) >> 4;
      const int grad_pred = GradientPredictor(p[i - 1], p[i - width], p[i - width - 1]);
      const int diff3 = abs(p[i] - grad_pred) >> 4;
      bins[FILTER_NONE][diff0] = 1;
      bins[FILTER_HORIZONTAL][diff1] = 1;
      bins[FILTER_VERTICAL][diff2] = 1;
      bins[FILTER_GRADIENT][diff3] = 1;
      mean = (3 * mean + p[i] + 2) >> 2;
    }
  }
  int best_filter = FILTER_NONE, best_score = 0x7fffffff;
  for (int filter = FILTER_NONE; filter < FILTER_LAST; ++filter) {
    int score = 0;
    for (int i = 0; i < SMAX; ++i)
      if (bins[filter][i] > 0) score += i;
    if (score < best_score) {
      best_score = score;
      best_filter = filter;
    }
  }
  return best_filter;
}

int NumColors(const uint8_t* data, size_t n) {
  uint8_t color[256] = {0};
  for (size_t i = 0; i < n; ++i) color[data[i]] = 1;
  int colors = 0;
  for (int j = 0; j < 256; ++j) colors += color[j];
  return colors;
}

// The filter libwebp's fast mode tries beside no filter (GetFilterMap: at
// effort 4 it always tries no filter too).
int EstimateFilter(const uint8_t* alpha, int width, int height) {
  const int kMinColorsForFilterNone = 16;
  const int num_colors = NumColors(alpha, (size_t)width * height);
  return (num_colors <= kMinColorsForFilterNone) ? FILTER_NONE : EstimateBestFilter(alpha, width, height);
}

// The forward filters (the spec's prediction of each sample).
void ApplyFilter(const uint8_t* in, int width, int height, int filter, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* const row = in + (size_t)y * width;
    const uint8_t* const up = row - width;
    uint8_t* const dst = out + (size_t)y * width;
    for (int x = 0; x < width; ++x) {
      int pred;
      if (x == 0 && y == 0) pred = 0;
      else if (y == 0) pred = row[x - 1];
      else if (x == 0) pred = up[0];
      else if (filter == FILTER_HORIZONTAL) pred = row[x - 1];
      else if (filter == FILTER_VERTICAL) pred = up[x];
      else pred = GradientPredictor(row[x - 1], up[x], up[x - 1]);
      dst[x] = (uint8_t)(row[x] - pred);
    }
  }
}

// The ALPH payload (alpha_enc.c: GetFilterMap, ApplyFiltersAndEncode,
// EncodeAlphaInternal): its header byte (compression, filter), then the
// VP8L stream of the filtered plane (libwebp's own, sl_vp8l_enc.cpp), or the
// plane itself where the stream is larger. At effort 4 libwebp tries no
// filter and then, where the estimate is another, that filter, and keeps
// the first of the smallest.
std::vector<uint8_t> EncodeAlphaTrial(const uint8_t* alpha, int width, int height, int filter,
                                      uint8_t* filtered) {
  const size_t data_size = (size_t)width * height;
  const uint8_t* src = alpha;
  if (filter != FILTER_NONE) {
    ApplyFilter(alpha, width, height, filter, filtered);
    src = filtered;
  }
  std::vector<uint8_t> stream = SlVp8lEncodePlane(src, width, height);
  int method = 1;
  if (stream.size() > data_size) {  // larger than the plane: store it raw
    method = 0;
    stream.assign(src, src + data_size);
  }
  std::vector<uint8_t> out;
  out.reserve(1 + stream.size());
  out.push_back((uint8_t)(method | (filter << 2)));
  out.insert(out.end(), stream.begin(), stream.end());
  return out;
}

std::vector<uint8_t> EncodeAlpha(const uint8_t* alpha, int width, int height) {
  const int estimate = EstimateFilter(alpha, width, height);
  std::vector<uint8_t> filtered((size_t)width * height);
  std::vector<uint8_t> best = EncodeAlphaTrial(alpha, width, height, FILTER_NONE, filtered.data());
  if (estimate != FILTER_NONE) {
    std::vector<uint8_t> trial = EncodeAlphaTrial(alpha, width, height, estimate, filtered.data());
    if (trial.size() < best.size()) best.swap(trial);
  }
  return best;
}

// The whole file: RIFF, then VP8X and ALPH where there is transparency.
std::vector<uint8_t> EncodeWebP(const uint8_t* pixels, int width, int height, int channels) {
  if (width <= 0 || height <= 0 || width > 16383 || height > 16383)
    throw Error(SL_UNSUPPORTED, "encoding error 5: Image size exceeds WebP limit of 16383 pixels");
  std::call_once(tables_once, [] {
    InitCostTables();
    InitGammaTables();
  });
  Picture pic = ImportRGBA(pixels, width, height, channels);
  CleanupTransparentArea(pic);
  std::vector<uint8_t> alpha;
  if (!pic.a.empty()) alpha = EncodeAlpha(pic.a.data(), width, height);
  std::vector<uint8_t> vp8 = EncodeVP8(pic);
  const size_t pad = vp8.size() & 1;
  const size_t vp8_size = vp8.size() + pad;
  size_t riff_size = 4 + 8 + vp8_size;
  if (!pic.a.empty()) riff_size += (8 + 10) + 8 + alpha.size() + (alpha.size() & 1);
  if (riff_size > 0xfffffffeU) throw Error(SL_UNSUPPORTED, "encoding error 9: File is bigger than 4G");
  std::vector<uint8_t> out;
  out.reserve(8 + riff_size);
  auto put32 = [&out](uint32_t v) {
    uint8_t b[4];
    PutLE32(b, v);
    out.insert(out.end(), b, b + 4);
  };
  auto tag = [&out](const char* t) { out.insert(out.end(), t, t + 4); };
  tag("RIFF");
  put32((uint32_t)riff_size);
  tag("WEBP");
  if (!pic.a.empty()) {
    tag("VP8X");
    put32(10);
    put32(0x10);  // the alpha flag; then the canvas' sides minus one, 24 bits each
    out.push_back((width - 1) & 0xff);
    out.push_back(((width - 1) >> 8) & 0xff);
    out.push_back(((width - 1) >> 16) & 0xff);
    out.push_back((height - 1) & 0xff);
    out.push_back(((height - 1) >> 8) & 0xff);
    out.push_back(((height - 1) >> 16) & 0xff);
    tag("ALPH");
    put32((uint32_t)alpha.size());
    out.insert(out.end(), alpha.begin(), alpha.end());
    if (alpha.size() & 1) out.push_back(0);
  }
  tag("VP8 ");
  put32((uint32_t)vp8_size);
  out.insert(out.end(), vp8.begin(), vp8.end());
  if (pad) out.push_back(0);
  return out;
}

int fail(const Error& e, char* err, int errlen) {
  snprintf(err, errlen, "%s", e.what());
  return e.code;
}

}  // namespace

extern "C" {

int sl_webp_encode(const uint8_t* pixels, int width, int height, int channels, uint8_t** out,
                   size_t* out_size, char* err, int errlen) {
  try {
    if (channels != 3 && channels != 4) throw Error(SL_UNSUPPORTED, "channels must be 3 or 4");
    std::vector<uint8_t> data = EncodeWebP(pixels, width, height, channels);
    uint8_t* buf = (uint8_t*)malloc(data.size());
    if (buf == nullptr) throw Error(SL_NO_ROOM, "out of memory");
    memcpy(buf, data.data(), data.size());
    *out = buf;
    *out_size = data.size();
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_NO_ROOM, "out of memory"), err, errlen);
  }
}

void sl_webp_enc_free(uint8_t* p) { free(p); }

int sl_webp_enc_planes(const uint8_t* pixels, int width, int height, int channels, int cleanup,
                       uint8_t* y, uint8_t* u, uint8_t* v, uint8_t* a, int* has_alpha) {
  std::call_once(tables_once, [] {
    InitCostTables();
    InitGammaTables();
  });
  Picture pic = ImportRGBA(pixels, width, height, channels);
  if (cleanup) CleanupTransparentArea(pic);
  memcpy(y, pic.y.data(), pic.y.size());
  memcpy(u, pic.u.data(), pic.u.size());
  memcpy(v, pic.v.data(), pic.v.size());
  *has_alpha = !pic.a.empty();
  if (*has_alpha) memcpy(a, pic.a.data(), pic.a.size());
  return SL_OK;
}

}  // extern "C"
