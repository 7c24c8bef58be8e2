// libwebp 1.6.0's lossless (VP8L) encoder, as alpha_enc.c's EncodeLossless
// calls it: the plane in the green byte of ARGB pixels (alpha, red, blue 0),
// method 4, quality 32, exact, no header. The stages are libwebp's, file by
// file (enc/vp8l_enc.c, enc/backward_references_enc.c,
// enc/backward_references_cost_enc.c, enc/histogram_enc.c,
// enc/predictor_enc.c, utils/huffman_encode_utils.c, utils/palette.c,
// dsp/lossless_enc.c), in their fixed-point arithmetic (costs in units of
// 2^-23 bits), so the stream is libwebp's bit for bit. Only what that call
// reaches is here: no colour transform or subtract-green (a plane's red and
// blue are 0, so libwebp's analysis never picks them), no near-lossless, no
// low-effort path, one crunch configuration.

#include "sl_vp8l_enc.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

const int kMethod = 4;     // Pillow's method, libwebp's effort level
const int kQuality = 32;   // 8 x the effort level (alpha_enc.c)

const int LOG_2_PRECISION_BITS = 23;
const int NUM_LITERAL_CODES = 256;
const int NUM_LENGTH_CODES = 24;
const int NUM_DISTANCE_CODES = 40;
const int CODE_LENGTH_CODES = 19;
const int MAX_ALLOWED_CODE_LENGTH = 15;
const int MAX_COLOR_CACHE_BITS = 10;
const int MIN_HUFFMAN_BITS = 2;
const int MAX_HUFFMAN_BITS = 9;
const int MIN_TRANSFORM_BITS = 2;
const int MAX_TRANSFORM_BITS = 9;
const int MAX_HUFF_IMAGE_SIZE = 2600;
const int MAX_PREDICTOR_IMAGE_SIZE = 1 << 14;
const int MAX_PALETTE_SIZE = 256;
const int MAX_LENGTH_BITS = 12;
const int MAX_LENGTH = (1 << MAX_LENGTH_BITS) - 1;
const int WINDOW_SIZE = (1 << 20) - 120;
const int HASH_BITS = 18;
const int HASH_SIZE = 1 << HASH_BITS;
const int MIN_LENGTH = 4;
const uint32_t ARGB_BLACK = 0xff000000u;
const uint16_t NON_TRIVIAL_SYM = 0xffff;
const int64_t INT64_MAX_ = 0x7fffffffffffffffll;

// LZ77 kinds (backward_references_enc.h)
const int kLZ77Standard = 1, kLZ77RLE = 2, kLZ77Box = 4;
// Entropy modes (vp8l_enc.c)
enum { kDirect = 0, kSpatial, kSubGreen, kSpatialSubGreen, kPalette, kPaletteAndSpatial };

// ---------------------------------------------------------------------------
// Fixed-point logarithms (dsp/lossless_common.h, dsp/lossless.c): log2(v)
// and v * log2(v) in units of 2^-23.

const uint32_t kLog2Table[256] = {
    0, 0, 8388608, 13295629, 16777216, 19477745, 21684237, 23549800,
    25165824, 26591258, 27866353, 29019816, 30072845, 31041538, 31938408, 32773374,
    33554432, 34288123, 34979866, 35634199, 36254961, 36845429, 37408424, 37946388,
    38461453, 38955489, 39430146, 39886887, 40327016, 40751698, 41161982, 41558811,
    41943040, 42315445, 42676731, 43027545, 43368474, 43700062, 44022807, 44337167,
    44643569, 44942404, 45234037, 45518808, 45797032, 46069003, 46334996, 46595268,
    46850061, 47099600, 47344097, 47583753, 47818754, 48049279, 48275495, 48497560,
    48715624, 48929828, 49140306, 49347187, 49550590, 49750631, 49947419, 50141058,
    50331648, 50519283, 50704053, 50886044, 51065339, 51242017, 51416153, 51587818,
    51757082, 51924012, 52088670, 52251118, 52411415, 52569616, 52725775, 52879946,
    53032177, 53182516, 53331012, 53477707, 53622645, 53765868, 53907416, 54047327,
    54185640, 54322389, 54457611, 54591338, 54723604, 54854440, 54983876, 55111943,
    55238669, 55364082, 55488208, 55611074, 55732705, 55853126, 55972361, 56090432,
    56207362, 56323174, 56437887, 56551524, 56664103, 56775645, 56886168, 56995691,
    57104232, 57211808, 57318436, 57424133, 57528914, 57632796, 57735795, 57837923,
    57939198, 58039632, 58139239, 58238033, 58336027, 58433234, 58529666, 58625336,
    58720256, 58814437, 58907891, 59000628, 59092661, 59183999, 59274652, 59364632,
    59453947, 59542609, 59630625, 59718006, 59804761, 59890898, 59976426, 60061354,
    60145690, 60229443, 60312620, 60395229, 60477278, 60558775, 60639726, 60720140,
    60800023, 60879382, 60958224, 61036555, 61114383, 61191714, 61268554, 61344908,
    61420785, 61496188, 61571124, 61645600, 61719620, 61793189, 61866315, 61939001,
    62011253, 62083076, 62154476, 62225457, 62296024, 62366182, 62435935, 62505289,
    62574248, 62642816, 62710997, 62778797, 62846219, 62913267, 62979946, 63046260,
    63112212, 63177807, 63243048, 63307939, 63372484, 63436687, 63500551, 63564080,
    63627277, 63690146, 63752690, 63814912, 63876816, 63938405, 63999682, 64060650,
    64121313, 64181673, 64241734, 64301498, 64360969, 64420148, 64479040, 64537646,
    64595970, 64654014, 64711782, 64769274, 64826495, 64883447, 64940132, 64996553,
    65052711, 65108611, 65164253, 65219641, 65274776, 65329662, 65384299, 65438691,
    65492840, 65546747, 65600416, 65653847, 65707044, 65760008, 65812741, 65865245,
    65917522, 65969575, 66021404, 66073013, 66124403, 66175575, 66226531, 66277275,
    66327806, 66378127, 66428240, 66478146, 66527847, 66577345, 66626641, 66675737,
    66724635, 66773336, 66821842, 66870154, 66918274, 66966204, 67013944, 67061497,
};
const uint64_t kSLog2Table[256] = {
    0ull, 0ull, 16777216ull, 39886887ull, 67108864ull, 97388723ull,
    130105423ull, 164848600ull, 201326592ull, 239321324ull, 278663526ull, 319217973ull,
    360874141ull, 403539997ull, 447137711ull, 491600606ull, 536870912ull, 582898099ull,
    629637592ull, 677049776ull, 725099212ull, 773754010ull, 822985323ull, 872766924ull,
    923074875ull, 973887230ull, 1025183802ull, 1076945958ull, 1129156447ull, 1181799249ull,
    1234859451ull, 1288323135ull, 1342177280ull, 1396409681ull, 1451008871ull, 1505964059ull,
    1561265072ull, 1616902301ull, 1672866655ull, 1729149526ull, 1785742744ull, 1842638548ull,
    1899829557ull, 1957308741ull, 2015069397ull, 2073105127ull, 2131409817ull, 2189977618ull,
    2248802933ull, 2307880396ull, 2367204859ull, 2426771383ull, 2486575220ull, 2546611805ull,
    2606876748ull, 2667365819ull, 2728074942ull, 2789000187ull, 2850137762ull, 2911484006ull,
    2973035382ull, 3034788471ull, 3096739966ull, 3158886666ull, 3221225472ull, 3283753383ull,
    3346467489ull, 3409364969ull, 3472443085ull, 3535699182ull, 3599130679ull, 3662735070ull,
    3726509920ull, 3790452862ull, 3854561593ull, 3918833872ull, 3983267519ull, 4047860410ull,
    4112610476ull, 4177515704ull, 4242574127ull, 4307783833ull, 4373142952ull, 4438649662ull,
    4504302186ull, 4570098787ull, 4636037770ull, 4702117480ull, 4768336298ull, 4834692645ull,
    4901184974ull, 4967811774ull, 5034571569ull, 5101462912ull, 5168484389ull, 5235634615ull,
    5302912235ull, 5370315922ull, 5437844376ull, 5505496324ull, 5573270518ull, 5641165737ull,
    5709180782ull, 5777314477ull, 5845565671ull, 5913933235ull, 5982416059ull, 6051013057ull,
    6119723161ull, 6188545324ull, 6257478518ull, 6326521733ull, 6395673979ull, 6464934282ull,
    6534301685ull, 6603775250ull, 6673354052ull, 6743037185ull, 6812823756ull, 6882712890ull,
    6952703725ull, 7022795412ull, 7092987118ull, 7163278025ull, 7233667324ull, 7304154222ull,
    7374737939ull, 7445417707ull, 7516192768ull, 7587062379ull, 7658025806ull, 7729082328ull,
    7800231234ull, 7871471825ull, 7942803410ull, 8014225311ull, 8085736859ull, 8157337394ull,
    8229026267ull, 8300802839ull, 8372666477ull, 8444616560ull, 8516652476ull, 8588773618ull,
    8660979393ull, 8733269211ull, 8805642493ull, 8878098667ull, 8950637170ull, 9023257446ull,
    9095958945ull, 9168741125ull, 9241603454ull, 9314545403ull, 9387566451ull, 9460666086ull,
    9533843800ull, 9607099093ull, 9680431471ull, 9753840445ull, 9827325535ull, 9900886263ull,
    9974522161ull, 10048232765ull, 10122017615ull, 10195876260ull, 10269808253ull, 10343813150ull,
    10417890516ull, 10492039919ull, 10566260934ull, 10640553138ull, 10714916116ull, 10789349456ull,
    10863852751ull, 10938425600ull, 11013067604ull, 11087778372ull, 11162557513ull, 11237404645ull,
    11312319387ull, 11387301364ull, 11462350205ull, 11537465541ull, 11612647010ull, 11687894253ull,
    11763206912ull, 11838584638ull, 11914027082ull, 11989533899ull, 12065104750ull, 12140739296ull,
    12216437206ull, 12292198148ull, 12368021795ull, 12443907826ull, 12519855920ull, 12595865759ull,
    12671937032ull, 12748069427ull, 12824262637ull, 12900516358ull, 12976830290ull, 13053204134ull,
    13129637595ull, 13206130381ull, 13282682202ull, 13359292772ull, 13435961806ull, 13512689025ull,
    13589474149ull, 13666316903ull, 13743217014ull, 13820174211ull, 13897188225ull, 13974258793ull,
    14051385649ull, 14128568535ull, 14205807192ull, 14283101363ull, 14360450796ull, 14437855239ull,
    14515314443ull, 14592828162ull, 14670396151ull, 14748018167ull, 14825693972ull, 14903423326ull,
    14981205995ull, 15059041743ull, 15136930339ull, 15214871554ull, 15292865160ull, 15370910930ull,
    15449008641ull, 15527158071ull, 15605359001ull, 15683611210ull, 15761914485ull, 15840268608ull,
    15918673369ull, 15997128556ull, 16075633960ull, 16154189373ull, 16232794589ull, 16311449405ull,
    16390153617ull, 16468907026ull, 16547709431ull, 16626560636ull, 16705460444ull, 16784408661ull,
    16863405094ull, 16942449552ull, 17021541845ull, 17100681785ull,
};

inline int BitsLog2Floor(uint32_t n) { return 31 ^ __builtin_clz(n); }
inline int SubSampleSize(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }
inline int64_t DivRound(int64_t a, int64_t b) {
  return ((a < 0) == (b < 0)) ? ((a + b / 2) / b) : ((a - b / 2) / b);
}

const uint64_t kLog2ReciprocalFixed = 12102203;             // 2^23 / ln(2)
const double kLog2ReciprocalFixedDouble = 0x1.71547652b82fep+23;

uint32_t FastLog2Slow(uint32_t v) {
  if (v < 65536) {
    const uint32_t orig_v = v;
    const uint32_t log_cnt = BitsLog2Floor(v) - 7;
    const uint32_t y = 1u << log_cnt;
    v >>= log_cnt;
    uint32_t log_2 = kLog2Table[v] + (log_cnt << LOG_2_PRECISION_BITS);
    if (orig_v >= 4096) {
      const uint64_t correction = kLog2ReciprocalFixed * (orig_v & (y - 1));
      log_2 += (uint32_t)DivRound((int64_t)correction, orig_v);
    }
    return log_2;
  }
  return (uint32_t)(uint64_t)(kLog2ReciprocalFixedDouble * log((double)v) + .5);
}

uint64_t FastSLog2Slow(uint32_t v) {
  if (v < 65536) {
    const uint64_t orig_v = v;
    const uint64_t log_cnt = BitsLog2Floor(v) - 7;
    const uint32_t y = 1u << log_cnt;
    v >>= log_cnt;
    const uint64_t correction = kLog2ReciprocalFixed * (orig_v & (y - 1));
    return orig_v * (kLog2Table[v] + (log_cnt << LOG_2_PRECISION_BITS)) + correction;
  }
  return (uint64_t)((double)v * kLog2ReciprocalFixedDouble * log((double)v) + .5);
}

inline uint32_t FastLog2(uint32_t v) { return v < 256 ? kLog2Table[v] : FastLog2Slow(v); }
inline uint64_t FastSLog2(uint32_t v) { return v < 256 ? kSLog2Table[v] : FastSLog2Slow(v); }

// ---------------------------------------------------------------------------
// Pixels

inline uint32_t SubPixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_and_green = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t red_and_blue = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (alpha_and_green & 0xff00ff00u) | (red_and_blue & 0x00ff00ffu);
}

// A length or distance as its prefix code and extra bits (the LUT below 512
// gives the same; 0 maps to code 0 as libwebp's table does).
inline void PrefixEncodeBits(int distance, int* code, int* extra_bits) {
  if (distance < 3) {
    *code = (distance == 2) ? 1 : 0;
    *extra_bits = 0;
    return;
  }
  const int d = distance - 1;
  const int highest_bit = BitsLog2Floor(d);
  const int second_highest_bit = (d >> (highest_bit - 1)) & 1;
  *extra_bits = highest_bit - 1;
  *code = 2 * highest_bit + second_highest_bit;
}

inline void PrefixEncode(int distance, int* code, int* extra_bits, int* extra_bits_value) {
  if (distance < 3) {
    *code = (distance == 2) ? 1 : 0;
    *extra_bits = 0;
    *extra_bits_value = 0;
    return;
  }
  const int d = distance - 1;
  const int highest_bit = BitsLog2Floor(d);
  const int second_highest_bit = (d >> (highest_bit - 1)) & 1;
  *extra_bits = highest_bit - 1;
  *extra_bits_value = d & ((1 << *extra_bits) - 1);
  *code = 2 * highest_bit + second_highest_bit;
}

// ---------------------------------------------------------------------------
// The bit writer (utils/bit_writer_utils.c, VP8L's LSB-first one)

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t bits = 0;
  int used = 0;
  void Put(uint32_t v, int n) {
    if (n == 0) return;
    bits |= (uint64_t)(v & (uint32_t)((1ull << n) - 1)) << used;
    used += n;
    while (used >= 8) {
      buf.push_back((uint8_t)bits);
      bits >>= 8;
      used -= 8;
    }
  }
  size_t NumBytes() const { return buf.size() + ((used + 7) >> 3); }
  std::vector<uint8_t> Finish() const {
    std::vector<uint8_t> out = buf;
    if (used > 0) out.push_back((uint8_t)bits);
    return out;
  }
};

// ---------------------------------------------------------------------------
// The colour cache (utils/color_cache_utils.h): zeroed at the start, so a
// black transparent pixel is found before it was ever inserted.

const uint32_t kHashMul = 0x1e35a7bdu;
inline int HashPix(uint32_t argb, int shift) { return (int)((argb * kHashMul) >> shift); }

struct ColorCache {
  std::vector<uint32_t> colors;
  int hash_shift;
  explicit ColorCache(int bits) : colors((size_t)1 << bits, 0), hash_shift(32 - bits) {}
  int Contains(uint32_t argb) const {
    const int key = HashPix(argb, hash_shift);
    return (colors[key] == argb) ? key : -1;
  }
  void Insert(uint32_t argb) { colors[HashPix(argb, hash_shift)] = argb; }
};

// ---------------------------------------------------------------------------
// Backward references (backward_references_enc.c)

enum { kLiteral = 0, kCacheIdx = 1, kCopy = 2 };

struct PixOrCopy {
  uint8_t mode;
  uint16_t len;
  uint32_t argb_or_distance;
};

inline PixOrCopy CreateCopy(uint32_t distance, int len) { return {kCopy, (uint16_t)len, distance}; }
inline PixOrCopy CreateCacheIdx(int idx) { return {kCacheIdx, 1, (uint32_t)idx}; }
inline PixOrCopy CreateLiteral(uint32_t argb) { return {kLiteral, 1, argb}; }

typedef std::vector<PixOrCopy> Refs;

const uint8_t kPlaneToCodeLut[128] = {
    96,  73,  55,  39,  23,  13,  5,   1,   255, 255, 255, 255, 255, 255, 255, 255,
    101, 78,  58,  42,  26,  16,  8,   2,   0,   3,   9,   17,  27,  43,  59,  79,
    102, 86,  62,  46,  32,  20,  10,  6,   4,   7,   11,  21,  33,  47,  63,  87,
    105, 90,  70,  52,  37,  28,  18,  14,  12,  15,  19,  29,  38,  53,  71,  91,
    110, 99,  82,  66,  48,  35,  30,  24,  22,  25,  31,  36,  49,  67,  83,  100,
    115, 108, 94,  76,  64,  50,  44,  40,  34,  41,  45,  51,  65,  77,  95,  109,
    118, 113, 103, 92,  80,  68,  60,  56,  54,  57,  61,  69,  81,  93,  104, 114,
    119, 116, 111, 106, 97,  88,  84,  74,  72,  75,  85,  89,  98,  107, 112, 117};

int DistanceToPlaneCode(int xsize, int dist) {
  const int yoffset = dist / xsize;
  const int xoffset = dist - yoffset * xsize;
  if (xoffset <= 8 && yoffset < 8) {
    return kPlaneToCodeLut[yoffset * 16 + 8 - xoffset] + 1;
  } else if (xoffset > xsize - 8 && yoffset < 7) {
    return kPlaneToCodeLut[(yoffset + 1) * 16 + 8 + (xsize - xoffset)] + 1;
  }
  return dist + 120;
}

inline int VectorMismatch(const uint32_t* a, const uint32_t* b, int length) {
  int match_len = 0;
  while (match_len < length && a[match_len] == b[match_len]) ++match_len;
  return match_len;
}

inline int FindMatchLength(const uint32_t* a, const uint32_t* b, int best_len_match, int max_limit) {
  if (a[best_len_match] != b[best_len_match]) return 0;
  return VectorMismatch(a, b, max_limit);
}

inline int MaxFindCopyLength(int len) { return (len < MAX_LENGTH) ? len : MAX_LENGTH; }

// Each position's best match: offset << 12 | length.
struct HashChain {
  std::vector<uint32_t> offset_length;
  int FindOffset(int pos) const { return (int)(offset_length[pos] >> MAX_LENGTH_BITS); }
  int FindLength(int pos) const { return (int)(offset_length[pos] & ((1u << MAX_LENGTH_BITS) - 1)); }
};

inline uint32_t GetPixPairHash64(const uint32_t* argb) {
  uint32_t key = argb[1] * 0xc6a4a793u;
  key += argb[0] * 0x5bd1e996u;
  return key >> (32 - HASH_BITS);
}

int GetMaxItersForQuality(int quality) { return 8 + (quality * quality) / 128; }

int GetWindowSizeForHashChain(int quality, int xsize) {
  const int max_window_size = (quality > 75)   ? WINDOW_SIZE
                              : (quality > 50) ? (xsize << 8)
                              : (quality > 25) ? (xsize << 6)
                                               : (xsize << 4);
  return (max_window_size > WINDOW_SIZE) ? WINDOW_SIZE : max_window_size;
}

void HashChainFill(HashChain& p, int quality, const uint32_t* argb, int xsize, int ysize) {
  const int size = xsize * ysize;
  const int iter_max = GetMaxItersForQuality(quality);
  const uint32_t window_size = (uint32_t)GetWindowSizeForHashChain(quality, xsize);
  p.offset_length.assign(size, 0);
  if (size <= 2) return;
  std::vector<int32_t> hash_to_first_index(HASH_SIZE, -1);
  std::vector<int32_t> chain(size, 0);
  int pos;
  int argb_comp = (argb[0] == argb[1]);
  for (pos = 0; pos < size - 2;) {
    uint32_t hash_code;
    const int argb_comp_next = (argb[pos + 1] == argb[pos + 2]);
    if (argb_comp && argb_comp_next) {
      // A run of one colour: hash the colour with the run's length.
      uint32_t tmp[2];
      uint32_t len = 1;
      tmp[0] = argb[pos];
      while (pos + (int)len + 2 < size && argb[pos + len + 2] == argb[pos]) ++len;
      if (len > (uint32_t)MAX_LENGTH) {
        for (uint32_t k = 0; k < len - MAX_LENGTH; ++k) chain[pos + k] = -1;
        pos += len - MAX_LENGTH;
        len = MAX_LENGTH;
      }
      while (len) {
        tmp[1] = len--;
        hash_code = GetPixPairHash64(tmp);
        chain[pos] = hash_to_first_index[hash_code];
        hash_to_first_index[hash_code] = pos++;
      }
      argb_comp = 0;
    } else {
      hash_code = GetPixPairHash64(argb + pos);
      chain[pos] = hash_to_first_index[hash_code];
      hash_to_first_index[hash_code] = pos++;
      argb_comp = argb_comp_next;
    }
  }
  chain[pos] = hash_to_first_index[GetPixPairHash64(argb + pos)];

  p.offset_length[0] = p.offset_length[size - 1] = 0;
  for (uint32_t base_position = size - 2; base_position > 0;) {
    const int max_len = MaxFindCopyLength(size - 1 - base_position);
    const uint32_t* const argb_start = argb + base_position;
    int iter = iter_max;
    int best_length = 0;
    uint32_t best_distance = 0;
    uint32_t best_argb;
    const int min_pos = (base_position > window_size) ? (int)(base_position - window_size) : 0;
    const int length_max = (max_len < 256) ? max_len : 256;
    uint32_t max_base_position;

    pos = chain[base_position];
    {
      int curr_length;
      if (base_position >= (uint32_t)xsize) {
        curr_length = FindMatchLength(argb_start - xsize, argb_start, best_length, max_len);
        if (curr_length > best_length) {
          best_length = curr_length;
          best_distance = xsize;
        }
        --iter;
      }
      curr_length = FindMatchLength(argb_start - 1, argb_start, best_length, max_len);
      if (curr_length > best_length) {
        best_length = curr_length;
        best_distance = 1;
      }
      --iter;
      if (best_length == MAX_LENGTH) pos = min_pos - 1;
    }
    best_argb = argb_start[best_length];

    for (; pos >= min_pos && --iter; pos = chain[pos]) {
      int curr_length;
      if (argb[pos + best_length] != best_argb) continue;
      curr_length = VectorMismatch(argb + pos, argb_start, max_len);
      if (best_length < curr_length) {
        best_length = curr_length;
        best_distance = base_position - pos;
        best_argb = argb_start[best_length];
        if (best_length >= length_max) break;
      }
    }
    // Extend the match to the left while the two intervals keep matching.
    max_base_position = base_position;
    while (1) {
      p.offset_length[base_position] = (best_distance << MAX_LENGTH_BITS) | (uint32_t)best_length;
      --base_position;
      if (best_distance == 0 || base_position == 0) break;
      if (base_position < best_distance || argb[base_position - best_distance] != argb[base_position]) {
        break;
      }
      if (best_length == MAX_LENGTH && best_distance != 1 &&
          base_position + MAX_LENGTH < max_base_position) {
        break;
      }
      if (best_length < MAX_LENGTH) {
        ++best_length;
        max_base_position = base_position;
      }
    }
  }
}

// The three LZ77 parses below run without a colour cache (libwebp adds
// one afterwards, BackwardRefsWithLocalCache).
void BackwardReferencesRle(int xsize, int ysize, const uint32_t* argb, Refs& refs) {
  const int pix_count = xsize * ysize;
  refs.clear();
  refs.push_back(CreateLiteral(argb[0]));
  int i = 1;
  while (i < pix_count) {
    const int max_len = MaxFindCopyLength(pix_count - i);
    const int rle_len = FindMatchLength(argb + i, argb + i - 1, 0, max_len);
    const int prev_row_len = (i < xsize) ? 0 : FindMatchLength(argb + i, argb + i - xsize, 0, max_len);
    if (rle_len >= prev_row_len && rle_len >= MIN_LENGTH) {
      refs.push_back(CreateCopy(1, rle_len));
      i += rle_len;
    } else if (prev_row_len >= MIN_LENGTH) {
      refs.push_back(CreateCopy(xsize, prev_row_len));
      i += prev_row_len;
    } else {
      refs.push_back(CreateLiteral(argb[i]));
      i++;
    }
  }
}

void BackwardReferencesLz77(int xsize, int ysize, const uint32_t* argb, const HashChain& hash_chain,
                            Refs& refs) {
  const int pix_count = xsize * ysize;
  int i_last_check = -1;
  refs.clear();
  for (int i = 0; i < pix_count;) {
    int offset = 0;
    int len = 0;
    int j;
    offset = hash_chain.FindOffset(i);
    len = hash_chain.FindLength(i);
    if (len >= MIN_LENGTH) {
      const int len_ini = len;
      int max_reach = 0;
      const int j_max = (i + len_ini >= pix_count) ? pix_count - 1 : i + len_ini;
      // The best match for this pixel and the next one together: the copy
      // may end early where the following match reaches further.
      i_last_check = (i > i_last_check) ? i : i_last_check;
      for (j = i_last_check + 1; j <= j_max; ++j) {
        const int len_j = hash_chain.FindLength(j);
        const int reach = j + (len_j >= MIN_LENGTH ? len_j : 1);
        if (reach > max_reach) {
          len = j - i;
          max_reach = reach;
          if (max_reach >= pix_count) break;
        }
      }
    } else {
      len = 1;
    }
    if (len == 1) {
      refs.push_back(CreateLiteral(argb[i]));
    } else {
      refs.push_back(CreateCopy(offset, len));
    }
    i += len;
  }
}

// LZ77 restricted to the 32 shortest plane codes around each pixel.
void BackwardReferencesLz77Box(int xsize, int ysize, const uint32_t* argb, const HashChain& hash_chain_best,
                               HashChain& hash_chain, Refs& refs) {
  const int pix_count = xsize * ysize;
  const int kWindowOffsetsSizeMax = 32;
  int window_offsets[32] = {0};
  int window_offsets_new[32] = {0};
  int window_offsets_size = 0;
  int window_offsets_new_size = 0;
  std::vector<uint16_t> counts_ini(pix_count);
  int best_offset_prev = -1, best_length_prev = -1;
  int i;

  // counts[i]: how many times the pixel at i repeats from there (at most MAX_LENGTH)
  counts_ini[pix_count - 1] = 1;
  for (i = pix_count - 2; i >= 0; --i) {
    if (argb[i] == argb[i + 1]) {
      counts_ini[i] = counts_ini[i + 1] + (counts_ini[i + 1] != MAX_LENGTH);
    } else {
      counts_ini[i] = 1;
    }
  }

  {
    int x, y;
    for (y = 0; y <= 6; ++y) {
      for (x = -6; x <= 6; ++x) {
        const int offset = y * xsize + x;
        int plane_code;
        if (offset <= 0) continue;
        plane_code = DistanceToPlaneCode(xsize, offset) - 1;
        if (plane_code >= kWindowOffsetsSizeMax) continue;
        window_offsets[plane_code] = offset;
      }
    }
    for (i = 0; i < kWindowOffsetsSizeMax; ++i) {
      if (window_offsets[i] == 0) continue;
      window_offsets[window_offsets_size++] = window_offsets[i];
    }
    // The offsets that reach pixels the previous pixel's offsets cannot.
    for (i = 0; i < window_offsets_size; ++i) {
      int j;
      int is_reachable = 0;
      for (j = 0; j < window_offsets_size && !is_reachable; ++j) {
        is_reachable |= (window_offsets[i] == window_offsets[j] + 1);
      }
      if (!is_reachable) {
        window_offsets_new[window_offsets_new_size] = window_offsets[i];
        ++window_offsets_new_size;
      }
    }
  }

  hash_chain.offset_length.assign(pix_count, 0);
  for (i = 1; i < pix_count; ++i) {
    int ind;
    int best_length = hash_chain_best.FindLength(i);
    int best_offset = 0;
    int do_compute = 1;

    if (best_length >= MAX_LENGTH) {
      best_offset = hash_chain_best.FindOffset(i);
      for (ind = 0; ind < window_offsets_size; ++ind) {
        if (best_offset == window_offsets[ind]) {
          do_compute = 0;
          break;
        }
      }
    }
    if (do_compute) {
      const int use_prev = (best_length_prev > 1) && (best_length_prev < MAX_LENGTH);
      const int num_ind = use_prev ? window_offsets_new_size : window_offsets_size;
      best_length = use_prev ? best_length_prev - 1 : 0;
      best_offset = use_prev ? best_offset_prev : 0;
      for (ind = 0; ind < num_ind; ++ind) {
        int curr_length = 0;
        int j = i;
        int j_offset = use_prev ? i - window_offsets_new[ind] : i - window_offsets[ind];
        if (j_offset < 0 || argb[j_offset] != argb[i]) continue;
        do {
          const int counts_j_offset = counts_ini[j_offset];
          const int counts_j = counts_ini[j];
          if (counts_j_offset != counts_j) {
            curr_length += (counts_j_offset < counts_j) ? counts_j_offset : counts_j;
            break;
          }
          curr_length += counts_j_offset;
          j_offset += counts_j_offset;
          j += counts_j_offset;
        } while (curr_length <= MAX_LENGTH && j < pix_count && argb[j_offset] == argb[j]);
        if (best_length < curr_length) {
          best_offset = use_prev ? window_offsets_new[ind] : window_offsets[ind];
          if (curr_length >= MAX_LENGTH) {
            best_length = MAX_LENGTH;
            break;
          } else {
            best_length = curr_length;
          }
        }
      }
    }

    if (best_length <= MIN_LENGTH) {
      hash_chain.offset_length[i] = 0;
      best_offset_prev = 0;
      best_length_prev = 0;
    } else {
      hash_chain.offset_length[i] = ((uint32_t)best_offset << MAX_LENGTH_BITS) | (uint32_t)best_length;
      best_offset_prev = best_offset;
      best_length_prev = best_length;
    }
  }
  hash_chain.offset_length[0] = 0;
  BackwardReferencesLz77(xsize, ysize, argb, hash_chain, refs);
}

// ---------------------------------------------------------------------------
// Histograms (histogram_enc.c): five per set of codes, each with its cost,
// its trivial symbol (0xffff: none or several) and whether it is used.

inline int HistogramNumCodes(int palette_code_bits) {
  return NUM_LITERAL_CODES + NUM_LENGTH_CODES + ((palette_code_bits > 0) ? (1 << palette_code_bits) : 0);
}

struct Histogram {
  std::vector<uint32_t> literal;
  uint32_t red[256];
  uint32_t blue[256];
  uint32_t alpha[256];
  uint32_t distance[NUM_DISTANCE_CODES];
  int palette_code_bits;
  uint16_t trivial_symbol[5];
  uint8_t is_used[5];
  uint16_t bin_id;
  uint64_t bit_cost;
  uint64_t costs[5];

  explicit Histogram(int cache_bits = 0) { Init(cache_bits); }
  void Init(int cache_bits) {
    palette_code_bits = cache_bits;
    literal.assign(HistogramNumCodes(cache_bits), 0);
    Clear();
  }
  // libwebp's clear zeroes the whole histogram, trivial symbols included.
  void Clear() {
    std::fill(literal.begin(), literal.end(), 0);
    memset(red, 0, sizeof(red));
    memset(blue, 0, sizeof(blue));
    memset(alpha, 0, sizeof(alpha));
    memset(distance, 0, sizeof(distance));
    memset(trivial_symbol, 0, sizeof(trivial_symbol));
    memset(is_used, 0, sizeof(is_used));
    bin_id = 0;
    bit_cost = 0;
    memset(costs, 0, sizeof(costs));
  }
  // The population of component i (literal, red, blue, alpha, distance).
  const uint32_t* Population(int i, int* length) const {
    switch (i) {
      case 0: *length = (int)literal.size(); return literal.data();
      case 1: *length = 256; return red;
      case 2: *length = 256; return blue;
      case 3: *length = 256; return alpha;
      default: *length = NUM_DISTANCE_CODES; return distance;
    }
  }
  uint32_t* Population(int i, int* length) {
    return const_cast<uint32_t*>(static_cast<const Histogram*>(this)->Population(i, length));
  }
};

void HistogramAddSinglePixOrCopy(Histogram& h, const PixOrCopy& v, int xsize_for_plane_codes) {
  if (v.mode == kLiteral) {
    ++h.alpha[v.argb_or_distance >> 24];
    ++h.red[(v.argb_or_distance >> 16) & 0xff];
    ++h.literal[(v.argb_or_distance >> 8) & 0xff];
    ++h.blue[v.argb_or_distance & 0xff];
  } else if (v.mode == kCacheIdx) {
    ++h.literal[NUM_LITERAL_CODES + NUM_LENGTH_CODES + v.argb_or_distance];
  } else {
    int code, extra_bits;
    PrefixEncodeBits(v.len, &code, &extra_bits);
    ++h.literal[NUM_LITERAL_CODES + code];
    const int dist = xsize_for_plane_codes > 0 ? DistanceToPlaneCode(xsize_for_plane_codes, v.argb_or_distance)
                                               : (int)v.argb_or_distance;
    PrefixEncodeBits(dist, &code, &extra_bits);
    ++h.distance[code];
  }
}

// xsize > 0: distances go through their plane codes first.
void HistogramStoreRefs(const Refs& refs, int xsize_for_plane_codes, Histogram& h) {
  for (const PixOrCopy& v : refs) HistogramAddSinglePixOrCopy(h, v, xsize_for_plane_codes);
}

void HistogramCreate(Histogram& h, const Refs& refs, int palette_code_bits) {
  h.Init(palette_code_bits);
  HistogramStoreRefs(refs, 0, h);
}

struct BitEntropy {
  uint64_t entropy;
  uint32_t sum;
  int nonzeros;
  uint32_t max_val;
  uint32_t nonzero_code;
};

struct Streaks {
  int counts[2];      // zero / non-zero streaks longer than 3
  int streaks[2][2];  // [zero / non-zero][short / long]
};

void BitEntropyInit(BitEntropy* e) {
  e->entropy = 0;
  e->sum = 0;
  e->nonzeros = 0;
  e->max_val = 0;
  e->nonzero_code = 0xffffffffu;
}

void BitEntropyUnrefined(const uint32_t* array, int n, BitEntropy* e) {
  BitEntropyInit(e);
  for (int i = 0; i < n; ++i) {
    if (array[i] != 0) {
      e->sum += array[i];
      e->nonzero_code = i;
      ++e->nonzeros;
      e->entropy += FastSLog2(array[i]);
      if (e->max_val < array[i]) e->max_val = array[i];
    }
  }
  e->entropy = FastSLog2(e->sum) - e->entropy;
}

inline void GetEntropyUnrefinedHelper(uint32_t val, int i, uint32_t* val_prev, int* i_prev, BitEntropy* be,
                                      Streaks* st) {
  const int streak = i - *i_prev;
  if (*val_prev != 0) {
    be->sum += (*val_prev) * streak;
    be->nonzeros += streak;
    be->nonzero_code = *i_prev;
    be->entropy += FastSLog2(*val_prev) * streak;
    if (be->max_val < *val_prev) be->max_val = *val_prev;
  }
  st->counts[*val_prev != 0] += (streak > 3);
  st->streaks[*val_prev != 0][(streak > 3)] += streak;
  *val_prev = val;
  *i_prev = i;
}

void GetEntropyUnrefined(const uint32_t* X, int length, BitEntropy* be, Streaks* st) {
  int i;
  int i_prev = 0;
  uint32_t x_prev = X[0];
  memset(st, 0, sizeof(*st));
  BitEntropyInit(be);
  for (i = 1; i < length; ++i) {
    const uint32_t x = X[i];
    if (x != x_prev) GetEntropyUnrefinedHelper(x, i, &x_prev, &i_prev, be, st);
  }
  GetEntropyUnrefinedHelper(0, i, &x_prev, &i_prev, be, st);
  be->entropy = FastSLog2(be->sum) - be->entropy;
}

void GetCombinedEntropyUnrefined(const uint32_t* X, const uint32_t* Y, int length, BitEntropy* be, Streaks* st) {
  int i;
  int i_prev = 0;
  uint32_t xy_prev = X[0] + Y[0];
  memset(st, 0, sizeof(*st));
  BitEntropyInit(be);
  for (i = 1; i < length; ++i) {
    const uint32_t xy = X[i] + Y[i];
    if (xy != xy_prev) GetEntropyUnrefinedHelper(xy, i, &xy_prev, &i_prev, be, st);
  }
  GetEntropyUnrefinedHelper(0, i, &xy_prev, &i_prev, be, st);
  be->entropy = FastSLog2(be->sum) - be->entropy;
}

uint64_t BitsEntropyRefine(const BitEntropy* e) {
  uint64_t mix;
  if (e->nonzeros < 5) {
    if (e->nonzeros <= 1) return 0;
    // Two symbols are coded with one bit each; a little entropy mixed in.
    if (e->nonzeros == 2) {
      return (uint64_t)DivRound((int64_t)(99 * ((uint64_t)e->sum << LOG_2_PRECISION_BITS) + e->entropy), 100);
    }
    mix = (e->nonzeros == 3) ? 950 : 700;
  } else {
    mix = 627;
  }
  uint64_t min_limit = (uint64_t)(uint32_t)(2 * e->sum - e->max_val) << LOG_2_PRECISION_BITS;
  min_limit = (uint64_t)DivRound((int64_t)(mix * min_limit + (1000 - mix) * e->entropy), 1000);
  return (e->entropy < min_limit) ? min_limit : e->entropy;
}

uint64_t BitsEntropy(const uint32_t* array, int n) {
  BitEntropy e;
  BitEntropyUnrefined(array, n, &e);
  return BitsEntropyRefine(&e);
}

// The cost of coding the code lengths, from the streaks (1/1024 bits, then
// shifted), plus libwebp's constant for the code of code lengths.
uint64_t FinalHuffmanCost(const Streaks* st) {
  uint32_t retval = st->counts[0] * 1600 + 240 * st->streaks[0][1];
  retval += st->counts[1] * 2640 + 720 * st->streaks[1][1];
  retval += 1840 * st->streaks[0][0];
  retval += 3360 * st->streaks[1][0];
  return ((uint64_t)retval << (LOG_2_PRECISION_BITS - 10)) + 401814323ull;
}

uint64_t PopulationCost(const uint32_t* population, int length, uint16_t* trivial_sym, uint8_t* is_used) {
  BitEntropy be;
  Streaks st;
  GetEntropyUnrefined(population, length, &be, &st);
  if (trivial_sym != nullptr) *trivial_sym = (be.nonzeros == 1) ? (uint16_t)be.nonzero_code : NON_TRIVIAL_SYM;
  if (is_used != nullptr) *is_used = (st.streaks[1][0] != 0 || st.streaks[1][1] != 0);
  return BitsEntropyRefine(&be) + FinalHuffmanCost(&st);
}

uint32_t ExtraCost(const uint32_t* population, int length) {
  uint32_t cost = population[4] + population[5];
  for (int i = 2; i < length / 2 - 1; ++i) cost += i * (population[2 * i + 2] + population[2 * i + 3]);
  return cost;
}

uint64_t HistogramEstimateBits(const Histogram& h) {
  uint64_t cost = 0;
  for (int i = 0; i < 5; ++i) {
    int len;
    const uint32_t* pop = h.Population(i, &len);
    cost += PopulationCost(pop, len, nullptr, nullptr);
  }
  const uint32_t extra = ExtraCost(h.literal.data() + NUM_LITERAL_CODES, NUM_LENGTH_CODES) +
                         ExtraCost(h.distance, NUM_DISTANCE_CODES);
  return cost + ((uint64_t)extra << LOG_2_PRECISION_BITS);
}

void UpdateHistogramCost(Histogram& h) {
  uint64_t sum = 0;
  for (int i = 0; i < 5; ++i) {
    int len;
    const uint32_t* pop = h.Population(i, &len);
    h.costs[i] = PopulationCost(pop, len, &h.trivial_symbol[i], &h.is_used[i]);
    sum += h.costs[i];
  }
  h.bit_cost = sum;
}

// out = a + b (out may be b).
void HistogramAdd(const Histogram& a, const Histogram& b, Histogram& out) {
  for (int i = 0; i < 5; ++i) {
    int len;
    const uint32_t* pa = a.Population(i, &len);
    const uint32_t* pb = b.Population(i, &len);
    uint32_t* po = out.Population(i, &len);
    for (int k = 0; k < len; ++k) po[k] = pa[k] + pb[k];
  }
  for (int i = 0; i < 5; ++i) {
    out.trivial_symbol[i] = (a.trivial_symbol[i] == b.trivial_symbol[i]) ? a.trivial_symbol[i] : NON_TRIVIAL_SYM;
    out.is_used[i] = a.is_used[i] | b.is_used[i];
  }
}

// The cost of a + b, component by component against ``cost_threshold``:
// 0 as soon as the running cost reaches it, else 1 with the cost and its
// five parts.
int GetCombinedHistogramEntropy(const Histogram& a, const Histogram& b, int64_t cost_threshold, uint64_t* cost,
                                uint64_t costs[5]) {
  *cost = 0;
  for (int i = 0; i < 5; ++i) {
    const uint16_t ta = a.trivial_symbol[i];
    if (ta != NON_TRIVIAL_SYM && ta == b.trivial_symbol[i]) {
      costs[i] = a.is_used[i] ? a.costs[i] : b.costs[i];
    } else if (!a.is_used[i]) {
      costs[i] = b.costs[i];
    } else if (!b.is_used[i]) {
      costs[i] = a.costs[i];
    } else {
      int len;
      const uint32_t* pa = a.Population(i, &len);
      const uint32_t* pb = b.Population(i, &len);
      BitEntropy be;
      Streaks st;
      GetCombinedEntropyUnrefined(pa, pb, len, &be, &st);
      costs[i] = BitsEntropyRefine(&be) + FinalHuffmanCost(&st);
    }
    *cost += costs[i];
    if (*cost >= (uint64_t)cost_threshold) return 0;
  }
  return 1;
}

inline int64_t SaturateAdd(uint64_t a, int64_t b) {
  if (b >= 0 && (int64_t)a > INT64_MAX_ - b) return INT64_MAX_;
  return (int64_t)a + b;
}

// A set of histograms: ``size`` live ones at the front of ``histograms``;
// removing one moves the last into its slot.
struct HistogramSet {
  std::vector<Histogram> storage;
  std::vector<Histogram*> histograms;
  int size = 0;
  int max_size = 0;
  HistogramSet(int n, int cache_bits) : storage(n, Histogram(cache_bits)), histograms(n), size(n), max_size(n) {
    for (int i = 0; i < n; ++i) histograms[i] = &storage[i];
  }
  // libwebp's clear zeroes the set's block and points the set at its own
  // histograms again, in order.
  void Clear() {
    for (int i = 0; i < max_size; ++i) {
      histograms[i] = &storage[i];
      storage[i].Clear();
    }
    size = max_size;
  }
  void Remove(int i) {
    histograms[i] = histograms[size - 1];
    --size;
  }
};

// histogram_enc.c's entropy bins: the literal, red and blue costs each cut
// into four ranges.
const int NUM_PARTITIONS = 4;
const int BIN_SIZE = NUM_PARTITIONS * NUM_PARTITIONS * NUM_PARTITIONS;
const int MAX_HISTO_GREEDY = 100;

inline int GetBinIdForEntropy(uint64_t min, uint64_t max, uint64_t val) {
  const uint64_t range = max - min;
  if (range > 0) {
    const uint64_t delta = val - min;
    return (int)((NUM_PARTITIONS - 1e-6) * (double)delta / (double)range);
  }
  return 0;
}

void HistogramAnalyzeEntropyBin(HistogramSet& set) {
  uint64_t lit_min = ~0ull, lit_max = 0, red_min = ~0ull, red_max = 0, blue_min = ~0ull, blue_max = 0;
  for (int i = 0; i < set.size; ++i) {
    const Histogram& h = *set.histograms[i];
    lit_max = std::max(lit_max, h.costs[0]);
    lit_min = std::min(lit_min, h.costs[0]);
    red_max = std::max(red_max, h.costs[1]);
    red_min = std::min(red_min, h.costs[1]);
    blue_max = std::max(blue_max, h.costs[2]);
    blue_min = std::min(blue_min, h.costs[2]);
  }
  for (int i = 0; i < set.size; ++i) {
    Histogram& h = *set.histograms[i];
    int bin_id = GetBinIdForEntropy(lit_min, lit_max, h.costs[0]);
    bin_id = bin_id * NUM_PARTITIONS + GetBinIdForEntropy(red_min, red_max, h.costs[1]);
    bin_id = bin_id * NUM_PARTITIONS + GetBinIdForEntropy(blue_min, blue_max, h.costs[2]);
    h.bin_id = (uint16_t)bin_id;
  }
}

inline bool IsTrivialARB(const Histogram& h) {
  return h.trivial_symbol[1] != NON_TRIVIAL_SYM && h.trivial_symbol[2] != NON_TRIVIAL_SYM &&
         h.trivial_symbol[3] != NON_TRIVIAL_SYM;
}

// Merges histograms of one bin into the bin's first where that pays.
void HistogramCombineEntropyBin(HistogramSet& set, Histogram*& cur_combo, int num_bins, int combine_cost_factor) {
  struct {
    int16_t first;
    uint16_t num_combine_failures;
  } bin_info[BIN_SIZE];
  for (int i = 0; i < num_bins; ++i) {
    bin_info[i].first = -1;
    bin_info[i].num_combine_failures = 0;
  }
  for (int idx = 0; idx < set.size;) {
    Histogram* const h = set.histograms[idx];
    const int bin_id = h->bin_id;
    const int first = bin_info[bin_id].first;
    if (first == -1) {
      bin_info[bin_id].first = (int16_t)idx;
      ++idx;
      continue;
    }
    Histogram* const hf = set.histograms[first];
    const int64_t bit_cost_thresh = -DivRound((int64_t)h->bit_cost * combine_cost_factor, 100);
    const int64_t threshold = SaturateAdd(hf->bit_cost + h->bit_cost, bit_cost_thresh);
    uint64_t cost, costs[5];
    if (!GetCombinedHistogramEntropy(*hf, *h, threshold, &cost, costs)) {
      ++idx;
      continue;
    }
    HistogramAdd(*hf, *h, *cur_combo);
    cur_combo->bit_cost = cost;
    memcpy(cur_combo->costs, costs, sizeof(costs));
    // Merge only where the result is trivial or both were not, unless the
    // bin failed that often already.
    const bool try_combine = IsTrivialARB(*cur_combo) || (!IsTrivialARB(*h) && !IsTrivialARB(*hf));
    if (try_combine || bin_info[bin_id].num_combine_failures >= 32) {
      std::swap(cur_combo, set.histograms[first]);
      set.Remove(idx);
    } else {
      ++bin_info[bin_id].num_combine_failures;
      ++idx;
    }
  }
}

struct HistogramPair {
  int idx1, idx2;
  int64_t cost_diff;
  uint64_t cost_combo;
  uint64_t costs[5];
};

struct HistoQueue {
  std::vector<HistogramPair> queue;
  int size = 0;
  int max_size;
  explicit HistoQueue(int n) : queue(n + 1), max_size(n) {}
  void PopPair(int j) {
    queue[j] = queue[size - 1];
    --size;
  }
  void UpdateHead(int j) {
    if (queue[j].cost_diff < queue[0].cost_diff) std::swap(queue[0], queue[j]);
  }
};

// Re-evaluates a pair against 0 (a merge must pay); 0 if it does not.
int HistoQueueUpdatePair(const Histogram& h1, const Histogram& h2, HistogramPair& pair) {
  const uint64_t sum_cost = h1.bit_cost + h2.bit_cost;
  if (!GetCombinedHistogramEntropy(h1, h2, SaturateAdd(sum_cost, 0), &pair.cost_combo, pair.costs)) return 0;
  pair.cost_diff = (int64_t)(pair.cost_combo - sum_cost);
  return 1;
}

// Pushes the pair if merging it beats ``threshold``; returns its cost
// difference, or 0 where it was not pushed.
int64_t HistoQueuePush(HistoQueue& q, const HistogramSet& set, int idx1, int idx2, int64_t threshold) {
  if (q.size == q.max_size) return 0;
  if (idx1 > idx2) std::swap(idx1, idx2);
  HistogramPair pair;
  pair.idx1 = idx1;
  pair.idx2 = idx2;
  const Histogram& h1 = *set.histograms[idx1];
  const Histogram& h2 = *set.histograms[idx2];
  const uint64_t sum_cost = h1.bit_cost + h2.bit_cost;
  if (!GetCombinedHistogramEntropy(h1, h2, SaturateAdd(sum_cost, threshold), &pair.cost_combo, pair.costs)) {
    return 0;
  }
  pair.cost_diff = (int64_t)(pair.cost_combo - sum_cost);
  q.queue[q.size++] = pair;
  q.UpdateHead(q.size - 1);
  return pair.cost_diff;
}

void MergePair(HistogramSet& set, const HistogramPair& best) {
  Histogram& h1 = *set.histograms[best.idx1];
  HistogramAdd(*set.histograms[best.idx2], h1, h1);
  h1.bit_cost = best.cost_combo;
  memcpy(h1.costs, best.costs, sizeof(best.costs));
  set.Remove(best.idx2);
}

void HistogramCombineGreedy(HistogramSet& set) {
  const int n = set.size;
  HistoQueue q(n * n);
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) HistoQueuePush(q, set, i, j, 0);
  }
  while (q.size > 0) {
    const HistogramPair best = q.queue[0];
    const int idx1 = best.idx1, idx2 = best.idx2;
    MergePair(set, best);
    const int moved = set.size;  // the old last index, now at idx2
    for (int j = 0; j < q.size;) {
      HistogramPair& p = q.queue[j];
      if (p.idx1 == idx1 || p.idx2 == idx1 || p.idx1 == idx2 || p.idx2 == idx2) {
        q.PopPair(j);
        continue;
      }
      if (p.idx1 == moved) p.idx1 = idx2;
      if (p.idx2 == moved) p.idx2 = idx2;
      if (p.idx1 > p.idx2) std::swap(p.idx1, p.idx2);
      q.UpdateHead(j);
      ++j;
    }
    for (int i = 0; i < set.size; ++i) {
      if (i == idx1) continue;
      HistoQueuePush(q, set, idx1, i, 0);
    }
  }
}

inline uint32_t MyRand(uint32_t* seed) {
  *seed = (uint32_t)(((uint64_t)(*seed) * 48271u) % 2147483647u);
  return *seed;
}

// Returns whether the greedy merge follows.
bool HistogramCombineStochastic(HistogramSet& set, int min_cluster_size) {
  uint32_t seed = 1;
  int tries_with_no_success = 0;
  const int outer_iters = set.size;
  const int num_tries_no_success = outer_iters / 2;
  HistoQueue q(9);
  if (set.size < min_cluster_size) return true;
  for (int iter = 0; iter < outer_iters && set.size >= min_cluster_size &&
                     ++tries_with_no_success < num_tries_no_success;
       ++iter) {
    int64_t best_cost = (q.size == 0) ? 0 : q.queue[0].cost_diff;
    const int num_used = set.size;
    const uint32_t rand_range = (uint32_t)((num_used - 1) * num_used);
    const int num_tries = num_used / 2;
    for (int j = 0; num_used >= 2 && j < num_tries; ++j) {
      const uint32_t tmp = MyRand(&seed) % rand_range;
      const uint32_t idx1 = tmp / (num_used - 1);
      uint32_t idx2 = tmp % (num_used - 1);
      if (idx2 >= idx1) ++idx2;
      const int64_t curr_cost = HistoQueuePush(q, set, (int)idx1, (int)idx2, best_cost);
      if (curr_cost < 0) {
        best_cost = curr_cost;
        if (q.size == q.max_size) break;
      }
    }
    if (q.size == 0) continue;

    const HistogramPair best = q.queue[0];
    const int best_idx1 = best.idx1, best_idx2 = best.idx2;
    MergePair(set, best);
    const int moved = set.size;
    for (int j = 0; j < q.size;) {
      HistogramPair& p = q.queue[j];
      const bool is_idx1_best = p.idx1 == best_idx1 || p.idx1 == best_idx2;
      const bool is_idx2_best = p.idx2 == best_idx1 || p.idx2 == best_idx2;
      if (is_idx1_best && is_idx2_best) {
        q.PopPair(j);
        continue;
      }
      bool do_eval = false;
      if (is_idx1_best) {
        p.idx1 = best_idx1;
        do_eval = true;
      } else if (is_idx2_best) {
        p.idx2 = best_idx1;
        do_eval = true;
      }
      if (do_eval) {
        if (p.idx1 > p.idx2) std::swap(p.idx1, p.idx2);
        if (!HistoQueueUpdatePair(*set.histograms[p.idx1], *set.histograms[p.idx2], p)) {
          q.PopPair(j);
          continue;
        }
      }
      if (p.idx1 == moved) p.idx1 = best_idx2;
      if (p.idx2 == moved) p.idx2 = best_idx2;
      if (p.idx1 > p.idx2) std::swap(p.idx1, p.idx2);
      q.UpdateHead(j);
      ++j;
    }
    tries_with_no_success = 0;
  }
  return set.size <= min_cluster_size;
}

// Maps each tile's histogram to the cluster it costs least to join, and
// rebuilds the clusters from the tiles.
void HistogramRemap(const HistogramSet& in, HistogramSet& out, std::vector<uint32_t>& symbols) {
  const int in_size = out.max_size;
  const int out_size = out.size;
  if (out_size > 1) {
    for (int i = 0; i < in_size; ++i) {
      if (in.histograms[i] == nullptr) {
        symbols[i] = symbols[i - 1];
        continue;
      }
      int best_out = 0;
      int64_t best_bits = INT64_MAX_;
      for (int k = 0; k < out_size; ++k) {
        const Histogram& o = *out.histograms[k];
        uint64_t cost, costs[5];
        if (GetCombinedHistogramEntropy(o, *in.histograms[i], SaturateAdd(o.bit_cost, best_bits), &cost, costs)) {
          best_out = k;
          best_bits = (int64_t)(cost - o.bit_cost);
        }
      }
      symbols[i] = best_out;
    }
  } else {
    for (int i = 0; i < in_size; ++i) symbols[i] = 0;
  }
  out.Clear();
  out.size = out_size;
  for (int i = 0; i < in_size; ++i) {
    if (in.histograms[i] == nullptr) continue;
    Histogram& o = *out.histograms[symbols[i]];
    HistogramAdd(*in.histograms[i], o, o);
  }
}

void GetHistoImageSymbols(int xsize, int ysize, const Refs& refs, int quality, int histogram_bits, int cache_bits,
                          HistogramSet& image_histo, Histogram*& tmp_histo, std::vector<uint32_t>& symbols) {
  const int histo_xsize = histogram_bits ? SubSampleSize(xsize, histogram_bits) : 1;
  const int histo_ysize = histogram_bits ? SubSampleSize(ysize, histogram_bits) : 1;
  const int image_histo_raw_size = histo_xsize * histo_ysize;
  HistogramSet orig_histo(image_histo_raw_size, cache_bits);

  // The tiles' histograms (HistogramBuild).
  {
    int x = 0, y = 0;
    for (const PixOrCopy& v : refs) {
      const int ix = (y >> histogram_bits) * histo_xsize + (x >> histogram_bits);
      HistogramAddSinglePixOrCopy(*orig_histo.histograms[ix], v, 0);
      x += v.len;
      while (x >= xsize) {
        x -= xsize;
        ++y;
      }
    }
  }
  // Their costs; the used ones copied to the front of image_histo, the
  // empty ones dropped from orig_histo (HistogramCopyAndAnalyze).
  image_histo.size = 0;
  for (int i = 0; i < orig_histo.max_size; ++i) {
    Histogram* const h = orig_histo.histograms[i];
    UpdateHistogramCost(*h);
    if (!h->is_used[0] && !h->is_used[1] && !h->is_used[2] && !h->is_used[3] && !h->is_used[4]) {
      orig_histo.histograms[i] = nullptr;
    } else {
      *image_histo.histograms[image_histo.size++] = *h;
    }
  }

  const int entropy_combine_num_bins = BIN_SIZE;
  const bool entropy_combine = (image_histo.size > entropy_combine_num_bins * 2) && (quality < 100);
  if (entropy_combine) {
    int combine_cost_factor = 16;
    if (quality < 90) {
      if (image_histo_raw_size > 256) combine_cost_factor /= 2;
      if (image_histo_raw_size > 512) combine_cost_factor /= 2;
      if (image_histo_raw_size > 1024) combine_cost_factor /= 2;
      if (quality <= 50) combine_cost_factor /= 2;
    }
    HistogramAnalyzeEntropyBin(image_histo);
    HistogramCombineEntropyBin(image_histo, tmp_histo, entropy_combine_num_bins, combine_cost_factor);
  }
  {
    // cubic ramp between 1 and MAX_HISTO_GREEDY
    const int threshold_size =
        (int)(1 + DivRound((int64_t)quality * quality * quality * (MAX_HISTO_GREEDY - 1), 100 * 100 * 100));
    const bool do_greedy = HistogramCombineStochastic(image_histo, threshold_size);
    if (do_greedy) HistogramCombineGreedy(image_histo);
  }
  HistogramRemap(orig_histo, image_histo, symbols);
}

// ---------------------------------------------------------------------------
// Color-cache size and the LZ77 search (backward_references_enc.c)

int CalculateBestCacheSize(const uint32_t* argb, int quality, const Refs& refs, int* best_cache_bits) {
  const int cache_bits_max = (quality <= 25) ? 0 : *best_cache_bits;
  if (cache_bits_max == 0) {
    *best_cache_bits = 0;
    return 1;
  }
  std::vector<Histogram> histos;
  std::vector<ColorCache> hashers;
  histos.reserve(cache_bits_max + 1);
  hashers.reserve(cache_bits_max + 1);
  for (int i = 0; i <= cache_bits_max; ++i) {
    histos.emplace_back(i);
    hashers.emplace_back(i == 0 ? 1 : i);
  }
  for (const PixOrCopy& v : refs) {
    if (v.mode == kLiteral) {
      const uint32_t pix = *argb++;
      const uint32_t a = (pix >> 24) & 0xff;
      const uint32_t r = (pix >> 16) & 0xff;
      const uint32_t g = (pix >> 8) & 0xff;
      const uint32_t b = (pix >> 0) & 0xff;
      int key = HashPix(pix, 32 - cache_bits_max);
      ++histos[0].blue[b];
      ++histos[0].literal[g];
      ++histos[0].red[r];
      ++histos[0].alpha[a];
      for (int i = cache_bits_max; i >= 1; --i, key >>= 1) {
        if (hashers[i].colors[key] == pix) {
          ++histos[i].literal[NUM_LITERAL_CODES + NUM_LENGTH_CODES + key];
        } else {
          hashers[i].colors[key] = pix;
          ++histos[i].blue[b];
          ++histos[i].literal[g];
          ++histos[i].red[r];
          ++histos[i].alpha[a];
        }
      }
    } else {
      int code, extra_bits, extra_bits_value;
      int len = v.len;
      uint32_t argb_prev = *argb ^ 0xffffffffu;
      PrefixEncode(len, &code, &extra_bits, &extra_bits_value);
      for (int i = 0; i <= cache_bits_max; ++i) ++histos[i].literal[NUM_LITERAL_CODES + code];
      do {
        if (*argb != argb_prev) {
          int key = HashPix(*argb, 32 - cache_bits_max);
          for (int i = cache_bits_max; i >= 1; --i, key >>= 1) hashers[i].colors[key] = *argb;
          argb_prev = *argb;
        }
        argb++;
      } while (--len != 0);
    }
  }
  uint64_t entropy_min = ~0ull;
  for (int i = 0; i <= cache_bits_max; ++i) {
    const uint64_t entropy = HistogramEstimateBits(histos[i]);
    if (i == 0 || entropy < entropy_min) {
      entropy_min = entropy;
      *best_cache_bits = i;
    }
  }
  return 1;
}

void BackwardRefsWithLocalCache(const uint32_t* argb, int cache_bits, Refs& refs) {
  int pixel_index = 0;
  ColorCache hashers(cache_bits);
  for (PixOrCopy& v : refs) {
    if (v.mode == kLiteral) {
      const uint32_t argb_literal = v.argb_or_distance;
      const int ix = hashers.Contains(argb_literal);
      if (ix >= 0) {
        v = CreateCacheIdx(ix);
      } else {
        hashers.Insert(argb_literal);
      }
      ++pixel_index;
    } else {
      for (int k = 0; k < v.len; ++k) hashers.Insert(argb[pixel_index++]);
    }
  }
}

void BackwardReferences2DLocality(int xsize, Refs& refs) {
  for (PixOrCopy& v : refs) {
    if (v.mode == kCopy) v.argb_or_distance = DistanceToPlaneCode(xsize, v.argb_or_distance);
  }
}

// ---------------------------------------------------------------------------
// The least-cost parse (backward_references_cost_enc.c)

struct CostModel {
  uint32_t alpha[256];
  uint32_t red[256];
  uint32_t blue[256];
  uint32_t distance[NUM_DISTANCE_CODES];
  std::vector<uint32_t> literal;
};

void ConvertPopulationCountTableToBitEstimates(int num_symbols, const uint32_t* population_counts,
                                               uint32_t* output) {
  uint32_t sum = 0;
  int nonzeros = 0;
  for (int i = 0; i < num_symbols; ++i) {
    sum += population_counts[i];
    if (population_counts[i] > 0) ++nonzeros;
  }
  if (nonzeros <= 1) {
    memset(output, 0, num_symbols * sizeof(*output));
  } else {
    const uint32_t logsum = FastLog2(sum);
    for (int i = 0; i < num_symbols; ++i) output[i] = logsum - FastLog2(population_counts[i]);
  }
}

void CostModelBuild(CostModel& m, int xsize, int cache_bits, const Refs& refs) {
  Histogram histo(cache_bits);
  HistogramStoreRefs(refs, xsize, histo);
  m.literal.assign(HistogramNumCodes(cache_bits), 0);
  ConvertPopulationCountTableToBitEstimates(HistogramNumCodes(histo.palette_code_bits), histo.literal.data(),
                                            m.literal.data());
  ConvertPopulationCountTableToBitEstimates(256, histo.red, m.red);
  ConvertPopulationCountTableToBitEstimates(256, histo.blue, m.blue);
  ConvertPopulationCountTableToBitEstimates(256, histo.alpha, m.alpha);
  ConvertPopulationCountTableToBitEstimates(NUM_DISTANCE_CODES, histo.distance, m.distance);
}

inline int64_t GetLiteralCost(const CostModel& m, uint32_t v) {
  return (int64_t)m.alpha[v >> 24] + m.red[(v >> 16) & 0xff] + m.literal[(v >> 8) & 0xff] + m.blue[v & 0xff];
}

inline int64_t GetCacheCost(const CostModel& m, uint32_t idx) {
  return (int64_t)m.literal[NUM_LITERAL_CODES + NUM_LENGTH_CODES + idx];
}

inline int64_t GetLengthCost(const CostModel& m, uint32_t length) {
  int code, extra_bits;
  PrefixEncodeBits(length, &code, &extra_bits);
  return (int64_t)m.literal[NUM_LITERAL_CODES + code] + ((int64_t)extra_bits << LOG_2_PRECISION_BITS);
}

inline int64_t GetDistanceCost(const CostModel& m, uint32_t distance) {
  int code, extra_bits;
  PrefixEncodeBits(distance, &code, &extra_bits);
  return (int64_t)m.distance[code] + ((int64_t)extra_bits << LOG_2_PRECISION_BITS);
}

inline void AddSingleLiteralWithCostModel(const uint32_t* argb, ColorCache* hashers, const CostModel& m, int idx,
                                          int use_color_cache, int64_t prev_cost, int64_t* cost,
                                          uint16_t* dist_array) {
  int64_t cost_val = prev_cost;
  const uint32_t color = argb[idx];
  const int ix = use_color_cache ? hashers->Contains(color) : -1;
  if (ix >= 0) {
    cost_val += DivRound(GetCacheCost(m, ix) * 68, 100);
  } else {
    if (use_color_cache) hashers->Insert(color);
    cost_val += DivRound(GetLiteralCost(m, color) * 82, 100);
  }
  if (cost[idx] > cost_val) {
    cost[idx] = cost_val;
    dist_array[idx] = 1;
  }
}

// Intervals of constant cost, ordered by start, that no two overlap: the
// cheapest copy found so far ending at each pixel ahead.
struct CostInterval {
  int64_t cost;
  int start;
  int end;  // exclusive
  int index;
  CostInterval* previous;
  CostInterval* next;
};

struct CostCacheInterval {
  int64_t cost;
  int start;
  int end;
};

const int COST_CACHE_INTERVAL_SIZE_MAX = 500;

struct CostManager {
  CostInterval* head = nullptr;
  int count = 0;
  std::vector<CostCacheInterval> cache_intervals;
  std::vector<int64_t> cost_cache;
  std::vector<int64_t> costs;
  uint16_t* dist_array = nullptr;
  std::vector<CostInterval*> pool;  // every interval made, freed at the end
  CostInterval* free_list = nullptr;

  ~CostManager() {
    for (CostInterval* p : pool) delete p;
  }

  CostInterval* NewInterval() {
    if (free_list != nullptr) {
      CostInterval* p = free_list;
      free_list = p->next;
      return p;
    }
    CostInterval* p = new CostInterval();
    pool.push_back(p);
    return p;
  }

  void Init(uint16_t* dist, int pix_count, const CostModel& m) {
    const int cost_cache_size = (pix_count > MAX_LENGTH) ? MAX_LENGTH : pix_count;
    dist_array = dist;
    cost_cache.resize(cost_cache_size);
    for (int i = 0; i < cost_cache_size; ++i) cost_cache[i] = GetLengthCost(m, i);
    cache_intervals.clear();
    CostCacheInterval cur;
    cur.start = 0;
    cur.end = 1;
    cur.cost = cost_cache[0];
    for (int i = 1; i < cost_cache_size; ++i) {
      const int64_t cost_val = cost_cache[i];
      if (cost_val != cur.cost) {
        cache_intervals.push_back(cur);
        cur.start = i;
        cur.cost = cost_val;
      }
      cur.end = i + 1;
    }
    cache_intervals.push_back(cur);
    costs.assign(pix_count, INT64_MAX_);
  }

  inline void UpdateCost(int i, int position, int64_t cost) {
    const int k = i - position;
    if (costs[i] > cost) {
      costs[i] = cost;
      dist_array[i] = (uint16_t)(k + 1);
    }
  }

  inline void UpdateCostPerInterval(int start, int end, int position, int64_t cost) {
    for (int i = start; i < end; ++i) UpdateCost(i, position, cost);
  }

  inline void ConnectIntervals(CostInterval* prev, CostInterval* next) {
    if (prev != nullptr) {
      prev->next = next;
    } else {
      head = next;
    }
    if (next != nullptr) next->previous = prev;
  }

  inline void PopInterval(CostInterval* interval) {
    if (interval == nullptr) return;
    ConnectIntervals(interval->previous, interval->next);
    interval->next = free_list;
    free_list = interval;
    --count;
  }

  inline void UpdateCostAtIndex(int i, int do_clean_intervals) {
    CostInterval* current = head;
    while (current != nullptr && current->start <= i) {
      CostInterval* const next = current->next;
      if (current->end <= i) {
        if (do_clean_intervals) PopInterval(current);
      } else {
        UpdateCost(i, current->index, current->cost);
      }
      current = next;
    }
  }

  inline void PositionOrphanInterval(CostInterval* current, CostInterval* previous) {
    if (previous == nullptr) previous = head;
    while (previous != nullptr && current->start < previous->start) previous = previous->previous;
    while (previous != nullptr && previous->next != nullptr && previous->next->start < current->start) {
      previous = previous->next;
    }
    if (previous != nullptr) {
      ConnectIntervals(current, previous->next);
    } else {
      ConnectIntervals(current, head);
    }
    ConnectIntervals(previous, current);
  }

  inline void InsertInterval(CostInterval* interval_in, int64_t cost, int position, int start, int end) {
    if (start >= end) return;
    if (count >= COST_CACHE_INTERVAL_SIZE_MAX) {
      UpdateCostPerInterval(start, end, position, cost);
      return;
    }
    CostInterval* const interval_new = NewInterval();
    interval_new->cost = cost;
    interval_new->index = position;
    interval_new->start = start;
    interval_new->end = end;
    PositionOrphanInterval(interval_new, interval_in);
    ++count;
  }

  // A copy from ``position`` of at most ``len`` pixels at ``distance_cost``.
  void PushInterval(int64_t distance_cost, int position, int len) {
    CostInterval* interval = head;
    CostInterval* interval_next;
    const int kSkipDistance = 10;
    if (len < kSkipDistance) {
      for (int j = position; j < position + len; ++j) {
        const int k = j - position;
        const int64_t cost_tmp = distance_cost + cost_cache[k];
        if (costs[j] > cost_tmp) {
          costs[j] = cost_tmp;
          dist_array[j] = (uint16_t)(k + 1);
        }
      }
      return;
    }
    for (size_t i = 0; i < cache_intervals.size() && cache_intervals[i].start < len; ++i) {
      int start = position + cache_intervals[i].start;
      const int end = position + (cache_intervals[i].end > len ? len : cache_intervals[i].end);
      const int64_t cost = distance_cost + cache_intervals[i].cost;
      for (; interval != nullptr && interval->start < end; interval = interval_next) {
        interval_next = interval->next;
        if (start >= interval->end) continue;
        if (cost >= interval->cost) {
          // worse than what is there: keep the part before it
          const int start_new = interval->end;
          InsertInterval(interval, cost, position, start, interval->start);
          start = start_new;
          if (start >= end) break;
          continue;
        }
        if (start <= interval->start) {
          if (interval->end <= end) {
            PopInterval(interval);
          } else {
            interval->start = end;
            break;
          }
        } else {
          if (end < interval->end) {
            const int end_original = interval->end;
            interval->end = start;
            InsertInterval(interval, interval->cost, interval->index, end, end_original);
            interval = interval->next;
            break;
          } else {
            interval->end = start;
          }
        }
      }
      InsertInterval(interval, cost, position, start, end);
    }
  }
};

void BackwardReferencesHashChainDistanceOnly(int xsize, int ysize, const uint32_t* argb, int cache_bits,
                                             const HashChain& hash_chain, const Refs& refs, uint16_t* dist_array) {
  const int pix_count = xsize * ysize;
  const int use_color_cache = (cache_bits > 0);
  CostModel cost_model;
  ColorCache hashers(use_color_cache ? cache_bits : 1);
  CostManager cm;
  int offset_prev = -1, len_prev = -1;
  int64_t offset_cost = -1;
  int first_offset_is_constant = -1;
  int reach = 0;

  CostModelBuild(cost_model, xsize, cache_bits, refs);
  cm.Init(dist_array, pix_count, cost_model);

  dist_array[0] = 0;
  AddSingleLiteralWithCostModel(argb, &hashers, cost_model, 0, use_color_cache, 0, cm.costs.data(), dist_array);

  for (int i = 1; i < pix_count; ++i) {
    const int64_t prev_cost = cm.costs[i - 1];
    const int offset = hash_chain.FindOffset(i);
    const int len = hash_chain.FindLength(i);

    AddSingleLiteralWithCostModel(argb, &hashers, cost_model, i, use_color_cache, prev_cost, cm.costs.data(),
                                  dist_array);

    if (len >= 2) {
      if (offset != offset_prev) {
        const int code = DistanceToPlaneCode(xsize, offset);
        offset_cost = GetDistanceCost(cost_model, code);
        first_offset_is_constant = 1;
        cm.PushInterval(prev_cost + offset_cost, i, len);
      } else {
        // The same offset as the pixel before: only a copy that reaches
        // further than the previous one adds anything.
        if (first_offset_is_constant) {
          reach = i - 1 + len_prev - 1;
          first_offset_is_constant = 0;
        }
        if (i + len - 1 > reach) {
          int offset_j = 0, len_j = 0;
          int j;
          for (j = i; j <= reach; ++j) {
            offset_j = hash_chain.FindOffset(j + 1);
            len_j = hash_chain.FindLength(j + 1);
            if (offset_j != offset) {
              offset_j = hash_chain.FindOffset(j);
              len_j = hash_chain.FindLength(j);
              break;
            }
          }
          cm.UpdateCostAtIndex(j - 1, 0);
          cm.UpdateCostAtIndex(j, 0);
          cm.PushInterval(cm.costs[j - 1] + offset_cost, j, len_j);
          reach = j + len_j - 1;
        }
      }
    }
    cm.UpdateCostAtIndex(i, 1);
    offset_prev = offset;
    len_prev = len;
  }
}

void TraceBackwardsAndFollow(int xsize, int ysize, const uint32_t* argb, int cache_bits,
                             const HashChain& hash_chain, const Refs& refs_src, Refs& refs_dst) {
  const int dist_array_size = xsize * ysize;
  std::vector<uint16_t> dist_array(dist_array_size);
  BackwardReferencesHashChainDistanceOnly(xsize, ysize, argb, cache_bits, hash_chain, refs_src, dist_array.data());
  // The path, from the end (TraceBackwards).
  std::vector<uint16_t> path;
  for (int cur = dist_array_size - 1; cur >= 0;) {
    const int k = dist_array[cur];
    path.push_back((uint16_t)k);
    cur -= k;
  }
  std::reverse(path.begin(), path.end());
  // The references along it (BackwardReferencesHashChainFollowChosenPath).
  const int use_color_cache = (cache_bits > 0);
  ColorCache hashers(use_color_cache ? cache_bits : 1);
  refs_dst.clear();
  int i = 0;
  for (uint16_t len : path) {
    if (len != 1) {
      const int offset = hash_chain.FindOffset(i);
      refs_dst.push_back(CreateCopy(offset, len));
      if (use_color_cache) {
        for (int k = 0; k < len; ++k) hashers.Insert(argb[i + k]);
      }
      i += len;
    } else {
      const int idx = use_color_cache ? hashers.Contains(argb[i]) : -1;
      if (idx >= 0) {
        refs_dst.push_back(CreateCacheIdx(idx));
      } else {
        if (use_color_cache) hashers.Insert(argb[i]);
        refs_dst.push_back(CreateLiteral(argb[i]));
      }
      ++i;
    }
  }
}

// refs[0]: the best references with a colour cache of *cache_bits_best
// bits (at most cache_bits_max), in plane codes.
void GetBackwardReferences(int width, int height, const uint32_t* argb, int quality, int lz77_types_to_try,
                           int cache_bits_max, const HashChain& hash_chain, Refs& best_refs,
                           int* cache_bits_best) {
  int lz77_type_best = 0;
  uint64_t bit_cost_best = ~0ull;
  HashChain hash_chain_box;
  Refs refs_tmp;
  Histogram histo(MAX_COLOR_CACHE_BITS);
  for (int lz77_type = 1; lz77_types_to_try; lz77_types_to_try &= ~lz77_type, lz77_type <<= 1) {
    if ((lz77_types_to_try & lz77_type) == 0) continue;
    switch (lz77_type) {
      case kLZ77RLE:
        BackwardReferencesRle(width, height, argb, refs_tmp);
        break;
      case kLZ77Standard:
        BackwardReferencesLz77(width, height, argb, hash_chain, refs_tmp);
        break;
      case kLZ77Box:
        BackwardReferencesLz77Box(width, height, argb, hash_chain, hash_chain_box, refs_tmp);
        break;
    }
    int cache_bits = cache_bits_max;
    CalculateBestCacheSize(argb, quality, refs_tmp, &cache_bits);
    if (cache_bits > 0) BackwardRefsWithLocalCache(argb, cache_bits, refs_tmp);
    HistogramCreate(histo, refs_tmp, cache_bits);
    const uint64_t bit_cost = HistogramEstimateBits(histo);
    if (bit_cost < bit_cost_best) {
      std::swap(refs_tmp, best_refs);
      bit_cost_best = bit_cost;
      lz77_type_best = lz77_type;
      *cache_bits_best = cache_bits;
    }
  }
  // The least-cost parse, where the best is an LZ77 one.
  if ((lz77_type_best == kLZ77Standard || lz77_type_best == kLZ77Box) && quality >= 25) {
    const HashChain& hash_chain_tmp = (lz77_type_best == kLZ77Standard) ? hash_chain : hash_chain_box;
    TraceBackwardsAndFollow(width, height, argb, *cache_bits_best, hash_chain_tmp, best_refs, refs_tmp);
    HistogramCreate(histo, refs_tmp, *cache_bits_best);
    const uint64_t bit_cost_trace = HistogramEstimateBits(histo);
    if (bit_cost_trace < bit_cost_best) std::swap(refs_tmp, best_refs);
  }
  BackwardReferences2DLocality(width, best_refs);
}

// ---------------------------------------------------------------------------
// Prefix codes (utils/huffman_encode_utils.c)

struct HuffmanTreeCode {
  int num_symbols = 0;
  std::vector<uint8_t> code_lengths;
  std::vector<uint16_t> codes;
};

struct HuffmanTreeToken {
  uint8_t code;
  uint8_t extra_bits;
};

struct HuffmanTree {
  uint32_t total_count;
  int value;
  int pool_index_left;
  int pool_index_right;
};

inline bool ValuesShouldBeCollapsedToStrideAverage(int a, int b) { return abs(a - b) < 4; }

// Evens out the counts so that the code lengths run-length code better.
void OptimizeHuffmanForRle(int length, uint8_t* good_for_rle, uint32_t* counts) {
  int i;
  for (; length >= 0; --length) {
    if (length == 0) return;  // all zeros
    if (counts[length - 1] != 0) break;
  }
  {
    uint32_t symbol = counts[0];
    int stride = 0;
    for (i = 0; i < length + 1; ++i) {
      if (i == length || counts[i] != symbol) {
        if ((symbol == 0 && stride >= 5) || (symbol != 0 && stride >= 7)) {
          for (int k = 0; k < stride; ++k) good_for_rle[i - k - 1] = 1;
        }
        stride = 1;
        if (i != length) symbol = counts[i];
      } else {
        ++stride;
      }
    }
  }
  {
    uint32_t stride = 0;
    uint32_t limit = counts[0];
    uint32_t sum = 0;
    for (i = 0; i < length + 1; ++i) {
      if (i == length || good_for_rle[i] || (i != 0 && good_for_rle[i - 1]) ||
          !ValuesShouldBeCollapsedToStrideAverage(counts[i], limit)) {
        if (stride >= 4 || (stride >= 3 && sum == 0)) {
          uint32_t count = (sum + stride / 2) / stride;
          if (count < 1) count = 1;
          if (sum == 0) count = 0;
          for (uint32_t k = 0; k < stride; ++k) counts[i - k - 1] = count;
        }
        stride = 0;
        sum = 0;
        if (i < length - 3) {
          limit = (counts[i] + counts[i + 1] + counts[i + 2] + counts[i + 3] + 2) / 4;
        } else if (i < length) {
          limit = counts[i];
        } else {
          limit = 0;
        }
      }
      ++stride;
      if (i != length) {
        sum += counts[i];
        if (stride >= 4) limit = (sum + stride / 2) / stride;
      }
    }
  }
}

int CompareHuffmanTrees(const void* ptr1, const void* ptr2) {
  const HuffmanTree* const t1 = (const HuffmanTree*)ptr1;
  const HuffmanTree* const t2 = (const HuffmanTree*)ptr2;
  if (t1->total_count > t2->total_count) return -1;
  if (t1->total_count < t2->total_count) return 1;
  return (t1->value < t2->value) ? -1 : 1;
}

void SetBitDepths(const HuffmanTree* tree, const HuffmanTree* pool, uint8_t* bit_depths, int level) {
  if (tree->pool_index_left >= 0) {
    SetBitDepths(&pool[tree->pool_index_left], pool, bit_depths, level + 1);
    SetBitDepths(&pool[tree->pool_index_right], pool, bit_depths, level + 1);
  } else {
    bit_depths[tree->value] = level;
  }
}

// Huffman's tree with every count raised to count_min, count_min doubled
// until no code is longer than tree_depth_limit.
void GenerateOptimalTree(const uint32_t* histogram, int histogram_size, HuffmanTree* tree, int tree_depth_limit,
                         uint8_t* bit_depths) {
  int tree_size_orig = 0;
  for (int i = 0; i < histogram_size; ++i) {
    if (histogram[i] != 0) ++tree_size_orig;
  }
  if (tree_size_orig == 0) return;
  HuffmanTree* const tree_pool = tree + tree_size_orig;
  for (uint32_t count_min = 1;; count_min *= 2) {
    int tree_size = tree_size_orig;
    int idx = 0;
    for (int j = 0; j < histogram_size; ++j) {
      if (histogram[j] != 0) {
        const uint32_t count = (histogram[j] < count_min) ? count_min : histogram[j];
        tree[idx].total_count = count;
        tree[idx].value = j;
        tree[idx].pool_index_left = -1;
        tree[idx].pool_index_right = -1;
        ++idx;
      }
    }
    qsort(tree, tree_size, sizeof(*tree), CompareHuffmanTrees);
    if (tree_size > 1) {
      int tree_pool_size = 0;
      while (tree_size > 1) {
        tree_pool[tree_pool_size++] = tree[tree_size - 1];
        tree_pool[tree_pool_size++] = tree[tree_size - 2];
        const uint32_t count = tree_pool[tree_pool_size - 1].total_count + tree_pool[tree_pool_size - 2].total_count;
        tree_size -= 2;
        int k;
        for (k = 0; k < tree_size; ++k) {
          if (tree[k].total_count <= count) break;
        }
        memmove(tree + (k + 1), tree + k, (tree_size - k) * sizeof(*tree));
        tree[k].total_count = count;
        tree[k].value = -1;
        tree[k].pool_index_left = tree_pool_size - 1;
        tree[k].pool_index_right = tree_pool_size - 2;
        tree_size = tree_size + 1;
      }
      SetBitDepths(&tree[0], tree_pool, bit_depths, 0);
    } else if (tree_size == 1) {
      bit_depths[tree[0].value] = 1;
    }
    int max_depth = bit_depths[0];
    for (int j = 1; j < histogram_size; ++j) {
      if (max_depth < bit_depths[j]) max_depth = bit_depths[j];
    }
    if (max_depth <= tree_depth_limit) break;
  }
}

const uint8_t kReversedBits[16] = {0x0, 0x8, 0x4, 0xc, 0x2, 0xa, 0x6, 0xe,
                                   0x1, 0x9, 0x5, 0xd, 0x3, 0xb, 0x7, 0xf};

uint32_t ReverseBits(int num_bits, uint32_t bits) {
  uint32_t retval = 0;
  int i = 0;
  while (i < num_bits) {
    i += 4;
    retval |= kReversedBits[bits & 0xf] << (MAX_ALLOWED_CODE_LENGTH + 1 - i);
    bits >>= 4;
  }
  retval >>= (MAX_ALLOWED_CODE_LENGTH + 1 - num_bits);
  return retval;
}

void ConvertBitDepthsToSymbols(HuffmanTreeCode& tree) {
  uint32_t next_code[MAX_ALLOWED_CODE_LENGTH + 1];
  int depth_count[MAX_ALLOWED_CODE_LENGTH + 1] = {0};
  const int len = tree.num_symbols;
  for (int i = 0; i < len; ++i) ++depth_count[tree.code_lengths[i]];
  depth_count[0] = 0;
  next_code[0] = 0;
  {
    uint32_t code = 0;
    for (int i = 1; i <= MAX_ALLOWED_CODE_LENGTH; ++i) {
      code = (code + depth_count[i - 1]) << 1;
      next_code[i] = code;
    }
  }
  for (int i = 0; i < len; ++i) {
    const int code_length = tree.code_lengths[i];
    tree.codes[i] = (uint16_t)ReverseBits(code_length, next_code[code_length]++);
  }
}

// ``histogram`` is modified (OptimizeHuffmanForRle).
void CreateHuffmanTree(uint32_t* histogram, int tree_depth_limit, HuffmanTreeCode& code) {
  const int num_symbols = code.num_symbols;
  std::vector<uint8_t> buf_rle(num_symbols, 0);
  std::vector<HuffmanTree> huff_tree(3 * num_symbols);
  code.code_lengths.assign(num_symbols, 0);
  code.codes.assign(num_symbols, 0);
  OptimizeHuffmanForRle(num_symbols, buf_rle.data(), histogram);
  GenerateOptimalTree(histogram, num_symbols, huff_tree.data(), tree_depth_limit, code.code_lengths.data());
  ConvertBitDepthsToSymbols(code);
}

HuffmanTreeToken* CodeRepeatedValues(int repetitions, HuffmanTreeToken* tokens, int value, int prev_value) {
  if (value != prev_value) {
    tokens->code = value;
    tokens->extra_bits = 0;
    ++tokens;
    --repetitions;
  }
  while (repetitions >= 1) {
    if (repetitions < 3) {
      for (int i = 0; i < repetitions; ++i) {
        tokens->code = value;
        tokens->extra_bits = 0;
        ++tokens;
      }
      break;
    } else if (repetitions < 7) {
      tokens->code = 16;
      tokens->extra_bits = repetitions - 3;
      ++tokens;
      break;
    } else {
      tokens->code = 16;
      tokens->extra_bits = 3;
      ++tokens;
      repetitions -= 6;
    }
  }
  return tokens;
}

HuffmanTreeToken* CodeRepeatedZeros(int repetitions, HuffmanTreeToken* tokens) {
  while (repetitions >= 1) {
    if (repetitions < 3) {
      for (int i = 0; i < repetitions; ++i) {
        tokens->code = 0;
        tokens->extra_bits = 0;
        ++tokens;
      }
      break;
    } else if (repetitions < 11) {
      tokens->code = 17;
      tokens->extra_bits = repetitions - 3;
      ++tokens;
      break;
    } else if (repetitions < 139) {
      tokens->code = 18;
      tokens->extra_bits = repetitions - 11;
      ++tokens;
      break;
    } else {
      tokens->code = 18;
      tokens->extra_bits = 0x7f;  // 138 zeros
      ++tokens;
      repetitions -= 138;
    }
  }
  return tokens;
}

int CreateCompressedHuffmanTree(const HuffmanTreeCode& tree, HuffmanTreeToken* tokens) {
  HuffmanTreeToken* const starting_token = tokens;
  const int depth_size = tree.num_symbols;
  int prev_value = 8;  // the initial value for the run-length coding
  int i = 0;
  while (i < depth_size) {
    const int value = tree.code_lengths[i];
    int k = i + 1;
    while (k < depth_size && tree.code_lengths[k] == value) ++k;
    const int runs = k - i;
    if (value == 0) {
      tokens = CodeRepeatedZeros(runs, tokens);
    } else {
      tokens = CodeRepeatedValues(runs, tokens, value, prev_value);
      prev_value = value;
    }
    i += runs;
  }
  return (int)(tokens - starting_token);
}

void StoreHuffmanTreeOfHuffmanTreeToBitMask(BitWriter& bw, const uint8_t* code_length_bitdepth) {
  static const uint8_t kStorageOrder[CODE_LENGTH_CODES] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                                           7, 8, 9, 10, 11, 12, 13, 14, 15};
  int codes_to_store = CODE_LENGTH_CODES;
  for (; codes_to_store > 4; --codes_to_store) {
    if (code_length_bitdepth[kStorageOrder[codes_to_store - 1]] != 0) break;
  }
  bw.Put(codes_to_store - 4, 4);
  for (int i = 0; i < codes_to_store; ++i) bw.Put(code_length_bitdepth[kStorageOrder[i]], 3);
}

void ClearHuffmanTreeIfOnlyOneSymbol(HuffmanTreeCode& code) {
  int count = 0;
  for (int k = 0; k < code.num_symbols; ++k) {
    if (code.code_lengths[k] != 0) {
      ++count;
      if (count > 1) return;
    }
  }
  for (int k = 0; k < code.num_symbols; ++k) {
    code.code_lengths[k] = 0;
    code.codes[k] = 0;
  }
}

void StoreHuffmanTreeToBitMask(BitWriter& bw, const HuffmanTreeToken* tokens, int num_tokens,
                               const HuffmanTreeCode& code) {
  for (int i = 0; i < num_tokens; ++i) {
    const int ix = tokens[i].code;
    const int extra_bits = tokens[i].extra_bits;
    bw.Put(code.codes[ix], code.code_lengths[ix]);
    switch (ix) {
      case 16: bw.Put(extra_bits, 2); break;
      case 17: bw.Put(extra_bits, 3); break;
      case 18: bw.Put(extra_bits, 7); break;
    }
  }
}

void StoreFullHuffmanCode(BitWriter& bw, const HuffmanTreeCode& tree) {
  HuffmanTreeCode huffman_code;
  huffman_code.num_symbols = CODE_LENGTH_CODES;
  std::vector<HuffmanTreeToken> tokens(tree.num_symbols);
  bw.Put(0, 1);
  const int num_tokens = CreateCompressedHuffmanTree(tree, tokens.data());
  {
    uint32_t histogram[CODE_LENGTH_CODES] = {0};
    for (int i = 0; i < num_tokens; ++i) ++histogram[tokens[i].code];
    CreateHuffmanTree(histogram, 7, huffman_code);
  }
  StoreHuffmanTreeOfHuffmanTreeToBitMask(bw, huffman_code.code_lengths.data());
  ClearHuffmanTreeIfOnlyOneSymbol(huffman_code);
  {
    int trailing_zero_bits = 0;
    int trimmed_length = num_tokens;
    int i = num_tokens;
    while (i-- > 0) {
      const int ix = tokens[i].code;
      if (ix == 0 || ix == 17 || ix == 18) {
        --trimmed_length;  // trailing zeros need not be written
        trailing_zero_bits += huffman_code.code_lengths[ix];
        if (ix == 17) {
          trailing_zero_bits += 3;
        } else if (ix == 18) {
          trailing_zero_bits += 7;
        }
      } else {
        break;
      }
    }
    const int write_trimmed_length = (trimmed_length > 1 && trailing_zero_bits > 12);
    const int length = write_trimmed_length ? trimmed_length : num_tokens;
    bw.Put(write_trimmed_length, 1);
    if (write_trimmed_length) {
      if (trimmed_length == 2) {
        bw.Put(0, 3 + 2);  // nbitpairs 1, trimmed_length 2
      } else {
        const int nbits = BitsLog2Floor(trimmed_length - 2);
        const int nbitpairs = nbits / 2 + 1;
        bw.Put(nbitpairs - 1, 3);
        bw.Put(trimmed_length - 2, nbitpairs * 2);
      }
    }
    StoreHuffmanTreeToBitMask(bw, tokens.data(), length, huffman_code);
  }
}

void StoreHuffmanCode(BitWriter& bw, const HuffmanTreeCode& huffman_code) {
  int count = 0;
  int symbols[2] = {0, 0};
  const int kMaxBits = 8;
  const int kMaxSymbol = 1 << kMaxBits;
  for (int i = 0; i < huffman_code.num_symbols && count < 3; ++i) {
    if (huffman_code.code_lengths[i] != 0) {
      if (count < 2) symbols[count] = i;
      ++count;
    }
  }
  if (count == 0) {  // an empty code: one symbol, 0
    bw.Put(0x01, 4);
  } else if (count <= 2 && symbols[0] < kMaxSymbol && symbols[1] < kMaxSymbol) {
    bw.Put(1, 1);  // the simple code of one or two symbols
    bw.Put(count - 1, 1);
    if (symbols[0] <= 1) {
      bw.Put(0, 1);
      bw.Put(symbols[0], 1);
    } else {
      bw.Put(1, 1);
      bw.Put(symbols[0], 8);
    }
    if (count == 2) bw.Put(symbols[1], 8);
  } else {
    StoreFullHuffmanCode(bw, huffman_code);
  }
}

std::vector<HuffmanTreeCode> GetHuffBitLengthsAndCodes(const HistogramSet& set) {
  std::vector<HuffmanTreeCode> codes(5 * set.size);
  for (int i = 0; i < set.size; ++i) {
    const Histogram& h = *set.histograms[i];
    for (int k = 0; k < 5; ++k) {
      int len;
      const uint32_t* pop = h.Population(k, &len);
      std::vector<uint32_t> counts(pop, pop + len);
      HuffmanTreeCode& c = codes[5 * i + k];
      c.num_symbols = len;
      CreateHuffmanTree(counts.data(), 15, c);
    }
  }
  return codes;
}

inline void WriteHuffmanCode(BitWriter& bw, const HuffmanTreeCode& code, int code_index) {
  bw.Put(code.codes[code_index], code.code_lengths[code_index]);
}

void StoreImageToBitMask(BitWriter& bw, int width, int histo_bits, const Refs& refs,
                         const uint32_t* histogram_symbols, const std::vector<HuffmanTreeCode>& huffman_codes) {
  const int histo_xsize = histo_bits ? SubSampleSize(width, histo_bits) : 1;
  const int tile_mask = (histo_bits == 0) ? 0 : -(1 << histo_bits);
  int x = 0;
  int y = 0;
  int tile_x = x & tile_mask;
  int tile_y = y & tile_mask;
  int histogram_ix = (histogram_symbols[0] >> 8) & 0xffff;
  const HuffmanTreeCode* codes = huffman_codes.data() + 5 * histogram_ix;
  for (const PixOrCopy& v : refs) {
    if ((tile_x != (x & tile_mask)) || (tile_y != (y & tile_mask))) {
      tile_x = x & tile_mask;
      tile_y = y & tile_mask;
      histogram_ix = (histogram_symbols[(y >> histo_bits) * histo_xsize + (x >> histo_bits)] >> 8) & 0xffff;
      codes = huffman_codes.data() + 5 * histogram_ix;
    }
    if (v.mode == kLiteral) {
      static const uint8_t order[] = {1, 2, 0, 3};
      for (int k = 0; k < 4; ++k) {
        const int code = (v.argb_or_distance >> (order[k] * 8)) & 0xff;
        WriteHuffmanCode(bw, codes[k], code);
      }
    } else if (v.mode == kCacheIdx) {
      WriteHuffmanCode(bw, codes[0], NUM_LITERAL_CODES + NUM_LENGTH_CODES + v.argb_or_distance);
    } else {
      int bits, n_bits, code;
      PrefixEncode(v.len, &code, &n_bits, &bits);
      WriteHuffmanCode(bw, codes[0], NUM_LITERAL_CODES + code);
      bw.Put(bits, n_bits);
      PrefixEncode(v.argb_or_distance, &code, &n_bits, &bits);
      WriteHuffmanCode(bw, codes[4], code);
      bw.Put(bits, n_bits);
    }
    x += v.len;
    while (x >= width) {
      x -= width;
      ++y;
    }
  }
}

// An image coded with one set of codes and no colour cache (the palette,
// the predictor modes, the histogram image).
void EncodeImageNoHuffman(BitWriter& bw, const uint32_t* argb, int width, int height, int quality) {
  HashChain hash_chain;
  Refs refs;
  int cache_bits = 0;
  HashChainFill(hash_chain, quality, argb, width, height);
  GetBackwardReferences(width, height, argb, quality, kLZ77Standard | kLZ77RLE, 0, hash_chain, refs, &cache_bits);
  HistogramSet histogram_image(1, cache_bits);
  histogram_image.Clear();
  HistogramStoreRefs(refs, 0, *histogram_image.histograms[0]);
  std::vector<HuffmanTreeCode> huffman_codes = GetHuffBitLengthsAndCodes(histogram_image);
  bw.Put(0, 1);  // no colour cache
  for (int i = 0; i < 5; ++i) {
    StoreHuffmanCode(bw, huffman_codes[i]);
    ClearHuffmanTreeIfOnlyOneSymbol(huffman_codes[i]);
  }
  const uint32_t histogram_symbols[1] = {0};
  StoreImageToBitMask(bw, width, 0, refs, histogram_symbols, huffman_codes);
}

// Sub-samples an image of tiles where every 2x2 (4x4, ...) block holds one
// value, up to max_bits.
void OptimizeSampling(uint32_t* image, int full_width, int full_height, int bits, int max_bits,
                      int* best_bits_out) {
  int width = SubSampleSize(full_width, bits);
  int height = SubSampleSize(full_height, bits);
  int old_width, x, y, square_size;
  int best_bits = bits;
  *best_bits_out = bits;
  // the rows first
  while (best_bits < max_bits) {
    const int new_square_size = 1 << (best_bits + 1 - bits);
    int is_good = 1;
    square_size = 1 << (best_bits - bits);
    for (y = 0; y + square_size < height; y += new_square_size) {
      if (memcmp(&image[y * width], &image[(y + square_size) * width], width * sizeof(*image)) != 0) {
        is_good = 0;
        break;
      }
    }
    if (is_good) {
      ++best_bits;
    } else {
      break;
    }
  }
  if (best_bits == bits) return;
  // then the columns
  while (best_bits > bits) {
    int is_good = 1;
    square_size = 1 << (best_bits - bits);
    for (y = 0; is_good && y < height; ++y) {
      for (x = 0; is_good && x < width; x += square_size) {
        for (int i = x + 1; i < std::min(x + square_size, width); ++i) {
          if (image[y * width + i] != image[y * width + x]) {
            is_good = 0;
            break;
          }
        }
      }
    }
    if (is_good) break;
    --best_bits;
  }
  if (best_bits == bits) return;
  old_width = width;
  square_size = 1 << (best_bits - bits);
  width = SubSampleSize(full_width, best_bits);
  height = SubSampleSize(full_height, best_bits);
  for (y = 0; y < height; ++y) {
    for (x = 0; x < width; ++x) image[y * width + x] = image[square_size * (y * old_width + x)];
  }
  *best_bits_out = best_bits;
}

struct CrunchSubConfig {
  int lz77;
  int do_no_cache;
};

void EncodeImageInternal(BitWriter& bw, const std::vector<uint32_t>& argb, int width, int height, int quality,
                         const std::vector<CrunchSubConfig>& sub_configs, int* cache_bits, int histogram_bits_in) {
  const int histogram_image_xysize =
      SubSampleSize(width, histogram_bits_in) * SubSampleSize(height, histogram_bits_in);
  HashChain hash_chain;
  HashChainFill(hash_chain, quality, argb.data(), width, height);
  const int cache_bits_init = (*cache_bits == 0) ? MAX_COLOR_CACHE_BITS : *cache_bits;
  const BitWriter bw_init = bw;
  BitWriter bw_best;
  size_t bw_size_best = ~(size_t)0;
  for (const CrunchSubConfig& sub_config : sub_configs) {
    Refs refs;
    int cache_bits_best = 0;
    GetBackwardReferences(width, height, argb.data(), quality, sub_config.lz77, cache_bits_init, hash_chain, refs,
                          &cache_bits_best);
    const int cache_bits_tmp = cache_bits_best;
    int histogram_bits = histogram_bits_in;
    bw = bw_init;
    HistogramSet histogram_image(histogram_image_xysize, cache_bits_tmp);
    Histogram tmp_histo_storage(cache_bits_tmp);
    Histogram* tmp_histo = &tmp_histo_storage;
    std::vector<uint32_t> histogram_argb(histogram_image_xysize, 0);
    GetHistoImageSymbols(width, height, refs, quality, histogram_bits, cache_bits_tmp, histogram_image, tmp_histo,
                         histogram_argb);
    std::vector<HuffmanTreeCode> huffman_codes = GetHuffBitLengthsAndCodes(histogram_image);
    if (cache_bits_tmp > 0) {
      bw.Put(1, 1);
      bw.Put(cache_bits_tmp, 4);
    } else {
      bw.Put(0, 1);
    }
    // the histogram image (the meta prefix codes)
    uint32_t histogram_image_size = 0;
    for (int i = 0; i < histogram_image_xysize; ++i) {
      if (histogram_argb[i] >= histogram_image_size) histogram_image_size = histogram_argb[i] + 1;
      histogram_argb[i] <<= 8;
    }
    const int write_histogram_image = (histogram_image_size > 1);
    bw.Put(write_histogram_image, 1);
    if (write_histogram_image) {
      OptimizeSampling(histogram_argb.data(), width, height, histogram_bits_in, MAX_HUFFMAN_BITS, &histogram_bits);
      bw.Put(histogram_bits - 2, 3);
      EncodeImageNoHuffman(bw, histogram_argb.data(), SubSampleSize(width, histogram_bits),
                           SubSampleSize(height, histogram_bits), quality);
    }
    for (uint32_t i = 0; i < 5 * histogram_image_size; ++i) {
      StoreHuffmanCode(bw, huffman_codes[i]);
      ClearHuffmanTreeIfOnlyOneSymbol(huffman_codes[i]);
    }
    StoreImageToBitMask(bw, width, histogram_bits, refs, histogram_argb.data(), huffman_codes);
    if (bw.NumBytes() < bw_size_best) {
      bw_size_best = bw.NumBytes();
      *cache_bits = cache_bits_tmp;
      bw_best = bw;
    }
  }
  bw = bw_best;
}

// ---------------------------------------------------------------------------
// The analysis (vp8l_enc.c)

int ClampBits(int width, int height, int bits, int min_bits, int max_bits, int image_size_max) {
  int image_size;
  bits = (bits < min_bits) ? min_bits : (bits > max_bits) ? max_bits : bits;
  image_size = SubSampleSize(width, bits) * SubSampleSize(height, bits);
  while (bits < max_bits && image_size > image_size_max) {
    ++bits;
    image_size = SubSampleSize(width, bits) * SubSampleSize(height, bits);
  }
  // where the bits leave one tile, the fewest that do
  while (bits > min_bits && image_size == 1) {
    image_size = SubSampleSize(width, bits - 1) * SubSampleSize(height, bits - 1);
    if (image_size != 1) break;
    --bits;
  }
  return bits;
}

int GetHistoBits(int method, int use_palette, int width, int height) {
  const int histo_bits = (use_palette ? 9 : 7) - method;
  return ClampBits(width, height, histo_bits, MIN_HUFFMAN_BITS, MAX_HUFFMAN_BITS, MAX_HUFF_IMAGE_SIZE);
}

int GetTransformBits(int method, int histo_bits) {
  const int max_transform_bits = (method < 4) ? 6 : (method > 4) ? 4 : 5;
  return (histo_bits > max_transform_bits) ? max_transform_bits : histo_bits;
}

enum {
  kHistoAlpha = 0, kHistoAlphaPred, kHistoGreen, kHistoGreenPred, kHistoRed, kHistoRedPred, kHistoBlue,
  kHistoBluePred, kHistoRedSubGreen, kHistoRedPredSubGreen, kHistoBlueSubGreen, kHistoBluePredSubGreen,
  kHistoPalette, kHistoTotal
};

inline void AddSingleSubGreen(uint32_t p, uint32_t* r, uint32_t* b) {
  const int green = (int)p >> 8;
  ++r[(((int)p >> 16) - green) & 0xff];
  ++b[(((int)p >> 0) - green) & 0xff];
}

inline void AddSingle(uint32_t p, uint32_t* a, uint32_t* r, uint32_t* g, uint32_t* b) {
  ++a[(p >> 24) & 0xff];
  ++r[(p >> 16) & 0xff];
  ++g[(p >> 8) & 0xff];
  ++b[(p >> 0) & 0xff];
}

inline uint8_t HashPixPalette(uint32_t pix) {
  return (uint8_t)(((((uint64_t)pix + (pix >> 19)) * 0x39c5fba7ull) & 0xffffffffu) >> 24);
}

// The entropy mode libwebp guesses best, and whether its red and blue are
// all 0.
void AnalyzeEntropy(const uint32_t* argb, int width, int height, int use_palette, int palette_size,
                    int transform_bits, int* min_entropy_ix, int* red_and_blue_always_zero) {
  if (use_palette && palette_size <= 16) {
    *min_entropy_ix = kPalette;
    *red_and_blue_always_zero = 1;
    return;
  }
  std::vector<uint32_t> histo((size_t)kHistoTotal * 256, 0);
  auto category = [&histo](int k) { return histo.data() + (size_t)k * 256; };
  const uint32_t* prev_row = nullptr;
  const uint32_t* curr_row = argb;
  uint32_t pix_prev = argb[0];
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      const uint32_t pix = curr_row[x];
      const uint32_t pix_diff = SubPixels(pix, pix_prev);
      pix_prev = pix;
      if ((pix_diff == 0) || (prev_row != nullptr && pix == prev_row[x])) continue;
      AddSingle(pix, category(kHistoAlpha), category(kHistoRed), category(kHistoGreen), category(kHistoBlue));
      AddSingle(pix_diff, category(kHistoAlphaPred), category(kHistoRedPred), category(kHistoGreenPred),
                category(kHistoBluePred));
      AddSingleSubGreen(pix, category(kHistoRedSubGreen), category(kHistoBlueSubGreen));
      AddSingleSubGreen(pix_diff, category(kHistoRedPredSubGreen), category(kHistoBluePredSubGreen));
      ++category(kHistoPalette)[HashPixPalette(pix)];
    }
    prev_row = curr_row;
    curr_row += width;
  }
  uint64_t entropy_comp[kHistoTotal];
  uint64_t entropy[6];
  const int last_mode_to_analyze = use_palette ? kPalette : kSpatialSubGreen;
  // One zero in each predicted histogram: the pix_diff == 0 test drops
  // them too well.
  ++category(kHistoRedPredSubGreen)[0];
  ++category(kHistoBluePredSubGreen)[0];
  ++category(kHistoRedPred)[0];
  ++category(kHistoGreenPred)[0];
  ++category(kHistoBluePred)[0];
  ++category(kHistoAlphaPred)[0];
  for (int j = 0; j < kHistoTotal; ++j) entropy_comp[j] = BitsEntropy(category(j), 256);
  entropy[kDirect] = entropy_comp[kHistoAlpha] + entropy_comp[kHistoRed] + entropy_comp[kHistoGreen] +
                     entropy_comp[kHistoBlue];
  entropy[kSpatial] = entropy_comp[kHistoAlphaPred] + entropy_comp[kHistoRedPred] +
                      entropy_comp[kHistoGreenPred] + entropy_comp[kHistoBluePred];
  entropy[kSubGreen] = entropy_comp[kHistoAlpha] + entropy_comp[kHistoRedSubGreen] +
                       entropy_comp[kHistoGreen] + entropy_comp[kHistoBlueSubGreen];
  entropy[kSpatialSubGreen] = entropy_comp[kHistoAlphaPred] + entropy_comp[kHistoRedPredSubGreen] +
                              entropy_comp[kHistoGreenPred] + entropy_comp[kHistoBluePredSubGreen];
  entropy[kPalette] = entropy_comp[kHistoPalette];
  // The transforms' own data: 14 predictors, 24 colour-transform
  // elements, 8 bits a palette entry.
  entropy[kSpatial] +=
      (uint64_t)SubSampleSize(width, transform_bits) * SubSampleSize(height, transform_bits) * FastLog2(14);
  entropy[kSpatialSubGreen] +=
      (uint64_t)SubSampleSize(width, transform_bits) * SubSampleSize(height, transform_bits) * FastLog2(24);
  entropy[kPalette] += ((uint64_t)palette_size * 8ull) << LOG_2_PRECISION_BITS;

  *min_entropy_ix = kDirect;
  for (int k = kDirect + 1; k <= last_mode_to_analyze; ++k) {
    if (entropy[*min_entropy_ix] > entropy[k]) *min_entropy_ix = k;
  }
  *red_and_blue_always_zero = 1;
  {
    static const uint8_t kHistoPairs[5][2] = {{kHistoRed, kHistoBlue},
                                              {kHistoRedPred, kHistoBluePred},
                                              {kHistoRedSubGreen, kHistoBlueSubGreen},
                                              {kHistoRedPredSubGreen, kHistoBluePredSubGreen},
                                              {kHistoRed, kHistoBlue}};
    const uint32_t* const red_histo = category(kHistoPairs[*min_entropy_ix][0]);
    const uint32_t* const blue_histo = category(kHistoPairs[*min_entropy_ix][1]);
    for (int i = 1; i < 256; ++i) {
      if ((red_histo[i] | blue_histo[i]) != 0) {
        *red_and_blue_always_zero = 0;
        break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The palette (utils/palette.c, vp8l_enc.c)

// The colours in increasing order (WebPGetColorPalette), or 257 if more
// than 256.
int GetColorPalette(const std::vector<uint32_t>& argb, uint32_t* palette) {
  std::vector<uint32_t> colors(argb);
  std::sort(colors.begin(), colors.end());
  colors.erase(std::unique(colors.begin(), colors.end()), colors.end());
  if ((int)colors.size() > MAX_PALETTE_SIZE) return MAX_PALETTE_SIZE + 1;
  std::copy(colors.begin(), colors.end(), palette);
  return (int)colors.size();
}

int PaletteHasNonMonotonousDeltas(const uint32_t* palette, int num_colors) {
  uint8_t sign_found = 0x00;
  uint32_t predict = 0x000000;
  for (int i = 0; i < num_colors; ++i) {
    const uint32_t diff = SubPixels(palette[i], predict);
    const uint8_t rd = (diff >> 16) & 0xff;
    const uint8_t gd = (diff >> 8) & 0xff;
    const uint8_t bd = (diff >> 0) & 0xff;
    if (rd != 0x00) sign_found |= (rd < 0x80) ? 1 : 2;
    if (gd != 0x00) sign_found |= (gd < 0x80) ? 8 : 16;
    if (bd != 0x00) sign_found |= (bd < 0x80) ? 64 : 128;
    predict = palette[i];
  }
  return (sign_found & (sign_found << 1)) != 0;  // two consequent signs
}

inline uint32_t PaletteComponentDistance(uint32_t v) { return (v <= 128) ? v : (256 - v); }

inline uint32_t PaletteColorDistance(uint32_t col1, uint32_t col2) {
  const uint32_t diff = SubPixels(col1, col2);
  const int kMoreWeightForRGBThanForAlpha = 9;
  uint32_t score;
  score = PaletteComponentDistance((diff >> 0) & 0xff);
  score += PaletteComponentDistance((diff >> 8) & 0xff);
  score += PaletteComponentDistance((diff >> 16) & 0xff);
  score *= kMoreWeightForRGBThanForAlpha;
  score += PaletteComponentDistance((diff >> 24) & 0xff);
  return score;
}

// kMinimizeDelta: the sorted palette, or where its deltas change sign, a
// greedy walk to the nearest colour each step.
void PaletteSortMinimizeDeltas(const uint32_t* palette_sorted, int num_colors, uint32_t* palette) {
  uint32_t predict = 0x00000000;
  memcpy(palette, palette_sorted, num_colors * sizeof(*palette));
  if (!PaletteHasNonMonotonousDeltas(palette_sorted, num_colors)) return;
  for (int i = 0; i < num_colors; ++i) {
    int best_ix = i;
    uint32_t best_score = ~0U;
    for (int k = i; k < num_colors; ++k) {
      const uint32_t cur_score = PaletteColorDistance(palette[k], predict);
      if (best_score > cur_score) {
        best_score = cur_score;
        best_ix = k;
      }
    }
    std::swap(palette[best_ix], palette[i]);
    predict = palette[i];
  }
}

void EncodePalette(BitWriter& bw, const uint32_t* palette, int palette_size) {
  std::vector<uint32_t> tmp_palette(MAX_PALETTE_SIZE);
  // A last entry of 0 is implied where no pixels are bundled.
  const int encoded_palette_size =
      (palette[palette_size - 1] == 0 && palette_size > 17) ? palette_size - 1 : palette_size;
  bw.Put(1, 1);  // a transform
  bw.Put(3, 2);  // colour indexing
  bw.Put(encoded_palette_size - 1, 8);
  for (int i = encoded_palette_size - 1; i >= 1; --i) tmp_palette[i] = SubPixels(palette[i], palette[i - 1]);
  tmp_palette[0] = palette[0];
  EncodeImageNoHuffman(bw, tmp_palette.data(), encoded_palette_size, 1, /*quality=*/20);
}

// The pixels as palette indices, 2, 4 or 8 to a pixel for at most 16
// colours (VP8LBundleColorMap).
std::vector<uint32_t> MapImageFromPalette(const std::vector<uint32_t>& argb, int width, int height,
                                          const uint32_t* palette, int palette_size, int* packed_width) {
  int xbits;
  if (palette_size <= 4) {
    xbits = (palette_size <= 2) ? 3 : 2;
  } else {
    xbits = (palette_size <= 16) ? 1 : 0;
  }
  const int dst_width = SubSampleSize(width, xbits);
  *packed_width = dst_width;
  // each colour's index, found by its place among the sorted colours
  std::vector<std::pair<uint32_t, int>> sorted(palette_size);
  for (int k = 0; k < palette_size; ++k) sorted[k] = {palette[k], k};
  std::sort(sorted.begin(), sorted.end());
  std::vector<uint32_t> out((size_t)dst_width * height);
  std::vector<uint8_t> row(width);
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      const uint32_t pix = argb[(size_t)y * width + x];
      row[x] = (uint8_t)std::lower_bound(sorted.begin(), sorted.end(), std::make_pair(pix, 0))->second;
    }
    uint32_t* const dst = out.data() + (size_t)y * dst_width;
    if (xbits > 0) {
      const int bit_depth = 1 << (3 - xbits);
      const int mask = (1 << xbits) - 1;
      uint32_t code = 0xff000000;
      for (int x = 0; x < width; ++x) {
        const int xsub = x & mask;
        if (xsub == 0) code = 0xff000000;
        code |= (uint32_t)row[x] << (8 + bit_depth * xsub);
        dst[x >> xbits] = code;
      }
    } else {
      for (int x = 0; x < width; ++x) dst[x] = 0xff000000 | ((uint32_t)row[x] << 8);
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// The predictor transform (enc/predictor_enc.c, dsp/lossless.c)

inline uint32_t Average2(uint32_t a0, uint32_t a1) { return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1); }
inline uint32_t Average3(uint32_t a0, uint32_t a1, uint32_t a2) { return Average2(Average2(a0, a2), a1); }
inline uint32_t Average4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3) {
  return Average2(Average2(a0, a1), Average2(a2, a3));
}
inline uint32_t Clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;  // 0 below, 255 above
}
inline int AddSubtractComponentFull(int a, int b, int c) { return (int)Clip255((uint32_t)(a + b - c)); }
inline uint32_t ClampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = AddSubtractComponentFull(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = AddSubtractComponentFull((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = AddSubtractComponentFull((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = AddSubtractComponentFull(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}
inline int AddSubtractComponentHalf(int a, int b) { return (int)Clip255((uint32_t)(a + (a - b) / 2)); }
inline uint32_t ClampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = Average2(c0, c1);
  const int a = AddSubtractComponentHalf(ave >> 24, c2 >> 24);
  const int r = AddSubtractComponentHalf((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = AddSubtractComponentHalf((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = AddSubtractComponentHalf((ave >> 0) & 0xff, (c2 >> 0) & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}
inline int Sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return abs(pb) - abs(pa);
}
inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = Sub3((a >> 24), (b >> 24), (c >> 24)) +
                          Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          Sub3((a) & 0xff, (b) & 0xff, (c) & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}

// The prediction of pixel x of row y (above: row y - 1, so above[x + 1] at
// the last column is row y's first pixel).
inline uint32_t Predict(int mode, const uint32_t* row, const uint32_t* above, int x) {
  const uint32_t left = row[x - 1];
  switch (mode) {
    case 0: return ARGB_BLACK;
    case 1: return left;
    case 2: return above[x];
    case 3: return above[x + 1];
    case 4: return above[x - 1];
    case 5: return Average3(left, above[x], above[x + 1]);
    case 6: return Average2(left, above[x - 1]);
    case 7: return Average2(left, above[x]);
    case 8: return Average2(above[x - 1], above[x]);
    case 9: return Average2(above[x], above[x + 1]);
    case 10: return Average4(left, above[x - 1], above[x], above[x + 1]);
    case 11: return Select(above[x], left, above[x - 1]);
    case 12: return ClampedAddSubtractFull(left, above[x], above[x - 1]);
    default: return ClampedAddSubtractHalf(left, above[x], above[x - 1]);
  }
}

inline uint32_t Residual(const uint32_t* argb, int width, int x, int y, int mode) {
  const uint32_t* const row = argb + (size_t)y * width;
  uint32_t pred;
  if (y == 0) {
    pred = (x == 0) ? ARGB_BLACK : row[x - 1];
  } else if (x == 0) {
    pred = row[-width];
  } else {
    pred = Predict(mode, row, row - width, x);
  }
  return SubPixels(row[x], pred);
}

// A bias for residuals near 0, in 2^-23 bits: 'exp_val' in hundredths,
// decaying by 6/10 a step.
int64_t PredictionCostBias(const uint32_t counts[256], uint64_t weight_0, uint64_t exp_val) {
  const int significant_symbols = 256 >> 4;
  const uint64_t exp_decay_factor = 6;
  uint64_t bits = (weight_0 * counts[0]) << LOG_2_PRECISION_BITS;
  exp_val <<= LOG_2_PRECISION_BITS;
  for (int i = 1; i < significant_symbols; ++i) {
    bits += (uint64_t)DivRound((int64_t)(exp_val * (uint32_t)(counts[i] + counts[256 - i])), 100);
    exp_val = (uint64_t)DivRound((int64_t)(exp_decay_factor * exp_val), 10);
  }
  return -DivRound((int64_t)bits, 10);
}

uint64_t CombinedShannonEntropy(const uint32_t X[256], const uint32_t Y[256]) {
  uint64_t retval = 0;
  uint32_t sumX = 0, sumXY = 0;
  for (int i = 0; i < 256; ++i) {
    const uint32_t x = X[i];
    if (x != 0) {
      const uint32_t xy = x + Y[i];
      sumX += x;
      retval += FastSLog2(x);
      sumXY += xy;
      retval += FastSLog2(xy);
    } else if (Y[i] != 0) {
      sumXY += Y[i];
      retval += FastSLog2(Y[i]);
    }
  }
  retval = FastSLog2(sumX) + FastSLog2(sumXY) - retval;
  return retval;
}

const int64_t kSpatialPredictorBias = 15ll << LOG_2_PRECISION_BITS;

int64_t PredictionCostSpatialHistogram(const uint32_t* accumulated, const uint32_t* tile, int mode, int left_mode,
                                       int above_mode) {
  int64_t retval = 0;
  for (int i = 0; i < 4; ++i) {
    const uint64_t kExpValue = 94;
    retval += PredictionCostBias(&tile[i * 256], 1, kExpValue);
    retval += (int64_t)CombinedShannonEntropy(&tile[i * 256], &accumulated[i * 256]);
  }
  if (mode == left_mode) retval -= kSpatialPredictorBias;
  if (mode == above_mode) retval -= kSpatialPredictorBias;
  return retval;
}

// Picks each tile's predictor (row by row, against the histogram of the
// residuals chosen so far), then replaces argb by its residuals. Returns the
// modes' image, sub-sampled where uniform, and its bits.
std::vector<uint32_t> ResidualImage(int width, int height, int bits, std::vector<uint32_t>& argb, int* best_bits) {
  const int kNumPredModes = 14;
  const int tiles_per_row = SubSampleSize(width, bits);
  const int tiles_per_col = SubSampleSize(height, bits);
  std::vector<uint32_t> image((size_t)tiles_per_row * tiles_per_col);
  std::vector<uint32_t> accumulated(4 * 256, 0);
  std::vector<uint32_t> histo_argb(4 * 256), best_histo(4 * 256);
  for (int tile_y = 0; tile_y < tiles_per_col; ++tile_y) {
    for (int tile_x = 0; tile_x < tiles_per_row; ++tile_x) {
      const int start_x = tile_x << bits;
      const int start_y = tile_y << bits;
      const int max_y = std::min(1 << bits, height - start_y);
      const int max_x = std::min(1 << bits, width - start_x);
      const int left_mode = (tile_x > 0) ? (image[tile_y * tiles_per_row + tile_x - 1] >> 8) & 0xff : 0xff;
      const int above_mode = (tile_y > 0) ? (image[(tile_y - 1) * tiles_per_row + tile_x] >> 8) & 0xff : 0xff;
      int64_t best_diff = INT64_MAX_;
      int best_mode = 0;
      for (int mode = 0; mode < kNumPredModes; ++mode) {
        std::fill(histo_argb.begin(), histo_argb.end(), 0);
        for (int y = start_y; y < start_y + max_y; ++y) {
          for (int x = start_x; x < start_x + max_x; ++x) {
            const uint32_t r = Residual(argb.data(), width, x, y, mode);
            ++histo_argb[0 * 256 + (r >> 24)];
            ++histo_argb[1 * 256 + ((r >> 16) & 0xff)];
            ++histo_argb[2 * 256 + ((r >> 8) & 0xff)];
            ++histo_argb[3 * 256 + (r & 0xff)];
          }
        }
        const int64_t cur_diff =
            PredictionCostSpatialHistogram(accumulated.data(), histo_argb.data(), mode, left_mode, above_mode);
        if (cur_diff < best_diff) {
          std::swap(histo_argb, best_histo);
          best_diff = cur_diff;
          best_mode = mode;
        }
      }
      for (int i = 0; i < 4 * 256; ++i) accumulated[i] += best_histo[i];
      image[tile_y * tiles_per_row + tile_x] = ARGB_BLACK | ((uint32_t)best_mode << 8);
    }
  }
  // the residuals, bottom-up so that each prediction reads the pixels
  std::vector<uint32_t> residuals(argb.size());
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      const int mode = (image[(y >> bits) * tiles_per_row + (x >> bits)] >> 8) & 0xff;
      residuals[(size_t)y * width + x] = Residual(argb.data(), width, x, y, mode);
    }
  }
  argb.swap(residuals);
  OptimizeSampling(image.data(), width, height, bits, MAX_TRANSFORM_BITS, best_bits);
  image.resize((size_t)SubSampleSize(width, *best_bits) * SubSampleSize(height, *best_bits));
  return image;
}

void ApplyPredictFilter(BitWriter& bw, std::vector<uint32_t>& argb, int width, int height, int transform_bits,
                        int quality) {
  const int max_bits = ClampBits(width, height, transform_bits, MIN_TRANSFORM_BITS, MAX_TRANSFORM_BITS,
                                 MAX_PREDICTOR_IMAGE_SIZE);
  int best_bits;
  std::vector<uint32_t> modes = ResidualImage(width, height, max_bits, argb, &best_bits);
  bw.Put(1, 1);  // a transform
  bw.Put(0, 2);  // the predictor
  bw.Put(best_bits - MIN_TRANSFORM_BITS, 3);
  EncodeImageNoHuffman(bw, modes.data(), SubSampleSize(width, best_bits), SubSampleSize(height, best_bits),
                       quality);
}

// ---------------------------------------------------------------------------
// The stream (vp8l_enc.c: EncoderAnalyze, then EncodeStreamHook for its one
// crunch configuration)

std::vector<uint8_t> EncodeStream(const uint8_t* plane, int width, int height) {
  const size_t n = (size_t)width * height;
  std::vector<uint32_t> argb(n);
  for (size_t i = 0; i < n; ++i) argb[i] = (uint32_t)plane[i] << 8;

  uint32_t palette_sorted[MAX_PALETTE_SIZE];
  int palette_size = GetColorPalette(argb, palette_sorted);
  const int use_palette = (palette_size <= MAX_PALETTE_SIZE);
  if (!use_palette) palette_size = 0;
  const int histo_bits = GetHistoBits(kMethod, use_palette, width, height);
  const int transform_bits = GetTransformBits(kMethod, histo_bits);
  const int n_lz77s = (palette_size > 0 && palette_size <= 16) ? 2 : 1;
  int entropy_idx, red_and_blue_always_zero;
  AnalyzeEntropy(argb.data(), width, height, use_palette, palette_size, transform_bits, &entropy_idx,
                 &red_and_blue_always_zero);
  std::vector<CrunchSubConfig> sub_configs;
  for (int j = 0; j < n_lz77s; ++j) {
    sub_configs.push_back({(j == 0) ? (kLZ77Standard | kLZ77RLE) : kLZ77Box, 0});
  }

  const int use_pal = (entropy_idx == kPalette) || (entropy_idx == kPaletteAndSpatial);
  const int use_subtract_green = (entropy_idx == kSubGreen) || (entropy_idx == kSpatialSubGreen);
  const int use_predict =
      (entropy_idx == kSpatial) || (entropy_idx == kSpatialSubGreen) || (entropy_idx == kPaletteAndSpatial);
  const int use_cross_color = use_pal ? 0 : (red_and_blue_always_zero ? 0 : use_predict);
  if (use_subtract_green || use_cross_color) {
    // A plane's red and blue are 0: libwebp's analysis cannot pick these.
    throw std::logic_error("VP8L: a transform this encoder leaves out");
  }

  BitWriter bw;
  int cache_bits = 0;
  int current_width = width;
  if (use_pal) {
    uint32_t palette[MAX_PALETTE_SIZE];
    PaletteSortMinimizeDeltas(palette_sorted, palette_size, palette);
    EncodePalette(bw, palette, palette_size);
    argb = MapImageFromPalette(argb, width, height, palette, palette_size, &current_width);
    // a colour cache no larger than the palette
    if (palette_size < (1 << MAX_COLOR_CACHE_BITS)) cache_bits = BitsLog2Floor(palette_size) + 1;
  }
  if (use_predict) ApplyPredictFilter(bw, argb, current_width, height, transform_bits, kQuality);
  bw.Put(0, 1);  // no more transforms
  EncodeImageInternal(bw, argb, current_width, height, kQuality, sub_configs, &cache_bits, histo_bits);
  return bw.Finish();
}

}  // namespace

std::vector<uint8_t> SlVp8lEncodePlane(const uint8_t* plane, int width, int height) {
  return EncodeStream(plane, width, height);
}

extern "C" {

int sl_vp8l_encode_plane(const uint8_t* plane, int width, int height, uint8_t** out, size_t* out_size, char* err,
                         int errlen) {
  try {
    if (width <= 0 || height <= 0 || width > 16383 || height > 16383) {
      snprintf(err, errlen, "plane of %dx%d: sides must be 1..16383", width, height);
      return SL_UNSUPPORTED;
    }
    std::vector<uint8_t> data = EncodeStream(plane, width, height);
    uint8_t* buf = (uint8_t*)malloc(data.size() ? data.size() : 1);
    if (buf == nullptr) throw std::bad_alloc();
    memcpy(buf, data.data(), data.size());
    *out = buf;
    *out_size = data.size();
    return SL_OK;
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "out of memory");
    return SL_NO_ROOM;
  } catch (const std::exception& e) {
    snprintf(err, errlen, "%s", e.what());
    return SL_UNSUPPORTED;
  }
}

}  // extern "C"
