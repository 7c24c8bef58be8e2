// The port's WebP decoder; see sl_webp.h.
//
// The numbers follow libwebp 1.6's default decode paths, whose SIMD
// versions compute the same values as its C code: dec/vp8_dec.c,
// tree_dec.c, quant_dec.c and frame_dec.c (VP8), dsp/dec.c (prediction,
// transforms, loop filters), dsp/upsampling.c and dsp/yuv.h (fancy
// upsampling, YUV -> RGB), dec/vp8l_dec.c and dsp/lossless.c (VP8L),
// dec/alpha_dec.c and dsp/filters.c (ALPH), dec/webp_dec.c (the headers a
// WebPDecode call parses), demux/demux.c and demux/anim_decode.c (the
// container and frame 0). Build: g++ -O3 -shared -fPIC -std=c++17.

#include "sl_webp.h"

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
[[noreturn]] void truncated(const std::string& m) { throw Error(SL_TRUNCATED, m); }

inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
inline bool tag(const uint8_t* p, const char* t) { return memcmp(p, t, 4) == 0; }

const uint32_t MAX_CHUNK_PAYLOAD = ~0U - 8 - 1;
const uint64_t MAX_IMAGE_AREA = 1ULL << 32;
const uint32_t ALPHA_FLAG = 0x10, ANIMATION_FLAG = 0x02, ICCP_FLAG = 0x20, EXIF_FLAG = 0x08,
               XMP_FLAG = 0x04;
const uint32_t ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | ICCP_FLAG | EXIF_FLAG | XMP_FLAG;

// ===========================================================================
// VP8 tables (RFC 6386; the intra modes in libwebp's order: DC, TM, VE, HE,
// RD, VR, LD, VL, HD, HU)
// ===========================================================================

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};

const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95}, {175, 69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152}, {114, 26, 17, 163, 44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85}, {144, 71, 10, 38, 171, 213, 144, 34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71}, {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80}, {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141, 26, 8, 107}, {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128}, {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23}, {47, 41, 14, 110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61}, {39, 53, 200, 87, 26, 21, 43, 232, 171}, {56, 34, 51, 104, 114, 102, 29, 93, 77}, {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22, 116, 206, 23, 34, 43, 166, 73}, {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171, 36, 225, 114}, {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111}, {112, 113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109}, {88, 43, 29, 140, 166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209}, {100, 80, 8, 43, 154, 1, 51, 26, 71}, {142, 78, 78, 16, 255, 128, 34, 197, 171}, {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179}, {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34, 39, 175}, {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183}, {57, 46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205}, {40, 3, 9, 115, 51, 192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57}, {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34, 26, 133, 152, 116, 10, 32, 134}, {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2, 15, 1, 118, 73}, {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186, 85}, {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45}, {75, 79, 123, 47, 51, 128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49}, {38, 33, 13, 121, 57, 73, 26, 1, 85}, {41, 10, 67, 138, 77, 110, 90, 47, 114}, {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16, 10, 85, 128, 101, 196, 26}, {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37}, {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70}, {37, 43, 37, 154, 100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85}, {75, 15, 9, 9, 64, 255, 184, 119, 16}, {86, 6, 28, 5, 64, 255, 25, 248, 1}, {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158}, {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1, 209}, {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213}, {83, 12, 13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171}, {18, 11, 7, 63, 144, 171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32}, {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62}, {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138, 55, 70, 43, 26, 142}, {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81, 188, 64}, {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

// ===========================================================================
// VP8 boolean decoder (bit_reader_utils / bit_reader_inl_utils)
// ===========================================================================

struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;  // buffered bits beyond the 8 the next decision reads
  uint32_t range = 254;  // range - 1
  int eof = 0;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 255 - 1;
    eof = 0;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= get_bit(0x80) << nbits;
    return v;
  }
  int get() { return get_value(1); }
  int get_signed_value(int nbits) {
    const int v = get_value(nbits);
    return get() ? -v : v;
  }
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }
};

// ===========================================================================
// VP8 decoder
// ===========================================================================

const int BPS = 32;
const int YUV_SIZE = BPS * 17 + BPS * 9;
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;

inline uint8_t clip_8b(int v) { return (!(v & ~0xff)) ? uint8_t(v) : (v < 0) ? 0 : 255; }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip_8b(dst[0] + ((a + d) >> 3));
    dst[1] = clip_8b(dst[1] + ((b + c) >> 3));
    dst[2] = clip_8b(dst[2] + ((b - c) >> 3));
    dst[3] = clip_8b(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// --- intra predictors (dsp/dec.c) ---

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip_8b(top[x] + l - tl);
    dst += BPS;
  }
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, int(dc), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, avg3(A, B, C), 4);
      memset(dst + 1 * BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    }
  }
}
#undef DST

void put_block(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

// 16x16 (size 16, shift 5) and chroma 8x8 (size 8, shift 4) predictors
void pred_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      put_block(dst, size, dc >> shift);
      break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case DC_NOTOP: {
      int dc = size / 2;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      put_block(dst, size, dc >> (shift - 1));
      break;
    }
    case DC_NOLEFT: {
      int dc = size / 2;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      put_block(dst, size, dc >> (shift - 1));
      break;
    }
    default: put_block(dst, size, 0x80); break;
  }
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return (mb_y == 0) ? DC_NOTOPLEFT : DC_NOLEFT;
    return (mb_y == 0) ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

// --- loop filters (dsp/dec.c) ---

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
inline uint8_t uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = uclip(p0 + a2);
  p[0] = uclip(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = uclip(p1 + a3);
  p[-step] = uclip(p0 + a2);
  p[0] = uclip(q0 - a1);
  p[step] = uclip(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = uclip(p2 + a3);
  p[-2 * step] = uclip(p1 + a2);
  p[-step] = uclip(p0 + a1);
  p[0] = uclip(q0 - a1);
  p[step] = uclip(q1 - a2);
  p[2 * step] = uclip(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs(p1 - p0) > thresh) || (abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs(p0 - q0) + abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs(p0 - q0) + abs(p1 - q1)) > t) return 0;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
  }
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct BandProbas {
  uint8_t probas[3][11];
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4;
  uint8_t imodes[16];
  uint8_t uvmode;
  uint8_t segment;
  uint8_t skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

struct VP8Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
};

int get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// the position of the last non-zero coefficient plus one
int get_coeffs(BoolReader& br, const BandProbas* const* prob, int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = prob[n]->probas[ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = prob[++n]->probas[0];
      if (n == 16) return 16;
    }
    const BandProbas* const* p_ctx = &prob[n + 1];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = (*p_ctx)->probas[1];
    } else {
      v = get_large_value(br, p);
      p = (*p_ctx)->probas[2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

class VP8Decoder {
 public:
  // Decodes the VP8 bitstream of ``size`` bytes at ``data`` (the data that
  // follows the chunk header, to the end of the buffer libwebp is given).
  void decode(const uint8_t* data, size_t size, VP8Frame& f);

 private:
  void parse_header(const uint8_t* data, size_t size);
  void parse_intra_mode(int mb_x);
  int parse_residuals(int mb_x, BoolReader& token_br);
  void reconstruct_row(int mb_y, VP8Frame& f);
  void filter_frame(VP8Frame& f);

  BoolReader br_;
  std::vector<BoolReader> parts_;
  int num_parts_minus_one_ = 0;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  // segment header
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0, 0, 0, 0};
  int filter_strength_[4] = {0, 0, 0, 0};
  uint8_t segments_proba_[3] = {255, 255, 255};
  // filter header
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0};
  int mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;
  FInfo fstrengths_[4][2];
  QuantMatrix dqm_[4];
  BandProbas bands_[4][8];
  const BandProbas* bands_ptr_[4][16 + 1];
  int use_skip_proba_ = 0;
  int skip_p_ = 0;
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<MBInfo> mb_info_;  // index 0 is the left neighbour of mb_x = 0
  std::vector<MBData> mb_data_;
  std::vector<FInfo> f_info_;  // per macroblock of the frame
  std::vector<uint8_t> yuv_t_;  // top samples: 32 bytes per macroblock (y16 u8 v8)
  uint8_t yuv_b_[YUV_SIZE];
};

void VP8Decoder::parse_header(const uint8_t* buf, size_t buf_size) {
  if (buf_size < 4) truncated("VP8: truncated header");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) corrupt("VP8: incorrect keyframe parameters");
  if (!show) corrupt("VP8: frame not displayable");
  buf += 3;
  buf_size -= 3;
  if (key_frame) {
    if (buf_size < 7) truncated("VP8: cannot parse picture header");
    if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) corrupt("VP8: bad code word");
    width_ = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    buf_size -= 7;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) bands_[t][b].probas[c][p] = kCoeffsProba0[t][b][c][p];
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 16 + 1; ++b) bands_ptr_[t][b] = &bands_[t][kBands[b]];
  }
  if (partition_length > buf_size) truncated("VP8: bad partition length");
  br_.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  if (key_frame) {
    br_.get();  // colour space
    br_.get();  // clamping type
  }
  // segment header
  use_segment_ = br_.get();
  if (use_segment_) {
    update_map_ = br_.get();
    if (br_.get()) {  // update data
      absolute_delta_ = br_.get();
      for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get() ? br_.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.get() ? br_.get_signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s) segments_proba_[s] = br_.get() ? br_.get_value(8) : 255;
  } else {
    update_map_ = 0;
  }
  if (br_.eof) corrupt("VP8: cannot parse segment header");
  // filter header
  simple_ = br_.get();
  level_ = br_.get_value(6);
  sharpness_ = br_.get_value(3);
  use_lf_delta_ = br_.get();
  if (use_lf_delta_) {
    if (br_.get()) {
      for (int i = 0; i < 4; ++i)
        if (br_.get()) ref_lf_delta_[i] = br_.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get()) mode_lf_delta_[i] = br_.get_signed_value(6);
    }
  }
  filter_type_ = (level_ == 0) ? 0 : simple_ ? 1 : 2;
  if (br_.eof) corrupt("VP8: cannot parse filter header");
  // partitions
  num_parts_minus_one_ = (1 << br_.get_value(2)) - 1;
  const size_t last_part = size_t(num_parts_minus_one_);
  if (buf_size < 3 * last_part) truncated("VP8: cannot parse partitions");
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + buf_size;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = buf_size - last_part * 3;
  parts_.assign(last_part + 1, BoolReader());
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts_[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts_[last_part].init(part_start, size_left);
  if (!(part_start < buf_end)) truncated("VP8: cannot parse partitions");
  // quantisers
  const int base_q0 = br_.get_value(7);
  const int dqy1_dc = br_.get() ? br_.get_signed_value(4) : 0;
  const int dqy2_dc = br_.get() ? br_.get_signed_value(4) : 0;
  const int dqy2_ac = br_.get() ? br_.get_signed_value(4) : 0;
  const int dquv_dc = br_.get() ? br_.get_signed_value(4) : 0;
  const int dquv_ac = br_.get() ? br_.get_signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = quantizer_[i];
      if (!absolute_delta_) q += base_q0;
    } else {
      if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix* const m = &dqm_[i];
    m->y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m->y1[1] = kAcTable[clip(q + 0, 127)];
    m->y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m->y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m->y2[1] < 8) m->y2[1] = 8;
    m->uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m->uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  if (!key_frame) corrupt("VP8: not a key frame");
  br_.get();  // update_proba, ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int v =
              br_.get_bit(kCoeffsUpdateProba[t][b][c][p]) ? br_.get_value(8) : kCoeffsProba0[t][b][c][p];
          bands_[t][b].probas[c][p] = uint8_t(v);
        }
  use_skip_proba_ = br_.get();
  if (use_skip_proba_) skip_p_ = br_.get_value(8);
}

void VP8Decoder::parse_intra_mode(int mb_x) {
  uint8_t* const top = intra_t_.data() + 4 * mb_x;
  uint8_t* const left = intra_l_;
  MBData* const block = &mb_data_[mb_x];
  if (update_map_) {
    block->segment = !br_.get_bit(segments_proba_[0]) ? br_.get_bit(segments_proba_[1])
                                                      : br_.get_bit(segments_proba_[2]) + 2;
  } else {
    block->segment = 0;
  }
  if (use_skip_proba_) block->skip = br_.get_bit(skip_p_);
  block->is_i4x4 = !br_.get_bit(145);
  if (!block->is_i4x4) {
    const int ymode = br_.get_bit(156) ? (br_.get_bit(128) ? TM_PRED : H_PRED)
                                       : (br_.get_bit(163) ? V_PRED : DC_PRED);
    block->imodes[0] = uint8_t(ymode);
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba[top[x]][ymode];
        ymode = !br_.get_bit(prob[0])   ? B_DC_PRED
                : !br_.get_bit(prob[1]) ? B_TM_PRED
                : !br_.get_bit(prob[2]) ? B_VE_PRED
                : !br_.get_bit(prob[3])
                    ? (!br_.get_bit(prob[4]) ? B_HE_PRED
                                             : (!br_.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br_.get_bit(prob[6])
                           ? B_LD_PRED
                           : (!br_.get_bit(prob[7])
                                  ? B_VL_PRED
                                  : (!br_.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = uint8_t(ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block->uvmode = !br_.get_bit(142)   ? DC_PRED
                  : !br_.get_bit(114) ? V_PRED
                  : br_.get_bit(183)  ? TM_PRED
                                      : H_PRED;
}

int VP8Decoder::parse_residuals(int mb_x, BoolReader& token_br) {
  const BandProbas* const* ac_proba;
  MBData* const block = &mb_data_[mb_x];
  const QuantMatrix* const q = &dqm_[block->segment];
  int16_t* dst = block->coeffs;
  MBInfo* const mb = &mb_info_[mb_x + 1];
  MBInfo* const left_mb = &mb_info_[0];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint32_t out_t_nz, out_l_nz;
  int first;
  memset(dst, 0, 384 * sizeof(*dst));
  if (!block->is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb->nz_dc + left_mb->nz_dc;
    const int nz = get_coeffs(token_br, bands_ptr_[1], ctx, q->y2, 0, dc);
    mb->nz_dc = left_mb->nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_proba = bands_ptr_[0];
  } else {
    first = 0;
    ac_proba = bands_ptr_[3];
  }
  uint8_t tnz = mb->nz & 0x0f;
  uint8_t lnz = left_mb->nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(token_br, ac_proba, ctx, q->y1, first, dst);
      l = (nz > first);
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  out_t_nz = tnz;
  out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(mb->nz >> (4 + ch));
    lnz = uint8_t(left_mb->nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(token_br, bands_ptr_[2], ctx, q->uv, 0, dst);
        l = (nz > 0);
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  mb->nz = uint8_t(out_t_nz);
  left_mb->nz = uint8_t(out_l_nz);
  block->non_zero_y = non_zero_y;
  block->non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

void VP8Decoder::reconstruct_row(int mb_y, VP8Frame& f) {
  uint8_t* const y_dst = yuv_b_ + Y_OFF;
  uint8_t* const u_dst = yuv_b_ + U_OFF;
  uint8_t* const v_dst = yuv_b_ + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = 129;
    v_dst[j * BPS - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
    const MBData* const block = &mb_data_[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    uint8_t* const top_yuv = yuv_t_.data() + 32 * mb_x;
    const int16_t* const coeffs = block->coeffs;
    uint32_t bits = block->non_zero_y;
    if (mb_y > 0) {
      memcpy(y_dst - BPS, top_yuv, 16);
      memcpy(u_dst - BPS, top_yuv + 16, 8);
      memcpy(v_dst - BPS, top_yuv + 24, 8);
    }
    if (block->is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1) {
          memset(top_right, top_yuv[15], 4);
        } else {
          memcpy(top_right, top_yuv + 32, 4);
        }
      }
      for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        pred_luma4(block->imodes[n], dst);
        if (bits >> 30) transform_one(coeffs + n * 16, dst);
      }
    } else {
      pred_block(check_mode(mb_x, mb_y, block->imodes[0]), y_dst, 16);
      if (bits != 0) {
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          if (bits >> 30) transform_one(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
      }
    }
    const uint32_t bits_uv = block->non_zero_uv;
    const int pred_func = check_mode(mb_x, mb_y, block->uvmode);
    pred_block(pred_func, u_dst, 8);
    pred_block(pred_func, v_dst, 8);
    for (int c = 0; c < 2; ++c) {
      uint8_t* const dst = c ? v_dst : u_dst;
      if ((bits_uv >> (8 * c)) & 0xff) {
        const int16_t* in = coeffs + (16 + 4 * c) * 16;
        transform_one(in, dst);
        transform_one(in + 16, dst + 4);
        transform_one(in + 32, dst + 4 * BPS);
        transform_one(in + 48, dst + 4 * BPS + 4);
      }
    }
    if (mb_y < mb_h_ - 1) {
      memcpy(top_yuv, y_dst + 15 * BPS, 16);
      memcpy(top_yuv + 16, u_dst + 7 * BPS, 8);
      memcpy(top_yuv + 24, v_dst + 7 * BPS, 8);
    }
    uint8_t* const y_out = f.y.data() + size_t(mb_y) * 16 * f.y_stride + mb_x * 16;
    uint8_t* const u_out = f.u.data() + size_t(mb_y) * 8 * f.uv_stride + mb_x * 8;
    uint8_t* const v_out = f.v.data() + size_t(mb_y) * 8 * f.uv_stride + mb_x * 8;
    for (int j = 0; j < 16; ++j) memcpy(y_out + j * f.y_stride, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(u_out + j * f.uv_stride, u_dst + j * BPS, 8);
      memcpy(v_out + j * f.uv_stride, v_dst + j * BPS, 8);
    }
  }
}

void VP8Decoder::filter_frame(VP8Frame& f) {
  const int y_bps = f.y_stride, uv_bps = f.uv_stride;
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const FInfo& fi = f_info_[size_t(mb_y) * mb_w_ + mb_x];
      const int limit = fi.limit;
      if (limit == 0) continue;
      uint8_t* const y_dst = f.y.data() + size_t(mb_y) * 16 * y_bps + mb_x * 16;
      if (filter_type_ == 1) {
        if (mb_x > 0) simple_filter(y_dst, 1, y_bps, limit + 4);
        if (fi.inner)
          for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, y_bps, limit);
        if (mb_y > 0) simple_filter(y_dst, y_bps, 1, limit + 4);
        if (fi.inner)
          for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * y_bps, y_bps, 1, limit);
      } else {
        uint8_t* const u_dst = f.u.data() + size_t(mb_y) * 8 * uv_bps + mb_x * 8;
        uint8_t* const v_dst = f.v.data() + size_t(mb_y) * 8 * uv_bps + mb_x * 8;
        const int ilevel = fi.ilevel, hev_t = fi.hev_thresh;
        if (mb_x > 0) {
          filter_loop26(y_dst, 1, y_bps, 16, limit + 4, ilevel, hev_t);
          filter_loop26(u_dst, 1, uv_bps, 8, limit + 4, ilevel, hev_t);
          filter_loop26(v_dst, 1, uv_bps, 8, limit + 4, ilevel, hev_t);
        }
        if (fi.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop24(y_dst + 4 * k, 1, y_bps, 16, limit, ilevel, hev_t);
          filter_loop24(u_dst + 4, 1, uv_bps, 8, limit, ilevel, hev_t);
          filter_loop24(v_dst + 4, 1, uv_bps, 8, limit, ilevel, hev_t);
        }
        if (mb_y > 0) {
          filter_loop26(y_dst, y_bps, 1, 16, limit + 4, ilevel, hev_t);
          filter_loop26(u_dst, uv_bps, 1, 8, limit + 4, ilevel, hev_t);
          filter_loop26(v_dst, uv_bps, 1, 8, limit + 4, ilevel, hev_t);
        }
        if (fi.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop24(y_dst + 4 * k * y_bps, y_bps, 1, 16, limit, ilevel, hev_t);
          filter_loop24(u_dst + 4 * uv_bps, uv_bps, 1, 8, limit, ilevel, hev_t);
          filter_loop24(v_dst + 4 * uv_bps, uv_bps, 1, 8, limit, ilevel, hev_t);
        }
      }
    }
  }
}

void VP8Decoder::decode(const uint8_t* data, size_t size, VP8Frame& f) {
  parse_header(data, size);
  // filter strengths per segment and 4x4-ness
  if (filter_type_ > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment_) {
        base_level = filter_strength_[s];
        if (!absolute_delta_) base_level += level_;
      } else {
        base_level = level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo* const info = &fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = (level < 0) ? 0 : (level > 63) ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            if (sharpness_ > 4) {
              ilevel >>= 2;
            } else {
              ilevel >>= 1;
            }
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info->ilevel = ilevel;
          info->limit = 2 * level + ilevel;
          info->hev_thresh = (level >= 40) ? 2 : (level >= 15) ? 1 : 0;
        } else {
          info->limit = 0;
        }
        info->inner = i4x4;
      }
    }
  }
  f.width = width_;
  f.height = height_;
  f.mb_w = mb_w_;
  f.mb_h = mb_h_;
  f.y_stride = mb_w_ * 16;
  f.uv_stride = mb_w_ * 8;
  f.y.assign(size_t(f.y_stride) * mb_h_ * 16, 0);
  f.u.assign(size_t(f.uv_stride) * mb_h_ * 8, 0);
  f.v.assign(size_t(f.uv_stride) * mb_h_ * 8, 0);
  intra_t_.assign(size_t(4) * mb_w_, B_DC_PRED);
  mb_info_.assign(size_t(mb_w_) + 1, MBInfo());
  mb_data_.assign(size_t(mb_w_), MBData());
  f_info_.assign(size_t(mb_w_) * mb_h_, FInfo());
  yuv_t_.assign(size_t(32) * mb_w_, 0);
  memset(yuv_b_, 0, sizeof(yuv_b_));
  memset(intra_l_, B_DC_PRED, 4);
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    BoolReader& token_br = parts_[mb_y & num_parts_minus_one_];
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x);
    if (br_.eof) truncated("VP8: premature end of partition 0");
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      MBData* const block = &mb_data_[mb_x];
      MBInfo* const left = &mb_info_[0];
      MBInfo* const mb = &mb_info_[mb_x + 1];
      int skip = use_skip_proba_ ? block->skip : 0;
      if (!skip) {
        skip = parse_residuals(mb_x, token_br);
      } else {
        left->nz = mb->nz = 0;
        if (!block->is_i4x4) left->nz_dc = mb->nz_dc = 0;
        block->non_zero_y = 0;
        block->non_zero_uv = 0;
      }
      if (filter_type_ > 0) {
        FInfo& fi = f_info_[size_t(mb_y) * mb_w_ + mb_x];
        fi = fstrengths_[block->segment][block->is_i4x4];
        fi.inner |= !skip;
      }
      if (token_br.eof) truncated("VP8: premature end of file");
    }
    // the next row's left context
    mb_info_[0] = MBInfo();
    memset(intra_l_, B_DC_PRED, 4);
    reconstruct_row(mb_y, f);
  }
  if (filter_type_ > 0) filter_frame(f);
}

// --- libwebp's output stage: fancy upsampling and YUV -> RGB ---

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = uint8_t(clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgba[1] = uint8_t(clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgba[2] = uint8_t(clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
  rgba[3] = 0xff;
}

inline uint32_t load_uv(uint8_t u, uint8_t v) { return uint32_t(u) | (uint32_t(v) << 16); }

void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (2 * x - 1) * 4);
      yuv_to_rgba(top_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, top_dst + (2 * x) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, bottom_dst + (2 * x) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[len - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (len - 1) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16) & 0xff,
                  bottom_dst + (len - 1) * 4);
    }
  }
}

// EmitFancyRGB over the whole picture: RGBA (alpha 0xff) rows of ``stride`` bytes
void emit_fancy_rgba(const VP8Frame& f, uint8_t* out, size_t stride) {
  const int w = f.width, h = f.height;
  const uint8_t* y = f.y.data();
  const uint8_t* u = f.u.data();
  const uint8_t* v = f.v.data();
  const int ys = f.y_stride, uvs = f.uv_stride;
  upsample_pair(y, nullptr, u, v, u, v, out, nullptr, w);
  int row = 1;
  for (; row + 1 < h; row += 2) {
    const int k = (row + 1) >> 1;  // chroma row of the pair's bottom line
    upsample_pair(y + size_t(row) * ys, y + size_t(row + 1) * ys, u + size_t(k - 1) * uvs,
                  v + size_t(k - 1) * uvs, u + size_t(k) * uvs, v + size_t(k) * uvs,
                  out + row * stride, out + (row + 1) * stride, w);
  }
  if (row < h) {  // the last row of an even-sized picture
    const int k = (row - 1) >> 1;
    upsample_pair(y + size_t(row) * ys, nullptr, u + size_t(k) * uvs, v + size_t(k) * uvs,
                  u + size_t(k) * uvs, v + size_t(k) * uvs, out + row * stride, nullptr, w);
  }
}

// ===========================================================================
// VP8L
// ===========================================================================

const int NUM_LITERAL_CODES = 256, NUM_LENGTH_CODES = 24, NUM_DISTANCE_CODES = 40;
const int CODE_LENGTH_CODES = 19;
const int kAlphabetSize[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES, NUM_LITERAL_CODES,
                              NUM_LITERAL_CODES, NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
const uint8_t kCodeLengthCodeOrder[CODE_LENGTH_CODES] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                         7,  8,  9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

// LSB-first bit reader; past the end it reads zeros. ``eos`` is libwebp's
// end-of-stream: more bits consumed than the buffer holds (a buffer of
// under 8 bytes counts as 8, libwebp's first window).
struct LBitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0;
  uint64_t pos = 0;
  uint64_t limit = 0;
  bool eos_flag = false;  // set by a read past the end or of more than 24 bits

  void init(const uint8_t* p, size_t n) {
    buf = p;
    len = n;
    pos = 0;
    limit = 8 * uint64_t(std::max<size_t>(n, 8));
    eos_flag = false;
  }
  bool eos() const { return eos_flag || pos > limit; }
  uint32_t peek(int n) const {  // n <= 32
    const uint64_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len) {
      memcpy(&v, buf + byte, 8);
    } else {
      for (uint64_t i = 0; i < 8 && byte + i < len; ++i) v |= uint64_t(buf[byte + i]) << (8 * i);
    }
    v >>= (pos & 7);
    return uint32_t(v & ((n >= 32) ? 0xffffffffULL : ((1ULL << n) - 1)));
  }
  uint32_t read(int n) {
    if (eos() || n > 24) {
      eos_flag = true;
      return 0;
    }
    const uint32_t v = peek(n);
    pos += n;
    if (pos > limit) eos_flag = true;
    return v;
  }
  void skip(int n) { pos += n; }
};

// A canonical prefix code: a 9-bit lookup for short codes, the canonical
// walk for longer ones. A code of one symbol reads no bits.
struct Huffman {
  static const int LUT_BITS = 9;
  int single = -1;
  uint16_t count[16] = {0};
  std::vector<uint16_t> sorted;
  std::vector<uint16_t> lut;  // (symbol << 4) | length, 0 = longer code

  // false where libwebp's VP8LBuildHuffmanTable returns 0
  bool build(const int* lengths, int n) {
    int cnt[16] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15 || lengths[s] < 0) return false;
      ++cnt[lengths[s]];
    }
    if (cnt[0] == n) return false;
    int offset[16];
    offset[1] = 0;
    for (int len = 1; len < 15; ++len) {
      if (cnt[len] > (1 << len)) return false;
      offset[len + 1] = offset[len] + cnt[len];
    }
    const int total = n - cnt[0];
    sorted.assign(total, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s] > 0) sorted[offset[lengths[s]]++] = uint16_t(s);
    if (total == 1) {
      single = sorted[0];
      return true;
    }
    int num_open = 1;
    for (int len = 1; len <= 15; ++len) {
      num_open <<= 1;
      num_open -= cnt[len];
      if (num_open < 0) return false;
    }
    if (num_open != 0) return false;
    for (int len = 0; len < 16; ++len) count[len] = uint16_t(cnt[len]);
    lut.assign(1 << LUT_BITS, 0);
    int code = 0, idx = 0;
    for (int len = 1; len <= LUT_BITS; ++len) {
      for (int k = 0; k < cnt[len]; ++k) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = rev; fill < (1 << LUT_BITS); fill += 1 << len)
          lut[fill] = uint16_t((sorted[idx] << 4) | len);
        ++code;
        ++idx;
      }
      code <<= 1;
    }
    return true;
  }
  int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(16);
    const uint16_t e = lut[bits & ((1 << LUT_BITS) - 1)];
    if (e) {
      br.skip(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int c = count[len];
      if (code - first < c) {
        br.skip(len);
        return sorted[index + code - first];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // not reached for a complete code
  }
};

struct HTreeGroup {
  Huffman h[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

enum { PREDICTOR_TRANSFORM = 0, CROSS_COLOR_TRANSFORM = 1, SUBTRACT_GREEN_TRANSFORM = 2,
       COLOR_INDEXING_TRANSFORM = 3 };

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline int sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return abs(pb) - abs(pa);
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}
inline uint32_t clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;
}
inline int add_sub_full(int a, int b, int c) { return int(clip255(uint32_t(a + b - c))); }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (r << 16) | (g << 8) | b;
}
inline int add_sub_half(int a, int b) { return int(clip255(uint32_t(a + (a - b) / 2))); }
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_sub_half(ave >> 24, c2 >> 24);
  const int r = add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_half(ave & 0xff, c2 & 0xff);
  return (uint32_t(a) << 24) | (r << 16) | (g << 8) | b;
}

// the predicted value of mode ``m`` for the pixel with left ``L`` and the
// row above at ``top`` (top[-1] top-left, top[1] top-right)
inline uint32_t predict(int m, uint32_t L, const uint32_t* top) {
  switch (m) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

inline int color_transform_delta(int8_t color_pred, int8_t color) {
  return (int(color_pred) * color) >> 5;
}

void inverse_transform(const Transform& t, std::vector<uint32_t>& img) {
  const int width = t.xsize, height = t.ysize;
  switch (t.type) {
    case SUBTRACT_GREEN_TRANSFORM:
      for (size_t i = 0; i < size_t(width) * height; ++i) {
        const uint32_t argb = img[i];
        const uint32_t green = (argb >> 8) & 0xff;
        uint32_t red_blue = argb & 0x00ff00ffu;
        red_blue += (green << 16) | green;
        red_blue &= 0x00ff00ffu;
        img[i] = (argb & 0xff00ff00u) | red_blue;
      }
      break;
    case PREDICTOR_TRANSFORM: {
      uint32_t* out = img.data();
      out[0] = add_pixels(out[0], 0xff000000u);
      for (int x = 1; x < width; ++x) out[x] = add_pixels(out[x], out[x - 1]);
      const int tiles_per_row = subsample(width, t.bits);
      for (int y = 1; y < height; ++y) {
        uint32_t* row = out + size_t(y) * width;
        const uint32_t* top = row - width;
        const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles_per_row;
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < width; ++x) {
          const int m = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(m, row[x - 1], top + x));
        }
      }
      break;
    }
    case CROSS_COLOR_TRANSFORM: {
      const int tiles_per_row = subsample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        uint32_t* row = img.data() + size_t(y) * width;
        const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles_per_row;
        for (int x = 0; x < width; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff),
                       r2b = int8_t((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = int8_t(argb >> 8);
          const uint32_t red = argb >> 16;
          int new_red = red & 0xff;
          int new_blue = argb & 0xff;
          new_red += color_transform_delta(g2r, green);
          new_red &= 0xff;
          new_blue += color_transform_delta(g2b, green);
          new_blue += color_transform_delta(r2b, int8_t(new_red));
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (uint32_t(new_red) << 16) | uint32_t(new_blue);
        }
      }
      break;
    }
    case COLOR_INDEXING_TRANSFORM: {
      const int bits = t.bits;
      const int packed_w = subsample(width, bits);
      std::vector<uint32_t> out(size_t(width) * height);
      const uint32_t* cmap = t.data.data();
      if (bits == 0) {
        for (size_t i = 0; i < out.size(); ++i) out[i] = cmap[(img[i] >> 8) & 0xff];
      } else {
        const int bits_per_pixel = 8 >> bits;
        const int count_mask = (1 << bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = img.data() + size_t(y) * packed_w;
          uint32_t* dst = out.data() + size_t(y) * width;
          uint32_t packed = 0;
          for (int x = 0; x < width; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = cmap[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
      }
      img.swap(out);
      break;
    }
  }
}

class VP8LDecoder {
 public:
  explicit VP8LDecoder(const uint8_t* data, size_t size) { br_.init(data, size); }
  // The image header (signature, size, alpha bit, version).
  void read_header(int* width, int* height, int* has_alpha);
  // The image stream of a width x height picture (``level0``: the main
  // image, with transforms); ARGB pixels after every inverse transform.
  // ``alpha_8b``: the end-of-stream rule of libwebp's 8-bit alpha path.
  std::vector<uint32_t> decode_image(int width, int height, bool alpha);

 private:
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0, bool* use_8b);
  void read_huffman_codes(int xsize, int ysize, int cache_bits, bool allow_recursion);
  void read_code(int alphabet_size, Huffman* out);
  void decode_data(std::vector<uint32_t>& data, int width, int height, bool alpha_8b);

  LBitReader br_;
  std::vector<Transform> transforms_;
  uint32_t transforms_seen_ = 0;
  // the meta codes of the stream being decoded
  int huffman_bits_ = 0;
  int huffman_xsize_ = 0;
  std::vector<uint32_t> huffman_image_;
  std::vector<HTreeGroup> groups_;
  int cache_bits_ = 0;
};

void VP8LDecoder::read_header(int* width, int* height, int* has_alpha) {
  if (br_.read(8) != 0x2f) corrupt("VP8L: bad signature");
  *width = int(br_.read(14)) + 1;
  *height = int(br_.read(14)) + 1;
  *has_alpha = int(br_.read(1));
  if (br_.read(3) != 0) corrupt("VP8L: bad version");
  if (br_.eos()) truncated("VP8L: truncated header");
}

void VP8LDecoder::read_code(int alphabet_size, Huffman* out) {
  std::vector<int> code_lengths(std::max(alphabet_size, 256), 0);
  const int simple_code = int(br_.read(1));
  bool ok = true;
  if (simple_code) {
    const int num_symbols = int(br_.read(1)) + 1;
    const int first_symbol_len_code = int(br_.read(1));
    int symbol = int(br_.read(first_symbol_len_code == 0 ? 1 : 8));
    code_lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = int(br_.read(8));
      code_lengths[symbol] = 1;
    }
  } else {
    int cl_lengths[CODE_LENGTH_CODES] = {0};
    const int num_codes = int(br_.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
    Huffman lengths_code;
    if (!lengths_code.build(cl_lengths, CODE_LENGTH_CODES)) corrupt("VP8L: bad code lengths code");
    int max_symbol;
    if (br_.read(1)) {
      const int length_nbits = 2 + 2 * int(br_.read(3));
      max_symbol = 2 + int(br_.read(length_nbits));
      if (max_symbol > alphabet_size) corrupt("VP8L: bad code lengths");
    } else {
      max_symbol = alphabet_size;
    }
    int symbol = 0, prev_code_len = 8;
    while (symbol < alphabet_size) {
      if (max_symbol-- == 0) break;
      const int code_len = lengths_code.read(br_);
      if (code_len < 16) {
        code_lengths[symbol++] = code_len;
        if (code_len != 0) prev_code_len = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kRepeatOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = int(br_.read(kExtraBits[slot])) + kRepeatOffsets[slot];
        if (symbol + repeat > alphabet_size) corrupt("VP8L: bad code lengths");
        const int length = (code_len == 16) ? prev_code_len : 0;
        while (repeat-- > 0) code_lengths[symbol++] = length;
      }
    }
  }
  ok = ok && !br_.eos();
  if (!ok) truncated("VP8L: truncated prefix code");
  if (!out->build(code_lengths.data(), alphabet_size)) corrupt("VP8L: bad prefix code");
}

void VP8LDecoder::read_huffman_codes(int xsize, int ysize, int cache_bits, bool allow_recursion) {
  int num_groups = 1;
  huffman_bits_ = 0;
  huffman_image_.clear();
  std::vector<uint32_t> image;
  int bits = 0;
  if (allow_recursion && br_.read(1)) {
    bits = 2 + int(br_.read(3));
    const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
    bool dummy = false;
    image = decode_stream(hx, hy, false, &dummy);
    for (auto& v : image) {
      v = (v >> 8) & 0xffff;
      num_groups = std::max(num_groups, int(v) + 1);
    }
    huffman_xsize_ = hx;
  }
  if (br_.eos()) truncated("VP8L: truncated meta codes");
  std::vector<char> used(num_groups, image.empty() ? 1 : 0);
  for (uint32_t v : image) used[v] = 1;
  std::vector<HTreeGroup> groups(num_groups);
  HTreeGroup scratch;
  for (int i = 0; i < num_groups; ++i) {
    HTreeGroup& g = used[i] ? groups[i] : scratch;
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      read_code(alphabet, &g.h[j]);
    }
  }
  huffman_bits_ = bits;
  huffman_image_.swap(image);
  groups_.swap(groups);
}

std::vector<uint32_t> VP8LDecoder::decode_stream(int xsize, int ysize, bool level0,
                                                 bool* use_8b) {
  int transform_xsize = xsize;
  if (level0) {
    while (br_.read(1)) {
      if (br_.eos()) truncated("VP8L: truncated transform");
      const int type = int(br_.read(2));
      if (transforms_seen_ & (1u << type)) corrupt("VP8L: repeated transform");
      transforms_seen_ |= 1u << type;
      Transform t;
      t.type = type;
      t.xsize = transform_xsize;
      t.ysize = ysize;
      if (type == PREDICTOR_TRANSFORM || type == CROSS_COLOR_TRANSFORM) {
        t.bits = int(br_.read(3)) + 2;
        bool dummy = false;
        t.data = decode_stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false,
                               &dummy);
      } else if (type == COLOR_INDEXING_TRANSFORM) {
        const int num_colors = int(br_.read(8)) + 1;
        const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
        transform_xsize = subsample(t.xsize, bits);
        t.bits = bits;
        bool dummy = false;
        std::vector<uint32_t> pal = decode_stream(num_colors, 1, false, &dummy);
        const int final_num_colors = 1 << (8 >> bits);
        t.data.assign(final_num_colors, 0);
        t.data[0] = pal[0];
        uint8_t* const nd = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* const od = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 4; i < 4 * num_colors; ++i) nd[i] = uint8_t(od[i] + nd[i - 4]);
      }
      transforms_.push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br_.read(1)) {
    cache_bits = int(br_.read(4));
    if (cache_bits < 1 || cache_bits > 11) corrupt("VP8L: bad colour cache size");
  }
  // the meta codes of this (sub-)image are read after its own sub-images
  read_huffman_codes(transform_xsize, ysize, cache_bits, level0);
  cache_bits_ = cache_bits;
  std::vector<uint32_t> data(size_t(transform_xsize) * ysize, 0);
  if (use_8b) {
    // libwebp's 8-bit alpha path: only a colour-indexing transform, no
    // cache, and red, blue and alpha codes of one symbol each
    bool ok = level0 && transforms_.size() == 1 &&
              transforms_[0].type == COLOR_INDEXING_TRANSFORM && cache_bits == 0;
    for (const HTreeGroup& g : groups_)
      ok = ok && g.h[1].single >= 0 && g.h[2].single >= 0 && g.h[3].single >= 0;
    *use_8b = ok;
  }
  decode_data(data, transform_xsize, ysize, use_8b && *use_8b);
  return data;
}

void VP8LDecoder::decode_data(std::vector<uint32_t>& data, int width, int height, bool alpha_8b) {
  const int len_code_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES;
  const int cache_size = cache_bits_ > 0 ? 1 << cache_bits_ : 0;
  const int color_cache_limit = len_code_limit + cache_size;
  std::vector<uint32_t> cache(cache_size, 0);
  const int cache_shift = 32 - cache_bits_;
  size_t last_cached = 0;
  const size_t end = size_t(width) * height;
  size_t pos = 0;
  int col = 0, row = 0;
  const int hbits = huffman_bits_;
  auto group_at = [&](int c, int r) -> const HTreeGroup& {
    if (huffman_image_.empty()) return groups_[0];
    return groups_[huffman_image_[size_t(r >> hbits) * huffman_xsize_ + (c >> hbits)]];
  };
  auto insert_cache = [&]() {
    if (cache_size) {
      while (last_cached < pos) {
        const uint32_t argb = data[last_cached++];
        cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
      }
    }
  };
  bool error = false;
  // libwebp's 32-bit path stops as soon as a read passes the end; its
  // 8-bit alpha path checks before each symbol
  while (pos < end) {
    if (alpha_8b && br_.eos()) break;
    const HTreeGroup& g = group_at(col, row);
    const int code = g.h[0].read(br_);
    if (!alpha_8b && br_.eos()) break;
    if (code < NUM_LITERAL_CODES) {
      if (alpha_8b) {
        data[pos] = uint32_t(code) << 8;
      } else {
        const int red = g.h[1].read(br_);
        const int blue = g.h[2].read(br_);
        const int alpha = g.h[3].read(br_);
        if (br_.eos()) break;
        data[pos] = (uint32_t(alpha) << 24) | (red << 16) | (code << 8) | blue;
      }
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
        insert_cache();
      }
    } else if (code < len_code_limit) {
      const int length_sym = code - NUM_LITERAL_CODES;
      auto copy_value = [&](int sym) -> int {
        if (sym < 4) return sym + 1;
        const int extra_bits = (sym - 2) >> 1;
        const int offset = (2 + (sym & 1)) << extra_bits;
        return offset + int(br_.read(extra_bits)) + 1;
      };
      const int length = copy_value(length_sym);
      const int dist_symbol = g.h[4].read(br_);
      const int dist_code = copy_value(dist_symbol);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int dc = kCodeToPlane[dist_code - 1];
        const int yoffset = dc >> 4;
        const int xoffset = 8 - (dc & 0xf);
        dist = yoffset * width + xoffset;
        if (dist < 1) dist = 1;
      }
      if (!alpha_8b && br_.eos()) break;
      if (pos < size_t(dist) || end - pos < size_t(length)) {
        error = true;
        break;
      }
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      insert_cache();
    } else if (code < color_cache_limit) {
      insert_cache();
      data[pos] = cache[code - len_code_limit];
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
        insert_cache();
      }
    } else {
      error = true;
      break;
    }
  }
  if (error) corrupt("VP8L: bad backward reference");
  if (br_.eos() && (pos < end || !alpha_8b)) truncated("VP8L: premature end of stream");
}

std::vector<uint32_t> VP8LDecoder::decode_image(int width, int height, bool alpha) {
  bool use_8b = false;
  std::vector<uint32_t> img = decode_stream(width, height, true, alpha ? &use_8b : nullptr);
  for (size_t n = transforms_.size(); n-- > 0;) inverse_transform(transforms_[n], img);
  return img;
}

// ===========================================================================
// ALPH
// ===========================================================================

void unfilter_alpha(int filter, uint8_t* plane, int width, int height) {
  for (int y = 0; y < height; ++y) {
    uint8_t* out = plane + size_t(y) * width;
    const uint8_t* prev = y ? out - width : nullptr;
    const uint8_t* in = out;  // in place, as libwebp's lossless path
    if (filter == 0) continue;
    if (filter == 1 || prev == nullptr) {
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        out[i] = uint8_t(pred + in[i]);
        pred = out[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) out[i] = uint8_t(prev[i] + in[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = uint8_t(in[i] + ((g & ~0xff) == 0 ? g : (g < 0) ? 0 : 255));
        top_left = top;
        out[i] = left;
      }
    }
  }
}

std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t size, int width, int height) {
  if (size <= 1) corrupt("ALPH: no data");
  const int method = data[0] & 3;
  const int filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3;
  const int rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || rsrv != 0) corrupt("ALPH: bad header");
  std::vector<uint8_t> plane(size_t(width) * height);
  if (method == 0) {
    if (size - 1 < plane.size()) corrupt("ALPH: short raw data");
    memcpy(plane.data(), data + 1, plane.size());
  } else {
    VP8LDecoder dec(data + 1, size - 1);
    const std::vector<uint32_t> argb = dec.decode_image(width, height, true);
    for (size_t i = 0; i < plane.size(); ++i) plane[i] = uint8_t(argb[i] >> 8);
  }
  unfilter_alpha(filter, plane.data(), width, height);
  return plane;
}

// ===========================================================================
// WebPDecode (dec/webp_dec.c): the headers, then the bitstream
// ===========================================================================

enum Status { ST_OK, ST_NOT_ENOUGH_DATA, ST_BITSTREAM_ERROR, ST_UNSUPPORTED };

struct Headers {
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  size_t offset = 0;  // of the VP8 / VP8L bitstream
  bool lossless = false;
  int width = 0, height = 0, has_alpha = 0, animation = 0;
};

bool vp8_get_info(const uint8_t* data, size_t data_size, size_t chunk_size, int* w, int* h) {
  if (data_size < 10) return false;
  if (!(data[3] == 0x9d && data[4] == 0x01 && data[5] == 0x2a)) return false;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int ww = ((data[7] << 8) | data[6]) & 0x3fff;
  const int hh = ((data[9] << 8) | data[8]) & 0x3fff;
  if (bits & 1) return false;
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  if (ww == 0 || hh == 0) return false;
  *w = ww;
  *h = hh;
  return true;
}

bool vp8l_check_signature(const uint8_t* data, size_t size) {
  return size >= 5 && data[0] == 0x2f && (data[4] >> 5) == 0;
}

bool vp8l_get_info(const uint8_t* data, size_t size, int* w, int* h, int* a) {
  if (size < 5 || !vp8l_check_signature(data, size)) return false;
  LBitReader br;
  br.init(data, size);
  if (br.read(8) != 0x2f) return false;
  *w = int(br.read(14)) + 1;
  *h = int(br.read(14)) + 1;
  *a = int(br.read(1));
  if (br.read(3) != 0) return false;
  return !br.eos();
}

// ParseHeadersInternal: ``full`` is WebPParseHeaders (have_all_data, the
// bitstream's offset), else WebPGetFeatures.
Status parse_headers(const uint8_t* data0, size_t size0, bool full, Headers& h) {
  const uint8_t* data = data0;
  size_t data_size = size0;
  int canvas_w = 0, canvas_h = 0, image_w = 0, image_h = 0;
  bool found_riff = false, found_vp8x = false;
  int has_alpha = 0;
  size_t riff_size = 0;
  const uint8_t* alpha_data = nullptr;
  size_t alpha_size = 0;
  Status status = ST_OK;
  bool lossless = false;
  if (data_size < 12) return ST_NOT_ENOUGH_DATA;
  // RIFF
  if (tag(data, "RIFF")) {
    if (!tag(data + 8, "WEBP")) return ST_BITSTREAM_ERROR;
    const uint32_t size = le32(data + 4);
    if (size < 4 + 8) return ST_BITSTREAM_ERROR;
    if (size > MAX_CHUNK_PAYLOAD) return ST_BITSTREAM_ERROR;
    if (full && size > data_size - 8) return ST_NOT_ENOUGH_DATA;
    riff_size = size;
    data += 12;
    data_size -= 12;
  }
  found_riff = riff_size > 0;
  // VP8X
  {
    uint32_t flags = 0;
    if (data_size < 8) return ST_NOT_ENOUGH_DATA;
    if (tag(data, "VP8X")) {
      if (le32(data + 4) != 10) return ST_BITSTREAM_ERROR;
      if (data_size < 18) return ST_NOT_ENOUGH_DATA;
      flags = le32(data + 8);
      const int w = 1 + int(le24(data + 12));
      const int hh = 1 + int(le24(data + 15));
      if (uint64_t(w) * uint64_t(hh) >= MAX_IMAGE_AREA) return ST_BITSTREAM_ERROR;
      canvas_w = w;
      canvas_h = hh;
      data += 18;
      data_size -= 18;
      found_vp8x = true;
    }
    if (!found_riff && found_vp8x) return ST_BITSTREAM_ERROR;
    has_alpha = !!(flags & ALPHA_FLAG);
    h.animation = !!(flags & ANIMATION_FLAG);
    image_w = canvas_w;
    image_h = canvas_h;
    if (found_vp8x && h.animation && !full) goto done;
  }
  if (data_size < 4) {
    status = ST_NOT_ENOUGH_DATA;
    goto done;
  }
  if ((found_riff && found_vp8x) || (!found_riff && !found_vp8x && tag(data, "ALPH"))) {
    // ParseOptionalChunks
    uint32_t total_size = 4 + 8 + 10;
    const uint8_t* buf = data;
    size_t buf_size = data_size;
    for (;;) {
      data = buf;
      data_size = buf_size;
      if (buf_size < 8) {
        status = ST_NOT_ENOUGH_DATA;
        goto done;
      }
      const uint32_t chunk_size = le32(buf + 4);
      if (chunk_size > MAX_CHUNK_PAYLOAD) return ST_BITSTREAM_ERROR;
      const uint32_t disk_chunk_size = (8 + chunk_size + 1) & ~1u;
      total_size += disk_chunk_size;
      if (riff_size > 0 && total_size > riff_size) return ST_BITSTREAM_ERROR;
      if (tag(buf, "VP8 ") || tag(buf, "VP8L")) break;
      if (buf_size < disk_chunk_size) {
        status = ST_NOT_ENOUGH_DATA;
        goto done;
      }
      if (tag(buf, "ALPH")) {
        alpha_data = buf + 8;
        alpha_size = chunk_size;
      }
      buf += disk_chunk_size;
      buf_size -= disk_chunk_size;
    }
  }
  // ParseVP8Header
  {
    if (data_size < 8) {
      status = ST_NOT_ENOUGH_DATA;
      goto done;
    }
    size_t compressed_size;
    const bool is_vp8 = tag(data, "VP8 "), is_vp8l = tag(data, "VP8L");
    if (is_vp8 || is_vp8l) {
      const uint32_t size = le32(data + 4);
      if (riff_size >= 12 && size > riff_size - 12) return ST_BITSTREAM_ERROR;
      if (full && size > data_size - 8) return ST_NOT_ENOUGH_DATA;
      compressed_size = size;
      data += 8;
      data_size -= 8;
      lossless = is_vp8l;
    } else {
      lossless = vp8l_check_signature(data, data_size);
      compressed_size = data_size;
    }
    if (compressed_size > MAX_CHUNK_PAYLOAD) return ST_BITSTREAM_ERROR;
    if (!lossless) {
      if (data_size < 10) {
        status = ST_NOT_ENOUGH_DATA;
        goto done;
      }
      if (!vp8_get_info(data, data_size, compressed_size, &image_w, &image_h))
        return ST_BITSTREAM_ERROR;
    } else {
      if (data_size < 5) {
        status = ST_NOT_ENOUGH_DATA;
        goto done;
      }
      if (!vp8l_get_info(data, data_size, &image_w, &image_h, &has_alpha))
        return ST_BITSTREAM_ERROR;
    }
    if (found_vp8x && (canvas_w != image_w || canvas_h != image_h)) return ST_BITSTREAM_ERROR;
    h.offset = size_t(data - data0);
  }
done:
  if (status == ST_OK || (status == ST_NOT_ENOUGH_DATA && found_vp8x && !full)) {
    h.has_alpha = has_alpha | (alpha_data != nullptr);
    h.width = image_w;
    h.height = image_h;
    h.alpha = alpha_data;
    h.alpha_size = alpha_size;
    h.lossless = lossless;
    return ST_OK;
  }
  return status;
}

[[noreturn]] void raise_status(Status s, const char* what) {
  if (s == ST_NOT_ENOUGH_DATA) truncated(std::string(what) + ": not enough data");
  if (s == ST_UNSUPPORTED) corrupt(std::string(what) + ": an animation");
  corrupt(std::string(what) + ": bitstream error");
}

// WebPDecode of ``data`` into RGBA rows of ``stride`` bytes; a picture
// wider than ``max_w`` or taller than ``max_h`` (the room left on the
// canvas) is refused.
void webp_decode(const uint8_t* data, size_t size, uint8_t* out, size_t stride, int max_w,
                 int max_h) {
  Headers h;
  const Status s = parse_headers(data, size, true, h);
  if (s != ST_OK) raise_status(s, "WebP");
  if (h.animation) corrupt("WebP: an animation where a still image was expected");
  const uint8_t* bits = data + h.offset;
  const size_t nbits = size - h.offset;
  if (h.width > max_w || h.height > max_h) corrupt("WebP: frame outside its canvas");
  if (!h.lossless) {
    VP8Frame f;
    VP8Decoder dec;
    dec.decode(bits, nbits, f);
    emit_fancy_rgba(f, out, stride);
    if (h.alpha) {
      const std::vector<uint8_t> a = decode_alpha(h.alpha, h.alpha_size, f.width, f.height);
      for (int y = 0; y < f.height; ++y)
        for (int x = 0; x < f.width; ++x) out[y * stride + 4 * x + 3] = a[size_t(y) * f.width + x];
    }
  } else {
    VP8LDecoder dec(bits, nbits);
    int w, hh, a;
    dec.read_header(&w, &hh, &a);
    const std::vector<uint32_t> argb = dec.decode_image(w, hh, false);
    for (int y = 0; y < hh; ++y) {
      uint8_t* row = out + y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[size_t(y) * w + x];
        row[4 * x + 0] = uint8_t(p >> 16);
        row[4 * x + 1] = uint8_t(p >> 8);
        row[4 * x + 2] = uint8_t(p);
        row[4 * x + 3] = uint8_t(p >> 24);
      }
    }
  }
}

// ===========================================================================
// The demuxer (demux/demux.c) and frame 0 (demux/anim_decode.c)
// ===========================================================================

enum Parse { P_OK, P_NEED_MORE, P_ERROR };

struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  int has_alpha = 0, complete = 0, frame_num = 0;
  size_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
};

struct Demux {
  const uint8_t* buf = nullptr;
  size_t start = 0, end = 0, riff_end = 0;
  int is_ext = 0;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  int num_frames = 0;
  bool done = false;
  std::vector<Frame> frames;

  size_t avail() const { return end - start; }
  bool size_invalid(size_t size) const { return size > riff_end - start; }
  uint32_t read_le32() {
    const uint32_t v = le32(buf + start);
    start += 4;
    return v;
  }
  uint32_t read_le24() {
    const uint32_t v = le24(buf + start);
    start += 3;
    return v;
  }

  Parse store_frame(int frame_num, uint32_t min_size, Frame& f);
  Parse parse_single_image();
  Parse parse_anim_frame(uint32_t frame_chunk_size);
  Parse parse_vp8x();
  bool valid_simple() const;
  bool valid_extended() const;
};

Parse Demux::store_frame(int frame_num, uint32_t min_size, Frame& f) {
  int alpha_chunks = 0, image_chunks = 0;
  bool done_ = (avail() < 8 || avail() < min_size);
  Parse status = P_OK;
  if (done_) return P_NEED_MORE;
  do {
    const size_t chunk_start = start;
    const uint8_t* fourcc = buf + start;
    start += 4;
    const uint32_t payload_size = read_le32();
    if (payload_size > MAX_CHUNK_PAYLOAD) return P_ERROR;
    const uint32_t padded = payload_size + (payload_size & 1);
    const size_t payload_available = padded > avail() ? avail() : padded;
    const size_t chunk_size = 8 + payload_available;
    if (size_invalid(padded)) return P_ERROR;
    if (padded > avail()) status = P_NEED_MORE;
    bool leave = false;
    if (tag(fourcc, "ALPH")) {
      if (alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_off = chunk_start;
        f.alpha_size = chunk_size;
        f.has_alpha = 1;
        f.frame_num = frame_num;
        start += payload_available;
      } else {
        leave = true;
      }
    } else if (tag(fourcc, "VP8L") || tag(fourcc, "VP8 ")) {
      if (tag(fourcc, "VP8L") && alpha_chunks > 0) return P_ERROR;
      if (image_chunks == 0) {
        Headers feat;
        const Status vs = parse_headers(buf + chunk_start, chunk_size, false, feat);
        if (status == P_NEED_MORE && vs == ST_NOT_ENOUGH_DATA) return P_NEED_MORE;
        if (vs != ST_OK) return P_ERROR;
        ++image_chunks;
        f.img_off = chunk_start;
        f.img_size = chunk_size;
        f.w = feat.width;
        f.h = feat.height;
        f.has_alpha |= feat.has_alpha;
        f.frame_num = frame_num;
        f.complete = (status == P_OK);
        start += payload_available;
      } else {
        leave = true;
      }
    } else {
      leave = true;
    }
    if (leave) {
      start -= 8;
      done_ = true;
    }
    if (start == riff_end) {
      done_ = true;
    } else if (avail() < 8) {
      status = P_NEED_MORE;
    }
  } while (!done_ && status == P_OK);
  return status;
}

Parse Demux::parse_single_image() {
  if (!frames.empty()) return P_ERROR;
  if (size_invalid(8)) return P_ERROR;
  if (avail() < 8) return P_NEED_MORE;
  Frame f;
  Parse status = store_frame(1, 0, f);
  if (status != P_ERROR) {
    const int has_alpha = !!(flags & ALPHA_FLAG);
    if (!has_alpha && f.alpha_size > 0) {
      f.alpha_off = 0;
      f.alpha_size = 0;
      f.has_alpha = 0;
    }
    if (!is_ext && f.w > 0 && f.h > 0) {
      canvas_w = f.w;
      canvas_h = f.h;
      flags |= f.has_alpha ? ALPHA_FLAG : 0;
    }
    // AddFrame: a frame left incomplete before this one is an error
    if (!frames.empty() && !frames.back().complete) return P_ERROR;
    frames.push_back(f);
    num_frames = 1;
  }
  return status;
}

Parse Demux::parse_anim_frame(uint32_t frame_chunk_size) {
  const int is_animation = !!(flags & ANIMATION_FLAG);
  const uint32_t anmf_payload_size = frame_chunk_size - 16;
  if (size_invalid(16)) return P_ERROR;
  if (frame_chunk_size < 16) return P_ERROR;
  if (avail() < 16) return P_NEED_MORE;
  Frame f;
  f.x = 2 * int(read_le24());
  f.y = 2 * int(read_le24());
  f.w = 1 + int(read_le24());
  f.h = 1 + int(read_le24());
  read_le24();  // duration
  start += 1;   // dispose / blend bits
  if (uint64_t(f.w) * uint64_t(f.h) >= MAX_IMAGE_AREA) return P_ERROR;
  const size_t start_offset = start;
  Parse status = store_frame(num_frames + 1, anmf_payload_size, f);
  if (status != P_ERROR && start - start_offset > anmf_payload_size) status = P_ERROR;
  if (status != P_ERROR && is_animation && f.frame_num > 0) {
    if (!frames.empty() && !frames.back().complete) return P_ERROR;
    frames.push_back(f);
    ++num_frames;
  }
  return status;
}

Parse Demux::parse_vp8x() {
  if (avail() < 8) return P_NEED_MORE;
  is_ext = 1;
  start += 4;
  uint32_t vp8x_size = read_le32();
  if (vp8x_size > MAX_CHUNK_PAYLOAD) return P_ERROR;
  if (vp8x_size < 10) return P_ERROR;
  vp8x_size += vp8x_size & 1;
  if (size_invalid(vp8x_size)) return P_ERROR;
  if (avail() < vp8x_size) return P_NEED_MORE;
  flags = buf[start];
  start += 4;
  canvas_w = 1 + int(read_le24());
  canvas_h = 1 + int(read_le24());
  if (uint64_t(canvas_w) * uint64_t(canvas_h) >= MAX_IMAGE_AREA) return P_ERROR;
  start += vp8x_size - 10;
  if (size_invalid(8)) return P_ERROR;
  if (avail() < 8) return P_NEED_MORE;
  // ParseVP8XChunks
  const int is_animation = !!(flags & ANIMATION_FLAG);
  int anim_chunks = 0;
  Parse status = P_OK;
  do {
    const uint8_t* fourcc = buf + start;
    start += 4;
    const uint32_t chunk_size = read_le32();
    if (chunk_size > MAX_CHUNK_PAYLOAD) return P_ERROR;
    const uint32_t padded = chunk_size + (chunk_size & 1);
    if (size_invalid(padded)) return P_ERROR;
    if (tag(fourcc, "VP8X")) return P_ERROR;
    if (tag(fourcc, "ALPH") || tag(fourcc, "VP8 ") || tag(fourcc, "VP8L")) {
      if (anim_chunks > 0 || is_animation) return P_ERROR;
      start -= 8;
      status = parse_single_image();
    } else if (tag(fourcc, "ANIM")) {
      if (padded < 6) return P_ERROR;
      if (avail() < padded) {
        status = P_NEED_MORE;
      } else if (anim_chunks == 0) {
        ++anim_chunks;
        start += padded;  // background colour, loop count
      } else if (padded <= avail()) {
        start += padded;
      } else {
        status = P_NEED_MORE;
      }
    } else if (tag(fourcc, "ANMF")) {
      if (anim_chunks == 0) return P_ERROR;
      status = parse_anim_frame(padded);
    } else {
      if (padded <= avail()) {
        start += padded;
      } else {
        status = P_NEED_MORE;
      }
    }
    if (start == riff_end) {
      break;
    } else if (avail() < 8) {
      status = P_NEED_MORE;
    }
  } while (status == P_OK);
  return status;
}

bool Demux::valid_simple() const {
  if (canvas_w <= 0 || canvas_h <= 0) return false;
  if (done && frames.empty()) return false;
  if (frames[0].w <= 0 || frames[0].h <= 0) return false;
  return true;
}

bool Demux::valid_extended() const {
  const int is_animation = !!(flags & ANIMATION_FLAG);
  if (canvas_w <= 0 || canvas_h <= 0) return false;
  if (done && frames.empty()) return false;
  if (flags & ~ALL_VALID_FLAGS) return false;
  for (size_t i = 0; i < frames.size(); ++i) {
    const Frame& f = frames[i];
    if (!is_animation && f.frame_num > 1) return false;
    if (f.complete) {
      if (f.alpha_size == 0 && f.img_size == 0) return false;
      if (f.alpha_size > 0 && f.alpha_off > f.img_off) return false;
      if (f.w <= 0 || f.h <= 0) return false;
    } else {
      if (done) return false;
      if (f.alpha_size > 0 && f.img_size > 0 && f.alpha_off > f.img_off) return false;
      if (i + 1 < frames.size()) return false;
    }
    if (f.w > 0 && f.h > 0) {
      if (!is_animation) {
        if (f.x != 0 || f.y != 0 || f.w != canvas_w || f.h != canvas_h) return false;
      } else {
        if (f.x + f.w > canvas_w || f.y + f.h > canvas_h) return false;
      }
    }
  }
  return true;
}

// WebPDemux (not partial): the frames, or an error
void demux(const uint8_t* data, size_t n, Demux& d) {
  if (n < 20) truncated("WebP: truncated header");
  if (!tag(data, "RIFF") || !tag(data + 8, "WEBP")) corrupt("WebP: not a WebP file");
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 8) corrupt("WebP: bad RIFF size");
  if (riff_size > MAX_CHUNK_PAYLOAD) corrupt("WebP: bad RIFF size");
  d.buf = data;
  d.riff_end = size_t(riff_size) + 8;
  d.end = std::min(n, d.riff_end);
  if (d.end < d.riff_end) truncated("WebP: the file ends before its RIFF chunk does");
  d.start = 12;
  Parse status = P_ERROR;
  bool known = false;
  const uint8_t* master = data + 12;
  if (tag(master, "VP8 ") || tag(master, "VP8L")) {
    known = true;
    status = d.parse_single_image();
    if (status == P_OK) d.done = true;
    if (status == P_NEED_MORE) status = P_ERROR;
    if (status != P_ERROR && !d.valid_simple()) status = P_ERROR;
  } else if (tag(master, "VP8X")) {
    known = true;
    status = d.parse_vp8x();
    if (status == P_OK) d.done = true;
    if (status == P_NEED_MORE) status = P_ERROR;
    if (status != P_ERROR && !d.valid_extended()) status = P_ERROR;
  }
  if (!known || status == P_ERROR) corrupt("WebP: the container is not valid");
}

struct Info {
  int canvas_w = 0, canvas_h = 0, alpha = 0, x = 0, y = 0, w = 0, h = 0, lossless = 0, frames = 0;
  // frame 0's bytes as the decoder sees them
  const uint8_t* frag = nullptr;
  size_t frag_size = 0;
};

// What OpenCV's header step reads: WebPGetFeatures of the first 32 bytes
// (the canvas that imread checks against its size limits).
Headers cv2_features(const uint8_t* data, size_t n) {
  if (n < 32) corrupt("WebP: OpenCV reads no file under 32 bytes");
  Headers feat;
  const Status s = parse_headers(data, 32, false, feat);
  if (s != ST_OK) raise_status(s, "WebP");
  return feat;
}

Info read_info(const uint8_t* data, size_t n, bool cv2) {
  Info info;
  if (cv2) {
    const Headers feat = cv2_features(data, n);
    if (!feat.animation) {
      Headers full;
      const Status s2 = parse_headers(data, n, true, full);
      if (s2 != ST_OK) raise_status(s2, "WebP");
      if (full.animation) corrupt("WebP: an animation");
      info.canvas_w = info.w = full.width;
      info.canvas_h = info.h = full.height;
      info.alpha = full.has_alpha;
      info.lossless = full.lossless;
      info.frames = 1;
      info.frag = data;
      info.frag_size = n;
      return info;
    }
  } else {
    if (n < 16 || !tag(data, "RIFF") || !tag(data + 8, "WEBP") ||
        !(tag(data + 12, "VP8 ") || tag(data + 12, "VP8L") || tag(data + 12, "VP8X")))
      corrupt("WebP: not a WebP file");
  }
  Demux d;
  demux(data, n, d);
  const Frame& f = d.frames[0];
  info.canvas_w = d.canvas_w;
  info.canvas_h = d.canvas_h;
  info.x = f.x;
  info.y = f.y;
  info.w = f.w;
  info.h = f.h;
  info.frames = d.num_frames;
  size_t off = f.img_off, size = f.img_size;
  if (f.alpha_size > 0) {
    const size_t inter = (f.img_off > 0) ? f.img_off - (f.alpha_off + f.alpha_size) : 0;
    off = f.alpha_off;
    size += f.alpha_size + inter;
  }
  info.frag = data + off;
  info.frag_size = size;
  info.lossless = (f.img_size >= 4 && tag(data + f.img_off, "VP8L"));
  // Pillow's mode: WebPGetFeatures of the whole file
  Headers feat;
  info.alpha = (parse_headers(data, n, false, feat) == ST_OK) ? feat.has_alpha : 1;
  return info;
}

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.what());
  return e.code;
}

}  // namespace

extern "C" {

int sl_webp_info(const uint8_t* data, size_t n, int cv2, int* out, char* err, int errlen) {
  try {
    const Info info = read_info(data, n, cv2 != 0);
    const int v[9] = {info.canvas_w, info.canvas_h, info.alpha, info.x, info.y,
                      info.w, info.h, info.lossless, info.frames};
    memcpy(out, v, sizeof(v));
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_CORRUPT, "WebP: out of memory"), err, errlen);
  }
}

int sl_webp_header_cv2(const uint8_t* data, size_t n, int* size, char* err, int errlen) {
  try {
    const Headers feat = cv2_features(data, n);
    if (feat.animation) {  // the animation decoder is made in the header step
      Demux d;
      demux(data, n, d);
    }
    size[0] = feat.width;
    size[1] = feat.height;
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_CORRUPT, "WebP: out of memory"), err, errlen);
  }
}

int sl_webp_decode(const uint8_t* data, size_t n, int cv2, uint8_t* out, char* err, int errlen) {
  try {
    const Info info = read_info(data, n, cv2 != 0);
    const size_t stride = size_t(info.canvas_w) * 4;
    uint8_t* const dst = out + size_t(info.y) * stride + size_t(info.x) * 4;
    webp_decode(info.frag, info.frag_size, dst, stride, info.canvas_w - info.x,
                info.canvas_h - info.y);
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_CORRUPT, "WebP: out of memory"), err, errlen);
  }
}

}  // extern "C"
