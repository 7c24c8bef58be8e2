// The parts of the port's AV1 codec that its decoder (sl_av1.cpp) and its
// encoder (sl_av1_enc.cpp) share: the specification's sizes and scans, the
// CDFs of a tile, and the reconstruction of a frame (struct Recon): intra
// prediction with the edge filter and upsampling, CfL, filter intra and
// palettes, dequantisation with the quantizer matrices and the inverse
// transforms, the deblocking filter, and the
// contexts the block syntax derives from what was decoded before. The
// encoder reconstructs through these functions, so its reconstruction is
// the decoder's by construction. Planes hold 16-bit samples and every step
// follows seq.BitDepth (8, 10 or 12); the encoder writes 8 bits.
//
// The names of variables and functions are the specification's (AV1
// Bitstream & Decoding Process Specification) where it has one.

#pragma once

#include <algorithm>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "sl_av1.h"
#include "sl_av1_tables.h"
#include "sl_av1_tables_hbd.h"

namespace sl_av1 {

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] inline void fail(int code, const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Fail{code, buf};
}

[[noreturn]] inline void unsupported(const char* what) { fail(SL_UNSUPPORTED, "AV1 %s is not supported", what); }

inline int Clip3(int lo, int hi, int x) { return x < lo ? lo : (x > hi ? hi : x); }
// Clip1 of samples of ``bitDepth`` bits
inline int ClipBd(int x, int bitDepth) { return Clip3(0, (1 << bitDepth) - 1, x); }
inline int Round2(int x, int n) { return n == 0 ? x : (x + (1 << (n - 1))) >> n; }
inline int64_t Round2L(int64_t x, int n) { return n == 0 ? x : (x + ((int64_t)1 << (n - 1))) >> n; }
inline int Round2Signed(int x, int n) { return x >= 0 ? Round2(x, n) : -Round2(-x, n); }
inline int FloorLog2(uint32_t x) {
  int s = 0;
  while (x > 1) {
    x >>= 1;
    s++;
  }
  return s;
}
inline int CeilLog2(uint32_t x) {
  if (x < 2) return 0;
  int i = 1;
  uint32_t p = 2;
  while (p < x) {
    i++;
    p <<= 1;
  }
  return i;
}

// ---------------------------------------------------------------------------
// sizes
// ---------------------------------------------------------------------------

enum {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32,
  BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64,
  BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
  BLOCK_SIZES, BLOCK_INVALID = BLOCK_SIZES
};
const uint8_t Num_4x4_Blocks_Wide[BLOCK_SIZES] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8,
                                                  16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const uint8_t Num_4x4_Blocks_High[BLOCK_SIZES] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16,
                                                  8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const uint8_t Mi_Width_Log2[BLOCK_SIZES] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const uint8_t Mi_Height_Log2[BLOCK_SIZES] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
inline int Block_Width(int b) { return 4 * Num_4x4_Blocks_Wide[b]; }
inline int Block_Height(int b) { return 4 * Num_4x4_Blocks_High[b]; }
inline uint8_t BlockOf[6][6];  // [log2 w4][log2 h4]

enum {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32,
  TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL
};
const uint8_t Tx_Width_Log2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t Tx_Height_Log2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
inline int Tx_Width(int t) { return 1 << Tx_Width_Log2[t]; }
inline int Tx_Height(int t) { return 1 << Tx_Height_Log2[t]; }
const uint8_t Tx_Size_Sqr[TX_SIZES_ALL] = {TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X4, TX_4X4,
                                           TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
                                           TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16};
const uint8_t Tx_Size_Sqr_Up[TX_SIZES_ALL] = {TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_8X8,
                                              TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
                                              TX_64X64, TX_64X64, TX_16X16, TX_16X16, TX_32X32,
                                              TX_32X32, TX_64X64, TX_64X64};
const uint8_t Split_Tx_Size[TX_SIZES_ALL] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4,
                                             TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
                                             TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16};
const uint8_t Max_Tx_Size_Rect[BLOCK_SIZES] = {
    TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16, TX_16X8, TX_16X16, TX_16X32, TX_32X16, TX_32X32, TX_32X64,
    TX_64X32, TX_64X64, TX_64X64, TX_64X64, TX_64X64, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16};
const uint8_t Transform_Row_Shift[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};
inline uint8_t TxOf[5][5];  // [log2 w - 2][log2 h - 2]
inline int Adjusted_Tx_Size(int t) {
  return TxOf[std::min<int>(Tx_Width_Log2[t], 5) - 2][std::min<int>(Tx_Height_Log2[t], 5) - 2];
}

enum {
  PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
  PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4
};

enum {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
  SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED
};
const int Mode_To_Angle[9] = {0, 90, 180, 45, 135, 113, 157, 203, 67};
const uint8_t Intra_Mode_Context[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
inline bool is_directional_mode(int m) { return m >= V_PRED && m <= D67_PRED; }

enum {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST,
  FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 };
enum { TX_SET_INTER_1 = 1, TX_SET_INTER_2, TX_SET_INTER_3 };
const uint8_t Tx_Type_Intra_Inv_Set1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t Tx_Type_Intra_Inv_Set2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t Tx_Type_Inter_Inv_Set1[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT,
                                            ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                                            FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const uint8_t Tx_Type_Inter_Inv_Set2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
                                            DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
                                            FLIPADST_ADST};
const uint8_t Tx_Type_Inter_Inv_Set3[2] = {IDTX, DCT_DCT};
const uint8_t Tx_Type_In_Set_Intra[3][16] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0},
    {1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0}};
const uint8_t Tx_Type_In_Set_Inter[4][16] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0}};
const uint8_t Mode_To_Txfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                                  DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
const uint8_t Filter_Intra_Mode_To_Intra_Dir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
inline int get_tx_class(int t) {
  if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
  if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
  return TX_CLASS_2D;
}

const int Segmentation_Feature_Bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int Segmentation_Feature_Signed[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int Segmentation_Feature_Max[8] = {255, 63, 63, 63, 63, 7, 0, 0};
enum { SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_REF_FRAME = 5, SEG_LVL_SKIP = 6 };

const int Palette_Color_Context[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
const int Palette_Color_Hash_Multipliers[3] = {1, 2, 2};
const int Intra_Edge_Kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

// Coeff_Base_Ctx_Offset and the scans are built at first use (init_tables)
inline int8_t Coeff_Base_Ctx_Offset[TX_SIZES_ALL][5][5];
const int Coeff_Base_Pos_Ctx_Offset[3] = {26, 31, 36};
const int Mag_Ref_Offset_With_Tx_Class[3][3][2] = {
    {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
const int Sig_Ref_Diff_Offset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
// scans by (log2 w - 2, log2 h - 2) for sizes up to 32: default, mrow, mcol
inline std::vector<uint16_t> Scan[3][4][4];

inline void build_transforms();

inline void build_tables() {
  for (auto& r : BlockOf)
    for (auto& v : r) v = BLOCK_INVALID;
  for (int b = 0; b < BLOCK_SIZES; b++) BlockOf[Mi_Width_Log2[b]][Mi_Height_Log2[b]] = b;
  for (int t = 0; t < TX_SIZES_ALL; t++) TxOf[Tx_Width_Log2[t] - 2][Tx_Height_Log2[t] - 2] = t;
  for (int wl = 0; wl < 4; wl++)
    for (int hl = 0; hl < 4; hl++) {
      int w = 4 << wl, h = 4 << hl;
      if (w > 4 * h || h > 4 * w) continue;
      std::vector<uint16_t>& d = Scan[0][wl][hl];
      std::vector<uint16_t>& mr = Scan[1][wl][hl];
      std::vector<uint16_t>& mc = Scan[2][wl][hl];
      for (int i = 0; i < w * h; i++) mr.push_back(i);
      for (int c = 0; c < w; c++)
        for (int r = 0; r < h; r++) mc.push_back(r * w + c);
      // the default scan: anti-diagonals; a square block alternates the
      // direction (a zig-zag), a tall one runs each from top right to bottom
      // left, a wide one from bottom left to top right
      for (int s = 0; s < w + h - 1; s++) {
        bool down;  // row increasing along the diagonal
        if (w == h) down = (s & 1);
        else down = (w < h);
        int r0 = std::max(0, s - (w - 1)), r1 = std::min(h - 1, s);
        if (down)
          for (int r = r0; r <= r1; r++) d.push_back(r * w + (s - r));
        else
          for (int r = r1; r >= r0; r--) d.push_back(r * w + (s - r));
      }
    }
  for (int t = 0; t < TX_SIZES_ALL; t++) {
    int w = Tx_Width(t), h = Tx_Height(t);
    for (int r = 0; r < 5; r++)
      for (int c = 0; c < 5; c++) {
        int v;
        if (r >= std::min(h, 5) || c >= std::min(w, 5)) {
          v = 0;
        } else if (w == h) {
          v = (r + c == 0) ? 0 : (r + c < 2 ? 1 : (r + c < 4 ? 6 : 21));
        } else if (w < h) {  // tall
          v = (r + c == 0) ? 0 : (r < 2 ? 11 : (r + c < 4 ? 6 : 21));
        } else {  // wide
          v = (r + c == 0) ? 0 : (c < 2 ? 16 : (r + c < 4 ? 6 : 21));
        }
        Coeff_Base_Ctx_Offset[t][r][c] = v;
      }
  }
  build_transforms();
}

// builds the tables once per process, whichever thread asks first
inline void init_tables() {
  static const bool built = (build_tables(), true);
  (void)built;
}

// ---------------------------------------------------------------------------
// headers
// ---------------------------------------------------------------------------

struct SequenceHeader {
  int seq_profile = 0, still_picture = 0, reduced_still_picture_header = 0;
  int timing_info_present_flag = 0, decoder_model_info_present_flag = 0, equal_picture_interval = 0;
  int buffer_removal_time_length_minus_1 = 0, frame_presentation_time_length_minus_1 = 0;
  int operating_points_cnt_minus_1 = 0;
  int operating_point_idc[32] = {0};
  int decoder_model_present_for_this_op[32] = {0};
  int frame_width_bits_minus_1 = 0, frame_height_bits_minus_1 = 0;
  int max_frame_width_minus_1 = 0, max_frame_height_minus_1 = 0;
  int frame_id_numbers_present_flag = 0, delta_frame_id_length_minus_2 = 0,
      additional_frame_id_length_minus_1 = 0;
  int use_128x128_superblock = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
  int enable_order_hint = 0, OrderHintBits = 0;
  int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
  int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
  int BitDepth = 8, mono_chrome = 0, color_range = 0, subsampling_x = 1, subsampling_y = 1;
  int color_primaries = 2, transfer_characteristics = 2, matrix_coefficients = 2;
  int separate_uv_delta_q = 0, film_grain_params_present = 0;
  int NumPlanes = 3;
  bool valid = false;
};

// the adaptation of a CDF after it coded ``sym`` (8.2.2 and 8.2.6): the
// decoder's reader and the encoder's writer both call it
inline void update_cdf(uint16_t* cdf, int N, int sym) {
  int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(FloorLog2(N), 2);
  uint32_t tmp = 0;
  for (int i = 0; i < N - 1; i++) {
    tmp = (i == sym) ? (1u << 15) : tmp;
    if (tmp < cdf[i]) cdf[i] -= (cdf[i] - tmp) >> rate;
    else cdf[i] += (tmp - cdf[i]) >> rate;
  }
  cdf[N] += (cdf[N] < 32);
}

// ---------------------------------------------------------------------------
// the adaptive CDFs of one tile
// ---------------------------------------------------------------------------

template <typename T>
inline void copy_cdf(T& dst, const T& src) {
  memcpy(&dst, &src, sizeof(T));
}

struct Cdfs {
  uint16_t y_mode[5][5][14];
  uint16_t uv_nocfl[13][14];
  uint16_t uv_cfl[13][15];
  uint16_t angle_delta[8][8];
  uint16_t part8[4][5], part16[4][11], part32[4][11], part64[4][11], part128[4][9];
  uint16_t tx_set1[2][13][8], tx_set2[3][13][6];
  uint16_t cfl_alpha[6][17], cfl_sign[9];
  uint16_t filter_intra[22][3], filter_intra_mode[6];
  uint16_t skip[3][3];
  uint16_t tx8[3][3], tx16[3][4], tx32[3][4], tx64[3][4];
  uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
  uint16_t segment_id[3][9];
  uint16_t intrabc[3];
  uint16_t inter_set1[2][17], inter_set2[13], inter_set3[4][3], txfm_split[21][3];
  uint16_t mv_joint[5], mv_class[2][12], mv_sign[2][3], mv_class0[2][3], mv_bits[2][10][3];
  uint16_t pal_y_mode[7][3][3], pal_uv_mode[2][3];
  uint16_t pal_y_size[7][8], pal_uv_size[7][8];
  uint16_t pal_y_color2[5][3], pal_y_color3[5][4], pal_y_color4[5][5], pal_y_color5[5][6],
      pal_y_color6[5][7], pal_y_color7[5][8], pal_y_color8[5][9];
  uint16_t pal_uv_color2[5][3], pal_uv_color3[5][4], pal_uv_color4[5][5], pal_uv_color5[5][6],
      pal_uv_color6[5][7], pal_uv_color7[5][8], pal_uv_color8[5][9];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9], eob256[2][2][10];
  uint16_t eob512[2][11], eob1024[2][12];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];

  void init(int base_q_idx) {
    copy_cdf(y_mode, Default_Intra_Frame_Y_Mode_Cdf);
    copy_cdf(uv_nocfl, Default_Uv_Mode_Cfl_Not_Allowed_Cdf);
    copy_cdf(uv_cfl, Default_Uv_Mode_Cfl_Allowed_Cdf);
    copy_cdf(angle_delta, Default_Angle_Delta_Cdf);
    copy_cdf(part8, Default_Partition_W8_Cdf);
    copy_cdf(part16, Default_Partition_W16_Cdf);
    copy_cdf(part32, Default_Partition_W32_Cdf);
    copy_cdf(part64, Default_Partition_W64_Cdf);
    copy_cdf(part128, Default_Partition_W128_Cdf);
    copy_cdf(tx_set1, Default_Intra_Tx_Type_Set1_Cdf);
    copy_cdf(tx_set2, Default_Intra_Tx_Type_Set2_Cdf);
    copy_cdf(cfl_alpha, Default_Cfl_Alpha_Cdf);
    copy_cdf(cfl_sign, Default_Cfl_Sign_Cdf);
    copy_cdf(filter_intra, Default_Filter_Intra_Cdf);
    copy_cdf(filter_intra_mode, Default_Filter_Intra_Mode_Cdf);
    copy_cdf(skip, Default_Skip_Cdf);
    copy_cdf(tx8, Default_Tx_8x8_Cdf);
    copy_cdf(tx16, Default_Tx_16x16_Cdf);
    copy_cdf(tx32, Default_Tx_32x32_Cdf);
    copy_cdf(tx64, Default_Tx_64x64_Cdf);
    copy_cdf(delta_q, Default_Delta_Q_Cdf);
    copy_cdf(delta_lf, Default_Delta_Lf_Cdf);
    for (auto& c : delta_lf_multi) copy_cdf(c, Default_Delta_Lf_Cdf);
    copy_cdf(segment_id, Default_Segment_Id_Cdf);
    copy_cdf(intrabc, Default_Intrabc_Cdf);
    copy_cdf(inter_set1, Default_Inter_Tx_Type_Set1_Cdf);
    copy_cdf(inter_set2, Default_Inter_Tx_Type_Set2_Cdf);
    copy_cdf(inter_set3, Default_Inter_Tx_Type_Set3_Cdf);
    copy_cdf(txfm_split, Default_Txfm_Split_Cdf);
    copy_cdf(mv_joint, Default_Mv_Joint_Cdf);
    for (int c = 0; c < 2; c++) {
      copy_cdf(mv_class[c], Default_Mv_Class_Cdf);
      copy_cdf(mv_sign[c], Default_Mv_Sign_Cdf);
      copy_cdf(mv_class0[c], Default_Mv_Class0_Bit_Cdf);
      copy_cdf(mv_bits[c], Default_Mv_Bit_Cdf);
    }
    copy_cdf(pal_y_mode, Default_Palette_Y_Mode_Cdf);
    copy_cdf(pal_uv_mode, Default_Palette_Uv_Mode_Cdf);
    copy_cdf(pal_y_size, Default_Palette_Y_Size_Cdf);
    copy_cdf(pal_uv_size, Default_Palette_Uv_Size_Cdf);
    copy_cdf(pal_y_color2, Default_Palette_Size_2_Y_Color_Cdf);
    copy_cdf(pal_y_color3, Default_Palette_Size_3_Y_Color_Cdf);
    copy_cdf(pal_y_color4, Default_Palette_Size_4_Y_Color_Cdf);
    copy_cdf(pal_y_color5, Default_Palette_Size_5_Y_Color_Cdf);
    copy_cdf(pal_y_color6, Default_Palette_Size_6_Y_Color_Cdf);
    copy_cdf(pal_y_color7, Default_Palette_Size_7_Y_Color_Cdf);
    copy_cdf(pal_y_color8, Default_Palette_Size_8_Y_Color_Cdf);
    copy_cdf(pal_uv_color2, Default_Palette_Size_2_Uv_Color_Cdf);
    copy_cdf(pal_uv_color3, Default_Palette_Size_3_Uv_Color_Cdf);
    copy_cdf(pal_uv_color4, Default_Palette_Size_4_Uv_Color_Cdf);
    copy_cdf(pal_uv_color5, Default_Palette_Size_5_Uv_Color_Cdf);
    copy_cdf(pal_uv_color6, Default_Palette_Size_6_Uv_Color_Cdf);
    copy_cdf(pal_uv_color7, Default_Palette_Size_7_Uv_Color_Cdf);
    copy_cdf(pal_uv_color8, Default_Palette_Size_8_Uv_Color_Cdf);
    int idx = base_q_idx <= 20 ? 0 : (base_q_idx <= 60 ? 1 : (base_q_idx <= 120 ? 2 : 3));
    copy_cdf(txb_skip, Default_Txb_Skip_Cdf[idx]);
    copy_cdf(eob_extra, Default_Eob_Extra_Cdf[idx]);
    copy_cdf(dc_sign, Default_Dc_Sign_Cdf[idx]);
    copy_cdf(eob16, Default_Eob_Pt_16_Cdf[idx]);
    copy_cdf(eob32, Default_Eob_Pt_32_Cdf[idx]);
    copy_cdf(eob64, Default_Eob_Pt_64_Cdf[idx]);
    copy_cdf(eob128, Default_Eob_Pt_128_Cdf[idx]);
    copy_cdf(eob256, Default_Eob_Pt_256_Cdf[idx]);
    copy_cdf(eob512, Default_Eob_Pt_512_Cdf[idx]);
    copy_cdf(eob1024, Default_Eob_Pt_1024_Cdf[idx]);
    copy_cdf(base_eob, Default_Coeff_Base_Eob_Cdf[idx]);
    copy_cdf(base, Default_Coeff_Base_Cdf[idx]);
    copy_cdf(br, Default_Coeff_Br_Cdf[idx]);
  }
};

// the CDF of a colour index of a palette of n colours
inline uint16_t* palette_color_cdf(Cdfs& cdf, int plane, int n, int ctx) {
  if (plane == 0) {
    switch (n) {
      case 2: return cdf.pal_y_color2[ctx];
      case 3: return cdf.pal_y_color3[ctx];
      case 4: return cdf.pal_y_color4[ctx];
      case 5: return cdf.pal_y_color5[ctx];
      case 6: return cdf.pal_y_color6[ctx];
      case 7: return cdf.pal_y_color7[ctx];
      default: return cdf.pal_y_color8[ctx];
    }
  }
  switch (n) {
    case 2: return cdf.pal_uv_color2[ctx];
    case 3: return cdf.pal_uv_color3[ctx];
    case 4: return cdf.pal_uv_color4[ctx];
    case 5: return cdf.pal_uv_color5[ctx];
    case 6: return cdf.pal_uv_color6[ctx];
    case 7: return cdf.pal_uv_color7[ctx];
    default: return cdf.pal_uv_color8[ctx];
  }
}

// ---------------------------------------------------------------------------
// the inverse transforms (7.13.2)
// ---------------------------------------------------------------------------

inline int brev(int numBits, int x) {
  int r = 0;
  for (int i = 0; i < numBits; i++) r |= ((x >> i) & 1) << (numBits - 1 - i);
  return r;
}
inline int cos128(int angle) {
  int angle2 = angle & 255;
  if (angle2 <= 64) return Cos128_Lookup[angle2];
  if (angle2 <= 128) return -Cos128_Lookup[128 - angle2];
  if (angle2 <= 192) return -Cos128_Lookup[angle2 - 128];
  return Cos128_Lookup[256 - angle2];
}
inline int sin128(int angle) { return cos128(angle - 64); }

// one butterfly of an inverse transform: a rotation (B) or a Hadamard
// step (H) on two of its points
struct TxOp {
  uint8_t rotate, a, b, flip;
  int32_t c, s;  // a rotation's cos128 and sin128
};

// the butterflies of the inverse DCTs of 2^n points after the input's
// bit reversal (Dct_Ops[n]), and of the inverse ADSTs of 8 and 16 points
// between their input and output permutations (Adst_Ops[n]), in the order
// the specification's processes run them (built by init_tables)
inline std::vector<TxOp> Dct_Ops[7], Adst_Ops[5];
inline uint8_t Brev[7][64];

struct Txfm {
  int32_t T[64];
  std::vector<TxOp>* rec = nullptr;  // where set, B and H record themselves
  void B(int a, int b, int angle, int flip) {
    if (rec) {
      rec->push_back({1, (uint8_t)a, (uint8_t)b, (uint8_t)flip, cos128(angle), sin128(angle)});
      return;
    }
    int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
    int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
    T[a] = (int32_t)Round2L(x, 12);
    T[b] = (int32_t)Round2L(y, 12);
    if (flip) std::swap(T[a], T[b]);
  }
  void H(int a, int b, int flip) {
    if (rec) {
      rec->push_back({0, (uint8_t)a, (uint8_t)b, (uint8_t)flip, 0, 0});
      return;
    }
    if (flip) std::swap(a, b);
    int32_t x = T[a], y = T[b];
    T[a] = x + y;
    T[b] = x - y;
  }
  // the odd half of an inverse DCT of 2^n points (positions 2^(n-1) ..
  // 2^n - 1 after the bit-reversal permutation): the first rotations, then
  // Hadamard stages of growing span, each followed by the rotations of the
  // next smaller odd half, and last the rotations by pi/4
  static int first_angle(int n, int i) { return 64 - (brev(n, (1 << (n - 1)) + i) << (6 - n)); }
  void dct_odd(int n) {
    int M = 1 << (n - 1), base = M, top = 2 * M - 1;
    for (int i = 0; i < M / 2; i++) B(base + i, top - i, first_angle(n, i), 0);
    if (n == 2) return;
    for (int g = 1, lg = 0; g <= M / 4; g *= 2, lg++) {
      for (int i = 0; i < M / (2 * g); i++)
        for (int j = 0; j < g; j++) H(base + 2 * g * i + j, base + 2 * g * i + 2 * g - 1 - j, i & 1);
      if (g < M / 4) {
        for (int i = 0; i < M / (8 * g); i++)
          for (int j = 0; j < 2 * g; j++)
            B(top - g - 4 * g * i - j, base + g + 4 * g * i + j, first_angle(n - 2 - lg, i) + 64 * (j / g), 1);
      } else {
        for (int j = 0; j < M / 4; j++) B(top - M / 4 - j, base + M / 4 + j, 32, 1);
      }
    }
  }
  void dct_core(int n) {
    if (n == 1) {
      B(0, 1, 32, 1);
      return;
    }
    dct_core(n - 1);
    dct_odd(n);
    int M = 1 << (n - 1);
    for (int i = 0; i < M; i++) H(i, 2 * M - 1 - i, 0);
  }
  // the recorded butterflies, each as B and H compute it
  void run_ops(const std::vector<TxOp>& ops) {
    for (const TxOp& o : ops) {
      if (o.rotate) {
        int64_t x = (int64_t)T[o.a] * o.c - (int64_t)T[o.b] * o.s;
        int64_t y = (int64_t)T[o.a] * o.s + (int64_t)T[o.b] * o.c;
        T[o.a] = (int32_t)Round2L(x, 12);
        T[o.b] = (int32_t)Round2L(y, 12);
        if (o.flip) std::swap(T[o.a], T[o.b]);
      } else {
        int a = o.a, b = o.b;
        if (o.flip) std::swap(a, b);
        int32_t x = T[a], y = T[b];
        T[a] = x + y;
        T[b] = x - y;
      }
    }
  }
  void dct(int n) {
    int n0 = 1 << n;
    int32_t copy[64];
    memcpy(copy, T, n0 * sizeof(int32_t));
    for (int i = 0; i < n0; i++) T[i] = copy[Brev[n][i]];
    run_ops(Dct_Ops[n]);
  }
  void adst_in_perm(int n) {
    int n0 = 1 << n;
    int32_t copy[16];
    memcpy(copy, T, n0 * sizeof(int32_t));
    for (int i = 0; i < n0; i++) {
      int idx = (i & 1) ? (i - 1) : (n0 - i - 1);
      T[i] = copy[idx];
    }
  }
  void adst_out_perm(int n) {
    int n0 = 1 << n;
    int32_t copy[16];
    memcpy(copy, T, n0 * sizeof(int32_t));
    for (int i = 0; i < n0; i++) {
      int a = ((i >> 3) & 1);
      int b = ((i >> 2) & 1) ^ ((i >> 3) & 1);
      int c = ((i >> 1) & 1) ^ ((i >> 2) & 1);
      int d = (i & 1) ^ ((i >> 1) & 1);
      int idx = ((d << 3) | (c << 2) | (b << 1) | a) >> (4 - n);
      T[i] = (i & 1) ? -copy[idx] : copy[idx];
    }
  }
  void adst4() {
    const int64_t SINPI_1_9 = Sin_Pi[1], SINPI_2_9 = Sin_Pi[2], SINPI_3_9 = Sin_Pi[3], SINPI_4_9 = Sin_Pi[4];
    int64_t s0 = SINPI_1_9 * T[0];
    int64_t s1 = SINPI_2_9 * T[0];
    int64_t s2 = SINPI_3_9 * T[1];
    int64_t s3 = SINPI_4_9 * T[2];
    int64_t s4 = SINPI_1_9 * T[2];
    int64_t s5 = SINPI_2_9 * T[3];
    int64_t s6 = SINPI_4_9 * T[3];
    int32_t a7 = T[0] - T[2];
    int32_t b7 = a7 + T[3];
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = SINPI_3_9 * b7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    int64_t x0 = s0 + s3;
    int64_t x1 = s1 + s3;
    int64_t x2 = s2;
    int64_t x3 = s0 + s1;
    x3 = x3 - s3;
    T[0] = (int32_t)Round2L(x0, 12);
    T[1] = (int32_t)Round2L(x1, 12);
    T[2] = (int32_t)Round2L(x2, 12);
    T[3] = (int32_t)Round2L(x3, 12);
  }
  void adst8() {
    adst_in_perm(3);
    run_ops(Adst_Ops[3]);
    adst_out_perm(3);
  }
  void adst8_core() {
    for (int i = 0; i < 4; i++) B(2 * i, 1 + 2 * i, 60 - 16 * i, 1);
    for (int i = 0; i < 4; i++) H(i, 4 + i, 0);
    for (int i = 0; i < 2; i++) B(4 + 3 * i, 5 + i, 48 - 32 * i, 1);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) H(4 * j + i, 2 + 4 * j + i, 0);
    for (int i = 0; i < 2; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
  }
  void adst16() {
    adst_in_perm(4);
    run_ops(Adst_Ops[4]);
    adst_out_perm(4);
  }
  void adst16_core() {
    for (int i = 0; i < 8; i++) B(2 * i, 1 + 2 * i, 62 - 8 * i, 1);
    for (int i = 0; i < 8; i++) H(i, 8 + i, 0);
    for (int i = 0; i < 2; i++) {
      B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
      B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
    }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) H(8 * j + i, 4 + 8 * j + i, 0);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) H(4 * j + i, 2 + 4 * j + i, 0);
    for (int i = 0; i < 4; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
  }
  void identity(int n) {
    int n0 = 1 << n;
    for (int i = 0; i < n0; i++) {
      if (n == 2) T[i] = (int32_t)Round2L((int64_t)T[i] * 5793, 12);
      else if (n == 3) T[i] = T[i] * 2;
      else if (n == 4) T[i] = (int32_t)Round2L((int64_t)T[i] * 11586, 12);
      else T[i] = T[i] * 4;
    }
  }
  // kind: 0 DCT, 1 ADST, 2 identity
  void run(int kind, int n) {
    if (kind == 0) dct(n);
    else if (kind == 2) identity(n);
    else if (n == 2) adst4();
    else if (n == 3) adst8();
    else adst16();
  }
};

inline void build_transforms() {
  for (int n = 2; n <= 6; n++) {
    for (int i = 0; i < (1 << n); i++) Brev[n][i] = brev(n, i);
    Txfm t;
    t.rec = &Dct_Ops[n];
    t.dct_core(n);
  }
  Txfm t;
  t.rec = &Adst_Ops[3];
  t.adst8_core();
  t.rec = &Adst_Ops[4];
  t.adst16_core();
}

// vertical (column) and horizontal (row) 1D kinds of each transform type
const uint8_t ColKind[16] = {0, 1, 0, 1, 1, 0, 1, 1, 1, 2, 0, 2, 1, 2, 1, 2};
const uint8_t RowKind[16] = {0, 0, 1, 1, 0, 1, 1, 1, 1, 2, 2, 0, 2, 1, 2, 1};

// ---------------------------------------------------------------------------
// the frame decoder
// ---------------------------------------------------------------------------

// the samples of one plane, of 8, 10 or 12 bits
struct Plane {
  std::vector<uint16_t> px;
  int stride = 0, rows = 0;
  uint16_t* at(int y, int x) { return &px[(size_t)y * stride + x]; }
};

struct ModeInfo {  // per 4x4 luma unit
  uint8_t mi_size, y_mode, uv_mode, skip, tx_size, segment_id, is_inter, written;
  int16_t mv[2];  // the intra block copy vector (row, column) in 1/8 pixels
  uint8_t palette_size[2];
  int8_t delta_lf[4];
  uint16_t palette_colors[2][8];
};

// ---------------------------------------------------------------------------
// the frame under reconstruction, shared by the decoder and the encoder
// ---------------------------------------------------------------------------

struct Recon {
  SequenceHeader seq;
  // frame header
  int FrameWidth = 0, FrameHeight = 0, MiCols = 0, MiRows = 0;
  int TileCols = 0, TileRows = 0, TileColsLog2 = 0, TileRowsLog2 = 0;
  std::vector<int> MiColStarts, MiRowStarts;
  int base_q_idx = 0, DeltaQYDc = 0, DeltaQUDc = 0, DeltaQUAc = 0, DeltaQVDc = 0, DeltaQVAc = 0;
  int segmentation_enabled = 0, FeatureEnabled[8][8] = {{0}}, FeatureData[8][8] = {{0}};
  int delta_q_present = 0, delta_lf_multi = 0;
  int loop_filter_level[4] = {0}, loop_filter_sharpness = 0, loop_filter_delta_enabled = 0;
  int loop_filter_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, loop_filter_mode_deltas[2] = {0, 0};
  int reduced_tx_set = 0;
  int using_qmatrix = 0, SegQMLevel[3][8] = {{0}};
  uint32_t QmTxSizes = 0;  // a bit for each transform size a quantizer matrix weighed
  // state
  Plane planes[3];
  std::vector<ModeInfo> mi;
  int mi_stride = 0, mi_rows_alloc = 0;
  std::vector<uint8_t> TxTypes;  // per 4x4 luma unit
  int tx_stride = 0;
  std::vector<uint8_t> LfTxSize[3];  // per 4x4 unit of each plane
  int lf_stride[3] = {0};
  std::vector<uint8_t> AboveLevelContext[3], AboveDcContext[3], LeftLevelContext[3], LeftDcContext[3];
  int MiRowStart = 0, MiRowEnd = 0, MiColStart = 0, MiColEnd = 0;
  int CurrentQIndex = 0, DeltaLF[4] = {0};
  // BlockDecoded[plane][-1 .. 32][-1 .. 32]
  uint8_t BlockDecoded[3][34][34];
  // block state
  int MiRow = 0, MiCol = 0, MiSize = 0, HasChroma = 0, AvailU = 0, AvailL = 0, AvailUChroma = 0,
      AvailLChroma = 0;
  int segment_id = 0, Lossless = 0, skip = 0, YMode = 0, UVMode = 0, AngleDeltaY = 0, AngleDeltaUV = 0;
  int CflAlphaU = 0, CflAlphaV = 0, use_filter_intra = 0, filter_intra_mode = 0, TxSize = 0;
  int PaletteSizeY = 0, PaletteSizeUV = 0, is_inter = 0;
  int Mv[2] = {0, 0};
  uint16_t palette_colors_y[8] = {0}, palette_colors_u[8] = {0}, palette_colors_v[8] = {0};
  uint8_t ColorMapY[64][64], ColorMapUV[64][64];
  int MaxLumaW = 0, MaxLumaH = 0;
  int PlaneTxType = 0;
  int32_t Quant[1024];

  // ---- tiles (5.9.15) ----------------------------------------------------

  static int tile_log2(int blkSize, int target) {
    int k = 0;
    for (; (blkSize << k) < target; k++) {
    }
    return k;
  }

  struct TileLimits {
    int sbCols, sbRows, sbShift, maxTileWidthSb, maxTileAreaSb, minLog2TileCols, maxLog2TileCols,
        maxLog2TileRows, minLog2Tiles;
  };
  TileLimits tile_limits() const {
    TileLimits t;
    t.sbCols = seq.use_128x128_superblock ? ((MiCols + 31) >> 5) : ((MiCols + 15) >> 4);
    t.sbRows = seq.use_128x128_superblock ? ((MiRows + 31) >> 5) : ((MiRows + 15) >> 4);
    t.sbShift = seq.use_128x128_superblock ? 5 : 4;
    int sbSize = t.sbShift + 2;
    t.maxTileWidthSb = 4096 >> sbSize;
    t.maxTileAreaSb = (4096 * 2304) >> (2 * sbSize);
    t.minLog2TileCols = tile_log2(t.maxTileWidthSb, t.sbCols);
    t.maxLog2TileCols = tile_log2(1, std::min(t.sbCols, 64));
    t.maxLog2TileRows = tile_log2(1, std::min(t.sbRows, 64));
    t.minLog2Tiles = std::max(t.minLog2TileCols, tile_log2(t.maxTileAreaSb, t.sbRows * t.sbCols));
    return t;
  }
  // the tile starts of uniform spacing at TileColsLog2 and TileRowsLog2
  void uniform_tile_starts(const TileLimits& t) {
    MiColStarts.clear();
    MiRowStarts.clear();
    int tileWidthSb = (t.sbCols + (1 << TileColsLog2) - 1) >> TileColsLog2;
    for (int startSb = 0; startSb < t.sbCols; startSb += tileWidthSb) MiColStarts.push_back(startSb << t.sbShift);
    TileCols = MiColStarts.size();
    MiColStarts.push_back(MiCols);
    int tileHeightSb = (t.sbRows + (1 << TileRowsLog2) - 1) >> TileRowsLog2;
    for (int startSb = 0; startSb < t.sbRows; startSb += tileHeightSb) MiRowStarts.push_back(startSb << t.sbShift);
    TileRows = MiRowStarts.size();
    MiRowStarts.push_back(MiRows);
  }
  void set_tile(int tileRow, int tileCol) {
    MiRowStart = MiRowStarts[tileRow];
    MiRowEnd = MiRowStarts[tileRow + 1];
    MiColStart = MiColStarts[tileCol];
    MiColEnd = MiColStarts[tileCol + 1];
    CurrentQIndex = base_q_idx;
  }
  // the contexts a tile starts with, and those each superblock row starts with
  void clear_above_context() {
    for (int p = 0; p < seq.NumPlanes; p++) {
      std::fill(AboveLevelContext[p].begin(), AboveLevelContext[p].end(), 0);
      std::fill(AboveDcContext[p].begin(), AboveDcContext[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) DeltaLF[i] = 0;
  }
  void clear_left_context() {
    for (int p = 0; p < seq.NumPlanes; p++) {
      std::fill(LeftLevelContext[p].begin(), LeftLevelContext[p].end(), 0);
      std::fill(LeftDcContext[p].begin(), LeftDcContext[p].end(), 0);
    }
  }

  // ---- the contexts of the block syntax ------------------------------------

  // the partition symbol's context (at r, c for a block of bSize)
  int partition_ctx(int r, int c, int bSize) {
    int bsl = Mi_Width_Log2[bSize];
    int above = is_inside(r - 1, c) && (Mi_Width_Log2[M(r - 1, c).mi_size] < bsl);
    int left = is_inside(r, c - 1) && (Mi_Height_Log2[M(r, c - 1).mi_size] < bsl);
    return left * 2 + above;
  }
  // a partition at the frame's bottom (hasCols) or right edge codes one
  // boolean: the probability, out of 1 << 15, that it splits
  static int partition_split_prob(const uint16_t* pc, int bSize, bool hasCols) {
    auto P = [&](int e) { return (int)pc[e] - (e > 0 ? (int)pc[e - 1] : 0); };
    int psum;
    if (hasCols) {  // the bottom half lies outside: a vertical split in the top half
      psum = P(PARTITION_VERT) + P(PARTITION_SPLIT) + P(PARTITION_HORZ_A) + P(PARTITION_VERT_A) +
             P(PARTITION_VERT_B);
      if (bSize != BLOCK_128X128) psum += P(PARTITION_VERT_4);
    } else {  // the right half lies outside: a horizontal split in the left half
      psum = P(PARTITION_HORZ) + P(PARTITION_SPLIT) + P(PARTITION_HORZ_A) + P(PARTITION_HORZ_B) +
             P(PARTITION_VERT_A);
      if (bSize != BLOCK_128X128) psum += P(PARTITION_HORZ_4);
    }
    return psum;
  }

  // where the block lies and which neighbours it has (decode_block)
  void set_block(int r, int c, int subSize) {
    MiRow = r;
    MiCol = c;
    MiSize = subSize;
    int bw4 = Num_4x4_Blocks_Wide[subSize], bh4 = Num_4x4_Blocks_High[subSize];
    if (bh4 == 1 && seq.subsampling_y && (MiRow & 1) == 0) HasChroma = 0;
    else if (bw4 == 1 && seq.subsampling_x && (MiCol & 1) == 0) HasChroma = 0;
    else HasChroma = seq.NumPlanes > 1;
    AvailU = is_inside(r - 1, c);
    AvailL = is_inside(r, c - 1);
    AvailUChroma = AvailU;
    AvailLChroma = AvailL;
    if (HasChroma) {
      if (seq.subsampling_y && bh4 == 1) AvailUChroma = is_inside(r - 2, c);
      if (seq.subsampling_x && bw4 == 1) AvailLChroma = is_inside(r, c - 2);
    } else {
      AvailUChroma = AvailLChroma = 0;
    }
  }
  int skip_ctx() {
    int ctx = 0;
    if (AvailU) ctx += M(MiRow - 1, MiCol).skip;
    if (AvailL) ctx += M(MiRow, MiCol - 1).skip;
    return ctx;
  }
  int above_mode_ctx() { return Intra_Mode_Context[AvailU ? M(MiRow - 1, MiCol).y_mode : (int)DC_PRED]; }
  int left_mode_ctx() { return Intra_Mode_Context[AvailL ? M(MiRow, MiCol - 1).y_mode : (int)DC_PRED]; }
  bool cfl_allowed() {
    if (Lossless && get_plane_residual_size(MiSize, 1) == BLOCK_4X4) return true;
    return !Lossless && std::max(Block_Width(MiSize), Block_Height(MiSize)) <= 32;
  }
  bool filter_intra_allowed() {
    return seq.enable_filter_intra && YMode == DC_PRED && PaletteSizeY == 0 &&
           std::max(Block_Width(MiSize), Block_Height(MiSize)) <= 32;
  }
  // the tx_depth symbol of read_tx_size: its category (the CDF) and context
  static int tx_depth_cat(int maxRectTxSize) {
    int depth = 0;
    for (int t = maxRectTxSize; t != TX_4X4; t = Split_Tx_Size[t]) depth++;
    return depth - 1;
  }
  int tx_depth_ctx(int maxRectTxSize) {
    int maxTxWidth = Tx_Width(maxRectTxSize), maxTxHeight = Tx_Height(maxRectTxSize);
    int aboveW = 0, leftH = 0;
    if (AvailU && M(MiRow - 1, MiCol).is_inter) aboveW = Block_Width(M(MiRow - 1, MiCol).mi_size);
    else if (AvailU) aboveW = get_above_tx_width(MiRow, MiCol);
    if (AvailL && M(MiRow, MiCol - 1).is_inter) leftH = Block_Height(M(MiRow, MiCol - 1).mi_size);
    else if (AvailL) leftH = get_left_tx_height(MiRow, MiCol);
    return (aboveW >= maxTxWidth) + (leftH >= maxTxHeight);
  }
  // the block's modes into the 4x4 units it covers (decode_block)
  void store_mode_info() {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    for (int y = 0; y < bh4; y++)
      for (int x = 0; x < bw4; x++) {
        if (MiRow + y >= mi_rows_alloc || MiCol + x >= mi_stride) continue;
        ModeInfo& m = M(MiRow + y, MiCol + x);
        m.mi_size = MiSize;
        m.y_mode = YMode;
        m.uv_mode = UVMode;
        m.skip = skip;
        m.segment_id = segment_id;
        m.is_inter = is_inter;
        m.written = 1;
        m.mv[0] = Mv[0];
        m.mv[1] = Mv[1];
        m.palette_size[0] = PaletteSizeY;
        m.palette_size[1] = PaletteSizeUV;
        memcpy(m.palette_colors[0], palette_colors_y, sizeof palette_colors_y);
        memcpy(m.palette_colors[1], palette_colors_u, sizeof palette_colors_u);
        for (int i = 0; i < 4; i++) m.delta_lf[i] = DeltaLF[i];
      }
  }
  // the all_zero symbol's context (coeffs)
  int txb_skip_ctx(int plane, int txSz, int x4, int y4) {
    int w4 = Tx_Width(txSz) >> 2, h4 = Tx_Height(txSz) >> 2;
    int maxX4 = MiCols, maxY4 = MiRows;
    if (plane > 0) {
      maxX4 >>= seq.subsampling_x;
      maxY4 >>= seq.subsampling_y;
    }
    int bsize = get_plane_residual_size(MiSize, plane);
    int w = Tx_Width(txSz), h = Tx_Height(txSz);
    int ctx;
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < maxX4) top = std::max(top, (int)AboveLevelContext[plane][x4 + k]);
      for (int k = 0; k < h4; k++)
        if (y4 + k < maxY4) left = std::max(left, (int)LeftLevelContext[plane][y4 + k]);
      top = std::min(top, 255);
      left = std::min(left, 255);
      if (Block_Width(bsize) == w && Block_Height(bsize) == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < maxX4) above |= AboveLevelContext[plane][x4 + i] | AboveDcContext[plane][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < maxY4) left |= LeftLevelContext[plane][y4 + i] | LeftDcContext[plane][y4 + i];
      ctx = (above != 0) + (left != 0) + 7;
      if (Block_Width(bsize) * Block_Height(bsize) > w * h) ctx += 3;
    }
    return ctx;
  }
  // the dc_sign symbol's context
  int dc_sign_ctx(int plane, int txSz, int x4, int y4) {
    int w4 = Tx_Width(txSz) >> 2, h4 = Tx_Height(txSz) >> 2;
    int maxX4 = MiCols, maxY4 = MiRows;
    if (plane > 0) {
      maxX4 >>= seq.subsampling_x;
      maxY4 >>= seq.subsampling_y;
    }
    int dcSign = 0;
    for (int k = 0; k < w4; k++)
      if (x4 + k < maxX4) {
        int s = AboveDcContext[plane][x4 + k];
        if (s == 1) dcSign--;
        else if (s == 2) dcSign++;
      }
    for (int k = 0; k < h4; k++)
      if (y4 + k < maxY4) {
        int s = LeftDcContext[plane][y4 + k];
        if (s == 1) dcSign--;
        else if (s == 2) dcSign++;
      }
    return dcSign < 0 ? 1 : (dcSign > 0 ? 2 : 0);
  }
  // what a transform block leaves for the contexts of the next (coeffs)
  void set_coeff_ctx(int plane, int txSz, int x4, int y4, int culLevel, int dcCategory) {
    int w4 = Tx_Width(txSz) >> 2, h4 = Tx_Height(txSz) >> 2;
    for (int i = 0; i < w4; i++) {
      AboveLevelContext[plane][x4 + i] = culLevel;
      AboveDcContext[plane][x4 + i] = dcCategory;
    }
    for (int i = 0; i < h4; i++) {
      LeftLevelContext[plane][y4 + i] = culLevel;
      LeftDcContext[plane][y4 + i] = dcCategory;
    }
  }
  void set_tx_types(int x4, int y4, int txSz, int txType) {
    int w4 = Tx_Width(txSz) >> 2, h4 = Tx_Height(txSz) >> 2;
    for (int i = 0; i < w4; i++)
      for (int j = 0; j < h4; j++) TxTypes[(size_t)(y4 + j) * tx_stride + x4 + i] = txType;
  }
  // the intra direction that picks the tx_type CDF (transform_type)
  int intra_tx_dir() { return use_filter_intra ? Filter_Intra_Mode_To_Intra_Dir[filter_intra_mode] : YMode; }
  static int eob_multisize(int txSz) {
    return std::min<int>(Tx_Width_Log2[txSz], 5) + std::min<int>(Tx_Height_Log2[txSz], 5) - 4;
  }
  static int tx_size_ctx(int txSz) { return (Tx_Size_Sqr[txSz] + Tx_Size_Sqr_Up[txSz] + 1) >> 1; }

  // ---- transform blocks ----------------------------------------------------

  bool tx_block_on_screen(int plane, int startX, int startY) {
    int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
    int maxX = (MiCols * 4) - 1, maxY = (MiRows * 4) - 1;
    return startX < (maxX >> subX) + 1 && startY < (maxY >> subY) + 1;
  }
  int get_palette_cache(int plane, uint16_t* cache) {
    int aboveN = 0, leftN = 0;
    if (((MiRow * 4) % 64) && AvailU) aboveN = M(MiRow - 1, MiCol).palette_size[plane];
    if (AvailL) leftN = M(MiRow, MiCol - 1).palette_size[plane];
    int aboveIdx = 0, leftIdx = 0, n = 0;
    const uint16_t* above = aboveN ? M(MiRow - 1, MiCol).palette_colors[plane] : nullptr;
    const uint16_t* left = leftN ? M(MiRow, MiCol - 1).palette_colors[plane] : nullptr;
    while (aboveIdx < aboveN && leftIdx < leftN) {
      int aboveC = above[aboveIdx], leftC = left[leftIdx];
      if (leftC < aboveC) {
        if (n == 0 || leftC != cache[n - 1]) cache[n++] = leftC;
        leftIdx++;
      } else {
        if (n == 0 || aboveC != cache[n - 1]) cache[n++] = aboveC;
        aboveIdx++;
        if (leftC == aboveC) leftIdx++;
      }
    }
    while (aboveIdx < aboveN) {
      int val = above[aboveIdx++];
      if (n == 0 || val != cache[n - 1]) cache[n++] = val;
    }
    while (leftIdx < leftN) {
      int val = left[leftIdx++];
      if (n == 0 || val != cache[n - 1]) cache[n++] = val;
    }
    return n;
  }

  void predict_palette(int plane, int startX, int startY, int x, int y, int txSz) {
    int w = Tx_Width(txSz), h = Tx_Height(txSz);
    const uint16_t* palette = plane == 0 ? palette_colors_y : (plane == 1 ? palette_colors_u : palette_colors_v);
    uint8_t (*map)[64] = plane == 0 ? ColorMapY : ColorMapUV;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) *planes[plane].at(startY + i, startX + j) = palette[map[y * 4 + i][x * 4 + j]];
  }

  // the context of the colour index at (r, c) from its decoded neighbours,
  // and the order of the n colours it ranks them in (get_palette_color_context)
  static int palette_color_context(uint8_t (*map)[64], int r, int c, int n, int* order) {
    int scores[8] = {0};
    for (int k = 0; k < 8; k++) order[k] = k;
    if (c > 0) scores[map[r][c - 1]] += 2;
    if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
    if (r > 0) scores[map[r - 1][c]] += 2;
    for (int k = 0; k < 3; k++) {
      int maxScore = scores[k], maxIdx = k;
      for (int l = k + 1; l < n; l++)
        if (scores[l] > maxScore) {
          maxScore = scores[l];
          maxIdx = l;
        }
      if (maxIdx != k) {
        maxScore = scores[maxIdx];
        int maxOrder = order[maxIdx];
        for (int l = maxIdx; l > k; l--) {
          scores[l] = scores[l - 1];
          order[l] = order[l - 1];
        }
        scores[k] = maxScore;
        order[k] = maxOrder;
      }
    }
    int hash = 0;
    for (int k = 0; k < 3; k++) hash += scores[k] * Palette_Color_Hash_Multipliers[k];
    return Palette_Color_Context[hash];
  }
  // the colour indices off the frame repeat its last column and row
  static void extend_color_map(uint8_t (*map)[64], int blockWidth, int blockHeight, int onscreenWidth,
                               int onscreenHeight) {
    for (int i = 0; i < onscreenHeight; i++)
      for (int j = onscreenWidth; j < blockWidth; j++) map[i][j] = map[i][onscreenWidth - 1];
    for (int i = onscreenHeight; i < blockHeight; i++)
      for (int j = 0; j < blockWidth; j++) map[i][j] = map[onscreenHeight - 1][j];
  }
  // the palette's block sizes: onscreen, then as coded (palette_tokens)
  void color_map_size(int plane, int* blockWidth, int* blockHeight, int* onscreenWidth, int* onscreenHeight) {
    *blockHeight = Block_Height(MiSize);
    *blockWidth = Block_Width(MiSize);
    *onscreenHeight = std::min(*blockHeight, (MiRows - MiRow) * 4);
    *onscreenWidth = std::min(*blockWidth, (MiCols - MiCol) * 4);
    if (plane > 0) {
      *blockHeight >>= seq.subsampling_y;
      *blockWidth >>= seq.subsampling_x;
      *onscreenHeight >>= seq.subsampling_y;
      *onscreenWidth >>= seq.subsampling_x;
      if (*blockWidth < 4) {
        *blockWidth += 2;
        *onscreenWidth += 2;
      }
      if (*blockHeight < 4) {
        *blockHeight += 2;
        *onscreenHeight += 2;
      }
    }
  }

  // the intra prediction of one transform block (transform_block): the
  // block's palette or mode, or DC and CfL for a chroma block that takes it
  // from luma
  void predict_tx_intra(int plane, int startX, int startY, int x, int y, int txSz) {
    if ((plane == 0 && PaletteSizeY) || (plane != 0 && PaletteSizeUV)) {
      predict_palette(plane, startX, startY, x, y, txSz);
      return;
    }
    int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
    int row = (startY << subY) >> 2, col = (startX << subX) >> 2;
    int sbMask = seq.use_128x128_superblock ? 31 : 15;
    int subBlockMiRow = row & sbMask, subBlockMiCol = col & sbMask;
    int stepX = Tx_Width(txSz) >> 2, stepY = Tx_Height(txSz) >> 2;
    bool isCfl = plane > 0 && UVMode == UV_CFL_PRED;
    int mode = plane == 0 ? YMode : (isCfl ? DC_PRED : UVMode);
    int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
    predict_intra(plane, startX, startY, (plane == 0 ? AvailL : AvailLChroma) || x > 0,
                  (plane == 0 ? AvailU : AvailUChroma) || y > 0,
                  BD(plane, (subBlockMiRow >> subY) - 1, (subBlockMiCol >> subX) + stepX),
                  BD(plane, (subBlockMiRow >> subY) + stepY, (subBlockMiCol >> subX) - 1), mode, log2W,
                  log2H);
    if (isCfl) predict_chroma_from_luma(plane, startX, startY, txSz);
  }
  // after a transform block: the luma extent CfL reads, the transform size
  // the loop filter reads, and the flags of what was decoded
  void finish_tx_block(int plane, int startX, int startY, int txSz) {
    int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
    int row = (startY << subY) >> 2, col = (startX << subX) >> 2;
    int sbMask = seq.use_128x128_superblock ? 31 : 15;
    int subBlockMiRow = row & sbMask, subBlockMiCol = col & sbMask;
    int stepX = Tx_Width(txSz) >> 2, stepY = Tx_Height(txSz) >> 2;
    if (plane == 0) {
      MaxLumaW = startX + stepX * 4;
      MaxLumaH = startY + stepY * 4;
    }
    for (int i = 0; i < stepY; i++)
      for (int j = 0; j < stepX; j++) {
        int ly = (row >> subY) + i, lx = (col >> subX) + j;
        LfTxSize[plane][(size_t)ly * lf_stride[plane] + lx] = txSz;
        if ((subBlockMiRow >> subY) + i <= 32 && (subBlockMiCol >> subX) + j <= 32)
          BD(plane, (subBlockMiRow >> subY) + i, (subBlockMiCol >> subX) + j) = 1;
      }
  }

  ModeInfo& M(int r, int c) { return mi[(size_t)r * mi_stride + c]; }
  bool is_inside(int r, int c) const {
    return c >= MiColStart && c < MiColEnd && r >= MiRowStart && r < MiRowEnd;
  }
  uint8_t& BD(int plane, int y, int x) { return BlockDecoded[plane][y + 1][x + 1]; }

  int get_qindex(int ignoreDeltaQ, int segmentId) {
    if (segmentation_enabled && FeatureEnabled[segmentId][SEG_LVL_ALT_Q]) {
      int data = FeatureData[segmentId][SEG_LVL_ALT_Q];
      int qindex = base_q_idx + data;
      if (!ignoreDeltaQ && delta_q_present) qindex = CurrentQIndex + data;
      return Clip3(0, 255, qindex);
    }
    if (!ignoreDeltaQ && delta_q_present) return CurrentQIndex;
    return base_q_idx;
  }
  bool seg_feature_active(int feature) {
    return segmentation_enabled && FeatureEnabled[segment_id][feature];
  }

  void alloc() {
    int sb = seq.use_128x128_superblock ? 128 : 64;
    int W = ((MiCols * 4 + sb - 1) / sb) * sb + 160, H = ((MiRows * 4 + sb - 1) / sb) * sb + 160;
    for (int p = 0; p < seq.NumPlanes; p++) {
      int sx = p ? seq.subsampling_x : 0, sy = p ? seq.subsampling_y : 0;
      planes[p].stride = W >> sx;
      planes[p].rows = H >> sy;
      planes[p].px.assign((size_t)planes[p].stride * planes[p].rows, 0);
      lf_stride[p] = (W >> sx) / 4;
      LfTxSize[p].assign((size_t)lf_stride[p] * ((H >> sy) / 4), 0);
      AboveLevelContext[p].assign(W / 4 + 64, 0);
      AboveDcContext[p].assign(W / 4 + 64, 0);
      LeftLevelContext[p].assign(H / 4 + 64, 0);
      LeftDcContext[p].assign(H / 4 + 64, 0);
    }
    mi_stride = W / 4;
    mi_rows_alloc = H / 4;
    mi.assign((size_t)mi_stride * mi_rows_alloc, ModeInfo{});
    tx_stride = W / 4;
    TxTypes.assign((size_t)tx_stride * (H / 4), 0);
  }

  void clear_block_decoded_flags(int r, int c, int sbSize4) {
    for (int plane = 0; plane < seq.NumPlanes; plane++) {
      int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
      int sbWidth4 = (MiColEnd - c) >> subX;
      int sbHeight4 = (MiRowEnd - r) >> subY;
      for (int y = -1; y <= (sbSize4 >> subY); y++)
        for (int x = -1; x <= (sbSize4 >> subX); x++) {
          uint8_t v;
          if (y < 0 && x < sbWidth4) v = 1;
          else if (x < 0 && y < sbHeight4) v = 1;
          else v = 0;
          BD(plane, y, x) = v;
        }
      BD(plane, sbSize4 >> subY, -1) = 0;
    }
  }

  int get_plane_residual_size(int subsize, int plane) {
    if (plane == 0) return subsize;
    int wl = Mi_Width_Log2[subsize], hl = Mi_Height_Log2[subsize];
    if (seq.subsampling_x) wl = std::max(0, wl - 1);
    if (seq.subsampling_y) hl = std::max(0, hl - 1);
    return BlockOf[wl][hl];
  }

  // the transform width of the 4x4 unit above (row, col), and the height of
  // the one left of it, as the transform size contexts see them
  int get_above_tx_width(int row, int col) {
    if (row == MiRow) {
      if (!AvailU) return 64;
      ModeInfo& a = M(row - 1, col);
      if (a.skip && a.is_inter) return Block_Width(a.mi_size);
    }
    return Tx_Width(M(row - 1, col).tx_size);
  }
  int get_left_tx_height(int row, int col) {
    if (col == MiCol) {
      if (!AvailL) return 64;
      ModeInfo& l = M(row, col - 1);
      if (l.skip && l.is_inter) return Block_Height(l.mi_size);
    }
    return Tx_Height(M(row, col - 1).tx_size);
  }

  void set_inter_tx_size(int row, int col, int h4, int w4, int txSz) {
    for (int i = 0; i < h4; i++)
      for (int j = 0; j < w4; j++)
        if (row + i < mi_rows_alloc && col + j < mi_stride) M(row + i, col + j).tx_size = txSz;
  }

  static int find_tx_size(int w, int h) { return TxOf[FloorLog2(w) - 2][FloorLog2(h) - 2]; }

  void reset_block_context(int bw4, int bh4) {
    for (int plane = 0; plane < 1 + 2 * HasChroma; plane++) {
      int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
      for (int i = MiCol >> subX; i < ((MiCol + bw4) >> subX); i++) {
        AboveLevelContext[plane][i] = 0;
        AboveDcContext[plane][i] = 0;
      }
      for (int i = MiRow >> subY; i < ((MiRow + bh4) >> subY); i++) {
        LeftLevelContext[plane][i] = 0;
        LeftDcContext[plane][i] = 0;
      }
    }
  }

  int get_tx_size(int plane, int txSz) {
    if (plane == 0) return txSz;
    int uvTx = Max_Tx_Size_Rect[get_plane_residual_size(MiSize, plane)];
    if (Tx_Width(uvTx) == 64 || Tx_Height(uvTx) == 64) {
      if (Tx_Width(uvTx) == 16) return TX_16X32;
      if (Tx_Height(uvTx) == 16) return TX_32X16;
      return TX_32X32;
    }
    return uvTx;
  }

  int get_tx_set(int txSz) {
    int txSzSqr = Tx_Size_Sqr[txSz], txSzSqrUp = Tx_Size_Sqr_Up[txSz];
    if (txSzSqrUp > TX_32X32) return TX_SET_DCTONLY;
    if (is_inter) {
      if (reduced_tx_set || txSzSqrUp == TX_32X32) return TX_SET_INTER_3;
      if (txSzSqr == TX_16X16) return TX_SET_INTER_2;
      return TX_SET_INTER_1;
    }
    if (txSzSqrUp == TX_32X32) return TX_SET_DCTONLY;
    if (reduced_tx_set) return TX_SET_INTRA_2;
    if (txSzSqr == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  int compute_tx_type(int plane, int txSz, int blockX, int blockY) {
    int txSzSqrUp = Tx_Size_Sqr_Up[txSz];
    if (Lossless || txSzSqrUp > TX_32X32) return DCT_DCT;
    int txSet = get_tx_set(txSz);
    if (plane == 0) return TxTypes[(size_t)blockY * tx_stride + blockX];
    if (is_inter) {
      int x4 = std::max(MiCol, blockX << seq.subsampling_x);
      int y4 = std::max(MiRow, blockY << seq.subsampling_y);
      int txType = TxTypes[(size_t)y4 * tx_stride + x4];
      return Tx_Type_In_Set_Inter[txSet][txType] ? txType : DCT_DCT;
    }
    int txType = Mode_To_Txfm[UVMode];
    if (!Tx_Type_In_Set_Intra[txSet][txType]) return DCT_DCT;
    return txType;
  }

  const uint16_t* get_scan(int txSz) {
    int wl, hl;
    if (txSz == TX_16X64) {
      wl = 2;
      hl = 3;
    } else if (txSz == TX_64X16) {
      wl = 3;
      hl = 2;
    } else if (Tx_Size_Sqr_Up[txSz] == TX_64X64) {
      wl = hl = 3;
    } else {
      wl = Tx_Width_Log2[txSz] - 2;
      hl = Tx_Height_Log2[txSz] - 2;
    }
    int kind = 0;
    if (PlaneTxType == IDTX) kind = 0;
    else if (PlaneTxType == V_DCT || PlaneTxType == V_ADST || PlaneTxType == V_FLIPADST) kind = 1;
    else if (PlaneTxType == H_DCT || PlaneTxType == H_ADST || PlaneTxType == H_FLIPADST) kind = 2;
    if (Tx_Size_Sqr_Up[txSz] == TX_64X64) kind = 0;
    return Scan[kind][wl][hl].data();
  }

  int get_coeff_base_ctx(int txSz, int pos, int c, bool isEob) {
    int adjTxSz = Adjusted_Tx_Size(txSz);
    int bwl = Tx_Width_Log2[adjTxSz];
    int txh = Tx_Height(adjTxSz);
    if (isEob) {
      if (c == 0) return 42 - 4;
      if (c <= (txh << bwl) / 8) return 42 - 3;
      if (c <= (txh << bwl) / 4) return 42 - 2;
      return 42 - 1;
    }
    int txClass = get_tx_class(PlaneTxType);
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int idx = 0; idx < 5; idx++) {
      int refRow = row + Sig_Ref_Diff_Offset[txClass][idx][0];
      int refCol = col + Sig_Ref_Diff_Offset[txClass][idx][1];
      if (refRow >= 0 && refCol >= 0 && refRow < txh && refCol < (1 << bwl))
        mag += std::min(std::abs(Quant[(refRow << bwl) + refCol]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (txClass == TX_CLASS_2D) {
      if (row == 0 && col == 0) return 0;
      return ctx + Coeff_Base_Ctx_Offset[txSz][std::min(row, 4)][std::min(col, 4)];
    }
    int idx = txClass == TX_CLASS_VERT ? row : col;
    return ctx + Coeff_Base_Pos_Ctx_Offset[std::min(idx, 2)];
  }

  int get_br_ctx(int txSz, int pos) {
    int adjTxSz = Adjusted_Tx_Size(txSz);
    int bwl = Tx_Width_Log2[adjTxSz];
    int txw = Tx_Width(adjTxSz), txh = Tx_Height(adjTxSz);
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    int txClass = get_tx_class(PlaneTxType);
    for (int idx = 0; idx < 3; idx++) {
      int refRow = row + Mag_Ref_Offset_With_Tx_Class[txClass][idx][0];
      int refCol = col + Mag_Ref_Offset_With_Tx_Class[txClass][idx][1];
      if (refRow >= 0 && refCol >= 0 && refRow < txh && refCol < (1 << bwl))
        mag += std::min(Quant[refRow * txw + refCol], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (txClass == TX_CLASS_2D) {
      if (row < 2 && col < 2) return mag + 7;
    } else if (txClass == TX_CLASS_HORIZ) {
      if (col == 0) return mag + 7;
    } else {
      if (row == 0) return mag + 7;
    }
    return mag + 14;
  }

  // ---- reconstruction ----------------------------------------------------

  int Clip1(int x) const { return ClipBd(x, seq.BitDepth); }
  int dc_q(int b) const {
    b = Clip3(0, 255, b);
    return seq.BitDepth == 8 ? Dc_Qlookup[b] : Dc_Qlookup_Hbd[(seq.BitDepth - 10) >> 1][b];
  }
  int ac_q(int b) const {
    b = Clip3(0, 255, b);
    return seq.BitDepth == 8 ? Ac_Qlookup[b] : Ac_Qlookup_Hbd[(seq.BitDepth - 10) >> 1][b];
  }

  void reconstruct(int plane, int x, int y, int txSz) {
    int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
    int pels = 1 << (log2W + log2H);
    int dqDenom = 1 << ((pels > 256) + (pels > 1024));
    int w = 1 << log2W, h = 1 << log2H;
    int tw = std::min(32, w), th = std::min(32, h);
    int t = PlaneTxType;
    bool flipUD = t == FLIPADST_DCT || t == FLIPADST_ADST || t == V_FLIPADST || t == FLIPADST_FLIPADST;
    bool flipLR = t == DCT_FLIPADST || t == ADST_FLIPADST || t == H_FLIPADST || t == FLIPADST_FLIPADST;
    int qindex = get_qindex(0, segment_id);
    int dcQ, acQ;
    if (plane == 0) {
      dcQ = dc_q(qindex + DeltaQYDc);
      acQ = ac_q(qindex);
    } else if (plane == 1) {
      dcQ = dc_q(qindex + DeltaQUDc);
      acQ = ac_q(qindex + DeltaQUAc);
    } else {
      dcQ = dc_q(qindex + DeltaQVDc);
      acQ = ac_q(qindex + DeltaQVAc);
    }
    // the quantizer matrix weighs a 2-D transform's coefficients, stored
    // as w rows of h weights (sl_av1_tables_hbd.h)
    const uint8_t* qm = nullptr;
    int qmLevel = using_qmatrix ? SegQMLevel[plane][segment_id] : 15;
    if (qmLevel < 15 && !Lossless && t < IDTX) {
      qm = Quantizer_Matrix[qmLevel][plane > 0] + Qm_Offset[txSz];
      QmTxSizes |= 1u << txSz;
    }
    int dqMax = 1 << (7 + seq.BitDepth);
    static thread_local int32_t Residual[64][64];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) Residual[i][j] = 0;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        int32_t coef = Quant[i * tw + j];
        if (!coef) continue;
        int q = (i == 0 && j == 0) ? dcQ : acQ;
        if (qm) q = Round2(q * qm[j * th + i], 5);  // AOM_QM_BITS
        int64_t dq = ((int64_t)std::abs(coef) * q) & 0xFFFFFF;
        dq = dq / dqDenom;
        if (coef < 0) dq = -dq;
        Residual[i][j] = (int32_t)std::max<int64_t>(-dqMax, std::min<int64_t>(dqMax - 1, dq));
      }
    // 2D inverse transform (7.13.3)
    if (Lossless) {
      inverse_wht4(Residual);
    } else {
      inverse_transform_2d(Residual, txSz, t, log2W, log2H, seq.BitDepth);
    }
    Plane& P = planes[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int xx = flipLR ? (w - j - 1) : j;
        int yy = flipUD ? (h - i - 1) : i;
        uint16_t* p = P.at(y + yy, x + xx);
        *p = Clip1(*p + Residual[i][j]);
      }
  }

  // the inverse Walsh-Hadamard transform of a lossless 4x4 (7.13.2.10):
  // the rows with shift 2, then the columns with shift 0
  static void wht4(int32_t* T, int shift) {
    int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
    a += c;
    d -= b;
    int32_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    T[0] = a;
    T[1] = b;
    T[2] = c;
    T[3] = d;
  }
  static void inverse_wht4(int32_t (*Residual)[64]) {
    int32_t T[4];
    for (int i = 0; i < 4; i++) {
      for (int j = 0; j < 4; j++) T[j] = Residual[i][j];
      wht4(T, 2);
      for (int j = 0; j < 4; j++) Residual[i][j] = T[j];
    }
    for (int j = 0; j < 4; j++) {
      for (int i = 0; i < 4; i++) T[i] = Residual[i][j];
      wht4(T, 0);
      for (int i = 0; i < 4; i++) Residual[i][j] = T[i];
    }
  }

  static void inverse_transform_2d(int32_t (*Residual)[64], int txSz, int t, int log2W, int log2H,
                                   int bitDepth) {
    int w = 1 << log2W, h = 1 << log2H;
    int rowShift = Transform_Row_Shift[txSz];
    // the row transform's input clamps to BitDepth + 8 bits, its output to
    // Max(BitDepth + 6, 16)
    int rowMax = 1 << (bitDepth + 7), colMax = 1 << (std::max(bitDepth + 6, 16) - 1);
    Txfm tf;
    for (int i = 0; i < std::min(h, 32); i++) {
      bool nz = false;
      for (int j = 0; j < w; j++) {
        tf.T[j] = Residual[i][j];
        nz |= tf.T[j] != 0;
      }
      if (!nz && RowKind[t] != 2) {
        // an all-zero row stays zero through every 1D transform
        continue;
      }
      if (std::abs(log2W - log2H) == 1)
        for (int j = 0; j < w; j++) tf.T[j] = (int32_t)Round2L((int64_t)tf.T[j] * 2896, 12);
      for (int j = 0; j < w; j++) tf.T[j] = Clip3(-rowMax, rowMax - 1, tf.T[j]);
      tf.run(RowKind[t], log2W);
      for (int j = 0; j < w; j++) Residual[i][j] = Round2(tf.T[j], rowShift);
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) Residual[i][j] = Clip3(-colMax, colMax - 1, Residual[i][j]);
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) tf.T[i] = Residual[i][j];
      tf.run(ColKind[t], log2H);
      for (int i = 0; i < h; i++) Residual[i][j] = Round2(tf.T[i], 4);
    }
  }

  bool is_smooth(int row, int col, int plane) {
    int mode = plane == 0 ? M(row, col).y_mode : M(row, col).uv_mode;
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
  }

  int get_filter_type(int plane) {
    int aboveSmooth = 0, leftSmooth = 0;
    if (plane == 0 ? AvailU : AvailUChroma) {
      int r = MiRow - 1, c = MiCol;
      if (plane > 0) {
        if (seq.subsampling_x && !(MiCol & 1)) c++;
        if (seq.subsampling_y && (MiRow & 1)) r--;
      }
      aboveSmooth = is_smooth(r, c, plane);
    }
    if (plane == 0 ? AvailL : AvailLChroma) {
      int r = MiRow, c = MiCol - 1;
      if (plane > 0) {
        if (seq.subsampling_x && (MiCol & 1)) c--;
        if (seq.subsampling_y && !(MiRow & 1)) r++;
      }
      leftSmooth = is_smooth(r, c, plane);
    }
    return aboveSmooth || leftSmooth;
  }

  static int edge_strength(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h, strength = 0;
    if (filterType == 0) {
      if (blkWh <= 8) {
        if (d >= 56) strength = 1;
      } else if (blkWh <= 12) {
        if (d >= 40) strength = 1;
      } else if (blkWh <= 16) {
        if (d >= 40) strength = 1;
      } else if (blkWh <= 24) {
        if (d >= 8) strength = 1;
        if (d >= 16) strength = 2;
        if (d >= 32) strength = 3;
      } else if (blkWh <= 32) {
        if (d >= 1) strength = 1;
        if (d >= 4) strength = 2;
        if (d >= 32) strength = 3;
      } else {
        if (d >= 1) strength = 3;
      }
    } else {
      if (blkWh <= 8) {
        if (d >= 40) strength = 1;
        if (d >= 64) strength = 2;
      } else if (blkWh <= 16) {
        if (d >= 20) strength = 1;
        if (d >= 48) strength = 2;
      } else if (blkWh <= 24) {
        if (d >= 4) strength = 3;
      } else {
        if (d >= 1) strength = 3;
      }
    }
    return strength;
  }

  static bool use_upsample(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h;
    if (d <= 0 || d >= 40) return false;
    return filterType == 0 ? blkWh <= 16 : blkWh <= 8;
  }

  // edge arrays hold indices -16 .. 2 * 128 + 16
  static void edge_filter(int* buf, int sz, int strength) {
    if (strength == 0) return;
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = Clip3(0, sz - 1, i - 2 + j);
        s += Intra_Edge_Kernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }

  static void edge_upsample(int* buf, int numPx, int bitDepth) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
    dup[numPx + 2] = buf[numPx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numPx; i++) {
      int s = -dup[i] + (9 * dup[i + 1]) + (9 * dup[i + 2]) - dup[i + 3];
      s = ClipBd(Round2(s, 4), bitDepth);
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, bool haveLeft, bool haveAbove, bool haveAboveRight,
                     bool haveBelowLeft, int mode, int log2W, int log2H) {
    int w = 1 << log2W, h = 1 << log2H;
    int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
    int maxX = ((MiCols * 4) >> subX) - 1, maxY = ((MiRows * 4) >> subY) - 1;
    Plane& P = planes[plane];
    int aboveBuf[320], leftBuf[320];
    int* AboveRow = aboveBuf + 16;
    int* LeftCol = leftBuf + 16;
    int mid = 1 << (seq.BitDepth - 1);
    if (!haveAbove && haveLeft) {
      int v = *P.at(y, x - 1);
      for (int i = 0; i < w + h; i++) AboveRow[i] = v;
    } else if (!haveAbove && !haveLeft) {
      for (int i = 0; i < w + h; i++) AboveRow[i] = mid - 1;
    } else {
      int aboveLimit = std::min(maxX, x + (haveAboveRight ? 2 * w : w) - 1);
      for (int i = 0; i < w + h; i++) AboveRow[i] = *P.at(y - 1, std::min(aboveLimit, x + i));
    }
    if (!haveLeft && haveAbove) {
      int v = *P.at(y - 1, x);
      for (int i = 0; i < w + h; i++) LeftCol[i] = v;
    } else if (!haveLeft && !haveAbove) {
      for (int i = 0; i < w + h; i++) LeftCol[i] = mid + 1;
    } else {
      int leftLimit = std::min(maxY, y + (haveBelowLeft ? 2 * h : h) - 1);
      for (int i = 0; i < w + h; i++) LeftCol[i] = *P.at(std::min(leftLimit, y + i), x - 1);
    }
    if (haveAbove && haveLeft) AboveRow[-1] = *P.at(y - 1, x - 1);
    else if (haveAbove) AboveRow[-1] = *P.at(y - 1, x);
    else if (haveLeft) AboveRow[-1] = *P.at(y, x - 1);
    else AboveRow[-1] = mid;
    LeftCol[-1] = AboveRow[-1];
    static thread_local int pred[64][64];
    if (plane == 0 && use_filter_intra) {
      int w4 = w >> 2, h2 = h >> 1;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int p[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) p[i] = AboveRow[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) p[i] = LeftCol[(i2 << 1) - 1];
              else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0) p[i] = LeftCol[(i2 << 1) + i - 5];
              else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += Filter_Intra_Taps[filter_intra_mode][i][j] * p[j];
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = Clip1(Round2Signed(pr, 4));
          }
        }
    } else if (is_directional_mode(mode)) {
      int angleDelta = plane == 0 ? AngleDeltaY : AngleDeltaUV;
      int pAngle = Mode_To_Angle[mode] + angleDelta * 3;
      int upsampleAbove = 0, upsampleLeft = 0;
      if (seq.enable_intra_edge_filter) {
        int filterType = get_filter_type(plane);
        if (pAngle != 90 && pAngle != 180) {
          if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
            int s = LeftCol[0] * 5 + AboveRow[-1] * 6 + AboveRow[0] * 5;
            LeftCol[-1] = AboveRow[-1] = Round2(s, 4);
          }
          if (haveAbove) {
            int strength = edge_strength(w, h, filterType, pAngle - 90);
            int numPx = std::min(w, (maxX - x + 1)) + (pAngle < 90 ? h : 0) + 1;
            edge_filter(AboveRow, numPx, strength);
          }
          if (haveLeft) {
            int strength = edge_strength(w, h, filterType, pAngle - 180);
            int numPx = std::min(h, (maxY - y + 1)) + (pAngle > 180 ? w : 0) + 1;
            edge_filter(LeftCol, numPx, strength);
          }
        }
        upsampleAbove = use_upsample(w, h, filterType, pAngle - 90);
        if (upsampleAbove) edge_upsample(AboveRow, w + (pAngle < 90 ? h : 0), seq.BitDepth);
        upsampleLeft = use_upsample(w, h, filterType, pAngle - 180);
        if (upsampleLeft) edge_upsample(LeftCol, h + (pAngle > 180 ? w : 0), seq.BitDepth);
      }
      int dx = 0, dy = 0;
      if (pAngle < 90) dx = Dr_Intra_Derivative[pAngle];
      else if (pAngle > 90 && pAngle < 180) dx = Dr_Intra_Derivative[180 - pAngle];
      if (pAngle > 90 && pAngle < 180) dy = Dr_Intra_Derivative[pAngle - 90];
      else if (pAngle > 180) dy = Dr_Intra_Derivative[270 - pAngle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (pAngle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - upsampleAbove)) + (j << upsampleAbove);
            int shift = ((idx << upsampleAbove) >> 1) & 0x1F;
            int maxBaseX = (w + h - 1) << upsampleAbove;
            if (base < maxBaseX)
              v = Round2(AboveRow[base] * (32 - shift) + AboveRow[base + 1] * shift, 5);
            else
              v = AboveRow[maxBaseX];
          } else if (pAngle > 90 && pAngle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - upsampleAbove);
            if (base >= -(1 << upsampleAbove)) {
              int shift = ((idx * (1 << upsampleAbove)) >> 1) & 0x1F;
              v = Round2(AboveRow[base] * (32 - shift) + AboveRow[base + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - upsampleLeft);
              int shift = ((idx * (1 << upsampleLeft)) >> 1) & 0x1F;
              v = Round2(LeftCol[base] * (32 - shift) + LeftCol[base + 1] * shift, 5);
            }
          } else if (pAngle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - upsampleLeft)) + (i << upsampleLeft);
            int shift = ((idx << upsampleLeft) >> 1) & 0x1F;
            v = Round2(LeftCol[base] * (32 - shift) + LeftCol[base + 1] * shift, 5);
          } else if (pAngle == 90) {
            v = AboveRow[j];
          } else {
            v = LeftCol[i];
          }
          pred[i][j] = v;
        }
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      const uint8_t* wX = sm_weights(log2W);
      const uint8_t* wY = sm_weights(log2H);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (mode == SMOOTH_PRED)
            v = Round2(wY[i] * AboveRow[j] + (256 - wY[i]) * LeftCol[h - 1] + wX[j] * LeftCol[i] +
                           (256 - wX[j]) * AboveRow[w - 1],
                       9);
          else if (mode == SMOOTH_V_PRED)
            v = Round2(wY[i] * AboveRow[j] + (256 - wY[i]) * LeftCol[h - 1], 8);
          else
            v = Round2(wX[j] * LeftCol[i] + (256 - wX[j]) * AboveRow[w - 1], 8);
          pred[i][j] = v;
        }
    } else if (mode == DC_PRED) {
      int avg;
      if (haveLeft && haveAbove) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += LeftCol[k];
        for (int k = 0; k < w; k++) sum += AboveRow[k];
        sum += (w + h) >> 1;
        avg = sum / (w + h);
      } else if (haveLeft) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += LeftCol[k];
        avg = Clip1((sum + (h >> 1)) >> log2H);
      } else if (haveAbove) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += AboveRow[k];
        avg = Clip1((sum + (w >> 1)) >> log2W);
      } else {
        avg = mid;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = AboveRow[j] + LeftCol[i] - AboveRow[-1];
          int pLeft = std::abs(base - LeftCol[i]), pTop = std::abs(base - AboveRow[j]),
              pTopLeft = std::abs(base - AboveRow[-1]);
          if (pLeft <= pTop && pLeft <= pTopLeft) pred[i][j] = LeftCol[i];
          else if (pTop <= pTopLeft) pred[i][j] = AboveRow[j];
          else pred[i][j] = AboveRow[-1];
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) *P.at(y + i, x + j) = (uint16_t)pred[i][j];
  }

  static const uint8_t* sm_weights(int log2) {
    switch (log2) {
      case 2: return Sm_Weights_Tx_4x4;
      case 3: return Sm_Weights_Tx_8x8;
      case 4: return Sm_Weights_Tx_16x16;
      case 5: return Sm_Weights_Tx_32x32;
      default: return Sm_Weights_Tx_64x64;
    }
  }

  void predict_chroma_from_luma(int plane, int startX, int startY, int txSz) {
    int w = Tx_Width(txSz), h = Tx_Height(txSz);
    int subX = seq.subsampling_x, subY = seq.subsampling_y;
    int alpha = plane == 1 ? CflAlphaU : CflAlphaV;
    static thread_local int L[64][64];
    int lumaAvg = 0;
    for (int i = 0; i < h; i++) {
      int lumaY = std::min(i, ((MaxLumaH - (startY << subY)) >> subY) - 1);
      lumaY = (startY + lumaY) << subY;
      for (int j = 0; j < w; j++) {
        int lumaX = std::min(j, ((MaxLumaW - (startX << subX)) >> subX) - 1);
        lumaX = (startX + lumaX) << subX;
        int t = 0;
        for (int dy = 0; dy <= subY; dy++)
          for (int dx = 0; dx <= subX; dx++) t += *planes[0].at(lumaY + dy, lumaX + dx);
        int v = t << (3 - subX - subY);
        L[i][j] = v;
        lumaAvg += v;
      }
    }
    lumaAvg = Round2(lumaAvg, Tx_Width_Log2[txSz] + Tx_Height_Log2[txSz]);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        uint16_t* p = planes[plane].at(startY + i, startX + j);
        int scaledLuma = Round2Signed(alpha * (L[i][j] - lumaAvg), 6);
        *p = Clip1(*p + scaledLuma);
      }
  }

  // ---- the loop filter (7.14) ---------------------------------------------

  int filter_level(int row, int col, int plane, int pass) {
    ModeInfo& m = M(row, col);
    int deltaLF = delta_lf_multi ? m.delta_lf[plane == 0 ? pass : plane + 1] : m.delta_lf[0];
    int i = plane == 0 ? pass : plane + 1;
    int baseFilterLevel = Clip3(0, 63, deltaLF + loop_filter_level[i]);
    int lvlSeg = baseFilterLevel;
    int feature = SEG_LVL_ALT_LF_Y_V + i;
    if (segmentation_enabled && FeatureEnabled[m.segment_id][feature])
      lvlSeg = Clip3(0, 63, lvlSeg + FeatureData[m.segment_id][feature]);
    if (loop_filter_delta_enabled) {
      int nShift = lvlSeg >> 5;
      lvlSeg += loop_filter_ref_deltas[0] << nShift;  // INTRA_FRAME
      lvlSeg = Clip3(0, 63, lvlSeg);
    }
    return lvlSeg;
  }

  void loop_filter() {
    if (!loop_filter_level[0] && !loop_filter_level[1]) return;
    for (int plane = 0; plane < seq.NumPlanes; plane++) {
      if (plane > 0 && !loop_filter_level[1 + plane]) continue;
      for (int pass = 0; pass < 2; pass++) {
        int rowStep = plane == 0 ? 1 : (1 << seq.subsampling_y);
        int colStep = plane == 0 ? 1 : (1 << seq.subsampling_x);
        for (int row = 0; row < MiRows; row += rowStep)
          for (int col = 0; col < MiCols; col += colStep) edge_loop_filter(plane, pass, row, col);
      }
    }
  }

  void edge_loop_filter(int plane, int pass, int row, int col) {
    int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
    int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
    int x = col * 4, y = row * 4;
    row |= subY;
    col |= subX;
    bool onScreen;
    if (x >= FrameWidth) onScreen = false;
    else if (y >= FrameHeight) onScreen = false;
    else if (pass == 0 && x == 0) onScreen = false;
    else if (pass == 1 && y == 0) onScreen = false;
    else onScreen = true;
    if (!onScreen) return;
    int xP = x >> subX, yP = y >> subY;
    int prevRow = row - (dy << subY), prevCol = col - (dx << subX);
    int txSz = LfTxSize[plane][(size_t)(row >> subY) * lf_stride[plane] + (col >> subX)];
    int prevTxSz = LfTxSize[plane][(size_t)(prevRow >> subY) * lf_stride[plane] + (prevCol >> subX)];
    // every transform edge is filtered: a block that skips its residual
    // keeps its inner edges only where it copies from elsewhere (inter),
    // and intra block copy turns the loop filter off
    bool isTxEdge = (pass == 0 && xP % Tx_Width(txSz) == 0) || (pass == 1 && yP % Tx_Height(txSz) == 0);
    int baseSize = pass == 0 ? std::min(Tx_Width(prevTxSz), Tx_Width(txSz))
                             : std::min(Tx_Height(prevTxSz), Tx_Height(txSz));
    int filterSize = plane == 0 ? std::min(16, baseSize) : std::min(8, baseSize);
    int lvl = filter_level(row, col, plane, pass);
    if (lvl == 0) lvl = filter_level(prevRow, prevCol, plane, pass);
    int shift = loop_filter_sharpness > 4 ? 2 : (loop_filter_sharpness > 0 ? 1 : 0);
    int limit = loop_filter_sharpness > 0 ? Clip3(1, 9 - loop_filter_sharpness, lvl >> shift)
                                          : std::max(1, lvl >> shift);
    int blimit = 2 * (lvl + 2) + limit;
    int thresh = lvl >> 4;
    if (!isTxEdge || lvl == 0) return;
    // samples of more than 8 bits: the thresholds scale with them
    int shiftBd = seq.BitDepth - 8;
    for (int i = 0; i < 4; i++)
      sample_filter(xP + dy * i, yP + dx * i, plane, limit << shiftBd, blimit << shiftBd, thresh << shiftBd, dx,
                    dy, filterSize);
  }

  void sample_filter(int x, int y, int plane, int limit, int blimit, int thresh, int dx, int dy,
                     int filterSize) {
    Plane& P = planes[plane];
    auto S = [&](int k) -> uint16_t& {  // k >= 0: q_k, k < 0: p_{-k-1}
      return *P.at(y + dy * k, x + dx * k);
    };
    int q0 = S(0), q1 = S(1), q2 = S(2), q3 = S(3);
    int p0 = S(-1), p1 = S(-2), p2 = S(-3), p3 = S(-4);
    bool hevMask = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int mask = 0;
    mask |= std::abs(p1 - p0) > limit;
    mask |= std::abs(q1 - q0) > limit;
    mask |= std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    int len = filterSize == 4 ? 4 : (plane > 0 ? 6 : (filterSize == 8 ? 8 : 16));
    if (len >= 6) {
      mask |= std::abs(p2 - p1) > limit;
      mask |= std::abs(q2 - q1) > limit;
    }
    if (len >= 8) {
      mask |= std::abs(p3 - p2) > limit;
      mask |= std::abs(q3 - q2) > limit;
    }
    if (mask) return;
    bool flat = false, flat2 = false;
    int one = 1 << (seq.BitDepth - 8);  // flatness: within 1 << (BitDepth - 8)
    if (len == 6) {
      flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one && std::abs(p2 - p0) <= one &&
             std::abs(q2 - q0) <= one;
    } else if (len >= 8) {
      flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one && std::abs(p2 - p0) <= one &&
             std::abs(q2 - q0) <= one && std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
    }
    if (len == 16) {
      int q4 = S(4), q5 = S(5), q6 = S(6), p4 = S(-5), p5 = S(-6), p6 = S(-7);
      flat2 = std::abs(p6 - p0) <= one && std::abs(q6 - q0) <= one && std::abs(p5 - p0) <= one &&
              std::abs(q5 - q0) <= one && std::abs(p4 - p0) <= one && std::abs(q4 - q0) <= one;
    }
    if (len == 4 || !flat) {
      narrow_filter(S, hevMask, seq.BitDepth);
    } else if (len == 8 || len == 6 || !flat2) {
      wide_filter(S, 3, plane);
    } else {
      wide_filter(S, 4, plane);
    }
  }

  template <typename F>
  static void narrow_filter(F& S, bool hevMask, int bitDepth) {
    int half = 1 << (bitDepth - 1);  // 0x80 << (BitDepth - 8)
    auto c4 = [half](int v) { return Clip3(-half, half - 1, v); };
    int ps1 = S(-2) - half, ps0 = S(-1) - half, qs0 = S(0) - half, qs1 = S(1) - half;
    int filter = hevMask ? c4(ps1 - qs1) : 0;
    filter = c4(filter + 3 * (qs0 - ps0));
    int filter1 = c4(filter + 4) >> 3;
    int filter2 = c4(filter + 3) >> 3;
    S(0) = c4(qs0 - filter1) + half;
    S(-1) = c4(ps0 + filter2) + half;
    if (!hevMask) {
      filter = Round2(filter1, 1);
      S(1) = c4(qs1 - filter) + half;
      S(-2) = c4(ps1 + filter) + half;
    }
  }

  template <typename F>
  static void wide_filter(F& S, int log2Size, int plane) {
    int n;
    if (log2Size == 4) n = 6;
    else if (plane == 0) n = 3;
    else n = 2;
    int n2 = (log2Size == 3 && plane == 0) ? 0 : 1;
    int v[16], F_[16];
    for (int k = -(n + 1); k <= n; k++) v[k + 8] = S(k);
    for (int i = -n; i < n; i++) {
      int t = 0;
      for (int j = -n; j <= n; j++) {
        int p = Clip3(-(n + 1), n, i + j);
        int tap = (std::abs(j) <= n2) ? 2 : 1;
        t += v[p + 8] * tap;
      }
      F_[i + 8] = Round2(t, log2Size);
    }
    for (int i = -n; i < n; i++) S(i) = F_[i + 8];
  }
};

}  // namespace sl_av1
