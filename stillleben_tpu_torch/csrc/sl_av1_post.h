// The port's AV1 decoder's filters after the deblocking filter: the
// constrained directional enhancement filter (CDEF, 7.15) and loop
// restoration (7.17: the Wiener filter and the self-guided filter), with
// the frame header's parameters for both (5.9.19, 5.9.20), what the tiles
// read per 64x64 and per restoration unit, and the counts of what a decode
// ran (sl_av1_decode_counts); and the film grain synthesis (7.18.3) of the
// output. Only the decoder includes it: the encoder writes none of these.
//
// The names of variables and functions are the specification's (AV1
// Bitstream & Decoding Process Specification) where it has one.

#pragma once

#include "sl_av1_recon.h"

namespace sl_av1 {

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
const int Remap_Lr_Type[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
const int Wiener_Taps_Min[3] = {-5, -23, -17};
const int Wiener_Taps_Max[3] = {10, 8, 46};
const int Wiener_Taps_K[3] = {1, 2, 3};
const int Wiener_Taps_Mid[3] = {3, -7, 15};
const int Sgrproj_Xqd_Min[2] = {-96, -32};
const int Sgrproj_Xqd_Max[2] = {31, 95};
const int Sgrproj_Xqd_Mid[2] = {-32, 31};
// {r0, s0, r1, s1}: the radius and the scale of each pass
const int Sgr_Params[16][4] = {
    {2, 140, 1, 3236}, {2, 112, 1, 2158}, {2, 93, 1, 1618}, {2, 80, 1, 1438}, {2, 70, 1, 1295},
    {2, 58, 1, 1177},  {2, 47, 1, 1079},  {2, 37, 1, 996},  {2, 30, 1, 925},  {2, 25, 1, 863},
    {0, -1, 1, 2589},  {0, -1, 1, 1618},  {0, -1, 1, 1177}, {0, -1, 1, 925},  {2, 56, 0, -1},
    {2, 22, 0, -1}};
const uint16_t Default_Use_Wiener_Cdf[3] = {11570, 32768, 0};
const uint16_t Default_Use_Sgrproj_Cdf[3] = {16855, 32768, 0};
const uint16_t Default_Restoration_Type_Cdf[4] = {9413, 22581, 32768, 0};

const int Cdef_Uv_Dir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                                  {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
const int Cdef_Directions[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
                                      {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
                                      {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
const int Cdef_Pri_Taps[2][2] = {{4, 2}, {3, 3}};
const int Cdef_Sec_Taps[2][2] = {{2, 1}, {2, 1}};
const int Div_Table[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

// the counts of sl_av1_decode_counts, in order: (enum name, Python name)
#define SL_AV1_COUNTS(X)                                                                          \
  X(LR_TYPE, lr_type_y)             /* + plane: FrameRestorationType (0-3) */                   \
  X(LR_TYPE_U, lr_type_u)                                                                         \
  X(LR_TYPE_V, lr_type_v)                                                                         \
  X(LR_UNIT_SHIFT, lr_unit_shift)   /* lr_unit_shift, or -1 without loop restoration */          \
  X(LR_WIENER, wiener_y)            /* + plane: Wiener units */                                   \
  X(LR_WIENER_U, wiener_u)                                                                        \
  X(LR_WIENER_V, wiener_v)                                                                        \
  X(LR_SGRPROJ, sgrproj_y)          /* + plane: self-guided units */                              \
  X(LR_SGRPROJ_U, sgrproj_u)                                                                      \
  X(LR_SGRPROJ_V, sgrproj_v)                                                                      \
  X(LR_SGR_SETS, sgr_sets)          /* a bit for each Sgr_Params set a unit used */              \
  X(CDEF_Y_PRI, cdef_y_pri)         /* luma 8x8s filtered with a nonzero primary strength */     \
  X(CDEF_Y_SEC, cdef_y_sec)         /* ... and a nonzero secondary strength */                    \
  X(CDEF_UV_PRI, cdef_uv_pri)       /* chroma 8x8s (both planes count once) */                    \
  X(CDEF_UV_SEC, cdef_uv_sec)                                                                     \
  X(CDEF_SKIP_64X64, cdef_skip_64x64) /* 64x64s with no cdef_idx (every block skips) */          \
  X(CFL, cfl)                       /* blocks predicting chroma from luma */                      \
  X(LOSSLESS, lossless)             /* lossless blocks */                                         \
  X(PALETTE_UV, palette_uv)         /* blocks with a chroma palette */                            \
  X(UV_TX_SIZES, uv_tx_sizes)       /* a bit for each chroma transform size */                    \
  X(SUBSAMPLING, subsampling)       /* subsampling_x * 2 + subsampling_y */                       \
  X(CDEF_BITS, cdef_bits)           /* cdef_bits, or -1 where the frame has no CDEF */         \
  X(QM_TX_SIZES, qm_tx_sizes)       /* a bit for each transform size a quantizer matrix weighed */

#define SL_AV1_COUNT_ENUM(e, name) CNT_##e,
#define SL_AV1_COUNT_NAME(e, name) #name ","
enum { SL_AV1_COUNTS(SL_AV1_COUNT_ENUM) CNT_COUNT };
// the Python names, each followed by a comma (sl_av1_count_names)
const char Count_Names[] = SL_AV1_COUNTS(SL_AV1_COUNT_NAME);

struct LrUnit {
  uint8_t type = RESTORE_NONE, set = 0;
  int8_t wiener[2][3] = {{0}};  // [pass 0: vertical, 1: horizontal][tap]
  int8_t xqd[2] = {0};
};

struct Post {
  int BitDepth = 8;
  // cdef_params
  int cdef_bits = 0, CdefDamping = 3;
  int cdef_y_pri_strength[8] = {0}, cdef_y_sec_strength[8] = {0};
  int cdef_uv_pri_strength[8] = {0}, cdef_uv_sec_strength[8] = {0};
  std::vector<int8_t> cdef_idx;  // per 64x64
  int cdef_stride = 0;
  bool cdef_on = false;
  // lr_params
  int FrameRestorationType[3] = {0}, LoopRestorationSize[3] = {0}, UsesLr = 0;
  int lr_unit_shift = -1, lr_uv_shift = 0;
  int unitRows[3] = {0}, unitCols[3] = {0};
  std::vector<LrUnit> LrUnits[3];
  int RefLrWiener[3][2][3], RefSgrXqd[3][2];
  int32_t counts[CNT_COUNT] = {0};

  static int count_units_in_frame(int unitSize, int frameSize) {
    return std::max((frameSize + (unitSize >> 1)) / unitSize, 1);
  }

  // after the frame header: the grid of cdef_idx and of restoration units
  void alloc_post(const Recon& f) {
    BitDepth = f.seq.BitDepth;
    cdef_stride = (f.MiCols + 15) >> 4;
    cdef_idx.assign((size_t)cdef_stride * ((f.MiRows + 15) >> 4) + 2 * cdef_stride + 2, -1);
    for (int p = 0; p < f.seq.NumPlanes; p++) {
      if (FrameRestorationType[p] == RESTORE_NONE) continue;
      int subX = p ? f.seq.subsampling_x : 0, subY = p ? f.seq.subsampling_y : 0;
      unitRows[p] = count_units_in_frame(LoopRestorationSize[p], Round2(f.FrameHeight, subY));
      unitCols[p] = count_units_in_frame(LoopRestorationSize[p], Round2(f.FrameWidth, subX));
      LrUnits[p].assign((size_t)unitRows[p] * unitCols[p], LrUnit{});
    }
    for (int p = 0; p < 3; p++) counts[CNT_LR_TYPE + p] = FrameRestorationType[p];
    counts[CNT_LR_UNIT_SHIFT] = UsesLr ? lr_unit_shift : -1;
    counts[CNT_SUBSAMPLING] = f.seq.subsampling_x * 2 + f.seq.subsampling_y;
    counts[CNT_CDEF_BITS] = cdef_on ? cdef_bits : -1;
  }
  int8_t& cdef_at(int r, int c) { return cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)]; }

  // the references a tile's restoration coefficients start from
  void reset_lr_refs() {
    for (int p = 0; p < 3; p++)
      for (int pass = 0; pass < 2; pass++) {
        RefSgrXqd[p][pass] = Sgrproj_Xqd_Mid[pass];
        for (int i = 0; i < 3; i++) RefLrWiener[p][pass][i] = Wiener_Taps_Mid[i];
      }
  }

  // ---- CDEF (7.15) ---------------------------------------------------------

  static int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int dampingAdj = std::max(0, damping - FloorLog2(threshold));
    int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> dampingAdj)));
    return diff < 0 ? -val : val;
  }

  // the direction of the 8x8 luma block at (x0, y0) and its variance
  static int cdef_direction(const Plane& P, int x0, int y0, int bitDepth, int* var) {
    int64_t cost[8] = {0};
    int partial[8][15] = {{0}};
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int x = (P.px[(size_t)(y0 + i) * P.stride + x0 + j] >> (bitDepth - 8)) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    for (int i = 0; i < 8; i++) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= Div_Table[8];
    cost[6] *= Div_Table[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (int64_t)(partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) *
                 Div_Table[i + 1];
      cost[4] += (int64_t)(partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) *
                 Div_Table[i + 1];
    }
    cost[0] += (int64_t)partial[0][7] * partial[0][7] * Div_Table[8];
    cost[4] += (int64_t)partial[4][7] * partial[4][7] * Div_Table[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= Div_Table[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (int64_t)(partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) *
                   Div_Table[2 * j + 2];
    }
    int64_t bestCost = 0;
    int yDir = 0;
    for (int i = 0; i < 8; i++)
      if (cost[i] > bestCost) {
        bestCost = cost[i];
        yDir = i;
      }
    *var = (int)((bestCost - cost[(yDir + 4) & 7]) >> 10);
    return yDir;
  }

  // one plane's block of the 8x8 at mode info (r, c): from ``src`` (the
  // deblocked frame) into ``dst``
  static void cdef_filter(const Recon& f, const Plane& src, Plane& dst, int plane, int r, int c, int priStr,
                          int secStr, int damping, int dir) {
    int subX = plane ? f.seq.subsampling_x : 0, subY = plane ? f.seq.subsampling_y : 0;
    int x0 = (c * 4) >> subX, y0 = (r * 4) >> subY;
    int w = 8 >> subX, h = 8 >> subY;
    const int priTap = (priStr >> (f.seq.BitDepth - 8)) & 1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int x = src.px[(size_t)(y0 + i) * src.stride + x0 + j];
        int sum = 0, mx = x, mn = x;
        auto get = [&](int di, int dj, int* v) {
          int y = y0 + di, xx = x0 + dj;
          if (y < 0 || xx < 0) return false;
          int candR = (y << subY) >> 2, candC = (xx << subX) >> 2;
          if (candR >= f.MiRows || candC >= f.MiCols) return false;
          *v = src.px[(size_t)y * src.stride + xx];
          return true;
        };
        for (int k = 0; k < 2; k++)
          for (int sign = -1; sign <= 1; sign += 2) {
            int p;
            if (get(i + sign * Cdef_Directions[dir][k][0], j + sign * Cdef_Directions[dir][k][1], &p)) {
              sum += Cdef_Pri_Taps[priTap][k] * constrain(p - x, priStr, damping);
              mx = std::max(p, mx);
              mn = std::min(p, mn);
            }
            for (int dirOff = -2; dirOff <= 2; dirOff += 4) {
              int d2 = (dir + dirOff) & 7, s;
              if (get(i + sign * Cdef_Directions[d2][k][0], j + sign * Cdef_Directions[d2][k][1], &s)) {
                sum += Cdef_Sec_Taps[priTap][k] * constrain(s - x, secStr, damping);
                mx = std::max(s, mx);
                mn = std::min(s, mn);
              }
            }
          }
        dst.px[(size_t)(y0 + i) * dst.stride + x0 + j] =
            (uint16_t)Clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
      }
  }

  // the CDEF process: reads ``deblocked``, writes the frame's planes
  void cdef_frame(Recon& f, const Plane* deblocked) {
    int NumPlanes = f.seq.NumPlanes;
    for (int r = 0; r < f.MiRows; r += 2)
      for (int c = 0; c < f.MiCols; c += 2) {
        int idx = cdef_at(r, c);
        if (idx == -1) {
          if (!(r & 15) && !(c & 15)) counts[CNT_CDEF_SKIP_64X64]++;
          continue;
        }
        if (f.M(r, c).skip && f.M(r + 1, c).skip && f.M(r, c + 1).skip && f.M(r + 1, c + 1).skip)
          continue;
        // samples of more than 8 bits scale the strengths and the damping
        int coeffShift = BitDepth - 8;
        int var = 0;
        int yDir = cdef_direction(deblocked[0], c * 4, r * 4, BitDepth, &var);
        int priStr = cdef_y_pri_strength[idx] << coeffShift, secStr = cdef_y_sec_strength[idx] << coeffShift;
        int dir = priStr == 0 ? 0 : yDir;
        int varStr = (var >> 6) ? std::min(FloorLog2(var >> 6), 12) : 0;
        priStr = var ? (priStr * (4 + varStr) + 8) >> 4 : 0;
        counts[CNT_CDEF_Y_PRI] += priStr > 0;
        counts[CNT_CDEF_Y_SEC] += secStr > 0;
        cdef_filter(f, deblocked[0], f.planes[0], 0, r, c, priStr, secStr, CdefDamping + coeffShift, dir);
        if (NumPlanes == 1) continue;
        priStr = cdef_uv_pri_strength[idx] << coeffShift;
        secStr = cdef_uv_sec_strength[idx] << coeffShift;
        dir = priStr == 0 ? 0 : Cdef_Uv_Dir[f.seq.subsampling_x][f.seq.subsampling_y][yDir];
        counts[CNT_CDEF_UV_PRI] += priStr > 0;
        counts[CNT_CDEF_UV_SEC] += secStr > 0;
        for (int p = 1; p < 3; p++)
          cdef_filter(f, deblocked[p], f.planes[p], p, r, c, priStr, secStr, CdefDamping - 1 + coeffShift, dir);
      }
  }

  // ---- loop restoration (7.17) -----------------------------------------------

  // The restoration of one plane. The specification filters each 4x4 block
  // (2x2 in a subsampled chroma plane) with the parameters of its unit and
  // the bounds of its 64-row stripe; every such block lies wholly inside one
  // unit and one stripe, so the same output comes from filtering each
  // rectangle where a stripe meets a unit at once. Inside the stripe the
  // source is the CDEF output (``cdef``); up to two rows above and below it
  // come from the deblocked frame (``deblocked``); the frame's edges repeat.
  void lr_plane(Recon& f, int plane, const Plane& deblocked, const Plane& cdef) {
    int subX = plane ? f.seq.subsampling_x : 0, subY = plane ? f.seq.subsampling_y : 0;
    int unitSize = LoopRestorationSize[plane];
    int PlaneEndX = Round2(f.FrameWidth, subX) - 1, PlaneEndY = Round2(f.FrameHeight, subY) - 1;
    int stripeH = 64 >> subY, stripeOff = 8 >> subY;
    Plane& out = f.planes[plane];
    // rows: split at every stripe and unit boundary
    for (int y0 = 0; y0 <= PlaneEndY;) {
      int stripeNum = (y0 + stripeOff) / stripeH;
      int StripeStartY = stripeNum * stripeH - stripeOff, StripeEndY = StripeStartY + stripeH - 1;
      int unitRow = std::min(unitRows[plane] - 1, (y0 + stripeOff) / unitSize);
      int y1 = std::min(PlaneEndY + 1, StripeEndY + 1);
      if (unitRow < unitRows[plane] - 1) y1 = std::min(y1, (unitRow + 1) * unitSize - stripeOff);
      for (int x0 = 0; x0 <= PlaneEndX;) {
        int unitCol = std::min(unitCols[plane] - 1, x0 / unitSize);
        int x1 = unitCol < unitCols[plane] - 1 ? (unitCol + 1) * unitSize : PlaneEndX + 1;
        const LrUnit& u = LrUnits[plane][(size_t)unitRow * unitCols[plane] + unitCol];
        if (u.type != RESTORE_NONE) {
          auto src = [&](int x, int y) -> int {
            x = std::max(0, std::min(PlaneEndX, x));
            y = std::max(0, std::min(PlaneEndY, y));
            if (y < StripeStartY) return deblocked.px[(size_t)std::max(StripeStartY - 2, y) * deblocked.stride + x];
            if (y > StripeEndY) return deblocked.px[(size_t)std::min(StripeEndY + 2, y) * deblocked.stride + x];
            return cdef.px[(size_t)y * cdef.stride + x];
          };
          if (u.type == RESTORE_WIENER) wiener(u, src, out, x0, y0, x1 - x0, y1 - y0, plane);
          else self_guided(u, src, cdef, out, x0, y0, x1 - x0, y1 - y0, plane);
        }
        x0 = x1;
      }
      y0 = y1;
    }
  }

  template <typename Src>
  void wiener(const LrUnit& u, Src& src, Plane& out, int x, int y, int w, int h, int plane) {
    counts[CNT_LR_WIENER + plane]++;
    int vfilter[7], hfilter[7];
    for (int pass = 0; pass < 2; pass++) {
      int* filter = pass ? hfilter : vfilter;
      filter[3] = 128;
      for (int i = 0; i < 3; i++) {
        int c = u.wiener[pass][i];
        filter[i] = filter[6 - i] = c;
        filter[3] -= 2 * c;
      }
    }
    // InterRound0 = 3 and InterRound1 = 11 (5 and 9 at 12 bits); the
    // intermediate lies in [-offset, limit - offset]
    const int round0 = BitDepth == 12 ? 5 : 3, round1 = 14 - round0;
    const int offset = 1 << (BitDepth + 7 - round0 - 1), limit = (1 << (BitDepth + 1 + 7 - round0)) - 1;
    std::vector<int> inter((size_t)(h + 6) * w);
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += hfilter[t] * src(x + c + t - 3, y + r - 3);
        inter[(size_t)r * w + c] = Clip3(-offset, limit - offset, Round2(s, round0));
      }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += vfilter[t] * inter[(size_t)(r + t) * w + c];
        out.px[(size_t)(y + r) * out.stride + x + c] = (uint16_t)ClipBd(Round2(s, round1), BitDepth);
      }
  }

  // one pass of the self-guided filter (box_filter) over the rectangle:
  // F (w x h), in the precision SGRPROJ_RST_BITS adds
  template <typename Src>
  static void box_filter(Src& src, const Plane& cdef, int x, int y, int w, int h, int set, int pass,
                         int bitDepth, std::vector<int>& F) {
    int r = Sgr_Params[set][pass * 2], s = Sgr_Params[set][pass * 2 + 1];
    int n = (2 * r + 1) * (2 * r + 1);
    int oneOverN = ((1 << 12) + (n / 2)) / n;
    // the source over the rectangle and a margin of r + 1
    int m = r + 1, sw = w + 2 * m, sh = h + 2 * m;
    std::vector<int> S((size_t)sw * sh);
    for (int i = 0; i < sh; i++)
      for (int j = 0; j < sw; j++) S[(size_t)i * sw + j] = src(x + j - m, y + i - m);
    int aw = w + 2, ah = h + 2;  // A and B at -1 .. w, -1 .. h
    std::vector<int> A((size_t)aw * ah), B((size_t)aw * ah);
    for (int i = -1; i < h + 1; i++) {
      if (pass == 0 && !(i & 1)) continue;  // pass 0 weighs only the odd rows
      for (int j = -1; j < w + 1; j++) {
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            int c = S[(size_t)(i + dy + m) * sw + j + dx + m];
            a += c * c;
            b += c;
          }
        // samples of more than 8 bits: a and b scaled back to 8 bits
        a = Round2(a, 2 * (bitDepth - 8));
        int d = Round2(b, bitDepth - 8);
        int64_t p = std::max<int64_t>(0, (int64_t)a * n - (int64_t)d * d);
        int z = (int)Round2L(p * s, 20);
        int a2;
        if (z >= 255) a2 = 256;
        else if (z == 0) a2 = 1;
        else a2 = ((z << 8) + (z / 2)) / (z + 1);
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * oneOverN;
        A[(size_t)(i + 1) * aw + j + 1] = a2;
        B[(size_t)(i + 1) * aw + j + 1] = (int)Round2L(b2, 12);
      }
    }
    F.assign((size_t)w * h, 0);
    for (int i = 0; i < h; i++) {
      int shift = (pass == 0 && (i & 1)) ? 4 : 5;
      for (int j = 0; j < w; j++) {
        int a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int weight;
            if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else weight = (dx == 0 || dy == 0) ? 4 : 3;
            if (!weight) continue;
            a += weight * A[(size_t)(i + dy + 1) * aw + j + dx + 1];
            b += weight * B[(size_t)(i + dy + 1) * aw + j + dx + 1];
          }
        int v = a * cdef.px[(size_t)(y + i) * cdef.stride + x + j] + b;
        F[(size_t)i * w + j] = Round2(v, 8 + shift - 4);
      }
    }
  }

  template <typename Src>
  void self_guided(const LrUnit& u, Src& src, const Plane& cdef, Plane& out, int x, int y, int w, int h,
                   int plane) {
    counts[CNT_LR_SGRPROJ + plane]++;
    counts[CNT_LR_SGR_SETS] |= 1 << u.set;
    int set = u.set;
    int r0 = Sgr_Params[set][0], r1 = Sgr_Params[set][2];
    std::vector<int> flt0, flt1;
    if (r0) box_filter(src, cdef, x, y, w, h, set, 0, BitDepth, flt0);
    if (r1) box_filter(src, cdef, x, y, w, h, set, 1, BitDepth, flt1);
    int w0 = u.xqd[0], w1 = u.xqd[1], w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int uu = cdef.px[(size_t)(y + i) * cdef.stride + x + j] << 4;
        int v = w1 * uu;
        v += w0 * (r0 ? flt0[(size_t)i * w + j] : uu);
        v += w2 * (r1 ? flt1[(size_t)i * w + j] : uu);
        out.px[(size_t)(y + i) * out.stride + x + j] = (uint16_t)ClipBd(Round2(v, 4 + 7), BitDepth);
      }
  }

  // after the deblocking filter: CDEF, then loop restoration where a plane
  // restores
  void post_filters(Recon& f) {
    if (!cdef_on && !UsesLr) return;
    int NumPlanes = f.seq.NumPlanes;
    Plane deblocked[3];
    for (int p = 0; p < NumPlanes; p++) deblocked[p] = f.planes[p];
    if (cdef_on) cdef_frame(f, deblocked);
    if (!UsesLr) return;
    for (int p = 0; p < NumPlanes; p++) {
      if (FrameRestorationType[p] == RESTORE_NONE) continue;
      Plane cdef = f.planes[p];
      lr_plane(f, p, deblocked[p], cdef);
    }
  }
};

// ---- film grain (5.9.30, 7.18.3) -----------------------------------------------

struct FilmGrainParams {
  int apply_grain = 0, grain_seed = 0;
  int num_y_points = 0, point_y_value[16] = {0}, point_y_scaling[16] = {0};
  int chroma_scaling_from_luma = 0;
  int num_cb_points = 0, point_cb_value[16] = {0}, point_cb_scaling[16] = {0};
  int num_cr_points = 0, point_cr_value[16] = {0}, point_cr_scaling[16] = {0};
  int grain_scaling_minus_8 = 0, ar_coeff_lag = 0;
  int ar_coeffs_y_plus_128[24] = {0}, ar_coeffs_cb_plus_128[25] = {0}, ar_coeffs_cr_plus_128[25] = {0};
  int ar_coeff_shift_minus_6 = 0, grain_scale_shift = 0;
  int cb_mult = 0, cb_luma_mult = 0, cb_offset = 0, cr_mult = 0, cr_luma_mult = 0, cr_offset = 0;
  int overlap_flag = 0, clip_to_restricted_range = 0;
};

// The film grain synthesis process (7.18.3) on the output planes ``out``
// (copies of the decoded frame: the grain never reaches a reference).
struct FilmGrain {
  const FilmGrainParams& g;
  int BitDepth, subX, subY, NumPlanes, matrix;
  int RandomRegister = 0, GrainCenter = 0, GrainMin = 0, GrainMax = 0;
  int LumaGrain[73][82], CbGrain[73][82], CrGrain[73][82];
  int ScalingLut[3][256];

  FilmGrain(const FilmGrainParams& params, const SequenceHeader& s)
      : g(params), BitDepth(s.BitDepth), subX(s.subsampling_x), subY(s.subsampling_y), NumPlanes(s.NumPlanes),
        matrix(s.matrix_coefficients) {}

  int get_random_number(int bits) {
    int r = RandomRegister;
    int bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    r = (r >> 1) | (bit << 15);
    RandomRegister = r;
    return (r >> (16 - bits)) & ((1 << bits) - 1);
  }

  // 7.18.3.3
  void generate_grain() {
    int shift = 12 - BitDepth + g.grain_scale_shift;
    for (int y = 0; y < 73; y++)
      for (int x = 0; x < 82; x++) {
        int v = g.num_y_points > 0 ? Gaussian_Sequence[get_random_number(11)] : 0;
        LumaGrain[y][x] = Round2(v, shift);
      }
    int arShift = g.ar_coeff_shift_minus_6 + 6, lag = g.ar_coeff_lag;
    if (g.num_y_points > 0)
      for (int y = 3; y < 73; y++)
        for (int x = 3; x < 82 - 3; x++) {
          int sum = 0, pos = 0;
          for (int deltaRow = -lag; deltaRow <= 0; deltaRow++)
            for (int deltaCol = -lag; deltaCol <= lag; deltaCol++) {
              if (deltaRow == 0 && deltaCol == 0) break;
              sum += LumaGrain[y + deltaRow][x + deltaCol] * (g.ar_coeffs_y_plus_128[pos] - 128);
              pos++;
            }
          LumaGrain[y][x] = Clip3(GrainMin, GrainMax, LumaGrain[y][x] + Round2(sum, arShift));
        }
    if (NumPlanes == 1) return;
    int chromaW = subX ? 44 : 82, chromaH = subY ? 38 : 73;
    bool cb = g.num_cb_points || g.chroma_scaling_from_luma, cr = g.num_cr_points || g.chroma_scaling_from_luma;
    RandomRegister = g.grain_seed ^ 0xb524;
    for (int y = 0; y < chromaH; y++)
      for (int x = 0; x < chromaW; x++) CbGrain[y][x] = Round2(cb ? Gaussian_Sequence[get_random_number(11)] : 0, shift);
    RandomRegister = g.grain_seed ^ 0x49d8;
    for (int y = 0; y < chromaH; y++)
      for (int x = 0; x < chromaW; x++) CrGrain[y][x] = Round2(cr ? Gaussian_Sequence[get_random_number(11)] : 0, shift);
    for (int y = 3; y < chromaH; y++)
      for (int x = 3; x < chromaW - 3; x++) {
        int sum0 = 0, sum1 = 0, pos = 0;
        for (int deltaRow = -lag; deltaRow <= 0; deltaRow++)
          for (int deltaCol = -lag; deltaCol <= lag; deltaCol++) {
            int c0 = g.ar_coeffs_cb_plus_128[pos] - 128, c1 = g.ar_coeffs_cr_plus_128[pos] - 128;
            if (deltaRow == 0 && deltaCol == 0) {
              if (g.num_y_points > 0) {
                int luma = 0;
                int lumaX = ((x - 3) << subX) + 3, lumaY = ((y - 3) << subY) + 3;
                for (int i = 0; i <= subY; i++)
                  for (int j = 0; j <= subX; j++) luma += LumaGrain[lumaY + i][lumaX + j];
                luma = Round2(luma, subX + subY);
                sum0 += luma * c0;
                sum1 += luma * c1;
              }
              break;
            }
            sum0 += c0 * CbGrain[y + deltaRow][x + deltaCol];
            sum1 += c1 * CrGrain[y + deltaRow][x + deltaCol];
            pos++;
          }
        if (cb) CbGrain[y][x] = Clip3(GrainMin, GrainMax, CbGrain[y][x] + Round2(sum0, arShift));
        if (cr) CrGrain[y][x] = Clip3(GrainMin, GrainMax, CrGrain[y][x] + Round2(sum1, arShift));
      }
  }

  // 7.18.3.4
  void init_scaling(int plane) {
    int numPoints;
    const int *value, *scaling;
    if (plane == 0 || g.chroma_scaling_from_luma) {
      numPoints = g.num_y_points;
      value = g.point_y_value;
      scaling = g.point_y_scaling;
    } else if (plane == 1) {
      numPoints = g.num_cb_points;
      value = g.point_cb_value;
      scaling = g.point_cb_scaling;
    } else {
      numPoints = g.num_cr_points;
      value = g.point_cr_value;
      scaling = g.point_cr_scaling;
    }
    int* lut = ScalingLut[plane];
    if (numPoints == 0) {
      for (int i = 0; i < 256; i++) lut[i] = 0;
      return;
    }
    for (int i = 0; i < value[0]; i++) lut[i] = scaling[0];
    for (int point = 0; point < numPoints - 1; point++) {
      int deltaY = scaling[point + 1] - scaling[point];
      int deltaX = value[point + 1] - value[point];
      if (deltaX <= 0) fail(SL_CORRUPT, "AV1 film grain points out of order");
      int delta = deltaY * ((65536 + (deltaX >> 1)) / deltaX);
      for (int x = 0; x < deltaX; x++) lut[value[point] + x] = scaling[point] + ((x * delta + 32768) >> 16);
    }
    for (int i = value[numPoints - 1]; i < 256; i++) lut[i] = scaling[numPoints - 1];
  }

  int scale_lut(int plane, int index) {
    int shift = BitDepth - 8;
    int x = index >> shift, rem = index - (x << shift);
    if (BitDepth == 8 || x == 255) return ScalingLut[plane][x];
    int start = ScalingLut[plane][x], end = ScalingLut[plane][x + 1];
    return start + Round2((end - start) * rem, shift);
  }

  // 7.18.3.5 over planes of w x h luma samples
  void add_noise(Plane* out, int w, int h) {
    int numStripes = ((h + 1) / 2 + 15) / 16;
    int stripeW = ((w + 1) / 2 + 15) / 16 * 32 + 34;
    // NoiseStripe[lumaNum][plane][34 rows][stripeW]
    std::vector<int> stripes((size_t)numStripes * NumPlanes * 34 * stripeW, 0);
    auto NS = [&](int lumaNum, int plane, int i, int x) -> int& {
      return stripes[(((size_t)lumaNum * NumPlanes + plane) * 34 + i) * stripeW + x];
    };
    int lumaNum = 0;
    for (int y = 0; y < (h + 1) / 2; y += 16) {
      RandomRegister = g.grain_seed;
      RandomRegister ^= ((lumaNum * 37 + 178) & 255) << 8;
      RandomRegister ^= ((lumaNum * 173 + 105) & 255);
      for (int x = 0; x < (w + 1) / 2; x += 16) {
        int rand = get_random_number(8);
        int offsetX = rand >> 4, offsetY = rand & 15;
        for (int plane = 0; plane < NumPlanes; plane++) {
          int planeSubX = plane ? subX : 0, planeSubY = plane ? subY : 0;
          int planeOffsetX = planeSubX ? 6 + offsetX : 9 + offsetX * 2;
          int planeOffsetY = planeSubY ? 6 + offsetY : 9 + offsetY * 2;
          int (*grain)[82] = plane == 0 ? LumaGrain : (plane == 1 ? CbGrain : CrGrain);
          for (int i = 0; i < (34 >> planeSubY); i++)
            for (int j = 0; j < (34 >> planeSubX); j++) {
              int v = grain[planeOffsetY + i][planeOffsetX + j];
              if (planeSubX == 0) {
                if (j < 2 && g.overlap_flag && x > 0) {
                  int old = NS(lumaNum, plane, i, x * 2 + j);
                  v = j == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
                  v = Clip3(GrainMin, GrainMax, Round2(v, 5));
                }
                NS(lumaNum, plane, i, x * 2 + j) = v;
              } else {
                if (j == 0 && g.overlap_flag && x > 0) {
                  int old = NS(lumaNum, plane, i, x + j);
                  v = old * 23 + v * 22;
                  v = Clip3(GrainMin, GrainMax, Round2(v, 5));
                }
                NS(lumaNum, plane, i, x + j) = v;
              }
            }
        }
      }
      lumaNum++;
    }
    // the noise image, the stripes blended where they overlap
    std::vector<int> noise[3];
    for (int plane = 0; plane < NumPlanes; plane++) {
      int planeSubX = plane ? subX : 0, planeSubY = plane ? subY : 0;
      int pw = (w + planeSubX) >> planeSubX, ph = (h + planeSubY) >> planeSubY;
      noise[plane].assign((size_t)pw * ph, 0);
      for (int y = 0; y < ph; y++) {
        int ln = y >> (5 - planeSubY), i = y - (ln << (5 - planeSubY));
        for (int x = 0; x < pw; x++) {
          int v = NS(ln, plane, i, x);
          if (planeSubY == 0) {
            if (i < 2 && ln > 0 && g.overlap_flag) {
              int old = NS(ln - 1, plane, i + 32, x);
              v = i == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
              v = Clip3(GrainMin, GrainMax, Round2(v, 5));
            }
          } else if (i < 1 && ln > 0 && g.overlap_flag) {
            int old = NS(ln - 1, plane, i + 16, x);
            v = old * 23 + v * 22;
            v = Clip3(GrainMin, GrainMax, Round2(v, 5));
          }
          noise[plane][(size_t)y * pw + x] = v;
        }
      }
    }
    int minValue, maxLuma, maxChroma;
    if (g.clip_to_restricted_range) {
      minValue = 16 << (BitDepth - 8);
      maxLuma = 235 << (BitDepth - 8);
      maxChroma = matrix == 0 ? maxLuma : 240 << (BitDepth - 8);
    } else {
      minValue = 0;
      maxLuma = maxChroma = (256 << (BitDepth - 8)) - 1;
    }
    int ScalingShift = g.grain_scaling_minus_8 + 8;
    if (NumPlanes > 1) {
      int pw = (w + subX) >> subX, ph = (h + subY) >> subY;
      for (int y = 0; y < ph; y++)
        for (int x = 0; x < pw; x++) {
          int lumaX = x << subX, lumaY = y << subY, lumaNextX = std::min(lumaX + 1, w - 1);
          int averageLuma = subX ? Round2(*out[0].at(lumaY, lumaX) + *out[0].at(lumaY, lumaNextX), 1)
                                 : *out[0].at(lumaY, lumaX);
          for (int plane = 1; plane < 3; plane++) {
            bool on = plane == 1 ? (g.num_cb_points > 0 || g.chroma_scaling_from_luma)
                                 : (g.num_cr_points > 0 || g.chroma_scaling_from_luma);
            if (!on) continue;
            uint16_t* p = out[plane].at(y, x);
            int orig = *p, merged;
            if (g.chroma_scaling_from_luma) {
              merged = averageLuma;
            } else {
              int lm = plane == 1 ? g.cb_luma_mult : g.cr_luma_mult, m = plane == 1 ? g.cb_mult : g.cr_mult;
              int off = plane == 1 ? g.cb_offset : g.cr_offset;
              int combined = averageLuma * (lm - 128) + orig * (m - 128);
              merged = ClipBd((combined >> 6) + ((off - 256) << (BitDepth - 8)), BitDepth);
            }
            int n = Round2(scale_lut(plane, merged) * noise[plane][(size_t)y * pw + x], ScalingShift);
            *p = Clip3(minValue, maxChroma, orig + n);
          }
        }
    }
    if (g.num_y_points > 0)
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          uint16_t* p = out[0].at(y, x);
          int n = Round2(scale_lut(0, *p) * noise[0][(size_t)y * w + x], ScalingShift);
          *p = Clip3(minValue, maxLuma, *p + n);
        }
  }

  void apply(Plane* out, int w, int h) {
    RandomRegister = g.grain_seed;
    GrainCenter = 128 << (BitDepth - 8);
    GrainMin = -GrainCenter;
    GrainMax = (256 << (BitDepth - 8)) - 1 - GrainCenter;
    generate_grain();
    for (int p = 0; p < NumPlanes; p++) init_scaling(p);
    add_noise(out, w, h);
  }
};

}  // namespace sl_av1
