// The port's AV1 still-image encoder (sl_av1_enc.h).
//
// The bitstream is the AV1 specification's (AV1 Bitstream & Decoding
// Process Specification): the encoder writes what the decoder's syntax
// reads (sl_av1.cpp), with the contexts and the reconstruction of
// sl_av1_recon.h. The range encoder is the inverse of the symbol decoder of
// 8.2 (libaom's od_ec layout: carries kept in 16-bit words and propagated
// when the tile is done).
//
// The decisions, per superblock (64x64; 128x128, always split, where both
// sides exceed 480, as aom picks it): a recursive search over the
// partitions NONE, HORZ, VERT and SPLIT down to 4x4 (a split is tried with
// its quarters unsplit first, and searched in depth only where that wins),
// and in each block over the 13 luma modes (the best directional one's
// angle deltas, filter intra) ranked by SATD, the exact palette of a block
// of 2 to 8 colours (with screen content tools on, aom's rule), the
// transform sizes, the chroma modes with CfL, and the transform types, by
// the cost D + lambda R. D is the sum of squared errors of the
// reconstruction (estimated from the transform's norms where only modes
// are ranked), R the bits of every symbol from the CDFs as the superblock
// starts. Costs are integers, and the few floats (the forward transforms)
// round the same on every host, so the decisions are too. The search
// leaves its decisions in a tree; a second pass codes the tree, writing
// each symbol with the adapted CDFs, and rebuilds the same reconstruction.

#include "sl_av1_enc.h"

#include <cmath>
#include <memory>
#include <type_traits>

#include "sl_av1_recon.h"

namespace {

using namespace sl_av1;

// ---------------------------------------------------------------------------
// bits and the range encoder
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> buf;
  int nbits = 0;
  void bit(int b) {
    if ((nbits & 7) == 0) buf.push_back(0);
    if (b) buf.back() |= 0x80 >> (nbits & 7);
    nbits++;
  }
  void f(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) bit((v >> i) & 1);
  }
  void byte_alignment() {
    while (nbits & 7) bit(0);
  }
  void trailing_bits() {
    bit(1);
    byte_alignment();
  }
};

void leb128(std::vector<uint8_t>& out, uint64_t v) {
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    out.push_back(b | (v ? 0x80 : 0));
  } while (v);
}

struct SymbolWriter {
  std::vector<uint16_t> precarry;
  uint64_t low = 0;
  uint32_t rng = 0x8000;
  int cnt = -9;

  void init() {
    precarry.clear();
    low = 0;
    rng = 0x8000;
    cnt = -9;
  }
  void normalize(uint64_t l, uint32_t r) {
    int d = 15 - FloorLog2(r);
    int c = cnt, s = c + d;
    if (s >= 0) {
      c += 16;
      uint64_t m = ((uint64_t)1 << c) - 1;
      if (s >= 8) {
        precarry.push_back((uint16_t)(l >> c));
        l &= m;
        c -= 8;
        m >>= 8;
      }
      precarry.push_back((uint16_t)(l >> c));
      s = c + d - 24;
      l &= m;
    }
    low = l << d;
    rng = r << d;
    cnt = s;
  }
  // symbol s of N under a CDF in the decoder's layout (cdf[N - 1] = 32768)
  void symbol(uint16_t* cdf, int N, int s, bool adapt = true) {
    uint32_t fl = s > 0 ? 32768u - cdf[s - 1] : 32768u, fh = 32768u - cdf[s];
    uint64_t l = low;
    uint32_t r = rng;
    int n = N - 1;
    uint32_t v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s);
    if (fl < 32768u) {
      uint32_t u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (n - (s - 1));
      l += r - u;
      r = u - v;
    } else {
      r -= v;
    }
    normalize(l, r);
    if (adapt) update_cdf(cdf, N, s);
  }
  void boolean(int b) {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    symbol(cdf, 2, b, false);
  }
  void literal(int n, uint32_t v) {
    for (int i = n - 1; i >= 0; i--) boolean((v >> i) & 1);
  }
  std::vector<uint8_t> done() {
    uint64_t m = 0x3FFF, e = ((low + m) & ~m) | (m + 1);
    int c = cnt, s = c + 10;
    std::vector<uint16_t> buf = precarry;
    if (s > 0) {
      uint64_t n = ((uint64_t)1 << (c + 16)) - 1;
      do {
        buf.push_back((uint16_t)(e >> (c + 16)));
        e &= n;
        s -= 8;
        c -= 8;
        n >>= 8;
      } while (s > 0);
    }
    std::vector<uint8_t> out(buf.size());
    uint32_t carry = 0;
    for (size_t i = buf.size(); i-- > 0;) {
      carry += buf[i];
      out[i] = (uint8_t)carry;
      carry >>= 8;
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
// rates: -log2 of a probability, in 1/1024 bit, by integer arithmetic
// ---------------------------------------------------------------------------

constexpr int RATE_SHIFT = 10;

struct RateTable {
  int32_t cost[32769];
  RateTable() {
    cost[0] = 20 << RATE_SHIFT;
    for (uint32_t p = 1; p <= 32768; p++) {
      // log2(p) = e + the fraction of the mantissa, bit by bit by squaring
      int e = FloorLog2(p);
      uint64_t mant = ((uint64_t)p << 30) >> e;  // in [1, 2), 30 fraction bits
      int frac = 0;
      for (int i = 0; i < RATE_SHIFT; i++) {
        mant = (mant * mant) >> 30;
        frac <<= 1;
        if (mant >= ((uint64_t)2 << 30)) {
          mant >>= 1;
          frac |= 1;
        }
      }
      cost[p] = ((15 - e) << RATE_SHIFT) - frac;
    }
  }
};

const RateTable Rates;

// the rate of symbol s under a CDF in the decoder's layout
inline int32_t sym_rate(const uint16_t* cdf, int s) {
  int p = (int)cdf[s] - (s > 0 ? (int)cdf[s - 1] : 0);
  return Rates.cost[std::max(p, 1)];
}

// a sink for the syntax: the rate it would take (Counter) or the bits
// themselves (Writer)
struct Counter {
  int64_t bits = 0;
  void symbol(uint16_t* cdf, int, int s, bool = true) { bits += sym_rate(cdf, s); }
  void literal(int n, uint32_t) { bits += (int64_t)n << RATE_SHIFT; }
};

struct Writer {
  SymbolWriter& w;
  void symbol(uint16_t* cdf, int N, int s, bool adapt = true) { w.symbol(cdf, N, s, adapt); }
  void literal(int n, uint32_t v) { w.literal(n, v); }
};

// ---------------------------------------------------------------------------
// the forward transforms: the least-squares inverses of the decoder's
// inverse transforms. The DCTs and the ADSTs of 8 and 16 points run the
// decoder's butterflies transposed (M^T x) and divide by each column's
// squared norm; ADST4 and the identities are small matrices. In double
// precision, whose rounding is the same on every host (no fused
// multiply-add: the library is built with -ffp-contract=off)
// ---------------------------------------------------------------------------

struct Forward {
  // [kind: DCT, ADST, identity][log2 n - 2]: 1 / the squared norm of each
  // coefficient's inverse (the first 32 of 64 points), and for ADST4 and
  // the identities the n x n matrix M^T / norm^2 (row k: coefficient k)
  std::vector<double> inv_norm2[3][5], m[3][5];
  // the squared norms in 1/65536, for the distortion a level error costs
  std::vector<int32_t> norm[3][5];
  Forward() {
    const int A = 1 << 12;
    for (int kind = 0; kind < 3; kind++)
      for (int ln = 2; ln <= 6; ln++) {
        if (kind > 0 && ln > 4) continue;
        int n = 1 << ln;
        std::vector<int64_t> inv((size_t)n * n);  // inv[i * n + k]: sample i of impulse k
        for (int k = 0; k < n; k++) {
          Txfm t;
          for (int i = 0; i < n; i++) t.T[i] = i == k ? A : 0;
          t.run(kind, ln);
          for (int i = 0; i < n; i++) inv[(size_t)i * n + k] = t.T[i];
        }
        norm[kind][ln - 2].assign(n, 0);
        inv_norm2[kind][ln - 2].assign(n, 0.0);
        m[kind][ln - 2].assign((size_t)n * n, 0.0);
        for (int k = 0; k < std::min(n, 32); k++) {
          int64_t nk = 0;
          for (int i = 0; i < n; i++) nk += inv[(size_t)i * n + k] * inv[(size_t)i * n + k];
          norm[kind][ln - 2][k] = (int32_t)(nk >> 8);  // / A^2 * 2^16
          inv_norm2[kind][ln - 2][k] = (double)A * A / (double)nk;
          for (int i = 0; i < n; i++) m[kind][ln - 2][(size_t)k * n + i] = (double)inv[(size_t)i * n + k] * A / (double)nk;
        }
      }
  }
};

const Forward& forward() {
  static const Forward t;
  return t;
}

// the transpose of recorded butterflies
void transpose_ops(const std::vector<TxOp>& ops, double* T) {
  for (auto o = ops.rbegin(); o != ops.rend(); ++o) {
    int a = o->a, b = o->b;
    if (o->rotate) {
      if (o->flip) std::swap(T[a], T[b]);
      double c = o->c / 4096.0, s = o->s / 4096.0, x = T[a], y = T[b];
      T[a] = x * c + y * s;
      T[b] = y * c - x * s;
    } else {
      if (o->flip) std::swap(a, b);
      double x = T[a], y = T[b];
      T[a] = x + y;
      T[b] = x - y;
    }
  }
}

// the 1D forward transform of 2^ln points in place (kind: 0 DCT, 1 ADST,
// 2 identity)
void forward_1d(int kind, int ln, double* v) {
  const Forward& F = forward();
  int n = 1 << ln;
  double out[64];
  if (kind == 0) {
    transpose_ops(Dct_Ops[ln], v);
    for (int i = 0; i < n; i++) out[Brev[ln][i]] = v[i];
  } else if (kind == 1 && ln > 2) {
    // the transposes of adst_out_perm, the butterflies and adst_in_perm
    double t[16];
    for (int i = 0; i < n; i++) {
      int a = (i >> 3) & 1, b = ((i >> 2) & 1) ^ ((i >> 3) & 1), c = ((i >> 1) & 1) ^ ((i >> 2) & 1),
          d = (i & 1) ^ ((i >> 1) & 1);
      int idx = ((d << 3) | (c << 2) | (b << 1) | a) >> (4 - ln);
      t[idx] = (i & 1) ? -v[i] : v[i];
    }
    transpose_ops(Adst_Ops[ln], t);
    for (int i = 0; i < n; i++) out[(i & 1) ? (i - 1) : (n - i - 1)] = t[i];
  } else {
    const double* m = F.m[kind][ln - 2].data();
    for (int k = 0; k < n; k++) {
      double a = 0.0;
      for (int i = 0; i < n; i++) a += m[k * n + i] * v[i];
      out[k] = a;
    }
    memcpy(v, out, n * sizeof(double));
    return;
  }
  const double* in2 = F.inv_norm2[kind][ln - 2].data();
  for (int k = 0; k < std::min(n, 32); k++) v[k] = out[k] * in2[k];
}

// ---------------------------------------------------------------------------
// the encoder
// ---------------------------------------------------------------------------

// the modes of one block
struct Modes {
  int y = DC_PRED, uv = DC_PRED, dy = 0, duv = 0, cflU = 0, cflV = 0, fi = 0, fiMode = 0, txDepth = 0;
  int palY = 0, palUV = 0;
  uint16_t colY[8], colU[8], colV[8];
};

// the decisions of a partition node
struct Node {
  int partition = PARTITION_NONE;
  Modes modes[4];
  std::unique_ptr<Node> sub[4];
};

// one coded transform block
struct TxBlock {
  int plane, x4, y4, txSz, txType, eob;
  int32_t lev[1024];  // signed levels in the decoder's Quant layout
};

constexpr int SEARCH_LUMA = 2;    // luma modes given the full rate-distortion test
constexpr int SEARCH_CHROMA = 2;  // chroma modes given it
constexpr int AC_ROUND = 112;     // the rounding of AC levels, in 1/256: a dead zone

struct Encoder : Recon {
  int visW[3] = {0}, visH[3] = {0};
  Plane src[3];
  Cdfs live, est;
  SymbolWriter sw;
  int64_t lambda = 0;     // SSE per bit, in 1/256
  int64_t lambdaSad = 0;  // SATD per bit, in 1/256 (its square root)
  int allow_screen_content_tools = 0;
  std::vector<TxBlock> txb;  // the transform blocks of the block being coded

  // ---- set-up ------------------------------------------------------------

  void init(int width, int height, bool mono, int q) {
    init_tables();
    seq = SequenceHeader();
    seq.still_picture = seq.reduced_still_picture_header = 1;
    seq.enable_filter_intra = seq.enable_intra_edge_filter = 1;
    // aom's superblocks of 128x128 above 480p
    seq.use_128x128_superblock = std::min(width, height) > 480;
    seq.mono_chrome = mono;
    seq.NumPlanes = mono ? 1 : 3;
    seq.color_range = 1;
    seq.valid = true;
    FrameWidth = width;
    FrameHeight = height;
    MiCols = 2 * ((FrameWidth + 7) >> 3);
    MiRows = 2 * ((FrameHeight + 7) >> 3);
    base_q_idx = q;
    // aom's loop filter level from the quantizer for a key frame (8-bit)
    int aq = Ac_Qlookup[q];
    int lvl = Clip3(0, 63, (aq * 17563 - 421574 + (1 << 17)) >> 18);
    for (int i = 0; i < 4; i++) loop_filter_level[i] = lvl;
    loop_filter_sharpness = 0;
    loop_filter_delta_enabled = 1;
    // SSE per bit: ac_q^2 / 560, near aom's RD multiplier for an intra
    // frame; an alpha plane a quarter of that (its few bytes buy sharp edges)
    lambda = (int64_t)aq * aq * 256 / (mono ? 2240 : 560);
    lambdaSad = 1;
    while ((lambdaSad + 1) * (lambdaSad + 1) <= lambda * 256) lambdaSad++;
    set_tiles();
    alloc();
    txb.resize(25);  // the last is the transform type search's
  }

  // libavif's automatic tiles (avifSetTileConfiguration) for a host of 8
  // threads: one tile for each 512x512 of area, at most 8 tiles, a power of
  // two split towards square tiles
  void set_tiles() {
    const int threads = 8;
    uint64_t area = (uint64_t)FrameWidth * FrameHeight, kMinTileArea = 512 * 512;
    uint64_t tiles = std::min<uint64_t>((area + kMinTileArea - 1) / kMinTileArea, 32);
    tiles = std::min<uint64_t>(tiles, threads);
    int tilesLog2 = 0;
    while (tiles >>= 1) tilesLog2++;
    auto split = [&](uint32_t dim1, uint32_t dim2, int* log1, int* log2) {
      uint32_t ratio = dim1 / dim2;
      int diffLog2 = 0;
      while (ratio >>= 1) diffLog2++;
      int subtract = std::max(tilesLog2 - diffLog2, 0);
      *log2 = subtract / 2;
      *log1 = tilesLog2 - *log2;
    };
    int colsLog2, rowsLog2;
    if (FrameWidth >= FrameHeight) split(FrameWidth, FrameHeight, &colsLog2, &rowsLog2);
    else split(FrameHeight, FrameWidth, &rowsLog2, &colsLog2);
    TileLimits t = tile_limits();
    TileColsLog2 = Clip3(t.minLog2TileCols, t.maxLog2TileCols, colsLog2);
    TileRowsLog2 = Clip3(std::max(t.minLog2Tiles - TileColsLog2, 0), t.maxLog2TileRows, rowsLog2);
    uniform_tile_starts(t);
  }

  void set_source(int p, const uint8_t* data, int w, int h) {
    visW[p] = w;
    visH[p] = h;
    src[p].stride = planes[p].stride;
    src[p].rows = planes[p].rows;
    src[p].px.assign(planes[p].px.size(), 0);
    for (int y = 0; y < src[p].rows; y++) {
      const uint8_t* row = data + (size_t)std::min(y, h - 1) * w;
      uint16_t* d = src[p].at(y, 0);
      std::copy(row, row + w, d);
      std::fill(d + w, d + src[p].stride, row[w - 1]);
    }
  }

  // ---- the syntax (what the decoder reads, in its order) --------------------

  template <class S>
  void code_partition(S& s, Cdfs& c, int r, int cc, int bSize, int partition) {
    if (bSize < BLOCK_8X8) return;
    int halfBlock4x4 = Num_4x4_Blocks_Wide[bSize] >> 1;
    bool hasRows = (r + halfBlock4x4) < MiRows, hasCols = (cc + halfBlock4x4) < MiCols;
    int bsl = Mi_Width_Log2[bSize], ctx = partition_ctx(r, cc, bSize);
    uint16_t* pc;
    int N;
    switch (bsl) {
      case 1: N = 4; pc = c.part8[ctx]; break;
      case 2: N = 10; pc = c.part16[ctx]; break;
      case 3: N = 10; pc = c.part32[ctx]; break;
      case 4: N = 10; pc = c.part64[ctx]; break;
      default: N = 8; pc = c.part128[ctx]; break;
    }
    if (hasRows && hasCols) {
      s.symbol(pc, N, partition);
    } else if (hasCols || hasRows) {
      uint16_t bc[3] = {(uint16_t)((1 << 15) - partition_split_prob(pc, bSize, hasCols)), 1 << 15, 0};
      s.symbol(bc, 2, partition == PARTITION_SPLIT, false);
    }
  }

  // the mode info of intra_frame_mode_info(), palette_tokens() and
  // read_tx_size(), in the decoder's order
  template <class S>
  void code_mode_info(S& s, Cdfs& c) {
    s.symbol(c.skip[skip_ctx()], 2, skip);
    code_y_mode(s, c);
    if (HasChroma) code_uv_mode(s, c);
    if (palette_allowed()) {
      code_palette_y(s, c);
      code_palette_uv(s, c);
    }
    code_filter_intra(s, c);
    if (PaletteSizeY) code_color_map(s, c, 0);
    if (PaletteSizeUV) code_color_map(s, c, 1);
    code_tx_depth(s, c);
  }
  template <class S>
  void code_y_mode(S& s, Cdfs& c) {
    s.symbol(c.y_mode[above_mode_ctx()][left_mode_ctx()], 13, YMode);
    if (MiSize >= BLOCK_8X8 && is_directional_mode(YMode))
      s.symbol(c.angle_delta[YMode - V_PRED], 7, AngleDeltaY + 3);
  }
  template <class S>
  void code_uv_mode(S& s, Cdfs& c) {
    if (cfl_allowed()) s.symbol(c.uv_cfl[YMode], 14, UVMode);
    else s.symbol(c.uv_nocfl[YMode], 13, UVMode);
    if (UVMode == UV_CFL_PRED) {
      int signU = CflAlphaU == 0 ? 0 : (CflAlphaU < 0 ? 1 : 2);
      int signV = CflAlphaV == 0 ? 0 : (CflAlphaV < 0 ? 1 : 2);
      s.symbol(c.cfl_sign, 8, signU * 3 + signV - 1);
      if (signU) s.symbol(c.cfl_alpha[(signU - 1) * 3 + signV], 16, std::abs(CflAlphaU) - 1);
      if (signV) s.symbol(c.cfl_alpha[(signV - 1) * 3 + signU], 16, std::abs(CflAlphaV) - 1);
    }
    if (MiSize >= BLOCK_8X8 && is_directional_mode(UVMode))
      s.symbol(c.angle_delta[UVMode - V_PRED], 7, AngleDeltaUV + 3);
  }
  template <class S>
  void code_filter_intra(S& s, Cdfs& c) {
    if (filter_intra_allowed()) {
      s.symbol(c.filter_intra[MiSize], 2, use_filter_intra);
      if (use_filter_intra) s.symbol(c.filter_intra_mode, 5, filter_intra_mode);
    }
  }

  // ---- palettes (palette_mode_info, get_palette_cache, palette_tokens) ------

  bool palette_allowed() {
    return allow_screen_content_tools && MiSize >= BLOCK_8X8 && Block_Width(MiSize) <= 64 &&
           Block_Height(MiSize) <= 64;
  }
  int palette_bsize_ctx() { return Mi_Width_Log2[MiSize] + Mi_Height_Log2[MiSize] - 2; }
  template <class S>
  void code_palette_y(S& s, Cdfs& c) {
    if (YMode != DC_PRED) return;
    int ctx = (AvailU && M(MiRow - 1, MiCol).palette_size[0] > 0) + (AvailL && M(MiRow, MiCol - 1).palette_size[0] > 0);
    s.symbol(c.pal_y_mode[palette_bsize_ctx()][ctx], 2, PaletteSizeY > 0);
    if (PaletteSizeY) {
      s.symbol(c.pal_y_size[palette_bsize_ctx()], 7, PaletteSizeY - 2);
      code_palette_colors(s, 0);
    }
  }
  template <class S>
  void code_palette_uv(S& s, Cdfs& c) {
    if (!HasChroma || UVMode != DC_PRED) return;
    s.symbol(c.pal_uv_mode[PaletteSizeY > 0], 2, PaletteSizeUV > 0);
    if (PaletteSizeUV) {
      s.symbol(c.pal_uv_size[palette_bsize_ctx()], 7, PaletteSizeUV - 2);
      code_palette_colors(s, 1);
    }
  }
  // the colours, ascending (Y distinct): those of the neighbours' cache by
  // a flag each, the rest as a literal and deltas; V as literals
  template <class S>
  void code_palette_colors(S& s, int plane) {
    int n = plane ? PaletteSizeUV : PaletteSizeY;
    const uint16_t* col = plane ? palette_colors_u : palette_colors_y;
    uint16_t cache[16];
    int cacheN = get_palette_cache(plane, cache), idx = 0;
    bool used[8] = {false};
    for (int i = 0; i < cacheN && idx < n; i++) {
      int hit = -1;
      for (int k = 0; k < n && hit < 0; k++)
        if (!used[k] && col[k] == cache[i]) hit = k;
      s.literal(1, hit >= 0);
      if (hit >= 0) {
        used[hit] = true;
        idx++;
      }
    }
    int rest[8], nr = 0;
    for (int k = 0; k < n; k++)
      if (!used[k]) rest[nr++] = col[k];
    if (nr > 0) s.literal(8, rest[0]);
    if (nr > 1) {
      int minDelta = plane == 0 ? 1 : 0, bits = 5;
      for (int k = 1; k < nr; k++) {
        int d = rest[k] - rest[k - 1] - minDelta;
        if (d > 0) bits = std::max(bits, FloorLog2(d) + 1);
      }
      s.literal(2, bits - 5);
      for (int k = 1; k < nr; k++) {
        s.literal(bits, rest[k] - rest[k - 1] - minDelta);
        bits = std::min(bits, CeilLog2(256 - rest[k] - minDelta));
      }
    }
    if (plane) {
      s.literal(1, 0);  // delta_encode_palette_colors_v
      for (int k = 0; k < n; k++) s.literal(8, palette_colors_v[k]);
    }
  }
  template <class S>
  void code_color_map(S& s, Cdfs& c, int plane) {
    int n = plane ? PaletteSizeUV : PaletteSizeY;
    uint8_t (*map)[64] = plane ? ColorMapUV : ColorMapY;
    int bw, bh, ow, oh;
    color_map_size(plane, &bw, &bh, &ow, &oh);
    // map[0][0] in ns(n)
    int w = FloorLog2(n) + 1, m = (1 << w) - n, v = map[0][0];
    if (v < m) {
      s.literal(w - 1, v);
    } else {
      s.literal(w - 1, (v + m) >> 1);
      s.literal(1, (v + m) & 1);
    }
    for (int i = 1; i < oh + ow - 1; i++)
      for (int j = std::min(i, ow - 1); j >= std::max(0, i - oh + 1); j--) {
        int r = i - j, order[8];
        int ctx = palette_color_context(map, r, j, n, order), sym = 0;
        while (order[sym] != map[r][j]) sym++;
        s.symbol(palette_color_cdf(c, plane, n, ctx), n, sym);
      }
  }
  // the colour map of the block's source under its palette: each sample's
  // nearest colour
  void build_color_map(int plane) {
    int n = plane ? PaletteSizeUV : PaletteSizeY;
    uint8_t (*map)[64] = plane ? ColorMapUV : ColorMapY;
    int bw, bh, ow, oh;
    color_map_size(plane, &bw, &bh, &ow, &oh);
    int sx = plane ? seq.subsampling_x : 0, sy = plane ? seq.subsampling_y : 0;
    int x0 = (MiCol >> sx) * 4, y0 = (MiRow >> sy) * 4;
    for (int i = 0; i < oh; i++)
      for (int j = 0; j < ow; j++) {
        int best = 0, bestE = INT32_MAX;
        for (int k = 0; k < n; k++) {
          int e;
          if (plane == 0) {
            e = std::abs(*src[0].at(y0 + i, x0 + j) - palette_colors_y[k]);
          } else {
            int du = *src[1].at(y0 + i, x0 + j) - palette_colors_u[k];
            int dv = *src[2].at(y0 + i, x0 + j) - palette_colors_v[k];
            e = du * du + dv * dv;
          }
          if (e < bestE) {
            bestE = e;
            best = k;
          }
        }
        map[i][j] = best;
      }
    extend_color_map(map, bw, bh, ow, oh);
  }
  // the distinct values (or U, V pairs) of the block's onscreen source, if
  // 2 to 8: a palette that predicts it exactly
  int exact_palette(int plane, uint16_t* a, uint16_t* b) {
    int bw, bh, ow, oh;
    color_map_size(plane, &bw, &bh, &ow, &oh);
    int sx = plane ? seq.subsampling_x : 0, sy = plane ? seq.subsampling_y : 0;
    int x0 = (MiCol >> sx) * 4, y0 = (MiRow >> sy) * 4, n = 0;
    int keys[16];
    for (int i = 0; i < oh; i++)
      for (int j = 0; j < ow; j++) {
        int key = plane == 0 ? *src[0].at(y0 + i, x0 + j)
                             : (*src[1].at(y0 + i, x0 + j) << 8) | *src[2].at(y0 + i, x0 + j);
        bool seen = false;
        for (int k = 0; k < n && !seen; k++) seen = keys[k] == key;
        if (!seen) {
          if (n == 8) return 0;
          keys[n++] = key;
        }
      }
    if (n < 2) return 0;
    std::sort(keys, keys + n);
    for (int k = 0; k < n; k++) {
      a[k] = plane == 0 ? keys[k] : keys[k] >> 8;
      if (b) b[k] = keys[k] & 255;
    }
    return n;
  }

  // read_tx_size()'s tx_depth
  template <class S>
  void code_tx_depth(S& s, Cdfs& c) {
    if (MiSize == BLOCK_4X4) return;
    int maxRect = Max_Tx_Size_Rect[MiSize], cat = tx_depth_cat(maxRect), ctx = tx_depth_ctx(maxRect);
    int depth = 0;
    for (int t = maxRect; t != TxSize; t = Split_Tx_Size[t]) depth++;
    if (cat == 0) s.symbol(c.tx8[ctx], 2, depth);
    else if (cat == 1) s.symbol(c.tx16[ctx], 3, depth);
    else if (cat == 2) s.symbol(c.tx32[ctx], 3, depth);
    else s.symbol(c.tx64[ctx], 3, depth);
  }
  int max_tx_depth() {
    if (MiSize == BLOCK_4X4) return 0;
    return std::min(2, tx_depth_cat(Max_Tx_Size_Rect[MiSize]) + 1);
  }

  // the rate of the luma's mode info alone (the luma search's)
  int64_t luma_mode_rate(Cdfs& c) {
    Counter k;
    code_y_mode(k, c);
    if (palette_allowed()) code_palette_y(k, c);
    code_filter_intra(k, c);
    if (PaletteSizeY) code_color_map(k, c, 0);
    code_tx_depth(k, c);
    return k.bits;
  }
  int64_t chroma_mode_rate(Cdfs& c) {
    Counter k;
    code_uv_mode(k, c);
    if (palette_allowed()) code_palette_uv(k, c);
    if (PaletteSizeUV) code_color_map(k, c, 1);
    return k.bits;
  }

  // coeffs(): the transform block's levels, written; the contexts are left
  // as the decoder leaves them
  void write_coeffs(Writer& s, Cdfs& c, const TxBlock& t) {
    int plane = t.plane, txSz = t.txSz, x4 = t.x4, y4 = t.y4, eob = t.eob;
    int txSzCtx = tx_size_ctx(txSz), ptype = plane > 0;
    s.symbol(c.txb_skip[txSzCtx][txb_skip_ctx(plane, txSz, x4, y4)], 2, eob == 0);
    if (eob == 0) {
      commit_coeffs(t);
      return;
    }
    if (plane == 0) {
      int set = get_tx_set(txSz);
      if (set > 0) {
        int txSzSqr = Tx_Size_Sqr[txSz], dir = intra_tx_dir();
        if (set == TX_SET_INTRA_1) {
          int i = 0;
          while (Tx_Type_Intra_Inv_Set1[i] != t.txType) i++;
          s.symbol(c.tx_set1[txSzSqr][dir], 7, i);
        } else {
          int i = 0;
          while (Tx_Type_Intra_Inv_Set2[i] != t.txType) i++;
          s.symbol(c.tx_set2[txSzSqr][dir], 5, i);
        }
      }
    }
    PlaneTxType = t.txType;
    const uint16_t* scan = get_scan(txSz);
    int eobMultisize = eob_multisize(txSz);
    int ectx = get_tx_class(PlaneTxType) == TX_CLASS_2D ? 0 : 1;
    int eobPt = eob <= 2 ? eob : 2 + FloorLog2(eob - 1);
    switch (eobMultisize) {
      case 0: s.symbol(c.eob16[ptype][ectx], 5, eobPt - 1); break;
      case 1: s.symbol(c.eob32[ptype][ectx], 6, eobPt - 1); break;
      case 2: s.symbol(c.eob64[ptype][ectx], 7, eobPt - 1); break;
      case 3: s.symbol(c.eob128[ptype][ectx], 8, eobPt - 1); break;
      case 4: s.symbol(c.eob256[ptype][ectx], 9, eobPt - 1); break;
      case 5: s.symbol(c.eob512[ptype], 10, eobPt - 1); break;
      default: s.symbol(c.eob1024[ptype], 11, eobPt - 1); break;
    }
    if (eobPt >= 3) {
      int rem = eob - ((1 << (eobPt - 2)) + 1);
      s.symbol(c.eob_extra[txSzCtx][ptype][eobPt - 3], 2, (rem >> (eobPt - 3)) & 1);
      for (int i = 1; i < eobPt - 2; i++) s.literal(1, (rem >> (eobPt - 3 - i)) & 1);
    }
    int segEob = (txSz == TX_16X64 || txSz == TX_64X16) ? 512 : std::min(1024, Tx_Width(txSz) * Tx_Height(txSz));
    for (int k = 0; k < segEob; k++) Quant[k] = 0;
    for (int k = eob - 1; k >= 0; k--) {
      int pos = scan[k];
      int level = std::abs(t.lev[pos]);
      if (k == eob - 1) {
        int bctx = get_coeff_base_ctx(txSz, pos, k, true) - 42 + 4;
        s.symbol(c.base_eob[txSzCtx][ptype][bctx], 3, std::min(level, 3) - 1);
      } else {
        s.symbol(c.base[txSzCtx][ptype][get_coeff_base_ctx(txSz, pos, k, false)], 4, std::min(level, 3));
      }
      if (level > 2) {
        int brctx = get_br_ctx(txSz, pos);
        int rest = level - 3;
        for (int idx = 0; idx < 4; idx++) {
          int br = std::min(rest, 3);
          s.symbol(c.br[std::min(txSzCtx, 3)][ptype][brctx], 4, br);
          rest -= br;
          if (br < 3) break;
        }
      }
      Quant[pos] = std::min(level, 15);
    }
    for (int k = 0; k < eob; k++) {
      int pos = scan[k], v = t.lev[pos], level = std::abs(v);
      if (v != 0) {
        if (k == 0) s.symbol(c.dc_sign[ptype][dc_sign_ctx(plane, txSz, x4, y4)], 2, v < 0);
        else s.literal(1, v < 0);
      }
      if (level > 14) {  // Exp-Golomb of level - 14
        uint32_t g = level - 14;
        int length = FloorLog2(g) + 1;
        s.literal(length - 1, 0);
        s.literal(length, g);
      }
    }
    commit_coeffs(t);
  }

  // the contexts coeffs() leaves for the next transform blocks
  void commit_coeffs(const TxBlock& t) {
    if (t.plane == 0) set_tx_types(t.x4, t.y4, t.txSz, t.eob ? t.txType : (int)DCT_DCT);
    int culLevel = 0, dcCategory = 0;
    if (t.eob) {
      int n = std::min(Tx_Width(t.txSz), 32) * std::min(Tx_Height(t.txSz), 32);
      for (int i = 0; i < n; i++) culLevel += std::abs(t.lev[i]);
      if (t.lev[0]) dcCategory = t.lev[0] < 0 ? 1 : 2;
    }
    set_coeff_ctx(t.plane, t.txSz, t.x4, t.y4, std::min(63, culLevel), dcCategory);
  }

  // the rate write_coeffs would take, from the CDFs as they stand (its
  // contexts from the levels in a zero-padded square)
  int64_t coeff_rate(const TxBlock& t, Cdfs& c) {
    int plane = t.plane, txSz = t.txSz, eob = t.eob;
    int txSzCtx = tx_size_ctx(txSz), ptype = plane > 0;
    int64_t bits = sym_rate(c.txb_skip[txSzCtx][txb_skip_ctx(plane, txSz, t.x4, t.y4)], eob == 0);
    if (eob == 0) return bits;
    if (plane == 0) {
      int set = get_tx_set(txSz);
      if (set > 0) {
        int txSzSqr = Tx_Size_Sqr[txSz], dir = intra_tx_dir(), i = 0;
        if (set == TX_SET_INTRA_1) {
          while (Tx_Type_Intra_Inv_Set1[i] != t.txType) i++;
          bits += sym_rate(c.tx_set1[txSzSqr][dir], i);
        } else {
          while (Tx_Type_Intra_Inv_Set2[i] != t.txType) i++;
          bits += sym_rate(c.tx_set2[txSzSqr][dir], i);
        }
      }
    }
    PlaneTxType = t.txType;
    const uint16_t* scan = get_scan(txSz);
    int txClass = get_tx_class(t.txType), ectx = txClass == TX_CLASS_2D ? 0 : 1;
    int eobPt = eob <= 2 ? eob : 2 + FloorLog2(eob - 1);
    const uint16_t* ec;
    switch (eob_multisize(txSz)) {
      case 0: ec = c.eob16[ptype][ectx]; break;
      case 1: ec = c.eob32[ptype][ectx]; break;
      case 2: ec = c.eob64[ptype][ectx]; break;
      case 3: ec = c.eob128[ptype][ectx]; break;
      case 4: ec = c.eob256[ptype][ectx]; break;
      case 5: ec = c.eob512[ptype]; break;
      default: ec = c.eob1024[ptype]; break;
    }
    bits += sym_rate(ec, eobPt - 1);
    if (eobPt >= 3) {
      int rem = eob - ((1 << (eobPt - 2)) + 1);
      bits += sym_rate(c.eob_extra[txSzCtx][ptype][eobPt - 3], (rem >> (eobPt - 3)) & 1);
      bits += (int64_t)(eobPt - 3) << RATE_SHIFT;
    }
    int adj = Adjusted_Tx_Size(txSz), bwl = Tx_Width_Log2[adj], txw = 1 << bwl, txh = Tx_Height(adj);
    const int S = 36;  // the padded square's stride
    static thread_local uint8_t lv[36 * 36];
    for (int i = 0; i < txh + 4; i++) memset(lv + i * S, 0, txw + 4);
    int area = txh << bwl;
    int cmax = std::min(txSzCtx, 3);
    for (int k = eob - 1; k >= 0; k--) {
      int pos = scan[k], row = pos >> bwl, col = pos & (txw - 1);
      int level = std::abs(t.lev[pos]);
      if (k == eob - 1) {
        int bctx = k == 0 ? 0 : (k <= area / 8 ? 1 : (k <= area / 4 ? 2 : 3));
        bits += sym_rate(c.base_eob[txSzCtx][ptype][bctx], std::min(level, 3) - 1);
      } else {
        int mag = 0;
        for (int i = 0; i < 5; i++)
          mag += std::min<int>(lv[(row + Sig_Ref_Diff_Offset[txClass][i][0]) * S + col +
                                  Sig_Ref_Diff_Offset[txClass][i][1]], 3);
        int ctx = std::min((mag + 1) >> 1, 4);
        if (txClass == TX_CLASS_2D) ctx = (row == 0 && col == 0) ? 0 : ctx + Coeff_Base_Ctx_Offset[txSz][std::min(row, 4)][std::min(col, 4)];
        else ctx += Coeff_Base_Pos_Ctx_Offset[std::min(txClass == TX_CLASS_VERT ? row : col, 2)];
        bits += sym_rate(c.base[txSzCtx][ptype][ctx], std::min(level, 3));
      }
      if (level > 2) {
        int mag = 0;
        for (int i = 0; i < 3; i++)
          mag += lv[(row + Mag_Ref_Offset_With_Tx_Class[txClass][i][0]) * S + col +
                    Mag_Ref_Offset_With_Tx_Class[txClass][i][1]];
        mag = std::min((mag + 1) >> 1, 6);
        int brctx;
        if (pos == 0) brctx = mag;
        else if (txClass == TX_CLASS_2D) brctx = mag + ((row < 2 && col < 2) ? 7 : 14);
        else if (txClass == TX_CLASS_HORIZ) brctx = mag + (col == 0 ? 7 : 14);
        else brctx = mag + (row == 0 ? 7 : 14);
        const uint16_t* bc = c.br[cmax][ptype][brctx];
        int rest = level - 3;
        for (int idx = 0; idx < 4; idx++) {
          int br = std::min(rest, 3);
          bits += sym_rate(bc, br);
          rest -= br;
          if (br < 3) break;
        }
      }
      lv[row * S + col] = std::min(level, 15);
      if (level) {
        if (k == 0) bits += sym_rate(c.dc_sign[ptype][dc_sign_ctx(plane, txSz, t.x4, t.y4)], t.lev[pos] < 0);
        else bits += 1 << RATE_SHIFT;
        if (level > 14) bits += (int64_t)(2 * FloorLog2(level - 14) + 1) << RATE_SHIFT;
      }
    }
    return bits;
  }

  // ---- transform blocks ----------------------------------------------------

  int64_t sse(int plane, int x0, int y0, int w, int h) {
    int64_t d = 0;
    int x1 = std::min(x0 + w, visW[plane]), y1 = std::min(y0 + h, visH[plane]);
    for (int y = y0; y < y1; y++) {
      const uint16_t* a = planes[plane].at(y, 0);
      const uint16_t* b = src[plane].at(y, 0);
      for (int x = x0; x < x1; x++) {
        int e = a[x] - b[x];
        d += e * e;
      }
    }
    return d;
  }

  // the sum of absolute 4x4 Hadamard coefficients of source less prediction
  int64_t satd(int plane, int x0, int y0, int w, int h) {
    int64_t sum = 0;
    for (int by = 0; by < h; by += 4)
      for (int bx = 0; bx < w; bx += 4) {
        int d[16];
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 4; j++)
            d[i * 4 + j] = *src[plane].at(y0 + by + i, x0 + bx + j) - *planes[plane].at(y0 + by + i, x0 + bx + j);
        for (int i = 0; i < 4; i++) {
          int* r = d + 4 * i;
          int a0 = r[0] + r[3], a1 = r[1] + r[2], a2 = r[1] - r[2], a3 = r[0] - r[3];
          r[0] = a0 + a1;
          r[1] = a3 + a2;
          r[2] = a0 - a1;
          r[3] = a3 - a2;
        }
        for (int j = 0; j < 4; j++) {
          int a0 = d[j] + d[12 + j], a1 = d[4 + j] + d[8 + j], a2 = d[4 + j] - d[8 + j], a3 = d[j] - d[12 + j];
          sum += std::abs(a0 + a1) + std::abs(a3 + a2) + std::abs(a0 - a1) + std::abs(a3 - a2);
        }
      }
    return sum / 2;
  }

  // the forward transform of the residual and its quantization to levels
  // (a dead zone of 0.125 for AC); returns the eob, and the distortion of
  // the levels and of no coefficients at all as the transform's norms
  // estimate them (in the 64-point transforms, of the coded quarter)
  int quantize(int plane, const int32_t* resid, int txSz, int txType, int32_t* lev, int64_t* dist,
               int64_t* distZero) {
    const Forward& F = forward();
    int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
    int w = 1 << log2W, h = 1 << log2H, tw = std::min(w, 32), th = std::min(h, 32);
    const int32_t* Nr = F.norm[RowKind[txType]][log2W - 2].data();
    const int32_t* Nc = F.norm[ColKind[txType]][log2H - 2].data();
    int qindex = base_q_idx;
    int dcQ = plane == 0 ? Dc_Qlookup[qindex + DeltaQYDc] : Dc_Qlookup[qindex + DeltaQUDc];
    int acQ = plane == 0 ? Ac_Qlookup[qindex] : Ac_Qlookup[qindex + DeltaQUAc];
    int pels = w * h, dqDenom = 1 << ((pels > 256) + (pels > 1024));
    // 2^40 / (q << 8), rounded up: floor((v + rnd) / (q << 8)) for the v here
    int64_t dcRecip = (((int64_t)1 << 32) + dcQ - 1) / dcQ, acRecip = (((int64_t)1 << 32) + acQ - 1) / acQ;
    int rowShift = Transform_Row_Shift[txSz];
    bool rect = std::abs(log2W - log2H) == 1;
    // the columns, then the rows; X = that * 2^(rowShift + 4) / rect
    static thread_local double tmp[32][64];
    double v[64];
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) v[i] = resid[i * w + j];
      forward_1d(ColKind[txType], log2H, v);
      for (int k = 0; k < th; k++) tmp[k][j] = v[k];
    }
    double scale = (double)(1 << (rowShift + 4)) * 256.0 * (rect ? 4096.0 / 2896.0 : 1.0);
    static thread_local int64_t Xq[32 * 32];  // X in 1/256
    for (int k = 0; k < th; k++) {
      memcpy(v, tmp[k], w * sizeof(double));
      forward_1d(RowKind[txType], log2W, v);
      for (int l = 0; l < tw; l++) Xq[k * tw + l] = (int64_t)std::floor(v[l] * scale + 0.5);
    }
    // an error E in X costs E^2 nc^2 nr^2 rect^2 / 2^(2 (rowShift + 4)) in samples
    int dshift = 16 + 2 * (rowShift + 4) + (rect ? 1 : 0);
    int64_t d = 0, d0 = 0;
    for (int k = 0; k < th; k++)
      for (int l = 0; l < tw; l++) {
        int64_t X = Xq[k * tw + l];
        bool dc = k == 0 && l == 0;
        int q = dc ? dcQ : acQ;
        int64_t v = std::llabs(X) * dqDenom;
        int64_t level = std::min<int64_t>(((v + (dc ? 128 : AC_ROUND) * q) * (dc ? dcRecip : acRecip)) >> 40, 1 << 14);
        lev[k * tw + l] = (int32_t)(X < 0 ? -level : level);
        int64_t wgt = ((int64_t)Nc[k] * Nr[l]) >> 16;
        int64_t e = (std::llabs(X) - ((((level * q) & 0xFFFFFF) >> (dqDenom >> 1)) << 8) + 128) >> 8;
        int64_t x0 = (std::llabs(X) + 128) >> 8;
        d += e * e * wgt;
        d0 += x0 * x0 * wgt;
      }
    *dist = d >> dshift;
    *distZero = d0 >> dshift;
    int eob = 0, n = std::min(1024, tw * th);
    PlaneTxType = txType;
    const uint16_t* scan = get_scan(txSz);
    for (int c = 0; c < n; c++)
      if (lev[scan[c]]) eob = c + 1;
    return eob;
  }

  // predicts, transforms and quantizes one transform block into t, the
  // transform type too where searchTypes, by D + lambda R with D as the
  // transform's norms estimate it; returns that cost. With ``recon`` it
  // then reconstructs the block, leaves the contexts as the decoder would,
  // adds the exact D to *dist and the rate to *rate and returns the exact
  // cost
  int64_t code_tx(int plane, int startX, int startY, int x, int y, int txSz, bool searchTypes, TxBlock& t,
                  int64_t* dist, int64_t* rate, bool recon = true) {
    int w = Tx_Width(txSz), h = Tx_Height(txSz), tw = std::min(w, 32), th = std::min(h, 32);
    predict_tx_intra(plane, startX, startY, x, y, txSz);
    static thread_local int32_t resid[64 * 64];
    for (int i = 0; i < h; i++) {
      const uint16_t* p = planes[plane].at(startY + i, startX);
      const uint16_t* s = src[plane].at(startY + i, startX);
      for (int j = 0; j < w; j++) resid[i * w + j] = s[j] - p[j];
    }
    t.plane = plane;
    t.x4 = startX >> 2;
    t.y4 = startY >> 2;
    t.txSz = txSz;
    int types[4], ntypes = 0;
    types[ntypes++] = plane == 0 ? (int)DCT_DCT : compute_tx_type(plane, txSz, t.x4, t.y4);
    if (plane == 0 && searchTypes && get_tx_set(txSz) > 0) {
      types[ntypes++] = ADST_ADST;
      int implied = Mode_To_Txfm[use_filter_intra ? (int)Filter_Intra_Mode_To_Intra_Dir[filter_intra_mode] : YMode];
      if (implied != DCT_DCT && implied != ADST_ADST) types[ntypes++] = implied;
      types[ntypes++] = IDTX;
    }
    static thread_local int32_t lev[1024];
    int64_t best = INT64_MAX, bestR = 0, distZero = 0;
    t.eob = -1;
    for (int ti = 0; ti <= ntypes; ti++) {
      int type = ti < ntypes ? types[ti] : types[0], eob = 0;
      int64_t D;
      if (ti < ntypes) {
        int64_t dz;
        eob = quantize(plane, resid, txSz, type, lev, &D, &dz);
        if (ti == 0) distZero = dz;
        if (eob == 0) {  // where the DCT leaves nothing, so do the others
          if (ti == 0) ti = ntypes - 1;
          continue;
        }
      } else {  // no coefficients
        D = distZero;
        for (int i = 0; i < tw * th; i++) lev[i] = 0;
      }
      TxBlock& c = txb.back();
      c.plane = plane;
      c.x4 = t.x4;
      c.y4 = t.y4;
      c.txSz = txSz;
      c.txType = type;
      c.eob = eob;
      memcpy(c.lev, lev, sizeof(int32_t) * tw * th);
      int64_t R = coeff_rate(c, est);
      int64_t J = (D << 18) + lambda * R;
      if (J < best) {
        best = J;
        bestR = R;
        t.txType = type;
        t.eob = eob;
        memcpy(t.lev, lev, sizeof(int32_t) * tw * th);
      }
    }
    if (!recon) return best;
    if (t.eob > 0) {
      PlaneTxType = t.txType;
      for (int i = 0; i < tw * th; i++) Quant[i] = t.lev[i];
      reconstruct(plane, startX, startY, txSz);
    }
    int64_t D = sse(plane, startX, startY, w, h);
    commit_coeffs(t);
    finish_tx_block(plane, startX, startY, txSz);
    *dist += D;
    *rate += bestR;
    return (D << 18) + lambda * bestR;
  }

  // the transform blocks of one plane of the block, in the decoder's order
  // (residual(): one chunk, as no block is larger than 64x64)
  template <class F>
  void for_each_tx(int plane, F&& f) {
    int txSz = get_tx_size(plane, TxSize);
    int stepX = Tx_Width(txSz) >> 2, stepY = Tx_Height(txSz) >> 2;
    int planeSz = get_plane_residual_size(MiSize, plane);
    int num4x4W = Num_4x4_Blocks_Wide[planeSz], num4x4H = Num_4x4_Blocks_High[planeSz];
    int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
    int baseX = (MiCol >> subX) * 4, baseY = (MiRow >> subY) * 4;
    for (int y = 0; y < std::min(num4x4H, 16 >> subY); y += stepY)
      for (int x = 0; x < std::min(num4x4W, 16 >> subX); x += stepX) {
        int startX = baseX + 4 * x, startY = baseY + 4 * y;
        if (!tx_block_on_screen(plane, startX, startY)) continue;
        f(startX, startY, x, y, txSz);
      }
  }

  // ---- blocks --------------------------------------------------------------

  void begin_block(int r, int c, int bSize) {
    set_block(r, c, bSize);
    segment_id = 0;
    Lossless = 0;
    is_inter = 0;
    skip = 0;
    TxSize = Max_Tx_Size_Rect[bSize];
  }
  void apply(const Modes& m) {
    YMode = m.y;
    AngleDeltaY = m.dy;
    UVMode = m.uv;
    AngleDeltaUV = m.duv;
    CflAlphaU = m.cflU;
    CflAlphaV = m.cflV;
    use_filter_intra = m.fi;
    filter_intra_mode = m.fiMode;
    PaletteSizeY = m.palY;
    PaletteSizeUV = m.palUV;
    if (PaletteSizeY) {
      memcpy(palette_colors_y, m.colY, sizeof m.colY);
      build_color_map(0);
    }
    if (PaletteSizeUV) {
      memcpy(palette_colors_u, m.colU, sizeof m.colU);
      memcpy(palette_colors_v, m.colV, sizeof m.colV);
      build_color_map(1);
    }
    TxSize = Max_Tx_Size_Rect[MiSize];
    for (int i = 0; i < m.txDepth; i++) TxSize = Split_Tx_Size[TxSize];
    set_inter_tx_size(MiRow, MiCol, Num_4x4_Blocks_High[MiSize], Num_4x4_Blocks_Wide[MiSize], TxSize);
  }

  // the coefficient contexts of the block's span, to code its blocks again
  struct CtxSpan {
    uint8_t a[3][2][16], l[3][2][16];
    int a0[3], an[3], l0[3], ln[3];
  };
  void save_ctx(CtxSpan& s) {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    for (int p = 0; p < seq.NumPlanes; p++) {
      int sx = p ? 1 : 0;
      s.a0[p] = MiCol >> sx;
      s.an[p] = ((MiCol + bw4 - 1) >> sx) - s.a0[p] + 1;
      s.l0[p] = MiRow >> sx;
      s.ln[p] = ((MiRow + bh4 - 1) >> sx) - s.l0[p] + 1;
      memcpy(s.a[p][0], &AboveLevelContext[p][s.a0[p]], s.an[p]);
      memcpy(s.a[p][1], &AboveDcContext[p][s.a0[p]], s.an[p]);
      memcpy(s.l[p][0], &LeftLevelContext[p][s.l0[p]], s.ln[p]);
      memcpy(s.l[p][1], &LeftDcContext[p][s.l0[p]], s.ln[p]);
    }
  }
  void restore_ctx(const CtxSpan& s) {
    for (int p = 0; p < seq.NumPlanes; p++) {
      memcpy(&AboveLevelContext[p][s.a0[p]], s.a[p][0], s.an[p]);
      memcpy(&AboveDcContext[p][s.a0[p]], s.a[p][1], s.an[p]);
      memcpy(&LeftLevelContext[p][s.l0[p]], s.l[p][0], s.ln[p]);
      memcpy(&LeftDcContext[p][s.l0[p]], s.l[p][1], s.ln[p]);
    }
  }

  // codes the block with modes m: reconstructs it and, given a writer,
  // writes its syntax with the adapted CDFs; returns its cost D * 2^18 +
  // lambda R, R from the CDFs as the superblock started
  int64_t code_block(int r, int cc, int bSize, const Modes& m, Writer* w = nullptr) {
    begin_block(r, cc, bSize);
    apply(m);
    store_mode_info();
    CtxSpan saved;
    save_ctx(saved);
    int64_t D = 0, Rc = 0;
    int n = 0;
    for (int plane = 0; plane < 1 + 2 * HasChroma; plane++)
      for_each_tx(plane, [&](int startX, int startY, int x, int y, int txSz) {
        code_tx(plane, startX, startY, x, y, txSz, w || Tx_Size_Sqr_Up[txSz] <= TX_8X8, txb[n++], &D, &Rc);
      });
    skip = 1;
    for (int i = 0; i < n; i++)
      if (txb[i].eob) skip = 0;
    store_mode_info();
    restore_ctx(saved);
    Counter k;
    code_mode_info(k, est);
    if (w) code_mode_info(*w, live);
    if (skip) {
      reset_block_context(Num_4x4_Blocks_Wide[bSize], Num_4x4_Blocks_High[bSize]);
      return (D << 18) + lambda * k.bits;
    }
    for (int i = 0; i < n; i++) {
      if (w) write_coeffs(*w, live, txb[i]);
      else commit_coeffs(txb[i]);
    }
    return (D << 18) + lambda * (k.bits + Rc);
  }

  // the luma modes' search: the 13 modes (and the best directional one's
  // angle deltas, filter intra) ranked by SATD, then rate-distortion tests
  // of the first SEARCH_LUMA, the exact palette and smaller transforms;
  // leaves the best's luma reconstructed
  void search_luma(Modes& best) {
    int w = Block_Width(MiSize), h = Block_Height(MiSize);
    int x0 = MiCol * 4, y0 = MiRow * 4;
    struct Cand {
      int64_t cost;
      Modes m;
    };
    std::vector<Cand> cands;
    auto try_satd = [&](const Modes& m) {
      apply(m);
      for_each_tx(0, [&](int startX, int startY, int x, int y, int txSz) {
        predict_tx_intra(0, startX, startY, x, y, txSz);
      });
      int64_t cost = (satd(0, x0, y0, w, h) << 18) + lambdaSad * luma_mode_rate(est);
      cands.push_back({cost, m});
    };
    for (int mode = DC_PRED; mode <= PAETH_PRED; mode++) {
      Modes m;
      m.y = mode;
      try_satd(m);
    }
    // the angle deltas of the best directional mode where it ranks in the
    // first three, filter intra where DC_PRED or a smooth mode does
    std::vector<Cand> ranked = cands;
    std::stable_sort(ranked.begin(), ranked.end(), [](const Cand& a, const Cand& b) { return a.cost < b.cost; });
    int bestDir = -1;
    bool smooth = false;
    for (int i = 0; i < 3; i++) {
      if (bestDir < 0 && is_directional_mode(ranked[i].m.y)) bestDir = ranked[i].m.y;
      smooth |= ranked[i].m.y == DC_PRED || (ranked[i].m.y >= SMOOTH_PRED && ranked[i].m.y <= SMOOTH_H_PRED);
    }
    if (MiSize >= BLOCK_8X8 && bestDir >= 0) {
      for (int d = -3; d <= 3; d++) {
        if (d == 0) continue;
        Modes m;
        m.y = bestDir;
        m.dy = d;
        try_satd(m);
      }
    }
    if (seq.enable_filter_intra && std::max(w, h) <= 32 && smooth)
      for (int fm = 0; fm < 5; fm++) {
        Modes m;
        m.fi = 1;
        m.fiMode = fm;
        try_satd(m);
      }
    std::stable_sort(cands.begin(), cands.end(), [](const Cand& a, const Cand& b) { return a.cost < b.cost; });
    // full tests: the SEARCH_LUMA best at the largest transform and the
    // exact palette; then, where the best leaves a residual, DC_PRED at
    // each smaller transform
    std::vector<Modes> tests;
    for (int i = 0; i < std::min<int>(SEARCH_LUMA, cands.size()); i++) tests.push_back(cands[i].m);
    if (palette_allowed()) {
      Modes m;
      m.palY = exact_palette(0, m.colY, nullptr);
      if (m.palY) tests.push_back(m);
    }
    int64_t bestJ = INT64_MAX;
    int bestI = 0;
    bool residual = false;
    for (size_t i = 0; i < tests.size(); i++) {
      int64_t J = luma_rd(tests[i], false);
      if (J < bestJ) {
        bestJ = J;
        bestI = i;
        residual = lumaResidual;
      }
    }
    for (int d = 1; d <= max_tx_depth() && residual; d++) {
      Modes m;
      m.txDepth = d;
      tests.push_back(m);
      int64_t J = luma_rd(m, false);
      if (J < bestJ) {
        bestJ = J;
        bestI = tests.size() - 1;
        residual = lumaResidual;
      }
    }
    best = tests[bestI];
    luma_rd(best, true);
  }

  // the luma of the block with modes m, reconstructed, and its cost; the
  // contexts and decoded flags are left as the block found them
  // (a lone transform of up to 32x32 is costed without its reconstruction,
  // its distortion as the transform's norms estimate it, unless ``exact``)
  int64_t luma_rd(const Modes& m, bool exact) {
    reset_block_state();
    apply(m);
    int64_t D = 0, R = 0, J = lambda * luma_mode_rate(est);
    int n = 0;
    bool lone = TxSize == Max_Tx_Size_Rect[MiSize] && Tx_Width(TxSize) <= 32 && Tx_Height(TxSize) <= 32;
    lumaResidual = false;
    for_each_tx(0, [&](int startX, int startY, int x, int y, int txSz) {
      J += code_tx(0, startX, startY, x, y, txSz, false, txb[n], &D, &R, exact || !lone);
      lumaResidual |= txb[n++].eob > 0;
    });
    reset_block_state();
    return J;
  }
  CtxSpan blockCtx;
  uint8_t blockBD[3][34][34];
  bool lumaResidual = false;  // whether luma_rd's luma left coefficients
  struct ModeCache {
    int64_t sb = -1;  // the superblock it was found in
    Modes m;
  };
  std::vector<ModeCache> modeCache = std::vector<ModeCache>(BLOCK_SIZES * 32 * 32);
  int64_t sbCount = 0;
  void reset_block_state() {
    restore_ctx(blockCtx);
    memcpy(BlockDecoded, blockBD, sizeof BlockDecoded);
  }

  // the cheapest of the first ``count`` chroma candidates, each chroma
  // transform costed without its reconstruction
  template <class Cand>
  Modes chroma_rd(const std::vector<Cand>& cands, int count) {
    int64_t bestJ = INT64_MAX;
    int nTry = std::min<int>(count, cands.size()), bestI = 0;
    for (int i = 0; i < nTry; i++) {
      apply(cands[i].m);
      int64_t J = lambda * chroma_mode_rate(est), D = 0, R = 0;
      for (int p = 1; p <= 2; p++)
        for_each_tx(p, [&](int startX, int startY, int x, int y, int txSz) {
          J += code_tx(p, startX, startY, x, y, txSz, false, txb[0], &D, &R, false);
        });
      if (J < bestJ) {
        bestJ = J;
        bestI = i;
      }
    }
    return cands[bestI].m;
  }

  // CfL's alphas for the current luma: the least-squares fit of each
  // chroma plane's residual from DC on the luma's AC, in 1/8
  void cfl_alphas(int* au, int* av) {
    int txSz = get_tx_size(1, TxSize);
    int w = Tx_Width(txSz), h = Tx_Height(txSz);
    int x0 = (MiCol >> 1) * 4, y0 = (MiRow >> 1) * 4;
    int alphas[2];
    UVMode = DC_PRED;
    for (int p = 1; p <= 2; p++) {
      predict_tx_intra(p, x0, y0, 0, 0, txSz);
      int64_t lsum = 0;
      static thread_local int L[64 * 64];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int lumaY = std::min(i, ((MaxLumaH - (y0 << 1)) >> 1) - 1);
          int lumaX = std::min(j, ((MaxLumaW - (x0 << 1)) >> 1) - 1);
          int ly = (y0 + lumaY) << 1, lx = (x0 + lumaX) << 1;
          int t = *planes[0].at(ly, lx) + *planes[0].at(ly, lx + 1) + *planes[0].at(ly + 1, lx) +
                  *planes[0].at(ly + 1, lx + 1);
          L[i * w + j] = t << 1;
          lsum += t << 1;
        }
      int avg = Round2((int)lsum, Tx_Width_Log2[txSz] + Tx_Height_Log2[txSz]);
      int64_t num = 0, den = 0;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int ac = L[i * w + j] - avg;
          int e = *src[p].at(y0 + i, x0 + j) - *planes[p].at(y0 + i, x0 + j);
          num += (int64_t)ac * e;
          den += (int64_t)ac * ac;
        }
      int a = 0;
      if (den > 0) {
        int64_t q = (std::llabs(num) * 64 * 2 + den) / (2 * den);  // |alpha| in 1/8, rounded
        a = (int)std::min<int64_t>(q, 16);
        if (num < 0) a = -a;
      }
      alphas[p - 1] = a;
    }
    if (alphas[0] == 0 && alphas[1] == 0) alphas[0] = 1;
    *au = alphas[0];
    *av = alphas[1];
  }

  // the chroma modes' search, given the luma's reconstruction
  void search_chroma(Modes& best) {
    int cw = Block_Width(get_plane_residual_size(MiSize, 1)), ch = Block_Height(get_plane_residual_size(MiSize, 1));
    int x0 = (MiCol >> 1) * 4, y0 = (MiRow >> 1) * 4;
    struct Cand {
      int64_t cost;
      Modes m;
    };
    std::vector<Cand> cands;
    auto predict_uv = [&]() {
      for (int p = 1; p <= 2; p++)
        for_each_tx(p, [&](int startX, int startY, int x, int y, int txSz) {
          predict_tx_intra(p, startX, startY, x, y, txSz);
        });
    };
    // DC, V, H, the smooth modes, Paeth, CfL, and the luma's mode
    int modes[16], nModes = 0;
    for (int mode : {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED})
      modes[nModes++] = mode;
    if (is_directional_mode(best.y) && best.y != V_PRED && best.y != H_PRED) modes[nModes++] = best.y;
    if (cfl_allowed()) modes[nModes++] = UV_CFL_PRED;
    for (int i = 0; i < nModes; i++) {
      int mode = modes[i];
      Modes m = best;
      m.uv = mode;
      m.duv = 0;
      m.cflU = m.cflV = 0;
      if (mode == UV_CFL_PRED) cfl_alphas(&m.cflU, &m.cflV);
      apply(m);
      predict_uv();
      int64_t cost = ((satd(1, x0, y0, cw, ch) + satd(2, x0, y0, cw, ch)) << 18) +
                     lambdaSad * chroma_mode_rate(est);
      cands.push_back({cost, m});
    }
    if (palette_allowed()) {
      Modes m = best;
      m.uv = DC_PRED;
      m.duv = m.cflU = m.cflV = 0;
      m.palUV = exact_palette(1, m.colU, m.colV);
      if (m.palUV) {
        apply(m);
        predict_uv();
        int64_t cost = ((satd(1, x0, y0, cw, ch) + satd(2, x0, y0, cw, ch)) << 18) +
                       lambdaSad * chroma_mode_rate(est);
        cands.push_back({cost, m});
      }
    }
    std::stable_sort(cands.begin(), cands.end(), [](const Cand& a, const Cand& b) { return a.cost < b.cost; });
    best = chroma_rd(cands, SEARCH_CHROMA);
  }

  // a block's search: its modes, then its cost with the transform types
  // searched too (the block is left reconstructed and its contexts set)
  // (a block searched before in this superblock, the quarter of a shallow
  // split searched again in depth, keeps the modes it found then)
  int64_t search_block(int r, int c, int bSize, Modes& m) {
    begin_block(r, c, bSize);
    ModeCache& cached = modeCache[((size_t)bSize * 32 + (r & 31)) * 32 + (c & 31)];
    if (cached.sb == sbCount) {
      m = cached.m;
    } else {
      save_ctx(blockCtx);
      memcpy(blockBD, BlockDecoded, sizeof BlockDecoded);
      m = Modes();
      search_luma(m);
      if (HasChroma) search_chroma(m);
      reset_block_state();
      cached.sb = sbCount;
      cached.m = m;
    }
    return code_block(r, c, bSize, m);
  }

  // ---- partitions ----------------------------------------------------------

  // what the coding of a block region changes, to try another partition
  struct Snapshot {
    int r, c, bSize;
    std::vector<uint16_t> px[3];
    std::vector<ModeInfo> mis;
    std::vector<uint8_t> ctx[3][4];
    uint8_t bd[3][34][34];
  };
  void region(int plane, int r, int c, int bSize, int* x0, int* y0, int* w, int* h) {
    int bw = Block_Width(bSize), bh = Block_Height(bSize);
    int lx0 = (c * 4) & ~7, ly0 = (r * 4) & ~7, lx1 = (c * 4 + bw + 7) & ~7, ly1 = (r * 4 + bh + 7) & ~7;
    int s = plane ? 1 : 0;
    *x0 = lx0 >> s;
    *y0 = ly0 >> s;
    *w = (lx1 - lx0) >> s;
    *h = (ly1 - ly0) >> s;
  }
  void save(Snapshot& s, int r, int c, int bSize) {
    s.r = r;
    s.c = c;
    s.bSize = bSize;
    for (int p = 0; p < seq.NumPlanes; p++) {
      int x0, y0, w, h;
      region(p, r, c, bSize, &x0, &y0, &w, &h);
      s.px[p].resize((size_t)w * h);
      for (int i = 0; i < h; i++) std::copy_n(planes[p].at(y0 + i, x0), w, &s.px[p][(size_t)i * w]);
      int ax0 = (c >> (p ? 1 : 0)), lx0 = (r >> (p ? 1 : 0));
      int n = std::max(Num_4x4_Blocks_Wide[bSize], Num_4x4_Blocks_High[bSize]) + 2;
      s.ctx[p][0].assign(&AboveLevelContext[p][ax0], &AboveLevelContext[p][ax0] + n);
      s.ctx[p][1].assign(&AboveDcContext[p][ax0], &AboveDcContext[p][ax0] + n);
      s.ctx[p][2].assign(&LeftLevelContext[p][lx0], &LeftLevelContext[p][lx0] + n);
      s.ctx[p][3].assign(&LeftDcContext[p][lx0], &LeftDcContext[p][lx0] + n);
    }
    int bw4 = Num_4x4_Blocks_Wide[bSize], bh4 = Num_4x4_Blocks_High[bSize];
    s.mis.resize((size_t)bw4 * bh4);
    for (int y = 0; y < bh4; y++)
      for (int x = 0; x < bw4; x++) s.mis[(size_t)y * bw4 + x] = M(r + y, c + x);
    memcpy(s.bd, BlockDecoded, sizeof BlockDecoded);
  }
  void restore(const Snapshot& s) {
    int r = s.r, c = s.c, bSize = s.bSize;
    for (int p = 0; p < seq.NumPlanes; p++) {
      int x0, y0, w, h;
      region(p, r, c, bSize, &x0, &y0, &w, &h);
      for (int i = 0; i < h; i++) std::copy_n(&s.px[p][(size_t)i * w], w, planes[p].at(y0 + i, x0));
      int ax0 = (c >> (p ? 1 : 0)), lx0 = (r >> (p ? 1 : 0));
      std::copy(s.ctx[p][0].begin(), s.ctx[p][0].end(), &AboveLevelContext[p][ax0]);
      std::copy(s.ctx[p][1].begin(), s.ctx[p][1].end(), &AboveDcContext[p][ax0]);
      std::copy(s.ctx[p][2].begin(), s.ctx[p][2].end(), &LeftLevelContext[p][lx0]);
      std::copy(s.ctx[p][3].begin(), s.ctx[p][3].end(), &LeftDcContext[p][lx0]);
    }
    int bw4 = Num_4x4_Blocks_Wide[bSize], bh4 = Num_4x4_Blocks_High[bSize];
    for (int y = 0; y < bh4; y++)
      for (int x = 0; x < bw4; x++) M(r + y, c + x) = s.mis[(size_t)y * bw4 + x];
    memcpy(BlockDecoded, s.bd, sizeof BlockDecoded);
  }

  int64_t partition_rate(int r, int c, int bSize, int partition) {
    Counter k;
    code_partition(k, est, r, c, bSize, partition);
    return k.bits;
  }

  // the search of a partition node: leaves its best reconstructed. A split
  // is first tried shallow (its quarters unsplit); only where that beats
  // the node's best so far are the quarters searched in depth
  int64_t search_partition(int r, int c, int bSize, Node& node, bool deep = true) {
    if (r >= MiRows || c >= MiCols) return 0;
    int num4x4 = Num_4x4_Blocks_Wide[bSize], half = num4x4 >> 1;
    bool hasRows = (r + half) < MiRows, hasCols = (c + half) < MiCols;
    int wl = Mi_Width_Log2[bSize], hl = Mi_Height_Log2[bSize];
    int cands[4], n = 0;
    if (bSize == BLOCK_4X4) {
      cands[n++] = PARTITION_NONE;
    } else if (bSize == BLOCK_128X128) {  // its blocks are 64x64 at most
      cands[n++] = PARTITION_SPLIT;
    } else if (hasRows && hasCols) {
      cands[n++] = PARTITION_NONE;
      if (bSize != BLOCK_64X64 && deep) {
        cands[n++] = PARTITION_HORZ;
        cands[n++] = PARTITION_VERT;
      }
      if (deep) cands[n++] = PARTITION_SPLIT;
    } else if (hasCols) {
      cands[n++] = PARTITION_HORZ;
      if (deep) cands[n++] = PARTITION_SPLIT;
    } else if (hasRows) {
      cands[n++] = PARTITION_VERT;
      if (deep) cands[n++] = PARTITION_SPLIT;
    } else {
      cands[n++] = PARTITION_SPLIT;
    }
    Snapshot start, bestState;
    if (n > 1) save(start, r, c, bSize);
    int64_t best = INT64_MAX;
    Node trial;
    bool holdsBest = true;
    for (int i = 0; i < n; i++) {
      int p = cands[i];
      if (i > 0) restore(start);
      trial.partition = p;
      int64_t J = lambda * partition_rate(r, c, bSize, p);
      if (p == PARTITION_NONE) {
        J += search_block(r, c, bSize, trial.modes[0]);
      } else if (p == PARTITION_HORZ) {
        int sub = BlockOf[wl][hl - 1];
        J += search_block(r, c, sub, trial.modes[0]);
        if (hasRows && J < best) J += search_block(r + half, c, sub, trial.modes[1]);
      } else if (p == PARTITION_VERT) {
        int sub = BlockOf[wl - 1][hl];
        J += search_block(r, c, sub, trial.modes[0]);
        if (hasCols && J < best) J += search_block(r, c + half, sub, trial.modes[1]);
      } else {
        int sub = BlockOf[wl - 1][hl - 1];
        bool onlySplit = n == 1;
        int64_t J0 = J;
        for (int pass = (deep && !onlySplit) ? 0 : 1; pass < 2; pass++) {
          if (pass == 1 && deep && !onlySplit) {  // the shallow split won: search it in depth
            if (J >= best) break;
            restore(start);
            J = J0;
          }
          bool deeper = onlySplit ? deep : (pass == 1 && deep);
          for (int k = 0; k < 4 && J < best; k++) {
            trial.sub[k].reset(new Node());
            J += search_partition(r + (k >> 1) * half, c + (k & 1) * half, sub, *trial.sub[k], deeper);
          }
        }
      }
      // a block that needs no residual is not split
      bool settled = p == PARTITION_NONE && skip && n > 1;
      if (J < best) {
        best = J;
        node.partition = p;
        for (int k = 0; k < 4; k++) {
          node.modes[k] = trial.modes[k];
          node.sub[k] = std::move(trial.sub[k]);
        }
        holdsBest = true;
        if (i < n - 1) save(bestState, r, c, bSize);
      } else {
        holdsBest = false;
      }
      if (settled) break;
    }
    if (!holdsBest) restore(bestState);
    return best;
  }

  // the coding of the decided tree, writing its symbols
  void encode_partition(int r, int c, int bSize, const Node& node) {
    if (r >= MiRows || c >= MiCols) return;
    Writer w{sw};
    int num4x4 = Num_4x4_Blocks_Wide[bSize], half = num4x4 >> 1;
    bool hasRows = (r + half) < MiRows, hasCols = (c + half) < MiCols;
    int wl = Mi_Width_Log2[bSize], hl = Mi_Height_Log2[bSize];
    code_partition(w, live, r, c, bSize, node.partition);
    switch (node.partition) {
      case PARTITION_NONE: code_block(r, c, bSize, node.modes[0], &w); break;
      case PARTITION_HORZ: {
        int sub = BlockOf[wl][hl - 1];
        code_block(r, c, sub, node.modes[0], &w);
        if (hasRows) code_block(r + half, c, sub, node.modes[1], &w);
        break;
      }
      case PARTITION_VERT: {
        int sub = BlockOf[wl - 1][hl];
        code_block(r, c, sub, node.modes[0], &w);
        if (hasCols) code_block(r, c + half, sub, node.modes[1], &w);
        break;
      }
      default: {
        int sub = BlockOf[wl - 1][hl - 1];
        for (int k = 0; k < 4; k++) encode_partition(r + (k >> 1) * half, c + (k & 1) * half, sub, *node.sub[k]);
      }
    }
  }

  // ---- the frame -----------------------------------------------------------

  std::vector<uint8_t> encode_tile() {
    live.init(base_q_idx);
    sw.init();
    clear_above_context();
    int sbSize = seq.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
    int sbSize4 = Num_4x4_Blocks_Wide[sbSize];
    for (int r = MiRowStart; r < MiRowEnd; r += sbSize4) {
      clear_left_context();
      for (int c = MiColStart; c < MiColEnd; c += sbSize4) {
        copy_cdf(est, live);
        sbCount++;
        clear_block_decoded_flags(r, c, sbSize4);
        Snapshot sb;
        save(sb, r, c, sbSize);
        Node root;
        search_partition(r, c, sbSize, root);
        restore(sb);
        clear_block_decoded_flags(r, c, sbSize4);
        encode_partition(r, c, sbSize, root);
      }
    }
    return sw.done();
  }

  void sequence_header(BitWriter& b) {
    int wbits = std::max(1, FloorLog2(std::max(FrameWidth - 1, 1)) + 1);
    int hbits = std::max(1, FloorLog2(std::max(FrameHeight - 1, 1)) + 1);
    b.f(0, 3);  // seq_profile
    b.f(1, 1);  // still_picture
    b.f(1, 1);  // reduced_still_picture_header
    b.f(seq_level(), 5);
    b.f(wbits - 1, 4);
    b.f(hbits - 1, 4);
    b.f(FrameWidth - 1, wbits);
    b.f(FrameHeight - 1, hbits);
    b.f(std::min(FrameWidth, FrameHeight) > 480, 1);  // use_128x128_superblock
    b.f(1, 1);                                       // enable_filter_intra
    b.f(1, 1);  // enable_intra_edge_filter
    b.f(0, 3);  // enable_superres, enable_cdef, enable_restoration
    b.f(0, 1);  // high_bitdepth
    b.f(seq.mono_chrome, 1);
    b.f(0, 1);  // color_description_present_flag
    b.f(1, 1);  // color_range: full
    if (!seq.mono_chrome) {
      b.f(0, 2);  // chroma_sample_position
      b.f(0, 1);  // separate_uv_delta_q
    }
    b.f(0, 1);  // film_grain_params_present
    b.trailing_bits();
  }

  // the level of Annex A whose picture size and dimensions hold the frame
  int seq_level() const {
    struct Level {
      int idx;
      int64_t pic;
      int w, h;
    };
    static const Level levels[] = {{0, 147456, 2048, 1152},    {1, 278784, 2816, 1584},
                                   {4, 665856, 4352, 2448},    {5, 1065024, 5504, 3096},
                                   {8, 2359296, 6144, 3456},   {12, 8912896, 8192, 4352},
                                   {16, 35651584, 16384, 8704}};
    for (const Level& l : levels)
      if ((int64_t)FrameWidth * FrameHeight <= l.pic && FrameWidth <= l.w && FrameHeight <= l.h) return l.idx;
    return 31;
  }

  void frame_header(BitWriter& b) {
    b.f(0, 1);  // disable_cdf_update
    b.f(allow_screen_content_tools, 1);
    if (allow_screen_content_tools) b.f(0, 1);  // force_integer_mv
    b.f(0, 1);                                  // render_and_frame_size_different
    if (allow_screen_content_tools) b.f(0, 1);  // allow_intrabc
    // tile_info: uniform spacing
    TileLimits t = tile_limits();
    b.f(1, 1);
    for (int i = t.minLog2TileCols; i < t.maxLog2TileCols; i++) {
      b.f(i < TileColsLog2, 1);
      if (i >= TileColsLog2) break;
    }
    for (int i = std::max(t.minLog2Tiles - TileColsLog2, 0); i < t.maxLog2TileRows; i++) {
      b.f(i < TileRowsLog2, 1);
      if (i >= TileRowsLog2) break;
    }
    if (TileColsLog2 > 0 || TileRowsLog2 > 0) {
      b.f(0, TileRowsLog2 + TileColsLog2);  // context_update_tile_id
      b.f(3, 2);                            // tile_size_bytes_minus_1
    }
    // quantization_params
    b.f(base_q_idx, 8);
    b.f(0, 1);  // DeltaQYDc
    if (seq.NumPlanes > 1) b.f(0, 2);  // DeltaQUDc, DeltaQUAc
    b.f(0, 1);  // using_qmatrix
    b.f(0, 1);  // segmentation_enabled
    b.f(0, 1);  // delta_q_present
    // loop_filter_params
    b.f(loop_filter_level[0], 6);
    b.f(loop_filter_level[1], 6);
    if (seq.NumPlanes > 1 && (loop_filter_level[0] || loop_filter_level[1])) {
      b.f(loop_filter_level[2], 6);
      b.f(loop_filter_level[3], 6);
    }
    b.f(loop_filter_sharpness, 3);
    b.f(loop_filter_delta_enabled, 1);
    if (loop_filter_delta_enabled) b.f(0, 1);  // loop_filter_delta_update
    b.f(1, 1);                                 // tx_mode_select
    b.f(reduced_tx_set, 1);
  }

  // aom's screen content decision (av1_set_screen_content_options): enough
  // 16x16 blocks of 2 to 4 luma values, a tenth of the frame; for an alpha
  // plane a hundredth (the edge of a mask, which a palette codes exactly)
  bool screen_content() {
    int64_t counts = 0;
    for (int r = 0; r + 16 <= visH[0]; r += 16)
      for (int c = 0; c + 16 <= visW[0]; c += 16) {
        bool seen[256] = {false};
        int n = 0;
        for (int i = 0; i < 16 && n <= 4; i++)
          for (int j = 0; j < 16; j++) {
            int v = *src[0].at(r + i, c + j);
            if (!seen[v]) {
              seen[v] = true;
              n++;
            }
          }
        if (n > 1 && n <= 4) counts++;
      }
    return counts * 16 * 16 * (seq.mono_chrome ? 100 : 10) > (int64_t)FrameWidth * FrameHeight;
  }

  std::vector<uint8_t> encode() {
    allow_screen_content_tools = screen_content();
    std::vector<std::vector<uint8_t>> tiles;
    for (int tr = 0; tr < TileRows; tr++)
      for (int tc = 0; tc < TileCols; tc++) {
        set_tile(tr, tc);
        tiles.push_back(encode_tile());
      }
    loop_filter();
    std::vector<uint8_t> out = {0x12, 0x00};  // temporal delimiter
    BitWriter sh;
    sequence_header(sh);
    out.push_back(0x0a);
    leb128(out, sh.buf.size());
    out.insert(out.end(), sh.buf.begin(), sh.buf.end());
    BitWriter fh;
    frame_header(fh);
    fh.byte_alignment();
    if (tiles.size() > 1) {
      fh.f(0, 1);  // tile_start_and_end_present_flag
      fh.byte_alignment();
    }
    std::vector<uint8_t> payload = fh.buf;
    for (size_t i = 0; i < tiles.size(); i++) {
      if (i + 1 < tiles.size()) {
        uint32_t n = tiles[i].size() - 1;
        for (int k = 0; k < 4; k++) payload.push_back((n >> (8 * k)) & 0xff);
      }
      payload.insert(payload.end(), tiles[i].begin(), tiles[i].end());
    }
    out.push_back(0x32);  // OBU_FRAME with its size
    leb128(out, payload.size());
    out.insert(out.end(), payload.begin(), payload.end());
    return out;
  }
};

}  // namespace

extern "C" {

int sl_av1_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height, int monochrome,
                  int base_q_idx, uint8_t* recon_y, uint8_t* recon_u, uint8_t* recon_v, uint8_t** out,
                  size_t* out_size, char* err, int errlen) {
  try {
    if (width < 1 || height < 1 || width > 65536 || height > 65536)
      fail(SL_UNSUPPORTED, "AV1 frame of %dx%d", width, height);
    if (base_q_idx < 1 || base_q_idx > 255) fail(SL_UNSUPPORTED, "AV1 base_q_idx %d", base_q_idx);
    std::unique_ptr<Encoder> e(new Encoder());
    e->init(width, height, monochrome != 0, base_q_idx);
    int cw = (width + 1) >> 1, ch = (height + 1) >> 1;
    e->set_source(0, y, width, height);
    if (!monochrome) {
      e->set_source(1, u, cw, ch);
      e->set_source(2, v, cw, ch);
    }
    std::vector<uint8_t> obus = e->encode();
    uint8_t* buf = (uint8_t*)malloc(obus.size());
    if (!buf) fail(SL_NO_ROOM, "out of memory");
    memcpy(buf, obus.data(), obus.size());
    *out = buf;
    *out_size = obus.size();
    if (recon_y)
      for (int r = 0; r < height; r++) std::copy_n(e->planes[0].at(r, 0), width, recon_y + (size_t)r * width);
    if (!monochrome && recon_u && recon_v)
      for (int r = 0; r < ch; r++) {
        std::copy_n(e->planes[1].at(r, 0), cw, recon_u + (size_t)r * cw);
        std::copy_n(e->planes[2].at(r, 0), cw, recon_v + (size_t)r * cw);
      }
    return SL_OK;
  } catch (const Fail& f) {
    snprintf(err, errlen, "%s", f.msg.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "out of memory");
    return SL_NO_ROOM;
  }
}

void sl_av1_enc_free(uint8_t* p) { free(p); }

void sl_av1_rgb_to_yuv420(const uint8_t* rgb, int width, int height, int channels, uint8_t* y, uint8_t* u,
                          uint8_t* v) {
  const float kr = 0.299f, kb = 0.114f, kg = 1.0f - kr - kb;
  auto unorm = [](float x) {
    float r = floorf(x + 0.5f);
    return (uint8_t)(r < 0.0f ? 0 : (r > 255.0f ? 255 : (int)r));
  };
  int cw = (width + 1) >> 1;
  for (int by = 0; by < height; by += 2)
    for (int bx = 0; bx < width; bx += 2) {
      float su = 0.0f, sv = 0.0f;
      int count = 0;
      for (int j = by; j < std::min(by + 2, height); j++)
        for (int i = bx; i < std::min(bx + 2, width); i++) {
          const uint8_t* p = rgb + ((size_t)j * width + i) * channels;
          float r = p[0] / 255.0f, g = p[1] / 255.0f, b = p[2] / 255.0f;
          float Y = kr * r + kg * g + kb * b;
          y[(size_t)j * width + i] = unorm(Y * 255.0f);
          su += (b - Y) / (2.0f * (1.0f - kb));
          sv += (r - Y) / (2.0f * (1.0f - kr));
          count++;
        }
      u[(size_t)(by >> 1) * cw + (bx >> 1)] = unorm(su / count * 255.0f + 128.0f);
      v[(size_t)(by >> 1) * cw + (bx >> 1)] = unorm(sv / count * 255.0f + 128.0f);
    }
}

int sl_av1_write_symbols(const int32_t* symbols, const int32_t* sizes, const int32_t* offsets, int count,
                         uint16_t* cdfs, uint8_t* out, int room) {
  SymbolWriter w;
  w.init();
  for (int i = 0; i < count; i++) {
    if (sizes[i] == 0) w.literal(8, symbols[i]);
    else w.symbol(cdfs + offsets[i], sizes[i], symbols[i]);
  }
  std::vector<uint8_t> bytes = w.done();
  if ((int)bytes.size() > room) return -1;
  memcpy(out, bytes.data(), bytes.size());
  return (int)bytes.size();
}

}  // extern "C"
