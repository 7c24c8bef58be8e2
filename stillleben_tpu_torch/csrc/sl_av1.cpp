// The port's AV1 intra decoder and libavif's RGB conversion (sl_av1.h).
//
// The decoding follows the AV1 Bitstream & Decoding Process Specification
// section by section: the OBU and header syntax (5.3-5.9), the tile and
// block syntax (5.11), the symbol decoder (8.2), the intra prediction and
// reconstruction processes (7.11.2, 7.12, 7.13), the loop filter (7.14),
// CDEF (7.15), loop restoration (7.17) and the film grain synthesis
// (7.18.3; all in sl_av1_post.h).
// The names of variables and functions are the specification's where it
// has one.


#include <memory>

#include "sl_av1_post.h"

namespace {

using namespace sl_av1;

// ---------------------------------------------------------------------------
// bit reader (f(n), su, ns, le, leb128, uvlc)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // in bits
  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}
  int bit() {
    if ((pos >> 3) >= size) fail(SL_TRUNCATED, "AV1 header ends early");
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = (x << 1) | bit();
    return x;
  }
  int su(int n) {
    int v = f(n);
    int signMask = 1 << (n - 1);
    if (v & signMask) v -= 2 * signMask;
    return v;
  }
  uint32_t ns(uint32_t n) {
    int w = FloorLog2(n) + 1;
    uint32_t m = (1u << w) - n;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!bit()) {
      if (++lz >= 32) fail(SL_CORRUPT, "AV1 uvlc too long");
    }
    return lz ? (uint32_t)((1ull << lz) - 1 + f(lz)) : 0;
  }
  void byte_alignment() {
    while (pos & 7) bit();
  }
};

uint64_t leb128(const uint8_t* d, size_t n, size_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    if (*p >= n) fail(SL_TRUNCATED, "AV1 OBU size ends early");
    uint8_t b = d[(*p)++];
    v |= (uint64_t)(b & 0x7f) << (i * 7);
    if (!(b & 0x80)) break;
  }
  return v;
}

// ``color_range_bit``: where color_range lies in the reader's bits, -1 where
// the header does not code it
void parse_sequence_header(BitReader& b, SequenceHeader& s, int64_t* color_range_bit) {
  s.seq_profile = b.f(3);
  s.still_picture = b.f(1);
  s.reduced_still_picture_header = b.f(1);
  if (s.reduced_still_picture_header) {
    b.f(5);  // seq_level_idx[0]
  } else {
    s.timing_info_present_flag = b.f(1);
    int buffer_delay_length_minus_1 = 0;
    if (s.timing_info_present_flag) {
      b.f(32);
      b.f(32);
      s.equal_picture_interval = b.f(1);
      if (s.equal_picture_interval) b.uvlc();
      s.decoder_model_info_present_flag = b.f(1);
      if (s.decoder_model_info_present_flag) {
        buffer_delay_length_minus_1 = b.f(5);
        b.f(32);
        s.buffer_removal_time_length_minus_1 = b.f(5);
        s.frame_presentation_time_length_minus_1 = b.f(5);
      }
    }
    int initial_display_delay_present_flag = b.f(1);
    s.operating_points_cnt_minus_1 = b.f(5);
    for (int i = 0; i <= s.operating_points_cnt_minus_1; i++) {
      s.operating_point_idc[i] = b.f(12);
      int seq_level_idx = b.f(5);
      if (seq_level_idx > 7) b.f(1);
      if (s.decoder_model_info_present_flag) {
        s.decoder_model_present_for_this_op[i] = b.f(1);
        if (s.decoder_model_present_for_this_op[i]) {
          int n = buffer_delay_length_minus_1 + 1;
          b.f(n);
          b.f(n);
          b.f(1);
        }
      }
      if (initial_display_delay_present_flag)
        if (b.f(1)) b.f(4);
    }
  }
  s.frame_width_bits_minus_1 = b.f(4);
  s.frame_height_bits_minus_1 = b.f(4);
  s.max_frame_width_minus_1 = b.f(s.frame_width_bits_minus_1 + 1);
  s.max_frame_height_minus_1 = b.f(s.frame_height_bits_minus_1 + 1);
  if (!s.reduced_still_picture_header) s.frame_id_numbers_present_flag = b.f(1);
  if (s.frame_id_numbers_present_flag) {
    s.delta_frame_id_length_minus_2 = b.f(4);
    s.additional_frame_id_length_minus_1 = b.f(3);
  }
  s.use_128x128_superblock = b.f(1);
  s.enable_filter_intra = b.f(1);
  s.enable_intra_edge_filter = b.f(1);
  if (!s.reduced_still_picture_header) {
    b.f(1);  // enable_interintra_compound
    b.f(1);  // enable_masked_compound
    b.f(1);  // enable_warped_motion
    b.f(1);  // enable_dual_filter
    s.enable_order_hint = b.f(1);
    if (s.enable_order_hint) {
      b.f(1);  // enable_jnt_comp
      b.f(1);  // enable_ref_frame_mvs
    }
    int seq_choose_screen_content_tools = b.f(1);
    s.seq_force_screen_content_tools = seq_choose_screen_content_tools ? 2 : b.f(1);
    if (s.seq_force_screen_content_tools > 0) {
      int seq_choose_integer_mv = b.f(1);
      s.seq_force_integer_mv = seq_choose_integer_mv ? 2 : b.f(1);
    } else {
      s.seq_force_integer_mv = 2;
    }
    if (s.enable_order_hint) s.OrderHintBits = b.f(3) + 1;
  }
  s.enable_superres = b.f(1);
  s.enable_cdef = b.f(1);
  s.enable_restoration = b.f(1);
  // color_config()
  int high_bitdepth = b.f(1);
  if (s.seq_profile == 2 && high_bitdepth) s.BitDepth = b.f(1) ? 12 : 10;
  else s.BitDepth = high_bitdepth ? 10 : 8;
  s.mono_chrome = s.seq_profile == 1 ? 0 : b.f(1);
  s.NumPlanes = s.mono_chrome ? 1 : 3;
  if (b.f(1)) {
    s.color_primaries = b.f(8);
    s.transfer_characteristics = b.f(8);
    s.matrix_coefficients = b.f(8);
  }
  *color_range_bit = -1;
  if (s.mono_chrome) {
    *color_range_bit = (int64_t)b.pos;
    s.color_range = b.f(1);
    s.subsampling_x = s.subsampling_y = 1;
    s.separate_uv_delta_q = 0;
  } else {
    if (s.color_primaries == 1 && s.transfer_characteristics == 13 && s.matrix_coefficients == 0) {
      s.color_range = 1;
      s.subsampling_x = s.subsampling_y = 0;
    } else {
      *color_range_bit = (int64_t)b.pos;
      s.color_range = b.f(1);
      if (s.seq_profile == 0) {
        s.subsampling_x = s.subsampling_y = 1;
      } else if (s.seq_profile == 1) {
        s.subsampling_x = s.subsampling_y = 0;
      } else if (s.BitDepth == 12) {
        s.subsampling_x = b.f(1);
        s.subsampling_y = s.subsampling_x ? b.f(1) : 0;
      } else {
        s.subsampling_x = 1;
        s.subsampling_y = 0;
      }
      if (s.subsampling_x && s.subsampling_y) b.f(2);  // chroma_sample_position
    }
    s.separate_uv_delta_q = b.f(1);
  }
  s.film_grain_params_present = b.f(1);
  s.valid = true;
}

void check_supported(const SequenceHeader& s) {
  // no profile codes 4:4:0
  if (!s.mono_chrome && !s.subsampling_x && s.subsampling_y) unsupported("4:4:0 colour");
  if (s.enable_superres) unsupported("superres");
}

// ---------------------------------------------------------------------------
// the symbol decoder (8.2)
// ---------------------------------------------------------------------------

struct SymbolDecoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;  // bits read
  uint32_t SymbolValue = 0, SymbolRange = 0;
  int SymbolMaxBits = 0;
  bool disable_update = false;

  uint32_t read_bits(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) {
      size_t byte = pos >> 3;
      int b = byte < size ? (data[byte] >> (7 - (pos & 7))) & 1 : 0;
      pos++;
      x = (x << 1) | b;
    }
    return x;
  }
  void init(const uint8_t* d, size_t sz, bool no_update) {
    if (sz < 1) fail(SL_CORRUPT, "AV1 tile of no bytes");
    data = d;
    size = sz;
    pos = 0;
    disable_update = no_update;
    int numBits = std::min<int>(sz * 8, 15);
    uint32_t buf = read_bits(numBits);
    uint32_t paddedBuf = buf << (15 - numBits);
    SymbolValue = ((1u << 15) - 1) ^ paddedBuf;
    SymbolRange = 1u << 15;
    SymbolMaxBits = 8 * (int)sz - 15;
  }
  int symbol(uint16_t* cdf, int N, bool adapt = true) {
    uint32_t cur = SymbolRange, prev;
    int sym = -1;
    do {
      sym++;
      prev = cur;
      uint32_t f = (1u << 15) - cdf[sym];
      cur = ((SymbolRange >> 8) * (f >> 6) >> 1) + 4 * (N - sym - 1);
    } while (SymbolValue < cur);
    SymbolRange = prev - cur;
    SymbolValue -= cur;
    int bits = 15 - FloorLog2(SymbolRange);
    SymbolRange <<= bits;
    int numBits = std::min(bits, std::max(0, SymbolMaxBits));
    uint32_t newData = read_bits(numBits);
    uint32_t paddedData = newData << (bits - numBits);
    SymbolValue = paddedData ^ (((SymbolValue + 1) << bits) - 1);
    SymbolMaxBits -= bits;
    if (adapt && !disable_update) update_cdf(cdf, N, sym);
    return sym;
  }
  int boolean() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    return symbol(cdf, 2, false);
  }
  uint32_t literal(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + boolean();
    return x;
  }
  uint32_t ns(uint32_t n) {
    int w = FloorLog2(n) + 1;
    uint32_t m = (1u << w) - n;
    uint32_t v = literal(w - 1);
    if (v < m) return v;
    return (v << 1) - m + literal(1);
  }
};

struct Decoder : Recon, Post {
  // frame header
  int disable_cdf_update = 0, allow_screen_content_tools = 0, allow_intrabc = 0;
  int TileSizeBytes = 4;
  int SegIdPreSkip = 0, LastActiveSegId = 0;
  int delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0;
  int CodedLossless = 0, AllLossless = 0, LosslessArray[8] = {0};
  int TxMode = 0;
  int qm_y = 15, qm_u = 15, qm_v = 15;
  FilmGrainParams grain;
  bool have_frame_header = false, frame_done = false;
  int64_t color_range_bit = -1;  // in the item's bits (sl_av1_info)
  // state
  Cdfs cdf;
  uint16_t use_wiener_cdf[3], use_sgrproj_cdf[3], restoration_type_cdf[4];
  SymbolDecoder sd;
  int ReadDeltas = 0;
  // block state
  int use_intrabc = 0;
  int NumMvFound = 0, RefStackMv[8][2], WeightStack[8];

  // ---- headers -----------------------------------------------------------

  int read_delta_q(BitReader& b) { return b.f(1) ? b.su(7) : 0; }


  void frame_header(BitReader& b, int temporal_id, int spatial_id) {
    const SequenceHeader& s = seq;
    if (!s.valid) fail(SL_CORRUPT, "AV1 frame header before the sequence header");
    if (have_frame_header) fail(SL_UNSUPPORTED, "AV1 streams of several frames are not supported");
    int frame_type = 0, show_frame = 1;  // KEY_FRAME, shown
    if (!s.reduced_still_picture_header) {
      if (b.f(1)) unsupported("show_existing_frame");
      frame_type = b.f(2);
      show_frame = b.f(1);
      if (show_frame && s.decoder_model_info_present_flag && !s.equal_picture_interval)
        b.f(s.frame_presentation_time_length_minus_1 + 1);
      if (!show_frame) b.f(1);  // showable_frame
      if (!(frame_type == 3 || (frame_type == 0 && show_frame))) b.f(1);  // error_resilient_mode
    }
    if (frame_type == 1 || frame_type == 3) unsupported("inter frames");
    if (frame_type == 2) unsupported("intra-only frames");
    if (!show_frame) unsupported("frames that are not shown");
    disable_cdf_update = b.f(1);
    if (s.seq_force_screen_content_tools == 2) allow_screen_content_tools = b.f(1);
    else allow_screen_content_tools = s.seq_force_screen_content_tools;
    if (allow_screen_content_tools && s.seq_force_integer_mv == 2) b.f(1);  // force_integer_mv
    if (s.frame_id_numbers_present_flag)
      b.f(s.additional_frame_id_length_minus_1 + s.delta_frame_id_length_minus_2 + 3);
    int frame_size_override_flag = s.reduced_still_picture_header ? 0 : b.f(1);
    b.f(s.OrderHintBits);  // order_hint
    // primary_ref_frame is PRIMARY_REF_NONE for an intra frame
    if (s.decoder_model_info_present_flag) {
      if (b.f(1)) {  // buffer_removal_time_present_flag
        for (int op = 0; op <= s.operating_points_cnt_minus_1; op++)
          if (s.decoder_model_present_for_this_op[op]) {
            int idc = s.operating_point_idc[op];
            int inT = (idc >> temporal_id) & 1, inS = (idc >> (spatial_id + 8)) & 1;
            if (idc == 0 || (inT && inS)) b.f(s.buffer_removal_time_length_minus_1 + 1);
          }
      }
    }
    // refresh_frame_flags = 0xFF for a shown key frame: nothing to read
    if (frame_size_override_flag) {
      FrameWidth = b.f(s.frame_width_bits_minus_1 + 1) + 1;
      FrameHeight = b.f(s.frame_height_bits_minus_1 + 1) + 1;
    } else {
      FrameWidth = s.max_frame_width_minus_1 + 1;
      FrameHeight = s.max_frame_height_minus_1 + 1;
    }
    if (s.enable_superres && b.f(1)) unsupported("superres");
    MiCols = 2 * ((FrameWidth + 7) >> 3);
    MiRows = 2 * ((FrameHeight + 7) >> 3);
    if (b.f(1)) {  // render_and_frame_size_different
      b.f(16);
      b.f(16);
    }
    if (allow_screen_content_tools) allow_intrabc = b.f(1);
    // disable_frame_end_update_cdf: no later frame reads the CDFs
    if (!(s.reduced_still_picture_header || disable_cdf_update)) b.f(1);
    tile_info(b);
    quantization_params(b);
    segmentation_params(b);
    delta_q_res = delta_lf_present = delta_lf_res = delta_lf_multi = 0;
    delta_q_present = base_q_idx > 0 ? b.f(1) : 0;
    if (delta_q_present) delta_q_res = b.f(2);
    if (delta_q_present) {
      if (!allow_intrabc) delta_lf_present = b.f(1);
      if (delta_lf_present) {
        delta_lf_res = b.f(2);
        delta_lf_multi = b.f(1);
      }
    }
    CodedLossless = 1;
    for (int sid = 0; sid < 8; sid++) {
      int qindex = get_qindex(1, sid);
      LosslessArray[sid] = qindex == 0 && DeltaQYDc == 0 && DeltaQUAc == 0 && DeltaQUDc == 0 &&
                           DeltaQVAc == 0 && DeltaQVDc == 0;
      if (!LosslessArray[sid]) CodedLossless = 0;
    }
    if (using_qmatrix)
      for (int sid = 0; sid < 8; sid++) {
        SegQMLevel[0][sid] = LosslessArray[sid] ? 15 : qm_y;
        SegQMLevel[1][sid] = LosslessArray[sid] ? 15 : qm_u;
        SegQMLevel[2][sid] = LosslessArray[sid] ? 15 : qm_v;
      }
    AllLossless = CodedLossless;  // no superres
    loop_filter_params(b);
    cdef_params(b);
    lr_params(b);
    if (CodedLossless) TxMode = 0;  // ONLY_4X4
    else TxMode = b.f(1) ? 2 : 1;  // tx_mode_select: TX_MODE_SELECT : TX_MODE_LARGEST
    // reference_select, skip_mode_present, allow_warped_motion: intra
    reduced_tx_set = b.f(1);
    // global motion: none for an intra frame
    grain = FilmGrainParams();
    if (s.film_grain_params_present) film_grain_params(b);
    have_frame_header = true;
    alloc();
    alloc_post(*this);
  }

  void tile_info(BitReader& b) {
    TileLimits t = tile_limits();
    if (b.f(1)) {  // uniform_tile_spacing_flag
      TileColsLog2 = t.minLog2TileCols;
      while (TileColsLog2 < t.maxLog2TileCols) {
        if (b.f(1)) TileColsLog2++;
        else break;
      }
      TileRowsLog2 = std::max(t.minLog2Tiles - TileColsLog2, 0);
      while (TileRowsLog2 < t.maxLog2TileRows) {
        if (b.f(1)) TileRowsLog2++;
        else break;
      }
      uniform_tile_starts(t);
    } else {
      MiColStarts.clear();
      MiRowStarts.clear();
      int widestTileSb = 0, startSb = 0;
      while (startSb < t.sbCols) {
        MiColStarts.push_back(startSb << t.sbShift);
        int maxWidth = std::min(t.sbCols - startSb, t.maxTileWidthSb);
        int sizeSb = b.ns(maxWidth) + 1;
        widestTileSb = std::max(sizeSb, widestTileSb);
        startSb += sizeSb;
      }
      TileCols = MiColStarts.size();
      MiColStarts.push_back(MiCols);
      TileColsLog2 = tile_log2(1, TileCols);
      int maxTileAreaSb;
      if (t.minLog2Tiles > 0) maxTileAreaSb = (t.sbRows * t.sbCols) >> (t.minLog2Tiles + 1);
      else maxTileAreaSb = t.sbRows * t.sbCols;
      int maxTileHeightSb = std::max(maxTileAreaSb / widestTileSb, 1);
      startSb = 0;
      while (startSb < t.sbRows) {
        MiRowStarts.push_back(startSb << t.sbShift);
        int maxHeight = std::min(t.sbRows - startSb, maxTileHeightSb);
        startSb += b.ns(maxHeight) + 1;
      }
      TileRows = MiRowStarts.size();
      MiRowStarts.push_back(MiRows);
      TileRowsLog2 = tile_log2(1, TileRows);
    }
    if (TileColsLog2 > 0 || TileRowsLog2 > 0) {
      b.f(TileRowsLog2 + TileColsLog2);  // context_update_tile_id
      TileSizeBytes = b.f(2) + 1;
    } else {
      TileSizeBytes = 4;
    }
  }

  void quantization_params(BitReader& b) {
    base_q_idx = b.f(8);
    DeltaQYDc = read_delta_q(b);
    DeltaQUDc = DeltaQUAc = DeltaQVDc = DeltaQVAc = 0;
    if (seq.NumPlanes > 1) {
      int diff_uv_delta = seq.separate_uv_delta_q ? b.f(1) : 0;
      DeltaQUDc = read_delta_q(b);
      DeltaQUAc = read_delta_q(b);
      if (diff_uv_delta) {
        DeltaQVDc = read_delta_q(b);
        DeltaQVAc = read_delta_q(b);
      } else {
        DeltaQVDc = DeltaQUDc;
        DeltaQVAc = DeltaQUAc;
      }
    }
    using_qmatrix = b.f(1);
    if (using_qmatrix) {
      qm_y = b.f(4);
      qm_u = b.f(4);
      qm_v = seq.separate_uv_delta_q ? b.f(4) : qm_u;
    }
  }

  // film_grain_params (5.9.30) of a shown key frame: update_grain is 1
  void film_grain_params(BitReader& b) {
    FilmGrainParams& g = grain;
    g.apply_grain = b.f(1);
    if (!g.apply_grain) return;
    g.grain_seed = b.f(16);
    g.num_y_points = b.f(4);
    if (g.num_y_points > 14) fail(SL_CORRUPT, "AV1 film grain of %d luma points", g.num_y_points);
    for (int i = 0; i < g.num_y_points; i++) {
      g.point_y_value[i] = b.f(8);
      g.point_y_scaling[i] = b.f(8);
    }
    g.chroma_scaling_from_luma = seq.mono_chrome ? 0 : b.f(1);
    if (seq.mono_chrome || g.chroma_scaling_from_luma ||
        (seq.subsampling_x == 1 && seq.subsampling_y == 1 && g.num_y_points == 0)) {
      g.num_cb_points = g.num_cr_points = 0;
    } else {
      g.num_cb_points = b.f(4);
      if (g.num_cb_points > 10) fail(SL_CORRUPT, "AV1 film grain of %d cb points", g.num_cb_points);
      for (int i = 0; i < g.num_cb_points; i++) {
        g.point_cb_value[i] = b.f(8);
        g.point_cb_scaling[i] = b.f(8);
      }
      g.num_cr_points = b.f(4);
      if (g.num_cr_points > 10) fail(SL_CORRUPT, "AV1 film grain of %d cr points", g.num_cr_points);
      for (int i = 0; i < g.num_cr_points; i++) {
        g.point_cr_value[i] = b.f(8);
        g.point_cr_scaling[i] = b.f(8);
      }
    }
    g.grain_scaling_minus_8 = b.f(2);
    g.ar_coeff_lag = b.f(2);
    int numPosLuma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1), numPosChroma = numPosLuma;
    if (g.num_y_points) {
      numPosChroma = numPosLuma + 1;
      for (int i = 0; i < numPosLuma; i++) g.ar_coeffs_y_plus_128[i] = b.f(8);
    }
    if (g.chroma_scaling_from_luma || g.num_cb_points)
      for (int i = 0; i < numPosChroma; i++) g.ar_coeffs_cb_plus_128[i] = b.f(8);
    if (g.chroma_scaling_from_luma || g.num_cr_points)
      for (int i = 0; i < numPosChroma; i++) g.ar_coeffs_cr_plus_128[i] = b.f(8);
    g.ar_coeff_shift_minus_6 = b.f(2);
    g.grain_scale_shift = b.f(2);
    if (g.num_cb_points) {
      g.cb_mult = b.f(8);
      g.cb_luma_mult = b.f(8);
      g.cb_offset = b.f(9);
    }
    if (g.num_cr_points) {
      g.cr_mult = b.f(8);
      g.cr_luma_mult = b.f(8);
      g.cr_offset = b.f(9);
    }
    g.overlap_flag = b.f(1);
    g.clip_to_restricted_range = b.f(1);
  }

  void segmentation_params(BitReader& b) {
    segmentation_enabled = b.f(1);
    memset(FeatureEnabled, 0, sizeof FeatureEnabled);
    memset(FeatureData, 0, sizeof FeatureData);
    if (segmentation_enabled) {
      // primary_ref_frame is none: the map and the data are both updated
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          int enabled = b.f(1);
          FeatureEnabled[i][j] = enabled;
          int clipped = 0;
          if (enabled) {
            int bits = Segmentation_Feature_Bits[j], limit = Segmentation_Feature_Max[j];
            if (Segmentation_Feature_Signed[j]) clipped = Clip3(-limit, limit, b.su(1 + bits));
            else clipped = Clip3(0, limit, (int)b.f(bits));
          }
          FeatureData[i][j] = clipped;
        }
    }
    SegIdPreSkip = 0;
    LastActiveSegId = 0;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (FeatureEnabled[i][j]) {
          LastActiveSegId = i;
          if (j >= SEG_LVL_REF_FRAME) SegIdPreSkip = 1;
        }
  }

  void loop_filter_params(BitReader& b) {
    loop_filter_level[0] = loop_filter_level[1] = loop_filter_level[2] = loop_filter_level[3] = 0;
    loop_filter_delta_enabled = 1;
    const int defaults[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    memcpy(loop_filter_ref_deltas, defaults, sizeof defaults);
    loop_filter_mode_deltas[0] = loop_filter_mode_deltas[1] = 0;
    if (CodedLossless || allow_intrabc) return;
    loop_filter_level[0] = b.f(6);
    loop_filter_level[1] = b.f(6);
    if (seq.NumPlanes > 1 && (loop_filter_level[0] || loop_filter_level[1])) {
      loop_filter_level[2] = b.f(6);
      loop_filter_level[3] = b.f(6);
    }
    loop_filter_sharpness = b.f(3);
    loop_filter_delta_enabled = b.f(1);
    if (loop_filter_delta_enabled) {
      if (b.f(1)) {  // loop_filter_delta_update
        for (int i = 0; i < 8; i++)
          if (b.f(1)) loop_filter_ref_deltas[i] = b.su(7);
        for (int i = 0; i < 2; i++)
          if (b.f(1)) loop_filter_mode_deltas[i] = b.su(7);
      }
    }
  }


  void cdef_params(BitReader& b) {
    cdef_on = !(CodedLossless || allow_intrabc || !seq.enable_cdef);
    cdef_bits = 0;
    cdef_y_pri_strength[0] = cdef_y_sec_strength[0] = 0;
    cdef_uv_pri_strength[0] = cdef_uv_sec_strength[0] = 0;
    CdefDamping = 3;
    if (!cdef_on) return;
    CdefDamping = b.f(2) + 3;
    cdef_bits = b.f(2);
    for (int i = 0; i < (1 << cdef_bits); i++) {
      cdef_y_pri_strength[i] = b.f(4);
      cdef_y_sec_strength[i] = b.f(2);
      if (cdef_y_sec_strength[i] == 3) cdef_y_sec_strength[i] += 1;
      if (seq.NumPlanes > 1) {
        cdef_uv_pri_strength[i] = b.f(4);
        cdef_uv_sec_strength[i] = b.f(2);
        if (cdef_uv_sec_strength[i] == 3) cdef_uv_sec_strength[i] += 1;
      }
    }
  }

  void lr_params(BitReader& b) {
    UsesLr = 0;
    lr_unit_shift = -1;
    lr_uv_shift = 0;
    for (int i = 0; i < 3; i++) FrameRestorationType[i] = RESTORE_NONE;
    if (AllLossless || allow_intrabc || !seq.enable_restoration) return;
    int usesChromaLr = 0;
    for (int i = 0; i < seq.NumPlanes; i++) {
      FrameRestorationType[i] = Remap_Lr_Type[b.f(2)];
      if (FrameRestorationType[i] != RESTORE_NONE) {
        UsesLr = 1;
        if (i > 0) usesChromaLr = 1;
      }
    }
    if (!UsesLr) return;
    if (seq.use_128x128_superblock) {
      lr_unit_shift = b.f(1) + 1;
    } else {
      lr_unit_shift = b.f(1);
      if (lr_unit_shift) lr_unit_shift += b.f(1);
    }
    LoopRestorationSize[0] = 256 >> (2 - lr_unit_shift);
    if (seq.subsampling_x && seq.subsampling_y && usesChromaLr) lr_uv_shift = b.f(1);
    LoopRestorationSize[1] = LoopRestorationSize[2] = LoopRestorationSize[0] >> lr_uv_shift;
  }

  // ---- tiles -------------------------------------------------------------

  void tile_group(const uint8_t* data, size_t size) {
    if (!have_frame_header) fail(SL_CORRUPT, "AV1 tile group before the frame header");
    BitReader b(data, size);
    int NumTiles = TileCols * TileRows;
    int tg_start = 0, tg_end = NumTiles - 1;
    if (NumTiles > 1 && b.f(1)) {
      int tileBits = TileColsLog2 + TileRowsLog2;
      tg_start = b.f(tileBits);
      tg_end = b.f(tileBits);
    }
    b.byte_alignment();
    size_t pos = b.pos / 8;
    if (tg_end >= NumTiles || tg_start > tg_end) fail(SL_CORRUPT, "AV1 tile group out of range");
    for (int TileNum = tg_start; TileNum <= tg_end; TileNum++) {
      int tileRow = TileNum / TileCols, tileCol = TileNum % TileCols;
      size_t tileSize;
      if (TileNum == tg_end) {
        if (pos > size) fail(SL_TRUNCATED, "AV1 tile data ends early");
        tileSize = size - pos;
      } else {
        if (pos + TileSizeBytes > size) fail(SL_TRUNCATED, "AV1 tile data ends early");
        tileSize = 0;
        for (int i = 0; i < TileSizeBytes; i++) tileSize |= (size_t)data[pos + i] << (8 * i);
        tileSize += 1;
        pos += TileSizeBytes;
        if (pos + tileSize > size) fail(SL_TRUNCATED, "AV1 tile data ends early");
      }
      set_tile(tileRow, tileCol);
      cdf.init(base_q_idx);
      copy_cdf(use_wiener_cdf, Default_Use_Wiener_Cdf);
      copy_cdf(use_sgrproj_cdf, Default_Use_Sgrproj_Cdf);
      copy_cdf(restoration_type_cdf, Default_Restoration_Type_Cdf);
      sd.init(data + pos, tileSize, disable_cdf_update);
      decode_tile();
      pos += tileSize;
    }
    if (tg_end == NumTiles - 1) {
      loop_filter();
      post_filters(*this);
      frame_done = true;
    }
  }

  void decode_tile() {
    clear_above_context();
    reset_lr_refs();
    int sbSize = seq.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
    int sbSize4 = Num_4x4_Blocks_Wide[sbSize];
    for (int r = MiRowStart; r < MiRowEnd; r += sbSize4) {
      clear_left_context();
      for (int c = MiColStart; c < MiColEnd; c += sbSize4) {
        ReadDeltas = delta_q_present;
        clear_cdef(r, c);
        clear_block_decoded_flags(r, c, sbSize4);
        read_lr(r, c, sbSize);
        decode_partition(r, c, sbSize);
      }
    }
  }

  void clear_cdef(int r, int c) {
    cdef_at(r, c) = -1;
    if (seq.use_128x128_superblock) {
      if (c + 16 < MiCols) cdef_at(r, c + 16) = -1;
      if (r + 16 < MiRows) cdef_at(r + 16, c) = -1;
      if (r + 16 < MiRows && c + 16 < MiCols) cdef_at(r + 16, c + 16) = -1;
    }
  }

  void read_cdef() {
    if (skip || !cdef_on) return;  // cdef_on: enable_cdef, and neither CodedLossless nor allow_intrabc
    int r = MiRow & ~15, c = MiCol & ~15;
    if (cdef_at(r, c) == -1) {
      int idx = sd.literal(cdef_bits);
      int w4 = Num_4x4_Blocks_Wide[MiSize], h4 = Num_4x4_Blocks_High[MiSize];
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16)
          if (y < MiRows && x < MiCols) cdef_at(y, x) = idx;
    }
  }

  // ---- loop restoration coefficients (5.11.57, 5.11.58) --------------------

  void read_lr(int r, int c, int bSize) {
    if (allow_intrabc) return;
    int w = Num_4x4_Blocks_Wide[bSize], h = Num_4x4_Blocks_High[bSize];
    for (int plane = 0; plane < seq.NumPlanes; plane++) {
      if (FrameRestorationType[plane] == RESTORE_NONE) continue;
      int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
      int unitSize = LoopRestorationSize[plane];
      int unitRowStart = (r * (4 >> subY) + unitSize - 1) / unitSize;
      int unitRowEnd = std::min(unitRows[plane], ((r + h) * (4 >> subY) + unitSize - 1) / unitSize);
      int numerator = 4 >> subX, denominator = unitSize;
      int unitColStart = (c * numerator + denominator - 1) / denominator;
      int unitColEnd = std::min(unitCols[plane], ((c + w) * numerator + denominator - 1) / denominator);
      for (int unitRow = unitRowStart; unitRow < unitRowEnd; unitRow++)
        for (int unitCol = unitColStart; unitCol < unitColEnd; unitCol++) read_lr_unit(plane, unitRow, unitCol);
    }
  }

  void read_lr_unit(int plane, int unitRow, int unitCol) {
    LrUnit& u = LrUnits[plane][(size_t)unitRow * unitCols[plane] + unitCol];
    int type;
    if (FrameRestorationType[plane] == RESTORE_WIENER)
      type = sd.symbol(use_wiener_cdf, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (FrameRestorationType[plane] == RESTORE_SGRPROJ)
      type = sd.symbol(use_sgrproj_cdf, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else
      type = sd.symbol(restoration_type_cdf, 3);  // RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ
    u.type = type;
    if (type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        int firstCoeff = 0;
        if (plane) {
          firstCoeff = 1;
          u.wiener[pass][0] = 0;
        }
        for (int j = firstCoeff; j < 3; j++) {
          int v = decode_signed_subexp_with_ref_bool(Wiener_Taps_Min[j], Wiener_Taps_Max[j] + 1, Wiener_Taps_K[j],
                                                     RefLrWiener[plane][pass][j]);
          u.wiener[pass][j] = v;
          RefLrWiener[plane][pass][j] = v;
        }
      }
    } else if (type == RESTORE_SGRPROJ) {
      int set = sd.literal(4);
      u.set = set;
      for (int i = 0; i < 2; i++) {
        int radius = Sgr_Params[set][i * 2];
        int mn = Sgrproj_Xqd_Min[i], mx = Sgrproj_Xqd_Max[i];
        int v;
        if (radius) {
          v = decode_signed_subexp_with_ref_bool(mn, mx + 1, 4, RefSgrXqd[plane][i]);
        } else {
          v = 0;
          if (i == 1) v = Clip3(mn, mx, (1 << 7) - RefSgrXqd[plane][0]);
        }
        u.xqd[i] = v;
        RefSgrXqd[plane][i] = v;
      }
    }
  }

  int decode_signed_subexp_with_ref_bool(int low, int high, int k, int r) {
    return decode_unsigned_subexp_with_ref_bool(high - low, k, r - low) + low;
  }
  int decode_unsigned_subexp_with_ref_bool(int mx, int k, int r) {
    int v = decode_subexp_bool(mx, k);
    if ((r << 1) <= mx) return inverse_recenter(r, v);
    return mx - 1 - inverse_recenter(mx - 1 - r, v);
  }
  int decode_subexp_bool(int numSyms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (numSyms <= mk + 3 * a) return (int)sd.ns(numSyms - mk) + mk;
      if (sd.literal(1)) {
        i++;
        mk += a;
      } else {
        return (int)sd.literal(b2) + mk;
      }
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }


  uint16_t* partition_cdf(int bsl, int ctx, int* N) {
    switch (bsl) {
      case 1: *N = 4; return cdf.part8[ctx];
      case 2: *N = 10; return cdf.part16[ctx];
      case 3: *N = 10; return cdf.part32[ctx];
      case 4: *N = 10; return cdf.part64[ctx];
      default: *N = 8; return cdf.part128[ctx];
    }
  }

  void decode_partition(int r, int c, int bSize) {
    if (r >= MiRows || c >= MiCols) return;
    int num4x4 = Num_4x4_Blocks_Wide[bSize];
    int halfBlock4x4 = num4x4 >> 1, quarterBlock4x4 = halfBlock4x4 >> 1;
    bool hasRows = (r + halfBlock4x4) < MiRows;
    bool hasCols = (c + halfBlock4x4) < MiCols;
    int partition;
    if (bSize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int N;
      uint16_t* pc = partition_cdf(Mi_Width_Log2[bSize], partition_ctx(r, c, bSize), &N);
      if (hasRows && hasCols) {
        partition = sd.symbol(pc, N);
      } else if (hasCols || hasRows) {
        // one half lies outside: SPLIT stands for every partition that
        // splits the half inside
        int psum = partition_split_prob(pc, bSize, hasCols);
        uint16_t bc[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
        partition = sd.symbol(bc, 2, false) ? PARTITION_SPLIT : (hasCols ? PARTITION_HORZ : PARTITION_VERT);
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int wl = Mi_Width_Log2[bSize], hl = Mi_Height_Log2[bSize];
    int splitSize = bSize >= BLOCK_8X8 ? BlockOf[wl - 1][hl - 1] : bSize;
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, bSize); break;
      case PARTITION_HORZ: {
        int sub = BlockOf[wl][hl - 1];
        decode_block(r, c, sub);
        if (hasRows) decode_block(r + halfBlock4x4, c, sub);
        break;
      }
      case PARTITION_VERT: {
        int sub = BlockOf[wl - 1][hl];
        decode_block(r, c, sub);
        if (hasCols) decode_block(r, c + halfBlock4x4, sub);
        break;
      }
      case PARTITION_SPLIT:
        decode_partition(r, c, splitSize);
        decode_partition(r, c + halfBlock4x4, splitSize);
        decode_partition(r + halfBlock4x4, c, splitSize);
        decode_partition(r + halfBlock4x4, c + halfBlock4x4, splitSize);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, splitSize);
        decode_block(r, c + halfBlock4x4, splitSize);
        decode_block(r + halfBlock4x4, c, BlockOf[wl][hl - 1]);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, BlockOf[wl][hl - 1]);
        decode_block(r + halfBlock4x4, c, splitSize);
        decode_block(r + halfBlock4x4, c + halfBlock4x4, splitSize);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, splitSize);
        decode_block(r + halfBlock4x4, c, splitSize);
        decode_block(r, c + halfBlock4x4, BlockOf[wl - 1][hl]);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, BlockOf[wl - 1][hl]);
        decode_block(r, c + halfBlock4x4, splitSize);
        decode_block(r + halfBlock4x4, c + halfBlock4x4, splitSize);
        break;
      case PARTITION_HORZ_4: {
        int sub = BlockOf[wl][hl - 2];
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarterBlock4x4 * 3 < MiRows) decode_block(r + quarterBlock4x4 * i, c, sub);
        break;
      }
      case PARTITION_VERT_4: {
        int sub = BlockOf[wl - 2][hl];
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarterBlock4x4 * 3 < MiCols) decode_block(r, c + quarterBlock4x4 * i, sub);
        break;
      }
    }
  }

  // ---- blocks ------------------------------------------------------------


  void decode_block(int r, int c, int subSize) {
    // 4:2:2 has no chroma block for a luma block taller than wide
    // (Subsampled_Size)
    if (seq.NumPlanes > 1 && seq.subsampling_x && !seq.subsampling_y &&
        Num_4x4_Blocks_High[subSize] > Num_4x4_Blocks_Wide[subSize])
      fail(SL_CORRUPT, "AV1 block size with no 4:2:2 chroma size");
    set_block(r, c, subSize);
    intra_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context(Num_4x4_Blocks_Wide[subSize], Num_4x4_Blocks_High[subSize]);
    store_mode_info();
    if (is_inter) predict_intrabc();
    residual();
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (SegIdPreSkip) intra_segment_id();
    if (SegIdPreSkip && seg_feature_active(SEG_LVL_SKIP)) {
      skip = 1;
    } else {
      skip = sd.symbol(cdf.skip[skip_ctx()], 2);
    }
    if (!SegIdPreSkip) intra_segment_id();
    read_cdef();
    Lossless = LosslessArray[segment_id];
    counts[CNT_LOSSLESS] += Lossless;
    read_delta_qindex();
    read_delta_lf();
    ReadDeltas = 0;
    use_filter_intra = 0;
    is_inter = use_intrabc = 0;
    Mv[0] = Mv[1] = 0;
    if (allow_intrabc) use_intrabc = sd.symbol(cdf.intrabc, 2);
    if (use_intrabc) {
      is_inter = 1;
      YMode = UVMode = DC_PRED;
      AngleDeltaY = AngleDeltaUV = 0;
      CflAlphaU = CflAlphaV = 0;
      PaletteSizeY = PaletteSizeUV = 0;
      find_mv_stack();
      assign_dv();
      return;
    }
    YMode = sd.symbol(cdf.y_mode[above_mode_ctx()][left_mode_ctx()], 13);
    AngleDeltaY = 0;
    if (MiSize >= BLOCK_8X8 && is_directional_mode(YMode))
      AngleDeltaY = sd.symbol(cdf.angle_delta[YMode - V_PRED], 7) - 3;
    UVMode = DC_PRED;
    AngleDeltaUV = 0;
    CflAlphaU = CflAlphaV = 0;
    if (HasChroma) {
      if (cfl_allowed()) UVMode = sd.symbol(cdf.uv_cfl[YMode], 14);
      else UVMode = sd.symbol(cdf.uv_nocfl[YMode], 13);
      if (UVMode == UV_CFL_PRED) {
        read_cfl_alphas();
        counts[CNT_CFL]++;
      }
      if (MiSize >= BLOCK_8X8 && is_directional_mode(UVMode))
        AngleDeltaUV = sd.symbol(cdf.angle_delta[UVMode - V_PRED], 7) - 3;
    }
    PaletteSizeY = PaletteSizeUV = 0;
    if (MiSize >= BLOCK_8X8 && Block_Width(MiSize) <= 64 && Block_Height(MiSize) <= 64 &&
        allow_screen_content_tools)
      palette_mode_info();
    if (filter_intra_allowed()) {
      use_filter_intra = sd.symbol(cdf.filter_intra[MiSize], 2);
      if (use_filter_intra) filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
    }
  }

  void intra_segment_id() {
    if (!segmentation_enabled) {
      segment_id = 0;
      return;
    }
    int prevUL = -1, prevU = -1, prevL = -1;
    if (AvailU && AvailL) prevUL = M(MiRow - 1, MiCol - 1).segment_id;
    if (AvailU) prevU = M(MiRow - 1, MiCol).segment_id;
    if (AvailL) prevL = M(MiRow, MiCol - 1).segment_id;
    int pred;
    if (prevU == -1) pred = prevL == -1 ? 0 : prevL;
    else if (prevL == -1) pred = prevU;
    else pred = prevUL == prevU ? prevU : prevL;
    if (skip) {
      segment_id = pred;
      return;
    }
    int ctx;
    if (prevUL < 0) ctx = 0;
    else if (prevUL == prevU && prevUL == prevL) ctx = 2;
    else if (prevUL == prevU || prevUL == prevL || prevU == prevL) ctx = 1;
    else ctx = 0;
    int v = sd.symbol(cdf.segment_id[ctx], 8);
    segment_id = Clip3(0, LastActiveSegId, neg_deinterleave(v, pred, LastActiveSegId + 1));
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) {
        if (diff & 1) return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
      }
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) {
      if (diff & 1) return ref + ((diff + 1) >> 1);
      return ref - (diff >> 1);
    }
    return max - (diff + 1);
  }

  void read_delta_qindex() {
    int sbSize = seq.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
    if (MiSize == sbSize && skip) return;
    if (ReadDeltas) {
      int delta_q_abs = sd.symbol(cdf.delta_q, 4);
      if (delta_q_abs == 3) {
        int rem_bits = sd.literal(3) + 1;
        delta_q_abs = sd.literal(rem_bits) + (1 << rem_bits) + 1;
      }
      if (delta_q_abs) {
        int sign = sd.literal(1);
        int reduced = sign ? -delta_q_abs : delta_q_abs;
        CurrentQIndex = Clip3(1, 255, CurrentQIndex + (reduced << delta_q_res));
      }
    }
  }

  void read_delta_lf() {
    int sbSize = seq.use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
    if (MiSize == sbSize && skip) return;
    if (ReadDeltas && delta_lf_present) {
      int frameLfCount = 1;
      if (delta_lf_multi) frameLfCount = seq.NumPlanes > 1 ? 4 : 2;
      for (int i = 0; i < frameLfCount; i++) {
        uint16_t* c = delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
        int abs = sd.symbol(c, 4);
        if (abs == 3) {
          int n = sd.literal(3) + 1;
          abs = sd.literal(n) + (1 << n) + 1;
        }
        if (abs) {
          int sign = sd.literal(1);
          int reduced = sign ? -abs : abs;
          DeltaLF[i] = Clip3(-63, 63, DeltaLF[i] + (reduced << delta_lf_res));
        }
      }
    }
  }

  void read_cfl_alphas() {
    int signs = sd.symbol(cdf.cfl_sign, 8);
    int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
    if (signU) {
      int ctx = (signU - 1) * 3 + signV;
      CflAlphaU = 1 + sd.symbol(cdf.cfl_alpha[ctx], 16);
      if (signU == 1) CflAlphaU = -CflAlphaU;
    }
    if (signV) {
      int ctx = (signV - 1) * 3 + signU;
      CflAlphaV = 1 + sd.symbol(cdf.cfl_alpha[ctx], 16);
      if (signV == 1) CflAlphaV = -CflAlphaV;
    }
  }

  // ---- intra block copy (the motion vector syntax and prediction) --------

  void search_stack(int mvRow, int mvCol, int weight) {
    ModeInfo& m = M(mvRow, mvCol);
    int candMv[2] = {m.mv[0], m.mv[1]};
    // force_integer_mv: candidates round to whole pixels
    for (int i = 0; i < 2; i++) {
      int a = std::abs(candMv[i]);
      int aInt = (a + 3) >> 3;
      candMv[i] = candMv[i] > 0 ? (aInt << 3) : -(aInt << 3);
    }
    int idx;
    for (idx = 0; idx < NumMvFound; idx++)
      if (candMv[0] == RefStackMv[idx][0] && candMv[1] == RefStackMv[idx][1]) break;
    if (idx < NumMvFound) {
      WeightStack[idx] += weight;
    } else if (NumMvFound < 8) {
      RefStackMv[NumMvFound][0] = candMv[0];
      RefStackMv[NumMvFound][1] = candMv[1];
      WeightStack[NumMvFound] = weight;
      NumMvFound++;
    }
  }

  // the candidates are the neighbours that copy from this frame too
  void add_ref_mv_candidate(int mvRow, int mvCol, int weight) {
    if (!M(mvRow, mvCol).is_inter) return;
    search_stack(mvRow, mvCol, weight);
  }

  void scan_row(int deltaRow) {
    int bw4 = Num_4x4_Blocks_Wide[MiSize];
    int end4 = std::min(std::min(bw4, MiCols - MiCol), 16);
    int deltaCol = 0;
    bool useStep16 = bw4 >= 16;
    if (std::abs(deltaRow) > 1) {
      deltaRow += MiRow & 1;
      deltaCol = 1 - (MiCol & 1);
    }
    for (int i = 0; i < end4;) {
      int mvRow = MiRow + deltaRow, mvCol = MiCol + deltaCol + i;
      if (!is_inside(mvRow, mvCol)) break;
      int len = std::min(bw4, (int)Num_4x4_Blocks_Wide[M(mvRow, mvCol).mi_size]);
      if (std::abs(deltaRow) > 1) len = std::max(2, len);
      if (useStep16) len = std::max(4, len);
      add_ref_mv_candidate(mvRow, mvCol, len * 2);
      i += len;
    }
  }

  void scan_col(int deltaCol) {
    int bh4 = Num_4x4_Blocks_High[MiSize];
    int end4 = std::min(std::min(bh4, MiRows - MiRow), 16);
    int deltaRow = 0;
    bool useStep16 = bh4 >= 16;
    if (std::abs(deltaCol) > 1) {
      deltaRow = 1 - (MiRow & 1);
      deltaCol += MiCol & 1;
    }
    for (int i = 0; i < end4;) {
      int mvRow = MiRow + deltaRow + i, mvCol = MiCol + deltaCol;
      if (!is_inside(mvRow, mvCol)) break;
      int len = std::min(bh4, (int)Num_4x4_Blocks_High[M(mvRow, mvCol).mi_size]);
      if (std::abs(deltaCol) > 1) len = std::max(2, len);
      if (useStep16) len = std::max(4, len);
      add_ref_mv_candidate(mvRow, mvCol, len * 2);
      i += len;
    }
  }

  void scan_point(int deltaRow, int deltaCol) {
    int mvRow = MiRow + deltaRow, mvCol = MiCol + deltaCol;
    if (is_inside(mvRow, mvCol) && M(mvRow, mvCol).written) add_ref_mv_candidate(mvRow, mvCol, 4);
  }

  void find_mv_stack() {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    NumMvFound = 0;
    scan_row(-1);
    scan_col(-1);
    if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
    int numNearest = NumMvFound;
    for (int idx = 0; idx < numNearest; idx++) WeightStack[idx] += 640;
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    sorting(0, numNearest);
    sorting(numNearest, NumMvFound);
    // extra_search adds nothing: no neighbour refers to another frame
    for (int idx = 0; idx < NumMvFound; idx++) {
      RefStackMv[idx][0] = clamp_mv_row(RefStackMv[idx][0], 128 + bh4 * 4 * 8);
      RefStackMv[idx][1] = clamp_mv_col(RefStackMv[idx][1], 128 + bw4 * 4 * 8);
    }
  }

  void sorting(int start, int end) {
    while (end > start) {
      int newEnd = start;
      for (int idx = start + 1; idx < end; idx++)
        if (WeightStack[idx - 1] < WeightStack[idx]) {
          std::swap(WeightStack[idx - 1], WeightStack[idx]);
          std::swap(RefStackMv[idx - 1][0], RefStackMv[idx][0]);
          std::swap(RefStackMv[idx - 1][1], RefStackMv[idx][1]);
          newEnd = idx;
        }
      end = newEnd;
    }
  }

  int clamp_mv_row(int mvec, int border) {
    int bh4 = Num_4x4_Blocks_High[MiSize];
    int mbToTopEdge = -((MiRow * 4) * 8);
    int mbToBottomEdge = ((MiRows - bh4 - MiRow) * 4) * 8;
    return Clip3(mbToTopEdge - border, mbToBottomEdge + border, mvec);
  }
  int clamp_mv_col(int mvec, int border) {
    int bw4 = Num_4x4_Blocks_Wide[MiSize];
    int mbToLeftEdge = -((MiCol * 4) * 8);
    int mbToRightEdge = ((MiCols - bw4 - MiCol) * 4) * 8;
    return Clip3(mbToLeftEdge - border, mbToRightEdge + border, mvec);
  }

  int read_mv_component(int comp) {
    int sign = sd.symbol(cdf.mv_sign[comp], 2);
    int mv_class = sd.symbol(cdf.mv_class[comp], 11);
    int mag;
    if (mv_class == 0) {
      int class0_bit = sd.symbol(cdf.mv_class0[comp], 2);
      // force_integer_mv: the fraction is 3 and the high precision bit 1
      mag = ((class0_bit << 3) | (3 << 1) | 1) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < mv_class; i++) d |= sd.symbol(cdf.mv_bits[comp][i], 2) << i;
      mag = 2 << (mv_class + 2);
      mag += ((d << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
  }

  void assign_dv() {
    int pred[2] = {0, 0};
    if (NumMvFound > 0) {
      pred[0] = RefStackMv[0][0];
      pred[1] = RefStackMv[0][1];
    }
    if (pred[0] == 0 && pred[1] == 0 && NumMvFound > 1) {
      pred[0] = RefStackMv[1][0];
      pred[1] = RefStackMv[1][1];
    }
    if (pred[0] == 0 && pred[1] == 0) {
      int sbSize4 = seq.use_128x128_superblock ? 32 : 16;
      if (MiRow - sbSize4 < MiRowStart) {
        pred[0] = 0;
        pred[1] = -(sbSize4 * 4 + 256) * 8;
      } else {
        pred[0] = -(sbSize4 * 4 * 8);
        pred[1] = 0;
      }
    }
    int diff[2] = {0, 0};
    int mv_joint = sd.symbol(cdf.mv_joint, 4);
    if (mv_joint == 2 || mv_joint == 3) diff[0] = read_mv_component(0);
    if (mv_joint == 1 || mv_joint == 3) diff[1] = read_mv_component(1);
    Mv[0] = pred[0] + diff[0];
    Mv[1] = pred[1] + diff[1];
  }

  // the block copied from the frame decoded so far (7.11.3 with the
  // bilinear filter; a vector is in whole pixels, so a subsampled plane may
  // land half way)
  void predict_intrabc() {
    for (int plane = 0; plane < 1 + HasChroma * 2; plane++) {
      int planeSz = get_plane_residual_size(MiSize, plane);
      int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
      int w = Num_4x4_Blocks_Wide[planeSz] * 4, h = Num_4x4_Blocks_High[planeSz] * 4;
      int baseX = (MiCol >> subX) * 4, baseY = (MiRow >> subY) * 4;
      int lastX = ((FrameWidth + subX) >> subX) - 1, lastY = ((FrameHeight + subY) >> subY) - 1;
      Plane& P = planes[plane];
      // positions in 1/16 sample
      int px = (baseX << 4) + ((2 * Mv[1]) >> subX);
      int py = (baseY << 4) + ((2 * Mv[0]) >> subY);
      int fx = px & 15, fy = py & 15, ix = px >> 4, iy = py >> 4;
      // InterRound0 and InterRound1 (7.11.3.2): 3 and 11, 5 and 9 at 12 bits
      int round0 = seq.BitDepth == 12 ? 5 : 3, round1 = 14 - round0;
      static thread_local int inter[72][64];
      for (int r = 0; r < h + 1; r++)
        for (int c = 0; c < w; c++) {
          int yy = Clip3(0, lastY, iy + r);
          int a = *P.at(yy, Clip3(0, lastX, ix + c)), b = *P.at(yy, Clip3(0, lastX, ix + c + 1));
          inter[r][c] = Round2((128 - 8 * fx) * a + 8 * fx * b, round0);
        }
      static thread_local uint16_t out[64][64];
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++)
          out[r][c] = Clip1(Round2((128 - 8 * fy) * inter[r][c] + 8 * fy * inter[r + 1][c], round1));
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) *P.at(baseY + r, baseX + c) = out[r][c];
    }
  }

  // ---- palette -----------------------------------------------------------

  void palette_mode_info() {
    int bsizeCtx = Mi_Width_Log2[MiSize] + Mi_Height_Log2[MiSize] - 2;
    uint16_t cache[16];
    int bd = seq.BitDepth;
    if (YMode == DC_PRED) {
      int ctx = 0;
      if (AvailU && M(MiRow - 1, MiCol).palette_size[0] > 0) ctx++;
      if (AvailL && M(MiRow, MiCol - 1).palette_size[0] > 0) ctx++;
      if (sd.symbol(cdf.pal_y_mode[bsizeCtx][ctx], 2)) {
        PaletteSizeY = sd.symbol(cdf.pal_y_size[bsizeCtx], 7) + 2;
        int cacheN = get_palette_cache(0, cache);
        int idx = 0;
        for (int i = 0; i < cacheN && idx < PaletteSizeY; i++)
          if (sd.literal(1)) palette_colors_y[idx++] = cache[i];
        if (idx < PaletteSizeY) palette_colors_y[idx++] = sd.literal(bd);
        int paletteBits = 0;
        if (idx < PaletteSizeY) paletteBits = bd - 3 + sd.literal(2);
        while (idx < PaletteSizeY) {
          int delta = sd.literal(paletteBits) + 1;
          palette_colors_y[idx] = Clip1(palette_colors_y[idx - 1] + delta);
          int range = (1 << bd) - palette_colors_y[idx] - 1;
          paletteBits = std::min(paletteBits, CeilLog2(range));
          idx++;
        }
        std::sort(palette_colors_y, palette_colors_y + PaletteSizeY);
      }
    }
    if (HasChroma && UVMode == DC_PRED) {
      if (sd.symbol(cdf.pal_uv_mode[PaletteSizeY > 0], 2)) {
        PaletteSizeUV = sd.symbol(cdf.pal_uv_size[bsizeCtx], 7) + 2;
        int cacheN = get_palette_cache(1, cache);
        int idx = 0;
        for (int i = 0; i < cacheN && idx < PaletteSizeUV; i++)
          if (sd.literal(1)) palette_colors_u[idx++] = cache[i];
        if (idx < PaletteSizeUV) palette_colors_u[idx++] = sd.literal(bd);
        int paletteBits = 0;
        if (idx < PaletteSizeUV) paletteBits = bd - 3 + sd.literal(2);
        while (idx < PaletteSizeUV) {
          int delta = sd.literal(paletteBits);
          palette_colors_u[idx] = Clip1(palette_colors_u[idx - 1] + delta);
          int range = (1 << bd) - palette_colors_u[idx];
          idx++;
          paletteBits = std::min(paletteBits, CeilLog2(range));
        }
        std::sort(palette_colors_u, palette_colors_u + PaletteSizeUV);
        if (sd.literal(1)) {  // delta_encode_palette_colors_v
          int minBits = bd - 4, maxVal = 1 << bd;
          int bits = minBits + sd.literal(2);
          palette_colors_v[0] = sd.literal(bd);
          for (idx = 1; idx < PaletteSizeUV; idx++) {
            int delta = sd.literal(bits);
            if (delta && sd.literal(1)) delta = -delta;
            int val = palette_colors_v[idx - 1] + delta;
            if (val < 0) val += maxVal;
            if (val >= maxVal) val -= maxVal;
            palette_colors_v[idx] = Clip1(val);
          }
        } else {
          for (idx = 0; idx < PaletteSizeUV; idx++) palette_colors_v[idx] = sd.literal(bd);
        }
      }
    }
  }

  void read_color_map(uint8_t (*map)[64], int plane, int n, int blockWidth, int blockHeight,
                      int onscreenWidth, int onscreenHeight) {
    map[0][0] = sd.ns(n);
    for (int i = 1; i < onscreenHeight + onscreenWidth - 1; i++)
      for (int j = std::min(i, onscreenWidth - 1); j >= std::max(0, i - onscreenHeight + 1); j--) {
        int r = i - j, c = j, order[8];
        int ctx = palette_color_context(map, r, c, n, order);
        map[r][c] = order[sd.symbol(palette_color_cdf(cdf, plane, n, ctx), n)];
      }
    extend_color_map(map, blockWidth, blockHeight, onscreenWidth, onscreenHeight);
  }

  void palette_tokens() {
    int bw, bh, ow, oh;
    if (PaletteSizeY) {
      color_map_size(0, &bw, &bh, &ow, &oh);
      read_color_map(ColorMapY, 0, PaletteSizeY, bw, bh, ow, oh);
    }
    if (PaletteSizeUV) {
      counts[CNT_PALETTE_UV]++;
      color_map_size(1, &bw, &bh, &ow, &oh);
      read_color_map(ColorMapUV, 1, PaletteSizeUV, bw, bh, ow, oh);
    }
  }


  // ---- transform sizes ---------------------------------------------------


  void read_block_tx_size() {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    if (TxMode == 2 && MiSize > BLOCK_4X4 && is_inter && !skip && !Lossless) {
      int maxTxSz = Max_Tx_Size_Rect[MiSize];
      int txW4 = Tx_Width(maxTxSz) / 4, txH4 = Tx_Height(maxTxSz) / 4;
      for (int row = MiRow; row < MiRow + bh4; row += txH4)
        for (int col = MiCol; col < MiCol + bw4; col += txW4) read_var_tx_size(row, col, maxTxSz, 0);
    } else {
      read_tx_size();
      set_inter_tx_size(MiRow, MiCol, bh4, bw4, TxSize);
    }
  }


  void read_var_tx_size(int row, int col, int txSz, int depth) {
    if (row >= MiRows || col >= MiCols) return;
    int txfm_split = 0;
    if (!(txSz == TX_4X4 || depth == 2)) {
      int above = get_above_tx_width(row, col) < Tx_Width(txSz);
      int left = get_left_tx_height(row, col) < Tx_Height(txSz);
      int size = std::min(64, std::max(Block_Width(MiSize), Block_Height(MiSize)));
      int maxTxSz = find_tx_size(size, size);
      int txSzSqrUp = Tx_Size_Sqr_Up[txSz];
      int ctx = (txSzSqrUp != maxTxSz) * 3 + (TX_64X64 - maxTxSz) * 6 + above + left;
      txfm_split = sd.symbol(cdf.txfm_split[ctx], 2);
    }
    int w4 = Tx_Width(txSz) / 4, h4 = Tx_Height(txSz) / 4;
    if (txfm_split) {
      int sub = Split_Tx_Size[txSz];
      int stepW = Tx_Width(sub) / 4, stepH = Tx_Height(sub) / 4;
      for (int i = 0; i < h4; i += stepH)
        for (int j = 0; j < w4; j += stepW) read_var_tx_size(row + i, col + j, sub, depth + 1);
    } else {
      set_inter_tx_size(row, col, h4, w4, txSz);
      TxSize = txSz;
    }
  }

  void read_tx_size() {
    if (Lossless) {
      TxSize = TX_4X4;
      return;
    }
    int maxRectTxSize = Max_Tx_Size_Rect[MiSize];
    TxSize = maxRectTxSize;
    if (MiSize > BLOCK_4X4 && TxMode == 2 && (!skip || !is_inter)) {
      // the category: the splits from the largest size to 4x4, less one
      int cat = tx_depth_cat(maxRectTxSize);
      int ctx = tx_depth_ctx(maxRectTxSize);
      int tx_depth;
      if (cat == 0) tx_depth = sd.symbol(cdf.tx8[ctx], 2);
      else if (cat == 1) tx_depth = sd.symbol(cdf.tx16[ctx], 3);
      else if (cat == 2) tx_depth = sd.symbol(cdf.tx32[ctx], 3);
      else tx_depth = sd.symbol(cdf.tx64[ctx], 3);
      for (int i = 0; i < tx_depth; i++) TxSize = Split_Tx_Size[TxSize];
    }
  }


  // ---- residual ----------------------------------------------------------

  void residual() {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    int widthChunks = std::max(1, bw4 >> 4), heightChunks = std::max(1, bh4 >> 4);
    for (int chunkY = 0; chunkY < heightChunks; chunkY++)
      for (int chunkX = 0; chunkX < widthChunks; chunkX++) {
        for (int plane = 0; plane < 1 + HasChroma * 2; plane++) {
          int txSz = Lossless ? TX_4X4 : get_tx_size(plane, TxSize);
          if (plane) counts[CNT_UV_TX_SIZES] |= 1 << txSz;
          int stepX = Tx_Width(txSz) >> 2, stepY = Tx_Height(txSz) >> 2;
          int planeSz = get_plane_residual_size(MiSize, plane);
          int num4x4W = Num_4x4_Blocks_Wide[planeSz], num4x4H = Num_4x4_Blocks_High[planeSz];
          int subX = plane ? seq.subsampling_x : 0, subY = plane ? seq.subsampling_y : 0;
          if (is_inter && !Lossless && !plane) {
            int baseX = ((MiCol + (chunkX << 4)) >> subX) * 4, baseY = ((MiRow + (chunkY << 4)) >> subY) * 4;
            transform_tree(baseX, baseY, std::min(num4x4W * 4, 64), std::min(num4x4H * 4, 64));
            continue;
          }
          int baseXBlock = (MiCol >> subX) * 4, baseYBlock = (MiRow >> subY) * 4;
          for (int y = 0; y < std::min(num4x4H, 16 >> subY); y += stepY)
            for (int x = 0; x < std::min(num4x4W, 16 >> subX); x += stepX)
              transform_block(plane, baseXBlock, baseYBlock, txSz, x + ((chunkX << 4) >> subX),
                              y + ((chunkY << 4) >> subY));
        }
      }
  }

  void transform_tree(int startX, int startY, int w, int h) {
    int maxX = MiCols * 4, maxY = MiRows * 4;
    if (startX >= maxX || startY >= maxY) return;
    int row = startY >> 2, col = startX >> 2;
    int txSz = M(row, col).tx_size;
    if (w <= Tx_Width(txSz) && h <= Tx_Height(txSz)) {
      transform_block(0, startX, startY, find_tx_size(w, h), 0, 0);
    } else if (w > h) {
      transform_tree(startX, startY, w / 2, h);
      transform_tree(startX + w / 2, startY, w / 2, h);
    } else if (w < h) {
      transform_tree(startX, startY, w, h / 2);
      transform_tree(startX, startY + h / 2, w, h / 2);
    } else {
      transform_tree(startX, startY, w / 2, h / 2);
      transform_tree(startX + w / 2, startY, w / 2, h / 2);
      transform_tree(startX, startY + h / 2, w / 2, h / 2);
      transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
    }
  }

  void transform_block(int plane, int baseX, int baseY, int txSz, int x, int y) {
    int startX = baseX + 4 * x, startY = baseY + 4 * y;
    if (!tx_block_on_screen(plane, startX, startY)) return;
    // an intra block copy is predicted for the whole block (predict_intrabc)
    if (!is_inter) predict_tx_intra(plane, startX, startY, x, y, txSz);
    if (!skip) {
      int eob = coeffs(startX >> 2, startY >> 2, plane, txSz);
      if (eob > 0) reconstruct(plane, startX, startY, txSz);
    }
    finish_tx_block(plane, startX, startY, txSz);
  }

  // ---- coefficients ------------------------------------------------------


  int coeffs(int x4, int y4, int plane, int txSz) {
    int txSzCtx = tx_size_ctx(txSz);
    int ptype = plane > 0;
    int segEob = (txSz == TX_16X64 || txSz == TX_64X16) ? 512 : std::min(1024, Tx_Width(txSz) * Tx_Height(txSz));
    for (int c = 0; c < segEob; c++) Quant[c] = 0;
    int eob = 0, culLevel = 0, dcCategory = 0;
    int ctx = txb_skip_ctx(plane, txSz, x4, y4);
    int all_zero = sd.symbol(cdf.txb_skip[txSzCtx][ctx], 2);
    if (all_zero) {
      if (plane == 0) set_tx_types(x4, y4, txSz, DCT_DCT);
    } else {
      if (plane == 0) transform_type(x4, y4, txSz);
      PlaneTxType = compute_tx_type(plane, txSz, x4, y4);
      const uint16_t* scan = get_scan(txSz);
      int eobMultisize = eob_multisize(txSz);
      int ectx = get_tx_class(PlaneTxType) == TX_CLASS_2D ? 0 : 1;
      int eobPt;
      switch (eobMultisize) {
        case 0: eobPt = sd.symbol(cdf.eob16[ptype][ectx], 5) + 1; break;
        case 1: eobPt = sd.symbol(cdf.eob32[ptype][ectx], 6) + 1; break;
        case 2: eobPt = sd.symbol(cdf.eob64[ptype][ectx], 7) + 1; break;
        case 3: eobPt = sd.symbol(cdf.eob128[ptype][ectx], 8) + 1; break;
        case 4: eobPt = sd.symbol(cdf.eob256[ptype][ectx], 9) + 1; break;
        case 5: eobPt = sd.symbol(cdf.eob512[ptype], 10) + 1; break;
        default: eobPt = sd.symbol(cdf.eob1024[ptype], 11) + 1; break;
      }
      eob = (eobPt < 2) ? eobPt : ((1 << (eobPt - 2)) + 1);
      int eobShift = eobPt - 3;
      if (eobShift >= 0) {
        if (sd.symbol(cdf.eob_extra[txSzCtx][ptype][eobPt - 3], 2)) eob += 1 << eobShift;
        for (int i = 1; i < std::max(0, eobPt - 2); i++) {
          eobShift = std::max(0, eobPt - 2) - 1 - i;
          if (sd.literal(1)) eob += 1 << eobShift;
        }
      }
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        if (c == eob - 1) {
          int bctx = get_coeff_base_ctx(txSz, pos, c, true) - 42 + 4;
          level = sd.symbol(cdf.base_eob[txSzCtx][ptype][bctx], 3) + 1;
        } else {
          int bctx = get_coeff_base_ctx(txSz, pos, c, false);
          level = sd.symbol(cdf.base[txSzCtx][ptype][bctx], 4);
        }
        if (level > 2) {
          int brctx = get_br_ctx(txSz, pos);
          for (int idx = 0; idx < 4; idx++) {
            int coeff_br = sd.symbol(cdf.br[std::min(txSzCtx, 3)][ptype][brctx], 4);
            level += coeff_br;
            if (coeff_br < 3) break;
          }
        }
        Quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (Quant[pos] != 0) {
          if (c == 0) {
            sign = sd.symbol(cdf.dc_sign[ptype][dc_sign_ctx(plane, txSz, x4, y4)], 2);
          } else {
            sign = sd.literal(1);
          }
        }
        if (Quant[pos] > 14) {
          int length = 0, bit;
          do {
            length++;
            bit = sd.literal(1);
            if (length > 32) fail(SL_CORRUPT, "AV1 Golomb code too long");
          } while (!bit);
          uint32_t xg = 1;
          for (int i = length - 2; i >= 0; i--) xg = (xg << 1) | sd.literal(1);
          Quant[pos] = (int32_t)(xg + 14);
        }
        if (pos == 0 && Quant[pos] > 0) dcCategory = sign ? 1 : 2;
        Quant[pos] = Quant[pos] & 0xFFFFF;
        culLevel += Quant[pos];
        if (sign) Quant[pos] = -Quant[pos];
      }
      culLevel = std::min(63, culLevel);
    }
    set_coeff_ctx(plane, txSz, x4, y4, culLevel, dcCategory);
    return eob;
  }

  void transform_type(int x4, int y4, int txSz) {
    int set = get_tx_set(txSz);
    int TxType = DCT_DCT;
    int q = segmentation_enabled ? get_qindex(1, segment_id) : base_q_idx;
    if (set > 0 && q > 0 && is_inter) {
      int txSzSqr = Tx_Size_Sqr[txSz];
      if (set == TX_SET_INTER_1) TxType = Tx_Type_Inter_Inv_Set1[sd.symbol(cdf.inter_set1[txSzSqr], 16)];
      else if (set == TX_SET_INTER_2) TxType = Tx_Type_Inter_Inv_Set2[sd.symbol(cdf.inter_set2, 12)];
      else TxType = Tx_Type_Inter_Inv_Set3[sd.symbol(cdf.inter_set3[txSzSqr], 2)];
    } else if (set > 0 && q > 0) {
      int intraDir = intra_tx_dir();
      int txSzSqr = Tx_Size_Sqr[txSz];
      if (set == TX_SET_INTRA_1) TxType = Tx_Type_Intra_Inv_Set1[sd.symbol(cdf.tx_set1[txSzSqr][intraDir], 7)];
      else TxType = Tx_Type_Intra_Inv_Set2[sd.symbol(cdf.tx_set2[txSzSqr][intraDir], 5)];
    }
    set_tx_types(x4, y4, txSz, TxType);
  }
};

int run(const uint8_t* data, size_t size, Decoder& d, bool headers_only, char* err, size_t errlen) {
  try {
    init_tables();
    size_t p = 0;
    while (p < size) {
      uint8_t h = data[p++];
      if (h & 0x80) fail(SL_CORRUPT, "AV1 OBU forbidden bit set");
      int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
      int temporal_id = 0, spatial_id = 0;
      if (ext) {
        if (p >= size) fail(SL_TRUNCATED, "AV1 OBU header ends early");
        uint8_t e = data[p++];
        temporal_id = e >> 5;
        spatial_id = (e >> 3) & 3;
      }
      size_t obu_size = has_size ? (size_t)leb128(data, size, &p) : size - p;
      if (obu_size > size - p) fail(SL_TRUNCATED, "AV1 OBU ends early");
      const uint8_t* obu = data + p;
      p += obu_size;
      if (type == 1) {
        BitReader b(obu, obu_size);
        SequenceHeader s;
        parse_sequence_header(b, s, &d.color_range_bit);
        if (d.color_range_bit >= 0) d.color_range_bit += (int64_t)(obu - data) * 8;
        d.seq = s;
        if (!headers_only) check_supported(d.seq);
      } else if (type == 3 || type == 6) {
        if (d.frame_done) break;
        if (headers_only) {
          if (!d.seq.valid) fail(SL_CORRUPT, "AV1 frame header before the sequence header");
          check_supported(d.seq);
          BitReader b(obu, obu_size);
          d.frame_header(b, temporal_id, spatial_id);
          return SL_OK;
        }
        BitReader b(obu, obu_size);
        d.frame_header(b, temporal_id, spatial_id);
        if (type == 6) {
          b.byte_alignment();
          size_t off = b.pos / 8;
          d.tile_group(obu + off, obu_size - off);
        }
      } else if (type == 4) {
        if (headers_only) continue;
        d.tile_group(obu, obu_size);
      } else if (type == 7 || type == 8) {
        if (type == 8) unsupported("tile list OBUs");
      }
      // temporal delimiters, metadata, padding: nothing to do
    }
    if (!d.seq.valid) fail(SL_CORRUPT, "AV1 item has no sequence header");
    if (!d.frame_done) fail(SL_TRUNCATED, "AV1 item ends before its frame does");
    return SL_OK;
  } catch (const Fail& f) {
    snprintf(err, errlen, "%s", f.msg.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "out of memory");
    return SL_NO_ROOM;
  }
}

}  // namespace

extern "C" {

int sl_av1_info(const uint8_t* obus, size_t size, int32_t* info, char* err, size_t errlen) {
  Decoder d;
  int rc = run(obus, size, d, true, err, errlen);
  if (rc != SL_OK) return rc;
  info[0] = d.FrameWidth;
  info[1] = d.FrameHeight;
  info[2] = d.seq.mono_chrome;
  info[3] = d.seq.BitDepth;
  info[4] = d.seq.subsampling_x;
  info[5] = d.seq.subsampling_y;
  info[6] = d.seq.color_range;
  info[7] = d.seq.matrix_coefficients;
  info[8] = d.base_q_idx;
  info[9] = d.TileCols;
  info[10] = d.TileRows;
  for (int i = 0; i < 4; i++) info[11 + i] = d.loop_filter_level[i];
  info[15] = d.loop_filter_sharpness;
  info[16] = (int32_t)d.color_range_bit;
  info[17] = d.using_qmatrix;
  info[18] = d.qm_y;
  info[19] = d.qm_u;
  info[20] = d.qm_v;
  info[21] = d.grain.apply_grain;
  return SL_OK;
}

int sl_av1_decode(const uint8_t* obus, size_t size, void* y, void* u, void* v, char* err, size_t errlen) {
  Decoder d;
  int rc = run(obus, size, d, false, err, errlen);
  if (rc != SL_OK) return rc;
  int W = d.FrameWidth, H = d.FrameHeight;
  const Plane* out = d.planes;
  std::vector<Plane> grained;
  if (d.grain.apply_grain) {  // on copies: the grain is the output's alone
    grained.assign(d.planes, d.planes + d.seq.NumPlanes);
    try {
      std::unique_ptr<FilmGrain> fg(new FilmGrain(d.grain, d.seq));
      fg->apply(grained.data(), W, H);
    } catch (const Fail& f) {
      snprintf(err, errlen, "%s", f.msg.c_str());
      return f.code;
    }
    out = grained.data();
  }
  auto put = [&](const Plane& P, void* dst, int w, int h) {
    for (int r = 0; r < h; r++) {
      const uint16_t* row = &P.px[(size_t)r * P.stride];
      if (d.seq.BitDepth == 8) std::copy_n(row, w, (uint8_t*)dst + (size_t)r * w);
      else std::copy_n(row, w, (uint16_t*)dst + (size_t)r * w);
    }
  };
  put(out[0], y, W, H);
  if (d.seq.NumPlanes > 1) {
    int cw = (W + d.seq.subsampling_x) >> d.seq.subsampling_x;
    int ch = (H + d.seq.subsampling_y) >> d.seq.subsampling_y;
    put(out[1], u, cw, ch);
    put(out[2], v, cw, ch);
  }
  return SL_OK;
}

int sl_av1_decode_counts(const uint8_t* obus, size_t size, int32_t* counts, char* err, size_t errlen) {
  Decoder d;
  int rc = run(obus, size, d, false, err, errlen);
  if (rc != SL_OK) return rc;
  d.counts[CNT_QM_TX_SIZES] = (int32_t)d.QmTxSizes;
  memcpy(counts, d.counts, sizeof d.counts);
  return SL_OK;
}

const char* sl_av1_count_names() { return Count_Names; }

int sl_av1_wiener(const uint8_t* src, int width, int height, const int8_t* taps, uint8_t* dst) {
  if (width < 1 || height < 1) return SL_CORRUPT;
  Post post;
  LrUnit u;
  u.type = RESTORE_WIENER;
  memcpy(u.wiener, taps, sizeof u.wiener);
  Plane out;
  out.stride = width;
  out.rows = height;
  out.px.assign((size_t)width * height, 0);
  auto at = [&](int x, int y) -> int {
    return src[(size_t)std::max(0, std::min(height - 1, y)) * width + std::max(0, std::min(width - 1, x))];
  };
  post.wiener(u, at, out, 0, 0, width, height, 0);
  std::copy(out.px.begin(), out.px.end(), dst);
  return SL_OK;
}

int sl_av1_read_symbols(const uint8_t* data, size_t size, const int32_t* sizes, const int32_t* offsets,
                        int count, uint16_t* cdfs, int32_t* symbols) {
  SymbolDecoder sd;
  try {
    sd.init(data, size, false);
  } catch (const Fail&) {
    return SL_CORRUPT;
  }
  for (int i = 0; i < count; i++)
    symbols[i] = sizes[i] == 0 ? (int32_t)sd.literal(8) : sd.symbol(cdfs + offsets[i], sizes[i]);
  return SL_OK;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// libyuv's YUV to RGB as libavif calls it: I420 and I422 with bilinear
// chroma upsampling (the "filter" variants), I444 as it is. The chroma
// rows are doubled with the (3, 1)/4 linear filter at the first and, for
// an even height, the last row, and with the (9, 3, 3, 1)/16 bilinear
// filter between; the first and last columns take their chroma sample as
// it is (linear) or in a (3, 1)/4 mix of two rows (bilinear). A 4:2:2 row
// is widened with the linear filter alone. Then libyuv's fixed point
// arithmetic, 6 fraction bits, with the constants of the matrix and range.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
void up_linear(const T* s, int W, int* d) {
  d[0] = s[0];
  int ww = (W - 1) & ~1;
  for (int x = 0; x < ww / 2; x++) {
    d[1 + 2 * x] = (3 * s[x] + s[x + 1] + 2) >> 2;
    d[2 + 2 * x] = (s[x] + 3 * s[x + 1] + 2) >> 2;
  }
  d[W - 1] = s[(W - 1) / 2];
}

template <typename T>
void up_bilinear(const T* sa, const T* sb, int W, int* da, int* db) {
  da[0] = (3 * sa[0] + sb[0] + 2) >> 2;
  db[0] = (sa[0] + 3 * sb[0] + 2) >> 2;
  int ww = (W - 1) & ~1;
  for (int x = 0; x < ww / 2; x++) {
    int s0 = sa[x], s1 = sa[x + 1], t0 = sb[x], t1 = sb[x + 1];
    da[1 + 2 * x] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4;
    da[2 + 2 * x] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4;
    db[1 + 2 * x] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4;
    db[2 + 2 * x] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4;
  }
  int k = (W - 1) / 2;
  da[W - 1] = (3 * sa[k] + sb[k] + 2) >> 2;
  db[W - 1] = (sa[k] + 3 * sb[k] + 2) >> 2;
}

inline uint8_t clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// libyuv's YuvConstants: the scale and bias of Y, and the U and V
// contributions to R, G and B (6 fraction bits)
struct YuvConstants {
  int yg, yb, ub, ug, vg, vr;
};
const YuvConstants kYuvJPEG = {16320, 32, 113, 22, 46, 90};     // BT.601 full range
const YuvConstants kYuvI601 = {18997, -1160, 128, 25, 52, 102};  // BT.601 limited range
const YuvConstants kYuvF709 = {16320, 32, 119, 12, 30, 101};     // BT.709 full range
const YuvConstants kYuvH709 = {18997, -1160, 128, 14, 34, 115};  // BT.709 limited range

void yuv_row(const uint8_t* y, const int* u, const int* v, int W, const YuvConstants& k, uint8_t* rgba) {
  for (int x = 0; x < W; x++) {
    int y1 = (int)(((uint32_t)y[x] * 0x0101 * k.yg) >> 16);
    int uu = u[x] - 128, vv = v[x] - 128;
    rgba[4 * x + 0] = clamp255((y1 + k.vr * vv + k.yb) >> 6);
    rgba[4 * x + 1] = clamp255((y1 - k.ug * uu - k.vg * vv + k.yb) >> 6);
    rgba[4 * x + 2] = clamp255((y1 + k.ub * uu + k.yb) >> 6);
    rgba[4 * x + 3] = 255;
  }
}

// ``row(y, u, v, W, rgba)`` converts one row of samples given its chroma
// upsampled to full width
template <typename T, typename Row>
void yuv420_rows(const T* y, const T* u, const T* v, int width, int height, Row row, uint8_t* rgba) {
  int cw = (width + 1) / 2;
  std::vector<int> u1(width), u2(width), v1(width), v2(width);
  size_t stride = (size_t)width * 4;
  up_linear(u, width, u1.data());
  up_linear(v, width, v1.data());
  row(y, u1.data(), v1.data(), width, rgba);
  int r = 1, k = 0;
  for (int yy = 0; yy < height - 2; yy += 2, k++) {
    up_bilinear(u + (size_t)k * cw, u + (size_t)(k + 1) * cw, width, u1.data(), u2.data());
    up_bilinear(v + (size_t)k * cw, v + (size_t)(k + 1) * cw, width, v1.data(), v2.data());
    row(y + (size_t)r * width, u1.data(), v1.data(), width, rgba + r * stride);
    row(y + (size_t)(r + 1) * width, u2.data(), v2.data(), width, rgba + (r + 1) * stride);
    r += 2;
  }
  if (!(height & 1)) {
    up_linear(u + (size_t)k * cw, width, u1.data());
    up_linear(v + (size_t)k * cw, width, v1.data());
    row(y + (size_t)r * width, u1.data(), v1.data(), width, rgba + r * stride);
  }
}

}  // namespace

extern "C" int sl_avif_yuv_to_rgba(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
                                   int subsampling_x, int subsampling_y, int matrix, int full_range,
                                   uint8_t* rgba) {
  size_t stride = (size_t)width * 4;
  if (matrix == 0) {  // identity (GBR): libavif's own copy, 4:4:4 full range only
    if (subsampling_x || subsampling_y || !full_range) return SL_UNSUPPORTED;
    for (int r = 0; r < height; r++)
      for (int x = 0; x < width; x++) {
        size_t i = (size_t)r * width + x;
        uint8_t* px = rgba + r * stride + 4 * x;
        px[0] = v[i];
        px[1] = y[i];
        px[2] = u[i];
        px[3] = 255;
      }
    return SL_OK;
  }
  const YuvConstants& kc = matrix == 1 ? (full_range ? kYuvF709 : kYuvH709) : (full_range ? kYuvJPEG : kYuvI601);
  if (subsampling_x && subsampling_y) {
    auto row = [&](const uint8_t* yr, const int* ur, const int* vr, int W, uint8_t* out) { yuv_row(yr, ur, vr, W, kc, out); };
    yuv420_rows(y, u, v, width, height, row, rgba);
  } else if (subsampling_x) {
    int cw = (width + 1) / 2;
    std::vector<int> u1(width), v1(width);
    for (int r = 0; r < height; r++) {
      up_linear(u + (size_t)r * cw, width, u1.data());
      up_linear(v + (size_t)r * cw, width, v1.data());
      yuv_row(y + (size_t)r * width, u1.data(), v1.data(), width, kc, rgba + r * stride);
    }
  } else if (!subsampling_y) {
    std::vector<int> u1(width), v1(width);
    for (int r = 0; r < height; r++) {
      for (int x = 0; x < width; x++) {
        u1[x] = u[(size_t)r * width + x];
        v1[x] = v[(size_t)r * width + x];
      }
      yuv_row(y + (size_t)r * width, u1.data(), v1.data(), width, kc, rgba + r * stride);
    }
  } else {
    return SL_UNSUPPORTED;
  }
  return SL_OK;
}

// ---------------------------------------------------------------------------
// the conversions of samples of any depth held as uint16_t: libavif's own
// single-precision path (avifImageYUVAnyToRGBAnySlow: each chroma sample of
// a subsampled plane from its four nearest, weighed 9, 3, 3, 1 / 16, and
// R, G, B from the matrix's kr and kb), and libyuv's rows of 10- and 12-bit
// samples (I010, I210, I410 ToARGBMatrixFilter; I012ToARGBMatrix, whose
// chroma is the nearest sample)
// ---------------------------------------------------------------------------

namespace {

// one output pixel of libavif's path: the channel's value in [0, 1] to an
// integer of ``maxF``
inline int float_out(float c, float maxF) {
  float cl = c < 0.0f ? 0.0f : (c > 1.0f ? 1.0f : c);
  return (int)(0.5f + cl * maxF);
}

template <typename Out>
void float_rows(const uint16_t* y, const uint16_t* u, const uint16_t* v, int W, int H, int depth, int sx, int sy,
                int mono, int matrix, int full, int outDepth, Out* rgba) {
  int maxChannel = (1 << depth) - 1;
  float biasY = full ? 0.0f : (float)(16 << (depth - 8));
  float rangeY = full ? (float)maxChannel : (float)(219 << (depth - 8));
  float biasUV = (float)(1 << (depth - 1));
  float rangeUV = full ? (float)maxChannel : (float)(224 << (depth - 8));
  std::vector<float> tY(maxChannel + 1), tUV(maxChannel + 1);
  for (int i = 0; i <= maxChannel; i++) {
    tY[i] = ((float)i - biasY) / rangeY;
    tUV[i] = ((float)i - biasUV) / rangeUV;
  }
  float kr = matrix == 1 ? 0.2126f : 0.299f, kb = matrix == 1 ? 0.0722f : 0.114f;
  float kg = 1.0f - kr - kb;
  float maxF = (float)((1 << outDepth) - 1);
  int cw = (W + sx) >> sx;
  for (int j = 0; j < H; j++)
    for (int i = 0; i < W; i++) {
      float Y = tY[std::min<int>(y[(size_t)j * W + i], maxChannel)], R, G, B;
      if (mono) {
        R = G = B = Y;
      } else {
        int uvJ = j >> sy, uvI = i >> sx;
        float Cb, Cr;
        auto at = [&](const uint16_t* p, int jj, int ii) { return tUV[std::min<int>(p[(size_t)jj * cw + ii], maxChannel)]; };
        if (!sx && !sy) {
          Cb = at(u, uvJ, uvI);
          Cr = at(v, uvJ, uvI);
        } else {
          int adjCol = (i == 0 || (i == W - 1 && (i % 2) != 0)) ? 0 : ((i % 2) != 0 ? 1 : -1);
          int adjRow = (j == 0 || (j == H - 1 && (j % 2) != 0) || !sy) ? 0 : ((j % 2) != 0 ? 1 : -1);
          Cb = (at(u, uvJ, uvI) * (9.0f / 16.0f)) + (at(u, uvJ, uvI + adjCol) * (3.0f / 16.0f)) +
               (at(u, uvJ + adjRow, uvI) * (3.0f / 16.0f)) + (at(u, uvJ + adjRow, uvI + adjCol) * (1.0f / 16.0f));
          Cr = (at(v, uvJ, uvI) * (9.0f / 16.0f)) + (at(v, uvJ, uvI + adjCol) * (3.0f / 16.0f)) +
               (at(v, uvJ + adjRow, uvI) * (3.0f / 16.0f)) + (at(v, uvJ + adjRow, uvI + adjCol) * (1.0f / 16.0f));
        }
        R = Y + (2 * (1 - kr)) * Cr;
        B = Y + (2 * (1 - kb)) * Cb;
        G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
      }
      Out* px = rgba + ((size_t)j * W + i) * 4;
      px[0] = (Out)float_out(R, maxF);
      px[1] = (Out)float_out(G, maxF);
      px[2] = (Out)float_out(B, maxF);
      px[3] = (Out)((1 << outDepth) - 1);
    }
}

// libyuv's row of 10- or 12-bit samples (YuvPixel10, YuvPixel12): the luma
// widened to 16 bits by repeating its top bits, the chroma narrowed to 8
void yuv16_row(const uint16_t* y, const int* u, const int* v, int W, int depth, const YuvConstants& k,
               uint8_t* rgba) {
  for (int x = 0; x < W; x++) {
    uint32_t y32 = ((uint32_t)y[x] << (16 - depth)) | (y[x] >> (2 * depth - 16));
    int y1 = (int)((y32 * (uint32_t)k.yg) >> 16);
    int uu = std::min(255, u[x] >> (depth - 8)) - 128, vv = std::min(255, v[x] >> (depth - 8)) - 128;
    rgba[4 * x + 0] = clamp255((y1 + k.vr * vv + k.yb) >> 6);
    rgba[4 * x + 1] = clamp255((y1 - k.ug * uu - k.vg * vv + k.yb) >> 6);
    rgba[4 * x + 2] = clamp255((y1 + k.ub * uu + k.yb) >> 6);
    rgba[4 * x + 3] = 255;
  }
}

}  // namespace

extern "C" int sl_avif_yuv16_to_rgba(const uint16_t* y, const uint16_t* u, const uint16_t* v, int width, int height,
                                     int depth, int subsampling_x, int subsampling_y, int monochrome, int matrix,
                                     int full_range, int kind, void* rgba) {
  if (matrix == 0 || depth < 8 || depth > 12) return SL_UNSUPPORTED;
  int sx = subsampling_x, sy = subsampling_y;
  if (kind == 0 || kind == 1) {
    if (kind == 0)
      float_rows(y, u, v, width, height, depth, sx, sy, monochrome, matrix, full_range, 8, (uint8_t*)rgba);
    else
      float_rows(y, u, v, width, height, depth, sx, sy, monochrome, matrix, full_range, depth, (uint16_t*)rgba);
    return SL_OK;
  }
  if (monochrome || depth == 8 || (!sx && sy)) return SL_UNSUPPORTED;
  const YuvConstants& kc = matrix == 1 ? (full_range ? kYuvF709 : kYuvH709) : (full_range ? kYuvJPEG : kYuvI601);
  uint8_t* out = (uint8_t*)rgba;
  size_t stride = (size_t)width * 4;
  int cw = (width + sx) >> sx;
  auto row = [&](const uint16_t* yr, const int* ur, const int* vr, int W, uint8_t* o) {
    yuv16_row(yr, ur, vr, W, depth, kc, o);
  };
  std::vector<int> u1(width), v1(width);
  if (kind == 3 || !sx) {  // the nearest chroma sample (I012), or none to upsample (4:4:4)
    for (int r = 0; r < height; r++) {
      const uint16_t* ur = u + (size_t)(r >> sy) * cw;
      const uint16_t* vr = v + (size_t)(r >> sy) * cw;
      for (int x = 0; x < width; x++) {
        u1[x] = ur[x >> sx];
        v1[x] = vr[x >> sx];
      }
      row(y + (size_t)r * width, u1.data(), v1.data(), width, out + r * stride);
    }
  } else if (sy) {
    yuv420_rows(y, u, v, width, height, row, out);
  } else {
    for (int r = 0; r < height; r++) {
      up_linear(u + (size_t)r * cw, width, u1.data());
      up_linear(v + (size_t)r * cw, width, v1.data());
      row(y + (size_t)r * width, u1.data(), v1.data(), width, out + r * stride);
    }
  }
  return SL_OK;
}
