// CCITT modified Huffman, Group 3 and Group 4 decoding after libtiff 4.7's
// tif_fax3.c / tif_fax3.h (see sl_fax.h).

#include "sl_fax.h"

#include <string.h>

#include <vector>

namespace {

// the states of libtiff's decoding tables (tif_fax3.h)
enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
       S_MakeUp, S_EOL };

struct Ent {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

// T.4's code words as (length, bits), most significant bit first
struct Code {
  int len, bits, run;
};

const Code kWhiteTerm[] = {
    {8, 0x35, 0},   {6, 0x7, 1},    {4, 0x7, 2},    {4, 0x8, 3},    {4, 0xB, 4},    {4, 0xC, 5},
    {4, 0xE, 6},    {4, 0xF, 7},    {5, 0x13, 8},   {5, 0x14, 9},   {5, 0x7, 10},   {5, 0x8, 11},
    {6, 0x8, 12},   {6, 0x3, 13},   {6, 0x34, 14},  {6, 0x35, 15},  {6, 0x2A, 16},  {6, 0x2B, 17},
    {7, 0x27, 18},  {7, 0xC, 19},   {7, 0x8, 20},   {7, 0x17, 21},  {7, 0x3, 22},   {7, 0x4, 23},
    {7, 0x28, 24},  {7, 0x2B, 25},  {7, 0x13, 26},  {7, 0x24, 27},  {7, 0x18, 28},  {8, 0x2, 29},
    {8, 0x3, 30},   {8, 0x1A, 31},  {8, 0x1B, 32},  {8, 0x12, 33},  {8, 0x13, 34},  {8, 0x14, 35},
    {8, 0x15, 36},  {8, 0x16, 37},  {8, 0x17, 38},  {8, 0x28, 39},  {8, 0x29, 40},  {8, 0x2A, 41},
    {8, 0x2B, 42},  {8, 0x2C, 43},  {8, 0x2D, 44},  {8, 0x4, 45},   {8, 0x5, 46},   {8, 0xA, 47},
    {8, 0xB, 48},   {8, 0x52, 49},  {8, 0x53, 50},  {8, 0x54, 51},  {8, 0x55, 52},  {8, 0x24, 53},
    {8, 0x25, 54},  {8, 0x58, 55},  {8, 0x59, 56},  {8, 0x5A, 57},  {8, 0x5B, 58},  {8, 0x4A, 59},
    {8, 0x4B, 60},  {8, 0x32, 61},  {8, 0x33, 62},  {8, 0x34, 63}};
const Code kWhiteMakeUp[] = {
    {5, 0x1B, 64},   {5, 0x12, 128},  {6, 0x17, 192},  {7, 0x37, 256},  {8, 0x36, 320},
    {8, 0x37, 384},  {8, 0x64, 448},  {8, 0x65, 512},  {8, 0x68, 576},  {8, 0x67, 640},
    {9, 0xCC, 704},  {9, 0xCD, 768},  {9, 0xD2, 832},  {9, 0xD3, 896},  {9, 0xD4, 960},
    {9, 0xD5, 1024}, {9, 0xD6, 1088}, {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280},
    {9, 0xDA, 1344}, {9, 0xDB, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536}, {9, 0x9A, 1600},
    {6, 0x18, 1664}, {9, 0x9B, 1728}};
const Code kBlackTerm[] = {
    {10, 0x37, 0},  {3, 0x2, 1},    {2, 0x3, 2},    {2, 0x2, 3},    {3, 0x3, 4},    {4, 0x3, 5},
    {4, 0x2, 6},    {5, 0x3, 7},    {6, 0x5, 8},    {6, 0x4, 9},    {7, 0x4, 10},   {7, 0x5, 11},
    {7, 0x7, 12},   {8, 0x4, 13},   {8, 0x7, 14},   {9, 0x18, 15},  {10, 0x17, 16}, {10, 0x18, 17},
    {10, 0x8, 18},  {11, 0x67, 19}, {11, 0x68, 20}, {11, 0x6C, 21}, {11, 0x37, 22}, {11, 0x28, 23},
    {11, 0x17, 24}, {11, 0x18, 25}, {12, 0xCA, 26}, {12, 0xCB, 27}, {12, 0xCC, 28}, {12, 0xCD, 29},
    {12, 0x68, 30}, {12, 0x69, 31}, {12, 0x6A, 32}, {12, 0x6B, 33}, {12, 0xD2, 34}, {12, 0xD3, 35},
    {12, 0xD4, 36}, {12, 0xD5, 37}, {12, 0xD6, 38}, {12, 0xD7, 39}, {12, 0x6C, 40}, {12, 0x6D, 41},
    {12, 0xDA, 42}, {12, 0xDB, 43}, {12, 0x54, 44}, {12, 0x55, 45}, {12, 0x56, 46}, {12, 0x57, 47},
    {12, 0x64, 48}, {12, 0x65, 49}, {12, 0x52, 50}, {12, 0x53, 51}, {12, 0x24, 52}, {12, 0x37, 53},
    {12, 0x38, 54}, {12, 0x27, 55}, {12, 0x28, 56}, {12, 0x58, 57}, {12, 0x59, 58}, {12, 0x2B, 59},
    {12, 0x2C, 60}, {12, 0x5A, 61}, {12, 0x66, 62}, {12, 0x67, 63}};
const Code kBlackMakeUp[] = {
    {10, 0xF, 64},    {12, 0xC8, 128},  {12, 0xC9, 192},  {12, 0x5B, 256},  {12, 0x33, 320},
    {12, 0x34, 384},  {12, 0x35, 448},  {13, 0x6C, 512},  {13, 0x6D, 576},  {13, 0x4A, 640},
    {13, 0x4B, 704},  {13, 0x4C, 768},  {13, 0x4D, 832},  {13, 0x72, 896},  {13, 0x73, 960},
    {13, 0x74, 1024}, {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280},
    {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536}, {13, 0x5B, 1600},
    {13, 0x64, 1664}, {13, 0x65, 1728}};
// the extended make-up codes both colours share
const Code kMakeUp[] = {
    {11, 0x8, 1792},  {11, 0xC, 1856},  {11, 0xD, 1920},  {12, 0x12, 1984}, {12, 0x13, 2048},
    {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304}, {12, 0x1C, 2368},
    {12, 0x1D, 2432}, {12, 0x1E, 2496}, {12, 0x1F, 2560}};

struct Tables {
  std::vector<Ent> white, black, main;  // 12, 13 and 7-bit lookups, bits read first lowest

  static int reverse(int bits, int len) {
    int r = 0;
    for (int i = 0; i < len; i++) r |= ((bits >> i) & 1) << (len - 1 - i);
    return r;
  }
  static void put(std::vector<Ent>& t, int wid, int len, int bits, int state, int param) {
    int rev = reverse(bits, len);
    for (int hi = 0; hi < (1 << (wid - len)); hi++) {
      Ent& e = t[rev | (hi << len)];
      e.state = uint8_t(state);
      e.width = uint8_t(len);
      e.param = param;
    }
  }
  Tables() : white(1 << 12), black(1 << 13), main(1 << 7) {
    for (const Code& c : kWhiteTerm) put(white, 12, c.len, c.bits, S_TermW, c.run);
    for (const Code& c : kWhiteMakeUp) put(white, 12, c.len, c.bits, S_MakeUpW, c.run);
    for (const Code& c : kBlackTerm) put(black, 13, c.len, c.bits, S_TermB, c.run);
    for (const Code& c : kBlackMakeUp) put(black, 13, c.len, c.bits, S_MakeUpB, c.run);
    for (const Code& c : kMakeUp) {
      put(white, 12, c.len, c.bits, S_MakeUp, c.run);
      put(black, 13, c.len, c.bits, S_MakeUp, c.run);
    }
    put(white, 12, 12, 1, S_EOL, 0);
    put(black, 13, 12, 1, S_EOL, 0);
    put(main, 7, 4, 0x1, S_Pass, 0);
    put(main, 7, 3, 0x1, S_Horiz, 0);
    put(main, 7, 1, 0x1, S_V0, 0);
    put(main, 7, 3, 0x3, S_VR, 1);
    put(main, 7, 6, 0x3, S_VR, 2);
    put(main, 7, 7, 0x3, S_VR, 3);
    put(main, 7, 3, 0x2, S_VL, 1);
    put(main, 7, 6, 0x2, S_VL, 2);
    put(main, 7, 7, 0x2, S_VL, 3);
    put(main, 7, 7, 0x1, S_Ext, 0);
    put(main, 7, 7, 0x0, S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct Eof {};       // the data ends (libtiff's eoflab)
struct Overflow {};  // a run array overflows (libtiff returns -1)

struct Decoder {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  int lastx;
  size_t nruns;
  std::vector<uint32_t> cur, ref;
  // the current row: its run array, the next run slot, a0 and the pending run
  uint32_t* thisrun = nullptr;
  uint32_t* pa = nullptr;
  int a0 = 0, run_length = 0;
  const uint8_t* rev;

  Decoder(const uint8_t* d, size_t n, int width, bool two_d, const uint8_t* bitrev)
      : cp(d), ep(d + n), lastx(width), rev(bitrev) {
    nruns = ((size_t(width) + 1 + 31) / 32) * 32;  // TIFFroundup_32(rowpixels + 1, 32)
    if (two_d) nruns *= 2;
    cur.assign(nruns, 0);
    ref.assign(two_d ? nruns : 0, 0);
    if (two_d) {
      ref[0] = uint32_t(width);
      ref[1] = 0;
    }
  }

  bool end() const { return cp >= ep; }
  // NeedBits8 / NeedBits16: the data's end pads with zeros, once a bit is left
  void need8(int n) {
    if (avail < n) {
      if (end()) {
        if (avail == 0) throw Eof();
        avail = n;
      } else {
        acc |= uint32_t(rev[*cp++]) << avail;
        avail += 8;
      }
    }
  }
  void need16(int n) {
    if (avail < n) {
      if (end()) {
        if (avail == 0) throw Eof();
        avail = n;
      } else {
        acc |= uint32_t(rev[*cp++]) << avail;
        if ((avail += 8) < n) {
          if (end()) {
            avail = n;
          } else {
            acc |= uint32_t(rev[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  const Ent& lookup8(int wid, const std::vector<Ent>& t) {
    need8(wid);
    const Ent& e = t[get(wid)];
    clr(e.width);
    return e;
  }
  const Ent& lookup16(int wid, const std::vector<Ent>& t) {
    need16(wid);
    const Ent& e = t[get(wid)];
    clr(e.width);
    return e;
  }

  void setvalue(int x) {
    if (pa >= thisrun + nruns) throw Overflow();
    *pa++ = uint32_t(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup_runs() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= int(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }

  void sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        need16(11);
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need8(8);
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
  }

  // a colour's run (make-up codes, then its terminating code): false at an
  // EOL or a bad code, after which libtiff ends the row
  enum { RUN_DONE, RUN_EOL, RUN_BAD };
  int run(bool white) {
    const Tables& T = tables();
    for (;;) {
      const Ent& e = white ? lookup16(12, T.white) : lookup16(13, T.black);
      switch (e.state) {
        case S_EOL:
          return RUN_EOL;
        case S_TermW:
        case S_TermB:
          if ((e.state == S_TermW) != white) return RUN_BAD;
          setvalue(e.param);
          return RUN_DONE;
        case S_MakeUpW:
        case S_MakeUpB:
          if ((e.state == S_MakeUpW) != white) return RUN_BAD;
          [[fallthrough]];
        case S_MakeUp:
          a0 += e.param;
          run_length += e.param;
          break;
        default:
          return RUN_BAD;
      }
    }
  }

  // EXPAND1D: throws Eof after CLEANUP_RUNS, as its eof1d label does
  void expand1d() {
    try {
      for (;;) {
        int r = run(true);
        if (r == RUN_EOL) eolcnt = 1;
        if (r != RUN_DONE || a0 >= lastx) break;
        r = run(false);
        if (r == RUN_EOL) eolcnt = 1;
        if (r != RUN_DONE || a0 >= lastx) break;
        if (pa - thisrun >= 2 && *(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }

  // EXPAND2D against the reference runs; throws Eof after CLEANUP_RUNS
  void expand2d() {
    const Tables& T = tables();
    uint32_t* refbase = ref.data();
    uint32_t* pb = refbase;
    int b1 = int(*pb++);
    auto check_b1 = [&]() {
      if (pa != thisrun)
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= refbase + nruns) throw Overflow();
          b1 += int(pb[0] + pb[1]);
          pb += 2;
        }
    };
    try {
      while (a0 < lastx) {
        if (pa >= thisrun + nruns) throw Overflow();
        const Ent& e = lookup8(7, T.main);
        switch (e.state) {
          case S_Pass:
            check_b1();
            if (pb + 1 >= refbase + nruns) throw Overflow();
            b1 += int(*pb++);
            run_length += b1 - a0;
            a0 = b1;
            b1 += int(*pb++);
            break;
          case S_Horiz: {
            bool black_first = (pa - thisrun) & 1;
            if (run(!black_first) != RUN_DONE) goto eol2d;
            if (run(black_first) != RUN_DONE) goto eol2d;
            check_b1();
            break;
          }
          case S_V0:
            check_b1();
            setvalue(b1 - a0);
            if (pb >= refbase + nruns) throw Overflow();
            b1 += int(*pb++);
            break;
          case S_VR:
            check_b1();
            setvalue(b1 - a0 + e.param);
            if (pb >= refbase + nruns) throw Overflow();
            b1 += int(*pb++);
            break;
          case S_VL:
            check_b1();
            if (b1 < a0 + e.param) goto eol2d;
            setvalue(b1 - a0 - e.param);
            b1 -= int(*--pb);
            break;
          case S_Ext:
            *pa++ = uint32_t(lastx - a0);
            goto eol2d;
          case S_EOL:
            *pa++ = uint32_t(lastx - a0);
            need8(4);
            clr(4);
            eolcnt = 1;
            goto eol2d;
          default:
            goto eol2d;
        }
      }
      if (run_length) {
        if (run_length + a0 < lastx) {  // expect a final V0
          need8(1);
          if (!get(1)) goto eol2d;
          clr(1);
        }
        setvalue(0);
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
  eol2d:
    cleanup_runs();
  }

  // _TIFFFax3fillruns: white runs 0, black runs 1; a run past the row is
  // clamped in the run array itself
  void fill(uint8_t* buf) {
    uint32_t* runs = thisrun;
    uint32_t* erun = pa;
    if (((erun - runs) & 1) && erun < thisrun + nruns) *erun++ = 0;
    int x = 0;
    for (; runs < erun; runs += 2) {
      for (int k = 0; k < 2; k++) {
        uint32_t r = runs[k];
        if (uint32_t(x) + r > uint32_t(lastx) || r > uint32_t(lastx)) r = runs[k] = lastx - x;
        if (k == 1)
          for (uint32_t i = 0; i < r; i++) buf[(x + i) >> 3] |= uint8_t(0x80 >> ((x + i) & 7));
        x += int(r);
      }
    }
  }
};

}  // namespace

extern "C" {

int sl_fax_decode(const uint8_t* data, size_t size, int mode, int width, int rows,
                  int t4options, uint8_t* out, int* rows_done) {
  static uint8_t bitrev[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) bitrev[i] = uint8_t(Tables::reverse(i, 8));
    init = true;
  }
  *rows_done = 0;
  if (width <= 0 || rows <= 0) return 0;
  size_t row_bytes = (size_t(width) + 7) / 8;
  memset(out, 0, row_bytes * size_t(rows));
  bool two_d = mode == 4 || (mode == 3 && (t4options & 1));
  Decoder d(data, size, width, two_d, bitrev);
  int line = 0;
  uint8_t* buf = out;
  try {
    for (; line < rows; line++, buf += row_bytes) {
      d.a0 = 0;
      d.run_length = 0;
      d.pa = d.thisrun = d.cur.data();
      bool is1d = true;
      try {
        if (mode == 3) {
          d.sync_eol();
          if (two_d) {
            d.need8(1);
            is1d = d.get(1);
            d.clr(1);
          }
        }
        if (mode == 4 || !is1d)
          d.expand2d();
        else
          d.expand1d();
      } catch (const Eof&) {
        d.fill(buf);
        *rows_done = line + 1;
        // libtiff 4.7 forgives a Group 3 strip that ends early (the rows
        // after stay white) and a Group 4 one once a row is done
        if (mode == 3) return 0;
        return mode == 4 && line > 0 ? 0 : 1;
      }
      if (mode == 4 && d.eolcnt) {  // an EOL (the EOFB) ends a Group 4 strip
        d.fill(buf);
        *rows_done = line + 1;
        return line > 0 ? 0 : 1;
      }
      d.fill(buf);
      if (two_d) {
        if (d.pa < d.thisrun + d.nruns) d.setvalue(0);  // imaginary change for reference
        std::swap(d.cur, d.ref);
      }
      if (mode == 2) d.clr(d.avail - (d.avail & ~7));  // rows start on a byte
      *rows_done = line + 1;
    }
  } catch (const Overflow&) {
    *rows_done = line;
    return 2;
  }
  return 0;
}

}  // extern "C"
