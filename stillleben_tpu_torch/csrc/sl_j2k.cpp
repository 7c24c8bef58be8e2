// JPEG 2000 codestreams both ways (see sl_j2k.h): written as OpenJPEG 2.5.4
// codes them at Pillow's defaults, read as OpenJPEG 2.5.4 reads every
// stream Pillow's save writes at any of its options. The stages follow
// ISO/IEC 15444-1: the DC level shift, the colour transforms (the RCT and
// the ICT), the reversible 5/3 and irreversible 9/7 lifting with symmetric
// extension at any origin (Annex F), the dequantisation (Annex E), the
// code-block coder with its three passes per bitplane over the MQ coder
// (Annexes C and D), the packets with their tag trees, layers, precincts
// and five progression orders (Annex B) and the marker segments (Annex A).
// Where the standard leaves the encoder a choice, OpenJPEG's is taken: the
// MQ coder's flush (opj_mqc_flush), the termination of the last pass only,
// one layer of every pass, the packet header's leading 1 bit even for a
// packet that includes nothing. Where it leaves the decoder one, OpenJPEG's
// is taken too: its single-precision 9/7 constants and their order, the
// step size without the band's gain beside a 2/K high-pass scaling, and
// lrintf's rounding at the DC shift.

#include "sl_j2k.h"

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct J2kError {
    int code;
    std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw J2kError{code, msg}; }

int floorlog2(uint32_t v) {
    int l = 0;
    while (v >>= 1) ++l;
    return l;
}

// ceil(v / 2^n), v of either sign (opj_int64_ceildivpow2)
int64_t ceil_pow2(int64_t v, int n) { return (v + ((int64_t)1 << n) - 1) >> n; }

// ---------------------------------------------------------------------------
// The MQ coder (Annex C)
// ---------------------------------------------------------------------------

struct MqState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};

const MqState MQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

struct Ctx {
    uint8_t idx, mps;
};

// the code-block coder's 19 contexts (Table D.7's initial states)
enum { CX_ZC = 0, CX_SC = 9, CX_MAG = 14, CX_AGG = 17, CX_UNI = 18, NCX = 19 };

void reset_contexts(Ctx* cx) {
    for (int i = 0; i < NCX; ++i) cx[i] = {0, 0};
    cx[CX_UNI].idx = 46;
    cx[CX_AGG].idx = 3;
    cx[CX_ZC].idx = 4;
}

struct MqEncoder {
    std::vector<uint8_t> buf;  // buf[0] stands before the stream, as OpenJPEG's start - 1
    size_t bp = 0;
    uint32_t a = 0, c = 0;
    int ct = 0;

    void init() {
        buf.assign(1, 0);
        bp = 0;
        a = 0x8000;
        c = 0;
        ct = 12;
    }
    void put(uint8_t v) {
        ++bp;
        if (bp >= buf.size()) buf.resize(bp + 1);
        buf[bp] = v;
    }
    void byteout() {
        if (buf[bp] == 0xff) {
            put((uint8_t)(c >> 20));
            c &= 0xfffff;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            put((uint8_t)(c >> 19));
            c &= 0x7ffff;
            ct = 8;
        } else {
            buf[bp]++;
            if (buf[bp] == 0xff) {
                c &= 0x7ffffff;
                put((uint8_t)(c >> 20));
                c &= 0xfffff;
                ct = 7;
            } else {
                put((uint8_t)(c >> 19));
                c &= 0x7ffff;
                ct = 8;
            }
        }
    }
    void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while ((a & 0x8000) == 0);
    }
    void encode(Ctx& cx, int d) {
        const MqState& s = MQ[cx.idx];
        a -= s.qe;
        if (d == cx.mps) {
            if ((a & 0x8000) == 0) {
                if (a < s.qe)
                    a = s.qe;
                else
                    c += s.qe;
                cx.idx = s.nmps;
                renorm();
            } else {
                c += s.qe;
            }
        } else {
            if (a < s.qe)
                c += s.qe;
            else
                a = s.qe;
            if (s.sw) cx.mps ^= 1;
            cx.idx = s.nlps;
            renorm();
        }
    }
    // opj_mqc_flush: SETBITS, two bytes out, and no pass ends on 0xFF
    void flush() {
        uint32_t tempc = c + a;
        c |= 0xffff;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        if (buf[bp] != 0xff) ++bp;
    }
    size_t numbytes() const { return bp - 1; }
};

struct MqDecoder {
    std::vector<uint8_t> data;  // the segment and two 0xFF bytes
    size_t bp = 0;
    uint32_t a = 0, c = 0;
    int ct = 0;

    void init(const uint8_t* p, size_t n) {
        data.assign(p, p + n);
        data.push_back(0xff);
        data.push_back(0xff);
        bp = 0;
        c = n == 0 ? (0xffu << 16) : ((uint32_t)data[0] << 16);
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void bytein() {
        uint32_t next = data[std::min(bp + 1, data.size() - 1)];
        if (data[bp] == 0xff) {
            if (next > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += next << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += next << 8;
            ct = 8;
        }
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    int decode(Ctx& cx) {
        const MqState& s = MQ[cx.idx];
        int d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                a = s.qe;
                d = cx.mps;
                cx.idx = s.nmps;
            } else {
                a = s.qe;
                d = 1 - cx.mps;
                if (s.sw) cx.mps ^= 1;
                cx.idx = s.nlps;
            }
            renorm();
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    d = 1 - cx.mps;
                    if (s.sw) cx.mps ^= 1;
                    cx.idx = s.nlps;
                } else {
                    d = cx.mps;
                    cx.idx = s.nmps;
                }
                renorm();
            } else {
                d = cx.mps;
            }
        }
        return d;
    }
};

// ---------------------------------------------------------------------------
// The code-block coder (Annex D)
// ---------------------------------------------------------------------------

enum : uint8_t { F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REFINED = 8 };

// the subband whose horizontal and vertical neighbours trade places in the
// significance contexts (Table D.1): HL, the horizontally high-pass band
const int SWAP_ORIENT = 1;

struct Flags {
    int w, h, stride;
    std::vector<uint8_t> f;  // (h + 2) x (w + 2), a border of zeros around the block
    void init(int w_, int h_) {
        w = w_;
        h = h_;
        stride = w + 2;
        f.assign((size_t)(h + 2) * stride, 0);
    }
    uint8_t* at(int x, int y) { return &f[(size_t)(y + 1) * stride + x + 1]; }
};

inline bool sig_neighbour(const uint8_t* f, int s) {
    return ((f[-1] | f[1] | f[-s] | f[s] | f[-s - 1] | f[-s + 1] | f[s - 1] | f[s + 1]) & F_SIG) != 0;
}

inline int zc_context(const uint8_t* f, int s, int orient) {
    int h = (f[-1] & F_SIG) + (f[1] & F_SIG);
    int v = (f[-s] & F_SIG) + (f[s] & F_SIG);
    int d = (f[-s - 1] & F_SIG) + (f[-s + 1] & F_SIG) + (f[s - 1] & F_SIG) + (f[s + 1] & F_SIG);
    int n;
    if (orient == 3) {
        int hv = h + v;
        if (d == 0)
            n = hv == 0 ? 0 : (hv == 1 ? 1 : 2);
        else if (d == 1)
            n = hv == 0 ? 3 : (hv == 1 ? 4 : 5);
        else if (d == 2)
            n = hv == 0 ? 6 : 7;
        else
            n = 8;
    } else {
        if (orient == SWAP_ORIENT) std::swap(h, v);
        if (h == 0) {
            if (v == 0)
                n = d == 0 ? 0 : (d == 1 ? 1 : 2);
            else
                n = v == 1 ? 3 : 4;
        } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
        } else {
            n = 8;
        }
    }
    return CX_ZC + n;
}

inline int contribution(uint8_t f) { return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0; }

// Table D.3: the sign's context and the bit it is XORed with
inline int sc_context(const uint8_t* f, int s, int* xorbit) {
    int hc = std::max(-1, std::min(1, contribution(f[-1]) + contribution(f[1])));
    int vc = std::max(-1, std::min(1, contribution(f[-s]) + contribution(f[s])));
    if (hc < 0) {
        hc = -hc;
        vc = -vc;
        *xorbit = 1;
    } else if (hc == 0 && vc < 0) {
        vc = -vc;
        *xorbit = 1;
    } else {
        *xorbit = 0;
    }
    // hc in {0, 1}; vc in {-1, 0, 1} (hc 1) or {0, 1} (hc 0)
    int n = hc == 0 ? vc : 3 + vc;
    return CX_SC + n;
}

inline int mag_context(const uint8_t* f, int s) {
    if (*f & F_REFINED) return CX_MAG + 2;
    return CX_MAG + (sig_neighbour(f, s) ? 1 : 0);
}

struct CodedBlock {
    int numbps = 0;  // magnitude bitplanes
    int passes = 0;
    std::vector<uint8_t> data;
};

// One code-block of ``w`` x ``h`` coefficients (row stride ``stride``) in
// subband ``orient`` (0 LL, 1 HL, 2 LH, 3 HH): every pass, the last one
// terminated, as opj_t1_encode_cblk codes it.
CodedBlock encode_block(const int32_t* coef, int stride, int w, int h, int orient) {
    CodedBlock out;
    std::vector<uint32_t> mag((size_t)w * h);
    uint32_t maxmag = 0;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int32_t v = coef[(size_t)y * stride + x];
            uint32_t m = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
            mag[(size_t)y * w + x] = m;
            maxmag = std::max(maxmag, m);
        }
    if (maxmag == 0) return out;
    out.numbps = floorlog2(maxmag) + 1;
    Flags fl;
    fl.init(w, h);
    const int s = fl.stride;
    Ctx cx[NCX];
    reset_contexts(cx);
    MqEncoder mq;
    mq.init();

    auto code_sign = [&](uint8_t* f, int x, int y) {
        int xr;
        int ctx = sc_context(f, s, &xr);
        int neg = coef[(size_t)y * stride + x] < 0;
        mq.encode(cx[ctx], neg ^ xr);
        *f |= F_SIG | (neg ? F_NEG : 0);
    };

    int passtype = 2;
    for (int bpno = out.numbps - 1; bpno >= 0;) {
        if (passtype == 0) {  // significance propagation
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; ++x)
                    for (int y = k; y < std::min(k + 4, h); ++y) {
                        uint8_t* f = fl.at(x, y);
                        if ((*f & F_SIG) || !sig_neighbour(f, s)) continue;
                        int v = (mag[(size_t)y * w + x] >> bpno) & 1;
                        mq.encode(cx[zc_context(f, s, orient)], v);
                        if (v) code_sign(f, x, y);
                        *f |= F_VISIT;
                    }
        } else if (passtype == 1) {  // magnitude refinement
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; ++x)
                    for (int y = k; y < std::min(k + 4, h); ++y) {
                        uint8_t* f = fl.at(x, y);
                        if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
                        mq.encode(cx[mag_context(f, s)], (mag[(size_t)y * w + x] >> bpno) & 1);
                        *f |= F_REFINED;
                    }
        } else {  // cleanup, with the run-length mode on whole columns of four
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; ++x) {
                    int runlen = 0;
                    bool agg = false;
                    if (k + 4 <= h) {
                        agg = true;
                        for (int y = k; y < k + 4 && agg; ++y) {
                            uint8_t* f = fl.at(x, y);
                            agg = !(*f & (F_SIG | F_VISIT)) && !sig_neighbour(f, s);
                        }
                    }
                    if (agg) {
                        while (runlen < 4 && !((mag[(size_t)(k + runlen) * w + x] >> bpno) & 1))
                            ++runlen;
                        mq.encode(cx[CX_AGG], runlen != 4);
                        if (runlen == 4) continue;
                        mq.encode(cx[CX_UNI], runlen >> 1);
                        mq.encode(cx[CX_UNI], runlen & 1);
                    }
                    for (int y = k + runlen; y < std::min(k + 4, h); ++y) {
                        uint8_t* f = fl.at(x, y);
                        if (agg && y == k + runlen) {
                            code_sign(f, x, y);
                        } else if (!(*f & (F_SIG | F_VISIT))) {
                            int v = (mag[(size_t)y * w + x] >> bpno) & 1;
                            mq.encode(cx[zc_context(f, s, orient)], v);
                            if (v) code_sign(f, x, y);
                        }
                        *f &= ~F_VISIT;
                    }
                }
        }
        ++out.passes;
        if (++passtype == 3) {
            passtype = 0;
            --bpno;
        }
    }
    mq.flush();
    out.data.assign(mq.buf.begin() + 1, mq.buf.begin() + 1 + mq.numbytes());
    return out;
}

// The inverse of ``encode_block``: ``passes`` passes from ``numbps``
// bitplanes down, into ``out`` (``w`` x ``h``, row stride ``stride``) as
// OpenJPEG's opj_t1_decode_cblk leaves them: each value twice the
// magnitude decoded plus the half step of the bitplanes not decoded, with
// its sign (the reversible path halves it towards zero, the irreversible
// one scales it by half the step size).
void decode_block(const uint8_t* data, size_t size, int numbps, int passes, int32_t* out,
                  int stride, int w, int h, int orient) {
    for (int y = 0; y < h; ++y) std::fill(out + (size_t)y * stride, out + (size_t)y * stride + w, 0);
    if (passes == 0 || numbps <= 0) return;
    if (numbps > 30) fail(SL_CORRUPT, "a code-block of more than 30 bitplanes");
    Flags fl;
    fl.init(w, h);
    const int s = fl.stride;
    std::vector<int32_t> mag((size_t)w * h, 0);
    Ctx cx[NCX];
    reset_contexts(cx);
    MqDecoder mq;
    mq.init(data, size);

    int passtype = 2;
    int plane = numbps;  // OpenJPEG's bpno_plus_one: the bit below is the half step
    auto become_significant = [&](uint8_t* f, int x, int y) {
        int xr;
        int ctx = sc_context(f, s, &xr);
        int neg = mq.decode(cx[ctx]) ^ xr;
        *f |= F_SIG | (neg ? F_NEG : 0);
        mag[(size_t)y * w + x] = (1 << plane) | (1 << (plane - 1));
    };
    for (int p = 0; p < passes && plane >= 1; ++p) {
        if (passtype == 0) {
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; ++x)
                    for (int y = k; y < std::min(k + 4, h); ++y) {
                        uint8_t* f = fl.at(x, y);
                        if ((*f & F_SIG) || !sig_neighbour(f, s)) continue;
                        if (mq.decode(cx[zc_context(f, s, orient)])) become_significant(f, x, y);
                        *f |= F_VISIT;
                    }
        } else if (passtype == 1) {
            const int half = 1 << (plane - 1);
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; ++x)
                    for (int y = k; y < std::min(k + 4, h); ++y) {
                        uint8_t* f = fl.at(x, y);
                        if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
                        int v = mq.decode(cx[mag_context(f, s)]);
                        mag[(size_t)y * w + x] += v ? half : -half;
                        *f |= F_REFINED;
                    }
        } else {
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; ++x) {
                    int runlen = 0;
                    bool agg = false;
                    if (k + 4 <= h) {
                        agg = true;
                        for (int y = k; y < k + 4 && agg; ++y) {
                            uint8_t* f = fl.at(x, y);
                            agg = !(*f & (F_SIG | F_VISIT)) && !sig_neighbour(f, s);
                        }
                    }
                    if (agg) {
                        if (!mq.decode(cx[CX_AGG])) continue;
                        runlen = mq.decode(cx[CX_UNI]) << 1;
                        runlen |= mq.decode(cx[CX_UNI]);
                    }
                    for (int y = k + runlen; y < std::min(k + 4, h); ++y) {
                        uint8_t* f = fl.at(x, y);
                        if (agg && y == k + runlen) {
                            become_significant(f, x, y);
                        } else if (!(*f & (F_SIG | F_VISIT))) {
                            if (mq.decode(cx[zc_context(f, s, orient)])) become_significant(f, x, y);
                        }
                        *f &= ~F_VISIT;
                    }
                }
        }
        if (++passtype == 3) {
            passtype = 0;
            --plane;
        }
    }
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int32_t m = mag[(size_t)y * w + x];
            out[(size_t)y * stride + x] = (*fl.at(x, y) & F_NEG) ? -m : m;
        }
}

// ---------------------------------------------------------------------------
// The forward reversible 5/3 wavelet (Annex F), origin 0
// ---------------------------------------------------------------------------

// one line of ``n`` samples ``stride`` apart: lifting, then the low half
// first
void dwt53_forward_line(int32_t* x, int n, int stride, std::vector<int32_t>& tmp) {
    if (n < 2) return;
    const int sn = (n + 1) / 2, dn = n / 2;
    tmp.resize(n);
    for (int i = 0; i < n; ++i) tmp[i] = x[(size_t)i * stride];
    auto S = [&](int i) { return tmp[2 * std::max(0, std::min(sn - 1, i))]; };
    std::vector<int32_t> d(dn), s(sn);
    for (int i = 0; i < dn; ++i) d[i] = tmp[2 * i + 1] - ((S(i) + S(i + 1)) >> 1);
    auto D = [&](int i) { return d[std::max(0, std::min(dn - 1, i))]; };
    for (int i = 0; i < sn; ++i) s[i] = tmp[2 * i] + ((D(i - 1) + D(i) + 2) >> 2);
    for (int i = 0; i < sn; ++i) x[(size_t)i * stride] = s[i];
    for (int i = 0; i < dn; ++i) x[(size_t)(sn + i) * stride] = d[i];
}

// ``levels`` decompositions of a ``w`` x ``h`` plane: each level's columns,
// then its rows (opj_dwt_encode)
void dwt53_forward(int32_t* plane, int w, int h, int levels) {
    std::vector<int32_t> tmp;
    for (int l = 0; l < levels; ++l) {
        int rw = (int)ceil_pow2(w, l), rh = (int)ceil_pow2(h, l);
        for (int x = 0; x < rw; ++x) dwt53_forward_line(plane + x, rh, w, tmp);
        for (int y = 0; y < rh; ++y) dwt53_forward_line(plane + (size_t)y * w, rw, 1, tmp);
    }
}

// ---------------------------------------------------------------------------
// Subbands and code-blocks
// ---------------------------------------------------------------------------

struct Band {
    int x0, y0, w, h;  // in the plane after the transform
    int orient;        // 0 LL, 1 HL, 2 LH, 3 HH
};

// the bands of resolution ``r`` (0 = the lowest) of a ``w`` x ``h`` plane
// after ``levels`` decompositions, in codestream order
std::vector<Band> bands_of(int w, int h, int levels, int r) {
    if (r == 0) return {{0, 0, (int)ceil_pow2(w, levels), (int)ceil_pow2(h, levels), 0}};
    const int n = levels - r + 1;  // the decomposition level
    const int rw = (int)ceil_pow2(w, n - 1), rh = (int)ceil_pow2(h, n - 1);
    const int lw = (int)ceil_pow2(w, n), lh = (int)ceil_pow2(h, n);
    return {{lw, 0, rw - lw, lh, 1}, {0, lh, lw, rh - lh, 2}, {lw, lh, rw - lw, rh - lh, 3}};
}

// ---------------------------------------------------------------------------
// Tag trees and the packet header's bits (Annex B)
// ---------------------------------------------------------------------------

struct TagTree {
    struct Node {
        int parent;
        int value, low;
        bool known;
    };
    std::vector<Node> nodes;

    void init(int w, int h) {
        nodes.clear();
        std::vector<int> lw{w}, lh{h};
        while ((size_t)lw.back() * lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        std::vector<int> base(lw.size());
        int total = 0;
        for (size_t k = 0; k < lw.size(); ++k) {
            base[k] = total;
            total += lw[k] * lh[k];
        }
        nodes.assign(total, {-1, 999, 0, false});
        for (size_t k = 0; k + 1 < lw.size(); ++k)
            for (int j = 0; j < lh[k]; ++j)
                for (int i = 0; i < lw[k]; ++i)
                    nodes[base[k] + j * lw[k] + i].parent = base[k + 1] + (j / 2) * lw[k + 1] + i / 2;
    }
    void set_value(int leaf, int value) {
        for (int n = leaf; n >= 0 && nodes[n].value > value; n = nodes[n].parent) nodes[n].value = value;
    }
    std::vector<int> path(int leaf) const {
        std::vector<int> p;
        for (int n = leaf; n >= 0; n = nodes[n].parent) p.push_back(n);
        return p;  // leaf first, root last
    }
};

struct BitWriter {  // opj_bio: a byte after 0xFF carries 7 bits
    std::vector<uint8_t>& out;
    uint32_t buf = 0;
    int ct = 8;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void byteout() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        out.push_back((uint8_t)(buf >> 8));
    }
    void bit(int b) {
        if (ct == 0) byteout();
        ct--;
        buf |= (uint32_t)b << ct;
    }
    void bits(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) bit((v >> i) & 1);
    }
    void flush() {
        byteout();
        if (ct == 7) byteout();
    }
};

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t buf = 0;
    int ct = 0;
    BitReader(const uint8_t* b, const uint8_t* e) : p(b), end(e) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (p < end) buf |= *p++;
    }
    int bit() {
        if (ct == 0) {
            if (p >= end) fail(SL_TRUNCATED, "a packet header runs past the tile's data");
            bytein();
        }
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) v = (v << 1) | bit();
        return v;
    }
    void align() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
};

void tag_encode(BitWriter& bw, TagTree& t, int leaf, int threshold) {
    std::vector<int> path = t.path(leaf);
    int low = 0;
    for (int k = (int)path.size() - 1; k >= 0; --k) {
        TagTree::Node& node = t.nodes[path[k]];
        if (low > node.low)
            node.low = low;
        else
            low = node.low;
        while (low < threshold) {
            if (low >= node.value) {
                if (!node.known) {
                    bw.bit(1);
                    node.known = true;
                }
                break;
            }
            bw.bit(0);
            ++low;
        }
        node.low = low;
    }
}

// 1 where the leaf's value is below ``threshold``
int tag_decode(BitReader& br, TagTree& t, int leaf, int threshold) {
    std::vector<int> path = t.path(leaf);
    int low = 0;
    int n = path.back();
    for (int k = (int)path.size() - 1; k >= 0; --k) {
        n = path[k];
        TagTree::Node& node = t.nodes[n];
        if (low > node.low)
            node.low = low;
        else
            low = node.low;
        while (low < threshold && low < node.value) {
            if (br.bit())
                node.value = low;
            else
                ++low;
        }
        node.low = low;
    }
    return t.nodes[n].value < threshold ? 1 : 0;
}

void put_numpasses(BitWriter& bw, int n) {
    if (n == 1)
        bw.bits(0, 1);
    else if (n == 2)
        bw.bits(2, 2);
    else if (n <= 5)
        bw.bits(0xc | (n - 3), 4);
    else if (n <= 36)
        bw.bits(0x1e0 | (n - 6), 9);
    else
        bw.bits(0xff80 | (n - 37), 16);
}

int get_numpasses(BitReader& br) {
    if (!br.bit()) return 1;
    if (!br.bit()) return 2;
    int n = br.bits(2);
    if (n != 3) return 3 + n;
    n = br.bits(5);
    if (n != 31) return 6 + n;
    return 37 + br.bits(7);
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

const char COMMENT[] = "Created by OpenJPEG version 2.5.4";

void put16(std::vector<uint8_t>& o, uint32_t v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}
void put32(std::vector<uint8_t>& o, uint32_t v) {
    put16(o, v >> 16);
    put16(o, v & 0xffff);
}

struct EncBand {
    Band band;
    int cw, ch;  // code-blocks across and down
    std::vector<CodedBlock> blocks;
};

std::vector<uint8_t> encode(const void* pixels, int w, int h, int nc, int depth) {
    int levels = 5;
    while (levels > 0 && (w < (1 << levels) || h < (1 << levels))) --levels;
    const int cb = 64;
    // resolution -> component -> bands
    std::vector<std::vector<std::vector<EncBand>>> res(levels + 1, std::vector<std::vector<EncBand>>(nc));
    std::vector<int32_t> plane((size_t)w * h);
    const int shift = 1 << (depth - 1);
    for (int c = 0; c < nc; ++c) {
        for (size_t i = 0; i < (size_t)w * h; ++i) {
            int v = depth == 8 ? ((const uint8_t*)pixels)[i * nc + c] : ((const uint16_t*)pixels)[i * nc + c];
            plane[i] = v - shift;
        }
        dwt53_forward(plane.data(), w, h, levels);
        for (int r = 0; r <= levels; ++r)
            for (const Band& b : bands_of(w, h, levels, r)) {
                EncBand eb{b, (b.w + cb - 1) / cb, (b.h + cb - 1) / cb, {}};
                if (b.w > 0 && b.h > 0)
                    for (int j = 0; j < eb.ch; ++j)
                        for (int i = 0; i < eb.cw; ++i) {
                            int x0 = i * cb, y0 = j * cb;
                            int bw = std::min(cb, b.w - x0), bh = std::min(cb, b.h - y0);
                            eb.blocks.push_back(encode_block(
                                plane.data() + (size_t)(b.y0 + y0) * w + b.x0 + x0, w, bw, bh, b.orient));
                        }
                res[r][c].push_back(std::move(eb));
            }
    }

    // the packets, LRCP with one layer: resolution, then component
    std::vector<uint8_t> body;
    for (int r = 0; r <= levels; ++r)
        for (int c = 0; c < nc; ++c) {
            BitWriter bw(body);
            bw.bit(1);  // OpenJPEG's packets are never marked empty
            for (EncBand& eb : res[r][c]) {
                if (eb.band.w == 0 || eb.band.h == 0) continue;
                const int gain = eb.band.orient == 0 ? 0 : (eb.band.orient == 3 ? 2 : 1);
                const int band_numbps = depth + gain + 2 - 1;  // exponent + guard bits - 1
                TagTree incl, imsb;
                incl.init(eb.cw, eb.ch);
                imsb.init(eb.cw, eb.ch);
                for (size_t k = 0; k < eb.blocks.size(); ++k) {
                    imsb.set_value((int)k, band_numbps - eb.blocks[k].numbps);
                    if (eb.blocks[k].passes) incl.set_value((int)k, 0);
                }
                for (size_t k = 0; k < eb.blocks.size(); ++k) {
                    const CodedBlock& blk = eb.blocks[k];
                    tag_encode(bw, incl, (int)k, 1);
                    if (!blk.passes) continue;
                    tag_encode(bw, imsb, (int)k, 999);
                    put_numpasses(bw, blk.passes);
                    const int len = (int)blk.data.size();
                    const int numlenbits = 3;
                    int increment = std::max(0, floorlog2(len) + 1 - (numlenbits + floorlog2(blk.passes)));
                    for (int i = 0; i < increment; ++i) bw.bit(1);
                    bw.bit(0);
                    bw.bits(len, numlenbits + increment + floorlog2(blk.passes));
                }
            }
            bw.flush();
            for (EncBand& eb : res[r][c])
                for (const CodedBlock& blk : eb.blocks)
                    if (blk.passes) body.insert(body.end(), blk.data.begin(), blk.data.end());
        }

    std::vector<uint8_t> o;
    put16(o, 0xff4f);
    put16(o, 0xff51);  // SIZ
    put16(o, 38 + 3 * nc);
    put16(o, 0);
    put32(o, w);
    put32(o, h);
    put32(o, 0);
    put32(o, 0);
    put32(o, w);
    put32(o, h);
    put32(o, 0);
    put32(o, 0);
    put16(o, nc);
    for (int c = 0; c < nc; ++c) {
        o.push_back((uint8_t)(depth - 1));
        o.push_back(1);
        o.push_back(1);
    }
    put16(o, 0xff52);  // COD
    put16(o, 12);
    o.insert(o.end(), {0, 0, 0, 1, 0, (uint8_t)levels, 4, 4, 0, 1});
    put16(o, 0xff5c);  // QCD
    put16(o, 3 + 3 * levels + 1);
    o.push_back(0x40);
    for (int b = 0; b < 3 * levels + 1; ++b) {
        const int gain = b == 0 ? 0 : ((b - 1) % 3 == 2 ? 2 : 1);
        o.push_back((uint8_t)((depth + gain) << 3));
    }
    put16(o, 0xff64);  // COM
    put16(o, 4 + (int)strlen(COMMENT));
    put16(o, 1);
    o.insert(o.end(), COMMENT, COMMENT + strlen(COMMENT));
    put16(o, 0xff90);  // SOT
    put16(o, 10);
    put16(o, 0);
    put32(o, (uint32_t)(12 + 2 + body.size()));
    o.push_back(0);
    o.push_back(1);
    put16(o, 0xff93);  // SOD
    o.insert(o.end(), body.begin(), body.end());
    put16(o, 0xffd9);
    return o;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// Each stage below mirrors OpenJPEG 2.5.4's decoder: the tile grid and
// the tile-component, resolution, subband, precinct and code-block bounds
// of opj_tcd_init_tile (Annex B.5-B.7), the packet iterator of opj_pi_next_*
// (Annex B.12, with POC), the packet headers of opj_t2_read_packet_header,
// the dequantisation of opj_t1_clbl_decode_processor, both inverse wavelets
// at any origin (opj_dwt_decode_tile, opj_dwt_decode_tile_97), the inverse
// RCT and ICT (opj_mct_decode, opj_mct_decode_real) and the DC level shift
// (opj_tcd_dc_level_shift_decode).

// one progression: layers [0, lye), resolutions [rs, re), components
// [cs, ce) in the order ``prg`` (0 LRCP, 1 RLCP, 2 RPCL, 3 PCRL, 4 CPRL)
struct Progression {
    int rs, cs, lye, re, ce, prg;
};

struct TileStream {
    std::vector<uint8_t> data;      // the tile's packets, its tile-parts joined in order
    std::vector<Progression> pocs;  // the POC entries of its tile-part headers
    bool seen = false;
};

struct Stream {
    int64_t xs = 0, ys = 0, xo = 0, yo = 0, xt = 0, yt = 0, xto = 0, yto = 0;
    int nc = 0, prec = 0, sgnd = 0;  // sgnd: bit c for a signed component c
    int prog = 0, layers = 0, levels = -1, cbw = 0, cbh = 0, mct = 0, reversible = 1;
    int ppx[33] = {}, ppy[33] = {};  // the precinct exponents by resolution
    int guard = -1;
    std::vector<int> expn, mant;     // by subband, in codestream order
    std::vector<Progression> pocs;   // the main header's POC entries
    int tiles_x = 0, tiles_y = 0;
    std::vector<TileStream> tiles;
};

uint32_t rd16(const uint8_t* p) { return ((uint32_t)p[0] << 8) | p[1]; }
uint32_t rd32(const uint8_t* p) { return (rd16(p) << 16) | rd16(p + 2); }

// ceil(v / d), v >= 0
int64_t ceil_div(int64_t v, int64_t d) { return (v + d - 1) / d; }

std::string hex(uint32_t m) {
    char b[16];
    snprintf(b, sizeof b, "0x%04X", m);
    return b;
}

const char* marker_refusal(uint32_t m) {
    switch (m) {
        case 0xff53: return "per-component coding styles (COC)";
        case 0xff5d: return "per-component quantisation (QCC)";
        case 0xff5e: return "a region of interest (RGN)";
        case 0xff60: return "packed packet headers (PPM)";
        case 0xff61: return "packed packet headers (PPT)";
        default: return nullptr;
    }
}

void parse_siz(Stream& st, const uint8_t* p, size_t n) {
    if (n < 36) fail(SL_CORRUPT, "a SIZ marker segment is too short");
    st.xs = rd32(p + 2);
    st.ys = rd32(p + 6);
    st.xo = rd32(p + 10);
    st.yo = rd32(p + 14);
    st.xt = rd32(p + 18);
    st.yt = rd32(p + 22);
    st.xto = rd32(p + 26);
    st.yto = rd32(p + 30);
    int csiz = (int)rd16(p + 34);
    if (csiz < 1 || csiz > 4) fail(SL_UNSUPPORTED, std::to_string(csiz) + " components are not supported");
    if (n < (size_t)(36 + 3 * csiz)) fail(SL_CORRUPT, "a SIZ marker segment is too short");
    if (st.xs > 0x7fffffff || st.ys > 0x7fffffff || st.xo >= st.xs || st.yo >= st.ys)
        fail(SL_CORRUPT, "an empty image");
    if (st.xt == 0 || st.yt == 0 || st.xto > st.xo || st.yto > st.yo || st.xto + st.xt <= st.xo ||
        st.yto + st.yt <= st.yo)
        fail(SL_CORRUPT, "a tile grid that misses the image");
    int64_t tx = ceil_div(st.xs - st.xto, st.xt), ty = ceil_div(st.ys - st.yto, st.yt);
    if (tx * ty > 65535) fail(SL_CORRUPT, "more than 65535 tiles");
    st.tiles_x = (int)tx;
    st.tiles_y = (int)ty;
    st.nc = csiz;
    for (int c = 0; c < csiz; ++c) {
        int ssiz = p[36 + 3 * c];
        if (ssiz & 0x80) st.sgnd |= 1 << c;
        int prec = (ssiz & 0x7f) + 1;
        if (prec != 8 && prec != 16)
            fail(SL_UNSUPPORTED, "a precision of " + std::to_string(prec) + " bits is not supported (only 8 and 16)");
        if (c && prec != st.prec) fail(SL_UNSUPPORTED, "components of different precisions are not supported");
        st.prec = prec;
        if (p[37 + 3 * c] != 1 || p[38 + 3 * c] != 1)
            fail(SL_UNSUPPORTED, "sub-sampled components are not supported");
    }
}

void parse_cod(Stream& st, const uint8_t* p, size_t n) {
    if (n < 10) fail(SL_CORRUPT, "a COD marker segment is too short");
    int scod = p[0];
    if (scod & 6) fail(SL_UNSUPPORTED, "SOP/EPH markers are not supported");
    if (scod & ~7) fail(SL_CORRUPT, "an unknown coding style " + hex(scod).substr(4));
    st.prog = p[1];
    if (st.prog > 4) fail(SL_CORRUPT, "an unknown progression order " + std::to_string(st.prog));
    st.layers = (int)rd16(p + 2);
    if (st.layers == 0) fail(SL_CORRUPT, "a COD marker segment of no quality layers");
    st.mct = p[4];
    if (st.mct > 1) fail(SL_UNSUPPORTED, "the multiple component transform " + std::to_string(st.mct));
    st.levels = p[5];
    if (st.levels > 32) fail(SL_CORRUPT, "more than 32 decomposition levels");
    int xcb = p[6] + 2, ycb = p[7] + 2;
    if (xcb > 10 || ycb > 10 || xcb + ycb > 12) fail(SL_CORRUPT, "a code-block size out of range");
    st.cbw = xcb;
    st.cbh = ycb;
    if (p[8] != 0) fail(SL_UNSUPPORTED, "the code-block style " + hex(p[8]).substr(4) +
                                            " is not supported (only style 0)");
    if (p[9] > 1) fail(SL_CORRUPT, "an unknown wavelet transform " + std::to_string(p[9]));
    st.reversible = p[9];
    for (int r = 0; r <= st.levels; ++r) {
        st.ppx[r] = st.ppy[r] = 15;
        if (!(scod & 1)) continue;
        if (n < (size_t)(10 + st.levels + 1)) fail(SL_CORRUPT, "a COD marker segment is too short");
        st.ppx[r] = p[10 + r] & 15;
        st.ppy[r] = p[10 + r] >> 4;
        // Table A.21: an exponent of 0 only for the lowest resolution
        if (r && (st.ppx[r] == 0 || st.ppy[r] == 0)) fail(SL_CORRUPT, "an invalid precinct size");
    }
}

void parse_qcd(Stream& st, const uint8_t* p, size_t n) {
    if (n < 1) fail(SL_CORRUPT, "a QCD marker segment is too short");
    int style = p[0] & 0x1f;
    if (style == 1) fail(SL_UNSUPPORTED, "derived quantisation (scalar derived) is not supported");
    if (style != 0 && style != 2) fail(SL_CORRUPT, "an unknown quantisation style " + std::to_string(style));
    st.guard = p[0] >> 5;
    st.expn.clear();
    st.mant.clear();
    if (style == 0) {
        for (size_t i = 1; i < n; ++i) {
            st.expn.push_back(p[i] >> 3);
            st.mant.push_back(0);
        }
    } else {
        for (size_t i = 1; i + 1 < n; i += 2) {
            st.expn.push_back((int)(rd16(p + i) >> 11));
            st.mant.push_back((int)(rd16(p + i) & 0x7ff));
        }
    }
}

void parse_poc(std::vector<Progression>& out, int nc, const uint8_t* p, size_t n) {
    if (n == 0 || n % 7) fail(SL_CORRUPT, "a POC marker segment of the wrong length");
    for (size_t i = 0; i < n; i += 7) {
        Progression q{p[i], p[i + 1], (int)rd16(p + i + 2), p[i + 4], std::min((int)p[i + 5], nc), p[i + 6]};
        if (q.prg > 4) fail(SL_CORRUPT, "an unknown progression order " + std::to_string(q.prg) + " in a POC");
        out.push_back(q);
    }
}

Stream parse(const uint8_t* d, size_t size) {
    Stream st;
    if (size < 4 || rd16(d) != 0xff4f) fail(SL_CORRUPT, "not a JPEG 2000 codestream");
    size_t pos = 2;
    bool siz = false;
    // main header
    for (;;) {
        if (pos + 4 > size) fail(SL_TRUNCATED, "the codestream ends in its main header");
        uint32_t m = rd16(d + pos);
        if (m == 0xff90) break;
        uint32_t len = rd16(d + pos + 2);
        if (len < 2 || pos + 2 + len > size) fail(SL_TRUNCATED, "a marker segment runs past the codestream");
        const uint8_t* p = d + pos + 4;
        size_t n = len - 2;
        if (m == 0xff51) {
            parse_siz(st, p, n);
            siz = true;
        } else if (m == 0xff52) {
            parse_cod(st, p, n);
        } else if (m == 0xff5c) {
            parse_qcd(st, p, n);
        } else if (m == 0xff5f) {
            if (!siz) fail(SL_CORRUPT, "a POC marker segment before SIZ");
            parse_poc(st.pocs, st.nc, p, n);
        } else if (const char* what = marker_refusal(m)) {
            fail(SL_UNSUPPORTED, std::string(what) + " are not supported");
        } else if ((m & 0xff00) != 0xff00) {
            fail(SL_CORRUPT, "a marker expected at byte " + std::to_string(pos));
        }
        pos += 2 + len;  // TLM, PLM, CRG, COM and others carry nothing the decoder needs
    }
    if (!siz || st.levels < 0 || st.guard < 0) fail(SL_CORRUPT, "the main header lacks SIZ, COD or QCD");
    if (st.mct && st.nc < 3) fail(SL_CORRUPT, "a colour transform of fewer than three components");
    if ((int)st.expn.size() < 3 * st.levels + 1) fail(SL_CORRUPT, "a QCD marker segment is too short");
    st.tiles.resize((size_t)st.tiles_x * st.tiles_y);
    // tile-parts, of the tiles in any order
    while (pos + 2 <= size) {
        uint32_t m = rd16(d + pos);
        if (m == 0xffd9) break;
        if (m != 0xff90) fail(SL_CORRUPT, "an SOT marker expected at byte " + std::to_string(pos));
        if (pos + 12 > size) fail(SL_TRUNCATED, "the codestream ends in a tile-part header");
        uint32_t isot = rd16(d + pos + 4);
        if (isot >= st.tiles.size()) fail(SL_CORRUPT, "a tile index beyond the tile grid");
        TileStream& tile = st.tiles[isot];
        uint32_t psot = rd32(d + pos + 6);
        size_t end = psot ? pos + psot : size;
        if (psot == 0 && size >= 2 && rd16(d + size - 2) == 0xffd9) end = size - 2;
        if (end > size) fail(SL_TRUNCATED, "a tile-part runs past the codestream");
        size_t q = pos + 12;
        for (;;) {
            if (q + 2 > end) fail(SL_TRUNCATED, "a tile-part header ends before its SOD");
            uint32_t tm = rd16(d + q);
            if (tm == 0xff93) {
                q += 2;
                break;
            }
            if (q + 4 > end) fail(SL_TRUNCATED, "a tile-part header ends before its SOD");
            uint32_t len = rd16(d + q + 2);
            if (len < 2 || q + 2 + len > end) fail(SL_TRUNCATED, "a marker segment runs past its tile-part");
            if (tm == 0xff5f)
                parse_poc(tile.pocs, st.nc, d + q + 4, len - 2);
            else if (tm == 0xff52 || tm == 0xff5c || marker_refusal(tm))
                fail(SL_UNSUPPORTED, "a tile-part header's marker " + hex(tm) + " is not supported");
            q += 2 + len;  // PLT, COM
        }
        tile.data.insert(tile.data.end(), d + q, d + end);
        tile.seen = true;
        pos = end;
    }
    return st;
}

// ---------------------------------------------------------------------------
// A tile's structure (opj_tcd_init_tile)
// ---------------------------------------------------------------------------

struct Cblk {
    int x0, y0, x1, y1;
    int numbps = 0, numlenbits = 0, passes = 0, newpasses = 0;
    uint32_t newlen = 0;
    bool included = false;
    std::vector<uint8_t> data;  // its bytes of every layer, joined
};

struct Precinct {
    int cw = 0, ch = 0;
    TagTree incl, imsb;
    std::vector<Cblk> blocks;
};

struct Subband {
    int x0, y0, x1, y1;
    int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
    int numbps;
    float half_step;  // half the irreversible path's step size
    std::vector<Precinct> precincts;
    bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
    int x0, y0, x1, y1;
    int pdx, pdy, pw, ph;
    std::vector<Subband> bands;
    std::vector<int> layers_done;  // by precinct: the packets read, a prefix of the layers
};

struct TileComponent {
    int x0, y0, x1, y1;
    std::vector<Resolution> res;
};

TileComponent init_tile_component(const Stream& st, int tx0, int ty0, int tx1, int ty1) {
    TileComponent tc{tx0, ty0, tx1, ty1, {}};
    const int L = st.levels;
    tc.res.resize(L + 1);
    for (int r = 0; r <= L; ++r) {
        Resolution& R = tc.res[r];
        const int lev = L - r;
        R.x0 = (int)ceil_pow2(tx0, lev);
        R.y0 = (int)ceil_pow2(ty0, lev);
        R.x1 = (int)ceil_pow2(tx1, lev);
        R.y1 = (int)ceil_pow2(ty1, lev);
        R.pdx = st.ppx[r];
        R.pdy = st.ppy[r];
        const int64_t px0 = ((int64_t)R.x0 >> R.pdx) << R.pdx, py0 = ((int64_t)R.y0 >> R.pdy) << R.pdy;
        const int64_t px1 = ceil_pow2(R.x1, R.pdx) << R.pdx, py1 = ceil_pow2(R.y1, R.pdy) << R.pdy;
        R.pw = R.x0 == R.x1 ? 0 : (int)((px1 - px0) >> R.pdx);
        R.ph = R.y0 == R.y1 ? 0 : (int)((py1 - py0) >> R.pdy);
        if ((int64_t)R.pw * R.ph > (1 << 24)) fail(SL_CORRUPT, "more than 2^24 precincts in a resolution");
        R.layers_done.assign((size_t)R.pw * R.ph, 0);
        // the precincts' partition of the bands, and their code-blocks
        const int64_t gx0 = r == 0 ? px0 : ceil_pow2(px0, 1), gy0 = r == 0 ? py0 : ceil_pow2(py0, 1);
        const int gw = r == 0 ? R.pdx : R.pdx - 1, gh = r == 0 ? R.pdy : R.pdy - 1;
        const int cbw = std::min(st.cbw, gw), cbh = std::min(st.cbh, gh);
        for (int b = 0; b < (r == 0 ? 1 : 3); ++b) {
            Subband B;
            B.bandno = r == 0 ? 0 : b + 1;
            if (r == 0) {
                B.x0 = R.x0;
                B.y0 = R.y0;
                B.x1 = R.x1;
                B.y1 = R.y1;
            } else {
                const int64_t ox = (int64_t)(B.bandno & 1) << lev, oy = (int64_t)(B.bandno >> 1) << lev;
                B.x0 = (int)ceil_pow2(tx0 - ox, lev + 1);
                B.y0 = (int)ceil_pow2(ty0 - oy, lev + 1);
                B.x1 = (int)ceil_pow2(tx1 - ox, lev + 1);
                B.y1 = (int)ceil_pow2(ty1 - oy, lev + 1);
            }
            const int q = r == 0 ? 0 : 3 * (r - 1) + B.bandno;
            B.numbps = st.expn[q] + st.guard - 1;
            // Annex E's step size, without the band's gain: OpenJPEG's 9/7
            // inverse scales the high-pass by 2/K in its place
            B.half_step = 0.5f * (float)std::ldexp(1.0 + st.mant[q] / 2048.0, st.prec - st.expn[q]);
            B.precincts.resize((size_t)R.pw * R.ph);
            for (int pn = 0; pn < R.pw * R.ph; ++pn) {
                Precinct& P = B.precincts[pn];
                const int64_t cx0 = gx0 + (int64_t)(pn % R.pw) * ((int64_t)1 << gw);
                const int64_t cy0 = gy0 + (int64_t)(pn / R.pw) * ((int64_t)1 << gh);
                const int64_t x0 = std::max<int64_t>(cx0, B.x0), y0 = std::max<int64_t>(cy0, B.y0);
                const int64_t x1 = std::min<int64_t>(cx0 + ((int64_t)1 << gw), B.x1);
                const int64_t y1 = std::min<int64_t>(cy0 + ((int64_t)1 << gh), B.y1);
                const int64_t bx0 = (x0 >> cbw) << cbw, by0 = (y0 >> cbh) << cbh;
                P.cw = (int)std::max<int64_t>(0, ((ceil_pow2(x1, cbw) << cbw) - bx0) >> cbw);
                P.ch = (int)std::max<int64_t>(0, ((ceil_pow2(y1, cbh) << cbh) - by0) >> cbh);
                if (P.cw * P.ch == 0) continue;
                P.incl.init(P.cw, P.ch);
                P.imsb.init(P.cw, P.ch);
                P.blocks.resize((size_t)P.cw * P.ch);
                for (int k = 0; k < P.cw * P.ch; ++k) {
                    Cblk& cb = P.blocks[k];
                    const int64_t kx = bx0 + ((int64_t)(k % P.cw) << cbw), ky = by0 + ((int64_t)(k / P.cw) << cbh);
                    cb.x0 = (int)std::max(kx, x0);
                    cb.y0 = (int)std::max(ky, y0);
                    cb.x1 = (int)std::min(kx + ((int64_t)1 << cbw), x1);
                    cb.y1 = (int)std::min(ky + ((int64_t)1 << cbh), y1);
                }
            }
            R.bands.push_back(std::move(B));
        }
    }
    return tc;
}

// ---------------------------------------------------------------------------
// Packets (opj_t2_read_packet_header, opj_t2_read_packet_data)
// ---------------------------------------------------------------------------

void read_packet(const uint8_t*& p, const uint8_t* end, Resolution& R, int precno, int layno) {
    if (p >= end) fail(SL_TRUNCATED, "the tile's data ends before its packets do");
    BitReader br(p, end);
    const bool present = br.bit();
    if (present) {
        for (Subband& B : R.bands) {
            if (B.empty()) continue;
            Precinct& P = B.precincts[precno];
            for (int k = 0; k < P.cw * P.ch; ++k) {
                Cblk& cb = P.blocks[k];
                const int included = cb.included ? br.bit() : tag_decode(br, P.incl, k, layno + 1);
                cb.newpasses = 0;
                if (!included) continue;
                if (!cb.included) {
                    int zero = 0;
                    while (!tag_decode(br, P.imsb, k, zero)) {
                        if (++zero > 64) fail(SL_CORRUPT, "a zero-bitplane count out of range");
                    }
                    cb.numbps = B.numbps + 1 - zero;
                    cb.numlenbits = 3;
                    cb.included = true;
                }
                cb.newpasses = get_numpasses(br);
                while (br.bit()) {
                    if (++cb.numlenbits > 32) fail(SL_CORRUPT, "a length indicator out of range");
                }
                // style 0 codes every pass of a code-block into one segment
                if (cb.passes + cb.newpasses > 109) fail(SL_CORRUPT, "a code-block of more than 109 passes");
                const int nbits = cb.numlenbits + floorlog2(cb.newpasses);
                if (nbits > 32) fail(SL_CORRUPT, "a length indicator out of range");
                cb.newlen = br.bits(nbits);
            }
        }
    }
    br.align();
    p = br.p;
    if (!present) return;
    for (Subband& B : R.bands) {
        if (B.empty()) continue;
        for (Cblk& cb : B.precincts[precno].blocks) {
            if (!cb.newpasses) continue;
            if ((size_t)(end - p) < cb.newlen) fail(SL_TRUNCATED, "a code-block's data runs past the tile's");
            cb.data.insert(cb.data.end(), p, p + cb.newlen);
            p += cb.newlen;
            cb.passes += cb.newpasses;
        }
    }
}

struct TileDecoder {
    const Stream& st;
    std::vector<TileComponent> comps;
    int64_t tx0, ty0, tx1, ty1;
    const uint8_t* p;
    const uint8_t* end;
    std::vector<int> top;  // by component: the highest resolution of a packet read

    // the packet (layno, r, c, precno), unless a progression read it before
    void packet(int layno, int r, int c, int precno) {
        top[c] = std::max(top[c], r);
        Resolution& R = comps[c].res[r];
        if (precno < 0 || precno >= R.pw * R.ph) fail(SL_CORRUPT, "a precinct beyond its resolution's");
        int& done = R.layers_done[precno];
        if (layno < done) return;
        if (layno > done) fail(SL_CORRUPT, "a packet before its precinct's earlier layers");
        read_packet(p, end, R, precno, layno);
        done = layno + 1;
    }

    // the precinct of (r, c) whose top-left is at (x, y) on the reference
    // grid, or -1 (opj_pi_next_rpcl's test)
    int precinct_at(int r, int c, int64_t x, int64_t y) const {
        const Resolution& R = comps[c].res[r];
        const int lev = st.levels - r;
        const int64_t rx0 = ceil_pow2(tx0, lev), ry0 = ceil_pow2(ty0, lev);
        const int64_t rx1 = ceil_pow2(tx1, lev), ry1 = ceil_pow2(ty1, lev);
        const int rpx = R.pdx + lev, rpy = R.pdy + lev;
        if (!(y % ((int64_t)1 << rpy) == 0 || (y == ty0 && ((ry0 << lev) % ((int64_t)1 << rpy)))))
            return -1;
        if (!(x % ((int64_t)1 << rpx) == 0 || (x == tx0 && ((rx0 << lev) % ((int64_t)1 << rpx)))))
            return -1;
        if (R.pw == 0 || R.ph == 0 || rx0 == rx1 || ry0 == ry1) return -1;
        const int64_t i = (ceil_pow2(x, lev) >> R.pdx) - (rx0 >> R.pdx);
        const int64_t j = (ceil_pow2(y, lev) >> R.pdy) - (ry0 >> R.pdy);
        return (int)(i + j * R.pw);
    }

    // the position step of components [c0, c1): the least precinct size
    // over their resolutions on the reference grid
    void steps(int c0, int c1, int64_t* dx, int64_t* dy) const {
        *dx = *dy = 0;
        for (int c = c0; c < c1; ++c)
            for (int r = 0; r <= st.levels; ++r) {
                const Resolution& R = comps[c].res[r];
                const int sx = R.pdx + st.levels - r, sy = R.pdy + st.levels - r;
                if (sx < 32) *dx = *dx ? std::min(*dx, (int64_t)1 << sx) : (int64_t)1 << sx;
                if (sy < 32) *dy = *dy ? std::min(*dy, (int64_t)1 << sy) : (int64_t)1 << sy;
            }
    }

    void progression(const Progression& q) {
        const int nres = st.levels + 1;
        const int lye = std::min(q.lye, st.layers), re = std::min(q.re, nres);
        auto at = [&](int r, int c, int64_t x, int64_t y) {
            int pn = precinct_at(r, c, x, y);
            if (pn >= 0)
                for (int l = 0; l < lye; ++l) packet(l, r, c, pn);
        };
        int64_t dx, dy;
        switch (q.prg) {
            case 0:  // LRCP
                for (int l = 0; l < lye; ++l)
                    for (int r = q.rs; r < re; ++r)
                        for (int c = q.cs; c < q.ce; ++c)
                            for (int pn = 0; pn < comps[c].res[r].pw * comps[c].res[r].ph; ++pn) packet(l, r, c, pn);
                break;
            case 1:  // RLCP
                for (int r = q.rs; r < re; ++r)
                    for (int l = 0; l < lye; ++l)
                        for (int c = q.cs; c < q.ce; ++c)
                            for (int pn = 0; pn < comps[c].res[r].pw * comps[c].res[r].ph; ++pn) packet(l, r, c, pn);
                break;
            case 2:  // RPCL
                steps(0, st.nc, &dx, &dy);
                if (!dx || !dy) break;
                for (int r = q.rs; r < re; ++r)
                    for (int64_t y = ty0; y < ty1; y += dy - y % dy)
                        for (int64_t x = tx0; x < tx1; x += dx - x % dx)
                            for (int c = q.cs; c < q.ce; ++c) at(r, c, x, y);
                break;
            case 3:  // PCRL
                steps(0, st.nc, &dx, &dy);
                if (!dx || !dy) break;
                for (int64_t y = ty0; y < ty1; y += dy - y % dy)
                    for (int64_t x = tx0; x < tx1; x += dx - x % dx)
                        for (int c = q.cs; c < q.ce; ++c)
                            for (int r = q.rs; r < re; ++r) at(r, c, x, y);
                break;
            default:  // CPRL
                for (int c = q.cs; c < q.ce; ++c) {
                    steps(c, c + 1, &dx, &dy);
                    if (!dx || !dy) return;
                    for (int64_t y = ty0; y < ty1; y += dy - y % dy)
                        for (int64_t x = tx0; x < tx1; x += dx - x % dx)
                            for (int r = q.rs; r < re; ++r) at(r, c, x, y);
                }
        }
    }
};

// ---------------------------------------------------------------------------
// The inverse wavelets (Annex F), at any origin
// ---------------------------------------------------------------------------

// One line of ``n`` samples ``stride`` apart, its ``sn`` low-pass samples
// first; ``cas`` 1 where its first sample is at an odd coordinate (a
// high-pass one). The lifting extends the line symmetrically.
void idwt53_line(int32_t* x, int n, int stride, int sn, int cas, std::vector<int32_t>& t) {
    if (n == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    if (n < 1) return;
    t.resize(n);
    for (int i = 0; i < sn; ++i) t[2 * i + cas] = x[(size_t)i * stride];
    for (int i = 0; i < n - sn; ++i) t[2 * i + 1 - cas] = x[(size_t)(sn + i) * stride];
    auto at = [&](int k) { return t[k < 0 ? -k : (k >= n ? 2 * (n - 1) - k : k)]; };
    for (int k = cas; k < n; k += 2) t[k] -= (at(k - 1) + at(k + 1) + 2) >> 2;
    for (int k = 1 - cas; k < n; k += 2) t[k] += (at(k - 1) + at(k + 1)) >> 1;
    for (int k = 0; k < n; ++k) x[(size_t)k * stride] = t[k];
}

// OpenJPEG's single-precision lifting constants (opj_v8dwt_decode): the
// low-pass scaled by K, the high-pass by its historic 2/K
const float K97 = 1.230174105f, TWO_INV_K97 = 1.625732422f;
const float ALPHA97 = -1.586134342f, BETA97 = -0.052980118f, GAMMA97 = 0.882911075f, DELTA97 = 0.443506852f;

void idwt97_line(float* x, int n, int stride, int sn, int cas, std::vector<float>& t) {
    if (n <= 1) return;  // a lone sample stays as it is, even a high-pass one
    t.resize(n);
    for (int i = 0; i < sn; ++i) t[2 * i + cas] = x[(size_t)i * stride] * K97;
    for (int i = 0; i < n - sn; ++i) t[2 * i + 1 - cas] = x[(size_t)(sn + i) * stride] * TWO_INV_K97;
    auto at = [&](int k) { return t[k < 0 ? -k : (k >= n ? 2 * (n - 1) - k : k)]; };
    for (int k = cas; k < n; k += 2) t[k] = t[k] - (at(k - 1) + at(k + 1)) * DELTA97;
    for (int k = 1 - cas; k < n; k += 2) t[k] = t[k] - (at(k - 1) + at(k + 1)) * GAMMA97;
    for (int k = cas; k < n; k += 2) t[k] = t[k] - (at(k - 1) + at(k + 1)) * BETA97;
    for (int k = 1 - cas; k < n; k += 2) t[k] = t[k] - (at(k - 1) + at(k + 1)) * ALPHA97;
    for (int k = 0; k < n; ++k) x[(size_t)k * stride] = t[k];
}

// every level of a tile-component's plane (row stride ``w``): its rows,
// then its columns
template <class T, class Line>
void idwt_2d(T* plane, int w, const TileComponent& tc, Line line) {
    std::vector<T> t;
    for (size_t r = 1; r < tc.res.size(); ++r) {
        const Resolution &lo = tc.res[r - 1], &R = tc.res[r];
        const int rw = R.x1 - R.x0, rh = R.y1 - R.y0;
        for (int j = 0; j < rh; ++j) line(plane + (size_t)j * w, rw, 1, lo.x1 - lo.x0, R.x0 & 1, t);
        for (int i = 0; i < rw; ++i) line(plane + i, rh, w, lo.y1 - lo.y0, R.y0 & 1, t);
    }
}

// ---------------------------------------------------------------------------
// A tile, then the image
// ---------------------------------------------------------------------------

void decode_tile(const Stream& st, const TileStream& ts, int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1,
                 uint16_t* out) {
    const int nc = st.nc;
    TileDecoder td{st, {}, tx0, ty0, tx1, ty1, ts.data.data(), ts.data.data() + ts.data.size(),
                   std::vector<int>(nc, -1)};
    for (int c = 0; c < nc; ++c) td.comps.push_back(init_tile_component(st, (int)tx0, (int)ty0, (int)tx1, (int)ty1));
    std::vector<Progression> order(st.pocs);
    order.insert(order.end(), ts.pocs.begin(), ts.pocs.end());
    if (order.empty()) order.push_back({0, 0, st.layers, st.levels + 1, nc, st.prog});
    for (const Progression& q : order) td.progression(q);
    // OpenJPEG gives such a component at the resolution its packets reach,
    // into a buffer of the full one
    for (int c = 0; c < nc; ++c)
        if (td.top[c] < st.levels)
            fail(SL_UNSUPPORTED, "progression order changes (POC) that leave out a component's highest "
                                 "resolution are not supported");

    const int w = (int)(tx1 - tx0), h = (int)(ty1 - ty0);
    const size_t n = (size_t)w * h;
    std::vector<std::vector<int32_t>> ip(st.reversible ? nc : 0, std::vector<int32_t>(n, 0));
    std::vector<std::vector<float>> fp(st.reversible ? 0 : nc, std::vector<float>(n, 0.0f));
    std::vector<int32_t> raw;
    for (int c = 0; c < nc; ++c) {
        const TileComponent& tc = td.comps[c];
        for (size_t r = 0; r < tc.res.size(); ++r)
            for (const Subband& B : tc.res[r].bands)
                for (const Precinct& P : B.precincts)
                    for (const Cblk& cb : P.blocks) {
                        const int bw = cb.x1 - cb.x0, bh = cb.y1 - cb.y0;
                        if (bw <= 0 || bh <= 0) continue;
                        int x = cb.x0 - B.x0, y = cb.y0 - B.y0;
                        if (B.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (B.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        raw.resize((size_t)bw * bh);
                        decode_block(cb.data.data(), cb.data.size(), cb.numbps, cb.passes, raw.data(), bw, bw,
                                     bh, B.bandno);
                        for (int j = 0; j < bh; ++j)
                            for (int i = 0; i < bw; ++i) {
                                const size_t at = (size_t)(y + j) * w + x + i;
                                const int32_t v = raw[(size_t)j * bw + i];
                                if (st.reversible)
                                    ip[c][at] = v / 2;
                                else
                                    fp[c][at] = (float)v * B.half_step;
                            }
                    }
        if (st.reversible)
            idwt_2d(ip[c].data(), w, tc, idwt53_line);
        else
            idwt_2d(fp[c].data(), w, tc, idwt97_line);
    }
    if (st.mct && nc >= 3) {
        if (st.reversible) {
            for (size_t i = 0; i < n; ++i) {
                int32_t y = ip[0][i], u = ip[1][i], v = ip[2][i];
                int32_t g = y - ((u + v) >> 2);
                ip[0][i] = v + g;
                ip[1][i] = g;
                ip[2][i] = u + g;
            }
        } else {
            for (size_t i = 0; i < n; ++i) {
                float y = fp[0][i], u = fp[1][i], v = fp[2][i];
                fp[0][i] = y + v * 1.402f;
                fp[1][i] = y - u * 0.34413f - v * 0.71414f;
                fp[2][i] = y + u * 1.772f;
            }
        }
    }
    const int64_t W = st.xs - st.xo;
    for (int c = 0; c < nc; ++c) {
        const bool sg = (st.sgnd >> c) & 1;
        const int64_t half = (int64_t)1 << (st.prec - 1);
        const int64_t shift = sg ? 0 : half, lo = sg ? -half : 0, hi = sg ? half - 1 : 2 * half - 1;
        for (int j = 0; j < h; ++j) {
            uint16_t* row = out + ((size_t)(ty0 - st.yo + j) * W + (size_t)(tx0 - st.xo)) * nc + c;
            for (int i = 0; i < w; ++i) {
                int64_t v;
                if (st.reversible) {
                    v = std::max(lo, std::min(hi, (int64_t)ip[c][(size_t)j * w + i] + shift));
                } else {
                    const float f = fp[c][(size_t)j * w + i];
                    if (f > (float)INT32_MAX)
                        v = hi;
                    else if (f < (float)INT32_MIN)
                        v = lo;
                    else  // lrintf: to nearest, ties to even
                        v = std::max(lo, std::min(hi, (int64_t)std::lrintf(f) + shift));
                }
                row[(size_t)i * nc] = (uint16_t)(v + (sg ? half : 0));
            }
        }
    }
}

void decode(const Stream& st, uint16_t* out) {
    for (size_t t = 0; t < st.tiles.size(); ++t) {
        if (!st.tiles[t].seen) fail(SL_TRUNCATED, "the codestream ends before its tile " + std::to_string(t));
        const int64_t p = (int64_t)(t % st.tiles_x), q = (int64_t)(t / st.tiles_x);
        const int64_t tx0 = std::max(st.xto + p * st.xt, st.xo), ty0 = std::max(st.yto + q * st.yt, st.yo);
        const int64_t tx1 = std::min(st.xto + (p + 1) * st.xt, st.xs);
        const int64_t ty1 = std::min(st.yto + (q + 1) * st.yt, st.ys);
        decode_tile(st, st.tiles[t], tx0, ty0, tx1, ty1, out);
    }
}

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

int sl_j2k_encode(const void* pixels, int width, int height, int components, int depth,
                  uint8_t** out, size_t* out_size, char* err, int errlen) {
    try {
        if (width < 1 || height < 1 || components < 1 || components > 4 || (depth != 8 && depth != 16))
            fail(SL_UNSUPPORTED, "unsupported image shape");
        std::vector<uint8_t> o = encode(pixels, width, height, components, depth);
        uint8_t* buf = (uint8_t*)malloc(o.size());
        if (!buf) fail(SL_NO_ROOM, "out of memory");
        memcpy(buf, o.data(), o.size());
        *out = buf;
        *out_size = o.size();
        return SL_OK;
    } catch (const J2kError& e) {
        set_err(err, errlen, e.msg);
        return e.code;
    } catch (const std::bad_alloc&) {
        set_err(err, errlen, "out of memory");
        return SL_NO_ROOM;
    }
}

void sl_j2k_free(uint8_t* buffer) { free(buffer); }

int sl_j2k_info(const uint8_t* data, size_t size, int32_t* info, char* err, int errlen) {
    try {
        Stream st = parse(data, size);
        info[0] = (int32_t)(st.xs - st.xo);
        info[1] = (int32_t)(st.ys - st.yo);
        info[2] = st.nc;
        info[3] = st.prec;
        info[4] = st.levels;
        info[5] = st.mct;
        info[6] = st.sgnd;
        info[7] = (int32_t)st.xo;
        info[8] = (int32_t)st.yo;
        return SL_OK;
    } catch (const J2kError& e) {
        set_err(err, errlen, e.msg);
        return e.code;
    } catch (const std::bad_alloc&) {
        set_err(err, errlen, "out of memory");
        return SL_NO_ROOM;
    }
}

int sl_j2k_decode(const uint8_t* data, size_t size, uint16_t* out, char* err, int errlen) {
    try {
        decode(parse(data, size), out);
        return SL_OK;
    } catch (const J2kError& e) {
        set_err(err, errlen, e.msg);
        return e.code;
    } catch (const std::bad_alloc&) {
        set_err(err, errlen, "out of memory");
        return SL_NO_ROOM;
    }
}

}  // extern "C"
