// JPEG 2000 codestreams both ways, as OpenJPEG 2.5.4 codes them at Pillow's
// defaults (see sl_j2k.h). The stages follow ISO/IEC 15444-1: the DC level
// shift, the reversible 5/3 lifting with symmetric extension (Annex F), the
// code-block coder with its three passes per bitplane over the MQ coder
// (Annexes C and D), the packet headers with their tag trees (Annex B) and
// the marker segments (Annex A). Where the standard leaves the encoder a
// choice, OpenJPEG's is taken: the MQ coder's flush (opj_mqc_flush), the
// termination of the last pass only, one layer of every pass, the packet
// header's leading 1 bit even for a packet that includes nothing.

#include "sl_j2k.h"

#include <algorithm>
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

int ceil_shift(int v, int n) { return (int)(((int64_t)v + (1LL << n) - 1) >> n); }

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
// bitplanes down, into ``coef`` (row stride ``stride``) as OpenJPEG
// reconstructs a reversible block (the half step of the bitplanes not
// decoded, then halved towards zero).
void decode_block(const uint8_t* data, size_t size, int numbps, int passes, int32_t* coef,
                  int stride, int w, int h, int orient) {
    for (int y = 0; y < h; ++y) std::fill(coef + (size_t)y * stride, coef + (size_t)y * stride + w, 0);
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
            int32_t m = mag[(size_t)y * w + x] / 2;
            coef[(size_t)y * stride + x] = (*fl.at(x, y) & F_NEG) ? -m : m;
        }
}

// ---------------------------------------------------------------------------
// The reversible 5/3 wavelet (Annex F), origin 0
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

void dwt53_inverse_line(int32_t* x, int n, int stride) {
    if (n < 2) return;
    const int sn = (n + 1) / 2, dn = n / 2;
    std::vector<int32_t> s(sn), d(dn);
    for (int i = 0; i < sn; ++i) s[i] = x[(size_t)i * stride];
    for (int i = 0; i < dn; ++i) d[i] = x[(size_t)(sn + i) * stride];
    auto D = [&](int i) { return d[std::max(0, std::min(dn - 1, i))]; };
    for (int i = 0; i < sn; ++i) s[i] -= (D(i - 1) + D(i) + 2) >> 2;
    auto S = [&](int i) { return s[std::max(0, std::min(sn - 1, i))]; };
    for (int i = 0; i < dn; ++i) d[i] += (S(i) + S(i + 1)) >> 1;
    for (int i = 0; i < sn; ++i) x[(size_t)(2 * i) * stride] = s[i];
    for (int i = 0; i < dn; ++i) x[(size_t)(2 * i + 1) * stride] = d[i];
}

// ``levels`` decompositions of a ``w`` x ``h`` plane: each level's columns,
// then its rows (opj_dwt_encode)
void dwt53_forward(int32_t* plane, int w, int h, int levels) {
    std::vector<int32_t> tmp;
    for (int l = 0; l < levels; ++l) {
        int rw = ceil_shift(w, l), rh = ceil_shift(h, l);
        for (int x = 0; x < rw; ++x) dwt53_forward_line(plane + x, rh, w, tmp);
        for (int y = 0; y < rh; ++y) dwt53_forward_line(plane + (size_t)y * w, rw, 1, tmp);
    }
}

void dwt53_inverse(int32_t* plane, int w, int h, int levels) {
    for (int l = levels - 1; l >= 0; --l) {
        int rw = ceil_shift(w, l), rh = ceil_shift(h, l);
        for (int y = 0; y < rh; ++y) dwt53_inverse_line(plane + (size_t)y * w, rw, 1);
        for (int x = 0; x < rw; ++x) dwt53_inverse_line(plane + x, rh, w);
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
    if (r == 0) return {{0, 0, ceil_shift(w, levels), ceil_shift(h, levels), 0}};
    const int n = levels - r + 1;  // the decomposition level
    const int rw = ceil_shift(w, n - 1), rh = ceil_shift(h, n - 1);
    const int lw = ceil_shift(w, n), lh = ceil_shift(h, n);
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

struct Stream {
    int w = 0, h = 0, nc = 0, prec = 0;
    int levels = -1, cbw = 0, cbh = 0, mct = 0;
    int guard = -1;
    std::vector<int> expn;
    std::vector<uint8_t> tile;  // the tile's packets, every tile-part in order
};

uint32_t rd16(const uint8_t* p) { return ((uint32_t)p[0] << 8) | p[1]; }
uint32_t rd32(const uint8_t* p) { return (rd16(p) << 16) | rd16(p + 2); }

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
        case 0xff5f: return "progression order changes (POC)";
        case 0xff60: return "packed packet headers (PPM)";
        case 0xff61: return "packed packet headers (PPT)";
        default: return nullptr;
    }
}

void parse_cod(Stream& st, const uint8_t* p, size_t n) {
    if (n < 10) fail(SL_CORRUPT, "a COD marker segment is too short");
    int scod = p[0];
    if (scod & 6) fail(SL_UNSUPPORTED, "SOP/EPH markers are not supported");
    if (p[1] != 0) fail(SL_UNSUPPORTED, "the progression order " + std::to_string(p[1]) +
                                            " is not supported (only LRCP)");
    int layers = (int)rd16(p + 2);
    if (layers != 1) fail(SL_UNSUPPORTED, std::to_string(layers) + " quality layers are not supported (only one)");
    st.mct = p[4];
    if (st.mct > 1) fail(SL_UNSUPPORTED, "the multiple component transform " + std::to_string(st.mct));
    st.levels = p[5];
    if (st.levels > 32) fail(SL_CORRUPT, "more than 32 decomposition levels");
    int xcb = p[6] + 2, ycb = p[7] + 2;
    if (xcb > 10 || ycb > 10 || xcb + ycb > 12) fail(SL_CORRUPT, "a code-block size out of range");
    st.cbw = 1 << xcb;
    st.cbh = 1 << ycb;
    if (p[8] != 0) fail(SL_UNSUPPORTED, "the code-block style " + hex(p[8]).substr(4) +
                                            " is not supported (only style 0)");
    if (p[9] != 1) fail(SL_UNSUPPORTED, "the irreversible 9/7 wavelet is not supported (only 5/3)");
    if (scod & 1) {
        if (n < (size_t)(10 + st.levels + 1)) fail(SL_CORRUPT, "a COD marker segment is too short");
        for (int r = 0; r <= st.levels; ++r)
            if (p[10 + r] != 0xff) fail(SL_UNSUPPORTED, "precincts are not supported (only maximal ones)");
    }
}

void parse_qcd(Stream& st, const uint8_t* p, size_t n) {
    if (n < 1) fail(SL_CORRUPT, "a QCD marker segment is too short");
    if ((p[0] & 0x1f) != 0) fail(SL_UNSUPPORTED, "quantised subbands are not supported (only reversible ones)");
    st.guard = p[0] >> 5;
    st.expn.clear();
    for (size_t i = 1; i < n; ++i) st.expn.push_back(p[i] >> 3);
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
            if (n < 36) fail(SL_CORRUPT, "a SIZ marker segment is too short");
            uint32_t xs = rd32(p + 2), ys = rd32(p + 6), xo = rd32(p + 10), yo = rd32(p + 14);
            uint32_t xt = rd32(p + 18), yt = rd32(p + 22), xto = rd32(p + 26), yto = rd32(p + 30);
            int csiz = (int)rd16(p + 34);
            if (xo || yo) fail(SL_UNSUPPORTED, "an image offset is not supported");
            if (xto || yto || xt < xs || yt < ys) fail(SL_UNSUPPORTED, "several tiles are not supported (only one)");
            if (csiz < 1 || csiz > 4) fail(SL_UNSUPPORTED, std::to_string(csiz) + " components are not supported");
            if (n < (size_t)(36 + 3 * csiz)) fail(SL_CORRUPT, "a SIZ marker segment is too short");
            if (xs == 0 || ys == 0 || xs > 0x7fffffff || ys > 0x7fffffff) fail(SL_CORRUPT, "an empty image");
            st.w = (int)xs;
            st.h = (int)ys;
            st.nc = csiz;
            for (int c = 0; c < csiz; ++c) {
                int ssiz = p[36 + 3 * c];
                if (ssiz & 0x80) fail(SL_UNSUPPORTED, "signed samples are not supported");
                int prec = (ssiz & 0x7f) + 1;
                if (prec != 8 && prec != 16)
                    fail(SL_UNSUPPORTED, "a precision of " + std::to_string(prec) + " bits is not supported (only 8 and 16)");
                if (c && prec != st.prec) fail(SL_UNSUPPORTED, "components of different precisions are not supported");
                st.prec = prec;
                if (p[37 + 3 * c] != 1 || p[38 + 3 * c] != 1)
                    fail(SL_UNSUPPORTED, "sub-sampled components are not supported");
            }
            siz = true;
        } else if (m == 0xff52) {
            parse_cod(st, p, n);
        } else if (m == 0xff5c) {
            parse_qcd(st, p, n);
        } else if (const char* what = marker_refusal(m)) {
            fail(SL_UNSUPPORTED, std::string(what) + " are not supported");
        } else if ((m & 0xff00) != 0xff00) {
            fail(SL_CORRUPT, "a marker expected at byte " + std::to_string(pos));
        }
        pos += 2 + len;
    }
    if (!siz || st.levels < 0 || st.guard < 0) fail(SL_CORRUPT, "the main header lacks SIZ, COD or QCD");
    if (st.mct && st.nc < 3) fail(SL_CORRUPT, "a colour transform of fewer than three components");
    if ((int)st.expn.size() < 3 * st.levels + 1) fail(SL_CORRUPT, "a QCD marker segment is too short");
    // tile-parts
    while (pos + 2 <= size) {
        uint32_t m = rd16(d + pos);
        if (m == 0xffd9) break;
        if (m != 0xff90) fail(SL_CORRUPT, "an SOT marker expected at byte " + std::to_string(pos));
        if (pos + 12 > size) fail(SL_TRUNCATED, "the codestream ends in a tile-part header");
        if (rd16(d + pos + 4) != 0) fail(SL_UNSUPPORTED, "several tiles are not supported (only one)");
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
            if (tm == 0xff52 || tm == 0xff5c || marker_refusal(tm))
                fail(SL_UNSUPPORTED, "a tile-part header's marker " + hex(tm) + " is not supported");
            q += 2 + len;
        }
        st.tile.insert(st.tile.end(), d + q, d + end);
        pos = end;
    }
    return st;
}

struct DecBlock {
    int numbps = 0, passes = 0;
    const uint8_t* data = nullptr;
    size_t len = 0;
};

void decode(const Stream& st, uint16_t* out) {
    const int w = st.w, h = st.h, nc = st.nc, L = st.levels;
    std::vector<std::vector<int32_t>> planes(nc, std::vector<int32_t>((size_t)w * h, 0));
    const uint8_t* p = st.tile.data();
    const uint8_t* end = p + st.tile.size();
    for (int r = 0; r <= L; ++r)
        for (int c = 0; c < nc; ++c) {
            std::vector<Band> bands = bands_of(w, h, L, r);
            std::vector<std::vector<DecBlock>> blocks(bands.size());
            if (p >= end) fail(SL_TRUNCATED, "the tile's data ends before its packets do");
            BitReader br(p, end);
            if (br.bit()) {
                for (size_t bi = 0; bi < bands.size(); ++bi) {
                    const Band& b = bands[bi];
                    if (b.w == 0 || b.h == 0) continue;
                    const int cw = (b.w + st.cbw - 1) / st.cbw, ch = (b.h + st.cbh - 1) / st.cbh;
                    const int band_index = r == 0 ? 0 : 3 * (r - 1) + b.orient;
                    const int band_numbps = st.expn[band_index] + st.guard - 1;
                    TagTree incl, imsb;
                    incl.init(cw, ch);
                    imsb.init(cw, ch);
                    blocks[bi].resize((size_t)cw * ch);
                    for (int k = 0; k < cw * ch; ++k) {
                        DecBlock& db = blocks[bi][k];
                        if (!tag_decode(br, incl, k, 1)) continue;
                        int zero = 0;
                        while (!tag_decode(br, imsb, k, zero)) {
                            if (++zero > 64) fail(SL_CORRUPT, "a zero-bitplane count out of range");
                        }
                        db.numbps = band_numbps + 1 - zero;
                        db.passes = get_numpasses(br);
                        int numlenbits = 3;
                        while (br.bit()) {
                            if (++numlenbits > 32) fail(SL_CORRUPT, "a length indicator out of range");
                        }
                        db.len = br.bits(numlenbits + floorlog2(db.passes));
                    }
                }
            }
            br.align();
            p = br.p;
            for (size_t bi = 0; bi < bands.size(); ++bi)
                for (DecBlock& db : blocks[bi]) {
                    if (!db.passes) continue;
                    if ((size_t)(end - p) < db.len) fail(SL_TRUNCATED, "a code-block's data runs past the tile's");
                    db.data = p;
                    p += db.len;
                }
            for (size_t bi = 0; bi < bands.size(); ++bi) {
                const Band& b = bands[bi];
                if (blocks[bi].empty()) continue;
                const int cw = (b.w + st.cbw - 1) / st.cbw;
                for (size_t k = 0; k < blocks[bi].size(); ++k) {
                    const DecBlock& db = blocks[bi][k];
                    int x0 = (int)(k % cw) * st.cbw, y0 = (int)(k / cw) * st.cbh;
                    int bw = std::min(st.cbw, b.w - x0), bh = std::min(st.cbh, b.h - y0);
                    decode_block(db.data, db.len, db.numbps, db.passes,
                                 planes[c].data() + (size_t)(b.y0 + y0) * w + b.x0 + x0, w, bw, bh, b.orient);
                }
            }
        }
    for (int c = 0; c < nc; ++c) dwt53_inverse(planes[c].data(), w, h, L);
    const size_t n = (size_t)w * h;
    if (st.mct) {
        for (size_t i = 0; i < n; ++i) {
            int32_t y = planes[0][i], u = planes[1][i], v = planes[2][i];
            int32_t g = y - ((u + v) >> 2);
            planes[0][i] = v + g;
            planes[1][i] = g;
            planes[2][i] = u + g;
        }
    }
    const int32_t shift = 1 << (st.prec - 1), hi = (1 << st.prec) - 1;
    for (int c = 0; c < nc; ++c)
        for (size_t i = 0; i < n; ++i) out[i * nc + c] = (uint16_t)std::max(0, std::min(hi, planes[c][i] + shift));
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
        info[0] = st.w;
        info[1] = st.h;
        info[2] = st.nc;
        info[3] = st.prec;
        info[4] = st.levels;
        info[5] = st.mct;
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
