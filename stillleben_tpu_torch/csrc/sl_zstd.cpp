// Zstandard decompression (RFC 8878) for TIFF's ZSTD strips: frames and
// skippable frames; raw, RLE and compressed blocks; literals raw, RLE or
// Huffman-coded (weights direct or FSE-coded, one or four streams, the
// previous tree for treeless literals); sequences with predefined, RLE,
// FSE-coded and repeated tables; repeat offsets; the content checksum
// (XXH64), checked. A frame that names a dictionary is refused by name.
// libtiff's ZSTD codec decodes a strip into its buffer and stops once the
// buffer is full, so the output here stops at ``capacity`` too (a frame
// whose last block fills it still has its checksum checked).

#include "sl_zstd.h"

#include <stdio.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};
[[noreturn]] void corrupt(const std::string& m) { throw Error{2, "ZSTD: " + m}; }

int highest_bit(uint64_t v) {  // index of the highest set bit; v > 0
  int n = -1;
  while (v) {
    v >>= 1;
    n++;
  }
  return n;
}

// a backward bitstream (FSE and Huffman streams): bits are read from the
// end, below the final-bit flag; bits before the start read as zeros
struct BackBits {
  const uint8_t* src;
  int64_t offset;
  BackBits(const uint8_t* s, size_t len) : src(s) {
    if (len == 0) corrupt("empty bitstream");
    if (s[len - 1] == 0) corrupt("bitstream without its final bit");
    offset = int64_t(len) * 8 - (8 - highest_bit(s[len - 1]));
  }
  uint64_t read(int bits) {
    if (bits == 0) return 0;
    offset -= bits;
    int64_t off = offset;
    int actual = bits;
    if (off < 0) {
      actual += int(off);
      off = 0;
    }
    uint64_t res = 0;
    for (int i = 0; i < actual; i++) {
      int64_t b = off + i;
      res |= uint64_t((src[b >> 3] >> (b & 7)) & 1) << i;
    }
    if (offset < 0) res = -offset >= 64 ? 0 : res << -offset;
    return res;
  }
};

// a forward little-endian bitstream (FSE table descriptions)
struct FwdBits {
  const uint8_t* src;
  size_t len;
  size_t bit = 0;
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++, bit++) {
      if ((bit >> 3) >= len) corrupt("truncated table description");
      v |= uint32_t((src[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes() const { return (bit + 7) >> 3; }
};

struct Fse {
  int log = 0;
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;

  void build(const int16_t* norm, int nsym, int accuracy) {
    log = accuracy;
    size_t size = size_t(1) << accuracy;
    symbol.assign(size, 0);
    bits.assign(size, 0);
    base.assign(size, 0);
    std::vector<uint16_t> next(nsym > 0 ? nsym : 1);
    size_t high = size;
    for (int s = 0; s < nsym; s++)
      if (norm[s] == -1) {
        symbol[--high] = uint8_t(s);
        next[s] = 1;
      }
    size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; s++) {
      if (norm[s] <= 0) continue;
      next[s] = uint16_t(norm[s]);
      for (int i = 0; i < norm[s]; i++) {
        symbol[pos] = uint8_t(s);
        do {
          pos = (pos + step) & mask;
        } while (pos >= high);
      }
    }
    if (pos != 0) corrupt("bad FSE distribution");
    for (size_t i = 0; i < size; i++) {
      uint16_t d = next[symbol[i]]++;
      bits[i] = uint8_t(accuracy - highest_bit(d));
      base[i] = uint16_t((uint32_t(d) << bits[i]) - size);
    }
  }
  void rle(uint8_t s) {
    log = 0;
    symbol.assign(1, s);
    bits.assign(1, 0);
    base.assign(1, 0);
  }
  // the table description; returns the bytes it took
  size_t read_header(const uint8_t* p, size_t len, int max_log, int max_symbols) {
    FwdBits in{p, len};
    int accuracy = 5 + int(in.read(4));
    if (accuracy > max_log) corrupt("FSE accuracy too large");
    int32_t remaining = 1 << accuracy;
    std::vector<int16_t> freq;
    while (remaining > 0 && int(freq.size()) < max_symbols) {
      int nbits = highest_bit(uint64_t(remaining) + 1) + 1;
      uint32_t val = in.read(nbits);
      uint32_t lower = (1u << (nbits - 1)) - 1;
      uint32_t threshold = (1u << nbits) - 1 - (uint32_t(remaining) + 1);
      if ((val & lower) < threshold) {
        in.bit--;
        val &= lower;
      } else if (val > lower) {
        val -= threshold;
      }
      int16_t proba = int16_t(int(val) - 1);
      remaining -= proba < 0 ? -proba : proba;
      freq.push_back(proba);
      if (proba == 0) {
        uint32_t repeat = in.read(2);
        for (;;) {
          for (uint32_t i = 0; i < repeat && int(freq.size()) < max_symbols; i++) freq.push_back(0);
          if (repeat != 3) break;
          repeat = in.read(2);
        }
      }
    }
    if (remaining != 0) corrupt("bad FSE distribution");
    build(freq.data(), int(freq.size()), accuracy);
    return in.bytes();
  }
  uint8_t peek(uint32_t state) const { return symbol[state]; }
  void update(uint32_t& state, BackBits& b) const {
    uint32_t rest = uint32_t(b.read(bits[state]));
    state = base[state] + rest;
  }
};

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;
  bool present = false;

  void from_weights(const uint8_t* w, int n) {
    if (n + 1 > 256) corrupt("too many Huffman symbols");
    uint64_t sum = 0;
    for (int i = 0; i < n; i++) {
      if (w[i] > 11) corrupt("Huffman weight too large");
      sum += w[i] ? uint64_t(1) << (w[i] - 1) : 0;
    }
    if (sum == 0) corrupt("no Huffman weights");
    int mb = highest_bit(sum) + 1;
    uint64_t left = (uint64_t(1) << mb) - sum;
    if (left & (left - 1)) corrupt("bad Huffman weights");
    int last = highest_bit(left) + 1;
    std::vector<uint8_t> nb(n + 1);
    for (int i = 0; i < n; i++) nb[i] = w[i] ? uint8_t(mb + 1 - w[i]) : 0;
    nb[n] = uint8_t(mb + 1 - last);
    build(nb.data(), n + 1);
  }
  void build(const uint8_t* nb, int n) {
    int mb = 0;
    uint32_t rank_count[13] = {0};
    for (int i = 0; i < n; i++) {
      if (nb[i] > 11) corrupt("Huffman table too deep");
      if (nb[i] > mb) mb = nb[i];
      rank_count[nb[i]]++;
    }
    size_t size = size_t(1) << mb;
    max_bits = mb;
    symbol.assign(size, 0);
    bits.assign(size, 0);
    uint32_t rank_idx[13];
    rank_idx[mb] = 0;
    for (int i = mb; i >= 1; i--) {
      rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (mb - i));
      if (rank_idx[i - 1] > size) corrupt("bad Huffman table");
      memset(&bits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
    }
    if (rank_idx[0] != size) corrupt("bad Huffman table");
    for (int i = 0; i < n; i++)
      if (nb[i]) {
        uint32_t code = rank_idx[nb[i]];
        uint32_t len = 1u << (mb - nb[i]);
        memset(&symbol[code], i, len);
        rank_idx[nb[i]] += len;
      }
    present = true;
  }
  // one stream of ``count`` symbols
  void stream(const uint8_t* p, size_t len, uint8_t* out, size_t count) const {
    BackBits b(p, len);
    uint32_t mask = (1u << max_bits) - 1;
    uint32_t state = uint32_t(b.read(max_bits));
    for (size_t i = 0; i < count; i++) {
      out[i] = symbol[state];
      int n = bits[state];
      state = ((state << n) + uint32_t(b.read(n))) & mask;
    }
    if (b.offset != -max_bits) corrupt("a Huffman stream not consumed exactly");
  }
};

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLExtraBase[21] = {35,  37,  39,   41,   43,   47,   51,    59,    67,    83,   99,
                                   131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};

uint32_t ml_base(int code) { return code < 32 ? uint32_t(code + 3) : kMLExtraBase[code - 32]; }

// XXH64 (the frame checksum's low 32 bits)
const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;
uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t rd64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}
uint32_t rd32(const uint8_t* p) { return uint32_t(p[0]) | p[1] << 8 | p[2] << 16 | uint32_t(p[3]) << 24; }
uint64_t round1(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
uint64_t merge(uint64_t acc, uint64_t v) { return (acc ^ round1(0, v)) * P1 + P4; }
uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, rd64(p));
      v2 = round1(v2, rd64(p + 8));
      v3 = round1(v3, rd64(p + 16));
      v4 = round1(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= round1(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Frame {
  std::vector<uint8_t>& out;  // the whole output; this frame starts at ``start``
  size_t start;
  Huffman huf;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;

  Frame(std::vector<uint8_t>& o) : out(o), start(o.size()) {}

  void literals(const uint8_t* p, size_t len, size_t& used) {
    if (len < 1) corrupt("truncated literals");
    int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
    size_t regen, comp = 0, head;
    if (type < 2) {
      if (fmt == 0 || fmt == 2) {
        regen = p[0] >> 3;
        head = 1;
      } else if (fmt == 1) {
        if (len < 2) corrupt("truncated literals");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
        head = 2;
      } else {
        if (len < 3) corrupt("truncated literals");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
        head = 3;
      }
      lit.resize(regen);
      if (type == 0) {
        if (head + regen > len) corrupt("truncated raw literals");
        memcpy(lit.data(), p + head, regen);
        used = head + regen;
      } else {
        if (head + 1 > len) corrupt("truncated RLE literals");
        memset(lit.data(), p[head], regen);
        used = head + 1;
      }
      return;
    }
    int streams = fmt == 0 ? 1 : 4;
    if (fmt < 2) {
      if (len < 3) corrupt("truncated literals");
      uint32_t h = p[0] | p[1] << 8 | p[2] << 16;
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
      head = 3;
    } else if (fmt == 2) {
      if (len < 4) corrupt("truncated literals");
      uint32_t h = rd32(p);
      regen = (h >> 4) & 0x3FFF;
      comp = (h >> 18) & 0x3FFF;
      head = 4;
    } else {
      if (len < 5) corrupt("truncated literals");
      uint64_t h = rd32(p) | uint64_t(p[4]) << 32;
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
      head = 5;
    }
    if (head + comp > len) corrupt("truncated Huffman literals");
    const uint8_t* q = p + head;
    size_t qlen = comp;
    if (type == 2) {  // the tree description
      size_t t = tree(q, qlen);
      q += t;
      qlen -= t;
    } else if (!huf.present) {
      corrupt("treeless literals without a previous tree");
    }
    lit.resize(regen);
    if (streams == 1) {
      huf.stream(q, qlen, lit.data(), regen);
    } else {
      if (qlen < 6) corrupt("truncated jump table");
      size_t s1 = q[0] | q[1] << 8, s2 = q[2] | q[3] << 8, s3 = q[4] | q[5] << 8;
      if (6 + s1 + s2 + s3 > qlen) corrupt("bad jump table");
      size_t s4 = qlen - 6 - s1 - s2 - s3;
      size_t per = (regen + 3) / 4;
      if (3 * per > regen) corrupt("too few literals for four streams");
      const uint8_t* d = q + 6;
      huf.stream(d, s1, lit.data(), per);
      huf.stream(d + s1, s2, lit.data() + per, per);
      huf.stream(d + s1 + s2, s3, lit.data() + 2 * per, per);
      huf.stream(d + s1 + s2 + s3, s4, lit.data() + 3 * per, regen - 3 * per);
    }
    used = head + comp;
  }

  size_t tree(const uint8_t* p, size_t len) {
    if (len < 1) corrupt("truncated Huffman tree");
    int hb = p[0];
    std::vector<uint8_t> w;
    size_t used;
    if (hb >= 128) {
      int n = hb - 127;
      used = 1 + size_t((n + 1) / 2);
      if (used > len) corrupt("truncated Huffman weights");
      for (int i = 0; i < n; i++) w.push_back(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
    } else {
      used = 1 + size_t(hb);
      if (used > len || hb == 0) corrupt("truncated Huffman weights");
      Fse t;
      size_t h = t.read_header(p + 1, size_t(hb), 6, 256);
      if (h >= size_t(hb)) corrupt("bad Huffman weights");
      BackBits b(p + 1 + h, size_t(hb) - h);
      uint32_t s1 = uint32_t(b.read(t.log)), s2 = uint32_t(b.read(t.log));
      for (;;) {
        if (w.size() > 255) corrupt("too many Huffman weights");
        w.push_back(t.peek(s1));
        t.update(s1, b);
        if (b.offset < 0) {
          w.push_back(t.peek(s2));
          break;
        }
        w.push_back(t.peek(s2));
        t.update(s2, b);
        if (b.offset < 0) {
          w.push_back(t.peek(s1));
          break;
        }
      }
    }
    huf.from_weights(w.data(), int(w.size()));
    return used;
  }

  // one table of the sequences section: returns the bytes it took
  size_t table(Fse& t, bool& have, int mode, const uint8_t* p, size_t len, const int16_t* norm,
               int nnorm, int accuracy, int max_log, int max_symbols) {
    switch (mode) {
      case 0:
        t.build(norm, nnorm, accuracy);
        have = true;
        return 0;
      case 1:
        if (len < 1) corrupt("truncated RLE table");
        t.rle(p[0]);
        have = true;
        return 1;
      case 2: {
        size_t n = t.read_header(p, len, max_log, max_symbols);
        have = true;
        return n;
      }
      default:
        if (!have) corrupt("a repeated table with none before it");
        return 0;
    }
  }

  void block(const uint8_t* p, size_t len) {
    size_t used = 0;
    literals(p, len, used);
    p += used;
    len -= used;
    if (len < 1) corrupt("truncated sequences");
    size_t nseq;
    if (p[0] < 128) {
      nseq = p[0];
      p += 1;
      len -= 1;
    } else if (p[0] < 255) {
      if (len < 2) corrupt("truncated sequences");
      nseq = (size_t(p[0] - 128) << 8) + p[1];
      p += 2;
      len -= 2;
    } else {
      if (len < 3) corrupt("truncated sequences");
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
      len -= 3;
    }
    size_t lpos = 0;
    if (nseq > 0) {
      if (len < 1) corrupt("truncated sequences");
      int modes = p[0];
      if (modes & 3) corrupt("reserved sequence modes");
      p += 1;
      len -= 1;
      size_t n = table(ll, have_ll, modes >> 6, p, len, kLLNorm, 36, 6, 9, 36);
      p += n;
      len -= n;
      n = table(of, have_of, (modes >> 4) & 3, p, len, kOFNorm, 29, 5, 8, 32);
      p += n;
      len -= n;
      n = table(ml, have_ml, (modes >> 2) & 3, p, len, kMLNorm, 53, 6, 9, 53);
      p += n;
      len -= n;
      BackBits b(p, len);
      uint32_t sll = uint32_t(b.read(ll.log)), sof = uint32_t(b.read(of.log)),
               sml = uint32_t(b.read(ml.log));
      for (size_t i = 0; i < nseq; i++) {
        int ofc = of.peek(sof), llc = ll.peek(sll), mlc = ml.peek(sml);
        if (llc > 35 || mlc > 52 || ofc > 31) corrupt("bad sequence code");
        uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
        uint64_t mlen = ml_base(mlc) + b.read(kMLBits[mlc]);
        uint64_t llen = kLLBase[llc] + b.read(kLLBits[llc]);
        if (i + 1 < nseq) {
          ll.update(sll, b);
          ml.update(sml, b);
          of.update(sof, b);
        }
        uint64_t offset;
        if (ofv <= 3) {
          uint64_t idx = ofv - 1 + (llen == 0);
          if (idx == 0) {
            offset = rep[0];
          } else {
            offset = idx < 3 ? rep[idx] : rep[0] - 1;
            if (idx > 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = offset;
          }
        } else {
          offset = ofv - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
        if (llen > lit.size() - lpos) corrupt("a sequence past its literals");
        out.insert(out.end(), lit.begin() + long(lpos), lit.begin() + long(lpos + llen));
        lpos += llen;
        if (offset == 0 || offset > out.size() - start) corrupt("a match before the frame");
        size_t from = out.size() - offset;
        for (uint64_t k = 0; k < mlen; k++) out.push_back(out[from + k]);
      }
      if (b.offset != 0) corrupt("sequence bits not consumed exactly");
    }
    out.insert(out.end(), lit.begin() + long(lpos), lit.end());
  }
};

size_t decode(const uint8_t* d, size_t n, std::vector<uint8_t>& out, size_t capacity) {
  size_t pos = 0;
  while (pos < n && out.size() < capacity) {
    if (n - pos < 4) corrupt("truncated frame");
    uint32_t magic = rd32(d + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - pos < 8) corrupt("truncated skippable frame");
      size_t len = rd32(d + pos + 4);
      if (len > n - pos - 8) corrupt("truncated skippable frame");
      pos += 8 + len;
      continue;
    }
    if (magic != 0xFD2FB528u) corrupt("not a frame");
    pos += 4;
    if (pos >= n) corrupt("truncated frame header");
    int desc = d[pos++];
    int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1;
    int dict_flag = desc & 3;
    if (desc & 8) corrupt("reserved frame header bit");
    size_t skip = (single ? 0 : 1);
    size_t dict_bytes = dict_flag == 0 ? 0 : size_t(1) << (dict_flag - 1);
    size_t fcs_bytes = fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
    if (pos + skip + dict_bytes + fcs_bytes > n) corrupt("truncated frame header");
    uint32_t dict_id = 0;
    for (size_t i = 0; i < dict_bytes; i++) dict_id |= uint32_t(d[pos + skip + i]) << (8 * i);
    if (dict_id) throw Error{1, "ZSTD: a frame compressed with dictionary " +
                                    std::to_string(dict_id) + " is not supported"};
    pos += skip + dict_bytes + fcs_bytes;
    Frame f(out);
    for (;;) {
      if (pos + 3 > n) corrupt("truncated block header");
      uint32_t bh = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16;
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) corrupt("reserved block type");
      if (type == 1) {
        if (pos + 1 > n) corrupt("truncated RLE block");
        out.insert(out.end(), size, d[pos]);
        pos += 1;
      } else {
        if (size > n - pos) corrupt("truncated block");
        if (type == 0)
          out.insert(out.end(), d + pos, d + pos + size);
        else
          f.block(d + pos, size);
        pos += size;
      }
      if (last) break;
      if (out.size() >= capacity) return pos;  // libtiff's buffer is full
    }
    if (checksum) {
      if (pos + 4 > n) corrupt("truncated checksum");
      uint32_t want = rd32(d + pos);
      if (uint32_t(xxh64(out.data() + f.start, out.size() - f.start)) != want)
        corrupt("checksum mismatch");
      pos += 4;
    }
  }
  return pos;
}

}  // namespace

extern "C" int sl_zstd_decompress(const uint8_t* data, size_t size, uint8_t* out, size_t capacity,
                                  size_t* written, char* err, int errlen) {
  *written = 0;
  try {
    std::vector<uint8_t> buf;
    decode(data, size, buf, capacity);
    size_t n = buf.size() < capacity ? buf.size() : capacity;
    memcpy(out, buf.data(), n);
    *written = n;
    return 0;
  } catch (const Error& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.msg.c_str());
    return e.code;
  } catch (const std::exception& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "ZSTD: %s", e.what());
    return 2;
  }
}
