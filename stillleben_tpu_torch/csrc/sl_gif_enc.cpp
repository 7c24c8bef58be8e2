// The port's GIF encoder core; see sl_gif_enc.h.
//
// The quantisers follow Pillow 12's libImaging, rule for rule:
// - Quant.c's median cut (method 0, kmeans 0) with QuantHash.c's pixel
//   hash and QuantHeap.c's box heap. The hash keys a colour by a 32-bit
//   hash of its channels shifted right by ``scale``; two colours whose
//   hashes are equal share an entry. While the table holds more than 65536
//   entries the scale grows by one and the table is rehashed in place,
//   entries that meet summing their counts. A bucket's chain is sorted by
//   hash, the table's length grows and shrinks by Pillow's prime search
//   (which, as written there, takes the first odd length whose low nibble
//   is 1, 3, 7, 9, 11 or 13), and an entry keeps the key it was last
//   updated with. The boxes split along the channel of the widest
//   weighted range (77 R, 150 G, 29 B), at the first colour whose running
//   count passes half the box (with the whole run of its value); the
//   three channel lists are sorted by Pillow's linked-list merge sort,
//   descending, the right run first where values tie. A box's colour is
//   the rounded mean of its pixels; a pixel then takes the nearest entry
//   among those its box's entry is near (squared distance, ties to the
//   first in the distance table sorted stably, as glibc's qsort sorts).
// - QuantOctree.c's fast octree (method 2) of RGBA: a fine cube of 3/4/3/3
//   bits and a coarse one of 2/2/2/2, the fine buckets sorted stably by
//   count, the most used taking the palette's room beside the coarse
//   buckets they do not empty; a bucket's colour is its mean in
//   single-precision floats, truncated. The transparent pixels first take
//   the colour of the first transparent pixel (Quantize.c).
// Both quantise to 256 colours, as Pillow's GIF writer asks.
// The LZW follows GifEncode.c (Pillow >= 9): a clear code first, the code
// width grown when the code just added exceeds the width's largest, a
// clear code in place of the 4096th entry, the end code, and the data cut
// into sub-blocks of at most 255 bytes within the encoder's buffers.
// Build: g++ -O3 -shared -fPIC -std=c++17 (no -ffast-math: the octree's
// means are single-precision divisions).

#include "sl_gif_enc.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <deque>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  int code;
  Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.what());
  return e.code;
}

union Pixel {
  struct {
    uint8_t r, g, b, a;
  } c;
  uint8_t v[4];
  uint32_t u;
};

inline uint32_t dist_sqr(const Pixel& p, const Pixel& q) {
  int dr = (int)p.c.r - (int)q.c.r, dg = (int)p.c.g - (int)q.c.g, db = (int)p.c.b - (int)q.c.b;
  return (uint32_t)(dr * dr + dg * dg + db * db);
}

// ---------------------------------------------------------------------------
// QuantHash.c with Quant.c's scaled pixel hash
// ---------------------------------------------------------------------------

const uint32_t COLORS = 256;  // the palette size Pillow's GIF writer asks for
const uint32_t MAX_HASH_ENTRIES = 65536;
const uint32_t MIN_LENGTH = 11;
const uint32_t RESIZE_FACTOR = 3;

inline uint32_t pixel_hash(uint32_t r, uint32_t g, uint32_t b) {
  return (r * 463u) ^ ((g << 8) * 10069u) ^ ((b << 16) * 64997u);
}

struct HashNode {
  HashNode* next;
  Pixel key;
  uint32_t value;
};

uint32_t find_prime(uint32_t start, int dir) {
  static const int unit[16] = {0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0};
  while (start > 1 && !unit[start & 0x0f]) start += dir;
  return start;
}

class PixelHash {
 public:
  uint32_t scale = 0;
  uint32_t count = 0;
  std::vector<HashNode*> table;

  // ``capacity``: the most entries the table will ever hold (the pixels)
  explicit PixelHash(size_t capacity) : table(MIN_LENGTH, nullptr) { nodes_.reserve(capacity); }

  uint32_t hash(Pixel p) const { return pixel_hash(p.c.r >> scale, p.c.g >> scale, p.c.b >> scale); }
  int cmp(Pixel a, Pixel b) const {
    uint32_t A = hash(a), B = hash(b);
    return A == B ? 0 : A < B ? -1 : 1;
  }

  // hashtable_insert_or_update_computed with Quant.c's counting functions
  void count_pixel(Pixel key) {
    HashNode** n;
    for (n = &table[hash(key) % table.size()]; *n; n = &(*n)->next) {
      int i = cmp((*n)->key, key);
      if (!i) {
        (*n)->key = key;
        (*n)->value += 1;
        return;
      }
      if (i > 0) break;
    }
    nodes_.push_back(HashNode{*n, key, 1});  // never reallocates: reserved
    *n = &nodes_.back();
    count++;
    resize();
  }

  // hashtable_rehash_compute(h, rehash_collide) after the scale grew
  void rehash_summing() { rehash((uint32_t)table.size(), true); }

  // hashtable_insert: set the value of the entry of ``key`` (every key
  // inserted after the counting has its entry)
  void set(Pixel key, uint32_t value) {
    for (HashNode* n = table[hash(key) % table.size()]; n; n = n->next) {
      int i = cmp(n->key, key);
      if (!i) {
        n->value = value;
        return;
      }
      if (i > 0) break;
    }
    throw Error(SL_CORRUPT, "median cut: a box colour lost its hash entry");
  }

  uint32_t lookup(Pixel key) const {
    for (HashNode* n = table[hash(key) % table.size()]; n; n = n->next) {
      int i = cmp(n->key, key);
      if (!i) return n->value;
      if (i > 0) break;
    }
    throw Error(SL_CORRUPT, "median cut: pixel lookup failed");
  }

 private:
  std::vector<HashNode> nodes_;

  void insert_node(HashNode* node, bool summing) {
    HashNode** n;
    for (n = &table[hash(node->key) % table.size()]; *n; n = &(*n)->next) {
      int i = cmp((*n)->key, node->key);
      if (!i) {
        (*n)->key = node->key;
        (*n)->value = summing ? (*n)->value + node->value : node->value;
        return;
      }
      if (i > 0) break;
    }
    node->next = *n;
    *n = node;
    count++;
  }

  void rehash(uint32_t new_size, bool summing) {
    std::vector<HashNode*> old(new_size, nullptr);
    old.swap(table);
    count = 0;
    for (HashNode* head : old) {
      for (HashNode *n = head, *nn; n; n = nn) {
        nn = n->next;
        insert_node(n, summing);
      }
    }
  }

  void resize() {
    uint32_t length = (uint32_t)table.size(), new_size = length;
    if (count * RESIZE_FACTOR < length) {
      new_size = find_prime(length / 2 - 1, -1);
    } else if (length * RESIZE_FACTOR < count) {
      new_size = find_prime(length * 2 + 1, +1);
    }
    if (new_size < MIN_LENGTH) new_size = length;
    if (new_size != length) rehash(new_size, false);
  }
};

// ---------------------------------------------------------------------------
// Quant.c: the median cut
// ---------------------------------------------------------------------------

struct PixelList {
  PixelList *next[3], *prev[3];
  Pixel p;
  unsigned flag;
  int count;
};

struct BoxNode {
  BoxNode *l, *r;
  PixelList *head[3], *tail[3];
  int axis;
  int volume;
  uint32_t pixel_count;
};

PixelList* mergesort_pixels(PixelList* head, int i) {
  PixelList *c, *t, *a, *b, *p;
  if (!head || !head->next[i]) {
    if (head) {
      head->next[i] = nullptr;
      head->prev[i] = nullptr;
    }
    return head;
  }
  for (c = t = head; c && t; c = c->next[i], t = (t->next[i]) ? t->next[i]->next[i] : nullptr) {
  }
  if (c) {
    if (c->prev[i]) c->prev[i]->next[i] = nullptr;
    c->prev[i] = nullptr;
  }
  a = mergesort_pixels(head, i);
  b = mergesort_pixels(c, i);
  head = nullptr;
  p = nullptr;
  while (a && b) {
    if (a->p.v[i] > b->p.v[i]) {
      c = a;
      a = a->next[i];
    } else {
      c = b;
      b = b->next[i];
    }
    c->prev[i] = p;
    c->next[i] = nullptr;
    if (p) p->next[i] = c;
    p = c;
    if (!head) head = c;
  }
  if (a) {
    c->next[i] = a;
    a->prev[i] = c;
  } else if (b) {
    c->next[i] = b;
    b->prev[i] = c;
  }
  return head;
}

int box_cmp(const BoxNode* a, const BoxNode* b) { return (int)a->pixel_count - (int)b->pixel_count; }

// QuantHeap.c: a max-heap by pixel count, 1-based
class BoxHeap {
 public:
  void add(BoxNode* val) {
    heap_.push_back(nullptr);
    size_t k = heap_.size() - 1;
    while (k != 1) {
      if (box_cmp(val, heap_[k / 2]) <= 0) break;
      heap_[k] = heap_[k / 2];
      k >>= 1;
    }
    heap_[k] = val;
  }
  bool remove(BoxNode** r) {
    size_t count = heap_.size() - 1;
    if (!count) return false;
    *r = heap_[1];
    BoxNode* v = heap_[count];
    heap_.pop_back();
    count--;
    size_t k, l;
    for (k = 1; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && box_cmp(heap_[l], heap_[l + 1]) < 0) l++;
      if (box_cmp(v, heap_[l]) > 0) break;
      heap_[k] = heap_[l];
    }
    if (count) heap_[k] = v;
    return true;
  }

 private:
  std::vector<BoxNode*> heap_{nullptr};
};

int box_volume(BoxNode* b) {
  if (b->volume >= 0) return b->volume;
  if (!b->head[0]) {
    b->volume = 0;
  } else {
    int rh = b->head[0]->p.c.r, rl = b->tail[0]->p.c.r;
    int gh = b->head[1]->p.c.g, gl = b->tail[1]->p.c.g;
    int bh = b->head[2]->p.c.b, bl = b->tail[2]->p.c.b;
    b->volume = (rh - rl + 1) * (gh - gl + 1) * (bh - bl + 1);
  }
  return b->volume;
}

void split_lists(PixelList* h[3], PixelList* t[3], PixelList* nh[2][3], PixelList* nt[2][3],
                 uint32_t ncount[2], int axis, uint32_t pixel_count) {
  uint32_t left;
  PixelList *c, *n;
  ncount[0] = ncount[1] = 0;
  int n_right = 0;
  for (left = 0, c = h[axis]; c;) {
    left = left + (uint32_t)c->count;
    ncount[0] += (uint32_t)c->count;
    c->flag = 0;
    c = c->next[axis];
    if (left * 2 > pixel_count) break;
  }
  if (c) {
    int split_value = c->prev[axis]->p.v[axis];
    for (; c; c = c->next[axis]) {
      if (split_value != c->p.v[axis]) break;
      c->flag = 0;
      ncount[0] += (uint32_t)c->count;
    }
  }
  for (; c; c = c->next[axis]) {
    c->flag = 1;
    n_right++;
    ncount[1] += (uint32_t)c->count;
  }
  if (!n_right) {
    int split_value = t[axis]->p.v[axis];
    for (c = t[axis]; c; c = c->prev[axis]) {
      if (split_value != c->p.v[axis]) break;
      c->flag = 1;
      ncount[0] -= (uint32_t)c->count;
      ncount[1] += (uint32_t)c->count;
    }
  }
  for (int i = 0; i < 3; i++) {
    PixelList *l = nullptr, *r = nullptr;
    nh[0][i] = nt[0][i] = nh[1][i] = nt[1][i] = nullptr;
    for (c = h[i]; c; c = n) {
      n = c->next[i];
      if (c->flag) {
        if (r) {
          r->next[i] = c;
        } else {
          nh[1][i] = c;
        }
        c->prev[i] = r;
        r = c;
      } else {
        if (l) {
          l->next[i] = c;
        } else {
          nh[0][i] = c;
        }
        c->prev[i] = l;
        l = c;
      }
    }
    if (l) l->next[i] = nullptr;
    if (r) r->next[i] = nullptr;
    nt[0][i] = l;
    nt[1][i] = r;
  }
}

void split(BoxNode* node, std::deque<BoxNode>& boxes) {
  int f[3] = {(node->head[0]->p.c.r - node->tail[0]->p.c.r) * 77,
              (node->head[1]->p.c.g - node->tail[1]->p.c.g) * 150,
              (node->head[2]->p.c.b - node->tail[2]->p.c.b) * 29};
  int best = f[0], axis = 0;
  for (int i = 1; i < 3; i++) {
    if (best < f[i]) {
      best = f[i];
      axis = i;
    }
  }
  PixelList *heads[2][3], *tails[2][3];
  uint32_t counts[2];
  split_lists(node->head, node->tail, heads, tails, counts, axis, node->pixel_count);
  boxes.push_back(BoxNode{});
  BoxNode* left = &boxes.back();
  boxes.push_back(BoxNode{});
  BoxNode* right = &boxes.back();
  for (int i = 0; i < 3; i++) {
    left->head[i] = heads[0][i];
    left->tail[i] = tails[0][i];
    right->head[i] = heads[1][i];
    right->tail[i] = tails[1][i];
    node->head[i] = node->tail[i] = nullptr;
  }
  left->volume = right->volume = -1;
  left->pixel_count = counts[0];
  right->pixel_count = counts[1];
  left->axis = right->axis = -1;
  left->l = left->r = right->l = right->r = nullptr;
  node->l = left;
  node->r = right;
  node->axis = axis;
}

BoxNode* median_cut(PixelList* hl[3], uint32_t image_pixels, int n_boxes,
                    std::deque<BoxNode>& boxes) {
  boxes.push_back(BoxNode{});
  BoxNode* root = &boxes.back();
  for (int i = 0; i < 3; i++) {
    PixelList* tl = hl[i];
    while (tl && tl->next[i]) tl = tl->next[i];
    root->head[i] = hl[i];
    root->tail[i] = tl;
  }
  root->l = root->r = nullptr;
  root->axis = -1;
  root->volume = -1;
  root->pixel_count = image_pixels;
  BoxHeap heap;
  heap.add(root);
  while (--n_boxes) {
    BoxNode* node;
    do {
      if (!heap.remove(&node)) return root;
    } while (box_volume(node) == 1);
    split(node, boxes);
    heap.add(node->l);
    heap.add(node->r);
  }
  return root;
}

void annotate(BoxNode* n, PixelHash& h, uint32_t* box) {
  if (n->l && n->r) {
    annotate(n->l, h, box);
    annotate(n->r, h, box);
    return;
  }
  for (PixelList* p = n->head[0]; p; p = p->next[0]) {
    Pixel q = p->p;
    q.c.r = (uint8_t)(p->p.c.r << h.scale);
    q.c.g = (uint8_t)(p->p.c.g << h.scale);
    q.c.b = (uint8_t)(p->p.c.b << h.scale);
    h.set(q, *box);
  }
  if (n->head[0]) (*box)++;
}

// The palette entry each distinct colour was mapped to (Quant.c keeps a
// hash table of them; the mapping is a function of the colour, so any map
// gives the same indices): open addressing over 24-bit colours.
class ColourCache {
 public:
  explicit ColourCache(size_t n) {
    size_t size = 64;
    while (size < 2 * n) size <<= 1;
    keys_.assign(size, EMPTY);
    vals_.assign(size, 0);
    mask_ = size - 1;
  }
  int find(uint32_t rgb) const {
    for (size_t at = slot(rgb);; at = (at + 1) & mask_) {
      if (keys_[at] == rgb) return vals_[at];
      if (keys_[at] == EMPTY) return -1;
    }
  }
  void insert(uint32_t rgb, uint8_t v) {
    size_t at = slot(rgb);
    while (keys_[at] != EMPTY) at = (at + 1) & mask_;
    keys_[at] = rgb;
    vals_[at] = v;
  }

 private:
  static constexpr uint32_t EMPTY = 0xFFFFFFFFu;
  std::vector<uint32_t> keys_;
  std::vector<uint8_t> vals_;
  size_t mask_;
  size_t slot(uint32_t rgb) const { return (size_t)((rgb * 2654435761u) >> 8) & mask_; }
};

// quantize() of Quant.c without k-means
void quantize_median(const std::vector<Pixel>& pix, std::vector<Pixel>& palette, uint8_t* index) {
  const uint32_t npix = (uint32_t)pix.size();
  PixelHash h(npix);
  for (uint32_t i = 0; i < npix; i++) {
    h.count_pixel(pix[i]);
    while (h.count > MAX_HASH_ENTRIES) {
      h.scale++;
      h.rehash_summing();
    }
  }
  // hash_to_list: each entry (its key scaled) goes to the front of the
  // three lists, in the table's order
  std::vector<PixelList> items(h.count);
  PixelList* hl[3] = {nullptr, nullptr, nullptr};
  size_t at = 0;
  for (HashNode* head : h.table) {
    for (HashNode* n = head; n; n = n->next) {
      PixelList* p = &items[at++];
      p->flag = 0;
      p->p = n->key;
      p->p.c.r = (uint8_t)(n->key.c.r >> h.scale);
      p->p.c.g = (uint8_t)(n->key.c.g >> h.scale);
      p->p.c.b = (uint8_t)(n->key.c.b >> h.scale);
      p->count = (int)n->value;
      for (int i = 0; i < 3; i++) {
        p->next[i] = hl[i];
        p->prev[i] = nullptr;
        if (hl[i]) hl[i]->prev[i] = p;
        hl[i] = p;
      }
    }
  }
  for (int i = 0; i < 3; i++) hl[i] = mergesort_pixels(hl[i], i);
  std::deque<BoxNode> boxes;
  BoxNode* root = median_cut(hl, npix, (int)COLORS, boxes);
  uint32_t n_entries = 0;
  annotate(root, h, &n_entries);

  // compute_palette_from_median_cut
  std::vector<uint32_t> sum(3 * (size_t)n_entries, 0), count(n_entries, 0);
  std::vector<uint32_t> box_of(npix);
  for (uint32_t i = 0; i < npix; i++) {
    uint32_t e = h.lookup(pix[i]);
    if (e >= n_entries) throw Error(SL_CORRUPT, "median cut: box index out of range");
    box_of[i] = e;
    sum[3 * e] += pix[i].c.r;
    sum[3 * e + 1] += pix[i].c.g;
    sum[3 * e + 2] += pix[i].c.b;
    count[e]++;
  }
  palette.assign(n_entries, Pixel{});
  for (uint32_t e = 0; e < n_entries; e++) {
    for (int c = 0; c < 3; c++) {
      palette[e].v[c] = (uint8_t)(int)(.5 + (double)sum[3 * e + c] / (double)count[e]);
    }
  }

  // build_distance_tables: each row's entries sorted stably by distance
  const size_t n = n_entries;
  std::vector<uint32_t> dist(n * n, 0);
  for (size_t i = 0; i < n; i++) {
    for (size_t j = 0; j < i; j++) dist[j * n + i] = dist[i * n + j] = dist_sqr(palette[i], palette[j]);
  }
  std::vector<uint16_t> order(n * n);
  for (size_t i = 0; i < n; i++) {
    uint16_t* row = &order[i * n];
    const uint32_t* d = &dist[i * n];
    for (size_t j = 0; j < n; j++) row[j] = (uint16_t)j;
    std::stable_sort(row, row + n, [d](uint16_t a, uint16_t b) { return d[a] < d[b]; });
  }

  // map_image_pixels_from_median_box: the nearest entry among those whose
  // distance to the box's entry is at most 4x the pixel's to it
  ColourCache cache(npix);
  for (uint32_t i = 0; i < npix; i++) {
    const uint32_t rgb = pix[i].u & 0xFFFFFFu;
    int hit = cache.find(rgb);
    if (hit >= 0) {
      index[i] = (uint8_t)hit;
      continue;
    }
    const uint32_t e = box_of[i];
    uint32_t best = dist_sqr(palette[e], pix[i]), match = e;
    const uint32_t reach = best << 2;
    const uint16_t* row = &order[e * n];
    const uint32_t* d = &dist[e * n];
    for (size_t j = 0; j < n; j++) {
      const uint32_t idx = row[j];
      if (d[idx] > reach) break;
      const uint32_t dd = dist_sqr(palette[idx], pix[i]);
      if (dd < best) {
        best = dd;
        match = idx;
      }
    }
    index[i] = (uint8_t)match;
    cache.insert(rgb, (uint8_t)match);
  }
}

// ---------------------------------------------------------------------------
// QuantOctree.c
// ---------------------------------------------------------------------------

struct ColorBucket {
  uint32_t count;
  uint64_t r, g, b, a;
};

struct ColorCube {
  unsigned bits[4], width[4], offset[4];
  std::vector<ColorBucket> buckets;

  ColorCube(unsigned r, unsigned g, unsigned b, unsigned a) {
    bits[0] = r;
    bits[1] = g;
    bits[2] = b;
    bits[3] = a;
    for (int i = 0; i < 4; i++) width[i] = 1u << bits[i];
    offset[0] = bits[1] + bits[2] + bits[3];
    offset[1] = bits[2] + bits[3];
    offset[2] = bits[3];
    offset[3] = 0;
    buckets.assign((size_t)width[0] * width[1] * width[2] * width[3], ColorBucket{});
  }
  size_t pos(unsigned r, unsigned g, unsigned b, unsigned a) const {
    return r << offset[0] | g << offset[1] | b << offset[2] | a << offset[3];
  }
  ColorBucket& at(const Pixel& p) {
    return buckets[pos(p.c.r >> (8 - bits[0]), p.c.g >> (8 - bits[1]), p.c.b >> (8 - bits[2]),
                       p.c.a >> (8 - bits[3]))];
  }
  size_t used() const {
    size_t n = 0;
    for (const ColorBucket& b : buckets) n += b.count > 0;
    return n;
  }
};

inline uint8_t clip8(int v) { return (uint8_t)(v <= 0 ? 0 : v < 256 ? v : 255); }

Pixel bucket_colour(const ColorBucket& b) {
  Pixel p;
  float count = (float)b.count;
  if (count != 0) {
    p.c.r = clip8((int)((float)b.r / count));
    p.c.g = clip8((int)((float)b.g / count));
    p.c.b = clip8((int)((float)b.b / count));
    p.c.a = clip8((int)((float)b.a / count));
  } else {
    p.u = 0;
  }
  return p;
}

void add_bucket(const ColorBucket& src, ColorBucket& dst) {
  dst.count += src.count;
  dst.r += src.r;
  dst.g += src.g;
  dst.b += src.b;
  dst.a += src.a;
}

ColorCube copy_cube(const ColorCube& cube, const unsigned* bits) {
  ColorCube out(bits[0], bits[1], bits[2], bits[3]);
  unsigned src_reduce[4] = {0, 0, 0, 0}, dst_reduce[4] = {0, 0, 0, 0}, width[4];
  for (int i = 0; i < 4; i++) {
    if (cube.bits[i] > out.bits[i]) {
      dst_reduce[i] = cube.bits[i] - out.bits[i];
      width[i] = cube.width[i];
    } else {
      src_reduce[i] = out.bits[i] - cube.bits[i];
      width[i] = out.width[i];
    }
  }
  for (unsigned r = 0; r < width[0]; r++) {
    for (unsigned g = 0; g < width[1]; g++) {
      for (unsigned b = 0; b < width[2]; b++) {
        for (unsigned a = 0; a < width[3]; a++) {
          size_t s = cube.pos(r >> src_reduce[0], g >> src_reduce[1], b >> src_reduce[2],
                              a >> src_reduce[3]);
          size_t d = out.pos(r >> dst_reduce[0], g >> dst_reduce[1], b >> dst_reduce[2],
                             a >> dst_reduce[3]);
          add_bucket(cube.buckets[s], out.buckets[d]);
        }
      }
    }
  }
  return out;
}

std::vector<ColorBucket> sorted_by_count(const ColorCube& cube) {
  std::vector<ColorBucket> out = cube.buckets;
  std::stable_sort(out.begin(), out.end(),
                   [](const ColorBucket& x, const ColorBucket& y) { return x.count > y.count; });
  return out;
}

void subtract_buckets(ColorCube& cube, const ColorBucket* buckets, long n) {
  for (long i = 0; i < n; i++) {
    const ColorBucket& s = buckets[i];
    if (s.count == 0) continue;
    ColorBucket& m = cube.at(bucket_colour(s));
    m.count -= s.count;
    m.r -= s.r;
    m.g -= s.g;
    m.b -= s.b;
    m.a -= s.a;
  }
}

void add_lookup_buckets(ColorCube& cube, const std::vector<ColorBucket>& palette, long n,
                        long offset) {
  for (long i = offset + n - 1; i >= offset; i--) cube.at(bucket_colour(palette[i])).count = (uint32_t)i;
}

const unsigned CUBE_LEVELS_ALPHA[8] = {3, 4, 3, 3, 2, 2, 2, 2};  // fine R G B A, coarse R G B A

void quantize_octree(const std::vector<Pixel>& pix, std::vector<Pixel>& palette, uint8_t* index) {
  const uint32_t colors = COLORS;
  const unsigned* bits = CUBE_LEVELS_ALPHA;
  ColorCube fine(bits[0], bits[1], bits[2], bits[3]);
  for (const Pixel& p : pix) {
    ColorBucket& b = fine.at(p);
    b.count += 1;
    b.r += p.c.r;
    b.g += p.c.g;
    b.b += p.c.b;
    b.a += p.c.a;
  }
  ColorCube coarse = copy_cube(fine, bits + 4);
  unsigned long n_coarse = coarse.used();
  if (n_coarse > colors) n_coarse = colors;
  unsigned long n_fine = colors - n_coarse;
  std::vector<ColorBucket> fine_sorted = sorted_by_count(fine);
  subtract_buckets(coarse, fine_sorted.data(), (long)n_fine);
  while (n_coarse > coarse.used()) {
    unsigned long done = n_fine;
    n_coarse = coarse.used();
    n_fine = colors - n_coarse;
    subtract_buckets(coarse, fine_sorted.data() + done, (long)(n_fine - done));
  }
  std::vector<ColorBucket> coarse_sorted = sorted_by_count(coarse);
  std::vector<ColorBucket> buckets(coarse_sorted.begin(), coarse_sorted.begin() + n_coarse);
  buckets.insert(buckets.end(), fine_sorted.begin(), fine_sorted.begin() + n_fine);

  ColorCube coarse_lookup(bits[4], bits[5], bits[6], bits[7]);
  add_lookup_buckets(coarse_lookup, buckets, (long)n_coarse, 0);
  ColorCube lookup = copy_cube(coarse_lookup, bits);
  add_lookup_buckets(lookup, buckets, (long)n_fine, (long)n_coarse);
  for (size_t i = 0; i < pix.size(); i++) index[i] = (uint8_t)lookup.at(pix[i]).count;
  palette.resize(colors);
  for (uint32_t i = 0; i < colors; i++) palette[i] = bucket_colour(buckets[i]);
}

// ---------------------------------------------------------------------------
// GifEncode.c: LZW
// ---------------------------------------------------------------------------

const int CODE_LIMIT = 4096;
const int TABLE_SIZE = 8192;

class LzwWriter {
 public:
  std::vector<uint8_t> out;

  explicit LzwWriter(int bits) : clear_(1 << bits), end_(clear_ + 1), bits_(bits) {
    codes_.assign(TABLE_SIZE, 0);
    reset();
  }

  void put(uint32_t code) {
    acc_ |= (uint64_t)code << nacc_;
    nacc_ += width_;
    while (nacc_ >= 8) {
      out.push_back((uint8_t)acc_);
      acc_ >>= 8;
      nacc_ -= 8;
    }
  }

  void encode(const uint8_t* px, size_t n) {  // n > 0
    put(clear_);
    uint32_t head = px[0];
    for (size_t k = 1; k < n; k++) {
      const uint32_t tail = px[k];
      int probe = (int)(((head ^ (tail << 6)) * 31) & (TABLE_SIZE - 1));
      bool found = false;
      while (codes_[probe]) {
        if ((codes_[probe] & 0xFFFFF) == ((head << 8) | tail)) {
          head = codes_[probe] >> 20;
          found = true;
          break;
        }
        probe -= (int)((tail << 2) | 1);
        if (probe < 0) probe += TABLE_SIZE;
      }
      if (found) continue;
      put(head);
      if (next_ < CODE_LIMIT) {
        codes_[probe] = (next_ << 20) | (head << 8) | tail;
        if (next_ > max_code_) {
          max_code_ = max_code_ * 2 + 1;
          width_++;
        }
        next_++;
      } else {
        put(clear_);
        reset();
      }
      head = tail;
    }
    put(head);
    put(end_);
    if (nacc_) out.push_back((uint8_t)acc_);
  }

 private:
  uint32_t clear_, end_;
  int bits_;
  uint32_t next_ = 0, max_code_ = 0;
  int width_ = 0;
  std::vector<uint32_t> codes_;
  uint64_t acc_ = 0;
  int nacc_ = 0;

  void reset() {
    next_ = end_ + 1;
    max_code_ = 2 * clear_ - 1;
    width_ = bits_ + 1;
    std::fill(codes_.begin(), codes_.end(), 0u);
  }
};

// ImagingGifEncode's framing: each call fills a buffer of ``bufsize``
// bytes (ImageFile._save's max(MAXBLOCK, 4 x width)) with sub-blocks of up
// to 255 bytes; a sub-block needs 2 bytes of the buffer and is cut short
// at its end.
std::vector<uint8_t> sub_blocks(const std::vector<uint8_t>& data, size_t bufsize) {
  std::vector<uint8_t> out;
  out.reserve(data.size() + data.size() / 255 + 2);
  size_t at = 0, pos = 0;
  while (at < data.size()) {
    if (bufsize - pos < 2) pos = 0;
    const size_t room = std::min<size_t>(256, bufsize - pos) - 1;
    const size_t k = std::min(room, data.size() - at);
    out.push_back((uint8_t)k);
    out.insert(out.end(), data.begin() + at, data.begin() + at + k);
    at += k;
    pos += 1 + k;
  }
  return out;
}

std::vector<Pixel> load_pixels(const uint8_t* src, uint32_t npix, int channels) {
  std::vector<Pixel> pix(npix);
  for (uint32_t i = 0; i < npix; i++) {
    pix[i].c.r = src[(size_t)i * channels];
    pix[i].c.g = src[(size_t)i * channels + 1];
    pix[i].c.b = src[(size_t)i * channels + 2];
    pix[i].c.a = channels == 4 ? src[(size_t)i * channels + 3] : 255;
  }
  return pix;
}

}  // namespace

extern "C" {

int sl_quant_median(const uint8_t* rgb, uint32_t npix, uint8_t* palette, int* palette_len,
                    uint8_t* index, char* err, int errlen) {
  try {
    if (npix == 0) throw Error(SL_UNSUPPORTED, "empty image");
    std::vector<Pixel> pal;
    quantize_median(load_pixels(rgb, npix, 3), pal, index);
    for (size_t i = 0; i < pal.size(); i++) memcpy(palette + 3 * i, pal[i].v, 3);
    *palette_len = (int)pal.size();
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_NO_ROOM, "out of memory"), err, errlen);
  }
}

int sl_quant_octree(const uint8_t* rgba, uint32_t npix, uint8_t* palette, int* palette_len,
                    uint8_t* index, char* err, int errlen) {
  try {
    if (npix == 0) throw Error(SL_UNSUPPORTED, "empty image");
    std::vector<Pixel> pix = load_pixels(rgba, npix, 4);
    bool seen = false;  // Quantize.c: every transparent pixel takes the first one's colour
    Pixel first{};
    for (Pixel& p : pix) {
      if (p.c.a != 0) continue;
      if (!seen) {
        seen = true;
        first = p;
      } else {
        p.c.r = first.c.r;
        p.c.g = first.c.g;
        p.c.b = first.c.b;
      }
    }
    std::vector<Pixel> pal;
    quantize_octree(pix, pal, index);
    for (size_t i = 0; i < pal.size(); i++) memcpy(palette + 4 * i, pal[i].v, 4);
    *palette_len = (int)pal.size();
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_NO_ROOM, "out of memory"), err, errlen);
  }
}

int sl_gif_lzw_encode(const uint8_t* index, int width, int height, int interlace,
                      uint8_t** out, size_t* out_size, char* err, int errlen) {
  try {
    if (width <= 0 || height <= 0) throw Error(SL_UNSUPPORTED, "empty image");
    std::vector<uint8_t> rows;
    const uint8_t* px = index;
    if (interlace) {
      rows.reserve((size_t)width * height);
      const int starts[4] = {0, 4, 2, 1}, steps[4] = {8, 8, 4, 2};
      for (int pass = 0; pass < 4; pass++) {
        for (int y = starts[pass]; y < height; y += steps[pass]) {
          rows.insert(rows.end(), index + (size_t)y * width, index + (size_t)(y + 1) * width);
        }
      }
      px = rows.data();
    }
    LzwWriter lzw(8);
    lzw.encode(px, (size_t)width * height);
    std::vector<uint8_t> data = sub_blocks(lzw.out, std::max<size_t>(65536, 4 * (size_t)width));
    uint8_t* buf = (uint8_t*)malloc(data.size());
    if (buf == nullptr) throw Error(SL_NO_ROOM, "out of memory");
    memcpy(buf, data.data(), data.size());
    *out = buf;
    *out_size = data.size();
    return SL_OK;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Error(SL_NO_ROOM, "out of memory"), err, errlen);
  }
}

void sl_gif_enc_free(uint8_t* p) { free(p); }

}  // extern "C"
