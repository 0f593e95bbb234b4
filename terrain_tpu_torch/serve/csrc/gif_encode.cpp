// GIF's host work for terrain_tpu_torch/serve/gif.py: the adaptive palette
// of a full-colour frame (median cut), and LZW coding and decoding of the
// frames' palette indices (GIF89a specification, appendix F).
//
// gif_quantize follows the median cut that Pillow's
// `Image.convert("P", palette=ADAPTIVE)` runs (libImaging/Quant.c):
//   * colours are counted in buckets keyed by a hash of the colour shifted
//     right by `scale` bits, the least scale that leaves at most 65536
//     buckets; a bucket keeps the first colour that fell into it;
//   * boxes of buckets are taken from a heap ordered by their pixel count
//     (a 1-based binary heap; boxes of a single colour are dropped from
//     it) and split along the axis of the largest range weighted 77/150/29
//     (R/G/B), at the first value, from the top, where the running count
//     passes half the box's pixels; the values equal to it go with the top
//     half, and if the top half took everything the lowest value goes to
//     the bottom one;
//   * the palette is the leaves from left (high) to right, each the mean
//     of its pixels' own colours rounded half up;
//   * each pixel takes the entry nearest to it in squared RGB distance,
//     searched from its box's entry among entries at most twice as far
//     from that entry as the pixel, in order of that distance (ties by
//     index), replaced only by a strictly nearer one.
// Nothing of Pillow is used or needed here.
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes; the frames
// of a clip are quantized on host threads at once, one call each.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMaxBuckets = 65536;

inline uint32_t pixel_hash(uint32_t r, uint32_t g, uint32_t b) {
  return (r * 463u) ^ ((g << 8) * 10069u) ^ ((b << 16) * 64997u);
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
  const int dr = int(a[0]) - int(b[0]);
  const int dg = int(a[1]) - int(b[1]);
  const int db = int(a[2]) - int(b[2]);
  return uint32_t(dr * dr + dg * dg + db * db);
}

struct Box {
  std::vector<int32_t> items;  // bucket indices
  uint32_t count = 0;          // pixels
  int32_t left = -1, right = -1;
  uint8_t lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
};

void bounds(Box& b, const std::vector<uint8_t>& col) {
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = 255;
    b.hi[c] = 0;
  }
  for (int32_t i : b.items)
    for (int c = 0; c < 3; ++c) {
      b.lo[c] = std::min(b.lo[c], col[3 * i + c]);
      b.hi[c] = std::max(b.hi[c], col[3 * i + c]);
    }
}

int volume(const Box& b) {
  if (b.items.empty()) return 0;
  return (b.hi[0] - b.lo[0] + 1) * (b.hi[1] - b.lo[1] + 1) *
         (b.hi[2] - b.lo[2] + 1);
}

// The heap of Quant.c's median cut: 1-based, the box of most pixels on top.
struct Heap {
  std::vector<int32_t> h{-1};
  const std::vector<Box>* boxes;
  int cmp(int32_t a, int32_t b) const {
    return int((*boxes)[a].count) - int((*boxes)[b].count);
  }
  void add(int32_t v) {
    h.push_back(v);
    size_t k = h.size() - 1;
    while (k != 1) {
      if (cmp(v, h[k / 2]) <= 0) break;
      h[k] = h[k / 2];
      k /= 2;
    }
    h[k] = v;
  }
  bool remove(int32_t* out) {
    size_t n = h.size() - 1;
    if (!n) return false;
    *out = h[1];
    const int32_t v = h[n];
    h.pop_back();
    --n;
    size_t k = 1, l;
    for (; k * 2 <= n; k = l) {
      l = k * 2;
      if (l < n && cmp(h[l], h[l + 1]) < 0) ++l;
      if (cmp(v, h[l]) > 0) break;
      h[k] = h[l];
    }
    if (n) h[k] = v;
    return true;
  }
};

// Splits box `b` into two new boxes (appended); their indices in *l, *r.
void split(std::vector<Box>& boxes, int32_t b, const std::vector<uint8_t>& col,
           const std::vector<uint32_t>& cnt) {
  Box& node = boxes[b];
  const int f[3] = {(node.hi[0] - node.lo[0]) * 77,
                    (node.hi[1] - node.lo[1]) * 150,
                    (node.hi[2] - node.lo[2]) * 29};
  int axis = 0, best = f[0];
  for (int i = 1; i < 3; ++i)
    if (best < f[i]) {
      best = f[i];
      axis = i;
    }
  uint64_t hist[256] = {0};
  for (int32_t i : node.items) hist[col[3 * i + axis]] += cnt[i];
  // from the top value down, until the running count passes half
  uint64_t run = 0;
  int cut = 0;
  for (int v = 255; v >= 0; --v) {
    if (!hist[v]) continue;
    run += hist[v];
    cut = v;
    if (run * 2 > node.count) break;
  }
  if (cut == node.lo[axis]) cut = node.lo[axis] + 1;  // lowest value alone
  Box hiBox, loBox;
  for (int32_t i : node.items) {
    Box& to = col[3 * i + axis] >= cut ? hiBox : loBox;
    to.items.push_back(i);
    to.count += cnt[i];
  }
  bounds(hiBox, col);
  bounds(loBox, col);
  node.items.clear();
  node.items.shrink_to_fit();
  const int32_t l = int32_t(boxes.size());
  boxes.push_back(std::move(hiBox));
  boxes.push_back(std::move(loBox));
  boxes[b].left = l;
  boxes[b].right = l + 1;
}

void leaves(const std::vector<Box>& boxes, int32_t b, std::vector<int32_t>* out) {
  // iterative in-order walk, left (high values) first
  std::vector<int32_t> stack{b};
  while (!stack.empty()) {
    const int32_t n = stack.back();
    stack.pop_back();
    if (boxes[n].left >= 0) {
      stack.push_back(boxes[n].right);
      stack.push_back(boxes[n].left);
    } else if (!boxes[n].items.empty()) {
      out->push_back(n);
    }
  }
}

// GIF LZW bit packing, least significant bit first, in sub-blocks of at
// most 255 bytes.
struct BitWriter {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint8_t block[255];
  int nblock = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;
  void byte(uint8_t v) {
    block[nblock++] = v;
    if (nblock == 255) flush();
  }
  void flush() {
    if (!nblock) return;
    if (pos + 1 + nblock > cap) {
      overflow = true;
      nblock = 0;
      return;
    }
    out[pos++] = uint8_t(nblock);
    std::memcpy(out + pos, block, nblock);
    pos += nblock;
    nblock = 0;
  }
  void put(uint32_t code, int width) {
    acc |= code << nbits;
    nbits += width;
    while (nbits >= 8) {
      byte(uint8_t(acc & 0xFF));
      acc >>= 8;
      nbits -= 8;
    }
  }
  void finish() {
    if (nbits > 0) byte(uint8_t(acc & 0xFF));
    acc = 0;
    nbits = 0;
    flush();
    if (pos + 1 > cap) {
      overflow = true;
      return;
    }
    out[pos++] = 0;  // the block terminator
  }
};

}  // namespace

// rgb: npix pixels of 3 bytes.  Writes up to `colors` (1-256) palette
// entries to palette (3 bytes each), their number to *entries, and each
// pixel's entry to idx.  Returns 0, or 1 when memory runs out.
extern "C" int gif_quantize(const uint8_t* rgb, int64_t npix, int colors,
                            uint8_t* palette, int32_t* entries, uint8_t* idx) {
  try {
    *entries = 0;
    if (npix <= 0) return 0;
    // the least scale that leaves at most kMaxBuckets hash keys
    std::vector<uint32_t> key(npix), sorted;
    int scale = 0;
    for (;; ++scale) {
      for (int64_t i = 0; i < npix; ++i) {
        const uint8_t* p = rgb + 3 * i;
        key[i] = pixel_hash(p[0] >> scale, p[1] >> scale, p[2] >> scale);
      }
      sorted = key;
      std::sort(sorted.begin(), sorted.end());
      const size_t n = size_t(std::unique(sorted.begin(), sorted.end()) -
                              sorted.begin());
      if (n <= kMaxBuckets || scale == 8) break;
    }
    // buckets in first-seen order: a scaled colour and a pixel count each
    std::unordered_map<uint32_t, int32_t> bucket_of;
    bucket_of.reserve(kMaxBuckets * 2);
    std::vector<uint8_t> col;
    std::vector<uint32_t> cnt;
    std::vector<int32_t> pix_bucket(npix);
    for (int64_t i = 0; i < npix; ++i) {
      auto it = bucket_of.find(key[i]);
      int32_t b;
      if (it == bucket_of.end()) {
        b = int32_t(cnt.size());
        bucket_of.emplace(key[i], b);
        const uint8_t* p = rgb + 3 * i;
        col.push_back(p[0] >> scale);
        col.push_back(p[1] >> scale);
        col.push_back(p[2] >> scale);
        cnt.push_back(0);
      } else {
        b = it->second;
      }
      ++cnt[b];
      pix_bucket[i] = b;
    }
    std::vector<uint32_t>().swap(key);
    std::vector<uint32_t>().swap(sorted);
    // the median cut
    std::vector<Box> boxes(1);
    boxes.reserve(2 * size_t(colors) + 1);
    boxes[0].items.resize(cnt.size());
    for (size_t i = 0; i < cnt.size(); ++i) boxes[0].items[i] = int32_t(i);
    boxes[0].count = uint32_t(npix);
    bounds(boxes[0], col);
    Heap heap;
    heap.boxes = &boxes;
    heap.add(0);
    for (int left = colors; --left;) {
      int32_t b;
      bool found = false;
      while (heap.remove(&b)) {
        if (volume(boxes[b]) != 1) {
          found = true;
          break;
        }
      }
      if (!found) break;
      split(boxes, b, col, cnt);
      heap.add(boxes[b].left);
      heap.add(boxes[b].right);
    }
    std::vector<int32_t> leaf;
    leaves(boxes, 0, &leaf);
    const int n = int(leaf.size());
    std::vector<int32_t> entry_of(cnt.size());
    for (int e = 0; e < n; ++e)
      for (int32_t i : boxes[leaf[e]].items) entry_of[i] = e;
    // each entry the rounded mean of its pixels' own colours
    std::vector<uint64_t> sum(3 * n, 0), num(n, 0);
    for (int64_t i = 0; i < npix; ++i) {
      const int32_t e = entry_of[pix_bucket[i]];
      for (int c = 0; c < 3; ++c) sum[3 * e + c] += rgb[3 * i + c];
      ++num[e];
    }
    for (int e = 0; e < n; ++e)
      for (int c = 0; c < 3; ++c)
        palette[3 * e + c] =
            uint8_t(int(.5 + double(sum[3 * e + c]) / double(num[e])));
    // distances between entries, each row in order of (distance, index)
    std::vector<uint32_t> d(size_t(n) * n);
    std::vector<int32_t> order(size_t(n) * n);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        d[size_t(i) * n + j] = dist2(palette + 3 * i, palette + 3 * j);
    for (int i = 0; i < n; ++i) {
      int32_t* o = order.data() + size_t(i) * n;
      const uint32_t* di = d.data() + size_t(i) * n;
      for (int j = 0; j < n; ++j) o[j] = j;
      std::sort(o, o + n, [di](int32_t a, int32_t b) {
        return di[a] != di[b] ? di[a] < di[b] : a < b;
      });
    }
    // each pixel to its nearest entry, once per exact colour
    std::unordered_map<uint32_t, uint8_t> seen;
    seen.reserve(size_t(std::min<int64_t>(npix, 1 << 20)));
    for (int64_t i = 0; i < npix; ++i) {
      const uint8_t* p = rgb + 3 * i;
      const uint32_t c24 = uint32_t(p[0]) << 16 | uint32_t(p[1]) << 8 | p[2];
      auto it = seen.find(c24);
      if (it != seen.end()) {
        idx[i] = it->second;
        continue;
      }
      const int32_t e = entry_of[pix_bucket[i]];
      uint32_t best = dist2(palette + 3 * e, p), bestj = uint32_t(e);
      const uint32_t limit = best << 2;
      const int32_t* o = order.data() + size_t(e) * n;
      const uint32_t* de = d.data() + size_t(e) * n;
      for (int k = 0; k < n; ++k) {
        const int32_t j = o[k];
        if (de[j] > limit) break;
        const uint32_t dj = dist2(palette + 3 * j, p);
        if (dj < best) {
          best = dj;
          bestj = uint32_t(j);
        }
      }
      idx[i] = uint8_t(bestj);
      seen.emplace(c24, uint8_t(bestj));
    }
    *entries = n;
    return 0;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

// idx: n palette indices, each below 2^min_code (min_code 2-8).  Writes
// the LZW code stream in sub-blocks and the block terminator to out
// (at most cap bytes).  Returns the bytes written, or -1 if cap is short.
extern "C" int64_t gif_lzw_encode(const uint8_t* idx, int64_t n, int min_code,
                                  uint8_t* out, int64_t cap) {
  const uint32_t clear = 1u << min_code, eoi = clear + 1;
  // the dictionary: (prefix code << 8 | byte) -> code, open addressing;
  // a stamp per slot empties it at each clear without a memset
  constexpr uint32_t kSlots = 1 << 14;
  std::vector<uint32_t> keys(kSlots), stamp(kSlots, 0);
  std::vector<uint16_t> codes(kSlots);
  uint32_t gen = 1;
  BitWriter w{out, cap};
  int width = min_code + 1;
  uint32_t next = eoi + 1;
  w.put(clear, width);
  if (n > 0) {
    uint32_t prefix = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const uint32_t k = prefix << 8 | idx[i];
      uint32_t s = (k * 2654435761u) >> 18;
      bool hit = false;
      while (stamp[s] == gen) {
        if (keys[s] == k) {
          hit = true;
          break;
        }
        s = (s + 1) & (kSlots - 1);
      }
      if (hit) {
        prefix = codes[s];
        continue;
      }
      w.put(prefix, width);
      stamp[s] = gen;
      keys[s] = k;
      codes[s] = uint16_t(next);
      ++next;
      if (next > (1u << width) && width < 12) ++width;
      if (next == 4096) {  // the table is full: start again
        w.put(clear, width);
        ++gen;
        width = min_code + 1;
        next = eoi + 1;
      }
      prefix = idx[i];
    }
    w.put(prefix, width);
  }
  w.put(eoi, width);
  w.finish();
  return w.overflow ? -1 : w.pos;
}

// data: the code stream of one image (its sub-blocks' payloads joined).
// Decodes up to npix indices into out.  Returns the number decoded, or -1
// for a code that is not in the table.
extern "C" int64_t gif_lzw_decode(const uint8_t* data, int64_t n, int min_code,
                                  uint8_t* out, int64_t npix) {
  if (min_code < 1 || min_code > 11) return -1;
  const uint32_t clear = 1u << min_code, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> len(4096);
  for (uint32_t i = 0; i < clear; ++i) {
    suffix[i] = first[i] = uint8_t(i);
    len[i] = 1;
  }
  std::vector<uint8_t> buf(4097);
  int width = min_code + 1;
  uint32_t next = eoi + 1;
  int32_t prev = -1;
  uint32_t acc = 0;
  int nbits = 0;
  int64_t pos = 0, at = 0;
  while (at < npix) {
    while (nbits < width && pos < n) {
      acc |= uint32_t(data[pos++]) << nbits;
      nbits += 8;
    }
    if (nbits < width) break;  // the data ends without an end code
    const uint32_t code = acc & ((1u << width) - 1);
    acc >>= width;
    nbits -= width;
    if (code == clear) {
      width = min_code + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    uint32_t cur;
    uint8_t head;
    if (prev < 0) {
      if (code >= clear) return -1;
      cur = code;
    } else if (code < next) {
      cur = code;
    } else if (code == next && next < 4096) {
      cur = uint32_t(prev);  // the KwKwK case: prev's string + its head
    } else {
      return -1;
    }
    // the string of `cur`, back to front
    int l = len[cur];
    uint32_t c = cur;
    for (int j = l - 1; j >= 0; --j) {
      buf[j] = suffix[c];
      c = prefix[c];
    }
    head = first[cur];
    if (prev >= 0 && code == next) buf[l++] = head;
    if (prev >= 0 && next < 4096) {
      prefix[next] = uint16_t(prev);
      suffix[next] = code == next ? head : first[code];
      first[next] = first[prev];
      len[next] = uint16_t(len[prev] + 1);
      ++next;
      if (next == (1u << width) && width < 12) ++width;
    }
    const int64_t take = std::min<int64_t>(l, npix - at);
    std::memcpy(out + at, buf.data(), size_t(take));
    at += take;
    prev = int32_t(code);
  }
  return at;
}
