// The byte-level decoders of terrain_tpu_torch/data/tiff.py, data/bmp.py,
// data/tga.py, data/sun.py, data/hdr.py, data/dds.py, data/sgi.py,
// data/pcx.py and data/qoi.py, in host C++.
//
// The JAX package reads its rasters with imageio, through Pillow, which
// decodes a compressed TIFF with libtiff and a run-length BMP with its own
// Python loop.  The port depends on no image library; these routines give
// the same bytes:
//   * tiff_chunk: one strip or tile of a TIFF -- its stored bytes through
//     LZW (compression 5, libtiff's tif_lzw.c: 9- to 12-bit codes, most
//     significant bit first, the code width growing one code early) or
//     PackBits (32773), or as they are (1; deflate, 8 and 32946, is
//     inflated by the caller with zlib), then byte-swapped to the host's
//     order and the predictor undone (tif_predict.c: 2, horizontal
//     differences of 8-, 16- or 32-bit samples; 3, the floating-point
//     predictor: byte planes, most significant first, differenced);
//   * bmp_rle: Pillow's BmpRleDecoder (BmpImagePlugin.py) for BI_RLE8 and
//     BI_RLE4, quirks included: a delta escape reads two more bytes than
//     it names and moves by those, an odd RLE4 absolute run drops its last
//     pixel, and an absolute run's padding follows the file position;
//   * tga_rle: Pillow's TgaRleDecode.c for run-length TGA: a repeat packet
//     must end within its row (Pillow: "buffer overrun"), a literal packet
//     runs on into the rows after, and whatever follows the last row is
//     ignored;
//   * sun_rle: Pillow's SunRleDecode.c for a byte-encoded Sun raster;
//   * hdr_pixels: OpenCV's RGBE_ReadPixels_RLE (rgbe.cpp) for Radiance
//     scanlines, flat and new-style run-length;
//   * bcn_decode: Pillow's BcnDecode.c for DDS blocks, BC1-BC7 (BC6H
//     signed and unsigned), block rows at a time so data/dds.py can run
//     them on several threads.
//   * sgi_rle: Pillow's SgiRleDecode.c for run-length SGI rows (8- and
//     16-bit samples, the high byte of a 16-bit one kept), a band of
//     rows at a time so data/sgi.py can run them on several threads;
//   * pcx_rle: Pillow's PcxDecode.c for PCX scan lines, its move of
//     padded planes included;
//   * qoi_decode: Pillow's QoiDecoder (QoiImagePlugin.py), op by op.
// A 21600x10800 RGB TIFF is ~700 MB of pixels: a Python loop over it would
// take hours, these take seconds, and tiff.py runs its strips or tiles on
// several threads (ctypes lets go of the GIL during each call).
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kMalformed = 2 };

int fail(int status, char* msg, int64_t len, const char* text) {
  if (len > 0) std::snprintf(msg, static_cast<size_t>(len), "%s", text);
  return status;
}

// LZW as libtiff's LZWDecode reads it; returns the bytes written (at most
// `cap`), or -1 on a code the table does not hold.
int64_t lzw(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
  const int kClear = 256, kEoi = 257, kFirst = 258, kMax = 4096;
  std::vector<uint16_t> prefix(kMax);
  std::vector<uint8_t> suffix(kMax), first(kMax);
  std::vector<uint16_t> length(kMax);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  uint8_t tmp[kMax];
  int64_t pos = 0, p = 0;
  uint64_t acc = 0;  // bits read ahead, the oldest most significant
  int have = 0;
  int width = 9, next = kFirst, prev = -1;
  while (pos < cap) {
    while (have < width && p < n) {
      acc = (acc << 8) | src[p++];
      have += 8;
    }
    if (have < width) break;  // the data ends without an EOI code
    const uint32_t code =
        static_cast<uint32_t>(acc >> (have - width)) & ((1u << width) - 1);
    have -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      prev = -1;
      continue;
    }
    if (prev < 0) {  // the first code after a clear: a literal
      if (code > 255) return -1;
      out[pos++] = static_cast<uint8_t>(code);
      prev = static_cast<int>(code);
      continue;
    }
    if (static_cast<int>(code) > next || (static_cast<int>(code) == next &&
                                          next >= kMax))
      return -1;
    const bool kwk = static_cast<int>(code) == next;
    if (next < kMax) {  // prev's string + the first byte of code's
      prefix[next] = static_cast<uint16_t>(prev);
      first[next] = first[prev];
      suffix[next] = kwk ? first[prev] : first[code];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
      if (next == (1 << width) - 1 && width < 12) ++width;
    }
    // code's string, written from its last byte back
    const int len = length[code];
    uint8_t* dst = pos + len <= cap ? out + pos : tmp;
    int c = static_cast<int>(code);
    for (int i = len - 1; i >= 0; --i) {
      dst[i] = suffix[c];
      c = prefix[c];
    }
    if (dst == tmp) std::memcpy(out + pos, tmp, cap - pos);
    pos += len < cap - pos ? len : cap - pos;
    prev = static_cast<int>(code);
  }
  return pos;
}

int64_t packbits(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
  int64_t p = 0, pos = 0;
  while (p < n && pos < cap) {
    const int c = static_cast<int8_t>(src[p++]);
    if (c >= 0) {
      int64_t k = c + 1;
      if (k > n - p) k = n - p;
      if (k > cap - pos) k = cap - pos;
      std::memcpy(out + pos, src + p, k);
      p += c + 1;
      pos += k;
    } else if (c != -128) {
      if (p >= n) break;
      int64_t k = 1 - c;
      if (k > cap - pos) k = cap - pos;
      std::memset(out + pos, src[p++], k);
      pos += k;
    }
  }
  return pos;
}

template <typename T>
void swap_bytes(uint8_t* buf, int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    uint8_t* b = buf + i * sizeof(T);
    for (size_t j = 0; j < sizeof(T) / 2; ++j) {
      const uint8_t t = b[j];
      b[j] = b[sizeof(T) - 1 - j];
      b[sizeof(T) - 1 - j] = t;
    }
  }
}

template <typename T>
void horizontal(uint8_t* row, int64_t count, int spp) {
  T* v = reinterpret_cast<T*>(row);
  for (int64_t i = spp; i < count; ++i)
    v[i] = static_cast<T>(v[i] + v[i - spp]);
}

}  // namespace

// One strip or tile: `src` (n bytes, as stored, bits reversed already for
// FillOrder 2) -> `out`, rows x row_bytes bytes, the host's byte order,
// the predictor undone.  comp: 1 (none, or inflated by the caller), 5
// (LZW), 32773 (PackBits).  sample_bytes: 0 for samples of fewer than 8
// bits, else 1, 2, 4 or 8; swap: the file's order is not the host's.
// Returns 0, kUnsupported or kMalformed with a message in msg.
extern "C" int tiff_chunk(const uint8_t* src, int64_t n, int comp,
                          uint8_t* out, int64_t rows, int64_t row_bytes,
                          int predictor, int sample_bytes, int spp, int swap,
                          char* msg, int64_t msg_len) {
  const int64_t cap = rows * row_bytes;
  int64_t got;
  if (comp == 5) {
    if (n >= 2 && src[0] == 0 && (src[1] & 1))
      return fail(kUnsupported, msg, msg_len,
                  "old-style (pre-6.0, LSB-first) LZW");
    got = lzw(src, n, out, cap);
    if (got < 0)
      return fail(kMalformed, msg, msg_len, "an LZW code the table lacks");
  } else if (comp == 32773) {
    got = packbits(src, n, out, cap);
  } else if (comp == 1) {
    got = n < cap ? n : cap;
    std::memcpy(out, src, got);
  } else {
    return fail(kUnsupported, msg, msg_len, "compression");
  }
  if (got < cap) {
    char text[160];
    std::snprintf(text, sizeof(text),
                  "a strip or tile holds %lld of its %lld bytes",
                  static_cast<long long>(got), static_cast<long long>(cap));
    return fail(kMalformed, msg, msg_len, text);
  }
  const int64_t count = sample_bytes ? row_bytes / sample_bytes : 0;
  if (predictor == 3) {  // byte planes, most significant first, differenced
    if (sample_bytes < 2)
      return fail(kMalformed, msg, msg_len,
                  "predictor 3 on samples of one byte");
    std::vector<uint8_t> tmp(row_bytes);
    const int64_t wc = count;
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = out + r * row_bytes;
      for (int64_t i = spp; i < row_bytes; ++i)
        row[i] = static_cast<uint8_t>(row[i] + row[i - spp]);
      std::memcpy(tmp.data(), row, row_bytes);
      for (int64_t c = 0; c < wc; ++c)
        for (int b = 0; b < sample_bytes; ++b)  // host: little-endian
          row[sample_bytes * c + b] = tmp[(sample_bytes - 1 - b) * wc + c];
    }
    return kOk;
  }
  if (swap && sample_bytes > 1) {
    if (sample_bytes == 2) swap_bytes<uint16_t>(out, cap / 2);
    if (sample_bytes == 4) swap_bytes<uint32_t>(out, cap / 4);
    if (sample_bytes == 8) swap_bytes<uint64_t>(out, cap / 8);
  }
  if (predictor == 2) {
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = out + r * row_bytes;
      if (sample_bytes == 1) horizontal<uint8_t>(row, count, spp);
      else if (sample_bytes == 2) horizontal<uint16_t>(row, count, spp);
      else if (sample_bytes == 4) horizontal<uint32_t>(row, count, spp);
      else
        return fail(kUnsupported, msg, msg_len,
                    "predictor 2 on samples of fewer than 8 or of 64 bits");
    }
  }
  return kOk;
}

// Pillow's BmpRleDecoder: `src` (n bytes from the file's offset, whose
// parity is base_parity) -> out, width x height indices in the order
// Pillow's raw data holds them (the file's rows, bottom-up or not), zeros
// where the runs leave pixels unwritten.  Returns 0, or kMalformed for a
// delta escape cut short (Pillow raises there too).
extern "C" int bmp_rle(const uint8_t* src, int64_t n, int rle4,
                       int base_parity, int64_t width, int64_t height,
                       uint8_t* out, char* msg, int64_t msg_len) {
  const int64_t dest = width * height;
  std::memset(out, 0, dest);
  int64_t len = 0, x = 0, p = 0;  // len: Pillow's len(data)
  auto put = [&](uint8_t v) {
    if (len < dest) out[len] = v;
    ++len;
  };
  while (len < dest) {
    if (p + 2 > n) break;
    int64_t num = src[p];
    const uint8_t byte = src[p + 1];
    p += 2;
    if (num) {
      if (x + num > width) num = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < num; ++i)
        put(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 15) : byte);
      x += num;
    } else if (byte == 0) {
      while (len % width != 0) put(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (p + 2 > n) break;
      p += 2;  // Pillow reads the delta's two bytes, then two more
      if (p + 2 > n)
        return fail(kMalformed, msg, msg_len, "a BMP delta escape cut short");
      const int64_t right = src[p], up = src[p + 1];
      p += 2;
      const int64_t k = right + up * width;
      for (int64_t i = 0; i < k && len < dest; ++i) put(0);
      x = len % width;
    } else {
      const int64_t want = rle4 ? byte / 2 : byte;
      const int64_t have = want < n - p ? want : n - p;
      for (int64_t i = 0; i < have; ++i) {
        const uint8_t v = src[p + i];
        if (rle4) {
          put(v >> 4);
          put(v & 15);
        } else {
          put(v);
        }
      }
      p += have;
      if (have < want) break;
      x += byte;
      if ((p + base_parity) % 2 != 0) ++p;
    }
  }
  return kOk;
}

// Run-length TGA packets -> the rows as stored (height rows of width
// pixels of bpp bytes).  Returns kMalformed where the packets end before
// the last row or a repeat packet crosses a row's end.
extern "C" int tga_rle(const uint8_t* src, int64_t n, int bpp, int64_t width,
                       int64_t height, uint8_t* out, char* msg,
                       int64_t msg_len) {
  const int64_t row = width * bpp, total = row * height;
  int64_t len = 0, p = 0;
  while (len < total) {
    if (p >= n)
      return fail(kMalformed, msg, msg_len, "TGA: the run-length data is cut short");
    const int64_t count = (src[p] & 0x7f) + 1;
    if (src[p] & 0x80) {
      if (p + 1 + bpp > n)
        return fail(kMalformed, msg, msg_len, "TGA: a repeat packet is cut short");
      if (len % row + count * bpp > row)
        return fail(kMalformed, msg, msg_len,
                    "TGA: a repeat packet crosses the end of a row");
      for (int64_t i = 0; i < count; ++i, len += bpp)
        std::memcpy(out + len, src + p + 1, bpp);
      p += 1 + bpp;
    } else {
      const int64_t bytes = count * bpp;
      if (p + 1 + bytes > n)
        return fail(kMalformed, msg, msg_len, "TGA: a literal packet is cut short");
      const int64_t take = bytes < total - len ? bytes : total - len;
      std::memcpy(out + len, src + p + 1, take);
      len += take;
      p += 1 + bytes;
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ Sun

// Pillow's SunRleDecode.c for a byte-encoded Sun raster: 0x80 n v gives
// n + 1 bytes v, 0x80 0 one byte 0x80, any other byte itself; runs carry
// on across rows (which hold no padding), and what follows the last byte
// is ignored.  `out` gets `total` bytes; kMalformed where the data ends
// first.
extern "C" int sun_rle(const uint8_t* src, int64_t n, uint8_t* out,
                       int64_t total, char* msg, int64_t msg_len) {
  int64_t p = 0, x = 0;
  while (x < total) {
    if (p >= n)
      return fail(kMalformed, msg, msg_len,
                  "the byte-encoded data is cut short");
    if (src[p] != 0x80) {
      out[x++] = src[p++];
      continue;
    }
    if (p + 2 > n)
      return fail(kMalformed, msg, msg_len, "a run is cut short");
    int64_t k = src[p + 1];
    if (k == 0) {
      out[x++] = 0x80;
      p += 2;
      continue;
    }
    if (p + 3 > n)
      return fail(kMalformed, msg, msg_len, "a run is cut short");
    k += 1;
    if (k > total - x) k = total - x;
    std::memset(out + x, src[p + 2], k);
    x += k;
    p += 3;
  }
  return kOk;
}

// ------------------------------------------------------------ Radiance

// OpenCV's RGBE_ReadPixels_RLE (rgbe.cpp): the pixels after the header as
// RGBE bytes, width x height x 4.  A scanline of width 8 to 32767 that
// starts 2 2 w (new-style) holds four run-length channels; the first
// scanline that does not (and any image of another width) makes the rest
// of the image flat RGBE, old-style runs included.  kMalformed where the
// data ends early or a run leaves its scanline.
extern "C" int hdr_pixels(const uint8_t* src, int64_t n, int64_t width,
                          int64_t height, uint8_t* out, char* msg,
                          int64_t msg_len) {
  int64_t p = 0;
  const int64_t total = width * height * 4;
  auto flat = [&](int64_t at) {
    if (n - p < total - at)
      return fail(kMalformed, msg, msg_len, "HDR: the pixels are cut short");
    std::memcpy(out + at, src + p, total - at);
    return static_cast<int>(kOk);
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line(4 * width);
  for (int64_t y = 0; y < height; ++y) {
    if (n - p < 4)
      return fail(kMalformed, msg, msg_len, "HDR: the pixels are cut short");
    const uint8_t* q = src + p;
    if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) return flat(y * width * 4);
    if (((q[2] << 8) | q[3]) != width)
      return fail(kMalformed, msg, msg_len, "HDR: wrong scanline width");
    p += 4;
    for (int c = 0; c < 4; ++c) {
      int64_t x = c * width;
      const int64_t end = x + width;
      while (x < end) {
        if (n - p < 2)
          return fail(kMalformed, msg, msg_len,
                      "HDR: the pixels are cut short");
        int64_t count = src[p];
        const uint8_t v = src[p + 1];
        p += 2;
        if (count > 128) {
          count -= 128;
          if (count > end - x)
            return fail(kMalformed, msg, msg_len, "HDR: bad scanline data");
          std::memset(line.data() + x, v, count);
          x += count;
        } else {
          if (count == 0 || count > end - x)
            return fail(kMalformed, msg, msg_len, "HDR: bad scanline data");
          line[x++] = v;
          if (--count > 0) {
            if (n - p < count)
              return fail(kMalformed, msg, msg_len,
                          "HDR: the pixels are cut short");
            std::memcpy(line.data() + x, src + p, count);
            p += count;
            x += count;
          }
        }
      }
    }
    uint8_t* row = out + y * width * 4;
    for (int64_t x = 0; x < width; ++x)
      for (int c = 0; c < 4; ++c) row[4 * x + c] = line[c * width + x];
  }
  return kOk;
}

// ----------------------------------------------------------------- BCn
//
// Pillow's BcnDecode.c, block for block: BC1-BC3 (DXT1/3/5; BC2 and BC3
// colour blocks always four-colour), BC4, BC5 (blue 0; BC5S: each signed
// endpoint plus 128, blue 128), BC6H (UF16 and SF16, each texel's half float taken
// to 8 bits: (uint8)(f * 255) clamped, NaN 0) and BC7 (a block whose
// first byte is 0: black, alpha 255).

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

int get_bit(const uint8_t* s, int bit) { return (s[bit >> 3] >> (bit & 7)) & 1; }

int get_bits(const uint8_t* s, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  int x = s[by];
  if (bit + count > 8) x |= s[by + 1] << 8;
  return (x >> bit) & ((1 << count) - 1);
}

Rgba decode_565(uint16_t x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  r |= r >> 5;
  g |= g >> 6;
  b |= b >> 5;
  return {static_cast<uint8_t>(r), static_cast<uint8_t>(g),
          static_cast<uint8_t>(b), 0xff};
}

void bc1_color(Rgba* dst, const uint8_t* s, bool four) {
  const uint16_t c0 = s[0] | (s[1] << 8), c1 = s[2] | (s[3] << 8);
  const uint32_t lut = s[4] | (s[5] << 8) | (s[6] << 16) |
                       (static_cast<uint32_t>(s[7]) << 24);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3),
            static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 0xff};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3),
            static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2),
            static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) dst[i] = p[3 & (lut >> (2 * i))];
}

// BC3's alpha block (BC4 and BC5 channels): 8 or 6 interpolated values
void bc3_alpha(uint8_t* dst, int stride, const uint8_t* s, bool sign) {
  const int a0 = sign ? static_cast<int8_t>(s[0]) + 128 : s[0];
  const int a1 = sign ? static_cast<int8_t>(s[1]) + 128 : s[1];
  uint8_t a[8] = {static_cast<uint8_t>(a0), static_cast<uint8_t>(a1)};
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k)
      a[k + 1] = static_cast<uint8_t>(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; ++k)
      a[k + 1] = static_cast<uint8_t>(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  const uint32_t lut1 = s[2] | (s[3] << 8) | (s[4] << 16);
  const uint32_t lut2 = s[5] | (s[6] << 8) | (s[7] << 16);
  for (int i = 0; i < 8; ++i) {
    dst[stride * i] = a[7 & (lut1 >> (3 * i))];
    dst[stride * (8 + i)] = a[7 & (lut2 >> (3 * i))];
  }
}

// BC7 and BC6H partitions (two subsets: a bit per texel; three: two bits)
const uint16_t kSubsets2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800,
    0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e,
    0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110, 0x6666,
    0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc,
    0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996,
    0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c,
    0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744,
    0xee22};
const uint32_t kSubsets3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// anchor texels: the second subset of two; the second and third of three
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                               34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int ns, int partition, int i) {
  if (ns == 2) return 1 & (kSubsets2[partition] >> i);
  if (ns == 3) return 3 & (kSubsets3[partition] >> (2 * i));
  return 0;
}

// BC7 modes: subsets, partition bits, rotation bits, index selection
// bits, colour bits, alpha bits, endpoint p-bits, shared p-bits, index
// bits, secondary index bits
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0},
                         {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                         {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
                         {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                         {1, 0, 2, 1, 5, 6, 0, 0, 2, 3},
                         {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                         {1, 0, 0, 0, 7, 7, 1, 0, 4, 0},
                         {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

uint8_t expand(int v, int bits) {
  const uint8_t w = static_cast<uint8_t>(v << (8 - bits));
  return static_cast<uint8_t>(w | (w >> bits));
}

void bc7_block(Rgba* col, const uint8_t* s) {
  if (s[0] == 0) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int m = 0;
  while (!((s[0] >> m) & 1)) ++m;
  const Bc7Mode& md = kBc7[m];
  int bit = m + 1;
  const int partition = get_bits(s, bit, md.pb);
  bit += md.pb;
  const int rotation = get_bits(s, bit, md.rb);
  bit += md.rb;
  const int index_sel = get_bits(s, bit, md.isb);
  bit += md.isb;
  const int ne = md.ns * 2;
  int cb = md.cb, ab = md.ab;
  uint8_t ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < ne; ++i, bit += cb) ep[i][c] = get_bits(s, bit, cb);
  for (int i = 0; i < ne; ++i) {
    ep[i][3] = ab ? get_bits(s, bit, ab) : 255;
    bit += ab;
  }
  const int nc = ab ? 4 : 3;
  if (md.epb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < ne; ++i) {
      const int p = get_bit(s, bit++);
      for (int c = 0; c < nc; ++c)
        ep[i][c] = static_cast<uint8_t>((ep[i][c] << 1) | p);
    }
  }
  if (md.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < ne; i += 2) {
      const int p = get_bit(s, bit++);
      for (int j = 0; j < 2; ++j)
        for (int c = 0; c < nc; ++c)
          ep[i + j][c] = static_cast<uint8_t>((ep[i + j][c] << 1) | p);
    }
  }
  for (int i = 0; i < ne; ++i) {
    for (int c = 0; c < 3; ++c) ep[i][c] = expand(ep[i][c], cb);
    if (ab) ep[i][3] = expand(ep[i][3], ab);
  }
  const uint8_t* cw = weights(md.ib);
  const uint8_t* aw = weights(ab && md.ib2 ? md.ib2 : md.ib);
  int cbit = bit, abit = bit + 16 * md.ib - md.ns;
  for (int i = 0; i < 16; ++i) {
    const int sub = subset_of(md.ns, partition, i) * 2;
    int ib = md.ib;
    if (i == 0 || (md.ns == 2 && i == kAnchor2[partition]) ||
        (md.ns == 3 && (i == kAnchor3a[partition] ||
                        i == kAnchor3b[partition])))
      --ib;
    const int i0 = get_bits(s, cbit, ib);
    cbit += ib;
    int s0 = cw[i0], s1 = cw[i0];
    if (ab && md.ib2) {
      const int ib2 = md.ib2 - (i == 0);
      const int i1 = get_bits(s, abit, ib2);
      abit += ib2;
      s0 = index_sel ? aw[i1] : cw[i0];
      s1 = index_sel ? cw[i0] : aw[i1];
    }
    const uint8_t* e0 = ep[sub];
    const uint8_t* e1 = ep[sub + 1];
    uint8_t px[4];
    for (int c = 0; c < 4; ++c) {
      const int w = c < 3 ? s0 : s1;
      px[c] = static_cast<uint8_t>(((64 - w) * e0[c] + w * e1[c] + 32) >> 6);
    }
    if (rotation) std::swap(px[rotation - 1], px[3]);
    col[i] = {px[0], px[1], px[2], px[3]};
  }
}

// BC6H modes: subsets, transformed, partition bits, endpoint bits, delta
// bits of r, g, b; then each mode's endpoint bits in stream order, each
// (value << 4 | bit), the values rw gw bw rx gx bx ry gy by rz gz bz
struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
const uint8_t kBc6Bits[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52,
     164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
     80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
     144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20,
     21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48,
     49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160,
     161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98,
     99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112,
     113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112,
     113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82,
     83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145,
     146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112,
     113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146,
     147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112,
     113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145,
     146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133,
     178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51,
     52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163,
     80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101,
     144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85,
     86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85,
     86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85,
     86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12,
     11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46,
     45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

uint16_t sign_extend(uint16_t v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  return static_cast<uint16_t>(x);
}

int unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15 || x == 0) return x;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = static_cast<int16_t>(v);
  if (prec >= 16) return x;
  const bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0)
    x = x >= (1 << (prec - 1)) - 1 ? 0x7fff
                                    : ((x << 15) + 0x4000) >> (prec - 1);
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {  // Pillow's, after F. Giesen
  uint32_t o = static_cast<uint32_t>(h & 0x7fff) << 13, m = 0x77800000;
  float f, mf;
  std::memcpy(&f, &o, 4);
  std::memcpy(&mf, &m, 4);
  f *= mf;
  m = 0x47800000;
  std::memcpy(&mf, &m, 4);
  std::memcpy(&o, &f, 4);
  if (f >= mf) o |= 255u << 23;
  o |= static_cast<uint32_t>(h & 0x8000) << 16;
  std::memcpy(&f, &o, 4);
  return f;
}

uint8_t bc6_byte(int v, bool sign) {
  float f;
  if (sign)
    f = v < 0 ? half_to_float(static_cast<uint16_t>(0x8000 | ((-v) * 31 / 32)))
              : half_to_float(static_cast<uint16_t>(v * 31 / 32));
  else
    f = half_to_float(static_cast<uint16_t>(v * 31 / 64));
  if (f != f || f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
  int mode = s[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {  // a reserved mode: black, alpha 0
    std::memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode& md = kBc6[mode];
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    const int d = kBc6Bits[mode][i];
    ep[d >> 4] |= static_cast<uint16_t>(get_bit(s, bit + i) << (d & 15));
  }
  bit += epbits;
  const int partition = get_bits(s, bit, md.pb);
  bit += md.pb;
  const int ne = md.ns == 2 ? 12 : 6;
  if (sign)
    for (int i = 0; i < 3; ++i) ep[i] = sign_extend(ep[i], md.epb);
  if (sign || md.tr)
    for (int i = 3; i < ne; i += 3) {
      ep[i] = sign_extend(ep[i], md.rb);
      ep[i + 1] = sign_extend(ep[i + 1], md.gb);
      ep[i + 2] = sign_extend(ep[i + 2], md.bb);
    }
  if (md.tr)  // deltas from the first endpoint, masked (not re-extended)
    for (int i = 3; i < ne; ++i)
      ep[i] = static_cast<uint16_t>((ep[i] + ep[i % 3]) &
                                    ((1 << md.epb) - 1));
  int u[12];
  for (int i = 0; i < ne; ++i) u[i] = unquantize(ep[i], md.epb, sign);
  const uint8_t* cw = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int sub = subset_of(md.ns, partition, i) * 6;
    int b = ib;
    if (i == 0 || (md.ns == 2 && i == kAnchor2[partition])) --b;
    const int t = cw[get_bits(s, bit, b)];
    bit += b;
    uint8_t px[3];
    for (int c = 0; c < 3; ++c)
      px[c] = bc6_byte((u[sub + c] * (64 - t) + u[sub + 3 + c] * t) >> 6,
                       sign);
    col[i] = {px[0], px[1], px[2], 0};
  }
}

}  // namespace

// Block rows row0..row1 (4 texels high each) of a BCn surface `width` x
// `height` whose blocks start at `src` (n bytes: all of them) -> out,
// height x width x channels bytes (4 for BC1-3 and BC7, 1 for BC4, 3 for
// BC5, BC5S and BC6H).  fmt: 1-7 (BCn), 51 (BC5S), 61 (BC6H SF16).
extern "C" int bcn_decode(const uint8_t* src, int64_t n, int fmt,
                          int64_t width, int64_t height, int64_t row0,
                          int64_t row1, uint8_t* out, char* msg,
                          int64_t msg_len) {
  const int size = (fmt == 1 || fmt == 4) ? 8 : 16;
  const int ch = (fmt == 4) ? 1 : (fmt == 5 || fmt == 51 || fmt == 6 ||
                                   fmt == 61) ? 3 : 4;
  const int64_t bw = (width + 3) / 4;
  if (n < ((height + 3) / 4) * bw * size)
    return fail(kMalformed, msg, msg_len, "DDS: the blocks are cut short");
  Rgba col[16];
  uint8_t lum[16];
  for (int64_t by = row0; by < row1; ++by)
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t* s = src + (by * bw + bx) * size;
      std::memset(col, 0, sizeof(col));
      switch (fmt) {
        case 1: bc1_color(col, s, false); break;
        case 2:
          bc1_color(col, s + 8, true);
          for (int i = 0; i < 16; ++i) {
            const int av = 0xf & (s[i >> 1] >> ((i & 1) * 4));
            col[i].a = static_cast<uint8_t>((av << 4) | av);
          }
          break;
        case 3:
          bc1_color(col, s + 8, true);
          bc3_alpha(&col[0].a, 4, s, false);
          break;
        case 4: bc3_alpha(lum, 1, s, false); break;
        case 5:
        case 51:  // BC5S: blue 128, the signed zero
          bc3_alpha(&col[0].r, 4, s, fmt == 51);
          bc3_alpha(&col[0].g, 4, s + 8, fmt == 51);
          if (fmt == 51)
            for (int i = 0; i < 16; ++i) col[i].b = 128;
          break;
        case 6:
        case 61: bc6_block(col, s, fmt == 61); break;
        case 7: bc7_block(col, s); break;
        default: return fail(kUnsupported, msg, msg_len, "DDS: format");
      }
      for (int j = 0; j < 4; ++j) {
        const int64_t y = 4 * by + j;
        if (y >= height) break;
        for (int i = 0; i < 4; ++i) {
          const int64_t x = 4 * bx + i;
          if (x >= width) break;
          uint8_t* d = out + (y * width + x) * ch;
          if (ch == 1) {
            d[0] = lum[4 * j + i];
          } else {
            const Rgba& c = col[4 * j + i];
            d[0] = c.r;
            d[1] = c.g;
            d[2] = c.b;
            if (ch == 4) d[3] = c.a;
          }
        }
      }
    }
  return kOk;
}

// ------------------------------------------------------------------ SGI

// Pillow's SgiRleDecode.c, expandrow / expandrow2 for one row of one
// channel: `src` at the row's offset in the data after the 512-byte header
// (`end`: its last byte), `n` the row's length field, which counts
// packets, not bytes.  Writes every `z`-th byte of `dest` (the high byte
// of a 16-bit sample) and sets *x to the samples written.  Returns -1
// (Pillow: buffer overrun), 0, or 1 (the last packet the length allows
// is not the terminator: Pillow stops decoding the image there).
namespace {

int sgi_row(uint8_t* dest, const uint8_t* src, int64_t n, int z, int bpc,
            int64_t xsize, const uint8_t* end, int64_t* x) {
  *x = 0;
  for (; n > 0; n--) {
    uint8_t pixel;
    if (bpc == 1) {
      if (src > end) return -1;
      pixel = *src++;
    } else {
      if (src + 1 > end) return -1;
      pixel = src[1];
      src += 2;
    }
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (*x + count > xsize) return -1;
    *x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > end) return -1;
      for (; count > 0; --count, dest += z) {
        *dest = *src;
        src += bpc;
      }
    } else {
      if (src + (bpc - 1) > end) return -1;
      for (; count > 0; --count, dest += z) *dest = *src;
      src += bpc;
    }
  }
  return 0;
}

}  // namespace

// Rows row0..row1 of the tables (row 0 is the image's bottom row) of a
// run-length SGI: `data` the bufsize bytes after the header, `starts` and
// `lengths` its tables (ysize x z each, channel-major, as stored).  Writes
// image row ysize - 1 - r of `out` (ysize x xsize x z, top-down) and, for
// each row and channel, the samples written (`ends`) and sgi_row's status
// (`status`).  A row that stops short keeps, in Pillow, the samples the
// row before left in its buffer: data/sgi.py fills those in afterwards,
// row by row.
extern "C" int sgi_rle(const uint8_t* data, int64_t bufsize,
                       const int64_t* starts, const int64_t* lengths,
                       int64_t xsize, int64_t ysize, int z, int bpc,
                       int64_t row0, int64_t row1, uint8_t* out,
                       int64_t* ends, int8_t* status) {
  const uint8_t* end = data + bufsize - 1;
  for (int64_t r = row0; r < row1; ++r) {
    uint8_t* row = out + (ysize - 1 - r) * xsize * z;
    for (int c = 0; c < z; ++c) {
      const int64_t off = starts[r + c * ysize], len = lengths[r + c * ysize];
      int8_t& st = status[r * z + c];
      ends[r * z + c] = 0;
      if (off < 512) {
        st = -1;
        continue;
      }
      st = static_cast<int8_t>(sgi_row(row + c, data + off - 512, len, z,
                                       bpc, xsize, end, &ends[r * z + c]));
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ PCX

// Pillow's PcxDecode.c: `src` (n bytes after the 128-byte header) ->
// `out`, height scan lines of `bytes` bytes (planes x stride), each as
// Pillow hands it to its unpacker, whose sample size is `bits` (1, 8 or
// 24; 2 or 4 for 1-bit planes): where a plane's stride exceeds what the
// unpacker reads of it, the planes after the first are moved to follow
// one another.  A run (0xC0 | count, value) may not cross the end of a
// line.  Returns kMalformed where the data ends first ("truncated") or a
// run crosses a line ("overrun").
extern "C" int pcx_rle(const uint8_t* src, int64_t n, int64_t bytes,
                       int64_t width, int bits, int64_t height, uint8_t* out,
                       char* msg, int64_t msg_len) {
  int64_t xsize, bands, stride = 0;
  if (bits == 2 || bits == 4) {
    xsize = (width + 7) / 8;
    bands = bits;
    stride = bytes / bits;
  } else {
    xsize = width;
    bands = bytes / width;
    if (bands) stride = bytes / bands;
  }
  std::vector<uint8_t> line(bytes);
  int64_t p = 0, x = 0;
  bool overrun = false;
  for (int64_t y = 0; y < height;) {
    if (p >= n)
      return fail(kMalformed, msg, msg_len, "the image data is truncated");
    if ((src[p] & 0xC0) == 0xC0) {
      if (p + 2 > n)
        return fail(kMalformed, msg, msg_len, "the image data is truncated");
      for (int k = src[p] & 0x3F; k > 0; --k) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        line[x++] = src[p + 1];
      }
      p += 2;
    } else {
      line[x++] = src[p++];
    }
    if (x >= bytes) {
      if (stride > xsize)
        for (int64_t i = 1; i < bands; ++i)
          std::memmove(&line[i * xsize], &line[i * stride], xsize);
      std::memcpy(out + y * bytes, line.data(), bytes);
      x = 0;
      ++y;
    }
  }
  if (overrun)
    return fail(kMalformed, msg, msg_len, "a run crosses a scan line");
  return kOk;
}

// ------------------------------------------------------------------ QOI

// Pillow's QoiDecoder: the ops after the 14-byte header -> `out`, w x h
// pixels of `bands` (3 or 4) bytes.  The previous pixel starts at
// (0, 0, 0, 255); a run repeats it and enters nothing in the index; an
// index entry never set is (0, 0, 0, 0); a run may overshoot the last
// pixel (the rest is dropped) and whatever follows is ignored.  Returns
// 3 where the data ends at an op or inside QOI_OP_LUMA (Pillow:
// IndexError), kMalformed where it ends inside QOI_OP_RGB or QOI_OP_RGBA
// (ValueError).
extern "C" int qoi_decode(const uint8_t* src, int64_t n, int64_t pixels,
                          int bands, uint8_t* out, char* msg,
                          int64_t msg_len) {
  uint8_t index[64][4] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t total = pixels * bands;
  int64_t p = 0, o = 0;
  while (o < total) {
    if (p >= n) return fail(3, msg, msg_len, "the ops end early");
    const uint8_t b = src[p++];
    uint8_t v[4];
    if (b == 0xFE || b == 0xFF) {
      const int k = b == 0xFE ? 3 : 4;
      if (p + k > n)
        return fail(kMalformed, msg, msg_len, "a pixel op is cut short");
      std::memcpy(v, src + p, k);
      if (k == 3) v[3] = prev[3];
      p += k;
    } else if ((b >> 6) == 0) {
      std::memcpy(v, index[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (p >= n) return fail(3, msg, msg_len, "a luma op is cut short");
      const uint8_t b2 = src[p++];
      const int dg = (b & 63) - 32;
      v[0] = static_cast<uint8_t>(prev[0] + dg + ((b2 >> 4) - 8));
      v[1] = static_cast<uint8_t>(prev[1] + dg);
      v[2] = static_cast<uint8_t>(prev[2] + dg + ((b2 & 15) - 8));
      v[3] = prev[3];
    } else {
      for (int k = (b & 63) + 1; k > 0 && o < total; --k, o += bands)
        std::memcpy(out + o, prev, bands);
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v,
                4);
    std::memcpy(out + o, v, bands);
    o += bands;
  }
  return kOk;
}
