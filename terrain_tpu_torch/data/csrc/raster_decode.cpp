// The byte-level decoders of terrain_tpu_torch/data/tiff.py, data/bmp.py and
// data/tga.py, in host C++.
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
//     ignored.
// A 21600x10800 RGB TIFF is ~700 MB of pixels: a Python loop over it would
// take hours, these take seconds, and tiff.py runs its strips or tiles on
// several threads (ctypes lets go of the GIL during each call).
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
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
