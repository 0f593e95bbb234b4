// Undoing the PNG row filters (PNG specification, section 9) for
// terrain_tpu_torch/serve/png.py's decoder, in host C++.
//
// Each row of a PNG starts with a filter type byte: 0 None, 1 Sub (left),
// 2 Up, 3 Average (left, up), 4 Paeth (left, up, upper left).  Average and
// Paeth read the row's own previous output, so a row is undone one byte
// after another: numpy cannot vectorize them, and a per-byte Python loop
// takes hours for a 21600x10800 RGB raster.  Here the whole image takes
// one pass at memory speed.  The filters work on bytes, so one routine
// serves 8- and 16-bit samples and every colour type (`bpp` is the bytes
// of one pixel, at least 1).
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);          // |p - a| with p = a + b - c
  const int pb = std::abs(a - c);          // |p - b|
  const int pc = std::abs(a + b - 2 * c);  // |p - c|
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

// raw: h rows of 1 + stride bytes (the filter type, then the filtered row);
// out: h rows of stride bytes.  Returns 0, or r + 1 when row r has a filter
// type other than 0-4 (out is then undefined from row r on).
extern "C" int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                                int64_t bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above, unfiltered; none for row 0
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* src = raw + r * (stride + 1);
    const uint8_t ftype = *src++;
    uint8_t* dst = out + r * stride;
    const int64_t lead = bpp < stride ? bpp : stride;  // bytes with no left
    switch (ftype) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        std::memcpy(dst, src, lead);
        for (int64_t i = lead; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + dst[i - bpp]);
        break;
      case 2:
        if (prev == nullptr) {
          std::memcpy(dst, src, stride);
        } else {
          for (int64_t i = 0; i < stride; ++i)
            dst[i] = static_cast<uint8_t>(src[i] + prev[i]);
        }
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? dst[i - bpp] : 0;
          const int up = prev != nullptr ? prev[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? dst[i - bpp] : 0;
          const int up = prev != nullptr ? prev[i] : 0;
          const int ul = prev != nullptr && i >= bpp ? prev[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(left, up, ul));
        }
        break;
      default:
        return r + 1;
    }
    prev = dst;
  }
  return 0;
}
