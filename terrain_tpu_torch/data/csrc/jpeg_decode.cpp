// A baseline JPEG decoder for terrain_tpu_torch/data/jpeg.py, in host C++.
//
// It gives the bytes that libjpeg-turbo gives with its default settings
// (the library behind Pillow and imageio, which the JAX package reads its
// rasters with): the same integer routines, written after libjpeg-turbo's
// C code --
//   * jpeg_idct_islow (jidctint.c): the accurate integer IDCT, 13-bit
//     constants, two passes, and its range-limit table (jdmaster.c);
//   * fancy upsampling (jdsample.c): h2v1, h1v2 and h2v2 "triangle"
//     filters with their alternating rounding biases; plain replication
//     where the subsampled width is 2 or less, as libjpeg-turbo does;
//     the row above the first and below the last real row of a component
//     repeat that row (jdmainct.c's context rows);
//   * the fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fraction bits).
//
// Covered: sequential Huffman JPEGs (SOF0 baseline, SOF1 extended) of 8-bit
// samples with 1 component, or 3 (YCbCr) in one interleaved scan, any
// sampling factors up to 2x2 (4:4:4, 4:2:2, 4:4:0, 4:2:0), restart
// intervals, byte stuffing; APPn and COM segments are skipped.  Refused,
// by name: progressive, lossless, arithmetic-coded and hierarchical
// frames, 12-bit samples, CMYK/YCCK and RGB-coded (Adobe transform 0)
// files, and sequential files of several scans.
//
// The image is decoded one MCU row at a time into the caller's array; only
// three MCU rows of each component are held (the rows above and below are
// the upsampling's context), so a 21600x10800 texture needs no full-size
// plane of coefficients or samples.
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kMalformed = 2 };

const int kNatural[64 + 16] = {  // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the block lands on the last coefficient
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int status;
  char msg[200];
};

Error make_error(int status, const char* msg) {
  Error e;
  e.status = status;
  std::snprintf(e.msg, sizeof(e.msg), "%s", msg);
  return e;
}

const int kLook = 9;  // bits of the Huffman lookup table

struct Huffman {
  bool present = false;
  uint8_t look_len[1 << kLook];  // 0: the code is longer than kLook
  uint8_t look_val[1 << kLook];
  int32_t maxcode[18];    // the largest code of each length, -1 if none
  int32_t valoffset[18];  // index of a length's first value minus its code
  uint8_t vals[256];
};

// DHT's counts and values -> the table (jdhuff.c jpeg_make_d_derived_tbl)
bool build_huffman(const uint8_t* counts, const uint8_t* vals, int nvals,
                   Huffman* h) {
  h->present = true;
  std::memcpy(h->vals, vals, nvals);
  std::memset(h->look_len, 0, sizeof(h->look_len));
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = counts[l - 1];
    // more codes than the length holds, checked before any lookup entry is
    // written; as in jdhuff.c no code may be all ones
    if (code + n >= (1 << l)) return false;
    if (n) {
      h->valoffset[l] = k - code;
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (l <= kLook) {
          const int shift = kLook - l;
          for (int j = 0; j < (1 << shift); ++j) {
            h->look_len[(code << shift) | j] = static_cast<uint8_t>(l);
            h->look_val[(code << shift) | j] = vals[k];
          }
        }
      }
      h->maxcode[l] = code - 1;
    } else {
      h->maxcode[l] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;  // ends a search past 16 bits
  return true;
}

struct Component {
  int id, h, v, tq, td = 0, ta = 0;
  int dw, dh;          // the component's real size in samples
  int stride;          // samples in a buffer row (MCUs across x h x 8)
  int rows;            // rows of one MCU row (v x 8)
  int dc_pred = 0;
  std::vector<uint8_t> buf[3];  // MCU rows r - 1, r, r + 1 (a ring)
};

struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t acc = 0;  // the next bits, most significant first
  int bits = 0;
  bool at_marker = false;

  // keeps at least 57 bits in acc; past a marker or the end it adds zeros,
  // as libjpeg does
  void fill() {
    while (bits <= 56) {
      uint64_t byte = 0;
      if (!at_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          if (pos + 1 < n && data[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // the marker is left for the caller
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= byte << (56 - bits);
      bits += 8;
    }
  }

  int get(int s) {  // s in 1..16
    if (bits < s) fill();
    const int v = static_cast<int>(acc >> (64 - s));
    acc <<= s;
    bits -= s;
    return v;
  }

  // one Huffman symbol; -1 for a code no table holds
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    const int look = static_cast<int>(acc >> (64 - kLook));
    const int len = h.look_len[look];
    if (len) {
      acc <<= len;
      bits -= len;
      return h.look_val[look];
    }
    int l = kLook + 1;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) return -1;
      code = static_cast<int32_t>(acc >> (64 - l));
    }
    acc <<= l;
    bits -= l;
    return h.vals[(h.valoffset[l] + code) & 0xFF];
  }

  void reset() {
    acc = 0;
    bits = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) {  // jdhuff.c HUFF_EXTEND
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jdmaster.c prepare_range_limit_table: 8-bit samples.  `limit` points at
// index 0 of the "simple" table (valid from -256 to 639); the IDCT's table
// starts 128 further and is indexed with & 1023.
struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  uint8_t* simple;
  uint8_t* idct;
  RangeLimit() {
    uint8_t* t = table + 256;
    simple = t;
    std::memset(t - 256, 0, 256);
    for (int i = 0; i < 256; ++i) t[i] = static_cast<uint8_t>(i);
    t += 128;
    idct = t;
    for (int i = 128; i < 512; ++i) t[i] = 255;
    std::memset(t + 512, 0, 512 - 128);
    std::memcpy(t + 1024 - 128, simple, 128);
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

// jidctint.c jpeg_idct_islow: coefficients in natural order, dequantized
// here, -> an 8x8 block of samples at out (row stride `stride`)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const int CB = 13, P1 = 2;
  const uint8_t* lim = range_limit().idct;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = (ip[0] * qp[0]) * (1 << P1);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CB - P1;
    const int64_t half = int64_t(1) << (sh - 1);
    wp[0] = static_cast<int>((t10 + tmp3 + half) >> sh);
    wp[56] = static_cast<int>((t10 - tmp3 + half) >> sh);
    wp[8] = static_cast<int>((t11 + tmp2 + half) >> sh);
    wp[48] = static_cast<int>((t11 - tmp2 + half) >> sh);
    wp[16] = static_cast<int>((t12 + tmp1 + half) >> sh);
    wp[40] = static_cast<int>((t12 - tmp1 + half) >> sh);
    wp[24] = static_cast<int>((t13 + tmp0 + half) >> sh);
    wp[32] = static_cast<int>((t13 - tmp0 + half) >> sh);
  }
  const int sh = CB + P1 + 3;
  const int64_t half = int64_t(1) << (sh - 1);
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t dc = lim[((wp[0] + (1 << (P1 + 2))) >> (P1 + 3)) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CB);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = lim[static_cast<int>((t10 + tmp3 + half) >> sh) & 1023];
    op[7] = lim[static_cast<int>((t10 - tmp3 + half) >> sh) & 1023];
    op[1] = lim[static_cast<int>((t11 + tmp2 + half) >> sh) & 1023];
    op[6] = lim[static_cast<int>((t11 - tmp2 + half) >> sh) & 1023];
    op[2] = lim[static_cast<int>((t12 + tmp1 + half) >> sh) & 1023];
    op[5] = lim[static_cast<int>((t12 - tmp1 + half) >> sh) & 1023];
    op[3] = lim[static_cast<int>((t13 + tmp0 + half) >> sh) & 1023];
    op[4] = lim[static_cast<int>((t13 - tmp0 + half) >> sh) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = int64_t(1) << (SB - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << 16) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

struct Frame {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  Component comp[3];
  uint16_t quant[4][64];  // natural order
  bool quant_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  size_t scan_pos = 0;  // the first byte of the scan's entropy-coded data
  int scan_comps[3];    // the scan's components, as indices into comp
  int nscan = 0;
};

const char* sof_name(int m) {
  switch (m) {
    case 0xC2: return "progressive (SOF2)";
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "differential sequential (SOF5)";
    case 0xC6: return "differential progressive (SOF6)";
    case 0xC7: return "differential lossless (SOF7)";
    case 0xC9: return "arithmetic-coded sequential (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
    default: return "of an unknown frame type";
  }
}

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// the markers from SOI to the first SOS -> the frame and the scan header
Error parse(const uint8_t* d, size_t n, Frame* f) {
  char msg[200];
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8)
    return make_error(kMalformed, "not a JPEG (no SOI marker)");
  size_t pos = 2;
  bool sof = false;
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;  // junk between segments
    while (pos < n && d[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= n) return make_error(kMalformed, "no SOS marker");
    const int m = d[pos++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) return make_error(kMalformed, "EOI before any scan");
    if (pos + 2 > n) return make_error(kMalformed, "truncated segment");
    const int len = be16(d + pos);
    if (len < 2 || pos + len > n)
      return make_error(kMalformed, "truncated segment");
    const uint8_t* s = d + pos + 2;
    const int sl = len - 2;
    pos += len;
    if (m == 0xC0 || m == 0xC1) {
      if (sof) return make_error(kMalformed, "two SOF markers");
      sof = true;
      if (sl < 6) return make_error(kMalformed, "short SOF segment");
      if (s[0] != 8) {
        std::snprintf(msg, sizeof(msg), "%d-bit samples (SOF%d): the "
                      "decoder takes 8-bit JPEGs", s[0], m - 0xC0);
        return make_error(kUnsupported, msg);
      }
      f->height = be16(s + 1);
      f->width = be16(s + 3);
      f->ncomp = s[5];
      if (f->height == 0)
        return make_error(kUnsupported, "a height defined by a DNL marker");
      if (f->width == 0) return make_error(kMalformed, "zero width");
      if (f->ncomp == 4) {
        std::snprintf(msg, sizeof(msg), "a 4-component (CMYK/YCCK) SOF%d "
                      "frame", m - 0xC0);
        return make_error(kUnsupported, msg);
      }
      if (f->ncomp != 1 && f->ncomp != 3) {
        std::snprintf(msg, sizeof(msg), "%d components (SOF%d)", f->ncomp,
                      m - 0xC0);
        return make_error(kUnsupported, msg);
      }
      if (sl < 6 + 3 * f->ncomp)
        return make_error(kMalformed, "short SOF segment");
      for (int i = 0; i < f->ncomp; ++i) {
        Component& c = f->comp[i];
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i];
        if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) {
          std::snprintf(msg, sizeof(msg), "sampling factors %dx%d (SOF%d): "
                        "the decoder takes 1 and 2", c.h, c.v, m - 0xC0);
          return make_error(kUnsupported, msg);
        }
        if (c.tq > 3) return make_error(kMalformed, "bad quant table index");
      }
    } else if ((m >= 0xC2 && m <= 0xC7 && m != 0xC4) ||
               (m >= 0xC9 && m <= 0xCB) ||
               (m >= 0xCD && m <= 0xCF)) {
      std::snprintf(msg, sizeof(msg), "a %s JPEG: the decoder takes "
                    "baseline (SOF0) and extended sequential (SOF1) Huffman "
                    "JPEGs", sof_name(m));
      return make_error(kUnsupported, msg);
    } else if (m == 0xCC) {
      return make_error(kUnsupported, "arithmetic coding conditioning (DAC)");
    } else if (m == 0xDB) {  // DQT
      int i = 0;
      while (i < sl) {
        const int pq = s[i] >> 4, tq = s[i] & 15;
        ++i;
        if (tq > 3 || pq > 1 || i + 64 * (pq + 1) > sl)
          return make_error(kMalformed, "bad DQT segment");
        for (int k = 0; k < 64; ++k) {
          f->quant[tq][kNatural[k]] =
              pq ? static_cast<uint16_t>(be16(s + i + 2 * k)) : s[i + k];
        }
        f->quant_present[tq] = true;
        i += 64 * (pq + 1);
      }
    } else if (m == 0xC4) {  // DHT
      int i = 0;
      while (i < sl) {
        if (i + 17 > sl) return make_error(kMalformed, "bad DHT segment");
        const int tc = s[i] >> 4, th = s[i] & 15;
        const uint8_t* counts = s + i + 1;
        int nv = 0;
        for (int k = 0; k < 16; ++k) nv += counts[k];
        if (tc > 1 || th > 3 || nv > 256 || i + 17 + nv > sl)
          return make_error(kMalformed, "bad DHT segment");
        if (!build_huffman(counts, s + i + 17, nv,
                           tc ? &f->ac[th] : &f->dc[th]))
          return make_error(kMalformed, "bad Huffman table");
        i += 17 + nv;
      }
    } else if (m == 0xDD) {  // DRI
      if (sl < 2) return make_error(kMalformed, "bad DRI segment");
      f->restart = be16(s);
    } else if (m == 0xE0) {
      if (sl >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) f->jfif = true;
    } else if (m == 0xEE) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        f->adobe = true;
        f->adobe_transform = s[11];
      }
    } else if (m == 0xDA) {  // SOS
      if (!sof) return make_error(kMalformed, "SOS before SOF");
      if (sl < 1) return make_error(kMalformed, "bad SOS segment");
      const int ns = s[0];
      if (sl < 1 + 2 * ns + 3 || ns < 1 || ns > f->ncomp)
        return make_error(kMalformed, "bad SOS segment");
      if (ns != f->ncomp) {
        std::snprintf(msg, sizeof(msg), "a sequential JPEG of several scans "
                      "(%d of %d components in the first): the decoder takes "
                      "one interleaved scan", ns, f->ncomp);
        return make_error(kUnsupported, msg);
      }
      for (int i = 0; i < ns; ++i) {
        const int cid = s[1 + 2 * i], t = s[2 + 2 * i];
        int ci = -1;
        for (int k = 0; k < f->ncomp; ++k)
          if (f->comp[k].id == cid) ci = k;
        if (ci < 0) return make_error(kMalformed, "SOS names no component");
        f->comp[ci].td = t >> 4;
        f->comp[ci].ta = t & 15;
        if (f->comp[ci].td > 3 || f->comp[ci].ta > 3)
          return make_error(kMalformed, "bad Huffman table index");
        f->scan_comps[i] = ci;
      }
      f->nscan = ns;
      const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
      if (ss != 0 || se != 63)
        return make_error(kMalformed, "a sequential scan must span 0..63");
      f->scan_pos = pos;
      break;
    }
    // APPn, COM and any other segment: skipped
  }
  if (f->ncomp == 3) {
    // libjpeg's colour space of 3 components (jdapimin.c
    // default_decompress_parms): JFIF or Adobe transform 1 -> YCbCr, Adobe
    // transform 0 or the IDs 'R','G','B' -> RGB, otherwise YCbCr
    bool rgb = false;
    if (!f->jfif && f->adobe) {
      rgb = f->adobe_transform == 0;
    } else if (!f->jfif && f->comp[0].id == 82 && f->comp[1].id == 71 &&
               f->comp[2].id == 66) {
      rgb = true;
    }
    if (rgb)
      return make_error(kUnsupported, "an RGB-coded (Adobe transform 0) "
                        "JPEG: the decoder takes YCbCr");
  }
  for (int i = 0; i < f->ncomp; ++i) {
    Component& c = f->comp[i];
    if (!f->quant_present[c.tq])
      return make_error(kMalformed, "a component's quant table is missing");
    if (!f->dc[c.td].present || !f->ac[c.ta].present)
      return make_error(kMalformed, "a component's Huffman table is missing");
  }
  if (f->ncomp == 1) {  // one block an MCU, whatever the factors say
    f->comp[0].h = f->comp[0].v = 1;
  }
  for (int i = 0; i < f->ncomp; ++i) {
    f->hmax = f->comp[i].h > f->hmax ? f->comp[i].h : f->hmax;
    f->vmax = f->comp[i].v > f->vmax ? f->comp[i].v : f->vmax;
  }
  return make_error(kOk, "");
}

// one upsampled component row (width w) for output row y
struct Upsampler {
  const Frame* f;
  int mcu_rows_done;  // MCU rows decoded so far

  const uint8_t* row(const Component& c, int j) const {
    const int r = j / c.rows;  // the MCU row holding component row j
    return c.buf[r % 3].data() + static_cast<size_t>(j % c.rows) * c.stride;
  }

  void run(const Component& c, int y, uint8_t* out, int* tmp) const {
    const int fx = f->hmax / c.h, fy = f->vmax / c.v;
    const int dw = c.dw;
    const uint8_t* r0;
    const uint8_t* r1 = nullptr;
    int bias = 0;
    if (fy == 1) {
      r0 = row(c, y);
    } else {
      const int j = y >> 1;
      r0 = row(c, j);
      if (y & 1) {  // the row below, the last real row repeated
        r1 = row(c, j + 1 < c.dh ? j + 1 : c.dh - 1);
        bias = 2;
      } else {  // the row above, the first repeated
        r1 = row(c, j > 0 ? j - 1 : 0);
        bias = 1;
      }
    }
    if (fx == 1) {
      if (fy == 1) {
        std::memcpy(out, r0, dw);
      } else {  // h1v2_fancy_upsample
        for (int x = 0; x < dw; ++x) out[x] = (3 * r0[x] + r1[x] + bias) >> 2;
      }
      return;
    }
    if (dw <= 2) {  // h2v1_upsample, h2v2_upsample: replication
      for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = r0[x];
      return;
    }
    if (fy == 1) {  // h2v1_fancy_upsample
      int v = r0[0];
      out[0] = static_cast<uint8_t>(v);
      out[1] = static_cast<uint8_t>((v * 3 + r0[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = r0[x] * 3;
        out[2 * x] = static_cast<uint8_t>((v + r0[x - 1] + 1) >> 2);
        out[2 * x + 1] = static_cast<uint8_t>((v + r0[x + 1] + 2) >> 2);
      }
      v = r0[dw - 1];
      out[2 * dw - 2] = static_cast<uint8_t>((v * 3 + r0[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = static_cast<uint8_t>(v);
      return;
    }
    // h2v2_fancy_upsample
    for (int x = 0; x < dw; ++x) tmp[x] = r0[x] * 3 + r1[x];
    int last, cur = tmp[0], next = tmp[1];
    out[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int x = 2; x < dw; ++x) {
      next = tmp[x];
      out[2 * x - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
      out[2 * x - 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    out[2 * dw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
    out[2 * dw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
  }
};

Error decode(const uint8_t* d, size_t n, uint8_t* out) {
  Frame* fp = new Frame();
  Frame& f = *fp;
  struct Guard {
    Frame* f;
    ~Guard() { delete f; }
  } guard{fp};
  Error e = parse(d, n, &f);
  if (e.status != kOk) return e;
  const int W = f.width, H = f.height, nc = f.ncomp;
  const int mcu_w = 8 * f.hmax, mcu_h = 8 * f.vmax;
  const int mcux = (W + mcu_w - 1) / mcu_w, mcuy = (H + mcu_h - 1) / mcu_h;
  for (int i = 0; i < nc; ++i) {
    Component& c = f.comp[i];
    c.dw = static_cast<int>((int64_t(W) * c.h + f.hmax - 1) / f.hmax);
    c.dh = static_cast<int>((int64_t(H) * c.v + f.vmax - 1) / f.vmax);
    if (nc == 1) {  // a non-interleaved scan: blocks of the image alone
      c.stride = ((W + 7) / 8) * 8;
    } else {
      c.stride = mcux * c.h * 8;
    }
    c.rows = 8 * c.v;
    for (auto& b : c.buf) b.assign(static_cast<size_t>(c.stride) * c.rows, 0);
  }
  const int across = nc == 1 ? (W + 7) / 8 : mcux;  // MCUs in an MCU row
  const int down = nc == 1 ? (H + 7) / 8 : mcuy;
  BitReader br{d, n, f.scan_pos};
  int16_t blk[64];
  int todo = f.restart;  // MCUs to the next restart marker
  int next_rst = 0;
  Upsampler up{&f, 0};
  std::vector<uint8_t> line[3];
  for (auto& l : line) l.assign(static_cast<size_t>(2 * W + 16), 0);
  std::vector<int> tmp(static_cast<size_t>(W + 16));
  const YccTables& yt = ycc_tables();
  const uint8_t* lim = range_limit().simple;
  const int out_rows = nc == 1 ? 8 : mcu_h;

  // MCU row r's output rows, once MCU row r + 1 (its context) is decoded
  auto emit = [&](int r) {
    const int y0 = r * out_rows;
    const int y1 = y0 + out_rows < H ? y0 + out_rows : H;
    for (int y = y0; y < y1; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * W * nc;
      if (nc == 1) {
        std::memcpy(o, up.row(f.comp[0], y), W);
        continue;
      }
      for (int i = 0; i < 3; ++i) up.run(f.comp[i], y, line[i].data(),
                                         tmp.data());
      const uint8_t* Y = line[0].data();
      const uint8_t* cb = line[1].data();
      const uint8_t* cr = line[2].data();
      for (int x = 0; x < W; ++x) {  // jdcolor.c ycc_rgb_convert
        const int yy = Y[x];
        o[3 * x] = lim[yy + yt.cr_r[cr[x]]];
        o[3 * x + 1] = lim[yy + static_cast<int>(
                                    (yt.cb_g[cb[x]] + yt.cr_g[cr[x]]) >> 16)];
        o[3 * x + 2] = lim[yy + yt.cb_b[cb[x]]];
      }
    }
  };

  for (int r = 0; r < down; ++r) {
    for (int mx = 0; mx < across; ++mx) {
      if (f.restart && todo == 0) {  // expect RSTn, then start afresh
        size_t p = br.pos;  // the next marker: 0xFF, fill bytes, a code
        while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00)) ++p;
        while (p < n && d[p] == 0xFF) ++p;
        if (p >= n || d[p] != 0xD0 + next_rst)
          return make_error(kMalformed, "a restart marker is missing");
        br.pos = p + 1;
        br.reset();
        next_rst = (next_rst + 1) & 7;
        todo = f.restart;
        for (int i = 0; i < nc; ++i) f.comp[i].dc_pred = 0;
      }
      for (int si = 0; si < f.nscan; ++si) {
        Component& c = f.comp[f.scan_comps[si]];
        const Huffman& hd = f.dc[c.td];
        const Huffman& ha = f.ac[c.ta];
        const uint16_t* q = f.quant[c.tq];
        uint8_t* base = c.buf[r % 3].data();
        for (int by = 0; by < c.v; ++by) {
          for (int bx = 0; bx < c.h; ++bx) {
            std::memset(blk, 0, sizeof(blk));
            int s = br.decode(hd);
            if (s < 0 || s > 15)
              return make_error(kMalformed, "bad Huffman code (DC)");
            const int diff = s ? extend(br.get(s), s) : 0;
            c.dc_pred += diff;
            blk[0] = static_cast<int16_t>(c.dc_pred);
            for (int k = 1; k < 64; ++k) {
              const int rs = br.decode(ha);
              if (rs < 0)
                return make_error(kMalformed, "bad Huffman code (AC)");
              const int run = rs >> 4;
              s = rs & 15;
              if (s) {
                k += run;
                blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
              } else {
                if (run != 15) break;
                k += 15;
              }
            }
            const int col = (mx * c.h + bx) * 8;
            const int row = by * 8;
            idct_islow(blk, q, base + static_cast<size_t>(row) * c.stride + col,
                       c.stride);
          }
        }
      }
      if (f.restart) --todo;
    }
    if (r > 0) emit(r - 1);
  }
  emit(down - 1);
  return make_error(kOk, "");
}

void put_msg(const Error& e, char* msg, int64_t msg_len) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", e.msg);
}

}  // namespace

// hwc: the image's height, width and components (1 or 3).  Returns 0, 1
// (a JPEG this decoder does not take; `msg` names its kind) or 2 (not a
// valid JPEG; `msg` says why).
extern "C" int jpeg_header(const uint8_t* data, int64_t n, int64_t* hwc,
                           char* msg, int64_t msg_len) {
  Frame* f = new Frame();
  const Error e = parse(data, static_cast<size_t>(n), f);
  if (e.status == kOk) {
    hwc[0] = f->height;
    hwc[1] = f->width;
    hwc[2] = f->ncomp;
  }
  delete f;
  put_msg(e, msg, msg_len);
  return e.status;
}

// out: height x width x components bytes, row-major.  Returns as
// jpeg_header does.
extern "C" int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                           char* msg, int64_t msg_len) {
  const Error e = decode(data, static_cast<size_t>(n), out);
  put_msg(e, msg, msg_len);
  return e.status;
}
