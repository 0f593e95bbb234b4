// A JPEG decoder for terrain_tpu_torch/data/jpeg.py, in host C++.
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
//   * the fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fraction bits);
//   * progressive files: jdphuff.c's four kinds of scan (DC first and
//     refinement, interleaved or not; AC first and refinement with spectral
//     selection, successive approximation and EOB runs) and jdcoefct.c's
//     block smoothing (libjpeg-turbo 2.1 and later: a 5x5 neighbourhood of
//     DC values), which only changes coefficients whose bits are still
//     unrefined after the last scan -- a file whose scans refine every
//     coefficient is not smoothed, one cut after an early scan is.
//
// Covered: Huffman JPEGs of 8-bit samples, sequential (SOF0 baseline, SOF1
// extended: one interleaved scan) or progressive (SOF2: any scans, the
// tables and restart interval (DRI) given again before each), with 1
// component, or 3 (YCbCr), any sampling factors up to 2x2 (4:4:4, 4:2:2,
// 4:4:0, 4:2:0), restart intervals in every kind of scan, byte stuffing;
// APPn and COM segments are skipped.  Refused, by name: lossless,
// arithmetic-coded and hierarchical frames, 12-bit samples, CMYK/YCCK and
// RGB-coded (Adobe transform 0) files, and sequential files of several
// scans.
//
// A sequential image is decoded one MCU row at a time into the caller's
// array; only three MCU rows of each component's samples are held (the
// rows above and below are the upsampling's context).  A progressive one
// first reads every scan into a buffer of all its coefficients (int16, 128
// bytes a block, dummy blocks of the MCUs included: ~700 MB for a
// 21600x10800 4:2:0 texture), then leaves it the same way, one MCU row at a
// time; nothing else it allocates grows with the image's height.
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// kTruncated: the file ends where libjpeg needs more (Pillow's OSError)
enum Status { kOk = 0, kUnsupported = 1, kMalformed = 2, kTruncated = 3 };

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
  int bw, bh;          // its real blocks across and down
  int pw, ph;          // blocks across and down with the MCUs' dummy ones
  int stride;          // samples in a buffer row (MCUs across x h x 8)
  int rows;            // rows of one MCU row (v x 8)
  int dc_pred = 0;
  uint16_t q[64];      // the quant table latched at its first scan
  bool q_latched = false;
  std::vector<uint8_t> buf[3];  // MCU rows r - 1, r, r + 1 (a ring)
  // progressive: every block's coefficients (pw x ph blocks of 64, natural
  // order) and, for each zigzag index, the point transform Al of the last
  // scan that coded it (-1: none yet), jdphuff.c's coef_bits
  std::vector<int16_t> coef;
  int bits[64];
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

  int get(int s) {  // s in 0..16
    if (s == 0) return 0;
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

struct Scan {
  int ns = 0;
  int comps[3] = {0, 0, 0};  // the scan's components, as indices into comp
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Frame {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool progressive = false;
  Component comp[3];
  uint16_t quant[4][64];  // natural order
  bool quant_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  size_t scan_pos = 0;  // the first byte of the scan's entropy-coded data
  Scan scan;            // the scan being read
  int scans = 0;        // scans read so far
  bool eoi = false;
};

const char* sof_name(int m) {
  switch (m) {
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

Error parse_sof(const uint8_t* s, int sl, int m, Frame* f) {
  char msg[200];
  if (sl < 6) return make_error(kMalformed, "short SOF segment");
  if (s[0] != 8) {
    std::snprintf(msg, sizeof(msg), "%d-bit samples (SOF%d): the "
                  "decoder takes 8-bit JPEGs", s[0], m - 0xC0);
    return make_error(kUnsupported, msg);
  }
  f->progressive = m == 0xC2;
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
  return make_error(kOk, "");
}

// an SOS segment -> f->scan, its components' tables chosen and their quant
// tables latched at their first scan (jdinput.c latch_quant_tables)
Error parse_sos(const uint8_t* s, int sl, Frame* f) {
  char msg[200];
  if (sl < 1) return make_error(kMalformed, "bad SOS segment");
  const int ns = s[0];
  if (sl < 1 + 2 * ns + 3 || ns < 1 || ns > f->ncomp)
    return make_error(kMalformed, "bad SOS segment");
  Scan& sc = f->scan;
  sc.ns = ns;
  for (int i = 0; i < ns; ++i) {
    const int cid = s[1 + 2 * i], t = s[2 + 2 * i];
    int ci = -1;
    for (int k = 0; k < f->ncomp; ++k)
      if (f->comp[k].id == cid) ci = k;
    if (ci < 0) return make_error(kMalformed, "SOS names no component");
    Component& c = f->comp[ci];
    c.td = t >> 4;
    c.ta = t & 15;
    if (c.td > 3 || c.ta > 3)
      return make_error(kMalformed, "bad Huffman table index");
    if (!c.q_latched) {
      if (!f->quant_present[c.tq])
        return make_error(kMalformed, "a component's quant table is missing");
      std::memcpy(c.q, f->quant[c.tq], sizeof(c.q));
      c.q_latched = true;
    }
    sc.comps[i] = ci;
  }
  sc.ss = s[1 + 2 * ns];
  sc.se = s[2 + 2 * ns];
  sc.ah = s[3 + 2 * ns] >> 4;
  sc.al = s[3 + 2 * ns] & 15;
  if (!f->progressive) {
    if (ns != f->ncomp) {
      std::snprintf(msg, sizeof(msg), "a sequential JPEG of several scans "
                    "(%d of %d components in the first): the decoder takes "
                    "one interleaved scan", ns, f->ncomp);
      return make_error(kUnsupported, msg);
    }
    if (sc.ss != 0 || sc.se != 63)
      return make_error(kMalformed, "a sequential scan must span 0..63");
  } else {  // jdinput.c / jdphuff.c start_pass_phuff_decoder's checks
    const bool dc = sc.ss == 0;
    if ((dc && sc.se != 0) || (!dc && (sc.se < sc.ss || sc.se > 63 ||
                                       ns != 1)) ||
        (sc.ah != 0 && sc.al != sc.ah - 1) || sc.al > 13)
      return make_error(kMalformed, "a progressive scan of bad parameters");
  }
  for (int i = 0; i < ns; ++i) {
    const Component& c = f->comp[sc.comps[i]];
    const bool need_dc = !f->progressive || (sc.ss == 0 && sc.ah == 0);
    const bool need_ac = !f->progressive || sc.ss > 0;
    if ((need_dc && !f->dc[c.td].present) ||
        (need_ac && !f->ac[c.ta].present))
      return make_error(kMalformed, "a component's Huffman table is missing");
  }
  return make_error(kOk, "");
}

// the markers from `pos` to the next SOS (f->scan and f->scan_pos set) or
// EOI (f->eoi set): the frame header before the first scan, tables and
// restart intervals before each one
Error parse_from(const uint8_t* d, size_t n, size_t pos, Frame* f) {
  char msg[200];
  const bool first = f->scans == 0;
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;  // junk between segments
    while (pos < n && d[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= n) {
      if (first) return make_error(kMalformed, "no SOS marker");
      std::snprintf(msg, sizeof(msg), "the file ends after scan %d without "
                    "an EOI marker", f->scans);
      return make_error(kTruncated, msg);
    }
    const int m = d[pos++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) {
      if (first) return make_error(kMalformed, "EOI before any scan");
      f->eoi = true;
      return make_error(kOk, "");
    }
    // Pillow reads the markers before the first scan: a cut marker length
    // is its ValueError there, cut segment data its OSError; libjpeg reads
    // those after it, where every cut is the OSError
    if (pos + 2 > n)
      return make_error(first ? kMalformed : kTruncated, "truncated segment");
    const int len = be16(d + pos);
    if (len < 2) return make_error(kMalformed, "bad segment length");
    if (pos + len > n) return make_error(kTruncated, "truncated segment");
    const uint8_t* s = d + pos + 2;
    const int sl = len - 2;
    pos += len;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (f->ncomp) return make_error(kMalformed, "two SOF markers");
      const Error e = parse_sof(s, sl, m, f);
      if (e.status != kOk) return e;
    } else if ((m >= 0xC3 && m <= 0xC7 && m != 0xC4) ||
               (m >= 0xC9 && m <= 0xCB) ||
               (m >= 0xCD && m <= 0xCF)) {
      std::snprintf(msg, sizeof(msg), "a %s JPEG: the decoder takes "
                    "baseline (SOF0), extended sequential (SOF1) and "
                    "progressive (SOF2) Huffman JPEGs", sof_name(m));
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
      if (!f->ncomp) return make_error(kMalformed, "SOS before SOF");
      if (first) {
        // libjpeg's colour space of 3 components (jdapimin.c
        // default_decompress_parms): JFIF or Adobe transform 1 -> YCbCr,
        // Adobe transform 0 or the IDs 'R','G','B' -> RGB, else YCbCr
        bool rgb = false;
        if (f->ncomp == 3 && !f->jfif && f->adobe) {
          rgb = f->adobe_transform == 0;
        } else if (f->ncomp == 3 && !f->jfif && f->comp[0].id == 82 &&
                   f->comp[1].id == 71 && f->comp[2].id == 66) {
          rgb = true;
        }
        if (rgb)
          return make_error(kUnsupported, "an RGB-coded (Adobe transform 0) "
                            "JPEG: the decoder takes YCbCr");
      }
      const Error e = parse_sos(s, sl, f);
      if (e.status != kOk) return e;
      f->scan_pos = pos;
      ++f->scans;
      return make_error(kOk, "");
    }
    // APPn, COM and any other segment: skipped
  }
}

// the frame header and the first scan's; the components' sizes
Error parse(const uint8_t* d, size_t n, Frame* f) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8)
    return make_error(kMalformed, "not a JPEG (no SOI marker)");
  const Error e = parse_from(d, n, 2, f);
  if (e.status != kOk) return e;
  if (f->ncomp == 1) {  // one block an MCU, whatever the factors say
    f->comp[0].h = f->comp[0].v = 1;
  }
  for (int i = 0; i < f->ncomp; ++i) {
    f->hmax = f->comp[i].h > f->hmax ? f->comp[i].h : f->hmax;
    f->vmax = f->comp[i].v > f->vmax ? f->comp[i].v : f->vmax;
  }
  const int mcux = (f->width + 8 * f->hmax - 1) / (8 * f->hmax);
  const int mcuy = (f->height + 8 * f->vmax - 1) / (8 * f->vmax);
  for (int i = 0; i < f->ncomp; ++i) {
    Component& c = f->comp[i];
    c.dw = static_cast<int>((int64_t(f->width) * c.h + f->hmax - 1) / f->hmax);
    c.dh = static_cast<int>((int64_t(f->height) * c.v + f->vmax - 1) /
                            f->vmax);
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.pw = f->ncomp == 1 ? c.bw : mcux * c.h;  // MCUs hold dummy blocks
    c.ph = f->ncomp == 1 ? c.bh : mcuy * c.v;
  }
  return make_error(kOk, "");
}

// one upsampled component row (width w) for output row y
struct Upsampler {
  const Frame* f;

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

// the restart interval's bookkeeping of a scan: at every `interval` MCUs
// the next RSTn marker, then the bit reader, the DC predictions and the
// EOB run start afresh
struct Restarts {
  int interval, todo, next = 0;

  explicit Restarts(int r) : interval(r), todo(r) {}

  // before an MCU: false when the expected marker is missing
  bool before(const uint8_t* d, size_t n, BitReader* br, Frame* f,
              int* eobrun) {
    if (!interval || todo) return true;
    size_t p = br->pos;  // the next marker: 0xFF, fill bytes, a code
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00)) ++p;
    while (p < n && d[p] == 0xFF) ++p;
    if (p >= n || d[p] != 0xD0 + next) return false;
    br->pos = p + 1;
    br->reset();
    next = (next + 1) & 7;
    todo = interval;
    for (int i = 0; i < f->ncomp; ++i) f->comp[i].dc_pred = 0;
    *eobrun = 0;
    return true;
  }

  void after() {
    if (interval) --todo;
  }
};

// the output side shared by both kinds: `fill(r)` puts MCU row r of every
// component's samples into its ring; each MCU row's output rows are made
// once the next one (their upsampling context) is there
template <typename Fill>
Error run_rows(Frame& f, uint8_t* out, Fill fill) {
  const int W = f.width, H = f.height, nc = f.ncomp;
  const int mcux = (W + 8 * f.hmax - 1) / (8 * f.hmax);
  const int mcuy = (H + 8 * f.vmax - 1) / (8 * f.vmax);
  for (int i = 0; i < nc; ++i) {
    Component& c = f.comp[i];
    c.stride = nc == 1 ? c.bw * 8 : mcux * c.h * 8;
    c.rows = 8 * c.v;
    for (auto& b : c.buf) b.assign(static_cast<size_t>(c.stride) * c.rows, 0);
  }
  const int down = nc == 1 ? (H + 7) / 8 : mcuy;
  Upsampler up{&f};
  std::vector<uint8_t> line[3];
  for (auto& l : line) l.assign(static_cast<size_t>(2 * W + 16), 0);
  std::vector<int> tmp(static_cast<size_t>(W + 16));
  const YccTables& yt = ycc_tables();
  const uint8_t* lim = range_limit().simple;
  const int out_rows = nc == 1 ? 8 : 8 * f.vmax;

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
    const Error e = fill(r);
    if (e.status != kOk) return e;
    if (r > 0) emit(r - 1);
  }
  emit(down - 1);
  return make_error(kOk, "");
}

// ------------------------------------------------------------ sequential
Error decode_baseline(const uint8_t* d, size_t n, Frame& f, uint8_t* out) {
  const int mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
  const int across = f.ncomp == 1 ? f.comp[0].bw : mcux;  // MCUs a row
  BitReader br{d, n, f.scan_pos};
  Restarts rst(f.restart);
  int eobrun = 0;
  int16_t blk[64];
  auto fill = [&](int r) -> Error {
    for (int mx = 0; mx < across; ++mx) {
      if (!rst.before(d, n, &br, &f, &eobrun))
        return make_error(kMalformed, "a restart marker is missing");
      for (int si = 0; si < f.scan.ns; ++si) {
        Component& c = f.comp[f.scan.comps[si]];
        const Huffman& hd = f.dc[c.td];
        const Huffman& ha = f.ac[c.ta];
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
            idct_islow(blk, c.q, base + static_cast<size_t>(row) * c.stride +
                                      col, c.stride);
          }
        }
      }
      rst.after();
    }
    return make_error(kOk, "");
  };
  const Error e = run_rows(f, out, fill);
  if (e.status != kOk) return e;
  // libjpeg reads on to the EOI marker (jpeg_finish_decompress) and Pillow
  // feeds it until then, so a file that ends first is truncated there:
  // the rest of the scan's bytes skipped, up to a marker that is neither
  // stuffing nor a restart
  size_t p = br.pos;
  while (p < n && !(d[p] == 0xFF && p + 1 < n && d[p + 1] != 0x00 &&
                    d[p + 1] != 0xFF && (d[p + 1] < 0xD0 || d[p + 1] > 0xD7)))
    ++p;
  return parse_from(d, n, p, &f);
}

// ----------------------------------------------------------- progressive
// one block's share of a progressive scan (jdphuff.c decode_mcu_DC_first,
// decode_mcu_DC_refine, decode_mcu_AC_first, decode_mcu_AC_refine)
bool decode_block(BitReader& br, Frame& f, Component& c, int16_t* blk,
                  int* eobrun) {
  const Scan& sc = f.scan;
  if (sc.ss == 0) {
    if (sc.ah == 0) {
      const int s = br.decode(f.dc[c.td]);
      if (s < 0 || s > 15) return false;
      c.dc_pred += s ? extend(br.get(s), s) : 0;
      blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred)
                                    << sc.al);
    } else if (br.get(1)) {
      blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
    }
    return true;
  }
  const Huffman& ha = f.ac[c.ta];
  if (sc.ah == 0) {
    if (*eobrun > 0) {
      --*eobrun;
      return true;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      const int rs = br.decode(ha);
      if (rs < 0) return false;
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.get(s), s)) << sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get(r);
        --*eobrun;
        break;
      }
    }
    return true;
  }
  const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
  int k = sc.ss;
  auto correct = [&](int16_t* coef) {  // a correction bit of a nonzero one
    if (br.get(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  };
  if (*eobrun == 0) {
    for (; k <= sc.se; ++k) {
      const int rs = br.decode(ha);
      if (rs < 0) return false;
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        s = br.get(1) ? p1 : m1;  // a newly nonzero coefficient's sign
      } else if (r != 15) {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (*eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0) correct(coef);
    }
    --*eobrun;
  }
  return true;
}

// the scan at f.scan_pos into the coefficient buffers; returns the position
// after its entropy-coded data
Error decode_scan(const uint8_t* d, size_t n, Frame& f, size_t* end) {
  const Scan& sc = f.scan;
  BitReader br{d, n, f.scan_pos};
  Restarts rst(f.restart);
  int eobrun = 0;
  for (int i = 0; i < f.ncomp; ++i) f.comp[i].dc_pred = 0;
  const bool interleaved = sc.ns > 1;
  Component& c0 = f.comp[sc.comps[0]];
  const int across = interleaved ? (f.width + 8 * f.hmax - 1) / (8 * f.hmax)
                                 : c0.bw;
  const int down = interleaved ? (f.height + 8 * f.vmax - 1) / (8 * f.vmax)
                               : c0.bh;
  char msg[200];
  for (int my = 0; my < down; ++my) {
    for (int mx = 0; mx < across; ++mx) {
      if (!rst.before(d, n, &br, &f, &eobrun)) {
        std::snprintf(msg, sizeof(msg), "a restart marker is missing in "
                      "scan %d", f.scans);
        return make_error(kMalformed, msg);
      }
      for (int si = 0; si < sc.ns; ++si) {
        Component& c = f.comp[sc.comps[si]];
        const int bh = interleaved ? c.v : 1, bw = interleaved ? c.h : 1;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            const size_t row = interleaved ? my * c.v + by : my;
            const size_t col = interleaved ? mx * c.h + bx : mx;
            int16_t* blk = c.coef.data() + (row * c.pw + col) * 64;
            if (!decode_block(br, f, c, blk, &eobrun)) {
              std::snprintf(msg, sizeof(msg), "bad Huffman code in scan %d",
                            f.scans);
              return make_error(kMalformed, msg);
            }
          }
        }
      }
      rst.after();
    }
  }
  for (int i = 0; i < sc.ns; ++i) {  // jdphuff.c: coef_bits[k] = Al
    Component& c = f.comp[sc.comps[i]];
    for (int k = sc.ss; k <= sc.se; ++k) c.bits[k] = sc.al;
  }
  size_t p = br.pos;
  while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00)) ++p;
  *end = p;
  return make_error(kOk, "");
}

// jdcoefct.c's block smoothing (libjpeg-turbo 2.1 and later): the first
// nine AC coefficients, where still zero and not known to full precision,
// estimated from the DC values of the block's 5x5 neighbourhood; where no
// AC coefficient of 1..9 has been decoded at all, the DC too
const int kSavedPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

bool smoothing_ok(const Frame& f) {
  bool useful = false;
  for (int i = 0; i < f.ncomp; ++i) {
    const Component& c = f.comp[i];
    for (int k = 0; k < 10; ++k)
      if (c.q[kSavedPos[k]] == 0) return false;
    if (c.bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.bits[k] != 0) useful = true;
  }
  return useful;
}

inline int predict(int64_t num, int64_t q, int al, bool clamp) {
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// component c's block row `row` (its blocks' samples into `base`), smoothed
// when `smooth`; `r` is the iMCU row, `total` the frame's iMCU rows
void idct_row(const Component& c, int r, int br_, int total, bool smooth,
              uint8_t* base) {
  const size_t row = static_cast<size_t>(r) * c.v + br_;
  const int16_t* cur = c.coef.data() + row * c.pw * 64;
  if (!smooth) {
    for (int x = 0; x < c.bw; ++x)
      idct_islow(cur + x * 64, c.q, base + x * 8, c.stride);
    return;
  }
  // jdcoefct.c decompress_smooth_data's rows: the last iMCU row counts the
  // real block rows only, and the image's block rows are that count times
  // the iMCU rows, as libjpeg-turbo computes them
  int block_rows = c.v;
  if (r == total - 1) {
    block_rows = c.bh % c.v;
    if (block_rows == 0) block_rows = c.v;
  }
  const int img = r * block_rows + br_;
  const int imgs = block_rows * total;
  const size_t rs = static_cast<size_t>(c.pw) * 64;
  const int16_t* prev = img > 0 ? cur - rs : cur;
  const int16_t* prev2 = img > 1 ? cur - 2 * rs : prev;
  const int16_t* next = img < imgs - 1 ? cur + rs : cur;
  const int16_t* next2 = img < imgs - 2 ? cur + 2 * rs : next;
  const int16_t* rows[5] = {prev2, prev, cur, next, next2};
  const int* bits = c.bits;
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                         bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                         bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                Q21 = c.q[17], Q30 = c.q[24];
  const int last = c.bw - 1;
  // DC[i][j]: row i (0 two above .. 4 two below), column j (0 two left ..
  // 4 two right); the columns past either edge repeat the edge's
  int DC[5][5];
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j) DC[i][j] = rows[i][0];
  int16_t ws[64];
  for (int x = 0; x <= last; ++x) {
    std::memcpy(ws, cur + x * 64, sizeof(ws));
    if (x == 0 && x < last)
      for (int i = 0; i < 5; ++i) DC[i][3] = DC[i][4] = rows[i][64];
    if (x + 1 < last)
      for (int i = 0; i < 5; ++i) DC[i][4] = rows[i][128 + x * 64];
    const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2],
              DC04 = DC[0][3], DC05 = DC[0][4], DC06 = DC[1][0],
              DC07 = DC[1][1], DC08 = DC[1][2], DC09 = DC[1][3],
              DC10 = DC[1][4], DC11 = DC[2][0], DC12 = DC[2][1],
              DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4],
              DC16 = DC[3][0], DC17 = DC[3][1], DC18 = DC[3][2],
              DC19 = DC[3][3], DC20 = DC[3][4], DC21 = DC[4][0],
              DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3],
              DC25 = DC[4][4];
    int al;
    if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
      const int64_t num = Q00 * (change_dc ?
          (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
           13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
           3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
           DC21 - DC22 + DC24 + DC25) :
          (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
      ws[1] = static_cast<int16_t>(predict(num, Q01, al, true));
    }
    if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
      const int64_t num = Q00 * (change_dc ?
          (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
           13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
           13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
           3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
          (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
      ws[8] = static_cast<int16_t>(predict(num, Q10, al, true));
    }
    if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
      const int64_t num = Q00 * (change_dc ?
          (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
           5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
          (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
      ws[16] = static_cast<int16_t>(predict(num, Q20, al, true));
    }
    if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
      const int64_t num = Q00 * (change_dc ?
          (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
           9 * DC19 + DC21 - DC25) :
          (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
           DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
      ws[9] = static_cast<int16_t>(predict(num, Q11, al, true));
    }
    if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
      const int64_t num = Q00 * (change_dc ?
          (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
           7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
          (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
      ws[2] = static_cast<int16_t>(predict(num, Q02, al, true));
    }
    if (change_dc) {
      if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
        const int64_t num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                   DC17 - DC19);
        ws[3] = static_cast<int16_t>(predict(num, Q03, al, true));
      }
      if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
        const int64_t num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                   3 * DC18 - DC19);
        ws[10] = static_cast<int16_t>(predict(num, Q12, al, true));
      }
      if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
        const int64_t num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                   DC17 - DC19);
        ws[17] = static_cast<int16_t>(predict(num, Q21, al, true));
      }
      if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
        const int64_t num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                   2 * DC18 - DC19);
        ws[24] = static_cast<int16_t>(predict(num, Q30, al, true));
      }
      const int64_t num = Q00 *
          (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
           6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
           8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
           8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
           6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
           2 * DC25);
      ws[0] = static_cast<int16_t>(predict(num, Q00, 0, false));
    }
    idct_islow(ws, c.q, base + x * 8, c.stride);
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 4; ++j) DC[i][j] = DC[i][j + 1];
  }
}

Error decode_progressive(const uint8_t* d, size_t n, Frame& f, uint8_t* out) {
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    c.coef.assign(static_cast<size_t>(c.pw) * c.ph * 64, 0);
    for (int& b : c.bits) b = -1;
  }
  for (;;) {
    size_t end = n;
    Error e = decode_scan(d, n, f, &end);
    if (e.status != kOk) return e;
    e = parse_from(d, n, end, &f);
    if (e.status != kOk) return e;
    if (f.eoi) break;
  }
  for (int i = 0; i < f.ncomp; ++i) {
    if (!f.comp[i].q_latched)
      return make_error(kMalformed, "a component is in no scan");
  }
  const bool smooth = smoothing_ok(f);
  const int total = f.ncomp == 1 ? f.comp[0].bh
                                 : (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
  auto fill = [&](int r) -> Error {
    for (int i = 0; i < f.ncomp; ++i) {
      Component& c = f.comp[i];
      uint8_t* base = c.buf[r % 3].data();
      for (int b = 0; b < c.v; ++b) {
        if (static_cast<int64_t>(r) * c.v + b >= c.bh) break;
        idct_row(c, r, b, total, smooth,
                 base + static_cast<size_t>(b) * 8 * c.stride);
      }
    }
    return make_error(kOk, "");
  };
  return run_rows(f, out, fill);
}

Error decode(const uint8_t* d, size_t n, uint8_t* out) {
  Frame* fp = new Frame();
  struct Guard {
    Frame* f;
    ~Guard() { delete f; }
  } guard{fp};
  Error e = parse(d, n, fp);
  if (e.status != kOk) return e;
  return fp->progressive ? decode_progressive(d, n, *fp, out)
                         : decode_baseline(d, n, *fp, out);
}

void put_msg(const Error& e, char* msg, int64_t msg_len) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", e.msg);
}

}  // namespace

// hwc: the image's height, width and components (1 or 3).  Returns 0, 1
// (a JPEG this decoder does not take; `msg` names its kind), 2 (not a
// valid JPEG; `msg` says why) or 3 (a JPEG cut short; `msg` says where).
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
