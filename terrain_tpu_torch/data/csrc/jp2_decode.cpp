// A JPEG 2000 decoder for terrain_tpu_torch/data/jp2.py, in host C++.
//
// It gives the array imageio.v3.imread gives for a JP2 file or a bare
// codestream: Pillow's Jpeg2KImagePlugin decodes it through openjpeg's
// tile-by-tile calls (opj_read_tile_header, opj_decode_tile_data, every
// layer, every resolution, strict mode) and unpacks each tile with its own
// rules.  This file follows both:
//   * containers: the JP2 boxes as openjpeg reads them (signature, ftyp,
//     jp2h with ihdr, colr, bpcc, cdef, res and unknown sub-boxes, then jp2c;
//     uuid, xml, jp2i, asoc and other boxes skipped), and as Pillow's
//     _parse_jp2_header reads them for the mode and size; a bare codestream
//     (SOC, SIZ) with Pillow's _parse_codestream mode;
//   * the codestream: SIZ, COD/COC, QCD/QCC, COM, TLM, PLM, PLT and CRG
//     (read and skipped), tile-parts in any order of tiles, and openjpeg's
//     marker-by-marker reading, so that a cut file gives openjpeg's verdict:
//     a cut right after a tile-part's SOT marker code decodes the tiles
//     completed before it (the rest stay zero), any other cut fails;
//   * tier 2: packet headers (tag trees, inclusion, zero bit-planes, pass
//     counts, Lblock, codeword segments of 109 passes), the five
//     progression orders as openjpeg's packet
//     iterator walks them (pi.c), and precinct and code-block partitions as
//     tcd.c computes them;
//   * tier 1: the MQ decoder (ISO 15444-1 Annex C) and EBCOT's significance,
//     refinement and cleanup passes, with openjpeg's values in half units, so
//     a code-block cut short by a quality layer is reconstructed at the
//     mid-point of its last decoded bit-plane;
//   * dequantisation: reversible (a halving), and scalar derived and
//     expounded steps in openjpeg's float arithmetic (the step of every band
//     computed without the band's gain, which openjpeg's 9/7 lifting makes up
//     for with 2/K in place of 1/K);
//   * the inverse wavelets: 5/3 integer lifting and 9/7 float lifting with
//     openjpeg 2.5's constants and step order (dwt.c's opj_v8dwt_decode,
//     element by element), rows then columns, at any origin parity;
//   * the inverse RCT and ICT (mct.c), the DC level shift, lrintf rounding
//     and the clamp (tcd.c), the tile buffer's component widths, then
//     Pillow's unpackers (Jpeg2KDecode.c): the shift to 8 or 16 bits with
//     its rounding offset, the signed offset, gray, gray+alpha, RGB and RGBA.
// Tiles are decoded on host threads, or, for fewer tiles than threads, the
// code-blocks, wavelet rows and column strips of each tile; the bits do not
// depend on the thread count.
//
// Refused by name (status 1), before any pixel is decoded: what no fixture
// of tests/data/jp2 holds -- POC, PPM/PPT, RGN, SOP/EPH, code-block styles other than
// 0 (HTJ2K included), subsampled components, palettes (pclr/cmap), sYCC,
// samples of more than 16 bits and Part-2 markers.  A damaged file, or one
// openjpeg or Pillow rejects, fails (status 2).
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <type_traits>
#include <vector>

#pragma GCC optimize("fp-contract=off")

namespace {

enum Status { kOk = 0, kUnsupported = 1, kMalformed = 2 };

struct Failure {
  int status;
  std::string msg;
};

[[noreturn]] void bad(const std::string& msg) { throw Failure{kMalformed, "JPEG 2000: " + msg}; }
[[noreturn]] void refuse(const std::string& msg) {
  throw Failure{kUnsupported, "JPEG 2000: " + msg};
}

inline uint32_t be16(const uint8_t* p) { return uint32_t(p[0]) << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}
inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }
inline int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) { a >>= 1; ++l; }
  return l;
}

// ------------------------------------------------------------ parameters --

constexpr int kMaxRes = 33;  // openjpeg's OPJ_J2K_MAXRLVLS

struct Siz {
  uint32_t x1 = 0, y1 = 0, x0 = 0, y0 = 0;     // Xsiz, Ysiz, XOsiz, YOsiz
  uint32_t tw = 0, th = 0, tx0 = 0, ty0 = 0;   // XTsiz, YTsiz, XTOsiz, YTOsiz
  int ncomp = 0;
  std::vector<int> prec;
  std::vector<bool> sgnd;
  uint32_t ntx = 0, nty = 0;
};

struct CompCoding {  // SPcod / SPcoc
  int levels = 0, cbw = 0, cbh = 0, cblksty = 0, qmf = 0;
  bool user_precincts = false;
  uint8_t ppx[kMaxRes], ppy[kMaxRes];
};

struct Quant {  // SQcd / SQcc
  int style = 0, guard = 0;
  int expn[3 * kMaxRes + 1], mant[3 * kMaxRes + 1];
};

struct Coding {
  int prog = 0, layers = 0, mct = 0;
  std::vector<CompCoding> cc;
  std::vector<Quant> q;
};

void read_spcod(const uint8_t* p, size_t n, CompCoding& c, bool user_precincts) {
  if (n < 5) bad("a COD/COC segment is cut short");
  c.levels = p[0];
  if (c.levels + 1 > kMaxRes) bad("too many decomposition levels");
  c.cbw = p[1] + 2;
  c.cbh = p[2] + 2;
  if (c.cbw > 10 || c.cbh > 10 || c.cbw + c.cbh > 12) bad("an invalid code-block size");
  c.cblksty = p[3];
  c.qmf = p[4];
  if (c.qmf > 1) bad("an unknown wavelet transform");
  if (c.cblksty & 0x40) refuse("HTJ2K code-blocks (style 0x40)");
  if (c.cblksty)
    refuse("code-block style " + std::to_string(c.cblksty) +
           " (bypass, resets, termination, causal or segmentation symbols)");
  c.user_precincts = user_precincts;
  if (user_precincts) {
    if (n < size_t(5 + c.levels + 1)) bad("a COD/COC segment is cut short");
    for (int r = 0; r <= c.levels; ++r) {
      const uint8_t v = p[5 + r];
      if (r && ((v & 15) == 0 || (v >> 4) == 0)) bad("an invalid precinct size");
      c.ppx[r] = v & 15;
      c.ppy[r] = v >> 4;
    }
  } else {
    for (int r = 0; r < kMaxRes; ++r) c.ppx[r] = c.ppy[r] = 15;
  }
}

void read_sqcd(const uint8_t* p, size_t n, Quant& q) {
  if (n < 1) bad("a QCD/QCC segment is cut short");
  q.style = p[0] & 31;
  q.guard = p[0] >> 5;
  ++p;
  --n;
  int count;
  if (q.style == 0) {
    count = int(std::min<size_t>(n, 3 * kMaxRes + 1));
    for (int i = 0; i < count; ++i) {
      q.expn[i] = p[i] >> 3;
      q.mant[i] = 0;
    }
  } else {  // 1 derived, 2 expounded (openjpeg reads any other style as 2)
    if (n < 2) bad("a QCD/QCC segment is cut short");
    count = q.style == 1 ? 1 : int(std::min<size_t>(n / 2, 3 * kMaxRes + 1));
    for (int i = 0; i < count; ++i) {
      const uint32_t v = be16(p + 2 * i);
      q.expn[i] = int(v >> 11);
      q.mant[i] = int(v & 0x7ff);
    }
  }
  if (q.style == 1) {  // derived: openjpeg's rule for the other bands
    for (int b = 1; b < 3 * kMaxRes + 1; ++b) {
      const int e = q.expn[0] - (b - 1) / 3;
      q.expn[b] = e > 0 ? e : 0;
      q.mant[b] = q.mant[0];
    }
  } else {
    for (int b = count; b < 3 * kMaxRes + 1; ++b) {
      q.expn[b] = 0;
      q.mant[b] = 0;
    }
  }
}

// Apply one COD/COC/QCD/QCC segment to a set of coding parameters.
void apply_marker(uint32_t m, const uint8_t* p, size_t n, Coding& cd, const Siz& siz) {
  const int nc = siz.ncomp;
  const int csz = nc <= 256 ? 1 : 2;
  if (m == 0xFF52) {  // COD
    if (n < 5) bad("a COD segment is cut short");
    const int scod = p[0];
    if (scod & 6) refuse("SOP/EPH packet markers (COD style " + std::to_string(scod) + ")");
    if (scod & ~7) bad("an unknown COD style");
    cd.prog = p[1];
    if (cd.prog > 4) bad("an unknown progression order");
    cd.layers = int(be16(p + 2));
    if (!cd.layers) bad("no quality layers");
    cd.mct = p[4];
    if (cd.mct > 1) refuse("a Part-2 multiple component transform");
    if (cd.mct && nc < 3) bad("a component transform with fewer than three components");
    CompCoding c;
    read_spcod(p + 5, n - 5, c, scod & 1);
    for (int i = 0; i < nc; ++i) cd.cc[i] = c;
  } else if (m == 0xFF53) {  // COC
    if (n < size_t(csz + 1)) bad("a COC segment is cut short");
    const int ci = csz == 1 ? p[0] : int(be16(p));
    if (ci >= nc) bad("a COC for a component that does not exist");
    const int scoc = p[csz];
    read_spcod(p + csz + 1, n - csz - 1, cd.cc[ci], scoc & 1);
  } else if (m == 0xFF5C) {  // QCD
    Quant q;
    read_sqcd(p, n, q);
    for (int i = 0; i < nc; ++i) cd.q[i] = q;
  } else if (m == 0xFF5D) {  // QCC
    if (n < size_t(csz)) bad("a QCC segment is cut short");
    const int ci = csz == 1 ? p[0] : int(be16(p));
    if (ci >= nc) bad("a QCC for a component that does not exist");
    read_sqcd(p + csz, n - csz, cd.q[ci]);
  }
}

// ------------------------------------------------------------- codestream --

// What openjpeg reads of a codestream before it decodes a pixel: the main
// header, then every tile-part in the order openjpeg's tile-by-tile reading
// meets them, with the order in which it hands complete tiles to the
// decoder (`order`) and, where the stream ends or breaks, its verdict.
struct Tile {
  Coding cd;
  std::vector<std::pair<const uint8_t*, size_t>> parts;
  int parts_read = 0, parts_total = 0;
  bool has_data = false;
};

struct Codestream {
  Siz siz;
  Coding main;
  std::vector<Tile> tiles;
  std::vector<int> order;
};

void check_main_marker(uint32_t m) {
  switch (m) {
    case 0xFF5F: refuse("POC progression changes");
    case 0xFF60: refuse("PPM packed packet headers");
    case 0xFF61: refuse("PPT packed packet headers");
    case 0xFF5E: refuse("RGN regions of interest");
    case 0xFF50: refuse("a CAP marker (HTJ2K)");
    case 0xFF59: refuse("a CPF marker");
    case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78:
      refuse("Part-2 component transform markers (MCT/MCC/MCO/CBD)");
    default: break;
  }
}

void read_siz(const uint8_t* p, size_t n, Siz& s) {
  if (n < 36) bad("the SIZ segment is cut short");
  s.x1 = be32(p + 2);
  s.y1 = be32(p + 6);
  s.x0 = be32(p + 10);
  s.y0 = be32(p + 14);
  s.tw = be32(p + 18);
  s.th = be32(p + 22);
  s.tx0 = be32(p + 26);
  s.ty0 = be32(p + 30);
  s.ncomp = int(be16(p + 34));
  if (!s.ncomp || s.ncomp > 16384) bad("a SIZ with " + std::to_string(s.ncomp) + " components");
  if (n < size_t(36 + 3 * s.ncomp)) bad("the SIZ segment is cut short");
  if (s.x0 >= s.x1 || s.y0 >= s.y1) bad("an empty image");
  if (!s.tw || !s.th) bad("an empty tile size");
  if (s.tx0 > s.x0 || s.ty0 > s.y0 || uint64_t(s.tx0) + s.tw <= s.x0 ||
      uint64_t(s.ty0) + s.th <= s.y0)
    bad("an illegal tile offset");
  for (int i = 0; i < s.ncomp; ++i) {
    const uint8_t* c = p + 36 + 3 * i;
    const int prec = (c[0] & 0x7f) + 1;
    if (!c[1] || !c[2]) bad("a component sampled by 0");
    if (c[1] != 1 || c[2] != 1)
      refuse("a subsampled component (XRsiz " + std::to_string(c[1]) + ", YRsiz " +
             std::to_string(c[2]) + ")");
    if (prec > 38) bad("a component of " + std::to_string(prec) + " bits");
    if (prec > 16) refuse("samples of " + std::to_string(prec) + " bits");
    s.prec.push_back(prec);
    s.sgnd.push_back(c[0] >> 7);
  }
  s.ntx = uint32_t(ceildiv(int64_t(s.x1) - s.tx0, s.tw));
  s.nty = uint32_t(ceildiv(int64_t(s.y1) - s.ty0, s.th));
  if (uint64_t(s.ntx) * s.nty > 65535) bad("more than 65535 tiles");
}

// The main header, up to and including the first SOT marker code; returns
// the offset after it.
size_t read_main_header(const uint8_t* d, size_t n, Codestream& cs) {
  if (n < 4 || be16(d) != 0xFF4F) bad("no SOC marker");
  if (be16(d + 2) != 0xFF51) bad("the SIZ marker does not follow SOC");
  size_t pos = 2;
  bool has_cod = false, has_qcd = false, has_siz = false;
  uint32_t m = be16(d + pos);
  pos += 2;
  while (m != 0xFF90) {
    if (m < 0xFF00) bad("a marker was expected");
    check_main_marker(m);
    if (pos + 2 > n) bad("the main header is cut short");
    const uint32_t len = be16(d + pos);
    if (len < 2) bad("an invalid marker size");
    if (pos + len > n) bad("the main header is cut short");
    const uint8_t* seg = d + pos + 2;
    const size_t sn = len - 2;
    if (m == 0xFF51) {
      if (has_siz) bad("a second SIZ marker");
      read_siz(seg, sn, cs.siz);
      cs.main.cc.assign(cs.siz.ncomp, CompCoding());
      cs.main.q.assign(cs.siz.ncomp, Quant());
      has_siz = true;
    } else if (m == 0xFF52 || m == 0xFF53 || m == 0xFF5C || m == 0xFF5D) {
      if (m == 0xFF53 && !has_cod) bad("a COC before the COD");
      if (m == 0xFF5D && !has_qcd) bad("a QCC before the QCD");
      apply_marker(m, seg, sn, cs.main, cs.siz);
      has_cod |= m == 0xFF52;
      has_qcd |= m == 0xFF5C;
    } else if (m == 0xFF64 || m == 0xFF55 || m == 0xFF57 || m == 0xFF63) {
      // COM, TLM, PLM, CRG: read and skipped
    } else if (m == 0xFF4F || m == 0xFF93 || m == 0xFFD9 || m == 0xFF58) {
      bad("a marker out of its place in the main header");
    } else {
      bad("an unknown marker in the main header");
    }
    pos += len;
    if (pos + 2 > n) bad("the main header is cut short");
    m = be16(d + pos);
    pos += 2;
  }
  if (!has_cod) bad("no COD marker in the main header");
  if (!has_qcd) bad("no QCD marker in the main header");
  return pos;
}

// openjpeg's tile-by-tile reading after the main header (j2k.c
// opj_j2k_read_tile_header, opj_j2k_read_sot, opj_j2k_read_sod and the end
// of opj_j2k_decode_tile), in strict mode: which tiles it hands out, and in
// what order; throws where it fails.
void read_tiles(const uint8_t* d, size_t n, size_t pos, Codestream& cs) {
  const Siz& s = cs.siz;
  const uint32_t ntiles = s.ntx * s.nty;
  cs.tiles.assign(ntiles, Tile());
  for (Tile& t : cs.tiles) t.cd = cs.main;
  enum { TPHSOT, TPH, NEOC, EOC } state = TPHSOT;
  uint32_t marker = 0xFF90;  // the main header read the first SOT's code
  uint32_t current = 0;
  auto left = [&]() { return n - pos; };
  for (;;) {
    // opj_j2k_read_tile_header
    if (state == EOC) {
      marker = 0xFFD9;
    } else if (state != TPHSOT) {
      bad("the codestream ends without an EOC marker");
    }
    bool can_decode = false;
    int64_t sot_length = 0;
    bool last_part = false;
    while (!can_decode && marker != 0xFFD9) {
      while (marker != 0xFF93) {
        if (left() == 0) {
          state = NEOC;
          break;
        }
        if (left() < 2) bad("the stream is cut short in a tile-part header");
        uint32_t size = be16(d + pos);
        pos += 2;
        if (size < 2) bad("an inconsistent marker size");
        if (marker == 0x8080 && left() == 0) {
          state = NEOC;
          break;
        }
        if (state == TPH && sot_length != 0) {
          if (sot_length < int64_t(size) + 2) bad("a tile-part header longer than its tile-part");
          sot_length -= size + 2;
        }
        const bool sot = marker == 0xFF90;
        if (sot ? state != TPHSOT : state != TPH) bad("a marker out of its place");
        if (left() < size - 2) bad("the stream is cut short in a tile-part header");
        const uint8_t* seg = d + pos;
        const size_t sn = size - 2;
        if (sot) {
          if (size != 10) bad("an SOT segment of the wrong size");
          const uint32_t isot = be16(seg), psot = be32(seg + 2);
          const int tpsot = seg[6], tnsot = seg[7];
          if (isot >= ntiles) bad("a tile index out of range");
          if (psot != 0 && psot < 14 && psot != 12) bad("an invalid Psot");
          Tile& t = cs.tiles[isot];
          if (t.parts_total && tpsot >= t.parts_total) bad("a tile-part index out of range");
          if (tpsot != t.parts_read) bad("tile-parts out of order");
          if (tnsot) {
            if (t.parts_total && tpsot >= t.parts_total) bad("a tile-part index out of range");
            t.parts_total = tnsot;
          }
          can_decode = t.parts_total && t.parts_total == tpsot + 1;
          last_part = psot == 0;
          sot_length = int64_t(psot) - 12;
          current = isot;
          state = TPH;
        } else {
          check_main_marker(marker);
          if (marker == 0xFF52 || marker == 0xFF53 || marker == 0xFF5C || marker == 0xFF5D) {
            apply_marker(marker, seg, sn, cs.tiles[current].cd, s);
          } else if (marker != 0xFF64 && marker != 0xFF58) {  // COM, PLT
            bad("a marker out of its place in a tile-part header");
          }
        }
        pos += sn;
        if (left() < 2) bad("the stream is cut short in a tile-part header");
        marker = be16(d + pos);
        pos += 2;
      }
      if (left() == 0 && state == NEOC) break;
      // opj_j2k_read_sod
      if (state != TPH) bad("an SOD marker out of its place");
      int64_t len;
      if (last_part) {
        len = int64_t(left()) - 2;
      } else {
        len = sot_length >= 2 ? sot_length - 2 : sot_length;
      }
      if (len < 0) len = 0;
      if (len > int64_t(left())) bad("a tile-part runs past the end of the stream");
      Tile& t = cs.tiles[current];
      t.parts.emplace_back(d + pos, size_t(len));
      t.parts_read += 1;
      t.has_data = true;
      pos += size_t(len);
      state = TPHSOT;
      if (!can_decode) {
        if (left() < 2) {
          // openjpeg's allowance for files whose last tiles have TNsot == 0
          // and no EOC
          bool spot6 = false;
          if (current + 1 == ntiles) {
            for (uint32_t i = 0; i < ntiles; ++i) {
              if (cs.tiles[i].parts_read == 1 && cs.tiles[i].parts_total == 0) {
                current = i;
                spot6 = true;
                break;
              }
            }
          }
          if (!spot6) bad("the stream is cut short after a tile-part");
          marker = 0xFFD9;
          state = EOC;
          break;
        }
        marker = be16(d + pos);
        pos += 2;
      }
    }
    if (marker == 0xFFD9 && state != EOC) {
      current = 0;
      state = EOC;
    }
    if (!can_decode) {
      while (current < ntiles && !cs.tiles[current].has_data) ++current;
      if (current == ntiles) return;
    }
    cs.order.push_back(int(current));
    cs.tiles[current].has_data = false;  // opj_j2k_decode_tile frees it
    // the end of opj_j2k_decode_tile
    if (state != EOC) {
      if (left() == 0) {
        state = NEOC;
      } else {
        if (left() < 2) bad("the stream is cut short after a tile");
        marker = be16(d + pos);
        pos += 2;
        if (marker == 0xFFD9) {
          current = 0;
          state = EOC;
        } else if (marker != 0xFF90) {
          // "Stream does not end with EOC": the next tile header fails
          if (left() != 0) bad("a tile is followed by neither SOT nor EOC");
          state = NEOC;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- tier 2 --

struct Bio {  // openjpeg's bio.c, for packet headers
  const uint8_t *start, *p, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* s, size_t n) : start(s), p(s), end(s + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (p < end) buf |= *p++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t bits(int k) {
    uint32_t v = 0;
    for (int i = k - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void align() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t used() const { return size_t(p - start); }
};

struct TagTree {  // tgt.c
  std::vector<int> value, low, parent;
  void init(int w, int h) {
    value.clear();
    low.clear();
    parent.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw{w}, lh{h};
    int nodes = w * h;
    while (lw.back() > 1 || lh.back() > 1) {
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
      nodes += lw.back() * lh.back();
    }
    value.assign(nodes, 999);
    low.assign(nodes, 0);
    parent.assign(nodes, -1);
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      const int next = base + lw[l] * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          parent[base + j * lw[l] + i] = next + (j / 2) * lw[l + 1] + i / 2;
      base = next;
    }
  }
  bool decode(Bio& bio, int leaf, int threshold) {
    int stack[32], sp = 0, node = leaf;
    while (parent[node] >= 0) {
      stack[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.bit()) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (!sp) break;
      node = stack[--sp];
    }
    return value[node] < threshold;
  }
};

// openjpeg's codeword segments: with code-block style 0 a segment holds at
// most 109 passes, and each starts the MQ decoder afresh on its own bytes.
constexpr int kSegPasses = 109;

struct Cblk {
  int x0, y0, x1, y1;
  std::vector<uint8_t> data;  // every segment's bytes, in order
  struct Seg {
    int passes, len;
  };
  std::vector<Seg> segs;
  std::vector<Seg> fresh;  // this packet's passes and bytes, segment by segment
  int numbps = 0, lenbits = 3;
};

struct Prec {
  int cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<Cblk> cblks;
};

struct Band {
  int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int mb;       // openjpeg's band->numbps
  float step;   // band->stepsize
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int nres;
  std::vector<Res> res;
  std::vector<int32_t> data;  // int32, or float bits under the 9/7
};

struct TileGeom {
  int64_t x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

void build_tile(const Codestream& cs, int tileno, const Coding& cd, TileGeom& t) {
  const Siz& s = cs.siz;
  const int p = int(tileno % s.ntx), q = int(tileno / s.ntx);
  t.x0 = std::max<int64_t>(int64_t(s.tx0) + int64_t(p) * s.tw, s.x0);
  t.y0 = std::max<int64_t>(int64_t(s.ty0) + int64_t(q) * s.th, s.y0);
  t.x1 = std::min<int64_t>(int64_t(s.tx0) + int64_t(p + 1) * s.tw, s.x1);
  t.y1 = std::min<int64_t>(int64_t(s.ty0) + int64_t(q + 1) * s.th, s.y1);
  t.comps.resize(s.ncomp);
  for (int c = 0; c < s.ncomp; ++c) {
    const CompCoding& cc = cd.cc[c];
    const Quant& qu = cd.q[c];
    TileComp& tc = t.comps[c];
    tc.x0 = t.x0;
    tc.y0 = t.y0;
    tc.x1 = t.x1;
    tc.y1 = t.y1;
    tc.nres = cc.levels + 1;
    tc.res.resize(tc.nres);
    for (int r = 0; r < tc.nres; ++r) {
      Res& re = tc.res[r];
      const int level = tc.nres - 1 - r;
      re.x0 = ceildivpow2(tc.x0, level);
      re.y0 = ceildivpow2(tc.y0, level);
      re.x1 = ceildivpow2(tc.x1, level);
      re.y1 = ceildivpow2(tc.y1, level);
      re.pdx = cc.ppx[r];
      re.pdy = cc.ppy[r];
      const int64_t px0 = floordivpow2(re.x0, re.pdx) << re.pdx;
      const int64_t py0 = floordivpow2(re.y0, re.pdy) << re.pdy;
      const int64_t px1 = ceildivpow2(re.x1, re.pdx) << re.pdx;
      const int64_t py1 = ceildivpow2(re.y1, re.pdy) << re.pdy;
      re.pw = re.x0 == re.x1 ? 0 : int((px1 - px0) >> re.pdx);
      re.ph = re.y0 == re.y1 ? 0 : int((py1 - py0) >> re.pdy);
      if (int64_t(re.pw) * re.ph > (1 << 24)) bad("too many precincts");
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0;
        cbgy0 = py0;
        cbgw = re.pdx;
        cbgh = re.pdy;
      } else {
        cbgx0 = ceildivpow2(px0, 1);
        cbgy0 = ceildivpow2(py0, 1);
        cbgw = re.pdx - 1;
        cbgh = re.pdy - 1;
      }
      const int cbw = std::min(cc.cbw, cbgw), cbh = std::min(cc.cbh, cbgh);
      const int nb = r == 0 ? 1 : 3;
      re.bands.resize(nb);
      for (int b = 0; b < nb; ++b) {
        Band& ba = re.bands[b];
        if (r == 0) {
          ba.bandno = 0;
          ba.x0 = ceildivpow2(tc.x0, level);
          ba.y0 = ceildivpow2(tc.y0, level);
          ba.x1 = ceildivpow2(tc.x1, level);
          ba.y1 = ceildivpow2(tc.y1, level);
        } else {
          ba.bandno = b + 1;
          const int64_t x0b = ba.bandno & 1, y0b = ba.bandno >> 1;
          ba.x0 = ceildivpow2(tc.x0 - (x0b << level), level + 1);
          ba.y0 = ceildivpow2(tc.y0 - (y0b << level), level + 1);
          ba.x1 = ceildivpow2(tc.x1 - (x0b << level), level + 1);
          ba.y1 = ceildivpow2(tc.y1 - (y0b << level), level + 1);
        }
        const int si = r == 0 ? 0 : 3 * (r - 1) + ba.bandno;
        const int expn = qu.expn[si], mant = qu.mant[si];
        // tcd.c: no gain for the 9/7 (see BUG_WEIRD_TWO_INVK in dwt.c)
        const int gain = cc.qmf == 0 ? 0 : (ba.bandno == 0 ? 0 : ba.bandno == 3 ? 2 : 1);
        const int rb = s.prec[c] + gain;
        ba.step = float((1.0 + mant / 2048.0) * std::pow(2.0, double(rb - expn)));
        ba.mb = expn + qu.guard - 1;
        ba.precs.resize(size_t(re.pw) * re.ph);
        for (int pi = 0; pi < re.pw * re.ph; ++pi) {
          Prec& pr = ba.precs[pi];
          const int64_t gx0 = cbgx0 + int64_t(pi % re.pw) * (int64_t(1) << cbgw);
          const int64_t gy0 = cbgy0 + int64_t(pi / re.pw) * (int64_t(1) << cbgh);
          const int64_t gx1 = gx0 + (int64_t(1) << cbgw), gy1 = gy0 + (int64_t(1) << cbgh);
          const int64_t prx0 = std::max(gx0, ba.x0), pry0 = std::max(gy0, ba.y0);
          const int64_t prx1 = std::min(gx1, ba.x1), pry1 = std::min(gy1, ba.y1);
          const int64_t tx = floordivpow2(prx0, cbw) << cbw, ty = floordivpow2(pry0, cbh) << cbh;
          const int64_t bx = ceildivpow2(prx1, cbw) << cbw, by = ceildivpow2(pry1, cbh) << cbh;
          pr.cw = int(std::max<int64_t>(0, (bx - tx) >> cbw));
          pr.ch = int(std::max<int64_t>(0, (by - ty) >> cbh));
          if (int64_t(pr.cw) * pr.ch > (1 << 22)) bad("too many code-blocks");
          pr.incl.init(pr.cw, pr.ch);
          pr.imsb.init(pr.cw, pr.ch);
          pr.cblks.resize(size_t(pr.cw) * pr.ch);
          for (int k = 0; k < pr.cw * pr.ch; ++k) {
            Cblk& cb = pr.cblks[k];
            const int64_t cx = tx + int64_t(k % pr.cw) * (int64_t(1) << cbw);
            const int64_t cy = ty + int64_t(k / pr.cw) * (int64_t(1) << cbh);
            cb.x0 = int(std::max(cx, prx0));
            cb.y0 = int(std::max(cy, pry0));
            cb.x1 = int(std::min(cx + (int64_t(1) << cbw), prx1));
            cb.y1 = int(std::min(cy + (int64_t(1) << cbh), pry1));
          }
        }
      }
    }
  }
}

int numpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.bits(2);
  if (n != 3) return int(3 + n);
  n = bio.bits(5);
  if (n != 31) return int(6 + n);
  return int(37 + bio.bits(7));
}

// One packet: its header and its code-block contributions; returns the
// bytes it took.
size_t read_packet(TileComp& tc, int resno, int precno, int layno, const uint8_t* d, size_t n) {
  Res& re = tc.res[resno];
  Bio bio(d, n);
  if (!bio.bit()) {
    bio.align();
    return bio.used();
  }
  for (Band& ba : re.bands) {
    if (ba.empty()) continue;
    Prec& pr = ba.precs[precno];
    for (int k = 0; k < pr.cw * pr.ch; ++k) {
      Cblk& cb = pr.cblks[k];
      bool included;
      if (cb.segs.empty()) included = pr.incl.decode(bio, k, layno + 1);
      else included = bio.bit();
      if (!included) continue;
      if (cb.segs.empty()) {
        int i = 0;  // ends by 1000: a tag tree's values start at 999
        while (!pr.imsb.decode(bio, k, i)) ++i;
        cb.numbps = ba.mb + 1 - i;
        cb.lenbits = 3;
      }
      int n = numpasses(bio);
      while (bio.bit()) ++cb.lenbits;
      // a segment per kSegPasses passes, each with its length
      int room = cb.segs.empty() ? kSegPasses : kSegPasses - cb.segs.back().passes;
      if (!room) room = kSegPasses;
      while (n > 0) {
        const int np = std::min(room, n);
        const int bits = cb.lenbits + floorlog2(uint32_t(np));
        if (bits > 32) bad("an invalid code-block length");
        const int len = int(bio.bits(bits));
        if (len < 0) bad("an invalid code-block length");
        cb.fresh.push_back({np, len});
        n -= np;
        room = kSegPasses;
      }
    }
  }
  bio.align();
  size_t used = bio.used();
  for (Band& ba : re.bands) {
    if (ba.empty()) continue;
    Prec& pr = ba.precs[precno];
    for (Cblk& cb : pr.cblks) {
      for (size_t i = 0; i < cb.fresh.size(); ++i) {
        const Cblk::Seg& f = cb.fresh[i];
        if (size_t(f.len) > n - used) bad("a code-block runs past its tile");
        cb.data.insert(cb.data.end(), d + used, d + used + f.len);
        used += size_t(f.len);
        if (cb.segs.empty() || (i == 0 && cb.segs.back().passes == kSegPasses) || i > 0)
          cb.segs.push_back({0, 0});
        cb.segs.back().passes += f.passes;
        cb.segs.back().len += f.len;
      }
      cb.fresh.clear();
    }
  }
  return used;
}

// The packets of a tile in its progression order (pi.c), each read once.
void read_packets(TileGeom& t, const Coding& cd, const uint8_t* d, size_t n) {
  const int nc = int(t.comps.size());
  int maxres = 0;
  int64_t maxprec = 0;
  for (const TileComp& tc : t.comps) {
    maxres = std::max(maxres, tc.nres);
    for (const Res& re : tc.res) maxprec = std::max<int64_t>(maxprec, int64_t(re.pw) * re.ph);
  }
  const int64_t step_p = 1, step_c = maxprec, step_r = step_c * nc, step_l = step_r * maxres;
  std::vector<uint8_t> include(size_t(step_l * cd.layers), 0);
  size_t pos = 0;
  auto packet = [&](int l, int r, int c, int64_t p) {
    const int64_t idx = l * step_l + r * step_r + c * step_c + p * step_p;
    if (include[size_t(idx)]) return;
    include[size_t(idx)] = 1;
    pos += read_packet(t.comps[c], r, int(p), l, d + pos, n - pos);
  };
  const int L = cd.layers;
  if (cd.prog == 0 || cd.prog == 1) {  // LRCP, RLCP
    for (int a = 0; a < (cd.prog == 0 ? L : maxres); ++a)
      for (int b = 0; b < (cd.prog == 0 ? maxres : L); ++b) {
        const int l = cd.prog == 0 ? a : b, r = cd.prog == 0 ? b : a;
        for (int c = 0; c < nc; ++c) {
          const TileComp& tc = t.comps[c];
          if (r >= tc.nres) continue;
          const Res& re = tc.res[r];
          for (int64_t p = 0; p < int64_t(re.pw) * re.ph; ++p) packet(l, r, c, p);
        }
      }
    return;
  }
  // position-driven orders: RPCL, PCRL, CPRL
  auto steps = [&](int c0, int c1, uint64_t& dx, uint64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      const TileComp& tc = t.comps[c];
      for (int r = 0; r < tc.nres; ++r) {
        const int sx = tc.res[r].pdx + tc.nres - 1 - r, sy = tc.res[r].pdy + tc.nres - 1 - r;
        if (sx < 32) dx = dx ? std::min<uint64_t>(dx, uint64_t(1) << sx) : uint64_t(1) << sx;
        if (sy < 32) dy = dy ? std::min<uint64_t>(dy, uint64_t(1) << sy) : uint64_t(1) << sy;
      }
    }
    if (!dx || !dy) bad("an empty packet iteration");
  };
  const uint64_t tx0 = uint64_t(t.x0), ty0 = uint64_t(t.y0), tx1 = uint64_t(t.x1),
                 ty1 = uint64_t(t.y1);
  // the precinct of (c, r) the iterator stands on at (x, y), or -1
  auto precinct_at = [&](int c, int r, uint64_t x, uint64_t y) -> int64_t {
    const TileComp& tc = t.comps[c];
    if (r >= tc.nres) return -1;
    const Res& re = tc.res[r];
    const int level = tc.nres - 1 - r;
    if (level >= 32) return -1;
    const uint64_t trx0 = uint64_t(ceildiv(int64_t(tx0), int64_t(1) << level));
    const uint64_t try0 = uint64_t(ceildiv(int64_t(ty0), int64_t(1) << level));
    const uint64_t trx1 = uint64_t(ceildiv(int64_t(tx1), int64_t(1) << level));
    const uint64_t try1 = uint64_t(ceildiv(int64_t(ty1), int64_t(1) << level));
    const int rpx = re.pdx + level, rpy = re.pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!(y % (uint64_t(1) << rpy) == 0 || (y == ty0 && ((try0 << level) % (uint64_t(1) << rpy)))))
      return -1;
    if (!(x % (uint64_t(1) << rpx) == 0 || (x == tx0 && ((trx0 << level) % (uint64_t(1) << rpx)))))
      return -1;
    if (re.pw == 0 || re.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    const int64_t prci = int64_t(ceildiv(int64_t(x), int64_t(1) << level) >> re.pdx) -
                         int64_t(trx0 >> re.pdx);
    const int64_t prcj = int64_t(ceildiv(int64_t(y), int64_t(1) << level) >> re.pdy) -
                         int64_t(try0 >> re.pdy);
    return prci + prcj * re.pw;
  };
  auto next = [](uint64_t v, uint64_t step) { return v + (step - v % step); };
  if (cd.prog == 2) {  // RPCL
    uint64_t dx, dy;
    steps(0, nc, dx, dy);
    for (int r = 0; r < maxres; ++r)
      for (uint64_t y = ty0; y < ty1; y = next(y, dy))
        for (uint64_t x = tx0; x < tx1; x = next(x, dx))
          for (int c = 0; c < nc; ++c) {
            const int64_t p = precinct_at(c, r, x, y);
            if (p < 0) continue;
            for (int l = 0; l < L; ++l) packet(l, r, c, p);
          }
  } else if (cd.prog == 3) {  // PCRL
    uint64_t dx, dy;
    steps(0, nc, dx, dy);
    for (uint64_t y = ty0; y < ty1; y = next(y, dy))
      for (uint64_t x = tx0; x < tx1; x = next(x, dx))
        for (int c = 0; c < nc; ++c)
          for (int r = 0; r < t.comps[c].nres; ++r) {
            const int64_t p = precinct_at(c, r, x, y);
            if (p < 0) continue;
            for (int l = 0; l < L; ++l) packet(l, r, c, p);
          }
  } else {  // CPRL
    for (int c = 0; c < nc; ++c) {
      uint64_t dx, dy;
      steps(c, c + 1, dx, dy);
      for (uint64_t y = ty0; y < ty1; y = next(y, dy))
        for (uint64_t x = tx0; x < tx1; x = next(x, dx))
          for (int r = 0; r < t.comps[c].nres; ++r) {
            const int64_t p = precinct_at(c, r, x, y);
            if (p < 0) continue;
            for (int l = 0; l < L; ++l) packet(l, r, c, p);
          }
    }
  }
}

// ----------------------------------------------------------------- tier 1 --

struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const QeEntry kQe[47] = {
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
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 magnitude, 17 run, 18 uniform
enum { kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19 };

// The 94 states of openjpeg's table: Qe index and MPS, with the states an
// MPS or an LPS leads to (the switch folded in).
struct MqState {
  uint32_t qe;
  int mps;
  const MqState *nmps, *nlps;
};

MqState kStates[94];

// The MQ decoder's registers (ISO 15444-1 C.3, as openjpeg's mqc.c decodes);
// a pass copies them into locals so that they stay in registers.
struct Mq {
  const uint8_t* bp;  // the current byte; the data ends in 0xFF 0xFF
  uint32_t a, c;
  int ct;
  void bytein() {
    if (bp[0] == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(bp[0]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(bp[0]) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data) {
    bp = data;
    c = uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  inline __attribute__((always_inline)) int decode(const MqState** cxp) {
    const MqState* st = *cxp;
    const uint32_t qe = st->qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {  // LPS exchange
      if (a < qe) {
        d = st->mps;
        *cxp = st->nmps;
      } else {
        d = 1 - st->mps;
        *cxp = st->nlps;
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < qe) {
          d = 1 - st->mps;
          *cxp = st->nlps;
        } else {
          d = st->mps;
          *cxp = st->nmps;
        }
        renorm();
      } else {
        d = st->mps;
      }
    }
    return d;
  }
};

// Each sample's flags: which of its eight neighbours are significant, the
// signs of the four direct ones, and its own state; a sample that becomes
// significant sets its bits in its neighbours' flags, so every context is
// read from one flag word.
enum : uint16_t {
  NB_NW = 1, NB_N = 2, NB_NE = 4, NB_W = 8, NB_E = 16, NB_SW = 32, NB_S = 64, NB_SE = 128,
  NEG_N = 256, NEG_S = 512, NEG_W = 1024, NEG_E = 2048,
  SIG = 4096, VIS = 8192, REF = 16384,
};

// zero-coding context by band orientation and the eight neighbour bits
uint8_t kZc[4][256];
// sign context and its xor bit by the direct neighbours' significance and
// signs (N, S, W, E significant, then N, S, W, E negative)
uint8_t kScCtx[256], kScXor[256];

void init_tables() {
  for (int i = 0; i < 47; ++i)
    for (int m = 0; m < 2; ++m) {
      MqState& st = kStates[2 * i + m];
      st.qe = kQe[i].qe;
      st.mps = m;
      st.nmps = &kStates[2 * kQe[i].nmps + m];
      st.nlps = &kStates[2 * kQe[i].nlps + (kQe[i].sw ? 1 - m : m)];
    }
  for (int o = 0; o < 4; ++o)
    for (int nb = 0; nb < 256; ++nb) {
      int h = !!(nb & NB_W) + !!(nb & NB_E), v = !!(nb & NB_N) + !!(nb & NB_S);
      const int d = !!(nb & NB_NW) + !!(nb & NB_NE) + !!(nb & NB_SW) + !!(nb & NB_SE);
      int ctx;
      if (o == 1) std::swap(h, v);  // HL: the table of LL and LH transposed
      if (o == 3) {
        const int hv = h + v;
        if (d >= 3) ctx = 8;
        else if (d == 2) ctx = hv >= 1 ? 7 : 6;
        else if (d == 1) ctx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        else ctx = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
      } else {
        if (h == 2) ctx = 8;
        else if (h == 1) ctx = v >= 1 ? 7 : d >= 1 ? 6 : 5;
        else if (v == 2) ctx = 4;
        else if (v == 1) ctx = 3;
        else ctx = d >= 2 ? 2 : d == 1 ? 1 : 0;
      }
      kZc[o][nb] = uint8_t(ctx);
    }
  // by the clamped sums H (rows: -1, 0, 1) and V (columns: -1, 0, 1)
  const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
  const int x[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
  for (int k = 0; k < 256; ++k) {
    auto c = [&](int sig, int neg) { return (k >> sig & 1) ? ((k >> neg & 1) ? -1 : 1) : 0; };
    auto clamp = [](int v) { return v < -1 ? -1 : v > 1 ? 1 : v; };
    const int hh = clamp(c(2, 6) + c(3, 7)) + 1, vv = clamp(c(0, 4) + c(1, 5)) + 1;
    kScCtx[k] = uint8_t(ctx[hh][vv]);
    kScXor[k] = uint8_t(x[hh][vv]);
  }
}

struct T1 {
  int w = 0, h = 0, W = 0;
  std::vector<uint16_t> fl;  // (w + 2) x (h + 2), a border never coded
  std::vector<int32_t> v;    // w x h, values in openjpeg's half units
  std::vector<uint8_t> data;
  Mq mq;
  const MqState* ctx[kNumCtx];
  const uint8_t* zc = nullptr;

  static int sc_index(uint16_t f) {
    return ((f & NB_N) >> 1) | ((f & NB_S) >> 5) | ((f & NB_W) >> 1) | ((f & NB_E) >> 1) |
           ((f >> 4) & 0xf0);
  }
  void become_sig(Mq& m, uint16_t* f, int32_t* val, int oph) {
    const int k = sc_index(*f);
    const int s = m.decode(&ctx[kScCtx[k]]) ^ kScXor[k];
    *val = s ? -oph : oph;
    *f |= SIG;
    const int W_ = W;
    f[-W_ - 1] |= NB_SE;
    f[-W_] |= uint16_t(NB_S | (s ? NEG_S : 0));
    f[-W_ + 1] |= NB_SW;
    f[-1] |= uint16_t(NB_E | (s ? NEG_E : 0));
    f[1] |= uint16_t(NB_W | (s ? NEG_W : 0));
    f[W_ - 1] |= NB_NE;
    f[W_] |= uint16_t(NB_N | (s ? NEG_N : 0));
    f[W_ + 1] |= NB_NW;
  }
  void sig_pass(int bp) {
    const int one = 1 << (bp + 1), oph = one | (one >> 1);
    Mq m = mq;
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int x = 0; x < w; ++x) {
        uint16_t* col = &fl[size_t(y0 + 1) * W + x + 1];
        if (y1 - y0 == 4 && !((col[0] | col[W] | col[2 * W] | col[3 * W]) & 0xff)) continue;
        for (int y = y0; y < y1; ++y) {
          uint16_t* f = &col[size_t(y - y0) * W];
          if ((*f & (SIG | VIS)) || !(*f & 0xff)) continue;
          if (m.decode(&ctx[zc[*f & 0xff]])) become_sig(m, f, &v[size_t(y) * w + x], oph);
          *f |= VIS;
        }
      }
    }
    mq = m;
  }
  void ref_pass(int bp) {
    const int half = 1 << bp;
    Mq m = mq;
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int x = 0; x < w; ++x) {
        uint16_t* col = &fl[size_t(y0 + 1) * W + x + 1];
        if (y1 - y0 == 4 && !((col[0] | col[W] | col[2 * W] | col[3 * W]) & SIG)) continue;
        for (int y = y0; y < y1; ++y) {
          uint16_t* f = &col[size_t(y - y0) * W];
          if ((*f & (SIG | VIS)) != SIG) continue;
          const int cx = (*f & REF) ? kCtxMag + 2 : (*f & 0xff) ? kCtxMag + 1 : kCtxMag;
          const int b = m.decode(&ctx[cx]);
          int32_t& d = v[size_t(y) * w + x];
          d += (b ^ (d < 0)) ? half : -half;
          *f |= REF;
        }
      }
    }
    mq = m;
  }
  void cleanup_pass(int bp) {
    const int one = 1 << (bp + 1), oph = one | (one >> 1);
    Mq m = mq;
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int y1 = std::min(y0 + 4, h);
      for (int x = 0; x < w; ++x) {
        uint16_t* col = &fl[size_t(y0 + 1) * W + x + 1];
        int y = y0;
        if (y0 + 4 <= h && !((col[0] | col[W] | col[2 * W] | col[3 * W]) &
                             (SIG | VIS | 0xff))) {
          if (!m.decode(&ctx[kCtxAgg])) continue;
          int r = m.decode(&ctx[kCtxUni]) << 1;
          r |= m.decode(&ctx[kCtxUni]);
          y = y0 + r;
          become_sig(m, &col[size_t(r) * W], &v[size_t(y) * w + x], oph);
          ++y;
        }
        for (; y < y1; ++y) {
          uint16_t* f = &col[size_t(y - y0) * W];
          if (!(*f & (SIG | VIS)) && m.decode(&ctx[zc[*f & 0xff]]))
            become_sig(m, f, &v[size_t(y) * w + x], oph);
        }
        for (int k = 0; k < y1 - y0; ++k) col[size_t(k) * W] &= uint16_t(~VIS);
      }
    }
    mq = m;
  }
  // Decode a code-block's passes into v (w x h).
  void decode(const Cblk& cb, int band_orient) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    W = w + 2;
    zc = kZc[band_orient];
    fl.assign(size_t(W) * (h + 2), 0);
    v.assign(size_t(w) * h, 0);
    if (cb.numbps >= 31) bad("a code-block of 31 or more bit-planes");
    // more zero bit-planes than the band has: openjpeg's unsigned count
    // wraps to a negative plane, and nothing is decoded
    if (cb.numbps <= 0) return;
    for (int i = 0; i < kNumCtx; ++i) ctx[i] = &kStates[0];
    ctx[kCtxUni] = &kStates[2 * 46];
    ctx[kCtxAgg] = &kStates[2 * 3];
    ctx[0] = &kStates[2 * 4];
    int bp = cb.numbps - 1, type = 2;
    size_t at = 0;
    for (const Cblk::Seg& sg : cb.segs) {  // the contexts carry over
      // the segment's bytes, then the 0xFF 0xFF openjpeg puts after them
      data.assign(cb.data.begin() + at, cb.data.begin() + at + sg.len);
      at += size_t(sg.len);
      data.push_back(0xff);
      data.push_back(0xff);
      mq.init(data.data());
      for (int p = 0; p < sg.passes && bp >= 0; ++p) {
        if (type == 0) sig_pass(bp);
        else if (type == 1) ref_pass(bp);
        else cleanup_pass(bp);
        if (++type == 3) {
          type = 0;
          --bp;
        }
      }
    }
  }
};

// --------------------------------------------------------------- wavelets --

// The 5/3's integer lifting (ISO 15444-1 F.3.8.1) on n interleaved samples
// whose first sits at parity `cas` (L samples at cas, cas + 2, ...), with
// whole-sample symmetric extension; n >= 2.  lo(t, l, r): X[t] -= (X[l] +
// X[r] + 2) >> 2 on an L sample; hi(t, l, r): X[t] += (X[l] + X[r]) >> 1.
template <class Lo, class Hi>
void lift53(int n, int cas, Lo lo, Hi hi) {
  auto nb = [n](int p, int& l, int& r) {
    l = p ? p - 1 : p + 1;
    r = p + 1 < n ? p + 1 : p - 1;
  };
  int l, r;
  for (int t = cas; t < n; t += 2) {
    nb(t, l, r);
    lo(t, l, r);
  }
  for (int t = 1 - cas; t < n; t += 2) {
    nb(t, l, r);
    hi(t, l, r);
  }
}

const float kAlpha = 1.586134342f, kBeta = 0.052980118f, kGamma = -0.882911075f,
            kDelta = -0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

// openjpeg 2.5's 9/7 lifting (dwt.c opj_v8dwt_decode, one lane of it) on
// sn L and dn H interleaved samples, the first at parity `cas`: the L
// samples times K and the H ones times 2/K (openjpeg's BUG_WEIRD_TWO_INVK,
// which its band steps make up for), then four steps; a step's sample t
// becomes X[t] + (X[l] + X[r]) * c, a mirrored edge taking one neighbour
// twice (openjpeg's (c + c) * X gives the same bits).  mul(t, c): X[t] *=
// c; add(t, l, r, c) the step.  A line of one sample is left as it is.
template <class Mul, class Add>
void lift97(int sn, int dn, int cas, Mul mul, Add add) {
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const int a = cas, b = 1 - cas;
  for (int i = 0; i < sn; ++i) mul(a + 2 * i, kK);
  for (int i = 0; i < dn; ++i) mul(b + 2 * i, kTwoInvK);
  auto step = [&](int first, int end, int m, float c) {
    const int imax = std::min(end, m);
    for (int i = 0; i < imax; ++i) {
      const int t = first + 2 * i;
      add(t, t ? t - 1 : t + 1, t + 1, c);
    }
    if (m < end) {
      const int t = first + 2 * m;
      add(t, t - 1, t - 1, c);
    }
  };
  step(a, sn, std::min(sn, dn - a), kDelta);
  step(b, dn, std::min(dn, sn - b), kGamma);
  step(a, sn, std::min(sn, dn - a), kBeta);
  step(b, dn, std::min(dn, sn - b), kAlpha);
}

// One line (a row: L samples then H samples) inverse transformed in place.
void idwt53_line(int32_t* x, int sn, int n, int cas, int32_t* tmp) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  for (int i = 0; i < sn; ++i) tmp[2 * i + cas] = x[i];
  for (int i = 0; i < n - sn; ++i) tmp[2 * i + 1 - cas] = x[sn + i];
  lift53(n, cas, [&](int t, int l, int r) { tmp[t] -= (tmp[l] + tmp[r] + 2) >> 2; },
         [&](int t, int l, int r) { tmp[t] += (tmp[l] + tmp[r]) >> 1; });
  std::memcpy(x, tmp, sizeof(int32_t) * size_t(n));
}

void idwt97_line(float* x, int sn, int n, int cas, float* tmp) {
  for (int i = 0; i < sn; ++i) tmp[2 * i + cas] = x[i];
  for (int i = 0; i < n - sn; ++i) tmp[2 * i + 1 - cas] = x[sn + i];
  lift97(sn, n - sn, cas, [&](int t, float c) { tmp[t] = tmp[t] * c; },
         [&](int t, int l, int r, float c) { tmp[t] = tmp[t] + (tmp[l] + tmp[r]) * c; });
  std::memcpy(x, tmp, sizeof(float) * size_t(n));
}

// Columns [x0, x1) of rows 0..n-1 (L rows then H rows, `stride` apart)
// inverse transformed in place: the strip's rows interleaved into tmp, then
// each lifting step applied to whole rows of the strip (the same arithmetic
// per sample as a column at a time, in cache).
template <class T>
void idwt_columns(T* data, int64_t stride, int sn, int n, int cas, int x0, int x1,
                  std::vector<T>& tmp) {
  const int cw = x1 - x0;
  if (n == 1) {
    if (cas && std::is_integral<T>::value)
      for (int j = 0; j < cw; ++j) data[x0 + j] /= 2;
    return;
  }
  tmp.resize(size_t(n) * cw);
  auto row = [&](int p) { return &tmp[size_t(p) * cw]; };
  for (int i = 0; i < sn; ++i)
    std::memcpy(row(2 * i + cas), data + i * stride + x0, sizeof(T) * size_t(cw));
  for (int i = 0; i < n - sn; ++i)
    std::memcpy(row(2 * i + 1 - cas), data + (sn + i) * stride + x0, sizeof(T) * size_t(cw));
  if constexpr (std::is_integral<T>::value) {
    lift53(n, cas,
           [&](int t, int l, int r) {
             T *xt = row(t), *xl = row(l), *xr = row(r);
             for (int j = 0; j < cw; ++j) xt[j] -= (xl[j] + xr[j] + 2) >> 2;
           },
           [&](int t, int l, int r) {
             T *xt = row(t), *xl = row(l), *xr = row(r);
             for (int j = 0; j < cw; ++j) xt[j] += (xl[j] + xr[j]) >> 1;
           });
  } else {
    lift97(sn, n - sn, cas,
           [&](int t, float c) {
             T* xt = row(t);
             for (int j = 0; j < cw; ++j) xt[j] = xt[j] * c;
           },
           [&](int t, int l, int r, float c) {
             T *xt = row(t), *xl = row(l), *xr = row(r);
             for (int j = 0; j < cw; ++j) xt[j] = xt[j] + (xl[j] + xr[j]) * c;
           });
  }
  for (int p = 0; p < n; ++p)
    std::memcpy(data + p * stride + x0, row(p), sizeof(T) * size_t(cw));
}

template <class F>
void parallel_for(int n, int threads, F fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  Failure err{kOk, ""};
  std::atomic<bool> failed{false};
  auto work = [&]() {
    try {
      for (int i; (i = next.fetch_add(1)) < n && !failed.load();) fn(i);
    } catch (const Failure& e) {
      if (!failed.exchange(true)) err = e;
    } catch (const std::bad_alloc&) {
      if (!failed.exchange(true)) err = Failure{kMalformed, "JPEG 2000: out of memory"};
    }
  };
  const int k = std::min(threads, n);
  for (int t = 1; t < k; ++t) pool.emplace_back(work);
  work();
  for (std::thread& t : pool) t.join();
  if (failed) throw err;
}

void inverse_dwt(TileComp& tc, bool reversible, int threads) {
  const int64_t W = tc.x1 - tc.x0;
  for (int r = 1; r < tc.nres; ++r) {
    const Res& lo = tc.res[r - 1];
    const Res& re = tc.res[r];
    const int rw = int(re.x1 - re.x0), rh = int(re.y1 - re.y0);
    const int snh = int(lo.x1 - lo.x0), snv = int(lo.y1 - lo.y0);
    const int cash = int(re.x0 & 1), casv = int(re.y0 & 1);
    const int chunk = 64;
    parallel_for((rh + chunk - 1) / chunk, threads, [&](int k) {
      std::vector<int32_t> tmp(size_t(rw) + 2);
      for (int y = k * chunk; y < std::min(rh, (k + 1) * chunk); ++y) {
        int32_t* row = &tc.data[size_t(y) * W];
        if (reversible) idwt53_line(row, snh, rw, cash, tmp.data());
        else idwt97_line(reinterpret_cast<float*>(row), snh, rw, cash,
                         reinterpret_cast<float*>(tmp.data()));
      }
    });
    parallel_for((rw + chunk - 1) / chunk, threads, [&](int k) {
      const int x0 = k * chunk, x1 = std::min(rw, x0 + chunk);
      if (reversible) {
        std::vector<int32_t> tmp;
        idwt_columns(tc.data.data(), W, snv, rh, casv, x0, x1, tmp);
      } else {
        std::vector<float> tmp;
        idwt_columns(reinterpret_cast<float*>(tc.data.data()), W, snv, rh, casv, x0, x1, tmp);
      }
    });
  }
}

// ----------------------------------------------------------- Pillow's view --

enum Mode { kL, kI16, kLA, kRGB, kRGBA, kCMYK };
enum ColorSpace { kUnknown = -1, kUnspecified = 0, kSRGB = 1, kGray = 2, kSYCC = 3, kEYCC = 4,
                  kCMYKSpace = 5 };

struct Image {
  Codestream cs;
  const uint8_t* code = nullptr;  // the codestream
  size_t code_len = 0;
  Mode mode = kL;
  int64_t width = 0, height = 0;  // Pillow's size
  int color = kUnspecified;
  int channels = 0, itemsize = 1;  // of imageio's array; 0 channels: 2-D
};

// Pillow's unpacker for (mode, colour space, components), as Jpeg2KDecode.c
// picks it; 0 gray_l, 1 gray_i, 2 gray_rgb, 3 graya_la, 4 srgb_rgb,
// 5 srgba_rgba; -1 none.
int unpacker(const Image& im) {
  int cs = im.color;
  const int nc = im.cs.siz.ncomp;
  if (cs == kUnspecified || cs == kUnknown) cs = nc <= 2 ? kGray : kSRGB;
  if (cs == kSYCC) refuse("sYCC colour (colr enumerated space 18)");
  struct Row { Mode m; int cs, nc, fn; };
  static const Row rows[] = {
      {kL, kGray, 1, 0},    {kI16, kGray, 1, 1},   {kLA, kGray, 2, 3},
      {kRGB, kGray, 1, 2},  {kRGB, kGray, 2, 2},   {kRGB, kSRGB, 3, 4},
      {kRGB, kSRGB, 4, 4},  {kRGBA, kGray, 1, 2},  {kRGBA, kGray, 2, 3},
      {kRGBA, kSRGB, 3, 4}, {kRGBA, kSRGB, 4, 5},  {kCMYK, kCMYKSpace, 4, 5},
  };
  for (const Row& r : rows)
    if (r.m == im.mode && r.cs == cs && r.nc == nc) return r.fn;
  return -1;
}

void check_pillow(Image& im) {
  const Siz& s = im.cs.siz;
  if (s.ncomp < 1 || s.ncomp > 4) bad("Pillow decodes one to four components");
  if (im.width != int64_t(s.x1) - s.x0 || im.height != int64_t(s.y1) - s.y0)
    bad("the ihdr box and the SIZ marker disagree on the size");
  if (unpacker(im) < 0) bad("no Pillow unpacker for this mode, colour space and component count");
  switch (im.mode) {
    case kL: im.channels = 0; im.itemsize = 1; break;
    case kI16: im.channels = 0; im.itemsize = 2; break;
    case kLA: im.channels = 2; im.itemsize = 1; break;
    case kRGB: im.channels = 3; im.itemsize = 1; break;
    case kRGBA: case kCMYK: im.channels = 4; im.itemsize = 1; break;
  }
}

// Pillow's _parse_codestream: the mode from SIZ's component count.
void pillow_codestream_mode(const uint8_t* d, size_t n, Image& im) {
  if (n < 6) bad("the SIZ segment is cut short");
  const uint32_t lsiz = be16(d + 4);
  if (n < 4 + size_t(lsiz) || lsiz < 38) bad("the SIZ segment is cut short");
  const uint8_t* siz = d + 4;
  const int64_t xsiz = be32(siz + 4), ysiz = be32(siz + 8), xo = be32(siz + 12),
                yo = be32(siz + 16);
  const uint32_t csiz = be16(siz + 36);
  im.width = xsiz - xo;
  im.height = ysiz - yo;
  if (csiz == 1) {
    if (lsiz < 39) bad("the SIZ segment is cut short");
    im.mode = (siz[38] & 0x7f) + 1 > 8 ? kI16 : kL;
  } else if (csiz == 2) {
    im.mode = kLA;
  } else if (csiz == 3) {
    im.mode = kRGB;
  } else if (csiz == 4) {
    im.mode = kRGBA;
  } else {
    bad("Pillow cannot tell the mode of " + std::to_string(csiz) + " components");
  }
}

constexpr uint32_t tag(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 |
         uint32_t(uint8_t(s[2])) << 8 | uint8_t(s[3]);
}

struct Box {
  uint32_t type;
  const uint8_t* body;
  uint64_t len;   // of the body; an undefined length reaches the end
  uint64_t size;  // with the header
};

// The box at d[pos, n): a length of 1 takes the 64-bit one that follows, 0
// the rest of the data.  A jp2c box may claim more than there is: openjpeg
// reads its codestream to the end of the stream.
Box box_at(const uint8_t* d, size_t n, size_t pos) {
  if (n - pos < 8) bad("a box header is cut short");
  uint64_t size = be32(d + pos);
  size_t hdr = 8;
  if (size == 1) {
    if (n - pos < 16) bad("a box header is cut short");
    size = uint64_t(be32(d + pos + 8)) << 32 | be32(d + pos + 12);
    hdr = 16;
  } else if (size == 0) {
    size = n - pos;
  }
  const uint32_t type = be32(d + pos + 4);
  if (size < hdr || (size > n - pos && type != tag("jp2c")))
    bad("a box runs past its container");
  return Box{type, d + pos + hdr, size - hdr, size};
}

// The JP2 boxes as openjpeg (jp2.c) reads them -- signature, ftyp, jp2h
// (an ihdr, the first colr; pclr/cmap refused), then jp2c, other boxes
// skipped -- and as Pillow's _parse_jp2_header reads the first jp2h for the
// size and mode (a box of undefined length before it fails there).
void read_jp2(const uint8_t* d, size_t n, Image& im) {
  enum { NONE = 0, SIGNATURE = 1, FILE_TYPE = 2, HEADER = 4 };
  int state = NONE, enumcs = 0, nc = 0;
  bool have_colr = false, have_mode = false, have_cdef = false;
  for (size_t pos = 0;; ) {
    if (pos == n) bad("no jp2c box");
    const Box b = box_at(d, n, pos);
    if (b.type == tag("jp2c")) {
      if (!(state & HEADER)) bad("a codestream before the jp2h box");
      im.code = b.body;
      im.code_len = n - size_t(b.body - d);
      break;
    }
    if (!be32(d + pos) && !(state & HEADER)) bad("a box of undefined length");
    if (b.type == tag("jP  ")) {
      if (state != NONE) bad("the signature box is not first");
      if (b.len != 4 || be32(b.body) != 0x0d0a870a) bad("a bad signature box");
      state |= SIGNATURE;
    } else if (b.type == tag("ftyp")) {
      if (state != SIGNATURE) bad("the ftyp box is not second");
      if (b.len < 8 || (b.len & 3)) bad("a bad ftyp box");
      state |= FILE_TYPE;
    } else if (b.type == tag("jp2h")) {
      if ((state & FILE_TYPE) != FILE_TYPE) bad("a jp2h box before ftyp");
      const bool first = !(state & HEADER);
      bool have_ihdr = false;
      for (size_t p = 0; p < b.len;) {
        const Box s = box_at(b.body, size_t(b.len), p);
        if (!be32(b.body + p)) bad("a jp2h sub-box of undefined length");
        if (s.type == tag("ihdr")) {
          if (s.len != 14) bad("a bad ihdr box");
          const uint32_t comps = be16(s.body + 8);
          if (!be32(s.body) || !be32(s.body + 4) || !comps) bad("an empty ihdr box");
          if (comps - 1u >= 16384u) bad("too many components in ihdr");
          if (first) {  // Pillow: the mode by the count and the bits
            im.height = be32(s.body);
            im.width = be32(s.body + 4);
            nc = int(comps);
            const int bpc = s.body[10];
            have_mode = nc <= 4;
            im.mode = nc == 1 ? ((bpc & 0x7f) > 8 ? kI16 : kL)
                    : nc == 2 ? kLA : nc == 3 ? kRGB : kRGBA;
          }
          have_ihdr = true;
        } else if (s.type == tag("colr")) {
          if (s.len < 3 || (s.body[0] == 1 && s.len < 7)) bad("a bad colr box");
          if (first && nc == 4 && s.body[0] == 1 && be32(s.body + 3) == 12) im.mode = kCMYK;
          if (!have_colr && s.body[0] <= 2) {  // openjpeg keeps the first (of
            // method 1 or 2); an ICC profile's space is unknown
            enumcs = s.body[0] == 1 ? int(be32(s.body + 3)) : 0;
            have_colr = true;
          }
        } else if (s.type == tag("cdef")) {  // openjpeg reads one, whole
          if (s.len < 2 || !be16(s.body) || s.len < 2 + 6 * uint64_t(be16(s.body)) || have_cdef)
            bad("a bad cdef box");
          have_cdef = true;
        } else if (s.type == tag("bpcc")) {
          if (s.len != uint64_t(nc)) bad("a bad bpcc box");
        } else if (s.type == tag("pclr") || s.type == tag("cmap")) {
          refuse("a palette (pclr/cmap)");
        }
        p += size_t(s.size);
      }
      if (!have_ihdr) bad("no ihdr box in jp2h");
      state |= HEADER;
    }
    pos += size_t(b.size);
  }
  if (!have_mode) bad("a malformed JP2 header");
  im.color = !have_colr ? kUnknown
           : enumcs == 16 ? kSRGB
           : enumcs == 17 ? kGray
           : enumcs == 18 ? kSYCC
           : enumcs == 24 ? kEYCC
           : enumcs == 12 ? kCMYKSpace : kUnknown;
}

void read_image(const uint8_t* d, size_t n, Image& im, bool tiles) {
  static const uint8_t sig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ', 13, 10, 0x87, 10};
  if (n >= 4 && be32(d) == 0xFF4FFF51) {
    pillow_codestream_mode(d, n, im);
    im.code = d;
    im.code_len = n;
    im.color = kUnspecified;
  } else if (n >= 12 && !std::memcmp(d, sig, 12)) {
    read_jp2(d, n, im);
  } else {
    bad("not a JP2 file or a codestream");
  }
  const size_t pos = read_main_header(im.code, im.code_len, im.cs);
  check_pillow(im);
  if (tiles) read_tiles(im.code, im.code_len, pos, im.cs);
}

// Decode one tile and unpack it into `out` (Pillow's image of imageio's
// array), as opj_decode_tile_data and Pillow's unpacker do.
// A thread's tile buffers, kept from tile to tile: fresh ones of a few MB
// each would be mapped and unmapped by the allocator for every tile, and
// threads faulting and unmapping pages at once wait on each other.
struct Workspace {
  std::vector<std::vector<int32_t>> comps;
  std::vector<uint32_t> words;
};

Workspace& workspace() {
  thread_local Workspace ws;
  return ws;
}

void decode_tile(const Image& im, int tileno, uint8_t* out, int threads) {
  const Codestream& cs = im.cs;
  const Siz& s = cs.siz;
  const Tile& tile = cs.tiles[tileno];
  const Coding& cd = tile.cd;
  Workspace& ws = workspace();
  TileGeom t;
  build_tile(cs, tileno, cd, t);
  if (ws.comps.size() < t.comps.size()) ws.comps.resize(t.comps.size());
  for (size_t c = 0; c < t.comps.size(); ++c) t.comps[c].data.swap(ws.comps[c]);
  struct GiveBack {  // the buffers go back to the workspace, however we leave
    TileGeom& t;
    Workspace& ws;
    ~GiveBack() {
      for (size_t c = 0; c < t.comps.size(); ++c) t.comps[c].data.swap(ws.comps[c]);
    }
  } give_back{t, ws};
  std::vector<uint8_t> joined;
  const uint8_t* data;
  size_t len;
  if (tile.parts.size() == 1) {
    data = tile.parts[0].first;
    len = tile.parts[0].second;
  } else {
    for (const auto& p : tile.parts) joined.insert(joined.end(), p.first, p.first + p.second);
    data = joined.data();
    len = joined.size();
  }
  read_packets(t, cd, data, len);
  const int nc = s.ncomp;
  const int64_t tw = t.x1 - t.x0, th = t.y1 - t.y0;
  // tier 1 and dequantisation, code-block by code-block
  struct Job { int c, r, b, p, k; };
  std::vector<Job> jobs;
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = t.comps[c];
    tc.data.assign(size_t(tw * th), 0);
    for (int r = 0; r < tc.nres; ++r)
      for (int b = 0; b < int(tc.res[r].bands.size()); ++b) {
        const Band& ba = tc.res[r].bands[b];
        for (int p = 0; p < int(ba.precs.size()); ++p)
          for (int k = 0; k < int(ba.precs[p].cblks.size()); ++k) {
            const Cblk& cb = ba.precs[p].cblks[k];
            if (!cb.segs.empty() && cb.x1 > cb.x0 && cb.y1 > cb.y0) jobs.push_back({c, r, b, p, k});
          }
      }
  }
  parallel_for(int(jobs.size()), threads, [&](int j) {
    thread_local T1 t1;
    const Job& jb = jobs[j];
    TileComp& tc = t.comps[jb.c];
    const Res& re = tc.res[jb.r];
    const Band& ba = re.bands[jb.b];
    const Cblk& cb = ba.precs[jb.p].cblks[jb.k];
    t1.decode(cb, ba.bandno);
    int64_t x = cb.x0 - ba.x0, y = cb.y0 - ba.y0;
    if (ba.bandno & 1) x += tc.res[jb.r - 1].x1 - tc.res[jb.r - 1].x0;
    if (ba.bandno & 2) y += tc.res[jb.r - 1].y1 - tc.res[jb.r - 1].y0;
    const bool reversible = cd.cc[jb.c].qmf == 1;
    const float step = 0.5f * ba.step;
    for (int yy = 0; yy < t1.h; ++yy) {
      int32_t* dst = &tc.data[size_t(y + yy) * tw + x];
      const int32_t* src = &t1.v[size_t(yy) * t1.w];
      if (reversible) {
        for (int xx = 0; xx < t1.w; ++xx) dst[xx] = src[xx] / 2;
      } else {
        float* f = reinterpret_cast<float*>(dst);
        for (int xx = 0; xx < t1.w; ++xx) f[xx] = float(src[xx]) * step;
      }
    }
  });
  for (int c = 0; c < nc; ++c) inverse_dwt(t.comps[c], cd.cc[c].qmf == 1, threads);
  const size_t npx = size_t(tw * th);
  if (cd.mct) {
    if (cd.cc[0].qmf == 1) {
      int32_t *c0 = t.comps[0].data.data(), *c1 = t.comps[1].data.data(),
              *c2 = t.comps[2].data.data();
      for (size_t i = 0; i < npx; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      float* c0 = reinterpret_cast<float*>(t.comps[0].data.data());
      float* c1 = reinterpret_cast<float*>(t.comps[1].data.data());
      float* c2 = reinterpret_cast<float*>(t.comps[2].data.data());
      for (size_t i = 0; i < npx; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + (v * 1.402f);
        const float g = y - (u * 0.34413f) - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // DC level shift and clamp (tcd.c), then the tile buffer's widths
  std::vector<uint32_t>& words = ws.words;
  words.resize(npx * nc);
  for (int c = 0; c < nc; ++c) {
    const int prec = s.prec[c];
    const bool sg = s.sgnd[c];
    const int32_t lo = sg ? -(1 << (prec - 1)) : 0;
    const int32_t hi = sg ? (1 << (prec - 1)) - 1 : int32_t((1u << prec) - 1);
    const int32_t shift = sg ? 0 : 1 << (prec - 1);
    const int csiz = (prec + 7) >> 3 == 3 ? 4 : (prec + 7) >> 3;
    const uint32_t mask = csiz == 1 ? 0xffu : csiz == 2 ? 0xffffu : 0xffffffffu;
    int32_t* src = t.comps[c].data.data();
    uint32_t* dst = &words[size_t(c) * npx];
    for (size_t i = 0; i < npx; ++i) {
      int64_t v;
      if (cd.cc[c].qmf == 1) {
        v = int64_t(src[i]) + shift;
      } else {
        const float f = reinterpret_cast<const float*>(src)[i];
        if (f > float(INT32_MAX)) v = hi;
        else if (f < float(INT32_MIN)) v = lo;
        else v = int64_t(std::lrintf(f)) + shift;
      }
      v = v < lo ? lo : v > hi ? hi : v;
      dst[i] = uint32_t(v) & mask;
    }
  }
  // Pillow's unpack (Jpeg2KDecode.c j2ku_*), at the tile's place
  const int64_t x0 = t.x0 - s.x0, y0 = t.y0 - s.y0;
  if (x0 < 0 || y0 < 0 || x0 + tw > im.width || y0 + th > im.height)
    bad("a tile outside Pillow's image");
  auto shifted = [&](int c, uint32_t word, int bits) -> uint32_t {
    const int prec = s.prec[c];
    const int sh = bits - prec;
    uint32_t off = s.sgnd[c] ? 1u << (prec - 1) : 0;
    if (sh < 0) off += 1u << (-sh - 1);
    const uint32_t x = off + word;
    return sh < 0 ? x >> -sh : x << sh;
  };
  const int fn = unpacker(im);
  const int ch = std::max(im.channels, 1);
  for (int64_t yy = 0; yy < th; ++yy)
    for (int64_t xx = 0; xx < tw; ++xx) {
      const size_t i = size_t(yy * tw + xx);
      const size_t o = size_t((y0 + yy) * im.width + x0 + xx) * ch;
      auto w = [&](int c) { return words[size_t(c) * npx + i]; };
      switch (fn) {
        case 0: out[o] = uint8_t(shifted(0, w(0), 8)); break;
        case 1: reinterpret_cast<uint16_t*>(out)[o] = uint16_t(shifted(0, w(0), 16)); break;
        case 2: {
          const uint8_t g = uint8_t(shifted(0, w(0), 8));
          for (int k = 0; k < std::min(ch, 3); ++k) out[o + k] = g;
          if (ch == 4) out[o + 3] = 0xff;
          break;
        }
        case 3: {
          const uint8_t g = uint8_t(shifted(0, w(0), 8)), a = uint8_t(shifted(1, w(1), 8));
          if (ch == 2) {
            out[o] = g;
            out[o + 1] = a;
          } else {
            out[o] = out[o + 1] = out[o + 2] = g;
            if (ch == 4) out[o + 3] = a;
          }
          break;
        }
        case 4:
          for (int k = 0; k < 3; ++k) out[o + k] = uint8_t(shifted(k, w(k), 8));
          if (ch == 4) out[o + 3] = 0xff;
          break;
        default:
          for (int k = 0; k < 4; ++k) out[o + k] = uint8_t(shifted(k, w(k), 8));
          break;
      }
    }
}

void decode(const uint8_t* d, size_t n, uint8_t* out, int threads) {
  struct Release {  // the calling thread's buffers are not kept after the call
    ~Release() { workspace() = Workspace(); }
  } release;
  Image im;
  read_image(d, n, im, true);
  const std::vector<int>& order = im.cs.order;
  std::memset(out, 0, size_t(im.width * im.height) * std::max(im.channels, 1) * im.itemsize);
  if (int(order.size()) >= threads) {
    parallel_for(int(order.size()), threads, [&](int i) { decode_tile(im, order[i], out, 1); });
  } else {
    for (int t : order) decode_tile(im, t, out, threads);
  }
}

int finish(const Failure& e, char* msg, int64_t len) {
  if (len > 0) std::snprintf(msg, static_cast<size_t>(len), "%s", e.msg.c_str());
  return e.status;
}

struct Tables {
  Tables() { init_tables(); }
} tables;

}  // namespace

// info: height, width, channels (0 for a 2-D array), bytes per sample (1 or
// 2) of imageio's array.  Reads the container and the main header only.
// Returns 0, 1 for a kind the decoder refuses, 2 for a damaged file or one
// imageio fails on, with a message in msg.
extern "C" int jp2_header(const uint8_t* data, int64_t n, int64_t* info, char* msg,
                          int64_t msg_len) {
  try {
    Image im;
    read_image(data, static_cast<size_t>(n), im, false);
    info[0] = im.height;
    info[1] = im.width;
    info[2] = im.channels;
    info[3] = im.itemsize;
    return kOk;
  } catch (const Failure& e) {
    return finish(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return finish(Failure{kMalformed, "JPEG 2000: out of memory"}, msg, msg_len);
  }
}

// out: imageio's array (jp2_header's shape), row-major.  Every tile-part
// header is read before any pixel is decoded.  Returns as jp2_header.
extern "C" int jp2_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t threads,
                          char* msg, int64_t msg_len) {
  try {
    decode(data, static_cast<size_t>(n), out, int(std::max<int64_t>(1, threads)));
    return kOk;
  } catch (const Failure& e) {
    return finish(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return finish(Failure{kMalformed, "JPEG 2000: out of memory"}, msg, msg_len);
  }
}
