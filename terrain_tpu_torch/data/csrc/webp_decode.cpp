// A WebP decoder for terrain_tpu_torch/data/webp.py, in host C++.
//
// It gives the bytes that libwebp gives through Pillow's WebPAnimDecoder
// (the route imageio.v3.imread takes for a WebP, in MODE_RGBA, straight
// alpha), following libwebp's C code:
//   * the RIFF container: a simple file (one VP8 or VP8L chunk) or an
//     extended one (VP8X of 10 bytes and no reserved flag, then
//     ICCP/EXIF/XMP/unknown chunks skipped, an optional ALPH chunk right
//     before a VP8 chunk); the canvas must be the
//     frame's size; an ALPH chunk counts only where VP8X sets the alpha flag
//     (libwebp's demuxer drops it otherwise), and the output has four
//     channels where WebPGetFeatures reports alpha (the VP8X flag or an ALPH
//     chunk for VP8, the header's alpha bit for VP8L), else three;
//   * VP8L (lossless, vp8l_dec.c): prefix codes (simple and normal code
//     lengths, complete codes only, a one-symbol code read with no bits),
//     meta prefix codes, LZ77 with the 120-entry distance map, the colour
//     cache, and the four transforms (predictor with its 14 modes -- 14 and
//     15 predict black, as libwebp's table pads them --, cross-colour,
//     subtract-green, colour indexing with pixel bundling);
//   * VP8 (lossy, vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c, dsp/dec.c):
//     libwebp's boolean decoder (a partition read past its end fails) with
//     its seven-byte loads, segments and quantizer deltas, coefficient
//     probability updates, tokens with the 16-bit wrap of libwebp's int16
//     coefficients, i16/i4/chroma intra prediction on unfiltered neighbours
//     (127 above the frame, 129 left of it, the top-right four pixels of a
//     row's last macroblock repeating the pixel above its last column),
//     an odd chunk's pad byte readable by the last partition as libwebp's
//     demuxer hands it over,
//     the WHT and the integer DCT (each block through the routine libwebp
//     picks for it, the full one as its SSE2 code computes it), and the
//     simple and normal loop filters with sharpness and the ref/mode
//     deltas, over every macroblock, after the whole frame is predicted;
//   * the "fancy" 4:2:0 upsampler (dsp/upsampling.c: 9-3-3-1 weights, the
//     first and last rows and an odd last column) and VP8YUVToR/G/B's
//     14-bit fixed point (dsp/yuv.h);
//   * ALPH (alpha_dec.c): raw or VP8L-coded (an image stream without its
//     header, the green channel), and the horizontal, vertical and gradient
//     unfilters (dsp/filters.c).
// The constant tables are the VP8 and VP8L formats' own (RFC 6386, RFC
// 9649).  An animation (VP8X's animation flag, ANIM, ANMF frames) gives
// WebPAnimDecoder's first frame: a zeroed canvas of VP8X's size with the
// frame decoded into its rectangle, RGBA under VP8X's alpha flag, else RGB
// (a frame's ALPH chunk always counts; every frame's chunks and bounds are
// checked as the demuxer checks them).  A damaged or truncated file fails,
// as do layouts libwebp's demuxer rejects (two ALPH chunks, a chunk between
// ALPH and the image, ALPH with VP8L, ANMF before ANIM, a frame outside
// the canvas).
//
// Built at first use with the host C++ compiler into terrain_tpu_torch/_build/
// (ops/kernels/_build.py build_host) and called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kMalformed = 2 };

struct Failure {
  int status;
  std::string msg;
};

[[noreturn]] void bad(const std::string& msg) { throw Failure{kMalformed, msg}; }

const uint8_t kZigzag[16] = {
    0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15,
};

const uint8_t kBands[17] = {
    0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0,
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const int8_t kYModesIntra4[18] = {
    0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCat3[] = {
    173, 148, 140, 0,
};

const uint8_t kCat4[] = {
    176, 155, 140, 135, 0,
};

const uint8_t kCat5[] = {
    180, 157, 141, 134, 130, 0,
};

const uint8_t kCat6[] = {
    254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kCodeLengthCodeOrder[19] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
};

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }

// ---------------------------------------------------------------- VP8L --

// Bits least significant first; past the end it reads zeros and counts
// them, and a stream that used any of them is truncated.
struct LReader {
  const uint8_t* p = nullptr;
  uint64_t n = 0, pos = 0, val = 0;
  int nb = 0;
  LReader(const uint8_t* data, uint64_t size) : p(data), n(size) {}
  void fill() {
    while (nb <= 56) {
      const uint64_t b = pos < n ? p[pos] : 0;
      ++pos;
      val |= b << nb;
      nb += 8;
    }
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    if (nb < k) fill();
    const uint32_t v = static_cast<uint32_t>(val & ((uint64_t(1) << k) - 1));
    val >>= k;
    nb -= k;
    return v;
  }
  bool eos() const { return 8 * pos - nb > 8 * n; }
  void check() const {
    if (eos()) bad("VP8L: the stream is truncated");
  }
};

// One canonical prefix code, read most significant code bit first.
struct Code {
  int single = -1;        // the symbol of a one-symbol code (no bits)
  uint32_t fast[256];     // (length << 16) | symbol for codes of <= 8 bits
  uint16_t count[16];
  std::vector<uint16_t> sorted;
};

void build_code(const int* lengths, int size, Code* c) {
  std::memset(c->count, 0, sizeof(c->count));
  int used = 0, last = 0;
  for (int s = 0; s < size; ++s) {
    if (lengths[s]) {
      ++c->count[lengths[s]];
      ++used;
      last = s;
    }
  }
  if (used == 0) bad("VP8L: a prefix code without symbols");
  c->single = -1;
  if (used == 1) {
    c->single = last;
    return;
  }
  int64_t left = 1;  // Kraft: every code must be complete
  for (int len = 1; len < 16; ++len) {
    left = 2 * left - c->count[len];
    if (left < 0) bad("VP8L: an over-subscribed prefix code");
  }
  if (left != 0) bad("VP8L: an incomplete prefix code");
  int offset[17];
  offset[1] = 0;
  for (int len = 1; len < 16; ++len) offset[len + 1] = offset[len] + c->count[len];
  c->sorted.assign(used, 0);
  for (int s = 0; s < size; ++s)
    if (lengths[s]) c->sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  std::memset(c->fast, 0, sizeof(c->fast));
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len < 16; ++len) {
    for (int i = 0; i < c->count[len]; ++i, ++k, ++code) {
      if (len > 8) continue;
      uint32_t rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (uint32_t idx = rev; idx < 256; idx += 1u << len)
        c->fast[idx] = (uint32_t(len) << 16) | c->sorted[k];
    }
    code <<= 1;
  }
}

inline int read_symbol(const Code& c, LReader& br) {
  if (c.single >= 0) return c.single;
  if (br.nb < 16) br.fill();
  const uint32_t e = c.fast[br.val & 255];
  if (e) {
    br.val >>= e >> 16;
    br.nb -= e >> 16;
    return e & 0xffff;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= br.read(1);
    const int cnt = c.count[len];
    if (code - first < cnt) return c.sorted[index + code - first];
    index += cnt;
    first = (first + cnt) << 1;
    code <<= 1;
  }
  bad("VP8L: an invalid prefix code");
}

const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

void read_code(LReader& br, int alphabet, Code* out) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int num = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
    Code cl;
    build_code(cl_lengths, 19, &cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) bad("VP8L: a code-length count too large");
    }
    int prev = 8, symbol = 0;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = read_symbol(cl, br);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        const int slot = len - 16;
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int repeat = br.read(kExtra[slot]) + kOffset[slot];
        if (symbol + repeat > alphabet) bad("VP8L: a code-length run too long");
        const int value = slot == 0 ? prev : 0;
        for (int r = 0; r < repeat; ++r) lengths[symbol++] = value;
      }
      br.check();
    }
  }
  br.check();
  build_code(lengths.data(), alphabet, out);
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) - int((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

// The predictor of mode m for the pixel at out[x], whose row above is up.
inline uint32_t predict(int m, const uint32_t* out, const uint32_t* up, int x) {
  const uint32_t L = out[x - 1], T = up[x], TR = up[x + 1], TL = up[x - 1];
  switch (m) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return add_sub_full(L, T, TL);
    case 13: return add_sub_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp pads them
  }
}

inline int color_delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

struct Transform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

struct Group {
  Code codes[5];
};

void decode_stream(LReader& br, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>* out);

// The LZ77-coded pixels of one stream, with its prefix codes read first.
void decode_pixels(LReader& br, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>* out) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) bad("VP8L: a colour cache of the wrong size");
  }
  int meta_bits = 0, meta_xsize = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = br.read(3) + 2;
    meta_xsize = subsample(xsize, meta_bits);
    decode_stream(br, meta_xsize, subsample(ysize, meta_bits), false, &meta);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if (int(m) + 1 > num_groups) num_groups = m + 1;
    }
  }
  br.check();
  std::vector<Group> groups(num_groups);
  for (Group& g : groups) {
    for (int j = 0; j < 5; ++j)
      read_code(br, kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0),
                &g.codes[j]);
  }
  const int64_t total = int64_t(xsize) * ysize;
  out->assign(total, 0);
  uint32_t* data = out->data();
  std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
  const int cache_shift = 32 - cache_bits;
  int64_t cached = 0, pos = 0;
  int x = 0, y = 0;
  const int mask = meta_bits ? (1 << meta_bits) - 1 : -1;
  const Group* g = &groups[meta_bits ? meta[0] : 0];
  auto group_at = [&](int gx, int gy) {
    return &groups[meta_bits ? meta[(gy >> meta_bits) * meta_xsize + (gx >> meta_bits)] : 0];
  };
  auto insert = [&]() {
    if (cache_bits)
      for (; cached < pos; ++cached)
        cache[(data[cached] * 0x1e35a7bdu) >> cache_shift] = data[cached];
  };
  while (pos < total) {
    if ((x & mask) == 0) g = group_at(x, y);
    const int code = read_symbol(g->codes[0], br);
    if (code < 256) {
      const uint32_t red = read_symbol(g->codes[1], br);
      const uint32_t blue = read_symbol(g->codes[2], br);
      const uint32_t alpha = read_symbol(g->codes[3], br);
      br.check();
      data[pos++] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
      if (++x >= xsize) {
        x = 0;
        ++y;
        insert();
      }
    } else if (code < 256 + 24) {
      auto prefix = [&](int sym) {
        if (sym < 4) return sym + 1;
        const int extra = (sym - 2) >> 1;
        const int offset = (2 + (sym & 1)) << extra;
        return offset + int(br.read(extra)) + 1;
      };
      const int length = prefix(code - 256);
      const int dist_code = prefix(read_symbol(g->codes[4], br));
      int64_t dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int d = kCodeToPlane[dist_code - 1];
        dist = int64_t(d >> 4) * xsize + (8 - (d & 15));
        if (dist < 1) dist = 1;
      }
      br.check();
      if (pos < dist || total - pos < length) bad("VP8L: a backward reference leaves the image");
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      x += length;
      while (x >= xsize) {
        x -= xsize;
        ++y;
      }
      if (x & mask) g = group_at(x, y);
      insert();
    } else {
      const int key = code - 256 - 24;
      if (key >= int(cache.size())) bad("VP8L: a colour-cache symbol without a cache");
      insert();
      br.check();
      data[pos++] = cache[key];
      if (++x >= xsize) {
        x = 0;
        ++y;
        insert();
      }
    }
  }
  br.check();
}

// Undo one transform: in (t.xsize or its packed width) x ysize -> out.
void inverse(const Transform& t, int width, int ysize, const std::vector<uint32_t>& in,
             std::vector<uint32_t>* out) {
  const int w = t.xsize;
  if (t.type == 3) {  // colour indexing, pixels bundled
    out->assign(int64_t(w) * ysize, 0);
    const int per_byte_bits = 8 >> t.bits;  // bits per index
    const int per = 1 << t.bits;            // indices per packed pixel
    const uint32_t imask = (1u << per_byte_bits) - 1;
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = &in[int64_t(y) * width];
      uint32_t* dst = &(*out)[int64_t(y) * w];
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & imask];
        packed >>= per_byte_bits;
      }
    }
    return;
  }
  *out = in;
  uint32_t* px = out->data();
  const int64_t n = int64_t(w) * ysize;
  if (t.type == 2) {  // subtract green
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t green = (px[i] >> 8) & 0xff;
      const uint32_t rb = ((px[i] & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
      px[i] = (px[i] & 0xff00ff00u) | rb;
    }
    return;
  }
  const int tiles = subsample(w, t.bits);
  if (t.type == 1) {  // cross colour
    for (int y = 0; y < ysize; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                     r2b = int8_t((m >> 16) & 0xff);
        uint32_t& argb = px[int64_t(y) * w + x];
        const int8_t green = int8_t(argb >> 8);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + color_delta(g2r, green)) & 0xff;
        blue += color_delta(g2b, green);
        blue = (blue + color_delta(r2b, int8_t(red))) & 0xff;
        argb = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
      }
    }
    return;
  }
  // predictor: the first row from the left (the first pixel from black),
  // the first column from above, the rest by each tile's mode
  px[0] = add_pixels(px[0], 0xff000000u);
  for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
  for (int y = 1; y < ysize; ++y) {
    uint32_t* row = px + int64_t(y) * w;
    const uint32_t* up = row - w;
    row[0] = add_pixels(row[0], up[0]);
    const uint32_t* modes = &t.data[(y >> t.bits) * tiles];
    for (int x = 1; x < w; ++x) {
      const int m = (modes[x >> t.bits] >> 8) & 15;
      row[x] = add_pixels(row[x], predict(m, row, up, x));
    }
  }
}

// One image stream: the transforms (level 0 only), then the pixels, then
// the transforms undone in reverse order.
void decode_stream(LReader& br, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>* out) {
  std::vector<Transform> transforms;
  int width = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = br.read(2);
      if (seen & (1u << t.type)) bad("VP8L: a transform given twice");
      seen |= 1u << t.type;
      t.xsize = width;
      if (t.type == 0 || t.type == 1) {
        t.bits = br.read(3) + 2;
        decode_stream(br, subsample(width, t.bits), subsample(ysize, t.bits), false,
                      &t.data);
      } else if (t.type == 3) {
        const int num = br.read(8) + 1;
        t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
        std::vector<uint32_t> pal;
        decode_stream(br, num, 1, false, &pal);
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        t.data[0] = pal[0];
        for (int i = 1; i < num; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
        width = subsample(width, t.bits);
      }
      br.check();
      transforms.push_back(std::move(t));
    }
  }
  decode_pixels(br, width, ysize, level0, out);
  std::vector<uint32_t> tmp;
  for (int i = int(transforms.size()) - 1; i >= 0; --i) {
    const Transform& t = transforms[i];
    inverse(t, width, ysize, *out, &tmp);
    out->swap(tmp);
    width = t.xsize;
  }
}

struct LHeader {
  int width, height, alpha;
};

LHeader vp8l_header(const uint8_t* p, uint64_t n) {
  if (n < 5 || p[0] != 0x2f) bad("VP8L: no 0x2f signature");
  const uint32_t bits = le32(p + 1);
  if (bits >> 29) bad("VP8L: version " + std::to_string(bits >> 29));
  return {int(bits & 0x3fff) + 1, int((bits >> 14) & 0x3fff) + 1, int((bits >> 28) & 1)};
}

// ALPH compression 1 and the VP8L image: ARGB pixels.
std::vector<uint32_t> vp8l_pixels(const uint8_t* p, uint64_t n, int width, int height) {
  LReader br(p, n);
  std::vector<uint32_t> argb;
  decode_stream(br, width, height, true, &argb);
  return argb;
}

// ----------------------------------------------------------------- VP8 --

// libwebp's boolean decoder (bit_reader_utils.h) as a 64-bit build runs
// it: the range is kept minus one, bytes are loaded seven at a time while
// eight remain, then one at a time; past the end one zero byte is read and
// the partition marked, which fails the macroblock that read it.  The
// seven-byte loads matter only for a damaged partition (a first byte past
// the range): the window then carries high bits, cut to 32 as libwebp
// cuts them.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;  // seven-byte loads while buf < max
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;
  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    max = n >= 8 ? p + n - 7 : p;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < max) {
      uint64_t in = 0;
      for (int i = 0; i < 8; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = (in >> 8) | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get(0x80)) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = int(value_bits(n));
    return get(0x80) ? -v : v;
  }
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MB {  // the per-macroblock modes of one row
  uint8_t segment = 0, skip = 0, is_i4 = 0, uvmode = 0;
  uint8_t imodes[16];
};

const int BPS = 32;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 (size 16) and chroma (size 8) prediction; mode 0 DC, 1 TM, 2 V, 3 H.
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case 0: {
      int dc;
      if (has_top && has_left) {
        dc = size;
        for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
        dc >>= shift + 1;
      } else if (has_top) {
        dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        dc >>= shift;
      } else if (has_left) {
        dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        dc >>= shift;
      } else {
        dc = 0x80;
      }
      fill(dst, size, dc);
      break;
    }
    case 1: true_motion(dst, size); break;
    case 2:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
      break;
    default:
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

// The ten 4x4 modes in libwebp's order: DC TM VE HE RD VR LD VL HD HU.
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case 0: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, dc >> 3, 4);
      break;
    }
    case 1: true_motion(dst, 4); break;
    case 2: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
      break;
    }
    case 3: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, v[y], 4);
      break;
    }
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
  }
}

#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return int16_t(uint16_t(v)); }  // wraps
inline int16_t mulhi(int16_t a, int k) { return int16_t((int32_t(a) * k) >> 16); }

// The inverse DCT of one block added to its prediction as libwebp runs it
// on x86 (Transform_SSE2): TransformOne_C's arithmetic, each step wrapped
// to 16 bits, the sum with the prediction saturated.  The same bytes as
// the C version wherever a valid stream's coefficients keep the steps in
// range; a damaged one's too, as imageio decodes it.
void idct_add(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];  // t[j][i]: output j of the vertical pass of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t a = w16(in[i] + in[8 + i]), b = w16(in[i] - in[8 + i]);
    const int16_t c = w16(w16(in[4 + i] - in[12 + i]) +
                          w16(mulhi(in[4 + i], -30068) - mulhi(in[12 + i], 20091)));
    const int16_t d = w16(w16(in[4 + i] + in[12 + i]) +
                          w16(mulhi(in[4 + i], 20091) + mulhi(in[12 + i], -30068)));
    t[0][i] = w16(a + d);
    t[1][i] = w16(b + c);
    t[2][i] = w16(b - c);
    t[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r, dst += BPS) {  // row r from t[r][0..3]
    const int16_t* v = t[r];
    const int16_t dc = w16(v[0] + 4);
    const int16_t a = w16(dc + v[2]), b = w16(dc - v[2]);
    const int16_t c =
        w16(w16(v[1] - v[3]) + w16(mulhi(v[1], -30068) - mulhi(v[3], 20091)));
    const int16_t d =
        w16(w16(v[1] + v[3]) + w16(mulhi(v[1], 20091) + mulhi(v[3], -30068)));
    const int16_t o[4] = {int16_t(w16(a + d) >> 3), int16_t(w16(b + c) >> 3),
                          int16_t(w16(b - c) >> 3), int16_t(w16(a - d) >> 3)};
    for (int x = 0; x < 4; ++x) dst[x] = clip8(w16(dst[x] + o[x]));
  }
}

// TransformAC3_C: only coefficients 0, 1 and 4 set (a block's last
// non-zero one second or third in zigzag order).
void ac3_add(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y, dst += BPS) {
    dst[0] = clip8(dst[0] + ((rows[y] + d1) >> 3));
    dst[1] = clip8(dst[1] + ((rows[y] + c1) >> 3));
    dst[2] = clip8(dst[2] + ((rows[y] - c1) >> 3));
    dst[3] = clip8(dst[3] + ((rows[y] - d1) >> 3));
  }
}

// TransformDC_C: the DC coefficient alone.
void dc_add(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y, dst += BPS)
    for (int x = 0; x < 4; ++x) dst[x] = clip8(dst[x] + (dc >> 3));
}

// libwebp's DoTransform: the routine a block's code (3 full, 2 AC3, 1 DC,
// 0 none) picks.
void transform(int code, const int16_t* in, uint8_t* dst) {
  if (code == 3) idct_add(in, dst);
  else if (code == 2) ac3_add(in, dst);
  else if (code == 1) dc_add(in, dst);
}

// DoUVTransform: four chroma blocks, all through the full transform where
// any has an AC coefficient, else all through the DC one.
void transform_uv(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa)
      idct_add(in + 16 * n, d);
    else
      dc_add(in + 16 * n, d);
  }
}

void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
  }
}

// ------------------------------------------------------ loop filters --

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020,1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112,112]

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// Simple filter across one edge of 16 pixels: step across, along between.
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, t2)) filter2(p, step);
}

// Normal filter across one edge of `size` pixels; mb: the 6-tap edge.
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_t, bool mb) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_t))
      filter2(p, step);
    else if (mb)
      filter6(p, step);
    else
      filter4(p, step);
  }
}

// -------------------------------------------------------------- frame --

struct Vp8Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct Proba {
  uint8_t bands[4][8][3][11];
  uint8_t segments[3];
};

int get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = br.get(p[4]) ? 3 + br.get(p[5]) : 2;
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    static const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// The coefficients of one block from position n (GetCoeffsFast); returns
// the position after the last non-zero one (n where there is none).
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = get_large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

// data: size bytes, the chunk's chunk_size and its pad byte (libwebp's
// demuxer hands the decoder an odd chunk's pad byte too: the last token
// partition may read it).
Vp8Frame decode_vp8(const uint8_t* data, size_t size, size_t chunk_size) {
  if (size < 10) bad("VP8: the frame header is cut short");
  const uint32_t tag = le24(data);
  if (tag & 1) bad("VP8: not a key frame");
  if (((tag >> 1) & 7) > 3) bad("VP8: profile " + std::to_string((tag >> 1) & 7));
  if (!((tag >> 4) & 1)) bad("VP8: a frame not to be shown");
  const uint32_t part0 = tag >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) bad("VP8: no start code");
  Vp8Frame f;
  f.width = le16(data + 6) & 0x3fff;
  f.height = le16(data + 8) & 0x3fff;
  if (!f.width || !f.height) bad("VP8: an empty frame");
  if (part0 >= chunk_size) bad("VP8: the first partition's length is too large");
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t left = size - 10;
  if (part0 > left) bad("VP8: the first partition is cut short");
  BoolReader br;
  br.init(buf, part0);
  buf += part0;
  left -= part0;

  br.get(0x80);  // colour space
  br.get(0x80);  // clamping type
  // segment header
  bool use_segment = br.get(0x80), update_map = false, absolute = true;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  Proba proba;
  std::memset(proba.segments, 255, 3);
  if (use_segment) {
    update_map = br.get(0x80);
    if (br.get(0x80)) {
      absolute = br.get(0x80);
      for (int s = 0; s < 4; ++s) seg_quant[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) seg_filter[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) proba.segments[s] = br.get(0x80) ? br.value_bits(8) : 255;
  }
  if (br.eof) bad("VP8: the segment header is cut short");
  // filter header
  const int simple = br.get(0x80);
  const int level = br.value_bits(6);
  const int sharpness = br.value_bits(3);
  const int use_lf_delta = br.get(0x80);
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) ref_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) mode_delta[i] = br.signed_value(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) bad("VP8: the filter header is cut short");
  // partitions
  const int num_parts = 1 << br.value_bits(2);
  const int last = num_parts - 1;
  if (left < size_t(3 * last)) bad("VP8: the partition sizes are cut short");
  std::vector<BoolReader> parts(num_parts);
  {
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t remain = left - 3 * last;
    for (int p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > remain) psize = remain;
      parts[p].init(start, psize);
      start += psize;
      remain -= psize;
    }
    if (remain == 0) bad("VP8: the last partition is empty");
    parts[last].init(start, remain);
  }
  // quantizers
  Quant quant[4];
  {
    const int base_q0 = br.value_bits(7);
    int dq[5];
    for (int i = 0; i < 5; ++i) dq[i] = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2], dquv_dc = dq[3], dquv_ac = dq[4];
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = seg_quant[i] + (absolute ? 0 : base_q0);
      } else {
        if (i > 0) {
          quant[i] = quant[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = quant[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }
  br.get(0x80);  // refresh entropy probs: ignored, as libwebp does
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba.bands[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                        ? br.value_bits(8)
                                        : kCoeffsProba0[t][b][c][p];
  const int use_skip = br.get(0x80);
  const int skip_p = use_skip ? br.value_bits(8) : 0;

  // filter strengths for each segment, and i16 / i4
  FInfo fstrengths[4][2];
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) base = seg_filter[s] + (absolute ? 0 : level);
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& info = fstrengths[s][i4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_delta[0];
          if (i4) lvl += mode_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = uint8_t(ilevel);
          info.limit = uint8_t(2 * lvl + ilevel);
          info.hev = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = uint8_t(i4);
      }
    }
  }

  f.y_stride = f.mb_w * 16;
  f.uv_stride = f.mb_w * 8;
  f.y.assign(size_t(f.y_stride) * f.mb_h * 16, 0);
  f.u.assign(size_t(f.uv_stride) * f.mb_h * 8, 0);
  f.v.assign(size_t(f.uv_stride) * f.mb_h * 8, 0);
  std::vector<FInfo> finfo(size_t(f.mb_w) * f.mb_h);
  std::vector<uint8_t> intra_t(4 * f.mb_w, 0);
  std::vector<uint8_t> top_nz(f.mb_w, 0), top_nz_dc(f.mb_w, 0);
  std::vector<MB> row(f.mb_w);
  uint8_t ywork[BPS * 17], uwork[BPS * 9], vwork[BPS * 9];
  uint8_t* const ydst = ywork + BPS + 8;
  uint8_t* const udst = uwork + BPS + 8;
  uint8_t* const vdst = vwork + BPS + 8;
  int16_t coeffs[384];

  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    // intra modes of the row, from the first partition
    uint8_t intra_l[4] = {0, 0, 0, 0};
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      MB& b = row[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      b.segment = update_map ? (!br.get(proba.segments[0]) ? br.get(proba.segments[1])
                                                            : br.get(proba.segments[2]) + 2)
                             : 0;
      b.skip = use_skip ? br.get(skip_p) : 0;
      b.is_i4 = !br.get(145);
      if (!b.is_i4) {
        const int ymode = br.get(156) ? (br.get(128) ? 1 : 3) : (br.get(163) ? 2 : 0);
        b.imodes[0] = uint8_t(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[x] = uint8_t(ymode);
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = uint8_t(ymode);
        }
      }
      b.uvmode = !br.get(142) ? 0 : !br.get(114) ? 2 : br.get(183) ? 1 : 3;
    }
    if (br.eof) bad("VP8: the first partition is cut short");

    BoolReader& tbr = parts[mb_y & last];
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const MB& b = row[mb_x];
      uint32_t non_zero_y = 0, non_zero_uv = 0;
      bool all_zero;
      std::memset(coeffs, 0, sizeof(coeffs));
      if (!b.skip) {
        const Quant& q = quant[b.segment];
        int16_t* dst = coeffs;
        int first;
        const uint8_t(*ac)[3][11];
        if (!b.is_i4) {
          int16_t dc[16] = {0};
          const int ctx = top_nz_dc[mb_x] + left_nz_dc;
          const int nz = get_coeffs(tbr, proba.bands[1], ctx, q.y2, 0, dc);
          top_nz_dc[mb_x] = left_nz_dc = nz > 0;
          if (nz > 1) {
            iwht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
          }
          first = 1;
          ac = proba.bands[0];
        } else {
          first = 0;
          ac = proba.bands[3];
        }
        uint8_t tnz = top_nz[mb_x] & 0x0f, lnz = left_nz & 0x0f;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          uint32_t nzc = 0;
          for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(tbr, ac, ctx, q.y1, first, dst);
            l = nz > first;
            tnz = uint8_t((tnz >> 1) | (l << 7));
            nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
            dst += 16;
          }
          tnz >>= 4;
          lnz = uint8_t((lnz >> 1) | (l << 7));
          non_zero_y = (non_zero_y << 8) | nzc;
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nzc = 0;
          tnz = uint8_t(top_nz[mb_x] >> (4 + ch));
          lnz = uint8_t(left_nz >> (4 + ch));
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(tbr, proba.bands[2], ctx, q.uv, 0, dst);
              l = nz > 0;
              tnz = uint8_t((tnz >> 1) | (l << 3));
              nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
              dst += 16;
            }
            tnz >>= 2;
            lnz = uint8_t((lnz >> 1) | (l << 5));
          }
          non_zero_uv |= nzc << (4 * ch);
          out_t |= uint32_t(tnz << 4) << ch;
          out_l |= uint32_t(lnz & 0xf0) << ch;
        }
        top_nz[mb_x] = uint8_t(out_t);
        left_nz = uint8_t(out_l);
        all_zero = !(non_zero_y | non_zero_uv);
      } else {
        top_nz[mb_x] = left_nz = 0;
        if (!b.is_i4) top_nz_dc[mb_x] = left_nz_dc = 0;
        all_zero = true;
      }
      if (filter_type > 0) {
        FInfo fi = fstrengths[b.segment][b.is_i4];
        fi.inner |= !all_zero;
        finfo[size_t(mb_y) * f.mb_w + mb_x] = fi;
      }
      if (tbr.eof) bad("VP8: a token partition is cut short");

      // reconstruct into the work buffers, from unfiltered neighbours
      const int x0 = mb_x * 16, y0 = mb_y * 16;
      uint8_t* Y = &f.y[size_t(y0) * f.y_stride + x0];
      uint8_t* U = &f.u[size_t(y0 / 2) * f.uv_stride + x0 / 2];
      uint8_t* V = &f.v[size_t(y0 / 2) * f.uv_stride + x0 / 2];
      if (mb_y == 0) {
        std::memset(ydst - BPS - 1, 127, 21);
        std::memset(udst - BPS - 1, 127, 9);
        std::memset(vdst - BPS - 1, 127, 9);
      } else {
        std::memcpy(ydst - BPS, Y - f.y_stride, 16);
        std::memcpy(udst - BPS, U - f.uv_stride, 8);
        std::memcpy(vdst - BPS, V - f.uv_stride, 8);
        ydst[-BPS - 1] = mb_x ? Y[-f.y_stride - 1] : 129;
        udst[-BPS - 1] = mb_x ? U[-f.uv_stride - 1] : 129;
        vdst[-BPS - 1] = mb_x ? V[-f.uv_stride - 1] : 129;
        if (mb_x < f.mb_w - 1)
          std::memcpy(ydst - BPS + 16, Y - f.y_stride + 16, 4);
        else
          std::memset(ydst - BPS + 16, Y[-f.y_stride + 15], 4);
      }
      for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = mb_x ? Y[j * f.y_stride - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        udst[j * BPS - 1] = mb_x ? U[j * f.uv_stride - 1] : 129;
        vdst[j * BPS - 1] = mb_x ? V[j * f.uv_stride - 1] : 129;
      }
      if (b.is_i4) {
        for (int r = 1; r <= 3; ++r) std::memcpy(ydst + (4 * r - 1) * BPS + 16, ydst - BPS + 16, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, b.imodes[n]);
          transform((non_zero_y >> (30 - 2 * n)) & 3, coeffs + 16 * n, dst);
        }
      } else {
        predict_block(ydst, 16, b.imodes[0], mb_y > 0, mb_x > 0);
        for (int n = 0; n < 16; ++n)
          transform((non_zero_y >> (30 - 2 * n)) & 3, coeffs + 16 * n,
                    ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      predict_block(udst, 8, b.uvmode, mb_y > 0, mb_x > 0);
      predict_block(vdst, 8, b.uvmode, mb_y > 0, mb_x > 0);
      transform_uv(non_zero_uv, coeffs + 256, udst);
      transform_uv(non_zero_uv >> 8, coeffs + 320, vdst);
      for (int j = 0; j < 16; ++j) std::memcpy(Y + j * f.y_stride, ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(U + j * f.uv_stride, udst + j * BPS, 8);
        std::memcpy(V + j * f.uv_stride, vdst + j * BPS, 8);
      }
    }
  }

  // the loop filter, macroblock by macroblock in raster order
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
        const FInfo& fi = finfo[size_t(mb_y) * f.mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        const int ys = f.y_stride, uvs = f.uv_stride;
        uint8_t* Y = &f.y[size_t(mb_y) * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_edge(Y, 1, ys, limit + 4);
          if (fi.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(Y + k, 1, ys, limit);
          if (mb_y > 0) simple_edge(Y, ys, 1, limit + 4);
          if (fi.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(Y + k * ys, ys, 1, limit);
        } else {
          uint8_t* U = &f.u[size_t(mb_y) * 8 * uvs + mb_x * 8];
          uint8_t* V = &f.v[size_t(mb_y) * 8 * uvs + mb_x * 8];
          const int il = fi.ilevel, hv = fi.hev;
          if (mb_x > 0) {
            normal_edge(Y, 1, ys, 16, limit + 4, il, hv, true);
            normal_edge(U, 1, uvs, 8, limit + 4, il, hv, true);
            normal_edge(V, 1, uvs, 8, limit + 4, il, hv, true);
          }
          if (fi.inner) {
            for (int k = 4; k < 16; k += 4) normal_edge(Y + k, 1, ys, 16, limit, il, hv, false);
            normal_edge(U + 4, 1, uvs, 8, limit, il, hv, false);
            normal_edge(V + 4, 1, uvs, 8, limit, il, hv, false);
          }
          if (mb_y > 0) {
            normal_edge(Y, ys, 1, 16, limit + 4, il, hv, true);
            normal_edge(U, uvs, 1, 8, limit + 4, il, hv, true);
            normal_edge(V, uvs, 1, 8, limit + 4, il, hv, true);
          }
          if (fi.inner) {
            for (int k = 4; k < 16; k += 4)
              normal_edge(Y + k * ys, ys, 1, 16, limit, il, hv, false);
            normal_edge(U + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
            normal_edge(V + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
          }
        }
      }
    }
  }
  return f;
}

// ------------------------------------------------------- YUV -> RGB --

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = uint8_t(yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// One output row of the fancy upsampler: near is the chroma row nearest
// the luma row (weight 3), far the other (weight 1).
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int len, uint8_t* dst, int ch) {
  // (3 * near + far + 2) >> 2 on each chroma column, then the 3:1 mix of
  // neighbouring columns as libwebp's packed diagonals compute it
  auto vert = [](int n, int f) { return (3 * n + f + 2) >> 2; };
  yuv_to_rgb(y[0], vert(nu[0], fu[0]), vert(nv[0], fv[0]), dst);
  const int pairs = (len - 1) >> 1;
  for (int x = 1; x <= pairs; ++x) {
    const int tl_u = nu[x - 1], t_u = nu[x], l_u = fu[x - 1], c_u = fu[x];
    const int tl_v = nv[x - 1], t_v = nv[x], l_v = fv[x - 1], c_v = fv[x];
    // with near as libwebp's "top" row: avg = tl + t + l + uv + 8
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgb(y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + (2 * x - 1) * ch);
    yuv_to_rgb(y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + (2 * x) * ch);
  }
  if (!(len & 1)) {
    yuv_to_rgb(y[len - 1], vert(nu[pairs], fu[pairs]), vert(nv[pairs], fv[pairs]),
               dst + (len - 1) * ch);
  }
}

void yuv_to_rgb_image(const Vp8Frame& f, uint8_t* out, int ch) {
  const int w = f.width, h = f.height, ch_rows = (h + 1) / 2;
  for (int r = 0; r < h; ++r) {
    int near, far;
    if (r & 1) {  // 2k - 1: nearest chroma row k - 1, then k
      near = (r - 1) / 2;
      far = near + 1 < ch_rows ? near + 1 : near;
    } else {      // 2k: nearest k, then k - 1
      near = r / 2;
      far = near > 0 ? near - 1 : near;
    }
    const uint8_t* nu = &f.u[size_t(near) * f.uv_stride];
    const uint8_t* nv = &f.v[size_t(near) * f.uv_stride];
    const uint8_t* fu = &f.u[size_t(far) * f.uv_stride];
    const uint8_t* fv = &f.v[size_t(far) * f.uv_stride];
    upsample_row(&f.y[size_t(r) * f.y_stride], nu, nv, fu, fv, w, out + size_t(r) * w * ch, ch);
  }
}

// -------------------------------------------------------------- ALPH --

// The alpha plane of an ALPH chunk's payload for a width x height frame.
std::vector<uint8_t> decode_alpha(const uint8_t* p, size_t n, int width, int height) {
  if (n <= 1) bad("ALPH: an empty chunk");
  const int method = p[0] & 3, filter = (p[0] >> 2) & 3, pre = (p[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (p[0] >> 6)) bad("ALPH: a reserved header value");
  const size_t total = size_t(width) * height;
  std::vector<uint8_t> a(total);
  if (method == 0) {
    if (n - 1 < total) bad("ALPH: the raw alpha is cut short");
    std::memcpy(a.data(), p + 1, total);
  } else {
    const std::vector<uint32_t> argb = vp8l_pixels(p + 1, n - 1, width, height);
    for (size_t i = 0; i < total; ++i) a[i] = uint8_t(argb[i] >> 8);
  }
  for (int y = 0; y < height; ++y) {  // unfilter in place, row by row
    uint8_t* row = &a[size_t(y) * width];
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 0) continue;
    if (filter == 1 || !prev) {  // horizontal, and every first row
      uint8_t pred = (prev && filter == 1) ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = uint8_t(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = uint8_t(prev[x] + row[x]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = uint8_t(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        row[x] = left;
      }
    }
  }
  return a;
}

// ------------------------------------------------------------- RIFF --

struct Layout {
  int width = 0, height = 0, channels = 3;  // of the output (an animation's canvas)
  const uint8_t* image = nullptr;
  size_t image_size = 0, image_avail = 0;  // the chunk's size, with its pad
  bool lossless = false;
  const uint8_t* alpha = nullptr;  // an ALPH payload that counts
  size_t alpha_size = 0;
  bool animated = false;  // then the first frame's size and place on the canvas
  int frame_w = 0, frame_h = 0, x = 0, y = 0;
};

struct Chunk {
  uint32_t tag;
  const uint8_t* data;
  size_t size, avail;  // avail: with the pad byte of an odd size, if there
};

inline uint32_t fourcc(const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); }

// The width and height of a VP8 or VP8L bitstream, as WebPGetFeatures reads
// them.
void frame_size(const uint8_t* p, size_t n, bool lossless, int& w, int& h) {
  if (lossless) {
    const LHeader lh = vp8l_header(p, n);
    w = lh.width;
    h = lh.height;
    return;
  }
  if (n < 10) bad("VP8: the frame header is cut short");
  if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) bad("VP8: no start code");
  w = le16(p + 6) & 0x3fff;
  h = le16(p + 8) & 0x3fff;
}

// An animation (VP8X's animation flag, ANIM, ANMF frames) as libwebp's
// demuxer validates it, with the first frame's bitstream and place: the
// canvas of VP8X's size, RGBA by VP8X's alpha flag, else RGB.  A frame's
// ALPH chunk always counts (the demuxer drops ALPH only in still files).
Layout parse_animation(const std::vector<Chunk>& chunks, int canvas_w, int canvas_h,
                       bool alpha_flag) {
  Layout lay;
  lay.animated = true;
  lay.width = canvas_w;
  lay.height = canvas_h;
  lay.channels = alpha_flag ? 4 : 3;
  bool anim = false, first = true;
  if (std::none_of(chunks.begin(), chunks.end(),
                   [](const Chunk& c) { return c.tag == fourcc("ANMF"); }))
    bad("WebP: VP8X's animation flag without ANMF frames");
  for (size_t i = 1; i < chunks.size(); ++i) {
    const Chunk& c = chunks[i];
    if (c.tag == fourcc("ANIM")) {
      if (c.size < 6) bad("WebP: an ANIM chunk is cut short");
      anim = true;
      continue;
    }
    if (c.tag == fourcc("ALPH") || c.tag == fourcc("VP8 ") || c.tag == fourcc("VP8L"))
      bad("WebP: an image chunk outside the frames of an animation");
    if (c.tag != fourcc("ANMF")) continue;  // ICCP, EXIF, XMP, unknown
    if (!anim) bad("WebP: an ANMF frame before the ANIM chunk");
    if (c.size < 16) bad("WebP: an ANMF chunk is cut short");
    const int x = 2 * int(le24(c.data)), y = 2 * int(le24(c.data + 3));
    const uint8_t* alph = nullptr;
    size_t alph_size = 0;
    const uint8_t* img = nullptr;
    size_t img_size = 0, img_avail = 0;
    bool lossless = false;
    for (size_t q = 16; q + 8 <= c.size;) {
      const uint32_t tag = le32(c.data + q), size = le32(c.data + q + 4);
      if (size > c.size - q - 8) bad("WebP: a frame's chunk runs past its ANMF chunk");
      if (tag == fourcc("ALPH")) {
        if (alph) bad("WebP: two ALPH chunks in a frame");
        alph = c.data + q + 8;
        alph_size = size;
      } else if (tag == fourcc("VP8 ") || tag == fourcc("VP8L")) {
        img = c.data + q + 8;
        img_size = size;
        img_avail = std::min<size_t>(size + (size & 1), c.size - q - 8);
        lossless = tag == fourcc("VP8L");
        break;
      } else {
        bad("WebP: a frame's chunk is neither ALPH, VP8 nor VP8L");
      }
      q += 8 + size + (size & 1);
    }
    if (!img) bad("WebP: an animation frame without an image");
    if (alph && lossless) bad("WebP: an ALPH chunk with a VP8L frame");
    int w, h;
    frame_size(img, img_size, lossless, w, h);
    if (!w || !h) bad("WebP: an empty frame");
    if (x + w > canvas_w || y + h > canvas_h) bad("WebP: a frame leaves the canvas");
    if (first) {
      lay.image = img;
      lay.image_size = img_size;
      lay.image_avail = img_avail;
      lay.lossless = lossless;
      lay.alpha = alph;
      lay.alpha_size = alph_size;
      lay.frame_w = w;
      lay.frame_h = h;
      lay.x = x;
      lay.y = y;
      first = false;
    }
  }
  return lay;
}

Layout parse(const uint8_t* data, size_t n) {
  if (n < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4))
    bad("WebP: no RIFF....WEBP header");
  const uint32_t riff = le32(data + 4);
  if (riff < 12) bad("WebP: the RIFF size is too small");
  if (size_t(riff) + 8 > n) bad("WebP: the file is cut short of its RIFF size");
  const size_t end = size_t(riff) + 8;
  std::vector<Chunk> chunks;
  for (size_t p = 12; p < end;) {
    if (end - p < 8) bad("WebP: a chunk header is cut short");
    const uint32_t size = le32(data + p + 4);
    if (size > end - p - 8) bad("WebP: a chunk runs past the RIFF size");
    const size_t pad = (size & 1) && size < end - p - 8 ? 1 : 0;
    chunks.push_back({le32(data + p), data + p + 8, size, size + pad});
    p += 8 + size + (size & 1);
  }
  if (chunks.empty()) bad("WebP: no chunks");
  Layout lay;
  bool vp8x = false, alpha_flag = false, anim_flag = false;
  int canvas_w = 0, canvas_h = 0;
  size_t i = 0;
  if (chunks[0].tag == fourcc("VP8X")) {
    const Chunk& c = chunks[0];
    if (c.size != 10) bad("WebP: a VP8X chunk of " + std::to_string(c.size) + " bytes");
    if (c.data[0] & ~0x3e) bad("WebP: reserved VP8X flags set");
    anim_flag = c.data[0] & 0x02;
    alpha_flag = c.data[0] & 0x10;
    canvas_w = int(le24(c.data + 4)) + 1;
    canvas_h = int(le24(c.data + 7)) + 1;
    vp8x = true;
    i = 1;
  }
  if (anim_flag) return parse_animation(chunks, canvas_w, canvas_h, alpha_flag);
  for (const Chunk& c : chunks)
    if (c.tag == fourcc("ANMF")) bad("WebP: ANMF frames without VP8X's animation flag");
  const Chunk* alph = nullptr;
  for (; i < chunks.size(); ++i) {
    const Chunk& c = chunks[i];
    if (c.tag == fourcc("ALPH")) {
      if (!vp8x) bad("WebP: an ALPH chunk in a simple file");
      if (alph) bad("WebP: two ALPH chunks");
      alph = &c;
      continue;
    }
    if (c.tag == fourcc("VP8 ") || c.tag == fourcc("VP8L")) {
      lay.image = c.data;
      lay.image_size = c.size;
      lay.image_avail = c.avail;
      lay.lossless = c.tag == fourcc("VP8L");
      break;
    }
    if (!vp8x) bad("WebP: the first chunk is not VP8, VP8L or VP8X");
    if (alph) bad("WebP: a chunk between ALPH and the image");
  }
  if (!lay.image) bad("WebP: no VP8 or VP8L chunk");
  if (lay.lossless) {
    if (alph) bad("WebP: an ALPH chunk with a VP8L image");
    const LHeader h = vp8l_header(lay.image, lay.image_size);
    lay.width = h.width;
    lay.height = h.height;
    lay.channels = h.alpha ? 4 : 3;
  } else {
    frame_size(lay.image, lay.image_size, false, lay.width, lay.height);
    lay.channels = (alpha_flag || alph) ? 4 : 3;
    if (alph && alpha_flag) {  // libwebp's demuxer drops ALPH without the flag
      lay.alpha = alph->data;
      lay.alpha_size = alph->size;
    }
  }
  if (!lay.width || !lay.height) bad("WebP: an empty image");
  if (vp8x && (canvas_w != lay.width || canvas_h != lay.height))
    bad("WebP: the canvas is not the frame's size");
  return lay;
}

// The frame of `lay` (a still image, or an animation's first frame) into out,
// width x height x ch.
void decode_frame(const Layout& lay, uint8_t* out, int ch) {
  const size_t px = size_t(lay.width) * lay.height;
  if (lay.lossless) {
    const std::vector<uint32_t> argb =
        vp8l_pixels(lay.image + 5, lay.image_avail - 5, lay.width, lay.height);
    for (size_t i = 0; i < px; ++i) {
      const uint32_t v = argb[i];
      uint8_t* o = out + i * ch;
      o[0] = uint8_t(v >> 16);
      o[1] = uint8_t(v >> 8);
      o[2] = uint8_t(v);
      if (ch == 4) o[3] = uint8_t(v >> 24);
    }
    return;
  }
  const Vp8Frame f = decode_vp8(lay.image, lay.image_avail, lay.image_size);
  if (f.width != lay.width || f.height != lay.height) bad("VP8: inconsistent frame size");
  yuv_to_rgb_image(f, out, ch);
  if (ch == 4) {
    if (lay.alpha) {
      const std::vector<uint8_t> a = decode_alpha(lay.alpha, lay.alpha_size, f.width, f.height);
      for (size_t i = 0; i < px; ++i) out[i * 4 + 3] = a[i];
    } else {
      for (size_t i = 0; i < px; ++i) out[i * 4 + 3] = 255;
    }
  }
}

// WebPAnimDecoder's first frame: a zeroed (transparent) RGBA canvas, the
// frame decoded into its rectangle (no blending: nothing is under it), then
// RGB or RGBA.
void decode(const uint8_t* data, size_t n, uint8_t* out) {
  Layout lay = parse(data, n);
  if (!lay.animated) {
    decode_frame(lay, out, lay.channels);
    return;
  }
  const int cw = lay.width, chh = lay.height, ch = lay.channels;
  lay.width = lay.frame_w;
  lay.height = lay.frame_h;
  std::vector<uint8_t> frame(size_t(lay.width) * lay.height * 4);
  decode_frame(lay, frame.data(), 4);
  std::memset(out, 0, size_t(cw) * chh * ch);
  for (int y = 0; y < lay.height; ++y)
    for (int x = 0; x < lay.width; ++x)
      std::memcpy(out + (size_t(lay.y + y) * cw + lay.x + x) * ch,
                  &frame[(size_t(y) * lay.width + x) * 4], size_t(ch));
}

int finish(const Failure& e, char* msg, int64_t len) {
  if (len > 0) std::snprintf(msg, static_cast<size_t>(len), "%s", e.msg.c_str());
  return e.status;
}

}  // namespace

// hwc: height, width, channels (3 or 4).  Returns 0, or 2 for a damaged
// file, with a message in msg.
extern "C" int webp_header(const uint8_t* data, int64_t n, int64_t* hwc, char* msg,
                           int64_t msg_len) {
  try {
    const Layout lay = parse(data, static_cast<size_t>(n));
    hwc[0] = lay.height;
    hwc[1] = lay.width;
    hwc[2] = lay.channels;
    return kOk;
  } catch (const Failure& e) {
    return finish(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return finish(Failure{kMalformed, "WebP: out of memory"}, msg, msg_len);
  }
}

// out: height x width x channels bytes, row-major.  Returns as webp_header.
extern "C" int webp_decode(const uint8_t* data, int64_t n, uint8_t* out, char* msg,
                           int64_t msg_len) {
  try {
    decode(data, static_cast<size_t>(n), out);
    return kOk;
  } catch (const Failure& e) {
    return finish(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return finish(Failure{kMalformed, "WebP: out of memory"}, msg, msg_len);
  }
}
