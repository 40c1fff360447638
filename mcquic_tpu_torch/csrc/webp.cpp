// mcquic_tpu_torch WebP decoder (C++17, C ABI for ctypes).
//
// Decodes a WebP file to RGBA as `PIL.Image.open(f)` does on libwebp 1.6
// (Pillow 12.1 reads every WebP through `WebPAnimDecoder`, MODE_RGBA,
// non-premultiplied), so that its RGB equals `convert("RGB")` bit for bit:
//   * the RIFF container as demux.c checks it: simple `VP8 ` and `VP8L`
//     files, and `VP8X` files with ICCP, EXIF, XMP and unknown chunks
//     skipped (PIL applies no ICC profile in `convert`), an ALPH chunk
//     before `VP8 `, and ANIM / ANMF animations, of which frame 0 is
//     composed as anim_decode.c composes a key frame: on a canvas of
//     transparent black, the frame's pixels copied into its rectangle;
//   * VP8L (RFC 9649; src/dec/vp8l_dec.c): prefix-code groups with the meta
//     prefix image, the color cache, LZ77 backward references with the
//     distance map, and the four transforms (predictor with its 14 modes,
//     cross-color, subtract-green, color indexing with pixel bundling);
//   * VP8 key frames (RFC 6386; src/dec/vp8_dec.c, tree_dec.c,
//     quant_dec.c, frame_dec.c, dsp/dec.c): the boolean decoder, segments,
//     token partitions, coefficient tokens and dequantization, intra
//     prediction for 16x16, 4x4 and chroma, the inverse DCT and WHT, the
//     simple and normal loop filters with libwebp's filter strengths;
//   * libwebp's YUV 4:2:0 to RGB: the fancy upsampler of dsp/upsampling.c
//     and the 14-bit fixed-point conversion of dsp/yuv.h;
//   * ALPH (alpha_dec.c): raw or VP8L-compressed alpha (the green channel of
//     a headerless VP8L stream), the horizontal, vertical and gradient
//     filters; its level quantization needs no work at PIL's default
//     (alpha dithering off).
// A file libwebp refuses, truncated or corrupt data returns MCQ_WEBP_CORRUPT
// with a message; every valid file is read.
//
// The constant tables are those of RFC 6386 (default token probabilities,
// their update probabilities, the key-frame 4x4 mode probabilities in
// libwebp's mode order, the quantizer steps) and RFC 9649 (the distance
// map).
//
// Every entry point is reentrant. Build: see ../data/webp.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 2, kTooSmall = 3 };

struct Failure {
  Status status;
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) { throw Failure{kCorrupt, message}; }

constexpr int64_t kMaxPixels = 2 * 89478485;  // PIL's decompression-bomb limit

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (static_cast<uint32_t>(p[3]) << 24); }

constexpr uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
constexpr uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
constexpr uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};
constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// =================================================================== VP8L
class LosslessBits {
 public:
  LosslessBits(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // the next 32 bits from the current position, LSB first; bits past the end
  // read as zeros
  uint32_t peek() const {
    const size_t byte = static_cast<size_t>(pos_ >> 3);
    uint64_t window = 0;
    if (byte + 8 <= size_) {
      std::memcpy(&window, data_ + byte, 8);
    } else {
      for (size_t i = 0; byte + i < size_ && i < 8; ++i)
        window |= static_cast<uint64_t>(data_[byte + i]) << (8 * i);
    }
    return static_cast<uint32_t>(window >> (pos_ & 7));
  }
  void skip(int n) { pos_ += static_cast<uint64_t>(n); }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek() & ((n == 32 ? 0 : (1u << n)) - 1);
    skip(n);
    return v;
  }
  // vp8l_dec.c: the stream has ended once a read went past its last bit
  bool ended() const { return pos_ > 8 * static_cast<uint64_t>(size_); }

 private:
  const uint8_t* data_;
  size_t size_;
  uint64_t pos_ = 0;
};

// A canonical prefix code (huffman_utils.c::BuildHuffmanTable): symbols
// sorted by length, then value; the first bit read is the code's MSB.
class PrefixCode {
 public:
  // Builds from code lengths; false where libwebp refuses the code (all
  // lengths zero, or a code that is not complete). One symbol is a 0-bit code.
  bool build(const int* lengths, int size, bool keep) {
    int count[16] = {};
    for (int s = 0; s < size; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
    }
    if (count[0] == size) return false;
    int symbols = size - count[0];
    if (symbols == 1) {
      if (keep)
        for (int s = 0; s < size; ++s)
          if (lengths[s]) single_ = s;
      singleValued_ = true;
      return true;
    }
    int64_t kraft = 0;
    for (int l = 1; l < 16; ++l) kraft += static_cast<int64_t>(count[l]) << (15 - l);
    if (kraft != (1 << 15)) return false;
    if (!keep) return true;
    singleValued_ = false;
    sorted_.resize(symbols);
    int offset[16] = {};
    for (int l = 1; l < 15; ++l) offset[l + 1] = offset[l] + count[l];
    for (int l = 1; l < 16; ++l) count_[l] = count[l];
    for (int s = 0; s < size; ++s)
      if (lengths[s]) sorted_[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    // the root table: the next 8 bits, LSB first -> symbol and length
    std::fill(rootLen_, rootLen_ + 256, 0);
    int code = 0, k = 0;
    for (int l = 1; l < 16; ++l) {
      for (int i = 0; i < count[l]; ++i, ++k, ++code) {
        if (l <= 8) {
          int rev = 0;
          for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
          for (int fill = rev; fill < 256; fill += 1 << l) {
            rootLen_[fill] = static_cast<uint8_t>(l);
            rootSym_[fill] = sorted_[k];
          }
        }
      }
      code <<= 1;
    }
    return true;
  }

  int read(LosslessBits& br) const {
    if (singleValued_) return single_;
    uint32_t bits = br.peek();
    int len = rootLen_[bits & 255];
    if (len) {
      br.skip(len);
      return rootSym_[bits & 255];
    }
    // longer than 8 bits: canonical decoding bit by bit
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= (bits >> (l - 1)) & 1;
      int count = count_[l];
      if (code - first < count) {
        br.skip(l);
        return sorted_[index + code - first];
      }
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    br.skip(16);  // unreachable for a complete code
    return 0;
  }

 private:
  bool singleValued_ = true;
  int single_ = 0;
  int count_[16] = {};
  std::vector<uint16_t> sorted_;
  uint8_t rootLen_[256];
  uint16_t rootSym_[256];
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subSample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

inline uint32_t addPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int clip255(int a) { return a < 0 ? 0 : (a > 255 ? 255 : a); }

inline uint32_t clampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((c0 >> s) & 255) +
                                         static_cast<int>((c1 >> s) & 255) -
                                         static_cast<int>((c2 >> s) & 255)))
           << s;
  return out;
}

inline uint32_t clampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = static_cast<int>((ave >> s) & 255), b = static_cast<int>((c2 >> s) & 255);
    out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a top, b left, c top-left
  int paMinusPb = 0;
  for (int s = 0; s < 32; s += 8)
    paMinusPb += sub3((a >> s) & 255, (b >> s) & 255, (c >> s) & 255);
  return paMinusPb <= 0 ? a : b;
}

// lossless.c: the 14 predictors (14 and 15 are black, as libwebp pads them)
inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* upper) {
  const uint32_t L = out[-1], T = upper[0], TR = upper[1], TL = upper[-1];
  switch (mode) {
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
    case 11: return select(T, L, TL);
    case 12: return clampedAddSubtractFull(L, T, TL);
    case 13: return clampedAddSubtractHalf(L, T, TL);
    default: return 0xff000000u;
  }
}

// vp8l_dec.c: one image stream (the main image at level 0 with its
// transforms, or an entropy image, a transform's data or a palette)
class LosslessDecoder {
 public:
  LosslessDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  // The VP8L chunk: its 5-byte header, then the image.
  std::vector<uint32_t> decodeFile(int& width, int& height) {
    if (br_.read(8) != 0x2f) corrupt("VP8L: bad signature");
    width = static_cast<int>(br_.read(14)) + 1;
    height = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha_is_used: a hint
    if (br_.read(3) != 0) corrupt("VP8L: unknown version");
    return decodeStream(width, height, true);
  }

  // A headerless stream of known size (ALPH's compressed alpha).
  std::vector<uint32_t> decodeHeaderless(int width, int height) { return decodeStream(width, height, true); }

 private:
  struct Group {
    PrefixCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
  };

  std::vector<uint32_t> decodeStream(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int txs = xsize;
    if (level0) {
      unsigned seen = 0;
      while (br_.read(1)) {
        Transform t;
        t.type = static_cast<int>(br_.read(2));
        if (seen & (1u << t.type)) corrupt("VP8L: a transform repeats");
        seen |= 1u << t.type;
        t.xsize = txs;
        t.ysize = ysize;
        if (t.type == 0 || t.type == 1) {  // predictor, cross-color
          t.bits = static_cast<int>(br_.read(3)) + 2;
          t.data = decodeStream(subSample(t.xsize, t.bits), subSample(ysize, t.bits), false);
        } else if (t.type == 3) {  // color indexing
          const int colors = static_cast<int>(br_.read(8)) + 1;
          t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
          txs = subSample(t.xsize, t.bits);
          std::vector<uint32_t> palette = decodeStream(colors, 1, false);
          // vp8l_dec.c::ExpandColorMap: delta-coded, padded with transparent black
          t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
          t.data[0] = palette[0];
          for (int i = 1; i < colors; ++i) t.data[i] = addPixels(palette[i], t.data[i - 1]);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cacheBits = 0;
    if (br_.read(1)) {
      cacheBits = static_cast<int>(br_.read(4));
      if (cacheBits < 1 || cacheBits > 11) corrupt("VP8L: bad color cache size");
    }
    readCodes(txs, ysize, cacheBits, level0);
    std::vector<uint32_t> data = decodeData(txs, ysize, cacheBits);
    if (br_.ended()) corrupt("VP8L: data truncated");
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) data = inverse(*t, data);
    return data;
  }

  // vp8l_dec.c::ReadHuffmanCodeLengths
  void readCodeLengths(const int* codeLengthLengths, int size, int* lengths) {
    PrefixCode table;
    if (!table.build(codeLengthLengths, 19, true)) corrupt("VP8L: bad code length code");
    int maxSymbol = size;
    if (br_.read(1)) {
      const int bits = 2 + 2 * static_cast<int>(br_.read(3));
      maxSymbol = 2 + static_cast<int>(br_.read(bits));
      if (maxSymbol > size) corrupt("VP8L: bad code length count");
    }
    int previous = 8, symbol = 0;
    while (symbol < size) {
      if (maxSymbol-- == 0) break;
      const int len = table.read(br_);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) previous = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = len - 16;
        int repeat = static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > size) corrupt("VP8L: code lengths overflow");
        const int value = len == 16 ? previous : 0;
        while (repeat-- > 0) lengths[symbol++] = value;
      }
    }
  }

  // vp8l_dec.c::ReadHuffmanCode
  void readCode(int size, PrefixCode* code) {
    std::vector<int> lengths(std::max(size, 256), 0);
    if (br_.read(1)) {  // simple code
      const int symbols = static_cast<int>(br_.read(1)) + 1;
      const int firstBits = br_.read(1) ? 8 : 1;
      lengths[br_.read(firstBits)] = 1;
      if (symbols == 2) lengths[br_.read(8)] = 1;
    } else {
      int codeLengthLengths[19] = {};
      const int count = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < count; ++i) codeLengthLengths[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
      readCodeLengths(codeLengthLengths, size, lengths.data());
    }
    if (br_.ended()) corrupt("VP8L: data truncated in a prefix code");
    PrefixCode scratch;
    if (!(code ? code : &scratch)->build(lengths.data(), size, code != nullptr))
      corrupt("VP8L: bad prefix code");
  }

  // vp8l_dec.c::ReadHuffmanCodes (the entropy image is decoded first, as a
  // stream of its own)
  void readCodes(int xsize, int ysize, int cacheBits, bool allowMeta) {
    int metaBits = 0, metaXsize = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (allowMeta && br_.read(1)) {
      metaBits = static_cast<int>(br_.read(3)) + 2;
      metaXsize = subSample(xsize, metaBits);
      meta = decodeStream(metaXsize, subSample(ysize, metaBits), false);
      for (auto& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, static_cast<int>(m) + 1);
      }
    }
    metaBits_ = metaBits;
    metaXsize_ = metaXsize;
    meta_ = std::move(meta);
    std::vector<char> used(groups, meta_.empty() ? 1 : 0);
    for (uint32_t m : meta_) used[m] = 1;
    groupIndex_.assign(groups, -1);
    groups_.clear();
    int kept = 0;
    for (int g = 0; g < groups; ++g)
      if (used[g]) groupIndex_[g] = kept++;
    groups_.resize(kept);
    const int sizes[5] = {256 + 24 + (cacheBits ? 1 << cacheBits : 0), 256, 256, 256, 40};
    for (int g = 0; g < groups; ++g)
      for (int j = 0; j < 5; ++j)
        readCode(sizes[j], used[g] ? &groups_[groupIndex_[g]].codes[j] : nullptr);
  }

  // vp8l_dec.c::DecodeImageData
  std::vector<uint32_t> decodeData(int width, int height, int cacheBits) {
    const size_t total = static_cast<size_t>(width) * height;
    std::vector<uint32_t> data(total);
    std::vector<uint32_t> cache(cacheBits ? static_cast<size_t>(1) << cacheBits : 0);
    const int cacheShift = 32 - cacheBits;
    size_t pos = 0, cached = 0;
    int x = 0, y = 0;
    const uint32_t mask = metaBits_ ? (1u << metaBits_) - 1 : ~0u;
    auto groupAt = [&](int gx, int gy) -> const Group& {
      if (!metaBits_) return groups_[0];
      return groups_[groupIndex_[meta_[static_cast<size_t>(gy >> metaBits_) * metaXsize_ + (gx >> metaBits_)]]];
    };
    auto flushCache = [&]() {
      for (; cached < pos; ++cached)
        cache[(0x1e35a7bdu * data[cached]) >> cacheShift] = data[cached];
    };
    const Group* group = total ? &groupAt(0, 0) : nullptr;
    while (pos < total) {
      if ((x & mask) == 0) group = &groupAt(x, y);
      const int code = group->codes[0].read(br_);
      if (br_.ended()) break;
      if (code < 256) {
        const int red = group->codes[1].read(br_);
        const int blue = group->codes[2].read(br_);
        const int alpha = group->codes[3].read(br_);
        if (br_.ended()) break;
        data[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
        if (++x >= width) {
          x = 0;
          ++y;
          if (cacheBits) flushCache();
        }
      } else if (code < 256 + 24) {
        const int length = copyValue(code - 256);
        const int distSymbol = group->codes[4].read(br_);
        const int distCode = copyValue(distSymbol);
        const int dist = planeToDistance(width, distCode);
        if (br_.ended()) break;
        if (pos < static_cast<size_t>(dist) || total - pos < static_cast<size_t>(length))
          corrupt("VP8L: backward reference out of the image");
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        x += length;
        while (x >= width) {
          x -= width;
          ++y;
        }
        if (x & mask) group = &groupAt(x, y);
        if (cacheBits) flushCache();
      } else {
        const int key = code - 256 - 24;
        if (!cacheBits || key >= (1 << cacheBits)) corrupt("VP8L: bad color cache code");
        flushCache();
        data[pos++] = cache[key];
        if (++x >= width) {
          x = 0;
          ++y;
          flushCache();
        }
      }
    }
    if (br_.ended()) corrupt("VP8L: data truncated");
    return data;
  }

  int copyValue(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  static int planeToDistance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int distCode = kCodeToPlane[code - 1];
    const int yoffset = distCode >> 4, xoffset = 8 - (distCode & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // lossless.c::VP8LInverseTransform over the whole image
  static std::vector<uint32_t> inverse(const Transform& t, const std::vector<uint32_t>& in) {
    const int width = t.xsize, height = t.ysize;
    std::vector<uint32_t> out(static_cast<size_t>(width) * height);
    if (t.type == 2) {  // subtract green
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
        uint32_t redBlue = argb & 0x00ff00ffu;
        redBlue += (green << 16) | green;
        out[i] = (argb & 0xff00ff00u) | (redBlue & 0x00ff00ffu);
      }
    } else if (t.type == 1) {  // cross-color
      const int tiles = subSample(width, t.bits);
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t greenToRed = static_cast<int8_t>(m & 0xff),
                       greenToBlue = static_cast<int8_t>((m >> 8) & 0xff),
                       redToBlue = static_cast<int8_t>((m >> 16) & 0xff);
          const size_t i = static_cast<size_t>(y) * width + x;
          const uint32_t argb = in[i];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((greenToRed * green) >> 5)) & 0xff;
          blue += (greenToBlue * green) >> 5;
          blue += (redToBlue * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          out[i] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
    } else if (t.type == 0) {  // predictor
      const int tiles = subSample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        const uint32_t* src = &in[static_cast<size_t>(y) * width];
        uint32_t* dst = &out[static_cast<size_t>(y) * width];
        if (y == 0) {
          dst[0] = addPixels(src[0], 0xff000000u);
          for (int x = 1; x < width; ++x) dst[x] = addPixels(src[x], dst[x - 1]);
          continue;
        }
        const uint32_t* upper = dst - width;
        dst[0] = addPixels(src[0], upper[0]);
        const uint32_t* modes = &t.data[static_cast<size_t>(y >> t.bits) * tiles];
        for (int x = 1; x < width; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          dst[x] = addPixels(src[x], predict(mode, dst + x, upper + x));
        }
      }
    } else {  // color indexing
      const int bitsPerPixel = 8 >> t.bits, inWidth = subSample(width, t.bits);
      const int perByte = 1 << t.bits;
      const uint32_t bitMask = (1u << bitsPerPixel) - 1;
      for (int y = 0; y < height; ++y) {
        const uint32_t* src = &in[static_cast<size_t>(y) * inWidth];
        uint32_t* dst = &out[static_cast<size_t>(y) * width];
        uint32_t packed = 0;
        for (int x = 0; x < width; ++x) {
          if ((x & (perByte - 1)) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & bitMask];
          packed >>= bitsPerPixel;
        }
      }
    }
    return out;
  }

  LosslessBits br_;
  int metaBits_ = 0, metaXsize_ = 0;
  std::vector<uint32_t> meta_;
  std::vector<int> groupIndex_;
  std::vector<Group> groups_;
};

// ==================================================================== VP8
// bit_reader_utils.h: the boolean decoder, loading one byte at a time (the
// same bits and the same end-of-data point as libwebp's wider loads)
class BoolDecoder {
 public:
  void init(const uint8_t* data, size_t size) {
    buf_ = data;
    end_ = data + size;
    value_ = 0;
    range_ = 255 - 1;
    bits_ = -8;
    eof_ = false;
    load();
  }

  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    int shift = 0;
    while ((range << shift) < 128) ++shift;  // 7 ^ BitsLog2Floor(range)
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }

  uint32_t value(int bits) {
    uint32_t v = 0;
    while (bits-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << bits;
    return v;
  }

  int signedValue(int bits) {
    const int v = static_cast<int>(value(bits));
    return bit(0x80) ? -v : v;
  }

  bool eof() const { return eof_; }

 private:
  void load() {  // VP8LoadFinalBytes
    if (buf_ < end_) {
      bits_ += 8;
      value_ = static_cast<uint64_t>(*buf_++) | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
  bool eof_ = false;
};

// libwebp's mode order
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
       B_HD_PRED, B_HU_PRED, DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };

constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

// dsp/dec.c::TransformOne: add the inverse DCT of `in` to the 4x4 at `dst`
void transformAdd(const int16_t* in, uint8_t* dst, int stride) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += stride;
  }
}

// dsp/dec.c::TransformWHT: the 16 luma DC values into each block's [0]
void transformWht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

#define AVG3(a, b, c) static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) static_cast<uint8_t>(((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * bps]

void trueMotion(uint8_t* dst, int bps, int size) {
  const uint8_t* top = dst - bps;
  const int topLeft = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - topLeft);
    dst += bps;
  }
}

// dsp/dec.c: the ten 4x4 predictors
void predict4(int mode, uint8_t* dst, int bps) {
  const uint8_t* top = dst - bps;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - bps] + dst[-1 + i * bps];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * bps, static_cast<int>(dc), 4);
      break;
    }
    case B_TM_PRED:
      trueMotion(dst, bps, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * bps, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - bps], B = dst[-1], C = dst[-1 + bps], D = dst[-1 + 2 * bps],
                E = dst[-1 + 3 * bps];
      std::memset(dst + 0 * bps, AVG3(A, B, C), 4);
      std::memset(dst + 1 * bps, AVG3(B, C, D), 4);
      std::memset(dst + 2 * bps, AVG3(C, D, E), 4);
      std::memset(dst + 3 * bps, AVG3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * bps], J = dst[-1 + 1 * bps], K = dst[-1 + 2 * bps],
                L = dst[-1 + 3 * bps], X = dst[-1 - bps], A = dst[0 - bps], B = dst[1 - bps],
                C = dst[2 - bps], D = dst[3 - bps];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - bps], B = dst[1 - bps], C = dst[2 - bps], D = dst[3 - bps],
                E = dst[4 - bps], F = dst[5 - bps], G = dst[6 - bps], H = dst[7 - bps];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * bps], J = dst[-1 + 1 * bps], K = dst[-1 + 2 * bps],
                X = dst[-1 - bps], A = dst[0 - bps], B = dst[1 - bps], C = dst[2 - bps],
                D = dst[3 - bps];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - bps], B = dst[1 - bps], C = dst[2 - bps], D = dst[3 - bps],
                E = dst[4 - bps], F = dst[5 - bps], G = dst[6 - bps], H = dst[7 - bps];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * bps], J = dst[-1 + 1 * bps], K = dst[-1 + 2 * bps],
                L = dst[-1 + 3 * bps], X = dst[-1 - bps], A = dst[0 - bps], B = dst[1 - bps],
                C = dst[2 - bps];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * bps], J = dst[-1 + 1 * bps], K = dst[-1 + 2 * bps],
                L = dst[-1 + 3 * bps];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    }
  }
}

// dsp/dec.c: 16x16 luma and 8x8 chroma predictors (`size`), with the DC
// variants frame_dec.c::CheckMode picks at the picture's edges
void predictBlock(int mode, uint8_t* dst, int bps, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - bps] + dst[-1 + j * bps];
      for (int j = 0; j < size; ++j) std::memset(dst + j * bps, dc >> (shift + 1), size);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * bps];
      for (int j = 0; j < size; ++j) std::memset(dst + j * bps, dc >> shift, size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - bps];
      for (int j = 0; j < size; ++j) std::memset(dst + j * bps, dc >> shift, size);
      break;
    }
    case DC_NOTOPLEFT:
      for (int j = 0; j < size; ++j) std::memset(dst + j * bps, 0x80, size);
      break;
    case B_TM_PRED:
      trueMotion(dst, bps, size);
      break;
    case B_VE_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * bps, dst - bps, size);
      break;
    default:  // B_HE_PRED
      for (int j = 0; j < size; ++j) std::memset(dst + j * bps, dst[-1 + j * bps], size);
      break;
  }
}
#undef DST
#undef AVG2
#undef AVG3

// dsp/dec.c: the loop filters
inline void doFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void doFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void doFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
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

inline bool needsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `hstride` steps across the edge, `vstride` along it
void simpleFilter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needsFilter(p, hstride, thresh2)) doFilter2(p, hstride);
}

void filterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hevThresh,
                bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needsFilter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hevThresh)) doFilter2(p, hstride);
    else if (edge) doFilter6(p, hstride);
    else doFilter4(p, hstride);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hevThresh = 0;
  bool inner = false;
};

class LossyDecoder {
 public:
  // Decodes the `VP8 ` chunk's payload (with its padding byte) into Y, U,
  // V planes over whole macroblocks, the picture's size in width and height.
  void decode(const uint8_t* data, size_t size) {
    if (size < 10) corrupt("VP8: truncated header");
    const uint32_t bits = le24(data);
    const bool keyFrame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partitionLength = bits >> 5;
    if (!keyFrame) corrupt("VP8: not a key frame");
    if (profile > 3) corrupt("VP8: unknown profile");
    if (!show) corrupt("VP8: frame not displayable");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) corrupt("VP8: bad start code");
    width = le16(data + 6) & 0x3fff;
    height = le16(data + 8) & 0x3fff;
    if (width == 0 || height == 0) corrupt("VP8: empty picture");
    mbw_ = (width + 15) >> 4;
    mbh_ = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t left = size - 10;
    if (partitionLength > left) corrupt("VP8: bad partition length");
    br_.init(buf, partitionLength);
    buf += partitionLength;
    left -= partitionLength;
    br_.value(1);  // colorspace
    br_.value(1);  // clamping type
    parseSegmentHeader();
    parseFilterHeader();
    parsePartitions(buf, left);
    parseQuant();
    br_.value(1);  // refresh entropy probabilities: ignored
    parseProba();
    frame();
  }

  int width = 0, height = 0;
  std::vector<uint8_t> y, u, v;
  int yStride = 0, uvStride = 0;

 private:
  struct Quant {
    int y1[2], y2[2], uv[2];
  };
  struct MbData {
    int16_t coeffs[384];
    uint8_t modes[16];
    int uvMode = 0;
    bool i4x4 = false, skip = false;
    int segment = 0;
    uint32_t nonZeroY = 0, nonZeroUv = 0;
  };

  void parseSegmentHeader() {
    useSegment_ = br_.value(1);
    if (useSegment_) {
      updateMap_ = br_.value(1);
      if (br_.value(1)) {
        absoluteDelta_ = br_.value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value(1) ? br_.signedValue(7) : 0;
        for (int s = 0; s < 4; ++s) filterStrength_[s] = br_.value(1) ? br_.signedValue(6) : 0;
      }
      if (updateMap_)
        for (int s = 0; s < 3; ++s) segmentProba_[s] = br_.value(1) ? br_.value(8) : 255;
    } else {
      updateMap_ = false;
    }
    if (br_.eof()) corrupt("VP8: cannot parse segment header");
  }

  void parseFilterHeader() {
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    useLfDelta_ = br_.value(1);
    if (useLfDelta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) refLfDelta_[i] = br_.signedValue(6);
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) modeLfDelta_[i] = br_.signedValue(6);
    }
    filterType_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) corrupt("VP8: cannot parse filter header");
  }

  void parsePartitions(const uint8_t* buf, size_t size) {
    const uint8_t* end = buf + size;
    numParts_ = 1 << br_.value(2);
    const size_t last = numParts_ - 1;
    if (size < 3 * last) corrupt("VP8: cannot parse partitions");
    const uint8_t* sizes = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = le24(sizes + 3 * p);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (start >= end) corrupt("VP8: cannot parse partitions");
  }

  void parseQuant() {
    const int base = br_.value(7);
    const int dqy1Dc = br_.value(1) ? br_.signedValue(4) : 0;
    const int dqy2Dc = br_.value(1) ? br_.signedValue(4) : 0;
    const int dqy2Ac = br_.value(1) ? br_.signedValue(4) : 0;
    const int dquvDc = br_.value(1) ? br_.signedValue(4) : 0;
    const int dquvAc = br_.value(1) ? br_.signedValue(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : (v > m ? m : v); };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (useSegment_) {
        q = quantizer_[i];
        if (!absoluteDelta_) q += base;
      } else {
        if (i > 0) {
          quant_[i] = quant_[0];
          continue;
        }
        q = base;
      }
      Quant& m = quant_[i];
      m.y1[0] = kDcTable[clip(q + dqy1Dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2Dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2Ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquvDc, 117)];
      m.uv[1] = kAcTable[clip(q + dquvAc, 127)];
    }
  }

  void parseProba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba_[t][b][c][p] = static_cast<uint8_t>(br_.bit(kCoeffsUpdateProba[i]) ? br_.value(8)
                                                                                     : kCoeffsProba0[i]);
          }
    useSkipProba_ = br_.value(1);
    if (useSkipProba_) skipProba_ = br_.value(8);
  }

  // tree_dec.c::ParseIntraMode
  void parseIntraMode(MbData& mb, uint8_t* top, uint8_t* left) {
    if (updateMap_)
      mb.segment = !br_.bit(segmentProba_[0]) ? br_.bit(segmentProba_[1])
                                              : br_.bit(segmentProba_[2]) + 2;
    else
      mb.segment = 0;
    mb.skip = useSkipProba_ ? br_.bit(skipProba_) : false;
    mb.i4x4 = !br_.bit(145);
    if (!mb.i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM_PRED : B_HE_PRED)
                                     : (br_.bit(163) ? B_VE_PRED : B_DC_PRED);
      mb.modes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.modes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          ymode = !br_.bit(prob[0])   ? B_DC_PRED
                  : !br_.bit(prob[1]) ? B_TM_PRED
                  : !br_.bit(prob[2]) ? B_VE_PRED
                  : !br_.bit(prob[3])
                      ? (!br_.bit(prob[4]) ? B_HE_PRED : (!br_.bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                      : (!br_.bit(prob[6])
                             ? B_LD_PRED
                             : (!br_.bit(prob[7]) ? B_VL_PRED
                                                  : (!br_.bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvMode = !br_.bit(142) ? B_DC_PRED : !br_.bit(114) ? B_VE_PRED : br_.bit(183) ? B_TM_PRED : B_HE_PRED;
  }

  // tree_dec.c / vp8_dec.c::GetCoeffsFast
  int getCoeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int band = kBands[n + 1];
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][band][1];
      } else {
        if (!br.bit(p[3])) {
          v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
        } else if (!br.bit(p[6])) {
          if (!br.bit(p[7])) {
            v = 5 + br.bit(159);
          } else {
            v = 7 + 2 * br.bit(165);
            v += br.bit(145);
          }
        } else {
          const int bit1 = br.bit(p[8]);
          const int bit0 = br.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba_[type][band][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>((br.bit(0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nzCodeBits(uint32_t nzCoeffs, int nz, int dcNz) {
    nzCoeffs <<= 2;
    nzCoeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dcNz;
    return nzCoeffs;
  }

  // vp8_dec.c::ParseResiduals: true where every coefficient is zero
  bool parseResiduals(MbData& block, BoolDecoder& br, uint32_t& topNz, uint32_t& topNzDc) {
    const Quant& q = quant_[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof block.coeffs);
    int first, acType;
    if (!block.i4x4) {
      int16_t dc[16] = {};
      const int ctx = static_cast<int>(topNzDc + leftNzDc_);
      const int nz = getCoeffs(br, 1, ctx, q.y2, 0, dc);
      topNzDc = leftNzDc_ = nz > 0;
      if (nz > 1) {
        transformWht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      acType = 0;
    } else {
      first = 0;
      acType = 3;
    }
    uint32_t tnz = topNz & 0x0f, lnz = leftNz_ & 0x0f;
    uint32_t nonZeroY = 0, nonZeroUv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nzCoeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + static_cast<int>(tnz & 1);
        const int nz = getCoeffs(br, acType, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 7);
        nzCoeffs = nzCodeBits(nzCoeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 7);
      nonZeroY = (nonZeroY << 8) | nzCoeffs;
    }
    uint32_t outTnz = tnz, outLnz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzCoeffs = 0;
      tnz = topNz >> (4 + ch);
      lnz = leftNz_ >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + static_cast<int>(tnz & 1);
          const int nz = getCoeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 3);
          nzCoeffs = nzCodeBits(nzCoeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 5);
      }
      nonZeroUv |= nzCoeffs << (4 * ch);
      outTnz |= (tnz << 4) << ch;
      outLnz |= (lnz & 0xf0) << ch;
    }
    topNz = outTnz;
    leftNz_ = outLnz;
    block.nonZeroY = nonZeroY;
    block.nonZeroUv = nonZeroUv;
    return !(nonZeroY | nonZeroUv);
  }

  // frame_dec.c::PrecomputeFilterStrengths
  void filterStrengths() {
    for (int s = 0; s < 4; ++s) {
      int base = useSegment_ ? filterStrength_[s] + (absoluteDelta_ ? 0 : level_) : level_;
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = strengths_[s][i4x4];
        int level = base;
        if (useLfDelta_) {
          level += refLfDelta_[0];
          if (i4x4) level += modeLfDelta_[0];
        }
        level = level < 0 ? 0 : (level > 63 ? 63 : level);
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hevThresh = level >= 40 ? 2 : (level >= 15 ? 1 : 0);
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  static int checkMode(int mbx, int mby, int mode) {
    if (mode == B_DC_PRED) {
      if (mbx == 0) return mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mby == 0 ? DC_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  // frame_dec.c::ReconstructRow for one macroblock, in a work area of
  // stride 32 with the unfiltered samples around it
  void reconstruct(const MbData& block, int mbx, int mby) {
    constexpr int BPS = 32;
    uint8_t work[BPS * 17 + BPS * 9 * 2 + 64];
    uint8_t* ydst = work + BPS + 8;
    uint8_t* udst = work + BPS * 18 + 8;
    uint8_t* vdst = udst + 16;
    // left column, top row and corner: 129 on the left edge, 127 on the top
    for (int j = -1; j < 16; ++j) ydst[j * BPS - 1] = mbx > 0 && j >= 0 ? y[(mby * 16 + j) * yStride + mbx * 16 - 1] : 129;
    for (int j = -1; j < 8; ++j) {
      udst[j * BPS - 1] = mbx > 0 && j >= 0 ? u[(mby * 8 + j) * uvStride + mbx * 8 - 1] : 129;
      vdst[j * BPS - 1] = mbx > 0 && j >= 0 ? v[(mby * 8 + j) * uvStride + mbx * 8 - 1] : 129;
    }
    if (mby > 0) {
      const uint8_t* ty = &y[(mby * 16 - 1) * yStride + mbx * 16];
      std::memcpy(ydst - BPS, ty, 16);
      std::memcpy(udst - BPS, &u[(mby * 8 - 1) * uvStride + mbx * 8], 8);
      std::memcpy(vdst - BPS, &v[(mby * 8 - 1) * uvStride + mbx * 8], 8);
      if (mbx > 0) {
        ydst[-BPS - 1] = ty[-1];
        udst[-BPS - 1] = u[(mby * 8 - 1) * uvStride + mbx * 8 - 1];
        vdst[-BPS - 1] = v[(mby * 8 - 1) * uvStride + mbx * 8 - 1];
      }
      // the 4x4 predictors' top-right samples
      if (mbx >= mbw_ - 1) std::memset(ydst - BPS + 16, ty[15], 4);
      else std::memcpy(ydst - BPS + 16, ty + 16, 4);
    } else {
      std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(udst - BPS - 1, 127, 8 + 1);
      std::memset(vdst - BPS - 1, 127, 8 + 1);
    }
    const int16_t* coeffs = block.coeffs;
    if (block.i4x4) {
      uint8_t* topRight = ydst - BPS + 16;
      for (int r = 1; r <= 3; ++r) std::memcpy(topRight + 4 * r * BPS, topRight, 4);
      uint32_t bits = block.nonZeroY;
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(block.modes[n], dst, BPS);
        if (bits >> 30) transformAdd(coeffs + n * 16, dst, BPS);
      }
    } else {
      predictBlock(checkMode(mbx, mby, block.modes[0]), ydst, BPS, 16);
      uint32_t bits = block.nonZeroY;
      if (bits)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          if (bits >> 30) transformAdd(coeffs + n * 16, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
    }
    const int uvMode = checkMode(mbx, mby, block.uvMode);
    predictBlock(uvMode, udst, BPS, 8);
    predictBlock(uvMode, vdst, BPS, 8);
    for (int ch = 0; ch < 2; ++ch) {
      const uint32_t bits = block.nonZeroUv >> (8 * ch);
      uint8_t* dst = ch ? vdst : udst;
      if (bits & 0xff)
        for (int n = 0; n < 4; ++n)
          transformAdd(coeffs + (16 + 4 * ch + n) * 16, dst + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
    }
    for (int j = 0; j < 16; ++j) std::memcpy(&y[(mby * 16 + j) * yStride + mbx * 16], ydst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(&u[(mby * 8 + j) * uvStride + mbx * 8], udst + j * BPS, 8);
      std::memcpy(&v[(mby * 8 + j) * uvStride + mbx * 8], vdst + j * BPS, 8);
    }
  }

  // frame_dec.c::DoFilter on the filtered planes
  void filter(const FilterInfo& f, int mbx, int mby, std::vector<uint8_t>& fy, std::vector<uint8_t>& fu,
              std::vector<uint8_t>& fv) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* yd = &fy[(mby * 16) * yStride + mbx * 16];
    if (filterType_ == 1) {
      if (mbx > 0) simpleFilter(yd, 1, yStride, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simpleFilter(yd + 4 * k, 1, yStride, 16, limit);
      if (mby > 0) simpleFilter(yd, yStride, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simpleFilter(yd + 4 * k * yStride, yStride, 1, 16, limit);
      return;
    }
    uint8_t* ud = &fu[(mby * 8) * uvStride + mbx * 8];
    uint8_t* vd = &fv[(mby * 8) * uvStride + mbx * 8];
    const int il = f.ilevel, hv = f.hevThresh;
    if (mbx > 0) {
      filterLoop(yd, 1, yStride, 16, limit + 4, il, hv, true);
      filterLoop(ud, 1, uvStride, 8, limit + 4, il, hv, true);
      filterLoop(vd, 1, uvStride, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filterLoop(yd + 4 * k, 1, yStride, 16, limit, il, hv, false);
      filterLoop(ud + 4, 1, uvStride, 8, limit, il, hv, false);
      filterLoop(vd + 4, 1, uvStride, 8, limit, il, hv, false);
    }
    if (mby > 0) {
      filterLoop(yd, yStride, 1, 16, limit + 4, il, hv, true);
      filterLoop(ud, uvStride, 1, 8, limit + 4, il, hv, true);
      filterLoop(vd, uvStride, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filterLoop(yd + 4 * k * yStride, yStride, 1, 16, limit, il, hv, false);
      filterLoop(ud + 4 * uvStride, uvStride, 1, 8, limit, il, hv, false);
      filterLoop(vd + 4 * uvStride, uvStride, 1, 8, limit, il, hv, false);
    }
  }

  // vp8_dec.c::ParseFrame: every row's modes, then its tokens; the
  // reconstruction uses unfiltered samples, and the loop filter runs over
  // the reconstructed picture in macroblock order
  void frame() {
    yStride = mbw_ * 16;
    uvStride = mbw_ * 8;
    y.assign(static_cast<size_t>(yStride) * mbh_ * 16, 0);
    u.assign(static_cast<size_t>(uvStride) * mbh_ * 8, 0);
    v.assign(static_cast<size_t>(uvStride) * mbh_ * 8, 0);
    if (filterType_) filterStrengths();
    std::vector<uint8_t> intraTop(4 * mbw_, B_DC_PRED);
    std::vector<uint32_t> topNz(mbw_, 0), topNzDc(mbw_, 0);
    std::vector<MbData> row(mbw_);
    std::vector<FilterInfo> finfo(static_cast<size_t>(mbw_) * mbh_);
    for (int mby = 0; mby < mbh_; ++mby) {
      uint8_t intraLeft[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mbx = 0; mbx < mbw_; ++mbx) parseIntraMode(row[mbx], &intraTop[4 * mbx], intraLeft);
      if (br_.eof()) corrupt("VP8: premature end of partition 0");
      BoolDecoder& tokens = parts_[mby & (numParts_ - 1)];
      leftNz_ = leftNzDc_ = 0;
      for (int mbx = 0; mbx < mbw_; ++mbx) {
        MbData& block = row[mbx];
        bool skip = useSkipProba_ ? block.skip : false;
        if (!skip) {
          skip = parseResiduals(block, tokens, topNz[mbx], topNzDc[mbx]);
        } else {
          leftNz_ = topNz[mbx] = 0;
          if (!block.i4x4) leftNzDc_ = topNzDc[mbx] = 0;
          block.nonZeroY = block.nonZeroUv = 0;
        }
        if (filterType_) {
          FilterInfo& f = finfo[static_cast<size_t>(mby) * mbw_ + mbx];
          f = strengths_[block.segment][block.i4x4];
          f.inner = f.inner || !skip;
        }
        if (tokens.eof()) corrupt("VP8: premature end of file");
      }
      for (int mbx = 0; mbx < mbw_; ++mbx) reconstruct(row[mbx], mbx, mby);
    }
    if (!filterType_) return;
    std::vector<uint8_t> fy = y, fu = u, fv = v;
    for (int mby = 0; mby < mbh_; ++mby)
      for (int mbx = 0; mbx < mbw_; ++mbx)
        filter(finfo[static_cast<size_t>(mby) * mbw_ + mbx], mbx, mby, fy, fu, fv);
    y.swap(fy);
    u.swap(fu);
    v.swap(fv);
  }

  BoolDecoder br_, parts_[8];
  int numParts_ = 1, mbw_ = 0, mbh_ = 0;
  bool useSegment_ = false, updateMap_ = false, absoluteDelta_ = true;
  int quantizer_[4] = {}, filterStrength_[4] = {};
  uint8_t segmentProba_[3] = {255, 255, 255};
  bool simple_ = false, useLfDelta_ = false;
  int level_ = 0, sharpness_ = 0, filterType_ = 0;
  int refLfDelta_[4] = {}, modeLfDelta_[4] = {};
  Quant quant_[4];
  uint8_t proba_[4][8][3][11];
  bool useSkipProba_ = false;
  int skipProba_ = 0;
  uint32_t leftNz_ = 0, leftNzDc_ = 0;
  FilterInfo strengths_[4][2];
};

// ============================================================ YUV -> RGB
// dsp/yuv.h
inline int multHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clipYuv(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0 ? 0 : 255); }
inline void yuvToRgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = static_cast<uint8_t>(clipYuv(multHi(y, 19077) + multHi(v, 26149) - 14234));
  rgba[1] = static_cast<uint8_t>(clipYuv(multHi(y, 19077) - multHi(u, 6419) - multHi(v, 13320) + 8708));
  rgba[2] = static_cast<uint8_t>(clipYuv(multHi(y, 19077) + multHi(u, 33050) - 17685));
  rgba[3] = 0xff;
}

// dsp/upsampling.c::UPSAMPLE_FUNC: two output rows from two luma rows and
// the chroma rows above (top) and below (cur) them
void upsampleLinePair(const uint8_t* topY, const uint8_t* bottomY, const uint8_t* topU,
                      const uint8_t* topV, const uint8_t* curU, const uint8_t* curV, uint8_t* topDst,
                      uint8_t* bottomDst, int len) {
  auto load = [](int a, int b) { return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16); };
  const int lastPair = (len - 1) >> 1;
  uint32_t tl = load(topU[0], topV[0]), l = load(curU[0], curV[0]);
  {
    const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuvToRgba(topY[0], uv0 & 0xff, uv0 >> 16, topDst);
  }
  if (bottomY) {
    const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
    yuvToRgba(bottomY[0], uv0 & 0xff, uv0 >> 16, bottomDst);
  }
  for (int x = 1; x <= lastPair; ++x) {
    const uint32_t t = load(topU[x], topV[x]), uv = load(curU[x], curV[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag03 = (avg + 2 * (tl + uv)) >> 3;
    {
      const uint32_t uv0 = (diag12 + tl) >> 1, uv1 = (diag03 + t) >> 1;
      yuvToRgba(topY[2 * x - 1], uv0 & 0xff, uv0 >> 16, topDst + (2 * x - 1) * 4);
      yuvToRgba(topY[2 * x], uv1 & 0xff, uv1 >> 16, topDst + (2 * x) * 4);
    }
    if (bottomY) {
      const uint32_t uv0 = (diag03 + l) >> 1, uv1 = (diag12 + uv) >> 1;
      yuvToRgba(bottomY[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottomDst + (2 * x - 1) * 4);
      yuvToRgba(bottomY[2 * x], uv1 & 0xff, uv1 >> 16, bottomDst + (2 * x) * 4);
    }
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
      yuvToRgba(topY[len - 1], uv0 & 0xff, uv0 >> 16, topDst + (len - 1) * 4);
    }
    if (bottomY) {
      const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
      yuvToRgba(bottomY[len - 1], uv0 & 0xff, uv0 >> 16, bottomDst + (len - 1) * 4);
    }
  }
}

// io_dec.c::EmitFancyRGB over the whole picture, into RGBA rows of `stride`
void emitFancyRgb(const LossyDecoder& d, uint8_t* out, size_t stride) {
  const int W = d.width, H = d.height;
  auto Y = [&](int r) { return &d.y[static_cast<size_t>(r) * d.yStride]; };
  auto U = [&](int r) { return &d.u[static_cast<size_t>(r) * d.uvStride]; };
  auto V = [&](int r) { return &d.v[static_cast<size_t>(r) * d.uvStride]; };
  upsampleLinePair(Y(0), nullptr, U(0), V(0), U(0), V(0), out, nullptr, W);
  int y = 0;
  for (; y + 2 < H; y += 2)
    upsampleLinePair(Y(y + 1), Y(y + 2), U(y / 2), V(y / 2), U(y / 2 + 1), V(y / 2 + 1),
                     out + (y + 1) * stride, out + (y + 2) * stride, W);
  if (!(H & 1))
    upsampleLinePair(Y(H - 1), nullptr, U(y / 2), V(y / 2), U(y / 2), V(y / 2), out + (H - 1) * stride,
                     nullptr, W);
}

// ================================================================ ALPH
// alpha_dec.c: the alpha plane of a `VP8 ` frame [height][width]
std::vector<uint8_t> decodeAlpha(const uint8_t* data, size_t size, int width, int height) {
  if (size < 1) corrupt("ALPH: empty chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || reserved != 0) corrupt("ALPH: bad header");
  const size_t pixels = static_cast<size_t>(width) * height;
  std::vector<uint8_t> alpha(pixels);
  if (method == 0) {
    if (size - 1 < pixels) corrupt("ALPH: raw alpha truncated");
    std::memcpy(alpha.data(), data + 1, pixels);
  } else {
    LosslessDecoder lossless(data + 1, size - 1);
    std::vector<uint32_t> argb = lossless.decodeHeaderless(width, height);
    for (size_t i = 0; i < pixels; ++i) alpha[i] = static_cast<uint8_t>(argb[i] >> 8);
  }
  // dsp/filters.c: the unfilters, in place, row by row
  for (int y = 0; y < height && filter; ++y) {
    uint8_t* row = &alpha[static_cast<size_t>(y) * width];
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      int top = prev[0], topLeft = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        const int g = left + top - topLeft;
        left = static_cast<uint8_t>(row[x] + ((g & ~0xff) == 0 ? g : (g < 0 ? 0 : 255)));
        topLeft = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return alpha;
}

// ============================================================ container
struct Chunk {
  uint32_t tag;
  const uint8_t* data;
  size_t size;
  // the payload with its padding byte, as far as the container holds it:
  // demux.c hands a frame's chunks to the decoder padded, and the VP8 and
  // VP8L readers may read into that byte
  size_t padded;
};

constexpr uint32_t fourcc(const char* s) {
  return static_cast<uint32_t>(s[0]) | (static_cast<uint32_t>(s[1]) << 8) |
         (static_cast<uint32_t>(s[2]) << 16) | (static_cast<uint32_t>(s[3]) << 24);
}

// The chunks of [data, data + size), each padded to an even size; a chunk
// that runs past the end is a truncated file.
std::vector<Chunk> chunks(const uint8_t* data, size_t size) {
  std::vector<Chunk> out;
  size_t pos = 0;
  while (pos + 8 <= size) {
    const uint32_t tag = le32(data + pos), length = le32(data + pos + 4);
    if (length > size - pos - 8) corrupt("RIFF chunk truncated");
    out.push_back({tag, data + pos + 8, length, std::min<size_t>(length + (length & 1), size - pos - 8)});
    pos += 8 + static_cast<size_t>(length) + (length & 1);
  }
  return out;  // fewer than 8 bytes after the last chunk are not a chunk
}

// One frame's image: an optional ALPH chunk, then `VP8 ` or `VP8L`.
struct Frame {
  const Chunk* alpha = nullptr;
  const Chunk* image = nullptr;
  int x = 0, y = 0;
};

// A frame's size from its bitstream's header, with the checks of
// VP8GetInfo / VP8LGetInfo that demux.c runs on every frame of a file.
int frameWidth(const Chunk& c, int& height) {
  if (c.tag == fourcc("VP8L")) {
    if (c.size < 5 || c.data[0] != 0x2f || (c.data[4] >> 5) != 0) corrupt("VP8L: bad header");
    const uint32_t bits = le32(c.data + 1);
    height = static_cast<int>((bits >> 14) & 0x3fff) + 1;
    return static_cast<int>(bits & 0x3fff) + 1;
  }
  if (c.size < 10 || c.data[3] != 0x9d || c.data[4] != 0x01 || c.data[5] != 0x2a)
    corrupt("VP8: bad header");
  const uint32_t bits = le24(c.data);
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= c.size)
    corrupt("VP8: bad frame header");
  height = le16(c.data + 8) & 0x3fff;
  const int width = le16(c.data + 6) & 0x3fff;
  if (width == 0 || height == 0) corrupt("VP8: empty picture");
  return width;
}

// webp_dec.c::DecodeInto with MODE_RGBA, into rows of `stride` bytes
void decodeFrame(const Frame& f, uint8_t* out, size_t stride) {
  if (f.image->tag == fourcc("VP8L")) {
    int width, height;
    LosslessDecoder d(f.image->data, f.image->padded);
    std::vector<uint32_t> argb = d.decodeFile(width, height);
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        const uint32_t p = argb[static_cast<size_t>(y) * width + x];
        uint8_t* o = out + y * stride + 4 * x;
        o[0] = static_cast<uint8_t>(p >> 16);
        o[1] = static_cast<uint8_t>(p >> 8);
        o[2] = static_cast<uint8_t>(p);
        o[3] = static_cast<uint8_t>(p >> 24);
      }
    return;
  }
  LossyDecoder d;
  d.decode(f.image->data, f.image->padded);
  emitFancyRgb(d, out, stride);
  if (f.alpha) {
    std::vector<uint8_t> alpha = decodeAlpha(f.alpha->data, f.alpha->size, d.width, d.height);
    for (int y = 0; y < d.height; ++y)
      for (int x = 0; x < d.width; ++x) out[y * stride + 4 * x + 3] = alpha[static_cast<size_t>(y) * d.width + x];
  }
}

// The frame's image chunks from `list` starting at `i` (demux.c::StoreFrame);
// no image where the chunks hold none
Frame storeFrame(const std::vector<Chunk>& list, size_t i) {
  Frame f;
  for (; i < list.size(); ++i) {
    const uint32_t tag = list[i].tag;
    if (tag == fourcc("ALPH")) {
      if (!f.alpha && !f.image) f.alpha = &list[i];
    } else if (tag == fourcc("VP8L")) {
      if (f.alpha) corrupt("WebP: ALPH before VP8L");
      if (f.image) break;
      f.image = &list[i];
    } else if (tag == fourcc("VP8 ")) {
      if (f.image) break;
      f.image = &list[i];
    } else {
      break;
    }
    if (f.image) break;
  }
  return f;
}

class WebpFile {
 public:
  WebpFile(const uint8_t* data, size_t size) {
    if (size < 12 || std::memcmp(data, "RIFF", 4) != 0 || std::memcmp(data + 8, "WEBP", 4) != 0)
      corrupt("not a WebP file (no RIFF WEBP header)");
    const uint32_t riff = le32(data + 4);
    if (riff < 12) corrupt("RIFF size too small");
    if (static_cast<size_t>(riff) + 8 > size) corrupt("WebP file truncated (RIFF size past the end)");
    list_ = chunks(data + 12, riff - 4);
    if (list_.empty()) corrupt("WebP file without chunks");
    const uint32_t first = list_[0].tag;
    if (first == fourcc("VP8 ") || first == fourcc("VP8L")) {
      frame_ = storeFrame(list_, 0);  // its first chunk is the image
      width = frameWidth(*frame_.image, height);
    } else if (first == fourcc("VP8X")) {
      extended();
    } else {
      corrupt("WebP file whose first chunk is not VP8, VP8L or VP8X");
    }
    if (width <= 0 || height <= 0) corrupt("WebP picture of size 0");
    if (int64_t(width) * height > kMaxPixels) corrupt("WebP picture past the pixel limit");
  }

  void decode(uint8_t* rgba) const {
    const size_t stride = static_cast<size_t>(width) * 4;
    std::memset(rgba, 0, stride * height);  // anim_decode.c::ZeroFillCanvas
    decodeFrame(frame_, rgba + frame_.y * stride + 4 * frame_.x, stride);
  }

  int width = 0, height = 0;

 private:
  // demux.c::ParseVP8XChunks and IsValidExtendedFormat, for frame 0
  void extended() {
    const Chunk& vp8x = list_[0];
    if (vp8x.size < 10) corrupt("VP8X chunk too small");
    const uint32_t flags = vp8x.data[0];
    if (flags & ~0x3Eu) corrupt("VP8X: reserved flags set");
    const bool animation = flags & 0x02;
    width = static_cast<int>(le24(vp8x.data + 4)) + 1;
    height = static_cast<int>(le24(vp8x.data + 7)) + 1;
    bool found = false, sawAnim = false;
    for (size_t i = 1; i < list_.size(); ++i) {
      const uint32_t tag = list_[i].tag;
      if (tag == fourcc("VP8X")) corrupt("WebP: a second VP8X chunk");
      if (tag == fourcc("ALPH") || tag == fourcc("VP8 ") || tag == fourcc("VP8L")) {
        if (animation || sawAnim) corrupt("WebP: image data outside a frame of an animation");
        if (found) corrupt("WebP: a second image in a still file");
        frame_ = storeFrame(list_, i);
        if (!frame_.image) corrupt("WebP: ALPH without image data");
        i = static_cast<size_t>(frame_.image - list_.data());  // past ALPH and the image
        int h;
        const int w = frameWidth(*frame_.image, h);
        if (w != width || h != height) corrupt("WebP: image size differs from the canvas");
        found = true;
      } else if (tag == fourcc("ANIM")) {
        if (list_[i].size < 6) corrupt("ANIM chunk too small");
        sawAnim = true;
      } else if (tag == fourcc("ANMF")) {
        // demux.c::ParseAnimationFrame: every frame is checked, frame 0 kept
        if (!sawAnim) corrupt("ANMF before ANIM");
        if (!animation) continue;
        const Chunk& anmf = list_[i];
        if (anmf.size < 16) corrupt("ANMF chunk too small");
        std::vector<Chunk> inner = chunks(anmf.data + 16, anmf.size - 16);
        Frame f = storeFrame(inner, 0);
        if (!f.image) continue;  // demux.c adds no frame without image data
        f.x = 2 * static_cast<int>(le24(anmf.data));
        f.y = 2 * static_cast<int>(le24(anmf.data + 3));
        int h;
        const int w = frameWidth(*f.image, h);
        if (f.x + w > width || f.y + h > height) corrupt("WebP: frame outside the canvas");
        if (frames_++ == 0) {
          frameChunks_ = std::move(inner);
          frame_ = storeFrame(frameChunks_, 0);
          frame_.x = f.x;
          frame_.y = f.y;
        }
      }
    }
    if (frames_) found = true;
    if (!found) corrupt("WebP: no frame");
  }

  std::vector<Chunk> list_, frameChunks_;
  Frame frame_;
  int frames_ = 0;
};

int fail(const Failure& f, char* err, int32_t errLen) {
  if (err && errLen > 0) std::snprintf(err, static_cast<size_t>(errLen), "%s", f.message.c_str());
  return f.status;
}

}  // namespace

extern "C" {

enum { MCQ_WEBP_OK = 0, MCQ_WEBP_CORRUPT = 2, MCQ_WEBP_TOO_SMALL = 3 };

// dims <- [height, width]. Returns a status; on failure `err` holds the message.
int mcq_webp_header(const uint8_t* data, int64_t size, int32_t* dims, char* err, int32_t errLen) {
  try {
    WebpFile f(data, static_cast<size_t>(size));
    dims[0] = f.height;
    dims[1] = f.width;
    return MCQ_WEBP_OK;
  } catch (const Failure& f) {
    return fail(f, err, errLen);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, err, errLen);
  }
}

// Decode frame 0 on its canvas into rgba [height, width, 4] uint8 (outSize bytes).
int mcq_webp_decode(const uint8_t* data, int64_t size, uint8_t* rgba, int64_t outSize, char* err,
                    int32_t errLen) {
  try {
    WebpFile f(data, static_cast<size_t>(size));
    if (static_cast<int64_t>(f.height) * f.width * 4 != outSize)
      return fail(Failure{kTooSmall, "output buffer has the wrong size"}, err, errLen);
    f.decode(rgba);
    return MCQ_WEBP_OK;
  } catch (const Failure& f) {
    return fail(f, err, errLen);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, err, errLen);
  }
}

}  // extern "C"
