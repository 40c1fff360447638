// mcquic_tpu_torch JPEG codec (C++17, C ABI for ctypes).
//
// The decoder reads every JPEG that `PIL.Image.open(f).convert("RGB")` reads
// on libjpeg-turbo 3.1 and returns RGB, bit-identical to that call:
// sequential (SOF0, SOF1) and progressive (SOF2) Huffman files, the same
// with arithmetic coding (SOF9, SOF10, DAC), and lossless files (SOF3), at
// 8-bit precision with 1, 3 or 4 components and sampling factors up to 4.
// It follows libjpeg-turbo's integer paths with the defaults PIL uses:
//   * jdhuff.c: Huffman decoding, restart markers, DC prediction;
//   * jdphuff.c: the four progressive scan kinds (DC first, DC refine, AC
//     first with end-of-band runs, AC refine with correction bits) into a
//     coefficient buffer over the whole image, which the baseline path fills
//     too; a restart resets the DC predictions and the end-of-band run;
//   * jdarith.c: the QM decoder of T.81 Annex D (jaricom.c's table), the DC
//     and AC statistics areas, the DAC conditioning (L, U, Kx), the four
//     progressive scan kinds, restarts that reset the statistics, and the
//     decoder's "spectral or magnitude overflow", after which the rest of the
//     scan is left as decoded so far (libjpeg warns and goes on);
//   * jdlhuff.c, jddiffct.c and jdlossls.c for lossless files: the seven
//     predictors, the first-row and first-column rules, restarts that start a
//     first row again, the point transform; libjpeg-turbo converts no colour
//     in lossless mode, so a lossless file it would have to convert (JFIF
//     YCbCr, YCCK) is refused as PIL refuses it, and upsampling is plain
//     replication (do_fancy needs a DCT);
//   * jdcoefct.c::decompress_smooth_data: block smoothing of a progressive
//     file whose scans leave any of the first ten coefficients of a component
//     inexact, over the 5x5 neighbourhood of DC values libjpeg-turbo 2.1 and
//     later use, with the DC interpolation where no AC data came;
//   * jdinput.c::latch_quant_tables: a component's quantization table is
//     the one defined when its first scan starts;
//   * jidctint.c::jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, the
//     dequantization in the first pass, the all-zero column and row shortcuts,
//     and the post-IDCT range-limit table indexed with RANGE_MASK;
//   * jdsample.c: h2v1_fancy_upsample and h2v2_fancy_upsample where the
//     downsampled width exceeds 2 (box upsampling otherwise),
//     h1v2_fancy_upsample, and int_upsample for every other integral ratio;
//     jdmainct.c's context rows: the row above the first is the first, the row
//     below the last real downsampled row is that row;
//   * jdcolor.c::ycc_rgb_convert with its 16-bit fixed-point tables, and
//     ycck_cmyk_convert; a 4-component file is read as PIL reads it (CMYK,
//     "CMYK;I": each sample inverted), then PIL's cmyk2rgb;
//   * jdapimin.c::default_decompress_parms for the colour space (JFIF means
//     YCbCr, Adobe transform 0 means RGB, then the component ids; 4
//     components are CMYK unless an Adobe marker's transform is nonzero).
// Every file libjpeg or PIL refuses returns MCQ_JPEG_CORRUPT, as truncated
// or corrupt data does: 12-bit and 2-component files (PIL reads 8-bit
// files of 1, 3 or 4 components only), hierarchical files, a height of 0
// (the height a DNL marker would set), interleaved scans of more than ten
// blocks per MCU, fractional sampling ratios, lossless files that need a
// colour conversion or whose restart interval is not a whole number of MCU
// rows, lossless arithmetic coding (SOF11). A DNL marker after a scan is
// skipped, as libjpeg skips it. No valid file returns MCQ_JPEG_UNSUPPORTED.
//
// The encoder writes what `PIL.Image.save(f, "JPEG", quality=q)` writes for
// an RGB image, byte for byte: SOI, JFIF APP0 1.01 (density 1x1, no unit),
// DQT, SOF0, DHT, SOS and EOI in jcmarker.c's order; the quality scaling of
// jcparam.c with force_baseline; jccolor.c::rgb_ycc_convert; 4:2:0 by
// jcsample.c::h2v2_downsample with the right-edge expansion and jcprepct.c's
// bottom-edge replication; jfdctint.c::jpeg_fdct_islow and jcdctmgr.c's
// reciprocal quantization; jccoefct.c's dummy edge blocks; the standard
// Huffman tables of jstdhuff.c, not optimized.
//
// Every entry point is reentrant: the tables are built once, thread-safe, and
// a call keeps its state on its own stack and heap, so several threads may
// decode at once.
//
// Build: see ../data/jpeg.py (g++ -O3 -std=c++17 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr int64_t kMaxPixels = 2 * 89478485;

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2, kTooSmall = 3 };

struct Failure {
  Status status;
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) { throw Failure{kCorrupt, message}; }

std::string hexMarker(int marker) {
  char buf[16];
  std::snprintf(buf, sizeof buf, "0xFF%02X", marker);
  return buf;
}

// Zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries of 63 that catch a run past the block's end in corrupt data.
constexpr int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------- shared tables
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct Tables {
  // jdmaster.c::prepare_range_limit_table, the post-IDCT part: indexed by
  // (x & 1023) where x is the IDCT's output before the +128 level shift.
  uint8_t idctLimit[1024];
  // jdcolor.c::build_ycc_rgb_table
  int crR[256], cbB[256];
  int64_t crG[256], cbG[256];
  // jccolor.c::rgb_ycc_start
  int64_t rgbYcc[8 * 256];

  Tables() {
    for (int x = 0; x < 1024; ++x) {
      int v;
      if (x < 128) v = x + 128;
      else if (x < 512) v = 255;
      else if (x < 896) v = 0;
      else v = x - 896;
      idctLimit[x] = static_cast<uint8_t>(v);
    }
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      crR[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cbB[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      crG[i] = -fix(0.71414) * x;
      cbG[i] = -fix(0.34414) * x + kHalf;
    }
    const int64_t cbcrOffset = int64_t(128) << kScale;
    for (int i = 0; i < 256; ++i) {
      rgbYcc[i + 0 * 256] = fix(0.29900) * i;
      rgbYcc[i + 1 * 256] = fix(0.58700) * i;
      rgbYcc[i + 2 * 256] = fix(0.11400) * i + kHalf;
      rgbYcc[i + 3 * 256] = -fix(0.16874) * i;
      rgbYcc[i + 4 * 256] = -fix(0.33126) * i;
      rgbYcc[i + 5 * 256] = fix(0.50000) * i + cbcrOffset + kHalf - 1;  // B=>Cb and R=>Cr
      rgbYcc[i + 6 * 256] = -fix(0.41869) * i;
      rgbYcc[i + 7 * 256] = -fix(0.08131) * i;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clampByte(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ===================================================================== decoder
struct HuffTable {
  bool defined = false;
  uint8_t lookLen[512];   // 9-bit lookahead: code length (0: longer than 9 bits)
  uint8_t lookSym[512];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];
  uint8_t huffval[256];
};

void buildHuffTable(HuffTable& t, const uint8_t* bits, const uint8_t* vals, int count) {
  // jdhuff.c::jpeg_make_d_derived_tbl
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) corrupt("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t.valoffset[l] = p - huffcode[p];
      p += bits[l - 1];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.lookLen, 0, sizeof t.lookLen);
  std::memcpy(t.huffval, vals, count);
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr, ++lookbits) {
        t.lookLen[lookbits] = static_cast<uint8_t>(l);
        t.lookSym[lookbits] = vals[p];
      }
    }
  }
  t.defined = true;
}

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos) : data_(data), size_(size), pos_(pos) {}

  size_t position() const { return pos_; }

  void fill() {
    while (count_ <= 56) {
      int byte = 0;
      if (marker_ || pos_ >= size_) {
        if (!marker_ && pos_ >= size_) truncated_ = true;
        pad_ += 8;
      } else {
        byte = data_[pos_];
        if (byte == 0xFF) {
          size_t next = pos_ + 1;
          while (next < size_ && data_[next] == 0xFF) ++next;  // fill bytes
          if (next >= size_) {
            truncated_ = true;
            pad_ += 8;
            byte = 0;
            pos_ = size_;
          } else if (data_[next] == 0x00) {
            pos_ = next + 1;
          } else {
            marker_ = true;
            pos_ = next - 1;  // at the 0xFF of the marker
            pad_ += 8;
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      buffer_ |= static_cast<uint64_t>(byte) << (56 - count_);
      count_ += 8;
    }
  }

  int peek(int n) {
    if (count_ < n) fill();
    return static_cast<int>(buffer_ >> (64 - n));
  }

  void skip(int n) {
    buffer_ <<= n;
    count_ -= n;
    if (count_ < pad_) {
      if (truncated_) corrupt("entropy-coded data truncated");
      corrupt("entropy-coded data runs into a marker");
    }
  }

  int bits(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }

  int decode(const HuffTable& t) {
    int look = peek(9);
    int len = t.lookLen[look];
    if (len) {
      skip(len);
      return t.lookSym[look];
    }
    int code = peek(16);
    int l = 10;
    while (l <= 16 && (code >> (16 - l)) > t.maxcode[l]) ++l;
    if (l > 16) corrupt("bad Huffman code");
    skip(l);
    return t.huffval[((code >> (16 - l)) + t.valoffset[l]) & 0xFF];
  }

  // jdhuff.c::process_restart: drop the bits left in the buffer, then step
  // over the next marker, which must be `want` (a restart marker).
  void restart(int want) {
    buffer_ = 0;
    count_ = pad_ = 0;
    if (!marker_) pos_ = finish();
    marker_ = false;
    while (pos_ < size_ && data_[pos_] == 0xFF) ++pos_;
    if (pos_ >= size_) corrupt("entropy-coded data truncated before a restart marker");
    int marker = data_[pos_++];
    if (marker != want)
      corrupt("expected restart marker " + hexMarker(want) + ", found " + hexMarker(marker));
  }

  // The position of the marker that ends the scan.
  size_t finish() {
    if (marker_) return pos_;
    size_t pos = pos_;
    while (pos < size_ && !(data_[pos] == 0xFF && pos + 1 < size_ && data_[pos + 1] != 0x00 &&
                            data_[pos + 1] != 0xFF))
      ++pos;
    return pos;
  }

 private:
  const uint8_t* data_;
  size_t size_, pos_;
  uint64_t buffer_ = 0;
  int count_ = 0, pad_ = 0;
  bool marker_ = false, truncated_ = false;
};

// jaricom.c: T.81 Table D.2, each entry Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate.
constexpr uint32_t arithEntry(uint32_t qe, uint32_t nlps, uint32_t nmps, uint32_t sw) {
  return (qe << 16) | (nmps << 8) | (sw << 7) | nlps;
}
constexpr uint32_t kAriTab[114] = {
    arithEntry(0x5a1d, 1, 1, 1),      arithEntry(0x2586, 14, 2, 0),
    arithEntry(0x1114, 16, 3, 0),     arithEntry(0x080b, 18, 4, 0),
    arithEntry(0x03d8, 20, 5, 0),     arithEntry(0x01da, 23, 6, 0),
    arithEntry(0x00e5, 25, 7, 0),     arithEntry(0x006f, 28, 8, 0),
    arithEntry(0x0036, 30, 9, 0),     arithEntry(0x001a, 33, 10, 0),
    arithEntry(0x000d, 35, 11, 0),    arithEntry(0x0006, 9, 12, 0),
    arithEntry(0x0003, 10, 13, 0),    arithEntry(0x0001, 12, 13, 0),
    arithEntry(0x5a7f, 15, 15, 1),    arithEntry(0x3f25, 36, 16, 0),
    arithEntry(0x2cf2, 38, 17, 0),    arithEntry(0x207c, 39, 18, 0),
    arithEntry(0x17b9, 40, 19, 0),    arithEntry(0x1182, 42, 20, 0),
    arithEntry(0x0cef, 43, 21, 0),    arithEntry(0x09a1, 45, 22, 0),
    arithEntry(0x072f, 46, 23, 0),    arithEntry(0x055c, 48, 24, 0),
    arithEntry(0x0406, 49, 25, 0),    arithEntry(0x0303, 51, 26, 0),
    arithEntry(0x0240, 52, 27, 0),    arithEntry(0x01b1, 54, 28, 0),
    arithEntry(0x0144, 56, 29, 0),    arithEntry(0x00f5, 57, 30, 0),
    arithEntry(0x00b7, 59, 31, 0),    arithEntry(0x008a, 60, 32, 0),
    arithEntry(0x0068, 62, 33, 0),    arithEntry(0x004e, 63, 34, 0),
    arithEntry(0x003b, 32, 35, 0),    arithEntry(0x002c, 33, 9, 0),
    arithEntry(0x5ae1, 37, 37, 1),    arithEntry(0x484c, 64, 38, 0),
    arithEntry(0x3a0d, 65, 39, 0),    arithEntry(0x2ef1, 67, 40, 0),
    arithEntry(0x261f, 68, 41, 0),    arithEntry(0x1f33, 69, 42, 0),
    arithEntry(0x19a8, 70, 43, 0),    arithEntry(0x1518, 72, 44, 0),
    arithEntry(0x1177, 73, 45, 0),    arithEntry(0x0e74, 74, 46, 0),
    arithEntry(0x0bfb, 75, 47, 0),    arithEntry(0x09f8, 77, 48, 0),
    arithEntry(0x0861, 78, 49, 0),    arithEntry(0x0706, 79, 50, 0),
    arithEntry(0x05cd, 48, 51, 0),    arithEntry(0x04de, 50, 52, 0),
    arithEntry(0x040f, 50, 53, 0),    arithEntry(0x0363, 51, 54, 0),
    arithEntry(0x02d4, 52, 55, 0),    arithEntry(0x025c, 53, 56, 0),
    arithEntry(0x01f8, 54, 57, 0),    arithEntry(0x01a4, 55, 58, 0),
    arithEntry(0x0160, 56, 59, 0),    arithEntry(0x0125, 57, 60, 0),
    arithEntry(0x00f6, 58, 61, 0),    arithEntry(0x00cb, 59, 62, 0),
    arithEntry(0x00ab, 61, 63, 0),    arithEntry(0x008f, 61, 32, 0),
    arithEntry(0x5b12, 65, 65, 1),    arithEntry(0x4d04, 80, 66, 0),
    arithEntry(0x412c, 81, 67, 0),    arithEntry(0x37d8, 82, 68, 0),
    arithEntry(0x2fe8, 83, 69, 0),    arithEntry(0x293c, 84, 70, 0),
    arithEntry(0x2379, 86, 71, 0),    arithEntry(0x1edf, 87, 72, 0),
    arithEntry(0x1aa9, 87, 73, 0),    arithEntry(0x174e, 72, 74, 0),
    arithEntry(0x1424, 72, 75, 0),    arithEntry(0x119c, 74, 76, 0),
    arithEntry(0x0f6b, 74, 77, 0),    arithEntry(0x0d51, 75, 78, 0),
    arithEntry(0x0bb6, 77, 79, 0),    arithEntry(0x0a40, 77, 48, 0),
    arithEntry(0x5832, 80, 81, 1),    arithEntry(0x4d1c, 88, 82, 0),
    arithEntry(0x438e, 89, 83, 0),    arithEntry(0x3bdd, 90, 84, 0),
    arithEntry(0x34ee, 91, 85, 0),    arithEntry(0x2eae, 92, 86, 0),
    arithEntry(0x299a, 93, 87, 0),    arithEntry(0x2516, 86, 71, 0),
    arithEntry(0x5570, 88, 89, 1),    arithEntry(0x4ca9, 95, 90, 0),
    arithEntry(0x44d9, 96, 91, 0),    arithEntry(0x3e22, 97, 92, 0),
    arithEntry(0x3824, 99, 93, 0),    arithEntry(0x32b4, 99, 94, 0),
    arithEntry(0x2e17, 93, 86, 0),    arithEntry(0x56a8, 95, 96, 1),
    arithEntry(0x4f46, 101, 97, 0),   arithEntry(0x47e5, 102, 98, 0),
    arithEntry(0x41cf, 103, 99, 0),   arithEntry(0x3c3d, 104, 100, 0),
    arithEntry(0x375e, 99, 93, 0),    arithEntry(0x5231, 105, 102, 0),
    arithEntry(0x4c0f, 106, 103, 0),  arithEntry(0x4639, 107, 104, 0),
    arithEntry(0x415e, 103, 99, 0),   arithEntry(0x5627, 105, 106, 1),
    arithEntry(0x50e7, 108, 107, 0),  arithEntry(0x4b85, 109, 103, 0),
    arithEntry(0x5597, 110, 109, 0),  arithEntry(0x504f, 111, 107, 0),
    arithEntry(0x5a10, 110, 111, 1),  arithEntry(0x5522, 112, 109, 0),
    arithEntry(0x59eb, 112, 111, 1),  arithEntry(0x5a1d, 113, 113, 0)};

// jdarith.c::arith_decode and its byte input: past a marker the decoder
// reads zeros (legal in arithmetic coding); past the end of the data the
// file is truncated, which PIL refuses.
class ArithReader {
 public:
  ArithReader(const uint8_t* data, size_t size, size_t pos) : data_(data), size_(size), pos_(pos) {}

  int decode(uint8_t* st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        int byte = 0;
        if (!marker_) {
          byte = next();
          if (byte == 0xFF) {
            size_t at = pos_ - 1;
            do byte = next();
            while (byte == 0xFF);
            if (byte == 0) {
              byte = 0xFF;
            } else {
              marker_ = true;
              markerPos_ = at;
              byte = 0;
            }
          }
        }
        c_ = (c_ << 8) | byte;
        if ((ct_ += 8) < 0)
          if (++ct_ == 0) a_ = 0x8000;
      }
      a_ <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    uint8_t nl = qe & 0xFF;
    qe >>= 8;
    uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdarith.c::process_restart's reader part: find the next marker, which
  // must be `want`, and start decoding afresh after it.
  void restart(int want) {
    size_t pos = marker_ ? markerPos_ : nextMarkerFrom(pos_);
    while (pos < size_ && data_[pos] == 0xFF) ++pos;
    if (pos >= size_) corrupt("entropy-coded data truncated before a restart marker");
    int marker = data_[pos];
    if (marker != want)
      corrupt("expected restart marker " + hexMarker(want) + ", found " + hexMarker(marker));
    pos_ = pos + 1;
    marker_ = false;
    c_ = a_ = 0;
    ct_ = -16;
  }

  size_t finish() const { return marker_ ? markerPos_ : nextMarkerFrom(pos_); }

  bool failed() const { return ct_ == -1; }
  void fail() { ct_ = -1; }

 private:
  int next() {
    if (pos_ >= size_) corrupt("entropy-coded data truncated");
    return data_[pos_++];
  }

  size_t nextMarkerFrom(size_t pos) const {
    while (pos < size_ && !(data_[pos] == 0xFF && pos + 1 < size_ && data_[pos + 1] != 0x00 &&
                            data_[pos + 1] != 0xFF))
      ++pos;
    return pos;
  }

  const uint8_t* data_;
  size_t size_, pos_, markerPos_ = 0;
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16;
  bool marker_ = false;
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jidctint.c::jpeg_idct_islow
void idctIslow(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride) {
  const uint8_t* limit = tables().idctLimit;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (in[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
    ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
    ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
    ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
    ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  constexpr int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = limit[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = limit[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = limit[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = limit[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = limit[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = limit[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = limit[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = limit[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int blocksW = 0, blocksH = 0;     // allocated blocks (interleaved MCU cover); samples when lossless
  int realBlocksW = 0, realBlocksH = 0;
  int width = 0, height = 0;        // downsampled size of the real samples
  std::vector<int16_t> coefs;       // blocksH * blocksW * 64, natural order
  std::vector<uint16_t> diffs;      // lossless: blocksH * blocksW differences, then samples
  bool seen = false;
  int dcTable = 0, acTable = 0;
  int16_t quant[64] = {};           // latched at the component's first scan
  int coefBits[64];                 // progressive: the last scan's Al per coefficient, -1 unsent
};

// jdcoefct.c: the natural positions of the first ten coefficients in zigzag
// order, whose quantizers block smoothing divides by.
constexpr int kQ01 = 1, kQ10 = 8, kQ20 = 16, kQ11 = 9, kQ02 = 2, kQ03 = 3, kQ12 = 10, kQ21 = 17,
              kQ30 = 24;

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  void readHeaders() {
    if (size_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8) corrupt("not a JPEG (no SOI marker)");
    pos_ = 2;
    while (true) {
      int marker = nextMarker();
      if (marker == 0xDA) {  // the first scan: the frame is known
        if (!frame_) corrupt("SOS before SOF");
        scanStart_ = pos_;
        return;
      }
      segment(marker);
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }
  int components() const { return static_cast<int>(comps_.size()); }

  void decode(uint8_t* rgb) {
    colorSpace();
    pos_ = scanStart_;
    int marker = 0xDA;
    while (true) {
      if (marker == 0xDA) {
        scan();
      } else if (marker == 0xD9) {
        break;
      } else {
        segment(marker);
      }
      marker = nextMarker();
    }
    for (auto& c : comps_)
      if (!c.seen) corrupt("component " + std::to_string(c.id) + " has no scan");
    smoothing_ = smoothingOk();
    output(rgb);
  }

 private:
  enum Space { kGray, kRgb, kYcc, kCmyk, kYcck };

  int nextMarker() {
    // skip anything up to the next 0xFF (libjpeg warns about such bytes),
    // then the fill bytes
    while (pos_ < size_ && data_[pos_] != 0xFF) ++pos_;
    while (pos_ < size_ && data_[pos_] == 0xFF) ++pos_;
    if (pos_ >= size_) corrupt("truncated: no EOI marker");
    return data_[pos_++];
  }

  size_t segmentLength() {
    if (pos_ + 2 > size_) corrupt("truncated marker segment");
    size_t length = (data_[pos_] << 8) | data_[pos_ + 1];
    if (length < 2 || pos_ + length > size_) corrupt("truncated marker segment");
    return length;
  }

  void segment(int marker) {
    if (marker == 0xD8) corrupt("a second SOI marker");
    if (marker >= 0xD0 && marker <= 0xD7) return;  // a stray restart marker
    if (marker == 0x01) return;                    // TEM
    size_t length = segmentLength();
    const uint8_t* p = data_ + pos_ + 2;
    size_t n = length - 2;
    switch (marker) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
        frame(marker, p, n);
        break;
      case 0xCB:
        corrupt("lossless arithmetic-coded JPEG (SOF marker 0xFFCB), which libjpeg-turbo does "
                "not read");
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        corrupt("hierarchical JPEG (SOF marker " + hexMarker(marker) +
                "), which libjpeg does not read");
      case 0xCC:
        arithConditioning(p, n);
        break;
      case 0xC4:
        huffmanTables(p, n);
        break;
      case 0xDB:
        quantTables(p, n);
        break;
      case 0xDD:
        if (n < 2) corrupt("bad DRI segment");
        restartInterval_ = (p[0] << 8) | p[1];
        break;
      case 0xE0:
        if (n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) sawJfif_ = true;
        break;
      case 0xEE:
        if (n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          sawAdobe_ = true;
          adobeTransform_ = p[11];
        }
        break;
      case 0xDC:
        break;  // DNL: jdmarker.c skips it
      case 0xDE: case 0xDF:
        corrupt("hierarchical JPEG (marker " + hexMarker(marker) + "), which libjpeg does not read");
      default:
        if (!(marker >= 0xE0 && marker <= 0xEF) && marker != 0xFE)
          corrupt("unknown marker " + hexMarker(marker));
        break;  // APPn, COM
    }
    pos_ += length;
  }

  void frame(int marker, const uint8_t* p, size_t n) {
    if (frame_) corrupt("a second SOF marker");
    if (n < 6) corrupt("bad SOF segment");
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    lossless_ = marker == 0xC3;
    int precision = p[0];
    if (precision != 8)
      corrupt(std::to_string(precision) + "-bit JPEG (SOF marker " + hexMarker(marker) +
              "); PIL reads 8-bit files only");
    height_ = (p[1] << 8) | p[2];
    width_ = (p[3] << 8) | p[4];
    int count = p[5];
    if (count != 1 && count != 3 && count != 4)
      corrupt(std::to_string(count) + "-component JPEG (SOF marker " + hexMarker(marker) +
              "); PIL reads 1, 3 or 4 components");
    if (height_ == 0) corrupt("JPEG of height 0 (a height set by a DNL marker), which libjpeg refuses");
    if (width_ == 0) corrupt("JPEG of width 0");
    // PIL's decompression-bomb limit (2 * Image.MAX_IMAGE_PIXELS), past which
    // PIL refuses to open a file: a corrupt header allocates nothing huge
    if (int64_t(width_) * height_ > kMaxPixels)
      corrupt(std::to_string(int64_t(width_) * height_) + " pixels exceed the limit of " +
              std::to_string(kMaxPixels));
    if (n < static_cast<size_t>(6 + 3 * count)) corrupt("bad SOF segment");
    comps_.resize(count);
    for (int i = 0; i < count; ++i) {
      Component& c = comps_[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad SOF component");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    // jdsample.c: only integral ratios (JERR_FRACT_SAMPLE_NOTIMPL)
    for (auto& c : comps_)
      if (hmax_ % c.h || vmax_ % c.v)
        corrupt("JPEG with fractional sampling ratios, which libjpeg does not read");
    const int unit = lossless_ ? 1 : 8;
    mcusX_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcusY_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (auto& c : comps_) {
      c.width = static_cast<int>((int64_t(width_) * c.h + hmax_ - 1) / hmax_);
      c.height = static_cast<int>((int64_t(height_) * c.v + vmax_ - 1) / vmax_);
      c.realBlocksW = (c.width + unit - 1) / unit;
      c.realBlocksH = (c.height + unit - 1) / unit;
      c.blocksW = mcusX_ * c.h;
      c.blocksH = mcusY_ * c.v;
      if (lossless_) c.diffs.assign(static_cast<size_t>(c.blocksW) * c.blocksH, 0);
      else c.coefs.assign(static_cast<size_t>(c.blocksW) * c.blocksH * 64, 0);
      std::fill(c.coefBits, c.coefBits + 64, -1);
    }
    frame_ = true;
  }

  // jdapimin.c::default_decompress_parms, and the conversions libjpeg-turbo
  // refuses in lossless mode
  void colorSpace() {
    if (comps_.size() == 1) {
      space_ = kGray;
    } else if (comps_.size() == 3) {
      if (sawJfif_) space_ = kYcc;
      else if (sawAdobe_) space_ = adobeTransform_ == 0 ? kRgb : kYcc;
      else space_ = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66 ? kRgb : kYcc;
    } else {
      space_ = sawAdobe_ && adobeTransform_ != 0 ? kYcck : kCmyk;
    }
    if (lossless_ && (space_ == kYcc || space_ == kYcck))
      corrupt("lossless JPEG in YCbCr or YCCK (SOF marker 0xFFC3): libjpeg-turbo converts no colour "
              "in lossless mode");
  }

  void huffmanTables(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      if (i + 17 > n) corrupt("bad DHT segment");
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT table index");
      const uint8_t* bits = p + i + 1;
      int count = 0;
      for (int l = 0; l < 16; ++l) count += bits[l];
      if (count > 256 || i + 17 + count > n) corrupt("bad DHT segment");
      buildHuffTable(huff_[tc][th], bits, p + i + 17, count);
      i += 17 + count;
    }
  }

  // jdmarker.c::get_dac
  void arithConditioning(const uint8_t* p, size_t n) {
    if (n % 2) corrupt("bad DAC segment");
    for (size_t i = 0; i < n; i += 2) {
      int index = p[i], value = p[i + 1];
      if (index >= 32) corrupt("bad DAC table index");  // Tc << 4 | Tb, NUM_ARITH_TBLS 16
      if (index >= 16) {
        acK_[index - 16] = value;
      } else {
        dcL_[index] = value & 15;
        dcU_[index] = value >> 4;
        if (dcL_[index] > dcU_[index]) corrupt("bad DAC value");
      }
    }
  }

  void quantTables(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      if (pq > 1 || tq > 3) corrupt("bad DQT segment");
      size_t need = 1 + 64 * (pq + 1);
      if (i + need > n) corrupt("bad DQT segment");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (p[i + 1 + 2 * k] << 8) | p[i + 2 + 2 * k] : p[i + 1 + k];
        // ISLOW_MULT_TYPE is a short in libjpeg-turbo
        quant_[tq][kNaturalOrder[k]] = static_cast<int16_t>(v);
      }
      quantDefined_[tq] = true;
      i += need;
    }
  }

  // Calls unit(component, index in scan, block or sample index) for every
  // unit of a scan in order, and between(last) after each MCU.
  template <class Unit, class Between>
  void forEachMcu(const std::vector<Component*>& scanComps, Unit&& unit, Between&& between) {
    const size_t count = scanComps.size();
    if (count == 1) {  // non-interleaved: one block per MCU over the real blocks
      Component& c = *scanComps[0];
      int total = c.realBlocksW * c.realBlocksH, done = 0;
      for (int by = 0; by < c.realBlocksH; ++by)
        for (int bx = 0; bx < c.realBlocksW; ++bx) {
          unit(c, 0, static_cast<size_t>(by) * c.blocksW + bx);
          between(++done == total);
        }
      return;
    }
    int total = mcusX_ * mcusY_, done = 0;
    for (int my = 0; my < mcusY_; ++my)
      for (int mx = 0; mx < mcusX_; ++mx) {
        for (size_t i = 0; i < count; ++i) {
          Component& c = *scanComps[i];
          for (int y = 0; y < c.v; ++y)
            for (int x = 0; x < c.h; ++x) {
              size_t by = static_cast<size_t>(my) * c.v + y, bx = mx * c.h + x;
              unit(c, static_cast<int>(i), by * c.blocksW + bx);
            }
        }
        between(++done == total);
      }
  }

  void scan() {
    size_t length = segmentLength();
    const uint8_t* p = data_ + pos_ + 2;
    size_t n = length - 2;
    if (n < 1) corrupt("bad SOS segment");
    int count = p[0];
    if (count < 1 || count > 4 || n < static_cast<size_t>(1 + 2 * count + 3))
      corrupt("bad SOS segment");
    std::vector<Component*> scanComps;
    int blocksInMcu = 0;
    for (int i = 0; i < count; ++i) {
      int id = p[1 + 2 * i];
      Component* found = nullptr;
      for (auto& c : comps_)
        if (c.id == id) found = &c;
      if (!found) corrupt("SOS names an unknown component");
      found->dcTable = p[2 + 2 * i] >> 4;
      found->acTable = p[2 + 2 * i] & 15;
      if (found->dcTable > 3 || found->acTable > 3) corrupt("bad SOS table index");
      scanComps.push_back(found);
      blocksInMcu += found->h * found->v;
    }
    // jdinput.c::per_scan_setup: D_MAX_BLOCKS_IN_MCU
    if (count > 1 && blocksInMcu > 10)
      corrupt("interleaved scan of " + std::to_string(blocksInMcu) +
              " blocks per MCU; libjpeg reads at most 10");
    int ss = p[1 + 2 * count], se = p[2 + 2 * count], ah = p[3 + 2 * count] >> 4,
        al = p[3 + 2 * count] & 15;
    pos_ += length;
    if (lossless_) {
      losslessScan(scanComps, ss, se, ah, al);
      return;
    }
    if (!progressive_ && (ss != 0 || se != 63 || ah != 0 || al != 0))
      corrupt("sequential scan with Ss, Se, Ah/Al " + std::to_string(ss) + ", " +
              std::to_string(se) + ", " + std::to_string(p[3 + 2 * count]));
    bool dcBand = ss == 0;
    if (progressive_) progression(scanComps, ss, se, ah, al);
    for (auto* c : scanComps) {
      if (!quantDefined_[c->tq]) corrupt("quantization table not defined");
      bool needDc = !progressive_ || (dcBand && ah == 0), needAc = !progressive_ || !dcBand;
      if (!arith_ &&
          ((needDc && !huff_[0][c->dcTable].defined) || (needAc && !huff_[1][c->acTable].defined)))
        corrupt("Huffman table not defined");
      if (!c->seen) std::memcpy(c->quant, quant_[c->tq], sizeof c->quant);
      c->seen = true;
    }
    if (arith_) arithScan(scanComps, ss, se, ah, al);
    else huffmanScan(scanComps, ss, se, ah, al);
  }

  void huffmanScan(const std::vector<Component*>& scanComps, int ss, int se, int ah, int al) {
    BitReader reader(data_, size_, pos_);
    int dcPred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restartsLeft = restartInterval_, nextRestart = 0;
    // jdhuff.c::decode_mcu: a whole block of a sequential scan
    auto decodeBlock = [&](Component& c, int pred, int16_t* block) {
      const HuffTable& dc = huff_[0][c.dcTable];
      const HuffTable& ac = huff_[1][c.acTable];
      int s = reader.decode(dc);
      if (s > 16) corrupt("bad DC difference size");
      int diff = s ? extend(reader.bits(s), s) : 0;
      dcPred[pred] += diff;
      block[0] = static_cast<int16_t>(dcPred[pred]);
      for (int k = 1; k < 64; ++k) {
        int rs = reader.decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          block[kNaturalOrder[k]] = static_cast<int16_t>(extend(reader.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };
    // jdphuff.c::decode_mcu_DC_first
    auto dcFirst = [&](Component& c, int pred, int16_t* block) {
      int s = reader.decode(huff_[0][c.dcTable]);
      if (s > 16) corrupt("bad DC difference size");
      int diff = s ? extend(reader.bits(s), s) : 0;
      dcPred[pred] += diff;
      block[0] = static_cast<int16_t>(static_cast<uint32_t>(dcPred[pred]) << al);
    };
    // jdphuff.c::decode_mcu_DC_refine
    auto dcRefine = [&](Component&, int, int16_t* block) {
      if (reader.bits(1)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
    };
    // jdphuff.c::decode_mcu_AC_first
    auto acFirst = [&](Component& c, int, int16_t* block) {
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      const HuffTable& ac = huff_[1][c.acTable];
      for (int k = ss; k <= se; ++k) {
        int rs = reader.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          block[kNaturalOrder[k]] =
              static_cast<int16_t>(static_cast<uint32_t>(extend(reader.bits(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += reader.bits(r);
          --eobrun;
          break;
        }
      }
    };
    // jdphuff.c::decode_mcu_AC_refine
    const int p1 = 1 << al, m1 = -(1 << al);
    auto refine = [&](int16_t& coef) {
      if (reader.bits(1) && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    auto acRefine = [&](Component& c, int, int16_t* block) {
      int k = ss;
      if (eobrun == 0) {
        const HuffTable& ac = huff_[1][c.acTable];
        for (; k <= se; ++k) {
          int rs = reader.decode(ac);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = reader.bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += reader.bits(r);
            break;
          }
          do {
            int16_t& coef = block[kNaturalOrder[k]];
            if (coef != 0) {
              refine(coef);
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) block[kNaturalOrder[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t& coef = block[kNaturalOrder[k]];
          if (coef != 0) refine(coef);
        }
        --eobrun;
      }
    };
    auto between = [&](bool last) {
      if (!restartInterval_ || last) return;
      if (--restartsLeft == 0) {
        reader.restart(0xD0 + nextRestart);
        nextRestart = (nextRestart + 1) & 7;
        restartsLeft = restartInterval_;
        std::fill(dcPred, dcPred + 4, 0);
        eobrun = 0;
      }
    };
    auto run = [&](auto&& unit) {
      forEachMcu(scanComps,
                 [&](Component& c, int i, size_t block) { unit(c, i, &c.coefs[block * 64]); }, between);
    };
    bool dcBand = ss == 0;
    if (!progressive_) run(decodeBlock);
    else if (dcBand && ah == 0) run(dcFirst);
    else if (dcBand) run(dcRefine);
    else if (ah == 0) run(acFirst);
    else run(acRefine);
    pos_ = reader.finish();
  }

  // jdarith.c: decode_mcu and the four progressive kinds
  void arithScan(const std::vector<Component*>& scanComps, int ss, int se, int ah, int al) {
    ArithReader reader(data_, size_, pos_);
    const bool dcScan = !progressive_ || (ss == 0 && ah == 0), acScan = !progressive_ || ss != 0;
    auto resetStats = [&]() {
      for (auto* c : scanComps) {
        if (dcScan) std::memset(dcStats_[c->dcTable], 0, sizeof dcStats_[0]);
        if (acScan) std::memset(acStats_[c->acTable], 0, sizeof acStats_[0]);
      }
    };
    resetStats();
    int lastDc[4] = {0, 0, 0, 0}, dcContext[4] = {0, 0, 0, 0};
    uint8_t fixedBin = 113;
    int restartsLeft = restartInterval_, nextRestart = 0;
    // Figures F.19-F.24: a DC difference, into lastDc[i]
    auto dcDiff = [&](Component& c, int i) {
      uint8_t* stats = dcStats_[c.dcTable];
      uint8_t* st = stats + dcContext[i];
      if (reader.decode(st) == 0) {
        dcContext[i] = 0;
        return true;
      }
      int sign = reader.decode(st + 1);
      st += 2 + sign;
      int m = reader.decode(st);
      if (m != 0) {
        st = stats + 20;
        while (reader.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            reader.fail();  // magnitude overflow
            return false;
          }
          st += 1;
        }
      }
      if (m < ((1 << dcL_[c.dcTable]) >> 1)) dcContext[i] = 0;
      else if (m > ((1 << dcU_[c.dcTable]) >> 1)) dcContext[i] = 12 + sign * 4;
      else dcContext[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (reader.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      lastDc[i] = (lastDc[i] + v) & 0xFFFF;
      return true;
    };
    // Figures F.20-F.24: AC coefficients k0..k1 into block, shifted by al
    auto acBand = [&](Component& c, int16_t* block, int k0, int k1, int shift) {
      uint8_t* stats = acStats_[c.acTable];
      for (int k = k0; k <= k1; ++k) {
        uint8_t* st = stats + 3 * (k - 1);
        if (reader.decode(st)) break;  // EOB
        while (reader.decode(st + 1) == 0) {
          st += 3;
          if (++k > k1) {
            reader.fail();  // spectral overflow
            return;
          }
        }
        int sign = reader.decode(&fixedBin);
        st += 2;
        int m = reader.decode(st);
        if (m != 0) {
          if (reader.decode(st)) {
            m <<= 1;
            st = stats + (k <= acK_[c.acTable] ? 189 : 217);
            while (reader.decode(st)) {
              if ((m <<= 1) == 0x8000) {
                reader.fail();  // magnitude overflow
                return;
              }
              st += 1;
            }
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (reader.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        block[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << shift);
      }
    };
    auto sequential = [&](Component& c, int i, int16_t* block) {
      if (!dcDiff(c, i)) return;
      block[0] = static_cast<int16_t>(lastDc[i]);
      acBand(c, block, 1, 63, 0);
    };
    auto dcFirst = [&](Component& c, int i, int16_t* block) {
      if (!dcDiff(c, i)) return;
      block[0] = static_cast<int16_t>(static_cast<uint32_t>(lastDc[i]) << al);
    };
    auto dcRefine = [&](Component&, int, int16_t* block) {
      if (reader.decode(&fixedBin)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
    };
    auto acFirst = [&](Component& c, int, int16_t* block) { acBand(c, block, ss, se, al); };
    const int p1 = 1 << al, m1 = -(1 << al);
    auto acRefine = [&](Component& c, int, int16_t* block) {
      uint8_t* stats = acStats_[c.acTable];
      int kex = se;
      for (; kex > 0; --kex)
        if (block[kNaturalOrder[kex]]) break;
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = stats + 3 * (k - 1);
        if (k > kex && reader.decode(st)) break;  // EOB
        while (true) {
          int16_t& coef = block[kNaturalOrder[k]];
          if (coef) {
            if (reader.decode(st + 2)) coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
            break;
          }
          if (reader.decode(st + 1)) {
            coef = static_cast<int16_t>(reader.decode(&fixedBin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se) {
            reader.fail();  // spectral overflow
            return;
          }
        }
      }
    };
    auto between = [&](bool last) {
      if (!restartInterval_ || last) return;
      if (--restartsLeft == 0) {
        reader.restart(0xD0 + nextRestart);
        nextRestart = (nextRestart + 1) & 7;
        restartsLeft = restartInterval_;
        resetStats();
        for (int i = 0; i < 4; ++i) {
          if (dcScan) lastDc[i] = dcContext[i] = 0;
        }
      }
    };
    auto run = [&](auto&& unit) {
      forEachMcu(
          scanComps,
          [&](Component& c, int i, size_t block) {
            // after an overflow libjpeg decodes nothing more until a restart
            if (!reader.failed()) unit(c, i, &c.coefs[block * 64]);
          },
          between);
    };
    bool dcBand = ss == 0;
    if (!progressive_) run(sequential);
    else if (dcBand && ah == 0) run(dcFirst);
    else if (dcBand) run(dcRefine);
    else if (ah == 0) run(acFirst);
    else run(acRefine);
    pos_ = reader.finish();
  }

  // jdlhuff.c, jddiffct.c and jdlossls.c: one lossless scan
  void losslessScan(const std::vector<Component*>& scanComps, int psv, int se, int ah, int pt) {
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt > 7)
      corrupt("bad lossless scan: Ss " + std::to_string(psv) + ", Se " + std::to_string(se) +
              ", Ah " + std::to_string(ah) + ", Al " + std::to_string(pt));
    for (auto* c : scanComps) {
      if (!huff_[0][c->dcTable].defined) corrupt("Huffman table not defined");
      c->seen = true;
    }
    const int mcusPerRow = scanComps.size() == 1 ? scanComps[0]->realBlocksW : mcusX_;
    if (restartInterval_ && restartInterval_ % mcusPerRow)
      corrupt("lossless JPEG whose restart interval (" + std::to_string(restartInterval_) +
              " MCUs) is not a whole number of MCU rows (" + std::to_string(mcusPerRow) +
              "), which libjpeg-turbo refuses");
    BitReader reader(data_, size_, pos_);
    int restartsLeft = restartInterval_, nextRestart = 0;
    // the component rows that start after a restart take the first-row rule
    std::vector<std::vector<uint8_t>> firstRow(scanComps.size());
    for (size_t i = 0; i < scanComps.size(); ++i) {
      firstRow[i].assign(scanComps[i]->blocksH, 0);
      firstRow[i][0] = 1;
    }
    int mcuRow = 0, mcuInRow = 0;
    auto unit = [&](Component& c, int, size_t sample) {
      int s = reader.decode(huff_[0][c.dcTable]);
      if (s > 16) corrupt("bad lossless difference size");
      int diff = s == 16 ? 32768 : (s ? extend(reader.bits(s), s) : 0);
      c.diffs[sample] = static_cast<uint16_t>(diff);
    };
    auto between = [&](bool last) {
      if (++mcuInRow == mcusPerRow) {
        mcuInRow = 0;
        ++mcuRow;
      }
      if (!restartInterval_ || last) return;
      if (--restartsLeft == 0) {
        reader.restart(0xD0 + nextRestart);
        nextRestart = (nextRestart + 1) & 7;
        restartsLeft = restartInterval_;
        for (size_t i = 0; i < scanComps.size(); ++i) {
          int v = scanComps.size() == 1 ? 1 : scanComps[i]->v;
          size_t row = static_cast<size_t>(mcuRow) * v;
          if (row < firstRow[i].size()) firstRow[i][row] = 1;
        }
      }
    };
    forEachMcu(scanComps, unit, between);
    pos_ = reader.finish();
    for (size_t i = 0; i < scanComps.size(); ++i) undifference(*scanComps[i], psv, pt, firstRow[i]);
  }

  // jdlossls.c: the predictors over the real samples, in place, then the
  // point transform's scaling to 8 bits
  void undifference(Component& c, int psv, int pt, const std::vector<uint8_t>& firstRow) {
    const int W = c.width, H = c.height;
    std::vector<int> prev(W), cur(W);
    for (int y = 0; y < H; ++y) {
      const uint16_t* diff = &c.diffs[static_cast<size_t>(y) * c.blocksW];
      if (firstRow[y]) {
        int ra = (diff[0] + (1 << (8 - pt - 1))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < W; ++x) cur[x] = ra = (diff[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0];
        int ra = (diff[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < W; ++x) {
          int rc = rb;
          rb = prev[x];
          int pred;
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (diff[x] + pred) & 0xFFFF;
        }
      }
      uint16_t* out = &c.diffs[static_cast<size_t>(y) * c.blocksW];
      for (int x = 0; x < W; ++x) out[x] = static_cast<uint16_t>(static_cast<uint8_t>(cur[x] << pt));
      std::swap(prev, cur);
    }
  }

  // jdphuff.c::start_pass_phuff_decoder: the scan's parameters, then each
  // coefficient's progression. libjpeg only warns where a scan refines bits
  // that were never sent or sends them twice; no encoder writes such a file,
  // and here it is corrupt.
  void progression(const std::vector<Component*>& scanComps, int ss, int se, int ah, int al) {
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || scanComps.size() != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad)
      corrupt("bad progressive scan: Ss " + std::to_string(ss) + ", Se " + std::to_string(se) +
              ", Ah " + std::to_string(ah) + ", Al " + std::to_string(al));
    for (auto* c : scanComps) {
      if (ss != 0 && c->coefBits[0] < 0)
        corrupt("progressive AC scan of component " + std::to_string(c->id) +
                " before its DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != std::max(c->coefBits[k], 0))
          corrupt("progressive scan of component " + std::to_string(c->id) +
                  " refines coefficient " + std::to_string(k) + " out of order");
        c->coefBits[k] = al;
      }
    }
  }

  // jdcoefct.c::smoothing_ok, with the bits of the last scan (the whole file
  // is read before the output pass)
  bool smoothingOk() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto& c : comps_) {
      const int16_t* q = c.quant;
      if (q[0] == 0 || q[kQ01] == 0 || q[kQ10] == 0 || q[kQ20] == 0 || q[kQ11] == 0 ||
          q[kQ02] == 0 || q[kQ03] == 0 || q[kQ12] == 0 || q[kQ21] == 0 || q[kQ30] == 0)
        return false;
      if (c.coefBits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coefBits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c::decompress_smooth_data for one block row: each block's
  // estimates from the DC values of its 5x5 neighbourhood, then the IDCT.
  void smoothRow(const Component& c, int by, uint8_t* out, int stride) const {
    const int* bits = c.coefBits;
    const bool changeDc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                          bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                          bits[9] == -1;
    const int16_t* qt = c.quant;
    const int64_t Q00 = qt[0], Q01 = qt[kQ01], Q10 = qt[kQ10], Q20 = qt[kQ20], Q11 = qt[kQ11],
                  Q02 = qt[kQ02], Q03 = qt[kQ03], Q12 = qt[kQ12], Q21 = qt[kQ21], Q30 = qt[kQ30];
    // the rows above and below, as libjpeg-turbo picks them: it counts
    // block rows as block_rows (the iMCU row's real rows) times the iMCU
    // rows, so below the last real row it may read the DC values of the
    // padding blocks an interleaved DC scan decoded
    const int v = c.v, lastImcu = mcusY_ - 1, imcu = by / v, blockRow = by % v;
    int blockRows = v;
    if (imcu == lastImcu) {
      blockRows = c.realBlocksH % v;
      if (blockRows == 0) blockRows = v;
    }
    const int64_t image = int64_t(imcu) * blockRows + blockRow, imageRows = int64_t(blockRows) * mcusY_;
    auto rowAt = [&](int r) { return &c.coefs[static_cast<size_t>(r) * c.blocksW * 64]; };
    const int16_t* cur = rowAt(by);
    const int16_t* prev = image > 0 ? rowAt(by - 1) : cur;
    const int16_t* prevPrev = image > 1 ? rowAt(by - 2) : prev;
    const int16_t* next = image < imageRows - 1 ? rowAt(by + 1) : cur;
    const int16_t* nextNext = image < imageRows - 2 ? rowAt(by + 2) : next;
    const int16_t* rows[5] = {prevPrev, prev, cur, next, nextNext};
    int DC[26];  // DC[1..25]: the 5x5 neighbourhood, row by row
    const int lastCol = c.realBlocksW - 1;
    int16_t ws[64];
    auto estimate = [&](int al, int64_t q, int64_t num) {
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return static_cast<int16_t>(pred);
    };
    for (int bx = 0; bx <= lastCol; ++bx) {
      std::memcpy(ws, cur + static_cast<size_t>(bx) * 64, sizeof ws);
      // columns past the edges repeat the edge column
      for (int g = 0; g < 5; ++g)
        for (int j = 1; j <= 5; ++j)
          DC[g * 5 + j] = rows[g][static_cast<size_t>(std::min(std::max(bx + j - 3, 0), lastCol)) * 64];
      int al;
      if ((al = bits[1]) != 0 && ws[1] == 0) {
        int64_t num = Q00 * (changeDc ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] -
                                         13 * DC[9] + 3 * DC[10] - 3 * DC[11] + 38 * DC[12] -
                                         38 * DC[14] + 3 * DC[15] - 3 * DC[16] + 13 * DC[17] -
                                         13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] + DC[24] + DC[25])
                                      : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]));
        ws[1] = estimate(al, Q01, num);
      }
      if ((al = bits[2]) != 0 && ws[8] == 0) {
        int64_t num = Q00 * (changeDc ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] +
                                         13 * DC[7] + 38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] -
                                         13 * DC[17] - 38 * DC[18] - 13 * DC[19] + DC[20] + DC[21] +
                                         3 * DC[22] + 3 * DC[23] + 3 * DC[24] + DC[25])
                                      : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]));
        ws[8] = estimate(al, Q10, num);
      }
      if ((al = bits[3]) != 0 && ws[16] == 0) {
        int64_t num = Q00 * (changeDc ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] -
                                         14 * DC[13] - 5 * DC[14] + 2 * DC[17] + 7 * DC[18] +
                                         2 * DC[19] + DC[23])
                                      : (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23]));
        ws[16] = estimate(al, Q20, num);
      }
      if ((al = bits[4]) != 0 && ws[9] == 0) {
        int64_t num = Q00 * (changeDc ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] +
                                         9 * DC[19] + DC[21] - DC[25])
                                      : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] -
                                         DC[20] + DC[22] - DC[24] + DC[4] - DC[6] + 10 * DC[7] -
                                         10 * DC[9]));
        ws[9] = estimate(al, Q11, num);
      }
      if ((al = bits[5]) != 0 && ws[2] == 0) {
        int64_t num = Q00 * (changeDc ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] -
                                         14 * DC[13] + 7 * DC[14] + DC[15] + 2 * DC[17] -
                                         5 * DC[18] + 2 * DC[19])
                                      : (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15]));
        ws[2] = estimate(al, Q02, num);
      }
      if (changeDc) {
        if ((al = bits[6]) != 0 && ws[3] == 0)
          ws[3] = estimate(al, Q03, Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]));
        if ((al = bits[7]) != 0 && ws[10] == 0)
          ws[10] =
              estimate(al, Q12, Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]));
        if ((al = bits[8]) != 0 && ws[17] == 0)
          ws[17] =
              estimate(al, Q21, Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]));
        if ((al = bits[9]) != 0 && ws[24] == 0)
          ws[24] =
              estimate(al, Q30, Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]));
        int64_t num =
            Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6] +
                   6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12] +
                   152 * DC[13] + 42 * DC[14] - 8 * DC[15] - 6 * DC[16] + 6 * DC[17] + 42 * DC[18] +
                   6 * DC[19] - 6 * DC[20] - 2 * DC[21] - 6 * DC[22] - 8 * DC[23] - 6 * DC[24] -
                   2 * DC[25]);
        ws[0] = num >= 0 ? static_cast<int16_t>(((Q00 << 7) + num) / (Q00 << 8))
                         : static_cast<int16_t>(-(((Q00 << 7) - num) / (Q00 << 8)));
      }
      idctIslow(ws, qt, out + bx * 8, stride);
    }
  }

  // The component's real samples, [height rows][stride], after the IDCT (or
  // the lossless predictors).
  std::vector<uint8_t> samples(const Component& c, int& stride) {
    if (lossless_) {
      stride = c.blocksW;
      std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.height);
      for (size_t i = 0; i < plane.size(); ++i) plane[i] = static_cast<uint8_t>(c.diffs[i]);
      return plane;
    }
    stride = c.realBlocksW * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.realBlocksH * 8);
    const int16_t* q = c.quant;
    for (int by = 0; by < c.realBlocksH; ++by) {
      uint8_t* row = &plane[static_cast<size_t>(by) * 8 * stride];
      if (smoothing_) {
        smoothRow(c, by, row, stride);
        continue;
      }
      for (int bx = 0; bx < c.realBlocksW; ++bx)
        idctIslow(&c.coefs[(static_cast<size_t>(by) * c.blocksW + bx) * 64], q, row + bx * 8, stride);
    }
    return plane;
  }

  // Upsample one component to [height_][width_] by jdsample.c's methods.
  std::vector<uint8_t> upsample(const Component& c) {
    int stride;
    std::vector<uint8_t> in = samples(c, stride);
    const int hr = hmax_ / c.h, vr = vmax_ / c.v;
    const int W = width_, H = height_, dw = c.width, dh = c.height;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto row = [&](int y) { return &in[static_cast<size_t>(std::min(std::max(y, 0), dh - 1)) * stride]; };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[static_cast<size_t>(y) * W], row(y), W);
      return out;
    }
    std::vector<uint8_t> line(static_cast<size_t>(dw) * hr + 8);
    auto store = [&](int y, const uint8_t* src) {
      if (y < H) std::memcpy(&out[static_cast<size_t>(y) * W], src, W);
    };
    // lossless files have no fancy upsampling (jdmaster.c: do_fancy needs a DCT)
    const bool fancy = !lossless_;
    if (fancy && hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        const uint8_t* p = row(y);
        uint8_t* o = line.data();
        int v = p[0];
        o[0] = static_cast<uint8_t>(v);
        o[1] = static_cast<uint8_t>((v * 3 + p[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = p[x] * 3;
          o[2 * x] = static_cast<uint8_t>((v + p[x - 1] + 1) >> 2);
          o[2 * x + 1] = static_cast<uint8_t>((v + p[x + 1] + 2) >> 2);
        }
        v = p[dw - 1];
        o[2 * dw - 2] = static_cast<uint8_t>((v * 3 + p[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = static_cast<uint8_t>(v);
        store(y, o);
      }
      return out;
    }
    if (fancy && hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        const uint8_t* p0 = row(y);
        for (int v = 0; v < 2; ++v) {
          const uint8_t* p1 = row(v == 0 ? y - 1 : y + 1);
          int bias = v == 0 ? 1 : 2;
          uint8_t* o = line.data();
          for (int x = 0; x < dw; ++x) o[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
          store(2 * y + v, o);
        }
      }
      return out;
    }
    if (fancy && hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      for (int y = 0; y < dh; ++y) {
        const uint8_t* p0 = row(y);
        for (int v = 0; v < 2; ++v) {
          uint8_t* o = line.data();
          const uint8_t* p1 = row(v == 0 ? y - 1 : y + 1);
          int thiscol = p0[0] * 3 + p1[0];
          int nextcol = p0[1] * 3 + p1[1];
          o[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
          o[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          int lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 2; x < dw; ++x) {
            nextcol = p0[x] * 3 + p1[x];
            o[2 * x - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
            o[2 * x - 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          o[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          o[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
          store(2 * y + v, o);
        }
      }
      return out;
    }
    // h2v1_upsample, h2v2_upsample and int_upsample: replication
    for (int y = 0; y < dh; ++y) {
      const uint8_t* p = row(y);
      uint8_t* o = line.data();
      for (int x = 0; x < dw; ++x) std::memset(o + x * hr, p[x], hr);
      for (int v = 0; v < vr; ++v) store(y * vr + v, o);
    }
    return out;
  }

  void output(uint8_t* rgb) {
    const size_t pixels = static_cast<size_t>(width_) * height_;
    if (space_ == kGray) {
      std::vector<uint8_t> gray = upsample(comps_[0]);
      for (size_t i = 0; i < pixels; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = gray[i];
      return;
    }
    std::vector<uint8_t> a = upsample(comps_[0]), b = upsample(comps_[1]), c = upsample(comps_[2]);
    const Tables& t = tables();
    if (space_ == kRgb) {
      for (size_t i = 0; i < pixels; ++i) {
        rgb[3 * i] = a[i];
        rgb[3 * i + 1] = b[i];
        rgb[3 * i + 2] = c[i];
      }
      return;
    }
    if (space_ == kYcc) {
      for (size_t i = 0; i < pixels; ++i) {  // jdcolor.c::ycc_rgb_convert
        int y = a[i], cb = b[i], cr = c[i];
        rgb[3 * i] = clampByte(y + t.crR[cr]);
        rgb[3 * i + 1] = clampByte(y + static_cast<int>((t.cbG[cb] + t.crG[cr]) >> 16));
        rgb[3 * i + 2] = clampByte(y + t.cbB[cb]);
      }
      return;
    }
    std::vector<uint8_t> k = upsample(comps_[3]);
    for (size_t i = 0; i < pixels; ++i) {
      int cmyk[4] = {a[i], b[i], c[i], k[i]};
      if (space_ == kYcck) {  // jdcolor.c::ycck_cmyk_convert
        int y = a[i], cb = b[i], cr = c[i];
        cmyk[0] = clampByte(255 - (y + t.crR[cr]));
        cmyk[1] = clampByte(255 - (y + static_cast<int>((t.cbG[cb] + t.crG[cr]) >> 16)));
        cmyk[2] = clampByte(255 - (y + t.cbB[cb]));
      }
      // PIL: rawmode "CMYK;I" inverts each sample, then Convert.c::cmyk2rgb
      int nk = cmyk[3];  // 255 - (255 - k)
      for (int j = 0; j < 3; ++j) {
        int tmp = (255 - cmyk[j]) * nk + 128;
        rgb[3 * i + j] = clampByte(nk - (((tmp >> 8) + tmp) >> 8));
      }
    }
  }

  const uint8_t* data_;
  size_t size_, pos_ = 0, scanStart_ = 0;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false, smoothing_ = false;
  bool sawJfif_ = false, sawAdobe_ = false;
  int adobeTransform_ = -1;
  Space space_ = kGray;
  int height_ = 0, width_ = 0, hmax_ = 1, vmax_ = 1, mcusX_ = 0, mcusY_ = 0;
  int restartInterval_ = 0;
  std::vector<Component> comps_;
  HuffTable huff_[2][4];
  int16_t quant_[4][64] = {};
  bool quantDefined_[4] = {false, false, false, false};
  // jdmarker.c::get_soi: the default conditioning
  int dcL_[16] = {}, dcU_[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
      acK_[16] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  uint8_t dcStats_[4][64] = {}, acStats_[4][256] = {};
};

// ===================================================================== encoder
// jcparam.c: the Annex K tables (natural order)
constexpr int kStdLuminanceQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr int kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: counts of codes of each length 1..16, then the symbols
constexpr uint8_t kDcLuminanceBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChrominanceBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLuminanceBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLuminanceValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChrominanceBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChrominanceValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
};

EncTable encTable(const uint8_t* bits, const uint8_t* vals) {
  // jchuff.c::jpeg_make_c_derived_tbl
  EncTable t{};
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      t.code[vals[k]] = code++;
      t.size[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  return t;
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t code, int size) {
    buffer_ = (buffer_ << size) | (code & ((1u << size) - 1));
    count_ += size;
    while (count_ >= 8) {
      count_ -= 8;
      emit(static_cast<uint8_t>(buffer_ >> count_));
    }
  }
  void flush() {  // jchuff.c::flush_bits: fill the partial byte with ones
    if (count_) put(0x7F, 8 - count_);
  }

 private:
  void emit(uint8_t byte) {
    out_.push_back(byte);
    if (byte == 0xFF) out_.push_back(0);
  }
  std::vector<uint8_t>& out_;
  uint64_t buffer_ = 0;
  int count_ = 0;
};

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jfdctint.c::jpeg_fdct_islow, in place on samples - 128
void fdctIslow(int* data) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int step = pass == 0 ? 1 : 8;
      int* d = pass == 0 ? data + i * 8 : data + i;
      int64_t tmp0 = d[0 * step] + d[7 * step], tmp7 = d[0 * step] - d[7 * step];
      int64_t tmp1 = d[1 * step] + d[6 * step], tmp6 = d[1 * step] - d[6 * step];
      int64_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int64_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int evenShift = pass == 0 ? 0 : kPass1Bits;
      int oddShift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        d[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * step] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0] = static_cast<int>(descale(tmp10 + tmp11, evenShift));
        d[4 * step] = static_cast<int>(descale(tmp10 - tmp11, evenShift));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, oddShift));
      d[6 * step] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, oddShift));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      d[7 * step] = static_cast<int>(descale(tmp4 + z1 + z3, oddShift));
      d[5 * step] = static_cast<int>(descale(tmp5 + z2 + z4, oddShift));
      d[3 * step] = static_cast<int>(descale(tmp6 + z2 + z3, oddShift));
      d[1 * step] = static_cast<int>(descale(tmp7 + z1 + z4, oddShift));
    }
  }
}

// jcdctmgr.c::compute_reciprocal with a 16-bit DCTELEM (libjpeg-turbo's SIMD
// build), for divisor = quantval << 3
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  for (uint32_t d = divisor; d; d >>= 1) ++b;
  b -= 1;
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

class Encoder {
 public:
  Encoder(const uint8_t* rgb, int height, int width, int quality)
      : rgb_(rgb), H_(height), W_(width) {
    // jcparam.c::jpeg_quality_scaling and jpeg_add_quant_table(force_baseline)
    quality = std::min(std::max(quality, 1), 100);
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
      quant_[0][i] = scaled(kStdLuminanceQuant[i], scale);
      quant_[1][i] = scaled(kStdChrominanceQuant[i], scale);
      for (int t = 0; t < 2; ++t) div_[t][i] = reciprocal(static_cast<uint32_t>(quant_[t][i]) << 3);
    }
    dc_[0] = encTable(kDcLuminanceBits, kDcValues);
    ac_[0] = encTable(kAcLuminanceBits, kAcLuminanceValues);
    dc_[1] = encTable(kDcChrominanceBits, kDcValues);
    ac_[1] = encTable(kAcChrominanceBits, kAcChrominanceValues);
  }

  std::vector<uint8_t> encode() {
    std::vector<uint8_t> out;
    out.reserve(static_cast<size_t>(W_) * H_ / 2 + 1024);
    headers(out);
    planes();
    BitWriter writer(out);
    const int mcusX = (W_ + 15) / 16, mcusY = (H_ + 15) / 16;
    const int yBlocksW = (W_ + 7) / 8, yBlocksH = (H_ + 7) / 8;
    int lastDc[3] = {0, 0, 0};
    int16_t blocks[6][64];
    for (int my = 0; my < mcusY; ++my) {
      for (int mx = 0; mx < mcusX; ++mx) {
        // jccoefct.c::compress_data: real blocks, then the dummy ones
        int n = 0;
        for (int y = 0; y < 2; ++y) {
          int by = my * 2 + y;
          if (by < yBlocksH) {
            int count = (mx < mcusX - 1) ? 2 : (yBlocksW % 2 ? yBlocksW % 2 : 2);
            for (int x = 0; x < 2; ++x) {
              if (x < count) {
                forward(plane_[0], stride_[0], by, mx * 2 + x, 0, blocks[n]);
              } else {
                std::memset(blocks[n], 0, sizeof blocks[n]);
                blocks[n][0] = blocks[n - 1][0];
              }
              ++n;
            }
          } else {
            int16_t dc = blocks[n - 1][0];
            for (int x = 0; x < 2; ++x, ++n) {
              std::memset(blocks[n], 0, sizeof blocks[n]);
              blocks[n][0] = dc;
            }
          }
        }
        // the chroma planes have exactly mcusX x mcusY blocks
        for (int c = 1; c < 3; ++c, ++n) forward(plane_[c], stride_[c], my, mx, 1, blocks[n]);
        for (int b = 0; b < 6; ++b) {
          int c = b < 4 ? 0 : b - 3;
          encodeBlock(writer, blocks[b], lastDc[c], c == 0 ? 0 : 1);
          lastDc[c] = blocks[b][0];
        }
      }
    }
    writer.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
    return out;
  }

 private:
  static int scaled(int base, int scale) {
    long temp = (static_cast<long>(base) * scale + 50L) / 100L;
    if (temp <= 0L) temp = 1L;
    if (temp > 32767L) temp = 32767L;
    if (temp > 255L) temp = 255L;  // force_baseline
    return static_cast<int>(temp);
  }

  static void marker(std::vector<uint8_t>& out, int m) {
    out.push_back(0xFF);
    out.push_back(static_cast<uint8_t>(m));
  }
  static void word(std::vector<uint8_t>& out, int v) {
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v & 0xFF));
  }

  void headers(std::vector<uint8_t>& out) {
    // jcmarker.c: write_file_header, write_frame_header, write_scan_header
    marker(out, 0xD8);
    marker(out, 0xE0);
    word(out, 16);
    const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0};
    out.insert(out.end(), jfif, jfif + sizeof jfif);
    word(out, 1);
    word(out, 1);
    out.push_back(0);
    out.push_back(0);
    for (int t = 0; t < 2; ++t) {
      marker(out, 0xDB);
      word(out, 64 + 1 + 2);
      out.push_back(static_cast<uint8_t>(t));
      for (int k = 0; k < 64; ++k) out.push_back(static_cast<uint8_t>(quant_[t][kNaturalOrder[k]]));
    }
    marker(out, 0xC0);
    word(out, 3 * 3 + 2 + 5 + 1);
    out.push_back(8);
    word(out, H_);
    word(out, W_);
    out.push_back(3);
    const uint8_t comps[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    out.insert(out.end(), comps, comps + sizeof comps);
    auto dht = [&](int index, const uint8_t* bits, const uint8_t* vals) {
      int count = 0;
      for (int l = 0; l < 16; ++l) count += bits[l];
      marker(out, 0xC4);
      word(out, 2 + 1 + 16 + count);
      out.push_back(static_cast<uint8_t>(index));
      out.insert(out.end(), bits, bits + 16);
      out.insert(out.end(), vals, vals + count);
    };
    dht(0x00, kDcLuminanceBits, kDcValues);
    dht(0x10, kAcLuminanceBits, kAcLuminanceValues);
    dht(0x01, kDcChrominanceBits, kDcValues);
    dht(0x11, kAcChrominanceBits, kAcChrominanceValues);
    marker(out, 0xDA);
    word(out, 2 * 3 + 2 + 1 + 3);
    out.push_back(3);
    const uint8_t scan[] = {1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    out.insert(out.end(), scan, scan + sizeof scan);
  }

  // The colour-converted, downsampled and edge-padded planes.
  void planes() {
    const Tables& t = tables();
    const int mcusY = (H_ + 15) / 16;
    const int yCols = (W_ + 7) / 8 * 8;
    const int cW = (W_ + 1) / 2, cH = (H_ + 1) / 2;
    const int cCols = (cW + 7) / 8 * 8;
    const int fullCols = std::max(yCols, 2 * cCols), fullRows = 2 * cH;
    // jccolor.c::rgb_ycc_convert over the real pixels; jcsample.c's
    // expand_right_edge and jcprepct.c's expand_bottom_edge around them
    std::vector<uint8_t> full[3];
    for (auto& f : full) f.resize(static_cast<size_t>(fullCols) * fullRows);
    for (int y = 0; y < fullRows; ++y) {
      const uint8_t* src = rgb_ + static_cast<size_t>(std::min(y, H_ - 1)) * W_ * 3;
      uint8_t* o[3] = {&full[0][static_cast<size_t>(y) * fullCols],
                       &full[1][static_cast<size_t>(y) * fullCols],
                       &full[2][static_cast<size_t>(y) * fullCols]};
      for (int x = 0; x < W_; ++x) {
        int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
        const int64_t* c = t.rgbYcc;
        o[0][x] = static_cast<uint8_t>((c[r] + c[g + 256] + c[b + 512]) >> 16);
        o[1][x] = static_cast<uint8_t>((c[r + 768] + c[g + 1024] + c[b + 1280]) >> 16);
        o[2][x] = static_cast<uint8_t>((c[r + 1280] + c[g + 1536] + c[b + 1792]) >> 16);
      }
      for (int k = 0; k < 3; ++k)
        for (int x = W_; x < fullCols; ++x) o[k][x] = o[k][W_ - 1];
    }
    // Y: fullsize_downsample, the rows past the image repeat the last
    stride_[0] = yCols;
    const int yRows = mcusY * 16;
    plane_[0].resize(static_cast<size_t>(yCols) * yRows);
    for (int y = 0; y < yRows; ++y)
      std::memcpy(&plane_[0][static_cast<size_t>(y) * yCols],
                  &full[0][static_cast<size_t>(std::min(y, fullRows - 1)) * fullCols], yCols);
    // Cb, Cr: h2v2_downsample with the alternating bias 1, 2
    const int cRows = mcusY * 8;
    for (int k = 1; k < 3; ++k) {
      stride_[k] = cCols;
      plane_[k].resize(static_cast<size_t>(cCols) * cRows);
      for (int y = 0; y < cRows; ++y) {
        uint8_t* o = &plane_[k][static_cast<size_t>(y) * cCols];
        if (y >= cH) {
          std::memcpy(o, &plane_[k][static_cast<size_t>(cH - 1) * cCols], cCols);
          continue;
        }
        const uint8_t* p0 = &full[k][static_cast<size_t>(2 * y) * fullCols];
        const uint8_t* p1 = p0 + fullCols;
        int bias = 1;
        for (int x = 0; x < cCols; ++x) {
          o[x] = static_cast<uint8_t>((p0[2 * x] + p0[2 * x + 1] + p1[2 * x] + p1[2 * x + 1] +
                                       bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  void forward(const std::vector<uint8_t>& plane, int stride, int by, int bx, int table,
               int16_t* out) {
    int data[64];
    for (int r = 0; r < 8; ++r) {
      const uint8_t* p = &plane[static_cast<size_t>(by * 8 + r) * stride + bx * 8];
      for (int c = 0; c < 8; ++c) data[r * 8 + c] = p[c] - 128;
    }
    fdctIslow(data);
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c::quantize
      const Divisor& d = div_[table][i];
      int temp = static_cast<int16_t>(data[i]);  // DCTELEM is a short
      bool negative = temp < 0;
      if (negative) temp = -temp;
      uint32_t product = static_cast<uint32_t>(temp + static_cast<int>(d.corr)) * d.recip;
      product >>= d.shift;
      int q = static_cast<int16_t>(product);
      out[i] = static_cast<int16_t>(negative ? -q : q);
    }
  }

  void encodeBlock(BitWriter& w, const int16_t* block, int lastDc, int table) {
    // jchuff.c::encode_one_block
    int temp = block[0] - lastDc, temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int n = nbits(temp);
    w.put(dc_[table].code[n], dc_[table].size[n]);
    if (n) w.put(static_cast<uint32_t>(temp2), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      temp = block[kNaturalOrder[k]];
      if (temp == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        w.put(ac_[table].code[0xF0], ac_[table].size[0xF0]);
        run -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        --temp2;
      }
      n = nbits(temp);
      int sym = (run << 4) + n;
      w.put(ac_[table].code[sym], ac_[table].size[sym]);
      w.put(static_cast<uint32_t>(temp2), n);
      run = 0;
    }
    if (run > 0) w.put(ac_[table].code[0], ac_[table].size[0]);
  }

  const uint8_t* rgb_;
  int H_, W_;
  int quant_[2][64];
  Divisor div_[2][64];
  EncTable dc_[2], ac_[2];
  std::vector<uint8_t> plane_[3];
  int stride_[3] = {0, 0, 0};
};

int fail(const Failure& f, char* err, int32_t errLen) {
  if (err && errLen > 0) {
    std::snprintf(err, static_cast<size_t>(errLen), "%s", f.message.c_str());
  }
  return f.status;
}

}  // namespace

extern "C" {

enum { MCQ_JPEG_OK = 0, MCQ_JPEG_UNSUPPORTED = 1, MCQ_JPEG_CORRUPT = 2, MCQ_JPEG_TOO_SMALL = 3 };

// dims <- [height, width, components]. Returns a status; on failure `err`
// holds the message.
int mcq_jpeg_header(const uint8_t* data, int64_t size, int32_t* dims, char* err, int32_t errLen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.readHeaders();
    dims[0] = d.height();
    dims[1] = d.width();
    dims[2] = d.components();
    return MCQ_JPEG_OK;
  } catch (const Failure& f) {
    return fail(f, err, errLen);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, err, errLen);
  }
}

// Decode into rgb [height, width, 3] uint8 (outSize bytes).
int mcq_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* rgb, int64_t outSize, char* err,
                    int32_t errLen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.readHeaders();
    if (static_cast<int64_t>(d.height()) * d.width() * 3 != outSize)
      return fail(Failure{kTooSmall, "output buffer has the wrong size"}, err, errLen);
    d.decode(rgb);
    return MCQ_JPEG_OK;
  } catch (const Failure& f) {
    return fail(f, err, errLen);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kCorrupt, "out of memory"}, err, errLen);
  }
}

// Encode rgb [height, width, 3] uint8 at `quality`, 4:2:0. Returns the
// file's size; if it exceeds `capacity`, nothing is written and the size is
// returned all the same, so the caller can retry with a larger buffer. A
// negative value is a failure.
int64_t mcq_jpeg_encode(const uint8_t* rgb, int32_t height, int32_t width, int32_t quality,
                        uint8_t* out, int64_t capacity, char* err, int32_t errLen) {
  try {
    if (height < 1 || width < 1 || height > 65535 || width > 65535)
      return -fail(Failure{kUnsupported, "JPEG sizes run from 1 to 65535"}, err, errLen);
    std::vector<uint8_t> file = Encoder(rgb, height, width, quality).encode();
    if (static_cast<int64_t>(file.size()) <= capacity) std::memcpy(out, file.data(), file.size());
    return static_cast<int64_t>(file.size());
  } catch (const Failure& f) {
    return -fail(f, err, errLen);
  } catch (const std::bad_alloc&) {
    return -fail(Failure{kCorrupt, "out of memory"}, err, errLen);
  }
}

}  // extern "C"
