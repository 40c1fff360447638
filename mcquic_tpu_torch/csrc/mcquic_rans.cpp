// mcquic_tpu_torch native entropy-coding runtime (C++17, C ABI for ctypes).
// A copy of mcquic_tpu/coding/csrc/mcquic_rans.cpp: the bitstream must stay
// byte-identical between the two packages (tests/test_torch_coding.py).
//
// Implements the bitstream format of the reference rANS coder
// (reference: third_party/CompressAI/cpp_exts/{ops,buffered_rans_encoder,
// rans_decoder}.cpp over the public-domain ryg_rans 64-bit construction):
//   * 64-bit rANS state, lower renormalization bound 2^31, 32-bit word I/O
//     written backwards, flushed as two little-endian 32-bit words.
//   * 16-bit probability precision; quantized CDFs sum to 2^16.
//   * escape ("bypass") coding for out-of-range symbols: the last in-range
//     slot is a sentinel followed by a 4-bit-chunk unary-terminated length
//     and then the raw value in 4-bit chunks.
//   * CDF quantization with "frequency stealing" so every symbol keeps a
//     non-zero frequency (reference ops.cpp:42-111 algorithm, re-derived).
//
// Engineering differences from the reference (interface, not format):
//   * C ABI over contiguous int32/uint8 buffers — no per-symbol Python lists
//     crossing the boundary (reference entropyCoder.py:120-124 serializes
//     python ints).
//   * Decoder inverts the CDF with a per-CDF alias/bucket lookup table
//     instead of a linear scan (reference rans_decoder.cpp:133-141 hot spot).
//   * Batch entry points encode/decode many independent streams in one call.
//
// Build: see ../coding/build.py (g++ -O3 -std=c++17 -shared -fPIC).

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <stdexcept>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;            // probability bits
constexpr uint32_t kBypassBits = 4;            // bypass chunk bits
constexpr uint32_t kMaxBypass = (1u << kBypassBits) - 1;
constexpr uint64_t kRansLow = 1ull << 31;      // renormalization lower bound

// ----------------------------------------------------------------- encoder
struct PendingSym {
  uint16_t start;
  uint16_t range;   // freq for normal syms; (val+1) for bypass chunks
  uint8_t bypass;
};

inline void encPut(uint64_t& x, std::vector<uint32_t>& words, uint32_t start,
                   uint32_t freq) {
  // Renormalize: emit low 32 bits when the state would overflow.
  const uint64_t xMax = ((kRansLow >> kPrecision) << 32) * freq;
  if (x >= xMax) {
    words.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void encPutBits(uint64_t& x, std::vector<uint32_t>& words, uint32_t val,
                       uint32_t nbits) {
  const uint32_t freq = 1u << (kPrecision - nbits);
  const uint64_t xMax = ((kRansLow >> kPrecision) << 32) * freq;
  if (x >= xMax) {
    words.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = (x << nbits) | val;
}

// Encode one stream. cdfs: [nCdfs, cdfStride] row-major quantized CDFs.
// Returns number of bytes written to `out` (caller guarantees capacity),
// or -1 if capacity insufficient.
int64_t encodeStream(const int32_t* symbols, const int32_t* indexes, int64_t n,
                     const int32_t* cdfs, int64_t cdfStride,
                     const int32_t* cdfSizes, const int32_t* offsets,
                     uint8_t* out, int64_t outCap) {
  std::vector<PendingSym> syms;
  syms.reserve(static_cast<size_t>(n) + 8);

  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdfIdx = indexes[i];
    const int32_t* cdf = cdfs + cdfIdx * cdfStride;
    const int32_t maxValue = cdfSizes[cdfIdx] - 2;
    int32_t value = symbols[i] - offsets[cdfIdx];

    uint32_t rawVal = 0;
    if (value < 0) {
      rawVal = static_cast<uint32_t>(-2 * value - 1);
      value = maxValue;
    } else if (value >= maxValue) {
      rawVal = static_cast<uint32_t>(2 * (value - maxValue));
      value = maxValue;
    }

    syms.push_back({static_cast<uint16_t>(cdf[value]),
                    static_cast<uint16_t>(cdf[value + 1] - cdf[value]), 0});

    if (value == maxValue) {
      // Escape: chunk count in saturating kMaxBypass units, then raw chunks.
      int32_t nBypass = 0;
      while ((rawVal >> (nBypass * kBypassBits)) != 0) ++nBypass;
      int32_t rem = nBypass;
      while (rem >= static_cast<int32_t>(kMaxBypass)) {
        syms.push_back({static_cast<uint16_t>(kMaxBypass),
                        static_cast<uint16_t>(kMaxBypass + 1), 1});
        rem -= kMaxBypass;
      }
      syms.push_back({static_cast<uint16_t>(rem), static_cast<uint16_t>(rem + 1), 1});
      for (int32_t j = 0; j < nBypass; ++j) {
        const uint32_t chunk = (rawVal >> (j * kBypassBits)) & kMaxBypass;
        syms.push_back({static_cast<uint16_t>(chunk), static_cast<uint16_t>(chunk + 1), 1});
      }
    }
  }

  // rANS encodes in reverse; words come out back-to-front.
  uint64_t x = kRansLow;
  std::vector<uint32_t> words;
  words.reserve(syms.size() / 2 + 4);
  for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
    if (!it->bypass) {
      encPut(x, words, it->start, it->range);
    } else {
      encPutBits(x, words, it->start, kBypassBits);
    }
  }
  // Flush: two words, low then high — they are the FIRST words of the stream.
  const uint32_t flushLo = static_cast<uint32_t>(x);
  const uint32_t flushHi = static_cast<uint32_t>(x >> 32);

  const int64_t nBytes = static_cast<int64_t>((words.size() + 2) * sizeof(uint32_t));
  if (nBytes > outCap) return -1;

  uint32_t* w = reinterpret_cast<uint32_t*>(out);
  *w++ = flushLo;
  *w++ = flushHi;
  // Remaining words in reverse emission order (earliest-needed first).
  for (auto it = words.rbegin(); it != words.rend(); ++it) *w++ = *it;
  return nBytes;
}

// ----------------------------------------------------------------- decoder
struct DecTable {
  // bucket -> symbol: sym[f >> shift] gives a starting guess; with
  // kPrecision=16 and a full 2^16-entry table the lookup is exact.
  std::vector<uint16_t> lut;  // 2^16 entries: cumFreq -> symbol
};

inline uint32_t decGet(uint64_t x) { return static_cast<uint32_t>(x & ((1u << kPrecision) - 1)); }

inline void decAdvance(uint64_t& x, const uint32_t*& ptr, const uint32_t* end,
                       uint32_t start, uint32_t freq) {
  const uint32_t mask = (1u << kPrecision) - 1;
  x = freq * (x >> kPrecision) + (x & mask) - start;
  if (x < kRansLow && ptr < end) {
    x = (x << 32) | *ptr++;
  }
}

inline uint32_t decGetBits(uint64_t& x, const uint32_t*& ptr, const uint32_t* end,
                           uint32_t nbits) {
  const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
  x >>= nbits;
  if (x < kRansLow && ptr < end) {
    x = (x << 32) | *ptr++;
  }
  return val;
}

int64_t decodeStream(const uint8_t* encoded, int64_t nBytes,
                     const int32_t* indexes, int64_t n,
                     const int32_t* cdfs, int64_t cdfStride,
                     const int32_t* cdfSizes, const int32_t* offsets,
                     const uint16_t* const* luts,  // per-cdf 2^16 LUT or null
                     int32_t* out) {
  if (nBytes < 8 || (nBytes & 3)) return -1;
  const uint32_t* ptr = reinterpret_cast<const uint32_t*>(encoded);
  const uint32_t* end = ptr + nBytes / 4;
  uint64_t x = (static_cast<uint64_t>(ptr[1]) << 32) | ptr[0];
  ptr += 2;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdfIdx = indexes[i];
    const int32_t* cdf = cdfs + cdfIdx * cdfStride;
    const int32_t cdfSize = cdfSizes[cdfIdx];
    const int32_t maxValue = cdfSize - 2;

    const uint32_t cumFreq = decGet(x);
    int32_t s;
    if (luts && luts[cdfIdx]) {
      s = luts[cdfIdx][cumFreq];
    } else {
      // Binary search: first index with cdf[idx] > cumFreq, minus one.
      int32_t lo = 0, hi = cdfSize - 1;
      while (lo + 1 < hi) {
        const int32_t mid = (lo + hi) / 2;
        if (static_cast<uint32_t>(cdf[mid]) <= cumFreq) lo = mid; else hi = mid;
      }
      s = lo;
    }
    decAdvance(x, ptr, end, cdf[s], cdf[s + 1] - cdf[s]);

    int32_t value = s;
    if (value == maxValue) {
      uint32_t val = decGetBits(x, ptr, end, kBypassBits);
      int32_t nBypass = static_cast<int32_t>(val);
      while (val == kMaxBypass) {
        val = decGetBits(x, ptr, end, kBypassBits);
        nBypass += static_cast<int32_t>(val);
      }
      uint32_t rawVal = 0;
      for (int32_t j = 0; j < nBypass; ++j) {
        val = decGetBits(x, ptr, end, kBypassBits);
        rawVal |= val << (j * kBypassBits);
      }
      value = static_cast<int32_t>(rawVal >> 1);
      if (rawVal & 1) {
        value = -value - 1;
      } else {
        value += maxValue;
      }
    }
    out[i] = value + offsets[cdfIdx];
  }
  return n;
}

}  // namespace

extern "C" {

// Quantize a pmf into an integer CDF summing to 2^precision with strictly
// increasing entries (frequency-stealing repair; reference ops.cpp semantics).
// pmf: [size] floats; outCdf: [size+1] int32. Returns 0 ok, <0 error.
int mcq_pmf_to_quantized_cdf(const float* pmf, int32_t size, int32_t precision,
                             int32_t* outCdf) {
  if (size <= 0 || precision <= 0 || precision > 30) return -1;
  for (int32_t i = 0; i < size; ++i) {
    if (!(pmf[i] >= 0.0f) || !std::isfinite(pmf[i])) return -2;
  }
  std::vector<uint32_t> freq(static_cast<size_t>(size) + 1);
  freq[0] = 0;
  for (int32_t i = 0; i < size; ++i) {
    freq[i + 1] = static_cast<uint32_t>(std::round(pmf[i] * (1 << precision)));
  }
  const uint64_t total = std::accumulate(freq.begin(), freq.end(), uint64_t{0});
  if (total == 0) return -3;
  // Rescale so the partial sums land exactly on 2^precision.
  for (auto& f : freq) {
    f = static_cast<uint32_t>((static_cast<uint64_t>(1ull << precision) * f) / total);
  }
  std::vector<uint32_t> cdf(freq.size());
  std::partial_sum(freq.begin(), freq.end(), cdf.begin());
  cdf.back() = 1u << precision;

  // Repair zero-width slots by stealing from the smallest >1 frequency.
  for (int32_t i = 0; i < size; ++i) {
    if (cdf[i] == cdf[i + 1]) {
      uint32_t bestFreq = ~0u;
      int32_t bestSteal = -1;
      for (int32_t j = 0; j < size; ++j) {
        const uint32_t f = cdf[j + 1] - cdf[j];
        if (f > 1 && f < bestFreq) {
          bestFreq = f;
          bestSteal = j;
        }
      }
      if (bestSteal < 0) return -4;
      if (bestSteal < i) {
        for (int32_t j = bestSteal + 1; j <= i; ++j) --cdf[j];
      } else {
        for (int32_t j = i + 1; j <= bestSteal; ++j) ++cdf[j];
      }
    }
  }
  if (cdf[0] != 0 || cdf.back() != (1u << precision)) return -5;
  for (int32_t i = 0; i < size; ++i) {
    if (cdf[i + 1] <= cdf[i]) return -5;
  }
  for (size_t i = 0; i < cdf.size(); ++i) outCdf[i] = static_cast<int32_t>(cdf[i]);
  return 0;
}

// Build a 2^16 cumFreq->symbol lookup table for one CDF.
// outLut: [65536] uint16. Returns 0 ok.
int mcq_build_decode_lut(const int32_t* cdf, int32_t cdfSize, uint16_t* outLut) {
  if (cdfSize < 2) return -1;
  for (int32_t s = 0; s < cdfSize - 1; ++s) {
    const int32_t lo = cdf[s], hi = cdf[s + 1];
    for (int32_t f = lo; f < hi; ++f) outLut[f] = static_cast<uint16_t>(s);
  }
  return 0;
}

int64_t mcq_encode_with_indexes(const int32_t* symbols, const int32_t* indexes,
                                int64_t n, const int32_t* cdfs, int64_t cdfStride,
                                const int32_t* cdfSizes, const int32_t* offsets,
                                uint8_t* out, int64_t outCap) {
  return encodeStream(symbols, indexes, n, cdfs, cdfStride, cdfSizes, offsets, out, outCap);
}

int64_t mcq_decode_with_indexes(const uint8_t* encoded, int64_t nBytes,
                                const int32_t* indexes, int64_t n,
                                const int32_t* cdfs, int64_t cdfStride,
                                const int32_t* cdfSizes, const int32_t* offsets,
                                const uint16_t* lutsFlat,  // [nCdfs * 65536] or null
                                int64_t nCdfs, int32_t* out) {
  std::vector<const uint16_t*> luts;
  const uint16_t* const* lutPtr = nullptr;
  if (lutsFlat) {
    luts.resize(static_cast<size_t>(nCdfs));
    for (int64_t i = 0; i < nCdfs; ++i) luts[i] = lutsFlat + i * 65536;
    lutPtr = luts.data();
  }
  return decodeStream(encoded, nBytes, indexes, n, cdfs, cdfStride, cdfSizes,
                      offsets, lutPtr, out);
}

// Batch API: encode `batch` independent streams sharing one CDF set.
// symbols/indexes: [batch, n] row-major. outSizes: [batch]. out: [batch, perCap].
int mcq_encode_batch(const int32_t* symbols, const int32_t* indexes,
                     int64_t batch, int64_t n, const int32_t* cdfs,
                     int64_t cdfStride, const int32_t* cdfSizes,
                     const int32_t* offsets, uint8_t* out, int64_t perCap,
                     int64_t* outSizes) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t nb = encodeStream(symbols + b * n, indexes + b * n, n, cdfs,
                                    cdfStride, cdfSizes, offsets,
                                    out + b * perCap, perCap);
    if (nb < 0) return -1;
    outSizes[b] = nb;
  }
  return 0;
}

int mcq_decode_batch(const uint8_t* encoded, const int64_t* offsetsBytes,
                     const int64_t* sizesBytes, int64_t batch,
                     const int32_t* indexes, int64_t n, const int32_t* cdfs,
                     int64_t cdfStride, const int32_t* cdfSizes,
                     const int32_t* symOffsets, const uint16_t* lutsFlat,
                     int64_t nCdfs, int32_t* out) {
  std::vector<const uint16_t*> luts;
  const uint16_t* const* lutPtr = nullptr;
  if (lutsFlat) {
    luts.resize(static_cast<size_t>(nCdfs));
    for (int64_t i = 0; i < nCdfs; ++i) luts[i] = lutsFlat + i * 65536;
    lutPtr = luts.data();
  }
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t rc = decodeStream(encoded + offsetsBytes[b], sizesBytes[b],
                                    indexes, n, cdfs, cdfStride, cdfSizes,
                                    symOffsets, lutPtr, out + b * n);
    if (rc < 0) return -1;
  }
  return 0;
}

// ------------------------------------------------------ streaming decoder
// Parity with the reference's stateful RansDecoder.set_stream/decode_stream
// (rans_decoder.cpp:175-248): one stream decoded in several calls.
struct StreamState {
  std::vector<uint8_t> data;
  const uint32_t* ptr;
  const uint32_t* end;
  uint64_t x;
};

void* mcq_stream_new(const uint8_t* encoded, int64_t nBytes) {
  if (nBytes < 8 || (nBytes & 3)) return nullptr;
  auto* s = new StreamState();
  s->data.assign(encoded, encoded + nBytes);
  s->ptr = reinterpret_cast<const uint32_t*>(s->data.data());
  s->end = s->ptr + nBytes / 4;
  s->x = (static_cast<uint64_t>(s->ptr[1]) << 32) | s->ptr[0];
  s->ptr += 2;
  return s;
}

int64_t mcq_stream_decode(void* handle, const int32_t* indexes, int64_t n,
                          const int32_t* cdfs, int64_t cdfStride,
                          const int32_t* cdfSizes, const int32_t* offsets,
                          int32_t* out) {
  auto* s = static_cast<StreamState*>(handle);
  if (!s) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdfIdx = indexes[i];
    const int32_t* cdf = cdfs + cdfIdx * cdfStride;
    const int32_t cdfSize = cdfSizes[cdfIdx];
    const int32_t maxValue = cdfSize - 2;

    const uint32_t cumFreq = decGet(s->x);
    int32_t lo = 0, hi = cdfSize - 1;
    while (lo + 1 < hi) {
      const int32_t mid = (lo + hi) / 2;
      if (static_cast<uint32_t>(cdf[mid]) <= cumFreq) lo = mid; else hi = mid;
    }
    const int32_t sym = lo;
    decAdvance(s->x, s->ptr, s->end, cdf[sym], cdf[sym + 1] - cdf[sym]);

    int32_t value = sym;
    if (value == maxValue) {
      uint32_t val = decGetBits(s->x, s->ptr, s->end, kBypassBits);
      int32_t nBypass = static_cast<int32_t>(val);
      while (val == kMaxBypass) {
        val = decGetBits(s->x, s->ptr, s->end, kBypassBits);
        nBypass += static_cast<int32_t>(val);
      }
      uint32_t rawVal = 0;
      for (int32_t j = 0; j < nBypass; ++j) {
        val = decGetBits(s->x, s->ptr, s->end, kBypassBits);
        rawVal |= val << (j * kBypassBits);
      }
      value = static_cast<int32_t>(rawVal >> 1);
      if (rawVal & 1) {
        value = -value - 1;
      } else {
        value += maxValue;
      }
    }
    out[i] = value + offsets[cdfIdx];
  }
  return n;
}

void mcq_stream_free(void* handle) {
  delete static_cast<StreamState*>(handle);
}

}  // extern "C"
