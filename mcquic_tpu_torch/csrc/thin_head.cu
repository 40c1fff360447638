// K2: the decoder's thin RGB head, a 3x3 SAME convolution from C to F = r*r*f
// channels plus bias, fused with depth-to-space by r, for sm_90a.
//
// Replaces mcquic_tpu/ops/subpixel_pallas.py::conv3x3SubpixelThin (kernel
// _thinHeadKernel). Input x [B, C, H, W] (NCHW, fp32), weights [F, C, 3, 3]
// (OIHW, as the module holds them), bias [F]; output [B, f, r*H, r*W] with
// conv channel o = (c, i, j) landing at out[b, c, r*y + i, r*x + j], the
// channel order of torch.nn.PixelShuffle.
//
// Bound: at the photo (C 128, F 12, 384x256 -> 768x512x3) the conv is 2.7
// GFLOP against 55 MB moved: 16.4 us of memory against 16.5 us of three
// TF32 products on the tensor cores (40.6 us at fp32 FMA), so it sits at
// the ridge.
//
// Design: an implicit GEMM on the tensor cores in 3xTF32 (the direct form,
// not the JAX kernel's scatter form: the taps are read as shifted windows of
// the halo tile in shared memory, so no [pixels, 9F] product is kept).
//  * M is the output pixels of a tile of 8 rows x 32 columns, N is F padded
//    to 16 (two n8 tiles), K is 9 taps x C. A block of 4 warps owns a tile;
//    a warp owns 2 rows, four m16 tiles of 16 pixels, and 32 accumulators.
//  * Channels arrive in chunks of 8 (one k8 step) through a 2-stage
//    cp.async ring (csrc/cp_async.cuh): the halo tile x [8][10][34] with
//    16-byte copies for the 32 interior columns where W % 4 == 0 and x is
//    16-byte aligned (4-byte copies otherwise), and zero-fill copies
//    (src-size 0) for the halo outside the image and for channels past C,
//    so SAME padding costs no branch in the product; and the chunk's
//    weights, read straight from OIHW: for each feature the chunk's 8
//    channels x 9 taps are 72 contiguous floats, copied with coalesced
//    16-byte copies into [16][72] (features past F are zeros), so nothing
//    is repacked per call. Plane stride 408 and feature stride 100 keep
//    the fragment reads free of bank conflicts.
//  * 3xTF32 (csrc/tf32_mma.cuh): each operand a = hi + lo, hi rounded to
//    TF32 with two integer operations and lo = a - hi, which the tensor core
//    truncates; each product lo.hi + hi.lo + hi.hi. A thread splits the
//    weights it copied once per chunk, in place, before the barrier; the
//    activations are split as their fragments are read (a shared-memory
//    copy of their halves would double the fragment loads, which bound the
//    loop).
//  * The epilogue adds the bias and writes the conv tile to shared memory,
//    then stores the pixel shuffle row by row: 16-byte coalesced stores
//    where r*W % 4 == 0, 4-byte ones otherwise.
//  * Grid: one block per tile. Registers are capped at 170 so that three
//    blocks (52 KB of shared memory each) share an SM: at B 1 the photo's
//    384 tiles fit in one wave of 396. On the card three blocks ran faster
//    than two (235 registers) and than four (128 registers: spills, or the
//    taps not unrolled).
//
// Launchers are plain C functions over raw device pointers and a stream,
// so the library needs no PyTorch headers (see ops/subpixel_cuda.py).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

using mcq::cpAsync16;
using mcq::cpAsync4;
using mcq::cpCommit;
using mcq::cpWait;

constexpr int NW = 4;              // warps per block
constexpr int THREADS = NW * 32;
constexpr int TH = 8;              // tile rows (input pixels)
constexpr int TW = 32;             // tile columns
constexpr int CC = 8;              // channels per chunk: one k8 step
constexpr int MAX_F = 16;          // N, two n8 tiles
constexpr int STAGES = 2;
constexpr int RS = 40;             // halo row stride: column x0 - 1 + j at 3 + j
constexpr int PLANE = (TH + 2) * RS + 8;    // 408: 24 mod 32 banks
constexpr int WR = CC * 9;         // a feature's weights of one chunk: 72 contiguous floats
constexpr int FS = 100;            // weight stride per feature: 4 mod 32
constexpr int X_FLOATS = CC * PLANE;
constexpr int W_FLOATS = MAX_F * FS;
constexpr int STAGE_FLOATS = X_FLOATS + 2 * W_FLOATS;   // x, weights hi (in place), weights lo
constexpr int OS = TH * TW + 4;    // conv tile stride per feature in the epilogue
static_assert(MAX_F * OS <= STAGES * STAGE_FLOATS, "the epilogue tile fits the ring");

struct Args {
  const float* x;
  const float* w;
  const float* bias;   // or null
  float* out;
  int C, H, W, F;
  bool vecIn, vecW, vecOut;
};

// grid (ceil(W / TW), ceil(H / TH), B), THREADS threads,
// STAGES * STAGE_FLOATS * 4 bytes of dynamic shared memory
// at most 170 registers, so that three blocks share an SM
template <int R>
__global__ void __launch_bounds__(THREADS, 3) thinHeadKernel(const Args a) {
  extern __shared__ float4 smemRaw[];
  float* ring = reinterpret_cast<float*>(smemRaw);

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int C = a.C, H = a.H, W = a.W, F = a.F;
  const float* xb = a.x + (size_t)b * C * H * W;
  const int chunks = (C + CC - 1) / CC;
  const int wUnit = a.vecW ? 4 : 1;   // floats per weight copy

  auto load = [&](int chunk) {
    float* xs = ring + (chunk % STAGES) * STAGE_FLOATS;
    float* ws = xs + X_FLOATS;
    const int c0 = chunk * CC;
    if (a.vecIn) {   // 8 interior pieces of 4 columns and 2 halo columns per (channel, row)
      for (int e = tid; e < CC * (TH + 2) * 10; e += THREADS) {
        const int piece = e % 10, row = (e / 10) % (TH + 2), c = e / (10 * (TH + 2));
        const int gy = y0 - 1 + row, ch = c0 + c;
        const bool inside = ch < C && gy >= 0 && gy < H;
        float* dst = xs + c * PLANE + row * RS;
        if (piece < 8) {
          const int gx = x0 + 4 * piece;
          const bool ok = inside && gx < W;
          cpAsync16(dst + 4 + 4 * piece, xb + (ok ? ((size_t)ch * H + gy) * W + gx : 0), ok);
        } else {
          const int j = piece == 8 ? 0 : TW + 1, gx = x0 - 1 + j;
          const bool ok = inside && gx >= 0 && gx < W;
          cpAsync4(dst + 3 + j, xb + (ok ? ((size_t)ch * H + gy) * W + gx : 0), ok);
        }
      }
    } else {
      for (int e = tid; e < CC * (TH + 2) * (TW + 2); e += THREADS) {
        const int j = e % (TW + 2), row = (e / (TW + 2)) % (TH + 2), c = e / ((TW + 2) * (TH + 2));
        const int gy = y0 - 1 + row, gx = x0 - 1 + j, ch = c0 + c;
        const bool ok = ch < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
        cpAsync4(xs + c * PLANE + row * RS + 3 + j,
                 xb + (ok ? ((size_t)ch * H + gy) * W + gx : 0), ok);
      }
    }
    // feature f's weights of channels c0 .. c0 + 7 are w[f][c0 * 9 .. c0 * 9 + 71]
    const int live = min(CC, C - c0) * 9;
    for (int e = tid; e < MAX_F * WR / wUnit; e += THREADS) {
      const int f = e / (WR / wUnit), q = (e % (WR / wUnit)) * wUnit;
      const bool ok = f < F && q < live;
      const float* from = a.w + (ok ? ((size_t)f * C + c0) * 9 + q : 0);
      if (a.vecW)
        cpAsync16(ws + f * FS + q, from, ok);
      else
        cpAsync4(ws + f * FS + q, from, ok);
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][n][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s);
    cpCommit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cpWait<STAGES - 2>();
    {   // split the weights this thread copied: hi in place, lo beside
      float* ws = ring + (chunk % STAGES) * STAGE_FLOATS + X_FLOATS;
      for (int e = tid; e < MAX_F * WR / wUnit; e += THREADS) {
        const int o = e / (WR / wUnit) * FS + (e % (WR / wUnit)) * wUnit;
        for (int u = 0; u < wUnit; ++u) {
          uint32_t hi, lo;
          mcq::split(ws[o + u], hi, lo);
          ws[o + u] = __uint_as_float(hi);
          ws[W_FLOATS + o + u] = __uint_as_float(lo);
        }
      }
    }
    __syncthreads();   // this chunk is split and visible; every warp is done with the last one
    if (chunk + STAGES - 1 < chunks) load(chunk + STAGES - 1);
    cpCommit();

    const float* xs = ring + (chunk % STAGES) * STAGE_FLOATS;
    const float* wsHi = xs + X_FLOATS;
    const float* wsLo = wsHi + W_FLOATS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // b0 = W[feature 8n + g][channel t][tap], b1 = channel t + 4
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int o = (8 * n + g) * FS + 9 * t + tap;
        bh[n][0] = __float_as_uint(wsHi[o]);
        bh[n][1] = __float_as_uint(wsHi[o + 36]);
        bl[n][0] = __float_as_uint(wsLo[o]);
        bl[n][1] = __float_as_uint(wsLo[o + 36]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // m tile mi: tile row 2 warp + mi / 2, columns 16 (mi % 2) + 0..15;
        // a0 pixel g channel t, a1 pixel g + 8, a2 channel t + 4, a3 both
        const float* xr = xs + t * PLANE + (2 * warp + (mi >> 1) + dy) * RS + 3 + 16 * (mi & 1) + g + dx;
        const float av[4] = {xr[0], xr[8], xr[4 * PLANE], xr[4 * PLANE + 8]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mcq::split(av[i], ah[i], al[i]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mcq::mma(acc[mi][n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mcq::mma(acc[mi][n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mcq::mma(acc[mi][n], ah, bh[n]);
      }
    }
  }
  cpWait<0>();
  __syncthreads();   // the ring is free for the conv tile

  // C layout: acc[mi][n][i] is pixel 16 (mi % 2) + g + 8 (i >> 1) of tile row
  // 2 warp + mi / 2, feature 8 n + 2 t + (i & 1)
  float* os = ring;   // [F][TH * TW], stride OS
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 8 * n + 2 * t + (i & 1);
        const int p = (2 * warp + (mi >> 1)) * TW + 16 * (mi & 1) + g + 8 * (i >> 1);
        if (f < F) os[f * OS + p] = acc[mi][n][i] + (a.bias != nullptr ? a.bias[f] : 0.f);
      }
  __syncthreads();

  // out[b, oc, r y + i, r x + j] = conv[oc r^2 + i r + j][y][x], by 4 output columns
  constexpr int Q = TW * R / 4;           // float4 pieces per output row of the tile
  const int Ho = H * R, Wo = W * R, oChannels = F / (R * R);
  float* ob = a.out + (size_t)b * oChannels * Ho * Wo;
  for (int e = tid; e < oChannels * TH * R * Q; e += THREADS) {
    const int q = e % Q, orow = (e / Q) % (TH * R), oc = e / (Q * TH * R);
    const int py = orow / R, i = orow % R, oy = y0 * R + orow;
    if (y0 + py >= H) continue;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = 4 * q + u, px = col / R, j = col % R;
      v[u] = os[(oc * R * R + i * R + j) * OS + py * TW + px];
    }
    const int ox = x0 * R + 4 * q;
    float* dst = ob + ((size_t)oc * Ho + oy) * Wo + ox;
    if (a.vecOut) {
      if (ox < Wo) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ox + u < Wo) dst[u] = v[u];
    }
  }
}

template <int R>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> devices{0};
  constexpr int bytes = STAGES * STAGE_FLOATS * 4;
  const cudaError_t err = mcq::allowSharedBytes(thinHeadKernel<R>, bytes, devices);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  thinHeadKernel<R><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_thin_head_max_features() { return MAX_F; }

// the tile, rows * 1000 + columns (ops/subpixel_cuda.py::thinHeadGrid mirrors it)
int mcq_thin_head_tile() { return TH * 1000 + TW; }

// x [B, C, H, W], w [F, C, 3, 3], bias [F] or null (fp32, contiguous, on the device);
// out [B, F / (r*r), r*H, r*W]. The wrapper gates the shapes (ops/subpixel_cuda.py).
int mcq_thin_head(const float* x, const float* w, const float* bias, float* out,
                  int B, int C, int H, int W, int F, int r, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || r <= 0 || r > 4 || F <= 0 || F > MAX_F ||
      F % (r * r) != 0 || B > 65535 || (H + TH - 1) / TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vecIn = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vecW = reinterpret_cast<uintptr_t>(w) % 16 == 0;   // C % 4 == 0: rows of 16 bytes
  const bool vecOut = (W * r) % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Args a{x, w, bias, out, C, H, W, F, vecIn, vecW, vecOut};
  cudaError_t err;
  switch (r) {
    case 1: err = launch<1>(a, B, stream); break;
    case 2: err = launch<2>(a, B, stream); break;
    case 3: err = launch<3>(a, B, stream); break;
    default: err = launch<4>(a, B, stream); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
