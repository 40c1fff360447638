// K2: the decoder's thin RGB head, a 3x3 SAME convolution from C to F = r*r*f
// channels plus bias, fused with depth-to-space by r, for sm_90a.
//
// Replaces mcquic_tpu/ops/subpixel_pallas.py::conv3x3SubpixelThin (kernel
// _thinHeadKernel). Input x [B, C, H, W] (NCHW, fp32), weights repacked to
// [C, 3, 3, F] by the wrapper, bias [F]; output [B, f, r*H, r*W] with conv
// channel o = (c, i, j) landing at out[b, c, r*y + i, r*x + j], the channel
// order of torch.nn.PixelShuffle.
//
// Bound: at the product geometry (C 128, F 12, 384x256 -> 768x512x3) the
// conv is 2.7 GFLOP of fp32 FMA against 55 MB moved, so the fp32 rate bounds
// it. A library conv pads the 12 output channels of this head to a full
// tile; here each thread owns one input pixel and accumulates exactly its F
// outputs in registers. A block stages TH x TW pixels plus the one-pixel
// halo (zero outside the image) and the matching weights in shared memory,
// CC input channels at a time, and the store does the bias add and the
// pixel shuffle, so the conv output never round-trips through device memory.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TW = 32;             // tile width (input pixels)
constexpr int TH = 8;              // tile height
constexpr int CC = 16;             // input channels staged per pass
constexpr int THREADS = TW * TH;   // one input pixel per thread
constexpr int MAX_F = 16;

template <int F>
__global__ void __launch_bounds__(THREADS)
thinHeadKernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int C, int H, int W, int r) {
  __shared__ float xs[CC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[CC * 9 * F];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;
  const float* xb = x + (size_t)b * C * H * W;

  float acc[F];
#pragma unroll
  for (int o = 0; o < F; ++o) acc[o] = bias[o];

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < CC * (TH + 2) * (TW + 2); e += THREADS) {
      const int c = e / ((TH + 2) * (TW + 2));
      const int rem = e % ((TH + 2) * (TW + 2));
      const int ry = rem / (TW + 2), rx = rem % (TW + 2);
      const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
      const bool inside = c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
      xs[c][ry][rx] = inside ? xb[((size_t)(c0 + c) * H + gy) * W + gx] : 0.f;
    }
    for (int e = tid; e < CC * 9 * F; e += THREADS)
      ws[e] = c0 + e / (9 * F) < C ? w[(size_t)c0 * 9 * F + e] : 0.f;
    __syncthreads();

    for (int c = 0; c < CC; ++c) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = xs[c][ty + tap / 3][tx + tap % 3];
        const float* wt = ws + (c * 9 + tap) * F;
        if constexpr (F % 4 == 0) {
#pragma unroll
          for (int o = 0; o < F; o += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wt + o);
            acc[o] = fmaf(v, w4.x, acc[o]);
            acc[o + 1] = fmaf(v, w4.y, acc[o + 1]);
            acc[o + 2] = fmaf(v, w4.z, acc[o + 2]);
            acc[o + 3] = fmaf(v, w4.w, acc[o + 3]);
          }
        } else {
#pragma unroll
          for (int o = 0; o < F; ++o) acc[o] = fmaf(v, wt[o], acc[o]);
        }
      }
    }
  }

  const int y = y0 + ty, xx = x0 + tx;
  if (y >= H || xx >= W) return;
  const int rr = r * r;
  const int f = F / rr;
  const int Ho = H * r, Wo = W * r;
  float* ob = out + (size_t)b * f * Ho * Wo;
#pragma unroll
  for (int o = 0; o < F; ++o) {
    const int c = o / rr, i = (o / r) % r, j = o % r;
    ob[((size_t)c * Ho + y * r + i) * Wo + xx * r + j] = acc[o];
  }
}

template <int F>
int launch(const float* x, const float* w, const float* bias, float* out,
           int B, int C, int H, int W, int r, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  thinHeadKernel<F><<<grid, THREADS, 0, stream>>>(x, w, bias, out, C, H, W, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_thin_head_max_features() { return MAX_F; }

// x [B, C, H, W], w [C, 3, 3, F], bias [F] (fp32, contiguous, on the device);
// out [B, F / (r*r), r*H, r*W]. The wrapper gates the shapes (ops/subpixel_cuda.py).
int mcq_thin_head(const float* x, const float* w, const float* bias, float* out,
                  int B, int C, int H, int W, int F, int r, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || r <= 0 || F % (r * r) != 0 ||
      B > 65535 || (H + TH - 1) / TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (F) {
    case 1: return launch<1>(x, w, bias, out, B, C, H, W, r, stream);
    case 2: return launch<2>(x, w, bias, out, B, C, H, W, r, stream);
    case 3: return launch<3>(x, w, bias, out, B, C, H, W, r, stream);
    case 4: return launch<4>(x, w, bias, out, B, C, H, W, r, stream);
    case 5: return launch<5>(x, w, bias, out, B, C, H, W, r, stream);
    case 6: return launch<6>(x, w, bias, out, B, C, H, W, r, stream);
    case 7: return launch<7>(x, w, bias, out, B, C, H, W, r, stream);
    case 8: return launch<8>(x, w, bias, out, B, C, H, W, r, stream);
    case 9: return launch<9>(x, w, bias, out, B, C, H, W, r, stream);
    case 10: return launch<10>(x, w, bias, out, B, C, H, W, r, stream);
    case 11: return launch<11>(x, w, bias, out, B, C, H, W, r, stream);
    case 12: return launch<12>(x, w, bias, out, B, C, H, W, r, stream);
    case 13: return launch<13>(x, w, bias, out, B, C, H, W, r, stream);
    case 14: return launch<14>(x, w, bias, out, B, C, H, W, r, stream);
    case 15: return launch<15>(x, w, bias, out, B, C, H, W, r, stream);
    case 16: return launch<16>(x, w, bias, out, B, C, H, W, r, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
