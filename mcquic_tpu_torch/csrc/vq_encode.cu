// K1: nearest-codeword search of the multi-codebook quantizer, for sm_90a.
//
// Replaces mcquic_tpu/ops/vq_pallas.py::vqEncodeResident (kernel
// _residentKernel). For each group g and token t it returns
//     argmin_j  ||c[g,j]||^2 - 2 x[g,t] . c[g,j]
// in fp32 (||x||^2 is constant in j and left out), with ties going to the
// lowest j, exactly as the plain version ops/vq.py::vqEncodePlain.
//
// Bound: at qp-2 level 0 (m 2, T 1536, k 8192, d 64) the work is 3.2 GFLOP of
// fp32 FMA against 4.8 MB of inputs, so the card's fp32 rate bounds it, not
// its memory. The design keeps the [T, k] distance matrix out of device
// memory: a block owns a tile of BT tokens of one group and streams tiles of
// BK codewords through shared memory; each thread keeps a running
// (min, argmin) for its RT tokens over its RK codewords of every tile, and
// the block reduces across threads at the end. The work is split over k
// (grid.z) so that small levels still fill the SMs; a second kernel merges
// the splits in increasing k order.
//
// Arithmetic: plain fp32 FMA on the CUDA cores, no tensor cores and no TF32.
// Ties: a thread visits its codewords in increasing index and replaces its
// best only on a strictly smaller distance; the block and split reductions
// take the smaller index on equal distances.
//
// Launchers are plain C functions over raw device pointers and a stream, so
// the library needs no PyTorch headers (see ops/vq_cuda.py).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TX = 8;              // threads along codewords
constexpr int TY = 16;             // threads along tokens
constexpr int RT = 8;              // tokens per thread
constexpr int RK = 8;              // codewords per thread per tile
constexpr int BT = TY * RT;        // 128 tokens per block
constexpr int BK = TX * RK;        // 64 codewords per tile
constexpr int THREADS = TX * TY;   // 128
constexpr int XS_STRIDE = BT + 1;  // +1: transposed stores hit distinct banks
constexpr int CS_STRIDE = BK + 1;

__device__ __forceinline__ bool isBetter(float d, int i, float bestD, int bestI) {
  return d < bestD || (d == bestD && i < bestI);
}

// grid (ceil(T / BT), m, splits); dynamic shared memory d * (XS + CS) floats.
__global__ void __launch_bounds__(THREADS)
vqNearestKernel(const float* __restrict__ x, const float* __restrict__ codebook,
                const float* __restrict__ c2, int T, int k, int d, int kPerSplit,
                int32_t* __restrict__ codes, float* __restrict__ splitDist,
                int32_t* __restrict__ splitIdx) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [d][XS_STRIDE], token tile transposed
  float* cs = smem + d * XS_STRIDE;      // [d][CS_STRIDE], codeword tile transposed

  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int t0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m = gridDim.y;

  const float* xg = x + (size_t)g * T * d;
  const float* cg = codebook + (size_t)g * k * d;
  const float* c2g = c2 + (size_t)g * k;

  for (int e = tid; e < BT * d; e += THREADS) {
    const int row = e / d, col = e % d;
    const int t = t0 + row;
    xs[col * XS_STRIDE + row] = t < T ? xg[(size_t)t * d + col] : 0.f;
  }

  const int kBegin = split * kPerSplit;
  const int kEnd = min(k, kBegin + kPerSplit);

  float best[RT];
  int arg[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    arg[i] = kBegin;
  }

  for (int k0 = kBegin; k0 < kEnd; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and xs is staged)
    for (int e = tid; e < BK * d; e += THREADS) {
      const int row = e / d, col = e % d;
      const int j = k0 + row;
      cs[col * CS_STRIDE + row] = j < kEnd ? cg[(size_t)j * d + col] : 0.f;
    }
    __syncthreads();

    float acc[RT][RK];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;

    for (int dd = 0; dd < d; ++dd) {
      float xv[RT], cv[RK];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = xs[dd * XS_STRIDE + ty + i * TY];
#pragma unroll
      for (int j = 0; j < RK; ++j) cv[j] = cs[dd * CS_STRIDE + tx + j * TX];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
    }

    // codewords tx + j*TX visited in increasing index: strict < keeps the lowest
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int idx = k0 + tx + j * TX;
      if (idx < kEnd) {
        const float c2v = c2g[idx];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          // 2*acc is exact, so this rounds once, like c2 - 2.0 * inter
          const float dist = fmaf(-2.f, acc[i][j], c2v);
          if (dist < best[i]) {
            best[i] = dist;
            arg[i] = idx;
          }
        }
      }
    }
  }

  // reduce over the TX threads that share a token: lanes tx = 0..7 of a warp
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float b = best[i];
    int a = arg[i];
#pragma unroll
    for (int offset = TX / 2; offset > 0; offset /= 2) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, offset);
      const int oa = __shfl_xor_sync(0xffffffffu, a, offset);
      if (isBetter(ob, oa, b, a)) {
        b = ob;
        a = oa;
      }
    }
    const int t = t0 + ty + i * TY;
    if (tx == 0 && t < T) {
      if (splitDist == nullptr) {
        codes[(size_t)g * T + t] = a;
      } else {
        const size_t o = ((size_t)split * m + g) * T + t;
        splitDist[o] = b;
        splitIdx[o] = a;
      }
    }
  }
}

// Merge the k splits: splits are in increasing k, so the earliest wins ties.
__global__ void vqMergeSplitsKernel(const float* __restrict__ splitDist,
                                    const int32_t* __restrict__ splitIdx,
                                    int splits, int mT, int32_t* __restrict__ codes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mT) return;
  float b = splitDist[e];
  int a = splitIdx[e];
  for (int s = 1; s < splits; ++s) {
    const float ob = splitDist[(size_t)s * mT + e];
    if (ob < b) {
      b = ob;
      a = splitIdx[(size_t)s * mT + e];
    }
  }
  codes[e] = a;
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_vq_block_tokens() { return BT; }
int mcq_vq_tile_codewords() { return BK; }

// x [m, T, d], codebook [m, k, d], c2 [m, k] (all fp32, contiguous, on the
// device); codes [m, T] int32. With splits > 1, splitDist/splitIdx hold
// [splits, m, T] scratch and kPerSplit is a multiple of the codeword tile.
int mcq_vq_nearest(const float* x, const float* codebook, const float* c2,
                   int32_t* codes, float* splitDist, int32_t* splitIdx,
                   int m, int T, int k, int d, int splits, int kPerSplit,
                   cudaStream_t stream) {
  if (m <= 0 || T <= 0 || k <= 0 || d <= 0 || splits <= 0 || kPerSplit <= 0 ||
      (splits > 1 && (splitDist == nullptr || splitIdx == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smemBytes = (size_t)d * (XS_STRIDE + CS_STRIDE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vqNearestKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BT - 1) / BT, m, splits);
  vqNearestKernel<<<grid, THREADS, smemBytes, stream>>>(
      x, codebook, c2, T, k, d, kPerSplit, codes,
      splits > 1 ? splitDist : nullptr, splits > 1 ? splitIdx : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int mT = m * T;
  vqMergeSplitsKernel<<<(mT + 255) / 256, 256, 0, stream>>>(splitDist, splitIdx,
                                                            splits, mT, codes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
