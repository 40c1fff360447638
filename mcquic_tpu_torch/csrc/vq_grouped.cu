// K1b: nearest-codeword search on a (token tile x codeword tile x group)
// grid, for sm_90a.
//
// Replaces mcquic_tpu/ops/vq_pallas.py::vqEncodeGrouped (kernel
// _encodeKernel), which vqEncodeFused takes when the codebook does not fit
// the resident kernel's budget (residentFits). For each group g and token t
// it returns
//     argmin_j  ||c[g,j]||^2 - 2 x[g,t] . c[g,j]
// in fp32, with ties going to the lowest j, exactly as the plain version
// ops/vq.py::vqEncodePlain. It is the kernel for every codebook that K1
// (csrc/vq_encode.cu) cannot hold: codebooks past the 8 MB budget, and any
// d, since K1 keeps a whole d-vector tile in shared memory and stops at 256.
//
// Bound: at the past-budget level (m 2, T 1536, k 16384, d 64) the work is
// 6.5 GFLOP of fp32 FMA against 9 MB of inputs, so the card's fp32 rate
// bounds it, not its memory.
//
// Design: one block owns BT tokens and BK codewords of one group and
// streams d through shared memory in chunks of DC, so shared memory does
// not grow with d. Each thread accumulates an RT x RK tile of dot products
// in registers, in increasing d (one fmaf chain per pair, as K1 does), then
// keeps the best of its RK codewords per token; the block reduces across
// threads. The Pallas kernel carries the running (min, argmin) across
// codeword tiles in scratch, because its grid runs in order; here the
// codeword tiles run in parallel, so each block folds its result into one
// 64-bit key per token with atomicMin:
//     key = orderedBits(dist) << 32 | j
// orderedBits maps fp32 to uint32 preserving order, after -0.0 is mapped to
// +0.0 (the plain version's < treats them as equal), so the smallest key is
// the smallest distance and, among equal distances, the lowest index: the
// tie rule holds whatever order the blocks run in. A block reads the key
// first and skips the atomic when it cannot win. Codewords past k are
// masked by index; nothing is padded.
//
// Arithmetic: plain fp32 FMA on the CUDA cores, no tensor cores and no
// TF32. The launcher initializes the keys, runs the grid, and unpacks the
// low 32 bits into int32 codes; it is a plain C function over raw device
// pointers and a stream (see ops/vq_grouped_cuda.py).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TX = 8;              // threads along codewords
constexpr int TY = 16;             // threads along tokens
constexpr int RT = 8;              // tokens per thread
constexpr int RK = 8;              // codewords per thread
constexpr int BT = TY * RT;        // 128 tokens per block
constexpr int BK = TX * RK;        // 64 codewords per block
constexpr int DC = 32;             // d streamed in chunks of 32
constexpr int THREADS = TX * TY;   // 128
constexpr int XS_STRIDE = BT + 1;  // +1: transposed stores hit distinct banks
constexpr int CS_STRIDE = BK + 1;

__device__ __forceinline__ bool isBetter(float d, int i, float bestD, int bestI) {
  return d < bestD || (d == bestD && i < bestI);
}

__device__ __forceinline__ unsigned long long packKey(float dist, int idx) {
  if (dist == 0.f) dist = 0.f;  // -0.0 -> +0.0
  unsigned u = __float_as_uint(dist);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(idx);
}

// grid (ceil(T / BT), ceil(k / BK), m); keys [m, T] start at all ones.
__global__ void __launch_bounds__(THREADS)
vqGroupedKernel(const float* __restrict__ x, const float* __restrict__ codebook,
                const float* __restrict__ c2, int T, int k, int d,
                unsigned long long* keys) {
  __shared__ float xs[DC * XS_STRIDE];   // [DC][XS_STRIDE], token chunk transposed
  __shared__ float cs[DC * CS_STRIDE];   // [DC][CS_STRIDE], codeword chunk transposed

  const int g = blockIdx.z;
  const int t0 = blockIdx.x * BT;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  const float* xg = x + (size_t)g * T * d;
  const float* cg = codebook + (size_t)g * k * d;

  float acc[RT][RK];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += DC) {
    const int dc = min(DC, d - d0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < BT * DC; e += THREADS) {
      const int row = e / DC, col = e % DC;
      const int t = t0 + row;
      xs[col * XS_STRIDE + row] = (t < T && col < dc) ? xg[(size_t)t * d + d0 + col] : 0.f;
    }
    for (int e = tid; e < BK * DC; e += THREADS) {
      const int row = e / DC, col = e % DC;
      const int j = k0 + row;
      cs[col * CS_STRIDE + row] = (j < k && col < dc) ? cg[(size_t)j * d + d0 + col] : 0.f;
    }
    __syncthreads();

    for (int dd = 0; dd < dc; ++dd) {
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
  }

  float best[RT];
  int arg[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    arg[i] = k0 + tx;
  }
  // codewords tx + j*TX visited in increasing index: strict < keeps the lowest
#pragma unroll
  for (int j = 0; j < RK; ++j) {
    const int idx = k0 + tx + j * TX;
    if (idx < k) {
      const float c2v = c2[(size_t)g * k + idx];
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

  // reduce over the TX threads that share a token (lanes tx = 0..7), then
  // fold into the token's key
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
      unsigned long long* slot = keys + (size_t)g * T + t;
      const unsigned long long key = packKey(b, a);
      // keys only decrease, so a stale read can only cost an extra atomic
      if (key < *reinterpret_cast<volatile unsigned long long*>(slot)) atomicMin(slot, key);
    }
  }
}

__global__ void vqUnpackKeysKernel(const unsigned long long* __restrict__ keys, int mT,
                                   int32_t* __restrict__ codes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < mT) codes[e] = static_cast<int32_t>(keys[e] & 0xffffffffull);
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x [m, T, d], codebook [m, k, d], c2 [m, k] (fp32, contiguous, on the
// device); keys [m, T] uint64 scratch; codes [m, T] int32.
int mcq_vq_grouped(const float* x, const float* codebook, const float* c2,
                   unsigned long long* keys, int32_t* codes, int m, int T, int k, int d,
                   cudaStream_t stream) {
  if (m <= 0 || T <= 0 || k <= 0 || d <= 0 || m > 65535 || (k + BK - 1) / BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mT = m * T;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * (size_t)mT, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BT - 1) / BT, (k + BK - 1) / BK, m);
  vqGroupedKernel<<<grid, THREADS, 0, stream>>>(x, codebook, c2, T, k, d, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vqUnpackKeysKernel<<<(mT + 255) / 256, 256, 0, stream>>>(keys, mT, codes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
