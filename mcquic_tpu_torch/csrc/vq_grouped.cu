// K1b: nearest-codeword search for codebooks past K1's budget, for sm_90a.
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
// Design: a block of 128 threads owns a tile of BT tokens (128, or 64
// where the grid would otherwise be short of blocks) of one group and
// walks a run of 64-codeword tiles, a k-split, with its token tile fixed.
// Each (tile, d-chunk of 32) step comes through a 3-stage cp.async ring
// (csrc/cp_async.cuh; 16-byte copies where d and the base pointers allow,
// 4-byte ones otherwise), so the next chunks load while one is computed. Each thread
// accumulates an RT x 8 tile of dot products (RT 8, or 4 for 64 tokens)
// from 16-byte shared loads; after a tile's last chunk it folds the tile
// into a running (best, arg) per token that stays in registers across the
// whole run. At the end the block reduces across the threads that share a
// token and folds the result into one 64-bit key per token with atomicMin:
//     key = orderedBits(dist) << 32 | j
// orderedBits maps fp32 to uint32 preserving order, after -0.0 is mapped to
// +0.0 (the plain version's < treats them as equal), so the smallest key is
// the smallest distance and, among equal distances, the lowest index,
// whatever order the splits finish in. A token takes one atomic per split,
// not one per codeword tile. The split plan is a plain Python function,
// ops/vq_grouped_cuda.py::groupedSplitPlan.
//
// Arithmetic: plain fp32 FMA on the CUDA cores, one fmaf chain in
// increasing d per (token, codeword) pair, as cuBLAS's fp32 product in the
// plain version sums it. No tensor cores: TF32, even split three ways,
// rounds differently and moves codes at near-ties, and the result has to be
// the exact argmin of the plain version. Codewords past k are masked by
// index; tokens past T and columns past d are zero-filled. The launcher
// initializes the keys, runs the grid and unpacks the low 32 bits into
// int32 codes; it is a plain C function over raw device pointers and a
// stream (see ops/vq_grouped_cuda.py).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"

namespace {

using mcq::cpAsync16;
using mcq::cpAsync4;
using mcq::cpCommit;
using mcq::cpWait;

constexpr int TX = 8;              // threads along codewords
constexpr int TY = 16;             // threads along tokens
constexpr int THREADS = TX * TY;   // 128
constexpr int RK = 8;              // codewords per thread
constexpr int BK = TX * RK;        // 64 codewords per tile
constexpr int DC = 32;             // d streamed in chunks of 32
constexpr int SS = DC + 4;         // shared row stride: 16-byte rows, conflict-free float4 reads
constexpr int STAGES = 3;

struct Args {
  const float* x;          // [m, T, d]
  const float* codebook;   // [m, k, d]
  const float* c2;         // [m, k]
  unsigned long long* keys;
  int T, k, d, tilesPerSplit;
  bool vec;                // 16-byte copies
};

__device__ __forceinline__ bool isBetter(float d, int i, float bestD, int bestI) {
  return d < bestD || (d == bestD && i < bestI);
}

__device__ __forceinline__ unsigned long long packKey(float dist, int idx) {
  if (dist == 0.f) dist = 0.f;  // -0.0 -> +0.0
  unsigned u = __float_as_uint(dist);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(idx);
}

// rows [row0, row0 + rows) x columns [d0, d0 + DC) of src [*, d] into dst
// [rows][SS]; rows at or past `limit` and columns at or past d are zeros
__device__ __forceinline__ void loadChunk(float* dst, const float* src, int row0, int rows,
                                          int limit, int d0, int d, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < rows * (DC / 4); e += THREADS) {
      const int r = e / (DC / 4), c = 4 * (e % (DC / 4)), row = row0 + r;
      const bool ok = row < limit && d0 + c < d;
      cpAsync16(dst + r * SS + c, src + (ok ? (size_t)row * d + d0 + c : 0), ok);
    }
  } else {
    for (int e = tid; e < rows * DC; e += THREADS) {
      const int r = e / DC, c = e % DC, row = row0 + r;
      const bool ok = row < limit && d0 + c < d;
      cpAsync4(dst + r * SS + c, src + (ok ? (size_t)row * d + d0 + c : 0), ok);
    }
  }
}

template <int RT>
constexpr int ringBytes() {
  return STAGES * (TY * RT + BK) * SS * 4;
}

// RT tokens per thread; grid (ceil(T / BT), splits, m), THREADS threads,
// ringBytes<RT>() of dynamic shared memory; keys [m, T] start at all ones.
template <int RT>
__global__ void __launch_bounds__(THREADS) vqGroupedKernel(const Args a) {
  constexpr int BT = TY * RT;
  extern __shared__ float4 ringRaw[];
  float* ring = reinterpret_cast<float*>(ringRaw);   // per stage: x [BT][SS], then c [BK][SS]

  const int g = blockIdx.z, t0 = blockIdx.x * BT;
  const int kBegin = blockIdx.y * a.tilesPerSplit * BK;
  const int kEnd = min(a.k, kBegin + a.tilesPerSplit * BK);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int chunks = (a.d + DC - 1) / DC;
  const int steps = (kEnd - kBegin + BK - 1) / BK * chunks;
  const float* xg = a.x + (size_t)g * a.T * a.d;
  const float* cg = a.codebook + (size_t)g * a.k * a.d;
  const float* c2g = a.c2 + (size_t)g * a.k;

  auto load = [&](int step) {
    float* xs = ring + (step % STAGES) * (BT + BK) * SS;
    const int d0 = (step % chunks) * DC, j0 = kBegin + (step / chunks) * BK;
    loadChunk(xs, xg, t0, BT, a.T, d0, a.d, a.vec, tid);
    loadChunk(xs + BT * SS, cg, j0, BK, kEnd, d0, a.d, a.vec, tid);
  };

  float acc[RT][RK], best[RT];
  int arg[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    best[i] = __int_as_float(0x7f800000);   // +inf
    arg[i] = kBegin + tx;
#pragma unroll
    for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cpCommit();
  }
  for (int step = 0; step < steps; ++step) {
    cpWait<STAGES - 2>();
    __syncthreads();   // this step's chunk has landed; every thread is done with the last one
    if (step + STAGES - 1 < steps) load(step + STAGES - 1);
    cpCommit();

    const float* xs = ring + (step % STAGES) * (BT + BK) * SS;
    const float* cs = xs + BT * SS;
    const int chunk = step % chunks;
    const int groups = (min(DC, a.d - chunk * DC) + 3) / 4;   // zero-filled past d
    for (int q = 0; q < groups; ++q) {
      float4 xv[RT], cv[RK];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = *reinterpret_cast<const float4*>(xs + (ty + i * TY) * SS + 4 * q);
#pragma unroll
      for (int j = 0; j < RK; ++j) cv[j] = *reinterpret_cast<const float4*>(cs + (tx + j * TX) * SS + 4 * q);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          acc[i][j] = fmaf(xv[i].x, cv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, cv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, cv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, cv[j].w, acc[i][j]);
        }
    }

    if (chunk == chunks - 1) {
      // the tile is summed: codewords tx + j*TX in increasing index, strict <
      // keeps the lowest; then start the next tile from zero
      const int j0 = kBegin + (step / chunks) * BK;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int idx = j0 + tx + j * TX;
        const float c2v = idx < kEnd ? c2g[idx] : 0.f;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          // 2*acc is exact, so this rounds once, like c2 - 2.0 * inter
          const float dist = fmaf(-2.f, acc[i][j], c2v);
          if (idx < kEnd && dist < best[i]) {
            best[i] = dist;
            arg[i] = idx;
          }
          acc[i][j] = 0.f;
        }
      }
    }
  }
  cpWait<0>();

  // reduce over the TX lanes that share a token, then fold into its key
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float b = best[i];
    int arg0 = arg[i];
#pragma unroll
    for (int offset = TX / 2; offset > 0; offset /= 2) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, offset);
      const int oa = __shfl_xor_sync(0xffffffffu, arg0, offset);
      if (isBetter(ob, oa, b, arg0)) {
        b = ob;
        arg0 = oa;
      }
    }
    const int t = t0 + ty + i * TY;
    if (tx == 0 && t < a.T) {
      unsigned long long* slot = a.keys + (size_t)g * a.T + t;
      const unsigned long long key = packKey(b, arg0);
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

template <int RT>
cudaError_t launch(const Args& a, int m, int splits, cudaStream_t stream) {
  static std::atomic<unsigned long long> devices{0};
  const int bytes = ringBytes<RT>();
  const cudaError_t err = mcq::allowSharedBytes(vqGroupedKernel<RT>, bytes, devices);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + TY * RT - 1) / (TY * RT), splits, m);
  vqGroupedKernel<RT><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_vq_grouped_tile_codewords() { return BK; }

// x [m, T, d], codebook [m, k, d], c2 [m, k] (fp32, contiguous, on the
// device); keys [m, T] uint64 scratch; codes [m, T] int32. blockTokens (128
// or 64), splits and tilesPerSplit come from
// ops/vq_grouped_cuda.py::groupedSplitPlan.
int mcq_vq_grouped(const float* x, const float* codebook, const float* c2,
                   unsigned long long* keys, int32_t* codes, int m, int T, int k, int d,
                   int blockTokens, int splits, int tilesPerSplit, cudaStream_t stream) {
  const long long tiles = (k + BK - 1) / BK;
  if (m <= 0 || T <= 0 || k <= 0 || d <= 0 || m > 65535 || splits <= 0 || splits > 65535 ||
      tilesPerSplit <= 0 || (long long)(splits - 1) * tilesPerSplit >= tiles ||
      (long long)splits * tilesPerSplit < tiles || (blockTokens != 128 && blockTokens != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mT = m * T;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * (size_t)mT, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codebook) % 16 == 0;
  const Args a{x, codebook, c2, keys, T, k, d, tilesPerSplit, vec};
  err = blockTokens == 128 ? launch<8>(a, m, splits, stream) : launch<4>(a, m, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  vqUnpackKeysKernel<<<(mT + 255) / 256, 256, 0, stream>>>(keys, mT, codes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
