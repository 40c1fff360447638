// K3: attention with an online softmax, for sm_90a.
//
// Replaces mcquic_tpu/ops/attention_pallas.py::_flashBHTD (kernels
// _kernelResident, maskless, and _kernel, masked), entry flashAttention.
// For each batch b, head h and query row i it returns
//     sum_j softmax_j(scale * q[b,i,h] . k[b,j,h] + (mask[i,j] - 1) * 1e9) v[b,j,h]
// with the mask term only when a mask is given, in fp32 throughout, as the
// plain version ops/attention.py::flashAttentionPlain does.
//
// Layout: q, k, v and out are [B, T, H, D] with D contiguous, read through
// their batch, row and head strides, so the generator's layout needs no
// transpose and a prefix slice of a [B, Lmax, H, D] KV cache is passed as
// it is. The mask is int8 [Tq, Tk] with a row stride.
//
// Bound: at the generator's shapes (B 4, H 8, D 64, Tk <= 426) one call
// moves at most 14 MB and does at most 1.5 GFLOP (the uncached 426-token
// call): 4 us of memory traffic against 22 us of fp32 arithmetic, so
// operations bound it; at the small levels launch and latency set its time.
// The design keeps the [Tq, Tk] scores out of device memory: a block owns
// BQ = 16 query rows of one (batch, head) and streams BK = 32-key tiles of K
// and V through shared memory. Each of its four warps owns four rows; lane
// j scores key j of the tile against those rows, the warp reduces the
// tile's row max and sum with shuffles and keeps a running (max, sum) per
// row, and each lane keeps the fp32 accumulator of its D / 32 output
// columns. The output is acc / max(rowSum, 1e-30).
//
// Columns at or past Tk score -inf and add nothing (the key-padding guard);
// every tile has a valid key at lane 0, so the running max is finite from
// the first tile on. A row whose keys are all masked stays finite.
//
// Arithmetic: fp32 FMA on the CUDA cores, expf (no fast math), no tensor
// cores. Launchers are plain C functions over raw device pointers and a
// stream, so the library needs no PyTorch headers (see ops/attention_cuda.py).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                 // query rows per warp
constexpr int BQ = WARPS * RPW;        // 16 query rows per block
constexpr int BK = 32;                 // keys per tile, one per lane
constexpr int DMAX = 128;
constexpr int SLOTS = DMAX / 32;       // output columns per lane

__device__ __forceinline__ float warpMax(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warpSum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, t, h;
};

// grid (ceil(Tq / BQ), B * H)
__global__ void __launch_bounds__(THREADS)
flashAttentionKernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int8_t* __restrict__ mask,
                     long long maskRow, float* __restrict__ out, int H, int Tq, int Tk,
                     int D, float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  __shared__ float qTile[BQ][DMAX];
  __shared__ float kTile[BK][DMAX + 1];   // +1: lane j reads row j, distinct banks
  __shared__ float vTile[BK][DMAX];
  __shared__ float pTile[WARPS][RPW][BK];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, t = q0 + r;
    qTile[r][d] = t < Tq ? qb[t * qs.t + d] : 0.f;
  }

  float acc[RPW][SLOTS];
  float rowMax[RPW], rowSum[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    rowMax[r] = -INFINITY;
    rowSum[r] = 0.f;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) acc[r][s] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();                     // the previous tile is consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D, key = k0 + j;
      kTile[j][d] = key < Tk ? kb[key * ks.t + d] : 0.f;
      vTile[j][d] = key < Tk ? vb[key * vs.t + d] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool valid = key < Tk;
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = kTile[lane][d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = fmaf(qTile[warp * RPW + r][d], kd, s[r]);
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + warp * RPW + r;
      float score = s[r] * scale;
      if (mask != nullptr && valid && row < Tq)
        score += ((float)mask[row * maskRow + key] - 1.f) * 1e9f;
      score = valid ? score : -INFINITY;
      const float newMax = fmaxf(rowMax[r], warpMax(score));
      const float correction = expf(rowMax[r] - newMax);
      const float p = valid ? expf(score - newMax) : 0.f;
      rowSum[r] = rowSum[r] * correction + warpSum(p);
      rowMax[r] = newMax;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) acc[r][sl] *= correction;
      pTile[warp][r][lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        const int d = lane + 32 * sl;
        if (d < D) {
          const float vd = vTile[j][d];
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r][sl] = fmaf(pTile[warp][r][j], vd, acc[r][sl]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(rowSum[r], 1e-30f);
    float* o = out + b * os.b + row * os.t + h * os.h;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const int d = lane + 32 * sl;
      if (d < D) o[d] = acc[r][sl] * inv;
    }
  }
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_flash_max_head_dim() { return DMAX; }

// q [B, Tq, H, D], k and v [B, Tk, H, D], out [B, Tq, H, D]: fp32 on the
// device, D contiguous, the other strides in elements. mask: int8 [Tq, Tk]
// with row stride maskRow, or null. The wrapper checks the shapes
// (ops/attention_cuda.py).
int mcq_flash_attention(const float* q, const float* k, const float* v, const int8_t* mask,
                        long long maskRow, float* out, int B, int H, int Tq, int Tk, int D,
                        float scale, long long qsb, long long qst, long long qsh,
                        long long ksb, long long kst, long long ksh, long long vsb,
                        long long vst, long long vsh, long long osb, long long ost,
                        long long osh, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > DMAX || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flashAttentionKernel<<<grid, THREADS, 0, stream>>>(
      q, k, v, mask, maskRow, out, H, Tq, Tk, D, scale, Strides{qsb, qst, qsh},
      Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, Strides{osb, ost, osh});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
