// K3: attention with an online softmax, for sm_90a.
//
// Replaces mcquic_tpu/ops/attention_pallas.py::_flashBHTD (kernels
// _kernelResident, maskless, and _kernel, masked), entry flashAttention.
// For each batch b, head h and query row i it returns
//     sum_j softmax_j(scale * q[b,i,h] . k[b,j,h] + (mask[i,j] - 1) * 1e9) v[b,j,h]
// with the mask term only when a mask is given, as the plain version
// ops/attention.py::flashAttentionPlain does.
//
// Layout: q, k, v and out are [B, T, H, D] with D contiguous, read through
// their batch, row and head strides, so the generator's layout needs no
// transpose and a prefix slice of a [B, Lmax, H, D] KV cache is passed as
// it is. k and v are copied with 16-byte cp.async where D is a multiple of
// 4 and their base pointers and strides are 16-byte aligned, and with
// 4-byte cp.async otherwise (any D up to 128). The mask is int8 [Tq, Tk]
// with a row stride.
//
// Bound: at the generator's shapes (B 4, H 8, D 64, Tk <= 426) one call
// moves at most 14 MB and does at most 1.5 GFLOP (the uncached 426-token
// call): 4 us of memory traffic against 22 us of fp32 FMA or 9 us of three
// TF32 products; at the small levels launch and latency set its time.
//
// Design (FlashAttention-2 form on mma.sync):
//  * Tensor cores. Q.K^T and P.V run as mma.sync.m16n8k8 in TF32 with fp32
//    accumulators, each operand split a = hi(a) + lo(a) with hi rounded
//    to TF32 and lo = a - hi (the tensor core truncates it to TF32), and
//    each product taken as lo.hi + hi.lo + hi.hi (3xTF32). Plain TF32 keeps
//    10 mantissa bits and would miss the 1e-4 tolerance against the fp32
//    plain version; the three products keep about 21, and the dropped
//    lo.lo term is below fp32 rounding. The split and the products are
//    csrc/tf32_mma.cuh, shared with K1 and K2. wgmma is not used: its
//    64-row M tile would be mostly padding at every level but the last
//    (Tq 1 ... 64 rows per (b, h)).
//  * Each warp owns 16 query rows; its Q fragments, scores, running
//    (max, sum) and the [16, D] accumulator stay in registers. The score
//    fragment (C layout) becomes the A operand of P.V through 8 register
//    shuffles per 8 keys. The output is acc / max(rowSum, 1e-30).
//  * K and V come through a 3-stage cp.async ring of 32-key tiles in
//    dynamic shared memory (csrc/cp_async.cuh), so the next tiles load
//    while one is computed.
//    Row strides D + 4 (K) and D + 8 (V) keep the fragment reads free of
//    bank conflicts.
//  * Enough blocks at every level: a block holds NW = 1, 2 or 4 warps
//    (16 * NW query rows) and the keys may be split across blocks
//    (flash-decoding); split s covers keys [s * keysPerSplit, ...) and
//    writes its unnormalized accumulator and (max, sum) to scratch, and a
//    second kernel merges the splits:
//        M = max_s m_s,  L = sum_s l_s e^(m_s - M),
//        out = sum_s acc_s e^(m_s - M) / max(L, 1e-30).
//    The plan (NW, splits, keysPerSplit) is computed in Python,
//    ops/attention_cuda.py::attentionPlan, where the CPU tests reach it.
//
// Keys at or past the split's end score -inf and add nothing (their K and
// V rows are zero-filled); every tile has a valid key at its first row, so
// the running max is finite from the first tile on. A row whose keys are
// all masked stays finite. expf throughout (no fast math).
//
// Launchers are plain C functions over raw device pointers and a stream,
// so the library needs no PyTorch headers.
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
using mcq::mma3;

constexpr int BK = 32;         // keys per tile
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int DMAX = 128;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int8_t* mask;
  long long maskRow;
  float* out;
  float* partAcc;   // [splits, B*H, Tq, D] when splits > 1
  float* partStat;  // [splits, B*H, Tq, 2] (max, sum)
  int H, Tq, Tk, D, keysPerSplit, splits;
  float scale;
  bool vec;         // k and v take 16-byte copies
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

__device__ __forceinline__ float quadMax(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quadSum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// o[c], o[c + 1] = x, y where within D; one 8-byte store where D is even
// (c is even, and every row of out and of the scratch starts 8-byte aligned)
__device__ __forceinline__ void store2(float* o, int c, int D, float x, float y) {
  if ((D & 1) == 0) {
    if (c < D) *reinterpret_cast<float2*>(o + c) = make_float2(x, y);
  } else {
    if (c < D) o[c] = x;
    if (c + 1 < D) o[c + 1] = y;
  }
}

template <int DP>
constexpr int ringBytes() {
  return STAGES * BK * ((DP + 4) + (DP + 8)) * 4;
}

// grid (ceil(Tq / (16 NW)), B * H, splits), NW * 32 threads,
// ringBytes<DP>() of dynamic shared memory; D <= DP.
template <int NW, int DP>
__global__ void __launch_bounds__(NW * 32) flashAttentionKernel(const Params p) {
  constexpr int KS = DP + 4, VS = DP + 8, THREADS = NW * 32, DT = DP / 8;
  extern __shared__ float4 ringRaw[];
  float* kRing = reinterpret_cast<float*>(ringRaw);
  float* vRing = kRing + STAGES * BK * KS;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, split = blockIdx.z;
  const int kBegin = split * p.keysPerSplit;
  const int kEnd = min(p.Tk, kBegin + p.keysPerSplit);
  const int nTiles = (kEnd - kBegin + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 16 * NW + warp * 16;
  const int D = p.D, dSteps = (D + 7) >> 3, pieces = D >> 2;
  const float* kBase = p.k + b * p.kb + h * p.kh;
  const float* vBase = p.v + b * p.vb + h * p.vh;

  // columns [D, 8 * dSteps) are read by the mma but never copied: zero them once
  for (int e = tid; e < STAGES * BK * (8 * dSteps - D); e += THREADS) {
    const int r = e / (8 * dSteps - D), c = D + e % (8 * dSteps - D);
    kRing[r * KS + c] = 0.f;
    vRing[r * VS + c] = 0.f;
  }

  auto loadTile = [&](int tile, int stage) {
    const int key0 = kBegin + tile * BK;
    float* ks = kRing + stage * BK * KS;
    float* vs = vRing + stage * BK * VS;
    if (p.vec) {
      for (int e = tid; e < BK * pieces; e += THREADS) {
        const int j = e / pieces, c = 4 * (e - j * pieces), key = key0 + j;
        const bool ok = key < kEnd;
        const long long row = ok ? key : kBegin;   // a valid address; the copy zero-fills
        cpAsync16(ks + j * KS + c, kBase + row * p.kt + c, ok);
        cpAsync16(vs + j * VS + c, vBase + row * p.vt + c, ok);
      }
    } else {
      for (int e = tid; e < BK * D; e += THREADS) {
        const int j = e / D, c = e - j * D, key = key0 + j;
        const bool ok = key < kEnd;
        const long long row = ok ? key : kBegin;
        cpAsync4(ks + j * KS + c, kBase + row * p.kt + c, ok);
        cpAsync4(vs + j * VS + c, vBase + row * p.vt + c, ok);
      }
    }
  };

  // Q as A fragments: a0 (g, 8s+t), a1 (g+8, 8s+t), a2 (g, 8s+t+4), a3 (g+8, 8s+t+4)
  float qf[DT][4];
  {
    const float* qBase = p.q + b * p.qb + h * p.qh;
#pragma unroll
    for (int s = 0; s < DT; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + g + 8 * (i & 1), c = 8 * s + t + 4 * (i >> 1);
        qf[s][i] = (r < p.Tq && c < D) ? qBase[r * p.qt + c] : 0.f;
      }
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float rowMax[2] = {-INFINITY, -INFINITY}, rowSum[2] = {0.f, 0.f};   // rows g, g+8
  const bool active = row0 < p.Tq;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nTiles) loadTile(s, s);
    cpCommit();
  }
  for (int tile = 0; tile < nTiles; ++tile) {
    cpWait<STAGES - 2>();
    __syncthreads();   // tile `tile` has landed and every warp is done with tile - 1
    if (tile + STAGES - 1 < nTiles) loadTile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    cpCommit();
    if (!active) continue;   // an idle warp still copies and meets the barriers
    const float* ks = kRing + (tile % STAGES) * BK * KS;
    const float* vs = vRing + (tile % STAGES) * BK * VS;

    // S = Q K^T for 4 n-tiles of 8 keys: b0 = K[8n+g][8s+t], b1 = K[8n+g][8s+t+4]
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int s = 0; s < DT; ++s) {
      if (s >= dSteps) break;
      float kb[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* kr = ks + (8 * n + g) * KS + 8 * s + t;
        kb[n][0] = kr[0];
        kb[n][1] = kr[4];
      }
      mma3<4>(sc, qf[s], kb, 4);
    }

    // C layout: sc[n][i] is row g + 8 (i >> 1), key 8n + 2t + (i & 1)
    const int key0 = kBegin + tile * BK;
    float tileMax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + 8 * n + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
        float x = sc[n][i] * p.scale;
        if (p.mask != nullptr && key < kEnd && row < p.Tq)
          x += ((float)p.mask[row * p.maskRow + key] - 1.f) * 1e9f;
        x = key < kEnd ? x : -INFINITY;
        sc[n][i] = x;
        tileMax[i >> 1] = fmaxf(tileMax[i >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float newMax = fmaxf(rowMax[r], quadMax(tileMax[r]));
      const float correction = expf(rowMax[r] - newMax);
      rowMax[r] = newMax;
      rowSum[r] *= correction;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][2 * r] *= correction;
        acc[n][2 * r + 1] *= correction;
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = expf(sc[n][i] - rowMax[i >> 1]);   // -inf -> 0
        sc[n][i] = pr;
        rowSum[i >> 1] += pr;
      }

    // O += P V over 4 k-steps of 8 keys; P's A fragment from the C layout:
    // key t lives in lane (g, t/2) element t&1, key t+4 in lane (g, t/2+2)
    const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pa[4];
      float e0 = __shfl_sync(0xffffffffu, sc[j][0], src0), e1 = __shfl_sync(0xffffffffu, sc[j][1], src0);
      pa[0] = odd ? e1 : e0;
      e0 = __shfl_sync(0xffffffffu, sc[j][2], src0);
      e1 = __shfl_sync(0xffffffffu, sc[j][3], src0);
      pa[1] = odd ? e1 : e0;
      e0 = __shfl_sync(0xffffffffu, sc[j][0], src1);
      e1 = __shfl_sync(0xffffffffu, sc[j][1], src1);
      pa[2] = odd ? e1 : e0;
      e0 = __shfl_sync(0xffffffffu, sc[j][2], src1);
      e1 = __shfl_sync(0xffffffffu, sc[j][3], src1);
      pa[3] = odd ? e1 : e0;
      // b0 = V[8j+t][8n+g], b1 = V[8j+t+4][8n+g]
      // in groups of 4 n-tiles, which keeps the split operands in registers
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += 4) {
        float vb[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* vr = vs + (8 * j + t) * VS + 8 * (n0 + n) + g;
          vb[n][0] = n0 + n < dSteps ? vr[0] : 0.f;
          vb[n][1] = n0 + n < dSteps ? vr[4 * VS] : 0.f;
        }
        mma3<4>(acc + n0, pa, vb, dSteps - n0);
      }
    }
  }
  cpWait<0>();
  if (!active) return;

  const float sum[2] = {quadSum(rowSum[0]), quadSum(rowSum[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.Tq) continue;
    if (p.splits == 1) {
      const float inv = 1.f / fmaxf(sum[r], 1e-30f);
      float* o = p.out + b * p.ob + row * p.ot + h * p.oh;
#pragma unroll
      for (int n = 0; n < DT; ++n) store2(o, 8 * n + 2 * t, D, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    } else {
      const long long slot = ((long long)split * gridDim.y + bh) * p.Tq + row;
      float* o = p.partAcc + slot * D;
#pragma unroll
      for (int n = 0; n < DT; ++n) store2(o, 8 * n + 2 * t, D, acc[n][2 * r], acc[n][2 * r + 1]);
      if (t == 0) {   // scalar stores: with D odd the pairs need not be 8-byte aligned
        p.partStat[2 * slot] = rowMax[r];
        p.partStat[2 * slot + 1] = sum[r];
      }
    }
  }
}

// one thread per output element: out = sum_s acc_s e^(m_s - M) / max(L, 1e-30)
__global__ void mergeSplitsKernel(const Params p, int BH) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)BH * p.Tq;
  if (e >= rows * p.D) return;
  const long long slot = e / p.D;
  const int c = e % p.D, bh = slot / p.Tq, row = slot % p.Tq;
  float top = -INFINITY;
  for (int s = 0; s < p.splits; ++s) top = fmaxf(top, p.partStat[2 * (s * rows + slot)]);
  float total = 0.f, value = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const long long i = s * rows + slot;
    const float w = expf(p.partStat[2 * i] - top);
    total += p.partStat[2 * i + 1] * w;
    value += p.partAcc[i * p.D + c] * w;
  }
  const int b = bh / p.H, h = bh % p.H;
  p.out[b * p.ob + row * p.ot + h * p.oh + c] = value / fmaxf(total, 1e-30f);
}

template <int NW, int DP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> devices{0};
  const int bytes = ringBytes<DP>();
  const cudaError_t err = mcq::allowSharedBytes(flashAttentionKernel<NW, DP>, bytes, devices);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + 16 * NW - 1) / (16 * NW), B * p.H, p.splits);
  flashAttentionKernel<NW, DP><<<grid, NW * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launchWarps(const Params& p, int B, int warps, cudaStream_t stream) {
  switch (warps) {
    case 1: return launch<1, DP>(p, B, stream);
    case 2: return launch<2, DP>(p, B, stream);
    case 4: return launch<4, DP>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_flash_max_head_dim() { return DMAX; }

int mcq_flash_key_tile() { return BK; }

// q [B, Tq, H, D], k and v [B, Tk, H, D], out [B, Tq, H, D]: fp32 on the
// device, D contiguous, the other strides (batch, row, head) in elements.
// mask: int8 [Tq, Tk] with row stride maskRow, or null. warps, splits and
// keysPerSplit come from ops/attention_cuda.py::attentionPlan; with
// splits > 1, partAcc holds splits * B * H * Tq * D floats and partStat
// splits * B * H * Tq * 2. The wrapper checks the shapes.
int mcq_flash_attention(const float* q, const float* k, const float* v, const int8_t* mask,
                        long long maskRow, float* out, float* partAcc, float* partStat, int B,
                        int H, int Tq, int Tk, int D, int warps, int splits, int keysPerSplit,
                        float scale, long long qsb, long long qst, long long qsh,
                        long long ksb, long long kst, long long ksh, long long vsb,
                        long long vst, long long vsh, long long osb, long long ost,
                        long long osh, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > DMAX ||
      (long long)B * H > 65535 || splits <= 0 || splits > 65535 || keysPerSplit % BK != 0 ||
      (long long)(splits - 1) * keysPerSplit >= Tk || (long long)splits * keysPerSplit < Tk ||
      (splits > 1 && (partAcc == nullptr || partStat == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 && (ksb | kst | ksh) % 4 == 0 &&
                   (vsb | vst | vsh) % 4 == 0;
  const Params p{q,   k,   v,   mask, maskRow, out, partAcc, partStat,
                 H,   Tq,  Tk,  D,    keysPerSplit, splits, scale, vec,
                 qsb, qst, qsh, ksb,  kst,  ksh, vsb, vst, vsh, osb, ost, osh};
  cudaError_t err = D <= 64 ? launchWarps<64>(p, B, warps, stream)
                            : launchWarps<128>(p, B, warps, stream);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)B * H * Tq * D;
  mergeSplitsKernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(p, B * H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
