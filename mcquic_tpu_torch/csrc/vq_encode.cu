// K1: nearest-codeword search of the multi-codebook quantizer, for sm_90a.
//
// Replaces mcquic_tpu/ops/vq_pallas.py::vqEncodeResident (kernel
// _residentKernel). For each group g and token t it returns
//     argmin_j  ||c[g,j]||^2 - 2 x[g,t] . c[g,j]
// with ties going to the lowest j. The distance of a pair is defined by fp32
// arithmetic: one fmaf chain over d in increasing order from 0, then
// fmaf(-2, dot, c2), with c2 the plain version's norms (ops/vq.py::
// vqEncodePlain, ops/vq_grouped_cuda.py::codewordNorms). The codes are the
// exact argmin of those distances.
//
// Bound: at qp-2 level 0 (m 2, T 1536, k 8192, d 64) the work is 3.2 GFLOP
// against 4.8 MB of inputs; at the TF32 rate the tensor cores need 6.5 us,
// the memory 1.4 us, so operations bound it.
//
// Design: an exact argmin through a tensor-core filter.
//  * Filter. A block of 4 warps owns a tile of 128 tokens of one group (64
//    where d > 176, for shared memory), resident in shared memory for the
//    whole walk, and walks a k-split of 64-codeword tiles that arrive
//    through a cp.async ring (csrc/cp_async.cuh; 16-byte copies where d %
//    4 == 0 and the pointers allow, 4-byte ones otherwise; columns from d
//    up to a multiple of 8 are zero-filled). Each warp owns 16 or 32 token
//    rows and computes dot~ for all 64 codewords of the tile with one
//    mma.sync.m16n8k8 in TF32 per k8 step (csrc/tf32_mma.cuh): the raw fp32
//    bits go in, the tensor core truncates them, nothing is split or
//    converted. The approximate distance is dist~ = fmaf(-2, dot~, c2).
//    For d up to 64 a warp keeps its token fragments in registers for the
//    whole walk (two blocks of 215 registers per SM, a 3-stage ring); for d
//    up to 16 a 2-stage ring and at most 170 registers let three blocks
//    share an SM, which ran faster at qp-12's level 0 on the card.
//  * Margin. For token x and codeword c_j,
//        |dist~_j - dist_j| <= delta_j = kappa |x| |c_j| + 2^-20 c2_j,
//        kappa = 4 (2^-9 + d 2^-23) + 2^-19.
//    TF32 truncation loses under 2^-10 of each operand, so the products
//    lose at most (2^-9 + 2^-20) |x_i c_i| each and their sum, by
//    Cauchy-Schwarz, (2^-9 + 2^-20) |x| |c|; summing d terms in fp32 (the
//    tensor core's order, which is not documented, and the fmaf chain) adds
//    at most d 2^-24 |x| |c| each. The difference of the two dots is
//    doubled by the -2 and doubled again as a safety factor against the
//    tensor core's undocumented summation: 4 (2^-9 + d 2^-23). The terms
//    2^-19 |x| |c| and 2^-20 c2 cover the rounding of both distances, of
//    the margin and of the bounds (|dist| <= c2 + 2 |x| |c|), each well
//    under 2^-22 of that. A larger margin only costs rescoring. A lane
//    takes one margin for its 16 columns of a tile, D = kappa |x| max |c_j|
//    + 2^-20 max c2_j >= delta_j, so that a codeword costs one fmaf and a
//    minimum in the common case.
//  * Candidates. Each row keeps U, the least upper bound dist~_j + D seen
//    so far (the tile's bounds folded in before it is tested). A codeword
//    is a candidate when its lower bound dist~_j - D <= U. One that fails
//    is beaten exactly by the codeword h that holds U:
//        dist_j >= dist~_j - D > U = dist~_h + D_h >= dist_h,
//    and h was rescored, since its own lower bound is at most U. So no
//    codeword that fails can be the argmin or tie with it. One pass: the
//    candidates cluster where U falls (about ln(tiles) per row).
//  * Rescoring. A lane recomputes its candidates from the same
//    shared-memory tiles with the fmaf chain, two at a time so that the two
//    dependent chains interleave, and folds each into an exact (best,
//    index) per row, replacing on a smaller distance or an equal one at a
//    lower index. The quad's lanes are reduced the same way.
//  * Splits. Where the grid needs splits over k to fill the card, each
//    split runs the argument against its own U, and the splits combine with
//    one 64-bit atomicMin per token on orderedBits(dist) << 32 | index
//    (-0.0 as +0.0), so the lowest index wins ties in any order; the
//    launcher resets the keys first and unpacks them after. Without splits
//    the codes are written directly: one launch. The plan is a plain
//    Python function, ops/vq_cuda.py::k1Plan.
//
// Launchers are plain C functions over raw device pointers and a stream, so
// the library needs no PyTorch headers (see ops/vq_cuda.py).
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

constexpr int NW = 4;                // warps per block
constexpr int THREADS = NW * 32;
constexpr int BK = 64;               // codewords per tile
constexpr int NT = BK / 8;           // n8 tiles per codeword tile
constexpr int WIDE_D = 176;          // d rounded up to 8 past which the tile is 64 tokens
constexpr int RESIDENT_STEPS = 8;    // d up to 64 keeps the token fragments in registers
constexpr int NARROW_STEPS = 2;      // ... in fewer of them for d up to 16

struct Args {
  const float* x;          // [m, T, d]
  const float* codebook;   // [m, k, d]
  const float* c2;         // [m, k], the plain version's norms
  const float* cn;         // [m, k], sqrt(c2)
  unsigned long long* keys;       // [m, T] with splits > 1, else null
  int32_t* codes;                 // [m, T] without splits
  unsigned long long* rescored;   // a counter of rescored pairs, or null
  int T, k, d, tilesPerSplit;
  float kappa;
  bool vec;                // 16-byte copies
};

__device__ __forceinline__ bool isBetter(float d, int i, float bestD, int bestI) {
  return d < bestD || (d == bestD && i < bestI);
}

// v[0] = min(v[0 .. 2W)), as a tree of minima rather than a chain
template <int W>
__device__ __forceinline__ void treeMin(float* v) {
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = fminf(v[i], v[i + W]);
  if constexpr (W > 1) treeMin<W / 2>(v);
}

__device__ __forceinline__ unsigned long long packKey(float dist, int idx) {
  if (dist == 0.f) dist = 0.f;  // -0.0 -> +0.0
  unsigned u = __float_as_uint(dist);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(idx);
}

// padded width of d: a multiple of 8 (one k8 step), row stride DP + 4 (a
// stride of 4 mod 8 floats keeps the fragment reads free of bank conflicts)
__host__ __device__ constexpr int paddedD(int d) { return (d + 7) / 8 * 8; }

template <int BT, int STAGES>
__host__ __device__ constexpr int sharedFloats(int d) {
  return BT * (paddedD(d) + 4) + STAGES * (BK * (paddedD(d) + 4) + 2 * BK);
}

// MT m16 tiles per warp (BT = 64 MT tokens per block); KS > 0 keeps a warp's
// token fragments in registers for d up to 8 KS, KS == 0 reads them from
// shared memory at every tile; MIN_BLOCKS per SM caps the registers. grid
// (ceil(T / BT), splits, m), THREADS threads, sharedFloats<BT, STAGES>(d) * 4
// bytes.
template <int MT, int STAGES, int KS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) vqNearestKernel(const Args a) {
  constexpr int BT = NW * 16 * MT, ROWS = 2 * MT;   // a lane's rows: 16 mi + gr + 8 r
  extern __shared__ float4 smemRaw[];
  const int d = a.d, DP = paddedD(d), S = DP + 4;
  float* xs = reinterpret_cast<float*>(smemRaw);   // [BT][S] tokens
  float* ring = xs + BT * S;                        // per stage: [BK][S] codewords, c2 [BK], cn [BK]
  const int stageFloats = BK * S + 2 * BK;

  const int g = blockIdx.z, t0 = blockIdx.x * BT;
  const int kBegin = blockIdx.y * a.tilesPerSplit * BK;
  const int kEnd = min(a.k, kBegin + a.tilesPerSplit * BK);
  const int tiles = (kEnd - kBegin + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const float* xg = a.x + (size_t)g * a.T * d;
  const float* cg = a.codebook + (size_t)g * a.k * d;
  const float* c2g = a.c2 + (size_t)g * a.k;
  const float* cng = a.cn + (size_t)g * a.k;

  // copies: a warp's lanes cover `rowsPerPass` rows of `pieces` pieces each
  // (4 floats, or 1 on the 4-byte route); the divisions happen once
  const int unit = a.vec ? 4 : 1, pieces = DP / unit;
  const int perRow = min(pieces, 32), rowsPerPass = 32 / perRow;
  const int laneRow = lane / perRow, lanePiece = lane - laneRow * perRow;
  auto loadRows = [&](float* dst, const float* src, int row0, int rows, int limit) {
    if (laneRow >= rowsPerPass) return;
    for (int r = warp * rowsPerPass + laneRow; r < rows; r += NW * rowsPerPass) {
      const int row = row0 + r;
      for (int p = lanePiece; p < pieces; p += perRow) {
        const int c = p * unit;
        const bool ok = row < limit && c < d;
        const float* from = src + (ok ? (size_t)row * d + c : 0);
        if (a.vec)
          cpAsync16(dst + r * S + c, from, ok);
        else
          cpAsync4(dst + r * S + c, from, ok);
      }
    }
  };
  auto loadTile = [&](int tile) {
    float* cs = ring + (tile % STAGES) * stageFloats;
    const int j0 = kBegin + tile * BK;
    loadRows(cs, cg, j0, BK, kEnd);
    if (tid < 2 * BK) {   // c2 and cn of the tile's codewords
      const int j = tid % BK;
      const bool ok = j0 + j < kEnd;
      cpAsync4(cs + BK * S + tid, (tid < BK ? c2g : cng) + (ok ? j0 + j : 0), ok);
    }
  };

  loadRows(xs, xg, t0, BT, a.T);
  loadTile(0);
  cpCommit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < tiles) loadTile(s);
    cpCommit();
  }

  const int rowBase = warp * 16 * MT;
  const bool active = t0 + rowBase < a.T;
  const int dSteps = DP / 8;
  float xk[ROWS], U[ROWS], best[ROWS];
  int arg[ROWS];
  unsigned long long live = 0;   // candidate bits of rows before T: rows past it are never rescored
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    U[q] = best[q] = __int_as_float(0x7f800000);   // +inf
    arg[q] = kBegin;
    xk[q] = 0.f;
    if (t0 + rowBase + 16 * (q >> 1) + gr + 8 * (q & 1) < a.T) live |= 0xffffull << (16 * q);
  }
  uint32_t ar[KS > 0 ? MT : 1][KS > 0 ? KS : 1][4];   // resident token fragments
  unsigned count = 0;

  for (int tile = 0; tile < tiles; ++tile) {
    cpWait<STAGES - 2>();
    __syncthreads();   // this tile (and at the first, the tokens) landed; the last one is consumed
    if (tile + STAGES - 1 < tiles) loadTile(tile + STAGES - 1);
    cpCommit();
    if (!active) continue;   // an idle warp still copies and meets the barriers

    if (tile == 0) {   // kappa |x| per row: each lane sums every 4th column, then the quad
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const float* xr = xs + (rowBase + 16 * (q >> 1) + gr + 8 * (q & 1)) * S;
        float s = 0.f;
        for (int c = tq; c < d; c += 4) s = fmaf(xr[c], xr[c], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        xk[q] = a.kappa * sqrtf(s);
      }
      if constexpr (KS > 0) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const float* xr = xs + (rowBase + 16 * mi + gr) * S + 8 * s + tq;
            const bool in = s < dSteps;
            ar[mi][s][0] = in ? __float_as_uint(xr[0]) : 0u;
            ar[mi][s][1] = in ? __float_as_uint(xr[8 * S]) : 0u;
            ar[mi][s][2] = in ? __float_as_uint(xr[4]) : 0u;
            ar[mi][s][3] = in ? __float_as_uint(xr[8 * S + 4]) : 0u;
          }
      }
    }

    const float* cs = ring + (tile % STAGES) * stageFloats;
    const float* c2s = cs + BK * S;
    const float* cns = c2s + BK;

    // dot~ on the tensor cores: A the tokens, B the codewords (b0 = c[8n + gr][8s + tq])
    float acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][n][i] = 0.f;
    auto kStep = [&](int s, uint32_t (*af)[4]) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* cr = cs + (8 * n + gr) * S + 8 * s + tq;
        bf[n][0] = __float_as_uint(cr[0]);
        bf[n][1] = __float_as_uint(cr[4]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < NT; ++n) mcq::mma(acc[mi][n], af[mi], bf[n]);
    };
    if constexpr (KS > 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s >= dSteps) break;
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int i = 0; i < 4; ++i) af[mi][i] = ar[mi][s][i];
        kStep(s, af);
      }
    } else {
      for (int s = 0; s < dSteps; ++s) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float* xr = xs + (rowBase + 16 * mi + gr) * S + 8 * s + tq;
          af[mi][0] = __float_as_uint(xr[0]);
          af[mi][1] = __float_as_uint(xr[8 * S]);
          af[mi][2] = __float_as_uint(xr[4]);
          af[mi][3] = __float_as_uint(xr[8 * S + 4]);
        }
        kStep(s, af);
      }
    }

    // the bounds: C layout, acc[mi][n][2r + c] is row 16 mi + gr + 8 r, column
    // 8 n + 2 tq + c; acc becomes dist~
    const int j0 = kBegin + tile * BK, valid = kEnd - j0;
    const bool full = valid >= BK;
    // a lane's margin over its 16 columns of the tile: delta_j <= D for
    // each of them, D = kappa |x| max |c_j| + 2^-20 max c2_j (zero-filled
    // columns past the split add nothing to the maxima)
    float2 c2v[NT];
    float cnMax = 0.f, c2Max = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      c2v[n] = *reinterpret_cast<const float2*>(c2s + 8 * n + 2 * tq);
      const float2 cn = *reinterpret_cast<const float2*>(cns + 8 * n + 2 * tq);
      cnMax = fmaxf(cnMax, fmaxf(cn.x, cn.y));
      c2Max = fmaxf(c2Max, fmaxf(c2v[n].x, c2v[n].y));
    }
    const float ec2 = 0x1p-20f * c2Max;
    unsigned long long cand = 0;   // bit 16 q + 2 n + c
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int mi = q >> 1, r = q & 1;
      const float D = fmaf(xk[q], cnMax, ec2);
      float low[2 * NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float dt = fmaf(-2.f, acc[mi][n][2 * r + c], c ? c2v[n].y : c2v[n].x);
          if (!full && 8 * n + 2 * tq + c >= valid) dt = __int_as_float(0x7f800000);
          acc[mi][n][2 * r + c] = dt;
          low[2 * n + c] = dt;
        }
      treeMin<NT>(low);
      // fold the quad's least upper bound into U; the candidates are the
      // codewords whose lower bound dist~ - D reaches it
      float upper = low[0] + D;
      upper = fminf(upper, __shfl_xor_sync(0xffffffffu, upper, 1));
      upper = fminf(upper, __shfl_xor_sync(0xffffffffu, upper, 2));
      U[q] = fminf(U[q], upper);
      const float limit = U[q] + D;
      if (low[0] <= limit) {   // most lanes have no candidate in most tiles
        unsigned bits = 0;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool ok = full || 8 * n + 2 * tq + c < valid;
            bits |= (ok && acc[mi][n][2 * r + c] <= limit ? 1u : 0u) << (2 * n + c);
          }
        cand |= (unsigned long long)bits << (16 * q);
      }
    }
    cand &= live;

    // rescore the candidates with the fmaf chain, two at a time so that the
    // two chains interleave; the columns past d are zeros, and fmaf(0, 0,
    // dot) leaves the distance as it is
    while (cand) {
      const int b0 = __ffsll(static_cast<long long>(cand)) - 1;
      cand &= cand - 1;
      const int b1 = cand ? __ffsll(static_cast<long long>(cand)) - 1 : b0;
      if (cand) cand &= cand - 1;
      const int col0 = 8 * ((b0 & 15) >> 1) + 2 * tq + (b0 & 1);
      const int col1 = 8 * ((b1 & 15) >> 1) + 2 * tq + (b1 & 1);
      const int q0 = b0 >> 4, q1 = b1 >> 4;
      const float* x0 = xs + (rowBase + 16 * (q0 >> 1) + gr + 8 * (q0 & 1)) * S;
      const float* x1 = xs + (rowBase + 16 * (q1 >> 1) + gr + 8 * (q1 & 1)) * S;
      const float* cr0 = cs + col0 * S;
      const float* cr1 = cs + col1 * S;
      float dot0 = 0.f, dot1 = 0.f;
      for (int i = 0; i < DP; i += 4) {
        const float4 xv0 = *reinterpret_cast<const float4*>(x0 + i);
        const float4 cv0 = *reinterpret_cast<const float4*>(cr0 + i);
        const float4 xv1 = *reinterpret_cast<const float4*>(x1 + i);
        const float4 cv1 = *reinterpret_cast<const float4*>(cr1 + i);
        dot0 = fmaf(xv0.x, cv0.x, dot0);
        dot1 = fmaf(xv1.x, cv1.x, dot1);
        dot0 = fmaf(xv0.y, cv0.y, dot0);
        dot1 = fmaf(xv1.y, cv1.y, dot1);
        dot0 = fmaf(xv0.z, cv0.z, dot0);
        dot1 = fmaf(xv1.z, cv1.z, dot1);
        dot0 = fmaf(xv0.w, cv0.w, dot0);
        dot1 = fmaf(xv1.w, cv1.w, dot1);
      }
      const float dist0 = fmaf(-2.f, dot0, c2s[col0]), dist1 = fmaf(-2.f, dot1, c2s[col1]);
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {   // unrolled, so best and arg stay in registers
        if (q == q0 && isBetter(dist0, j0 + col0, best[q], arg[q])) {
          best[q] = dist0;
          arg[q] = j0 + col0;
        }
        if (q == q1 && isBetter(dist1, j0 + col1, best[q], arg[q])) {
          best[q] = dist1;
          arg[q] = j0 + col1;
        }
      }
      count += b1 != b0 ? 2 : 1;
    }
  }
  cpWait<0>();
  if (!active) return;

  if (a.rescored != nullptr) {
    const unsigned total = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0) atomicAdd(a.rescored, (unsigned long long)total);
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    float b = best[q];
    int i = arg[q];
#pragma unroll
    for (int offset = 1; offset < 4; offset <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, offset);
      const int oi = __shfl_xor_sync(0xffffffffu, i, offset);
      if (isBetter(ob, oi, b, i)) {
        b = ob;
        i = oi;
      }
    }
    const int t = t0 + rowBase + 16 * (q >> 1) + gr + 8 * (q & 1);
    if (tq == 0 && t < a.T) {
      if (a.keys == nullptr) {
        a.codes[(size_t)g * a.T + t] = i;
      } else {
        unsigned long long* slot = a.keys + (size_t)g * a.T + t;
        const unsigned long long key = packKey(b, i);
        // keys only decrease, so a stale read can only cost an extra atomic
        if (key < *reinterpret_cast<volatile unsigned long long*>(slot)) atomicMin(slot, key);
      }
    }
  }
}

__global__ void vqUnpackKeysKernel(const unsigned long long* __restrict__ keys, int mT,
                                   int32_t* __restrict__ codes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < mT) codes[e] = static_cast<int32_t>(keys[e] & 0xffffffffull);
}

// MAX_D: the largest d an instance takes; its shared memory is allowed once
// per device for that d, so that a later call with a larger d still fits
template <int MT, int STAGES, int KS, int MIN_BLOCKS, int MAX_D>
cudaError_t launch(const Args& a, int m, int splits, cudaStream_t stream) {
  static std::atomic<unsigned long long> devices{0};
  constexpr auto kernel = vqNearestKernel<MT, STAGES, KS, MIN_BLOCKS>;
  constexpr int BT = NW * 16 * MT;
  const int bytes = sharedFloats<BT, STAGES>(a.d) * 4;
  const cudaError_t err =
      mcq::allowSharedBytes(kernel, sharedFloats<BT, STAGES>(MAX_D) * 4, devices);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + BT - 1) / BT, splits, m);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mcq_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mcq_vq_tile_codewords() { return BK; }

int mcq_vq_wide_d() { return WIDE_D; }

// x [m, T, d], codebook [m, k, d], c2 and cn [m, k] (fp32, contiguous, on
// the device); codes [m, T] int32; keys [m, T] uint64 scratch when splits >
// 1 (else null); rescored a uint64 counter or null. blockTokens (128 where
// d rounded up to 8 is at most WIDE_D, else 64), splits and tilesPerSplit
// come from ops/vq_cuda.py::k1Plan.
int mcq_vq_nearest(const float* x, const float* codebook, const float* c2, const float* cn,
                   int32_t* codes, unsigned long long* keys, unsigned long long* rescored,
                   int m, int T, int k, int d, int blockTokens, int splits, int tilesPerSplit,
                   cudaStream_t stream) {
  const long long tiles = (k + BK - 1) / BK;
  if (m <= 0 || T <= 0 || k <= 0 || d <= 0 || d > 256 || m > 65535 || splits <= 0 ||
      splits > 65535 || tilesPerSplit <= 0 || (long long)(splits - 1) * tilesPerSplit >= tiles ||
      (long long)splits * tilesPerSplit < tiles || (splits > 1 && keys == nullptr) ||
      blockTokens != (paddedD(d) <= WIDE_D ? 128 : 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mT = m * T;
  cudaError_t err = cudaSuccess;
  if (splits > 1) {
    err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * (size_t)mT, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codebook) % 16 == 0;
  const float kappa = 4.f * (0x1p-9f + d * 0x1p-23f) + 0x1p-19f;
  const Args a{x, codebook, c2, cn, splits > 1 ? keys : nullptr, codes, rescored,
               T, k, d, tilesPerSplit, kappa, vec};
  constexpr int narrow = 8 * NARROW_STEPS, resident = 8 * RESIDENT_STEPS;
  // d up to 16 (Neon, qp-12): a 2-stage ring and at most 170 registers, so
  // that three blocks share an SM; d up to 64 (qp-2): 3 stages, the token
  // fragments in registers, two blocks
  err = blockTokens == 64      ? launch<1, 2, 0, 1, 256>(a, m, splits, stream)
        : paddedD(d) <= narrow   ? launch<2, 2, NARROW_STEPS, 3, narrow>(a, m, splits, stream)
        : paddedD(d) <= resident ? launch<2, 3, RESIDENT_STEPS, 1, resident>(a, m, splits, stream)
                                 : launch<2, 3, 0, 1, WIDE_D>(a, m, splits, stream);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  vqUnpackKeysKernel<<<(mT + 255) / 256, 256, 0, stream>>>(keys, mT, codes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
