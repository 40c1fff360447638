// TF32 tensor-core helpers shared by the kernels that run mma.sync.m16n8k8
// (K1, csrc/vq_encode.cu; K2, csrc/thin_head.cu; K3, csrc/flash_attention.cu).
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The tensor core reads a .tf32 operand as an fp32 bit pattern and ignores
// its low 13 bits, so raw fp32 bits go in as they are (a truncation).
#pragma once
#include <cstdint>

namespace mcq {

// x = hi + lo: hi is x rounded to TF32 (ties away from zero, as
// cvt.rna.tf32.f32 rounds) with two integer operations, since the
// conversion unit's cvt runs at a fraction of the ALU rate and was K3's
// bottleneck; lo = x - hi is exact and goes in as it is, the tensor core
// ignoring its low 13 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b in TF32 with fp32 accumulators; not volatile, so the compiler
// may interleave independent products
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a . b[n] for N independent n-tiles in 3xTF32 (lo.hi + hi.lo +
// hi.hi, small terms first; the dropped lo.lo is below fp32 rounding); each
// pass runs over all n so that consecutive products are independent
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const float* a, float (*b)[2], int n) {
  uint32_t ah[4], al[4], bh[N][2], bl[N][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    split(b[j][0], bh[j][0], bl[j][0]);
    split(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) mma(c[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) mma(c[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) mma(c[j], ah, bh[j]);
}

}  // namespace mcq
