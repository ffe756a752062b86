// Warp-level tensor-core building blocks for the redesigned K3, K2h and
// K1's FP32 chain (csrc/chain.cuh, csrc/march.cuh): mma.sync
// in inline PTX, the splits of an FP32 value into tensor-core operands, and
// the products at the two precisions (the fragment loaders are in
// csrc/chain.cuh).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8" and
// "mma.m16n8k16"), lane = 4 * g + t (g = lane / 4, the group; t = lane % 4):
//   * C/D of both shapes, 16 x 8 FP32: c0, c1 at row g, columns 2t, 2t + 1;
//     c2, c3 at row g + 8, the same columns.
//   * m16n8k8 tf32: A 16 x 8, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4); B 8 x 8, b0 (k = t, n = g), b1 (k = t + 4, n = g).
//   * m16n8k16 bf16: A 16 x 16, two values per register, the lower column in
//     the low half: a0 row g, columns 2t, 2t + 1; a1 row g + 8, the same;
//     a2 row g, columns 2t + 8, 2t + 9; a3 row g + 8, the same. B 16 x 8:
//     b0 rows k = 2t, 2t + 1; b1 rows 2t + 8, 2t + 9; column n = g.
//
// The accumulator-to-A hand-off: the bf16 A fragment of k-chunk kk (columns
// 16kk..16kk+15) is exactly what C of n-tiles 2kk and 2kk + 1 holds, in the
// same lanes (a0 = c0, c1 of n-tile 2kk, a1 = its c2, c3, a2 and a3 those of
// n-tile 2kk + 1), so one layer's output feeds the next without leaving the
// registers. The tf32 A fragment wants columns t and t + 4 where C holds 2t
// and 2t + 1: the kernels permute the contraction index instead, feeding
// physical column 2t as the MMA's k = t and 2t + 1 as k = t + 4, in A and
// in B alike (kernels/fused_mlp.py packed_mma packs the weights so). A
// contraction does not depend on the order of its index, so the product is
// unchanged, and a lane then reads its a0/a2 (and a1/a3) pair of a row as
// one 64-bit load. Under that permutation the tf32 A fragment of k-chunk j
// (columns 8j..8j+7) is what C of n-tile j holds, in the same lanes: a0 =
// c0, a1 = c2, a2 = c1, a3 = c3 (K1's FP32 chain at widths 32 and 64 hands
// each layer's output to the next so).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cnr {

// D = A * B + D, m16n8k8, tf32 inputs (the low 13 bits of each ignored),
// FP32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A * B + D, m16n8k16, bfloat16 inputs, FP32 accumulation. A product of
// two bfloat16 values is exact in FP32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as the bits of a float32 whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: x ~ big + small, big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// The three-pass split of two neighbouring values (the lower column first)
// into their bfloat16 halves, packed as an A-fragment register each:
// hi = bf16(x), lo = bf16(x - hi), round to nearest even (the plain
// version's split, fused_mlp.split_hi_lo).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x0, __low2float(h)),
                                                 __fsub_rn(x1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Where the sums round. A tensor core adds its products and the C operand
// with truncation (toward zero), not to nearest: accumulating a whole
// contraction in its C operand loses about an ulp of the running sum per
// MMA, always the same way, so the error grows with the width (3xTF32
// accumulated so misses the fused forward's 1e-5 bar against the FP32 chain
// at the wide widths). Both products below therefore start each k-chunk's
// MMAs from zero and add the chunk's sum to the FP32 accumulator with a
// round-to-nearest add, as an FP32 GEMM would: the truncation then only
// touches one chunk's sum (8 or 16 products), whose sign varies. K1's
// 3xTF32 product from width 128 also rounds that chunk sum to even
// (round_to_even below); at 32 and 64 it recovers what the truncation
// dropped with one more MMA instead (mma_tf32_tiles).

// The products below issue pass by pass over N independent tiles (all the
// first products, then all the second, ...), so that N MMAs are in flight
// where one tile's three would wait on each other.

// acc[j] += x * w_j on the tensor cores at the three-pass precision, for N
// n-tiles j sharing the A fragments: x_lo * w_hi, x_hi * w_lo, then
// x_hi * w_hi over one k-chunk of 16 (the small terms first, so they are
// not lost against the large one), then one rounded add into the FP32
// accumulator. The lo * lo term is dropped, as XLA's Precision.HIGH drops
// it. w[j] is one lane's packed B fragment: {b0 hi, b1 hi, b0 lo, b1 lo}.
template <int N>
__device__ __forceinline__ void mma_3pass(float (&acc)[N][4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], const uint4 (&w)[N]) {
  float d[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
    mma_bf16(d[j], alo, w[j].x, w[j].y);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_bf16(d[j], ahi, w[j].z, w[j].w);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_bf16(d[j], ahi, w[j].x, w[j].y);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], d[j][i]);
}

// A tensor core's FP32 result rounded to even: each odd value moves one ulp
// away from zero (an integer add on its bits, which carries into the
// exponent where it must). The truncated t of an exact sum s has |s| in
// [|t|, |t| + ulp), so t is low by half an ulp on average, always toward
// zero, and across a chain's layers of ReLU units that adds up (3e-7 on
// csg_demo widened's SDF, tests/test_torch_k1mma.py); t rounded to even is
// low by nothing on average (fused_mlp.round_truncated_to_even).
__device__ __forceinline__ float round_to_even(float t) {
  const int bits = __float_as_int(t);
  return __int_as_float(bits + (bits & 1));
}

// acc[j] += a * b_j at FP32-grade precision on the tf32 tensor cores
// (3xTF32), for N n-tiles j sharing the A fragments of one m-tile, the B
// pairs given split (bbig, bsmall: split_tf32 of one lane's {b0, b1}):
// a_small * b_big, a_big * b_small, then a_big * b_big over one k-chunk of
// 8 from zero, then the chunk's sum rounded to even (round_to_even) and
// added to the FP32 accumulator with a rounded add. The a_small * b_small
// term (2^-22 relative) is dropped. The 128-wide march applies one split
// B pair to several m-tiles (csrc/hidden128_group.cuh).
template <int N>
__device__ __forceinline__ void mma_3xtf32_split(float (&acc)[N][4], const uint32_t (&abig)[4],
                                                 const uint32_t (&asmall)[4],
                                                 const uint32_t (&bbig)[N][2],
                                                 const uint32_t (&bsmall)[N][2]) {
  float d[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
    mma_tf32(d[j], asmall, bbig[j][0], bbig[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], abig, bsmall[j][0], bsmall[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], abig, bbig[j][0], bbig[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], round_to_even(d[j][i]));
}

// The same from one lane's FP32 B pairs b[j] = {b0, b1}, split into big /
// small here (K1's FP32 chain from width 256, the value-and-gradient
// kernel, X1).
template <int N>
__device__ __forceinline__ void mma_3xtf32_rows(float (&acc)[N][4], const uint32_t (&abig)[4],
                                                const uint32_t (&asmall)[4],
                                                const float2 (&b)[N]) {
  uint32_t bbig[N][2], bsmall[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    split_tf32(b[j].x, bbig[j][0], bsmall[j][0]);
    split_tf32(b[j].y, bbig[j][1], bsmall[j][1]);
  }
  mma_3xtf32_split(acc, abig, asmall, bbig, bsmall);
}

// acc[m][j] += a_m * b_j at FP32-grade precision on the tf32 tensor cores,
// for M m-tiles m and N n-tiles j at once (K1's FP32 chain at widths 32
// and 64, both m-tiles of a warp's rays), each k-chunk's sum added to the
// FP32 accumulator nearly as a correctly rounded FP32 sum: the big pass
// first from zero on the negated A, u = -t, t = a_big * b_big truncated;
// then d = a_big * b_big + u, what that truncation dropped (up to the
// products' alignment, which C = u may move up by the few bits |t| has
// over the largest product), then a_small * b_big,
// a_big * b_small and, with kPasses = 4, a_small * b_small into d (small
// terms on a small accumulator); then acc += t + d with round-to-nearest
// adds. Each B pair is split once for the M m-tiles, each A fragment given
// split (big, its negation nbig, small) once for the N n-tiles; M * N
// independent tiles a pass. 4 or 5 MMAs a tile and k-chunk.
template <int kPasses, int M, int N>
__device__ __forceinline__ void mma_tf32_tiles(float (&acc)[M][N][4],
                                               const uint32_t (&abig)[M][4],
                                               const uint32_t (&nbig)[M][4],
                                               const uint32_t (&asmall)[M][4],
                                               const float2 (&b)[N]) {
  static_assert(kPasses == 3 || kPasses == 4, "3 or 4 products a weight");
  uint32_t bbig[N][2], bsmall[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    split_tf32(b[j].x, bbig[j][0], bsmall[j][0]);
    split_tf32(b[j].y, bbig[j][1], bsmall[j][1]);
  }
  float u[M][N][4], d[M][N][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) u[m][j][i] = 0.f;
      mma_tf32(u[m][j], nbig[m], bbig[j][0], bbig[j][1]);
    }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[m][j][i] = u[m][j][i];
      mma_tf32(d[m][j], abig[m], bbig[j][0], bbig[j][1]);
    }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[m][j], asmall[m], bbig[j][0], bbig[j][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[m][j], abig[m], bsmall[j][0], bsmall[j][1]);
  if constexpr (kPasses == 4) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < N; ++j) mma_tf32(d[m][j], asmall[m], bsmall[j][0], bsmall[j][1]);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[m][j][i] = __fadd_rn(acc[m][j][i], __fsub_rn(d[m][j][i], u[m][j][i]));
}

// acc[m] += a_m * b at FP32-grade precision on the tf32 tensor cores
// (3xTF32), for N m-tiles m sharing the B fragments: a_small * b_big,
// a_big * b_small, then a_big * b_big over one k-chunk of 8, then one
// rounded add into the FP32 accumulator; the a_small * b_small term (2^-22
// relative) is dropped.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[N][4], const uint32_t (&abig)[N][4],
                                           const uint32_t (&asmall)[N][4], uint32_t b0big,
                                           uint32_t b1big, uint32_t b0small, uint32_t b1small) {
  float d[N][4];
#pragma unroll
  for (int m = 0; m < N; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[m][i] = 0.f;
    mma_tf32(d[m], asmall[m], b0big, b1big);
  }
#pragma unroll
  for (int m = 0; m < N; ++m) mma_tf32(d[m], abig[m], b0small, b1small);
#pragma unroll
  for (int m = 0; m < N; ++m) mma_tf32(d[m], abig[m], b0big, b1big);
#pragma unroll
  for (int m = 0; m < N; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = __fadd_rn(acc[m][i], d[m][i]);
}

}  // namespace cnr
