// The multiresolution hash encoding (Müller et al., Instant NGP,
// arXiv:2201.05989, section 3) as the input stage of the layer chain at
// width 64: the march kernel's (march.cuh, kHashInputs) FP32 chain a ray
// per thread, its three-pass chain and its ray-per-warp terminal rung, and
// the shading normals' encoding kernel (csrc/hash_grid.cu).
//
// It replaces no TPU kernel: the JAX package has no encoding. Its plain
// version is models/hash_grid.py encode_plain, whose order of operations it
// copies: x = clamp(p * (1 / span) + 0.5, 0, 1), u = s_l * x + 0.5, g = floor(u),
// f = u - g, each corner's weight (w_x * w_y) * w_z and contribution
// w * v rounded on their own, the 8 corners summed in order from corner 0;
// every product and sum with an explicit round-to-nearest intrinsic, so
// nothing is contracted into a fused multiply-add. The encoded features are
// so the plain version's bit for bit, and the ray-per-warp rung, whose
// chain sums in the plain order, marches as the plain version does.
//
// What bounds it: the gathers. An evaluation reads 8 corners of each of 16
// levels, 8 bytes each (a corner's two float32 features are one 64-bit
// load): 1024 bytes scattered over a 48.8 MB table (the published sizes),
// beside 12.4 kFLOP of the MLP. The table nearly fits the H100's 50 MB L2;
// the coarse levels' corners of neighbouring rays share cache lines, the
// hashed levels' do not.
//
// Where the work goes, a ray per thread (the chain's A fragments):
// m16n8k8 tf32 and m16n8k16 bf16 A fragments put, in lane 4g + t, rows
// (rays) 16 mt + 8 half + g and columns 8j + 2t + c (tf32: x[mt][j][half +
// 2c]; bf16: the pair (c = 0, 1) of k-chunk j / 2, register 2 (j % 2) +
// half). Column 8j + 2t + c is feature c of level 4j + t. So each lane
// interpolates levels t, t + 4, t + 8 and t + 12 of the 4 rays of its rows,
// straight into its fragments: 16 (level, ray) pairs a lane, 128 loads, with
// no transposition through shared memory; the rays' positions come by
// shuffles. A ray per warp (split_hash_sdf): lane j interpolates level j / 2
// (both lanes of a level load the same corners, one transaction) and keeps
// feature j % 2, the chain's input j.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace cnr {

// Input stages of the march kernel's chain: the point (and frame) itself,
// or its hash encoding.
enum Inputs : int { kRawInputs = 0, kHashInputs = 1 };

// The levels a table holds at most, and the layout of its level words
// (models/hash_grid.py level_words): kHashMaxLevels words each of scale
// (float32 bits), resolution, first entry, size and hashed, then the level
// count and 1 / span (float32 bits).
constexpr int kHashMaxLevels = 16;

struct HashLevel {
  float scale;
  uint32_t res, first, size;
  bool hashed;
};

__device__ __forceinline__ HashLevel hash_level(const uint32_t* __restrict__ words, int l) {
  HashLevel lv;
  lv.scale = __uint_as_float(__ldg(words + l));
  lv.res = __ldg(words + kHashMaxLevels + l);
  lv.first = __ldg(words + 2 * kHashMaxLevels + l);
  lv.size = __ldg(words + 3 * kHashMaxLevels + l);
  lv.hashed = __ldg(words + 4 * kHashMaxLevels + l) != 0u;
  return lv;
}

__device__ __forceinline__ int hash_levels(const uint32_t* __restrict__ words) {
  return static_cast<int>(__ldg(words + 5 * kHashMaxLevels));
}

// p * (1 / span) + 0.5, unclamped.
__device__ __forceinline__ float hash_unit_raw(float p, const uint32_t* __restrict__ words) {
  return __fadd_rn(__fmul_rn(p, __uint_as_float(__ldg(words + 5 * kHashMaxLevels + 1))), 0.5f);
}

// The point's position in the unit cube: clamped to [0, 1] (the march
// reaches beyond the bound, where the 1:1 levels' indices would wrap).
__device__ __forceinline__ float hash_unit(float p, const uint32_t* __restrict__ words) {
  return fminf(fmaxf(hash_unit_raw(p, words), 0.f), 1.f);
}

// A corner's index within its level, in uint32 arithmetic: 1:1 where the
// grid fits the table, else tiny-cuda-nn's prime hash (a hashed level's
// size is a power of two).
__device__ __forceinline__ uint32_t hash_corner(const HashLevel& lv, uint32_t gx, uint32_t gy,
                                                uint32_t gz) {
  if (lv.hashed) return (gx ^ (gy * 2654435761u) ^ (gz * 805459861u)) & (lv.size - 1u);
  return (gx + gy * lv.res + gz * (lv.res * lv.res)) % lv.size;
}

// The cell of one level at unit position (x, y, z): corner g, the
// weights' two factors on each axis (lower 1 - f, upper f) and the 8
// corners' table entries, in corner order.
struct HashCell {
  float w[3][2];
  float2 v[8];
};

__device__ __forceinline__ HashCell hash_cell(const float2* __restrict__ table,
                                              const HashLevel& lv, float x, float y, float z) {
  HashCell c;
  const float pos[3] = {x, y, z};
  uint32_t g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = __fadd_rn(__fmul_rn(pos[a], lv.scale), 0.5f);
    const float fl = floorf(u);
    const float f = __fsub_rn(u, fl);
    g[a] = static_cast<uint32_t>(static_cast<int>(fl));
    c.w[a][0] = __fsub_rn(1.f, f);
    c.w[a][1] = f;
  }
  const float2* base = table + lv.first;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    c.v[k] = __ldg(base + hash_corner(lv, g[0] + (k & 1), g[1] + ((k >> 1) & 1),
                                      g[2] + ((k >> 2) & 1)));
  return c;
}

// Corner k's weight (w_x * w_y) * w_z.
__device__ __forceinline__ float hash_weight(const HashCell& c, int k) {
  return __fmul_rn(__fmul_rn(c.w[0][k & 1], c.w[1][(k >> 1) & 1]), c.w[2][(k >> 2) & 1]);
}

// The level's two features at unit position (x, y, z), in the plain order.
__device__ __forceinline__ float2 hash_features(const float2* __restrict__ table,
                                                const HashLevel& lv, float x, float y,
                                                float z) {
  const HashCell c = hash_cell(table, lv, x, y, z);
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = hash_weight(c, k);
    const float tx = __fmul_rn(w, c.v[k].x), ty = __fmul_rn(w, c.v[k].y);
    acc = k == 0 ? make_float2(tx, ty) : make_float2(__fadd_rn(acc.x, tx), __fadd_rn(acc.y, ty));
  }
  return acc;
}

// This lane's features of the warp's 32 rays in A-fragment order: for row
// half-block (mt, half) and level group j, the two features of level
// 4j + t of ray 16 mt + 8 half + g, in f[mt][half][j] (zero past the
// table's levels). Every lane passes its ray's unit position.
__device__ __forceinline__ void hash_fragments(const float2* __restrict__ table,
                                               const uint32_t* __restrict__ words, float x,
                                               float y, float z, float2 (&f)[2][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int levels = hash_levels(words);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int src = 16 * mt + 8 * half + g;
      const float rx = __shfl_sync(0xffffffffu, x, src);
      const float ry = __shfl_sync(0xffffffffu, y, src);
      const float rz = __shfl_sync(0xffffffffu, z, src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * j + t;
        f[mt][half][j] = l < levels ? hash_features(table, hash_level(words, l), rx, ry, rz)
                                    : make_float2(0.f, 0.f);
      }
    }
}

// The FP32 chain at H = 64 (chain_tf32_regs) on the encoded rays: the first
// layer a tf32 product over the features' 4 k-chunks (32 columns), then
// the hidden layers and the head.
template <int H>
__device__ __forceinline__ float chain_hash_tf32(const float2* __restrict__ w,
                                                 const float* __restrict__ b, int n_layers,
                                                 const float2* __restrict__ table,
                                                 const uint32_t* __restrict__ words, float px,
                                                 float py, float pz) {
  static_assert(H == 64, "the hash-grid chain runs at width 64");
  constexpr int KT = H / 8;
  float2 f[2][2][4];
  hash_fragments(table, words, hash_unit(px, words), hash_unit(py, words),
                 hash_unit(pz, words), f);
  float x[2][KT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 v = kk < 4 ? f[mt][half][kk] : make_float2(0.f, 0.f);
        x[mt][kk][half] = v.x;
        x[mt][kk][half + 2] = v.y;
      }
  hidden_tf32_regs<H, 4>(w, b, 0, x);
#pragma unroll 1
  for (int l = 1; l < n_layers - 1; ++l) hidden_tf32_regs<H>(w, b, l, x);
  return head_tf32_regs<H>(w, b, n_layers, x);
}

// The three-pass chain at H = 64 (chain_3pass_layers) on the encoded rays:
// the features split into bf16 (hi, lo) pairs, 2 k-chunks of 16.
template <int H>
__device__ __forceinline__ float chain_hash_3pass(const uint4* __restrict__ w,
                                                  const float* __restrict__ b, int n_layers,
                                                  const float2* __restrict__ table,
                                                  const uint32_t* __restrict__ words, float px,
                                                  float py, float pz) {
  static_assert(H == 64, "the hash-grid chain runs at width 64");
  constexpr int KT = H / 16;
  float2 f[2][2][4];
  hash_fragments(table, words, hash_unit(px, words), hash_unit(py, words),
                 hash_unit(pz, words), f);
  uint32_t ahi[2][KT][4], alo[2][KT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r of k-chunk kk: level group j = 2 kk + r / 2, rows half r % 2
        const int j = 2 * kk + r / 2;
        if (j < 4)
          split_bf16x2(f[mt][r % 2][j].x, f[mt][r % 2][j].y, ahi[mt][kk][r], alo[mt][kk][r]);
        else
          ahi[mt][kk][r] = alo[mt][kk][r] = 0u;
      }
  return chain_3pass_layers<H>(w, b, n_layers, ahi, alo, 2);
}

// The ray-per-warp chain (split_sdf) on one encoded point: lane j's input
// is feature j % 2 of level j / 2, the inputs from 32 on zero.
template <int H>
__device__ __forceinline__ float split_hash_sdf(const float* sw, const float* sb, float* xrow,
                                                int n_layers, const float2* __restrict__ table,
                                                const uint32_t* __restrict__ words, float px,
                                                float py, float pz) {
  static_assert(H == 64, "the hash-grid chain runs at width 64");
  const int lane = threadIdx.x & 31, l = lane >> 1;
  float2 v = make_float2(0.f, 0.f);
  if (l < hash_levels(words))
    v = hash_features(table, hash_level(words, l), hash_unit(px, words), hash_unit(py, words),
                      hash_unit(pz, words));
  float x[H / 32] = {lane & 1 ? v.y : v.x, 0.f};
  return split_layers<H>(sw, sb, xrow, 0, n_layers, x);
}

}  // namespace cnr
