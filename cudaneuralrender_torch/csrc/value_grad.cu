// The SDF net's value and its exact input gradient at each point, in one
// kernel: a render's autodiff shading normals (kernels/fused_mlp.py
// neural_sdf_fn_grad_kernel, render/renderer.py shade_fn), with its C entry
// cnr_mlp_value_grad (bound by kernels/build.py, wrapped by
// kernels/fused_mlp.py mlp_value_grad).
//
// It replaces no TPU kernel: the JAX package takes the normals' gradient
// with jax.grad through its plain chain (cudaneuralrender_tpu/ops/shading.py
// autodiff_normals), which XLA fuses. The port took it with
// torch.autograd.grad through the plain chain: cuBLAS FP32 GEMMs forward and
// back and the ReLU-tie backward (csrc/elementwise.cu), every layer's
// activations written to device memory and read back, about 33 launches a
// frame. Here a warp runs its 32 points through
//   * the forward chain at FP32 grade on the tensor cores, built from K1's
//     FP32 chain (chain.cuh): at widths 32 and 64 as chain_tf32_regs runs
//     it (the first layer on FFMA in the plain order, first_layer_ffma; the
//     activations in registers, each layer's accumulators the next one's A
//     fragments), with 3xTF32 products (mma.cuh mma_3xtf32_rows); at 128
//     as chain_tf32_smem runs it (3xTF32, activations in the warp's shared
//     memory); keeping each hidden pre-activation's ReLU factor in
//     {0, 1/2, 1} as two bits (positive, exactly zero) in shared memory:
//     1/2 at a tie, the JAX package's jnp.maximum gradient (models/mlp.py
//     relu_tie);
//   * the backward chain through the same MMA products: the head's gradient
//     is column 0 of the last layer's weights, then g <- (g * factor_l) W_l^T
//     layer by layer down to the 3 spatial inputs. W_l^T is the transposed
//     stack in the same tf32 fragment order (fused_mlp.packed_mma_t), so
//     each backward product's accumulators are the next one's A fragments
//     in place, as the forward's are (mma.cuh);
// and writes only the value [n] and the gradient [n, 3]. A 4-input net's
// 4th input is the frame, read from device memory, with no gradient.
//
// What bounds it: arithmetic, twice the chain's (3H + 7H^2 + H fused
// multiply-adds forward, about as many back), at the tf32 rate with three
// products a weight (495 TFLOP/s / 3): at H = 32 about 29 kFLOP a point.
// The forward's pre-activations differ from the plain chain's by rounding,
// so where one lies within that rounding of 0 (a hidden unit at its kink,
// about 2 points in 10^5) the kernel may take the other side's factor, a
// subgradient as valid as the plain chain's. The bytes
// are 28 a point. Its design: a persistent grid (as many blocks as fit the
// card, each warp striding over groups of 32 points) so that a block stages
// the stacks in shared memory once; at 32 both stacks (37 KB each at 9
// layers), at 64 none (both read from L2, 150 KB each); at 128 both read
// from L2 (590 KB each), each warp's activations in two [16, H + 8]
// buffers, its two m-tiles in turn. The masks take H / 16
// words a lane and layer at 32 and 64, in each warp's own shared memory
// (lane-major: conflict-free, and each lane reads back only what it wrote).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace cnr {
namespace {

// Warps of a block, at every width; whether the two stacks (the forward one
// with its biases, the transposed one) are staged in shared memory, else
// read from L2: at 32 (83 KB a block with the masks, 2 blocks an SM), not at
// 64 (150 KB each; the registers leave 2 blocks an SM) or 128. On the H100
// at a 1080p frame's shade region these ran fastest of 5-6 layouts each
// (PERF.md): at 32, 8 warps a block or the transposed stack in L2 ran
// 3-18% slower; at 64, the forward stack staged (8 warps, one block) 8%.
constexpr int kVgWarps = 4;
__host__ __device__ constexpr bool stage_stacks(int h) { return h == 32; }

// Mask words a lane keeps for one layer: at 32 and 64 its H values of the
// layer (both m-tiles) as H / 32 words of positive bits and as many of tie
// bits; at 128 (one m-tile at a time) a positive and a tie word for each
// chunk of kMmaChunkTiles n-tiles.
__host__ __device__ constexpr int mask_words(int h) {
  return h <= 64 ? h / 16 : 2 * (h / 8 / kMmaChunkTiles);
}

// Dynamic shared memory of a block: the staged stacks and biases (32) or
// each warp's two activation buffers (128), then each warp's masks.
__host__ __device__ constexpr size_t vg_smem_bytes(int h, int n_layers) {
  const size_t masks = sizeof(uint32_t) * kVgWarps * (n_layers - 1) * mask_words(h) * 32;
  if (h > 64) return sizeof(float) * kVgWarps * 2 * 16 * act_words(h) + masks;
  const size_t stacks = static_cast<size_t>(n_layers) * h * (2 * h + 1);
  return (stage_stacks(h) ? sizeof(float) * stacks : 0) + masks;
}

// The gradient factor of a value whose bits sit at `bit` of pos and tie:
// 1 above zero, 1/2 at exactly zero, 0 below (and for NaN).
__device__ __forceinline__ float tie_factor(uint32_t pos, uint32_t tie, int bit) {
  return (pos >> bit) & 1u ? 1.f : ((tie >> bit) & 1u ? 0.5f : 0.f);
}

// Each ray's column C (0-7) of an n-tile's accumulators, back to its lane
// (head_to_ray is C = 0): column C sits in the lanes with t = C / 2,
// register C % 2 for row g and 2 + C % 2 for row g + 8.
template <int C>
__device__ __forceinline__ float column_to_ray(const float (&h)[2][1][4]) {
  const int lane = threadIdx.x & 31, src = 4 * (lane & 7) + C / 2;
  const float v00 = __shfl_sync(0xffffffffu, h[0][0][C % 2], src);
  const float v02 = __shfl_sync(0xffffffffu, h[0][0][2 + C % 2], src);
  const float v10 = __shfl_sync(0xffffffffu, h[1][0][C % 2], src);
  const float v12 = __shfl_sync(0xffffffffu, h[1][0][2 + C % 2], src);
  const bool upper = lane & 8;
  return lane & 16 ? (upper ? v12 : v10) : (upper ? v02 : v00);
}

// ---------------------------------------------------------------------------
// H = 32, 64: both m-tiles at once, values in registers in A-fragment slots
// (k-chunk j's (a0, a1, a2, a3) of m-tile mt in x[mt][j]: column
// 8j + 2t + e / 2, row g + 8 (e % 2)), bit (mt * H/8 + j) * 4 + e of a
// layer's masks.

// The layer's pre-activations x to their ReLU in place, their factors'
// bits to m (this lane's words of the layer, lane-major).
template <int H>
__device__ __forceinline__ void relu_record(float (&x)[2][H / 8][4], uint32_t* __restrict__ m) {
  constexpr int NT = H / 8, W = H / 32;
  const int lane = threadIdx.x & 31;
  uint32_t pos[W], tie[W];
#pragma unroll
  for (int w = 0; w < W; ++w) pos[w] = tie[w] = 0u;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = (mt * NT + j) * 4 + e;
        const float v = x[mt][j][e];
        pos[bit / 32] |= static_cast<uint32_t>(v > 0.f) << (bit % 32);
        tie[bit / 32] |= static_cast<uint32_t>(v == 0.f) << (bit % 32);
        x[mt][j][e] = fmaxf(v, 0.f);
      }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    m[w * 32 + lane] = pos[w];
    m[(W + w) * 32 + lane] = tie[w];
  }
}

// x *= the factors relu_record kept in m.
template <int H>
__device__ __forceinline__ void apply_factors(float (&x)[2][H / 8][4],
                                              const uint32_t* __restrict__ m) {
  constexpr int NT = H / 8, W = H / 32;
  const int lane = threadIdx.x & 31;
  uint32_t pos[W], tie[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pos[w] = m[w * 32 + lane];
    tie[w] = m[(W + w) * 32 + lane];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = (mt * NT + j) * 4 + e;
        x[mt][j][e] *= tie_factor(pos[bit / 32], tie[bit / 32], bit % 32);
      }
}

// n-tile j's accumulators (c0, c1, c2, c3) to k-chunk j's A-fragment slots
// (a0, a2, a1, a3), plus the bias of columns 8j + 2t, 8j + 2t + 1 where
// kBias.
template <int H, bool kBias>
__device__ __forceinline__ void acc_to_slots(
    const float (&acc)[H / 8 / reg_group(H / 8)][2][reg_group(H / 8)][4],
    const float* __restrict__ bl, float (&x)[2][H / 8][4]) {
  constexpr int NT = H / 8, G = reg_group(NT);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float2 bias = make_float2(0.f, 0.f);
    if constexpr (kBias) bias = *reinterpret_cast<const float2*>(bl + 8 * j + 2 * t);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float(&c)[4] = acc[j / G][mt][j % G];
      if constexpr (kBias) {
        x[mt][j][0] = __fadd_rn(c[0], bias.x);
        x[mt][j][2] = __fadd_rn(c[1], bias.y);
        x[mt][j][1] = __fadd_rn(c[2], bias.x);
        x[mt][j][3] = __fadd_rn(c[3], bias.y);
      } else {
        x[mt][j][0] = c[0];
        x[mt][j][2] = c[1];
        x[mt][j][1] = c[2];
        x[mt][j][3] = c[3];
      }
    }
  }
}

// acc += x (both m-tiles' A-fragment slots) times the first N n-tiles of
// the layer, 3xTF32 a tile (mma.cuh mma_3xtf32_rows: 3 MMAs a weight, each
// k-chunk's sum rounded to even and added), acc in layer_tf32_regs'
// layout; wl: the layer's stack in tf32 fragment order at this lane's first
// B pair. K1's product at 32 and 64 (layer_tf32_regs: the truncation's
// residual and, at 32, the small terms, 5 / 4 MMAs a weight) ran 23% / 3%
// slower here and parted from the plain chain's ReLU signs at fewer points
// (15 against 22 of a 1080p frame's 966656 at 32; PERF.md).
template <int H, int N>
__device__ __forceinline__ void layer_3xtf32_regs(
    const float (&x)[2][H / 8][4], const float2* wl,
    float (&acc)[N / reg_group(N)][2][reg_group(N)][4]) {
  constexpr int KT = H / 8, NT = H / 8, G = reg_group(N);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t abig[2][4], asmall[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[mt][kk][e], abig[mt][e], asmall[mt][e]);
#pragma unroll
    for (int q = 0; q < N / G; ++q) {
      float2 bv[G];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) bv[jj] = wl[(kk * NT + q * G + jj) * 32];
      mma_3xtf32_rows(acc[q][0], abig[0], asmall[0], bv);
      mma_3xtf32_rows(acc[q][1], abig[1], asmall[1], bv);
    }
  }
}

template <int H>
__device__ __forceinline__ void zero_acc(
    float (&acc)[H / 8 / reg_group(H / 8)][2][reg_group(H / 8)][4]) {
  constexpr int NT = H / 8, G = reg_group(NT);
#pragma unroll
  for (int q = 0; q < NT / G; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][jj][e] = 0.f;
}

// The forward chain (n_layers >= 2) as chain_tf32_regs computes it, each
// hidden layer's factors to masks (mask_words(H) * 32 words a layer).
// Returns each ray's raw head value.
template <int H>
__device__ __forceinline__ float value_regs(const float2* __restrict__ w,
                                            const float* __restrict__ b, int n_layers, float px,
                                            float py, float pz, float pf,
                                            uint32_t* __restrict__ masks) {
  constexpr int NT = H / 8, KT = H / 8, G = reg_group(NT);
  constexpr int MW = mask_words(H) * 32;
  const int lane = threadIdx.x & 31;
  float x[2][KT][4];
  first_layer_ffma<H, false>(w, b, px, py, pz, pf, x);
  relu_record<H>(x, masks);
#pragma unroll 1
  for (int l = 1; l < n_layers - 1; ++l) {
    float acc[NT / G][2][G][4];
    zero_acc<H>(acc);
    layer_3xtf32_regs<H, NT>(x, w + l * KT * NT * 32 + lane, acc);
    acc_to_slots<H, true>(acc, b + l * H, x);
    relu_record<H>(x, masks + l * MW);
  }
  float h[1][2][1][4] = {{{{0.f, 0.f, 0.f, 0.f}}, {{0.f, 0.f, 0.f, 0.f}}}};
  layer_3xtf32_regs<H, 1>(x, w + (n_layers - 1) * KT * NT * 32 + lane, h);
  return __fadd_rn(head_to_ray(h[0]), b[(n_layers - 1) * H]);
}

// The backward chain (n_layers >= 2) from value_regs' masks: w the forward
// stack (its last layer's column 0 is the head's gradient), wt the
// transposed one. Each ray's gradient to (gx, gy, gz).
template <int H>
__device__ __forceinline__ void gradient_regs(const float2* __restrict__ w,
                                              const float2* __restrict__ wt, int n_layers,
                                              const uint32_t* __restrict__ masks, float& gx,
                                              float& gy, float& gz) {
  constexpr int NT = H / 8, KT = H / 8, G = reg_group(NT);
  constexpr int MW = mask_words(H) * 32;
  const int lane = threadIdx.x & 31, t = lane & 3;
  float x[2][KT][4];
  // lane t of n-tile 0 holds rows 8j + 2t, 8j + 2t + 1 of column 0
  const float2* wh = w + (n_layers - 1) * KT * NT * 32 + t;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float2 c = wh[j * NT * 32];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      x[mt][j][0] = x[mt][j][1] = c.x;
      x[mt][j][2] = x[mt][j][3] = c.y;
    }
  }
  apply_factors<H>(x, masks + (n_layers - 2) * MW);
#pragma unroll 1
  for (int l = n_layers - 2; l >= 1; --l) {
    float acc[NT / G][2][G][4];
    zero_acc<H>(acc);
    layer_3xtf32_regs<H, NT>(x, wt + l * KT * NT * 32 + lane, acc);
    acc_to_slots<H, false>(acc, nullptr, x);
    apply_factors<H>(x, masks + (l - 1) * MW);
  }
  // layer 0 transposed: n-tile 0's columns are the inputs
  float d[1][2][1][4] = {{{{0.f, 0.f, 0.f, 0.f}}, {{0.f, 0.f, 0.f, 0.f}}}};
  layer_3xtf32_regs<H, 1>(x, wt + lane, d);
  gx = column_to_ray<0>(d[0]);
  gy = column_to_ray<1>(d[0]);
  gz = column_to_ray<2>(d[0]);
}

// ---------------------------------------------------------------------------
// H = 128: one m-tile at a time through the warp's two buffers [16,
// act_words(H)], values in the accumulator layout (acc[j][e]: row
// g + 8 (e / 2), column 8(c + j) + 2t + e % 2 of chunk c), bit 4j + e of
// chunk c's mask words.

// One layer of one m-tile as layer_tf32_smem computes it, with the kernel's
// epilogues: forward, out = ReLU(acc + b_l) and the factors' bits to m;
// backward, out = acc * the factors in m (no bias). m: the layer's words,
// a positive and a tie word a chunk, lane-major.
template <int H, bool kBackward>
__device__ __forceinline__ void layer_vg_smem(const float* __restrict__ in, int kin,
                                              const uint32_t (&pbig)[4],
                                              const uint32_t (&psmall)[4],
                                              const float2* __restrict__ wl,
                                              const float* __restrict__ bl,
                                              uint32_t* __restrict__ m,
                                              float* __restrict__ out) {
  constexpr int NT = H / 8, CT = kMmaChunkTiles, S = act_words(H);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int c = 0; c < NT; c += CT) {
    float acc[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float2 bnext[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) bnext[j] = __ldg(wl + (c + j) * 32 + lane);
#pragma unroll 1
    for (int kk = 0; kk < kin; ++kk) {
      uint32_t abig[4], asmall[4];
      if (in == nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) abig[e] = pbig[e], asmall[e] = psmall[e];
      } else {
        load_a_tf32<H>(in, kk, abig, asmall);
      }
      float2 bnow[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        bnow[j] = bnext[j];
        if (kk + 1 < kin) bnext[j] = __ldg(wl + ((kk + 1) * NT + c + j) * 32 + lane);
      }
      mma_3xtf32_rows(acc, abig, asmall, bnow);
    }
    uint32_t* mc = m + (c / CT) * 64 + lane;
    uint32_t pos = 0u, tie = 0u;
    if constexpr (kBackward) {
      pos = mc[0];
      tie = mc[32];
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int col = 8 * (c + j) + 2 * t;
      float r[4];
      if constexpr (kBackward) {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = acc[j][e] * tie_factor(pos, tie, 4 * j + e);
      } else {
        const float b0 = __ldg(bl + col), b1 = __ldg(bl + col + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fadd_rn(acc[j][e], e % 2 ? b1 : b0);
          pos |= static_cast<uint32_t>(v > 0.f) << (4 * j + e);
          tie |= static_cast<uint32_t>(v == 0.f) << (4 * j + e);
          r[e] = fmaxf(v, 0.f);
        }
      }
      *reinterpret_cast<float2*>(out + g * S + col) = make_float2(r[0], r[1]);
      *reinterpret_cast<float2*>(out + (g + 8) * S + col) = make_float2(r[2], r[3]);
    }
    if constexpr (!kBackward) {
      mc[0] = pos;
      mc[32] = tie;
    }
  }
}

// The value and gradient (n_layers >= 2) at H >= 128: for each m-tile the
// forward chain as chain_tf32_smem runs it, then the backward chain through
// the same buffers; w, wt: the forward and transposed stacks in L2.
template <int H>
__device__ __forceinline__ void value_grad_smem(const float2* __restrict__ w,
                                                const float2* __restrict__ wt,
                                                const float* __restrict__ b, int n_layers,
                                                float px, float py, float pz, float pf,
                                                float* __restrict__ buf,
                                                uint32_t* __restrict__ masks, float& value,
                                                float& gx, float& gy, float& gz) {
  constexpr int NT = H / 8, KT = H / 8, CT = kMmaChunkTiles, S = act_words(H);
  constexpr int MW = mask_words(H) * 32;
  constexpr size_t kLayer = static_cast<size_t>(KT) * NT * 32;  // float2 pairs
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2* wh = w + (n_layers - 1) * kLayer;  // the head, n-tile 0
  float h[2][1][4], d[2][1][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t pbig[4], psmall[4];
    inputs_a_tf32(mt, px, py, pz, pf, pbig, psmall);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[mt][0][e] = d[mt][0][e] = 0.f;
    layer_vg_smem<H, false>(nullptr, 1, pbig, psmall, w, b, masks, buf);
    __syncwarp();
#pragma unroll 1
    for (int l = 1; l < n_layers - 1; ++l) {
      layer_vg_smem<H, false>(buf + ((l - 1) & 1) * 16 * S, KT, pbig, psmall, w + l * kLayer,
                              b + l * H, masks + l * MW, buf + (l & 1) * 16 * S);
      __syncwarp();
    }
    const float* in = buf + ((n_layers - 2) & 1) * 16 * S;
    float2 wnext = __ldg(wh + lane);
#pragma unroll 1
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t abig[4], asmall[4];
      load_a_tf32<H>(in, kk, abig, asmall);
      const float2 wv[1] = {wnext};
      if (kk + 1 < KT) wnext = __ldg(wh + (kk + 1) * NT * 32 + lane);
      mma_3xtf32_rows(h[mt], abig, asmall, wv);
    }
    // the head's gradient (column 0 of the last layer: lane t of n-tile 0
    // holds rows 8j + 2t, 8j + 2t + 1) times the last hidden layer's
    // factors, into the other buffer
    int cur = (n_layers - 1) & 1;
    float* a = buf + cur * 16 * S;
    const uint32_t* ml = masks + (n_layers - 2) * MW;
#pragma unroll 1
    for (int c = 0; c < NT; c += CT) {
      const uint32_t pos = ml[(c / CT) * 64 + lane], tie = ml[(c / CT) * 64 + 32 + lane];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float2 w0 = __ldg(wh + (c + j) * NT * 32 + t);
        const int col = 8 * (c + j) + 2 * t;
        *reinterpret_cast<float2*>(a + g * S + col) =
            make_float2(w0.x * tie_factor(pos, tie, 4 * j), w0.y * tie_factor(pos, tie, 4 * j + 1));
        *reinterpret_cast<float2*>(a + (g + 8) * S + col) = make_float2(
            w0.x * tie_factor(pos, tie, 4 * j + 2), w0.y * tie_factor(pos, tie, 4 * j + 3));
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int l = n_layers - 2; l >= 1; --l) {
      layer_vg_smem<H, true>(buf + cur * 16 * S, KT, pbig, psmall, wt + l * kLayer, nullptr,
                             masks + (l - 1) * MW, buf + (cur ^ 1) * 16 * S);
      __syncwarp();
      cur ^= 1;
    }
    // layer 0 transposed: n-tile 0's columns are the inputs
    in = buf + cur * 16 * S;
    float2 vnext = __ldg(wt + lane);
#pragma unroll 1
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t abig[4], asmall[4];
      load_a_tf32<H>(in, kk, abig, asmall);
      const float2 wv[1] = {vnext};
      if (kk + 1 < KT) vnext = __ldg(wt + (kk + 1) * NT * 32 + lane);
      mma_3xtf32_rows(d[mt], abig, asmall, wv);
    }
    __syncwarp();  // the next m-tile overwrites the buffers
  }
  value = __fadd_rn(head_to_ray(h), __ldg(b + (n_layers - 1) * H));
  gx = column_to_ray<0>(d);
  gy = column_to_ray<1>(d);
  gz = column_to_ray<2>(d);
}

// ---------------------------------------------------------------------------

// pts [n, 3]; frame [1] (read where n_inputs is 4); wf, wt: the padded
// stack and its transpose in tf32 fragment order; biases [n_layers, H];
// value [n], grad [n, 3].
template <int H>
__global__ void __launch_bounds__(32 * kVgWarps)
    mlp_value_grad_kernel(const float* __restrict__ pts, const float* __restrict__ frame,
                          const float2* __restrict__ wf, const float2* __restrict__ wb,
                          const float* __restrict__ biases, int n_layers, int n_inputs, int n,
                          float* __restrict__ value, float* __restrict__ grad) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float2* w = wf;
  const float2* wt = wb;
  const float* b = biases;
  float* buf = nullptr;
  uint32_t* masks;
  if constexpr (H <= 64) {
    float* next = s;
    if constexpr (stage_stacks(H)) {
      const int stack4 = n_layers * H * H / 4;
      float4* s4 = smem4;
      for (int k = threadIdx.x; k < stack4; k += blockDim.x) {
        s4[k] = reinterpret_cast<const float4*>(wf)[k];
        s4[stack4 + k] = reinterpret_cast<const float4*>(wb)[k];
      }
      w = reinterpret_cast<const float2*>(s4);
      wt = reinterpret_cast<const float2*>(s4 + stack4);
      next = reinterpret_cast<float*>(s4 + 2 * stack4);
      for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) next[k] = biases[k];
      b = next;
      next += n_layers * H;
    }
    masks = reinterpret_cast<uint32_t*>(next) + warp * (n_layers - 1) * mask_words(H) * 32;
    __syncthreads();
  } else {
    buf = s + warp * 2 * 16 * act_words(H);
    masks = reinterpret_cast<uint32_t*>(s + kVgWarps * 2 * 16 * act_words(H)) +
            warp * (n_layers - 1) * mask_words(H) * 32;
  }
  const float pf = n_inputs == 4 ? __ldg(frame) : 0.f;
  for (int base = (blockIdx.x * kVgWarps + warp) * 32; base < n; base += gridDim.x * kVgWarps * 32) {
    const int i = base + lane;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (i < n) {
      px = pts[3 * i];
      py = pts[3 * i + 1];
      pz = pts[3 * i + 2];
    }
    float v, gx, gy, gz;
    if (n_layers == 1) {  // the head is the first layer: rows 0-3 of its column 0
      const float2 w01 = w[0], w23 = w[1];
      float y = fmaf(px, w01.x, 0.f);
      y = fmaf(py, w01.y, y);
      y = fmaf(pz, w23.x, y);
      y = fmaf(pf, w23.y, y);
      v = __fadd_rn(y, b[0]);
      gx = w01.x, gy = w01.y, gz = w23.x;
    } else if constexpr (H <= 64) {
      v = value_regs<H>(w, b, n_layers, px, py, pz, pf, masks);
      gradient_regs<H>(w, wt, n_layers, masks, gx, gy, gz);
    } else {
      value_grad_smem<H>(w, wt, b, n_layers, px, py, pz, pf, buf, masks, v, gx, gy, gz);
    }
    if (i < n) {
      value[i] = v;
      grad[3 * i] = gx;
      grad[3 * i + 1] = gy;
      grad[3 * i + 2] = gz;
    }
  }
}

struct ValueGradArgs {
  const float* pts;
  const float* frame;
  const float2* wf;
  const float2* wb;
  const float* biases;
  int n_layers;
  int n_inputs;
  int n;
  float* value;
  float* grad;
};

// A persistent grid: as many blocks as the card holds at once, at most one
// a 32 * kVgWarps points.
template <int H>
int launch_value_grad(const ValueGradArgs& a, cudaStream_t stream) {
  if (a.n_layers < 1 || (a.n_inputs != 3 && a.n_inputs != 4) ||
      (a.n_inputs == 4 && a.frame == nullptr) || a.n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const size_t smem = vg_smem_bytes(H, a.n_layers);
  const int threads = 32 * kVgWarps;
  cudaError_t err = allow_smem(mlp_value_grad_kernel<H>, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_value_grad_kernel<H>,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (static_cast<long long>(a.n) + threads - 1) / threads;
  const long long most = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(want < most ? want : most);
  mlp_value_grad_kernel<H><<<grid, threads, smem, stream>>>(
      a.pts, a.frame, a.wf, a.wb, a.biases, a.n_layers, a.n_inputs, a.n, a.value, a.grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cnr

// The value-and-gradient kernel at hidden width 32, 64 or 128 (others give
// cudaErrorInvalidValue): pts [n, 3], frame [1] (n_inputs 4) or NULL,
// wf / wt: fused_mlp.packed_mma(params, "tf32") and packed_mma_t(params),
// biases [n_layers, hidden]; value [n], grad [n, 3]. Returns a cudaError_t.
extern "C" int cnr_mlp_value_grad(int device, const float* pts, const float* frame,
                                  const void* wf, const void* wt, const float* biases,
                                  int n_layers, int hidden, int n_inputs, int n, float* value,
                                  float* grad, void* stream) {
  const cnr::ValueGradArgs a{pts,      frame,    static_cast<const float2*>(wf),
                             static_cast<const float2*>(wt), biases, n_layers, n_inputs, n,
                             value,    grad};
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 32: return cnr::launch_value_grad<32>(a, s);
    case 64: return cnr::launch_value_grad<64>(a, s);
    case 128: return cnr::launch_value_grad<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a launch of the kernel asks for, or -1 for a
// width it has no instantiation for.
extern "C" long long cnr_value_grad_smem_bytes(int hidden, int n_layers) {
  if (hidden != 32 && hidden != 64 && hidden != 128) return -1;
  return static_cast<long long>(cnr::vg_smem_bytes(hidden, n_layers));
}
