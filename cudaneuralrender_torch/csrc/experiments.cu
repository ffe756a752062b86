// The step-cost experiment kernels X1-X3, with their C entries (bound with
// ctypes by kernels/build.py, wrapped by cudaneuralrender_torch/benchmarks/).
//
//   cnr_x1_loop      X1, benchmarks/exp_blockdiag.py::_loop_kernel (launched
//                    by chain): reps times x <- relu(W^T x + b) with one
//                    [H, H] weight, at H = 32 and 128
//   cnr_x2_stepcost  X2, benchmarks/exp_stepcost.py::make_kernel (launched by
//                    run_variant): a fixed-step march with no early exit,
//                    the chain alone (chain_only), with the state update
//                    (march_state) or with the coarse kernel's relax /
//                    budget / converged bookkeeping (march_relax), on the
//                    FP32 or the three-pass chain
//   cnr_x3_ablation  X3, benchmarks/exp_stepcost2.py::make_kernel (launched
//                    by run_variant): the ablation from a bare loop of
//                    products to the march chain (v0, v1, v2, v3) and the
//                    five- / six-pass bfloat16 emulations of FP32 (v5p, v5)
//
// Each takes a march step apart: every lane runs every step, so the time
// over lanes x steps is the cost of one lane-step of that piece. The JAX
// scripts run each at the MXU's DEFAULT (one bfloat16 pass) and HIGHEST
// precisions; this card runs both at FP32 grade, so one kernel serves both
// names.
//
// X2 runs the per-thread FFMA chains of chain.cuh (FP32, three-pass), one
// lane per thread, 128 threads a block: each output summed from zero in
// input order with the bias last, the point o + d*t built with one fused
// multiply-add and the first layer contracted over the 3 true inputs, as
// the plain versions (cuBLAS on the card) sum, so it equals them bit for
// bit. It is built at H = 32, the width of the nets the JAX scripts run.
//
// X1 and X3 run their chains on the tensor cores, for the 32 lanes of a
// warp together (lane = row, two m16 tiles), with the building blocks of
// K1 and K2h (chain.cuh, mma.cuh), so that they time the chain that ships
// beside the bfloat16 scheme that might replace it:
//   * X1 (x1_loop_kernel): K1's FP32-grade layer. At H = 32 the
//     activations stay in registers and each rep is K1's layer_tf32_regs
//     (tf32 MMA, the residual of each chunk's truncation recovered) with a
//     fifth product, the weight's third tf32 part (product_tf32: 6 MMAs a
//     weight), the weight staged once a block in tf32 fragment order; at
//     H = 128 each warp's 16-row m-tiles take turns through two
//     activation buffers in shared memory and each rep is 3xTF32
//     (mma_3xtf32_rows, the chunk sums rounded to even), the 64 KB weight
//     staged in shared memory beside the buffers;
//   * X3 v0-v3 (x3_ablation_kernel): K1's tf32 chain at width 32 over the
//     tf32 fragment-ordered stack (fused_mlp.packed_mma(params, "tf32"),
//     staged as K1 stages it): v3 (= v4) is t += sdf(t) * 1e-8 on
//     chain_tf32_regs, v1 and v2 its hidden layers (layer_tf32_regs) over
//     all H inputs without the point rebuild, v0 the same product repeated
//     with the first layer's weight, with a fifth product, the
//     activation's third tf32 part (product_tf32);
//   * X3 v5 / v5p: the six- and five-pass bfloat16 emulation of FP32 on
//     m16n8k16 bf16 MMA (chain_split3_regs below), K2h's design with a
//     third weight part: the stack's hi, mid and lo parts (split3) staged
//     once a block in shared memory in bf16 fragment order, 55 KB at 9
//     layers; the activations split into their three parts once a layer,
//     in registers, each layer's accumulators handed to the next layer's A
//     fragments in place (mma.cuh).
// The tensor cores sum in their own order, so X1 and X3 no longer equal
// their plain versions bit for bit: the benchmarks' models
// (exp_blockdiag.chain_model, exp_stepcost2.ablation_model) sum in the
// kernels' order, and chip_smoke.py holds the kernels to the plain versions
// within X_RTOL and to float64 at the witness bars.
//
// What bounds X1 and X3 v0-v3: the FP32-grade products at the tf32 rate
// (3 tf32 products a weight at 495 TFLOP/s; the kernels run 5 at H = 32,
// X1 at 32 and v0 6); v5 / v5p: 6 / 5 bf16 products a weight at 989
// TFLOP/s (v5 runs 7). The splits of every operand, the chunk sums'
// corrections and the shuffles of the point sit beside the MMAs on the
// CUDA cores.
//
// A warp's MMAs need all 32 lanes: a partial last warp's spare lanes march
// the last lane's ray (X3) or zero rows (X1) and write nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace cnr {
namespace {

constexpr int kBlock = 128;

// A zero the optimiser cannot see through, made anew at each call. Added to
// the weight's address inside a loop that multiplies by the same weight
// every iteration (X1, X3's v0), it keeps the loads in the loop, from shared
// memory, as the march kernel's chain reads each layer's weight: otherwise
// the compiler may hoist a lane's fragments of the weight, and their
// splits, out of the loop.
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}

// The first lane of this thread's warp, in a grid of 32-lane warps.
__device__ __forceinline__ int warp_first_lane() {
  return blockIdx.x * blockDim.x + (threadIdx.x & ~31);
}

// The products of a weight used again and again: X1's one weight, X3 v0's
// first-layer weight. K1's tf32 product (layer_tf32_regs: each operand
// split into two tf32 parts, big + small, which drop up to 2^-23 of it;
// four products a weight and the residual of the chunk's truncation) leaves
// them short of FP32 grade in two ways, each read against float64 on the CPU
// (the benchmarks' models) and on the card:
//   * the weight's dropped bits are the same at every rep, a fixed
//     perturbation of W: under a gain above one they add up, and X1 at 32
//     (the card tests' 18 reps) lay 1.72x as far from float64 as the plain
//     version on the mean, past chip_smoke.py's 1.25x witness bar. X1 at 32
//     therefore stages W split exactly into three tf32 parts (big, small,
//     third; exp_blockdiag.pack_tf32_parts) and adds a_big * b_third: 0.89x;
//   * v0 sums 3 products an output (the point's coordinates), whose FP32
//     rounding lies below what the activation's split drops: on K1's product
//     its outputs lay 1.69x from float64. v0 therefore splits each activation
//     into three parts and adds a_third * b_big: 1.07x (1.10x on the card).
// K1 does neither: its weights change every layer and it takes the first
// layer on FFMA (first_layer_ffma). 6 MMAs a weight, where K1 runs 5.
// mma_tf32_exact: acc[m][j] += a_m * b_j, both m-tiles m and G n-tiles j,
// one k-chunk of 8: u = -(a_big b_big) from zero, d = a_big b_big + u (what
// u's truncation dropped), then the small products into d, the smallest
// first (a_third b_big or a_big b_third, a_small b_small, a_small b_big,
// a_big b_small), and acc += d - u with round-to-nearest adds (mma.cuh's
// mma_tf32_tiles with one more product). b: one lane's B pairs {b0, b1},
// big, small and third parts as tf32 bits.
template <bool kThirdA, int G>
__device__ __forceinline__ void mma_tf32_exact(float (&acc)[2][G][4], const uint32_t (&abig)[2][4],
                                               const uint32_t (&nbig)[2][4],
                                               const uint32_t (&asmall)[2][4],
                                               const uint32_t (&athird)[2][4],
                                               const uint32_t (&bbig)[G][2],
                                               const uint32_t (&bsmall)[G][2],
                                               const uint32_t (&bthird)[G][2]) {
  float u[2][G][4], d[2][G][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) u[m][j][e] = 0.f;
      mma_tf32(u[m][j], nbig[m], bbig[j][0], bbig[j][1]);
    }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[m][j][e] = u[m][j][e];
      mma_tf32(d[m][j], abig[m], bbig[j][0], bbig[j][1]);
    }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if constexpr (kThirdA)
        mma_tf32(d[m][j], athird[m], bbig[j][0], bbig[j][1]);
      else
        mma_tf32(d[m][j], abig[m], bthird[j][0], bthird[j][1]);
      mma_tf32(d[m][j], asmall[m], bsmall[j][0], bsmall[j][1]);
    }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      mma_tf32(d[m][j], asmall[m], bbig[j][0], bbig[j][1]);
      mma_tf32(d[m][j], abig[m], bsmall[j][0], bsmall[j][1]);
    }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[m][j][e] = __fadd_rn(acc[m][j][e], __fsub_rn(d[m][j][e], u[m][j][e]));
}

// The products product_tf32 takes: K1's, v0's (a third part of each
// activation) or X1's at 32 (a third part of each weight, staged split).
enum ProductKind : int { kK1Product = 0, kThirdA = 1, kThirdB = 2 };

// x (k-chunk kk's A-fragment slots of both m-tiles, chain_tf32_regs'
// layout: slot [mt][kk][half + 2c] of lane 4g + t is row 16 mt + 8 half + g,
// column 8 kk + 2t + c) <- x * W over all H inputs, on the products of
// kKind; then + bl (when given) and ReLU (when relu). n-tile j's
// accumulators are k-chunk j's slots (mma.cuh). wl: this lane's first B
// pair of the weight in tf32 fragment order (kThirdB: of its big part, the
// small and third parts H * H / 2 pairs apart).
template <int H, int kKind>
__device__ __forceinline__ void product_tf32(float (&x)[2][H / 8][4], const float2* wl,
                                             const float* bl, bool relu) {
  constexpr int KT = H / 8, NT = H / 8, G = reg_group(NT), P = tf32_passes(H);
  const int t = threadIdx.x & 3;
  float acc[NT / G][2][G][4];
#pragma unroll
  for (int q = 0; q < NT / G; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][jj][e] = 0.f;
  if constexpr (kKind == kK1Product) {
    layer_tf32_regs<P, KT, NT, NT>(x, wl, acc);
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t abig[2][4], nbig[2][4], asmall[2][4], athird[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = x[mt][kk][e];
          split_tf32(v, abig[mt][e], asmall[mt][e]);
          nbig[mt][e] = abig[mt][e] ^ 0x80000000u;
          athird[mt][e] = kKind == kThirdA
                              ? tf32_rna(__fsub_rn(__fsub_rn(v, __uint_as_float(abig[mt][e])),
                                                   __uint_as_float(asmall[mt][e])))
                              : 0u;
        }
#pragma unroll
      for (int q = 0; q < NT / G; ++q) {
        uint32_t bbig[G][2], bsmall[G][2], bthird[G][2];
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const int at = (kk * NT + q * G + jj) * 32;
          const float2 b0 = wl[at];
          if constexpr (kKind == kThirdA) {
            split_tf32(b0.x, bbig[jj][0], bsmall[jj][0]);
            split_tf32(b0.y, bbig[jj][1], bsmall[jj][1]);
            bthird[jj][0] = bthird[jj][1] = 0u;
          } else {
            const float2 b1 = wl[at + H * H / 2], b2 = wl[at + H * H];
            bbig[jj][0] = __float_as_uint(b0.x), bbig[jj][1] = __float_as_uint(b0.y);
            bsmall[jj][0] = __float_as_uint(b1.x), bsmall[jj][1] = __float_as_uint(b1.y);
            bthird[jj][0] = __float_as_uint(b2.x), bthird[jj][1] = __float_as_uint(b2.y);
          }
        }
        mma_tf32_exact<kKind == kThirdA, G>(acc[q], abig, nbig, asmall, athird, bbig, bsmall,
                                            bthird);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bias = bl ? *reinterpret_cast<const float2*>(bl + 8 * j + 2 * t)
                           : make_float2(0.f, 0.f);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float(&c)[4] = acc[j / G][mt][j % G];
      // n-tile j's (c0, c1, c2, c3) are k-chunk j's slots (0, 2, 1, 3)
      const float v[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = v[e];
        if (bl) y = __fadd_rn(y, e < 2 ? bias.x : bias.y);
        x[mt][j][e] = relu ? fmaxf(y, 0.f) : y;
      }
    }
  }
}

// --------------------------------------------------------------------------
// X1. x [H, lanes], b [H] -> out [H, lanes]; w [H, H] in tf32 fragment order
// ([H/8, H/8, 32] float2 pairs, fused_mlp.pack_mma(w[None], "tf32")), at
// H = 32 split into its three tf32 parts, [3, H/8, H/8, 32]
// (exp_blockdiag.pack_tf32_parts).

// Warps a block at H = 128. The block holds the weight (64 KB, tf32
// fragment order), the bias and each warp's two activation buffers [16,
// act_words(128)] (17 KB): 201 KB with 8 warps, so one block an SM, and 8
// warps an SM; 9 would still fit the 227 KB, 2 blocks of 3 would not.
// ptxas gives the kernel 104 registers a thread (chip_smoke.py phase 2,
// sm_90a), room for 19 warps an SM, so shared memory, not registers, sets
// the 8. A warp waits on its own chain of dependent MMAs and splits (each
// rep reads the last one's output), so more warps, not less shared memory
// traffic, would raise the rate (20% of its 3xTF32 bound on the H100).
constexpr int kX1Warps128 = 8;

__host__ __device__ constexpr int x1_threads(int h) { return h == 32 ? kBlock : 32 * kX1Warps128; }

// Dynamic shared memory of an X1 block: none at H = 32 (static), else the
// weight, the bias and the warps' buffers.
__host__ __device__ constexpr size_t x1_smem_bytes(int h) {
  return h == 32 ? 0
                 : sizeof(float) * (static_cast<size_t>(h) * h + h +
                                    static_cast<size_t>(kX1Warps128) * 2 * 16 * act_words(h));
}

// One rep at H >= 128 for one m-tile: out = ReLU(in * W + b) on 3xTF32
// (mma_3xtf32_rows), over the H/8 k-chunks of `in`, in chunks of
// kMmaChunkTiles n-tiles; chain.cuh's layer_tf32_smem with the weight in
// shared memory. w: the weight in tf32 fragment order at this lane's first B
// pair; in, out: 16 rows of act_words(H) floats.
template <int H>
__device__ __forceinline__ void x1_layer_smem(const float* __restrict__ in,
                                              const float2* __restrict__ w,
                                              const float* __restrict__ b,
                                              float* __restrict__ out) {
  constexpr int NT = H / 8, KT = H / 8, CT = kMmaChunkTiles, S = act_words(H);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int c = 0; c < NT; c += CT) {
    float acc[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t abig[4], asmall[4];
      load_a_tf32<H>(in, kk, abig, asmall);
      float2 bv[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) bv[j] = w[(kk * NT + c + j) * 32];
      mma_3xtf32_rows(acc, abig, asmall, bv);
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int col = 8 * (c + j) + 2 * t;
      const float b0 = b[col], b1 = b[col + 1];
      *reinterpret_cast<float2*>(out + g * S + col) =
          make_float2(fmaxf(__fadd_rn(acc[j][0], b0), 0.f), fmaxf(__fadd_rn(acc[j][1], b1), 0.f));
      *reinterpret_cast<float2*>(out + (g + 8) * S + col) =
          make_float2(fmaxf(__fadd_rn(acc[j][2], b0), 0.f), fmaxf(__fadd_rn(acc[j][3], b1), 0.f));
    }
  }
}

template <int H>
__global__ void __launch_bounds__(x1_threads(H))
x1_loop_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, int lanes, int reps, float* __restrict__ out) {
  constexpr int KT = H / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (H == 32) {
    __shared__ float4 sw4[3 * H * H / 4];  // the big, small and third parts
    __shared__ __align__(16) float sb[H];
    for (int k = threadIdx.x; k < 3 * H * H / 4; k += blockDim.x)
      sw4[k] = reinterpret_cast<const float4*>(w)[k];
    for (int k = threadIdx.x; k < H; k += blockDim.x) sb[k] = b[k];
    __syncthreads();
    const int row0 = warp_first_lane();
    if (row0 >= lanes) return;
    float v[2][KT][4];  // rows past `lanes` are zero
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * mt + 8 * half + g;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            v[mt][kk][half + 2 * c] =
                row < lanes ? x[static_cast<int64_t>(8 * kk + 2 * t + c) * lanes + row] : 0.f;
      }
    const float2* sw = reinterpret_cast<const float2*>(sw4) + lane;
#pragma unroll 1
    for (int rep = 0; rep < reps; ++rep) product_tf32<H, kThirdB>(v, sw + opaque_zero(), sb, true);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * mt + 8 * half + g;
        if (row < lanes)
#pragma unroll
          for (int kk = 0; kk < KT; ++kk)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              out[static_cast<int64_t>(8 * kk + 2 * t + c) * lanes + row] = v[mt][kk][half + 2 * c];
      }
  } else {
    constexpr int S = act_words(H);
    extern __shared__ float4 smem4[];
    float2* sw = reinterpret_cast<float2*>(smem4);
    float* sb = reinterpret_cast<float*>(sw + H * H / 2);
    for (int k = threadIdx.x; k < H * H / 4; k += blockDim.x)
      smem4[k] = reinterpret_cast<const float4*>(w)[k];
    for (int k = threadIdx.x; k < H; k += blockDim.x) sb[k] = b[k];
    __syncthreads();
    const int row0 = warp_first_lane();
    if (row0 >= lanes) return;
    float* buf = sb + H + (threadIdx.x / 32) * 2 * 16 * S;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {  // the m-tiles take turns through the buffers
      const int r0 = row0 + 16 * mt;
      // 16 rows of a column are 64 contiguous bytes of x: lanes 16k..16k+15
      // read one column's
      for (int e = lane; e < 16 * H; e += 32) {
        const int row = e & 15, col = e >> 4;
        buf[row * S + col] =
            r0 + row < lanes ? x[static_cast<int64_t>(col) * lanes + r0 + row] : 0.f;
      }
      __syncwarp();
      int cur = 0;
#pragma unroll 1
      for (int rep = 0; rep < reps; ++rep) {
        x1_layer_smem<H>(buf + cur * 16 * S, sw + opaque_zero() + lane, sb,
                         buf + (cur ^ 1) * 16 * S);
        __syncwarp();
        cur ^= 1;
      }
      for (int e = lane; e < 16 * H; e += 32) {
        const int row = e & 15, col = e >> 4;
        if (r0 + row < lanes)
          out[static_cast<int64_t>(col) * lanes + r0 + row] = buf[cur * 16 * S + row * S + col];
      }
      __syncwarp();  // the next m-tile overwrites the buffers
    }
  }
}

template <int H>
int launch_x1(const float* x, const float* w, const float* b, int lanes, int reps, float* out,
              cudaStream_t stream) {
  const size_t smem = x1_smem_bytes(H);
  const cudaError_t err = allow_smem(x1_loop_kernel<H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = x1_threads(H);
  const int grid = (lanes + threads - 1) / threads;
  x1_loop_kernel<H><<<grid, threads, smem, stream>>>(x, w, b, lanes, reps, out);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// X2 and X3 read one lane's ray: dirs [3, n], t0 [1, n], origin [3, 1].
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ dirs,
                                        const float* __restrict__ origin, int n, int r) {
  return Ray{origin[0], origin[1], origin[2], dirs[r], dirs[n + r],
             dirs[2 * static_cast<int64_t>(n) + r]};
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The chains X2 marches on.
enum ChainKind : int { kFp32 = 0, kThreePassChain = 1 };

// Bytes of shared memory each of X2's chain kinds stages at width H: the
// FP32 stack, or its bfloat16 hi and lo halves in as many bytes, and the
// biases.
inline size_t x_smem_bytes(int kind, int h, int n_layers) {
  const size_t w = static_cast<size_t>(n_layers) * h * h, bias = sizeof(float) * n_layers * h;
  return (kind == kFp32 ? sizeof(float) : 2 * sizeof(uint16_t)) * w + bias;
}

// The stack of one of X2's chain kinds, staged in shared memory by every
// thread of the block: FP32 [L, H, H] (w0) or the bfloat16 hi and lo halves
// (w0, w1); the biases last.
template <int H, int kKind>
__device__ __forceinline__ void stage_x(const void* __restrict__ w0, const void* __restrict__ w1,
                                        const float* __restrict__ biases, int n_layers,
                                        const float*& w, const float*& b) {
  if constexpr (kKind == kFp32) {
    stage_weights<H>(static_cast<const float*>(w0), biases, n_layers, w, b);
  } else {
    stage_weights_3pass<H>(static_cast<const uint16_t*>(w0), static_cast<const uint16_t*>(w1),
                           biases, n_layers);
  }
}

// The SDF of one lane at t: the point o + d*t (one fused multiply-add), its
// coordinates rounded to bfloat16 when bf16_input is set (X2's act_dtype),
// through the chain of kind kKind.
template <int H, int kKind>
__device__ __forceinline__ float x_sdf(const Ray& ray, float t, bool bf16_input,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b, int n_layers) {
  float px = __fmaf_rn(ray.dx, t, ray.ox);
  float py = __fmaf_rn(ray.dy, t, ray.oy);
  float pz = __fmaf_rn(ray.dz, t, ray.oz);
  if (bf16_input) {
    px = round_bf16(px);
    py = round_bf16(py);
    pz = round_bf16(pz);
  }
  if constexpr (kKind == kFp32)
    return chain_sdf<H>(w, b, n_layers, 3, px, py, pz, 0.f);
  else
    return chain_sdf_3pass<H>(n_layers, 3, px, py, pz, 0.f);
}

// --------------------------------------------------------------------------
// X2: steps fixed steps of every lane, t_out [1, n].
enum StepCostVariant : int { kChainOnly = 0, kMarchState = 1, kMarchRelax = 2 };

template <int H, int kKind, int V>
__global__ void __launch_bounds__(kBlock)
x2_stepcost_kernel(const float* __restrict__ dirs, const float* __restrict__ t0,
                   const float* __restrict__ origin, const void* __restrict__ w0,
                   const void* __restrict__ w1, const float* __restrict__ biases,
                   int n_layers, int n, int steps, int bf16_input, float* __restrict__ t_out) {
  const float* w = nullptr;
  const float* b = nullptr;
  stage_x<H, kKind>(w0, w1, biases, n_layers, w, b);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(dirs, origin, n, r);
  const bool bf16 = bf16_input != 0;
  float t = t0[r];
  if constexpr (V == kMarchRelax) {
    // The coarse kernel's bookkeeping (march.cuh) with no early exit: eps
    // 1e-6, omega 1.6, budget 3. The JAX kernel also carries each lane's
    // resolve step, which it never reads.
    float budget = 3.f, prev_r = 0.f, step_len = 0.f;
    bool active = true, conv = false;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const float d = x_sdf<H, kKind>(ray, t, bf16, w, b, n_layers);
      const bool act = active;
      const bool sor_fail = act && step_len > prev_r && __fadd_rn(d, prev_r) < step_len;
      const bool near = act && !sor_fail && d < 1e-6f;
      const float om = step_len < 0.f ? 1.f : 1.6f;
      const float stepv =
          sor_fail ? __fsub_rn(prev_r, step_len) : (near ? d : __fmul_rn(om, d));
      if (act) budget = __fsub_rn(budget, stepv);
      const bool miss = act && !sor_fail && budget <= 0.f;
      const bool moved = act && !miss;
      if (moved) t = __fadd_rn(t, stepv);
      const bool conv_now = moved && near;
      active = moved && !conv_now;
      conv = conv || conv_now;
      if (moved && !sor_fail) prev_r = d;
      if (moved) step_len = stepv;
    }
    t_out[r] = conv ? __fadd_rn(t, 1e-9f) : t;  // t + conv * 1e-9
  } else {
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const float d = x_sdf<H, kKind>(ray, t, bf16, w, b, n_layers);
      if constexpr (V == kChainOnly) {
        t = __fadd_rn(t, d);
      } else {  // kMarchState: act = d > -1e30; move unless near
        const bool act = d > -1e30f;
        if (act && !(d < 1e-6f)) t = __fadd_rn(t, d);
      }
    }
    t_out[r] = t;
  }
}

// --------------------------------------------------------------------------
// X3's v5 / v5p chain: the six- and five-pass bfloat16 emulation of FP32 on
// m16n8k16 bf16 MMA, for the 32 rays of a warp (K2h's chain_3pass_regs with
// a third part).
//
// Each value v, weight or activation, is split into three bfloat16 parts
// (exp_stepcost2.split3): hi = bf16(v), mid = bf16(v - hi), lo =
// bf16((v - hi) - mid), to nearest even, both differences exact. A layer
// keeps the products of parts (activation part x weight part) down to the
// 2^-16 tier: x_hi w_hi; x_mid w_hi, x_hi w_mid; x_lo w_hi, x_hi w_lo and,
// six-pass only, x_mid w_mid. Each product of two bfloat16 values is exact
// in FP32; the tensor cores then sum each k-chunk's 16 products and the C
// operand aligned to the largest and truncated. Per k-chunk the MMAs start
// from zero with the smallest products first and the chunk's sum goes to
// the FP32 accumulator with a round-to-nearest add (mma.cuh's discipline).
// The six-pass chain, whose error is otherwise FP32's, also recovers what
// the truncation of the chunk sum dropped, as mma.cuh's mma_tf32_tiles
// does: u = -(x_hi w_hi) truncated, from zero; d = x_hi w_hi + u; the five
// smaller products into d; acc += d - u. Without it the six-pass chain's
// SDF lay 3.7x as far from float64 as its plain version's on the mean
// (csg_demo, 4096 points, exp_stepcost2.mlp_chain_split3_mma on the CPU),
// past chip_smoke.py's 1.25x witness bar; with it 0.68x. The five-pass
// chain's error is its dropped x_mid w_mid term's (2^-16 relative, 34x
// FP32's), and its truncation moves that by under 2%, so it runs its 5
// products alone. MMAs a weight: 7 (v5), 5 (v5p).

// The three-term split of two neighbouring values (the lower column
// first), each part packed as an A-fragment register.
__device__ __forceinline__ void split3_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(h)), r1 = __fsub_rn(x1, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, __low2float(m)), __fsub_rn(r1, __high2float(m)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d[m][j] += part PA of m-tile m's A fragment times part PB of n-tile j's B
// fragment, for both m-tiles and G n-tiles.
template <int PA, int PB, int G>
__device__ __forceinline__ void split3_pass(float (&d)[2][G][4], const uint32_t (&a)[3][2][4],
                                            const uint2 (&b)[3][G]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_bf16(d[m][j], a[PA][m], b[PB][j].x, b[PB][j].y);
}

// acc[m][j] += x_m * w_j over one k-chunk of 16, both m-tiles m and G
// n-tiles j, at the five- or six-pass precision (above). a[p][m]: part p (0
// hi, 1 mid, 2 lo) of m-tile m's A fragment; b[p][j]: part p's B fragment
// {b0, b1} of n-tile j. 2G independent MMAs a pass.
template <bool kSix, int G>
__device__ __forceinline__ void mma_split3(float (&acc)[2][G][4], const uint32_t (&a)[3][2][4],
                                           const uint2 (&b)[3][G]) {
  float d[2][G][4], u[2][G][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[m][j][e] = 0.f;
  if constexpr (kSix) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t nhi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) nhi[e] = a[0][m][e] ^ 0x80008000u;
#pragma unroll
      for (int j = 0; j < G; ++j) mma_bf16(u[m][j], nhi, b[0][j].x, b[0][j].y);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[m][j][e] = u[m][j][e];
        mma_bf16(d[m][j], a[0][m], b[0][j].x, b[0][j].y);  // x_hi w_hi's residual
      }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[m][j][e] = 0.f;
  }
  // (activation part, weight part), the smallest first
  split3_pass<2, 0>(d, a, b);
  split3_pass<0, 2>(d, a, b);
  if constexpr (kSix) split3_pass<1, 1>(d, a, b);
  split3_pass<1, 0>(d, a, b);
  split3_pass<0, 1>(d, a, b);
  if constexpr (!kSix) split3_pass<0, 0>(d, a, b);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[m][j][e] = __fadd_rn(acc[m][j][e], kSix ? __fsub_rn(d[m][j][e], u[m][j][e])
                                                    : d[m][j][e]);
}

// The A fragments (hi, mid, lo) of m-tile mt for the first contraction:
// row r holds ray 16 mt + r's point (x, y, z) in columns 0-2, zero beyond
// (chain.cuh inputs_a's layout). a: k-chunk 0's parts [3][2][4].
__device__ __forceinline__ void inputs_split3(int mt, float px, float py, float pz,
                                              uint32_t (&a)[3][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int src = 16 * mt + 8 * half + g;
    const float x = __shfl_sync(0xffffffffu, px, src);
    const float y = __shfl_sync(0xffffffffu, py, src);
    const float z = __shfl_sync(0xffffffffu, pz, src);
    const float c0 = t == 0 ? x : (t == 1 ? z : 0.f);  // columns 2t, 2t + 1
    const float c1 = t == 0 ? y : 0.f;
    split3_bf16x2(c0, c1, a[0][mt][half], a[1][mt][half], a[2][mt][half]);
#pragma unroll
    for (int p = 0; p < 3; ++p) a[p][mt][2 + half] = 0u;  // columns 8-15
  }
}

// Dynamic shared memory of an X3 block: the tf32 fragment-ordered stack
// (v0-v3, as many bytes as the FP32 stack) or the three bf16 parts (v5,
// v5p), and the biases.
inline size_t x3_smem_bytes(bool split, int h, int n_layers) {
  const size_t w = static_cast<size_t>(n_layers) * h * h, bias = sizeof(float) * n_layers * h;
  return (split ? 3 * sizeof(uint16_t) : sizeof(float)) * w + bias;
}

// Stages the three bf16 parts of the stack, each in bf16 fragment order
// [L, H/16, H/8, 32] of 8-byte B fragments (exp_stepcost2.pack_split3), one
// after the other in shared memory, then the biases; every thread of the
// block helps. Returns the biases; w points at the hi part, the mid and lo
// parts n_layers * H * H / 4 fragments after it. Call before any thread of
// the block leaves.
template <int H>
__device__ __forceinline__ const float* stage_split3(const void* __restrict__ w_hi,
                                                     const void* __restrict__ w_mid,
                                                     const void* __restrict__ w_lo,
                                                     const float* __restrict__ biases,
                                                     int n_layers, const uint2*& w) {
  extern __shared__ float4 smem4[];
  uint4* s4 = reinterpret_cast<uint4*>(smem4);
  const int n_w8 = n_layers * H * H / 8;  // eight bfloat16 values per uint4
  const void* parts[3] = {w_hi, w_mid, w_lo};
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (int k = threadIdx.x; k < n_w8; k += blockDim.x)
      s4[p * n_w8 + k] = reinterpret_cast<const uint4*>(parts[p])[k];
  float* sb = reinterpret_cast<float*>(s4 + 3 * n_w8);
  for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) sb[k] = biases[k];
  __syncthreads();
  w = reinterpret_cast<const uint2*>(s4);
  return sb;
}

// The five- (kSix false) or six-pass chain's raw head value for each ray of
// the warp at its point, called by all 32 lanes together; w, b: where
// stage_split3 put the stack. The first contraction is one k-chunk padded
// to 16; the head is n-tile 0 of the last layer (head_to_ray).
template <int H, bool kSix>
__device__ __forceinline__ float chain_split3_regs(const uint2* __restrict__ w,
                                                   const float* __restrict__ b, int n_layers,
                                                   float px, float py, float pz) {
  constexpr int NT = H / 8, KT = H / 16, G = reg_group(NT);
  static_assert(NT % G == 0, "a layer's n-tiles split into groups of kRegTiles");
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int plane = n_layers * KT * NT * 32;  // B fragments of one part
  uint32_t a[KT][3][2][4];  // k-chunk kk's A fragments: part, m-tile, register
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kk][p][mt][e] = 0u;
  inputs_split3(0, px, py, pz, a[0]);
  inputs_split3(1, px, py, pz, a[0]);
  int kin = 1;  // k-chunks of the layer's input: the inputs are one
#pragma unroll 1
  for (int l = 0; l < n_layers - 1; ++l) {
    const uint2* wl = w + l * KT * NT * 32 + lane;
    float acc[NT / G][2][G][4];
#pragma unroll
    for (int q = 0; q < NT / G; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][mt][jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk < kin) {
#pragma unroll
        for (int q = 0; q < NT / G; ++q) {
          uint2 bv[3][G];
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int jj = 0; jj < G; ++jj) bv[p][jj] = wl[p * plane + (kk * NT + q * G + jj) * 32];
          mma_split3<kSix, G>(acc[q], a[kk], bv);
        }
      }
    }
    const float* bl = b + l * H;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = bl[8 * j + 2 * t], b1 = bl[8 * j + 2 * t + 1];
      uint32_t(&dst)[3][2][4] = a[j / 2];
      const int r = 2 * (j % 2);  // n-tile j's rows g, g + 8: registers r, r + 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float(&c)[4] = acc[j / G][mt][j % G];
        split3_bf16x2(fmaxf(__fadd_rn(c[0], b0), 0.f), fmaxf(__fadd_rn(c[1], b1), 0.f),
                      dst[0][mt][r], dst[1][mt][r], dst[2][mt][r]);
        split3_bf16x2(fmaxf(__fadd_rn(c[2], b0), 0.f), fmaxf(__fadd_rn(c[3], b1), 0.f),
                      dst[0][mt][r + 1], dst[1][mt][r + 1], dst[2][mt][r + 1]);
      }
    }
    kin = KT;
  }
  const uint2* wl = w + (n_layers - 1) * KT * NT * 32 + lane;
  float h[2][1][4] = {{{0.f, 0.f, 0.f, 0.f}}, {{0.f, 0.f, 0.f, 0.f}}};
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk < kin) {
      const uint2 bv[3][1] = {{wl[kk * NT * 32]}, {wl[plane + kk * NT * 32]},
                              {wl[2 * plane + kk * NT * 32]}};
      mma_split3<kSix, 1>(h, a[kk], bv);
    }
  }
  return __fadd_rn(head_to_ray(h), b[(n_layers - 1) * H]);
}

// --------------------------------------------------------------------------
// X3. v0-v2 carry the padded input x [H] through products (no point is
// rebuilt); v3, v5 and v5p carry t and add sdf(t) * kScale each step. The
// JAX script's 1e-8 keeps x bounded and t nearly still.
enum AblationVariant : int { kV0 = 0, kV1 = 1, kV2 = 2, kV3 = 3, kV5 = 5, kV5p = 6 };
constexpr float kScale = 1e-8f;

// The point (px, py, pz) of each ray of the warp as row 16 mt + 8 half + g of
// the padded input, in chain_tf32_regs' A-fragment slots (product_tf32):
// columns 0-2, zero beyond.
template <int H>
__device__ __forceinline__ void point_slots(float px, float py, float pz,
                                            float (&x)[2][H / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int kk = 0; kk < H / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mt][kk][e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int src = 16 * mt + 8 * half + g;
      const float vx = __shfl_sync(0xffffffffu, px, src);
      const float vy = __shfl_sync(0xffffffffu, py, src);
      const float vz = __shfl_sync(0xffffffffu, pz, src);
      x[mt][0][half] = t == 0 ? vx : (t == 1 ? vz : 0.f);  // column 2t
      x[mt][0][half + 2] = t == 0 ? vy : 0.f;              // column 2t + 1
    }
  }
}

template <int H, int V>
__global__ void __launch_bounds__(kBlock)
x3_ablation_kernel(const float* __restrict__ dirs, const float* __restrict__ t0,
                   const float* __restrict__ origin, const void* __restrict__ w0,
                   const void* __restrict__ w1, const void* __restrict__ w2,
                   const float* __restrict__ biases, int n_layers, int n, int steps,
                   float* __restrict__ out) {
  static_assert(H == 32, "X3 is built at width 32");
  constexpr bool kSplit = V == kV5 || V == kV5p;
  const float* b = nullptr;
  const float* wf = nullptr;
  const uint2* ws = nullptr;
  if constexpr (kSplit)
    b = stage_split3<H>(w0, w1, w2, biases, n_layers, ws);
  else
    stage_weights<H>(static_cast<const float*>(w0), biases, n_layers, wf, b);
  const int lane = threadIdx.x & 31;
  const int r0 = warp_first_lane();
  if (r0 >= n) return;  // whole warps only: the chains are warp-collective
  const int r = min(r0 + lane, n - 1);  // a partial warp's spare lanes march the last ray
  const Ray ray = load_ray(dirs, origin, n, r);
  const float2* w = reinterpret_cast<const float2*>(wf);  // tf32 fragment order (v0-v3)
  float result;
  if constexpr (V == kV0 || V == kV1 || V == kV2) {
    float x[2][H / 8][4];
    point_slots<H>(__fmaf_rn(ray.dx, t0[r], ray.ox), __fmaf_rn(ray.dy, t0[r], ray.oy),
                   __fmaf_rn(ray.dz, t0[r], ray.oz), x);
    if constexpr (V == kV0) {  // steps * n_layers products by the first layer's weight
#pragma unroll 1
      for (int k = 0; k < steps * n_layers; ++k)
        product_tf32<H, kThirdA>(x, w + lane + opaque_zero(), nullptr, false);
    } else {  // each step the n_layers weights (v2: with bias and ReLU), then x * kScale
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
#pragma unroll 1
        for (int l = 0; l < n_layers; ++l)
          product_tf32<H, kK1Product>(x, w + l * H * H / 2 + lane, V == kV2 ? b + l * H : nullptr,
                          V == kV2 && l + 1 < n_layers);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int kk = 0; kk < H / 8; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) x[mt][kk][e] = __fmul_rn(x[mt][kk][e], kScale);
      }
    }
    // column 0 of each row: slots 0 (row g) and 1 (row g + 8) of k-chunk 0
    // in the lanes with t = 0, as n-tile 0's c0 and c2
    const float h[2][1][4] = {{{x[0][0][0], 0.f, x[0][0][1], 0.f}},
                              {{x[1][0][0], 0.f, x[1][0][1], 0.f}}};
    result = head_to_ray(h);
  } else {
    float t = t0[r];
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const float px = __fmaf_rn(ray.dx, t, ray.ox);
      const float py = __fmaf_rn(ray.dy, t, ray.oy);
      const float pz = __fmaf_rn(ray.dz, t, ray.oz);
      float d;
      if constexpr (kSplit)
        d = chain_split3_regs<H, V == kV5>(ws, b, n_layers, px, py, pz);
      else
        d = chain_tf32_regs<H>(w, b, n_layers, px, py, pz, 0.f);
      t = __fadd_rn(t, __fmul_rn(d, kScale));
    }
    result = t;
  }
  if (r0 + lane < n) out[r0 + lane] = result;
}

template <int H, int kKind, int V>
int launch_x2(const float* dirs, const float* t0, const float* origin, const void* w0,
              const void* w1, const float* biases, int n_layers, int n, int steps,
              int bf16_input, float* t_out, cudaStream_t stream) {
  const size_t smem = x_smem_bytes(kKind, H, n_layers);
  const cudaError_t err = allow_smem(x2_stepcost_kernel<H, kKind, V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  x2_stepcost_kernel<H, kKind, V><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(
      dirs, t0, origin, w0, w1, biases, n_layers, n, steps, bf16_input, t_out);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int V>
int launch_x3(const float* dirs, const float* t0, const float* origin, const void* w0,
              const void* w1, const void* w2, const float* biases, int n_layers, int n,
              int steps, float* out, cudaStream_t stream) {
  const size_t smem = x3_smem_bytes(V == kV5 || V == kV5p, H, n_layers);
  const cudaError_t err = allow_smem(x3_ablation_kernel<H, V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  x3_ablation_kernel<H, V><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(
      dirs, t0, origin, w0, w1, w2, biases, n_layers, n, steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cnr

// X1: hidden 32 or 128; x, out [hidden, lanes], w [hidden, hidden] in tf32
// fragment order (fused_mlp.pack_mma(w[None], "tf32")), at 32 its three
// tf32 parts (exp_blockdiag.pack_tf32_parts), b [hidden].
extern "C" int cnr_x1_loop(int device, const float* x, const float* w, const float* b,
                           int hidden, int lanes, int reps, float* out, void* stream) {
  if ((hidden != 32 && hidden != 128) || lanes < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hidden == 32 ? cnr::launch_x1<32>(x, w, b, lanes, reps, out, s)
                      : cnr::launch_x1<128>(x, w, b, lanes, reps, out, s);
}

// X2: variant 0 chain_only, 1 march_state, 2 march_relax; three_pass 0 (the
// FP32 stack in weights) or 1 (its bfloat16 hi and lo halves in weights and
// weights_lo); hidden 32.
extern "C" int cnr_x2_stepcost(int device, const float* dirs, const float* t0,
                               const float* origin, const void* weights,
                               const void* weights_lo, const float* biases, int n_layers,
                               int hidden, int variant, int three_pass, int bf16_input, int n,
                               int steps, float* t_out, void* stream) {
  using namespace cnr;
  if (hidden != 32 || n_layers < 2 || n < 0 || steps < 0 || (three_pass && !weights_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = int (*)(const float*, const float*, const float*, const void*, const void*,
                         const float*, int, int, int, int, float*, cudaStream_t);
  Launch launch = nullptr;
  switch (variant * 2 + (three_pass ? 1 : 0)) {
    case 0: launch = launch_x2<32, kFp32, kChainOnly>; break;
    case 1: launch = launch_x2<32, kThreePassChain, kChainOnly>; break;
    case 2: launch = launch_x2<32, kFp32, kMarchState>; break;
    case 3: launch = launch_x2<32, kThreePassChain, kMarchState>; break;
    case 4: launch = launch_x2<32, kFp32, kMarchRelax>; break;
    case 5: launch = launch_x2<32, kThreePassChain, kMarchRelax>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return launch(dirs, t0, origin, weights, weights_lo, biases, n_layers, n, steps, bf16_input,
                t_out, static_cast<cudaStream_t>(stream));
}

// X3: variant 0 v0, 1 v1, 2 v2, 3 v3, 5 v5, 6 v5p; weights the stack
// [n_layers, 32, 32] in tf32 fragment order (v0-v3,
// fused_mlp.pack_mma(weights, "tf32")), or w_hi, w_mid, w_lo its three
// bfloat16 parts in bf16 fragment order (v5, v5p,
// exp_stepcost2.pack_split3); hidden 32.
extern "C" int cnr_x3_ablation(int device, const float* dirs, const float* t0,
                               const float* origin, const float* weights, const void* w_hi,
                               const void* w_mid, const void* w_lo, const float* biases,
                               int n_layers, int hidden, int variant, int n, int steps,
                               float* out, void* stream) {
  using namespace cnr;
  const bool split = variant == kV5 || variant == kV5p;
  if (hidden != 32 || n_layers < 2 || n < 0 || steps < 0 ||
      (split ? !(w_hi && w_mid && w_lo) : !weights))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  switch (variant) {
    case kV0: return launch_x3<32, kV0>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV1: return launch_x3<32, kV1>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV2: return launch_x3<32, kV2>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV3: return launch_x3<32, kV3>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV5: return launch_x3<32, kV5>(dirs, t0, origin, w_hi, w_mid, w_lo, biases, n_layers,
                                        n, steps, out, s);
    case kV5p: return launch_x3<32, kV5p>(dirs, t0, origin, w_hi, w_mid, w_lo, biases,
                                          n_layers, n, steps, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
