// The layer chain at every hidden width, its three-pass variant, and the
// fused forward kernel (K3).
//
// The chain replaces the JAX package's pallas/fused_mlp.py::_mlp_chain, which
// the Pallas kernels inline on zero-padded [H, T] activations; the forward
// kernel replaces pallas/fused_mlp.py::_fused_mlp_kernel (launched by
// mlp_forward_pallas, used by neural_sdf_fn_pallas for config.use_pallas).
// The three-pass chain (K2h) replaces pallas/fused_mlp.py::_mlp_chain_3pass,
// the emulated Precision.HIGH chain on the bfloat16 halves of the weights
// (split_hi_lo), which the march kernel runs at precision "high".
//
// What bounds the chain on this card: arithmetic. A 9-layer net costs
// 3H + 7H^2 + H fused multiply-adds per point (the true 3-input first layer,
// the 1-column head): 7.3k at H=32, 28.9k at 64, 115k at 128, 460k at 256,
// 1.84M at 512, 7.34M at 1024.
//
// Design, by width and arithmetic:
//   * the FP32 chain inside the march kernel (K1): 3xTF32 on the tensor
//     cores over the 32 rays of a warp at every width (see "K1's FP32 chain
//     on the tensor cores" below):
//     - H = 32, 64: the activations in registers, each layer's accumulators
//       handed to the next layer as its A fragments; the stack in tf32
//       fragment order staged in shared memory once per block (37 KB at
//       L=9, H=32; 150 KB at 64) (chain_tf32_regs). For the refine
//       ladder's later rungs the march kernel runs the chain of one point
//       split over a warp's lanes on FFMA instead (split_sdf below, a ray
//       per warp), each output summed in input order from zero, the bias
//       last: the plain version's order bit for bit;
//     - H = 128: a block's group of rays at once, the warps splitting each
//       layer's columns over the group's activations in the block's shared
//       memory, the stack (590 KB at L=9) read from L2
//       (csrc/hidden128_group.cuh);
//     - H = 256 to 1024: the activations in the warp's shared memory, the
//       stack (2.36 MB / 9.4 MB / 37.7 MB at L=9) read from the 50 MB L2
//       (chain_tf32_smem).
//     The step-cost experiment X2 (csrc/experiments.cu) times this chain,
//     chain_tf32_regs at 32, with a fixed-step march around it.
//   * the fused forward K3: 3xTF32 on the tensor cores over a tile of points
//     per block, activations in shared memory (see "K3" below).
//   * the three-pass chain K2h inside the march kernel: bf16 MMA over the 32
//     rays of a warp, activations in registers (32, 64) or in the warp's
//     shared memory (256-1024), or over a block's group of rays at 128
//     (csrc/hidden128_group.cuh) (see "K2h on the tensor cores" below); X2
//     times chain_3pass_regs at 32 the same way.
// 1024 is the widest: the JAX package's kernels hold the whole stack in
// VMEM, and a wider 9-layer stack exceeds this card's L2 too. The first
// layer contracts only the true 3 or 4 inputs (the frame is the 4th), and
// the head computes only column 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"
#include "mma.cuh"

namespace cnr {

// Allow a launch above 48 KB of dynamic shared memory (a size too large for
// the card fails here, with the error the launch would have given).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Stages a stack of L * H * H floats (H = 32, 64: the FP32 stack in tf32
// fragment order, chain_tf32_regs' layout) and its biases in shared
// memory, every thread of the block helping copy them in; w and b point
// there after. Call before any thread leaves the kernel.
template <int H>
__device__ __forceinline__ void stage_weights(const float* __restrict__ weights,
                                              const float* __restrict__ biases,
                                              int n_layers, const float*& w,
                                              const float*& b) {
  static_assert(H <= 64, "the FP32 stack is staged at widths 32 and 64 only");
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sb = sw + n_layers * H * H;
  const int n_w4 = n_layers * H * H / 4;
  for (int k = threadIdx.x; k < n_w4; k += blockDim.x)
    smem4[k] = reinterpret_cast<const float4*>(weights)[k];
  for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) sb[k] = biases[k];
  __syncthreads();
  w = sw;
  b = sb;
}

// ---------------------------------------------------------------------------
// The FP32 chain of ONE point split over the 32 lanes of a warp (H = 32, 64;
// the ray-split march kernel, march.cuh march_split_kernel).
//
// Every lane passes the same point; lane j computes outputs j and, at 64,
// j + 32 of each layer; every lane returns the same head value. Each output
// sums its products with fmaf in input order from zero, then adds the bias
// with __fadd_rn and applies fmaxf, as the plain version's cuBLAS chain
// sums, so the value equals it bit for bit. The head is one sum over the
// layer's inputs in input order, computed alike in every lane: a tree or
// __reduce_add_sync would reorder it. Every branch depends on n_layers and
// n_inputs only, so the whole warp runs every warp-wide operation.
//
// What bounds it: a weight serves one point, where a ray per thread's chain
// serves the 32 points of a warp, so a hidden layer moves H^2 * 4 bytes of
// shared memory per point (32 cycles of the SM's 128 bytes a cycle at
// H = 32, 128 at 64) and its H inputs to every lane as
// many again; a step's latency is the chain of one output, H + 1 dependent
// operations a layer. Hence the layout: the stack is staged transposed, a
// row per output padded to split_stride(H) floats, so a lane reads four
// consecutive inputs' weights as one 16-byte load and the eight lanes of a
// quarter-warp fall in distinct banks; and a layer's inputs pass through
// the warp's row of shared memory, each lane writing its outputs and
// reading all H as 16-byte broadcasts, all before the layer's first
// product, so the loads' latency overlaps instead of sitting on the chain.
// Shuffles of the inputs (H a layer, one a product), and the row-major
// stack read a weight at a time, ran slower on the H100, at the terminal
// rung and on the larger rungs alike (PERF.md).

// Floats per row of the transposed stack: H weights and 4 of padding.
__host__ __device__ constexpr int split_stride(int h) { return h + 4; }

// Rays (warps) of a block of the ray-split march kernel.
constexpr int kSplitRays = 16;

// Dynamic shared memory of a ray-split march block: the transposed stack,
// the biases, and each warp's row of layer inputs.
__host__ __device__ constexpr size_t split_smem_bytes(int h, int n_layers) {
  return sizeof(float) * (static_cast<size_t>(n_layers) * h * split_stride(h) +
                          static_cast<size_t>(n_layers) * h + kSplitRays * h);
}

// Stages the stack transposed (row o of layer l = W[l][:, o]) and the
// biases into shared memory, every thread of the block helping; returns
// where the biases start. Call before any thread of the block leaves.
template <int H>
__device__ __forceinline__ const float* stage_weights_split(const float* __restrict__ weights,
                                                            const float* __restrict__ biases,
                                                            int n_layers) {
  static_assert(H == 32 || H == 64, "the ray-split chain runs at widths 32 and 64");
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  constexpr int S = split_stride(H);
  for (int k = threadIdx.x; k < n_layers * H * H; k += blockDim.x) {
    const int row = k / H;  // l * H + i
    const int l = row / H, i = row % H, o = k % H;
    sw[(l * H + o) * S + i] = weights[k];
  }
  float* sb = sw + n_layers * H * S;
  for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) sb[k] = biases[k];
  __syncthreads();
  return sb;
}

// xs[i] = input i of the layer in every lane, from the outputs x the lanes
// hold (lane j: j + 32k in x[k]), through the warp's row xrow of shared
// memory: each lane writes its outputs, then reads all H as 16-byte
// broadcasts.
template <int H>
__device__ __forceinline__ void gather_inputs(const float (&x)[H / 32], float* xrow,
                                              float (&xs)[H]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane has read the row's last inputs
#pragma unroll
  for (int k = 0; k < H / 32; ++k) xrow[lane + 32 * k] = x[k];
  __syncwarp();
  const float4* x4 = reinterpret_cast<const float4*>(xrow);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 v = x4[q];
    xs[4 * q] = v.x;
    xs[4 * q + 1] = v.y;
    xs[4 * q + 2] = v.z;
    xs[4 * q + 3] = v.w;
  }
}

// Sum_i xs[i] * row[i] with fmaf in input order from zero, the row read as
// 16-byte loads.
template <int H>
__device__ __forceinline__ float dot_in_order(const float (&xs)[H], const float* row) {
  const float4* w4 = reinterpret_cast<const float4*>(row);
  float y = 0.f;
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = w4[q];
    y = fmaf(xs[4 * q], w.x, y);
    y = fmaf(xs[4 * q + 1], w.y, y);
    y = fmaf(xs[4 * q + 2], w.z, y);
    y = fmaf(xs[4 * q + 3], w.w, y);
  }
  return y;
}

// The layers from l0 on, from layer l0's inputs x (lane j: j + 32k in x[k]):
// the hidden layers, then the head value, in every lane.
template <int H>
__device__ __forceinline__ float split_layers(const float* sw, const float* sb, float* xrow,
                                              int l0, int n_layers, float (&x)[H / 32]) {
  constexpr int K = H / 32;
  constexpr int S = split_stride(H);
  const int lane = threadIdx.x & 31;
  float xs[H];  // the layer's inputs, all of them in every lane
  for (int l = l0; l < n_layers - 1; ++l) {
    gather_inputs<H>(x, xrow, xs);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = lane + 32 * k;
      x[k] = fmaxf(__fadd_rn(dot_in_order<H>(xs, sw + (l * H + o) * S), sb[l * H + o]), 0.f);
    }
  }
  gather_inputs<H>(x, xrow, xs);
  const int head = n_layers - 1;
  return __fadd_rn(dot_in_order<H>(xs, sw + head * H * S), sb[head * H]);
}

// The raw head value at one point; sw: the transposed stack, sb: its
// biases (stage_weights_split), xrow: the warp's row of H floats.
template <int H>
__device__ __forceinline__ float split_sdf(const float* sw, const float* sb, float* xrow,
                                           int n_layers, int n_inputs, float px, float py,
                                           float pz, float frame) {
  constexpr int K = H / 32;  // outputs a lane owns
  constexpr int S = split_stride(H);
  const int lane = threadIdx.x & 31;
  const float in[4] = {px, py, pz, frame};
  if (n_layers == 1) {  // the head is the first layer: row 0
    const float4 w = *reinterpret_cast<const float4*>(sw);
    const float wi[4] = {w.x, w.y, w.z, w.w};
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) d = fmaf(in[i], wi[i], d);
    return __fadd_rn(d, sb[0]);
  }
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(sw + (lane + 32 * k) * S);
    const float wi[4] = {w.x, w.y, w.z, w.w};
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) v = fmaf(in[i], wi[i], v);
    x[k] = fmaxf(__fadd_rn(v, sb[lane + 32 * k]), 0.f);
  }

  return split_layers<H>(sw, sb, xrow, 1, n_layers, x);
}

// ---------------------------------------------------------------------------
// K3: the fused forward, 3xTF32 on the tensor cores.
//
// Replaces pallas/fused_mlp.py::_fused_mlp_kernel (mlp_forward_pallas, whose
// default precision is HIGHEST), so its result is FP32-grade: each product
// is a_big * b_big + a_big * b_small + a_small * b_big (mma.cuh mma_3xtf32),
// big = tf32(v), small = tf32(v - big), summed in FP32. That runs at the
// tf32 rate, 495 TFLOP/s / 3, where FP32 FFMA gives 67: the bound of an
// FP32-accurate chain on this card is 0.406x the FFMA bound. The TPU's
// six-pass bf16 HIGHEST would cost six bf16 products at 989 TFLOP/s, the
// same rate, with more splitting.
//
// Design. A block owns a tile of kPoints points and runs every layer on it:
//   * the tile's activations [kPoints, H] FP32 live in shared memory (row
//     stride H + 8 floats: a lane's a0/a2 pair is one conflict-free 64-bit
//     load); the first layer (3 or 4 true inputs) runs on FFMA straight
//     into it, each output summed in input order from zero, bias last;
//   * each hidden layer's output columns are split between the warps: a
//     warp owns kTilesN n-tiles of 8 columns for all kPoints rows and keeps
//     them in accumulator registers while every warp reads the input; after
//     a block barrier the warps write bias + ReLU back over the input;
//   * weights are fragment-ordered FP32 (fused_mlp.packed_mma(params,
//     "tf32")): a lane's two B values for an n-tile and k-chunk are one
//     64-bit load from L2, coalesced across the warp, prefetched one
//     k-chunk ahead, split into big/small in registers. The stack is not
//     stored pre-split: at 1024 two copies of 37.7 MB would exceed the
//     50 MB L2. As each warp reads only its own columns, a block reads
//     each weight byte once per layer; a shared-memory ring would copy them
//     without reuse, so there is none, and the stack is not staged at 32/64;
//   * the head computes column 0 only, on FFMA: a warp per row, lanes
//     strided over the input, a shuffle reduction, bias last.
// A weight byte read from L2 serves kPoints points: L2 bytes per point are
// 4 * (L - 2) * H^2 / kPoints + the head and first layer (chip_smoke.py
// prints them). Budget by width (227 KB of shared memory and 64K registers
// an SM; accumulators = kPoints / 16 * kTilesN * 4 per lane; registers and
// spills as ptxas reports them for sm_90a, chip_smoke.py phase 2):
//     H     kPoints  warps  n-tiles/warp  accumulators  shared memory  registers  spill st/ld
//     32    128      4      1             32            20.0 KB        113        0 / 0 B
//     64    128      8      1             32            36.0 KB        107        0 / 0 B
//     128   64       8      2             32            34.0 KB        92         0 / 0 B
//     256   64       8      4             64            66.0 KB        168        0 / 0 B
//     512   64       16     4             64            130.0 KB       128        88 / 64 B
//     1024  32       16     8             64            129.0 KB       128        208 / 156 B
// At 512 and 1024, 512 threads a block leave 128 registers a thread; at
// 1024 two 64-point tiles would need 264 KB, so the tile is 32 points and
// each weight serves 32 (128 KB of L2 reads per point per layer). There the
// 128-register cap spills: the accumulators, the prefetched B pair and the
// big/small splits do not fit, and ptxas stores 88 B (512) and 208 B (1024)
// a thread to local memory. Their cost is not measured apart (no profiler
// reads it on the card); K3 runs at 0.74x (512) and 0.60x (1024) of its
// FP32 bound's speed and 1.7x / 1.16x the cuBLAS plain version's, and
// fewer warps a block (more registers a thread) or clusters sharing the
// weight tiles (TMA multicast) are the next step (ROADMAP section 2b).
template <int H>
struct ForwardTile {
  static constexpr int kPoints = H <= 64 ? 128 : (H <= 512 ? 64 : 32);
  static constexpr int kWarps = H == 32 ? 4 : (H <= 256 ? 8 : 16);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTilesN = H / 8 / kWarps;
  static constexpr int kTilesM = kPoints / 16;
  static constexpr int kStride = H + 8;
  static_assert(kTilesN >= 1 && kTilesN * kWarps * 8 == H, "warps must split the n-tiles");
};

__host__ __device__ constexpr size_t forward_smem_bytes(int h) {
  return h == 32     ? sizeof(float) * ForwardTile<32>::kPoints * ForwardTile<32>::kStride
         : h == 64   ? sizeof(float) * ForwardTile<64>::kPoints * ForwardTile<64>::kStride
         : h == 128  ? sizeof(float) * ForwardTile<128>::kPoints * ForwardTile<128>::kStride
         : h == 256  ? sizeof(float) * ForwardTile<256>::kPoints * ForwardTile<256>::kStride
         : h == 512  ? sizeof(float) * ForwardTile<512>::kPoints * ForwardTile<512>::kStride
                     : sizeof(float) * ForwardTile<1024>::kPoints * ForwardTile<1024>::kStride;
}

// K3: the chain's head value at each of n points x [n, n_inputs]. weights
// [L, H, H] (the first layer and the head are read from it), packed the
// same stack in tf32 fragment order [L, H/8, H/8, 32] float2.
template <int H>
__global__ void __launch_bounds__(ForwardTile<H>::kThreads)
mlp_forward_kernel(const float* __restrict__ x, const float* __restrict__ weights,
                   const float2* __restrict__ packed, const float* __restrict__ biases,
                   int n_layers, int n_inputs, int n, float* __restrict__ out) {
  using T = ForwardTile<H>;
  constexpr int KT = H / 8, NT = T::kTilesN, MT = T::kTilesM, S = T::kStride;
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.x * T::kPoints;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  if (n_layers == 1) {  // the head is the first layer
    for (int m = threadIdx.x; m < T::kPoints && row0 + m < n; m += T::kThreads) {
      float d = 0.f;
      for (int i = 0; i < n_inputs; ++i)
        d = fmaf(x[static_cast<int64_t>(row0 + m) * n_inputs + i], __ldg(weights + i * H), d);
      out[row0 + m] = __fadd_rn(d, __ldg(biases));
    }
    return;
  }

  for (int e = threadIdx.x; e < T::kPoints * H; e += T::kThreads) {
    const int m = e / H, o = e % H;
    float d = 0.f;
    if (row0 + m < n)
      for (int i = 0; i < n_inputs; ++i)
        d = fmaf(x[static_cast<int64_t>(row0 + m) * n_inputs + i], __ldg(weights + i * H + o), d);
    act[m * S + o] = fmaxf(__fadd_rn(d, __ldg(biases + o)), 0.f);
  }
  __syncthreads();

  const int n0 = warp * NT;  // this warp's first n-tile
#pragma unroll 1
  for (int l = 1; l < n_layers - 1; ++l) {
    const float2* wl = packed + static_cast<size_t>(l) * KT * KT * 32 + n0 * 32 + lane;
    float acc[NT][MT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][mt][c] = 0.f;
    float2 bnext[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) bnext[j] = __ldg(wl + j * 32);
#pragma unroll 1
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t abig[MT][4], asmall[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // physical columns 8kk + 2t and 8kk + 2t + 1 are the MMA's k = t and t + 4
        const float2 r0 =
            *reinterpret_cast<const float2*>(act + (16 * mt + g) * S + 8 * kk + 2 * t);
        const float2 r1 =
            *reinterpret_cast<const float2*>(act + (16 * mt + g + 8) * S + 8 * kk + 2 * t);
        split_tf32(r0.x, abig[mt][0], asmall[mt][0]);
        split_tf32(r1.x, abig[mt][1], asmall[mt][1]);
        split_tf32(r0.y, abig[mt][2], asmall[mt][2]);
        split_tf32(r1.y, abig[mt][3], asmall[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0big, b0small, b1big, b1small;
        split_tf32(bnext[j].x, b0big, b0small);
        split_tf32(bnext[j].y, b1big, b1small);
        if (kk + 1 < KT) bnext[j] = __ldg(wl + ((kk + 1) * KT + j) * 32);
        mma_3xtf32(acc[j], abig, asmall, b0big, b1big, b0small, b1small);
      }
    }
    __syncthreads();  // every warp has read the layer's input
    const float* bl = biases + l * H;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * (n0 + j) + 2 * t;
      const float b0 = __ldg(bl + col), b1 = __ldg(bl + col + 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        *reinterpret_cast<float2*>(act + (16 * mt + g) * S + col) =
            make_float2(fmaxf(__fadd_rn(acc[j][mt][0], b0), 0.f),
                        fmaxf(__fadd_rn(acc[j][mt][1], b1), 0.f));
        *reinterpret_cast<float2*>(act + (16 * mt + g + 8) * S + col) =
            make_float2(fmaxf(__fadd_rn(acc[j][mt][2], b0), 0.f),
                        fmaxf(__fadd_rn(acc[j][mt][3], b1), 0.f));
      }
    }
    __syncthreads();
  }

  const float* wh = weights + static_cast<size_t>(n_layers - 1) * H * H;  // column 0
  const float bh = __ldg(biases + (n_layers - 1) * H);
  for (int m = warp; m < T::kPoints; m += T::kWarps) {
    float d = 0.f;
#pragma unroll 4
    for (int k = lane; k < H; k += 32) d = fmaf(act[m * S + k], __ldg(wh + k * H), d);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
    if (lane == 0 && row0 + m < n) out[row0 + m] = __fadd_rn(d, bh);
  }
}

template <int H>
int launch_mlp_forward(const MlpArgs& a, cudaStream_t stream) {
  if (a.n_layers < 1 || a.n_inputs < 1 || a.n_inputs > 4 || a.packed == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n <= 0) return 0;
  const size_t smem = forward_smem_bytes(H);
  cudaError_t err = allow_smem(mlp_forward_kernel<H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.n + ForwardTile<H>::kPoints - 1) / ForwardTile<H>::kPoints;
  mlp_forward_kernel<H><<<grid, ForwardTile<H>::kThreads, smem, stream>>>(
      a.x, a.weights, static_cast<const float2*>(a.packed), a.biases, a.n_layers, a.n_inputs,
      a.n, a.out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2h on the tensor cores: the three-pass chain as a warp-collective call.
//
// The march kernel's three-pass instantiations (march.cuh, kThreePass) run
// the chain for the 32 rays of a warp together, as a product with M = 32
// rows (ray = lane = row), two m16 tiles. Per layer, acc = x_lo * w_hi +
// x_hi * w_lo + x_hi * w_hi on m16n8k16 bf16 MMA into one FP32 accumulator
// (mma.cuh mma_3pass), then + bias and ReLU; the activations are split per
// layer as the plain version splits them (x_hi = bf16(x), x_lo =
// bf16(x - x_hi)). Each product of two bfloat16 values is exact in FP32, so
// only the sums round, but in the tensor core's order and in one
// accumulator: the result is no longer the plain version's bit for bit
// (kernels/fused_mlp.py mlp_chain_3pass_plain sums three float32 products),
// and chip_smoke.py holds it to a tolerance instead.
//
// What bounds it: the three bf16 products per weight at 989 TFLOP/s. The
// first contraction takes the true 3 or 4 inputs as one k-chunk padded to
// 16 (the inputs gathered from their lanes with shuffles, the padded
// weight rows zero); the head is n-tile 0 of the last layer, column 0 read
// from the accumulator lanes with t = 0 and shuffled back to the ray's lane.
//
// Where things live, by width (the stack in bf16 fragment order,
// fused_mlp.packed_mma(params, "bf16"): a lane's hi and lo B fragments of
// one n-tile and k-chunk are one 128-bit load):
//   * H = 32, 64: the stack in shared memory (staged once per block, as many
//     bytes as the FP32 stack: 37 KB / 150 KB at 9 layers); the activations
//     stay in registers, each layer's accumulators handed to the next
//     layer's A fragments in place (mma.cuh), both m-tiles at once;
//   * H = 128: a block's group of rays at once (csrc/hidden128_group.cuh:
//     the warps split each layer's columns, so a fragment fetched from L2
//     serves the group's kGroupRays rays, not a warp's 16);
//   * H = 256 to 1024: the stack is read from L2 (fragment-ordered loads,
//     each warp on its own: the warps of a block do not step together, so
//     no ray waits on another warp's straggler). A warp's activations go
//     to shared memory, already split, an (hi, lo) pair of bf16x2 per two
//     columns in 8 bytes (a row stride of H/2 + 4 such pairs: the A loads
//     and the epilogue stores are conflict-free). The two m-tiles run one
//     after the other, each through two buffers [16, H] (input and output),
//     each layer's output in chunks of 64 columns held in accumulators:
//     2 * 16 * (H/2 + 4) * 8 bytes a warp, 33 KB at 256, 65 KB at 512,
//     129 KB at 1024. Warps a block: 2, 1, 1. At 256 ptxas caps the block's
//     registers at 128 a thread and spills 120-122 B a thread in four of
//     the eight scene instantiations (scenes 2, 3 and 4 at windows 3 and
//     5); the others spill nothing (chip_smoke.py phase 2 prints each).
//   * H = 1024: the tightest budget. 32 rows would need 264 KB for the two
//     buffers, more than an SM has, and keeping a layer's output in
//     registers would need 1024 accumulators a lane; so the m-tiles take
//     turns, a block is one warp with 129 KB, one block an SM: 132 warps
//     march at once on the card, each reading the whole 37.7 MB stack once
//     per m-tile and step.

// At H = 128 the march kernel runs the chain for a block's group of
// kGroupRays consecutive rays at once (csrc/hidden128_group.cuh): a block
// of kGroupBlock threads, a ray each, whose kGroupBlock / kGroupRays groups
// take turns through one pair of activation buffers [kGroupRays,
// act_words(128)]. 64-ray groups in blocks of 4 warps (each warp 32 of a
// layer's columns, 3 blocks an SM) marched faster than 128-ray groups in
// one block of 8 warps an SM (PERF.md); kernels/megakernel.py SHARED_GROUP
// names the group.
constexpr int kGroupRays = 64;
constexpr int kGroupBlock = 128;
// 4-byte words of a ray's state that wait in shared memory while a block's
// chains run.
constexpr int kGroupStateWords = 10;

// Threads of a block of the march kernel, whose chains (the FP32 one and
// the three-pass one) both run for the 32 rays of a warp together on the
// tensor cores: 128 at 32 and 256 at 64, where the block stages the stack
// (at 64 its 150 KB leave one block an SM), at 128 kGroupBlock, and at
// 256-1024 as many warps as their activation buffers allow (2, 1, 1).
__host__ __device__ constexpr int march_block(int h) {
  return h == 32 ? 128 : (h == 64 ? 256 : (h == 128 ? kGroupBlock : (h == 256 ? 64 : 32)));
}

// 4-byte words of a row of the activation buffers at H >= 128: H FP32
// values (K1), or H / 2 (hi, lo) bf16x2 pairs of 8 bytes (K2h), then 8
// words of padding that make the A loads and epilogue stores
// conflict-free.
__host__ __device__ constexpr int act_words(int h) { return h + 8; }

// An (hi, lo) bf16x2 pair per two activation columns: pairs per row.
__host__ __device__ constexpr int act_pairs(int h) { return act_words(h) / 2; }

// Dynamic shared memory of a 128-wide march block: the group's two
// activation buffers, a head value a thread, a ballot a warp, each ray's
// state, the rays' origin.
__host__ __device__ constexpr size_t group_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kGroupRays) * act_words(128) + kGroupBlock) +
         sizeof(uint32_t) * (kGroupBlock / 32) +
         sizeof(float) * (static_cast<size_t>(kGroupStateWords) * kGroupBlock + 3);
}

// Dynamic shared memory of a march block: the staged stack and its biases
// (H = 32, 64: FP32 in tf32 fragment order, or the bf16 hi and lo halves in
// as many bytes), the group's buffers (H = 128), or each warp's two
// activation buffers [16, act_words(H)] (H >= 256).
__host__ __device__ constexpr size_t march_smem_bytes(int h, int n_layers) {
  return h <= 64    ? sizeof(float) * static_cast<size_t>(n_layers) * h * (h + 1)
         : h == 128 ? group_smem_bytes()
                    : static_cast<size_t>(march_block(h) / 32) * 2 * 16 * act_words(h) *
                          sizeof(float);
}

// Output columns of a layer chunk at H >= 128 (8 n-tiles).
constexpr int kMmaChunkTiles = 8;

// The packed stack (and biases) where the three-pass march kernel reads
// them: shared memory at H = 32, 64 after every thread of the block has
// helped copy them in, device memory as it is above. Call before any
// thread leaves the kernel.
template <int H>
__device__ __forceinline__ void stage_weights_mma(const uint4* __restrict__ packed,
                                                  const float* __restrict__ biases,
                                                  int n_layers, const uint4*& w,
                                                  const float*& b) {
  if constexpr (H <= 64) {
    extern __shared__ float4 smem4[];
    uint4* s4 = reinterpret_cast<uint4*>(smem4);
    const int n_w16 = n_layers * H * H / 4;  // 16 bytes each, hi and lo together
    for (int k = threadIdx.x; k < n_w16; k += blockDim.x) s4[k] = packed[k];
    float* sb = reinterpret_cast<float*>(s4 + n_w16);
    for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) sb[k] = biases[k];
    __syncthreads();
    w = s4;
    b = sb;
  } else {
    w = packed;
    b = biases;
  }
}

// The A fragments (hi, lo) of m-tile mt for the first contraction: row r
// holds ray r's inputs (x, y, z, frame or 0) in columns 0-3, zero beyond.
__device__ __forceinline__ void inputs_a(int mt, float px, float py, float pz, float pf,
                                         uint32_t (&ahi)[4], uint32_t (&alo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int src = 16 * mt + 8 * half + g;
    const float x = __shfl_sync(0xffffffffu, px, src);
    const float y = __shfl_sync(0xffffffffu, py, src);
    const float z = __shfl_sync(0xffffffffu, pz, src);
    const float f = __shfl_sync(0xffffffffu, pf, src);
    const float c0 = t == 0 ? x : (t == 1 ? z : 0.f);  // columns 2t, 2t + 1
    const float c1 = t == 0 ? y : (t == 1 ? f : 0.f);
    split_bf16x2(c0, c1, ahi[half], alo[half]);
    ahi[2 + half] = alo[2 + half] = 0u;  // columns 8-15
  }
}

// Each ray's head value, from the accumulators of n-tile 0 (column 0 sits in
// the lanes with t = 0: row g in c0, row g + 8 in c2), back to its lane.
__device__ __forceinline__ float head_to_ray(const float (&h)[2][1][4]) {
  const int lane = threadIdx.x & 31, src = 4 * (lane & 7);
  const float v00 = __shfl_sync(0xffffffffu, h[0][0][0], src);
  const float v02 = __shfl_sync(0xffffffffu, h[0][0][2], src);
  const float v10 = __shfl_sync(0xffffffffu, h[1][0][0], src);
  const float v12 = __shfl_sync(0xffffffffu, h[1][0][2], src);
  const bool upper = lane & 8;
  return lane & 16 ? (upper ? v12 : v10) : (upper ? v02 : v00);
}

// H = 32, 64: every layer from the first layer's input A fragments (hi,
// lo) of both m-tiles, its first kin k-chunks nonzero; activations in
// registers, the stack in shared memory.
template <int H>
__device__ __forceinline__ float chain_3pass_layers(const uint4* __restrict__ w,
                                                    const float* __restrict__ b, int n_layers,
                                                    uint32_t (&ahi)[2][H / 16][4],
                                                    uint32_t (&alo)[2][H / 16][4], int kin) {
  constexpr int NT = H / 8, KT = H / 16;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll 1
  for (int l = 0; l < n_layers - 1; ++l) {
    const uint4* wl = w + l * KT * NT * 32 + lane;
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk < kin) {
        uint4 wv[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) wv[j] = wl[(kk * NT + j) * 32];
        mma_3pass(acc[0], ahi[0][kk], alo[0][kk], wv);
        mma_3pass(acc[1], ahi[1][kk], alo[1][kk], wv);
      }
    }
    const float* bl = b + l * H;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = bl[8 * j + 2 * t], b1 = bl[8 * j + 2 * t + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // n-tile j's rows g and g + 8 are registers 0-1 (j even) or 2-3 (j
        // odd) of k-chunk j / 2's A fragment
        split_bf16x2(fmaxf(__fadd_rn(acc[mt][j][0], b0), 0.f),
                     fmaxf(__fadd_rn(acc[mt][j][1], b1), 0.f), ahi[mt][j / 2][2 * (j % 2)],
                     alo[mt][j / 2][2 * (j % 2)]);
        split_bf16x2(fmaxf(__fadd_rn(acc[mt][j][2], b0), 0.f),
                     fmaxf(__fadd_rn(acc[mt][j][3], b1), 0.f), ahi[mt][j / 2][2 * (j % 2) + 1],
                     alo[mt][j / 2][2 * (j % 2) + 1]);
      }
    }
    kin = KT;
  }
  const uint4* wl = w + (n_layers - 1) * KT * NT * 32 + lane;
  float h[2][1][4] = {{{0.f, 0.f, 0.f, 0.f}}, {{0.f, 0.f, 0.f, 0.f}}};
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk < kin) {
      const uint4 wv[1] = {wl[kk * NT * 32]};
      mma_3pass(h[0], ahi[0][kk], alo[0][kk], wv);
      mma_3pass(h[1], ahi[1][kk], alo[1][kk], wv);
    }
  }
  return __fadd_rn(head_to_ray(h), b[(n_layers - 1) * H]);
}

// H = 32, 64: activations in registers, the stack in shared memory.
template <int H>
__device__ __forceinline__ float chain_3pass_regs(const uint4* __restrict__ w,
                                                  const float* __restrict__ b, int n_layers,
                                                  float px, float py, float pz, float pf) {
  constexpr int KT = H / 16;
  uint32_t ahi[2][KT][4], alo[2][KT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) ahi[mt][kk][c] = alo[mt][kk][c] = 0u;
    inputs_a(mt, px, py, pz, pf, ahi[mt][0], alo[mt][0]);
  }
  return chain_3pass_layers<H>(w, b, n_layers, ahi, alo, 1);  // the inputs are one k-chunk
}

// The A fragments (hi, lo) of k-chunk kk from a shared-memory buffer of 16
// rows of (hi, lo) pairs.
template <int H>
__device__ __forceinline__ void load_a(const uint2* __restrict__ in, int kk, uint32_t (&ahi)[4],
                                       uint32_t (&alo)[4]) {
  constexpr int S = act_pairs(H);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2 a0 = in[g * S + 8 * kk + t], a1 = in[(g + 8) * S + 8 * kk + t];
  const uint2 a2 = in[g * S + 8 * kk + 4 + t], a3 = in[(g + 8) * S + 8 * kk + 4 + t];
  ahi[0] = a0.x, ahi[1] = a1.x, ahi[2] = a2.x, ahi[3] = a3.x;
  alo[0] = a0.y, alo[1] = a1.y, alo[2] = a2.y, alo[3] = a3.y;
}

// One layer (l < n_layers - 1) of one m-tile at H >= 128: out = split(ReLU(
// in * W_l + b_l)), in the k-chunks of `in` (kin of them; 1 for the inputs,
// given as fragments in phi / plo), in chunks of kMmaChunkTiles n-tiles.
template <int H>
__device__ __forceinline__ void layer_3pass_smem(const uint2* __restrict__ in, int kin,
                                                 const uint32_t (&phi)[4],
                                                 const uint32_t (&plo)[4],
                                                 const uint4* __restrict__ wl,
                                                 const float* __restrict__ bl,
                                                 uint2* __restrict__ out) {
  constexpr int NT = H / 8, CT = kMmaChunkTiles, S = act_pairs(H);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int c = 0; c < NT; c += CT) {
    float acc[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kin; ++kk) {
      uint4 wv[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) wv[j] = __ldg(wl + (kk * NT + c + j) * 32 + lane);
      uint32_t ahi[4], alo[4];
      if (in == nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ahi[e] = phi[e], alo[e] = plo[e];
      } else {
        load_a<H>(in, kk, ahi, alo);
      }
      mma_3pass(acc, ahi, alo, wv);
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int col = 8 * (c + j) + 2 * t;
      const float b0 = __ldg(bl + col), b1 = __ldg(bl + col + 1);
      uint2 r0, r1;
      split_bf16x2(fmaxf(__fadd_rn(acc[j][0], b0), 0.f), fmaxf(__fadd_rn(acc[j][1], b1), 0.f),
                   r0.x, r0.y);
      split_bf16x2(fmaxf(__fadd_rn(acc[j][2], b0), 0.f), fmaxf(__fadd_rn(acc[j][3], b1), 0.f),
                   r1.x, r1.y);
      out[g * S + 4 * (c + j) + t] = r0;
      out[(g + 8) * S + 4 * (c + j) + t] = r1;
    }
  }
}

// H = 128 to 1024: activations in this warp's two shared-memory buffers
// `buf` [2][16][act_pairs(H)], the stack read from L2.
template <int H>
__device__ __forceinline__ float chain_3pass_smem(const uint4* __restrict__ w,
                                                  const float* __restrict__ b, int n_layers,
                                                  float px, float py, float pz, float pf,
                                                  uint2* __restrict__ buf) {
  constexpr int NT = H / 8, KT = H / 16, S = act_pairs(H);
  const int lane = threadIdx.x & 31;
  const uint4* wh = w + static_cast<size_t>(n_layers - 1) * KT * NT * 32 + lane;
  float h[2][1][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t phi[4], plo[4];
    inputs_a(mt, px, py, pz, pf, phi, plo);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[mt][0][e] = 0.f;
    if (n_layers == 1) {
      const uint4 wv[1] = {__ldg(wh)};
      mma_3pass(h[mt], phi, plo, wv);
      continue;
    }
    layer_3pass_smem<H>(nullptr, 1, phi, plo, w, b, buf);
    __syncwarp();
#pragma unroll 1
    for (int l = 1; l < n_layers - 1; ++l) {
      layer_3pass_smem<H>(buf + ((l - 1) & 1) * 16 * S, KT, phi, plo,
                          w + static_cast<size_t>(l) * KT * NT * 32, b + l * H,
                          buf + (l & 1) * 16 * S);
      __syncwarp();
    }
    const uint2* in = buf + ((n_layers - 2) & 1) * 16 * S;
#pragma unroll 1
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ahi[4], alo[4];
      load_a<H>(in, kk, ahi, alo);
      const uint4 wv[1] = {__ldg(wh + kk * NT * 32)};
      mma_3pass(h[mt], ahi, alo, wv);
    }
    __syncwarp();  // the next m-tile overwrites the buffers
  }
  return __fadd_rn(head_to_ray(h), __ldg(b + (n_layers - 1) * H));
}

// The three-pass chain's raw head value for each ray of the warp, called
// by all 32 lanes together (rays that do not march pass any finite point:
// rows do not mix). w, b: where stage_weights_mma<H> put the stack; buf:
// this warp's activation buffers at H >= 128.
template <int H>
__device__ __forceinline__ float chain_sdf_mma(const uint4* __restrict__ w,
                                               const float* __restrict__ b, int n_layers,
                                               int n_inputs, float px, float py, float pz,
                                               float frame, uint2* __restrict__ buf) {
  const float pf = n_inputs == 4 ? frame : 0.f;
  if constexpr (H <= 64)
    return chain_3pass_regs<H>(w, b, n_layers, px, py, pz, pf);
  else
    return chain_3pass_smem<H>(w, b, n_layers, px, py, pz, pf, buf);
}

// ---------------------------------------------------------------------------
// K1's FP32 chain on the tensor cores (every width).
//
// The march kernel's FP32 instantiations (precisions DEFAULT and HIGHEST;
// march.cuh) run the chain for the 32 rays of a warp together, as K2h
// does: a product with M = 32 rows (ray = lane = row), two m16 tiles, on
// m16n8k8 tf32 MMA at FP32-grade precision (3xTF32): per k-chunk of 8 the
// products a_small * b_big, a_big * b_small, a_big * b_big, the chunk's
// sum added to an FP32 accumulator with a round-to-nearest add; then bias
// and ReLU in FP32. The tensor cores truncate a chunk's sum toward zero,
// and left so a chain of ReLU layers drifts low. From 128 (mma.cuh
// mma_3xtf32_rows) the truncated sum is rounded to even (round_to_even),
// unbiased but up to an ulp off; at 32 and 64 (mma_tf32_tiles) one more
// MMA recovers what the truncation dropped, so the chunk's sum reaches
// the accumulator rounded to nearest, and at 32 a fourth product,
// a_small * b_small, is kept (tf32_passes): the 32- and 64-wide layers sum
// too few products for their chunks' errors to average out, and on the
// card the rounded-to-even chain's SDF lay 1.26x (32) and 1.39x (64) as
// far from float64 as the plain chain's on the lanes where two marches
// part (chip_smoke.py's witness bar is 1.25x; PERF.md). From 128
// the first layer is one k-chunk (the 3 or 4 true inputs gathered from
// their lanes by shuffles, the padded weight rows zero), a few MMAs next to
// a hidden layer's 3 * (H/8)^2; at 32 and 64 it runs on FFMA in the plain
// version's order (first_layer_ffma), its weights read from the packed
// stack. The head is n-tile 0 of the last layer, its column 0 shuffled
// back to each ray's lane (head_to_ray). The result is no
// longer the plain version's (cuBLAS FP32, each output summed in input
// order) bit for bit: fused_mlp.mlp_chain_3xtf32_mma models this order at
// every width, and chip_smoke.py holds the kernel to its plain version at
// the bar of a chain summed in the tensor cores' order (K1_MMA_SDF_ATOL and
// the shares), with the lanes beyond it replayed.
//
// What bounds it: the three tf32 products per weight at 495 TFLOP/s, 0.406x
// the FP32 FFMA bound (chip_smoke.py tc_bound_ms), the least an
// FP32-accurate chain on the tensor cores could take; at 32 and 64 the
// kernel issues 5 and 4 MMAs a weight (the residual, the fourth product).
// Each weight pair is split where it is loaded and each activation where
// it is read, and each chunk's sum is corrected or rounded and added, a
// few FP32 and integer operations per MMA beside it.
//
// Where things live. The stack is in tf32 fragment order
// (fused_mlp.packed_mma(params, "tf32"), K3's layout of the FP32 values): a
// lane's B pair of one n-tile and k-chunk is one 64-bit load, split into
// big / small in registers. It is not stored pre-split: at 64 the two
// halves would need 300 KB of shared memory, at 1024 two 37.7 MB copies
// would not fit the 50 MB L2. Then, by width:
//   * H = 32, 64 (chain_tf32_regs): the stack, as many bytes as the FP32
//     stack (37 KB / 150 KB at 9 layers), staged in shared memory once per
//     block, and each B pair read there for both m-tiles. The activations
//     stay in registers, both m-tiles at once: under pack_mma's permutation
//     of k, n-tile j's accumulators are k-chunk j's A fragment in the same
//     lane (mma.cuh), so bias + ReLU write each layer's output where the
//     next layer reads it, as FP32 values split into big / small once per
//     layer as they are read. A lane holds 2 * H/8 * 4 activations and as
//     many accumulators (32 + 32 at H = 32, 64 + 64 at 64); the n-tiles of
//     a k-chunk run in groups of kRegTiles, each MMA pass over a group's
//     2 * kRegTiles tiles before the next pass (groups of 4 ran as fast
//     at 32, and at 64 spilled 300 B a thread once the first layer moved
//     to FFMA);
//   * H = 128: a block's group of rays at once (csrc/hidden128_group.cuh),
//     K2h's budget; each B pair fetched once per group and split once for
//     all of its m-tiles;
//   * H = 256 to 1024 (chain_tf32_smem; K2h's budget, FP32 activations in
//     the bytes of its (hi, lo) pairs): the stack read from L2, each B pair
//     prefetched a k-chunk ahead; a warp's activations in its own two
//     shared-memory buffers [16, act_words(H) = H + 8] FP32, the layer's
//     input and output (the padded stride makes a lane's a0 / a2 pair one
//     conflict-free 64-bit load, and the epilogue's stores conflict-free),
//     split into big / small as they are read. The two m-tiles take turns
//     through them: 2 * 16 * (H + 8) * 4 bytes a warp, 33 / 65 / 129 KB
//     at 256 / 512 / 1024, with 2 / 1 / 1 warps a block
//     (march_block), so each warp reads the stack once per m-tile and step;
//     each layer's output in chunks of kMmaChunkTiles n-tiles (64 columns)
//     held in accumulators, 32 a lane.
// Budget by width over the 8 scene instantiations (registers, stack and
// spills as ptxas reports them for sm_90a, chip_smoke.py phase 2):
//     H     warps  shared memory  blocks an SM  registers  stack    spill st/ld
//     32    4      37.1 KB        3             142-145    0 (32)   0 / 0 B
//     64    8      146.3 KB       1             255        120-168  266-322 / 196-260 B
//     128   4      73.5 KB        3             157-168    0-32     0 / 0 B  (a block's group)
//     256   2      66.0 KB        3             153-158    0 (32)   0 / 0 B
//     512   1      65.0 KB        3             127-158    0 (32)   0 / 0 B
//     1024  1      129.0 KB       1             127-158    0 (32)   0 / 0 B
// The 64-wide units spill: their 128 activations and accumulators a
// lane, the MMA temporaries and the first layer's inputs exceed the
// 255-register cap; at 128 three of the 16 group kernels spill 8 B (the
// three-pass chain under scenes 2, 3 and window 3, at 3 blocks' 168); the displacement scene's 32-byte frame is sinf's range
// reduction. Registers set the warps an SM holds at 32 (12) and shared
// memory from 64 (8 at 64, where 512 threads a block spilled 600 B a thread
// under the 128-register cap and ran slower; 12, 6, 3 and 1 at 128-1024;
// at 128 both chains' 16 instantiations: csrc/hidden128_group.cuh),
// so at 512 and 1024 one or three warps' MMAs, loads and splits cannot
// hide each other's latency; that, not the tensor cores' rate, bounds the
// wide widths (PERF.md).

// The tf32 A fragments (big, small) of m-tile mt for the first contraction:
// row r holds ray 16 mt + r's inputs (x, y, z, frame or 0) in physical
// columns 0-3, zero beyond (physical columns 2t and 2t + 1 are the MMA's
// k = t and t + 4: a0 / a1 rows g / g + 8 of column 2t, a2 / a3 of 2t + 1).
__device__ __forceinline__ void inputs_a_tf32(int mt, float px, float py, float pz, float pf,
                                              uint32_t (&abig)[4], uint32_t (&asmall)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int src = 16 * mt + 8 * half + g;
    const float x = __shfl_sync(0xffffffffu, px, src);
    const float y = __shfl_sync(0xffffffffu, py, src);
    const float z = __shfl_sync(0xffffffffu, pz, src);
    const float f = __shfl_sync(0xffffffffu, pf, src);
    split_tf32(t == 0 ? x : (t == 1 ? z : 0.f), abig[half], asmall[half]);
    split_tf32(t == 0 ? y : (t == 1 ? f : 0.f), abig[2 + half], asmall[2 + half]);
  }
}

// N-tiles of a k-chunk whose three passes chain_tf32_regs issues together
// (for both m-tiles: 2 * kRegTiles independent MMAs a pass), and the group
// of a layer that computes n of them.
constexpr int kRegTiles = 2;
__host__ __device__ constexpr int reg_group(int n) { return n < kRegTiles ? n : kRegTiles; }

// The tf32 products per weight of the FP32 chain at width h (32, 64): 3
// (3xTF32), and at 32 a fourth, a_small * b_small, the last of each
// chunk's MMAs (mma.cuh mma_tf32_tiles). Without it the chain's SDF on the
// shipped 3 -> 32 x 8 -> 1 net lay 1.15-1.25x as far from float64 as the
// plain chain's on the lanes where two marches part, on the card (1.00-
// 1.04x with it, for 11% of the coarse call's time; 64-wide: 0.94-0.98x
// with three): a 32-wide layer sums too few products for the dropped
// 2^-22 terms to hide in the FP32 sum's own rounding (PERF.md).
__host__ __device__ constexpr int tf32_passes(int h) { return h == 32 ? 4 : 3; }

// acc += x (FP32 values in A-fragment slots, both m-tiles) times the
// first N of the layer's NT n-tiles (the head: N = 1), kPasses tf32
// products per weight (mma.cuh mma_tf32_tiles), over x's first KIN
// k-chunks (the rest zero); wl: the layer's stack in tf32 fragment order
// at this lane's first B pair.
template <int kPasses, int KT, int NT, int N, int KIN = KT>
__device__ __forceinline__ void layer_tf32_regs(
    const float (&x)[2][KT][4], const float2* wl,
    float (&acc)[N / reg_group(N)][2][reg_group(N)][4]) {
  constexpr int G = reg_group(N);
#pragma unroll
  for (int kk = 0; kk < KIN; ++kk) {
    uint32_t abig[2][4], nbig[2][4], asmall[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(x[mt][kk][e], abig[mt][e], asmall[mt][e]);
        nbig[mt][e] = abig[mt][e] ^ 0x80000000u;
      }
#pragma unroll
    for (int q = 0; q < N / G; ++q) {
      float2 bv[G];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) bv[jj] = wl[(kk * NT + q * G + jj) * 32];
      mma_tf32_tiles<kPasses>(acc[q], abig, nbig, asmall, bv);
    }
  }
}

// The first layer at H = 32, 64 on FFMA, each output summed from zero in
// input order with fused multiply-adds, the bias last, then ReLU (the plain
// version's order bit for bit), written in the lane's A-fragment slots:
// lane 4g + t holds rows 16 mt + 8 half + g, columns 8j + 2t + c, in
// x[mt][j][half + 2c]. A 3xTF32 first layer would split the point's
// coordinates to 22 bits and move the SDF by up to 2^-22 of them, as much
// as the rest of the chain's error. w: layer 0 of the stack in tf32
// fragment order, whose B pair of n-tile j in lane 4(2t + c) + i/2 holds
// W[i][8j + 2t + c] and W[i + 1][8j + 2t + c] (i even, pack_mma). With
// kRelu false it writes the pre-activations (the value-and-gradient kernel,
// csrc/value_grad.cu, reads their signs before its ReLU).
template <int H, bool kRelu = true>
__device__ __forceinline__ void first_layer_ffma(const float2* __restrict__ w,
                                                 const float* __restrict__ b, float px, float py,
                                                 float pz, float pf, float (&x)[2][H / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float in[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int src = 16 * mt + 8 * half + g;
      in[mt][half][0] = __shfl_sync(0xffffffffu, px, src);
      in[mt][half][1] = __shfl_sync(0xffffffffu, py, src);
      in[mt][half][2] = __shfl_sync(0xffffffffu, pz, src);
      in[mt][half][3] = __shfl_sync(0xffffffffu, pf, src);
    }
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float2 w01 = w[j * 32 + 4 * (2 * t + c)], w23 = w[j * 32 + 4 * (2 * t + c) + 1];
      const float bias = b[8 * j + 2 * t + c];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float(&v)[4] = in[mt][half];
          float y = fmaf(v[0], w01.x, 0.f);
          y = fmaf(v[1], w01.y, y);
          y = fmaf(v[2], w23.x, y);
          y = fmaf(v[3], w23.y, y);
          const float pre = __fadd_rn(y, bias);
          x[mt][j][half + 2 * c] = kRelu ? fmaxf(pre, 0.f) : pre;
        }
    }
}

// Hidden layer l at H = 32, 64 (chain_tf32_regs) on x, the layer's input
// in A-fragment slots, whose first KIN k-chunks are nonzero; its output,
// bias and ReLU applied, replaces x in the same slots.
template <int H, int KIN = H / 8>
__device__ __forceinline__ void hidden_tf32_regs(const float2* __restrict__ w,
                                                 const float* __restrict__ b, int l,
                                                 float (&x)[2][H / 8][4]) {
  constexpr int NT = H / 8, KT = H / 8, G = reg_group(NT), P = tf32_passes(H);
  const int lane = threadIdx.x & 31, t = lane & 3;
  float acc[NT / G][2][G][4];
#pragma unroll
  for (int q = 0; q < NT / G; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][jj][e] = 0.f;
  layer_tf32_regs<P, KT, NT, NT, KIN>(x, w + l * KT * NT * 32 + lane, acc);
  const float* bl = b + l * H;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(bl + 8 * j + 2 * t);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float(&c)[4] = acc[j / G][mt][j % G];
      // n-tile j's (c0, c1, c2, c3) are k-chunk j's (a0, a2, a1, a3)
      x[mt][j][0] = fmaxf(__fadd_rn(c[0], bias.x), 0.f);
      x[mt][j][2] = fmaxf(__fadd_rn(c[1], bias.y), 0.f);
      x[mt][j][1] = fmaxf(__fadd_rn(c[2], bias.x), 0.f);
      x[mt][j][3] = fmaxf(__fadd_rn(c[3], bias.y), 0.f);
    }
  }
}

// The head (the last layer's column 0) at H = 32, 64 on x, its input in
// A-fragment slots: each ray's raw value, back in its lane.
template <int H>
__device__ __forceinline__ float head_tf32_regs(const float2* __restrict__ w,
                                                const float* __restrict__ b, int n_layers,
                                                const float (&x)[2][H / 8][4]) {
  constexpr int NT = H / 8, KT = H / 8, P = tf32_passes(H);
  const int lane = threadIdx.x & 31;
  float h[1][2][1][4] = {{{{0.f, 0.f, 0.f, 0.f}}, {{0.f, 0.f, 0.f, 0.f}}}};
  layer_tf32_regs<P, KT, NT, 1>(x, w + (n_layers - 1) * KT * NT * 32 + lane, h);
  return __fadd_rn(head_to_ray(h[0]), b[(n_layers - 1) * H]);
}

// H = 32, 64: activations in registers, the stack (tf32 fragment order)
// and its biases in shared memory where stage_weights<H> put them.
template <int H>
__device__ __forceinline__ float chain_tf32_regs(const float2* __restrict__ w,
                                                 const float* __restrict__ b, int n_layers,
                                                 float px, float py, float pz, float pf) {
  constexpr int NT = H / 8, KT = H / 8, G = reg_group(NT);
  static_assert(NT % G == 0, "a layer's n-tiles split into groups of kRegTiles");
  if (n_layers == 1) {  // the head is the first layer: column 0, this lane's ray
    const float2 w01 = w[0], w23 = w[1];
    float y = fmaf(px, w01.x, 0.f);
    y = fmaf(py, w01.y, y);
    y = fmaf(pz, w23.x, y);
    y = fmaf(pf, w23.y, y);
    return __fadd_rn(y, b[0]);
  }
  float x[2][KT][4];  // the layer's input, k-chunk kk's A-fragment values
  first_layer_ffma<H>(w, b, px, py, pz, pf, x);
#pragma unroll 1
  for (int l = 1; l < n_layers - 1; ++l) hidden_tf32_regs<H>(w, b, l, x);
  return head_tf32_regs<H>(w, b, n_layers, x);
}

// The tf32 A fragments (big, small) of k-chunk kk from a shared-memory
// buffer of 16 FP32 rows: a lane's a0 / a2 (row g) and a1 / a3 (row g + 8)
// pairs, physical columns 8 kk + 2t and 8 kk + 2t + 1, one 64-bit load each.
template <int H>
__device__ __forceinline__ void load_a_tf32(const float* __restrict__ in, int kk,
                                            uint32_t (&abig)[4], uint32_t (&asmall)[4]) {
  constexpr int S = act_words(H);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 r0 = *reinterpret_cast<const float2*>(in + g * S + 8 * kk + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(in + (g + 8) * S + 8 * kk + 2 * t);
  split_tf32(r0.x, abig[0], asmall[0]);
  split_tf32(r1.x, abig[1], asmall[1]);
  split_tf32(r0.y, abig[2], asmall[2]);
  split_tf32(r1.y, abig[3], asmall[3]);
}

// One layer (l < n_layers - 1) of one m-tile at H >= 128: out = ReLU(in *
// W_l + b_l) on 3xTF32, over the k-chunks of `in` (kin of them; for the
// inputs, one, given as the fragments pbig / psmall with in == nullptr), in
// chunks of kMmaChunkTiles n-tiles. wl: the layer's stack in tf32 fragment
// order [H/8, H/8, 32] float2 pairs.
template <int H>
__device__ __forceinline__ void layer_tf32_smem(const float* __restrict__ in, int kin,
                                                const uint32_t (&pbig)[4],
                                                const uint32_t (&psmall)[4],
                                                const float2* __restrict__ wl,
                                                const float* __restrict__ bl,
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
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int col = 8 * (c + j) + 2 * t;
      const float b0 = __ldg(bl + col), b1 = __ldg(bl + col + 1);
      *reinterpret_cast<float2*>(out + g * S + col) =
          make_float2(fmaxf(__fadd_rn(acc[j][0], b0), 0.f), fmaxf(__fadd_rn(acc[j][1], b1), 0.f));
      *reinterpret_cast<float2*>(out + (g + 8) * S + col) =
          make_float2(fmaxf(__fadd_rn(acc[j][2], b0), 0.f), fmaxf(__fadd_rn(acc[j][3], b1), 0.f));
    }
  }
}

// The chain at H >= 128 for the two m-tiles in turn, through this warp's
// two shared-memory buffers `buf` [2][16][act_words(H)]; w: the stack in
// tf32 fragment order, read from L2.
template <int H>
__device__ __forceinline__ float chain_tf32_smem(const float2* __restrict__ w,
                                                 const float* __restrict__ b, int n_layers,
                                                 float px, float py, float pz, float pf,
                                                 float* __restrict__ buf) {
  constexpr int NT = H / 8, KT = H / 8, S = act_words(H);
  const int lane = threadIdx.x & 31;
  const float2* wh = w + static_cast<size_t>(n_layers - 1) * KT * NT * 32 + lane;  // n-tile 0
  float h[2][1][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t pbig[4], psmall[4];
    inputs_a_tf32(mt, px, py, pz, pf, pbig, psmall);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[mt][0][e] = 0.f;
    if (n_layers == 1) {  // the head is the first layer
      const float2 wv[1] = {__ldg(wh)};
      mma_3xtf32_rows(h[mt], pbig, psmall, wv);
      continue;
    }
    layer_tf32_smem<H>(nullptr, 1, pbig, psmall, w, b, buf);
    __syncwarp();
#pragma unroll 1
    for (int l = 1; l < n_layers - 1; ++l) {
      layer_tf32_smem<H>(buf + ((l - 1) & 1) * 16 * S, KT, pbig, psmall,
                         w + static_cast<size_t>(l) * KT * NT * 32, b + l * H,
                         buf + (l & 1) * 16 * S);
      __syncwarp();
    }
    const float* in = buf + ((n_layers - 2) & 1) * 16 * S;
    float2 wnext = __ldg(wh);
#pragma unroll 1
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t abig[4], asmall[4];
      load_a_tf32<H>(in, kk, abig, asmall);
      const float2 wv[1] = {wnext};
      if (kk + 1 < KT) wnext = __ldg(wh + (kk + 1) * NT * 32);
      mma_3xtf32_rows(h[mt], abig, asmall, wv);
    }
    __syncwarp();  // the next m-tile overwrites the buffers
  }
  return __fadd_rn(head_to_ray(h), __ldg(b + (n_layers - 1) * H));
}

// The FP32 chain's raw head value for each ray of the warp, called by all
// 32 lanes together (rays that do not march pass any finite point: rows do
// not mix). w: the stack in tf32 fragment order (fused_mlp.packed_mma(
// params, "tf32")), staged in shared memory at H = 32, 64 (stage_weights);
// buf: this warp's activation buffers at H >= 128.
template <int H>
__device__ __forceinline__ float chain_sdf_tf32(const float2* __restrict__ w,
                                                const float* __restrict__ b, int n_layers,
                                                int n_inputs, float px, float py, float pz,
                                                float frame, float* __restrict__ buf) {
  const float pf = n_inputs == 4 ? frame : 0.f;
  if constexpr (H <= 64)
    return chain_tf32_regs<H>(w, b, n_layers, px, py, pz, pf);
  else
    return chain_tf32_smem<H>(w, b, n_layers, px, py, pz, pf, buf);
}

}  // namespace cnr
