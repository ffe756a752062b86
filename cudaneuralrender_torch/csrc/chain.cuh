// The layer chain at every hidden width, its three-pass variant, and the
// fused forward kernel (K3).
//
// The chain replaces the JAX package's pallas/fused_mlp.py::_mlp_chain, which
// the Pallas kernels inline on zero-padded [H, T] activations; the forward
// kernel replaces pallas/fused_mlp.py::_fused_mlp_kernel (launched by
// mlp_forward_pallas, used by neural_sdf_fn_pallas for config.use_pallas).
// The three-pass chain (K2h, at the end of this file) replaces
// pallas/fused_mlp.py::_mlp_chain_3pass, the emulated Precision.HIGH chain on
// the bfloat16 halves of the weights (split_hi_lo), which the march kernel
// runs at precision "high".
//
// What bounds the chain on this card: arithmetic. A 9-layer net costs
// 3H + 7H^2 + H fused multiply-adds per point (the true 3-input first layer,
// the 1-column head): 7.3k at H=32, 28.9k at 64, 115k at 128, 460k at 256,
// 1.84M at 512, 7.34M at 1024.
// One thread evaluates one point, so every thread of a warp needs the same
// weight at the same time: weights are read at warp-uniform addresses, one
// broadcast per 4 fused multiply-adds.
//
// Design, by width:
//   * H = 32, 64: the whole padded stack [L, H, H] + [L, H] is staged into
//     shared memory once per block (37 KB at L=9, H=32; 150 KB at 64: one
//     block per SM, so 256 threads per block at 64); activations x[H] and
//     y[H] live in registers (mlp_sdf).
//   * H = 128 to 1024: the stack (590 KB / 2.36 MB / 9.4 MB / 37.7 MB at
//     L=9) does not fit in shared memory; it is read through the read-only
//     path (__ldg) and lives in the 50 MB L2. Each layer is computed in
//     chunks of 32 outputs, accumulated in registers; the two activation
//     buffers [2, H] live in the thread's local memory (mlp_sdf_wide: a
//     1 / 2 / 4 / 8 KB frame per thread, which CUDA reserves for every
//     resident thread, 2.2 GB at 1024). Nothing synchronises the block after
//     the weights are staged, so each ray still exits on its own. 1024 is
//     the widest: the JAX package's kernels hold the whole stack in VMEM,
//     and a wider 9-layer stack exceeds this card's L2 too.
// Each output sums its products in input order from zero and adds the bias
// last, at every width: output chunks keep that order, and the input
// dimension is never split. The first layer contracts only the true 3 or 4
// inputs (the frame is the 4th), and the head computes only column 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"

namespace cnr {

// Threads per block at a hidden width.
__host__ __device__ constexpr int block_for(int h) { return h == 64 ? 256 : 128; }

// Whether the weight stack is staged in shared memory at a hidden width.
__host__ __device__ constexpr bool smem_weights(int h) { return h <= 64; }

// Dynamic shared memory of one block: the stack and its biases, or nothing.
// The three-pass chain's two bfloat16 halves take what the FP32 stack takes.
inline size_t smem_bytes(int h, int n_layers) {
  return smem_weights(h) ? sizeof(float) * static_cast<size_t>(n_layers) * h * (h + 1) : 0;
}

// Output chunk of the wide chain (accumulators held in registers).
constexpr int kChunk = 32;

// Make a kernel's shared-memory needs explicit before its launch: above
// 48 KB the kernel must opt in, and a stack too large for the card fails
// here, with the error the launch would have given.
template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, int h, size_t smem) {
  if (!smem_weights(h))  // all on-chip memory to L1, which caches the stack
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxL1);
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

// Activations in registers, weights from shared memory (H = 32, 64). Each
// layer sums its products in input order, starting from zero, and adds the
// bias last: the order of a plain GEMM followed by a bias add, so the
// kernel's SDF values match its plain version's on both CPU and cuBLAS.
template <int H>
__device__ __forceinline__ float mlp_sdf(const float* __restrict__ sw,
                                         const float* __restrict__ sb,
                                         int n_layers, int n_inputs,
                                         float px, float py, float pz,
                                         float frame) {
  const float in[4] = {px, py, pz, frame};
  if (n_layers == 1) {  // the head is the first layer
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) d = fmaf(in[i], sw[i * H], d);
    return __fadd_rn(d, sb[0]);
  }
  float x[H];
#pragma unroll
  for (int o = 0; o < H; ++o) x[o] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < n_inputs) {
#pragma unroll
      for (int o = 0; o < H; ++o) x[o] = fmaf(in[i], sw[i * H + o], x[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < H; ++o) x[o] = fmaxf(__fadd_rn(x[o], sb[o]), 0.f);

  for (int l = 1; l < n_layers - 1; ++l) {
    const float* w = sw + l * H * H;
    const float* b = sb + l * H;
    float y[H];
#pragma unroll
    for (int o = 0; o < H; ++o) y[o] = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float xi = x[i];
#pragma unroll
      for (int o = 0; o < H; o += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(w + i * H + o);
        y[o] = fmaf(xi, wv.x, y[o]);
        y[o + 1] = fmaf(xi, wv.y, y[o + 1]);
        y[o + 2] = fmaf(xi, wv.z, y[o + 2]);
        y[o + 3] = fmaf(xi, wv.w, y[o + 3]);
      }
    }
#pragma unroll
    for (int o = 0; o < H; ++o) x[o] = fmaxf(__fadd_rn(y[o], b[o]), 0.f);
  }

  const float* w = sw + (n_layers - 1) * H * H;
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < H; ++i) d = fmaf(x[i], w[i * H], d);
  return __fadd_rn(d, sb[(n_layers - 1) * H]);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[o] += xi * w[o] for the chunk's 32 outputs, in that order.
__device__ __forceinline__ void fma_chunk(float (&acc)[kChunk], float xi,
                                          const float* __restrict__ w) {
#pragma unroll
  for (int o = 0; o < kChunk; o += 4) {
    const float4 wv = ldg4(w + o);
    acc[o] = fmaf(xi, wv.x, acc[o]);
    acc[o + 1] = fmaf(xi, wv.y, acc[o + 1]);
    acc[o + 2] = fmaf(xi, wv.z, acc[o + 2]);
    acc[o + 3] = fmaf(xi, wv.w, acc[o + 3]);
  }
}

// Activations in local memory, weights from L2 (H = 128 to 1024); the same
// arithmetic, in the same order, as mlp_sdf.
template <int H>
__device__ __forceinline__ float mlp_sdf_wide(const float* __restrict__ w,
                                              const float* __restrict__ b,
                                              int n_layers, int n_inputs,
                                              float px, float py, float pz,
                                              float frame) {
  static_assert(H % kChunk == 0, "the width must be a multiple of the chunk");
  const float in[4] = {px, py, pz, frame};
  if (n_layers == 1) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) d = fmaf(in[i], __ldg(w + i * H), d);
    return __fadd_rn(d, __ldg(b));
  }
  float act[2 * H];  // layer input at [cur, cur + H), output at the other half
  int cur = 0;
#pragma unroll 1
  for (int c = 0; c < H; c += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int o = 0; o < kChunk; ++o) acc[o] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) fma_chunk(acc, in[i], w + i * H + c);
#pragma unroll
    for (int o = 0; o < kChunk; ++o)
      act[c + o] = fmaxf(__fadd_rn(acc[o], __ldg(b + c + o)), 0.f);
  }

#pragma unroll 1
  for (int l = 1; l < n_layers - 1; ++l) {
    const float* wl = w + l * H * H;
    const float* bl = b + l * H;
    const int nxt = H - cur;
#pragma unroll 1
    for (int c = 0; c < H; c += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int o = 0; o < kChunk; ++o) acc[o] = 0.f;
#pragma unroll 4
      for (int i = 0; i < H; ++i) fma_chunk(acc, act[cur + i], wl + i * H + c);
#pragma unroll
      for (int o = 0; o < kChunk; ++o)
        act[nxt + c + o] = fmaxf(__fadd_rn(acc[o], __ldg(bl + c + o)), 0.f);
    }
    cur = nxt;
  }

  const float* wl = w + (n_layers - 1) * H * H;
  float d = 0.f;
#pragma unroll 4
  for (int i = 0; i < H; ++i) d = fmaf(act[cur + i], __ldg(wl + i * H), d);
  return __fadd_rn(d, __ldg(b + (n_layers - 1) * H));
}

// mlp_sdf on the stack staged at the start of shared memory, as a function
// of its own. At H = 64 the unrolled chain is 4096 fused multiply-adds per
// layer: called rather than inlined, each translation unit compiles it once
// instead of once per scene (the inlined build took minutes). It reads the
// stack through the shared-memory array itself, so its loads stay LDS.
template <int H>
__device__ __noinline__ float mlp_sdf_called(int n_layers, int n_inputs, float px,
                                             float py, float pz, float frame) {
  extern __shared__ float4 smem4[];
  const float* sw = reinterpret_cast<const float*>(smem4);
  return mlp_sdf<H>(sw, sw + n_layers * H * H, n_layers, n_inputs, px, py, pz, frame);
}

// The chain's raw head value at one point; w and b are where
// stage_weights<H> put the stack.
template <int H>
__device__ __forceinline__ float chain_sdf(const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int n_layers, int n_inputs,
                                           float px, float py, float pz,
                                           float frame) {
  if constexpr (H == 32)
    return mlp_sdf<H>(w, b, n_layers, n_inputs, px, py, pz, frame);
  else if constexpr (smem_weights(H))
    return mlp_sdf_called<H>(n_layers, n_inputs, px, py, pz, frame);
  else
    return mlp_sdf_wide<H>(w, b, n_layers, n_inputs, px, py, pz, frame);
}

// Where a block reads the stack from: shared memory, after every thread of
// the block has helped copy it in, or device memory as it is. Call before
// any thread leaves the kernel.
template <int H>
__device__ __forceinline__ void stage_weights(const float* __restrict__ weights,
                                              const float* __restrict__ biases,
                                              int n_layers, const float*& w,
                                              const float*& b) {
  if constexpr (smem_weights(H)) {
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
  } else {
    w = weights;
    b = biases;
  }
}

// K3: the chain's head value at each of n points x [n, n_inputs].
template <int H>
__global__ void __launch_bounds__(block_for(H))
mlp_forward_kernel(const float* __restrict__ x, const float* __restrict__ weights,
                   const float* __restrict__ biases, int n_layers, int n_inputs, int n,
                   float* __restrict__ out) {
  const float* w;
  const float* b;
  stage_weights<H>(weights, biases, n_layers, w, b);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float in[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n_inputs) in[i] = x[static_cast<int64_t>(r) * n_inputs + i];
  out[r] = chain_sdf<H>(w, b, n_layers, n_inputs, in[0], in[1], in[2], in[3]);
}

template <int H>
int launch_mlp_forward(const MlpArgs& a, cudaStream_t stream) {
  if (a.n_layers < 1 || a.n_inputs < 1 || a.n_inputs > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n <= 0) return 0;
  const size_t smem = smem_bytes(H, a.n_layers);
  cudaError_t err = prepare_launch(mlp_forward_kernel<H>, H, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.n + block_for(H) - 1) / block_for(H);
  mlp_forward_kernel<H><<<grid, block_for(H), smem, stream>>>(
      a.x, a.weights, a.biases, a.n_layers, a.n_inputs, a.n, a.out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2h: the three-pass chain.
//
// Per layer, with the activations split like the weights (x_hi = bf16(x),
// x_lo = bf16(x - x_hi), round to nearest even), each output is
//   ((sum_i x_hi[i] w_hi[i][o] + sum_i x_lo[i] w_hi[i][o])
//                              + sum_i x_hi[i] w_lo[i][o]) + b[o],
// each of the three sums taken from zero in input order, in that order, the
// bias last: the plain version's three float32 products and adds
// (kernels/fused_mlp.py mlp_chain_3pass_plain), whose order the kernel keeps
// so that the two agree bit for bit. A product of two bfloat16 values is
// exact in float32, so each fused multiply-add rounds only the sum. The three
// sums are never fused into one accumulator: that would round differently.
//
// What bounds it: arithmetic, 3x the FP32 chain's fused multiply-adds (the
// weights are widened from bfloat16 by a shift, the activations split per
// layer). Design, by width:
//   * H = 32: x, the sum y and one temporary t, 32 each, in registers;
//     three passes over the inputs per layer; the stack (the two bfloat16
//     halves, as many bytes as the FP32 stack) in shared memory;
//   * H = 64: the stack in shared memory, the activations [2, H] in local
//     memory, each layer in chunks of 32 outputs (y and t in registers);
//   * H = 128 to 1024: the same chunks, the stack read from L2 with __ldg
//     (the two bfloat16 halves take the FP32 stack's 37.7 MB at 1024).
// The first layer contracts the true 3 or 4 inputs (the frame is split too);
// the head computes column 0 only.

// A bfloat16 value is the top half of the float32 with the same bits.
__device__ __forceinline__ float bf16_low(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_high(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The split of an activation: bf16(x) and bf16(x - bf16(x)), as floats.
__device__ __forceinline__ float split_hi(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float split_lo(float x) {
  return __bfloat162float(__float2bfloat16_rn(__fsub_rn(x, split_hi(x))));
}

// Loads from the stack: shared memory, or device memory through the
// read-only path.
template <bool kShared>
__device__ __forceinline__ uint4 load_bf16x8(const uint16_t* p) {
  if constexpr (kShared)
    return *reinterpret_cast<const uint4*>(p);
  else
    return __ldg(reinterpret_cast<const uint4*>(p));
}
template <bool kShared>
__device__ __forceinline__ float load_bf16(const uint16_t* p) {
  if constexpr (kShared)
    return bf16_low(*p);
  else
    return bf16_low(__ldg(p));
}
template <bool kShared>
__device__ __forceinline__ float load_f32(const float* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldg(p);
}

// acc[o] += xi * w[o] for N consecutive bfloat16 weights, in order.
template <int N, bool kShared>
__device__ __forceinline__ void fma_row_bf16(float (&acc)[N], float xi,
                                             const uint16_t* __restrict__ w) {
#pragma unroll
  for (int o = 0; o < N; o += 8) {
    const uint4 v = load_bf16x8<kShared>(w + o);
    acc[o] = fmaf(xi, bf16_low(v.x), acc[o]);
    acc[o + 1] = fmaf(xi, bf16_high(v.x), acc[o + 1]);
    acc[o + 2] = fmaf(xi, bf16_low(v.y), acc[o + 2]);
    acc[o + 3] = fmaf(xi, bf16_high(v.y), acc[o + 3]);
    acc[o + 4] = fmaf(xi, bf16_low(v.z), acc[o + 4]);
    acc[o + 5] = fmaf(xi, bf16_high(v.z), acc[o + 5]);
    acc[o + 6] = fmaf(xi, bf16_low(v.w), acc[o + 6]);
    acc[o + 7] = fmaf(xi, bf16_high(v.w), acc[o + 7]);
  }
}

// One three-pass layer at H = 32 with everything in registers: out = the
// layer's pre-activation sums of x[0..n) (without the bias). x may be out.
template <int H, int NX>
__device__ __forceinline__ void layer_3pass_regs(const float (&x)[NX], int n,
                                                 const uint16_t* __restrict__ whi,
                                                 const uint16_t* __restrict__ wlo,
                                                 float (&out)[H]) {
  float y[H], t[H];
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = t[o] = 0.f;
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (i < n) fma_row_bf16<H, true>(y, split_hi(x[i]), whi + i * H);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (i < n) fma_row_bf16<H, true>(t, split_lo(x[i]), whi + i * H);
#pragma unroll
  for (int o = 0; o < H; ++o) {
    y[o] = __fadd_rn(y[o], t[o]);
    t[o] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (i < n) fma_row_bf16<H, true>(t, split_hi(x[i]), wlo + i * H);
#pragma unroll
  for (int o = 0; o < H; ++o) out[o] = __fadd_rn(y[o], t[o]);
}

// The head of the three-pass chain: column 0 of the last layer over x[0..n).
template <int NX, bool kShared>
__device__ __forceinline__ float head_3pass(const float (&x)[NX], int n,
                                            const uint16_t* __restrict__ whi,
                                            const uint16_t* __restrict__ wlo, int stride,
                                            float bias) {
  float d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    if (i < n) {
      const float hi = split_hi(x[i]);
      d1 = fmaf(hi, load_bf16<kShared>(whi + i * stride), d1);
      d2 = fmaf(split_lo(x[i]), load_bf16<kShared>(whi + i * stride), d2);
      d3 = fmaf(hi, load_bf16<kShared>(wlo + i * stride), d3);
    }
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(d1, d2), d3), bias);
}

// The three-pass chain at H = 32: activations in registers, the stack in
// shared memory.
template <int H>
__device__ __forceinline__ float mlp_sdf_3pass_regs(const uint16_t* __restrict__ whi,
                                                    const uint16_t* __restrict__ wlo,
                                                    const float* __restrict__ b,
                                                    int n_layers, int n_inputs, float px,
                                                    float py, float pz, float frame) {
  const float in[4] = {px, py, pz, frame};
  if (n_layers == 1) return head_3pass<4, true>(in, n_inputs, whi, wlo, H, b[0]);
  float x[H];
  layer_3pass_regs<H, 4>(in, n_inputs, whi, wlo, x);
#pragma unroll
  for (int o = 0; o < H; ++o) x[o] = fmaxf(__fadd_rn(x[o], b[o]), 0.f);
  for (int l = 1; l < n_layers - 1; ++l) {
    layer_3pass_regs<H, H>(x, H, whi + l * H * H, wlo + l * H * H, x);
#pragma unroll
    for (int o = 0; o < H; ++o) x[o] = fmaxf(__fadd_rn(x[o], b[l * H + o]), 0.f);
  }
  const int l = n_layers - 1;
  return head_3pass<H, true>(x, H, whi + l * H * H, wlo + l * H * H, H, b[l * H]);
}

// The three-pass chain at H >= 64: activations [2, H] in local memory (the
// inputs in the first 4 entries), each layer in chunks of kChunk outputs.
template <int H, bool kShared>
__device__ __forceinline__ float mlp_sdf_3pass_chunked(const uint16_t* __restrict__ whi,
                                                       const uint16_t* __restrict__ wlo,
                                                       const float* __restrict__ b,
                                                       int n_layers, int n_inputs, float px,
                                                       float py, float pz, float frame) {
  static_assert(H % kChunk == 0 && H >= 4, "the width must be a multiple of the chunk");
  float act[2 * H];  // layer input at [cur, cur + n), output at the other half
  act[0] = px;
  act[1] = py;
  act[2] = pz;
  act[3] = frame;
  int cur = 0, n = n_inputs;
#pragma unroll 1
  for (int l = 0; l < n_layers - 1; ++l) {
    const uint16_t* wh = whi + l * H * H;
    const uint16_t* wl = wlo + l * H * H;
    const float* bl = b + l * H;
    const int nxt = H - cur;
#pragma unroll 1
    for (int c = 0; c < H; c += kChunk) {
      float y[kChunk], t[kChunk];
#pragma unroll
      for (int o = 0; o < kChunk; ++o) y[o] = t[o] = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        fma_row_bf16<kChunk, kShared>(y, split_hi(act[cur + i]), wh + i * H + c);
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        fma_row_bf16<kChunk, kShared>(t, split_lo(act[cur + i]), wh + i * H + c);
#pragma unroll
      for (int o = 0; o < kChunk; ++o) {
        y[o] = __fadd_rn(y[o], t[o]);
        t[o] = 0.f;
      }
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        fma_row_bf16<kChunk, kShared>(t, split_hi(act[cur + i]), wl + i * H + c);
#pragma unroll
      for (int o = 0; o < kChunk; ++o)
        act[nxt + c + o] =
            fmaxf(__fadd_rn(__fadd_rn(y[o], t[o]), load_f32<kShared>(bl + c + o)), 0.f);
    }
    cur = nxt;
    n = H;
  }
  const int l = n_layers - 1;
  const uint16_t* wh = whi + l * H * H;
  const uint16_t* wl = wlo + l * H * H;
  float d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float x = act[cur + i];
    const float hi = split_hi(x);
    d1 = fmaf(hi, load_bf16<kShared>(wh + i * H), d1);
    d2 = fmaf(split_lo(x), load_bf16<kShared>(wh + i * H), d2);
    d3 = fmaf(hi, load_bf16<kShared>(wl + i * H), d3);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(d1, d2), d3), load_f32<kShared>(b + l * H));
}

// The three-pass chain on the stack staged in shared memory (H = 32, 64), as
// a function of its own: called rather than inlined, each translation unit
// compiles it once instead of once per scene. It reads the stack through the
// shared-memory array itself, so its loads stay LDS.
template <int H>
__device__ __noinline__ float mlp_sdf_3pass_called(int n_layers, int n_inputs, float px,
                                                   float py, float pz, float frame) {
  extern __shared__ float4 smem4[];
  const uint16_t* whi = reinterpret_cast<const uint16_t*>(smem4);
  const uint16_t* wlo = whi + n_layers * H * H;
  const float* b = reinterpret_cast<const float*>(wlo + n_layers * H * H);
  if constexpr (H == 32)
    return mlp_sdf_3pass_regs<H>(whi, wlo, b, n_layers, n_inputs, px, py, pz, frame);
  else
    return mlp_sdf_3pass_chunked<H, true>(whi, wlo, b, n_layers, n_inputs, px, py, pz, frame);
}

// The three-pass chain's raw head value at one point; whi, wlo and b are
// where stage_weights_3pass<H> put the stack.
template <int H>
__device__ __forceinline__ float chain_sdf_3pass(const uint16_t* __restrict__ whi,
                                                 const uint16_t* __restrict__ wlo,
                                                 const float* __restrict__ b,
                                                 int n_layers, int n_inputs, float px,
                                                 float py, float pz, float frame) {
  if constexpr (smem_weights(H))
    return mlp_sdf_3pass_called<H>(n_layers, n_inputs, px, py, pz, frame);
  else
    return mlp_sdf_3pass_chunked<H, false>(whi, wlo, b, n_layers, n_inputs, px, py, pz, frame);
}

// stage_weights for the three-pass chain: the hi half, the lo half, then
// the biases, in shared memory at H = 32, 64 (smem_bytes in all).
template <int H>
__device__ __forceinline__ void stage_weights_3pass(const uint16_t* __restrict__ w_hi,
                                                    const uint16_t* __restrict__ w_lo,
                                                    const float* __restrict__ biases,
                                                    int n_layers, const uint16_t*& whi,
                                                    const uint16_t*& wlo, const float*& b) {
  if constexpr (smem_weights(H)) {
    extern __shared__ float4 smem4[];
    uint4* s4 = reinterpret_cast<uint4*>(smem4);
    const int n_w8 = n_layers * H * H / 8;  // eight bfloat16 values per uint4
    for (int k = threadIdx.x; k < n_w8; k += blockDim.x) {
      s4[k] = reinterpret_cast<const uint4*>(w_hi)[k];
      s4[n_w8 + k] = reinterpret_cast<const uint4*>(w_lo)[k];
    }
    float* sb = reinterpret_cast<float*>(s4 + 2 * n_w8);
    for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) sb[k] = biases[k];
    __syncthreads();
    whi = reinterpret_cast<const uint16_t*>(s4);
    wlo = whi + n_layers * H * H;
    b = sb;
  } else {
    whi = w_hi;
    wlo = w_lo;
    b = biases;
  }
}

}  // namespace cnr
