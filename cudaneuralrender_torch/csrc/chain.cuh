// The layer chain at every hidden width, and the fused forward kernel (K3).
//
// The chain replaces the JAX package's pallas/fused_mlp.py::_mlp_chain, which
// the Pallas kernels inline on zero-padded [H, T] activations; the forward
// kernel replaces pallas/fused_mlp.py::_fused_mlp_kernel (launched by
// mlp_forward_pallas, used by neural_sdf_fn_pallas for config.use_pallas).
//
// What bounds the chain on this card: arithmetic. A 9-layer net costs
// 3H + 7H^2 + H fused multiply-adds per point (the true 3-input first layer,
// the 1-column head): 7.3k at H=32, 28.9k at 64, 115k at 128, 460k at 256.
// One thread evaluates one point, so every thread of a warp needs the same
// weight at the same time: weights are read at warp-uniform addresses, one
// broadcast per 4 fused multiply-adds.
//
// Design, by width:
//   * H = 32, 64: the whole padded stack [L, H, H] + [L, H] is staged into
//     shared memory once per block (37 KB at L=9, H=32; 150 KB at 64: one
//     block per SM, so 256 threads per block at 64); activations x[H] and
//     y[H] live in registers (mlp_sdf).
//   * H = 128, 256: the stack (590 KB / 2.36 MB at L=9) does not fit in
//     shared memory; it is read through the read-only path (__ldg) and lives
//     in L2. Each layer is computed in chunks of 32 outputs, accumulated in
//     registers; the two activation buffers [2, H] live in the thread's
//     local memory (mlp_sdf_wide). Nothing synchronises the block after the
//     weights are staged, so each ray still exits on its own.
// Each output sums its products in input order from zero and adds the bias
// last, at every width: output chunks keep that order, and the input
// dimension is never split. The first layer contracts only the true 3 or 4
// inputs (the frame is the 4th), and the head computes only column 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"

namespace cnr {

// Threads per block at a hidden width.
__host__ __device__ constexpr int block_for(int h) { return h == 64 ? 256 : 128; }

// Whether the weight stack is staged in shared memory at a hidden width.
__host__ __device__ constexpr bool smem_weights(int h) { return h <= 64; }

// Dynamic shared memory of one block: the stack and its biases, or nothing.
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

// Activations in local memory, weights from L2 (H = 128, 256); the same
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

}  // namespace cnr
