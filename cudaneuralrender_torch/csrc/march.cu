// Sphere-trace march kernel: the whole march of each ray in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// cudaneuralrender_tpu/pallas/megakernel.py::_march_megakernel (launched by
// march_pallas_state), together with the layer chain it inlines
// (pallas/fused_mlp.py::_mlp_chain) and the neural_raw branch of the scene
// compose (pallas/scenes.py::compose_fn).
//
// What bounds it on this card: arithmetic. A step of a 9-layer, 32-wide
// net is about 9.2k fused multiply-adds per ray (7.3k with the true 3-input
// first layer and the 1-column head this kernel computes), while it reads
// nothing from device memory per step: the weights come from shared memory
// and the ray state lives in registers. Device memory is touched once per
// ray on entry (direction, t, budget, flags) and once on exit.
//
// Design:
//   * one thread per ray, 128 threads per block;
//   * the padded weight stack [L, H, H] and biases [L, H] are staged into
//     shared memory once per block (36 KB + 1.1 KB at L=9, H=32); every
//     thread of a warp reads the same weight at the same time, a broadcast;
//   * activations live in registers, with H a template parameter (32);
//   * the first layer contracts over the true 3 or 4 inputs (the frame is
//     the 4th), and the head computes only output column 0;
//   * each ray loops until it resolves (per-ray exit; the TPU kernel exits
//     per 8192-lane tile, with identical per-ray results);
//   * all arithmetic is FP32 FFMA, for both of the JAX package's
//     precisions (DEFAULT and HIGHEST).
//
// Per-lane semantics follow the TPU kernel exactly: singleMarch's update
// order (budget charge, miss, move, converge), the constant over-relaxation
// with backtrack (prev_r / step_len, plain step while step_len < 0), and the
// resolve step: lanes that resolve report step + 1, lanes still active at
// exit report the exit step, lanes inactive at entry report the entry step.
// The point o + d*t is one fused multiply-add (XLA contracts it the same
// way); the rest of the bookkeeping uses explicit round-to-nearest
// intrinsics so that nothing else is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kHidden = 32;

// Each layer sums its products in input order, starting from zero, and adds
// the bias last: the order of a plain GEMM followed by a bias add, so the
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

template <int H>
__global__ void __launch_bounds__(kBlock)
march_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
             const float* __restrict__ t0, const float* __restrict__ budget0,
             const uint8_t* __restrict__ active0,
             const int32_t* __restrict__ steps0,
             const float* __restrict__ weights,
             const float* __restrict__ biases, int n_layers, int n_inputs,
             float frame, int n, int max_steps, int num_steps, float eps,
             float omega, float* __restrict__ t_out,
             float* __restrict__ budget_out, uint8_t* __restrict__ active_out,
             uint8_t* __restrict__ conv_out, int32_t* __restrict__ steps_out) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sb = sw + n_layers * H * H;
  const int n_w4 = n_layers * H * H / 4;
  for (int k = threadIdx.x; k < n_w4; k += blockDim.x)
    smem4[k] = reinterpret_cast<const float4*>(weights)[k];
  for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x)
    sb[k] = biases[k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  float t = t0[r];
  float budget = budget0[r];
  bool act = active0[r] != 0;
  bool conv = false;
  const int start = *steps0;
  int step = start;
  int res = start;
  const bool relax = omega > 1.f;
  float prev_r = 0.f, step_len = 0.f;

  while (act && step < max_steps && (num_steps < 0 || step - start < num_steps)) {
    const float px = __fmaf_rn(dx, t, ox);
    const float py = __fmaf_rn(dy, t, oy);
    const float pz = __fmaf_rn(dz, t, oz);
    const float d = mlp_sdf<H>(sw, sb, n_layers, n_inputs, px, py, pz, frame);

    bool sor_fail = false;
    bool near;
    float stepv;
    if (relax) {
      sor_fail = (step_len > prev_r) && (__fadd_rn(d, prev_r) < step_len);
      near = !sor_fail && (d < eps);
      const float om = step_len < 0.f ? 1.f : omega;
      stepv = sor_fail ? __fsub_rn(prev_r, step_len)
                       : (near ? d : __fmul_rn(om, d));
    } else {
      near = d < eps;
      stepv = d;
    }
    budget = __fsub_rn(budget, stepv);
    const bool moved = sor_fail || !(budget <= 0.f);  // miss: budget <= 0
    if (moved) t = __fadd_rn(t, stepv);
    const bool conv_now = moved && near;
    conv = conv || conv_now;
    if (relax) {
      if (moved && !sor_fail) prev_r = d;
      if (moved) step_len = stepv;
    }
    ++step;
    act = moved && !conv_now;
    if (!act) res = step;
  }

  t_out[r] = t;
  budget_out[r] = budget;
  active_out[r] = act ? 1 : 0;
  conv_out[r] = conv ? 1 : 0;
  steps_out[r] = act ? step : res;
}

}  // namespace

extern "C" int cnr_march(int device, const float* dirs, const float* origin,
                         const float* t0, const float* budget0,
                         const uint8_t* active0, const int32_t* steps0,
                         const float* weights, const float* biases,
                         int n_layers, int hidden, int n_inputs, float frame,
                         int n, int max_steps, int num_steps, float eps,
                         float omega, float* t_out, float* budget_out,
                         uint8_t* active_out, uint8_t* conv_out,
                         int32_t* steps_out, void* stream) {
  if (hidden != kHidden || n_layers < 1 || n_inputs < 1 || n_inputs > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * static_cast<size_t>(n_layers) * kHidden *
                      (kHidden + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(march_kernel<kHidden>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  march_kernel<kHidden><<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      dirs, origin, t0, budget0, active0, steps0, weights, biases, n_layers,
      n_inputs, frame, n, max_steps, num_steps, eps, omega, t_out, budget_out,
      active_out, conv_out, steps_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cnr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
