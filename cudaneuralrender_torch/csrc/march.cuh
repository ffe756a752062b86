// Sphere-trace march kernel: the whole march of each ray in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// cudaneuralrender_tpu/pallas/megakernel.py::_march_megakernel (launched by
// march_pallas_state), together with the layer chain it inlines
// (pallas/fused_mlp.py::_mlp_chain, here csrc/chain.cuh) and the scene
// compose (pallas/scenes.py::compose_fn: neural_raw, neural_tanh,
// many_sphere, many_sphere_cut, many_cylinder_cut through a 1/3/5 grid
// window, and displacement).
//
// What bounds it on this card: arithmetic. A step of a 9-layer net is
// 3H + 7H^2 + H fused multiply-adds per ray (7.3k at H=32: the true 3-input
// first layer and the 1-column head), while the ray state lives in
// registers; at H = 32 and 64 the weights come from shared memory, at 128
// and 256 from L2 (chain.cuh). Device memory is touched once per ray on
// entry (direction, t, budget, flags) and once on exit.
//
// Design:
//   * one thread per ray, block_for(H) threads per block (chain.cuh);
//   * the chain at the padded width H, a template parameter (32, 64, 128 or
//     256; one instantiation of every scene per width, in
//     csrc/hidden{H}.cu); see chain.cuh for where weights and activations
//     live at each width;
//   * the scene compose runs right after the chain, each step, where the
//     reference's sceneSDF runs inside its march kernel. The scene and the
//     cylinder window are template parameters, one instantiation per
//     (scene, window): the compose is straight-line code with no branch on
//     the scene, and the neural_raw instantiation is the bare chain;
//   * each ray loops until it resolves (per-ray exit; the TPU kernel exits
//     per 8192-lane tile, with identical per-ray results);
//   * all arithmetic is FP32 FFMA, for both of the JAX package's
//     precisions (DEFAULT and HIGHEST).
//
// The compose's cost: it is FP32 elementwise work on the ray's own
// registers, about 100 (many_sphere: 9 sphere distances and smooth
// unions) to 400 (many_cylinder_cut, window 5: 25 cylinders and smooth
// subtractions) operations per step plus a few sqrtf / sinf / tanhf, next
// to the ~7.3k FMAs of the layer chain. It should change the cost of a
// step by a few percent; frame times per scene differ mostly through their
// step counts.
//
// Per-lane semantics follow the TPU kernel exactly: singleMarch's update
// order (budget charge, miss, move, converge), the constant over-relaxation
// with backtrack (prev_r / step_len, plain step while step_len < 0), and the
// resolve step: lanes that resolve report step + 1, lanes still active at
// exit report the exit step, lanes inactive at entry report the entry step.
// The point o + d*t is one fused multiply-add (XLA contracts it the same
// way); the rest of the bookkeeping and the whole compose use explicit
// round-to-nearest intrinsics so that nothing else is contracted: the
// compose's plain version (kernels/scenes.py) runs each product and sum as
// its own PyTorch operator, which never fuses a multiply-add. A division
// by a constant is a multiplication by the constant's float32 reciprocal
// in both versions (XLA folds it so, and PyTorch's CUDA division by a
// scalar does too). sqrtf, sinf and tanhf are CUDA's own (no fast-math
// flags), the functions PyTorch's CUDA operators call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "launch.h"

namespace cnr {

// Scene ids: kernels/scenes.py SCENE_IDS.
enum Scene : int {
  kNeuralRaw = 0,
  kNeuralTanh = 1,
  kManySphere = 2,
  kManySphereCut = 3,
  kManyCylinderCut = 4,
  kDisplacement = 5,
};

// Smooth-operator blend width k and its float32 reciprocal (1 / 0.01f).
constexpr float kSmoothK = 0.01f;
constexpr float kInvSmoothK = 100.0f;
// Drill-hole grid spacing's float32 reciprocal (1 / 0.1f).
constexpr float kInvCell = 10.0f;
// many_sphere's z step per frame, 2*0.7/360 rounded to float32.
constexpr float kSphereZStep = static_cast<float>(2.0 * 0.7 / 360.0);

__device__ __forceinline__ float clamp01(float h) {
  // clamp to [0, 1] keeping NaN, as torch.clamp and jnp.clip do
  h = h < 0.f ? 0.f : h;
  return h > 1.f ? 1.f : h;
}

// d2*(1-h) + d1*h - k*h*(1-h), h = clip(0.5 + 0.5*(d2-d1)/k, 0, 1)
__device__ __forceinline__ float smooth_union(float d1, float d2) {
  const float h = clamp01(__fadd_rn(
      0.5f, __fmul_rn(__fmul_rn(0.5f, __fsub_rn(d2, d1)), kInvSmoothK)));
  const float g = __fsub_rn(1.f, h);
  return __fsub_rn(__fadd_rn(__fmul_rn(d2, g), __fmul_rn(d1, h)),
                   __fmul_rn(__fmul_rn(kSmoothK, h), g));
}

// d1*(1-h) - d2*h + k*h*(1-h), h = clip(0.5 - 0.5*(d1+d2)/k, 0, 1)
__device__ __forceinline__ float smooth_subtract(float d1, float d2) {
  const float h = clamp01(__fsub_rn(
      0.5f, __fmul_rn(__fmul_rn(0.5f, __fadd_rn(d1, d2)), kInvSmoothK)));
  const float g = __fsub_rn(1.f, h);
  return __fadd_rn(__fsub_rn(__fmul_rn(d1, g), __fmul_rn(d2, h)),
                   __fmul_rn(__fmul_rn(kSmoothK, h), g));
}

// pallas/scenes.py::_many_sphere: nine radius-0.1 spheres on a 3 x 3 grid
// (world centers ops/sdf.py::_MANY_SPHERE_CENTERS), animated in z by the
// frame, smooth-unioned (or subtracted) in the reference's order.
template <bool kUnion>
__device__ __forceinline__ float many_sphere(float px, float py, float pz,
                                             float d, float frame) {
  const float cx[3] = {-0.5f, -0.1f, 0.3f};
  const float cy[3] = {0.2f, -0.2f, -0.6f};
  const float dz = __fadd_rn(pz, __fadd_rn(-0.7f, __fmul_rn(frame, kSphereZStep)));
  const float dz2 = __fmul_rn(dz, dz);
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float dy = __fsub_rn(py, cy[row]);
    const float dy2 = __fmul_rn(dy, dy);
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      const float dx = __fsub_rn(px, cx[col]);
      const float sd = __fsub_rn(
          __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), dy2), dz2)), 0.1f);
      d = kUnion ? smooth_union(d, sd) : smooth_subtract(d, sd);
    }
  }
  return d;
}

// pallas/scenes.py::_many_cylinder_cut: the W x W cells of the 20 x 15
// drill-hole grid around the point's nearest cell, in (row, col) order.
template <int W>
__device__ __forceinline__ float many_cylinder_cut(float px, float py, float d) {
  const float c0 = floorf(__fadd_rn(__fmul_rn(__fadd_rn(px, 0.88f), kInvCell), 0.5f));
  const float r0 = floorf(__fadd_rn(__fmul_rn(__fsub_rn(0.42f, py), kInvCell), 0.5f));
#pragma unroll
  for (int dr = -W / 2; dr <= W / 2; ++dr) {
    const float r = __fadd_rn(r0, static_cast<float>(dr));
    const float dy = __fsub_rn(__fadd_rn(py, __fadd_rn(-0.4f, __fmul_rn(0.1f, r))), 0.02f);
    const float dy2 = __fmul_rn(dy, dy);
    const bool row_ok = r >= 0.f && r <= 14.f;
#pragma unroll
    for (int dc = -W / 2; dc <= W / 2; ++dc) {
      const float c = __fadd_rn(c0, static_cast<float>(dc));
      const float dx = __fsub_rn(__fadd_rn(px, __fsub_rn(0.9f, __fmul_rn(0.1f, c))), 0.02f);
      const float cyl = __fsub_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), dy2)), 0.02f);
      const bool valid = row_ok && c >= 0.f && c <= 19.f;
      d = smooth_subtract(d, valid ? cyl : 1e9f);
    }
  }
  return d;
}

// The scene's distance from the chain's raw logit d at point p.
template <int S, int W>
__device__ __forceinline__ float compose(float px, float py, float pz, float d,
                                         float frame) {
  if constexpr (S == kNeuralRaw) {
    return d;
  } else if constexpr (S == kNeuralTanh) {
    return tanhf(d);
  } else if constexpr (S == kManySphere || S == kManySphereCut) {
    return many_sphere<S == kManySphere>(px, py, pz, d, frame);
  } else if constexpr (S == kManyCylinderCut) {
    return many_cylinder_cut<W>(px, py, d);
  } else {  // kDisplacement: sin(5x) sin(5y) sin(5z) * 0.05 over tanh(d)
    const float s = __fmul_rn(__fmul_rn(sinf(__fmul_rn(5.f, px)), sinf(__fmul_rn(5.f, py))),
                              sinf(__fmul_rn(5.f, pz)));
    return __fadd_rn(tanhf(d), __fmul_rn(s, 0.05f));
  }
}

template <int H, int S, int W>
__global__ void __launch_bounds__(block_for(H))
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
  const float* sw;
  const float* sb;
  stage_weights<H>(weights, biases, n_layers, sw, sb);

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
    const float d = compose<S, W>(
        px, py, pz, chain_sdf<H>(sw, sb, n_layers, n_inputs, px, py, pz, frame), frame);

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

using MarchKernel = void (*)(const float*, const float*, const float*, const float*,
                             const uint8_t*, const int32_t*, const float*, const float*,
                             int, int, float, int, int, int, float, float, float*, float*,
                             uint8_t*, uint8_t*, int32_t*);

// The instantiation for a width, scene id and cylinder window, or nullptr.
template <int H>
MarchKernel pick_kernel(int scene, int window) {
  if (window != 1 && window != 3 && window != 5) return nullptr;
  switch (scene) {
    case kNeuralRaw: return march_kernel<H, kNeuralRaw, 0>;
    case kNeuralTanh: return march_kernel<H, kNeuralTanh, 0>;
    case kManySphere: return march_kernel<H, kManySphere, 0>;
    case kManySphereCut: return march_kernel<H, kManySphereCut, 0>;
    case kManyCylinderCut:
      if (window == 1) return march_kernel<H, kManyCylinderCut, 1>;
      if (window == 3) return march_kernel<H, kManyCylinderCut, 3>;
      return march_kernel<H, kManyCylinderCut, 5>;
    case kDisplacement: return march_kernel<H, kDisplacement, 0>;
    default: return nullptr;
  }
}

template <int H>
int launch_march(const MarchArgs& a, cudaStream_t stream) {
  const MarchKernel kernel = pick_kernel<H>(a.scene, a.window);
  if (kernel == nullptr || a.n_layers < 1 || a.n_inputs < 1 || a.n_inputs > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n <= 0) return 0;
  const size_t smem = smem_bytes(H, a.n_layers);
  cudaError_t err = prepare_launch(kernel, H, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.n + block_for(H) - 1) / block_for(H);
  kernel<<<grid, block_for(H), smem, stream>>>(
      a.dirs, a.origin, a.t0, a.budget0, a.active0, a.steps0, a.weights, a.biases,
      a.n_layers, a.n_inputs, a.frame, a.n, a.max_steps, a.num_steps, a.eps, a.omega,
      a.t_out, a.budget_out, a.active_out, a.conv_out, a.steps_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cnr
