// Sphere-trace march kernel: the whole march of each ray in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// cudaneuralrender_tpu/pallas/megakernel.py::_march_megakernel (launched by
// march_pallas_state, and by march_pallas_raygen for a cold start with the
// rays built in the kernel, K5), together with the layer chains it inlines
// (pallas/fused_mlp.py::_mlp_chain and, at precision HIGH, the three-pass
// _mlp_chain_3pass: csrc/chain.cuh) and the scene compose
// (pallas/scenes.py::compose_fn: neural_raw, neural_tanh, many_sphere,
// many_sphere_cut, many_cylinder_cut through a 1/3/5 grid window, and
// displacement).
//
// What bounds it on this card: arithmetic. A step of a 9-layer net is
// 3H + 7H^2 + H fused multiply-adds per ray (7.3k at H=32: the true 3-input
// first layer and the 1-column head), on the tensor cores at every width
// (3xTF32, three tf32 products per weight), while the ray state lives in
// registers; at H = 32 and 64 the weights come from shared memory, at 128
// to 1024 from L2 (chain.cuh). Device memory is touched once per ray on
// entry (direction, t, budget, flags) and once on exit.
//
// Design:
//   * one thread per ray, march_block(H) threads per block (chain.cuh), a
//     warp's 32 rays the rows of one product on the tensor cores (at 128 a
//     block's group of rays, csrc/hidden128_group.cuh); or, for
//     the FP32 chain at H = 32 and 64 on a launch of few rays, one warp per
//     ray on FFMA (march_split_kernel below), and at 128 a warp per ray in
//     each CTA of a 4-CTA cluster that holds the stack
//     (csrc/hidden128_split.cu);
//   * the chain at the padded width H, a template parameter (32, 64, 128,
//     256, 512 or 1024; one instantiation of every scene per width, in
//     csrc/hidden{H}.cu); see chain.cuh for where weights and activations
//     live at each width;
//   * the chain's arithmetic, a template parameter: FP32 for both of the
//     JAX package's precisions DEFAULT and HIGHEST (3xTF32), or the
//     three-pass bfloat16 chain for HIGH (kThreePass; its instantiations in
//     csrc/hidden{H}_3pass.cu, compiled in parallel with the others);
//   * the cold start (K5) is a prologue chosen at run time, the same for the
//     whole launch (pos set or not), so it adds no instantiation: each ray
//     is built from its pixel index and the camera by the TPU kernel's own
//     formula (megakernel.py:105-135) and intersected with the bounding
//     sphere, where the continue mode reads the state from device memory.
//     It saves the [n, 3] directions and the state in device memory, and
//     costs an integer division, a square root and two divisions per ray;
//   * the scene compose runs right after the chain, each step, where the
//     reference's sceneSDF runs inside its march kernel. The scene and the
//     cylinder window are template parameters, one instantiation per
//     (scene, window): the compose is straight-line code with no branch on
//     the scene, and the neural_raw instantiation is the bare chain;
//   * a warp loops until its last ray resolves, each lane's state advancing
//     only while its own ray marches (the TPU kernel exits per 8192-lane
//     tile, with identical per-ray results);
//   * outside the tensor-core chains all arithmetic is FP32 (FFMA in the
//     ray-split mode's chain).
//
// The compose's cost: it is FP32 elementwise work on the ray's own
// registers, about 100 (many_sphere: 9 sphere distances and smooth
// unions) to 400 (many_cylinder_cut, window 5: 25 cylinders and smooth
// subtractions) operations per step plus a few sqrtf / sinf / tanhf, next
// to the ~7.3k FMAs of the layer chain. It should change the cost of a
// step by a few percent; frame times per scene differ mostly through their
// step counts.
//
// The prologue's arithmetic is the plain version's
// (kernels/megakernel.py raygen_state), one rounding per operation, the
// division by the width a product with its float32 reciprocal.
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
#include "hash_grid.cuh"
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

// K5's prologue: the ray of pixel index p and its bounding-sphere init. The
// index is split by floor division, as JAX's // and %, so a pad lane (p < 0)
// stays defined; it starts inactive.
__device__ __forceinline__ void ray_from_index(
    int p, const float* __restrict__ c2w, int width, int height, float focal, float cx,
    float cy, float cz, float r2, float& ox, float& oy, float& oz, float& dx, float& dy,
    float& dz, float& t, float& budget, bool& act) {
  int py = p / width;
  int px = p - py * width;
  if (px < 0) {
    px += width;
    --py;
  }
  const float u = __fsub_rn(
      __fmul_rn(__fmul_rn(static_cast<float>(px), __frcp_rn(static_cast<float>(width))), 2.f),
      1.f);
  const float v = __fsub_rn(
      __fmul_rn(__fmul_rn(static_cast<float>(py), __frcp_rn(static_cast<float>(height))), 2.f),
      1.f);
  const float fw = -focal;
  const float inv = __fdiv_rn(
      1.f, __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)), __fmul_rn(fw, fw))));
  const float du = __fmul_rn(u, inv), dv = __fmul_rn(v, inv), dw = __fmul_rn(fw, inv);
  dx = __fadd_rn(__fadd_rn(__fmul_rn(c2w[0], du), __fmul_rn(c2w[1], dv)), __fmul_rn(c2w[2], dw));
  dy = __fadd_rn(__fadd_rn(__fmul_rn(c2w[4], du), __fmul_rn(c2w[5], dv)), __fmul_rn(c2w[6], dw));
  dz = __fadd_rn(__fadd_rn(__fmul_rn(c2w[8], du), __fmul_rn(c2w[9], dv)),
                 __fmul_rn(c2w[10], dw));
  ox = c2w[3];
  oy = c2w[7];
  oz = c2w[11];
  const float qx = __fsub_rn(ox, cx), qy = __fsub_rn(oy, cy), qz = __fsub_rn(oz, cz);
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  const float b = __fmul_rn(
      2.f, __fadd_rn(__fadd_rn(__fmul_rn(qx, dx), __fmul_rn(qy, dy)), __fmul_rn(qz, dz)));
  const float c = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz)), r2);
  const float disc = __fsub_rn(__fmul_rn(b, b), __fmul_rn(__fmul_rn(4.f, a), c));
  const bool hit = disc > 0.f;
  const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
  const float a2 = __fmul_rn(2.f, a);
  t = hit ? fmaxf(__fdiv_rn(__fsub_rn(-b, sq), a2), 0.f) : 0.f;
  budget = hit ? __fdiv_rn(__fadd_rn(-b, sq), a2) : 0.f;
  act = hit && p >= 0;
}

// One step of a ray's march after its chain value raw at p (singleMarch's
// update order, the over-relaxation, the resolve step).
template <int S, int W>
__device__ __forceinline__ void march_step(float px, float py, float pz, float raw, float frame,
                                           bool relax, float eps, float omega, float& t,
                                           float& budget, float& prev_r, float& step_len,
                                           bool& conv, bool& act, int& step, int& res) {
  const float d = compose<S, W>(px, py, pz, raw, frame);

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

// The chain's input stage E (hash_grid.cuh Inputs) is a template parameter
// too: the point itself (kRawInputs), or its hash encoding (kHashInputs:
// the hash-grid SDF, width 64, neural_raw only; table and levels are read
// only there, csrc/hidden64_hash.cu and hidden64_3pass_hash.cu).
//
// The chain runs for the 32 rays of a warp together (chain_sdf_mma,
// chain_sdf_tf32), so the loop is warp-uniform: it runs while any lane's
// ray marches, and a lane whose ray is done, or that has no ray (r >= n),
// stays in it inactive, passing a finite point. SIMT ran a warp until its
// slowest ray already, so this adds no steps; a lane's own step count and
// state are those of a per-ray loop.
template <int H, int S, int W, bool kThreePass, int E = kRawInputs>
__global__ void __launch_bounds__(march_block(H))
march_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
             const float* __restrict__ t0, const float* __restrict__ budget0,
             const uint8_t* __restrict__ active0, const int32_t* __restrict__ steps0,
             const int32_t* __restrict__ pos, const float* __restrict__ c2w, int width,
             int height, float focal, float bound_cx, float bound_cy, float bound_cz,
             float bound_r2, const void* __restrict__ weights,
             const float* __restrict__ biases, int n_layers, int n_inputs,
             const float* __restrict__ frame_ptr, int n, int max_steps, int num_steps, float eps,
             float omega, float* __restrict__ t_out,
             float* __restrict__ budget_out, uint8_t* __restrict__ active_out,
             uint8_t* __restrict__ conv_out, int32_t* __restrict__ steps_out,
             const float2* __restrict__ table, const uint32_t* __restrict__ levels) {
  const uint4* sw3 = nullptr;   // the three-pass stack, bf16 fragment order
  const float2* swt = nullptr;  // the FP32 stack, tf32 fragment order
  const float* sb = biases;
  if constexpr (kThreePass) {
    stage_weights_mma<H>(static_cast<const uint4*>(weights), biases, n_layers, sw3, sb);
  } else if constexpr (H <= 64) {
    const float* sw;
    stage_weights<H>(static_cast<const float*>(weights), biases, n_layers, sw, sb);
    swt = reinterpret_cast<const float2*>(sw);
  } else {
    swt = static_cast<const float2*>(weights);
  }

  // The frame number lives in device memory, so a CUDA graph of a frame
  // reads the value its caller copied in before each replay: one uniform
  // load a warp, the same float32 the plain version composes with.
  const float frame = __ldg(frame_ptr);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = r < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, t = 0.f, budget = 0.f;
  bool act = false;
  int start;
  if (pos != nullptr) {  // K5: a cold start from the pixel index
    if (in_range)
      ray_from_index(pos[r], c2w, width, height, focal, bound_cx, bound_cy, bound_cz, bound_r2,
                     ox, oy, oz, dx, dy, dz, t, budget, act);
    start = 0;
  } else {
    if (in_range) {
      ox = origin[0];
      oy = origin[1];
      oz = origin[2];
      dx = dirs[3 * r];
      dy = dirs[3 * r + 1];
      dz = dirs[3 * r + 2];
      t = t0[r];
      budget = budget0[r];
      act = active0[r] != 0;
    }
    start = *steps0;
  }
  bool conv = false;
  int step = start;
  int res = start;
  const bool relax = omega > 1.f;
  float prev_r = 0.f, step_len = 0.f;

  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4) +
               (threadIdx.x / 32) * 2 * 16 * act_words(H);  // H >= 128 only
  while (__any_sync(0xffffffffu,
                    act && step < max_steps && (num_steps < 0 || step - start < num_steps))) {
    const bool go = act && step < max_steps && (num_steps < 0 || step - start < num_steps);
    const float px = __fmaf_rn(dx, t, ox);
    const float py = __fmaf_rn(dy, t, oy);
    const float pz = __fmaf_rn(dz, t, oz);
    float raw;
    if constexpr (E == kHashInputs && kThreePass)
      raw = chain_hash_3pass<H>(sw3, sb, n_layers, table, levels, px, py, pz);
    else if constexpr (E == kHashInputs)
      raw = chain_hash_tf32<H>(swt, sb, n_layers, table, levels, px, py, pz);
    else if constexpr (kThreePass)
      raw = chain_sdf_mma<H>(sw3, sb, n_layers, n_inputs, px, py, pz, frame,
                             reinterpret_cast<uint2*>(buf));
    else
      raw = chain_sdf_tf32<H>(swt, sb, n_layers, n_inputs, px, py, pz, frame, buf);
    if (go)
      march_step<S, W>(px, py, pz, raw, frame, relax, eps, omega, t, budget, prev_r, step_len,
                       conv, act, step, res);
  }
  if (!in_range) return;

  t_out[r] = t;
  budget_out[r] = budget;
  active_out[r] = act ? 1 : 0;
  conv_out[r] = conv ? 1 : 0;
  steps_out[r] = act ? step : res;
}

// The ray-split mode of the FP32 chain at H = 32 and 64 (march_state's
// ray_lanes = kSplitLanes): warp w of the grid marches ray w, the chain of
// its point split over the warp's lanes (chain.cuh split_sdf). Every lane
// reads the ray's state and keeps it, runs the same compose and march_step
// on the same values, so every branch and the loop condition are the same
// in all 32 lanes; lane 0 writes the results. A ray's steps and results are
// those of the plain version (megakernel.march_state_plain) bit for bit:
// the chain sums each output in input order from zero on FFMA, the order of
// the plain version's cuBLAS chain, and the bookkeeping is
// march_step itself (a ray per thread, march_kernel<H, S, W, false> sums
// on the tensor cores in their own order).
//
// Why: in one ray per thread, a warp marches as long as its slowest ray, and
// a straggler's warp issues the whole chain for its rows every step while
// the other lanes idle. In the split mode a step's latency is the chain of
// one output per layer, so a refine rung whose few active rays march
// hundreds of steps (the terminal rung) ends sooner. Its throughput is
// lower (each weight is read once per ray, not once per 32 rays, and on
// FFMA), so march_state picks it per launch (ray_lanes in
// kernels/megakernel.py). Continue mode only: a cold start (K5) marches one
// ray per thread.
//
// A block is kSplitRays warps, 512 threads, and one block an SM is enough
// for the launch bound, so ptxas may give a thread up to 128 registers: the
// chain loads a layer's inputs and weights ahead of its products (chain.cuh
// split_sdf). Capped at 64 (1024 threads a block, or 512 with no minimum
// of blocks), it issued many loads just before their products, on the
// critical path, and a straggler's step took several times as long on the
// H100. The block's first kSplitRays
// threads write the entry state back for its inactive rays (r < n),
// coalesced; a warp whose ray is inactive (or r >= n) then leaves, and a
// block with no active ray also skips staging the stack, so the empty
// lanes of a sorted refine bucket cost a read of their flag and a write of
// their results.
constexpr int kSplitLanes = 32;
constexpr int kSplitBlock = 32 * kSplitRays;

template <int H, int S, int W, int E = kRawInputs>
__global__ void __launch_bounds__(kSplitBlock, 1)
march_split_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
                   const float* __restrict__ t0, const float* __restrict__ budget0,
                   const uint8_t* __restrict__ active0, const int32_t* __restrict__ steps0,
                   const float* __restrict__ weights, const float* __restrict__ biases,
                   int n_layers, int n_inputs, const float* __restrict__ frame_ptr, int n,
                   int max_steps, int num_steps,
                   float eps, float omega, float* __restrict__ t_out,
                   float* __restrict__ budget_out, uint8_t* __restrict__ active_out,
                   uint8_t* __restrict__ conv_out, int32_t* __restrict__ steps_out,
                   const float2* __restrict__ table, const uint32_t* __restrict__ levels) {
  const int r0 = blockIdx.x * kSplitRays;
  const int start = *steps0;
  bool entry_act = false;  // thread k < kSplitRays: ray r0 + k's flag
  if (threadIdx.x < kSplitRays && r0 + static_cast<int>(threadIdx.x) < n) {
    const int q = r0 + static_cast<int>(threadIdx.x);
    entry_act = active0[q] != 0;
    if (!entry_act) {
      t_out[q] = t0[q];
      budget_out[q] = budget0[q];
      active_out[q] = 0;
      conv_out[q] = 0;
      steps_out[q] = start;
    }
  }
  if (!__syncthreads_or(entry_act)) return;
  extern __shared__ float4 smem4[];
  const float* sw = reinterpret_cast<const float*>(smem4);
  const float* sb = stage_weights_split<H>(weights, biases, n_layers);
  float* xrow = reinterpret_cast<float*>(smem4) + n_layers * H * split_stride(H) +
                n_layers * H + (threadIdx.x / 32) * H;
  const int r = r0 + static_cast<int>(threadIdx.x / 32);
  if (r >= n || active0[r] == 0) return;  // the whole warp

  const float frame = __ldg(frame_ptr);  // as march_kernel reads it
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  float t = t0[r];
  float budget = budget0[r];
  bool act = true;
  bool conv = false;
  int step = start;
  int res = start;
  const bool relax = omega > 1.f;
  float prev_r = 0.f, step_len = 0.f;
  while (act && step < max_steps && (num_steps < 0 || step - start < num_steps)) {
    const float px = __fmaf_rn(dx, t, ox);
    const float py = __fmaf_rn(dy, t, oy);
    const float pz = __fmaf_rn(dz, t, oz);
    float raw;
    if constexpr (E == kHashInputs)
      raw = split_hash_sdf<H>(sw, sb, xrow, n_layers, table, levels, px, py, pz);
    else
      raw = split_sdf<H>(sw, sb, xrow, n_layers, n_inputs, px, py, pz, frame);
    march_step<S, W>(px, py, pz, raw, frame, relax, eps, omega, t, budget, prev_r, step_len,
                     conv, act, step, res);
  }
  if ((threadIdx.x & 31) == 0) {
    t_out[r] = t;
    budget_out[r] = budget;
    active_out[r] = act ? 1 : 0;
    conv_out[r] = conv ? 1 : 0;
    steps_out[r] = act ? step : res;
  }
}

// The kernel takes its arguments one by one: passed as one MarchArgs by
// value, ptxas allots the FP32 instantiations more registers (100-103 at
// width 32 instead of 96) and spills at 128 and 256.
using MarchKernel = void (*)(const float*, const float*, const float*, const float*,
                             const uint8_t*, const int32_t*, const int32_t*, const float*, int,
                             int, float, float, float, float, float, const void*, const float*,
                             int, int, const float*, int, int, int, float, float, float*,
                             float*, uint8_t*, uint8_t*, int32_t*, const float2*,
                             const uint32_t*);
using SplitKernel = void (*)(const float*, const float*, const float*, const float*,
                             const uint8_t*, const int32_t*, const float*, const float*, int,
                             int, const float*, int, int, int, float, float, float*, float*, uint8_t*,
                             uint8_t*, int32_t*, const float2*, const uint32_t*);

// The ray-split instantiation for a scene id and cylinder window, or nullptr.
template <int H>
SplitKernel pick_split_kernel(int scene, int window) {
  if (window != 1 && window != 3 && window != 5) return nullptr;
  switch (scene) {
    case kNeuralRaw: return march_split_kernel<H, kNeuralRaw, 0>;
    case kNeuralTanh: return march_split_kernel<H, kNeuralTanh, 0>;
    case kManySphere: return march_split_kernel<H, kManySphere, 0>;
    case kManySphereCut: return march_split_kernel<H, kManySphereCut, 0>;
    case kManyCylinderCut:
      if (window == 1) return march_split_kernel<H, kManyCylinderCut, 1>;
      if (window == 3) return march_split_kernel<H, kManyCylinderCut, 3>;
      return march_split_kernel<H, kManyCylinderCut, 5>;
    case kDisplacement: return march_split_kernel<H, kDisplacement, 0>;
    default: return nullptr;
  }
}

template <int H>
int launch_split_kernel(SplitKernel kernel, const MarchArgs& a, cudaStream_t stream) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split_smem_bytes(H, a.n_layers);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.n + kSplitRays - 1) / kSplitRays;
  kernel<<<grid, kSplitBlock, smem, stream>>>(
      a.dirs, a.origin, a.t0, a.budget0, a.active0, a.steps0,
      static_cast<const float*>(a.weights), a.biases, a.n_layers, a.n_inputs, a.frame, a.n,
      a.max_steps, a.num_steps, a.eps, a.omega, a.t_out, a.budget_out, a.active_out,
      a.conv_out, a.steps_out, static_cast<const float2*>(a.table), a.levels);
  return static_cast<int>(cudaGetLastError());
}

// The 128-wide instantiations, a block's group of rays at once
// (csrc/hidden128_group.cuh, which the 128-wide units include).
template <bool kThreePass>
MarchKernel pick_group_kernel(int scene, int window);

// The instantiation for a width, chain, scene id and cylinder window, or
// nullptr.
template <int H, bool kThreePass>
MarchKernel pick_kernel(int scene, int window) {
  if constexpr (H == 128) {
    return pick_group_kernel<kThreePass>(scene, window);
  } else {
    if (window != 1 && window != 3 && window != 5) return nullptr;
    switch (scene) {
      case kNeuralRaw: return march_kernel<H, kNeuralRaw, 0, kThreePass>;
      case kNeuralTanh: return march_kernel<H, kNeuralTanh, 0, kThreePass>;
      case kManySphere: return march_kernel<H, kManySphere, 0, kThreePass>;
      case kManySphereCut: return march_kernel<H, kManySphereCut, 0, kThreePass>;
      case kManyCylinderCut:
        if (window == 1) return march_kernel<H, kManyCylinderCut, 1, kThreePass>;
        if (window == 3) return march_kernel<H, kManyCylinderCut, 3, kThreePass>;
        return march_kernel<H, kManyCylinderCut, 5, kThreePass>;
      case kDisplacement: return march_kernel<H, kDisplacement, 0, kThreePass>;
      default: return nullptr;
    }
  }
}

// A launch of the ray-split mode, or nullptr where the chain has none.
using SplitLauncher = int (*)(const MarchArgs&, cudaStream_t);

template <int H>
int launch_split(const MarchArgs& a, cudaStream_t stream) {
  return launch_split_kernel<H>(pick_split_kernel<H>(a.scene, a.window), a, stream);
}

// A launch of the ray-per-thread kernel, or of the ray-split mode the args
// ask for (split: nullptr where the chain has none).
template <int H>
int launch_march_kernel(MarchKernel kernel, SplitLauncher split_launch, const MarchArgs& a,
                        cudaStream_t stream) {
  const bool state_given = a.pos != nullptr || a.steps0 != nullptr;
  if (kernel == nullptr || !state_given || a.n_layers < 1 || a.n_inputs < 1 || a.n_inputs > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // The ray-split mode: the FP32 chain at 32, 64 and 128, continue mode only.
  const bool split = a.ray_lanes == kSplitLanes;
  if ((!split && a.ray_lanes != 1) || (split && (split_launch == nullptr || a.pos != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n <= 0) return 0;
  if (split) return split_launch(a, stream);
  const size_t smem = march_smem_bytes(H, a.n_layers);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = march_block(H);
  const int grid = (a.n + block - 1) / block;
  kernel<<<grid, block, smem, stream>>>(
      a.dirs, a.origin, a.t0, a.budget0, a.active0, a.steps0, a.pos, a.c2w, a.width, a.height,
      a.focal, a.bound_cx, a.bound_cy, a.bound_cz, a.bound_r2, a.weights, a.biases, a.n_layers,
      a.n_inputs, a.frame, a.n, a.max_steps, a.num_steps, a.eps, a.omega, a.t_out,
      a.budget_out, a.active_out, a.conv_out, a.steps_out, static_cast<const float2*>(a.table),
      a.levels);
  return static_cast<int>(cudaGetLastError());
}

template <int H, bool kThreePass>
int launch_march(const MarchArgs& a, cudaStream_t stream) {
  // The ray-split mode: the FP32 chain at 32 and 64 (march_split_kernel),
  // and at 128 across a cluster (csrc/hidden128_split.cu).
  SplitLauncher split = nullptr;
  if constexpr (!kThreePass && H <= 64) split = launch_split<H>;
  if constexpr (!kThreePass && H == 128) split = launch_march_split128;
  return launch_march_kernel<H>(pick_kernel<H, kThreePass>(a.scene, a.window), split, a,
                                stream);
}

// The hash-grid SDF's instantiations: width 64, neural_raw, the encoding as
// the chain's input stage (csrc/hidden64_hash.cu, hidden64_3pass_hash.cu).
template <bool kThreePass>
int launch_march_hash(const MarchArgs& a, cudaStream_t stream) {
  if (a.scene != kNeuralRaw || a.table == nullptr || a.levels == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitLauncher split = nullptr;
  if constexpr (!kThreePass)
    split = [](const MarchArgs& b, cudaStream_t s) {
      return launch_split_kernel<64>(march_split_kernel<64, kNeuralRaw, 0, kHashInputs>, b, s);
    };
  return launch_march_kernel<64>(march_kernel<64, kNeuralRaw, 0, kThreePass, kHashInputs>,
                                 split, a, stream);
}

}  // namespace cnr
