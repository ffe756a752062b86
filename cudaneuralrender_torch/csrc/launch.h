// The launchers of the package's kernels, one explicit instantiation per
// hidden width and chain (csrc/hidden{H}.cu for the FP32 chain and the
// forward kernel, csrc/hidden{H}_3pass.cu for the three-pass chain, H = 32,
// 64, 128, 256, 512 and 1024), called by the C entry points in
// csrc/march.cu. Each returns a cudaError_t as an int.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cnr {

// One march call (K1): per-ray inputs and outputs, the padded weight stack
// and its biases [n_layers, H], the scene and the step rule. With pos set it
// is a cold start (K5): each ray is built in the kernel from its pixel index
// and the camera, and dirs, origin, t0, budget0, active0 and steps0 are not
// read.
struct MarchArgs {
  const float* dirs;       // [n, 3]
  const float* origin;     // [3]
  const float* t0;         // [n]
  const float* budget0;    // [n]
  const uint8_t* active0;  // [n]
  const int32_t* steps0;   // [1], the step counter the call starts from
  const int32_t* pos;      // K5: [n] pixel index y * width + x, -1 = pad lane
  const float* c2w;        // K5: [3, 4] camera to world, row-major
  int width;               // K5: image size and focal length
  int height;
  float focal;
  float bound_cx;          // K5: bounding sphere center and radius squared
  float bound_cy;
  float bound_cz;
  float bound_r2;
  const void* weights;     // FP32 [n_layers, H, H] at H = 32, 64, in tf32 fragment
                           // order from 128; three-pass: the bf16 hi and lo
                           // halves in fragment order (fused_mlp.packed_mma)
  const float* biases;
  int n_layers;
  int n_inputs;
  const float* frame;       // [1] the frame number, in device memory
  int scene;
  int window;
  int three_pass;
  int ray_lanes;           // 1: a ray per thread; 32: a ray per warp (the
                           // FP32 chain at H = 32, 64, continue mode only)
  int n;
  int max_steps;
  int num_steps;
  float eps;
  float omega;
  float* t_out;
  float* budget_out;
  uint8_t* active_out;
  uint8_t* conv_out;
  int32_t* steps_out;
};

// One fused forward (K3): points x [n, n_inputs] -> out [n]; packed is the
// stack in tf32 fragment order (kernels/fused_mlp.py packed_mma).
struct MlpArgs {
  const float* x;
  const float* weights;
  const void* packed;
  const float* biases;
  int n_layers;
  int n_inputs;
  int n;
  float* out;
};

template <int H, bool kThreePass>
int launch_march(const MarchArgs& a, cudaStream_t stream);

template <int H>
int launch_mlp_forward(const MlpArgs& a, cudaStream_t stream);

}  // namespace cnr
