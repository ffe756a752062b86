// The launchers of the package's kernels, one explicit instantiation per
// hidden width (csrc/hidden{32,64,128,256}.cu), called by the C entry
// points in csrc/march.cu. Each returns a cudaError_t as an int.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cnr {

// One march call (K1): per-ray inputs and outputs, the padded weight stack
// [n_layers, H, H] and biases [n_layers, H], the scene and the step rule.
struct MarchArgs {
  const float* dirs;
  const float* origin;
  const float* t0;
  const float* budget0;
  const uint8_t* active0;
  const int32_t* steps0;
  const float* weights;
  const float* biases;
  int n_layers;
  int n_inputs;
  float frame;
  int scene;
  int window;
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

// One fused forward (K3): points x [n, n_inputs] -> out [n].
struct MlpArgs {
  const float* x;
  const float* weights;
  const float* biases;
  int n_layers;
  int n_inputs;
  int n;
  float* out;
};

template <int H>
int launch_march(const MarchArgs& a, cudaStream_t stream);

template <int H>
int launch_mlp_forward(const MlpArgs& a, cudaStream_t stream);

}  // namespace cnr
