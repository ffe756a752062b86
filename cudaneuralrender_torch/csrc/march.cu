// The library's C interface, bound with ctypes by kernels/build.py.
//
//   cnr_march        the march kernel (K1, csrc/march.cuh)
//   cnr_mlp_forward  the fused forward (K3, csrc/chain.cuh)
//
// Each dispatches on the padded hidden width to the instantiation in
// csrc/hidden{32,64,128,256}.cu and returns a cudaError_t: a width, scene,
// window or input count with no instantiation gives cudaErrorInvalidValue,
// and a refused launch its own error. Nothing is launched in either case.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.h"

namespace {

template <typename Args>
using Launcher = int (*)(const Args&, cudaStream_t);

template <typename Args>
int dispatch(int device, int hidden, const Args& a, void* stream,
             Launcher<Args> h32, Launcher<Args> h64, Launcher<Args> h128,
             Launcher<Args> h256) {
  Launcher<Args> launch = nullptr;
  switch (hidden) {
    case 32: launch = h32; break;
    case 64: launch = h64; break;
    case 128: launch = h128; break;
    case 256: launch = h256; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int cnr_march(int device, const float* dirs, const float* origin,
                         const float* t0, const float* budget0,
                         const uint8_t* active0, const int32_t* steps0,
                         const float* weights, const float* biases,
                         int n_layers, int hidden, int n_inputs, float frame,
                         int scene, int window,
                         int n, int max_steps, int num_steps, float eps,
                         float omega, float* t_out, float* budget_out,
                         uint8_t* active_out, uint8_t* conv_out,
                         int32_t* steps_out, void* stream) {
  const cnr::MarchArgs a{dirs, origin, t0, budget0, active0, steps0, weights, biases,
                         n_layers, n_inputs, frame, scene, window, n, max_steps,
                         num_steps, eps, omega, t_out, budget_out, active_out,
                         conv_out, steps_out};
  return dispatch(device, hidden, a, stream, cnr::launch_march<32>,
                  cnr::launch_march<64>, cnr::launch_march<128>, cnr::launch_march<256>);
}

extern "C" int cnr_mlp_forward(int device, const float* x, const float* weights,
                               const float* biases, int n_layers, int hidden,
                               int n_inputs, int n, float* out, void* stream) {
  const cnr::MlpArgs a{x, weights, biases, n_layers, n_inputs, n, out};
  return dispatch(device, hidden, a, stream, cnr::launch_mlp_forward<32>,
                  cnr::launch_mlp_forward<64>, cnr::launch_mlp_forward<128>,
                  cnr::launch_mlp_forward<256>);
}

extern "C" const char* cnr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
