// The library's C interface, bound with ctypes by kernels/build.py.
//
//   cnr_march         the march kernel (K1, csrc/march.cuh), continuing a
//                     march state
//   cnr_march_raygen  the same kernel from a cold start, each ray built in
//                     the kernel from its pixel index (K5)
//   cnr_mlp_forward   the fused forward (K3, csrc/chain.cuh)
//   cnr_smem_bytes    the dynamic shared memory a launch of a kernel asks for
//   cnr_trace_mark    a span's begin or end mark on a stream (utils/trace.py)
//
// Each dispatches on the padded hidden width (32, 64, 128, 256, 512 or
// 1024), and the march entries on the chain (three_pass: 0 for FP32, whose
// weights are the stack in tf32 fragment order; 1 for the three-pass chain
// K2h), to the instantiation in csrc/hidden{H}.cu or
// csrc/hidden{H}_3pass.cu; cnr_march also on the mode (ray_lanes: 1 for a
// ray per thread, 32 for a ray per warp, the FP32 chain at widths 32, 64
// and 128 only, whose weights are then the FP32 stack [L, H, H]: march.cuh
// march_split_kernel; at 128 csrc/hidden128_split.cu, which takes work, a
// zeroed int32 in device memory, as its ray counter; NULL elsewhere). Given
// a table and its level words, both march entries run the hash-grid SDF's
// instantiations (width 64, neural_raw: csrc/hash_grid.cuh). Each returns
// a cudaError_t: a width, scene, window, input count or mode with no
// instantiation gives cudaErrorInvalidValue, and a refused launch its own
// error. Nothing is launched in either case. The experiment kernels X1-X3
// have their own entries (csrc/experiments.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "launch.h"

namespace {

template <typename Args>
using Launcher = int (*)(const Args&, cudaStream_t);

// The hidden widths with an instantiation (kernels/fused_mlp.py KERNEL_WIDTHS).
constexpr int kWidths[] = {32, 64, 128, 256, 512, 1024};
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);

// by_width[k] launches at width kWidths[k].
template <typename Args>
int dispatch(int device, int hidden, const Args& a, void* stream,
             const Launcher<Args> (&by_width)[kNumWidths]) {
  for (int k = 0; k < kNumWidths; ++k) {
    if (kWidths[k] != hidden) continue;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return by_width[k](a, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kThreePass>
constexpr Launcher<cnr::MarchArgs> kMarch[kNumWidths] = {
    cnr::launch_march<32, kThreePass>,  cnr::launch_march<64, kThreePass>,
    cnr::launch_march<128, kThreePass>, cnr::launch_march<256, kThreePass>,
    cnr::launch_march<512, kThreePass>, cnr::launch_march<1024, kThreePass>};

constexpr Launcher<cnr::MlpArgs> kForward[kNumWidths] = {
    cnr::launch_mlp_forward<32>,  cnr::launch_mlp_forward<64>,  cnr::launch_mlp_forward<128>,
    cnr::launch_mlp_forward<256>, cnr::launch_mlp_forward<512>, cnr::launch_mlp_forward<1024>};

int dispatch_march(int device, int hidden, const cnr::MarchArgs& a, void* stream) {
  if (a.table != nullptr) {  // the hash-grid SDF: width 64 only
    if (hidden != 64) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return a.three_pass ? cnr::launch_march_hash<true>(a, s) : cnr::launch_march_hash<false>(a, s);
  }
  if (a.three_pass) return dispatch(device, hidden, a, stream, kMarch<true>);
  return dispatch(device, hidden, a, stream, kMarch<false>);
}

// One thread: a begin mark stores %globaltimer (ns) in span[0]; an end mark
// adds the time since span[0] to span[1] and 1 to span[2]. The stream runs
// it after the work queued before it, so two marks bracket that work.
__global__ void trace_mark_kernel(long long* span, int end) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (end) {
    span[1] += now - span[0];
    span[2] += 1;
  } else {
    span[0] = now;
  }
}

}  // namespace

extern "C" int cnr_trace_mark(int device, long long* buf, int slot, int end, void* stream) {
  if (buf == nullptr || slot < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(buf + slot, end);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cnr_march(int device, const float* dirs, const float* origin,
                         const float* t0, const float* budget0,
                         const uint8_t* active0, const int32_t* steps0,
                         const void* weights, const float* biases, int n_layers,
                         int hidden, int n_inputs, const float* frame, const void* table,
                         const uint32_t* levels, int scene, int window,
                         int three_pass, int ray_lanes, int n, int max_steps, int num_steps,
                         float eps,
                         float omega, float* t_out, float* budget_out,
                         uint8_t* active_out, uint8_t* conv_out,
                         int32_t* steps_out, int32_t* work, void* stream) {
  if (frame == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cnr::MarchArgs a{};
  a.dirs = dirs;
  a.origin = origin;
  a.t0 = t0;
  a.budget0 = budget0;
  a.active0 = active0;
  a.steps0 = steps0;
  a.weights = weights;
  a.biases = biases;
  a.n_layers = n_layers;
  a.n_inputs = n_inputs;
  a.frame = frame;
  a.table = table;
  a.levels = levels;
  a.scene = scene;
  a.window = window;
  a.three_pass = three_pass;
  a.ray_lanes = ray_lanes;
  a.n = n;
  a.max_steps = max_steps;
  a.num_steps = num_steps;
  a.eps = eps;
  a.omega = omega;
  a.t_out = t_out;
  a.budget_out = budget_out;
  a.active_out = active_out;
  a.conv_out = conv_out;
  a.steps_out = steps_out;
  a.work = work;
  return dispatch_march(device, hidden, a, stream);
}

extern "C" int cnr_march_raygen(int device, const int32_t* pos, const float* c2w,
                                int width, int height, float focal, float bound_cx,
                                float bound_cy, float bound_cz, float bound_r2,
                                const void* weights, const float* biases, int n_layers, int hidden,
                                int n_inputs, const float* frame, const void* table,
                                const uint32_t* levels, int scene, int window,
                                int three_pass, int n, int max_steps, float eps,
                                float omega, float* t_out, float* budget_out,
                                uint8_t* active_out, uint8_t* conv_out,
                                int32_t* steps_out, void* stream) {
  if (pos == nullptr || c2w == nullptr || frame == nullptr || width <= 0 || height <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cnr::MarchArgs a{};
  a.pos = pos;
  a.c2w = c2w;
  a.width = width;
  a.height = height;
  a.focal = focal;
  a.bound_cx = bound_cx;
  a.bound_cy = bound_cy;
  a.bound_cz = bound_cz;
  a.bound_r2 = bound_r2;
  a.weights = weights;
  a.biases = biases;
  a.n_layers = n_layers;
  a.n_inputs = n_inputs;
  a.frame = frame;
  a.table = table;
  a.levels = levels;
  a.scene = scene;
  a.window = window;
  a.three_pass = three_pass;
  a.ray_lanes = 1;  // a cold start marches a ray per thread
  a.n = n;
  a.max_steps = max_steps;
  a.num_steps = -1;  // run to dry
  a.eps = eps;
  a.omega = omega;
  a.t_out = t_out;
  a.budget_out = budget_out;
  a.active_out = active_out;
  a.conv_out = conv_out;
  a.steps_out = steps_out;
  return dispatch_march(device, hidden, a, stream);
}

extern "C" int cnr_mlp_forward(int device, const float* x, const float* weights,
                               const void* packed, const float* biases, int n_layers,
                               int hidden, int n_inputs, int n, float* out, void* stream) {
  const cnr::MlpArgs a{x, weights, packed, biases, n_layers, n_inputs, n, out};
  return dispatch(device, hidden, a, stream, kForward);
}

// Bytes of dynamic shared memory a launch asks for: kind 0 the march kernel
// with the FP32 chain, 1 with the three-pass chain, 2 the fused forward, 3
// the ray-split march kernel (widths 32 and 64; at 128 a CTA of its
// cluster); -1 for an unknown kind or width.
extern "C" long long cnr_smem_bytes(int kind, int hidden, int n_layers) {
  bool known = false;
  for (int k = 0; k < kNumWidths; ++k) known = known || kWidths[k] == hidden;
  if (!known) return -1;
  switch (kind) {
    case 0:
    case 1: return static_cast<long long>(cnr::march_smem_bytes(hidden, n_layers));
    case 2: return static_cast<long long>(cnr::forward_smem_bytes(hidden));
    case 3:
      if (hidden == 128) return static_cast<long long>(cnr::split_cluster_smem_bytes(n_layers));
      return hidden <= 64 ? static_cast<long long>(cnr::split_smem_bytes(hidden, n_layers))
                          : -1;
    default: return -1;
  }
}

extern "C" const char* cnr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
