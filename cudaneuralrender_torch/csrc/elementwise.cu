// Elementwise kernels of the shading and training backward passes, with
// their C entries (bound by kernels/build.py, wrapped by
// kernels/elementwise.py).
//
//   cnr_relu_tie_backward  out = g * H(h, 1/2): the gradient of a ReLU whose
//                          derivative at a pre-activation of exactly 0 is
//                          1/2, as the JAX package's jnp.maximum(h, 0.0)
//                          gives it (cudaneuralrender_tpu/models/mlp.py
//                          apply). torch.relu's backward gives a tie 0.
//
// It replaces no TPU kernel: the JAX package leaves this gradient to XLA,
// which fuses it into the backward pass. Here it is one pass over g and h
// and one write of out (models/mlp.py _TieReLU), where the plain version
// g * torch.heaviside(h, 1/2) is two (the step, then the product).
//
// What bounds it: bytes, 12 a point (two float32 reads, one write); no
// arithmetic to speak of. Its design: four points a thread as 16-byte
// loads and stores where all three pointers are 16-byte aligned (neighbour
// threads on neighbour addresses), a grid-stride loop over at most
// kMaxBlocks blocks of kBlock threads, and a scalar tail. The step is
// selected, not computed: h == 0 (either sign) gives 1/2, h > 0 gives 1,
// anything else (h < 0, NaN) 0, as torch.heaviside(h, 1/2) does, and the
// product g * step is the plain version's, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads on each SM

__device__ __forceinline__ float tie_step(float h) {
  return h == 0.0f ? 0.5f : (h > 0.0f ? 1.0f : 0.0f);
}

__global__ void relu_tie_backward_kernel(const float* __restrict__ g,
                                         const float* __restrict__ h, float* __restrict__ out,
                                         int64_t n, int vec4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec4) {
    const int64_t n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* h4 = reinterpret_cast<const float4*>(h);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = g4[i];
      const float4 b = h4[i];
      out4[i] = make_float4(a.x * tie_step(b.x), a.y * tie_step(b.y), a.z * tie_step(b.z),
                            a.w * tie_step(b.w));
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = g[i] * tie_step(h[i]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// g, h, out: n float32 values each, in device memory. Returns a cudaError_t.
extern "C" int cnr_relu_tie_backward(int device, const float* g, const float* h, float* out,
                                     long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int vec4 = aligned16(g) && aligned16(h) && aligned16(out);
  const int64_t items = vec4 ? (n + 3) / 4 : n;
  const int64_t want = (items + kBlock - 1) / kBlock;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  relu_tie_backward_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      g, h, out, static_cast<int64_t>(n), vec4);
  return static_cast<int>(cudaGetLastError());
}
