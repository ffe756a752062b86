// The hash encoding of a render's shading points and its input gradient
// (models/hash_grid.py _Encode, the hash-grid SDF's autodiff normals), with
// its C entry cnr_hash_encode (bound by kernels/build.py).
//
// It replaces no TPU kernel: the JAX package has no encoding. The normals
// of a hash-grid SDF are the gradient of MLP(encode(p)): the forward here
// writes the features [n, 2L] (the plain version's bits,
// hash_grid.cuh hash_features), the MLP runs under autograd on cuBLAS FP32,
// and the backward here takes the features' gradient [n, 2L] back to the
// points through the trilinear weights (floor's gradient is 0):
//   d feature_c / d p_a = s_l / span * sum_k v_k[c] * (+-1 on axis a) *
//   the product of corner k's weights on the other two axes,
// summed per level and over the levels, in its own order (autograd of the
// plain version sums otherwise: the gradient agrees to FP32 rounding); 0 on
// an axis where the point lies outside the unit cube (the clamp).
//
// What bounds it: the gathers, as in the march: 1024 bytes a point a pass
// from the 48.8 MB table (16 levels x 8 corners x 8 bytes), against 32 (or
// 12 + 128) bytes of points and features. Design: a thread per (point,
// level), 16 threads a point in a half-warp, so a point's 128 gathers go out
// from 16 lanes at once and a warp holds two points; the forward writes its
// level's two features as one 8-byte store (a point's 16 levels, 128
// contiguous bytes); the backward sums its level's 3 components and the
// half-warp adds them over the levels by shuffles, lane 0 writing the
// point's gradient.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace cnr {
namespace {

constexpr int kEncodeBlock = 256;

__global__ void __launch_bounds__(kEncodeBlock)
hash_encode_kernel(const float* __restrict__ pts, const float2* __restrict__ table,
                   const uint32_t* __restrict__ words, const float2* __restrict__ grad_features,
                   int n, float* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t p = idx / kHashMaxLevels;
  const int l = static_cast<int>(idx % kHashMaxLevels);
  const int levels = hash_levels(words);
  const bool live = p < n && l < levels;
  float d[3] = {0.f, 0.f, 0.f};
  if (live) {
    const float raw[3] = {hash_unit_raw(pts[3 * p], words), hash_unit_raw(pts[3 * p + 1], words),
                          hash_unit_raw(pts[3 * p + 2], words)};
    const float x = fminf(fmaxf(raw[0], 0.f), 1.f), y = fminf(fmaxf(raw[1], 0.f), 1.f),
                z = fminf(fmaxf(raw[2], 0.f), 1.f);
    const HashLevel lv = hash_level(words, l);
    if (grad_features == nullptr) {
      reinterpret_cast<float2*>(out)[p * levels + l] = hash_features(table, lv, x, y, z);
    } else {
      const HashCell c = hash_cell(table, lv, x, y, z);
      const float2 g = grad_features[p * levels + l];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float gv = fmaf(g.x, c.v[k].x, g.y * c.v[k].y);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int b0 = (a + 1) % 3, b1 = (a + 2) % 3;
          const float other = c.w[b0][(k >> b0) & 1] * c.w[b1][(k >> b1) & 1];
          d[a] = fmaf((k >> a) & 1 ? gv : -gv, other, d[a]);
        }
      }
      const float unit = lv.scale * __uint_as_float(__ldg(words + 5 * kHashMaxLevels + 1));
#pragma unroll
      for (int a = 0; a < 3; ++a)  // the clamp's gradient: 0 outside the unit cube
        d[a] = raw[a] >= 0.f && raw[a] <= 1.f ? d[a] * unit : 0.f;
    }
  }
  if (grad_features == nullptr) return;
  // the half-warp of point p adds its levels' components
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int off = kHashMaxLevels / 2; off > 0; off /= 2)
      d[a] += __shfl_xor_sync(0xffffffffu, d[a], off);
  if (l == 0 && p < n)
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * p + a] = d[a];
}

}  // namespace
}  // namespace cnr

// The features [n, 2L] of points [n, 3] (grad_features NULL), or the
// points' gradient [n, 3] from the features' gradient [n, 2L]. Returns a
// cudaError_t.
extern "C" int cnr_hash_encode(int device, const float* pts, const void* table,
                               const uint32_t* levels, const float* grad_features, int n,
                               float* out, void* stream) {
  if (pts == nullptr || table == nullptr || levels == nullptr || out == nullptr || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int64_t threads = static_cast<int64_t>(n) * cnr::kHashMaxLevels;
  const int grid = static_cast<int>((threads + cnr::kEncodeBlock - 1) / cnr::kEncodeBlock);
  cnr::hash_encode_kernel<<<grid, cnr::kEncodeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, static_cast<const float2*>(table), levels,
      reinterpret_cast<const float2*>(grad_features), n, out);
  return static_cast<int>(cudaGetLastError());
}
