// The step-cost experiment kernels X1-X3, with their C entries (bound with
// ctypes by kernels/build.py, wrapped by cudaneuralrender_torch/benchmarks/).
//
//   cnr_x1_loop      X1, benchmarks/exp_blockdiag.py::_loop_kernel (launched
//                    by chain): reps times x <- relu(W^T x + b) with one
//                    [H, H] weight, at H = 32 and 128
//   cnr_x2_stepcost  X2, benchmarks/exp_stepcost.py::make_kernel (launched by
//                    run_variant): a fixed-step march with no early exit,
//                    the chain alone (chain_only), with the state update
//                    (march_state) or with the coarse kernel's relax /
//                    budget / converged bookkeeping (march_relax), on the
//                    FP32 or the three-pass chain
//   cnr_x3_ablation  X3, benchmarks/exp_stepcost2.py::make_kernel (launched
//                    by run_variant): the ablation from a bare loop of
//                    products to the march chain (v0, v1, v2, v3) and the
//                    five- / six-pass bfloat16 emulations of FP32 (v5p, v5)
//
// Each takes a march step apart: every lane runs every step, so the time
// over lanes x steps is the cost of one lane-step of that piece. What bounds
// them: arithmetic, the chain's fused multiply-adds (chain.cuh), one lane
// per thread, 128 threads per block. The JAX scripts run each at the MXU's
// DEFAULT (one bfloat16 pass) and HIGHEST precisions; this card runs both as
// FP32 FFMA, as the march kernel does, so one kernel serves both names.
//
// Every output is summed from zero in input order with the bias last, as
// the plain versions' products (cuBLAS on the card) sum; X2 and X3 build
// the point o + d*t with one fused multiply-add (as the march kernel does)
// and contract the first layer over the 3 true inputs (the padded input's
// other rows are zeros, whose products add nothing). X2 and X3 are built at
// H = 32, the width of the nets the JAX scripts run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace cnr {
namespace {

constexpr int kBlock = 128;

// y = W^T x over all H inputs, each output from zero in input order; w in
// shared memory.
template <int H>
__device__ __forceinline__ void dense_regs(const float* __restrict__ w, const float (&x)[H],
                                           float (&y)[H]) {
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
}

// A zero the optimiser cannot see through, made anew at each call. Added to
// the weight's address inside a loop that multiplies by the same weight
// every iteration (X1, X3's v0), it keeps the loads in the loop, from shared
// memory, as the march kernel's chain reads each layer's weight: otherwise
// the compiler hoists the 1024 weights of a 32-wide layer into registers
// and spills (255 registers, 3.3 KB of spills per thread).
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}

// --------------------------------------------------------------------------
// X1. x [H, lanes], w [H, H], b [H] -> out [H, lanes]. At H = 32 the lane's
// x and the sums live in registers and the weight in shared memory; at 128
// the activations [2, H] live in local memory and each layer runs in chunks
// of kChunk outputs with the weight read from L1 / L2, as K1 runs the
// chain at those widths.
template <int H>
__global__ void __launch_bounds__(kBlock)
x1_loop_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, int lanes, int reps, float* __restrict__ out) {
  if constexpr (H == 32) {
    __shared__ float4 sw4[H * H / 4];
    __shared__ float sb[H];
    for (int k = threadIdx.x; k < H * H / 4; k += blockDim.x)
      sw4[k] = reinterpret_cast<const float4*>(w)[k];
    for (int k = threadIdx.x; k < H; k += blockDim.x) sb[k] = b[k];
    __syncthreads();
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= lanes) return;
    const float* sw = reinterpret_cast<const float*>(sw4);
    float v[H];
#pragma unroll
    for (int i = 0; i < H; ++i) v[i] = x[static_cast<int64_t>(i) * lanes + r];
#pragma unroll 1
    for (int rep = 0; rep < reps; ++rep) {
      float y[H];
      dense_regs<H>(sw + opaque_zero(), v, y);
#pragma unroll
      for (int o = 0; o < H; ++o) v[o] = fmaxf(__fadd_rn(y[o], sb[o]), 0.f);
    }
#pragma unroll
    for (int o = 0; o < H; ++o) out[static_cast<int64_t>(o) * lanes + r] = v[o];
  } else {
    static_assert(H % kChunk == 0, "the width must be a multiple of the chunk");
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= lanes) return;
    float act[2 * H];  // input at [cur, cur + H), output at the other half
    int cur = 0;
#pragma unroll 4
    for (int i = 0; i < H; ++i) act[i] = x[static_cast<int64_t>(i) * lanes + r];
#pragma unroll 1
    for (int rep = 0; rep < reps; ++rep) {
      const int nxt = H - cur;
#pragma unroll 1
      for (int c = 0; c < H; c += kChunk) {
        float acc[kChunk];
#pragma unroll
        for (int o = 0; o < kChunk; ++o) acc[o] = 0.f;
#pragma unroll 4
        for (int i = 0; i < H; ++i) fma_chunk(acc, act[cur + i], w + i * H + c);
#pragma unroll
        for (int o = 0; o < kChunk; ++o)
          act[nxt + c + o] = fmaxf(__fadd_rn(acc[o], __ldg(b + c + o)), 0.f);
      }
      cur = nxt;
    }
#pragma unroll 4
    for (int o = 0; o < H; ++o) out[static_cast<int64_t>(o) * lanes + r] = act[cur + o];
  }
}

template <int H>
int launch_x1(const float* x, const float* w, const float* b, int lanes, int reps, float* out,
              cudaStream_t stream) {
  const int grid = (lanes + kBlock - 1) / kBlock;
  x1_loop_kernel<H><<<grid, kBlock, 0, stream>>>(x, w, b, lanes, reps, out);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// X2 and X3 read one lane's ray: dirs [3, n], t0 [1, n], origin [3, 1].
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ dirs,
                                        const float* __restrict__ origin, int n, int r) {
  return Ray{origin[0], origin[1], origin[2], dirs[r], dirs[n + r],
             dirs[2 * static_cast<int64_t>(n) + r]};
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The chains X2 and X3 march on.
enum ChainKind : int { kFp32 = 0, kThreePassChain = 1, kFivePass = 2, kSixPass = 3 };

// The part of an activation's three-term bfloat16 split (split3): 0 = hi =
// bf16(x), 1 = mid = bf16(x - hi), 2 = lo = bf16((x - hi) - mid).
template <int kPart>
__device__ __forceinline__ float split3_part(float x) {
  const float hi = round_bf16(x);
  if constexpr (kPart == 0) return hi;
  const float r = __fsub_rn(x, hi);
  const float mid = round_bf16(r);
  if constexpr (kPart == 1) return mid;
  return round_bf16(__fsub_rn(r, mid));
}

// acc = sum over inputs i < n of part(x[i]) * w[i][o], from zero in input
// order; w is bfloat16 [., H] in shared memory.
template <int H, int NX, int kPart>
__device__ __forceinline__ void split_pass(float (&acc)[H], const float (&x)[NX], int n,
                                           const uint16_t* __restrict__ w) {
#pragma unroll
  for (int o = 0; o < H; ++o) acc[o] = 0.f;
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (i < n) fma_row_bf16<H>(acc, split3_part<kPart>(x[i]), w + i * H);
}

// One layer of the five- / six-pass chain (X3 v5p / v5) without its bias:
// the passes hi*hi, mid*hi, hi*mid, lo*hi, hi*lo (and mid*mid), each summed
// from zero in input order and added in that order, as exp_stepcost2.py's
// chain adds its bfloat16 products. Each product of two bfloat16 values is
// exact in float32. K2h's discipline (layer_3pass_regs) with three more
// passes; x may be out.
template <int H, int NX, bool kSix>
__device__ __forceinline__ void layer_split3_regs(const float (&x)[NX], int n,
                                                  const uint16_t* __restrict__ whi,
                                                  const uint16_t* __restrict__ wmid,
                                                  const uint16_t* __restrict__ wlo,
                                                  float (&out)[H]) {
  float y[H], t[H];
  split_pass<H, NX, 0>(y, x, n, whi);
  split_pass<H, NX, 1>(t, x, n, whi);
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = __fadd_rn(y[o], t[o]);
  split_pass<H, NX, 0>(t, x, n, wmid);
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = __fadd_rn(y[o], t[o]);
  split_pass<H, NX, 2>(t, x, n, whi);
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = __fadd_rn(y[o], t[o]);
  split_pass<H, NX, 0>(t, x, n, wlo);
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = __fadd_rn(y[o], t[o]);
  if constexpr (kSix) {
    split_pass<H, NX, 1>(t, x, n, wmid);
#pragma unroll
    for (int o = 0; o < H; ++o) y[o] = __fadd_rn(y[o], t[o]);
  }
#pragma unroll
  for (int o = 0; o < H; ++o) out[o] = y[o];
}

// Column 0 of the last layer, the same passes in the same order.
template <int H, bool kSix>
__device__ __forceinline__ float head_split3(const float (&x)[H], const uint16_t* __restrict__ whi,
                                             const uint16_t* __restrict__ wmid,
                                             const uint16_t* __restrict__ wlo, float bias) {
  float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float hi = split3_part<0>(x[i]), mid = split3_part<1>(x[i]);
    const float w_hi = bf16_low(whi[i * H]), w_mid = bf16_low(wmid[i * H]);
    d[0] = fmaf(hi, w_hi, d[0]);
    d[1] = fmaf(mid, w_hi, d[1]);
    d[2] = fmaf(hi, w_mid, d[2]);
    d[3] = fmaf(split3_part<2>(x[i]), w_hi, d[3]);
    d[4] = fmaf(hi, bf16_low(wlo[i * H]), d[4]);
    if constexpr (kSix) d[5] = fmaf(mid, w_mid, d[5]);
  }
  float y = d[0];
#pragma unroll
  for (int k = 1; k < (kSix ? 6 : 5); ++k) y = __fadd_rn(y, d[k]);
  return __fadd_rn(y, bias);
}

// The five- / six-pass chain's head value at a point, on the stack staged by
// stage_split3 (the hi, mid and lo halves, then the biases). Called rather
// than inlined, as K2h's chain is at H = 32.
template <int H, bool kSix>
__device__ __noinline__ float mlp_sdf_split3(int n_layers, float px, float py, float pz) {
  extern __shared__ float4 smem4[];
  const uint16_t* whi = reinterpret_cast<const uint16_t*>(smem4);
  const uint16_t* wmid = whi + n_layers * H * H;
  const uint16_t* wlo = wmid + n_layers * H * H;
  const float* b = reinterpret_cast<const float*>(wlo + n_layers * H * H);
  const float in[3] = {px, py, pz};
  float x[H];
  layer_split3_regs<H, 3, kSix>(in, 3, whi, wmid, wlo, x);
#pragma unroll
  for (int o = 0; o < H; ++o) x[o] = fmaxf(__fadd_rn(x[o], b[o]), 0.f);
  for (int l = 1; l < n_layers - 1; ++l) {
    layer_split3_regs<H, H, kSix>(x, H, whi + l * H * H, wmid + l * H * H, wlo + l * H * H, x);
#pragma unroll
    for (int o = 0; o < H; ++o) x[o] = fmaxf(__fadd_rn(x[o], b[l * H + o]), 0.f);
  }
  const int l = n_layers - 1;
  return head_split3<H, kSix>(x, whi + l * H * H, wmid + l * H * H, wlo + l * H * H, b[l * H]);
}

// Bytes of shared memory each chain kind stages at width H.
inline size_t x_smem_bytes(int kind, int h, int n_layers) {
  const size_t w = static_cast<size_t>(n_layers) * h * h, bias = sizeof(float) * n_layers * h;
  if (kind == kFp32) return sizeof(float) * w + bias;
  if (kind == kThreePassChain) return 2 * sizeof(uint16_t) * w + bias;
  return 3 * sizeof(uint16_t) * w + bias;
}

// The stack of a chain kind, staged in shared memory by every thread of the
// block: FP32 [L, H, H] (w0), the bfloat16 hi and lo halves (w0, w1), or
// the hi, mid and lo thirds (w0, w1, w2); the biases last.
template <int H, int kKind>
__device__ __forceinline__ void stage_x(const void* __restrict__ w0, const void* __restrict__ w1,
                                        const void* __restrict__ w2,
                                        const float* __restrict__ biases, int n_layers,
                                        const float*& w, const float*& b) {
  if constexpr (kKind == kFp32) {
    stage_weights<H>(static_cast<const float*>(w0), biases, n_layers, w, b);
  } else if constexpr (kKind == kThreePassChain) {
    stage_weights_3pass<H>(static_cast<const uint16_t*>(w0), static_cast<const uint16_t*>(w1),
                           biases, n_layers);
  } else {
    extern __shared__ float4 smem4[];
    uint4* s4 = reinterpret_cast<uint4*>(smem4);
    const int n_w8 = n_layers * H * H / 8;  // eight bfloat16 values per uint4
    const void* parts[3] = {w0, w1, w2};
#pragma unroll
    for (int p = 0; p < 3; ++p)
      for (int k = threadIdx.x; k < n_w8; k += blockDim.x)
        s4[p * n_w8 + k] = reinterpret_cast<const uint4*>(parts[p])[k];
    float* sb = reinterpret_cast<float*>(s4 + 3 * n_w8);
    for (int k = threadIdx.x; k < n_layers * H; k += blockDim.x) sb[k] = biases[k];
    __syncthreads();
    b = sb;
  }
}

// The SDF of one lane at t: the point o + d*t (one fused multiply-add), its
// coordinates rounded to bfloat16 when bf16_input is set (X2's act_dtype),
// through the chain of kind kKind.
template <int H, int kKind>
__device__ __forceinline__ float x_sdf(const Ray& ray, float t, bool bf16_input,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b, int n_layers) {
  float px = __fmaf_rn(ray.dx, t, ray.ox);
  float py = __fmaf_rn(ray.dy, t, ray.oy);
  float pz = __fmaf_rn(ray.dz, t, ray.oz);
  if (bf16_input) {
    px = round_bf16(px);
    py = round_bf16(py);
    pz = round_bf16(pz);
  }
  if constexpr (kKind == kFp32)
    return chain_sdf<H>(w, b, n_layers, 3, px, py, pz, 0.f);
  else if constexpr (kKind == kThreePassChain)
    return chain_sdf_3pass<H>(n_layers, 3, px, py, pz, 0.f);
  else
    return mlp_sdf_split3<H, kKind == kSixPass>(n_layers, px, py, pz);
}

// --------------------------------------------------------------------------
// X2: steps fixed steps of every lane, t_out [1, n].
enum StepCostVariant : int { kChainOnly = 0, kMarchState = 1, kMarchRelax = 2 };

template <int H, int kKind, int V>
__global__ void __launch_bounds__(kBlock)
x2_stepcost_kernel(const float* __restrict__ dirs, const float* __restrict__ t0,
                   const float* __restrict__ origin, const void* __restrict__ w0,
                   const void* __restrict__ w1, const float* __restrict__ biases,
                   int n_layers, int n, int steps, int bf16_input, float* __restrict__ t_out) {
  const float* w = nullptr;
  const float* b = nullptr;
  stage_x<H, kKind>(w0, w1, nullptr, biases, n_layers, w, b);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(dirs, origin, n, r);
  const bool bf16 = bf16_input != 0;
  float t = t0[r];
  if constexpr (V == kMarchRelax) {
    // The coarse kernel's bookkeeping (march.cuh) with no early exit: eps
    // 1e-6, omega 1.6, budget 3. The JAX kernel also carries each lane's
    // resolve step, which it never reads.
    float budget = 3.f, prev_r = 0.f, step_len = 0.f;
    bool active = true, conv = false;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const float d = x_sdf<H, kKind>(ray, t, bf16, w, b, n_layers);
      const bool act = active;
      const bool sor_fail = act && step_len > prev_r && __fadd_rn(d, prev_r) < step_len;
      const bool near = act && !sor_fail && d < 1e-6f;
      const float om = step_len < 0.f ? 1.f : 1.6f;
      const float stepv =
          sor_fail ? __fsub_rn(prev_r, step_len) : (near ? d : __fmul_rn(om, d));
      if (act) budget = __fsub_rn(budget, stepv);
      const bool miss = act && !sor_fail && budget <= 0.f;
      const bool moved = act && !miss;
      if (moved) t = __fadd_rn(t, stepv);
      const bool conv_now = moved && near;
      active = moved && !conv_now;
      conv = conv || conv_now;
      if (moved && !sor_fail) prev_r = d;
      if (moved) step_len = stepv;
    }
    t_out[r] = conv ? __fadd_rn(t, 1e-9f) : t;  // t + conv * 1e-9
  } else {
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const float d = x_sdf<H, kKind>(ray, t, bf16, w, b, n_layers);
      if constexpr (V == kChainOnly) {
        t = __fadd_rn(t, d);
      } else {  // kMarchState: act = d > -1e30; move unless near
        const bool act = d > -1e30f;
        if (act && !(d < 1e-6f)) t = __fadd_rn(t, d);
      }
    }
    t_out[r] = t;
  }
}

// --------------------------------------------------------------------------
// X3. v0-v2 carry the padded input x [H] through products (no point is
// rebuilt); v3, v5 and v5p carry t and add sdf(t) * kScale each step. The
// JAX script's 1e-8 keeps x bounded and t nearly still.
enum AblationVariant : int { kV0 = 0, kV1 = 1, kV2 = 2, kV3 = 3, kV5 = 5, kV5p = 6 };
constexpr float kScale = 1e-8f;

template <int H, int V>
__global__ void __launch_bounds__(kBlock)
x3_ablation_kernel(const float* __restrict__ dirs, const float* __restrict__ t0,
                   const float* __restrict__ origin, const void* __restrict__ w0,
                   const void* __restrict__ w1, const void* __restrict__ w2,
                   const float* __restrict__ biases, int n_layers, int n, int steps,
                   float* __restrict__ out) {
  constexpr int kKind = V == kV5 ? kSixPass : (V == kV5p ? kFivePass : kFp32);
  const float* w = nullptr;
  const float* b = nullptr;
  stage_x<H, kKind>(w0, w1, w2, biases, n_layers, w, b);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(dirs, origin, n, r);
  if constexpr (V == kV0 || V == kV1 || V == kV2) {
    float x[H];
#pragma unroll
    for (int i = 0; i < H; ++i) x[i] = 0.f;
    x[0] = __fmaf_rn(ray.dx, t0[r], ray.ox);
    x[1] = __fmaf_rn(ray.dy, t0[r], ray.oy);
    x[2] = __fmaf_rn(ray.dz, t0[r], ray.oz);
    if constexpr (V == kV0) {  // steps * n_layers products by the first layer's weight
#pragma unroll 1
      for (int k = 0; k < steps * n_layers; ++k) {
        float y[H];
        dense_regs<H>(w + opaque_zero(), x, y);
#pragma unroll
        for (int o = 0; o < H; ++o) x[o] = y[o];
      }
    } else {  // each step the n_layers weights (v2: with bias and ReLU), then x * kScale
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
#pragma unroll 1
        for (int l = 0; l < n_layers; ++l) {
          float y[H];
          dense_regs<H>(w + l * H * H, x, y);
#pragma unroll
          for (int o = 0; o < H; ++o) {
            float v = y[o];
            if constexpr (V == kV2) {
              v = __fadd_rn(v, b[l * H + o]);
              if (l + 1 < n_layers) v = fmaxf(v, 0.f);
            }
            x[o] = v;
          }
        }
#pragma unroll
        for (int o = 0; o < H; ++o) x[o] = __fmul_rn(x[o], kScale);
      }
    }
    out[r] = x[0];
  } else {
    float t = t0[r];
#pragma unroll 1
    for (int s = 0; s < steps; ++s)
      t = __fadd_rn(t,
                    __fmul_rn(x_sdf<H, kKind>(ray, t, false, w, b, n_layers), kScale));
    out[r] = t;
  }
}

template <typename Kernel>
cudaError_t prepare_x(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

template <int H, int kKind, int V>
int launch_x2(const float* dirs, const float* t0, const float* origin, const void* w0,
              const void* w1, const float* biases, int n_layers, int n, int steps,
              int bf16_input, float* t_out, cudaStream_t stream) {
  const size_t smem = x_smem_bytes(kKind, H, n_layers);
  const cudaError_t err = prepare_x(x2_stepcost_kernel<H, kKind, V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  x2_stepcost_kernel<H, kKind, V><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(
      dirs, t0, origin, w0, w1, biases, n_layers, n, steps, bf16_input, t_out);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int V>
int launch_x3(const float* dirs, const float* t0, const float* origin, const void* w0,
              const void* w1, const void* w2, const float* biases, int n_layers, int n,
              int steps, float* out, cudaStream_t stream) {
  constexpr int kKind = V == kV5 ? kSixPass : (V == kV5p ? kFivePass : kFp32);
  const size_t smem = x_smem_bytes(kKind, H, n_layers);
  const cudaError_t err = prepare_x(x3_ablation_kernel<H, V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  x3_ablation_kernel<H, V><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(
      dirs, t0, origin, w0, w1, w2, biases, n_layers, n, steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cnr

// X1: hidden 32 or 128; x, out [hidden, lanes], w [hidden, hidden], b [hidden].
extern "C" int cnr_x1_loop(int device, const float* x, const float* w, const float* b,
                           int hidden, int lanes, int reps, float* out, void* stream) {
  if ((hidden != 32 && hidden != 128) || lanes < 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hidden == 32 ? cnr::launch_x1<32>(x, w, b, lanes, reps, out, s)
                      : cnr::launch_x1<128>(x, w, b, lanes, reps, out, s);
}

// X2: variant 0 chain_only, 1 march_state, 2 march_relax; three_pass 0 (the
// FP32 stack in weights) or 1 (its bfloat16 hi and lo halves in weights and
// weights_lo); hidden 32.
extern "C" int cnr_x2_stepcost(int device, const float* dirs, const float* t0,
                               const float* origin, const void* weights,
                               const void* weights_lo, const float* biases, int n_layers,
                               int hidden, int variant, int three_pass, int bf16_input, int n,
                               int steps, float* t_out, void* stream) {
  using namespace cnr;
  if (hidden != 32 || n_layers < 2 || n < 0 || steps < 0 || (three_pass && !weights_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = int (*)(const float*, const float*, const float*, const void*, const void*,
                         const float*, int, int, int, int, float*, cudaStream_t);
  Launch launch = nullptr;
  switch (variant * 2 + (three_pass ? 1 : 0)) {
    case 0: launch = launch_x2<32, kFp32, kChainOnly>; break;
    case 1: launch = launch_x2<32, kThreePassChain, kChainOnly>; break;
    case 2: launch = launch_x2<32, kFp32, kMarchState>; break;
    case 3: launch = launch_x2<32, kThreePassChain, kMarchState>; break;
    case 4: launch = launch_x2<32, kFp32, kMarchRelax>; break;
    case 5: launch = launch_x2<32, kThreePassChain, kMarchRelax>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return launch(dirs, t0, origin, weights, weights_lo, biases, n_layers, n, steps, bf16_input,
                t_out, static_cast<cudaStream_t>(stream));
}

// X3: variant 0 v0, 1 v1, 2 v2, 3 v3, 5 v5, 6 v5p; weights the FP32 stack
// [n_layers, 32, 32] (v0-v3), or w_hi, w_mid, w_lo its bfloat16 thirds
// (v5, v5p); hidden 32.
extern "C" int cnr_x3_ablation(int device, const float* dirs, const float* t0,
                               const float* origin, const float* weights, const void* w_hi,
                               const void* w_mid, const void* w_lo, const float* biases,
                               int n_layers, int hidden, int variant, int n, int steps,
                               float* out, void* stream) {
  using namespace cnr;
  const bool split = variant == kV5 || variant == kV5p;
  if (hidden != 32 || n_layers < 2 || n < 0 || steps < 0 ||
      (split ? !(w_hi && w_mid && w_lo) : !weights))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  switch (variant) {
    case kV0: return launch_x3<32, kV0>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV1: return launch_x3<32, kV1>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV2: return launch_x3<32, kV2>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV3: return launch_x3<32, kV3>(dirs, t0, origin, weights, nullptr, nullptr, biases,
                                        n_layers, n, steps, out, s);
    case kV5: return launch_x3<32, kV5>(dirs, t0, origin, w_hi, w_mid, w_lo, biases, n_layers,
                                        n, steps, out, s);
    case kV5p: return launch_x3<32, kV5p>(dirs, t0, origin, w_hi, w_mid, w_lo, biases,
                                          n_layers, n, steps, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
