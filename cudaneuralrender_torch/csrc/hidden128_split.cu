// The ray-split mode of the FP32 chain at width 128: a ray per warp in each
// of the four CTAs of a thread-block cluster, the stack held on chip across
// the cluster (cluster::march_split_kernel<128, S, W>, launched by
// launch_march's split branch at H = 128: march_state's ray_lanes =
// kSplitLanes). It is named as the ray-split kernel at 32 and 64 is, in a
// namespace of its own: a profile counts both as the march.
//
// Replaces no TPU kernel: the JAX package marches a ray per lane of its
// Pallas kernel (pallas/megakernel.py::_march_megakernel), whose VMEM holds
// the whole stack. It exists because of this card's shared memory. The
// refine ladder's later rungs (the (32, 64) rung and the terminal one, run
// to dry) hold a few stragglers that march for hundreds to thousands of
// steps; a ray per thread (march_kernel<128, S, W, false>)
// then issues the 3xTF32 chain over all 32 rays of a straggler's warp every
// step and reads the stack from L2 once per m-tile and step (chain.cuh
// chain_tf32_smem). At 32 and 64 march_split_kernel marches such a ray on
// one warp from a stack staged in its block's shared memory; at 128 the
// stack (7 hidden layers of 128 x 128 FP32, 460.8 KB at 9 layers) exceeds
// one SM's 227 KB. A cluster of four CTAs holds it: CTA c keeps, transposed,
// output columns 32c .. 32c + 31 of every hidden layer (a row per output,
// split_stride(128) floats), and every CTA keeps the first layer, the head
// row and the biases: 147 KB at 9 layers, one CTA an SM.
//
// Design:
//   * a ray is warp w of each of the cluster's four CTAs (the ray slot w).
//     Every lane evaluates the first layer's 128 outputs of its point itself
//     (4 a lane, 3 or 4 inputs each: no exchange). In hidden layer l, lane j
//     of CTA c computes output 32c + j: its 128 products summed with fmaf in
//     input order from zero, the bias added last, the ReLU; the order of the
//     plain version's chain (megakernel.march_state_plain), as split_sdf
//     sums at 32 and 64. It stores the output into the ray's input row in
//     all four CTAs (distributed shared memory), and the warp's lane 0
//     arrives on the slot's mbarrier in each of them; the four warps of a ray
//     wait on their own CTA's, so rays never wait on each other (no barrier
//     of the whole cluster). The rows and barriers are double-buffered: an
//     exchange is written only after every CTA has sent the one before,
//     which each sent after reading the row the new one overwrites;
//   * every lane of the four warps computes the head from the full row, the
//     same sum in the same order, then compose and march_step on the same
//     values, so the four copies of the ray's state (t, steps, flags) agree
//     without an exchange and every branch is uniform across the slot's
//     128 lanes; CTA rank 0 writes the results;
//   * persistent rays: the grid is the clusters that fit on the card at
//     once (at most one a kClusterRays rays). A slot whose ray stops takes
//     the next active ray from a counter in device memory (the launch's
//     zeroed work word): rank 0's lane 0 takes it and hands it to the other
//     three CTAs through the same exchange. So a few deep rays hold their
//     own slots only, and the empty lanes of a sorted bucket are written
//     back once by the whole grid (entry state, resolve step = entry step).
// A ray's steps and results are those of the plain version bit for bit.
//
// What bounds it: the critical path of one step. At 9 layers a step is
// about 8 dependent chains of 128 fused multiply-adds (7 hidden layers and
// the head; the first layer's 4 are short) and 7 exchanges (a store and an
// arrive to each CTA of the cluster, then the wait), with zero weight bytes
// from L2 or device memory: on the H100 about 3.0 us of chains (1035
// dependent operations, 2.1 us at 4 cycles each) and 3.9 us of exchanges a
// step. Many rays at once are bound by each SM's shared-memory reads
// instead: a hidden layer reads its 16.5 KB slice of the stack once per ray
// and step (128 bytes a cycle), about a ray-step every 1000 cycles a CTA. kClusterRays = 16 slots a CTA: the (32, 64)
// rung's 8-21 thousand active rays marched in 16% less time than with 8,
// the terminal rung's few in the same time (H100, 12 poses at 1080p).
#include <stdint.h>

#include "march.cuh"

namespace cnr {
namespace cluster {

constexpr int kH = 128;
constexpr int kClusterCtas = 4;
constexpr int kOwn = kH / kClusterCtas;   // outputs of a layer a CTA computes
constexpr int kStride = split_stride(kH);  // floats a row of the transposed slice
constexpr int kClusterRays = 16;           // ray slots (warps) a CTA
constexpr int kClusterBlock = 32 * kClusterRays;
// Floats of a slot's rows: the first layer's outputs and two exchange rows.
constexpr int kSlotFloats = 3 * kH;

// Dynamic shared memory of a CTA at n_layers (stack_at's layout): the
// hidden layers' slices, the first layer [128][4], the head row, the biases
// [L][128], the slots' rows; then two mbarriers and two ray words a slot.
__host__ __device__ constexpr size_t cluster_smem(int n_layers) {
  return sizeof(float) * (static_cast<size_t>(n_layers > 2 ? n_layers - 2 : 0) * kOwn * kStride +
                          kH * 4 + kH + static_cast<size_t>(n_layers) * kH +
                          kClusterRays * kSlotFloats) +
         kClusterRays * 2 * sizeof(uint64_t) + kClusterRays * 2 * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster; orders what each did before.
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();  // the .aligned barrier: the warp's threads together
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// v into the word at local shared address a in CTA `rank` of the cluster.
__device__ __forceinline__ void store_at(uint32_t a, uint32_t rank, float v) {
  asm volatile("{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
               "st.shared::cluster.f32 [ra], %2;\n}" :: "r"(a), "r"(rank), "f"(v) : "memory");
}

__device__ __forceinline__ void store_at(uint32_t a, uint32_t rank, int v) {
  asm volatile("{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
               "st.shared::cluster.s32 [ra], %2;\n}" :: "r"(a), "r"(rank), "r"(v) : "memory");
}

// A relaxed arrival on the mbarrier at local shared address bar in CTA
// `rank` (exchange's fence gives the four of a warp their release).
__device__ __forceinline__ void arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile("{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
               "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [ra];\n}"
               :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}

// Wait, with acquire at cluster scope, until this CTA's mbarrier at bar has
// completed the phase of the given parity. A wait lasts at most a step of
// the other CTAs' march; one of kWaitLimitNs means the exchange protocol
// broke, and the launch fails (a trap) instead of holding the card.
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t since = 0;
  for (;;) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (since == 0) since = now;
    else if (now - since > kWaitLimitNs) __trap();
  }
}

// One exchange of the slot: each lane has stored its part into every CTA's
// row (or rank 0's lane 0 the ray word); the warp's arrival on the exchange's
// barrier in each CTA, then the wait on this CTA's. k counts the slot's
// exchanges: barrier k & 1, its (k >> 1)-th phase. Lane 0 releases the
// warp's stores and reads with one fence at cluster scope before its four
// relaxed arrivals; four arrivals with release semantics, each its own
// fence, made a step of the terminal rung's deepest ray take 14.2 us on the
// H100 against 6.9 us.
__device__ __forceinline__ void exchange(uint32_t bars, uint32_t& k) {
  const uint32_t bar = bars + (k & 1) * 8u;
  __syncwarp();  // the warp's stores, and its reads of the rows, before the arrival
  if ((threadIdx.x & 31) == 0) {
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
#pragma unroll
    for (uint32_t q = 0; q < kClusterCtas; ++q) arrive_at(bar, q);
  }
  wait_phase(bar, (k >> 1) & 1);
  ++k;
}

// Sum_i x[i] * w[i] over the 128 inputs with fmaf in input order from zero,
// both rows read as 16-byte loads from shared memory.
__device__ __forceinline__ float dot_row(const float* x, const float* w) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float y = 0.f;
#pragma unroll
  for (int q = 0; q < kH / 4; ++q) {
    const float4 a = x4[q], b = w4[q];
    y = fmaf(a.x, b.x, y);
    y = fmaf(a.y, b.y, y);
    y = fmaf(a.z, b.z, y);
    y = fmaf(a.w, b.w, y);
  }
  return y;
}

// The shared memory of a CTA (cluster_smem's layout).
struct Stack {
  float* hid;          // [(L - 2) * kOwn][kStride]: row (l - 1) * kOwn + j = W[l][:, 32c + j]
  float* first;        // [kH][4]: W[0][i][o] at o * 4 + i
  float* head;         // [kH]: W[L - 1][i][0]
  float* bias;         // [L][kH]
  float* rows;         // [kClusterRays][kSlotFloats]
  uint64_t* bars;      // [kClusterRays][2]
  int* rays;           // [kClusterRays][2]
};

__device__ __forceinline__ Stack stack_at(float* smem, int n_layers) {
  Stack s;
  float* hid = smem;
  float* first = hid + static_cast<size_t>(n_layers > 2 ? n_layers - 2 : 0) * kOwn * kStride;
  float* head = first + kH * 4;
  float* bias = head + kH;
  float* rows = bias + static_cast<size_t>(n_layers) * kH;
  s.hid = hid;
  s.first = first;
  s.head = head;
  s.bias = bias;
  s.rows = rows;
  s.bars = reinterpret_cast<uint64_t*>(rows + kClusterRays * kSlotFloats);
  s.rays = reinterpret_cast<int*>(s.bars + kClusterRays * 2);
  return s;
}

// The raw head value at point p for the ray of this warp's slot, the rows
// exchanged across the cluster (k: the slot's exchange count).
__device__ __forceinline__ float cluster_sdf(const Stack& s, float* row0, uint32_t xrows,
                                             uint32_t bars, uint32_t rank, int n_layers,
                                             int n_inputs, float px, float py, float pz,
                                             float frame, uint32_t& k) {
  const int lane = threadIdx.x & 31;
  const float in[4] = {px, py, pz, frame};
  if (n_layers == 1) {  // the head is the first layer: output 0
    const float4 w = *reinterpret_cast<const float4*>(s.first);
    const float wi[4] = {w.x, w.y, w.z, w.w};
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) d = fmaf(in[i], wi[i], d);
    return __fadd_rn(d, s.bias[0]);
  }
  __syncwarp();  // every lane has read the row's last inputs
#pragma unroll
  for (int q = 0; q < kH / 32; ++q) {
    const int o = lane + 32 * q;
    const float4 w = *reinterpret_cast<const float4*>(s.first + o * 4);
    const float wi[4] = {w.x, w.y, w.z, w.w};
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_inputs) v = fmaf(in[i], wi[i], v);
    row0[o] = fmaxf(__fadd_rn(v, s.bias[o]), 0.f);
  }
  __syncwarp();
  const float* x = row0;
  const int o = static_cast<int>(rank) * kOwn + lane;
  for (int l = 1; l < n_layers - 1; ++l) {
    const float y = fmaxf(
        __fadd_rn(dot_row(x, s.hid + static_cast<size_t>((l - 1) * kOwn + lane) * kStride),
                  s.bias[l * kH + o]),
        0.f);
    const uint32_t dst = xrows + (k & 1) * (kH * 4u) + static_cast<uint32_t>(o) * 4u;
#pragma unroll
    for (uint32_t q = 0; q < kClusterCtas; ++q) store_at(dst, q, y);
    x = row0 + kH + (k & 1) * kH;  // the row dst names, in this CTA
    exchange(bars, k);
  }
  return __fadd_rn(dot_row(x, s.head), s.bias[(n_layers - 1) * kH]);
}

// The kernel's arguments are cnr::march_split_kernel's, and work: [1]
// int32, zero at launch, the index of the next ray a slot takes.
template <int H, int S, int W>
__global__ void __cluster_dims__(kClusterCtas, 1, 1) __launch_bounds__(kClusterBlock, 1)
march_split_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
                           const float* __restrict__ t0, const float* __restrict__ budget0,
                           const uint8_t* __restrict__ active0,
                           const int32_t* __restrict__ steps0,
                           const float* __restrict__ weights, const float* __restrict__ biases,
                           int n_layers, int n_inputs, const float* __restrict__ frame_ptr,
                           int n, int max_steps, int num_steps, float eps, float omega,
                           float* __restrict__ t_out, float* __restrict__ budget_out,
                           uint8_t* __restrict__ active_out, uint8_t* __restrict__ conv_out,
                           int32_t* __restrict__ steps_out, int32_t* __restrict__ work) {
  static_assert(H == kH, "the cluster's ray-split chain runs at width 128");
  const int start = *steps0;
  // The entry state back for the rays inactive at entry, by the whole grid.
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n; q += gridDim.x * blockDim.x) {
    if (active0[q] == 0) {
      t_out[q] = t0[q];
      budget_out[q] = budget0[q];
      active_out[q] = 0;
      conv_out[q] = 0;
      steps_out[q] = start;
    }
  }

  extern __shared__ float4 smem4[];
  const Stack s = stack_at(reinterpret_cast<float*>(smem4), n_layers);
  const uint32_t rank = cluster_rank();
  // Hidden layer l + 1's columns 32c .. 32c + 31, transposed; a warp reads
  // 32 consecutive weights of one input row.
  const int hidden = n_layers > 2 ? n_layers - 2 : 0;
  for (int e = threadIdx.x; e < hidden * kH * kOwn; e += blockDim.x) {
    const int j = e % kOwn, i = (e / kOwn) % kH, l = e / (kOwn * kH);
    s.hid[static_cast<size_t>(l * kOwn + j) * kStride + i] =
        weights[(static_cast<size_t>(l + 1) * kH + i) * kH + rank * kOwn + j];
  }
  for (int e = threadIdx.x; e < kH * 4; e += blockDim.x)
    s.first[e] = weights[(e % 4) * kH + e / 4];
  if (n_layers >= 2)
    for (int e = threadIdx.x; e < kH; e += blockDim.x)
      s.head[e] = weights[(static_cast<size_t>(n_layers - 1) * kH + e) * kH];
  for (int e = threadIdx.x; e < n_layers * kH; e += blockDim.x) s.bias[e] = biases[e];
  if (threadIdx.x < 2 * kClusterRays) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(s.bars + threadIdx.x)), "r"(kClusterCtas) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's stack and barriers ready before any exchange

  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  float* row0 = s.rows + slot * kSlotFloats;
  const uint32_t xrows = smem_addr(row0 + kH);
  const uint32_t bars = smem_addr(s.bars + 2 * slot);
  const int* rays = s.rays + 2 * slot;
  const uint32_t ray_words = smem_addr(rays);
  const float frame = __ldg(frame_ptr);  // as march_kernel reads it
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const bool relax = omega > 1.f;
  uint32_t k = 0;
  for (;;) {
    // The hand-off: rank 0's lane 0 takes the next active ray (-1: none).
    const uint32_t b = k & 1;
    if (rank == 0 && lane == 0) {
      int r;
      do {
        r = atomicAdd(work, 1);
      } while (r < n && active0[r] == 0);
      r = r < n ? r : -1;
#pragma unroll
      for (uint32_t q = 0; q < kClusterCtas; ++q) store_at(ray_words + b * 4u, q, r);
    }
    exchange(bars, k);
    const int r = rays[b];
    if (r < 0) break;

    const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
    float t = t0[r];
    float budget = budget0[r];
    bool act = true;
    bool conv = false;
    int step = start;
    int res = start;
    float prev_r = 0.f, step_len = 0.f;
    while (act && step < max_steps && (num_steps < 0 || step - start < num_steps)) {
      const float px = __fmaf_rn(dx, t, ox);
      const float py = __fmaf_rn(dy, t, oy);
      const float pz = __fmaf_rn(dz, t, oz);
      const float raw = cluster_sdf(s, row0, xrows, bars, rank, n_layers, n_inputs, px, py, pz,
                                    frame, k);
      march_step<S, W>(px, py, pz, raw, frame, relax, eps, omega, t, budget, prev_r, step_len,
                       conv, act, step, res);
    }
    if (rank == 0 && lane == 0) {
      t_out[r] = t;
      budget_out[r] = budget;
      active_out[r] = act ? 1 : 0;
      conv_out[r] = conv ? 1 : 0;
      steps_out[r] = act ? step : res;
    }
  }
  cluster_sync();  // no CTA leaves while another may still address its shared memory
}

}  // namespace cluster

namespace {

using ClusterKernel = void (*)(const float*, const float*, const float*, const float*,
                               const uint8_t*, const int32_t*, const float*, const float*, int,
                               int, const float*, int, int, int, float, float, float*, float*,
                               uint8_t*, uint8_t*, int32_t*, int32_t*);

// The instantiation for a scene id and cylinder window (pick_split_kernel's
// set), or nullptr.
ClusterKernel pick_cluster_kernel(int scene, int window) {
  if (window != 1 && window != 3 && window != 5) return nullptr;
  using cluster::march_split_kernel;
  switch (scene) {
    case kNeuralRaw: return march_split_kernel<128, kNeuralRaw, 0>;
    case kNeuralTanh: return march_split_kernel<128, kNeuralTanh, 0>;
    case kManySphere: return march_split_kernel<128, kManySphere, 0>;
    case kManySphereCut: return march_split_kernel<128, kManySphereCut, 0>;
    case kManyCylinderCut:
      if (window == 1) return march_split_kernel<128, kManyCylinderCut, 1>;
      if (window == 3) return march_split_kernel<128, kManyCylinderCut, 3>;
      return march_split_kernel<128, kManyCylinderCut, 5>;
    case kDisplacement: return march_split_kernel<128, kDisplacement, 0>;
    default: return nullptr;
  }
}

}  // namespace

size_t split_cluster_smem_bytes(int n_layers) { return cluster::cluster_smem(n_layers); }

int launch_march_split128(const MarchArgs& a, cudaStream_t stream) {
  using namespace cluster;
  const ClusterKernel kernel = pick_cluster_kernel(a.scene, a.window);
  if (kernel == nullptr || a.work == nullptr || a.n_layers > kSplitClusterMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cluster_smem(a.n_layers);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterCtas, 1, 1);
  config.blockDim = dim3(kClusterBlock, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int wanted = (a.n + kClusterRays - 1) / kClusterRays;
  if (wanted < clusters) clusters = wanted;
  kernel<<<clusters * kClusterCtas, kClusterBlock, smem, stream>>>(
      a.dirs, a.origin, a.t0, a.budget0, a.active0, a.steps0,
      static_cast<const float*>(a.weights), a.biases, a.n_layers, a.n_inputs, a.frame, a.n,
      a.max_steps, a.num_steps, a.eps, a.omega, a.t_out, a.budget_out, a.active_out,
      a.conv_out, a.steps_out, a.work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cnr
