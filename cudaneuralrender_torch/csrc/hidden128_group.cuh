// The march kernel a ray per thread at hidden width 128, for both chains
// (the FP32 3xTF32 one and the three-pass one, K2h): a block's group of
// kGroupRays rays marches together, and the block's warps split each
// layer's columns over the group's activations in shared memory
// (group::march_kernel<128, S, W, kThreePass>, which pick_kernel<128, *>
// returns for every scene and window). csrc/hidden128.cu and
// hidden128_3pass.cu, the 128-wide units, compile it; it is named as
// march.cuh's march_kernel, in a namespace of its own, so a profile counts
// both as the march. Widths 32 and 64 (activations in registers) and 256 to
// 1024 keep march.cuh's kernel on chain.cuh's per-warp chains.
//
// What it replaces: at this width, march.cuh's march_kernel on
// chain_tf32_smem and chain_3pass_smem, the card's form of the JAX
// package's pallas/megakernel.py::_march_megakernel with
// pallas/fused_mlp.py::_mlp_chain and _mlp_chain_3pass. There each warp
// runs the chain for its own 32 rays, its two m16 tiles in turn, and reads
// the whole stack from L2 for each: one fetch of every weight fragment per
// 16 rays and step. Both stacks take 4 bytes a weight at 128 (467 KB at 9
// layers), so a ray-step fetched 29 KB for 230,400 FLOPs: 24 tensor-core
// FLOPs a byte with the three passes counted, where L2's 8.49 TB/s needs
// about 58 (3xTF32 at 495 TFLOP/s) or 116 (three-pass bf16 at 989) to keep
// the tensor cores fed; and each fragment fed one m-tile's MMAs, too few to
// hide L2's latency, so the FP32 rung ran slower than even its FP32 FFMA
// bound (PERF.md).
//
// What bounds it now: a fragment fetched from L2 serves the group's
// kGroupRays rays, so a ray-step fetches 467 KB / kGroupRays (7.3 KB at
// 64). The FP32 chain is then bound by issue: each k-chunk's 48 MMAs a
// warp come with about 280 other instructions (the A and B splits, and
// each chunk sum's rounding to even and its add, which the bit equality
// with the per-warp chains keeps). The three-pass chain issues few beside
// its MMAs, and its B fetches and A reads from shared memory, at 12 warps
// an SM, bound it. 128-ray groups halve the fetches but hold 8 warps an SM
// (or 4, which spill): they ran slower on the card (PERF.md).
//
// Design:
//   * a block of kGroupBlock threads, a ray each, holds kGroupBlock /
//     kGroupRays groups of consecutive rays, which take turns through one
//     pair of shared-memory buffers [kGroupRays, act_words(128)], a layer's
//     input and its output, in chain.cuh's row layout (FP32 values, or the
//     three-pass chain's (hi, lo) bf16x2 pairs);
//   * warp w computes n-tiles [w kWarpTiles, (w + 1) kWarpTiles) of each
//     layer for all of the group's m-tiles: it fetches each B fragment of
//     its columns from L2 once per group and step, splits it once, and
//     applies it to every m-tile. The three-pass chain fetches it a k-chunk
//     ahead; the FP32 chain, which holds each pair split too, spilled when
//     it fetched ahead, and ran no slower without (PERF.md). A block barrier separates
//     the layers. The head (n-tile 0) is split across the warps by m-tile,
//     its values handed to the rays' threads through shared memory;
//   * each output column is still summed by one warp over the k-chunks in
//     chain.cuh's order, with its splits (split_tf32, split_bf16x2) and MMA
//     sequences (mma_3xtf32_split, mma_3pass), and the first layer reads
//     the points from the input buffer's first 8 columns as the per-warp
//     chains' A fragments held them: t, budget, the flags and the steps
//     equal the per-warp kernel's bit for bit;
//   * the loop is block-uniform: it runs while any ray of the block
//     marches, and a group whose rays all wait skips its chain, so the
//     lockstep unit is the group (megakernel.SHARED_GROUP counts its
//     slots). march_step runs only where the thread's own ray goes, so a
//     ray's steps and state are those of a per-ray loop; rays that do not
//     march pass a finite point (rows do not mix);
//   * the ray's state, and the rays' origin, wait in shared memory while the
//     chains run: held in registers across them, they left ptxas too few
//     under the 168 that 3 blocks an SM allow, and both chains spilled up to
//     88 B; now three of the 16 instantiations spill 8 B (PERF.md).
#pragma once

#include "march.cuh"

namespace cnr {
namespace group {

constexpr int kH = 128;
constexpr int kNT = kH / 8;                     // n-tiles of a layer
constexpr int kWarps = kGroupBlock / 32;
constexpr int kGroups = kGroupBlock / kGroupRays;
constexpr int kTilesM = kGroupRays / 16;        // m-tiles of a group
constexpr int kWarpTiles = kNT / kWarps;        // n-tiles of a layer a warp computes
constexpr int kS = act_words(kH);               // 4-byte words a row of a buffer
constexpr int kBuf = kGroupRays * kS;           // words a buffer
// Blocks an SM holds by their shared memory (227 KB, 1 KB of it reserved a
// block): the launch bound that caps the registers.
constexpr int kMinBlocks = static_cast<int>((227 * 1024) / (group_smem_bytes() + 1024));
static_assert(kGroupBlock % kGroupRays == 0 && kGroupRays % 32 == 0 && kGroups <= 32,
              "a block holds whole groups of whole warps");
static_assert(kNT % kWarps == 0, "the warps split a layer's n-tiles evenly");
static_assert(kMinBlocks >= 1, "a block's buffers fit an SM");

// Ray `row`'s point into row `row` of the group's input buffer, columns 0-7
// (x, y, z, the frame or 0, then zeros): the first layer's one k-chunk, as
// inputs_a_tf32 (FP32) and inputs_a (three-pass, the (hi, lo) pairs split
// as split_bf16x2 splits them) build its A fragments.
template <bool kThreePass>
__device__ __forceinline__ void put_point(float* in, int row, float px, float py, float pz,
                                          float pf) {
  if constexpr (kThreePass) {
    uint4* p = reinterpret_cast<uint4*>(in + row * kS);  // 8 (hi, lo) pairs, 16 columns
    uint32_t hi0, lo0, hi1, lo1;
    split_bf16x2(px, py, hi0, lo0);
    split_bf16x2(pz, pf, hi1, lo1);
    p[0] = make_uint4(hi0, lo0, hi1, lo1);
    p[1] = p[2] = p[3] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    float4* p = reinterpret_cast<float4*>(in + row * kS);
    p[0] = make_float4(px, py, pz, pf);
    p[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// This warp's n-tiles of one layer (l < n_layers - 1) of the FP32 chain for
// the group: out = ReLU(in * W_l + b_l) on 3xTF32, over the first kin
// k-chunks of `in` (1 for the first layer: the points); wl: the layer's
// stack in tf32 fragment order [H/8, H/8, 32] float2 pairs.
__device__ __forceinline__ void layer_tf32(const float* __restrict__ in, int kin,
                                           const float2* __restrict__ wl,
                                           const float* __restrict__ bl, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * kWarpTiles;
  float acc[kTilesM][kWarpTiles][4];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m)
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < kin; ++kk) {
    uint32_t bbig[kWarpTiles][2], bsmall[kWarpTiles][2];
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j) {
      const float2 bv = __ldg(wl + (kk * kNT + n0 + j) * 32 + lane);
      split_tf32(bv.x, bbig[j][0], bsmall[j][0]);
      split_tf32(bv.y, bbig[j][1], bsmall[j][1]);
    }
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
      uint32_t abig[4], asmall[4];
      load_a_tf32<kH>(in + m * 16 * kS, kk, abig, asmall);
      mma_3xtf32_split(acc[m], abig, asmall, bbig, bsmall);
    }
  }
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    const int col = 8 * (n0 + j) + 2 * t;
    const float b0 = __ldg(bl + col), b1 = __ldg(bl + col + 1);
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
      float* o = out + (16 * m + g) * kS + col;
      *reinterpret_cast<float2*>(o) = make_float2(fmaxf(__fadd_rn(acc[m][j][0], b0), 0.f),
                                                  fmaxf(__fadd_rn(acc[m][j][1], b1), 0.f));
      *reinterpret_cast<float2*>(o + 8 * kS) = make_float2(
          fmaxf(__fadd_rn(acc[m][j][2], b0), 0.f), fmaxf(__fadd_rn(acc[m][j][3], b1), 0.f));
    }
  }
}

// The same layer of the three-pass chain: out = split(ReLU(in * W_l + b_l)),
// in and out of (hi, lo) pairs; wl: the layer's stack in bf16 fragment
// order [H/16, H/8, 32] uint4.
__device__ __forceinline__ void layer_3pass(const uint2* __restrict__ in, int kin,
                                            const uint4* __restrict__ wl,
                                            const float* __restrict__ bl, uint2* __restrict__ out) {
  constexpr int S = act_pairs(kH);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * kWarpTiles;
  float acc[kTilesM][kWarpTiles][4];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m)
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  uint4 bnext[kWarpTiles];  // B fragments a k-chunk ahead
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) bnext[j] = __ldg(wl + (n0 + j) * 32 + lane);
#pragma unroll 1
  for (int kk = 0; kk < kin; ++kk) {
    uint4 bnow[kWarpTiles];
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j) {
      bnow[j] = bnext[j];
      if (kk + 1 < kin) bnext[j] = __ldg(wl + ((kk + 1) * kNT + n0 + j) * 32 + lane);
    }
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
      uint32_t ahi[4], alo[4];
      load_a<kH>(in + m * 16 * S, kk, ahi, alo);
      mma_3pass(acc[m], ahi, alo, bnow);
    }
  }
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    const int col = 8 * (n0 + j) + 2 * t;
    const float b0 = __ldg(bl + col), b1 = __ldg(bl + col + 1);
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
      uint2 r0, r1;
      split_bf16x2(fmaxf(__fadd_rn(acc[m][j][0], b0), 0.f),
                   fmaxf(__fadd_rn(acc[m][j][1], b1), 0.f), r0.x, r0.y);
      split_bf16x2(fmaxf(__fadd_rn(acc[m][j][2], b0), 0.f),
                   fmaxf(__fadd_rn(acc[m][j][3], b1), 0.f), r1.x, r1.y);
      out[(16 * m + g) * S + 4 * (n0 + j) + t] = r0;
      out[(16 * m + g + 8) * S + 4 * (n0 + j) + t] = r1;
    }
  }
}

// The head (n-tile 0 of the last layer, no bias yet) of m-tiles m = w,
// w + kWarps, ... of the group, warp w, over the first kin k-chunks of
// `in`: each row's value into head[row]. wh: the layer's n-tile 0 at this
// lane's B fragment.
template <bool kThreePass>
__device__ __forceinline__ void group_head(const float* __restrict__ in, int kin,
                                           const void* __restrict__ wh, float* __restrict__ head) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int m = threadIdx.x >> 5; m < kTilesM; m += kWarps) {
    float h[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    if constexpr (kThreePass) {
      const uint4* w = static_cast<const uint4*>(wh);
      const uint2* a = reinterpret_cast<const uint2*>(in) + m * 16 * act_pairs(kH);
#pragma unroll 1
      for (int kk = 0; kk < kin; ++kk) {
        uint32_t ahi[4], alo[4];
        load_a<kH>(a, kk, ahi, alo);
        const uint4 wv[1] = {__ldg(w + kk * kNT * 32)};
        mma_3pass(h, ahi, alo, wv);
      }
    } else {
      const float2* w = static_cast<const float2*>(wh);
      float2 wnext = __ldg(w);
#pragma unroll 1
      for (int kk = 0; kk < kin; ++kk) {
        uint32_t abig[4], asmall[4];
        load_a_tf32<kH>(in + m * 16 * kS, kk, abig, asmall);
        const float2 wv[1] = {wnext};
        if (kk + 1 < kin) wnext = __ldg(w + (kk + 1) * kNT * 32);
        mma_3xtf32_rows(h, abig, asmall, wv);
      }
    }
    if (t == 0) {  // column 0: row g in c0, row g + 8 in c2
      head[16 * m + g] = h[0][0];
      head[16 * m + g + 8] = h[0][2];
    }
  }
}

// The chain for one group, every thread of the block together: from the
// points in buffer 0 (put_point) through the layers, buffers alternating,
// to each row's head value (no bias) in head[row]; w: the stack in tf32
// (FP32) or bf16 (three-pass) fragment order, read from L2.
template <bool kThreePass>
__device__ __forceinline__ void group_chain(const void* __restrict__ w,
                                            const float* __restrict__ b, int n_layers,
                                            float* act, float* head) {
  // 8-byte units (a tf32 B pair, or half a bf16 hi / lo fragment) of a
  // layer's stack and of a lane's B fragment
  constexpr int kUnits = kThreePass ? 2 : 1;
  constexpr int KT = kThreePass ? kH / 16 : kH / 8;
  const size_t layer_units = static_cast<size_t>(KT) * kNT * 32 * kUnits;
  const float2* w2 = static_cast<const float2*>(w);
#pragma unroll 1
  for (int l = 0; l < n_layers - 1; ++l) {
    const float* in = act + (l & 1) * kBuf;
    float* out = act + ((l + 1) & 1) * kBuf;
    const int kin = l == 0 ? 1 : KT;
    if constexpr (kThreePass)
      layer_3pass(reinterpret_cast<const uint2*>(in), kin,
                  reinterpret_cast<const uint4*>(w2 + l * layer_units), b + l * kH,
                  reinterpret_cast<uint2*>(out));
    else
      layer_tf32(in, kin, w2 + l * layer_units, b + l * kH, out);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  group_head<kThreePass>(act + ((n_layers - 1) & 1) * kBuf, n_layers == 1 ? 1 : KT,
                         w2 + (n_layers - 1) * layer_units + lane * kUnits, head);
}

// The kernel, with march.cuh's march_kernel's arguments (table and levels
// unread: the hash-grid SDF runs at width 64) and its per-ray semantics.
template <int H, int S, int W, bool kThreePass>
__global__ void __launch_bounds__(kGroupBlock, kMinBlocks)
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
  static_assert(H == kH, "the group march runs at width 128");
  const float frame = __ldg(frame_ptr);  // as march.cuh's march_kernel reads it
  const int r = blockIdx.x * kGroupBlock + threadIdx.x;
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
  const float pf = n_inputs == 4 ? frame : 0.f;

  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);                     // [2][kGroupRays][kS]
  float* head = buf + 2 * kBuf;                                     // [kGroupBlock]
  uint32_t* marching = reinterpret_cast<uint32_t*>(head + kGroupBlock);  // [kWarps] ballots
  // The ray's state waits in its thread's column of shared memory while the
  // chains run, which need the registers: t, budget, prev_r, step_len, the
  // direction, then step, res and the flags (1 active, 2 converged).
  constexpr int B = kGroupBlock;
  static_assert(kGroupStateWords == 10, "the state's words");
  float* sf = reinterpret_cast<float*>(marching + kWarps);  // [7][B]
  int* si = reinterpret_cast<int*>(sf + 7 * B);              // [3][B]
  float* so = reinterpret_cast<float*>(si + 3 * B);          // [3] the origin, every ray's
  const int me = threadIdx.x;
  sf[4 * B + me] = dx, sf[5 * B + me] = dy, sf[6 * B + me] = dz;
  if (me < 3) so[me] = pos != nullptr ? c2w[4 * me + 3] : origin[me];
  auto save = [&]() {
    sf[me] = t, sf[B + me] = budget, sf[2 * B + me] = prev_r, sf[3 * B + me] = step_len;
    si[me] = step, si[B + me] = res, si[2 * B + me] = (act ? 1 : 0) | (conv ? 2 : 0);
  };
  auto load = [&]() {
    t = sf[me], budget = sf[B + me], prev_r = sf[2 * B + me], step_len = sf[3 * B + me];
    step = si[me], res = si[B + me];
    act = (si[2 * B + me] & 1) != 0, conv = (si[2 * B + me] & 2) != 0;
  };
  // The point o + d t, one fused multiply-add a coordinate, from the state
  // in shared memory (a ray out of range marches nowhere: any finite point).
  auto point = [&](float& px, float& py, float& pz) {
    const float tt = sf[me];
    px = __fmaf_rn(sf[4 * B + me], tt, so[0]);
    py = __fmaf_rn(sf[5 * B + me], tt, so[1]);
    pz = __fmaf_rn(sf[6 * B + me], tt, so[2]);
  };
  save();  // the loop's first barrier shows every thread the origin

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = threadIdx.x / kGroupRays, row = threadIdx.x % kGroupRays;
  for (;;) {
    const int now = si[me];
    const bool go = (si[2 * B + me] & 1) && now < max_steps &&
                    (num_steps < 0 || now - start < num_steps);
    const uint32_t ballot = __ballot_sync(0xffffffffu, go);
    if (lane == 0) marching[warp] = ballot;
    __syncthreads();
    uint32_t groups = 0;  // bit q: a ray of group q marches
#pragma unroll
    for (int k = 0; k < kWarps; ++k)
      if (marching[k] != 0u) groups |= 1u << (k * 32 / kGroupRays);
    if (groups == 0u) break;
#pragma unroll 1
    for (int q = 0; q < kGroups; ++q) {
      if (((groups >> q) & 1u) == 0u) continue;
      if (mine == q) {
        float px, py, pz;
        point(px, py, pz);
        put_point<kThreePass>(buf, row, px, py, pz, pf);
      }
      __syncthreads();
      group_chain<kThreePass>(weights, biases, n_layers, buf, head + q * kGroupRays);
      __syncthreads();  // the head's values out; the buffers free for the next group
    }
    if (go) {
      load();
      float px, py, pz;
      point(px, py, pz);
      const float raw = __fadd_rn(head[threadIdx.x], __ldg(biases + (n_layers - 1) * kH));
      march_step<S, W>(px, py, pz, raw, frame, relax, eps, omega, t, budget, prev_r, step_len,
                       conv, act, step, res);
      save();
    }
  }
  if (!in_range) return;
  load();

  t_out[r] = t;
  budget_out[r] = budget;
  active_out[r] = act ? 1 : 0;
  conv_out[r] = conv ? 1 : 0;
  steps_out[r] = act ? step : res;
}

}  // namespace group

// The group march's instantiation for a chain, scene id and cylinder
// window, or nullptr (march.cuh pick_kernel at H = 128).
template <bool kThreePass>
MarchKernel pick_group_kernel(int scene, int window) {
  if (window != 1 && window != 3 && window != 5) return nullptr;
  switch (scene) {
    case kNeuralRaw: return group::march_kernel<128, kNeuralRaw, 0, kThreePass>;
    case kNeuralTanh: return group::march_kernel<128, kNeuralTanh, 0, kThreePass>;
    case kManySphere: return group::march_kernel<128, kManySphere, 0, kThreePass>;
    case kManySphereCut: return group::march_kernel<128, kManySphereCut, 0, kThreePass>;
    case kManyCylinderCut:
      if (window == 1) return group::march_kernel<128, kManyCylinderCut, 1, kThreePass>;
      if (window == 3) return group::march_kernel<128, kManyCylinderCut, 3, kThreePass>;
      return group::march_kernel<128, kManyCylinderCut, 5, kThreePass>;
    case kDisplacement: return group::march_kernel<128, kDisplacement, 0, kThreePass>;
    default: return nullptr;
  }
}

}  // namespace cnr
