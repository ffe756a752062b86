// The kernels of the package at hidden width 128 with the FP32 chain: the
// march kernel for each (scene, window), a block's group of rays at once
// (hidden128_group.cuh), and the fused forward. One translation unit per
// width and chain, so they compile in parallel (kernels/build.py).
#include "hidden128_group.cuh"

namespace cnr {
template MarchKernel pick_group_kernel<false>(int, int);
template int launch_march<128, false>(const MarchArgs&, cudaStream_t);
template int launch_mlp_forward<128>(const MlpArgs&, cudaStream_t);
}  // namespace cnr
