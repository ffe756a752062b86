// The kernels of the package at hidden width 64 with the FP32 chain: the
// march kernel for each (scene, window), a ray per thread and a ray per
// warp (march_split_kernel), and the fused forward. One
// translation unit per width and chain, so they compile in parallel
// (kernels/build.py).
#include "march.cuh"

namespace cnr {
template int launch_march<64, false>(const MarchArgs&, cudaStream_t);
template int launch_mlp_forward<64>(const MlpArgs&, cudaStream_t);
}  // namespace cnr
