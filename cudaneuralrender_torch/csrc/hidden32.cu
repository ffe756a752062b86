// Every kernel of the package at hidden width 32: the march kernel for each
// (scene, window) and the fused forward. One translation unit per width, so
// the widths compile in parallel (kernels/build.py).
#include "march.cuh"

namespace cnr {
template int launch_march<32>(const MarchArgs&, cudaStream_t);
template int launch_mlp_forward<32>(const MlpArgs&, cudaStream_t);
}  // namespace cnr
