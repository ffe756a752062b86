// The march kernel at hidden width 128 with the three-pass chain (K2h), for
// each (scene, window), a block's group of rays at once
// (hidden128_group.cuh). A translation unit of its own, so it compiles in
// parallel with the others (kernels/build.py).
#include "hidden128_group.cuh"

namespace cnr {
template MarchKernel pick_group_kernel<true>(int, int);
template int launch_march<128, true>(const MarchArgs&, cudaStream_t);
}  // namespace cnr
