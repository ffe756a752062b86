// The march kernel at hidden width 512 with the three-pass chain (K2h), for
// each (scene, window). A translation unit of its own, so it compiles in
// parallel with the others (kernels/build.py).
#include "march.cuh"

namespace cnr {
template int launch_march<512, true>(const MarchArgs&, cudaStream_t);
}  // namespace cnr
