// The march kernel of the hash-grid SDF with the three-pass chain (K2h) at
// width 64: the encoding as the chain's input stage (hash_grid.cuh),
// neural_raw. A translation unit of its own, so it compiles in parallel with
// the others (kernels/build.py).
#include "march.cuh"

namespace cnr {
template int launch_march_hash<true>(const MarchArgs&, cudaStream_t);
}  // namespace cnr
