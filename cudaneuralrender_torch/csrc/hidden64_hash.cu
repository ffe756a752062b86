// The march kernel of the hash-grid SDF with the FP32 chain at width 64:
// the encoding as the chain's input stage (hash_grid.cuh), neural_raw, a
// ray per thread and a ray per warp (march_split_kernel). A translation unit
// of its own, so it compiles in parallel with the others (kernels/build.py).
#include "march.cuh"

namespace cnr {
template int launch_march_hash<false>(const MarchArgs&, cudaStream_t);
}  // namespace cnr
