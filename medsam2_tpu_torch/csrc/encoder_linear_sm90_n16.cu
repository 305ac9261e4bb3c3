// Instantiations of the bf16 encoder linear (encoder_linear_sm90.cuh) at
// column tiles 16, 32, 48, 64: one file per four widths, so that the
// sixteen widths compile in parallel.

#include "encoder_linear_sm90.cuh"

namespace medsam2 {
namespace enc {

template cudaError_t launch_linear<16>(const LinearCall&);
template cudaError_t launch_linear<32>(const LinearCall&);
template cudaError_t launch_linear<48>(const LinearCall&);
template cudaError_t launch_linear<64>(const LinearCall&);

}  // namespace enc
}  // namespace medsam2
