// Instantiations of the bf16 encoder linear (encoder_linear_sm90.cuh) at
// column tiles 144, 160, 176, 192: one file per four widths, so that the
// sixteen widths compile in parallel.

#include "encoder_linear_sm90.cuh"

namespace medsam2 {
namespace enc {

template cudaError_t launch_linear<144>(const LinearCall&);
template cudaError_t launch_linear<160>(const LinearCall&);
template cudaError_t launch_linear<176>(const LinearCall&);
template cudaError_t launch_linear<192>(const LinearCall&);

}  // namespace enc
}  // namespace medsam2
