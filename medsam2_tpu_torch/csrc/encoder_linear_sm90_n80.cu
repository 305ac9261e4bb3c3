// Instantiations of the bf16 encoder linear (encoder_linear_sm90.cuh) at
// column tiles 80, 96, 112, 128: one file per four widths, so that the
// sixteen widths compile in parallel.

#include "encoder_linear_sm90.cuh"

namespace medsam2 {
namespace enc {

template cudaError_t launch_linear<80>(const LinearCall&);
template cudaError_t launch_linear<96>(const LinearCall&);
template cudaError_t launch_linear<112>(const LinearCall&);
template cudaError_t launch_linear<128>(const LinearCall&);

}  // namespace enc
}  // namespace medsam2
