// bf16 flash-backward dQ pass for Hopper (sm_90a): the call
// flash_attention_bwd.cu makes into flash_bwd_dq_sm90.cu. See that file for
// the design.
#pragma once

#include <cuda_runtime.h>

namespace medsam2 {
namespace hopper {

struct DqCall {
  const void* q;      // [BH, Nq, D] bf16
  const void* k;      // [BH, Nk, D]
  const void* v;      // [BH, Nk, DV]
  const float* mask;  // [BH / H, Nk] or null
  const void* dout;   // [BH, Nq, DV] bf16
  const float* lse;   // [BH, Nq]
  const float* dvec;  // [BH, Nq]
  float* dq;          // [BH, rows_out, D], scaled (splits == 1)
  float* part;        // [splits, BH * Nq, D], unscaled partial sums (splits > 1)
  int BH, H, Nq, Nk, rows_out, splits;
  float scale;
  cudaStream_t stream;
};

// (D, DV) in {(256, 256), (256, 64)}.
template <int D, int DV>
cudaError_t flash_bwd_dq_sm90(const DqCall& call);

}  // namespace hopper
}  // namespace medsam2
