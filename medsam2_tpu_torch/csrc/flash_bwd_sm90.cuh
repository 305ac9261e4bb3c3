// bf16 flash-backward passes for Hopper (sm_90a): the calls
// flash_attention_bwd.cu makes into flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu. See those files for the designs.
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

// (D, DV) in {(256, 256), (256, 64), (96, 96), (72, 72)}.
template <int D, int DV>
cudaError_t flash_bwd_dq_sm90(const DqCall& call);

// The bf16 dK/dV pass (flash_bwd_dkv_sm90.cu).
struct DkvCall {
  const void* q;      // [BH, Nq, D] bf16
  const void* k;      // [BH, Nk, D]
  const void* v;      // [BH, Nk, DV]
  const float* mask;  // [BH / H, Nk] or null
  const void* dout;   // [BH, Nq, DV] bf16
  const float* lse;   // [BH, Nq]
  const float* dvec;  // [BH, Nq]
  float* dk;          // [BH, rows_out, D], scaled (splits == 1)
  float* dv;          // [BH, rows_out, DV]
  float* part_k;      // [splits, BH * rows_out, D], unscaled partial sums (splits > 1)
  float* part_v;      // [splits, BH * rows_out, DV]
  int BH, H, Nq, Nk, rows_out, splits;
  float scale;
  cudaStream_t stream;
};

// (D, DV) in {(256, 256), (256, 64), (96, 96), (72, 72)}.
template <int D, int DV>
cudaError_t flash_bwd_dkv_sm90(const DkvCall& call);

}  // namespace hopper
}  // namespace medsam2
