// bf16 window attention for Hopper (sm_90a): the call window_attention.cu
// makes into window_attention_sm90.cu. See that file for the design.
#pragma once

#include <cuda_runtime.h>

namespace medsam2 {
namespace hopper {

struct WinCall {
  const void* qkv;  // [B, Hp, Wp, 3C] bf16
  void* out;        // [B, Hp, Wp, C] bf16
  int B, Hp, Wp, C, heads, ws, d;  // C = heads * d
  float scale;
  cudaStream_t stream;
};

// Launches the bf16 kernel built for (call.d, call.ws): d 96 with ws 1 to
// 14, d 56 with ws 4, 7, 8, 14, d 72 with ws 4, 8, 16.
cudaError_t window_sm90(const WinCall& call);

}  // namespace hopper

// The fp32 kernel of window_attention.cu, same call: d in {56, 72, 96},
// ws * ws <= 196 at d 96 and <= 256 at d 56 / 72.
cudaError_t window_attention_f32(const hopper::WinCall& call);

}  // namespace medsam2
