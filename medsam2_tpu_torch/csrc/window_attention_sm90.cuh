// bf16 window attention for Hopper (sm_90a): the call window_attention.cu
// makes into window_attention_sm90.cu. See that file for the design.
#pragma once

#include <cuda_runtime.h>

namespace medsam2 {
namespace hopper {

struct WinCall {
  const void* qkv;  // [B, Hp, Wp, 3C] bf16
  void* out;        // [B, Hp, Wp, C] bf16
  int B, Hp, Wp, C, heads, ws;
  float scale;
  cudaStream_t stream;
};

// Launches the kernel built for call.ws (1 to 14, head dim 96).
cudaError_t window_sm90(const WinCall& call);

}  // namespace hopper
}  // namespace medsam2
