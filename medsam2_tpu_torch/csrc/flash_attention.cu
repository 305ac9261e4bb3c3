// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/attention.py:_flash_kernel
// (reached through _flash_call <- flash_attention <- attention). Same math:
// online softmax over kv tiles, -1e30 on masked logits, probabilities
// multiplied by the float kv mask, fp32 running max / sum / accumulator, and a
// zero output for a row whose every key is masked. With a non-null `lse` it
// also writes the per-row log-sum-exp m + log(l) (l == 0 -> 1), the training
// forward's second output (`with_lse`, attention.py:96-101) that the backward
// kernels (flash_attention_bwd.cu) recompute P from; a null `lse` is the
// inference launch and costs nothing extra.
//
// What bounds it on the H100: at the main path's shapes (Hiera global
// attention [1,4,4096,96], memory self-attention [B,1,4096,256], training
// cross-attention [2,1,1024,10316] with 64-wide values) the work is
// 2*Nq*Nk*(D+Dv) flops against O((Nq+Nk)*D) bytes, far above the card's
// ~295 flop/byte ridge, so the limit is tensor-core issue rate, not HBM.
// This first version stages K/V through shared memory with plain 16-byte
// loads and keeps O in shared memory, so it reaches only a fraction of the
// mma.sync peak; the design keeps the [Nq, Nk] logits out of device memory
// (the plain path writes them), which is what matters at these shapes. A
// wgmma + TMA pipeline is later work.
//
// Grid: (ceil(Nq / 64), B*H); 128 threads; dynamic shared memory per
// (dtype, D, Dv) from attention_tile.cuh.

#include "attention_tile.cuh"

namespace medsam2 {
namespace {

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                     int H, int Nq, int Nk, float scale) {
  using L = Smem<T, D, DV>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<T, D, DV> t(smem);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int valid_q = min(kBQ, Nq - q0);
  init_block(t, q + ((size_t)bh * Nq + q0) * D, valid_q);
  const float* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * DV;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    const int valid = min(BK, Nk - k0);
    __syncthreads();  // the previous tile's readers are done with K/V/mask
    if (!stage_mask(t, mrow ? mrow + k0 : nullptr, valid)) continue;
    load_rows<T, D>(t.k, L::LDK, kb + (size_t)k0 * D, BK, valid);
    load_rows<T, DV>(t.v, L::LDV, vb + (size_t)k0 * DV, BK, valid);
    __syncthreads();
    attend_tile(t, scale);
  }
  __syncthreads();
  write_out(t, out + ((size_t)bh * Nq + q0) * DV, valid_q);
  if (lse != nullptr) {
    // a fully masked row keeps m = -1e30 and l = 0: lse = -1e30, finite,
    // and the backward zeroes its probabilities through the mask
    float* lrow = lse + (size_t)bh * Nq + q0;
    for (int r = threadIdx.x; r < valid_q; r += kThreads) {
      const float l = t.l[r];
      lrow[r] = t.m[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* out;
  float* lse;
  int BH, H, Nq, Nk;
  float scale;
  cudaStream_t stream;
};

template <typename T>
struct FlashLaunch {
  const FlashArgs& a;
  template <int D, int DV>
  cudaError_t operator()() const {
    using L = Smem<T, D, DV>;
    auto kern = flash_fwd_kernel<T, D, DV>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.Nq + kBQ - 1) / kBQ, a.BH);
    kern<<<grid, kThreads, L::bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask,
        static_cast<T*>(a.out), a.lse, a.H, a.Nq, a.Nk, a.scale);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace medsam2

// q [BH, Nq, D], k [BH, Nk, D], v [BH, Nk, Dv], mask [BH / H, Nk] float or
// NULL, out [BH, Nq, Dv]; all contiguous, 16-byte aligned, one dtype
// (0 = float32, 1 = bfloat16). lse [BH, Nq] float32, or NULL for the
// inference launch. Returns the cudaError_t of the launch.
extern "C" int medsam2_flash_attention_fwd(const void* q, const void* k, const void* v,
                                           const float* mask, void* out, float* lse, int BH,
                                           int H, int Nq, int Nk, int D, int Dv, float scale,
                                           int dtype, void* stream) {
  using namespace medsam2;
  if (BH <= 0 || Nq <= 0 || H <= 0 || BH % H != 0 || Nk < 0) return (int)cudaErrorInvalidValue;
  const FlashArgs a{q, k, v, mask, out, lse, BH, H, Nq, Nk, scale,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)dispatch_dims(D, Dv, FlashLaunch<bf16>{a});
  if (dtype == 0) return (int)dispatch_dims(D, Dv, FlashLaunch<float>{a});
  return (int)cudaErrorInvalidValue;
}
