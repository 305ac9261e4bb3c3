// bf16 flash attention forward for Hopper (sm_90a): warp-specialised wgmma +
// TMA design of hopper_attention.cuh, with split-kv.
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/attention.py:_flash_kernel
// for bfloat16 inputs (flash_attention.cu keeps the fp32 launch and the
// dispatch). The producer warp reads the kv mask of each 64-key tile, skips
// a tile whose keys are all masked, and TMA-loads the others; the two
// consumer warpgroups run the online softmax over 128 query rows.
//
// What bounds it on the H100: 2*Nq*Nk*(D+Dv) flops against O((Nq+Nk)*D)
// bytes, far above the ~295 flop/byte ridge, so tensor-core issue. The grid
// is (ceil(Nq / 128), splits, B*H); the wrapper picks splits > 1 when
// B*H*ceil(Nq / 128) leaves SMs idle, and the blocks then write fp32 partial
// outputs that attention_merge combines.
//
// Each flash_fwd_sm90_d<D>.cu defines MEDSAM2_FLASH_SM90_DEFINE and
// instantiates flash_sm90<D, DV> for every DV, so nvcc compiles them in
// parallel; other files see only FlashCall and the declaration.
#pragma once

#include "hopper_attention.cuh"

namespace medsam2 {
namespace hopper {

struct FlashCall {
  const void* q;      // [BH, Nq, D] bf16
  const void* k;      // [BH, Nk, D]
  const void* v;      // [BH, Nk, DV]
  const float* mask;  // [BH / H, Nk] or null
  void* out;          // [BH, Nq, DV] bf16 (splits == 1)
  float* lse;         // [BH, Nq] or null (splits == 1)
  float* o_part;      // [splits, BH, Nq, DV] fp32 (splits > 1)
  float* lse_part;    // [splits, BH, Nq]
  int BH, H, Nq, Nk, splits;
  float scale;
  cudaStream_t stream;
};

template <int D, int DV>
cudaError_t flash_sm90(const FlashCall& a);

}  // namespace hopper
}  // namespace medsam2

#ifdef MEDSAM2_FLASH_SM90_DEFINE

namespace medsam2 {
namespace hopper {

struct FlashMaps {
  CUtensorMap q64, q_rem, k64, k_rem, v64, v_rem;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ FlashMaps maps, const float* __restrict__ mask,
                      const OutArgs oa, int H, int Nq, int Nk, int tiles_per_split,
                      float scale_log2) {
  using L = Layout<D, DV, 0>;
  extern __shared__ unsigned char smem_raw[];
  const Shared<L> sh(smem_raw);
  const int bh = blockIdx.z;
  const int split = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  if (threadIdx.x == 0) sh.init_barriers(1);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one warp issues every load ----
    regs_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(sh.qbar(), L::kQBytes);
      tma_tile<D>(sh.q(), kBQ, &maps.q64, &maps.q_rem, sh.qbar(), q0, bh);
    }
    produce_kv<D, DV>(sh, maps, mask, H, Nk, bh, split, tiles_per_split, lane);
  } else {
    regs_inc<232>();
    consume<D, DV>(sh, threadIdx.x / 128 - 1, scale_log2, oa, bh * Nq + q0, min(kBQ, Nq - q0),
                   split);
  }
}

template <int D, int DV>
cudaError_t flash_sm90(const FlashCall& a) {
  using L = Layout<D, DV, 0>;
  FlashMaps maps;
  // no keys: the maps must still name device memory, and nothing is loaded
  const void* k = a.Nk > 0 ? a.k : a.q;
  const void* v = a.Nk > 0 ? a.v : a.q;
  if (!make_maps<D>(&maps.q64, &maps.q_rem, a.q, a.Nq, a.BH, kBQ) ||
      !make_maps<D>(&maps.k64, &maps.k_rem, k, a.Nk, a.BH, kBK) ||
      !make_maps<DV>(&maps.v64, &maps.v_rem, v, a.Nk, a.BH, kBK))
    return cudaErrorInvalidValue;
  auto kern = flash_sm90_kernel<D, DV>;
  static unsigned long long smem_set = 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), L::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = (a.Nk + kBK - 1) / kBK;
  const int per_split = (n_tiles + a.splits - 1) / a.splits;
  OutArgs oa{nullptr, nullptr, nullptr, nullptr, a.BH * a.Nq};
  if (a.splits == 1) {
    oa.out = static_cast<bf16*>(a.out);
    oa.lse = a.lse;
  } else {
    oa.o_part = a.o_part;
    oa.lse_part = a.lse_part;
  }
  const dim3 grid((a.Nq + kBQ - 1) / kBQ, a.splits, a.BH);
  kern<<<grid, kThreads, L::bytes, a.stream>>>(maps, a.mask, oa, a.H, a.Nq, a.Nk, per_split,
                                               a.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace medsam2

// Explicit instantiations of flash_sm90<D, DV> for every DV, one D a file.
#define MEDSAM2_FLASH_SM90_FOR_D(D)                                                      \
  namespace medsam2 {                                                                    \
  namespace hopper {                                                                     \
  template cudaError_t flash_sm90<D, 64>(const FlashCall&);                              \
  template cudaError_t flash_sm90<D, 72>(const FlashCall&);                              \
  template cudaError_t flash_sm90<D, 96>(const FlashCall&);                              \
  template cudaError_t flash_sm90<D, 128>(const FlashCall&);                             \
  template cudaError_t flash_sm90<D, 256>(const FlashCall&);                             \
  }                                                                                      \
  }

#endif  // MEDSAM2_FLASH_SM90_DEFINE
