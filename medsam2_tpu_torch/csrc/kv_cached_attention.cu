// Storage-order cross-attention over the memory bank's roped-key cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/attention.py:_kv_cached_kernel
// (reached through kv_cached_attention <- transformer.rope_attn_storage).
// Single kv head. For each bank slot f the key tile is assembled in shared
// memory as kcache[b, f, layer] + pos_rows[row_of_slot[f], layer], summed in
// the cache dtype; values are the raw 64-wide memory features v_slots[b, f];
// the trailing tiles carry the object-pointer keys ptr_k and values ptr_v.
// Nothing is gathered, concatenated or re-ordered in device memory.
//
// Differences from the TPU kernel, by design:
// - Each block reads row_of_slot itself (the TPU prefetched it as a scalar).
// - Any P and any Nptr: slot and pointer tails are ragged tiles masked inside
//   the kernel (the TPU wrapper fell back to XLA when no aligned block divided
//   P or when Nptr exceeded one block).
// - A tile whose keys are all masked (a stale ring slot, pointer padding)
//   skips its loads and dots, as the TPU kernel's pl.when did.
//
// What bounds it on the H100: per call 2*Nq*(F*P+Nptr)*(C+Dv) flops (86 GF at
// 1024 px, B=1) against the layer's slice of the cache (F*P*C, 16.8 MB bf16)
// plus its positional rows, which every q block re-reads. The cache slice fits
// in the 50 MB L2, so the re-reads hit L2 and the kernel is bound by tensor
// core issue and shared-memory traffic; with 64-row q blocks a B=1 call has
// only 64 blocks for 132 SMs, which is the first thing to fix (split kv across
// blocks with a second reduction pass, or wgmma with 128-row tiles).
//
// Grid: (ceil(Nq / 64), B); 128 threads. Instantiated only for the widths
// every SAM2 variant gives it: C = d_model = 256, Dv = mem_dim = 64.

#include "attention_tile.cuh"

namespace medsam2 {
namespace {

constexpr int kKvC = 256;
constexpr int kKvDv = 64;

template <typename T, int C, int DV>
__global__ void __launch_bounds__(kThreads)
    kv_cached_kernel(const T* __restrict__ q, const T* __restrict__ kcache,
                     const T* __restrict__ pos_rows, const int* __restrict__ row_of_slot,
                     const T* __restrict__ ptr_k, const T* __restrict__ v_slots,
                     const T* __restrict__ ptr_v, const float* __restrict__ mask,
                     T* __restrict__ out, int Nq, int F, int L, int P, int Nptr, int Rr,
                     int layer, float scale) {
  using Lay = Smem<T, C, DV>;
  constexpr int BK = Lay::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<T, C, DV> t(smem);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int valid_q = min(kBQ, Nq - q0);
  init_block(t, q + ((size_t)b * Nq + q0) * C, valid_q);
  const float* mrow = mask + (size_t)b * ((size_t)F * P + Nptr);

  for (int f = 0; f < F; ++f) {
    // out-of-range rows clamp, as the TPU's index maps would
    const int row = min(max(row_of_slot[f], 0), Rr - 1);
    const T* kc = kcache + (((size_t)b * F + f) * L + layer) * (size_t)P * C;
    const T* pr = pos_rows + ((size_t)row * L + layer) * (size_t)P * C;
    const T* vs = v_slots + ((size_t)b * F + f) * (size_t)P * DV;
    for (int p0 = 0; p0 < P; p0 += BK) {
      const int valid = min(BK, P - p0);
      __syncthreads();
      if (!stage_mask(t, mrow + (size_t)f * P + p0, valid)) continue;
      load_rows_sum<T, C>(t.k, Lay::LDK, kc + (size_t)p0 * C, pr + (size_t)p0 * C, BK, valid);
      load_rows<T, DV>(t.v, Lay::LDV, vs + (size_t)p0 * DV, BK, valid);
      __syncthreads();
      attend_tile(t, scale);
    }
  }
  const T* pkb = ptr_k + (size_t)b * Nptr * C;
  const T* pvb = ptr_v + (size_t)b * Nptr * DV;
  for (int p0 = 0; p0 < Nptr; p0 += BK) {
    const int valid = min(BK, Nptr - p0);
    __syncthreads();
    if (!stage_mask(t, mrow + (size_t)F * P + p0, valid)) continue;
    load_rows<T, C>(t.k, Lay::LDK, pkb + (size_t)p0 * C, BK, valid);
    load_rows<T, DV>(t.v, Lay::LDV, pvb + (size_t)p0 * DV, BK, valid);
    __syncthreads();
    attend_tile(t, scale);
  }
  __syncthreads();
  write_out(t, out + ((size_t)b * Nq + q0) * DV, valid_q);
}

struct KvArgs {
  const void* q;
  const void* kcache;
  const void* pos_rows;
  const int* row_of_slot;
  const void* ptr_k;
  const void* v_slots;
  const void* ptr_v;
  const float* mask;
  void* out;
  int B, Nq, F, L, P, Nptr, Rr, layer;
  float scale;
  cudaStream_t stream;
};

template <typename T>
struct KvLaunch {
  const KvArgs& a;
  template <int C, int DV>
  cudaError_t operator()() const {
    using Lay = Smem<T, C, DV>;
    auto kern = kv_cached_kernel<T, C, DV>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.Nq + kBQ - 1) / kBQ, a.B);
    kern<<<grid, kThreads, Lay::bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.kcache),
        static_cast<const T*>(a.pos_rows), a.row_of_slot, static_cast<const T*>(a.ptr_k),
        static_cast<const T*>(a.v_slots), static_cast<const T*>(a.ptr_v), a.mask,
        static_cast<T*>(a.out), a.Nq, a.F, a.L, a.P, a.Nptr, a.Rr, a.layer, a.scale);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace medsam2

// q [B, Nq, C]; kcache [B, F, L, P, C]; pos_rows [Rr, L, P, C]; row_of_slot
// [F] int32; ptr_k [B, Nptr, C]; v_slots [B, F, P, Dv]; ptr_v [B, Nptr, Dv];
// mask [B, F*P + Nptr] float (> 0 attends); out [B, Nq, Dv]. All contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16) except row_of_slot
// and mask; C = 256 and Dv = 64. Returns the cudaError_t of the launch.
extern "C" int medsam2_kv_cached_attention_fwd(const void* q, const void* kcache,
                                               const void* pos_rows, const int* row_of_slot,
                                               const void* ptr_k, const void* v_slots,
                                               const void* ptr_v, const float* mask, void* out,
                                               int B, int Nq, int F, int L, int P, int C, int Dv,
                                               int Nptr, int Rr, int layer, float scale, int dtype,
                                               void* stream) {
  using namespace medsam2;
  if (B <= 0 || Nq <= 0 || F < 0 || P < 0 || Nptr < 0 || Rr <= 0 || layer < 0 || layer >= L ||
      C != kKvC || Dv != kKvDv)
    return (int)cudaErrorInvalidValue;
  const KvArgs a{q,  kcache, pos_rows, row_of_slot, ptr_k, v_slots, ptr_v, mask,
                 out, B,     Nq,       F,           L,     P,       Nptr,  Rr,
                 layer, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)KvLaunch<bf16>{a}.operator()<kKvC, kKvDv>();
  if (dtype == 0) return (int)KvLaunch<float>{a}.operator()<kKvC, kKvDv>();
  return (int)cudaErrorInvalidValue;
}
