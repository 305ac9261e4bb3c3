// Flash attention forward for Hopper (sm_90a): the entry point, the fp32
// kernel, and attention_merge, which combines split-kv partial outputs.
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/attention.py:_flash_kernel
// (reached through _flash_call <- flash_attention <- attention). Same math:
// online softmax over kv tiles, -1e30 on masked logits, probabilities
// multiplied by the float kv mask, fp32 running max / sum / accumulator, and a
// zero output for a row whose every key is masked. With a non-null `lse` it
// also writes the per-row log-sum-exp m + log(l) (-1e30 when every key is
// masked), the training forward's second output (`with_lse`,
// attention.py:96-101) that the backward kernels (flash_attention_bwd.cu)
// recompute P from; a null `lse` is the inference launch.
//
// bfloat16 inputs run the wgmma + TMA design (flash_fwd_sm90.cuh), with the
// kv range split over `splits` blocks when the wrapper asks for it.
// float32 inputs run the FMA design of attention_tile.cuh (wgmma has no
// full-fp32 mode, and the JAX package pins Precision.HIGHEST): grid
// (ceil(Nq / 64), B*H), 128 threads, one split.

#include "attention_tile.cuh"
#include "flash_fwd_sm90.cuh"

namespace medsam2 {
namespace {

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse, int H, int Nq, int Nk,
                         float scale) {
  using L = Smem<D, DV>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<D, DV> t(smem);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int valid_q = min(kBQ, Nq - q0);
  init_block(t, q + ((size_t)bh * Nq + q0) * D, valid_q);
  const float* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * DV;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    const int valid = min(BK, Nk - k0);
    __syncthreads();  // the previous tile's readers are done with K/V/mask
    if (!stage_mask(t, mrow ? mrow + k0 : nullptr, valid)) continue;
    load_rows<float, D>(t.k, L::LDK, kb + (size_t)k0 * D, BK, valid);
    load_rows<float, DV>(t.v, L::LDV, vb + (size_t)k0 * DV, BK, valid);
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

struct F32Launch {
  const hopper::FlashCall& a;
  template <int D, int DV>
  cudaError_t operator()() const {
    using L = Smem<D, DV>;
    auto kern = flash_fwd_f32_kernel<D, DV>;
    static unsigned long long smem_set = 0;
    const cudaError_t e =
        hopper::allow_smem(reinterpret_cast<const void*>(kern), (int)L::bytes, smem_set);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.Nq + kBQ - 1) / kBQ, a.BH);
    kern<<<grid, kThreads, L::bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out), a.lse, a.H, a.Nq,
        a.Nk, a.scale);
    return cudaGetLastError();
  }
};

struct Sm90Launch {
  const hopper::FlashCall& a;
  template <int D, int DV>
  cudaError_t operator()() const {
    return hopper::flash_sm90<D, DV>(a);
  }
};

// attention_merge: one warp per row. lse = logsumexp_i lse_i over the
// splits, out = sum_i exp(lse_i - lse) O_i; a split whose keys were all
// masked has lse_i = -1e30 and weight 0; when every split is empty the row
// is 0 with lse -1e30. The order of the sum is fixed: no atomics.
constexpr int kMergeRows = 8;

__global__ void __launch_bounds__(32 * kMergeRows)
    attention_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                           bf16* __restrict__ out, float* __restrict__ lse, int splits, int rows,
                           int DV) {
  const int row = blockIdx.x * kMergeRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lse_part[(size_t)s * rows + row]);
  bf16* orow = out + (size_t)row * DV;
  if (mx == kNegInf) {
    for (int c = lane; c < DV; c += 32) orow[c] = __float2bfloat16(0.f);
    if (lse != nullptr && lane == 0) lse[row] = kNegInf;
    return;
  }
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += expf(lse_part[(size_t)s * rows + row] - mx);
  const float total = mx + logf(sum);
  for (int c = lane; c < DV; c += 32) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t prow = (size_t)s * rows + row;
      acc += expf(lse_part[prow] - total) * o_part[prow * DV + c];
    }
    orow[c] = __float2bfloat16(acc);
  }
  if (lse != nullptr && lane == 0) lse[row] = total;
}

}  // namespace
}  // namespace medsam2

// q [BH, Nq, D], k [BH, Nk, D], v [BH, Nk, Dv], mask [BH / H, Nk] float or
// NULL, out [BH, Nq, Dv]; all contiguous, 16-byte aligned, one dtype
// (0 = float32, 1 = bfloat16). lse [BH, Nq] float32, or NULL for the
// inference launch. bfloat16 only: with splits > 1 the blocks write
// o_part [splits, BH, Nq, Dv] and lse_part [splits, BH, Nq] (float32) and
// leave out and lse to medsam2_attention_merge. Returns the cudaError_t of
// the launch.
extern "C" int medsam2_flash_attention_fwd(const void* q, const void* k, const void* v,
                                           const float* mask, void* out, float* lse,
                                           float* o_part, float* lse_part, int BH, int H, int Nq,
                                           int Nk, int D, int Dv, float scale, int splits,
                                           int dtype, void* stream) {
  using namespace medsam2;
  if (BH <= 0 || Nq <= 0 || H <= 0 || BH % H != 0 || Nk < 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (dtype != 1 || o_part == nullptr || lse_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const hopper::FlashCall a{q,     k,  v,  mask, out, lse, o_part, lse_part, BH,
                            H,     Nq, Nk, splits, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)dispatch_dims(D, Dv, Sm90Launch{a});
  if (dtype == 0) return (int)dispatch_dims(D, Dv, F32Launch{a});
  return (int)cudaErrorInvalidValue;
}

// o_part [splits, rows, Dv] and lse_part [splits, rows] float32 -> out
// [rows, Dv] bfloat16 and, if non-NULL, lse [rows] float32.
extern "C" int medsam2_attention_merge(const float* o_part, const float* lse_part, void* out,
                                       float* lse, int splits, int rows, int Dv, void* stream) {
  using namespace medsam2;
  if (splits < 1 || rows <= 0 || Dv <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kMergeRows - 1) / kMergeRows);
  attention_merge_kernel<<<grid, 32 * kMergeRows, 0, static_cast<cudaStream_t>(stream)>>>(
      o_part, lse_part, static_cast<bf16*>(out), lse, splits, rows, Dv);
  return (int)cudaGetLastError();
}
