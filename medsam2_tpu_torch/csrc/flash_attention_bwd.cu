// Flash attention backward for Hopper (sm_90a): the dK/dV pass and the dQ pass.
//
// Replaces the two Pallas TPU kernels of the flash backward,
// medsam2_tpu/ops/attention.py:_bwd_dkv_kernel and :_bwd_dq_kernel, reached
// through _flash_bwd_pallas <- the custom_vjp of flash_attention. For one
// (batch*head) slice, with S = Q K^T * scale, lse the forward's per-row
// log-sum-exp (flash_attention.cu) and dvec = rowsum(dO * O) (computed by the
// caller in fp32, as the JAX package computes it in XLA):
//
//   P  = exp(min(S - lse, 0)) * mask          mask: 0/1 per key
//   dV = P^T dO          dP = dO V^T          dS = P * (dP - dvec)
//   dK = scale * dS^T Q  dQ = scale * dS K
//
// P and dS are rounded to the input dtype before their products and every
// product accumulates in fp32, as the Pallas kernels do. The JAX wrapper
// zeroes masked K rows and masks dK/dV afterwards; multiplying P by the mask
// gives the same dQ, dK and dV, and zero gradients for a query row whose keys
// are all masked (its lse is -1e30, its P is 0).
//
// Two kernels, as on the TPU, so that neither needs atomics and both are
// deterministic:
//   dkv: one block per (tile of BM kv rows, b*h), looping over q tiles;
//   dq:  one block per (tile of BM q rows, b*h), looping over kv tiles.
// Ragged Nq and Nk take no escape: edge tiles are zero-filled, padded keys
// carry mask 0 and padded query rows lse = +1e30, so both contribute nothing.
// A kv tile whose keys are all masked (a stale ring slot, pointer padding) is
// skipped block-uniformly. Outputs are fp32 into buffers padded to a multiple
// of 64 rows; the wrapper slices and casts them, as the TPU kernels write fp32.
//
// What bounds it on the H100: 2*Nq*Nk*(2*D + 2*Dv) flops for dkv and
// 2*Nq*Nk*(2*D + Dv) for dq (S and dP are recomputed in each) against
// O((Nq + Nk) * (D + Dv)) bytes: far above the ~295 flop/byte ridge at the
// training shapes, so tensor-core issue rate bounds both. The bf16 passes
// are the wgmma + TMA designs of flash_bwd_dq_sm90.cu (split-kv) and
// flash_bwd_dkv_sm90.cu (split-q); this file's kernels serve fp32 only: the
// accumulators stay in registers and the K/V/Q/dO tiles, S and dP live in
// shared memory, plain FMA on 32-row tiles with no TF32 (the JAX package
// pins Precision.HIGHEST for fp32).

#include "attention_tile.cuh"
#include "flash_bwd_sm90.cuh"
#include "hopper_attention.cuh"

namespace medsam2 {
namespace {

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;

// Shared-memory layout (bytes) of one block of either fp32 kernel.
template <typename T, int D, int DV>
struct BwdSmem {
  static_assert(std::is_same<T, float>::value, "the bf16 passes are the sm90 kernels");
  static constexpr int BM = 32;  // rows of every q and kv tile
  static constexpr int PAD = 4;
  static constexpr int LDD = D + PAD;   // Q and K rows (elements of T)
  static constexpr int LDV = DV + PAD;  // V and dO rows
  static constexpr int LDS = BM + 4;    // S and dP (floats)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(T) * BM * LDD);
  static constexpr size_t do_off = k_off + align128(sizeof(T) * BM * LDD);
  static constexpr size_t v_off = do_off + align128(sizeof(T) * BM * LDV);
  static constexpr size_t s_off = v_off + align128(sizeof(T) * BM * LDV);
  static constexpr size_t dp_off = s_off + align128(sizeof(float) * BM * LDS);
  static constexpr size_t lse_off = dp_off + align128(sizeof(float) * BM * LDS);
  static constexpr size_t dvec_off = lse_off + align128(sizeof(float) * BM);
  static constexpr size_t mask_off = dvec_off + align128(sizeof(float) * BM);
  static constexpr size_t bytes = mask_off + align128(sizeof(float) * BM);
  static_assert(bytes <= 232448, "tile does not fit the 227 KB a block may use");
  static_assert(BM * BM % kBwdThreads == 0, "fp32 S tile split over the threads");
};

template <typename T, int D, int DV>
struct BwdTiles {
  using L = BwdSmem<T, D, DV>;
  T* q;
  T* k;
  T* dout;
  T* v;
  float* s;
  float* dp;
  float* lse;
  float* dvec;
  float* mask;
  __device__ explicit BwdTiles(unsigned char* base)
      : q(reinterpret_cast<T*>(base + L::q_off)),
        k(reinterpret_cast<T*>(base + L::k_off)),
        dout(reinterpret_cast<T*>(base + L::do_off)),
        v(reinterpret_cast<T*>(base + L::v_off)),
        s(reinterpret_cast<float*>(base + L::s_off)),
        dp(reinterpret_cast<float*>(base + L::dp_off)),
        lse(reinterpret_cast<float*>(base + L::lse_off)),
        dvec(reinterpret_cast<float*>(base + L::dvec_off)),
        mask(reinterpret_cast<float*>(base + L::mask_off)) {}
};

// Stage the mask of one kv tile (nullptr = all keys attend; rows at or past
// `valid` are padding, mask 0). Returns, block-uniformly, whether any key of
// the tile attends.
template <int BM>
__device__ __forceinline__ bool stage_kv_mask(float* mask_s, const float* mask, int valid) {
  float mv = 0.f;
  if (threadIdx.x < BM) {
    if (threadIdx.x < valid) mv = mask ? mask[threadIdx.x] : 1.f;
    mask_s[threadIdx.x] = mv;
  }
  return __syncthreads_or(mv > 0.f) != 0;
}

// lse and dvec of the q rows of a tile; rows past `valid` get lse = +1e30,
// so exp(min(S - lse, 0)) is 0 for them.
template <int BM>
__device__ __forceinline__ void stage_q_rows(float* lse_s, float* dvec_s, const float* lse,
                                             const float* dvec, int valid) {
  for (int i = threadIdx.x; i < BM; i += kBwdThreads) {
    lse_s[i] = i < valid ? lse[i] : 1e30f;
    dvec_s[i] = i < valid ? dvec[i] : 0.f;
  }
}

// C[BM][BM] (fp32, row stride LDC) = A[BM][KD] . B[BM][KD]^T, both row-major
// in shared memory, by FMA: each thread BM*BM/256 outputs (a warp shares its
// row, lanes take the columns).
template <typename T, int BM, int KD, int LDA, int LDB, int LDC>
__device__ __forceinline__ void nt_product(const T* a, const T* b, float* c) {
#pragma unroll
  for (int e = 0; e < BM * BM / kBwdThreads; ++e) {
    const int idx = threadIdx.x + kBwdThreads * e;
    const int i = idx / BM;
    const int j = idx % BM;
    const float* ar = a + i * LDA;
    const float* br = b + j * LDB;
    float sum = 0.f;
    for (int d = 0; d < KD; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(ar + d);
      const float4 y = *reinterpret_cast<const float4*>(br + d);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
      sum = fmaf(x.z, y.z, sum);
      sum = fmaf(x.w, y.w, sum);
    }
    c[i * LDC + j] = sum;
  }
}

// From S (or S^T) and dP (or dP^T) in shared memory: P and dS, over S and
// dP. KV_ROWS: rows are keys and columns queries (the dkv pass), else the
// other way round.
template <typename T, int D, int DV, bool KV_ROWS>
__device__ __forceinline__ void probs_and_dscores(BwdTiles<T, D, DV>& t, float scale) {
  using L = BwdSmem<T, D, DV>;
  constexpr int BM = L::BM;
  for (int idx = threadIdx.x; idx < BM * BM; idx += kBwdThreads) {
    const int i = idx / BM;
    const int j = idx % BM;
    const int qi = KV_ROWS ? j : i;
    const int ki = KV_ROWS ? i : j;
    const float p = expf(fminf(t.s[i * L::LDS + j] * scale - t.lse[qi], 0.f)) * t.mask[ki];
    const float ds = p * (t.dp[i * L::LDS + j] - t.dvec[qi]);
    t.s[i * L::LDS + j] = p;
    t.dp[i * L::LDS + j] = ds;
  }
}

// An fp32 [BM][N] gradient accumulator of one block: acc += A[BM][BM] . B[BM][N]
// with A (P or dS) and B row-major in shared memory.
template <typename T, int N>
struct Acc;

// fp32: registers, BM = 32 rows; thread t owns elements t + 256 e of the
// row-major tile (a warp shares its row, lanes take consecutive columns).
template <int N>
struct Acc<float, N> {
  static constexpr int BM = 32;
  static constexpr int E = BM * N / kBwdThreads;
  float r[E];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] = 0.f;
  }

  template <int LDA, int LDB>
  __device__ __forceinline__ void mma(const float* a, const float* b) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = threadIdx.x + kBwdThreads * e;
      const int i = idx / N;
      const int c = idx % N;
      float sum = r[e];
#pragma unroll 8
      for (int j = 0; j < BM; ++j) sum = fmaf(a[i * LDA + j], b[j * LDB + c], sum);
      r[e] = sum;
    }
  }

  __device__ __forceinline__ void store(float* out, float scale) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = threadIdx.x + kBwdThreads * e;
      out[idx] = r[e] * scale;  // row idx / N, column idx % N of the block's rows
    }
  }
};

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ mask,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dvec, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Nq, int Nk, int Nk_out, float scale) {
  using L = BwdSmem<T, D, DV>;
  constexpr int BM = L::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  BwdTiles<T, D, DV> t(smem);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BM;
  const int valid_k = min(BM, Nk - k0);
  const bool live =
      stage_kv_mask<BM>(t.mask, mask ? mask + (size_t)(bh / H) * Nk + k0 : nullptr, valid_k);
  Acc<T, D> acc_k;
  Acc<T, DV> acc_v;
  acc_k.zero();
  acc_v.zero();
  if (live) {
    load_rows<T, D, kBwdThreads>(t.k, L::LDD, k + ((size_t)bh * Nk + k0) * D, BM, valid_k);
    load_rows<T, DV, kBwdThreads>(t.v, L::LDV, v + ((size_t)bh * Nk + k0) * DV, BM, valid_k);
    for (int q0 = 0; q0 < Nq; q0 += BM) {
      const int valid_q = min(BM, Nq - q0);
      __syncthreads();  // the previous q tile's readers are done
      const size_t row = (size_t)bh * Nq + q0;
      load_rows<T, D, kBwdThreads>(t.q, L::LDD, q + row * D, BM, valid_q);
      load_rows<T, DV, kBwdThreads>(t.dout, L::LDV, dout + row * DV, BM, valid_q);
      stage_q_rows<BM>(t.lse, t.dvec, lse + row, dvec + row, valid_q);
      __syncthreads();
      nt_product<T, BM, D, L::LDD, L::LDD, L::LDS>(t.k, t.q, t.s);          // S^T = K Q^T
      nt_product<T, BM, DV, L::LDV, L::LDV, L::LDS>(t.v, t.dout, t.dp);     // dP^T = V dO^T
      __syncthreads();
      probs_and_dscores<T, D, DV, true>(t, scale);
      __syncthreads();
      acc_v.template mma<L::LDS, L::LDV>(t.s, t.dout);   // dV += P^T dO
      acc_k.template mma<L::LDS, L::LDD>(t.dp, t.q);     // dK += dS^T Q
    }
  }
  const size_t out_row = (size_t)bh * Nk_out + k0;
  acc_k.store(dk + out_row * D, scale);
  acc_v.store(dv + out_row * DV, 1.f);
}

// fp32 only: the bf16 dq pass is flash_bwd_dq_sm90.cu.
template <int D, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ mask,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dq, int H, int Nq,
                        int Nk, int Nq_out, float scale) {
  using T = float;
  using L = BwdSmem<T, D, DV>;
  constexpr int BM = L::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  BwdTiles<T, D, DV> t(smem);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int valid_q = min(BM, Nq - q0);
  const size_t row = (size_t)bh * Nq + q0;
  load_rows<T, D, kBwdThreads>(t.q, L::LDD, q + row * D, BM, valid_q);
  load_rows<T, DV, kBwdThreads>(t.dout, L::LDV, dout + row * DV, BM, valid_q);
  stage_q_rows<BM>(t.lse, t.dvec, lse + row, dvec + row, valid_q);
  const float* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * DV;
  Acc<T, D> acc;
  acc.zero();

  for (int k0 = 0; k0 < Nk; k0 += BM) {
    const int valid = min(BM, Nk - k0);
    __syncthreads();  // the previous kv tile's readers are done
    if (!stage_kv_mask<BM>(t.mask, mrow ? mrow + k0 : nullptr, valid)) continue;
    load_rows<T, D, kBwdThreads>(t.k, L::LDD, kb + (size_t)k0 * D, BM, valid);
    load_rows<T, DV, kBwdThreads>(t.v, L::LDV, vb + (size_t)k0 * DV, BM, valid);
    __syncthreads();
    nt_product<T, BM, D, L::LDD, L::LDD, L::LDS>(t.q, t.k, t.s);          // S = Q K^T
    nt_product<T, BM, DV, L::LDV, L::LDV, L::LDS>(t.dout, t.v, t.dp);     // dP = dO V^T
    __syncthreads();
    probs_and_dscores<T, D, DV, false>(t, scale);
    __syncthreads();
    acc.template mma<L::LDS, L::LDD>(t.dp, t.k);  // dQ += dS K
  }
  acc.store(dq + ((size_t)bh * Nq_out + q0) * D, scale);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  const void* dout;
  const float* lse;
  const float* dvec;
  float* da;      // dK (dkv pass) or dQ (dq pass)
  float* db;      // dV (dkv pass)
  float* part;    // bf16 with splits > 1: dQ [splits, BH * Nq, D] or dK
                  // [splits, BH * rows_out, D] partials
  float* part_b;  // bf16 dkv with splits > 1: dV [splits, BH * rows_out, Dv] partials
  int BH, H, Nq, Nk, rows_out, splits;
  float scale;
  cudaStream_t stream;
};

template <typename T, bool DKV>
struct BwdLaunch {
  const BwdArgs& a;
  template <int D, int DV>
  cudaError_t operator()() const {
    using L = BwdSmem<T, D, DV>;
    const int n = DKV ? a.Nk : a.Nq;
    const dim3 grid((n + L::BM - 1) / L::BM, a.BH);
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    cudaError_t e;
    static unsigned long long smem_set = 0;
    if constexpr (DKV) {
      auto kern = flash_bwd_dkv_kernel<T, D, DV>;
      e = hopper::allow_smem(reinterpret_cast<const void*>(kern), (int)L::bytes, smem_set);
      if (e != cudaSuccess) return e;
      kern<<<grid, kBwdThreads, L::bytes, a.stream>>>(q, k, v, a.mask, dout, a.lse, a.dvec, a.da,
                                                       a.db, a.H, a.Nq, a.Nk, a.rows_out, a.scale);
    } else {
      auto kern = flash_bwd_dq_kernel<D, DV>;
      e = hopper::allow_smem(reinterpret_cast<const void*>(kern), (int)L::bytes, smem_set);
      if (e != cudaSuccess) return e;
      kern<<<grid, kBwdThreads, L::bytes, a.stream>>>(q, k, v, a.mask, dout, a.lse, a.dvec, a.da,
                                                       a.H, a.Nq, a.Nk, a.rows_out, a.scale);
    }
    return cudaGetLastError();
  }
};

// Only the (D, Dv) pairs the training paths reach: memory self-attention
// (256, 256), the low-rank memory cross-attention (256, 64), and the Hiera
// global blocks that 2D training differentiates (96, 96: hiera_t / s; 72,
// 72: hiera_l).
template <typename Fn>
cudaError_t dispatch_bwd_dims(int d, int dv, Fn&& fn) {
  if (d == 256 && dv == 256) return fn.template operator()<256, 256>();
  if (d == 256 && dv == 64) return fn.template operator()<256, 64>();
  if (d == 96 && dv == 96) return fn.template operator()<96, 96>();
  if (d == 72 && dv == 72) return fn.template operator()<72, 72>();
  return cudaErrorInvalidValue;
}

// The bf16 dkv pass on Hopper (flash_bwd_dkv_sm90.cu).
struct DkvSm90 {
  const BwdArgs& a;
  template <int D, int DV>
  cudaError_t operator()() const {
    return hopper::flash_bwd_dkv_sm90<D, DV>({a.q, a.k, a.v, a.mask, a.dout, a.lse, a.dvec, a.da,
                                              a.db, a.part, a.part_b, a.BH, a.H, a.Nq, a.Nk,
                                              a.rows_out, a.splits, a.scale, a.stream});
  }
};

// The bf16 dq pass on Hopper (flash_bwd_dq_sm90.cu).
struct DqSm90 {
  const BwdArgs& a;
  template <int D, int DV>
  cudaError_t operator()() const {
    return hopper::flash_bwd_dq_sm90<D, DV>({a.q, a.k, a.v, a.mask, a.dout, a.lse, a.dvec, a.da,
                                             a.part, a.BH, a.H, a.Nq, a.Nk, a.rows_out,
                                             a.splits, a.scale, a.stream});
  }
};

template <bool DKV>
int launch_bwd(const BwdArgs& a, int D, int Dv, int dtype) {
  if (a.BH <= 0 || a.H <= 0 || a.BH % a.H != 0 || a.Nq <= 0 || a.Nk <= 0 || a.rows_out % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (a.rows_out < (DKV ? a.Nk : a.Nq)) return (int)cudaErrorInvalidValue;
  // only the bf16 passes split (dq its kv range, dkv its q range)
  if (a.splits < 1 ||
      (a.splits > 1 && (dtype != 1 || a.part == nullptr || (DKV && a.part_b == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if constexpr (DKV)
      return (int)dispatch_bwd_dims(D, Dv, DkvSm90{a});
    else
      return (int)dispatch_bwd_dims(D, Dv, DqSm90{a});
  }
  if (dtype == 0) return (int)dispatch_bwd_dims(D, Dv, BwdLaunch<float, DKV>{a});
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace medsam2

// Inputs as the forward's: q [BH, Nq, D], k [BH, Nk, D], v [BH, Nk, Dv],
// mask [BH / H, Nk] float or NULL, all contiguous and 16-byte aligned in one
// dtype (0 = float32, 1 = bfloat16); dout [BH, Nq, Dv] in that dtype; lse and
// dvec [BH, Nq] float32. dk [BH, Nk_out, D] and dv [BH, Nk_out, Dv] float32,
// Nk_out >= Nk a multiple of 64. The bf16 pass may split its q tiles over
// `splits` blocks per kv tile: it then writes unscaled partials to part_k
// [splits, BH * Nk_out, D] and part_v [splits, BH * Nk_out, Dv] float32 (dk
// and dv untouched), which medsam2_flash_attention_bwd_dkv_sum adds; fp32
// takes splits = 1 only. Returns the cudaError_t of the launch.
extern "C" int medsam2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                               const float* mask, const void* dout,
                                               const float* lse, const float* dvec, float* dk,
                                               float* dv, float* part_k, float* part_v, int BH,
                                               int H, int Nq, int Nk, int Nk_out, int D, int Dv,
                                               float scale, int splits, int dtype,
                                               void* stream) {
  using namespace medsam2;
  const BwdArgs a{q,  k,  v,      mask,   dout, lse,    dvec,   dk,     dv,
                  part_k, part_v, BH, H, Nq, Nk, Nk_out, splits, scale,
                  static_cast<cudaStream_t>(stream)};
  return launch_bwd<true>(a, D, Dv, dtype);
}

// As above; dq [BH, Nq_out, D] float32, Nq_out >= Nq a multiple of 64. The
// bf16 pass may split its kv tiles over `splits` blocks per query tile: it
// then writes unscaled partials to part [splits, BH * Nq, D] float32 (dq
// untouched), which medsam2_flash_attention_bwd_dq_sum adds; fp32 takes
// splits = 1 only.
extern "C" int medsam2_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                              const float* mask, const void* dout,
                                              const float* lse, const float* dvec, float* dq,
                                              float* part, int BH, int H, int Nq, int Nk,
                                              int Nq_out, int D, int Dv, float scale, int splits,
                                              int dtype, void* stream) {
  using namespace medsam2;
  const BwdArgs a{q,  k,  v,  mask,   dout, lse, dvec, dq, nullptr, part, nullptr, BH, H, Nq, Nk,
                  Nq_out, splits, scale, static_cast<cudaStream_t>(stream)};
  return launch_bwd<false>(a, D, Dv, dtype);
}
