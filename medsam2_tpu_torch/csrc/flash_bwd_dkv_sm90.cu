// bf16 flash-backward dK/dV pass for Hopper (sm_90a): warp-specialised
// wgmma + TMA, split over the query range.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernel
// medsam2_tpu/ops/attention.py:_bwd_dkv_kernel (flash_attention_bwd.cu keeps
// the fp32 launch and the dispatch). For one (batch*head) slice and one tile
// of 64 keys, with lse the forward's per-row log-sum-exp and
// dvec = rowsum(dO * O), in the transposed form (rows are keys):
//
//   S^T  = K Q^T                    P^T  = exp(min(S^T * scale - lse, 0)) * mask
//   dP^T = V dO^T                   dS^T = P^T * (dP^T - dvec)
//   dV   = sum over q tiles of P^T dO      (P^T rounded to bf16)
//   dK   = scale * sum of dS^T Q           (dS^T rounded to bf16)
//
// What bounds it on the H100: 2 Nq Nk (2 D + 2 Dv) flops against
// O((Nq + Nk)(D + Dv)) bytes, far above the ~295 flop/byte ridge at the
// training shapes: tensor-core issue. The design:
// - One block per (64-key tile, q split, b*h): warpgroup 0 is the producer.
//   One thread TMA-loads the block's K and V tiles once; one warp streams the
//   64-row Q and dO tiles of the block's q range through an mbarrier ring,
//   with each tile's lse (in log2 units; +1e30 for rows past Nq, so their P
//   is 0) and dvec rows written beside them.
// - Warpgroups 1 and 2 are consumers over the same 64 keys. Each computes
//   S^T and dP^T for its half of the 64 query columns by wgmma with both
//   operands in shared memory (m64n32), and P^T and dS^T in fp32 registers.
//   The two halves go to shared memory as bf16 [64][64] tiles in the
//   128-byte swizzle, the A operand's layout of the next products (a named
//   barrier over the 256 consumer threads publishes them, a second one
//   frees them for the next tile).
// - Each consumer owns half of dK's and dV's 64-column chunks (chunk c to
//   warpgroup c % 2; at Dv = 64 warpgroup 1 holds none of dV), and adds
//   dV += P^T dO and dK += dS^T Q by wgmma with A = P^T / dS^T and B = dO / Q
//   (MN-major) from shared memory. At D = Dv = 256 the 64 x 512 fp32
//   accumulators of one tile take 128 registers a consumer thread this way,
//   where one warpgroup holding all of them would need 256.
// - Masks: the keys' mask values are read once; a tile whose keys are all
//   masked loads and computes nothing and writes zeros; masked keys have
//   P^T = 0, so zero dK and dV rows.
// - Split: with blocks too few to fill the card (self-attention @512: 16 key
//   tiles x 2), the wrapper splits each tile's q range by the forward's
//   one-wave rule; a split writes unscaled fp32 partial dK and dV, and
//   flash_attention_bwd_dkv_sum adds them in split order (no atomics,
//   deterministic) and scales dK.

#include "flash_bwd_sm90.cuh"
#include "hopper_attention.cuh"

namespace medsam2 {
namespace hopper {
namespace {

constexpr int kKvRows = 64;  // keys a block
constexpr int kQTile = 64;   // query rows a ring stage

template <int D, int DV>
struct DkvLayout {
  static_assert(D % 64 == 0 && DV % 64 == 0, "head dims in whole 64-column chunks");
  static constexpr int kKBytes = kKvRows * D * 2;
  static constexpr int kVBytes = kKvRows * DV * 2;
  static constexpr int kQBytes = kQTile * D * 2;
  static constexpr int kOBytes = kQTile * DV * 2;
  static constexpr int kPBytes = kKvRows * kQTile * 2;  // one bf16 [64][64] tile
  static constexpr int kMisc = 3072;  // lse / dvec rows, mask, tile indices, barriers
  static constexpr int kFixed = kKBytes + kVBytes + 2 * kPBytes + kMisc + 1024;
  static constexpr int kStageBytes = kQBytes + kOBytes;
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static_assert(kStages >= 2, "two q stages do not fit");
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + kKBytes;
  static constexpr int p_off = v_off + kVBytes;
  static constexpr int ds_off = p_off + kPBytes;
  static constexpr int q_off = ds_off + kPBytes;
  static constexpr int o_off = q_off + kStages * kQBytes;
  static constexpr int lse_off = o_off + kStages * kOBytes;  // kStages x 64 floats
  static constexpr int dvec_off = lse_off + 4 * kQTile * 4;   // kStages x 64 floats
  static constexpr int mask_off = dvec_off + 4 * kQTile * 4;  // 64 floats
  static constexpr int idx_off = mask_off + kKvRows * 4;      // kStages ints
  static constexpr int bar_off = idx_off + 64;                // full, empty, kv
  static constexpr int bytes = bar_off + 128 + 1024;
  static_assert(bar_off + 128 <= lse_off + kMisc, "misc region overflows");
  static_assert(bytes <= kSmemLimit, "block does not fit the 227 KB a block may use");
};

struct DkvMaps {
  CUtensorMap q64, o64, k64, v64;
};

struct DkvArgs {
  const float* lse;
  const float* dvec;
  const float* mask;
  float* dk;      // splits == 1
  float* dv;
  float* part_k;  // splits > 1
  float* part_v;
  int BH, H, Nq, Nk, rows_out;
  float scale, scale_log2;
};

template <class L>
struct DkvShared {
  unsigned char* base;
  __device__ explicit DkvShared(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                              ~uintptr_t(1023))) {}
  __device__ unsigned char* k() const { return base + L::k_off; }
  __device__ unsigned char* v() const { return base + L::v_off; }
  __device__ unsigned char* pt() const { return base + L::p_off; }
  __device__ unsigned char* dst() const { return base + L::ds_off; }
  __device__ unsigned char* q(int s) const { return base + L::q_off + s * L::kQBytes; }
  __device__ unsigned char* dout(int s) const { return base + L::o_off + s * L::kOBytes; }
  __device__ float* lse2(int s) const {
    return reinterpret_cast<float*>(base + L::lse_off) + s * kQTile;
  }
  __device__ float* dvec(int s) const {
    return reinterpret_cast<float*>(base + L::dvec_off) + s * kQTile;
  }
  __device__ float* mask() const { return reinterpret_cast<float*>(base + L::mask_off); }
  __device__ int* tile(int s) const { return reinterpret_cast<int*>(base + L::idx_off) + s; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + L::bar_off) + s;
  }
  __device__ uint64_t* empty(int s) const {
    return reinterpret_cast<uint64_t*>(base + L::bar_off) + 4 + s;
  }
  __device__ uint64_t* kvbar() const { return reinterpret_cast<uint64_t*>(base + L::bar_off) + 8; }
};

template <int D, int DV, class L>
__device__ __forceinline__ void dkv_produce(const DkvShared<L>& sh, const DkvMaps& maps,
                                            const DkvArgs& a, int bh, int k0, int t0, int t1,
                                            int lane) {
  if (lane == 0) {
    mbar_arrive_expect_tx(sh.kvbar(), L::kKBytes + L::kVBytes);
    tma_tile<D>(sh.k(), kKvRows, &maps.k64, nullptr, sh.kvbar(), k0, bh);
    tma_tile<DV>(sh.v(), kKvRows, &maps.v64, nullptr, sh.kvbar(), k0, bh);
  }
  const size_t row0 = (size_t)bh * a.Nq;
  Ring ring;
  for (int t = t0; t < t1; ++t) {
    const int s = ring.stage;
    mbar_wait(sh.empty(s), ring.phase ^ 1u);
    const int q0 = t * kQTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      const bool in = q0 + r < a.Nq;
      sh.lse2(s)[r] = in ? a.lse[row0 + q0 + r] * kLog2e : 1e30f;
      sh.dvec(s)[r] = in ? a.dvec[row0 + q0 + r] : 0.f;
    }
    if (lane == 0) *sh.tile(s) = t;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_expect_tx(sh.full(s), L::kQBytes + L::kOBytes);
      tma_tile<D>(sh.q(s), kQTile, &maps.q64, nullptr, sh.full(s), q0, bh);
      tma_tile<DV>(sh.dout(s), kQTile, &maps.o64, nullptr, sh.full(s), q0, bh);
    }
    ring.advance<L::kStages>();
  }
  const int s = ring.stage;
  mbar_wait(sh.empty(s), ring.phase ^ 1u);
  if (lane == 0) {
    *sh.tile(s) = -1;  // range done
    mbar_arrive(sh.full(s));
  }
}

template <int D, int DV, class L>
__device__ __forceinline__ void dkv_consume(const DkvShared<L>& sh, int wg, const DkvArgs& a,
                                            bool live, int bh, int k0, int split) {
  constexpr int kCK = D / 64;          // dK chunks
  constexpr int kCV = DV / 64;         // dV chunks
  constexpr int kMK = (kCK + 1) / 2;   // dK chunks a warpgroup: c = 2 u + wg
  constexpr int kMV = (kCV + 1) / 2;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r_a = warp * 16 + lane / 4;  // this thread's keys: r_a, r_a + 8
  const float m_a = sh.mask()[r_a];
  const float m_b = sh.mask()[r_a + 8];

  float acc_k[kMK * 32], acc_v[kMV * 32];
#pragma unroll
  for (int i = 0; i < kMK * 32; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kMV * 32; ++i) acc_v[i] = 0.f;

  const uint32_t k_addr = smem_u32(sh.k());
  const uint32_t v_addr = smem_u32(sh.v());
  const uint32_t pt_addr = smem_u32(sh.pt());
  const uint32_t ds_addr = smem_u32(sh.dst());
  unsigned char* pt = sh.pt();
  unsigned char* dst = sh.dst();
  if (live) {
    mbar_wait(sh.kvbar(), 0);
    Ring ring;
    for (;;) {
      const int s = ring.stage;
      mbar_wait(sh.full(s), ring.phase);
      if (*sh.tile(s) < 0) break;
      const uint32_t q_addr = smem_u32(sh.q(s));
      const uint32_t o_addr = smem_u32(sh.dout(s));

      // ---- S^T = K Q^T and dP^T = V dO^T for query columns [32 wg, 32 wg + 32) ----
      float sc[16], dp[16];
      wg_fence();
#pragma unroll
      for (int c = 0; c < kCK; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wgmma_ss_n32(sc, make_desc(k_addr + c * kKvRows * 128 + 32 * i, 64, 16, 1024),
                       make_desc(q_addr + c * kQTile * 128 + wg * 32 * 128 + 32 * i, 64, 16, 1024),
                       (c | i) ? 1 : 0);
#pragma unroll
      for (int c = 0; c < kCV; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wgmma_ss_n32(dp, make_desc(v_addr + c * kKvRows * 128 + 32 * i, 64, 16, 1024),
                       make_desc(o_addr + c * kQTile * 128 + wg * 32 * 128 + 32 * i, 64, 16, 1024),
                       (c | i) ? 1 : 0);
      wg_commit();
      wg_wait_all();
      fence_regs<16>(sc);
      fence_regs<16>(dp);

      // ---- P^T and dS^T: keys r_a (e < 2) / r_a + 8, query columns
      // 32 wg + 8 j + 2 quad + (e & 1) ----
      const float* l2 = sh.lse2(s);
      const float* dvv = sh.dvec(s);
      uint32_t pw[4][2], dw[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * wg + 8 * j + 2 * quad;
        const float2 lq = *reinterpret_cast<const float2*>(l2 + col);
        const float2 dq = *reinterpret_cast<const float2*>(dvv + col);
        const float p0 = exp2f(fminf(sc[4 * j] * a.scale_log2 - lq.x, 0.f)) * m_a;
        const float p1 = exp2f(fminf(sc[4 * j + 1] * a.scale_log2 - lq.y, 0.f)) * m_a;
        const float p2 = exp2f(fminf(sc[4 * j + 2] * a.scale_log2 - lq.x, 0.f)) * m_b;
        const float p3 = exp2f(fminf(sc[4 * j + 3] * a.scale_log2 - lq.y, 0.f)) * m_b;
        pw[j][0] = pack_bf16(p0, p1);
        pw[j][1] = pack_bf16(p2, p3);
        dw[j][0] = pack_bf16(p0 * (dp[4 * j] - dq.x), p1 * (dp[4 * j + 1] - dq.y));
        dw[j][1] = pack_bf16(p2 * (dp[4 * j + 2] - dq.x), p3 * (dp[4 * j + 3] - dq.y));
      }
      // the previous tile's products have read P^T and dS^T in both warpgroups
      named_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * wg + 8 * j + 2 * quad;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_a + 8 * h;
          *reinterpret_cast<uint32_t*>(pt + swz128(r, col)) = pw[j][h];
          *reinterpret_cast<uint32_t*>(dst + swz128(r, col)) = dw[j][h];
        }
      }
      fence_proxy_async();
      named_sync(2, 256);

      // ---- dV += P^T dO and dK += dS^T Q over this warpgroup's chunks ----
      fence_regs<kMV * 32>(acc_v);
      fence_regs<kMK * 32>(acc_k);
      wg_fence();
#pragma unroll
      for (int u = 0; u < kMV; ++u) {
        const int c = 2 * u + wg;
        if (c < kCV) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wgmma_ss_n64_tb(acc_v + 32 * u, make_desc(pt_addr + 32 * i, 64, 16, 1024),
                            make_desc(o_addr + c * kQTile * 128 + i * 16 * 128, 64, 16, 1024));
        }
      }
#pragma unroll
      for (int u = 0; u < kMK; ++u) {
        const int c = 2 * u + wg;
        if (c < kCK) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wgmma_ss_n64_tb(acc_k + 32 * u, make_desc(ds_addr + 32 * i, 64, 16, 1024),
                            make_desc(q_addr + c * kQTile * 128 + i * 16 * 128, 64, 16, 1024));
        }
      }
      wg_commit();
      wg_wait_all();
      fence_regs<kMV * 32>(acc_v);
      fence_regs<kMK * 32>(acc_k);
      mbar_arrive(sh.empty(s));
      ring.advance<L::kStages>();
    }
  }

  // ---- epilogue: scale * dK and dV (one split) or the unscaled partials ----
  const bool one = a.dk != nullptr;
  const size_t row_base = (size_t)bh * a.rows_out + k0;
  const size_t part_base = (size_t)split * a.BH * a.rows_out + row_base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (one ? row_base : part_base) + r_a + 8 * h;
#pragma unroll
    for (int u = 0; u < kMK; ++u) {
      const int c = 2 * u + wg;
      if (c >= kCK) continue;
      float* dst_k = (one ? a.dk : a.part_k) + row * D + 64 * c;
      const float f = one ? a.scale : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst_k + 8 * j + 2 * quad) = make_float2(
            acc_k[32 * u + 4 * j + 2 * h] * f, acc_k[32 * u + 4 * j + 2 * h + 1] * f);
    }
#pragma unroll
    for (int u = 0; u < kMV; ++u) {
      const int c = 2 * u + wg;
      if (c >= kCV) continue;
      float* dst_v = (one ? a.dv : a.part_v) + row * DV + 64 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst_v + 8 * j + 2 * quad) =
            make_float2(acc_v[32 * u + 4 * j + 2 * h], acc_v[32 * u + 4 * j + 2 * h + 1]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ DkvMaps maps, const DkvArgs args,
                              int tiles_per_split) {
  using L = DkvLayout<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  const DkvShared<L> sh(smem_raw);
  const int bh = blockIdx.z;
  const int split = blockIdx.y;
  const int k0 = blockIdx.x * kKvRows;
  const int n_qt = (args.Nq + kQTile - 1) / kQTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_qt, t0 + tiles_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(sh.full(s), 1);
      mbar_init(sh.empty(s), 256);
    }
    mbar_init(sh.kvbar(), 1);
    fence_barrier_init();
  }
  // the keys' mask values (0 past Nk); a tile with none attending is skipped
  float m = 0.f;
  if (threadIdx.x < kKvRows) {
    const int key = k0 + threadIdx.x;
    if (key < args.Nk)
      m = args.mask != nullptr ? args.mask[(size_t)(bh / args.H) * args.Nk + key] : 1.f;
    sh.mask()[threadIdx.x] = m;
  }
  const bool live = __syncthreads_or(m > 0.f) != 0;

  if (threadIdx.x < 128) {
    // ---- producer: one warp issues every load ----
    regs_dec<40>();
    if (threadIdx.x >= 32 || !live) return;
    dkv_produce<D, DV>(sh, maps, args, bh, k0, t0, t1, threadIdx.x);
  } else {
    regs_inc<232>();
    dkv_consume<D, DV>(sh, threadIdx.x / 128 - 1, args, live, bh, k0, split);
  }
}

}  // namespace

template <int D, int DV>
cudaError_t flash_bwd_dkv_sm90(const DkvCall& a) {
  using L = DkvLayout<D, DV>;
  DkvMaps maps;
  CUtensorMap unused;
  if (!make_maps<D>(&maps.q64, &unused, a.q, a.Nq, a.BH, kQTile) ||
      !make_maps<DV>(&maps.o64, &unused, a.dout, a.Nq, a.BH, kQTile) ||
      !make_maps<D>(&maps.k64, &unused, a.k, a.Nk, a.BH, kKvRows) ||
      !make_maps<DV>(&maps.v64, &unused, a.v, a.Nk, a.BH, kKvRows))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_sm90_kernel<D, DV>;
  static unsigned long long smem_set = 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), L::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const int n_qt = (a.Nq + kQTile - 1) / kQTile;
  const int per_split = (n_qt + a.splits - 1) / a.splits;
  const DkvArgs args{a.lse,
                     a.dvec,
                     a.mask,
                     a.splits == 1 ? a.dk : nullptr,
                     a.splits == 1 ? a.dv : nullptr,
                     a.splits > 1 ? a.part_k : nullptr,
                     a.splits > 1 ? a.part_v : nullptr,
                     a.BH,
                     a.H,
                     a.Nq,
                     a.Nk,
                     a.rows_out,
                     a.scale,
                     a.scale * kLog2e};
  const dim3 grid((a.Nk + kKvRows - 1) / kKvRows, a.splits, a.BH);
  kern<<<grid, 384, L::bytes, a.stream>>>(maps, args, per_split);
  return cudaGetLastError();
}

template cudaError_t flash_bwd_dkv_sm90<256, 256>(const DkvCall&);
template cudaError_t flash_bwd_dkv_sm90<256, 64>(const DkvCall&);

}  // namespace hopper
}  // namespace medsam2
