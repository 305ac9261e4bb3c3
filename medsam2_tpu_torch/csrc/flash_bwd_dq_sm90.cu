// bf16 flash-backward dQ pass for Hopper (sm_90a): warp-specialised wgmma +
// TMA, split-kv, and the fixed-order sum of the split partials.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernel
// medsam2_tpu/ops/attention.py:_bwd_dq_kernel (flash_attention_bwd.cu keeps
// the fp32 launch and the dispatch). For one (batch*head) slice, with lse the
// forward's per-row log-sum-exp and dvec = rowsum(dO * O):
//
//   P  = exp(min(S * scale - lse, 0)) * mask     S = Q K^T
//   dS = P * (dO V^T - dvec)                      rounded to bf16
//   dQ = scale * dS K                             fp32 accumulation
//
// What bounds it on the H100: 2 Nq Nk (2 D + Dv) flops against
// O((Nq + Nk)(D + Dv)) bytes, far above the ~295 flop/byte ridge at the
// training shapes: tensor-core issue. The design, hopper_attention.cuh's
// main loop with the backward's arithmetic:
// - Warpgroup 0 is the producer: one warp TMA-loads the block's Q and dO
//   rows once, then streams K and V 64-key tiles through the mbarrier ring
//   with each tile's mask values, skipping a tile whose keys are all masked
//   (the forward's produce_kv; the block's layout is the forward's Layout
//   with dO in its staging region).
// - Each consumer warpgroup owns 64 query rows. Per kv tile: S = Q K^T and
//   dP = dO V^T by wgmma with both operands in shared memory (V K-major
//   there), P and dS in fp32 registers (exp2 in log2 units, the mask as a
//   0/1 factor), dS rounded to bf16 straight into wgmma A fragments, and
//   dQ += dS K by wgmma with K MN-major. The 64 x D fp32 dQ accumulator stays
//   in registers over the whole kv range (128 registers at D = 256; 232 a
//   consumer thread through setmaxnreg).
// - Rows a block: 128 (two consumer warpgroups) at Dv = 64, 96 and 72; 64
//   (one) at Dv = 256, where Q and dO of 128 rows alone would take 128 KB
//   and leave no room for a two-stage ring.
// - Head dims 96 and 72 (the Hiera global blocks of hiera_t / s and
//   hiera_l) take the forward's column chunks (64 + 32, and 64 + 16 with
//   the columns past 72 zero-filled by TMA); the epilogue writes the D real
//   columns.
// - Split-kv: the wrapper splits the kv tiles over blocks when one block per
//   query tile leaves SMs idle (the forward's one-wave rule). With one split
//   a block writes scale * dQ; with more it writes its unscaled fp32 partial,
//   and dq_split_sum adds the partials in split order (no atomics, so the
//   result is deterministic) and scales them.
// Padded query rows get lse = +1e30 (P = 0); keys at or past Nk get mask 0.

#include "flash_bwd_sm90.cuh"
#include "hopper_attention.cuh"

namespace medsam2 {
namespace hopper {
namespace {

// Query rows a block: 128 (two consumer warpgroups) at DV = 64, 64 (one) at
// DV = 256.
template <int DV>
__host__ __device__ constexpr int dq_rows() { return DV == 256 ? 64 : 128; }
template <int DV>
__host__ __device__ constexpr int dq_out_bytes() { return dq_rows<DV>() * Cols<DV>::kPad * 2; }
// threads a block: the consumers and the producer warpgroup
template <int DV>
__host__ __device__ constexpr int dq_threads() { return 128 * (dq_rows<DV>() / 64 + 1); }

// The forward's layout at dq_rows query rows, with the dO tile of those rows
// in its staging region.
template <int D, int DV>
using DqLayout = Layout<D, DV, round1024(dq_out_bytes<DV>()), dq_rows<DV>()>;

struct DqMaps {
  CUtensorMap q64, q_rem, o64, o_rem, k64, k_rem, v64, v_rem;
};

struct DqArgs {
  const float* lse;
  const float* dvec;
  float* dq;    // splits == 1
  float* part;  // splits > 1
  int BH, Nq, rows_out;
  float scale, scale_log2;
};

template <int D, int DV, class L>
__device__ __forceinline__ void dq_consume(const Shared<L>& sh, int wg, const DqArgs& a, int bh,
                                           int q0, int split) {
  using CD = Cols<D>;
  using CV = Cols<DV>;
  constexpr int kA = CD::kPad / 2;  // dQ accumulator registers per thread
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r_a = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: r_a, r_a + 8
  const int valid_q = min(L::kRows, a.Nq - q0);
  const size_t row0 = (size_t)bh * a.Nq + q0;
  // lse in log2 units; a padded row gets +1e30, so its P is 0
  const float lse_a = r_a < valid_q ? a.lse[row0 + r_a] * kLog2e : 1e30f;
  const float lse_b = r_a + 8 < valid_q ? a.lse[row0 + r_a + 8] * kLog2e : 1e30f;
  const float dv_a = r_a < valid_q ? a.dvec[row0 + r_a] : 0.f;
  const float dv_b = r_a + 8 < valid_q ? a.dvec[row0 + r_a + 8] : 0.f;

  float acc[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(sh.q());
  const uint32_t do_addr = smem_u32(sh.staging());  // dO
  mbar_wait(sh.qbar(), 0);

  Ring ring;
  for (;;) {
    const int s = ring.stage;
    mbar_wait(sh.full(s), ring.phase);
    if (*sh.tile(s) < 0) break;

    // ---- S = Q K^T and dP = dO V^T, one commit group ----
    float sc[32], dp[32];
    const uint32_t k_addr = smem_u32(sh.k(s));
    const uint32_t v_addr = smem_u32(sh.v(s));
    wg_fence();
#pragma unroll
    for (int c = 0; c < CD::kChunks; ++c) {
      const int w = CD::width(c);
      const uint32_t pitch = 2 * w;
      const uint32_t qa = q_addr + CD::offset(c, L::kRows) + wg * 64 * pitch;
      const uint32_t ka = k_addr + CD::offset(c, kBK);
#pragma unroll
      for (int i = 0; i < w / 16; ++i)
        wgmma_ss_n64(sc, make_desc(qa + 32 * i, w, 16, 8 * pitch),
                     make_desc(ka + 32 * i, w, 16, 8 * pitch), (c | i) ? 1 : 0);
    }
#pragma unroll
    for (int c = 0; c < CV::kChunks; ++c) {
      const int w = CV::width(c);
      const uint32_t pitch = 2 * w;
      const uint32_t oa = do_addr + CV::offset(c, L::kRows) + wg * 64 * pitch;
      const uint32_t va = v_addr + CV::offset(c, kBK);
#pragma unroll
      for (int i = 0; i < w / 16; ++i)
        wgmma_ss_n64(dp, make_desc(oa + 32 * i, w, 16, 8 * pitch),
                     make_desc(va + 32 * i, w, 16, 8 * pitch), (c | i) ? 1 : 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    // ---- P and dS: rows r_a (e < 2) and r_a + 8, columns 8 j + 2 quad + (e & 1) ----
    const float* mk = sh.mask(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(mk + 8 * j + 2 * quad);
      const float p0 = exp2f(fminf(sc[4 * j] * a.scale_log2 - lse_a, 0.f)) * m2.x;
      const float p1 = exp2f(fminf(sc[4 * j + 1] * a.scale_log2 - lse_a, 0.f)) * m2.y;
      const float p2 = exp2f(fminf(sc[4 * j + 2] * a.scale_log2 - lse_b, 0.f)) * m2.x;
      const float p3 = exp2f(fminf(sc[4 * j + 3] * a.scale_log2 - lse_b, 0.f)) * m2.y;
      dp[4 * j] = p0 * (dp[4 * j] - dv_a);
      dp[4 * j + 1] = p1 * (dp[4 * j + 1] - dv_a);
      dp[4 * j + 2] = p2 * (dp[4 * j + 2] - dv_b);
      dp[4 * j + 3] = p3 * (dp[4 * j + 3] - dv_b);
    }
    // dS in bf16, the A fragments of the four 16-key steps
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);

    // ---- dQ += dS K, K MN-major ----
    fence_regs<kA>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < CD::kChunks; ++c) {
        const int w = CD::width(c);
        const uint32_t pitch = 2 * w;
        const uint64_t desc = make_desc(k_addr + CD::offset(c, kBK) + kk * 16 * pitch, w, 16,
                                        8 * pitch);
        if (w == 64)
          wgmma_rs_n64(acc + 32 * c, ds[kk], desc);
        else if (w == 32)
          wgmma_rs_n32(acc + 32 * c, ds[kk], desc);
        else
          wgmma_rs_n16(acc + 32 * c, ds[kk], desc);
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs<kA>(acc);
    mbar_arrive(sh.empty(s));
    ring.advance<L::kStages>();
  }

  // ---- epilogue: scale * dQ (one split) or the unscaled partial ----
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_a + 8 * hh;
    if (r >= valid_q) continue;
    float* dst;
    float f;
    if (a.dq != nullptr) {
      dst = a.dq + ((size_t)bh * a.rows_out + q0 + r) * D;
      f = a.scale;
    } else {
      dst = a.part + ((size_t)split * a.BH * a.Nq + row0 + r) * D;
      f = 1.f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * quad) =
          make_float2(acc[4 * j + 2 * hh] * f, acc[4 * j + 2 * hh + 1] * f);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(dq_threads<DV>(), 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ DqMaps maps, const float* __restrict__ mask,
                             const DqArgs args, int H, int Nk, int tiles_per_split) {
  using L = DqLayout<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  const Shared<L> sh(smem_raw);
  const int bh = blockIdx.z;
  const int split = blockIdx.y;
  const int q0 = blockIdx.x * L::kRows;
  if (threadIdx.x == 0) sh.init_barriers(1);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one warp issues every load ----
    if constexpr (L::kConsumers == 2) regs_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(sh.qbar(), L::kQBytes + dq_out_bytes<DV>());
      tma_tile<D>(sh.q(), L::kRows, &maps.q64, &maps.q_rem, sh.qbar(), q0, bh);
      tma_tile<DV>(sh.staging(), L::kRows, &maps.o64, &maps.o_rem, sh.qbar(), q0, bh);
    }
    produce_kv<D, DV>(sh, maps, mask, H, Nk, bh, split, tiles_per_split, lane);
  } else {
    if constexpr (L::kConsumers == 2) regs_inc<232>();
    dq_consume<D, DV>(sh, threadIdx.x / 128 - 1, args, bh, q0, split);
  }
}

// One output of a split sum: out[i] = scale * (((part[0][i] + part[1][i]) +
// part[2][i]) + ...), i over n4 float4s.
struct SumSeg {
  const float4* part;
  float4* out;
  size_t n4;
  float scale;
};

// The split sums of the bf16 backward passes: dQ (segment a only), or dK
// and dV of the dK/dV pass (segments a and b, one launch).
__global__ void __launch_bounds__(256)
    split_sum_kernel(const SumSeg a, const SumSeg b, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n4 + b.n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool in_a = i < a.n4;
    const float4* part = in_a ? a.part : b.part;
    const size_t n4 = in_a ? a.n4 : b.n4;
    const size_t j = in_a ? i : i - a.n4;
    const float scale = in_a ? a.scale : b.scale;
    float4 acc = part[j];
    for (int s = 1; s < splits; ++s) {
      const float4 x = part[s * n4 + j];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    (in_a ? a.out : b.out)[j] =
        make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
  }
}

}  // namespace

template <int D, int DV>
cudaError_t flash_bwd_dq_sm90(const DqCall& a) {
  using L = DqLayout<D, DV>;
  DqMaps maps;
  if (!make_maps<D>(&maps.q64, &maps.q_rem, a.q, a.Nq, a.BH, L::kRows) ||
      !make_maps<DV>(&maps.o64, &maps.o_rem, a.dout, a.Nq, a.BH, L::kRows) ||
      !make_maps<D>(&maps.k64, &maps.k_rem, a.k, a.Nk, a.BH, kBK) ||
      !make_maps<DV>(&maps.v64, &maps.v_rem, a.v, a.Nk, a.BH, kBK))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_sm90_kernel<D, DV>;
  static unsigned long long smem_set = 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), L::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = (a.Nk + kBK - 1) / kBK;
  const int per_split = (n_tiles + a.splits - 1) / a.splits;
  const DqArgs args{a.lse,  a.dvec, a.splits == 1 ? a.dq : nullptr,
                    a.splits > 1 ? a.part : nullptr, a.BH, a.Nq, a.rows_out, a.scale,
                    a.scale * kLog2e};
  const dim3 grid((a.Nq + L::kRows - 1) / L::kRows, a.splits, a.BH);
  kern<<<grid, dq_threads<DV>(), L::bytes, a.stream>>>(maps, a.mask, args, a.H, a.Nk, per_split);
  return cudaGetLastError();
}

template cudaError_t flash_bwd_dq_sm90<256, 256>(const DqCall&);
template cudaError_t flash_bwd_dq_sm90<256, 64>(const DqCall&);
template cudaError_t flash_bwd_dq_sm90<96, 96>(const DqCall&);
template cudaError_t flash_bwd_dq_sm90<72, 72>(const DqCall&);

}  // namespace hopper
}  // namespace medsam2

namespace {

int launch_split_sum(const medsam2::hopper::SumSeg& a, const medsam2::hopper::SumSeg& b,
                     int splits, void* stream) {
  const size_t n4 = a.n4 + b.n4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  medsam2::hopper::split_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The split-kv sum of the bf16 dQ pass: part [splits, rows, D] fp32 ->
// out [rows, D] fp32 = scale * the partials added in split order. D a
// multiple of 4, both 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int medsam2_flash_attention_bwd_dq_sum(const float* part, float* out, int splits,
                                                  int rows, int D, float scale, void* stream) {
  using medsam2::hopper::SumSeg;
  if (splits <= 0 || rows <= 0 || D <= 0 || D % 4) return (int)cudaErrorInvalidValue;
  const SumSeg a{reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
                 (size_t)rows * D / 4, scale};
  return launch_split_sum(a, SumSeg{nullptr, nullptr, 0, 0.f}, splits, stream);
}

// The split-q sum of the bf16 dK/dV pass, one launch: part_k [splits, rows,
// D] -> dk [rows, D] = scale * the partials added in split order, part_v
// [splits, rows, Dv] -> dv [rows, Dv] = their sum. D and Dv multiples of 4,
// all 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int medsam2_flash_attention_bwd_dkv_sum(const float* part_k, float* dk,
                                                   const float* part_v, float* dv, int splits,
                                                   int rows, int D, int Dv, float scale,
                                                   void* stream) {
  using medsam2::hopper::SumSeg;
  if (splits <= 0 || rows <= 0 || D <= 0 || Dv <= 0 || D % 4 || Dv % 4)
    return (int)cudaErrorInvalidValue;
  const SumSeg a{reinterpret_cast<const float4*>(part_k), reinterpret_cast<float4*>(dk),
                 (size_t)rows * D / 4, scale};
  const SumSeg b{reinterpret_cast<const float4*>(part_v), reinterpret_cast<float4*>(dv),
                 (size_t)rows * Dv / 4, 1.f};
  return launch_split_sum(a, b, splits, stream);
}
