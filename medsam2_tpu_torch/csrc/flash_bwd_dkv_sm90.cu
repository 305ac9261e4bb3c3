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
// - Head dims: the forward's column layout (hopper_attention.cuh Cols): a
//   tile is padded to a multiple of 16 columns and cut into 64-wide chunks
//   in the 128-byte swizzle plus one 32- or 16-wide chunk in the 64- or
//   32-byte swizzle (96 = 64 + 32, 72 -> 80 = 64 + 16), TMA zero-filling the
//   columns past the head dim; every product walks the chunks at their own
//   width.
// - Warpgroups 1 and 2 are consumers over the same 64 keys. Each computes
//   S^T and dP^T for its half of the 64 query columns by wgmma with both
//   operands in shared memory (m64n32), and P^T and dS^T in fp32 registers.
//   The two halves go to shared memory as bf16 [64][64] tiles in the
//   128-byte swizzle, the A operand's layout of the next products (a named
//   barrier over the 256 consumer threads publishes them, a second one
//   frees them for the next tile).
// - Each consumer owns half of dK's and dV's column chunks and adds
//   dV += P^T dO and dK += dS^T Q by wgmma with A = P^T / dS^T and B = dO / Q
//   (MN-major) from shared memory. dK chunk c goes to warpgroup c % 2; dV's
//   go the same way, or the other way round when the head dim ends in a
//   narrow chunk, so that at 96 (64 + 32) and 72 (64 + 16) each warpgroup
//   holds one wide and one narrow chunk (96 and 80 columns each); at
//   Dv = 64 warpgroup 1 holds none of dV. At D = Dv = 256 the 64 x 512 fp32
//   accumulators of one tile take 128 registers a consumer thread this way,
//   where one warpgroup holding all of them would need 256. The warpgroup is
//   a template argument of the consumer, so every chunk's width and owner is
//   known at compile time.
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
  // tiles of head dim W hold Cols<W>::kPad columns: whole 1024-byte units at
  // 64 rows, so every chunk region stays aligned to its swizzle
  static constexpr int kKBytes = kKvRows * Cols<D>::kPad * 2;
  static constexpr int kVBytes = kKvRows * Cols<DV>::kPad * 2;
  static constexpr int kQBytes = kQTile * Cols<D>::kPad * 2;
  static constexpr int kOBytes = kQTile * Cols<DV>::kPad * 2;
  static_assert(kKBytes % 1024 == 0 && kVBytes % 1024 == 0, "chunk regions 1024-aligned");
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
  CUtensorMap q64, q_rem, o64, o_rem, k64, k_rem, v64, v_rem;
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
    tma_tile<D>(sh.k(), kKvRows, &maps.k64, &maps.k_rem, sh.kvbar(), k0, bh);
    tma_tile<DV>(sh.v(), kKvRows, &maps.v64, &maps.v_rem, sh.kvbar(), k0, bh);
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
      tma_tile<D>(sh.q(s), kQTile, &maps.q64, &maps.q_rem, sh.full(s), q0, bh);
      tma_tile<DV>(sh.dout(s), kQTile, &maps.o64, &maps.o_rem, sh.full(s), q0, bh);
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

// C (+)= A B over the 16-row k steps of a 64-row tile, with A = P^T / dS^T
// (a [64][64] bf16 tile in the 128-byte swizzle) and B one W-wide chunk of
// dO / Q (MN-major, in its own swizzle): acc holds the chunk's 64 x W sums.
template <int W>
__device__ __forceinline__ void add_chunk_product(float* acc, uint32_t a_addr, uint32_t b_addr) {
  constexpr uint32_t pitch = 2 * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t da = make_desc(a_addr + 32 * i, 64, 16, 1024);
    const uint64_t db = make_desc(b_addr + i * 16 * pitch, W, 16, 8 * pitch);
    if constexpr (W == 64)
      wgmma_ss_n64_tb(acc, da, db);
    else if constexpr (W == 32)
      wgmma_ss_n32_tb(acc, da, db);
    else
      wgmma_ss_n16_tb(acc, da, db);
  }
}

// S^T (or dP^T) [64 keys][32 query columns] = A B^T over the head dim's
// chunks, A the block's K (or V) tile and B this warpgroup's 32 rows of the
// stage's Q (or dO) tile, both K-major.
template <int W>
__device__ __forceinline__ void scores_t(float* acc, uint32_t a_addr, uint32_t b_addr, int wg) {
  using C = Cols<W>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    const int w = C::width(c);
    const uint32_t pitch = 2 * w;
    const uint32_t a = a_addr + C::offset(c, kKvRows);
    const uint32_t b = b_addr + C::offset(c, kQTile) + wg * 32 * pitch;
#pragma unroll
    for (int i = 0; i < w / 16; ++i)
      wgmma_ss_n32(acc, make_desc(a + 32 * i, w, 16, 8 * pitch),
                   make_desc(b + 32 * i, w, 16, 8 * pitch), (c | i) ? 1 : 0);
  }
}

// Which chunks warpgroup WG owns: dK chunk c goes to warpgroup c % 2, dV
// chunk c to (c + kFlipV) % 2. The u-th owned chunk is 2 u + first.
template <int D, int DV, int WG>
struct DkvOwner {
  static constexpr int kCK = Cols<D>::kChunks;
  static constexpr int kCV = Cols<DV>::kChunks;
  // a head dim ending in a narrow chunk: give each warpgroup one of each
  static constexpr int kFlipV = Cols<D>::kRem != 0 ? 1 : 0;
  static constexpr int kFirstK = WG;
  static constexpr int kFirstV = WG ^ kFlipV;
  static constexpr int kMK = (kCK + 1) / 2;  // accumulator slots of 32 registers
  static constexpr int kMV = (kCV + 1) / 2;
};

// One owned chunk's epilogue rows: columns [64 c, 64 c + W) of rows r and
// r + 8 (h), cut at the head dim; scale f.
template <int W>
__device__ __forceinline__ void store_chunk(float* row_a, float* row_b, const float* acc,
                                           int col0, int width, int quad, float f) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (col0 + 8 * j >= width) continue;
    *reinterpret_cast<float2*>(row_a + col0 + 8 * j + 2 * quad) =
        make_float2(acc[4 * j] * f, acc[4 * j + 1] * f);
    *reinterpret_cast<float2*>(row_b + col0 + 8 * j + 2 * quad) =
        make_float2(acc[4 * j + 2] * f, acc[4 * j + 3] * f);
  }
}

template <int D, int DV, int WG, class L>
__device__ __forceinline__ void dkv_consume(const DkvShared<L>& sh, const DkvArgs& a,
                                            bool live, int bh, int k0, int split) {
  using CD = Cols<D>;
  using CV = Cols<DV>;
  using O = DkvOwner<D, DV, WG>;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r_a = warp * 16 + lane / 4;  // this thread's keys: r_a, r_a + 8
  const float m_a = sh.mask()[r_a];
  const float m_b = sh.mask()[r_a + 8];

  float acc_k[O::kMK * 32], acc_v[O::kMV * 32];
#pragma unroll
  for (int i = 0; i < O::kMK * 32; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < O::kMV * 32; ++i) acc_v[i] = 0.f;

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

      // ---- S^T = K Q^T and dP^T = V dO^T for query columns [32 WG, 32 WG + 32) ----
      float sc[16], dp[16];
      wg_fence();
      scores_t<D>(sc, k_addr, q_addr, WG);
      scores_t<DV>(dp, v_addr, o_addr, WG);
      wg_commit();
      wg_wait_all();
      fence_regs<16>(sc);
      fence_regs<16>(dp);

      // ---- P^T and dS^T: keys r_a (e < 2) / r_a + 8, query columns
      // 32 WG + 8 j + 2 quad + (e & 1) ----
      const float* l2 = sh.lse2(s);
      const float* dvv = sh.dvec(s);
      uint32_t pw[4][2], dw[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * WG + 8 * j + 2 * quad;
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
        const int col = 32 * WG + 8 * j + 2 * quad;
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
      fence_regs<O::kMV * 32>(acc_v);
      fence_regs<O::kMK * 32>(acc_k);
      wg_fence();
#pragma unroll
      for (int u = 0; u < O::kMV; ++u) {
        const int c = 2 * u + O::kFirstV;
        if (c < O::kCV) {
          const uint32_t b = o_addr + CV::offset(c, kQTile);
          if (CV::width(c) == 64)
            add_chunk_product<64>(acc_v + 32 * u, pt_addr, b);
          else if (CV::width(c) == 32)
            add_chunk_product<32>(acc_v + 32 * u, pt_addr, b);
          else
            add_chunk_product<16>(acc_v + 32 * u, pt_addr, b);
        }
      }
#pragma unroll
      for (int u = 0; u < O::kMK; ++u) {
        const int c = 2 * u + O::kFirstK;
        if (c < O::kCK) {
          const uint32_t b = q_addr + CD::offset(c, kQTile);
          if (CD::width(c) == 64)
            add_chunk_product<64>(acc_k + 32 * u, ds_addr, b);
          else if (CD::width(c) == 32)
            add_chunk_product<32>(acc_k + 32 * u, ds_addr, b);
          else
            add_chunk_product<16>(acc_k + 32 * u, ds_addr, b);
        }
      }
      wg_commit();
      wg_wait_all();
      fence_regs<O::kMV * 32>(acc_v);
      fence_regs<O::kMK * 32>(acc_k);
      mbar_arrive(sh.empty(s));
      ring.advance<L::kStages>();
    }
  }

  // ---- epilogue: scale * dK and dV (one split) or the unscaled partials ----
  const bool one = a.dk != nullptr;
  const size_t row_base = (size_t)bh * a.rows_out + k0;
  const size_t part_base = (size_t)split * a.BH * a.rows_out + row_base;
  const size_t row = (one ? row_base : part_base) + r_a;
  float* base_k = (one ? a.dk : a.part_k) + row * D;
  float* base_v = (one ? a.dv : a.part_v) + row * DV;
  const float fk = one ? a.scale : 1.f;
#pragma unroll
  for (int u = 0; u < O::kMK; ++u) {
    const int c = 2 * u + O::kFirstK;
    if (c >= O::kCK) continue;
    if (CD::width(c) == 64)
      store_chunk<64>(base_k, base_k + 8 * D, acc_k + 32 * u, 64 * c, D, quad, fk);
    else if (CD::width(c) == 32)
      store_chunk<32>(base_k, base_k + 8 * D, acc_k + 32 * u, 64 * c, D, quad, fk);
    else
      store_chunk<16>(base_k, base_k + 8 * D, acc_k + 32 * u, 64 * c, D, quad, fk);
  }
#pragma unroll
  for (int u = 0; u < O::kMV; ++u) {
    const int c = 2 * u + O::kFirstV;
    if (c >= O::kCV) continue;
    if (CV::width(c) == 64)
      store_chunk<64>(base_v, base_v + 8 * DV, acc_v + 32 * u, 64 * c, DV, quad, 1.f);
    else if (CV::width(c) == 32)
      store_chunk<32>(base_v, base_v + 8 * DV, acc_v + 32 * u, 64 * c, DV, quad, 1.f);
    else
      store_chunk<16>(base_v, base_v + 8 * DV, acc_v + 32 * u, 64 * c, DV, quad, 1.f);
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
    if (threadIdx.x < 256)
      dkv_consume<D, DV, 0>(sh, args, live, bh, k0, split);
    else
      dkv_consume<D, DV, 1>(sh, args, live, bh, k0, split);
  }
}

}  // namespace

template <int D, int DV>
cudaError_t flash_bwd_dkv_sm90(const DkvCall& a) {
  using L = DkvLayout<D, DV>;
  DkvMaps maps;
  if (!make_maps<D>(&maps.q64, &maps.q_rem, a.q, a.Nq, a.BH, kQTile) ||
      !make_maps<DV>(&maps.o64, &maps.o_rem, a.dout, a.Nq, a.BH, kQTile) ||
      !make_maps<D>(&maps.k64, &maps.k_rem, a.k, a.Nk, a.BH, kKvRows) ||
      !make_maps<DV>(&maps.v64, &maps.v_rem, a.v, a.Nk, a.BH, kKvRows))
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
template cudaError_t flash_bwd_dkv_sm90<96, 96>(const DkvCall&);
template cudaError_t flash_bwd_dkv_sm90<72, 72>(const DkvCall&);

}  // namespace hopper
}  // namespace medsam2
