// Storage-order cross-attention over the memory bank's roped-key cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/attention.py:_kv_cached_kernel
// (reached through kv_cached_attention <- transformer.rope_attn_storage).
// Single kv head. For each bank slot f the key tile is
// kcache[b, f, layer] + pos_rows[row_of_slot[f], layer], summed in the cache
// dtype (to fp32, add, round); values are the raw 64-wide memory features
// v_slots[b, f]; the trailing tiles carry the object-pointer keys ptr_k and
// values ptr_v. Nothing is gathered, concatenated or re-ordered in device
// memory.
//
// Differences from the TPU kernel, by design:
// - The producer reads row_of_slot itself (the TPU prefetched it as a
//   scalar) and clamps it into [0, Rr), as the TPU's index maps would.
// - Any P and any Nptr: slot and pointer tails are ragged tiles masked inside
//   the kernel (the TPU wrapper fell back to XLA when no aligned block divided
//   P or when Nptr exceeded one block).
// - A tile whose keys are all masked (a stale ring slot, pointer padding)
//   skips its loads and dots, as the TPU kernel's pl.when did.
//
// bfloat16: the wgmma + TMA main loop of hopper_attention.cuh. The producer
// warpgroup TMA-loads the kcache and pos_rows tiles into two staging buffers
// in the same 128-byte swizzle, sums them element by element into the
// stage's K buffer (identically swizzled tiles need no un-swizzling), fences
// the generic-proxy writes for wgmma and arrives on the stage's barrier; the
// V tile and pointer tiles load straight into the stage. The kv tiles (the
// slots' tiles, then the pointer tiles) are split over `splits` blocks, grid
// (ceil(Nq / 128), splits, B), so a B = 1 call fills the card; the partial
// outputs go through attention_merge (flash_attention.cu).
// float32: the FMA design of attention_tile.cuh, grid (ceil(Nq / 64), B).
//
// What bounds it on the H100: per call 2*Nq*(F*P+Nptr)*(C+Dv) flops (86 GF at
// 1024 px, B=1) against the layer's slice of the cache (F*P*C, 16.8 MB bf16)
// plus its positional rows, which every q block re-reads from L2. Tensor-core
// issue bounds it; the producer's two tile loads and its sum per tile are
// what the consumers wait for when they do wait.
//
// Instantiated only for the widths every SAM2 variant gives it: C = d_model =
// 256, Dv = mem_dim = 64.

#include "attention_tile.cuh"
#include "hopper_attention.cuh"

namespace medsam2 {
namespace {

constexpr int kKvC = 256;
constexpr int kKvDv = 64;

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
  float* o_part;
  float* lse_part;
  int B, Nq, F, L, P, Nptr, Rr, layer, splits;
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

template <int C, int DV>
__global__ void __launch_bounds__(kThreads)
    kv_cached_f32_kernel(const float* __restrict__ q, const float* __restrict__ kcache,
                         const float* __restrict__ pos_rows, const int* __restrict__ row_of_slot,
                         const float* __restrict__ ptr_k, const float* __restrict__ v_slots,
                         const float* __restrict__ ptr_v, const float* __restrict__ mask,
                         float* __restrict__ out, int Nq, int F, int L, int P, int Nptr, int Rr,
                         int layer, float scale) {
  using Lay = Smem<C, DV>;
  constexpr int BK = Lay::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<C, DV> t(smem);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int valid_q = min(kBQ, Nq - q0);
  init_block(t, q + ((size_t)b * Nq + q0) * C, valid_q);
  const float* mrow = mask + (size_t)b * ((size_t)F * P + Nptr);

  for (int f = 0; f < F; ++f) {
    // out-of-range rows clamp, as the TPU's index maps would
    const int row = min(max(row_of_slot[f], 0), Rr - 1);
    const float* kc = kcache + (((size_t)b * F + f) * L + layer) * (size_t)P * C;
    const float* pr = pos_rows + ((size_t)row * L + layer) * (size_t)P * C;
    const float* vs = v_slots + ((size_t)b * F + f) * (size_t)P * DV;
    for (int p0 = 0; p0 < P; p0 += BK) {
      const int valid = min(BK, P - p0);
      __syncthreads();
      if (!stage_mask(t, mrow + (size_t)f * P + p0, valid)) continue;
      load_rows_sum<float, C>(t.k, Lay::LDK, kc + (size_t)p0 * C, pr + (size_t)p0 * C, BK, valid);
      load_rows<float, DV>(t.v, Lay::LDV, vs + (size_t)p0 * DV, BK, valid);
      __syncthreads();
      attend_tile(t, scale);
    }
  }
  const float* pkb = ptr_k + (size_t)b * Nptr * C;
  const float* pvb = ptr_v + (size_t)b * Nptr * DV;
  for (int p0 = 0; p0 < Nptr; p0 += BK) {
    const int valid = min(BK, Nptr - p0);
    __syncthreads();
    if (!stage_mask(t, mrow + (size_t)F * P + p0, valid)) continue;
    load_rows<float, C>(t.k, Lay::LDK, pkb + (size_t)p0 * C, BK, valid);
    load_rows<float, DV>(t.v, Lay::LDV, pvb + (size_t)p0 * DV, BK, valid);
    __syncthreads();
    attend_tile(t, scale);
  }
  __syncthreads();
  write_out(t, out + ((size_t)b * Nq + q0) * DV, valid_q);
}

cudaError_t launch_f32(const KvArgs& a) {
  using Lay = Smem<kKvC, kKvDv>;
  auto kern = kv_cached_f32_kernel<kKvC, kKvDv>;
  static unsigned long long smem_set = 0;
  const cudaError_t e =
      hopper::allow_smem(reinterpret_cast<const void*>(kern), (int)Lay::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Nq + kBQ - 1) / kBQ, a.B);
  kern<<<grid, kThreads, Lay::bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kcache),
      static_cast<const float*>(a.pos_rows), a.row_of_slot, static_cast<const float*>(a.ptr_k),
      static_cast<const float*>(a.v_slots), static_cast<const float*>(a.ptr_v), a.mask,
      static_cast<float*>(a.out), a.Nq, a.F, a.L, a.P, a.Nptr, a.Rr, a.layer, a.scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

using namespace hopper;

struct KvMaps {
  CUtensorMap q, kc, pos, pk, vs, pv;  // every box 64 columns wide
};

// two [kBK][C] staging tiles: the kcache rows and their positional rows
constexpr int kStaging = 2 * kBK * kKvC * 2;
using KvLayout = Layout<kKvC, kKvDv, kStaging>;

__global__ void __launch_bounds__(hopper::kThreads, 1)
    kv_cached_sm90_kernel(const __grid_constant__ KvMaps maps, const int* __restrict__ row_of_slot,
                          const float* __restrict__ mask, const OutArgs oa, int Nq, int F, int L,
                          int P, int Nptr, int Rr, int layer, int tiles_per_split,
                          float scale_log2) {
  using Lay = KvLayout;
  extern __shared__ unsigned char smem_raw[];
  const Shared<Lay> sh(smem_raw);
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int q0 = blockIdx.x * hopper::kBQ;
  // a stage is full after the TMA bytes have landed and two arrivals: the
  // one that set the expected bytes and the producer's once K is in place
  if (threadIdx.x == 0) sh.init_barriers(2);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    regs_dec<40>();
    const int t = threadIdx.x;
    const int lane = t % 32;
    if (t == 0) {
      mbar_arrive_expect_tx(sh.qbar(), Lay::kQBytes);
      tma_tile<kKvC>(sh.q(), hopper::kBQ, &maps.q, &maps.q, sh.qbar(), q0, b);
    }
    const int slot_tiles = (P + kBK - 1) / kBK;
    const int n_tiles = F * slot_tiles + (Nptr + kBK - 1) / kBK;
    const int t0 = split * tiles_per_split;
    const int t1 = min(n_tiles, t0 + tiles_per_split);
    const float* mrow = mask + (size_t)b * ((size_t)F * P + Nptr);
    Ring ring;
    uint32_t stg_phase = 0;
    for (int tile = t0; tile < t1; ++tile) {
      const bool ptr = tile >= F * slot_tiles;
      const int f = ptr ? -1 : tile / slot_tiles;
      const int p0 = (ptr ? tile - F * slot_tiles : tile % slot_tiles) * kBK;
      const int valid = min(kBK, (ptr ? Nptr : P) - p0);
      const float* mt = mrow + (ptr ? (size_t)F * P : (size_t)f * P) + p0;
      // every warp reads the tile's mask, so all four agree on skipping it
      const float m0 = lane < valid ? mt[lane] : 0.f;
      const float m1 = lane + 32 < valid ? mt[lane + 32] : 0.f;
      if (!__any_sync(0xffffffffu, m0 > 0.f || m1 > 0.f)) continue;  // stale slot, padding
      const int s = ring.stage;
      mbar_wait(sh.empty(s), ring.phase ^ 1u);
      if (t < 32) {
        sh.mask(s)[lane] = m0;
        sh.mask(s)[lane + 32] = m1;
        if (lane == 0) *sh.tile(s) = tile;
      }
      if (ptr) {
        if (t == 0) {
          mbar_arrive_expect_tx(sh.full(s), Lay::kKBytes + Lay::kVBytes);
          tma_tile<kKvC>(sh.k(s), kBK, &maps.pk, &maps.pk, sh.full(s), p0, b);
          tma_tile<kKvDv>(sh.v(s), kBK, &maps.pv, &maps.pv, sh.full(s), p0, b);
        }
      } else {
        const int row = min(max(row_of_slot[f], 0), Rr - 1);
        unsigned char* stg = sh.staging();
        if (t == 0) {
          mbar_arrive_expect_tx(sh.full(s), Lay::kVBytes);
          tma_tile<kKvDv>(sh.v(s), kBK, &maps.vs, &maps.vs, sh.full(s), p0, b * F + f);
          mbar_arrive_expect_tx(sh.stgbar(), 2 * Lay::kKBytes);
          tma_tile<kKvC>(stg, kBK, &maps.kc, &maps.kc, sh.stgbar(), p0, (b * F + f) * L + layer);
          tma_tile<kKvC>(stg + Lay::kKBytes, kBK, &maps.pos, &maps.pos, sh.stgbar(), p0,
                         row * L + layer);
        }
        mbar_wait(sh.stgbar(), stg_phase);
        stg_phase ^= 1u;
        // K = kcache + pos, in bf16 (to fp32, add, round), same swizzled places
        const uint4* ka = reinterpret_cast<const uint4*>(stg);
        const uint4* kb = reinterpret_cast<const uint4*>(stg + Lay::kKBytes);
        uint4* kd = reinterpret_cast<uint4*>(sh.k(s));
#pragma unroll 4
        for (int i = t; i < Lay::kKBytes / 16; i += 128) {
          const uint4 x = ka[i];
          const uint4 y = kb[i];
          uint4 z;
          const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
          __nv_bfloat162* za = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fx = __bfloat1622float2(xa[e]);
            const float2 fy = __bfloat1622float2(ya[e]);
            za[e] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
          }
          kd[i] = z;
        }
        fence_proxy_async();  // the sum is read by wgmma; staging is next written by TMA
      }
      // every producer thread is done with this tile's staging, mask and K
      named_sync(1, 128);
      if (t == 0) mbar_arrive(sh.full(s));
      ring.advance<Lay::kStages>();
    }
    const int s = ring.stage;
    mbar_wait(sh.empty(s), ring.phase ^ 1u);
    if (t == 0) {
      *sh.tile(s) = -1;  // range done
      mbar_arrive(sh.full(s));
      mbar_arrive(sh.full(s));
    }
  } else {
    regs_inc<232>();
    consume<kKvC, kKvDv>(sh, threadIdx.x / 128 - 1, scale_log2, oa, b * Nq + q0,
                         min(hopper::kBQ, Nq - q0), split);
  }
}

cudaError_t launch_sm90(const KvArgs& a) {
  // an empty tensor still needs device memory behind its map; nothing is loaded
  const void* kc = a.F * a.P > 0 ? a.kcache : a.q;
  const void* pos = a.F * a.P > 0 ? a.pos_rows : a.q;
  const void* vs = a.F * a.P > 0 ? a.v_slots : a.q;
  const void* pk = a.Nptr > 0 ? a.ptr_k : a.q;
  const void* pv = a.Nptr > 0 ? a.ptr_v : a.q;
  KvMaps maps;
  if (!make_map(&maps.q, a.q, kKvC, a.Nq, a.B, 64, hopper::kBQ) ||
      !make_map(&maps.kc, kc, kKvC, a.P, (uint64_t)a.B * a.F * a.L, 64, kBK) ||
      !make_map(&maps.pos, pos, kKvC, a.P, (uint64_t)a.Rr * a.L, 64, kBK) ||
      !make_map(&maps.pk, pk, kKvC, a.Nptr, a.B, 64, kBK) ||
      !make_map(&maps.vs, vs, kKvDv, a.P, (uint64_t)a.B * a.F, 64, kBK) ||
      !make_map(&maps.pv, pv, kKvDv, a.Nptr, a.B, 64, kBK))
    return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kv_cached_sm90_kernel),
                                   KvLayout::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = a.F * ((a.P + kBK - 1) / kBK) + (a.Nptr + kBK - 1) / kBK;
  const int per_split = (n_tiles + a.splits - 1) / a.splits;
  OutArgs oa{nullptr, nullptr, nullptr, nullptr, a.B * a.Nq};
  if (a.splits == 1) {
    oa.out = static_cast<hopper::bf16*>(a.out);
  } else {
    oa.o_part = a.o_part;
    oa.lse_part = a.lse_part;
  }
  const dim3 grid((a.Nq + hopper::kBQ - 1) / hopper::kBQ, a.splits, a.B);
  kv_cached_sm90_kernel<<<grid, hopper::kThreads, KvLayout::bytes, a.stream>>>(
      maps, a.row_of_slot, a.mask, oa, a.Nq, a.F, a.L, a.P, a.Nptr, a.Rr, a.layer, per_split,
      a.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medsam2

// q [B, Nq, C]; kcache [B, F, L, P, C]; pos_rows [Rr, L, P, C]; row_of_slot
// [F] int32; ptr_k [B, Nptr, C]; v_slots [B, F, P, Dv]; ptr_v [B, Nptr, Dv];
// mask [B, F*P + Nptr] float (> 0 attends); out [B, Nq, Dv]. All contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16) except row_of_slot
// and mask; C = 256 and Dv = 64. bfloat16 only: with splits > 1 the blocks
// write o_part [splits, B, Nq, Dv] and lse_part [splits, B, Nq] (float32)
// for medsam2_attention_merge. Returns the cudaError_t of the launch.
extern "C" int medsam2_kv_cached_attention_fwd(const void* q, const void* kcache,
                                               const void* pos_rows, const int* row_of_slot,
                                               const void* ptr_k, const void* v_slots,
                                               const void* ptr_v, const float* mask, void* out,
                                               float* o_part, float* lse_part, int B, int Nq,
                                               int F, int L, int P, int C, int Dv, int Nptr,
                                               int Rr, int layer, float scale, int splits,
                                               int dtype, void* stream) {
  using namespace medsam2;
  if (B <= 0 || Nq <= 0 || F < 0 || P < 0 || Nptr < 0 || Rr <= 0 || layer < 0 || layer >= L ||
      C != kKvC || Dv != kKvDv || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (dtype != 1 || o_part == nullptr || lse_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const KvArgs a{q,     kcache, pos_rows, row_of_slot, ptr_k, v_slots, ptr_v,  mask,
                 out,   o_part, lse_part, B,           Nq,    F,       L,      P,
                 Nptr,  Rr,     layer,    splits,      scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)launch_sm90(a);
  if (dtype == 0) return (int)launch_f32(a);
  return (int)cudaErrorInvalidValue;
}
