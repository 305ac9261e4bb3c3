// bf16 per-window attention for Hopper (sm_90a): TMA loads, wgmma products,
// the softmax in registers.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernels
// medsam2_tpu/ops/window_attention.py:_window_attn_kernel (B5) and
// _window_attn_kernel_3d (B6, the same function over a free reshape, which
// window_attention.cu serves with this kernel unchanged); window_attention.cu
// keeps the fp32 launch and the dispatch. qkv [B, Hp, Wp, 3C] (channels
// [3, heads, d]) -> out [B, Hp, Wp, C]: every ws x ws window attends within
// itself; fp32 logits and softmax, probabilities normalised and rounded to
// bf16 before the P V product, fp32 accumulation, as the Pallas kernel.
//
// What bounds it on the H100: ~n / 2 flops per byte (98 at n = ws^2 = 196),
// below the ~295 ridge, so device memory. The design reads each window's q,
// k and v once and writes only the output:
// - One CTA per (window, head, query part). qkv is a 4-D tensor
//   [B*Hp, Wp, 3 heads, d] to TMA; a box of (channel chunk, one head, ws
//   columns, rows) brings the window's head slice into shared memory in
//   token order t = y ws + x, as the [rows][64] (128-byte swizzle) and
//   [rows][32] or [rows][16] chunks of the head dim padded to 16 that B1's
//   design reads (96 = 64 + 32, 72 = 64 + 16, 56 -> one chunk of 64).
//   Channels past d lie past the map's innermost dim, so TMA zero-fills
//   them (56-63 at d 56, 72-79 at d 72): q . k sums only the head's own
//   channels. One thread issues the boxes of q, k and v on one mbarrier;
//   K and V are loaded once.
// - Keys are padded to NK = n rounded up to 16 (208 at ws 14). The rows
//   [n, NK) of K and V are zeroed in shared memory once (stale bits could be
//   NaN, and 0 x NaN poisons P V), and logits of columns >= n are set to
//   -1e30 in registers before the row max.
// - Each consumer warpgroup owns 64 query rows: S = Q K^T by wgmma in
//   64-key groups (the last 16, 32 or 48 wide) with both operands in shared
//   memory and S in registers; the exact softmax (max, exp2, sum, 1/sum) in
//   registers over the quad that holds a row; P rounded to bf16 straight into
//   wgmma A fragments; O = P V by wgmma with V MN-major; O written from
//   registers to [B, Hp, Wp, C], rows t < n only.
// - Grid: window_query_parts: ceil(n / 128) parts of whole window rows per
//   (window, head), at most 128 query rows (two consumer warpgroups) a CTA.
//   At ws 14 that is 2 x 98 rows and 200 CTAs of 103 KB, two CTAs an SM: one
//   wave on 132 SMs; at ws 7 one 64-row warpgroup a CTA, 200 CTAs. ws 16
//   (hiera_l's stage 3, inside the fused block) holds 4 x 64 logits a row
//   and runs one CTA an SM, so that its registers do not spill.
// Instantiated for head dim 96 at every ws from 1 to 14 (hiera_t / s), 56
// at ws 4, 7, 8, 14 (hiera_b+) and 72 at ws 4, 8, 16 (hiera_l).

#include "hopper_attention.cuh"
#include "window_attention_sm90.cuh"

namespace medsam2 {
namespace hopper {
namespace {

template <int WS, int D>
struct WinCfg {
  using CW = Cols<D>;  // chunks of 64, then 32 or 16 columns
  static constexpr int kN = WS * WS;
  static constexpr int kNK = (kN + 15) / 16 * 16;            // keys padded to the wgmma depth
  static constexpr int kSteps = kNK / 16;                     // 16-key steps of P V
  static constexpr int kGroups = (kSteps + 3) / 4;            // 64-key groups of S
  static constexpr int kTail = kSteps - 4 * (kGroups - 1);    // 16-key steps in the last group
  static constexpr int kParts = (kN + 127) / 128;             // CTAs per (window, head)
  static constexpr int kHY = (WS + kParts - 1) / kParts;      // window rows per part
  static constexpr int kQRows = kHY * WS;                     // query rows per part
  static constexpr int kNC = (kQRows + 63) / 64;              // consumer warpgroups
  static constexpr int kThreads = 128 * kNC;
  static constexpr int kQTile = 64 * kNC;                     // rows of the Q tile
  static constexpr int kQBytes = kQTile * CW::kPad * 2;
  static constexpr int kKVBytes = kNK * CW::kPad * 2;
  static constexpr int q_off = 0;
  static constexpr int k_off = round1024(kQBytes);
  static constexpr int v_off = k_off + round1024(kKVBytes);
  static constexpr int bar_off = v_off + round1024(kKVBytes);
  static constexpr int bytes = bar_off + 64 + 1024;          // + base alignment
  // boxes count in full, zero-filled columns included
  static constexpr uint32_t kTxBytes = (kHY + 2 * WS) * WS * CW::kPad * 2;
  static constexpr int kMinBlocks = WS <= 14 ? 2 : 1;
  static_assert(kNC <= 2 && kGroups <= 4, "window larger than 256 tokens");
  // CTAs an SM: kMinBlocks x (bytes + the 1 KB the runtime reserves) <= 228 KB
  static_assert(kMinBlocks * (bytes + 1024) <= 233472, "the CTAs do not fit one SM");
};

struct WinMaps {
  CUtensorMap q64, q_rem, kv64, kv_rem;
};

// Zero rows [r0, r1) of a chunked [rows][W] tile (rows of each chunk are
// contiguous whatever the swizzle, which permutes 16-byte units within a row).
template <class CW>
__device__ __forceinline__ void zero_rows(unsigned char* tile, int rows, int r0, int r1) {
#pragma unroll
  for (int c = 0; c < CW::kChunks; ++c) {
    const int pitch = 2 * CW::width(c);
    uint4* p = reinterpret_cast<uint4*>(tile + CW::offset(c, rows) + r0 * pitch);
    for (int i = threadIdx.x; i < (r1 - r0) * pitch / 16; i += blockDim.x)
      p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int WS, int D>
__global__ void __launch_bounds__(WinCfg<WS, D>::kThreads, WinCfg<WS, D>::kMinBlocks)
    window_sm90_kernel(const __grid_constant__ WinMaps maps, bf16* __restrict__ out, int Hp,
                       int Wp, int C, int heads, float scale_log2) {
  using G = WinCfg<WS, D>;
  using CW = typename G::CW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base + G::q_off;
  unsigned char* ks = base + G::k_off;
  unsigned char* vs = base + G::v_off;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + G::bar_off);

  const int nwx = Wp / WS;
  const int nwy = Hp / WS;
  const int b = blockIdx.x / (nwy * nwx);
  const int wy = (blockIdx.x / nwx) % nwy;
  const int wx = blockIdx.x % nwx;
  const int h = blockIdx.y;
  const int part = blockIdx.z;
  const int x0 = wx * WS;
  const int y0 = b * Hp + wy * WS;  // row of [B*Hp, Wp, .]

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, G::kTxBytes);
#pragma unroll
    for (int c = 0; c < CW::kChunks; ++c) {
      tma_load_4d(qs + CW::offset(c, G::kQTile), c ? &maps.q_rem : &maps.q64, bar, 64 * c, h,
                  x0, y0 + part * G::kHY);
      tma_load_4d(ks + CW::offset(c, G::kNK), c ? &maps.kv_rem : &maps.kv64, bar, 64 * c,
                  heads + h, x0, y0);
      tma_load_4d(vs + CW::offset(c, G::kNK), c ? &maps.kv_rem : &maps.kv64, bar, 64 * c,
                  2 * heads + h, x0, y0);
    }
  }
  // key and value rows past the window: zero, seen by the async proxy
  zero_rows<CW>(ks, G::kNK, G::kN, G::kNK);
  zero_rows<CW>(vs, G::kNK, G::kN, G::kNK);
  fence_proxy_async();
  __syncthreads();
  mbar_wait(bar, 0);

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r_a = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: r_a, r_a + 8

  // ---- S = Q K^T, 64-key groups; sc[g][4j + e]: rows r_a (e < 2) / r_a + 8,
  // columns 64 g + 8 j + 2 quad + (e & 1) ----
  float sc[G::kGroups][32];
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t k_addr = smem_u32(ks);
  wg_fence();
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) {
    const int steps = g < G::kGroups - 1 ? 4 : G::kTail;
#pragma unroll
    for (int c = 0; c < CW::kChunks; ++c) {
      const int w = CW::width(c);
      const uint32_t pitch = 2 * w;
      const uint32_t qa = q_addr + CW::offset(c, G::kQTile) + wg * 64 * pitch;
      const uint32_t ka = k_addr + CW::offset(c, G::kNK) + g * 64 * pitch;
#pragma unroll
      for (int i = 0; i < w / 16; ++i) {
        const uint64_t da = make_desc(qa + 32 * i, w, 16, 8 * pitch);
        const uint64_t db = make_desc(ka + 32 * i, w, 16, 8 * pitch);
        const int acc = (c | i) ? 1 : 0;
        if (steps == 4)
          wgmma_ss_n64(sc[g], da, db, acc);
        else if (steps == 3)
          wgmma_ss_n48(sc[g], da, db, acc);
        else if (steps == 2)
          wgmma_ss_n32(sc[g], da, db, acc);
        else
          wgmma_ss_n16(sc[g], da, db, acc);
      }
    }
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int g = 0; g < G::kGroups - 1; ++g) fence_regs<32>(sc[g]);
  fence_regs<8 * G::kTail>(sc[G::kGroups - 1]);  // the last group's registers only

  // ---- exact softmax in registers: columns >= n masked before the max ----
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) {
    const int steps = g < G::kGroups - 1 ? 4 : G::kTail;
#pragma unroll
    for (int j = 0; j < 2 * steps; ++j) {
      const int col = 64 * g + 8 * j + 2 * quad;
      if (col >= G::kN) sc[g][4 * j] = sc[g][4 * j + 2] = kNegInf;
      if (col + 1 >= G::kN) sc[g][4 * j + 1] = sc[g][4 * j + 3] = kNegInf;
      mx_a = fmaxf(mx_a, fmaxf(sc[g][4 * j], sc[g][4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[g][4 * j + 2], sc[g][4 * j + 3]));
    }
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) {
    const int steps = g < G::kGroups - 1 ? 4 : G::kTail;
#pragma unroll
    for (int j = 0; j < 2 * steps; ++j) {
      sc[g][4 * j] = exp2f((sc[g][4 * j] - mx_a) * scale_log2);
      sc[g][4 * j + 1] = exp2f((sc[g][4 * j + 1] - mx_a) * scale_log2);
      sc[g][4 * j + 2] = exp2f((sc[g][4 * j + 2] - mx_b) * scale_log2);
      sc[g][4 * j + 3] = exp2f((sc[g][4 * j + 3] - mx_b) * scale_log2);
      sum_a += sc[g][4 * j] + sc[g][4 * j + 1];
      sum_b += sc[g][4 * j + 2] + sc[g][4 * j + 3];
    }
  }
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
  const float inv_a = 1.f / sum_a, inv_b = 1.f / sum_b;
  // normalised P in bf16: the A fragment of 16-key step kk (e even: row r_a)
  uint32_t p[G::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    const float* s = sc[kk / 4] + 8 * (kk % 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float inv = (e & 1) ? inv_b : inv_a;
      p[kk][e] = pack_bf16(s[2 * e] * inv, s[2 * e + 1] * inv);
    }
  }

  // ---- O = P V, V MN-major; o + 32 c holds chunk c's columns ----
  constexpr int kO = CW::kPad / 2;
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  const uint32_t v_addr = smem_u32(vs);
  fence_regs<kO>(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
#pragma unroll
    for (int c = 0; c < CW::kChunks; ++c) {
      const int w = CW::width(c);
      const uint32_t pitch = 2 * w;
      const uint64_t desc =
          make_desc(v_addr + CW::offset(c, G::kNK) + kk * 16 * pitch, w, 16, 8 * pitch);
      if (w == 64)
        wgmma_rs_n64(o + 32 * c, p[kk], desc);
      else if (w == 32)
        wgmma_rs_n32(o + 32 * c, p[kk], desc);
      else
        wgmma_rs_n16(o + 32 * c, p[kk], desc);
    }
  }
  wg_commit();
  wg_wait_all();
  fence_regs<kO>(o);

  // ---- rows t < n of this part to [B*Hp, Wp, C] ----
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_a + 8 * hh;
    const int tok = part * G::kQRows + r;
    if (r >= G::kQRows || tok >= G::kN) continue;
    const int y = tok / WS;
    const int x = tok % WS;
    bf16* dst = out + ((size_t)(y0 + y) * Wp + x0 + x) * C + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * quad) =
          pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
  }
}

template <int WS, int D>
cudaError_t launch_ws(const WinCall& a) {
  using G = WinCfg<WS, D>;
  using CW = typename G::CW;
  WinMaps maps;
  // [B*Hp][Wp][3 heads][D]: the innermost dim is one head's channels
  const uint64_t dims[4] = {D, 3 * (uint64_t)a.heads, (uint64_t)a.Wp, (uint64_t)a.B * a.Hp};
  const uint64_t strides[3] = {2 * (uint64_t)D, 6 * (uint64_t)a.C, 6 * (uint64_t)a.C * a.Wp};
  const uint32_t rem = CW::kRem ? CW::kRem : 64;
  if (!make_map4(&maps.q64, a.qkv, dims, strides, {64, 1, WS, G::kHY}) ||
      !make_map4(&maps.q_rem, a.qkv, dims, strides, {rem, 1, WS, G::kHY}) ||
      !make_map4(&maps.kv64, a.qkv, dims, strides, {64, 1, WS, WS}) ||
      !make_map4(&maps.kv_rem, a.qkv, dims, strides, {rem, 1, WS, WS}))
    return cudaErrorInvalidValue;
  auto kern = window_sm90_kernel<WS, D>;
  static unsigned long long smem_set = 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), G::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * (a.Hp / WS) * (a.Wp / WS), a.heads, G::kParts);
  kern<<<grid, G::kThreads, G::bytes, a.stream>>>(maps, static_cast<bf16*>(a.out), a.Hp, a.Wp,
                                                  a.C, a.heads, a.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

cudaError_t window_sm90(const WinCall& a) {
  if (a.C != a.heads * a.d) return cudaErrorInvalidValue;
  if (a.d == 96) {
    switch (a.ws) {
      case 1: return launch_ws<1, 96>(a);
      case 2: return launch_ws<2, 96>(a);
      case 3: return launch_ws<3, 96>(a);
      case 4: return launch_ws<4, 96>(a);
      case 5: return launch_ws<5, 96>(a);
      case 6: return launch_ws<6, 96>(a);
      case 7: return launch_ws<7, 96>(a);
      case 8: return launch_ws<8, 96>(a);
      case 9: return launch_ws<9, 96>(a);
      case 10: return launch_ws<10, 96>(a);
      case 11: return launch_ws<11, 96>(a);
      case 12: return launch_ws<12, 96>(a);
      case 13: return launch_ws<13, 96>(a);
      case 14: return launch_ws<14, 96>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.d == 56) {
    switch (a.ws) {
      case 4: return launch_ws<4, 56>(a);
      case 7: return launch_ws<7, 56>(a);
      case 8: return launch_ws<8, 56>(a);
      case 14: return launch_ws<14, 56>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.d == 72) {
    switch (a.ws) {
      case 4: return launch_ws<4, 72>(a);
      case 8: return launch_ws<8, 72>(a);
      case 16: return launch_ws<16, 72>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace medsam2
