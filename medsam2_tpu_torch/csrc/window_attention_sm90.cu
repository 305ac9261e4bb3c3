// bf16 per-window attention for Hopper (sm_90a): TMA loads, wgmma products,
// the softmax in registers.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernels
// medsam2_tpu/ops/window_attention.py:_window_attn_kernel (B5) and
// _window_attn_kernel_3d (B6, the same function over a free reshape, which
// window_attention.cu serves with this kernel unchanged); window_attention.cu
// keeps the fp32 launch and the dispatch. qkv [B, Hp, Wp, 3C] (channels
// [3, heads, 96]) -> out [B, Hp, Wp, C]: every ws x ws window attends within
// itself; fp32 logits and softmax, probabilities normalised and rounded to
// bf16 before the P V product, fp32 accumulation, as the Pallas kernel.
//
// What bounds it on the H100: ~n / 2 flops per byte (98 at n = ws^2 = 196),
// below the ~295 ridge, so device memory. The design reads each window's q,
// k and v once and writes only the output:
// - One CTA per (window, head, query part). qkv is a 3-D tensor
//   [B*Hp, Wp, 3C] to TMA; a box of (channel chunk, ws columns, rows) brings
//   the window's head slice into shared memory in token order t = y ws + x,
//   as the [rows][64] (128-byte swizzle) and [rows][32] (64-byte swizzle)
//   chunks of a 96-wide head that B1's design reads. One thread issues the
//   six boxes of q, k and v on one mbarrier; K and V are loaded once.
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
//   wave on 132 SMs; at ws 7 one 64-row warpgroup a CTA, 200 CTAs.
// Instantiated for head dim 96 and every ws from 1 to 14 (n <= 196).

#include "hopper_attention.cuh"
#include "window_attention_sm90.cuh"

namespace medsam2 {
namespace hopper {
namespace {

constexpr int kWinD = 96;
using CW = Cols<kWinD>;  // chunks of 64 and 32 columns

template <int WS>
struct WinCfg {
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
  static constexpr uint32_t kTxBytes = (kHY + 2 * WS) * WS * kWinD * 2;
  static_assert(kNC <= 2 && kGroups <= 4, "window larger than 196 tokens");
  // two CTAs an SM: 2 x (bytes + the 1 KB the runtime reserves) <= 228 KB
  static_assert(2 * (bytes + 1024) <= 233472, "two CTAs do not fit one SM");
};

struct WinMaps {
  CUtensorMap q64, q32, kv64, kv32;
};

// Zero rows [r0, r1) of a chunked [rows][96] tile (rows of each chunk are
// contiguous whatever the swizzle, which permutes 16-byte units within a row).
__device__ __forceinline__ void zero_rows(unsigned char* tile, int rows, int r0, int r1) {
#pragma unroll
  for (int c = 0; c < CW::kChunks; ++c) {
    const int pitch = 2 * CW::width(c);
    uint4* p = reinterpret_cast<uint4*>(tile + CW::offset(c, rows) + r0 * pitch);
    for (int i = threadIdx.x; i < (r1 - r0) * pitch / 16; i += blockDim.x)
      p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int WS>
__global__ void __launch_bounds__(WinCfg<WS>::kThreads, 2)
    window_sm90_kernel(const __grid_constant__ WinMaps maps, bf16* __restrict__ out, int Hp,
                       int Wp, int C, float scale_log2) {
  using G = WinCfg<WS>;
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
      const int col = h * kWinD + 64 * c;
      tma_load_3d(qs + CW::offset(c, G::kQTile), c ? &maps.q32 : &maps.q64, bar, col, x0,
                  y0 + part * G::kHY);
      tma_load_3d(ks + CW::offset(c, G::kNK), c ? &maps.kv32 : &maps.kv64, bar, C + col, x0, y0);
      tma_load_3d(vs + CW::offset(c, G::kNK), c ? &maps.kv32 : &maps.kv64, bar, 2 * C + col, x0,
                  y0);
    }
  }
  // key and value rows past the window: zero, seen by the async proxy
  zero_rows(ks, G::kNK, G::kN, G::kNK);
  zero_rows(vs, G::kNK, G::kN, G::kNK);
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
      else
        wgmma_rs_n32(o + 32 * c, p[kk], desc);
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
    bf16* dst = out + ((size_t)(y0 + y) * Wp + x0 + x) * C + h * kWinD;
#pragma unroll
    for (int j = 0; j < kWinD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * quad) =
          pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
  }
}

template <int WS>
cudaError_t launch_ws(const WinCall& a) {
  using G = WinCfg<WS>;
  WinMaps maps;
  const uint64_t d0 = 3 * (uint64_t)a.C, d1 = a.Wp, d2 = (uint64_t)a.B * a.Hp;
  if (!make_map(&maps.q64, a.qkv, d0, d1, d2, 64, WS, G::kHY) ||
      !make_map(&maps.q32, a.qkv, d0, d1, d2, 32, WS, G::kHY) ||
      !make_map(&maps.kv64, a.qkv, d0, d1, d2, 64, WS, WS) ||
      !make_map(&maps.kv32, a.qkv, d0, d1, d2, 32, WS, WS))
    return cudaErrorInvalidValue;
  auto kern = window_sm90_kernel<WS>;
  static unsigned long long smem_set = 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), G::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * (a.Hp / WS) * (a.Wp / WS), a.heads, G::kParts);
  kern<<<grid, G::kThreads, G::bytes, a.stream>>>(maps, static_cast<bf16*>(a.out), a.Hp, a.Wp,
                                                  a.C, a.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

cudaError_t window_sm90(const WinCall& a) {
  switch (a.ws) {
    case 1: return launch_ws<1>(a);
    case 2: return launch_ws<2>(a);
    case 3: return launch_ws<3>(a);
    case 4: return launch_ws<4>(a);
    case 5: return launch_ws<5>(a);
    case 6: return launch_ws<6>(a);
    case 7: return launch_ws<7>(a);
    case 8: return launch_ws<8>(a);
    case 9: return launch_ws<9>(a);
    case 10: return launch_ws<10>(a);
    case 11: return launch_ws<11>(a);
    case 12: return launch_ws<12>(a);
    case 13: return launch_ws<13>(a);
    case 14: return launch_ws<14>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hopper
}  // namespace medsam2
