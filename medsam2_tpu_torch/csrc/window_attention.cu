// Per-window attention straight from the fused qkv layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels medsam2_tpu/ops/window_attention.py:
// _window_attn_kernel (B5, reached through window_attention) and
// _window_attn_kernel_3d (B6, through window_attention_v2, the same function
// over a free [B*Hp, Wp, 3C] reshape, which this kernel serves unchanged).
// qkv [B, Hp, Wp, 3C] (channels split [3, heads, d]) -> out [B, Hp, Wp, C]:
// every ws x ws window attends within itself, fp32 logits and softmax,
// probabilities normalised and rounded to the input dtype before the PV
// product, fp32 accumulation. The TPU kernel packs 128 // ws^2 small windows
// under a block mask to fill its 128-lane matrix unit; that is a TPU trick,
// and here each window is computed on its own.
//
// bf16 runs the wgmma + TMA design of window_attention_sm90.cu. fp32 (TF32
// off, as the JAX package pins Precision.HIGHEST) runs this file's FMA
// kernel: one block per (window, head, chunk of 32 query rows) gathers the
// window's n = ws^2 keys and values of its head (zero rows pad n to a
// multiple of 16) and its query chunk from the strided [.., 3C] layout into
// shared memory, runs S = Q K^T, the softmax and P V there, and scatters its
// rows back to the [B, Hp, Wp, C] layout.
//
// What bounds it on the H100: at the main path's shapes (hiera_t @1024,
// [1, 70, 70, 1152] with ws 14 and [1, 35, 35, 2304] with ws 7, d 96) the
// work is 4 n d flops per query row against 8 d bytes of q, k, v and out,
// ~n / 2 flops per byte in bf16 (98 at n = 196): device memory in bf16; fp32
// runs without tensor cores and is bound by its FMA rate.
//
// Instantiated for d in {56, 72, 96}: n <= 196 at d 96, n <= 256 at d 56
// and 72 (hiera_l's ws 16 inside the fused block).

#include "encoder_tile.cuh"
#include "hopper_attention.cuh"
#include "window_attention_sm90.cuh"

namespace medsam2 {
namespace {

constexpr int kWinThreads = 128;

// Shared-memory layout of one fp32 block at head dim D: QB query rows, the
// window's keys and values padded to 16 rows, and the logit tile (also P
// after the softmax).
template <int D>
struct WinSmem {
  static constexpr int kMaxTokens = D == 96 ? 196 : 256;  // ws 14, ws 16
  static constexpr int kWinMaxPad = (kMaxTokens + 15) / 16 * 16;
  static constexpr int QB = 32;
  static constexpr int LDD = enc::ld(D);
  static constexpr int LDS = kWinMaxPad + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(float) * QB * LDD);
  static constexpr size_t v_off = k_off + align128(sizeof(float) * kWinMaxPad * LDD);
  static constexpr size_t s_off = v_off + align128(sizeof(float) * kWinMaxPad * LDD);
  static constexpr size_t bytes = s_off + align128(sizeof(float) * QB * LDS);
  static_assert(bytes <= 232448, "tile does not fit the 227 KB a block may use");
};

// Offset (elements) of token t of window (b, wy, wx) in a [B, Hp, Wp, ch] map.
__device__ __forceinline__ size_t token_offset(int b, int wy, int wx, int t, int ws, int Hp,
                                               int Wp, int ch) {
  const int y = wy * ws + t / ws;
  const int x = wx * ws + t % ws;
  return (((size_t)b * Hp + y) * Wp + x) * ch;
}

// rows [t0, t0 + rows) of the window's tokens, channels [c0, c0 + D), into
// dst with row stride LDD; tokens at or past n are zero.
template <int D>
__device__ __forceinline__ void gather_tokens(float* dst, const float* qkv, int b, int wy, int wx, int t0,
                                              int rows, int n, int c0, int ws, int Hp, int Wp,
                                              int C3) {
  constexpr int VEC = 4;
  constexpr int CV = D / VEC;
  for (int i = threadIdx.x; i < rows * CV; i += kWinThreads) {
    const int r = i / CV;
    const int c = (i % CV) * VEC;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < n)
      val = *reinterpret_cast<const uint4*>(qkv + token_offset(b, wy, wx, t, ws, Hp, Wp, C3) +
                                            c0 + c);
    *reinterpret_cast<uint4*>(dst + r * WinSmem<D>::LDD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWinThreads)
    window_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int Hp,
                            int Wp, int C, int ws, float scale) {
  using L = WinSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* s = reinterpret_cast<float*>(smem + L::s_off);

  const int n = ws * ws;
  const int np = (n + 15) / 16 * 16;
  const int nwx = Wp / ws;
  const int nwy = Hp / ws;
  const int b = blockIdx.x / (nwy * nwx);
  const int wy = (blockIdx.x / nwx) % nwy;
  const int wx = blockIdx.x % nwx;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * L::QB;
  const int C3 = 3 * C;

  gather_tokens<D>(qs, qkv, b, wy, wx, q0, L::QB, n, h * D, ws, Hp, Wp, C3);
  gather_tokens<D>(ks, qkv, b, wy, wx, 0, np, n, C + h * D, ws, Hp, Wp, C3);
  gather_tokens<D>(vs, qkv, b, wy, wx, 0, np, n, 2 * C + h * D, ws, Hp, Wp, C3);
  __syncthreads();
  enc::gemm_rows<L::QB, kWinThreads, false>(
      qs, L::LDD, ks, L::LDD, D, np,
      [&](int r, int c, float v) { s[r * L::LDS + c] = v; });
  __syncthreads();
  enc::softmax_rows<float, kWinThreads>(s, L::LDS, s, L::LDS, L::QB, n, np, scale,
                                        [](int, int) { return true; });
  __syncthreads();
  enc::gemm_rows<L::QB, kWinThreads, true>(
      s, L::LDS, vs, L::LDD, np, D, [&](int r, int c, float v) {
        const int t = q0 + r;
        if (t < n) out[token_offset(b, wy, wx, t, ws, Hp, Wp, C) + h * D + c] = v;
      });
}

template <int D>
cudaError_t launch_f32(const hopper::WinCall& a) {
  using L = WinSmem<D>;
  const int n = a.ws * a.ws;
  if (n > L::kMaxTokens) return cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  auto kern = window_attention_kernel<D>;
  const cudaError_t e =
      hopper::allow_smem(reinterpret_cast<const void*>(kern), (int)L::bytes, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * (a.Hp / a.ws) * (a.Wp / a.ws), a.heads, (n + L::QB - 1) / L::QB);
  kern<<<grid, kWinThreads, L::bytes, a.stream>>>(static_cast<const float*>(a.qkv),
                                                  static_cast<float*>(a.out), a.Hp, a.Wp, a.C,
                                                  a.ws, a.scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t window_attention_f32(const hopper::WinCall& a) {
  if (a.C != a.heads * a.d) return cudaErrorInvalidValue;
  switch (a.d) {
    case 56: return launch_f32<56>(a);
    case 72: return launch_f32<72>(a);
    case 96: return launch_f32<96>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace medsam2

// qkv [B, Hp, Wp, 3C] -> out [B, Hp, Wp, C], Hp and Wp multiples of ws,
// C = heads * d with (d, ws) built (window_attention_sm90.cuh). Contiguous,
// 16-byte aligned, one dtype (0 = float32, 1 = bfloat16). Returns the
// cudaError_t of the launch.
extern "C" int medsam2_window_attention_fwd(const void* qkv, void* out, int B, int Hp, int Wp,
                                            int C, int heads, int ws, float scale, int dtype,
                                            void* stream) {
  using namespace medsam2;
  if (B <= 0 || ws <= 0 || Hp % ws || Wp % ws || Hp <= 0 || Wp <= 0 || heads <= 0 ||
      C % heads)
    return (int)cudaErrorInvalidValue;
  const hopper::WinCall call{qkv, out, B,  Hp, Wp, C, heads, ws, C / heads, scale,
                             static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)hopper::window_sm90(call);
  if (dtype == 0) return (int)window_attention_f32(call);
  return (int)cudaErrorInvalidValue;
}
