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
// One block per (window, head, chunk of query rows): it gathers the window's
// n = ws^2 keys and values of its head (zero rows pad n to a multiple of 16)
// and its query chunk from the strided [.., 3C] layout into shared memory,
// runs S = Q K^T, the softmax and P V there, and scatters its rows back to
// the [B, Hp, Wp, C] layout. Nothing is partitioned in device memory, and no
// logit leaves the block.
//
// What bounds it on the H100: at the main path's shapes (hiera_t @1024,
// [1, 70, 70, 1152] with ws 14 and [1, 35, 35, 2304] with ws 7, d 96) the
// work is 4 n d flops per query row against 8 d bytes of q, k, v and out in
// bf16, ~n / 2 flops per byte (98 at n = 196), below the ~295 ridge: device
// memory bounds it. Each block reads its window's keys and values once per
// query chunk (up to 4 times at n = 196), which L2 absorbs.
//
// Grid: (windows, heads, ceil(n / QB)); 128 threads; QB = 64 query rows in
// bf16, 32 in fp32 (shared memory). Instantiated for d = 96 and n <= 196.

#include "encoder_tile.cuh"

namespace medsam2 {
namespace {

constexpr int kWinThreads = 128;
constexpr int kWinD = 96;
constexpr int kWinMaxTokens = 196;  // ws 14
constexpr int kWinMaxPad = 208;     // 196 rounded up to 16

template <typename T>
struct WinSmem {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int QB = kBf16 ? 64 : 32;
  static constexpr int LDD = enc::ld<T>(kWinD);
  static constexpr int LDS = kWinMaxPad + 4;
  static constexpr int LDP = kBf16 ? enc::ld<T>(kWinMaxPad) : LDS;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(T) * QB * LDD);
  static constexpr size_t v_off = k_off + align128(sizeof(T) * kWinMaxPad * LDD);
  static constexpr size_t s_off = v_off + align128(sizeof(T) * kWinMaxPad * LDD);
  static constexpr size_t p_off = s_off + align128(sizeof(float) * QB * LDS);
  static constexpr size_t scratch_off = p_off + (kBf16 ? align128(sizeof(T) * QB * LDP) : 0);
  static constexpr size_t bytes =
      scratch_off + (kBf16 ? sizeof(float) * 256 * (kWinThreads / 32) : 0);
  static_assert(bytes <= 232448, "tile does not fit the 227 KB a block may use");
};

// Offset (elements) of token t of window (b, wy, wx) in a [B, Hp, Wp, ch] map.
__device__ __forceinline__ size_t token_offset(int b, int wy, int wx, int t, int ws, int Hp,
                                               int Wp, int ch) {
  const int y = wy * ws + t / ws;
  const int x = wx * ws + t % ws;
  return (((size_t)b * Hp + y) * Wp + x) * ch;
}

// rows [t0, t0 + rows) of the window's tokens, channels [c0, c0 + 96), into
// dst with row stride LDD; tokens at or past n are zero.
template <typename T>
__device__ __forceinline__ void gather_tokens(T* dst, const T* qkv, int b, int wy, int wx, int t0,
                                              int rows, int n, int c0, int ws, int Hp, int Wp,
                                              int C3) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CV = kWinD / VEC;
  for (int i = threadIdx.x; i < rows * CV; i += kWinThreads) {
    const int r = i / CV;
    const int c = (i % CV) * VEC;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < n)
      val = *reinterpret_cast<const uint4*>(qkv + token_offset(b, wy, wx, t, ws, Hp, Wp, C3) +
                                            c0 + c);
    *reinterpret_cast<uint4*>(dst + r * WinSmem<T>::LDD + c) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads)
    window_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int Hp, int Wp, int C,
                            int ws, float scale) {
  using L = WinSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* s = reinterpret_cast<float*>(smem + L::s_off);
  T* pr = L::kBf16 ? reinterpret_cast<T*>(smem + L::p_off) : reinterpret_cast<T*>(s);
  float* scratch = reinterpret_cast<float*>(smem + L::scratch_off);

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

  gather_tokens(qs, qkv, b, wy, wx, q0, L::QB, n, h * kWinD, ws, Hp, Wp, C3);
  gather_tokens(ks, qkv, b, wy, wx, 0, np, n, C + h * kWinD, ws, Hp, Wp, C3);
  gather_tokens(vs, qkv, b, wy, wx, 0, np, n, 2 * C + h * kWinD, ws, Hp, Wp, C3);
  __syncthreads();
  enc::gemm_rows<T, L::QB, kWinThreads, false>(qs, L::LDD, ks, L::LDD, kWinD, np, scratch,
                                               [&](int r, int c, float v) { s[r * L::LDS + c] = v; });
  __syncthreads();
  enc::softmax_rows<T, kWinThreads>(s, L::LDS, pr, L::LDP, L::QB, n, np, scale,
                                    [](int, int) { return true; });
  __syncthreads();
  enc::gemm_rows<T, L::QB, kWinThreads, true>(
      pr, L::LDP, vs, L::LDD, np, kWinD, scratch, [&](int r, int c, float v) {
        const int t = q0 + r;
        if (t < n) out[token_offset(b, wy, wx, t, ws, Hp, Wp, C) + h * kWinD + c] = from_float<T>(v);
      });
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int B, int Hp, int Wp, int C, int heads, int ws,
                   float scale, cudaStream_t stream) {
  using L = WinSmem<T>;
  auto kern = window_attention_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int n = ws * ws;
  const dim3 grid(B * (Hp / ws) * (Wp / ws), heads, (n + L::QB - 1) / L::QB);
  kern<<<grid, kWinThreads, L::bytes, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                                Hp, Wp, C, ws, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medsam2

// qkv [B, Hp, Wp, 3C] -> out [B, Hp, Wp, C], Hp and Wp multiples of ws,
// C = heads * 96, ws * ws <= 196. Contiguous, 16-byte aligned, one dtype
// (0 = float32, 1 = bfloat16). Returns the cudaError_t of the launch.
extern "C" int medsam2_window_attention_fwd(const void* qkv, void* out, int B, int Hp, int Wp,
                                            int C, int heads, int ws, float scale, int dtype,
                                            void* stream) {
  using namespace medsam2;
  if (B <= 0 || ws <= 0 || ws * ws > kWinMaxTokens || Hp % ws || Wp % ws || Hp <= 0 || Wp <= 0 ||
      heads <= 0 || C != heads * kWinD)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<bf16>(qkv, out, B, Hp, Wp, C, heads, ws, scale, s);
  if (dtype == 0) return (int)launch<float>(qkv, out, B, Hp, Wp, C, heads, ws, scale, s);
  return (int)cudaErrorInvalidValue;
}
