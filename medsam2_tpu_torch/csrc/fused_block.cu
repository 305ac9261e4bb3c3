// A whole plain windowed Hiera block for Hopper (sm_90a), as a short
// sequence of the port's own kernels.
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/fused_block.py:_kernel
// (reached through _pallas_fwd <- fused_window_block). Input: window-
// contiguous rows x [N, C], every n = ws^2 consecutive rows one window.
//   x1  = (x + T(sum_h attn_h(LN1(x)) @ Wp[h])) + bp
//   out = (x1 + T(fc2(gelu(fc1(LN2(x1)))))) + b2
// with qkv = T(T(LN1(x) @ Wqkv) + bqkv) split [3, heads, d], per-window
// fp32 softmax, probabilities rounded to T before P V, each head's output
// rounded to T and its slice of the output projection accumulated over heads
// in fp32: the Pallas kernel's rounding order (fused_block.py:98-132).
//
// The launches, each intermediate rounded where the Pallas kernel rounds
// it: LN1 (encoder_gemm.cu) -> the qkv linear with its bias -> the window
// attention kernel on the rows as [windows, ws, ws, 3C]
// (window_attention_sm90.cu in bf16: each head's output rounded, as the
// Pallas kernel's oh) -> the proj linear with the (x + T(acc)) + bp
// epilogue (its fp32 sum over all C input channels is the Pallas sum over
// heads of each head's slice) -> the fused MLP (one launch where
// enc::mlp_launches says so, else three). Every preset's width runs this
// way: hiera_t / hiera_s (C 96 / 192, head dim 96), hiera_b+ (C 112 / 224,
// head dim 56) and hiera_l (C 144 / 288 / 576 / 1152, head dim 72, windows
// of 16, 64 or 256 rows). One kernel for the whole block would hold a [rows x C] fp32
// accumulator on chip, which a 256-row window at C 576, or 64 rows at C
// 1152, does not fit.
//
// What bounds it on the H100: per row 2C(3C + C + 8C) + 4nC flops against
// 4C bytes of x and out in bf16, above the ~295 flop/byte ridge at every
// preset width: tensor-core issue rate. The sequence also moves its ~10
// x-sized intermediates through device memory (mostly the 50 MB L2).

#include <cmath>

#include "attention_tile.cuh"
#include "encoder_gemm.cuh"
#include "window_attention_sm90.cuh"

namespace medsam2 {
namespace {

// The block as a sequence of launches; work holds [N, C] LN rows, [N, 3C]
// qkv, [N, C] head outputs, [N, C] x1 and, where the MLP takes three
// launches, [N, 4C] hidden rows.
template <typename T>
cudaError_t composite(const void* x_, const void* const* prm, void* out, void* work, int N,
                      int C, int heads, int ws, float eps, cudaStream_t s) {
  auto t = [&](int i) { return static_cast<const T*>(prm[i]); };
  const T* x = static_cast<const T*>(x_);
  T* normed = static_cast<T*>(work);
  T* qkv = normed + (size_t)N * C;
  T* att = qkv + (size_t)3 * N * C;
  T* x1 = att + (size_t)N * C;
  T* hidden = x1 + (size_t)N * C;
  const int d = C / heads;
  cudaError_t e = enc::layer_norm<T>(x, t(0), t(1), normed, N, C, eps, s);
  if (e == cudaSuccess)
    e = enc::linear<T>(normed, t(2), t(3), nullptr, qkv, N, 3 * C, C, enc::kEpiBias, s);
  if (e == cudaSuccess) {
    // float32(1 / sqrt(d)), as Pallas
    const hopper::WinCall call{qkv, att, N / (ws * ws), ws, ws, C, heads, ws, d,
                               (float)(1.0 / sqrt((double)d)), s};
    e = std::is_same<T, bf16>::value ? hopper::window_sm90(call) : window_attention_f32(call);
  }
  if (e == cudaSuccess)
    e = enc::linear<T>(att, t(4), t(5), x, x1, N, C, C, enc::kEpiResidual, s);
  if (e == cudaSuccess)
    e = enc::mlp_residual<T>(x1, t(6), t(7), t(8), t(9), t(10), t(11), normed, hidden,
                             static_cast<T*>(out), N, C, 4 * C, eps, s);
  return e;
}

}  // namespace
}  // namespace medsam2

// x [N, C] window-contiguous rows (n = ws * ws rows per window, N % n ==
// 0); params in order: norm1 weight, bias [C]; qkv weight [3C, C], bias
// [3C]; proj weight [C, C], bias [C]; norm2 weight, bias [C]; fc1 weight
// [4C, C], bias [4C]; fc2 weight [C, 4C], bias [C]. out [N, C]. work is
// [N, 6C] scratch, [N, 10C] where medsam2_fused_mlp_launches(C, 4C, dtype)
// is 3; (C / heads, ws) is a pair the window kernel is built for. All
// contiguous, 32-byte aligned, one dtype (0 = float32, 1 = bfloat16).
// Returns the cudaError_t of the first launch that fails.
extern "C" int medsam2_fused_block_fwd(const void* x, const void* g1, const void* b1,
                                       const void* wqkv, const void* bqkv, const void* wp,
                                       const void* bp, const void* g2, const void* b2,
                                       const void* w1, const void* b1m, const void* w2,
                                       const void* b2m, void* out, void* work, int N, int C,
                                       int heads, int n, float eps, int dtype, void* stream) {
  using namespace medsam2;
  if (N <= 0 || n <= 0 || N % n || heads <= 0 || C % heads || C % 8 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  int ws = 1;
  while (ws * ws < n) ++ws;
  if (ws * ws != n) return (int)cudaErrorInvalidValue;
  const void* prm[12] = {g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)composite<bf16>(x, prm, out, work, N, C, heads, ws, eps, s);
  if (dtype == 0) return (int)composite<float>(x, prm, out, work, N, C, heads, ws, eps, s);
  return (int)cudaErrorInvalidValue;
}
