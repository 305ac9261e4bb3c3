// Fused LayerNorm -> MLP(fc1, GELU, fc2) -> residual for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/fused_mlp.py:_kernel
// (reached through _pallas_fwd <- ln_mlp_residual): the x + mlp(norm2(x))
// tail of a Hiera block, y = (x + T(fc2(gelu(fc1(LN(x)))))) + b2, with the
// Pallas kernel's roundings (fused_mlp.py:58-75).
//
// What bounds it on the H100: per row 2 * 2 * C * H flops (H = 4C) against
// 4C bytes of x and y in bf16, 4C flops a byte (384 at C = 96), above the
// card's ~295 flop/byte ridge: tensor-core issue rate.
//
// The kernels are encoder_gemm.cu's (see there for the design). bf16 at C
// <= 256 (96, 112, 144, 192, 224) is one wgmma + TMA kernel whose hidden
// rows never leave the SM; wider bf16 and every fp32 call are three
// launches: the LN rows, fc1 with bias and GELU into a hidden buffer, fc2
// with the residual epilogue (bf16 on wgmma + TMA, fp32 FMA with TF32 off).
// Any row count, any C that is a multiple of 8 and any hidden width H that
// is a multiple of 8: every width of hiera_t, hiera_s, hiera_b+ and hiera_l.

#include "encoder_gemm.cuh"

// The kernel launches of one call at (C, H) in `dtype` (0 = float32, 1 =
// bfloat16): 1 or 3. Only a call of three launches needs its work buffer.
extern "C" int medsam2_fused_mlp_launches(int C, int H, int dtype) {
  return medsam2::enc::mlp_launches(C, H, dtype == 1);
}

// x [N, C]; gamma, beta [C]; w1 [H, C]; b1 [H]; w2 [C, H]; b2 [C]; out
// [N, C]; work [N, C + H] scratch for the LN rows and the hidden rows where
// the call makes three launches, else unused (may be null). All
// contiguous, 16-byte aligned, one dtype (0 = float32, 1 = bfloat16).
// Returns the cudaError_t of the first launch that fails.
extern "C" int medsam2_fused_mlp_fwd(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, void* work, int N, int C, int H,
                                     float eps, int dtype, void* stream) {
  using namespace medsam2::enc;
  if (N <= 0 || C <= 0 || H <= 0 || C % 8 || H % 8) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    T* normed = static_cast<T*>(work);
    return (int)mlp_residual<T>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), normed, normed ? normed + (size_t)N * C : nullptr,
        static_cast<T*>(out), N, C, H, eps, s);
  }
  if (dtype == 0) {
    using T = float;
    T* normed = static_cast<T*>(work);
    return (int)mlp_residual<T>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), normed, normed ? normed + (size_t)N * C : nullptr,
        static_cast<T*>(out), N, C, H, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The building blocks of B7 and B8 on their own, for the tests and the
// per-launch split of scripts/profile_port_block_split.py: the LayerNorm
// rows (out [N, C]) and the linear out[M, N] = epilogue(a[M, K] @ w[N, K]^T)
// with epi 0 = bias, 1 = bias + GELU, 2 = residual (resid [M, N]; see
// encoder_gemm.cuh). All contiguous, 16-byte aligned, one dtype (0 =
// float32, 1 = bfloat16). Return the cudaError_t of the launch.
extern "C" int medsam2_encoder_layer_norm(const void* x, const void* g, const void* b, void* out,
                                          int N, int C, float eps, int dtype, void* stream) {
  using namespace medsam2::enc;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return (int)layer_norm<T>(static_cast<const T*>(x), static_cast<const T*>(g),
                              static_cast<const T*>(b), static_cast<T*>(out), N, C, eps, s);
  }
  if (dtype == 0)
    return (int)layer_norm<float>(static_cast<const float*>(x), static_cast<const float*>(g),
                                  static_cast<const float*>(b), static_cast<float*>(out), N, C,
                                  eps, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 linear's column-tile width for an [M, K] x [K, N] product on
// `sms` SMs (encoder_gemm.cuh's tile_n).
extern "C" int medsam2_linear_tile_n(int M, int N, int K, int sms) {
  return medsam2::enc::tile_n(M, N, K, sms);
}

extern "C" int medsam2_encoder_linear(const void* a, const void* w, const void* bias,
                                      const void* resid, void* out, int M, int N, int K, int epi,
                                      int dtype, void* stream) {
  using namespace medsam2::enc;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return (int)linear<T>(static_cast<const T*>(a), static_cast<const T*>(w),
                          static_cast<const T*>(bias), static_cast<const T*>(resid),
                          static_cast<T*>(out), M, N, K, epi, s);
  }
  if (dtype == 0)
    return (int)linear<float>(static_cast<const float*>(a), static_cast<const float*>(w),
                              static_cast<const float*>(bias), static_cast<const float*>(resid),
                              static_cast<float*>(out), M, N, K, epi, s);
  return (int)cudaErrorInvalidValue;
}
