// The Hiera encoder's row-wise products, for the fused LN-MLP
// (fused_mlp.cu) and the fused window block (fused_block.cu). See
// encoder_gemm.cu for the design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace medsam2 {
namespace enc {

// What a linear writes, with T the working type and acc the fp32 product:
//   kEpiBias      out = T(T(acc) + b)                 (qkv)
//   kEpiBiasGelu  out = T(gelu(T(T(acc) + b)))        (fc1: erf in fp32, tanh in bf16)
//   kEpiResidual  out = T(T(x + T(acc)) + b)          (proj, fc2: the Pallas (x + y) + b)
enum Epilogue : int { kEpiBias = 0, kEpiBiasGelu = 1, kEpiResidual = 2 };

// out[N, C] = T(LN(x) * g + b): fp32 statistics, biased variance,
// rsqrt(var + eps). C a multiple of 8.
template <typename T>
cudaError_t layer_norm(const T* x, const T* g, const T* b, T* out, int N, int C, float eps,
                       cudaStream_t stream);

// out[M, N] = epilogue(a[M, K] @ w[N, K]^T) (w a torch Linear weight), with
// bias [N] and, for kEpiResidual, x = resid [M, N]. N and K multiples of 8,
// pointers 16-byte aligned; any other shape returns cudaErrorInvalidValue.
// bf16: the persistent wgmma + TMA kernel (encoder_linear_sm90.cuh) at
// column tiles of tile_n(M, N, K, SMs); fp32: FMA (no TF32).
template <typename T>
cudaError_t linear(const T* a, const T* w, const T* bias, const T* resid, T* out, int M, int N,
                   int K, int epi, cudaStream_t stream);

// The bf16 linear's column-tile width on `sms` SMs: among the multiples of
// 16 up to 192 that divide N (all of them where none does), the one with
// the fewest rounds x (max(BN, 64) + 32), rounds = ceil(ceil(M / 128)
// ceil(N / BN) / sms), the wider on a tie. ops/encoder_linear.tile_n
// restates it.
int tile_n(int M, int N, int K, int sms);

// The launches mlp_residual makes at (C, H): 1 in bf16 at C in {96, 112,
// 144, 192, 224} with H = 4C (the fused kernel), else 3.
int mlp_launches(int C, int H, bool is_bf16);

// x + mlp(LN(x)) as the Pallas fused_mlp kernel rounds it:
// out = T(T(x + T(fc2(h))) + b2), h = T(gelu(T(T(fc1(T(LN(x)))) + b1))).
// One launch of the fused kernel where mlp_launches says 1 (normed and
// hidden unused, may be null). Otherwise three launches: layer_norm into
// `normed` [N, C], fc1 into `hidden` [N, H], fc2 with the residual into out.
template <typename T>
cudaError_t mlp_residual(const T* x, const T* g, const T* b, const T* w1, const T* b1,
                         const T* w2, const T* b2, T* normed, T* hidden, T* out, int N, int C,
                         int H, float eps, cudaStream_t stream);

}  // namespace enc
}  // namespace medsam2
