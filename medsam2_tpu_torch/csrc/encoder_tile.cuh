// Row-tile building blocks of the fp32 window attention (window_attention.cu);
// encoder_gemm.cu shares the rounding and GELU helpers.
//
// A thread block holds a tile of rows (tokens) in shared memory and runs
// every product of its rows itself:
//   - gemm_rows: out = A B over the tile's rows, with B read from keys /
//     values in shared memory, plain fp32 FMA (no TF32, as the JAX package
//     pins Precision.HIGHEST). Every output is handed once, by one thread,
//     to an epilogue;
//   - softmax_rows: fp32 softmax of a logit tile (masked logits -1e30),
//     probabilities normalised and then rounded to the working type.
#pragma once

#include "attention_tile.cuh"

namespace medsam2 {
namespace enc {

// Leading dimension (floats) of a shared-memory row of `cols` fp32 values,
// padded by 16 bytes against bank conflicts.
__host__ __device__ constexpr int ld(int cols) { return cols + 4; }

template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_float(from_float<T>(x));
}

// layers.gelu: exact erf GELU in float32, the tanh approximation in bfloat16
// (evaluated in fp32; the caller rounds the result).
template <typename T>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  } else {
    const float k = 0.79788456080286536f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
}

// out(r, c) = sum_k A[r * lda + k] * B(k, c) for r < BM, c < N, in fp32 FMA,
//   B(k, c) = W[c * ldw + k]  (kRowMajorB false: keys [key, d])
//   B(k, c) = W[k * ldw + c]  (kRowMajorB true: values [key, d]).
// BM is a multiple of 16. Each output goes once to epi(r, c, value) from one
// thread; each thread takes one output column of 16 rows at a time.
template <int BM, int NT, bool kRowMajorB, typename Epi>
__device__ __forceinline__ void gemm_rows(const float* A, int lda, const float* W, int ldw, int K,
                                          int N, Epi epi) {
  constexpr int RB = 16;
  for (int item = threadIdx.x; item < (BM / RB) * N; item += NT) {
    const int c = item % N;
    const int r0 = (item / N) * RB;
    float acc[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) acc[rr] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float bv = kRowMajorB ? W[(size_t)k * ldw + c] : W[(size_t)c * ldw + k];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) acc[rr] = fmaf(A[(r0 + rr) * lda + k], bv, acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) epi(r0 + rr, c, acc[rr]);
  }
}

// P[r][c] = softmax_c(keep(r, c) ? S[r][c] * scale : -1e30) for r < rows and
// c < ncols, rounded to T; columns [ncols, ncols_pad) are written as 0 (the
// zero-padded keys of the PV product). fp32 softmax, normalised before the
// rounding (exp(s - max) / sum). P may alias S when T is float.
template <typename T, int NT, typename Keep>
__device__ __forceinline__ void softmax_rows(const float* S, int lds, T* P, int ldp, int rows,
                                             int ncols, int ncols_pad, float scale, Keep keep) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    const float* srow = S + r * lds;
    float mx = kNegInf;
    for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, keep(r, c) ? srow[c] * scale : kNegInf);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) sum += expf((keep(r, c) ? srow[c] * scale : kNegInf) - mx);
    sum = warp_sum(sum);
    for (int c = lane; c < ncols_pad; c += 32) {
      float p = 0.f;
      if (c < ncols) p = expf((keep(r, c) ? srow[c] * scale : kNegInf) - mx) / sum;
      P[r * ldp + c] = from_float<T>(p);
    }
  }
}

}  // namespace enc
}  // namespace medsam2
