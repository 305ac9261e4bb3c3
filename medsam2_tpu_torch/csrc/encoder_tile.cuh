// Row-tile building blocks of the three Hiera encoder kernels
// (window_attention.cu, fused_mlp.cu, fused_block.cu).
//
// A thread block holds a tile of rows (tokens) in shared memory and runs
// every product of its rows itself:
//   - layer_norm_rows: fp32 statistics, biased variance, rsqrt(var + eps),
//     affine in fp32, result rounded to the working type;
//   - gemm_rows: out = A B over the tile's rows, with B read straight from a
//     weight in device memory (a Linear's [out, in] matrix, L2-resident) or
//     from keys / values in shared memory. bfloat16 runs on the tensor cores
//     through WMMA (mma.sync 16x16x16, fp32 accumulation) one 16x16 tile per
//     warp, staged through a per-warp fp32 scratch; float32 is plain FMA
//     (no TF32, as the JAX package pins Precision.HIGHEST). Every output is
//     handed once, by one thread, to an epilogue that rounds, adds a bias,
//     applies GELU or accumulates, in the order the Pallas kernel does;
//   - softmax_rows: fp32 softmax of a logit tile (masked logits -1e30),
//     probabilities normalised and then rounded to the working type;
//   - mlp_residual_rows: B7's body, x + fc2(gelu(fc1(LN(x)))) with the hidden
//     width walked in chunks of 128, so the 4C hidden activations never reach
//     device memory. fused_block.cu runs it as the second half of a block.
#pragma once

#include "attention_tile.cuh"

namespace medsam2 {
namespace enc {

// Leading dimension (elements) of a shared-memory row of `cols` values:
// padded by 16 bytes, which keeps every 16-row WMMA tile 32-byte aligned.
template <typename T>
__host__ __device__ constexpr int ld(int cols) {
  return cols + (sizeof(T) == 2 ? 8 : 4);
}

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

// dst[r] = T(LN(src[r]) * g + b) for r < rows; rows at or past `valid` read
// as zeros. One warp per row, C / 32 values per lane.
template <typename T, int C, int NT>
__device__ __forceinline__ void layer_norm_rows(T* dst, int ldd, const T* src, int lds, int rows,
                                                int valid, const T* g, const T* b, float eps) {
  static_assert(C % 32 == 0, "layer_norm_rows maps C / 32 values to each lane");
  constexpr int PER = C / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    float v[PER];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      v[j] = r < valid ? to_float(src[(size_t)r * lds + lane + 32 * j]) : 0.f;
      sum += v[j];
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) sq += (v[j] - mean) * (v[j] - mean);
    const float inv = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      dst[r * ldd + c] = from_float<T>((v[j] - mean) * inv * to_float(g[c]) + to_float(b[c]));
    }
  }
}

// out(r, c) = sum_k A[r * lda + k] * B(k, c) for r < BM, c < N, with
//   B(k, c) = W[c * ldw + k]  (kRowMajorB false: a Linear's [out, in] weight, or keys [key, d])
//   B(k, c) = W[k * ldw + c]  (kRowMajorB true: values [key, d]).
// K and N are multiples of 16, BM of 16; A and W tiles 32-byte aligned. Each
// output goes once to epi(r, c, value) from one thread. `scratch` holds
// NT / 32 blocks of 256 floats (bfloat16 only).
template <typename T, int BM, int NT, bool kRowMajorB, typename Epi>
__device__ __forceinline__ void gemm_rows(const T* A, int lda, const T* W, int ldw, int K, int N,
                                          float* scratch, Epi epi) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float* sc = scratch + warp * 256;
    const int tiles_n = N / 16;
    for (int tile = warp; tile < (BM / 16) * tiles_n; tile += NT / 32) {
      const int r0 = (tile / tiles_n) * 16;
      const int c0 = (tile % tiles_n) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + r0 * lda + k0, lda);
        if constexpr (kRowMajorB) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, W + (size_t)k0 * ldw + c0, ldw);
          wmma::mma_sync(acc, a, bm, acc);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(bm, W + (size_t)c0 * ldw + k0, ldw);
          wmma::mma_sync(acc, a, bm, acc);
        }
      }
      wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) epi(r0 + i / 16, c0 + i % 16, sc[i]);
      __syncwarp();
    }
  } else {
    // each thread: one output column, 16 rows
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

// One MLP tail's parameters, each in the working type: LN scale / bias [C],
// fc1 weight [4C, C] and bias [4C], fc2 weight [C, 4C] and bias [C] (torch
// Linear layouts).
template <typename T>
struct MlpParams {
  const T* g;
  const T* b;
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
};

constexpr int kHiddenChunk = 128;

// out[r] = (x[r] + T(fc2(gelu(fc1(LN(x[r])))))) + b2 for r < valid: the
// Pallas kernel's rounding order (fused_mlp.py:75). fc1's output is rounded,
// then its bias added in T, then GELU; fc2 accumulates every hidden chunk in
// fp32 and is rounded once. Work space in shared memory: normed
// [BM][ld<T>(C)], acc [BM][C + 4] fp32, hid [BM][ld<T>(128)], and the gemm
// scratch. x may lie in device or shared memory (row stride ldx); out is
// device memory with row stride C.
template <typename T, int C, int BM, int NT>
__device__ __forceinline__ void mlp_residual_rows(const T* x, int ldx, int valid,
                                                  const MlpParams<T>& p, float eps, T* normed,
                                                  float* acc, T* hid, float* scratch, T* out) {
  constexpr int H = 4 * C;
  constexpr int HC = kHiddenChunk;
  constexpr int LDN = ld<T>(C);
  constexpr int LDA = C + 4;
  constexpr int LDH = ld<T>(HC);
  static_assert(H % HC == 0, "the hidden width walks in whole chunks");
  layer_norm_rows<T, C, NT>(normed, LDN, x, ldx, BM, valid, p.g, p.b, eps);
  for (int i = threadIdx.x; i < BM * LDA; i += NT) acc[i] = 0.f;
  __syncthreads();
  for (int j = 0; j < H; j += HC) {
    gemm_rows<T, BM, NT, false>(normed, LDN, p.w1 + (size_t)j * C, C, C, HC, scratch,
                                [&](int r, int c, float v) {
                                  const float h = rnd<T>(rnd<T>(v) + to_float(p.b1[j + c]));
                                  hid[r * LDH + c] = from_float<T>(gelu<T>(h));
                                });
    __syncthreads();
    gemm_rows<T, BM, NT, false>(hid, LDH, p.w2 + j, H, HC, C, scratch,
                                [&](int r, int c, float v) { acc[r * LDA + c] += v; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < valid * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const float y = rnd<T>(to_float(x[(size_t)r * ldx + c]) + rnd<T>(acc[r * LDA + c]));
    out[(size_t)r * C + c] = from_float<T>(y + to_float(p.b2[c]));
  }
}

}  // namespace enc
}  // namespace medsam2
