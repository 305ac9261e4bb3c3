// A whole plain windowed Hiera block in one kernel, for Hopper (sm_90a).
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
// One block per 64 rows (one ws-8 window, or four ws-4 windows; the logits
// of a group are one 64 x 64 tile under a same-window mask, which is exactly
// the per-window softmax). In order, all in shared memory: LN1 -> for each
// head, its q/k/v columns of the qkv product (W_qkv streamed from L2) ->
// logits -> softmax -> P V -> that head's slice of the projection added to
// an fp32 accumulator -> residual + bias -> fused_mlp.cu's MLP tail
// (enc::mlp_residual_rows: LN2, the hidden width in chunks of 128). Device
// memory sees one read of x, one write of out and the weights.
//
// What bounds it on the H100: per row 2C(3C + C + 8C) + 4 * 64 * C flops
// against 4C bytes in bf16, above the ~295 flop/byte ridge at C = 96 and
// 192, so tensor-core issue rate bounds it; the design keeps the ~10
// x-sized intermediates of the unfused block out of device memory.
//
// Grid: ceil(N / 64) blocks of 256 threads; a ragged last group masks its
// rows. Instantiated for C in {96, 192} (hiera_t / hiera_s stages 1-2),
// head dim 96, windows of n rows with 64 % n == 0.

#include "encoder_tile.cuh"

namespace medsam2 {
namespace {

constexpr int kBlkThreads = 256;
constexpr int kBlkRows = 64;
constexpr int kBlkD = 96;

template <typename T, int C>
struct BlockSmem {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int LDC = enc::ld<T>(C);             // normed1, then x1
  static constexpr int LDA = C + 4;                     // fp32 accumulator
  static constexpr int LDQ = enc::ld<T>(3 * kBlkD);     // one head's q | k | v
  static constexpr int LDS = kBlkRows + 4;              // logits
  static constexpr int LDP = kBf16 ? enc::ld<T>(kBlkRows) : LDS;
  static constexpr int LDO = enc::ld<T>(kBlkD);         // one head's output
  static constexpr size_t qkv_bytes = sizeof(T) * kBlkRows * (LDQ > LDC ? LDQ : LDC);
  static constexpr size_t att_bytes = align128(sizeof(float) * kBlkRows * LDS) +
                                      (kBf16 ? align128(sizeof(T) * kBlkRows * LDP) : 0) +
                                      align128(sizeof(T) * kBlkRows * LDO);
  static constexpr size_t hid_bytes = sizeof(T) * kBlkRows * enc::ld<T>(enc::kHiddenChunk);
  static constexpr size_t xn_off = 0;
  static constexpr size_t acc_off = xn_off + align128(sizeof(T) * kBlkRows * LDC);
  static constexpr size_t qkv_off = acc_off + align128(sizeof(float) * kBlkRows * LDA);
  // the attention tiles, then (MLP half) the hidden chunk
  static constexpr size_t s_off = qkv_off + align128(qkv_bytes);
  static constexpr size_t p_off = s_off + align128(sizeof(float) * kBlkRows * LDS);
  static constexpr size_t o_off = p_off + (kBf16 ? align128(sizeof(T) * kBlkRows * LDP) : 0);
  static constexpr size_t scratch_off =
      s_off + align128(att_bytes > hid_bytes ? att_bytes : hid_bytes);
  static constexpr size_t bytes =
      scratch_off + (kBf16 ? sizeof(float) * 256 * (kBlkThreads / 32) : 0);
  static_assert(bytes <= 232448, "tile does not fit the 227 KB a block may use");
  static_assert(C % kBlkD == 0, "heads of 96 channels");
};

template <typename T>
struct BlockParams {
  const T* g1;
  const T* b1;
  const T* wqkv;  // [3C, C]
  const T* bqkv;  // [3C]
  const T* wp;    // [C, C]
  const T* bp;    // [C]
  enc::MlpParams<T> mlp;
};

template <typename T, int C>
__global__ void __launch_bounds__(kBlkThreads)
    fused_block_kernel(const T* __restrict__ x, BlockParams<T> p, int n, float eps, float scale,
                       T* __restrict__ out, int N) {
  using L = BlockSmem<T, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xn = reinterpret_cast<T*>(smem + L::xn_off);
  float* acc = reinterpret_cast<float*>(smem + L::acc_off);
  T* qkv = reinterpret_cast<T*>(smem + L::qkv_off);
  float* s = reinterpret_cast<float*>(smem + L::s_off);
  T* pr = L::kBf16 ? reinterpret_cast<T*>(smem + L::p_off) : reinterpret_cast<T*>(s);
  T* oh = reinterpret_cast<T*>(smem + L::o_off);
  float* scratch = reinterpret_cast<float*>(smem + L::scratch_off);

  const int r0 = blockIdx.x * kBlkRows;
  const int valid = min(kBlkRows, N - r0);
  const T* xb = x + (size_t)r0 * C;

  enc::layer_norm_rows<T, C, kBlkThreads>(xn, L::LDC, xb, C, kBlkRows, valid, p.g1, p.b1, eps);
  for (int i = threadIdx.x; i < kBlkRows * L::LDA; i += kBlkThreads) acc[i] = 0.f;
  __syncthreads();
  for (int h = 0; h < C / kBlkD; ++h) {
    for (int part = 0; part < 3; ++part) {
      const int col0 = part * C + h * kBlkD;  // this head's columns of q, k or v
      enc::gemm_rows<T, kBlkRows, kBlkThreads, false>(
          xn, L::LDC, p.wqkv + (size_t)col0 * C, C, C, kBlkD, scratch,
          [&](int r, int c, float v) {
            qkv[r * L::LDQ + part * kBlkD + c] =
                from_float<T>(enc::rnd<T>(v) + to_float(p.bqkv[col0 + c]));
          });
    }
    __syncthreads();
    enc::gemm_rows<T, kBlkRows, kBlkThreads, false>(
        qkv, L::LDQ, qkv + kBlkD, L::LDQ, kBlkD, kBlkRows, scratch,
        [&](int r, int c, float v) { s[r * L::LDS + c] = v; });
    __syncthreads();
    enc::softmax_rows<T, kBlkThreads>(s, L::LDS, pr, L::LDP, kBlkRows, kBlkRows, kBlkRows, scale,
                                      [n](int r, int c) { return r / n == c / n; });
    __syncthreads();
    enc::gemm_rows<T, kBlkRows, kBlkThreads, true>(
        pr, L::LDP, qkv + 2 * kBlkD, L::LDQ, kBlkRows, kBlkD, scratch,
        [&](int r, int c, float v) { oh[r * L::LDO + c] = from_float<T>(v); });
    __syncthreads();
    enc::gemm_rows<T, kBlkRows, kBlkThreads, false>(
        oh, L::LDO, p.wp + h * kBlkD, C, kBlkD, C, scratch,
        [&](int r, int c, float v) { acc[r * L::LDA + c] += v; });
    __syncthreads();
  }
  // x1 = (x + T(acc)) + bp, over normed1 (no longer read)
  for (int i = threadIdx.x; i < kBlkRows * C; i += kBlkThreads) {
    const int r = i / C;
    const int c = i % C;
    const float xv = r < valid ? to_float(xb[(size_t)r * C + c]) : 0.f;
    xn[r * L::LDC + c] =
        from_float<T>(enc::rnd<T>(xv + enc::rnd<T>(acc[r * L::LDA + c])) + to_float(p.bp[c]));
  }
  __syncthreads();
  enc::mlp_residual_rows<T, C, kBlkRows, kBlkThreads>(
      xn, L::LDC, valid, p.mlp, eps, qkv, acc, reinterpret_cast<T*>(s), scratch,
      out + (size_t)r0 * C);
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* const* prm, void* out, int N, int n, float eps,
                   float scale, cudaStream_t stream) {
  using L = BlockSmem<T, C>;
  auto kern = fused_block_kernel<T, C>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  auto t = [&](int i) { return static_cast<const T*>(prm[i]); };
  const BlockParams<T> p{t(0), t(1), t(2), t(3), t(4), t(5),
                         enc::MlpParams<T>{t(6), t(7), t(8), t(9), t(10), t(11)}};
  kern<<<(N + kBlkRows - 1) / kBlkRows, kBlkThreads, L::bytes, stream>>>(
      static_cast<const T*>(x), p, n, eps, scale, static_cast<T*>(out), N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* const* prm, void* out, int N, int n,
                     float eps, float scale, cudaStream_t stream) {
  switch (C) {
    case 96: return launch<T, 96>(x, prm, out, N, n, eps, scale, stream);
    case 192: return launch<T, 192>(x, prm, out, N, n, eps, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace medsam2

// x [N, C] window-contiguous rows (n rows per window, N % n == 0,
// 64 % n == 0); params in order: norm1 weight, bias [C]; qkv weight [3C, C],
// bias [3C]; proj weight [C, C], bias [C]; norm2 weight, bias [C]; fc1
// weight [4C, C], bias [4C]; fc2 weight [C, 4C], bias [C]. out [N, C].
// All contiguous, 32-byte aligned, one dtype (0 = float32, 1 = bfloat16);
// heads = C / 96. Returns the cudaError_t of the launch.
extern "C" int medsam2_fused_block_fwd(const void* x, const void* g1, const void* b1,
                                       const void* wqkv, const void* bqkv, const void* wp,
                                       const void* bp, const void* g2, const void* b2,
                                       const void* w1, const void* b1m, const void* w2,
                                       const void* b2m, void* out, int N, int C, int heads, int n,
                                       float eps, int dtype, void* stream) {
  using namespace medsam2;
  if (N <= 0 || n <= 0 || N % n || 64 % n || heads * kBlkD != C) return (int)cudaErrorInvalidValue;
  const void* prm[12] = {g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m};
  const float scale = (float)(1.0 / sqrt((double)kBlkD));  // float32(1 / sqrt(d)), as Pallas
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)dispatch<bf16>(C, x, prm, out, N, n, eps, scale, s);
  if (dtype == 0) return (int)dispatch<float>(C, x, prm, out, N, n, eps, scale, s);
  return (int)cudaErrorInvalidValue;
}
