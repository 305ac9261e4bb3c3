// Fused LayerNorm -> MLP(fc1, GELU, fc2) -> residual for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medsam2_tpu/ops/fused_mlp.py:_kernel
// (reached through _pallas_fwd <- ln_mlp_residual): the x + mlp(norm2(x))
// tail of a Hiera block, y = (x + T(fc2(gelu(fc1(LN(x)))))) + b2.
//
// What bounds it on the H100: per row it reads and writes C values (4C bytes
// in bf16) and does 2 * 2 * C * 4C = 16 C^2 flops, 4C flops per byte (384 at
// C = 96, 3072 at C = 768), above the card's ~295 flop/byte ridge, so the
// limit is tensor-core issue rate; XLA's lowering instead writes the normed
// rows and the 4C-wide
// hidden activations to device memory and reads them back. This kernel keeps
// both in shared memory: a block owns 32 rows, normalises them once, then
// walks the hidden width in chunks of 128 (fc1 chunk -> bias -> GELU ->
// fc2 partial product accumulated in fp32), so device memory sees one read
// of x, one write of y and the weights, which stream from L2 (W1 is
// 4.5 MiB in bf16 at C = 768). The products are WMMA mma.sync with B loaded
// straight from L2; a wgmma + TMA pipeline is later work.
//
// Grid: ceil(N / 32) blocks of 256 threads; any row count (the ragged last
// block masks its rows). Instantiated for C in {96, 192, 384, 768}, H = 4C.

#include "encoder_tile.cuh"

namespace medsam2 {
namespace {

constexpr int kMlpThreads = 256;
constexpr int kMlpRows = 32;

template <typename T, int C>
struct MlpSmem {
  static constexpr size_t normed_off = 0;
  static constexpr size_t acc_off = normed_off + align128(sizeof(T) * kMlpRows * enc::ld<T>(C));
  static constexpr size_t hid_off = acc_off + align128(sizeof(float) * kMlpRows * (C + 4));
  static constexpr size_t scratch_off =
      hid_off + align128(sizeof(T) * kMlpRows * enc::ld<T>(enc::kHiddenChunk));
  static constexpr size_t bytes =
      scratch_off + (sizeof(T) == 2 ? sizeof(float) * 256 * (kMlpThreads / 32) : 0);
  static_assert(bytes <= 232448, "tile does not fit the 227 KB a block may use");
};

template <typename T, int C>
__global__ void __launch_bounds__(kMlpThreads)
    fused_mlp_kernel(const T* __restrict__ x, enc::MlpParams<T> p, float eps, T* __restrict__ out,
                     int N) {
  using L = MlpSmem<T, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.x * kMlpRows;
  const int valid = min(kMlpRows, N - r0);
  enc::mlp_residual_rows<T, C, kMlpRows, kMlpThreads>(
      x + (size_t)r0 * C, C, valid, p, eps, reinterpret_cast<T*>(smem + L::normed_off),
      reinterpret_cast<float*>(smem + L::acc_off), reinterpret_cast<T*>(smem + L::hid_off),
      reinterpret_cast<float*>(smem + L::scratch_off), out + (size_t)r0 * C);
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* const* prm, void* out, int N, float eps,
                   cudaStream_t stream) {
  using L = MlpSmem<T, C>;
  auto kern = fused_mlp_kernel<T, C>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const enc::MlpParams<T> p{static_cast<const T*>(prm[0]), static_cast<const T*>(prm[1]),
                            static_cast<const T*>(prm[2]), static_cast<const T*>(prm[3]),
                            static_cast<const T*>(prm[4]), static_cast<const T*>(prm[5])};
  kern<<<(N + kMlpRows - 1) / kMlpRows, kMlpThreads, L::bytes, stream>>>(
      static_cast<const T*>(x), p, eps, static_cast<T*>(out), N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* const* prm, void* out, int N, float eps,
                     cudaStream_t stream) {
  switch (C) {
    case 96: return launch<T, 96>(x, prm, out, N, eps, stream);
    case 192: return launch<T, 192>(x, prm, out, N, eps, stream);
    case 384: return launch<T, 384>(x, prm, out, N, eps, stream);
    case 768: return launch<T, 768>(x, prm, out, N, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace medsam2

// x [N, C]; gamma, beta [C]; w1 [4C, C]; b1 [4C]; w2 [C, 4C]; b2 [C]; out
// [N, C]. All contiguous, 32-byte aligned, one dtype (0 = float32,
// 1 = bfloat16). Returns the cudaError_t of the launch.
extern "C" int medsam2_fused_mlp_fwd(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, int N, int C, int H, float eps,
                                     int dtype, void* stream) {
  using namespace medsam2;
  if (N <= 0 || H != 4 * C) return (int)cudaErrorInvalidValue;
  const void* prm[6] = {gamma, beta, w1, b1, w2, b2};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)dispatch<bf16>(C, x, prm, out, N, eps, s);
  if (dtype == 0) return (int)dispatch<float>(C, x, prm, out, N, eps, s);
  return (int)cudaErrorInvalidValue;
}
