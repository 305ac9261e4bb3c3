// The Hiera encoder's row-wise products for Hopper (sm_90a): LayerNorm rows
// and linears with the Pallas kernels' epilogues.
//
// They make up the fused LN-MLP (B7, replacing the Pallas TPU kernel
// medsam2_tpu/ops/fused_mlp.py:_kernel) and the fused window block (B8,
// medsam2_tpu/ops/fused_block.py:_kernel): LN, qkv, window attention, proj
// and the MLP as a short sequence of these launches.
//
// What bounds them on the H100: a linear of M rows does 2 M N K flops
// against 2 (M K + N K + M N) bytes in bf16, above the ~295 flop/byte
// ridge for every encoder shape (M >= 1024, K >= 112): tensor-core issue.
// The LayerNorm pass moves 4 M C bytes and is bound by device memory.
//
// bf16 linear: encoder_linear_sm90.cuh, a persistent warp-specialised
// wgmma + TMA product whose column tile BN (a multiple of 16 up to 192) is
// matched to N by tile_n below, with the epilogue stored by TMA from a
// swizzled shared-memory tile. Any M, any N and K that are multiples of 8.
//
// fp32 linear (TF32 off, as the JAX package pins Precision.HIGHEST): plain
// FMA on 64 x 64 output tiles, 16-deep k slices staged in shared memory.
//
// The bf16 fused MLP at the widths C <= 256 of the presets (96, 112, 144,
// 192, 224) is one kernel, mlp_fused_sm90_kernel: a block's 128 LN rows are
// written by its consumers into a swizzled shared-memory tile, and the
// hidden width is walked in 64-wide chunks (fc1 chunk by wgmma, bias and
// GELU in registers, fc2 by wgmma with A from registers into a [64 x C]
// fp32 accumulator per warpgroup), so the hidden rows never leave the SM.
// Wider C (the [64 x C] accumulator no longer fits the registers) and fp32
// take three launches: layer_norm writes the rounded LN rows (the Pallas
// kernel rounds them there too), fc1 writes the rounded GELU hidden rows,
// fc2 adds the residual. The hidden rows pass through device memory, but at
// the encoder's row counts they stay in the 50 MB L2 (12.6 MB at 4096 x
// 1536, 9.4 MB at hiera_l's 1024 x 4608).

#include "encoder_gemm.cuh"
#include "encoder_linear_sm90.cuh"
#include "encoder_tile.cuh"
#include "hopper_attention.cuh"

namespace medsam2 {
namespace enc {
namespace {

template <typename T>
struct Epi {
  const T* bias;
  const T* resid;
  T* out;
  int M, N, epi;
  // the value written at (r, c), before its rounding to T
  __device__ __forceinline__ float apply(int r, int c, float v) const {
    const float t = rnd<T>(v);
    if (epi == kEpiResidual)
      return rnd<T>(to_float(resid[(size_t)r * N + c]) + t) + to_float(bias[c]);
    const float h = t + to_float(bias[c]);
    return epi == kEpiBiasGelu ? gelu<T>(rnd<T>(h)) : h;
  }
};

// ---------------------------------------------------------------------------
// LayerNorm rows: one warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                      T* __restrict__ out, int N, int C, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const T* xr = x + (size_t)row * C;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += to_float(xr[c]);
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_float(xr[c]) - mean;
    sq += d * d;
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
  T* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_float<T>((to_float(xr[c]) - mean) * inv * to_float(g[c]) + to_float(b[c]));
}

// ---------------------------------------------------------------------------
// fp32 linear: FMA tiles
// ---------------------------------------------------------------------------

constexpr int kFT = 64;  // output tile edge
constexpr int kFK = 16;  // k slice

__global__ void __launch_bounds__(256)
    linear_fma_kernel(const float* __restrict__ a, const float* __restrict__ w, Epi<float> e,
                      int K) {
  __shared__ float as[kFK][kFT + 4];  // [k][row]
  __shared__ float bs[kFK][kFT + 4];  // [k][column]
  const int m0 = blockIdx.y * kFT;
  const int n0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = threadIdx.x; i < kFT * kFK; i += 256) {
      const int r = i / kFK;
      const int kk = i % kFK;
      const int gk = k0 + kk;
      as[kk][r] = (m0 + r < e.M && gk < K) ? a[(size_t)(m0 + r) * K + gk] : 0.f;
      bs[kk][r] = (n0 + r < e.N && gk < K) ? w[(size_t)(n0 + r) * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[kk][ty + 16 * i];
        bv[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i;
      const int c = n0 + tx + 16 * j;
      if (r < e.M && c < e.N) e.out[(size_t)r * e.N + c] = e.apply(r, c, acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// bf16 fused MLP at C <= 256: one kernel, the hidden rows never leave the SM
// ---------------------------------------------------------------------------

constexpr int kGM = 128;  // rows a block: two consumer warpgroups
constexpr int kHC = 64;   // hidden columns a chunk

template <int C>
struct MlpLayout {
  static constexpr int kCP = (C + 63) / 64 * 64;  // fc1's K padded to whole 64-wide chunks
  static constexpr int kKC = kCP / 64;
  static constexpr int kABytes = kGM * kCP * 2;   // the LN rows, [kKC][128][64]
  static constexpr int kW1Bytes = kHC * kCP * 2;  // a chunk's fc1 weight rows, [kKC][64][64]
  static constexpr int kW2Bytes = C * kHC * 2;    // a chunk's fc2 weight columns, [C][64]
  static constexpr int kStage = kW1Bytes + kW2Bytes;
  static constexpr int kFit = (hopper::kSmemLimit - kABytes - 2048) / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int w_off = kABytes;
  static constexpr int bar_off = w_off + kStages * kStage;
  static constexpr int bytes = bar_off + 128 + 1024;  // barriers, base alignment
  static_assert(C % 16 == 0 && C <= 256, "fc2's N in 64-, 32- and 16-wide pieces");
  static_assert(kStages >= 2 && bytes <= hopper::kSmemLimit, "two stages do not fit");
};

struct MlpMaps {
  CUtensorMap w1, w2;
};

struct MlpArgs {
  const bf16* x;
  const bf16* g;
  const bf16* b;
  const bf16* b1;
  const bf16* b2;
  bf16* out;
  int N;
  float eps;
};

// A block owns 128 rows. Its consumer warpgroups (64 rows each) write their
// LN rows into the A tile (fp32 statistics, rounded to bf16, columns past C
// zero); then per 64-wide hidden chunk: h = LN(x) W1_chunk^T by wgmma from
// shared memory, T(gelu(T(T(h) + b1))) in registers as the A fragments of
// acc += h W2_chunk^T (wgmma with A from registers, fc2's C columns in 64-,
// 32- and 16-wide pieces), the [64 x C] fp32 accumulator in registers over
// all chunks; the producer streams each chunk's W1 rows and W2 columns
// through the ring. Epilogue (x + T(acc)) + b2.
template <int C>
__global__ void __launch_bounds__(384, 1)
    mlp_fused_sm90_kernel(const __grid_constant__ MlpMaps maps, const MlpArgs a) {
  using namespace hopper;
  using L = MlpLayout<C>;
  constexpr int kChunks = 4 * C / kHC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::bar_off);
  uint64_t* empty = full + L::kStages;
  const int m0 = blockIdx.x * kGM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load ----
    regs_dec<40>();
    if (threadIdx.x == 0) {
      Ring ring;
      for (int j = 0; j < kChunks; ++j) {
        const int s = ring.stage;
        mbar_wait(empty + s, ring.phase ^ 1u);
        unsigned char* st = base + L::w_off + s * L::kStage;
        mbar_arrive_expect_tx(full + s, L::kStage);
#pragma unroll
        for (int kc = 0; kc < L::kKC; ++kc)
          tma_load_3d(st + kc * kHC * 128, &maps.w1, full + s, kc * 64, j * kHC, 0);
        tma_load_3d(st + L::kW1Bytes, &maps.w2, full + s, j * kHC, 0, 0);
        ring.advance<L::kStages>();
      }
    }
    return;
  }

  regs_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;

  // ---- LN prologue: this warpgroup's 64 rows into the swizzled A tile ----
  for (int rr = warp; rr < 64; rr += 4) {
    const int r = wg * 64 + rr;
    const int row = m0 + r;
    const bf16* xr = a.x + (size_t)row * C;
    float mean = 0.f, inv = 0.f;
    if (row < a.N) {
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += to_float(xr[c]);
      mean = warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_float(xr[c]) - mean;
        sq += d * d;
      }
      inv = rsqrtf(warp_sum(sq) / C + a.eps);
    }
    for (int c = lane; c < L::kCP; c += 32) {
      const bool in = row < a.N && c < C;
      const float v =
          in ? (to_float(xr[c]) - mean) * inv * to_float(a.g[c]) + to_float(a.b[c]) : 0.f;
      *reinterpret_cast<bf16*>(base + (c / 64) * kGM * 128 + swz128(r, c % 64)) =
          __float2bfloat16(v);
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  const uint32_t a_addr = smem_u32(base) + wg * 64 * 128;
  Ring ring;
  for (int j = 0; j < kChunks; ++j) {
    const int s = ring.stage;
    mbar_wait(full + s, ring.phase);
    const uint32_t w1_addr = smem_u32(base + L::w_off + s * L::kStage);
    const uint32_t w2_addr = w1_addr + L::kW1Bytes;

    // ---- fc1 chunk: h [64 x 64] ----
    float h[32];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < L::kKC; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wgmma_ss_n64(h, make_desc(a_addr + kc * kGM * 128 + 32 * i, 64, 16, 1024),
                     make_desc(w1_addr + kc * kHC * 128 + 32 * i, 64, 16, 1024),
                     (kc | i) ? 1 : 0);
    wg_commit();
    wg_wait_all();
    fence_regs<32>(h);

    // ---- bias and GELU, rounded as the Pallas kernel: fc2's A fragments ----
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const __nv_bfloat162 bb =
          *reinterpret_cast<const __nv_bfloat162*>(a.b1 + j * kHC + 8 * jj + 2 * quad);
      const float bx = __low2float(bb), by = __high2float(bb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[4 * jj + e] = gelu<bf16>(rnd<bf16>(rnd<bf16>(h[4 * jj + e]) + ((e & 1) ? by : bx)));
    }
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(h[8 * kk + 2 * e], h[8 * kk + 2 * e + 1]);

    // ---- fc2: acc += h W2_chunk^T, C columns in 64/32/16-wide pieces ----
    fence_regs<C / 2>(acc);
    wg_fence();
    constexpr int kN64 = C / 64;                     // 64-wide pieces
    constexpr int kN32 = C % 64 >= 32 ? 1 : 0;       // then one 32-wide piece
    constexpr int kN16 = C % 32 ? 1 : 0;             // then one 16-wide piece
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < kN64; ++q)
        wgmma_rs_kmajor_n64(acc + 32 * q, p[kk],
                            make_desc(w2_addr + 64 * q * 128 + 32 * kk, 64, 16, 1024));
      if constexpr (kN32)
        wgmma_rs_kmajor_n32(acc + 32 * kN64, p[kk],
                            make_desc(w2_addr + 64 * kN64 * 128 + 32 * kk, 64, 16, 1024));
      if constexpr (kN16)
        wgmma_rs_kmajor_n16(
            acc + 32 * kN64 + 16 * kN32, p[kk],
            make_desc(w2_addr + (64 * kN64 + 32 * kN32) * 128 + 32 * kk, 64, 16, 1024));
    }
    wg_commit();
    wg_wait_all();
    fence_regs<C / 2>(acc);
    mbar_arrive(empty + s);
    ring.advance<L::kStages>();
  }

  // ---- epilogue: (x + T(acc)) + b2, rows r_a and r_a + 8 ----
  const int r_a = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_a + 8 * hh;
    if (r >= a.N) continue;
#pragma unroll
    for (int jj = 0; jj < C / 8; ++jj) {
      const int c = 8 * jj + 2 * quad;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(a.x + (size_t)r * C + c);
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(a.b2 + c);
      const float y0 = rnd<bf16>(__low2float(xv) + rnd<bf16>(acc[4 * jj + 2 * hh]));
      const float y1 = rnd<bf16>(__high2float(xv) + rnd<bf16>(acc[4 * jj + 2 * hh + 1]));
      *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)r * C + c) =
          __floats2bfloat162_rn(y0 + __low2float(bv), y1 + __high2float(bv));
    }
  }
}

template <int C>
cudaError_t launch_mlp_fused(const bf16* x, const bf16* g, const bf16* b, const bf16* w1,
                             const bf16* b1, const bf16* w2, const bf16* b2, bf16* out, int N,
                             float eps, cudaStream_t stream) {
  using L = MlpLayout<C>;
  MlpMaps maps;
  if (!hopper::make_map(&maps.w1, w1, C, 4 * C, 1, 64, kHC) ||
      !hopper::make_map(&maps.w2, w2, 4 * C, C, 1, 64, C))
    return cudaErrorInvalidValue;
  auto kern = mlp_fused_sm90_kernel<C>;
  static unsigned long long smem_set = 0;
  const cudaError_t err =
      hopper::allow_smem(reinterpret_cast<const void*>(kern), L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const MlpArgs args{x, g, b, b1, b2, out, N, eps};
  kern<<<(N + kGM - 1) / kGM, 384, L::bytes, stream>>>(maps, args);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace

template <typename T>
cudaError_t layer_norm(const T* x, const T* g, const T* b, T* out, int N, int C, float eps,
                       cudaStream_t stream) {
  if (N <= 0 || C <= 0 || C % 8) return cudaErrorInvalidValue;
  layer_norm_kernel<T><<<(N + 7) / 8, 256, 0, stream>>>(x, g, b, out, N, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t linear(const T* a, const T* w, const T* bias, const T* resid, T* out, int M, int N,
                   int K, int epi, cudaStream_t stream) {
  auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || epi < kEpiBias || epi > kEpiResidual ||
      (epi == kEpiResidual && (resid == nullptr || misaligned(resid))) || misaligned(a) ||
      misaligned(w) || misaligned(bias) || misaligned(out))
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    const int sms = sm_count();
    const LinearCall c{a, w, bias, resid, out, M, N, K, epi, sms, stream};
    switch (tile_n(M, N, K, sms)) {
#define MEDSAM2_LINEAR_CASE(BN) \
  case BN:                      \
    return launch_linear<BN>(c);
      MEDSAM2_LINEAR_WIDTHS(MEDSAM2_LINEAR_CASE)
#undef MEDSAM2_LINEAR_CASE
      default: return cudaErrorInvalidValue;
    }
  } else {
    const Epi<T> e{bias, resid, out, M, N, epi};
    const dim3 grid((N + kFT - 1) / kFT, (M + kFT - 1) / kFT);
    linear_fma_kernel<<<grid, 256, 0, stream>>>(a, w, e, K);
    return cudaGetLastError();
  }
}

int tile_n(int M, int N, int K, int sms) {
  (void)K;  // every tile walks the same K
  bool divides = false;
  for (int bn = 16; bn <= 192; bn += 16) divides = divides || N % bn == 0;
  int best = 0;
  long best_cost = -1;
  for (int bn = 16; bn <= 192; bn += 16) {
    if (divides && N % bn) continue;
    const long tiles = (long)((M + kLM - 1) / kLM) * ((N + bn - 1) / bn);
    const long cost = (tiles + sms - 1) / sms * ((bn > 64 ? bn : 64) + 32);
    if (best_cost < 0 || cost <= best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

int mlp_launches(int C, int H, bool is_bf16) {
  const bool fused =
      is_bf16 && H == 4 * C && (C == 96 || C == 112 || C == 144 || C == 192 || C == 224);
  return fused ? 1 : 3;
}

template <typename T>
cudaError_t mlp_residual(const T* x, const T* g, const T* b, const T* w1, const T* b1,
                         const T* w2, const T* b2, T* normed, T* hidden, T* out, int N, int C,
                         int H, float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (N > 0 && mlp_launches(C, H, true) == 1) {
      switch (C) {
        case 96: return launch_mlp_fused<96>(x, g, b, w1, b1, w2, b2, out, N, eps, stream);
        case 112: return launch_mlp_fused<112>(x, g, b, w1, b1, w2, b2, out, N, eps, stream);
        case 144: return launch_mlp_fused<144>(x, g, b, w1, b1, w2, b2, out, N, eps, stream);
        case 192: return launch_mlp_fused<192>(x, g, b, w1, b1, w2, b2, out, N, eps, stream);
        default: return launch_mlp_fused<224>(x, g, b, w1, b1, w2, b2, out, N, eps, stream);
      }
    }
  }
  if (normed == nullptr || hidden == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = layer_norm<T>(x, g, b, normed, N, C, eps, stream);
  if (e == cudaSuccess) e = linear<T>(normed, w1, b1, nullptr, hidden, N, H, C, kEpiBiasGelu, stream);
  if (e == cudaSuccess) e = linear<T>(hidden, w2, b2, x, out, N, C, H, kEpiResidual, stream);
  return e;
}

template cudaError_t layer_norm<float>(const float*, const float*, const float*, float*, int,
                                       int, float, cudaStream_t);
template cudaError_t layer_norm<bf16>(const bf16*, const bf16*, const bf16*, bf16*, int, int,
                                      float, cudaStream_t);
template cudaError_t linear<float>(const float*, const float*, const float*, const float*, float*,
                                   int, int, int, int, cudaStream_t);
template cudaError_t linear<bf16>(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, int,
                                  int, int, int, cudaStream_t);
template cudaError_t mlp_residual<float>(const float*, const float*, const float*, const float*,
                                         const float*, const float*, const float*, float*, float*,
                                         float*, int, int, int, float, cudaStream_t);
template cudaError_t mlp_residual<bf16>(const bf16*, const bf16*, const bf16*, const bf16*,
                                        const bf16*, const bf16*, const bf16*, bf16*, bf16*,
                                        bf16*, int, int, int, float, cudaStream_t);

}  // namespace enc
}  // namespace medsam2
