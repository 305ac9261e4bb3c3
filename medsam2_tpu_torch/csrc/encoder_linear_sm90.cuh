// The bf16 encoder linear for Hopper (sm_90a): a persistent, warp-
// specialised wgmma + TMA product with the Pallas kernels' epilogues.
//
// It is the building block of B7's three-launch form and of every linear of
// B8 (the Pallas TPU kernels medsam2_tpu/ops/fused_mlp.py:_kernel and
// medsam2_tpu/ops/fused_block.py:_kernel): out[M, N] = epilogue(a[M, K] @
// w[N, K]^T), rounded as encoder_gemm.cuh's Epilogue says.
//
// What bounds it on the H100: 2 M N K flops against 2 (M K + N K + M N)
// bytes, above the ~295 flop/byte ridge at every encoder shape with K >=
// 288; at K 96-224 and 65536 rows the output's bytes come close to the
// products' time. The design keeps the tensor cores fed across tiles and
// takes the epilogue's global traffic off their path:
// - Persistent grid: min(tiles, SMs) CTAs of 384 threads, one an SM. CTA b
//   takes the 128 x BN output tiles b, b + grid, b + 2 grid, ... with the
//   column index fastest, so the CTAs of one round share A row blocks (the
//   weights, at most 10.6 MB, stay in the 50 MB L2).
// - BN matched to N (tile_n in encoder_gemm.cu, restated by
//   ops/encoder_linear.tile_n): a multiple of 16 up to 192 dividing N where
//   one does, taking the fewest rounds x (max(BN, 64) + 32).
// - Warpgroup 0 is the producer. One thread TMA-loads the 64-wide k chunks
//   of the A rows and the weight rows (a torch Linear weight [N, K] is
//   already the K-major B operand) into a ring of stages ([128][64] and
//   [BN][64] in the 128-byte swizzle, a `full` and an `empty` mbarrier
//   each), tile after tile without draining between tiles; with a tile's
//   last chunk it TMA-loads the residual tile (the residual epilogue) into
//   its own buffer. TMA zero-fills rows past M and N and columns past K.
// - Warpgroups 1 and 2 consume, 64 rows each: per chunk four k16 steps of
//   wgmma.m64n{BN}k16 from shared memory (K's zero-filled tail included: a
//   step issued only below K made ptxas fence every product), a stage
//   handed back by one arrival a warp once the next chunk's group is issued.
// - Epilogue (cooperative, with an asynchronous store): each consumer
//   warpgroup rounds and adds in the Pallas order in registers (bias as
//   bf16 pairs, the residual from its shared-memory tile, GELU's tanh from
//   the fast exponential), writes bf16 into its [64][BN] staging tile
//   (16-column chunks in the 32-byte swizzle, conflict-free for the
//   accumulator's layout), and one thread TMA-stores the chunks (TMA clips
//   rows past M and columns past N). The store drains while the warpgroup
//   runs the next tile's products; the thread waits for it to have read
//   the staging tile only before the next epilogue writes it.
// - Measured on the H100 (PERF.md): ping-pong consumers (each
//   warpgroup a whole 128-row tile, its epilogue under the other's
//   products) were slower at hiera_l's C 576 block (0.1585 against 0.1293
//   ms) and at every one-round shape, faster only at some GELU shapes of
//   several rounds. tanhf's instruction sequence, unrolled over a tile's
//   columns, slowed even the bias-only calls (C 576 qkv 0.0266 -> 0.0211 ms
//   without it).
#pragma once

#include "encoder_gemm.cuh"
#include "encoder_tile.cuh"
#include "hopper_attention.cuh"
#include "wgmma_ss.cuh"

namespace medsam2 {
namespace enc {

constexpr int kLM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int kLK = 64;   // k of a stage: one 128-byte swizzled chunk
constexpr int kLC = 16;   // columns of an output chunk: a [64][16] box, 32-byte swizzle
constexpr int kLChunk = 64 * kLC * 2;  // bytes of an output chunk

// One call of the bf16 linear.
struct LinearCall {
  const bf16* a;      // [M, K]
  const bf16* w;      // [N, K]
  const bf16* bias;   // [N]
  const bf16* resid;  // [M, N], kEpiResidual only
  bf16* out;          // [M, N]
  int M, N, K, epi, sms;
  cudaStream_t stream;
};

template <int BN>
struct LinearCfg {
  static_assert(BN % kLC == 0 && BN >= 16 && BN <= 192, "BN a multiple of 16 up to 192");
  static constexpr int kABytes = kLM * kLK * 2;
  static constexpr int kStage = kABytes + BN * kLK * 2;  // a multiple of 1024
  static constexpr int kHalf = 64 * BN * 2;              // one warpgroup's [64][BN] tile
  static constexpr int kOut = 2 * kHalf;
  static constexpr int kFixed = 256 + 1024;              // barriers, base alignment
  // ring stages that fit beside the staging (and residual) tiles, at most 6
  static constexpr int stages(bool resid) {
    const int fit = (hopper::kSmemLimit - kFixed - kOut * (resid ? 2 : 1)) / kStage;
    return fit > 6 ? 6 : fit;
  }
  static constexpr int bytes(bool resid) {
    return stages(resid) * kStage + kOut * (resid ? 2 : 1) + kFixed;
  }
  static_assert(stages(true) >= 2, "two stages do not fit beside the residual tile");
};

struct LinearMaps {
  CUtensorMap a, w, out, resid;
};

struct LinearArgs {
  const bf16* bias;
  int M, N, K, epi, stages;
};

// Byte offset of element (r, c) of a [64][16] bf16 chunk in the 32-byte
// swizzle that TMA reads and writes (16-byte unit c / 8 of row r at unit
// (c / 8) ^ ((r / 4) % 2), the chunk 256-byte aligned).
__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return r * 32 + ((((c >> 3) ^ (r >> 2)) & 1) << 4) + (c & 7) * 2;
}

// bf16's GELU (layers.gelu: the tanh approximation evaluated in fp32), with
// tanh(u) = 1 - 2 / (1 + e^(2u)) from the fast exponential and division:
// within ~1e-7 of tanhf in absolute value, where tanhf's own instruction
// sequence made the epilogue of a 128-row tile cost more than its products.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);  // sqrt(2 / pi)
  return 0.5f * x * (2.f - __fdividef(2.f, 1.f + __expf(2.f * u)));
}

// A ring position over a number of stages known at run time.
struct RingN {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(384, 1)
    linear_persistent_sm90_kernel(const __grid_constant__ LinearMaps maps, const LinearArgs a) {
  using namespace hopper;
  using L = LinearCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bool resid = a.epi == kEpiResidual;
  const int out_off = a.stages * L::kStage;
  const int res_off = out_off + L::kOut;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + res_off + (resid ? L::kOut : 0));
  uint64_t* empty = full + a.stages;
  uint64_t* rfull = empty + a.stages;  // residual tile loaded, one per consumer warpgroup
  uint64_t* rempty = rfull + 2;        // residual tile read
  const int n_tiles = (a.N + BN - 1) / BN;
  const int tiles = (a.M + kLM - 1) / kLM * n_tiles;
  const int k_chunks = (a.K + kLK - 1) / kLK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival a consumer warp
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(rfull + h, 1);
      mbar_init(rempty + h, 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load ----
    regs_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&maps.a);
      prefetch_map(&maps.w);
      prefetch_map(&maps.out);
      if (resid) prefetch_map(&maps.resid);
      RingN ring;
      int j = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
        const int m0 = t / n_tiles * kLM;
        const int n0 = t % n_tiles * BN;
        for (int kt = 0; kt < k_chunks; ++kt) {
          const int s = ring.stage;
          unsigned char* st = base + s * L::kStage;
          mbar_wait(empty + s, ring.phase ^ 1u);
          mbar_arrive_expect_tx(full + s, L::kStage);
          tma_load_3d(st, &maps.a, full + s, kt * kLK, m0, 0);
          tma_load_3d(st + L::kABytes, &maps.w, full + s, kt * kLK, n0, 0);
          ring.advance(a.stages);
        }
        if (resid) {
          // with the tile's last chunk: the chunks of the residual tile that
          // hold columns below N, one warpgroup's 64 rows each
          const int rem = (a.N - n0 + kLC - 1) / kLC;
          const int chunks = rem < BN / kLC ? rem : BN / kLC;
          for (int h = 0; h < 2; ++h) {
            mbar_wait(rempty + h, (j & 1) ^ 1u);
            mbar_arrive_expect_tx(rfull + h, chunks * kLChunk);
            for (int c = 0; c < chunks; ++c)
              tma_load_3d(base + res_off + h * L::kHalf + c * kLChunk, &maps.resid, rfull + h,
                          n0 + c * kLC, m0 + 64 * h, 0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows of each tile ----
  regs_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int quad = t % 4;
  const int rl = (t / 32) * 16 + (t % 32) / 4;  // this thread's rows rl, rl + 8 of the 64
  unsigned char* out_tile = base + out_off + wg * L::kHalf;
  const unsigned char* res_tile = base + res_off + wg * L::kHalf;
  float acc[BN / 2];
  RingN ring;
  int j = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    const int m0 = tile / n_tiles * kLM;
    const int n0 = tile % n_tiles * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < k_chunks; ++kt) {
      const int s = ring.stage;
      mbar_wait(full + s, ring.phase);
      const uint32_t a_addr = smem_u32(base + s * L::kStage) + wg * 64 * 128;
      const uint32_t b_addr = smem_u32(base + s * L::kStage + L::kABytes);
      wg_fence();
#pragma unroll
      for (int i = 0; i < kLK / 16; ++i)
        WgmmaSS<BN>::mma(acc, make_desc(a_addr + 32 * i, 64, 16, 1024),
                         make_desc(b_addr + 32 * i, 64, 16, 1024), 1);
      wg_commit();
      wg_wait_1();  // the previous chunk's products are done: hand its stage back
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = s;
      ring.advance(a.stages);
    }
    wg_wait_all();
    fence_regs<BN / 2>(acc);
    if (lane == 0) mbar_arrive(empty + prev);

    // ---- epilogue: the previous tile's store has read the staging tile ----
    if (t == 0) store_wait_read();
    named_sync(1 + wg, 128);
    if (resid) mbar_wait(rfull + wg, j & 1);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int cl = 8 * jj + 2 * quad;  // column in the tile (and cl + 1)
      const int c = n0 + cl;
      float bx = 0.f, by = 0.f;
      if (c < a.N) {
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(a.bias + c);
        bx = __low2float(bb);
        by = __high2float(bb);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = (cl / kLC) * kLChunk + swz32(rl + 8 * h, cl % kLC);
        float v0 = rnd<bf16>(acc[4 * jj + 2 * h]);
        float v1 = rnd<bf16>(acc[4 * jj + 2 * h + 1]);
        if (resid) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(res_tile + off);
          v0 = rnd<bf16>(__low2float(x) + v0) + bx;
          v1 = rnd<bf16>(__high2float(x) + v1) + by;
        } else {
          v0 += bx;
          v1 += by;
          if (a.epi == kEpiBiasGelu) {
            v0 = gelu_tanh(rnd<bf16>(v0));
            v1 = gelu_tanh(rnd<bf16>(v1));
          }
        }
        *reinterpret_cast<uint32_t*>(out_tile + off) = hopper::pack_bf16(v0, v1);
      }
    }
    if (resid) {  // this warp has read its rows of the residual tile
      __syncwarp();
      if (lane == 0) mbar_arrive(rempty + wg);
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (t == 0 && m0 + 64 * wg < a.M) {
      for (int c = 0; c < BN / kLC && n0 + c * kLC < a.N; ++c)
        tma_store_3d(&maps.out, out_tile + c * kLChunk, n0 + c * kLC, m0 + 64 * wg, 0);
      store_commit();
    }
  }
  if (t == 0) store_wait_all();
}

template <int BN>
cudaError_t launch_linear(const LinearCall& c) {
  using L = LinearCfg<BN>;
  const bool resid = c.epi == kEpiResidual;
  LinearMaps maps;
  if (!hopper::make_map(&maps.a, c.a, c.K, c.M, 1, kLK, kLM) ||
      !hopper::make_map(&maps.w, c.w, c.K, c.N, 1, kLK, BN) ||
      !hopper::make_map(&maps.out, c.out, c.N, c.M, 1, kLC, 64) ||
      !hopper::make_map(&maps.resid, resid ? c.resid : c.out, c.N, c.M, 1, kLC, 64))
    return cudaErrorInvalidValue;
  auto kern = linear_persistent_sm90_kernel<BN>;
  static unsigned long long smem_set = 0;
  const cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(kern),
                                             hopper::kSmemLimit, smem_set);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((c.M + kLM - 1) / kLM) * ((c.N + BN - 1) / BN);
  const int grid = tiles < c.sms ? (int)tiles : c.sms;
  const LinearArgs args{c.bias, c.M, c.N, c.K, c.epi, L::stages(resid)};
  kern<<<grid, 384, L::bytes(resid), c.stream>>>(maps, args);
  return cudaGetLastError();
}

// The instantiations live in encoder_linear_sm90_n*.cu, four widths a file,
// so that they compile in parallel.
#define MEDSAM2_LINEAR_WIDTHS(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192)
#define MEDSAM2_LINEAR_EXTERN(BN) extern template cudaError_t launch_linear<BN>(const LinearCall&);
MEDSAM2_LINEAR_WIDTHS(MEDSAM2_LINEAR_EXTERN)
#undef MEDSAM2_LINEAR_EXTERN

}  // namespace enc
}  // namespace medsam2
