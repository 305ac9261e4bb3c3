// The fp32 online-softmax tile machinery of the two forward attention kernels
// (flash_attention.cu, kv_cached_attention.cu), and the helpers the
// backward kernels (flash_attention_bwd.cu) and the encoder kernels
// (encoder_tile.cuh) share: the bf16 type, conversions, warp reductions and
// load_rows. The bf16 forwards run the wgmma design of hopper_attention.cuh.
//
// fp32: one thread block owns kBQ = 64 query rows; each of its 4 warps owns a
// strip of 16 rows and does everything for those rows itself (logits,
// softmax update, PV product) with plain FMA, no TF32 (the JAX package pins
// Precision.HIGHEST for fp32), so inside a kv tile the only block-wide
// barrier is the one that publishes the freshly staged K/V tile. The running
// max m, row sum l and the output accumulator O stay in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace medsam2 {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;  // query rows per block; warp w owns [16w, 16w+16)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout (bytes) of one fp32 block.
template <int D, int DV>
struct Smem {
  static constexpr int BK = 32;   // kv rows per tile: one key column per lane
  static constexpr int PAD = 4;
  static constexpr int LDQ = D + PAD;   // floats
  static constexpr int LDK = D + PAD;
  static constexpr int LDV = DV + PAD;
  static constexpr int LDS = BK + 4;
  static constexpr int LDO = DV + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(float) * kBQ * LDQ);
  static constexpr size_t v_off = k_off + align128(sizeof(float) * BK * LDK);
  static constexpr size_t s_off = v_off + align128(sizeof(float) * BK * LDV);
  static constexpr size_t o_off = s_off + align128(sizeof(float) * kBQ * LDS);
  static constexpr size_t m_off = o_off + align128(sizeof(float) * kBQ * LDO);
  static constexpr size_t l_off = m_off + align128(sizeof(float) * kBQ);
  static constexpr size_t a_off = l_off + align128(sizeof(float) * kBQ);
  static constexpr size_t mask_off = a_off + align128(sizeof(float) * kBQ);
  static constexpr size_t bytes = mask_off + align128(sizeof(float) * BK);
  static_assert(bytes <= 232448, "tile does not fit the 227 KB a block may use");
  static_assert(D % 4 == 0 && DV % 4 == 0, "head dims must be multiples of 4");
};

template <int D, int DV>
struct Tile {
  using L = Smem<D, DV>;
  float* q;
  float* k;
  float* v;
  float* s;
  float* o;
  float* m;
  float* l;
  float* alpha;
  float* mask;
  __device__ explicit Tile(unsigned char* base)
      : q(reinterpret_cast<float*>(base + L::q_off)),
        k(reinterpret_cast<float*>(base + L::k_off)),
        v(reinterpret_cast<float*>(base + L::v_off)),
        s(reinterpret_cast<float*>(base + L::s_off)),
        o(reinterpret_cast<float*>(base + L::o_off)),
        m(reinterpret_cast<float*>(base + L::m_off)),
        l(reinterpret_cast<float*>(base + L::l_off)),
        alpha(reinterpret_cast<float*>(base + L::a_off)),
        mask(reinterpret_cast<float*>(base + L::mask_off)) {}
};

// Copy `rows` rows of COLS elements (global row stride COLS) into shared
// memory with row stride `ld`, 16 bytes per thread per step, NT threads;
// rows at or past `valid` are zero-filled (the ragged edge of a sequence).
template <typename T, int COLS, int NT = kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CV = COLS / VEC;
  for (int i = threadIdx.x; i < rows * CV; i += NT) {
    const int r = i / CV;
    const int c = (i % CV) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * COLS + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// As load_rows, but stores a + b rounded to T: the roped-key cache row plus
// its positional row, summed in the cache dtype as the Pallas kernel does.
template <typename T, int COLS>
__device__ __forceinline__ void load_rows_sum(T* dst, int ld, const T* a, const T* b, int rows,
                                              int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CV = COLS / VEC;
  for (int i = threadIdx.x; i < rows * CV; i += kThreads) {
    const int r = i / CV;
    const int c = (i % CV) * VEC;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      const uint4 va = *reinterpret_cast<const uint4*>(a + (size_t)r * COLS + c);
      const uint4 vb = *reinterpret_cast<const uint4*>(b + (size_t)r * COLS + c);
      const T* ta = reinterpret_cast<const T*>(&va);
      const T* tb = reinterpret_cast<const T*>(&vb);
      T* to = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < VEC; ++e) to[e] = from_float<T>(to_float(ta[e]) + to_float(tb[e]));
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = out;
  }
}

// Zero the accumulators and load this block's query rows.
template <int D, int DV>
__device__ __forceinline__ void init_block(Tile<D, DV>& t, const float* q_rows, int valid_q) {
  using L = Smem<D, DV>;
  load_rows<float, D>(t.q, L::LDQ, q_rows, kBQ, valid_q);
  for (int i = threadIdx.x; i < kBQ * L::LDO; i += kThreads) t.o[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    t.m[i] = kNegInf;
    t.l[i] = 0.f;
  }
}

// Stage the mask of one kv tile (mask values > 0 attend; nullptr = all valid;
// columns at or past `valid` are padding). Returns, block-uniformly, whether
// any key of the tile attends: a fully masked tile changes nothing (p = 0,
// alpha = 1) and skips its dots, as the Pallas kernel's pl.when does.
template <int D, int DV>
__device__ __forceinline__ bool stage_mask(Tile<D, DV>& t, const float* mask, int valid) {
  constexpr int BK = Smem<D, DV>::BK;
  float mv = 0.f;
  if (threadIdx.x < BK) {
    if (threadIdx.x < valid) mv = mask ? mask[threadIdx.x] : 1.f;
    t.mask[threadIdx.x] = mv;
  }
  return __syncthreads_or(mv > 0.f) != 0;
}

// One online-softmax step over the staged K/V tile, for this warp's 16 rows.
// Caller: K, V and mask staged and published with __syncthreads().
template <int D, int DV>
__device__ __forceinline__ void attend_tile(Tile<D, DV>& t, float scale) {
  using L = Smem<D, DV>;
  constexpr int BK = L::BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  // ---- S = Q K^T for rows [r0, r0 + 16): one key column per lane ----
  {
    const int c = lane;
    float acc[16];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) acc[rr] = 0.f;
    const float* krow = t.k + c * L::LDK;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(t.q + (r0 + rr) * L::LDQ + d);
        acc[rr] = fmaf(qv.x, kv.x, acc[rr]);
        acc[rr] = fmaf(qv.y, kv.y, acc[rr]);
        acc[rr] = fmaf(qv.z, kv.z, acc[rr]);
        acc[rr] = fmaf(qv.w, kv.w, acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) t.s[(r0 + rr) * L::LDS + c] = acc[rr];
  }
  __syncwarp();

  // ---- online softmax update, one row at a time across the warp ----
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    float* srow = t.s + r * L::LDS;
    const float sv = t.mask[lane] > 0.f ? srow[lane] * scale : kNegInf;
    const float mx = warp_max(sv);
    const float m_old = t.m[r];
    const float m_new = fmaxf(m_old, mx);
    const float p = expf(sv - m_new) * t.mask[lane];
    srow[lane] = p;
    const float sum = warp_sum(p);
    __syncwarp();
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      t.alpha[r] = alpha;
      t.l[r] = t.l[r] * alpha + sum;
      t.m[r] = m_new;
    }
  }
  __syncwarp();

  // ---- O = alpha * O + P V ----
  for (int i = lane; i < 16 * DV; i += 32) {
    const int rr = i / DV;
    const int c = i % DV;
    t.o[(r0 + rr) * L::LDO + c] *= t.alpha[r0 + rr];
  }
  __syncwarp();
  for (int c = lane; c < DV; c += 32) {
    float acc[16];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) acc[rr] = t.o[(r0 + rr) * L::LDO + c];
    for (int kk = 0; kk < BK; ++kk) {
      const float vv = t.v[kk * L::LDV + c];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) acc[rr] = fmaf(t.s[(r0 + rr) * L::LDS + kk], vv, acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) t.o[(r0 + rr) * L::LDO + c] = acc[rr];
  }
  __syncwarp();
}

// out rows [q0, q0 + valid_q) = O / l, with l == 0 (every key masked) -> 0.
// Caller: __syncthreads() after the last tile.
template <int D, int DV>
__device__ __forceinline__ void write_out(Tile<D, DV>& t, float* out_rows, int valid_q) {
  using L = Smem<D, DV>;
  for (int i = threadIdx.x; i < kBQ * DV; i += kThreads) {
    const int r = i / DV;
    const int c = i % DV;
    if (r < valid_q) {
      const float l = t.l[r];
      out_rows[(size_t)r * DV + c] = t.o[r * L::LDO + c] / (l == 0.f ? 1.f : l);
    }
  }
}

// Calls fn.template operator()<D, DV>() for the (D, DV) pairs the flash
// forward is instantiated for, D and DV each in {64, 72, 96, 128, 256};
// anything else is cudaErrorInvalidValue.
template <int D, typename Fn>
cudaError_t dispatch_dv(int dv, Fn&& fn) {
  switch (dv) {
    case 64: return fn.template operator()<D, 64>();
    case 72: return fn.template operator()<D, 72>();
    case 96: return fn.template operator()<D, 96>();
    case 128: return fn.template operator()<D, 128>();
    case 256: return fn.template operator()<D, 256>();
    default: return cudaErrorInvalidValue;
  }
}
template <typename Fn>
cudaError_t dispatch_dims(int d, int dv, Fn&& fn) {
  switch (d) {
    case 64: return dispatch_dv<64>(dv, fn);
    case 72: return dispatch_dv<72>(dv, fn);
    case 96: return dispatch_dv<96>(dv, fn);
    case 128: return dispatch_dv<128>(dv, fn);
    case 256: return dispatch_dv<256>(dv, fn);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace medsam2
