// The Hopper (sm_90a) main loop shared by the bf16 flash forward
// (flash_fwd_sm90_*.cu) and the bf16 storage-order kv-cached attention
// (kv_cached_attention.cu); the bf16 flash-backward dQ pass
// (flash_bwd_dq_sm90.cu) shares its layout, ring and producer loop; the
// dK/dV pass (flash_bwd_dkv_sm90.cu), the window attention
// (window_attention_sm90.cu) and the encoder products (encoder_gemm.cu,
// encoder_linear_sm90.cuh) use its PTX wrappers, ring and TMA maps. fp32
// keeps the FMA design of attention_tile.cuh: wgmma has no full-fp32 mode
// and the JAX package pins Precision.HIGHEST.
//
// Block: three warpgroups, 384 threads, one block per SM.
// - Warpgroup 0 is the producer. It reads the kv mask of each tile, skips a
//   tile whose keys are all masked (no loads, no products, as the Pallas
//   kernel's pl.when), and TMA-loads K and V tiles into a ring of kStages
//   shared-memory stages (one `full` and one `empty` mbarrier per stage). It
//   hands the consumers each stage's mask values and kv tile index in shared
//   memory, and a tile index of -1 when its range is done.
// - Warpgroups 1 and 2 are consumers, 64 query rows each (kBQ = 128 rows a
//   block). Per kv tile: S = Q K^T by wgmma with both operands in shared
//   memory; the online softmax in registers (each row lives in the 4 lanes of
//   a quad, so max and sum are two shuffles); P rounded to bf16 in registers
//   and O = alpha O + P V by wgmma with A from registers. m, l and O stay in
//   fp32 registers until the epilogue.
//
// Layout: a tile of R rows and head dim W is padded to a multiple of 16
// columns (72 -> 80) and cut into column chunks of 64, then one chunk of 32
// or 16 for the remainder. A 64-wide chunk is a [R][64] region in TMA's
// 128-byte swizzle, a 32-wide one in the 64-byte swizzle, a 16-wide one in
// the 32-byte swizzle; wgmma reads each through a descriptor of the same
// swizzle, K-major for Q and K, MN-major (transposed) for V. TMA zero-fills
// columns past the head dim and rows past the sequence; columns at or past
// Nk get mask 0 from the producer, so their logits are -1e30, not 0.
//
// Split-kv: a block covers the kv tiles [t0, t1) of its split. With one
// split it writes the output (and the LSE) itself; with more it writes the
// normalised partial O in fp32 and its LSE, and attention_merge combines
// them (flash_attention.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace medsam2 {
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;       // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// Column chunks of a head dim W, padded to a multiple of 16.
template <int W>
struct Cols {
  static constexpr int kPad = (W + 15) / 16 * 16;
  static constexpr int kFull = kPad / 64;  // chunks of 64 columns
  static constexpr int kRem = kPad % 64;   // one last chunk of 16 or 32 columns, or none
  static constexpr int kChunks = kFull + (kRem ? 1 : 0);
  static_assert(kRem == 0 || kRem == 16 || kRem == 32, "head dim not built");
  __host__ __device__ static constexpr int width(int c) { return c < kFull ? 64 : kRem; }
  // byte offset of chunk c inside a tile of `rows` rows
  __host__ __device__ static constexpr int offset(int c, int rows) { return c * rows * 128; }
};

// Shared-memory layout of one block (bytes from a 1024-aligned base).
// STAGING: extra bytes for the kv-cached producer's two staging tiles or the
// dQ pass's dO tile. ROWS: query rows a block, 64 per consumer warpgroup.
template <int D, int DV, int STAGING, int ROWS = kBQ>
struct Layout {
  static constexpr int kRows = ROWS;
  static constexpr int kConsumers = ROWS / 64;  // consumer warpgroups
  static_assert(ROWS == 64 || ROWS == 128, "one or two consumer warpgroups");
  static constexpr int kQBytes = ROWS * Cols<D>::kPad * 2;
  static constexpr int kKBytes = kBK * Cols<D>::kPad * 2;
  static constexpr int kVBytes = kBK * Cols<DV>::kPad * 2;
  static constexpr int kMisc = 2048;  // masks, tile indices, barriers
  static constexpr int kFixed = round1024(kQBytes) + STAGING + kMisc + 1024;  // + base alignment
  static constexpr int kStageBytes = round1024(kKBytes) + round1024(kVBytes);
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static_assert(kStages >= 2, "two kv stages do not fit");
  static constexpr int q_off = 0;
  static constexpr int k_off = round1024(kQBytes);
  static constexpr int v_off = k_off + kStages * round1024(kKBytes);
  static constexpr int stg_off = v_off + kStages * round1024(kVBytes);
  static constexpr int mask_off = stg_off + STAGING;              // kStages x kBK floats
  static constexpr int idx_off = mask_off + 4 * kBK * 4;           // kStages ints
  static constexpr int bar_off = idx_off + 64;                     // full, empty, q, staging
  static constexpr int bytes = mask_off + kMisc + 1024;
  static_assert(bytes <= kSmemLimit, "block does not fit the 227 KB a block may use");
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma, register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA, wgmma) accesses of the same buffers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// 3D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// 4D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// TMA store of one box from shared memory (3D map coordinates), in this
// thread's bulk async group; the tile may be reused once store_wait_read
// returns.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores have read their shared-memory source.
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// This thread's bulk stores are complete (written to global memory).
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most one committed group of this warpgroup is in flight.
__device__ __forceinline__ void wg_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Tie registers to this point of the program, so the compiler neither reads
// an accumulator before the wgmma that writes it has been waited for nor
// moves writes to it past the next wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle of a chunk `width` columns wide (64 ->
// 128-byte, 32 -> 64-byte, 16 -> 32-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int width, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  const uint64_t layout = width == 64 ? 1 : (width == 32 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory, both
// K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Narrower S = Q K^T products (N = 16, 32 or 48 keys), both operands K-major in
// shared memory: the window kernel's last key group.
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A K-major and B MN-major
// (transposed) in shared memory: the dK/dV pass's products with P^T and dS^T
// read from shared memory.
__device__ __forceinline__ void wgmma_ss_n64_tb(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}
// As wgmma_ss_n64_tb at N = 32 and 16: the dK/dV pass's narrow last column
// chunk (head dims 96 and 72).
__device__ __forceinline__ void wgmma_ss_n32_tb(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_ss_n16_tb(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b));
}

// D[64 x N] += A[64 x 16] * B[16 x N], A from registers (bf16 pairs), B from
// shared memory MN-major (transposed); N = 64, 32 or 16.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// As wgmma_rs_n64/n32/n16 with B K-major (not transposed) in shared memory:
// the fused MLP's fc2, whose B is the fc2 weight's [C][hidden chunk] rows.
__device__ __forceinline__ void wgmma_rs_kmajor_n64(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_rs_kmajor_n32(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_rs_kmajor_n16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// Byte offset of element (r, c) of a [rows][64] bf16 tile in the 128-byte
// swizzle that TMA writes and wgmma reads (16-byte unit c / 8 of row r at
// unit (c / 8) ^ (r % 8), the tile 1024-byte aligned): for threads that
// write such a tile themselves.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Block state in shared memory
// ---------------------------------------------------------------------------

template <class L>
struct Shared {
  unsigned char* base;
  __device__ explicit Shared(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                              ~uintptr_t(1023))) {}
  __device__ unsigned char* q() const { return base + L::q_off; }
  __device__ unsigned char* k(int s) const { return base + L::k_off + s * round1024(L::kKBytes); }
  __device__ unsigned char* v(int s) const { return base + L::v_off + s * round1024(L::kVBytes); }
  __device__ unsigned char* staging() const { return base + L::stg_off; }
  __device__ float* mask(int s) const {
    return reinterpret_cast<float*>(base + L::mask_off) + s * kBK;
  }
  __device__ int* tile(int s) const { return reinterpret_cast<int*>(base + L::idx_off) + s; }
  __device__ uint64_t* full(int s) const { return reinterpret_cast<uint64_t*>(base + L::bar_off) + s; }
  __device__ uint64_t* empty(int s) const {
    return reinterpret_cast<uint64_t*>(base + L::bar_off) + 4 + s;
  }
  __device__ uint64_t* qbar() const { return reinterpret_cast<uint64_t*>(base + L::bar_off) + 8; }
  __device__ uint64_t* stgbar() const {
    return reinterpret_cast<uint64_t*>(base + L::bar_off) + 9;
  }
  // thread 0, before the roles split; full_count arrivals complete a stage
  __device__ void init_barriers(int full_count) const {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), 128 * L::kConsumers);
    }
    mbar_init(qbar(), 1);
    mbar_init(stgbar(), 1);
    fence_barrier_init();
  }
};

// Producer's ring position.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int S>
  __device__ void advance() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// TMA-load rows [row0, row0 + rows) of a [.., n, W] bf16 tensor (3D map
// coordinates (column, row, z)) into a chunked tile: map64 serves the
// 64-wide chunks, map_rem the last narrower one.
template <int W>
__device__ __forceinline__ void tma_tile(unsigned char* dst, int rows, const CUtensorMap* map64,
                                         const CUtensorMap* map_rem, uint64_t* bar, int row0,
                                         int z) {
  using C = Cols<W>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
    tma_load_3d(dst + C::offset(c, rows), c < C::kFull ? map64 : map_rem, bar, 64 * c, row0, z);
}

// The producer warp's kv stream (`lane`: its lane) for slice bh: the 64-key
// tiles of the block's split, each with its mask values (keys at or past Nk
// get 0) and its index, a tile whose keys are all masked skipped; then a
// tile index of -1. Maps: the K and V maps k64, k_rem, v64, v_rem of
// [BH, Nk, D] and [BH, Nk, DV]; mask [BH / H, Nk] or null.
template <int D, int DV, class L, class Maps>
__device__ __forceinline__ void produce_kv(const Shared<L>& sh, const Maps& maps,
                                           const float* mask, int H, int Nk, int bh, int split,
                                           int tiles_per_split, int lane) {
  const float* mrow = mask != nullptr ? mask + (size_t)(bh / H) * Nk : nullptr;
  const int n_tiles = (Nk + kBK - 1) / kBK;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  Ring ring;
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    const int c0 = k0 + lane;
    const int c1 = c0 + 32;
    const float m0 = c0 < Nk ? (mrow != nullptr ? mrow[c0] : 1.f) : 0.f;
    const float m1 = c1 < Nk ? (mrow != nullptr ? mrow[c1] : 1.f) : 0.f;
    if (!__any_sync(0xffffffffu, m0 > 0.f || m1 > 0.f)) continue;  // every key masked
    const int s = ring.stage;
    mbar_wait(sh.empty(s), ring.phase ^ 1u);
    sh.mask(s)[lane] = m0;
    sh.mask(s)[lane + 32] = m1;
    if (lane == 0) *sh.tile(s) = t;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_expect_tx(sh.full(s), L::kKBytes + L::kVBytes);
      tma_tile<D>(sh.k(s), kBK, &maps.k64, &maps.k_rem, sh.full(s), k0, bh);
      tma_tile<DV>(sh.v(s), kBK, &maps.v64, &maps.v_rem, sh.full(s), k0, bh);
    }
    ring.advance<L::kStages>();
  }
  const int s = ring.stage;
  mbar_wait(sh.empty(s), ring.phase ^ 1u);
  if (lane == 0) {
    *sh.tile(s) = -1;  // range done
    mbar_arrive(sh.full(s));
  }
}

// Where a block writes its rows.
struct OutArgs {
  bf16* out;         // [rows_total, DV] (one split), else null
  float* lse;        // [rows_total] or null (one split)
  float* o_part;     // [splits, rows_total, DV] fp32 (several splits), else null
  float* lse_part;   // [splits, rows_total]
  int rows_total;    // BH * Nq
};

// ---------------------------------------------------------------------------
// Consumer warpgroup: the online-softmax main loop and the epilogue
// ---------------------------------------------------------------------------

template <int D, int DV, class L>
__device__ __forceinline__ void consume(const Shared<L>& sh, int wg, float scale_log2,
                                        const OutArgs& oa, int row_base, int valid_q, int split) {
  using CD = Cols<D>;
  using CV = Cols<DV>;
  constexpr int kO = CV::kPad / 2;  // accumulator registers per thread
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r_a = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: r_a, r_a + 8

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's partial sums

  const uint32_t q_addr = smem_u32(sh.q());
  mbar_wait(sh.qbar(), 0);

  Ring ring;
  for (;;) {
    const int s = ring.stage;
    mbar_wait(sh.full(s), ring.phase);
    if (*sh.tile(s) < 0) break;

    // ---- S = Q K^T ----
    float sc[32];
    const uint32_t k_addr = smem_u32(sh.k(s));
    wg_fence();
#pragma unroll
    for (int c = 0; c < CD::kChunks; ++c) {
      const int w = CD::width(c);
      const uint32_t pitch = 2 * w;
      const uint32_t qa = q_addr + CD::offset(c, L::kRows) + wg * 64 * pitch;
      const uint32_t ka = k_addr + CD::offset(c, kBK);
#pragma unroll
      for (int i = 0; i < w / 16; ++i)
        wgmma_ss_n64(sc, make_desc(qa + 32 * i, w, 16, 8 * pitch),
                     make_desc(ka + 32 * i, w, 16, 8 * pitch), (c | i) ? 1 : 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<32>(sc);

    // ---- online softmax, rows r_a (sc[4j], sc[4j+1]) and r_a + 8 (sc[4j+2], sc[4j+3]) ----
    const float* mk = sh.mask(s);
    float mx_a = kNegInf, mx_b = kNegInf;
    float mv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(mk + 8 * j + 2 * quad);
      mv[2 * j] = m2.x;
      mv[2 * j + 1] = m2.y;
      sc[4 * j] = m2.x > 0.f ? sc[4 * j] * scale_log2 : kNegInf;
      sc[4 * j + 1] = m2.y > 0.f ? sc[4 * j + 1] * scale_log2 : kNegInf;
      sc[4 * j + 2] = m2.x > 0.f ? sc[4 * j + 2] * scale_log2 : kNegInf;
      sc[4 * j + 3] = m2.y > 0.f ? sc[4 * j + 3] * scale_log2 : kNegInf;
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] - mn_a) * mv[2 * j];
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn_a) * mv[2 * j + 1];
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn_b) * mv[2 * j];
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn_b) * mv[2 * j + 1];
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
    // P in bf16, the A fragments of the four 16-key steps
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

    // ---- O += P V ----
    const uint32_t v_addr = smem_u32(sh.v(s));
    fence_regs<kO>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < CV::kChunks; ++c) {
        const int w = CV::width(c);
        const uint32_t pitch = 2 * w;
        const uint64_t desc = make_desc(v_addr + CV::offset(c, kBK) + kk * 16 * pitch, w, 16,
                                        8 * pitch);
        if (w == 64)
          wgmma_rs_n64(o + 32 * c, p[kk], desc);
        else if (w == 32)
          wgmma_rs_n32(o + 32 * c, p[kk], desc);
        else
          wgmma_rs_n16(o + 32 * c, p[kk], desc);
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs<kO>(o);
    mbar_arrive(sh.empty(s));
    ring.advance<L::kStages>();
  }

  // ---- epilogue: O / l (l == 0 -> 1), LSE = m + log(l) in natural-log units ----
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  const float lse_a = l_a == 0.f ? kNegInf : m_a * kLn2 + logf(l_a);
  const float lse_b = l_b == 0.f ? kNegInf : m_b * kLn2 + logf(l_b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + 8 * h;
    if (r >= valid_q) continue;
    const float inv = h ? inv_b : inv_a;
    const size_t row = (size_t)row_base + r;
    if (oa.out != nullptr) {
      bf16* dst = oa.out + row * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * quad) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (oa.lse != nullptr && quad == 0) oa.lse[row] = h ? lse_b : lse_a;
    } else {
      const size_t prow = (size_t)split * oa.rows_total + row;
      float* dst = oa.o_part + prow * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * quad) =
            make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (quad == 0) oa.lse_part[prow] = h ? lse_b : lse_a;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: TMA descriptors, encoded per call through the driver entry point
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit on the current device the
// first time it launches there; `done` is the calling launcher's own record
// (one bit per device ordinal). Later launches, CUDA-graph captures
// included, make no call.
inline cudaError_t allow_smem(const void* kern, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3D map over a contiguous bf16 tensor [d2][d1][d0] with box
// {box0, box1, box2}, swizzled as a chunk box0 columns wide. Out-of-range
// elements read as zero. Returns false when the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t box0, uint32_t box1, uint32_t box2 = 1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1 > 0 ? d1 : 1, d2 > 0 ? d2 : 1};
  const cuuint64_t strides[2] = {d0 * 2, d0 * dims[1] * 2};
  const cuuint32_t box[3] = {box0, box1, box2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = box0 == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box0 == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4D map over a bf16 tensor of dims {d0, d1, d2, d3} (d0 contiguous) with
// byte strides {s1, s2, s3} of dims 1-3 (multiples of 16) and box {box0, box1,
// box2, box3}, swizzled as a chunk box0 columns wide. Elements past a dim
// read as zero, so a box wider than d0 zero-fills the columns past it.
inline bool make_map4(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                      const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = box[0] == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box[0] == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, bx, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The two maps (64-wide chunks, and the narrower last chunk if any) of a
// [d2][d1][W] tensor read in boxes of `rows` rows.
template <int W>
inline bool make_maps(CUtensorMap* map64, CUtensorMap* map_rem, const void* base, uint64_t d1,
                      uint64_t d2, uint32_t rows) {
  using C = Cols<W>;
  if (!make_map(map64, base, W, d1, d2, 64, rows)) return false;
  return C::kRem == 0 || make_map(map_rem, base, W, d1, d2, C::kRem, rows);
}

}  // namespace hopper
}  // namespace medsam2
