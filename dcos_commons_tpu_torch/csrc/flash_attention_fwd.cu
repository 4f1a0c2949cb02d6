// Flash-attention forward for Hopper (sm_90a): causal or full GQA
// attention with online softmax, saving O (bf16) and the per-row
// logsumexp (fp32) for the backward.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// dcos_commons_tpu/ops/flash_attention.py:62 (reached through
// `_flash_forward`). Same semantics, not the same blocking: q [B, Sq, H, D]
// against k/v [B, Sk, KV, D], query head h reads KV head h / (H / KV);
// query row i sits at position q_offset + i and, when causal, sees keys
// j <= q_offset + i. A row that sees no key gets output 0 and lse -1e30.
// lse is [B, H, Sq], not the TPU's 8 copied sublanes. Any Sq and Sk: the
// ragged tail is masked here, not refused. P is rounded to bf16 before
// P V, as the TPU kernel casts p to v's dtype; sums stay fp32.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16). The Llama-400m train
// step (B=16, S=511, H=12, KV=6, D=128, causal) moves ~75 MB of
// q/k/v/o/lse (0.0226 ms) for ~13 GFLOP of causal products (0.013 ms):
// bound by bytes, with the tensor cores close behind. Llama-3-8B heads
// (B=2, S=2048, H=32, KV=8, D=128, causal; slot prefill) do ~69 GFLOP
// (0.0695 ms) against ~84 MB (0.0252 ms): bound by operations. Either
// way the products must run on the tensor cores at their full rate and
// no copy may stall them.
//
// Design (tiles: 128 q rows x 128 keys at D = 64 and 128, with a 3-stage
// K/V ring; 128 x 64 with 2 stages at D = 256, where the 64 x 256 fp32 O
// accumulator alone takes 128 registers a thread). A persistent grid, one
// block per SM, deals out work tiles (one 128-row q tile of one head and
// batch) longest first: the reversed q-tile index is the slowest, so the
// long causal rows do not finish in the tail, and the rounds alternate
// direction, so each block collects about the same work. Three
// warpgroups a block:
// - a producer warpgroup, trimmed to 32 registers a thread (setmaxnreg),
//   whose one thread issues TMA copies: each tile's Q once, then K and V
//   into the ring, ordered by mbarriers: "full" ones that the copies
//   complete, "empty" ones that the consumers arrive on. K and V have
//   their own, so a K tile goes back as soon as S = Q K^T has read it,
//   and Q goes back after the tile's last S: the next tile's Q and keys
//   load under this tile's last P V and its epilogue;
// - two consumer warpgroups, grown to 232 registers, each owning 64 q
//   rows. S = Q K^T is wgmma m64nNk16 with both operands in shared memory
//   (K is K-major, B's natural layout); O += P V is wgmma with P from
//   registers (S's fp32 fragment packed to bf16 is wgmma's register-A
//   fragment) and V read MN-major through the transpose-B bit. Within a
//   warpgroup, S of tile i runs beside P V of tile i - 1, and the softmax
//   of tile i overlaps that P V; a V tile goes back only after
//   wgmma.wait_group shows its P V complete. The two warpgroups take
//   turns to issue their products (named barriers), so one's softmax
//   runs while the other's products keep the tensor cores busy. The
//   online softmax stays in registers in the accumulator layout: base 2,
//   the scale folded into the exponent's FFMA, one MUFU ex2 per score.
// TMA tensor maps are rank 4, (D, heads, S, B), so a tile never reaches
// into the next sequence and rows past S arrive as zeros; 64-column boxes
// (128 bytes) with 128-byte swizzle, which the wgmma descriptors name
// too. Causal: tiles above the diagonal are never loaded, and only a tile
// that straddles the diagonal or the Sk tail computes a mask. O and lse
// go from registers to global memory.
//
// Times (chip_smoke.py phase 2 and tools/torch_bench_flash_fwd.py, which
// also times the steps that led here) are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegLse = -1e30f;   // lse of a row with no live key
constexpr int kConsumers = 2;       // consumer warpgroups, 64 q rows each
constexpr int kBlockM = 64 * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;        // bf16 columns per TMA box: 128 bytes
constexpr int kBoxBytesPerRow = 128;
constexpr int kProducerRegs = 32, kConsumerRegs = 232;

template <int D>
struct Tile {
  static constexpr int kBlockN = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kChunks = D / kBoxCols;   // 64-column boxes per row
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;   // one K or one V tile
  // Q, then K and V per stage; 1024-byte aligned for the 128-byte swizzle
  static constexpr int kSmemTiles = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kSmemTiles + (4 * kStages + 2) * 8 + 1024;
};

// ----------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: box (c0, c1, c2, c3) of a rank-4 map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most `Pending` committed wgmma groups are still running
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma that reads and writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// 2^x in one MUFU instruction; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x 64) {+}= A (64 x 16, smem) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31} "
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (64 x 128) {+}= A (64 x 16, smem) * B (128 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63} "
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31} "
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63} "
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256) += A (64 x 16, registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127} "
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- kernel

// A work tile: one 128-row q tile of one (head, batch). Tiles are ordered
// longest first (the q tile index, reversed, is the slowest) and dealt to
// the persistent blocks in rounds of one tile each, every other round in
// reverse block order, so that no block collects the longest tile of
// every round.
struct Work {
  int h, b, q0, n_kt;
};

template <int D>
__device__ __forceinline__ Work work_tile(int t, int q_tiles, int heads,
                                          int batch, int seq_q, int seq_k,
                                          int causal, int q_offset) {
  Work w;
  const int hb = heads * batch;
  w.q0 = (q_tiles - 1 - t / hb) * kBlockM;
  w.b = (t % hb) / heads;
  w.h = t % heads;
  // keys past k_end are dead for every row of the tile
  int k_end = seq_k;
  if (causal) k_end = min(seq_k, q_offset + min(w.q0 + kBlockM, seq_q));
  w.n_kt = k_end > 0 ? (k_end + Tile<D>::kBlockN - 1) / Tile<D>::kBlockN : 0;
  return w;
}

// grid min(tiles, SMs), block kThreads, dynamic smem Tile<D>::kSmem.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
          float* __restrict__ lse, int batch, int seq_q, int seq_k, int heads,
          int kv_heads, float scale_log2, int causal, int q_offset) {
  using T = Tile<D>;
  constexpr int kN = T::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: the swizzle pattern follows address bits
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_kv = s_q + T::kQBytes;          // stage s: K, then V
  const uint32_t bars = s_kv + 2 * T::kStages * T::kKVBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + T::kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 2 * T::kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 + 3 * T::kStages + s); };
  auto s_k = [&](int s) { return s_kv + 2u * s * T::kKVBytes; };
  auto s_v = [&](int s) { return s_k(s) + T::kKVBytes; };
  // ring position p: stage p % kStages, in its (p / kStages)-th round
  auto stage = [](int p) { return p % T::kStages; };
  auto round_parity = [](int p) {
    return static_cast<uint32_t>(p / T::kStages) & 1;
  };

  const int q_tiles = (seq_q + kBlockM - 1) / kBlockM;
  const int n_tiles = q_tiles * heads * batch;
  const int group = heads / kv_heads;
  // this block's tile of round r (n_tiles or more: none this round)
  auto dealt = [&](int r) {
    const int slot = r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return r * static_cast<int>(gridDim.x) + slot;
  };
  const int rounds = (n_tiles + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);      // lane 0 of each consumer warp
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kConsumers);
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      int pos = 0, loaded = 0;             // ring position, Q tiles loaded
      for (int round = 0; round < rounds; ++round) {
        const int t = dealt(round);
        if (t >= n_tiles) continue;
        const Work w = work_tile<D>(t, q_tiles, heads, batch, seq_q, seq_k,
                                    causal, q_offset);
        if (w.n_kt == 0) continue;
        const int kh = w.h / group;
        // the consumers hand Q back after their last S = Q K^T
        if (loaded > 0) mbar_wait(q_empty, (loaded - 1) & 1);
        mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(s_q + c * kBlockM * kBoxBytesPerRow, &tm_q, q_full,
                   c * kBoxCols, w.h, w.q0, w.b);
        ++loaded;
        for (int i = 0; i < w.n_kt; ++i, ++pos) {
          const int s = stage(pos);
          const uint32_t released = round_parity(pos) ^ 1;
          if (pos >= T::kStages) mbar_wait(k_empty(s), released);
          mbar_expect_tx(k_full(s), T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kChunks; ++c)
            tma_load(s_k(s) + c * kN * kBoxBytesPerRow, &tm_k, k_full(s),
                     c * kBoxCols, kh, i * kN, w.b);
          if (pos >= T::kStages) mbar_wait(v_empty(s), released);
          mbar_expect_tx(v_full(s), T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kChunks; ++c)
            tma_load(s_v(s) + c * kN * kBoxBytesPerRow, &tm_v, v_full(s),
                     c * kBoxCols, kh, i * kN, w.b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // this warpgroup's 64 Q rows inside each 128-row box
    const uint32_t s_qw = s_q + wg * 64 * kBoxBytesPerRow;

    float o[D / 8][4];
    float m[2], l[2];
    float sc[kN / 8][4];      // S of the newest tile, then its P in fp32
    uint32_t p[kN / 16][4];   // P of the tile P V runs on, bf16 A fragments
    int pos = 0, loaded = 0;  // ring position, Q tiles consumed
    int row0 = 0, rows[2] = {0, 0};

    // S = Q K^T of ring position q into sc, issued and committed
    auto issue_qk = [&](int q) {
      const uint32_t k_tile = s_k(stage(q));
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
        const uint64_t da = sw128_desc(
            s_qw + (kk / 4) * kBlockM * kBoxBytesPerRow + off, 16, 1024);
        const uint64_t db = sw128_desc(
            k_tile + (kk / 4) * kN * kBoxBytesPerRow + off, 16, 1024);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of ring position q, issued and committed
    auto issue_pv = [&](int q) {
      const uint32_t v_tile = s_v(stage(q));
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        // V is [keys, D]: MN-major B; 16 keys = 2 rows of 8-row atoms
        const uint64_t db = sw128_desc(v_tile + kk * 16 * kBoxBytesPerRow,
                                       kN * kBoxBytesPerRow, 1024);
        wgmma_rs(o, p[kk], db);
      }
      wgmma_commit();
    };
    // online softmax of k tile i's scores in sc: sc becomes P (fp32), m
    // and the partial row sums l advance; returns O's rescale in alpha.
    // A positive scale folds into the exponent's FFMA, so the max runs on
    // raw scores.
    auto softmax = [&](int i, float (&alpha)[2], auto fold) {
      constexpr bool kFold = decltype(fold)::value;
      const int k0 = i * kN;
      // masks only where a key lies past the Sk tail or past some row's
      // diagonal; interior tiles take none
      const bool edge =
          k0 + kN > seq_k || (causal && k0 + kN - 1 > q_offset + row0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = kFold ? sc[j][e] : sc[j][e] * scale_log2;
          if (edge) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const bool live = col < seq_k &&
                              (!causal || col <= q_offset + rows[e >> 1]);
            x = live ? x : -INFINITY;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], kFold ? mx[r] * scale_log2 : mx[r]);
        // a row with no live key so far keeps max -inf: subtract 0
        // instead, so every exponential below is exp2(-inf) = 0, not NaN
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = ex2(m[r] - base[r]);
        m[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = kFold ? ex2(fmaf(sc[j][e], scale_log2, -base[e >> 1]))
                           : ex2(sc[j][e] - base[e >> 1]);
          rs[e >> 1] += sc[j][e];
        }
      // partial row sums: the quad's four lanes add up at the end
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
    };
    auto softmax_any = [&](int i, float (&alpha)[2]) {
      if (scale_log2 > 0.f)
        softmax(i, alpha, std::true_type{});
      else
        softmax(i, alpha, std::false_type{});
    };
    // P (rounded to bf16, as the TPU kernel casts p to v's dtype) into the
    // register-A fragments of P V
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        p[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        p[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        p[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
    };
    // hand a smem tile back to the producer once the wgmma that reads it
    // has completed
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // the two warpgroups take turns to issue their products (named
    // barriers 3 and 4), so that one's softmax runs while the other's
    // wgmma keep the tensor cores busy
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
    };
    if (wg == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

    for (int round = 0; round < rounds; ++round) {
      const int tile = dealt(round);
      if (tile >= n_tiles) continue;
      const Work w = work_tile<D>(tile, q_tiles, heads, batch, seq_q, seq_k,
                                  causal, q_offset);
      row0 = w.q0 + wg * 64;                     // this warpgroup's rows
      rows[0] = row0 + warp * 16 + g;
      rows[1] = rows[0] + 8;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      if (w.n_kt > 0) {
        float alpha[2];
        const int last = w.n_kt - 1;
        mbar_wait(q_full, loaded & 1);
        ++loaded;
        mbar_wait(k_full(stage(pos)), round_parity(pos));
        my_turn();
        issue_qk(pos);
        pass_turn();
        wgmma_wait<0>();
        fence_regs(sc);
        release(k_empty(stage(pos)));
        if (last == 0) release(q_empty);
        softmax_any(0, alpha);          // O is 0: nothing to rescale
        pack_p();
        // S of k tile i runs on the tensor cores beside P V of tile i - 1;
        // the softmax of tile i overlaps P V of tile i - 1
        for (int i = 1; i <= last; ++i) {
          const int cur = pos + i, prev = cur - 1;
          mbar_wait(k_full(stage(cur)), round_parity(cur));
          mbar_wait(v_full(stage(prev)), round_parity(prev));
          my_turn();
          issue_qk(cur);
          issue_pv(prev);
          pass_turn();
          wgmma_wait<1>();            // S of tile i is in
          fence_regs(sc);
          release(k_empty(stage(cur)));
          if (i == last) release(q_empty);   // Q's last reader is done
          softmax_any(i, alpha);
          wgmma_wait<0>();            // P V of tile i - 1 is done
          fence_regs(o);
          release(v_empty(stage(prev)));
          pack_p();
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
          }
        }
        const int end = pos + last;
        mbar_wait(v_full(stage(end)), round_parity(end));
        my_turn();
        issue_pv(end);
        pass_turn();
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty(stage(end)));
        pos += w.n_kt;
      }

      // ------------------------------------------------ epilogue
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = rows[r];
        if (row >= seq_q) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
        bf16* dst = out + ((static_cast<size_t>(w.b) * seq_q + row) * heads +
                           w.h) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
        if (t == 0)
          lse[(static_cast<size_t>(w.b) * heads + w.h) * seq_q + row] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNegLse;
      }
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// entry point, so the library links the runtime only.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Rank-4 map of a contiguous [batch, seq, heads, D] bf16 tensor, boxes of
// 64 columns x `rows` rows of one head, 128-byte swizzle; reads past seq
// fill zeros, writes past it are dropped.
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(d) * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's dynamic shared-memory limit once per device.
template <int D>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<D>::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// Streaming multiprocessors of the current device, asked once per device.
int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = counts[dev & 63].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    counts[dev & 63].store(n);
  }
  return n;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq_q, int seq_k, int heads,
                   int kv_heads, float sm_scale, int causal, int q_offset,
                   cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>((seq_q + kBlockM - 1) / kBlockM) * heads * batch;
  const int sms = sm_count();
  if (tiles > 0x7fffffff || sms == 0) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, D, heads, seq_q, batch, kBlockM) ||
      !make_map(&tm_k, k, D, kv_heads, seq_k, batch, Tile<D>::kBlockN) ||
      !make_map(&tm_v, v, D, kv_heads, seq_k, batch, Tile<D>::kBlockN))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  flash_fwd<D><<<grid, kThreads, Tile<D>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse),
      batch, seq_q, seq_k, heads, kv_heads, sm_scale * kLog2e, causal,
      q_offset);
  return cudaGetLastError();
}

}  // namespace

// Launches the forward on `stream`; returns cudaGetLastError() (0 on
// success). The caller validates shapes, dtypes, contiguity and 16-byte
// alignment and allocates o [B, Sq, H, D] bf16 and lse [B, H, Sq] fp32.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int batch, int seq_q, int seq_k,
                                          int heads, int kv_heads,
                                          int head_dim, float sm_scale,
                                          int causal, int q_offset,
                                          void* stream_handle) {
  if (batch < 1 || seq_q < 1 || seq_k < 1 || kv_heads < 1 ||
      heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, o, lse, batch, seq_q, seq_k, heads, kv_heads,
                        sm_scale, causal, q_offset, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, seq_q, seq_k, heads,
                         kv_heads, sm_scale, causal, q_offset, stream);
    case 256:
      return launch<256>(q, k, v, o, lse, batch, seq_q, seq_k, heads,
                         kv_heads, sm_scale, causal, q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
