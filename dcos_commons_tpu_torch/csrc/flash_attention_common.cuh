// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): bf16 tensor-core tiles through mma.sync
// m16n8k16 with fp32 accumulation, fragment loads from padded shared
// memory tiles, and the global -> shared tile copy.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16 x 16, row major): reg0 (row g, cols 2t, 2t+1), reg1 (row g+8,
//     cols 2t, 2t+1), reg2 (row g, cols 2t+8, 2t+9), reg3 (row g+8,
//     cols 2t+8, 2t+9);
//   B (16 x 8): reg0 (k 2t, 2t+1; col g), reg1 (k 2t+8, 2t+9; col g);
//   C (16 x 8, fp32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two neighbouring C tiles of 8 columns hold exactly the A fragment of
// one 16-wide k-chunk, so a score tile turns into the next product's A
// operand in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // rows per block tile: 16 per warp
constexpr int kPad = 8;    // bf16 row padding in shared memory (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegLse = -1e30f;  // lse of a row with no live key
constexpr float kDeadLse = -1e29f; // below this, a saved lse marks such a row

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment: rows r0..r0+15, cols c0..c0+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int r0, int c0, int g, int tq) {
  const bf16* p = t + (r0 + g) * ld + c0 + 2 * tq;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B[k][n] = t[n0 + n][k0 + k]: the tile stores one B
// column per row (K for q.k^T), so each register is one 32-bit load.
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* t, int ld, int n0,
                                            int k0, int g, int tq) {
  const bf16* p = t + (n0 + g) * ld + k0 + 2 * tq;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment with B[k][n] = t[k0 + k][n0 + n]: the tile stores one B row
// per row (V for p.v), so each register packs two rows.
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* t, int ld, int k0,
                                            int n0, int g, int tq) {
  const bf16* p = t + (k0 + 2 * tq) * ld + n0 + g;
  b0 = pack(p[0], p[ld]);
  b1 = pack(p[8 * ld], p[9 * ld]);
}

// A fragment of k-chunk kk from fp32 C tiles c[2kk], c[2kk+1] (rounded to
// bf16, as the TPU kernel casts p and ds to the input type).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Copy rows row0..row0+kTile-1 of head `head` of a [B, S, heads, D] bf16
// tensor into a shared tile with row stride D + kPad; rows past S are 0.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int row0, int seq, int heads,
                                          int head, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int ld = D + kPad;
  for (int c = tid; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < seq)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * seq + row) * heads + head) * D + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

template <int D>
constexpr int tile_bytes() {
  return kTile * (D + kPad) * static_cast<int>(sizeof(bf16));
}

// Raise a kernel's dynamic shared memory limit (above 48 KB) on the
// current device; a host call of about a microsecond, made per launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fa
