// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// recomputation scheme in two kernels, dK/dV and dQ.
//
// Replaces the Pallas TPU kernels `_bwd_dkdv_kernel` and `_bwd_dq_kernel`
// of dcos_commons_tpu/ops/flash_attention.py:214 and :256 (reached through
// `_flash_backward`). Both recompute P = exp(q.k * scale - lse) tile by
// tile from the forward's saved lse [B, H, Sq] and take
// delta = rowsum(dO * O) [B, H, Sq] (fp32, computed by the caller);
// dS = P * (dP - delta) * scale with dP = dO.v. P and dS are rounded to
// bf16 before their products, as the TPU kernel casts them; sums stay
// fp32. Causal and ragged masks, q_offset and the dead-row rule are the
// forward's: a row whose saved lse is -1e30 gets P = 0 (never
// exp(s + 1e30)) and so dq = 0. Any scale, Sq, Sk; D in {64, 128, 256}.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16). At the Llama-400m train
// step (B=16, S=511, H=12, KV=6, D=128, causal) each kernel moves ~101 MB
// (0.030 ms) for 20-26 GFLOP of causal products (0.020-0.026 ms): bound
// by bytes, the tensor cores close behind. At Llama-3-8B heads (B=2,
// S=2048, H=32, KV=8) they do 103 (dQ) and 137 (dK/dV) GFLOP against
// ~50 MB: bound by operations. Either way every product must run on the
// tensor cores at full rate and no copy may stall them.
//
// Design: both kernels have the forward's shape (flash_attention_fwd.cu):
// a persistent grid, one block per SM, dealing work tiles longest first in
// rounds whose block order alternates; three warpgroups a block, a
// producer trimmed to 32 registers (setmaxnreg) that feeds shared memory
// by TMA (rank-4 maps, 64-column boxes, 128-byte swizzle) ordered by
// "full" and "empty" mbarriers, and two consumer warpgroups grown to 232
// registers that run every product on wgmma. No product goes through
// shared memory: S / S^T and dP / dP^T accumulate in registers, and their
// fp32 fragments packed to bf16 are the register-A operand of the next
// product, whose B operand is a TMA tile read MN-major through the
// transpose-B bit, the tile the first product read K-major.
//
// * dQ (`flash_bwd_dq`): a work tile is one 128-row q tile of one (head,
//   batch), 64 rows a consumer warpgroup; tiles are dealt with the
//   reversed q-tile index slowest (causal: the longest rows first). The
//   producer loads the tile's Q and dO once, then K and V into a ring
//   (64 keys a stage; 32 at D=256), K and V released apart. Per stage:
//   S = Q K^T and dP = dO V^T (A and B K-major in shared memory), then
//   dS in registers, then dQ += dS K (K MN-major). dS of stage i is
//   computed while dQ += dS K of stage i - 1 runs; V goes back when dP is
//   in, K when its dQ product is done, Q and dO after the tile's last S.
//   dQ (64 x D fp32 a warpgroup) stays in registers until the bf16
//   epilogue. lse and delta of a thread's two rows come from global
//   memory once per tile.
// * dK/dV (`flash_bwd_dkdv`): the transposed loop. A work tile is one
//   128-key tile of one (KV head, batch), 64 keys a consumer warpgroup;
//   K and V are loaded once, then a ring of (Q, dO) stages of 64 query
//   rows (32 at D=256) walks the group's query heads times the live q
//   tiles (causal: none entirely above the diagonal). Per stage:
//   S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in registers, then
//   dV += P^T dO and dK += dS^T Q (dO and Q MN-major). dK and dV stay in
//   registers over the whole walk, which sums the GQA group inside the
//   block: every output element is written by exactly one block, with no
//   atomics, so results are the same from run to run. lse and delta
//   [B, H, Sq] cannot come by TMA (a row of Sq=511 floats is not 16-byte
//   aligned): the producer warp's 32 lanes copy a stage's values of each
//   into shared memory (lse pre-scaled by log2 e, +inf on a dead or
//   absent row, so P = ex2(s scale log2e - lse) is 0 there) and arrive on
//   the stage's "full" barrier beside the TMA bytes. Key tiles are dealt
//   in ascending order (causal: key tile 0 sees every q tile, the last
//   the fewest); at the train shape 384 tiles of 16, 12, 8 and 4 stages
//   over 132 SMs, and the alternating block order gives each block 24-32
//   stages against a mean of 29. Within a warpgroup a stage's products
//   run in turn; the two consumer warpgroups share each stage, and while
//   one computes P and dS on the CUDA cores the other's products keep
//   the tensor cores busy. (Overlapping stage i's S^T with stage i - 1's
//   dV and dK inside a warpgroup needs 224 accumulator registers a
//   thread, spills at D=128 and measured slower, as did 32-row stages
//   that fit it: PERF.md.)
//
// Registers (fp32 accumulators a consumer thread, D=128): dQ kernel dQ 64
// + S 32 + dP 32; dK/dV kernel dK 64 + dV 64 + S^T 32 + dP^T 32. At D=256
// dK and dV alone would take 256, over the 255 limit, so a D=256 key tile
// is two work tiles, one computing dV (S^T, dV += P^T dO) and one dK
// (S^T, dP^T, dK += dS^T Q): S^T is computed twice, and each output is
// still written by one block. Shared memory sets the rest at D=256: dQ
// stages of 32 keys and dK/dV stages of 32 q rows, 2 of each; the rings
// hold 4 (dQ) and 4 / 3 (dK/dV) stages at D = 64 / 128.
//
// Masks are computed only on tiles that straddle the causal diagonal or
// (dQ) the Sk tail; key rows past Sk in dK/dV are never stored, and q
// rows past Sq arrive as zeros with lse +inf. Times are in PERF.md
// (chip_smoke.py phase 2, tools/torch_bench_flash.py --kernel bwd).

#include "flash_attention_hopper.cuh"

namespace {

using namespace fa_hopper;

constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 32, kConsumerRegs = 232;
constexpr float kDeadLse = -1e29f;  // below this, a saved lse marks a row
                                    // with no live key

template <int D>
struct DqTile {
  static constexpr int kBlockM = 64 * kConsumers;   // q rows a work tile
  static constexpr int kBlockN = D == 256 ? 32 : 64;  // keys a stage
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kChunks = D / kBoxCols;     // 64-column boxes a row
  static constexpr int kQBytes = kBlockM * D * 2;  // one Q or one dO tile
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K or one V tile
  // Q, dO, then K and V per stage; 1024-byte aligned for the swizzle
  static constexpr int kSmemTiles = 2 * kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kSmemTiles + (4 * kStages + 2) * 8 + 1024;
};

template <int D>
struct DkvTile {
  static constexpr int kBlockN = 64 * kConsumers;  // keys a work tile
  static constexpr int kBlockM = D == 256 ? 32 : 64;  // q rows a stage
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr bool kSplit = D == 256;         // dV and dK apart
  static constexpr int kParts = kSplit ? 2 : 1;
  static constexpr int kChunks = D / kBoxCols;
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr int kQBytes = kBlockM * D * 2;   // one Q or one dO tile
  static constexpr int kRowBytes = kBlockM * 4;     // a stage's lse or delta
  // K, V, then Q and dO per stage, then lse and delta per stage
  static constexpr int kSmemTiles = 2 * kKVBytes + 2 * kStages * kQBytes;
  static constexpr int kSmem =
      kSmemTiles + 2 * kStages * kRowBytes + (2 * kStages + 2) * 8 + 1024;
};

// this block's work tile of round r (n_tiles or more: none this round);
// every other round deals in reverse block order, so that no block
// collects the longest tile of every round
__device__ __forceinline__ int dealt(int r) {
  const int slot = r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * static_cast<int>(gridDim.x) + slot;
}

// hand a shared-memory tile back to the producer (lane 0 of each
// consumer warp arrives) once the wgmma that read it has completed
__device__ __forceinline__ void release(uint32_t bar) {
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// ------------------------------------------------------------------- dQ

struct DqWork {
  int h, b, q0, n_kt;
};

template <int D>
__device__ __forceinline__ DqWork dq_work(int t, int q_tiles, int heads,
                                          int batch, int seq_q, int seq_k,
                                          int causal, int q_offset) {
  using T = DqTile<D>;
  DqWork w;
  const int hb = heads * batch;
  w.q0 = (q_tiles - 1 - t / hb) * T::kBlockM;
  w.b = (t % hb) / heads;
  w.h = t % heads;
  // keys past k_end are dead for every row of the tile
  int k_end = seq_k;
  if (causal) k_end = min(seq_k, q_offset + min(w.q0 + T::kBlockM, seq_q));
  w.n_kt = k_end > 0 ? (k_end + T::kBlockN - 1) / T::kBlockN : 0;
  return w;
}

// grid min(tiles, SMs), block kThreads, dynamic smem DqTile<D>::kSmem.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int batch, int seq_q, int seq_k,
             int heads, int kv_heads, float sm_scale, int causal,
             int q_offset) {
  using T = DqTile<D>;
  constexpr int kM = T::kBlockM, kN = T::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = base + T::kQBytes;
  const uint32_t s_kv = s_do + T::kQBytes;       // stage s: K, then V
  const uint32_t bars = s_kv + 2 * T::kStages * T::kKVBytes;
  const uint32_t qdo_full = bars, qdo_empty = bars + 8;
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

  const int q_tiles = (seq_q + kM - 1) / kM;
  const int n_tiles = q_tiles * heads * batch;
  const int group = heads / kv_heads;
  const int rounds = (n_tiles + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    mbar_init(qdo_empty, 4 * kConsumers);     // lane 0 of each consumer warp
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
        const DqWork w = dq_work<D>(t, q_tiles, heads, batch, seq_q, seq_k,
                                    causal, q_offset);
        if (w.n_kt == 0) continue;
        const int kh = w.h / group;
        // the consumers hand Q and dO back after their last S and dP
        if (loaded > 0) mbar_wait(qdo_empty, (loaded - 1) & 1);
        mbar_expect_tx(qdo_full, 2 * T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(s_q + c * kM * kBoxBytesPerRow, &tm_q, qdo_full,
                   c * kBoxCols, w.h, w.q0, w.b);
          tma_load(s_do + c * kM * kBoxBytesPerRow, &tm_do, qdo_full,
                   c * kBoxCols, w.h, w.q0, w.b);
        }
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
    // this warpgroup's 64 rows inside each 128-row box of Q and dO
    const uint32_t s_qw = s_q + wg * 64 * kBoxBytesPerRow;
    const uint32_t s_dow = s_do + wg * 64 * kBoxBytesPerRow;
    const float scale_log2 = sm_scale * kLog2e;

    float acc[D / 8][4];      // dQ of this warpgroup's 64 rows
    float sc[kN / 8][4];      // S of the newest stage, then its dS
    float dp[kN / 8][4];      // dP of the newest stage
    uint32_t ds[kN / 16][4];  // dS (bf16 A fragments) of the stage dQ runs on
    int pos = 0, loaded = 0;  // ring position, Q tiles consumed

    // S = Q K^T and dP = dO V^T of ring position q, one commit group
    auto issue_sdp = [&](int q) {
      const uint32_t k_tile = s_k(stage(q)), v_tile = s_v(stage(q));
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss(sc,
                 sw128_desc(s_qw + (kk / 4) * kM * kBoxBytesPerRow + off, 16,
                            1024),
                 sw128_desc(k_tile + (kk / 4) * kN * kBoxBytesPerRow + off,
                            16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(dp,
                 sw128_desc(s_dow + (kk / 4) * kM * kBoxBytesPerRow + off, 16,
                            1024),
                 sw128_desc(v_tile + (kk / 4) * kN * kBoxBytesPerRow + off,
                            16, 1024),
                 kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K of ring position q (K read MN-major), one commit group
    auto issue_dq = [&](int q) {
      const uint32_t k_tile = s_k(stage(q));
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs(acc, ds[kk],
                 sw128_desc(k_tile + kk * 16 * kBoxBytesPerRow,
                            kN * kBoxBytesPerRow, 1024));
      wgmma_commit();
    };

    for (int round = 0; round < rounds; ++round) {
      const int tile = dealt(round);
      if (tile >= n_tiles) continue;
      const DqWork w = dq_work<D>(tile, q_tiles, heads, batch, seq_q, seq_k,
                                  causal, q_offset);
      const int row0 = w.q0 + wg * 64;           // this warpgroup's rows
      int rows[2];
      rows[0] = row0 + warp * 16 + g;
      rows[1] = rows[0] + 8;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      if (w.n_kt > 0) {
        // lse (times log2 e; +inf on a dead or absent row, so P = 0
        // there) and delta of this thread's two rows
        float lse2[2], dlt[2];
        const size_t stat = (static_cast<size_t>(w.b) * heads + w.h) * seq_q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool in = rows[r] < seq_q;
          const float l = in ? lse[stat + rows[r]] : kNegLse;
          lse2[r] = l > kDeadLse ? l * kLog2e : INFINITY;
          dlt[r] = in ? delta[stat + rows[r]] : 0.f;
        }
        // dS of key tile i into sc, from S in sc and dP in dp; masks only
        // where a key lies past the Sk tail or past some row's diagonal
        auto recompute = [&](int i) {
          const int k0 = i * kN;
          const bool edge =
              k0 + kN > seq_k || (causal && k0 + kN - 1 > q_offset + row0);
#pragma unroll
          for (int j = 0; j < kN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              float p = ex2(fmaf(sc[j][e], scale_log2, -lse2[r]));
              if (edge) {
                const int col = k0 + j * 8 + 2 * t + (e & 1);
                const bool live =
                    col < seq_k && (!causal || col <= q_offset + rows[r]);
                p = live ? p : 0.f;
              }
              sc[j][e] = p * (dp[j][e] - dlt[r]) * sm_scale;
            }
        };
        // dS rounded to bf16, as the TPU kernel casts it, into the
        // register-A fragments of dQ += dS K
        auto pack_ds = [&]() {
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            ds[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
            ds[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
            ds[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
            ds[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
          }
        };

        const int last = w.n_kt - 1;
        mbar_wait(qdo_full, loaded & 1);
        ++loaded;
        // S and dP of key tile i run on the tensor cores beside dQ += dS K
        // of tile i - 1; the recompute of tile i overlaps that product
        for (int i = 0; i <= last; ++i) {
          const int cur = pos + i;
          mbar_wait(k_full(stage(cur)), round_parity(cur));
          mbar_wait(v_full(stage(cur)), round_parity(cur));
          issue_sdp(cur);
          if (i > 0) {
            issue_dq(cur - 1);
            wgmma_wait<1>();            // S and dP of tile i are in
          } else {
            wgmma_wait<0>();
          }
          fence_regs(sc);
          fence_regs(dp);
          release(v_empty(stage(cur)));
          if (i == last) release(qdo_empty);   // Q and dO's last readers
          recompute(i);
          if (i > 0) {
            wgmma_wait<0>();            // dQ += dS K of tile i - 1 is done
            fence_regs(acc);
            release(k_empty(stage(cur - 1)));
          }
          pack_ds();
        }
        const int end = pos + last;
        issue_dq(end);
        wgmma_wait<0>();
        fence_regs(acc);
        release(k_empty(stage(end)));
        pos += w.n_kt;
      }

      // ------------------------------------------------ epilogue
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rows[r];
        if (row >= seq_q) continue;
        bf16* dst = dq + ((static_cast<size_t>(w.b) * seq_q + row) * heads +
                          w.h) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dK/dV

// A work tile: one 128-key tile of one (KV head, batch) and, at D=256,
// one of its two parts (0: dV, 1: dK; 2: both). Its stages walk the
// group's query heads (slowest) times the live q tiles.
struct DkvWork {
  int kh, b, k0, part, qt_begin, n_qt, n_st;
};

template <int D>
__device__ __forceinline__ DkvWork dkv_work(int t, int kv_heads, int batch,
                                            int group, int seq_q, int causal,
                                            int q_offset) {
  using T = DkvTile<D>;
  DkvWork w;
  const int per_kt = kv_heads * batch * T::kParts;
  const int r = t % per_kt;
  w.k0 = (t / per_kt) * T::kBlockN;     // ascending: the longest first
  w.part = T::kSplit ? r % 2 : 2;
  w.kh = (r / T::kParts) % kv_heads;
  w.b = r / (T::kParts * kv_heads);
  const int q_tiles = (seq_q + T::kBlockM - 1) / T::kBlockM;
  // causal: q tile qt sees key k0 only if its last row, at position
  // q_offset + (qt + 1) * kBlockM - 1, is at k0 or past it
  int first = 0;
  if (causal) {
    const long long f = static_cast<long long>(w.k0) - q_offset;
    first = f > 0 ? static_cast<int>(min(f / T::kBlockM,
                                         static_cast<long long>(q_tiles)))
                  : 0;
  }
  w.qt_begin = first;
  w.n_qt = q_tiles - first;
  w.n_st = w.n_qt * group;
  return w;
}

// grid min(tiles, SMs), block kThreads, dynamic smem DkvTile<D>::kSmem.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int batch, int seq_q, int seq_k,
               int heads, int kv_heads, float sm_scale, int causal,
               int q_offset) {
  using T = DkvTile<D>;
  constexpr int kM = T::kBlockM, kN = T::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = base + T::kKVBytes;
  const uint32_t s_stages = s_v + T::kKVBytes;     // stage s: Q, then dO
  const uint32_t s_rows = s_stages + 2 * T::kStages * T::kQBytes;
  const uint32_t bars = s_rows + 2 * T::kStages * T::kRowBytes;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8u * (2 + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + T::kStages + s); };
  auto s_qs = [&](int s) { return s_stages + 2u * s * T::kQBytes; };
  auto s_dos = [&](int s) { return s_qs(s) + T::kQBytes; };
  // a stage's lse (times log2 e) and delta rows, as generic pointers
  auto lse_s = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + (s_rows - raw) +
                                    2 * s * T::kRowBytes);
  };
  auto delta_s = [&](int s) { return lse_s(s) + kM; };
  auto stage = [](int p) { return p % T::kStages; };
  auto round_parity = [](int p) {
    return static_cast<uint32_t>(p / T::kStages) & 1;
  };

  const int k_tiles = (seq_k + kN - 1) / kN;
  const int n_tiles = k_tiles * kv_heads * batch * T::kParts;
  const int group = heads / kv_heads;
  const int rounds = (n_tiles + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * kConsumers);      // lane 0 of each consumer warp
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full(s), 32);                 // every lane of the producer
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x / 32 == 4 * kConsumers) {     // its first warp
      const int lane = threadIdx.x % 32;
      int pos = 0, loaded = 0;             // ring position, K tiles loaded
      for (int round = 0; round < rounds; ++round) {
        const int t = dealt(round);
        if (t >= n_tiles) continue;
        const DkvWork w = dkv_work<D>(t, kv_heads, batch, group, seq_q,
                                      causal, q_offset);
        if (w.n_st == 0) continue;
        const bool need_v = !T::kSplit || w.part == 1;
        // the consumers hand K and V back after the tile's last products
        if (loaded > 0) mbar_wait(kv_empty, (loaded - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(kv_full, (need_v ? 2 : 1) * T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kChunks; ++c) {
            tma_load(s_k + c * kN * kBoxBytesPerRow, &tm_k, kv_full,
                     c * kBoxCols, w.kh, w.k0, w.b);
            if (need_v)
              tma_load(s_v + c * kN * kBoxBytesPerRow, &tm_v, kv_full,
                       c * kBoxCols, w.kh, w.k0, w.b);
          }
        }
        ++loaded;
        for (int st = 0; st < w.n_st; ++st, ++pos) {
          const int s = stage(pos);
          if (pos >= T::kStages) mbar_wait(empty(s), round_parity(pos) ^ 1);
          const int h = w.kh * group + st / w.n_qt;
          const int q0 = (w.qt_begin + st % w.n_qt) * kM;
          const size_t stat = (static_cast<size_t>(w.b) * heads + h) * seq_q;
          float* ls = lse_s(s);
          float* dl = delta_s(s);
          for (int r = lane; r < kM; r += 32) {
            const int row = q0 + r;
            const float l = row < seq_q ? lse[stat + row] : kNegLse;
            ls[r] = l > kDeadLse ? l * kLog2e : INFINITY;
            dl[r] = row < seq_q ? delta[stat + row] : 0.f;
          }
          // each lane's arrival publishes its rows; lane 0's also expects
          // the TMA bytes
          if (lane == 0) {
            mbar_expect_tx(full(s), 2 * T::kQBytes);
#pragma unroll
            for (int c = 0; c < T::kChunks; ++c) {
              tma_load(s_qs(s) + c * kM * kBoxBytesPerRow, &tm_q, full(s),
                       c * kBoxCols, h, q0, w.b);
              tma_load(s_dos(s) + c * kM * kBoxBytesPerRow, &tm_do, full(s),
                       c * kBoxCols, h, q0, w.b);
            }
          } else {
            mbar_arrive(full(s));
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // this warpgroup's 64 keys inside the 128-key boxes of K and V
    const uint32_t s_kw = s_k + wg * 64 * kBoxBytesPerRow;
    const uint32_t s_vw = s_v + wg * 64 * kBoxBytesPerRow;
    const float scale_log2 = sm_scale * kLog2e;

    float acc_a[D / 8][4];                 // dV (split: dV or dK)
    float acc_b[T::kSplit ? 1 : D / 8][4];  // dK
    float st_[kM / 8][4];     // S^T, then P^T in fp32
    float dpt[kM / 8][4];     // dP^T, then dS^T in fp32
    uint32_t pp[kM / 16][4];  // P^T (split, dK part: dS^T), bf16 A fragments
    uint32_t dsp[T::kSplit ? 1 : kM / 16][4];  // dS^T, bf16 A fragments
    int pos = 0, loaded = 0;  // ring position, K tiles consumed

    for (int round = 0; round < rounds; ++round) {
      const int tile = dealt(round);
      if (tile >= n_tiles) continue;
      const DkvWork w = dkv_work<D>(tile, kv_heads, batch, group, seq_q,
                                    causal, q_offset);
      const bool do_dv = !T::kSplit || w.part == 0;
      const bool do_dk = !T::kSplit || w.part == 1;
      const int kw0 = w.k0 + wg * 64;        // this warpgroup's keys
      int keys[2];
      keys[0] = kw0 + warp * 16 + g;
      keys[1] = keys[0] + 8;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_a[j][e] = 0.f;
      if constexpr (!T::kSplit) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_b[j][e] = 0.f;
      }

      if (w.n_st > 0) {
        // S^T = K Q^T and dP^T = V dO^T of ring position q, both operands
        // K-major, one commit group
        auto issue_sdp = [&](int q) {
          const uint32_t q_tile = s_qs(stage(q)), do_tile = s_dos(stage(q));
          fence_regs(st_);
          fence_regs(dpt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            wgmma_ss(st_,
                     sw128_desc(s_kw + (kk / 4) * kN * kBoxBytesPerRow + off,
                                16, 1024),
                     sw128_desc(q_tile + (kk / 4) * kM * kBoxBytesPerRow +
                                    off, 16, 1024),
                     kk > 0);
          }
          if (do_dk) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const uint32_t off = (kk % 4) * 32;
              wgmma_ss(dpt,
                       sw128_desc(s_vw + (kk / 4) * kN * kBoxBytesPerRow +
                                      off, 16, 1024),
                       sw128_desc(do_tile + (kk / 4) * kM * kBoxBytesPerRow +
                                      off, 16, 1024),
                       kk > 0);
            }
          }
          wgmma_commit();
        };
        // P^T into st_ and dS^T into dpt (split, dK part: dS^T into st_)
        // for stage i of the walk; column c of the tile is q row q0 + c.
        // Masks only where some key of this warpgroup lies past some
        // row's diagonal.
        auto recompute = [&](int i) {
          const int s = stage(pos + i);
          const int q0 = (w.qt_begin + i % w.n_qt) * kM;
          const float* ls = lse_s(s);
          const float* dl = delta_s(s);
          const bool straddle = causal && kw0 + 63 > q_offset + q0;
#pragma unroll
          for (int j = 0; j < kM / 8; ++j) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(ls + j * 8 + 2 * t);
            const float2 d2 =
                *reinterpret_cast<const float2*>(dl + j * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float lc = e & 1 ? l2.y : l2.x;
              float p = ex2(fmaf(st_[j][e], scale_log2, -lc));
              if (straddle) {
                const int col = q0 + j * 8 + 2 * t + (e & 1);
                p = keys[e >> 1] <= q_offset + col ? p : 0.f;
              }
              const float ds =
                  p * (dpt[j][e] - (e & 1 ? d2.y : d2.x)) * sm_scale;
              if constexpr (T::kSplit) {
                st_[j][e] = do_dk ? ds : p;
              } else {
                st_[j][e] = p;
                dpt[j][e] = ds;
              }
            }
          }
        };
        // P^T and dS^T rounded to bf16, as the TPU kernel casts them, into
        // the register-A fragments of the next products
        auto pack = [&]() {
          pack_a(pp, st_);
          if constexpr (!T::kSplit) pack_a(dsp, dpt);
        };
        // dV += P^T dO and dK += dS^T Q of ring position q, dO and Q read
        // MN-major, one commit group
        auto issue_dkdv = [&](int q) {
          const uint32_t q_tile = s_qs(stage(q)), do_tile = s_dos(stage(q));
          fence_regs(acc_a);
          fence_regs(pp);
          if constexpr (!T::kSplit) {
            fence_regs(acc_b);
            fence_regs(dsp);
          }
          wgmma_fence();
          const uint32_t a_tile = do_dv ? do_tile : q_tile;
#pragma unroll
          for (int kk = 0; kk < kM / 16; ++kk)
            wgmma_rs(acc_a, pp[kk],
                     sw128_desc(a_tile + kk * 16 * kBoxBytesPerRow,
                                kM * kBoxBytesPerRow, 1024));
          if constexpr (!T::kSplit) {
#pragma unroll
            for (int kk = 0; kk < kM / 16; ++kk)
              wgmma_rs(acc_b, dsp[kk],
                       sw128_desc(q_tile + kk * 16 * kBoxBytesPerRow,
                                  kM * kBoxBytesPerRow, 1024));
          }
          wgmma_commit();
        };

        mbar_wait(kv_full, loaded & 1);
        ++loaded;
        for (int i = 0; i < w.n_st; ++i) {
          const int cur = pos + i;
          mbar_wait(full(stage(cur)), round_parity(cur));
          issue_sdp(cur);
          wgmma_wait<0>();
          fence_regs(st_);
          fence_regs(dpt);
          recompute(i);
          pack();
          issue_dkdv(cur);
          wgmma_wait<0>();
          fence_regs(acc_a);
          if constexpr (!T::kSplit) fence_regs(acc_b);
          release(empty(stage(cur)));
        }
        pos += w.n_st;
        release(kv_empty);
      }

      // ------------------------------------------------ epilogue
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = keys[r];
        if (key >= seq_k) continue;
        const size_t off =
            ((static_cast<size_t>(w.b) * seq_k + key) * kv_heads + w.kh) * D +
            2 * t;
        bf16* out_a = (do_dv ? dv : dk) + off;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out_a + 8 * j) =
              pack_bf16(acc_a[j][2 * r], acc_a[j][2 * r + 1]);
        if constexpr (!T::kSplit) {
          bf16* out_b = dk + off;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(out_b + 8 * j) =
                pack_bf16(acc_b[j][2 * r], acc_b[j][2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, seq_q, seq_k, heads, kv_heads;
  float sm_scale;
  int causal, q_offset;
  cudaStream_t stream;
};

// The four rank-4 maps, with `q_rows`-row boxes for Q and dO and
// `kv_rows`-row boxes for K and V.
bool make_maps(const Args& a, int d, int q_rows, int kv_rows,
               CUtensorMap (&tm)[4]) {
  return make_map(&tm[0], a.q, d, a.heads, a.seq_q, a.batch, q_rows) &&
         make_map(&tm[1], a.k, d, a.kv_heads, a.seq_k, a.batch, kv_rows) &&
         make_map(&tm[2], a.v, d, a.kv_heads, a.seq_k, a.batch, kv_rows) &&
         make_map(&tm[3], a.dout, d, a.heads, a.seq_q, a.batch, q_rows);
}

// the persistent grid for `tiles` work tiles; 0 if it cannot launch
int grid_for(long long tiles) {
  const int sms = sm_count();
  if (tiles > 0x7fffffff || sms == 0) return 0;
  return static_cast<int>(tiles < sms ? tiles : sms);
}

template <int D>
cudaError_t launch_dkdv(const Args& a, bf16* dk, bf16* dv) {
  using T = DkvTile<D>;
  static std::atomic<unsigned long long> raised{0};
  const int grid = grid_for(static_cast<long long>(
      (a.seq_k + T::kBlockN - 1) / T::kBlockN) * a.kv_heads * a.batch *
      T::kParts);
  CUtensorMap tm[4];
  if (grid == 0 || !make_maps(a, D, T::kBlockM, T::kBlockN, tm))
    return cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit(flash_bwd_dkdv<D>, T::kSmem, raised);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D><<<grid, kThreads, T::kSmem, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, dk, dv, a.batch, a.seq_q,
      a.seq_k, a.heads, a.kv_heads, a.sm_scale, a.causal, a.q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  using T = DqTile<D>;
  static std::atomic<unsigned long long> raised{0};
  const int grid = grid_for(static_cast<long long>(
      (a.seq_q + T::kBlockM - 1) / T::kBlockM) * a.heads * a.batch);
  CUtensorMap tm[4];
  if (grid == 0 || !make_maps(a, D, T::kBlockM, T::kBlockN, tm))
    return cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit(flash_bwd_dq<D>, T::kSmem, raised);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D><<<grid, kThreads, T::kSmem, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, dq, a.batch, a.seq_q,
      a.seq_k, a.heads, a.kv_heads, a.sm_scale, a.causal, a.q_offset);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.batch >= 1 && a.seq_q >= 1 && a.seq_k >= 1 && a.kv_heads >= 1 &&
         a.heads % a.kv_heads == 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int batch, int seq_q,
               int seq_k, int heads, int kv_heads, float sm_scale, int causal,
               int q_offset, void* stream) {
  return Args{q, k, v, dout,
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              batch, seq_q, seq_k, heads, kv_heads, sm_scale, causal,
              q_offset, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success). The caller validates shapes, dtypes,
// contiguity and 16-byte alignment and allocates the outputs: dk/dv
// [B, Sk, KV, D] bf16, dq [B, Sq, H, D] bf16.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
    float sm_scale, int causal, int q_offset, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, batch, seq_q, seq_k,
                           heads, kv_heads, sm_scale, causal, q_offset,
                           stream);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  bf16* k_out = static_cast<bf16*>(dk);
  bf16* v_out = static_cast<bf16*>(dv);
  switch (head_dim) {
    case 64: return launch_dkdv<64>(a, k_out, v_out);
    case 128: return launch_dkdv<128>(a, k_out, v_out);
    case 256: return launch_dkdv<256>(a, k_out, v_out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq_q,
    int seq_k, int heads, int kv_heads, int head_dim, float sm_scale,
    int causal, int q_offset, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, batch, seq_q, seq_k,
                           heads, kv_heads, sm_scale, causal, q_offset,
                           stream);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  bf16* q_out = static_cast<bf16*>(dq);
  switch (head_dim) {
    case 64: return launch_dq<64>(a, q_out);
    case 128: return launch_dq<128>(a, q_out);
    case 256: return launch_dq<256>(a, q_out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
