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
// Times (chip_smoke.py phase 2 and tools/torch_bench_flash.py, which also
// times the steps that led here) are in PERF.md. The PTX, TMA and
// tensor-map helpers live in flash_attention_hopper.cuh.

#include <type_traits>

#include "flash_attention_hopper.cuh"

namespace {

using namespace fa_hopper;

constexpr int kConsumers = 2;       // consumer warpgroups, 64 q rows each
constexpr int kBlockM = 64 * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);
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

// Raise the kernel's dynamic shared-memory limit once per device.
template <int D>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  return raise_smem_limit(flash_fwd<D>, Tile<D>::kSmem, done);
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
