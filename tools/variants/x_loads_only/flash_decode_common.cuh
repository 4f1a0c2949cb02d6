// Flash-decode for Hopper (sm_90a), the body shared by the paged kernel
// (flash_decode_paged.cu) and the slot-cache kernel (flash_decode_slots.cu).
// The two differ only in where position p of a stream's K/V lives: each
// passes its own `RowOf`, the index of that position's row (D elements of
// one KV head) in the cache.
//
// Work by live length. A work item is (stream, KV head, chunk): a chunk is
// a run of whole 64-position ring stages of the stream's live positions
// [0, min(kv_len[b], span)), lengthened for a long stream so that no
// (stream, KV head) has more than kMaxPartials partials. The grid is
// persistent (one block per SM at most); every block reads kv_len itself
// and walks the same item list, taking items blockIdx.x, + gridDim.x, ...
// The dealing (stream_split, Walk) follows
// dcos_commons_tpu_torch/ops/flash_decode.py::decode_plan and its
// stream_split / decode_items, where the formulas live once and are tested.
// No block reads or writes a position at or past min(kv_len[b], span); a
// stream with none gets output 0.
//
// Block: one producer warp and four consumer warps.
// - The producer walks the block's items and fills a ring of K/V stages in
//   shared memory: one 1-D bulk copy (cp.async.bulk) per row of one head,
//   completing on the stage's "full" mbarrier, each row looked up through
//   `RowOf` (so any page size works, with nothing encoded on the host).
//   int8 scales (2 bytes a row) cannot come by bulk copy: its lanes load
//   them into the stage before they arrive on the barrier. It looks up a
//   stage's rows (and scales) before it waits for the stage's slot, copies
//   the item's query heads with its first stage, and zero-fills the V rows
//   (int8: the scales) past the end of a short last stage.
// - Consumer warp w takes rows [16 w, 16 w + 16) of every stage. Both
//   products run on tensor cores (mma.sync m16n8k16, bf16 in, fp32 out):
//   S^T = K Q^T with keys as M and the group's <= 8 query heads as N (K by
//   ldmatrix, Q^T in registers for the whole item), then O^T += V^T P^T
//   with V^T by ldmatrix.trans and P^T moved from the score fragment by
//   movmatrix.trans. The softmax is online, in base 2 with the scale
//   folded in (ex2.approx), one max per head per stage for the warp.
//   wgmma was not taken: its 64-row M tile would take a whole warpgroup
//   per 64 keys and P^T would have to go through shared memory for the
//   second product, and the kernel is bound by bytes (a few flops per
//   byte against the ~295 where the tensor cores become the limit), so the
//   tensor cores idle either way.
// - At an item's end the four warps merge in shared memory into one
//   partial (m, l, acc) per query head. An item that is its stream's only
//   one writes the output. Otherwise it writes its partial to the
//   workspace, and the block that finishes the pair's last item (found by
//   __threadfence then atomicAdd on the pair's counter) merges the pair's
//   partials in chunk order, writes the output and sets the counter back to
//   0 for the next launch (or CUDA-graph replay). One launch a call; the
//   output does not depend on which block finishes last.
//
// The arithmetic is the TPU kernel's: fp32 accumulation; int8 scales fold
// as (q . k_q) * s_k and (p * s_v) @ v_q; int8 payloads convert exactly to
// bf16 (each consumer warp converts its 16 rows into its own scratch)
// before the products. p (times s_v for int8) meets V as bf16, rounded as
// the TPU kernel rounds it, plus what that rounding left as a second bf16
// product: with one max per 16 keys, the rounding alone is off by up to
// 2^-9 of each p, and on a stream of a few positions (nothing to average
// it out) that exceeds the 1e-3 + 1e-2 * |out| the kernel is held to
// against the fp32 plain version (measured on the card: 10 of 32,768
// outputs at 2.9e-3 for streams of 5 and 9 positions). The second product
// costs tensor-core time only, which the kernel has to spare.

#pragma once

#include <type_traits>

#include "flash_attention_hopper.cuh"

namespace flash_decode {

using fa_hopper::bf16;
using fa_hopper::ex2;
using fa_hopper::mbar_arrive;
using fa_hopper::mbar_expect_tx;
using fa_hopper::mbar_init;
using fa_hopper::mbar_wait;
using fa_hopper::pack_bf16;
using fa_hopper::smem_addr;

// Work sizing: ops/flash_decode.py STAGE_ROWS and MAX_PARTIALS.
constexpr int kStageRows = 64;     // positions per ring stage; the base chunk
constexpr int kMaxPartials = 16;   // partials per (stream, KV head) at most
constexpr int kConsumerWarps = 4;  // 16 rows of a stage each
constexpr int kWarpRows = kStageRows / kConsumerWarps;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxGroup = 8;       // query heads per KV head: N of m16n8k16
constexpr int kRowPad = 16;        // bytes after each shared-memory row, so
                                   // ldmatrix's 8 rows hit all 32 banks
constexpr int kLenCache = 1024;    // live lengths a block reads up front

// Shared-memory plan of one block for cache element T and head_dim D.
template <typename T, int D>
struct Cfg {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kRowStride = kRowBytes + kRowPad;
  static constexpr int kTileBytes = kStageRows * kRowStride;
  static constexpr int kScaleBytes = kQuant ? kStageRows * 2 : 0;
  // the item's query heads, copied with its first stage; rows padded
  static constexpr int kQStride = 2 * D + kRowPad;
  static constexpr int kQBytes = kMaxGroup * kQStride;
  // K tile, V tile, K scales, V scales, Q
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kScaleBytes + kQBytes;
  // ring depth: as many stages as fit one block per SM beside the rest
  static constexpr int kStages =
      D == 64 ? 6 : D == 128 ? 4 : (kQuant ? 3 : 2);
  // int8: a consumer warp's 16 K rows and 16 V rows converted to bf16
  static constexpr int kScratchStride = 2 * D + kRowPad;
  static constexpr int kScratchBytes =
      kQuant ? kConsumerWarps * 2 * kWarpRows * kScratchStride : 0;
  static constexpr int kMergeStride = D + 4;  // floats; conflict-free stores
  // o, m and l of each warp; weights, partial m and l, l of each head
  static constexpr int kMergeBytes =
      (kConsumerWarps * kMaxGroup * (kMergeStride + 2) +
       3 * kMaxPartials * kMaxGroup + kMaxGroup) * 4;
  static constexpr int kHeadBytes = 128;  // barriers and the merge flag
  static constexpr int kSmem = kHeadBytes + kStages * kStageBytes +
                               kScratchBytes + kMergeBytes + kLenCache * 4;
  static_assert(2 * kStages * 8 + 4 <= kHeadBytes, "barrier area");
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(kConsumerWarps <= kMaxPartials, "merge weights");
  static_assert(kMaxPartials * kMaxGroup <= kConsumers, "partial loads");
};

// ----------------------------------------------------------------- PTX

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy (bulk copy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier 1 over the consumer warps only (the producer never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// transpose an 8 x 8 bf16 matrix held one 32-bit pair per lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ the work

// kv_len as a pointer with a stride (0: one length for every stream) or,
// without a pointer, one value; clamped to [0, span].
struct Lens {
  const int* ptr;
  int stride;
  int value;
  int span;
  __device__ __forceinline__ int live(int b) const {
    const int n = ptr != nullptr ? ptr[static_cast<size_t>(b) * stride] : value;
    return max(0, min(n, span));
  }
};

// ops/flash_decode.py::stream_split: (chunk length, chunks) of a stream
// with `live` positions
__device__ __forceinline__ void stream_split(int live, int& chunk, int& n) {
  if (live <= 0) {
    chunk = kStageRows;
    n = 0;
    return;
  }
  const int stages = (live + kStageRows - 1) / kStageRows;
  chunk = kStageRows * ((stages + kMaxPartials - 1) / kMaxPartials);
  n = (live + chunk - 1) / chunk;
}

struct Item {
  int b, kh;   // stream, KV head
  int j, n;    // chunk, chunks of the stream (0: no live position)
  int p0, p1;  // positions [p0, p1)
};

// The items of this block in ops/flash_decode.py::decode_items' order:
// stream by stream, each a KV head x max(chunks, 1) grid (a stream without
// live positions has one empty item per KV head, which writes zeros);
// item i goes to block i % gridDim.x.
// The live lengths of the first kLenCache streams come from shared memory,
// where the block loaded them all at once (one latency, not one a stream).
struct Walk {
  Lens lens;
  const int* cached;
  int batch, kv_heads;
  int b = -1, first = 0, count = 0, live = 0, chunk = 0, n = 0, per = 1;
  int next;
  __device__ Walk(const Lens& l, const int* c, int bt, int kvh)
      : lens(l), cached(c), batch(bt), kv_heads(kvh), next(blockIdx.x) {}
  __device__ bool get(Item& it) {
    while (next >= first + count) {
      first += count;
      count = 0;
      if (++b >= batch) return false;
      live = b < kLenCache ? cached[b] : lens.live(b);
      stream_split(live, chunk, n);
      per = max(n, 1);
      count = kv_heads * per;
    }
    const int r = next - first;
    it.b = b;
    it.kh = r / per;
    it.j = r % per;
    it.n = n;
    it.p0 = it.j * chunk;
    it.p1 = min(it.p0 + chunk, live);
    next += gridDim.x;
    return true;
  }
};

struct Params {
  const bf16* q;  // [B, H, D]
  const void* k;  // cache payload, bf16 or int8
  const void* v;
  const bf16* k_scale;  // int8 only: one per row
  const bf16* v_scale;
  Lens lens;
  bf16* out;        // [B, H, D]
  float* ws;        // partials: acc, then m, then l
  int* counters;    // [B, KV], zero between launches
  const int* cached;  // shared memory: live lengths of the first streams
  int batch, kv_heads, group, max_partials;
  float scale_log2;  // sm_scale * log2(e)
};

// workspace offsets of partial (pair, j) of head h
__device__ __forceinline__ size_t part_index(const Params& p, size_t pair,
                                             int j, int h) {
  return (pair * p.max_partials + j) * p.group + h;
}

// The block's stages in order: each item's positions in runs of
// kStageRows (an item without positions has none).
struct Stages {
  Walk walk;
  Item it;
  int p0 = 0;
  bool ok;
  __device__ Stages(const Lens& l, const int* c, int batch, int kvh)
      : walk(l, c, batch, kvh) {
    ok = walk.get(it);
    p0 = ok ? it.p0 : 0;
    skip_empty();
  }
  __device__ void skip_empty() {
    while (ok && p0 >= it.p1) {
      ok = walk.get(it);
      p0 = ok ? it.p0 : 0;
    }
  }
  __device__ void advance() {
    p0 += kStageRows;
    skip_empty();
  }
};

// one producer lane's rows of a stage: cache row index and int8 scales
template <bool kQuant>
struct Fetch {
  static constexpr int kPerLane = kStageRows / 32;
  size_t row[kPerLane];
  bf16 ks[kPerLane], vs[kPerLane];
};

template <typename T, int D, typename RowOf>
__device__ __forceinline__ void lookup(const Params& p, const RowOf& row_of,
                                       const Stages& st,
                                       Fetch<Cfg<T, D>::kQuant>& f,
                                       int lane) {
  const int rows = min(kStageRows, st.it.p1 - st.p0);
#pragma unroll
  for (int i = 0; i < Fetch<Cfg<T, D>::kQuant>::kPerLane; ++i) {
    const int r = lane + 32 * i;
    f.row[i] = r < rows ? row_of(st.it.b, st.it.kh, st.p0 + r) : 0;
    if constexpr (Cfg<T, D>::kQuant) {
      f.ks[i] = r < rows ? p.k_scale[f.row[i]] : __float2bfloat16(0.f);
      f.vs[i] = r < rows ? p.v_scale[f.row[i]] : __float2bfloat16(0.f);
    }
  }
}

// Looks up the next stage's rows (page table, int8 scales) before it waits
// for that stage's slot, so the lookups' latency overlaps the copies in
// flight.
template <typename T, int D, typename RowOf>
__device__ __forceinline__ void produce(const Params& p, const RowOf& row_of,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int lane) {
  using C = Cfg<T, D>;
  using F = Fetch<C::kQuant>;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  Stages st(p.lens, p.cached, p.batch, p.kv_heads);
  F cur, nxt;
  if (st.ok) lookup<T, D>(p, row_of, st, cur, lane);
  for (int stage = 0; st.ok; ++stage) {
    const Item it = st.it;
    const int p0 = st.p0;
    st.advance();
    if (st.ok) lookup<T, D>(p, row_of, st, nxt, lane);
    const int slot = stage % C::kStages;
    mbar_wait(smem_addr(&empty[slot]), ((stage / C::kStages) & 1) ^ 1);
    const int rows = min(kStageRows, it.p1 - p0);
    uint8_t* kt = ring + slot * C::kStageBytes;
    uint8_t* vt = kt + C::kTileBytes;
    bf16* ks = reinterpret_cast<bf16*>(vt + C::kTileBytes);
    bf16* vs = ks + kStageRows;
    uint8_t* qs = vt + C::kTileBytes + 2 * C::kScaleBytes;
#pragma unroll
    for (int i = 0; i < F::kPerLane; ++i) {
      const int r = lane + 32 * i;
      if constexpr (C::kQuant) {
        // 0 past the end: p * s_v must be 0 whatever the stale bytes hold
        ks[r] = cur.ks[i];
        vs[r] = cur.vs[i];
      } else if (r >= rows) {
        // stale or never written bf16 could be NaN, and 0 * NaN is NaN
        uint4* dst = reinterpret_cast<uint4*>(vt + r * C::kRowStride);
#pragma unroll
        for (int e = 0; e < C::kRowBytes / 16; ++e)
          dst[e] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    fence_proxy_async();
    __syncwarp();
    const bool first = p0 == it.p0;
    const uint32_t bar = smem_addr(&full[slot]);
    if (lane == 0)
      mbar_expect_tx(bar, 2u * rows * C::kRowBytes +
                              (first ? 2u * p.group * D : 0u));
    else
      mbar_arrive(bar);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < F::kPerLane; ++i) {
      const int r = lane + 32 * i;
      if (r < rows) {
        bulk_load(smem_addr(kt + r * C::kRowStride), k + cur.row[i] * D,
                  C::kRowBytes, bar);
        bulk_load(smem_addr(vt + r * C::kRowStride), v + cur.row[i] * D,
                  C::kRowBytes, bar);
      }
    }
    if (first && lane < p.group) {  // the item's query heads, one row each
      const size_t pair = static_cast<size_t>(it.b) * p.kv_heads + it.kh;
      bulk_load(smem_addr(qs + lane * C::kQStride),
                p.q + (pair * p.group + lane) * D, 2 * D, bar);
    }
    cur = nxt;
  }
}

// ------------------------------------------------------------- consumer

// int8 -> bf16 (exact) of a warp's 16 rows: src rows kRowStride apart,
// dst rows kScratchStride apart
template <int D, int kSrcStride, int kDstStride>
__device__ __forceinline__ void convert_rows(const uint8_t* src, uint8_t* dst,
                                             int lane) {
  constexpr int kChunks = D / 8;  // 8 bytes in, 16 bytes out
#pragma unroll
  for (int c = lane; c < kWarpRows * kChunks; c += 32) {
    const int r = c / kChunks, col = c % kChunks;
    const uint2 raw =
        *reinterpret_cast<const uint2*>(src + r * kSrcStride + col * 8);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint4 o;
    o.x = pack_bf16(static_cast<float>(x[0]), static_cast<float>(x[1]));
    o.y = pack_bf16(static_cast<float>(x[2]), static_cast<float>(x[3]));
    o.z = pack_bf16(static_cast<float>(x[4]), static_cast<float>(x[5]));
    o.w = pack_bf16(static_cast<float>(x[6]), static_cast<float>(x[7]));
    *reinterpret_cast<uint4*>(dst + r * kDstStride + col * 16) = o;
  }
}

// what bf16 rounding left of (lo, hi), as a second bf16 pair
__device__ __forceinline__ uint32_t residual(float lo, float hi,
                                             uint32_t rounded) {
  const float2 r =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rounded));
  return pack_bf16(lo - r.x, hi - r.y);
}

__device__ __forceinline__ float4 fma4(float4 acc, float4 x, float w) {
  return make_float4(fmaf(x.x, w, acc.x), fmaf(x.y, w, acc.y),
                     fmaf(x.z, w, acc.z), fmaf(x.w, w, acc.w));
}

// out[0..3] = bf16(acc / l)
__device__ __forceinline__ void store_out(bf16* out, float4 acc, float l) {
  uint2 o;
  o.x = pack_bf16(acc.x / l, acc.y / l);
  o.y = pack_bf16(acc.z / l, acc.w / l);
  *reinterpret_cast<uint2*>(out) = o;
}

// Shared-memory merge area of the consumer warps.
template <int D>
struct Merge {
  static constexpr int Ms = D + 4;
  float* o;   // [warps][kMaxGroup][Ms]
  float* m;   // [warps][kMaxGroup]
  float* l;   // [warps][kMaxGroup]
  float* wt;  // [kMaxPartials][kMaxGroup]: weights of warps or partials
  float* pm;  // [kMaxPartials][kMaxGroup]: partial m, then l
  float* pl;
  float* hl;  // [kMaxGroup]: l of each head
  __device__ explicit Merge(uint8_t* base) {
    o = reinterpret_cast<float*>(base);
    m = o + kConsumerWarps * kMaxGroup * Ms;
    l = m + kConsumerWarps * kMaxGroup;
    wt = l + kConsumerWarps * kMaxGroup;
    pm = wt + kMaxPartials * kMaxGroup;
    pl = pm + kMaxPartials * kMaxGroup;
    hl = pl + kMaxPartials * kMaxGroup;
  }
};

// Head h's weights 2^(m_i - max m) of n terms m[i * kMaxGroup + h] into
// wt, and their sum weighted by l into hl[h]; returns max m. One thread
// per head.
__device__ __forceinline__ float weigh(const float* m, const float* l, int n,
                                       int h, float* wt, float* hl) {
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, m[i * kMaxGroup + h]);
  float sum = 0.f;
  for (int i = 0; i < n; ++i) {
    const float w = ex2(m[i * kMaxGroup + h] - mx);
    wt[i * kMaxGroup + h] = w;
    sum += l[i * kMaxGroup + h] * w;
  }
  hl[h] = sum;
  return mx;
}

template <typename T, int D>
__device__ __forceinline__ void consume(const Params& p, uint8_t* ring,
                                        uint8_t* scratch, uint8_t* merge_area,
                                        uint64_t* full, uint64_t* empty,
                                        int* flag, int warp, int lane) {
  using C = Cfg<T, D>;
  constexpr int kSteps = D / 16;
  const Merge<D> mg(merge_area);
  constexpr int Ms = Merge<D>::Ms;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int group = p.group;
  const size_t slots = static_cast<size_t>(p.batch) * p.kv_heads *
                       p.max_partials * group;  // partial slots
  float* part_acc = p.ws;
  float* part_m = p.ws + slots * D;
  float* part_l = part_m + slots;
  Walk walk(p.lens, p.cached, p.batch, p.kv_heads);
  Item it;
  int stage = 0;
  while (walk.get(it)) {
    const size_t pair = static_cast<size_t>(it.b) * p.kv_heads + it.kh;
    bf16* out = p.out + pair * group * D;
    if (it.n == 0) {  // no live position: output 0
      for (int e = tid; e < group * D; e += kConsumers)
        out[e] = __float2bfloat16(0.f);
      continue;
    }
    // Q^T, the B operand of S^T = K Q^T (column g: query head g), comes
    // with the item's first stage
    uint32_t qf[kSteps][2];
    // this thread: heads 2t, 2t + 1; O^T rows 16 mt + g (+ 8)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[kSteps][4];
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;

    for (int p0 = it.p0; p0 < it.p1; p0 += kStageRows, ++stage) {
      const int slot = stage % C::kStages;
      mbar_wait(smem_addr(&full[slot]), (stage / C::kStages) & 1);
      const int rows = min(kStageRows, it.p1 - p0);
      const int r0 = kWarpRows * warp;
      uint8_t* kt = ring + slot * C::kStageBytes;
      uint8_t* vt = kt + C::kTileBytes;
      if (p0 == it.p0) {
        // rows past the group are zero from the start (never copied)
        const uint32_t qaddr =
            smem_addr(vt + C::kTileBytes + 2 * C::kScaleBytes);
#pragma unroll
        for (int ks = 0; ks < kSteps; ks += 2) {
          uint32_t r[4];
          ldsm_x4(r, qaddr + (lane & 7) * C::kQStride +
                         (16 * ks + 8 * (lane >> 3)) * 2);
          qf[ks][0] = r[0];
          qf[ks][1] = r[1];
          qf[ks + 1][0] = r[2];
          qf[ks + 1][1] = r[3];
        }
      }
      if (r0 < rows && p.batch < 0) {  // diagnostic: no math, loads and merges only
        uint32_t kaddr, vaddr;
        int stride;
        float sk[2] = {1.f, 1.f}, sv[2] = {1.f, 1.f};
        if constexpr (C::kQuant) {
          const bf16* ks = reinterpret_cast<const bf16*>(vt + C::kTileBytes);
          const bf16* vs = ks + kStageRows;
          uint8_t* kc = scratch + warp * 2 * kWarpRows * C::kScratchStride;
          uint8_t* vc = kc + kWarpRows * C::kScratchStride;
          convert_rows<D, C::kRowStride, C::kScratchStride>(
              kt + r0 * C::kRowStride, kc, lane);
          convert_rows<D, C::kRowStride, C::kScratchStride>(
              vt + r0 * C::kRowStride, vc, lane);
          sk[0] = __bfloat162float(ks[r0 + g]);
          sk[1] = __bfloat162float(ks[r0 + g + 8]);
          sv[0] = __bfloat162float(vs[r0 + g]);
          sv[1] = __bfloat162float(vs[r0 + g + 8]);
          __syncwarp();
          kaddr = smem_addr(kc);
          vaddr = smem_addr(vc);
          stride = C::kScratchStride;
        } else {
          kaddr = smem_addr(kt + r0 * C::kRowStride);
          vaddr = smem_addr(vt + r0 * C::kRowStride);
          stride = C::kRowStride;
        }
        // S^T (16 keys x 8 heads): s[0..1] key r0 + g, s[2..3] key
        // r0 + g + 8; heads 2t, 2t + 1
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, kaddr + (lane & 15) * stride +
                         (16 * ks + 8 * (lane >> 4)) * 2);
          mma_16816(s, a, qf[ks][0], qf[ks][1]);
        }
        const bool live0 = r0 + g < rows, live1 = r0 + g + 8 < rows;
        s[0] = live0 ? s[0] * sk[0] * p.scale_log2 : -INFINITY;
        s[1] = live0 ? s[1] * sk[0] * p.scale_log2 : -INFINITY;
        s[2] = live1 ? s[2] * sk[1] * p.scale_log2 : -INFINITY;
        s[3] = live1 ? s[3] * sk[1] * p.scale_log2 : -INFINITY;
        float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
        const float al0 = ex2(m[0] - mn0), al1 = ex2(m[1] - mn1);
        m[0] = mn0;
        m[1] = mn1;
        const float p00 = ex2(s[0] - mn0), p01 = ex2(s[1] - mn1);
        const float p10 = ex2(s[2] - mn0), p11 = ex2(s[3] - mn1);
        l[0] = l[0] * al0 + p00 + p10;
        l[1] = l[1] * al1 + p01 + p11;
#pragma unroll
        for (int mt = 0; mt < kSteps; ++mt) {
          o[mt][0] *= al0;
          o[mt][1] *= al1;
          o[mt][2] *= al0;
          o[mt][3] *= al1;
        }
        // P^T (16 keys x 8 heads, times s_v for int8) as the B operand:
        // rounded to bf16 (h), and what the rounding left (r) as a second
        // product
        const float x00 = p00 * sv[0], x01 = p01 * sv[0];
        const float x10 = p10 * sv[1], x11 = p11 * sv[1];
        const uint32_t h0 = pack_bf16(x00, x01), h1 = pack_bf16(x10, x11);
        const uint32_t b0 = movmatrix_trans(h0), b1 = movmatrix_trans(h1);
        const uint32_t c0 = movmatrix_trans(residual(x00, x01, h0));
        const uint32_t c1 = movmatrix_trans(residual(x10, x11, h1));
#pragma unroll
        for (int mt = 0; mt < kSteps; ++mt) {
          uint32_t a[4];
          ldsm_x4_trans(a, vaddr + ((lane & 7) + 8 * (lane >> 4)) * stride +
                               (16 * mt + 8 * ((lane >> 3) & 1)) * 2);
          mma_16816(o[mt], a, b0, b1);
          mma_16816(o[mt], a, c0, c1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[slot]));
    }

    // merge the four warps into the item's partial
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    float* mo = mg.o + warp * kMaxGroup * Ms;
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      mo[(2 * t) * Ms + 16 * mt + g] = o[mt][0];
      mo[(2 * t + 1) * Ms + 16 * mt + g] = o[mt][1];
      mo[(2 * t) * Ms + 16 * mt + g + 8] = o[mt][2];
      mo[(2 * t + 1) * Ms + 16 * mt + g + 8] = o[mt][3];
    }
    if (g == 0) {
      mg.m[warp * kMaxGroup + 2 * t] = m[0];
      mg.m[warp * kMaxGroup + 2 * t + 1] = m[1];
      mg.l[warp * kMaxGroup + 2 * t] = l[0];
      mg.l[warp * kMaxGroup + 2 * t + 1] = l[1];
    }
    consumer_sync();
    const bool single = it.n == 1;
    if (tid < group) {
      const float mx = weigh(mg.m, mg.l, kConsumerWarps, tid, mg.wt, mg.hl);
      if (!single) {
        const size_t i = part_index(p, pair, it.j, tid);
        part_m[i] = mx;
        part_l[i] = mg.hl[tid];
      }
    }
    consumer_sync();
    for (int e = 4 * tid; e < group * D; e += 4 * kConsumers) {
      const int h = e / D, d = e % D;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        acc = fma4(acc,
                   *reinterpret_cast<const float4*>(
                       mg.o + (w * kMaxGroup + h) * Ms + d),
                   mg.wt[w * kMaxGroup + h]);
      if (single)
        store_out(out + e, acc, mg.hl[h]);
      else
        *reinterpret_cast<float4*>(
            part_acc + part_index(p, pair, it.j, h) * D + d) = acc;
    }
    if (!single) {
      __threadfence();
      consumer_sync();
      if (tid == 0) {
        const int done = atomicAdd(&p.counters[pair], 1);
        const int last = done == it.n - 1;
        if (last) p.counters[pair] = 0;  // zero for the next launch
        *flag = last;
      }
      consumer_sync();
      if (*flag) {  // the pair's last item: merge its partials in order
        __threadfence();
        if (tid < it.n * group) {
          const int j = tid / group, h = tid % group;
          const size_t i = part_index(p, pair, j, h);
          mg.pm[j * kMaxGroup + h] = __ldcg(part_m + i);
          mg.pl[j * kMaxGroup + h] = __ldcg(part_l + i);
        }
        consumer_sync();
        if (tid < group) weigh(mg.pm, mg.pl, it.n, tid, mg.wt, mg.hl);
        consumer_sync();
        for (int e = 4 * tid; e < group * D; e += 4 * kConsumers) {
          const int h = e / D, d = e % D;
          float4 x[kMaxPartials];
#pragma unroll
          for (int j = 0; j < kMaxPartials; ++j)
            if (j < it.n)
              x[j] = __ldcg(reinterpret_cast<const float4*>(
                  part_acc + part_index(p, pair, j, h) * D + d));
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < kMaxPartials; ++j)
            if (j < it.n) acc = fma4(acc, x[j], mg.wt[j * kMaxGroup + h]);
          store_out(out + e, acc, mg.hl[h]);
        }
      }
    }
    consumer_sync();  // merge area and flag free for the next item
  }
}

// -------------------------------------------------------------- kernel

// grid: ops/flash_decode.py::decode_plan(...).grid blocks; kThreads.
template <typename T, int D, typename RowOf>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(Params p, const RowOf row_of) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + C::kStages;
  int* flag = reinterpret_cast<int*>(empty + C::kStages);
  uint8_t* ring = smem + C::kHeadBytes;
  uint8_t* scratch = ring + C::kStages * C::kStageBytes;
  uint8_t* merge_area = scratch + C::kScratchBytes;
  int* cached = reinterpret_cast<int*>(merge_area + C::kMergeBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < min(p.batch, kLenCache); b += kThreads)
    cached[b] = p.lens.live(b);
  p.cached = cached;
  // Q rows past the group are never copied: zero, so their score columns
  // stay finite
  for (int s = 0; s < C::kStages; ++s) {
    uint8_t* qs = ring + s * C::kStageBytes + 2 * C::kTileBytes +
                  2 * C::kScaleBytes;
    for (int e = p.group * D * 2 / 16 + threadIdx.x;
         e < kMaxGroup * D * 2 / 16; e += kThreads) {
      const int r = e / (D * 2 / 16), c = e % (D * 2 / 16);
      *reinterpret_cast<uint4*>(qs + r * C::kQStride + c * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 32);
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumerWarps)
    produce<T, D>(p, row_of, ring, full, empty, lane);
  else
    consume<T, D>(p, ring, scratch, merge_area, full, empty, flag, warp,
                  lane);
}

// ---------------------------------------------------------------- host

template <typename T>
struct Tag {
  using type = T;
};

// Calls `launch(Tag<T>, integral_constant<int, D>)` for the runtime
// head_dim and cache type; false for a head_dim without an instance.
template <typename F>
bool dispatch(int head_dim, bool quant, F&& launch) {
  auto by_type = [&](auto d) {
    if (quant)
      launch(Tag<int8_t>{}, d);
    else
      launch(Tag<bf16>{}, d);
  };
  switch (head_dim) {
    case 64:
      by_type(std::integral_constant<int, 64>{});
      return true;
    case 128:
      by_type(std::integral_constant<int, 128>{});
      return true;
    case 256:
      by_type(std::integral_constant<int, 256>{});
      return true;
    default:
      return false;
  }
}

// Checks the sizes and launches one kernel on `stream`; returns a
// cudaError_t (0 on success).
template <typename RowOf>
int launch(Params p, const RowOf& row_of, int heads, int head_dim,
           int quantized, float sm_scale, int grid, void* stream_handle) {
  if (p.batch < 1 || p.kv_heads < 1 || heads % p.kv_heads != 0 ||
      heads / p.kv_heads > kMaxGroup || p.lens.span < 1 || grid < 1 ||
      p.max_partials < 1 || p.max_partials > kMaxPartials)
    return static_cast<int>(cudaErrorInvalidValue);
  p.group = heads / p.kv_heads;
  p.scale_log2 = sm_scale * fa_hopper::kLog2e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t err = cudaSuccess;
  const bool known = dispatch(head_dim, quantized != 0, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    auto kernel = decode_kernel<T, D, RowOf>;
    static std::atomic<unsigned long long> raised{0};
    err = fa_hopper::raise_smem_limit(kernel, Cfg<T, D>::kSmem, raised);
    if (err != cudaSuccess) return;
    kernel<<<grid, kThreads, Cfg<T, D>::kSmem, stream>>>(p, row_of);
    err = cudaGetLastError();
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // namespace flash_decode
