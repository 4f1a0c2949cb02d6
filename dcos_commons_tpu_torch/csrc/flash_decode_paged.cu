// Paged flash-decode for Hopper (sm_90a): one query position per stream
// against a block-paged K/V pool, bf16 or int8 pages.
//
// Replaces the Pallas TPU kernel `_paged_kernel` (arithmetic body
// `_decode_kernel`) of dcos_commons_tpu/ops/flash_decode.py, reached
// through `flash_decode_paged`. Same semantics, not the same blocking:
// position p of stream b lives at pool[table[b, p / ps], p % ps, h, :];
// stream b attends to positions [0, min(kv_len[b], MP * ps)); online
// softmax in fp32; int8 scales fold exactly as the TPU kernel folds them,
// (q . k_q) * s_k and (p * s_v) @ v_q; a stream with no live position
// gets output 0.
//
// Bound. Decode attention touches every live K/V row once and does
// 4 * group flops per K/V element pair (group = query heads per KV head,
// 4 at Llama-3-8B): a few flops per byte, far below the ~295 flops/byte
// where the H100's bf16 tensor cores become the limit. It is bound by
// bytes: the live K/V rows (+ their int8 scales), q and out, over
// 3.35 TB/s.
//
// Design. At the 8B serving shape B=8 streams x KV=8 heads give only 64
// (stream, head) pairs against 132 SMs, so each stream's table is cut
// into splits of whole pages and the grid is (B, KV, splits). A block
// walks its split's positions with one row group of D/8 threads per K/V
// row (16-byte bf16 loads, 8-byte int8 loads), keeps the `group` query
// heads of its KV head in registers so every loaded row serves all of
// them, and accumulates in fp32. Row groups merge in shared memory; each
// block writes a partial (m, l, acc) to scratch the wrapper allocates,
// and `paged_decode_combine` merges the live splits of each head. Splits
// beyond kv_len read nothing and write an empty partial (m=-inf, l=0).
// Tensor cores, TMA and wgmma are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads per KV head
constexpr int kVec = 8;       // row elements per thread

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[kVec]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = static_cast<float>(c[i]);
}

// grid (B, KV, n_splits), block kThreads.
template <typename T, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const __nv_bfloat16* __restrict__ q,        // [B, H, D]
                   const T* __restrict__ k_pool,               // [P, ps, KV, D]
                   const T* __restrict__ v_pool,               // [P, ps, KV, D]
                   const __nv_bfloat16* __restrict__ k_scale,  // [P, ps, KV] or null
                   const __nv_bfloat16* __restrict__ v_scale,  // [P, ps, KV] or null
                   const int* __restrict__ table,              // [B, MP]
                   const int* __restrict__ kv_len,             // [B]
                   float* __restrict__ part_m,                 // [B, KV, n_splits, G]
                   float* __restrict__ part_l,                 // [B, KV, n_splits, G]
                   float* __restrict__ part_acc,               // [B, KV, n_splits, G, D]
                   int kv_heads, int group, int page_size, int max_pages,
                   int pages_per_split, float sm_scale) {
  constexpr int kTpr = D / kVec;           // threads per row: 8, 16, 32
  constexpr int kRpw = 32 / kTpr;          // rows per warp
  constexpr int kRowGroups = kWarps * kRpw;
  __shared__ float sm_m[kRowGroups][kMaxGroup];
  __shared__ float sm_l[kRowGroups][kMaxGroup];
  __shared__ float sm_acc[kRowGroups][D];

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp * kRpw + lane / kTpr;  // this thread's row group
  const int sub = lane % kTpr;               // its slice of the row
  const size_t part = ((size_t)b * kv_heads + kh) * n_splits + split;

  const int limit = max(0, min(kv_len[b], max_pages * page_size));
  const int p0 = split * pages_per_split * page_size;
  const int p1 = min(p0 + pages_per_split * page_size, limit);
  if (p0 >= p1) {  // nothing live in this split: empty partial
    if (tid < group) {
      part_m[part * group + tid] = -INFINITY;
      part_l[part * group + tid] = 0.f;
    }
    return;
  }

  const int heads = kv_heads * group;
  float qf[kMaxGroup][kVec];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kVec];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      acc[g][e] = 0.f;
      qf[g][e] = 0.f;
    }
    if (g < group)
      load8(q + ((size_t)b * heads + kh * group + g) * D + sub * kVec, qf[g]);
  }

  const int* trow = table + (size_t)b * max_pages;
  // every lane of a warp runs the same trip count (the row-group shuffles
  // need the whole warp); lanes past the split's end mask their update
  for (int base = p0 + warp * kRpw; base < p1; base += kRowGroups) {
    const int p = base + lane / kTpr;
    const bool live = p < p1;
    float kf[kVec], vf[kVec];
    float ks = 1.f, vs = 1.f;
    if (live) {
      const int page = trow[p / page_size];
      const size_t row =
          ((size_t)page * page_size + (p % page_size)) * kv_heads + kh;
      load8(k_pool + row * D + sub * kVec, kf);
      load8(v_pool + row * D + sub * kVec, vf);
      if (kQuant) {
        ks = __bfloat162float(k_scale[row]);
        vs = __bfloat162float(v_scale[row]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
        for (int o = kTpr / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (live) {
          s = s * sm_scale;
          if (kQuant) s = s * ks;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float pr = expf(s - m_new);
          l[g] = l[g] * alpha + pr;
          const float pv = kQuant ? pr * vs : pr;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the row groups of this block, one query head at a time
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      sm_m[rg][g] = m[g];
      sm_l[rg][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {  // uniform across the block
      float mx = -INFINITY;
      for (int r = 0; r < kRowGroups; ++r) mx = fmaxf(mx, sm_m[r][g]);
      const float w = m[g] == -INFINITY ? 0.f : expf(m[g] - mx);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm_acc[rg][sub * kVec + e] = acc[g][e] * w;
      __syncthreads();
      for (int e = tid; e < D; e += kThreads) {
        float a = 0.f;
        for (int r = 0; r < kRowGroups; ++r) a += sm_acc[r][e];
        part_acc[(part * group + g) * D + e] = a;
      }
      if (tid == 0) {
        float lsum = 0.f;
        for (int r = 0; r < kRowGroups; ++r)
          if (sm_m[r][g] != -INFINITY) lsum += sm_l[r][g] * expf(sm_m[r][g] - mx);
        part_m[part * group + g] = mx;
        part_l[part * group + g] = lsum;
      }
      __syncthreads();
    }
  }
}

// grid (B, H), block D: merge the live splits of one (stream, head).
__global__ void paged_decode_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     const int* __restrict__ kv_len,
                                     __nv_bfloat16* __restrict__ out,  // [B, H, D]
                                     int group, int n_splits, int split_len,
                                     int max_len) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int heads = gridDim.y, head_dim = blockDim.x;
  const int kh = h / group, g = h % group;
  const int kv_heads = heads / group;
  const int limit = max(0, min(kv_len[b], max_len));
  const int live = (limit + split_len - 1) / split_len;
  const size_t base = ((size_t)b * kv_heads + kh) * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, part_m[(base + s) * group + g]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < live; ++s) {
    const size_t i = (base + s) * group + g;
    const float w = expf(part_m[i] - mx);
    lsum += part_l[i] * w;
    a += part_acc[i * head_dim + d] * w;
  }
  out[((size_t)b * heads + h) * head_dim + d] =
      __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
}

template <typename T, int D, bool kQuant>
void launch_split(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                  const void* v, const void* ks, const void* vs, const int* table,
                  const int* kv_len, float* part_m, float* part_l,
                  float* part_acc, int kv_heads, int group, int page_size,
                  int max_pages, int pages_per_split, float sm_scale) {
  paged_decode_split<T, D, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), table, kv_len, part_m, part_l,
      part_acc, kv_heads, group, page_size, max_pages, pages_per_split,
      sm_scale);
}

template <int D>
void launch_dim(bool quant, dim3 grid, cudaStream_t stream, const void* q,
                const void* k, const void* v, const void* ks, const void* vs,
                const int* table, const int* kv_len, float* part_m,
                float* part_l, float* part_acc, int kv_heads, int group,
                int page_size, int max_pages, int pages_per_split,
                float sm_scale) {
  if (quant)
    launch_split<int8_t, D, true>(grid, stream, q, k, v, ks, vs, table, kv_len,
                                  part_m, part_l, part_acc, kv_heads, group,
                                  page_size, max_pages, pages_per_split, sm_scale);
  else
    launch_split<__nv_bfloat16, D, false>(grid, stream, q, k, v, ks, vs, table,
                                          kv_len, part_m, part_l, part_acc,
                                          kv_heads, group, page_size, max_pages,
                                          pages_per_split, sm_scale);
}

}  // namespace

// Launches the split pass and the combine on `stream`; returns
// cudaGetLastError() (0 on success). The caller validates shapes, dtypes,
// contiguity and alignment and allocates out and the partials.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* kv_len, void* out,
    void* part_m, void* part_l, void* part_acc, int batch, int heads,
    int kv_heads, int head_dim, int page_size, int max_pages,
    int pages_per_split, int n_splits, int quantized, float sm_scale,
    void* stream_handle) {
  if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || page_size < 1 || max_pages < 1 ||
      pages_per_split < 1 || n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = heads / kv_heads;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 grid(batch, kv_heads, n_splits);
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(kv_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  const bool quant = quantized != 0;
  switch (head_dim) {
    case 64:
      launch_dim<64>(quant, grid, stream, q, k, v, k_scale, v_scale, tbl, lens,
                     pm, pl, pa, kv_heads, group, page_size, max_pages,
                     pages_per_split, sm_scale);
      break;
    case 128:
      launch_dim<128>(quant, grid, stream, q, k, v, k_scale, v_scale, tbl, lens,
                      pm, pl, pa, kv_heads, group, page_size, max_pages,
                      pages_per_split, sm_scale);
      break;
    case 256:
      launch_dim<256>(quant, grid, stream, q, k, v, k_scale, v_scale, tbl, lens,
                      pm, pl, pa, kv_heads, group, page_size, max_pages,
                      pages_per_split, sm_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine<<<dim3(batch, heads), head_dim, 0, stream>>>(
      pm, pl, pa, lens, static_cast<__nv_bfloat16*>(out), group, n_splits,
      pages_per_split * page_size, max_pages * page_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_decode_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
