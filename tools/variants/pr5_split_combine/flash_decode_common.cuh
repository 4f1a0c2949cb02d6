// Split-KV flash-decode body shared by the paged kernel
// (flash_decode_paged.cu) and the slot-cache kernel (flash_decode_slots.cu).
// The two differ only in where position p of a stream's K/V lives; each
// passes its own `row_of(p)`, the index of that position's row (of D
// elements, one KV head) in the cache, and its own split ranges.
//
// One block takes one (stream, KV head, split). It walks the split's
// positions with one row group of D/8 threads per K/V row (16-byte bf16
// loads, 8-byte int8 loads), keeps the `group` query heads of its KV head
// in registers so every loaded row serves all of them, and keeps the
// online softmax in fp32. As the TPU kernel does, int8 scales fold as
// (q . k_q) * s_k and (p * s_v) @ v_q, and p * s_v is rounded to bf16
// before it meets V. Row groups merge in shared memory into one partial
// (m, l, acc) per query head; `decode_combine` merges a head's live splits.
// A split with no live position writes an empty partial (m=-inf, l=0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace flash_decode {

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

// The split [p0, p1) of one (stream, KV head): `q` points at the group's
// first query head ([group, D] bf16); `part_*` at this split's partial
// ([group], [group], [group, D] fp32). Call with the whole block.
template <typename T, int D, bool kQuant, typename RowOf>
__device__ __forceinline__ void split_body(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, RowOf row_of, int p0, int p1,
    int group, float sm_scale, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int kTpr = D / kVec;           // threads per row: 8, 16, 32
  constexpr int kRpw = 32 / kTpr;          // rows per warp
  constexpr int kRowGroups = kWarps * kRpw;
  __shared__ float sm_m[kRowGroups][kMaxGroup];
  __shared__ float sm_l[kRowGroups][kMaxGroup];
  __shared__ float sm_acc[kRowGroups][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp * kRpw + lane / kTpr;  // this thread's row group
  const int sub = lane % kTpr;               // its slice of the row
  if (p0 >= p1) {  // nothing live in this split: empty partial
    if (tid < group) {
      part_m[tid] = -INFINITY;
      part_l[tid] = 0.f;
    }
    return;
  }

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
    if (g < group) load8(q + (size_t)g * D + sub * kVec, qf[g]);
  }

  // every lane of a warp runs the same trip count (the row-group shuffles
  // need the whole warp); lanes past the split's end mask their update
  for (int base = p0 + warp * kRpw; base < p1; base += kRowGroups) {
    const int p = base + lane / kTpr;
    const bool live = p < p1;
    float kf[kVec], vf[kVec];
    float ks = 1.f, vs = 1.f;
    if (live) {
      const size_t row = row_of(p);
      load8(k + row * D + sub * kVec, kf);
      load8(v + row * D + sub * kVec, vf);
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
          const float pv =
              __bfloat162float(__float2bfloat16(kQuant ? pr * vs : pr));
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
        part_acc[(size_t)g * D + e] = a;
      }
      if (tid == 0) {
        float lsum = 0.f;
        for (int r = 0; r < kRowGroups; ++r)
          if (sm_m[r][g] != -INFINITY) lsum += sm_l[r][g] * expf(sm_m[r][g] - mx);
        part_m[g] = mx;
        part_l[g] = lsum;
      }
      __syncthreads();
    }
  }
}

// grid (B, H), block D: merge the live splits of one (stream, head). A
// stream sees positions [0, min(kv_len[b], max_len)), cut into splits of
// `split_len`; with none live its output is 0.
__global__ void decode_combine(const float* __restrict__ part_m,
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

template <typename T>
struct Tag {
  using type = T;
};

// Calls `launch(Tag<T>, integral_constant<int, D>, bool_constant<quant>)`
// for the runtime head_dim and cache type; false for a head_dim without
// an instance.
template <typename F>
bool dispatch(int head_dim, bool quant, F&& launch) {
  auto by_type = [&](auto d) {
    if (quant)
      launch(Tag<int8_t>{}, d, std::true_type{});
    else
      launch(Tag<__nv_bfloat16>{}, d, std::false_type{});
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

}  // namespace flash_decode
