// Paged flash-decode for Hopper (sm_90a): one query position per stream
// against a block-paged K/V pool, bf16 or int8 pages.
//
// Replaces the Pallas TPU kernel `_paged_kernel` (arithmetic body
// `_decode_kernel`) of dcos_commons_tpu/ops/flash_decode.py, reached
// through `flash_decode_paged`. Same semantics, not the same blocking:
// position p of stream b lives at pool[table[b, p / ps], p % ps, h, :];
// stream b attends to positions [0, min(kv_len[b], MP * ps)); online
// softmax in fp32; int8 scales fold exactly as the TPU kernel folds them,
// (q . k_q) * s_k and (p * s_v) @ v_q, with p * s_v rounded to bf16
// before it meets V; a stream with no live position gets output 0.
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
// into splits of whole pages and the grid is (B, KV, splits). The split
// body and the combine pass are shared with the slot-cache kernel
// (flash_decode_common.cuh); here a position's row is found through the
// page table. Tensor cores, TMA and wgmma are left for later work.

#include "flash_decode_common.cuh"

using namespace flash_decode;

namespace {

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
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const size_t part = ((size_t)b * kv_heads + kh) * gridDim.z + split;
  const int limit = max(0, min(kv_len[b], max_pages * page_size));
  const int p0 = split * pages_per_split * page_size;
  const int p1 = min(p0 + pages_per_split * page_size, limit);
  const int* trow = table + (size_t)b * max_pages;
  auto row_of = [=](int p) {
    return ((size_t)trow[p / page_size] * page_size + (p % page_size)) * kv_heads +
           kh;
  };
  split_body<T, D, kQuant>(
      q + ((size_t)b * kv_heads + kh) * group * D, k_pool, v_pool, k_scale,
      v_scale, row_of, p0, p1, group, sm_scale, part_m + part * group,
      part_l + part * group, part_acc + part * group * D);
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
  const bool known = dispatch(head_dim, quantized != 0, [&](auto t, auto d, auto quant) {
    using T = typename decltype(t)::type;
    paged_decode_split<T, decltype(d)::value, decltype(quant)::value>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const __nv_bfloat16*>(k_scale),
            static_cast<const __nv_bfloat16*>(v_scale), tbl, lens, pm, pl, pa,
            kv_heads, group, page_size, max_pages, pages_per_split, sm_scale);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<<<dim3(batch, heads), head_dim, 0, stream>>>(
      pm, pl, pa, lens, static_cast<__nv_bfloat16*>(out), group, n_splits,
      pages_per_split * page_size, max_pages * page_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_decode_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
