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
// Design (flash_decode_common.cuh, shared with the slot-cache kernel): a
// persistent grid deals (stream, KV head, chunk) items sized by the live
// length, which each block reads on the device; a producer warp keeps a
// ring of K/V stages filled by 1-D bulk copies, one per row, each row's
// page looked up in the table (any page size, nothing encoded on the
// host); both products run on tensor cores; the block that finishes a
// (stream, KV head)'s last chunk merges its partials, so a call is one
// launch.

#include "flash_decode_common.cuh"

using namespace flash_decode;

namespace {

struct PagedRows {
  const int* table;  // [B, MP]
  int page_size, max_pages, kv_heads;
  __device__ __forceinline__ size_t operator()(int b, int kh, int p) const {
    // planted fault F3: every logical page is read through entry 0
    const int page = table[static_cast<size_t>(b) * max_pages];
    return (static_cast<size_t>(page) * page_size + p % page_size) * kv_heads +
           kh;
  }
};

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// kv_len: [B] int32. workspace and counters: ops/flash_decode.py::
// decode_plan sizes them, with max_partials and grid; counters are zero
// between launches. The caller validates shapes, dtypes, contiguity and
// alignment and allocates out.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* kv_len, void* out,
    void* workspace, void* counters, int batch, int heads, int kv_heads,
    int head_dim, int page_size, int max_pages, int max_partials, int grid,
    int quantized, float sm_scale, void* stream_handle) {
  if (page_size < 1 || max_pages < 1 ||
      static_cast<long long>(page_size) * max_pages > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const bf16*>(k_scale);
  p.v_scale = static_cast<const bf16*>(v_scale);
  p.lens = Lens{static_cast<const int*>(kv_len), 1, 0, page_size * max_pages};
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.batch = batch;
  p.kv_heads = kv_heads;
  p.max_partials = max_partials;
  return launch(p,
                PagedRows{static_cast<const int*>(table), page_size, max_pages,
                          kv_heads},
                heads, head_dim, quantized, sm_scale, grid, stream_handle);
}

extern "C" const char* flash_decode_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Version of the C interface above (2: the one-launch kernel with a kept
// workspace); tools/torch_bench_flash.py reads it to call older sources.
extern "C" int flash_decode_paged_abi() { return 2; }
