// Slot-cache flash-decode for Hopper (sm_90a): one query position per slot
// against a padded per-slot K/V cache, bf16 or int8.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// dcos_commons_tpu/ops/flash_decode.py, reached through `flash_decode`
// (the decode attention of `decode_step` and `decode_step_slots`). Same
// semantics, not the same blocking: position p of slot b lives at
// cache[b, p, h, :], row ((b * S + p) * KV + h) of the contiguous
// [B, S, KV, D] cache, read in place (the TPU wrapper's transposed cache
// and 8-sublane scale tiles are layout artifacts and are not made here).
// Slot b attends to positions [0, min(kv_len[b], S)); online softmax in
// fp32; int8 scales fold as (q . k_q) * s_k and (p * s_v) @ v_q, with
// p * s_v rounded to bf16 before it meets V, as the TPU kernel does; a
// slot with kv_len <= 0 gets output 0.
//
// Bound. Decode attention touches every live K/V row once and does
// 4 * group flops per K/V element pair: a few flops per byte, far below
// the ~295 flops/byte where the H100's bf16 tensor cores become the
// limit. It is bound by bytes: the live K/V rows (+ their int8 scales),
// q and out, over 3.35 TB/s. Rows past kv_len are never read, so the cost
// tracks each slot's own length, not S.
//
// Design. B=8 slots x KV=8 heads give only 64 (slot, head) pairs against
// 132 SMs, so the grid is (B, KV, splits): the wrapper cuts [0, S) into
// fixed ranges of `split_len` positions, their count taken from S and the
// SM count. A split that starts at or past min(kv_len[b], S) reads
// nothing and writes an empty partial; `decode_combine` merges the live
// ones. The split body and the combine are shared with the paged kernel
// (flash_decode_common.cuh). Tensor cores, TMA and wgmma are left for
// later work.

#include "flash_decode_common.cuh"

using namespace flash_decode;

namespace {

// grid (B, KV, n_splits), block kThreads.
template <typename T, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
slot_decode_split(const __nv_bfloat16* __restrict__ q,        // [B, H, D]
                  const T* __restrict__ k,                    // [B, S, KV, D]
                  const T* __restrict__ v,                    // [B, S, KV, D]
                  const __nv_bfloat16* __restrict__ k_scale,  // [B, S, KV] or null
                  const __nv_bfloat16* __restrict__ v_scale,  // [B, S, KV] or null
                  const int* __restrict__ kv_len,             // [B]
                  float* __restrict__ part_m,                 // [B, KV, n_splits, G]
                  float* __restrict__ part_l,                 // [B, KV, n_splits, G]
                  float* __restrict__ part_acc,               // [B, KV, n_splits, G, D]
                  int kv_heads, int group, int seq, int split_len,
                  float sm_scale) {
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const size_t part = ((size_t)b * kv_heads + kh) * gridDim.z + split;
  const int limit = max(0, min(kv_len[b], seq));
  const int p0 = split * split_len;
  const int p1 = min(p0 + split_len, limit);
  auto row_of = [=](int p) { return ((size_t)b * seq + p) * kv_heads + kh; };
  split_body<T, D, kQuant>(
      q + ((size_t)b * kv_heads + kh) * group * D, k, v, k_scale, v_scale,
      row_of, p0, p1, group, sm_scale, part_m + part * group,
      part_l + part * group, part_acc + part * group * D);
}

}  // namespace

// Launches the split pass and the combine on `stream`; returns
// cudaGetLastError() (0 on success). The caller validates shapes, dtypes,
// contiguity and alignment, broadcasts kv_len to [B] int32 and allocates
// out and the partials.
extern "C" int flash_decode_slots_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* part_m,
    void* part_l, void* part_acc, int batch, int heads, int kv_heads,
    int head_dim, int seq, int split_len, int n_splits, int quantized,
    float sm_scale, void* stream_handle) {
  if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || seq < 1 || split_len < 1 ||
      n_splits < 1 || (long long)split_len * n_splits < seq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = heads / kv_heads;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 grid(batch, kv_heads, n_splits);
  const int* lens = static_cast<const int*>(kv_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  const bool known = dispatch(head_dim, quantized != 0, [&](auto t, auto d, auto quant) {
    using T = typename decltype(t)::type;
    slot_decode_split<T, decltype(d)::value, decltype(quant)::value>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const __nv_bfloat16*>(k_scale),
            static_cast<const __nv_bfloat16*>(v_scale), lens, pm, pl, pa,
            kv_heads, group, seq, split_len, sm_scale);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<<<dim3(batch, heads), head_dim, 0, stream>>>(
      pm, pl, pa, lens, static_cast<__nv_bfloat16*>(out), group, n_splits,
      split_len, seq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_decode_slots_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
