// Flash-attention forward for Hopper (sm_90a): causal or full GQA
// attention with online softmax, saving O (bf16) and the per-row
// logsumexp (fp32) for the backward.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// dcos_commons_tpu/ops/flash_attention.py (reached through
// `_flash_forward`). Same semantics, not the same blocking: q [B, Sq, H, D]
// against k/v [B, Sk, KV, D], query head h reads KV head h / (H / KV);
// query row i sits at position q_offset + i and, when causal, sees keys
// j <= q_offset + i. A row that sees no key gets output 0 and lse -1e30.
// lse is [B, H, Sq], not the TPU's 8 copied sublanes. Any Sq and Sk: the
// ragged tail is masked here, not refused.
//
// Bound. Per layer of the Llama-400m train step (B=16, S=511, H=12, KV=6,
// D=128) the causal products are ~13 GFLOP (0.013 ms at 989 TFLOP/s)
// against ~75 MB of q/k/v/o (0.022 ms at 3.35 TB/s): bound by bytes, with
// the tensor cores close behind, so the products must run on them.
//
// Design. One block of 4 warps per (64-row q tile, head, batch); each warp
// owns 16 query rows. The block walks the live 64-key tiles (causal: none
// above the diagonal), copying K and V into padded shared memory; S = Q K^T
// and O += P V run on bf16 tensor cores (mma.sync m16n8k16, fp32
// accumulation). Scores, the running max and sum, and O stay in registers
// in the mma fragment layout; P turns into the next product's A operand
// without leaving them. Exponentials are base 2 with the scale folded in.
// Nothing of size Sq x Sk touches device memory. Synchronous tile copies,
// no TMA, no wgmma, no pipelining: left for later work.

#include "flash_attention_common.cuh"

namespace {

using namespace fa;

// grid (ceil(Sq / 64), H, B), block kThreads, dynamic smem 3 tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o,
          float* __restrict__ lse, int seq_q, int seq_k, int heads,
          int kv_heads, float scale_log2, int causal, int q_offset) {
  constexpr int ld = D + kPad;
  constexpr int kN = kTile / 8;  // 8-key score tiles per warp row block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kTile * ld;
  bf16* s_v = s_k + kTile * ld;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_lo = q0 + warp * 16 + g;  // this thread's two query rows
  const int rows[2] = {row_lo, row_lo + 8};

  load_tile<D>(s_q, q, b, q0, seq_q, heads, h, tid);
  int k_end = seq_k;  // keys past k_end are dead for every row of the tile
  if (causal) k_end = min(seq_k, q_offset + q0 + kTile);
  const int n_kt = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(s_k, k, b, k0, seq_k, kv_heads, kh, tid);
    load_tile<D>(s_v, v, b, k0, seq_k, kv_heads, kh, tid);
    __syncthreads();

    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, s_q, ld, warp * 16, kk * 16, g, tq);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, s_k, ld, n * 8, kk * 16, g, tq);
        mma(s[n], a, b0, b1);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        const int row = rows[e >> 1];
        const bool live = col < seq_k && (!causal || col <= q_offset + row);
        s[n][e] = live ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with no live key so far keeps max -inf: subtract 0 instead,
      // so every exponential below is exp2(-inf) = 0, never NaN
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, s_v, ld, kk * 16, n * 8, g, tq);
        mma(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= seq_q) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* out = o + ((static_cast<size_t>(b) * seq_q + row) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tq == 0)
      lse[(static_cast<size_t>(b) * heads + h) * seq_q + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : kNegLse;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq_q, int seq_k, int heads,
                   int kv_heads, float sm_scale, int causal, int q_offset,
                   cudaStream_t stream) {
  const int smem = 3 * tile_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kTile - 1) / kTile, heads, batch);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), seq_q, seq_k, heads, kv_heads,
      sm_scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace

// Launches the forward on `stream`; returns cudaGetLastError() (0 on
// success). The caller validates shapes, dtypes, contiguity and alignment
// and allocates o [B, Sq, H, D] bf16 and lse [B, H, Sq] fp32.
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
