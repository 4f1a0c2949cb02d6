// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// recomputation scheme in two kernels, dK/dV and dQ.
//
// Replaces the Pallas TPU kernels `_bwd_dkdv_kernel` and `_bwd_dq_kernel`
// of dcos_commons_tpu/ops/flash_attention.py (reached through
// `_flash_backward`). Both recompute P = exp(q.k * scale - lse) tile by
// tile from the forward's saved lse [B, H, Sq] and take
// delta = rowsum(dO * O) [B, H, Sq] (fp32, computed by the caller);
// dS = P * (dP - delta) * scale with dP = dO.v. Causal and ragged masks,
// q_offset and the dead-row rule are the forward's: a row whose saved lse
// is -1e30 gets P = 0 (never exp(s + 1e30)) and so dq = 0.
//
// Bound. Per layer of the Llama-400m train step (B=16, S=511, H=12, KV=6,
// D=128) the backward does ~2.5x the forward's products (~0.033 ms on the
// tensor cores) and moves ~150 MB of q, k, v, o, dO, dq, dk, dv (~0.045 ms
// at 3.35 TB/s): bound by bytes, the tensor cores close behind.
//
// Design.
// * dK/dV (`flash_bwd_dkdv`): one block of 4 warps per (64-key tile, KV
//   head, batch); each warp owns 16 keys and keeps their dK and dV rows in
//   registers. The block loops over the query heads of its KV group and
//   over the live 64-row q tiles (causal: none entirely above the
//   diagonal), copying Q, dO, lse and delta into shared memory, and
//   computes S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q on bf16
//   tensor cores in 32-query halves. Summing the group inside the block,
//   instead of writing per-q-head dK/dV as the TPU kernel does, needs no
//   atomics, so the result is the same from run to run.
// * dQ (`flash_bwd_dq`): one block per (64-row q tile, head, batch), the
//   forward's layout; each warp keeps its 16 rows of dQ in registers
//   while the block walks the live key tiles: S = Q K^T, dP = dO V^T,
//   dQ += dS K.
// Scores and P never touch device memory. Synchronous tile copies, no
// TMA, no wgmma: left for later work. At head_dim 256 the dK/dV
// accumulators exceed the register file and spill.

#include "flash_attention_common.cuh"

namespace {

using namespace fa;

// grid (ceil(Sk / 64), KV, B), block kThreads, dynamic smem 4 tiles + 2 x
// 64 floats.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_q,
               int seq_k, int heads, int kv_heads, float sm_scale,
               int causal, int q_offset) {
  constexpr int ld = D + kPad;
  constexpr int kHalf = 32;         // query columns per pass
  constexpr int kN = kHalf / 8;     // 8-column score tiles per pass
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kTile * ld;
  bf16* s_q = s_v + kTile * ld;
  bf16* s_do = s_q + kTile * ld;
  float* s_lse = reinterpret_cast<float*>(s_do + kTile * ld);
  float* s_delta = s_lse + kTile;

  const int k0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int key_lo = k0 + warp * 16 + g;  // this thread's two keys
  const int keys[2] = {key_lo, key_lo + 8};
  const float scale_log2 = sm_scale * kLog2e;

  load_tile<D>(s_k, k, b, k0, seq_k, kv_heads, kh, tid);
  load_tile<D>(s_v, v, b, k0, seq_k, kv_heads, kh, tid);
  // causal: query row i sees key k0 only if q_offset + i >= k0
  int qt_begin = 0;
  if (causal) {
    const int first = k0 - q_offset;
    qt_begin = first > 0 ? first / kTile : 0;
  }
  const int n_qt = (seq_q + kTile - 1) / kTile;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int hg = 0; hg < group; ++hg) {
    const int h = kh * group + hg;
    const size_t stat = (static_cast<size_t>(b) * heads + h) * seq_q;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D>(s_q, q, b, q0, seq_q, heads, h, tid);
      load_tile<D>(s_do, dout, b, q0, seq_q, heads, h, tid);
      if (tid < kTile) {
        const int row = q0 + tid;
        s_lse[tid] = row < seq_q ? lse[stat + row] : kNegLse;
      } else if (tid < 2 * kTile) {
        const int row = q0 + tid - kTile;
        s_delta[tid - kTile] = row < seq_q ? delta[stat + row] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += kHalf) {
        float st[kN][4], dpt[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          load_a(ak, s_k, ld, warp * 16, kk * 16, g, tq);
          load_a(av, s_v, ld, warp * 16, kk * 16, g, tq);
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            uint32_t b0, b1;
            load_b_rows(b0, b1, s_q, ld, c0 + n * 8, kk * 16, g, tq);
            mma(st[n], ak, b0, b1);
            load_b_rows(b0, b1, s_do, ld, c0 + n * 8, kk * 16, g, tq);
            mma(dpt[n], av, b0, b1);
          }
        }
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + n * 8 + 2 * tq + (e & 1);
            const int row = q0 + c;
            const int key = keys[e >> 1];
            const float row_lse = s_lse[c];
            const bool live = row < seq_q && key < seq_k &&
                              (!causal || key <= q_offset + row) &&
                              row_lse > kDeadLse;
            const float p =
                live ? exp2f(st[n][e] * scale_log2 - row_lse * kLog2e) : 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - s_delta[c]) * sm_scale;
          }
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
          uint32_t ap[4], ads[4];
          c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
          c_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            uint32_t b0, b1;
            load_b_cols(b0, b1, s_do, ld, c0 + kk * 16, n * 8, g, tq);
            mma(acc_v[n], ap, b0, b1);
            load_b_cols(b0, b1, s_q, ld, c0 + kk * 16, n * 8, g, tq);
            mma(acc_k[n], ads, b0, b1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = keys[i];
    if (key >= seq_k) continue;
    const size_t off =
        ((static_cast<size_t>(b) * seq_k + key) * kv_heads + kh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

// grid (ceil(Sq / 64), H, B), block kThreads, dynamic smem 4 tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int seq_q, int seq_k, int heads,
             int kv_heads, float sm_scale, int causal, int q_offset) {
  constexpr int ld = D + kPad;
  constexpr int kHalf = 32;         // keys per pass
  constexpr int kN = kHalf / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + kTile * ld;
  bf16* s_k = s_do + kTile * ld;
  bf16* s_v = s_k + kTile * ld;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_lo = q0 + warp * 16 + g;
  const int rows[2] = {row_lo, row_lo + 8};
  const float scale_log2 = sm_scale * kLog2e;

  load_tile<D>(s_q, q, b, q0, seq_q, heads, h, tid);
  load_tile<D>(s_do, dout, b, q0, seq_q, heads, h, tid);
  const size_t stat = (static_cast<size_t>(b) * heads + h) * seq_q;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < seq_q;
    row_lse[i] = in ? lse[stat + rows[i]] : kNegLse;
    row_delta[i] = in ? delta[stat + rows[i]] : 0.f;
  }
  int k_end = seq_k;
  if (causal) k_end = min(seq_k, q_offset + q0 + kTile);
  const int n_kt = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(s_k, k, b, k0, seq_k, kv_heads, kh, tid);
    load_tile<D>(s_v, v, b, k0, seq_k, kv_heads, kh, tid);
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kHalf) {
      float s[kN][4], dp[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ado[4];
        load_a(aq, s_q, ld, warp * 16, kk * 16, g, tq);
        load_a(ado, s_do, ld, warp * 16, kk * 16, g, tq);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, s_k, ld, c0 + n * 8, kk * 16, g, tq);
          mma(s[n], aq, b0, b1);
          load_b_rows(b0, b1, s_v, ld, c0 + n * 8, kk * 16, g, tq);
          mma(dp[n], ado, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c0 + n * 8 + 2 * tq + (e & 1);
          const int i = e >> 1;
          const bool live = rows[i] < seq_q && col < seq_k &&
                            (!causal || col <= q_offset + rows[i]) &&
                            row_lse[i] > kDeadLse;
          const float p =
              live ? exp2f(s[n][e] * scale_log2 - row_lse[i] * kLog2e) : 0.f;
          s[n][e] = p * (dp[n][e] - row_delta[i]) * sm_scale;  // dS
        }
#pragma unroll
      for (int kk = 0; kk < kHalf / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b_cols(b0, b1, s_k, ld, c0 + kk * 16, n * 8, g, tq);
          mma(acc[n], a, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= seq_q) continue;
    bf16* out = dq + ((static_cast<size_t>(b) * seq_q + row) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, seq_q, seq_k, heads, kv_heads;
  float sm_scale;
  int causal, q_offset;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkdv(const Args& a, bf16* dk, bf16* dv) {
  const int smem =
      4 * tile_bytes<D>() + 2 * kTile * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(flash_bwd_dkdv<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_k + kTile - 1) / kTile, a.kv_heads, a.batch);
  flash_bwd_dkdv<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.seq_q, a.seq_k,
      a.heads, a.kv_heads, a.sm_scale, a.causal, a.q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  const int smem = 4 * tile_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + kTile - 1) / kTile, a.heads, a.batch);
  flash_bwd_dq<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.seq_q, a.seq_k, a.heads,
      a.kv_heads, a.sm_scale, a.causal, a.q_offset);
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
  return Args{static_cast<const bf16*>(q),
              static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),
              static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              batch, seq_q, seq_k, heads, kv_heads, sm_scale, causal,
              q_offset, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success). The caller validates shapes, dtypes,
// contiguity and alignment and allocates the outputs: dk/dv
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
