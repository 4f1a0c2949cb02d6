"""Llama decoder (port of ``dcos_commons_tpu/models/llama.py``): the
serving subset and the train forward.

Serving: the config presets, parameter init, the page pool, and the two
paged forwards, ``decode_step_paged`` and ``prefill_chunk_paged``.
Training: ``forward`` (full sequences, causal attention through the
flash-attention kernels or the dense path, optional per-layer remat)
and ``loss_fn`` (next-token loss, fused linear cross-entropy by
default). Parameters are a plain dict of tensors with the JAX pytree's
keys and its stacked ``[L, ...]`` ``x @ W`` layout; the reference's
``lax.scan`` over layers is a Python loop. bf16 weights and
activations, fp32 softmax, norms and logits, with the casts where the
reference places them.

Unlike the reference, whose arrays are immutable, the paged forwards
write K/V into the pool IN PLACE (the pool dominates device memory) and
return the same pool object.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import gqa_attention
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import flash_decode_paged, supports_decode_paged
from ..ops.losses import fused_linear_cross_entropy, softmax_cross_entropy
from ..ops.norms import rms_norm
from ..ops.quant import QArray, QTensor, dequantize, qmm, qtake, quantize
from ..ops.rotary import (apply_rope, apply_rope_at, apply_rope_positions,
                          rope_frequencies)

Params = Dict[str, Any]
Pool = Dict[str, QArray]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # train attention: auto | dense | flash (ring | ulysses raise until
    # ported). auto = the flash-attention kernels on a CUDA device (a
    # shape or dtype outside their gate raises), the dense path on the
    # CPU; flash forces the kernel wrapper (its plain version on CPU)
    attn_impl: str = "auto"
    dtype: torch.dtype = torch.bfloat16
    # recompute each layer's activations in the backward (full remat);
    # a selective remat_policy is not ported yet
    remat: bool = True
    remat_policy: Optional[str] = None
    # int8 KV pages (per-position, per-head scales)
    kv_quant: bool = False
    # paged decode attention: auto | dense | flash. auto = the CUDA
    # kernel on a CUDA device (a shape outside its gate raises), dense
    # gather + gqa_attention on the CPU; flash forces the kernel wrapper
    # (which runs its plain version on CPU tensors)
    decode_attn: str = "auto"
    # fused linear cross-entropy on the train loss head (ops/losses.py):
    # the [B, S, V] fp32 logits never materialize
    fused_ce: bool = True
    # sequence chunk of the fused loss (S need not divide it)
    fused_ce_block: int = 512

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama_400m(cls, **kw) -> "LlamaConfig":
        """The mid-size bench/operator preset (~306M params)."""
        defaults = dict(vocab_size=32000, dim=1536, n_layers=8,
                        n_heads=12, n_kv_heads=6, ffn_dim=4096,
                        max_seq=512, remat=False)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """4-layer toy config for tests."""
        defaults = dict(vocab_size=256, dim=64, n_layers=4, n_heads=8,
                        n_kv_heads=4, ffn_dim=128, max_seq=128, remat=False)
        defaults.update(kw)
        return cls(**defaults)


# ---------------------------------------------------------------------------
# parameters

# rows of fp32 noise drawn at once: bounds the temporary next to the
# bf16 result (an 8B init never holds a whole fp32 weight stack)
_INIT_ROWS = 1 << 14


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Scaled-normal init with the reference's shapes and scales; stacked
    [L, ...] layer weights. ``generator`` must live on ``device``. Torch
    and JAX draw different numbers from one seed: parity tests take the
    JAX weights through ``models.bridge.params_from_jax`` instead."""
    dev = resolve_device(device)
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    dt = cfg.dtype

    def norm2(*shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        out = torch.empty(shape, dtype=dt, device=dev)
        rows = out.view(-1, shape[-1])
        for i in range(0, rows.shape[0], _INIT_ROWS):
            n = min(_INIT_ROWS, rows.shape[0] - i)
            rows[i:i + n] = (torch.randn(
                (n, shape[-1]), generator=generator, dtype=torch.float32,
                device=dev) * scale).to(dt)
        return out

    return {
        "embed": norm2(cfg.vocab_size, d, scale=d ** -0.5),
        "layers": {
            "attn_norm": torch.ones((L, d), dtype=dt, device=dev),
            "wq": norm2(L, d, qd),
            "wk": norm2(L, d, kvd),
            "wv": norm2(L, d, kvd),
            "wo": norm2(L, qd, d, scale=(qd ** -0.5) / (2 * L) ** 0.5),
            "ffn_norm": torch.ones((L, d), dtype=dt, device=dev),
            "w_gate": norm2(L, d, f),
            "w_up": norm2(L, d, f),
            "w_down": norm2(L, f, d, scale=(f ** -0.5) / (2 * L) ** 0.5),
        },
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": norm2(d, cfg.vocab_size),
    }


# ---------------------------------------------------------------------------
# block-paged KV: a fixed pool of pages + per-stream page tables


def init_page_pool(cfg: LlamaConfig, pages: int, page_size: int,
                   device: DeviceLike = "cuda") -> Pool:
    """KV page pool [L, pages, page_size, KV, D] (int8 payload +
    per-position bf16 scales under ``cfg.kv_quant``). Who owns which
    page is host bookkeeping (``models.paging.PagePool``)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return {side: QTensor(torch.zeros(shape, dtype=torch.int8,
                                          device=dev),
                              torch.zeros(sshape, dtype=torch.bfloat16,
                                          device=dev))
                for side in ("k", "v")}
    return {side: torch.zeros(shape, dtype=cfg.dtype, device=dev)
            for side in ("k", "v")}


def _gather_pages(cache: QArray, table: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Reassemble a per-layer pool [P, ps, KV, D] into logical-order
    views [B, MP*ps, KV, D] through ``table`` [B, MP]: the dense-path
    attention read. int8 pages dequantize to ``dtype`` BEFORE attention,
    as the reference's dense read does."""
    tbl = table.long()
    if isinstance(cache, QTensor):
        view = dequantize(QTensor(cache.q[tbl], cache.s[tbl]), dtype)
    else:
        view = cache[tbl]
    b, mp, ps, kv, d = view.shape
    return view.reshape(b, mp * ps, kv, d)


def _page_write(cache: QArray, rows: torch.Tensor, phys: torch.Tensor,
                offs: torch.Tensor) -> None:
    """Scatter K/V ``rows`` [N, KV, D] into a per-layer pool at
    (``phys[i]``, ``offs[i]``) in place, quantizing when the pool is
    int8. Duplicate targets only ever hit the scratch page, whose
    content nothing reads, so no ``accumulate``."""
    idx = (phys.long(), offs.long())
    if isinstance(cache, QTensor):
        nq = quantize(rows, axis=-1)
        cache.q.index_put_(idx, nq.q)
        cache.s.index_put_(idx, nq.s.to(cache.s.dtype))
    else:
        cache.index_put_(idx, rows.to(cache.dtype))


def _use_flash_decode_paged(cfg: LlamaConfig, device: torch.device) -> bool:
    """Route the paged decode step's attention: ``auto`` takes the CUDA
    kernel on a CUDA device and the dense gather on the CPU; ``flash``
    forces the kernel wrapper; ``dense`` the gather."""
    mode = cfg.decode_attn
    if mode not in ("auto", "dense", "flash"):
        # a typo'd mode must not silently measure the dense path
        raise ValueError(f"decode_attn={mode!r}: expected one of 'auto', "
                         "'dense', 'flash'")
    if mode == "dense":
        return False
    return mode == "flash" or device.type == "cuda"


def _decode_body(cfg: LlamaConfig, params: Params, pool: Pool,
                 tokens: torch.Tensor, rope_fn: Callable, cache_write,
                 attn: Callable, logit_index: Optional[int] = None
                 ) -> torch.Tensor:
    """The cache-consuming forward shared by the paged decode step and
    the paged prefill chunk: they differ only in how rope is applied,
    where K/V rows land (``cache_write(pool_layer, rows)``) and the
    attention read (``attn(q, k_pool_layer, v_pool_layer)``).

    ``tokens`` [B, S]; returns fp32 logits [B, V] at the last position,
    or at ``logit_index`` (a padded prefill chunk's last live token)."""
    b, s = tokens.shape
    layers = params["layers"]
    x = qtake(params["embed"], tokens, cfg.dtype)               # [B, S, D]
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        k_cache, v_cache = pool["k"][i], pool["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = qmm(h, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = qmm(h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = qmm(h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = rope_fn(q)
        k = rope_fn(k)
        cache_write(k_cache, k)
        cache_write(v_cache, v)
        o = attn(q, k_cache, v_cache)
        x = x + qmm(o.reshape(b, s, -1), lp["wo"])
        x = ffn_block(cfg, x, lp)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    x = x[:, -1, :] if logit_index is None else x[:, logit_index, :]
    return qmm(x, params["lm_head"]).float()


def _pool_page_size(pool: Pool) -> int:
    k = pool["k"]
    return (k.q if isinstance(k, QTensor) else k).shape[2]


def decode_step_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                      table: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor,
                      rope: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Pool]:
    """One decode step against the paged pool.

    ``tokens``/``lengths`` [B] int32; ``table`` [B, MP] int32 maps each
    stream's logical page to a physical pool page. Stream b's new K/V
    row lands at (table[b, lengths[b] // ps], lengths[b] % ps) and it
    attends to ``lengths[b] + 1`` positions, through the CUDA kernel or
    the dense gather (:func:`_use_flash_decode_paged`). Inactive
    streams point their table rows at a scratch page. Returns (logits
    [B, V] fp32, pool updated in place)."""
    if rope is None:
        rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=tokens.device)
    ps = _pool_page_size(pool)
    mp = table.shape[1]
    # clip: a stream retired mid-window keeps advancing past its table;
    # its row is all scratch, so the clipped write lands there
    page_idx = torch.clamp(lengths // ps, 0, mp - 1).long()
    phys = torch.gather(table, 1, page_idx[:, None])[:, 0]
    offs = lengths % ps
    kv_len = (lengths + 1).to(torch.int32)
    flash = _use_flash_decode_paged(cfg, tokens.device)

    def cache_write(cache, new):
        _page_write(cache, new[:, 0], phys, offs)

    def attn(q, k_cache, v_cache):
        if flash:
            if not supports_decode_paged(q, k_cache, ps):
                raise ValueError(
                    f"decode_attn={cfg.decode_attn!r}: the paged decode "
                    f"kernel does not take head_dim {cfg.head_dim} with "
                    f"{cfg.n_heads // cfg.n_kv_heads} query heads per KV "
                    "head; use decode_attn='dense'")
            return flash_decode_paged(q, k_cache, v_cache, table, kv_len)
        k_read = _gather_pages(k_cache, table, cfg.dtype)
        v_read = _gather_pages(v_cache, table, cfg.dtype)
        return gqa_attention(q, k_read, v_read, causal=False, kv_len=kv_len)

    logits = _decode_body(cfg, params, pool, tokens[:, None],
                          rope_fn=lambda t: apply_rope_at(t, rope, lengths),
                          cache_write=cache_write, attn=attn)
    return logits, pool


def prefill_chunk_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                        table: torch.Tensor, tokens: torch.Tensor,
                        start: int, true_len: int, logit_index: int,
                        scratch_page: int,
                        rope: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Pool]:
    """One CHUNK of paged prefill for a single stream: ``tokens`` [1, C]
    occupy positions ``start..start+C-1``, K/V landing through ``table``
    [MP]. Returns (logits [1, V] at chunk index ``logit_index``, the
    pool updated in place). Padded positions at/after ``true_len`` write
    to ``scratch_page``; attention gathers the stream's pages in logical
    order, causal from ``start``."""
    if rope is None:
        rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=tokens.device)
    ps = _pool_page_size(pool)
    mp = table.shape[0]
    c = tokens.shape[1]
    dev = tokens.device
    positions = start + torch.arange(c, dtype=torch.int32, device=dev)
    live = positions < true_len
    page_idx = torch.clamp(positions // ps, 0, mp - 1).long()
    phys = torch.where(live, table[page_idx],
                       torch.full_like(positions, scratch_page))
    offs = positions % ps
    table_b = table[None]                                     # [1, MP]
    # rotate per lane: a resumed chunk may overrun the table; its dead
    # tail lanes saturate, the live head rotates at its true positions
    rope_pos = torch.clamp(positions, 0, rope.shape[1] - 1)

    def cache_write(cache, new):
        _page_write(cache, new[0], phys, offs)

    def attn(q, k_cache, v_cache):
        k_read = _gather_pages(k_cache, table_b, cfg.dtype)
        v_read = _gather_pages(v_cache, table_b, cfg.dtype)
        return gqa_attention(q, k_read, v_read, causal=True,
                             q_offset=start, kv_len=start + c)

    logits = _decode_body(
        cfg, params, pool, tokens,
        rope_fn=lambda t: apply_rope_positions(t, rope, rope_pos),
        cache_write=cache_write, attn=attn, logit_index=logit_index)
    return logits, pool


# ---------------------------------------------------------------------------
# train forward


def _make_attn_fn(cfg: LlamaConfig, device: torch.device) -> Callable:
    """f(q, k, v) for q [B, S, H, D], k/v [B, S, KV, D], causal.

    ``auto`` takes the flash-attention kernels on a CUDA device and the
    dense path on the CPU; ``flash`` forces the kernel wrapper; ``dense``
    the dense path. Unlike the reference, a shape or dtype the kernels do
    not take raises on CUDA instead of going dense (``supports`` is the
    kernels' gate, not a router)."""
    impl = cfg.attn_impl
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported yet (ROADMAP Queue 1 item 9)")
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"attn_impl={impl!r}: expected one of 'auto', "
                         "'dense', 'flash'")
    if impl == "flash" or (impl == "auto" and device.type == "cuda"):
        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    return lambda q, k, v: gqa_attention(q, k, v, causal=True)


def attention_block(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
                    rope: torch.Tensor, attn_fn: Callable) -> torch.Tensor:
    """Pre-norm attention residual step on x [B, S, D]."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = qmm(h, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = qmm(h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = qmm(h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    o = attn_fn(q, k, v)             # GQA expansion is the impl's business
    return x + qmm(o.reshape(b, s, -1), lp["wo"])


def ffn_block(cfg: LlamaConfig, x: torch.Tensor, lp: Params) -> torch.Tensor:
    """Pre-norm SwiGLU residual step on x [B, S, D]; silu in fp32 on the
    matmul output, as the reference."""
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    gate = F.silu(qmm(h, lp["w_gate"]).float())
    up = qmm(h, lp["w_up"]).float()
    return x + qmm((gate * up).to(cfg.dtype), lp["w_down"])


def apply_layer(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
                rope: torch.Tensor, attn_fn: Callable) -> torch.Tensor:
    """One decoder layer on activations x [B, S, D]."""
    return ffn_block(cfg, attention_block(cfg, x, lp, rope, attn_fn), lp)


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] fp32, or with
    ``return_hidden`` the final-norm hidden states [B, S, D] (the fused
    loss's input). ``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant)."""
    if cfg.remat and cfg.remat_policy:
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet "
            "(ROADMAP Queue 1 item 2)")
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=tokens.device)
    attn_fn = _make_attn_fn(cfg, tokens.device)
    layers = params["layers"]
    x = qtake(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        if cfg.remat:
            x = torch.utils.checkpoint.checkpoint(
                apply_layer, cfg, x, lp, rope, attn_fn, use_reentrant=False)
        else:
            x = apply_layer(cfg, x, lp, rope, attn_fn)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if return_hidden:
        return x
    return qmm(x, params["lm_head"]).float()


def loss_fn(cfg: LlamaConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token LM loss over tokens [B, S] -> (loss, accuracy), with
    z-loss 1e-4. ``cfg.fused_ce`` (the default) runs the lm_head inside
    ``fused_linear_cross_entropy``'s sequence-blocked loop."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.fused_ce:
        x = forward(cfg, params, inputs, return_hidden=True)
        return fused_linear_cross_entropy(
            x, params["lm_head"], targets, z_loss=1e-4,
            block_size=cfg.fused_ce_block)
    logits = forward(cfg, params, inputs)
    return softmax_cross_entropy(logits, targets, z_loss=1e-4)
