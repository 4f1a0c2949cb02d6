"""Llama decoder (port of ``dcos_commons_tpu/models/llama.py``): the
serving subset and the train forward.

Serving: the config presets, parameter init and int8 weights
(``quantize_params``), and two caches.

* The padded slot cache [L, B, max_seq, KV, D] (``init_kv_cache``):
  ``prefill`` / ``prefill_trunk`` write a prompt's K/V, ``decode_step``
  decodes every row at one position, ``decode_step_slots`` each row at
  its own; ``generate``, ``generate_stepwise``, ``generate_chunked`` and
  ``decode_chunk`` drive solo decode; ``extend_step`` consumes a K-token
  window at one position (the speculative verify of solo decoding).
* The page pool (``init_page_pool``) with ``decode_step_paged``,
  ``prefill_chunk_paged`` and ``verify_step_paged`` (a K-token window per
  stream: the engine's speculative verify).

``truncate_layers`` cuts a draft from the target's first layers.

Mixture of experts (serving): ``init_moe_params`` builds the routed tree
(``router``, ``w_in``, ``w_out`` in place of the dense FFN);
``make_moe_ffn`` is the ``ffn_override`` that the decode steps, the
paged prefill chunk and ``extend_step`` take, and
``generate_stepwise_moe`` the greedy reference the MoE engine is held
to.

Training: ``forward`` (full sequences, causal attention through the
flash-attention kernels or the dense path, optional per-layer remat)
and ``loss_fn`` (next-token loss, fused linear cross-entropy by
default). Parameters are a plain dict of tensors with the JAX pytree's
keys and its stacked ``[L, ...]`` ``x @ W`` layout; the reference's
``lax.scan`` over layers is a Python loop. bf16 weights and
activations, fp32 softmax, norms and logits, with the casts where the
reference places them.

Unlike the reference, whose arrays are immutable, the cache-consuming
forwards write K/V into the cache or pool IN PLACE (it dominates device
memory) and return the same object. The reference's silent index rules
are written out: a solo write past the cache's end clamps onto the last
rows (``dynamic_update_slice``), a per-slot write at a length >= max_seq
is dropped (``.at[].set``), and rope lookups past the table clamp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import gqa_attention
from ..ops.flash_attention import HEAD_DIMS, flash_attention
from ..ops.flash_decode import (flash_decode, flash_decode_paged,
                                supports_decode, supports_decode_paged)
from ..ops.losses import fused_linear_cross_entropy, softmax_cross_entropy
from ..ops.norms import rms_norm
from ..ops.quant import QArray, QTensor, dequantize, qmm, qtake, quantize
from ..ops.rotary import (apply_rope, apply_rope_at, apply_rope_at_many,
                          apply_rope_positions, rope_frequencies)
from ..parallel.moe import MoEConfig, moe_apply_local

Params = Dict[str, Any]
Pool = Dict[str, QArray]
Cache = Dict[str, QArray]
Sampler = Callable[[Optional[torch.Generator], torch.Tensor], torch.Tensor]
# x [B, S, D], one layer's params -> x after the FFN residual step
FfnOverride = Callable[[torch.Tensor, Params], torch.Tensor]


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
    # ported). On a CUDA device auto and flash take the flash-attention
    # kernels for every head_dim up to 256 (the reference's gate), zero-
    # padded to the kernels' widths, and the dense path beyond it; the
    # kernels take bf16 only, so an fp32 config raises there. On the
    # CPU auto is dense and flash runs the kernel wrapper (its plain
    # version). See :func:`attn_route`
    attn_impl: str = "auto"
    dtype: torch.dtype = torch.bfloat16
    # recompute each layer's activations in the backward (full remat);
    # a selective remat_policy is not ported yet
    remat: bool = True
    remat_policy: Optional[str] = None
    # int8 KV cache and pages (per-position, per-head scales)
    kv_quant: bool = False
    # decode attention (slot cache and paged pool): auto | dense | flash.
    # auto = the CUDA kernel on a CUDA device (a shape outside its gate
    # raises), the dense read + gqa_attention on the CPU; flash forces
    # the kernel wrapper (which runs its plain version on CPU tensors).
    # It also routes slot prefill's attention: the flash-attention
    # forward kernel where decode takes the kernel, dense elsewhere
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


def param_template(cfg: LlamaConfig, device: DeviceLike = "cuda",
                   num_experts: int = 0) -> Params:
    """The parameter tree of uninitialised tensors: the reference's keys,
    shapes (stacked [L, ...] layer weights) and ``cfg.dtype``.
    :func:`init_params` fills it; a checkpoint restore takes it as its
    template, with no random draws. With ``num_experts`` the tree of
    :func:`init_moe_params`: the dense FFN (never allocated) replaced by
    ``router`` [L, D, E] fp32, ``w_in`` [L, E, D, F] and ``w_out``
    [L, E, F, D]."""
    dev = resolve_device(device)
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim

    def e(*shape, dtype=cfg.dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    if num_experts:
        ffn = {"router": e(L, d, num_experts, dtype=torch.float32),
               "w_in": e(L, num_experts, d, f),
               "w_out": e(L, num_experts, f, d)}
    else:
        ffn = {"w_gate": e(L, d, f), "w_up": e(L, d, f),
               "w_down": e(L, f, d)}
    return {
        "embed": e(cfg.vocab_size, d),
        "layers": {"attn_norm": e(L, d), "wq": e(L, d, qd),
                   "wk": e(L, d, kvd), "wv": e(L, d, kvd),
                   "wo": e(L, qd, d), "ffn_norm": e(L, d), **ffn},
        "norm": e(d),
        "lm_head": e(d, cfg.vocab_size),
    }


def _normal_(out: torch.Tensor, generator: torch.Generator,
             scale: Optional[float] = None) -> None:
    """Fill ``out`` in place with scaled normal noise, drawn in fp32
    ``_INIT_ROWS`` rows at a time (default scale: fan-in ** -0.5)."""
    scale = scale if scale is not None else out.shape[-2] ** -0.5
    rows = out.view(-1, out.shape[-1])
    for i in range(0, rows.shape[0], _INIT_ROWS):
        n = min(_INIT_ROWS, rows.shape[0] - i)
        rows[i:i + n] = (torch.randn(
            (n, rows.shape[1]), generator=generator,
            dtype=torch.float32, device=out.device) * scale).to(out.dtype)


def _init_attention(cfg: LlamaConfig, params: Params,
                    generator: torch.Generator) -> None:
    """Draw the embedding and the attention weights (in this order)."""
    layers = params["layers"]
    qd = cfg.n_heads * cfg.head_dim
    _normal_(params["embed"], generator, cfg.dim ** -0.5)
    for name in ("wq", "wk", "wv"):
        _normal_(layers[name], generator)
    _normal_(layers["wo"], generator, (qd ** -0.5) / (2 * cfg.n_layers) ** 0.5)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Scaled-normal init with the reference's shapes and scales; stacked
    [L, ...] layer weights. ``generator`` must live on ``device``. Torch
    and JAX draw different numbers from one seed: parity tests take the
    JAX weights through ``models.bridge.params_from_jax`` instead."""
    params = param_template(cfg, device)
    layers = params["layers"]
    L = cfg.n_layers
    # drawn in the order the keys are listed, as before the template
    _init_attention(cfg, params, generator)
    for name in ("w_gate", "w_up"):
        _normal_(layers[name], generator)
    _normal_(layers["w_down"], generator,
             (cfg.ffn_dim ** -0.5) / (2 * L) ** 0.5)
    _normal_(params["lm_head"], generator)
    for norm in (layers["attn_norm"], layers["ffn_norm"], params["norm"]):
        norm.fill_(1)
    return params


def init_moe_params(cfg: LlamaConfig, num_experts: int,
                    generator: torch.Generator,
                    device: DeviceLike = "cuda") -> Params:
    """:func:`init_params` with the dense FFN replaced by a routed expert
    bank, the reference's tree and scales: ``router`` [L, D, E] fp32
    (scale D ** -0.5), ``w_in`` [L, E, D, F] (D ** -0.5) and ``w_out``
    [L, E, F, D] (F ** -0.5 / sqrt(2L)) in ``cfg.dtype``. The banks are
    drawn one [D, F] (or [F, D]) slab at a time into the final tensors,
    and the dense FFN is never allocated. ``generator`` must live on
    ``device``."""
    params = param_template(cfg, device, num_experts)
    layers = params["layers"]
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    _init_attention(cfg, params, generator)
    _normal_(params["lm_head"], generator)
    _normal_(layers["router"], generator, d ** -0.5)
    out_scale = (f ** -0.5) / (2 * L) ** 0.5
    for bank, scale in ((layers["w_in"], d ** -0.5),
                        (layers["w_out"], out_scale)):
        for i in range(L):
            for e in range(num_experts):
                _normal_(bank[i, e], generator, scale)
    for norm in (layers["attn_norm"], layers["ffn_norm"], params["norm"]):
        norm.fill_(1)
    return params


def check_params_device(params: Params, device: torch.device,
                        user: str) -> None:
    """Raise unless ``params`` live on ``device``'s type (the ``user``,
    an engine or a decoder, runs there)."""
    embed = params["embed"]
    params_dev = (embed.q if isinstance(embed, QTensor) else embed).device
    if params_dev.type != device.type:
        raise ValueError(f"params live on {params_dev}, the {user} on "
                         f"{device}")


def quantize_params(params: Params) -> Params:
    """Weight-only int8 (``ops.quant``) for the dense decoder's serving
    path: matmul weights per out-channel (reduction axis -2), the
    embedding table per row; the norm gains stay as they are. MoE trees
    are refused, as in the reference."""
    if "router" in params["layers"]:
        raise ValueError(
            "quantize_params supports the dense decoder only; "
            "MoE expert banks are not quantizable (parallel.moe)")
    keep = ("attn_norm", "ffn_norm")
    layers = {k: (v if k in keep else quantize(v, axis=-2))
              for k, v in params["layers"].items()}
    return {"embed": quantize(params["embed"], axis=-1),
            "layers": layers,
            "norm": params["norm"],
            "lm_head": quantize(params["lm_head"], axis=-2)}


def init_quantized_params(cfg: LlamaConfig, generator: torch.Generator,
                          device: DeviceLike = "cuda") -> Params:
    """:func:`init_params` then :func:`quantize_params`, both on the
    host CPU with ``generator`` (a CPU generator), then only the int8
    payloads, their scales and the norm gains move to ``device``: no bf16
    weight stack is ever allocated there. Bitwise equal to
    ``quantize_params(init_params(cfg, generator, "cpu"))``."""
    dev = resolve_device(device)
    host = quantize_params(init_params(cfg, generator, device="cpu"))

    def move(w):
        if isinstance(w, QTensor):
            return QTensor(w.q.to(dev), w.s.to(dev))
        return w.to(dev)

    return {"embed": move(host["embed"]),
            "layers": {k: move(v) for k, v in host["layers"].items()},
            "norm": move(host["norm"]),
            "lm_head": move(host["lm_head"])}


# ---------------------------------------------------------------------------
# KV storage: the padded slot cache and the block-paged pool


def _kv_zeros(cfg: LlamaConfig, rows: int, length: int,
              device: DeviceLike) -> Cache:
    """Zeroed K and V [L, rows, length, KV, D] (int8 payload +
    per-position bf16 scales under ``cfg.kv_quant``)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, rows, length, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return {side: QTensor(torch.zeros(shape, dtype=torch.int8,
                                          device=dev),
                              torch.zeros(sshape, dtype=torch.bfloat16,
                                          device=dev))
                for side in ("k", "v")}
    return {side: torch.zeros(shape, dtype=cfg.dtype, device=dev)
            for side in ("k", "v")}


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                  device: DeviceLike = "cuda") -> Cache:
    """The padded slot cache [L, batch, max_seq, KV, D]."""
    return _kv_zeros(cfg, batch, max_seq, device)


def init_page_pool(cfg: LlamaConfig, pages: int, page_size: int,
                   device: DeviceLike = "cuda") -> Pool:
    """KV page pool [L, pages, page_size, KV, D]. Who owns which page is
    host bookkeeping (``models.paging.PagePool``)."""
    return _kv_zeros(cfg, pages, page_size, device)


def _dense(cache: QArray, dtype: torch.dtype) -> torch.Tensor:
    """The attention-readable view of a cache: int8 dequantizes to
    ``dtype`` BEFORE attention, as the reference's dense read does."""
    return dequantize(cache, dtype) if isinstance(cache, QTensor) else cache


def _cache_update(cache: QArray, new: torch.Tensor, pos: int,
                  axis: int) -> None:
    """Write K or V rows ``new`` into ``cache`` at ``pos`` along ``axis``
    in place, quantizing when the cache is int8. As the reference's
    ``dynamic_update_slice``, a start that would run off the end moves
    back to fit: it clamps to ``[0, size - n]`` (``generate_chunked``'s
    overshoot relies on it)."""
    n = new.shape[axis]
    start = min(max(int(pos), 0), cache.shape[axis] - n)
    if isinstance(cache, QTensor):
        nq = quantize(new, axis=-1)
        cache.q.narrow(axis, start, n).copy_(nq.q)
        cache.s.narrow(axis, start, n).copy_(nq.s)
    else:
        cache.narrow(axis, start, n).copy_(new)


def _slot_targets(lengths: torch.Tensor, size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where :func:`_cache_update_slots` writes each slot's row: (slot
    indices, clamped positions, [B, 1, 1] mask of the writes that land).
    Built once a step and shared by every layer."""
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    idx = lengths.long().clamp(0, size - 1)
    return rows, idx, (lengths < size)[:, None, None]


def _cache_update_slots(cache: QArray, new: torch.Tensor,
                        targets: Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]) -> None:
    """Per-slot write in place: row b of ``new`` [B, 1, KV, D] lands at
    position ``lengths[b]`` of a per-layer cache [B, S, KV, D]
    (``targets`` from :func:`_slot_targets`). The reference's
    ``.at[rows, lengths].set`` DROPS a row whose length is >= S (a slot
    retired mid-window keeps advancing); here such a row writes back what
    its clamped target already holds, so no index leaves the cache and
    nothing waits for the host."""
    rows, idx, keep = targets
    if isinstance(cache, QTensor):
        nq = quantize(new[:, 0], axis=-1)
        cache.q[rows, idx] = torch.where(keep, nq.q, cache.q[rows, idx])
        cache.s[rows, idx] = torch.where(keep, nq.s.to(cache.s.dtype),
                                         cache.s[rows, idx])
    else:
        cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype),
                                       cache[rows, idx])


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


def _use_flash_decode(cfg: LlamaConfig, device: torch.device) -> bool:
    """Route decode attention (slot cache and paged pool): ``auto`` takes
    the CUDA kernel on a CUDA device and the dense read on the CPU;
    ``flash`` forces the kernel wrapper; ``dense`` the dense read. The
    reference's lane-128 conditions do not carry over."""
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
                 attn: Callable, logit_index: Optional[int] = None,
                 all_positions: bool = False,
                 ffn_override: Optional[FfnOverride] = None
                 ) -> torch.Tensor:
    """The cache-consuming forward shared by the decode steps (solo, per
    slot, paged), the paged prefill chunk and the K-token windows: they
    differ only in how rope is applied, where K/V rows land
    (``cache_write(cache_layer, rows)``) and the attention read
    (``attn(q, k_cache_layer, v_cache_layer)``).

    ``tokens`` [B, S]; returns fp32 logits [B, V] at the last position,
    at ``logit_index`` (a padded prefill chunk's last live token), or
    with ``all_positions`` [B, S, V] at every position.
    ``ffn_override(x, lp) -> x`` replaces the whole pre-norm FFN residual
    step (MoE serving routes through ``parallel.moe`` there,
    :func:`make_moe_ffn`); None keeps the dense SwiGLU."""
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
        if ffn_override is not None:
            x = ffn_override(x, lp)
        else:
            x = ffn_block(cfg, x, lp)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if not all_positions:
        x = x[:, -1, :] if logit_index is None else x[:, logit_index, :]
    return qmm(x, params["lm_head"]).float()


def decode_step_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                      table: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor,
                      rope: Optional[torch.Tensor] = None,
                      ffn_override: Optional[FfnOverride] = None
                      ) -> Tuple[torch.Tensor, Pool]:
    """One decode step against the paged pool.

    ``tokens``/``lengths`` [B] int32; ``table`` [B, MP] int32 maps each
    stream's logical page to a physical pool page. Stream b's new K/V
    row lands at (table[b, lengths[b] // ps], lengths[b] % ps) and it
    attends to ``lengths[b] + 1`` positions, through the CUDA kernel or
    the dense gather (:func:`_use_flash_decode`). Inactive
    streams point their table rows at a scratch page. ``ffn_override``
    as in :func:`_decode_body`. Returns (logits [B, V] fp32, pool
    updated in place)."""
    rope = _rope_table(cfg, rope, tokens.device)
    ps = pool["k"].shape[2]
    mp = table.shape[1]
    # clip: a stream retired mid-window keeps advancing past its table;
    # its row is all scratch, so the clipped write lands there
    page_idx = torch.clamp(lengths // ps, 0, mp - 1).long()
    phys = torch.gather(table, 1, page_idx[:, None])[:, 0]
    offs = lengths % ps
    kv_len = (lengths + 1).to(torch.int32)
    flash = _use_flash_decode(cfg, tokens.device)

    def cache_write(cache, new):
        _page_write(cache, new[:, 0], phys, offs)

    def attn(q, k_cache, v_cache):
        if flash:
            if not supports_decode_paged(q, k_cache, ps):
                raise ValueError(_outside_gate(cfg, "paged decode"))
            return flash_decode_paged(q, k_cache, v_cache, table, kv_len)
        k_read = _gather_pages(k_cache, table, cfg.dtype)
        v_read = _gather_pages(v_cache, table, cfg.dtype)
        return gqa_attention(q, k_read, v_read, causal=False, kv_len=kv_len)

    logits = _decode_body(cfg, params, pool, tokens[:, None],
                          rope_fn=lambda t: apply_rope_at(t, rope, lengths),
                          cache_write=cache_write, attn=attn,
                          ffn_override=ffn_override)
    return logits, pool


def verify_step_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                      table: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor,
                      rope: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Pool]:
    """Consume a K-token window PER STREAM against the paged pool: the
    speculative verify of :class:`~dcos_commons_tpu_torch.models.serving.
    PagedServer`.

    ``tokens`` [B, K] occupy positions ``lengths[b] .. lengths[b]+K-1``
    of each stream. Row (b, j)'s K/V lands through ``table`` [B, MP] as
    :func:`decode_step_paged`'s single row would at that position, every
    stream's, masked or not; the page index clips to ``MP - 1``, so a
    window past the table's span writes onto the rows of its last page,
    as the reference's does. Attention gathers the pages and is causal
    within the window (query j of stream b sees positions up to
    ``lengths[b] + j``), in fp32 over the dense gather, outside any
    kernel, as in the reference. Returns (logits [B, K, V] fp32, the pool
    updated in place)."""
    rope = _rope_table(cfg, rope, tokens.device)
    b, kk = tokens.shape
    ps = pool["k"].shape[2]
    mp = table.shape[1]
    positions = lengths[:, None] + torch.arange(
        kk, dtype=torch.int32, device=tokens.device)[None]
    page_idx = torch.clamp(positions // ps, 0, mp - 1).long()
    phys = torch.gather(table, 1, page_idx)                    # [B, K]
    offs = positions % ps
    rope_pos = torch.clamp(positions, 0, rope.shape[1] - 1)

    def cache_write(cache, new):
        _page_write(cache, new.reshape((b * kk,) + new.shape[2:]),
                    phys.reshape(-1), offs.reshape(-1))

    def attn(q, k_cache, v_cache):
        k_read = _gather_pages(k_cache, table, cfg.dtype)
        v_read = _gather_pages(v_cache, table, cfg.dtype)
        return gqa_attention(q, k_read, v_read, causal=True,
                             q_offset=lengths, kv_len=lengths + kk)

    logits = _decode_body(
        cfg, params, pool, tokens,
        rope_fn=lambda t: apply_rope_at_many(t, rope, rope_pos),
        cache_write=cache_write, attn=attn, all_positions=True)
    return logits, pool


def _outside_gate(cfg: LlamaConfig, kernel: str) -> str:
    return (f"decode_attn={cfg.decode_attn!r}: the {kernel} kernel does "
            f"not take head_dim {cfg.head_dim} with "
            f"{cfg.n_heads // cfg.n_kv_heads} query heads per KV head; use "
            "decode_attn='dense'")


def _slot_attn(cfg: LlamaConfig, device: torch.device, kv_len) -> Callable:
    """The decode read of the slot cache: the slot kernel (through
    :func:`_use_flash_decode`) or the dense read of the whole cache,
    masked at ``kv_len`` [B]."""
    flash = _use_flash_decode(cfg, device)

    def attn(q, k_cache, v_cache):
        if flash:
            if not supports_decode(q, k_cache):
                raise ValueError(_outside_gate(cfg, "slot decode"))
            return flash_decode(q, k_cache, v_cache, kv_len)
        return gqa_attention(q, _dense(k_cache, cfg.dtype),
                             _dense(v_cache, cfg.dtype), causal=False,
                             kv_len=kv_len)

    return attn


def _rope_table(cfg: LlamaConfig, rope: Optional[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    if rope is not None:
        return rope
    return rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=device)


def decode_step(cfg: LlamaConfig, params: Params, cache: Cache, pos: int,
                token: torch.Tensor, rope: Optional[torch.Tensor] = None,
                ffn_override: Optional[FfnOverride] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step of every row at position ``pos`` (a host int, the
    current length): ``token`` [B] int32 lands at ``pos`` and every row
    attends to ``pos + 1`` positions. A ``pos`` past the cache writes
    onto its last row and attends to all of it, as the reference's
    clamping update does. Returns (logits [B, V] fp32, the cache updated
    in place)."""
    rope = _rope_table(cfg, rope, token.device)
    # one [B] length for every layer's read, filled on the device
    kv_len = torch.full(token.shape, pos + 1, dtype=torch.int32,
                        device=token.device)
    logits = _decode_body(
        cfg, params, cache, token[:, None],
        rope_fn=lambda t: apply_rope(t, rope, pos),
        cache_write=lambda c, new: _cache_update(c, new, pos, 1),
        attn=_slot_attn(cfg, token.device, kv_len),
        ffn_override=ffn_override)
    return logits, cache


def extend_step(cfg: LlamaConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos: int,
                rope: Optional[torch.Tensor] = None,
                ffn_override: Optional[FfnOverride] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """Consume K tokens in ONE forward: ``tokens`` [B, K] occupy
    positions ``pos .. pos+K-1`` (``pos`` a host int); returns (logits
    [B, K, V] fp32 at every position, the cache updated in place). The
    verify pass of :class:`~dcos_commons_tpu_torch.models.speculative.
    SpeculativeDecoder`: the window's K/V land first, then each query
    attends causally within the window and to the live prefix, over the
    dense read (as in the reference). A window past the cache's end
    writes onto its last rows (the clamped start of
    :func:`_cache_update`)."""
    kk = tokens.shape[1]
    rope = _rope_table(cfg, rope, tokens.device)
    return _decode_body(
        cfg, params, cache, tokens,
        rope_fn=lambda t: apply_rope(t, rope, pos),
        cache_write=lambda c, new: _cache_update(c, new, pos, 1),
        attn=lambda q, k_cache, v_cache: gqa_attention(
            q, _dense(k_cache, cfg.dtype), _dense(v_cache, cfg.dtype),
            causal=True, q_offset=pos, kv_len=pos + kk),
        all_positions=True, ffn_override=ffn_override), cache


def decode_step_slots(cfg: LlamaConfig, params: Params, cache: Cache,
                      lengths: torch.Tensor, tokens: torch.Tensor,
                      rope: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """One decode step with PER-SLOT positions, the step of
    :class:`~dcos_commons_tpu_torch.models.serving.SlotServer`.

    ``tokens``/``lengths`` [B] int32: slot b's new K/V row lands at
    ``lengths[b]`` (dropped when that is >= max_seq) and it attends to
    ``lengths[b] + 1`` positions. Per row the math of
    :func:`decode_step`. Returns (logits [B, V] fp32, the cache updated
    in place)."""
    rope = _rope_table(cfg, rope, tokens.device)
    targets = _slot_targets(lengths, cache["k"].shape[2])
    logits = _decode_body(
        cfg, params, cache, tokens[:, None],
        rope_fn=lambda t: apply_rope_at(t, rope, lengths),
        cache_write=lambda c, new: _cache_update_slots(c, new, targets),
        attn=_slot_attn(cfg, tokens.device, lengths + 1))
    return logits, cache


def prefill_chunk_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                        table: torch.Tensor, tokens: torch.Tensor,
                        start: int, true_len: int, logit_index: int,
                        scratch_page: int,
                        rope: Optional[torch.Tensor] = None,
                        ffn_override: Optional[FfnOverride] = None
                        ) -> Tuple[torch.Tensor, Pool]:
    """One CHUNK of paged prefill for a single stream: ``tokens`` [1, C]
    occupy positions ``start..start+C-1``, K/V landing through ``table``
    [MP]. Returns (logits [1, V] at chunk index ``logit_index``, the
    pool updated in place). Padded positions at/after ``true_len`` write
    to ``scratch_page``; attention gathers the stream's pages in logical
    order, causal from ``start``. Every one of the C rows goes through
    ``ffn_override``, padded ones included, as in the reference."""
    rope = _rope_table(cfg, rope, tokens.device)
    ps = pool["k"].shape[2]
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
        cache_write=cache_write, attn=attn, logit_index=logit_index,
        ffn_override=ffn_override)
    return logits, pool


# ---------------------------------------------------------------------------
# train forward


def attn_route(impl: str, device_type: str, q: torch.Tensor,
               k: torch.Tensor) -> str:
    """Which path causal train attention takes, ``"flash"`` or
    ``"dense"``, decided from the impl, the device type and the shapes
    and dtype alone (no launch, no build).

    ``dense`` is dense. A head_dim above 256 is dense, as the reference's
    gate sends it. On the CPU ``auto`` is dense and ``flash`` takes the
    kernel wrapper, which runs its plain version. On a CUDA device
    ``auto`` and ``flash`` take the kernels: they take any sequence
    length (the reference's ``S % 128`` tile rule does not carry over)
    and :func:`_make_attn_fn` zero-pads a head_dim below a kernel width;
    they take bf16 only, so any other dtype raises ``TypeError`` where
    the reference would run its kernel. A caller that trains under the
    reference's mesh, where its ``auto`` is dense, passes ``dense``."""
    if impl == "dense" or q.shape[-1] > HEAD_DIMS[-1]:
        return "dense"
    if device_type != "cuda":
        return "flash" if impl == "flash" else "dense"
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(
            f"attn_impl={impl!r} on a CUDA device: the flash-attention "
            f"kernels take bf16, got {q.dtype}/{k.dtype}; train this "
            "config with attn_impl='dense'")
    return "flash"


def _padded_flash(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention at any head_dim up to 256: q/k/v are
    zero-padded to the next kernel width and the softmax keeps the true
    width's scale. The zero columns add nothing to Q.K^T, the output's
    padded columns are zero and cut away, and the gradients of the
    padding are dropped by the pad's own backward."""
    d = q.shape[-1]
    width = next(w for w in HEAD_DIMS if w >= d)
    if width == d:
        return flash_attention(q, k, v, causal=True)
    pad = (0, width - d)
    o = flash_attention(torch.nn.functional.pad(q, pad),
                        torch.nn.functional.pad(k, pad),
                        torch.nn.functional.pad(v, pad), causal=True,
                        sm_scale=d ** -0.5)
    return o[..., :d]


def _make_attn_fn(cfg: LlamaConfig, device: torch.device) -> Callable:
    """f(q, k, v) for q [B, S, H, D], k/v [B, S, KV, D], causal, routed
    per call by :func:`attn_route`."""
    impl = cfg.attn_impl
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported yet (ROADMAP Queue 1 item 9)")
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"attn_impl={impl!r}: expected one of 'auto', "
                         "'dense', 'flash'")

    def attn(q, k, v):
        if attn_route(impl, device.type, q, k) == "flash":
            return _padded_flash(q, k, v)
        return gqa_attention(q, k, v, causal=True)

    return attn


def attention_block(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
                    rope: torch.Tensor, attn_fn: Callable,
                    return_kv: bool = False):
    """Pre-norm attention residual step on x [B, S, D]. With
    ``return_kv`` also returns the rope'd K/V (the prefill cache
    contract, what ``decode_step`` writes)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = qmm(h, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = qmm(h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = qmm(h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    o = attn_fn(q, k, v)             # GQA expansion is the impl's business
    out = x + qmm(o.reshape(b, s, -1), lp["wo"])
    return (out, k, v) if return_kv else out


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


# ---------------------------------------------------------------------------
# prefill and solo generation on the slot cache


def prefill_trunk(cfg: LlamaConfig, params: Params, prompt: torch.Tensor,
                  rope: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prefill forward shared by :func:`prefill` and the engine's
    bucketed slot prefill: (normed hidden states [B, S, D], ks/vs
    [L, B, S, KV, D]); callers pick the logits position and where the
    K/V land. Causal attention takes the flash-attention forward kernel
    where decode takes its kernel (:func:`_use_flash_decode`: on a CUDA
    device, any S, a shape outside its gate raises) and the dense path
    elsewhere; the reference's ``S % 128`` gate does not carry over."""
    if _use_flash_decode(cfg, prompt.device):
        def attn_fn(q, k, v):
            return flash_attention(q, k, v, causal=True)
    else:
        def attn_fn(q, k, v):
            return gqa_attention(q, k, v, causal=True)
    layers = params["layers"]
    x = qtake(params["embed"], prompt, cfg.dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x, k, v = attention_block(cfg, x, lp, rope, attn_fn, return_kv=True)
        x = ffn_block(cfg, x, lp)
        ks.append(k)
        vs.append(v)
    return (rms_norm(x, params["norm"], cfg.norm_eps), torch.stack(ks),
            torch.stack(vs))


def prefill(cfg: LlamaConfig, params: Params, cache: Cache,
            prompt: torch.Tensor, rope: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """One forward over the whole prompt [B, S], every layer's K/V
    written into the cache at positions [0, S) in place. Returns
    (last-position logits [B, V] fp32, cache)."""
    rope = _rope_table(cfg, rope, prompt.device)
    x, ks, vs = prefill_trunk(cfg, params, prompt, rope)
    logits = qmm(x[:, -1, :], params["lm_head"]).float()
    _cache_update(cache["k"], ks, 0, 2)
    _cache_update(cache["v"], vs, 0, 2)
    return logits, cache


def _check_capacity(cfg: LlamaConfig, prompt_len: int, steps: int) -> None:
    """Refuse a request that would write past the cache: the clamping
    update would smear its tail onto the last row instead of failing."""
    if prompt_len + steps > cfg.max_seq:
        raise ValueError(
            f"prompt {prompt_len} + steps {steps} exceeds the cache "
            f"({cfg.max_seq}); raise max_seq or shrink the ask")


def _select(sampler: Optional[Sampler], generator: Optional[torch.Generator],
            logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Next token from logits: the sampler (``ops/sampling.py``) when
    given, else greedy argmax."""
    if sampler is None:
        return torch.argmax(logits, dim=-1).to(dtype)
    return sampler(generator, logits).to(dtype)


def generate(cfg: LlamaConfig, params: Params, prompt: torch.Tensor,
             steps: int) -> torch.Tensor:
    """Greedy generation: prefill, then ``steps`` decode steps; returns
    [B, steps] (the first token from the prefill logits). The fused
    program and the host-driven loop of the reference are one loop
    here, so :func:`generate_stepwise` is this function."""
    b, s = prompt.shape
    _check_capacity(cfg, s, steps)
    cache = init_kv_cache(cfg, b, cfg.max_seq, device=prompt.device)
    rope = _rope_table(cfg, None, prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt, rope=rope)
    toks = []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        logits, cache = decode_step(cfg, params, cache, s + i, tok, rope=rope)
        toks.append(tok)
    if not toks:
        return torch.zeros((b, 0), dtype=prompt.dtype, device=prompt.device)
    return torch.stack(toks, dim=1)


generate_stepwise = generate


# ---------------------------------------------------------------------------
# mixture of experts: the routed FFN of the serving paths


def make_moe_ffn(cfg: LlamaConfig, moe_cfg: MoEConfig,
                 mesh: Any = None) -> FfnOverride:
    """The ``ffn_override`` that routes :func:`_decode_body`'s FFN step
    through :func:`~dcos_commons_tpu_torch.parallel.moe.moe_apply_local`:
    every token of the call (all B*S rows, padded and masked ones
    included) is one dispatch group. The auxiliary loss is dead weight at
    inference and is dropped. Only the local path is ported: the
    expert-parallel mesh form is ROADMAP Queue 1 item 7."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a device mesh is not ported yet "
            "(ROADMAP Queue 1 item 7)")

    def ffn(x: torch.Tensor, lp: Params) -> torch.Tensor:
        b, s, d = x.shape
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        out, _ = moe_apply_local(h.reshape(b * s, d), lp["router"],
                                 lp["w_in"], lp["w_out"], moe_cfg)
        return x + out.reshape(b, s, d).to(cfg.dtype)

    return ffn


def generate_stepwise_moe(cfg: LlamaConfig, params: Params,
                          prompt: torch.Tensor, steps: int,
                          moe_cfg: MoEConfig) -> torch.Tensor:
    """Greedy MoE generation, the serving parity reference: the whole
    prompt in one :func:`extend_step`, then one :func:`decode_step` per
    token (on a CUDA device through the slot-cache decode kernel), both
    with the :func:`make_moe_ffn` override. Returns [B, steps]. The paged
    engine routes each prefill chunk and decode batch as its own group,
    this reference the whole prompt and then one token at a time: the
    two agree token for token only under dropless capacity
    (``parallel.moe.dropless``)."""
    b, s = prompt.shape
    _check_capacity(cfg, s, steps)
    cache = init_kv_cache(cfg, b, cfg.max_seq, device=prompt.device)
    rope = _rope_table(cfg, None, prompt.device)
    ffn = make_moe_ffn(cfg, moe_cfg)
    logits, cache = extend_step(cfg, params, cache, prompt, 0, rope=rope,
                                ffn_override=ffn)
    logits = logits[:, -1]           # extend_step returns every position
    toks = []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        logits, cache = decode_step(cfg, params, cache, s + i, tok,
                                    rope=rope, ffn_override=ffn)
        toks.append(tok)
    if not toks:
        return torch.zeros((b, 0), dtype=prompt.dtype, device=prompt.device)
    return torch.stack(toks, dim=1)


def decode_chunk_logits(cfg: LlamaConfig, params: Params, cache: Cache,
                        pos: int, token: torch.Tensor, steps: int,
                        rope: Optional[torch.Tensor] = None,
                        sampler: Optional[Sampler] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """``steps`` decode steps from ``token`` [B] at position ``pos``:
    (toks [B, steps], every step's logits [B, steps, V], cache). Greedy
    unless ``sampler`` (drawing from ``generator``) is given."""
    rope = _rope_table(cfg, rope, token.device)
    toks, logits_all = [], []
    tok = token
    for i in range(steps):
        logits, cache = decode_step(cfg, params, cache, pos + i, tok,
                                    rope=rope)
        tok = _select(sampler, generator, logits, token.dtype)
        toks.append(tok)
        logits_all.append(logits)
    return torch.stack(toks, dim=1), torch.stack(logits_all, dim=1), cache


def decode_chunk(cfg: LlamaConfig, params: Params, cache: Cache, pos: int,
                 token: torch.Tensor, steps: int,
                 rope: Optional[torch.Tensor] = None,
                 sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """:func:`decode_chunk_logits` without the logits: (toks [B, steps],
    cache)."""
    toks, _, cache = decode_chunk_logits(cfg, params, cache, pos, token,
                                         steps, rope=rope, sampler=sampler,
                                         generator=generator)
    return toks, cache


def generate_chunked(cfg: LlamaConfig, params: Params, prompt: torch.Tensor,
                     steps: int, chunk: int = 16,
                     sampler: Optional[Sampler] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Generation in chunks of ``chunk`` decode steps (the worker's solo
    decode): the first token from the prefill logits, then whole chunks,
    trimmed to [B, steps]. Greedy unless ``sampler`` is given. The last
    chunk may run past ``steps`` and past the cache: its writes clamp
    onto the last row after every kept token was computed, as in the
    reference."""
    b, s = prompt.shape
    _check_capacity(cfg, s, steps)
    cache = init_kv_cache(cfg, b, cfg.max_seq, device=prompt.device)
    rope = _rope_table(cfg, None, prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt, rope=rope)
    tok = _select(sampler, generator, logits, prompt.dtype)
    out = [tok[:, None]]
    emitted, pos = 1, s
    while emitted < steps:
        toks, cache = decode_chunk(cfg, params, cache, pos, tok, chunk,
                                   rope=rope, sampler=sampler,
                                   generator=generator)
        out.append(toks)
        tok = toks[:, -1]
        emitted += chunk
        pos += chunk
    return torch.cat(out, dim=1)[:, :steps]


def truncate_layers(cfg: LlamaConfig, params: Params, n_layers: int
                    ) -> Tuple[LlamaConfig, Params]:
    """A layer-skip draft: the target's FIRST ``n_layers`` decoder layers
    with the embedding, final norm and lm_head shared. The stacked
    ``[L, ...]`` layout makes the cut a view (quantized leaves too): no
    weight is copied."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"draft layers {n_layers} not in [1, {cfg.n_layers}]")
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    layers = {k: w[:n_layers] for k, w in params["layers"].items()}
    return dcfg, {**params, "layers": layers}
