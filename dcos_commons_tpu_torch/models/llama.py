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

Sequence-parallel prefill (serving): ``prefill_ring`` is
``prefill_trunk``'s contract on one rank of an ``sp`` mesh: every rank
holds the whole padded prompt and computes its contiguous S/sp shard,
attention through ``parallel.ring_attention``.

Mixture of experts (serving): ``init_moe_params`` builds the routed tree
(``router``, ``w_in``, ``w_out`` in place of the dense FFN);
``make_moe_ffn`` is the ``ffn_override`` that the decode steps, the
paged prefill chunk and ``extend_step`` take, and
``generate_stepwise_moe`` the greedy reference the MoE engine is held
to.

Tensor parallelism (serving): ``param_specs`` is the reference's
Megatron layout over the ``tp`` axis and ``shard_params`` slices this
rank's part of every leaf (``init_params(..., mesh=)`` draws each leaf
whole and slices it at once). The serving forwards, the caches and the
pools take ``mesh=`` (a ``parallel.mesh.Mesh``): each rank computes its
own query and KV heads and its own FFN columns, the residual stream stays
replicated, the row-parallel outputs (``wo``, ``w_down``) and the
vocab-parallel embedding are all-reduced and the column-parallel
``lm_head`` logits all-gathered in rank order, so every rank holds the
same bits after each collective. A mesh of one process is no mesh.

Training: ``forward`` (full sequences, causal attention through the
flash-attention kernels or the dense path, optional per-layer remat)
and ``loss_fn`` (next-token loss, fused linear cross-entropy by
default), both with ``mesh=``. Under sp (a mesh whose ``sp`` axis is
larger than 1) each rank holds ``S/sp`` of the sequence through the
embedding, the blocks, the norm and the loss: ``loss_fn`` takes the
whole token batch, shifts it, lays it out (``zigzag`` for the zigzag
ring) and keeps the rank's slice; rope reads each slot's global
position; attention is the ring (``parallel.ring_attention``), Ulysses
(``parallel.ulysses``), or, for ``dense`` and ``flash``, the rank's
queries over K/V gathered over sp (``Mesh.gather_seq``, whose backward
sums the ranks' K/V gradients) at the rank's query offset; the loss and
the accuracy are averaged over sp (the train step averages the
gradients over dp and sp). Under tp the train forward places
Megatron's pair (``parallel.mesh``): each attention and FFN block
passes its normed input through ``Mesh.copy_to`` ("f", whose backward
sums the ranks' partial input gradients) and its ``wo``/``w_down``
output through ``Mesh.reduce_from`` ("g"), the embedding's lookup
through "g" too, and the vocabulary-parallel loss sums the final hidden
state's gradient itself; so the residual stream and its gradient, and
the norms' gradients, hold the same bits on every rank.

Expert and pipeline parallelism (training): ``moe_param_specs``,
``forward_moe`` and ``loss_fn_moe`` (every rank computes the whole
batch; the FFN is ``parallel.moe.make_moe`` over ``ep``, the rank's
experts of the bank, plus 0.01 times the auxiliary loss), and
``stack_pipeline_params``, ``pipeline_param_specs``,
``forward_pipelined`` and ``loss_fn_pipelined`` (the trunk's
``[pp, L/pp, ...]`` stacks, a rank its stage, through
``parallel.pipeline``'s GPipe schedule; the embedding, final norm and
head replicated outside it). Both attend densely, as the reference's do.
``shard_params(..., specs=)`` slices any of these layouts, and
``make_moe_ffn(mesh=)`` serves MoE over an ep mesh.

Parameters are a plain dict of tensors with the JAX pytree's
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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import gqa_attention, repeat_kv
from ..ops.flash_attention import (HEAD_DIMS, flash_attention,
                                   flash_attention_tp)
from ..ops.flash_decode import (flash_decode, flash_decode_paged,
                                flash_decode_paged_tp, flash_decode_tp,
                                supports_decode, supports_decode_paged)
from ..ops.losses import fused_linear_cross_entropy, softmax_cross_entropy
from ..ops.norms import rms_norm
from ..ops.quant import QArray, QTensor, dequantize, qmm, qtake, quantize
from ..ops.rotary import (apply_rope, apply_rope_at, apply_rope_at_many,
                          apply_rope_positions, rope_frequencies)
from ..parallel.mesh import (Mesh, Spec, scale_spec, shard_slices, sp_size,
                             tp_size)
from ..parallel.moe import MoEConfig, moe_apply_local
from ..parallel.ring_attention import ring_attention, zigzag_indices
from ..parallel.ulysses import ulysses_attention

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
    # train attention: auto | dense | flash | ring | ulysses. On a CUDA
    # device auto and flash take the flash-attention kernels for every
    # head_dim up to 256 (the reference's gate), zero-padded to the
    # kernels' widths, and the dense path beyond it; the kernels take
    # bf16 only, so an fp32 config raises there. On the CPU auto is dense
    # and flash runs the kernel wrapper (its plain version). Under a mesh
    # of more than one process auto is ring when sp > 1, else dense. ring
    # and ulysses shard the sequence over sp (plain torch products; dense
    # without a mesh). See :func:`attn_route`
    attn_impl: str = "auto"
    # ring attention's block order: "contiguous" (rank i holds positions
    # [i S/sp, (i+1) S/sp); causal work is imbalanced over the ring) or
    # "zigzag" (rank i holds chunks i and 2 sp - 1 - i of 2 sp; balanced;
    # loss_fn lays the tokens out with ring_attention.zigzag_indices)
    ring_layout: str = "contiguous"
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
                   num_experts: int = 0, mesh: Optional[Mesh] = None
                   ) -> Params:
    """The parameter tree of uninitialised tensors: the reference's keys,
    shapes (stacked [L, ...] layer weights) and ``cfg.dtype``.
    :func:`init_params` fills it; a checkpoint restore takes it as its
    template, with no random draws. With ``num_experts`` the tree of
    :func:`init_moe_params`: the dense FFN (never allocated) replaced by
    ``router`` [L, D, E] fp32, ``w_in`` [L, E, D, F] and ``w_out``
    [L, E, F, D]. With a ``mesh``, this rank's shard shapes under
    :func:`shard_params`' default specs."""
    if mesh is not None and mesh.size > 1:
        dev = resolve_device(device)
        full = shard_params(param_template(cfg, "meta", num_experts), mesh,
                            cfg)

        def alloc(t):
            return torch.empty(t.shape, dtype=t.dtype, device=dev)

        return {"embed": alloc(full["embed"]),
                "layers": {k: alloc(v) for k, v in full["layers"].items()},
                "norm": alloc(full["norm"]),
                "lm_head": alloc(full["lm_head"])}
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


def _draws(cfg: LlamaConfig) -> List[Tuple[Tuple[str, ...], Optional[float]]]:
    """The dense tree's random leaves in draw order, each with its scale
    (None: fan-in ** -0.5)."""
    qd = cfg.n_heads * cfg.head_dim
    L = cfg.n_layers
    return [(("embed",), cfg.dim ** -0.5),
            (("layers", "wq"), None), (("layers", "wk"), None),
            (("layers", "wv"), None),
            (("layers", "wo"), (qd ** -0.5) / (2 * L) ** 0.5),
            (("layers", "w_gate"), None), (("layers", "w_up"), None),
            (("layers", "w_down"), (cfg.ffn_dim ** -0.5) / (2 * L) ** 0.5),
            (("lm_head",), None)]


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = "cuda",
                mesh: Optional[Mesh] = None) -> Params:
    """Scaled-normal init with the reference's shapes and scales; stacked
    [L, ...] layer weights. ``generator`` must live on ``device``. Torch
    and JAX draw different numbers from one seed: parity tests take the
    JAX weights through ``models.bridge.params_from_jax`` instead.

    With a ``mesh`` each leaf is drawn whole, in the same order, and
    sliced to this rank's shard before the next is drawn: bitwise
    ``shard_params(init_params(...), mesh, cfg)``, with one whole leaf at
    a time on the device."""
    if tp_size(mesh) > 1:
        _check_tp(cfg, tp_size(mesh))
        dev = resolve_device(device)
        full = param_template(cfg, "meta")
        specs = param_specs(cfg)
        out = {"embed": None, "layers": dict.fromkeys(full["layers"]),
               "norm": None, "lm_head": None}
        for path, scale in _draws(cfg):
            leaf = torch.empty(_get(full, path).shape, dtype=cfg.dtype,
                               device=dev)
            _normal_(leaf, generator, scale)
            _set(out, path, _shard(leaf, _get(specs, path), mesh))
            del leaf
        for path in (("layers", "attn_norm"), ("layers", "ffn_norm"),
                     ("norm",)):
            _set(out, path, torch.ones(_get(full, path).shape,
                                       dtype=cfg.dtype, device=dev))
        return out
    params = param_template(cfg, device)
    layers = params["layers"]
    for path, scale in _draws(cfg):
        _normal_(_get(params, path), generator, scale)
    for norm in (layers["attn_norm"], layers["ffn_norm"], params["norm"]):
        norm.fill_(1)
    return params


def init_moe_params(cfg: LlamaConfig, num_experts: int,
                    generator: torch.Generator,
                    device: DeviceLike = "cuda",
                    mesh: Optional[Mesh] = None) -> Params:
    """:func:`init_params` with the dense FFN replaced by a routed expert
    bank, the reference's tree and scales: ``router`` [L, D, E] fp32
    (scale D ** -0.5), ``w_in`` [L, E, D, F] (D ** -0.5) and ``w_out``
    [L, E, F, D] (F ** -0.5 / sqrt(2L)) in ``cfg.dtype``. The banks are
    drawn one [D, F] (or [F, D]) slab at a time into the final tensors,
    and the dense FFN is never allocated. ``generator`` must live on
    ``device``. With an ep ``mesh`` every slab is drawn in the same order
    and only the rank's experts are kept: bitwise ``shard_params`` of the
    whole tree, with the rank's banks alone on the device."""
    params = param_template(cfg, device, num_experts, mesh)
    layers = params["layers"]
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    _init_attention(cfg, params, generator)
    _normal_(params["lm_head"], generator)
    _normal_(layers["router"], generator, d ** -0.5)
    out_scale = (f ** -0.5) / (2 * L) ** 0.5
    mine = layers["w_in"].shape[1]
    first = mine * (mesh.coords["ep"] if mesh is not None else 0)
    for bank, scale in ((layers["w_in"], d ** -0.5),
                        (layers["w_out"], out_scale)):
        other = torch.empty_like(bank[0, 0])
        for i in range(L):
            for e in range(num_experts):
                _normal_(bank[i, e - first] if 0 <= e - first < mine
                         else other, generator, scale)
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
                          device: DeviceLike = "cuda",
                          mesh: Optional[Mesh] = None) -> Params:
    """:func:`init_params` then :func:`quantize_params`, both on the
    host CPU with ``generator`` (a CPU generator), then only the int8
    payloads, their scales and the norm gains move to ``device``: no bf16
    weight stack is ever allocated there. Bitwise equal to
    ``quantize_params(init_params(cfg, generator, "cpu"))``; with a
    ``mesh``, this rank's shard of it, sliced on the host."""
    dev = resolve_device(device)
    host = shard_params(quantize_params(init_params(cfg, generator,
                                                    device="cpu")),
                        mesh, cfg)

    def move(w):
        if isinstance(w, QTensor):
            return QTensor(w.q.to(dev), w.s.to(dev))
        return w.to(dev)

    return {"embed": move(host["embed"]),
            "layers": {k: move(v) for k, v in host["layers"].items()},
            "norm": move(host["norm"]),
            "lm_head": move(host["lm_head"])}


# ---------------------------------------------------------------------------
# tensor-parallel shards

def param_specs(cfg: LlamaConfig) -> Params:
    """Megatron-style tp sharding, the reference's: column-parallel
    in-projections (``wq``/``wk``/``wv``/``w_gate``/``w_up``, and
    ``lm_head`` over the vocabulary), row-parallel out-projections
    (``wo``/``w_down``), the embedding row-sharded over the vocabulary,
    norms replicated."""
    col, row = (None, None, "tp"), (None, "tp", None)
    return {
        "embed": ("tp", None),
        "layers": {"attn_norm": (), "wq": col, "wk": col, "wv": col,
                   "wo": row, "ffn_norm": (), "w_gate": col, "w_up": col,
                   "w_down": row},
        "norm": (),
        "lm_head": (None, "tp"),
    }


def _check_tp(cfg: LlamaConfig, tp: int) -> None:
    """tp must divide every sharded dimension (the GQA group then stays
    whole on each rank)."""
    for name in ("n_heads", "n_kv_heads", "ffn_dim", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"tp={tp} does not divide {name}="
                             f"{getattr(cfg, name)}")


def _get(tree: Params, path: Tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Params, path: Tuple[str, ...], value: Any) -> None:
    _get(tree, path[:-1])[path[-1]] = value


def _shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: a tensor of its own
    (the whole leaf can be freed), or ``t`` itself when replicated."""
    out = t
    for dim, (start, n) in enumerate(shard_slices(t.shape, spec, mesh)):
        if n != t.shape[dim]:
            out = out.narrow(dim, start, n)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def shard_leaf(leaf: QArray, spec: Spec, mesh: Mesh) -> QArray:
    """:func:`_shard` of one leaf, a ``QTensor``'s scales under
    ``parallel.mesh.scale_spec``."""
    if isinstance(leaf, QTensor):
        return QTensor(_shard(leaf.q, spec, mesh),
                       _shard(leaf.s, scale_spec(spec, tuple(leaf.s.shape)),
                              mesh))
    return _shard(leaf, spec, mesh)


def shard_params(params: Params, mesh: Optional[Mesh],
                 cfg: LlamaConfig, specs: Optional[Params] = None
                 ) -> Params:
    """This rank's shard of every leaf under ``specs``, ``QTensor``s
    included. By default the dense tree's :func:`param_specs` (tp) and
    a MoE tree's :func:`moe_param_specs` (ep; refused under tp, whose
    ``moe=`` is not ported yet); the pipelined tree passes
    :func:`pipeline_param_specs`. Each whole leaf is dropped from the
    returned tree as soon as it is sliced (the caller's references keep
    theirs); a mesh of one returns ``params``."""
    if mesh is None or mesh.size == 1:
        return params
    moe = "router" in params["layers"]
    if specs is None:
        if moe and tp_size(mesh) > 1:
            raise NotImplementedError(
                "a MoE tree under tensor parallelism (tp="
                f"{tp_size(mesh)}) is not ported yet (ROADMAP Queue 1 item "
                "7b); MoE trees shard their experts over ep")
        specs = moe_param_specs(cfg) if moe else param_specs(cfg)
    if tp_size(mesh) > 1:
        _check_tp(cfg, tp_size(mesh))
    out = {"embed": None, "layers": dict.fromkeys(params["layers"]),
           "norm": None, "lm_head": None}
    for key in ("embed", "norm", "lm_head"):
        out[key] = shard_leaf(params[key], specs[key], mesh)
    for key, leaf in params["layers"].items():
        out["layers"][key] = shard_leaf(leaf, specs["layers"][key], mesh)
    return out


def local_kv_heads(cfg: LlamaConfig, mesh: Optional[Mesh]) -> int:
    """The KV heads one rank holds."""
    tp = tp_size(mesh)
    if cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} does not divide n_kv_heads="
                         f"{cfg.n_kv_heads}")
    return cfg.n_kv_heads // tp


def _reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A row-parallel partial product summed over ``tp`` ("g")."""
    return x if tp_size(mesh) == 1 else mesh.reduce_from(x, "tp")


def _copy(h: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A column-parallel product's input ("f"): its gradient summed over
    ``tp`` in the backward."""
    return h if tp_size(mesh) == 1 else mesh.copy_to(h, "tp")


def _embed(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
           mesh: Optional[Mesh]) -> torch.Tensor:
    """The token embedding; vocab-parallel under tp: each rank looks up
    the tokens in its row range, zeros elsewhere, and the all-reduce
    ("g") adds the one nonzero row to zeros, which is exact. Backward,
    each rank's shard takes the gradient of its own rows only."""
    if tp_size(mesh) == 1:
        return qtake(params["embed"], tokens, cfg.dtype)
    rows = params["embed"].shape[0]
    local = tokens.long() - mesh.coords["tp"] * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    x = qtake(params["embed"], local.clamp(0, rows - 1), cfg.dtype)
    return mesh.reduce_from(torch.where(inside, x, torch.zeros_like(x)),
                            "tp")


def _lm_head(x: torch.Tensor, params: Params,
             mesh: Optional[Mesh]) -> torch.Tensor:
    """fp32 logits; under tp each rank's vocabulary columns gathered in
    rank order."""
    logits = qmm(x, params["lm_head"])
    if tp_size(mesh) > 1:
        logits = mesh.all_gather(logits, "tp", dim=-1)
    return logits.float()


# ---------------------------------------------------------------------------
# KV storage: the padded slot cache and the block-paged pool


def _kv_zeros(cfg: LlamaConfig, rows: int, length: int,
              device: DeviceLike, mesh: Optional[Mesh] = None) -> Cache:
    """Zeroed K and V [L, rows, length, KV, D] (int8 payload +
    per-position bf16 scales under ``cfg.kv_quant``); under tp the
    rank's KV heads, the scales with their payload."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, rows, length, local_kv_heads(cfg, mesh),
             cfg.head_dim)
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
                  device: DeviceLike = "cuda",
                  mesh: Optional[Mesh] = None) -> Cache:
    """The padded slot cache [L, batch, max_seq, KV, D] (KV: the rank's
    heads under tp; every rank holds every slot)."""
    return _kv_zeros(cfg, batch, max_seq, device, mesh)


def init_page_pool(cfg: LlamaConfig, pages: int, page_size: int,
                   device: DeviceLike = "cuda",
                   mesh: Optional[Mesh] = None) -> Pool:
    """KV page pool [L, pages, page_size, KV, D] (KV: the rank's heads
    under tp; every rank holds every page). Who owns which page is host
    bookkeeping (``models.paging.PagePool``), the same on every rank."""
    return _kv_zeros(cfg, pages, page_size, device, mesh)


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


def _use_flash_decode(cfg: LlamaConfig, device: torch.device,
                      mesh: Optional[Mesh] = None) -> bool:
    """Route decode attention (slot cache and paged pool): ``auto`` takes
    the CUDA kernel on a CUDA device and the dense read on the CPU;
    ``flash`` forces the kernel wrapper; ``dense`` the dense read. The
    reference's lane-128 conditions do not carry over; its mesh rule
    does, widened to ep and sp: the kernel serves no mesh, a mesh of one,
    or a mesh over tp (whose axis divides the KV heads: each rank runs it
    on its heads), ep and sp (decode attention is replicated over both:
    each rank runs it on every head of its whole pool), and a forced
    ``flash`` on any other mesh raises."""
    mode = cfg.decode_attn
    if mode not in ("auto", "dense", "flash"):
        # a typo'd mode must not silently measure the dense path
        raise ValueError(f"decode_attn={mode!r}: expected one of 'auto', "
                         "'dense', 'flash'")
    mesh_ok = (mesh is None or mesh.size == 1
               or (all(n == 1 for ax, n in mesh.shape.items()
                       if ax not in ("tp", "ep", "sp"))
                   and cfg.n_kv_heads % mesh.shape["tp"] == 0))
    if mode == "flash" and not mesh_ok:
        raise ValueError(
            f"decode_attn='flash' needs an unsharded or tp-only mesh whose "
            f"axis divides the KV heads, beside ep and sp (over which "
            f"decode attention is replicated); got {dict(mesh.shape)}")
    if mode == "dense":
        return False
    return mode == "flash" or (device.type == "cuda" and mesh_ok)


def _decode_body(cfg: LlamaConfig, params: Params, pool: Pool,
                 tokens: torch.Tensor, rope_fn: Callable, cache_write,
                 attn: Callable, logit_index: Optional[int] = None,
                 all_positions: bool = False,
                 ffn_override: Optional[FfnOverride] = None,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
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
    :func:`make_moe_ffn`); None keeps the dense SwiGLU. Under ``mesh``
    the heads and FFN columns are the rank's (module doc)."""
    b, s = tokens.shape
    layers = params["layers"]
    x = _embed(cfg, params, tokens, mesh)                      # [B, S, D]
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        k_cache, v_cache = pool["k"][i], pool["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        # -1: the rank's heads under tp
        q = qmm(h, lp["wq"]).reshape(b, s, -1, cfg.head_dim)
        k = qmm(h, lp["wk"]).reshape(b, s, -1, cfg.head_dim)
        v = qmm(h, lp["wv"]).reshape(b, s, -1, cfg.head_dim)
        q = rope_fn(q)
        k = rope_fn(k)
        cache_write(k_cache, k)
        cache_write(v_cache, v)
        o = attn(q, k_cache, v_cache)
        x = x + _reduce(qmm(o.reshape(b, s, -1), lp["wo"]), mesh)
        if ffn_override is not None:
            x = ffn_override(x, lp)
        else:
            x = ffn_block(cfg, x, lp, mesh)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if not all_positions:
        x = x[:, -1, :] if logit_index is None else x[:, logit_index, :]
    return _lm_head(x, params, mesh)


def decode_step_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                      table: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor,
                      rope: Optional[torch.Tensor] = None,
                      ffn_override: Optional[FfnOverride] = None,
                      mesh: Optional[Mesh] = None
                      ) -> Tuple[torch.Tensor, Pool]:
    """One decode step against the paged pool.

    ``tokens``/``lengths`` [B] int32; ``table`` [B, MP] int32 maps each
    stream's logical page to a physical pool page. Stream b's new K/V
    row lands at (table[b, lengths[b] // ps], lengths[b] % ps) and it
    attends to ``lengths[b] + 1`` positions, through the CUDA kernel or
    the dense gather (:func:`_use_flash_decode`). Inactive
    streams point their table rows at a scratch page. ``ffn_override``
    as in :func:`_decode_body`; under ``mesh`` the pool holds the rank's
    KV heads. Returns (logits [B, V] fp32, pool updated in place)."""
    rope = _rope_table(cfg, rope, tokens.device)
    ps = pool["k"].shape[2]
    mp = table.shape[1]
    # clip: a stream retired mid-window keeps advancing past its table;
    # its row is all scratch, so the clipped write lands there
    page_idx = torch.clamp(lengths // ps, 0, mp - 1).long()
    phys = torch.gather(table, 1, page_idx[:, None])[:, 0]
    offs = lengths % ps
    kv_len = (lengths + 1).to(torch.int32)
    flash = _use_flash_decode(cfg, tokens.device, mesh)

    def cache_write(cache, new):
        _page_write(cache, new[:, 0], phys, offs)

    def attn(q, k_cache, v_cache):
        if flash:
            if not supports_decode_paged(q, k_cache, ps):
                raise ValueError(_outside_gate(cfg, "paged decode"))
            if tp_size(mesh) > 1:
                return flash_decode_paged_tp(q, k_cache, v_cache, table,
                                             kv_len, mesh,
                                             kv_heads=cfg.n_kv_heads)
            return flash_decode_paged(q, k_cache, v_cache, table, kv_len)
        k_read = _gather_pages(k_cache, table, cfg.dtype)
        v_read = _gather_pages(v_cache, table, cfg.dtype)
        return gqa_attention(q, k_read, v_read, causal=False, kv_len=kv_len)

    logits = _decode_body(cfg, params, pool, tokens[:, None],
                          rope_fn=lambda t: apply_rope_at(t, rope, lengths),
                          cache_write=cache_write, attn=attn,
                          ffn_override=ffn_override, mesh=mesh)
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


def _slot_attn(cfg: LlamaConfig, device: torch.device, kv_len,
               mesh: Optional[Mesh] = None) -> Callable:
    """The decode read of the slot cache: the slot kernel (through
    :func:`_use_flash_decode`; under tp on the rank's heads) or the dense
    read of the whole cache, masked at ``kv_len`` [B]."""
    flash = _use_flash_decode(cfg, device, mesh)

    def attn(q, k_cache, v_cache):
        if flash:
            if not supports_decode(q, k_cache):
                raise ValueError(_outside_gate(cfg, "slot decode"))
            if tp_size(mesh) > 1:
                return flash_decode_tp(q, k_cache, v_cache, kv_len, mesh,
                                       kv_heads=cfg.n_kv_heads)
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
                ffn_override: Optional[FfnOverride] = None,
                mesh: Optional[Mesh] = None
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
        attn=_slot_attn(cfg, token.device, kv_len, mesh),
        ffn_override=ffn_override, mesh=mesh)
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
                      rope: Optional[torch.Tensor] = None,
                      mesh: Optional[Mesh] = None
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
        attn=_slot_attn(cfg, tokens.device, lengths + 1, mesh), mesh=mesh)
    return logits, cache


def prefill_chunk_paged(cfg: LlamaConfig, params: Params, pool: Pool,
                        table: torch.Tensor, tokens: torch.Tensor,
                        start: int, true_len: int, logit_index: int,
                        scratch_page: int,
                        rope: Optional[torch.Tensor] = None,
                        ffn_override: Optional[FfnOverride] = None,
                        mesh: Optional[Mesh] = None
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
        ffn_override=ffn_override, mesh=mesh)
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


def _padded_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  attend: Callable = flash_attention,
                  q_offset: int = 0) -> torch.Tensor:
    """Causal flash attention at any head_dim up to 256 (``attend``,
    :func:`flash_attention` or a tp rank's ``flash_attention_tp``): q/k/v
    are zero-padded to the next kernel width and the softmax keeps the
    true width's scale. The zero columns add nothing to Q.K^T, the
    output's padded columns are zero and cut away, and the gradients of
    the padding are dropped by the pad's own backward. Query row ``i``
    sits at position ``q_offset + i`` of the keys."""
    d = q.shape[-1]
    width = next(w for w in HEAD_DIMS if w >= d)
    if width == d:
        return attend(q, k, v, causal=True, q_offset=q_offset)
    pad = (0, width - d)
    o = attend(torch.nn.functional.pad(q, pad),
               torch.nn.functional.pad(k, pad),
               torch.nn.functional.pad(v, pad), causal=True,
               sm_scale=d ** -0.5, q_offset=q_offset)
    return o[..., :d]


ATTN_IMPLS = ("auto", "dense", "flash", "ring", "ulysses")


def resolve_attn(cfg: LlamaConfig, mesh: Optional[Mesh] = None) -> str:
    """``cfg.attn_impl`` with ``auto`` resolved under a mesh of more than
    one process: ``ring`` when its ``sp`` axis is larger than 1 (the
    worker's rule), else ``dense`` (the reference's ``auto`` under a
    mesh). ``auto`` stays for :func:`attn_route` otherwise."""
    impl = cfg.attn_impl
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={impl!r}: expected one of "
                         f"{', '.join(map(repr, ATTN_IMPLS))}")
    if impl == "auto" and mesh is not None and mesh.size > 1:
        return "ring" if sp_size(mesh) > 1 else "dense"
    return impl


def _make_attn_fn(cfg: LlamaConfig, device: torch.device,
                  mesh: Optional[Mesh] = None) -> Callable:
    """f(q, k, v) for q [B, S, H, D], k/v [B, S, KV, D], causal, the
    rank's heads and sequence shard under ``mesh``.

    ``ring`` and ``ulysses`` (:func:`resolve_attn`) shard the sequence
    over sp: the ring takes the RAW KV heads in ``cfg.ring_layout``,
    Ulysses the heads repeated to the query heads, as the reference;
    without a mesh both are dense, as the reference's. The port's shards
    need tp to divide the KV heads (``shard_params``), so the
    reference's repeated-heads ring (tp not dividing KV) is refused
    before it. ``dense`` and ``flash`` (routed per call by
    :func:`attn_route`) keep the global attention under sp: K/V gathered
    over sp with :meth:`Mesh.gather_seq`, the rank's queries at its
    offset (the contiguous layout). Under tp ``flash`` runs the kernels
    on the rank's heads through ``flash_attention_tp``, which checks
    that the model's KV heads divide over ``tp``."""
    impl = resolve_attn(cfg, mesh)
    if impl in ("ring", "ulysses") and mesh is None:
        impl = "dense"
    if impl == "ring":
        def ring(q, k, v):
            return ring_attention(q, k, v, mesh, causal=True,
                                  layout=cfg.ring_layout)
        return ring
    if impl == "ulysses":
        rep = cfg.n_heads // cfg.n_kv_heads

        def ulysses(q, k, v):
            return ulysses_attention(q, repeat_kv(k, rep), repeat_kv(v, rep),
                                     mesh, causal=True)
        return ulysses
    attend = flash_attention
    if tp_size(mesh) > 1:
        def attend(q, k, v, **kw):
            return flash_attention_tp(q, k, v, mesh,
                                      kv_heads=cfg.n_kv_heads, **kw)
    sp = sp_size(mesh)

    def attn(q, k, v):
        offset = 0
        if sp > 1:
            # one gather for K and V; the rank's queries at their offset
            k, v = mesh.gather_seq(torch.stack([k, v]), "sp",
                                   dim=2).unbind(0)
            offset = mesh.coords["sp"] * q.shape[1]
        if attn_route(impl, device.type, q, k) == "flash":
            return _padded_flash(q, k, v, attend, q_offset=offset)
        return gqa_attention(q, k, v, causal=True, q_offset=offset)

    return attn


def attention_block(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
                    rope: torch.Tensor, attn_fn: Callable,
                    return_kv: bool = False, mesh: Optional[Mesh] = None):
    """Pre-norm attention residual step on x [B, S, D]. With
    ``return_kv`` also returns the rope'd K/V (the prefill cache
    contract, what ``decode_step`` writes). Under ``mesh`` the rank's
    heads: the normed input through "f", the ``wo`` output through
    "g"."""
    b, s, _ = x.shape
    h = _copy(rms_norm(x, lp["attn_norm"], cfg.norm_eps), mesh)
    q = qmm(h, lp["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = qmm(h, lp["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = qmm(h, lp["wv"]).reshape(b, s, -1, cfg.head_dim)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    o = attn_fn(q, k, v)             # GQA expansion is the impl's business
    out = x + _reduce(qmm(o.reshape(b, s, -1), lp["wo"]), mesh)
    return (out, k, v) if return_kv else out


def ffn_block(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Pre-norm SwiGLU residual step on x [B, S, D]; silu in fp32 on the
    matmul output, as the reference. Under ``mesh`` the rank's FFN
    columns: the normed input through "f", the ``w_down`` output through
    "g"."""
    h = _copy(rms_norm(x, lp["ffn_norm"], cfg.norm_eps), mesh)
    gate = F.silu(qmm(h, lp["w_gate"]).float())
    up = qmm(h, lp["w_up"]).float()
    return x + _reduce(qmm((gate * up).to(cfg.dtype), lp["w_down"]), mesh)


def apply_layer(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
                rope: torch.Tensor, attn_fn: Callable,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One decoder layer on activations x [B, S, D]."""
    return ffn_block(cfg, attention_block(cfg, x, lp, rope, attn_fn,
                                          mesh=mesh), lp, mesh)


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            mesh: Optional[Mesh] = None,
            positions: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] fp32, or with
    ``return_hidden`` the final-norm hidden states [B, S, D] (the fused
    loss's input). ``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant).

    ``positions`` (optional [S] ints): the global position of each
    sequence slot, for layouts where slot != position (the zigzag ring
    layout, or a sequence shard): rope reads the table at them. Under a
    ``mesh`` whose ``sp`` is larger than 1, ``tokens`` are this rank's
    ``S/sp`` slots, at ``positions`` or by default the rank's contiguous
    shard; attention follows :func:`_make_attn_fn`.

    Under a tp ``mesh`` (``params`` the rank's shards) each rank computes
    its heads and FFN columns with Megatron's pair (module doc); the
    logits are gathered whole in rank order (their backward takes the
    rank's columns), the hidden states are whole on every rank. With
    ``remat`` the backward recomputes each layer's forward up to its last
    saved tensor (torch's non-reentrant early stop), the attention
    block's "g" all-reduce included: every rank recomputes the same
    layers in the same order, so the collectives still pair up."""
    if cfg.remat and cfg.remat_policy:
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet "
            "(ROADMAP Queue 1 item 2)")
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=tokens.device)
    if positions is None and sp_size(mesh) > 1:
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device) \
            + mesh.coords["sp"] * s
    if positions is not None:
        rope = rope[:, positions.to(tokens.device).long()]
    attn_fn = _make_attn_fn(cfg, tokens.device, mesh)
    layers = params["layers"]
    x = _embed(cfg, params, tokens, mesh)
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x = _remat(cfg, apply_layer, cfg, x, lp, rope, attn_fn, mesh)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if return_hidden:
        return x
    logits = qmm(_copy(x, mesh), params["lm_head"]).float()
    return logits if tp_size(mesh) == 1 else mesh.gather_from(logits, "tp")


def loss_fn(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            mesh: Optional[Mesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token LM loss over tokens [B, S] -> (loss, accuracy), with
    z-loss 1e-4. ``cfg.fused_ce`` (the default) runs the lm_head inside
    ``fused_linear_cross_entropy``'s sequence-blocked loop, under tp
    vocabulary-parallel over the rank's ``lm_head`` columns; unfused,
    the logits are gathered whole (:func:`forward`) and every rank takes
    the loss of the whole vocabulary.

    With the zigzag ring (:func:`resolve_attn` ``ring`` and
    ``cfg.ring_layout == "zigzag"`` under a mesh), inputs AND targets
    are permuted into the layout order after the shift, as the
    reference's: cross entropy is invariant under a permutation that
    keeps each input with its target. Under sp every rank holds the
    whole ``tokens`` and keeps its ``S/sp`` slice of the (laid-out)
    pairs; its loss and accuracy are means over its slice, averaged
    over sp (:meth:`Mesh.all_reduce_mean`: the equal slices make it the
    mean over every token of the sequence, and each rank backpropagates
    its own slice's mean)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    sp = sp_size(mesh)
    positions = None
    if (mesh is not None and resolve_attn(cfg, mesh) == "ring"
            and cfg.ring_layout == "zigzag"):
        positions = torch.from_numpy(zigzag_indices(inputs.shape[1], sp)
                                     ).to(tokens.device).long()
        inputs, targets = inputs[:, positions], targets[:, positions]
    if sp > 1:
        s = inputs.shape[1]
        if s % sp:
            raise ValueError(f"sequence parallelism: {s} positions do not "
                             f"divide over sp={sp}")
        at, n = mesh.coords["sp"] * (s // sp), s // sp
        inputs, targets = inputs[:, at:at + n], targets[:, at:at + n]
        positions = (torch.arange(at, at + n, device=tokens.device)
                     if positions is None else positions[at:at + n])
    if cfg.fused_ce:
        x = forward(cfg, params, inputs, mesh, positions=positions,
                    return_hidden=True)
        loss, acc = fused_linear_cross_entropy(
            x, params["lm_head"], targets, z_loss=1e-4,
            block_size=cfg.fused_ce_block,
            mesh=mesh if tp_size(mesh) > 1 else None)
    else:
        logits = forward(cfg, params, inputs, mesh, positions=positions)
        loss, acc = softmax_cross_entropy(logits, targets, z_loss=1e-4)
    if sp > 1:
        loss, acc = mesh.all_reduce_mean(torch.stack([loss, acc]),
                                         "sp").unbind(0)
    return loss, acc.detach()


# ---------------------------------------------------------------------------
# expert- and pipeline-parallel training


def _dense_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """The causal dense attention that the reference's MoE and pipelined
    forwards hard-code."""
    return gqa_attention(q, k, v, causal=True)


def _remat(cfg: LlamaConfig, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward when ``cfg.remat``
    (non-reentrant: collectives inside are recomputed in one order on
    every rank)."""
    if cfg.remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def moe_param_specs(cfg: LlamaConfig) -> Params:
    """The reference's MoE sharding: the expert banks over ``ep``,
    everything else replicated."""
    del cfg
    return {"embed": (),
            "layers": {"attn_norm": (), "wq": (), "wk": (), "wv": (),
                       "wo": (), "ffn_norm": (), "router": (),
                       "w_in": (None, "ep"), "w_out": (None, "ep")},
            "norm": (),
            "lm_head": ()}


def forward_moe(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                mesh: Optional[Mesh], moe_cfg: MoEConfig,
                return_hidden: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE decoder forward: dense causal attention, the FFN replaced
    by the routed expert layer, all B*S tokens one group
    (``parallel.moe.make_moe`` over ``ep``; without an ``ep`` axis
    larger than 1, ``moe_apply_local``). Returns (logits [B, S, V] fp32,
    or with ``return_hidden`` the final-norm hidden states; the mean
    auxiliary loss over the layers, fp32). ``tokens`` are the whole batch
    on every rank; ``params`` the rank's shards under
    :func:`moe_param_specs`."""
    from ..parallel.moe import make_moe

    b, s = tokens.shape
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=tokens.device)
    if mesh is not None and mesh.shape["ep"] > 1:
        moe_fn = make_moe(mesh, moe_cfg)
    else:
        def moe_fn(flat, rw, wi, wo):
            return moe_apply_local(flat, rw, wi, wo, moe_cfg)

    def layer(x, lp):
        x = attention_block(cfg, x, lp, rope, _dense_attn)
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        out, aux = moe_fn(h.reshape(b * s, -1), lp["router"], lp["w_in"],
                          lp["w_out"])
        return x + out.reshape(b, s, -1).to(cfg.dtype), aux.float()

    x = _embed(cfg, params, tokens, None)
    aux_sum = torch.zeros((), device=tokens.device)
    for i in range(cfg.n_layers):
        x, aux = _remat(cfg, layer, x,
                        {k: w[i] for k, w in params["layers"].items()})
        aux_sum = aux_sum + aux
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    aux = aux_sum / cfg.n_layers
    if return_hidden:
        return x, aux
    return (x @ params["lm_head"]).float(), aux


def loss_fn_moe(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                mesh: Optional[Mesh], moe_cfg: MoEConfig,
                aux_weight: float = 0.01
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token loss (z-loss 1e-4, fused unless ``cfg.fused_ce`` is
    off) plus ``aux_weight`` times the auxiliary load-balance loss ->
    (loss, accuracy). Every rank computes the whole objective."""
    if cfg.fused_ce:
        x, aux = forward_moe(cfg, params, tokens[:, :-1], mesh, moe_cfg,
                             return_hidden=True)
        loss, acc = fused_linear_cross_entropy(
            x, params["lm_head"], tokens[:, 1:], z_loss=1e-4,
            block_size=cfg.fused_ce_block)
    else:
        logits, aux = forward_moe(cfg, params, tokens[:, :-1], mesh,
                                  moe_cfg)
        loss, acc = softmax_cross_entropy(logits, tokens[:, 1:], z_loss=1e-4)
    return loss + aux_weight * aux, acc.detach()


def stack_pipeline_params(params: Params, pp: int) -> Params:
    """The layer stacks [L, ...] as [pp, L/pp, ...] (views), the
    pipeline's stage axis first; the embedding, final norm and lm_head
    stay as they are."""
    layers = {k: w.reshape(pp, w.shape[0] // pp, *w.shape[1:])
              for k, w in params["layers"].items()}
    return {**params, "layers": layers}


def pipeline_param_specs(cfg: LlamaConfig) -> Params:
    """The pipelined layout's sharding: every layer stack over ``pp``,
    the rest replicated."""
    return {"embed": (),
            "layers": {k: ("pp",) for k in param_specs(cfg)["layers"]},
            "norm": (),
            "lm_head": ()}


def forward_pipelined(cfg: LlamaConfig, params: Params,
                      tokens: torch.Tensor, mesh: Optional[Mesh],
                      n_micro: int, return_hidden: bool = False
                      ) -> torch.Tensor:
    """The pipeline-parallel forward: the decoder trunk stage-sharded
    over ``pp`` (``params`` in the :func:`stack_pipeline_params` layout,
    this rank's ``[1, L/pp, ...]`` stage under
    :func:`pipeline_param_specs`), ``n_micro`` microbatches of the whole
    batch ``tokens`` streaming through the GPipe schedule
    (``parallel.pipeline``), dense causal attention; the embedding, final
    norm and lm_head run replicated outside the pipe. Returns the logits
    [B, S, V] fp32, or with ``return_hidden`` the final-norm hidden
    states."""
    from ..parallel.pipeline import make_pipeline

    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} "
                         "microbatches")
    rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=tokens.device)
    x = _embed(cfg, params, tokens, None)
    xm = x.reshape(n_micro, b // n_micro, s, -1)

    def stage_fn(stage_layers, x_mb):
        for i in range(next(iter(stage_layers.values())).shape[0]):
            lp = {k: w[i] for k, w in stage_layers.items()}
            x_mb = _remat(cfg, apply_layer, cfg, x_mb, lp, rope,
                          _dense_attn)
        return x_mb

    if mesh is not None and mesh.shape["pp"] > 1:
        x = make_pipeline(mesh, stage_fn)(params["layers"], xm)
    else:
        x = torch.stack([stage_fn({k: w.flatten(0, 1) for k, w in
                                   params["layers"].items()}, mb)
                         for mb in xm])
    x = rms_norm(x.reshape(b, s, -1), params["norm"], cfg.norm_eps)
    if return_hidden:
        return x
    return (x @ params["lm_head"]).float()


def loss_fn_pipelined(cfg: LlamaConfig, params: Params,
                      tokens: torch.Tensor, mesh: Optional[Mesh],
                      n_micro: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token loss of :func:`forward_pipelined` (z-loss 1e-4, fused
    unless ``cfg.fused_ce`` is off) -> (loss, accuracy). Every rank
    computes the whole objective."""
    if cfg.fused_ce:
        x = forward_pipelined(cfg, params, tokens[:, :-1], mesh, n_micro,
                              return_hidden=True)
        loss, acc = fused_linear_cross_entropy(
            x, params["lm_head"], tokens[:, 1:], z_loss=1e-4,
            block_size=cfg.fused_ce_block)
    else:
        logits = forward_pipelined(cfg, params, tokens[:, :-1], mesh,
                                   n_micro)
        loss, acc = softmax_cross_entropy(logits, tokens[:, 1:], z_loss=1e-4)
    return loss, acc.detach()


# ---------------------------------------------------------------------------
# prefill and solo generation on the slot cache


def _prefill_attn(cfg: LlamaConfig, device: torch.device,
                  mesh: Optional[Mesh]) -> Callable:
    """:func:`prefill_trunk`'s causal attention: the flash forward kernel
    where decode takes its kernel (on the rank's heads under tp), dense
    attention elsewhere."""
    if not _use_flash_decode(cfg, device, mesh):
        return lambda q, k, v: gqa_attention(q, k, v, causal=True)
    if tp_size(mesh) > 1:
        return lambda q, k, v: flash_attention_tp(
            q, k, v, mesh, causal=True, kv_heads=cfg.n_kv_heads)
    return lambda q, k, v: flash_attention(q, k, v, causal=True)


def prefill_trunk(cfg: LlamaConfig, params: Params, prompt: torch.Tensor,
                  rope: torch.Tensor, mesh: Optional[Mesh] = None,
                  attn_fn: Optional[Callable] = None,
                  ffn_override: Optional[FfnOverride] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prefill forward shared by :func:`prefill` and the engine's
    bucketed slot prefill: (normed hidden states [B, S, D], ks/vs
    [L, B, S, KV, D]); callers pick the logits position and where the
    K/V land. Causal attention takes the flash-attention forward kernel
    where decode takes its kernel (:func:`_use_flash_decode`: on a CUDA
    device, any S, a shape outside its gate raises) and the dense path
    elsewhere; the reference's ``S % 128`` gate does not carry over.
    Under ``mesh`` the ks/vs are the rank's KV heads and each rank runs
    the kernel on its own heads. ``attn_fn`` replaces that choice of
    attention (:func:`prefill_ring` passes the ring) and
    ``ffn_override(x, lp)`` the FFN residual step."""
    if attn_fn is None:
        attn_fn = _prefill_attn(cfg, prompt.device, mesh)
    layers = params["layers"]
    x = _embed(cfg, params, prompt, mesh)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x, k, v = attention_block(cfg, x, lp, rope, attn_fn, return_kv=True,
                                  mesh=mesh)
        x = (ffn_override(x, lp) if ffn_override is not None
             else ffn_block(cfg, x, lp, mesh))
        ks.append(k)
        vs.append(v)
    return (rms_norm(x, params["norm"], cfg.norm_eps), torch.stack(ks),
            torch.stack(vs))


def prefill(cfg: LlamaConfig, params: Params, cache: Cache,
            prompt: torch.Tensor, rope: Optional[torch.Tensor] = None,
            mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Cache]:
    """One forward over the whole prompt [B, S], every layer's K/V
    written into the cache at positions [0, S) in place. Returns
    (last-position logits [B, V] fp32, cache)."""
    rope = _rope_table(cfg, rope, prompt.device)
    x, ks, vs = prefill_trunk(cfg, params, prompt, rope, mesh)
    logits = _lm_head(x[:, -1, :], params, mesh)
    _cache_update(cache["k"], ks, 0, 2)
    _cache_update(cache["v"], vs, 0, 2)
    return logits, cache


def prefill_ring(cfg: LlamaConfig, params: Params, prompt: torch.Tensor,
                 mesh: Mesh, rope: Optional[torch.Tensor] = None,
                 ffn_override: Optional[FfnOverride] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-parallel prefill on one rank of a mesh whose ``sp`` axis
    is larger than 1: :func:`prefill_trunk`'s contract for the rank's
    contiguous shard of the sequence. Every rank passes the WHOLE padded
    prompt [B, S] and gets back its own S/sp positions: the normed hidden
    states [B, S/sp, D] and ks/vs [L, B, S/sp, KV, D], rope'd at their
    global positions. Attention is :func:`~dcos_commons_tpu_torch.
    parallel.ring_attention.ring_attention` in the contiguous layout (the
    zigzag's permuted order would not install into a page table), so a
    rank pays about S/sp of the attention work. Runs without autograd.

    The caller pads the prompt to an sp-divisible length
    (``ring_attention.ring_pad_len``); padded positions compute K/V that
    the serving engine sends to scratch or never reads. Raises
    ValueError, as the reference does, without an sp axis larger than
    1, when sp does not divide S, or when S is over ``cfg.max_seq`` (the
    rope table's bound); under tp, which the reference's serving worker
    never builds with the ring, too."""
    s = prompt.shape[1]
    sp = sp_size(mesh)
    if sp <= 1:
        raise ValueError("prefill_ring needs an 'sp' mesh axis > 1; got "
                         f"{dict(mesh.shape) if mesh is not None else None}")
    if s % sp:
        raise ValueError(f"ring prefill needs S ({s}) % sp ({sp}) == 0; pad "
                         "the prompt with ring_attention.ring_pad_len")
    if s > cfg.max_seq:
        raise ValueError(f"padded prompt {s} exceeds max_seq {cfg.max_seq}")
    if tp_size(mesh) > 1:
        raise ValueError(f"ring prefill under tp={tp_size(mesh)} is not "
                         "ported (the reference's worker never builds it)")
    n = s // sp
    at = mesh.coords["sp"] * n
    rope = _rope_table(cfg, rope, prompt.device)[:, at:at + n]

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh, causal=True,
                              layout="contiguous")

    with torch.no_grad():
        return prefill_trunk(cfg, params, prompt[:, at:at + n], rope,
                             attn_fn=ring, ffn_override=ffn_override)


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
             steps: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Greedy generation: prefill, then ``steps`` decode steps; returns
    [B, steps] (the first token from the prefill logits). The fused
    program and the host-driven loop of the reference are one loop
    here, so :func:`generate_stepwise` is this function."""
    b, s = prompt.shape
    _check_capacity(cfg, s, steps)
    cache = init_kv_cache(cfg, b, cfg.max_seq, device=prompt.device,
                          mesh=mesh)
    rope = _rope_table(cfg, None, prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt, rope=rope, mesh=mesh)
    toks = []
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        logits, cache = decode_step(cfg, params, cache, s + i, tok, rope=rope,
                                    mesh=mesh)
        toks.append(tok)
    if not toks:
        return torch.zeros((b, 0), dtype=prompt.dtype, device=prompt.device)
    return torch.stack(toks, dim=1)


generate_stepwise = generate


# ---------------------------------------------------------------------------
# mixture of experts: the routed FFN of the serving paths


def make_moe_ffn(cfg: LlamaConfig, moe_cfg: MoEConfig,
                 mesh: Optional[Mesh] = None) -> FfnOverride:
    """The ``ffn_override`` that routes :func:`_decode_body`'s FFN step
    through the MoE layer: every token of the call (all B*S rows, padded
    and masked ones included) is one dispatch group. On a mesh whose
    ``ep`` axis is larger than 1 (``lp``'s banks the rank's experts) it
    is :func:`~dcos_commons_tpu_torch.parallel.moe.moe_apply`, whose two
    all-to-alls carry the [E, C, D] buffers; without one,
    :func:`~dcos_commons_tpu_torch.parallel.moe.moe_apply_local`, the
    same products expert by expert. The auxiliary loss is dead weight at
    inference and is dropped. Under tp it is not ported yet (ROADMAP
    Queue 1 item 7b)."""
    from ..parallel.moe import moe_apply

    ep = mesh.shape["ep"] if mesh is not None else 1
    if tp_size(mesh) > 1:
        raise NotImplementedError(
            f"MoE under tensor parallelism (tp={tp_size(mesh)}) is not "
            "ported yet (ROADMAP Queue 1 item 7b)")
    if moe_cfg.num_experts % ep:
        raise ValueError(f"num_experts={moe_cfg.num_experts} not divisible "
                         f"by ep={ep}")

    def ffn(x: torch.Tensor, lp: Params) -> torch.Tensor:
        b, s, d = x.shape
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        if ep > 1:
            out, _ = moe_apply(h.reshape(b * s, d), lp["router"],
                               lp["w_in"], lp["w_out"], moe_cfg, mesh)
        else:
            out, _ = moe_apply_local(h.reshape(b * s, d), lp["router"],
                                     lp["w_in"], lp["w_out"], moe_cfg)
        return x + out.reshape(b, s, d).to(cfg.dtype)

    return ffn


def generate_stepwise_moe(cfg: LlamaConfig, params: Params,
                          prompt: torch.Tensor, steps: int,
                          moe_cfg: MoEConfig,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Greedy MoE generation, the serving parity reference: the whole
    prompt in one :func:`extend_step`, then one :func:`decode_step` per
    token (on a CUDA device through the slot-cache decode kernel), both
    with the :func:`make_moe_ffn` override (over ``mesh``'s ep axis,
    ``params`` the rank's experts; the attention whole on every rank).
    Returns [B, steps]. The paged
    engine routes each prefill chunk and decode batch as its own group,
    this reference the whole prompt and then one token at a time: the
    two agree token for token only under dropless capacity
    (``parallel.moe.dropless``)."""
    b, s = prompt.shape
    _check_capacity(cfg, s, steps)
    cache = init_kv_cache(cfg, b, cfg.max_seq, device=prompt.device)
    rope = _rope_table(cfg, None, prompt.device)
    ffn = make_moe_ffn(cfg, moe_cfg, mesh)
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
                        generator: Optional[torch.Generator] = None,
                        mesh: Optional[Mesh] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """``steps`` decode steps from ``token`` [B] at position ``pos``:
    (toks [B, steps], every step's logits [B, steps, V], cache). Greedy
    unless ``sampler`` (drawing from ``generator``) is given."""
    rope = _rope_table(cfg, rope, token.device)
    toks, logits_all = [], []
    tok = token
    for i in range(steps):
        logits, cache = decode_step(cfg, params, cache, pos + i, tok,
                                    rope=rope, mesh=mesh)
        tok = _select(sampler, generator, logits, token.dtype)
        toks.append(tok)
        logits_all.append(logits)
    return torch.stack(toks, dim=1), torch.stack(logits_all, dim=1), cache


def decode_chunk(cfg: LlamaConfig, params: Params, cache: Cache, pos: int,
                 token: torch.Tensor, steps: int,
                 rope: Optional[torch.Tensor] = None,
                 sampler: Optional[Sampler] = None,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """:func:`decode_chunk_logits` without the logits: (toks [B, steps],
    cache)."""
    toks, _, cache = decode_chunk_logits(cfg, params, cache, pos, token,
                                         steps, rope=rope, sampler=sampler,
                                         generator=generator, mesh=mesh)
    return toks, cache


def generate_chunked(cfg: LlamaConfig, params: Params, prompt: torch.Tensor,
                     steps: int, chunk: int = 16,
                     sampler: Optional[Sampler] = None,
                     generator: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Generation in chunks of ``chunk`` decode steps (the worker's solo
    decode): the first token from the prefill logits, then whole chunks,
    trimmed to [B, steps]. Greedy unless ``sampler`` is given. The last
    chunk may run past ``steps`` and past the cache: its writes clamp
    onto the last row after every kept token was computed, as in the
    reference. Under ``mesh`` a sampler must draw the same on every rank
    (the same generator seed)."""
    b, s = prompt.shape
    _check_capacity(cfg, s, steps)
    cache = init_kv_cache(cfg, b, cfg.max_seq, device=prompt.device,
                          mesh=mesh)
    rope = _rope_table(cfg, None, prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt, rope=rope, mesh=mesh)
    tok = _select(sampler, generator, logits, prompt.dtype)
    out = [tok[:, None]]
    emitted, pos = 1, s
    while emitted < steps:
        toks, cache = decode_chunk(cfg, params, cache, pos, tok, chunk,
                                   rope=rope, sampler=sampler,
                                   generator=generator, mesh=mesh)
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
