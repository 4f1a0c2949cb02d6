"""Flash attention, forward and backward (port of
``dcos_commons_tpu/ops/flash_attention.py``).

* :func:`flash_attention` is a ``torch.autograd.Function``: its forward
  saves O and the per-row logsumexp, its backward recomputes P from them
  (FlashAttention-2). On CUDA tensors both directions launch the CUDA
  kernels of ``csrc/flash_attention_fwd.cu`` and
  ``csrc/flash_attention_bwd.cu``; on CPU tensors they run the plain
  versions. It never falls back from a kernel: a CUDA tensor outside
  :func:`supports` raises.
* :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dkdv` and
  :func:`flash_attention_bwd_dq` are the three kernel wrappers; each
  counts its launches in ``.launches``.
* :func:`flash_attention_reference` (forward, returns ``(o, lse)``),
  :func:`flash_attention_bwd_dkdv_reference` and
  :func:`flash_attention_bwd_dq_reference` (from lse and
  ``delta = rowsum(dO * O)``, :func:`attention_delta`) are the plain
  PyTorch versions of the three kernels, in fp32;
  :func:`flash_attention_backward_reference` is the whole backward.
* :func:`supports` is the kernels' gate: bf16, head_dim 64, 128 or 256,
  ``H % KV == 0``, any ``Sq`` and ``Sk``. The TPU kernel's
  ``Sq % 8`` / ``Sk % 128`` rules do not apply: the kernels mask the
  ragged tail themselves.

Layout as in ``ops.attention``: q [B, Sq, H, D], k/v [B, Sk, KV, D]; query
head h reads KV head ``h // (H // KV)``. Query row i sits at position
``q_offset + i``; causal rows see keys ``j <= q_offset + i``. A row that
sees no key (``q_offset < 0``) gets output 0, lse ``-1e30`` and zero
gradient. lse is [B, H, Sq] fp32 (the TPU kernel's 8 copied sublanes are
a layout artifact); ``delta`` is left to torch, as the reference leaves
it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

HEAD_DIMS = (64, 128, 256)
_NEG = -1e30
# a saved lse below this marks a row with no live key
_DEAD = _NEG / 2

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_DIMS = [_c_int] * 6            # batch, seq_q, seq_k, heads, kv_heads, D
_TAIL = [_c_float, _c_int, _c_int, _c_void_p]   # scale, causal, q_offset, stream
_FWD_SIGNATURES = {
    "flash_attention_fwd_launch": (_c_int, [_c_void_p] * 5 + _DIMS + _TAIL),
    "flash_attention_fwd_error_string": (ctypes.c_char_p, [_c_int]),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd_dkdv_launch": (
        _c_int, [_c_void_p] * 8 + _DIMS + _TAIL),
    "flash_attention_bwd_dq_launch": (
        _c_int, [_c_void_p] * 7 + _DIMS + _TAIL),
    "flash_attention_bwd_error_string": (ctypes.c_char_p, [_c_int]),
}


def supports(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the CUDA kernels take these shapes and types."""
    return (q.dim() == 4 and k.dim() == 4
            and q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
            and q.shape[-1] in HEAD_DIMS and k.shape[-1] == q.shape[-1]
            and q.shape[0] == k.shape[0] and q.shape[0] >= 1
            and q.shape[1] >= 1 and k.shape[1] >= 1
            and k.shape[2] >= 1 and q.shape[2] % k.shape[2] == 0)


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


# ---------------------------------------------------------------------------
# plain versions (fp32)


def _group(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, KV*n_rep, S, D] fp32: each query head's KV."""
    b, s, kv, d = x.shape
    x = x.float().permute(0, 2, 1, 3)
    return x[:, :, None].expand(b, kv, n_rep, s, d).reshape(b, kv * n_rep,
                                                             s, d)


def _live(s_q: int, s_k: int, causal: bool, q_offset: int,
          device: torch.device) -> Optional[torch.Tensor]:
    """[Sq, Sk] mask of the keys each query row sees (None: all)."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(s_q, device=device)
    return q_pos[:, None] >= torch.arange(s_k, device=device)[None, :]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32: (o [B, Sq, H, D] in q's dtype, lse
    [B, H, Sq] fp32; -1e30 and output 0 on rows that see no key)."""
    n_rep = q.shape[2] // k.shape[2]
    qt = q.float().permute(0, 2, 1, 3)                      # [B, H, Sq, D]
    s = qt @ _group(k, n_rep).transpose(-1, -2) * _scale(q, sm_scale)
    live = _live(q.shape[1], k.shape[1], causal, q_offset, q.device)
    if live is not None:
        s = s.masked_fill(~live, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                        # [B, H, Sq]
    dead = torch.isinf(lse)
    p = torch.exp(s - torch.where(dead, 0.0, lse)[..., None])
    o = (p @ _group(v, n_rep)).permute(0, 2, 1, 3)
    return o.to(q.dtype).contiguous(), torch.where(dead, _NEG, lse)


def _recompute(q, k, v, do, lse, delta, causal, sm_scale, q_offset):
    """P and dS [B, H, Sq, Sk] fp32 from the saved lse and delta."""
    n_rep = q.shape[2] // k.shape[2]
    scale = _scale(q, sm_scale)
    qt = q.float().permute(0, 2, 1, 3)
    dot = do.float().permute(0, 2, 1, 3)
    s = qt @ _group(k, n_rep).transpose(-1, -2) * scale
    alive = lse > _DEAD
    p = torch.exp(s - torch.where(alive, lse, 0.0)[..., None])
    keep = alive[..., None]
    live = _live(q.shape[1], k.shape[1], causal, q_offset, q.device)
    if live is not None:
        keep = keep & live
    p = torch.where(keep, p, 0.0)
    dp = dot @ _group(v, n_rep).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def _group_sum(x: torch.Tensor, kv: int) -> torch.Tensor:
    """[B, H, Sk, D] per query head -> [B, Sk, KV, D] summed per group."""
    b, h, s, d = x.shape
    return x.reshape(b, kv, h // kv, s, d).sum(2).permute(0, 2, 1, 3)


def flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, *,
                                       causal=True, sm_scale=None,
                                       q_offset=0):
    """Plain version of kernel 4: (dk, dv) from lse and delta, summed
    over each GQA group."""
    p, ds = _recompute(q, k, v, do, lse, delta, causal, sm_scale, q_offset)
    kv = k.shape[2]
    dv = p.transpose(-1, -2) @ do.float().permute(0, 2, 1, 3)
    dk = ds.transpose(-1, -2) @ q.float().permute(0, 2, 1, 3)
    return (_group_sum(dk, kv).to(k.dtype).contiguous(),
            _group_sum(dv, kv).to(v.dtype).contiguous())


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, *,
                                     causal=True, sm_scale=None, q_offset=0):
    """Plain version of kernel 5: dq from lse and delta."""
    _, ds = _recompute(q, k, v, do, lse, delta, causal, sm_scale, q_offset)
    dq = ds @ _group(k, q.shape[2] // k.shape[2])
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, [B, H, Sq]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
        sm_scale: Optional[float] = None, q_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain FlashAttention-2 backward in fp32: (dq, dk, dv), with dk/dv
    summed over each GQA group."""
    delta = attention_delta(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    dk, dv = flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(name: str, tensors, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> None:
    """Raise on anything the kernels (CUDA) or the plain path (CPU) do
    not take."""
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {dev}, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape) \
            or q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"{name}: need q [B, Sq, H, D], k/v [B, Sk, KV, D] with "
            f"H % KV == 0, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernels take bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not supports(q, k):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}: need head_dim in {HEAD_DIMS} and "
            "non-empty sequences")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: storage is not 16-byte aligned")


def _raise(lib, fn: str, name: str, err: int) -> None:
    msg = getattr(lib, fn)(err).decode()
    raise RuntimeError(f"{name}: launch failed ({err}: {msg})")


def _dims(q: torch.Tensor, k: torch.Tensor):
    b, s_q, h, d = q.shape
    return b, s_q, k.shape[1], h, k.shape[2], d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): CUDA tensors launch kernel 3 (and count in
    ``flash_attention_fwd.launches``); CPU tensors run the plain
    version."""
    _check("flash_attention_fwd", (q, k, v), q, k, v)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                          sm_scale=scale, q_offset=q_offset)
    from ..kernels import build
    lib = build.load("flash_attention_fwd", _FWD_SIGNATURES)
    b, s_q, _, h, _, _ = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_dims(q, k), float(scale), int(causal),
            int(q_offset), stream)
    if err:
        _raise(lib, "flash_attention_fwd_error_string",
               "flash_attention_fwd", err)
    flash_attention_fwd.launches += 1
    return o, lse


def _bwd_check(name, q, k, v, do, lse, delta):
    _check(name, (q, k, v, do, lse, delta), q, k, v)
    b, s_q, h, _ = q.shape
    if tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (b, h, s_q) \
            or tuple(delta.shape) != (b, h, s_q):
        raise ValueError(f"{name}: need dO like q and lse/delta "
                         f"[B, H, Sq], got {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)}")
    if q.device.type == "cuda" and (
            do.dtype != torch.bfloat16 or lse.dtype != torch.float32
            or delta.dtype != torch.float32):
        raise TypeError(f"{name}: need bf16 dO and fp32 lse/delta")


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True,
                             sm_scale=None, q_offset=0):
    """(dk, dv) summed over each GQA group: CUDA tensors launch kernel 4
    (counted in ``flash_attention_bwd_dkdv.launches``), CPU tensors run
    the plain version."""
    name = "flash_attention_bwd_dkdv"
    _bwd_check(name, q, k, v, do, lse, delta)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_reference(
            q, k, v, do, lse, delta, causal=causal, sm_scale=scale,
            q_offset=q_offset)
    from ..kernels import build
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_dkdv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k), float(scale), int(causal), int(q_offset), stream)
    if err:
        _raise(lib, "flash_attention_bwd_error_string", name, err)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           sm_scale=None, q_offset=0):
    """dq: CUDA tensors launch kernel 5 (counted in
    ``flash_attention_bwd_dq.launches``), CPU tensors run the plain
    version."""
    name = "flash_attention_bwd_dq"
    _bwd_check(name, q, k, v, do, lse, delta)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(
            q, k, v, do, lse, delta, causal=causal, sm_scale=scale,
            q_offset=q_offset)
    from ..kernels import build
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(q, k),
            float(scale), int(causal), int(q_offset), stream)
    if err:
        _raise(lib, "flash_attention_bwd_error_string", name, err)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                          **ctx.opts)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``ops.attention.gqa_attention`` on full sequences,
    differentiable through the backward kernels; see module doc."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale, int(q_offset))
