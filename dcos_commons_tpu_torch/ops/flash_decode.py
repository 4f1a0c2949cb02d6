"""Paged flash-decode: one query position per stream against a block-paged
K/V pool, bf16 or int8 pages (port of ``flash_decode_paged`` in
``dcos_commons_tpu/ops/flash_decode.py``).

* :func:`flash_decode_paged` checks its inputs and launches the CUDA
  kernel of ``csrc/flash_decode_paged.cu`` for CUDA tensors; for CPU
  tensors it runs the plain version. It never falls back from the
  kernel: on CUDA it launches or raises.
* :func:`flash_decode_paged_reference` is the plain PyTorch version: it
  gathers the pages in logical order and folds int8 scales in fp32 the
  way the kernel does, ``(q . k_q) * s_k`` and ``(p * s_v) @ v_q``.
* :func:`supports_decode_paged` is the kernel's shape gate: one query
  position, head_dim 64, 128 or 256, at most 8 query heads per KV head,
  any page size >= 1. The TPU kernel's lane-128 rules do not apply.

Layout: q [B, 1, H, D] bf16; pools [P, ps, KV, D] bf16, or
:class:`QTensor` int8 payload + [P, ps, KV, 1] bf16 scales; page_table
[B, MP] int32 (entries < P); kv_len [B] int32. Stream b attends to
positions [0, min(kv_len[b], MP * ps)); output [B, 1, H, D] bf16, 0 for a
stream with no live position.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from .quant import QTensor

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
# target number of split blocks per SM: enough blocks in flight to hide
# the gather latency when B * KV alone cannot fill the card
_BLOCKS_PER_SM = 4

Pool = Union[torch.Tensor, QTensor]

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {
    "flash_decode_paged_launch": (
        _c_int, [_c_void_p] * 11 + [_c_int] * 9 + [_c_float, _c_void_p]),
    "flash_decode_paged_error_string": (ctypes.c_char_p, [_c_int]),
}


def supports_decode_paged(q: torch.Tensor, k: Pool, page_size: int) -> bool:
    """Whether the CUDA kernel takes these shapes."""
    kq = k.q if isinstance(k, QTensor) else k
    h, kv = q.shape[2], kq.shape[2]
    return (q.dim() == 4 and q.shape[1] == 1 and q.shape[-1] in HEAD_DIMS
            and page_size >= 1 and kv >= 1 and h % kv == 0
            and h // kv <= MAX_GROUP)


def flash_decode_paged_reference(q: torch.Tensor, k: Pool, v: Pool,
                                 page_table: torch.Tensor,
                                 kv_len: torch.Tensor, *,
                                 sm_scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch paged decode attention, the kernel's arithmetic in
    fp32 over the gathered pages."""
    b, _, h, d = q.shape
    quantized = isinstance(k, QTensor)
    kq, vq = (k.q, v.q) if quantized else (k, v)
    _, ps, kvh, _ = kq.shape
    mp = page_table.shape[1]
    group = h // kvh
    span = mp * ps
    tbl = page_table.long()
    scale = sm_scale if sm_scale is not None else d ** -0.5
    kg = kq[tbl].reshape(b, span, kvh, d).float()
    vg = vq[tbl].reshape(b, span, kvh, d).float()
    qg = q[:, 0].reshape(b, kvh, group, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, kg) * scale
    if quantized:
        ks = k.s[tbl].reshape(b, span, kvh).float().permute(0, 2, 1)
        s = s * ks[:, :, None, :]
    pos = torch.arange(span, device=q.device)
    live = pos[None, :] < kv_len.long().clamp(0, span)[:, None]   # [B, S]
    live = live[:, None, None, :]
    s = torch.where(live, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if quantized:
        vs = v.s[tbl].reshape(b, span, kvh).float().permute(0, 2, 1)
        p = p * vs[:, :, None, :]
    acc = torch.einsum("bkgs,bskd->bkgd", p, vg)
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0),
                      torch.zeros_like(acc))
    return out.reshape(b, 1, h, d).to(q.dtype)


def _check(q: torch.Tensor, k: Pool, v: Pool, page_table: torch.Tensor,
           kv_len: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    quantized = isinstance(k, QTensor)
    if quantized != isinstance(v, QTensor):
        raise TypeError("k and v pools must both be int8 QTensors or both "
                        "bf16 tensors")
    kq, vq = (k.q, v.q) if quantized else (k, v)
    tensors = [q, kq, vq, page_table, kv_len]
    if quantized:
        tensors += [k.s, v.s]
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("flash_decode_paged: all inputs must be on "
                         f"{dev}, got {[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_paged: inputs must be contiguous")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_decode_paged: q must be bf16, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if kq.dtype != want or vq.dtype != want:
        raise TypeError(f"flash_decode_paged: pools must be {want}, got "
                        f"{kq.dtype}/{vq.dtype}")
    if page_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("flash_decode_paged: page_table and kv_len must be "
                        "int32")
    if kq.dim() != 4 or kq.shape != vq.shape:
        raise ValueError(f"flash_decode_paged: pools must be [P, ps, KV, D] "
                         f"of one shape, got {tuple(kq.shape)} and "
                         f"{tuple(vq.shape)}")
    b, _, _, d = q.shape
    _, ps, kvh, dk = kq.shape
    if quantized and (k.s.shape != kq.shape[:3] + (1,)
                      or v.s.shape != kq.shape[:3] + (1,)
                      or k.s.dtype != torch.bfloat16
                      or v.s.dtype != torch.bfloat16):
        raise ValueError("flash_decode_paged: int8 pools need bf16 scales "
                         "of shape [P, ps, KV, 1]")
    if not supports_decode_paged(q, k, ps) or dk != d:
        raise ValueError(
            f"flash_decode_paged: unsupported shapes q {tuple(q.shape)}, "
            f"pool {tuple(kq.shape)}: need q [B, 1, H, D] with D in "
            f"{HEAD_DIMS} matching the pool and H / KV <= {MAX_GROUP}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1 or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"flash_decode_paged: page_table must be [B={b}, MP>=1] and "
            f"kv_len [B], got {tuple(page_table.shape)} and "
            f"{tuple(kv_len.shape)}")


def _launch(q, k, v, page_table, kv_len, scale) -> torch.Tensor:
    from ..kernels import build
    lib = build.load("flash_decode_paged", _SIGNATURES)
    quantized = isinstance(k, QTensor)
    kq, vq = (k.q, v.q) if quantized else (k, v)
    b, _, h, d = q.shape
    _, ps, kvh, _ = kq.shape
    mp = page_table.shape[1]
    group = h // kvh
    align = 8 if quantized else 16          # the kernel's vector loads
    if any(t.data_ptr() % align for t in (kq, vq)) or q.data_ptr() % 16:
        raise ValueError("flash_decode_paged: pool or q storage is not "
                         f"{align}-byte aligned")
    dev = q.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    want_splits = max(1, -(-_BLOCKS_PER_SM * n_sm // (b * kvh)))
    pages_per_split = max(1, -(-mp // want_splits))
    n_splits = -(-mp // pages_per_split)
    f32 = torch.float32
    part_m = torch.empty((b, kvh, n_splits, group), dtype=f32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kvh, n_splits, group, d), dtype=f32,
                           device=dev)
    out = torch.empty_like(q)
    ks = k.s.data_ptr() if quantized else None
    vs = v.s.data_ptr() if quantized else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_decode_paged_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            b, h, kvh, d, ps, mp, pages_per_split, n_splits,
            int(quantized), float(scale), stream)
    if err:
        msg = lib.flash_decode_paged_error_string(err).decode()
        raise RuntimeError(f"flash_decode_paged: launch failed ({err}: "
                           f"{msg})")
    return out


def flash_decode_paged(q: torch.Tensor, k: Pool, v: Pool,
                       page_table: torch.Tensor, kv_len: torch.Tensor, *,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention; see module doc. CUDA tensors launch the
    kernel (and count in ``flash_decode_paged.launches``); CPU tensors
    run :func:`flash_decode_paged_reference`."""
    _check(q, k, v, page_table, kv_len)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k, v, page_table, kv_len,
                                            sm_scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: no kernel for device "
                         f"{q.device}")
    out = _launch(q, k, v, page_table, kv_len, scale)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
