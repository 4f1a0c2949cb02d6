"""Flash-decode: one query position per stream against a K/V cache, bf16
or int8 (port of ``flash_decode`` and ``flash_decode_paged`` in
``dcos_commons_tpu/ops/flash_decode.py``). Two caches, two kernels:

* the padded slot cache of ``decode_step`` / ``decode_step_slots``:
  :func:`flash_decode` launches ``csrc/flash_decode_slots.cu``;
* the block-paged pool of ``decode_step_paged``:
  :func:`flash_decode_paged` launches ``csrc/flash_decode_paged.cu``.

Each wrapper checks its inputs, launches its CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors. It never falls back
from the kernel: on CUDA it launches or raises. Each counts its launches
in ``.launches``.

The plain versions (:func:`flash_decode_reference`,
:func:`flash_decode_paged_reference`) compute in fp32 and fold int8
scales the way the kernels do, ``(q . k_q) * s_k`` and
``(p * s_v) @ v_q``. The kernels also round ``p * s_v`` to bf16 before
it meets V, as the TPU kernel does; the plain versions keep it in fp32.

The shape gates (:func:`supports_decode`, :func:`supports_decode_paged`):
one query position, head_dim 64, 128 or 256, at most 8 query heads per
KV head, any cache length or page size >= 1. The TPU kernel's lane-128
rules do not apply.

Layouts: q [B, 1, H, D] bf16; output [B, 1, H, D] bf16, 0 for a stream
with no live position.

* Slot cache: k/v [B, S, KV, D] bf16, or :class:`QTensor` int8 payload +
  [B, S, KV, 1] bf16 scales, read in place; kv_len a Python int or an
  int32 tensor of 1 or B elements. Slot b attends to positions
  [0, min(kv_len[b], S)).
* Paged pool: k/v [P, ps, KV, D] (int8: + [P, ps, KV, 1] scales);
  page_table [B, MP] int32 (entries < P); kv_len [B] int32. Stream b
  attends to positions [0, min(kv_len[b], MP * ps)).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from .quant import QTensor

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
# target number of split blocks per SM: enough blocks in flight to hide
# the load latency when B * KV alone cannot fill the card
_BLOCKS_PER_SM = 4
# the slot kernel's split length is a multiple of this many positions
_SPLIT_ALIGN = 64
_INT32_MAX = 2 ** 31 - 1

Cache = Union[torch.Tensor, QTensor]

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_PAGED_SIGNATURES = {
    "flash_decode_paged_launch": (
        _c_int, [_c_void_p] * 11 + [_c_int] * 9 + [_c_float, _c_void_p]),
    "flash_decode_paged_error_string": (ctypes.c_char_p, [_c_int]),
}
_SLOT_SIGNATURES = {
    "flash_decode_slots_launch": (
        _c_int, [_c_void_p] * 10 + [_c_int] * 8 + [_c_float, _c_void_p]),
    "flash_decode_slots_error_string": (ctypes.c_char_p, [_c_int]),
}


def _payload(k: Cache) -> torch.Tensor:
    return k.q if isinstance(k, QTensor) else k


def _gate(q: torch.Tensor, kq: torch.Tensor) -> bool:
    if q.dim() != 4 or kq.dim() != 4:
        return False
    h, kv = q.shape[2], kq.shape[2]
    return (q.shape[1] == 1 and q.shape[-1] in HEAD_DIMS and kv >= 1
            and h % kv == 0 and h // kv <= MAX_GROUP)


def supports_decode(q: torch.Tensor, k: Cache) -> bool:
    """Whether the slot-cache kernel takes these shapes."""
    kq = _payload(k)
    return _gate(q, kq) and kq.shape[1] >= 1


def supports_decode_paged(q: torch.Tensor, k: Cache, page_size: int) -> bool:
    """Whether the paged kernel takes these shapes."""
    return _gate(q, _payload(k)) and page_size >= 1


# ---------------------------------------------------------------------------
# plain versions (fp32)


def _attend(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
            ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
            kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """Decode attention in fp32 over a cache in logical order: kq/vq
    [B, S, KV, D], int8 scales ks/vs [B, S, KV] or None, kv_len [B]."""
    b, _, h, d = q.shape
    _, span, kvh, _ = kq.shape
    qg = q[:, 0].reshape(b, kvh, h // kvh, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, kq.float()) * scale
    if ks is not None:
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    pos = torch.arange(span, device=q.device)
    live = pos[None, :] < kv_len.long().clamp(0, span)[:, None]   # [B, S]
    live = live[:, None, None, :]
    s = torch.where(live, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs.float().permute(0, 2, 1)[:, :, None, :]
    acc = torch.einsum("bkgs,bskd->bkgd", p, vq.float())
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0),
                      torch.zeros_like(acc))
    return out.reshape(b, 1, h, d).to(q.dtype)


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def _lengths(kv_len: Union[int, torch.Tensor], b: int,
             device: torch.device) -> torch.Tensor:
    """kv_len as a contiguous [B] int32 tensor on ``device``, broadcast
    there (no host sync). An int past int32 saturates: the kernel clamps
    to S anyway."""
    if not isinstance(kv_len, torch.Tensor):
        n = max(-_INT32_MAX - 1, min(int(kv_len), _INT32_MAX))
        return torch.full((b,), n, dtype=torch.int32, device=device)
    if kv_len.dtype != torch.int32:
        raise TypeError(f"flash_decode: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    if kv_len.device != device:
        raise ValueError(f"flash_decode: kv_len must be on {device}, got "
                         f"{kv_len.device}")
    flat = kv_len.reshape(-1)
    if flat.numel() == 1:
        return flat.expand(b).contiguous()
    if flat.numel() != b:
        raise ValueError(f"flash_decode: kv_len must have 1 or B={b} "
                         f"elements, got shape {tuple(kv_len.shape)}")
    return flat.contiguous()


def flash_decode_reference(q: torch.Tensor, k: Cache, v: Cache,
                           kv_len: Union[int, torch.Tensor], *,
                           sm_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Plain PyTorch slot-cache decode attention: the kernel's arithmetic
    in fp32, reading the cache as it lies."""
    lens = _lengths(kv_len, q.shape[0], q.device)
    if isinstance(k, QTensor):
        return _attend(q, k.q, v.q, k.s[..., 0], v.s[..., 0], lens,
                       _scale(q, sm_scale))
    return _attend(q, k, v, None, None, lens, _scale(q, sm_scale))


def flash_decode_paged_reference(q: torch.Tensor, k: Cache, v: Cache,
                                 page_table: torch.Tensor,
                                 kv_len: torch.Tensor, *,
                                 sm_scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch paged decode attention, the kernel's arithmetic in
    fp32 over the gathered pages."""
    b, _, _, d = q.shape
    kq, vq = _payload(k), _payload(v)
    _, ps, kvh, _ = kq.shape
    span = page_table.shape[1] * ps
    tbl = page_table.long()
    ks = vs = None
    if isinstance(k, QTensor):
        ks = k.s[tbl].reshape(b, span, kvh)
        vs = v.s[tbl].reshape(b, span, kvh)
    return _attend(q, kq[tbl].reshape(b, span, kvh, d),
                   vq[tbl].reshape(b, span, kvh, d), ks, vs, kv_len,
                   _scale(q, sm_scale))


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_cache(name: str, q: torch.Tensor, k: Cache, v: Cache,
                 layout: str, extra: Sequence[torch.Tensor] = ()) -> None:
    """Raise on a cache either kernel refuses: both sides int8 or both
    bf16, one device, contiguous, bf16 q, 4-d K/V of one shape and int8
    scales of the payload's shape with a last axis of 1."""
    quantized = isinstance(k, QTensor)
    if quantized != isinstance(v, QTensor):
        raise TypeError(f"{name}: k and v must both be int8 QTensors or "
                        "both bf16 tensors")
    kq, vq = _payload(k), _payload(v)
    tensors = [q, kq, vq, *extra]
    if quantized:
        tensors += [k.s, v.s]
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {dev}, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q must be bf16, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if kq.dtype != want or vq.dtype != want:
        raise TypeError(f"{name}: the cache must be {want}, got "
                        f"{kq.dtype}/{vq.dtype}")
    if kq.dim() != 4 or kq.shape != vq.shape:
        raise ValueError(f"{name}: k and v must be {layout} of one shape, "
                         f"got {tuple(kq.shape)} and {tuple(vq.shape)}")
    if quantized and (k.s.shape != kq.shape[:3] + (1,)
                      or v.s.shape != kq.shape[:3] + (1,)
                      or k.s.dtype != torch.bfloat16
                      or v.s.dtype != torch.bfloat16):
        raise ValueError(f"{name}: int8 caches need bf16 scales of shape "
                         f"{tuple(kq.shape[:3]) + (1,)}")


def _unsupported(name: str, q: torch.Tensor, kq: torch.Tensor) -> str:
    return (f"{name}: unsupported shapes q {tuple(q.shape)}, cache "
            f"{tuple(kq.shape)}: need q [B, 1, H, D] with D in {HEAD_DIMS} "
            f"matching the cache and H / KV <= {MAX_GROUP}")


def _kernel_inputs(name: str, q: torch.Tensor, k: Cache, v: Cache):
    """(k payload, v payload, k scale pointer, v scale pointer) of a
    launch; raises on storage the kernels' vector loads cannot read."""
    quantized = isinstance(k, QTensor)
    kq, vq = _payload(k), _payload(v)
    align = 8 if quantized else 16
    if any(t.data_ptr() % align for t in (kq, vq)) or q.data_ptr() % 16:
        raise ValueError(f"{name}: cache or q storage is not "
                         f"{align}-byte aligned")
    ks = k.s.data_ptr() if quantized else None
    vs = v.s.data_ptr() if quantized else None
    return kq, vq, ks, vs


def _partials(q: torch.Tensor, kvh: int, n_splits: int):
    b, _, h, d = q.shape
    f32 = torch.float32
    part_m = torch.empty((b, kvh, n_splits, h // kvh), dtype=f32,
                         device=q.device)
    part_acc = torch.empty((b, kvh, n_splits, h // kvh, d), dtype=f32,
                           device=q.device)
    return part_m, torch.empty_like(part_m), part_acc


def _want_splits(q: torch.Tensor, kvh: int) -> int:
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return max(1, -(-_BLOCKS_PER_SM * n_sm // (q.shape[0] * kvh)))


def _raise(lib, fn: str, name: str, err: int) -> None:
    msg = getattr(lib, fn)(err).decode()
    raise RuntimeError(f"{name}: launch failed ({err}: {msg})")


def _launch_slots(q, k, v, lens, scale) -> torch.Tensor:
    from ..kernels import build
    lib = build.load("flash_decode_slots", _SLOT_SIGNATURES)
    kq, vq, ks, vs = _kernel_inputs("flash_decode", q, k, v)
    b, _, h, d = q.shape
    _, s, kvh, _ = kq.shape
    split_len = -(-s // _want_splits(q, kvh))
    split_len = -(-split_len // _SPLIT_ALIGN) * _SPLIT_ALIGN
    n_splits = -(-s // split_len)
    part_m, part_l, part_acc = _partials(q, kvh, n_splits)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_slots_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
            lens.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), b, h, kvh, d, s,
            split_len, n_splits, int(isinstance(k, QTensor)), float(scale),
            stream)
    if err:
        _raise(lib, "flash_decode_slots_error_string", "flash_decode", err)
    return out


def _launch_paged(q, k, v, page_table, kv_len, scale) -> torch.Tensor:
    from ..kernels import build
    lib = build.load("flash_decode_paged", _PAGED_SIGNATURES)
    kq, vq, ks, vs = _kernel_inputs("flash_decode_paged", q, k, v)
    b, _, h, d = q.shape
    _, ps, kvh, _ = kq.shape
    mp = page_table.shape[1]
    pages_per_split = max(1, -(-mp // _want_splits(q, kvh)))
    n_splits = -(-mp // pages_per_split)
    part_m, part_l, part_acc = _partials(q, kvh, n_splits)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_paged_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            b, h, kvh, d, ps, mp, pages_per_split, n_splits,
            int(isinstance(k, QTensor)), float(scale), stream)
    if err:
        _raise(lib, "flash_decode_paged_error_string", "flash_decode_paged",
               err)
    return out


def _no_kernel(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")


def flash_decode(q: torch.Tensor, k: Cache, v: Cache,
                 kv_len: Union[int, torch.Tensor], *,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """Slot-cache decode attention; see module doc. CUDA tensors launch
    the kernel (and count in ``flash_decode.launches``); CPU tensors run
    :func:`flash_decode_reference`."""
    name = "flash_decode"
    _check_cache(name, q, k, v, "[B, S, KV, D]")
    kq = _payload(k)
    if not supports_decode(q, k) or kq.shape[-1] != q.shape[-1] \
            or kq.shape[0] != q.shape[0]:
        raise ValueError(_unsupported(name, q, kq) + " and one cache row "
                         "per query")
    lens = _lengths(kv_len, q.shape[0], q.device)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, lens, sm_scale=scale)
    _no_kernel(name, q.device)
    out = _launch_slots(q, k, v, lens, scale)
    flash_decode.launches += 1
    return out


def flash_decode_paged(q: torch.Tensor, k: Cache, v: Cache,
                       page_table: torch.Tensor, kv_len: torch.Tensor, *,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention; see module doc. CUDA tensors launch the
    kernel (and count in ``flash_decode_paged.launches``); CPU tensors
    run :func:`flash_decode_paged_reference`."""
    name = "flash_decode_paged"
    _check_cache(name, q, k, v, "[P, ps, KV, D]", (page_table, kv_len))
    kq = _payload(k)
    if page_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and kv_len must be int32")
    if not supports_decode_paged(q, k, kq.shape[1]) \
            or kq.shape[-1] != q.shape[-1]:
        raise ValueError(_unsupported(name, q, kq))
    b = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1 or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"{name}: page_table must be [B={b}, MP>=1] and kv_len [B], "
            f"got {tuple(page_table.shape)} and {tuple(kv_len.shape)}")
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k, v, page_table, kv_len,
                                            sm_scale=scale)
    _no_kernel(name, q.device)
    out = _launch_paged(q, k, v, page_table, kv_len, scale)
    flash_decode_paged.launches += 1
    return out


flash_decode.launches = 0
flash_decode_paged.launches = 0
