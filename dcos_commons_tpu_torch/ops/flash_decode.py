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
in ``.launches``. A call is one kernel launch: the kernels deal work by
each stream's live length, read on the device, and merge a stream's
partials in the launch itself (:func:`decode_plan` sizes the grid and the
workspace, which the wrappers keep per device and stream, and keep alive
for good once a CUDA graph has captured it).

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
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .quant import QTensor

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
_INT32_MAX = 2 ** 31 - 1

Cache = Union[torch.Tensor, QTensor]

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_PAGED_SIGNATURES = {
    "flash_decode_paged_launch": (
        _c_int, [_c_void_p] * 10 + [_c_int] * 9 + [_c_float, _c_void_p]),
    "flash_decode_paged_error_string": (ctypes.c_char_p, [_c_int]),
}
_SLOT_SIGNATURES = {
    "flash_decode_slots_launch": (
        _c_int, [_c_void_p] * 6 + [_c_int] * 2 + [_c_void_p] * 3
        + [_c_int] * 8 + [_c_float, _c_void_p]),
    "flash_decode_slots_error_string": (ctypes.c_char_p, [_c_int]),
}


# ---------------------------------------------------------------------------
# work sizing: every integer formula of the two kernels' dealing lives here,
# and the kernels' device-side walk (csrc/flash_decode_common.cuh
# ``stream_split`` and ``Walk``) follows it

STAGE_ROWS = 64        # positions per ring stage of the kernels: the chunk unit
MAX_PARTIALS = 8       # partials per (stream, KV head) at most (8 measured
                       # faster than 16 on an H100 80GB HBM3 at 700 W)
BLOCKS_PER_SM = 1      # the persistent grid's blocks per SM (2 was slower
                       # on an H100 80GB HBM3 at 700 W, PERF.md)


def stream_split(live: int) -> Tuple[int, int]:
    """(chunk length, chunks) of a stream with ``live`` positions: whole
    ring stages, the chunk lengthened for a long stream so that it has at
    most :data:`MAX_PARTIALS` chunks; no chunk for ``live <= 0``."""
    if live <= 0:
        return STAGE_ROWS, 0
    stages = -(-live // STAGE_ROWS)
    length = STAGE_ROWS * -(-stages // MAX_PARTIALS)
    return length, -(-live // length)


def decode_items(kv_len: Sequence[int], span: int, kv_heads: int
                 ) -> List[Tuple[int, int, int, int, int, int]]:
    """The work items in the kernels' deal order, ``(stream, KV head,
    chunk, chunks, first, end)``: stream by stream, each a max(chunks, 1) x
    KV head grid over its live positions [0, min(kv_len, span)), the heads
    of a chunk side by side (blocks that take neighbouring items read the
    same positions' rows, which lie together in the cache); a stream
    without one has one empty item per KV head (it writes zeros). Item i
    goes to block i % grid."""
    items = []
    for b, n in enumerate(kv_len):
        live = max(0, min(int(n), span))
        length, chunks = stream_split(live)
        for j in range(max(chunks, 1)):
            for kh in range(kv_heads):
                p0 = j * length
                items.append((b, kh, j, chunks, p0, min(p0 + length, live)))
    return items


@dataclass(frozen=True)
class DecodePlan:
    """Launch sizes of one call: the persistent grid, the partials a
    (stream, KV head) may write, and the workspace (fp32 partials and
    int32 counters, one per (stream, KV head))."""
    grid: int
    max_partials: int
    workspace_floats: int
    counters: int


def decode_plan(batch: int, kv_heads: int, group: int, head_dim: int,
                span: int, n_sm: int, blocks_per_sm: int = BLOCKS_PER_SM,
                max_partials: int = MAX_PARTIALS) -> DecodePlan:
    """Sizes of a call over ``span`` cache positions, from the shapes
    alone (the lengths stay on the device): at most ``blocks_per_sm *
    n_sm`` blocks and never more than the most items the lengths could
    make; partial slots for the most chunks a stream can have under the
    kernel's cap ``max_partials``."""
    max_partials = min(max_partials, -(-span // STAGE_ROWS))
    pairs = batch * kv_heads
    grid = max(1, min(blocks_per_sm * n_sm, pairs * max_partials))
    return DecodePlan(grid, max_partials,
                      pairs * max_partials * group * (head_dim + 2), pairs)


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


def _check_lengths(kv_len: Union[int, torch.Tensor], b: int,
                   device: torch.device) -> None:
    if not isinstance(kv_len, torch.Tensor):
        return
    if kv_len.dtype != torch.int32:
        raise TypeError(f"flash_decode: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    if kv_len.device != device:
        raise ValueError(f"flash_decode: kv_len must be on {device}, got "
                         f"{kv_len.device}")
    if kv_len.numel() not in (1, b):
        raise ValueError(f"flash_decode: kv_len must have 1 or B={b} "
                         f"elements, got shape {tuple(kv_len.shape)}")


def _saturate(n: int) -> int:
    return max(-_INT32_MAX - 1, min(int(n), _INT32_MAX))


def _lengths(kv_len: Union[int, torch.Tensor], b: int,
             device: torch.device) -> torch.Tensor:
    """kv_len as a contiguous [B] int32 tensor on ``device``, broadcast
    there (no host sync). An int past int32 saturates: the kernel clamps
    to S anyway."""
    _check_lengths(kv_len, b, device)
    if not isinstance(kv_len, torch.Tensor):
        return torch.full((b,), _saturate(kv_len), dtype=torch.int32,
                          device=device)
    flat = kv_len.reshape(-1)
    return flat.expand(b).contiguous() if flat.numel() == 1 \
        else flat.contiguous()


def _length_args(kv_len: Union[int, torch.Tensor], b: int):
    """(kv_len, pointer, stride, value) of a launch: an int goes in by
    value, a [1] or [B] int32 tensor by pointer with stride 0 or 1 (no
    copy and no host sync); the tensor is returned to keep it alive."""
    if not isinstance(kv_len, torch.Tensor):
        return None, None, 0, _saturate(kv_len)
    flat = kv_len.reshape(-1).contiguous()
    return flat, flat.data_ptr(), int(flat.numel() > 1), 0


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
    launch; raises on storage the kernels' bulk copies cannot read."""
    quantized = isinstance(k, QTensor)
    kq, vq = _payload(k), _payload(v)
    if any(t.data_ptr() % 16 for t in (q, kq, vq)):
        raise ValueError(f"{name}: cache or q storage is not 16-byte "
                         "aligned")
    ks = k.s.data_ptr() if quantized else None
    vs = v.s.data_ptr() if quantized else None
    return kq, vq, ks, vs


# SM count per device index, asked once
_SM_COUNT: Dict[int, int] = {}
# (device index, stream) -> (fp32 partials, int32 counters); they only
# grow, and the counters are zeroed once, when allocated (each launch
# leaves them at zero)
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# the workspaces a CUDA graph captured, kept for the life of the process:
# a replay writes the buffers its capture saw, so a later growth on the
# same stream must not free them
_CAPTURED: List[Tuple[torch.Tensor, torch.Tensor]] = []


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _workspace(device: torch.device, stream: int, plan: DecodePlan):
    """The kept (partials, counters) of ``device`` and ``stream``, grown
    to ``plan``'s sizes where they fall short."""
    key = (device.index, stream)
    part, counters = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < plan.workspace_floats:
        part = torch.empty(plan.workspace_floats, dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < plan.counters:
        counters = torch.zeros(plan.counters, dtype=torch.int32,
                               device=device)
    _WORKSPACE[key] = (part, counters)
    if torch.cuda.is_current_stream_capturing() and not any(
            p is part and c is counters for p, c in _CAPTURED):
        _CAPTURED.append((part, counters))
    return part, counters


def _raise(lib, fn: str, name: str, err: int) -> None:
    msg = getattr(lib, fn)(err).decode()
    raise RuntimeError(f"{name}: launch failed ({err}: {msg})")


def _launch_slots(q, k, v, kv_len, scale) -> torch.Tensor:
    """One launch of the slot kernel; ``kv_len`` an int or a checked [1]
    or [B] int32 tensor on q's device."""
    from ..kernels import build
    lib = build.load("flash_decode_slots", _SLOT_SIGNATURES)
    kq, vq, ks, vs = _kernel_inputs("flash_decode", q, k, v)
    b, _, h, d = q.shape
    _, s, kvh, _ = kq.shape
    lens, len_ptr, len_stride, len_value = _length_args(kv_len, b)
    plan = decode_plan(b, kvh, h // kvh, d, s, _sm_count(q.device))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, counters = _workspace(q.device, stream, plan)
        err = lib.flash_decode_slots_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs, len_ptr,
            len_stride, len_value, out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), b, h, kvh, d, s, plan.max_partials,
            plan.grid, int(isinstance(k, QTensor)), float(scale), stream)
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
    plan = decode_plan(b, kvh, h // kvh, d, mp * ps, _sm_count(q.device))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, counters = _workspace(q.device, stream, plan)
        err = lib.flash_decode_paged_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks, vs,
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), b, h, kvh, d, ps, mp,
            plan.max_partials, plan.grid, int(isinstance(k, QTensor)),
            float(scale), stream)
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
    _check_lengths(kv_len, q.shape[0], q.device)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, kv_len, sm_scale=scale)
    _no_kernel(name, q.device)
    out = _launch_slots(q, k, v, kv_len, scale)
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
