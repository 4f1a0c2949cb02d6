"""Weight-only int8 quantization (port of ``dcos_commons_tpu/ops/quant.py``).

Symmetric per-channel int8 payload ``q`` with broadcastable scales ``s``
(the quantized axis has size 1 in ``s``). :func:`qmm` and :func:`qtake`
accept plain tensors too, so model code has one path for quantized and
unquantized weights. ``torch.round`` rounds half to even, as
``jnp.round`` does, so payloads match the reference bit for bit on equal
inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Int8 payload + broadcastable scales; quantized axis has size 1 in
    ``s``. Indexing slices both along the leading axes (a stacked
    ``[L, ...]`` weight's layer, a pool's page)."""

    q: torch.Tensor  # int8, original shape
    s: torch.Tensor  # scale, same rank, quantized axis collapsed to 1

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        # the logical dtype models compute in, not the storage dtype
        return self.s.dtype

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.q[idx], self.s[idx])


QArray = Union[torch.Tensor, QTensor]


def quantize(w: torch.Tensor, axis: int = -2,
             scale_dtype: torch.dtype = torch.bfloat16) -> QTensor:
    """Symmetric per-channel int8: ``axis`` is folded into each scale
    group (the reduction axis for ``x @ w`` weights; head_dim for K/V
    rows; the embedding dim for gather tables)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s.to(scale_dtype))


def dequantize(w: QTensor, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    dtype = dtype or w.s.dtype
    return (w.q.float() * w.s.float()).to(dtype)


def qmm(x: torch.Tensor, w: QArray) -> torch.Tensor:
    """``x @ w`` for plain or quantized ``w``. Quantized: matmul against
    the payload cast to ``x.dtype``, then scale the output (exact for
    per-out-channel scales); the scale is cast to ``x.dtype`` before the
    product, as the reference does."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)) * w.s.squeeze(-2).to(x.dtype)
    return x @ w


def qtake(w: QArray, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup ``w[idx]`` for plain or quantized tables (tables
    quantize per row, so the gathered rows carry their own scales)."""
    if isinstance(w, QTensor):
        return w.q[idx].to(dtype) * w.s[idx].to(dtype)
    return w.to(dtype)[idx]
