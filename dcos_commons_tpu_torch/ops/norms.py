"""Normalization (port of ``dcos_commons_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim. Stats in fp32, result in x.dtype."""
    x32 = x.float()
    rms = torch.sqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return ((x32 / rms) * weight.float()).to(x.dtype)
