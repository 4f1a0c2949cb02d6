"""MNIST MLP (port of ``dcos_commons_tpu/models/mlp.py``): the minimum
end-to-end workload, one device and no collectives (the ``mnist``
service, BASELINE.json config #3).

Parameters are the reference's tree: ``layer{i}`` with ``w`` [in, out]
and ``b`` [out], both in ``cfg.dtype`` (bf16), He-scaled normal weights
and zero biases. Torch and JAX draw different numbers from one seed:
parity tests carry the JAX weights over with
``models.bridge.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.losses import softmax_cross_entropy

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (512, 256)
    n_classes: int = 10
    dtype: Any = torch.bfloat16


def init_params(cfg: MLPConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """fp32 normal draws scaled by ``(2 / fan_in) ** 0.5``, then cast to
    ``cfg.dtype``; ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    params: Params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((din, dout), generator=generator, device=dev,
                        dtype=torch.float32) * (2.0 / din) ** 0.5
        params[f"layer{i}"] = {
            "w": w.to(cfg.dtype),
            "b": torch.zeros((dout,), dtype=cfg.dtype, device=dev)}
    return params


def forward(cfg: MLPConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [B, in_dim] -> logits [B, n_classes] fp32."""
    x = x.to(cfg.dtype)
    n = len(params)
    for i in range(n):
        lp = params[f"layer{i}"]
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x.float()


def loss_fn(cfg: MLPConfig, params: Params,
            batch: Tuple[torch.Tensor, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy, accuracy) of ``batch = (x, labels)``."""
    x, y = batch
    return softmax_cross_entropy(forward(cfg, params, x), y)
