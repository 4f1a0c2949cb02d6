"""Carry JAX-side trees into the port: parameters (Llama, the MLP, the
ResNet with its batch-norm state), slot caches, page pools and the
optimizer state.

Inputs are trees of numpy arrays (``jax.device_get`` of a parameter
pytree or a page pool): dicts, arrays, and quantized leaves with ``q``
and ``s`` attributes (the JAX ``QTensor``), which become the port's
:class:`~dcos_commons_tpu_torch.ops.quant.QTensor`. Nothing here imports
JAX or the JAX package.

``torch.from_numpy`` refuses ml_dtypes' ``bfloat16``, so bf16 arrays
cross as a ``uint16`` bit view and are reinterpreted on the torch side:
the bits arrive exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.quant import QTensor


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One array, bit-exact (bf16 through a uint16 view). Always a copy:
    the port writes pools in place, and a JAX array's host buffer is
    read-only."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return QTensor(tensor_from_numpy(tree.q, device),
                       tensor_from_numpy(tree.s, device))
    return tensor_from_numpy(tree, device)


def params_from_jax(tree: Any, device: DeviceLike = "cuda", mesh=None,
                    cfg=None, specs=None) -> Any:
    """The JAX Llama parameter pytree (as numpy) as the port's dict, with
    the same keys and layout: the stacked ``[L, ...]`` ``x @ W`` layer
    weights, a MoE tree's ``router``, ``w_in`` and ``w_out``, or the
    pipelined ``[pp, L/pp, ...]`` stacks (``stack_pipeline_params``).
    With a ``mesh`` (and the model's ``cfg``) this rank's shard of it
    under ``specs`` (``llama.shard_params``' default when None; the
    pipelined tree passes ``llama.pipeline_param_specs``): each leaf is
    sliced on the host before it moves, so the device holds the shard
    only."""
    dev = resolve_device(device)
    if mesh is None or mesh.size == 1:
        return _convert(tree, dev)
    from .llama import shard_params
    return _move(shard_params(_convert(tree, torch.device("cpu")), mesh,
                              cfg, specs), dev)


def _move(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device), tree.s.to(device))
    return tree.to(device)


def resnet_from_jax(params: Any, state: Any, device: DeviceLike = "cuda"):
    """The JAX ResNet's ``(params, bn_state)`` (as numpy) as the port's,
    bit for bit: the same keys, HWIO conv weights and dtypes."""
    dev = resolve_device(device)
    return _convert(params, dev), _convert(state, dev)


def pool_from_jax(pool: Any, device: DeviceLike = "cuda") -> Any:
    """A JAX page pool ``{"k", "v"}`` (as numpy) as the port's pool."""
    return _convert(pool, resolve_device(device))


def cache_from_jax(cache: Any, device: DeviceLike = "cuda") -> Any:
    """A JAX slot cache ``{"k", "v"}`` [L, B, S, KV, D] (as numpy) as the
    port's cache."""
    return _convert(cache, resolve_device(device))


def opt_state_from_jax(state: Any, device: DeviceLike = "cuda"):
    """The reference optimizer's optax chain state (as numpy, e.g.
    ``jax.device_get(opt_state)``) as the port's
    :class:`~dcos_commons_tpu_torch.models.train.OptState`: Adam's
    ``count``, ``mu`` and ``nu`` (in their stored dtypes) and the
    learning-rate schedule's ``count``. The chain is searched by field
    name (the states are named tuples), so the empty states around them
    do not matter."""
    from .train import OptState

    found = {}

    def walk(node):
        fields = getattr(node, "_fields", ())
        if "mu" in fields and "nu" in fields:
            found["adam"] = node
        elif fields == ("count",):
            found["sched"] = node
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(state)
    if "adam" not in found or "sched" not in found:
        raise ValueError("opt_state_from_jax: expected an optax chain with "
                         "a ScaleByAdamState and a ScaleByScheduleState")
    dev = resolve_device(device)
    adam = found["adam"]
    return OptState(count=int(np.asarray(adam.count)),
                    mu=_convert(adam.mu, dev), nu=_convert(adam.nu, dev),
                    sched_count=int(np.asarray(found["sched"].count)))
