"""Pipeline parallelism (port of ``dcos_commons_tpu/parallel/
pipeline.py``): the GPipe fill and drain schedule over the ``pp`` axis
of a process mesh.

A stage is one rank of ``pp``, holding its slice of the layer stack.
The microbatches stream through ``m + n - 1`` ticks (``m`` microbatches,
``n`` stages): at each tick every stage runs its layers on what it
holds, and its output hops one stage on (``Mesh.ppermute(x, "pp", 1)``).
Stage 0 takes microbatch ``t`` at tick ``t``; the last stage's outputs
from tick ``n - 1`` on are the results, zero on the other stages, and
the sum over ``pp`` (``Mesh.reduce_from``) hands them to every rank.
The bubble is ``(n - 1) / (m + n - 1)`` of the ticks.

Every rank runs the same ticks and the same hops in the same order, as
the reference's ``lax.scan`` does: a stage runs its layers at every tick
(in the fill and the drain on what it holds, which the masks then drop),
and both the choice between the microbatch and the received activation
and the mask of the outputs are a ``torch.where`` on every rank. So
each rank's autograd graph has one shape, every hop's output is used,
and the backward runs the reverse hops (each hop's adjoint is the hop
back) in one order on every rank, with zero cotangents where a mask
dropped the value. The last tick's hop would feed nothing, and no rank
makes it.

Gradients, each rank backpropagating its own copy of the objective with
cotangent 1 (the tp convention of ``models.llama``): the sum's adjoint
passes the cotangent through (Megatron's "g"), so only the last stage's
copy reaches the pipe, and each stage's layers get their whole gradient.
The microbatches enter at stage 0 only, so their gradient would exist on
stage 0 alone; they pass through ``Mesh.copy_to`` over ``pp`` (Megatron's
"f": the identity forward, the sum of the cotangents backward), which
hands that gradient to every stage, and with it the embedding's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run microbatches through the pipeline.

    ``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape`` (a
    transformer trunk's homogeneous activations); ``stage_params`` this
    rank's stage; ``x_microbatches`` [M, ...], the same on every rank.
    Returns the outputs [M, ...], the same on every rank."""
    n, s = mesh.shape[axis], mesh.coords[axis]
    m = x_microbatches.shape[0]
    xm = mesh.copy_to(x_microbatches, axis)
    first = torch.tensor(s == 0, device=xm.device)
    last = torch.tensor(s == n - 1, device=xm.device)
    recv = torch.zeros_like(xm[0])
    outs = []
    for t in range(m + n - 1):
        out = stage_fn(stage_params,
                       torch.where(first, xm[min(t, m - 1)], recv))
        outs.append(out)
        if t < m + n - 2:
            recv = mesh.ppermute(out, axis, 1)
    # the last stage's outputs from tick n - 1 on; zero elsewhere
    outputs = torch.stack(outs[n - 1:])
    outputs = torch.where(last, outputs, torch.zeros_like(outputs))
    return mesh.reduce_from(outputs, axis)


def make_pipeline(mesh, stage_fn: Callable[[Any, torch.Tensor],
                                           torch.Tensor],
                  axis: str = "pp") -> Callable:
    """The reference's ``make_pipeline``: ``fn(stacked_params, x_mb)``
    where every leaf of ``stacked_params`` is this rank's ``[1, ...]``
    slice of the ``[pp, ...]`` stage stack (the reference's ``P("pp")``
    shard); the stage axis is dropped before ``stage_fn``."""
    def fn(stacked_params, x_microbatches):
        return pipeline_apply(stage_fn, _squeeze(stacked_params),
                              x_microbatches, mesh, axis)

    return fn


def _squeeze(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _squeeze(v) for k, v in tree.items()}
    return tree[0]
