"""Ulysses sequence parallelism: an all-to-all head <-> sequence reshard
(port of ``dcos_commons_tpu/parallel/ulysses.py``).

The alternative long-context mode: instead of rotating K/V round a ring,
one all-to-all (:meth:`parallel.mesh.Mesh.all_to_all`) turns
sequence-sharded, all-heads tensors into whole-sequence tensors of a
head subset, attention runs locally over those heads, and a second
all-to-all restores the layout. Two exchanges a call whatever the
sequence length (here q, k and v cross in one message); the local heads
(after tp) must divide by ``sp``. The attention is
:func:`ops.attention.gqa_attention`, the reference's dense fp32 softmax
(its ``full_attention``), plain torch products.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import gqa_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh=None, *, axis: str = "sp", causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """This rank's ``[B, S/sp, H, D]`` attention output for its
    sequence shard of ``q``, ``k`` and ``v`` (k/v with the query heads,
    repeated by the caller as the reference's): scatter the heads and
    gather the sequence, attend, scatter the sequence and gather the
    heads. Without a mesh, or with ``axis`` of size 1, dense attention."""
    n = mesh.shape[axis] if mesh is not None else 1
    if n == 1:
        return gqa_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if k.shape != q.shape or v.shape != q.shape or q.shape[2] % n:
        raise ValueError(f"ulysses: q/k/v of one shape whose local heads "
                         f"divide over {axis}={n}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    q, k, v = mesh.all_to_all(torch.stack([q, k, v]), axis, 3, 2).unbind(0)
    out = gqa_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return mesh.all_to_all(out, axis, 1, 2)
