"""Mixture-of-experts routing (port of ``dcos_commons_tpu/parallel/
moe.py``): the local form, every expert on one device.

Token-to-expert routing is dense one-hot dispatch and combine tensors
[G, E, C] (C the capacity of each expert's buffer), so the layer is
three products with static shapes: no data-dependent shape and no host
round trip, which is what lets a decode window holding it replay as one
CUDA graph.

Two routers:

* ``top2``: GShard token choice. Each token picks its two best experts,
  first come first served along the group axis; tokens overflowing an
  expert's capacity are dropped (residual passthrough), and a
  Switch-style auxiliary loss fights the imbalance that causes drops.
* ``expert_choice``: each expert takes its top-C tokens by affinity
  (Zhou et al. 2022). Balanced by construction, no auxiliary loss; a
  token may be taken by several experts or none. It ranks a token
  against the whole group, future positions included, so it is
  non-causal for a next-token objective.

:func:`dropless` sets the capacity to the group size: no token can
overflow, so a token's output does not depend on how tokens are grouped
into dispatch calls, which is what lets chunked prefill, batched decode
and the whole-sequence reference agree token for token (in bf16 up to
roundings, which can flip a route whose gates are near a tie).

The reference's sharded forms (``moe_apply`` and ``make_moe``, the two
``all_to_all`` collectives over the ``ep`` mesh axis) need the device
mesh, which is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    capacity_factor: float = 2.0  # tokens-per-expert = G/E * factor
    routing: str = "top2"         # top2 | expert_choice

    def capacity(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens * self.capacity_factor
                                / self.num_experts))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row. A
    comparison, so no host check of the indices (``F.one_hot`` has one,
    which a CUDA graph cannot hold)."""
    classes = torch.arange(n, device=idx.device)
    return (idx.long()[..., None] == classes).to(dtype)


def top2_dispatch(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine and dispatch tensors from router probabilities.

    gates: [G, E] softmax output. Returns (combine [G, E, C] in the
    gates' dtype, dispatch [G, E, C] bool). Tokens overflowing an
    expert's capacity are dropped: their combine weights are zero."""
    e = gates.shape[1]
    # argmax takes the first maximum, as jnp.argmax does
    mask1 = _one_hot(torch.argmax(gates, dim=-1), e, gates.dtype)
    gate1 = torch.sum(gates * mask1, dim=-1)
    gates2 = gates * (1.0 - mask1)
    mask2 = _one_hot(torch.argmax(gates2, dim=-1), e, gates.dtype)
    gate2 = torch.sum(gates * mask2, dim=-1)
    # renormalize the two winners
    denom = torch.clamp_min(gate1 + gate2, 1e-9)
    gate1, gate2 = gate1 / denom, gate2 / denom

    # position of each token within its expert's buffer (first come,
    # along the group axis); the cumsum runs in the gates' dtype
    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1         # [G, E]
    used1 = torch.sum(mask1, dim=0, keepdim=True)             # [1, E]
    pos2 = (torch.cumsum(mask2, dim=0) + used1) * mask2 - mask2
    keep1 = (pos1 < capacity).to(gates.dtype) * mask1
    keep2 = (pos2 < capacity).to(gates.dtype) * mask2

    # [G, E, C]: slot one-hot, zeroed where dropped or not routed
    slot1 = (_one_hot(torch.sum(pos1 * keep1, dim=-1).to(torch.int32),
                      capacity, gates.dtype)[:, None, :]
             * keep1[..., None])
    slot2 = (_one_hot(torch.sum(pos2 * keep2, dim=-1).to(torch.int32),
                      capacity, gates.dtype)[:, None, :]
             * keep2[..., None])
    combine = gate1[:, None, None] * slot1 + gate2[:, None, None] * slot2
    dispatch = (slot1 + slot2) > 0
    return combine, dispatch


def expert_choice_dispatch(gates: torch.Tensor, capacity: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert ``e`` takes its ``capacity`` highest-affinity tokens.
    Returns (combine [G, E, C], dispatch [G, E, C] bool), the contract of
    :func:`top2_dispatch`. Among equal affinities the lower token index
    comes first, as ``lax.top_k`` orders them: a stable descending sort
    (``torch.topk`` promises no order among equal values, and an
    engine's masked slots carry identical rows)."""
    g = gates.shape[0]
    capacity = min(capacity, g)
    vals, idx = torch.sort(gates.t(), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :capacity], idx[:, :capacity]         # [E, C]
    oh = _one_hot(idx, g, gates.dtype)                        # [E, C, G]
    dispatch = oh.permute(2, 0, 1) > 0                        # [G, E, C]
    combine = (oh * vals[..., None]).permute(2, 0, 1)
    return combine, dispatch


def aux_load_balance_loss(gates: torch.Tensor) -> torch.Tensor:
    """Switch-transformer load-balance auxiliary loss (mean_e f_e * p_e *
    E)."""
    e = gates.shape[-1]
    top1 = _one_hot(torch.argmax(gates, dim=-1), e, gates.dtype)
    return torch.mean(top1.mean(0) * gates.mean(0)) * (e * e)


def moe_apply_local(x: torch.Tensor, router_w: torch.Tensor,
                    w_in: torch.Tensor, w_out: torch.Tensor,
                    cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN with every expert local. Returns (output [G, D],
    auxiliary loss scalar).

    x: [G, D]; router_w: [D, E]; w_in: [E, D, F] and w_out: [E, F, D],
    the whole expert stack. The router runs in fp32; ``combine`` is cast
    to the activations' dtype before the combine product, so in bf16 the
    gate weights are rounded before they are applied, as in the
    reference. The expert products are batched matmuls over [E, C]
    buffers."""
    g = x.shape[0]
    cap = cfg.capacity(g)
    gates = torch.softmax(x.float() @ router_w.float(), dim=-1)
    if cfg.routing == "expert_choice":
        combine, dispatch = expert_choice_dispatch(gates, cap)
    elif cfg.routing == "top2":
        combine, dispatch = top2_dispatch(gates, cap)
    else:
        raise ValueError(f"unknown MoE routing {cfg.routing!r}")
    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(x.dtype), x)
    h = torch.bmm(expert_in, w_in)                            # [E, C, F]
    # jax.nn.silu is x * sigmoid(x), each rounded to the dtype
    h = h * torch.sigmoid(h)
    expert_out = torch.bmm(h, w_out)                          # [E, C, D]
    out = torch.einsum("gec,ecd->gd", combine.to(x.dtype), expert_out)
    aux = (torch.zeros((), dtype=x.dtype, device=x.device)
           if cfg.routing == "expert_choice"
           else aux_load_balance_loss(gates).to(x.dtype))
    return out, aux


def dropless(cfg: MoEConfig) -> MoEConfig:
    """The decode-side routing contract: ``capacity_factor =
    num_experts`` makes ``capacity(n) == n``, so no token can overflow
    any expert's buffer and per-token outputs are independent of how
    tokens are grouped into dispatch calls."""
    return dataclasses.replace(cfg,
                               capacity_factor=float(cfg.num_experts))
