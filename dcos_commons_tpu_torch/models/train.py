"""Train step (port of ``dcos_commons_tpu/models/train.py``): AdamW with
linear warmup and cosine decay after global-norm clipping, and a step
builder with gradient accumulation.

:func:`make_optimizer` mirrors the reference's
``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
weight_decay))`` and follows optax's order of operations: clip by the
global norm -> Adam moments (kept in each parameter's dtype, as optax
does with ``mu_dtype=None``) with bias correction -> add
``weight_decay * param`` -> scale by ``-lr(count)`` (the rate rounded to
the parameter's dtype) -> add to the parameter. The schedule is
``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)``, so
the rate is 0 at step 0.

Unlike the reference, whose jitted step donates and returns new arrays,
:func:`make_train_step`'s step updates the parameters and the optimizer
state IN PLACE and returns the same objects. There is no mesh yet, and
no ``has_aux_state`` (the ResNet batch-norm pattern).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

import torch

Params = Dict[str, Any]


# optax.adamw's defaults, which the reference keeps (eps_root is 0)
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The reference optimizer's settings."""

    lr: float = 3e-4
    weight_decay: float = 0.01
    warmup: int = 100
    decay_steps: int = 10000
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        """``warmup_cosine_decay_schedule(0.0, lr, warmup, decay_steps)``
        at update ``count``: linear 0 -> lr over ``warmup`` steps, then
        cosine to 0 at ``decay_steps``, 0 after."""
        if count < self.warmup:
            frac = 1.0 - max(count, 0) / self.warmup
            return -self.lr * frac + self.lr
        span = self.decay_steps - self.warmup
        t = min(count - self.warmup, span)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / span))


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   warmup: int = 100, decay_steps: int = 10000,
                   grad_clip: float = 1.0) -> AdamW:
    if warmup < 1 or decay_steps <= warmup:
        raise ValueError(f"need 1 <= warmup < decay_steps, got warmup="
                         f"{warmup}, decay_steps={decay_steps}")
    return AdamW(lr=lr, weight_decay=weight_decay, warmup=warmup,
                 decay_steps=decay_steps, grad_clip=grad_clip)


@dataclasses.dataclass
class OptState:
    """Adam's update count and moments, plus the schedule's own count
    (optax keeps both; they advance together)."""

    count: int
    mu: Params
    nu: Params
    sched_count: int


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"training takes plain tensor parameters, got "
                        f"{type(tree).__name__}")
    return [tree]


def _zeros_like(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def init_opt_state(optimizer: AdamW, params: Params) -> OptState:
    """Zero moments in each parameter's dtype, counts at 0."""
    del optimizer
    _leaves(params)
    return OptState(count=0, mu=_zeros_like(params), nu=_zeros_like(params),
                    sched_count=0)


@torch.no_grad()
def apply_updates(optimizer: AdamW, params: Params, grads: List[torch.Tensor],
                  state: OptState) -> None:
    """One optimizer update of ``params`` from ``grads`` (in the order of
    the parameter leaves), in place."""
    leaves, mus, nus = _leaves(params), _leaves(state.mu), _leaves(state.nu)
    o = optimizer
    g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    trigger = g_norm < o.grad_clip
    state.count += 1
    bc1 = 1.0 - B1 ** state.count
    bc2 = 1.0 - B2 ** state.count
    lr = o.schedule(state.sched_count)
    state.sched_count += 1
    for p, g, mu, nu in zip(leaves, grads, mus, nus):
        g = torch.where(trigger, g, (g / g_norm.to(g.dtype)) * o.grad_clip)
        mu.mul_(B1).add_(g, alpha=1.0 - B1)
        nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        # optax rounds the bias corrections and the step size to the
        # moment's / update's dtype before using them
        u = (mu / _rounded(bc1, mu.dtype)).div_(
            (nu / _rounded(bc2, nu.dtype)).sqrt_().add_(EPS))
        u.add_(p, alpha=o.weight_decay)
        p.add_(u.mul_(_rounded(-lr, u.dtype)))


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` as fp32 (where optax computes it), then as ``dtype``."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def _split(batch: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Cut a token batch into ``n`` equal slices along dim 0."""
    if not isinstance(batch, torch.Tensor):
        raise TypeError(f"grad_accum splits a tensor batch, got "
                        f"{type(batch).__name__}")
    if batch.shape[0] % n:
        raise ValueError(f"batch leading dim {batch.shape[0]} not "
                         f"divisible by grad_accum={n}")
    return list(batch.chunk(n, dim=0))


def make_train_step(loss_fn: Callable, optimizer: AdamW,
                    grad_accum: int = 1) -> Callable:
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "metric"})``; ``loss_fn(params, batch)`` returns
    ``(loss, metric)``. Params and state are updated in place.

    ``grad_accum > 1`` splits the batch tensor's leading axis into that
    many microbatches, runs their backward passes one after another,
    sums the gradients in fp32 and applies ONE update on their mean (cast
    back to each parameter's dtype); loss and metric are microbatch
    means."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def grads_of(params, leaves, batch):
        loss, metric = loss_fn(params, batch)
        return loss.detach(), metric.detach(), torch.autograd.grad(
            loss, leaves)

    def step(params, opt_state, batch):
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            if grad_accum == 1:
                loss, metric, grads = grads_of(params, leaves, batch)
            else:
                sums = [torch.zeros_like(t, dtype=torch.float32)
                        for t in leaves]
                loss = metric = 0.0
                for mb in _split(batch, grad_accum):
                    l_mb, m_mb, g_mb = grads_of(params, leaves, mb)
                    for acc, g in zip(sums, g_mb):
                        acc += g.float()
                    loss = loss + l_mb
                    metric = metric + m_mb
                    del g_mb
                grads = [(acc / grad_accum).to(t.dtype)
                         for acc, t in zip(sums, leaves)]
                loss, metric = loss / grad_accum, metric / grad_accum
        finally:
            for t in leaves:
                t.requires_grad_(False)
        apply_updates(optimizer, params, list(grads), opt_state)
        return params, opt_state, {"loss": loss, "metric": metric}

    return step
