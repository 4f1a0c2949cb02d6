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
state IN PLACE and returns the same objects. With a process mesh whose
``dp`` axis is larger than 1 (``parallel.mesh``), the parameters and the
optimizer state are replicated on every rank, each rank backpropagates
its own rows, and ONE collective a step (``Mesh.reduce_grads``) averages
the gradients, the loss and the metric over ``dp`` before the clip and
the update, so every rank applies the same global gradient and holds the
same bits. With ``tp > 1`` (``param_spec_tree``, the reference's
Megatron specs) each rank holds its shards of the parameters and of both
moments; the clip's global norm sums the sharded leaves' squares over
``tp`` and counts each replicated leaf once, so every rank clips by one
factor and the replicated leaves stay bitwise equal. With ``sp > 1``
the parameters and their moments are replicated over ``sp`` as over
``dp``: each rank backpropagates its own sequence shard's loss, and the
one reduction runs over ``dp`` and ``sp`` together, so the clip's norm
is unchanged.
With ``ep > 1`` or ``pp > 1`` (beside ``dp``; ``param_spec_tree`` the
reference's ``llama.moe_param_specs`` or ``pipeline_param_specs``) every
rank computes the loss of the WHOLE batch, as the reference's replicas
do, and backpropagates it with cotangent 1; each leaf's gradient is
then averaged over the ranks that hold the same slice of it (a
replicated leaf over the whole mesh, a stage or expert bank over
``dp``), and an ep-sharded leaf is divided by ``ep`` as well: every ep
rank routes the whole token group, so an expert's owner receives each
token's cotangent once from each ep rank. The model places the rest
(``parallel.pipeline`` hands the embedding's stage-0 gradient to every
stage). The clip's norm sums the sharded leaves' squares over their
axis and counts each replicated leaf once.
:func:`opt_state_specs` gives the specs the reference places the
optimizer state under, which the gang checkpoint writes.
``has_aux_state`` is the ResNet batch-norm pattern: the loss
returns a new state tree beside its metric, and the step hands it back
detached.
The step's backward and optimizer update run under
``train_step.backward`` and ``train_step.optimizer`` profiler ranges.

:class:`OptState` keeps its counts as Python ints; :func:`opt_state_tree`
and :func:`opt_state_from_tree` map it to and from the tree of the
reference's optax chain, ``(EmptyState(), (ScaleByAdamState(count, mu,
nu), EmptyState(), ScaleByScheduleState(count)))`` with int32 0-d counts,
which ``parallel.checkpoint`` saves under the reference's keys
(``opt_state.1.0.count``, ``opt_state.1.0.mu.<param>``, ...,
``opt_state.1.2.count``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from ..parallel.mesh import GRAD_AXES

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


class EmptyState(NamedTuple):
    """optax's stateless transforms' state (clip, weight decay)."""


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the moments."""

    count: torch.Tensor
    mu: Params
    nu: Params


class ScaleByScheduleState(NamedTuple):
    """optax's ``ScaleByScheduleState``: the schedule's count."""

    count: torch.Tensor


def opt_state_tree(state: OptState) -> tuple:
    """``state`` as the reference optimizer's optax chain tree, the
    moments shared (not copied) and the counts int32 0-d tensors on the
    moments' device."""
    dev = _leaves(state.mu)[0].device

    def count(n: int) -> torch.Tensor:
        return torch.tensor(n, dtype=torch.int32, device=dev)

    return (EmptyState(),
            (ScaleByAdamState(count(state.count), state.mu, state.nu),
             EmptyState(), ScaleByScheduleState(count(state.sched_count))))


def opt_state_from_tree(tree: tuple) -> OptState:
    """The inverse of :func:`opt_state_tree` (e.g. after a restore)."""
    _, (adam, _, sched) = tree
    return OptState(count=int(adam.count), mu=adam.mu, nu=adam.nu,
                    sched_count=int(sched.count))


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


def _leaf_specs(params: Params, specs: Any) -> List[tuple]:
    """``specs``' entry for each leaf, in :func:`_leaves` order."""
    if isinstance(params, dict):
        return [sp for key in params
                for sp in _leaf_specs(params[key], specs[key])]
    return [tuple(specs)]


def _sorted_leaves(tree: Any, specs: Any) -> List[Tuple[torch.Tensor, tuple]]:
    """``(leaf, spec)`` in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _sorted_leaves(tree[key], specs[key])]
    return [(tree, tuple(specs))]


def opt_state_specs(params: Params, specs: Params, mesh) -> tuple:
    """The specs of :func:`opt_state_tree`'s leaves as the reference
    places them (``_opt_shardings`` and ``init_opt_state(..., mesh,
    specs)``): each moment takes the spec of the FIRST parameter, in
    sorted-leaf order, whose whole shape equals its own, and the counts
    are replicated. In every Llama ``wq`` and ``wo`` share a shape and
    ``wo`` sorts first, so ``wq``'s moments are row shards there while a
    rank's live moments are column shards like its ``wq``.
    ``params`` are this rank's shards under ``specs`` over ``mesh``."""
    from ..parallel.mesh import whole_shape
    by_shape: Dict[tuple, tuple] = {}
    for leaf, spec in _sorted_leaves(params, specs):
        by_shape.setdefault(tuple(whole_shape(leaf.shape, spec, mesh)), spec)

    def moment(tree, spec):
        if isinstance(tree, dict):
            return {k: moment(tree[k], spec[k]) for k in tree}
        return by_shape[tuple(whole_shape(tree.shape, spec, mesh))]

    return moment_specs(moment(params, specs))


def moment_specs(specs: Params) -> tuple:
    """The specs of an :func:`opt_state_tree` whose moments are sharded
    under ``specs`` (a rank's own: its parameters' specs), the counts
    replicated."""
    return (EmptyState(), (ScaleByAdamState((), specs, specs), EmptyState(),
                           ScaleByScheduleState(())))


def _global_norm(grads: List[torch.Tensor],
                 sharded: Optional[List[Optional[str]]], mesh
                 ) -> torch.Tensor:
    """The gradient's global norm: with ``sharded`` (one entry a leaf:
    the mesh axis it is sharded over, or None), the sharded leaves' sums
    of squares summed over their axis in one collective an axis, and the
    replicated leaves' (whole on every rank) added once."""
    squares = [g.float().square().sum() for g in grads]
    if sharded is None:
        return torch.sqrt(sum(squares))
    zero = torch.zeros((), device=grads[0].device)
    total = sum((q for q, ax in zip(squares, sharded) if ax is None), zero)
    for axis in sorted({ax for ax in sharded if ax is not None}):
        part = sum((q for q, ax in zip(squares, sharded) if ax == axis),
                   zero)
        total = total + mesh.all_reduce(part.reshape(1), axis)[0]
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(optimizer: AdamW, params: Params, grads: List[torch.Tensor],
                  state: OptState,
                  sharded: Optional[List[Optional[str]]] = None,
                  mesh=None) -> None:
    """One optimizer update of ``params`` from ``grads`` (in the order of
    the parameter leaves), in place. ``sharded`` (one entry a leaf: the
    axis it is sharded over, or None) and ``mesh``: the leaves are a
    rank's shards, and the clip's norm is the whole model's
    (:func:`_global_norm`)."""
    leaves, mus, nus = _leaves(params), _leaves(state.mu), _leaves(state.nu)
    o = optimizer
    g_norm = _global_norm(grads, sharded, mesh)
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


def _detached(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def dp_rows(n_rows: int, mesh) -> Tuple[int, int]:
    """``(start, count)`` of this rank's rows of a batch of ``n_rows``
    that every rank holds whole: ``numpy.array_split``'s cut over the
    ``dp`` axis (the first ``n_rows % dp`` ranks take one row more; a
    rank may take none)."""
    dp, r = mesh.shape["dp"], mesh.coords["dp"]
    q, rem = divmod(n_rows, dp)
    return r * q + min(r, rem), q + (1 if r < rem else 0)


def make_train_step(loss_fn: Callable, optimizer: AdamW,
                    grad_accum: int = 1,
                    has_aux_state: bool = False, mesh=None,
                    batch_spec: Optional[str] = "dp",
                    param_spec_tree: Optional[Params] = None) -> Callable:
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "metric"})``; ``loss_fn(params, batch)`` returns
    ``(loss, metric)``. Params and state are updated in place.

    ``has_aux_state``: ``loss_fn(params, batch)`` returns ``(loss,
    (metric, aux))`` (``batch`` is ``(state, data)`` for the ResNet), and
    the step returns ``(params, opt_state, aux, {"loss", "metric"})``
    with ``aux``'s tensors detached.

    ``grad_accum > 1`` splits the batch tensor's leading axis into that
    many microbatches, runs their backward passes one after another,
    sums the gradients in fp32 and applies ONE update on their mean (cast
    back to each parameter's dtype); loss and metric are microbatch
    means.

    ``mesh`` with ``dp > 1`` (the reference's ``mesh=``): the gradients,
    loss and metric are reduced over ``dp`` in one collective after the
    backward, before the clip, and ``loss``/``metric`` are global means.
    ``batch_spec="dp"`` (the reference's ``P("dp")``): ``batch`` is this
    rank's equal share of the global batch, and the ranks' gradients are
    averaged. ``batch_spec=None``: every rank holds the whole batch and
    takes its rows (:func:`dp_rows`; ``grad_accum`` splits those), and
    each rank's gradient is weighted by its share of the rows, so the
    step equals one process's over the whole batch for any batch size; a
    rank left with no rows adds zeros and still joins the collective.

    ``mesh`` with ``tp > 1`` needs ``param_spec_tree`` (the reference's
    ``llama.param_specs``): ``params`` and the moments are this rank's
    shards, ``loss_fn`` runs the tp forward (its collectives pair the
    ranks' gradients), and the clip's norm is the whole model's. With
    ``dp > 1`` too, the reduction runs over the rank's ``dp`` group, and
    every tp rank of one dp coordinate takes the same rows.

    ``mesh`` with ``sp > 1``: every sp rank of one dp coordinate takes
    the same rows and ``loss_fn`` its sequence shard of them (the
    sequence-parallel forward; each rank's gradients are its own shard's
    share); the gradients, loss and metric are reduced over ``dp`` and
    ``sp`` in the one collective, each rank weighted by its dp share over
    ``sp``.

    ``mesh`` with ``ep > 1`` or ``pp > 1`` (beside ``dp`` only) needs
    ``param_spec_tree`` and ``batch_spec=None``: every rank computes the
    loss of the whole batch (module doc), and two collectives reduce the
    gradients: the replicated leaves (with the loss and the metric) over
    the whole mesh, weighted ``1 / n``, and the sharded ones over
    ``dp``, weighted ``1 / (dp ep)`` for an expert bank and ``1 / dp``
    for a stage."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if grad_accum > 1 and has_aux_state:
        # sequential microbatches would thread a stale state through the
        # loss; the reference refuses the combination too
        raise NotImplementedError(
            "grad_accum > 1 with has_aux_state is not supported")
    shape = dict(mesh.shape) if mesh is not None else {}
    dp, sp, tp, ep, pp = (shape.get(a, 1) for a in ("dp", "sp", "tp", "ep",
                                                     "pp"))
    # the axis beside dp over which every rank computes the whole batch
    whole = "ep" if ep > 1 else "pp" if pp > 1 else None
    if whole is not None and mesh.size != dp * shape[whole]:
        raise NotImplementedError(
            f"training on mesh {shape}: ep and pp train beside dp only "
            "(no other axis, and not both)")
    # the axes the gradients are reduced over, and the group's name
    grad_axis = {(True, True): GRAD_AXES, (True, False): "dp",
                 (False, True): "sp"}.get((dp > 1, sp > 1))
    if (tp > 1 or whole) and param_spec_tree is None:
        raise ValueError(f"a mesh over {'tp' if tp > 1 else whole} needs "
                         "param_spec_tree (the parameters' sharding specs)")
    if batch_spec not in ("dp", None):
        raise ValueError(f"batch_spec must be 'dp' or None, got "
                         f"{batch_spec!r}")
    if whole and batch_spec is not None:
        raise ValueError(f"on a mesh over {whole} every rank computes the "
                         "whole batch: batch_spec must be None")
    n = dp * shape.get(whole, 1)
    # a replicated leaf's group: the whole mesh
    whole_group = (("dp", whole) if dp > 1 else whole) if whole else None

    def grads_of(params, leaves, batch):
        loss, metric = loss_fn(params, batch)
        aux = None
        if has_aux_state:
            metric, aux = metric
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metric.detach(), grads, aux

    def local_grads(params, leaves, batch):
        if grad_accum == 1:
            return grads_of(params, leaves, batch)
        sums = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        loss = metric = 0.0
        for mb in _split(batch, grad_accum):
            l_mb, m_mb, g_mb, _ = grads_of(params, leaves, mb)
            for acc, g in zip(sums, g_mb):
                acc += g.float()
            loss = loss + l_mb
            metric = metric + m_mb
            del g_mb
        grads = [(acc / grad_accum).to(t.dtype)
                 for acc, t in zip(sums, leaves)]
        return loss / grad_accum, metric / grad_accum, grads, None

    def reduce_whole(grads, loss, metric, axes):
        """The ep/pp reduction (the method doc): the replicated leaves
        with the loss and the metric over the whole mesh, the sharded
        ones over dp."""
        grads = list(grads)
        rep = [i for i, ax in enumerate(axes) if ax is None]
        shd = [i for i, ax in enumerate(axes) if ax is not None]
        g_rep, (loss, metric) = mesh.reduce_grads(
            [grads[i] for i in rep], (loss.float(), metric.float()),
            1.0 / n, whole_group)
        g_shd, _ = mesh.reduce_grads([grads[i] for i in shd], (),
                                     1.0 / (n if whole == "ep" else dp),
                                     "dp")
        for i, g in zip(rep + shd, g_rep + g_shd):
            grads[i] = g
        return grads, loss, metric

    def step(params, opt_state, batch):
        leaves = _leaves(params)
        # the axis each leaf is sharded over (None: replicated)
        sharded = None if tp == 1 and not whole else [
            next((a for a in spec if a is not None), None)
            for spec in _leaf_specs(params, param_spec_tree)]
        weight, empty = 1.0 / (dp * sp), False
        if dp > 1 and batch_spec is None and not whole:
            start, rows = dp_rows(batch.shape[0], mesh)
            weight, empty = rows / batch.shape[0] / sp, rows == 0
            batch = batch[start:start + rows]
        aux = None
        for t in leaves:
            t.requires_grad_(True)
        try:
            if empty:
                zero = torch.zeros((), device=leaves[0].device)
                loss, metric = zero, zero
                grads = [torch.zeros_like(t) for t in leaves]
            else:
                loss, metric, grads, aux = local_grads(params, leaves, batch)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        if whole:
            with record_function("train_step.grad_all_reduce"):
                grads, loss, metric = reduce_whole(grads, loss, metric,
                                                   sharded)
        elif grad_axis is not None:
            with record_function("train_step.grad_all_reduce"):
                grads, (loss, metric) = mesh.reduce_grads(
                    grads, (loss.float(), metric.float()), weight, grad_axis)
        with record_function("train_step.optimizer"):
            apply_updates(optimizer, params, list(grads), opt_state,
                          sharded, mesh)
        out = {"loss": loss, "metric": metric}
        if has_aux_state:
            return params, opt_state, _detached(aux), out
        return params, opt_state, out

    return step
