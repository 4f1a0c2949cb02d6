"""The process mesh of tensor- and expert-parallel serving and data-,
tensor-, sequence-, expert- and pipeline-parallel training (port of
``dcos_commons_tpu/parallel/mesh.py``).

The reference's mesh is a grid of devices with named axes, and XLA
inserts the collectives from the shardings. Here one process drives one
device, a mesh is a grid of processes joined by ``torch.distributed``
(``parallel.distributed.initialize`` forms the process group from the
scheduler's rank contract), and the model calls the collectives itself,
through :class:`Mesh`: :meth:`Mesh.all_reduce` and :meth:`Mesh.all_gather`
on device tensors, :meth:`Mesh.broadcast_array` and
:func:`host_all_gather` on host arrays. They live here and nowhere else,
as does the map from a leaf's sharding spec to this rank's slice of it
(:func:`shard_slices`), which the model's shards and the gang checkpoint
share.

The backend follows the layout, and the mesh states it
(:attr:`Mesh.backend`): each rank opens ``cuda:(rank % device_count)``;
the ranks all-gather (hostname, device UUID) over the world's gloo group
and take ``nccl`` for the device collectives when no two ranks share a
device, ``gloo`` when some do (several ranks on one card) or on the CPU.
gloo reduces host memory, so on CUDA tensors it stages through the host,
in this module only. An NCCL group that fails to form raises; it is never
retried with gloo.

A rank's coordinates are its rank in row-major order over :data:`AXES`
(``dcn`` folded into ``dp``, slice-major), as the reference lays out its
device grid, and each axis larger than 1 gets its own group over the
ranks that share the other coordinates; with ``dp`` and one of ``sp``,
``ep`` or ``pp`` both larger than 1, also one group over the two
(:data:`PAIRS`), where the gradients of the leaves replicated over both
are reduced. Every axis may be larger than 1.

Data parallelism needs two collectives that autograd sees, and they live
here: :meth:`Mesh.all_reduce_mean` (its backward is the all-reduce-mean
of the cotangents: each rank backpropagates its own local-mean loss and
the gradients are then averaged over ``dp``) and
:meth:`Mesh.reduce_grads` (every gradient leaf packed into one fp32
buffer, reduced once a step, cast back to each leaf's dtype).

Tensor-parallel training needs Megatron's pair, each the other's adjoint:
:meth:`Mesh.copy_to` ("f": the identity forward, the all-reduce-sum of
the cotangents backward, at the input of a column-parallel product, so
every rank's residual-stream gradient is whole) and
:meth:`Mesh.reduce_from` ("g": the all-reduce-sum forward, the identity
backward, at the output of a row-parallel product). Also
:meth:`Mesh.gather_from` (the all-gather forward, the rank's own slice
of the cotangent backward) and :meth:`Mesh.all_reduce_max` (no
gradient), which the vocabulary-parallel loss reads.

Sequence-parallel training needs three more, each with its adjoint:
:meth:`Mesh.ppermute` (the ring hop, ``lax.ppermute``: the backward is
the hop the other way), :meth:`Mesh.all_to_all` (``lax.all_to_all(...,
tiled=True)``: the backward is the inverse all-to-all) and
:meth:`Mesh.gather_seq` (the all-gather forward; the backward sums the
cotangents over the axis and narrows to the rank's slice, a
reduce-scatter: every rank's queries read every rank's keys).

Expert parallelism (``parallel.moe``) dispatches over ``ep`` with
``all_to_all(x, "ep", 0, 1)`` and returns with ``all_to_all(x, "ep", 1,
0)``; the pipeline (``parallel.pipeline``) hops with ``ppermute(x, "pp",
1)``, feeds stage 0 through :meth:`Mesh.copy_to` over ``pp`` and sums
the last stage's outputs with :meth:`Mesh.reduce_from` over ``pp``.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

#: canonical mesh axes, outermost first
AXES: Tuple[str, ...] = ("dp", "pp", "sp", "tp", "ep")

#: the axes a step reduces its gradients over: the parameters are
#: replicated over both
GRAD_AXES: Tuple[str, ...] = ("dp", "sp")

#: the pairs of axes that get one group over both when both are larger
#: than 1: a leaf replicated over both reduces its gradient there
PAIRS: Tuple[Tuple[str, str], ...] = (GRAD_AXES, ("dp", "pp"), ("dp", "ep"))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each named mesh axis, as in the reference: axes of size
    1 stay in the mesh, and ``dcn`` folds into ``dp``."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    dcn: int = 1

    def axis_sizes(self) -> Tuple[int, ...]:
        sizes = tuple(getattr(self, a) for a in AXES)
        return (sizes[0] * self.dcn,) + sizes[1:]

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes())

    @classmethod
    def auto(cls, n_devices: int,
             prefer: Sequence[str] = ("tp", "pp", "ep", "sp")) -> "MeshSpec":
        """Factorize ``n_devices`` into a full five-axis mesh: each
        preferred axis gets a factor of 2 while one is left, the rest
        goes to ``dp``."""
        sizes = {a: 1 for a in AXES}
        remaining = n_devices
        for axis in prefer:
            if remaining % 2 == 0 and remaining >= 2:
                sizes[axis] = 2
                remaining //= 2
        sizes["dp"] = remaining
        return cls(**sizes)

    def build(self, device: Optional[DeviceLike] = None) -> "Mesh":
        """This rank's :class:`Mesh` over the process group. ``device``
        ``"cpu"`` keeps the rank on the CPU; otherwise the rank opens
        ``cuda:(rank % device_count)``. A mesh of one process needs no
        process group and keeps ``device`` as given."""
        import torch.distributed as dist

        shape = dict(zip(AXES, self.axis_sizes()))
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        if self.size != world:
            raise ValueError(f"mesh {shape} needs {self.size} processes, "
                             f"the process group has {world}")
        coords = mesh_coords(shape, rank)
        if world == 1:
            # one process drives the device it was given (``cuda:N``)
            return Mesh(shape, coords, resolve_device(
                device if device is not None else "cuda"), "local",
                rank=rank)
        dev = _rank_device(device, rank)
        cpu_group = _cpu_group()
        layout: List[Tuple[str, Optional[str]]] = [None] * world
        dist.all_gather_object(layout, (socket.gethostname(),
                                        _device_uuid(dev)), group=cpu_group)
        backend = choose_backend(layout)
        groups, lanes = {}, {}
        keys: List = [axis for axis, n in shape.items() if n > 1]
        keys += [pair for pair in PAIRS if all(shape[a] > 1 for a in pair)]
        for key in keys:
            # every rank forms every group of the axis, in one order
            for ranks in axis_groups(shape, key):
                if len(ranks) == world and backend == "gloo":
                    group = cpu_group
                else:
                    group = dist.new_group(ranks=ranks, backend=backend)
                if rank in ranks:
                    groups[key], lanes[key] = group, ranks
        return Mesh(shape, coords, dev, backend, groups=groups,
                    cpu_group=cpu_group, layout=layout, rank=rank,
                    lanes=lanes)


def mesh_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: its place in row-major
    order over ``AXES``, as the reference's device grid is laid out."""
    idx = np.unravel_index(rank, tuple(shape[a] for a in AXES))
    return {a: int(i) for a, i in zip(AXES, idx)}


def axis_groups(shape: Dict[str, int], axis) -> List[List[int]]:
    """The groups of ``axis`` (a name, or a tuple of names for one group
    over several axes): for each setting of the other coordinates, the
    ranks along ``axis`` in row-major order."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    grid = np.arange(math.prod(shape[a] for a in AXES)).reshape(
        tuple(shape[a] for a in AXES))
    lanes = np.moveaxis(grid, [AXES.index(a) for a in axes],
                        range(-len(axes), 0)).reshape(
        -1, math.prod(shape[a] for a in axes))
    return [[int(r) for r in lane] for lane in lanes]


def choose_backend(layout: Sequence[Tuple[str, Optional[str]]]) -> str:
    """The device collectives' backend from every rank's (hostname,
    device UUID; None on the CPU): ``nccl`` when every rank drives a CUDA
    device no other rank drives, else ``gloo``."""
    if any(uuid is None for _, uuid in layout):
        return "gloo"
    return "nccl" if len(set(layout)) == len(layout) else "gloo"


def _rank_device(device: Optional[DeviceLike], rank: int) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(device if device is not None else "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _device_uuid(dev: torch.device) -> Optional[str]:
    if dev.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    # without a UUID, the PCI bus id names the card on its host
    return str(uuid) if uuid is not None else f"pci:{props.pci_bus_id}"


def _cpu_group():
    """The world's gloo group: ``parallel.distributed.initialize`` forms
    the default group over gloo."""
    import torch.distributed as dist
    assert dist.get_backend() == "gloo", dist.get_backend()
    return dist.group.WORLD


class Mesh:
    """One rank's view of the process mesh.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does; ``coords`` this rank's place on each; ``device`` the device it
    drives; ``backend`` the device collectives' (``nccl``, ``gloo``, or
    ``local`` for a mesh of one); ``groups`` each axis's process group
    (an axis of size 1 has none) and ``lanes`` its ranks in order (the
    ring's neighbours). An axis argument is a name, or a pair of
    :data:`PAIRS` for the group over both. The collectives count their
    calls and host seconds in ``collectives`` and ``collective_s``."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 device: torch.device, backend: str, *, rank: int,
                 groups=None, cpu_group=None, layout=None, lanes=None):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.device = device
        self.backend = backend
        self._groups = dict(groups or {})
        self._lanes = dict(lanes or {})
        self._cpu_group = cpu_group
        self.layout = list(layout) if layout is not None else None
        self._rank = rank
        self.collectives = 0
        self.collective_s = 0.0
        self._pinned: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        """This rank's place in the process group."""
        return self._rank

    def axis_size(self, axis) -> int:
        """The size of ``axis``, a name or a tuple of names."""
        if isinstance(axis, str):
            return self.shape[axis]
        return math.prod(self.shape[a] for a in axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    def _start(self, x: torch.Tensor) -> float:
        """The clock at a collective's start. Before a staged copy the
        device finishes the work that made ``x`` (the copy would wait for
        it anyway), so ``collective_s`` holds the copies and the
        exchange, not that work; on NCCL it holds the host's enqueue
        only."""
        if self.backend == "gloo" and x.device.type == "cuda":
            torch.cuda.current_stream(x.device).synchronize()
        return time.perf_counter()

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the backend reduces: gloo takes host memory, here a
        view of one pinned buffer kept for the mesh (grown to the largest
        tensor staged; a device-to-host copy into pageable memory took
        2.4 s for 5.1 GB on an H100 host, into pinned 0.12 s)."""
        x = x.contiguous()
        if self.backend == "gloo" and x.device.type != "cpu":
            n = x.numel() * x.element_size()
            if self._pinned is None or self._pinned.numel() < n:
                self._pinned = None
                self._pinned = torch.empty(n, dtype=torch.uint8,
                                           pin_memory=True)
            buf = self._pinned[:n].view(x.dtype).view(x.shape)
            buf.copy_(x)
            return buf
        return x

    def all_reduce(self, x: torch.Tensor, axis="tp",
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the largest) of ``x`` over ``axis``, the
        same bits on every rank. A fresh partial product may be reduced
        in place. Outside autograd: see :meth:`all_reduce_mean`,
        :meth:`copy_to` and :meth:`reduce_from`."""
        if self.axis_size(axis) == 1:
            return x
        import torch.distributed as dist
        t0 = self._start(x)
        buf = self._stage(x)
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self._groups[axis])
        out = buf.to(x.device)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, axis: str = "tp",
                   dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
        rank order."""
        n = self.shape[axis]
        if n == 1:
            return x
        import torch.distributed as dist
        t0 = self._start(x)
        buf = self._stage(x)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=self._groups[axis])
        out = torch.cat(parts, dim=dim).to(x.device)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out

    def all_reduce_mean(self, x: torch.Tensor, axis: str = "dp"
                        ) -> torch.Tensor:
        """The mean of ``x`` over ``axis`` as autograd sees it: the
        backward is the mean of the cotangents over ``axis`` (each rank
        backpropagates its own local-mean loss, and the step averages the
        gradients over ``dp``)."""
        if self.shape[axis] == 1:
            return x
        return _AllReduceMean.apply(x, self, axis)

    def all_reduce_max(self, x: torch.Tensor, axis: str = "tp"
                       ) -> torch.Tensor:
        """The elementwise largest ``x`` over ``axis``; no gradient."""
        return self.all_reduce(x.detach().clone(), axis, op="max")

    def copy_to(self, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """Megatron's "f": ``x`` forward; backward, the sum of the
        cotangents over ``axis``. It stands at the input of a
        column-parallel product, whose backward leaves each rank a partial
        gradient of ``x``."""
        if self.shape[axis] == 1 or not (torch.is_grad_enabled()
                                         and x.requires_grad):
            return x
        return _CopyTo.apply(x, self, axis)

    def reduce_from(self, x: torch.Tensor, axis: str = "tp"
                    ) -> torch.Tensor:
        """Megatron's "g": the sum of ``x`` over ``axis`` forward; the
        identity backward. It stands at the output of a row-parallel
        product. Outside autograd (serving) it reduces ``x`` in place,
        which must then be a fresh partial product."""
        if self.shape[axis] == 1:
            return x
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_reduce(x, axis)
        return _ReduceFrom.apply(x, self, axis)

    def gather_from(self, x: torch.Tensor, axis: str = "tp",
                    dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order
        forward; backward, this rank's slice of the cotangent."""
        if self.shape[axis] == 1:
            return x
        return _GatherFrom.apply(x, self, axis, dim)

    def reduce_grads(self, grads: Sequence[torch.Tensor],
                     extra: Sequence[torch.Tensor] = (),
                     weight: float = 1.0, axis="dp"
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``sum over axis of weight * leaf`` for every gradient leaf and
        every ``extra`` scalar (the step's loss and metric), in ONE
        collective: the leaves are packed into one fp32 buffer, reduced,
        and cast back to each leaf's dtype. ``weight`` is this rank's
        share of the global batch (``1 / n`` for equal shares, so the
        gradients are averaged); ``axis`` may be :data:`GRAD_AXES`."""
        leaves = list(grads) + [e.reshape(1) for e in extra]
        flat = torch.cat([g.reshape(-1).float() for g in leaves])
        if weight != 1.0:
            flat.mul_(weight)
        flat = self.all_reduce(flat, axis)
        out, at = [], 0
        for g in leaves:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        n = len(grads)
        return out[:n], [e.reshape(()) for e in out[n:]]

    def gather_seq(self, x: torch.Tensor, axis: str = "sp",
                   dim: int = 1) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order
        forward; backward, the cotangents summed over ``axis`` and this
        rank's slice of the sum (a reduce-scatter). Unlike
        :meth:`gather_from`, whose backward narrows only, it is right
        where the ranks' downstream work differs, as each sequence
        shard's queries over the gathered keys do."""
        if self.shape[axis] == 1:
            return x
        return _GatherSeq.apply(x, self, axis, dim)

    def ppermute(self, x: torch.Tensor, axis: str = "sp",
                 shift: int = 1) -> torch.Tensor:
        """The ring hop (``lax.ppermute`` with ``perm = [(r, r + shift)
        mod n]``): this rank's ``x`` goes to the rank ``shift`` places on
        along ``axis`` and the one ``shift`` places back sends its own;
        every rank holds the same shape. A pair of non-blocking
        ``isend``/``irecv`` (staged through the host on gloo). Its
        backward is the hop the other way."""
        if self.shape[axis] == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _PPermute.apply(x, self, axis, shift)
        return self._ppermute(x, axis, shift)

    def _ppermute(self, x: torch.Tensor, axis: str, shift: int
                  ) -> torch.Tensor:
        import torch.distributed as dist
        lane, n = self._lanes[axis], self.shape[axis]
        me = self.coords[axis]
        t0 = self._start(x)
        buf = self._stage(x)
        got = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, lane[(me + shift) % n],
                          group=self._groups[axis]),
               dist.P2POp(dist.irecv, got, lane[(me - shift) % n],
                          group=self._groups[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = got.to(x.device)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out

    def all_to_all(self, x: torch.Tensor, axis: str = "sp",
                   split_dim: int = 2, concat_dim: int = 1) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
        ``x`` cut into ``n`` equal chunks on ``split_dim``, chunk ``j``
        sent to rank ``j`` of ``axis``, the chunks received concatenated
        on ``concat_dim`` in rank order (``all_to_all_single`` on the
        axis's group, staged through the host on gloo). Its backward is
        the inverse all-to-all (``split_dim`` and ``concat_dim``
        swapped)."""
        if self.shape[axis] == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _AllToAll.apply(x, self, axis, split_dim, concat_dim)
        return self._all_to_all(x, axis, split_dim, concat_dim)

    def _all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
        import torch.distributed as dist
        n = self.shape[axis]
        split_dim %= x.dim()
        concat_dim %= x.dim()
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)}"
                             f" does not divide over {axis}={n}")
        # [n, chunk...]: chunk j leads, for rank j
        parts = x.movedim(split_dim, 0)
        parts = parts.reshape(n, parts.shape[0] // n, *parts.shape[1:])
        t0 = self._start(x)
        buf = self._stage(parts)
        got = torch.empty_like(buf)
        dist.all_to_all_single(got, buf, group=self._groups[axis])
        got = got.to(x.device).movedim(1, split_dim + 1)
        out = torch.cat(got.unbind(0), dim=concat_dim)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out

    def broadcast_array(self, arr: np.ndarray, src: int = 0) -> np.ndarray:
        """Rank ``src``'s ``arr`` on every rank (same shape and dtype
        everywhere), over the CPU group."""
        if self.size == 1:
            return arr
        import torch.distributed as dist
        buf = torch.from_numpy(np.ascontiguousarray(arr).copy())
        dist.broadcast(buf, src=src, group=self._cpu_group)
        return buf.numpy()


class _AllReduceMean(torch.autograd.Function):
    """``Mesh.all_reduce_mean``: forward and backward are both the mean
    over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        # ``all_reduce`` may reduce in place: ``x`` is the caller's
        return mesh.all_reduce(x.clone(), axis) / mesh.shape[axis]

    @staticmethod
    def backward(ctx, g):
        # autograd may hand this same ``g`` to other branches
        mesh, axis = ctx.mesh, ctx.axis
        return mesh.all_reduce(g.clone(), axis) / mesh.shape[axis], None, None


class _CopyTo(torch.autograd.Function):
    """``Mesh.copy_to``: identity forward, all-reduce-sum backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # autograd may hand this same ``g`` to other branches
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """``Mesh.reduce_from``: all-reduce-sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        # ``all_reduce`` may reduce in place: ``x`` is the caller's
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """``Mesh.gather_from``: all-gather forward, own slice backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.n, ctx.dim = x.shape[dim], dim
        ctx.at = mesh.coords[axis] * x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at, ctx.n), None, None, None


class _GatherSeq(torch.autograd.Function):
    """``Mesh.gather_seq``: all-gather forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.n, ctx.dim = mesh, axis, x.shape[dim], dim
        ctx.at = mesh.coords[axis] * x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # autograd may hand this same ``g`` to other branches
        g = ctx.mesh.all_reduce(g.clone(), ctx.axis)
        return g.narrow(ctx.dim, ctx.at, ctx.n).contiguous(), None, None, None


class _PPermute(torch.autograd.Function):
    """``Mesh.ppermute``: the hop forward, the hop back backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh._ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._ppermute(g, ctx.axis, -ctx.shift), None, None, None


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all``: the exchange forward, its inverse backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.dims = (split_dim % x.dim(), concat_dim % x.dim())
        return mesh._all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.mesh._all_to_all(g, ctx.axis, concat_dim, split_dim),
                None, None, None, None)


def host_all_gather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` stacked in rank order ``[world, ...]``,
    over the world's gloo group; ``arr[None]`` without a process group.
    The gang checkpoint's step agreement reads it."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.asarray(arr)[None]
    buf = torch.from_numpy(np.ascontiguousarray(arr).copy())
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf, group=_cpu_group())
    return torch.stack(parts).numpy()


# a leaf's sharding: one mesh axis name (or None) per dimension, the
# reference's PartitionSpec as a tuple; () is replicated
Spec = Tuple[Optional[str], ...]


def _entries(spec: Spec, ndim: int) -> List[Optional[str]]:
    return list(spec) + [None] * (ndim - len(spec))


def scale_spec(spec: Spec, s_shape: Sequence[int]) -> Spec:
    """A QTensor's scales: the weight's spec with the collapsed (size-1)
    axes unsharded, so a column-parallel ``wq`` shards its scales with
    the out-channels and a row-parallel ``wo`` keeps them whole."""
    return tuple(None if n == 1 else axis for n, axis in
                 zip(s_shape, _entries(spec, len(s_shape))))


def shard_slices(shape: Sequence[int], spec: Spec, mesh: "Mesh"
                 ) -> List[Tuple[int, int]]:
    """(start, length) on each dimension of this rank's slice of a whole
    array of ``shape`` sharded under ``spec``."""
    out = []
    for dim, axis in zip(shape, _entries(spec, len(shape))):
        n = 1 if axis is None else mesh.shape[axis]
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by {axis}={n}")
        out.append((mesh.coords[axis] * (dim // n) if n > 1 else 0,
                    dim // n))
    return out


def take_shard(t: torch.Tensor, spec: Spec, mesh: "Mesh") -> torch.Tensor:
    """This rank's slice of a whole ``t`` under ``spec``, a tensor of its
    own."""
    out = t
    for dim, (start, n) in enumerate(shard_slices(t.shape, spec, mesh)):
        out = out.narrow(dim, start, n)
    return out.clone(memory_format=torch.contiguous_format)


def gather_whole(t: torch.Tensor, spec: Spec, mesh: "Mesh") -> torch.Tensor:
    """The whole array of which ``t`` is this rank's slice under
    ``spec``: one all-gather for each sharded dimension."""
    for dim, axis in enumerate(_entries(spec, t.dim())):
        if axis is not None:
            t = mesh.all_gather(t, axis, dim=dim)
    return t


def whole_shape(local_shape: Sequence[int], spec: Spec, mesh: "Mesh"
                ) -> List[int]:
    """The whole array's shape from one rank's slice of it under
    ``spec``."""
    return [d * (1 if axis is None else mesh.shape[axis])
            for d, axis in zip(local_shape, _entries(spec, len(local_shape)))]


def local_chunk(global_dim: int, mesh: "Mesh", axis: str) -> int:
    """Size of one shard of ``global_dim`` along mesh axis ``axis``."""
    n = mesh.shape[axis]
    if global_dim % n != 0:
        raise ValueError(f"dim {global_dim} not divisible by {axis}={n}")
    return global_dim // n


def tp_size(mesh: Optional["Mesh"]) -> int:
    """The ``tp`` axis's size; 1 without a mesh."""
    return mesh.shape["tp"] if mesh is not None else 1


def sp_size(mesh: Optional["Mesh"]) -> int:
    """The ``sp`` axis's size; 1 without a mesh."""
    return mesh.shape["sp"] if mesh is not None else 1
