"""Sharded model checkpoints: per-shard files + manifest, in the on-disk
format of ``dcos_commons_tpu/parallel/checkpoint.py`` (port).

Layout, one directory per (step, process)::

    <out>/step-00000042-p0/
        manifest.json                  # leaves -> shards, shapes, dtypes
        params.layers.wq.o0_0_0.bin    # raw bytes of one shard
        ...

The format is the reference's byte for byte, so a tree saved by either
package restores in the other bitwise:

* leaves are walked as ``jax.tree_util`` flattens a pytree: dict keys in
  SORTED order, sequence entries by index, a quantized leaf
  (:class:`~dcos_commons_tpu_torch.ops.quant.QTensor`) as its bare
  children ``(q, s)``, so its keys end in ``.0`` and ``.1``; ``None`` is
  an empty subtree. A leaf's key joins its path with ``.``;
* one process holds each array whole, so every leaf is one shard whose
  index key is ``o`` followed by one ``0`` per dimension (``o0_0`` for a
  matrix, ``o`` for a 0-d leaf); in a gang (``mesh=`` and ``specs=``,
  the tree's ``llama.param_specs``) each process writes the shard it
  owns under the whole leaf's ``global_shape``, its index key the start
  offsets of the shard (``o0_0_2048``), replicated leaves whole, as the
  reference's processes do (a replica over ``dp`` or ``sp`` writes its
  own copy in its own directory, and no shard twice). ``disk_specs`` names a leaf's spec on disk
  where it differs from the live one: the reference keys its optimizer
  state's placement by shape (``models.train.opt_state_specs``), so a
  rank's column shard of ``wq``'s moments is written as the reference's
  row shard. Such a leaf is all-gathered over the mesh and re-sliced at
  save, and at restore its disk shard is all-gathered and the rank's own
  slice taken back out (every rank in one order: these are collectives);
* a shard file is the array's C-order bytes (bf16 through a ``uint16``
  view); the manifest names the dtype as numpy does (``bfloat16``,
  ``int8``, ``float32``) and carries each shard's length and blake2s
  digest, so a truncated or bit-flipped shard raises
  :class:`CheckpointCorrupt` at restore;
* commit: shards and manifest go into a dot-tmp directory, fsynced, then
  ``os.rename``; keep-prune drops this process's older steps. Shards are
  hashed and written ``RESTORE_WORKERS`` (4) at a time.

Each process writes and reads its own ``step-XXXXXXXX-p{rank}``
directory, its rank read from the process group (0 without one). In a
gang :func:`latest_step` is the newest step every member has committed,
agreed over the world's gloo group. Restore reads and verifies shard
files a bounded window ahead (``workers``) and accepts another byte
source (``reader`` + ``manifest``). A checkpoint saved sharded over several
devices restores by assembling its shards on the host.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.quant import QTensor
from .mesh import (gather_whole, host_all_gather, scale_spec, shard_slices,
                   take_shard, whole_shape)

_STEP_RE = re.compile(r"step-(\d{8})-p(\d+)$")

# torch dtype -> the name numpy (and ml_dtypes) give it in the manifest
_DTYPE_NAMES = {
    torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.float32: "float32", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


class CheckpointCorrupt(ValueError):
    """A shard failed verification (digest mismatch or truncation):
    restore aborts rather than hand back silently wrong weights."""


def _process_id() -> int:
    """This process's rank in the process group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _num_processes() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


# ---------------------------------------------------------------------------
# the pytree walk: jax.tree_util's order and keys


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """``[(leaf key, leaf)]`` in ``jax.tree_util.tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (str(k),))
        return out
    if isinstance(tree, QTensor):
        return [(".".join(path + ("0",)), tree.q),
                (".".join(path + ("1",)), tree.s)]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        names = fields if fields is not None else range(len(tree))
        out = []
        for name, child in zip(names, tree):
            out += _flatten(child, path + (str(name),))
        return out
    return [(".".join(path) if path else "_root", tree)]


def _unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with its leaves taken in order from
    ``leaves`` (consumed from the front)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], leaves)
        return {k: out[k] for k in tree}
    if isinstance(tree, QTensor):
        q = leaves.pop(0)
        return QTensor(q, leaves.pop(0))
    if isinstance(tree, (list, tuple)):
        children = [_unflatten(c, leaves) for c in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*children)
        return type(tree)(children)
    return leaves.pop(0)


def _index_key(ndim: int, starts: Optional[List[int]] = None) -> str:
    """The index key of a shard: its start offsets (all 0 for a whole
    array)."""
    starts = starts if starts is not None else [0] * ndim
    return "o" + "_".join(str(o) for o in starts) if ndim else "o"


# where one leaf's local array sits in the whole one: (global shape,
# start offsets); None for a whole leaf
Layout = Optional[Tuple[List[int], List[int]]]


class _Place(NamedTuple):
    """Where one leaf goes on disk: its :data:`Layout`, and with
    ``moved`` the live and disk specs it is re-sliced between and its
    shape on disk."""

    layout: Layout
    moved: bool = False
    live: Any = None
    disk: Any = None
    disk_shape: Optional[List[int]] = None


def _places(tree: Any, mesh: Any, specs: Any, disk_specs: Any = None
            ) -> List[_Place]:
    """One :class:`_Place` per leaf of ``_flatten(tree)``, from the tree's
    sharding ``specs`` (``llama.param_specs``' form: a tuple of axis
    names per leaf, a ``QTensor``'s scales under ``mesh.scale_spec``;
    sequences and named tuples hold their children's specs) over
    ``mesh``, and ``disk_specs`` (default ``specs``). No mesh, or a mesh
    of one: every leaf whole."""
    flat = _flatten(tree)
    if mesh is None or mesh.size == 1:
        return [_Place(None)] * len(flat)

    out: List[_Place] = []

    def walk(node, spec, disk):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k], disk[k])
        elif isinstance(node, QTensor):
            walk(node.q, spec, disk)
            walk(node.s, scale_spec(spec, tuple(node.s.shape)),
                 scale_spec(disk, tuple(node.s.shape)))
        elif isinstance(node, (list, tuple)):
            for child, sp, dk in zip(node, spec, disk):
                walk(child, sp, dk)
        else:
            shape = whole_shape(node.shape, spec, mesh)
            cut = shard_slices(shape, disk, mesh)
            local = [n for _, n in cut]
            layout = (shape, [s for s, _ in cut]) if local != shape else None
            moved = cut != shard_slices(shape, spec, mesh)
            out.append(_Place(layout, moved, spec, disk, local))

    walk(tree, specs, specs if disk_specs is None else disk_specs)
    return out


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as the C-order host array whose bytes are stored: a tensor
    bit for bit (bf16 as ml_dtypes would hold it, through ``uint16``); a
    host value coerced as ``jnp.asarray`` would (64-bit to 32-bit)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return np.array(a, order="C")        # keeps a 0-d leaf 0-d


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor):
        return _DTYPE_NAMES[leaf.dtype]
    return str(arr.dtype)


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a shard's bytes are read as (bf16 as ``uint16``)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _leaf_entry(key: str, leaf: Any, layout: Layout = None
                ) -> Tuple[dict, str, bytes]:
    """(manifest entry, file name, bytes) of one leaf, a shard of a
    larger array under ``layout``."""
    arr = _host_array(leaf)
    gshape, starts = layout if layout is not None else (list(arr.shape),
                                                        None)
    ikey = _index_key(arr.ndim, starts)
    fname = f"{key}.{ikey}.bin"
    raw = arr.tobytes()
    shard = {"file": fname, "index": ikey,
             "local_shape": list(arr.shape), "bytes": len(raw),
             "digest": hashlib.blake2s(raw).hexdigest()}
    return ({"global_shape": list(gshape),
             "dtype": _dtype_name(leaf, arr), "shards": [shard]},
            fname, raw)


def export_tree(tree: Any) -> Tuple[Dict[str, dict], Dict[str, bytes]]:
    """``(leaves, blobs)`` of a live tree in the exact manifest schema
    :func:`save_sharded` commits (per-shard digests included), without
    touching the filesystem. The tensors are only read."""
    leaves: Dict[str, dict] = {}
    blobs: Dict[str, bytes] = {}
    for key, leaf in _flatten(tree):
        entry, fname, raw = _leaf_entry(key, leaf)
        leaves[key] = entry
        blobs[fname] = raw
    return leaves, blobs


# ---------------------------------------------------------------------------
# save


def _step_dir(out_dir: str, step: int, pid: int) -> str:
    return os.path.join(out_dir, f"step-{step:08d}-p{pid}")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_sharded(out_dir: str, step: int, tree: Any, keep: int = 3, *,
                 mesh: Any = None, specs: Any = None,
                 disk_specs: Any = None) -> str:
    """Write ``tree`` (a pytree of tensors) for ``step``; returns the
    committed directory. Older steps of this process beyond ``keep`` are
    pruned. In a gang, ``tree`` is this rank's shard of a tree sharded
    by ``specs`` over ``mesh``, written as ``disk_specs`` shard it."""
    pid = _process_id()
    places = _places(tree, mesh, specs, disk_specs)
    # the leaves stored under another spec, re-sliced here in the walk's
    # order on every rank (collectives), before the threads write
    flat = [(key, take_shard(gather_whole(leaf, pl.live, mesh), pl.disk,
                             mesh) if pl.moved else leaf)
            for (key, leaf), pl in zip(_flatten(tree), places)]
    final = _step_dir(out_dir, step, pid)
    tmp = os.path.join(out_dir, f".step-{step:08d}-p{pid}.tmp")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    def write(item: Tuple[Tuple[str, Any], Layout]) -> dict:
        entry, fname, raw = _leaf_entry(*item[0], item[1])
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        return entry

    # leaves copied to the host, hashed and written a few at a time (the
    # digest and the write release the interpreter lock); the manifest
    # keeps the walk's order
    with ThreadPoolExecutor(max_workers=_restore_workers(None)) as pool:
        entries = list(pool.map(write, zip(flat, [pl.layout
                                                  for pl in places])))
    leaves = {key: entry for (key, _), entry in zip(flat, entries)}

    manifest = {"step": step, "process": pid,
                "num_processes": _num_processes(), "leaves": leaves}
    with open(os.path.join(tmp, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)                     # directory entries of the shards
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)               # commit point
    _fsync_dir(out_dir)                 # the rename itself

    mine = sorted(s for s in _local_steps(out_dir, pid) if s != step)
    for old in mine[:-(keep - 1)] if keep > 1 else mine:
        shutil.rmtree(_step_dir(out_dir, old, pid), ignore_errors=True)
    return final


def _local_steps(out_dir: str, pid: int) -> List[int]:
    steps = []
    try:
        names = os.listdir(out_dir)
    except OSError:
        return []
    for name in names:
        m = _STEP_RE.match(name)
        if m and int(m.group(2)) == pid \
                and os.path.exists(os.path.join(out_dir, name,
                                                "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(out_dir: str) -> Optional[int]:
    """Newest step EVERY gang member has committed (None when none): each
    member contributes its 8 newest local steps, all-gathered over the
    world's gloo group, and a member that died before saving step N
    holds the gang back to the last step all share. One process: its
    newest step."""
    local = _local_steps(out_dir, _process_id())
    if _num_processes() == 1:
        return max(local) if local else None
    vec = np.full((8,), -1, np.int64)
    newest = local[-8:]
    vec[:len(newest)] = newest
    rows = host_all_gather(vec)
    common = set.intersection(*[set(int(s) for s in row if s >= 0)
                                for row in rows])
    return max(common) if common else None


# ---------------------------------------------------------------------------
# restore


def _verify_shard(meta: dict, raw: bytes, source: str) -> None:
    """Hold shard bytes to the manifest: ``bytes`` catches truncation,
    ``digest`` corruption."""
    want = meta.get("bytes")
    if want is not None and len(raw) != want:
        raise CheckpointCorrupt(
            f"shard {meta['file']!r} from {source}: truncated "
            f"({len(raw)} bytes, manifest says {want})")
    digest = meta.get("digest")
    if digest is not None \
            and hashlib.blake2s(raw).hexdigest() != digest:
        raise CheckpointCorrupt(
            f"shard {meta['file']!r} from {source}: digest mismatch "
            "(corrupt shard)")


class _ShardStream:
    """Bounded-lookahead concurrent shard source: the files restore will
    consume, read ``workers`` at a time a window ahead of the assembly
    loop. Files outside the planned order are read synchronously."""

    def __init__(self, read_fn: Callable[[str], bytes],
                 order: List[str], workers: int):
        self._read = read_fn
        self._workers = workers
        self._pool = (ThreadPoolExecutor(max_workers=workers)
                      if workers > 1 and len(order) > 1 else None)
        self._futures: Dict[str, Any] = {}
        self._queue = list(order)
        self._fill()

    def _fill(self) -> None:
        if self._pool is None:
            return
        # about twice the workers in flight: enough to hide read latency,
        # bounded so a large checkpoint never stages whole
        while self._queue and len(self._futures) < 2 * self._workers:
            fname = self._queue.pop(0)
            self._futures[fname] = self._pool.submit(self._read, fname)

    def fetch(self, fname: str) -> bytes:
        fut = self._futures.pop(fname, None)
        if fname in self._queue:
            self._queue.remove(fname)
        self._fill()
        return fut.result() if fut is not None else self._read(fname)

    def close(self) -> None:
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def _restore_workers(workers: Optional[int]) -> int:
    """Shards read, verified or written at once: ``workers``, else
    ``RESTORE_WORKERS`` (4)."""
    if workers is not None:
        return max(1, int(workers))
    return max(1, int(os.environ.get("RESTORE_WORKERS", "4") or 4))


def _read(step_dir: str, fname: str) -> bytes:
    with open(os.path.join(step_dir, fname), "rb") as f:
        return f.read()


def restore_sharded(out_dir: Optional[str], template: Any,
                    step: Optional[int] = None, *,
                    workers: Optional[int] = None,
                    reader: Optional[Callable[[str], bytes]] = None,
                    manifest: Optional[dict] = None, mesh: Any = None,
                    specs: Any = None, disk_specs: Any = None) -> Any:
    """Rebuild a tree bitwise from the shard files of ``step`` (default
    the newest).

    ``template`` supplies structure, shapes, dtypes and each tensor's
    device; its values are discarded, so ``torch.empty`` tensors do.
    Host (non-tensor) leaves come back as numpy values, as in the
    reference. Raises FileNotFoundError when no complete checkpoint
    exists, :class:`CheckpointCorrupt` when a shard fails its length or
    digest check, and ValueError on a shape or dtype the checkpoint does
    not hold. ``workers`` (default ``RESTORE_WORKERS``, 4) reads shard
    files concurrently; ``reader``/``manifest`` replace the step
    directory as the byte source, every shard still verified. In a gang,
    ``template`` is this rank's shard of a tree sharded by ``specs`` over
    ``mesh``, and each leaf reads the shard this rank saved (under
    ``disk_specs``, then re-sliced to ``specs``)."""
    source = "disk"
    if reader is None:
        if out_dir is None:
            raise ValueError("restore_sharded needs out_dir or a reader")
        if step is None:
            step = latest_step(out_dir)
            if step is None:
                raise FileNotFoundError(f"no complete checkpoint under "
                                        f"{out_dir!r}")
        step_d = _step_dir(out_dir, step, _process_id())

        def reader(fname: str, _d=step_d) -> bytes:
            try:
                return _read(_d, fname)
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"checkpoint step {os.path.basename(_d)} pruned "
                    f"under restore (shard {fname!r} vanished: a "
                    "concurrent save_sharded keep-prune?)") from None
        if manifest is None:
            try:
                manifest = json.loads(
                    _read(step_d, "manifest.json").decode("utf-8"))
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"no manifest for step {step} under {out_dir!r}"
                ) from None
    else:
        source = "peer"
        if manifest is None:
            manifest = json.loads(reader("manifest.json").decode("utf-8"))
    step = manifest.get("step", step)

    flat = _flatten(template)
    # plan the tensors' shard files in consumption order so the stream
    # can read ahead; each is verified in the thread that read it
    order: List[str] = []
    metas: Dict[str, dict] = {}
    for key, leaf in flat:
        entry = manifest["leaves"].get(key)
        if entry is None:
            continue
        for meta in entry["shards"]:
            if meta["file"] not in metas:
                metas[meta["file"]] = meta
                if isinstance(leaf, torch.Tensor):
                    order.append(meta["file"])

    def read_verified(fname: str) -> bytes:
        raw = reader(fname)
        _verify_shard(metas[fname], raw, source)
        return raw

    stream = _ShardStream(read_verified, order, _restore_workers(workers))

    def fetch(meta: dict) -> bytes:
        return stream.fetch(meta["file"])

    out = []
    try:
        for (key, leaf), pl in zip(flat, _places(template, mesh, specs,
                                                 disk_specs)):
            if not pl.moved:
                out.append(_restore_leaf(key, leaf, manifest, step, fetch,
                                         pl.layout))
                continue
            stored = _restore_leaf(key, torch.empty(
                pl.disk_shape, dtype=leaf.dtype, device=leaf.device),
                manifest, step, fetch, pl.layout)
            out.append(take_shard(gather_whole(stored, pl.disk, mesh),
                                  pl.live, mesh))
    finally:
        stream.close()
    return _unflatten(template, out)


def _restore_leaf(key: str, leaf: Any, manifest: dict, step,
                  fetch: Callable[[dict], bytes], layout: Layout = None
                  ) -> Any:
    entry = manifest["leaves"].get(key)
    if entry is None:
        raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
    dtype = _np_dtype(entry["dtype"])
    if not isinstance(leaf, torch.Tensor):
        # a host leaf: one stored shard, held to the saved shape + dtype
        np_leaf = _host_array(leaf)
        if list(np_leaf.shape) != entry["global_shape"] \
                or str(np_leaf.dtype) != entry["dtype"]:
            raise ValueError(
                f"leaf {key!r}: template {np_leaf.shape}/{np_leaf.dtype} "
                f"vs checkpoint {entry['global_shape']}/{entry['dtype']}: "
                "restore requires the same mesh/sharding/config")
        shard = entry["shards"][0]
        value = np.frombuffer(fetch(shard), dtype=dtype).reshape(
            shard["local_shape"])
        return dtype.type(value) if value.shape == () else value
    gshape, starts = layout if layout is not None else (list(leaf.shape),
                                                        None)
    if list(gshape) != entry["global_shape"] \
            or _DTYPE_NAMES.get(leaf.dtype) != entry["dtype"]:
        raise ValueError(
            f"leaf {key!r}: template {tuple(gshape)}/"
            f"{_DTYPE_NAMES.get(leaf.dtype, leaf.dtype)} vs checkpoint "
            f"{entry['global_shape']}/{entry['dtype']}: restore requires "
            "the same mesh/sharding/config")
    ikey = _index_key(leaf.dim(), starts)
    meta = {s["index"]: s for s in entry["shards"]}.get(ikey)
    if meta is not None and meta["local_shape"] == list(leaf.shape):
        value = np.frombuffer(fetch(meta), dtype=dtype).reshape(
            meta["local_shape"])
    elif layout is not None:
        raise KeyError(f"leaf {key!r}: step {step} holds no shard "
                       f"{ikey} of shape {list(leaf.shape)} (a checkpoint "
                       "of another layout: resharding is ROADMAP Queue 1 "
                       "item 10e)")
    else:
        # saved sharded over several devices: paste the shards together
        value, covered = _assemble(entry, dtype, fetch)
        if not covered.all():
            raise KeyError(f"leaf {key!r}: step {step}'s shard files do "
                           "not cover the whole array (checkpoint from "
                           "another process of a gang?)")
    if leaf.dtype == torch.bfloat16:
        return torch.from_numpy(np.array(value).view(np.int16)).view(
            torch.bfloat16).to(leaf.device)
    return torch.from_numpy(np.array(value)).to(leaf.device)


def _assemble(entry: dict, dtype, fetch: Callable[[dict], bytes]):
    """Paste a leaf's saved shards into one array covering their union:
    ``(data, covered)``."""
    out = np.zeros(entry["global_shape"], dtype=dtype)
    covered = np.zeros(entry["global_shape"], dtype=bool)
    for meta in entry["shards"]:
        value = np.frombuffer(fetch(meta), dtype=dtype).reshape(
            meta["local_shape"])
        offsets = ([int(o) for o in meta["index"][1:].split("_")]
                   if len(meta["index"]) > 1 else
                   [0] * len(meta["local_shape"]))
        slices = tuple(slice(o, o + n)
                       for o, n in zip(offsets, meta["local_shape"]))
        out[slices] = value
        covered[slices] = True
    return out, covered
