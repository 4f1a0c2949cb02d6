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
  matrix, ``o`` for a 0-d leaf);
* a shard file is the array's C-order bytes (bf16 through a ``uint16``
  view); the manifest names the dtype as numpy does (``bfloat16``,
  ``int8``, ``float32``) and carries each shard's length and blake2s
  digest, so a truncated or bit-flipped shard raises
  :class:`CheckpointCorrupt` at restore;
* commit: shards and manifest go into a dot-tmp directory, fsynced, then
  ``os.rename``; keep-prune drops this process's older steps.

One process: :func:`latest_step` and :func:`save_sharded` refuse a gang
of processes (``parallel.distributed``), which waits for tensor
parallelism (ROADMAP Queue 1 item 7). Restore reads shard files a
bounded window ahead (``workers``) and accepts another byte source
(``reader`` + ``manifest``). A checkpoint saved sharded over several
devices restores by assembling its shards on the host.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.quant import QTensor
from . import distributed

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
    """This process's index; a gang of processes raises (item 7)."""
    return distributed.initialize()["process_id"]


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


def _index_key(ndim: int) -> str:
    """The index key of a whole-array shard: start offsets, all 0."""
    return "o" + "_".join("0" for _ in range(ndim)) if ndim else "o"


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


def _leaf_entry(key: str, leaf: Any) -> Tuple[dict, str, bytes]:
    """(manifest entry, file name, bytes) of one leaf."""
    arr = _host_array(leaf)
    fname = f"{key}.{_index_key(arr.ndim)}.bin"
    raw = arr.tobytes()
    shard = {"file": fname, "index": _index_key(arr.ndim),
             "local_shape": list(arr.shape), "bytes": len(raw),
             "digest": hashlib.blake2s(raw).hexdigest()}
    return ({"global_shape": list(arr.shape),
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


def save_sharded(out_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write ``tree`` (a pytree of tensors) for ``step``; returns the
    committed directory. Older steps of this process beyond ``keep`` are
    pruned."""
    pid = _process_id()
    final = _step_dir(out_dir, step, pid)
    tmp = os.path.join(out_dir, f".step-{step:08d}-p{pid}.tmp")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves: Dict[str, dict] = {}
    for key, leaf in _flatten(tree):
        entry, fname, raw = _leaf_entry(key, leaf)
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        leaves[key] = entry

    manifest = {"step": step, "process": pid, "num_processes": 1,
                "leaves": leaves}
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
    """Newest committed step of this process (None when none)."""
    local = _local_steps(out_dir, _process_id())
    return max(local) if local else None


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
                    manifest: Optional[dict] = None) -> Any:
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
    directory as the byte source, every shard still verified."""
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
    # can read ahead
    order: List[str] = []
    seen = set()
    for key, leaf in flat:
        entry = manifest["leaves"].get(key)
        if entry is None:
            continue
        for meta in entry["shards"]:
            if meta["file"] not in seen:
                seen.add(meta["file"])
                if isinstance(leaf, torch.Tensor):
                    order.append(meta["file"])
    stream = _ShardStream(reader, order, _restore_workers(workers))

    def fetch(meta: dict) -> bytes:
        raw = stream.fetch(meta["file"])
        _verify_shard(meta, raw, source)
        return raw

    try:
        out = [_restore_leaf(key, leaf, manifest, step, fetch)
               for key, leaf in flat]
    finally:
        stream.close()
    return _unflatten(template, out)


def _restore_leaf(key: str, leaf: Any, manifest: dict, step,
                  fetch: Callable[[dict], bytes]) -> Any:
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
    if list(leaf.shape) != entry["global_shape"] \
            or _DTYPE_NAMES.get(leaf.dtype) != entry["dtype"]:
        raise ValueError(
            f"leaf {key!r}: template {tuple(leaf.shape)}/"
            f"{_DTYPE_NAMES.get(leaf.dtype, leaf.dtype)} vs checkpoint "
            f"{entry['global_shape']}/{entry['dtype']}: restore requires "
            "the same mesh/sharding/config")
    ikey = _index_key(leaf.dim())
    meta = {s["index"]: s for s in entry["shards"]}.get(ikey)
    if meta is not None and meta["local_shape"] == list(leaf.shape):
        value = np.frombuffer(fetch(meta), dtype=dtype).reshape(
            meta["local_shape"])
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
