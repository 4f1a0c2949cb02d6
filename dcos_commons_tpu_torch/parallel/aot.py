"""Engine reuse for homogeneous scale-up (port of
``dcos_commons_tpu/parallel/aot.py``).

:func:`engine_key` digests a model config, the device topology and the
engine's geometry, as the reference keys its compile cache.
:class:`CompileCache` is a process-wide registry of namespaces under such
keys, with the reference's counters (``aot.cache_hits``,
``aot.cache_misses``); :func:`shared_cache` is its process singleton and
:func:`from_env` the boot-path wiring (``AOT_CACHE=0`` turns it off,
``AOT_CACHE_DIR`` arms :func:`arm_persistent_cache`).

What a namespace holds differs from the reference. There, engines of one
key share jit wrappers, and so the compiled executables. The port's
counterpart of an executable is a CUDA graph of a decode window, and a
graph binds the buffers of the engine that captured it (its cache or
pool, its lengths, tokens, mask and table): a second engine can never
replay the first engine's graphs. So a namespace holds only what engines
of one key can share without pointers into engine state, the rope table;
each engine captures its own graphs (``PagedServer.warmup``). The kernel
libraries are shared per process already: ``kernels.build`` loads each
once.

The only compile product that outlives a process is an nvcc-built kernel
library, named by the digest of its source and flags. So the
cross-process form, :func:`arm_persistent_cache`, points the build
directory at a directory that survives restarts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..metrics import MetricsRegistry


def config_key(cfg: Any) -> str:
    """Stable digest of a model config (dataclass or mapping)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        fields = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        fields = cfg
    else:
        fields = {"repr": repr(cfg)}
    blob = ";".join(f"{k}={fields[k]!r}" for k in sorted(fields))
    return hashlib.blake2s(blob.encode(), digest_size=8).hexdigest()


def topology_key(mesh: Any = None,
                 device: Optional[torch.device] = None) -> str:
    """The device topology an engine runs on: ``"cuda:<device name>:
    <count>"``, or ``"cpu:1"`` when the engine's device is the CPU (or
    there is no CUDA). Under a process mesh (``parallel.mesh.Mesh``) the
    mesh's axis sizes and collective backend come first, so engines of
    different layouts never share an entry."""
    if (device is not None and torch.device(device).type == "cpu") \
            or not torch.cuda.is_available():
        devices = "cpu:1"
    else:
        devices = (f"cuda:{torch.cuda.get_device_name(device)}:"
                   f"{torch.cuda.device_count()}")
    if mesh is None:
        return devices
    axes = ",".join(f"{n}={s}" for n, s in mesh.shape.items())
    return f"mesh[{axes}]:{mesh.backend}:{devices}"


def engine_key(cfg: Any, mesh: Any = None,
               device: Optional[torch.device] = None, **extra: Any) -> str:
    """Cache key for one engine shape: (config, topology) plus whatever
    geometry the engine's windows close over (page count, page size,
    ...) passed as ``extra``."""
    parts = [config_key(cfg), topology_key(mesh, device)]
    parts += [f"{k}={extra[k]!r}" for k in sorted(extra)]
    return hashlib.blake2s("|".join(parts).encode(),
                           digest_size=16).hexdigest()


class CompileCache:
    """Process-wide registry of shared namespaces.

    ``namespace(key)`` returns the same dict for the same key, so a
    second engine built at an identical (config, topology, geometry)
    finds what the first one left there. Thread-safe; the counters make
    reuse receipted."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._spaces: Dict[str, Dict[str, Any]] = {}
        self.metrics = metrics
        self.hits = 0
        self.misses = 0

    def namespace(self, key: str) -> Dict[str, Any]:
        with self._lock:
            ns = self._spaces.get(key)
            if ns is None:
                ns = self._spaces[key] = {}
                self.misses += 1
                if self.metrics is not None:
                    self.metrics.counter("aot.cache_misses")
            else:
                self.hits += 1
                if self.metrics is not None:
                    self.metrics.counter("aot.cache_hits")
            return ns

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"namespaces": len(self._spaces),
                    "hits": self.hits, "misses": self.misses}


def arm_persistent_cache(cache_dir: str) -> bool:
    """Build and load the kernel libraries under ``cache_dir``, so a
    restarted process reuses what an earlier one compiled (a library's
    name carries its source digest). Best-effort: a directory that
    cannot be created or written returns False and changes nothing."""
    from ..kernels import build
    try:
        os.makedirs(cache_dir, exist_ok=True)
        probe = Path(cache_dir) / f".probe-{os.getpid()}"
        probe.write_bytes(b"")
        probe.unlink()
    except OSError:
        return False
    build.BUILD_DIR = Path(cache_dir)
    return True


_shared: Optional[CompileCache] = None
_shared_lock = threading.Lock()


def shared_cache(metrics: Optional[MetricsRegistry] = None) -> CompileCache:
    """The process singleton: every engine in one worker process wants
    the same registry."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = CompileCache(metrics=metrics)
        return _shared


def from_env(metrics: Optional[MetricsRegistry] = None
             ) -> Optional[CompileCache]:
    """Boot-path wiring: ``AOT_CACHE=0`` disables sharing entirely;
    ``AOT_CACHE_DIR`` additionally arms the persistent kernel-library
    directory. Returns the shared cache (or None when off)."""
    if os.environ.get("AOT_CACHE", "1") in ("0", "false", "no"):
        return None
    cache_dir = os.environ.get("AOT_CACHE_DIR", "")
    if cache_dir:
        arm_persistent_cache(cache_dir)
    return shared_cache(metrics=metrics)
