"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes) under ``build/torch_kernels/`` at the repository root. The file
name carries a digest of the source and flags, so an edited source
rebuilds and an unchanged one is reused. :func:`build_all` starts one
``nvcc`` per source at once; :func:`load` builds a library on first use
and returns it with its C signatures set.

Only the machine with the card has ``nvcc``; nothing here runs when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signature: (restype, argtypes) per exported function
Signature = Tuple[object, Sequence[object]]

# the process loads each library once; ctypes keeps it mapped for life
_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path; its digest covers the source, every shared
    header of ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.blake2s(src + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the last build (ptxas register and
    shared-memory report included)."""
    return BUILD_DIR / f"{name}.log"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel (default: all of ``csrc/``) that has no
    library for its current source yet, one ``nvcc`` per source, all
    started together. Raises with the compiler's output if any fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = []
    for name, lib in out.items():
        if lib.is_file():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        text, _ = proc.communicate()
        log_path(name).write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)        # atomic: a reader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``restype``/``argtypes`` set from ``signatures``."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _LOADED[name] = lib
        return lib
