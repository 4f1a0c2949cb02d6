"""The PyTorch port stands alone: ``dcos_commons_tpu_torch``,
``chip_smoke.py`` and the port's tools import neither JAX nor any module
of the JAX package (not even its jax-free ones), and ``chip_smoke.py`` refuses to report a
result where it cannot run."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "dcos_commons_tpu_torch"


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _run(code, cwd=ROOT, **kw):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=180, **kw)


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` fails, every module of
    the port and ``chip_smoke`` imports, and no module of the JAX package
    gets loaded."""
    mods = list(_modules()) + ["chip_smoke"]
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {str(ROOT)!r})
        for blocked in ("jax", "jaxlib", "dcos_commons_tpu"):
            sys.modules[blocked] = None
        for name in {mods!r}:
            importlib.import_module(name)
        leaked = sorted(m for m, v in sys.modules.items()
                        if v is not None and (m.split(".")[0] in
                            ("jax", "jaxlib", "dcos_commons_tpu")))
        print("LEAKED", leaked)
        print("IMPORTED", len({mods!r}))
    """)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout
    assert f"IMPORTED {len(mods)}" in out.stdout
    assert "dcos_commons_tpu_torch.models.serving" in mods
    assert "dcos_commons_tpu_torch.ops.flash_decode" in mods
    for name in ("ops.flash_attention", "ops.losses", "models.train",
                 "models.ingress", "metrics", "tracing", "utils.stats",
                 "parallel.aot", "parallel.distributed",
                 "frameworks.worker", "models.disagg", "models.resnet",
                 "models.mlp", "models.weights", "parallel.mesh",
                 "models.serving_gang", "parallel.ring_attention",
                 "parallel.ulysses", "parallel.pipeline", "parallel.moe"):
        assert f"dcos_commons_tpu_torch.{name}" in mods


def test_no_source_names_jax_or_the_jax_package():
    """Static check over every import statement, including imports
    inside functions (triton and the kernel build load lazily), of the
    port, ``chip_smoke.py``, the port's tools (``tools/torch_*.py``) and
    the rank functions its CPU gangs run (``tests/_torch_tp_ranks.py``,
    ``tests/_torch_dp_ranks.py``, ``tests/_torch_tp_train_ranks.py``,
    ``tests/_torch_ep_pp_ranks.py``, ``tests/_torch_ring_ranks.py``)."""
    offenders = []
    for path in (list(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                 + sorted((ROOT / "tools").glob("torch_*.py"))
                 + [ROOT / "tests" / "_torch_tp_ranks.py",
                    ROOT / "tests" / "_torch_dp_ranks.py",
                    ROOT / "tests" / "_torch_tp_train_ranks.py",
                    ROOT / "tests" / "_torch_ep_pp_ranks.py",
                    ROOT / "tests" / "_torch_ring_ranks.py"]):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "dcos_commons_tpu",
                                          "flax", "optax"):
                    offenders.append(f"{path.name}: {name}")
    assert offenders == []


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Copied into a directory without the rest of the repository, the
    script cannot build or run the port and must not claim success."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
