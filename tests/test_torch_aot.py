"""The port's engine cache and rank contract
(``dcos_commons_tpu_torch/parallel/aot.py``, ``parallel/distributed.py``)
against the JAX package's: the same keys for the same configs, the same
hits, misses and namespaces (and the same metrics counters) for the same
call sequence, ``AOT_CACHE=0``, the persistent kernel-library directory,
and the same contract for the same environments; plus the compile cache
as ``PagedServer`` uses it."""

import dataclasses
import os

import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu import metrics as jmetrics
from dcos_commons_tpu.parallel import aot as jaot
from dcos_commons_tpu.parallel import distributed as jdist
from dcos_commons_tpu_torch import metrics as tmetrics
from dcos_commons_tpu_torch.kernels import build
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.ops.sampling import make_sampler
from dcos_commons_tpu_torch.parallel import aot, distributed


@dataclasses.dataclass(frozen=True)
class _Cfg:
    dim: int = 64
    layers: int = 2
    name: str = "tiny"


@pytest.mark.parametrize("cfg", [
    {"dim": 64, "vocab": 256}, {"b": [1, 2], "a": "x"}, _Cfg(),
    _Cfg(dim=128), "a repr-only config"])
def test_config_key_matches_the_reference(cfg):
    assert aot.config_key(cfg) == jaot.config_key(cfg)


GEOMETRY = dict(kind="paged", slots=8, pages=64, page_size=16,
                prefill_chunk=8)


def test_engine_key_is_stable_and_changes_with_every_field():
    cfg = tl.LlamaConfig.tiny()
    cpu = torch.device("cpu")
    key = aot.engine_key(cfg, None, device=cpu, **GEOMETRY)
    assert key == aot.engine_key(cfg, None, device=cpu, **dict(GEOMETRY))
    assert len(key) == 32
    keys = {key}
    for field, other in [("kind", "slots"), ("slots", 4), ("pages", 65),
                         ("page_size", 32), ("prefill_chunk", 16)]:
        keys.add(aot.engine_key(cfg, None, device=cpu,
                                **dict(GEOMETRY, **{field: other})))
    keys.add(aot.engine_key(tl.LlamaConfig.tiny(max_seq=64), None,
                            device=cpu, **GEOMETRY))
    keys.add(aot.engine_key(tl.LlamaConfig.tiny(kv_quant=True), None,
                            device=cpu, **GEOMETRY))
    assert len(keys) == 8


def test_topology_key():
    assert aot.topology_key(None, torch.device("cpu")) == "cpu:1"
    with pytest.raises(NotImplementedError, match="item 7"):
        aot.topology_key(mesh=object())


def test_compile_cache_counts_as_the_reference():
    """One call sequence through both caches: the same hits, misses,
    namespace count and identity, and the same metrics counters."""
    tm, jm = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    tc, jc = aot.CompileCache(metrics=tm), jaot.CompileCache(metrics=jm)
    seq = ["a", "b", "a", "a", "c", "b"]
    t_spaces = [tc.namespace(k) for k in seq]
    j_spaces = [jc.namespace(k) for k in seq]
    assert tc.stats() == jc.stats() == {"namespaces": 3, "hits": 3,
                                        "misses": 3}
    assert [id(s) for s in t_spaces].count(id(t_spaces[0])) == \
        [id(s) for s in j_spaces].count(id(j_spaces[0])) == 3
    counters = {k: v for k, v in tm.to_dict()["counters"].items()
                if k.startswith("aot.")}
    assert counters == {k: v for k, v in jm.to_dict()["counters"].items()
                        if k.startswith("aot.")}
    assert counters == {"aot.cache_hits": 3, "aot.cache_misses": 3}
    plain = aot.CompileCache()
    plain.namespace("x")
    assert plain.stats() == {"namespaces": 1, "hits": 0, "misses": 1}


def test_from_env_and_the_persistent_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(aot, "_shared", None)
    for off in ("0", "false", "no"):
        monkeypatch.setenv("AOT_CACHE", off)
        assert aot.from_env() is None
    monkeypatch.delenv("AOT_CACHE")
    monkeypatch.delenv("AOT_CACHE_DIR", raising=False)
    before = build.BUILD_DIR
    shared = aot.from_env()
    assert shared is aot.from_env() is aot.shared_cache()
    assert build.BUILD_DIR == before
    monkeypatch.setenv("AOT_CACHE_DIR", str(tmp_path / "libs"))
    assert aot.from_env() is shared
    assert build.BUILD_DIR == tmp_path / "libs"
    assert (tmp_path / "libs").is_dir()
    assert build.library_path("flash_decode_paged").parent == \
        tmp_path / "libs"


def test_arm_persistent_cache_refuses_an_unwritable_directory(
        tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    before = build.BUILD_DIR
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    assert aot.arm_persistent_cache(str(blocker / "sub")) is False
    assert jaot.arm_persistent_cache(str(blocker / "sub")) is False
    assert build.BUILD_DIR == before
    if os.geteuid() != 0:
        ro = tmp_path / "ro"
        ro.mkdir()
        ro.chmod(0o500)
        assert aot.arm_persistent_cache(str(ro)) is False
        assert build.BUILD_DIR == before
    assert aot.arm_persistent_cache(str(tmp_path / "ok")) is True
    assert build.BUILD_DIR == tmp_path / "ok"


ENVIRONS = [
    {},
    {"JAX_NUM_PROCESSES": "1"},
    {"JAX_COORDINATOR_ADDRESS": "pod-0:8476", "JAX_PROCESS_ID": "0",
     "JAX_NUM_PROCESSES": "1", "TPU_SLICE_TOPOLOGY": "2x2"},
    {"JAX_COORDINATOR_ADDRESS": "pod-0:8476"},
    {"JAX_COORDINATOR_ADDRESS": "pod-0:8476", "JAX_PROCESS_ID": "1",
     "JAX_NUM_PROCESSES": "2"},
]


@pytest.mark.parametrize("environ", ENVIRONS)
def test_env_contract_matches_the_reference(environ):
    assert distributed.env_contract(environ) == jdist.env_contract(environ)


@pytest.mark.parametrize("environ", ENVIRONS[:4])
def test_initialize_single_process_matches_the_reference(environ):
    assert distributed.initialize(environ) == jdist.initialize(environ)


def test_initialize_refuses_a_gang():
    with pytest.raises(NotImplementedError, match="item 7"):
        distributed.initialize(ENVIRONS[4])
    env = {"JAX_NUM_PROCESSES": "2"}
    with pytest.raises(RuntimeError, match="JAX_COORDINATOR_ADDRESS"):
        distributed.initialize(env)
    with pytest.raises(RuntimeError, match="JAX_COORDINATOR_ADDRESS"):
        jdist.initialize(env)


def _tiny():
    cfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def test_paged_servers_share_a_namespace_by_key():
    """Greedy engines of one key share the rope table through one
    namespace; another geometry misses; a sampled engine bypasses the
    cache, as in the reference."""
    cfg, params = _tiny()
    cache = aot.CompileCache()
    kw = dict(slots=2, page_size=16, prefill_chunk=8, device="cpu",
              compile_cache=cache)
    a = ts.PagedServer(cfg, params, **kw)
    b = ts.PagedServer(cfg, params, **kw)
    assert cache.stats() == {"namespaces": 1, "hits": 1, "misses": 1}
    assert b._rope is a._rope
    c = ts.PagedServer(cfg, params, **dict(kw, page_size=32))
    assert cache.stats()["misses"] == 2 and c._rope is not a._rope
    ts.PagedServer(cfg, params, sampler=make_sampler(0.8), **kw)
    assert cache.stats() == {"namespaces": 2, "hits": 1, "misses": 2}
    reqs = [{"prompt": [1, 2, 3], "max_new": 4, "request_id": 0}]
    assert b.drain(reqs) == ts.PagedServer(
        cfg, params, slots=2, page_size=16, prefill_chunk=8,
        device="cpu").drain(reqs)
