"""Tensor-parallel serving in the port against the JAX package's tp
mesh: gangs of 2 and 4 gloo ranks on the CPU (``parallel.distributed.
launch_local``, each world started once for this module) run
``tests/_torch_tp_ranks.battery`` on the weights the JAX tests use, and
every result is held to JAX's on ``MeshSpec(tp=2)`` over 2 of the 8
virtual CPU devices (the tp=4 gang to the same references):

* ``decode_step_slots``, ``decode_step_paged`` and
  ``prefill_chunk_paged`` on the same whole caches and pools: fp32
  logits within 1e-4 (two layers of fp32 matmuls, partial sums reduced
  in another order), the K/V each rank wrote equal to its heads of JAX's
  within the same tolerance (int8 payloads within one quantization
  step); ``generate`` and ``generate_chunked`` token for token;
* ``SlotServer(mesh=)`` and ``PagedServer(mesh=)`` streams token for token
  against JAX's engines on the same mesh, and for the fp32 set against
  JAX's solo decode there too (the twins of
  ``TestSlotServerTP`` and ``TestPagedServerTP``): fp32, bf16 (a
  tie-free request set, as ``test_bf16_drain_matches_jax`` uses), and
  int8 weights with int8 KV held against JAX's dense path;
* every rank's logits bitwise equal at every step, and the same streams;
* the gang checkpoint: each rank's ``step-XXXXXXXX-p{rank}`` holds the
  shards JAX's save of the same sharded tree holds, byte for byte,
  ``latest_step`` agrees on the newest step every rank holds, the
  restore is bitwise, and the worker's boot takes the same source on
  every rank when one rank's shard is corrupt;
* a second ``distributed.initialize`` returns the same contract.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dcos_commons_tpu_torch.models.bridge import (params_from_jax,
                                                  pool_from_jax)
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_tp_ranks

FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _reqs(seed, shape):
    return [{"prompt": _prompt(seed + i, n), "max_new": m, "request_id": i}
            for i, (n, m) in enumerate(shape)]


# name -> (dtype, kv_quant, int8 weights, requests, decode window)
VARIANTS = {
    "fp32": ("fp32", False, False,
             _reqs(90, [(8, 6), (5, 9), (12, 4), (20, 7)]), 4),
    "bf16": ("bf16", False, False,
             _reqs(200, [(8, 6), (17, 5), (3, 8)]), 2),
    "int8": ("fp32", True, True, _reqs(20, [(8, 5), (16, 7), (4, 3)]), 1),
}
ENGINES = {"slots": dict(slots=2),
           "paged": dict(slots=2, page_size=16, prefill_chunk=8)}


def _cfg_kw(dtype, kv_quant):
    return dict(n_layers=2, max_seq=64, kv_quant=kv_quant,
                dtype={"fp32": torch.float32,
                       "bf16": torch.bfloat16}[dtype])


def _jcfg(dtype, kv_quant):
    return jl.LlamaConfig.tiny(
        n_layers=2, max_seq=64, attn_impl="dense", kv_quant=kv_quant,
        dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype])


def _jparams(jcfg, int8):
    """JAX's weights (int8: quantized in one compiled call; both
    packages take these same weights)."""
    jp = jl.init_params(jcfg, jax.random.key(0))
    return jax.jit(jl.quantize_params)(jp) if int8 else jp


def _random_kv(jcfg, rows, length, seed):
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, rows, length, jcfg.n_kv_heads, jcfg.head_dim)
    sides = {s: jnp.asarray(rng.standard_normal(shape), jcfg.dtype)
             for s in ("k", "v")}
    if jcfg.kv_quant:
        sides = {s: jquant.quantize(x, axis=-1) for s, x in sides.items()}
    return sides


def _steps_inputs(jcfg):
    """Whole caches/pools and step arguments, JAX's and the port's."""
    cache = _random_kv(jcfg, 4, jcfg.max_seq, 1)
    pool = _random_kv(jcfg, 13, 8, 2)
    pool2 = _random_kv(jcfg, 13, 8, 3)
    host = dict(
        slots=dict(lengths=np.array([5, 17, 63, 0], np.int32),
                   tokens=np.array([3, 250, 17, 9], np.int32)),
        paged=dict(table=np.array([[0, 1, 2], [3, 4, 12], [5, 6, 7],
                                   [12, 12, 12]], np.int32),
                   lengths=np.array([17, 8, 23, 30], np.int32),
                   tokens=np.array([5, 200, 31, 7], np.int32)),
        chunk=dict(table=np.array([4, 9, 2, 11, 12, 12, 12, 12], np.int32),
                   tokens=np.array([[3, 9, 27, 81, 243, 1, 2, 3]],
                                   np.int32),
                   start=12, true_len=17, logit_index=4, scratch=12),
        generate=dict(prompt=np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]],
                                      np.int32), steps=7))
    port = {k: dict(v) for k, v in host.items()}
    port["slots"]["cache"] = pool_from_jax(jax.device_get(cache), "cpu")
    port["paged"]["pool"] = pool_from_jax(jax.device_get(pool), "cpu")
    port["chunk"]["pool"] = pool_from_jax(jax.device_get(pool2), "cpu")
    return host, port, {"slots": cache, "paged": pool, "chunk": pool2}


def _shard_kv(kv, mesh):
    spec = NamedSharding(mesh, P(None, None, None, "tp", None))

    def put(x):
        if isinstance(x, jquant.QTensor):
            return jquant.QTensor(jax.device_put(x.q, spec),
                                  jax.device_put(x.s, spec))
        return jax.device_put(x, spec)

    return {k: put(v) for k, v in kv.items()}


def _jax_steps(jcfg, sharded, mesh, host, kvs):
    """JAX's three steps, generate and generate_chunked on ``mesh``."""
    out = {}
    s = host["slots"]
    out["slots"] = jax.jit(lambda p, c, ln, tok: jl.decode_step_slots(
        jcfg, p, c, ln, tok, mesh=mesh))(
        sharded, _shard_kv(kvs["slots"], mesh), jnp.asarray(s["lengths"]),
        jnp.asarray(s["tokens"]))
    p = host["paged"]
    out["paged"] = jax.jit(lambda pr, pool, t, ln, tok: jl.decode_step_paged(
        jcfg, pr, pool, t, ln, tok, mesh=mesh))(
        sharded, _shard_kv(kvs["paged"], mesh), jnp.asarray(p["table"]),
        jnp.asarray(p["lengths"]), jnp.asarray(p["tokens"]))
    c = host["chunk"]
    out["chunk"] = jax.jit(lambda pr, pool, t, tok: jl.prefill_chunk_paged(
        jcfg, pr, pool, t, tok, jnp.int32(c["start"]),
        jnp.int32(c["true_len"]), jnp.int32(c["logit_index"]),
        c["scratch"], mesh=mesh))(
        sharded, _shard_kv(kvs["chunk"], mesh), jnp.asarray(c["table"]),
        jnp.asarray(c["tokens"]))
    g = host["generate"]
    prompt = jnp.asarray(g["prompt"])
    out["generate"] = np.asarray(jl.generate_stepwise(
        jcfg, sharded, prompt, g["steps"], mesh=mesh))
    out["generate_chunked"] = np.asarray(jl.generate_chunked(
        jcfg, sharded, prompt, g["steps"], chunk=4, mesh=mesh))
    return out


def _world(tp, variants, tmp_path_factory, ckpt=False, refs=None):
    """Run the battery on a gang of ``tp`` ranks and compute JAX's
    references on a tp mesh of as many virtual devices, or take ``refs``
    (a wider gang is held to the tp=2 mesh's: JAX's tp results are one
    model's whatever the mesh's width, which the reference's own tp tests
    hold, so its compiles are shared)."""
    mesh = JMeshSpec(tp=tp).build(jax.devices()[:tp])
    inputs = {"variants": {}}
    compute = refs is None
    refs = {} if compute else refs
    for name in variants:
        dtype, kv_quant, int8, reqs, window = VARIANTS[name]
        jcfg = _jcfg(dtype, kv_quant)
        jp = _jparams(jcfg, int8) if compute else refs[name]["jp"]
        var = inputs["variants"][name] = dict(
            cfg=_cfg_kw(dtype, kv_quant),
            params=params_from_jax(jax.device_get(jp), "cpu"),
            requests=reqs, engines=ENGINES, window=window)
        if name in ("fp32", "int8"):
            host, port, kvs = _steps_inputs(jcfg)
            var["steps"] = port
        if not compute:
            continue
        with mesh:
            sharded = jl.shard_params(jp, mesh, jcfg)
        ref = refs[name] = {"jp": jp, "sharded": sharded, "jcfg": jcfg}
        if name in ("fp32", "int8"):
            ref["steps"] = _jax_steps(jcfg, sharded, mesh, host, kvs)
        ref["slots"] = js.SlotServer(jcfg, sharded, slots=2,
                                     mesh=mesh).drain(
            [dict(r) for r in reqs], decode_window=window)
        ref["paged"] = js.PagedServer(jcfg, sharded, mesh=mesh,
                                      **ENGINES["paged"]).drain(
            [dict(r) for r in reqs], decode_window=window)
        if name == "fp32":
            ref["solo"] = {r["request_id"]: [
                int(t) for t in jl.generate_stepwise(
                    jcfg, sharded, jnp.asarray([r["prompt"]], jnp.int32),
                    r["max_new"], mesh=mesh)[0]] for r in reqs}
    tmp = tmp_path_factory.mktemp(f"tp{tp}")
    if ckpt:
        inputs["ckpt_dir"] = str(tmp / "ckpt")
        inputs["ckpt_variant"] = "fp32"
        jdir = jc.save_sharded(str(tmp / "jax"), 1, refs["fp32"]["sharded"])
        with open(os.path.join(jdir, "manifest.json"),
                  encoding="utf-8") as f:
            refs["ckpt_manifest"] = json.load(f)
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    ranks = launch_local(_torch_tp_ranks.battery, tp, path, timeout_s=400,
                         threads=1)
    return ranks, refs


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return _world(2, list(VARIANTS), tmp_path_factory, ckpt=True)


@pytest.fixture(scope="module")
def tp4(tp2, tmp_path_factory):
    return _world(4, ["fp32"], tmp_path_factory, refs=tp2[1])


@pytest.fixture(params=["tp2", "tp4"])
def world(request):
    return request.param, request.getfixturevalue(request.param)


def _heads(a, tp, r):
    n = a.shape[3] // tp
    return a[:, :, :, r * n:(r + 1) * n]


def _kv_close(got, want, tp, r):
    for side in ("k", "v"):
        w = want[side]
        if isinstance(w, jquant.QTensor):
            q, s = got[side]
            wq = _heads(np.asarray(w.q), tp, r).astype(int)
            assert np.abs(q.astype(int) - wq).max() <= 1
            np.testing.assert_allclose(
                s, _heads(np.asarray(w.s, np.float32), tp, r),
                rtol=2e-2, atol=1e-6)
        else:
            np.testing.assert_allclose(
                got[side], _heads(np.asarray(w, np.float32), tp, r),
                **FP32_TOL)


@pytest.mark.parametrize("step", ["slots", "paged", "chunk"])
@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_decode_steps_match_jax_on_the_same_mesh(tp2, step, variant):
    ranks, refs = tp2
    jlog, jkv = refs[variant]["steps"][step]
    for r, res in enumerate(ranks):
        logits, kv = res["variants"][variant]["step_" + step]
        np.testing.assert_allclose(logits, np.asarray(jlog), **FP32_TOL)
        _kv_close(kv, jkv, 2, r)


@pytest.mark.parametrize("step", ["slots", "paged", "chunk"])
def test_decode_steps_match_jax_at_tp4(tp4, step):
    ranks, refs = tp4
    jlog, jkv = refs["fp32"]["steps"][step]
    for r, res in enumerate(ranks):
        logits, kv = res["variants"]["fp32"]["step_" + step]
        np.testing.assert_allclose(logits, np.asarray(jlog), **FP32_TOL)
        _kv_close(kv, jkv, 4, r)


@pytest.mark.parametrize("fn", ["generate", "generate_chunked"])
def test_generate_matches_jax_token_for_token(world, fn):
    _, (ranks, refs) = world
    for res in ranks:
        for variant in ("fp32", "int8"):
            if variant in res["variants"]:
                np.testing.assert_array_equal(
                    res["variants"][variant][fn],
                    refs[variant]["steps"][fn])


@pytest.mark.parametrize("engine", ["slots", "paged"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_streams_match_jax_tp_engines(tp2, engine, variant):
    """Token for token against JAX's engine and solo decode on the same
    tp=2 mesh (int8: weights and KV, against JAX's dense path)."""
    ranks, refs = tp2
    for res in ranks:
        got = res["variants"][variant][engine]
        assert got["streams"] == refs[variant][engine]
        if "solo" in refs[variant]:
            assert got["streams"] == refs[variant]["solo"]
        assert got["graphs"] == "tp"
        if engine == "paged":
            assert got["ledger"] == [] and got["tp"] == 2


@pytest.mark.parametrize("engine", ["slots", "paged"])
def test_engine_streams_match_jax_at_tp4(tp4, engine):
    ranks, refs = tp4
    for res in ranks:
        assert res["variants"]["fp32"][engine]["streams"] == \
            refs["fp32"][engine]


def test_every_rank_holds_the_same_logits_at_every_step(world):
    """Bitwise: the step logits, the engines' per-step logits (digests)
    and the streams, on every rank."""
    _, (ranks, _) = world
    head = ranks[0]["variants"]
    for res in ranks[1:]:
        for name, var in res["variants"].items():
            for key, value in var.items():
                want = head[name][key]
                if key in ("slots", "paged") and "digests" in value:
                    assert value["digests"] == want["digests"]
                    assert len(value["digests"]) > 0
                    assert value["streams"] == want["streams"]
                elif key in ("generate", "generate_chunked"):
                    np.testing.assert_array_equal(value, want)
                else:
                    assert np.array_equal(value[0], want[0]), (name, key)


def test_gang_backend_and_contract(world):
    tp, (ranks, _) = world
    assert [res["rank"] for res in ranks] == list(range(int(tp[2:])))
    for r, res in enumerate(ranks):
        assert res["backend"] == "gloo"
        assert res["contract"]["process_id"] == r
        assert res["contract"]["num_processes"] == int(tp[2:])


def test_gang_checkpoint_layout_agreement_and_restore(tp2):
    """Each rank's directory holds the shards of JAX's single-process
    save of the same tp=2 tree (same files, indices, shapes, digests);
    the gang agrees on step 1 (rank 0 alone saved step 2); restores are
    bitwise."""
    ranks, refs = tp2
    want = refs["ckpt_manifest"]["leaves"]
    union = {}
    for r, res in enumerate(ranks):
        ck = res["ckpt"]
        assert ck["latest"] == 1 and ck["bitwise"]
        man = json.loads(ck["manifest"])
        assert man["process"] == r and man["num_processes"] == 2
        for key, entry in man["leaves"].items():
            assert entry["global_shape"] == want[key]["global_shape"]
            assert entry["dtype"] == want[key]["dtype"]
            assert len(entry["shards"]) == 1
            union.setdefault(key, {})[entry["shards"][0]["index"]] = \
                entry["shards"][0]
    assert set(union) == set(want)
    for key, entry in want.items():
        assert union[key] == {s["index"]: s for s in entry["shards"]}, key


def test_gang_boot_agrees_on_its_weights(tp2):
    """The worker's boot from the gang checkpoint: every rank restores;
    with one shard of the last rank truncated, that rank cannot, and
    every rank falls back to the init, so the gang never serves two
    weight sets."""
    ranks, _ = tp2
    for res in ranks:
        boot = res["ckpt"]["boot"]
        assert boot["whole"] == {"source": "disk", "events": []}
        assert boot["one_rank_corrupt"] == {
            "source": "init", "events": ["weight_restore_fallback"]}
