"""Ring prefill in the port against the reference: ``llama.prefill_ring``
and ``PagedServer(longctx_ring=)`` on gloo gangs on the CPU
(``parallel.distributed.launch_local``; a gang of 2 and one of 4, each
started once for this module, run ``tests/_torch_ring_ranks.battery`` on
``MeshSpec(sp=world)``), held to ONE JAX process running the reference
on ``MeshSpec(sp=world)`` over as many virtual CPU devices:

* ``prefill_ring`` in fp32 (2 layers of the tiny config, max_seq 64) on
  a [2, 64] prompt, which pads nothing and fills max_seq exactly, and on
  a [1, 40] one: each rank's hidden states and ks/vs are its contiguous
  shard of the reference's within ``PREFILL_TOL``. sp=4 is the case that
  shows the ring's direction (at sp=2 a hop either way reaches the same
  rank);
* the engine on the reference test's case (max_seq 64, page 16, chunk
  8; prompts (60, 4), (33, 6), (7, 5)) and on a case whose prompts pad
  to pages past their last (page 3 at sp=2, 6 at sp=4, max_seq 72):
  every rank's streams token-equal to the reference's ring engine and
  to its solo decode, the reference's counters (two ring prefills, 93
  tokens on the reference's case), no fallback, no ledger violation,
  every rank's pool bitwise equal and within ``POOL_TOL`` of the
  reference engine's (the scratch page aside), and no collective in a
  decode window;
* a padded length over max_seq falls back to chunks on every rank
  alike, with no collective and the same tokens; a radix-resumed stream
  stays on chunks;
* the constructor's refusals, ``page_stats()["longctx"]`` with the
  reference's keys, ``prefill_ring``'s ``ValueError``s, the mesh
  refusals naming the sp axis, and a ring failure that the gang driver
  lets through;
* two worker processes serve ``--prefill-seq-parallel true`` as an sp
  gang: a long prompt rides the ring, the replies are those of the
  port's ring engine built directly, and the heartbeat carries
  ``pages.longctx``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models import serving_gang as tgang
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from dcos_commons_tpu_torch.parallel.mesh import Mesh
from dcos_commons_tpu_torch.parallel.moe import MoEConfig
from tests import _torch_ring_ranks
from tests.test_torch_serving_gang import _Gang, _post

PREFILL_TOL = 2e-5          # fp32, largest |port - reference|
POOL_TOL = 2e-5
WORLDS = (2, 4)
CFGS = {"m64": dict(n_layers=2, max_seq=64), "m72": dict(n_layers=2,
                                                        max_seq=72)}
PREFILLS = {"full": ((2, 64), 5), "short": ((1, 40), 6)}
# engine case -> (config, page size, chunk, [(prompt, max_new)], seed)
ENGINES = {"reference": ("m64", 16, 8, [(60, 4), (33, 6), (7, 5)], 170),
           "pad_pages": ("m72", None, 6, [(25, 5), (50, 4), (7, 5)], 180)}
PAD_PAGE = {2: 3, 4: 6}     # page sizes sp does not divide


def _prompt(seed, n, vocab=256):
    return [int(t) for t in jax.random.randint(jax.random.key(seed), (n,),
                                               0, vocab)]


def _jcfg(name):
    return jl.LlamaConfig.tiny(attn_impl="dense", dtype=jnp.float32,
                               **CFGS[name])


def _tcfg(name):
    return dict(attn_impl="dense", dtype=torch.float32, **CFGS[name])


@functools.lru_cache(maxsize=None)
def _jparams(name):
    return jax.device_get(jl.init_params(_jcfg(name), jax.random.key(0)))


def _jmesh(world):
    return JMeshSpec(sp=world).build(jax.devices()[:world])


def _engine_case(name, world):
    cfg, ps, chunk, shapes, seed = ENGINES[name]
    return {"cfg": _tcfg(cfg), "params": cfg,
            "engine": dict(slots=2, page_size=ps or PAD_PAGE[world],
                           prefill_chunk=chunk),
            "reqs": [{"prompt": _prompt(seed + i, n), "max_new": m,
                      "request_id": i} for i, (n, m) in enumerate(shapes)]}


def _prefill_prompt(name):
    shape, seed = PREFILLS[name]
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _resumed_case():
    """Two 40-token prompts sharing their first 32 tokens (two full pages
    of 16): the second resumes at 32 from the radix."""
    base = _prompt(190, 40)
    case = _engine_case("reference", 2)
    case["reqs"] = [{"prompt": base, "max_new": 4, "request_id": "a"},
                    {"prompt": base[:32] + _prompt(191, 8), "max_new": 4,
                     "request_id": "b"}]
    return case


def _world(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    inputs = {
        "params": {name: params_from_jax(_jparams(name), "cpu")
                   for name in CFGS},
        "prefill": {name: {"cfg": _tcfg("m64"), "params": "m64",
                           "prompt": _prefill_prompt(name)}
                    for name in PREFILLS},
        "engine": {name: _engine_case(name, world) for name in ENGINES},
        "fallback": _engine_case("reference", world),
        "resumed": _resumed_case()}
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    return launch_local(_torch_ring_ranks.battery, world, path,
                        timeout_s=300, threads=1)


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return _world(4, tmp_path_factory)


def _ranks(request, world):
    return request.getfixturevalue(f"w{world}")


@functools.lru_cache(maxsize=None)
def _jax_prefill(name, world):
    cfg = _jcfg("m64")
    mesh = _jmesh(world)
    with mesh, jax.default_matmul_precision("highest"):
        hidden, ks, vs = jax.jit(
            lambda p, t: jl.prefill_ring(cfg, p, t, mesh))(
                _jparams("m64"), jnp.asarray(_prefill_prompt(name)))
    return np.asarray(hidden), np.asarray(ks), np.asarray(vs)


@functools.lru_cache(maxsize=None)
def _jax_engine(name, world):
    """The reference's ring engine on ``MeshSpec(sp=world)`` (its streams,
    ring counters and pool) and its solo decode of each prompt."""
    case = _engine_case(name, world)
    cfg, params = _jcfg(ENGINES[name][0]), _jparams(ENGINES[name][0])
    mesh = _jmesh(world)
    with jax.default_matmul_precision("highest"):
        with mesh:
            srv = js.PagedServer(cfg, params, mesh=mesh, longctx_ring=world,
                                 **case["engine"])
            got = srv.drain([dict(r) for r in case["reqs"]])
        solo = {r["request_id"]: [int(t) for t in jl.generate_stepwise(
            cfg, params, jnp.asarray([r["prompt"]], jnp.int32),
            r["max_new"])[0]] for r in case["reqs"]}
    return {"streams": got, "solo": solo,
            "longctx": srv.page_stats()["longctx"],
            "pool": {s: np.asarray(srv.pool[s]) for s in ("k", "v")}}


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"sp{w}")
@pytest.mark.parametrize("name", list(PREFILLS))
def test_prefill_ring_matches_jax(request, world, name):
    hidden, ks, vs = _jax_prefill(name, world)
    s = hidden.shape[1] // world
    for r in _ranks(request, world):
        got = r["prefill"][name]
        at = slice(r["rank"] * s, (r["rank"] + 1) * s)
        assert got["hidden"].shape == hidden[:, at].shape
        assert np.abs(got["hidden"] - hidden[:, at]).max() < PREFILL_TOL
        assert np.abs(got["ks"] - ks[:, :, at]).max() < PREFILL_TOL
        assert np.abs(got["vs"] - vs[:, :, at]).max() < PREFILL_TOL


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"sp{w}")
@pytest.mark.parametrize("name", list(ENGINES))
def test_ring_engine_matches_the_reference_ring_engine(request, world,
                                                      name):
    want = _jax_engine(name, world)
    ranks = _ranks(request, world)
    assert want["streams"] == want["solo"]
    for r in ranks:
        got = r["engine"][name]
        assert got["streams"] == want["streams"]
        assert got["longctx"]["ring_prefills"] == 2
        assert got["longctx"]["fallbacks"] == 0
        for key in ("ring", "threshold", "ring_prefills",
                    "ring_prefilled_tokens", "fallbacks"):
            assert got["longctx"][key] == want["longctx"][key], key
        assert got["violations"] == [] and got["sp"] == world
        assert got["graphs_off"] is None
        assert got["window_collectives"] == 0 and got["windows"] > 0
        assert got["digest"] == ranks[0]["engine"][name]["digest"]
        for side in ("k", "v"):
            err = np.abs(got["pool"][side][:, :-1]
                         - want["pool"][side][:, :-1]).max()
            assert err < POOL_TOL, (side, err)
    if name == "reference":
        assert ranks[0]["engine"][name]["longctx"][
            "ring_prefilled_tokens"] == 93


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"sp{w}")
def test_padded_length_over_max_seq_falls_back_alike(request, world):
    want = _jax_engine("reference", world)["solo"]
    for r in _ranks(request, world):
        got = r["fallback"]
        assert got["streams"] == want
        assert got["longctx"]["ring_prefills"] == 0
        assert got["longctx"]["fallbacks"] == 2
        assert got["collectives"] == 0 and got["violations"] == []


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"sp{w}")
def test_radix_resumed_stream_stays_on_chunks(request, world):
    ranks = _ranks(request, world)
    cfg, params = _jcfg("m64"), _jparams("m64")
    for r in ranks:
        got = r["resumed"]
        assert got["prefix_hits"] == 1
        assert got["longctx"]["ring_prefills"] == 1
        assert got["longctx"]["ring_prefilled_tokens"] == 40
        assert got["longctx"]["fallbacks"] == 0
        assert got["violations"] == []
        assert got["digest"] == ranks[0]["resumed"]["digest"]
    with jax.default_matmul_precision("highest"):
        for req in _resumed_case()["reqs"]:
            solo = [int(t) for t in jl.generate_stepwise(
                cfg, params, jnp.asarray([req["prompt"]], jnp.int32),
                req["max_new"])[0]]
            assert ranks[0]["resumed"]["streams"][req["request_id"]] == solo


# ---------------------------------------------------------------------------
# refusals, on mesh objects of no process group: each raises before any
# collective


def _rank_mesh(**axes):
    shape = {"dp": 1, "pp": 1, "sp": 1, "tp": 1, "ep": 1, **axes}
    return Mesh(shape, {a: 0 for a in shape}, torch.device("cpu"), "gloo",
                rank=0)


def _tiny(**kw):
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64, **kw)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(longctx_ring=2), "'sp' axis"),
    (dict(longctx_ring=4, mesh=_rank_mesh(sp=2)), "'sp' axis"),
    (dict(longctx_ring=2, mesh=_rank_mesh(sp=2, tp=2)), "tp=2"),
], ids=["no_mesh", "sp_mismatch", "tp"])
def test_constructor_refuses_a_ring_without_its_axis(kw, match):
    cfg, params = _tiny()
    with pytest.raises(ValueError, match=match):
        ts.PagedServer(cfg, params, slots=2, page_size=16, device="cpu",
                       **kw)


def test_constructor_refuses_max_seq_the_ring_does_not_divide():
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=66)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="max_seq"):
        ts.PagedServer(cfg, params, slots=2, page_size=6, prefill_chunk=6,
                       device="cpu", mesh=_rank_mesh(sp=4), longctx_ring=4)


def test_constructor_refuses_kv_quant_and_moe_with_the_ring():
    cfg, params = _tiny(kv_quant=True)
    with pytest.raises(ValueError, match="kv_quant"):
        ts.PagedServer(cfg, params, slots=2, page_size=16, device="cpu",
                       mesh=_rank_mesh(sp=2), longctx_ring=2)
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64)
    routed = tl.init_moe_params(cfg, 4, torch.Generator().manual_seed(0),
                                "cpu")
    with pytest.raises(ValueError, match="moe="):
        ts.PagedServer(cfg, routed, slots=2, page_size=16, device="cpu",
                       mesh=_rank_mesh(sp=2), longctx_ring=2,
                       moe=MoEConfig(4))


def test_page_stats_longctx_has_the_reference_keys():
    cfg, params = _tiny()
    port = ts.PagedServer(cfg, params, slots=2, page_size=16,
                          prefill_chunk=8, device="cpu",
                          mesh=_rank_mesh(sp=2), longctx_ring=2)
    jcfg = jl.LlamaConfig.tiny(n_layers=1, max_seq=64)
    ref = js.PagedServer(jcfg, jl.init_params(jcfg, jax.random.key(0)),
                         slots=2, page_size=16, prefill_chunk=8)
    got, want = port.page_stats()["longctx"], ref.page_stats()["longctx"]
    assert set(got) == set(want)
    assert got == {"ring": 2, "threshold": 16, "ring_prefills": 0,
                   "ring_prefilled_tokens": 0, "ring_prefill_s": 0.0,
                   "fallbacks": 0}
    assert want["ring"] == 0 and want["threshold"] == 16
    assert ts.PagedServer(cfg, params, slots=2, page_size=16, device="cpu",
                          mesh=_rank_mesh(sp=2), longctx_ring=2,
                          ring_threshold=40).ring_threshold == 40


def test_prefill_ring_refusals():
    cfg, params = _tiny()
    prompt = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="'sp' mesh axis"):
        tl.prefill_ring(cfg, params, prompt, None)
    with pytest.raises(ValueError, match="% sp"):
        tl.prefill_ring(cfg, params, prompt[:, :63], _rank_mesh(sp=2))
    long_cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=32)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tl.prefill_ring(long_cfg, params, prompt, _rank_mesh(sp=2))


@pytest.mark.parametrize("what", ["tiers", "prefill_span", "arm_draft"])
def test_mesh_refusals_name_the_sp_axis(what):
    from dcos_commons_tpu_torch.models.paging import PageTierStore
    cfg, params = _tiny()

    def engine(**kw):
        return ts.PagedServer(cfg, params, slots=2, page_size=16,
                              device="cpu", mesh=_rank_mesh(sp=2),
                              longctx_ring=2, **kw)

    calls = {"tiers": lambda: engine(tiers=PageTierStore(host_pages=4)),
             "prefill_span": lambda: engine().prefill_span([1, 2, 3]),
             "arm_draft": lambda: engine().arm_draft(cfg, params)}
    with pytest.raises(ValueError, match="sp=2"):
        calls[what]()


class _FailingEngine:
    """An engine whose step fails as a ring prefill past its first
    collective does."""

    cfg = tl.LlamaConfig.tiny(max_seq=64)
    finished: dict = {}

    def free_slots(self):
        return [0]

    def submit_many(self, items):
        return [(0, items[0]["request_id"])] if items else []

    def requests_active(self):
        return True

    def step_many(self, k):
        raise ts.RingPrefillError("the ring broke after its first hop")


def test_gang_driver_lets_a_ring_failure_through():
    driver = tgang.GangServingDriver(_FailingEngine(), None,
                                     num_processes=1, process_id=1)
    with pytest.raises(ts.RingPrefillError):
        driver.run(max_iterations=3)
    assert driver.errors == 0


# ---------------------------------------------------------------------------
# the worker on a gang of two

RING_SERVE = ["--pages", "-1", "--max-seq", "256", "--page-size", "16",
              "--prefill-chunk", "8", "--prefill-seq-parallel", "true"]
WORKER_REQS = [(150, 6), (9, 5)]


def test_two_workers_serve_ring_prefill_as_an_sp_gang(tmp_path):
    rng = np.random.default_rng(43)
    reqs = [{"prompt": [int(t) for t in rng.integers(0, 256, n)],
             "max_new": m} for n, m in WORKER_REQS]
    path = str(tmp_path / "inputs.pt")
    torch.save({"max_seq": 256, "reqs": reqs,
                "engine": dict(slots=2, page_size=16, prefill_chunk=8)},
               path)
    want = launch_local(_torch_ring_ranks.serve_bf16, 2, path,
                        timeout_s=300, threads=1)[0]
    assert want["longctx"]["ring_prefills"] == 1
    gang = _Gang(tmp_path, RING_SERVE)
    try:
        port = gang.serving()
        paged = [e for r, e in gang.seen if e.get("event") == "serving"
                 and r == 0][0]["paged"]
        assert paged["sp"] == 2 and paged["tp"] == 1
        assert paged["graphs_off"] is None
        assert paged["longctx"]["ring"] == 2
        got = [_post(port, r)["tokens"] for r in reqs]
        assert got == want["replies"]
        for rank in (0, 1):
            _, beat = gang.wait(
                lambda r, e, rank=rank: r == rank
                and e.get("event") == "heartbeat"
                and e["pages"]["longctx"]["ring_prefills"] >= 1)
            assert beat["pages"]["longctx"]["fallbacks"] == 0
            assert beat["gang_errors"] == 0
        assert all(p.poll() is None for p in gang.procs)
    finally:
        gang.stop()
    assert not [e for _, e in gang.seen
                if e.get("event") == "longctx_fallback"]
