"""The port worker with expert and pipeline parallelism on a gang:
``llama-train --ep N`` and ``--pp N`` as the reference's
``_llama_train_moe`` / ``_llama_train_pipelined`` run them, and
``llama --serve --pages -1 --moe-experts E`` on a gang, as
``dist/moe.yml`` runs a replica of N chips.

* the mesh rule and report are the reference's: its ``run_llama_train``
  (the training loop after it replaced by one that hands back what it was
  given, and its weights' init by nothing, on as many of the virtual CPU
  devices as the gang has processes) reports the same ``mesh`` and
  ``attn`` for ``--ep 2``, ``--ep 4`` (dp=1 on 4 processes), ``--ep 3``
  on 2 (clamped to 2), ``--pp 2`` and ``--pp 2`` on 4 (dp=2 x pp=2);
* every rank reports one loss stream; a relaunch resumes every rank at
  one step and ends bitwise where a fresh run ends; each rank's step
  directory names the reference's shards (its expert bank or stage,
  every replicated leaf whole); the ``done`` keys are one process's and
  the gang report's;
* two worker processes serve the MoE model as an ep=2 gang, token-equal
  to the port's one-process engine on the same seeded init (dropless);
  the port's ep engine in fp32 is token-equal to the reference's
  ``PagedServer(moe=, mesh=MeshSpec(ep=2))``;
* a gang that does not divide the experts is refused with a code before
  the process group forms; the reference's path for it (``moe_note``,
  then ``MeshSpec(ep=1)`` built on the gang's devices) raises.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu.parallel import moe as jmoe
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from frameworks.jax import worker as jworker
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel import moe as tmoe
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_dp_ranks, _torch_ep_pp_ranks
from tests.test_torch_serving_gang import PROMPTS, _Gang, _post
from tests.test_torch_worker_tp_train import _done, _of

CPU = ["--device", "cpu"]
TRAIN = ["llama-train", "--seq", "16", "--fused-ce", "true"]
# run name -> (processes, argv)
RULES = {"ep2": (2, [*TRAIN, "--ep", "2"]),
         "ep3_on_2": (2, [*TRAIN, "--ep", "3"]),
         "pp2": (2, [*TRAIN, "--pp", "2"]),
         "ep4": (4, [*TRAIN, "--ep", "4", "--moe-routing",
                     "expert_choice"]),
         "dp2pp2": (4, [*TRAIN, "--pp", "2", "--ep", "2"])}
GANG_KEYS = {"dp", "collectives", "collective_s", "backend"}
MOE_SERVE = ["--pages", "-1", "--moe-experts", "4",
             "--moe-capacity-factor", "0"]


def _argv(name, steps=1):
    return [*RULES[name][1], *CPU, "--steps", str(steps)]


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    """``--ep 2`` and ``--pp 2`` each to 2 steps, resumed to 3, fresh to
    3; then one step of ``--ep 3`` on 2."""
    base = str(tmp_path_factory.mktemp("ep_pp_gang2"))
    runs = []
    for name in ("ep2", "pp2"):
        runs += [(name, _argv(name, 2), {}, []),
                 (name, _argv(name, 3), {}, []),
                 (f"{name}_fresh", _argv(name, 3), {}, [])]
    runs.append(("ep3_on_2", _argv("ep3_on_2"), {}, []))
    return base, launch_local(_torch_dp_ranks.worker_runs, 2, base, runs,
                              timeout_s=400, threads=1)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ep_pp_gang4"))
    runs = [(name, _argv(name), {}, []) for name in ("ep4", "dp2pp2")]
    return launch_local(_torch_dp_ranks.worker_runs, 4, base, runs,
                        timeout_s=400, threads=1)


def _port_run(name, gang2, gang4):
    """Each rank's ``(rc, events)`` of rule case ``name`` (the first run
    of a resumed pair)."""
    if RULES[name][0] == 4:
        return [r[("ep4", "dp2pp2").index(name)][:2] for r in gang4]
    at = {"ep2": 0, "pp2": 3, "ep3_on_2": 6}[name]
    return [r[at][:2] for r in gang2[1]]


@pytest.fixture(scope="module")
def reference_rule():
    """What the reference's ``run_llama_train`` hands its training loop
    for each rule case, on as many virtual devices as the case's gang
    has processes: ``{name: (mesh report, attn)}``. The rule reads no
    weights, so none are drawn."""
    got = {}
    real = (jax.devices, jax.device_count, jworker._llama_train_loop,
            jl.init_params, jl.init_moe_params, jl.stack_pipeline_params)

    def loop(args, contract, cfg, mesh, loss_fn, specs, params, toks,
             mesh_report, attn_name):
        return {"mesh": mesh_report, "attn": attn_name,
                "rows": int(toks.shape[0]), "n_layers": cfg.n_layers}

    try:
        jworker._llama_train_loop = loop
        jl.init_params = jl.init_moe_params = lambda *a, **kw: None
        jl.stack_pipeline_params = lambda *a, **kw: None
        for name, (n, argv) in RULES.items():
            jax.devices = lambda *a, n=n: real[0](*a)[:n]
            jax.device_count = lambda *a, n=n: n
            args = jworker.build_parser().parse_args(argv)
            got[name] = jworker.run_llama_train(args)
    finally:
        (jax.devices, jax.device_count, jworker._llama_train_loop,
         jl.init_params, jl.init_moe_params,
         jl.stack_pipeline_params) = real
    return got


@pytest.mark.parametrize("name", list(RULES))
def test_mesh_report_and_attention_are_the_reference_s(
        name, reference_rule, gang2, gang4):
    want = reference_rule[name]
    for rc, events in _port_run(name, gang2, gang4):
        assert rc == 0
        done = _done(events)
        assert done["mesh"] == want["mesh"], name
        assert done["attn"] == want["attn"] == "dense", name
        assert done["tokens_per_sec"] > 0
        axis = "ep" if "ep" in done["mesh"] else "pp"
        assert done[axis] == want["mesh"][axis] and done["dp"] * done[
            axis] == RULES[name][0]
    if name == "pp2":
        assert want["mesh"] == {"pp": 2, "microbatches": 2}
        assert (want["rows"], want["n_layers"]) == (4, 4)
    if name == "ep2":
        assert want["mesh"] == {"dp": 1, "ep": 2, "experts": 4,
                                "routing": "top2"}


def test_every_rank_reports_one_loss_stream(gang2, gang4):
    for name in RULES:
        dones = [_done(ev) for _, ev in _port_run(name, gang2, gang4)]
        assert [d["process_id"] for d in dones] == list(range(len(dones)))
        assert len({d["final_loss"] for d in dones}) == 1, name
        assert np.isfinite(dones[0]["final_loss"]), name
        assert dones[0]["backend"] == "gloo"


@pytest.mark.parametrize("name", ["ep2", "pp2"])
def test_a_relaunch_resumes_every_rank_at_one_step_bitwise(gang2, name):
    _, ranks = gang2
    at = {"ep2": 0, "pp2": 3}[name]
    for r, runs in enumerate(ranks):
        first, resumed, fresh = runs[at:at + 3]
        assert _of(first[1], "resumed") == []
        assert [e["step"] for e in _of(resumed[1], "resumed")] == [2]
        assert _done(resumed[1])["steps_run"] == 1
        assert _of(fresh[1], "resumed") == []
        assert _done(fresh[1])["steps_run"] == 3
        assert _done(resumed[1])["final_loss"] == _done(fresh[1])[
            "final_loss"]
        assert resumed[2] == [f"step-0000000{k}-p{r}" for k in (2, 3)]


@pytest.mark.parametrize("name", ["ep2", "pp2"])
def test_each_rank_writes_its_shards_under_the_reference_s_names(gang2,
                                                                 name):
    """Rank r writes its expert bank (``w_in``/``w_out`` at expert
    offset 2r) or its stage (every layer stack at stage r), and every
    replicated leaf whole, with the bytes the other rank wrote."""
    base, _ = gang2
    man = [json.loads(open(f"{base}/{name}_fresh/r{r}/step-00000003-p{r}/"
                           "manifest.json").read())["leaves"]
           for r in (0, 1)]
    assert set(man[0]) == set(man[1])
    for key in man[0]:
        s0, s1 = man[0][key]["shards"], man[1][key]["shards"]
        assert len(s0) == len(s1) == 1
        leaf = key.split(".")[-1]
        sharded = (leaf in ("w_in", "w_out") if name == "ep2"
                   else ".layers." in key)
        if not sharded:
            assert s0 == s1, key
            assert s0[0]["local_shape"] == man[0][key]["global_shape"]
            continue
        shape = man[0][key]["global_shape"]
        for r, shard in enumerate((s0[0], s1[0])):
            if name == "ep2":
                want = "o0_" + "_".join(["2" if r else "0"]
                                        + ["0"] * (len(shape) - 2))
                assert shard["local_shape"][1] * 2 == shape[1], key
            else:
                want = "o" + "_".join([str(r)] + ["0"] * (len(shape) - 1))
                assert shard["local_shape"][0] == 1 and shape[0] == 2, key
            assert shard["index"] == want, (key, shard["index"])


def test_done_keys_are_one_process_s_and_the_gang_report_s(gang2,
                                                           tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tworker.main([*TRAIN, *CPU, "--steps", "1", "--out",
                             str(tmp_path / "one")]) == 0
    want = _done([json.loads(line) for line in buf.getvalue().splitlines()
                  if line.startswith("{")])
    for runs in gang2[1]:
        for at, axis in ((2, "ep"), (5, "pp")):
            got = _done(runs[at][1])
            assert set(got) == set(want) | GANG_KEYS | {axis}


def _one_process_moe_replies():
    """The port's one-process MoE engine on the worker's seeded init, as
    ``--pages -1 --moe-experts 4 --moe-capacity-factor 0`` builds it."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_moe_params(cfg, 4, torch.Generator().manual_seed(0),
                                device="cpu")
    srv = ts.PagedServer(cfg, params, slots=2, moe=tmoe.dropless(
        tmoe.MoEConfig(4)), device="cpu")
    got = srv.drain([{"prompt": p, "max_new": 6, "request_id": i}
                     for i, p in enumerate(PROMPTS)], decode_window=4)
    return [got[i] for i in range(len(PROMPTS))]


def test_two_workers_serve_moe_as_an_ep_gang(tmp_path):
    gang = _Gang(tmp_path, MOE_SERVE)
    try:
        port = gang.serving()
        paged = [e for r, e in gang.seen if e.get("event") == "serving"
                 and r == 0][0]["paged"]
        assert paged["ep"] == 2 and paged["tp"] == 1
        assert paged["graphs_off"] == "ep"
        assert paged["moe"]["experts"] == 4
        got = [_post(port, {"prompt": p, "max_new": 6})["tokens"]
               for p in PROMPTS]
        assert got == _one_process_moe_replies()
        gang.wait(lambda r, e: r == 1 and e.get("event") == "heartbeat"
                  and e.get("gang_iterations", 0) > 0
                  and e["gang_errors"] == 0)
        assert all(p.poll() is None for p in gang.procs)
    finally:
        gang.stop()


ENGINE = dict(slots=2, page_size=16, prefill_chunk=8)
SERVE_REQS = [(8, 6), (5, 9), (17, 4)]


def test_ep_engine_matches_the_reference_ep_engine(tmp_path):
    """fp32, dropless, 4 experts over ep=2: the port's gang of two
    against the reference's engine on two virtual devices."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                               dtype=jnp.float32)
    jp = jax.device_get(jl.init_moe_params(jcfg, 4, jax.random.key(0)))
    rng = np.random.default_rng(41)
    reqs = [{"prompt": [int(t) for t in rng.integers(0, 256, n)],
             "max_new": m, "request_id": i}
            for i, (n, m) in enumerate(SERVE_REQS)]
    mesh = JMeshSpec(ep=2).build(jax.devices()[:2])
    with mesh:
        want = js.PagedServer(jcfg, jp, moe=jmoe.dropless(jmoe.MoEConfig(4)),
                              mesh=mesh, **ENGINE).drain(
            [dict(r) for r in reqs], decode_window=4)
    path = str(tmp_path / "inputs.pt")
    torch.save({"cfg": dict(n_layers=2, max_seq=64, dtype=torch.float32),
                "params": params_from_jax(jp, "cpu"), "experts": 4,
                "engine": ENGINE, "reqs": reqs, "window": 4}, path)
    for r in launch_local(_torch_ep_pp_ranks.ep_serving, 2, path,
                          timeout_s=300, threads=1):
        assert r["streams"] == want
        assert r["w_in"][1] == 2 and r["violations"] == []
        assert r["stats"]["ep"] == 2 and r["stats"]["graphs_off"] == "ep"


def test_experts_the_gang_does_not_divide_are_refused(tmp_path, capsys,
                                                      monkeypatch):
    """A coded refusal before the process group forms (the coordinator
    address is a closed port), where the reference's path fails at its
    mesh: its ``moe_note`` keeps ``MeshSpec(ep=1)``, which the gang's two
    devices do not fit."""
    monkeypatch.chdir(tmp_path)
    for k, v in {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1",
                 "JAX_PROCESS_ID": "0", "JAX_NUM_PROCESSES": "2"}.items():
        monkeypatch.setenv(k, v)
    rc = tworker.main(["llama", *CPU, "--serve", "--slots", "2",
                       "--pages", "-1", "--moe-experts", "3"])
    assert rc == 2
    events = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()]
    errors = _of(events, "error")
    assert len(errors) == 1 and errors[0]["code"] == "moe_ep_indivisible"
    import torch.distributed as dist
    assert not dist.is_initialized()
    # the reference, on two devices
    args = jworker.build_parser().parse_args(
        ["llama", "--serve", "--pages", "-1", "--moe-experts", "3"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        moe_cfg, ring, spec = jworker._serving_arithmetic(
            args, jl.LlamaConfig.tiny(), 2)
    assert moe_cfg.num_experts == 3 and ring == 0 and spec.ep == 1
    assert "moe_local_dispatch" in out.getvalue()
    with pytest.raises(ValueError):
        spec.build(jax.devices()[:2])
