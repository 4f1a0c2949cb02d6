"""The port worker's ``llama-train`` with sequence parallelism on a gang,
as ``dist/longctx.yml``'s ``worker`` pods run it: ``launch_local`` starts
the processes with the scheduler's ``JAX_*`` rank contract, and each runs
``worker.main`` in turn (``tests/_torch_dp_ranks.worker_runs``) with its
own volume.

* the mesh rule and report are the reference's: its ``run_llama_train``
  (the training loop after it replaced by one that hands back what it was
  given, and its weights' init and sharding by nothing, on as many of the
  virtual CPU devices as the gang has processes) reports the same
  ``mesh`` and ``attn`` for the deployed
  defaults (``--attn ring --sp 0 --tp 0``: sp=2 on 2 processes),
  ``--attn auto`` (the ring when sp > 1), ``flash``, the zigzag layout
  and its degrade (``--seq`` not divisible by ``2 sp``, or Ulysses), and
  ``--sp 2 --tp 2`` and dp=2 x sp=2 on 4 processes;
* every rank reports one loss stream; a relaunch resumes every rank at
  one step and ends bitwise where a fresh run ends; each rank's step
  directory holds the whole (replicated) leaves;
* the gang's ``done`` keys are the one-process result's (held to the
  reference's by ``tests/test_torch_worker_train_cross.py``) and the
  gang report's;
* the deployed defaults train on the gang within 1e-3 of one process
  (bf16: the ring and the one-rank ring round in another order).
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from frameworks.jax import worker as jworker
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_dp_ranks
from tests.test_torch_worker_tp_train import _done, _of

CPU = ["--device", "cpu"]
# dist/longctx.yml's worker command at the universe's defaults, but --seq
LONGCTX = ["llama-train", "--attn", "ring", "--ring-layout", "contiguous",
           "--sp", "0", "--tp", "0", "--fused-ce", "true", "--grad-accum",
           "1", "--ckpt-every", "1", "--seq", "16", *CPU]
# run name -> (processes, argv of the rule's cases)
RULES = {"longctx": (2, [*LONGCTX, "--steps", "2"]),
         "auto": (2, ["llama-train", "--attn", "auto", "--seq", "16"]),
         "flash": (2, ["llama-train", "--attn", "flash", "--seq", "16"]),
         "zigzag": (2, ["llama-train", "--ring-layout", "zigzag", "--seq",
                        "16"]),
         "zigzag_odd_seq": (2, ["llama-train", "--attn", "ring",
                                "--ring-layout", "zigzag", "--seq", "18"]),
         "zigzag_ulysses": (2, ["llama-train", "--attn", "ulysses",
                                "--ring-layout", "zigzag", "--seq", "16"]),
         "sp2tp2": (4, ["llama-train", "--sp", "2", "--tp", "2", "--seq",
                        "16"]),
         "dp2sp2": (4, ["llama-train", "--sp", "2", "--tp", "1", "--seq",
                        "16"])}
GANG_KEYS = {"dp", "sp", "tp", "collectives", "collective_s", "backend"}


def _argv(name):
    argv = RULES[name][1]
    argv = argv if "--device" in argv else [*argv, *CPU]
    return argv if "--steps" in argv else [*argv, "--steps", "1"]


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    """The deployed defaults to 2, resumed to 4, fresh to 4; then one
    step of each two-process rule case."""
    base = str(tmp_path_factory.mktemp("sp_gang2"))
    runs = [("a", [*LONGCTX, "--steps", "2"], {}, []),
            ("a", [*LONGCTX, "--steps", "4"], {}, []),
            ("b", [*LONGCTX, "--steps", "4"], {}, [])]
    runs += [(name, _argv(name), {}, []) for name, (n, _) in RULES.items()
             if n == 2 and name != "longctx"]
    return base, launch_local(_torch_dp_ranks.worker_runs, 2, base, runs,
                              timeout_s=400, threads=1)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("sp_gang4"))
    runs = [(name, _argv(name), {}, []) for name, (n, _) in RULES.items()
            if n == 4]
    return launch_local(_torch_dp_ranks.worker_runs, 4, base, runs,
                        timeout_s=400, threads=1)


def _port_run(name, gang2, gang4):
    """Each rank's ``(rc, events)`` of rule case ``name``."""
    n = RULES[name][0]
    names = (["longctx", "longctx_resumed", "longctx_fresh"]
             + [m for m, (k, _) in RULES.items() if k == 2 and m != "longctx"]
             if n == 2 else [m for m, (k, _) in RULES.items() if k == 4])
    ranks = gang2[1] if n == 2 else gang4
    return [r[names.index(name)][:2] for r in ranks]


@pytest.fixture(scope="module")
def reference_rule():
    """What the reference's ``run_llama_train`` hands its training loop
    for each rule case, on as many virtual devices as the case's gang
    has processes: ``{name: (mesh report, attn)}``. The rule reads no
    weights, so none are drawn."""
    got = {}
    real = (jax.devices, jax.device_count, jworker._llama_train_loop,
            jl.init_params, jl.shard_params)

    def loop(args, contract, cfg, mesh, loss_fn, specs, params, toks,
             mesh_report, attn_name):
        return {"mesh": mesh_report, "attn": attn_name}

    try:
        jworker._llama_train_loop = loop
        jl.init_params = jl.shard_params = lambda *a, **kw: None
        for name, (n, argv) in RULES.items():
            jax.devices = lambda *a, n=n: real[0](*a)[:n]
            jax.device_count = lambda *a, n=n: n
            args = jworker.build_parser().parse_args(
                [a for a in argv if a not in CPU])
            got[name] = jworker.run_llama_train(args)
    finally:
        (jax.devices, jax.device_count, jworker._llama_train_loop,
         jl.init_params, jl.shard_params) = real
    return got


@pytest.mark.parametrize("name", list(RULES))
def test_mesh_report_and_attention_are_the_reference_s(
        name, reference_rule, gang2, gang4):
    want = reference_rule[name]
    for rc, events in _port_run(name, gang2, gang4):
        assert rc == 0
        done = _done(events)
        assert done["mesh"] == want["mesh"], name
        assert done["attn"] == want["attn"], name
    if name == "longctx":
        assert want["mesh"] == {"dp": 1, "sp": 2, "tp": 1,
                                "ring_layout": "contiguous"}


def test_every_rank_reports_one_loss_stream(gang2, gang4):
    for name in RULES:
        dones = [_done(ev) for _, ev in _port_run(name, gang2, gang4)]
        assert [d["process_id"] for d in dones] == list(range(len(dones)))
        assert len({d["final_loss"] for d in dones}) == 1, name
        assert np.isfinite(dones[0]["final_loss"]), name
        assert dones[0]["sp"] == 2 and dones[0]["backend"] == "gloo"


def test_a_relaunch_resumes_every_rank_at_one_step_bitwise(gang2):
    """The deployed defaults with ``--ckpt-every 1``: the relaunch to 4
    resumes both ranks at 2 and ends where a fresh run to 4 ends, bit for
    bit; each rank's volume holds its own newest steps."""
    _, ranks = gang2
    for r, runs in enumerate(ranks):
        first, resumed, fresh = runs[:3]
        assert _of(first[1], "resumed") == []
        assert [e["step"] for e in _of(resumed[1], "resumed")] == [2]
        assert _done(resumed[1])["steps_run"] == 2
        assert _of(fresh[1], "resumed") == []
        assert _done(fresh[1])["steps_run"] == 4
        assert _done(resumed[1])["final_loss"] == _done(fresh[1])[
            "final_loss"]
        assert [e["step"] for e in _of(fresh[1], "checkpoint")] == [
            1, 2, 3, 4]
        assert fresh[2] == [f"step-0000000{k}-p{r}" for k in (2, 3, 4)]


def test_each_rank_writes_the_whole_replicated_leaves(gang2):
    """Under sp every leaf is replicated: each rank's step directory
    holds every leaf whole (index ``o0_...``) with the bytes the other
    rank wrote."""
    base, _ = gang2
    man = [json.loads(open(f"{base}/b/r{r}/step-00000004-p{r}/"
                           "manifest.json").read())["leaves"]
           for r in (0, 1)]
    assert set(man[0]) == set(man[1])
    for key, entry in man[0].items():
        assert len(entry["shards"]) == 1
        assert entry["shards"][0]["local_shape"] == entry["global_shape"]
        assert entry["shards"] == man[1][key]["shards"], key


def test_done_keys_are_one_process_s_and_the_gang_report_s(gang2,
                                                           tmp_path):
    _, ranks = gang2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tworker.main([*LONGCTX, "--steps", "4", "--out",
                             str(tmp_path / "one")]) == 0
    want = _done([json.loads(line) for line in buf.getvalue().splitlines()
                  if line.startswith("{")])
    assert want["mesh"] == {"dp": 1, "sp": 1, "tp": 1,
                            "ring_layout": "contiguous"}
    for runs in ranks:
        got = _done(runs[2][1])
        assert set(got) == set(want) | (GANG_KEYS - {"tp"})
        assert got["final_loss"] == pytest.approx(want["final_loss"],
                                                  rel=1e-3)
