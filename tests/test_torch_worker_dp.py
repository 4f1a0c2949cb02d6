"""The port worker's training workloads on a gang: ``launch_local`` starts
the processes with the scheduler's ``JAX_*`` rank contract, and each runs
``worker.main`` in turn (``tests/_torch_dp_ranks.worker_runs``) with its
own volume, as the pods of ``dist/resnet.yml`` do. One gang of 2 and one
of 4 for the module.

* ``resnet --depth 18`` on 2 ranks: both report the same ``final_loss``
  and ``global_batch = 2 x batch``; a relaunch with more ``--steps``
  resumes both at the same step; a rank whose newest step was removed
  holds the gang back to the newest step both hold; every rank's
  checkpoint holds the same bytes (the replicated state), and the JAX
  package's one-process ``run_resnet`` template restores a rank's step;
* ``MEGASCALE_NUM_SLICES=2`` on 4 ranks trains exactly as dp = 4;
* ``mnist`` on 2 ranks (each trains alone, as in the reference);
* ``distill`` and ``llama-train --sp 1 --tp 1`` on 2 ranks: the same
  losses on both, equal to one process of the worker over the same
  batch, ``"mesh": {"dp": 2, ...}``, a draft sealed in each volume;
* the refusals before any process group forms: ``llama-train`` with the
  default ``--sp`` on an even gang (``attn_not_ported``), with ``--tp 2``
  under ``RESHARD_ENABLE`` (``reshard_not_ported``), and ``resnet`` when
  the slices do not divide the gang (the reference's mesh error).
"""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import resnet as jr
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_dp_ranks

CPU = ["--device", "cpu"]
RESNET = ["resnet", "--depth", "18", "--batch", "2", *CPU,
          "--emit-every", "1"]
DISTILL = ["distill", "--preset", "tiny", "--batch", "3", "--seq", "32",
           "--steps", "2", "--emit-every", "1", *CPU]
LLAMA_TRAIN = ["llama-train", "--sp", "1", "--tp", "1", "--steps", "3",
               "--seq", "32", *CPU]
GANG_ENV = {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_PROCESS_ID": "0",
            "JAX_NUM_PROCESSES": "2"}


def _done(events):
    return [e for e in events if e["event"] == "done"][0]


def _of(events, name):
    return [e for e in events if e["event"] == name]


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("gang2"))
    runs = [("resnet", [*RESNET, "--steps", "2"], {}, []),
            ("resnet", [*RESNET, "--steps", "3"], {}, []),
            ("resnet", [*RESNET, "--steps", "4"], {}, [1]),
            ("mnist", ["mnist", *CPU, "--steps", "4"], {}, []),
            ("distill", DISTILL, {}, []),
            ("llama", LLAMA_TRAIN, {}, [])]
    ranks = launch_local(_torch_dp_ranks.worker_runs, 2, base, runs,
                         timeout_s=400, threads=1)
    return base, ranks


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("gang4"))
    one = ["resnet", "--depth", "18", "--batch", "1", "--steps", "1", *CPU]
    runs = [("slices", one, {"MEGASCALE_NUM_SLICES": "2"}, []),
            ("dp4", one, {}, [])]
    return launch_local(_torch_dp_ranks.worker_runs, 4, base, runs,
                        timeout_s=400, threads=1)


def _one_process(argv, tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tworker.main([*argv, "--out", str(tmp_path / "one")]) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def test_resnet_gang_shares_one_loss_and_reports_the_global_batch(gang2):
    _, ranks = gang2
    for run in range(3):
        dones = [_done(r[run][1]) for r in ranks]
        assert [r[run][0] for r in ranks] == [0, 0]
        assert [d["process_id"] for d in dones] == [0, 1]
        assert {d["global_batch"] for d in dones} == {4}
        assert dones[0]["final_loss"] == dones[1]["final_loss"]
        assert np.isfinite(dones[0]["final_loss"])
        assert dones[0]["backend"] == "gloo"
        progress = [[(e["step"], e["loss"]) for e in _of(r[run][1],
                                                         "progress")]
                    for r in ranks]
        assert progress[0] == progress[1] and progress[0]
    # a fresh run: 2 steps of 41 collectives (20 batch norms forward and
    # backward, one gradient reduction) after the warm-up's
    assert _done(ranks[0][0][1])["collectives"] == 3 * 41


def test_resnet_gang_resumes_every_rank_at_one_step(gang2):
    _, ranks = gang2
    for r in ranks:
        assert _of(r[0][1], "resumed") == []
        assert _of(r[1][1], "resumed") == [{"event": "resumed", "step": 2}]
        assert _done(r[1][1])["steps"] == 1
        assert [e["step"] for e in _of(r[1][1], "progress")] == [3]


def test_a_rank_behind_holds_the_gang_back_to_the_shared_step(gang2):
    """Rank 1 lost its step 3 before the third launch: both resume at 2
    and run 2 steps, and the stream continues bitwise: step 3's loss is
    the second launch's."""
    _, ranks = gang2
    for r in ranks:
        assert _of(r[2][1], "resumed") == [{"event": "resumed", "step": 2}]
        assert _done(r[2][1])["steps"] == 2
        again = {e["step"]: e["loss"] for e in _of(r[2][1], "progress")}
        first = {e["step"]: e["loss"] for e in _of(r[1][1], "progress")}
        assert again[3] == first[3]
    for r, runs in enumerate(ranks):
        assert runs[2][2] == [f"step-0000000{k}-p{r}" for k in (2, 3, 4)]


def test_every_rank_saves_the_same_replicated_state(gang2):
    base, _ = gang2
    manifests = [json.loads(open(f"{base}/resnet/r{r}/step-00000004-p{r}/"
                                 "manifest.json").read()) for r in (0, 1)]
    assert [m["process"] for m in manifests] == [0, 1]
    assert {m["num_processes"] for m in manifests} == {2}
    for key, entry in manifests[0]["leaves"].items():
        other = manifests[1]["leaves"][key]
        assert entry["global_shape"] == other["global_shape"]
        assert [s["digest"] for s in entry["shards"]] == \
            [s["digest"] for s in other["shards"]], key


def test_a_gang_rank_s_step_restores_into_the_jax_one_process_template(
        gang2, tmp_path):
    """Rank 1's ``step-4-p1`` as a one-process volume: the JAX package's
    ``run_resnet`` template (params, optax state, batch-norm state)
    restores it (its restore holds every shard to the digest the port
    wrote), at the port's counts and trained statistics."""
    base, _ = gang2
    shutil.copytree(f"{base}/resnet/r1/step-00000004-p1",
                    tmp_path / "step-00000004-p0")
    cfg = jr.ResNetConfig(depth=18, n_classes=1000)
    params, state = jax.tree.map(
        jnp.zeros_like, jax.eval_shape(
            lambda: jr.init_params(cfg, jax.random.key(0))))
    template = {"params": params,
                "opt_state": jt.make_optimizer(lr=0.1).init(params),
                "state": state}
    tree = jc.restore_sharded(str(tmp_path), template, 4)
    adam = tree["opt_state"][1][0]
    assert int(adam.count) == 5
    head = np.asarray(tree["params"]["head"]["w"]).astype(np.float32)
    assert np.isfinite(head).all() and np.abs(head).max() > 0
    var = np.asarray(tree["state"]["stem"]["bn"]["var"])
    assert not np.allclose(var, 1.0)


def test_multislice_trains_as_dp_over_every_slice(gang4):
    """``MEGASCALE_NUM_SLICES=2`` on 4 ranks: ``MeshSpec(dp=2, dcn=2)``
    is one dp axis of 4 in rank order, so its step is dp = 4's bit for
    bit."""
    for r, runs in enumerate(gang4):
        (rc_s, ev_s, _), (rc_d, ev_d, _) = runs
        assert rc_s == rc_d == 0
        assert _done(ev_s)["final_loss"] == _done(ev_d)["final_loss"]
        assert _done(ev_s)["global_batch"] == 4
        assert _done(ev_s)["process_id"] == r
    assert len({_done(runs[0][1])["final_loss"] for runs in gang4}) == 1


def test_mnist_on_a_gang_trains_each_process_alone(gang2):
    _, ranks = gang2
    for r, runs in enumerate(ranks):
        rc, events, steps = runs[3]
        assert rc == 0
        done = _done(events)
        assert done["process_id"] == r and done["steps"] == 4
        assert np.isfinite(done["final_loss"])
        assert steps[-1] == f"step-00000004-p{r}"
    # the same seed on every process, and no collective between them
    assert _done(ranks[0][3][1])["final_loss"] == \
        _done(ranks[1][3][1])["final_loss"]


def test_distill_on_a_gang_is_one_process_over_the_whole_batch(gang2,
                                                               tmp_path):
    """Batch 3 over 2 ranks (rows 2 + 1): the same losses on both ranks,
    within 1e-3 of one process of the worker (the tiny preset trains in
    bf16, where the ranks' split sums round in another order; the fp32
    step is held to 1e-5 in ``tests/test_torch_dp.py``); each rank seals
    its draft in its own volume."""
    base, ranks = gang2
    want = _done(_one_process(DISTILL, tmp_path))
    for r, runs in enumerate(ranks):
        rc, events, steps = runs[4]
        assert rc == 0
        done = _done(events)
        assert done["dp"] == 2 and done["process_id"] == r
        assert done["loss_trajectory"] == pytest.approx(
            want["loss_trajectory"], rel=1e-3)
        assert done["loss_trajectory"] == _done(ranks[0][4][1])[
            "loss_trajectory"]
        assert _of(events, "draft_saved")[0]["path"] == \
            f"{base}/distill/r{r}/draft"
        assert steps[-1] == f"step-00000002-p{r}"


def test_llama_train_on_a_gang_trains_dp_only(gang2, tmp_path):
    _, ranks = gang2
    want = _done(_one_process(LLAMA_TRAIN, tmp_path))
    assert want["mesh"] == {"dp": 1, "sp": 1, "tp": 1}
    finals = set()
    for r, runs in enumerate(ranks):
        rc, events, _ = runs[5]
        assert rc == 0
        done = _done(events)
        assert done["mesh"] == {"dp": 2, "sp": 1, "tp": 1}
        assert done["steps_run"] == 3 and np.isfinite(done["final_loss"])
        finals.add(done["final_loss"])
    assert len(finals) == 1
    # dp=2 trains 4 rows, one process 2: other data, the same scale
    assert abs(finals.pop() - want["final_loss"]) < 1.0


@pytest.mark.parametrize("workload,args,env,code", [
    ("llama-train", [], {"RESHARD_ENABLE": "1"}, "reshard_not_ported"),
    ("llama-train", ["--sp", "1", "--tp", "2"], {"RESHARD_ENABLE": "1"},
     "reshard_not_ported")])
def test_llama_train_gang_refusals_come_before_the_process_group(
        workload, args, env, code, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k, v in {**GANG_ENV, **env}.items():
        monkeypatch.setenv(k, v)
    assert tworker.main([workload, *CPU, *args]) == 2
    events = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()]
    errors = _of(events, "error")
    assert len(errors) == 1 and errors[0]["code"] == code
    assert "item" in errors[0]["error"]
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_slices_that_do_not_divide_the_gang_raise_as_the_reference(
        monkeypatch):
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "3")
    with pytest.raises(ValueError, match="processes"):
        tworker.main(RESNET)
