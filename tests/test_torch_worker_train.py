"""The port's training workloads (``python -m dcos_commons_tpu_torch.
frameworks.worker llama-train | distill``, ``--device cpu``), beside
``frameworks/jax/worker.py`` (``tests/test_torch_worker_train_cross.py``
crosses checkpoints between the two): a run at its target reports that
nothing ran; the knobs of modules not ported yet exit 2 with their
codes; a grad-accum the batch does not divide falls back; a
non-finite loss rolls back to the newest checkpoint; a SIGTERM'd worker
flushes, exits 143 and its relaunch resumes; ``distill`` lowers its
loss and seals a draft that the port's and the reference's
``load_draft`` and the port's ``PagedServer.arm_draft`` take;
``--profile-dir`` and ``TPU_PROFILE_DIR`` write a Chrome trace."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import speculative as jspec
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models import speculative as tspec

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["llama-train", "--seq", "64"]
CPU = ["--device", "cpu"]


def _events(capsys):
    return [json.loads(line)
            for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _done(events):
    return [e for e in events if e.get("event") == "done"][0]


def _counts(out_dir, step):
    """The saved optimizer state's (adam count, schedule count)."""
    d = Path(out_dir) / f"step-{step:08d}-p0"
    return tuple(int(np.fromfile(d / f"opt_state.{k}.count.o.bin",
                                 dtype=np.int32)[0])
                 for k in ("1.0", "1.2"))


def test_a_run_past_its_target_reports_nothing_ran(tmp_path, capsys):
    out = tmp_path / "vol"
    assert tworker.main([*TRAIN, *CPU, "--steps", "2", "--out",
                         str(out)]) == 0
    capsys.readouterr()
    assert tworker.main([*TRAIN, *CPU, "--steps", "2", "--out",
                         str(out)]) == 0
    got = _done(_events(capsys))
    assert got["steps_run"] == 0 and got["final_loss"] is None
    assert got["tokens_per_sec"] == 0.0


# (args, env, code, the ROADMAP Queue 1 item the refusal names)
REFUSALS = [
    (["--pp", "2"], {}, "pipeline_not_ported", 9),
    (["--ep", "2"], {}, "moe_not_ported", 7),
    (["--attn", "ring"], {}, "attn_not_ported", 9),
    (["--attn", "ulysses"], {}, "attn_not_ported", 9),
    ([], {"RESHARD_ENABLE": "1"}, "reshard_not_ported", 10),
]


@pytest.mark.parametrize("args,env,code,item", REFUSALS,
                         ids=[f"{c}-{i}" for i, (_, _, c, _) in
                              enumerate(REFUSALS)])
def test_unported_train_knob_exits_2_with_its_code(args, env, code, item,
                                                   tmp_path, capsys,
                                                   monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = tworker.main([*TRAIN, *CPU, "--steps", "1", "--out",
                       str(tmp_path / "vol"), *args])
    assert rc == 2
    events = _events(capsys)
    errors = [e for e in events if e.get("event") == "error"]
    assert len(errors) == 1 and errors[0]["code"] == code
    assert f"item {item})" in errors[0]["error"]
    assert not any(e.get("event") == "done" for e in events)
    assert not (tmp_path / "vol").exists()


def test_grad_accum_the_batch_does_not_divide_falls_back(capsys):
    assert tworker.main(["llama-train", *CPU, "--seq", "16", "--steps", "1",
                         "--grad-accum", "3"]) == 0
    events = _events(capsys)
    fb = [e for e in events if e.get("event") == "grad_accum_fallback"]
    assert fb == [{"event": "grad_accum_fallback", "requested": 3,
                   "batch": 2}]
    assert _done(events)["grad_accum"] == 1


def test_grad_accum_that_divides_the_batch_is_kept(capsys):
    assert tworker.main(["llama-train", *CPU, "--seq", "16", "--steps", "1",
                         "--grad-accum", "2"]) == 0
    events = _events(capsys)
    assert not any(e.get("event") == "grad_accum_fallback" for e in events)
    assert _done(events)["grad_accum"] == 2


def test_a_nonfinite_loss_rolls_back_to_the_newest_checkpoint(
        tmp_path, capsys, monkeypatch):
    """One poisoned step (its loss NaN, so its update NaN too): the
    sentinel restores the step-2 checkpoint, re-runs from there and the
    run completes with the counts of an unpoisoned run. (A periodic save
    lands before the step's loss check, as in the reference, so the save
    interval skips the poisoned step.)"""
    real = tl.loss_fn
    calls = {"n": 0}

    def poisoned(cfg, params, tokens):
        calls["n"] += 1
        loss, acc = real(cfg, params, tokens)
        # call 1 is the warm-up; call 4 is step index 2
        return (loss * float("nan"), acc) if calls["n"] == 4 else (loss, acc)

    monkeypatch.setattr(tl, "loss_fn", poisoned)
    out = tmp_path / "vol"
    assert tworker.main([*TRAIN, *CPU, "--steps", "4", "--ckpt-every", "2",
                         "--out", str(out)]) == 0
    events = _events(capsys)
    names = [e["event"] for e in events]
    assert names.count("nonfinite_loss") == 1
    back = [e for e in events if e["event"] == "rolled_back"]
    assert len(back) == 1 and back[0]["to_step"] == 2
    done = _done(events)
    assert np.isfinite(done["final_loss"])
    assert _counts(out, 4) == (5, 5)


def _spawn(out, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
         "llama-train", "--device", "cpu", "--seq", "16", "--ckpt-every",
         "1", "--out", str(out), *extra],
        cwd=out.parent, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_sigterm_flushes_exits_143_and_the_relaunch_resumes(tmp_path):
    out = tmp_path / "vol"
    proc = _spawn(out, "--steps", "100000")
    events = []
    deadline = time.time() + 60
    try:
        for line in proc.stdout:
            if line.startswith("{"):
                events.append(json.loads(line))
                if events[-1].get("event") == "checkpoint":
                    proc.send_signal(signal.SIGTERM)
                    break
            assert time.time() < deadline
        events += [json.loads(line) for line in proc.stdout
                   if line.startswith("{")]
        rc = proc.wait(timeout=60)
    finally:
        proc.kill()
    assert rc == 143, events
    names = [e["event"] for e in events]
    assert "sigterm" in names
    pre = [e for e in events if e["event"] == "preempted"]
    assert len(pre) == 1
    flushed = pre[0]["flushed_step"]
    done = [e for e in events if e["event"] == "done"][0]
    assert done["stopped"] == "preempted" and done["resume_step"] == flushed
    relaunch = _spawn(out, "--steps", str(flushed + 1))
    lines, _ = relaunch.communicate(timeout=60)
    assert relaunch.returncode == 0
    again = [json.loads(line) for line in lines.splitlines()
             if line.startswith("{")]
    assert [e["step"] for e in again if e["event"] == "resumed"] == [flushed]
    assert [e for e in again if e["event"] == "done"][0]["steps_run"] == 1


def test_distill_seals_a_draft_both_packages_load_and_the_engine_arms(
        tmp_path, capsys):
    out = tmp_path / "vol"
    argv = ["distill", *CPU, "--preset", "tiny", "--batch", "2", "--seq",
            "32", "--draft-layers", "1", "--out", str(out)]
    assert tworker.main([*argv, "--steps", "3", "--emit-every", "1"]) == 0
    events = _events(capsys)
    done = _done(events)
    assert done["loss_final"] < done["loss_first"], done
    assert sorted(done) == sorted([
        "event", "workload", "preset", "draft_layers", "teacher_layers",
        "seq", "temperature", "loss_first", "loss_final", "loss_trajectory",
        "steps_run", "draft_dir", "tokens_per_sec", "process_id"])
    assert [e["step"] for e in events if e["event"] == "progress"] == [1, 2,
                                                                       3]
    saved = [e for e in events if e["event"] == "draft_saved"][0]
    assert saved["path"] == done["draft_dir"] and saved["draft_layers"] == 1
    cfg_t = tl.LlamaConfig.tiny()
    cfg_d, params_d, meta = tspec.load_draft(done["draft_dir"], cfg_t,
                                             device="cpu")
    assert cfg_d.n_layers == 1 and meta["step"] == 3
    jcfg_d, _, _ = jspec.load_draft(done["draft_dir"], jl.LlamaConfig.tiny())
    assert jcfg_d.n_layers == 1
    target = tl.init_params(cfg_t, torch.Generator().manual_seed(0),
                            device="cpu")
    engine = ts.PagedServer(cfg_t, target, slots=2, pages=16, page_size=16,
                            prefill_chunk=16, device="cpu")
    engine.arm_draft(cfg_d, params_d, k=2)
    assert engine.page_stats()["spec"]["armed"]
    # the student trained its own copies: the layer-0 weights moved away
    # from the target's
    assert not torch.equal(params_d["layers"]["wq"][0],
                           target["layers"]["wq"][0])
    assert tworker.main([*argv, "--steps", "4"]) == 0
    again = _events(capsys)
    assert [e["step"] for e in again if e["event"] == "resumed"] == [3]
    assert _done(again)["steps_run"] == 1


@pytest.mark.parametrize("how", ["flag", "env"])
def test_profile_dir_writes_a_chrome_trace(how, tmp_path, capsys,
                                           monkeypatch):
    prof = tmp_path / "prof"
    extra = []
    if how == "flag":
        extra = ["--profile-dir", str(prof)]
    else:
        monkeypatch.setenv("TPU_PROFILE_DIR", str(prof))
    assert tworker.main(["llama-train", *CPU, "--seq", "16", "--steps", "1",
                         *extra]) == 0
    events = _events(capsys)
    assert {"event": "profiling", "dir": str(prof)} in events
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_step.backward", "train_step.optimizer"} <= names
