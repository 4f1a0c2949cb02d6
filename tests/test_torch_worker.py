"""The port's worker (``python -m dcos_commons_tpu_torch.frameworks.worker
llama``) against ``frameworks/jax/worker.py``: its flags carry the
reference's names, defaults, types, choices and env knobs; the solo run's
result has the reference's keys; as a subprocess with ``--serve --slots``
(slot and paged engines) it writes ``serving.ready``, emits ``serving``,
answers ``POST /v1/generate`` with the tokens of a port engine built
directly from the same seed, emits heartbeats and exits on SIGTERM; a
page size that does not divide ``max_seq`` falls back to slots; every
knob of a module not ported yet exits 2 with its coded error.
``--spec-decode`` arms the paged engine from a sealed draft artifact
(``spec_armed``) or gives the reference's coded ``spec_fallback``; a
serving ``--out`` holding a checkpoint the JAX package wrote restores it
bitwise (``source: disk``), a corrupt one falls back with
``weight_restore_fallback``, and an empty manifest fails as the
reference's does."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from frameworks.jax import worker as jworker
from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models import speculative as tspec
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel import checkpoint as tc

ROOT = Path(__file__).resolve().parents[1]
WORKER_SRC = (ROOT / "dcos_commons_tpu_torch" / "frameworks"
              / "worker.py").read_text()
ENV_KNOBS = sorted(set(re.findall(r'os\.environ\.get\("([A-Z_]+)"',
                                  WORKER_SRC)) - {
    # read at run time, not by the parser
    "WEIGHT_FETCH_PEERS", "WEIGHT_SERVE_PORT", "PORT_WEIGHTS",
    "PORT_SERVE", "MEGASCALE_NUM_SLICES", "TASK_NAME",
    "POD_INSTANCE_INDEX", "TPU_PROFILE_DIR", "RESHARD_ENABLE"})


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.option_strings}


def test_parser_flags_are_the_reference_flags():
    ours, ref = _actions(tworker.build_parser()), _actions(
        jworker.build_parser())
    assert "device" in ours and "device" not in ref
    for dest, a in ours.items():
        if dest in ("device", "help"):
            continue
        assert dest in ref, dest
        r = ref[dest]
        assert a.option_strings == r.option_strings, dest
        assert a.default == r.default, dest
        assert a.type == r.type, dest
        assert a.choices == r.choices, dest
        assert type(a) is type(r), dest
    llama_flags = {"preset", "kv_quant", "quant", "max_seq", "gen_len",
                   "slots", "serve", "serve_port", "pages", "page_size",
                   "prefill_chunk", "queue_limit", "decode_window",
                   "serve_interval", "serve_role", "out", "spec_decode",
                   "moe_experts", "prefill_seq_parallel",
                   "kv_tier_host_pages", "prefix_directory"}
    assert llama_flags <= set(ours)
    assert tworker.build_parser().parse_args(["llama"]).device == "cuda"


def test_parser_env_knobs_are_the_reference_knobs(monkeypatch):
    """Each env knob the port reads sets the same default in both
    parsers."""
    assert len(ENV_KNOBS) >= 20
    for i, name in enumerate(ENV_KNOBS):
        monkeypatch.setenv(name, str(100 + i))
    ours = vars(tworker.build_parser().parse_args(["llama"]))
    ref = vars(jworker.build_parser().parse_args(["llama"]))
    for dest, value in ours.items():
        if dest not in ("device", "workload"):
            assert value == ref[dest], dest
    for name in ENV_KNOBS:
        monkeypatch.delenv(name)
    defaults = vars(tworker.build_parser().parse_args(["llama"]))
    changed = [d for d in ours if ours[d] != defaults[d]]
    assert len(changed) == len(ENV_KNOBS)


def _done(capsys):
    events = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    return [e for e in events if e.get("event") == "done"][0]


def test_solo_run_has_the_reference_result_keys(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert jworker.main(["llama", "--preset", "tiny", "--gen-len", "4"]) == 0
    want = _done(capsys)
    os.remove("serving.ready")
    assert tworker.main(["llama", "--preset", "tiny", "--gen-len", "4",
                         "--device", "cpu", "--out", "vol"]) == 0
    got = _done(capsys)
    assert sorted(got) == sorted(want)
    assert got["tokens_per_sec"] > 0 and got["tp"] == 1
    assert got["quant"] == "none" and got["kv_quant"] is False
    assert (tmp_path / "serving.ready").read_text() == "ok\n"
    assert (tmp_path / "vol").is_dir()


def test_solo_run_int8_weights(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tworker.main(["llama", "--gen-len", "3", "--device", "cpu",
                         "--quant", "int8", "--kv-quant"]) == 0
    got = _done(capsys)
    assert got["quant"] == "int8" and got["kv_quant"] is True
    assert got["tokens_per_sec"] > 0


# every subprocess test ends within this many seconds of its start
TIME_LIMIT_S = 60


class _Worker:
    """A worker subprocess with a reader thread, so every wait has a
    real deadline, and all of them one within ``TIME_LIMIT_S``."""

    def __init__(self, cwd, *args, env=None):
        self.deadline = time.time() + TIME_LIMIT_S
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
             "llama", "--device", "cpu", "--serve-interval", "0.2",
             "--gen-len", "4", *args],
            cwd=cwd, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})))
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for raw in self.proc.stdout:
            self.lines.put(raw)

    def event(self, name, timeout=40.0, where=lambda e: True):
        deadline = min(time.time() + timeout, self.deadline - 5)
        while time.time() < deadline:
            try:
                raw = self.lines.get(timeout=0.5)
            except queue.Empty:
                if self.proc.poll() is not None and self.lines.empty():
                    break
                continue
            if not raw.startswith("{"):
                continue
            e = json.loads(raw)
            if e.get("event") == name and where(e):
                return e
        raise AssertionError(f"no {name} event before the deadline")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=max(1.0,
                                              self.deadline - time.time()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=20) as r:
        return json.loads(r.read())


PROMPTS = [[5, 17, 99, 3, 250, 1, 42], [7] * 20]


@pytest.mark.parametrize("engine", ["slots", "paged"])
def test_served_tokens_equal_a_directly_built_engine(tmp_path, engine):
    args = ["--serve", "--slots", "2", "--serve-port", "0"]
    if engine == "paged":
        args += ["--pages", "64"]
    w = _Worker(tmp_path, *args)
    try:
        serving = w.event("serving")
        assert serving["slots"] == 2
        assert serving["cold_start"]["source"] == "init"
        assert ("paged" in serving) == (engine == "paged")
        port = serving["port"]
        assert (tmp_path / "serving.ready").read_text() == f"ok {port}\n"
        got = [_post(port, {"prompt": p, "max_new": 6})["tokens"]
               for p in PROMPTS]
        hb = w.event("heartbeat", where=lambda e: e.get("requests") == 2)
        assert hb["tokens"] == 12
        assert ("paged" in hb) == (engine == "paged")
        rc = w.stop()
    finally:
        if w.proc.poll() is None:
            w.proc.kill()
    assert rc == -signal.SIGTERM
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    if engine == "paged":
        srv = ts.PagedServer(cfg, params, slots=2, pages=64, device="cpu")
    else:
        srv = ts.SlotServer(cfg, params, slots=2, device="cpu")
    want = [srv.drain([{"prompt": p, "max_new": 6, "request_id": i}],
                      decode_window=8)[i] for i, p in enumerate(PROMPTS)]
    assert got == want


def test_page_size_that_does_not_divide_max_seq_serves_slots(tmp_path):
    w = _Worker(tmp_path, "--serve", "--slots", "2", "--serve-port", "0",
                "--pages", "64", "--page-size", "48")
    try:
        fallback = w.event("paged_fallback")
        assert "divide" in fallback["error"] and fallback["page_size"] == 48
        serving = w.event("serving")
        assert serving["slots"] == 2 and "paged" not in serving
        assert len(_post(serving["port"], {"prompt": [1, 2, 3],
                                           "max_new": 3})["tokens"]) == 3
    finally:
        w.stop()


def test_weight_server_is_reported_and_serving_goes_on(tmp_path):
    w = _Worker(tmp_path, "--serve", "--slots", "1", "--serve-port", "0",
                "--out", "vol", env={"WEIGHT_SERVE_PORT": "0"})
    try:
        err = w.event("weight_server_error")
        assert "item 6" in err["error"]
        assert w.event("serving")["slots"] == 1
    finally:
        w.stop()


# (index, workload, args, env, code): the index keeps each case's id as
# it was while speculative decoding, the checkpoint restore, profiling and
# MoE serving were refused (MoE training stays refused: it needs the mesh)
REFUSALS = [
    (1, "llama-train", ["--ep", "2"], {}, "moe_not_ported"),
    (2, "llama", ["--prefill-seq-parallel", "true"], {},
     "longctx_not_ported"),
    (3, "llama", ["--serve-role", "prefill"], {}, "disagg_not_ported"),
    (4, "llama", ["--serve-role", "decode"], {}, "disagg_not_ported"),
    (5, "llama", ["--serve-role", "router"], {}, "router_not_ported"),
    (6, "llama", ["--kv-tier-host-pages", "8"], {}, "kv_tiers_not_ported"),
    (7, "llama", ["--kv-tier-disk-dir", "tier", "--kv-tier-disk-pages", "8"],
     {}, "kv_tiers_not_ported"),
    (8, "llama", ["--prefix-directory", "5"], {},
     "prefix_directory_not_ported"),
    (9, "llama", [], {"WEIGHT_FETCH_PEERS": "http://peer:1"},
     "weight_fetch_not_ported"),
    (13, "llama", [], {"JAX_COORDINATOR_ADDRESS": "pod-0:1",
                       "JAX_PROCESS_ID": "0", "JAX_NUM_PROCESSES": "2"},
     "not_ported"),
]


@pytest.mark.parametrize("workload,args,env,code", [r[1:] for r in REFUSALS],
                         ids=[f"{r[-1]}-{r[0]}" for r in REFUSALS])
def test_unported_knob_exits_2_with_its_code(workload, args, env, code,
                                             tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = tworker.main([workload, "--device", "cpu", "--serve", "--slots",
                       "2", "--gen-len", "2", *args])
    assert rc == 2
    events = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()]
    errors = [e for e in events if e.get("event") == "error"]
    assert len(errors) == 1 and errors[0]["code"] == code
    assert re.search(r"item [4-9]|item 10", errors[0]["error"])
    assert not any(e.get("event") == "serving" for e in events)


def test_multislice_is_refused(monkeypatch, capsys):
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    assert tworker.main(["llama", "--device", "cpu"]) == 2
    assert jworker.main(["llama"]) == 2


# ---------------------------------------------------------------------------
# speculative decoding and the checkpoint restore


def _draft_artifact(path, **cfg_kw):
    """The tiny worker model's 1-layer draft (the weights of seed 0, as
    the worker initialises them) sealed with ``save_draft``."""
    cfg = tl.LlamaConfig.tiny(**cfg_kw)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cfg_d, params_d = tl.truncate_layers(cfg, params, 1)
    tspec.save_draft(str(path), 1, cfg_d, params_d, target_cfg=cfg)
    return cfg, params, cfg_d, params_d


def _events(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _spec_outcome(capsys, argv, cfg_kw=None):
    """The spec events of the port's and the reference's
    ``_make_serving_engine`` on the same flags, each on its own tiny
    engine."""
    cfg_kw = cfg_kw or {}
    targs = tworker.build_parser().parse_args(["llama", *argv])
    tcfg = tl.LlamaConfig.tiny(**cfg_kw)
    tparams = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    engine, stats = tworker._make_serving_engine(targs, tcfg, tparams, "cpu")
    ours = [e for e in _events(capsys) if e["event"].startswith("spec_")]
    jargs = jworker.build_parser().parse_args(["llama", *argv])
    jcfg = jl.LlamaConfig.tiny(**cfg_kw)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    jworker._make_serving_engine(jargs, jcfg, jparams,
                                 types.SimpleNamespace(size=1))
    ref = [e for e in _events(capsys) if e["event"].startswith("spec_")]
    return engine, ours, ref


SPEC_CASES = [
    # (name, extra flags, draft artifact config, event, code)
    ("armed", ["--pages", "64"], {}, "spec_armed", None),
    ("no_checkpoint", ["--pages", "64", "--draft-checkpoint", ""], None,
     "spec_fallback", "draft_config_missing"),
    ("not_an_artifact", ["--pages", "64"], None, "spec_fallback",
     "draft_config_missing"),
    ("slot_engine", [], {}, "spec_fallback", "spec_needs_paged"),
    ("vocab", ["--pages", "64"], {"vocab_size": 512}, "spec_fallback",
     "draft_vocab_mismatch"),
    ("stale", ["--pages", "64"], "stale", "spec_fallback",
     "draft_manifest_stale"),
]


@pytest.mark.parametrize("name,extra,draft,event,code", SPEC_CASES,
                         ids=[c[0] for c in SPEC_CASES])
def test_spec_decode_arms_or_falls_back_as_the_reference(
        tmp_path, capsys, name, extra, draft, event, code):
    path = tmp_path / "draft"
    path.mkdir()
    if draft == "stale":
        cfg, params, _, _ = _draft_artifact(path)
        tc.save_sharded(str(path), 2, {"params": params})
    elif draft is not None:
        _draft_artifact(path, **draft)
    argv = ["--serve", "--slots", "2", "--spec-decode", "true",
            "--draft-checkpoint", str(path), "--draft-k", "3", *extra]
    engine, ours, ref = _spec_outcome(capsys, argv)
    assert [e["event"] for e in ours] == [e["event"] for e in ref] == [event]
    assert ours[0].get("code") == ref[0].get("code") == code
    if event == "spec_armed":
        assert ours[0]["k"] == ref[0]["k"] == 3
        assert ours[0]["draft_layers"] == ref[0]["draft_layers"] == 1
        assert ours[0]["draft_step"] == 1 and ours[0]["load_s"] >= 0
        assert engine.page_stats()["spec"]["armed"]
    elif hasattr(engine, "page_stats"):
        assert not engine.page_stats()["spec"]["armed"]


def _save_jax_checkpoint(vol, step=4):
    """The reference's serving template (tiny, bf16, key 0) changed so a
    restore is visible, saved by the JAX package under ``vol``."""
    jcfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.key(0))
    jp = {**jp, "lm_head": jp["lm_head"] * 2, "norm": jp["norm"] * 0.5}
    jc.save_sharded(str(vol), step, jp)
    return jcfg, jp


def test_serving_weights_restore_a_jax_checkpoint_bitwise(tmp_path, capsys):
    jcfg, jp = _save_jax_checkpoint(tmp_path / "vol")
    args = tworker.build_parser().parse_args(
        ["llama", "--serve", "--out", str(tmp_path / "vol")])
    template = tl.param_template(tl.LlamaConfig.tiny(), "cpu")
    params, report = tworker._boot_serving_weights(
        args, template, lambda: pytest.fail("restored, not initialised"))
    assert report["source"] == "disk" and report["step"] == 4
    assert report["restore_s"] >= 0 and report["fetch_s"] == 0.0
    want = params_from_jax(jax.device_get(jp), device="cpu")
    for (k, a), (_, b) in zip(tc._flatten(params), tc._flatten(want)):
        assert torch.equal(a, b), k
    jparams, jreport = jworker._boot_serving_weights(
        jworker.build_parser().parse_args(
            ["llama", "--serve", "--out", str(tmp_path / "vol")]),
        jl.init_params(jcfg, jax.random.key(0)))
    assert sorted(jreport) == sorted(report)
    assert not [e for e in _events(capsys) if "fallback" in e["event"]]


def test_a_corrupt_checkpoint_falls_back_to_the_init(tmp_path, capsys):
    _save_jax_checkpoint(tmp_path / "vol")
    shard = tmp_path / "vol" / "step-00000004-p0" / "norm.o0.bin"
    shard.write_bytes(shard.read_bytes()[:-2])
    init = tl.init_params(tl.LlamaConfig.tiny(),
                          torch.Generator().manual_seed(0), device="cpu")
    args = tworker.build_parser().parse_args(
        ["llama", "--serve", "--out", str(tmp_path / "vol")])
    params, report = tworker._boot_serving_weights(
        args, tl.param_template(tl.LlamaConfig.tiny(), "cpu"), lambda: init)
    assert params is init and report["source"] == "init"
    ours = [e for e in _events(capsys) if "fallback" in e["event"]]
    jworker._boot_serving_weights(
        jworker.build_parser().parse_args(
            ["llama", "--serve", "--out", str(tmp_path / "vol")]),
        jl.init_params(jl.LlamaConfig.tiny(), jax.random.key(0)))
    ref = [e for e in _events(capsys) if "fallback" in e["event"]]
    assert [e["event"] for e in ours] == [e["event"] for e in ref] == [
        "weight_restore_fallback"]
    assert ours[0]["step"] == ref[0]["step"] == 4
    assert "truncated" in ours[0]["error"]


def test_an_empty_manifest_fails_as_the_reference(tmp_path, monkeypatch,
                                                  capsys):
    """A step directory whose manifest is ``{}``: the reference's restore
    raises KeyError ('leaves'), which its fallback does not catch, and
    the worker dies (ROADMAP Queue 3); the port does the same."""
    monkeypatch.chdir(tmp_path)
    step = tmp_path / "vol" / "step-00000003-p0"
    step.mkdir(parents=True)
    (step / "manifest.json").write_text("{}")
    argv = ["llama", "--serve", "--slots", "2", "--gen-len", "2",
            "--out", "vol"]
    with pytest.raises(KeyError, match="leaves"):
        jworker.main(argv)
    with pytest.raises(KeyError, match="leaves"):
        tworker.main([*argv, "--device", "cpu"])
    assert not any(e.get("event") == "serving" for e in _events(capsys))


def test_the_worker_serves_spec_decode_from_a_restored_checkpoint(tmp_path):
    """The scheduler's command with ``--out`` holding a JAX checkpoint
    and ``--spec-decode``: ``weights_loaded`` from disk, ``spec_armed``,
    and the served tokens equal a port engine built directly from the
    restored weights and armed with the same draft."""
    jcfg, jp = _save_jax_checkpoint(tmp_path / "vol")
    draft = tmp_path / "draft"
    draft.mkdir()
    params = params_from_jax(jax.device_get(jp), device="cpu")
    cfg = tl.LlamaConfig.tiny()
    cfg_d, params_d = tl.truncate_layers(cfg, params, 1)
    tspec.save_draft(str(draft), 1, cfg_d, params_d)
    w = _Worker(tmp_path, "--serve", "--slots", "2", "--serve-port", "0",
                "--pages", "64", "--out", "vol", "--spec-decode", "true",
                "--draft-checkpoint", str(draft))
    try:
        loaded = w.event("weights_loaded")
        assert loaded["source"] == "disk" and loaded["step"] == 4
        armed = w.event("spec_armed")
        assert armed["draft_layers"] == 1 and armed["k"] == 4
        serving = w.event("serving")
        assert serving["cold_start"]["source"] == "disk"
        got = [_post(serving["port"], {"prompt": p, "max_new": 6})["tokens"]
               for p in PROMPTS]
        hb = w.event("heartbeat", where=lambda e: e.get("requests") == 2)
        assert hb["paged"]["spec"]["windows"] > 0
        stats = urllib.request.urlopen(
            f"http://127.0.0.1:{serving['port']}/v1/stats", timeout=20)
        assert json.loads(stats.read())["window"]["spec_windows"] > 0
        rc = w.stop()
    finally:
        if w.proc.poll() is None:
            w.proc.kill()
    assert rc == -signal.SIGTERM
    srv = ts.PagedServer(cfg, params, slots=2, pages=64, device="cpu")
    srv.arm_draft(cfg_d, params_d, k=4)
    want = [srv.drain([{"prompt": p, "max_new": 6, "request_id": i}],
                      decode_window=8)[i] for i, p in enumerate(PROMPTS)]
    assert got == want
