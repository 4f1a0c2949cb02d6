"""The port's worker (``python -m dcos_commons_tpu_torch.frameworks.worker
llama``) against ``frameworks/jax/worker.py``: its flags carry the
reference's names, defaults, types, choices and env knobs; the solo run's
result has the reference's keys; as a subprocess with ``--serve --slots``
(slot and paged engines) it writes ``serving.ready``, emits ``serving``,
answers ``POST /v1/generate`` with the tokens of a port engine built
directly from the same seed, emits heartbeats and exits on SIGTERM; a
page size that does not divide ``max_seq`` falls back to slots; every
knob of a module not ported yet exits 2 with its coded error."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

import tests._jax_cpu  # noqa: F401

from frameworks.jax import worker as jworker
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts

ROOT = Path(__file__).resolve().parents[1]
WORKER_SRC = (ROOT / "dcos_commons_tpu_torch" / "frameworks"
              / "worker.py").read_text()
ENV_KNOBS = sorted(set(re.findall(r'os\.environ\.get\("([A-Z_]+)"',
                                  WORKER_SRC)) - {
    # read at run time, not by the parser
    "WEIGHT_FETCH_PEERS", "WEIGHT_SERVE_PORT", "PORT_WEIGHTS",
    "PORT_SERVE", "MEGASCALE_NUM_SLICES", "TASK_NAME",
    "POD_INSTANCE_INDEX", "TPU_PROFILE_DIR"})


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


def _checkpoint(tmp_path):
    step = tmp_path / "vol" / "step-00000003-p0"
    step.mkdir(parents=True)
    (step / "manifest.json").write_text("{}")
    return ["--out", "vol"]


REFUSALS = [
    (["--spec-decode", "true"], {}, "spec_decode_not_ported"),
    (["--moe-experts", "4"], {}, "moe_not_ported"),
    (["--prefill-seq-parallel", "true"], {}, "longctx_not_ported"),
    (["--serve-role", "prefill"], {}, "disagg_not_ported"),
    (["--serve-role", "decode"], {}, "disagg_not_ported"),
    (["--serve-role", "router"], {}, "router_not_ported"),
    (["--kv-tier-host-pages", "8"], {}, "kv_tiers_not_ported"),
    (["--kv-tier-disk-dir", "tier", "--kv-tier-disk-pages", "8"], {},
     "kv_tiers_not_ported"),
    (["--prefix-directory", "5"], {}, "prefix_directory_not_ported"),
    ([], {"WEIGHT_FETCH_PEERS": "http://peer:1"}, "weight_fetch_not_ported"),
    (_checkpoint, {}, "checkpoint_not_ported"),
    (["--profile-dir", "prof"], {}, "profile_not_ported"),
    ([], {"TPU_PROFILE_DIR": "prof"}, "profile_not_ported"),
    ([], {"JAX_COORDINATOR_ADDRESS": "pod-0:1", "JAX_PROCESS_ID": "0",
          "JAX_NUM_PROCESSES": "2"}, "not_ported"),
]


@pytest.mark.parametrize("args,env,code", REFUSALS,
                         ids=[f"{c}-{i}" for i, (_, _, c) in
                              enumerate(REFUSALS)])
def test_unported_knob_exits_2_with_its_code(args, env, code, tmp_path,
                                             capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if callable(args):
        args = args(tmp_path)
    rc = tworker.main(["llama", "--device", "cpu", "--serve", "--slots",
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
