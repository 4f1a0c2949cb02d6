"""The port's worker (``python -m dcos_commons_tpu_torch.frameworks.worker
llama``) against ``frameworks/jax/worker.py``: its flags carry the
reference's names, defaults, types, choices and env knobs; the solo run's
result has the reference's keys; as a subprocess with ``--serve --slots``
(slot and paged engines) it writes ``serving.ready``, emits ``serving``,
answers ``POST /v1/generate`` with the tokens of a port engine built
directly from the same seed, emits heartbeats and exits on SIGTERM; a
page size that does not divide ``max_seq`` falls back to slots; every
knob of a module not ported yet exits 2 with its coded error; the
weight server seeds step 0 and serves it (a taken port is reported); the
disaggregated roles serve as a prefill/decode pair with the co-located
engine's tokens, and each ``disagg_fallback`` reason (and a dead peer)
serves co-located; the KV tier
and prefix-directory knobs build the reference's tier store and
directory (``kv_tier_fallback`` on an unusable disk directory) and the
served ``/v1/stats`` carries the ``kv_tier_*`` gauges.
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
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
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
    "WEIGHT_FETCH_PEERS", "WEIGHT_FETCH_TIMEOUT_S", "WEIGHT_SERVE_PORT",
    "PORT_WEIGHTS",
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
    """``WEIGHT_SERVE_PORT`` with ``--out``: the init-booted replica seeds
    step 0 and serves it (``weight_server`` with ``steps [0]``); a port
    already taken emits ``weight_server_error``, and either way the
    replica serves."""
    with socket.socket() as taken:
        taken.bind(("0.0.0.0", 0))
        taken.listen(1)
        for port, name in (("0", "weight_server"),
                           (str(taken.getsockname()[1]),
                            "weight_server_error")):
            cwd = tmp_path / name
            cwd.mkdir()
            w = _Worker(cwd, "--serve", "--slots", "1", "--serve-port", "0",
                        "--out", "vol", env={"WEIGHT_SERVE_PORT": port})
            try:
                event = w.event(name)
                assert w.event("serving")["slots"] == 1
            finally:
                w.stop()
            if name == "weight_server":
                assert event["steps"] == [0] and event["port"] > 0
                assert (cwd / "vol" / "step-00000000-p0"
                        / "manifest.json").exists()
            else:
                assert "in use" in event["error"]


# (index, workload, args, env, code): the index keeps each case's id as
# it was while speculative decoding, the checkpoint restore, profiling,
# MoE serving, the disaggregated roles (3, 4), the router role (5) and the
# peer weight fetch (9) were refused (a gang serves since the process
# mesh; ResNet across slices (14) trains since the dp axis, and 15,
# tensor-parallel training on a gang, since the tp axis; MoE training
# (1), the pipeline on a gang (15) and MoE on a gang (13) since the ep
# and pp axes: 13 is now a gang that does not divide the experts,
# refused before the process group forms; ring prefill (2) since the sp
# serving gang, tests/test_torch_ring_prefill.py)
REFUSALS = [
    (13, "llama", ["--pages", "64", "--moe-experts", "3"],
     {"JAX_COORDINATOR_ADDRESS": "pod-0:1", "JAX_PROCESS_ID": "0",
      "JAX_NUM_PROCESSES": "2"}, "moe_ep_indivisible"),
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


# ---------------------------------------------------------------------------
# the disaggregated roles


def _direct_paged(prompts, max_new, **kw):
    """The tokens of a paged engine built directly from the worker's seed:
    the co-located ``--pages 64`` worker's replies."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    srv = ts.PagedServer(cfg, params, slots=2, device="cpu",
                         **{"pages": 64, **kw})
    return [srv.drain([{"prompt": p, "max_new": max_new,
                        "request_id": i}], decode_window=8)[i]
            for i, p in enumerate(prompts)]


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/healthz",
                                timeout=20) as r:
        return json.loads(r.read())


SERVE = ["--serve", "--slots", "2", "--serve-port", "0"]
# (name, flags, reason, engine served co-located): each disagg_fallback
# reason of the reference's worker, after which the replica serves
DISAGG_FALLBACKS = [
    ("no_slots", ["--serve", "--slots", "0", "--serve-role", "prefill"],
     "--slots", None),
    ("no_pages", [*SERVE, "--serve-role", "prefill"], "paged-only",
     "slots"),
    ("infeasible", [*SERVE, "--serve-role", "decode", "--pages", "64",
                    "--page-size", "48", "--serve-peer",
                    "http://127.0.0.1:9"], "infeasible", "slots"),
    ("no_peer", [*SERVE, "--serve-role", "decode", "--pages", "64"],
     "serve-peer", "paged"),
]


@pytest.mark.parametrize("flags,reason,engine",
                         [c[1:] for c in DISAGG_FALLBACKS],
                         ids=[c[0] for c in DISAGG_FALLBACKS])
def test_disagg_fallback_serves_colocated(tmp_path, flags, reason, engine):
    """A tier config the reference cannot run emits ``disagg_fallback``
    (``role``, ``reason``) and the replica serves co-located: the slot
    engine, the paged engine, or with ``--slots 0`` the heartbeat
    decode."""
    w = _Worker(tmp_path, *flags)
    try:
        fb = w.event("disagg_fallback")
        assert sorted(fb) == ["event", "reason", "role"]
        assert reason in fb["reason"] and fb["role"] in ("prefill",
                                                         "decode")
        serving = w.event("serving")
        assert "role" not in serving
        if engine is None:
            assert serving["slots"] == 0
            w.event("heartbeat")
        else:
            assert ("paged" in serving) == (engine == "paged")
            got = _post(serving["port"], {"prompt": PROMPTS[0],
                                          "max_new": 4})["tokens"]
            if engine == "paged":
                assert [got] == _direct_paged(PROMPTS[:1], 4)
            else:
                assert len(got) == 4
    finally:
        w.stop()


@pytest.mark.parametrize("peer", ["prefill_worker", "dead"])
def test_disagg_pair_serves_the_colocated_tokens(tmp_path, peer):
    """A prefill worker and a decode worker pointed at it: the decode
    front door answers the co-located ``--pages 64`` engine's tokens,
    its heartbeat counts the shipped spans and no fallback, and the
    prefill tier's ``/v1/healthz`` and heartbeat name its role. Pointed
    at a dead peer instead, the decode worker serves every request
    co-located and counts each in ``peer_fallbacks``."""
    workers = []
    try:
        if peer == "dead":
            url = "http://127.0.0.1:9"
        else:
            (tmp_path / "prefill").mkdir()
            workers.append(_Worker(tmp_path / "prefill", *SERVE,
                                   "--pages", "64", "--serve-role",
                                   "prefill"))
            pre = workers[0].event("serving")
            assert pre["role"] == "prefill" and pre["paged"]["pages"] == 64
            assert (tmp_path / "prefill" / "serving.ready").read_text() == \
                f"ok {pre['port']}\n"
            url = f"http://127.0.0.1:{pre['port']}"
        (tmp_path / "decode").mkdir()
        dec = _Worker(tmp_path / "decode", *SERVE, "--pages", "64",
                      "--serve-role", "decode", "--serve-peer", url)
        workers.append(dec)
        serving = dec.event("serving")
        assert serving["role"] == "decode" and serving["peers"] == [url]
        assert serving["peer"] == url and "cold_start" in serving
        got = [_post(serving["port"], {"prompt": p, "max_new": 6})["tokens"]
               for p in PROMPTS]
        assert _healthz(serving["port"])["ok"]
        hb = dec.event("heartbeat", where=lambda e: e.get("requests") == 2)
        assert hb["role"] == "decode" and hb["tokens"] == 12
        shipped = 0 if peer == "dead" else 2
        assert hb["disagg"]["spans_shipped"] == shipped
        assert hb["disagg"]["peer_fallbacks"] == 2 - shipped
        assert hb["paged"]["adopted_spans"] == shipped
        if peer != "dead":
            hz = _healthz(pre["port"])
            assert hz["role"] == "prefill" and hz["ok"]
            assert hz["shipped_spans"] == 2
            beat = workers[0].event("heartbeat",
                                    where=lambda e: e["shipped_spans"] == 2)
            assert beat["role"] == "prefill"
        for w in workers:
            assert w.stop() == -signal.SIGTERM
    finally:
        for w in workers:
            if w.proc.poll() is None:
                w.proc.kill()
    assert got == _direct_paged(PROMPTS, 6)


# ---------------------------------------------------------------------------
# the KV hierarchy knobs


# (index, name, flags): the index keeps each case's id as it was while
# the knobs were refused ("{dir}" is the test's own directory)
KV_TIER_CASES = [
    (6, "kv_tiers", ["--kv-tier-host-pages", "8"]),
    (7, "kv_tier_disk", ["--kv-tier-disk-dir", "{dir}/tier",
                         "--kv-tier-disk-pages", "8"]),
    (8, "prefix_directory", ["--prefix-directory", "5"]),
]


def _tier_engines(capsys, argv):
    """The port's and the reference's ``_make_serving_engine`` on the
    same flags, each on its own tiny engine, with each one's events."""
    targs = tworker.build_parser().parse_args(["llama", *argv])
    tcfg = tl.LlamaConfig.tiny()
    tparams = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    engine, stats = tworker._make_serving_engine(targs, tcfg, tparams, "cpu")
    ours = _events(capsys)
    jargs = jworker.build_parser().parse_args(["llama", *argv])
    jcfg = jl.LlamaConfig.tiny()
    jengine, jstats = jworker._make_serving_engine(
        jargs, jcfg, jl.init_params(jcfg, jax.random.key(0)),
        types.SimpleNamespace(size=1))
    return engine, stats, ours, jengine, jstats, _events(capsys)


@pytest.mark.parametrize("name,flags", [c[1:] for c in KV_TIER_CASES],
                         ids=[f"{c[1]}-{c[0]}" for c in KV_TIER_CASES])
def test_kv_tier_knobs_build_the_reference_engine(tmp_path, capsys, name,
                                                  flags):
    """``--kv-tier-host-pages`` builds a host ``PageTierStore``,
    ``--kv-tier-disk-*`` one that spills to the directory, and
    ``--prefix-directory`` wires a ``PrefixDirectory`` and
    ``fetch_prefix``, each as the reference's worker does."""
    from dcos_commons_tpu_torch.models.disagg import fetch_prefix
    flags = [f.format(dir=tmp_path) for f in flags]
    engine, stats, ours, jengine, jstats, ref = _tier_engines(
        capsys, ["--serve", "--slots", "2", "--pages", "64", *flags])
    assert ours == ref == []
    assert stats["tiers"] == jstats["tiers"]
    assert stats["directory"] == jstats["directory"]
    if name == "prefix_directory":
        assert engine.tiers is None
        assert engine.directory.max_age_s == jengine.directory.max_age_s == 5
        assert engine.peer_fetch is fetch_prefix
        return
    assert engine.directory is None and engine.peer_fetch is None
    prompt = list(range(3, 73))               # one full page of 64
    engine.drain([{"prompt": prompt, "max_new": 2, "request_id": 0}])
    engine._evict(engine.ledger.pages)
    st = engine.tiers.stats()
    assert engine.tier_demoted_pages == 1
    if name == "kv_tiers":
        assert st["host_capacity"] == 8 and st["host_pages"] == 1
        assert st["disk_capacity"] == 0
    else:
        assert st["host_capacity"] == 0 and st["disk_pages"] == 1
        files = [p.name for p in (tmp_path / "tier").iterdir()]
        assert files == [engine.tiers.chains()[0] + ".kvpage"]
    again = engine.drain([{"prompt": prompt, "max_new": 2,
                           "request_id": 1}])
    assert again[1] == again[0] and engine.tier_promoted_pages == 1


def test_unusable_disk_dir_falls_back_to_one_tier(tmp_path, capsys):
    """A disk directory that cannot be made emits ``kv_tier_fallback``
    with the reference's keys and the replica serves single-tier."""
    (tmp_path / "file").write_text("not a directory")
    engine, stats, ours, _, jstats, ref = _tier_engines(
        capsys, ["--serve", "--slots", "2", "--pages", "64",
                 "--kv-tier-host-pages", "4", "--kv-tier-disk-dir",
                 str(tmp_path / "file" / "tier"),
                 "--kv-tier-disk-pages", "8"])
    assert [e["event"] for e in ours] == [e["event"] for e in ref] == [
        "kv_tier_fallback"]
    assert sorted(ours[0]) == sorted(ref[0])
    assert ours[0]["disk_pages"] == 8 and ours[0]["host_pages"] == 4
    assert engine.tiers is None and stats["tiers"] is None is jstats["tiers"]


def test_served_stats_carry_the_kv_tier_gauges(tmp_path):
    """The worker with tiers and a directory: the ``serving`` event's
    page stats hold the tier store, ``/v1/stats`` the ``kv_tier_*``
    gauges, and ``/v1/prefix`` answers the served prompt's cached pages
    as a span."""
    from dcos_commons_tpu_torch.models.disagg import unpack_span
    w = _Worker(tmp_path, "--serve", "--slots", "2", "--serve-port", "0",
                "--pages", "64", "--kv-tier-host-pages", "8",
                "--prefix-directory", "5")
    try:
        serving = w.event("serving")
        assert serving["paged"]["tiers"]["host_capacity"] == 8
        assert serving["paged"]["directory"]["chains"] == 0
        port = serving["port"]
        prompt = list(range(3, 73))
        assert len(_post(port, {"prompt": prompt, "max_new": 3})[
            "tokens"]) == 3
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats",
                                    timeout=20) as r:
            window = json.loads(r.read())["window"]
        assert window["kv_tier_host_capacity"] == 8
        assert window["kv_tier_disk_capacity"] == 0
        for key in ("kv_tier_host_pages", "kv_tier_disk_pages",
                    "kv_tier_hits", "kv_tier_promoted", "kv_tier_demoted"):
            assert window[key] == 0, key
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/prefix",
            data=json.dumps({"prompt": prompt}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=20) as r:
            span = unpack_span(r.read())
        assert span["prompt"] == prompt[:64] and span["first_token"] == -1
    finally:
        w.stop()


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
        args, lambda: template,
        lambda: pytest.fail("restored, not initialised"))
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


def test_no_checkpoint_builds_no_restore_template(tmp_path):
    """Without a checkpoint under ``--out`` (or without ``--out``) the
    weights are the init and no restore template is built: at 8B a
    template is another 16 GB on the card beside the init."""
    init = {"w": torch.zeros(1)}
    for argv in (["llama", "--serve"],
                 ["llama", "--serve", "--out", str(tmp_path / "empty")]):
        args = tworker.build_parser().parse_args(argv)
        params, report = tworker._boot_serving_weights(
            args, lambda: pytest.fail("a template without a checkpoint"),
            lambda: init)
        assert params is init and report["source"] == "init"


def test_a_corrupt_checkpoint_falls_back_to_the_init(tmp_path, capsys):
    _save_jax_checkpoint(tmp_path / "vol")
    shard = tmp_path / "vol" / "step-00000004-p0" / "norm.o0.bin"
    shard.write_bytes(shard.read_bytes()[:-2])
    init = tl.init_params(tl.LlamaConfig.tiny(),
                          torch.Generator().manual_seed(0), device="cpu")
    args = tworker.build_parser().parse_args(
        ["llama", "--serve", "--out", str(tmp_path / "vol")])
    params, report = tworker._boot_serving_weights(
        args, lambda: tl.param_template(tl.LlamaConfig.tiny(), "cpu"),
        lambda: init)
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


# ---------------------------------------------------------------------------
# the router role


@pytest.fixture(scope="module")
def replica():
    """A tiny paged replica behind the port's front door on 127.0.0.1,
    built from the worker's seed: what ``--pages 64`` serves."""
    from dcos_commons_tpu_torch.models.ingress import ServingFrontend
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    srv = ts.PagedServer(cfg, params, slots=2, pages=64, device="cpu")
    fe = ServingFrontend(srv, port=0, host="127.0.0.1").start()
    yield f"http://127.0.0.1:{fe.port}"
    fe.stop()


def _router_stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/routestats",
                                timeout=20) as r:
        return json.loads(r.read())


def test_router_role_relays_a_replica(tmp_path, replica):
    """``--serve-role router`` serves the model-free front door: a
    ``serving`` event with ``role: router``, the replica's own tokens
    relayed through it, a ``role: router`` heartbeat with its route
    stats, and no CUDA touched; no ``router_not_ported`` is left."""
    assert "router_not_ported" not in WORKER_SRC
    w = _Worker(tmp_path, "--serve", "--serve-role", "router",
                "--route-replicas", replica, "--page-size", "64",
                "--serve-port", "0")
    try:
        serving = w.event("serving")
        assert serving["role"] == "router"
        assert serving["replicas"] == [replica]
        assert serving["policy"] == "affinity" and serving["classes"] == []
        port = serving["port"]
        assert (tmp_path / "serving.ready").read_text() == f"ok {port}\n"
        got = [_post(port, {"prompt": p, "max_new": 6}) for p in PROMPTS]
        assert [g["replica"] for g in got] == [replica] * 2
        assert [g["routed"] for g in got] == ["affinity"] * 2
        hb = w.event("heartbeat", where=lambda e: e.get("routed") == 2)
        assert hb["role"] == "router" and hb["dropped_streams"] == 0
        assert hb["cuda_initialized"] is False
        assert w.stop() == -signal.SIGTERM
    finally:
        if w.proc.poll() is None:
            w.proc.kill()
    assert [g["tokens"] for g in got] == _direct_paged(PROMPTS, 6)


def test_router_bad_tenant_classes_serves_open(tmp_path, replica):
    """A ``--tenant-classes`` the parser refuses emits
    ``router_config_error`` and the router serves with admission open;
    a good one sheds a tenant past its burst with the reference's 429."""
    w = _Worker(tmp_path, "--serve", "--serve-role", "router",
                "--route-replicas", replica, "--page-size", "64",
                "--serve-port", "0", "--tenant-classes", "gold:10:50")
    try:
        err = w.event("router_config_error")
        assert "TENANT_CLASSES" in err["error"]
        assert err["tenant_classes"] == "gold:10:50"
        serving = w.event("serving")
        assert serving["classes"] == []
        body = {"prompt": PROMPTS[0], "max_new": 2, "tenant": "t",
                "qos": "gold"}
        for _ in range(3):
            assert len(_post(serving["port"], body)["tokens"]) == 2
        assert _router_stats(serving["port"])["sheds"] == 0
    finally:
        w.stop()
    (tmp_path / "good").mkdir()
    w = _Worker(tmp_path / "good", "--serve", "--serve-role", "router",
                "--route-replicas", replica, "--page-size", "64",
                "--serve-port", "0", "--tenant-classes", "gold:10:0:1")
    try:
        serving = w.event("serving")
        assert serving["classes"] == ["gold"]
        body = {"prompt": PROMPTS[0], "max_new": 2, "tenant": "t",
                "qos": "gold"}
        assert _post(serving["port"], body)["qos"] == "gold"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(serving["port"], body)
        assert e.value.code == 429 and e.value.headers["Retry-After"]
        assert _router_stats(serving["port"])["sheds"] == 1
    finally:
        w.stop()
