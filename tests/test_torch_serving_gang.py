"""The port's gang serving (``dcos_commons_tpu_torch/models/
serving_gang.py`` and the worker's gang path) against the reference's
``tests/test_serving_gang.py``:

* the intake wire format, byte-equal to the reference's arrays;
* the lock-step driver with one process behind real HTTP, streams
  equal to JAX's solo decode of the same weights; rank 0 alone owns the
  front door, and a gang needs its mesh;
* two port worker processes with the ``JAX_*`` contract on the CPU
  (the twin of ``TestTwoProcessGangServing``): both ranks emit
  ``serving`` with ``gang: true``, rank 0 answers ``POST /v1/generate``
  with the replies of the port's single-process engine on the same seeded
  init, ``/v1/stats`` shows the requests and rank 1's heartbeats carry
  ``gang_iterations``; the same with ``--quant int8`` (each rank's
  shard of the quantized tree), with a gang checkpoint restored from
  ``--out``, and with ``--pages`` and ``--serve-role decode`` (its
  ``disagg_fallback``, then the paged engine's tp stats);
* the worker's refusals on a gang, made before any process group forms.
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving_gang as jgang
from dcos_commons_tpu_torch.frameworks import worker as tworker
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models import serving_gang as tgang
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.ingress import ServingFrontend
from dcos_commons_tpu_torch.parallel import checkpoint as tc
from dcos_commons_tpu_torch.parallel import mesh as tmesh
from dcos_commons_tpu_torch.parallel.distributed import free_port

REPO = str(Path(__file__).resolve().parent.parent)


@pytest.mark.parametrize("items,max_intake,max_prompt", [
    ([([1, 2, 3], 16), ([9], 4)], 4, 8),
    ([], 2, 4),
    ([([7] * 8, 1)], 1, 8)])
def test_intake_wire_format_matches_the_reference(items, max_intake,
                                                  max_prompt):
    arr = tgang.encode_intake(items, max_intake, max_prompt)
    want = jgang.encode_intake(items, max_intake, max_prompt)
    assert arr.dtype == want.dtype and arr.tobytes() == want.tobytes()
    assert tgang.decode_intake(arr) == jgang.decode_intake(want) == items


def test_intake_limits_match_the_reference():
    for mod in (tgang, jgang):
        with pytest.raises(ValueError, match="max_intake"):
            mod.encode_intake([([1], 1)] * 3, 2, 4)
        with pytest.raises(ValueError, match="prompt length"):
            mod.encode_intake([([1] * 9, 1)], 2, 8)
        with pytest.raises(ValueError, match="prompt length"):
            mod.encode_intake([([], 1)], 2, 8)


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_driver_serves_http_matching_jax_solo_decode():
    """The lock-step loop (one process) behind the front door streams
    exactly JAX's solo decode of the same weights."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                               dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.key(0))
    prompts = [[int(t) for t in np.random.default_rng(60 + i).integers(
        0, 256, 5 + i)] for i in range(3)]
    want = {i: [int(t) for t in jl.generate_stepwise(
        jcfg, jp, jnp.asarray([p], jnp.int32), 6)[0]]
        for i, p in enumerate(prompts)}
    engine = ts.SlotServer(tcfg, params_from_jax(jax.device_get(jp), "cpu"),
                           slots=2, device="cpu")
    fe = ServingFrontend(engine, port=0, host="127.0.0.1")
    fe.start(drive=False)
    driver = tgang.GangServingDriver(engine, fe, num_processes=1,
                                     process_id=0, decode_window=4)
    t = threading.Thread(target=driver.run, daemon=True)
    t.start()
    try:
        got = {i: _post(fe.port, {"prompt": p, "max_new": 6})["tokens"]
               for i, p in enumerate(prompts)}
        assert got == want
        assert _get(fe.port, "/v1/healthz")["ok"] is True
        stats = driver.stats()
        assert stats["gang_iterations"] > 0 and stats["gang_errors"] == 0
        assert stats["requests"] == 3
    finally:
        driver.stop()
        t.join(timeout=10)
        fe.stop()


def test_frontend_belongs_to_rank0_and_a_gang_to_its_mesh():
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = ts.SlotServer(cfg, params, slots=1, device="cpu")
    with pytest.raises(ValueError, match="rank 0"):
        tgang.GangServingDriver(engine, None, num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="needs its mesh"):
        tgang.GangServingDriver(engine, None, num_processes=2,
                                process_id=1)
    one = tmesh.MeshSpec().build("cpu")
    with pytest.raises(ValueError, match="needs its mesh"):
        tgang.GangServingDriver(engine, None, num_processes=2,
                                process_id=1, mesh=one)


def test_peers_clear_finished_and_reset_on_error():
    """A peer (no front door) drops retired streams every iteration, and
    an engine error resets its engine and counts it."""
    cfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = ts.SlotServer(cfg, params, slots=2, device="cpu")
    driver = tgang.GangServingDriver(engine, None, num_processes=1,
                                     process_id=1, idle_sleep_s=0)
    engine.submit([1, 2, 3], max_new=2, request_id="a")
    driver.run(max_iterations=3)
    assert engine.finished == {} and not engine.requests_active()
    calls = []

    def boom(k):
        calls.append(k)
        raise RuntimeError("collective failed")

    engine.submit([1, 2, 3], max_new=4, request_id="b")
    engine.step_many = boom
    driver.run(max_iterations=4)
    assert driver.errors == 1 and calls == [8]
    assert engine.free_slots() == [0, 1]


# ---------------------------------------------------------------------------
# two port workers


WORKER = [sys.executable, "-m", "dcos_commons_tpu_torch.frameworks.worker",
          "llama", "--device", "cpu", "--serve", "--slots", "2",
          "--serve-interval", "0.5", "--decode-window", "4", "--gen-len",
          "4", "--serve-port", "0"]


class _Gang:
    """Two worker processes with the rank contract, their events pumped
    into one queue."""

    def __init__(self, tmp_path, extra=(), env=None):
        port = free_port()
        self.events = queue.Queue()
        self.procs = []
        for rank in range(2):
            cwd = tmp_path / f"r{rank}"
            cwd.mkdir(exist_ok=True)
            penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                        JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES="2",
                        POD_INSTANCE_INDEX=str(rank), **(env or {}))
            proc = subprocess.Popen([*WORKER, *extra], cwd=cwd, env=penv,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL, text=True)
            self.procs.append(proc)
            threading.Thread(target=self._pump, args=(proc, rank),
                             daemon=True).start()
        self.seen = []

    def _pump(self, proc, rank):
        for raw in proc.stdout:
            try:
                self.events.put((rank, json.loads(raw)))
            except json.JSONDecodeError:
                pass

    def wait(self, pred, timeout=240):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                rank, e = self.events.get(timeout=2)
            except queue.Empty:
                assert all(p.poll() is None for p in self.procs), \
                    [p.poll() for p in self.procs]
                continue
            self.seen.append((rank, e))
            if pred(rank, e):
                return rank, e
        raise AssertionError(f"timed out; saw {self.seen[-6:]}")

    def serving(self):
        ports = {}
        while len(ports) < 2:
            rank, e = self.wait(lambda r, e: e.get("event") == "serving")
            assert e["gang"] is True and e["tp"] == 2
            assert e["process_id"] == rank
            assert e["mesh"] == {"backend": "gloo", "device": "cpu"}
            ports[rank] = e.get("port")
        return ports[0]

    def stop(self):
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8], [9]]


def _single_process_replies(pages=None, int8=False):
    """The port's one-process engine on the worker's seeded init."""
    cfg = tl.LlamaConfig.tiny()
    if int8:
        params = tl.init_quantized_params(
            cfg, torch.Generator().manual_seed(0), "cpu")
    else:
        params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if pages:
        srv = ts.PagedServer(cfg, params, slots=2, pages=pages, device="cpu")
    else:
        srv = ts.SlotServer(cfg, params, slots=2, device="cpu")
    got = srv.drain([{"prompt": p, "max_new": 6, "request_id": i}
                     for i, p in enumerate(PROMPTS)], decode_window=4)
    return [got[i] for i in range(len(PROMPTS))]


def _serve_and_check(gang, want):
    port = gang.serving()
    got = [_post(port, {"prompt": p, "max_new": 6})["tokens"]
           for p in PROMPTS]
    again = _post(port, {"prompt": PROMPTS[0], "max_new": 6})["tokens"]
    assert got == want and again == want[0]
    stats = _get(port, "/v1/stats")
    assert stats["requests"] == len(PROMPTS) + 1
    gang.wait(lambda r, e: r == 1 and e.get("event") == "heartbeat"
              and e.get("gang_iterations", 0) > 0 and e["gang_errors"] == 0)
    assert all(p.poll() is None for p in gang.procs)


@pytest.mark.parametrize("extra", [(), ("--quant", "int8")],
                         ids=["slots", "int8"])
def test_two_workers_serve_http_as_a_gang(tmp_path, extra):
    gang = _Gang(tmp_path, extra)
    try:
        _serve_and_check(gang, _single_process_replies(
            int8="int8" in extra))
    finally:
        gang.stop()


def test_gang_restores_its_shards_from_out(tmp_path, monkeypatch):
    """Each rank's ``--out`` step directory (saved here rank by rank)
    boots that rank: ``weights_loaded`` ``source: disk``."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = tmp_path / "vol"
    for rank in range(2):
        mesh = tmesh.Mesh({**{a: 1 for a in tmesh.AXES}, "tp": 2},
                          {**{a: 0 for a in tmesh.AXES}, "tp": rank},
                          torch.device("cpu"), "gloo", rank=rank)
        monkeypatch.setattr(tc, "_process_id", lambda r=rank: r)
        monkeypatch.setattr(tc, "_num_processes", lambda: 2)
        tc.save_sharded(str(out), 3, tl.shard_params(params, mesh, cfg),
                        mesh=mesh, specs=tl.param_specs(cfg))
    monkeypatch.undo()
    gang = _Gang(tmp_path, ("--out", str(out)))
    try:
        for _ in range(2):
            _, e = gang.wait(lambda r, e: e.get("event") == "weights_loaded")
            assert e["source"] == "disk" and e["step"] == 3
        _serve_and_check(gang, _single_process_replies())
    finally:
        gang.stop()


def test_gang_decode_role_falls_back_to_colocated_paged(tmp_path):
    """``--serve-role decode`` on a gang serves co-located, on the paged
    engine (``--pages``) with its tp stats."""
    gang = _Gang(tmp_path, ("--pages", "64", "--serve-role", "decode",
                            "--serve-peer", "http://127.0.0.1:9"))
    try:
        for _ in range(2):
            _, e = gang.wait(lambda r, e: e.get("event") ==
                             "disagg_fallback")
            assert e["role"] == "decode"
            assert "single-process replica" in e["reason"]
        _serve_and_check(gang, _single_process_replies(64))
        paged = [e for r, e in gang.seen if e.get("event") == "serving"
                 and r == 0][0]["paged"]
        assert paged["tp"] == 2 and paged["graphs_off"] == "tp"
    finally:
        gang.stop()


GANG_ENV = {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_PROCESS_ID": "0",
            "JAX_NUM_PROCESSES": "2"}


# (MoE serving on a gang, --pp and --ep were refused here until the ep
# and pp axes; tests/test_torch_worker_ep_pp.py runs them, and holds the
# one refusal left of them, experts the gang does not divide, first
# below; the ids keep the cases' names)
@pytest.mark.parametrize("workload,args,env,code", [
    ("llama", ["--pages", "64", "--moe-experts", "3"], {},
     "moe_ep_indivisible"),
    ("llama", [], {"WEIGHT_FETCH_PEERS": "http://127.0.0.1:9"},
     "peer_weights_not_ported"),
    ("llama", [], {"WEIGHT_SERVE_PORT": "0"}, "peer_weights_not_ported"),
    ("llama-train", ["--sp", "1", "--tp", "2"], {"RESHARD_ENABLE": "1"},
     "reshard_not_ported")],
    ids=["llama-args0-env0-moe_ep_indivisible",
         "llama-args1-env1-peer_weights_not_ported",
         "llama-args2-env2-peer_weights_not_ported",
         "llama-train-args4-env4-reshard_not_ported"])
def test_gang_refusals_come_before_the_process_group(workload, args, env,
                                                     code, tmp_path, capsys,
                                                     monkeypatch):
    """Exit 2 with a coded error naming its ROADMAP item; no process
    group is formed (the coordinator address is a closed port)."""
    monkeypatch.chdir(tmp_path)
    for k, v in {**GANG_ENV, **env}.items():
        monkeypatch.setenv(k, v)
    serve = ["--serve", "--slots", "2", "--gen-len", "2"] \
        if workload == "llama" else []
    rc = tworker.main([workload, "--device", "cpu", *serve, *args])
    assert rc == 2
    events = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()]
    errors = [e for e in events if e.get("event") == "error"]
    assert len(errors) == 1 and errors[0]["code"] == code
    assert "item" in errors[0]["error"]
    import torch.distributed as dist
    assert not dist.is_initialized()
