"""North-star e2e of the port: a REAL multi-process ``torch.distributed``
gang under the real scheduler + C++ agent stack (the port twin of
``tests/test_gang_e2e.py``, whose assertions it keeps).

Two real ``tpu-agent`` processes register with a live ApiServer; the
deploy plan launches two real worker interpreters of the port
(``dcos_commons_tpu_torch.frameworks.worker``, through the real
``tpu-bootstrap``, which gates rank 1 on the coordinator port). They
read the same ``JAX_*`` contract, form a gloo process group against
pod-0's coordinator (``dcos_commons_tpu_torch/parallel/distributed.py``),
build a 2-process dp mesh (``--device cpu``), and train ResNet with REAL
cross-process batch-norm statistics and gradient all-reduces. One member
is then SIGKILLed mid-training; the scheduler's gang re-form relaunches
BOTH members with stable ranks; the new processes resume from the
sharded checkpoints on their persistent volumes, and the per-step loss
stream proves training *continued* across the re-form instead of
restarting.

The scheduler half is the JAX package's (a test may import it); the
worker the agents launch imports torch and the port only. ``STEPS`` is
cut from the reference test's 30 to 16 (checkpoints every 4 steps) to
keep the test's share of the tier-1 run small.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dcos_commons_tpu.agent import RemoteCluster
from dcos_commons_tpu.http import ApiServer
from dcos_commons_tpu.plan import Status
from dcos_commons_tpu.scheduler import ServiceScheduler
from dcos_commons_tpu.specification import load_service_yaml_str
from dcos_commons_tpu.state import MemPersister, TaskState
from dcos_commons_tpu_torch.parallel.distributed import free_port

NATIVE = Path(__file__).resolve().parent.parent / "native"
BIN = NATIVE / "bin"
REPO = str(Path(__file__).resolve().parent.parent)

STEPS = 16                     # ckpt_every = steps // 4 = 4
CKPT_EVERY = max(1, STEPS // 4)

# The production resnet.yml shape (frameworks/jax/dist/resnet.yml), pinned
# to CPU executors (--device cpu, one intra-op thread): each process is
# one rank of the 2-process dp mesh, exactly like one chip per host on
# hardware. The matcher puts the coordinator on the fixed port 8476 of
# pod 0's host; tests/test_gang_e2e.py's gang binds the same port on the
# same host and may run at the same time, so the task keeps the
# scheduler's host and takes a port that was free when the test began.
GANG_YML = """
name: gang-e2e
pods:
  worker:
    count: 2
    tpu:
      chips: 1
      topology: v4-8
      gang: true
    tasks:
      train:
        goal: RUNNING
        essential: true
        cmd: "export JAX_COORDINATOR_ADDRESS=${JAX_COORDINATOR_ADDRESS%:*}:{{GANG_PORT}} && {{BOOTSTRAP}} --wait-timeout 240 && {{PY}} -m dcos_commons_tpu_torch.frameworks.worker resnet --device cpu --steps {{STEPS}} --batch 2 --depth 18 --lr 0.003 --emit-every 1 --out data/ckpt && sleep 600"
        cpus: 1.0
        memory: 3072
        tpus: 1
        env:
          OMP_NUM_THREADS: "1"
          PYTHONPATH: "{{REPO}}"
        volume:
          path: data
          size: 64
          type: ROOT
"""


@pytest.fixture(scope="module")
def native_bins():
    subprocess.run(["make", "-C", str(NATIVE)], check=True,
                   capture_output=True)
    return BIN


def wait_for(predicate, timeout=60, interval=0.05, message="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def events_for(sandbox_roots, task_id):
    """Parse the worker's JSON event stream out of the task's sandbox
    stdout.log (bootstrap/gloo noise is filtered by the '{' gate)."""
    for root in sandbox_roots:
        f = root / task_id / "stdout.log"
        if not f.exists():
            continue
        out = []
        for line in f.read_text().splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass           # torn tail line; picked up next poll
        return out
    return []


def by_event(events, name):
    return [e for e in events if e.get("event") == name]


def _stop_tasks(sandbox_roots):
    """Kill the process group of every worker a task's events name that
    is still alive (the task's shell and its ``sleep``): stopping the
    agents leaves their tasks running. A pid is taken only while its
    command line is still the port's worker."""
    for root in sandbox_roots:
        for log in root.glob("*/stdout.log"):
            for e in events_for([root], log.parent.name):
                if e.get("event") != "start":
                    continue
                pid = int(e["pid"])
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"dcos_commons_tpu_torch.frameworks.worker" \
                                not in f.read():
                            continue
                    pgid = os.getpgid(pid)
                    if pgid != os.getpgrp():
                        os.killpg(pgid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    continue


def test_port_gang_forms_allreduces_survives_kill_and_resumes(
        native_bins, tmp_path):
    cluster = RemoteCluster(expiry_s=60.0, poll_interval_s=0.05)
    spec = load_service_yaml_str(GANG_YML, {
        "PY": sys.executable, "REPO": REPO, "STEPS": str(STEPS),
        "BOOTSTRAP": str(native_bins / "tpu-bootstrap"),
        "GANG_PORT": str(free_port())})
    sched = ServiceScheduler(spec, MemPersister(), cluster)
    server = ApiServer(sched, port=0, cluster=cluster)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    roots = [tmp_path / "a0", tmp_path / "a1"]
    # both agents report hostname 127.0.0.1 so the coordinator address the
    # matcher derives from pod-0's agent is genuinely routable
    agents = [subprocess.Popen(
        [str(native_bins / "tpu-agent"), "--scheduler", url,
         "--agent-id", f"g{i}", "--hostname", "127.0.0.1",
         "--cpus", "4", "--memory-mb", "8192", "--disk-mb", "10000",
         "--base-dir", str(roots[i]), "--poll-interval", "0.05",
         "--tpu-chips", "1", "--slice-id", "gang-slice",
         "--topology", "v4-8"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for i in range(2)]
    names = ("worker-0-train", "worker-1-train")
    from dcos_commons_tpu.testing import diag
    diag.register_http(url, sandbox_roots=roots)
    try:
        def deployed():
            sched.run_cycle()
            return sched.plan("deploy").status is Status.COMPLETE
        wait_for(deployed, timeout=90, message="gang deploy")
        gen1 = {n: sched.state.fetch_task(n).task_id for n in names}

        # ---- phase 1: the gang actually trains, in lock-step -----------
        # wait until rank 1 has compiled, stepped past the first
        # checkpoint boundary, and told us its interpreter pid
        def victim_ready():
            ev = events_for(roots, gen1["worker-1-train"])
            starts = by_event(ev, "start")
            prog = by_event(ev, "progress")
            if starts and any(p["step"] > CKPT_EVERY for p in prog):
                return starts[0]["pid"]
            return None
        # generous: two interpreters import torch, form the gang, and
        # run the warm-up step before the first progress line
        victim_pid = wait_for(victim_ready, timeout=420, interval=0.05,
                              message="rank 1 past first checkpoint")

        # ---- phase 2: fault injection — kill one member mid-training ---
        os.kill(victim_pid, signal.SIGKILL)

        def reformed():
            sched.run_cycle()
            for n in names:
                t = sched.state.fetch_task(n)
                if t is None or t.task_id == gen1[n]:
                    return False
                s = sched.state.fetch_status(n)
                if s is None or s.task_id != t.task_id \
                        or s.state is not TaskState.RUNNING:
                    return False
            return True
        wait_for(reformed, timeout=300, interval=0.05,
                 message="gang re-form relaunched both members")
        gen2 = {n: sched.state.fetch_task(n).task_id for n in names}
        assert set(gen2.values()).isdisjoint(set(gen1.values()))

        # ---- phase 3: the new gang resumes and finishes the job --------
        def all_done():
            sched.run_cycle()   # keep status/recovery machinery live
            return all(by_event(events_for(roots, gen2[n]), "done")
                       for n in names)
        wait_for(all_done, timeout=420, interval=0.2,
                 message="resumed gang finished training")

        ev1 = {n: events_for(roots, gen1[n]) for n in names}
        ev2 = {n: events_for(roots, gen2[n]) for n in names}

        # stable ranks: pod index == process id across generations
        for i, n in enumerate(names):
            for gen in (ev1, ev2):
                assert int(by_event(gen[n], "start")[0]["pod_index"]) == i
            done = by_event(ev2[n], "done")[0]
            assert done["process_id"] == i
            # global batch 4 = 2 per host x 2 processes: each process saw
            # the whole gang through the rank contract
            assert done["global_batch"] == 4
            assert math.isfinite(done["final_loss"])

        # resumed from the checkpoint, not restarted: both members report
        # the same resume step, on a checkpoint boundary, and ran only
        # the remainder
        resumes = {n: by_event(ev2[n], "resumed") for n in names}
        assert all(resumes[n] for n in names), resumes
        steps0 = resumes[names[0]][0]["step"]
        assert steps0 == resumes[names[1]][0]["step"]
        assert steps0 % CKPT_EVERY == 0 and steps0 > 0
        for n in names:
            assert by_event(ev2[n], "done")[0]["steps"] == STEPS - steps0

        # the all-reduce proof: dp ranks share one loss — every common
        # step's loss is identical across the two processes, in BOTH
        # generations
        def loss_by_step(ev):
            return {p["step"]: p["loss"] for p in by_event(ev, "progress")}
        for gen in (ev1, ev2):
            l0, l1 = loss_by_step(gen[names[0]]), loss_by_step(gen[names[1]])
            common = sorted(set(l0) & set(l1))
            assert common, "no common progress steps within a generation"
            for s in common:
                assert abs(l0[s] - l1[s]) <= 1e-5 * max(1.0, abs(l0[s])), (
                    s, l0[s], l1[s])

        # training CONTINUED: gen-2 re-executes the steps after the
        # checkpoint with bitwise-restored params+opt+bn state and the
        # same data, so any step both generations reached must agree on
        # the loss — and the small lr keeps those losses well away from
        # zero, so this equality is a real signal, not 0 == 0
        g1, g2 = loss_by_step(ev1[names[0]]), loss_by_step(ev2[names[0]])
        overlap = sorted(set(g1) & set(g2))
        assert overlap, (sorted(g1), sorted(g2))
        for s in overlap:
            assert g1[s] > 0.05, (s, g1[s])
            assert abs(g1[s] - g2[s]) <= 1e-4 * max(1.0, abs(g1[s])), (
                s, g1[s], g2[s])
        # the stream genuinely trains: first-step loss ~ ln(1000), and
        # it decreases
        full1 = loss_by_step(ev1[names[0]])
        assert full1[1] > 4.0 and min(full1.values()) < full1[1]
        # and gen-2 starts beyond step 1 — it did not train from scratch
        assert min(g2) == steps0 + 1
    finally:
        _stop_tasks(roots)
        for p in agents:
            p.terminate()
        for p in agents:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        server.stop()
