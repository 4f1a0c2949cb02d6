"""The scheduler's rank contract and the process group it forms (port of
``dcos_commons_tpu/parallel/distributed.py``).

The scheduler's matcher exports into every task sandbox:

    JAX_COORDINATOR_ADDRESS   host:port of pod instance 0
    JAX_PROCESS_ID            == POD_INSTANCE_INDEX
    JAX_NUM_PROCESSES         pod count
    TPU_SLICE_TOPOLOGY        e.g. "4x4" (informational)

The port reads the same variables, so the scheduler needs no edit. A
single process needs no process group. A gang maps the contract onto
``torch.distributed.init_process_group`` over gloo (``tcp://`` the
coordinator, the world size, the rank): the host collectives of the gang
(the rank-0 intake broadcast, the checkpoint step agreement) run there,
and ``parallel.mesh.MeshSpec.build`` adds an NCCL group for the device
collectives when the layout allows one.

:func:`launch_local` starts a gang of processes on this host with the
contract set, each running one function: the CPU tests' and the smoke's
gangs.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Any, Callable, List, Optional

log = logging.getLogger(__name__)

COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
PROCESS_ID_ENV = "JAX_PROCESS_ID"
NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"
TOPOLOGY_ENV = "TPU_SLICE_TOPOLOGY"
# seconds a collective waits for the slowest member before it raises
DEFAULT_TIMEOUT_S = 1800.0


def env_contract(environ=None) -> Optional[dict]:
    """Parse the bootstrap contract from ``environ``; None if absent."""
    env = os.environ if environ is None else environ
    addr = env.get(COORDINATOR_ENV)
    if not addr:
        n = int(env.get(NUM_PROCESSES_ENV, "1"))
        if n > 1:
            raise RuntimeError(
                f"{NUM_PROCESSES_ENV}={n} but {COORDINATOR_ENV} is unset/"
                "empty — refusing to run an unsynchronized multi-process "
                "job as single-process")
        return None
    return {
        "coordinator_address": addr,
        "process_id": int(env.get(PROCESS_ID_ENV, "0")),
        "num_processes": int(env.get(NUM_PROCESSES_ENV, "1")),
        "topology": env.get(TOPOLOGY_ENV),
    }


def initialize(environ=None) -> dict:
    """Form the gloo process group when the contract asks for more than
    one process, and return the parsed contract (or the reference's
    synthesized single-process one). A second call in the same process
    returns the contract and forms nothing twice."""
    import torch.distributed as dist

    contract = env_contract(environ)
    if contract is None or contract["num_processes"] <= 1:
        return contract or {"coordinator_address": None, "process_id": 0,
                            "num_processes": 1, "topology": None}
    if not dist.is_initialized():
        dist.init_process_group(
            backend="gloo",
            init_method="tcp://" + contract["coordinator_address"],
            rank=contract["process_id"],
            world_size=contract["num_processes"],
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        log.info("process group up: process %d/%d via %s",
                 contract["process_id"], contract["num_processes"],
                 contract["coordinator_address"])
    elif (dist.get_rank(), dist.get_world_size()) != (
            contract["process_id"], contract["num_processes"]):
        raise RuntimeError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the contract says "
            f"{contract['process_id']} of {contract['num_processes']}")
    return contract


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# what each member of launch_local's gang runs: load the call, form the
# group, run it, write (status, value) back
_BOOTSTRAP = """
import os, pickle, sys, traceback
with open(sys.argv[1], "rb") as f:
    path, module, main_file, name, args, threads = pickle.load(f)
sys.path[:0] = path
status, value = "ok", None
try:
    import importlib, importlib.util
    if main_file:
        spec = importlib.util.spec_from_file_location("_gang_main", main_file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    fn = mod
    for part in name.split("."):
        fn = getattr(fn, part)
    import torch
    if threads:
        torch.set_num_threads(threads)
    from dcos_commons_tpu_torch.parallel import distributed
    distributed.initialize()
    value = fn(*args)
except BaseException as e:
    status, value = "error", repr(e) + "\\n" + traceback.format_exc()
finally:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
with open(sys.argv[2] + ".tmp", "wb") as f:
    pickle.dump((status, value), f)
os.replace(sys.argv[2] + ".tmp", sys.argv[2])
"""


def launch_local(fn: Callable[..., Any], world: int, *args: Any,
                 timeout_s: float = 600.0, threads: int = 0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` fresh interpreters on this host, each
    with the rank contract in its environment and the process group
    formed (no fork after CUDA is up); returns each rank's result in rank
    order. ``fn`` is found by module and name (a function of the script
    being run is loaded from its file, whose top level must be guarded by
    ``__main__``), so it must import without JAX; ``args`` and the results
    cross by pickle. A rank that fails, or a gang that outlives
    ``timeout_s``, raises here after every member is stopped.
    ``threads`` > 0 caps each member's intra-op threads."""
    import pickle
    import subprocess
    import sys
    import tempfile
    import time

    main_file = None
    if fn.__module__ == "__main__":
        main_file = os.path.abspath(sys.modules["__main__"].__file__)
    addr = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="gang-") as tmp:
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((list(sys.path), fn.__module__, main_file,
                         fn.__qualname__, args, threads), f)
        procs, outs = [], []
        for r in range(world):
            env = dict(os.environ, **{COORDINATOR_ENV: addr,
                                      PROCESS_ID_ENV: str(r),
                                      NUM_PROCESSES_ENV: str(world)})
            outs.append(os.path.join(tmp, f"rank{r}.pkl"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _BOOTSTRAP, call, outs[-1]],
                env=env))
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)
                          or (p.poll() == 0 and _failed(outs[r]))]
                if failed:
                    break        # its peers wait in a collective: stop them
                if time.monotonic() > deadline:
                    raise TimeoutError(f"gang of {world} still running "
                                       f"after {timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results, errors = [], []
        for r, out in enumerate(outs):
            if not os.path.exists(out):
                errors.append(f"rank {r}: exit {procs[r].returncode}, "
                              "no result")
                continue
            with open(out, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}: {value}")
        if errors:
            raise RuntimeError("gang failed: " + "\n".join(errors))
        return results


def _failed(out: str) -> bool:
    """A finished member's result file says it failed."""
    import pickle
    if not os.path.exists(out):
        return True
    with open(out, "rb") as f:
        return pickle.load(f)[0] != "ok"
