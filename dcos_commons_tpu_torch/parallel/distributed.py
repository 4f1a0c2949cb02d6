"""The scheduler's rank contract, read by the port's worker (port of
``dcos_commons_tpu/parallel/distributed.py``).

The scheduler's matcher exports into every task sandbox:

    JAX_COORDINATOR_ADDRESS   host:port of pod instance 0
    JAX_PROCESS_ID            == POD_INSTANCE_INDEX
    JAX_NUM_PROCESSES         pod count
    TPU_SLICE_TOPOLOGY        e.g. "4x4" (informational)

The port reads the same variables, so the scheduler needs no edit. A
single process needs no process group. A gang of processes would map the
contract onto ``torch.distributed.init_process_group`` (``tcp://`` the
coordinator, the world size, the rank); that waits for tensor
parallelism (ROADMAP Queue 1 item 7), and :func:`initialize` refuses it.
"""

from __future__ import annotations

import os
from typing import Optional

COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
PROCESS_ID_ENV = "JAX_PROCESS_ID"
NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"
TOPOLOGY_ENV = "TPU_SLICE_TOPOLOGY"


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
    """The parsed contract, or the reference's synthesized
    single-process one. More than one process raises: the process group
    and the sharded engines it would serve are not ported yet."""
    contract = env_contract(environ)
    if contract is None or contract["num_processes"] <= 1:
        return contract or {"coordinator_address": None, "process_id": 0,
                            "num_processes": 1, "topology": None}
    raise NotImplementedError(
        f"{contract['num_processes']} processes: multi-process gangs "
        "(torch.distributed with NCCL, tensor-parallel serving) are not "
        "ported yet (ROADMAP Queue 1 item 7)")
