"""Rank functions of the port's ring-prefill CPU tests
(``tests/test_torch_ring_prefill.py``): each runs in one member of a gang
that ``parallel.distributed.launch_local`` starts, so this module imports
torch and the port only, never JAX. Inputs come from a ``torch.save``
file the test writes; results go back as numpy arrays and plain Python
values."""

import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcos_commons_tpu_torch.models import llama as tl  # noqa: E402
from dcos_commons_tpu_torch.models import serving as ts  # noqa: E402
from dcos_commons_tpu_torch.parallel import distributed  # noqa: E402
from dcos_commons_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402


def _pool_digest(srv) -> str:
    h = hashlib.blake2s()
    for side in ("k", "v"):
        h.update(srv.pool[side].contiguous().numpy().tobytes())
    return h.hexdigest()


def _engine(case: dict, params, mesh, **kw):
    cfg = tl.LlamaConfig.tiny(**case["cfg"])
    return ts.PagedServer(cfg, params[case["params"]], device="cpu",
                          mesh=mesh, longctx_ring=mesh.shape["sp"],
                          **case["engine"], **kw)


def _drain(srv, reqs) -> dict:
    """Drain ``reqs``; the collectives the decode windows made are
    counted apart from the prefill ticks'."""
    mesh = srv.mesh
    real, window_collectives = srv._window, []

    def window(k, mp):
        before = mesh.collectives
        out = real(k, mp)
        window_collectives.append(mesh.collectives - before)
        return out

    srv._window = window
    got = srv.drain([dict(r) for r in reqs])
    stats = srv.page_stats()
    return {"streams": got, "longctx": stats["longctx"],
            "graphs_off": stats["graphs_off"], "sp": stats["sp"],
            "violations": srv.ledger_violations(),
            "window_collectives": sum(window_collectives),
            "windows": len(window_collectives),
            "digest": _pool_digest(srv),
            "pool": {s: srv.pool[s].numpy().copy() for s in ("k", "v")}}


def _fallback(case: dict, params, mesh) -> dict:
    """The engine case with every prompt's padded length over max_seq (a
    stub of ``ring_pad_len``: the constructor's checks make it
    unreachable for a valid prompt, since sp and the page size divide
    max_seq): no ring runs and no collective is made."""
    srv = _engine(case, params, mesh)
    real = ts.ring_pad_len
    ts.ring_pad_len = lambda n, ring, multiple: srv.cfg.max_seq + multiple
    try:
        before = mesh.collectives
        out = _drain(srv, case["reqs"])
        out["collectives"] = mesh.collectives - before
    finally:
        ts.ring_pad_len = real
    del out["pool"]
    return out


def _resumed(case: dict, params, mesh) -> dict:
    """A long prompt drained alone, then one that shares its leading full
    pages: the second resumes after the radix's pages and stays on
    chunks."""
    srv = _engine(case, params, mesh)
    first = _drain(srv, case["reqs"][:1])
    second = _drain(srv, case["reqs"][1:])
    return {"streams": {**first["streams"], **second["streams"]},
            "longctx": second["longctx"],
            "prefix_hits": srv.page_stats()["prefix_hits"],
            "violations": second["violations"],
            "digest": second["digest"]}


def battery(path: str) -> dict:
    """Everything one gang member computes for the test module, on
    ``MeshSpec(sp=world)``: ``prefill_ring`` on each prompt of this world
    (the rank's hidden states and K/V), then each engine case (the
    streams, the ring's counters, the pool and its digest), the fallback
    and the radix-resumed cases."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    world = int(os.environ[distributed.NUM_PROCESSES_ENV])
    mesh = MeshSpec(sp=world).build("cpu")
    params = inputs["params"]
    out = {"rank": mesh.coords["sp"], "prefill": {}, "engine": {}}
    for name, case in inputs["prefill"].items():
        cfg = tl.LlamaConfig.tiny(**case["cfg"])
        hidden, ks, vs = tl.prefill_ring(
            cfg, params[case["params"]], torch.from_numpy(case["prompt"]),
            mesh)
        out["prefill"][name] = {"hidden": hidden.numpy(), "ks": ks.numpy(),
                                "vs": vs.numpy()}
    for name, case in inputs["engine"].items():
        out["engine"][name] = _drain(_engine(case, params, mesh),
                                     case["reqs"])
    out["fallback"] = _fallback(inputs["fallback"], params, mesh)
    out["resumed"] = _resumed(inputs["resumed"], params, mesh)
    return out


def serve_bf16(path: str) -> dict:
    """The worker gang's engine built directly (the tiny preset's bf16
    weights from seed 0, ``inputs["engine"]``), draining ``inputs["reqs"]``
    one request at a time: the replies the worker gang must give."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    world = int(os.environ[distributed.NUM_PROCESSES_ENV])
    mesh = MeshSpec(sp=world).build("cpu")
    cfg = tl.LlamaConfig.tiny(max_seq=inputs["max_seq"])
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh=mesh)
    srv = ts.PagedServer(cfg, params, device="cpu", mesh=mesh,
                         longctx_ring=world, **inputs["engine"])
    got = [srv.drain([dict(r, request_id=i)])[i]
           for i, r in enumerate(inputs["reqs"])]
    return {"replies": got, "longctx": srv.page_stats()["longctx"]}
