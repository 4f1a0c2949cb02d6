"""Rank functions of the port's data-parallel CPU tests: each runs in one
member of a gang that ``parallel.distributed.launch_local`` starts, so
this module imports torch and the port only, never JAX. Inputs come from
a ``torch.save`` file the test writes; results go back as numpy arrays
and plain Python values."""

import hashlib
import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcos_commons_tpu_torch.frameworks import worker  # noqa: E402
from dcos_commons_tpu_torch.models import llama as tl  # noqa: E402
from dcos_commons_tpu_torch.models import resnet as tr  # noqa: E402
from dcos_commons_tpu_torch.models import speculative as tspec  # noqa: E402
from dcos_commons_tpu_torch.models import train as tt  # noqa: E402
from dcos_commons_tpu_torch.parallel import distributed  # noqa: E402
from dcos_commons_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy().copy()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _digest(*trees) -> str:
    """The bytes of every leaf, in key order."""
    h = hashlib.sha1()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(t.detach().contiguous().numpy().tobytes())

    for t in trees:
        walk(t)
    return h.hexdigest()


def battery(path: str) -> dict:
    """Everything one gang member computes for ``tests/test_torch_dp.py``
    on ``MeshSpec(dp=world)``: ResNet's first pass (loss, accuracy,
    batch-norm state and the averaged gradients), its train steps, and,
    where the inputs hold them, distill and llama-train steps."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    mesh = MeshSpec(dp=int(os.environ[distributed.NUM_PROCESSES_ENV])
                    ).build("cpu")
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "resnet": _resnet(inputs["resnet"], mesh)}
    for case, spec in inputs.get("distill", {}).items():
        out.setdefault("distill", {})[case] = _distill(spec, mesh)
    for case, spec in inputs.get("llama_train", {}).items():
        out.setdefault("llama_train", {})[case] = _llama_train(spec, mesh)
    return out


def _resnet(spec: dict, mesh) -> dict:
    cfg = tr.ResNetConfig(**spec["cfg"])
    dp, r = mesh.shape["dp"], mesh.coords["dp"]
    x, y = spec["x"], spec["y"]
    b = x.shape[0] // dp
    batch = (torch.from_numpy(x[r * b:(r + 1) * b]),
             torch.from_numpy(y[r * b:(r + 1) * b]))

    params, state = _clone(spec["params"]), _clone(spec["state"])
    leaves = tt._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, (acc, new_state) = tr.loss_fn(cfg, params, state, batch, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    grads, (loss, acc) = mesh.reduce_grads(grads, (loss.detach(),
                                                   acc.float()), 1.0 / dp)
    res = {"loss": float(loss), "acc": float(acc),
           "state": _np(new_state),
           "grads": dict(zip(_flat_keys(params),
                             [g.numpy().copy() for g in grads]))}

    opt = tt.make_optimizer(**spec["opt"])
    step = tt.make_train_step(
        lambda p, bb: tr.loss_fn(cfg, p, bb[0], bb[1], mesh=mesh), opt,
        has_aux_state=True, mesh=mesh)
    params, state = _clone(spec["params"]), _clone(spec["state"])
    opt_state = tt.init_opt_state(opt, params)
    steps, counts = [], []
    for _ in range(spec["steps"]):
        before = mesh.collectives
        params, opt_state, state, o = step(params, opt_state,
                                           (state, batch))
        counts.append(mesh.collectives - before)
        steps.append((float(o["loss"]), _np(params), _np(opt_state.mu),
                      _np(opt_state.nu), _np(state), opt_state.count))
    res.update(steps=steps, collectives_per_step=counts,
               digest=_digest(params, opt_state.mu, opt_state.nu, state))
    return res


def _flat_keys(tree, prefix=""):
    """Leaf names in ``train._leaves`` order (dict insertion order)."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flat_keys(v, f"{prefix}{k}/")
        else:
            out.append(f"{prefix}{k}")
    return out


def _distill(spec: dict, mesh) -> dict:
    cfg_t = tl.LlamaConfig.tiny(**spec["cfg"])
    params_t = spec["params"]
    cfg_d, params_d = tspec.draft_student(cfg_t, params_t, spec["layers"])
    loss_fn = tspec.distill_loss(cfg_t, params_t, cfg_d, 1.0)
    opt = tt.make_optimizer(**spec["opt"])
    step = tt.make_train_step(loss_fn, opt, mesh=mesh, batch_spec=None)
    state = tt.init_opt_state(opt, params_d)
    toks = torch.from_numpy(spec["toks"])
    losses = []
    for _ in range(spec["steps"]):
        params_d, state, o = step(params_d, state, toks)
        losses.append(float(o["loss"]))
    return {"losses": losses, "params": _np(params_d),
            "rows": tt.dp_rows(toks.shape[0], mesh),
            "digest": _digest(params_d, state.mu, state.nu)}


def _llama_train(spec: dict, mesh) -> dict:
    cfg = tl.LlamaConfig.tiny(**spec["cfg"])
    params = _clone(spec["params"])
    opt = tt.make_optimizer(**spec["opt"])
    step = tt.make_train_step(lambda p, b: tl.loss_fn(cfg, p, b), opt,
                              grad_accum=spec["grad_accum"], mesh=mesh,
                              batch_spec=None)
    state = tt.init_opt_state(opt, params)
    toks = torch.from_numpy(spec["toks"])
    losses = []
    for _ in range(spec["steps"]):
        params, state, o = step(params, state, toks)
        losses.append(float(o["loss"]))
    return {"losses": losses, "params": _np(params), "mu": _np(state.mu),
            "nu": _np(state.nu),
            "digest": _digest(params, state.mu, state.nu)}


# ---------------------------------------------------------------------------
# the mesh itself (tests/test_torch_mesh.py)


def mesh_battery(path: str) -> dict:
    """On a gang of 4: ``MeshSpec(dp=2, dcn=2)`` and ``MeshSpec(dp=2,
    tp=2)``'s coordinates and each axis's group (the sum of the ranks
    over it), and on ``MeshSpec(dp=4)`` the gradient through
    ``all_reduce_mean`` of a local weighted sum."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    rank = int(os.environ[distributed.PROCESS_ID_ENV])
    out = {"rank": rank}
    one = torch.tensor([float(rank)])
    m = MeshSpec(dp=2, dcn=2).build("cpu")
    out["dcn"] = {"shape": m.shape, "coords": m.coords, "rank": m.rank,
                  "dp_sum": float(m.all_reduce(one.clone(), "dp"))}
    m = MeshSpec(dp=2, tp=2).build("cpu")
    out["dp_tp"] = {"shape": m.shape, "coords": m.coords, "rank": m.rank,
                    "dp_sum": float(m.all_reduce(one.clone(), "dp")),
                    "tp_sum": float(m.all_reduce(one.clone(), "tp")),
                    "tp_gather": m.all_gather(one.clone(), "tp").tolist()}
    m = MeshSpec(dp=4).build("cpu")
    own = inputs["x"][rank].copy()
    x = torch.from_numpy(inputs["x"][rank]).requires_grad_(True)
    w = torch.from_numpy(inputs["w"][rank])
    y = m.all_reduce_mean(x, "dp")
    out["x_after_forward"] = x.detach().numpy().copy()
    (gx,) = torch.autograd.grad((w * y.square()).sum(), x)
    out["mean"] = y.detach().numpy()
    out["grad"] = gx.numpy()
    out["collectives"] = m.collectives
    # the add's backward hands one cotangent to both of its branches
    x = torch.from_numpy(own).requires_grad_(True)
    (gx,) = torch.autograd.grad((w * (m.all_reduce_mean(x, "dp") + x)).sum(),
                                x)
    out["grad_shared"] = gx.numpy()
    out["own"] = own
    return out


# ---------------------------------------------------------------------------
# the worker on a gang (tests/test_torch_worker_dp.py)


def _main(argv, env=None) -> list:
    """``worker.main(argv)``'s exit code and JSON events, with ``env``
    set around it."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = worker.main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    events = [json.loads(line) for line in buf.getvalue().splitlines()
              if line.startswith("{")]
    return [rc, events]


def worker_runs(base: str, runs: list) -> list:
    """Run each ``(name, argv, env, drop_newest)`` in order on this rank,
    with ``--out`` at ``base/<name's volume>/r<rank>`` (each rank its own
    volume); ``drop_newest`` lists the ranks that delete their newest
    step directory before the run. Returns ``[rc, events, steps on
    disk]`` per run."""
    import torch.distributed as dist
    rank = int(os.environ[distributed.PROCESS_ID_ENV])
    out = []
    for vol, argv, env, drop_newest in runs:
        d = os.path.join(base, vol, f"r{rank}")
        if rank in drop_newest:
            steps = sorted(n for n in os.listdir(d) if n.startswith("step-"))
            shutil.rmtree(os.path.join(d, steps[-1]))
        if dist.is_initialized():
            dist.barrier()
        rc, events = _main([*argv, "--out", d], env)
        out.append([rc, events, sorted(n for n in os.listdir(d)
                                       if n.startswith("step-"))
                    if os.path.isdir(d) else []])
    return out
