"""Rank functions of the port's expert- and pipeline-parallel CPU tests
(``tests/test_torch_ep_pp.py``): each runs in one member of a gang that
``parallel.distributed.launch_local`` starts, so this module imports
torch and the port only, never JAX. Inputs come from a ``torch.save``
file the test writes; results go back as numpy arrays and plain Python
values."""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcos_commons_tpu_torch.models import llama as tl  # noqa: E402
from dcos_commons_tpu_torch.models import train as tt  # noqa: E402
from dcos_commons_tpu_torch.parallel import checkpoint as tc  # noqa: E402
from dcos_commons_tpu_torch.parallel import distributed  # noqa: E402
from dcos_commons_tpu_torch.parallel import moe as tmoe  # noqa: E402
from dcos_commons_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from dcos_commons_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from tests._torch_tp_train_ranks import _clone, _digest, _flat  # noqa: E402


def _as(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def specs_of(kind: str, cfg) -> dict:
    """The spec tree of a ``kind`` ("moe" or "pipe") model."""
    return (tl.moe_param_specs(cfg) if kind == "moe"
            else tl.pipeline_param_specs(cfg))


def leaf_names(kind: str, cfg, sharded: bool) -> tuple:
    """The flat names of the sharded (or the replicated) leaves."""
    flat = {"embed": specs_of(kind, cfg)["embed"],
            "norm": (), "lm_head": (),
            **{f"layers/{k}": v
               for k, v in specs_of(kind, cfg)["layers"].items()}}
    return tuple(sorted(k for k, v in flat.items()
                        if any(a is not None for a in v) == sharded))


def battery(path: str) -> dict:
    """Everything one gang member computes for the test module: on each
    mesh of ``inputs["meshes"]`` the MoE or pipelined model
    (:func:`_model`); then ``make_moe`` on ``MeshSpec(ep=world)`` and
    ``make_pipeline`` on ``MeshSpec(pp=world)`` for the cases of this
    world size; then the ep and pp collectives with their adjoints."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    world = int(os.environ[distributed.NUM_PROCESSES_ENV])
    out = {"meshes": {}, "moe": {}, "pipe": {}}
    for name, spec in inputs["meshes"].items():
        mesh = MeshSpec(**spec["mesh"]).build("cpu")
        out["meshes"][name] = _model(spec, inputs, mesh)
    ep = MeshSpec(ep=world).build("cpu")
    for case, a in inputs["moe"].items():
        if a["ep"] == world:
            out["moe"][case] = _moe_case(a, ep)
    pp = MeshSpec(pp=world).build("cpu")
    for case, a in inputs["pipe"].items():
        if a["pp"] == world:
            out["pipe"][case] = _pipe_case(a, pp)
    out["collectives"] = _collectives(ep, pp, inputs["collective_inputs"])
    return out


def _grads(fn, tensors):
    ts = [t.clone().requires_grad_(True) for t in tensors]
    value = fn(*ts)
    return value, torch.autograd.grad(value, ts)


def _moe_case(a: dict, mesh) -> dict:
    """``make_moe`` on the rank's experts: the output, the auxiliary loss
    and the gradients of ``sum(out * ct) + aux`` (the rank's own copy of
    the objective, cotangent 1)."""
    cfg = tmoe.MoEConfig(a["experts"], a["capacity_factor"], a["routing"])
    n = a["experts"] // mesh.shape["ep"]
    mine = slice(mesh.coords["ep"] * n, (mesh.coords["ep"] + 1) * n)
    fn = tmoe.make_moe(mesh, cfg)
    res = {}

    def objective(x, rw, wi, wo):
        o, aux = fn(x, rw, wi, wo)
        res["out"], res["aux"] = o.detach().numpy().copy(), float(aux)
        return (o * _as(a["ct"])).sum() + aux

    before = mesh.collectives
    _, grads = _grads(objective, [_as(a["x"]), _as(a["router"]),
                                  _as(a["w_in"][mine]),
                                  _as(a["w_out"][mine])])
    res["collectives"] = mesh.collectives - before
    res["grads"] = [g.numpy().copy() for g in grads]
    res["at"] = (mine.start, mine.stop)
    return res


def _pipe_case(a: dict, mesh) -> dict:
    """``make_pipeline`` of ``tanh(x @ w)`` layers on the rank's stage:
    the output and the gradients of ``sum(y * ct)``."""
    def stage(w, h):
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i])
        return h

    s = mesh.coords["pp"]
    fn = tpipe.make_pipeline(mesh, stage)
    res = {}

    def objective(w, x):
        y = fn(w, x)
        res["out"] = y.detach().numpy().copy()
        return (y * _as(a["ct"])).sum()

    before = mesh.collectives
    _, grads = _grads(objective, [_as(a["w"][s:s + 1]), _as(a["x"])])
    res["collectives"] = mesh.collectives - before
    res["grads"] = [g.numpy().copy() for g in grads]
    return res


def _model(spec: dict, inputs: dict, mesh) -> dict:
    """On ``mesh``: the forward (logits, and the MoE's auxiliary loss),
    the unfused loss, two train steps (losses, collectives a step, the
    first update's ``mu``, the parameters and moments after the second,
    digests of the replicated and of the sharded leaves) and with
    ``ckpt_dir`` the gang checkpoint's round trip."""
    kind = spec["kind"]
    cfg = tl.LlamaConfig.tiny(**spec["cfg"])
    toks = _as(inputs["toks"])
    specs = specs_of(kind, cfg)
    whole = _clone(inputs["params"][kind])
    if kind == "moe":
        moe_cfg = tmoe.MoEConfig(**spec["moe"])
        params = tl.shard_params(whole, mesh, cfg)

        def loss_of(c):
            return lambda p, b: tl.loss_fn_moe(c, p, b, mesh, moe_cfg)

        def forward(p):
            return tl.forward_moe(cfg, p, toks[:, :-1], mesh, moe_cfg)
    else:
        n_micro = spec["n_micro"]
        params = tl.shard_params(
            tl.stack_pipeline_params(whole, mesh.shape["pp"]), mesh, cfg,
            specs)

        def loss_of(c):
            return lambda p, b: tl.loss_fn_pipelined(c, p, b, mesh, n_micro)

        def forward(p):
            return (tl.forward_pipelined(cfg, p, toks[:, :-1], mesh,
                                         n_micro),)
    out = {"coords": mesh.coords}
    with torch.no_grad():
        before = mesh.collectives
        fwd = forward(params)
        out["forward_collectives"] = mesh.collectives - before
        out["logits"] = fwd[0].numpy().copy()
        if kind == "moe":
            out["aux"] = float(fwd[1])
        loss, acc = loss_of(dataclasses.replace(cfg, fused_ce=False))(
            params, toks)
        out["unfused"] = (float(loss), float(acc))
    opt = tt.make_optimizer(**inputs["opt"])
    step = tt.make_train_step(loss_of(cfg), opt, mesh=mesh, batch_spec=None,
                              param_spec_tree=specs)
    state = tt.init_opt_state(opt, params)
    losses, counts, accs = [], [], []
    for i in range(inputs["n_steps"]):
        before = mesh.collectives
        params, state, o = step(params, state, toks)
        counts.append(mesh.collectives - before)
        losses.append(float(o["loss"]))
        accs.append(float(o["metric"]))
        if i == 0:
            out["mu_first"] = _flat(state.mu)
    trees = (params, state.mu, state.nu)
    out.update(losses=losses, accs=accs, collectives_per_step=counts,
               params=_flat(params), mu=_flat(state.mu), nu=_flat(state.nu),
               replicated=_digest(trees, leaf_names(kind, cfg, False)),
               sharded=_digest(trees, leaf_names(kind, cfg, True)))
    if spec.get("ckpt_dir"):
        out["ckpt"] = _checkpoint(spec["ckpt_dir"], kind, cfg, specs,
                                  params, state, mesh)
    return out


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _checkpoint(ckpt_dir, kind, cfg, specs, params, state, mesh) -> dict:
    """Save the train tree under the reference's layout at step 1, restore
    it into a zeroed template, and report the manifest and whether the
    restore is bitwise, with its counts."""
    import json
    layout = {"mesh": mesh,
              "specs": {"params": specs,
                        "opt_state": tt.moment_specs(specs)},
              "disk_specs": {"params": specs,
                             "opt_state": tt.opt_state_specs(params, specs,
                                                             mesh)}}
    d = tc.save_sharded(ckpt_dir, 1, {"params": params,
                                      "opt_state": tt.opt_state_tree(state)},
                        **layout)
    zeros = {"params": _zeros(params),
             "opt_state": tt.opt_state_tree(tt.OptState(
                 0, _zeros(params), _zeros(params), 0))}
    got = tc.restore_sharded(ckpt_dir, zeros, 1, **layout)
    restored = tt.opt_state_from_tree(got["opt_state"])
    names = leaf_names(kind, cfg, False) + leaf_names(kind, cfg, True)
    with open(os.path.join(d, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    return {"manifest": manifest,
            "bitwise": (_digest((got["params"], restored.mu, restored.nu),
                                names)
                        == _digest((params, state.mu, state.nu), names)),
            "counts": (restored.count, restored.sched_count, state.count)}


def _collectives(ep, pp, x: np.ndarray) -> dict:
    """``Mesh.all_to_all`` over ep (split 0 concat 1, and split 1 concat
    0) and ``Mesh.ppermute`` over pp (both ways) on rank r's ``x[r]``
    (``[n * 2, 2 * n]``), each value and the gradient of ``sum(w * y)``
    with ``w`` the rank's weights of y's shape."""
    r = ep.coords["ep"]
    fns = {"a2a_01": lambda t: ep.all_to_all(t, "ep", 0, 1),
           "a2a_10": lambda t: ep.all_to_all(t, "ep", 1, 0),
           "hop": lambda t: pp.ppermute(t, "pp", 1),
           "hop_back": lambda t: pp.ppermute(t, "pp", -1)}
    out = {}
    for name, fn in fns.items():
        t = _as(x[r]).requires_grad_(True)
        y = fn(t)
        w = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape) * (r + 1)
        (g,) = torch.autograd.grad((w * y).sum(), t)
        out[name] = {"y": y.detach().numpy().copy(), "grad": g.numpy()}
    return out


def ep_serving(path: str) -> dict:
    """The port's paged MoE engine on ``MeshSpec(ep=world)``: the rank's
    experts of the whole tree (``llama.shard_params``), ``inputs["reqs"]``
    drained, the streams and the engine's page stats."""
    from dcos_commons_tpu_torch.models import serving as ts
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    world = int(os.environ[distributed.NUM_PROCESSES_ENV])
    mesh = MeshSpec(ep=world).build("cpu")
    cfg = tl.LlamaConfig.tiny(**inputs["cfg"])
    params = tl.shard_params(inputs["params"], mesh, cfg)
    srv = ts.PagedServer(cfg, params, moe=tmoe.dropless(tmoe.MoEConfig(
        inputs["experts"])), device="cpu", mesh=mesh, **inputs["engine"])
    got = srv.drain([dict(r) for r in inputs["reqs"]],
                    decode_window=inputs["window"])
    return {"streams": got, "stats": srv.page_stats(),
            "w_in": tuple(params["layers"]["w_in"].shape),
            "violations": srv.ledger_violations()}
