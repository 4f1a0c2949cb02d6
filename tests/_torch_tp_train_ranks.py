"""Rank functions of the port's tensor-parallel training CPU tests: each
runs in one member of a gang that ``parallel.distributed.launch_local``
starts, so this module imports torch and the port only, never JAX.
Inputs come from a ``torch.save`` file the test writes; results go back
as numpy arrays and plain Python values."""

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcos_commons_tpu_torch.models import llama as tl  # noqa: E402
from dcos_commons_tpu_torch.models import train as tt  # noqa: E402
from dcos_commons_tpu_torch.ops import losses as tlo  # noqa: E402
from dcos_commons_tpu_torch.parallel import checkpoint as tc  # noqa: E402
from dcos_commons_tpu_torch.parallel import distributed  # noqa: E402
from dcos_commons_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _flat(tree, prefix=""):
    """``{"layers/wq": numpy array, ...}`` of a tree of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().float().numpy().copy()
    return out


def _digest(trees, names) -> str:
    """The bytes of the ``names`` leaves of every tree, in order."""
    h = hashlib.sha1()
    for tree in trees:
        flat = _flat(tree)
        for name in names:
            h.update(flat[name].tobytes())
    return h.hexdigest()


REPLICATED = ("layers/attn_norm", "layers/ffn_norm", "norm")
SHARDED = ("embed", "layers/w_down", "layers/w_gate", "layers/w_up",
           "layers/wk", "layers/wo", "layers/wq", "layers/wv", "lm_head")


def battery(path: str) -> dict:
    """Everything one gang member computes for ``tests/
    test_torch_tp_train.py`` on ``MeshSpec(**inputs["mesh"])``: the first
    pass's loss, accuracy and gradient shards per case, three train steps
    per case (losses, parameter and moment shards, collectives a step,
    digests of the replicated and of the sharded leaves), the argmax tie
    rule of the vocabulary-parallel loss, and with ``ckpt_dir`` the gang
    checkpoint's round trip."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    mesh = MeshSpec(**inputs["mesh"]).build("cpu")
    toks = torch.from_numpy(inputs["toks"])
    out = {"rank": mesh.rank, "coords": mesh.coords, "first": {},
           "steps": {}, "ties": _ties(mesh)}
    for case, spec in inputs["first"].items():
        cfg = tl.LlamaConfig.tiny(**spec["cfg"])
        params = tl.shard_params(_clone(inputs["params"]), mesh, cfg)
        leaves = tt._leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        before = mesh.collectives
        loss, acc = tl.loss_fn(cfg, params, toks, mesh)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)

        def rebuild(tree):
            if isinstance(tree, dict):
                return {k: rebuild(v) for k, v in tree.items()}
            return next(it)

        out["first"][case] = {
            "loss": float(loss.detach()), "acc": float(acc),
            "collectives": mesh.collectives - before,
            "grads": _flat(rebuild(params))}
    for case, spec in inputs["steps"].items():
        out["steps"][case] = _steps(spec, inputs, mesh, toks)
    if inputs.get("ckpt_dir"):
        out["ckpt"] = _checkpoint(inputs, mesh, toks)
    return out


def _train(spec, inputs, mesh, toks, steps):
    cfg = tl.LlamaConfig.tiny(**spec["cfg"])
    specs = tl.param_specs(cfg)
    params = tl.shard_params(_clone(inputs["params"]), mesh, cfg)
    opt = tt.make_optimizer(**inputs["opt"])
    step = tt.make_train_step(lambda p, b: tl.loss_fn(cfg, p, b, mesh), opt,
                              grad_accum=spec["grad_accum"], mesh=mesh,
                              batch_spec=None, param_spec_tree=specs)
    state = tt.init_opt_state(opt, params)
    losses, counts = [], []
    for _ in range(steps):
        before = mesh.collectives
        params, state, o = step(params, state, toks)
        counts.append(mesh.collectives - before)
        losses.append(float(o["loss"]))
    return cfg, specs, params, state, losses, counts


def _steps(spec, inputs, mesh, toks) -> dict:
    _, _, params, state, losses, counts = _train(spec, inputs, mesh, toks,
                                                 inputs["n_steps"])
    trees = (params, state.mu, state.nu)
    return {"losses": losses, "collectives_per_step": counts,
            "params": _flat(params), "mu": _flat(state.mu),
            "nu": _flat(state.nu), "count": state.count,
            "replicated": _digest(trees, REPLICATED),
            "sharded": _digest(trees, SHARDED)}


def _ties(mesh) -> dict:
    """Accuracy of the vocabulary-parallel fused loss where the top logit
    ties: columns 1 (rank 0) and ``V - 1`` (the last rank) of a one-hot
    head hold the same largest weight, so two tokens' logits tie across
    the ranks; labels 1 and ``V - 1`` (each tied with the other) and 5
    (not the top). The lowest id wins, as ``jnp.argmax``'s."""
    tp = mesh.shape["tp"]
    vocab, d = 8 * tp, 4
    w = torch.zeros((d, vocab))
    w[0, 1] = w[0, vocab - 1] = 2.0
    w[1, 5] = 1.0
    x = torch.tensor([[[1.0, 0.5, 0.0, 0.0]] * 3])
    cols = vocab // tp
    mine = w[:, mesh.coords["tp"] * cols:(mesh.coords["tp"] + 1) * cols]
    out = {}
    for label in (1, vocab - 1, 5):
        labels = torch.full((1, 3), label)
        _, acc = tlo.fused_linear_cross_entropy(x, mine.contiguous(), labels,
                                                block_size=2, mesh=mesh)
        want = tlo.softmax_cross_entropy(x @ w, labels)[1]
        out[label] = (float(acc), float(want))
    return out


def _checkpoint(inputs, mesh, toks) -> dict:
    """Train ``n_steps`` with the first step case's spec, save the train
    tree under the reference's layout at step 1, restore it into a zeroed
    template, and report the manifest, the restored tree's digest against
    the live one, and the whole ``wq`` moment."""
    spec = next(iter(inputs["steps"].values()))
    cfg, specs, params, state, _, _ = _train(spec, inputs, mesh, toks,
                                             inputs["n_steps"])
    layout = {"mesh": mesh,
              "specs": {"params": specs,
                        "opt_state": tt.moment_specs(specs)},
              "disk_specs": {"params": specs,
                             "opt_state": tt.opt_state_specs(params, specs,
                                                             mesh)}}
    tree = {"params": params, "opt_state": tt.opt_state_tree(state)}
    d = tc.save_sharded(inputs["ckpt_dir"], 1, tree, **layout)
    zeros = {"params": tl.param_template(cfg, "cpu", mesh=mesh),
             "opt_state": tt.opt_state_tree(tt.OptState(
                 0, tl.param_template(cfg, "cpu", mesh=mesh),
                 tl.param_template(cfg, "cpu", mesh=mesh), 0))}
    before = mesh.collectives
    got = tc.restore_sharded(inputs["ckpt_dir"], zeros, 1, **layout)
    restore_collectives = mesh.collectives - before
    restored = tt.opt_state_from_tree(got["opt_state"])
    names = REPLICATED + SHARDED
    with open(os.path.join(d, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    wq_mu = mesh.all_gather(state.mu["layers"]["wq"], "tp", dim=2)
    return {"dir": d, "manifest": manifest,
            "bitwise": (_digest((got["params"], restored.mu, restored.nu),
                                names)
                        == _digest((params, state.mu, state.nu), names)),
            "counts": (restored.count, restored.sched_count, state.count),
            "restore_collectives": restore_collectives,
            "wq_mu_whole": wq_mu.numpy().copy()}


# ---------------------------------------------------------------------------
# Megatron's pair and the gather (tests/test_torch_mesh.py)


def megatron_pair(path: str) -> dict:
    """On ``MeshSpec(tp=world)``: the forward values and the gradients of
    ``Mesh.copy_to``, ``reduce_from``, ``gather_from`` and
    ``all_reduce_max`` on each rank's row ``x[rank]`` under weights
    ``w[rank]``, and of ``copy_to`` whose cotangent autograd shares with
    another branch."""
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    mesh = MeshSpec(tp=int(os.environ[distributed.NUM_PROCESSES_ENV])
                    ).build("cpu")
    r = mesh.rank
    w = torch.from_numpy(inputs["w"][r])
    out = {"rank": r}

    def run(fn, weight=w):
        x = torch.from_numpy(inputs["x"][r].copy()).requires_grad_(True)
        y = fn(x)
        (gx,) = torch.autograd.grad((weight * y).sum(), x)
        return {"y": y.detach().numpy().copy(), "grad": gx.numpy(),
                "x_after": x.detach().numpy().copy()}

    before = mesh.collectives
    out["copy_to"] = run(lambda x: mesh.copy_to(x))
    out["copy_to_collectives"] = mesh.collectives - before
    out["reduce_from"] = run(lambda x: mesh.reduce_from(x))
    out["shared"] = run(lambda x: mesh.copy_to(x) + x)
    whole = torch.from_numpy(inputs["w_whole"])
    out["gather_from"] = run(lambda x: mesh.gather_from(x, dim=0), whole)
    out["max"] = mesh.all_reduce_max(
        torch.from_numpy(inputs["x"][r].copy())).numpy()
    out["collectives"] = mesh.collectives
    with torch.no_grad():
        x = torch.from_numpy(inputs["x"][r].copy())
        out["no_grad_copy_is_x"] = mesh.copy_to(x) is x
    return out


# ---------------------------------------------------------------------------
# sequence parallelism (tests/test_torch_sp.py)


def _as(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def sp_battery(path: str) -> dict:
    """Everything one gang member computes for ``tests/test_torch_sp.py``:
    on each mesh of ``inputs["meshes"]`` (several meshes share one gang),
    the first pass per case (loss, accuracy, collectives, the gradient
    averaged over sp: each rank's shards), three train steps per step
    case (as :func:`battery`'s), and with ``ckpt`` the gang checkpoint
    of the first step case; then the attention functions alone on
    ``MeshSpec(sp=world)`` and the sp collectives' forward values and
    gradients."""
    from dcos_commons_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from dcos_commons_tpu_torch.parallel.ulysses import ulysses_attention
    inputs = torch.load(path, weights_only=False)
    distributed.initialize()
    world = int(os.environ[distributed.NUM_PROCESSES_ENV])
    toks = _as(inputs["toks"])
    out = {"meshes": {}, "attn": {}}
    for name, spec in inputs["meshes"].items():
        mesh = MeshSpec(**spec["mesh"]).build("cpu")
        res = out["meshes"][name] = {"coords": mesh.coords, "first": {},
                                     "steps": {}}
        sp = mesh.shape["sp"]
        for case, cfg_kw in spec["first"].items():
            cfg = tl.LlamaConfig.tiny(**cfg_kw)
            params = tl.shard_params(_clone(inputs["params"]), mesh, cfg)
            leaves = tt._leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            before = mesh.collectives
            loss, acc = tl.loss_fn(cfg, params, toks, mesh)
            grads = torch.autograd.grad(loss, leaves)
            collectives = mesh.collectives - before
            # each rank's gradient is its own shard's share: their mean
            grads, _ = mesh.reduce_grads(grads, weight=1.0 / sp, axis="sp")
            it = iter(grads)

            def rebuild(tree):
                if isinstance(tree, dict):
                    return {k: rebuild(v) for k, v in tree.items()}
                return next(it)

            res["first"][case] = {"loss": float(loss.detach()),
                                  "acc": float(acc),
                                  "collectives": collectives,
                                  "grads": _flat(rebuild(params))}
        view = dict(inputs, steps=spec["steps"])
        for case, step_spec in spec["steps"].items():
            res["steps"][case] = _steps(step_spec, view, mesh, toks)
        if spec.get("ckpt_dir"):
            res["ckpt"] = _checkpoint(dict(view, ckpt_dir=spec["ckpt_dir"]),
                                      mesh, toks)
    mesh = MeshSpec(sp=world).build("cpu")
    me, fns = mesh.coords["sp"], {"ring": ring_attention,
                                  "ulysses": ulysses_attention}
    for case, a in inputs["attn"].items():
        if a["sp"] != world:
            continue
        n = a["q"].shape[1] // world
        cut = slice(me * n, (me + 1) * n)
        q, k, v = (_as(a[x][:, cut]).requires_grad_(True)
                   for x in ("q", "k", "v"))
        kw = {"layout": a["layout"]} if a["fn"] == "ring" else {}
        before = mesh.collectives
        o = fns[a["fn"]](q, k, v, mesh, causal=a["causal"], **kw)
        grads = torch.autograd.grad((o * _as(a["do"][:, cut])).sum(),
                                    (q, k, v))
        out["attn"][case] = {
            "at": (cut.start, cut.stop), "collectives": mesh.collectives
            - before, "out": o.detach().numpy().copy(),
            "grads": [g.numpy().copy() for g in grads]}
    out["collectives"] = _sp_collectives(mesh, inputs["collective_inputs"])
    return out


def _sp_collectives(mesh, x: np.ndarray) -> dict:
    """``Mesh.ppermute``, ``all_to_all`` and ``gather_seq`` on rank r's
    ``x[r]`` (``[n * 2, 3]``), each value and the gradient of
    ``sum(w * y)`` with ``w[r]`` the rank's weights of y's shape: the
    cotangents cross back, as each collective's adjoint sends them."""
    r = mesh.coords["sp"]
    out = {}
    fns = {"ppermute": lambda t: mesh.ppermute(t, "sp", 1),
           "ppermute_back": lambda t: mesh.ppermute(t, "sp", -1),
           "all_to_all": lambda t: mesh.all_to_all(t, "sp", 0, 1),
           "gather_seq": lambda t: mesh.gather_seq(t, "sp", dim=0)}
    for name, fn in fns.items():
        t = _as(x[r]).requires_grad_(True)
        y = fn(t)
        w = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape) \
            * (r + 1)
        (g,) = torch.autograd.grad((w * y).sum(), t)
        out[name] = {"y": y.detach().numpy().copy(), "grad": g.numpy()}
    with torch.no_grad():
        t = _as(x[r])
        out["no_grad_all_to_all"] = mesh.all_to_all(t, "sp", 0, 1).numpy()
    return out
