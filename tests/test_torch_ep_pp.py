"""Expert- and pipeline-parallel training in the port against ONE JAX
process running the reference's own ep and pp code over as many virtual
CPU devices: gloo gangs on the CPU (``parallel.distributed.launch_local``;
a gang of 2 runs the ep2 and pp2 meshes, a gang of 4 the dp2 x ep2 and
dp2 x pp2 meshes, each world started once for this module) run
``tests/_torch_ep_pp_ranks.battery`` on the tiny config (2 layers, fp32,
4 x 17 tokens every rank holds), and JAX runs ``make_train_step(mesh=,
param_spec_tree=llama.moe_param_specs(cfg) or pipeline_param_specs(cfg),
batch_spec=None)`` on ``MeshSpec(ep=2)`` and ``MeshSpec(pp=2)`` (the dp2
gangs are held to those meshes' references: every rank computes the
whole batch, and a dp replica changes no arithmetic):

* ``forward_moe`` (logits and auxiliary loss), ``forward_pipelined``, and
  the unfused ``loss_fn_moe`` / ``loss_fn_pipelined``: within 1e-6;
* two train steps (the fused losses, whose first is the fused
  ``loss_fn_*``'s): the losses within 1e-6, the accuracy exact; the
  gradient of the first pass (the first update's ``mu / (1 - b1)``: the
  clip is set above the gradient's norm) within 1e-5 of its largest,
  checked apart for the expert banks or stages, the replicated leaves,
  and the embedding and head; the parameters and moments after two steps
  within ``PARAM_TOL`` / ``MOMENT_TOL``;
* the replicated leaves bitwise equal on every rank, each shard on its
  dp replicas; the collectives a step against the count from the code;
* the gang checkpoint at ep2 and pp2: the ranks' shard files, indices,
  shapes and dtypes are those of JAX's save of its state, and the
  restore is bitwise;
* ``make_moe`` at ep 2 and 4 (top-2 with drops, dropless, expert
  choice) against the reference's ``make_moe``: the output and the
  auxiliary loss within 1e-6, the gradients of the tokens and the
  router within 1e-5 of their largest on every rank, and each rank's
  expert gradients ``ep`` times the reference's shard (every ep rank
  routes the whole group, so the owner receives each token's cotangent
  ``ep`` times: the train step divides them);
* ``make_pipeline`` at pp 2 and 4 against the reference's: the output
  and the gradients of the stages and of the input;
* ``Mesh.all_to_all`` over ep (split before and after concat) and
  ``Mesh.ppermute`` over pp with their adjoints, against numpy.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops import losses as jlosses
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu.parallel import moe as jmoe
from dcos_commons_tpu.parallel import pipeline as jpipe
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_ep_pp_ranks
from tests import test_torch_llama_train as llt

LAYERS, BATCH, SEQ, BLOCK, STEPS = 2, 4, 17, 8, 2
OPT = dict(llt.OPT, grad_clip=1e3)   # above the norm: nothing is clipped
B1 = 0.9                             # optax.adamw's
LOSS_RTOL, GRAD_TOL, FWD_TOL = 1e-6, 1e-5, 1e-6
MOE = dict(num_experts=4, capacity_factor=2.0, routing="top2")
N_MICRO = 2
# mesh -> (model, axes); the JAX mesh each is held to
MESHES = {"ep2": ("moe", dict(ep=2)), "dp2ep2": ("moe", dict(dp=2, ep=2)),
          "pp2": ("pipe", dict(pp=2)), "dp2pp2": ("pipe", dict(dp=2, pp=2))}
REFERENCE = {"ep2": "ep2", "dp2ep2": "ep2", "pp2": "pp2", "dp2pp2": "pp2"}
WORLDS = {"w2": ("ep2", "pp2"), "w4": ("dp2ep2", "dp2pp2")}
CKPT_MESHES = ("ep2", "pp2")
# make_moe alone: case -> (ep, capacity factor, routing)
MOE_CASES = {"top2_drops_ep2": (2, 1.0, "top2"),
             "dropless_ep2": (2, 4.0, "top2"),
             "expert_choice_ep2": (2, 2.0, "expert_choice"),
             "top2_drops_ep4": (4, 1.0, "top2"),
             "dropless_ep4": (4, 4.0, "top2"),
             "expert_choice_ep4": (4, 2.0, "expert_choice")}
MOE_SHAPE = (16, 8, 16, 4)           # G, D, F, E
PIPE_CASES = {"pp2": 2, "pp4": 4}
PIPE_SHAPE = (4, 3, 8, 2)            # M, rows a microbatch, D, layers a stage


def _toks():
    return llt._tokens(batch=BATCH, seq=SEQ, seed=23)


def _jcfg(**kw):
    return jl.LlamaConfig.tiny(n_layers=LAYERS, dtype=jnp.float32,
                               attn_impl="dense", fused_ce_block=BLOCK, **kw)


def _tcfg():
    return dict(n_layers=LAYERS, dtype=torch.float32, attn_impl="dense",
                fused_ce_block=BLOCK)


@functools.lru_cache(maxsize=None)
def _jparams(kind):
    """The reference's init, on the host (the reference's step donates
    what it is given)."""
    cfg = _jcfg()
    key = jax.random.key(31)
    if kind == "moe":
        return jax.device_get(jl.init_moe_params(cfg, MOE["num_experts"],
                                                 key))
    return jax.device_get(jl.init_params(cfg, key))


def _moe_inputs(case):
    ep, cf, routing = MOE_CASES[case]
    g, d, f, e = MOE_SHAPE
    rng = np.random.default_rng(sorted(MOE_CASES).index(case))
    draw = {"x": (g, d), "router": (d, e), "w_in": (e, d, f),
            "w_out": (e, f, d), "ct": (g, d)}
    return dict(ep=ep, experts=e, capacity_factor=cf, routing=routing,
                **{k: rng.standard_normal(s).astype(np.float32)
                   for k, s in draw.items()})


def _pipe_inputs(case):
    pp = PIPE_CASES[case]
    m, rows, d, k = PIPE_SHAPE
    rng = np.random.default_rng(100 + pp)
    return dict(pp=pp,
                w=(rng.standard_normal((pp, k, d, d)) * 0.4).astype(
                    np.float32),
                x=rng.standard_normal((m, rows, d)).astype(np.float32),
                ct=rng.standard_normal((m, rows, d)).astype(np.float32))


def _collective_inputs(world):
    return np.random.default_rng(7).standard_normal(
        (world, 2 * world, 2 * world)).astype(np.float32)


def _world(name, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(name)
    world = 2 if name == "w2" else 4
    meshes = {}
    for m in WORLDS[name]:
        kind, axes = MESHES[m]
        meshes[m] = {"kind": kind, "mesh": axes, "cfg": _tcfg(),
                     "moe": MOE, "n_micro": N_MICRO}
        if m in CKPT_MESHES:
            meshes[m]["ckpt_dir"] = str(tmp / f"ckpt_{m}")
    inputs = {"meshes": meshes, "toks": _toks(), "opt": OPT,
              "n_steps": STEPS,
              "params": {k: params_from_jax(_jparams(k), "cpu")
                         for k in ("moe", "pipe")},
              "moe": {c: _moe_inputs(c) for c in MOE_CASES},
              "pipe": {c: _pipe_inputs(c) for c in PIPE_CASES},
              "collective_inputs": _collective_inputs(world)}
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    return launch_local(_torch_ep_pp_ranks.battery, world, path,
                        timeout_s=400, threads=1)


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return _world("w2", tmp_path_factory)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return _world("w4", tmp_path_factory)


def _ranks(request, mesh):
    world = next(w for w, ms in WORLDS.items() if mesh in ms)
    return [r["meshes"][mesh] for r in request.getfixturevalue(world)]


def _jmesh(axes):
    spec = JMeshSpec(**axes)
    return spec.build(jax.devices()[:spec.size])


def _place(tree, specs, mesh):
    return jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(mesh, s)),
                        specs, tree, is_leaf=lambda s: isinstance(s, P))


def _placed(state, mesh):
    """The optimizer state with its counts replicated, as the step's
    outputs place them, so the step compiles once."""
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P()))
        if a.ndim == 0 else a, state)


@functools.lru_cache(maxsize=None)
def _jax_model(mesh_name):
    """The reference on ``mesh_name``: the forward (logits, and the MoE's
    auxiliary loss), the unfused loss, and ``STEPS`` steps (per step the
    loss, the accuracy and the params and moments whole on the host),
    with the final device trees."""
    kind, axes = MESHES[mesh_name]
    mesh = _jmesh(axes)
    cfg = _jcfg()
    moe_cfg = jmoe.MoEConfig(**MOE)
    if kind == "moe":
        params, specs = _jparams("moe"), jl.moe_param_specs(cfg)

        def loss_of(c):
            return lambda p, b: jl.loss_fn_moe(c, p, b, mesh, moe_cfg)

        def forward(p, t):
            return jl.forward_moe(cfg, p, t, mesh, moe_cfg)
    else:
        params = jl.stack_pipeline_params(_jparams("pipe"), axes["pp"])
        specs = jl.pipeline_param_specs(cfg)

        def loss_of(c):
            return lambda p, b: jl.loss_fn_pipelined(c, p, b, mesh, N_MICRO)

        def forward(p, t):
            return (jl.forward_pipelined(cfg, p, t, mesh, N_MICRO),)
    toks = jnp.asarray(_toks())
    out = {"steps": []}
    with mesh, jax.default_matmul_precision("highest"):
        params = _place(params, specs, mesh)
        fwd = jax.jit(forward)(params, toks[:, :-1])
        out["logits"] = np.asarray(fwd[0])
        out["aux"] = float(fwd[1]) if kind == "moe" else None
        # the unfused loss_fn_* is the forward's logits through
        # softmax_cross_entropy (plus 0.01 aux for the MoE): eagerly, no
        # compile of its own
        loss, acc = jlosses.softmax_cross_entropy(fwd[0], toks[:, 1:],
                                                  z_loss=1e-4)
        out["unfused"] = (float(loss) + 0.01 * (out["aux"] or 0.0),
                          float(acc))
        opt = jt.make_optimizer(**OPT)
        step = jt.make_train_step(loss_of(cfg), opt, mesh=mesh,
                                  param_spec_tree=specs, batch_spec=None)
        state = _placed(jt.init_opt_state(opt, params, mesh, specs), mesh)
        for _ in range(STEPS):
            params, state, res = step(params, state, toks)
            adam = state[1][0]
            out["steps"].append({
                "loss": float(res["loss"]), "acc": float(res["metric"]),
                "params": llt._host(params), "mu": llt._host(adam.mu),
                "nu": llt._host(adam.nu)})
    out["final"] = (params, state)
    return out


def _spec_of(kind, name):
    tree = _torch_ep_pp_ranks.specs_of(kind, tl.LlamaConfig.tiny())
    for key in name.split("/"):
        tree = tree[key]
    return tree


def _whole(kind, ranks, part):
    """``part(rank)`` of the ranks at dp 0, concatenated in rank order
    along each sharded leaf's ep or pp dimension."""
    axis = "ep" if kind == "moe" else "pp"
    row = sorted((r for r in ranks if r["coords"]["dp"] == 0),
                 key=lambda r: r["coords"][axis])
    out = {}
    for name in part(row[0]):
        spec = _spec_of(kind, name)
        if axis not in spec:
            out[name] = part(row[0])[name]
        else:
            out[name] = np.concatenate([part(r)[name] for r in row],
                                       axis=spec.index(axis))
    return out


def _close(got, want, tol, names=None):
    want = llt._flat(want)
    assert sorted(got) == sorted(want)
    for name in names or want:
        w = np.asarray(want[name], np.float32)
        err = float(np.abs(got[name] - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), (name, err)


def _per_step(mesh_name, forward_only=False):
    """Collectives from the code. MoE: per layer two all-to-alls and the
    auxiliary loss's mean over ep, each way. Pipeline: ``m + n - 2`` hops
    and the outputs' sum forward; the hops back and the input's "f"
    backward. Then the replicated leaves' reduction over the mesh, the
    sharded leaves' over dp when dp > 1, and the clip's norm."""
    kind, axes = MESHES[mesh_name]
    if kind == "moe":
        fwd = 3 * LAYERS
        step = 2 * fwd
    else:
        hops = N_MICRO + axes["pp"] - 2
        fwd = hops + 1
        step = 2 * hops + 2
    if forward_only:
        return fwd
    return step + 1 + (axes.get("dp", 1) > 1) + 1


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_and_unfused_loss_match_jax(request, mesh):
    want = _jax_model(REFERENCE[mesh])
    for r in _ranks(request, mesh):
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=0,
                                   atol=FWD_TOL * float(np.abs(
                                       want["logits"]).max()))
        if want["aux"] is not None:
            assert r["aux"] == pytest.approx(want["aux"], rel=FWD_TOL)
        assert r["unfused"][0] == pytest.approx(want["unfused"][0],
                                                rel=LOSS_RTOL)
        assert r["unfused"][1] == want["unfused"][1]
        assert r["forward_collectives"] == _per_step(mesh, forward_only=True)


@pytest.mark.parametrize("group", ["sharded", "replicated", "embed_head"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_pass_gradient_matches_jax(request, mesh, group):
    """The expert banks (or stages), the other replicated leaves, and the
    embedding and head apart: the traps each meets differ."""
    kind = MESHES[mesh][0]
    ranks = _ranks(request, mesh)
    first = _jax_model(REFERENCE[mesh])["steps"][0]
    want = jax.tree.map(lambda m: m / np.float32(1 - B1), first["mu"])
    got = {k: v / np.float32(1 - B1) for k, v in
           _whole(kind, ranks, lambda r: r["mu_first"]).items()}
    cfg = tl.LlamaConfig.tiny()
    names = {"sharded": _torch_ep_pp_ranks.leaf_names(kind, cfg, True),
             "embed_head": ("embed", "lm_head")}.get(group) or tuple(
        n for n in _torch_ep_pp_ranks.leaf_names(kind, cfg, False)
        if n not in ("embed", "lm_head"))
    assert names
    _close(got, want, GRAD_TOL, names)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_steps_match_the_reference_step(request, mesh):
    kind = MESHES[mesh][0]
    ranks = _ranks(request, mesh)
    want = _jax_model(REFERENCE[mesh])["steps"]
    for r in ranks:
        assert r["losses"] == pytest.approx([w["loss"] for w in want],
                                            rel=LOSS_RTOL)
        assert r["accs"] == [w["acc"] for w in want]
        assert r["collectives_per_step"] == [_per_step(mesh)] * STEPS
    for part, tol in (("params", llt.PARAM_TOL), ("mu", llt.MOMENT_TOL),
                      ("nu", llt.MOMENT_TOL)):
        _close(_whole(kind, ranks, lambda r: r[part]), want[-1][part], tol)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_leaves_are_the_same_bits_on_every_rank(request, mesh):
    kind = MESHES[mesh][0]
    axis = "ep" if kind == "moe" else "pp"
    ranks = _ranks(request, mesh)
    assert len({r["replicated"] for r in ranks}) == 1
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    by_shard = {}
    for r in ranks:
        by_shard.setdefault(r["coords"][axis], set()).add(r["sharded"])
    assert all(len(v) == 1 for v in by_shard.values())
    assert len(by_shard) == MESHES[mesh][1][axis]


@pytest.fixture(scope="module")
def jax_ckpt_manifests(tmp_path_factory):
    """JAX's save of its ep2 and pp2 train states after the steps."""
    out = {}
    for m in CKPT_MESHES:
        params, state = _jax_model(m)["final"]
        d = jc.save_sharded(str(tmp_path_factory.mktemp(f"jax_{m}")), 1,
                            {"params": params, "opt_state": state})
        with open(f"{d}/manifest.json", encoding="utf-8") as f:
            out[m] = json.load(f)
    return out


@pytest.mark.parametrize("mesh", CKPT_MESHES)
def test_gang_checkpoint_names_the_reference_shards(w2, jax_ckpt_manifests,
                                                    mesh):
    """Every rank writes its expert bank or stage (and its own copy of
    every replicated leaf) under the whole leaf's shape and dtype; the
    union is JAX's shards, and the restore is bitwise with the counts."""
    want = jax_ckpt_manifests[mesh]["leaves"]
    union = {}
    for r, res in enumerate(w2):
        ck = res["meshes"][mesh]["ckpt"]
        assert ck["bitwise"] and ck["counts"] == (STEPS, STEPS, STEPS)
        man = ck["manifest"]
        assert man["process"] == r and man["num_processes"] == 2
        assert set(man["leaves"]) == set(want)
        for key, entry in man["leaves"].items():
            assert entry["global_shape"] == want[key]["global_shape"], key
            assert entry["dtype"] == want[key]["dtype"], key
            assert len(entry["shards"]) == 1
            union.setdefault(key, {}).update(
                {s["index"]: (s["file"], s["local_shape"])
                 for s in entry["shards"]})
    for key, entry in want.items():
        assert union[key] == {s["index"]: (s["file"], s["local_shape"])
                              for s in entry["shards"]}, key


@functools.lru_cache(maxsize=None)
def _jax_moe(case):
    """The reference's ``make_moe``: output, auxiliary loss, and the
    gradients of ``sum(out * ct) + aux``."""
    a = _moe_inputs(case)
    mesh = _jmesh({"ep": a["ep"]})
    cfg = jmoe.MoEConfig(a["experts"], a["capacity_factor"], a["routing"])
    fn = jmoe.make_moe(mesh, cfg)

    def objective(x, rw, wi, wo):
        out, aux = fn(x, rw, wi, wo)
        return jnp.sum(out * a["ct"]) + aux, (out, aux)

    with mesh, jax.default_matmul_precision("highest"):
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1, 2, 3), has_aux=True))(
            *(jnp.asarray(a[k]) for k in ("x", "router", "w_in", "w_out")))
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_make_moe_matches_the_reference(w2, w4, case):
    ep = MOE_CASES[case][0]
    want, want_aux, want_grads = _jax_moe(case)
    for r in (w2 if ep == 2 else w4):
        got = r["moe"][case]
        np.testing.assert_allclose(got["out"], want, rtol=0,
                                   atol=FWD_TOL * np.abs(want).max())
        assert got["aux"] == pytest.approx(want_aux, rel=FWD_TOL, abs=1e-7)
        mine = slice(*got["at"])
        # the tokens' and the router's whole on every rank; the rank's
        # expert bank ep times over
        for g, w in zip(got["grads"], [want_grads[0], want_grads[1],
                                       ep * want_grads[2][mine],
                                       ep * want_grads[3][mine]]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_TOL * np.abs(w).max())
        # two all-to-alls each way, and the auxiliary loss's mean over ep
        # (forward only for expert choice, whose loss is a constant zero)
        assert got["collectives"] == (5 if MOE_CASES[case][2] ==
                                      "expert_choice" else 6)


@functools.lru_cache(maxsize=None)
def _jax_pipe(case):
    a = _pipe_inputs(case)
    mesh = _jmesh({"pp": a["pp"]})

    def stage(w, h):
        for i in range(w.shape[0]):
            h = jnp.tanh(h @ w[i])
        return h

    fn = jpipe.make_pipeline(mesh, stage)

    def objective(w, x):
        y = fn(w, x)
        return jnp.sum(y * a["ct"]), y

    with mesh, jax.default_matmul_precision("highest"):
        (_, y), grads = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(
            jnp.asarray(a["w"]), jnp.asarray(a["x"]))
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_make_pipeline_matches_the_reference(w2, w4, case):
    pp = PIPE_CASES[case]
    want, (want_w, want_x) = _jax_pipe(case)
    m = PIPE_SHAPE[0]
    for s, r in enumerate(w2 if pp == 2 else w4):
        got = r["pipe"][case]
        np.testing.assert_allclose(got["out"], want, rtol=0, atol=FWD_TOL)
        np.testing.assert_allclose(got["grads"][0], want_w[s:s + 1], rtol=0,
                                   atol=GRAD_TOL * np.abs(want_w).max())
        np.testing.assert_allclose(got["grads"][1], want_x, rtol=0,
                                   atol=GRAD_TOL * np.abs(want_x).max())
        assert got["collectives"] == 2 * (m + pp - 2) + 2


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_ep_and_pp_collectives_and_their_adjoints(request, world):
    """``all_to_all`` over ep with split 0 / concat 1 and split 1 /
    concat 0, and ``ppermute`` over pp both ways, on rank r's ``x[r]``;
    the gradients of ``sum(w[r] * y)``, against their definitions."""
    ranks = request.getfixturevalue(world)
    n = len(ranks)
    x = _collective_inputs(n)
    rows, cols = x.shape[1] // n, x.shape[2] // n
    shapes = {"a2a_01": (rows, cols * n * n), "a2a_10": (rows * n * n, cols),
              "hop": x[0].shape, "hop_back": x[0].shape}
    w = {k: [np.arange(np.prod(s), dtype=np.float32).reshape(s) * (r + 1)
             for r in range(n)] for k, s in shapes.items()}
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_array_equal(c["a2a_01"]["y"], np.concatenate(
            [x[j][rows * r:rows * (r + 1)] for j in range(n)], axis=1))
        np.testing.assert_array_equal(c["a2a_01"]["grad"], np.concatenate(
            [w["a2a_01"][j][:, 2 * n * r:2 * n * (r + 1)]
             for j in range(n)]))
        np.testing.assert_array_equal(c["a2a_10"]["y"], np.concatenate(
            [x[j][:, cols * r:cols * (r + 1)] for j in range(n)], axis=0))
        np.testing.assert_array_equal(c["a2a_10"]["grad"], np.concatenate(
            [w["a2a_10"][j][2 * n * r:2 * n * (r + 1)] for j in range(n)],
            axis=1))
        for name, shift in (("hop", 1), ("hop_back", -1)):
            np.testing.assert_array_equal(c[name]["y"], x[(r - shift) % n])
            np.testing.assert_array_equal(c[name]["grad"],
                                          w[name][(r + shift) % n])
