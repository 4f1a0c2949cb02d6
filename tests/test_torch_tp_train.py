"""Tensor-parallel training in the port against ONE JAX process running
the reference's own tp train step over as many virtual CPU devices:
gloo gangs on the CPU (``parallel.distributed.launch_local``, each world
started once for this module) at tp=2, tp=4 and dp=2 x tp=2 run
``tests/_torch_tp_train_ranks.battery`` on the tiny config (2 layers,
fp32, 4 x 33 tokens every rank holds), and JAX runs
``make_train_step(mesh=, param_spec_tree=llama.param_specs(cfg),
batch_spec=None)`` from ``init_opt_state(opt, params, mesh, specs)`` on
``MeshSpec(tp=2)`` and ``MeshSpec(tp=4)`` over as many devices (the
dp=2 x tp=2 gang is held to the tp=2 mesh's references: with every rank
holding the whole batch, a dp replica changes no arithmetic of the
reference's step but the order of its row sums, and one compile a case
is shared):

* the first pass, fused and unfused loss heads, and fused with ``remat``
  (each layer's forward recomputed in the backward on every rank in one
  order, the attention block's "g" all-reduce included): loss within rel
  1e-5, the accuracy exact, every gradient leaf gathered whole within
  ``tests/test_torch_llama_train.py``'s ``GRAD_TOL`` (2e-5 of the leaf's
  largest);
* three steps for ``fused_ce`` true and false and ``grad_accum`` 1 and 2:
  losses within rel 1e-5, params, ``mu`` and ``nu`` gathered whole within
  ``PARAM_TOL`` and ``MOMENT_TOL`` (1e-5), as one device is held; no
  tolerance is loosened;
* the replicated leaves (the norms, their moments) bitwise equal on
  every rank, the sharded ones on every dp replica of a tp coordinate;
* the collectives a step against the count worked out from the code
  (module doc of ``models/llama.py``): per microbatch one for the
  embedding, four a layer ("f" backward and "g" forward around attention
  and the FFN), the head's (fused: two a sequence block forward and one
  backward; unfused: the gather and its input's "f"), then one for the
  clip's norm and, with dp, one gradient reduction;
* the vocabulary-parallel loss's argmax: a tie across ranks goes to the
  lowest id;
* the gang checkpoint at tp=2: the ranks' step directories name exactly
  the shard files, indices, local and global shapes and dtypes of JAX's
  save of its tp=2 train state, including ``opt_state.1.0.mu.layers.wq``
  as a ROW shard (the reference places moments by shape, and ``wo``
  sorts before ``wq``); the row shards hold the rows of the whole moment;
  the restore is bitwise.
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
from dcos_commons_tpu.parallel import checkpoint as jc
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_tp_train_ranks
from tests import test_torch_llama_train as llt

LAYERS, BATCH, SEQ, BLOCK, STEPS = 2, 4, 33, 16, 3
FIRST = {"fused": dict(fused_ce=True), "unfused": dict(fused_ce=False),
         "fused_remat": dict(fused_ce=True, remat=True)}
# case -> (fused_ce, grad_accum, the port's attention)
STEP_CASES = {"fused_ga1": (True, 1, "flash"), "fused_ga2": (True, 2, "flash"),
              "unfused_ga1": (False, 1, "dense"),
              "unfused_ga2": (False, 2, "flash")}
WORLDS = {"tp2": (1, 2), "tp4": (1, 4), "dp2tp2": (2, 2)}
# the JAX mesh each world is held to
REFERENCE = {"tp2": "tp2", "tp4": "tp4", "dp2tp2": "tp2"}


def _jcfg(**kw):
    return jl.LlamaConfig.tiny(n_layers=LAYERS, attn_impl="dense",
                               dtype=jnp.float32, fused_ce_block=BLOCK, **kw)


def _tcfg(attn="flash", **kw):
    return dict(n_layers=LAYERS, attn_impl=attn, dtype=torch.float32,
                fused_ce_block=BLOCK, **kw)


def _toks():
    return llt._tokens(batch=BATCH, seq=SEQ, seed=17)


def _jparams():
    return jl.init_params(_jcfg(), jax.random.key(11))


def _jax_mesh(world):
    dp, tp = WORLDS[world]
    return JMeshSpec(dp=dp, tp=tp).build(jax.devices()[:dp * tp])


@functools.lru_cache(maxsize=None)
def _jax_first(world, fused):
    """The reference's first pass on ``world``'s mesh (JAX has no remat
    to vary: the fused case's is the remat case's too)."""
    mesh = _jax_mesh(world)
    jcfg = _jcfg(fused_ce=fused)
    toks = jnp.asarray(_toks())
    with mesh, jax.default_matmul_precision("highest"):
        sharded = jl.shard_params(_jparams(), mesh, jcfg)
        (loss, acc), grads = jax.jit(jax.value_and_grad(
            lambda p: jl.loss_fn(jcfg, p, toks, mesh), has_aux=True))(sharded)
    return float(loss), float(acc), jax.device_get(grads)


@functools.lru_cache(maxsize=None)
def _jax_steps(world, fused, grad_accum, n=STEPS):
    """The reference's tp step; per step (loss, params, mu, nu) whole on
    the host, and the final (params, opt_state) device trees. The
    state's counts start where the step's outputs place them
    (replicated over the mesh), so the step compiles once."""
    mesh = _jax_mesh(world)
    jcfg = _jcfg(fused_ce=fused)
    specs = jl.param_specs(jcfg)
    toks = jnp.asarray(_toks())
    out = []
    with mesh, jax.default_matmul_precision("highest"):
        params = jl.shard_params(_jparams(), mesh, jcfg)
        opt = jt.make_optimizer(**llt.OPT)
        step = jt.make_train_step(lambda p, b: jl.loss_fn(jcfg, p, b, mesh),
                                  opt, mesh=mesh, param_spec_tree=specs,
                                  batch_spec=None, grad_accum=grad_accum)
        state = jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P()))
            if a.ndim == 0 else a,
            jt.init_opt_state(opt, params, mesh, specs))
        for _ in range(n):
            params, state, res = step(params, state, toks)
            adam = state[1][0]
            out.append((float(res["loss"]), llt._host(params),
                        llt._host(adam.mu), llt._host(adam.nu)))
    return out, params, state


def _world(name, tmp_path_factory):
    dp, tp = WORLDS[name]
    tmp = tmp_path_factory.mktemp(name)
    inputs = {
        "mesh": {"dp": dp, "tp": tp},
        "params": params_from_jax(jax.device_get(_jparams()), "cpu"),
        "toks": _toks(), "opt": llt.OPT, "n_steps": STEPS,
        "first": {case: {"cfg": _tcfg(**kw)} for case, kw in FIRST.items()},
        "steps": {case: {"cfg": _tcfg(attn, fused_ce=fused),
                         "grad_accum": ga}
                  for case, (fused, ga, attn) in STEP_CASES.items()}}
    if name == "tp2":
        inputs["ckpt_dir"] = str(tmp / "ckpt")
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    return launch_local(_torch_tp_train_ranks.battery, dp * tp, path,
                        timeout_s=400, threads=1)


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return _world("tp2", tmp_path_factory)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return _world("tp4", tmp_path_factory)


@pytest.fixture(scope="module")
def dp2tp2(tmp_path_factory):
    return _world("dp2tp2", tmp_path_factory)


@pytest.fixture(params=list(WORLDS))
def world(request):
    return request.param, request.getfixturevalue(request.param)


def _spec_of(name):
    tree = tl.param_specs(tl.LlamaConfig.tiny())
    for key in name.split("/"):
        tree = tree[key]
    return tree


def _whole(ranks, part):
    """``part(rank)`` (a ``{name: shard}`` dict) of the dp-0 ranks
    concatenated in tp order along each leaf's sharded dimension."""
    row = sorted((r for r in ranks if r["coords"]["dp"] == 0),
                 key=lambda r: r["coords"]["tp"])
    out = {}
    for name in part(row[0]):
        spec = _spec_of(name)
        if "tp" not in spec:
            out[name] = part(row[0])[name]
        else:
            out[name] = np.concatenate([part(r)[name] for r in row],
                                       axis=spec.index("tp"))
    return out


def _close(got, want, tol):
    want = llt._flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.abs(got[name] - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), (name, err)


def _per_step(dp, layers, fused, grad_accum):
    """Collectives a step, from the code (module doc)."""
    head = 2 * (-(-(SEQ - 1) // BLOCK)) + 1 if fused else 2
    return grad_accum * (1 + 4 * layers + head) + 1 + (dp > 1)


@pytest.mark.parametrize("case", list(FIRST))
def test_first_pass_loss_and_every_gradient_match_jax(world, case):
    name, ranks = world
    fused = FIRST[case]["fused_ce"]
    loss_j, acc_j, g_j = _jax_first(REFERENCE[name], fused)
    # remat recomputes each layer's forward up to its last saved tensor
    # (torch's early stop): the attention block's "g", not the FFN's
    recomputed = LAYERS if FIRST[case].get("remat") else 0
    for r in ranks:
        got = r["first"][case]
        assert got["loss"] == pytest.approx(loss_j, rel=1e-5)
        assert got["acc"] == acc_j
        assert got["collectives"] == _per_step(
            1, LAYERS, fused, 1) - 1 + recomputed
    _close(_whole(ranks, lambda r: r["first"][case]["grads"]), g_j,
           llt.GRAD_TOL)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_the_reference_tp_step(world, case):
    name, ranks = world
    dp, _ = WORLDS[name]
    fused, ga, _ = STEP_CASES[case]
    want, _, _ = _jax_steps(REFERENCE[name], fused, ga)
    for r in ranks:
        got = r["steps"][case]
        assert got["losses"] == pytest.approx([w[0] for w in want],
                                              rel=1e-5)
        assert got["count"] == STEPS
        assert got["collectives_per_step"] == [
            _per_step(dp, LAYERS, fused, ga)] * STEPS
    _, p_j, mu_j, nu_j = want[-1]
    _close(_whole(ranks, lambda r: r["steps"][case]["params"]), p_j,
           llt.PARAM_TOL)
    _close(_whole(ranks, lambda r: r["steps"][case]["mu"]), mu_j,
           llt.MOMENT_TOL)
    _close(_whole(ranks, lambda r: r["steps"][case]["nu"]), nu_j,
           llt.MOMENT_TOL)


def test_replicated_leaves_hold_the_same_bits_on_every_rank(world):
    """The norms and their moments on every rank; each sharded leaf on
    every dp replica of its tp coordinate; one loss stream."""
    name, ranks = world
    for case in STEP_CASES:
        steps = [r["steps"][case] for r in ranks]
        assert len({s["replicated"] for s in steps}) == 1, case
        assert len({tuple(s["losses"]) for s in steps}) == 1, case
        by_tp = {}
        for r in ranks:
            by_tp.setdefault(r["coords"]["tp"], set()).add(
                r["steps"][case]["sharded"])
        assert all(len(v) == 1 for v in by_tp.values()), case
        assert len(by_tp) == WORLDS[name][1]


def test_the_mesh_coordinates_are_row_major(world):
    name, ranks = world
    dp, tp = WORLDS[name]
    assert [(r["coords"]["dp"], r["coords"]["tp"]) for r in ranks] == [
        (d, t) for d in range(dp) for t in range(tp)]


def test_vocab_parallel_argmax_ties_go_to_the_lowest_id(world):
    _, ranks = world
    for r in ranks:
        ties = r["ties"]
        assert [ties[k] for k in sorted(ties)] == [
            (1.0, 1.0), (0.0, 0.0), (0.0, 0.0)]


@pytest.fixture(scope="module")
def jax_tp2_manifest(tmp_path_factory):
    """JAX's save of its tp=2 train state after the fused steps."""
    _, params, state = _jax_steps("tp2", True, 1)
    d = jc.save_sharded(str(tmp_path_factory.mktemp("jax_ckpt")), 1,
                        {"params": params, "opt_state": state})
    with open(f"{d}/manifest.json", encoding="utf-8") as f:
        return json.load(f)


def _shard_keys(entry):
    return {s["index"]: (s["file"], s["local_shape"]) for s in
            entry["shards"]}


def test_gang_checkpoint_names_the_reference_shards(tp2, jax_tp2_manifest):
    """Every leaf, its global shape and dtype, and the union of the
    ranks' shards (file, index, local shape) are JAX's; ``wq``'s moments
    are row shards, as JAX places them."""
    want = jax_tp2_manifest["leaves"]
    union = {}
    for r, res in enumerate(tp2):
        man = res["ckpt"]["manifest"]
        assert man["process"] == r and man["num_processes"] == 2
        assert set(man["leaves"]) == set(want)
        for key, entry in man["leaves"].items():
            assert entry["global_shape"] == want[key]["global_shape"], key
            assert entry["dtype"] == want[key]["dtype"], key
            assert len(entry["shards"]) == 1
            union.setdefault(key, {}).update(_shard_keys(entry))
    for key, entry in want.items():
        assert union[key] == _shard_keys(entry), key
    mu_wq = union["opt_state.1.0.mu.layers.wq"]
    assert sorted(mu_wq) == ["o0_0_0", "o0_32_0"]
    assert sorted(union["params.layers.wq"]) == ["o0_0_0", "o0_0_32"]


def test_gang_checkpoint_rows_and_bitwise_restore(tp2):
    """The row shard each rank wrote of ``wq``'s first moment is those
    rows of the whole moment (the ranks' column shards gathered), the
    restore re-slices it back bitwise, with the counts, and the save and
    restore each gather every moved leaf (``wq``'s ``mu`` and ``nu``)
    once."""
    for r, res in enumerate(tp2):
        ck = res["ckpt"]
        assert ck["bitwise"] and ck["counts"] == (STEPS, STEPS, STEPS)
        assert ck["restore_collectives"] == 2
        meta = [s for s in ck["manifest"]["leaves"][
            "opt_state.1.0.mu.layers.wq"]["shards"]][0]
        raw = np.fromfile(f"{ck['dir']}/{meta['file']}", np.float32)
        rows = raw.reshape(meta["local_shape"])
        whole = ck["wq_mu_whole"]
        n = whole.shape[1] // 2
        np.testing.assert_array_equal(rows, whole[:, r * n:(r + 1) * n])
