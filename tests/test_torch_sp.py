"""Sequence-parallel training in the port against ONE JAX process running
the reference's own sp code over as many virtual CPU devices: gloo
gangs on the CPU (``parallel.distributed.launch_local``; a gang of 2
runs the sp2 mesh, a gang of 4 the sp2 x tp2 and dp2 x sp2 meshes, each
world started once for this module) run
``tests/_torch_tp_train_ranks.sp_battery`` on the tiny config (2 layers,
fp32, 4 x 33 tokens every rank holds), and JAX runs ``make_train_step(
mesh=, param_spec_tree=llama.param_specs(cfg), batch_spec=None)`` on
``MeshSpec(sp=2)`` and ``MeshSpec(sp=2, tp=2)`` with the same attention
(the dp=2 x sp=2 gang is held to the sp=2 mesh's references: with every
rank holding the whole batch, a dp replica changes no arithmetic of the
reference's step but the order of its row sums, and one compile a case
is shared):

* the first pass for the ring (contiguous and zigzag), Ulysses, and
  ``flash``/``dense`` (the global attention: K/V gathered over sp, held
  to the reference's ring on the same mesh): the loss within 1e-6 of
  itself, the accuracy exact, and every gradient leaf (averaged over sp,
  gathered whole over tp) within 1e-5 of its largest. The optimizer's
  clip is set above the gradient's norm, so JAX's first update holds its
  gradient (``mu = (1 - b1) g``): each case's reference is one compile of
  the reference's step;
* three steps for the ring (fused, ``grad_accum`` 1), the zigzag ring
  (unfused, ``grad_accum`` 2) and Ulysses (fused): losses within 1e-6
  of themselves, params, ``mu`` and ``nu`` within ``PARAM_TOL`` /
  ``MOMENT_TOL`` (``tests/test_torch_llama_train.py``'s);
* every leaf bitwise equal on the sp ranks of one tp coordinate (the
  parameters are replicated over sp), the norms on every rank, one loss
  stream; the collectives a step against the count from the code;
* the gang checkpoint at sp2 x tp2: the ranks' shard files, indices,
  shapes and dtypes are those of JAX's save of its sp2 x tp2 state;
* ``ring_attention`` and ``ulysses_attention`` alone against
  ``make_ring_attention`` / ``make_ulysses_attention``: the output and
  ``jax.vjp``'s gradients at sp 2 and 4, causal and full, GQA, zigzag,
  and heads repeated to the query heads (the reference's ring when tp
  does not divide the KV heads), within 2e-5;
* ``zigzag_indices``, ``zigzag_inverse`` and ``ring_pad_len`` equal to
  the reference's, and ``Mesh.ppermute``, ``all_to_all`` and
  ``gather_seq`` with their adjoints against numpy.
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
from dcos_commons_tpu.parallel import ring_attention as jra
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dcos_commons_tpu.parallel.ulysses import make_ulysses_attention
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel import ring_attention as tra
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_tp_train_ranks
from tests import test_torch_llama_train as llt

LAYERS, BATCH, SEQ, BLOCK, STEPS = 2, 4, 33, 16, 3
# above the tiny model's gradient norm: the clip passes the gradient
OPT = dict(llt.OPT, grad_clip=1e3)
B1 = 0.9                            # optax.adamw's
LOSS_RTOL, GRAD_TOL, ATTN_TOL = 1e-6, 1e-5, 2e-5
# case -> (the port's attention, JAX's, ring layout, fused_ce, grad_accum)
# (the global attention, flash and dense, is held to the reference's ring
# on the same mesh: the same attention, one compile fewer a mesh)
CASES = {"ring": ("ring", "ring", "contiguous", True, 1),
         "zigzag": ("ring", "ring", "zigzag", False, 2),
         "ulysses": ("ulysses", "ulysses", "contiguous", True, 1),
         "flash": ("flash", "ring", "contiguous", True, 1),
         "dense": ("dense", "ring", "contiguous", True, 1)}
STEP_CASES = ("ring", "zigzag", "ulysses")
MESHES = {"sp2": (1, 2, 1), "sp2tp2": (1, 2, 2), "dp2sp2": (2, 2, 1)}
# the JAX mesh each gang mesh is held to
REFERENCE = {"sp2": "sp2", "sp2tp2": "sp2tp2", "dp2sp2": "sp2"}
WORLDS = {"w2": ("sp2",), "w4": ("sp2tp2", "dp2sp2")}
CKPT_MESH = "sp2tp2"
# attention alone: name -> (fn, sp, layout, causal, KV heads of H=4)
# (causal Ulysses is the model cases' ulysses)
ATTN = {"ring_sp2": ("ring", 2, "contiguous", True, 2),
        "zigzag_sp2": ("ring", 2, "zigzag", True, 2),
        "repeated_sp2": ("ring", 2, "contiguous", True, 4),
        "ring_sp4": ("ring", 4, "contiguous", True, 1),
        "zigzag_full_sp4": ("ring", 4, "zigzag", False, 2),
        "ulysses_full_sp4": ("ulysses", 4, "contiguous", False, 4)}
ATTN_SHAPE = (2, 16, 4, 8)           # B, S, H, D


def _toks():
    return llt._tokens(batch=BATCH, seq=SEQ, seed=17)


def _jparams():
    return jl.init_params(jl.LlamaConfig.tiny(n_layers=LAYERS,
                                              dtype=jnp.float32),
                          jax.random.key(11))


def _tcfg(case):
    attn, _, layout, fused, _ = CASES[case]
    return dict(n_layers=LAYERS, attn_impl=attn, ring_layout=layout,
                dtype=torch.float32, fused_ce=fused, fused_ce_block=BLOCK)


def _attn_inputs(name):
    fn, sp, layout, causal, kv = ATTN[name]
    b, s, h, d = ATTN_SHAPE
    rng = np.random.default_rng(sorted(ATTN).index(name))
    draw = {"q": (b, s, h, d), "k": (b, s, kv, d), "v": (b, s, kv, d),
            "do": (b, s, h, d)}
    return dict(fn=fn, sp=sp, layout=layout, causal=causal,
                **{x: rng.standard_normal(shape).astype(np.float32)
                   for x, shape in draw.items()})


def _collective_inputs(world):
    return np.random.default_rng(5).standard_normal(
        (world, 2 * world, 3)).astype(np.float32)


def _world(name, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(name)
    world = 2 if name == "w2" else 4
    meshes = {}
    for m in WORLDS[name]:
        dp, sp, tp = MESHES[m]
        meshes[m] = {"mesh": {"dp": dp, "sp": sp, "tp": tp},
                     "first": {c: _tcfg(c) for c in CASES},
                     "steps": {c: {"cfg": _tcfg(c),
                                   "grad_accum": CASES[c][4]}
                               for c in STEP_CASES}}
        if m == CKPT_MESH:
            meshes[m]["ckpt_dir"] = str(tmp / "ckpt")
    inputs = {"meshes": meshes,
              "params": params_from_jax(jax.device_get(_jparams()), "cpu"),
              "toks": _toks(), "opt": OPT, "n_steps": STEPS,
              "attn": {a: _attn_inputs(a) for a in ATTN},
              "collective_inputs": _collective_inputs(world)}
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    return launch_local(_torch_tp_train_ranks.sp_battery, world, path,
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


def _placed(state, mesh):
    """The optimizer state with its counts placed as the step's outputs
    place them (replicated over the mesh), so the step compiles once."""
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P()))
        if a.ndim == 0 else a, state)


@functools.lru_cache(maxsize=None)
def _jax_run(mesh_name, case, n):
    """``n`` steps of the reference's step on ``mesh_name`` with
    ``case``'s attention: per step the loss, the accuracy and the
    params and moments whole on the host; and the final device trees."""
    _, attn, layout, fused, ga = CASES[case]
    dp, sp, tp = MESHES[mesh_name]
    mesh = JMeshSpec(dp=dp, sp=sp, tp=tp).build(jax.devices()[:dp * sp * tp])
    jcfg = jl.LlamaConfig.tiny(n_layers=LAYERS, attn_impl=attn,
                               ring_layout=layout, dtype=jnp.float32,
                               fused_ce=fused, fused_ce_block=BLOCK)
    specs = jl.param_specs(jcfg)
    toks = jnp.asarray(_toks())
    out = []
    with mesh, jax.default_matmul_precision("highest"):
        params = jl.shard_params(_jparams(), mesh, jcfg)
        opt = jt.make_optimizer(**OPT)
        step = jt.make_train_step(lambda p, b: jl.loss_fn(jcfg, p, b, mesh),
                                  opt, mesh=mesh, param_spec_tree=specs,
                                  batch_spec=None, grad_accum=ga)
        state = _placed(jt.init_opt_state(opt, params, mesh, specs), mesh)
        for _ in range(n):
            params, state, res = step(params, state, toks)
            adam = state[1][0]
            out.append({"loss": float(res["loss"]),
                        "acc": float(res["metric"]),
                        "params": llt._host(params),
                        "mu": llt._host(adam.mu), "nu": llt._host(adam.nu)})
    return out, params, state


def _jax_first(mesh_name, case):
    """The reference's first pass: its loss, accuracy and gradient (the
    first update's ``mu`` over ``1 - b1``: nothing was clipped)."""
    jcase = next(c for c in STEP_CASES if CASES[c][1:] == CASES[case][1:])
    run, _, _ = _jax_run(mesh_name, jcase, STEPS)
    first = run[0]
    grads = jax.tree.map(lambda m: m / np.float32(1 - B1), first["mu"])
    return first["loss"], first["acc"], grads


def _spec_of(name):
    tree = tl.param_specs(tl.LlamaConfig.tiny())
    for key in name.split("/"):
        tree = tree[key]
    return tree


def _whole(ranks, part):
    """``part(rank)`` of the ranks at dp 0 and sp 0, concatenated in tp
    order along each leaf's sharded dimension."""
    row = sorted((r for r in ranks if r["coords"]["dp"] == 0
                  and r["coords"]["sp"] == 0),
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


def _per_step(mesh_name, case, first_pass=False):
    """Collectives of one step (the first pass: its loss and backward),
    from the code: per microbatch and layer the attention's (the ring
    ``sp - 1`` hops forward and ``sp`` back, Ulysses two all-to-alls
    each way, the global attention one K/V gather and its
    reduce-scatter) and under tp four more, under tp one for the
    embedding and the head's (fused: two a sequence block forward and one
    backward; unfused: the gather and its input's "f"), the loss's mean
    over sp and its backward; then the clip's norm under tp and one
    gradient reduction."""
    dp, sp, tp = MESHES[mesh_name]
    attn, _, _, fused, ga = CASES[case]
    per_layer = {"ring": 2 * sp - 1, "ulysses": 4}.get(attn, 2)
    blocks = -(-((SEQ - 1) // sp) // BLOCK)
    head = (2 * blocks + 1 if fused else 2) if tp > 1 else 0
    micro = LAYERS * (per_layer + 4 * (tp > 1)) + (tp > 1) + head + 2
    if first_pass:
        return micro
    return ga * micro + (tp > 1) + 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_pass_loss_and_every_gradient_match_jax(request, mesh, case):
    ranks = _ranks(request, mesh)
    loss_j, acc_j, g_j = _jax_first(REFERENCE[mesh], case)
    for r in ranks:
        got = r["first"][case]
        assert got["loss"] == pytest.approx(loss_j, rel=LOSS_RTOL)
        assert got["acc"] == acc_j
        assert got["collectives"] == _per_step(mesh, case, first_pass=True)
    _close(_whole(ranks, lambda r: r["first"][case]["grads"]), g_j,
           GRAD_TOL)


@pytest.mark.parametrize("case", STEP_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_three_steps_match_the_reference_sp_step(request, mesh, case):
    ranks = _ranks(request, mesh)
    want, _, _ = _jax_run(REFERENCE[mesh], case, STEPS)
    for r in ranks:
        got = r["steps"][case]
        assert got["losses"] == pytest.approx([w["loss"] for w in want],
                                              rel=LOSS_RTOL)
        assert got["count"] == STEPS
        assert got["collectives_per_step"] == [_per_step(mesh, case)] * STEPS
    for part, tol in (("params", llt.PARAM_TOL), ("mu", llt.MOMENT_TOL),
                      ("nu", llt.MOMENT_TOL)):
        _close(_whole(ranks, lambda r: r["steps"][case][part]),
               want[-1][part], tol)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_sp_rank_holds_the_same_bits(request, mesh):
    """The parameters and moments are replicated over sp: every leaf's
    bits on the sp ranks of one tp coordinate, the norms on every rank,
    one loss stream; the first pass's loss on every rank."""
    ranks = _ranks(request, mesh)
    for case in STEP_CASES:
        steps = [r["steps"][case] for r in ranks]
        assert len({s["replicated"] for s in steps}) == 1, case
        assert len({tuple(s["losses"]) for s in steps}) == 1, case
        by_tp = {}
        for r in ranks:
            by_tp.setdefault(r["coords"]["tp"], set()).add(
                r["steps"][case]["sharded"])
        assert all(len(v) == 1 for v in by_tp.values()), case
    for case in CASES:
        assert len({r["first"][case]["loss"] for r in ranks}) == 1, case


def test_the_mesh_coordinates_are_row_major(w2, w4):
    for world, names in WORLDS.items():
        ranks = {"w2": w2, "w4": w4}[world]
        for m in names:
            dp, sp, tp = MESHES[m]
            assert [tuple(r["meshes"][m]["coords"][a]
                          for a in ("dp", "sp", "tp")) for r in ranks] == [
                (d, s, t) for d in range(dp) for s in range(sp)
                for t in range(tp)]


@pytest.fixture(scope="module")
def jax_ckpt_manifest(tmp_path_factory):
    """JAX's save of its sp2 x tp2 train state after the ring steps."""
    _, params, state = _jax_run(CKPT_MESH, "ring", STEPS)
    d = jc.save_sharded(str(tmp_path_factory.mktemp("jax_ckpt")), 1,
                        {"params": params, "opt_state": state})
    with open(f"{d}/manifest.json", encoding="utf-8") as f:
        return json.load(f)


def test_gang_checkpoint_names_the_reference_shards(w4, jax_ckpt_manifest):
    """Every rank writes one shard a leaf (its tp shard; the sp replicas
    their own copy, as the reference's processes do) under the whole
    leaf's shape and dtype; the union is JAX's shards, and the restore is
    bitwise with the counts."""
    want = jax_ckpt_manifest["leaves"]
    union = {}
    for r, res in enumerate(w4):
        ck = res["meshes"][CKPT_MESH]["ckpt"]
        assert ck["bitwise"] and ck["counts"] == (STEPS, STEPS, STEPS)
        man = ck["manifest"]
        assert man["process"] == r and man["num_processes"] == 4
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
def _jax_attention(name):
    """The reference's output and ``jax.vjp`` gradients of ``name``."""
    a = _attn_inputs(name)
    mesh = JMeshSpec(sp=a["sp"]).build(jax.devices()[:a["sp"]])
    if a["fn"] == "ring":
        fn = jra.make_ring_attention(mesh, causal=a["causal"],
                                     layout=a["layout"])
    else:
        fn = make_ulysses_attention(mesh, causal=a["causal"])
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    with mesh, jax.default_matmul_precision("highest"):
        out, grads = jax.jit(run)(*(jnp.asarray(a[x])
                                    for x in ("q", "k", "v", "do")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(ATTN))
def test_attention_and_its_gradients_match_the_reference(w2, w4, name):
    fn, sp, _, _, _ = ATTN[name]
    want, want_grads = _jax_attention(name)
    ranks = w2 if sp == 2 else w4
    hops = {"ring": 2 * sp - 1, "ulysses": 4}[fn]
    for r in ranks:
        got = r["attn"][name]
        cut = slice(*got["at"])
        np.testing.assert_allclose(got["out"], want[:, cut], atol=ATTN_TOL,
                                   rtol=0)
        for g, w in zip(got["grads"], want_grads):
            np.testing.assert_allclose(g, w[:, cut], atol=ATTN_TOL, rtol=0)
        assert got["collectives"] == hops


@pytest.mark.parametrize("seq,ring", [(16, 2), (32, 4), (64, 8), (12, 3)])
def test_zigzag_helpers_are_the_reference_s_bit_for_bit(seq, ring):
    for fn in ("zigzag_indices", "zigzag_inverse"):
        got, want = getattr(tra, fn)(seq, ring), getattr(jra, fn)(seq, ring)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    for n, mult in ((1, 1), (17, 1), (17, 16), (100, 64), (5, 6)):
        assert tra.ring_pad_len(n, ring, mult) == \
            jra.ring_pad_len(n, ring, mult)
    with pytest.raises(ValueError):
        tra.zigzag_indices(seq + 1, ring)
    with pytest.raises(ValueError):
        tra.ring_pad_len(0, ring)


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_sp_collectives_and_their_adjoints(request, world):
    """``ppermute`` (both ways), ``all_to_all`` (split dim 0, concat dim
    1) and ``gather_seq`` on rank r's ``x[r]``, and the gradients of
    ``sum(w[r] * y)``, against their definitions in numpy."""
    ranks = request.getfixturevalue(world)
    n = len(ranks)
    x = _collective_inputs(n)
    y_shape = {"ppermute": x[0].shape, "ppermute_back": x[0].shape,
               "all_to_all": (2, 3 * n), "gather_seq": (2 * n * n, 3)}
    w = {k: [np.arange(np.prod(s), dtype=np.float32).reshape(s) * (r + 1)
             for r in range(n)] for k, s in y_shape.items()}
    for r, res in enumerate(ranks):
        c = res["collectives"]
        for name, shift in (("ppermute", 1), ("ppermute_back", -1)):
            np.testing.assert_array_equal(c[name]["y"], x[(r - shift) % n])
            np.testing.assert_array_equal(c[name]["grad"],
                                          w[name][(r + shift) % n])
        a2a = np.concatenate([x[j][2 * r:2 * r + 2] for j in range(n)],
                             axis=1)
        np.testing.assert_array_equal(c["all_to_all"]["y"], a2a)
        np.testing.assert_array_equal(c["no_grad_all_to_all"], a2a)
        np.testing.assert_array_equal(c["all_to_all"]["grad"], np.concatenate(
            [w["all_to_all"][j][:, 3 * r:3 * r + 3] for j in range(n)]))
        np.testing.assert_array_equal(c["gather_seq"]["y"],
                                      np.concatenate(list(x)))
        np.testing.assert_allclose(
            c["gather_seq"]["grad"],
            sum(w["gather_seq"])[2 * n * r:2 * n * (r + 1)], rtol=1e-6)
