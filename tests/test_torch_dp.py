"""Data-parallel training in the port against ONE JAX process on the whole
global batch, which is the reference's dp semantics by construction
(GSPMD's dp step is one program over the global batch): gangs of 2 and 4
gloo ranks on the CPU (``parallel.distributed.launch_local``, each world
started once for this module) run ``tests/_torch_dp_ranks.battery`` on
``MeshSpec(dp=world)``, each rank on its slice of one numpy batch.

* ResNet-18 at width 8, 32x32 images, fp32, a global batch of 8 (ranks
  of 4 and 2 images): the loss, the accuracy, every batch-norm state
  leaf and every gradient (averaged over dp) of the first pass, and
  three train steps (loss, params, both moments, state, count), with the
  tolerances of ``tests/test_torch_resnet.py``'s
  ``test_loss_state_and_every_gradient_match_jax`` (its ``r18_even``
  case: forward and state 1e-4, every gradient within 5e-4 of the
  largest) and ``test_three_aux_steps_match_jax`` (loss rel 1e-5, state
  1e-4, moments 1e-5, params ``PARAM_TOL`` with at most 1 element in
  10,000 over it [6 of 177,362 at dp=2, 7 at dp=4]). One bound is
  loosened: no element may pass TWICE the sum of the rates so far (the
  one-device test: once). At 32x32 the last stage is 1x1 and its batch
  norms see 8 values a channel, so some gradient elements are rounding
  noise (the worst, of ``stage3_block1/conv1``: -3.6e-7 against the
  leaf's largest 0.46), and Adam, which divides each gradient by its own
  magnitude, moves such an element by its full rate in the direction of
  its noise: the dp sums flip its sign against JAX's [5.6e-4 at dp=2
  against a rate of 5e-4; one process of the port on the same batch,
  2.6e-4]. For the same reason the loss after an update is held within
  rel 5e-5, not 1e-5 [step 3: 1.8e-5 at dp=2; one process of the port on
  the same batch, 1.9e-5]. Params, optimizer state and
  batch-norm state are bitwise equal across ranks after the steps, and a
  step issues one collective a batch norm forward and backward plus ONE
  for all the gradients.
* distill (a 2-layer fp32 teacher, a 1-layer draft) at dp=2 over
  batches of 4 and 3 rows (rows 2 + 1: each rank's gradient weighted by
  its share), against JAX's distill step in one process: losses within
  ``tests/test_torch_distill.py``'s 1e-5, the draft's params within
  ``PARAM_TOL``;
* ``llama-train``'s step at dp=2 (``max(2 * dp, 1)`` = 4 rows) with
  ``grad_accum`` 1 and 2 (each rank splits its own 2 rows) against
  JAX's step with the same ``grad_accum`` on the whole batch:
  ``tests/test_torch_llama_train.py``'s tolerances (loss rel 1e-5,
  moments 1e-5, params ``PARAM_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import resnet as jr
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops import losses as jlo
from dcos_commons_tpu_torch.models import train as tt
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.parallel import mesh as tmesh
from dcos_commons_tpu_torch.parallel.distributed import launch_local
from tests import _torch_dp_ranks
from tests import test_torch_llama_train as llt
from tests import test_torch_resnet as rt

GLOBAL_BATCH, SIZE, STEPS = 8, 32, 3
FWD_TOL, GRAD_TOL = 1e-4, 5e-4          # test_torch_resnet's r18_even
DISTILL_OPT = dict(lr=1e-3, warmup=5, decay_steps=10)
DISTILL_STEPS, LLAMA_STEPS, LLAMA_SEQ = 3, 3, 32


def _resnet_inputs():
    jcfg, _ = rt._cfgs(18, 8)
    (jp, js), (tp, ts) = rt._trees(jcfg)
    x, y = rt._batch(SIZE, GLOBAL_BATCH, seed=7)
    spec = {"cfg": dict(depth=18, width=8, n_classes=rt.N_CLASSES,
                        dtype=torch.float32),
            "params": tp, "state": ts, "x": x, "y": y, "opt": rt.OPT,
            "steps": STEPS}
    return spec, (jcfg, jp, js, x, y)


def _distill_pair():
    cfg_t = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                                dtype=jnp.float32)
    return cfg_t, jl.init_params(cfg_t, jax.random.key(0))


def _distill_toks(rows):
    return np.random.default_rng(10 + rows).integers(
        0, 256, (rows, 32)).astype(np.int32)


def _llama_toks():
    return llt._tokens(batch=4, seq=LLAMA_SEQ + 1, seed=6)


def _world(n, tmp_path_factory, extras):
    resnet, _ = _resnet_inputs()
    inputs = {"resnet": resnet}
    if extras:
        cfg_t, jp_t = _distill_pair()
        tp_t = params_from_jax(jax.device_get(jp_t), device="cpu")
        inputs["distill"] = {
            f"b{rows}": {"cfg": dict(n_layers=2, max_seq=64,
                                     attn_impl="dense",
                                     dtype=torch.float32),
                         "params": tp_t, "layers": 1,
                         "toks": _distill_toks(rows), "opt": DISTILL_OPT,
                         "steps": DISTILL_STEPS}
            for rows in (4, 3)}
        jcfg, _ = llt._cfgs()
        _, tp = llt._params(jcfg, seed=5)
        inputs["llama_train"] = {
            f"ga{ga}": {"cfg": dict(attn_impl="dense", dtype=torch.float32),
                        "params": tp, "toks": _llama_toks(), "opt": llt.OPT,
                        "grad_accum": ga, "steps": LLAMA_STEPS}
            for ga in (1, 2)}
    path = str(tmp_path_factory.mktemp(f"dp{n}") / "inputs.pt")
    torch.save(inputs, path)
    return launch_local(_torch_dp_ranks.battery, n, path, timeout_s=400,
                        threads=1)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _world(2, tmp_path_factory, extras=True)


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return _world(4, tmp_path_factory, extras=False)


@pytest.fixture(params=["dp2", "dp4"])
def world(request):
    return request.param, request.getfixturevalue(request.param)


@pytest.fixture(scope="module")
def jax_resnet():
    """One JAX process on the whole global batch: the first pass (loss,
    accuracy, state, gradients) and three train steps."""
    _, (jcfg, jp, js, x, y) = _resnet_inputs()

    def first(p, s, xx, yy):
        return jax.value_and_grad(
            lambda p_: jr.loss_fn(jcfg, p_, s, (xx, yy)), has_aux=True)(p)

    with jax.default_matmul_precision("highest"):
        (loss, (acc, state)), grads = jax.jit(first)(
            jp, js, jnp.asarray(x), jnp.asarray(y))
    return {"loss": float(loss), "acc": float(acc),
            "state": jax.device_get(state), "grads": jax.device_get(grads),
            "steps": rt._jax_steps(jcfg, jp, js, x, y, STEPS)}


# ---------------------------------------------------------------------------
# ResNet


def test_resnet_first_pass_matches_one_jax_process(world, jax_resnet):
    """Loss, accuracy and batch-norm state over the global batch, and
    every gradient averaged over dp, on every rank."""
    _, ranks = world
    want = jax_resnet
    for r in ranks:
        got = r["resnet"]
        assert got["loss"] == pytest.approx(want["loss"], rel=FWD_TOL)
        assert got["acc"] == want["acc"]
        rt._leaf_close(got["state"], want["state"], FWD_TOL)
        rt._grads_close(got["grads"], want["grads"], GRAD_TOL)


def test_resnet_three_steps_match_one_jax_process(world, jax_resnet):
    """Loss, params, both moments, the batch-norm state and the count
    after each of three steps, as ``test_three_aux_steps_match_jax``
    holds the one-device step."""
    _, ranks = world
    rates = 0.0
    opt = tt.make_optimizer(**rt.OPT)
    for i, want in enumerate(jax_resnet["steps"]):
        loss_j, p_j, mu_j, nu_j, st_j, count_j = want
        rates += opt.schedule(i)
        loss_t, p_t, mu_t, nu_t, st_t, count_t = ranks[0]["resnet"][
            "steps"][i]
        assert loss_t == pytest.approx(loss_j, rel=1e-5 if i == 0 else
                                       5e-5), i
        assert count_t == count_j == i + 1
        rt._leaf_close(st_t, st_j, rt.STATE_TOL)
        rt._leaf_close(mu_t, mu_j, rt.MOMENT_TOL)
        rt._leaf_close(nu_t, nu_j, rt.MOMENT_TOL)
        over, total = 0, 0
        for name, want_p in rt._flat(p_j).items():
            err = np.abs(rt._flat(p_t)[name] - want_p)
            over += int((err > rt.PARAM_TOL).sum())
            total += err.size
            assert float(err.max()) <= 2 * rates * (1 + rt.OPT["lr"]), (
                i, name)
        assert over <= total // 10_000, (i, over)


def test_replicas_hold_the_same_bits(world):
    """Params, both moments and the batch-norm state bitwise equal on
    every rank after the steps, and the same loss at every step."""
    _, ranks = world
    assert len({r["resnet"]["digest"] for r in ranks}) == 1
    losses = {tuple(s[0] for s in r["resnet"]["steps"]) for r in ranks}
    assert len(losses) == 1
    for r in ranks:
        for case in r.get("distill", {}):
            assert r["distill"][case]["digest"] == \
                ranks[0]["distill"][case]["digest"]
        for case in r.get("llama_train", {}):
            assert r["llama_train"][case]["digest"] == \
                ranks[0]["llama_train"][case]["digest"]


def test_a_resnet_step_issues_one_collective_a_batch_norm_pass(world):
    """ResNet-18 has 20 batch norms: 20 all-reduce-means forward, 20
    backward, and one for every gradient with the loss and metric."""
    name, ranks = world
    for r in ranks:
        assert r["resnet"]["collectives_per_step"] == [41] * STEPS
        assert r["coords"]["dp"] == r["rank"]


# ---------------------------------------------------------------------------
# distill and llama-train: every rank holds the whole batch


def _jax_distill(rows):
    cfg_t, params_t = _distill_pair()
    cfg_d, params_d = jl.truncate_layers(cfg_t, params_t, 1)
    params_d = jax.tree.map(jnp.array, params_d)

    def loss_fn(p_d, batch):
        with jax.default_matmul_precision("highest"):
            x_t = jax.lax.stop_gradient(
                jl.forward(cfg_t, params_t, batch, return_hidden=True))
            x_s = jl.forward(cfg_d, p_d, batch, return_hidden=True)
            loss = jlo.fused_linear_distillation(
                x_s, p_d["lm_head"], x_t, params_t["lm_head"])
        return loss, loss

    opt = jt.make_optimizer(**DISTILL_OPT)
    step = jt.make_train_step(loss_fn, opt)
    state, losses = opt.init(params_d), []
    toks = jnp.asarray(_distill_toks(rows))
    for _ in range(DISTILL_STEPS):
        params_d, state, o = step(params_d, state, toks)
        losses.append(float(o["loss"]))
    return losses, jax.device_get(params_d)


@pytest.mark.parametrize("rows,split", [(4, [(0, 2), (2, 2)]),
                                        (3, [(0, 2), (2, 1)])])
def test_distill_at_dp2_matches_one_jax_process(dp2, rows, split):
    """Each rank backpropagates its rows; the gradients are weighted by
    each rank's share, so batch 3 (2 + 1 rows) is one process's step."""
    losses_j, params_j = _jax_distill(rows)
    for r in dp2:
        got = r["distill"][f"b{rows}"]
        assert list(got["rows"]) == list(split[r["rank"]])
        assert got["losses"] == pytest.approx(losses_j, rel=1e-5)
        llt._tree_close(got["params"], params_j, llt.PARAM_TOL)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_llama_train_at_dp2_matches_jax_step(dp2, grad_accum):
    jcfg, _ = llt._cfgs()
    jp, _ = llt._params(jcfg, seed=5)
    want, _, _ = llt._jax_run(jcfg, jp, _llama_toks(), LLAMA_STEPS,
                              grad_accum=grad_accum)
    for r in dp2:
        got = r["llama_train"][f"ga{grad_accum}"]
        assert got["losses"] == pytest.approx([w[0] for w in want],
                                              rel=1e-5)
        _, p_j, mu_j, nu_j = want[-1]
        llt._tree_close(got["params"], p_j, llt.PARAM_TOL)
        llt._tree_close(got["mu"], mu_j, llt.MOMENT_TOL)
        llt._tree_close(got["nu"], nu_j, llt.MOMENT_TOL)


@pytest.mark.parametrize("n,dp,want", [
    (4, 2, [(0, 2), (2, 2)]), (3, 2, [(0, 2), (2, 1)]),
    (1, 2, [(0, 1), (1, 0)]), (7, 4, [(0, 2), (2, 2), (4, 2), (6, 1)]),
    (2, 4, [(0, 1), (1, 1), (2, 0), (2, 0)])])
def test_dp_rows_is_array_split(n, dp, want):
    got = []
    for r in range(dp):
        shape = {a: 1 for a in tmesh.AXES}
        shape["dp"] = dp
        coords = tmesh.mesh_coords(shape, r)
        got.append(tt.dp_rows(n, tmesh.Mesh(shape, coords,
                                            torch.device("cpu"), "gloo",
                                            rank=r)))
    assert got == want
    assert [len(a) for a in np.array_split(np.arange(n), dp)] == \
        [c for _, c in want]
