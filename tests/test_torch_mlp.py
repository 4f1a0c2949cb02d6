"""The port's MNIST MLP (``dcos_commons_tpu_torch/models/mlp.py``) and
``ops/norms.py`` ``layer_norm`` against the JAX reference on the CPU, on
the same trees (the JAX init carried over with ``params_from_jax``) and
the same numpy batches.

Tolerances: fp32 logits within 1e-5 relative; bf16 logits within 2e-2 of
the largest logit (each product and bias add rounds to bf16 in both, in
orders that may differ); 20 fp32 train steps (the worker's optimizer,
``make_optimizer(lr=1e-3)``, a new batch each step): loss within 1e-5
relative, moments within 1e-5 of each leaf's largest, parameters within
5e-2 of the rate at each step, except at most 1 element in 10,000 (an
element whose first moment nearly cancels turns a last-bits difference
of its gradient into a visible share of its Adam step), which stays
within the sum of the rates so far. ``layer_norm`` within 1e-6 in fp32
and one bf16 ulp in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import mlp as jm
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops import norms as jn
from dcos_commons_tpu_torch.models import mlp as tm
from dcos_commons_tpu_torch.models import train as tt
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.ops import norms as tn

LR = 1e-3
PARAM_TOL = 5e-2 * LR


def _cfgs(dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jm.MLPConfig(dtype=jdt, **kw), tm.MLPConfig(dtype=tdt, **kw)


def _params(jcfg):
    jp = jm.init_params(jcfg, jax.random.key(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _batch(seed, n=256, in_dim=784):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, in_dim)).astype(np.float32),
            rng.integers(0, 10, (n,)).astype(np.int32))


def test_config_and_init_match_the_reference():
    j, t = jm.MLPConfig(), tm.MLPConfig()
    assert (t.in_dim, t.hidden, t.n_classes) == (j.in_dim, j.hidden,
                                                 j.n_classes)
    assert t.dtype == torch.bfloat16
    jp = jax.eval_shape(lambda: jm.init_params(j, jax.random.key(0)))
    tp = tm.init_params(t, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tp) == sorted(jp) == ["layer0", "layer1", "layer2"]
    for name, layer in jp.items():
        for k in ("w", "b"):
            assert tuple(tp[name][k].shape) == layer[k].shape
            assert tp[name][k].dtype == torch.bfloat16
        assert not tp[name]["b"].any()
    assert float(tp["layer0"]["w"].float().std()) == pytest.approx(
        (2 / 784) ** 0.5, rel=0.05)


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 2e-2)])
def test_forward_and_loss_match_jax(dtype, tol):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    x, y = _batch(0, n=32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.forward(jcfg, jp, jnp.asarray(x)))
        loss_j, acc_j = jm.loss_fn(jcfg, jp, (jnp.asarray(x),
                                              jnp.asarray(y)))
    got = tm.forward(tcfg, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (32, 10)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)
    loss_t, acc_t = tm.loss_fn(tcfg, tp, (torch.from_numpy(x),
                                          torch.from_numpy(y)))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=tol, abs=tol)
    if dtype == "fp32":
        assert float(acc_t) == float(acc_j)


def test_twenty_train_steps_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jopt = jt.make_optimizer(lr=LR)
    jstep = jt.make_train_step(lambda p, b: jm.loss_fn(jcfg, p, b), jopt)
    jstate = jopt.init(jp)
    opt = tt.make_optimizer(lr=LR)
    step = tt.make_train_step(lambda p, b: tm.loss_fn(tcfg, p, b), opt)
    state = tt.init_opt_state(opt, tp)
    rates = 0.0
    for i in range(20):
        x, y = _batch(i + 1)
        with jax.default_matmul_precision("highest"):
            jp, jstate, jout = jstep(jp, jstate, (jnp.asarray(x),
                                                  jnp.asarray(y)))
        tp, state, out = step(tp, state, (torch.from_numpy(x),
                                          torch.from_numpy(y)))
        rates += opt.schedule(i)
        assert float(out["loss"]) == pytest.approx(float(jout["loss"]),
                                                   rel=1e-5), i
        assert float(out["metric"]) == float(jout["metric"]), i
        adam = jax.device_get(jstate[1][0])
        assert state.count == int(adam.count) == i + 1
        host = jax.device_get(jp)
        over = total = 0
        for name, layer in host.items():
            for k in ("w", "b"):
                for got, want in ((state.mu[name][k], adam.mu[name][k]),
                                  (state.nu[name][k], adam.nu[name][k])):
                    want = np.asarray(want)
                    err = float(np.abs(got.numpy() - want).max())
                    assert err <= 1e-5 * max(1.0, float(
                        np.abs(want).max())), (i, name, k)
                err = np.abs(tp[name][k].numpy() - np.asarray(layer[k]))
                over += int((err > PARAM_TOL).sum())
                total += err.size
                assert float(err.max()) <= rates * (1 + LR), (i, name, k)
        assert over <= total // 10_000, (i, over)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6),
                                        ("bfloat16", 2 ** -7)])
def test_layer_norm_matches_jax(dtype, atol):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 6, 96)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jn.layer_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                         jnp.asarray(b))
    got = tn.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                        torch.from_numpy(b))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=atol,
                               atol=atol)
    # eps 1e-6 by default, as the reference; a wide eps changes the result
    wide = tn.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), eps=10.0)
    assert not torch.allclose(wide, got.float())
