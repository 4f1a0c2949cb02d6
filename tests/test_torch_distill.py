"""The port's distillation head (``dcos_commons_tpu_torch/ops/losses.py``
``fused_linear_distillation`` and ``softmax_kl_divergence``) and the
distill train step against the JAX reference on the same numpy inputs,
in the style of ``tests/test_distill.py``: the loss value over mask x
temperature x block (with a padded tail), the student gradients, no
gradient on the teacher side, an int8 teacher head and an int8 student
head, the coded errors, and AdamW steps of the worker's distill loss on a
tiny teacher/student pair, with the teacher bit-identical afterwards.

Tolerances (fp32 on both sides, the JAX products at ``highest``
precision): loss values within 1e-5 relative; student gradients within
1e-4 of each tensor's largest magnitude (blocked sums in another order);
an int8 head within 1e-5 relative (the same int8 payload and scales on
both sides); the distill loop's losses within 1e-5 relative over four
AdamW steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops import losses as jlo
from dcos_commons_tpu.ops.quant import quantize as jquantize
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import speculative as tspec
from dcos_commons_tpu_torch.models import train as tt
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.ops import losses as tlo

B, S, DS, DT, V = 2, 16, 24, 32, 97
VALUE_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup=5, decay_steps=10)   # the workload's schedule


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x_s = rng.standard_normal((B, S, DS)).astype(np.float32)
    x_t = rng.standard_normal((B, S, DT)).astype(np.float32)
    w_s = (rng.standard_normal((DS, V)) * DS ** -0.5).astype(np.float32)
    w_t = (rng.standard_normal((DT, V)) * DT ** -0.5).astype(np.float32)
    mask = rng.uniform(size=(B, S)) > 0.3
    return x_s, w_s, x_t, w_t, mask


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _qtensor(q):
    """A JAX ``QTensor`` as the port's (same int8 payload and scales)."""
    return params_from_jax({"w": jax.device_get(q)}, device="cpu")["w"]


def _jax_fused(x_s, w_s, x_t, w_t, mask, temp, block):
    with jax.default_matmul_precision("highest"):
        return jlo.fused_linear_distillation(
            jnp.asarray(x_s), w_s, jnp.asarray(x_t), w_t,
            mask=None if mask is None else jnp.asarray(mask),
            temperature=temp, block_size=block)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


CASES = [(False, 1.0, 4), (True, 2.0, 4), (True, 1.0, 16), (False, 0.5, 5),
         (True, 0.7, 5)]


@pytest.mark.parametrize("mask_on,temp,block", CASES)
def test_value_parity(mask_on, temp, block):
    x_s, w_s, x_t, w_t, mask = _data()
    m = mask if mask_on else None
    want = float(_jax_fused(x_s, w_s, x_t, w_t, m, temp, block))
    got = tlo.fused_linear_distillation(
        _t(x_s), _t(w_s), _t(x_t), _t(w_t),
        mask=None if m is None else _t(m), temperature=temp,
        block_size=block)
    assert float(got) == pytest.approx(want, rel=VALUE_RTOL)
    with jax.default_matmul_precision("highest"):
        want_plain = float(jlo.softmax_kl_divergence(
            jnp.asarray(x_s @ w_s), jnp.asarray(x_t @ w_t),
            mask=None if m is None else jnp.asarray(m), temperature=temp))
    got_plain = tlo.softmax_kl_divergence(
        _t(x_s @ w_s), _t(x_t @ w_t), mask=None if m is None else _t(m),
        temperature=temp)
    assert float(got_plain) == pytest.approx(want_plain, rel=VALUE_RTOL)
    assert float(got) == pytest.approx(float(got_plain), rel=VALUE_RTOL)


@pytest.mark.parametrize("mask_on,temp,block", CASES[:2] + CASES[3:])
def test_student_grad_parity(mask_on, temp, block):
    x_s, w_s, x_t, w_t, mask = _data(1)
    m = mask if mask_on else None
    gx_j, gw_j = jax.grad(
        lambda xs, ws: _jax_fused(xs, ws, x_t, w_t, m, temp, block),
        argnums=(0, 1))(jnp.asarray(x_s), jnp.asarray(w_s))
    xs, ws = _t(x_s, True), _t(w_s, True)
    tlo.fused_linear_distillation(
        xs, ws, _t(x_t), _t(w_t), mask=None if m is None else _t(m),
        temperature=temp, block_size=block).backward()
    _close(xs.grad.numpy(), gx_j, GRAD_TOL)
    _close(ws.grad.numpy(), gw_j, GRAD_TOL)
    assert ws.grad.dtype == torch.float32


def test_teacher_side_gets_no_gradient():
    """The teacher is a frozen reference: its hidden states and head get
    no gradient even when they ask for one."""
    x_s, w_s, x_t, w_t, mask = _data(2)
    xs, xt, wt = _t(x_s, True), _t(x_t, True), _t(w_t, True)
    loss = tlo.fused_linear_distillation(xs, _t(w_s), xt, wt,
                                         mask=_t(mask), block_size=4)
    loss.backward()
    assert xt.grad is None and wt.grad is None
    assert xs.grad is not None and xs.grad.abs().sum() > 0


def test_quantized_teacher_head_parity():
    """An int8 serving target distills without dequantizing its head:
    the same value as the reference's fused head on the same int8
    payload, and the same student gradients."""
    x_s, w_s, x_t, w_t, mask = _data(3)
    q_t = jquantize(jnp.asarray(w_t))
    want = float(_jax_fused(x_s, w_s, x_t, q_t, mask, 1.0, 4))
    gx_j = jax.grad(lambda xs: _jax_fused(xs, w_s, x_t, q_t, mask, 1.0, 4)
                    )(jnp.asarray(x_s))
    xs = _t(x_s, True)
    got = tlo.fused_linear_distillation(xs, _t(w_s), _t(x_t), _qtensor(q_t),
                                        mask=_t(mask), block_size=4)
    got.backward()
    assert float(got.detach()) == pytest.approx(want, rel=VALUE_RTOL)
    _close(xs.grad.numpy(), gx_j, GRAD_TOL)


def test_quantized_student_head_gets_only_dx():
    """A quantized student head is frozen (no gradient); its hidden
    states still get the reference's gradient."""
    x_s, w_s, x_t, w_t, mask = _data(4)
    q_s = jquantize(jnp.asarray(w_s))
    gx_j = jax.grad(lambda xs: _jax_fused(xs, q_s, x_t, w_t, None, 2.0, 5)
                    )(jnp.asarray(x_s))
    xs = _t(x_s, True)
    tlo.fused_linear_distillation(xs, _qtensor(q_s), _t(x_t), _t(w_t),
                                  temperature=2.0, block_size=5).backward()
    _close(xs.grad.numpy(), gx_j, GRAD_TOL)


def test_coded_errors():
    x_s, w_s, x_t, w_t, _ = _data()
    with pytest.raises(ValueError, match="temperature"):
        tlo.fused_linear_distillation(_t(x_s), _t(w_s), _t(x_t), _t(w_t),
                                      temperature=0.0)
    with pytest.raises(ValueError, match="token shapes"):
        tlo.fused_linear_distillation(_t(x_s[:, :-1]), _t(w_s), _t(x_t),
                                      _t(w_t))


# ------------------------------------------------------- distill train step

STEPS = 4


def _jax_pair():
    cfg_t = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                                dtype=jnp.float32)
    params_t = jl.init_params(cfg_t, jax.random.key(0))
    cfg_d, params_d = jl.truncate_layers(cfg_t, params_t, 1)
    return cfg_t, params_t, cfg_d, jax.tree.map(jnp.array, params_d)


def _toks():
    return np.random.default_rng(1).integers(0, 256, (2, 32)).astype(
        np.int32)


def _jax_trajectory():
    cfg_t, params_t, cfg_d, params_d = _jax_pair()
    toks = jnp.asarray(_toks())

    def loss_fn(p_d, batch):
        with jax.default_matmul_precision("highest"):
            x_t = jax.lax.stop_gradient(
                jl.forward(cfg_t, params_t, batch, return_hidden=True))
            x_s = jl.forward(cfg_d, p_d, batch, return_hidden=True)
            loss = jlo.fused_linear_distillation(
                x_s, p_d["lm_head"], x_t, params_t["lm_head"])
        return loss, loss

    opt = jt.make_optimizer(**OPT)
    step = jt.make_train_step(loss_fn, opt)
    state = opt.init(params_d)
    out = []
    for _ in range(STEPS):
        params_d, state, o = step(params_d, state, toks)
        out.append(float(o["loss"]))
    return out


def test_distill_steps_track_jax_and_leave_the_teacher_bit_identical():
    """AdamW steps of the worker's distill loss
    (``speculative.draft_student``, ``speculative.distill_loss``): the port's losses follow the reference's loop, the
    student moves, and the teacher (whose first layer, embedding, norm
    and head the student started as) stays bit for bit what it was."""
    cfg_t, params_t, cfg_d, _ = _jax_pair()
    tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                               dtype=torch.float32)
    tp_t = params_from_jax(jax.device_get(params_t), device="cpu")
    frozen = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  {n: w.clone() for n, w in v.items()})
              for k, v in tp_t.items()}
    tcfg_d, tp_d = tspec.draft_student(tcfg, tp_t, 1)
    toks = torch.from_numpy(_toks())
    loss_fn = tspec.distill_loss(tcfg, tp_t, tcfg_d, 1.0)
    opt = tt.make_optimizer(**OPT)
    step = tt.make_train_step(loss_fn, opt)
    state = tt.init_opt_state(opt, tp_d)
    got = []
    for _ in range(STEPS):
        tp_d, state, o = step(tp_d, state, toks)
        got.append(float(o["loss"]))
    want = _jax_trajectory()
    assert got == pytest.approx(want, rel=VALUE_RTOL)
    assert got[-1] < got[0], got
    assert not torch.equal(tp_d["lm_head"], frozen["lm_head"])
    for k, v in frozen.items():
        for n, w in (v.items() if isinstance(v, dict) else [(k, v)]):
            now = tp_t[k][n] if isinstance(v, dict) else tp_t[k]
            assert torch.equal(now, w), (k, n)
