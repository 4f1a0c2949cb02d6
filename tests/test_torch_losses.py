"""The port's loss heads (``dcos_commons_tpu_torch/ops/losses.py``) against
the JAX reference on the same numpy inputs: ``fused_linear_cross_entropy``
(loss, accuracy, dx, dw) with z-loss on and off, a mask, ``S % block !=
0`` and an int8 head (dx only), and ``softmax_cross_entropy`` (loss,
accuracy, dlogits).

Tolerance: fp32 within 1e-5 for losses and gradients (both sides compute
in fp32; the blocked sums run in another order); accuracy exactly (argmax
picks the first maximum on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.ops import losses as jl
from dcos_commons_tpu.ops import quant as jquant
from dcos_commons_tpu_torch.models.bridge import tensor_from_numpy
from dcos_commons_tpu_torch.ops import losses as tl
from dcos_commons_tpu_torch.ops.quant import QTensor

B, S, D, V = 2, 16, 32, 97
TOL = 1e-5
CPU = torch.device("cpu")


def _data(seed=0, s=S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, s)).astype(np.int32)
    mask = (rng.uniform(size=(B, s)) > 0.3).astype(np.float32)
    return x, w, labels, mask


def _jax_fused(x, w, labels, mask, z_loss, block):
    def f(x_, w_):
        loss, acc = jl.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(labels), mask=mask, z_loss=z_loss,
            block_size=block)
        return loss, acc

    with jax.default_matmul_precision("highest"):
        (loss, acc), vjp = jax.vjp(f, x, w)
        dx, dw = vjp((jnp.ones(()), jnp.zeros(())))
    return float(loss), float(acc), np.asarray(dx), np.asarray(dw)


def _port_fused(x, w, labels, mask, z_loss, block):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask)
    loss, acc = tl.fused_linear_cross_entropy(
        xt, wt, torch.from_numpy(labels), mask=m, z_loss=z_loss,
        block_size=block)
    loss.backward()
    assert not acc.requires_grad
    return (float(loss.detach()), float(acc), xt.grad.numpy(),
            wt.grad.numpy())


@pytest.mark.parametrize("mask_on,z_loss,block", [
    (False, 0.0, 4),
    (True, 1e-4, 4),
    (True, 0.0, 16),     # block == S
    (False, 1e-4, 5),    # S % block != 0: padded under the mask
    (True, 1e-4, 512),   # one block larger than S (the train default)
])
def test_fused_linear_cross_entropy_matches_jax(mask_on, z_loss, block):
    x, w, labels, mask = _data()
    m = mask if mask_on else None
    got = _port_fused(x, w, labels, m, z_loss, block)
    want = _jax_fused(x, w, labels, m, z_loss, block)
    assert abs(got[0] - want[0]) < TOL
    assert got[1] == pytest.approx(want[1], abs=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=TOL)


def test_fused_matches_unfused_port_loss():
    x, w, labels, mask = _data(seed=1)
    got = _port_fused(x, w, labels, mask, 1e-4, 3)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss, acc = tl.softmax_cross_entropy(
        xt @ wt, torch.from_numpy(labels), mask=torch.from_numpy(mask),
        z_loss=1e-4)
    loss.backward()
    assert abs(got[0] - float(loss.detach())) < TOL
    assert got[1] == float(acc)
    np.testing.assert_allclose(got[2], xt.grad.numpy(), atol=TOL)
    np.testing.assert_allclose(got[3], wt.grad.numpy(), atol=TOL)


def test_fused_int8_head_gradient_flows_through_x_only():
    x, w, labels, mask = _data(seed=2)
    jq = jquant.quantize(jnp.asarray(w), axis=-2)
    tq = QTensor(tensor_from_numpy(np.asarray(jq.q), CPU),
                 tensor_from_numpy(np.asarray(jq.s), CPU))

    def f(x_):
        return jl.fused_linear_cross_entropy(
            x_, jq, jnp.asarray(labels), mask=mask, z_loss=1e-4,
            block_size=5)[0]

    with jax.default_matmul_precision("highest"):
        loss_j, dx_j = jax.value_and_grad(f)(x)
    xt = torch.from_numpy(x).requires_grad_()
    loss_t, _ = tl.fused_linear_cross_entropy(
        xt, tq, torch.from_numpy(labels), mask=torch.from_numpy(mask),
        z_loss=1e-4, block_size=5)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) < TOL
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), atol=TOL)


def test_fused_leading_dims_flatten():
    x, w, labels, _ = _data(seed=3)
    got = _port_fused(x.reshape(1, B, S, D), w, labels.reshape(1, B, S),
                      None, 0.0, 4)
    want = _port_fused(x, w, labels, None, 0.0, 4)
    assert got[0] == pytest.approx(want[0], abs=1e-7)
    np.testing.assert_allclose(got[2].reshape(B, S, D), want[2], atol=1e-7)


@pytest.mark.parametrize("mask_on,z_loss", [(False, 0.0), (True, 1e-4)])
def test_softmax_cross_entropy_matches_jax(mask_on, z_loss):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((B, S, V)).astype(np.float32) * 3
    _, _, labels, mask = _data(seed=4)
    m = mask if mask_on else None
    (loss_j, acc_j), vjp = jax.vjp(
        lambda lg: jl.softmax_cross_entropy(
            lg, jnp.asarray(labels), mask=m, z_loss=z_loss), logits)
    dlog_j = vjp((jnp.ones(()), jnp.zeros(())))[0]
    lt = torch.from_numpy(logits).requires_grad_()
    loss_t, acc_t = tl.softmax_cross_entropy(
        lt, torch.from_numpy(labels),
        mask=None if m is None else torch.from_numpy(m), z_loss=z_loss)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) < TOL
    assert float(acc_t) == pytest.approx(float(acc_j), abs=1e-7)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(dlog_j),
                               atol=TOL)
    loss_only, none = tl.softmax_cross_entropy(
        lt.detach(), torch.from_numpy(labels), compute_accuracy=False)
    assert none is None and float(loss_only) > 0
