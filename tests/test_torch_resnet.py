"""The port's ResNet (``dcos_commons_tpu_torch/models/resnet.py``) and its
batch-norm train step (``models/train.py`` ``has_aux_state``) against the
JAX reference on the CPU, on the same trees (drawn with numpy from a
seed in the reference's shapes and scales) carried over with
``models.bridge.resnet_from_jax``.

Cases: depth 18 at width 8 (basic blocks) and depth 50 at width 4
(bottleneck blocks with ``proj``), at an even size (asymmetric SAME
pads: the 7x7/s2 stem pads (2, 3), the pool and the strided 3x3s (0, 1))
and an odd one (33x33, other pads). The JAX side runs under one
``jax.jit`` per case.

Batch norm over few values is ill-conditioned by the reference's own
formula (``E[x^2] - E[x]^2`` in fp32): at 32x32 and batch 2 the last
stage is 1x1 and its batch norm sees 2 values a channel, and the fp32
gradients of both implementations sit 1-40 % away from an fp64
evaluation of the same functions (measured). So the depth-18 32x32 case
takes batch 4 and the depth-50 cases 33x33 and 40x40. Even there the
16 bottleneck blocks at width 4 amplify fp32 rounding through the batch
statistics: the two train-mode gradients differ by up to 0.16 of the
largest one (both as far from fp64). Without batch statistics the same
stack is well conditioned: eval-mode gradients agree within 1.2e-6.

Tolerances (fp32; measured in brackets):
- depth 18: logits within 1e-4 of the largest, loss, state [<= 1e-5];
  every train-mode gradient within 5e-4 of the tree's largest gradient
  [3.5e-5] (batch norm cancels most of the gradient of a scale or bias
  that feeds another batch norm, so a per-leaf relative measure would
  read rounding noise as error);
- depth 50: logits, loss and state within 2e-3 [3.4e-4]; the train-mode
  gradient's direction: cosine >= 0.95 [0.985];
- both: eval mode within the forward tolerance, and every eval-mode
  gradient within 1e-5 of the tree's largest [1.2e-6];
- bf16 (depth 18): logits within ``BF16_LOGIT_TOL`` of the largest
  logit [0.034]: each conv and elementwise result rounds to bf16 in
  both, in orders that differ; at both depths the port's bf16 logits
  no farther from JAX's fp32 ones than twice JAX's own bf16 distance
  [0.015 against 0.033 at depth 18, 0.26 against 0.28 at depth 50].
The space-to-depth stem is exact: integer-valued inputs and weights make
every sum exact in fp32, so the folded and the plain stem agree bit for
bit, with each other and with JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import resnet as jr
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops import softmax_cross_entropy as jsoftmax_cross_entropy
from dcos_commons_tpu_torch.models import resnet as tr
from dcos_commons_tpu_torch.models import train as tt
from dcos_commons_tpu_torch.models.bridge import resnet_from_jax
from dcos_commons_tpu_torch.ops.losses import softmax_cross_entropy

# (id, depth, width, size, batch, forward tolerance, train-mode gradient
# tolerance: None holds the whole gradient's direction to GRAD_COSINE)
CASES = [("r18_even", 18, 8, 32, 4, 1e-4, 5e-4),
         ("r18_odd", 18, 8, 33, 2, 1e-4, 5e-4),
         ("r50_odd", 50, 4, 33, 2, 2e-3, None),
         ("r50_even", 50, 4, 40, 2, 2e-3, None)]
GRAD_COSINE = 0.95
EVAL_GRAD_TOL = 1e-5
N_CLASSES = 10
LOGIT_RTOL = 1e-4
STATE_TOL = 1e-4
BF16_LOGIT_TOL = 0.1
BF16_VS_FP32_RATIO = 2.0
OPT = dict(lr=1e-3, warmup=2, decay_steps=20)
PARAM_TOL = 5e-2 * OPT["lr"]
MOMENT_TOL = 1e-5


def _cfgs(depth, width, dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jr.ResNetConfig(depth=depth, n_classes=N_CLASSES, width=width,
                            dtype=jdt, **kw),
            tr.ResNetConfig(depth=depth, n_classes=N_CLASSES, width=width,
                            dtype=tdt, **kw))


@functools.lru_cache(maxsize=None)
def _init(depth, width):
    """fp32 ``(params, state)`` of the reference's tree drawn with numpy
    from a seed, scaled as ``init_params`` scales (He for the convs,
    ``cin ** -0.5`` for the head; batch norm at scale 1, bias 0, running
    mean 0, variance 1). An eager JAX init compiles each draw's shape
    anew, about 10 s a depth."""
    jcfg, _ = _cfgs(depth, width)
    shapes = jax.eval_shape(lambda: jr.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(depth)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim == 4 or name.endswith("['w']"):
            fan_in = int(np.prod(a.shape[:-1]))
            scale = (2.0 / fan_in if a.ndim == 4 else 1.0 / fan_in) ** 0.5
            return (rng.standard_normal(a.shape) * scale).astype(np.float32)
        fill = 1.0 if name.endswith(("['scale']", "['var']")) else 0.0
        return np.full(a.shape, fill, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _trees(jcfg):
    """``((params, state) as JAX arrays, the same carried into the
    port)`` in ``jcfg``'s dtypes: a bf16 init is the fp32 one's weights
    cast, as ``init_params`` casts its fp32 draws."""
    shapes = jax.eval_shape(lambda: jr.init_params(jcfg, jax.random.key(0)))
    hp, hs = jax.tree.map(lambda a, want: np.asarray(a).astype(want.dtype),
                          _init(jcfg.depth, jcfg.width), shapes)
    return ((jax.tree.map(jnp.asarray, hp), jax.tree.map(jnp.asarray, hs)),
            resnet_from_jax(hp, hs, device="cpu"))


def _batch(size, batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, size, size, 3)).astype(np.float32),
            rng.integers(0, N_CLASSES, (batch,)).astype(np.int32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _leaf_close(got, want, tol):
    """Each leaf's largest error within ``tol`` of its largest value."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        a, b = _np(g[name]), _np(w[name])
        err = float(np.abs(a - b).max())
        assert err <= tol * max(1.0, float(np.abs(b).max())), (name, err)


def _jax_loss_grads(jcfg, jp, js, x, y):
    """The train pass (loss, accuracy, new state, gradients, logits), the
    eval-mode logits over the new state, and the eval-mode loss and its
    gradients over the given state, in one jit."""
    def eval_loss(p, s, xx, yy):
        return jsoftmax_cross_entropy(jr.forward(jcfg, p, s, xx,
                                                 train=False)[0], yy)[0]

    def run(p, s, xx, yy):
        (loss, (acc, state)), grads = jax.value_and_grad(
            lambda p_: jr.loss_fn(jcfg, p_, s, (xx, yy)), has_aux=True)(p)
        logits, _ = jr.forward(jcfg, p, s, xx)
        eval_logits, eval_state = jr.forward(jcfg, p, state, xx,
                                             train=False)
        return (loss, acc, state, grads, logits, eval_logits, eval_state,
                jax.grad(eval_loss)(p, s, xx, yy))

    with jax.default_matmul_precision("highest"):
        out = jax.jit(run)(jp, js, jnp.asarray(x), jnp.asarray(y))
    return jax.device_get(out)


def _port_grads(tp, loss_of):
    leaves = tt._leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        out = loss_of()
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return out, dict(zip(_flat(tp), grads))


def _port_loss_grads(tcfg, tp, ts, x, y):
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    (loss, (acc, state)), grads = _port_grads(
        tp, lambda: tr.loss_fn(tcfg, tp, ts, (xt, yt)))
    _, eval_grads = _port_grads(tp, lambda: softmax_cross_entropy(
        tr.forward(tcfg, tp, ts, xt, train=False)[0], yt)[0])
    with torch.no_grad():
        logits, _ = tr.forward(tcfg, tp, ts, xt)
        eval_logits, eval_state = tr.forward(tcfg, tp, state, xt,
                                             train=False)
    return (loss.detach(), acc, state, grads, logits, eval_logits,
            eval_state, eval_grads)


def _logits_close(got, want, tol=LOGIT_RTOL):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _grads_close(got, want, tol):
    """Each leaf's largest error within ``tol`` of the largest gradient of
    the whole tree."""
    want = _flat(want)
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, g in got.items():
        err = float(np.abs(_np(g) - want[name]).max())
        assert err <= tol * scale, (name, err, scale)


def _cosine(got, want) -> float:
    want = _flat(want)
    a = np.concatenate([want[k].ravel() for k in sorted(got)])
    b = np.concatenate([_np(got[k]).ravel() for k in sorted(got)])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("depth,width,size,batch,fwd_tol,grad_tol",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_loss_state_and_every_gradient_match_jax(depth, width, size, batch,
                                                 fwd_tol, grad_tol):
    """The train pass (logits, loss, accuracy, new state, every gradient),
    eval mode over the new state (the running statistics are used and
    the state comes back as the same tensors), and every gradient of the
    eval-mode loss."""
    jcfg, tcfg = _cfgs(depth, width)
    (jp, js), (tp, ts) = _trees(jcfg)
    x, y = _batch(size, batch)
    (loss_j, acc_j, st_j, g_j, logits_j, ev_j, ev_st_j,
     evg_j) = _jax_loss_grads(jcfg, jp, js, x, y)
    (loss_t, acc_t, st_t, g_t, logits_t, ev_t, ev_st_t,
     evg_t) = _port_loss_grads(tcfg, tp, ts, x, y)
    _logits_close(logits_t, logits_j, fwd_tol)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=fwd_tol)
    assert float(acc_t) == float(acc_j)
    _leaf_close(st_t, st_j, fwd_tol)
    if grad_tol is None:
        # the chaotic depth-50 stack: the direction of the whole gradient
        assert _cosine(g_t, g_j) >= GRAD_COSINE
    else:
        _grads_close(g_t, g_j, grad_tol)
    _logits_close(ev_t, ev_j, fwd_tol)
    for name, leaf in _flat(ev_st_t).items():
        assert leaf is _flat(st_t)[name], name
    _leaf_close(ev_st_t, ev_st_j, fwd_tol)
    _grads_close(evg_t, evg_j, EVAL_GRAD_TOL)


@pytest.mark.parametrize("depth,width,tol", [(18, 8, BF16_LOGIT_TOL),
                                             (50, 4, None)])
def test_bf16_forward_tracks_jax(depth, width, tol):
    """Both bf16 forwards on the same bf16 tree, beside JAX's fp32 forward
    of that tree: the port's bf16 logits within ``tol`` of JAX's bf16
    ones, and no farther from the fp32 logits than
    ``BF16_VS_FP32_RATIO`` times JAX's own bf16 distance. The tiny-width
    depth-50 stack is chaotic in bf16 (JAX's bf16 logits sit 0.28 of the
    largest logit from its fp32 ones, measured), so there only the second
    check holds."""
    jcfg, tcfg = _cfgs(depth, width, "bf16")
    jcfg32, _ = _cfgs(depth, width)
    (jp, js), (tp, ts) = _trees(jcfg)
    x, _ = _batch(33, 2, seed=2)

    def run(p, s, xx):
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        return (jr.forward(jcfg, p, s, xx),
                jr.forward(jcfg32, p32, s, xx)[0])

    with jax.default_matmul_precision("highest"):
        (want, st_j), want32 = jax.device_get(
            jax.jit(run)(jp, js, jnp.asarray(x)))
    got, st_t = tr.forward(tcfg, tp, ts, torch.from_numpy(x))
    assert got.dtype == torch.float32
    got, scale = got.numpy(), float(np.abs(want32).max())
    if tol is not None:
        assert float(np.abs(got - want).max()) <= tol * scale
    ref_dist = float(np.abs(want - want32).max())
    assert float(np.abs(got - want32).max()) <= (
        BF16_VS_FP32_RATIO * ref_dist + 1e-2 * scale)
    # the statistics are fp32 of bf16 activations: within bf16 rounding
    if tol is not None:
        _leaf_close(st_t, st_j, 2e-2)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (33, 7, 2, (3, 3)),
    (17, 3, 2, (1, 1)), (9, 3, 2, (1, 1)), (2, 3, 2, (0, 1)),
    (1, 3, 2, (1, 1)), (5, 1, 1, (0, 0))])
def test_same_pads_are_xla_s(size, k, stride, pads):
    assert tr.same_pads(size, k, stride) == pads
    x = np.arange(size * size, dtype=np.float32).reshape(1, size, size, 1)
    w = np.ones((k, k, 1, 1), np.float32)
    want = jr._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = tr._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w), stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("size", [16, 33, 112])
def test_max_pool_pads_with_minus_inf_as_xla(size):
    x = -np.abs(np.random.default_rng(3).standard_normal(
        (2, size, size, 4))).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tr._max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_space_to_depth_stem_is_exact():
    """Integer-valued input and kernel: every sum is exact in fp32, so the
    folded stem, the plain stem and JAX's folded stem agree bit for bit;
    then the whole forward with ``stem_s2d`` within the fp32 tolerance."""
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (2, 32, 32, 3)).astype(np.float32)
    w = rng.integers(-2, 3, (7, 7, 3, 8)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    folded = tr._stem_s2d(xt, torch.from_numpy(w))
    plain = tr._conv(xt, torch.from_numpy(w), 2)
    want = np.asarray(jr._stem_s2d(jnp.asarray(x), jnp.asarray(w)))
    assert torch.equal(folded, plain)
    np.testing.assert_array_equal(folded.permute(0, 2, 3, 1).numpy(), want)
    jcfg, tcfg = _cfgs(18, 8, stem_s2d=True)
    (jp, js), (tp, ts) = _trees(jcfg)
    xb, _ = _batch(32, 4)
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda p, s, xx: jr.forward(jcfg, p, s, xx))(
            jp, js, jnp.asarray(xb))
    got, _ = tr.forward(tcfg, tp, ts, torch.from_numpy(xb))
    plain_cfg = dataclasses.replace(tcfg, stem_s2d=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_RTOL, atol=LOGIT_RTOL)
    np.testing.assert_allclose(
        got.numpy(), tr.forward(plain_cfg, tp, ts,
                                torch.from_numpy(xb))[0].numpy(),
        rtol=LOGIT_RTOL, atol=LOGIT_RTOL)


def test_config_and_init_match_the_reference():
    for depth in jr.BLOCKS:
        j, t = jr.ResNetConfig(depth=depth), tr.ResNetConfig(depth=depth)
        assert t.stage_blocks == j.stage_blocks
        assert t.bottleneck == j.bottleneck
        for f in ("n_classes", "width", "bn_momentum", "bn_eps",
                  "stem_s2d"):
            assert getattr(t, f) == getattr(j, f), (depth, f)
    assert tr.ResNetConfig().dtype == torch.bfloat16
    for depth, width in ((18, 8), (50, 4)):
        jcfg, tcfg = _cfgs(depth, width, "bf16")
        jp, js = jax.eval_shape(lambda: jr.init_params(jcfg,
                                                       jax.random.key(0)))
        tp, ts = tr.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
        for want, got in ((jp, tp), (js, ts)):
            want, got = _flat(want), _flat(got)
            assert sorted(want) == sorted(got)
            for k, leaf in want.items():
                assert tuple(got[k].shape) == leaf.shape, k
                assert str(got[k].dtype).split(".")[-1] == str(
                    leaf.dtype), k
        # He scaling: the stem's 147 fan-in
        assert float(tp["stem"]["conv"].float().std()) == pytest.approx(
            (2 / 147) ** 0.5, rel=0.1)


# ---------------------------------------------------------------------------
# the has_aux_state train step


def _jax_steps(jcfg, jp, js, x, y, n):
    opt = jt.make_optimizer(**OPT)
    step = jt.make_train_step(lambda p, b: jr.loss_fn(jcfg, p, b[0], b[1]),
                              opt, has_aux_state=True)
    state, out = opt.init(jp), []
    with jax.default_matmul_precision("highest"):
        for _ in range(n):
            jp, state, js, res = step(jp, state, (js, (jnp.asarray(x),
                                                       jnp.asarray(y))))
            adam = state[1][0]
            out.append(jax.device_get((float(res["loss"]), jp, adam.mu,
                                       adam.nu, js, int(adam.count))))
    return out


def test_three_aux_steps_match_jax():
    """Loss, parameters, both moments, the batch-norm state and the count
    after each of three steps. Adam divides each gradient by its own
    running magnitude, so an element whose first moment nearly cancels
    turns a last-bits difference of its gradient into a visible share of
    its step: at most 1 element in 10,000 may pass ``PARAM_TOL``, and none
    by more than the sum of the rates so far (the largest move Adam
    makes); measured, 1 of 177,362 by 7.7e-5."""
    jcfg, tcfg = _cfgs(18, 8)
    (jp, js), (tp, ts) = _trees(jcfg)
    x, y = _batch(33, 2, seed=5)
    want = _jax_steps(jcfg, jp, js, x, y, 3)
    opt = tt.make_optimizer(**OPT)
    step = tt.make_train_step(lambda p, b: tr.loss_fn(tcfg, p, b[0], b[1]),
                              opt, has_aux_state=True)
    state = tt.init_opt_state(opt, tp)
    rates = 0.0
    for i, (loss_j, p_j, mu_j, nu_j, st_j, count_j) in enumerate(want):
        rates += opt.schedule(i)
        tp, state, ts, out = step(tp, state, (ts, (torch.from_numpy(x),
                                                   torch.from_numpy(y))))
        assert float(out["loss"]) == pytest.approx(loss_j, rel=1e-5), i
        assert state.count == state.sched_count == count_j == i + 1
        assert all(not t.requires_grad for t in _flat(ts).values())
        _leaf_close(ts, st_j, STATE_TOL)
        _leaf_close(state.mu, mu_j, MOMENT_TOL)
        _leaf_close(state.nu, nu_j, MOMENT_TOL)
        over, total = 0, 0
        for name, want_p in _flat(p_j).items():
            err = np.abs(_np(_flat(tp)[name]) - want_p)
            over += int((err > PARAM_TOL).sum())
            total += err.size
            assert float(err.max()) <= rates * (1 + OPT["lr"]), (i, name)
        assert over <= total // 10_000, (i, over)


def test_weight_decay_reaches_every_leaf_as_optax():
    """optax's adamw decays every leaf (no mask), batch-norm scale and
    bias included: with zero gradients one update at a positive rate
    moves each scale from 1 by ``lr * wd`` as optax does."""
    jcfg, tcfg = _cfgs(18, 8)
    (jp, _), (tp, _) = _trees(jcfg)
    opt_kw = dict(lr=1e-2, warmup=1, decay_steps=10, weight_decay=0.1)
    jopt = jt.make_optimizer(**opt_kw)
    @jax.jit
    def second_update(p):
        zeros = jax.tree.map(jnp.zeros_like, p)
        _, state = jopt.update(zeros, jopt.init(p), p)   # count 0: rate 0
        upd, _ = jopt.update(zeros, state, p)
        return jax.tree.map(lambda a, u: a + u, p, upd)

    want = _flat(jax.device_get(second_update(jp)))
    opt = tt.make_optimizer(**opt_kw)
    state = tt.init_opt_state(opt, tp)
    for _ in range(2):
        tt.apply_updates(opt, tp, [torch.zeros_like(t)
                                   for t in tt._leaves(tp)], state)
    got = _flat(tp)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), w, rtol=1e-6, atol=1e-9)
    scale = _np(got["stem/bn/scale"])
    np.testing.assert_allclose(scale, 1 - 1e-2 * 0.1, rtol=1e-6)


def test_grad_accum_with_aux_state_is_refused_as_the_reference():
    with pytest.raises(NotImplementedError, match="has_aux_state"):
        jt.make_train_step(lambda p, b: None, jt.make_optimizer(),
                           has_aux_state=True, grad_accum=2)
    with pytest.raises(NotImplementedError, match="has_aux_state"):
        tt.make_train_step(lambda p, b: None, tt.make_optimizer(),
                           has_aux_state=True, grad_accum=2)
