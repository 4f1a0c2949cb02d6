"""The port's Llama train path (``dcos_commons_tpu_torch/models/llama.py``
``forward``/``loss_fn`` and ``models/train.py``) against the JAX reference
on ``LlamaConfig.tiny`` with tokens [2, 128] (127 positions after the
next-token shift, a ragged length). Weights cross through
``params_from_jax``; the optimizer state through ``opt_state_from_jax``.

The port forces ``attn_impl="flash"`` (the flash-attention autograd
Function, which runs its plain versions on CPU tensors, with head_dim 8
zero-padded to 64 as on the card); JAX runs dense, since its flash
kernel cannot lower on the CPU.

Tolerances (fp32): logits and loss within 1e-5 relative, gradients
within 2e-5 of each leaf's largest magnitude (four layers of fp32
products summed in another order). Optimizer steps: moments within
1e-5; params within 5e-2 of the learning rate (1e-3 here) per leaf:
Adam divides each gradient by its own running magnitude, so an element
whose gradient is near ``eps`` turns a last-bit difference of the
gradient into a visible share of its update. bf16: the moments stay
bf16, and agree with JAX within bf16 rounding (relative norm 3e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import train as jt
from dcos_commons_tpu.ops import rotary as jrot
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import train as tt
from dcos_commons_tpu_torch.models.bridge import (opt_state_from_jax,
                                                  params_from_jax)
from dcos_commons_tpu_torch.ops import rotary as trot
from dcos_commons_tpu_torch.ops.attention import gqa_attention

CPU = torch.device("cpu")
OPT = dict(lr=1e-3, warmup=2, decay_steps=20)
GRAD_TOL = 2e-5
MOMENT_TOL = 1e-5
PARAM_TOL = 5e-2 * OPT["lr"]


def _cfgs(dtype="fp32", **kw):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jl.LlamaConfig.tiny(attn_impl="dense", dtype=jdt, **kw),
            tl.LlamaConfig.tiny(attn_impl="flash", dtype=tdt, **kw))


def _tokens(batch=2, seq=128, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, seq)).astype(np.int32)


def _params(jcfg, seed=0):
    jp = jl.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _tree_close(got, want, tol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        a, b = _np(g[name]), _np(w[name])
        err = float(np.abs(a - b).max()) if a.size else 0.0
        assert err <= tol * max(1.0, float(np.abs(b).max())), (name, err)


def test_train_config_fields_match_the_reference():
    for preset in ("llama3_8b", "llama_400m", "tiny"):
        j = getattr(jl.LlamaConfig, preset)()
        t = getattr(tl.LlamaConfig, preset)()
        for f in ("attn_impl", "remat", "remat_policy", "fused_ce",
                  "fused_ce_block"):
            assert getattr(t, f) == getattr(j, f), (preset, f)


@pytest.mark.parametrize("offset", [0, 5, 100])
def test_apply_rope_matches_jax(offset):
    """Full-sequence rope; offset 100 overruns the 128-row table and
    clamps the window's start as ``lax.dynamic_slice`` does."""
    x = np.random.default_rng(1).standard_normal((2, 40, 4, 16)).astype(
        np.float32)
    table_j = jrot.rope_frequencies(16, 128, 10000.0)
    table_t = trot.rope_frequencies(16, 128, 10000.0, device="cpu")
    want = jrot.apply_rope(jnp.asarray(x), table_j, offset)
    got = trot.apply_rope(torch.from_numpy(x), table_t, offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError):
        trot.apply_rope(torch.zeros((1, 129, 1, 16)), table_t)


def test_forward_logits_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens()
    with jax.default_matmul_precision("highest"):
        want = jl.forward(jcfg, jp, jnp.asarray(toks))
        hidden_j = jl.forward(jcfg, jp, jnp.asarray(toks), return_hidden=True)
    got = tl.forward(tcfg, tp, torch.from_numpy(toks))
    hidden_t = tl.forward(tcfg, tp, torch.from_numpy(toks),
                          return_hidden=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hidden_t.numpy(), np.asarray(hidden_j),
                               rtol=1e-5, atol=1e-5)


def _jax_loss_grads(jcfg, jp, toks):
    with jax.default_matmul_precision("highest"):
        (loss, acc), grads = jax.value_and_grad(
            lambda p: jl.loss_fn(jcfg, p, jnp.asarray(toks)),
            has_aux=True)(jp)
    return float(loss), float(acc), jax.device_get(grads)


def _port_loss_grads(tcfg, tp, toks):
    leaves = tt._leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, acc = tl.loss_fn(tcfg, tp, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        return next(it)

    return float(loss.detach()), float(acc), rebuild(tp)


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_every_gradient_leaf_match_jax(fused):
    jcfg, tcfg = _cfgs(fused_ce=fused, fused_ce_block=48)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(seed=1)
    loss_j, acc_j, g_j = _jax_loss_grads(jcfg, jp, toks)
    loss_t, acc_t, g_t = _port_loss_grads(tcfg, tp, toks)
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert acc_t == pytest.approx(acc_j, abs=1e-7)
    _tree_close(g_t, g_j, GRAD_TOL)


def test_fused_and_unfused_port_losses_agree():
    _, tcfg = _cfgs()
    jp, tp = _params(_cfgs()[0], seed=2)
    toks = torch.from_numpy(_tokens(seed=2))
    a = tl.loss_fn(tcfg, tp, toks)
    b = tl.loss_fn(dataclasses.replace(tcfg, fused_ce=False), tp, toks)
    assert float(a[0]) == pytest.approx(float(b[0]), rel=1e-6)
    assert float(a[1]) == float(b[1])


def test_schedule_matches_optax():
    opt = tt.make_optimizer(lr=3e-4, warmup=10, decay_steps=1000)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 1000)
    for count in list(range(13)) + [500, 999, 1000, 1001, 5000]:
        # optax evaluates in fp32: near the end of the cosine, 1 + cos
        # keeps few significant bits there
        assert opt.schedule(count) == pytest.approx(
            float(sched(count)), rel=1e-6, abs=3e-4 * 1e-7), count
    assert opt.schedule(0) == 0.0


def _host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True),
                        jax.device_get(tree))


def _jax_run(jcfg, jp, toks, n, opt_kw=OPT, grad_accum=1, state=None):
    """n reference steps; per step (loss, params, mu, nu) on the host."""
    opt = jt.make_optimizer(**opt_kw)
    step = jt.make_train_step(lambda p, b: jl.loss_fn(jcfg, p, b), opt,
                              grad_accum=grad_accum)
    state = opt.init(jp) if state is None else state
    out = []
    with jax.default_matmul_precision("highest"):
        for _ in range(n):
            jp, state, res = step(jp, state, jnp.asarray(toks))
            adam = state[1][0]
            # copies: the next step donates (and on CPU overwrites) the
            # buffers a zero-copy host view would alias
            out.append((float(res["loss"]), _host(jp), _host(adam.mu),
                        _host(adam.nu)))
    return out, jp, state


def _port_run(tcfg, tp, toks, n, opt_kw=OPT, grad_accum=1, state=None):
    opt = tt.make_optimizer(**opt_kw)
    step = tt.make_train_step(lambda p, b: tl.loss_fn(tcfg, p, b), opt,
                              grad_accum=grad_accum)
    state = tt.init_opt_state(opt, tp) if state is None else state
    out = []
    for _ in range(n):
        tp, state, res = step(tp, state, torch.from_numpy(toks))
        assert state.count == state.sched_count
        # copies: the next step updates params and moments in place
        out.append((float(res["loss"]), _clone(tp), tt.OptState(
            state.count, _clone(state.mu), _clone(state.nu),
            state.sched_count)))
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.parametrize("n_steps", [3, 5])
def test_train_steps_match_jax(n_steps):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    toks = _tokens(seed=3)
    want, _, _ = _jax_run(jcfg, jp, toks, n_steps)
    opt = tt.make_optimizer(**OPT)
    step = tt.make_train_step(lambda p, b: tl.loss_fn(tcfg, p, b), opt)
    state = tt.init_opt_state(opt, tp)
    first = tp["layers"]["wq"].clone()
    for i in range(n_steps):
        tp2, state, res = step(tp, state, torch.from_numpy(toks))
        assert tp2 is tp                                  # in place
        loss_j, p_j, mu_j, nu_j = want[i]
        assert float(res["loss"]) == pytest.approx(loss_j, rel=1e-5), i
        assert state.count == i + 1
        _tree_close(tp, p_j, PARAM_TOL)
        _tree_close(state.mu, mu_j, MOMENT_TOL)
        _tree_close(state.nu, nu_j, MOMENT_TOL)
        if i == 0:          # the schedule's rate is 0 at step 0
            assert torch.equal(tp["layers"]["wq"], first)
    assert not torch.equal(tp["layers"]["wq"], first)
    assert want[-1][0] < want[0][0]


def test_grad_accum_2_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    toks = _tokens(batch=4, seed=4)
    want, _, _ = _jax_run(jcfg, jp, toks, 3, grad_accum=2)
    got = _port_run(tcfg, tp, toks, 3, grad_accum=2)
    for (loss_j, p_j, mu_j, nu_j), (loss_t, p_t, st) in zip(want, got):
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
    _tree_close(p_t, p_j, PARAM_TOL)
    _tree_close(st.mu, mu_j, MOMENT_TOL)
    _tree_close(st.nu, nu_j, MOMENT_TOL)
    with pytest.raises(ValueError):
        tt.make_train_step(lambda p, b: None, tt.make_optimizer(**OPT),
                           grad_accum=3)(tp, st, torch.from_numpy(toks))


def test_remat_matches_no_remat():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, seed=5)
    toks = _tokens(seed=5)
    loss_a, _, g_a = _port_loss_grads(tcfg, tp, toks)
    loss_b, _, g_b = _port_loss_grads(
        dataclasses.replace(tcfg, remat=True), tp, toks)
    assert loss_a == loss_b
    _tree_close(g_b, g_a, 1e-6)


def test_bf16_moments_stay_bf16_and_track_jax():
    jcfg, tcfg = _cfgs("bf16")
    jp, tp = _params(jcfg, seed=6)
    toks = _tokens(seed=6)
    want, _, _ = _jax_run(jcfg, jp, toks, 3)
    got = _port_run(tcfg, tp, toks, 3)
    st = got[-1][2]
    assert st.mu["layers"]["wq"].dtype == torch.bfloat16
    assert st.nu["embed"].dtype == torch.bfloat16
    assert tp["lm_head"].dtype == torch.bfloat16
    loss_j, p_j, mu_j, nu_j = want[-1]
    assert got[-1][0] == pytest.approx(loss_j, rel=2e-2)
    for got_tree, want_tree in ((st.mu, mu_j), (st.nu, nu_j), (tp, p_j)):
        g, w = _flat(got_tree), _flat(want_tree)
        for name in w:
            a, b = _np(g[name]), _np(w[name])
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel < 3e-2, (name, rel)


def test_resume_from_jax_optimizer_state():
    """Both frameworks continue from one mid-schedule state."""
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg, seed=7)
    toks = _tokens(seed=7)
    _, jp3, jstate3 = _jax_run(jcfg, jp, toks, 3)
    host_state = _host(jstate3)
    tp = params_from_jax(_host(jp3), device="cpu")
    st = opt_state_from_jax(host_state, device="cpu")
    assert (st.count, st.sched_count) == (3, 3)
    assert st.mu["layers"]["wq"].dtype == torch.float32
    want, _, _ = _jax_run(jcfg, jp3, toks, 2, state=jstate3)
    got = _port_run(tcfg, tp, toks, 2, state=st)
    for (loss_j, p_j, mu_j, nu_j), (loss_t, p_t, s_t) in zip(want, got):
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
        _tree_close(p_t, p_j, PARAM_TOL)
        _tree_close(s_t.mu, mu_j, MOMENT_TOL)
    assert got[-1][2].count == 5


def test_opt_state_from_jax_refuses_a_foreign_state():
    with pytest.raises(ValueError):
        opt_state_from_jax((optax.EmptyState(),), device="cpu")


def test_config_guards_name_their_roadmap_item():
    """Unknown attention raises; a remat policy raises naming its item;
    ring and ulysses without a mesh are dense attention, as the
    reference's ``_make_attn_fn``."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    toks = torch.from_numpy(_tokens(seq=9))
    dense = tl.forward(dataclasses.replace(tcfg, attn_impl="dense"), tp, toks)
    for impl in ("ring", "ulysses"):
        torch.testing.assert_close(tl.forward(dataclasses.replace(
            tcfg, attn_impl=impl), tp, toks), dense, rtol=0, atol=0)
    with pytest.raises(ValueError, match="attn_impl"):
        tl.forward(dataclasses.replace(tcfg, attn_impl="flashy"), tp, toks)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.forward(dataclasses.replace(
            tcfg, remat=True, remat_policy="dots_saveable"), tp, toks)
    # without remat the reference ignores the policy, and so does the port
    tl.forward(dataclasses.replace(tcfg, remat_policy="dots_saveable"), tp,
               toks)


def test_auto_runs_dense_on_cpu_and_flash_forces_the_wrapper(monkeypatch):
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    toks = torch.from_numpy(_tokens(seq=9))
    calls = []
    real = tl.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tl, "flash_attention", spy)
    tl.forward(dataclasses.replace(tcfg, attn_impl="auto"), tp, toks)
    assert calls == []
    tl.forward(tcfg, tp, toks)
    assert len(calls) == tcfg.n_layers


def test_training_refuses_quantized_params():
    jcfg, _ = _cfgs()
    host = jax.device_get(jl.quantize_params(
        jl.init_params(jcfg, jax.random.key(0))))
    tp = params_from_jax(host, device="cpu")
    with pytest.raises(TypeError):
        tt.init_opt_state(tt.make_optimizer(**OPT), tp)


# (impl, device type, head_dim, dtype, route): the route is decided from
# shapes and dtype alone, so a CUDA device's decision is tested on CPU
# tensors
ROUTES = [
    ("auto", "cuda", 8, torch.bfloat16, "flash"),     # padded to 64
    ("flash", "cuda", 8, torch.bfloat16, "flash"),    # llama-train --attn
    ("auto", "cuda", 128, torch.bfloat16, "flash"),   # the distill shape
    ("flash", "cuda", 64, torch.bfloat16, "flash"),
    ("auto", "cuda", 512, torch.bfloat16, "dense"),   # past the ref's gate
    ("flash", "cuda", 512, torch.float32, "dense"),
    ("dense", "cuda", 128, torch.bfloat16, "dense"),
    ("auto", "cuda", 8, torch.float32, TypeError),    # bf16-only kernels
    ("flash", "cuda", 128, torch.float32, TypeError),
    ("auto", "cpu", 128, torch.bfloat16, "dense"),
    ("flash", "cpu", 8, torch.float32, "flash"),      # the plain version
]


@pytest.mark.parametrize("impl,device_type,d,dtype,want", ROUTES)
def test_attn_route_decides_from_shapes_and_dtype(impl, device_type, d, dtype,
                                             want):
    q = torch.zeros((2, 5, 8, d), dtype=dtype)
    k = torch.zeros((2, 5, 4, d), dtype=dtype)
    if want is TypeError:
        with pytest.raises(TypeError, match="bf16"):
            tl.attn_route(impl, device_type, q, k)
    else:
        assert tl.attn_route(impl, device_type, q, k) == want


@pytest.mark.parametrize("d", [8, 64, 96, 200])
def test_padded_flash_matches_dense(d):
    """The kernels' route at a head_dim below their widths: q/k/v
    zero-padded to 64/128/256 with the true width's softmax scale give
    the dense attention and its gradients (fp32, plain versions, within
    1e-5)."""
    rng = np.random.default_rng(d)
    qkv = [torch.from_numpy(rng.standard_normal(
        (2, 24, h, d)).astype(np.float32)) for h in (8, 4, 4)]
    res = []
    for fn in (tl._padded_flash,
               lambda q, k, v: gqa_attention(q, k, v, causal=True)):
        leaves = [t.clone().requires_grad_() for t in qkv]
        o = fn(*leaves)
        (o * torch.linspace(-1, 1, d)).sum().backward()
        res.append([o.detach()] + [t.grad for t in leaves])
    assert res[0][0].shape == (2, 24, 8, d)
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
