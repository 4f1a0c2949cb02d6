"""The port's MoE routing (``dcos_commons_tpu_torch/parallel/moe.py``)
against ``dcos_commons_tpu/parallel/moe.py`` on the same inputs, made
from a seed with numpy: ``top2_dispatch`` and ``expert_choice_dispatch``
(planted ties included), ``aux_load_balance_loss``, ``capacity`` /
``dropless`` and ``moe_apply_local`` (fp32 and bf16, dropless and
capacity-bounded with drops under a skewed router), plus the dropless
grouping independence the serving parity rests on.

Tolerances: the dispatch tensors and the auxiliary loss within 1e-6
absolute (they are elementwise in both, so in practice exact);
``moe_apply_local`` in fp32 within 1e-6 of max |out| (the expert
products' fp32 sums in another order); in bf16 within 2e-2 of max |out|
(the expert products' bf16 roundings in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.parallel import moe as jmoe
from dcos_commons_tpu_torch.parallel import moe as tmoe

DISPATCH_ATOL = 1e-6
APPLY_FP32_RTOL = 1e-6
APPLY_BF16_RTOL = 2e-2


def _gates(seed, g, e, skew=0.0):
    """Softmax router probabilities [G, E] fp32; ``skew`` adds to expert
    0's logit (a popular expert that overflows its capacity)."""
    logits = np.random.default_rng(seed).standard_normal((g, e)).astype(
        np.float32)
    logits[:, 0] += skew
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def _both(fn_name, gates, cap):
    jc, jd = getattr(jmoe, fn_name)(jnp.asarray(gates), cap)
    tc, td = getattr(tmoe, fn_name)(torch.from_numpy(gates), cap)
    return (np.asarray(jc), np.asarray(jd)), (tc.numpy(), td.numpy())


DISPATCH_CASES = [
    # (G, E, capacity factor or None for dropless, skew)
    (16, 4, 2.0, 0.0), (16, 4, 1.0, 0.0), (33, 8, 1.25, 0.0),
    (8, 4, None, 0.0), (24, 4, 1.0, 3.0), (5, 8, 1.0, 0.0),
]


@pytest.mark.parametrize("g,e,factor,skew", DISPATCH_CASES)
def test_top2_dispatch_matches_jax(g, e, factor, skew):
    cfg = jmoe.MoEConfig(e, capacity_factor=factor or float(e))
    cap = cfg.capacity(g)
    gates = _gates(g * 7 + e, g, e, skew)
    (jc, jd), (tc, td) = _both("top2_dispatch", gates, cap)
    assert tc.shape == jc.shape == (g, e, cap)
    assert np.array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=DISPATCH_ATOL)
    if skew:
        # the popular expert overflows: some assignments are dropped
        assert jd.sum() < 2 * g


def test_top2_dispatch_breaks_ties_to_the_lower_expert():
    """Planted ties: uniform rows and rows whose top two (or second and
    third) gates are equal pick the lower expert first, as jnp.argmax."""
    gates = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1],
                      [0.5, 0.2, 0.2, 0.1],
                      [0.1, 0.2, 0.3, 0.4]] * 2, np.float32)
    (jc, jd), (tc, td) = _both("top2_dispatch", gates, 3)
    assert np.array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=DISPATCH_ATOL)
    # row 0 goes to experts 0 and 1, row 1 to 1 and 2
    assert td[0].any(-1).tolist() == [True, True, False, False]
    assert td[1].any(-1).tolist() == [False, True, True, False]


@pytest.mark.parametrize("g,e,factor,skew", DISPATCH_CASES)
def test_expert_choice_dispatch_matches_jax(g, e, factor, skew):
    cfg = jmoe.MoEConfig(e, capacity_factor=factor or float(e),
                         routing="expert_choice")
    gates = _gates(g * 11 + e, g, e, skew)
    (jc, jd), (tc, td) = _both("expert_choice_dispatch", gates,
                               cfg.capacity(g))
    assert tc.shape == jc.shape
    assert np.array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=DISPATCH_ATOL)


@pytest.mark.parametrize("cap", [2, 5, 12])
def test_expert_choice_ties_take_the_lower_token(cap):
    """Identical rows (an engine's masked slots) and equal gates within a
    column: each expert's buffer lists equal tokens lowest index first,
    as lax.top_k does."""
    base = _gates(3, 4, 4)
    gates = np.concatenate([base[:1]] * 5 + [base, base[:2]] * 2, 0)
    gates[7, 2] = gates[9, 2] = gates[0, 2]
    (jc, jd), (tc, td) = _both("expert_choice_dispatch", gates, cap)
    assert np.array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=DISPATCH_ATOL)


@pytest.mark.parametrize("g,e,skew", [(16, 4, 0.0), (40, 8, 2.0)])
def test_aux_load_balance_loss_matches_jax(g, e, skew):
    gates = _gates(g + e, g, e, skew)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(gates)))
    got = float(tmoe.aux_load_balance_loss(torch.from_numpy(gates)))
    assert abs(got - want) <= DISPATCH_ATOL


def test_capacity_and_dropless_match_jax():
    for e in (1, 2, 4, 8):
        for factor in (0.5, 1.0, 1.25, 2.0, 3.3):
            for n in (1, 3, 8, 64, 1000):
                j = jmoe.MoEConfig(e, capacity_factor=factor)
                t = tmoe.MoEConfig(e, capacity_factor=factor)
                assert t.capacity(n) == j.capacity(n), (e, factor, n)
        jd = jmoe.dropless(jmoe.MoEConfig(e, routing="expert_choice"))
        td = tmoe.dropless(tmoe.MoEConfig(e, routing="expert_choice"))
        assert (td.num_experts, td.capacity_factor, td.routing) == (
            jd.num_experts, jd.capacity_factor, jd.routing)
        assert all(td.capacity(n) == n for n in (1, 7, 64))


def _weights(seed, g, d, e, f, skew=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    router[:, 0] += skew * x.mean(0) / (np.linalg.norm(x.mean(0)) ** 2)
    w_in = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    return x, router, w_in, w_out


def _apply_both(arrays, cfg_kw, dropless, dtype):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, router, w_in, w_out = arrays
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    if dropless:
        jcfg, tcfg = jmoe.dropless(jcfg), tmoe.dropless(tcfg)
    jout, jaux = jmoe.moe_apply_local(
        jnp.asarray(x, jdt), jnp.asarray(router), jnp.asarray(w_in, jdt),
        jnp.asarray(w_out, jdt), jcfg)
    tout, taux = tmoe.moe_apply_local(
        torch.from_numpy(x).to(tdt), torch.from_numpy(router),
        torch.from_numpy(w_in).to(tdt), torch.from_numpy(w_out).to(tdt),
        tcfg)
    return (np.asarray(jout.astype(jnp.float32)), float(jaux),
            tout.float().numpy(), float(taux))


APPLY_CASES = [
    # (G, E, routing, capacity factor or None for dropless, skew)
    (16, 4, "top2", None, 0.0), (16, 4, "top2", 1.0, 0.0),
    (32, 4, "top2", 1.0, 4.0), (12, 8, "expert_choice", None, 0.0),
    (20, 4, "expert_choice", 1.0, 0.0), (7, 2, "top2", 2.0, 0.0),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("g,e,routing,factor,skew", APPLY_CASES)
def test_moe_apply_local_matches_jax(g, e, routing, factor, skew, dtype):
    arrays = _weights(g * 13 + e, g, 64, e, 128, skew)
    kw = dict(num_experts=e, routing=routing,
              capacity_factor=factor or 2.0)
    jout, jaux, tout, taux = _apply_both(arrays, kw, not factor, dtype)
    rtol = APPLY_FP32_RTOL if dtype == "fp32" else APPLY_BF16_RTOL
    scale = float(np.abs(jout).max())
    assert np.abs(tout - jout).max() <= rtol * scale + 1e-30
    assert abs(taux - jaux) <= (DISPATCH_ATOL if dtype == "fp32" else 1e-2)
    if routing == "expert_choice":
        assert taux == 0.0
    if skew:
        # the skewed router drops tokens: their rows pass through as zeros
        dropped = np.all(jout == 0, axis=-1)
        assert dropped.any() and np.array_equal(
            np.all(tout == 0, axis=-1), dropped)


def test_moe_apply_local_refuses_an_unknown_routing():
    x, router, w_in, w_out = (torch.from_numpy(a) for a in
                              _weights(0, 4, 8, 2, 16))
    with pytest.raises(ValueError, match="routing"):
        tmoe.moe_apply_local(x, router, w_in, w_out,
                             tmoe.MoEConfig(2, routing="hash"))


@pytest.mark.parametrize("routing", ["top2", "expert_choice"])
def test_dropless_output_of_a_token_is_independent_of_its_group(routing):
    """Under dropless capacity one token's output is the same alone and in
    any group it is dispatched with (within 1e-6 of max |out|: only the
    products' row count changes)."""
    x, router, w_in, w_out = (torch.from_numpy(a) for a in
                              _weights(5, 24, 64, 4, 128))
    cfg = tmoe.dropless(tmoe.MoEConfig(4, routing=routing))
    if routing == "expert_choice":
        # expert choice ranks a token against its group: dropless takes
        # every token into every expert, so each output is the full mix
        assert cfg.capacity(24) == 24
    full, _ = tmoe.moe_apply_local(x, router, w_in, w_out, cfg)
    scale = float(full.abs().max())
    for idx in ([3], [0, 5, 9], [23, 1], list(range(12, 24))):
        part, _ = tmoe.moe_apply_local(x[idx], router, w_in, w_out, cfg)
        assert float((part - full[idx]).abs().max()) <= (
            APPLY_FP32_RTOL * scale)
    # a capacity-bounded config is not: the last token of a crowded group
    # can be dropped that alone would not be
    bound = tmoe.MoEConfig(4, capacity_factor=0.5)
    crowded, _ = tmoe.moe_apply_local(x, router, w_in, w_out, bound)
    alone = torch.cat([tmoe.moe_apply_local(x[i:i + 1], router, w_in, w_out,
                                            bound)[0] for i in range(24)])
    assert not torch.allclose(crowded, alone)
