"""MoE serving in the port (``PagedServer(moe=...)``, ``llama.
init_moe_params`` / ``make_moe_ffn`` / ``generate_stepwise_moe``) against
the JAX package on the same weights (``params_from_jax`` of the JAX
``init_moe_params`` tree).

In fp32 on the tiny 2-layer model, token for token: the port's dropless
engine, drained flat and with ``decode_window=4``, equals JAX
``generate_stepwise_moe`` and the JAX ``PagedServer(moe=...)`` (the
request set of ``tests/test_serving_paged.py::TestServingArithmetic``);
a capacity-bounded engine (factor 1.0, where masked slots and padded
chunk rows compete for capacity) and an ``expert_choice`` engine equal
the JAX engine. Plus the router/``moe`` refusals, ``draft_moe_engine``,
``page_stats()["moe"]``, the compile-cache key and the bridge carrying an
MoE tree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu.parallel import moe as jmoe
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.speculative import DraftIncompatible
from dcos_commons_tpu_torch.parallel import aot
from dcos_commons_tpu_torch.parallel import moe as tmoe

E = 4
ENGINE = dict(slots=2, page_size=16, prefill_chunk=8)
_MODELS = {}


def _model(dtype="fp32"):
    """(JAX cfg, port cfg, JAX params, port params): the tiny 2-layer
    engine model with a 4-expert bank, weights from ``key(0)``."""
    if dtype not in _MODELS:
        jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        jcfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                                   dtype=jdt)
        tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dtype=tdt)
        jp = jl.init_moe_params(jcfg, E, jax.random.key(0))
        _MODELS[dtype] = (jcfg, tcfg, jp,
                          params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[dtype]


def _moe(routing="top2", factor=None):
    """(JAX config, port config): dropless unless ``factor`` is given."""
    kw = dict(routing=routing, capacity_factor=factor or 2.0)
    j, t = jmoe.MoEConfig(E, **kw), tmoe.MoEConfig(E, **kw)
    return (j, t) if factor else (jmoe.dropless(j), tmoe.dropless(t))


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _reqs(seed, shape):
    return [{"prompt": _prompt(seed + i, n), "max_new": m, "request_id": i}
            for i, (n, m) in enumerate(shape)]


# the request set of the JAX package's MoE serving test
STEPWISE = [(8, 6), (5, 9), (17, 4)]
# more streams than slots, prompts over several chunks, one past a page
BOUNDED = [(8, 6), (5, 9), (17, 4), (3, 7), (20, 5)]


def _engines(reqs, moe, window):
    """Drain ``reqs`` through the JAX and the port engine; returns (JAX
    streams, port streams, port engine)."""
    jcfg, tcfg, jp, tp = _model()
    jm, tm = moe
    want = js.PagedServer(jcfg, jp, moe=jm, **ENGINE).drain(
        [dict(r) for r in reqs], decode_window=window)
    srv = ts.PagedServer(tcfg, tp, moe=tm, device="cpu", **ENGINE)
    got = srv.drain([dict(r) for r in reqs], decode_window=window)
    assert srv.ledger_violations() == []
    return want, got, srv


def test_generate_stepwise_moe_matches_jax():
    jcfg, tcfg, jp, tp = _model()
    jm, tm = _moe()
    for r in _reqs(150, STEPWISE):
        want = jl.generate_stepwise_moe(
            jcfg, jp, jnp.asarray([r["prompt"]], jnp.int32), r["max_new"],
            jm)
        got = tl.generate_stepwise_moe(
            tcfg, tp, torch.tensor([r["prompt"]], dtype=torch.int32),
            r["max_new"], tm)
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("window", [1, 4])
def test_dropless_engine_matches_jax_stepwise_and_engine(window):
    """The port's dropless engine equals JAX ``generate_stepwise_moe``
    (routing is grouping-free under dropless) and the JAX engine."""
    jcfg, _, jp, _ = _model()
    moe = _moe()
    reqs = _reqs(150, STEPWISE)
    stepwise = {r["request_id"]: [int(t) for t in jl.generate_stepwise_moe(
        jcfg, jp, jnp.asarray([r["prompt"]], jnp.int32), r["max_new"],
        moe[0])[0]] for r in reqs}
    want, got, srv = _engines(reqs, moe, window)
    assert got == stepwise
    assert got == want
    assert srv.page_stats()["moe"] == {"experts": E,
                                       "capacity_factor": float(E),
                                       "routing": "top2"}


@pytest.mark.parametrize("window", [1, 4])
def test_capacity_bounded_engine_matches_jax_engine(window):
    """Factor 1.0: capacity binds, so every routed row counts (the masked
    slots' stale tokens in a decode step, the padded tail of a prefill
    chunk); the port routes the same rows in the same order with the same
    contents as the JAX engine. The streams differ from dropless ones,
    so the drops are real."""
    reqs = _reqs(170, BOUNDED)
    want, got, _ = _engines(reqs, _moe(factor=1.0), window)
    assert got == want
    dropless, _, _ = _engines(reqs, _moe(), window)
    assert got != dropless


@pytest.mark.parametrize("factor", [None, 1.0])
def test_expert_choice_engine_matches_jax_engine(factor):
    """Expert choice ranks each token against its group (equal rows of
    masked slots break to the lower index, as ``lax.top_k``)."""
    want, got, srv = _engines(_reqs(190, BOUNDED),
                              _moe("expert_choice", factor), 4)
    assert got == want
    assert srv.page_stats()["moe"]["routing"] == "expert_choice"


def test_moe_requires_router_params_and_vice_versa():
    _, tcfg, _, tp = _model()
    dense = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match="router"):
        ts.PagedServer(tcfg, dense, moe=_moe()[1], device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="moe"):
        ts.PagedServer(tcfg, tp, device="cpu", **ENGINE)


def test_moe_engine_refuses_a_draft():
    _, tcfg, _, tp = _model()
    srv = ts.PagedServer(tcfg, tp, moe=_moe()[1], device="cpu", **ENGINE)
    dcfg = tl.LlamaConfig.tiny(n_layers=1, max_seq=64, dtype=torch.float32)
    dparams = tl.init_params(dcfg, torch.Generator().manual_seed(1),
                             device="cpu")
    with pytest.raises(DraftIncompatible) as ei:
        srv.arm_draft(dcfg, dparams, k=4)
    assert ei.value.code == "draft_moe_engine"
    assert srv.page_stats()["spec"]["armed"] is False


def test_page_stats_moe_matches_jax_and_dense_has_none():
    jcfg, tcfg, jp, tp = _model()
    jm, tm = _moe("expert_choice", 1.5)
    want = js.PagedServer(jcfg, jp, moe=jm, **ENGINE).page_stats()["moe"]
    got = ts.PagedServer(tcfg, tp, moe=tm, device="cpu",
                         **ENGINE).page_stats()["moe"]
    assert got == want == {"experts": E, "capacity_factor": 1.5,
                           "routing": "expert_choice"}
    dense = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert ts.PagedServer(tcfg, dense, device="cpu",
                          **ENGINE).page_stats()["moe"] is None


def test_routing_is_part_of_the_engine_key():
    """Engines that route differently never share a namespace; engines of
    one MoE config do."""
    _, tcfg, _, tp = _model()
    cache = aot.CompileCache()
    for moe in (_moe()[1], _moe()[1], _moe(factor=1.0)[1],
                _moe("expert_choice")[1]):
        ts.PagedServer(tcfg, tp, moe=moe, compile_cache=cache,
                       device="cpu", **ENGINE)
    assert (cache.hits, cache.misses) == (1, 3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_params_from_jax_carries_an_moe_tree_bit_for_bit(dtype):
    """The fp32 router and the banks in the model dtype arrive with the
    JAX tree's keys, shapes, dtypes and bits; no dense FFN key."""
    _, _, jp, tp = _model(dtype)
    host = jax.device_get(jp)
    assert sorted(tp["layers"]) == sorted(host["layers"]) == [
        "attn_norm", "ffn_norm", "router", "w_in", "w_out", "wk", "wo",
        "wq", "wv"]
    assert tp["layers"]["router"].dtype == torch.float32
    want_dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    for name in ("w_in", "w_out", "wq"):
        assert tp["layers"][name].dtype == want_dt
    for name, leaf in host["layers"].items():
        t = tp["layers"][name]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), a), name


def test_init_moe_params_has_the_reference_tree_and_scales():
    """The port's own init: the JAX tree's keys, shapes and dtypes, no
    dense FFN, and each bank's spread at the reference's scale."""
    jcfg, tcfg, jp, _ = _model()
    tcfg8 = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dim=128, ffn_dim=512)
    got = tl.init_moe_params(tcfg8, 8, torch.Generator().manual_seed(0),
                             device="cpu")
    want = jax.eval_shape(lambda: jl.init_moe_params(
        jl.LlamaConfig.tiny(n_layers=2, max_seq=64, dim=128, ffn_dim=512),
        8, jax.random.key(0)))
    for group in ("layers",):
        for name, spec in want[group].items():
            t = got[group][name]
            assert tuple(t.shape) == spec.shape, name
            assert str(t.dtype).split(".")[-1] == spec.dtype.name, name
    d, f, L = 128, 512, 2
    lay = got["layers"]
    for name, scale in (("router", d ** -0.5), ("w_in", d ** -0.5),
                        ("w_out", f ** -0.5 / (2 * L) ** 0.5)):
        std = float(lay[name].float().std())
        assert abs(std / scale - 1) < 0.05, (name, std, scale)
    # one slab at a time: no two expert slabs drew the same numbers
    assert not torch.equal(lay["w_in"][0, 0], lay["w_in"][0, 1])
    again = tl.init_moe_params(tcfg8, 8, torch.Generator().manual_seed(0),
                               device="cpu")
    assert all(torch.equal(lay[k], again["layers"][k]) for k in lay)


def test_make_moe_ffn_refuses_a_mesh():
    """A tp mesh (MoE under tp is item 7b) and an ep axis that does not
    divide the experts; an ep mesh is served (``tests/
    test_torch_worker_ep_pp.py``)."""
    _, tcfg, _, _ = _model()

    class _Mesh:
        def __init__(self, **axes):
            self.shape = {"dp": 1, "pp": 1, "sp": 1, "tp": 1, "ep": 1,
                          **axes}

    with pytest.raises(NotImplementedError, match="item 7b"):
        tl.make_moe_ffn(tcfg, _moe()[1], mesh=_Mesh(tp=2))
    with pytest.raises(ValueError, match="ep=3"):
        tl.make_moe_ffn(tcfg, _moe()[1], mesh=_Mesh(ep=3))
