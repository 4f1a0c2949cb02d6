"""Speculative decoding on the port's paged engine
(``dcos_commons_tpu_torch/models/serving.py:PagedServer.arm_draft``)
against the JAX engine armed with the same draft, on the request sets of
``tests/test_serving_spec.py``: in fp32 the port's spec streams equal the
JAX spec engine's and solo decode's token for token (self-draft with
every proposal accepted, a truncated draft, an int8-KV target, prefix
sharing with reset, a stream still prefilling while windows run, a window
that crosses ``max_seq``); the spec counters equal the reference's; the
guards, the sampled refusal and disarm leave a solo engine; the front
door carries the speculative gauges."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu_torch.metrics import MetricsRegistry
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.ingress import ServingFrontend
from dcos_commons_tpu_torch.models.speculative import DraftIncompatible
from dcos_commons_tpu_torch.ops.sampling import make_sampler

_MODELS = {}


def _model(kv_quant=False):
    """(JAX cfg, port cfg, JAX params, port params): the tiny 2-layer
    fp32 engine model of the JAX spec tests, weights from ``key(0)``."""
    if kv_quant not in _MODELS:
        jcfg = jl.LlamaConfig.tiny(n_layers=2, max_seq=64, attn_impl="dense",
                                   dtype=jnp.float32, kv_quant=kv_quant)
        tcfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64,
                                   dtype=torch.float32, kv_quant=kv_quant)
        jp = jl.init_params(jcfg, jax.random.key(0))
        _MODELS[kv_quant] = (jcfg, tcfg, jp,
                             params_from_jax(jax.device_get(jp),
                                             device="cpu"))
    return _MODELS[kv_quant]


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _reqs(shapes, base=40):
    return [{"prompt": _prompt(base + i, n), "max_new": m, "request_id": i}
            for i, (n, m) in enumerate(shapes)]


def _drafts(jcfg, tcfg, jp, tp, layers):
    """The draft in both packages: the target itself (``layers`` None) or
    its first ``layers`` layers."""
    if layers is None:
        return (jcfg, jp), (tcfg, tp)
    jd = jl.truncate_layers(jcfg, jp, layers)
    return ((jd[0], jax.tree.map(jnp.array, jd[1])),
            tl.truncate_layers(tcfg, tp, layers))


def _both(reqs, layers=None, kv_quant=False, k=4, window=4, **kw):
    """Drain ``reqs`` through the JAX spec engine, the port's spec engine
    and the port's solo engine; returns (jax, port, solo, port engine,
    jax engine)."""
    jcfg, tcfg, jp, tp = _model(kv_quant)
    (jcd, jpd), (tcd, tpd) = _drafts(jcfg, tcfg, jp, tp, layers)
    kw = {"slots": 2, "page_size": 16, "prefill_chunk": 8, **kw}
    je = js.PagedServer(jcfg, jp, **kw)
    je.arm_draft(jcd, jpd, k=k)
    want = je.drain([dict(r) for r in reqs], decode_window=window)
    te = ts.PagedServer(tcfg, tp, device="cpu", **kw)
    te.arm_draft(tcd, tpd, k=k)
    got = te.drain([dict(r) for r in reqs], decode_window=window)
    solo = ts.PagedServer(tcfg, tp, device="cpu", **kw).drain(
        [dict(r) for r in reqs], decode_window=window)
    assert te.ledger_violations() == []
    return want, got, solo, te, je


def _spec_counts(engine):
    s = engine.page_stats()["spec"]
    return {k: s[k] for k in ("armed", "k", "windows", "proposed",
                              "accepted", "accept_rate", "fallbacks")}


def test_self_draft_accepts_every_proposal():
    reqs = _reqs([(8, 6), (5, 9), (12, 4), (20, 7)])
    want, got, solo, te, je = _both(reqs)
    assert got == want == solo
    stats = te.page_stats()["spec"]
    assert stats["armed"] and stats["windows"] > 0
    assert stats["accept_rate"] == pytest.approx(1.0)
    assert _spec_counts(te) == _spec_counts(je)


@pytest.mark.parametrize("k", [2, 4])
def test_truncated_draft_streams_equal_jax_and_solo(k):
    reqs = _reqs([(8, 8), (5, 10), (14, 6)], base=110)
    want, got, solo, te, je = _both(reqs, layers=1, k=k)
    assert got == want == solo
    assert 0.0 <= te.page_stats()["spec"]["accept_rate"] < 1.0
    assert _spec_counts(te) == _spec_counts(je)


def test_int8_kv_target_keeps_an_unquantized_draft_cache():
    reqs = _reqs([(8, 6), (6, 8)], base=120)
    want, got, solo, te, je = _both(reqs, layers=1, kv_quant=True, k=3)
    assert got == want == solo
    assert te._draft[0].kv_quant is False
    assert te._draft_cache["k"].dtype == torch.float32
    assert _spec_counts(te) == _spec_counts(je)


def test_prefix_sharing_and_reset():
    """Shared-prefix admissions (radix pages and the boundary copy under
    the verify's scatter) stay exact, and after ``reset`` (the draft
    cache zeroed in place) the next batch is exact again."""
    jcfg, tcfg, jp, tp = _model()
    base = _prompt(70, 20)
    reqs = [{"prompt": base[:n] + _prompt(71 + i, 4), "max_new": 6,
             "request_id": i} for i, n in enumerate([20, 20, 12])]
    kw = dict(slots=2, page_size=4, prefill_chunk=4)
    want, got, solo, te, je = _both(reqs, **kw)
    assert got == want == solo
    assert te.page_stats()["prefix_hits"] >= 1
    cache = te._draft_cache["k"]
    te.reset()
    assert te._draft_cache["k"] is cache and not bool(cache.any())
    assert te.ledger_violations() == []
    assert te.drain([dict(r) for r in reqs], decode_window=4) == want


def test_a_stream_still_prefilling_while_windows_run():
    """One prefill chunk a window (``decode_window`` 1): the long prompt
    prefills across many spec windows of the short one; the windows'
    writes must not touch its rows, and the lengths and tables of the
    stream still prefilling follow the reference's."""
    reqs = [{"prompt": _prompt(80, 3), "max_new": 20, "request_id": "s"},
            {"prompt": _prompt(81, 40), "max_new": 8, "request_id": "l"}]
    want, got, solo, te, je = _both(reqs, layers=1, window=1,
                                    prefill_chunk=4)
    assert got == want == solo
    assert _spec_counts(te) == _spec_counts(je)
    # mid-prefill, window by window, against the JAX engine
    jcfg, tcfg, jp, tp = _model()
    (jcd, jpd), (tcd, tpd) = _drafts(jcfg, tcfg, jp, tp, 1)
    kw = dict(slots=2, page_size=16, prefill_chunk=4)
    je = js.PagedServer(jcfg, jp, **kw)
    te = ts.PagedServer(tcfg, tp, device="cpu", **kw)
    je.arm_draft(jcd, jpd, k=4)
    te.arm_draft(tcd, tpd, k=4)
    for e in (je, te):
        e.submit_many([dict(r) for r in reqs])
    for _ in range(6):
        assert te.step_many(1) == je.step_many(1)
        assert te.lengths.tolist() == np.asarray(je.lengths).tolist()
        assert te.cur_tok.tolist() == np.asarray(je.cur_tok).tolist()
        assert (te._decode_tables() == je._decode_tables()).all()
        assert te._prefill_pos == je._prefill_pos


def test_a_window_crossing_max_seq_matches_jax():
    """prompt + max_new == max_seq: the last windows write past the
    table's span (page index clipped onto the last page, rope clamped),
    as the reference's do. Those writes land on rows of the last page
    that the window's committed tokens still read, so here both engines'
    streams leave solo decode's (a fault of the reference, ROADMAP
    Queue 3); the port follows the reference."""
    reqs = [{"prompt": _prompt(90, 50), "max_new": 14, "request_id": 0},
            {"prompt": _prompt(91, 61), "max_new": 3, "request_id": 1}]
    want, got, solo, te, je = _both(reqs, layers=1)
    assert got == want
    assert (len(got[0]), len(got[1])) == (14, 3)
    want, got, solo, te, je = _both(reqs)
    assert got == want


def test_arm_guards_leave_the_engine_solo():
    jcfg, tcfg, jp, tp = _model()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=16,
                            prefill_chunk=8, device="cpu")
    for cfg_d, k, code in (
            (dataclasses.replace(tcfg, vocab_size=512), 4,
             "draft_vocab_mismatch"),
            (dataclasses.replace(tcfg, rope_theta=1234.5), 4,
             "draft_rope_mismatch"),
            (dataclasses.replace(tcfg, max_seq=32), 4, "draft_max_seq"),
            (tcfg, 1, "draft_k")):
        with pytest.raises(DraftIncompatible) as e:
            engine.arm_draft(cfg_d, tp, k=k)
        assert e.value.code == code
    assert engine._draft is None and engine.draft_k == 0
    reqs = _reqs([(6, 5)], base=99)
    want = js.PagedServer(jcfg, jp, slots=2, page_size=16,
                          prefill_chunk=8).drain([dict(r) for r in reqs])
    assert engine.drain([dict(r) for r in reqs]) == want
    assert engine.page_stats()["spec"]["windows"] == 0


def test_a_sampled_engine_refuses_a_draft():
    jcfg, tcfg, jp, tp = _model()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=16,
                            prefill_chunk=8, device="cpu",
                            sampler=make_sampler(1.0, top_k=8))
    with pytest.raises(DraftIncompatible) as e:
        engine.arm_draft(tcfg, tp, k=4)
    assert e.value.code == "draft_sampled_engine"
    assert engine._draft is None


def test_disarm_returns_to_the_solo_path():
    jcfg, tcfg, jp, tp = _model()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=16,
                            prefill_chunk=8, device="cpu")
    engine.arm_draft(tcfg, tp, k=4)
    reqs = _reqs([(8, 6), (5, 7)], base=30)
    want = js.PagedServer(jcfg, jp, slots=2, page_size=16,
                          prefill_chunk=8).drain([dict(r) for r in reqs],
                                                 decode_window=4)
    assert engine.drain([dict(r) for r in reqs], decode_window=4) == want
    windows = engine.spec_windows
    engine.disarm_draft()
    assert engine._draft is None and engine._draft_cache is None
    assert engine.drain([dict(r) for r in reqs], decode_window=4) == want
    stats = engine.page_stats()["spec"]
    assert not stats["armed"] and stats["windows"] == windows
    assert engine.ledger_violations() == []


def test_a_failed_window_disarms_and_counts_a_fallback(monkeypatch):
    jcfg, tcfg, jp, tp = _model()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=16,
                            prefill_chunk=8, device="cpu")
    registry = MetricsRegistry()
    engine.arm_draft(tcfg, tp, k=4, metrics=registry)
    engine.submit_many(_reqs([(8, 6)]))
    assert engine.step_many(4) == {}          # the prefill, no window yet

    def boom(*a, **kw):
        raise RuntimeError("window failed")

    monkeypatch.setattr(tl, "verify_step_paged", boom)
    with pytest.raises(RuntimeError, match="window failed"):
        engine.step_many(4)
    assert engine._draft is None and engine.spec_fallbacks == 1
    assert registry.to_dict()["counters"]["serving.spec.fallbacks"] == 1.0
    monkeypatch.undo()
    engine.reset()
    want = js.PagedServer(jcfg, jp, slots=2, page_size=16,
                          prefill_chunk=8).drain(_reqs([(8, 6)]),
                                                 decode_window=4)
    assert engine.drain(_reqs([(8, 6)]), decode_window=4) == want


def test_frontend_exports_spec_gauges():
    jcfg, tcfg, jp, tp = _model()
    registry = MetricsRegistry()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=16,
                            prefill_chunk=8, device="cpu")
    engine.arm_draft(tcfg, tp, k=4, metrics=registry)
    engine.drain([dict(r) for r in _reqs([(8, 6), (5, 7)])],
                 decode_window=4)
    fe = ServingFrontend(engine, port=0, host="127.0.0.1",
                         metrics=registry)
    g = fe.load_gauges()
    assert g["spec_windows"] > 0
    assert g["spec_proposed"] >= g["spec_accepted"] > 0
    assert g["spec_accept_rate"] == pytest.approx(1.0)
    assert g["spec_fallbacks"] == 0
    assert fe.stats()["window"]["spec_windows"] == g["spec_windows"]
    m = registry.to_dict()
    assert m["gauges"]["ingress.spec_windows"] == g["spec_windows"]
    assert m["counters"]["serving.spec.windows"] == g["spec_windows"]
    assert m["counters"]["serving.spec.accepted"] == g["spec_accepted"]
    assert m["timers"]["serving.spec.window_seconds"]["count"] == \
        g["spec_windows"]
    solo = ServingFrontend(ts.PagedServer(tcfg, tp, slots=2, device="cpu"),
                           port=0, host="127.0.0.1")
    assert "spec_windows" not in solo.load_gauges()
