"""Disaggregated prefill/decode serving in the port
(``dcos_commons_tpu_torch/models/disagg.py``: ``KVShipper``,
``PrefillWorker``, ``DisaggCoordinator``; ``PagedServer.prefill_span`` /
``adopt_pages``; the front door's external-driver seams) against the JAX
reference on the cases of ``tests/test_disagg.py``: the tiny 2-layer model
(``max_seq`` 64, page 8), weights carried over from the JAX init.

``prefill_span`` gives JAX's first token (exact) and K/V (fp32, within
``KV_ATOL``); a span shipped through the wire and adopted decodes the JAX
co-located engine's tokens in fp32, bf16 and int8 pools and with a
dropless MoE (bf16: prompts whose argmaxes are tie-free, as in
``tests/test_torch_serving_tiers.py``); frames cross both ways between
the packages; aborted adoptions, dedup, stalls, refusals and a full pool
match the reference; the coordinator serves over HTTP, degrades to the
co-located path on a dead peer and skips a dead peer in a list; the
prefill tier's HTTP contract; the external-driver health stamp and
``fail_inflight``. Every case ends with a clean page ledger."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu.models import disagg as jdisagg
from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.models import serving as js
from dcos_commons_tpu.parallel import aot as jaot
from dcos_commons_tpu.parallel import moe as jmoe
from dcos_commons_tpu_torch.models import disagg as tdisagg
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.ingress import ServingFrontend, _Pending
from dcos_commons_tpu_torch.parallel import moe as tmoe

ENGINE = dict(slots=2, page_size=8, prefill_chunk=8)
# prefill_span's fp32 K/V, port vs JAX: the same chunked forward in
# another reduction order
KV_ATOL = 1e-5
_MODELS = {}


@pytest.fixture(scope="module")
def jax_cache():
    return jaot.CompileCache()


def _model(kind="fp32"):
    """(JAX cfg, port cfg, JAX params, port params) for a pool kind:
    fp32, bf16, int8 (int8 K/V, fp32 compute) or moe (4 experts)."""
    if kind not in _MODELS:
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kind == "bf16"
                    else (jnp.float32, torch.float32))
        kw = dict(n_layers=2, max_seq=64, kv_quant=kind == "int8")
        jcfg = jl.LlamaConfig.tiny(attn_impl="dense", dtype=jdt, **kw)
        tcfg = tl.LlamaConfig.tiny(dtype=tdt, **kw)
        if kind == "moe":
            jp = jl.init_moe_params(jcfg, 4, jax.random.key(0))
        else:
            jp = jl.init_params(jcfg, jax.random.key(0))
        _MODELS[kind] = (jcfg, tcfg, jp,
                         params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODELS[kind]


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _moe_kw(kind, pkg):
    if kind != "moe":
        return {}
    m = jmoe if pkg == "jax" else tmoe
    return {"moe": m.dropless(m.MoEConfig(4))}


def _jax_engine(kind, jax_cache, **kw):
    jcfg, _, jp, _ = _model(kind)
    cache = jax_cache if kind != "moe" else None
    return js.PagedServer(jcfg, jp, compile_cache=cache,
                          **{**ENGINE, **_moe_kw(kind, "jax"), **kw})


def _port_engine(kind, **kw):
    _, tcfg, _, tp = _model(kind)
    return ts.PagedServer(tcfg, tp, device="cpu",
                          **{**ENGINE, **_moe_kw(kind, "port"), **kw})


def _colocated(kind, jax_cache, reqs):
    """The JAX co-located engine's streams for ``reqs`` [(prompt,
    max_new)]: the reference every adopted stream is held to."""
    eng = _jax_engine(kind, jax_cache)
    return {i: eng.drain([{"prompt": p, "max_new": m, "request_id": i}])[i]
            for i, (p, m) in enumerate(reqs)}


def _drain(engine):
    while engine.requests_active():
        engine.step()
    out = dict(engine.finished)
    engine.finished.clear()
    return out


def _audit(*engines):
    for eng in engines:
        assert eng.ledger_violations() == []


def _np(side):
    """A span side as numpy (bf16 through float32)."""
    if isinstance(side, dict):
        return {k: _np(v) for k, v in side.items()}
    if isinstance(side, torch.Tensor):
        return side.float().numpy() if side.dtype == torch.bfloat16 \
            else side.numpy()
    return np.asarray(side, np.float32) if side.dtype.name == "bfloat16" \
        else np.asarray(side)


# ---------------------------------------------------------- prefill_span


@pytest.mark.parametrize("seed,n", [(200, 21), (201, 8), (202, 40)])
def test_prefill_span_matches_jax(seed, n, jax_cache):
    """The same prompt through both engines' ``prefill_span``: the first
    token exact, the K/V pages within ``KV_ATOL``, the span's keys and
    header fields equal; a repeat hits the prefill tier's own radix in
    both."""
    jeng, teng = _jax_engine("fp32", jax_cache), _port_engine("fp32")
    prompt = _prompt(seed, n)
    for _ in range(2):
        want, got = jeng.prefill_span(prompt), teng.prefill_span(prompt)
        assert sorted(got) == sorted(want)
        assert got["first_token"] == want["first_token"]
        for key in ("version", "prompt", "page_size", "kv_quant"):
            assert got[key] == want[key], key
        for side in ("k", "v"):
            np.testing.assert_allclose(_np(got["payload"][side]),
                                       _np(want["payload"][side]),
                                       rtol=0, atol=KV_ATOL)
    for key in ("shipped_spans", "prefix_hits", "prefix_shared_pages",
                "pages_free"):
        assert teng.page_stats()[key] == jeng.page_stats()[key], key
    _audit(jeng, teng)


# ---------------------------------------------------- ship -> adopt path


SHIP_CASES = {"fp32": [(9, 6), (20, 5), (13, 7)],
              "bf16": [(9, 6), (20, 5), (13, 7)],
              "int8": [(9, 6), (20, 5), (13, 7)],
              "moe": [(9, 5), (20, 4)]}


@pytest.mark.parametrize("kind", sorted(SHIP_CASES))
def test_ship_adopt_parity_with_the_jax_engine(kind, jax_cache):
    """Prefilled on the port's prefill tier, packed, unpacked and adopted
    by the port's decode tier: the JAX co-located engine's tokens, and
    the counters the JAX pair keeps on the same traffic."""
    seed = {"fp32": 210, "bf16": 214, "int8": 218, "moe": 222}[kind]
    reqs = [(_prompt(seed + i, n), m)
            for i, (n, m) in enumerate(SHIP_CASES[kind])]
    want = _colocated(kind, jax_cache, reqs)
    pairs = {"jax": (_jax_engine(kind, jax_cache),
                     _jax_engine(kind, jax_cache)),
             "port": (_port_engine(kind), _port_engine(kind))}
    packages = {"jax": jdisagg, "port": tdisagg}
    got = {}
    for name, (pre, dec) in pairs.items():
        wire = packages[name]
        got[name] = {}
        for i, (p, m) in enumerate(reqs):
            span = wire.unpack_span(wire.pack_span(pre.prefill_span(p)))
            assert dec.adopt_pages(span, max_new=m, request_id=i) is not None
            got[name].update(_drain(dec))
        _audit(pre, dec)
    assert got["port"] == want
    assert got["jax"] == want
    for key in ("adopted_spans", "adopt_shared_pages", "prefix_hits",
                "pages_free"):
        assert pairs["port"][1].page_stats()[key] == \
            pairs["jax"][1].page_stats()[key], key
    assert pairs["port"][1].page_stats()["adopted_spans"] == len(reqs)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_frames_cross_both_ways(kind, jax_cache):
    """A JAX prefill tier's frame adopted by the port's decode tier, and
    the port's frame adopted by the JAX decode tier: both decode the JAX
    co-located engine's tokens."""
    reqs = [(_prompt(230 + i, n), 6) for i, n in enumerate((11, 24))]
    want = _colocated(kind, jax_cache, reqs)
    jpre, jdec = _jax_engine(kind, jax_cache), _jax_engine(kind, jax_cache)
    tpre, tdec = _port_engine(kind), _port_engine(kind)
    for i, (p, m) in enumerate(reqs):
        from_jax = jdisagg.pack_span(jpre.prefill_span(p))
        from_port = tdisagg.pack_span(tpre.prefill_span(p))
        assert tdec.adopt_pages(tdisagg.unpack_span(from_jax), max_new=m,
                                request_id=i) is not None
        assert jdec.adopt_pages(jdisagg.unpack_span(from_port), max_new=m,
                                request_id=i) is not None
        assert _drain(tdec)[i] == want[i]
        assert _drain(jdec)[i] == want[i]
    _audit(jpre, jdec, tpre, tdec)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_adoption_installs_in_place(kind):
    """An adoption writes into the tensors the engine was built with
    (captured windows bind them on CUDA): the pool, ``lengths``,
    ``cur_tok`` and the table buffer keep their storage, and the
    installed pages are the span's bytes."""
    from dcos_commons_tpu_torch.ops.quant import QTensor

    def ptrs(eng):
        out = [eng.lengths.data_ptr(), eng.cur_tok.data_ptr(),
               eng._table_buf.data_ptr()]
        for t in eng.pool.values():
            out += ([t.q.data_ptr(), t.s.data_ptr()]
                    if isinstance(t, QTensor) else [t.data_ptr()])
        return out

    pre, dec = _port_engine(kind), _port_engine(kind)
    before = ptrs(dec)
    prompt = _prompt(235, 19)
    span = tdisagg.unpack_span(tdisagg.pack_span(pre.prefill_span(prompt)))
    slot = dec.adopt_pages(span, max_new=4, request_id="a")
    assert ptrs(dec) == before
    got = dec._gather_span(dec._stream_pages[slot][:3])
    for side in ("k", "v"):
        a, b = got[side], span["payload"][side]
        for x, y in ([(a["q"], b["q"]), (a["s"], b["s"])]
                     if isinstance(a, dict) else [(a, b)]):
            assert torch.equal(x, y)
    assert int(dec.lengths[slot]) == 19
    assert int(dec.cur_tok[slot]) == span["first_token"]
    _drain(dec)
    assert ptrs(dec) == before
    _audit(pre, dec)


def test_adoption_abort_unwinds_every_reservation(jax_cache, monkeypatch):
    """A failure AFTER pages are reserved gives every reference back:
    pages_free and the ledger audit recover, and the same span adopts
    afterwards with the JAX engine's tokens."""
    prompt = _prompt(240, 18)
    want = _colocated("fp32", jax_cache, [(prompt, 4)])[0]
    pre, dec = _port_engine("fp32"), _port_engine("fp32")
    # a cached prefix, so the abort also holds shared radix references
    dec.drain([{"prompt": prompt, "max_new": 2, "request_id": "warm"}])
    dec.finished.clear()
    span = tdisagg.unpack_span(tdisagg.pack_span(pre.prefill_span(prompt)))
    before = (dec.pages_free(), dec.ledger.in_use())

    def boom(*args):
        raise RuntimeError("device lost")

    monkeypatch.setattr(dec, "_install", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        dec.adopt_pages(span, max_new=4)
    monkeypatch.undo()
    assert (dec.pages_free(), dec.ledger.in_use()) == before
    assert not dec.requests_active()
    _audit(dec)
    assert dec.adopt_pages(span, max_new=4, request_id="ok") is not None
    assert _drain(dec)["ok"] == want
    _audit(pre, dec)


def test_adopt_dedupes_a_shipped_prefix_as_jax(jax_cache):
    """The second adoption of a repeated prompt shares its full pages
    through the decode tier's radix (their payload is never written),
    with JAX's counters and tokens on both tiers."""
    prompt = _prompt(250, 20)
    stats = {}
    for name, mk in (("jax", lambda: _jax_engine("fp32", jax_cache)),
                     ("port", lambda: _port_engine("fp32"))):
        wire = jdisagg if name == "jax" else tdisagg
        pre, dec = mk(), mk()
        toks = []
        for i in range(2):
            span = wire.unpack_span(wire.pack_span(pre.prefill_span(prompt)))
            assert dec.adopt_pages(span, max_new=4, request_id=i) is not None
            toks.append(_drain(dec)[i])
        stats[name] = (toks, dec.page_stats()["adopt_shared_pages"],
                       pre.page_stats()["prefix_hits"],
                       pre.page_stats()["prefix_shared_pages"])
        _audit(pre, dec)
    assert stats["port"] == stats["jax"]
    assert stats["port"][1] > 0 and stats["port"][2] > 0
    assert stats["port"][0][0] == stats["port"][0][1]


def test_adopt_stalls_on_pages_free_then_admits(jax_cache):
    """A full pool answers None (the coordinator's transfer stall) and
    the same span admits once the hog retires, with JAX's tokens."""
    hog, late = _prompt(260, 30), _prompt(261, 16)
    want = _colocated("fp32", jax_cache, [(late, 8)])[0]
    pre = _port_engine("fp32")
    dec = _port_engine("fp32", slots=4, pages=6, prefix_cache=False)
    assert dec.submit(hog, max_new=10, request_id="hog") is not None
    span = tdisagg.unpack_span(tdisagg.pack_span(pre.prefill_span(late)))
    before = dec.pages_free()
    assert dec.adopt_pages(span, max_new=8) is None      # 3 pages > 1 free
    assert dec.pages_free() == before
    _drain(dec)
    assert dec.adopt_pages(span, max_new=8, request_id="late") is not None
    assert _drain(dec)["late"] == want
    _audit(pre, dec)


@pytest.mark.parametrize("change,match", [
    (lambda s: dict(s, page_size=16), "page.size|page size"),
    (lambda s: dict(s, kv_quant=True), "kv_quant"),
    (lambda s: dict(s, prompt=s["prompt"] * 10), "max_seq|cache|pages"),
    (lambda s: dict(s, payload={side: v[:, :, :4] for side, v in
                                s["payload"].items()}), "shape"),
], ids=["page_size", "kv_quant", "too_long", "payload_shape"])
def test_adopt_rejects_mismatched_tiers_before_reserving(change, match):
    """Config mismatches raise ValueError BEFORE any reservation."""
    pre, dec = _port_engine("fp32"), _port_engine("fp32")
    span = tdisagg.unpack_span(tdisagg.pack_span(
        pre.prefill_span(_prompt(270, 12))))
    before = (dec.pages_free(), dec.ledger.in_use())
    with pytest.raises(ValueError, match=match):
        dec.adopt_pages(change(span), max_new=4)
    assert (dec.pages_free(), dec.ledger.in_use()) == before
    _audit(pre, dec)


def test_prefill_span_releases_the_pool_and_rejects_the_impossible(
        jax_cache):
    """A prefill-only engine gives every working page back after the
    span (back-to-back spans reuse a pool of 2), answers None on a pool
    it cannot fill and raises as JAX does on impossible prompts."""
    out = {}
    for name, mk in (("jax", lambda **kw: _jax_engine("fp32", jax_cache,
                                                      **kw)),
                     ("port", lambda **kw: _port_engine("fp32", **kw))):
        tiny = mk(slots=1, pages=2, prefix_cache=False)
        firsts = []
        for i in range(3):                   # 2 pages each, pool of 2
            firsts.append(tiny.prefill_span(_prompt(280 + i, 16))[
                "first_token"])
            assert tiny.pages_free() == 2
        errors = []
        for bad in (_prompt(283, 40), [], _prompt(284, 64)):
            with pytest.raises(ValueError) as ei:
                tiny.prefill_span(bad)
            errors.append(str(ei.value))
        # a full pool: a stream holds both pages, the span needs one
        assert tiny.submit(_prompt(285, 9), max_new=4) is not None
        full = tiny.prefill_span(_prompt(286, 5))
        out[name] = (firsts, errors, full, tiny.pages_free())
        _audit(tiny)
    assert out["port"] == out["jax"]
    assert out["port"][2] is None
    assert [e.split()[0] for e in out["port"][1]] == ["prompt", "empty",
                                                      "prompt"]


# ----------------------------------------------------- coordinator + HTTP


def _post(port, payload, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _serve_pair(peer_of=lambda port: f"http://127.0.0.1:{port}", **kw):
    """A port prefill tier behind ``PrefillWorker`` and a port decode tier
    behind an externally driven front door and a coordinator."""
    pre, dec = _port_engine("fp32"), _port_engine("fp32")
    worker = tdisagg.PrefillWorker(pre, port=0, host="127.0.0.1").start()
    fe = ServingFrontend(dec, port=0, host="127.0.0.1").start(drive=False)
    coord = tdisagg.DisaggCoordinator(dec, fe, peer_of(worker.port),
                                      decode_window=4, **kw).start()
    return pre, dec, worker, fe, coord


def test_coordinator_serves_over_http_with_jax_tokens(jax_cache):
    """Client → decode front door → coordinator ships to the prefill
    tier → spans adopt → decode: three concurrent requests get the JAX
    co-located engine's streams, and the receipts show real shipping."""
    reqs = [(_prompt(290 + i, 9 + 4 * i), 6) for i in range(3)]
    want = _colocated("fp32", jax_cache, reqs)
    pre, dec, worker, fe, coord = _serve_pair()
    try:
        results = [None] * 3

        def hit(i):
            results[i] = _post(fe.port, {"prompt": reqs[i][0],
                                         "max_new": 6})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i in range(3):
            status, body = results[i]
            assert status == 200, (i, body)
            assert body["tokens"] == want[i], i
        st = coord.stats()
        assert st["spans_shipped"] == 3 and st["kv_bytes_shipped"] > 0
        assert st["peer_fallbacks"] == 0 and st["transfers_inflight"] == 0
        assert sorted(st) == sorted(jdisagg.DisaggCoordinator(
            None, None, "").stats())
        assert fe.health()["ok"]
        assert dec.page_stats()["adopted_spans"] == 3
        assert pre.page_stats()["shipped_spans"] == 3
    finally:
        coord.stop()
        fe.stop()
        worker.stop()
    _audit(pre, dec)


def test_dead_peer_degrades_to_colocated(jax_cache):
    """A dead peer never drops a request: the coordinator runs it on the
    decode tier's own engine, counted in ``peer_fallbacks``, with the JAX
    engine's tokens."""
    p = _prompt(300, 11)
    want = _colocated("fp32", jax_cache, [(p, 5)])[0]
    eng = _port_engine("fp32")
    fe = ServingFrontend(eng, port=0, host="127.0.0.1").start(drive=False)
    coord = tdisagg.DisaggCoordinator(
        eng, fe, "http://127.0.0.1:9", shipper=tdisagg.KVShipper(2.0),
        decode_window=4).start()
    try:
        status, body = _post(fe.port, {"prompt": p, "max_new": 5})
        assert status == 200 and body["tokens"] == want
        st = coord.stats()
        assert st["peer_fallbacks"] == 1 and st["spans_shipped"] == 0
        assert st["peers_down"] == ["http://127.0.0.1:9"]
    finally:
        coord.stop()
        fe.stop()
    _audit(eng)


def test_peer_list_parsing_matches_jax():
    """One URL, a comma-separated list (blanks dropped), a list or
    nothing; ``.peer`` is the first."""
    for peer in ("http://a:1, ,http://b:2,", None, "",
                 ["http://a:1", " http://b:2"], "http://c:3"):
        got = tdisagg.DisaggCoordinator(None, None, peer)
        want = jdisagg.DisaggCoordinator(None, None, peer)
        assert (got.peers, got.peer) == (want.peers, want.peer), peer
    assert tdisagg.DisaggCoordinator(
        None, None, "http://a:1, ,http://b:2,").peers == ["http://a:1",
                                                         "http://b:2"]


def test_multi_peer_skips_a_dead_peer_before_degrading(jax_cache):
    """With a peer list, a dead peer is tried, marked down and skipped
    while the request ships through the next: no co-located degrade."""
    reqs = [(_prompt(310 + i, 9 + 4 * i), 5) for i in range(2)]
    want = _colocated("fp32", jax_cache, reqs)
    dead = "http://127.0.0.1:9"
    pre, dec, worker, fe, coord = _serve_pair(
        lambda port: f"{dead}, http://127.0.0.1:{port}")
    try:
        for i, (p, m) in enumerate(reqs):
            status, body = _post(fe.port, {"prompt": p, "max_new": m})
            assert status == 200 and body["tokens"] == want[i], body
        st = coord.stats()
        assert st["spans_shipped"] == 2 and st["peer_fallbacks"] == 0
        assert dead in st["peers_down"]
    finally:
        coord.stop()
        fe.stop()
        worker.stop()
    _audit(pre, dec)


def _http(base, path, data=None):
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_prefill_worker_http_contract():
    """healthz names the tier and its pages; a good post returns a frame
    that verifies; a bad body, a bad route and a prompt the engine can
    never prefill are 400 / 404 / 400; a full pool is a 503 that shows in
    the load gauges; metrics, Prometheus text and traces answer."""
    eng = _port_engine("fp32", pages=2, prefix_cache=False)
    worker = tdisagg.PrefillWorker(eng, port=0, host="127.0.0.1").start()
    base = f"http://127.0.0.1:{worker.port}"
    try:
        code, body = _http(base, "/v1/healthz")
        hz = json.loads(body)
        assert code == 200 and hz["ok"] and hz["role"] == "prefill"
        assert sorted(hz) == ["load", "ok", "pages_free", "role",
                              "shipped_spans"]
        assert hz["pages_free"] == 2 and hz["shipped_spans"] == 0
        span = tdisagg.KVShipper(timeout_s=60).fetch(base, _prompt(320, 10))
        assert span["first_token"] >= 0 and len(span["prompt"]) == 10
        assert json.loads(_http(base, "/v1/healthz")[1])[
            "shipped_spans"] == 1
        assert _http(base, "/v1/prefill", b'{"prompt": "nope"}')[0] == 400
        assert _http(base, "/v1/prefill", b"[1, 2]")[0] == 400
        assert _http(base, "/v1/prefill",
                     json.dumps({"prompt": _prompt(321, 40)}).encode()
                     )[0] == 400
        assert _http(base, "/v1/nope", b"{}")[0] == 404
        assert _http(base, "/v1/nope")[0] == 404
        assert eng.submit(_prompt(322, 9), max_new=4) is not None
        code, body = _http(base, "/v1/prefill",
                           json.dumps({"prompt": [1, 2, 3]}).encode())
        assert code == 503 and b"exhausted" in body
        with pytest.raises(tdisagg.PageShipError, match="503"):
            tdisagg.KVShipper(timeout_s=60).fetch(base, [1, 2, 3])
        load = worker.load_gauges()
        assert load["shed"] == 2 and load["completed"] == 1
        assert load["pages_total"] == 2
        metrics = json.loads(_http(base, "/v1/metrics")[1])
        assert "prefill.spans_served" in json.dumps(metrics)
        code, text = _http(base, "/v1/metrics/prometheus")
        assert code == 200 and b"prefill" in text
        assert _http(base, "/v1/traces")[0] == 200
    finally:
        worker.stop()


# --------------------------------------------- the external-driver seams


def test_driven_health_stamp_and_fail_inflight_reset():
    """With ``drive=False`` health is ok only while ``mark_driven`` is
    fresh; ``fail_inflight`` fails the attached request and resets the
    engine (every page back, the ledger clean)."""
    eng = _port_engine("fp32")
    fe = ServingFrontend(eng, port=0, host="127.0.0.1").start(drive=False)
    try:
        assert fe.health()["ok"] is False
        fe.mark_driven()
        assert fe.health()["ok"] is True
        fe.driven_ttl_s = 0.0
        assert fe.health()["ok"] is False
        fe.driven_ttl_s = 600.0
        pending = _Pending(_prompt(330, 12), 8)
        slot = eng.submit(pending.prompt, pending.max_new,
                          request_id=pending)
        fe.attach(slot, pending)
        eng.step()
        fe.sync()
        assert eng.requests_active() and not pending.done.is_set()
        fe.fail_inflight("engine error: test")
        assert pending.done.is_set() and pending.error == "engine error: test"
        assert not eng.requests_active()
        assert eng.pages_free() == eng.total_pages
        assert fe.stats()["errors"] == 1
        _audit(eng)
    finally:
        fe.stop()
