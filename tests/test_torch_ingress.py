"""The port's HTTP front door (``dcos_commons_tpu_torch/models/
ingress.py:ServingFrontend``), mirroring ``TestServingFrontend`` of
``tests/test_serving.py``: concurrent HTTP requests over the port's
``SlotServer`` return the JAX solo greedy streams, chunked streaming,
400/404, the bounded queue's 503 + Retry-After, ``/v1/prefix`` (404 over
a slot engine; over a paged one 404, 400, the cached span, 503), the
metrics and trace routes, and one run over the port's ``PagedServer``.
The front door's copies of jax-free modules (``metrics``, ``tracing``,
``utils.stats``) are held byte-equal to the JAX package's on the same
calls."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._jax_cpu  # noqa: F401

from dcos_commons_tpu import metrics as jmetrics
from dcos_commons_tpu import tracing as jtracing
from dcos_commons_tpu.models import llama as jl
from dcos_commons_tpu.utils import stats as jstats
from dcos_commons_tpu_torch import metrics as tmetrics
from dcos_commons_tpu_torch import tracing as ttracing
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.ingress import ServingFrontend
from dcos_commons_tpu_torch.utils import stats as tstats

_MODEL = {}


def _model():
    """(JAX cfg, port cfg, JAX params, port params): the tiny 2-layer fp32
    model of the JAX serving tests, weights from ``key(0)``."""
    if not _MODEL:
        kw = dict(n_layers=2, max_seq=64)
        jcfg = jl.LlamaConfig.tiny(attn_impl="dense", dtype=jnp.float32, **kw)
        tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
        jp = jl.init_params(jcfg, jax.random.key(0))
        _MODEL["m"] = (jcfg, tcfg, jp,
                       params_from_jax(jax.device_get(jp), device="cpu"))
    return _MODEL["m"]


def _solo(prompt, steps):
    """The JAX reference's solo greedy stream."""
    jcfg, _, jp, _ = _model()
    toks = jl.generate_stepwise(jcfg, jp, jnp.asarray([prompt], jnp.int32),
                                steps)
    return [int(t) for t in toks[0]]


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


def _frontend(slots=2, engine=None, **kw):
    _, tcfg, _, tp = _model()
    engine = engine or ts.SlotServer(tcfg, tp, slots=slots, device="cpu")
    return ServingFrontend(engine, port=0, host="127.0.0.1", **kw)


def _post(port, payload, path="/v1/generate", headers=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path, raw=False):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        body = r.read()
        return r.status, (body.decode() if raw else json.loads(body))


def _concurrent(port, prompts, budgets):
    results = [None] * len(prompts)

    def hit(i):
        results[i] = _post(port, {"prompt": prompts[i],
                                  "max_new": budgets[i]})

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


def test_http_requests_match_solo_decode():
    """Concurrent clients each get exactly their solo greedy stream with
    per-request timings; health and stats reflect the served work."""
    fe = _frontend(slots=2).start()
    try:
        status, health = _get(fe.port, "/v1/healthz")
        assert status == 200 and health["ok"] and health["slots"] == 2
        prompts = [_prompt(i, 6 + i) for i in (1, 2, 3)]
        budgets = [6, 9, 4]
        results = _concurrent(fe.port, prompts, budgets)
        for i, (status, body) in enumerate(results):
            assert status == 200
            assert body["tokens"] == _solo(prompts[i], budgets[i])
            assert body["ttft_ms"] > 0 and body["queue_ms"] >= 0
            assert body["tpot_ms"] > 0
        _, stats = _get(fe.port, "/v1/stats")
        assert stats["requests"] == 3 and stats["tokens"] == sum(budgets)
        assert stats["ttft_ms"]["p50"] > 0 and stats["tpot_ms"]["p50"] > 0
        assert stats["window"]["completed"] == 3
    finally:
        fe.stop()


def test_http_streaming_tokens():
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    fe = _frontend(slots=1).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/v1/generate",
            data=json.dumps({"prompt": prompt, "max_new": 5,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
            lines = [json.loads(raw) for raw in r]
        assert [e["token"] for e in lines if "token" in e] == \
            _solo(prompt, 5)
        assert lines[-1]["done"] is True and lines[-1]["ttft_ms"] > 0
    finally:
        fe.stop()


def test_http_rejects_bad_requests_and_routes():
    _, tcfg, _, _ = _model()
    fe = _frontend(slots=1).start()
    try:
        for payload in ({"prompt": []}, {"prompt": ["x"]},
                        {"prompt": [1, 2], "max_new": tcfg.max_seq},
                        {"prompt": [1, 2], "max_new": 0}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(fe.port, payload)
            assert e.value.code == 400, payload
        for call in (lambda: _get(fe.port, "/v1/nope"),
                     lambda: _post(fe.port, {}, path="/v1/nope")):
            with pytest.raises(urllib.error.HTTPError) as e:
                call()
            assert e.value.code == 404
        # a slot engine exports no prefix: the reference's own answer
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fe.port, {"prompt": [1, 2, 3]}, path="/v1/prefix")
        assert e.value.code == 404
        assert json.loads(e.value.read())["error"] == \
            "engine has no prefix export"
    finally:
        fe.stop()


def test_http_bounded_queue_backpressure():
    """max_queue=1 with the HTTP thread but no engine thread: the queued
    request is visible, the next one answers 503 + Retry-After, and once
    the engine starts the queued one completes."""
    fe = _frontend(slots=1, max_queue=1)
    fe._http_thread = threading.Thread(target=fe._httpd.serve_forever,
                                       daemon=True)
    fe._http_thread.start()
    try:
        results = []
        t1 = threading.Thread(target=lambda: results.append(
            _post(fe.port, {"prompt": [1, 2, 3, 4], "max_new": 4})))
        t1.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            if _get(fe.port, "/v1/healthz")[1]["queued"] == 1:
                break
            time.sleep(0.01)
        assert _get(fe.port, "/v1/healthz")[1]["queued"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fe.port, {"prompt": [1, 2], "max_new": 2})
        assert e.value.code == 503 and e.value.headers["Retry-After"]
        fe._engine_thread = threading.Thread(
            target=fe._run_engine, daemon=True, name="serving-engine")
        fe._engine_thread.start()
        t1.join(timeout=300)
        assert not t1.is_alive()
        assert results and results[0][0] == 200
        assert results[0][1]["tokens"] == _solo([1, 2, 3, 4], 4)
        stats = _get(fe.port, "/v1/stats")[1]
        assert stats["rejected"] == 1 and stats["window"]["shed"] == 1
    finally:
        fe.stop()


def test_paged_engine_serves_behind_the_front_door():
    _, tcfg, _, tp = _model()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=16,
                            prefill_chunk=8, device="cpu")
    fe = _frontend(engine=engine, decode_window=4).start()
    try:
        prompts = [_prompt(i, n) for i, n in ((20, 9), (21, 30), (22, 4))]
        budgets = [5, 7, 3]
        for i, (status, body) in enumerate(
                _concurrent(fe.port, prompts, budgets)):
            assert status == 200
            assert body["tokens"] == _solo(prompts[i], budgets[i])
        _, health = _get(fe.port, "/v1/healthz")
        assert health["pages_free"] == engine.pages_free()
        assert health["load"]["pages_total"] == engine.total_pages
        assert engine.ledger_violations() == []
    finally:
        fe.stop()


def _post_raw(port, payload, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_prefix_export_route():
    """``POST /v1/prefix`` over a paged engine: 404 while nothing is
    cached, 400 on a bad body, and once a request has retired the
    cached full pages of the prompt as a KVSPAN1 span whose pages are
    the engine's own; a job the engine thread never runs answers 503."""
    from dcos_commons_tpu_torch.models.disagg import unpack_span
    _, tcfg, _, tp = _model()
    engine = ts.PagedServer(tcfg, tp, slots=2, page_size=8,
                            prefill_chunk=8, device="cpu")
    fe = _frontend(engine=engine).start()
    prompt = _prompt(23, 20)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_raw(fe.port, {"prompt": prompt}, "/v1/prefix")
        assert e.value.code == 404
        assert json.loads(e.value.read())["error"] == "no resident prefix"
        for bad in ({"prompt": []}, {"prompt": ["x"]}, {}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_raw(fe.port, bad, "/v1/prefix")
            assert e.value.code == 400, bad
        assert _post(fe.port, {"prompt": prompt, "max_new": 3})[1][
            "tokens"] == _solo(prompt, 3)
        status, ctype, body = _post_raw(fe.port, {"prompt": prompt + [1]},
                                        "/v1/prefix")
        assert status == 200 and ctype == "application/octet-stream"
        span = unpack_span(body)
        assert span["prompt"] == prompt[:16] and span["first_token"] == -1
        shared, _ = engine.radix.lookup(prompt)
        want = engine._gather_span(shared)
        for p in shared:
            engine.ledger.unref(p)
        for side in ("k", "v"):
            assert torch.equal(span["payload"][side], want[side])
        assert engine.exported_prefixes == 1
        _, m = _get(fe.port, "/v1/metrics")
        assert m["counters"]["ingress.prefix_exports"] == 1
    finally:
        fe.stop()
    # no engine thread: the job is never run, and the wait ends in a 503
    fe = _frontend(engine=engine)
    fe.export_timeout_s = 0.2
    fe._http_thread = threading.Thread(target=fe._httpd.serve_forever,
                                       daemon=True)
    fe._http_thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_raw(fe.port, {"prompt": prompt}, "/v1/prefix")
        assert e.value.code == 503
        assert e.value.headers.get("Retry-After") == "1"
    finally:
        fe.stop()


def test_metrics_and_trace_routes():
    """A request carrying ``X-Tpu-Trace`` lands a complete trace under the
    caller's id; the registry serves JSON and Prometheus text."""
    store = ttracing.TraceStore()
    fe = _frontend(slots=1, trace_store=store).start()
    try:
        parent = "00000000000000aa-00000000000000bb"
        _post(fe.port, {"prompt": [5, 6, 7], "max_new": 3},
              headers={ttracing.TRACE_HEADER: parent})
        _, traces = _get(fe.port, "/v1/traces")
        assert traces["trace_ids"] == ["00000000000000aa"]
        _, trace = _get(fe.port, "/v1/trace/00000000000000aa")
        assert trace["complete"]
        names = {s["name"] for s in trace["spans"]}
        assert {"serve.request", "serve.queue_wait", "serve.first_token",
                "serve.decode"} <= names
        root = next(s for s in trace["spans"] if s["name"] == "serve.request")
        assert root["parent_id"] == "00000000000000bb"
        assert root["attrs"]["tokens"] == 3
        _, m = _get(fe.port, "/v1/metrics")
        assert m["counters"]["ingress.requests_total"] == 1.0
        assert m["timers"]["ingress.ttft_seconds"]["count"] == 1
        assert m["gauges"]["ingress.queue_capacity"] == 64
        _, text = _get(fe.port, "/v1/metrics/prometheus", raw=True)
        assert "# TYPE ingress_ttft_seconds histogram" in text
    finally:
        fe.stop()


def _drive_registry(reg):
    reg.counter("ingress.requests_total")
    reg.counter("ingress.requests_total", 2)
    reg.counter("a.b")
    reg.counter("a_b", 5)                  # sanitizes onto "a.b"'s name
    reg.counter("9lives")
    for x in (0.0, 3e-5, 1e-4, 0.0123, 0.5, 2.0, 7.5, 5e3, -1.0):
        reg.observe("ingress.ttft_seconds", x)
    reg.observe("router.hop", 0.25)
    reg.gauge("g.int", lambda: 3)
    reg.gauge("g.float", lambda: 0.125)
    reg.gauge("g.none", lambda: None)
    reg.gauge("g.bool", lambda: True)
    reg.gauge("g.raises", lambda: 1 / 0)


def test_metrics_registry_is_byte_equal_to_the_reference():
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    for reg in regs:
        _drive_registry(reg)
    assert regs[1].to_dict() == regs[0].to_dict()
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    assert tmetrics.BUCKET_BOUNDS == jmetrics.BUCKET_BOUNDS
    for reg in regs:
        reg.close()


@pytest.mark.parametrize("value", [
    None, "", "abc-def", " 0a1b-ff00 ", "abc", "abc-", "-def", "ABC-def",
    "xyz-123", "a-b-c", "00000000000000aa-00000000000000bb"])
def test_parse_header_matches_the_reference(value):
    want = jtracing.parse_header(value)
    got = ttracing.parse_header(value)
    if want is None:
        assert got is None
    else:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert got.header() == want.header()


def test_percentiles_match_the_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        xs = [float(x) for x in rng.exponential(3.0, n)]
        assert tstats.percentiles(xs) == jstats.percentiles(xs)
        assert tstats.percentiles(xs, (0.5, 0.9), 1) == \
            jstats.percentiles(xs, (0.5, 0.9), 1)
