"""The fleet router in the port (``dcos_commons_tpu_torch/models/router.py``
and ``scheduler/elastic.py::backpressure``) against the JAX package's: the
affinity key, the consistent-hash ring, token buckets on an injected
clock, QoS classes, tenant admission, the replica set and the pressure
signal give the reference's answers on the same inputs; then the
behaviours of ``tests/test_router.py`` over tiny port ``PagedServer``
replicas behind the port's ``ServingFrontend`` on 127.0.0.1 (2 layers,
``max_seq`` 64, page 8, fp32): replies equal a direct call to the replica
that served them, affinity beats random on radix hits, spill off a dead
or busy replica, a resize under load drops nothing, the migration
redirect chains, and ``/v1/routestats`` with the reference's keys."""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from dcos_commons_tpu.models import router as jr
from dcos_commons_tpu.scheduler import elastic as jel
from dcos_commons_tpu_torch.models import llama as tl
from dcos_commons_tpu_torch.models import router as tr
from dcos_commons_tpu_torch.models import serving as ts
from dcos_commons_tpu_torch.models.ingress import ServingFrontend
from dcos_commons_tpu_torch.scheduler import elastic as tel

PS = 8


def _prompt(seed, n, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


# ------------------------------------------------------ host-side parity


@pytest.mark.parametrize("n,page_size,pages", [
    (32, 8, 1), (32, 8, 2), (5, 8, 1), (64, 64, 1), (100, 16, 3), (1, 4, 1)])
def test_route_key_equals_the_reference(n, page_size, pages):
    for seed in range(4):
        prompt = _prompt(seed, n)
        assert tr.route_key(prompt, page_size, pages) == \
            jr.route_key(prompt, page_size, pages)


@pytest.mark.parametrize("vnodes", [1, 8, 64])
def test_hash_ring_equals_the_reference(vnodes):
    """Points, lookups and preference lists equal the reference's, and
    stay equal through an add and a remove."""
    nodes = [f"http://r{i}:1" for i in range(4)]
    rings = [m.HashRing(nodes, vnodes=vnodes) for m in (jr, tr)]
    keys = [f"key-{i}" for i in range(64)] + [
        jr.route_key(_prompt(i, 24), PS) for i in range(16)]

    def same():
        assert rings[1]._points == rings[0]._points
        assert rings[1].nodes() == rings[0].nodes()
        assert len(rings[1]) == len(rings[0])
        for k in keys:
            assert rings[1].lookup(k) == rings[0].lookup(k)
            assert rings[1].preference(k) == rings[0].preference(k)
            assert rings[1].preference(k, 2) == rings[0].preference(k, 2)

    same()
    for r in rings:
        r.add("http://new:1")
    same()
    for r in rings:
        r.remove(nodes[1])
        r.remove("never-there")
    same()
    with pytest.raises(ValueError):
        tr.HashRing(vnodes=0)
    assert tr.HashRing().lookup("k") is None


def test_token_bucket_equals_the_reference():
    clock = [0.0]
    buckets = [m.TokenBucket(rate=1.5, burst=3.0, clock=lambda: clock[0])
               for m in (jr, tr)]
    for step in (0.0, 0.0, 0.0, 0.0, 0.4, 1.0, 0.1, 7.0, 0.0, 0.3):
        clock[0] += step
        got = [b.try_take() for b in buckets]
        assert got[0] == got[1]
        assert buckets[0].available() == buckets[1].available()
    for m in (jr, tr):
        with pytest.raises(ValueError):
            m.TokenBucket(rate=-1.0, burst=1.0)
    frozen = tr.TokenBucket(rate=0.0, burst=1.0, clock=lambda: clock[0])
    assert frozen.try_take() and not frozen.try_take()


@pytest.mark.parametrize("spec", ["gold:10:50:100:250,free:1:2:4", "",
                                  " a:1:0:2 , b:2:3:4: ", "x:0:1:1:9.5"])
def test_parse_qos_classes_equals_the_reference(spec):
    want, got = jr.parse_qos_classes(spec), tr.parse_qos_classes(spec)
    assert sorted(got) == sorted(want)
    for name, c in want.items():
        g = got[name]
        assert (g.name, g.priority, g.rate, g.burst, g.ttft_slo_ms) == (
            c.name, c.priority, c.rate, c.burst, c.ttft_slo_ms)


@pytest.mark.parametrize("spec", ["gold:10:50", "a:b:1:1", "g:1:x:1"])
def test_parse_qos_classes_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError):
        jr.parse_qos_classes(spec)
    with pytest.raises(ValueError):
        tr.parse_qos_classes(spec)


def test_tenant_admission_equals_the_reference():
    """One request sequence (tenants, classes, an unknown class, a class
    reconfigured in place, past the LRU cap) admits and sheds alike."""
    clock = [0.0]
    spec = "gold:10:1:2,free:1:0:1"
    adms = [m.TenantAdmission(m.parse_qos_classes(spec),
                              clock=lambda: clock[0], max_tenants=4)
            for m in (jr, tr)]
    seq = [("a", "gold"), ("a", "gold"), ("a", "gold"), ("b", "free"),
           ("b", "free"), ("a", "free"), ("c", None), ("d", "nope"),
           ("e", "gold"), ("f", "gold"), ("a", "gold")]
    for i, (tenant, qos) in enumerate(seq):
        clock[0] += 0.3 * (i % 3)
        if i == 7:
            for adm, m in zip(adms, (jr, tr)):
                adm.classes["gold"] = m.QoSClass("gold", priority=10,
                                                 rate=0.0, burst=5.0)
        res = [adm.admit(tenant, qos) for adm in adms]
        assert res[0][0] == res[1][0], (i, tenant, qos)
        assert res[0][1].name == res[1][1].name
    assert adms[1].counters() == adms[0].counters()
    assert (adms[1].admitted_total, adms[1].shed_total) == (
        adms[0].admitted_total, adms[0].shed_total)
    with pytest.raises(ValueError):
        tr.TenantAdmission(max_tenants=0)


GAUGES = [
    {},
    {"queue_depth": 3, "queue_capacity": 10},
    {"queue_depth": 3, "queue_capacity": 10, "shed": 1},
    {"pages_total": 64, "pages_free": 16},
    {"pages_total": 64},
    {"kv_tier_host_capacity": 8, "kv_tier_host_pages": 8},
    {"ttft_p95_ms": 300.0, "queue_capacity": 0},
    {"queue_depth": 1, "queue_capacity": 4, "pages_total": 10,
     "pages_free": 9, "ttft_p95_ms": 100.0},
]


@pytest.mark.parametrize("slo", [None, 250.0])
def test_backpressure_equals_the_reference(slo):
    for g in GAUGES:
        assert tel.backpressure(g, slo) == jel.backpressure(g, slo), g


def test_replica_set_equals_the_reference():
    """Down marks, the recheck probe and least-loaded placement."""
    state = {"ok": False}
    gauges = {"http://a": {"queue_depth": 9, "queue_capacity": 10},
              "http://b": {"queue_depth": 1, "queue_capacity": 10}}
    sets = [m.ReplicaSet(["http://a/", "http://b"], health_recheck_s=0.0,
                         probe=lambda ep: (state["ok"] or ep == "http://b",
                                           gauges[ep])) for m in (jr, tr)]
    for rs in sets:
        rs.refresh()
    assert [rs.down() for rs in sets] == [["http://a"]] * 2
    state["ok"] = True
    for rs in sets:
        assert rs.ok("http://a")
    assert [rs.least_loaded() for rs in sets] == ["http://b"] * 2
    assert [rs.least_loaded(exclude=["http://b"]) for rs in sets] == \
        ["http://a"] * 2
    assert sets[1].pressure("http://a") == sets[0].pressure("http://a")
    for rs in sets:
        rs.remove("http://a")
    assert sets[1].endpoints() == sets[0].endpoints() == ["http://b"]


# ----------------------------------------------------- router over replicas


@pytest.fixture(scope="module")
def model():
    cfg = tl.LlamaConfig.tiny(n_layers=2, max_seq=64, dtype=torch.float32)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


class _Replica:
    """A tiny port ``PagedServer`` behind the port's front door."""

    def __init__(self, model):
        self.engine = ts.PagedServer(*model, slots=2, page_size=PS,
                                     prefill_chunk=PS, device="cpu")
        self.fe = ServingFrontend(self.engine, port=0, host="127.0.0.1",
                                  decode_window=4).start()
        self.url = f"http://127.0.0.1:{self.fe.port}"
        self.alive = True

    def stop(self):
        if self.alive:
            self.fe.stop()
            self.alive = False


def _fleet(model, n=3, **kw):
    reps = [_Replica(model) for _ in range(n)]
    router = tr.Router([r.url for r in reps], host="127.0.0.1",
                       page_size=PS, probe_interval_s=0.0,
                       health_recheck_s=60.0, **kw).start()
    return router, reps


def _close(router, reps):
    router.stop()
    for r in reps:
        r.stop()


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _post_stream(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, trailer = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            obj = json.loads(line)
            if "token" in obj:
                toks.append(obj["token"])
            if obj.get("done"):
                trailer = obj
    return toks, trailer


def _gen(router):
    return f"http://127.0.0.1:{router.port}/v1/generate"


def _head(router, prompt):
    return router.ring.preference(tr.route_key(prompt, PS))[0]


def test_replies_equal_a_direct_replica_call(model):
    """Routing, not rewriting: unary and streamed replies through the
    router equal a direct call to the replica that served them."""
    router, reps = _fleet(model)
    try:
        by_url = {r.url: r for r in reps}
        for seed, n in ((500, 12), (501, 21), (502, 5)):
            prompt = _prompt(seed, n)
            unary = _post(_gen(router), {"prompt": prompt, "max_new": 6})
            assert unary["routed"] == "affinity"
            assert unary["replica"] == _head(router, prompt)
            direct = _post(by_url[unary["replica"]].url + "/v1/generate",
                           {"prompt": prompt, "max_new": 6})
            assert unary["tokens"] == direct["tokens"]
            toks, trailer = _post_stream(_gen(router), {
                "prompt": prompt, "max_new": 6, "stream": True})
            assert toks == direct["tokens"]
            assert trailer["replica"] == unary["replica"]
        st = router.stats()
        assert st["affinity_hits"] == 6 and st["dropped_streams"] == 0
    finally:
        _close(router, reps)


def _tenant_traffic(tenants=6, turns=3):
    """Each tenant: a 24-token system prompt (3 pages) and ``turns`` turns
    of its own; requests in turn order."""
    out = []
    for t in range(turns):
        for i in range(tenants):
            out.append((i, _prompt(600 + i, 24) + _prompt(700 + 10 * i + t,
                                                          5 + t)))
    return out


def test_affinity_beats_random_on_radix_hits(model):
    """The same traffic through two fresh fleets: under affinity every
    request of one system prompt lands on one replica, and the fleet's
    radix prefix hits are strictly more than under random routing."""
    hits, landed = {}, {}
    for policy in ("affinity", "random"):
        router, reps = _fleet(model, policy=policy)
        try:
            landed[policy] = {}
            for tenant, prompt in _tenant_traffic():
                out = _post(_gen(router), {"prompt": prompt, "max_new": 2})
                assert out["routed"] == policy
                landed[policy].setdefault(tenant, set()).add(out["replica"])
            hits[policy] = sum(r.engine.page_stats()["prefix_hits"]
                               for r in reps)
            if policy == "random":
                assert router.stats()["affinity_hits"] == 0
        finally:
            _close(router, reps)
    assert all(len(s) == 1 for s in landed["affinity"].values())
    assert hits["affinity"] > hits["random"], hits


def test_spill_off_a_dead_replica(model):
    router, reps = _fleet(model)
    try:
        prompt = _prompt(510, 16)
        by_url = {r.url: r for r in reps}
        victim = by_url[_head(router, prompt)]
        survivor = next(r for r in reps if r is not victim)
        want = _post(survivor.url + "/v1/generate",
                     {"prompt": prompt, "max_new": 6})["tokens"]
        victim.stop()
        out = _post(_gen(router), {"prompt": prompt, "max_new": 6})
        assert out["tokens"] == want and out["replica"] != victim.url
        st = router.stats()
        assert st["spill_attempts"] >= 1 and st["dropped_streams"] == 0
        out2 = _post(_gen(router), {"prompt": prompt, "max_new": 6})
        assert out2["routed"] == "spill_down" and out2["tokens"] == want
    finally:
        _close(router, reps)


class _Busy:
    """A replica that answers 503 (queue full) to every generate."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                body = b'{"ok": true, "load": {}}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self.send_error(503)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def test_spill_off_a_busy_replica_keeps_it_in_rotation(model):
    busy, rep = _Busy(), _Replica(model)
    router = tr.Router([busy.url, rep.url], host="127.0.0.1", page_size=PS,
                       probe_interval_s=0.0).start()
    try:
        prompt = next(p for p in (_prompt(520 + i, 16) for i in range(200))
                      if _head(router, p) == busy.url)
        out = _post(_gen(router), {"prompt": prompt, "max_new": 4})
        assert out["replica"] == rep.url
        assert out["tokens"] == _post(rep.url + "/v1/generate", {
            "prompt": prompt, "max_new": 4})["tokens"]
        st = router.stats()
        assert st["spill_attempts"] == 1 and st["replicas_down"] == []
        assert st["dropped_streams"] == 0
    finally:
        router.stop()
        busy.stop()
        rep.stop()


def test_resize_under_load_drops_no_stream(model):
    """4 streaming requests in flight while ``POST /v1/replicas`` swaps
    one replica out and back in: every stream completes with the tokens
    of a direct call, and ``dropped_streams`` stays 0."""
    router, reps = _fleet(model)
    try:
        prompts = [_prompt(530 + i, 10 + 3 * i) for i in range(4)]
        want = [_post(reps[0].url + "/v1/generate",
                      {"prompt": p, "max_new": 24})["tokens"]
                for p in prompts]
        got, errors = [None] * 4, []

        def hit(i):
            try:
                got[i] = _post_stream(_gen(router), {
                    "prompt": prompts[i], "max_new": 24, "stream": True})[0]
            except Exception as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        urls = [r.url for r in reps]
        base = f"http://127.0.0.1:{router.port}/v1/replicas"
        out = _post(base, {"replicas": urls[1:]})
        assert out["removed"] == [urls[0]]
        out = _post(base, {"replicas": urls})
        assert out["added"] == [urls[0]]
        for t in threads:
            t.join(timeout=120)
        assert not errors and got == want
        st = router.stats()
        assert st["dropped_streams"] == 0 and st["rebalances"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"replicas": "nope"})
        assert e.value.code == 400
    finally:
        _close(router, reps)


def test_tenant_bucket_sheds_429(model):
    router, reps = _fleet(model, n=1,
                          classes=tr.parse_qos_classes("gold:10:0:2"))
    try:
        req = {"prompt": [1, 2, 3, 4, 5], "max_new": 2, "tenant": "alice",
               "qos": "gold"}
        assert _post(_gen(router), req)["qos"] == "gold"
        _post(_gen(router), req)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(_gen(router), req)
        assert e.value.code == 429 and e.value.headers["Retry-After"]
        assert router.stats()["sheds"] == 1
        assert _post(_gen(router), dict(req, tenant="bob"))["tokens"]
        for bad in ({"prompt": [], "max_new": 2},
                    {"prompt": "nope", "max_new": 2},
                    {"prompt": [1, 2], "max_new": 0}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(_gen(router), bad)
            assert e.value.code == 400
    finally:
        _close(router, reps)


# ------------------------------------------------- migrations and the views


def _redirect_cases(m):
    """The three router cases of ``tests/test_migrate.py`` on module
    ``m``: (plans, active redirects, redirect counts) along the way."""
    a, b, c = "http://a:1", "http://b:1", "http://c:1"
    seen = []
    r = m.Router([a, b, c], host="127.0.0.1", page_size=4)
    r.note_migration(a, b)
    r.note_migration(b, c)
    seen.append(r._apply_redirects([a, b, c]))
    seen.append(r.stats()["migration_redirects_active"])
    seen.append(r.stats()["migration_redirects"])
    r.set_replicas([a, b])
    seen.append(r.stats()["migration_redirects_active"])
    r.stop()
    r = m.Router([a, b], host="127.0.0.1", page_size=4)
    r.note_migration(a, b)
    r.set_replicas([b])
    seen.append(r.stats()["migration_redirects_active"])
    r.set_replicas([a, b])
    seen.append(r.stats()["migration_redirects_active"])
    seen.append(r._apply_redirects([a, b]))
    r.stop()
    r = m.Router([a, b], host="127.0.0.1", page_size=4)
    r.note_migration(a, a)
    seen.append(r._apply_redirects([a, b]))
    r.note_migration(a, b)
    seen.append(r._apply_redirects([a, b]))
    r.note_migration(b, a)
    seen.append(r._apply_redirects([a, b]))
    r.stop()
    return seen


def test_migration_redirect_chains_equal_the_reference():
    got, want = _redirect_cases(tr), _redirect_cases(jr)
    assert got == want
    a, b, c = "http://a:1", "http://b:1", "http://c:1"
    assert got[0] == [c] and got[1] == {a: c, b: c} and got[2] == 2
    assert got[3] == {} and got[4] == {a: b} and got[5] == {}
    assert got[6] == [a, b] and got[7] == [a, b] and got[8] == [b]


def test_drain_redirects_the_router(model):
    """``MigrationManager(on_redirect=router.note_migration)``: after a
    drain, the router's plans send the victim's traffic to the survivor
    (the engines are driven here, so no front door runs over them)."""
    from dcos_commons_tpu_torch.models import migrate as tmig
    vic_url, sur_url = "http://victim:1", "http://survivor:1"
    router = tr.Router([vic_url, sur_url], host="127.0.0.1", page_size=PS)
    try:
        victim, survivor = (ts.PagedServer(*model, slots=2, page_size=PS,
                                           prefill_chunk=PS, device="cpu")
                            for _ in range(2))
        slot = victim.submit(_prompt(540, 13), 10, request_id="m")
        for _ in range(4):
            victim.step()
        mgr = tmig.MigrationManager(ring=router.ring, page_size=PS,
                                    on_redirect=router.note_migration)
        receipt = mgr.drain(victim, vic_url, [(sur_url, survivor)])
        assert receipt["migrated"] == 1 and victim.requests[slot] is None
        assert router._apply_redirects([vic_url]) == [sur_url]
        assert router.stats()["migration_redirects_active"] == {
            vic_url: sur_url}
    finally:
        router.stop()


def test_routestats_and_views_have_the_reference_keys(model):
    kw = dict(host="127.0.0.1", page_size=PS, probe_interval_s=0.0,
              classes=None)
    want = jr.Router(["http://x:1"], **kw)
    got = tr.Router(["http://x:1"], **kw)
    try:
        assert sorted(got.stats()) == sorted(want.stats())
        assert got.stats() == want.stats()
        assert got.health() == want.health()
    finally:
        want.stop()
        got.stop()
    router, reps = _fleet(model, n=1)
    try:
        _post(_gen(router), {"prompt": [3, 1, 4], "max_new": 2})
        for path in ("/v1/routestats", "/v1/healthz", "/v1/metrics",
                     "/v1/traces"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{router.port}{path}", timeout=10) as r:
                body = json.loads(r.read())
            assert body
        assert sorted(router.stats()) == sorted(want.stats())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/v1/metrics/prometheus",
                timeout=10) as r:
            assert b"router_routed" in r.read()
    finally:
        _close(router, reps)
