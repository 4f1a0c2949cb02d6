"""Fleet front door: the prefix-affinity router tier across decode
replicas (port of ``dcos_commons_tpu/models/router.py``; the port imports
nothing of the JAX package). The router carries no model and does no
device work: every byte it moves is HTTP between a client and a decode
replica's ``ServingFrontend``.

* **Consistent-hash affinity** (:class:`HashRing`): requests hash on
  their prompt's radix prefix, the same full-page content hash the KV
  wire format and the radix key on (``paging.page_hashes``; see
  :func:`route_key`), so prompts sharing a system prompt land on the
  replica that already caches it, and a decode-tier resize moves only
  about K/N of the keyspace. Points, lookups and preference lists equal
  the reference's for the same nodes and virtual nodes.
* **Per-tenant QoS** (:class:`TenantAdmission`): token-bucket admission
  per tenant, with :class:`QoSClass` carrying the scheduler's integer
  ``priority:`` classes, a per-class TTFT SLO and a spill floor: classes
  at or above it may chase idle capacity when their affinity target runs
  hot; spill on DOWN applies to every class.
* **Streaming fan-in**: each replica's chunked token stream relays
  straight back to the client; a replica that dies mid-stream is
  survivable under greedy decode: the relay re-issues the request on the
  next candidate and skips the tokens the client already has
  (``spill_resumes``), after checking each replayed token against what
  was relayed (``resume_divergences``). An admitted stream is dropped
  only after every healthy candidate was attempted (``dropped_streams``).
* **Health/load-aware spill** (:class:`ReplicaSet`): a failing replica is
  marked down and re-probed after ``health_recheck_s`` through
  ``/v1/healthz``, whose ``"load"`` gauges collapse through
  ``scheduler.elastic.backpressure`` into the spill signal.

Elasticity: :meth:`Router.set_replicas` (``POST /v1/replicas``)
rebalances the ring; departing replicas leave it first while relays
already attached drain to completion. :meth:`Router.note_migration` is
the ``on_redirect`` hook of ``models.migrate.MigrationManager``: relays
follow a stream after it moves.

Transport: the reference wraps its server in TLS through
``security/transport.py`` when that module is importable; it is not
ported, so the router serves plain HTTP and reaches replicas through
``disagg._transport_urlopen`` (the reference's own fallback).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from bisect import bisect_right, insort
from collections import OrderedDict, deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..metrics import MetricsRegistry
from ..scheduler.elastic import backpressure
from ..tracing import (TRACE_HEADER, Span, TraceContext, Tracer, new_id,
                       parse_header, perf_to_epoch)
from .disagg import _transport_urlopen
from .paging import chain_keys, page_hashes


def route_key(prompt: Sequence[int], page_size: int,
              affinity_pages: int = 1) -> str:
    """The affinity key for a prompt: the chain of its first
    ``affinity_pages`` FULL-page prefix hashes (``paging.page_hashes``
    — the exact hashes the radix and the KV wire format agree on), so
    two prompts share a key iff they share the radix pages affinity is
    chasing. Prompts shorter than one page hash their raw tokens —
    still stable, nothing cached to chase."""
    hashes = page_hashes(prompt, page_size)[:max(1, affinity_pages)]
    if hashes:
        return "/".join(hashes)
    raw = ",".join(str(int(t)) for t in prompt).encode()
    return "p:" + hashlib.blake2s(raw).hexdigest()[:16]


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each replica owns ``vnodes`` points (blake2s of ``"name#i"``); a key
    maps to the first point clockwise. Adding or removing one replica
    moves only the keys in its arcs — the bounded-key-movement property
    ``tests/test_router.py`` pins — so a decode-tier resize does not
    reshuffle the whole fleet's prefix affinity."""

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: List[Tuple[int, str]] = []   # sorted (point, node)
        self._nodes: Dict[str, List[int]] = {}
        for n in nodes:
            self.add(n)

    @staticmethod
    def _point(node: str, i: int) -> int:
        digest = hashlib.blake2s(f"{node}#{i}".encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        pts = [self._point(node, i) for i in range(self.vnodes)]
        self._nodes[node] = pts
        for p in pts:
            insort(self._points, (p, node))

    def remove(self, node: str) -> None:
        pts = self._nodes.pop(node, None)
        if pts is None:
            return
        dead = set(pts)
        self._points = [(p, n) for p, n in self._points
                        if not (n == node and p in dead)]

    def lookup(self, key: str) -> Optional[str]:
        pref = self.preference(key, 1)
        return pref[0] if pref else None

    def preference(self, key: str, n: Optional[int] = None) -> List[str]:
        """Distinct replicas in clockwise order from the key's point —
        the failover order for spill, so a key's fallback target is as
        stable as its primary."""
        if not self._points:
            return []
        want = len(self._nodes) if n is None else min(n, len(self._nodes))
        kp = int.from_bytes(hashlib.blake2s(key.encode()).digest()[:8],
                            "big")
        start = bisect_right(self._points, (kp, chr(0x10FFFF)))
        out: List[str] = []
        for i in range(len(self._points)):
            node = self._points[(start + i) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) >= want:
                    break
        return out


class TokenBucket:
    """Token-bucket admission: ``burst`` capacity, ``rate`` tokens/s
    refill. ``rate=0`` freezes the bucket — the initial burst is all it
    ever admits; ``burst=0`` admits nothing. The clock is injectable so
    tests and the chaos soak replay deterministically."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        if rate < 0 or burst < 0:
            raise ValueError(f"rate/burst must be >= 0, got "
                             f"{rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def available(self) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            return self._tokens


@dataclass(frozen=True)
class QoSClass:
    """One tenant QoS class. ``priority`` uses the scheduler's
    ``priority:`` integers (``specification``/``dist/fleet.yml``) so
    tenant classes and pod tiers rank on one scale; ``rate``/``burst``
    parameterize each tenant's admission bucket; ``ttft_slo_ms`` is the
    per-class conformance bar the bench receipts report against."""

    name: str
    priority: int = 0
    rate: float = float("inf")
    burst: float = float("inf")
    ttft_slo_ms: Optional[float] = None


DEFAULT_CLASS = QoSClass("default")


def parse_qos_classes(spec: str) -> Dict[str, QoSClass]:
    """Parse the ``TENANT_CLASSES`` knob:
    ``name:priority:rate:burst[:ttft_slo_ms]`` entries, comma-separated
    — e.g. ``gold:10:50:100:250,free:1:2:4``. Empty spec → no classes
    (every tenant admits unlimited under :data:`DEFAULT_CLASS`)."""
    out: Dict[str, QoSClass] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (4, 5):
            raise ValueError(
                f"bad TENANT_CLASSES entry {entry!r}: want "
                "name:priority:rate:burst[:ttft_slo_ms]")
        name = parts[0]
        slo = float(parts[4]) if len(parts) == 5 and parts[4] else None
        out[name] = QoSClass(name, priority=int(parts[1]),
                             rate=float(parts[2]), burst=float(parts[3]),
                             ttft_slo_ms=slo)
    return out


DEFAULT_MAX_TENANTS = 4096


class TenantAdmission:
    """Per-tenant token buckets over the configured QoS classes.

    A request names its tenant and (optionally) its class; unknown
    classes fall back to ``default`` when configured, else to the
    unlimited :data:`DEFAULT_CLASS`. Buckets key on ``(tenant, class)``:
    each TENANT gets its own bucket per class (two gold tenants cannot
    eat each other's budget — the isolation the ``tenant_flood`` chaos
    invariant leans on), and naming a DIFFERENT class on the next
    request never resets an existing bucket — ``qos`` is client-
    supplied, so a tenant alternating gold/free holds at most the sum
    of both budgets instead of minting a fresh burst per request. If a
    class is reconfigured in place, the old balance carries over
    (capped at the new burst); a config change is never a refill.

    All per-tenant state (buckets, admitted/shed counters) is LRU-
    capped at ``max_tenants`` entries, so an unauthenticated client
    spraying unique ``X-Tenant`` values cannot grow router memory
    without bound. An idle tenant evicted by the cap restarts from a
    fresh burst if it returns — the price of bounding state — while
    ``admitted_total``/``shed_total`` keep exact fleet-wide tallies."""

    def __init__(self, classes: Optional[Dict[str, QoSClass]] = None,
                 clock=time.monotonic,
                 max_tenants: int = DEFAULT_MAX_TENANTS):
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, "
                             f"got {max_tenants}")
        self.classes = dict(classes or {})
        self._clock = clock
        self.max_tenants = int(max_tenants)
        self._buckets: "OrderedDict[Tuple[str, str], TokenBucket]" = (
            OrderedDict())
        self._lock = threading.Lock()
        self.admitted: "OrderedDict[str, int]" = OrderedDict()
        self.shed: "OrderedDict[str, int]" = OrderedDict()
        self.admitted_total = 0
        self.shed_total = 0

    def qos(self, qos_name: Optional[str]) -> QoSClass:
        if qos_name and qos_name in self.classes:
            return self.classes[qos_name]
        return self.classes.get("default", DEFAULT_CLASS)

    def _bump(self, counters: "OrderedDict[str, int]",
              tenant: str) -> None:
        counters[tenant] = counters.get(tenant, 0) + 1
        counters.move_to_end(tenant)
        while len(counters) > self.max_tenants:
            counters.popitem(last=False)

    def admit(self, tenant: str, qos_name: Optional[str] = None
              ) -> Tuple[bool, QoSClass]:
        cls = self.qos(qos_name)
        key = (tenant, cls.name)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = TokenBucket(
                    cls.rate, cls.burst, clock=self._clock)
            elif (bucket.rate, bucket.burst) != (cls.rate, cls.burst):
                fresh = TokenBucket(cls.rate, cls.burst,
                                    clock=self._clock)
                fresh._tokens = min(bucket.available(), fresh.burst)
                bucket = self._buckets[key] = fresh
            self._buckets.move_to_end(key)
            while len(self._buckets) > self.max_tenants:
                self._buckets.popitem(last=False)
        if bucket.burst == float("inf") or bucket.try_take():
            with self._lock:
                self._bump(self.admitted, tenant)
                self.admitted_total += 1
            return True, cls
        with self._lock:
            self._bump(self.shed, tenant)
            self.shed_total += 1
        return False, cls

    def counters(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Consistent (admitted, shed) snapshot — handler threads bump
        the live OrderedDicts under ``_lock``, so a scrape iterating
        them bare can see a mid-``popitem`` resize."""
        with self._lock:
            return dict(self.admitted), dict(self.shed)


class ReplicaError(RuntimeError):
    """A replica that could not serve the relayed request — transport
    failure, truncated stream, or engine error. Marks the replica down
    and moves the relay to the next candidate."""


class ReplicaBusy(ReplicaError):
    """A replica 503 (queue full): back-pressure, not death — the relay
    tries the next candidate WITHOUT taking the replica out of
    rotation."""


class ReplicaSet:
    """Health- and load-tracked view of the decode endpoints —
    ``DisaggCoordinator``'s health-gated peer rotation generalized into
    a reusable piece: a failed replica is marked down and stays out of
    rotation until ``health_recheck_s`` elapses AND its ``/v1/healthz``
    answers ok again; each probe also caches the response's ``"load"``
    gauges, collapsed via ``scheduler/elastic.backpressure()`` into the
    spill signal."""

    def __init__(self, endpoints: Iterable[str] = (),
                 health_recheck_s: float = 5.0,
                 probe_timeout_s: float = 5.0, probe=None):
        self._lock = threading.Lock()
        self._endpoints: List[str] = []
        self._down: Dict[str, float] = {}      # endpoint -> monotonic mark
        self._gauges: Dict[str, dict] = {}
        self.health_recheck_s = health_recheck_s
        self.probe_timeout_s = probe_timeout_s
        self._probe = probe if probe is not None else self._http_probe
        for ep in endpoints:
            self.add(ep)

    # ------------------------------------------------------------ members

    def endpoints(self) -> List[str]:
        with self._lock:
            return list(self._endpoints)

    def add(self, endpoint: str) -> None:
        endpoint = endpoint.rstrip("/")
        with self._lock:
            if endpoint not in self._endpoints:
                self._endpoints.append(endpoint)

    def remove(self, endpoint: str) -> None:
        endpoint = endpoint.rstrip("/")
        with self._lock:
            if endpoint in self._endpoints:
                self._endpoints.remove(endpoint)
            self._down.pop(endpoint, None)
            self._gauges.pop(endpoint, None)

    # ------------------------------------------------------------- health

    def _http_probe(self, endpoint: str) -> Tuple[bool, Optional[dict]]:
        try:
            req = urllib.request.Request(endpoint + "/v1/healthz")
            with _transport_urlopen(req, timeout=self.probe_timeout_s) as r:
                body = json.loads(r.read())
            return bool(body.get("ok")), body.get("load")
        except Exception:
            return False, None

    def mark_down(self, endpoint: str) -> None:
        with self._lock:
            self._down[endpoint.rstrip("/")] = time.monotonic()

    def note_gauges(self, endpoint: str, gauges: Optional[dict]) -> None:
        if gauges is not None:
            with self._lock:
                self._gauges[endpoint.rstrip("/")] = gauges

    def gauges(self, endpoint: str) -> dict:
        with self._lock:
            return dict(self._gauges.get(endpoint.rstrip("/"), {}))

    def pressure(self, endpoint: str,
                 ttft_slo_ms: Optional[float] = None) -> float:
        return backpressure(self.gauges(endpoint), ttft_slo_ms)

    def ok(self, endpoint: str) -> bool:
        """True when the endpoint is in rotation. A down endpoint stays
        out until the recheck window elapses AND a fresh probe (done
        here, outside the lock) answers ok."""
        endpoint = endpoint.rstrip("/")
        with self._lock:
            if endpoint not in self._endpoints:
                return False
            marked = self._down.get(endpoint)
            if marked is None:
                return True
            if time.monotonic() - marked < self.health_recheck_s:
                return False
        up, gauges = self._probe(endpoint)
        if up:
            with self._lock:
                self._down.pop(endpoint, None)
            self.note_gauges(endpoint, gauges)
            return True
        self.mark_down(endpoint)
        return False

    def healthy(self) -> List[str]:
        return [ep for ep in self.endpoints() if self.ok(ep)]

    def down(self) -> List[str]:
        with self._lock:
            return sorted(ep for ep in self._down
                          if ep in self._endpoints)

    def refresh(self) -> None:
        """Probe every endpoint once: refresh cached gauges, clear or
        set down marks. The router's probe thread calls this on its
        interval; tests call it directly."""
        for ep in self.endpoints():
            up, gauges = self._probe(ep)
            if up:
                with self._lock:
                    self._down.pop(ep, None)
                self.note_gauges(ep, gauges)
            else:
                self.mark_down(ep)

    def least_loaded(self, exclude: Iterable[str] = ()) -> Optional[str]:
        skip = {e.rstrip("/") for e in exclude}
        best, best_p = None, None
        for ep in self.endpoints():
            if ep in skip or not self.ok(ep):
                continue
            p = self.pressure(ep)
            if best_p is None or p < best_p:
                best, best_p = ep, p
        return best


class Router:
    """The fleet front door: one HTTP pod routing ``/v1/generate``
    across N decode replicas.

    * ``POST /v1/generate`` — the ingress request shape plus optional
      ``"tenant"`` / ``"qos"`` fields (headers ``X-Tenant`` /
      ``X-QoS-Class`` also honored). 429 when the tenant's bucket is
      dry; otherwise the request routes by prefix affinity (or
      uniformly under ``policy="random"`` — the A/B control arm) and
      the replica's token stream relays back, chunked or unary, with
      ``"replica"`` and ``"routed"`` stamped into the trailer.
    * ``GET /v1/healthz`` — router liveness + per-replica health.
    * ``GET /v1/routestats`` — the ``tpuctl route-stats`` surface.
    * ``POST /v1/replicas`` ``{"replicas": [...]}`` — the resize hook
      (the worker main and the smoke drive :meth:`set_replicas`
      through it).
    """

    def __init__(self, replicas: Iterable[str] = (), port: int = 0,
                 host: str = "0.0.0.0", page_size: int = 64,
                 affinity_pages: int = 1, vnodes: int = 64,
                 classes: Optional[Dict[str, QoSClass]] = None,
                 max_tenants: int = DEFAULT_MAX_TENANTS,
                 policy: str = "affinity",
                 spill_pressure: float = 0.85,
                 spill_floor: int = 0,
                 health_recheck_s: float = 5.0,
                 probe_interval_s: float = 2.0,
                 request_timeout_s: float = 600.0,
                 seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 trace_store=None,
                 directory=None):
        if policy not in ("affinity", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.affinity_pages = max(1, affinity_pages)
        self.policy = policy
        self.spill_pressure = spill_pressure
        self.spill_floor = spill_floor
        self.request_timeout_s = request_timeout_s
        self.probe_interval_s = probe_interval_s
        # optional fleet prefix directory (paging.PrefixDirectory):
        # replicas publish which radix chains they hold, and route_plan
        # consults it when the affinity primary is unavailable so the
        # stream lands where the prefix is already resident (or
        # adoptable) instead of on an arbitrary least-loaded spill.
        self.directory = directory
        self.ring = HashRing(
            (e.rstrip("/") for e in replicas), vnodes=vnodes)
        self.replicas = ReplicaSet(replicas,
                                   health_recheck_s=health_recheck_s)
        self.admission = TenantAdmission(classes,
                                         max_tenants=max_tenants)
        import random as _random
        self._rng = _random.Random(seed)
        self._lock = threading.Lock()
        self._resize_lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "routed": 0, "affinity_hits": 0, "spills_hot": 0,
            "spills_down": 0, "spill_attempts": 0, "spill_resumes": 0,
            "resume_divergences": 0, "dropped_streams": 0, "sheds": 0,
            "rebalances": 0, "errors": 0, "migration_redirects": 0,
            "directory_hits": 0}
        # live-migration forwarding: victim endpoint -> destination the
        # MigrationManager drained its streams to. Applied to every
        # route plan so relays (and resume-exact failover replays)
        # follow the stream instead of re-prefilling on a doomed or
        # departed replica.
        self._redirects: Dict[str, str] = {}
        self._per_replica: Dict[str, int] = {}
        self._active: Dict[str, int] = {}      # replica -> live relays
        self._ttfts: deque = deque(maxlen=4096)  # (t, tenant, ttft_ms)
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._own_metrics = metrics is None
        self.tracer = Tracer("router", trace_store)
        # routestats folded into the shared registry: counters mirror
        # _counts via _count(); these gauges sample live fleet state
        self.metrics.gauge("router.replicas",
                           lambda: len(self.replicas.endpoints()))
        self.metrics.gauge("router.replicas_down",
                           lambda: len(self.replicas.down()))

        def _relays() -> int:
            with self._lock:
                return sum(n for n in self._active.values() if n > 0)

        self.metrics.gauge("router.active_relays", _relays)
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, code: int, payload: dict,
                      extra_headers: Optional[dict] = None) -> None:
                body = (json.dumps(payload) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/healthz":
                    self._json(200, router.health())
                elif self.path in ("/v1/routestats", "/v1/stats"):
                    self._json(200, router.stats())
                elif self.path == "/v1/metrics":
                    self._json(200, router.metrics.to_dict())
                elif self.path == "/v1/metrics/prometheus":
                    body = router.metrics.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/v1/traces":
                    store = router.tracer.store
                    self._json(200, {
                        "trace_ids": store.trace_ids(),
                        "incomplete": store.incomplete_trace_ids()})
                elif self.path.startswith("/v1/trace/"):
                    tid = self.path[len("/v1/trace/"):]
                    self._json(200, router.trace_export(tid))
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                if self.path == "/v1/replicas":
                    eps = req.get("replicas")
                    if (not isinstance(eps, list)
                            or not all(isinstance(e, str) for e in eps)):
                        self._json(400, {"error": "replicas must be a "
                                                  "list of endpoint URLs"})
                        return
                    self._json(200, router.set_replicas(eps))
                    return
                if self.path != "/v1/generate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    prompt = req.get("prompt")
                    max_new = int(req.get("max_new", 32))
                    if (not isinstance(prompt, list) or not prompt
                            or not all(isinstance(t, int) for t in prompt)):
                        raise ValueError("prompt must be a non-empty "
                                         "list of ints")
                    if max_new < 1:
                        raise ValueError("max_new must be >= 1")
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                tenant = (req.get("tenant")
                          or self.headers.get("X-Tenant") or "anonymous")
                qos = (req.get("qos")
                       or self.headers.get("X-QoS-Class") or None)
                stream = bool(req.get("stream", False))
                ctx = parse_header(self.headers.get(TRACE_HEADER))
                router._serve(self, prompt, max_new, stream,
                              str(tenant), qos, ctx)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- routing

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
        # mirrored into the registry so /v1/metrics/prometheus exposes
        # routestats without a second bookkeeping path
        self.metrics.counter(f"router.{key}", n)

    def route_plan(self, prompt: Sequence[int],
                   cls: QoSClass) -> Tuple[List[str], str]:
        """The ordered candidate list for one request and how its head
        was chosen (``affinity`` | ``spill_hot`` | ``spill_down`` |
        ``directory`` | ``random`` | ``none``). The tail is the
        mid-stream failover
        order: the rest of the ring's preference walk (stable per key),
        healthy-first."""
        if self.policy == "random":
            healthy = self.replicas.healthy()
            if not healthy:
                return [], "none"
            with self._lock:
                # Random instances are not thread-safe: an unguarded
                # shuffle from concurrent handler threads corrupts the
                # control arm's distribution and seed-determinism
                self._rng.shuffle(healthy)
            return healthy, "random"
        key = route_key(prompt, self.page_size, self.affinity_pages)
        pref = self.ring.preference(key)
        if not pref:
            return [], "none"
        primary = pref[0]
        rest = [ep for ep in pref[1:] if self.replicas.ok(ep)]
        if self.replicas.ok(primary):
            hot = (self.replicas.pressure(
                primary, cls.ttft_slo_ms) >= self.spill_pressure)
            if hot and cls.priority >= self.spill_floor and rest:
                spill = self.replicas.least_loaded(exclude=(primary,))
                if spill is not None:
                    order = [spill] + [ep for ep in [primary] + rest
                                       if ep != spill]
                    return order, "spill_hot"
            return [primary] + rest, "affinity"
        if rest:
            holder = self._directory_hint(prompt)
            if holder is not None and holder in rest:
                self._count("directory_hits")
                order = [holder] + [ep for ep in rest if ep != holder]
                return order, "directory"
            spill = self.replicas.least_loaded(exclude=(primary,))
            if spill is not None and spill in rest:
                rest = [spill] + [ep for ep in rest if ep != spill]
            return rest, "spill_down"
        return [], "none"

    def _directory_hint(self, prompt: Sequence[int]) -> Optional[str]:
        """Deepest fresh :class:`paging.PrefixDirectory` holder for this
        prompt's chain, or ``None``. Only consulted when the affinity
        primary is down: landing the stream where the prefix is already
        resident beats least-loaded spill, because the spill target
        would recompute the whole prefix from scratch."""
        if self.directory is None:
            return None
        try:
            chains = chain_keys(list(prompt), self.page_size)
        except Exception:
            return None
        for ck in reversed(chains):
            holder = self.directory.lookup(ck)
            if holder is not None:
                return holder.rstrip("/")
        return None

    # ------------------------------------------------------------- relay

    def _upstream(self, target: str, prompt: List[int], max_new: int,
                  trace: Optional[TraceContext] = None):
        """Generator over one replica's chunked token stream: yields
        the parsed JSON objects, raising :class:`ReplicaError` (or
        :class:`ReplicaBusy` on 503 back-pressure) instead of ever
        yielding a broken tail. When the relay carries a trace, its
        context crosses the hop in ``X-Tpu-Trace`` so the replica's
        spans parent onto the router's."""
        body = json.dumps({"prompt": prompt, "max_new": max_new,
                           "stream": True}).encode()
        headers = {"Content-Type": "application/json"}
        if trace is not None:
            headers[TRACE_HEADER] = trace.header()
        req = urllib.request.Request(
            target + "/v1/generate", data=body, headers=headers)
        try:
            resp = _transport_urlopen(req, timeout=self.request_timeout_s)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                raise ReplicaBusy(f"{target}: queue full") from None
            raise ReplicaError(f"{target}: HTTP {e.code}") from None
        except Exception as e:
            raise ReplicaError(f"{target}: {e}") from None
        with resp:
            while True:
                try:
                    line = resp.readline()
                except Exception as e:
                    raise ReplicaError(f"{target}: {e}") from None
                if not line:
                    raise ReplicaError(f"{target}: stream truncated")
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue                   # keep-alive noise
                yield obj
                if obj.get("done"):
                    return

    def _finish_trace(self, root: TraceContext,
                      parent: Optional[TraceContext], t0: float,
                      status: str, **attrs) -> None:
        """Record the terminal ``router.request`` root span — every
        admitted request's trace ends through here exactly once, the
        completeness guarantee the chaos tier audits."""
        t1 = time.perf_counter()
        self.tracer.store.add(Span(
            root.trace_id, root.span_id,
            parent.span_id if parent else None,
            "router.request", self.tracer.service,
            perf_to_epoch(t0), max(0.0, t1 - t0), attrs,
            terminal=True, status=status))

    def _serve(self, handler, prompt: List[int], max_new: int,
               stream: bool, tenant: str, qos: Optional[str],
               ctx: Optional[TraceContext] = None) -> None:
        t0 = time.perf_counter()
        ok, cls = self.admission.admit(tenant, qos)
        if not ok:
            self._count("sheds")
            # a shed is a complete (one-span) trace: admitted requests
            # are the ones whose traces must reach router.request
            self.tracer.record("router.admission", t0,
                               time.perf_counter(), parent=ctx,
                               terminal=True, status="shed",
                               tenant=tenant, qos=cls.name)
            handler._json(429, {"error": f"tenant {tenant!r} over its "
                                         f"{cls.name} admission budget"},
                          {"Retry-After": "1"})
            return
        # the root context downstream hops parent onto; the root span
        # itself is recorded at the end via _finish_trace
        root = TraceContext(ctx.trace_id if ctx else new_id(), new_id())
        self.tracer.record("router.admission", t0, time.perf_counter(),
                           parent=root, tenant=tenant, qos=cls.name)
        plan, routed = self.route_plan(prompt, cls)
        plan = self._apply_redirects(plan)
        if not plan:
            self._count("errors")
            self._finish_trace(root, ctx, t0, "error", tenant=tenant,
                               error="no healthy decode replica")
            handler._json(503, {"error": "no healthy decode replica"},
                          {"Retry-After": "1"})
            return
        self._count("routed")
        if routed == "affinity":
            self._count("affinity_hits")
        elif routed == "spill_hot":
            self._count("spills_hot")
        elif routed == "spill_down":
            self._count("spills_down")

        chunk = None
        if stream:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()

            def chunk(obj: dict) -> None:
                data = (json.dumps(obj) + "\n").encode()
                handler.wfile.write(f"{len(data):x}\r\n".encode()
                                    + data + b"\r\n")

        sent: List[int] = []
        t_first: Optional[float] = None
        final: Optional[dict] = None
        last_err = "no candidates"
        for attempt, target in enumerate(plan):
            if attempt > 0:
                # failover: deterministic greedy decode replays the
                # same tokens on the next replica; skip what the
                # client already has
                self._count("spill_attempts")
            with self._lock:
                self._active[target] = self._active.get(target, 0) + 1
            seen = 0
            t_attempt = time.perf_counter()
            relay_status = "ok"
            try:
                for obj in self._upstream(target, prompt, max_new,
                                          trace=root):
                    if "token" in obj:
                        seen += 1
                        tok = int(obj["token"])
                        if seen <= len(sent):
                            if tok != sent[seen - 1]:
                                # the replacement replica disagrees on
                                # the replayed prefix (mixed model or
                                # config versions mid-rolling-deploy):
                                # splicing the two completions would
                                # hand the client a corrupt stream
                                self._count("resume_divergences")
                                raise ReplicaError(
                                    f"{target}: resume divergence at "
                                    f"token {seen - 1} ({tok} != "
                                    f"{sent[seen - 1]})")
                            continue           # resume skip, verified
                        if t_first is None:
                            t_first = time.perf_counter()
                        sent.append(tok)
                        if chunk is not None:
                            chunk({"token": tok})
                    elif obj.get("done"):
                        if obj.get("error"):
                            raise ReplicaError(
                                f"{target}: {obj['error']}")
                        final = obj
                if attempt > 0 and final is not None:
                    self._count("spill_resumes")
                break
            except ReplicaBusy as e:
                last_err = str(e)              # back-pressure: next
                relay_status = "busy"
            except ReplicaError as e:
                last_err = str(e)
                relay_status = "error"
                self.replicas.mark_down(target)
            finally:
                with self._lock:
                    self._active[target] = max(
                        0, self._active.get(target, 1) - 1)
                    if final is not None:
                        self._per_replica[target] = (
                            self._per_replica.get(target, 0) + 1)
                self.tracer.record("router.relay", t_attempt,
                                   time.perf_counter(), parent=root,
                                   status=relay_status, target=target,
                                   attempt=attempt, tokens=seen)
            if final is not None:
                break
        if final is None:
            # every candidate was attempted before giving up — the
            # spill-before-drop invariant the chaos tier audits
            self._count("dropped_streams")
            self._finish_trace(root, ctx, t0, "error", tenant=tenant,
                               routed=routed, error=last_err)
            err = {"error": f"all replicas failed: {last_err}"}
            if chunk is not None:
                chunk({"done": True, **err})
                handler.wfile.write(b"0\r\n\r\n")
            else:
                handler._json(502, err)
            return
        ttft_ms = (round((t_first - t0) * 1e3, 3)
                   if t_first is not None else None)
        with self._lock:
            self._ttfts.append((time.monotonic(), tenant, ttft_ms))
        if t_first is not None:
            self.metrics.observe("router.ttft_seconds", t_first - t0)
        self.metrics.observe("router.request_seconds",
                             time.perf_counter() - t0)
        self._finish_trace(root, ctx, t0, "ok", tenant=tenant,
                           routed=routed, replica=target,
                           tokens=len(sent), ttft_ms=ttft_ms)
        trailer = {k: v for k, v in final.items() if k != "done"}
        trailer.update({"replica": target, "routed": routed,
                        "tenant": tenant, "qos": cls.name})
        if ttft_ms is not None:
            trailer["router_ttft_ms"] = ttft_ms
        if chunk is not None:
            chunk({"done": True, **trailer})
            handler.wfile.write(b"0\r\n\r\n")
        else:
            # "tokens" last: a replica trailer field must never clobber
            # the relayed token list
            handler._json(200, {**trailer, "tokens": sent})

    # ----------------------------------------------------------- elasticity

    def note_migration(self, src: str, dst: str) -> None:
        """Record a "migrated-to" redirect: streams drained off ``src``
        now live on ``dst``, so any plan that would try ``src`` tries
        ``dst`` there instead. Existing redirects pointing AT ``src``
        re-target ``dst`` (two scale events in a row must not leave a
        chain through a dead middle hop)."""
        src, dst = src.rstrip("/"), dst.rstrip("/")
        if src == dst:
            return
        with self._lock:
            for k, v in list(self._redirects.items()):
                if v == src:
                    self._redirects[k] = dst
            self._redirects.pop(dst, None)      # dst is live again
            self._redirects[src] = dst
        self._count("migration_redirects")

    def _apply_redirects(self, plan: List[str]) -> List[str]:
        """Map a route plan through the migration redirects (chains
        followed with a visited guard, order-preserving dedupe). Cheap
        no-op on the common path — no redirects, no work."""
        with self._lock:
            if not self._redirects:
                return plan
            redirects = dict(self._redirects)
        out: List[str] = []
        for ep in plan:
            seen = {ep}
            while ep in redirects and redirects[ep] not in seen:
                ep = redirects[ep]
                seen.add(ep)
            if ep not in out:
                out.append(ep)
        return out

    def set_replicas(self, endpoints: Sequence[str]) -> dict:
        """Rebalance the ring to a resized decode tier. Departing
        replicas leave the ring and the replica set immediately — no
        NEW streams route to them — while relays already attached keep
        their connections and drain to completion (``draining`` counts
        them). Arriving replicas take over only their arcs of the
        keyspace (bounded movement). The resized ring is built aside
        and swapped in as one reference assignment — ``HashRing`` makes
        no thread-safety promise, so concurrent ``route_plan`` calls
        must see the old ring or the new one, never a half-mutated
        point list."""
        with self._resize_lock:
            want = [e.rstrip("/") for e in endpoints]
            have = set(self.ring.nodes())
            added = [e for e in want if e not in have]
            removed = [e for e in have if e not in want]
            for ep in added:
                self.replicas.add(ep)
            self.ring = HashRing(want, vnodes=self.ring.vnodes)
            for ep in removed:
                self.replicas.remove(ep)
            if added or removed:
                self._count("rebalances")
            with self._lock:
                # migration redirects die with the fleet change that
                # obsoletes them: a destination that departed can't
                # receive forwards, and a victim that REJOINED is a
                # fresh replica that should take traffic directly
                for ep in list(self._redirects):
                    if (self._redirects[ep] not in want
                            or ep in added):
                        del self._redirects[ep]
                draining = {ep: n for ep, n in self._active.items()
                            if ep in removed and n > 0}
            return {"replicas": self.ring.nodes(),
                    "added": sorted(added), "removed": sorted(removed),
                    "draining": draining}

    # ------------------------------------------------------------- tracing

    def trace_export(self, trace_id: str) -> dict:
        """One trace, fleet-wide: the router's local spans merged with
        whatever each healthy replica retained for the same id (served
        over its own ``/v1/trace`` endpoint), de-duplicated by span_id
        — colocated tiers sharing the process-global store would
        otherwise report every span twice."""
        spans = {s.span_id: s.to_dict()
                 for s in self.tracer.store.spans(trace_id)}
        for ep in self.replicas.healthy():
            try:
                req = urllib.request.Request(f"{ep}/v1/trace/{trace_id}")
                with _transport_urlopen(req, timeout=5.0) as r:
                    body = json.loads(r.read())
            except Exception:
                continue
            for d in body.get("spans", ()):
                sid = d.get("span_id")
                if sid:
                    spans.setdefault(sid, d)
        ordered = sorted(spans.values(),
                         key=lambda d: (d.get("t_start", 0.0),
                                        d.get("span_id", "")))
        return {"trace_id": trace_id, "spans": ordered,
                "complete": any(d.get("terminal") for d in ordered)}

    # ------------------------------------------------------------- status

    def health(self) -> dict:
        eps = self.replicas.endpoints()
        down = self.replicas.down()
        return {"ok": True, "role": "router", "policy": self.policy,
                "replicas": eps, "replicas_down": down,
                "replicas_healthy": len(eps) - len(down)}

    def stats(self) -> dict:
        from ..utils.stats import percentiles
        with self._lock:
            counts = dict(self._counts)
            redirects = dict(self._redirects)
            per_replica = dict(self._per_replica)
            active = {ep: n for ep, n in self._active.items() if n > 0}
            ttfts = [t for _, _, t in self._ttfts if t is not None]
            per_tenant_ttft: Dict[str, List[float]] = {}
            for _, tenant, t in self._ttfts:
                if t is not None:
                    per_tenant_ttft.setdefault(tenant, []).append(t)
        routed = max(1, counts["routed"])
        tenants = {}
        admitted, shed = self.admission.counters()
        seen = set(admitted) | set(shed)
        for tenant in sorted(seen):
            tenants[tenant] = {
                "admitted": admitted.get(tenant, 0),
                "shed": shed.get(tenant, 0),
                "ttft_ms": percentiles(per_tenant_ttft.get(tenant, [])),
            }
        return {
            "policy": self.policy,
            "page_size": self.page_size,
            "affinity_pages": self.affinity_pages,
            "replicas": self.replicas.endpoints(),
            "replicas_down": self.replicas.down(),
            "ring_nodes": len(self.ring),
            **counts,
            "migration_redirects_active": redirects,
            "affinity_rate": round(counts["affinity_hits"] / routed, 4),
            "per_replica": per_replica,
            "active_relays": active,
            "ttft_ms": percentiles(ttfts),
            "tenants": tenants,
            "tenants_tracked": len(seen),
            "admitted_total": self.admission.admitted_total,
            "shed_total": self.admission.shed_total,
            "classes": {name: {"priority": c.priority, "rate": c.rate,
                               "burst": c.burst,
                               "ttft_slo_ms": c.ttft_slo_ms}
                        for name, c in self.admission.classes.items()},
        }

    # ----------------------------------------------------------- lifecycle

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.replicas.refresh()
            except Exception:
                pass                            # probes must never kill

    def start(self) -> "Router":
        """Serve plain HTTP (see module doc) and start the probe loop."""
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="router-http")
        self._http_thread.start()
        if self.probe_interval_s > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True, name="router-probe")
            self._probe_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._http_thread is not None:
            # shutdown() blocks on serve_forever's ack; never-started
            # routers (construct-only use) would wait forever
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._http_thread:
            self._http_thread.join(timeout=10)
        if self._probe_thread:
            self._probe_thread.join(timeout=5)
        if self._own_metrics:
            self.metrics.close()
