"""HTTP front door for the port's continuous-batching engines (port of
``dcos_commons_tpu/models/ingress.py``).

HTTP handler threads never touch the device. They validate, enqueue into
a BOUNDED queue (back-pressure is a 503 + Retry-After, not an unbounded
pile-up in front of a fixed-throughput card), and wait on their
request's stream. ONE engine thread owns the engine: submissions fill
freed slots, one ``step_many`` window advances every active slot, and
freshly decoded tokens fan out to the per-request streams with
timestamps, so TTFT and TPOT are measured per request at the door. The
engine is used duck-typed: :class:`~dcos_commons_tpu_torch.models.
serving.SlotServer` and :class:`~dcos_commons_tpu_torch.models.serving.
PagedServer` both serve behind it.

API (all JSON):

* ``POST /v1/generate``  ``{"prompt": [ints], "max_new": N, "stream": bool}``
  → ``{"tokens": [...], "ttft_ms", "tpot_ms", "queue_ms"}``; with
  ``stream`` true, chunked JSON lines ``{"token": t}`` … ``{"done": true}``.
* ``GET /v1/healthz`` → 200 once the engine thread accepts work.
* ``GET /v1/stats`` → request/token totals + TTFT/TPOT percentiles over
  the last window.
* ``GET /v1/metrics``, ``/v1/metrics/prometheus``, ``/v1/traces``,
  ``/v1/trace/<id>`` → the registry and the trace store.
* ``POST /v1/prefix`` → 404 "engine has no prefix export", as the
  reference answers for an engine without ``export_prefix``: no engine
  of the port exports a prefix yet (its KVSPAN frame is not ported).

A paged engine with a draft armed (or armed once) adds the reference's
speculative gauges (``spec_windows``, ``spec_proposed``,
``spec_accepted``, ``spec_accept_rate``, ``spec_fallbacks``) to the load
gauges and the registry.

Not ported: the external-driver interface of the tensor-parallel gang
loop (``start(drive=False)``, ``attach``, ``mark_driven``), and the KV
tier gauges (no port engine has tiers).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..metrics import MetricsRegistry
from ..tracing import TRACE_HEADER, Tracer, parse_header
from ..utils.stats import percentiles as _percentiles


class _Pending:
    """One in-flight request: filled in by the engine thread, consumed by
    the handler thread that owns the HTTP connection."""

    __slots__ = ("prompt", "max_new", "stream", "tokens", "emitted",
                 "t_enqueue", "t_submit", "t_first", "t_done", "error",
                 "done", "events", "trace", "on_finish")

    def __init__(self, prompt: List[int], max_new: int, trace=None):
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: List[int] = []
        self.emitted = 0                  # engine-side high-water mark
        self.t_enqueue = time.perf_counter()
        self.t_submit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.error: Optional[str] = None
        self.done = threading.Event()
        # token stream for chunked responses: ints, then None sentinel
        self.events: "queue.Queue" = queue.Queue()
        # incoming X-Tpu-Trace context (None for untraced callers) and
        # the frontend's one-shot finalizer (spans + histograms)
        self.trace = trace
        self.on_finish = None

    def push(self, tokens: List[int]) -> None:
        now = time.perf_counter()
        for t in tokens:
            if self.t_first is None:
                self.t_first = now
            self.tokens.append(t)
            self.events.put(t)

    def finish(self, error: Optional[str] = None) -> None:
        self.error = error
        self.t_done = time.perf_counter()
        # one-shot: every finish path (normal retire, engine error,
        # shutdown) lands exactly one terminal span + histogram sample
        hook, self.on_finish = self.on_finish, None
        if hook is not None:
            try:
                hook(self)
            except Exception:
                pass
        self.events.put(None)
        self.done.set()

    def timings_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.t_submit is not None:
            out["queue_ms"] = round((self.t_submit - self.t_enqueue) * 1e3, 3)
        if self.t_first is not None:
            out["ttft_ms"] = round((self.t_first - self.t_enqueue) * 1e3, 3)
        if (self.t_done is not None and self.t_first is not None
                and len(self.tokens) > 1):
            out["tpot_ms"] = round(
                (self.t_done - self.t_first) / (len(self.tokens) - 1) * 1e3,
                3)
        return out


class ServingFrontend:
    """Bounded-queue HTTP ingress over one engine (``SlotServer`` or
    ``PagedServer``)."""

    def __init__(self, engine, port: int = 0,
                 host: str = "0.0.0.0", max_queue: int = 64,
                 request_timeout_s: float = 600.0,
                 idle_sleep_s: float = 0.001,
                 decode_window: int = 8,
                 window_s: float = 60.0,
                 metrics: Optional[MetricsRegistry] = None,
                 trace_store=None):
        self.engine = engine
        self.max_queue = max_queue
        # shared registry when the deployment passes one, else a private
        # one; either way the /v1/metrics endpoints below serve it
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = Tracer("serve", trace_store)
        # the engine's tracer seam (models/serving.py): set here so an
        # engine that records spans shares the front door's store
        if getattr(engine, "tracer", None) is None:
            engine.tracer = Tracer("engine", trace_store)
        self.request_timeout_s = request_timeout_s
        self._idle_sleep_s = idle_sleep_s
        # tokens decoded per host round trip (step_many): the eager step
        # is host-bound, so the engine decodes a window between
        # transfers; new requests wait at most one window for a slot
        self._decode_window = max(1, decode_window)
        self._queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_queue)
        self._live: Dict[int, _Pending] = {}          # slot -> pending
        # drained from the queue but not yet admitted (a paged engine
        # admits a FIFO prefix when pages run short): retried FIRST on
        # the next fill so nothing is silently dropped
        self._backlog: List[_Pending] = []
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._lock = threading.Lock()                 # stats only
        self._totals = {"requests": 0, "tokens": 0, "rejected": 0}
        # rolling-window load gauges (autoscaler input): completions and
        # sheds are stamped with time.monotonic() so load_gauges() can
        # report the last window_s seconds rather than lifetime totals —
        # point samples and lifetime counters both mislead a controller
        # (the former is noise, the latter never decays)
        self.window_s = window_s
        self._window: deque = deque(maxlen=1024)      # (t, ttft_ms, tpot_ms)
        self._sheds: deque = deque(maxlen=4096)       # t of each rejection
        self._engine_thread: Optional[threading.Thread] = None
        self._own_metrics = metrics is None
        # fold the rolling load gauges into the registry so one scrape
        # carries queue fill, shed rate, and window TTFT p95 alongside
        # the request histograms (suppliers run OUTSIDE the registry
        # lock — to_dict()'s contract — so reading self._lock is safe)
        for key in ("queue_depth", "queue_capacity", "completed", "shed",
                    "shed_rate", "ttft_p95_ms", "pages_free",
                    "pages_total", "spec_windows", "spec_proposed",
                    "spec_accepted", "spec_accept_rate", "spec_fallbacks"):
            self.metrics.gauge(f"ingress.{key}",
                               lambda k=key: self.load_gauges().get(k))
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # one request per connection keeps the thread pool honest
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):             # no stderr spam
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
                    self._json(200, frontend.health())
                elif self.path == "/v1/stats":
                    self._json(200, frontend.stats())
                elif self.path == "/v1/metrics":
                    self._json(200, frontend.metrics.to_dict())
                elif self.path == "/v1/metrics/prometheus":
                    body = frontend.metrics.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/v1/traces":
                    store = frontend.tracer.store
                    self._json(200, {
                        "trace_ids": store.trace_ids(),
                        "incomplete": store.incomplete_trace_ids()})
                elif self.path.startswith("/v1/trace/"):
                    trace_id = self.path[len("/v1/trace/"):].split("?")[0]
                    self._json(200, frontend.tracer.store.export(trace_id))
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/v1/prefix":
                    # no port engine exports a prefix (module doc)
                    self._json(404, {"error": "engine has no prefix "
                                              "export"})
                    return
                if self.path != "/v1/generate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    prompt = req.get("prompt")
                    max_new = int(req.get("max_new", 32))
                    stream = bool(req.get("stream", False))
                    if (not isinstance(prompt, list) or not prompt
                            or not all(isinstance(t, int) for t in prompt)):
                        raise ValueError("prompt must be a non-empty "
                                         "list of ints")
                    if max_new < 1:
                        raise ValueError("max_new must be >= 1")
                    cfg = frontend.engine.cfg
                    if len(prompt) + max_new > cfg.max_seq:
                        raise ValueError(
                            f"prompt {len(prompt)} + max_new {max_new} "
                            f"exceeds the cache ({cfg.max_seq})")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                ctx = parse_header(self.headers.get(TRACE_HEADER))
                pending = _Pending(prompt, max_new, trace=ctx)
                pending.on_finish = frontend._finalize
                if not frontend._enqueue(pending):
                    now = time.perf_counter()
                    frontend.tracer.record(
                        "serve.admission", now, now, parent=ctx,
                        terminal=True, status="shed")
                    self._json(503, {"error": "queue full"},
                               {"Retry-After": "1"})
                    return
                if stream:
                    self._stream(pending)
                else:
                    self._unary(pending)

            def _unary(self, pending: _Pending) -> None:
                if not pending.done.wait(frontend.request_timeout_s):
                    self._json(504, {"error": "request timed out"})
                    return
                if pending.error:
                    self._json(500, {"error": pending.error})
                    return
                self._json(200, {"tokens": pending.tokens,
                                 **pending.timings_ms()})

            def _stream(self, pending: _Pending) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj: dict) -> None:
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")

                deadline = time.time() + frontend.request_timeout_s
                finished = False
                while time.time() < deadline:
                    try:
                        tok = pending.events.get(timeout=1.0)
                    except queue.Empty:
                        continue
                    if tok is None:
                        finished = True
                        break
                    chunk({"token": tok})
                if pending.error:
                    chunk({"done": True, "error": pending.error})
                elif not finished:
                    # a deadline-truncated stream must NOT read as a
                    # complete one (the unary path 504s here)
                    chunk({"done": True, "error": "request timed out"})
                else:
                    chunk({"done": True, **pending.timings_ms()})
                self.wfile.write(b"0\r\n\r\n")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ intake

    def _enqueue(self, pending: _Pending) -> bool:
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            with self._lock:
                self._totals["rejected"] += 1
                self._sheds.append(time.monotonic())
            self.metrics.counter("ingress.sheds")
            return False
        self._wake.set()
        return True

    def _finalize(self, pending: _Pending) -> None:
        """One-shot completion hook (``_Pending.finish``): land the
        request's latencies in the shared histograms and emit its spans
        retrospectively from the stored perf-counter stamps — queue wait,
        prefill-to-first-token, decode — chained under one terminal
        ``serve.request`` root so the trace reads end-to-end."""
        t_done = pending.t_done if pending.t_done is not None \
            else time.perf_counter()
        t_sub, t_first = pending.t_submit, pending.t_first
        m = self.metrics
        m.counter("ingress.requests_total")
        m.counter("ingress.tokens_total", len(pending.tokens))
        if pending.error:
            m.counter("ingress.request_errors")
        if t_sub is not None:
            m.observe("ingress.queue_seconds", t_sub - pending.t_enqueue)
        if t_first is not None:
            m.observe("ingress.ttft_seconds", t_first - pending.t_enqueue)
            if len(pending.tokens) > 1:
                m.observe("ingress.tpot_seconds",
                          (t_done - t_first) / (len(pending.tokens) - 1))
        status = "error" if pending.error else "ok"
        attrs = {"tokens": len(pending.tokens)}
        if pending.error:
            attrs["error"] = pending.error
        root = self.tracer.record(
            "serve.request", pending.t_enqueue, t_done,
            parent=pending.trace, terminal=True, status=status, **attrs)
        if t_sub is not None:
            self.tracer.record("serve.queue_wait", pending.t_enqueue,
                               t_sub, parent=root)
            if t_first is not None:
                self.tracer.record("serve.first_token", t_sub, t_first,
                                   parent=root)
                self.tracer.record("serve.decode", t_first, t_done,
                                   parent=root, tokens=len(pending.tokens))

    # ------------------------------------------------------- engine loop

    def _fill_slots(self) -> bool:
        filled = False
        while self.engine.free_slots():
            budget = len(self.engine.free_slots()) - len(self._backlog)
            batch = self._backlog + (self.drain_intake(budget)
                                     if budget > 0 else [])
            self._backlog = []
            if not batch:
                break
            now = time.perf_counter()
            items = []
            for pending in batch:
                if pending.t_submit is None:
                    pending.t_submit = now
                items.append({"prompt": pending.prompt,
                              "max_new": pending.max_new,
                              "request_id": pending})
            try:
                # batched admission: O(log n) prefill dispatches; the
                # engine's own predicate fails bad items ALONE
                # (validated at POST too, but one copy rules)
                placed = self.engine.submit_many(
                    items,
                    on_invalid=lambda item, reason:
                        item["request_id"].finish(reason))
                for slot, pending in placed:
                    self._live[slot] = pending
            except Exception as e:
                # dequeued but possibly not yet in _live: fail them
                # HERE or the clients hang to their timeout
                # (_fail_inflight only sees _live) — then re-raise so
                # _run_engine resets the engine (the dispatch may have
                # invalidated the cache)
                for item in items:
                    item["request_id"].finish(f"engine error: {e}")
                raise
            # unadmitted + not-failed items wait for capacity (pages or
            # slots), retried first next fill — NEVER dropped
            placed_ids = {id(p) for _, p in placed}
            self._backlog = [p for p in batch
                             if id(p) not in placed_ids
                             and not p.done.is_set()]
            self._sync()                # instant retire (max_new == 1)
            if not placed:
                break                    # no capacity: retry next tick
            filled = True
        return filled

    def _sync(self) -> None:
        """Fan freshly decoded tokens out to their request streams and
        resolve completions (engine thread only)."""
        for slot, pending in list(self._live.items()):
            r = self.engine.requests[slot]
            if r is not None and r.request_id is pending:
                if len(r.tokens) > pending.emitted:
                    pending.push(r.tokens[pending.emitted:])
                    pending.emitted = len(r.tokens)
                continue
            toks = self.engine.finished.pop(pending, None)
            if toks is not None and len(toks) > pending.emitted:
                pending.push(toks[pending.emitted:])
                pending.emitted = len(toks)
            del self._live[slot]
            # finish() first: timings_ms() only reports tpot once t_done
            # is stamped, so the stats window must read AFTER it
            pending.finish()
            with self._lock:
                self._totals["requests"] += 1
                self._totals["tokens"] += len(pending.tokens)
                t = pending.timings_ms()
                self._window.append((time.monotonic(), t.get("ttft_ms"),
                                     t.get("tpot_ms")))

    def _run_engine(self) -> None:
        while not self._stop.is_set():
            try:
                filled = self._fill_slots()
                if self.engine.requests_active():
                    self.engine.step_many(self._decode_window)
                    self._sync()
                elif not filled:
                    self._wake.wait(self._idle_sleep_s * 50)
                    self._wake.clear()
            except Exception as e:          # keep serving: only the
                # scheduler's health machinery should kill this task.
                # In-flight requests fail (their state is gone), the
                # engine RESETS (a failed step may have left the cache
                # half-written), and the loop accepts new work.
                self._fail_inflight(f"engine error: {e}")

    def _fail_inflight(self, error: str) -> None:
        for pending in list(self._live.values()):
            pending.finish(error)
        self._live.clear()
        with self._lock:
            self._totals["errors"] = self._totals.get("errors", 0) + 1
        # a reset that fails leaves the engine unusable: it escapes and
        # ends the engine thread, so health reports ok false
        self.engine.reset()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ServingFrontend":
        """Start the engine thread and the HTTP listener."""
        self._engine_thread = threading.Thread(
            target=self._run_engine, daemon=True, name="serving-engine")
        self._engine_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="serving-http")
        self._http_thread.start()
        return self

    def drain_intake(self, budget: int) -> List[_Pending]:
        """Pop up to ``budget`` queued requests (engine thread only)."""
        out = []
        while len(out) < budget:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return out

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._engine_thread:
            self._engine_thread.join(timeout=10)
        # fail anything still queued or in flight so no client hangs
        while True:
            try:
                self._queue.get_nowait().finish("server stopped")
            except queue.Empty:
                break
        for pending in self._backlog:
            pending.finish("server stopped")
        self._backlog = []
        for pending in list(self._live.values()):
            pending.finish("server stopped")
        self._live.clear()
        if self._own_metrics:
            self.metrics.close()

    # ------------------------------------------------------------- status

    def health(self) -> dict:
        alive = (self._engine_thread is not None
                 and self._engine_thread.is_alive())
        out = {"ok": alive, "slots": self.engine.slots,
               "free": len(self.engine.free_slots()),
               "queued": self._queue.qsize()}
        if hasattr(self.engine, "pages_free"):
            # paged engines admit on pages: surface the real
            # utilization signal (autoscalers key off this, not slots)
            out["pages_free"] = self.engine.pages_free()
        out["load"] = self.load_gauges()
        return out

    def load_gauges(self) -> dict:
        """Time-windowed back-pressure signals over the last ``window_s``
        seconds, the reference's autoscaler contract. Served in the
        ``/v1/healthz`` body and under ``stats()["window"]``."""
        now = time.monotonic()
        horizon = now - self.window_s
        with self._lock:
            shed = sum(1 for t in self._sheds if t >= horizon)
            recent = [e for e in self._window if e[0] >= horizon]
        completed = len(recent)
        ttft = [t for _, t, _ in recent if t is not None]
        out = {
            "window_s": self.window_s,
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self.max_queue,
            "completed": completed,
            "shed": shed,
            # fraction of window arrivals turned away at the door
            "shed_rate": shed / max(1, shed + completed),
            "ttft_p95_ms": _percentiles(ttft).get("p95"),
        }
        if hasattr(self.engine, "pages_free"):
            out["pages_free"] = self.engine.pages_free()
            ledger = getattr(self.engine, "ledger", None)
            if ledger is not None:
                out["pages_total"] = ledger.pages
        if getattr(self.engine, "spec_windows", 0) or \
                getattr(self.engine, "draft_k", 0):
            # speculative decode armed (or armed once): tokens per target
            # pass are 1 + accept_rate * (k - 1), the engine's speed
            # multiplier, beside the queue gauges
            proposed = self.engine.spec_proposed
            out["spec_windows"] = self.engine.spec_windows
            out["spec_proposed"] = proposed
            out["spec_accepted"] = self.engine.spec_accepted
            out["spec_accept_rate"] = (
                out["spec_accepted"] / proposed if proposed else 0.0)
            out["spec_fallbacks"] = self.engine.spec_fallbacks
        return out

    def stats(self) -> dict:
        with self._lock:
            totals = dict(self._totals)
            window = list(self._window)
        ttft = [t for _, t, _ in window if t is not None]
        tpot = [t for _, _, t in window if t is not None]
        return {**totals, "queued": self._queue.qsize(),
                "ttft_ms": _percentiles(ttft),
                "tpot_ms": _percentiles(tpot),
                "window": self.load_gauges()}
