"""Disaggregated prefill/decode serving: paged KV shipped between tiers
(port of ``dcos_commons_tpu/models/disagg.py``; the port imports nothing
of the JAX package).

A span is a run of full KV pages with its prompt, ``[L, N, page, KV,
D]`` per side (``{"q", "s"}`` for int8 pools), framed as KVSPAN1:
``MAGIC | header_len | header JSON | raw array bytes``, byte-identical
to the reference's frame for the same span. The header carries the
prompt, the per-page prefix hashes and a digest of the body, so a
mangled transfer dies in :func:`unpack_span` before anything touches a
page ledger.

* :class:`KVShipper` asks the prefill tier for a prompt's span
  (``POST /v1/prefill``) and keeps the shipping counters.
* :class:`PrefillWorker` is the prefill tier's front door: one
  ``PagedServer`` in prefill-only mode (``prefill_span``) behind HTTP,
  one request at a time on the engine; a full pool is a 503.
* :class:`DisaggCoordinator` drives the decode tier's engine behind a
  ``ServingFrontend`` started with ``drive=False``: new prompts go to
  the prefill tier through a small sender pool, arrived spans admit on
  pages free through ``adopt_pages``, and a dead or absent peer degrades
  a request to the co-located path (``peer_fallbacks``). The
  coordinator thread is the only one that touches the decode engine.

On CUDA the tiers run as two processes (``dist/disagg.yml``). With both
in ONE process, a decode window captured while the prefill tier works on
the card from its HTTP thread fails (``cudaErrorStreamCaptureInvalidated``):
keep the two apart, with one lock around the prefill engine's
``prefill_span`` and the decode engine's window captures (as
``chip_smoke.py`` phase 12 does), or by capturing every window the
coordinator runs before traffic (``engine.warmup(range(1,
engine.pages_per_stream + 1), window=decode_window)``).

:func:`fetch_prefix` is the fleet prefix-adoption client: it asks a
sibling's front door (``POST /v1/prefix``) for its longest cached prefix
of a prompt and is what ``PagedServer``'s ``peer_fetch`` calls.

Transport: the reference moves bytes through ``security/transport.py``
when it is importable (TLS for ``https://``); that module is not ported,
so this is the reference's own fallback: plain ``urllib`` for
``http://`` and :class:`PageShipError` for ``https://``, and
:class:`PrefillWorker` serves plain HTTP.
"""

from __future__ import annotations

import hashlib
import json
import queue
import struct
import threading
import time
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..metrics import MetricsRegistry
from ..tracing import TRACE_HEADER, Tracer, parse_header
from .paging import (flatten_payload, pack_arrays, page_hashes,
                     payload_from_arrays, unpack_arrays)

_MAGIC = b"KVSPAN1\0"
_WIRE_VERSION = 1


class PageShipError(RuntimeError):
    """A KV shipment that must not be adopted: framing, digest or
    prefix-hash verification failed."""


def pack_span(span: Dict[str, Any]) -> bytes:
    """Frame a span (``PagedServer.export_prefix``'s result) for the
    wire. The header names every array (shape and dtype), carries the
    prompt, first token, page size, the int8 flag, the per-page prefix
    hashes and a digest of the body."""
    specs, body = pack_arrays(flatten_payload(span["payload"]))
    meta = {
        "version": _WIRE_VERSION,
        "prompt": [int(t) for t in span["prompt"]],
        "first_token": int(span["first_token"]),
        "page_size": int(span["page_size"]),
        "kv_quant": bool(span["kv_quant"]),
        "page_hashes": page_hashes(span["prompt"], span["page_size"]),
        "body_digest": hashlib.blake2s(body).hexdigest(),
        "arrays": specs,
    }
    header = json.dumps(meta).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + body


def unpack_span(data: bytes) -> Dict[str, Any]:
    """Parse and VERIFY a framed span: magic, version, body digest, and
    the prefix hashes against the shipped prompt. Raises
    :class:`PageShipError` on any mismatch. Arrays come back as CPU
    tensors."""
    if not data.startswith(_MAGIC):
        raise PageShipError("bad magic: not a KV span frame")
    off = len(_MAGIC)
    if len(data) < off + 4:
        raise PageShipError("truncated frame: no header length")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        meta = json.loads(data[off:off + hlen])
        if not isinstance(meta, dict):
            raise ValueError("not an object")
    except ValueError as e:
        raise PageShipError(f"bad header: {e}") from None
    off += hlen
    if meta.get("version") != _WIRE_VERSION:
        raise PageShipError(f"wire version {meta.get('version')} != "
                            f"{_WIRE_VERSION}")
    body = memoryview(data)[off:]
    if hashlib.blake2s(body).hexdigest() != meta.get("body_digest"):
        raise PageShipError("body digest mismatch: corrupt transfer")
    try:
        prompt = [int(t) for t in meta["prompt"]]
        hashes_ok = (page_hashes(prompt, int(meta["page_size"]))
                     == meta["page_hashes"])
    except (KeyError, TypeError, ValueError) as e:
        raise PageShipError(f"bad header: {e}") from None
    if not hashes_ok:
        raise PageShipError("prefix-hash mismatch: prompt and pages "
                            "disagree")
    arrays = unpack_arrays(body, meta.get("arrays", []), PageShipError)
    payload = payload_from_arrays(arrays, PageShipError, "pages")
    return {"version": meta["version"], "prompt": prompt,
            "first_token": meta["first_token"],
            "page_size": meta["page_size"],
            "kv_quant": meta["kv_quant"],
            "page_hashes": meta["page_hashes"], "payload": payload}


def _transport_urlopen(req, timeout: float):
    """The reference's fallback transport: cleartext ``http://`` through
    plain urllib; ``https://`` is a hard error, since silently
    unverified TLS would defeat the point."""
    url = req.full_url if hasattr(req, "full_url") else str(req)
    if str(url).startswith("https://"):
        raise PageShipError(
            "https:// KV shipping needs security/transport.py, which is "
            "not ported")
    return urllib.request.urlopen(req, timeout=timeout)


class KVShipper:
    """Moves packed prefill spans between tiers and keeps the receipt
    counters (``bytes_shipped`` is the on-wire frame size)."""

    def __init__(self, timeout_s: float = 600.0):
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self.spans_shipped = 0
        self.bytes_shipped = 0

    pack = staticmethod(pack_span)
    unpack = staticmethod(unpack_span)

    def fetch(self, peer: str, prompt: List[int],
              trace=None) -> Dict[str, Any]:
        """Ship ``prompt`` to the prefill tier at ``peer`` and return the
        verified span its pages came back as. Raises
        :class:`PageShipError` on a transport failure, a peer 503 (pool
        back-pressure) or a frame that fails verification. ``trace`` (a
        ``tracing.TraceContext``) crosses the hop as ``X-Tpu-Trace``."""
        headers = {"Content-Type": "application/json"}
        if trace is not None:
            headers[TRACE_HEADER] = trace.header()
        req = urllib.request.Request(
            peer.rstrip("/") + "/v1/prefill",
            data=json.dumps({"prompt": [int(t) for t in prompt]}).encode(),
            headers=headers)
        try:
            with _transport_urlopen(req, timeout=self.timeout_s) as r:
                data = r.read()
        except PageShipError:
            raise
        except Exception as e:
            raise PageShipError(f"peer {peer}: {e}") from None
        span = unpack_span(data)
        with self._lock:
            self.spans_shipped += 1
            self.bytes_shipped += len(data)
        return span


def fetch_prefix(peer: str, prompt: List[int],
                 timeout_s: float = 30.0) -> Optional[Dict[str, Any]]:
    """Fetch a sibling replica's longest cached prefix of ``prompt`` as a
    verified span (``ServingFrontend``'s ``POST /v1/prefix``). Adoption
    is an optimization: on a miss (404), a transport failure or a frame
    that fails :func:`unpack_span`, this returns None and the asker
    recomputes."""
    req = urllib.request.Request(
        peer.rstrip("/") + "/v1/prefix",
        data=json.dumps({"prompt": [int(t) for t in prompt]}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with _transport_urlopen(req, timeout=timeout_s) as r:
            data = r.read()
        return unpack_span(data)
    except Exception:
        return None


class PrefillWorker:
    """The prefill tier's front door: one prefill-only ``PagedServer``
    behind HTTP.

    ``POST /v1/prefill`` ``{"prompt": [...]}`` runs chunked prefill flat
    out and answers with the packed span (200), 400 for a bad body or a
    prompt the engine can never prefill, 503 when the pool is full
    (transient: spans release every working page right after packing),
    500 for an engine error. ``GET`` serves ``/v1/healthz`` (``role``,
    ``pages_free``, ``shipped_spans``, ``load``), ``/v1/metrics``,
    ``/v1/metrics/prometheus``, ``/v1/traces`` and ``/v1/trace/<id>``.
    One request runs the engine at a time: concurrent posts queue on the
    engine lock."""

    def __init__(self, engine, port: int = 0, host: str = "0.0.0.0",
                 window_s: float = 60.0,
                 metrics: Optional[MetricsRegistry] = None,
                 trace_store=None):
        self.engine = engine
        self._lock = threading.Lock()
        # rolling-window load signal with ServingFrontend.load_gauges()'s
        # keys: the router and the autoscaler read "load" from every
        # replica shape's /v1/healthz
        self.window_s = window_s
        self._window: deque = deque(maxlen=4096)   # t of each span served
        self._sheds: deque = deque(maxlen=4096)    # t of each 503
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._own_metrics = metrics is None
        self.tracer = Tracer("prefill", trace_store)
        if getattr(engine, "tracer", None) is None:
            engine.tracer = Tracer("prefill-engine", trace_store)
        for key in ("completed", "shed", "shed_rate", "pages_free",
                    "pages_total"):
            self.metrics.gauge(f"prefill.{key}",
                               lambda k=key: self.load_gauges().get(k))
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/healthz":
                    st = worker.engine.page_stats()
                    self._json(200, {"ok": True, "role": "prefill",
                                     "pages_free": st["pages_free"],
                                     "shipped_spans": st["shipped_spans"],
                                     "load": worker.load_gauges()})
                elif self.path == "/v1/metrics":
                    self._json(200, worker.metrics.to_dict())
                elif self.path == "/v1/metrics/prometheus":
                    body = worker.metrics.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/v1/traces":
                    store = worker.tracer.store
                    self._json(200, {
                        "trace_ids": store.trace_ids(),
                        "incomplete": store.incomplete_trace_ids()})
                elif self.path.startswith("/v1/trace/"):
                    trace_id = self.path[len("/v1/trace/"):].split("?")[0]
                    self._json(200, worker.tracer.store.export(trace_id))
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/v1/prefill":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n))
                    prompt = [int(t) for t in body["prompt"]]
                except Exception as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                ctx = parse_header(self.headers.get(TRACE_HEADER))
                t0 = time.perf_counter()
                try:
                    with worker._lock:
                        span = worker.engine.prefill_span(prompt,
                                                          trace=ctx)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:
                    worker.metrics.counter("prefill.errors")
                    self._json(500, {"error": f"prefill failed: {e}"})
                    return
                if span is None:
                    worker._sheds.append(time.monotonic())
                    worker.metrics.counter("prefill.sheds")
                    if ctx is not None:
                        worker.tracer.record("prefill.request", t0,
                                             time.perf_counter(),
                                             parent=ctx, status="shed")
                    self._json(503, {"error": "page pool exhausted"})
                    return
                worker._window.append(time.monotonic())
                frame = pack_span(span)
                worker.metrics.counter("prefill.spans_served")
                worker.metrics.counter("prefill.bytes_served", len(frame))
                worker.metrics.observe("prefill.span_seconds",
                                       time.perf_counter() - t0)
                if ctx is not None:
                    worker.tracer.record(
                        "prefill.request", t0, time.perf_counter(),
                        parent=ctx, prompt_len=len(prompt),
                        frame_bytes=len(frame))
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(frame)))
                self.end_headers()
                self.wfile.write(frame)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def load_gauges(self) -> dict:
        """The autoscaler's back-pressure keys over the prefill tier:
        spans served stand for completions, 503s for sheds, page
        occupancy for utilization. ``queue_depth`` is 0 by construction:
        concurrent posts serialize on the engine lock, not a queue."""
        horizon = time.monotonic() - self.window_s
        shed = sum(1 for t in self._sheds if t >= horizon)
        completed = sum(1 for t in self._window if t >= horizon)
        out = {
            "window_s": self.window_s,
            "queue_depth": 0,
            "queue_capacity": 0,
            "completed": completed,
            "shed": shed,
            "shed_rate": shed / max(1, shed + completed),
            "ttft_p95_ms": None,
        }
        if hasattr(self.engine, "pages_free"):
            out["pages_free"] = self.engine.pages_free()
            ledger = getattr(self.engine, "ledger", None)
            if ledger is not None:
                out["pages_total"] = ledger.pages
        return out

    def start(self) -> "PrefillWorker":
        """Serve plain HTTP: the reference wraps TLS only through
        ``security/transport.py``, which is not ported."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="prefill-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
        if self._own_metrics:
            self.metrics.close()


class DisaggCoordinator:
    """The decode tier's driver, over the front door's external-driver
    seams (``mark_driven`` / ``drain_intake`` / ``attach`` / ``sync`` /
    ``fail_inflight``). One iteration:

    1. stamp liveness and resolve failed transfers (every peer down: a
       co-located fallback submit, counted in ``peer_fallbacks``);
    2. admit ARRIVED spans head of FIFO on pages free (``adopt_pages``);
       a span that does not fit stalls the queue (``transfer_stalls``)
       rather than being leapt;
    3. re-offer the co-located backlog, then drain NEW prompts from the
       front door (bounded by ``max_inflight`` transfers) into the
       sender pool;
    4. one decode window and the fan-out (``step_many`` + ``sync``).

    Only the coordinator thread touches the engine; the senders do HTTP
    and framing. ``run()`` keeps the gang driver's crash discipline: on
    an engine error every in-flight request fails fast and the engine
    resets. ``peer`` is one URL, a comma-separated list or a list:
    requests round-robin over the healthy peers, a failed fetch marks its
    peer down and tries the next before degrading, and a down peer
    rejoins once its ``/v1/healthz`` answers (probed at most every
    ``health_recheck_s``)."""

    def __init__(self, engine, frontend, peer,
                 shipper: Optional[KVShipper] = None,
                 max_intake: int = 4, decode_window: int = 8,
                 max_inflight: int = 8, transfer_workers: int = 2,
                 idle_sleep_s: float = 0.005,
                 colocated_fallback: bool = True,
                 health_recheck_s: float = 5.0):
        self.engine = engine
        self.frontend = frontend
        if isinstance(peer, str):
            self.peers = [p.strip() for p in peer.split(",") if p.strip()]
        elif peer:
            self.peers = [str(p).strip() for p in peer if str(p).strip()]
        else:
            self.peers = []
        # the single-peer view the reference's receipts read
        self.peer = self.peers[0] if self.peers else None
        self.health_recheck_s = health_recheck_s
        self._peer_lock = threading.Lock()
        self._rr = 0
        self._peer_down: Dict[str, float] = {}  # peer -> monotonic mark
        self.shipper = shipper if shipper is not None else KVShipper()
        self.max_intake = max(1, max_intake)
        self.decode_window = max(1, decode_window)
        self.max_inflight = max(1, max_inflight)
        self.idle_sleep_s = idle_sleep_s
        self.colocated_fallback = colocated_fallback
        self._send_q: "queue.Queue" = queue.Queue()
        self._arrivals: "queue.Queue" = queue.Queue()
        self._failed: "queue.Queue" = queue.Queue()
        self._arrival_backlog: List[Tuple[Dict[str, Any], Any]] = []
        self._local_backlog: List[Any] = []
        self._outstanding = 0              # transfers in flight
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self.tracer = Tracer("disagg")
        self.transfer_stalls = 0
        self.peer_fallbacks = 0
        self.iterations = 0
        self._senders = [
            threading.Thread(target=self._sender_loop, daemon=True,
                             name=f"kv-sender-{i}")
            for i in range(max(1, transfer_workers))]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ sender pool

    def _probe_healthz(self, peer: str) -> bool:
        try:
            req = urllib.request.Request(peer.rstrip("/") + "/v1/healthz")
            with _transport_urlopen(req, timeout=5.0) as r:
                return bool(json.loads(r.read()).get("ok"))
        except Exception:
            return False

    def _mark_down(self, peer: str) -> None:
        with self._peer_lock:
            self._peer_down[peer] = time.monotonic()

    def _peer_ok(self, peer: str) -> bool:
        """True when the peer is in rotation. A down peer stays out until
        the recheck window elapses AND its healthz probe (made here,
        outside the lock) answers ok."""
        with self._peer_lock:
            marked = self._peer_down.get(peer)
            if marked is None:
                return True
            if time.monotonic() - marked < self.health_recheck_s:
                return False
        if self._probe_healthz(peer):
            with self._peer_lock:
                self._peer_down.pop(peer, None)
            return True
        self._mark_down(peer)
        return False

    def _peer_order(self) -> List[str]:
        """Healthy peers in round-robin order for one request."""
        with self._peer_lock:
            n = len(self.peers)
            if n == 0:
                return []
            start = self._rr % n
            self._rr += 1
            ordered = self.peers[start:] + self.peers[:start]
        return [p for p in ordered if self._peer_ok(p)]

    def _sender_loop(self) -> None:
        while not self._stop.is_set():
            try:
                pending = self._send_q.get(timeout=0.1)
            except queue.Empty:
                continue
            last_err = "no healthy prefill peer"
            sent = False
            ctx = getattr(pending, "trace", None)
            # peer by peer: only after every healthy peer failed does the
            # request degrade to the co-located path
            for peer in self._peer_order():
                t0 = time.perf_counter()
                try:
                    span = self.shipper.fetch(peer, pending.prompt,
                                              trace=ctx)
                except Exception as e:
                    last_err = str(e)
                    if ctx is not None:
                        self.tracer.record("disagg.ship", t0,
                                           time.perf_counter(),
                                           parent=ctx, status="error",
                                           peer=peer)
                    self._mark_down(peer)
                    continue
                if ctx is not None:
                    self.tracer.record("disagg.ship", t0,
                                       time.perf_counter(), parent=ctx,
                                       peer=peer)
                self._arrivals.put((span, pending))
                sent = True
                break
            if not sent:
                self._failed.put((pending, last_err))

    def _dec_outstanding(self) -> None:
        with self._count_lock:
            self._outstanding -= 1

    # ------------------------------------------------------- drive loop

    def _admit_colocated(self, pending) -> None:
        """Degrade, never crash: the request runs both phases on the
        decode tier's engine (its chunked prefill). A capacity miss is
        re-offered from the local backlog next iteration."""
        if pending.t_submit is None:
            pending.t_submit = time.perf_counter()
        slot = self.engine.submit(pending.prompt, pending.max_new,
                                  request_id=pending)
        if slot is None:
            self._local_backlog.append(pending)
        else:
            self.frontend.attach(slot, pending)

    def run_iteration(self) -> bool:
        fe = self.frontend
        fe.mark_driven()
        worked = False
        # 1. failed transfers: degrade to the co-located paged path
        while True:
            try:
                pending, err = self._failed.get_nowait()
            except queue.Empty:
                break
            self._dec_outstanding()
            worked = True
            if self.colocated_fallback:
                self.peer_fallbacks += 1
                self._admit_colocated(pending)
            else:
                pending.finish(f"prefill peer failed: {err}")
        # 2. arrived spans admit on pages free, FIFO: a blocked head
        # stalls the queue (transfer_stalls) instead of being leapt
        while True:
            try:
                self._arrival_backlog.append(self._arrivals.get_nowait())
            except queue.Empty:
                break
        while self._arrival_backlog:
            span, pending = self._arrival_backlog[0]
            try:
                slot = self.engine.adopt_pages(
                    span, max_new=pending.max_new, request_id=pending)
            except (ValueError, PageShipError) as e:
                self._arrival_backlog.pop(0)
                self._dec_outstanding()
                pending.finish(f"span rejected: {e}")
                worked = True
                continue
            if slot is None:
                self.transfer_stalls += 1
                break
            self._arrival_backlog.pop(0)
            self._dec_outstanding()
            pending.t_submit = time.perf_counter()
            fe.attach(slot, pending)
            worked = True
        # 3. the co-located fallback backlog, then new intake
        backlog, self._local_backlog = self._local_backlog, []
        for pending in backlog:
            if pending.done.is_set():
                continue
            self._admit_colocated(pending)
        with self._count_lock:
            room = self.max_inflight - self._outstanding
        budget = min(self.max_intake, max(0, room))
        for pending in fe.drain_intake(budget):
            worked = True
            if not self.peers:
                self.peer_fallbacks += 1
                self._admit_colocated(pending)
                continue
            with self._count_lock:
                self._outstanding += 1
            self._send_q.put(pending)
        # 4. one decode window and the fan-out
        if self.engine.requests_active():
            self.engine.step_many(self.decode_window)
            fe.sync()
            worked = True
        self.iterations += 1
        return worked

    def run(self, max_iterations: Optional[int] = None) -> None:
        """Drive until stopped (or ``max_iterations``), with the gang
        driver's crash discipline: an engine error fails every in-flight
        request fast and resets the engine."""
        it = 0
        while not self._stop.is_set():
            if max_iterations is not None and it >= max_iterations:
                break
            it += 1
            try:
                worked = self.run_iteration()
            except Exception as e:
                self.frontend.fail_inflight(f"engine error: {e}")
                for _, pending in self._arrival_backlog:
                    self._dec_outstanding()
                    pending.finish(f"engine error: {e}")
                self._arrival_backlog = []
                for pending in self._local_backlog:
                    pending.finish(f"engine error: {e}")
                self._local_backlog = []
                self.engine.reset()
                continue
            if not worked:
                time.sleep(self.idle_sleep_s)

    def start(self) -> "DisaggCoordinator":
        for th in self._senders:
            th.start()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="disagg-coordinator")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        for th in self._senders:
            th.join(timeout=2)

    def stats(self) -> Dict[str, Any]:
        with self._count_lock:
            outstanding = self._outstanding
        with self._peer_lock:
            down = sorted(self._peer_down)
        return {
            "peer": self.peer,
            "peers": list(self.peers),
            "peers_down": down,
            "spans_shipped": self.shipper.spans_shipped,
            "kv_bytes_shipped": self.shipper.bytes_shipped,
            "transfer_stalls": self.transfer_stalls,
            "peer_fallbacks": self.peer_fallbacks,
            "transfers_inflight": outstanding,
            "iterations": self.iterations,
        }
