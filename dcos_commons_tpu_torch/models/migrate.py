"""Live migration of in-flight decode streams between paged engines (port
of ``dcos_commons_tpu/models/migrate.py``; the port imports nothing of the
JAX package).

A scale-down or a preemption drains a replica: every live decode stream
moves to a survivor and resumes there token-exact, on the span channel
that disaggregated serving built (``models.disagg``).

* :func:`pack_decstate` / :func:`unpack_decstate`: the ``DECSTATE`` wire
  frame, ``MAGIC | header_len | header digest | header JSON | raw
  pages``, byte-identical to the reference's frame for the same state.
  The header carries the prompt, the generated tokens, the remaining
  budget, the engine's RNG state, the tenant, QoS class, trace context
  and request id, the prompt's prefix-page hashes and a digest of the
  body; it has a digest of its own. Magic, version, both digests and the
  prefix hashes are checked before the destination reserves anything;
  any mismatch is a :class:`DecStateError`.
* :class:`MigrationManager`: the drain. Per stream it freezes at a
  window boundary (``PagedServer.export_stream``, a pure read), ranks
  the survivors by ring preference for the stream's affinity key
  (``router.route_key`` over a ``router.HashRing``), round-trips the
  state through the DECSTATE frame, adopts it transactionally
  (``import_stream``) and only then releases the victim's copy
  (``release_stream``). A refusal or a failure leaves the victim's
  stream untouched and tries the next survivor; a stream still
  prefilling re-submits its prompt.
* :class:`MigrateReceiver`: ``POST /v1/migrate`` over one engine, the
  destination of a drain across processes (:class:`RemoteReplica`).

The RNG field differs from the reference on purpose: the reference ships
its engine's JAX key data; the port's engines draw from a
``torch.Generator``, so ``export_stream`` ships ``generator.get_state()``
(a uint8 array) in the same ``rng_key`` slot, and ``import_stream(
adopt_rng=True)`` restores it into the destination's own generator.

Transport: the reference moves frames through ``security/transport.py``
when it is importable; that module is not ported, so this is the
reference's own fallback: plain HTTP (``disagg._transport_urlopen``), and
:class:`MigrateReceiver` serves plain HTTP.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tracing import TRACE_HEADER, Tracer, parse_header
from .disagg import PageShipError, _transport_urlopen
from .paging import (flatten_payload, pack_arrays, page_hashes,
                     payload_from_arrays, unpack_arrays)

_DEC_MAGIC = b"DECSTAT1"
_DEC_VERSION = 1


class DecStateError(PageShipError):
    """A DECSTATE frame that must not be adopted: framing, digest,
    version, or prefix-hash verification failed."""


# --------------------------------------------------------------- wire format


def pack_decstate(state: Dict[str, Any], tenant: Optional[str] = None,
                  qos: Optional[str] = None,
                  trace: Optional[str] = None,
                  request_id: Optional[Any] = None) -> bytes:
    """Frame a ``PagedServer.export_stream()`` result for the wire:
    ``MAGIC | header_len | header digest | header JSON | raw page
    bytes``. The header carries everything :func:`unpack_decstate`
    verifies plus the stream's identity (prompt, generated tokens,
    budget, the engine's RNG state in hex, tenant and QoS labels, the
    trace context header and the request id), so the destination resumes
    the stream as the same request."""
    specs, body = pack_arrays(flatten_payload(state["payload"]))
    rng = state.get("rng_key")
    rng_meta = None
    if rng is not None:
        # a generator state is a CPU uint8 tensor, a reference key an array
        rng = (rng.detach().cpu().contiguous().numpy()
               if isinstance(rng, torch.Tensor) else np.asarray(rng))
        rng_meta = {"shape": list(rng.shape), "dtype": rng.dtype.name,
                    "hex": rng.tobytes().hex()}
    meta = {
        "version": _DEC_VERSION,
        "prompt": [int(t) for t in state["prompt"]],
        "tokens": [int(t) for t in state["tokens"]],
        "max_new": int(state["max_new"]),
        "page_size": int(state["page_size"]),
        "kv_quant": bool(state["kv_quant"]),
        "rng_key": rng_meta,
        "tenant": tenant,
        "qos": qos,
        "trace": trace,
        "request_id": (request_id if request_id is None
                       or isinstance(request_id, (str, int))
                       else str(request_id)),
        "page_hashes": page_hashes(state["prompt"], state["page_size"]),
        "body_digest": hashlib.blake2s(body).hexdigest(),
        "arrays": specs,
    }
    header = json.dumps(meta).encode()
    # the stream's identity (tokens, budget, RNG state) is covered by no
    # page hash: the header gets a digest of its own
    hdig = hashlib.blake2s(header, digest_size=8).digest()
    return _DEC_MAGIC + struct.pack("<I", len(header)) + hdig + header + body


def unpack_decstate(data: bytes) -> Dict[str, Any]:
    """Parse and VERIFY a DECSTATE frame: magic, the header digest,
    version, the body digest, the prefix hashes against the shipped
    prompt, and each array's bounds. Raises :class:`DecStateError` on any
    mismatch, before the destination reserves anything. Returns the dict
    ``PagedServer.import_stream`` takes (pages as CPU tensors, the RNG
    state as a host array) plus ``tenant``, ``qos``, ``trace`` and
    ``request_id``."""
    if not data.startswith(_DEC_MAGIC):
        raise DecStateError("bad magic: not a DECSTATE frame")
    off = len(_DEC_MAGIC)
    if len(data) < off + 12:
        raise DecStateError("truncated frame: no header length")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    hdig, off = data[off:off + 8], off + 8
    header = data[off:off + hlen]
    if len(header) < hlen:
        raise DecStateError("truncated frame: short header")
    if hashlib.blake2s(header, digest_size=8).digest() != hdig:
        raise DecStateError("header digest mismatch: corrupt transfer")
    try:
        meta = json.loads(header)
    except ValueError as e:
        raise DecStateError(f"bad header: {e}") from None
    off += hlen
    if not isinstance(meta, dict):
        raise DecStateError("bad header: not an object")
    if meta.get("version") != _DEC_VERSION:
        raise DecStateError(f"DECSTATE version {meta.get('version')} != "
                            f"{_DEC_VERSION}")
    body = memoryview(data)[off:]
    if hashlib.blake2s(body).hexdigest() != meta.get("body_digest"):
        raise DecStateError("body digest mismatch: corrupt transfer")
    try:
        prompt = [int(t) for t in meta["prompt"]]
        tokens = [int(t) for t in meta["tokens"]]
        hashes_ok = (page_hashes(prompt, int(meta["page_size"]))
                     == meta["page_hashes"])
    except (KeyError, TypeError, ValueError) as e:
        raise DecStateError(f"bad header: {e}") from None
    if not tokens:
        raise DecStateError("DECSTATE frame carries no generated tokens")
    if not hashes_ok:
        raise DecStateError("prefix-hash mismatch: prompt and pages "
                            "disagree")
    arrays = unpack_arrays(body, meta.get("arrays", []), DecStateError)
    payload = payload_from_arrays(arrays, DecStateError, "pages")
    rng = None
    rm = meta.get("rng_key")
    if rm is not None:
        try:
            rng = np.frombuffer(bytes.fromhex(rm["hex"]),
                                np.dtype(rm["dtype"])).reshape(
                                    tuple(rm["shape"])).copy()
        except (TypeError, ValueError, AttributeError, KeyError):
            raise DecStateError("mangled rng_key in header") from None
    return {"version": meta["version"], "prompt": prompt,
            "tokens": tokens, "max_new": meta["max_new"],
            "page_size": meta["page_size"],
            "kv_quant": meta["kv_quant"], "rng_key": rng,
            "tenant": meta.get("tenant"), "qos": meta.get("qos"),
            "trace": meta.get("trace"),
            "request_id": meta.get("request_id"), "payload": payload}


# ------------------------------------------------------------ the wire hop


def ship_stream(peer: str, frame: bytes, timeout_s: float = 30.0,
                trace: Optional[str] = None) -> Dict[str, Any]:
    """POST one DECSTATE frame to ``peer``'s :class:`MigrateReceiver`.
    Raises :class:`DecStateError` on a transport failure, a peer 503
    (capacity back-pressure) or a rejected frame."""
    headers = {"Content-Type": "application/octet-stream"}
    if trace:
        headers[TRACE_HEADER] = trace
    req = urllib.request.Request(peer.rstrip("/") + "/v1/migrate",
                                 data=frame, headers=headers)
    try:
        with _transport_urlopen(req, timeout=timeout_s) as r:
            body = json.loads(r.read())
    except PageShipError:
        raise
    except Exception as e:
        raise DecStateError(f"peer {peer}: {e}") from None
    if not body.get("ok"):
        raise DecStateError(f"peer {peer}: {body.get('error', 'rejected')}")
    return body


class RemoteReplica:
    """A destination behind HTTP: the importer surface (``import_stream``
    / ``submit``) over a peer's :class:`MigrateReceiver`, so
    :class:`MigrationManager` drains to a remote replica through the code
    path it uses in process. A capacity 503 maps to None (the manager
    tries the next candidate); every other failure raises."""

    def __init__(self, peer: str, timeout_s: float = 30.0):
        self.peer = peer.rstrip("/")
        self.timeout_s = timeout_s

    def import_stream(self, state: Dict[str, Any],
                      request_id: Any = None) -> Optional[int]:
        trace = getattr(request_id, "trace", None)
        frame = pack_decstate(
            state, tenant=getattr(request_id, "tenant", None),
            qos=getattr(request_id, "qos", None),
            trace=trace.header() if hasattr(trace, "header") else None,
            request_id=request_id)
        try:
            body = ship_stream(self.peer, frame, timeout_s=self.timeout_s)
        except DecStateError as e:
            if "503" in str(e) or "exhausted" in str(e):
                return None
            raise
        return int(body.get("slot", 0))

    def submit(self, prompt: List[int], max_new: int = 32,
               request_id: Any = None) -> Optional[int]:
        # a still-prefilling stream has no decode state to ship, and the
        # receiver has no generic /v1/generate: "not handled", the caller
        # re-submits through the front door instead
        return None


# --------------------------------------------------------------- the manager


class MigrationManager:
    """The decode-to-decode drain protocol, one victim replica at a time.

    ``drain(victim, victim_name, dests)`` walks every live stream on the
    victim and for each one: freeze at a window boundary
    (``export_stream``, a pure read), rank the survivors by ring
    preference (prefix affinity: the stream lands where its prompt pages
    are likely cached), round-trip through the DECSTATE frame (so the
    in-process path runs the wire's verification), adopt
    transactionally (``import_stream``), and only then release the
    victim's copy. Any failure leaves the victim's stream untouched and
    tries the next candidate; a stream no destination accepts stays on
    the victim (``failed`` in the receipt). Streams still prefilling
    re-submit their prompt.

    ``ring`` is any object with ``preference(key) -> [name, ...]``
    (``router.HashRing``); without one, destinations are tried in the
    order given. ``on_redirect(src, dst)`` fires for each moved stream:
    ``router.Router.note_migration`` goes there so relays follow.
    """

    def __init__(self, enable: bool = True, timeout_s: float = 30.0,
                 max_inflight: int = 2, ring=None, page_size: int = 64,
                 affinity_pages: int = 1, tracer: Optional[Tracer] = None,
                 on_redirect=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        self.enable = enable
        self.timeout_s = timeout_s
        self.max_inflight = max_inflight
        self.ring = ring
        self.page_size = page_size
        self.affinity_pages = affinity_pages
        self.tracer = tracer
        self.on_redirect = on_redirect
        self._lock = threading.Lock()
        self.started = 0
        self.migrated = 0
        self.resubmitted = 0
        self.failed = 0
        self.pause_ms: List[float] = []
        # (victim, dest, request_id repr, generated tokens), newest last
        self.moves: List[Tuple[str, str, str, int]] = []

    # ------------------------------------------------------------ planning

    def destination_order(self, prompt: Sequence[int],
                          names: Sequence[str]) -> List[str]:
        """Surviving destinations in ring-preference order for this
        stream's affinity key; survivors the ring does not know follow
        in the order given (never unreachable)."""
        names = list(names)
        if self.ring is None or not names:
            return names
        from .router import route_key
        key = route_key(prompt, self.page_size, self.affinity_pages)
        pref = [n for n in self.ring.preference(key) if n in names]
        return pref + [n for n in names if n not in pref]

    # -------------------------------------------------------------- drain

    def migrate_stream(self, victim, slot: int, victim_name: str,
                       dests: Sequence[Tuple[str, Any]]) -> Optional[str]:
        """Move ONE stream; returns the destination's name, or None when
        every candidate refused (the victim keeps the stream)."""
        r = victim.requests[slot]
        if r is None:
            return None
        t0 = time.perf_counter()
        with self._lock:
            self.started += 1
        state = victim.export_stream(slot)
        rid = r.request_id
        trace = getattr(rid, "trace", None)
        if state is None:
            # still prefilling: nothing emitted yet, so re-submitting the
            # prompt on a survivor is already token-exact
            prompt = victim._prompts[slot]
            for name, dest in dests:
                if time.perf_counter() - t0 > self.timeout_s:
                    break
                try:
                    s = dest.submit(list(prompt), r.budget,
                                    request_id=rid)
                except Exception:
                    continue
                if s is None:
                    continue
                victim.release_stream(slot)
                self._done(t0, victim_name, name, rid, 0, resubmit=True)
                return name
            with self._lock:
                self.failed += 1
            return None
        frame = pack_decstate(
            state, tenant=getattr(rid, "tenant", None),
            qos=getattr(rid, "qos", None),
            trace=trace.header() if hasattr(trace, "header") else None)
        for name, dest in dests:
            if time.perf_counter() - t0 > self.timeout_s:
                break
            try:
                # the in-process hop round-trips the real frame, so the
                # local path runs exactly the wire's verification
                new_slot = dest.import_stream(unpack_decstate(frame),
                                              request_id=rid)
            except Exception:
                continue                       # dest unwound; try next
            if new_slot is None:
                continue                       # capacity; try next
            victim.release_stream(slot)
            self._done(t0, victim_name, name, rid, len(state["tokens"]))
            return name
        with self._lock:
            self.failed += 1
        return None

    def _done(self, t0: float, src: str, dst: str, rid: Any,
              generated: int, resubmit: bool = False) -> None:
        pause = (time.perf_counter() - t0) * 1e3
        with self._lock:
            if resubmit:
                self.resubmitted += 1
            else:
                self.migrated += 1
            self.pause_ms.append(pause)
            self.moves.append((src, dst, repr(rid), generated))
        if self.on_redirect is not None:
            self.on_redirect(src, dst)
        if self.tracer is not None:
            ctx = getattr(rid, "trace", None)
            if ctx is not None:
                self.tracer.record("migrate.stream", t0,
                                   time.perf_counter(), parent=ctx,
                                   src=src, dst=dst, generated=generated,
                                   resubmit=resubmit)

    def drain(self, victim, victim_name: str,
              dests: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
        """Drain EVERY live stream off ``victim`` onto the surviving
        ``dests`` (``[(name, engine or RemoteReplica), ...]``), each
        stream's candidates in ring preference over the given names.
        Returns the receipt. With ``enable=False`` this is a no-op
        returning a zero receipt: the scale event proceeds as before."""
        receipt = {"victim": victim_name, "live": 0, "migrated": 0,
                   "resubmitted": 0, "failed": 0}
        if not self.enable:
            return receipt
        by_name = dict(dests)
        for slot in range(victim.slots):
            r = victim.requests[slot]
            if r is None:
                continue
            receipt["live"] += 1
            prompt = victim._prompts[slot] or []
            order = self.destination_order(prompt, [n for n, _ in dests])
            ranked = [(n, by_name[n]) for n in order]
            moved = self.migrate_stream(victim, slot, victim_name, ranked)
            if moved is None:
                receipt["failed"] += 1
            elif victim.requests[slot] is None and r.tokens:
                receipt["migrated"] += 1
            else:
                receipt["resubmitted"] += 1
        return receipt

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        from ..utils.stats import percentiles
        with self._lock:
            return {
                "enable": self.enable,
                "timeout_s": self.timeout_s,
                "max_inflight": self.max_inflight,
                "started": self.started,
                "migrated": self.migrated,
                "resubmitted": self.resubmitted,
                "failed": self.failed,
                "pause_ms": percentiles(list(self.pause_ms)),
                "moves": list(self.moves[-32:]),
            }


# ------------------------------------------------------------ the receiver


class MigrateReceiver:
    """The destination's front door for drains across processes: one
    engine behind ``POST /v1/migrate`` taking a raw DECSTATE frame.
    Exactly ONE request runs the engine at a time. A full pool or no free
    slot is a 503 (the manager tries the next survivor); a frame that
    fails verification or the engine's validation is a 400 holding zero
    pages; any other import failure is a 500. Serves plain HTTP (see the
    module doc)."""

    def __init__(self, engine, port: int = 0, host: str = "0.0.0.0",
                 trace_store=None):
        self.engine = engine
        self._lock = threading.Lock()
        self.tracer = Tracer("migrate", trace_store)
        receiver = self

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
                    st = receiver.engine.page_stats()
                    self._json(200, {"ok": True, "role": "migrate",
                                     "pages_free": st["pages_free"],
                                     "migrated_in": st["migrated_in"],
                                     "migrated_out": st["migrated_out"]})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/v1/migrate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(n)
                ctx = parse_header(self.headers.get(TRACE_HEADER))
                t0 = time.perf_counter()
                try:
                    state = unpack_decstate(data)
                except DecStateError as e:
                    self._json(400, {"error": str(e)})
                    return
                try:
                    with receiver._lock:
                        slot = receiver.engine.import_stream(
                            state, request_id=state.get("request_id"))
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:
                    self._json(500, {"error": f"import failed: {e}"})
                    return
                if slot is None:
                    self._json(503, {"error": "pages exhausted"})
                    return
                if ctx is not None:
                    receiver.tracer.record(
                        "migrate.import", t0, time.perf_counter(),
                        parent=ctx, generated=len(state["tokens"]))
                self._json(200, {"ok": True, "slot": int(slot),
                                 "generated": len(state["tokens"])})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MigrateReceiver":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="migrate-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)


# ----------------------------------------------------------------- env knobs


def manager_from_env(env: Optional[dict] = None, **kw) -> MigrationManager:
    """A :class:`MigrationManager` from the ``MIGRATE_*`` env contract:
    ``MIGRATE_ENABLE`` (default on), ``MIGRATE_TIMEOUT_S`` (each stream's
    freeze-to-resume budget), ``MIGRATE_MAX_INFLIGHT`` (concurrent
    drains)."""
    import os
    e = os.environ if env is None else env
    enable = (e.get("MIGRATE_ENABLE") or "1").strip().lower() not in (
        "0", "false", "no", "off")
    timeout = float(e.get("MIGRATE_TIMEOUT_S") or 30.0)
    inflight = int(float(e.get("MIGRATE_MAX_INFLIGHT") or 2))
    return MigrationManager(enable=enable, timeout_s=timeout,
                            max_inflight=inflight, **kw)
