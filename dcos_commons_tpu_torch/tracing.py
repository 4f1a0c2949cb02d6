"""Request tracing: trace and span ids over the serving HTTP hops (a copy
of ``dcos_commons_tpu/tracing.py`` without the Chrome trace export).

Hops propagate identity over HTTP through one header::

    X-Tpu-Trace: <trace_id>-<span_id>

where ``span_id`` is the caller's span, becoming the callee's parent.
Spans (name, service, epoch start, duration, attributes) land in a
bounded per-process ring of whole traces. Ids come from
:func:`os.urandom`, never from ``random``, so tracing perturbs no seeded
draw. Span starts come from ``time.perf_counter()`` through one
per-process offset, so spans recorded retrospectively from stored stamps
(the front door's path) interleave monotonically with live ones. A span
marked ``terminal=True`` ends its trace.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import List, Optional

TRACE_HEADER = "X-Tpu-Trace"

# one per-process perf_counter -> epoch offset: every span start computed
# as _EPOCH0 + perf_counter() is monotone w.r.t. every other span in the
# process, live or retrospective
_EPOCH0 = time.time() - time.perf_counter()


def perf_to_epoch(t_perf: float) -> float:
    """Map a ``time.perf_counter()`` stamp onto the process epoch line."""
    return _EPOCH0 + t_perf


def new_id() -> str:
    """64-bit hex id from the OS entropy pool (RNG-neutral by design)."""
    return os.urandom(8).hex()


class TraceContext:
    """Immutable (trace_id, span_id) pair — what crosses a hop."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def header(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, {self.span_id})"


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """``<trace_id>-<span_id>`` -> context; None/garbage -> None."""
    if not value:
        return None
    trace_id, sep, span_id = value.strip().partition("-")
    if not sep or not trace_id or not span_id:
        return None
    if not all(c in "0123456789abcdef" for c in trace_id + span_id):
        return None
    return TraceContext(trace_id, span_id)


class Span:
    """One recorded operation. ``t_start`` is epoch seconds; ``dur_s`` the
    duration. ``terminal`` marks the end of the whole trace."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "t_start", "dur_s", "attrs", "terminal", "status")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, service: str, t_start: float, dur_s: float,
                 attrs: Optional[dict] = None, terminal: bool = False,
                 status: str = "ok"):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.t_start = t_start
        self.dur_s = dur_s
        self.attrs = attrs or {}
        self.terminal = terminal
        self.status = status

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "service": self.service,
            "t_start": round(self.t_start, 6),
            "dur_s": round(self.dur_s, 6),
            "attrs": self.attrs, "terminal": self.terminal,
            "status": self.status,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(d["trace_id"], d["span_id"], d.get("parent_id"),
                   d["name"], d.get("service", "?"),
                   float(d["t_start"]), float(d["dur_s"]),
                   dict(d.get("attrs") or {}), bool(d.get("terminal")),
                   d.get("status", "ok"))


class TraceStore:
    """Bounded per-process span store: a ring over whole traces. When the
    span budget is exceeded the *oldest trace* is evicted wholesale (an
    LRU over trace ids), so a retained trace is never half a trace."""

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._capacity = max(1, capacity)
        self._spans = 0
        # trace_id -> list of spans, insertion-ordered for eviction
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()
        # maintained incrementally: a poller of incomplete traces would
        # otherwise scan every retained span, O(capacity) per poll
        self._incomplete: set = set()

    def add(self, span: Span) -> None:
        with self._lock:
            bucket = self._traces.get(span.trace_id)
            if bucket is None:
                bucket = self._traces[span.trace_id] = []
                self._incomplete.add(span.trace_id)
            bucket.append(span)
            if span.terminal:
                self._incomplete.discard(span.trace_id)
            self._spans += 1
            while self._spans > self._capacity and len(self._traces) > 1:
                tid, evicted = self._traces.popitem(last=False)
                self._incomplete.discard(tid)
                self._spans -= len(evicted)

    def spans(self, trace_id: str) -> List[Span]:
        with self._lock:
            bucket = list(self._traces.get(trace_id, ()))
        return sorted(bucket, key=lambda s: (s.t_start, s.span_id))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def complete(self, trace_id: str) -> bool:
        """A trace is complete once any of its spans is terminal."""
        with self._lock:
            return (trace_id in self._traces
                    and trace_id not in self._incomplete)

    def incomplete_trace_ids(self) -> List[str]:
        """Retained traces that never reached a terminal span (served as
        ``incomplete`` on ``/v1/traces``)."""
        with self._lock:
            return list(self._incomplete)

    def export(self, trace_id: str) -> dict:
        return {"trace_id": trace_id,
                "complete": self.complete(trace_id),
                "spans": [s.to_dict() for s in self.spans(trace_id)]}

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._incomplete.clear()
            self._spans = 0

    def __len__(self) -> int:
        with self._lock:
            return self._spans


# the default process-wide store: every tier in one process shares it,
# so one /v1/trace endpoint can return a whole cross-tier trace
GLOBAL_STORE = TraceStore()


class _ActiveSpan:
    """Context manager for a live span. ``.ctx`` is what children parent
    to (and what ``header()`` serializes for the next hop)."""

    __slots__ = ("_tracer", "name", "ctx", "parent_id", "terminal",
                 "attrs", "_t0", "status")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 parent_id: Optional[str], terminal: bool, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.terminal = terminal
        self.attrs = attrs
        self.status = "ok"
        self._t0 = time.perf_counter()

    def header(self) -> str:
        return self.ctx.header()

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "_ActiveSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.status == "ok":
            self.status = "error"
        self.end()

    def end(self) -> None:
        t1 = time.perf_counter()
        self._tracer.store.add(Span(
            self.ctx.trace_id, self.ctx.span_id, self.parent_id,
            self.name, self._tracer.service,
            perf_to_epoch(self._t0), t1 - self._t0,
            self.attrs, self.terminal, self.status))


class Tracer:
    """Per-component span factory bound to one service label and one
    store (the process-global one unless a private store is injected —
    tests use private stores for isolation)."""

    def __init__(self, service: str, store: Optional[TraceStore] = None):
        self.service = service
        self.store = store if store is not None else GLOBAL_STORE

    def start(self, name: str, parent: Optional[TraceContext] = None,
              terminal: bool = False, **attrs) -> _ActiveSpan:
        """Open a live span; a fresh trace id is minted when there is no
        parent (this hop is the trace root)."""
        trace_id = parent.trace_id if parent else new_id()
        ctx = TraceContext(trace_id, new_id())
        return _ActiveSpan(self, name, ctx,
                           parent.span_id if parent else None,
                           terminal, dict(attrs))

    def record(self, name: str, t0_perf: float, t1_perf: float,
               parent: Optional[TraceContext] = None,
               terminal: bool = False, status: str = "ok",
               **attrs) -> TraceContext:
        """Record a span retrospectively from two ``perf_counter`` stamps
        (the ingress path stores stamps and emits spans at completion).
        Returns the new span's context for chaining children."""
        trace_id = parent.trace_id if parent else new_id()
        ctx = TraceContext(trace_id, new_id())
        self.store.add(Span(
            trace_id, ctx.span_id, parent.span_id if parent else None,
            name, self.service, perf_to_epoch(t0_perf),
            max(0.0, t1_perf - t0_perf), dict(attrs), terminal, status))
        return ctx
