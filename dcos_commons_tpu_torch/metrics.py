"""Metrics registry: counters, sampled gauges and latency histograms,
served as JSON and Prometheus text (a copy of the registry in
``dcos_commons_tpu/metrics.py``, without the scheduler's ``record_*``
counters, the StatsD push and ``PlanReporter``). Stdlib-only;
thread-safe.

Timers are fixed-bucket histograms (geometric bounds, factor 2^(1/8) from
100µs to >1000s), so p50/p95/p99 are exact within bucket resolution
(~±4.4% worst case) at O(1) record cost and bounded memory. The same
histograms back the Prometheus ``_bucket{le=...}`` exposition.
"""

from __future__ import annotations

import hashlib
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Tuple

# geometric histogram bounds: 2^(1/8) steps from 100µs up past 1000s.
# Within a bucket the estimate is the geometric midpoint, so the worst
# relative error is factor^(1/2)-1 ~ 4.4% — inside the 10% the serving
# receipts are held to.
_BUCKET_FACTOR = 2.0 ** 0.125
_BUCKET_MIN_S = 1e-4


def _make_bounds() -> Tuple[float, ...]:
    out = [_BUCKET_MIN_S]
    while out[-1] < 1e3:
        out.append(out[-1] * _BUCKET_FACTOR)
    return tuple(out)


BUCKET_BOUNDS: Tuple[float, ...] = _make_bounds()


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def _unique_name(name: str, seen: Dict[str, str]) -> str:
    """Sanitize with collision detection: two raw names mapping onto the
    same Prometheus name would otherwise emit duplicate series (invalid
    exposition); the later one gets a short content-hash suffix."""
    m = _sanitize(name)
    owner = seen.setdefault(m, name)
    if owner == name:
        return m
    m = f"{m}_{hashlib.blake2s(name.encode(), digest_size=4).hexdigest()}"
    seen[m] = name
    return m


class Timer:
    """Cumulative latency histogram (Codahale Timer analogue, upgraded
    from mean/max-only to bucketed percentiles)."""

    __slots__ = ("count", "total_s", "max_s", "min_s", "_buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.min_s = 0.0
        self._buckets: Dict[int, int] = {}   # bound index -> samples

    def record(self, elapsed_s: float) -> None:
        if elapsed_s < 0.0:
            elapsed_s = 0.0
        if self.count == 0 or elapsed_s < self.min_s:
            self.min_s = elapsed_s
        self.count += 1
        self.total_s += elapsed_s
        self.max_s = max(self.max_s, elapsed_s)
        idx = bisect_left(BUCKET_BOUNDS, elapsed_s)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0,1]) from the buckets: the
        geometric midpoint of the bucket holding the q-th sample, clamped
        to the observed [min, max] envelope."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(round(q * self.count)))
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                if idx == 0:
                    est = BUCKET_BOUNDS[0] / (_BUCKET_FACTOR ** 0.5)
                elif idx >= len(BUCKET_BOUNDS):
                    est = self.max_s
                else:
                    lo, hi = BUCKET_BOUNDS[idx - 1], BUCKET_BOUNDS[idx]
                    est = (lo * hi) ** 0.5
                return min(self.max_s, max(self.min_s, est))
        return self.max_s

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """Non-empty ``(upper_bound_s, cumulative_count)`` pairs for the
        Prometheus ``_bucket{le=...}`` series (any monotone subset of the
        bounds is valid exposition; empty buckets are elided)."""
        out: List[Tuple[float, int]] = []
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if idx < len(BUCKET_BOUNDS):
                out.append((BUCKET_BOUNDS[idx], seen))
        return out

    def to_dict(self) -> dict:
        mean = self.total_s / self.count if self.count else 0.0
        return {"count": self.count, "mean_s": round(mean, 6),
                "max_s": round(self.max_s, 6),
                "p50_s": round(self.percentile(0.50), 6),
                "p95_s": round(self.percentile(0.95), 6),
                "p99_s": round(self.percentile(0.99), 6)}


class MetricsRegistry:
    """Process metric registry: counters increment monotonically; gauges
    are sampled callables, read live at export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._timers: Dict[str, Timer] = {}

    def counter(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, supplier: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = supplier

    def observe(self, name: str, elapsed_s: float) -> None:
        """Record one latency sample into the named histogram (the
        serving front door measures TTFT/TPOT from stored stamps, then
        lands them here)."""
        with self._lock:
            self._timers.setdefault(name, Timer()).record(elapsed_s)

    # -- export ------------------------------------------------------------

    def to_dict(self) -> dict:
        # snapshot under the lock, then run user-supplied gauge suppliers
        # outside it: a supplier that touches the registry would deadlock
        # the (non-reentrant) lock, and slow suppliers must not stall the
        # scheduler cycle's counter() calls
        with self._lock:
            suppliers = dict(self._gauges)
            counters = dict(self._counters)
            timers = {n: t.to_dict() for n, t in self._timers.items()}
        gauges = {}
        for name, fn in suppliers.items():
            try:
                gauges[name] = fn()
            except Exception:
                gauges[name] = None
        return {"counters": counters, "gauges": gauges, "timers": timers}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (reference ``/v1/metrics/prometheus``).

        Timers are exported as real histograms (``_bucket{le=...}`` +
        ``_sum`` + ``_count``) with mean/max convenience gauges; every
        series carries a ``# TYPE`` line and sanitized-name collisions are
        de-duplicated with a content-hash suffix."""
        data = self.to_dict()
        with self._lock:
            buckets = {n: (t.cumulative_buckets(), t.count, t.total_s)
                       for n, t in self._timers.items()}
        lines = []
        seen: Dict[str, str] = {}
        for name, value in sorted(data["counters"].items()):
            m = _unique_name(name, seen)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {value}")
        for name, value in sorted(data["gauges"].items()):
            if not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            m = _unique_name(name, seen)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {value}")
        for name, timer in sorted(data["timers"].items()):
            # timers are conventionally named *.<op>_seconds; the unit
            # suffix is re-appended per series, so strip it here rather
            # than exporting ingress_ttft_seconds_seconds
            base = name[:-8] if name.endswith("_seconds") else name
            m = _unique_name(base, seen)
            steps, count, total_s = buckets.get(name, ([], timer["count"],
                                                       0.0))
            lines.append(f"# TYPE {m}_seconds histogram")
            for bound, cum in steps:
                lines.append(
                    f'{m}_seconds_bucket{{le="{bound:.9g}"}} {cum}')
            lines.append(f'{m}_seconds_bucket{{le="+Inf"}} {count}')
            lines.append(f"{m}_seconds_sum {round(total_s, 6)}")
            lines.append(f"{m}_seconds_count {count}")
            lines.append(f"# TYPE {m}_count counter")
            lines.append(f"{m}_count {timer['count']}")
            lines.append(f"# TYPE {m}_mean_seconds gauge")
            lines.append(f"{m}_mean_seconds {timer['mean_s']}")
            lines.append(f"# TYPE {m}_max_seconds gauge")
            lines.append(f"{m}_max_seconds {timer['max_s']}")
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        """Registry teardown. This registry pushes nowhere, so there is
        nothing to release; the front door calls it on the registry it
        owns."""
