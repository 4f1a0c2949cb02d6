"""Back-pressure signal of the serving fleet (a copy of ``backpressure``
in ``dcos_commons_tpu/scheduler/elastic.py``; the rest of that module,
the autoscaler, the preemptor and the backfill gate, is not ported).
``models.router`` collapses each replica's ``/v1/healthz`` load gauges
through it into the pressure that decides hot spill and least-loaded
placement."""

from __future__ import annotations

from typing import Optional


def backpressure(gauges: dict, ttft_slo_ms: Optional[float] = None) -> float:
    """Collapse a ``ServingFrontend.load_gauges()`` dict into one pressure
    scalar in [0, 1]: the max over the individual signals, because any
    single saturated resource is enough to degrade serving:

    * shedding (rejected requests in the window) pins pressure to 1.0:
      the queue already overflowed, scaling is overdue;
    * queue fill: ``queue_depth / queue_capacity``;
    * KV-page occupancy: ``1 - pages_free / pages_total`` (paged engines
      admit on pages, so this is the real utilization signal);
    * TTFT p95 against the SLO (when one is configured): crossing the SLO
      reads as high pressure even before the queue backs up;
    * host-tier occupancy, half-weighted: a full host tier
      (``kv_tier_host_pages / kv_tier_host_capacity``) means cold
      prefixes are already spilling to disk, a leading indicator worth
      pressure 0.5 but never a scale-up on its own (untiered replicas
      report no tier keys and are unaffected).
    """
    p = 0.0
    cap = gauges.get("queue_capacity") or 0
    if cap:
        p = max(p, min(1.0, gauges.get("queue_depth", 0) / cap))
    if gauges.get("shed", 0) > 0:
        p = 1.0
    total = gauges.get("pages_total") or 0
    if total:
        free = gauges.get("pages_free", total)
        p = max(p, min(1.0, 1.0 - free / total))
    host_cap = gauges.get("kv_tier_host_capacity") or 0
    if host_cap:
        fill = gauges.get("kv_tier_host_pages", 0) / host_cap
        p = max(p, 0.5 * min(1.0, fill))
    ttft = gauges.get("ttft_p95_ms")
    if ttft_slo_ms and ttft is not None:
        p = max(p, min(1.0, 0.8 * ttft / ttft_slo_ms))
    return p
