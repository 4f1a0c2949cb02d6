"""Percentile picks for the serving front door's latency windows (a copy
of ``percentiles`` in ``dcos_commons_tpu/utils/stats.py``)."""

from __future__ import annotations

from typing import Dict, List, Sequence


def percentiles(values: Sequence[float],
                qs: Sequence[float] = (0.50, 0.95, 0.99),
                ndigits: int = 3) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., ...} over ``values`` (empty -> {}).
    Upper-index pick: pessimistic on small samples, which is the right
    bias for latency reporting."""
    if not values:
        return {}
    xs: List[float] = sorted(values)

    def pick(q: float) -> float:
        return round(xs[min(len(xs) - 1, int(q * len(xs)))], ndigits)

    return {f"p{int(q * 100)}": pick(q) for q in qs}
