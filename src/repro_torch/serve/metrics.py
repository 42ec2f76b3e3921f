"""The metric instruments the serving router records into: the port's copy
of the JAX package's `core/metrics.py` `Histogram` and `MetricsRegistry`,
with the bucket bounds of the router's two histograms.

Histograms use fixed log-spaced bucket bounds (per-bucket counts, sum,
count), the same for every histogram of one name. `Histogram.quantile(q)`
returns the upper bound of the bucket holding the q-th order statistic:
never below the exact sample and at most one bucket above it. `MetricsRegistry` keys instruments by
(name, labels); a histogram's bounds come from `BOUNDS_BY_NAME`.

A copy, not an import: the port imports nothing of the JAX package, even
where a module of it has no JAX in it.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Tuple


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds: lo, lo*factor, ... >= hi.
    Fixed (not adaptive) so every producer of a histogram name shares
    the same bounds."""
    assert lo > 0 and factor > 1.0 and hi >= lo
    out = [float(lo)]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


# seconds (1 ms .. ~1.1 h) and queue depths
TIME_BUCKETS = log_buckets(0.001, 4096.0)
DEPTH_BUCKETS = log_buckets(0.25, 4096.0)

BOUNDS_BY_NAME: Dict[str, Tuple[float, ...]] = {
    "syndeo_router_queue_depth": DEPTH_BUCKETS,
    "syndeo_router_shed_depth": DEPTH_BUCKETS,
}


class Counter:
    """Monotone counter. `inc` only; exported value is `.value`."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        assert n >= 0, "counters are monotone"
        self.value += n


class Gauge:
    """Point-in-time value; `set` replaces, `add` adjusts."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def add(self, dv: float):
        self.value += float(dv)


class Histogram:
    """Fixed-bound log-bucket histogram.

    `counts[i]` counts observations v with v <= bounds[i] (and
    > bounds[i-1]); `counts[-1]` is the overflow bucket."""

    __slots__ = ("bounds", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, bounds: Tuple[float, ...] = TIME_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        assert list(self.bounds) == sorted(set(self.bounds)), \
            "histogram bounds must be strictly increasing"
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def bucket_index(self, v: float) -> int:
        return bisect.bisect_left(self.bounds, float(v))

    def observe(self, v: float):
        self.counts[self.bucket_index(v)] += 1
        self.sum += float(v)
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-bounded quantile estimate: the upper bound of the bucket
        containing the ceil(q*count)-th order statistic (overflow clamps to
        the top bound)."""
        if self.count <= 0:
            return 0.0
        rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]


class MetricsRegistry:
    """Instruments keyed by (name, sorted label items). Thread-safe
    lookup; instrument mutation is GIL-atomic dict/int work."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Dict[Tuple[Tuple[str, str], ...], Any]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str],
             factory: Callable[[], Any]):
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.setdefault(name, {})
            inst = fam.get(key)
            if inst is None:
                inst = fam[key] = factory()
            assert inst.kind == kind, f"metric {name!r} is a {inst.kind}, not a {kind}"
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, bounds: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        b = bounds or BOUNDS_BY_NAME.get(name, TIME_BUCKETS)
        return self._get("histogram", name, labels, lambda: Histogram(b))

    def family(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], Any]:
        with self._lock:
            return dict(self._families.get(name, {}))

    def samples(self) -> Iterable[Tuple[str, Dict[str, str], Any]]:
        with self._lock:
            flat = [(name, key, inst)
                    for name, fam in sorted(self._families.items())
                    for key, inst in sorted(fam.items())]
        for name, key, inst in flat:
            yield name, dict(key), inst
