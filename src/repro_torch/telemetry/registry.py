"""Process-local metrics registry: counters, gauges, histograms.

A copy of ``repro/telemetry/registry.py`` (pure Python; pinned to the
original by ``tests/test_torch_host.py``) with the three metric kinds the
serve engine records. The sinks, ``Info`` labels and the disabled-path
``NOOP`` come with the telemetry slice (their export needs the schema
module).

- **Bounded memory.** A histogram is a fixed vector of bucket counts plus
  count/sum/min/max — never a list of observations.
- **Host-side only.** Metrics take plain Python numbers; device values
  are converted by the caller.
- A :class:`Registry` instance is always live
  (``repro_torch.serve.EngineStats`` owns one regardless of the global
  switch, because its public stats must work with telemetry off).

Metric names are ``area/quantity[_unit]`` (``serve/ttft_s``).
"""
from __future__ import annotations

import math
import time
from bisect import bisect_right

SCHEMA_VERSION = 1       # the record schema of repro.telemetry.schema


def exp_buckets(lo: float, hi: float, per_decade: int = 8) -> tuple:
    """Log-spaced bucket boundaries covering [lo, hi]."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi (got {lo}, {hi})")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


# default boundaries for wall-clock seconds: 10us .. 100s, 8 per decade
TIME_BUCKETS = exp_buckets(1e-5, 100.0, 8)


class Counter:
    """Monotone accumulator (``inc``); value is a plain number."""
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": "counter", "name": self.name, "value": self.value}


class Gauge:
    """Last-write-wins value (``set``)."""
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Fixed-boundary histogram: ``len(bounds) + 1`` counts (the last bin
    is the +inf overflow), plus count/sum/min/max. Percentiles are read
    back by linear interpolation inside the resolved bucket — accurate to
    one bucket width (tested against numpy in ``tests/test_telemetry.py``).
    """
    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")
    kind = "histogram"

    def __init__(self, name: str, buckets=None):
        self.name = name
        self.bounds = tuple(float(b) for b in (buckets or TIME_BUCKETS))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"bucket boundaries must ascend: {name}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Interpolated percentile (q in [0, 100]) from the bucket counts."""
        if not self.count:
            return 0.0
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self.max

    def percentiles(self, qs=(50, 99)) -> dict:
        return {q: self.percentile(q) for q in qs}

    def snapshot(self) -> dict:
        return {"kind": "histogram", "name": self.name, "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "bounds": list(self.bounds), "counts": list(self.counts)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """A named collection of metrics.

    Accessors are get-or-create and type-checked: asking for an existing
    name with a different kind is a bug, not a silent new metric.
    Standalone instances (e.g. per serve engine) are cheap.
    """

    def __init__(self, label: str = ""):
        self.label = label
        self._metrics: dict = {}

    def _get(self, name: str, kind: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = _KINDS[kind](name, **kw)
            self._metrics[name] = m
        elif m.kind != kind:
            raise TypeError(f"metric {name!r} is a {m.kind}, not a {kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str, buckets=None) -> Histogram:
        h = self._metrics.get(name)
        if h is not None and h.kind == "histogram":
            return h
        return self._get(name, "histogram", buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> list:
        return sorted(self._metrics)

    def snapshot(self, ts: float | None = None) -> list:
        """One record per metric, as the JAX package's registry writes."""
        ts = time.time() if ts is None else ts
        out = []
        for name in sorted(self._metrics):
            rec = self._metrics[name].snapshot()
            rec["schema_version"] = SCHEMA_VERSION
            rec["ts"] = ts
            if self.label:
                rec["reg"] = self.label
            out.append(rec)
        return out
