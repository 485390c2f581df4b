"""Process-local metrics registry: counters, gauges, histograms, sinks.

A copy of ``repro/telemetry/registry.py`` (pure Python; pinned to the
original by ``tests/test_torch_host.py`` and
``tests/test_torch_telemetry.py``). Design rules:

- **Bounded memory.** A histogram is a fixed vector of bucket counts plus
  count/sum/min/max — never a list of observations. Long-running servers
  and training loops record into O(1) state per metric.
- **Host-side only.** Nothing here touches the device; metrics take plain Python
  numbers. Instrumentation sites convert device values explicitly (and
  only at flush boundaries, never per hot-path call).
- **Cheap when off.** The module-level accessors in
  :mod:`repro_torch.telemetry.metrics` return the shared :data:`NOOP` object
  when telemetry is disabled — recording into it is one attribute lookup
  and a ``pass``. A :class:`Registry` instance itself is always live
  (``repro_torch.serve.EngineStats`` owns one regardless of the global switch,
  because its public stats must work with telemetry off).

Metric names are ``area/quantity[_unit]`` (``train/step_time_s``,
``exchange/bytes_wire``, ``serve/ttft_s``) — the flat namespace the JSONL
schema and the Perfetto traces share.
"""
from __future__ import annotations

import json
import math
import time
from bisect import bisect_right


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


class Info:
    """Static string labels (strategy names, dtypes, versions)."""
    __slots__ = ("name", "labels")
    kind = "info"

    def __init__(self, name: str):
        self.name = name
        self.labels = {}

    def set(self, **labels) -> None:
        self.labels.update({k: str(v) for k, v in labels.items()})

    def snapshot(self) -> dict:
        return {"kind": "info", "name": self.name, "labels": dict(self.labels)}


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


class _Noop:
    """The disabled-path metric: every recording call is a no-op and every
    accessor is a constant. One shared instance (:data:`NOOP`) is returned
    for *all* metric kinds so the off path allocates nothing per call."""
    __slots__ = ()
    kind = "noop"
    name = "noop"
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, n=1):
        pass

    def set(self, *a, **kw):
        pass

    def observe(self, v):
        pass

    def percentile(self, q):
        return 0.0

    def percentiles(self, qs=(50, 99)):
        return {q: 0.0 for q in qs}


NOOP = _Noop()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "info": Info}


class Registry:
    """A named collection of metrics with attachable sinks.

    Accessors are get-or-create and type-checked: asking for an existing
    name with a different kind is a bug, not a silent new metric. The
    default process-wide registry lives in :mod:`repro_torch.telemetry._runtime`;
    standalone instances (e.g. per serve engine) are cheap.
    """

    def __init__(self, label: str = ""):
        self.label = label
        self._metrics: dict = {}
        self._sinks: list = []

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

    def info(self, name: str, **labels) -> Info:
        m = self._get(name, "info")
        if labels:
            m.set(**labels)
        return m

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> list:
        return sorted(self._metrics)

    def snapshot(self, ts: float | None = None) -> list:
        """One schema record per metric (see ``repro_torch.telemetry.schema``)."""
        from repro_torch.telemetry.schema import SCHEMA_VERSION
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

    # -- sinks --------------------------------------------------------------

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def flush(self, force: bool = True) -> None:
        """Push a full snapshot to every sink (periodic sinks may skip when
        not ``force`` and their interval has not elapsed)."""
        if not self._sinks:
            return
        records = self.snapshot()
        now = time.time()
        for s in self._sinks:
            s.emit(records, now, force)

    def close(self) -> None:
        self.flush(force=True)
        for s in self._sinks:
            s.close()
        self._sinks = []


class MemorySink:
    """Keeps every flushed snapshot — the test sink."""

    def __init__(self):
        self.snapshots: list = []

    def emit(self, records, now, force) -> None:
        self.snapshots.append(records)

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one JSON line per metric per flush. The file opens lazily
    and starts with a ``run`` header record (host/device/backend context)
    so any JSONL is self-describing."""

    def __init__(self, path: str, every_s: float = 0.0):
        self.path = path
        self.every_s = every_s
        self._f = None
        self._last = 0.0

    def _open(self):
        if self._f is None:
            from repro_torch.telemetry.schema import run_record
            self._f = open(self.path, "w")
            self._f.write(json.dumps(run_record()) + "\n")
        return self._f

    def emit(self, records, now, force) -> None:
        if not force and self.every_s and now - self._last < self.every_s:
            return
        self._last = now
        f = self._open()
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ConsoleSink:
    """Periodic one-line summaries of scalar metrics (counters/gauges and
    histogram count/mean) — the human tail -f."""

    def __init__(self, print_fn=print, every_s: float = 30.0):
        self.print_fn = print_fn
        self.every_s = every_s
        self._last = 0.0

    def emit(self, records, now, force) -> None:
        if not force and self.every_s and now - self._last < self.every_s:
            return
        self._last = now
        parts = []
        for r in records:
            if r["kind"] == "counter":
                parts.append(f"{r['name']}={r['value']}")
            elif r["kind"] == "gauge":
                parts.append(f"{r['name']}={r['value']:.4g}")
            elif r["kind"] == "histogram" and r["count"]:
                parts.append(f"{r['name']}: n={r['count']} "
                             f"mean={r['sum'] / r['count']:.3g}")
        if parts:
            self.print_fn("[telemetry] " + "  ".join(parts))

    def close(self) -> None:
        pass
