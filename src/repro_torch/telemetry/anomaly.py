"""Online step-time anomaly detection: EWMA + rolling-MAD detectors (a
copy of ``repro/telemetry/anomaly.py``, pinned to it by
``tests/test_torch_telemetry.py``).

Two detectors, both host-side, O(1) memory, and silent when telemetry is
off:

- :class:`StreamDetector` watches ONE scalar stream (per-step wall time)
  for **spikes** (one observation far outside the recent distribution)
  and **regressions** (a sustained shift of the level). Spikes use a
  robust z-score against a rolling median/MAD window — median absolute
  deviation is outlier-proof where a stddev would be dragged by the very
  spikes it should flag. Regressions compare a fast EWMA against a slow
  EWMA baseline: ``fast > slow * (1 + tol)`` for ``patience`` consecutive
  observations fires once, then the baseline re-anchors so a permanent
  shift is reported once, not forever.

      z = (x - median) / (1.4826 * MAD + eps)

  (1.4826 scales MAD to the stddev of a normal distribution.)

- :class:`FleetDetector` watches per-worker durations *cross-sectionally*
  (one observation per worker per step) and flags stragglers relative to
  the fleet median: worker w is flagged when ``d_w > max(rel * median,
  median + z * 1.4826 * MAD)``. The relative-factor arm makes the
  decision exact when the non-straggling workers tie (MAD = 0 — the
  simulated elastic loop's case), which keeps the feedback into
  ``MembershipController`` deterministic and replays bit-identical.

Every firing increments an ``anomaly/*`` counter and drops a trace
instant, so Perfetto shows *when* the step stream went bad next to the
spans that show *where* the time went.
"""
from __future__ import annotations

from collections import deque
from statistics import median

from repro_torch.telemetry import _runtime, metrics, trace

# MAD -> stddev scale for a normal distribution
_MAD_K = 1.4826
_EPS = 1e-12


def _slug(name: str) -> str:
    return name.replace("/", "_")


class StreamDetector:
    """Spike + regression detection over one scalar stream.

    ``observe(x)`` returns ``{"spike": bool, "regression": bool, "z": f}``
    and records ``anomaly/<stream>/spikes`` / ``.../regressions`` counters
    plus trace instants on firings. Pass ``registry`` to record into a
    standalone registry (serve's always-live ``EngineStats``); default is
    the process-wide one via the gated accessors.
    """

    def __init__(self, name: str, *, window: int = 64, min_n: int = 8,
                 spike_z: float = 8.0, regress_tol: float = 0.5,
                 patience: int = 5, alpha_fast: float = 0.3,
                 alpha_slow: float = 0.03, registry=None):
        self.name = name
        self.window: deque = deque(maxlen=window)
        self.min_n = min_n
        self.spike_z = spike_z
        self.regress_tol = regress_tol
        self.patience = patience
        self.alpha_fast = alpha_fast
        self.alpha_slow = alpha_slow
        self.ewma_fast: float | None = None
        self.ewma_slow: float | None = None
        self._over = 0          # consecutive observations above the band
        self.spikes = 0
        self.regressions = 0
        self._registry = registry

    def _counter(self, what: str):
        name = f"anomaly/{_slug(self.name)}/{what}"
        if self._registry is not None:
            return self._registry.counter(name)
        return metrics.counter(name)

    def robust_z(self, x: float) -> float:
        if len(self.window) < self.min_n:
            return 0.0
        med = median(self.window)
        mad = median(abs(v - med) for v in self.window)
        return (x - med) / (_MAD_K * mad + _EPS)

    def observe(self, x: float) -> dict:
        x = float(x)
        if not _runtime._state.enabled:
            return {"spike": False, "regression": False, "z": 0.0}
        z = self.robust_z(x)
        spike = z > self.spike_z
        if spike:
            self.spikes += 1
            self._counter("spikes").inc()
            trace.instant("anomaly/spike", stream=self.name, value=x,
                          z=round(z, 2))
        self.window.append(x)
        a_f, a_s = self.alpha_fast, self.alpha_slow
        self.ewma_fast = (x if self.ewma_fast is None
                          else a_f * x + (1 - a_f) * self.ewma_fast)
        self.ewma_slow = (x if self.ewma_slow is None
                          else a_s * x + (1 - a_s) * self.ewma_slow)
        regression = False
        if (len(self.window) >= self.min_n
                and self.ewma_fast > self.ewma_slow * (1 + self.regress_tol)):
            self._over += 1
            if self._over >= self.patience:
                regression = True
                self.regressions += 1
                self._counter("regressions").inc()
                trace.instant("anomaly/regression", stream=self.name,
                              ewma_fast=self.ewma_fast,
                              ewma_slow=self.ewma_slow)
                # re-anchor: a sustained shift reports once, not every step
                self.ewma_slow = self.ewma_fast
                self._over = 0
        else:
            self._over = 0
        return {"spike": spike, "regression": regression, "z": z}


class FleetDetector:
    """Cross-sectional straggler detection over per-worker durations.

    ``observe({worker: seconds})`` returns the workers flagged this round.
    A worker is a straggler when its duration exceeds BOTH arms of

        max(rel_thresh * median,  median + spike_z * 1.4826 * MAD)

    evaluated over the fleet — i.e. it must be a large *relative* outlier
    (robust to the MAD collapsing to 0 when the rest of the fleet ties)
    AND far in robust-z terms when there is spread. ``patience``
    consecutive flagged rounds are required before a worker is reported
    (default 1: flag immediately).
    """

    def __init__(self, *, rel_thresh: float = 3.0, spike_z: float = 6.0,
                 min_workers: int = 3, patience: int = 1):
        self.rel_thresh = rel_thresh
        self.spike_z = spike_z
        self.min_workers = min_workers
        self.patience = patience
        self._streak: dict = {}
        self.flagged_total = 0

    def observe(self, durations: dict) -> list:
        if not _runtime._state.enabled or len(durations) < self.min_workers:
            return []
        vals = list(durations.values())
        med = median(vals)
        mad = median(abs(v - med) for v in vals)
        cut = max(self.rel_thresh * med, med + self.spike_z * _MAD_K * mad)
        out = []
        for w, d in durations.items():
            if d > cut and med > 0:
                streak = self._streak.get(w, 0) + 1
                self._streak[w] = streak
                if streak >= self.patience:
                    out.append(w)
            else:
                self._streak[w] = 0
        self.flagged_total += len(out)
        return sorted(out)
