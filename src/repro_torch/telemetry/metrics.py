"""Module-level metric accessors against the default registry (a copy of
``repro/telemetry/metrics.py``).

    from repro_torch.telemetry import metrics
    metrics.counter("exchange/bytes_wire").inc(n)
    metrics.histogram("train/step_time_s").observe(dt)
    metrics.gauge("serve/page_occupancy").set(k)

When telemetry is disabled every accessor returns the shared
:data:`~repro_torch.telemetry.registry.NOOP` object — the hot path then costs
one function call and one flag test, and allocates nothing. Instrument
sites may cache handles, but a handle fetched while disabled stays a
no-op; fetch at use or after enabling.
"""
from __future__ import annotations

from repro_torch.telemetry import _runtime
from repro_torch.telemetry.registry import NOOP


def counter(name: str):
    if not _runtime._state.enabled:
        return NOOP
    return _runtime._state.registry.counter(name)


def gauge(name: str):
    if not _runtime._state.enabled:
        return NOOP
    return _runtime._state.registry.gauge(name)


def histogram(name: str, buckets=None):
    if not _runtime._state.enabled:
        return NOOP
    return _runtime._state.registry.histogram(name, buckets=buckets)


def info(name: str, **labels):
    if not _runtime._state.enabled:
        return NOOP
    return _runtime._state.registry.info(name, **labels)


def get(name: str):
    """Read back a recorded metric (None if absent)."""
    reg = _runtime._state.registry
    return reg[name] if name in reg else None
