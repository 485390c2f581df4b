"""Process-wide telemetry state: the on/off switch, the default registry,
attached registries, and sinks (a copy of ``repro/telemetry/_runtime.py``;
the one switch that the accessors, the span trace and the detectors
read).

Telemetry is **default-on** (recording into in-process state costs ~a
microsecond per call); ``REPRO_TELEMETRY=0`` in the environment flips the
whole surface to the shared no-op fast path before anything records.
``set_enabled`` flips it at runtime (the overhead benchmark and the
on-vs-off parity tests use this).

The switch gates *recording through the module-level accessors* — a
standalone :class:`~repro_torch.telemetry.registry.Registry` instance keeps
working regardless (serve's ``EngineStats`` depends on that).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.telemetry.registry import (ConsoleSink, JsonlSink, Registry,
                                      NOOP)


def _env_enabled() -> bool:
    return os.environ.get("REPRO_TELEMETRY", "1") not in ("0", "off", "false")


@dataclass
class TelemetryConfig:
    """Opt-in knobs beyond the on/off switch. ``grad_norm`` adds a global
    gradient-norm to the train-step metrics — an *in-graph* op, so it is
    off by default (the host-side-only rule) and only honored when a user
    asks (env ``REPRO_TELEMETRY_GRADNORM=1`` or ``configure``).
    ``profile`` gates per-program cost attribution
    (:mod:`repro_torch.telemetry.profile`) — default on, host-side only; env
    ``REPRO_TELEMETRY_PROFILE=0`` turns just the attribution off."""
    grad_norm: bool = False
    profile: bool = True


class _State:
    def __init__(self):
        self.enabled = _env_enabled()
        self.registry = Registry()
        self.extra: list = []          # (registry) attached for export
        self.config = TelemetryConfig(
            grad_norm=os.environ.get("REPRO_TELEMETRY_GRADNORM", "0")
            not in ("0", ""),
            profile=os.environ.get("REPRO_TELEMETRY_PROFILE", "1")
            not in ("0", "off", "false"))


_state = _State()


def enabled() -> bool:
    return _state.enabled


def set_enabled(on: bool) -> None:
    _state.enabled = bool(on)


def config() -> TelemetryConfig:
    return _state.config


def default_registry() -> Registry:
    """The live default registry — independent of the enabled switch (the
    accessors in :mod:`repro_torch.telemetry.metrics` do the gating)."""
    return _state.registry


def attach_registry(reg: Registry) -> None:
    """Include a standalone registry (e.g. a serve engine's) in
    ``flush``/``dump_metrics`` output."""
    if reg not in _state.extra and reg is not _state.registry:
        _state.extra.append(reg)


def detach_registry(reg: Registry) -> None:
    if reg in _state.extra:
        _state.extra.remove(reg)


def all_registries() -> list:
    return [_state.registry] + list(_state.extra)


def add_sink(sink) -> None:
    _state.registry.add_sink(sink)


def configure(metrics_out: str | None = None,
              console_every: float | None = None,
              grad_norm: bool | None = None,
              profile: bool | None = None) -> None:
    """Launcher-facing setup: attach a JSONL sink and/or a periodic console
    summary to the default registry, set opt-in knobs."""
    if metrics_out:
        add_sink(JsonlSink(metrics_out))
    if console_every is not None:
        add_sink(ConsoleSink(every_s=console_every))
    if grad_norm is not None:
        _state.config.grad_norm = bool(grad_norm)
    if profile is not None:
        _state.config.profile = bool(profile)


def flush(force: bool = False) -> None:
    """Push snapshots of the default registry to its sinks. Attached
    registries ride along: their records are merged into the default
    registry's sink stream."""
    reg = _state.registry
    if not reg._sinks:
        return
    from repro_torch.telemetry import profile
    profile.emit(reg)       # refresh per-program attribution gauges
    import time
    records = []
    for r in all_registries():
        records.extend(r.snapshot())
    now = time.time()
    for s in reg._sinks:
        s.emit(records, now, force)


def dump_metrics(path: str, extra=()) -> None:
    """Write one full snapshot of the default + attached (+ ``extra``)
    registries as schema'd JSONL with a leading run record."""
    import json

    from repro_torch.telemetry import profile
    from repro_torch.telemetry.schema import run_record
    profile.emit(_state.registry)
    regs = all_registries() + [r for r in extra
                               if r not in all_registries()]
    with open(path, "w") as f:
        f.write(json.dumps(run_record()) + "\n")
        for r in regs:
            for rec in r.snapshot():
                f.write(json.dumps(rec) + "\n")


def reset() -> None:
    """Drop all recorded state (tests). Keeps the enabled flag."""
    from repro_torch.telemetry import profile
    _state.registry.close()
    _state.registry = Registry()
    _state.extra = []
    profile.reset()


__all__ = ["enabled", "set_enabled", "config", "configure",
           "default_registry", "attach_registry", "detach_registry",
           "all_registries", "add_sink", "flush", "dump_metrics", "reset",
           "TelemetryConfig", "NOOP"]
