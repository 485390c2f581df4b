"""Per-program performance attribution: the ``ProgramProfile`` registry
(counterpart of ``repro/telemetry/profile.py``).

Every hot program (the train step, the local and sync steps of an async
plan, the decode step) gets one :class:`ProgramProfile` that joins

- **measured durations**: the instrument sites (train loop, elastic
  loop) feed per-call wall times via :func:`observe`; the join contract
  is *name equality* with the span that times the program
  (``train/step``, ``train/local``, ``train/sync``, ...);
- **first-call time**: :func:`instrument` times a program's first call
  (synchronising the card when its arguments live there) as a
  ``compile/*`` gauge, and :func:`compile_time` records one directly;
- **cost**: flops and bytes of one run of the program, counted by
  ``roofline.analysis.CostMode`` (aten ops through a dispatch mode, the
  hand kernels through ``kernels.cost``; :func:`capture`). The reference
  reads XLA's ``cost_analysis`` without running the program; an eager
  program has no compiled form, so the port counts a run, and
  :func:`instrument` makes the first call that run: no program runs twice.

The join emits achieved-FLOPs / achieved-bandwidth / MFU gauges against
``roofline.analysis.peaks`` (the card's peaks, env-overridable). The
gauges, the summary and the gating by the telemetry switch plus
``REPRO_TELEMETRY_PROFILE=0`` are the reference's. Capture failures
increment ``profile/capture_errors`` and never break the caller.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.telemetry import _runtime, metrics, trace

_profiles: dict = {}


def enabled() -> bool:
    return _runtime._state.enabled and _runtime._state.config.profile


def _slug(name: str) -> str:
    return name.replace("/", "_")


@dataclass
class ProgramProfile:
    """Cost + measured-duration attribution for one program."""
    name: str
    flops: float = 0.0           # per-device, from capture
    hbm_bytes: float = 0.0       # per-device, pre-fusion bytes accessed
    coll_bytes: float = 0.0      # per-rank analytic wire bytes (caller)
    calls: int = 0
    total_time_s: float = 0.0
    compile_time_s: float = 0.0
    capture_time_s: float = 0.0
    captured: bool = False
    meta: dict = field(default_factory=dict)

    @property
    def mean_time_s(self) -> float:
        return self.total_time_s / self.calls if self.calls else 0.0

    @property
    def achieved_flops_s(self) -> float:
        m = self.mean_time_s
        return self.flops / m if m > 0 else 0.0

    @property
    def achieved_hbm_bw(self) -> float:
        m = self.mean_time_s
        return self.hbm_bytes / m if m > 0 else 0.0

    @property
    def achieved_coll_bw(self) -> float:
        m = self.mean_time_s
        return self.coll_bytes / m if m > 0 else 0.0

    def roofline(self) -> dict:
        """Ratios vs the (env-overridable) peak model; the roofline bound
        time and which term dominates."""
        from repro_torch.roofline.analysis import peaks
        pk = peaks()
        terms = {"compute": self.flops / pk["flops"],
                 "memory": self.hbm_bytes / pk["hbm_bw"],
                 "collective": self.coll_bytes / pk["ici_bw"]}
        return {
            "mfu": self.achieved_flops_s / pk["flops"],
            "hbm_frac": self.achieved_hbm_bw / pk["hbm_bw"],
            "coll_frac": self.achieved_coll_bw / pk["ici_bw"],
            "t_roofline_s": max(terms.values()),
            "bound": max(terms, key=terms.get),
        }

    def gauges(self) -> dict:
        """The metric names/values this profile exports (flat
        ``profile/<program>/<quantity>`` namespace)."""
        s = _slug(self.name)
        out = {}
        if self.captured:
            out[f"profile/{s}/flops"] = self.flops
            out[f"profile/{s}/hbm_bytes"] = self.hbm_bytes
            out[f"profile/{s}/coll_bytes"] = self.coll_bytes
        if self.calls:
            out[f"profile/{s}/calls"] = float(self.calls)
            out[f"profile/{s}/mean_time_s"] = self.mean_time_s
        if self.captured and self.calls:
            rl = self.roofline()
            out[f"profile/{s}/achieved_flops_s"] = self.achieved_flops_s
            out[f"profile/{s}/achieved_hbm_bw"] = self.achieved_hbm_bw
            out[f"profile/{s}/mfu"] = rl["mfu"]
            out[f"profile/{s}/hbm_frac"] = rl["hbm_frac"]
            if self.coll_bytes:
                out[f"profile/{s}/achieved_coll_bw"] = self.achieved_coll_bw
                out[f"profile/{s}/coll_frac"] = rl["coll_frac"]
        return out


def _get(name: str) -> ProgramProfile:
    p = _profiles.get(name)
    if p is None:
        p = _profiles[name] = ProgramProfile(name)
    return p


def get(name: str) -> ProgramProfile | None:
    return _profiles.get(name)


def programs() -> dict:
    return dict(_profiles)


def reset() -> None:
    _profiles.clear()


def _capture_error(prof: ProgramProfile, msg: str) -> None:
    metrics.counter("profile/capture_errors").inc()
    prof.meta["capture_error"] = msg
    prof.captured = False


def _counted(name: str, fn, args, kwargs, coll_bytes):
    """``fn(*args, **kwargs)`` run once under a ``CostMode``; its flops and
    bytes fill the program's profile, and the hand kernels' share and the
    collectives go under ``meta["kernels"]`` / ``meta["collectives"]``.
    Returns fn's output; an exception of fn's own propagates, a fault of
    the counting is a capture error (and fn still runs once)."""
    from repro_torch.roofline.analysis import CostMode
    prof = _get(name)
    t0 = time.perf_counter()
    try:
        mode = CostMode()
        mode.__enter__()
    except Exception as e:  # noqa: BLE001 — attribution never breaks a run
        _capture_error(prof, f"{type(e).__name__}: {e}")
        return fn(*args, **kwargs)
    try:
        out = fn(*args, **kwargs)
    finally:
        mode.__exit__(None, None, None)
    prof.capture_time_s = time.perf_counter() - t0
    if mode.errors:
        _capture_error(prof, f"{mode.errors} ops uncounted, first "
                       f"{mode.first_error}")
        return out
    prof.flops, prof.hbm_bytes = mode.flops, mode.hbm_bytes
    if callable(coll_bytes):
        coll_bytes = coll_bytes(*args, **kwargs)
    prof.coll_bytes = float(coll_bytes or 0.0)
    prof.meta["kernels"] = mode.kernels
    prof.meta["host_copy_bytes"] = mode.host_copy_bytes
    prof.meta["host_copies"] = mode.host_copies
    prof.meta["bytes_by_op"] = mode.bytes_by_op
    prof.meta["collectives"] = {"counts": mode.collectives.counts,
                                "bytes_by_kind":
                                    mode.collectives.bytes_by_kind}
    prof.captured = True
    return out


def capture(name: str, fn, *args, coll_bytes: float = 0.0,
            **kwargs) -> ProgramProfile | None:
    """Cost of ``fn`` called with ``args``: it runs once under a
    ``CostMode`` (module docstring) and its output is dropped; use
    :func:`instrument` to keep the output of a call that is counted.
    ``coll_bytes`` is the caller's analytic wire accounting, as in the
    reference. Never raises: failures (fn's own included) count in
    ``profile/capture_errors`` and return None."""
    if not enabled():
        return None
    prof = _get(name)
    try:
        _counted(name, fn, args, kwargs, coll_bytes)
    except Exception as e:  # noqa: BLE001 — attribution never breaks a run
        _capture_error(prof, f"{type(e).__name__}: {e}")
    return prof if prof.captured else None


def observe(name: str, seconds: float) -> None:
    """Join one measured call duration into the program's profile."""
    if not enabled():
        return
    prof = _get(name)
    prof.calls += 1
    prof.total_time_s += float(seconds)


def compile_time(name: str, seconds: float) -> None:
    """Record a program's first-call (compile + first execution) wall time
    as a ``compile/*`` gauge — the per-program view TrainReport's single
    ``compile_time`` scalar can't give."""
    if not enabled():
        return
    _get(name).compile_time_s = float(seconds)
    metrics.gauge(f"compile/{_slug(name)}_s").set(float(seconds))


def _on_card(args, kwargs) -> bool:
    import torch
    from repro_torch.tree import leaves
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for a in list(args) + list(kwargs.values())
               for x in leaves(a))


def instrument(name: str, fn, *, coll_bytes: float = 0.0):
    """Wrap a callable with first-call attribution: its first call is the
    counted call (:func:`capture`'s cost, ``coll_bytes`` kept on the
    profile: a number, or a function of the call's arguments that
    returns one) and its output is returned, so the program runs once as it
    would unwrapped; that call is timed, synchronised with the card when
    its arguments live there, as the ``compile/<name>_s`` gauge (the
    one-time costs: kernel builds, cuDNN's algorithm search, the
    allocator's first allocations, and the counting's own host time).
    Later calls pass through untouched; disabled telemetry passes through
    from call zero."""
    state = {"first": True}

    def wrapped(*args, **kwargs):
        if state["first"] and enabled():
            state["first"] = False
            sync = _on_card(args, kwargs)
            import torch
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.span("profile/capture", program=name):
                out = _counted(name, fn, args, kwargs, coll_bytes)
                if sync:
                    torch.cuda.synchronize()
            compile_time(name, time.perf_counter() - t0)
            return out
        return fn(*args, **kwargs)

    wrapped.fn = fn         # introspection: the unwrapped program
    wrapped.program_name = name
    return wrapped


def emit(registry=None) -> None:
    """Write every profile's gauges into ``registry`` (default: the
    process-wide registry) so flush/dump picks them up."""
    if not enabled():
        return
    if registry is None:
        registry = _runtime.default_registry()
    for prof in _profiles.values():
        for gname, v in prof.gauges().items():
            registry.gauge(gname).set(v)


def summary() -> list:
    """One dict per captured program — the report CLI's table source."""
    out = []
    for name in sorted(_profiles):
        p = _profiles[name]
        row = {"program": name, "flops": p.flops, "hbm_bytes": p.hbm_bytes,
               "coll_bytes": p.coll_bytes, "calls": p.calls,
               "mean_time_s": p.mean_time_s,
               "compile_time_s": p.compile_time_s,
               "achieved_flops_s": p.achieved_flops_s,
               "achieved_hbm_bw": p.achieved_hbm_bw}
        if p.captured and p.calls:
            row.update(p.roofline())
        out.append(row)
    return out
