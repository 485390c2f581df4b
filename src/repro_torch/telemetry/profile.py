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
- **cost**: flops and bytes of the program, from :func:`capture`.

The reference reads its cost from XLA's ``cost_analysis`` and its peaks
from ``repro.roofline.analysis``; neither has a counterpart in the port
yet (ROADMAP queue 1, the roofline slice), so :func:`capture` and
:meth:`ProgramProfile.roofline` raise ``NotImplementedError`` rather than
report nothing. Everything else is the reference's: the gauges, the
summary, the gating by the telemetry switch plus
``REPRO_TELEMETRY_PROFILE=0``.
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
    flops: float = 0.0           # per-device, from capture (not yet)
    hbm_bytes: float = 0.0       # per-device (not yet)
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
        """Ratios against the card's peaks: they come with the roofline
        slice (ROADMAP queue 1 item 7), as :func:`capture` does."""
        raise NotImplementedError(
            f"ProgramProfile({self.name!r}).roofline(): the port has no "
            f"peak model yet; it comes with the roofline slice, ROADMAP "
            f"queue 1 item 7")

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


def capture(name: str, fn, *args, coll_bytes: float = 0.0,
            **kwargs) -> ProgramProfile | None:
    """Compile-time cost analysis of ``fn`` (flops, bytes). The reference
    reads XLA's ``cost_analysis``; the port has no cost model of its
    programs until the roofline slice, so this raises rather than return
    an empty profile."""
    raise NotImplementedError(
        f"profile.capture({name!r}): the port has no program cost model "
        f"yet (XLA's cost_analysis has no PyTorch counterpart); it comes "
        f"with the roofline slice, ROADMAP queue 1 item 7")


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
    """Wrap a callable with first-call attribution: a timing of its first
    call, synchronised with the card when its arguments live there, as
    the ``compile/<name>_s`` gauge (the one-time costs: kernel builds,
    cuDNN's algorithm search, the allocator's first allocations). Later
    calls pass through untouched; disabled telemetry passes through from
    call zero. ``coll_bytes`` is kept on the profile."""
    state = {"first": True}

    def wrapped(*args, **kwargs):
        if state["first"] and enabled():
            state["first"] = False
            _get(name).coll_bytes = float(coll_bytes or 0.0)
            sync = _on_card(args, kwargs)
            import torch
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.span("profile/first_call", program=name):
                out = fn(*args, **kwargs)
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
