"""Low-overhead host-side span tracing with Chrome-trace/Perfetto export.

    from repro_torch.telemetry import trace
    with trace.span("exchange/rs", bytes=n):
        ...
    trace.export("trace.json")      # load in ui.perfetto.dev / about:tracing

A copy of ``repro/telemetry/trace.py`` (pure Python; pinned to the
original by ``tests/test_torch_host.py``). Spans record host wall-clock
(``time.perf_counter``) begin/duration: they time *dispatch and host
work*, never device internals, so no span adds a device sync. Nested ``span``s on one thread
render as a flame stack (Perfetto nests complete events by time
containment per track); request-scoped lifecycles that overlap arbitrarily
use the async pair :func:`async_begin`/:func:`async_end` keyed by an id
(one Perfetto track per id).

The event buffer is bounded (:data:`MAX_EVENTS`); overflow increments a
drop counter rather than growing — a long-serving process can leave
tracing on.
"""
from __future__ import annotations

import json
import os
import threading
import time

MAX_EVENTS = 1 << 18     # ~262k events; each is a small tuple

_T0 = time.perf_counter()          # trace epoch (exported ts are µs from here)
_T0_UNIX = time.time()

_lock = threading.Lock()
_events: list = []
_dropped = 0
_tids: dict = {}


def _tid() -> int:
    ident = threading.get_ident()
    t = _tids.get(ident)
    if t is None:
        with _lock:
            t = _tids.setdefault(ident, len(_tids))
    return t


def _push(ev) -> None:
    global _dropped
    if len(_events) < MAX_EVENTS:
        _events.append(ev)
    else:
        _dropped += 1


class _Span:
    """A live complete-event span (context manager)."""
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _push(("X", self.name, self.t0, t1 - self.t0, _tid(), self.attrs))
        return False


class _NoopSpan:
    """Shared disabled-path span: enter/exit do nothing, allocate nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


def _enabled() -> bool:
    from repro_torch.telemetry._runtime import _state
    return _state.enabled


def span(name: str, **attrs):
    """Context manager timing a host-side region. ``attrs`` land in the
    exported event's ``args``."""
    if not _enabled():
        return _NOOP_SPAN
    return _Span(name, attrs or None)


def instant(name: str, **attrs) -> None:
    """A zero-duration marker event."""
    if not _enabled():
        return
    _push(("i", name, time.perf_counter(), 0.0, _tid(), attrs or None))


def async_begin(name: str, aid, **attrs) -> None:
    """Open an async span keyed by ``aid`` (e.g. a request id). Pairs with
    :func:`async_end`; overlapping ids get separate Perfetto tracks."""
    if not _enabled():
        return
    _push(("b", name, time.perf_counter(), 0.0, aid, attrs or None))


def async_end(name: str, aid, **attrs) -> None:
    if not _enabled():
        return
    _push(("e", name, time.perf_counter(), 0.0, aid, attrs or None))


def events() -> list:
    """The raw event buffer (tests)."""
    return list(_events)


def dropped() -> int:
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def to_chrome(extra_metadata: dict | None = None) -> dict:
    """Render the buffer as a Chrome-trace object (Perfetto-loadable)."""
    from repro_torch.telemetry.schema import SCHEMA_VERSION, run_context
    pid = os.getpid()
    out = []
    for ph, name, t0, dur, tid_or_id, attrs in _events:
        ev = {"name": name, "ph": ph, "pid": pid,
              "ts": (t0 - _T0) * 1e6}
        if ph == "X":
            ev["tid"] = tid_or_id
            ev["dur"] = dur * 1e6
        elif ph in ("b", "e"):
            # async events share one "requests" track, separated by id
            ev["tid"] = 0
            ev["cat"] = "request"
            ev["id"] = tid_or_id
        else:
            ev["tid"] = tid_or_id
            ev["s"] = "t"
        if attrs:
            ev["args"] = {k: v for k, v in attrs.items()}
        out.append(ev)
    meta = {"schema_version": SCHEMA_VERSION, "run": run_context(),
            "trace_epoch_unix": _T0_UNIX, "dropped_events": _dropped}
    if extra_metadata:
        meta.update(extra_metadata)
    return {"traceEvents": out, "displayTimeUnit": "ms", "otherData": meta}


def export(path: str, **extra_metadata) -> str:
    """Write the Chrome-trace JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(to_chrome(extra_metadata or None), f)
    return path
