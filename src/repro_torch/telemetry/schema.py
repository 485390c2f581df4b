"""The telemetry wire schema: versioning, run context, validators (a copy
of ``repro/telemetry/schema.py``; the run context names torch and the
card in place of JAX's backend, so the reference's validators accept
what the port writes).

One schema is shared by three producers so they stay comparable:

- live train/serve runs (``--metrics-out`` JSONL / ``--trace-out`` trace)
- ``benchmarks/run.py --json`` (``BENCH_*.json`` artifacts)
- tests (in-memory snapshots)

Every metrics record carries ``schema_version`` + ``ts``; every file opens
with a ``run`` record describing the host/device/backend that produced it
(the attribution satellite: a BENCH json or a metrics JSONL from three PRs
ago says *what machine and backend* its numbers came from).

The validators are dependency-free (no jsonschema) and are what the CI
telemetry-smoke step runs against freshly produced files.
"""
from __future__ import annotations

import json
import os
import platform
import sys
import time

SCHEMA_VERSION = 1

KINDS = ("run", "counter", "gauge", "histogram", "info")


def run_context() -> dict:
    """Host/device/backend identity for run attribution: torch's and CUDA's
    versions, and the backend ("cuda" or "cpu"), kind and count of the
    visible cards."""
    ctx = {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "time_unix": time.time(),
    }
    try:
        import torch
        ctx["torch"] = torch.__version__
        ctx["cuda"] = torch.version.cuda or ""
        if torch.cuda.is_available():
            ctx["backend"] = "cuda"
            ctx["device_kind"] = torch.cuda.get_device_name(0)
            ctx["device_count"] = torch.cuda.device_count()
        else:
            ctx["backend"] = "cpu"
            ctx["device_kind"] = "cpu"
            ctx["device_count"] = 1
    except Exception:  # noqa: BLE001 — no torch / no backend is still a run
        ctx["backend"] = "unknown"
    return ctx


def run_record() -> dict:
    return {"schema_version": SCHEMA_VERSION, "kind": "run",
            "ts": time.time(), "run": run_context()}


# ---------------------------------------------------------------------------
# validators
# ---------------------------------------------------------------------------

def _err(errs, where, msg):
    errs.append(f"{where}: {msg}")


def validate_record(rec, where: str = "record") -> list:
    """Validate one metrics record; returns a list of problems (empty =
    valid)."""
    errs: list = []
    if not isinstance(rec, dict):
        _err(errs, where, f"not an object: {type(rec).__name__}")
        return errs
    if rec.get("schema_version") != SCHEMA_VERSION:
        _err(errs, where, f"schema_version != {SCHEMA_VERSION}: "
             f"{rec.get('schema_version')!r}")
    kind = rec.get("kind")
    if kind not in KINDS:
        _err(errs, where, f"unknown kind {kind!r}")
        return errs
    if not isinstance(rec.get("ts"), (int, float)):
        _err(errs, where, "missing/non-numeric ts")
    if kind == "run":
        run = rec.get("run")
        if not isinstance(run, dict):
            _err(errs, where, "run record without run object")
        else:
            for k in ("host", "backend"):
                if k not in run:
                    _err(errs, where, f"run context missing {k!r}")
        return errs
    if not isinstance(rec.get("name"), str) or not rec.get("name"):
        _err(errs, where, "missing name")
    if kind in ("counter", "gauge"):
        if not isinstance(rec.get("value"), (int, float)):
            _err(errs, where, f"{kind} without numeric value")
    elif kind == "info":
        if not isinstance(rec.get("labels"), dict):
            _err(errs, where, "info without labels object")
    elif kind == "histogram":
        bounds, counts = rec.get("bounds"), rec.get("counts")
        if not isinstance(bounds, list) or not isinstance(counts, list):
            _err(errs, where, "histogram without bounds/counts lists")
        elif not all(isinstance(b, (int, float)) and not isinstance(b, bool)
                     for b in bounds):
            # guard before sorted(): a str/None bound must be a diagnostic,
            # not a TypeError out of the validator
            _err(errs, where, "non-numeric histogram bounds")
        elif not all(isinstance(c, int) and not isinstance(c, bool)
                     for c in counts):
            _err(errs, where, "non-integer histogram counts")
        else:
            if len(counts) != len(bounds) + 1:
                _err(errs, where, f"len(counts)={len(counts)} != "
                     f"len(bounds)+1={len(bounds) + 1}")
            if list(bounds) != sorted(bounds):
                _err(errs, where, "bounds not ascending")
            if sum(counts) != rec.get("count"):
                _err(errs, where, f"count={rec.get('count')} != "
                     f"sum(counts)={sum(counts)}")
        for k in ("count", "sum", "min", "max"):
            if not isinstance(rec.get(k), (int, float)):
                _err(errs, where, f"histogram missing {k!r}")
    return errs


def validate_metrics_jsonl(path: str) -> list:
    """Validate a ``--metrics-out`` file: JSON per line, a leading run
    record, every record schema-valid."""
    errs: list = []
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                _err(errs, f"{path}:{lineno}", f"bad json: {e}")
                continue
            if n == 0 and rec.get("kind") != "run":
                _err(errs, f"{path}:{lineno}",
                     "first record must be kind='run'")
            errs.extend(validate_record(rec, f"{path}:{lineno}"))
            n += 1
    if n == 0:
        _err(errs, path, "empty metrics file")
    return errs


def validate_trace(path: str) -> list:
    """Validate a ``--trace-out`` Chrome-trace/Perfetto JSON file."""
    errs: list = []
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            return [f"{path}: bad json: {e}"]
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return [f"{path}: not a Chrome trace (no traceEvents)"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return [f"{path}: traceEvents is not a list "
                f"({type(events).__name__})"]
    other = obj.get("otherData", {})
    if other.get("schema_version") != SCHEMA_VERSION:
        _err(errs, path, "otherData.schema_version missing/stale")
    if "backend" not in other.get("run", {}):
        _err(errs, path, "otherData.run context missing")
    open_async: dict = {}      # (name, id) -> open 'b' count
    for i, ev in enumerate(events):
        where = f"{path}:traceEvents[{i}]"
        if not isinstance(ev, dict):
            _err(errs, where, "event is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "b", "e", "i", "M"):
            _err(errs, where, f"unknown phase {ph!r}")
            continue
        for k in ("name", "ph", "pid", "tid", "ts"):
            if k not in ev:
                _err(errs, where, f"missing {k!r}")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            _err(errs, where, "complete event without dur")
        if ph in ("b", "e"):
            if "id" not in ev:
                _err(errs, where, "async event without id")
            else:
                key = (ev.get("name"), ev["id"])
                if ph == "b":
                    open_async[key] = open_async.get(key, 0) + 1
                elif open_async.get(key, 0) <= 0:
                    _err(errs, where, f"async end before begin for "
                         f"name={ev.get('name')!r} id={ev['id']!r}")
                else:
                    open_async[key] -= 1
    return errs


def validate_bench_obj(obj, where: str = "bench") -> list:
    """Validate an in-memory BENCH object (what ``benchmarks/run.py``
    checks *before* writing ``--json``)."""
    errs: list = []
    if not isinstance(obj, dict):
        return [f"{where}: not an object: {type(obj).__name__}"]
    if obj.get("schema_version") != SCHEMA_VERSION:
        _err(errs, where, "missing/stale schema_version")
    if "backend" not in obj.get("run", {}):
        _err(errs, where, "missing run context")
    rows = obj.get("rows")
    if not isinstance(rows, list):
        _err(errs, where, "missing rows list")
    else:
        for i, r in enumerate(rows):
            if not isinstance(r, dict) or "name" not in r:
                _err(errs, f"{where}:rows[{i}]", "row without name")
            elif not isinstance(r.get("us_per_call"), (int, float)):
                _err(errs, f"{where}:rows[{i}]",
                     "row without numeric us_per_call")
    return errs


def validate_bench_json(path: str) -> list:
    """Validate a ``BENCH_*.json`` artifact written by benchmarks/run.py."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            return [f"{path}: bad json: {e}"]
    return validate_bench_obj(obj, path)
