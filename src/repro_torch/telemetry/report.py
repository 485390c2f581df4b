"""``python -m repro_torch.telemetry.report`` — render a one-page markdown
run health report from telemetry artifacts (a copy of
``repro/telemetry/report.py``).

Joins up to three files from one run:

- a ``--metrics-out`` JSONL (required positional) — train / exchange /
  serve / fault counters+gauges+histograms, the ``profile/*`` program
  attribution gauges, ``compile/*`` compile times, ``anomaly/*`` firings;
- ``--trace`` Chrome-trace JSON — top spans by total wall time;
- ``--bench`` a ``BENCH_*.json`` — the bench rows of the same commit.

The report is the human view of the same schema the validators check: a
``Programs`` table (flops, bytes, achieved rates, MFU, roofline bound per
jitted program), per-area metric tables with interpolated histogram
percentiles, the anomaly/fault tallies, and run attribution (host,
backend, torch, CUDA) from the leading run record.
"""
from __future__ import annotations

import argparse
import json
import sys


def _fmt(v, unit: str = "") -> str:
    """Engineering-format a number for the tables."""
    if isinstance(v, str):
        return v
    try:
        x = float(v)
    except (TypeError, ValueError):
        return str(v)
    if x == 0:
        return f"0{unit}"
    ax = abs(x)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if ax >= scale:
            return f"{x / scale:.2f}{suffix}{unit}"
    if ax < 1e-3:
        return f"{x * 1e6:.1f}u{unit}"
    if ax < 1:
        return f"{x * 1e3:.2f}m{unit}"
    if x == int(x) and ax < 1e15:
        return f"{int(x)}{unit}"
    return f"{x:.3f}{unit}"


def _hist_percentile(rec: dict, q: float) -> float:
    """Interpolated percentile from a histogram *snapshot record* — the
    same bucket interpolation ``Histogram.percentile`` does live."""
    count, counts = rec.get("count", 0), rec.get("counts", [])
    bounds = rec.get("bounds", [])
    if not count or not counts:
        return 0.0
    lo_min, hi_max = rec.get("min", 0.0), rec.get("max", 0.0)
    rank = q / 100.0 * count
    cum = 0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else lo_min
            hi = bounds[i] if i < len(bounds) else hi_max
            lo = max(lo, lo_min)
            hi = min(hi, hi_max)
            if hi <= lo:
                return lo
            return lo + (hi - lo) * max(rank - cum, 0.0) / c
        cum += c
    return hi_max


def load_metrics(path: str) -> tuple:
    """Last-write-wins record per metric name, plus the run context."""
    run, records = {}, {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue       # validate CLI reports these; report renders
            if not isinstance(rec, dict):
                continue
            if rec.get("kind") == "run":
                run = rec.get("run", {}) or run
            elif isinstance(rec.get("name"), str):
                records[rec["name"]] = rec
    return run, records


def _by_area(records: dict) -> dict:
    areas: dict = {}
    for name, rec in sorted(records.items()):
        area = name.split("/", 1)[0]
        areas.setdefault(area, []).append(rec)
    return areas


def _metric_rows(recs: list) -> list:
    rows = []
    for rec in recs:
        kind, name = rec.get("kind"), rec.get("name")
        if kind in ("counter", "gauge"):
            rows.append((name, kind, _fmt(rec.get("value"))))
        elif kind == "histogram":
            rows.append((name, "histogram",
                         f"n={rec.get('count', 0)} "
                         f"p50={_fmt(_hist_percentile(rec, 50), 's')} "
                         f"p99={_fmt(_hist_percentile(rec, 99), 's')} "
                         f"max={_fmt(rec.get('max', 0.0), 's')}"))
        elif kind == "info":
            labels = rec.get("labels", {})
            rows.append((name, "info",
                         " ".join(f"{k}={v}" for k, v in labels.items())))
    return rows


def _programs_table(records: dict) -> list:
    """Reassemble the ``profile/<program>/<quantity>`` gauges into one row
    per program."""
    progs: dict = {}
    for name, rec in records.items():
        if not name.startswith("profile/") or rec.get("kind") != "gauge":
            continue
        parts = name.split("/")
        if len(parts) != 3:
            continue
        progs.setdefault(parts[1], {})[parts[2]] = rec.get("value", 0.0)
    lines = []
    if progs:
        lines.append("| program | calls | mean | flops | hbm B | coll B |"
                     " FLOP/s | MFU | HBM B/s |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
        for prog in sorted(progs):
            q = progs[prog]
            lines.append(
                f"| {prog} | {int(q.get('calls', 0))} "
                f"| {_fmt(q.get('mean_time_s', 0.0), 's')} "
                f"| {_fmt(q.get('flops', 0.0))} "
                f"| {_fmt(q.get('hbm_bytes', 0.0))} "
                f"| {_fmt(q.get('coll_bytes', 0.0))} "
                f"| {_fmt(q.get('achieved_flops_s', 0.0))} "
                f"| {q.get('mfu', 0.0):.4f} "
                f"| {_fmt(q.get('achieved_hbm_bw', 0.0))} |")
    return lines


def _serve_cache_line(records: dict) -> list:
    """Paged-KV-cache health next to the program attribution: page-pool
    occupancy, prefix hit-rate, and copy-on-write copies explain *why* the
    serve programs ran the token counts they did (a hot prefix cache cuts
    prefill calls; high occupancy explains admission gating)."""
    keys = ("serve/page_occupancy", "serve/prefix_hit_rate",
            "serve/cow_copies")
    if not any(k in records for k in keys):
        return []
    occ = records.get(keys[0], {}).get("value", 0.0)
    hit = records.get(keys[1], {}).get("value", 0.0)
    cow = records.get(keys[2], {}).get("value", 0.0)
    return [f"KV cache: page occupancy {occ:.2f}, "
            f"prefix hit-rate {hit:.2f}, COW copies {int(cow)}"]


def _top_spans(trace_path: str, n: int = 12) -> list:
    with open(trace_path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError:
            return ["(trace file unreadable)"]
    events = obj.get("traceEvents", [])
    if not isinstance(events, list):
        return ["(traceEvents is not a list)"]
    total: dict = {}
    count: dict = {}
    for ev in events:
        if isinstance(ev, dict) and ev.get("ph") == "X" \
                and isinstance(ev.get("dur"), (int, float)):
            name = ev.get("name", "?")
            total[name] = total.get(name, 0.0) + ev["dur"]
            count[name] = count.get(name, 0) + 1
    if not total:
        return ["(no complete spans)"]
    lines = ["| span | calls | total | mean |", "|---|---|---|---|"]
    for name in sorted(total, key=total.get, reverse=True)[:n]:
        t_us, c = total[name], count[name]
        lines.append(f"| {name} | {c} | {_fmt(t_us / 1e6, 's')} "
                     f"| {_fmt(t_us / c / 1e6, 's')} |")
    return lines


def _bench_table(bench_path: str) -> list:
    with open(bench_path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError:
            return ["(bench file unreadable)"]
    rows = obj.get("rows", [])
    lines = ["| bench | us/call | derived |", "|---|---|---|"]
    for r in rows:
        if not isinstance(r, dict):
            continue
        lines.append(f"| {r.get('name', '?')} "
                     f"| {_fmt(r.get('us_per_call', 0))} "
                     f"| {r.get('derived', '')} |")
    return lines


# metric areas rendered as their own sections, in report order
_AREAS = ("train", "exchange", "serve", "fault", "anomaly", "compile",
          "elastic", "ckpt")


def render(metrics_path: str, trace_path: str | None = None,
           bench_path: str | None = None) -> str:
    run, records = load_metrics(metrics_path)
    out = ["# Run health report", ""]
    out.append(f"Source: `{metrics_path}`")
    out.append("")
    out.append("## Run")
    out.append("")
    for k in ("host", "backend", "torch", "cuda", "device_kind",
              "device_count",
              "platform", "python"):
        if k in run:
            out.append(f"- **{k}**: {run[k]}")
    out.append("")

    prog_lines = _programs_table(records)
    if prog_lines:
        out += ["## Programs (per-program attribution)", ""]
        out += prog_lines
        out.append("")
        cache_lines = _serve_cache_line(records)
        if cache_lines:
            out += cache_lines
            out.append("")

    areas = _by_area(records)
    for area in _AREAS:
        recs = [r for r in areas.get(area, [])
                if not r.get("name", "").startswith("profile/")]
        if not recs:
            continue
        out += [f"## {area}", "", "| metric | kind | value |",
                "|---|---|---|"]
        for name, kind, val in _metric_rows(recs):
            out.append(f"| {name} | {kind} | {val} |")
        out.append("")
    leftovers = [r for a, recs in sorted(areas.items()) if a not in _AREAS
                 for r in recs if not r.get("name", "").startswith("profile/")]
    if leftovers:
        out += ["## other", "", "| metric | kind | value |", "|---|---|---|"]
        for name, kind, val in _metric_rows(leftovers):
            out.append(f"| {name} | {kind} | {val} |")
        out.append("")

    if trace_path:
        out += ["## Top spans", ""]
        out += _top_spans(trace_path)
        out.append("")
    if bench_path:
        out += ["## Bench rows", ""]
        out += _bench_table(bench_path)
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="render a markdown run health report from telemetry "
                    "artifacts")
    ap.add_argument("metrics", help="--metrics-out JSONL file")
    ap.add_argument("--trace", default=None, help="--trace-out JSON file")
    ap.add_argument("--bench", default=None, help="BENCH_*.json artifact")
    ap.add_argument("--out", default=None,
                    help="write markdown here (default: stdout)")
    args = ap.parse_args(argv)
    md = render(args.metrics, args.trace, args.bench)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}")
    else:
        print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
