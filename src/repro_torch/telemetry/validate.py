"""Schema validator CLI (a copy of ``repro/telemetry/validate.py``).

    python -m repro_torch.telemetry.validate metrics.jsonl more.jsonl \
        --trace trace.json --bench BENCH_quick.json

Exit 0 iff every file validates; problems print one per line.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.telemetry.schema import (validate_bench_json,
                                    validate_metrics_jsonl, validate_trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("metrics", nargs="*", help="metrics JSONL files")
    ap.add_argument("--trace", nargs="*", default=[],
                    help="Chrome-trace/Perfetto JSON files")
    ap.add_argument("--bench", nargs="*", default=[],
                    help="BENCH_*.json artifacts")
    args = ap.parse_args(argv)
    if not (args.metrics or args.trace or args.bench):
        ap.error("nothing to validate")
    errs = []
    for p in args.metrics:
        errs.extend(validate_metrics_jsonl(p))
    for p in args.trace:
        errs.extend(validate_trace(p))
    for p in args.bench:
        errs.extend(validate_bench_json(p))
    for e in errs:
        print(e, file=sys.stderr)
    n = len(args.metrics) + len(args.trace) + len(args.bench)
    print(f"validated {n} file(s): "
          + ("OK" if not errs else f"{len(errs)} problem(s)"))
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
