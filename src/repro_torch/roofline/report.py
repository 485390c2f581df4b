"""The dry run's tables (counterpart of ``repro/roofline/report.py``, a
copy): the dry-run and roofline tables of the rows that
``python -m repro_torch.launch.dryrun`` writes, one JSON a row.

    PYTHONPATH=src python -m repro_torch.roofline.report [DIR]

The figures are the dry run's predictions (meta device, H100 SXM
peaks), not measurements."""
from __future__ import annotations

import glob
import json
import os


def load_results(dirpath: str = "experiments/dryrun"):
    rows = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_b(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x:.0f}B"


ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def dryrun_table(rows, mesh="16x16") -> str:
    lines = ["| arch | shape | mode | ok | per-dev arg bytes | temp bytes | "
             "collectives | compile |",
             "|---|---|---|---|---|---|---|---|"]
    rs = [r for r in rows if r["mesh"] == mesh
          and "__bsp" not in json.dumps(r.get("exchanger", ""))]
    rs.sort(key=lambda r: (r["arch"], ORDER.index(r["shape"])
                           if r["shape"] in ORDER else 9))
    for r in rs:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | "
                         f"{r.get('mode', '-')} | FAIL: "
                         f"{r.get('error', '?')[:60]} | | | | |")
            continue
        mem = r["memory"]
        colls = r["collectives"]["counts"]
        cstr = " ".join(f"{k.split('-')[-1] if False else k}:{v}"
                        for k, v in sorted(colls.items())) or "-"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r.get('mode', '-')} | ok | "
            f"{_fmt_b(mem['argument_bytes'])} | {_fmt_b(mem['temp_bytes'])} | "
            f"{cstr} | {r.get('compile_s', 0):.0f}s |")
    return "\n".join(lines)


def roofline_table(rows, mesh="16x16") -> str:
    lines = ["| arch | shape | t_compute | t_memory | t_collective | "
             "dominant | MODEL/HLO flops | coll bytes/dev |",
             "|---|---|---|---|---|---|---|---|"]
    rs = [r for r in rows if r["mesh"] == mesh and r.get("ok")]
    rs.sort(key=lambda r: (r["arch"], ORDER.index(r["shape"])
                           if r["shape"] in ORDER else 9))
    for r in rs:
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(rl['t_compute_s'])} | "
            f"{_fmt_s(rl['t_memory_s'])} | {_fmt_s(rl['t_collective_s'])} | "
            f"**{rl['dominant']}** | {rl['useful_ratio']:.2f} | "
            f"{_fmt_b(rl['coll_bytes'])} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    rows = load_results(*sys.argv[1:2])
    print("## Dry-run (single-pod 16x16)\n")
    print(dryrun_table(rows, "16x16"))
    print("\n## Dry-run (multi-pod 2x16x16)\n")
    print(dryrun_table(rows, "2x16x16"))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(rows, "16x16"))
