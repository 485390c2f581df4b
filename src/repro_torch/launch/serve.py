"""Serving launcher: the continuous-batching engine over a model of the
registry, with random weights from a seeded ``torch.Generator``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --full --fused-sampling --num-requests 16 --max-slots 8

Runs on ``cuda`` unless ``--device cpu`` is given (the kernels' plain
versions). ``--full`` serves the registry configuration at full width and
depth; the default is its smoke reduction. ``--reference`` runs the
static-batch greedy ``train.serve.generate`` instead, the parity oracle.
Decoders alone have a serve path: the encoder-decoder is refused, as in
the reference.

SLO guardrails: ``--deadline-ms`` stamps a per-request budget (hopeless
requests are shed, in-flight ones past deadline cancelled),
``--max-queue``/``--shed-policy`` bound the submit queue,
``--drain-on-sigterm PATH`` drains on SIGTERM and snapshots unfinished
work there (a later start with the same path resumes it), and
``--fault-plan`` hands the run to the deterministic chaos loop
(``repro_torch.serve.chaos``) instead of the plain workload.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import with_attn_impl
from repro_torch.models import build_model, count_params
from repro_torch.serve import Engine, SamplingParams
from repro_torch.train.serve import generate


def profile_steps(eng, n: int) -> dict:
    """Run ``n`` engine steps untraced, then ``n`` more traced by
    torch.profiler (device activity only, which keeps the tracer's own host
    cost small). Prints and returns the wall time of both windows, the
    device time summed over kernels, the device's busy share of the traced
    window, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    cuda = eng.device.type == "cuda"

    def window(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = fn()
        if cuda:
            torch.cuda.synchronize()
        return live, (time.perf_counter() - t0) * 1e3

    live0, wall0 = window(lambda: sum(eng.step() for _ in range(n)))
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        live1, wall1 = window(lambda: sum(eng.step() for _ in range(n)))
    by_kernel: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    out = {"steps": n, "untraced": {"live_tokens": live0, "wall_ms": wall0},
           "traced": {"live_tokens": live1, "wall_ms": wall1,
                      "device_ms": busy, "busy_share": busy / wall1},
           "top_kernels_ms": {k[:80]: v for k, v in top}}
    print("profile " + json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="mean prompt length (Poisson)")
    ap.add_argument("--max-new", type=int, default=16,
                    help="mean output length (Poisson)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache rows per slot (0: from the workload)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (0: contiguous lanes)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="physical pages in the KV pool (0: every slot can "
                         "reach max_seq; fewer oversubscribe the card's "
                         "memory and gate admission on actual use)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="serve repeated page-aligned prompt prefixes from "
                         "shared pages (copy-on-write)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "flash", "ref"],
                    help="flash kernels (default) or the einsum oracles")
    ap.add_argument("--fused-sampling", action="store_true",
                    help="slot_gather_sample kernel (greedy/temperature)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference", action="store_true",
                    help="static-batch greedy generate() instead of the "
                         "engine")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO budget: shed if unmeetable in "
                         "queue, cancel in flight past deadline")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the submit queue (0: unbounded)")
    ap.add_argument("--shed-policy", default="reject-newest",
                    choices=["reject-newest", "reject-no-deadline"],
                    help="who loses when the bounded queue overflows")
    ap.add_argument("--drain-on-sigterm", default=None, metavar="SNAP",
                    help="SIGTERM drains and snapshots unfinished work to "
                         "SNAP (atomic, crc32); if SNAP exists at start, "
                         "its work resumes")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="run the deterministic serve chaos loop under "
                         "this seeded FaultPlan instead of the workload "
                         "(kinds qflood/stall/cancel/pagepress, grammar "
                         "kind:magnitude@step[xD])")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="write the telemetry metrics (schema'd JSONL)")
    ap.add_argument("--trace-out", default=None, metavar="JSON",
                    help="write host-side spans as Chrome-trace JSON")
    ap.add_argument("--no-profile", action="store_true",
                    help="no per-program attribution (profile/* and "
                         "compile/* gauges)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after the first admission wave, time this many "
                         "engine steps, then trace as many with "
                         "torch.profiler: device time by kernel and the "
                         "device's busy share")
    args = ap.parse_args(argv)
    family = get_config(args.arch).family
    if family != "decoder":
        # as the reference's launcher: only decoders have a serve path
        raise SystemExit(f"{family!r} models have no serve path")
    if args.no_profile:
        telemetry.configure(profile=False)

    if args.fault_plan:
        from repro_torch.serve.chaos import main as chaos_main
        chaos_main(["--arch", args.arch, "--fault-plan", args.fault_plan,
                    "--seed", str(args.seed),
                    "--requests", str(args.num_requests),
                    "--max-slots", str(args.max_slots),
                    "--page-size", str(args.page_size or 8),
                    "--num-pages", str(args.num_pages),
                    "--max-queue", str(args.max_queue or 16),
                    "--shed-policy", args.shed_policy, "--replay"]
                   + (["--device", args.device] if args.device else [])
                   + (["--metrics-out", args.metrics_out]
                      if args.metrics_out else [])
                   + (["--trace-out", args.trace_out]
                      if args.trace_out else []))
        return

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # random weights made in the compute dtype: the same numbers the engine
    # would cast fp32 masters to, at half the memory (DeepSeek-V2-Lite's
    # 15.7 B parameters: 31.4 GB in bf16, 63 GB in fp32)
    cfg = with_attn_impl(cfg, args.attn_impl).with_overrides(
        param_dtype=cfg.dtype)
    model = build_model(cfg, args.device)
    params = model.init(args.seed)

    rng = np.random.RandomState(args.seed)
    lens = np.maximum(1, rng.poisson(args.prompt_len, args.num_requests))
    news = np.maximum(1, rng.poisson(args.max_new, args.num_requests))
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]

    if args.reference:
        t0 = time.perf_counter()
        done = 0
        for p, m in zip(prompts, news):
            out = generate(model, params, [p], max_new=int(m))
            done += int(out.shape[1]) - len(p)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"reference generate: {done} tokens in {dt:.2f}s "
              f"({done / dt:.1f} tok/s)")
        return

    eng = Engine(model, params, max_slots=args.max_slots,
                 max_seq=args.max_seq or int((lens + news).max()),
                 prefill_chunk=args.prefill_chunk,
                 fused_sampling=args.fused_sampling,
                 page_size=args.page_size, num_pages=args.num_pages,
                 prefix_cache=args.prefix_cache, max_queue=args.max_queue,
                 shed_policy=args.shed_policy, device=model.device)
    del params
    if args.drain_on_sigterm:
        def _drain(signum, frame):
            snap = eng.drain(args.drain_on_sigterm)
            print(f"SIGTERM: drained to {args.drain_on_sigterm} "
                  f"({len(snap['queued']) + len(snap['inflight'])} "
                  f"requests snapshotted)")
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, _drain)
        if os.path.exists(args.drain_on_sigterm):
            resumed = eng.load_snapshot(args.drain_on_sigterm)
            print(f"resumed {len(resumed)} queued requests from "
                  f"{args.drain_on_sigterm}")
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    rids = [eng.submit(p, int(m), sp, deadline_ms=args.deadline_ms)
            for p, m in zip(prompts, news)]
    rids = [r for r in rids if r]          # a bounded queue may refuse some
    if args.profile_steps:
        eng.step()                 # admits + prefills the first wave
        profile_steps(eng, args.profile_steps)
    t0 = time.perf_counter()
    results = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = eng.stats
    lat = st.token_latency_percentiles()
    ttft = st.ttft_percentiles()
    qw = st.queue_wait_percentiles()
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu")
    print(f"{cfg.name}: {count_params(eng.params) / 1e9:.3f} B params, "
          f"{cfg.dtype} on {where}")
    print(f"served {len(rids)} requests / {st.decoded_tokens} decode tokens "
          f"in {dt:.2f}s on {args.max_slots} slots (prefill "
          f"{st.prefill_tok_s():.1f} tok/s, decode {st.decode_tok_s():.1f} "
          f"tok/s, p50/p99 token latency {lat[50] * 1e3:.2f}/"
          f"{lat[99] * 1e3:.2f} ms)")
    print(f"ttft p50/p99 {ttft[50] * 1e3:.1f}/{ttft[99] * 1e3:.1f} ms "
          f"(queue wait p50/p99 {qw[50] * 1e3:.1f}/{qw[99] * 1e3:.1f} ms, "
          f"{st.admissions} admitted / {st.evictions} evicted)")
    print(f"decode dispatched with {eng.trace_counts['decode']} argument "
          f"signature(s) across {st.steps} steps")
    if args.deadline_ms is not None or args.max_queue:
        print(f"guardrails: {st.goodput_tokens} tokens within deadline "
              f"(goodput {st.goodput_tok_s():.1f} tok/s), {st.shed} shed, "
              f"{st.cancelled} cancelled, {st.deadline_misses} deadline "
              f"misses, {st.rejected_queue_full} queue-rejected, "
              f"{st.watchdog_stalls} watchdog stalls, brownout clamped "
              f"{st.brownout_clamped}")
    if eng.allocator is not None:
        al = eng.allocator
        print(f"paged cache: {eng.num_pages} pages x {eng.page_size} tok, "
              f"final occupancy {al.occupancy():.2f}, prefix hit-rate "
              f"{al.hit_rate():.2f} ({al.hit_tokens} tok cached), "
              f"{al.cow_copies} COW copies, {al.evictions} cache evictions")
    if rids:
        print("sample:", results[int(rids[0])][:16])
    if args.metrics_out:
        telemetry.dump_metrics(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        telemetry.trace.export(args.trace_out)
        print(f"trace -> {args.trace_out}")

if __name__ == "__main__":
    main()
