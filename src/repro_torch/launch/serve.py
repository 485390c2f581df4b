"""Serving launcher: the continuous-batching engine over a model of the
registry, with random weights from a seeded ``torch.Generator``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --full --fused-sampling --num-requests 16 --max-slots 8

Runs on ``cuda`` unless ``--device cpu`` is given (the kernels' plain
versions). ``--full`` serves the registry configuration at full width and
depth; the default is its smoke reduction.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import with_attn_impl
from repro_torch.models import build_model, count_params
from repro_torch.serve import Engine, SamplingParams


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
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (0: contiguous lanes)")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "flash", "ref"],
                    help="flash kernels (default) or the einsum oracles")
    ap.add_argument("--fused-sampling", action="store_true",
                    help="slot_gather_sample kernel (greedy/temperature)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after the first admission wave, time this many "
                         "engine steps, then trace as many with "
                         "torch.profiler: device time by kernel and the "
                         "device's busy share")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = with_attn_impl(cfg, args.attn_impl)
    model = build_model(cfg, args.device)
    params = model.init(args.seed)

    rng = np.random.RandomState(args.seed)
    lens = np.maximum(1, rng.poisson(args.prompt_len, args.num_requests))
    news = np.maximum(1, rng.poisson(args.max_new, args.num_requests))
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]

    eng = Engine(model, params, max_slots=args.max_slots,
                 max_seq=int((lens + news).max()),
                 prefill_chunk=args.prefill_chunk,
                 fused_sampling=args.fused_sampling,
                 page_size=args.page_size, device=model.device)
    del params
    sp = SamplingParams(temperature=args.temperature, seed=args.seed)
    rids = [eng.submit(p, int(m), sp) for p, m in zip(prompts, news)]
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
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu")
    print(f"{cfg.name}: {count_params(eng.params) / 1e9:.3f} B params, "
          f"{cfg.dtype} on {where}")
    print(f"served {len(rids)} requests / {st.decoded_tokens} decode tokens "
          f"in {dt:.2f}s on {args.max_slots} slots (prefill "
          f"{st.prefill_tok_s():.1f} tok/s, decode {st.decode_tok_s():.1f} "
          f"tok/s, p50/p99 token latency {lat[50] * 1e3:.2f}/"
          f"{lat[99] * 1e3:.2f} ms)")
    if eng.allocator is not None:
        al = eng.allocator
        print(f"paged cache: {eng.num_pages} pages x {eng.page_size} tok, "
              f"prefix hit-rate {al.hit_rate():.2f}, {al.cow_copies} COW "
              f"copies")
    print("sample:", results[int(rids[0])][:16])


if __name__ == "__main__":
    main()
