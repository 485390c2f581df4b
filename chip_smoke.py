#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit. In order:

1. Device: prints ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` each, all started together).
3. Kernels: calls each kernel's wrapper at the serve path's full-width
   llama3.2-1b shapes in bf16, holds it to its plain PyTorch version on
   the same inputs, and times the kernel, the plain version and one
   PyTorch library call as a yardstick, beside the least time the card
   could take (bytes over 3.35 TB/s or bf16 flops over 989 TFLOP/s).
4. Engine: serves 16 requests through the port's ``Engine`` on full
   llama3.2-1b (16 layers, random weights from a seeded generator, bf16):
   paged KV cache, fused sampling, chunked prefill, a shared-prompt
   prefix hit. The launch counts are zeroed just before and read just
   after, and every kernel of the path must have launched. A short
   ``page_size=0`` pass reaches the contiguous ``flash_decode``. One
   prompt's teacher-forced prefill and decode logits through the kernels
   are held to the einsum path.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; with no CUDA device, or outside a checkout, it
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_S = 3.35e12        # H100 SXM memory rate
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 tensor-core peak
ROOT = Path(__file__).resolve().parent

# tolerances against the plain versions on the card, and why
FWD_TOL = 1e-2        # bf16 output (eps 2^-8 ~ 3.9e-3) of |o| <~ 1 values;
                      # the kernel rounds p per key tile, the plain version
                      # once against the global row max
DECODE_TOL = 1e-2     # bf16 output, fp32 sums in another order
LOGIT_TOL = 0.1       # flash vs einsum logits, bf16 through 16 layers:
                      # the einsum path runs its softmax in bf16


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _median_ms(fn, iters: int = 30, flush=None) -> float:
    """Median device time of one call in ms. The call is captured once in
    a CUDA graph and replayed between CUDA events, so the time is the
    card's and not the host's dispatch of it; ``flush`` runs (untimed)
    before each replay to empty the L2 cache, as a serve step finds it."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()                                    # warm-up outside capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def _host_ms(fn, iters: int = 30) -> float:
    """Median wall time of one call including the host's dispatch, ending
    in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def kernel_phase(torch, ref, fa, sg, flush):
    """Each kernel against its plain version at the serve path's shapes."""
    import torch.nn.functional as F
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(bf)
    rows = []

    # --- flash_attention: one 32-row prefill chunk at the end of a 1 K lane
    B, Sq, Sk, H, KV, D = 1, 32, 1024, 32, 8, 64
    q, k, v = rn(B, Sq, H, D), rn(B, Sk, KV, D), rn(B, Sk, KV, D)
    q_off = torch.tensor([Sk - Sq], dtype=torch.int32, device=dev)
    scale = 1 / math.sqrt(D)
    got = fa.flash_attention(q, k, v, q_off=q_off)
    want = ref.flash_attention_ref(q, k, v, q_off, 0, scale)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= FWD_TOL:
        _fail(f"flash_attention vs plain: max err {err} > {FWD_TOL}")
    qpos = torch.arange(Sq, device=dev) + int(q_off)
    mask = (torch.arange(Sk, device=dev)[None] <= qpos[:, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    keys = int((qpos + 1).clamp(max=Sk).sum())          # live (row, key) pairs
    live_rows = min(int(q_off) + Sq, Sk)
    rows.append(dict(
        name="flash_attention", src="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97", err=err,
        ms=_median_ms(lambda: fa.flash_attention(q, k, v, q_off=q_off),
                      flush=flush),
        host_ms=_host_ms(lambda: fa.flash_attention(q, k, v, q_off=q_off)),
        plain_ms=_median_ms(lambda: ref.flash_attention_ref(q, k, v, q_off, 0,
                                                            scale), flush=flush),
        library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush=flush),
        bound=_bound(2 * (q.numel() * 2) + 2 * live_rows * KV * D * 2 + 4 * B,
                     4 * D * H * keys)))

    # --- decode: 8 slots at positions 64..1000; lanes of 1 K, pages of 16
    B, S, ps = 8, 1024, 16
    NP = S // ps
    pos = torch.tensor([64, 200, 333, 480, 512, 700, 871, 1000],
                       dtype=torch.int32, device=dev)
    qd = rn(B, 1, H, D)
    P = B * NP + 1                                    # + the null page 0
    kp, vp = rn(P, ps, KV, D), rn(P, ps, KV, D)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    tables = perm.reshape(B, NP).contiguous()
    live = (torch.arange(NP, device=dev)[None] * ps <= pos[:, None].long())
    tables = torch.where(live, tables, 0).to(torch.int32)  # null page past pos
    lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    need = int((pos.long() + 1).sum())                 # visible keys, all slots
    dec_bytes = 2 * qd.numel() * 2 + 2 * need * KV * D * 2 + 4 * B
    dec_flops = 4 * D * H * need
    got_c = fa.flash_decode(qd, lk, lv, pos)
    want_c = ref.flash_decode_ref(qd, lk, lv, pos, 0, scale, 512)
    err_c = (got_c.float() - want_c.float()).abs().max().item()
    got_p = fa.flash_decode_paged(qd, kp, vp, tables, pos, page_size=ps)
    want_p = ref.flash_decode_paged_ref(qd, kp, vp, tables, pos, 0, scale, ps)
    err_p = (got_p.float() - want_p.float()).abs().max().item()
    if not (err_c <= DECODE_TOL and err_p <= DECODE_TOL):
        _fail(f"flash decode vs plain: max err {err_c} / {err_p}")
    same = fa.flash_decode(qd, lk, lv, pos, block_k=ps)
    if not torch.equal(got_p, same):
        _fail("flash_decode_paged != flash_decode(gathered, block_k=16)")
    dmask = (torch.arange(S, device=dev)[None] <= pos[:, None])[:, None, None]
    rows.append(dict(
        name="flash_decode", src="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:391", err=err_c,
        ms=_median_ms(lambda: fa.flash_decode(qd, lk, lv, pos), flush=flush),
        host_ms=_host_ms(lambda: fa.flash_decode(qd, lk, lv, pos)),
        plain_ms=_median_ms(lambda: ref.flash_decode_ref(qd, lk, lv, pos, 0,
                                                         scale, 512),
                            flush=flush),
        library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2),
            attn_mask=dmask, enable_gqa=True), flush=flush),
        bound=_bound(dec_bytes, dec_flops)))
    rows.append(dict(
        name="flash_decode_paged", src="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:490", err=err_p,
        ms=_median_ms(lambda: fa.flash_decode_paged(qd, kp, vp, tables, pos,
                                                    page_size=ps), flush=flush),
        host_ms=_host_ms(lambda: fa.flash_decode_paged(qd, kp, vp, tables, pos,
                                                       page_size=ps)),
        plain_ms=_median_ms(lambda: ref.flash_decode_paged_ref(
            qd, kp, vp, tables, pos, 0, scale, ps), flush=flush),
        library_ms=None,                  # no single library call pages
        bound=_bound(dec_bytes + tables.numel() * 4, dec_flops)))

    # --- slot_gather_sample: decode (8, 1, V) and the prefill tail (1, 32, V)
    V = 128256
    tiny = torch.finfo(torch.float32).tiny
    for S_, C in ((8, 1), (1, 32)):
        lg = rn(S_, C, V)
        sel = torch.randint(0, C, (S_,), generator=g, device=dev)
        oh = torch.nn.functional.one_hot(sel, C).float()
        T = torch.tensor([0.8, 0.0] * 4, device=dev)[:S_]
        u = torch.rand(S_, V, generator=g, device=dev).clamp_min(tiny)
        nz = -torch.log(-torch.log(u))
        gk, sk = sg.slot_gather_sample(lg, oh, T, nz)
        gr, sr = ref.slot_gather_sample_ref(lg, oh, T, nz)
        if not (torch.equal(gk, gr) and torch.equal(sk, sr)):
            _fail(f"slot_gather_sample ({S_}, {C}, {V}) differs from plain")
        row = lg[torch.arange(S_, device=dev), sel]
        r = dict(
            name="slot_gather_sample", src="src/repro_torch/csrc/slot_gather.cu",
            replaces="src/repro/kernels/slot_gather.py:37",
            err=float(max((gk - gr).abs().max().item(),
                          (sk - sr).abs().max().item())),
            ms=_median_ms(lambda: sg.slot_gather_sample(lg, oh, T, nz),
                          flush=flush),
            host_ms=_host_ms(lambda: sg.slot_gather_sample(lg, oh, T, nz)),
            plain_ms=_median_ms(lambda: ref.slot_gather_sample_ref(lg, oh, T,
                                                                   nz),
                                flush=flush),
            library_ms=_median_ms(lambda: torch.argmax(row, -1), flush=flush),
            # the kernel reads only the one-hot-selected row of each slot
            bound=_bound(S_ * V * (2 + 4) + oh.numel() * 4 + S_ * 12,
                         3 * S_ * V))
        if C == 1:
            rows.append(r)
        else:
            print("slot_gather_sample prefill tail (1, 32, 128256): "
                  + json.dumps({k_: r[k_] for k_ in
                                ("ms", "plain_ms", "library_ms", "host_ms",
                                 "bound")}))
    return rows


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def engine_phase(torch, K, cfg, models, serve, dev):
    """``cfg`` through the Engine on ``dev``; returns (launches, stats)."""
    model = models.build_model(cfg, dev)
    t0 = time.perf_counter()
    master = model.init(torch.Generator(device=dev).manual_seed(0))
    _sync(torch, dev)
    print(f"init {models.count_params(master) / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f}s")

    rng = __import__("numpy").random.RandomState(0)
    lens = rng.randint(32, 513, size=16)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    shared = rng.randint(0, cfg.vocab_size, size=256).tolist()
    # requests 1 and 9 share a 256-token prefix; 9 is admitted after 1 has
    # published its pages, so its prefill starts from the prefix cache
    prompts[1] = shared + prompts[1][:64]
    prompts[9] = shared + prompts[9][:96]
    SP = serve.SamplingParams
    sps = [SP(temperature=0.0) if i % 2 == 0 else SP(temperature=0.8, seed=i)
           for i in range(16)]

    eng = serve.Engine(model, master, max_slots=8, max_seq=1024,
                       prefill_chunk=32, page_size=16, fused_sampling=True,
                       device=dev)
    del master
    torch.cuda.empty_cache()
    rids = [eng.submit(p, 32, sp) for p, sp in zip(prompts, sps)]
    K.reset_launches()
    t0 = time.perf_counter()
    results = eng.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for name in ("flash_attention", "flash_decode_paged", "slot_gather_sample"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was not launched by the paged engine run")
    for r in rids:
        out = results[int(r)]
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            _fail(f"request {int(r)} returned {len(out)} tokens: {out[:8]}")
    st = eng.stats
    al = eng.allocator
    if al.hits <= 0:
        _fail("the shared-prefix request took no prefix-cache hit")
    chunks = launches["flash_attention"] // cfg.num_layers
    stats = dict(
        requests=len(rids), wall_s=wall, prefill_tokens=st.prefill_tokens,
        prefill_tok_s=st.prefill_tok_s(), decode_steps=st.steps,
        decoded_tokens=st.decoded_tokens, decode_tok_s=st.decode_tok_s(),
        prefill_chunks=chunks, prefix_hit_pages=al.hits,
        cow_copies=al.cow_copies,
        launches_per_decode_step=launches["flash_decode_paged"] / st.steps,
        launches_per_prefill_chunk=launches["flash_attention"] / chunks,
        token_latency_ms={str(q): v * 1e3 for q, v in
                          st.token_latency_percentiles().items()})
    print("engine " + json.dumps(stats))

    # contiguous pool: the path that reaches flash_decode
    eng0 = serve.Engine(model, eng.params, max_slots=4, max_seq=256,
                        prefill_chunk=32, page_size=0, fused_sampling=True,
                        device=dev)
    rids0 = [eng0.submit(p[:96], 8) for p in prompts[:4]]
    K.reset_launches()
    res0 = eng0.run()
    _sync(torch, dev)
    launches["flash_decode"] = K.LAUNCHES.get("flash_decode", 0)
    if launches["flash_decode"] <= 0:
        _fail("flash_decode was not launched by the contiguous engine run")
    if any(len(res0[int(r)]) != 8 for r in rids0):
        _fail("contiguous engine run did not finish its requests")
    print("contiguous engine launches " + json.dumps(dict(K.LAUNCHES)))

    check_flash_vs_ref(torch, cfg, models, eng.params, prompts[0][:64], dev)
    return launches, stats


def check_flash_vs_ref(torch, cfg, models, params, prompt, dev):
    """Teacher-forced prefill (2 chunks) + 4 decode steps of one prompt
    through the kernels and through the einsum path, on a paged cache."""
    from repro_torch.configs.base import with_attn_impl
    outs = {}
    for impl in ("flash", "ref"):
        m = models.build_model(with_attn_impl(cfg, impl), dev)
        pool = m.init_paged_cache(1, 16, 9)
        tables = torch.arange(1, 9, dtype=torch.int32, device=dev)[None]
        toks = torch.tensor(prompt, dtype=torch.int64, device=dev)
        logits = []
        for c in range(0, 64, 32):
            lg, pool = m.chunk_prefill(params, pool, toks[None, c:c + 32], c,
                                       32, seq_len=128, block_tables=tables,
                                       page_size=16)
            logits.append(lg.float())
        for i in range(4):
            lg, pool = m.decode_step(params, pool,
                                     {"tokens": toks[None, i:i + 1]},
                                     torch.tensor([64 + i], device=dev),
                                     seq_len=128, block_tables=tables,
                                     page_size=16)
            logits.append(lg.float())
        outs[impl] = logits
    errs = [(a - b).abs().max().item() for a, b in zip(outs["flash"],
                                                        outs["ref"])]
    scale = max(b.abs().max().item() for b in outs["ref"])
    top1 = sum(int((a.argmax(-1) == b.argmax(-1)).all())
               for a, b in zip(outs["flash"], outs["ref"]))
    print(f"flash vs ref logits: max err per call {errs}, max |logit| "
          f"{scale:.3f}, calls with equal top-1 {top1}/{len(errs)}")
    if not all(math.isfinite(e) for e in errs) or max(errs) > LOGIT_TOL:
        _fail(f"flash vs ref logits differ by {max(errs)} > {LOGIT_TOL}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch import models, serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import slot_gather as sg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    K.build_all()
    print(f"built {len(K.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f}s")

    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, ref, fa, sg, flush=l2.zero_)
    del l2
    launches, stats = engine_phase(torch, K,
                                   cfg_mod.get_config("llama3.2-1b"), models,
                                   serve, torch.device("cuda"))

    out = []
    for r in rows:
        b_ms, b_by = r["bound"]
        out.append({"name": r["name"], "route": "cuda", "source": r["src"],
                    "replaces": r["replaces"],
                    "launches": launches.get(r["name"], 0),
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
    print("wrapper call incl. host dispatch, ms: " + json.dumps(
        {r["name"]: r["host_ms"] for r in rows}))
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
