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
   The training path's kernels (chunk_sum, the fp16 casts, fused_sgd,
   fused_rs_update) are held the same way at full-width AlexNet shapes:
   the f6.w bucket of 37,748,736 elements and its k=2 shard of
   18,874,368, against bytes over 3.35 TB/s.
4. Engine: serves 16 requests through the port's ``Engine`` on full
   llama3.2-1b (16 layers, random weights from a seeded generator, bf16):
   paged KV cache, fused sampling, chunked prefill, a shared-prompt
   prefix hit. The launch counts are zeroed just before and read just
   after, and every kernel of the path must have launched. A short
   ``page_size=0`` pass reaches the contiguous ``flash_decode``. One
   prompt's teacher-forced prefill and decode logits through the kernels
   are held to the einsum path.
5. Train: the paper's BSP training of full-width AlexNet (227 px, 1000
   classes, 60,965,224 parameters, fp32, TF32 off) on k=2 gloo rank
   processes that share the card; each rank takes batches of 128
   ``ImageSource`` images through the ``ParallelLoader`` (235 px cropped
   to 227), momentum SGD 0.9, weight decay 5e-4, ``step_decay``. Three
   runs of 8 steps: (a) ``asa16`` with the sharded update (the
   ``fused_rs_update`` kernel), (b) ``asa16`` unsharded with
   ``sgd_momentum(fused_kernel=fused_sgd)`` (``chunk_sum``, the fp16
   casts, ``fused_sgd``), (c) ``asa8`` sharded (the int8 variant). Each
   run's launch counts are zeroed just before it and read just after,
   and must equal what its bucket plan predicts; every loss must be
   finite; and one ``asa`` step of the two ranks on two halves of a batch
   must equal one step of a group of one on the whole batch.

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
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
ROOT = Path(__file__).resolve().parent

# tolerances against the plain versions on the card, and why
FWD_TOL = 1e-2        # bf16 output (eps 2^-8 ~ 3.9e-3) of |o| <~ 1 values;
                      # the kernel rounds p per key tile, the plain version
                      # once against the global row max
DECODE_TOL = 1e-2     # bf16 output, fp32 sums in another order
LOGIT_TOL = 0.1       # flash vs einsum logits, bf16 through 16 layers:
                      # the einsum path runs its softmax in bf16
UPDATE_TOL = 0.0      # training kernels: they add rows in the plain
                      # version's order and round every product and sum on
                      # its own (no FMA), so they are held bit for bit
K_TOL = 1e-6          # one asa step, k=2 ranks on two halves vs a group of
                      # one on the whole batch, max |dp|: in full fp32
                      # (TF32 and cuDNN off) the gradients differ only by
                      # summation order (~1e-6 of |g|, so ~1e-8 at lr 0.01),
                      # and p - lr g rounds to 1 ulp of |p| < 1 (<= 1.2e-7)
TRAIN_STEPS = 8       # steps of each training run
TRAIN_BATCH = 128     # images per rank and step


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


def _bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S):
    t_b, t_f = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _event_ms(fn, iters: int = 20) -> float:
    """Median device time of one call launched from the host (for a
    library call that cannot be captured in a CUDA graph)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


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


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

F6_BUCKET = 9216 * 4096            # full AlexNet's f6.w bucket
F6_SHARD = F6_BUCKET // 2          # its shard at k=2


def train_kernel_phase(torch, ref, flush):
    """Each training kernel against its plain version at full-width
    AlexNet shapes (the f6.w bucket and its k=2 shard)."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import quantize as qz
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4321)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    n, s, k = F6_BUCKET, F6_SHARD, 2
    rows = []

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    def row(name, src, replaces, got, want, ms, plain_ms, library_ms, bound,
            host_ms):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            _fail(f"{name} differs from its plain version")
        fin = [(a[torch.isfinite(a)].float(), b[torch.isfinite(b)].float())
               for a, b in zip(got, want)]
        err = max((a - b).abs().max().item() for a, b in fin)
        if not err <= UPDATE_TOL:
            _fail(f"{name} vs plain: max err {err} > {UPDATE_TOL}")
        rows.append(dict(name=name, src=f"src/repro_torch/csrc/{src}",
                         replaces=replaces, err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound=bound, host_ms=host_ms))

    # --- chunk_sum: the (2, s) fp16 receive of the f6.w shard
    recv = rn(k, s).half()
    row("chunk_sum", "exchange.cu", "src/repro/kernels/chunk_sum.py:29",
        cs.chunk_sum(recv), ref.chunk_sum_ref(recv),
        _median_ms(lambda: cs.chunk_sum(recv), flush=flush),
        _median_ms(lambda: ref.chunk_sum_ref(recv), flush=flush),
        _median_ms(lambda: torch.sum(recv, 0, dtype=torch.float32),
                   flush=flush),
        _bound(recv.numel() * 2 + s * 4, (k - 1) * s, FP32_FLOP_S),
        _host_ms(lambda: cs.chunk_sum(recv)))

    # --- the fp16 wire casts of the whole f6.w bucket (about 0.1 % of
    # the values lie past fp16's range, so overflow to inf is exercised)
    x = rn(n) * 20000
    h = x.half()
    row("quant_fp16", "exchange.cu", "src/repro/kernels/quantize.py:39",
        qz.quant_fp16(x), ref.quant_fp16_ref(x),
        _median_ms(lambda: qz.quant_fp16(x), flush=flush),
        _median_ms(lambda: ref.quant_fp16_ref(x), flush=flush),
        _median_ms(lambda: x.half(), flush=flush),
        _bound(n * 4 + n * 2, n, FP32_FLOP_S),
        _host_ms(lambda: qz.quant_fp16(x)))
    row("dequant_fp16", "exchange.cu", "src/repro/kernels/quantize.py:57",
        qz.dequant_fp16(h), ref.dequant_fp16_ref(h),
        _median_ms(lambda: qz.dequant_fp16(h), flush=flush),
        _median_ms(lambda: ref.dequant_fp16_ref(h), flush=flush),
        _median_ms(lambda: h.float(), flush=flush),
        _bound(n * 2 + n * 4, n, FP32_FLOP_S),
        _host_ms(lambda: qz.dequant_fp16(h)))

    # --- fused_sgd over the whole f6.w bucket
    p, gr, m = rn(n) * 0.01, rn(n) * 0.001, rn(n) * 0.001
    lr = torch.tensor([0.01], device=dev)
    sgd_p = p.clone().requires_grad_(True)
    sgd_p.grad = gr.clone()
    sgd = torch.optim.SGD([sgd_p], lr=0.01, momentum=0.9, fused=True)
    # the yardstick: PyTorch's fused SGD on the same bytes (launched from
    # the host; its first step allocates the momentum buffer)
    row("fused_sgd", "sgd.cu", "src/repro/kernels/fused_sgd.py:24",
        fs.fused_sgd(p, gr, m, lr, 0.9), ref.fused_sgd_ref(p, gr, m, lr, 0.9),
        _median_ms(lambda: fs.fused_sgd(p, gr, m, lr, 0.9), flush=flush),
        _median_ms(lambda: ref.fused_sgd_ref(p, gr, m, lr, 0.9),
                   flush=flush),
        _event_ms(sgd.step),
        _bound(5 * n * 4, 5 * n, FP32_FLOP_S),
        _host_ms(lambda: fs.fused_sgd(p, gr, m, lr, 0.9)))
    del sgd, sgd_p

    # --- fused_rs_update on the f6.w shard: fp16 receive, and int8 with
    # one scale per received chunk (its numbers are printed on their own)
    ps, ms_, mask = rn(s) * 0.01, rn(s) * 0.001, torch.ones(s, device=dev)
    args = dict(wd_mask=mask, scale=1 / k, momentum=0.9, weight_decay=5e-4)
    fused = lambda r, sc=None: fru.fused_rs_update(r, ps, ms_, lr, **args,
                                                   scales=sc)
    plain = lambda r, sc=None: ref.fused_rs_update_ref(
        r, ps, ms_, mask, lr, 0.9, False, 1 / k, 5e-4, sc)
    row("fused_rs_update", "sgd.cu",
        "src/repro/kernels/fused_rs_update.py:53",
        fused(recv), plain(recv),
        _median_ms(lambda: fused(recv), flush=flush),
        _median_ms(lambda: plain(recv), flush=flush), None,
        _bound(recv.numel() * 2 + 5 * s * 4, (k + 7) * s, FP32_FLOP_S),
        _host_ms(lambda: fused(recv)))
    q = torch.randint(-127, 128, (k, s), generator=g, device=dev).to(
        torch.int8)
    sc = torch.rand(k, generator=g, device=dev) * 1e-3
    got_q, want_q = fused(q, sc), plain(q, sc)
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got_q, want_q)):
        _fail("fused_rs_update (int8 wire) differs from its plain version")
    err_q = max((a - b).abs().max().item() for a, b in zip(got_q, want_q))
    b_q = _bound(q.numel() + k * 4 + 5 * s * 4, (2 * k + 7) * s, FP32_FLOP_S)
    print("fused_rs_update int8 wire (_kernel_q, fused_rs_update.py:60), "
          "(2, 18874368) + (2,) scales: " +
          json.dumps({"max_abs_err": err_q,
                      "ms": _median_ms(lambda: fused(q, sc), flush=flush),
                      "plain_ms": _median_ms(lambda: plain(q, sc),
                                             flush=flush),
                      "bound_ms": b_q[0], "bound_by": b_q[1]}))
    return rows


def conv_precision(torch):
    """The weight gradient of AlexNet's c2 (5x5, 2 groups of 48 input
    channels, 27x27 maps) at batch 32 and 64 in fp32, with cuDNN and with
    PyTorch's own convolution, against fp64: max error over the largest
    magnitude. A measurement of the library, printed, not gated."""
    import torch.nn.functional as F
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 96, 27, 27, generator=g, device=dev,
                    dtype=torch.float64)
    w = torch.randn(256, 48, 5, 5, generator=g, device=dev,
                    dtype=torch.float64) * 0.05
    go = torch.randn(64, 256, 27, 27, generator=g, device=dev,
                     dtype=torch.float64)

    def wgrad(b, dtype):
        wd = w.to(dtype).requires_grad_(True)
        y = F.conv2d(x[:b].to(dtype), wd, padding=2, groups=2)
        return torch.autograd.grad(y, wd, go[:b].to(dtype))[0].double()

    out = {}
    for b in (32, 64):
        ref = wgrad(b, torch.float64)
        for name, on in (("cudnn", True), ("native", False)):
            with torch.backends.cudnn.flags(enabled=on):
                err = (wgrad(b, torch.float32) - ref).abs().max()
            out[f"{name}_b{b}"] = (err / ref.abs().max()).item()
    print("c2 weight gradient, fp32 vs fp64, max error / max |g|: "
          + json.dumps(out))


def _predicted_launches(rsplan, n_leaves: int, run: str, steps: int,
                        fused: bool):
    """Kernel launches of one rank over ``steps`` steps of a run, from its
    bucket plan: nb buckets (reduce-scattered, each shard updated and
    all-gathered) and ns small leaves (all-reduced, flat-updated).
    ``fused``: the sharded runs take the fused_rs_update kernel (the
    default where the parameters are on the card)."""
    nb, ns = rsplan.num_buckets, len(rsplan.small)
    if run == "b":       # asa16 unsharded: fp16 RS out, the sum, fp16 AG
        per_step = {"quant_fp16": 2 * nb, "dequant_fp16": nb,  # out and in,
                    "chunk_sum": nb, "fused_sgd": n_leaves}   # every leaf
    elif fused:          # sharded: fused tail, fp16 parameter AG
        per_step = {"fused_rs_update": nb, "fused_sgd": ns,
                    "quant_fp16": nb * (2 if run == "a" else 1),
                    "dequant_fp16": nb}
    else:                # sharded, unfused: sum (fp16 wire) + flat update
        per_step = {"fused_sgd": nb + ns, "dequant_fp16": nb,
                    "quant_fp16": nb * (2 if run == "a" else 1)}
        if run == "a":
            per_step["chunk_sum"] = nb
    return {name: c * steps for name, c in per_step.items()}


TRAIN_RUNS = (("a", "asa16", True), ("b", "asa16", False),
              ("c", "asa8", True))


def _train_rank(rank, k, out_dir, device, smoke):
    """One rank of the training phase (a spawned process on ``device``:
    cuda:0, or the CPU with the smoke config to rehearse)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant, sgd_momentum, step_decay
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    n_params = count_params(shapes)
    if not smoke and n_params != 60_965_224:
        _fail(f"AlexNet has {n_params} parameters, not 60,965,224")
    batch = 4 if smoke else TRAIN_BATCH
    rsplan = exchanger.make_rs_plan(shapes, k)
    n_leaves = len(leaves(shapes))
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"data{rank}"))
    opt = sgd_momentum(momentum=0.9, weight_decay=5e-4,
                       fused_kernel=fs.fused_sgd)
    lr = step_decay(0.01, steps_per_drop=TRAIN_STEPS // 2)
    out = {"runs": {}, "rank": rank}
    for run, ex, sharded in TRAIN_RUNS:
        loader = rank_loader(cfg, files, dev, TRAIN_STEPS, seed=rank)
        plan = TrainPlan(exchanger=ex, sharded_update=sharded)
        K.reset_launches()
        _, rep = train(model, opt, lr, loader, plan=plan,
                       num_steps=TRAIN_STEPS, log_every=TRAIN_STEPS,
                       seed=0, print_fn=lambda *a: None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        out["runs"][run] = dict(
            exchanger=ex, sharded=sharded, steps=rep.steps,
            losses=rep.losses, images_per_s=rep.steady_examples_per_s,
            first_step_s=rep.first_step_time,
            phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
            staged_mb_per_step=rep.staged_bytes / 1e6,
            stage_ms_per_step=rep.stage_s * 1e3,
            wire_ms_per_step=rep.wire_s * 1e3,
            launches=launches,
            predicted=_predicted_launches(rsplan, n_leaves, run,
                                          TRAIN_STEPS, dev.type == "cuda"))

    # one asa step: the two ranks on two halves of a batch, then a group
    # of one (rank 0) on the whole batch, from the same parameters
    solo = dist.new_group([0])
    src = ImageSource(cfg.image_size, cfg.num_classes)
    full = {n_: torch.from_numpy(v).to(dev)
            for n_, v in src.batch(2 * batch // 4, 12345).items()}
    half = {n_: v[rank * batch // 4:(rank + 1) * batch // 4]
            for n_, v in full.items()}
    params = model.init(torch.Generator(device=dev).manual_seed(7))
    asa = exchanger.get_exchanger("asa")
    state = {"params": params, "opt": opt.init(params), "step": 0}
    names = [f"{a}.{b}" for a in sorted(params) for b in sorted(params[a])]
    # cuDNN off: its fp32 weight-gradient path for c2 (5x5, 48 input
    # channels a group) errs by ~1 % of the gradient's scale, differently
    # at batch 32 and 64 (see the c2 line of the parent), which would
    # swamp the exchange's own agreement that this check is about
    with torch.backends.cudnn.flags(enabled=False):
        two, _ = bsp.make_bsp_step(model, opt, asa, constant(0.01))(state,
                                                                    half)
        if rank == 0:
            one, _ = bsp.make_bsp_step(model, opt, asa, constant(0.01),
                                       group=solo)(state, full)
    if rank == 0:
        per_leaf = {
            n_: {"max_abs_dp": (a - b).abs().max().item(),
                 "max_abs_step": (b - p0).abs().max().item()}
            for n_, a, b, p0 in zip(names, leaves(two["params"]),
                                    leaves(one["params"]), leaves(params))}
        out["k2_vs_k1"] = per_leaf
        out["k2_vs_k1_max_abs_dp"] = max(v["max_abs_dp"]
                                         for v in per_leaf.values())
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def train_phase(device="cuda:0", smoke=False):
    """Spawns the k=2 rank processes and checks what they report."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_train_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"rank{r}.json").read_text())
                 for r in range(k)]
    print(f"train phase: {k} gloo ranks on {device}, {wall:.1f}s")
    total = {}
    for run, ex, sharded in TRAIN_RUNS:
        r0 = ranks[0]["runs"][run]
        for rk in ranks:
            rr = rk["runs"][run]
            bad = [x for x in rr["losses"] if not math.isfinite(x)]
            if len(rr["losses"]) != TRAIN_STEPS or bad:
                _fail(f"run {run} rank {rk['rank']}: losses {rr['losses']}")
            if rr["launches"] != rr["predicted"]:
                _fail(f"run {run} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")
        for name, c in r0["launches"].items():
            total[name] = total.get(name, 0) + c
        print(f"train run ({run}) {ex}{' sharded' if sharded else ''}: " +
              json.dumps({key: r0[key] for key in (
                  "images_per_s", "first_step_s", "phase_ms",
                  "staged_mb_per_step", "stage_ms_per_step",
                  "wire_ms_per_step", "launches", "predicted", "losses")}))
    dp = ranks[0]["k2_vs_k1_max_abs_dp"]
    print("k2_vs_k1 per leaf: " + json.dumps(ranks[0]["k2_vs_k1"]))
    print(f"asa step, k=2 on halves vs k=1 on the batch: max |dp| {dp} "
          f"(bound {K_TOL})")
    if not dp <= K_TOL:
        _fail(f"k=2 and k=1 asa steps differ by {dp} > {K_TOL}")
    return total


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
    # the training kernels' equivalence: full fp32 (cuDNN's default TF32
    # would only touch the convolutions of the train phase)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows += train_kernel_phase(torch, ref, flush=l2.zero_)
    del l2
    conv_precision(torch)
    launches, stats = engine_phase(torch, K,
                                   cfg_mod.get_config("llama3.2-1b"), models,
                                   serve, torch.device("cuda"))
    torch.cuda.empty_cache()
    launches.update(train_phase())

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
