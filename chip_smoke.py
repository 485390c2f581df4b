#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit. In order:

1. Device: prints ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles every kernel source under ``src/repro_torch/csrc``
   (one ``nvcc`` each, all started together), then prints the registers
   and spills (``ptxas -v``) of the flash attention's 18 tensor-core
   kernels (forward, dq and dk/dv; bf16 and fp16; D 32, 64 and 128) and
   fails unless each one's SASS holds wgmma products (HGMMA) and TMA
   loads (UTMALDG) and no atomics, and unless the forward's six spill
   nothing; then those of the 36 split-KV decode kernels (dtype x D x
   rows a block) and the 3 combine kernels, and of the sampler's 6
   (dtype x 16-byte or scalar loads).
3. Kernels: calls each kernel's wrapper at the serve path's full-width
   llama3.2-1b shapes in bf16, holds it to its plain PyTorch version on
   the same inputs, and times the kernel, the plain version and one
   PyTorch library call as a yardstick, beside the least time the card
   could take (bytes over 3.35 TB/s or bf16 flops over 989 TFLOP/s).
   The training path's kernels (chunk_sum, the fp16 casts, fused_sgd,
   fused_rs_update) are held the same way at full-width AlexNet shapes:
   the f6.w bucket of 37,748,736 elements and its k=2 shard of
   18,874,368, against bytes over 3.35 TB/s. So are the blockwise int8
   quantizers (quant_int8, dequant_int8), which no path calls: a round
   trip through their wrappers on the f6.w bucket is their path (counts
   zeroed before it and read after), then each is held bit for bit to its
   plain version at that length and at 2,048,777, with an all-zero block
   and exact .5 ties, and timed (no PyTorch call computes the same
   function, so no library yardstick).
   The decode is the split kernel and the combine kernel (held alone to
   its plain version on partials whose dead chunks hold NaN); paged must
   equal contiguous at block_k = 16 and two calls must agree, bit for
   bit. The serve path's flash kernels are also held to their plain
   versions at head dim 128 (qwen1.5-4b's 20 heads over 20) in bf16, fp16
   and fp32: the prefill chunk and the decode, contiguous and paged,
   timed beside their D-64 times; the decode over 8 K lanes (8 slots at
   positions up to 8191: many chunks a lane), timed beside SDPA; every
   flash entry at head dims 16, 48 and 96 (zero-padded by the wrappers to
   32, 64, 128) in bf16; the sampler, bit for bit, at qwen1.5-4b's vocab
   of 151,936 as at llama3.2-1b's 128,256, at the decode's (8, 1, V) and
   the prefill tail's (1, 32, V), each shown by ``torch.profiler`` to be
   one operation on the card and timed beside an argmax of its selected
   rows, with its plan (CL blocks a slot, the slice of each).
4. Engine: serves 16 requests through the port's ``Engine`` on full
   llama3.2-1b (16 layers, random weights from a seeded generator, bf16):
   paged KV cache, fused sampling, chunked prefill, a shared-prompt
   prefix hit. The launch counts are zeroed just before and read just
   after, and every kernel of the path must have launched. A short
   ``page_size=0`` pass reaches the contiguous ``flash_decode``. Three
   prompts' teacher-forced prefill and decode logits through the kernels
   are held to the einsum path, each printed beside its distance from
   the kernels in fp32. Then the same for full qwen1.5-4b (40
   layers, d_model 2560, 20 heads of 128 over 20 KV heads, QKV bias,
   vocab 151,936): the flash kernels at head dim 128 and G = 1.
   The flash backward's two kernels (dq, and dk/dv) are held to their
   plain version at the LM training shapes (B 4, S 1024, 32 heads over 8,
   D 64, bf16), in fp32 at a smaller shape, and at G = 3 over a ragged
   S = 1000 (with the forward), and timed beside PyTorch's own flash
   backward; two backward calls at the LM shapes must agree bit for bit,
   and the order in which the flat grids launch their blocks is printed.
   At head dim 128 the forward and the backward are held the same way at
   B 2, S 1024, 20 heads over 20 and 64 over 8 (bf16 and fp16) and in
   fp32 at a smaller shape, two backward calls must agree bit for bit,
   and their times are printed beside the D-64 ones. A gradient check
   runs ``decoder_loss`` of full llama3.2-1b on 2 x 512 tokens through
   the kernels and through the einsum attention, and the same for
   qwen1.5-4b at full width, its depth cut to 4 layers.
5. Train: the paper's BSP training of full-width AlexNet (227 px, 1000
   classes, 60,965,224 parameters, fp32, TF32 off) on k=2 gloo rank
   processes that share the card; each rank takes batches of 128
   ``ImageSource`` images through the ``ParallelLoader`` (235 px cropped
   to 227), momentum SGD 0.9, weight decay 5e-4, the launcher's
   ``recipe`` (``warmup_cosine``) as for every convnet. Three
   runs of 8 steps: (a) ``asa16`` with the sharded update (the
   ``fused_rs_update`` kernel), (b) ``asa16`` unsharded with
   ``sgd_momentum(fused_kernel=fused_sgd)`` (``chunk_sum``, the fp16
   casts, ``fused_sgd``), (c) ``asa8`` sharded (the int8 variant). Each
   run's launch counts are zeroed just before it and read just after,
   and must equal what its bucket plan predicts; every loss must be
   finite; and one ``asa`` step of the two ranks on two halves of a batch
   must equal one step of a group of one on the whole batch.
   The same phase trains the paper's GoogLeNet (224 px, 1000 classes,
   both aux heads, 11,543,272 parameters; batch 32 a rank): (a) ``asa16``
   sharded with the fused tail, 6 steps, (b) ``ring16`` unsharded with
   ``fused_sgd``, 4 steps, and the k=2 = k=1 check to 1e-7; and VGG-16
   (224 px, 138,357,544 parameters; batch 16 a rank): ``asa16`` sharded,
   3 steps. Each prints its rate, step split, staging and peak memory a
   rank; its launches must equal the prediction.
6. LM train: BSP training of full llama3.2-1b (16 layers, 1,235,814,400
   parameters, bf16 compute over fp32 masters, remat) on k=2 gloo ranks
   sharing the card: batches of 4 x 1024 ``LMTokenSource`` tokens a rank
   through the ``ParallelLoader``, ``asa16`` with the sharded update (the
   fused RS tail), momentum SGD 0.9, weight decay 1e-4, ``warmup_cosine``,
   6 steps. The launch counts (flash forward twice a layer and step under
   remat, dq and dk/dv once, the wire and update kernels as the bucket
   plan says) must equal the prediction and every loss must be finite.
   At the smoke config the ranks then check that one fp32 ``asa`` step on
   two halves equals one step of a group of one on the whole batch, and
   that a run saved at step 3 and resumed to 6 equals an unbroken 6-step
   run bit for bit.
7. Training kernels at the paths' own shapes: at every (padded, shard)
   bucket shape that the LM, AlexNet, GoogLeNet and VGG-16 runs reported,
   ``quant_fp16`` / ``dequant_fp16`` (whole buckets, chunks and single
   shards, at either end of a bucket, as a ring hop casts them) and
   ``fused_rs_update`` equal their plain versions bit for bit (at the LM's
   and AlexNet's buckets also on the overlap's fp32 receive), and so
   does ``fused_sgd`` at every leaf and shard shape of the convnets.
8. Async, overlap and hier training (the paper's §4 and §3.2; it runs
   after phase 6, before phase 7's checks), on gloo ranks sharing the
   card, full-width models with random weights from a seeded
   generator: ``easgd`` at alpha 0.5 and tau 1, 2, 4 and
   ``asgd`` at tau 2 on full AlexNet (k = 2, 128 images a rank, the
   centre on ``asa16``, ``fused_sgd`` every step), 8 steps each, each
   printed with images/s, the mean local and sync step (its exchange and
   staging) and the engine's wire bytes a step; the exchange kernels must
   launch on the sync steps alone, as the bucket plan predicts, and a
   local step must move no staged byte. ``overlap="buckets"`` (2
   microbatches) beside the microbatched sharded step on full AlexNet (2
   x 64 images, 8 steps) and full llama3.2-1b (2 x (2 x 1024) tokens, 3
   steps), each with its step split, the exposed exchange (the timer's
   exchange and the host's wait) against the collectives' whole time,
   staged MB, rate and launches (m x the RS kernels, one
   fused_rs_update a bucket). ``hier16`` sharded and ``hier`` unsharded
   on full AlexNet, 4 ranks as 2 pods of 2, 32 images a rank, 4 steps,
   the cross-pod leg's time apart. At the smoke config (fp32, cuDNN
   off): ``asgd`` at tau 1 equals BSP at k x the lr (rtol 1e-5, atol
   1e-6), an ``easgd`` tau-2 run saved at step 3 and resumed to 6 equals
   the unbroken run bit for bit, the overlapped step equals the
   microbatched one and k = 2 equals k = 1, and a ``hier`` step of 4
   ranks on quarters equals a group of one on the whole batch (1e-6).

9. Elastic training (the paper's §4 lineage; it runs after phase 8):
   ``repro_torch.fault.elastic.elastic_train`` on 4 gloo slot processes
   sharing the card, full AlexNet (random weights from a seeded
   generator, fp32, TF32 off), 32 images a worker, batch
   (step + row) mod 4 of a pool of 4 that a slot draws once,
   ``easgd`` alpha 0.5, tau 4, quorum 2, the centre on
   ``asa16``, momentum 0.9 through ``fused_sgd``, the launcher's
   ``recipe``, 40 steps of the reference smoke's chaos spec (kill,
   straggle, corrupt, drop, rejoin). Prints images/s, the mean local step
   and synced round (exchange, staging), each rebuild's parts (the new
   group, the centre broadcast to the joiner, its optimizer.init), the
   counts and the round log, and slot 0's peak memory. Fails unless the
   counts are the reference's, the step-23 round weighs (0.5, 0, 1/6)
   over (0, 2), every loss is finite, every live step of every slot
   launches what the bucket plan predicts at that step's k (the exchange
   kernels on synced rounds alone, weight 0 included), an idle slot
   launches nothing, and a local step moves no transport counter. Then,
   in the same processes, the fault smoke's properties at its config
   (``repro_torch.fault.smoke``: clean, chaos in the clean band, bitwise
   replay, preempt at 26 and resume into the band), and
   ``python -m repro_torch.telemetry.validate`` on slot 0's metrics
   JSONL and trace. After every path has run, the centre exchange's
   kernels (``quant_fp16``, ``chunk_sum``, ``dequant_fp16``) are held
   bit for bit to their plain versions at its buckets at k = 3 and
   k = 4, the k of its synced rounds.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; with no CUDA device, or outside a checkout, it
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import math
import re
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
QWEN_LOGIT_TOL = 0.15  # the same through qwen1.5-4b's 40 layers: on an
                       # H100 its 3 prompts x 6 calls read 0.094 at most,
                       # while each bf16 path lay 0.083 from the kernels in
                       # fp32 (the control printed beside it), so two
                       # correct bf16 paths may differ by up to ~0.17
QWEN_GRAD_LAYERS = 4  # qwen1.5-4b's gradient check: full width, depth cut
                      # from 40 to 4 layers (three models' gradients of the
                      # 151,936 x 2560 embedding and head fit beside the
                      # engine's leftovers; 4 layers reach every kernel)
UPDATE_TOL = 0.0      # training kernels: they add rows in the plain
                      # version's order and round every product and sum on
                      # its own (no FMA), so they are held bit for bit
K_TOL = 1e-6          # one asa step, k=2 ranks on two halves vs a group of
                      # one on the whole batch, max |dp|: in full fp32
                      # (TF32 and cuDNN off) the gradients differ only by
                      # summation order (~1e-6 of |g|, so ~1e-8 at lr 0.01),
                      # and p - lr g rounds to 1 ulp of |p| < 1 (<= 1.2e-7)
K_TOL_GOOGLENET = 1e-7   # the same for GoogLeNet (|p| < 1 there, so one
                         # ulp of the update is <= 6e-8)
GOOGLENET_PARAMS = 11_543_272   # at 224 px: aux fc1 sized for the 3x3 map
                                # the forward makes (the paper: 13,378,280)
BWD_TOL = 2e-2        # flash dq/dk/dv at bf16, max |d| over the output's max
                      # |plain|: both versions round ds and p to bf16 per
                      # element but sum them in another order, and ds carries
                      # the cancellation of dp - di
BWD_TOL_FP32 = 1e-5   # the same in fp32: only the order of the sums differs
GRAD_LOSS_TOL = 1e-2  # full-width decoder_loss, kernels vs einsum attention:
                      # bf16 activations through 16 layers; the einsum path
                      # takes its scores and softmax in bf16, the kernels in
                      # fp32
GRAD_TOL = 5e-2       # each leaf's gradient there, relative Frobenius error:
                      # 16 layers of d_model 512 under the same bf16 policy
                      # measured 2.5e-2 (max) and 1.5e-2 (median) on the CPU
                      # with the plain versions, the attention projections
                      # the worst, while each side lay 2.7e-2 / 2.8e-2 from
                      # the kernels in fp32 (printed here too): the bf16
                      # policy, not the kernels, sets the disagreement.
                      # qwen1.5-4b cut to 4 layers of d_model 2560 (D 128,
                      # G 1) read 2.4e-2 (max) on an H100, each side 2.2e-2
                      # / 2.6e-2 from fp32: the same policy, the same limit
LM_STEPS = 6          # steps of the LM training run
LM_BATCH, LM_SEQ = 4, 1024   # sequences of tokens per rank and step
LM_PARAMS = 1_235_814_400    # llama3.2-1b with tied embeddings


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


def _event_ms(fn, iters: int = 20, flush=None) -> float:
    """Median device time of one call launched from the host (for a
    library call that cannot be captured in a CUDA graph)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


HOPPER = re.compile(r"fwd_hopper|bwd_d(?:q|kv)_hopper")
HOPPER_KERNELS = 18     # forward, dq, dk/dv x bf16, fp16 x D 32, 64, 128


def _ptxas(log: str, pattern: str):
    """(mangled name, {registers, spill_stores, spill_loads}) of each kernel
    whose name matches ``pattern`` in a ``ptxas -v`` log."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and re.search(pattern, m.group(1)):
            props = " ".join(lines[n + 1:n + 4])
            yield m.group(1), dict(
                registers=int(re.search(r"Used (\d+) registers", props).group(1)),
                spill_stores=int(re.search(r"(\d+) bytes spill stores", props)
                                 .group(1)),
                spill_loads=int(re.search(r"(\d+) bytes spill loads", props)
                                .group(1)))


def _dtype_label(mangled: str) -> str:
    return ("bf16" if "bfloat16" in mangled else "fp16" if "__half" in mangled
            else "fp32")


def _kernel_label(mangled: str) -> str:
    """``bwd_dq_hopper<bf16, 64>`` from a mangled kernel name."""
    return (f"{HOPPER.search(mangled).group(0)}<{_dtype_label(mangled)}, "
            f"{re.search(r'Li(\d+)E', mangled).group(1)}>")


def hopper_build_report(K):
    """The flash forward's and backward's tensor-core kernels as built:
    registers and spills (``ptxas -v``), and in their SASS the wgmma
    products (HGMMA), the TMA loads (UTMALDG) and no atomics (ATOM*,
    RED). The forward kernels must not spill."""
    regs = {_kernel_label(name): r for name, r in _ptxas(
        K.build_log("flash_attention"), HOPPER.pattern)}
    print("flash tensor-core kernels, ptxas: " + json.dumps(regs))
    sass = subprocess.run(
        [str(Path(K._nvcc()).parent / "cuobjdump"), "-sass",
         str(K._target("flash_attention"))],
        capture_output=True, text=True, timeout=300).stdout
    ops, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            fn = _kernel_label(fn) if HOPPER.search(fn) else None
            if fn:
                ops[fn] = dict(HGMMA=0, UTMALDG=0, atomics=0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if fn and m:
            op = m.group(1)
            if op in ("HGMMA", "UTMALDG"):
                ops[fn][op] += 1
            elif op.startswith("ATOM") or op == "RED":
                ops[fn]["atomics"] += 1
    print("flash tensor-core kernels, SASS instructions: " + json.dumps(ops))
    if len(regs) != HOPPER_KERNELS or sorted(ops) != sorted(regs) or not all(
            o["HGMMA"] > 0 and o["UTMALDG"] > 0 and o["atomics"] == 0
            for o in ops.values()):
        _fail(f"the {HOPPER_KERNELS} bf16/fp16 flash kernels must be built "
              f"with wgmma and TMA loads and no atomics")
    spills = {n: r for n, r in regs.items() if n.startswith("fwd_hopper")
              and r["spill_stores"] + r["spill_loads"] > 0}
    if spills:
        _fail(f"the flash forward kernels spill: {spills}")


def decode_build_report(K):
    """Registers and spills (``ptxas -v``) of every decode instantiation
    (dtype x head dim x rows a block) and of the combine kernel. Returns
    {label: {registers, spill_stores, spill_loads}}."""
    out = {}
    for name, r in _ptxas(K.build_log("flash_attention"), "decode"):
        kind = "decode_combine_kernel" if "combine" in name else "decode_kernel"
        ints = re.findall(r"Li(\d+)E", name)
        out[f"{kind}<{', '.join([_dtype_label(name)] + ints)}>"] = r
    spills = sum(r["spill_stores"] + r["spill_loads"] for r in out.values())
    print(f"flash decode kernels, ptxas ({len(out)} kernels, {spills} bytes "
          f"of spills): " + json.dumps(out))
    if not out:
        _fail("no decode kernel in the flash_attention build log")
    return out


def sampler_build_report(K):
    """Registers and spills (``ptxas -v``) of the sampler's six kernels
    (dtype x 16-byte or scalar loads, the W in ``sample_kernel<T, W>``).
    Returns {label: {registers, spill_stores, spill_loads}}."""
    out = {}
    for name, r in _ptxas(K.build_log("slot_gather"), "sample_kernel"):
        width = re.search(r"Li(\d+)E", name).group(1)
        out[f"sample_kernel<{_dtype_label(name)}, {width}>"] = r
    print("slot_gather_sample kernels, ptxas: " + json.dumps(out))
    if len(out) != 6:
        _fail(f"expected 6 sampler kernels in the slot_gather build log, "
              f"found {len(out)}")
    return out


def _bwd_grid_order(B, S, H, KV, tile=64):
    """Live tiles per block of the tensor-core backward at a causal shape
    (q_off 0, no window), in launch order, as csrc/flash_attention.cu lays
    the flat grid out: dk/dv's block n takes key tile n // (KV * B), dq's q
    tile nq - 1 - n // (KV * B), so the blocks with the most work go first.
    Returns {kernel: [live tiles of each (kv head, batch) round]}."""
    bq = tile // (H // KV)
    nq, nk = -(-S // bq), -(-S // tile)
    return {"dkv": [nq - max(0, -((bq - 1 - tile * j) // bq))
                    for j in range(nk)],
            "dq": [min(nk - 1, (min((i + 1) * bq, S) - 1) // tile) + 1
                   for i in reversed(range(nq))]}


def _serve_flash(torch, ref, fa, g, H, KV, D, dtype, flush=None, dev="cuda"):
    """The serve path's flash kernels at one head layout and dtype, each
    held to its plain version: a 32-query prefill chunk at the end of a
    1 K lane (with its lse), and the one-token decode of 8 slots at
    positions 64..1000 over 1 K lanes with its combine (_serve_decode).
    With ``flush``, each kernel's time beside its plain version's, the
    library call's and its bound. Returns {kernel name: row}."""
    import torch.nn.functional as F
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else None
    es = torch.finfo(dtype).bits // 8                # bytes a value
    scale = 1 / math.sqrt(D)
    src = "src/repro_torch/csrc/flash_attention.cu"
    label = f"{H}/{KV} heads, D {D}, {str(dtype)[6:]}"

    # --- flash_attention: one 32-row prefill chunk at the end of a 1 K lane
    B, Sq, Sk = 1, 32, 1024
    q, k, v = rn(B, Sq, H, D), rn(B, Sk, KV, D), rn(B, Sk, KV, D)
    q_off = torch.tensor([Sk - Sq], dtype=torch.int32, device=dev)
    got, lse = fa.flash_attention(q, k, v, q_off=q_off, return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, 0, scale, True)
    err = (got.float() - want.float()).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    if not (err <= (tol or FWD_TOL) and err_l <= 1e-3):
        _fail(f"flash_attention ({label}) vs plain: max err {err}, lse "
              f"{err_l}")
    rows = {"flash_attention": dict(
        name="flash_attention", src=src,
        replaces="src/repro/kernels/flash_attention.py:97", err=err,
        lse_err=err_l)}

    rows.update(_serve_decode(torch, ref, fa, g, H, KV, D, dtype, flush,
                              SERVE_POSITIONS, 1024, dev))
    if flush is None:
        return rows
    qpos = torch.arange(Sq, device=dev) + int(q_off)
    mask = (torch.arange(Sk, device=dev)[None] <= qpos[:, None])
    keys = int((qpos + 1).clamp(max=Sk).sum())          # live (row, key) pairs
    live_rows = min(int(q_off) + Sq, Sk)
    fn = lambda: fa.flash_attention(q, k, v, q_off=q_off)
    rows["flash_attention"].update(
        ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
        plain_ms=_median_ms(
            lambda: ref.flash_attention_ref(q, k, v, q_off, 0, scale),
            flush=flush),
        library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), flush=flush),
        bound=_bound(2 * q.numel() * es + 2 * live_rows * KV * D * es + 4 * B,
                     4 * D * H * keys))
    return rows


SERVE_POSITIONS = (64, 200, 333, 480, 512, 700, 871, 1000)  # 8 slots, 1 K lanes
LONG_POSITIONS = (0, 511, 1024, 2047, 4095, 5000, 7777, 8191)  # 8 K lanes


def _serve_decode(torch, ref, fa, g, H, KV, D, dtype, flush, positions, S,
                  dev="cuda"):
    """The one-token decode of len(positions) slots over lanes of S keys,
    contiguous and paged (pages of 16, a random page table, the null page
    past each position), held to the plain version; paged equal to
    contiguous at block_k = 16 bit for bit, and two calls equal bit for
    bit. The combine kernel held to its plain version on the plain
    version's chunk partials, its dead chunks poisoned with NaN. With
    ``flush``, each kernel's time beside its plain version's, SDPA's
    (contiguous) and its bound. Returns {kernel name: row}."""
    import torch.nn.functional as F
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else DECODE_TOL
    es = torch.finfo(dtype).bits // 8                # bytes a value
    scale = 1 / math.sqrt(D)
    src = "src/repro_torch/csrc/flash_attention.cu"
    label = f"{len(positions)} slots over {S} keys, {H}/{KV} heads, D {D}, " \
        f"{str(dtype)[6:]}"
    B, ps = len(positions), 16
    NP = S // ps
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    qd = rn(B, 1, H, D)
    P = B * NP + 1                                    # + the null page 0
    kp, vp = rn(P, ps, KV, D), rn(P, ps, KV, D)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    tables = perm.reshape(B, NP).contiguous()
    live = (torch.arange(NP, device=dev)[None] * ps <= pos[:, None].long())
    tables = torch.where(live, tables, 0).to(torch.int32)  # null page past pos
    lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    got_c = fa.flash_decode(qd, lk, lv, pos)
    want_c = ref.flash_decode_ref(qd, lk, lv, pos, 0, scale, 512)
    err_c = (got_c.float() - want_c.float()).abs().max().item()
    got_p = fa.flash_decode_paged(qd, kp, vp, tables, pos, page_size=ps)
    want_p = ref.flash_decode_paged_ref(qd, kp, vp, tables, pos, 0, scale, ps)
    err_p = (got_p.float() - want_p.float()).abs().max().item()
    if not (err_c <= tol and err_p <= tol):
        _fail(f"flash decode ({label}) vs plain: max err {err_c} / {err_p}")
    if not torch.equal(got_p, fa.flash_decode(qd, lk, lv, pos, block_k=ps)):
        _fail(f"flash_decode_paged != flash_decode(gathered, block_k=16) "
              f"({label})")
    if not (torch.equal(got_c, fa.flash_decode(qd, lk, lv, pos)) and
            torch.equal(got_p, fa.flash_decode_paged(qd, kp, vp, tables, pos,
                                                     page_size=ps))):
        _fail(f"two flash decode calls differ ({label})")

    # the combine, on the chunks the contiguous call makes
    chunk, ns = fa.decode_plan(S, fa.DEFAULT_DECODE_BLOCK_K, _sms(torch, dev))
    m, l, acc = ref.decode_partials_ref(qd, lk, lv, pos, 0, scale, chunk)
    chunk_live = (torch.arange(ns, device=dev)[None] * chunk
                  <= pos[:, None].long())               # (B, ns)
    dead = ~chunk_live[:, None, :, None]
    m, l = m.masked_fill(dead, float("nan")), l.masked_fill(dead, float("nan"))
    acc = acc.masked_fill(dead[..., None], float("nan"))
    comb = lambda: fa.decode_combine(m, l, acc, pos, chunk=chunk, kv_len=S,
                                     dtype=dtype)
    comb_plain = lambda: ref.combine_live_splits(m, l, acc, pos, 0, chunk,
                                                 S).to(dtype)
    err_m = (comb().float() - comb_plain().float()).abs().max().item()
    if not err_m <= tol:
        _fail(f"flash_decode_combine ({label}) vs plain: max err {err_m}")
    rows = {"flash_decode": dict(
                name="flash_decode", src=src,
                replaces="src/repro/kernels/flash_attention.py:391",
                err=err_c),
            "flash_decode_paged": dict(
                name="flash_decode_paged", src=src,
                replaces="src/repro/kernels/flash_attention.py:490",
                err=err_p),
            "flash_decode_combine": dict(
                name="flash_decode_combine", src=src,
                replaces="src/repro/kernels/flash_attention.py:474",
                err=err_m)}
    if flush is None:
        return rows

    dmask = (torch.arange(S, device=dev)[None] <= pos[:, None])[:, None, None]
    need = int((pos.long() + 1).sum())                 # visible keys, all slots
    dec_bytes = 2 * qd.numel() * es + 2 * need * KV * D * es + 4 * B
    dec_flops = 4 * D * H * need
    parts = int(chunk_live.sum()) * H           # live (chunk, query row) pairs
    calls = dict(
        flash_decode=(
            lambda: fa.flash_decode(qd, lk, lv, pos),
            lambda: ref.flash_decode_ref(qd, lk, lv, pos, 0, scale, 512),
            lambda: F.scaled_dot_product_attention(
                qd.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2),
                attn_mask=dmask, enable_gqa=True),
            _bound(dec_bytes, dec_flops)),
        flash_decode_paged=(
            lambda: fa.flash_decode_paged(qd, kp, vp, tables, pos,
                                          page_size=ps),
            lambda: ref.flash_decode_paged_ref(qd, kp, vp, tables, pos, 0,
                                               scale, ps),
            None,                         # no single library call pages
            _bound(dec_bytes + int(live.sum()) * 4, dec_flops)),
        flash_decode_combine=(
            comb, comb_plain,
            None,                         # no single library call merges
            _bound(parts * (2 + D) * 4 + 4 * B + qd.numel() * es,
                   parts * 3 * D, FP32_FLOP_S)))
    for name, (fn, plain, lib, bound) in calls.items():
        rows[name].update(
            ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
            plain_ms=_median_ms(plain, flush=flush),
            library_ms=None if lib is None else _median_ms(lib, flush=flush),
            bound=bound)
    rows["flash_decode_combine"].update(chunk=chunk, chunks=ns)
    return rows


def _sms(torch, dev) -> int:
    return torch.cuda.get_device_properties(
        torch.device(dev)).multi_processor_count if str(dev) != "cpu" else 132


def _device_ops(torch, fn) -> int:
    """Operations one call of ``fn`` runs on the card (kernels, copies and
    sets, counted by ``torch.profiler``), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


def _sampler_check(torch, ref, sg, g, S_, C, V, flush, dev="cuda"):
    """slot_gather_sample at (S_, C, V) on the card held bit for bit to
    its plain version (half the slots greedy, half at temperature 0.8),
    shown to be one operation on the card, and timed beside it and beside
    an argmax of the selected rows. The plan (CL blocks a slot, slice)
    comes with it."""
    tiny = torch.finfo(torch.float32).tiny
    lg = torch.randn(S_, C, V, generator=g, device=dev).to(torch.bfloat16)
    sel = torch.randint(0, C, (S_,), generator=g, device=dev)
    oh = torch.nn.functional.one_hot(sel, C).float()
    T = torch.tensor([0.8, 0.0] * 4, device=dev)[:S_]
    u = torch.rand(S_, V, generator=g, device=dev).clamp_min(tiny)
    nz = -torch.log(-torch.log(u))
    gk, sk = sg.slot_gather_sample(lg, oh, T, nz)
    gr, sr = ref.slot_gather_sample_ref(lg, oh, T, nz)
    if not (torch.equal(gk, gr) and torch.equal(sk, sr)):
        _fail(f"slot_gather_sample ({S_}, {C}, {V}) differs from plain")
    call = lambda: sg.slot_gather_sample(lg, oh, T, nz)  # noqa: E731
    ops = None if dev == "cpu" else _device_ops(torch, call)
    if ops not in (None, 1):
        _fail(f"slot_gather_sample ({S_}, {C}, {V}) runs {ops} operations "
              f"on the card, not one kernel")
    row = lg[torch.arange(S_, device=dev), sel]
    return dict(
        name="slot_gather_sample", src="src/repro_torch/csrc/slot_gather.cu",
        replaces="src/repro/kernels/slot_gather.py:37",
        err=float(max((gk - gr).abs().max().item(),
                      (sk - sr).abs().max().item())),
        plan=sg.sampler_plan(S_, C, V, _sms(torch, dev)), device_ops=ops,
        ms=_median_ms(call, flush=flush), host_ms=_host_ms(call),
        plain_ms=_median_ms(lambda: ref.slot_gather_sample_ref(lg, oh, T, nz),
                            flush=flush),
        library_ms=_median_ms(lambda: torch.argmax(row, -1), flush=flush),
        # the kernel reads only the one-hot-selected row of each slot
        bound=_bound(S_ * V * (2 + 4) + oh.numel() * 4 + S_ * 12, 3 * S_ * V))


def kernel_phase(torch, ref, fa, sg, flush):
    """Each serve kernel against its plain version at the serve path's
    shapes: llama3.2-1b's (32 heads over 8, D 64, vocab 128,256; the
    rows) and qwen1.5-4b's (20 over 20, D 128, vocab 151,936), the flash
    kernels there in every dtype they take."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1234)
    flash = _serve_flash(torch, ref, fa, g, 32, 8, 64, torch.bfloat16, flush)
    rows = list(flash.values())

    # --- slot_gather_sample: decode (8, 1, V) and the prefill tail (1, 32, V)
    print("slot_gather_sample clusters the card holds at once, by blocks a "
          "cluster: " + json.dumps({cl: sg.clusters_at_once(cl)
                                    for cl in (4, 8, 16)}))
    zeros = torch.zeros(8, dtype=torch.int32, device=dev)
    print("timer floor: one trivial kernel (8 int32 set to 0) timed as the "
          f"kernels are, ms: {_median_ms(zeros.zero_, flush=flush)}")
    for V in (128256, 151936):
        for S_, C in ((8, 1), (1, 32)):
            r = _sampler_check(torch, ref, sg, g, S_, C, V, flush)
            if (V, C) == (128256, 1):
                rows.append(r)
            print(f"slot_gather_sample ({S_}, {C}, {V}), equal to plain, "
                  f"library = argmax of these selected rows: " + json.dumps(
                      {k_: r[k_] for k_ in ("plan", "device_ops", "ms",
                                            "plain_ms", "library_ms",
                                            "host_ms", "bound")}))

    # --- the flash kernels at head dim 128, G = 1
    g = torch.Generator(device=dev).manual_seed(128)
    errs = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        bf = dtype == torch.bfloat16
        d128 = _serve_flash(torch, ref, fa, g, 20, 20, 128, dtype,
                            flush if bf else None)
        errs[str(dtype)[6:]] = dict(
            {n: r["err"] for n, r in d128.items()},
            lse=d128["flash_attention"]["lse_err"])
        if bf:
            beside = {n: dict({k_: r[k_] for k_ in (
                "ms", "host_ms", "plain_ms", "library_ms", "bound")},
                ms_d64=flash[n]["ms"]) for n, r in d128.items()}
    print("flash kernels at D 128 (20 heads over 20), max |d| vs plain: "
          + json.dumps(errs))
    print("flash serve kernels at D 128, bf16, beside D 64 (llama3.2-1b "
          "shapes): " + json.dumps(beside))

    # --- the decode over 8 K lanes: many chunks a lane
    long = _serve_decode(torch, ref, fa, g, 32, 8, 64, torch.bfloat16, flush,
                         LONG_POSITIONS, 8192)
    print("flash decode over 8 K lanes (8 slots at positions up to 8191, "
          "32/8 heads, D 64, bf16): " + json.dumps(
              {n: {k_: r[k_] for k_ in ("err", "ms", "host_ms", "plain_ms",
                                        "library_ms", "bound")}
               for n, r in long.items()}))
    odd_head_dims(torch, ref, fa, g)
    return rows


ODD_HEAD_DIMS = (16, 48, 96)


def odd_head_dims(torch, ref, fa, g, dev="cuda"):
    """Every flash entry at head dims the kernels are not built for (the
    wrappers zero-pad them to the next of 32, 64, 128), in bf16, held to
    its plain version: the forward with lse and the backward at B 2, S
    300, 8 heads over 2, window 100, q_off (0, 17); both decodes and the
    combine at the serve shape (_serve_decode)."""
    dtype = torch.bfloat16
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(dtype)
    errs = {}
    for D in ODD_HEAD_DIMS:
        B, S, H, KV, win = 2, 300, 8, 2, 100
        q, k, v, do = rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D), \
            rn(B, S, H, D)
        qo = torch.tensor([0, 17], dtype=torch.int32, device=dev)
        scale = 1 / math.sqrt(D)
        out, lse = fa.flash_attention(q, k, v, q_off=qo, window=win,
                                      return_lse=True)
        want, want_lse = ref.flash_attention_ref(q, k, v, qo, win, scale, True)
        e = dict(fwd=(out.float() - want.float()).abs().max().item(),
                 lse=(lse - want_lse).abs().max().item())
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=qo,
                                     window=win, sm_scale=scale)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qo, win,
                                            scale)
        e.update({n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                       got, wants)})
        if not (e["fwd"] <= FWD_TOL and e["lse"] <= 1e-3 and
                max(e["dq"], e["dk"], e["dv"]) <= BWD_TOL):
            _fail(f"flash at head dim {D} vs plain: {e}")
        dec = _serve_decode(torch, ref, fa, g, H, KV, D, dtype, None,
                            SERVE_POSITIONS, 1024, dev)
        errs[D] = dict(e, **{n: r["err"] for n, r in dec.items()})
    print(f"flash kernels at head dims {ODD_HEAD_DIMS} (padded to 32, 64, "
          f"128), bf16, max |d| vs plain (dq, dk, dv over max |plain|): "
          + json.dumps(errs))


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _check_bwd(torch, ref, fa, dtype, shape, tol, fwd_tol=None, seed=0,
               dev="cuda"):
    """The flash backward kernels (and, with ``fwd_tol``, the forward)
    against their plain versions at one shape; returns the inputs and the
    backward's errors, relative (``errs``, held to ``tol``) and absolute
    (``abs_errs``)."""
    B, S, H, KV, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(dtype)
    q, k, v, do = rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D), \
        rn(B, S, H, D)
    qo = torch.zeros(B, dtype=torch.int32, device=dev)
    scale = 1 / math.sqrt(D)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    if fwd_tol is not None:
        want, want_lse = ref.flash_attention_ref(q, k, v, qo, 0, scale, True)
        err = (out.float() - want.float()).abs().max().item()
        err_l = (lse - want_lse).abs().max().item()
        if not (err <= fwd_tol and err_l <= 1e-3):
            _fail(f"flash_attention {shape} {dtype}: max err {err}, lse "
                  f"{err_l}")
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=qo,
                                 sm_scale=scale)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qo, 0, scale)
    names = ("dq", "dk", "dv")
    errs = {n: _rel_err(a, b) for n, a, b in zip(names, got, want)}
    abs_errs = {n: (a.float() - b.float()).abs().max().item()
                for n, a, b in zip(names, got, want)}
    print(f"flash backward {shape} {str(dtype)[6:]}: max |d| / max |plain| "
          + json.dumps(errs))
    if not all(e <= tol for e in errs.values()):
        _fail(f"flash backward {shape} {dtype} vs plain: {errs} > {tol}")
    return dict(q=q, k=k, v=v, do=do, out=out, lse=lse, qo=qo, scale=scale,
                got=got, want=want, errs=errs, abs_errs=abs_errs)


def _library_bwd_ms(torch, q, k, v, do, flush):
    """PyTorch's own flash-attention backward (dq, dk, dv in one call) at
    the same shapes, K/V repeated to all H heads. A yardstick; the port
    never calls it."""
    G = q.shape[2] // k.shape[2]
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    o, lse, cq, ck, mq, mk, seed, off = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False)[:8]
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    return _event_ms(lambda: bwd(dot, qt, kt, vt, o, lse, cq, ck, mq, mk,
                                 0.0, True, seed, off), flush=flush)


def _lm_flash(torch, ref, fa, flush, shape, seed, dev="cuda"):
    """The flash forward and backward in bf16 at one causal training
    shape held to their plain versions, two backward calls bitwise equal,
    and the forward's, dq's and dk/dv's times beside PyTorch's own calls
    and their bounds (dq and dk/dv beside their plain versions too).
    Returns ({"fwd", "flash_attention_dq", "flash_attention_dkv": row},
    the _check_bwd result)."""
    B, S, H, KV, D = shape
    c = _check_bwd(torch, ref, fa, torch.bfloat16, shape, BWD_TOL,
                   fwd_tol=FWD_TOL, seed=seed, dev=dev)
    q, k, v, do, lse, qo, scale = (c[n] for n in ("q", "k", "v", "do", "lse",
                                                  "qo", "scale"))
    again = fa.flash_attention_bwd(q, k, v, c["out"], lse, do, q_off=qo,
                                   sm_scale=scale)
    same = all(torch.equal(a, b) for a, b in zip(c["got"], again))
    print(f"flash backward {shape}, two calls bitwise equal: {same}")
    if not same:
        _fail(f"two flash backward calls at {shape} differ")
    di = ref.flash_attention_di(c["out"], do)
    kw = dict(q_off=qo, window=0, sm_scale=scale)
    lib_ms = _library_bwd_ms(torch, q, k, v, do, flush)
    pairs = B * H * S * (S + 1) // 2           # live (row, key) pairs
    row_b, kv_b, st_b = B * S * H * D * 2, B * S * KV * D * 2, B * S * H * 4
    fwd = _bound(2 * row_b + 2 * kv_b + st_b, 4 * D * pairs)
    rows = {"fwd": dict(
        ms=_median_ms(lambda: fa.flash_attention(q, k, v, q_off=qo,
                                                 return_lse=True),
                      flush=flush),
        library_ms=_event_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), is_causal=True,
                                 enable_gqa=True), flush=flush),
        bound_ms=fwd[0], bound_by=fwd[1])}
    for name, line, fn, plain, nbytes, flops, outs in (
            ("flash_attention_dq", 179,
             lambda: fa.flash_attention_dq(q, k, v, lse, do, di, **kw),
             lambda: ref.flash_attention_dq_ref(q, k, v, lse, do, di, qo, 0,
                                                scale),
             3 * row_b + 2 * kv_b + 2 * st_b, 6 * D * pairs, ("dq",)),
            ("flash_attention_dkv", 214,
             lambda: fa.flash_attention_dkv(q, k, v, lse, do, di, **kw),
             lambda: ref.flash_attention_dkv_ref(q, k, v, lse, do, di, qo, 0,
                                                 scale),
             2 * row_b + 4 * kv_b + 2 * st_b, 8 * D * pairs, ("dk", "dv"))):
        rows[name] = dict(
            name=name, src="src/repro_torch/csrc/flash_attention.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            err=max(c["abs_errs"][o] for o in outs),
            rel_err=max(c["errs"][o] for o in outs),
            ms=_median_ms(fn, flush=flush), host_ms=_host_ms(fn),
            plain_ms=_median_ms(plain, flush=flush), library_ms=lib_ms,
            bound=_bound(nbytes, flops))
    return rows, c


def lm_kernel_phase(torch, ref, fa, flush, dev="cuda"):
    """The flash forward and backward kernels against their plain versions
    at the LM training shapes (B 4, S 1024, 32/8 heads, D 64; the rows),
    in fp32 at a smaller shape, at G = 3 over a ragged S, and at head dim
    128: an LM-like shape (B 2, S 1024, 20 heads over 20, qwen1.5-4b's
    G = 1) in bf16 and fp16, G = 8 (64 heads over 8) in both, and fp32;
    the D-128 times printed beside the D-64 ones."""
    B, S, H, KV, D = LM_BATCH, LM_SEQ, 32, 8, 64
    d64, _ = _lm_flash(torch, ref, fa, flush, (B, S, H, KV, D), 11, dev)
    d128, c128 = _lm_flash(torch, ref, fa, flush, (2, S, 20, 20, 128), 21,
                           dev)
    for i, (dtype, shape) in enumerate((
            (torch.float32, (1, 256, 8, 2, D)),
            (torch.bfloat16, (2, S - 24, 12, 4, D)),       # G = 3, ragged
            (torch.float16, (2, S, 20, 20, 128)),
            (torch.bfloat16, (1, S, 64, 8, 128)),
            (torch.float16, (1, S, 64, 8, 128)),
            (torch.float32, (1, 256, 8, 2, 128)))):
        fp32 = dtype == torch.float32
        _check_bwd(torch, ref, fa, dtype, shape,
                   BWD_TOL_FP32 if fp32 else BWD_TOL,
                   fwd_tol=1e-5 if fp32 else FWD_TOL, seed=12 + i, dev=dev)
    order = _bwd_grid_order(B, S, H, KV)
    print(f"flash backward grid at the LM shape: {len(order['dkv']) * KV * B} "
          f"dk/dv and {len(order['dq']) * KV * B} dq blocks, launched in rounds "
          f"of {KV * B} (kv head, batch) pairs; live tiles a block, round by "
          f"round: " + json.dumps(order))
    print("flash forward at the LM training shapes: " + json.dumps(d64["fwd"]))
    rows = [d64["flash_attention_dq"], d64["flash_attention_dkv"]]
    print("flash backward at B 4, S 1024, 32/8 heads, D 64, bf16: " +
          json.dumps({r["name"]: {k_: r[k_] for k_ in (
              "err", "rel_err", "ms", "plain_ms", "library_ms", "bound")}
              for r in rows}))
    beside = {n: dict({k_: r[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                            "bound", "bound_ms") if k_ in r},
                      ms_d64=d64[n]["ms"]) for n, r in d128.items()}
    print("flash kernels at D 128 (B 2, S 1024, 20/20 heads), bf16, beside "
          "D 64 (B 4, S 1024, 32/8 heads): " + json.dumps(dict(
              beside, errs=c128["errs"])))
    return rows


def _leaf_names(tree, prefix=""):
    """Dotted leaf paths in the port's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def lm_grad_check(torch, cfg, models, dev):
    """decoder_loss of full ``cfg`` on 2 x 512 tokens, and the gradient of
    every leaf, through the kernels and through the einsum attention."""
    import numpy as np

    from repro_torch.configs.base import with_attn_impl
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch import kernels as K
    from repro_torch.tree import flatten, unflatten
    src = LMTokenSource(cfg.vocab_size, 512)
    batch = {n: torch.from_numpy(v).to(dev)
             for n, v in src.batch(2, 4242).items()}
    master = models.build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(3))
    leaves, treedef = flatten(master)
    names = _leaf_names(master)
    out = {}
    for impl in ("flash", "ref", "fp32"):
        c = (cfg.with_overrides(dtype="float32") if impl == "fp32" else
             with_attn_impl(cfg, impl))
        model = models.build_model(c, dev)
        ps = [t.detach().requires_grad_(True) for t in leaves]
        K.reset_launches()
        loss, _ = model.loss_fn(unflatten(treedef, ps), batch)
        grads = torch.autograd.grad(loss, ps)
        _sync(torch, dev)
        out[impl] = (loss.item(), grads, dict(K.LAUNCHES))
        del ps, loss
    L = cfg.num_layers
    want_launches = {"flash_attention": (2 if cfg.remat else 1) * L,
                     "flash_attention_dq": L, "flash_attention_dkv": L}
    if dev.type == "cuda" and out["flash"][2] != want_launches:
        _fail(f"grad check launches {out['flash'][2]} != {want_launches}")
    def rel(a_impl, b_impl):
        return [((a.float() - b.float()).norm() / b.float().norm().clamp_min(
            1e-30)).item() for a, b in zip(out[a_impl][1], out[b_impl][1])]

    errs = rel("flash", "ref")
    worst = sorted(zip(errs, names), reverse=True)[:4]
    d_loss = abs(out["flash"][0] - out["ref"][0])
    print(f"grad check, {cfg.name} ({L} layers) on 2 x 512 tokens, kernels "
          f"vs einsum: "
          f"loss {out['flash'][0]:.6f} vs {out['ref'][0]:.6f} (|d| "
          f"{d_loss:.3g}); leaf gradients, relative Frobenius error: max "
          f"{max(errs):.4g}, median {float(np.median(errs)):.4g}, worst "
          f"leaves {[(n, round(e, 5)) for e, n in worst]}")
    for impl in ("flash", "ref"):
        e32 = rel(impl, "fp32")
        print(f"  {impl} (bf16) vs the kernels in fp32: loss |d| "
              f"{abs(out[impl][0] - out['fp32'][0]):.3g}; leaf gradients max "
              f"{max(e32):.4g}, median {float(np.median(e32)):.4g}")
    if not (math.isfinite(d_loss) and d_loss <= GRAD_LOSS_TOL):
        _fail(f"grad check: losses differ by {d_loss} > {GRAD_LOSS_TOL}")
    if not all(math.isfinite(e) and e <= GRAD_TOL for e in errs):
        _fail(f"grad check: a leaf gradient differs by {max(errs)} > "
              f"{GRAD_TOL}")


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def engine_phase(torch, K, cfg, models, serve, dev, logit_tol=LOGIT_TOL):
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
    for name in ("flash_attention", "flash_decode_paged",
                 "flash_decode_combine", "slot_gather_sample"):
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
    print(f"engine {cfg.name} " + json.dumps(stats))

    # contiguous pool: the path that reaches flash_decode
    eng0 = serve.Engine(model, eng.params, max_slots=4, max_seq=256,
                        prefill_chunk=32, page_size=0, fused_sampling=True,
                        device=dev)
    rids0 = [eng0.submit(p[:96], 8) for p in prompts[:4]]
    K.reset_launches()
    res0 = eng0.run()
    _sync(torch, dev)
    launches["flash_decode"] = K.LAUNCHES.get("flash_decode", 0)
    launches["flash_decode_combine"] += K.LAUNCHES.get("flash_decode_combine",
                                                       0)
    if launches["flash_decode"] <= 0:
        _fail("flash_decode was not launched by the contiguous engine run")
    if any(len(res0[int(r)]) != 8 for r in rids0):
        _fail("contiguous engine run did not finish its requests")
    print(f"contiguous engine launches ({cfg.name}) "
          + json.dumps(dict(K.LAUNCHES)))

    check_flash_vs_ref(torch, cfg, models, eng.params,
                       [p[:64] for p in prompts if len(p) >= 64][:3], dev,
                       logit_tol)
    return launches, stats


def check_flash_vs_ref(torch, cfg, models, params, prompts, dev, logit_tol):
    """Teacher-forced prefill (2 chunks) + 4 decode steps of each prompt
    through the kernels and through the einsum path, on a paged cache,
    held to ``logit_tol``; beside them, each path's distance from the
    kernels in fp32 on the same weights (the control: how far bf16
    alone moves the logits)."""
    from repro_torch.configs.base import with_attn_impl
    from repro_torch.tree import flatten, unflatten
    leaves, treedef = flatten(params)
    runs = {"flash": (with_attn_impl(cfg, "flash"), params),
            "ref": (with_attn_impl(cfg, "ref"), params),
            "fp32": (cfg.with_overrides(dtype="float32"),
                     unflatten(treedef, [t.float() for t in leaves]))}
    del leaves
    outs = {impl: [] for impl in runs}
    for impl, (c, ps) in runs.items():
        m = models.build_model(c, dev)
        for prompt in prompts:
            pool = m.init_paged_cache(1, 16, 9)
            tables = torch.arange(1, 9, dtype=torch.int32, device=dev)[None]
            toks = torch.tensor(prompt, dtype=torch.int64, device=dev)
            for ch in range(0, 64, 32):
                lg, pool = m.chunk_prefill(ps, pool, toks[None, ch:ch + 32],
                                           ch, 32, seq_len=128,
                                           block_tables=tables, page_size=16)
                outs[impl].append(lg.float())
            for i in range(4):
                lg, pool = m.decode_step(ps, pool,
                                         {"tokens": toks[None, i:i + 1]},
                                         torch.tensor([64 + i], device=dev),
                                         seq_len=128, block_tables=tables,
                                         page_size=16)
                outs[impl].append(lg.float())
    del runs
    err = lambda a, b: [(x - y).abs().max().item()
                        for x, y in zip(outs[a], outs[b])]
    errs = err("flash", "ref")
    scale = max(b.abs().max().item() for b in outs["ref"])
    top1 = sum(int((a.argmax(-1) == b.argmax(-1)).all())
               for a, b in zip(outs["flash"], outs["ref"]))
    print(f"flash vs ref logits ({cfg.name}, {len(prompts)} prompts): max "
          f"err per call {errs}, max |logit| {scale:.3f}, calls with equal "
          f"top-1 {top1}/{len(errs)}; vs the kernels in fp32: flash max "
          f"{max(err('flash', 'fp32')):.4g}, ref max "
          f"{max(err('ref', 'fp32')):.4g}")
    if not all(math.isfinite(e) for e in errs) or max(errs) > logit_tol:
        _fail(f"{cfg.name}: flash vs ref logits differ by {max(errs)} > "
              f"{logit_tol}")


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
    del q, sc, got_q, want_q, ps, ms_, mask, p, gr, m, recv
    int8_launches = int8_kernel_rows(torch, ref, qz, flush, row)
    return rows, int8_launches


INT8_ODD = 2048 * 1000 + 777       # a length that is not a multiple of 2048


def int8_kernel_rows(torch, ref, qz, flush, row, dev="cuda"):
    """The blockwise int8 quantizers: a round trip through the wrappers on
    the f6.w bucket (the counts zeroed just before and read just after:
    the path's launches), then each kernel held bit for bit to its plain
    version at that length and at INT8_ODD, and timed at the first. The
    rows go through ``row``; returns the round trip's launches. The input,
    ties and an all-zero block included, is the CPU tests' own."""
    from test_torch_ranks import int8_input

    from repro_torch import kernels as K
    n = F6_BUCKET
    x, pos = int8_input(n, dev)
    K.reset_launches()
    q, sc = qz.quant_int8(x)
    back = qz.dequant_int8(q, sc)
    _sync(torch, x.device)
    launches = dict(K.LAUNCHES)
    if launches != {"quant_int8": 1, "dequant_int8": 1}:
        _fail(f"int8 round trip launched {launches}")
    step = sc.repeat_interleave(2048)[:n]
    if not bool(((back - x).abs() <= 0.5 * step + 2.0 ** -22 * x.abs())
                .all()):
        _fail("int8 round trip lands further than half a step")
    if pos.numel() < 40 or bool((q[pos].int() % 2).any()):
        _fail(f"{pos.numel()} ties, rounded to {q[pos].tolist()[:8]}...")
    print(f"int8 round trip of {n} values: {pos.numel()} ties rounded to "
          f"even, max |x - dq(q(x))| / scale "
          f"{((back - x).abs() / step).max().item():.6f}")
    if sc[1].item() != ref.quant_int8_ref(torch.zeros(1, device=x.device))[
            1].item() or bool(q[2048:4096].any()):
        _fail("the all-zero block does not quantize to 0 with scale 1e-12")
    for n_, xx in ((INT8_ODD, int8_input(INT8_ODD, dev)[0]),
                   (n, x)):
        qq, ss = ref.quant_int8_ref(xx)
        got = qz.quant_int8(xx)
        if not (torch.equal(got[0], qq) and torch.equal(
                got[1].view(torch.int32), ss.view(torch.int32))):
            _fail(f"quant_int8 differs from its plain version at n={n_}")
        if not torch.equal(qz.dequant_int8(qq, ss).view(torch.int32),
                           ref.dequant_int8_ref(qq, ss).view(torch.int32)):
            _fail(f"dequant_int8 differs from its plain version at n={n_}")
    nb = sc.numel()
    qr, sr = ref.quant_int8_ref(x)
    # no single PyTorch call computes blockwise-absmax int8: library_ms None
    row("quant_int8", "exchange.cu", "src/repro/kernels/quantize.py:80",
        (q.view(torch.int8).float(), sc), (qr.float(), sr),
        _median_ms(lambda: qz.quant_int8(x), flush=flush),
        _median_ms(lambda: ref.quant_int8_ref(x), flush=flush), None,
        _bound(4 * n + n + 4 * nb, 5 * n, FP32_FLOP_S),
        _host_ms(lambda: qz.quant_int8(x)))
    row("dequant_int8", "exchange.cu", "src/repro/kernels/quantize.py:106",
        qz.dequant_int8(q, sc), ref.dequant_int8_ref(q, sc),
        _median_ms(lambda: qz.dequant_int8(q, sc), flush=flush),
        _median_ms(lambda: ref.dequant_int8_ref(q, sc), flush=flush), None,
        _bound(n + 4 * nb + 4 * n, n, FP32_FLOP_S),
        _host_ms(lambda: qz.dequant_int8(q, sc)))
    return launches


def wire_check(torch, ref, shapes, label, weight_decay, dev="cuda",
               overlap_m: int = 0, k: int = 2):
    """The wire, sum and update kernels at every bucket shape of a training
    run on ``k`` ranks, bit for bit against their plain versions: per
    (padded, shard) bucket, quant_fp16 of the (k, shard) chunks, of the
    first shard and of the last (a row that starts shard values into the
    bucket, as a ring hop sends it), chunk_sum of the (k, shard) fp16
    receive, dequant_fp16 of the gathered (padded,) bucket and of a
    received (shard,) row at either end, and fused_rs_update of the
    (k, shard) fp16 receive (with the run's momentum and weight decay over
    a mixed 0/1 decay mask). The values reach past fp16's range, so
    overflow to inf (and inf - inf = NaN in the sum, which must be NaN in
    both) is exercised. With ``overlap_m`` > 0 also dequant_fp16 of the
    (k, shard) receive and fused_rs_update of an fp32 (k, shard) receive at
    scale 1 / (k m): the overlap's accumulated chunks."""
    from repro_torch.kernels import chunk_sum as cs
    from repro_torch.kernels import fused_rs_update as fru
    from repro_torch.kernels import quantize as qz
    g = torch.Generator(device=dev).manual_seed(4322)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    lr = torch.tensor([0.01], device=dev)
    bits = lambda t: t.view({2: torch.int16, 4: torch.int32}[
        t.element_size()])
    same = lambda a, b: torch.equal(bits(a), bits(b))

    def same_or_nan(a, b):
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(
            bits(a)[~nan], bits(b)[~nan])
    for padded, s in shapes:
        if padded != k * s:
            _fail(f"{label} bucket {padded} is not {k} shards of {s}")
        x = rn(k, s) * 20000
        recv = x.half()
        ps, ms_ = rn(s) * 0.01, rn(s) * 0.001
        mask = (torch.rand(s, generator=g, device=dev) < 0.9).float()
        got = fru.fused_rs_update(recv, ps, ms_, lr, wd_mask=mask,
                                  scale=1 / k, momentum=0.9,
                                  weight_decay=weight_decay)
        want = ref.fused_rs_update_ref(recv, ps, ms_, mask, lr, 0.9, False,
                                       1 / k, weight_decay, None)
        ok = {"quant_fp16 (k, shard)": same(qz.quant_fp16(x),
                                            ref.quant_fp16_ref(x)),
              "chunk_sum (k, shard)": same_or_nan(cs.chunk_sum(recv),
                                                  ref.chunk_sum_ref(recv))}
        for r in (0, k - 1):
            ok[f"quant_fp16 shard {r}"] = same(qz.quant_fp16(x[r]),
                                               ref.quant_fp16_ref(x[r]))
            ok[f"dequant_fp16 shard {r}"] = same(
                qz.dequant_fp16(recv[r]), ref.dequant_fp16_ref(recv[r]))
        ok["dequant_fp16 (padded,)"] = same(
            qz.dequant_fp16(recv.reshape(-1)),
            ref.dequant_fp16_ref(recv.reshape(-1)))
        ok["fused_rs_update"] = all(same(a, b) for a, b in zip(got, want))
        if overlap_m:
            ok["dequant_fp16 (k, shard)"] = same(qz.dequant_fp16(recv),
                                                 ref.dequant_fp16_ref(recv))
            acc = x * 0.01
            got = fru.fused_rs_update(acc, ps, ms_, lr, wd_mask=mask,
                                      scale=1 / (k * overlap_m),
                                      momentum=0.9,
                                      weight_decay=weight_decay)
            want = ref.fused_rs_update_ref(acc, ps, ms_, mask, lr, 0.9, False,
                                           1 / (k * overlap_m), weight_decay,
                                           None)
            ok["fused_rs_update (fp32 receive)"] = all(
                same(a, b) for a, b in zip(got, want))
            del acc
        if not all(ok.values()):
            _fail(f"{label} bucket {padded} (k={k}): a wire, sum or update "
                  f"kernel differs from its plain version: {ok}")
        del x, recv, ps, ms_, mask, got, want
    print(f"{label}: the fp16 wire kernels, chunk_sum and fused_rs_update"
          f"{' (fp16 and fp32 receives)' if overlap_m else ''} equal their "
          f"plain versions bit for bit at k={k} at all {len(shapes)} bucket "
          f"shapes (padded, shard): {json.dumps(shapes)}")


def sgd_check(torch, ref, shapes, label, dev="cuda"):
    """fused_sgd bit for bit against its plain version at every leaf and
    shard shape of a training run (the unsharded update calls it on every
    leaf, the sharded one on the small leaves or the shards)."""
    from repro_torch.kernels import fused_sgd as fs
    g = torch.Generator(device=dev).manual_seed(4323)
    rn = lambda s: torch.randn(s, generator=g, device=dev)
    lr = torch.tensor([0.01], device=dev)
    for shape in shapes:
        p, gr, m = rn(shape) * 0.01, rn(shape) * 0.001, rn(shape) * 0.001
        got = fs.fused_sgd(p, gr, m, lr, 0.9)
        want = ref.fused_sgd_ref(p, gr, m, lr, 0.9)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            _fail(f"{label}: fused_sgd differs from its plain version at "
                  f"{tuple(shape)}")
    print(f"{label}: fused_sgd equals its plain version bit for bit at all "
          f"{len(shapes)} leaf and shard shapes")


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


def _predicted_launches(rsplan, n_leaves: int, ex: str, sharded: bool,
                        steps: int, fused: bool, k: int = 2):
    """Kernel launches of one rank over ``steps`` steps of a run, from its
    bucket plan: nb buckets (reduce-scattered, each shard updated and
    all-gathered) and ns small leaves (all-reduced, flat-updated).
    ``fused``: the sharded runs take the fused_rs_update kernel (the
    default where the parameters are on the card)."""
    nb, ns = rsplan.num_buckets, len(rsplan.small)
    ex = {"hier16": "asa16", "hier": "asa"}.get(ex, ex)   # the pod's wire
    asa16 = ex == "asa16"
    if ex == "ring16":   # k - 1 hops of each half, fp16 out and in per hop
        hops = 2 * (k - 1) * nb
        per_step = {"quant_fp16": hops, "dequant_fp16": hops}
        per_step["fused_sgd"] = ns + nb if sharded else n_leaves
    elif not sharded and ex == "asa":   # fp32: the sum alone
        per_step = {"chunk_sum": nb, "fused_sgd": n_leaves}
    elif not sharded:    # asa16: fp16 RS out, the sum, fp16 AG
        per_step = {"quant_fp16": 2 * nb, "dequant_fp16": nb,  # out and in,
                    "chunk_sum": nb, "fused_sgd": n_leaves}   # every leaf
    elif fused:          # sharded: fused tail, fp16 parameter AG
        per_step = {"fused_rs_update": nb, "fused_sgd": ns,
                    "quant_fp16": nb * (2 if asa16 else 1),
                    "dequant_fp16": nb}
    else:                # sharded, unfused: sum (fp16 wire) + flat update
        per_step = {"fused_sgd": nb + ns, "dequant_fp16": nb,
                    "quant_fp16": nb * (2 if asa16 else 1)}
        if asa16:
            per_step["chunk_sum"] = nb
    return {name: c * steps for name, c in per_step.items() if c}


# The convnet training phases: per arch, the full config's parameter count,
# images per rank and step, the runs (name, exchanger, sharded, steps),
# and whether one asa step of k=2 on halves is held to k=1 on the whole
# batch, and to what bound.
TRAIN_ARCHS = {
    "alexnet": dict(params=60_965_224, batch=128,
                    runs=(("a", "asa16", True, 8), ("b", "asa16", False, 8),
                          ("c", "asa8", True, 8)), k_tol=K_TOL),
    "googlenet": dict(params=GOOGLENET_PARAMS, batch=32,
                      runs=(("a", "asa16", True, 6),
                            ("b", "ring16", False, 4)), k_tol=K_TOL_GOOGLENET),
    "vggnet": dict(params=138_357_544, batch=16,
                   runs=(("a", "asa16", True, 3),), k_tol=None),
}


def _train_rank(rank, k, out_dir, device, smoke, arch="alexnet"):
    """One rank of a convnet training phase (a spawned process on
    ``device``: cuda:0, or the CPU with the smoke config to rehearse)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.launch.train import (rank_loader, recipe, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    spec = TRAIN_ARCHS[arch]
    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    n_params = count_params(shapes)
    if not smoke and n_params != spec["params"]:
        _fail(f"{arch} has {n_params} parameters, not {spec['params']:,}")
    batch = 4 if smoke else spec["batch"]
    rsplan = exchanger.make_rs_plan(shapes, k)
    n_leaves = len(leaves(shapes))
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"data{rank}"))
    out = {"runs": {}, "rank": rank, "params": n_params,
           "buckets": rsplan.num_buckets, "small_leaves": len(rsplan.small),
           "bucket_shapes": sorted({(b.padded, b.shard_len)
                                    for b in rsplan.buckets}),
           "leaf_shapes": sorted({tuple(t.shape) for t in leaves(shapes)})}
    for run, ex, sharded, steps in spec["runs"]:
        opt, lr = recipe(cfg, steps)
        loader = rank_loader(cfg, files, dev, steps, seed=rank)
        plan = TrainPlan(exchanger=ex, sharded_update=sharded)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        _, rep = train(model, opt, lr, loader, plan=plan,
                       num_steps=steps, log_every=steps,
                       seed=0, print_fn=lambda *a: None)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        out["runs"][run] = dict(
            exchanger=ex, sharded=sharded, steps=rep.steps, want_steps=steps,
            losses=rep.losses, images_per_s=rep.steady_examples_per_s,
            first_step_s=rep.first_step_time,
            phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
            staged_mb_per_step=rep.staged_bytes / 1e6,
            stage_ms_per_step=rep.stage_s * 1e3,
            wire_ms_per_step=rep.wire_s * 1e3,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9 if cuda
                         else None),
            launches=launches,
            predicted=_predicted_launches(rsplan, n_leaves, ex, sharded,
                                          steps, cuda, k))
        del rep
        if cuda:
            torch.cuda.empty_cache()

    if spec["k_tol"] is not None:
        # one asa step: the two ranks on two halves of a batch, then a
        # group of one (rank 0) on the whole batch, from the same parameters
        solo = dist.new_group([0])
        src = ImageSource(cfg.image_size, cfg.num_classes)
        full = {n_: torch.from_numpy(v).to(dev)
                for n_, v in src.batch(2 * batch // 4, 12345).items()}
        half = {n_: v[rank * batch // 4:(rank + 1) * batch // 4]
                for n_, v in full.items()}
        params = model.init(torch.Generator(device=dev).manual_seed(7))
        asa = exchanger.get_exchanger("asa")
        state = {"params": params, "opt": opt.init(params), "step": 0}
        names = _leaf_names(params)
        # cuDNN off: its fp32 weight-gradient path for AlexNet's c2 (5x5, 48
        # input channels a group) errs by ~1 % of the gradient's scale,
        # differently at batch 32 and 64 (see the c2 line), which would
        # swamp the exchange's own agreement that this check is about
        with torch.backends.cudnn.flags(enabled=False):
            two, _ = bsp.make_bsp_step(model, opt, asa, constant(0.01))(
                state, half)
            if rank == 0:
                one, _ = bsp.make_bsp_step(model, opt, asa, constant(0.01),
                                           group=solo)(state, full)
        if rank == 0:
            per_leaf = {
                n_: {"max_abs_dp": (a - b).abs().max().item(),
                     "max_abs_step": (b - p0).abs().max().item()}
                for n_, a, b, p0 in zip(names, leaves(two["params"]),
                                        leaves(one["params"]),
                                        leaves(params))}
            out["k2_vs_k1"] = per_leaf
            out["k2_vs_k1_max_abs_dp"] = max(v["max_abs_dp"]
                                             for v in per_leaf.values())
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def train_phase(device="cuda:0", smoke=False, arch="alexnet"):
    """Spawns the k=2 rank processes of ``arch`` and checks what they
    report; returns rank 0's launches summed over its runs, and its
    (padded, shard) bucket shapes with the leaf and shard shapes that
    fused_sgd updates."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    spec = TRAIN_ARCHS[arch]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_train_rank, k, (td, device, smoke, arch), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"rank{r}.json").read_text())
                 for r in range(k)]
    r0 = ranks[0]
    print(f"{arch} train phase: {k} gloo ranks on {device}, {wall:.1f}s; "
          f"{r0['params']:,} parameters in {r0['buckets']} buckets and "
          f"{r0['small_leaves']} small leaves")
    total = {}
    for run, ex, sharded, steps in spec["runs"]:
        for rk in ranks:
            rr = rk["runs"][run]
            bad = [x for x in rr["losses"] if not math.isfinite(x)]
            if len(rr["losses"]) != steps or bad:
                _fail(f"{arch} run {run} rank {rk['rank']}: losses "
                      f"{rr['losses']}")
            if rr["launches"] != rr["predicted"]:
                _fail(f"{arch} run {run} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")
        rr = r0["runs"][run]
        for name, c in rr["launches"].items():
            total[name] = total.get(name, 0) + c
        print(f"{arch} train run ({run}) {ex}{' sharded' if sharded else ''}"
              f", {steps} steps: " + json.dumps({key: rr[key] for key in (
                  "images_per_s", "first_step_s", "phase_ms",
                  "staged_mb_per_step", "stage_ms_per_step",
                  "wire_ms_per_step", "launches", "predicted", "losses")}))
        print(f"{arch} run ({run}) peak memory per rank, GB: " + json.dumps(
            [rk["runs"][run]["peak_mem_gb"] for rk in ranks]))
    if spec["k_tol"] is not None:
        dp = r0["k2_vs_k1_max_abs_dp"]
        print(f"{arch} k2_vs_k1 per leaf: " + json.dumps(r0["k2_vs_k1"]))
        print(f"{arch} asa step, k=2 on halves vs k=1 on the batch: max |dp| "
              f"{dp} (bound {spec['k_tol']})")
        if not dp <= spec["k_tol"]:
            _fail(f"{arch}: k=2 and k=1 asa steps differ by {dp} > "
                  f"{spec['k_tol']}")
    buckets = [tuple(b) for b in r0["bucket_shapes"]]
    sgd_shapes = ([tuple(sh) for sh in r0["leaf_shapes"]]
                  + sorted({(sh,) for _, sh in buckets}))
    return total, (buckets, sgd_shapes)


def _lm_rank(rank, k, out_dir, device, smoke):
    """One rank of the LM training phase (a spawned process on ``device``:
    cuda:0, or the CPU with the smoke config to rehearse)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model, count_params
    from repro_torch.optim import constant, sgd_momentum, warmup_cosine
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()        # the fp32 k=2 vs k=1 check wants full fp32 matmuls
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    quiet = lambda *a: None
    opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                       fused_kernel=fs.fused_sgd)
    plan = TrainPlan(exchanger="asa16", sharded_update=True)
    out = {"rank": rank}

    # --- the main path: full llama3.2-1b, asa16 with the fused RS tail
    cfg = (get_smoke_config if smoke else get_config)("llama3.2-1b")
    model = build_model(cfg, dev)
    batch, seq = (2, 64) if smoke else (LM_BATCH, LM_SEQ)
    files = write_rank_batches(cfg, rank, k, batch, LM_STEPS,
                               os.path.join(out_dir, f"lm{rank}"), seq=seq)
    loader = rank_loader(cfg, files, dev, LM_STEPS, seed=rank)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, rep = train(model, opt, warmup_cosine(0.01, 2, LM_STEPS), loader,
                       plan=plan, num_steps=LM_STEPS, log_every=LM_STEPS,
                       seed=0, print_fn=quiet)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    loader.stop()
    n_params = count_params(state["params"])
    if not smoke and n_params != LM_PARAMS:
        _fail(f"llama3.2-1b has {n_params} parameters, not {LM_PARAMS:,}")
    rsplan = exchanger.make_rs_plan(state["params"], k)
    predicted = _predicted_launches(rsplan, len(leaves(state["params"])),
                                    "asa16", True, LM_STEPS, cuda, k)
    L = cfg.num_layers
    predicted.update(flash_attention=(2 if cfg.remat else 1) * L * LM_STEPS,
                     flash_attention_dq=L * LM_STEPS,
                     flash_attention_dkv=L * LM_STEPS)
    out["main"] = dict(
        params=n_params, steps=rep.steps, losses=rep.losses,
        tokens_per_s=rep.steady_tokens_per_s,
        first_step_s=rep.first_step_time,
        phase_ms={p: v * 1e3 for p, v in rep.phase_s.items()},
        staged_mb_per_step=rep.staged_bytes / 1e6,
        stage_ms_per_step=rep.stage_s * 1e3,
        wire_ms_per_step=rep.wire_s * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        buckets=rsplan.num_buckets, launches=launches,
        bucket_shapes=sorted({(b.padded, b.shard_len)
                              for b in rsplan.buckets}),
        predicted={n: c for n, c in predicted.items() if c})
    del state, model, loader
    if cuda:
        torch.cuda.empty_cache()

    # --- one fp32 asa step at the smoke config, the attention through the
    # kernels: the two ranks on two halves, then a group of one (rank 0)
    # on the whole batch, from the same parameters
    solo = dist.new_group([0])
    scfg = get_smoke_config("llama3.2-1b").with_overrides(dtype="float32")
    smodel = build_model(scfg, dev)
    full = {n: torch.from_numpy(v).to(dev) for n, v in
            LMTokenSource(scfg.vocab_size, 64).batch(4, 777).items()}
    half = {n: v[rank * 2:(rank + 1) * 2] for n, v in full.items()}
    params = smodel.init(torch.Generator(device=dev).manual_seed(7))
    sstate = {"params": params, "opt": opt.init(params), "step": 0}
    asa = exchanger.get_exchanger("asa")
    K.reset_launches()
    two, _ = bsp.make_bsp_step(smodel, opt, asa, constant(0.01))(sstate, half)
    out["k2_launches"] = dict(K.LAUNCHES)
    if rank == 0:
        one, _ = bsp.make_bsp_step(smodel, opt, asa, constant(0.01),
                                   group=solo)(sstate, full)
        out["k2_vs_k1_max_abs_dp"] = max(
            (a - b).abs().max().item()
            for a, b in zip(leaves(two["params"]), leaves(one["params"])))
        out["k2_vs_k1_max_abs_step"] = max(
            (b - p0).abs().max().item()
            for b, p0 in zip(leaves(one["params"]), leaves(params)))

    # --- resume: a run saved at step 3 and resumed to 6 against an unbroken
    # 6-step run, at the smoke config (bf16 compute, asa16 sharded)
    rcfg = get_smoke_config("llama3.2-1b")
    rmodel = build_model(rcfg, dev)
    rfiles = write_rank_batches(rcfg, rank, k, 2, LM_STEPS,
                                os.path.join(out_dir, f"resume{rank}"),
                                seq=64)
    ck = os.path.join(out_dir, "ckpt")
    finals = []
    for kw in (dict(num_steps=LM_STEPS),
               dict(num_steps=3, ckpt_path=ck, ckpt_every=3),
               dict(num_steps=LM_STEPS, resume_from=ck)):
        rloader = rank_loader(rcfg, rfiles, dev, LM_STEPS, seed=rank)
        st, rrep = train(rmodel, opt, warmup_cosine(0.01, 2, LM_STEPS),
                         rloader, plan=plan, log_every=0, seed=0,
                         print_fn=quiet, **kw)
        rloader.stop()
        finals.append((leaves(st), rrep.steps))
    (a, na), (_, n3), (b, nb) = finals
    out["resume"] = dict(
        steps=[na, n3, nb],
        bitwise_equal=len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) if torch.is_tensor(x)
            else x == y for x, y in zip(a, b)),
        max_abs_diff=max((x.float() - y.float()).abs().max().item()
                         for x, y in zip(a, b) if torch.is_tensor(x)))
    dist.barrier()
    with open(os.path.join(out_dir, f"lm_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def lm_train_phase(device="cuda:0", smoke=False):
    """Spawns the k=2 LM rank processes and checks what they report;
    returns the main run's launches and its (padded, shard) bucket
    shapes."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_lm_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"lm_rank{r}.json").read_text())
                 for r in range(k)]
    print(f"LM train phase: {k} gloo ranks on {device}, {wall:.1f}s")
    for rk in ranks:
        m = rk["main"]
        bad = [x for x in m["losses"] if not math.isfinite(x)]
        if len(m["losses"]) != LM_STEPS or bad:
            _fail(f"LM run rank {rk['rank']}: losses {m['losses']}")
        if m["launches"] != m["predicted"]:
            _fail(f"LM run rank {rk['rank']}: launches {m['launches']} != "
                  f"predicted {m['predicted']}")
        for name in ("flash_attention", "flash_attention_dq",
                     "flash_attention_dkv"):
            if device != "cpu" and rk["k2_launches"].get(name, 0) <= 0:
                _fail(f"the LM k=2 step did not launch {name}")
        r = rk["resume"]
        if r["steps"] != [LM_STEPS, 3, LM_STEPS] or not r["bitwise_equal"]:
            _fail(f"rank {rk['rank']}: resumed run differs from the unbroken "
                  f"one: {r}")
    m = ranks[0]["main"]
    print("LM train run (llama3.2-1b, asa16 sharded): " + json.dumps(
        {key: m[key] for key in (
            "params", "tokens_per_s", "first_step_s", "phase_ms",
            "staged_mb_per_step", "stage_ms_per_step", "wire_ms_per_step",
            "buckets", "launches", "predicted", "losses")}))
    print("LM peak memory per rank, GB: " + json.dumps(
        [rk["main"]["peak_mem_gb"] for rk in ranks]))
    print("LM resume check: " + json.dumps(ranks[0]["resume"]))
    dp = ranks[0]["k2_vs_k1_max_abs_dp"]
    print(f"LM asa step (smoke config, fp32), k=2 on halves vs k=1 on the "
          f"batch: max |dp| {dp} (bound {K_TOL}; the step itself moved "
          f"parameters by up to {ranks[0]['k2_vs_k1_max_abs_step']})")
    if not dp <= K_TOL:
        _fail(f"LM k=2 and k=1 asa steps differ by {dp} > {K_TOL}")
    return dict(m["launches"]), [tuple(b) for b in m["bucket_shapes"]]


# Phase 8: async (EASGD/ASGD), overlap and hier training. The runs: the
# async plans on full AlexNet, 8 steps each, the centre on asa16; AlexNet
# and llama3.2-1b with overlap="buckets" and with the microbatched sharded
# step beside it; AlexNet on 4 ranks as 2 pods of 2.
ASYNC_RUNS = (("easgd", 1), ("easgd", 2), ("easgd", 4), ("asgd", 2))
ASYNC_STEPS = 8
ASYNC_RTOL, ASYNC_ATOL = 1e-5, 1e-6   # asgd at tau 1 vs BSP at k x lr, as
#                                       the reference's tests/test_engine.py
OVERLAP_STEPS = 8
OVERLAP_MB = 2          # microbatches of every overlap run
LM_OVERLAP_STEPS = 3
HIER_PODS, HIER_K = 2, 4
HIER_STEPS = 4
HIER_BATCH = 32         # images a rank


def _async_launches(rsplan, n_leaves: int, steps: int, tau: int):
    """An async asa16 run: fused_sgd on every leaf every step; the centre
    exchange (fp16 RS out, the sum, fp16 AG out and in) on each sync step
    alone."""
    nb = rsplan.num_buckets
    n_sync = sum(1 for i in range(steps) if (i + 1) % tau == 0)
    return {"fused_sgd": n_leaves * steps, "quant_fp16": 2 * nb * n_sync,
            "chunk_sum": nb * n_sync, "dequant_fp16": nb * n_sync}


def _overlap_launches(rsplan, n_leaves: int, steps: int, m: int,
                      fused: bool):
    """An overlapped asa16 run: per microbatch and bucket the fp16 RS out
    and, on the fused route, its receive dequantized to accumulate (else
    its chunk_sum); once a step and bucket the update (fused_rs_update,
    or fused_sgd on the shard) and the fp16 parameter AG out and in."""
    nb, ns = rsplan.num_buckets, len(rsplan.small)
    if fused:
        per_step = {"quant_fp16": nb * (m + 1), "dequant_fp16": nb * (m + 1),
                    "fused_rs_update": nb, "fused_sgd": ns}
    else:
        per_step = {"quant_fp16": nb * (m + 1), "chunk_sum": nb * m,
                    "dequant_fp16": nb, "fused_sgd": nb + ns}
    return {n: c * steps for n, c in per_step.items() if c}


def _ms(split: dict) -> dict:
    return {p: v * 1e3 for p, v in split.items()}


def _kind_ms(by_kind: dict) -> dict:
    """The loop's by_kind means, in ms and MB, with the whole step's ms."""
    return {kind: {"steps": v["steps"],
                   "step_ms": (v["fwd_bwd"] + v["exchange"]
                               + v["update"]) * 1e3,
                   "fwd_bwd_ms": v["fwd_bwd"] * 1e3,
                   "exchange_ms": v["exchange"] * 1e3,
                   "update_ms": v["update"] * 1e3,
                   "stage_ms": v["stage_s"] * 1e3,
                   "wire_ms": v["wire_s"] * 1e3,
                   "staged_mb": v["staged_bytes"] / 1e6}
            for kind, v in by_kind.items()}


def _max_dp(torch, a, b) -> float:
    from repro_torch.tree import leaves
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(leaves(a), leaves(b)))


def _run_report(torch, rep, launches, predicted, cuda) -> dict:
    """A run's rates, device split, transport counters and launches, with
    the host's mean wait for a batch and its mean wall time a steady step
    (the loop's ``train/data_time_s`` and ``train/step_time_s``)."""
    h_data, h_step = (rep.metrics["train/data_time_s"],
                      rep.metrics["train/step_time_s"])
    return dict(
        steps=rep.steps, losses=rep.losses,
        data_wait_ms=h_data.sum / max(h_data.count, 1) * 1e3,
        step_wall_ms=h_step.sum / max(h_step.count, 1) * 1e3,
        images_per_s=rep.steady_examples_per_s,
        tokens_per_s=rep.steady_tokens_per_s,
        first_step_s=rep.first_step_time, phase_ms=_ms(rep.phase_s),
        staged_mb_per_step=rep.staged_bytes / 1e6,
        stage_ms_per_step=rep.stage_s * 1e3,
        wire_ms_per_step=rep.wire_s * 1e3,
        exposed_wait_ms_per_step=rep.exposed_s * 1e3,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9 if cuda
                     else None),
        launches=launches, predicted=predicted)


def _phase8_rank(rank, k, out_dir, device, smoke):
    """One of the two ranks of phase 8's async and overlap runs."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.launch.train import (rank_loader, recipe, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import constant, sgd_momentum, warmup_cosine
    from repro_torch.train.engine import TrainPlan, plan_wire
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    quiet = lambda *a: None
    out = {"rank": rank}

    def run(model, cfg, files, plan, steps, opt_lr, predicted):
        """``predicted``: the launches, or a function of the trained
        parameters that gives them."""
        opt, lr = opt_lr
        loader = rank_loader(cfg, files, dev, steps, seed=rank)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        st, rep = train(model, opt, lr, loader, plan=plan, num_steps=steps,
                        log_every=steps, seed=0, print_fn=quiet)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        if callable(predicted):
            predicted = predicted(st["params"])
        del st
        res = _run_report(torch, rep, launches, predicted, cuda)
        res["by_kind"] = _kind_ms(rep.by_kind)
        return res

    # --- EASGD/ASGD on full AlexNet, the centre on asa16
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    rsplan = exchanger.make_rs_plan(shapes, k)
    n_leaves = len(leaves(shapes))
    batch = 4 if smoke else 128
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"data{rank}"))
    out["async"] = {}
    for algo, tau in ASYNC_RUNS:
        plan = TrainPlan(algo=algo, tau=tau, exchanger="asa16")
        res = run(model, cfg, files, plan, ASYNC_STEPS,
                  recipe(cfg, ASYNC_STEPS),
                  _async_launches(rsplan, n_leaves, ASYNC_STEPS, tau))
        res["wire_bytes_per_step"] = plan_wire(plan, shapes, k)[
            "bytes_per_step"]
        res["tau"] = tau
        out["async"][f"{algo} tau={tau}"] = res
    # --- the overlap on full AlexNet beside the microbatched sharded step
    out["overlap"] = {}
    for name, kw in (("overlap", dict(overlap="buckets")),
                     ("sharded", dict(sharded_update=True))):
        plan = TrainPlan(exchanger="asa16", microbatches=OVERLAP_MB, **kw)
        pred = (_overlap_launches(rsplan, n_leaves, OVERLAP_STEPS,
                                  OVERLAP_MB, cuda) if plan.overlap
                else _predicted_launches(rsplan, n_leaves, "asa16", True,
                                         OVERLAP_STEPS, cuda, k))
        out["overlap"][name] = run(model, cfg, files, plan, OVERLAP_STEPS,
                                   recipe(cfg, OVERLAP_STEPS), pred)
    del model
    if cuda:
        torch.cuda.empty_cache()

    # --- the smoke config, fp32 asa, cuDNN off (its fp32 weight gradient
    # errs by ~1 % of the scale, differently per batch; see the c2 line)
    solo = dist.new_group([0])
    scfg = get_smoke_config("alexnet")
    smodel = build_model(scfg, dev)
    sfiles = write_rank_batches(scfg, rank, k, 4, 6,
                                os.path.join(out_dir, f"smoke{rank}"))
    sgd = sgd_momentum(momentum=0.9, weight_decay=5e-4,
                       fused_kernel=fs.fused_sgd)
    with torch.backends.cudnn.flags(enabled=False):
        # asgd at tau 1 from a synced start against BSP at k x the lr
        finals = {}
        for name, plan, lr in (
                ("asgd", TrainPlan(algo="asgd", exchanger="asa"), 0.01),
                ("bsp", TrainPlan(exchanger="asa"), 0.01 * k)):
            loader = rank_loader(scfg, sfiles, dev, 3, seed=rank)
            st, _ = train(smodel, sgd, constant(lr), loader, plan=plan,
                          num_steps=3, log_every=0, seed=0, print_fn=quiet)
            loader.stop()
            finals[name] = st
        worst = max(((x.float() - y.float()).abs()
                     - (ASYNC_ATOL + ASYNC_RTOL * y.float().abs())).max()
                    .item() for x, y in zip(leaves(finals["asgd"]["center"]),
                                            leaves(finals["bsp"]["params"])))
        out["asgd_vs_bsp"] = {
            "max_abs_diff": _max_dp(torch, finals["asgd"]["center"],
                                    finals["bsp"]["params"]),
            "worst_excess": worst,
            "snapped": _max_dp(torch, finals["asgd"]["params"],
                               finals["asgd"]["center"]) == 0.0}
        # resume inside a tau-2 window: saved at 3, resumed to 6
        plan = TrainPlan(algo="easgd", tau=2, exchanger="asa16")
        ck = os.path.join(out_dir, "async_ckpt")
        states = []
        for kw in (dict(num_steps=6), dict(num_steps=3, ckpt_path=ck,
                                           ckpt_every=3),
                   dict(num_steps=6, resume_from=ck)):
            loader = rank_loader(scfg, sfiles, dev, 6, seed=rank)
            st, rep = train(smodel, sgd, constant(0.01), loader, plan=plan,
                            log_every=0, seed=0, print_fn=quiet, **kw)
            loader.stop()
            states.append((st, rep.steps))
        (a, na), (_, n3), (b, nb) = states
        out["async_resume"] = dict(
            steps=[na, n3, nb],
            bitwise_equal=all(
                x.dtype == y.dtype and torch.equal(x, y)
                for part in ("params", "opt", "center")
                for x, y in zip(leaves(a[part]), leaves(b[part]))))
        # the overlapped step against the microbatched one (k=2) and
        # against a group of one on the whole batch (k=1)
        src = ImageSource(scfg.image_size, scfg.num_classes)
        full = {n_: torch.from_numpy(v).to(dev)
                for n_, v in src.batch(4, 4321).items()}
        half = {n_: v[rank * 2:(rank + 1) * 2] for n_, v in full.items()}
        asa = exchanger.get_exchanger("asa")
        gen7 = lambda: torch.Generator(device=dev).manual_seed(7)
        s0 = bsp.init_sharded_train_state(smodel, sgd, gen7())
        K.reset_launches()
        ovl, _ = bsp.make_bsp_step(smodel, sgd, asa, constant(0.01),
                                   overlap="buckets",
                                   microbatches=OVERLAP_MB)(s0, half)
        out["overlap_smoke_launches"] = dict(K.LAUNCHES)
        mb, _ = bsp.make_bsp_step(smodel, sgd, asa, constant(0.01),
                                  sharded_update=True,
                                  microbatches=OVERLAP_MB)(s0, half)
        out["overlap_vs_mb_max_abs_dp"] = _max_dp(torch, ovl["params"],
                                                  mb["params"])
        if rank == 0:
            s1 = bsp.init_sharded_train_state(smodel, sgd, gen7(), solo)
            one, _ = bsp.make_bsp_step(
                smodel, sgd, asa, constant(0.01), group=solo,
                overlap="buckets", microbatches=OVERLAP_MB)(s1, full)
            out["overlap_k2_vs_k1_max_abs_dp"] = _max_dp(
                torch, ovl["params"], one["params"])
            out["overlap_max_abs_step"] = _max_dp(torch, one["params"],
                                                  s1["params"])
    del smodel
    if cuda:
        torch.cuda.empty_cache()

    # --- full llama3.2-1b with and without the overlap, 2 x (2 x 1024)
    # tokens a rank, asa16, the fused RS tail
    lcfg = (get_smoke_config if smoke else get_config)("llama3.2-1b")
    lmodel = build_model(lcfg, dev)
    lbatch, lseq = (2, 64) if smoke else (LM_BATCH, LM_SEQ)
    lfiles = write_rank_batches(lcfg, rank, k, lbatch, LM_OVERLAP_STEPS,
                                os.path.join(out_dir, f"lm{rank}"), seq=lseq)
    L, m = lcfg.num_layers, OVERLAP_MB
    flash = dict(flash_attention=(2 if lcfg.remat else 1) * L * m *
                 LM_OVERLAP_STEPS, flash_attention_dq=L * m *
                 LM_OVERLAP_STEPS, flash_attention_dkv=L * m *
                 LM_OVERLAP_STEPS)
    out["lm"] = {}
    lm_opt = sgd_momentum(momentum=0.9, weight_decay=1e-4,
                          fused_kernel=fs.fused_sgd)
    def lm_predicted(overlap):
        def of(params):
            lplan = exchanger.make_rs_plan(params, k)
            n = len(leaves(params))
            pred = (_overlap_launches(lplan, n, LM_OVERLAP_STEPS, m, cuda)
                    if overlap else _predicted_launches(
                        lplan, n, "asa16", True, LM_OVERLAP_STEPS, cuda, k))
            return dict(pred, **flash)
        return of

    for name, kw in (("overlap", dict(overlap="buckets")),
                     ("sharded", dict(sharded_update=True))):
        plan = TrainPlan(exchanger="asa16", microbatches=m, **kw)
        out["lm"][name] = run(
            lmodel, lcfg, lfiles, plan, LM_OVERLAP_STEPS,
            (lm_opt, warmup_cosine(0.01, 2, LM_OVERLAP_STEPS)),
            lm_predicted(plan.overlap))
    dist.barrier()
    with open(os.path.join(out_dir, f"p8_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _hier_rank(rank, k, out_dir, device, smoke):
    """One of the 4 ranks (2 pods of 2) of phase 8's hier runs."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import bsp, exchanger
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.launch.train import (rank_loader, recipe, set_fp32_math,
                                          write_rank_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import constant
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    from repro_torch.tree import leaves

    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    out = {"rank": rank}
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    shapes = build_model(cfg, "meta").init(None)
    per_pod = k // HIER_PODS
    rsplan = exchanger.make_rs_plan(shapes, per_pod)
    n_leaves = len(leaves(shapes))
    batch = 2 if smoke else HIER_BATCH
    files = write_rank_batches(cfg, rank, k, batch, 4,
                               os.path.join(out_dir, f"hier{rank}"))
    out["runs"] = {}
    for name, ex, sharded in (("hier16 sharded", "hier16", True),
                              ("hier", "hier", False)):
        plan = TrainPlan(exchanger=ex, sharded_update=sharded,
                         data_axes=("pod", "data"))
        opt, lr = recipe(cfg, HIER_STEPS)
        loader = rank_loader(cfg, files, dev, HIER_STEPS, seed=rank)
        K.reset_launches()
        _, rep = train(model, opt, lr, loader, plan=plan,
                       num_steps=HIER_STEPS, log_every=HIER_STEPS, seed=0,
                       pods=HIER_PODS, print_fn=lambda *a: None)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        loader.stop()
        res = _run_report(torch, rep, launches, _predicted_launches(
            rsplan, n_leaves, ex, sharded, HIER_STEPS, False, per_pod),
            cuda)
        res["cross_pod_wire_ms_per_step"] = rep.lead_wire_s * 1e3
        out["runs"][name] = res
    # one hier fp32 step of the 4 ranks on quarters against a group of one
    # on the whole batch, at the smoke config with cuDNN off
    solo = dist.new_group([0])
    tr = exchanger.make_transport(("pod", "data"), HIER_PODS)
    scfg = get_smoke_config("alexnet")
    smodel = build_model(scfg, dev)
    src = ImageSource(scfg.image_size, scfg.num_classes)
    full = {n_: torch.from_numpy(v).to(dev)
            for n_, v in src.batch(k, 999).items()}
    mine = {n_: v[rank:rank + 1] for n_, v in full.items()}
    opt, _ = recipe(scfg, 1)
    params = smodel.init(torch.Generator(device=dev).manual_seed(7))
    state = {"params": params, "opt": opt.init(params), "step": 0}
    with torch.backends.cudnn.flags(enabled=False):
        four, _ = bsp.make_bsp_step(smodel, opt,
                                    exchanger.get_exchanger("hier"),
                                    constant(0.01), tr)(state, mine)
        if rank == 0:
            one, _ = bsp.make_bsp_step(smodel, opt,
                                       exchanger.get_exchanger("asa"),
                                       constant(0.01), solo)(state, full)
            out["k4_vs_k1_max_abs_dp"] = _max_dp(torch, four["params"],
                                                 one["params"])
            out["k4_vs_k1_max_abs_step"] = _max_dp(torch, one["params"],
                                                   params)
    dist.barrier()
    with open(os.path.join(out_dir, f"hier_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _check_runs(label, ranks, key, want_steps):
    """Finite losses of the expected length and launches equal to the
    prediction, on every rank, for each run under ``key``."""
    for rk in ranks:
        for name, rr in rk[key].items():
            bad = [x for x in rr["losses"] if not math.isfinite(x)]
            if len(rr["losses"]) != want_steps or bad:
                _fail(f"{label} {name} rank {rk['rank']}: losses "
                      f"{rr['losses']}")
            if rr["launches"] != rr["predicted"]:
                _fail(f"{label} {name} rank {rk['rank']}: launches "
                      f"{rr['launches']} != predicted {rr['predicted']}")


def _sum_launches(runs) -> dict:
    total = {}
    for rr in runs:
        for name, c in rr["launches"].items():
            total[name] = total.get(name, 0) + c
    return total


_SHOW = ("images_per_s", "tokens_per_s", "first_step_s", "step_wall_ms",
         "data_wait_ms", "phase_ms",
         "exposed_wait_ms_per_step", "wire_ms_per_step", "stage_ms_per_step",
         "staged_mb_per_step", "peak_mem_gb", "launches", "predicted",
         "losses")


def async_phase(device="cuda:0", smoke=False):
    """Phase 8: spawns the 2 ranks of the async and overlap runs, then the
    4 of the hier runs, and checks what they report; returns the launches
    of each path (rank 0's, each run counted from zero)."""
    import tempfile

    from repro_torch.launch.train import run_ranks
    k = 2
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_phase8_rank, k, (td, device, smoke), backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"p8_rank{r}.json").read_text())
                 for r in range(k)]
        t1 = time.perf_counter()
        run_ranks(_hier_rank, HIER_K, (td, device, smoke), backend="gloo")
        hwall = time.perf_counter() - t1
        hranks = [json.loads(Path(td, f"hier_rank{r}.json").read_text())
                  for r in range(HIER_K)]
    print(f"async and overlap phase: {k} gloo ranks on {device}, "
          f"{wall:.1f}s; hier phase: {HIER_K} ranks as {HIER_PODS} pods, "
          f"{hwall:.1f}s")
    _check_runs("async", ranks, "async", ASYNC_STEPS)
    _check_runs("AlexNet overlap", ranks, "overlap", OVERLAP_STEPS)
    _check_runs("LM overlap", ranks, "lm", LM_OVERLAP_STEPS)
    _check_runs("hier", hranks, "runs", HIER_STEPS)
    r0 = ranks[0]
    for rk in ranks:
        for name, rr in rk["async"].items():
            local = rr["by_kind"].get("local")
            if (rr["tau"] > 1) != (local is not None) or (
                    local is not None and any(local[c] != 0.0 for c in (
                        "staged_mb", "stage_ms", "wire_ms"))):
                _fail(f"async {name} rank {rk['rank']}: a local step moved "
                      f"the transport's counters: {rr['by_kind']}")
    for name, rr in r0["async"].items():
        print(f"async run ({name}, asa16 centre), {ASYNC_STEPS} steps: "
              + json.dumps({key: rr[key] for key in (
                  "images_per_s", "first_step_s", "step_wall_ms",
                  "data_wait_ms", "by_kind",
                  "wire_bytes_per_step", "launches", "predicted",
                  "losses")}))
    a = r0["asgd_vs_bsp"]
    print(f"asgd tau=1 vs BSP at k x lr (smoke config, fp32 asa, 3 steps): "
          f"max |dc| {a['max_abs_diff']}, worst excess over rtol "
          f"{ASYNC_RTOL} / atol {ASYNC_ATOL}: {a['worst_excess']}; workers "
          f"snapped to the centre: {a['snapped']}")
    for rk in ranks:
        if not (rk["asgd_vs_bsp"]["worst_excess"] <= 0.0
                and rk["asgd_vs_bsp"]["snapped"]):
            _fail(f"rank {rk['rank']}: asgd at tau 1 differs from BSP at "
                  f"k x lr: {rk['asgd_vs_bsp']}")
        r = rk["async_resume"]
        if r["steps"] != [6, 3, 6] or not r["bitwise_equal"]:
            _fail(f"rank {rk['rank']}: the easgd run resumed inside its "
                  f"tau window differs from the unbroken one: {r}")
    print("async resume check (easgd tau 2, saved at 3, resumed to 6): "
          + json.dumps(r0["async_resume"]))
    for group in ("overlap", "lm"):
        for name, rr in r0[group].items():
            print(f"{'AlexNet' if group == 'overlap' else 'LM'} run "
                  f"({name}, asa16, {OVERLAP_MB} microbatches): "
                  + json.dumps({key: rr[key] for key in _SHOW}))
    dp = max(rk["overlap_vs_mb_max_abs_dp"] for rk in ranks)
    dk = r0["overlap_k2_vs_k1_max_abs_dp"]
    print(f"overlap step (smoke config, fp32 asa): vs the microbatched "
          f"sharded step max |dp| {dp}, k=2 vs k=1 max |dp| {dk} (bound "
          f"{K_TOL}; the step moved parameters by up to "
          f"{r0['overlap_max_abs_step']}); launches "
          + json.dumps(r0["overlap_smoke_launches"]))
    if not (dp <= K_TOL and dk <= K_TOL):
        _fail(f"the overlapped step differs: vs microbatched {dp}, k=2 vs "
              f"k=1 {dk} > {K_TOL}")
    h0 = hranks[0]
    for name, rr in h0["runs"].items():
        print(f"hier run ({name}, 2 pods x 2, {HIER_BATCH} a rank): "
              + json.dumps({key: rr[key] for key in _SHOW + (
                  "cross_pod_wire_ms_per_step",)}))
    dh = h0["k4_vs_k1_max_abs_dp"]
    print(f"hier step (smoke config, fp32), 4 ranks on quarters vs k=1 on "
          f"the batch: max |dp| {dh} (bound {K_TOL}; the step moved "
          f"parameters by up to {h0['k4_vs_k1_max_abs_step']})")
    if not dh <= K_TOL:
        _fail(f"hier: 4 ranks and a group of one differ by {dh} > {K_TOL}")
    return {"easgd_train": _sum_launches(r0["async"].values()),
            "overlap_train": _sum_launches(r0["overlap"].values()),
            "lm_overlap_train": _sum_launches(r0["lm"].values()),
            "hier_train": _sum_launches(h0["runs"].values())}


ELASTIC_SLOTS = 4
ELASTIC_BATCH = 32      # images a worker and step (phase 8's hier run's)
ELASTIC_STEPS = 40
ELASTIC_POOL = 4        # batches a slot draws once and indexes by step
ELASTIC_SPEC = "kill:3@9,straggle:2@13x2,corrupt:1@21,drop:0@29,join:3@33"
# the reference's figures for this spec (its tests/test_fault.py)
ELASTIC_COUNTS = dict(kills=1, joins=1, rebuilds=2, payloads_corrupt=1,
                      payloads_dropped=1, rounds_skipped_quorum=0)


def _elastic_step_launches(rsplan_of, n_leaves: int, k: int, sync: bool):
    """One elastic asa16 step of a live slot: fused_sgd on every leaf; on a
    synced round the centre exchange at that round's k (fp16 RS out, the
    sum, fp16 AG out and in), whatever the slot's weight."""
    if not sync:
        return {"fused_sgd": n_leaves}
    return _async_launches(rsplan_of(k), n_leaves, 1, 1)


def _phase9_rank(rank, k, out_dir, device, smoke):
    """One of the 4 slots of phase 9: elastic EASGD of full AlexNet through
    the chaos spec, then the fault smoke's properties at its config."""
    import os

    import torch

    from repro_torch import kernels as K
    from repro_torch import telemetry
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.fault import smoke as fsmoke
    from repro_torch.fault.elastic import elastic_train
    from repro_torch.launch.train import (elastic_batch_fn, recipe,
                                          set_fp32_math)
    from repro_torch.models import build_model
    from repro_torch.train.engine import TrainPlan

    set_fp32_math()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    telemetry.configure(metrics_out=os.path.join(
        out_dir, f"metrics_slot{rank}.jsonl"))
    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    model = build_model(cfg, dev)
    # a pool of this slot's batches, drawn once on the host and indexed by
    # (step + row): deterministic in both, and no global batch is drawn
    own = elastic_batch_fn(cfg, 8 if smoke else ELASTIC_BATCH, 0,
                           ELASTIC_SLOTS, dev, pool=ELASTIC_POOL)
    marks = []          # (step, k, launches so far) at each live step

    def batch_fn(step, kk, row):
        marks.append((step, kk, dict(K.LAUNCHES)))
        return own(step, kk, row)

    plan = TrainPlan(algo="easgd", tau=4, alpha=0.5, exchanger="asa16",
                     quorum=2)
    opt, lr = recipe(cfg, ELASTIC_STEPS)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, rep = elastic_train(model, opt, lr, batch_fn, plan=plan,
                               num_steps=ELASTIC_STEPS, seed=0,
                               fault_plan=ELASTIC_SPEC, log_every=0,
                               print_fn=None)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    out = {"rank": rank, "worker": rep.worker, "steps": rep.steps,
           "losses": rep.losses, "wall_s": rep.wall_time,
           "round_log": rep.round_log, "final_workers": rep.final_workers,
           "counts": {f: getattr(rep, f) for f in (
               "kills", "joins", "rebuilds", "payloads_corrupt",
               "payloads_dropped", "rounds_skipped_quorum", "rounds_synced",
               "straggles")},
           "rebuild_log": rep.rebuild_log, "by_kind": rep.by_kind,
           "marks": [(s, kk) for s, kk, _ in marks],
           "step_launches": [
               {n: c - a.get(n, 0) for n, c in (
                   marks[j + 1][2] if j + 1 < len(marks) else launches
               ).items() if c - a.get(n, 0)}
               for j, (_, _, a) in enumerate(marks)],
           "launches": launches,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None)}
    del state, model, own
    if cuda:
        torch.cuda.empty_cache()
    # the fault smoke's properties at its own config, on this device
    res_dir = os.path.join(out_dir, "smoke")
    os.makedirs(res_dir, exist_ok=True)
    opts = dict(device=str(dev), out=None, steps=48,
                workers=ELASTIC_SLOTS, tau=4, quorum=2,
                fault_plan=fsmoke.CHAOS, res_dir=res_dir)
    t0 = time.perf_counter()
    fsmoke._rank(rank, k, opts, os.path.join(out_dir, "smoke_ck"))
    out["smoke_s"] = time.perf_counter() - t0
    telemetry.flush(force=True)
    telemetry.trace.export(os.path.join(out_dir, f"trace_slot{rank}.json"))
    with open(os.path.join(out_dir, f"p9_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def elastic_phase(device="cuda:0", smoke=False):
    """Phase 9: spawns the 4 slots of the elastic run and checks what they
    report; returns the elastic path's launches (slot 0's) and, for each k
    of its synced rounds, the centre exchange's (padded, shard) buckets."""
    import os
    import tempfile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import exchanger
    from repro_torch.fault import smoke as fsmoke
    from repro_torch.launch.train import run_ranks
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = (get_smoke_config if smoke else get_config)("alexnet")
    shapes = build_model(cfg, "meta").init(None)
    n_leaves = len(leaves(shapes))
    plans = {}

    def rsplan_of(kk):
        if kk not in plans:
            plans[kk] = exchanger.make_rs_plan(shapes, kk)
        return plans[kk]

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        run_ranks(_phase9_rank, ELASTIC_SLOTS, (td, device, smoke),
                  backend="gloo")
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(td, f"p9_rank{r}.json").read_text())
                 for r in range(ELASTIC_SLOTS)]
        smoke_ranks = [json.loads(Path(td, "smoke", f"smoke{r}.json")
                                  .read_text())
                       for r in range(ELASTIC_SLOTS)]
        val = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry.validate",
             os.path.join(td, "metrics_slot0.jsonl"), "--trace",
             os.path.join(td, "trace_slot0.json")], capture_output=True,
            text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    r0 = ranks[0]
    print(f"elastic phase: {ELASTIC_SLOTS} gloo slots on {device}, "
          f"{wall:.1f}s (the fault smoke's four runs at its config "
          f"{r0['smoke_s']:.1f}s of it)")
    for rk in ranks:
        counts = {n: rk["counts"][n] for n in ELASTIC_COUNTS}
        if counts != ELASTIC_COUNTS or rk["final_workers"] != [0, 1, 2, 3]:
            _fail(f"elastic slot {rk['rank']}: counts {rk['counts']}, "
                  f"final workers {rk['final_workers']}")
        (w23,) = [(rep, w) for s, rep, w in rk["round_log"] if s == 23]
        if not (w23[0] == [0, 2] and w23[1][:2] == [0.5, 0.0]
                and abs(w23[1][2] - 0.5 / 3) < 1e-7):
            _fail(f"elastic slot {rk['rank']}: the step-23 round {w23}")
        bad = [x for x in rk["losses"] if not math.isfinite(x)]
        if len(rk["losses"]) != ELASTIC_STEPS or bad:
            _fail(f"elastic slot {rk['rank']}: losses {rk['losses']}")
        # every live step's launches, against the step's prediction at its
        # k; a slot's idle steps fall between two marks and must add none
        synced = {s for s, _, _ in rk["round_log"]}
        for (s, kk), got in zip(rk["marks"], rk["step_launches"]):
            want = _elastic_step_launches(rsplan_of, n_leaves, kk,
                                          s in synced)
            if got != want:
                _fail(f"elastic slot {rk['rank']} step {s} (k={kk}): "
                      f"launches {got} != predicted {want}")
        local = rk["by_kind"].get("local", {})
        if any(local.get(c, 0.0) != 0.0 for c in ("staged_bytes", "stage_s",
                                                    "wire_s")):
            _fail(f"elastic slot {rk['rank']}: a local step moved the "
                  f"transport's counters: {rk['by_kind']}")
    for rk in ranks:
        ran = {s for s, _ in rk["marks"]}
        idle = [s for s in range(ELASTIC_STEPS) if s not in ran]
        print(f"elastic slot {rk['rank']}: {len(ran)} live steps, idle at "
              f"steps {idle or 'none'} (launches there: none, checked); "
              f"worker at the end {rk['worker']}")
    images = sum(len(rk["marks"]) for rk in ranks) * (
        8 if smoke else ELASTIC_BATCH)
    wall_run = max(rk["wall_s"] for rk in ranks)
    bk = r0["by_kind"]
    print(f"elastic run (full AlexNet, easgd tau 4 alpha 0.5 quorum 2, "
          f"asa16 centre, {ELASTIC_BATCH} images a worker, "
          f"{ELASTIC_STEPS} steps, spec {ELASTIC_SPEC}): "
          + json.dumps({
              "images_per_s": images / wall_run, "wall_s": wall_run,
              "local_step_ms": _kind_ms({"local": bk["local"]})["local"],
              "sync_round_ms": _kind_ms({"sync": bk["sync"]})["sync"],
              "peak_mem_gb_slot0": r0["peak_mem_gb"],
              "counts": r0["counts"], "final_workers": r0["final_workers"],
              "losses": r0["losses"]}))
    # a slot that was idle waits in new_group for the live ones: slot 0
    # (live throughout) times the group and sends the centre; the
    # joiner's optimizer.init is its own
    for j, rb in enumerate(r0["rebuild_log"]):
        init_ms = max(rk["rebuild_log"][j]["opt_init_s"] for rk in ranks)
        print(f"elastic rebuild at step {rb['step']}: {rb['old']} -> "
              f"{rb['new']}, new_group {rb['new_group_s'] * 1e3:.1f} ms, "
              f"centre broadcast {rb['broadcast_s'] * 1e3:.1f} ms, the "
              f"joiner's optimizer.init {init_ms * 1e3:.1f} ms (slot 0's "
              f"view; a synced round takes "
              f"{_kind_ms({'s': bk['sync']})['s']['step_ms']:.1f} ms)")
    per_k = {}
    for s, rep, _ in r0["round_log"]:
        kk = dict(r0["marks"])[s]
        per_k.setdefault(kk, []).append(s)
    print("elastic synced rounds by k, each round's predicted launches: "
          + json.dumps({kk: {"rounds": steps, "launches":
                             _elastic_step_launches(rsplan_of, n_leaves, kk,
                                                    True)}
                        for kk, steps in per_k.items()}))
    print("elastic round_log: " + json.dumps(r0["round_log"]))
    failures = fsmoke.check(smoke_ranks, 48, print_fn=lambda s: print(
        f"elastic smoke config on {device}: {s}"))
    if failures:
        _fail(f"the fault smoke's properties failed on {device}: "
              f"{failures}")
    print(f"telemetry validate (slot 0's metrics JSONL and trace): "
          f"{val.stdout.strip()} {val.stderr.strip()}")
    if val.returncode != 0:
        _fail("slot 0's telemetry does not validate")
    return {"elastic": r0["launches"]}, {
        kk: [(b.padded, b.shard_len) for b in rsplan_of(kk).buckets]
        for kk in sorted(per_k)}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    # the port, and the CPU tests' JAX-free input makers (test_torch_ranks)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
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
    hopper_build_report(K)
    decode_build_report(K)
    sampler_build_report(K)

    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, ref, fa, sg, flush=l2.zero_)
    # the training kernels' equivalence: full fp32 (cuDNN's default TF32
    # would only touch the convolutions of the train phase)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_rows, int8_launches = train_kernel_phase(torch, ref, flush=l2.zero_)
    rows += train_rows
    rows += lm_kernel_phase(torch, ref, fa, flush=l2.zero_)
    del l2
    torch.cuda.empty_cache()
    conv_precision(torch)
    llama = cfg_mod.get_config("llama3.2-1b")
    launches, stats = engine_phase(torch, K, llama, models, serve,
                                   torch.device("cuda"))
    torch.cuda.empty_cache()
    qwen = cfg_mod.get_config("qwen1.5-4b")
    qwen_launches, _ = engine_phase(torch, K, qwen, models, serve,
                                    torch.device("cuda"), QWEN_LOGIT_TOL)
    torch.cuda.empty_cache()
    lm_grad_check(torch, llama, models, torch.device("cuda"))
    torch.cuda.empty_cache()
    lm_grad_check(torch, qwen.with_overrides(num_layers=QWEN_GRAD_LAYERS),
                  models, torch.device("cuda"))
    torch.cuda.empty_cache()
    # launches per kernel and main path (serving llama3.2-1b and
    # qwen1.5-4b, the convnets' training, LM training, the int8 round
    # trip), each path counted from zero around its run
    by_path = {"serve": launches, "serve_qwen1.5-4b": qwen_launches}
    conv_shapes = {}
    for arch in TRAIN_ARCHS:
        by_path[f"{arch}_train"], conv_shapes[arch] = train_phase(arch=arch)
    by_path["int8_roundtrip"] = int8_launches
    by_path["lm_train"], lm_buckets = lm_train_phase()
    by_path.update(async_phase())
    elastic_launches, elastic_buckets = elastic_phase()
    by_path.update(elastic_launches)
    # the kernels of every training path, held to their plain versions at
    # the shapes that path gave them (the overlap's fp32 accumulated
    # receives into fused_rs_update at the LM's and AlexNet's buckets)
    wire_check(torch, ref, lm_buckets, "LM", 1e-4, overlap_m=OVERLAP_MB)
    for arch, (buckets, sgd_shapes) in conv_shapes.items():
        wire_check(torch, ref, buckets, arch, 5e-4,
                   overlap_m=OVERLAP_MB if arch == "alexnet" else 0)
        sgd_check(torch, ref, sgd_shapes, arch)
        torch.cuda.empty_cache()
    # the elastic centre exchange's buckets at each k of its synced rounds
    for kk, buckets in elastic_buckets.items():
        wire_check(torch, ref, buckets, "alexnet elastic", 5e-4, k=kk)
        torch.cuda.empty_cache()

    out = []
    for r in rows:
        b_ms, b_by = r["bound"]
        out.append({"name": r["name"], "route": "cuda", "source": r["src"],
                    "replaces": r["replaces"],
                    "launches": sum(p.get(r["name"], 0)
                                    for p in by_path.values()),
                    "launches_by_path": {p: c[r["name"]]
                                         for p, c in by_path.items()
                                         if c.get(r["name"])},
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"]})
        if "rel_err" in r:
            out[-1]["max_rel_err"] = r["rel_err"]
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
