"""Training loop for one rank: engine step + batch iterable + metrics +
checkpoints (counterpart of ``repro/train/loop.py``): bsp, easgd and asgd
plans alike.

Every rank of the process group runs ``train`` on its own share of each
global batch; the engine's exchanger keeps the replicas in step.

Telemetry goes into a :class:`~repro_torch.telemetry.registry.Registry`
returned on the report (always live, and attached to the process's
telemetry for the run, so a ``--metrics-out`` sink receives it), under
the JAX loop's names:

- counters ``train/steps``, ``train/examples``, ``train/tokens`` (global,
  all ranks) and ``exchange/bytes_wire`` (this rank's analytic egress);
- histograms ``train/data_time_s``, ``train/step_time_s`` (first step
  excluded), ``train/flush_time_s``, and the step's split into
  ``train/fwd_bwd_time_s``, ``train/exchange_time_s`` and
  ``train/update_time_s`` (CUDA events on the card, read at flushes);
- gauges ``train/loss``, ``train/lr``, ``train/examples_per_s`` at flush
  boundaries and ``exchange/bytes_per_step``; at flush boundaries also
  ``train/model_flops_s`` (6·N·D of this rank's steady tokens a second,
  ``roofline.analysis.model_flops_6nd``; k ranks sharing one card give
  the card the sum), ``train/mfu`` when ``REPRO_PEAK_FLOPS`` names the
  device peak, ``train/grad_norm`` when telemetry's ``grad_norm`` knob
  is on (unsharded bsp) and ``train/device_mem_bytes``
  (``torch.cuda.memory_allocated``; absent on the CPU);
- infos ``train/plan`` and ``exchange/config``;
- the ``anomaly/train_step_time/{spikes,regressions}`` counters of a
  ``StreamDetector`` over the steady steps' host times;
- spans ``train/data``, ``train/step`` and ``train/checkpoint`` in the
  process's trace;
- per-program attribution (``telemetry.profile``): the engine's programs
  count their first call (``train/step``, or ``train/local`` /
  ``train/sync``), each later call of a program it has seen joins its
  profile through ``profile.observe``, and after the first step, in a
  ``profile/exchange_halves`` span, the exchange's reduce-scatter and
  all-gather halves are counted alone (``exchange/rs``, ``exchange/ag``;
  every rank runs them: they are collectives) and timed twice more when
  the gradients take at most 256 MiB.

Losses stay on the device between flushes: one host sync every
``log_every`` steps. An async plan's local step reports this worker's own
loss (it issues no collective); each flush averages the window's local
losses over the workers with one all-reduce, so ``TrainReport.losses``,
the ``train/loss`` gauge and the printed loss are the fleet's mean on
every step, as the reference's ``pmean`` gives them. The first step's wall time (cuDNN's algorithm
search, the allocator's first allocations) is kept apart as
``TrainReport.first_step_time`` and out of ``steady_examples_per_s``.
Dropout draws from a generator seeded from (seed, step, rank), and the
engine gets the global step index (an async plan's tau phase).

Checkpoints (``checkpoint/ckpt.py``): with ``ckpt_path`` the state is
saved every ``ckpt_every`` steps (0: only at the end) and at the last
step, keeping ``ckpt_keep`` steps, each rank into its
``ckpt.rank_dir``. ``resume_from`` restores the engine-initialised state
from such a directory and continues to ``num_steps``; it first draws and
drops the batches the checkpointed run consumed, so a run saved at step
s and resumed to n takes the same batches, dropout draws, learning
rates and (async plans) local and sync steps as an unbroken run of n
steps. An async state's ``center`` is saved and restored with the rest.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import (rank_dir, restore_for_resume,
                                        save_checkpoint)
from repro_torch.core.bsp import PHASES, KindStats, PhaseTimer
from repro_torch import telemetry
from repro_torch.models.registry import Model, count_params
from repro_torch.optim.optimizers import Optimizer
from repro_torch.roofline.analysis import model_flops_6nd
from repro_torch.telemetry import anomaly, profile, trace
from repro_torch.telemetry import metrics as tel_metrics
from repro_torch.telemetry.registry import Registry
from repro_torch.train.engine import Engine, TrainPlan, build_engine
from repro_torch.tree import leaves

# when logging is off, losses still move to the host in bounded windows
_FLUSH_CAP = 100
# the exchange halves are timed beyond their counted call only up to this
# many bytes of gradients (the reference's cap)
_HALF_TIMING_CAP_BYTES = 256 << 20


@dataclass
class TrainReport:
    steps: int = 0
    losses: list = field(default_factory=list)
    wall_time: float = 0.0
    examples_per_s: float = 0.0
    first_step_time: float = 0.0
    steady_examples_per_s: float = 0.0
    steady_tokens_per_s: float = 0.0
    # mean seconds per steady step of each phase (fwd_bwd/exchange/update)
    phase_s: dict = field(default_factory=dict)
    # per steady step: the transport's host staging of gloo collectives on
    # CUDA tensors (bytes copied, copy time), its collectives' host time
    # (both levels), the host's wait for an overlapped all-to-all, and
    # the cross-pod leg's collectives alone (two-level transports)
    staged_bytes: float = 0.0
    stage_s: float = 0.0
    wire_s: float = 0.0
    exposed_s: float = 0.0
    lead_wire_s: float = 0.0
    # async plans, per kind of steady step ("local", "sync"): "steps", the
    # mean seconds of each phase, and the mean transport counters a step
    by_kind: dict = field(default_factory=dict)
    metrics: Registry | None = None


def step_generator(seed: int, step: int, rank: int, device) -> torch.Generator:
    """The dropout generator of one (seed, step, rank)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + step) * 4099 + rank)
    return g


def _batch_counts(batch: dict, k: int) -> tuple[int, int]:
    """(examples, tokens) in the global batch of k equal shares."""
    b = int(next(iter(batch.values())).shape[0]) * k
    toks = batch.get("tokens")
    if toks is not None and toks.dim() >= 2:
        return b, b * int(toks.shape[1])
    return b, b


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _count_params(model: Model, plan: TrainPlan, params) -> int:
    """N of 6·N·D: the model's parameters (a gspmd rank holds shards, so
    its count comes from the model's shapes)."""
    if plan.algo == "gspmd":
        from repro_torch.core.gspmd import abstract_params
        params = abstract_params(model)
    return count_params(params)


def _all_ranks_ok(tr, ok: bool) -> bool:
    """Whether ``ok`` holds on every rank of the transport (its pod, and
    across pods on a two-level one): one all-reduce of a flag. A
    collective."""
    if tr.world_k == 1:
        return ok
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
    if tr.backend == "nccl":              # NCCL reduces card tensors
        flag = flag.cuda()
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=tr.group)
    if tr.lead is not None:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=tr.lead.group)
    return bool(flag.item())


def _profile_exchange_halves(engine: Engine, plan: TrainPlan,
                             params) -> None:
    """Per-half exchange attribution: the halves of
    ``exchanger.half_programs`` run alone on zeros, each counted once
    (``exchange/rs``, ``exchange/ag``, with ``wire_summary``'s bytes as
    their collective bytes) with that call timed as its ``compile/*``
    gauge, and, when the gradients take at most
    ``_HALF_TIMING_CAP_BYTES``, twice more into their profiles; their
    memory goes back to the card after. A collective: every rank calls
    it at the same step. The ranks first agree that every one of them
    built the halves and their inputs (a failure there, such as running
    out of memory, is a capture error and every rank skips the halves
    together); a fault inside the halves' collectives propagates, since
    the ranks' collectives would fall out of step."""
    from repro_torch.core.exchanger import (get_exchanger, half_programs,
                                            wire_summary)
    ex = get_exchanger(plan.exchanger)
    if ex.kind == "none":
        return
    tr = engine.transport
    try:
        rs_fn, ag_fn, grads, shards, rsplan = half_programs(
            ex, params, tr, bucket_bytes=plan.bucket_bytes)
        ws = wire_summary(ex, rsplan,
                          param_ag=bool(plan.sharded_update or plan.overlap))
    except Exception as e:  # noqa: BLE001 — never breaks training
        tel_metrics.counter("profile/capture_errors").inc()
        trace.instant("profile/exchange_halves_error",
                      error=f"{type(e).__name__}: {e}")
        rs_fn = None
    if not _all_ranks_ok(tr, rs_fn is not None):
        return
    dev = leaves(params)[0].device
    timed = sum(g.numel() * g.element_size()
                for g in leaves(grads)) <= _HALF_TIMING_CAP_BYTES
    for name, fn, arg, coll in (("exchange/rs", rs_fn, grads,
                                 ws["rs_bytes"]),
                                ("exchange/ag", ag_fn, shards,
                                 ws["ag_bytes"])):
        if not leaves(arg):
            continue
        counted = profile.instrument(name, fn, coll_bytes=coll)
        counted(arg)                  # counted, timed as compile/<name>_s
        for _ in range(2 if timed else 0):
            t0 = time.perf_counter()
            fn(arg)
            _sync(dev)
            profile.observe(name, time.perf_counter() - t0)
    # the zero gradients and the halves' buffers are needed once: hand
    # their blocks back to the card (another rank sharing it cannot use
    # this process's cached blocks)
    del grads, shards
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _fleet_losses(tr, losses: list, local: list) -> list:
    """``losses`` with each local step's entry (``local[j]`` true) averaged
    over the workers by one all-reduce (and one across pods on a
    two-level transport); a sync step's loss is already the mean. Every
    rank flushes the same steps, so the collective is matched."""
    idx = [j for j, is_local in enumerate(local) if is_local]
    if not idx or tr.world_k == 1:
        return losses
    acc = torch.tensor([losses[j] for j in idx], dtype=torch.float64)
    if tr.backend == "nccl":              # NCCL reduces card tensors
        acc = acc.cuda()
    dist.all_reduce(acc, group=tr.group)
    if tr.lead is not None:
        dist.all_reduce(acc, group=tr.lead.group)
    out = list(losses)
    for j, v in zip(idx, (acc / tr.world_k).tolist()):
        out[j] = v
    return out


def train(model: Model, optimizer: Optimizer, lr_fn, batches,
          plan: TrainPlan = TrainPlan(), *, group=None, num_steps: int = 100,
          seed: int = 0, log_every: int = 10, state=None,
          ckpt_path: str | None = None, ckpt_every: int = 0,
          ckpt_keep: int = 3, resume_from: str | None = None,
          pods: int = 1, print_fn=print) -> tuple[dict, TrainReport]:
    """``batches``: iterable of this rank's batches (dicts of tensors on
    the model's device, e.g. a ``ParallelLoader``); ``plan`` picks the
    algorithm and its knobs; ``group`` is the process group (None: the
    default one, or a single rank when none is initialised) or a
    ``Transport``; ``pods`` splits the ranks for a two-level plan.
    ``ckpt_path``/``ckpt_every``/``ckpt_keep`` save checkpoints and
    ``resume_from`` continues from one (see the module docstring)."""
    engine = build_engine(plan, model, optimizer, lr_fn, group, pods=pods)
    tr = engine.transport
    rank, k = tr.world_rank, tr.world_k
    dev = model.device
    if state is None:
        state = engine.init_state(torch.Generator(device=dev).manual_seed(
            seed))
    start_step = 0
    if resume_from:
        state, start_step = restore_for_resume(
            rank_dir(resume_from, rank, k), state, expect_algo=plan.algo)
    reg = Registry("train")
    c_steps, c_examples = reg.counter("train/steps"), reg.counter(
        "train/examples")
    c_tokens, c_wire = reg.counter("train/tokens"), reg.counter(
        "exchange/bytes_wire")
    h_data, h_step = reg.histogram("train/data_time_s"), reg.histogram(
        "train/step_time_s")
    h_flush = reg.histogram("train/flush_time_s")
    h_phase = {p: reg.histogram(f"train/{p}_time_s") for p in PHASES}
    g_loss, g_lr = reg.gauge("train/loss"), reg.gauge("train/lr")
    g_exps = reg.gauge("train/examples_per_s")
    reg.info("train/plan", algo=plan.algo, exchanger=plan.exchanger,
             scheme=plan.scheme,
             arch=getattr(getattr(model, "cfg", None), "name", ""))
    wire = engine.wire(state["params"])
    if wire:
        reg.info("exchange/config",
                 **{n: wire[n] for n in ("strategy", "wire_dtype",
                                         "ag_dtype", "k", "num_buckets",
                                         "sync_every")})
        reg.gauge("exchange/bytes_per_step").set(wire["bytes_per_step"])
    det_step = anomaly.StreamDetector("train/step_time", registry=reg)
    g_flops = reg.gauge("train/model_flops_s")
    n_params = _count_params(model, plan, state["params"])
    peak_flops = float(os.environ.get("REPRO_PEAK_FLOPS", "0") or 0)
    seen_progs: set = set()
    device_grad_norm = None

    report = TrainReport(steps=start_step, metrics=reg)
    flush_every = min(log_every, _FLUSH_CAP) if log_every else _FLUSH_CAP
    device_losses, local_steps, timers = [], [], []
    phase_sum = {p: 0.0 for p in PHASES}
    kinds = KindStats()
    n_examples = n_tokens = 0
    steady_base_ex = steady_base_tok = 0
    saved_at = None
    tr_base = (0, 0.0, 0.0, 0.0)
    lead_base = 0.0
    t0 = t_steady0 = time.perf_counter()
    it = iter(batches)
    for _ in range(start_step):        # the batches the saved run consumed
        if next(it, None) is None:
            return state, report
    telemetry.attach_registry(reg)

    def flush():
        t_f = time.perf_counter()
        losses = _fleet_losses(tr, [float(v) for v in device_losses],
                               local_steps)           # one device sync
        h_flush.observe(time.perf_counter() - t_f)
        report.losses.extend(losses)
        device_losses.clear()
        local_steps.clear()
        for tm, kind, moved in timers:
            split = tm.split_s()
            for p, s in split.items():
                h_phase[p].observe(s)
                phase_sum[p] += s
            if kind is not None:
                kinds.add(kind, split, moved)
        timers.clear()
        return losses[-1] if losses else None

    for i in range(start_step, num_steps):
        t_iter0 = time.perf_counter()
        with trace.span("train/data"):
            batch = next(it, None)
        if batch is None:
            break
        t_step0 = time.perf_counter()
        timer = PhaseTimer(dev)
        before = tr.counters()
        with trace.span("train/step", step=i):
            state, metrics = engine.step(
                state, batch, step_generator(seed, i, rank, dev), timer,
                step_idx=i)
        moved = [a - b for a, b in zip(tr.counters(), before)]
        device_losses.append(metrics["loss"])
        device_grad_norm = metrics.get("grad_norm")
        # the program this step ran (an async plan alternates local/sync)
        prog = (("train/sync" if engine.is_sync(i) else "train/local")
                if plan.is_async else "train/step")
        local_steps.append(plan.is_async and not engine.is_sync(i))
        b_ex, b_tok = _batch_counts(batch, k)
        n_examples += b_ex
        n_tokens += b_tok
        c_steps.inc()
        c_examples.inc(b_ex)
        c_tokens.inc(b_tok)
        if wire:
            c_wire.inc(wire["bytes_per_step"])
        h_data.observe(t_step0 - t_iter0)
        if i == start_step:
            # the first step carries the one-time costs: wait for it and
            # keep it out of the steady figures
            _sync(dev)
            report.first_step_time = time.perf_counter() - t_step0
            flush()
            seen_progs.add(prog)
            if profile.enabled() and wire:
                with trace.span("profile/exchange_halves"):
                    _profile_exchange_halves(engine, plan, state["params"])
            t_steady0 = time.perf_counter()
            steady_base_ex, steady_base_tok = n_examples, n_tokens
            tr_base = tr.counters()
            lead_base = tr.lead.wire_s if tr.lead else 0.0
        else:
            t_now = time.perf_counter()
            h_step.observe(t_now - t_iter0)
            det_step.observe(t_now - t_step0)
            # a program's own first call (train/sync first runs at step
            # tau - 1) carried its one-time costs: keep it out of its mean
            if prog in seen_progs:
                profile.observe(prog, t_now - t_step0)
            else:
                seen_progs.add(prog)
            timers.append((timer, (("sync" if engine.is_sync(i) else "local")
                                   if plan.is_async else None), moved))
        last = i == num_steps - 1
        if log_every and (i % log_every == 0 or last):
            loss = flush() if device_losses else report.losses[-1]
            print_fn(f"step {i:5d}  loss {loss:.4f}")
            g_loss.set(loss)
            g_lr.set(float(lr_fn(i)))
            if device_grad_norm is not None:
                reg.gauge("train/grad_norm").set(float(device_grad_norm))
            steady_t = time.perf_counter() - t_steady0
            if steady_t > 0 and n_examples > steady_base_ex:
                g_exps.set((n_examples - steady_base_ex) / steady_t)
                flops_s = model_flops_6nd(
                    n_params, (n_tokens - steady_base_tok) / k,
                    "train") / steady_t
                g_flops.set(flops_s)
                if peak_flops > 0:
                    reg.gauge("train/mfu").set(flops_s / peak_flops)
            if dev.type == "cuda":
                reg.gauge("train/device_mem_bytes").set(
                    torch.cuda.memory_allocated(dev))
            telemetry.flush(force=False)
        elif len(device_losses) >= flush_every:
            flush()
        if ckpt_path and ckpt_every and (i + 1) % ckpt_every == 0:
            with trace.span("train/checkpoint", step=i + 1):
                save_checkpoint(rank_dir(ckpt_path, rank, k), state,
                                step=i + 1, algo=plan.algo, keep=ckpt_keep)
            saved_at = i + 1
        report.steps = i + 1
    _sync(dev)
    flush()
    if ckpt_path and report.steps != saved_at:
        with trace.span("train/checkpoint", step=report.steps):
            save_checkpoint(rank_dir(ckpt_path, rank, k), state,
                            step=report.steps, algo=plan.algo,
                            keep=ckpt_keep)
    now = time.perf_counter()
    report.wall_time = now - t0
    report.examples_per_s = n_examples / max(report.wall_time, 1e-9)
    steady_steps = report.steps - start_step - 1
    if steady_steps > 0 and now > t_steady0:
        report.steady_examples_per_s = ((n_examples - steady_base_ex)
                                        / (now - t_steady0))
        report.steady_tokens_per_s = ((n_tokens - steady_base_tok)
                                      / (now - t_steady0))
        report.phase_s = {p: phase_sum[p] / steady_steps for p in PHASES}
        (report.staged_bytes, report.stage_s, report.wire_s,
         report.exposed_s) = ((now_v - base) / steady_steps for now_v, base
                              in zip(tr.counters(), tr_base))
        if tr.lead is not None:
            report.lead_wire_s = (tr.lead.wire_s - lead_base) / steady_steps
        report.by_kind = kinds.means()
    telemetry.flush(force=True)
    telemetry.detach_registry(reg)
    return state, report
