"""``elastic_train`` — the fault-tolerant async training loop on ranks
(counterpart of ``repro/fault/elastic.py``).

Drives the engine's quorum-sync programs (``build_elastic_programs``)
under a :class:`~repro_torch.fault.membership.MembershipController` and
an optional seeded :class:`~repro_torch.fault.inject.FaultPlan`, with the
reference's rules:

- every step is a local per-worker descent; every tau-th step is a round
  boundary where live, non-straggling workers report;
- the averaging round proceeds iff >= quorum workers report — each
  reporting delta is absorbed with the staleness-scaled coefficient
  ``alpha / (1 + staleness)``; below quorum the round degrades to a
  local step and every delta ages one round;
- ``corrupt`` injections flip a real bit in the worker's wire payload;
  the crc32 check detects it and the round excludes that payload;
- membership changes (kill/join) land at round boundaries;
- checkpoints are crash-safe and record the membership, so a preempted
  run resumes onto the checkpoint's fleet.

**Slots.** The reference keeps its workers' rows on ``len(devices)``
devices. Here the world's processes (the default process group) are the
slots: a live worker is one rank that holds its own row (``params``,
``opt``) and a replica of the ``center``. A killed worker's process stays
up as an idle slot, as the reference's device stays visible: it computes
nothing and issues no collective, but it enters every ``dist.new_group``
call (every world rank must, in one order), and it is reused when a
worker joins into that slot (``apply_pending`` hands out the lowest free
slot).

**Agreement without messages.** Every rank runs the same controller over
the same ``FaultPlan``, so all ranks agree on the membership, the
reporting set and the weights with no message. The straggler detector
is fed each rank's own step time times the ``slow`` factors: its
decision is relative (``rel_thresh`` 3 against a factor of 8), so every
rank flags the same worker whatever its clock read.

**Rebuild** is a new process group over the live slots (``fault/rebuild``)
and the programs built on it. **Reshard** (``fault/reshard``) moves no
survivor row: a joiner receives the ``center`` by broadcast from the
lowest slot of a survivor, starts its params at the center and takes a
fresh ``optimizer.init`` (what ``core.easgd.reshard_async_state`` does to
the stacked rows, which stays for checkpoints and tests).

**Row order is not group rank.** A group orders its ranks by global rank;
the membership's row order is ``controller.workers``, joiners appended.
The quorum sync reads the weights at the worker's row, and a worker's
batch is ``batch_fn(step, k, row)``: its row of the step's global batch.

**Losses.** A worker's local steps issue no collective, so the loop keeps
each worker's own loss on its device and, after the last step, one
all-reduce over the world sums them by step: ``ElasticReport.losses`` is
the mean over the live workers of each step, as the reference's
``pmean``, on every rank.

**Checkpoints.** Each live worker saves its own state under
``<ckpt_path>/worker<w>/`` (its row, the center and the step; the
membership in the meta). On resume every slot takes the newest step that
every worker recorded in it holds valid, so no two workers resume from
different steps after a torn save.

Determinism contract (the reference's): with the same seed, batch
function and ``FaultPlan``, two runs are bit-identical. Membership soft
state (staleness, in-flight straggles) is not checkpointed: on resume it
re-forms.

Telemetry (each slot records into its own process's registry): counters
``fault/kills``, ``fault/joins``, ``fault/joins_rejected``,
``fault/straggles``, ``fault/payloads_dropped``,
``fault/payloads_corrupt``, ``fault/rounds_synced``,
``fault/rounds_skipped_quorum``, ``fault/rebuilds``,
``fault/ckpt_fallbacks``, ``anomaly/stragglers_flagged``; gauges
``fault/live_workers``, ``fault/quorum``, ``fault/round_staleness_max``,
``fault/round_staleness_mean``, ``fault/absorbed_weight_sum``; spans
``fault/round`` (with membership attrs), ``fault/rebuild``,
``fault/reshard``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import (load_meta, restore_for_resume,
                                        save_checkpoint, valid_steps)
from repro_torch.core.bsp import KindStats, PhaseTimer
from repro_torch.fault.inject import FaultPlan, bitflip, payload_checksum
from repro_torch.fault.membership import MembershipController, WorkerState
from repro_torch.telemetry import anomaly, metrics, profile, trace
from repro_torch.train.engine import TrainPlan, build_elastic_programs
from repro_torch.train.loop import step_generator
from repro_torch.tree import leaves, tree_map


class Preempted(RuntimeError):
    """Raised when ``stop_at_step`` preempts the run mid-flight (the
    whole-process kill the resume property test injects). The partially
    trained state survives only through checkpoints."""

    def __init__(self, step: int):
        super().__init__(f"preempted after step {step}")
        self.step = step


@dataclass
class ElasticReport:
    steps: int = 0
    losses: list = field(default_factory=list)
    wall_time: float = 0.0
    rounds: int = 0
    rounds_synced: int = 0
    rounds_skipped_quorum: int = 0
    kills: int = 0
    joins: int = 0
    joins_rejected: int = 0
    straggles: int = 0
    payloads_dropped: int = 0
    payloads_corrupt: int = 0
    rebuilds: int = 0
    slows: int = 0                 # injected slowdowns ("slow" events)
    stragglers_detected: int = 0   # detector -> mark_straggling calls
    final_workers: tuple = ()
    # per synced round: (step, reporting ids, absorb weights)
    round_log: list = field(default_factory=list)
    # the port's own: this slot's worker at the end (None: idle), one
    # entry per membership change (its step, old and new workers and the
    # rebuild's parts in seconds), and per kind of step this slot ran
    # after its first ("local", "sync"): "steps", the mean seconds of each
    # phase and the mean transport counters a step
    worker: int | None = None
    rebuild_log: list = field(default_factory=list)
    by_kind: dict = field(default_factory=dict)


def worker_dir(path: str, worker: int) -> str:
    """The directory that worker ``worker`` checkpoints into."""
    return os.path.join(path, f"worker{worker}")


def resume_point(path: str) -> tuple[int, list]:
    """``(step, workers)`` to resume an elastic run from: the newest step
    that every worker recorded in its meta holds valid in its own
    directory. A torn save in one directory makes every slot fall back to
    the same older step."""
    dirs = {}
    for name in os.listdir(path):
        if name.startswith("worker") and name[6:].isdigit():
            dirs[int(name[6:])] = os.path.join(path, name)
    valid = {w: set(valid_steps(d)) for w, d in dirs.items()}
    for s in sorted(set().union(*valid.values()), reverse=True):
        w0 = min(w for w, steps in valid.items() if s in steps)
        workers = load_meta(dirs[w0], s).get("workers")
        if workers and all(s in valid.get(w, ()) for w in workers):
            return s, list(workers)
    raise FileNotFoundError(f"no step under {path!r} that every recorded "
                            f"worker holds valid")


def _agreed_resume_point(path: str) -> tuple[int, list]:
    """:func:`resume_point` as world rank 0 reads it, after every rank has
    arrived (an idle slot may reach the resume before the live ones have
    finished their last save), broadcast to all."""
    if not (dist.is_available() and dist.is_initialized()):
        return resume_point(path)
    dist.barrier()
    point = [resume_point(path) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(point, src=0)
    return point[0]


def _first_param_row(state):
    """One worker's wire payload proxy: its first params leaf on the
    host (the corruption check's input, as in the reference)."""
    return leaves(state["params"])[0].detach().cpu().numpy()


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _slot_workers(controller: MembershipController) -> dict:
    return {controller.slot_of(w): w for w in controller.workers}


def _new_group(controller: MembershipController):
    """A process group over the live slots; every world rank enters the
    call, in one order. None when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.new_group(sorted(_slot_workers(controller)))


def _drop_group(group) -> None:
    if group is not None and group != dist.GroupMember.NON_GROUP_MEMBER:
        dist.destroy_process_group(group)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elastic_train(model, optimizer, lr_fn, batch_fn, *,
                  plan: TrainPlan, num_workers: int | None = None,
                  num_steps: int = 100, seed: int = 0,
                  fault_plan: FaultPlan | str | None = None,
                  log_every: int = 10, ckpt_path: str | None = None,
                  ckpt_every: int = 0, ckpt_keep: int = 3,
                  resume_from: str | None = None,
                  stop_at_step: int | None = None, print_fn=print):
    """Elastic, fault-injected training to ``num_steps``, on this rank.

    Every rank of the default process group calls it with the same
    arguments; the world's ranks are the slots, and ``num_workers``
    (default: all) of them start live. ``batch_fn(step, k, row) -> batch``
    gives the worker at ``row`` of the ``k`` live ones its share of the
    step's global batch (tensors on the model's device), deterministic in
    its arguments; :func:`row_slice` makes one from a function of the
    global batch. ``plan`` must be async (easgd/asgd); ``plan.quorum`` (or
    the majority default) gates averaging rounds. ``print_fn`` prints on
    this rank (pass None on the others).

    Returns ``(state, ElasticReport)``: the state of this slot's worker
    (None when the slot is idle at the end) and the fleet's report, the
    same on every rank. ``stop_at_step`` raises :class:`Preempted` after
    that step on every rank, without a final checkpoint; resume with
    ``resume_from`` pointing at ``ckpt_path``.
    """
    if not plan.is_async:
        raise ValueError(f"elastic_train drives easgd/asgd plans "
                         f"(algo={plan.algo!r}); bsp/gspmd fault "
                         f"tolerance is checkpoint restart — use "
                         f"train() with resume_from")
    if tuple(plan.data_axes) != ("data",):
        raise ValueError("elastic membership reshards over a single "
                         f"'data' axis (got data_axes={plan.data_axes})")
    if isinstance(fault_plan, str):
        fault_plan = FaultPlan.from_spec(fault_plan)
    fault_plan = fault_plan or FaultPlan()
    slot, num_slots = _world()
    k0 = num_workers or num_slots
    if k0 > num_slots:
        raise ValueError(f"{k0} workers need {k0} slots but the process "
                         f"group has {num_slots} ranks — start more ranks "
                         f"or lower --workers")
    dev = model.device

    # -- membership + (possibly resumed) state ------------------------------
    start_step = 0
    workers = list(range(k0))
    if resume_from:
        start_step, workers = _agreed_resume_point(resume_from)
    controller = MembershipController(workers, alpha=plan.alpha,
                                      quorum=plan.quorum,
                                      num_slots=num_slots)
    group = _new_group(controller)
    mine = _slot_workers(controller).get(slot)
    progs = state = None
    # every slot draws the initial state once: the live ones keep it, an
    # idle one keeps its shapes for the centre it may receive on a join
    init = build_elastic_programs(plan, model, optimizer, lr_fn,
                                  None).init_state(
        torch.Generator(device=dev).manual_seed(seed))
    template = tree_map(lambda t: torch.empty_like(t, device="meta"),
                        init["center"])
    if mine is not None:
        progs = build_elastic_programs(plan, model, optimizer, lr_fn, group)
        state = init
        if resume_from:
            state, _ = restore_for_resume(worker_dir(resume_from, mine),
                                          state, expect_algo=plan.algo,
                                          step=start_step)
    del init

    # -- telemetry handles --------------------------------------------------
    c_kills = metrics.counter("fault/kills")
    c_joins = metrics.counter("fault/joins")
    c_joins_rej = metrics.counter("fault/joins_rejected")
    c_straggles = metrics.counter("fault/straggles")
    c_dropped = metrics.counter("fault/payloads_dropped")
    c_corrupt = metrics.counter("fault/payloads_corrupt")
    c_synced = metrics.counter("fault/rounds_synced")
    c_skipped = metrics.counter("fault/rounds_skipped_quorum")
    c_rebuilds = metrics.counter("fault/rebuilds")
    c_stragglers = metrics.counter("anomaly/stragglers_flagged")
    g_live = metrics.gauge("fault/live_workers")
    g_quorum = metrics.gauge("fault/quorum")
    g_stale_max = metrics.gauge("fault/round_staleness_max")
    g_stale_mean = metrics.gauge("fault/round_staleness_mean")
    g_absorbed = metrics.gauge("fault/absorbed_weight_sum")
    metrics.info("fault/plan", algo=plan.algo, tau=str(plan.tau),
                 quorum=str(plan.quorum or "majority"),
                 fault_spec=fault_plan.to_spec(), workers=str(k0),
                 slots=str(num_slots), slot=str(slot))
    g_live.set(controller.k)
    g_quorum.set(controller.quorum_count)

    report = ElasticReport()
    report.steps = start_step
    round_drops: set = set()
    round_corrupt: set = set()
    # injected slowdowns: worker -> (rounds left, timing factor); the
    # controller is not told, the fleet detector must find the straggler
    slow_left: dict = {}
    det_fleet = anomaly.FleetDetector()
    seen_progs: set = set()
    rebuilt_now = False
    own_losses: list = []          # (step, this worker's loss on device)
    timers: list = []              # (kind, PhaseTimer, transport deltas)
    t0 = time.perf_counter()
    try:
        for i in range(start_step, num_steps):
            row = (controller.workers.index(mine) if mine is not None
                   else None)
            gen = (step_generator(seed, i, row, dev) if mine is not None
                   else None)

            # -- injected faults scheduled at this step ---------------------
            for ev in fault_plan.events_at(i):
                if ev.kind == "kill":
                    if controller.kill(ev.worker):
                        report.kills += 1
                        c_kills.inc()
                        trace.instant("fault/kill", worker=ev.worker,
                                      step=i)
                elif ev.kind == "join":
                    if controller.request_join(ev.worker):
                        trace.instant("fault/join_request",
                                      worker=ev.worker, step=i)
                elif ev.kind == "straggle":
                    if controller.straggle(ev.worker, ev.rounds):
                        report.straggles += 1
                        c_straggles.inc()
                elif ev.kind == "drop":
                    round_drops.add(ev.worker)
                elif ev.kind == "corrupt":
                    round_corrupt.add((ev.worker, ev))
                elif ev.kind == "slow":
                    if ev.worker in controller.workers:
                        slow_left[ev.worker] = (
                            max(ev.rounds,
                                slow_left.get(ev.worker, (0, 0.0))[0]),
                            float(ev.factor))
                        report.slows += 1
                        trace.instant("fault/slow", worker=ev.worker,
                                      step=i, factor=ev.factor)

            is_round = (i + 1) % plan.tau == 0
            prog_name = "train/local"
            t_step = time.perf_counter()
            batch = (batch_fn(i, controller.k, row) if mine is not None
                     else None)
            timer = PhaseTimer(dev) if mine is not None else None
            before = progs.transport.counters() if progs else None
            kind = "local"
            if not is_round:
                if mine is not None:
                    state, m = progs.local(state, batch, gen, timer)
            else:
                report.rounds += 1
                # corrupted payloads: the owner flips a real bit in its
                # payload copy and crc32 must catch it; every rank then
                # excludes the payload like a drop
                detected = set()
                for w, ev in sorted(round_corrupt,
                                    key=lambda p: (p[0], p[1].step)):
                    if w not in controller.workers:
                        continue
                    if w == mine:
                        payload = _first_param_row(state)
                        good = payload_checksum(payload)
                        bad = bitflip(payload, fault_plan.event_rng(ev))
                        if payload_checksum(bad) == good:  # pragma: no cover
                            raise AssertionError(
                                "crc32 missed a single-bit corruption")
                    detected.add(w)
                    report.payloads_corrupt += 1
                    c_corrupt.inc()
                dropped = {w for w in round_drops
                           if w in controller.workers}
                report.payloads_dropped += len(dropped)
                c_dropped.inc(len(dropped))
                reporting = controller.reporting(exclude=dropped | detected)
                g_stale_max.set(controller.max_staleness())
                g_stale_mean.set(controller.mean_staleness())
                if controller.has_quorum(reporting):
                    absorb, attract = controller.round_weights(reporting)
                    with trace.span("fault/round", step=i,
                                    k=controller.k,
                                    reporting=len(reporting),
                                    stale_max=controller.max_staleness()):
                        if mine is not None:
                            state, m = progs.sync(state, batch, gen, timer,
                                                  absorb=absorb,
                                                  attract=attract, row=row)
                    prog_name, kind = "train/sync", "sync"
                    report.rounds_synced += 1
                    report.round_log.append(
                        (i, tuple(reporting), absorb.tolist()))
                    c_synced.inc()
                    g_absorbed.set(float(absorb.sum()))
                    controller.commit_round(reporting)
                else:
                    # below quorum: a local step; every delta ages
                    if mine is not None:
                        state, m = progs.local(state, batch, gen, timer)
                    report.rounds_skipped_quorum += 1
                    c_skipped.inc()
                    trace.instant("fault/quorum_skip", step=i,
                                  reporting=len(reporting),
                                  quorum=controller.quorum_count)
                    controller.skip_round()
                round_drops.clear()
                round_corrupt.clear()
            if mine is not None:
                own_losses.append((i, m["loss"]))
            if mine is not None and i > start_step:
                # the first step carries the one-time costs: kept apart
                timers.append((kind, timer, [
                    a - b for a, b in zip(progs.transport.counters(),
                                          before)]))

            if is_round:
                # -- membership changes land at the round boundary ----------
                old, new, left, joined = controller.apply_pending()
                if old != new:
                    with trace.span("fault/rebuild", k_old=len(old),
                                    k_new=len(new)):
                        mine, progs, state, group, parts = _rebuild(
                            controller, group, mine, state, joined, i + 1,
                            template, plan, model, optimizer, lr_fn, slot,
                            dev)
                        rebuilt_now = True
                    report.rebuilds += 1
                    report.joins += len(joined)
                    report.rebuild_log.append(dict(
                        step=i, old=list(old), new=list(new), **parts))
                    c_rebuilds.inc()
                    c_joins.inc(len(joined))
                    g_live.set(controller.k)
                    g_quorum.set(controller.quorum_count)
                    if print_fn:
                        print_fn(f"step {i:5d}  membership {len(old)} -> "
                                 f"{len(new)} (left={list(left)}, "
                                 f"joined={list(joined)})")
                if controller.rejected_joins > report.joins_rejected:
                    c_joins_rej.inc(controller.rejected_joins
                                    - report.joins_rejected)
                    report.joins_rejected = controller.rejected_joins

            # -- observed per-worker timing -> straggler detection ----------
            # This rank's own step time, inflated by each worker's injected
            # factor: the detector's decision is relative, so every rank
            # flags the same workers whatever its own clock read.
            dt_step = max(time.perf_counter() - t_step, 1e-9)
            if prog_name in seen_progs:
                profile.observe(prog_name, dt_step)
            else:
                seen_progs.add(prog_name)
            if rebuilt_now:
                seen_progs.clear()
                rebuilt_now = False
            durations = {
                w: dt_step * (slow_left[w][1] if w in slow_left else 1.0)
                for w in controller.workers}
            for w in det_fleet.observe(durations):
                if controller.state_of(w) == WorkerState.STRAGGLING:
                    continue       # already sitting out; don't re-count
                if controller.mark_straggling(w, 1):
                    report.stragglers_detected += 1
                    c_stragglers.inc()
                    trace.instant("anomaly/straggler", worker=w, step=i,
                                  k=controller.k)
            if is_round and slow_left:
                slow_left = {w: (r - 1, f)
                             for w, (r, f) in slow_left.items() if r > 1}

            report.steps = i + 1
            if (log_every and print_fn and mine is not None
                    and (i % log_every == 0 or i == num_steps - 1)):
                print_fn(f"step {i:5d}  loss {float(own_losses[-1][1]):.4f}"
                         f"  (worker {mine})  k={controller.k}")
            if ckpt_path and ckpt_every and (i + 1) % ckpt_every == 0 \
                    and mine is not None:
                with trace.span("train/checkpoint", step=i + 1):
                    save_checkpoint(worker_dir(ckpt_path, mine), state,
                                    step=i + 1, algo=plan.algo,
                                    workers=controller.workers,
                                    keep=ckpt_keep)
            if stop_at_step is not None and i + 1 >= stop_at_step:
                raise Preempted(i + 1)
        report.losses = _fleet_losses(own_losses, start_step,
                                      report.steps)
        kinds = KindStats()
        for kind, tm, moved in timers:
            kinds.add(kind, tm.split_s(), moved)
        report.by_kind = kinds.means()
    finally:
        report.wall_time = time.perf_counter() - t0
        report.final_workers = controller.workers
        report.worker = mine
        _drop_group(group)
    if ckpt_path and mine is not None and not (
            ckpt_every and report.steps and report.steps % ckpt_every == 0):
        save_checkpoint(worker_dir(ckpt_path, mine), state,
                        step=report.steps, algo=plan.algo,
                        workers=controller.workers, keep=ckpt_keep)
    return state, report


def _rebuild(controller, group, mine, state, joined, step, template, plan,
             model, optimizer, lr_fn, slot, dev):
    """The new membership's group and programs, and this slot's state in
    it: a survivor keeps its own, a joiner receives the centre from the
    lowest survivor's slot, a worker that left drops its state. Returns
    ``(worker, programs, state, group, seconds of each part)``."""
    t0 = time.perf_counter()
    _drop_group(group)
    group = _new_group(controller)
    parts = {"new_group_s": time.perf_counter() - t0, "broadcast_s": 0.0,
             "opt_init_s": 0.0}
    by_slot = _slot_workers(controller)
    now = by_slot.get(slot)
    if now is None:
        return None, None, None, group, parts
    progs = build_elastic_programs(plan, model, optimizer, lr_fn, group)
    if now != mine:
        state = None                 # a joiner (a slot's old worker left)
    with trace.span("fault/reshard"):
        if joined:
            slots = sorted(by_slot)
            src = min(s for s, w in by_slot.items() if w not in joined)
            _sync(dev)
            t1 = time.perf_counter()
            mine_c = (state["center"] if state is not None else tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                template))
            center = tree_map(lambda c: progs.transport.broadcast(
                c, slots.index(src)), mine_c)
            _sync(dev)
            parts["broadcast_s"] = time.perf_counter() - t1
            if state is None:
                t2 = time.perf_counter()
                state = {"params": center,
                         "opt": optimizer.init(center),
                         "center": center, "step": step}
                _sync(dev)
                parts["opt_init_s"] = time.perf_counter() - t2
    return now, progs, state, group, parts


def _fleet_losses(own_losses, start: int, end: int) -> list:
    """Each step's mean loss over the workers that ran it: this rank's own
    losses, summed with every other rank's by one all-reduce of the
    world (a rank that holds no worker adds zeros)."""
    n = end - start
    acc = torch.zeros((2, n), dtype=torch.float64)
    for i, loss in own_losses:
        acc[0, i - start] += float(loss)
        acc[1, i - start] += 1.0
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":      # NCCL reduces card tensors
            acc = acc.cuda()
        dist.all_reduce(acc)
        acc = acc.cpu()
    return (acc[0] / acc[1].clamp(min=1.0)).tolist()


def row_slice(global_batch_fn):
    """A ``batch_fn(step, k, row)`` from a function of the step's global
    batch ``global_batch_fn(step, k)`` (a dict of arrays or tensors whose
    leading dim divides by k): the row's equal share, as the reference's
    data-sharded batch gives it."""
    def batch_fn(step, k, row):
        full = global_batch_fn(step, k)
        out = {}
        for name, v in full.items():
            n = v.shape[0] // k
            out[name] = v[row * n:(row + 1) * n]
        return out
    return batch_fn


__all__ = ["ElasticReport", "Preempted", "elastic_train", "resume_point",
           "row_slice", "worker_dir"]
