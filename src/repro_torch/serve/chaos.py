"""Deterministic serve-side fault injection: the chaos loop (counterpart
of ``repro/serve/chaos.py``).

The property it pins is **bit-identical replay**: two runs of the same
seeded :class:`~repro_torch.fault.inject.FaultPlan` against the same
engine shape produce the same admissions, sheds, cancels, brownout
transitions, goodput counters and per-step log, byte for byte.

Wall time would break that, so the loop never reads it. The engine takes
two seams:

- ``clock``: a :class:`VirtualClock` that starts at 0.0 and only moves
  when told to;
- ``cost_model``: a pure function ``(kind, n) -> seconds`` that the
  engine feeds into the clock after each dispatch (``decode`` per step at
  its live-lane count, ``prefill_chunk`` per prompt chunk).

Every duration the guardrails read (step-time EWMA, deadlines, queue
budgets, goodput) is then a pure function of the plan, so the counts equal
the reference's on the same plan whatever the weights. A ``stall`` event
inflates the modeled cost, so the watchdog and deadline cancels fire
without sleeping. The dispatches are untouched: chaos is host-side
scheduling over the same decode step, whose argument signature stays one
(``trace_counts["decode"] == 1``, kept as ``decode_compiles`` in the
result, the reference's key).

Serve event kinds (``FaultPlan`` grammar, ``kind:magnitude@step[xD]``):

``qflood:N@S``      N requests burst-arrive at step S, drawn from the
                    per-event generator (tight deadlines + a hog mix).
``stall:F@SxD``     decode costs F x for the D steps starting at S.
``cancel:K@S``      the K-th live request (mod live count) is cancelled.
``pagepress:N@SxD`` N pages leave the allocator's free list at S and
                    return D steps later (drives brownout).

CLI (on the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.serve.chaos --device cpu \\
        --replay --drain-check --goodput-floor 20
"""
from __future__ import annotations

import json
import zlib

import numpy as np

from repro_torch.fault.inject import SERVE_KINDS, FaultPlan
from repro_torch.telemetry import trace


class VirtualClock:
    """An advance-only clock: ``clock()`` reads, ``advance(dt)`` moves.

    Monotonic by construction (negative advances are refused); it starts
    at 0.0 so logged timestamps are run-relative and replay-stable."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.now += float(dt)


def make_cost_model(state: dict | None = None):
    """The modeled dispatch costs that drive the virtual clock: a decode
    step costs a fixed overhead plus a term for each live lane (busier
    steps cost more, which is what the guardrail arithmetic needs to see);
    ``state["stall_factor"]`` scales everything while a ``stall`` window
    is open. Returns ``(cost_fn, state)``; mutate ``state`` to steer."""
    state = {"stall_factor": 1.0} if state is None else state

    def cost(kind: str, n: int) -> float:
        f = state.get("stall_factor", 1.0)
        if kind == "decode":
            return (0.002 + 0.0004 * n) * f
        if kind == "prefill_chunk":
            return 0.0008 * f
        return 0.0

    return cost, state


# ---------------------------------------------------------------------------
# deterministic workloads
# ---------------------------------------------------------------------------

def base_workload(seed: int, n: int, vocab: int, *, max_seq: int = 64):
    """The well-behaved arrival stream: one request per early step, short
    prompts, about half carrying generous deadlines. A pure function of
    the seed."""
    rng = np.random.default_rng([int(seed), 7])
    reqs = []
    for i in range(n):
        plen = int(rng.integers(3, 10))
        max_new = int(rng.integers(4, 12))
        if plen + max_new > max_seq:
            max_new = max_seq - plen
        deadline = float(rng.integers(80, 300)) if i % 2 else None
        reqs.append({"arrive": i, "tokens": rng.integers(
            1, vocab, size=plen).tolist(), "max_new": max_new,
            "deadline_ms": deadline, "max_queue_ms": None})
    return reqs


def _flood_request(rng, vocab: int, *, max_seq: int = 64) -> dict:
    """One adversarial arrival: a hog (long output, a deadline it cannot
    meet under load) or a short tight-deadline request, the mix deadline
    shedding exists to sort out."""
    if rng.random() < 0.4:
        plen = int(rng.integers(4, 12))
        max_new = min(int(rng.integers(24, 48)), max_seq - plen)
        deadline = float(rng.integers(8, 25))          # hopeless under load
    else:
        plen = int(rng.integers(2, 6))
        max_new = int(rng.integers(2, 6))
        deadline = float(rng.integers(30, 120))
    return {"tokens": rng.integers(1, vocab, size=plen).tolist(),
            "max_new": max_new, "deadline_ms": deadline,
            "max_queue_ms": float(rng.integers(40, 160))}


# ---------------------------------------------------------------------------
# the chaos loop
# ---------------------------------------------------------------------------

def run_chaos(make_engine, plan: FaultPlan, *, n_base: int = 8,
              max_steps: int = 500, vocab: int = 251,
              max_seq: int = 64) -> dict:
    """Drive one engine through ``plan``. ``make_engine(clock=,
    cost_model=)`` must return a fresh :class:`~repro_torch.serve.Engine`
    (the factory closes over model and params, so a replay reuses the
    weights).

    Returns a plain-JSON result: per-request outputs and finish reasons,
    the per-step log, the guardrail counters, and a crc32 ``digest`` over
    all of it; two runs of the same plan must give equal digests."""
    for e in plan.events:
        if e.kind not in SERVE_KINDS:
            raise ValueError(f"{e.kind!r} is a training-side fault kind; "
                             f"serve chaos takes {SERVE_KINDS}")
    clock = VirtualClock()
    cost, cstate = make_cost_model()
    eng = make_engine(clock=clock, cost_model=cost)
    base = base_workload(plan.seed, n_base, vocab, max_seq=max_seq)
    arrivals: dict[int, list] = {}
    for r in base:
        arrivals.setdefault(r["arrive"], []).append(r)
    stalls: list[tuple[int, float]] = []   # (last step affected, factor)
    press_release: dict[int, bool] = {}
    last_event = max([e.step + e.rounds for e in plan.events], default=0)
    submitted = rejected = 0
    log = []

    for t in range(max_steps):
        for e in plan.events_at(t):
            if e.kind == "stall":
                stalls.append((t + e.rounds - 1, float(max(2, e.worker))))
                trace.instant("chaos/stall", step=t, factor=e.worker,
                              rounds=e.rounds)
            elif e.kind == "pagepress" and eng.allocator is not None:
                got = eng.allocator.hold_pages(e.worker)
                press_release[t + e.rounds] = True
                trace.instant("chaos/pagepress", step=t, held=got,
                              rounds=e.rounds)
            elif e.kind == "cancel":
                live = sorted(st.req.rid for st in eng.sched.slots
                              if st is not None)
                if live:
                    eng.cancel(live[e.worker % len(live)])
            elif e.kind == "qflood":
                r = plan.event_rng(e)
                for _ in range(e.worker):
                    fr = _flood_request(r, vocab, max_seq=max_seq)
                    res = eng.submit(fr["tokens"], fr["max_new"],
                                     deadline_ms=fr["deadline_ms"],
                                     max_queue_ms=fr["max_queue_ms"])
                    submitted += 1
                    rejected += not res
        if press_release.pop(t, False) and eng.allocator is not None:
            eng.allocator.release_held()
        cstate["stall_factor"] = max(
            [f for (until, f) in stalls if t <= until], default=1.0)
        for r in arrivals.pop(t, ()):
            res = eng.submit(r["tokens"], r["max_new"],
                             deadline_ms=r["deadline_ms"],
                             max_queue_ms=r["max_queue_ms"])
            submitted += 1
            rejected += not res
        eng.step()
        st = eng.stats
        log.append({
            "step": t, "clock_us": int(round(clock.now * 1e6)),
            "active": eng.sched.num_active,
            "queue": eng.sched.queue_depth,
            "finished": eng.sched.finished_total,
            "occupancy_pct": int(round(st.page_occupancy * 100)),
            "brownout": st.brownout_level,
        })
        if (t >= last_event and not eng.sched.has_work()
                and not arrivals and not press_release):
            break
    if eng.allocator is not None:
        eng.allocator.release_held()       # unexpired pressure at exit
        eng.allocator.check_consistency()

    st = eng.stats
    result = {
        "plan": plan.to_spec(), "seed": plan.seed,
        "results": {str(int(r)): list(toks)
                    for r, toks in sorted(eng.sched.results().items())},
        "reasons": {str(int(r)): v
                    for r, v in sorted(eng.sched.finish_reasons().items())},
        "log": log,
        "stats": {
            "submitted": submitted,
            "rejected_at_submit": rejected,
            "finished_total": eng.sched.finished_total,
            "shed": st.shed, "cancelled": st.cancelled,
            "deadline_misses": st.deadline_misses,
            "rejected_queue_full": st.rejected_queue_full,
            "watchdog_stalls": st.watchdog_stalls,
            "brownout_clamped": st.brownout_clamped,
            "goodput_tokens": st.goodput_tokens,
            "decoded_tokens": st.decoded_tokens,
            "steps": st.steps,
        },
        "decode_compiles": eng.trace_counts["decode"],
    }
    result["digest"] = digest(result)
    return result


def digest(result: dict) -> int:
    """crc32 over the canonical JSON of a chaos result (minus any digest
    already stamped on it): the replay-equality check."""
    clean = {k: v for k, v in result.items() if k != "digest"}
    return zlib.crc32(json.dumps(clean, sort_keys=True).encode())


def verify_replay(make_engine, plan: FaultPlan, **kw) -> tuple[dict, dict]:
    """Run the plan twice against fresh engines; raises if anything
    (outputs, reasons, counters, the step log) differs."""
    a = run_chaos(make_engine, plan, **kw)
    b = run_chaos(make_engine, plan, **kw)
    if a["digest"] != b["digest"]:
        for key in ("results", "reasons", "stats", "log"):
            if a[key] != b[key]:
                raise AssertionError(
                    f"chaos replay diverged in {key!r}: run1={a[key]!r} "
                    f"run2={b[key]!r}")
        raise AssertionError("chaos replay digests differ")
    return a, b


def verify_drain_restore(make_engine, *, seed: int = 0, n: int = 6,
                         drain_after: int = 3, vocab: int = 251,
                         max_seq: int = 64, path: str | None = None) -> dict:
    """Greedy drain->restore parity: run a deterministic workload to the
    end (the oracle), then again but drain after ``drain_after`` steps,
    restore the snapshot into a fresh engine and finish there. The
    outputs must equal the oracle's bit for bit."""
    reqs = base_workload(seed, n, vocab, max_seq=max_seq)

    def feed(eng):
        for r in reqs:      # no deadlines: greedy parity, not shedding
            eng.submit(r["tokens"], r["max_new"])

    oracle = make_engine()
    feed(oracle)
    want = {int(r): list(t) for r, t in oracle.run().items()}

    eng = make_engine()
    feed(eng)
    for _ in range(drain_after):
        eng.step()
    snap = eng.drain(path)
    partial = {int(r): list(t) for r, t in eng.sched.results().items()}
    eng2 = make_engine()
    requeued = eng2.load_snapshot(path if path is not None else snap)
    eng2.run()
    got = {int(r): list(t) for r, t in eng2.sched.results().items()}
    if got != want:
        raise AssertionError(
            f"drain->restore diverged from the uninterrupted run: "
            f"want={want!r} got={got!r}")
    return {"oracle": want, "drained_finished": sorted(partial),
            "requeued": sorted(requeued)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse

    from repro_torch import default_device, telemetry
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine

    ap = argparse.ArgumentParser(
        description="deterministic serve chaos loop (seeded FaultPlan)")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--fault-plan",
                    default="qflood:6@3,stall:8@6x4,cancel:1@9,"
                            "pagepress:12@10x8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8,
                    help="well-behaved base arrivals under the chaos")
    ap.add_argument("--steps", type=int, default=300,
                    help="hard cap on chaos-loop steps")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=16)
    ap.add_argument("--shed-policy", default="reject-no-deadline")
    ap.add_argument("--goodput-floor", type=int, default=1,
                    help="minimum tokens delivered within deadline")
    ap.add_argument("--replay", action="store_true",
                    help="run the plan twice, assert bit-identical")
    ap.add_argument("--drain-check", action="store_true",
                    help="assert drain->restore greedy parity")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, dev)
    params = model.init(0)
    plan = FaultPlan.from_spec(args.fault_plan, seed=args.seed)

    def make_engine(**over):
        return Engine(model, params, max_slots=args.max_slots,
                      max_seq=args.max_seq, prefill_chunk=8,
                      page_size=args.page_size, num_pages=args.num_pages,
                      max_queue=args.max_queue,
                      shed_policy=args.shed_policy, device=dev, **over)

    kw = dict(n_base=args.requests, max_steps=args.steps,
              vocab=cfg.vocab_size, max_seq=args.max_seq)
    if args.replay:
        result, _ = verify_replay(make_engine, plan, **kw)
        print(f"replay: bit-identical (digest {result['digest']:#010x})")
    else:
        result = run_chaos(make_engine, plan, **kw)
    s = result["stats"]
    print(f"chaos plan [{plan.to_spec()}] seed={plan.seed}: "
          f"{s['submitted']} submitted, {s['finished_total']} terminal "
          f"({s['shed']} shed, {s['cancelled']} cancelled, "
          f"{s['deadline_misses']} deadline misses, "
          f"{s['rejected_queue_full']} queue-rejected)")
    print(f"goodput {s['goodput_tokens']} tokens within deadline "
          f"(of {s['decoded_tokens']} decoded over {s['steps']} steps); "
          f"watchdog flagged {s['watchdog_stalls']} stalls, brownout "
          f"clamped {s['brownout_clamped']}; decode compiled "
          f"{result['decode_compiles']}x")
    failures = []
    if result["decode_compiles"] != 1:
        failures.append(
            f"decode compiled {result['decode_compiles']}x (want exactly 1)")
    if s["goodput_tokens"] < args.goodput_floor:
        failures.append(f"goodput {s['goodput_tokens']} below floor "
                        f"{args.goodput_floor}")
    if args.drain_check:
        verify_drain_restore(make_engine, seed=args.seed,
                             vocab=cfg.vocab_size, max_seq=args.max_seq)
        print("drain->restore: greedy outputs bit-identical to the "
              "uninterrupted run")
    if args.metrics_out:
        telemetry.dump_metrics(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        telemetry.trace.export(args.trace_out)
        print(f"trace -> {args.trace_out}")
    if failures:
        raise SystemExit("serve-chaos FAILED: " + "; ".join(failures))


if __name__ == "__main__":
    main()
