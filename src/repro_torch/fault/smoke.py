"""Chaos smoke harness for the fault-tolerance stack (counterpart of
``repro/fault/smoke.py``).

    PYTHONPATH=src python -m repro_torch.fault.smoke --out DIR
    PYTHONPATH=src python -m repro_torch.fault.smoke --device cpu

Spawns one gloo rank process a worker (``--workers``, 4), on the card
(all sharing ``cuda:0``) unless ``--device cpu`` is given, and
runs the reference's four properties on its setup (the smoke
llama3.2-1b at vocab 64, d_ff 128, 2 layers, fp32; 4 sequences of 16
tokens a worker; ``easgd`` tau 4, alpha 0.5, on ``ar``, quorum 2;
momentum SGD without weight decay), at a constant lr of 0.02 where the
reference takes 0.05 (see ``LR``):

1. a clean elastic run (full participation) — the convergence reference;
2. a chaos run under a kill + straggle + corrupt + drop + rejoin
   schedule — must recover into the clean run's loss band;
3. the same chaos run again — must be bit-identical (the center of every
   live worker and the round log);
4. a run preempted mid-flight (after a kill) and resumed from its
   crash-safe checkpoints — must land in the same band.

Exits nonzero on the first violated property. With ``--out`` each slot
writes its metrics JSONL and Perfetto trace there
(``metrics_slot<r>.jsonl``, ``trace_slot<r>.json``) for
``python -m repro_torch.telemetry.validate``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

CHAOS = "kill:3@9,straggle:2@13x2,corrupt:1@21,drop:0@29,join:3@33"
# The reference's lr, 0.05 (momentum 0.9), is at this setup's edge of
# stability in both packages (tests/elastic_lr_sweep.py, clean 48-step
# runs from seeds 0-31 on the CPU): JAX's own loop from JAX's draws spikes
# on 3 (seed 21 ends in NaN), and on 8 of the port's draws; the port's
# loop on 6 and 9. The two packages draw from one distribution (per-leaf
# KS p 0.14-0.95; one spectral-norm p of 15 below 0.05, as chance gives),
# and whether a draw blows up is decided by fp32 rounding: JAX's run from
# the port's seed-17 draw ends at 2.11, and from that draw nudged by one
# ulp in NaN. A clean run that blows up voids the clean-band property. At
# 0.02 each of seeds 0-7 converges (clean final 0.77-1.77, never above
# its first loss) and passes all four properties.
LR = 0.02


def smoke_setup(device, lr: float = LR):
    """The reference smoke's model, optimizer, lr schedule and batch
    function, on ``device``."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch.fault.elastic import row_slice
    from repro_torch.models import build_model
    from repro_torch.optim import constant, sgd_momentum

    cfg = get_smoke_config("llama3.2-1b").with_overrides(
        vocab_size=64, d_ff=128, num_layers=2, dtype="float32")
    model = build_model(cfg, device)
    src = LMTokenSource(cfg.vocab_size, 16, seed=0)

    def global_batch(step, k):
        return {n: torch.from_numpy(v).to(device)
                for n, v in src.batch(4 * k, step).items()}

    return (model, sgd_momentum(weight_decay=0.0), constant(lr),
            row_slice(global_batch))


def _rank(rank, k, opts, ck_dir):
    import torch

    from repro_torch import telemetry
    from repro_torch.fault.elastic import Preempted, elastic_train
    from repro_torch.train.engine import TrainPlan
    from repro_torch.tree import leaves

    dev = torch.device(opts["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dev = torch.device("cuda", torch.cuda.current_device())
    out = opts["out"]
    if out:
        telemetry.configure(metrics_out=os.path.join(
            out, f"metrics_slot{rank}.jsonl"))
    model, opt, lr, batch_fn = smoke_setup(dev)
    plan = TrainPlan(algo="easgd", tau=opts["tau"], alpha=0.5,
                     exchanger="ar", quorum=opts["quorum"])
    say = print if rank == 0 else None

    def run(tag, **kw):
        if say:
            say(f"-- {tag}")
        with torch.backends.cudnn.flags(enabled=False):
            return elastic_train(model, opt, lr, batch_fn, plan=plan,
                                 num_workers=opts["workers"],
                                 num_steps=opts["steps"], seed=0,
                                 log_every=16, print_fn=say, **kw)

    res = {"rank": rank}
    _, clean = run("clean (full participation)")
    s_chaos, chaos = run("chaos", fault_plan=opts["fault_plan"])
    s_replay, replay = run("chaos replay", fault_plan=opts["fault_plan"])
    res["clean"] = clean.losses
    res["chaos"] = dict(losses=chaos.losses, kills=chaos.kills,
                        corrupt=chaos.payloads_corrupt,
                        dropped=chaos.payloads_dropped,
                        rebuilds=chaos.rebuilds, joins=chaos.joins,
                        final_workers=list(chaos.final_workers),
                        round_log=chaos.round_log)
    res["replay_round_log_equal"] = chaos.round_log == replay.round_log
    res["replay_center_equal"] = (
        (s_chaos is None) == (s_replay is None)
        and (s_chaos is None or all(
            torch.equal(a, b) for a, b in zip(leaves(s_chaos["center"]),
                                              leaves(s_replay["center"])))))
    steps = opts["steps"]
    try:
        run("chaos preempted", fault_plan=opts["fault_plan"],
            ckpt_path=ck_dir, ckpt_every=steps // 6,
            stop_at_step=steps // 2 + 2)
        res["preempted_at"] = None
    except Preempted as e:
        res["preempted_at"] = e.step
        if say:
            say(f"   preempted at step {e.step}")
    _, resumed = run("chaos resumed", fault_plan=opts["fault_plan"],
                     resume_from=ck_dir)
    res["resumed"] = dict(steps=resumed.steps, losses=resumed.losses)
    telemetry.flush(force=True)
    if out:
        telemetry.trace.export(os.path.join(out, f"trace_slot{rank}.json"))
    with open(os.path.join(opts["res_dir"], f"smoke{rank}.json"), "w") as f:
        json.dump(res, f)


def check(ranks, steps: int, print_fn=print) -> list:
    """The four properties over the ranks' results; returns the names of
    the failed ones."""
    failures = []

    def verdict(name, ok, detail):
        print_fn(f"{'PASS' if ok else 'FAIL'}: {name} ({detail})")
        if not ok:
            failures.append(name)

    r0 = ranks[0]
    clean, chaos = r0["clean"], r0["chaos"]
    verdict("chaos faults exercised",
            chaos["kills"] >= 1 and chaos["corrupt"] >= 1
            and chaos["dropped"] >= 1 and chaos["rebuilds"] >= 1,
            f"kills={chaos['kills']} corrupt={chaos['corrupt']} "
            f"dropped={chaos['dropped']} rebuilds={chaos['rebuilds']}")
    # convergence band: chaos must realize most of the clean run's drop
    drop_clean = clean[0] - clean[-1]
    band = 0.35 * drop_clean + 0.05
    cl = chaos["losses"]
    verdict("chaos converges into the clean loss band",
            cl[-1] < clean[0] and abs(cl[-1] - clean[-1]) <= band,
            f"chaos {cl[-1]:.4f} vs clean {clean[-1]:.4f} "
            f"(band {band:.4f})")
    log_eq = all(r["replay_round_log_equal"] for r in ranks)
    c_eq = all(r["replay_center_equal"] for r in ranks)
    verdict("fault replay bit-identical", log_eq and c_eq,
            f"center equal={c_eq}, round_log equal={log_eq}")
    verdict("preemption fired",
            all(r["preempted_at"] == steps // 2 + 2 for r in ranks),
            f"preempted at {r0['preempted_at']}")
    rs = r0["resumed"]
    verdict("preempt+resume lands in the chaos band",
            rs["steps"] == steps and abs(rs["losses"][-1] - cl[-1]) <= band,
            f"resumed {rs['losses'][-1]:.4f} vs chaos {cl[-1]:.4f} "
            f"(band {band:.4f})")
    return failures


def main(argv=None) -> int:
    from repro_torch import default_device
    from repro_torch.launch.train import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for each slot's metrics JSONL + trace")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--quorum", type=int, default=2)
    ap.add_argument("--fault-plan", default=CHAOS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        opts = dict(device=str(dev), out=args.out, steps=args.steps,
                    workers=args.workers, tau=args.tau, quorum=args.quorum,
                    fault_plan=args.fault_plan, res_dir=td)
        run_ranks(_rank, args.workers, (opts, os.path.join(td, "ck")),
                  backend="gloo")
        ranks = []
        for r in range(args.workers):
            with open(os.path.join(td, f"smoke{r}.json")) as f:
                ranks.append(json.load(f))
    failures = check(ranks, args.steps)
    if args.out:
        print(f"telemetry -> {args.out}")
    if failures:
        print(f"fault-smoke: {len(failures)} FAILED: {failures}")
        return 1
    print("fault-smoke: all properties hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
