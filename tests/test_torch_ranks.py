"""Rank bodies of the port's multi-rank tests (``test_torch_exchange.py``,
``test_torch_train.py``, ``test_torch_lm_train.py``, ``test_torch_gspmd.py``
and others). Each runs in a spawned gloo process, which
imports the module that holds it; this one imports torch and the port
only, not JAX, so a rank starts in about a second. It holds no tests.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import bsp as tbsp
from repro_torch.core import exchanger as tex
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models import vision as tvision
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedule as tsched
from repro_torch.tree import leaves, tree_map

# ---------------------------------------------------------------------------
# the exchange on k ranks
# ---------------------------------------------------------------------------

STRATEGIES = ("ar", "asa", "asa16", "asabf16", "asa8", "ring", "ring16",
              "none")
BUCKET_BYTES = (0, 16384)


def map_shapes(t, fn):
    if isinstance(t, dict):
        return {k: map_shapes(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [map_shapes(v, fn) for v in t]
    return fn(t)


def value_tree(seed):
    """Big and small, ragged leaves (numpy-seeded values)."""
    rng = np.random.default_rng(seed)
    return map_shapes(
        {"w1": (33, 77), "w2": (77, 40), "b1": (1237,), "small": (5,),
         "norm": (17,), "conv": {"w": (3, 3, 2, 100), "b": (100,)},
         "blocks": [(1500,), (7,)]},
        lambda s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)))


def int8_input(n, device="cpu"):
    """Seeded fp32 values for the blockwise int8 quantizers: randn * 3,
    block 1 (where n reaches it) all zero, and in block 0 (n >= 256)
    values whose fp32 quotient by the block's scale is exactly k + 0.5
    (ties, which round half to even). Returns (x, tie positions)."""
    g = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(n, generator=g, device=device) * 3
    x[2048:4096] = 0.0
    pos = torch.zeros(0, dtype=torch.long, device=device)
    if n >= 256:
        x[0] = 15.0                      # block 0's absmax, so its scale
        scale = ref.quant_int8_ref(x[:2048])[1][0]
        ks = torch.arange(-120, 120, 3, device=device, dtype=torch.float32)
        t = ((ks + 0.5).double() * scale.double()).float()
        keep = (t / scale) == ks + 0.5
        pos = torch.arange(1, 1 + int(keep.sum()), device=device)
        x[pos] = t[keep]
    return x, pos


def _np(tree):
    return [t.numpy() for t in leaves(tree)]


def exchange_worker(rank, k, out_dir):
    tree = value_tree(100 + rank)
    res = {}
    for name in STRATEGIES:
        ex = tex.get_exchanger(name)
        for bb in BUCKET_BYTES:
            res[(name, bb, "exchange")] = _np(ex.exchange(tree,
                                                          bucket_bytes=bb))
            if name == "none":
                continue
            halves, plan = ex.reduce_scatter(tree, bucket_bytes=bb)
            flats = ex.all_gather(halves["shards"], plan)
            res[(name, bb, "halves")] = _np(tex.Exchanger.unpack(
                flats, halves["full"], plan))
            res[(name, bb, "shards")] = [s.numpy() for s in halves["shards"]]
            if ex.supports_raw:
                raw, _ = ex.reduce_scatter(tree, bucket_bytes=bb, raw=True)
                dq = []
                for i, c in enumerate(raw["chunks"]):
                    c = c.float()
                    if raw["scales"]:
                        c = c * raw["scales"][i][:, None]
                    dq.append((c.sum(0) / k).numpy())
                res[(name, bb, "raw")] = dq
                res[(name, bb, "raw_dtype")] = str(raw["chunks"][0].dtype)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# BSP steps on k ranks
# ---------------------------------------------------------------------------

LR = 1e-3
# (name, exchanger, make_bsp_step keywords, tolerance class)
CASES = [
    ("ar", "ar", {}, "fp32"),
    ("asa", "asa", {}, "fp32"),
    ("asa-mb2", "asa", {"microbatches": 2}, "fp32"),
    ("awagd", "asa", {"scheme": "awagd"}, "fp32"),
    ("asa16-sharded-fused", "asa16",
     {"sharded_update": True, "fuse_rs_update": True}, "fp16"),
    ("asa16-sharded", "asa16",
     {"sharded_update": True, "fuse_rs_update": False}, "fp16"),
]


# GoogLeNet's cases (test_torch_convnets.py): fp32 all-to-all and ring
CONV_CASES = [("asa", "asa", {}, "fp32"), ("ring", "ring", {}, "fp32")]


def port_model(params, arch="alexnet"):
    """Smoke ``arch`` on the CPU whose ``init`` returns ``params`` and
    whose loss runs without dropout."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    return dataclasses.replace(
        model, init=lambda gen: tree_map(torch.clone, params),
        loss_fn=lambda p, b, gen=None: tvision.conv_loss(p, b, cfg, None))


def bsp_worker(rank, k, out_dir, arch="alexnet", cases=CASES, pods=1):
    """Each case's steps on this rank's 1/k of every saved batch; with
    ``pods`` > 1 over the two-level transport of that many pods."""
    params = torch.load(os.path.join(out_dir, "init.pt"))
    batches = torch.load(os.path.join(out_dir, "batches.pt"))
    model = port_model(params, arch)
    opt = topt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    tr = tex.make_transport(("pod", "data") if pods > 1 else ("data",),
                            pods)
    res = {}
    for name, exname, kw, _ in cases:
        sharded = kw.get("sharded_update", False) or bool(kw.get("overlap"))
        state = (tbsp.init_sharded_train_state(model, opt, None, tr)
                 if sharded else tbsp.init_train_state(model, opt, None))
        step = tbsp.make_bsp_step(model, opt, tex.get_exchanger(exname),
                                  tsched.constant(LR), tr, **kw)
        losses = []
        for b in batches:
            part = b["images"].shape[0] // k
            mine = {n: v[rank * part:(rank + 1) * part] for n, v in b.items()}
            state, metrics = step(state, mine)
            losses.append(float(metrics["loss"]))
        res[name] = {"params": state["params"], "losses": losses,
                     "step": state["step"]}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# BSP steps of the smoke decoder on k ranks
# ---------------------------------------------------------------------------

LM_LR = 0.05


def lm_bsp_worker(rank, k, out_dir, cfg):
    """Two ``asa`` steps of ``cfg`` from the saved parameters, this rank on
    its half of each saved global batch."""
    params = torch.load(os.path.join(out_dir, "init.pt"))
    batches = torch.load(os.path.join(out_dir, "batches.pt"))
    model = dataclasses.replace(build_model(cfg, "cpu"),
                                init=lambda gen: tree_map(torch.clone, params))
    opt = topt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    state = tbsp.init_train_state(model, opt, None)
    step = tbsp.make_bsp_step(model, opt, tex.get_exchanger("asa"),
                              tsched.constant(LM_LR))
    losses = []
    for b in batches:
        half = b["tokens"].shape[0] // k
        mine = {n: v[rank * half:(rank + 1) * half] for n, v in b.items()}
        state, metrics = step(state, mine)
        losses.append(float(metrics["loss"]))
    torch.save({"params": state["params"], "losses": losses},
               os.path.join(out_dir, f"lm_rank{rank}.pt"))


# ---------------------------------------------------------------------------
# the ring on the card (test_torch_gpu.py)
# ---------------------------------------------------------------------------

def ring_gpu_worker(rank, k, out_dir, name="ring16"):
    """One ``name`` exchange of ``value_tree(100 + rank)`` on cuda:0 (the
    ranks share the card over gloo); saves the result and the launches."""
    from repro_torch import kernels as K
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tree = tree_map(lambda t: t.to(dev), value_tree(100 + rank))
    K.reset_launches()
    out = tex.get_exchanger(name).exchange(tree)
    torch.cuda.synchronize()
    torch.save({"leaves": [t.cpu().numpy() for t in leaves(out)],
                "launches": dict(K.LAUNCHES)},
               os.path.join(out_dir, f"ring{rank}.pt"))


# ---------------------------------------------------------------------------
# overlap="buckets" on k ranks (test_torch_overlap.py)
# ---------------------------------------------------------------------------

_OVL = {"overlap": "buckets", "microbatches": 2}
OVERLAP_CASES = [
    ("asa-overlap", "asa", dict(_OVL, fuse_rs_update=False), "fp32"),
    ("asa-overlap-fused", "asa", dict(_OVL, fuse_rs_update=True), "fp32"),
    ("asa16-overlap", "asa16", dict(_OVL, fuse_rs_update=False), "fp16"),
    ("asa16-overlap-fused", "asa16", dict(_OVL, fuse_rs_update=True),
     "fp16"),
    ("asa-mb2-sharded", "asa", {"sharded_update": True, "microbatches": 2,
                                "fuse_rs_update": False}, "fp32"),
]


# ---------------------------------------------------------------------------
# the two-level (hier) exchange on 2 pods of 2 (test_torch_hier.py)
# ---------------------------------------------------------------------------

PODS = 2
HIER_STRATEGIES = ("ar", "asa", "asa16", "asa8", "ring", "ring16", "hier",
                   "hier16")
HIER_CASES = [
    ("hier", "hier", {}, "fp32"),
    ("hier16-sharded", "hier16", {"sharded_update": True}, "fp16"),
]


def hier_worker(rank, k, out_dir):
    """Every strategy over 2 pods of k / 2 (exchange, and the halves), the
    raw reduce-scatter's refusal, then the BSP cases of ``HIER_CASES``."""
    tr = tex.make_transport(("pod", "data"), PODS)
    tree = value_tree(100 + rank)
    res = {"k": tr.k, "rank": tr.rank, "world": (tr.world_rank, tr.world_k)}
    for name in HIER_STRATEGIES:
        ex = tex.get_exchanger(name)
        for bb in BUCKET_BYTES:
            res[(name, bb, "exchange")] = _np(ex.exchange(tree, tr, bb))
            halves, plan = ex.reduce_scatter(tree, tr, bucket_bytes=bb)
            flats = ex.all_gather(halves["shards"], plan, tr)
            res[(name, bb, "halves")] = _np(tex.Exchanger.unpack(
                flats, halves["full"], plan))
    try:
        tex.get_exchanger("hier16").reduce_scatter(tree, tr, raw=True)
        res["raw"] = "ran"
    except ValueError as e:
        res["raw"] = str(e)
    torch.save(res, os.path.join(out_dir, f"hier{rank}.pt"))
    bsp_worker(rank, k, out_dir, cases=HIER_CASES, pods=PODS)


# ---------------------------------------------------------------------------
# async EASGD/ASGD on k ranks (test_torch_easgd.py): a small classifier
# whose JAX twin lives in that test's JAX script
# ---------------------------------------------------------------------------

TINY_SHAPES = {"b1": (96,), "b3": (10,), "w1": (24, 96), "w2": (96, 40),
               "w3": (40, 10)}
ASYNC_LR, ASYNC_STEPS, ASYNC_BATCH = 0.05, 5, 8
# (name, TrainPlan keywords); each runs ASYNC_STEPS steps
ASYNC_CASES = [(f"{algo}-tau{tau}-{ex}", dict(algo=algo, tau=tau,
                                              exchanger=ex))
               for ex in ("asa", "asa16")
               for algo, tau in (("easgd", 1), ("easgd", 2), ("easgd", 3),
                                 ("asgd", 2))]


def tiny_params(seed=0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for n, s in TINY_SHAPES.items()}


def tiny_batches(n=ASYNC_STEPS, size=ASYNC_BATCH, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((size, 24)).astype(np.float32),
             "y": rng.integers(0, 10, size).astype(np.int32)}
            for _ in range(n)]


def tiny_loss(p, batch, gen=None):
    h = torch.relu(batch["x"] @ p["w1"] + p["b1"])
    logits = torch.tanh(h @ p["w2"]) @ p["w3"] + p["b3"]
    loss = torch.nn.functional.cross_entropy(logits, batch["y"].long())
    return loss, {"loss": loss, "aux": torch.zeros(())}


def tiny_model(params=None):
    """The classifier on the CPU, its ``init`` returning ``params``."""
    import types
    params = tiny_params() if params is None else params
    return types.SimpleNamespace(
        init=lambda gen: {n: torch.from_numpy(v.copy())
                          for n, v in params.items()},
        loss_fn=tiny_loss, device=torch.device("cpu"))


def _rank_batches(batches, rank, k):
    part = batches[0]["x"].shape[0] // k
    return [{n: torch.from_numpy(v[rank * part:(rank + 1) * part])
             for n, v in b.items()} for b in batches]


def _state_np(state):
    return {key: [t.numpy().copy() for t in leaves(state[key])]
            for key in ("params", "opt", "center") if key in state}


def easgd_worker(rank, k, out_dir):
    from repro_torch.core import easgd
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    model = tiny_model()
    opt = topt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    mine = _rank_batches(tiny_batches(), rank, k)
    quiet = dict(log_every=0, print_fn=lambda *a: None)
    res = {}

    def run(plan, lr=ASYNC_LR, **kw):
        kw.setdefault("num_steps", ASYNC_STEPS)
        return train(model, opt, tsched.constant(lr), mine, plan, **quiet,
                     **kw)

    for name, kw in ASYNC_CASES + [("easgd-alpha1-tau2-asa",
                                    dict(algo="easgd", alpha=1.0, tau=2))]:
        state, rep = run(TrainPlan(**kw))
        res[name] = dict(_state_np(state), step=state["step"],
                         losses=rep.losses, by_kind=rep.by_kind)
    # asgd at tau 1 against BSP with the learning rate times k
    for name, plan, lr in (
            ("asgd-tau1", TrainPlan(algo="asgd", exchanger="asa"), ASYNC_LR),
            ("bsp-lr-k", TrainPlan(exchanger="asa"), ASYNC_LR * k)):
        state, rep = run(plan, lr)
        res[name] = dict(_state_np(state), losses=rep.losses)
    # resume: tau 2, saved inside a window (3) and at its end (4)
    plan = TrainPlan(algo="easgd", tau=2, exchanger="asa16")
    full, rep = run(plan)
    res["resume"] = {"full": _state_np(full), "full_losses": rep.losses}
    for at in (3, 4):
        ck = os.path.join(out_dir, f"ck{at}")
        run(plan, num_steps=at, ckpt_path=ck, ckpt_every=at)
        st, rrep = run(plan, resume_from=ck)
        res["resume"][at] = (_state_np(st), st["step"], rrep.losses)
    # the quorum sync: this rank's absorb/attract weights from the vectors
    local, sync = easgd.make_async_step(
        model, opt, tex.get_exchanger("asa"), tsched.constant(ASYNC_LR),
        quorum=True)
    state = easgd.init_async_state(model, opt, None)
    rounds = []
    for absorb, attract in (((0.5, 0.25), (0.0, 1.0)),
                            ((0.3, 0.6), (0.4, 0.0)),
                            ((0.5, 0.5), (1.0, 0.7))):
        w_local, _ = local(state, mine[0])
        new, _ = sync(state, mine[0], absorb=absorb, attract=attract)
        rounds.append({"before": _state_np(state), "local": _state_np(
            w_local), "after": _state_np(new)})
        state = new
    res["quorum"] = rounds
    torch.save(res, os.path.join(out_dir, f"easgd{rank}.pt"))


def async_a2a_gpu_worker(rank, k, out_dir, device="cuda"):
    """On cuda:0 (the ranks share the card over gloo): the staged
    asynchronous reduce-scatter (``reduce_scatter_start``, twice in a row,
    the second reusing the first's pinned buffers) against the
    synchronous one, for every all-to-all wire, raw and summed; saves
    whether each pair is equal bit for bit and the transport's
    counters."""
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tree = tree_map(lambda t: t.to(dev), value_tree(100 + rank))
    tr = tex.Transport()
    res = {}
    for name in ("asa", "asa16", "asa8"):
        ex = tex.get_exchanger(name)
        for bb in BUCKET_BYTES:
            plan = tex.make_rs_plan(tree, k, bb)
            for raw in (False, True):
                want, _ = ex.reduce_scatter(tree, tr, plan=plan, raw=raw)
                first = ex.reduce_scatter_start(tree, tr, plan=plan, raw=raw)
                got = first.finish()
                again = ex.reduce_scatter_start(tree, tr, plan=plan,
                                                raw=raw).finish()
                res[(name, bb, raw)] = all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for key in want for out in (got, again)
                    for a, b in zip(out[key], want[key]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["counters"] = tr.counters()
    torch.save(res, os.path.join(out_dir, f"a2a{rank}.pt"))


# ---------------------------------------------------------------------------
# elastic training on 4 slots (test_torch_elastic.py)
# ---------------------------------------------------------------------------

ELASTIC_SPECS = {
    # the reference smoke's chaos schedule, 4 workers on 4 slots
    "chaos": ("kill:3@9,straggle:2@13x2,corrupt:1@21,drop:0@29,join:3@33",
              4, 40),
    # 3 workers on 4 slots: worker 0's slot frees at step 3 and worker 3
    # joins into it at step 7, below the survivors' slots 1 and 2 (row
    # order (1, 2, 3), group order (3, 1, 2)); then a detected slowdown
    "lowslot": ("kill:0@2,join:3@6,slow:1@9x2", 3, 20),
}
# the fault harness's lr (fault/smoke.py): at the reference's 0.05 this
# run is chaotic, and fp32 rounding alone moves it past any fixed tolerance
ELASTIC_LR = 0.02
PARITY_STEPS = 8             # full participation vs the fixed easgd plan
RESUME = dict(spec="kill:3@9", steps=32, every=8, stop=18,
              lr={"easgd": 0.05, "asgd": 0.02})
_COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "barrier",
                "broadcast_object_list", "batch_isend_irecv")


def _count_collectives(counts):
    """Wrap the process group's collectives (and the exchanger's bound
    all-gather) so that each call adds one to ``counts``."""
    import torch.distributed as dist

    def wrap(name, fn):
        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return counted

    for name in _COLLECTIVES:
        setattr(dist, name, wrap(name, getattr(dist, name)))
    tex._all_gather = wrap("all_gather", tex._all_gather)


def elastic_worker(rank, k, out_dir):
    """One slot of the elastic runs: the smoke llama3.2-1b of the
    reference's fault smoke, its initial parameters from JAX
    (``init.pkl``), through both specs, their replay, full participation
    against the fixed easgd plan, and preempt -> resume."""
    import pickle

    from repro_torch.bridge import decoder_params_from_jax
    from repro_torch.fault.elastic import Preempted, elastic_train
    from repro_torch.fault.smoke import smoke_setup
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train

    dev = torch.device("cpu")
    model, opt, _, batch_fn = smoke_setup(dev)
    with open(os.path.join(out_dir, "init.pkl"), "rb") as f:
        p0 = decoder_params_from_jax(pickle.load(f))
    model = dataclasses.replace(model,
                                init=lambda *a: tree_map(torch.clone, p0))
    counts: dict = {}
    _count_collectives(counts)
    plan = TrainPlan(algo="easgd", tau=4, alpha=0.5, exchanger="ar",
                     quorum=2)

    def run(p=plan, lr=ELASTIC_LR, **kw):
        counts.clear()
        state, rep = elastic_train(model, opt, tsched.constant(lr),
                                   batch_fn, plan=p, seed=0, print_fn=None,
                                   **kw)
        return state, rep, dict(counts)

    res = {}
    for name, (spec, workers, steps) in ELASTIC_SPECS.items():
        state, rep, coll = run(num_workers=workers, num_steps=steps,
                               fault_plan=spec)
        res[name] = dict(report=dataclasses.asdict(rep), collectives=coll,
                         center=(_np(state["center"]) if state else None))
    s2, r2, _ = run(num_workers=4, num_steps=40,
                    fault_plan=ELASTIC_SPECS["chaos"][0])
    res["replay"] = dict(round_log=r2.round_log,
                         center=_np(s2["center"]) if s2 else None)
    # full participation, quorum 4 and tau 2: the fixed easgd plan's step
    sq, _, _ = run(TrainPlan(algo="easgd", tau=2, alpha=0.5,
                             exchanger="ar", quorum=4),
                   num_workers=4, num_steps=PARITY_STEPS)
    mine = [batch_fn(i, k, rank) for i in range(PARITY_STEPS)]
    sf, _ = train(model, opt, tsched.constant(ELASTIC_LR), mine,
                  TrainPlan(algo="easgd", tau=2, alpha=0.5, exchanger="ar"),
                  num_steps=PARITY_STEPS, log_every=0, seed=0,
                  print_fn=lambda *a: None)
    res["parity"] = {part: all(torch.equal(a, b) for a, b in zip(
        leaves(sq[part]), leaves(sf[part]))) for part in ("params", "center")}
    # preempt -> resume, per algo
    res["resume"] = {}
    for algo, lr in RESUME["lr"].items():
        p = TrainPlan(algo=algo, tau=4, exchanger="ar", quorum=2,
                      alpha=0.5 if algo == "easgd" else None)
        kw = dict(num_workers=4, num_steps=RESUME["steps"],
                  fault_plan=RESUME["spec"])
        _, ref_rep, _ = run(p, lr, **kw)
        ck = os.path.join(out_dir, f"ck_{algo}")
        try:
            run(p, lr, ckpt_path=ck, ckpt_every=RESUME["every"],
                stop_at_step=RESUME["stop"], **kw)
            preempted = None
        except Preempted as e:
            preempted = e.step
        _, rr, _ = run(p, lr, resume_from=ck, **kw)
        res["resume"][algo] = dict(preempted=preempted, steps=rr.steps,
                                   ref=ref_rep.losses[-1],
                                   resumed=rr.losses[-1])
    torch.save(res, os.path.join(out_dir, f"elastic{rank}.pt"))


# ---------------------------------------------------------------------------
# gspmd (FSDP) training on k ranks (test_torch_gspmd.py)
# ---------------------------------------------------------------------------

GSPMD_STEPS = 3              # steps of each parity run
GSPMD_RESUME = (2, 4)        # save at step 2, resume to 4
GSPMD_LR = {"sgd": 0.05, "adamw": 0.01}
GSPMD_CASES = [(f"{mode}-{opt}", mode, opt) for opt in ("sgd", "adamw")
               for mode in ("zero1", "ar")]


def gspmd_optimizer(name):
    """The parity runs' optimizers (the JAX side builds the same)."""
    if name == "sgd":
        return topt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    return topt.adamw()


def gspmd_worker(rank, k, out_dir, cfg):
    """Every gspmd case (mode x optimizer) for GSPMD_STEPS steps from the
    saved parameters, this rank on its 1/k of each saved global batch;
    BSP ``asa`` with the sharded update the same way, with either
    optimizer; and a zero1 AdamW
    run saved at step 2 and resumed to 4 against an unbroken 4-step run.
    Saves this rank's shards, their shapes at rest and the losses."""
    from repro_torch.train.engine import TrainPlan, build_engine
    from repro_torch.train.loop import train
    params = torch.load(os.path.join(out_dir, "init.pt"))
    batches = torch.load(os.path.join(out_dir, "batches.pt"))
    model = dataclasses.replace(build_model(cfg, "cpu"),
                                init=lambda gen: tree_map(torch.clone, params))
    part = batches[0]["tokens"].shape[0] // k
    mine = [{n: v[rank * part:(rank + 1) * part] for n, v in b.items()}
            for b in batches]
    shapes = lambda tree: [tuple(t.shape) for t in leaves(tree)]  # noqa: E731
    res = {}
    for name, mode, oname in GSPMD_CASES:
        eng = build_engine(TrainPlan(algo="gspmd", mode=mode), model,
                           gspmd_optimizer(oname),
                           tsched.constant(GSPMD_LR[oname]))
        state = eng.init_state(None)
        rest = {"params": shapes(state["params"]),
                **{n: shapes(state["opt"][n]) for n in ("m", "v")
                   if n in state["opt"]}}
        losses = []
        for i, b in enumerate(mine[:GSPMD_STEPS]):
            state, metrics = eng.step(state, b, step_idx=i)
            losses.append(float(metrics["loss"]))
        res[name] = {"params": state["params"], "opt": state["opt"],
                     "losses": losses, "rest": rest, "specs": eng.specs,
                     "step": state["step"]}
    for oname in ("sgd", "adamw"):
        opt = gspmd_optimizer(oname)
        state = tbsp.init_sharded_train_state(model, opt, None)
        step = tbsp.make_bsp_step(model, opt, tex.get_exchanger("asa"),
                                  tsched.constant(GSPMD_LR[oname]),
                                  sharded_update=True)
        losses = []
        for b in mine[:GSPMD_STEPS]:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        res[f"bsp-{oname}"] = {"params": state["params"], "losses": losses}
    ck = os.path.join(out_dir, "ck")
    plan, opt = TrainPlan(algo="gspmd"), gspmd_optimizer("adamw")
    finals = []
    for kw in (dict(num_steps=GSPMD_RESUME[1]),
               dict(num_steps=GSPMD_RESUME[0], ckpt_path=ck),
               dict(num_steps=GSPMD_RESUME[1], resume_from=ck)):
        st, rep = train(model, opt, tsched.constant(GSPMD_LR["adamw"]), mine,
                        plan, log_every=0, print_fn=lambda *a: None, **kw)
        finals.append((leaves(st), rep.steps, rep.losses))
    (a, na, la), (_, n2, _), (b, nb, lb) = finals
    res["resume"] = dict(
        steps=[na, n2, nb], losses=(la, lb),
        bitwise=len(a) == len(b) and all(
            torch.equal(x, y) if torch.is_tensor(x) else x == y
            for x, y in zip(a, b)))
    torch.save(res, os.path.join(out_dir, f"gspmd{rank}.pt"))


# ---------------------------------------------------------------------------
# the exchange halves' attribution on k ranks
# ---------------------------------------------------------------------------

def halves_worker(rank, k, out_dir, fail_rank):
    """Two steps of smoke llama3.2-1b (asa16, sharded) with profiling on;
    on ``fail_rank`` building the exchange halves fails. Writes whether
    each half was counted and the rank's capture errors."""
    import json

    from repro_torch import telemetry
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch.telemetry import metrics, profile
    from repro_torch.train import loop
    from repro_torch.train.engine import TrainPlan

    telemetry.set_enabled(True)
    telemetry.reset()
    telemetry.configure(profile=True)
    if rank == fail_rank:
        def broken(*a, **kw):
            raise MemoryError("no room for the zero gradients")
        tex.half_programs = broken
    cfg = get_smoke_config("llama3.2-1b").with_overrides(dtype="float32")
    model = build_model(cfg, "cpu")
    src = LMTokenSource(cfg.vocab_size, 16)
    batches = [{n: torch.from_numpy(v) for n, v in
                src.batch(2, j * k + rank).items()} for j in range(2)]
    _, rep = loop.train(model, topt.sgd_momentum(), tsched.constant(0.01),
                        batches, plan=TrainPlan(exchanger="asa16",
                                                sharded_update=True),
                        num_steps=2, log_every=0, print_fn=lambda *a: None)
    out = {"losses": rep.losses,
           "counted": {n: bool(profile.get(n) and profile.get(n).captured)
                       for n in ("exchange/rs", "exchange/ag")},
           "errors": metrics.counter("profile/capture_errors").value}
    with open(os.path.join(out_dir, f"halves{rank}.json"), "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# the assigned decoders on k ranks (test_torch_archs.py)
# ---------------------------------------------------------------------------

ARCHS_LR = 0.05
ARCHS_STEPS = 2


def archs_worker(rank, k, out_dir, cases):
    """Each case ``(name, cfg, plan)`` for ARCHS_STEPS steps from the
    parameters saved as ``<name>.init.pt``, this rank on its 1/k of each
    global batch saved as ``<name>.batches.pt``: ``plan`` "bsp" is BSP
    ``asa`` (fp32 wire) with the sharded update, "zero1" gspmd zero1;
    momentum SGD. Saves the parameters (the shards and their specs for
    zero1) and the losses, by case."""
    from repro_torch.train.engine import TrainPlan, build_engine
    res = {}
    opt = topt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    lr = tsched.constant(ARCHS_LR)
    for name, cfg, plan in cases:
        params = torch.load(os.path.join(out_dir, f"{name}.init.pt"))
        batches = torch.load(os.path.join(out_dir, f"{name}.batches.pt"))
        model = dataclasses.replace(
            build_model(cfg, "cpu"),
            init=lambda gen, p=params: tree_map(torch.clone, p))
        part = batches[0]["tokens"].shape[0] // k
        mine = [{n: v[rank * part:(rank + 1) * part] for n, v in b.items()}
                for b in batches[:ARCHS_STEPS]]
        losses, out = [], {}
        if plan == "zero1":
            eng = build_engine(TrainPlan(algo="gspmd", mode="zero1"), model,
                               opt, lr)
            state = eng.init_state(None)
            for i, b in enumerate(mine):
                state, metrics = eng.step(state, b, step_idx=i)
                losses.append(float(metrics["loss"]))
            out["specs"] = eng.specs
        else:
            state = tbsp.init_sharded_train_state(model, opt, None)
            step = tbsp.make_bsp_step(model, opt, tex.get_exchanger("asa"),
                                      lr, sharded_update=True)
            for b in mine:
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
        res[f"{name}-{plan}"] = dict(out, params=state["params"],
                                     losses=losses)
    torch.save(res, os.path.join(out_dir, f"archs{rank}.pt"))


# ---------------------------------------------------------------------------
# the dry run against a counted step (test_torch_dryrun.py)
# ---------------------------------------------------------------------------

DRY_BATCH, DRY_SEQ = 2, 64       # a rank's sequences and tokens
DRY_CASES = ("bsp", "zero1")     # BSP asa16 sharded (fused), gspmd zero1


class _Recorder:
    """A kernel library whose every entry point returns success (0) and
    does nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


def card_path():
    """The wrappers' launch path on CPU tensors, as on the card: the
    library a recorder, so each launch reports its cost and computes
    nothing."""
    from repro_torch import kernels as K
    K.on_cpu = lambda *ts: False
    K.load = lambda name: _Recorder()
    K.stream_ptr = lambda t: None
    K.sm_count = lambda index: K.META_SM_COUNT


def dry_recipe():
    from repro_torch.kernels import fused_sgd as fs
    return (topt.sgd_momentum(momentum=0.9, weight_decay=1e-4,
                              fused_kernel=fs.fused_sgd),
            tsched.warmup_cosine(0.01, 2, 4))


def dryrun_worker(rank, k, out_dir):
    """One step of each of DRY_CASES on the smoke llama3.2-1b, on the
    kernels' launch path (``card_path``), counted by a ``CostMode``:
    flops, HBM bytes and collectives of rank 0's step."""
    import json

    from repro_torch.core.gspmd import (abstract_params, fsdp_shardings,
                                        init_gspmd_state, make_gspmd_step)
    from repro_torch.data.synthetic import LMTokenSource
    from repro_torch.roofline.analysis import CostMode
    card_path()
    cfg = get_smoke_config("llama3.2-1b")
    model = build_model(cfg, "cpu")
    opt, lr = dry_recipe()
    batch = {n: torch.from_numpy(v) for n, v in LMTokenSource(
        cfg.vocab_size, DRY_SEQ).batch(DRY_BATCH, rank).items()}
    out = {}
    for case in DRY_CASES:
        gen = torch.Generator().manual_seed(0)
        if case == "bsp":
            state = tbsp.init_sharded_train_state(model, opt, gen)
            # the card's fused RS tail (on by default where the parameters
            # are on the card or the meta device)
            step = tbsp.make_bsp_step(model, opt, tex.get_exchanger("asa16"),
                                      lr, sharded_update=True,
                                      fuse_rs_update=True)
        else:
            specs = fsdp_shardings(abstract_params(model), k)
            state = init_gspmd_state(model, opt, gen, specs)
            step = make_gspmd_step(model, opt, lr, specs, mode="zero1")
        mode = CostMode()
        with mode:
            step(state, batch)
        out[case] = dict(flops=mode.flops, hbm_bytes=mode.hbm_bytes,
                         counts=mode.collectives.counts,
                         bytes_by_kind=mode.collectives.bytes_by_kind,
                         kernels=mode.kernels)
    if rank == 0:
        with open(os.path.join(out_dir, "dryrun_step.json"), "w") as f:
            json.dump(out, f)


# ---------------------------------------------------------------------------
# the encoder-decoder under every plan (test_torch_encdec_plans.py)
# ---------------------------------------------------------------------------

PLAN_STEPS = 3
PLAN_LR = 0.05
PLAN_BATCH = 2                   # a rank's sequences a step
PLAN_CASES = (("gspmd", dict(algo="gspmd", mode="zero1")),
              ("bsp-sharded", dict(exchanger="asa", sharded_update=True)),
              ("easgd", dict(algo="easgd", exchanger="asa", tau=1,
                             alpha=0.5)),
              ("asgd", dict(algo="asgd", exchanger="asa", tau=1)),
              ("bsp-klr", dict(exchanger="asa")))


def plan_batches(cfg, k):
    """PLAN_STEPS global batches of the launcher's ``synthetic_batch``
    (frames included) of k * PLAN_BATCH sequences of 16 tokens."""
    from repro_torch.launch.train import synthetic_batch
    return [synthetic_batch(cfg, k * PLAN_BATCH, i, 16)
            for i in range(PLAN_STEPS)]


def encdec_plans_worker(rank, k, out_dir, cfg, params):
    """Each of PLAN_CASES on the smoke encoder-decoder (fp32) from
    ``params``, PLAN_STEPS steps through the training loop with momentum
    SGD 0.9 (weight decay 1e-4) at PLAN_LR (``bsp-klr``: k x PLAN_LR), each
    rank on its half of every global batch. Saves the losses and the
    full parameters (gspmd's gathered back from every rank's shards)."""
    import dataclasses as dc

    from repro_torch.core.gspmd import (abstract_params, fsdp_shardings,
                                        unshard_trees)
    from repro_torch.train.engine import TrainPlan
    from repro_torch.train.loop import train
    import torch.distributed as dist
    model = build_model(cfg, "cpu")
    model = dc.replace(model, init=lambda gen: tree_map(torch.clone, params))
    batches = [{n: torch.from_numpy(v[rank * PLAN_BATCH:
                                      (rank + 1) * PLAN_BATCH])
                for n, v in b.items()} for b in plan_batches(cfg, k)]
    out = {}
    for name, kw in PLAN_CASES:
        opt = topt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
        lr = tsched.constant(PLAN_LR * (k if name == "bsp-klr" else 1))
        state, rep = train(model, opt, lr, iter(batches),
                           plan=TrainPlan(**kw), num_steps=PLAN_STEPS,
                           log_every=0, seed=0, print_fn=lambda *a: None)
        ps = state["params"]
        if name == "gspmd":
            shards = [None] * k
            dist.all_gather_object(shards, tree_map(torch.clone, ps))
            ps = unshard_trees(shards, fsdp_shardings(
                abstract_params(model), k))
        out[name] = dict(losses=rep.losses, params=leaves(ps))
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "encdec_plans.pt"))


# ---------------------------------------------------------------------------
# the model axis on real values (test_torch_model_axis.py)
# ---------------------------------------------------------------------------

AXIS_POSITIONS = (0, 1, 2)       # decode steps from an empty cache


def _shard_of(tree, specs, rank, k):
    """Rank ``rank``'s shard of every leaf of ``tree`` under ``specs``
    (each ``model`` entry splits its dim in k)."""
    from repro_torch.dist.sharding import spec_leaves
    from repro_torch.tree import flatten, unflatten
    ls, td = flatten(tree)
    out = []
    for x, sp in zip(ls, spec_leaves(specs)):
        for i, e in enumerate(sp):
            if e == "model":
                m = x.shape[i] // k
                x = x.narrow(i, rank * m, m)
        out.append(x.detach().clone())
    return unflatten(td, out)


def _rel(a, b) -> float:
    """max |a - b| over max |b| (max |a| where b is all zeros)."""
    a, b = a.detach().float(), b.detach().float()
    top = b.abs().max()
    return float((a - b).abs().max() / top) if top > 0 else float(
        a.abs().max())


def model_axis_worker(rank, k, out_dir, cases):
    """Each (name, config) of ``cases`` (fp32) on a model axis of the k
    ranks (DTensor, ``models/tp.py``) against the same model on plain
    tensors: the loss and every gradient under the reference's placement
    (``param_shardings``), then AXIS_POSITIONS decode steps from an empty
    cache (``cache_shardings``): the logits and the rank's cache shards.
    Saves the largest differences (``_rel``)."""
    import json

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist.sharding import (Mesh, cache_shardings,
                                           param_shardings)
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import tp
    from repro_torch.tree import flatten, unflatten
    mm = init_device_mesh("cpu", (k,), mesh_dim_names=("model",))
    mesh = Mesh(("model",), (k,))
    out = {}
    for name, cfg in cases:
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        batch = {n: torch.from_numpy(v)
                 for n, v in synthetic_batch(cfg, 2, 0, 16).items()}
        ls = [x.requires_grad_(True) for x in leaves(params)]
        loss, _ = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ls, allow_unused=True)
        grads = unflatten(flatten(params)[1], [
            torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, ls)])
        specs = param_shardings(mesh, params)
        local = _shard_of(params, specs, rank, k)
        lls = [x.requires_grad_(True) for x in leaves(local)]
        with implicit_replication():
            tloss, _ = tp.tp_model(model, mm, specs).loss_fn(local, batch)
            tgrads = torch.autograd.grad(tloss, lls, allow_unused=True)
        res = dict(loss=_rel(tloss, loss), grads=max(
            _rel(torch.zeros_like(w) if g is None else g, w)
            for g, w in zip(tgrads, leaves(_shard_of(grads, specs, rank,
                                                     k)))))
        if cfg.family != "encdec":
            p0 = tree_map(torch.Tensor.detach, params)
            lp = _shard_of(p0, specs, rank, k)
            cache = model.init_cache(2, 8)
            cspecs = cache_shardings(mesh, cache, 2)
            tcache = _shard_of(cache, cspecs, rank, k)
            hd = tp._heads_divide(model, mm)
            res.update(logits=0.0, cache=0.0)
            for pos in AXIS_POSITIONS:
                tok = batch["tokens"][:, pos:pos + 1]
                logits, cache = model.decode_step(p0, cache, {"tokens": tok},
                                                  pos, seq_len=8)
                with implicit_replication():
                    tl, _ = model.decode_step(
                        tp._wrap_tree(lp, mm, specs, True, hd),
                        tp._wrap_tree(tcache, mm, cspecs),
                        {"tokens": tp.wrap(tok, mm)}, pos, seq_len=8)
                    tl = tp.replicated(tl).to_local()
                res["logits"] = max(res["logits"], _rel(tl, logits))
                res["cache"] = max(res["cache"], max(
                    _rel(a, b) for a, b in zip(leaves(tcache), leaves(
                        _shard_of(cache, cspecs, rank, k)))))
        out[name] = res
    with open(os.path.join(out_dir, f"axis{rank}.json"), "w") as f:
        json.dump(out, f)
