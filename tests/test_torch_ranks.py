"""Rank bodies of the port's multi-rank tests (``test_torch_exchange.py``,
``test_torch_train.py``, ``test_torch_lm_train.py``). Each runs in a spawned gloo process, which
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
