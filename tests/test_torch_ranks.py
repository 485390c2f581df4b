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


def bsp_worker(rank, k, out_dir, arch="alexnet", cases=CASES):
    params = torch.load(os.path.join(out_dir, "init.pt"))
    batches = torch.load(os.path.join(out_dir, "batches.pt"))
    model = port_model(params, arch)
    opt = topt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    res = {}
    for name, exname, kw, _ in cases:
        sharded = kw.get("sharded_update", False)
        state = (tbsp.init_sharded_train_state(model, opt, None)
                 if sharded else tbsp.init_train_state(model, opt, None))
        step = tbsp.make_bsp_step(model, opt, tex.get_exchanger(exname),
                                  tsched.constant(LR), **kw)
        losses = []
        for b in batches:
            half = b["images"].shape[0] // k
            mine = {n: v[rank * half:(rank + 1) * half] for n, v in b.items()}
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
