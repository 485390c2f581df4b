"""BSP synchronous data-parallel training (paper §3.1, §4), counterpart of
``repro/core/bsp.py``.

Each rank is one process holding the full model; ``make_bsp_step``
returns ``step(state, batch, gen=None, timer=None) -> (state, metrics)``
for this rank's share of the global batch. Both of the paper's
parallel-SGD schemes:

- ``subgd``: mean the gradients across ranks BEFORE the descent step;
- ``awagd``: each rank descends on its local gradient, then weights AND
  momentum are averaged.

``subgd`` also has the sharded path (``sharded_update=True``): the
exchange splits into its reduce-scatter and all-gather halves and the
optimizer updates only this rank's 1/k shard of every bucket between
them (RS -> update -> AG), with the fp32 master shard and the optimizer
state kept per rank (ZeRO-1). With the ``asa`` family and an optimizer
that has ``rs_fused_update``, the reduce-scatter hands its un-summed
(k, s) receives to the ``fused_rs_update`` kernel (``fuse_rs_update``;
None: on when the parameters are on the card, the counterpart of the JAX
package turning the Pallas kernel on where kernels compile).

``overlap="buckets"`` (the paper's §3.2 overlap of the exchange with
backprop) implies the sharded update: with ``microbatches`` >= 2,
microbatch i-1's bucket reduce-scatter is in flight while microbatch
i's forward and backward are queued and run
(:meth:`Exchanger.reduce_scatter_start`: the all-to-alls start on a
helper thread once their device -> host copies are done), and is waited
for after them. Every microbatch's gradient crosses the wire (m times
the reduce-scatter volume); the shards accumulate in fp32, and on the
fused route the raw chunks do and ``fused_rs_update`` runs once at the
end with scale 1/(k m). The timer's ``exchange`` is then the exposed
part, and the transport's ``wire_s`` the collectives' whole time.

On a two-level transport (``hier``) the raw (fused) tail is refused:
the shard is summed across pods before the update.

``grad_norm=True`` adds the gradient norm to an unsharded step's
metrics (the reference's rule: for subgd the norm of the exchanged
global mean, the same on every rank; for awagd the root of the workers'
mean squared local norm). Its square rides in the metrics' one
all-reduce, so it adds no collective.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.exchanger import (RAW_SINGLE_LEVEL, Exchanger, RSPlan,
                                        Transport, _from_wire, as_transport,
                                        make_rs_plan, param_wire_dtype)
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import flatten, leaves, unflatten

PHASES = ("fwd_bwd", "exchange", "update")


class PhaseTimer:
    """Splits a step into forward+backward, exchange and update time.

    ``mark(phase)`` closes the interval since the previous mark and books
    it to ``phase``. On the card each mark records a CUDA event, so the
    split is device time read after the step (``split_s`` synchronises
    once); on the CPU it reads the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: list = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self._marks = [(None, self._now())]

    def mark(self, phase: str) -> None:
        self._marks.append((phase, self._now()))

    def split_s(self) -> dict:
        """Seconds per phase of the last step."""
        out = {p: 0.0 for p in PHASES}
        if self.cuda and self._marks:
            self._marks[-1][1].synchronize()
        for (_, a), (phase, b) in zip(self._marks, self._marks[1:]):
            out[phase] += (a.elapsed_time(b) / 1e3 if self.cuda else b - a)
        return out


class KindStats:
    """Per kind of step (``"sync"``, ``"local"``, ...): the count, the mean
    seconds of each phase and the mean transport counters (staged bytes,
    staging, collectives, exposed wait) a step."""

    COUNTERS = ("staged_bytes", "stage_s", "wire_s", "exposed_s")

    def __init__(self):
        self._sum: dict = {}

    def add(self, kind: str, split: dict, moved) -> None:
        """One step: its ``PhaseTimer.split_s()`` and its transport
        counters' deltas, in ``COUNTERS`` order."""
        acc = self._sum.setdefault(kind, {"steps": 0})
        acc["steps"] += 1
        for name, v in list(split.items()) + list(zip(self.COUNTERS, moved)):
            acc[name] = acc.get(name, 0.0) + v

    def means(self) -> dict:
        return {kind: {n: (v if n == "steps" else v / acc["steps"])
                       for n, v in acc.items()}
                for kind, acc in self._sum.items()}


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


def init_train_state(model: Model, optimizer: Optimizer, gen):
    params = model.init(gen)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def init_sharded_train_state(model: Model, optimizer: Optimizer, gen,
                             group=None, bucket_bytes: int = 0):
    """Train state for the RS -> update -> AG path: this rank's fp32
    master shard and flat optimizer state of every bucket (1/k of each;
    on a two-level transport k and the shard's position are the pod's),
    replicated flat state for the small leaves, and the full compute
    params, which each step rebuilds from the wire-dtype all-gather (so
    the gather's rounding never feeds back into the update)."""
    if optimizer.flat_init is None:
        raise ValueError(f"optimizer {optimizer.name!r} has no flat/sharded "
                         "update support (flat_init/flat_update)")
    tr = as_transport(group)
    params = model.init(gen)
    plan = make_rs_plan(params, tr.k, bucket_bytes)
    dev = _device_of(params)
    flats = Exchanger.pack(params, plan)[0]
    master = [f[tr.rank * b.shard_len:(tr.rank + 1) * b.shard_len].clone()
              for f, b in zip(flats, plan.buckets)]
    opt = {"buckets": [optimizer.flat_init(b.shard_len, dev)
                       for b in plan.buckets],
           "small": [optimizer.flat_init(
               int(torch.Size(plan.shapes[i]).numel()), dev)
               for i in plan.small],
           "master": master}
    return {"params": params, "opt": opt, "step": 0}


def _split_batch(batch: dict, m: int) -> list[dict]:
    return [{k: v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)]
             for k, v in batch.items()} for i in range(m)]


def mean_metrics(metrics: dict, tr: Transport) -> dict:
    """The metrics' mean over every rank: one all-reduce of a vector."""
    names = sorted(metrics)
    v = torch.stack([metrics[n].float().reshape(()) for n in names])
    v = tr.all_reduce(v) / tr.world_k
    return {n: v[i] for i, n in enumerate(names)}


def shard_wd_mask(plan: RSPlan, b, start: int, device) -> torch.Tensor:
    """(shard_len,) fp32: 1 where the element's original leaf is >= 2-D
    (weight decay applies), for the shard that starts at ``start``."""
    mask = torch.zeros((b.shard_len,), dtype=torch.float32, device=device)
    off = 0
    for i, n in zip(b.leaves, b.sizes):
        if len(plan.shapes[i]) > 1:
            lo, hi = max(off, start), min(off + n, start + b.shard_len)
            if lo < hi:
                mask[lo - start:hi - start] = 1.0
        off += n
    return mask


def make_bsp_step(model: Model, optimizer: Optimizer, exchanger: Exchanger,
                  lr_fn: Callable, group=None, scheme: str = "subgd",
                  microbatches: int = 1,
                  bucket_bytes: int = 0, sharded_update: bool = False,
                  overlap: str | None = None, fuse_rs_update=None,
                  grad_norm: bool = False):
    """Returns ``step(state, batch, gen=None, timer=None) -> (state,
    metrics)``. ``batch`` is this rank's share; ``gen`` (a
    ``torch.Generator``) draws dropout, None runs without it; ``timer``
    (a :class:`PhaseTimer`) receives the phase marks. ``group`` is a
    process group or a :class:`Transport`. ``microbatches`` > 1
    splits the batch and accumulates fp32 gradients before one exchange.
    ``sharded_update=True`` (subgd only) takes the RS -> update -> AG path
    on a state from :func:`init_sharded_train_state` with the same
    ``bucket_bytes``; ``overlap="buckets"`` implies it; ``grad_norm``
    adds ``metrics["grad_norm"]`` on the unsharded paths (module
    docstring)."""
    if overlap not in (None, "buckets"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    if overlap:
        sharded_update = True
    if scheme not in ("subgd", "awagd"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if sharded_update and scheme != "subgd":
        raise ValueError("sharded_update requires scheme='subgd' "
                         "(awagd updates on the local gradient)")
    if sharded_update and (optimizer.flat_update is None
                           or optimizer.flat_init is None):
        raise ValueError(f"optimizer {optimizer.name!r} has no flat_init/"
                         "flat_update; cannot shard the update")
    tr: Transport = as_transport(group)
    raw_ok = exchanger.supports_raw and optimizer.rs_fused_update is not None
    if sharded_update and fuse_rs_update and tr.lead is not None:
        raise ValueError(f"fuse_rs_update with {exchanger.name!r} on a "
                         f"two-level transport: {RAW_SINGLE_LEVEL}")
    if sharded_update and fuse_rs_update and not raw_ok:
        raise ValueError(
            f"fuse_rs_update needs an all-to-all strategy and an optimizer "
            f"with rs_fused_update (got {exchanger.name!r} / "
            f"{optimizer.name!r})")
    raw_ok = raw_ok and tr.lead is None
    overlapped = overlap == "buckets" and microbatches > 1
    masks: dict = {}

    def one_grad(ls, treedef, mb, gen):
        ps = [l.detach().requires_grad_(True) for l in ls]
        loss, metrics = model.loss_fn(unflatten(treedef, ps), mb, gen)
        gs = torch.autograd.grad(loss, ps)
        return loss.detach(), metrics["aux"].detach(), gs

    def grad_of(params, batch, gen):
        ls, treedef = flatten(params)

        def one(mb):
            return one_grad(ls, treedef, mb, gen)

        if microbatches <= 1:
            loss, aux, gs = one(batch)
            return {"loss": loss, "aux": aux}, unflatten(treedef, list(gs))
        acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
               for l in ls]
        loss_sum = aux_sum = 0.0
        for mb in _split_batch(batch, microbatches):
            loss, aux, gs = one(mb)
            acc = [a + g.float() for a, g in zip(acc, gs)]
            loss_sum, aux_sum = loss_sum + loss, aux_sum + aux
        m = float(microbatches)
        return ({"loss": loss_sum / m, "aux": aux_sum / m},
                unflatten(treedef, [a / m for a in acc]))

    def step_unsharded(state, batch, gen, mark):
        params = state["params"]
        metrics, grads = grad_of(params, batch, gen)
        mark("fwd_bwd")
        lr = lr_fn(state["step"])
        if scheme == "subgd":
            grads = exchanger.exchange(grads, tr, bucket_bytes)
            mark("exchange")
            new_params, new_opt = optimizer.update(params, grads,
                                                   state["opt"], lr)
            mark("update")
        else:
            new_params, new_opt = optimizer.update(params, grads,
                                                   state["opt"], lr)
            mark("update")
            # average weights AND momentum after the descent step
            new_params = exchanger.exchange(new_params, tr, bucket_bytes)
            new_opt = exchanger.exchange(new_opt, tr, bucket_bytes)
            mark("exchange")
        if grad_norm:
            # subgd: the exchanged mean (equal on every rank); awagd: the
            # local gradient, whose square mean_metrics averages
            metrics["grad_sq"] = sum(g.float().square().sum()
                                     for g in leaves(grads))
        return new_params, new_opt, metrics

    def overlapped_rs(params, batch, gen, mark, plan, use_raw):
        """Microbatch i's forward and backward are queued while microbatch
        i-1's reduce-scatter is in flight; returns (metrics, fp32 sums over
        the microbatches of the shards, or of the raw chunks, and of the
        small leaves' means). Only the last reduce-scatter is exposed."""
        ls, treedef = flatten(params)
        acc = accf = pending = None
        loss_s = aux_s = 0.0

        def absorb(pending):
            """Add one microbatch's reduce-scatter to the sums, a bucket at
            a time (one bucket's fp32 copy of the raw chunks at once)."""
            nonlocal acc, accf
            res = pending.finish()
            parts = res["chunks" if use_raw else "shards"]
            scales = res.get("scales") or [None] * len(parts)
            if acc is None:
                acc = [None] * len(parts)
            for i in range(len(parts)):
                part = _from_wire(parts[i]) if use_raw else parts[i]
                parts[i] = None
                if scales[i] is not None:              # int8 wire
                    part = part * scales[i][:, None]
                acc[i] = part if acc[i] is None else acc[i].add_(part)
            accf = res["full"] if accf is None else [
                a + f for a, f in zip(accf, res["full"])]

        for mb in _split_batch(batch, microbatches):
            loss, aux, gs = one_grad(ls, treedef, mb, gen)
            mark("fwd_bwd")
            if pending is not None:
                absorb(pending)
                mark("exchange")
            pending = exchanger.reduce_scatter_start(
                unflatten(treedef, list(gs)), tr, plan=plan, raw=use_raw)
            del gs
            mark("exchange")
            loss_s, aux_s = loss_s + loss, aux_s + aux
        absorb(pending)
        mark("exchange")
        m = float(microbatches)
        return {"loss": loss_s / m, "aux": aux_s / m}, acc, accf

    def step_sharded(state, batch, gen, mark):
        params = state["params"]
        plan = make_rs_plan(params, tr.k, bucket_bytes)
        dev = _device_of(params)
        use_raw = (raw_ok and dev.type in ("cuda", "meta")
                   if fuse_rs_update is None
                   else bool(fuse_rs_update))
        lr = lr_fn(state["step"])
        scales = [None] * plan.num_buckets
        scale = 1.0 / plan.k
        if overlapped:
            metrics, acc, accf = overlapped_rs(params, batch, gen, mark,
                                               plan, use_raw)
            m = float(microbatches)
            res = {"full": [a / m for a in accf]}
            if use_raw:
                res["chunks"] = acc
                scale = 1.0 / (plan.k * m)
            else:
                res["shards"] = [a / m for a in acc]
        else:
            metrics, grads = grad_of(params, batch, gen)
            mark("fwd_bwd")
            res, _ = exchanger.reduce_scatter(grads, tr, plan=plan,
                                              raw=use_raw)
            mark("exchange")
            if use_raw and res["scales"]:
                scales = res["scales"]
        new_master, new_bstates = [], []
        for bi, b in enumerate(plan.buckets):
            key = (plan.shapes, bi, tr.rank, dev)
            if key not in masks:
                masks[key] = shard_wd_mask(plan, b, tr.rank * b.shard_len,
                                           dev)
            p_sh = state["opt"]["master"][bi]
            st = state["opt"]["buckets"][bi]
            if use_raw:
                p_new, st_new = optimizer.rs_fused_update(
                    res["chunks"][bi], p_sh, st, lr, masks[key], scale,
                    scales[bi])
            else:
                p_new, st_new = optimizer.flat_update(
                    p_sh, res["shards"][bi], st, lr, masks[key])
            new_master.append(p_new)
            new_bstates.append(st_new)
        p_leaves = leaves(params)
        new_smalls, new_sstates = [], []
        for si, i in enumerate(plan.small):
            p_fl = p_leaves[i].reshape(-1).float()
            mask = torch.ones_like(p_fl) if len(plan.shapes[i]) > 1 else None
            p_new, st_new = optimizer.flat_update(
                p_fl, res["full"][si].reshape(-1), state["opt"]["small"][si],
                lr, mask)
            new_smalls.append(p_new)
            new_sstates.append(st_new)
        mark("update")
        new_flats = exchanger.all_gather(new_master, plan, tr,
                                         wire_dtype=param_wire_dtype(
                                             exchanger))
        mark("exchange")
        new_opt = {"buckets": new_bstates, "small": new_sstates,
                   "master": new_master}
        return (Exchanger.unpack(new_flats, new_smalls, plan), new_opt,
                metrics)

    body = step_sharded if sharded_update else step_unsharded

    def step(state, batch, gen=None, timer: PhaseTimer | None = None):
        if timer is not None:
            timer.start()
        mark = timer.mark if timer is not None else (lambda phase: None)
        new_params, new_opt, metrics = body(state, batch, gen, mark)
        metrics = mean_metrics(metrics, tr)
        if "grad_sq" in metrics:
            metrics["grad_norm"] = metrics.pop("grad_sq").sqrt()
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step
