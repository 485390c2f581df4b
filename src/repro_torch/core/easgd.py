"""Async training plans: EASGD (paper §4; Zhang et al. 2015) and ASGD,
counterpart of ``repro/core/easgd.py``.

Each rank is one worker: it holds its own row of the reference's replica
stacks (``params`` and ``opt``) and a replica of the ``center``. The
elastic attraction to the center runs every ``tau`` steps (the averaging
period), a synchronous clock emulation of bounded-staleness asynchrony,
as in the reference. The state keeps the engine's canonical layout plus
the ``center`` extra:

    {"params": x_i, "opt": ..., "center": c, "step": int}

so the loop's checkpoints save and resume it like any other.

``make_async_step`` returns ``(local_step, sync_step)``. The local step
is this worker's optimizer step and issues no collective at all: its
metrics are this worker's own (on gloo the reference's per-step
``pmean`` would be a round trip on every step the plan means to keep off
the wire). The training loop averages them over the workers at each
flush with one all-reduce (``train/loop.py``), so what it reports equals
the reference's ``pmean`` on every step. The sync step adds the
elastic exchange through :meth:`Exchanger.exchange`, so the ASA
decomposition, bucketing and the fp16/int8 wires apply to the center
traffic as to BSP gradients, and reports the metrics' mean over the
workers (server-style order: the center absorbs the deltas first, the
workers then attract to the updated center):

    delta_i = x_i - c
    c'      = c + alpha * sum_i delta_i     (exchanger: mean * k)
    x_i'    = x_i - alpha * (x_i - c')

``algo="asgd"`` is the ``alpha = 1`` point: the center applies the full
sum of the worker deltas and the workers snap to it exactly. At tau = 1
from a synced start it equals BSP with the learning rate times k.

Each worker draws dropout from its own generator, which the loop seeds
from (seed, step, rank), the counterpart of the reference's
``_worker_rng``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.bsp import PhaseTimer, mean_metrics
from repro_torch.core.exchanger import Exchanger, Transport, as_transport
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import flatten, tree_map, unflatten


def init_async_state(model: Model, optimizer: Optimizer, gen):
    """Canonical layout + the async extras: this worker's row starts at
    the center (every worker draws the same init from ``gen``'s seed).
    Updates return new tensors, so ``params`` and ``center`` may share
    their tensors at the start."""
    params = model.init(gen)
    return {"params": params, "opt": optimizer.init(params),
            "center": params, "step": 0}


def make_async_step(model: Model, optimizer: Optimizer, exchanger: Exchanger,
                    lr_fn: Callable, group=None, *, algo: str = "easgd",
                    alpha: float = 0.5, bucket_bytes: int = 0,
                    quorum: bool = False):
    """Returns ``(local_step, sync_step)``, each ``step(state, batch,
    gen=None, timer=None) -> (state, metrics)`` on this rank. ``group``
    is a process group or a :class:`Transport`.

    With ``quorum=True`` the sync step instead takes per-worker weights,
    ``sync(state, batch, gen, timer, absorb=..., attract=...)`` with
    ``absorb`` and ``attract`` of length k (every rank passes the same
    vectors; each uses its own entry), the elastic-fleet variant:

        c'   = c + sum_i absorb_i * (x_i - c)
        x_i' = x_i - attract_i * (x_i - c')

    A worker with ``attract == 0`` keeps its parameters bit for bit, one
    with ``attract == 1`` snaps to the center. ``row=`` names this rank's
    entry of the vectors (default: its rank in the group); the elastic
    loop passes the worker's row in the membership's order, which is not
    the group's rank order once a worker joins."""
    if algo not in ("easgd", "asgd"):
        raise ValueError(f"unknown async algo {algo!r}")
    if exchanger.kind == "none":
        raise ValueError("async plans need a real exchanger for the center "
                         "traffic (got 'none')")
    a = float(alpha) if algo == "easgd" else 1.0
    tr: Transport = as_transport(group)

    def local_update(state, batch, gen, mark):
        ls, treedef = flatten(state["params"])
        ps = [l.detach().requires_grad_(True) for l in ls]
        loss, metrics = model.loss_fn(unflatten(treedef, ps), batch, gen)
        gs = torch.autograd.grad(loss, ps)
        mark("fwd_bwd")
        w, opt = optimizer.update(state["params"],
                                  unflatten(treedef, list(gs)),
                                  state["opt"], lr_fn(state["step"]))
        mark("update")
        return w, opt, {"loss": loss.detach(),
                        "aux": metrics["aux"].detach()}

    def _marker(timer):
        if timer is not None:
            timer.start()
            return timer.mark
        return lambda phase: None

    def local_step(state, batch, gen=None, timer: PhaseTimer | None = None):
        w, opt, metrics = local_update(state, batch, gen, _marker(timer))
        return ({"params": w, "opt": opt, "center": state["center"],
                 "step": state["step"] + 1}, metrics)

    def _center_round(w, center, mark, weight=None, scale=1.0):
        """c' = c + scale * k * mean_i(weight_i * (x_i - c))."""
        k = tr.world_k
        if weight is None:
            delta = tree_map(lambda wi, c: wi.float() - c.float(), w, center)
        else:
            delta = tree_map(lambda wi, c: weight * (wi.float() - c.float()),
                             w, center)
        dmean = exchanger.exchange(delta, tr, bucket_bytes)
        mark("exchange")
        return tree_map(lambda c, d: (c.float() + scale * k * d).to(c.dtype),
                        center, dmean)

    def sync_step(state, batch, gen=None, timer: PhaseTimer | None = None):
        mark = _marker(timer)
        w, opt, metrics = local_update(state, batch, gen, mark)
        c_new = _center_round(w, state["center"], mark, scale=a)
        if a == 1.0:
            # exact re-fetch (w - (w - c) would round)
            w_new = tree_map(lambda wi, c: c.to(wi.dtype), w, c_new)
        else:
            w_new = tree_map(lambda wi, c: (
                wi.float() - a * (wi.float() - c.float())).to(wi.dtype),
                w, c_new)
        mark("update")
        return ({"params": w_new, "opt": opt, "center": c_new,
                 "step": state["step"] + 1}, mean_metrics(metrics, tr))

    def sync_step_quorum(state, batch, gen=None,
                         timer: PhaseTimer | None = None, *, absorb,
                         attract, row: int | None = None):
        mark = _marker(timer)
        w, opt, metrics = local_update(state, batch, gen, mark)
        row = tr.world_rank if row is None else int(row)
        wa = float(absorb[row])
        at = float(attract[row])
        c_new = _center_round(w, state["center"], mark, weight=wa)
        if at == 1.0:
            w_new = tree_map(lambda wi, c: c.to(wi.dtype), w, c_new)
        elif at == 0.0:
            w_new = w
        else:
            w_new = tree_map(lambda wi, c: (
                wi.float() - at * (wi.float() - c.float())).to(wi.dtype),
                w, c_new)
        mark("update")
        return ({"params": w_new, "opt": opt, "center": c_new,
                 "step": state["step"] + 1}, mean_metrics(metrics, tr))

    return local_step, (sync_step_quorum if quorum else sync_step)


def reshard_async_state(state, old_workers, new_workers,
                        optimizer: Optimizer, *, k: int | None = None):
    """Migrate an async state between memberships (elastic join/leave),
    host side, over worker ids.

    ``state["params"]``/``state["opt"]`` hold the workers' rows stacked
    on a leading axis (torch tensors or numpy arrays) in the order of
    ``old_workers``; the result stacks them in the order of
    ``new_workers``. Survivors keep their rows (parameters and optimizer
    state); joiners start at the center with a fresh ``optimizer.init``
    row. ``center`` and ``step`` pass through. ``k``, when given, is the
    new membership's size, checked against ``new_workers``."""
    if k is not None and len(new_workers) != k:
        raise ValueError(f"{len(new_workers)} workers but the new "
                         f"membership has {k} ranks")
    old_index = {w: i for i, w in enumerate(old_workers)}
    center = state["center"]
    fresh = optimizer.init(tree_map(torch.as_tensor, center))

    def rows(stack, fill):
        if isinstance(stack, torch.Tensor):
            fill = torch.as_tensor(fill).to(stack.device, stack.dtype)
            return torch.stack([stack[old_index[w]] if w in old_index
                                else fill for w in new_workers])
        host = np.asarray(stack)
        fill = np.asarray(fill.cpu() if isinstance(fill, torch.Tensor)
                          else fill).astype(host.dtype)
        return np.stack([host[old_index[w]] if w in old_index else fill
                         for w in new_workers])

    return {"params": tree_map(rows, state["params"], center),
            "opt": tree_map(rows, state["opt"], fresh),
            "center": center, "step": state["step"]}
