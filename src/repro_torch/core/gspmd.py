"""GSPMD / FSDP training (counterpart of ``repro/core/gspmd.py``): the
path for models whose replicated parameters, gradients and optimizer
state do not fit a rank.

The paper's ASA decomposition (Alltoall-sum-Allgather = reduce-scatter +
all-gather) moves into the optimizer. Each rank holds, at rest, only its
shard of every parameter and of its optimizer state, on the dim that the
FSDP rule (``dist.sharding.fsdp_dim``) picks, padded where k does not
divide it; leaves the rule keeps whole are whole on every rank. A step:

- gathers the parameters through :class:`_Gather`, an
  ``autograd.Function`` whose forward all-gathers the shards over the
  :class:`~repro_torch.core.exchanger.Transport` (ASA leg 2) and whose
  backward reduces the gradient onto the shard: ``mode="zero1"``
  reduce-scatters it through the exchanger's ``asa`` route (all-to-all,
  then the ``chunk_sum`` kernel, fp32 on the wire; ASA leg 1),
  ``mode="ar"`` all-reduces it and keeps the shard (the paper's AR
  baseline). Either way the gradient is the mean over the k ranks, and a
  leaf kept whole gets the mean of its whole gradient;
- packs the leaves of one gather into one flat fp32 buffer, so a gather
  is one collective and its backward one more;
- for a decoder, gathers one layer at a time inside the layer body that
  ``models/transformer.py`` runs under ``torch.utils.checkpoint`` (the
  top-level leaves once, outside): the recompute gathers again, and a
  layer's full parameters live only while it runs. Other families gather
  the whole tree once a step;
- updates the shards with ``optimizer.update`` (with
  ``sgd_momentum(fused_kernel=fused_sgd)`` the ``fused_sgd`` kernel on
  every shard leaf), leaf by leaf, and writes the new values into the
  state's own tensors: the step consumes the state it is given (as a
  donated buffer is in JAX), so a rank holds one copy of its shards.

The batch is this rank's share of the global batch; the loss and metrics
are the global batch's mean (``core.bsp.mean_metrics``). The phase
timer books the gathers and reductions to ``exchange`` and the compute
between them to ``fwd_bwd``.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Callable

import torch

from repro_torch.core.bsp import PhaseTimer, mean_metrics
from repro_torch.core.exchanger import Transport, _rs_asa, as_transport
from repro_torch.dist.sharding import fsdp_dim, named_leaves
from repro_torch.models.registry import Model, build_model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import flatten, leaves, unflatten

MODES = ("zero1", "ar")


@dataclass(frozen=True)
class LeafSpec:
    """Where one leaf lives on k ranks: its full ``shape`` and the ``dim``
    each rank holds 1/k of (None: whole on every rank)."""
    shape: tuple
    dim: int | None
    k: int

    @property
    def chunk(self) -> int:
        """Extent of a shard along ``dim`` (the last one padded)."""
        return -(-self.shape[self.dim] // self.k)

    @property
    def shard_shape(self) -> tuple:
        if self.dim is None:
            return self.shape
        return self.shape[:self.dim] + (self.chunk,) + self.shape[
            self.dim + 1:]


# (path names, leaf) in ``tree.flatten``'s order
_named_leaves = named_leaves


def fsdp_shardings(params, k: int):
    """A :class:`LeafSpec` tree of ``params`` (tensors, real or on the
    meta device) on k ranks."""
    _, treedef = flatten(params)
    return unflatten(treedef, [
        LeafSpec(tuple(x.shape), fsdp_dim(names, tuple(x.shape), k), k)
        for names, x in _named_leaves(params)])


def fsdp_state_shardings(state, k: int):
    """Specs of a train state: the parameters and the optimizer's ``m`` and
    ``v`` by the FSDP rule, every other entry (AdamW's ``t``, ``step``)
    whole."""
    whole = LeafSpec((), None, k)
    opt = {n: (fsdp_shardings(v, k) if n in ("m", "v") else whole)
           for n, v in state["opt"].items()}
    return {"params": fsdp_shardings(state["params"], k), "opt": opt,
            "step": whole}


def abstract_params(model: Model):
    """The model's parameter tree on the meta device: shapes and dtypes,
    no memory (the counterpart of ``jax.eval_shape`` of the init)."""
    meta = build_model(model.cfg, "meta")
    return meta.init(None if model.cfg.family == "conv" else
                     torch.Generator())


# ---------------------------------------------------------------------------
# shard <-> full, on one rank's tensors
# ---------------------------------------------------------------------------

def shard_leaf(x: torch.Tensor, spec: LeafSpec, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the full leaf ``x`` (a new tensor, zero
    past the leaf's end)."""
    if spec.dim is None:
        return x.clone()
    d, c = spec.dim, spec.chunk
    n = x.shape[d]
    lo, hi = min(rank * c, n), min((rank + 1) * c, n)
    out = torch.zeros(spec.shard_shape, dtype=x.dtype, device=x.device)
    out.narrow(d, 0, hi - lo).copy_(x.narrow(d, lo, hi - lo))
    return out


def _merge(stack: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
    """(k, *shard_shape) shards in rank order -> the full leaf."""
    d = spec.dim
    x = stack.movedim(0, d)
    x = x.reshape(spec.shape[:d] + (spec.k * spec.chunk,)
                  + spec.shape[d + 1:])
    return x.narrow(d, 0, spec.shape[d]).contiguous()


def _split_into(dst: torch.Tensor, full: torch.Tensor,
                spec: LeafSpec) -> None:
    """Write the full leaf into ``dst`` (k, shard numel), row r rank r's
    shard (zero padded), in one strided copy."""
    d, c, k = spec.dim, spec.chunk, spec.k
    pad = k * c - spec.shape[d]
    if pad:
        tail = list(full.shape)
        tail[d] = pad
        full = torch.cat([full, full.new_zeros(tail)], dim=d)
    x = full.reshape(spec.shape[:d] + (k, c) + spec.shape[d + 1:])
    dst.view((k,) + spec.shard_shape).copy_(x.movedim(d, 0))


def shard_tree(tree, specs, rank: int):
    """Rank ``rank``'s shard of every leaf of a full tree."""
    ls, treedef = flatten(tree)
    spec_ls = leaves(specs)
    if [tuple(x.shape) for x in ls] != [s.shape for s in spec_ls]:
        raise ValueError("the tree's leaves are not the specs' shapes")
    return unflatten(treedef, [shard_leaf(x, s, rank)
                               for x, s in zip(ls, spec_ls)])


def unshard_trees(shard_trees: list, specs):
    """The full tree from every rank's shard tree, in rank order (no
    collective: the shards are at hand)."""
    per_rank = [leaves(t) for t in shard_trees]
    out, treedef = [], flatten(specs)[1]
    for i, s in enumerate(leaves(specs)):
        if s.dim is None:
            out.append(per_rank[0][i].clone())
        else:
            out.append(_merge(torch.stack([r[i] for r in per_rank]), s))
    return unflatten(treedef, out)


# ---------------------------------------------------------------------------
# the gather and its backward
# ---------------------------------------------------------------------------

class _Pack:
    """The leaves of one gather: their specs, the transport, the mode and
    the timer's ``mark``."""

    def __init__(self, specs: list, tr: Transport, mode: str, mark):
        self.specs, self.tr, self.mode, self.mark = specs, tr, mode, mark
        self.sharded = [i for i, s in enumerate(specs) if s.dim is not None]
        self.whole = [i for i, s in enumerate(specs) if s.dim is None]

    def gather(self, shards) -> list:
        self.dtypes = [x.dtype for x in shards]
        self.device = shards[0].device
        out = [None] * len(shards)
        for i in self.whole:
            out[i] = shards[i].clone()
        if not self.sharded:
            return out
        flat = torch.cat([shards[i].detach().reshape(-1).float()
                          for i in self.sharded])
        self.mark("fwd_bwd")
        got = self.tr.all_gather(flat).view(self.tr.k, -1)
        self.mark("exchange")
        off = 0
        for i in self.sharded:
            s = self.specs[i]
            n = prod(s.shard_shape)
            stack = got[:, off:off + n].reshape((s.k,) + s.shard_shape)
            out[i] = _merge(stack, s).to(shards[i].dtype)
            off += n
        return out

    def reduce(self, grads) -> list:
        """Full gradients -> this rank's shard of their mean over the
        ranks (whole leaves: the whole mean). The gradients are written
        into one flat fp32 buffer, (k, shard elements) row by destination
        rank: zero1 adds the whole leaves to every row, so that the
        all-to-all's sum hands each rank their whole sum; ar puts them
        once after the rows."""
        tr, k, dev = self.tr, self.tr.k, self.device
        zero1 = self.mode == "zero1"
        n_sh = sum(prod(self.specs[i].shard_shape) for i in self.sharded)
        n_wh = sum(prod(self.specs[i].shape) for i in self.whole)
        flat = torch.empty(k * (n_sh + n_wh) if zero1 else k * n_sh + n_wh,
                           dtype=torch.float32, device=dev)
        buf = flat[:k * (n_sh + n_wh) if zero1 else k * n_sh].view(k, -1)
        full = lambda i: (torch.zeros(self.specs[i].shape, device=dev)  # noqa: E731
                          if grads[i] is None else grads[i])
        off = 0
        for i in self.sharded:
            n = prod(self.specs[i].shard_shape)
            _split_into(buf[:, off:off + n], full(i), self.specs[i])
            off += n
        w = 0
        for i in self.whole:
            g = full(i).reshape(-1)
            n = g.numel()
            if zero1:
                buf[:, n_sh + w:n_sh + w + n].copy_(g.expand(k, -1))
            else:
                flat[k * n_sh + w:k * n_sh + w + n].copy_(g)
            w += n
        self.mark("fwd_bwd")
        if zero1:
            red = _rs_asa(flat, tr, 1.0 / k, None)
            sh, wh = red[:n_sh], red[n_sh:]
        else:
            red = tr.all_reduce(flat) * (1.0 / k)
            sh = red[:k * n_sh].view(k, -1)[tr.rank]
            wh = red[k * n_sh:]
        del flat, buf
        self.mark("exchange")
        out = [None] * len(grads)
        off = 0
        for i in self.sharded:
            s = self.specs[i]
            n = prod(s.shard_shape)
            out[i] = sh[off:off + n].reshape(s.shard_shape).to(
                self.dtypes[i])
            off += n
        off = 0
        for i in self.whole:
            n = prod(self.specs[i].shape)
            out[i] = wh[off:off + n].reshape(self.specs[i].shape).to(
                self.dtypes[i])
            off += n
        return out


class _Gather(torch.autograd.Function):
    """Shards -> full leaves; the backward reduces the full gradients onto
    the shards (``_Pack.reduce``)."""

    @staticmethod
    def forward(ctx, pack: _Pack, *shards):
        ctx.pack = pack
        return tuple(pack.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.pack.reduce(list(grads)))


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

def init_gspmd_state(model: Model, optimizer: Optimizer, gen, specs,
                     group=None):
    """This rank's shard of the state ``init_train_state`` draws from
    ``gen``: the parameters and, from them, the optimizer state (``m``,
    ``v`` shaped like the shards; AdamW's ``t`` whole)."""
    tr = as_transport(group)
    full = model.init(gen)
    params = shard_tree(full, specs, tr.rank)
    del full
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def _update_in_place(optimizer: Optimizer, params, grads, opt, lr):
    """``optimizer.update`` leaf by leaf (``m``/``v`` per leaf, any other
    entry whole: the same arithmetic as one call on the trees), each new
    value written into the state's tensor and the leaf's gradient dropped
    as soon as it is used."""
    per_leaf = [n for n in ("m", "v") if n in opt]
    rest = {n: v for n, v in opt.items() if n not in per_leaf}
    p_ls = leaves(params)
    st_ls = {n: leaves(opt[n]) for n in per_leaf}
    new_rest = rest
    for i, p in enumerate(p_ls):
        st = dict(rest, **{n: st_ls[n][i] for n in per_leaf})
        p_new, st_new = optimizer.update(p, grads[i], st, lr)
        grads[i] = None
        p.copy_(p_new)
        for n in per_leaf:
            st_ls[n][i].copy_(st_new[n])
        new_rest = {n: st_new[n] for n in rest}
    return dict(opt, **new_rest)


def make_gspmd_step(model: Model, optimizer: Optimizer, lr_fn: Callable,
                    specs, group=None, *, mode: str = "zero1"):
    """Returns ``step(state, batch, gen=None, timer=None) -> (state,
    metrics)`` on a state of shards laid out by ``specs`` (a
    :class:`LeafSpec` tree of the parameters). ``group`` is a process
    group or a :class:`Transport`; ``batch`` is this rank's share. The
    step consumes ``state`` (module docstring)."""
    if mode not in MODES:
        raise ValueError(f"unknown gspmd mode {mode!r}; known: {MODES}")
    tr = as_transport(group)
    spec_ls = leaves(specs)
    layerwise = getattr(getattr(model, "cfg", None), "family",
                        None) == "decoder"

    def step(state, batch, gen=None, timer: PhaseTimer | None = None):
        if timer is not None:
            timer.start()
        mark = timer.mark if timer is not None else (lambda phase: None)
        ls, treedef = flatten(state["params"])
        if len(ls) != len(spec_ls):
            raise ValueError(f"state has {len(ls)} parameter leaves, the "
                             f"specs {len(spec_ls)}")
        ps = [x.detach().requires_grad_(True) for x in ls]
        spec_of = {id(p): s for p, s in zip(ps, spec_ls)}

        def gather(tree):
            xs, td = flatten(tree)
            pack = _Pack([spec_of[id(x)] for x in xs], tr, mode, mark)
            return unflatten(td, list(_Gather.apply(pack, *xs)))

        params = unflatten(treedef, ps)
        if layerwise:
            loss, metrics = model.loss_fn(params, batch, gen, gather=gather)
        else:
            loss, metrics = model.loss_fn(gather(params), batch, gen)
        grads = list(torch.autograd.grad(loss, ps, allow_unused=True))
        mark("fwd_bwd")
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, ps)]
        del ps, params, spec_of
        with torch.no_grad():
            opt = _update_in_place(optimizer, state["params"], grads,
                                   state["opt"], lr_fn(state["step"]))
        mark("update")
        metrics = mean_metrics({"loss": loss.detach(),
                                "aux": metrics["aux"].detach()}, tr)
        return ({"params": state["params"], "opt": opt,
                 "step": state["step"] + 1}, metrics)

    return step
