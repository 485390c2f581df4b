"""Optimizers on parameter trees of tensors: momentum SGD (the paper's
optimizer, for both its AWAGD and SUBGD schemes) and AdamW. Counterpart
of ``repro/optim/optimizers.py``.

An ``Optimizer`` is (init, update):
    state = init(params)
    new_params, new_state = update(params, grads, state, lr)

with ``lr`` a Python float from a schedule. The flat hooks serve the
sharded RS -> update -> AG path of ``core/bsp.py``, where each rank owns
the flat fp32 shard of every bucket:

    st = flat_init(n, device)
    p', st' = flat_update(p, g, st, lr, wd_mask)

``wd_mask`` is a 0/1 fp32 tensor marking elements whose original leaf is
>= 2-D (weight decay never applies to biases), or None for no decay.
``rs_fused_update`` fuses the k-way chunk sum into the update (the
``fused_rs_update`` kernel): it takes the un-summed all-to-all receives.
Updates return new tensors; nothing is modified in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable
    flat_init: Callable | None = None
    flat_update: Callable | None = None
    rs_fused_update: Callable | None = None


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def _map_tuples(fn, *trees):
    """``fn`` over corresponding leaves; ``fn`` returns a tuple, which
    stays a leaf of the result."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_tuples(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_map_tuples(fn, *vs) for vs in zip(*trees)]
    return fn(*trees)


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 5e-4,
                 nesterov: bool = False, fused_kernel=None) -> Optimizer:
    """The paper's momentum SGD.

    ``fused_kernel``: the fused update (``kernels.fused_sgd.fused_sgd``),
    applied to every leaf of ndim >= 1 after weight decay; plain torch
    elsewhere."""

    def init(params):
        return {"m": tree_map(_zeros32, params)}

    def update(params, grads, state, lr):
        def leaf(p, g, m):
            g32 = g.float()
            if weight_decay and p.dim() > 1:
                g32 = g32 + weight_decay * p.float()
            if fused_kernel is not None and p.dim() >= 1:
                p_new, m_new = fused_kernel(p.float(), g32, m, lr, momentum,
                                            nesterov)
                return p_new.to(p.dtype), m_new
            m_new = momentum * m + g32
            step = (g32 + momentum * m_new) if nesterov else m_new
            return (p.float() - lr * step).to(p.dtype), m_new

        out = _map_tuples(leaf, params, grads, state["m"])
        return _pick(out, 0), {"m": _pick(out, 1)}

    def flat_init(n: int, device=None):
        return {"m": torch.zeros((n,), dtype=torch.float32, device=device)}

    def flat_update(p, g, state, lr, wd_mask):
        g32 = g.float()
        p32 = p.float()
        if weight_decay and wd_mask is not None:
            g32 = g32 + weight_decay * wd_mask * p32
        if fused_kernel is not None:
            p_new, m_new = fused_kernel(p32, g32, state["m"], lr, momentum,
                                        nesterov)
        else:
            m_new = momentum * state["m"] + g32
            step = (g32 + momentum * m_new) if nesterov else m_new
            p_new = p32 - lr * step
        return p_new, {"m": m_new}

    def rs_fused_update(recv, p, state, lr, wd_mask, scale, scales=None):
        from repro_torch.kernels.fused_rs_update import fused_rs_update
        p_new, m_new = fused_rs_update(
            recv, p.float(), state["m"], lr, wd_mask=wd_mask, scale=scale,
            momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
            scales=scales)
        return p_new, {"m": m_new}

    return Optimizer("sgd", init, update, flat_init, flat_update,
                     rs_fused_update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def _t0(device):
        return torch.zeros((), dtype=torch.int32, device=device)

    def _bias_corrections(t):
        tf = t.float()
        return 1.0 - b1 ** tf, 1.0 - b2 ** tf

    def init(params):
        first = next(iter(leaves(params)), None)
        return {"m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params),
                "t": _t0(None if first is None else first.device)}

    def update(params, grads, state, lr):
        t = state["t"] + 1
        bc1, bc2 = _bias_corrections(t)

        def leaf(p, g, m, v):
            g32 = g.float()
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            p32 = p.float()
            if weight_decay and p.dim() > 1:
                step = step + weight_decay * p32
            return (p32 - lr * step).to(p.dtype), m_new, v_new

        out = _map_tuples(leaf, params, grads, state["m"], state["v"])
        return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                               "t": t}

    def flat_init(n: int, device=None):
        return {"m": torch.zeros((n,), dtype=torch.float32, device=device),
                "v": torch.zeros((n,), dtype=torch.float32, device=device),
                "t": _t0(device)}

    def flat_update(p, g, state, lr, wd_mask):
        t = state["t"] + 1
        bc1, bc2 = _bias_corrections(t)
        g32 = g.float()
        p32 = p.float()
        m_new = b1 * state["m"] + (1 - b1) * g32
        v_new = b2 * state["v"] + (1 - b2) * torch.square(g32)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if weight_decay and wd_mask is not None:
            step = step + weight_decay * wd_mask * p32
        return p32 - lr * step, {"m": m_new, "v": v_new, "t": t}

    return Optimizer("adamw", init, update, flat_init, flat_update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd_momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise KeyError(name)
