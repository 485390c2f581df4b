"""Mixture-of-Experts layer: top-k router + capacity-based dispatch
(counterpart of ``repro/models/moe.py``).

Tokens are scattered into a dense ``(E, C, d)`` expert buffer (capacity C
per expert), the experts run as three batched products over it, and the
results come back weighted by the renormalised router probabilities.
Tokens past an expert's capacity are dropped (they contribute zero), the
GShard/Mixtral trade-off the JAX package makes. The expert products are
plain ``torch.einsum`` (batched matrix products): the JAX package computes
them outside any Pallas kernel too. Also returns the switch-transformer
load-balance loss.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(gen, d_model: int, m: MoEConfig, dtype, device=None):
    """Router (d, E) in fp32; experts wi/wu (E, d, F) and wd (E, F, d);
    the shared expert (an MLP of ``num_shared_experts * shared_expert_dim``)
    where the config has one."""
    E, F = m.num_experts, m.expert_dim
    p = {
        "router": dense_init(gen, d_model, (E,), torch.float32, device),
        "wi": dense_init(gen, d_model, (E, F), dtype, device)
        .transpose(0, 1).contiguous(),
        "wu": dense_init(gen, d_model, (E, F), dtype, device)
        .transpose(0, 1).contiguous(),
        "wd": dense_init(gen, F, (E, d_model), dtype, device)
        .transpose(0, 1).contiguous(),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d_model,
                               m.num_shared_experts * m.shared_expert_dim
                               if m.shared_expert_dim else m.expert_dim,
                               dtype, device)
    return p


def capacity(tokens: int, m: MoEConfig) -> int:
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, min(tokens, c))


def moe_forward(p, x, m: MoEConfig, *, full_capacity: bool = False,
                valid=None, expert_lo: int = 0):
    """x (B, S, d) -> (y (B, S, d), aux loss (fp32 scalar)).

    ``full_capacity=True`` sizes the buffer at C = T, so no token is ever
    dropped (a token routes to K distinct experts, so an expert takes at
    most T): each token's output is then independent of the others in
    the batch, which the serving engine's decode and prefill rely on.
    Training keeps the capped capacity. ``valid`` (flat (T,) bool)
    excludes tokens (prompt padding in chunked prefill) from routing: they
    claim no buffer slot and get only the shared expert's output.

    Expert parallelism (the dry run's model axis, ``models/tp.py``): when
    ``p``'s expert weights hold experts ``[expert_lo, expert_lo + E')``
    of the ``num_experts`` alone, the routing is the whole layer's and
    only the tokens those experts take are computed: ``y`` is this
    shard's partial sum over experts (no shared expert), the aux loss the
    whole layer's."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, K = m.num_experts, m.top_k
    C = T if full_capacity else capacity(T, m)

    # the router in fp32 (its weight may arrive cast to the compute dtype)
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # --- position of each (token, choice) within its expert ----------------
    onehot = torch.nn.functional.one_hot(gate_idx, E).to(torch.int32)
    if valid is not None:
        vm = valid.reshape(T)
        onehot = onehot * vm.reshape(T, 1, 1).to(torch.int32)
        gate_vals = gate_vals * vm.reshape(T, 1).to(gate_vals.dtype)
    # rank of each choice within its expert, counted over flattened (T*K)
    flat = onehot.reshape(T * K, E)
    pos_in_expert = torch.cumsum(flat, dim=0) - flat           # (T*K, E)
    pos = (pos_in_expert * flat).sum(-1).reshape(T, K)
    keep = pos < C
    if valid is not None:
        # invalid tokens must not scatter into (and clobber) a live slot
        keep &= vm.reshape(T, 1)
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # --- scatter tokens into the (E, C, d) buffer, row E*C the drop row ---
    E_all, E = E, p["wi"].shape[0]
    if E != E_all:              # an expert shard: the others' slots drop
        keep = keep & (gate_idx >= expert_lo) & (gate_idx < expert_lo + E)
        gate_vals = gate_vals * keep.to(gate_vals.dtype)
        gate_idx = (gate_idx - expert_lo).clamp(0, E - 1)
    slot = gate_idx * C + torch.where(keep, pos, torch.full_like(pos, C * E))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    # each token may occupy up to K slots; a kept slot is written once
    buf = buf.index_copy(0, slot.reshape(-1).clamp_max(E * C),
                         xt.repeat_interleave(K, dim=0))
    buf = buf[:-1].reshape(E, C, d)

    # --- expert computation --------------------------------------------------
    g = torch.einsum("ecd,edf->ecf", buf, p["wi"])
    u = torch.einsum("ecd,edf->ecf", buf, p["wu"])
    h = torch.nn.functional.silu(g) * u
    out = torch.einsum("ecf,efd->ecd", h, p["wd"])              # (E, C, d)

    # --- gather back ---------------------------------------------------------
    tok_out = out.reshape(E * C, d)[slot.clamp(0, E * C - 1).reshape(-1)]
    tok_out = tok_out.reshape(T, K, d) * gate_vals[..., None].to(x.dtype)
    y = tok_out.sum(1).reshape(B, S, d)

    if "shared" in p:
        y = y + mlp_forward(p["shared"], x)

    # --- load-balance auxiliary loss (switch transformer eq. 4) -------------
    me = probs.mean(0)                                          # (E,)
    ce = onehot.sum(1).float().mean(0)
    aux = E_all * (me * ce).sum() * m.router_aux_weight
    return y, aux
