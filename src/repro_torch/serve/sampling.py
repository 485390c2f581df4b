"""Per-slot sampling: greedy / temperature / top-k / top-p with
per-request parameters (counterpart of ``repro/serve/sampling.py``).

Temperature sampling is Gumbel-max (``argmax(logits / T + g)``) with the
noise an input, so the fused kernel (``repro_torch.kernels.slot_gather``)
and this path agree given the same noise, and a test can hand both
packages the same numbers. The noise comes from one ``torch.Generator``
per slot, seeded from the request's seed, so a request's stream does not
depend on what the other slots do. (PyTorch's generators are not JAX's:
the same seed gives other numbers than the JAX engine.)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gumbel_noise(generators, vocab: int, device) -> torch.Tensor:
    """(S, V) fp32 Gumbel noise, row s drawn from ``generators[s]``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.stack([torch.rand(vocab, generator=g, device=device)
                     for g in generators]).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def _apply_filters(scaled, top_k, top_p):
    """Top-k then top-p (nucleus) over the top-k-masked distribution;
    disabled filters (k = 0, p >= 1) keep everything."""
    S, V = scaled.shape
    sorted_desc = scaled.sort(-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, V), V).long()
    kth = sorted_desc.gather(-1, (k - 1)[:, None])
    masked = torch.where(scaled >= kth, scaled, NEG_INF)
    # keep tokens whose exclusive prefix mass (sorted descending) is still
    # below p — always at least one
    probs = torch.softmax(masked, -1)
    sp = probs.sort(-1, descending=True).values
    csum = sp.cumsum(-1)
    p = top_p.clamp(0.0, 1.0)[:, None]
    n_keep = ((csum - sp) < p).sum(-1).clamp_min(1)
    pth = sp.gather(-1, (n_keep - 1)[:, None])
    return torch.where(probs >= pth, masked, NEG_INF)


def sample_tokens(logits, temperature, top_k, top_p, noise):
    """One token per slot. logits (S, V); temperature (S,) fp32 (0 =
    greedy); top_k (S,) int (0 = off); top_p (S,) fp32 (>= 1 = off);
    noise (S, V) Gumbel. Returns (S,) int32."""
    lg = logits.float()
    greedy = lg.argmax(-1)
    scaled = lg / temperature.float().clamp_min(1e-6)[:, None]
    # the vocab sorts run only when some slot filters
    if bool(((top_k > 0) | (top_p < 1.0)).any()):
        scaled = _apply_filters(scaled, top_k, top_p)
    sampled = (scaled + noise.float()).argmax(-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def needs_full_path(sampling) -> bool:
    """Whether a request's params need the sort-based path."""
    return sampling.top_k > 0 or sampling.top_p < 1.0
