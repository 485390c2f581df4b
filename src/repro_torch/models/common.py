"""Shared layers: norms, initializers, RoPE, dtype policy, the loss.

Counterpart of ``repro/models/common.py``. Two traps that PyTorch's own
layers would get wrong: ``rms_norm`` multiplies by ``1 + scale`` (scales
start at zero), which ``torch.nn.RMSNorm`` does not; and RoPE rotates the
two *halves* of the head in fp32, not interleaved pairs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.tp import replicated, vocab_parallel_nll


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype=torch.float32,
               device=None):
    """Truncated-normal (+-2 std) fan-in init of an ``(in_dim, *out_shape)``
    einsum operand; ``out_shape`` may be an int or a tuple."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32,
               device=None):
    w = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5, reduce=None):
    """``reduce`` maps the mean square over the last dim, where that dim
    is one shard of the whole, to the whole's (``models/tp.py``)."""
    dt = x.dtype
    x = x.float()
    ms = x.pow(2).mean(-1, keepdim=True)
    if reduce is not None:
        ms = reduce(ms)
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + scale.float())).to(dt)


def head_rms_norm(x, eps: float = 1e-6):
    """Per-head qk-norm without a learned scale."""
    dt = x.dtype
    x = x.float()
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x (..., S, H, hd) rotated by halves; positions (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Mean cross-entropy over valid positions; logits (..., V), labels
    int (...). Computed in fp32. Logits sharded on the vocab (the dry
    run's model axis) take the vocab-parallel form; otherwise a DTensor's
    logits are gathered first."""
    nll = vocab_parallel_nll(logits, labels)
    if nll is None:
        logits = replicated(logits, "logits gathered for the loss").float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
