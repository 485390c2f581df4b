"""Greedy generation: the functional reference path beside the serving
engine (counterpart of ``repro/train/serve.py``).

``generate`` runs one whole-prompt ``chunk_prefill`` that writes every
layer's cache, then ``max_new - 1`` one-token ``decode_step`` calls, each
taking the argmax of the last logits (first index on ties, as
``jnp.argmax``).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dtype_of
from repro_torch.models.registry import Model, cast_params


@torch.no_grad()
def generate(model: Model, params, prompt, *, max_new: int):
    """prompt (B, S0) int -> (B, S0 + max_new) int64: the prompt and
    ``max_new`` greedy tokens; the cache holds S0 + max_new positions."""
    if model.chunk_prefill is None:
        raise NotImplementedError(
            f"{model.cfg.name}: generate needs a decoder with chunk_prefill")
    prompt = torch.as_tensor(prompt, device=model.device).long()
    B, S0 = prompt.shape
    total = S0 + max_new
    params = cast_params(params, dtype_of(model.cfg.dtype))   # cast once
    cache = model.init_cache(B, total)
    logits, cache = model.chunk_prefill(params, cache, prompt, 0, S0,
                                        seq_len=total)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [prompt, tok]
    for i in range(S0, total - 1):
        logits, cache = model.decode_step(params, cache, {"tokens": tok}, i,
                                          seq_len=total)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
