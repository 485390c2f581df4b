"""Greedy generation: the functional reference path beside the serving
engine (counterpart of ``repro/train/serve.py``).

``generate`` runs one whole-prompt ``chunk_prefill`` that writes every
layer's cache, then ``max_new - 1`` one-token ``decode_step`` calls, each
taking the argmax of the last logits (first index on ties, as
``jnp.argmax``). A family without a chunked prefill (``encdec``) takes
``_generate_stepwise``: one decode call per prompt token, its logits
discarded, as the reference does. That path never calls
``model.prefill``, so an encoder-decoder decodes against the zero cross
K/V that ``init_cache`` leaves, and its cross attention adds nothing: a
fault of the reference that the port copies.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dtype_of
from repro_torch.models.registry import Model, cast_params


def make_serve_step(model: Model, *, seq_len: int):
    """``serve(params, cache, tokens (B, 1), pos) -> (next (B, 1), cache)``
    sampling greedily; ``pos`` is the current cache write index."""

    def serve(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, {"tokens": tokens},
                                          pos, seq_len=seq_len)
        return logits[:, -1].argmax(-1)[:, None], cache

    return serve


@torch.no_grad()
def generate(model: Model, params, prompt, *, max_new: int):
    """prompt (B, S0) int -> (B, S0 + max_new) int64: the prompt and
    ``max_new`` greedy tokens; the cache holds S0 + max_new positions."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    params = cast_params(params, dtype_of(model.cfg.dtype))   # cast once
    if model.chunk_prefill is None:
        return _generate_stepwise(model, params, prompt, max_new=max_new)
    B, S0 = prompt.shape
    total = S0 + max_new
    cache = model.init_cache(B, total)
    logits, cache = model.chunk_prefill(params, cache, prompt, 0, S0,
                                        seq_len=total)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [prompt, tok]
    serve = make_serve_step(model, seq_len=total)
    for i in range(S0, total - 1):
        tok, cache = serve(params, cache, tok, i)
        out.append(tok)
    return torch.cat(out, dim=1)


def _generate_stepwise(model: Model, params, prompt, *, max_new: int):
    """The token-by-token forced prefill: a decode call per prompt token
    (logits discarded), then ``max_new`` greedy tokens."""
    B, S0 = prompt.shape
    total = S0 + max_new
    cache = model.init_cache(B, total)
    serve = make_serve_step(model, seq_len=total)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(total - 1):
        nxt, cache = serve(params, cache, tok, i)
        tok = prompt[:, i + 1:i + 2] if i + 1 < S0 else nxt
        out.append(tok)
    return torch.cat(out, dim=1)
