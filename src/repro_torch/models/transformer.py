"""Decoder-only LM executor, dense and MoE layers (counterpart of
``repro/models/transformer.py``).

Parameters are a dict: ``embed`` (V, d), ``ln_f`` (d,), ``head`` (d, V)
unless embeddings are tied, and ``layers`` — one dict per layer (the JAX
package's ``blocks[seg]`` stacks unstacked; ``repro_torch.bridge``
converts). The JAX ``lax.scan`` over stacked layers is a Python loop over
layers here. Caches keep the JAX structure: one entry per segment of
consecutive same-kind layers, ``{"attn": {"k", "v"}}`` (MLA: ``{"ckv",
"kr"}``, the latent and the rope key) with a leading layer axis, so a
paged pool is ``(layers, P, page_size, KV, hd)`` (MLA: ``(layers, P,
page_size, R)``). Decode and prefill write the caches in place and
return them.

Training runs ``decoder_loss`` under autograd. With ``cfg.remat`` each
layer runs under ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of the JAX package's ``jax.checkpoint(body)``: only the
layer inputs are kept, and the backward recomputes each layer's forward
(the flash forward kernel launches twice per layer and step).

Layer kinds: ``dense`` (attention + MLP) and ``moe`` (attention + the
MoE layer of ``models/moe.py``; DeepSeek-V2's first ``first_k_dense``
layers are dense). Training routes with the capped capacity and adds the
layers' load-balance loss to the loss; decode and prefill route with
full capacity (no drops, so a slot's tokens never depend on what the
other slots hold), and prefill keeps the pad tail out of the routing.
SSM and hybrid layers and meta tokens come with a later slice and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (dtype_of, embed_init, dense_init,
                                       rms_norm, softmax_xent)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward

LATER_SLICE = ("only dense and MoE decoder layers are ported; SSM and "
               "hybrid layers and meta tokens come with a later slice "
               "(ROADMAP queue 1)")


# ---------------------------------------------------------------------------
# layer layout (plain Python, as in the JAX package)
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Per-layer kind: 'dense' | 'moe' | 'ssm' | 'hybrid'."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.block == "ssm":
            kinds.append("ssm")
        elif cfg.block == "hybrid":
            kinds.append("hybrid")
        elif cfg.moe is not None:
            m = cfg.moe
            if i < m.first_k_dense or ((i - m.first_k_dense) % m.moe_every) != 0:
                kinds.append("dense")
            else:
                kinds.append("moe")
        else:
            kinds.append("dense")
    return kinds


def layer_windows(cfg: ArchConfig, shape_kind: str, seq_len: int) -> list[int]:
    """Static per-layer attention window (0 = full causal)."""
    a = cfg.attention
    wins = []
    for i in range(cfg.num_layers):
        w = a.sliding_window if a else 0
        if cfg.global_attn_every:
            is_global = (i % cfg.global_attn_every == 0) or i == cfg.num_layers - 1
            w = 0 if is_global else (a.sliding_window or 1024)
        if seq_len > 100_000 and cfg.long_context_window and w == 0:
            w = cfg.long_context_window
        wins.append(w)
    return wins


def segments(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Group consecutive identical kinds -> [(kind, count), ...]."""
    segs: list[tuple[str, int]] = []
    for k in layer_kinds(cfg):
        if segs and segs[-1][0] == k:
            segs[-1] = (k, segs[-1][1] + 1)
        else:
            segs.append((k, 1))
    return segs


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family != "decoder" or cfg.num_meta_tokens or any(
            k not in ("dense", "moe") for k in layer_kinds(cfg)):
        raise NotImplementedError(f"{cfg.name}: {LATER_SLICE}")


def _embed(params, tokens, dtype):
    return params["embed"][tokens].to(dtype)


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ArchConfig, kind: str, dtype, device):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    p = {"ln1": zeros(),
         "attn": attn_mod.init_attention(gen, cfg, dtype, device),
         "ln2": zeros()}
    if kind == "moe":
        p["moe"] = init_moe(gen, d, cfg.moe, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def _ffn(p, x, cfg: ArchConfig, **moe_kw):
    """The layer's MLP or MoE on the normed residual: (y, aux)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return moe_forward(p["moe"], h, cfg.moe, **moe_kw)
    return mlp_forward(p["mlp"], h), None


def _apply_layer(p, x, positions, cfg: ArchConfig, window, attn_impl):
    """Full-sequence layer: (x, aux or None)."""
    x = x + attn_mod.attn_forward(p["attn"], rms_norm(x, p["ln1"],
                                                      cfg.norm_eps),
                                  positions, cfg, window, impl=attn_impl)
    y, aux = _ffn(p, x, cfg)
    return x + y, aux


def _decode_layer(p, cache, x, pos, cfg: ArchConfig, window, attn_impl,
                  tables, page_size):
    y, _ = attn_mod.attn_decode(p["attn"], cache,
                                rms_norm(x, p["ln1"], cfg.norm_eps), pos, cfg,
                                window, impl=attn_impl, tables=tables,
                                page_size=page_size)
    x = x + y
    # full capacity: decode routing is drop-free, so each slot's output is
    # independent of what the other slots are decoding
    y, _ = _ffn(p, x, cfg, full_capacity=True)
    return x + y


def _prefill_layer(p, cache, x, positions, pos0, valid_flat, cfg: ArchConfig,
                   window, attn_impl, tables, page_size):
    y, _ = attn_mod.attn_prefill(p["attn"], cache,
                                 rms_norm(x, p["ln1"], cfg.norm_eps),
                                 positions, pos0, cfg, window,
                                 impl=attn_impl, tables=tables,
                                 page_size=page_size)
    x = x + y
    y, _ = _ffn(p, x, cfg, full_capacity=True, valid=valid_flat)
    return x + y


def _layer_caches(caches, cfg: ArchConfig):
    """Per-layer views ({"k", "v"} or MLA's {"ckv", "kr"}) into the stacked
    segment caches (writes through them land in the pool)."""
    out = []
    for seg_idx, (_, count) in enumerate(segments(cfg)):
        c = caches[seg_idx]["attn"]
        out += [{n: t[j] for n, t in c.items()} for j in range(count)]
    return out


def _head(params, h, cfg: ArchConfig, dtype):
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h, params["embed"].to(dtype))
    return torch.einsum("bsd,dv->bsv", h, params["head"].to(dtype))


# ---------------------------------------------------------------------------
# model init / forward
# ---------------------------------------------------------------------------

def init_decoder(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Master parameters (``param_dtype``) from ``gen``, on ``device``."""
    _check_ported(cfg)
    dtype = dtype_of(cfg.param_dtype)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, (cfg.vocab_size,),
                                    dtype, device)
    params["layers"] = [_init_layer(gen, cfg, kind, dtype, device)
                        for kind in layer_kinds(cfg)]
    return params


def decoder_forward(params, batch, cfg: ArchConfig):
    """batch {tokens (B, S)} -> (logits (B, S, V), aux): aux is the MoE
    layers' summed load-balance loss (fp32; 0 without MoE).
    Image-embedding inputs (the VLM stub frontend) are not ported."""
    _check_ported(cfg)
    if "image_embeds" in batch:
        raise NotImplementedError("image_embeds inputs are not ported")
    dtype = dtype_of(cfg.dtype)
    h = _embed(params, batch["tokens"], dtype)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    wins = layer_windows(cfg, "train", S)
    attn_impl = attn_mod.resolve_attn_impl(cfg.attention)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp, win in zip(params["layers"], wins):
        if remat:
            h, aux = checkpoint(_apply_layer, lp, h, positions, cfg, win,
                                attn_impl, use_reentrant=False)
        else:
            h, aux = _apply_layer(lp, h, positions, cfg, win, attn_impl)
        if aux is not None:
            aux_total = aux_total + aux
    return _head(params, h, cfg, dtype), aux_total


def decoder_loss(params, batch, cfg: ArchConfig):
    """Mean next-token cross-entropy over the positions with ``labels >=
    0``, plus the MoE layers' load-balance loss (0 without MoE). Returns
    (loss + aux, {"loss", "aux"})."""
    logits, aux = decoder_forward(params, batch, cfg)
    labels = batch["labels"]
    loss = softmax_xent(logits, labels.clamp_min(0), labels >= 0)
    return loss + aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# caches, decode, prefill
# ---------------------------------------------------------------------------

def init_decoder_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Contiguous cache: per segment {"attn": {"k", "v"}} of (count, batch,
    max_len, KV, hd) (MLA: {"ckv", "kr"} of (count, batch, max_len, R /
    rope))."""
    _check_ported(cfg)
    dtype = dtype_of(cfg.dtype)
    return [{"attn": _stacked_cache(count, batch, max_len, cfg, dtype, device)}
            for _, count in segments(cfg)]


def _stacked_cache(count: int, rows: int, length: int, cfg: ArchConfig,
                   dtype, device):
    """The attention cache leaves of (count, rows, length, ...) zeros."""
    one = attn_mod.attn_init_cache(count * rows, length, cfg, dtype, device)
    return {n: t.reshape(count, rows, *t.shape[1:]) for n, t in one.items()}


def init_paged_decoder_cache(cfg: ArchConfig, max_slots: int, page_size: int,
                             num_pages: int, device=None):
    """Paged pool: per segment {"attn": {"k", "v"}} of (count, num_pages,
    page_size, KV, hd) (MLA: {"ckv", "kr"} of (count, num_pages,
    page_size, R / rope)) physical pages shared through block tables."""
    del max_slots           # attention leaves are page-granular, not slotted
    _check_ported(cfg)
    dtype = dtype_of(cfg.dtype)
    return [{"attn": _stacked_cache(count, num_pages, page_size, cfg, dtype,
                                    device)}
            for _, count in segments(cfg)]


def decoder_decode_step(params, caches, tokens, pos, cfg: ArchConfig, *,
                        seq_len: int, block_tables=None, page_size: int = 0):
    """One decode step. tokens (B, 1); pos an int or (B,) per-slot cache
    indices; ``block_tables`` (B, NP) int32 routes the attention caches
    through the paged layout. Writes the caches in place. Returns (logits
    (B, 1, V), caches)."""
    _check_ported(cfg)
    dtype = dtype_of(cfg.dtype)
    h = _embed(params, tokens, dtype)
    wins = layer_windows(cfg, "decode", seq_len)
    attn_impl = attn_mod.resolve_attn_impl(cfg.attention)
    for lp, lc, win in zip(params["layers"], _layer_caches(caches, cfg), wins):
        h = _decode_layer(lp, lc, h, pos, cfg, win, attn_impl, block_tables,
                          page_size)
    return _head(params, h, cfg, dtype), caches


def decoder_prefill(params, caches, tokens, pos0: int, valid: int,
                    cfg: ArchConfig, *, seq_len: int, block_tables=None,
                    page_size: int = 0):
    """Chunked prompt prefill: one pass over a (B, C) token chunk starting
    at cache position ``pos0`` that computes logits for every chunk
    position and writes every layer's cache in place. ``valid`` (<= C)
    counts the real leading tokens: the pad tail is kept out of MoE
    routing (dense layers need no masking of it: its rows sit past the
    live sequence, hidden by causality). Returns (logits (B, C, V),
    caches)."""
    _check_ported(cfg)
    dtype = dtype_of(cfg.dtype)
    B, C = tokens.shape
    h = _embed(params, tokens, dtype)
    positions = (int(pos0) + torch.arange(C, device=h.device)).expand(B, C)
    valid_flat = (torch.arange(C, device=h.device) < int(valid)).expand(
        B, C).reshape(-1)
    wins = layer_windows(cfg, "decode", seq_len)
    attn_impl = attn_mod.resolve_attn_impl(cfg.attention)
    for lp, lc, win in zip(params["layers"], _layer_caches(caches, cfg), wins):
        h = _prefill_layer(lp, lc, h, positions, pos0, valid_flat, cfg, win,
                           attn_impl, block_tables, page_size)
    return _head(params, h, cfg, dtype), caches
