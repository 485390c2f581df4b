"""Decoder-only LM executor: dense, MoE, SSM and hybrid layers
(counterpart of ``repro/models/transformer.py``).

Parameters are a dict: ``embed`` (V, d), ``ln_f`` (d,), ``head`` (d, V)
unless embeddings are tied, ``meta`` (num_meta_tokens, d) for Hymba, and
``layers`` — one dict per layer (the JAX package's ``blocks[seg]`` stacks
unstacked; ``repro_torch.bridge`` converts). The JAX ``lax.scan`` over
stacked layers is a Python loop over layers here. Caches keep the JAX
structure: one entry per segment of consecutive same-kind layers,
``{"attn": {"k", "v"}}`` (MLA: ``{"ckv", "kr"}``, the latent and the rope
key) and/or ``{"ssm": {"conv", "state"}}`` with a leading layer axis, so
a paged pool's attention leaf is ``(layers, P, page_size, KV, hd)``
(MLA: ``(layers, P, page_size, R)``) while its SSM lanes stay one per
slot, ``(layers, max_slots, ...)``. Decode and prefill write the caches
in place and return them.

Training runs ``decoder_loss`` under autograd. With ``cfg.remat`` each
layer runs under ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of the JAX package's ``jax.checkpoint(body)``: only the
layer inputs are kept, and the backward recomputes each layer's forward
(the flash forward kernel launches twice per layer and step).

Layer kinds:

- ``dense`` (attention + MLP) and ``moe`` (attention + the MoE layer of
  ``models/moe.py``; DeepSeek-V2's first ``first_k_dense`` layers are
  dense). Training routes with the capped capacity and adds the layers'
  load-balance loss to the loss; decode and prefill route with full
  capacity (no drops, so a slot's tokens never depend on what the other
  slots hold), and prefill keeps the pad tail out of the routing.
- ``ssm`` (Mamba-2's SSD block of ``models/ssm.py`` alone) and
  ``hybrid`` (Hymba: attention and SSD on the same normed input, fused
  as ``0.5 * (rms_norm(attn) + rms_norm(ssm))``, then the MLP when
  ``d_ff``). Prefill keeps the pad tail out of the SSM state.

The forward puts early-fusion image embeddings (``batch["image_embeds"]``
of a ``vlm`` config, the stub frontend) before the tokens, and Hymba's
meta tokens before both, with positions over the whole prefix; the
logits cover the token positions alone. The serve paths (decode,
prefill) embed the tokens alone, as the reference's do: a served Hymba
runs without its meta prefix. The ``encdec`` family has its own
executor, ``models/encdec.py``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (dtype_of, embed_init, dense_init,
                                       rms_norm, softmax_xent)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models import tp

# the MoE and SSM calls as the model axis runs them (``models/tp.py``); on
# plain tensors each calls the function itself
_moe_tp = tp.experts_local(moe_forward, mlp_forward)
_ssm_tp = tp.ssm_local(ssm_mod.ssm_forward)
_ssm_decode_tp = tp.ssm_local(ssm_mod.ssm_decode, with_cache=True)

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


def _embed(params, tokens, dtype):
    # F.embedding, not indexing: under a dispatch mode (a counted call,
    # telemetry.profile) an indexing backward adds in another order on
    # the CPU, F.embedding's does not, so a counted step stays bit for bit
    return tp.embedding(tokens, params["embed"]).to(dtype)


def _has_images(batch, cfg: ArchConfig) -> bool:
    return cfg.modality == "vlm" and "image_embeds" in batch


def _embed_inputs(params, batch, cfg: ArchConfig, dtype):
    """One sequence of Hymba's meta tokens, then a VLM's image embeddings
    (early fusion), then the token embeddings. Returns (h, the length of
    the prefix before the tokens)."""
    h = _embed(params, batch["tokens"], dtype)
    parts = [h]
    if _has_images(batch, cfg):
        parts.insert(0, batch["image_embeds"].to(dtype))  # (B, n_img, d)
    if cfg.num_meta_tokens:
        parts.insert(0, params["meta"].to(dtype)[None].expand(
            h.shape[0], cfg.num_meta_tokens, cfg.d_model))
    n_prefix = sum(t.shape[1] for t in parts[:-1])
    return (torch.cat(parts, dim=1) if n_prefix else h), n_prefix


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ArchConfig, kind: str, dtype, device):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    p = {"ln1": zeros()}
    if kind in ("dense", "moe", "hybrid"):
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype, device)
    if kind in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.init_ssm(gen, d, cfg.ssm, dtype, device)
    if kind == "hybrid":
        p["fuse_na"], p["fuse_ns"] = zeros(), zeros()
    if kind == "moe":
        p["ln2"], p["moe"] = zeros(), init_moe(gen, d, cfg.moe, dtype, device)
    elif kind == "dense" or (kind == "hybrid" and cfg.d_ff):
        p["ln2"] = zeros()
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def _ffn(p, x, cfg: ArchConfig, **moe_kw):
    """x plus the layer's MLP or MoE on the normed residual (x itself when
    the layer has neither): (x, aux or None)."""
    if "ln2" not in p:
        return x, None
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = _moe_tp(p["moe"], h, cfg.moe, **moe_kw)
        return x + y, aux
    return x + mlp_forward(p["mlp"], h), None


def _mix(p, kind: str, eps: float, attn_fn, ssm_fn):
    """The layer's token mixer from its attention and SSM calls: one of
    them, or Hymba's fusion of both."""
    if kind == "ssm":
        return ssm_fn()
    if kind != "hybrid":
        return attn_fn()
    ya, ys = attn_fn(), ssm_fn()
    return 0.5 * (rms_norm(ya, p["fuse_na"], eps)
                  + rms_norm(ys, p["fuse_ns"], eps))


def _apply_layer(p, x, positions, cfg: ArchConfig, kind: str, window,
                 attn_impl, gather=None):
    """Full-sequence layer: (x, aux or None). ``gather`` (sharded
    training) turns the layer's parameter shards into its parameters
    first, inside the remat region."""
    if gather is not None:
        p = gather(p)
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    x = x + _mix(p, kind, eps,
                 lambda: attn_mod.attn_forward(p["attn"], h, positions, cfg,
                                               window, impl=attn_impl),
                 lambda: _ssm_tp(p["ssm"], h, cfg.d_model, cfg.ssm, eps))
    return _ffn(p, x, cfg)


def _decode_layer(p, cache, x, pos, cfg: ArchConfig, kind: str, window,
                  attn_impl, tables, page_size):
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    x = x + _mix(p, kind, eps,
                 lambda: attn_mod.attn_decode(
                     p["attn"], cache["attn"], h, pos, cfg, window,
                     impl=attn_impl, tables=tables, page_size=page_size)[0],
                 lambda: _ssm_decode_tp(p["ssm"], cache["ssm"], h,
                                        cfg.d_model, cfg.ssm, eps)[0])
    # full capacity: decode routing is drop-free, so each slot's output is
    # independent of what the other slots are decoding
    return _ffn(p, x, cfg, full_capacity=True)[0]


def _prefill_layer(p, cache, x, positions, pos0, valid: int, valid_flat,
                   cfg: ArchConfig, kind: str, window, attn_impl, tables,
                   page_size):
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    x = x + _mix(p, kind, eps,
                 lambda: attn_mod.attn_prefill(
                     p["attn"], cache["attn"], h, positions, pos0, cfg,
                     window, impl=attn_impl, tables=tables,
                     page_size=page_size)[0],
                 lambda: ssm_mod.ssm_prefill(p["ssm"], cache["ssm"], h, valid,
                                             cfg.d_model, cfg.ssm, eps)[0])
    return _ffn(p, x, cfg, full_capacity=True, valid=valid_flat)[0]


def _layer_caches(caches, cfg: ArchConfig):
    """Per-layer views ({"attn": {"k", "v"} or MLA's {"ckv", "kr"}, "ssm":
    {"conv", "state"}}, as the layer's kind has them) into the stacked
    segment caches (writes through them land in the pool)."""
    out = []
    for seg_idx, (_, count) in enumerate(segments(cfg)):
        seg = caches[seg_idx]
        out += [{grp: {n: t[j] for n, t in leaves.items()}
                 for grp, leaves in seg.items()} for j in range(count)]
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
    dtype = dtype_of(cfg.param_dtype)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, (cfg.vocab_size,),
                                    dtype, device)
    if cfg.num_meta_tokens:
        meta = torch.empty((cfg.num_meta_tokens, cfg.d_model),
                           dtype=torch.float32, device=device)
        params["meta"] = meta.normal_(0.0, 0.02, generator=gen).to(dtype)
    params["layers"] = [_init_layer(gen, cfg, kind, dtype, device)
                        for kind in layer_kinds(cfg)]
    return params


def decoder_forward(params, batch, cfg: ArchConfig, gather=None):
    """batch {tokens (B, S) [, image_embeds (B, Ni, d) of a vlm config]}
    -> (logits (B, S, V), aux): aux is the MoE layers' summed load-balance
    loss (fp32; 0 without MoE). The logits cover the token positions
    alone (the meta and image prefixes are stripped).

    ``gather`` (``core/gspmd.py``): ``params`` hold parameter shards, and
    ``gather(subtree)`` returns the parameters of a subtree: called on an
    untied ``head`` alone, on the other top-level leaves, and once a layer
    inside its (remat) body (two vocab-sized leaves in one gather would
    double its backward's buffers)."""
    if gather is not None:
        shards = params
        params = dict(gather({n: v for n, v in shards.items()
                              if n not in ("layers", "head")}),
                      layers=shards["layers"])
        if "head" in shards:
            params.update(gather({"head": shards["head"]}))
    dtype = dtype_of(cfg.dtype)
    h, n_prefix = _embed_inputs(params, batch, cfg, dtype)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    wins = layer_windows(cfg, "train", S)
    attn_impl = attn_mod.resolve_attn_impl(cfg.attention)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp, kind, win in zip(params["layers"], layer_kinds(cfg), wins):
        if remat:
            h, aux = checkpoint(_apply_layer, lp, h, positions, cfg, kind,
                                win, attn_impl, gather, use_reentrant=False)
        else:
            h, aux = _apply_layer(lp, h, positions, cfg, kind, win,
                                  attn_impl, gather)
        h = act.constrain(h)
        if aux is not None:
            aux_total = aux_total + aux
    # the final norm is per position, so stripping before it is the same
    return _head(params, h[:, n_prefix:], cfg, dtype), aux_total


def decoder_loss(params, batch, cfg: ArchConfig, gather=None):
    """Mean next-token cross-entropy over the positions with ``labels >=
    0``, plus the MoE layers' load-balance loss (0 without MoE). Returns
    (loss + aux, {"loss", "aux"}). ``gather``: see ``decoder_forward``."""
    logits, aux = decoder_forward(params, batch, cfg, gather)
    labels = batch["labels"]
    loss = softmax_xent(logits, labels.clamp_min(0), labels >= 0)
    return loss + aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# caches, decode, prefill
# ---------------------------------------------------------------------------

def init_decoder_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Contiguous cache: per segment {"attn": {"k", "v"}} of (count, batch,
    L, KV, hd) (MLA: {"ckv", "kr"} of (count, batch, L, R / rope)) and
    {"ssm": {"conv", "state"}} of (count, batch, ...), as the segment's
    kind has them. L is ``max_len`` plus the meta and image rows, as in the
    reference (the serve paths write neither)."""
    total = max_len + cfg.num_meta_tokens + (
        cfg.num_image_tokens if cfg.modality == "vlm" else 0)
    return _segment_caches(cfg, batch, total, batch, device)


def init_paged_decoder_cache(cfg: ArchConfig, max_slots: int, page_size: int,
                             num_pages: int, device=None):
    """Paged pool: per segment {"attn": {"k", "v"}} of (count, num_pages,
    page_size, KV, hd) (MLA: {"ckv", "kr"} of (count, num_pages,
    page_size, R / rope)) physical pages shared through block tables, and
    {"ssm": {"conv", "state"}} of (count, max_slots, ...): one lane a slot,
    since they have no sequence axis to page. No meta/image rows: the
    serve paths write no prefix, and pages are allocated by demand."""
    return _segment_caches(cfg, num_pages, page_size, max_slots, device)


def _segment_caches(cfg: ArchConfig, rows: int, length: int, lanes: int,
                    device):
    """Per segment, zeros of the attention leaves (count, rows, length,
    ...) and the SSM leaves (count, lanes, ...)."""
    dtype = dtype_of(cfg.dtype)
    out = []
    for kind, count in segments(cfg):
        seg = {}
        if kind in ("dense", "moe", "hybrid"):
            one = attn_mod.attn_init_cache(count * rows, length, cfg, dtype,
                                           device)
            seg["attn"] = {n: t.reshape(count, rows, *t.shape[1:])
                           for n, t in one.items()}
        if kind in ("ssm", "hybrid"):
            one = ssm_mod.ssm_init_cache(count * lanes, cfg.d_model, cfg.ssm,
                                         dtype, device)
            seg["ssm"] = {n: t.reshape(count, lanes, *t.shape[1:])
                          for n, t in one.items()}
        out.append(seg)
    return out


def decoder_decode_step(params, caches, tokens, pos, cfg: ArchConfig, *,
                        seq_len: int, block_tables=None, page_size: int = 0):
    """One decode step. tokens (B, 1); pos an int or (B,) per-slot cache
    indices; ``block_tables`` (B, NP) int32 routes the attention caches
    through the paged layout. Writes the caches in place. Returns (logits
    (B, 1, V), caches)."""
    dtype = dtype_of(cfg.dtype)
    h = _embed(params, tokens, dtype)
    wins = layer_windows(cfg, "decode", seq_len)
    attn_impl = attn_mod.resolve_attn_impl(cfg.attention)
    for lp, lc, kind, win in zip(params["layers"], _layer_caches(caches, cfg),
                                 layer_kinds(cfg), wins):
        h = _decode_layer(lp, lc, h, pos, cfg, kind, win, attn_impl,
                          block_tables, page_size)
    return _head(params, h, cfg, dtype), caches


def decoder_prefill(params, caches, tokens, pos0: int, valid: int,
                    cfg: ArchConfig, *, seq_len: int, block_tables=None,
                    page_size: int = 0):
    """Chunked prompt prefill: one pass over a (B, C) token chunk starting
    at cache position ``pos0`` that computes logits for every chunk
    position and writes every layer's cache in place. ``valid`` (<= C)
    counts the real leading tokens: the pad tail is kept out of MoE
    routing and out of the SSM state and conv window (attention needs no
    masking of it: its rows sit past the live sequence, hidden by
    causality). Tokens alone are embedded (no meta or image prefix, as in
    the reference). Returns (logits (B, C, V), caches)."""
    dtype = dtype_of(cfg.dtype)
    B, C = tokens.shape
    h = _embed(params, tokens, dtype)
    positions = (int(pos0) + torch.arange(C, device=h.device)).expand(B, C)
    valid_flat = (torch.arange(C, device=h.device) < int(valid)).expand(
        B, C).reshape(-1)
    wins = layer_windows(cfg, "decode", seq_len)
    attn_impl = attn_mod.resolve_attn_impl(cfg.attention)
    for lp, lc, kind, win in zip(params["layers"], _layer_caches(caches, cfg),
                                 layer_kinds(cfg), wins):
        h = act.constrain(_prefill_layer(
            lp, lc, h, positions, pos0, int(valid), valid_flat, cfg, kind,
            win, attn_impl, block_tables, page_size))
    return _head(params, h, cfg, dtype), caches
