"""Encoder-decoder transformer, the SeamlessM4T backbone (counterpart of
``repro/models/encdec.py``).

The encoder takes precomputed frontend frame embeddings (``frames`` (B,
T_src, d): the audio frontend is a stub, as in the reference); the
decoder is a causal token decoder with cross attention to the encoder's
output. Parameters are a dict: ``embed`` (V, d), ``head`` (d, V),
``ln_enc``/``ln_dec`` (d,) and the per-layer lists ``enc`` ({ln1, attn,
ln2, mlp}) and ``dec`` ({ln1, self_attn, ln_x, cross_attn, ln2, mlp});
the JAX package stacks each list along a leading layer axis, and
``repro_torch.bridge.encdec_params_from_jax`` unstacks them.

Attention: the decoder's causal self-attention goes through
``gqa_forward`` (training) and ``gqa_decode`` (serving), so it runs the
flash kernels (``flash_attention`` and its backward, ``flash_decode`` and
its combine) on the card and their plain versions on the CPU. The
encoder's bidirectional self-attention and every cross attention are the
reference's einsums (``gqa_attend``: plain matmuls and the masked
softmax), on the card too: no kernel of the reference is on them.

The reference constrains each layer's output with ``act.constrain``, an
identity on a data mesh, the only mesh the port has: the port drops it.
With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
(non-reentrant), as the decoders' do.

Decode caches: ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each leaf
(layers, B, length, KV, hd) in the compute dtype; ``prefill_encoder``
runs the encoder once and writes every layer's cross K/V, and
``encdec_decode_step`` writes the new self-attention row. Both write the
cache in place and return it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       embed_init, rms_norm, softmax_xent)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models import tp


def _zeros(cfg: ArchConfig, device):
    return torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)


def _init_enc_layer(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": _zeros(cfg, device),
        "attn": attn_mod.init_gqa(gen, cfg, cfg.attention, dtype, device),
        "ln2": _zeros(cfg, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _init_dec_layer(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": _zeros(cfg, device),
        "self_attn": attn_mod.init_gqa(gen, cfg, cfg.attention, dtype,
                                       device),
        "ln_x": _zeros(cfg, device),
        "cross_attn": attn_mod.init_gqa(gen, cfg, cfg.attention, dtype,
                                        device),
        "ln2": _zeros(cfg, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Master parameters (``param_dtype``; norms fp32) from ``gen``, on
    ``device``."""
    dtype = dtype_of(cfg.param_dtype)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "head": dense_init(gen, cfg.d_model, (cfg.vocab_size,), dtype,
                           device),
        "ln_enc": _zeros(cfg, device),
        "ln_dec": _zeros(cfg, device),
        "enc": [_init_enc_layer(gen, cfg, dtype, device)
                for _ in range(cfg.num_encoder_layers)],
        "dec": [_init_dec_layer(gen, cfg, dtype, device)
                for _ in range(cfg.num_layers)],
    }


def _all_keep(sq: int, sk: int, device):
    return torch.ones((sq, sk), dtype=torch.bool, device=device)


def _bidir_attend(p, x, positions, cfg: ArchConfig):
    """Encoder self-attention: RoPE on q and k, no mask."""
    a = cfg.attention
    q, k, v = attn_mod._project_qkv(p, x, a)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    B, S = x.shape[:2]
    out = attn_mod._attend_heads(q, k, v, _all_keep(S, S, x.device), a)
    return attn_mod._out_proj(p, out, B, S)


def _cross_attend(p, x, enc_out, cfg: ArchConfig):
    """Decoder queries over the encoder's output: no RoPE, no mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    B, S = x.shape[:2]
    keep = _all_keep(S, enc_out.shape[1], x.device)
    out = attn_mod._attend_heads(q, k, v, keep, cfg.attention)
    return attn_mod._out_proj(p, out, B, S)


def _enc_layer(lp, x, positions, cfg: ArchConfig):
    eps = cfg.norm_eps
    x = x + _bidir_attend(lp["attn"], rms_norm(x, lp["ln1"], eps), positions,
                          cfg)
    return x + mlp_forward(lp["mlp"], rms_norm(x, lp["ln2"], eps))


def _dec_layer(lp, x, enc_out, positions, cfg: ArchConfig, impl: str):
    eps = cfg.norm_eps
    x = x + attn_mod.gqa_forward(lp["self_attn"], rms_norm(x, lp["ln1"], eps),
                                 positions, cfg.attention, 0, impl=impl)
    x = x + _cross_attend(lp["cross_attn"], rms_norm(x, lp["ln_x"], eps),
                          enc_out, cfg)
    return x + mlp_forward(lp["mlp"], rms_norm(x, lp["ln2"], eps))


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def _call(layer, remat: bool, *args):
    """One layer, under ``checkpoint`` when ``remat``."""
    if remat:
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def encode(params, frames, cfg: ArchConfig):
    """frames (B, T_src, d) stub embeddings -> the encoder's output (B,
    T_src, d) in the compute dtype."""
    h = frames.to(dtype_of(cfg.dtype))
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc"]:
        h = act.constrain(_call(_enc_layer, remat, lp, h, positions, cfg))
    return rms_norm(h, params["ln_enc"], cfg.norm_eps)


def decode_train(params, tokens, enc_out, cfg: ArchConfig):
    """Teacher-forced decoder over tokens (B, S) against ``enc_out`` ->
    logits (B, S, V)."""
    dtype = dtype_of(cfg.dtype)
    # F.embedding, as transformer._embed: bitwise under a counted call
    h = tp.embedding(tokens, params["embed"]).to(dtype)
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)
    # resolved once, as decoder_forward does
    impl = attn_mod.resolve_attn_impl(cfg.attention)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["dec"]:
        h = act.constrain(_call(_dec_layer, remat, lp, h, enc_out,
                                positions, cfg, impl))
    h = rms_norm(h, params["ln_dec"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, params["head"].to(dtype))


def encdec_loss(params, batch, cfg: ArchConfig):
    """Mean next-token cross-entropy of the decoder over the positions
    with ``labels >= 0``, on batch {frames, tokens, labels}. Returns (loss,
    {"loss", "aux"}) with aux 0 (no MoE)."""
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    labels = batch["labels"]
    loss = softmax_xent(logits, labels.clamp_min(0), labels >= 0)
    return loss, {"loss": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None):
    """Zeros: the self-attention cache (layers, batch, max_len, KV, hd)
    and the cross K/V (layers, batch, encoder_seq_len, KV, hd), which
    ``prefill_encoder`` fills."""
    dtype = dtype_of(cfg.dtype)
    a = cfg.attention
    L = cfg.num_layers

    def zeros(length):
        return torch.zeros((L, batch, length, a.num_kv_heads, a.head_dim),
                           dtype=dtype, device=device)
    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(cfg.encoder_seq_len),
                      "v": zeros(cfg.encoder_seq_len)}}


def prefill_encoder(params, frames, cfg: ArchConfig, cache):
    """Run the encoder once and write each decoder layer's cross K/V into
    ``cache`` in place. Returns the cache."""
    enc_out = encode(params, frames, cfg)
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    for j, lp in enumerate(params["dec"]):
        p = lp["cross_attn"]
        ck[j] = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]).to(ck.dtype)
        cv[j] = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"]).to(cv.dtype)
    return cache


def encdec_decode_step(params, cache, tokens, pos, cfg: ArchConfig, *,
                       seq_len: int):
    """One decoder token. tokens (B, 1); pos an int or (B,) cache indices.
    Above 100,000 positions the self-attention slides over
    ``cfg.long_context_window`` keys. Writes the self-attention rows in
    place. Returns (logits (B, 1, V), cache)."""
    dtype = dtype_of(cfg.dtype)
    a = cfg.attention
    eps = cfg.norm_eps
    h = tp.embedding(tokens, params["embed"]).to(dtype)
    window = cfg.long_context_window if seq_len > 100_000 else 0
    impl = attn_mod.resolve_attn_impl(a)
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    B = h.shape[0]
    for j, lp in enumerate(params["dec"]):
        y, _ = attn_mod.gqa_decode(lp["self_attn"], {"k": sk[j], "v": sv[j]},
                                   rms_norm(h, lp["ln1"], eps), pos, a,
                                   window, impl=impl)
        h = h + y
        p = lp["cross_attn"]
        q = torch.einsum("bsd,dhk->bshk", rms_norm(h, lp["ln_x"], eps),
                         p["wq"])
        out = attn_mod._attend_heads(q, ck[j], cv[j],
                                     _all_keep(1, ck.shape[2], h.device), a)
        h = h + attn_mod._out_proj(p, out, B, 1)
        h = h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln2"], eps))
    h = rms_norm(h, params["ln_dec"], eps)
    return torch.einsum("bsd,dv->bsv", h, params["head"].to(dtype)), cache
