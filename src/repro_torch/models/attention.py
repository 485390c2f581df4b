"""Attention: ``repro/models/attention.py`` — GQA (+QKV bias, qk-norm,
sliding window) and DeepSeek-V2's MLA (multi-head latent attention).

Two interchangeable implementations back every path
(:func:`resolve_attn_impl`):

- ``flash``: the hand-written kernels of ``repro_torch.kernels
  .flash_attention`` — ``flash_attention`` with a per-row ``q_off`` for
  prefill over the cache lane, ``flash_decode`` / ``flash_decode_paged``
  for one-token decode. On CPU tensors each wrapper runs its plain
  version. The default (``auto``).
- ``ref``: the einsum paths below — the oracles ``flash`` is held to.

The JAX package's ``blockwise`` scan is not ported.

MLA caches the 512-value latent ``ckv`` and the shared 64-value rope key
``kr`` of each token (576 values a token). Its training forward with
``flash`` attends in the absorbed layout: W_uk folded into the query, so
the keys are (latent | rope key), the values the latent itself, one KV
head under all H query heads (Dk 576, Dv 512 at full width) — the
kernels' MLA route. ``ref`` keeps the naive per-head expansion as the
oracle. Decode and prefill are absorbed einsums over the latent for
either implementation, as in the JAX package (no flash variant there).

Caches update in place: the decode and prefill functions write the new
K/V (or latent / rope-key) rows into the cache tensors they are given
and return the same dict.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.configs.base import ArchConfig, AttentionConfig
from repro_torch.kernels.flash_attention import (flash_attention, flash_decode,
                                                 flash_decode_paged)
# (B, NP*page_size, ...) virtual contiguous lanes gathered from a paged
# buffer through (B, NP) tables: the einsum path's read of a paged cache
from repro_torch.kernels.ref import gather_pages as _gather_lane
from repro_torch.models.common import apply_rope, dense_init, head_rms_norm
from repro_torch.models.tp import heads_local

NEG_INF = -1e30

_IMPLS = ("flash", "ref")


def resolve_attn_impl(a: AttentionConfig | None) -> str:
    """``REPRO_ATTN_IMPL`` env > ``a.attn_impl`` > ``flash``."""
    impl = os.environ.get("REPRO_ATTN_IMPL", "") or (
        (a.attn_impl or "") if a is not None else "")
    if impl in ("", "auto"):
        return "flash"
    if impl not in _IMPLS:
        raise ValueError(f"REPRO_ATTN_IMPL / attn_impl must be one of "
                         f"{_IMPLS} or 'auto', got {impl!r}")
    return impl


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg: ArchConfig, a: AttentionConfig, dtype, device=None):
    d = cfg.d_model
    p = {
        "wq": dense_init(gen, d, (a.num_heads, a.head_dim), dtype, device),
        "wk": dense_init(gen, d, (a.num_kv_heads, a.head_dim), dtype, device),
        "wv": dense_init(gen, d, (a.num_kv_heads, a.head_dim), dtype, device),
        "wo": dense_init(gen, a.num_heads * a.head_dim, (d,), dtype, device),
    }
    if a.qkv_bias:
        for name, n in (("bq", a.num_heads), ("bk", a.num_kv_heads),
                        ("bv", a.num_kv_heads)):
            p[name] = torch.zeros((n, a.head_dim), dtype=dtype, device=device)
    return p


def init_mla(gen, cfg: ArchConfig, a: AttentionConfig, dtype, device=None):
    d = cfg.d_model
    qd = a.qk_nope_dim + a.qk_rope_dim
    return {
        "wq": dense_init(gen, d, (a.num_heads, qd), dtype, device),
        "wdkv": dense_init(gen, d, (a.kv_lora_rank,), dtype, device),
        "wkr": dense_init(gen, d, (a.qk_rope_dim,), dtype, device),
        # up-projections from the latent
        "wuk": dense_init(gen, a.kv_lora_rank, (a.num_heads, a.qk_nope_dim),
                          dtype, device),
        "wuv": dense_init(gen, a.kv_lora_rank, (a.num_heads, a.v_head_dim),
                          dtype, device),
        "wo": dense_init(gen, a.num_heads * a.v_head_dim, (d,), dtype, device),
    }


def init_attention(gen, cfg: ArchConfig, dtype, device=None):
    a = cfg.attention
    if a.kv_lora_rank:
        return init_mla(gen, cfg, a, dtype, device)
    return init_gqa(gen, cfg, a, dtype, device)


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

def causal_window_mask(q_pos, k_pos, window: int):
    """(S_q, S_k) boolean mask. window <= 0 => plain causal."""
    keep = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        keep &= (q_pos[:, None] - k_pos[None, :]) < window
    return keep


def decode_keep_batched(k_pos, pos_vec, window: int):
    """(B, S_k) mask for one query per batch row at ``pos_vec[b]``."""
    keep = k_pos[None, :] <= pos_vec[:, None]
    if window > 0:
        keep &= (pos_vec[:, None] - k_pos[None, :]) < window
    return keep


def _decode_pos(pos, batch: int, device):
    """((B, 1) rope positions, (B,) per-example cache indices or None if
    ``pos`` is a scalar)."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    if pos.ndim == 0:
        return pos.expand(batch, 1), None
    return pos[:, None], pos


def _update_cache_rows(buf, new, pos, pos_vec):
    """Write the (B, 1, ...) ``new`` rows into ``buf`` (B, S, ...) in place
    at a shared ``pos`` or per-example ``pos_vec`` (clamped into the lane,
    as ``dynamic_update_slice`` clamps)."""
    S = buf.shape[1]
    new = new.to(buf.dtype)
    if pos_vec is None:
        p = min(max(int(pos), 0), S - 1)
        buf[:, p] = new[:, 0]
    else:
        idx = pos_vec.clamp(0, S - 1)
        buf[torch.arange(buf.shape[0], device=buf.device), idx] = new[:, 0]
    return buf


def _page_coords(pos, page_size: int, num_logical: int):
    """(logical page, in-page row) of absolute positions; pages clamp into
    the table so pad positions scatter where masking hides them."""
    return (pos // page_size).clamp(0, num_logical - 1), pos % page_size


def _scatter_page_rows(buf, new, tables, pos_vec, page_size: int):
    """Write one (B, 1, ...) row per batch element into the paged buffer
    (P, page_size, ...) through the block table (B, NP), in place. Idle
    slots map to the null page; their writes land there harmlessly."""
    B = new.shape[0]
    pj, pr = _page_coords(pos_vec, page_size, tables.shape[1])
    pid = tables[torch.arange(B, device=tables.device), pj].long()
    buf[pid, pr] = new[:, 0].to(buf.dtype)
    return buf


def _scatter_chunk_rows(buf, new, tables, positions, page_size: int):
    """Scatter a (B, C, ...) prefill chunk into the paged buffer through
    each row's block table, in place. ``positions`` (B, C) are absolute —
    any alignment; rows whose page the table maps to 0 write the null
    page (pad tails)."""
    B, C = new.shape[:2]
    pj, pr = _page_coords(positions, page_size, tables.shape[1])
    pid = torch.gather(tables.long(), 1, pj)                   # (B, C)
    flat = new.reshape((B * C,) + new.shape[2:]).to(buf.dtype)
    buf[pid.reshape(-1), pr.reshape(-1)] = flat
    return buf


def _masked_softmax(scores, keep):
    """Masked softmax: max-subtract and exp in the score dtype, the row sum
    in fp32, weights back in the score dtype."""
    scores = torch.where(keep, scores, torch.tensor(NEG_INF, dtype=scores.dtype,
                                                    device=scores.device))
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    l = e.sum(-1, keepdim=True, dtype=torch.float32)
    return e / l.to(e.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _project_qkv(p, x, a: AttentionConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _rope_qk(p, x, positions, a: AttentionConfig):
    q, k, v = _project_qkv(p, x, a)
    if a.qk_norm:
        q, k = head_rms_norm(q), head_rms_norm(k)
    return (apply_rope(q, positions, a.rope_theta),
            apply_rope(k, positions, a.rope_theta), v)


def gqa_attend(q, k, v, keep, a: AttentionConfig):
    """Einsum oracle. q (B, Sq, H, hd), k/v (B, Sk, KV, hd), keep (Sq, Sk)
    or (B, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    scale = torch.tensor(math.sqrt(hd), dtype=q.dtype, device=q.device)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k) / scale
    keep_b = keep[None, None, None] if keep.ndim == 2 else keep[:, None, None]
    w = _masked_softmax(scores, keep_b).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, Sq, H, hd)


# the attention calls as the model axis runs them per head
# (``models/tp.py``); on plain tensors each calls the function itself
_flash_heads = heads_local(flash_attention)
_decode_heads = heads_local(flash_decode)
_attend_heads = heads_local(gqa_attend)


def _out_proj(p, out, B: int, S: int):
    return torch.einsum("bsf,fd->bsd", out.reshape(B, S, -1), p["wo"])


def gqa_forward(p, x, positions, a: AttentionConfig, window: int,
                impl: str | None = None):
    """Full causal self-attention over x (B, S, d) — the prefill/train
    forward without a cache."""
    impl = impl or resolve_attn_impl(a)
    q, k, v = _rope_qk(p, x, positions, a)
    B, S = x.shape[:2]
    if impl == "flash":
        # common-offset positions: the kernel's row-index masking (q_off=0)
        # is exact because causality only depends on q_pos - k_pos
        out = _flash_heads(q, k, v, window=window)
    else:
        keep = causal_window_mask(positions[0], positions[0], window)
        out = _attend_heads(q, k, v, keep, a)
    return _out_proj(p, out, B, S)


def gqa_init_cache(batch: int, max_len: int, a: AttentionConfig, dtype,
                   device=None):
    shape = (batch, max_len, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, cache, x, pos, a: AttentionConfig, window: int,
               impl: str | None = None, tables=None, page_size: int = 0):
    """One-token decode. x (B, 1, d); pos an int or a (B,) vector of
    per-slot cache indices. ``tables`` (B, NP) int32 switches to the paged
    layout (cache leaves (P, page_size, KV, hd)). Writes the new K/V row
    into ``cache`` in place. Returns (out (B, 1, d), cache)."""
    impl = impl or resolve_attn_impl(a)
    B = x.shape[0]
    posv, pos_vec = _decode_pos(pos, B, x.device)
    q, k, v = _rope_qk(p, x, posv, a)
    ck, cv = cache["k"], cache["v"]
    if tables is not None:
        pv = posv[:, 0]
        _scatter_page_rows(ck, k, tables, pv, page_size)
        _scatter_page_rows(cv, v, tables, pv, page_size)
        if impl == "flash":
            out = flash_decode_paged(q, ck, cv, tables, pv,
                                     page_size=page_size, window=window)
        else:
            lk, lv = _gather_lane(ck, tables), _gather_lane(cv, tables)
            kpos = torch.arange(lk.shape[1], device=x.device)
            keep = decode_keep_batched(kpos, pv, window)[:, None, :]
            out = gqa_attend(q, lk, lv, keep, a)
        return _out_proj(p, out, B, 1), cache
    _update_cache_rows(ck, k, pos, pos_vec)
    _update_cache_rows(cv, v, pos, pos_vec)
    S = ck.shape[1]
    if impl == "flash":
        out = _decode_heads(q, ck, cv, posv[:, 0],
                                        window=window)
    else:
        kpos = torch.arange(S, device=x.device)
        keep = decode_keep_batched(kpos, posv[:, 0], window)[:, None, :]
        out = _attend_heads(q, ck, cv, keep, a)
    return _out_proj(p, out, B, 1), cache


def gqa_prefill(p, cache, x, positions, pos0: int, a: AttentionConfig,
                window: int, impl: str | None = None, tables=None,
                page_size: int = 0):
    """Chunked prompt prefill: attend a whole (B, C, d) chunk against the
    cache and write its K/V rows at [pos0, pos0+C) in place (through the
    block tables when ``tables`` is given — any alignment). ``positions``
    (B, C) are absolute; rows past the valid prompt write pad garbage that
    causal masking hides until decode overwrites it. Returns (out, cache)."""
    impl = impl or resolve_attn_impl(a)
    q, k, v = _rope_qk(p, x, positions, a)
    B, C = x.shape[:2]
    ck, cv = cache["k"], cache["v"]
    if tables is not None:
        _scatter_chunk_rows(ck, k, tables, positions, page_size)
        _scatter_chunk_rows(cv, v, tables, positions, page_size)
        lane_k, lane_v = _gather_lane(ck, tables), _gather_lane(cv, tables)
    else:
        S = ck.shape[1]
        start = min(max(int(pos0), 0), S - C)   # dynamic_update_slice clamp
        ck[:, start:start + C] = k.to(ck.dtype)
        cv[:, start:start + C] = v.to(cv.dtype)
        lane_k, lane_v = ck, cv
    if impl == "flash":
        out = _flash_heads(q, lane_k, lane_v,
                                           q_off=positions[:, 0],
                                           window=window)
    else:
        kpos = torch.arange(lane_k.shape[1], device=x.device)
        keep = causal_window_mask(positions[0], kpos, window)
        out = _attend_heads(q, lane_k, lane_v, keep, a)
    return _out_proj(p, out, B, C), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_scale(a: AttentionConfig, dtype):
    """1 / sqrt(nope + rope) as the JAX package's einsum paths take it:
    the root rounded to the compute dtype first."""
    root = torch.tensor(math.sqrt(a.qk_nope_dim + a.qk_rope_dim),
                        dtype=torch.float32).to(dtype)
    return 1.0 / root


def _mla_q(p, x, positions, a: AttentionConfig):
    """(q_nope (B, S, H, nope), roped q_rope (B, S, H, rope))."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q.split([a.qk_nope_dim, a.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, a.rope_theta)


def _mla_kv(p, x, positions, a: AttentionConfig):
    """(latent c_kv (B, S, R), roped shared key k_rope (B, S, rope))."""
    c_kv = torch.einsum("bsd,dr->bsr", x, p["wdkv"])
    k_rope = torch.einsum("bsd,dr->bsr", x, p["wkr"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        a.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_forward(p, x, positions, a: AttentionConfig, window: int,
                impl: str | None = None):
    """Training/prefill MLA over x (B, S, d). ``flash`` attends in the
    absorbed layout through the kernels (q_cat = (q_nope W_uk | q_rope)
    against k_cat = (c_kv | k_rope), values c_kv: KV = 1, Dk = R + rope,
    Dv = R); ``ref`` expands k_nope and v per head (the oracle)."""
    impl = impl or resolve_attn_impl(a)
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, positions, a)
    c_kv, k_rope = _mla_kv(p, x, positions, a)
    if impl == "flash":
        lat_scale = 1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
        q_cat = torch.cat([q_lat, q_rope], dim=-1)           # (B,S,H,R+rope)
        k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None]
        v_lat = c_kv[:, :, None]                             # (B,S,1,R)
        o_lat = _flash_heads(q_cat, k_cat, v_lat,
                                             window=window,
                                             sm_scale=lat_scale)
        out = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype), p["wuv"])
        return _out_proj(p, out, B, S)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wuk"])   # (B,S,H,nope)
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wuv"])        # (B,S,H,vd)
    s_nope = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope)
    keep = causal_window_mask(positions[0], positions[0], window)
    w = _masked_softmax((s_nope + s_rope) * _mla_scale(a, x.dtype),
                        keep[None, None]).to(x.dtype)
    out = torch.einsum("bhst,bthk->bshk", w, v)
    return _out_proj(p, out, B, S)


def mla_init_cache(batch: int, max_len: int, a: AttentionConfig, dtype,
                   device=None):
    return {"ckv": torch.zeros((batch, max_len, a.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, a.qk_rope_dim), dtype=dtype,
                              device=device)}


def _mla_attend(p, q_nope, q_rope, lat, ropek, keep, a: AttentionConfig,
                dtype):
    """Absorbed-matmul attention of (B, C, H, ...) queries over the
    (B, S, R) latent and (B, S, rope) key lanes, keep broadcastable to
    (B, H, C, S). Returns (B, C, d)."""
    B, C = q_nope.shape[:2]
    # absorb W_uk into the query: (B,C,H,nope) x (R,H,nope) -> (B,C,H,R)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, lat)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, ropek)
    w = _masked_softmax((s_lat + s_rope) * _mla_scale(a, dtype),
                        keep).to(dtype)
    o_lat = torch.einsum("bhst,btr->bshr", w, lat)           # (B,C,H,R)
    out = torch.einsum("bshr,rhk->bshk", o_lat, p["wuv"])
    return _out_proj(p, out, B, C)


def mla_decode(p, cache, x, pos, a: AttentionConfig, window: int,
               tables=None, page_size: int = 0):
    """Absorbed-matmul MLA decode in the latent space. x (B, 1, d); pos
    an int or a (B,) vector; ``tables`` switches to paged latent / rope-key
    caches ((P, page_size, R) / (P, page_size, rope)): the new rows
    scatter through the block table and attention reads the gathered
    lanes. Writes the cache in place. Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    posv, pos_vec = _decode_pos(pos, B, x.device)
    q_nope, q_rope = _mla_q(p, x, posv, a)
    c_new, kr_new = _mla_kv(p, x, posv, a)
    ckv, kr = cache["ckv"], cache["kr"]
    if tables is not None:
        pv = posv[:, 0]
        _scatter_page_rows(ckv, c_new, tables, pv, page_size)
        _scatter_page_rows(kr, kr_new, tables, pv, page_size)
        lat, ropek = _gather_lane(ckv, tables), _gather_lane(kr, tables)
    else:
        _update_cache_rows(ckv, c_new, pos, pos_vec)
        _update_cache_rows(kr, kr_new, pos, pos_vec)
        lat, ropek = ckv, kr
    kpos = torch.arange(lat.shape[1], device=x.device)
    keep = decode_keep_batched(kpos, posv[:, 0], window)[:, None, None, :]
    return _mla_attend(p, q_nope, q_rope, lat, ropek, keep, a,
                       x.dtype), cache


def mla_prefill(p, cache, x, positions, pos0: int, a: AttentionConfig,
                window: int, tables=None, page_size: int = 0):
    """Chunked MLA prefill: the decode's absorbed attention for C query
    rows, writing the latent and rope-key rows at [pos0, pos0+C) in place
    (through the block tables when ``tables`` is given — any alignment).
    Returns (out (B, C, d), cache)."""
    B, C = x.shape[:2]
    q_nope, q_rope = _mla_q(p, x, positions, a)
    c_new, kr_new = _mla_kv(p, x, positions, a)
    ckv, kr = cache["ckv"], cache["kr"]
    if tables is not None:
        _scatter_chunk_rows(ckv, c_new, tables, positions, page_size)
        _scatter_chunk_rows(kr, kr_new, tables, positions, page_size)
        lat, ropek = _gather_lane(ckv, tables), _gather_lane(kr, tables)
    else:
        S = ckv.shape[1]
        start = min(max(int(pos0), 0), S - C)   # dynamic_update_slice clamp
        ckv[:, start:start + C] = c_new.to(ckv.dtype)
        kr[:, start:start + C] = kr_new.to(kr.dtype)
        lat, ropek = ckv, kr
    kpos = torch.arange(lat.shape[1], device=x.device)
    keep = causal_window_mask(positions[0], kpos, window)[None, None]
    return _mla_attend(p, q_nope, q_rope, lat, ropek, keep, a,
                       x.dtype), cache


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def attn_forward(p, x, positions, cfg: ArchConfig, window: int,
                 impl: str | None = None):
    a = cfg.attention
    if a.kv_lora_rank:
        return mla_forward(p, x, positions, a, window, impl=impl)
    return gqa_forward(p, x, positions, a, window, impl=impl)


def attn_init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype,
                    device=None):
    a = cfg.attention
    if a.kv_lora_rank:
        return mla_init_cache(batch, max_len, a, dtype, device)
    return gqa_init_cache(batch, max_len, a, dtype, device)


def attn_decode(p, cache, x, pos, cfg: ArchConfig, window: int,
                impl: str | None = None, tables=None, page_size: int = 0):
    a = cfg.attention
    if a.kv_lora_rank:
        # the absorbed einsum over the 576-value latent rows is the MLA
        # decode for either implementation, as in the JAX package
        return mla_decode(p, cache, x, pos, a, window, tables=tables,
                          page_size=page_size)
    return gqa_decode(p, cache, x, pos, a, window, impl=impl,
                      tables=tables, page_size=page_size)


def attn_prefill(p, cache, x, positions, pos0: int, cfg: ArchConfig,
                 window: int, impl: str | None = None, tables=None,
                 page_size: int = 0):
    a = cfg.attention
    if a.kv_lora_rank:
        return mla_prefill(p, cache, x, positions, pos0, a, window,
                           tables=tables, page_size=page_size)
    return gqa_prefill(p, cache, x, positions, pos0, a, window, impl=impl,
                       tables=tables, page_size=page_size)
