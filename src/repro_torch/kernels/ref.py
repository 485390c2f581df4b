"""Plain PyTorch versions of every ported kernel.

The wrappers (``flash_attention.py``, ``slot_gather.py``,
``chunk_sum.py``, ``quantize.py``, ``fused_sgd.py``,
``fused_rs_update.py``) call these for CPU tensors; on the card they are
what each CUDA kernel is held to. Each mirrors the arithmetic of the JAX
package's Pallas kernel. Serve path: fp32 softmax statistics,
``NEG_INF = -1e30`` for masked scores with masked ``p`` zeroed
explicitly, ``l`` clamped at ``1e-30``, and ``p`` rounded to the value
dtype before the PV product. The flash backward recomputes p from the
saved lse and rounds ``ds`` and ``p`` to the input dtype before each
contraction, as the Pallas backward does. Exchange and update path:
fp32 sums taken row by row in order 0..k-1, and every product and sum of
the update rounded on its own in the order written here, which the CUDA
kernels repeat operation for operation (no FMA), so the two agree bit
for bit. The blockwise int8 quantizer's scale is the one fused
multiply-add, because XLA makes it one in the JAX kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _keep(qpos, kpos, window: int):
    """Causal + sliding-window keep mask on broadcastable positions."""
    keep = kpos <= qpos
    if window > 0:
        keep &= (qpos - kpos) < window
    return keep


def _f(x):
    """Upcast to the attention's compute dtype: fp32, or fp64 for fp64
    inputs (the finite-difference gradient checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def flash_attention_ref(q, k, v, q_off, window: int, sm_scale: float,
                        return_lse: bool = False):
    """q (B, Sq, H, Dk), k (B, Sk, KV, Dk), v (B, Sk, KV, Dv), q_off (B,)
    int -> out (B, Sq, H, Dv) in q's dtype [+ lse (B, Sq, H) fp32, fp64
    for fp64 inputs]. Row r of batch b sits at absolute position
    ``q_off[b] + r``; key t at t."""
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = _f(q).reshape(B, Sq, KV, G, Dk)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, _f(k)) * sm_scale
    qpos = q_off.to(q.device).long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    keep = _keep(qpos[:, :, None], kpos[None, None, :], window)[:, None, None]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bkgqt,btkd->bkgqd", _f(p.to(v.dtype)), _f(v))
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l))[..., 0].permute(0, 3, 1, 2).reshape(B, Sq, H)
    return out, lse


def _bwd_p_ds(q, k, v, lse, do, di, q_off, window: int, sm_scale: float):
    """p and ds (B, KV, G, Sq, Sk), fp32, of the flash backward: p
    recomputed from lse, ``ds = p (dp - di) sm_scale`` with ``dp = do
    v^T``. Masked p is zeroed explicitly (the Pallas kernel's exp(NEG_INF
    - lse) is 0 on every row that sees at least one key)."""
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = _f(q).reshape(B, Sq, KV, G, Dk)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, _f(k)) * sm_scale
    qpos = q_off.to(q.device).long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    keep = _keep(qpos[:, :, None], kpos[None, None, :], window)[:, None, None]
    rows = lambda x: _f(x).reshape(B, Sq, KV, G).permute(0, 2, 3, 1)[..., None]
    p = torch.where(keep, torch.exp(s - rows(lse)), 0.0)
    dog = _f(do).reshape(B, Sq, KV, G, -1)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, _f(v))
    return p, p * (dp - rows(di)) * sm_scale


def flash_attention_di(out, do):
    """rowsum(out * do) in fp32: (B, Sq, H, Dv) x2 -> (B, Sq, H)."""
    return (_f(out) * _f(do)).sum(-1)


def flash_attention_dq_ref(q, k, v, lse, do, di, q_off, window: int,
                           sm_scale: float):
    """dq (B, Sq, H, Dk) in q's dtype; ds is rounded to k's dtype before
    the ``ds k`` product, as ``_dq_kernel`` rounds it."""
    B, Sq, H, Dk = q.shape
    _, ds = _bwd_p_ds(q, k, v, lse, do, di, q_off, window, sm_scale)
    dq = torch.einsum("bkgqt,btkd->bqkgd", _f(ds.to(k.dtype)), _f(k))
    return dq.reshape(B, Sq, H, Dk).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, lse, do, di, q_off, window: int,
                            sm_scale: float):
    """(dk, dv) (B, Sk, KV, D) in k's / v's dtype, each summed over the G
    query heads of its group; p is rounded to do's dtype and ds to q's
    before the contractions, as ``_dkv_kernel`` rounds them."""
    B, Sq, H, Dk = q.shape
    KV = k.shape[2]
    G = H // KV
    p, ds = _bwd_p_ds(q, k, v, lse, do, di, q_off, window, sm_scale)
    qg = _f(q).reshape(B, Sq, KV, G, Dk)
    dog = _f(do).reshape(B, Sq, KV, G, -1)
    dk = torch.einsum("bkgqt,bqkgd->btkd", _f(ds.to(q.dtype)), qg)
    dv = torch.einsum("bkgqt,bqkgd->btkd", _f(p.to(do.dtype)), dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, do, q_off, window: int,
                            sm_scale: float):
    """The flash backward as the Pallas kernels compute it (a direct
    formula, not autograd): ``di = rowsum(out do)`` in fp32, then
    :func:`flash_attention_dq_ref` and :func:`flash_attention_dkv_ref`.
    Returns (dq, dk, dv)."""
    di = flash_attention_di(out, do)
    dq = flash_attention_dq_ref(q, k, v, lse, do, di, q_off, window,
                                sm_scale)
    dk, dv = flash_attention_dkv_ref(q, k, v, lse, do, di, q_off, window,
                                     sm_scale)
    return dq, dk, dv


def mla_dkv_reduce_ref(part_k, part_v, n_live, dtype):
    """The sum of the tensor-core dk/dv's chunk partials: part_k (n, B,
    Sk, KV, Dk) and part_v (n, B, Sk, KV, Dv) fp32, n_live (B, Sk) the
    live chunks of each key (chunks 0 .. n_live - 1; the others are never
    read, whatever they hold). Summed from 0 in chunk order, as the
    kernel sums, and cast to ``dtype``: (dk, dv)."""
    live = (torch.arange(part_k.shape[0], device=part_k.device)[:, None, None]
            < n_live.to(part_k.device)[None])
    out = []
    for part in (part_k, part_v):
        acc = torch.zeros(part.shape[1:], dtype=torch.float32,
                          device=part.device)
        for c in range(part.shape[0]):
            acc = acc + torch.where(live[c, :, :, None, None], part[c], 0.0)
        out.append(acc.to(dtype))
    return tuple(out)


def decode_partials_ref(q, k, v, pos, window: int, sm_scale: float,
                        block_k: int):
    """Split-KV partials of one-token decode over contiguous lanes.

    q (B, 1, H, Dk), k/v (B, S, KV, D), pos (B,) -> m, l (B, KV, ns, G)
    and acc (B, KV, ns, G, Dv) fp32 with ns = ceil(S / block_k). A split
    that holds no visible key (``_tile_live`` false) is neutral: m =
    NEG_INF, l = 0, acc = 0."""
    B, _, H, Dk = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    ns = -(-S // block_k)
    pad = ns * block_k - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.float().reshape(B, ns, block_k, KV, Dk)
    vb = v.reshape(B, ns, block_k, KV, Dv)
    qg = q[:, 0].float().reshape(B, KV, G, Dk)
    s = torch.einsum("bkgd,bjckd->bkjgc", qg, kb) * sm_scale
    pos = pos.to(q.device).long()
    kpos = torch.arange(ns * block_k, device=q.device).reshape(ns, block_k)
    keep = _keep(pos[:, None, None], kpos[None], window) & (kpos < S)[None]
    keep = keep[:, None, :, None, :]                       # (B,1,ns,1,bk)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkjgc,bjckd->bkjgd", p.to(v.dtype).float(),
                       vb.float())
    j = torch.arange(ns, device=q.device)
    live = (j[None] * block_k <= pos[:, None])
    if window > 0:
        live &= (j[None] + 1) * block_k > pos[:, None] - window + 1
    live = live[:, None, :, None]                          # (B,1,ns,1)
    m = torch.where(live, m, NEG_INF)
    l = torch.where(live, l, 0.0)
    acc = torch.where(live[..., None], acc, 0.0)
    return m, l, acc


def combine_kv_splits(m, l, acc):
    """Online-softmax combine of split partials m/l (B, KV, ns, G) and acc
    (B, KV, ns, G, Dv) -> (B, 1, H, Dv) fp32. A neutral partial drops out
    exactly."""
    B, KV, _, G = m.shape
    m_g = m.amax(2, keepdim=True)
    alpha = torch.exp(m - m_g)
    l_g = (alpha * l).sum(2)
    out = (alpha[..., None] * acc).sum(2)
    out = out / l_g.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, KV * G, acc.shape[-1])


def combine_live_splits(m, l, acc, pos, window: int, chunk: int,
                        kv_len: int):
    """:func:`combine_kv_splits` over the chunks of ``chunk`` keys that
    hold a key visible from ``pos`` (B,) in lanes of ``kv_len`` keys; the
    others are taken as neutral whatever they hold (the decode kernel
    does not write them). -> (B, 1, H, Dv) fp32."""
    ns = m.shape[2]
    pos = pos.to(m.device).long()[:, None]
    j = torch.arange(ns, device=m.device)[None]
    lo, hi = j * chunk, torch.minimum((j + 1) * chunk, pos + 1).clamp(
        max=kv_len)
    if window > 0:
        lo = torch.maximum(lo, pos - window + 1)
    live = (lo < hi)[:, None, :, None]                     # (B,1,ns,1)
    m = torch.where(live, m, NEG_INF)
    l = torch.where(live, l, 0.0)
    acc = torch.where(live[..., None], acc, 0.0)
    return combine_kv_splits(m, l, acc)


def flash_decode_ref(q, k, v, pos, window: int, sm_scale: float,
                     block_k: int):
    m, l, acc = decode_partials_ref(q, k, v, pos, window, sm_scale, block_k)
    return combine_kv_splits(m, l, acc).to(q.dtype)


def gather_pages(pages, tables):
    """(P, ps, ...) pages through (B, NP) tables -> (B, NP*ps, ...) lanes."""
    lanes = pages[tables.long()]
    return lanes.reshape((tables.shape[0], -1) + pages.shape[2:])


def flash_decode_paged_ref(q, k_pages, v_pages, tables, pos, window: int,
                           sm_scale: float, page_size: int):
    """The paged decode is the contiguous one on the gathered lanes with
    one split per page."""
    return flash_decode_ref(q, gather_pages(k_pages, tables),
                            gather_pages(v_pages, tables), pos, window,
                            sm_scale, page_size)


def slot_gather_sample_ref(logits, onehot, temperature, noise):
    """(S, C, V) logits + (S, C) one-hot + (S,) temperatures + (S, V)
    Gumbel noise -> (greedy (S,), sampled (S,)) int32."""
    row = torch.einsum("scv,sc->sv", logits.float(), onehot.float())
    greedy = row.argmax(-1).to(torch.int32)
    t = temperature.float().clamp_min(1e-6)
    sampled = (row / t[:, None] + noise.float()).argmax(-1).to(torch.int32)
    return greedy, sampled


# ---------------------------------------------------------------------------
# training path: the ASA sum, the fp16 wire and the momentum-SGD update
# ---------------------------------------------------------------------------

def chunk_sum_ref(chunks):
    """(k, n) float chunks -> (n,) fp32 sum, rows added in order."""
    acc = chunks[0].float()
    for r in range(1, chunks.shape[0]):
        acc = acc + chunks[r].float()
    return acc


def quant_fp16_ref(x):
    return x.to(torch.float16)


def dequant_fp16_ref(x):
    return x.to(torch.float32)


def _pad_blocks(x, block_n: int):
    """(n,) -> (ceil(n / block_n), block_n), zeros past n."""
    pad = (-x.shape[0]) % block_n
    return torch.nn.functional.pad(x, (0, pad)).reshape(-1, block_n)


# fp32 1/127: XLA compiles the JAX kernel's ``absmax / 127.0 + 1e-12`` into
# one fused multiply-add by this reciprocal, so the scale is rounded once
INV_127 = (torch.tensor(1.0) / 127).item()
EPS_1E12 = torch.tensor(1e-12).item()          # 1e-12 rounded to fp32


def _fma_scale(absmax):
    """fp32 ``fma(absmax, INV_127, EPS_1E12)``, rounded once: the fp64
    product is exact, and where the fp64 sum lands exactly on an fp32 tie
    it is stepped one fp64 ulp towards the sum's rounding error (TwoSum),
    so the cast to fp32 rounds as the exact sum would."""
    prod = absmax.double() * INV_127
    s = prod + EPS_1E12
    err = EPS_1E12 - (s - prod)                 # the fp64 sum's error
    f = s.float()
    other = torch.nextafter(f, torch.where(s > f.double(), torch.inf,
                                           -torch.inf).float())
    tie = (s - f.double()) == (other.double() - s)
    nudged = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                             .double())
    return torch.where(tie & (err != 0), nudged, s).float()


def quant_int8_ref(x, block_n: int = 2048):
    """(n,) float -> (q (n,) int8, scales (ceil(n / block_n),) fp32): per
    block of ``block_n`` values, ``scale = absmax / 127 + 1e-12`` and ``q =
    clip(round(x / scale), -127, 127)`` with a true division, rounding half
    to even (as ``jnp.round``). The scale is what the JAX kernel computes
    under XLA, ``fma(absmax, fp32(1/127), 1e-12)`` rounded once to fp32
    (:func:`_fma_scale`). The zero padding of the last block counts toward
    its absmax and changes nothing."""
    n = x.shape[0]
    blocks = _pad_blocks(x.float(), block_n)
    scale = _fma_scale(blocks.abs().amax(dim=1))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1)[:n], scale


def dequant_int8_ref(q, scales, block_n: int = 2048):
    """(n,) int8 and its per-block fp32 scales -> (n,) fp32 ``q * scale``."""
    n = q.shape[0]
    out = _pad_blocks(q, block_n).float() * scales[:, None]
    return out.reshape(-1)[:n]


def _lr(lr, like):
    return torch.as_tensor(lr, dtype=torch.float32, device=like.device)


def fused_sgd_ref(p, g, m, lr, momentum: float = 0.9,
                  nesterov: bool = False):
    """Flat fp32 (p, g, m) + lr -> (p', m'): m' = mu m + g, then p' = p -
    lr m' (or p - lr (g + mu m') with nesterov)."""
    p, g, m = p.float(), g.float(), m.float()
    m_new = momentum * m + g
    step = g + momentum * m_new if nesterov else m_new
    return p - _lr(lr, p) * step, m_new


def fused_rs_update_ref(recv, p, m, mask, lr, momentum: float = 0.9,
                        nesterov: bool = False, scale: float = 1.0,
                        weight_decay: float = 0.0, scales=None):
    """(k, n) un-summed receives (float, or int8 with (k,) fp32 per-chunk
    scales) + this rank's flat shard (p, m, wd mask or None) -> (p', m'):
    g = scale * sum_r dequant(recv[r]) + weight_decay * mask * p, then the
    momentum step of :func:`fused_sgd_ref`."""
    acc = None
    for r in range(recv.shape[0]):
        v = recv[r].float()
        if scales is not None:
            v = v * scales[r].float()
        acc = v if acc is None else acc + v
    g = acc * scale
    p = p.float()
    if weight_decay and mask is not None:
        g = g + weight_decay * mask.float() * p
    return fused_sgd_ref(p, g, m, lr, momentum, nesterov)
