"""Plain PyTorch versions of every ported kernel.

The wrappers (``flash_attention.py``, ``slot_gather.py``,
``chunk_sum.py``, ``quantize.py``, ``fused_sgd.py``,
``fused_rs_update.py``) call these for CPU tensors; on the card they are
what each CUDA kernel is held to. Each mirrors the arithmetic of the JAX
package's Pallas kernel. Serve path: fp32 softmax statistics,
``NEG_INF = -1e30`` for masked scores with masked ``p`` zeroed
explicitly, ``l`` clamped at ``1e-30``, and ``p`` rounded to the value
dtype before the PV product. Training path: fp32 sums taken row by row in
order 0..k-1, and every product and sum of the update rounded on its own
in the order written here, which the CUDA kernels repeat operation for
operation (no FMA), so the two agree bit for bit.
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


def flash_attention_ref(q, k, v, q_off, window: int, sm_scale: float,
                        return_lse: bool = False):
    """q (B, Sq, H, Dk), k (B, Sk, KV, Dk), v (B, Sk, KV, Dv), q_off (B,)
    int -> out (B, Sq, H, Dv) in q's dtype [+ lse (B, Sq, H) fp32]. Row r
    of batch b sits at absolute position ``q_off[b] + r``; key t at t."""
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, Dk)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * sm_scale
    qpos = q_off.to(q.device).long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    keep = _keep(qpos[:, :, None], kpos[None, None, :], window)[:, None, None]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l))[..., 0].permute(0, 3, 1, 2).reshape(B, Sq, H)
    return out, lse


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
