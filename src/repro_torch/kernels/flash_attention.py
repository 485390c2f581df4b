"""Flash attention for the serve path: the causal/windowed GQA forward
(chunked prefill) and the split-KV one-token decode over contiguous or
paged cache lanes.

Each wrapper takes the JAX package's layouts (``(B, S, H, D)`` attention
tensors, ``(P, page_size, KV, D)`` pages, ``(B, NP)`` int32 block tables)
and semantics (``q_off`` = absolute position of query row 0, ``window``
<= 0 = plain causal, ``decode_keep`` visibility ``t <= pos[b]``). For CPU
tensors it runs the plain version in ``kernels/ref.py``; for CUDA tensors
it launches the kernel in ``csrc/flash_attention.cu`` or raises.

Kernels (design notes in the CUDA source):

- ``flash_attention`` -> ``flash_fwd``, replacing
  ``repro/kernels/flash_attention.py:_fwd_kernel`` (forward only here;
  the backward kernels come with the training slice).
- ``flash_decode`` / ``flash_decode_paged`` -> ``flash_decode_split``,
  replacing ``_decode_kernel`` / ``_decode_paged_kernel``. Both write the
  per-split partials (m, l, acc); the combine across splits is plain
  torch, as it is plain jnp outside the ``pallas_call`` in the JAX
  package. The paged kernel is the contiguous kernel reading each split's
  rows through the block table, so it equals ``flash_decode`` on the
  gathered lanes with ``block_k = page_size`` bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref

DEFAULT_DECODE_BLOCK_K = 512
HEAD_DIMS = (32, 64)
FWD_ROWS = 16        # rows (block_q * G) of a forward block; csrc FWD_ROWS


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_cuda(name: str, q, k, v, *, fwd: bool):
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q/k/v dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    K.dtype_code(q)
    Dk, Dv = q.shape[-1], v.shape[-1]
    if Dk != Dv or Dk not in HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes head_dim in {HEAD_DIMS} with "
            f"Dk == Dv (got Dk={Dk}, Dv={Dv}); other head dims and the MLA "
            f"absorbed layout (KV=1, Dk != Dv) come with the MLA serving "
            f"slice")
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    if fwd and FWD_ROWS % G:
        raise NotImplementedError(
            f"{name}: GQA group size {G} must divide {FWD_ROWS}")
    if not fwd and G > 16:
        raise NotImplementedError(f"{name}: GQA group size {G} > 16")


def _positions(x, batch: int, device) -> torch.Tensor:
    """None / int / (B,) -> contiguous (B,) int32 on ``device``."""
    if x is None:
        x = 0
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(batch).contiguous()


def flash_attention(q, k, v, *, q_off=None, window: int = 0, sm_scale=None,
                    return_lse: bool = False):
    """Fused causal(+window) attention. q (B, Sq, H, Dk), k (B, Sk, KV,
    Dk), v (B, Sk, KV, Dv), H % KV == 0. Returns (B, Sq, H, Dv) [+ lse
    (B, Sq, H) fp32 when ``return_lse``].

    ``q_off``: absolute position of query row 0 — None, an int or a (B,)
    vector. ``window``: sliding window (<= 0 plain causal). ``sm_scale``
    defaults to 1/sqrt(Dk). Forward only: no autograd."""
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dk)
    window = int(window)
    q_off = _positions(q_off, B, q.device)
    if K.on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, q_off, window, sm_scale,
                                       return_lse)
    _check_cuda("flash_attention", q, k, v, fwd=True)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Sq, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = K.load("flash_attention").flash_fwd(
        K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out), K.ptr(lse), K.ptr(q_off),
        B, Sq, Sk, H, KV, Dk, K.dtype_code(q), window,
        ctypes.c_float(sm_scale), K.stream_ptr(q))
    K.check(err, "flash_fwd")
    K.count("flash_attention")
    return (out, lse) if return_lse else out


def _decode_call(name, q, k, v, tables, pos, *, S, NP, block_k, ns, kv_len,
                 window, sm_scale):
    B, _, H, Dk = q.shape
    KV = k.shape[2]
    G = H // KV
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, ns, G), **f32)
    l = torch.empty((B, KV, ns, G), **f32)
    acc = torch.empty((B, KV, ns, G, v.shape[-1]), **f32)
    err = K.load("flash_attention").flash_decode_split(
        K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(tables), K.ptr(pos), K.ptr(m),
        K.ptr(l), K.ptr(acc), B, H, KV, Dk, K.dtype_code(q), S, NP, block_k,
        ns, kv_len, window, ctypes.c_float(sm_scale), K.stream_ptr(q))
    K.check(err, "flash_decode_split")
    K.count(name)
    return ref.combine_kv_splits(m, l, acc).to(q.dtype)


def flash_decode(q, k, v, pos, *, window: int = 0, sm_scale=None,
                 block_k: int = DEFAULT_DECODE_BLOCK_K):
    """Split-KV one-token decode. q (B, 1, H, Dk); k/v the full (B, S, KV,
    D) cache lanes; pos an int or (B,) per-slot positions (key t visible
    iff t <= pos[b] and within the window). The lanes split into
    ceil(S / block_k) chunks, each an independent partial; the partials
    merge with the online-softmax combine. Returns (B, 1, H, Dv)."""
    B, Sq, H, Dk = q.shape
    S, KV = k.shape[1], k.shape[2]
    if Sq != 1:
        raise ValueError(f"flash_decode wants a single query row, Sq={Sq}")
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dk)
    window = int(window)
    block_k = min(block_k, _round_up(S, 16))
    pos = _positions(pos, B, q.device)
    if K.on_cpu(q, k, v):
        return ref.flash_decode_ref(q, k, v, pos, window, sm_scale, block_k)
    _check_cuda("flash_decode", q, k, v, fwd=False)
    return _decode_call("flash_decode", q, k, v, None, pos, S=S, NP=0,
                        block_k=block_k, ns=-(-S // block_k), kv_len=S,
                        window=window, sm_scale=sm_scale)


def flash_decode_paged(q, k_pages, v_pages, tables, pos, *, page_size: int,
                       window: int = 0, sm_scale=None):
    """Split-KV decode over a paged cache: split j of slot b reads physical
    page ``tables[b, j]``. q (B, 1, H, Dk); k_pages/v_pages (P, page_size,
    KV, D); tables (B, NP) int32; pos (B,). Pages past ``pos // page_size``
    are skipped with neutral partials, so whatever page the table maps
    there (typically the null page 0) never reaches the combine. Returns
    (B, 1, H, Dv), equal to ``flash_decode`` on the gathered lanes with
    ``block_k=page_size``."""
    B, Sq, H, Dk = q.shape
    ps, KV = k_pages.shape[1], k_pages.shape[2]
    if Sq != 1:
        raise ValueError(f"flash_decode_paged wants one query row, Sq={Sq}")
    if ps != page_size:
        raise ValueError(f"page dim {ps} != page_size {page_size}")
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dk)
    window = int(window)
    NP = tables.shape[-1]
    pos = _positions(pos, B, q.device)
    if K.on_cpu(q, k_pages, v_pages, tables):
        return ref.flash_decode_paged_ref(q, k_pages, v_pages, tables, pos,
                                          window, sm_scale, page_size)
    _check_cuda("flash_decode_paged", q, k_pages, v_pages, fwd=False)
    tables = tables.to(torch.int32).reshape(B, NP).contiguous()
    return _decode_call("flash_decode_paged", q, k_pages, v_pages, tables,
                        pos, S=0, NP=NP, block_k=page_size, ns=NP,
                        kv_len=NP * page_size, window=window,
                        sm_scale=sm_scale)
