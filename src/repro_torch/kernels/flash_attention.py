"""Flash attention: the causal/windowed GQA forward (training and chunked
prefill) with its backward, and the split-KV one-token decode over
contiguous or paged cache lanes.

Each wrapper takes the JAX package's layouts (``(B, S, H, D)`` attention
tensors, ``(P, page_size, KV, D)`` pages, ``(B, NP)`` int32 block tables)
and semantics (``q_off`` = absolute position of query row 0, ``window``
<= 0 = plain causal, ``decode_keep`` visibility ``t <= pos[b]``). For CPU
tensors it runs the plain version in ``kernels/ref.py``; for CUDA tensors
it launches the kernel in ``csrc/flash_attention.cu`` or raises.

Kernels (design notes in the CUDA source):

- ``flash_attention`` -> ``flash_fwd``, replacing
  ``repro/kernels/flash_attention.py:_fwd_kernel``: in bf16/fp16
  ``fwd_hopper`` (wgmma products, TMA-fed K/V tiles), in fp32 the
  CUDA-core ``fwd_kernel`` (the MLA route: ``flash_mla_fwd``, below).
  Differentiable in q,
  k and v through :class:`FlashAttention` (the counterpart of the JAX
  package's custom VJP): the forward saves (out, lse) and the backward
  runs ``flash_attention_dq`` -> ``flash_bwd_dq`` (``_dq_kernel``) and
  ``flash_attention_dkv`` -> ``flash_bwd_dkv`` (``_dkv_kernel``), with
  ``di = rowsum(out do)`` one plain-torch reduction outside them, as it
  is plain jnp outside the ``pallas_call`` in the JAX package. The lse
  output is non-differentiable (the reference's ``stop_gradient``).
- ``flash_decode`` / ``flash_decode_paged`` -> ``flash_decode_split``,
  replacing ``_decode_kernel`` / ``_decode_paged_kernel``, then
  ``decode_combine`` -> ``flash_decode_combine``, the online-softmax merge
  of the chunk partials (plain jnp outside the ``pallas_call`` in the
  JAX package, ``_combine_kv_splits``). The lanes split into chunks
  chosen on the host by :func:`decode_plan` from the lane length, the
  page size (``block_k`` on the contiguous path) and the SM count alone;
  the paged kernel is the contiguous kernel reading each chunk's rows
  through the block table, so it equals ``flash_decode`` on the gathered
  lanes with ``block_k = page_size`` bit for bit. Neither the wrapper
  nor the kernels read ``pos`` on the host, so a decode step can be
  captured in a CUDA graph.

On the card the forward, dq and dk/dv take two routes. At Dk == Dv <=
128 they run the kernels built for head dims 32, 64 and 128, any other
D zero-padded to the next of them by :func:`pad_head_dim` (exact: zero
columns add nothing to q.k, and the padded output columns are sliced
off); a block holds the G = H / KV heads of ``rows // G`` queries, the
spare rows idle where G does not divide the row count: in bf16 and fp16
on the tensor cores with 64-row tiles, so G <= 64; in fp32 (forward 16
rows, dq 16, dk/dv 32) on the CUDA cores, G <= 16. The MLA absorbed
layout (Dk != Dv: DeepSeek-V2's latent 512 + rope 64 keys over the
512-value latent) and any head dim above 128 take the MLA route
(:func:`mla_route`; G <= 16): ``flash_mla_fwd``, ``flash_mla_bwd_dq``
and ``flash_mla_bwd_dkv``, in fp32 the CUDA-core ``fwd_kernel``,
``bwd_dq_kernel`` and ``bwd_dkv_kernel``, built at the (Dk, Dv) pairs of
:data:`MLA_PAIRS`, any other pair up to (576, 512) zero-padded to the
smallest that holds it (:func:`mla_pair`); in bf16/fp16 the tensor-core
``fwd_mla_hopper``, ``bwd_dq_mla_hopper`` and ``bwd_dkv_mla_hopper`` at
:data:`MLA_TC_PAIR`, every pair zero-padded up to it
(:func:`mla_kernel_pair`), dk/dv there as fp32 partials of chunks of q
tiles (:func:`mla_dkv_plan`) that ``flash_mla_dkv_reduce``
(:func:`mla_dkv_reduce`) sums. They count their
launches as ``flash_attention_mla``, ``flash_attention_mla_dq``,
``flash_attention_mla_dkv`` and ``flash_attention_mla_dkv_reduce``.
Above Dk 576 or Dv 512 raises ``NotImplementedError`` naming the dims.
The decode takes Dk == Dv <= 128 and G <= 16 (above 128 raises, naming
ROADMAP queue 2: the MLA decode is an einsum over the latent, as in the
JAX package).
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref

# the contiguous decode's page size: chunks are multiples of it. The JAX
# package's 512 would give a 1 K lane two chunks, too few blocks for the
# card's SMs; the plain version on the CPU splits by it
DEFAULT_DECODE_BLOCK_K = 128
# head dims the kernels are built for; others up to the largest are padded
HEAD_DIMS = (32, 64, 128)
# keys of the shortest decode chunk, and the most chunks a lane takes per
# SM (a long lane gets longer chunks rather than more of them)
DECODE_MIN_CHUNK = 128
DECODE_CHUNKS_PER_SM = 2
# largest G = H / KV per path: a 64-row tile on the tensor cores (bf16/fp16
# forward and backward; csrc HB_M), 16 rows on the CUDA cores (fp32:
# FWD_ROWS, DQ_ROWS) and in the decode (DEC_MAX_G)
MAX_GROUP_TENSOR_CORES = 64
MAX_GROUP_FP32 = 16
MAX_GROUP_DECODE = 16
# (Dk, Dv) pairs the MLA route's fp32 kernels are built for (csrc
# mla_entry): the smoke config's (80, 64) pads to the first,
# DeepSeek-V2-Lite's (576, 512) is the second; their CUDA-core blocks hold
# 16 rows, and the route takes G <= 16 in every dtype
MLA_PAIRS = ((96, 64), (576, 512))
MAX_GROUP_MLA = 16
# the one pair of the MLA route's bf16/fp16 forward and backward on the
# tensor cores (csrc MLA_TC_DK / MLA_TC_DV); every bf16/fp16 pair pads up
# to it
MLA_TC_PAIR = (576, 512)
# its dk/dv blocks: 64 keys (csrc HB_M) over q tiles of 32 rows (MB_N),
# cut into chunks of at least MLA_DKV_MIN_CHUNK q tiles (mla_dkv_plan)
MLA_DKV_KEYS = 64
MLA_DKV_ROWS = 32
MLA_DKV_MIN_CHUNK = 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def kernel_head_dim(name: str, D: int) -> int:
    """The head dim the Dk == Dv kernels compute ``D`` at: the next of
    :data:`HEAD_DIMS`. Above the largest raises; only the decode has no
    other route there (ROADMAP queue 2)."""
    for d in HEAD_DIMS:
        if D <= d:
            return d
    raise NotImplementedError(
        f"{name}: head_dim {D} is more than the split-KV decode kernels take "
        f"({HEAD_DIMS[-1]}); a decode above it is ROADMAP queue 2 (the "
        f"forward and backward take up to Dk 576 / Dv 512 on the MLA route)")


def mla_route(Dk: int, Dv: int) -> bool:
    """True where the forward and backward take the MLA-route kernels: Dk
    != Dv (the MLA absorbed layout) or a head dim above 128."""
    return Dk != Dv or Dk > HEAD_DIMS[-1]


def mla_pair(name: str, Dk: int, Dv: int) -> tuple[int, int]:
    """The smallest built (Dk, Dv) pair of :data:`MLA_PAIRS` that holds
    ``(Dk, Dv)``; beyond the largest raises, naming the dims."""
    for pk, pv in MLA_PAIRS:
        if Dk <= pk and Dv <= pv:
            return pk, pv
    raise NotImplementedError(
        f"{name}: head dims Dk={Dk}, Dv={Dv} are more than the CUDA kernels "
        f"take (Dk <= {MLA_PAIRS[-1][0]}, Dv <= {MLA_PAIRS[-1][1]})")


def mla_kernel_pair(name: str, Dk: int, Dv: int, dtype) -> tuple[int, int]:
    """The (Dk, Dv) the MLA-route kernels compute ``(Dk, Dv)`` at, the
    forward and the backward alike: in fp32 the CUDA-core ``fwd_kernel``,
    ``bwd_dq_kernel`` and ``bwd_dkv_kernel`` at :func:`mla_pair`'s pair;
    in bf16/fp16 the tensor-core ``fwd_mla_hopper``, ``bwd_dq_mla_hopper``
    and ``bwd_dkv_mla_hopper`` (+ ``mla_dkv_reduce``) at
    :data:`MLA_TC_PAIR`, zero-padded up (exact, as :func:`pad_head_dim`).
    Beyond (576, 512) raises, naming the dims."""
    pair = mla_pair(name, Dk, Dv)
    return pair if dtype == torch.float32 else MLA_TC_PAIR


def mla_dkv_plan(B: int, Sq: int, Sk: int, H: int, KV: int,
                 sm_count: int) -> tuple[int, int]:
    """(chunk, n_chunks) of the tensor-core dk/dv: each key tile's live q
    tiles (of ``MLA_DKV_ROWS // G`` queries) are cut into chunks of
    ``chunk`` tiles, one block (and one fp32 partial) a chunk and part (dk
    or dv). A function of the shapes and the SM count alone: under a
    causal mask about half of the ``nq x key tiles`` (key tile, q tile)
    pairs of each part are live, and ``chunk`` is chosen so that those
    fill each SM about twice, but no shorter than MLA_DKV_MIN_CHUNK tiles
    (each chunk adds a partial to write and read)."""
    bq = MLA_DKV_ROWS // (H // KV)
    nq = -(-Sq // bq)
    tiles = B * KV * -(-Sk // MLA_DKV_KEYS)
    chunk = min(nq, max(MLA_DKV_MIN_CHUNK, -(-nq * tiles // (2 * sm_count))))
    return chunk, -(-nq // chunk)


def mla_dkv_live(j: int, qoff: int, window: int, nq: int, bq: int):
    """Live q tiles [lo, lo + n) of the dk/dv key tile j (csrc
    mla_dkv_live): the tile's newest query at or past the key tile's
    oldest key, and (window) its oldest query within reach of the newest."""
    k0 = j * MLA_DKV_KEYS
    lo = max(0, -((qoff + bq - 1 - k0) // bq))
    end = (min(nq, (k0 + MLA_DKV_KEYS - 1 + window - 1 - qoff) // bq + 1)
           if window > 0 else nq)
    return lo, max(0, end - lo)


def mla_dkv_blocks(B: int, Sq: int, Sk: int, H: int, KV: int, q_off,
                   window: int, chunk: int):
    """The tensor-core dk/dv grid in launch order, as
    ``bwd_dkv_mla_hopper`` decodes its block index: chunk 0 of every key
    tile first (dk before dv, key tile 0 first, then the (batch, kv head)
    pairs), then chunk 1, ... Returns (chunk, part (0 dk, 1 dv), b, h, key
    tile, first q tile, q tiles) of each block that has a live q tile; the
    others return at once and write nothing. ``q_off`` a host sequence of
    B positions."""
    G = H // KV
    bq = MLA_DKV_ROWS // G
    nq, nk = -(-Sq // bq), -(-Sk // MLA_DKV_KEYS)
    pairs = KV * B
    per_part = nk * pairs
    out = []
    for x in range(-(-nq // chunk) * 2 * per_part):
        c, r = divmod(x, 2 * per_part)
        part, r2 = divmod(r, per_part)
        j, h, b = r2 // pairs, r2 % pairs % KV, r2 % pairs // KV
        lo, n = mla_dkv_live(j, int(q_off[b]), window, nq, bq)
        s_lo = lo + c * chunk
        steps = min(chunk, lo + n - s_lo)
        if steps > 0:
            out.append((c, part, b, h, j, s_lo, steps))
    return out


def _pad_to(width: int, *ts):
    """Each tensor's last dim zero-padded to ``width`` columns."""
    return tuple(t if t.shape[-1] == width else
                 torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in ts)


def pad_head_dim(D: int, *ts):
    """Each tensor's last dim zero-padded from its ``D`` columns to
    ``kernel_head_dim(D)`` (the tensors themselves where no pad is
    needed). Exact for attention: zero q/k columns add nothing to q.k,
    zero v/do columns give zero output, dv and dq/dk columns, and
    rowsum(do o) is unchanged; the caller passes ``sm_scale`` of the true
    D and slices the outputs back to D."""
    return _pad_to(kernel_head_dim("pad_head_dim", D), *ts)


def _check_cuda(name: str, q, k, v, decode: bool = False):
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q/k/v dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    K.dtype_code(q)
    Dk, Dv = q.shape[-1], v.shape[-1]
    G = q.shape[2] // k.shape[2]
    if decode:
        if Dk != Dv:
            raise NotImplementedError(
                f"{name}: the decode kernels take Dk == Dv (got Dk={Dk}, "
                f"Dv={Dv}); the MLA decode is an einsum over the latent")
        kernel_head_dim(name, Dk)
        limit, path = MAX_GROUP_DECODE, "the decode"
    elif mla_route(Dk, Dv):
        mla_pair(name, Dk, Dv)
        limit, path = MAX_GROUP_MLA, "the MLA route (Dk != Dv or D > 128)"
    elif q.dtype == torch.float32:
        limit, path = MAX_GROUP_FP32, "fp32"
    else:
        limit, path = MAX_GROUP_TENSOR_CORES, "bf16/fp16"
    if G > limit:
        raise NotImplementedError(
            f"{name}: GQA group size G = {G} > {limit}, the most {path} "
            f"takes")


def _unpad(t, D: int):
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def host_offsets(q_off) -> Counter:
    """{position: slots} of a (B,) position tensor (read on the host: the
    cost functions run only under a CostMode). A meta tensor holds no
    values: each of its slots stands at ``kernels.meta_position()``."""
    if q_off.is_meta:
        return Counter({K.meta_position(): q_off.numel()})
    return Counter(int(v) for v in q_off.reshape(-1).tolist())


def attention_flops_bytes(*, batch: int, q_len: int, kv_len: int,
                          heads: int, kv_heads: int, head_dim_k: int,
                          head_dim_v: int = 0, window: int = 0,
                          causal: bool = True, q_start: int = 0,
                          kind: str = "fwd", dtype_bytes: int = 2) -> dict:
    """Analytic FLOPs and minimal HBM bytes for (windowed-)causal
    attention — the roofline an exact fused kernel can at best achieve.

    ``pairs`` counts surviving (q, k) interactions: query at absolute
    position ``q_start + i`` sees ``min(pos+1, kv_len)`` keys, clipped to
    ``window`` when one is set — so windowed layers get a *linear* (not
    quadratic) compute term and the bench can report achieved-vs-roofline
    per masking mode. FLOPs: 2·(Dk+Dv) per pair per head forward (QK^T +
    PV); the backward recomputes the score tile and runs the dQ/dK/dV
    matmuls (3·Dk + 2·Dv dots of 2 FLOPs each). Bytes: one q/k/v read +
    one out write at ``dtype_bytes`` (+ the fp32 lse/di residual rows and
    a re-read of everything for ``fwd+bwd``) — no (S, S) term at all,
    which is exactly what separates flash from the dense XLA path."""
    import numpy as np
    Dk = head_dim_k
    Dv = head_dim_v or head_dim_k
    if causal:
        pos = q_start + np.arange(q_len, dtype=np.int64)
        per_q = np.minimum(pos + 1, kv_len)
        if window > 0:
            per_q = np.minimum(per_q, window)
        pairs = int(per_q.sum())
    else:
        pairs = q_len * kv_len
    f_fwd = 2.0 * batch * heads * pairs * (Dk + Dv)
    f_bwd = 2.0 * batch * heads * pairs * (3 * Dk + 2 * Dv)
    flops = f_fwd + (f_bwd if kind != "fwd" else 0.0)
    qo_bytes = batch * q_len * heads * (Dk + Dv) * dtype_bytes
    kv_bytes = batch * kv_len * kv_heads * (Dk + Dv) * dtype_bytes
    hbm = qo_bytes + kv_bytes
    if kind != "fwd":
        hbm += 2 * (qo_bytes + kv_bytes)          # re-read + grad writes
        hbm += batch * q_len * heads * 2 * 4      # lse + di, fp32
    return {"flops": flops, "hbm_bytes": float(hbm), "pairs": pairs,
            "intensity": flops / max(hbm, 1.0)}


def _keys_read(off: int, Sq: int, Sk: int, window: int) -> int:
    """Keys that query rows off .. off + Sq - 1 see, together: up to the
    last row's, from the first row's window start."""
    lo = max(0, off - window + 1) if window > 0 else 0
    return max(min(Sk, off + Sq) - lo, 0)


def attention_cost(part: str, B: int, Sq: int, Sk: int, H: int, KV: int,
                   Dk: int, Dv: int, q_off, window: int, es: int,
                   lse: bool = False, partials=None) -> tuple:
    """(flops, bytes) of one flash launch at the caller's head dims (the
    zero columns the kernels pad to are no work): ``part`` "fwd", "dq" or
    "dkv". The (query, key) pairs are ``attention_flops_bytes``'s for the
    call's own causal mask, window, q_off and dims; the forward's flops
    are its ``fwd`` count, 2 (Dk + Dv) a pair and head, dq's 2 (2 Dk +
    Dv) (it recomputes the scores) and dk/dv's 2 (2 Dk + 2 Dv). Bytes:
    each input read and each output written once at ``es`` bytes a
    value, K and V over the keys the rows see; lse (when returned) and
    the backward's lse and di rows fp32; q_off. ``partials``: bytes the
    MLA tensor-core dk/dv writes in place of dk and dv. ``q_off`` is read
    on the host (call it only under a CostMode)."""
    flops = 0.0
    nbytes = 4 * B + (B * Sq * H * 4 if lse else 0)
    if part != "fwd":
        nbytes += 2 * B * Sq * H * 4
    for off, n in host_offsets(q_off).items():
        a = attention_flops_bytes(batch=n, q_len=Sq, kv_len=Sk, heads=H,
                                  kv_heads=KV, head_dim_k=Dk, head_dim_v=Dv,
                                  window=window, q_start=off, kind="fwd",
                                  dtype_bytes=es)
        kv = _keys_read(off, Sq, Sk, window) * KV * (Dk + Dv)
        pairs = 2.0 * n * H * a["pairs"]
        if part == "fwd":
            flops += a["flops"]
            nbytes += n * (Sq * H * (Dk + Dv) + kv) * es
        elif part == "dq":
            flops += pairs * (2 * Dk + Dv)
            nbytes += n * (Sq * H * (2 * Dk + Dv) + kv) * es
        else:
            flops += pairs * (2 * Dk + 2 * Dv)
            nbytes += n * (Sq * H * (Dk + Dv) + kv) * es
            if partials is None:
                nbytes += n * Sk * KV * (Dk + Dv) * es
    if part == "dkv" and partials is not None:
        nbytes += partials
    return flops, float(nbytes)


def mla_live_partials(B: int, Sq: int, Sk: int, H: int, KV: int, Dk: int,
                      Dv: int, q_off, window: int, chunk: int) -> int:
    """Bytes of the fp32 partials of the MLA tensor-core dk/dv that hold a
    live chunk (:func:`mla_dkv_live`): what it writes and its reduction
    reads. ``q_off`` is read on the host."""
    bq = MLA_DKV_ROWS // (H // KV)
    nq = -(-Sq // bq)
    n = 0
    for off, slots in host_offsets(q_off).items():
        for j in range(-(-Sk // MLA_DKV_KEYS)):
            keys = min(MLA_DKV_KEYS, Sk - j * MLA_DKV_KEYS)
            live = mla_dkv_live(j, off, window, nq, bq)[1]
            n += slots * keys * -(-live // chunk)
    return n * KV * (Dk + Dv) * 4


def mla_reduce_cost(B: int, Sq: int, Sk: int, H: int, KV: int, Dk: int,
                    Dv: int, q_off, window: int, chunk: int, es: int):
    """(flops, bytes) of ``mla_dkv_reduce``: the live partials read and
    added, dk and dv written, q_off read."""
    live = mla_live_partials(B, Sq, Sk, H, KV, Dk, Dv, q_off, window, chunk)
    return live / 4, float(live + B * Sk * KV * (Dk + Dv) * es + 4 * B)


def decode_cost(pos, H: int, KV: int, D: int, es: int, window: int,
                page: int = 0) -> tuple:
    """(flops, bytes) of one split-KV decode: the keys each slot reads
    (pos + 1, clipped to the window) times the KV heads times K's and V's
    D at ``es`` bytes, q read and the output written, the positions; the
    paged kernel (``page`` > 0) also reads the table entry of each page
    that holds a visible key. 4 D flops a key and query head. ``pos`` is
    read on the host."""
    ps = list(host_offsets(pos).elements())
    B = len(ps)
    need = sum(min(p + 1, window) if window > 0 else p + 1 for p in ps)
    nbytes = 2 * B * H * D * es + 2 * need * KV * D * es + 4 * B
    if page:
        nbytes += 4 * sum(p // page - (max(0, p - window + 1) // page
                                        if window > 0 else 0) + 1 for p in ps)
    return 4.0 * D * H * need, float(nbytes)


def combine_cost(pos, H: int, D: int, es: int, chunk: int, ns: int,
                 window: int) -> tuple:
    """(flops, bytes) of the decode's combine: the fp32 m, l and D-wide acc
    of every live (chunk, query row), the positions, the output written
    at ``es`` bytes; 3 D flops a live row. ``pos`` is read on the
    host."""
    ps = list(host_offsets(pos).elements())
    live = sum(1 for p in ps for c in range(ns) if c * chunk <= p and (
        window <= 0 or (c + 1) * chunk > p - window + 1))
    parts = live * H
    return (3.0 * D * parts,
            float(parts * (2 + D) * 4 + 4 * len(ps) + len(ps) * H * D * es))


def _positions(x, batch: int, device) -> torch.Tensor:
    """None / int / (B,) -> contiguous (B,) int32 on ``device``."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.shape == (batch,) and x.device == device
            and x.is_contiguous()):
        return x
    if x is None:
        x = 0
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(batch).contiguous()


def _tma_ready(t):
    """Contiguous, and 16-byte aligned as a TMA tensor map needs (a
    contiguous view can start at any element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(q, k, v, q_off, window: int, sm_scale: float,
             return_lse: bool):
    """The forward: the plain version on CPU tensors, else the kernel."""
    if K.plain_path(q, k, v):
        return ref.flash_attention_ref(q, k, v, q_off, window, sm_scale,
                                       return_lse)
    _check_cuda("flash_attention", q, k, v)
    if mla_route(q.shape[-1], v.shape[-1]):
        return _mla_forward(q, k, v, q_off, window, sm_scale, return_lse)
    D = q.shape[-1]
    es = q.element_size()
    q, k, v = pad_head_dim(D, q, k, v)
    B, Sq, H, Dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    out = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if K.launches(q):
        err = K.load("flash_attention").flash_fwd(
            K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out), K.ptr(lse),
            K.ptr(q_off), B, Sq, Sk, H, KV, Dk, K.dtype_code(q), window,
            ctypes.c_float(sm_scale), K.stream_ptr(q))
        K.check(err, "flash_fwd")
        K.count("flash_attention")
    K.cost("flash_attention", lambda: attention_cost(
        "fwd", B, Sq, Sk, H, KV, D, D, q_off, window, es, return_lse))
    out = _unpad(out, D)
    return (out, lse) if return_lse else out


def _mla_forward(q, k, v, q_off, window: int, sm_scale: float,
                 return_lse: bool):
    """The forward on the MLA route: q/k padded to the pair's Dk, v to its
    Dv (:func:`mla_kernel_pair`), then ``flash_mla_fwd``: in fp32 the
    CUDA-core ``fwd_kernel``, in bf16/fp16 the tensor-core
    ``fwd_mla_hopper`` (TMA-ready inputs)."""
    Dk, Dv = q.shape[-1], v.shape[-1]
    pk, pv = mla_kernel_pair("flash_attention", Dk, Dv, q.dtype)
    (q, k), (v,) = _pad_to(pk, q, k), _pad_to(pv, v)
    tc = q.dtype != torch.float32
    q, k, v = (_tma_ready(t) if tc else t.contiguous() for t in (q, k, v))
    B, Sq, H, _ = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, pv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if K.launches(q):
        err = K.load("flash_attention").flash_mla_fwd(
            K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out), K.ptr(lse),
            K.ptr(q_off), B, Sq, Sk, H, KV, pk, pv, K.dtype_code(q), window,
            ctypes.c_float(sm_scale), K.stream_ptr(q))
        K.check(err, "flash_mla_fwd")
        K.count("flash_attention_mla")
    K.cost("flash_attention_mla", lambda: attention_cost(
        "fwd", B, Sq, Sk, H, KV, Dk, Dv, q_off, window, q.element_size(),
        return_lse))
    out = _unpad(out, Dv)
    return (out, lse) if return_lse else out


def _mla_bwd(which: str, q, k, v, lse, do, di, q_off, window: int,
             sm_scale: float):
    """dq (``which`` "dq") or (dk, dv) ("dkv") on the MLA route: in fp32
    the CUDA-core kernels, in bf16/fp16 the tensor-core ones, dk/dv then
    in two launches (the chunks' fp32 partials into one ``torch.empty``
    scratch, then their sum); see :func:`mla_kernel_pair`."""
    name = f"flash_attention_{which}"
    _check_cuda(name, q, k, v)
    if do.dtype != q.dtype or do.shape[:3] != q.shape[:3] \
            or do.shape[-1] != v.shape[-1]:
        raise TypeError(f"{name}: do {tuple(do.shape)} {do.dtype} does not "
                        f"match q {tuple(q.shape)} / v {tuple(v.shape)}")
    Dk, Dv = q.shape[-1], v.shape[-1]
    pk, pv = mla_kernel_pair(name, Dk, Dv, q.dtype)
    tc = q.dtype != torch.float32
    (q, k), (v, do) = _pad_to(pk, q, k), _pad_to(pv, v, do)
    q, k, v, do = (_tma_ready(t) if tc else t.contiguous()
                   for t in (q, k, v, do))
    lse, di = lse.float().contiguous(), di.float().contiguous()
    B, Sq, H, _ = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = K.load("flash_attention") if K.launches(q) else None
    args = (B, Sq, Sk, H, KV, pk, pv, K.dtype_code(q), int(window))
    ins = (K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(do), K.ptr(lse), K.ptr(di))
    if which == "dq":
        dq = torch.empty_like(q)
        if lib is not None:
            err = lib.flash_mla_bwd_dq(*ins, K.ptr(dq), K.ptr(q_off), *args,
                                       ctypes.c_float(sm_scale),
                                       K.stream_ptr(q))
            K.check(err, "flash_mla_bwd_dq")
            K.count("flash_attention_mla_dq")
        K.cost("flash_attention_mla_dq", lambda: attention_cost(
            "dq", B, Sq, Sk, H, KV, Dk, Dv, q_off, window,
            q.element_size()))
        return _unpad(dq, Dk)
    part, chunk = None, 0
    if tc:
        chunk, n_chunks = mla_dkv_plan(B, Sq, Sk, H, KV, K.sms_of(q))
        part = torch.empty(n_chunks * B * Sk * KV * (pk + pv),
                           dtype=torch.float32, device=q.device)
    dk, dv = (None, None) if tc else (torch.empty_like(k), torch.empty_like(v))
    if lib is not None:
        err = lib.flash_mla_bwd_dkv(*ins, K.ptr(dk), K.ptr(dv),
                                    K.ptr(q_off), *args,
                                    ctypes.c_float(sm_scale), K.ptr(part),
                                    chunk, K.stream_ptr(q))
        K.check(err, "flash_mla_bwd_dkv")
        K.count("flash_attention_mla_dkv")
    K.cost("flash_attention_mla_dkv", lambda: attention_cost(
        "dkv", B, Sq, Sk, H, KV, Dk, Dv, q_off, window, q.element_size(),
        partials=mla_live_partials(B, Sq, Sk, H, KV, pk, pv, q_off, window,
                                   chunk) if tc else None))
    if tc:
        dk, dv = mla_dkv_reduce(part, q_off, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV,
                                Dk=pk, Dv=pv, window=window, chunk=chunk,
                                dtype=q.dtype)
    return _unpad(dk, Dk), _unpad(dv, Dv)


def mla_dkv_reduce(part, q_off, *, B: int, Sq: int, Sk: int, H: int,
                   KV: int, Dk: int, Dv: int, window: int, chunk: int,
                   dtype):
    """dk (B, Sk, KV, Dk) and dv (B, Sk, KV, Dv) in ``dtype`` from the
    tensor-core dk/dv's fp32 partials ``part`` (n_chunks chunks, each dk's
    (B, Sk, KV, Dk) then dv's (B, Sk, KV, Dv)): each key's live chunks
    (:func:`mla_dkv_blocks`) summed in chunk order; the others are never
    read. On the card the kernel ``mla_dkv_reduce`` (counted as
    ``flash_attention_mla_dkv_reduce``), so two calls agree bit for bit;
    ``q_off`` is read on the host only on the CPU."""
    rows = B * Sk * KV
    n_chunks = part.numel() // (rows * (Dk + Dv))
    if K.plain_path(part, q_off):
        bq = MLA_DKV_ROWS // (H // KV)
        nq = -(-Sq // bq)
        n_live = torch.tensor(
            [[-(-mla_dkv_live(key // MLA_DKV_KEYS, int(q_off[b]), window,
                               nq, bq)[1] // chunk) for key in range(Sk)]
             for b in range(B)])
        chunks = part.reshape(n_chunks, rows * (Dk + Dv))
        part_k = chunks[:, :rows * Dk].reshape(n_chunks, B, Sk, KV, Dk)
        part_v = chunks[:, rows * Dk:].reshape(n_chunks, B, Sk, KV, Dv)
        return ref.mla_dkv_reduce_ref(part_k, part_v, n_live, dtype)
    if part.dtype != torch.float32 or not part.is_contiguous():
        raise TypeError("mla_dkv_reduce takes contiguous fp32 partials")
    dk = torch.empty((B, Sk, KV, Dk), dtype=dtype, device=part.device)
    dv = torch.empty((B, Sk, KV, Dv), dtype=dtype, device=part.device)
    if K.launches(part):
        err = K.load("flash_attention").flash_mla_dkv_reduce(
            K.ptr(part), K.ptr(dk), K.ptr(dv), K.ptr(q_off), B, Sq, Sk, H,
            KV, Dk, Dv, K.dtype_code(dk), int(window), chunk,
            K.stream_ptr(part))
        K.check(err, "flash_mla_dkv_reduce")
        K.count("flash_attention_mla_dkv_reduce")
    K.cost("flash_attention_mla_dkv_reduce", lambda: mla_reduce_cost(
        B, Sq, Sk, H, KV, Dk, Dv, q_off, window, chunk, dk.element_size()))
    return dk, dv


def _bwd_inputs(name, q, k, v, lse, do, di):
    """The kernels' inputs: q, k, v and do padded to the kernel head dim
    and TMA-ready, lse and di contiguous fp32."""
    _check_cuda(name, q, k, v)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise TypeError(f"{name}: do {tuple(do.shape)} {do.dtype} does not "
                        f"match q {tuple(q.shape)} {q.dtype}")
    q, k, v, do = pad_head_dim(q.shape[-1], q, k, v, do)
    return (_tma_ready(q), _tma_ready(k), _tma_ready(v), _tma_ready(do),
            lse.float().contiguous(), di.float().contiguous())


def flash_attention_dq(q, k, v, lse, do, di, *, q_off, window: int = 0,
                       sm_scale: float):
    """dq (B, Sq, H, Dk) of the flash forward from its saved lse (B, Sq,
    H) and ``di = rowsum(out do)`` (B, Sq, H), both fp32; ``do`` (B, Sq,
    H, Dv) in q's dtype; ``q_off`` a (B,) int32 tensor."""
    if K.plain_path(q, k, v, lse, do, di):
        return ref.flash_attention_dq_ref(q, k, v, lse, do, di, q_off,
                                          window, sm_scale)
    if mla_route(q.shape[-1], v.shape[-1]):
        return _mla_bwd("dq", q, k, v, lse, do, di, q_off, window, sm_scale)
    D_true = q.shape[-1]
    q, k, v, do, lse, di = _bwd_inputs("flash_attention_dq", q, k, v, lse,
                                       do, di)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if K.launches(q):
        err = K.load("flash_attention").flash_bwd_dq(
            K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(do), K.ptr(lse), K.ptr(di),
            K.ptr(dq), K.ptr(q_off), B, Sq, Sk, H, KV, D, K.dtype_code(q),
            int(window), ctypes.c_float(sm_scale), K.stream_ptr(q))
        K.check(err, "flash_bwd_dq")
        K.count("flash_attention_dq")
    K.cost("flash_attention_dq", lambda: attention_cost(
        "dq", B, Sq, Sk, H, KV, D_true, D_true, q_off, window,
        q.element_size()))
    return _unpad(dq, D_true)


def flash_attention_dkv(q, k, v, lse, do, di, *, q_off, window: int = 0,
                        sm_scale: float):
    """(dk (B, Sk, KV, Dk), dv (B, Sk, KV, Dv)) of the flash forward,
    each summed over the G query heads of its group; inputs as
    :func:`flash_attention_dq`."""
    if K.plain_path(q, k, v, lse, do, di):
        return ref.flash_attention_dkv_ref(q, k, v, lse, do, di, q_off,
                                           window, sm_scale)
    if mla_route(q.shape[-1], v.shape[-1]):
        return _mla_bwd("dkv", q, k, v, lse, do, di, q_off, window, sm_scale)
    D_true = q.shape[-1]
    q, k, v, do, lse, di = _bwd_inputs("flash_attention_dkv", q, k, v, lse,
                                       do, di)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if K.launches(q):
        err = K.load("flash_attention").flash_bwd_dkv(
            K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(do), K.ptr(lse), K.ptr(di),
            K.ptr(dk), K.ptr(dv), K.ptr(q_off), B, Sq, Sk, H, KV, D,
            K.dtype_code(q), int(window), ctypes.c_float(sm_scale),
            K.stream_ptr(q))
        K.check(err, "flash_bwd_dkv")
        K.count("flash_attention_dkv")
    K.cost("flash_attention_dkv", lambda: attention_cost(
        "dkv", B, Sq, Sk, H, KV, D_true, D_true, q_off, window,
        q.element_size()))
    return _unpad(dk, D_true), _unpad(dv, D_true)


def flash_attention_bwd(q, k, v, out, lse, do, *, q_off, window: int = 0,
                        sm_scale: float):
    """(dq, dk, dv) of the flash forward: ``di`` in plain torch, then the
    dq and dk/dv kernels (their plain versions on the CPU)."""
    di = ref.flash_attention_di(out, do)
    kw = dict(q_off=q_off, window=window, sm_scale=sm_scale)
    dq = flash_attention_dq(q, k, v, lse, do, di, **kw)
    dk, dv = flash_attention_dkv(q, k, v, lse, do, di, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``(q, k, v, q_off, window, sm_scale) -> (out, lse)`` with the flash
    backward; lse is marked non-differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, window, sm_scale):
        out, lse = _forward(q, k, v, q_off, window, sm_scale, True)
        ctx.save_for_backward(q, k, v, q_off, out, lse)
        ctx.window, ctx.sm_scale = window, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, q_off, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, q_off=q_off,
                                         window=ctx.window,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, q_off=None, window: int = 0, sm_scale=None,
                    return_lse: bool = False):
    """Fused causal(+window) attention. q (B, Sq, H, Dk), k (B, Sk, KV,
    Dk), v (B, Sk, KV, Dv), H % KV == 0. Returns (B, Sq, H, Dv) [+ lse
    (B, Sq, H) fp32 when ``return_lse``; lse carries no gradient].

    ``q_off``: absolute position of query row 0 — None, an int or a (B,)
    vector. ``window``: sliding window (<= 0 plain causal). ``sm_scale``
    defaults to 1/sqrt(Dk). Differentiable in q, k and v: when autograd
    records, the call goes through :class:`FlashAttention`."""
    B, Sq, H, Dk = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dk)
    window = int(window)
    q_off = _positions(q_off, B, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = FlashAttention.apply(q, k, v, q_off, window,
                                        float(sm_scale))
        return (out, lse) if return_lse else out
    return _forward(q, k, v, q_off, window, float(sm_scale), return_lse)


def decode_plan(lane_len: int, page: int, sm_count: int):
    """(chunk, n_chunks): the decode's split of a lane of ``lane_len`` keys
    into chunks of ``chunk`` keys, a multiple of ``page`` (the page size,
    or ``block_k`` on the contiguous path), one block per chunk, KV head
    and slot. A function of these three alone, so the paged and
    contiguous paths split alike and no device value is read: chunks of
    DECODE_MIN_CHUNK keys while a lane has at most
    DECODE_CHUNKS_PER_SM x ``sm_count`` of them, longer chunks past that
    (fewer partials to merge)."""
    chunk = max(DECODE_MIN_CHUNK,
                -(-lane_len // (DECODE_CHUNKS_PER_SM * sm_count)))
    chunk = _round_up(chunk, page)
    return chunk, -(-lane_len // chunk)


def _decode_call(name, q, k, v, tables, pos, *, S, NP, page, lane_len,
                 window, sm_scale, head_dim):
    """The split kernel's partials in one fp32 workspace, then the combine
    kernel into the output; q, k, v already padded to the kernel head
    dim from the caller's ``head_dim``."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    chunk, ns = decode_plan(lane_len, page, K.sms_of(q))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n_ml = B * KV * ns * G
    ws = torch.empty(n_ml * (2 + D), dtype=torch.float32, device=q.device)
    m, l, acc = (ctypes.c_void_p(ws.data_ptr() + 4 * n_ml * i)
                 for i in range(3))
    lib = K.load("flash_attention") if K.launches(q) else None
    if lib is not None:
        err = lib.flash_decode_split(
            K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(tables), K.ptr(pos), m, l,
            acc, B, H, KV, D, K.dtype_code(q), S, NP, page, chunk, ns,
            lane_len, window, ctypes.c_float(sm_scale), K.stream_ptr(q))
        K.check(err, "flash_decode_split")
        K.count(name)
    K.cost(name, lambda: decode_cost(pos, H, KV, head_dim, q.element_size(),
                                     window, page if NP else 0))
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    _combine_launch(lib, m, l, acc, pos, out, KV, chunk, ns, lane_len,
                    window, head_dim)
    return out


def _combine_launch(lib, m, l, acc, pos, out, KV, chunk, ns, kv_len, window,
                    head_dim):
    B, _, H, D = out.shape
    if lib is not None:
        err = lib.flash_decode_combine(
            m, l, acc, K.ptr(pos), K.ptr(out), B, H, KV, D,
            K.dtype_code(out), chunk, ns, kv_len, window, K.stream_ptr(out))
        K.check(err, "flash_decode_combine")
        K.count("flash_decode_combine")
    K.cost("flash_decode_combine", lambda: combine_cost(
        pos, H, head_dim, out.element_size(), chunk, ns, window))


def decode_combine(m, l, acc, pos, *, chunk: int, kv_len: int,
                   window: int = 0, dtype=torch.float32):
    """The online-softmax merge of decode partials m/l (B, KV, ns, G) and
    acc (B, KV, ns, G, D), fp32, over the chunks of ``chunk`` keys that
    hold a key visible from ``pos`` (B,) (``kv_len`` keys a lane, the
    ``window``); the others are never read. Returns (B, 1, KV * G, D) in
    ``dtype``. On the card the kernel ``flash_decode_combine``, in chunk
    order, so two calls agree bit for bit."""
    B, KV, ns, G = m.shape
    D = acc.shape[-1]
    pos = _positions(pos, B, m.device)
    if K.plain_path(m, l, acc, pos):
        return ref.combine_live_splits(m, l, acc, pos, window, chunk,
                                       kv_len).to(dtype)
    if not (m.dtype == l.dtype == acc.dtype == torch.float32):
        raise TypeError("decode_combine takes fp32 partials")
    m, l, acc = m.contiguous(), l.contiguous(), acc.contiguous()
    out = torch.empty((B, 1, KV * G, D), dtype=dtype, device=m.device)
    _combine_launch(K.load("flash_attention") if K.launches(m) else None,
                    K.ptr(m), K.ptr(l),
                    K.ptr(acc), pos, out, KV, chunk, ns, kv_len, int(window),
                    D)
    return out


def flash_decode(q, k, v, pos, *, window: int = 0, sm_scale=None,
                 block_k: int = DEFAULT_DECODE_BLOCK_K):
    """Split-KV one-token decode. q (B, 1, H, Dk); k/v the full (B, S, KV,
    D) cache lanes; pos an int or (B,) per-slot positions (key t visible
    iff t <= pos[b] and within the window). On the CPU the plain version
    splits the lanes into ceil(S / block_k) partials; on the card into
    :func:`decode_plan`'s chunks, multiples of ``block_k``. The partials
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
    if K.plain_path(q, k, v):
        return ref.flash_decode_ref(q, k, v, pos, window, sm_scale, block_k)
    _check_cuda("flash_decode", q, k, v, decode=True)
    qp, kp, vp = pad_head_dim(Dk, q, k, v)
    out = _decode_call("flash_decode", qp, kp, vp, None, pos, S=S, NP=0,
                       page=block_k, lane_len=S, window=window,
                       sm_scale=sm_scale, head_dim=Dk)
    return _unpad(out, Dk)


def flash_decode_paged(q, k_pages, v_pages, tables, pos, *, page_size: int,
                       window: int = 0, sm_scale=None):
    """Split-KV decode over a paged cache: logical page j of slot b is
    physical page ``tables[b, j]``. q (B, 1, H, Dk); k_pages/v_pages (P,
    page_size, KV, D); tables (B, NP) int32; pos (B,). Only the pages that
    hold a visible key are read, so whatever page the table maps past
    ``pos // page_size`` (typically the null page 0) never reaches the
    result. Returns (B, 1, H, Dv), equal to ``flash_decode`` on the
    gathered lanes with ``block_k=page_size``."""
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
    _check_cuda("flash_decode_paged", q, k_pages, v_pages, decode=True)
    tables = tables.to(torch.int32).reshape(B, NP).contiguous()
    qp, kp, vp = pad_head_dim(Dk, q, k_pages, v_pages)
    out = _decode_call("flash_decode_paged", qp, kp, vp, tables, pos, S=0,
                       NP=NP, page=page_size, lane_len=NP * page_size,
                       window=window, sm_scale=sm_scale, head_dim=Dk)
    return _unpad(out, Dk)
