"""Mamba-2 SSD (state-space duality) block (counterpart of
``repro/models/ssm.py``).  [arXiv:2405.21060]

Training and prefill run the SSD *chunked* algorithm: within a chunk of
``s.chunk`` positions the selective scan is a masked quadratic form
(batched matmuls), and a loop over chunks carries the fp32 state from one
chunk to the next (the JAX package's ``lax.scan``). Decode keeps the O(1)
recurrent update: h <- exp(dt*A) h + dt * B x ; y = C h + D x.

Every contraction is written as an elementwise product and one matmul in
a fixed order (no ``einsum`` whose contraction path could change with the
shapes), so a prompt prefilled in chunks aligned to ``s.chunk`` leaves
the cache bit for bit where a single-call prefill leaves it. The reference
computes none of this in a Pallas kernel, so none of it has a hand kernel.

Caches update in place: ``ssm_decode`` and ``ssm_prefill`` write the new
conv window and state into the tensors they are given and return the same
dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.common import dense_init, rms_norm


def d_inner_of(d_model: int, s: SSMConfig) -> int:
    return s.expand * d_model


def num_heads_of(d_model: int, s: SSMConfig) -> int:
    return d_inner_of(d_model, s) // s.head_dim


def init_ssm(gen: torch.Generator, d_model: int, s: SSMConfig, dtype,
             device=None):
    """The block's parameters from ``gen``: z/x/BC/dt projections and the
    output projection as ``(in, out)`` operands, the depthwise conv, and
    per head A (in -exp log space), the dt bias and the D skip (fp32), with
    the gated RMSNorm scale."""
    di = d_inner_of(d_model, s)
    nh = num_heads_of(d_model, s)
    G, N = s.ngroups, s.state_dim
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.empty((s.conv_width, di + 2 * G * N), **f32)
    conv_w.normal_(0.0, 0.1, generator=gen)
    u = torch.empty((nh,), **f32).uniform_(0.0, 1.0, generator=gen)
    return {
        "wz": dense_init(gen, d_model, (di,), dtype, device),
        "wx": dense_init(gen, d_model, (di,), dtype, device),
        "wbc": dense_init(gen, d_model, (2 * G * N,), dtype, device),
        "wdt": dense_init(gen, d_model, (nh,), dtype, device),
        "out_proj": dense_init(gen, di, (d_model,), dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di + 2 * G * N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.log(torch.expm1((u * 0.1 + 0.001).clamp(1e-4,
                                                                 0.1))),
        "D": torch.ones((nh,), **f32),
        "norm": torch.zeros((di,), **f32),
    }


def _project(p, x):
    """x (..., d) -> z (..., di), xBC (..., di + 2GN), dt (..., nh)."""
    z = torch.matmul(x, p["wz"])
    xs = torch.matmul(x, p["wx"])
    bc = torch.matmul(x, p["wbc"])
    dt = torch.matmul(x, p["wdt"])
    return z, torch.cat([xs, bc], dim=-1), dt


def _conv_taps(win, w, S: int):
    """sum_i win[:, i:i+S] * w[i] in fp32, tap by tap in order: the one
    multiply-add order both the conv and the prefill's windowed conv use
    (what keeps a chunked prefill bitwise equal to a single call)."""
    out = torch.zeros(win.shape[0], S, win.shape[2], dtype=torch.float32,
                      device=win.device)
    for i in range(w.shape[0]):
        out = out + win[:, i:i + S].float() * w[i].float()
    return out


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along seq. xBC (B, S, D), w (W, D)."""
    W = w.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = _conv_taps(pad, w, xBC.shape[1])
    return F.silu(out + b.float()).to(xBC.dtype)


def _segsum(x):
    """Stable segment sum: out[..., i, j] = sum_{j<k<=i} x[..., k], and
    -inf above the diagonal. The mask is filled before the caller's
    ``exp``: multiplying by a mask after it would put inf * 0 = NaN into
    the backward."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def _heads_major(t):
    """(b, c, q, h, ...) -> (b, c, h, q, ...)."""
    return t.transpose(2, 3)


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD forward.

    x (b, s, h, p), dt (b, s, h), A (h,) negative, B and C (b, s, g, n).
    Returns y (b, s, h, p) in x's dtype and the final state (b, h, n, p)
    fp32. ``init_state`` (b, h, n, p; zeros when None) seeds the
    inter-chunk recurrence, so a long prompt can be prefilled in
    consecutive calls with the state carried through the cache. Positions
    with dt == 0 are exact no-ops on the state (decay 1, contribution 0),
    which keeps both the chunk padding here and the engine's prompt
    padding transparent."""
    b, S0, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    Q = chunk
    pad = (-S0) % Q
    if pad:
        # zero dt on padding: decay 1, contribution 0
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S = S0 + pad
    nc = S // Q
    rep = h // g

    xc = x.float().reshape(b, nc, Q, h, p)
    dtc = dt.float().reshape(b, nc, Q, h)
    Bc = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, Q, h, n)
    Cc = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, Q, h, n)
    dA = dtc * A                                          # (b, nc, Q, h)
    xh = _heads_major(xc)                                 # (b, nc, h, Q, p)
    Ch = _heads_major(Cc)                                 # (b, nc, h, Q, n)

    # 1. intra-chunk (diagonal block) output
    L = torch.exp(_segsum(dA.transpose(2, 3)))            # (b, nc, h, Q, Q)
    scores = torch.matmul(Ch, _heads_major(Bc).transpose(-1, -2))
    M = scores * L * dtc.transpose(2, 3)[..., None, :]    # over keys k
    y_diag = torch.matmul(M, xh)                          # (b, nc, h, Q, p)

    # 2. each chunk's end state
    dA_cum = torch.cumsum(dA, dim=2)                      # (b, nc, Q, h)
    decay_to_end = torch.exp(dA_cum[:, :, -1:] - dA_cum)
    Bw = Bc * (decay_to_end * dtc)[..., None]             # (b, nc, Q, h, n)
    states = torch.matmul(_heads_major(Bw).transpose(-1, -2), xh)

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1])             # (b, nc, h)
    carry = (torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b, nc, h, n, p)

    # 4. inter-chunk (off-diagonal) output
    decay_in = torch.exp(dA_cum)                          # (b, nc, Q, h)
    y_off = torch.matmul(Ch * decay_in.transpose(2, 3)[..., None],
                         prev_states)                     # (b, nc, h, Q, p)

    y = _heads_major(y_diag + y_off).reshape(b, S, h, p)[:, :S0]
    return y.to(x.dtype), carry


def _dt_and_A(p, dt):
    return (F.softplus(dt.float() + p["dt_bias"]), -torch.exp(p["A_log"]))


def _split_xBC(xBC, shape, d_model: int, s: SSMConfig):
    """xBC (*shape, di + 2GN) -> x (*shape, nh, P), B and C (*shape, G,
    N)."""
    di = d_inner_of(d_model, s)
    G, N = s.ngroups, s.state_dim
    return (xBC[..., :di].reshape(*shape, num_heads_of(d_model, s),
                                  s.head_dim),
            xBC[..., di:di + G * N].reshape(*shape, G, N),
            xBC[..., di + G * N:].reshape(*shape, G, N))


def _gated_out(p, y, xs, z, eps: float, norm_reduce=None):
    """y + D x, the gated RMSNorm norm(y * silu(z)), the out projection.
    y, xs (B, S, nh, P); z (B, S, di)."""
    B_, S_ = y.shape[:2]
    y = y + xs.float().to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B_, S_, -1)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], eps,
                 norm_reduce)
    return torch.matmul(y, p["out_proj"])


def ssm_forward(p, x, d_model: int, s: SSMConfig, eps: float = 1e-5,
                norm_reduce=None):
    """Training / prefill SSD block. x (B, S, d) -> (B, S, d).
    ``norm_reduce``: the gated norm's reduction over heads held by other
    devices (``models/tp.py``'s ``ssm_local``)."""
    B_, S_, _ = x.shape
    z, xBC, dt = _project(p, x)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _split_xBC(xBC, (B_, S_), d_model, s)
    dt, A = _dt_and_A(p, dt)
    y, _ = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk)
    return _gated_out(p, y, xs, z, eps, norm_reduce)


# ---------------------------------------------------------------------------
# recurrent decode
# ---------------------------------------------------------------------------

def ssm_init_cache(batch: int, d_model: int, s: SSMConfig, dtype,
                   device=None):
    """{"conv": (batch, W - 1, di + 2GN) in ``dtype``, "state": (batch,
    nh, N, P) fp32}, zeros."""
    di = d_inner_of(d_model, s)
    nh = num_heads_of(d_model, s)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1,
                             di + 2 * s.ngroups * s.state_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nh, s.state_dim, s.head_dim),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p, cache, x, d_model: int, s: SSMConfig, eps: float = 1e-5,
               norm_reduce=None):
    """Single-token recurrent step. x (B, 1, d). Writes the cache in
    place; returns (y (B, 1, d), cache). ``norm_reduce`` as in
    :func:`ssm_forward`."""
    nh = num_heads_of(d_model, s)
    Bsz = x.shape[0]
    z, xBC, dt = _project(p, x[:, 0])                          # (B, .)
    # the conv over the rolling window
    win = torch.cat([cache["conv"], xBC[:, None, :].to(cache["conv"].dtype)],
                    dim=1)
    conv_out = (win.float() * p["conv_w"].float()).sum(dim=1)
    xBC = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)
    xs, Bm, Cm = _split_xBC(xBC, (Bsz,), d_model, s)
    rep = nh // s.ngroups
    Bh = Bm.float().repeat_interleave(rep, dim=1)              # (B, nh, N)
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    dt, A = _dt_and_A(p, dt)                                   # (B, nh)
    decay = torch.exp(dt * A)
    h = cache["state"] * decay[..., None, None] + (
        Bh * dt[..., None])[..., :, None] * xs.float()[:, :, None, :]
    y = torch.matmul(Ch[:, :, None, :], h)[:, :, 0]            # (B, nh, P)
    y = (y + xs.float() * p["D"][None, :, None]).reshape(Bsz, 1, -1)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype)[:, None, :], p["norm"],
                 eps, norm_reduce)
    out = torch.matmul(y, p["out_proj"])
    cache["conv"].copy_(win[:, 1:])
    cache["state"].copy_(h)
    return out, cache


# ---------------------------------------------------------------------------
# chunked prefill (serving)
# ---------------------------------------------------------------------------

def ssm_prefill(p, cache, x, valid: int, d_model: int, s: SSMConfig,
                eps: float = 1e-5):
    """Whole-chunk prefill that also writes the recurrent cache.

    x (B, C, d) is one prompt chunk; its first ``valid`` positions are
    real tokens. Pad positions are kept out of the state (dt = 0 is an
    exact no-op) and out of the conv tail, so a prompt prefilled in chunks
    of C ends with the cache bit for bit where a single-call prefill
    leaves it, as long as C is a multiple of ``s.chunk``.

    The first chunk of a prompt expects a zeroed conv/state lane (a fresh
    cache, or the engine's ``reset_slot_ssm`` at admission): the state
    carries across calls by design. Writes ``cache["conv"]`` (the last
    W - 1 valid inputs) and ``cache["state"]`` (the state after position
    valid - 1) in place; returns (y (B, C, d), cache)."""
    B_, C_, _ = x.shape
    W = s.conv_width
    valid = int(valid)
    z, xBC, dt = _project(p, x)
    # the causal conv over the cached history window instead of zero
    # padding, in _causal_conv's multiply-add order
    win = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)
    xBC = F.silu(_conv_taps(win, p["conv_w"], C_)
                 + p["conv_b"].float()).to(x.dtype)
    # rows [valid, valid + W - 2] of win are the last W - 1 valid inputs
    new_conv = win[:, valid:valid + W - 1]
    xs, Bm, Cm = _split_xBC(xBC, (B_, C_), d_model, s)
    dt, A = _dt_and_A(p, dt)
    pad = torch.arange(C_, device=x.device) >= valid
    dt = dt.masked_fill(pad[None, :, None], 0.0)
    y, final = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk,
                           init_state=cache["state"])
    out = _gated_out(p, y, xs, z, eps)
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(final)
    return out, cache


# ---------------------------------------------------------------------------
# naive reference (oracle for tests)
# ---------------------------------------------------------------------------

def ssd_naive(x, dt, A, B, C):
    """Sequential recurrence oracle, O(S) steps. Shapes as ssd_chunked."""
    b, S, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bf = B.float().repeat_interleave(rep, dim=2)
    Cf = C.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    hst = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)                      # (b, h)
        hst = hst * decay[..., None, None] + (
            Bf[:, t] * dtf[:, t, :, None])[..., None] * xf[:, t, :, None, :]
        ys.append(torch.matmul(Cf[:, t, :, None, :], hst)[:, :, 0])
    return torch.stack(ys, dim=1).to(x.dtype), hst
