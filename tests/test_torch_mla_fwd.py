"""The MLA route's forward on the tensor cores, checked on the CPU:

- the route table: which kernel a forward call reaches at each built
  (Dk, Dv) pair and at padded ones, in fp32, bf16 and fp16 (the wrapper's
  host side with the CUDA library swapped for a recorder, as in
  ``test_torch_mla_bwd.py``), TMA-ready inputs from an unaligned view,
  and the refusals past (576, 512) and G 16;
- a plain-torch model of what ``fwd_mla_hopper`` sums: q tiles of 64
  rows, key tiles of 32 keys scored in two halves of 16 (one a
  warpgroup), the tile's maximum taken over both halves, P rounded to
  v's dtype, each half's own l, added once at the end; held to JAX's
  ``_fwd_call`` (the Pallas forward, interpret mode) at Dk 96 / Dv 64
  over G 4 and at Dk 576 / Dv 512 over G 16, with a window, with a
  non-zero ``q_off``, and with rows of a live tile that see no key (the
  explicit zeroing of p).

Tolerances: out within 1e-5 (fp32) and 1e-2 (bf16, ``FWD_TOL`` of the
card's checks) of the output's largest magnitude: both sum in fp32, in
another order, and bf16 rounds P and the output once each; lse within
1e-3.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_mla_bwd import _Recorder  # noqa: E402

FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
Q_ROWS, KEYS, HALF = 64, 32, 16      # csrc HB_M, MB_N, one warpgroup's keys


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (a
    file run earlier in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

@pytest.fixture
def host_side(monkeypatch):
    """The MLA forward's CUDA path on CPU tensors with the library
    replaced by a recorder."""
    lib = _Recorder()
    monkeypatch.setattr(K, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "load", lambda name: lib)
    monkeypatch.setattr(K, "stream_ptr", lambda t: None)
    K.reset_launches()
    return lib


def _unaligned(dtype, *shape):
    """Zeros of ``shape`` as a contiguous view one element into its
    storage: 2 or 4 bytes past a 16-byte boundary."""
    n = math.prod(shape)
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dims,fp32_pair", [
    ((96, 64), (96, 64)), ((576, 512), (576, 512)),
    ((80, 64), (96, 64)),          # the smoke config's layout, padded
    ((300, 200), (576, 512)),      # padded up to the largest pair
])
def test_route_table(host_side, dtype, dims, fp32_pair):
    """fp32 reaches ``flash_mla_fwd`` at the smallest built pair that holds
    the dims (the CUDA-core ``fwd_kernel``); bf16 and fp16 at (576, 512)
    (``fwd_mla_hopper``), q, k and v 16-byte aligned even from unaligned
    views. One launch; out comes back at the true Dv, lse at (B, S, H)."""
    B, Sq, Sk, H, KV = 2, 100, 130, 16, 1
    Dk, Dv = dims
    q, k, v = (_unaligned(dtype, B, Sq, H, Dk), _unaligned(dtype, B, Sk, KV, Dk),
               _unaligned(dtype, B, Sk, KV, Dv))
    q_off = torch.tensor([30, 0], dtype=torch.int32)
    out, lse = tfa.flash_attention(q, k, v, q_off=q_off, window=9,
                                   sm_scale=0.1, return_lse=True)
    assert out.shape == (B, Sq, H, Dv) and out.dtype == dtype
    assert lse.shape == (B, Sq, H) and lse.dtype == torch.float32
    (name, args), = host_side.calls
    assert name == "flash_mla_fwd"
    pair = fp32_pair if dtype == torch.float32 else tfa.MLA_TC_PAIR
    # (B, Sq, Sk, H, KV, Dk, Dv, dtype, window) after the six pointers
    assert args[6:15] == (B, Sq, Sk, H, KV) + pair + (DTYPE_CODE[dtype], 9)
    if dtype != torch.float32:
        assert all(a.value % 16 == 0 for a in args[:3])
    assert K.LAUNCHES == {"flash_attention_mla": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_route_refuses_by_name(host_side, dtype):
    """Past Dk 576 / Dv 512, or at G 17, the forward raises before any
    kernel, naming what it exceeds."""
    for (Dk, Dv), H, match in (((577, 512), 16, "Dk=577, Dv=512 are more"),
                               ((576, 513), 16, "Dk=576, Dv=513 are more"),
                               ((576, 512), 17, "G = 17 > 16, .*MLA")):
        z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
        with pytest.raises(NotImplementedError, match=match):
            tfa.flash_attention(z(1, 8, H, Dk), z(1, 8, 1, Dk),
                                z(1, 8, 1, Dv), return_lse=True)
    assert host_side.calls == []


# ---------------------------------------------------------------------------
# a model of the kernel's sums against the Pallas forward
# ---------------------------------------------------------------------------

def _model_fwd(q, k, v, q_off, window, scale):
    """(out, lse) as ``fwd_mla_hopper`` sums them, in plain torch: per q
    tile of Q_ROWS rows (Q_ROWS // G queries) its live key tiles of KEYS
    keys in order; scores in log2 units; the element mask on tiles that
    cross the diagonal, the window edge or the ragged end; each half's l
    (the keys of one warpgroup) rescaled by the common alpha; out divided
    by l0 + l1 clamped at 1e-30."""
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    bq, nk = Q_ROWS // G, -(-Sk // KEYS)
    neg = ref.NEG_INF
    scale2 = scale / math.log(2)
    qf = q.float().reshape(B, Sq, KV, G, Dk)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, nk * KEYS - Sk))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, nk * KEYS - Sk))
    out = torch.zeros(B, Sq, KV, G, Dv)
    lse = torch.zeros(B, Sq, KV, G)
    for b in range(B):
        for i in range(-(-Sq // bq)):
            rows = slice(i * bq, min(Sq, (i + 1) * bq))
            qpos = int(q_off[b]) + torch.arange(rows.start, rows.stop)
            first_q, last_q = int(qpos[0]), int(qpos[-1])
            j_lo = max(0, (first_q - window + 1) // KEYS) if window > 0 else 0
            j_hi = min(nk - 1, last_q // KEYS)
            m = torch.full((len(qpos), KV, G), neg)
            l = torch.zeros(2, len(qpos), KV, G)
            acc = torch.zeros(len(qpos), KV, G, Dv)
            for j in range(j_lo, j_hi + 1):
                k0 = j * KEYS
                keys = slice(k0, k0 + KEYS)
                x = torch.einsum("qkgd,tkd->qkgt", qf[b, rows],
                                 kf[b, keys]) * scale2
                edge = (k0 + KEYS > Sk or k0 + KEYS - 1 > first_q
                        or (window > 0 and last_q - k0 >= window))
                masked = torch.zeros(len(qpos), 1, 1, KEYS, dtype=torch.bool)
                if edge:
                    kpos = torch.arange(k0, k0 + KEYS)
                    keep = ref._keep(qpos[:, None], kpos[None], window) \
                        & (kpos < Sk)[None]
                    masked = ~keep[:, None, None, :]
                    x = torch.where(masked, neg, x)
                halves = x.reshape(*x.shape[:-1], 2, HALF)
                m_next = torch.maximum(m, halves.amax(-1).amax(-1))
                alpha = torch.exp2(m - m_next)
                m = m_next
                p = torch.exp2(x - m[..., None])
                p = torch.where(masked, 0.0, p)
                ph = p.reshape(*p.shape[:-1], 2, HALF).sum(-1)
                l = l * alpha + ph.movedim(-1, 0)
                acc = acc * alpha[..., None] + torch.einsum(
                    "qkgt,tkd->qkgd", p.to(v.dtype).float(), vf[b, keys])
            lc = (l[0] + l[1]).clamp_min(1e-30)
            out[b, rows] = acc / lc[..., None]
            lse[b, rows] = torch.where(m == neg, neg, m * math.log(2)) \
                + torch.log(lc)
    return out.reshape(B, Sq, H, Dv).to(q.dtype), lse.reshape(B, Sq, H)


def _jax_fwd(q, k, v, q_off, window, scale, block):
    """JAX's ``_fwd_call`` (the Pallas forward, interpret mode) on the same
    inputs; S a multiple of ``block``."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    qo = jnp.asarray(q_off.numpy(), jnp.int32).reshape(-1, 1)
    win = jnp.asarray(window, jnp.int32).reshape(1, 1)
    out, lse = jfa._fwd_call(j(q), j(k), j(v), qo, win, scale, k.shape[1],
                             block, block, True)
    return (torch.tensor(np.asarray(out.astype(jnp.float32))),
            torch.tensor(np.asarray(lse)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,q_off", [
    ((2, 32, 8, 2, 96, 64), 7, (0, 5)),      # G 4 over KV 2, a window
    ((1, 72, 4, 1, 96, 64), 0, (3,)),        # G 4, 3 key tiles, ragged
    ((1, 32, 8, 2, 96, 64), 9, (36,)),       # rows past the keys' window
    ((1, 32, 16, 1, 576, 512), 0, (0,)),     # DeepSeek-V2-Lite's layout
    ((1, 32, 16, 1, 576, 512), 9, (2,)),
])
def test_kernel_sums_match_pallas_fwd(dtype, shape, window, q_off):
    """The model of the tensor-core forward's sums against JAX's forward
    in interpret mode."""
    B, S, H, KV, Dk, Dv = shape
    rng = np.random.default_rng(S + Dk + window)
    rn = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    q, k, v = rn(B, S, H, Dk), rn(B, S, KV, Dk), rn(B, S, KV, Dv)
    qo = torch.tensor(q_off, dtype=torch.int32)
    scale = 1 / math.sqrt(Dk)
    out, lse = _model_fwd(q, k, v, qo, window, scale)
    want, want_lse = _jax_fwd(q, k, v, qo, window, scale, 8)
    assert out.shape == want.shape and out.dtype == dtype
    err = (out.float() - want).abs().max().item()
    assert err <= FWD_TOL[dtype] * want.abs().max().item(), err
    assert (lse - want_lse).abs().max().item() <= 1e-3
