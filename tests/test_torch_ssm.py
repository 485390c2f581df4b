"""Mamba-2's SSD block, port (``repro_torch.models.ssm``) against the JAX
package (``repro.models.ssm``) at fp32 on the CPU, on numpy inputs from a
seed: ``ssd_chunked`` (S not a multiple of the chunk, an ``init_state``,
ngroups > 1) against JAX's and against the sequential ``ssd_naive``;
``ssm_forward``, ``ssm_decode`` and ``ssm_prefill`` (full and padded
chunks, a carried cache) against JAX's; the gradients of ``ssd_chunked``
against JAX's; and the port's own invariants: pad positions are exact
no-ops on the state, a prefill chunk by chunk equals one call bit for bit,
and prefill + decode equals the full-sequence forward.

Tolerances: 1e-5 of the output's largest magnitude (fp32, sums in
another order); gradients 1e-4 relative Frobenius error.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

GRAD_TOL = 1e-4
D_MODEL = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke shapes gain nothing from intra-op threads, and the suite's
    workers share the host's cores: one thread a worker for this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types. A
    test file run earlier in the same process may leave a global
    ``jax.set_mesh`` with explicit axes behind."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _ssd_inputs(seed, b, S, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(b, S, h, p), dt=np.abs(f(b, S, h)) * 0.3,
                A=-np.exp(f(h)).astype(np.float32), B=f(b, S, g, n),
                C=f(b, S, g, n), state=f(b, h, n, p))


SSD_CASES = {   # (b, S, h, p, g, n, chunk, init_state)
    "aligned": (2, 32, 4, 8, 1, 6, 8, False),
    "ragged": (2, 37, 4, 8, 1, 6, 8, False),
    "groups": (1, 29, 6, 4, 3, 5, 8, False),
    "init_state": (2, 21, 4, 8, 2, 6, 8, True),
    "one_chunk": (1, 5, 2, 4, 1, 3, 16, True),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunked_matches_jax(case):
    b, S, h, p, g, n, chunk, init = SSD_CASES[case]
    a = _ssd_inputs(1, b, S, h, p, g, n)
    args = [a[k] for k in ("x", "dt", "A", "B", "C")]
    st = a["state"] if init else None
    jy, jf = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                              init_state=None if st is None
                              else jnp.asarray(st))
    ty, tf = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                              init_state=None if st is None
                              else torch.from_numpy(st))
    assert ty.shape == (b, S, h, p) and tf.shape == (b, h, n, p)
    _close(ty, jy)
    _close(tf, jf)


@pytest.mark.parametrize("case", ["aligned", "ragged", "groups"])
def test_ssd_chunked_matches_the_sequential_oracle(case):
    """The chunked form equals the O(S) recurrence, on the port's own
    ``ssd_naive`` and on JAX's."""
    b, S, h, p, g, n, chunk, _ = SSD_CASES[case]
    a = _ssd_inputs(2, b, S, h, p, g, n)
    args = [torch.from_numpy(a[k]) for k in ("x", "dt", "A", "B", "C")]
    ty, tf = tssm.ssd_chunked(*args, chunk)
    ny, nf = tssm.ssd_naive(*args)
    jy, jf = jssm.ssd_naive(*(jnp.asarray(t.numpy()) for t in args))
    _close(ny, jy)
    _close(nf, jf)
    _close(ty, ny.numpy())
    _close(tf, nf.numpy())


def test_ssd_chunked_gradients_match_jax():
    """Every input's gradient through the -inf segment mask, the chunk
    recurrence and a carried state; no NaN from the masked exponent."""
    b, S, h, p, g, n, chunk = 2, 21, 4, 8, 2, 6, 8
    a = _ssd_inputs(3, b, S, h, p, g, n)
    names = ("x", "dt", "A", "B", "C", "state")
    w = np.random.default_rng(4).standard_normal((b, S, h, p)).astype(
        np.float32)

    def jloss(x, dt, A, B, C, st):
        y, f = jssm.ssd_chunked(x, dt, A, B, C, chunk, init_state=st)
        return jnp.sum(y * w) + jnp.sum(f * f)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in names))
    ts = [torch.from_numpy(a[k]).requires_grad_(True) for k in names]
    y, f = tssm.ssd_chunked(*ts[:5], chunk, init_state=ts[5])
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum()
                             + (f * f).sum(), ts)
    for name, x, want in zip(names, tg, jg):
        assert torch.isfinite(x).all(), name
        assert _rel(x.numpy(), want) <= GRAD_TOL, name


def test_segsum_masks_before_the_exponent():
    """Above the diagonal the segment sum is -inf (exp 0), and its
    gradient there is 0, not NaN."""
    x = torch.randn(2, 5, requires_grad=True)
    s = tssm._segsum(x)
    assert torch.isinf(s.triu(1)[..., 0, 1:]).all()
    torch.exp(s).sum().backward()
    assert torch.isfinite(x.grad).all()
    want = jssm._segsum(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(torch.exp(s).detach().numpy(),
                               np.exp(np.asarray(want)), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the block: forward, decode, prefill
# ---------------------------------------------------------------------------

def _block(ngroups=1, seed=0):
    """(JAX config, port config, numpy params) of one SSD block at
    d_model 64: 4 heads of 32, state 8, chunk 8."""
    kw = dict(state_dim=8, head_dim=32, expand=2, chunk=8, ngroups=ngroups)
    tc = TSSM(**kw)
    tp = tssm.init_ssm(torch.Generator().manual_seed(seed), D_MODEL, tc,
                       torch.float32)
    p = {k: v.numpy() for k, v in tp.items()}
    # a non-zero conv bias and norm scale, so both are exercised
    rng = np.random.default_rng(seed + 10)
    p["conv_b"] = (rng.standard_normal(p["conv_b"].shape) * 0.1).astype(
        np.float32)
    p["norm"] = (rng.standard_normal(p["norm"].shape) * 0.1).astype(np.float32)
    return JSSM(**kw), tc, p


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tp(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_init_matches_the_reference_tree():
    """The port's init gives the reference's leaves, shapes and dtypes, and
    the reference's A, D and norm values (they draw no randomness)."""
    jc, tc, p = _block(ngroups=2)
    want = jax.eval_shape(lambda: jssm.init_ssm(jax.random.key(0), D_MODEL,
                                                jc, jnp.float32))
    assert sorted(want) == sorted(p)
    for k, v in want.items():
        assert p[k].shape == v.shape and p[k].dtype == v.dtype, k
    ref = jssm.init_ssm(jax.random.key(0), D_MODEL, jc, jnp.float32)
    for k in ("A_log", "D"):
        np.testing.assert_allclose(p[k], np.asarray(ref[k]), rtol=1e-6)
    dt = np.log(np.expm1(0.1))       # softplus^-1 of the largest dt
    assert (p["dt_bias"] <= dt + 1e-6).all()


@pytest.mark.parametrize("ngroups", [1, 2])
def test_ssm_forward_matches_jax(ngroups):
    jc, tc, p = _block(ngroups)
    x = _x(5, 2, 19, D_MODEL)
    want = jssm.ssm_forward(_jp(p), jnp.asarray(x), D_MODEL, jc)
    got = tssm.ssm_forward(_tp(p), torch.from_numpy(x), D_MODEL, tc)
    _close(got, want)


def _cache(tc, p, seed, batch):
    """A cache with random conv history and state, on both sides."""
    c = tssm.ssm_init_cache(batch, D_MODEL, tc, torch.float32)
    rng = np.random.default_rng(seed)
    c = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
         for k, v in c.items()}
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: torch.from_numpy(v.copy()) for k, v in c.items()})


@pytest.mark.parametrize("ngroups", [1, 2])
def test_ssm_decode_matches_jax(ngroups):
    """Two recurrent steps from a random cache: outputs and the cache."""
    jc, tc, p = _block(ngroups)
    jcache, tcache = _cache(tc, p, 6, 3)
    for step in range(2):
        x = _x(7 + step, 3, 1, D_MODEL)
        jy, jcache = jssm.ssm_decode(_jp(p), jcache, jnp.asarray(x), D_MODEL,
                                     jc)
        ty, tcache = tssm.ssm_decode(_tp(p), tcache, torch.from_numpy(x),
                                     D_MODEL, tc)
        _close(ty, jy)
        for k in ("conv", "state"):
            _close(tcache[k], jcache[k])


@pytest.mark.parametrize("C,valid,carried", [(16, 16, False), (16, 11, False),
                                             (24, 5, True)])
def test_ssm_prefill_matches_jax(C, valid, carried):
    """A prefill chunk (``valid`` real positions, the rest pad) from a zero
    or a carried cache: outputs at the valid positions and the cache."""
    jc, tc, p = _block(2)
    if carried:
        jcache, tcache = _cache(tc, p, 8, 2)
    else:
        tcache = tssm.ssm_init_cache(2, D_MODEL, tc, torch.float32)
        jcache = jssm.ssm_init_cache(2, D_MODEL, jc, jnp.float32)
    x = _x(9, 2, C, D_MODEL)
    jy, jcache = jssm.ssm_prefill(_jp(p), jcache, jnp.asarray(x), valid,
                                  D_MODEL, jc)
    ty, tcache = tssm.ssm_prefill(_tp(p), tcache, torch.from_numpy(x), valid,
                                  D_MODEL, tc)
    _close(ty[:, :valid], np.asarray(jy)[:, :valid])
    for k in ("conv", "state"):
        _close(tcache[k], jcache[k])


def test_prefill_pad_positions_are_exact_noops():
    """A chunk of 11 real tokens then 5 pad tokens leaves the cache bit for
    bit where the 11 tokens alone (padded to 16 with other junk) leave
    it: dt = 0 and the conv tail skip the pad."""
    _, tc, p = _block()
    x = _x(10, 1, 16, D_MODEL)
    other = x.copy()
    other[:, 11:] = _x(11, 1, 5, D_MODEL) * 3
    caches = []
    for inp in (x, other):
        c = tssm.ssm_init_cache(1, D_MODEL, tc, torch.float32)
        y, c = tssm.ssm_prefill(_tp(p), c, torch.from_numpy(inp), 11,
                                D_MODEL, tc)
        caches.append((y, c))
    (y0, c0), (y1, c1) = caches
    assert torch.equal(y0[:, :11], y1[:, :11])
    for k in ("conv", "state"):
        assert torch.equal(c0[k], c1[k]), k


def test_chunked_prefill_equals_one_call_bitwise():
    """A 40-token prompt in chunks of 16 (the last 8 of 16 valid) against
    one 40-token call: the last logits' block output and every cache leaf
    bit for bit (chunk boundaries aligned to the SSD chunk of 8)."""
    _, tc, p = _block(2)
    x = _x(12, 1, 40, D_MODEL)
    cc = tssm.ssm_init_cache(1, D_MODEL, tc, torch.float32)
    for c in range(0, 40, 16):
        sl = x[:, c:c + 16]
        v = sl.shape[1]
        sl = np.pad(sl, ((0, 0), (0, 16 - v), (0, 0)))
        y, cc = tssm.ssm_prefill(_tp(p), cc, torch.from_numpy(sl), v,
                                 D_MODEL, tc)
    cr = tssm.ssm_init_cache(1, D_MODEL, tc, torch.float32)
    yr, cr = tssm.ssm_prefill(_tp(p), cr, torch.from_numpy(x), 40, D_MODEL,
                              tc)
    assert torch.equal(y[:, v - 1], yr[:, -1])
    for k in ("conv", "state"):
        assert torch.equal(cc[k], cr[k]), k


def test_prefill_then_decode_equals_the_forward():
    """Prefill 13 tokens, decode 4 more one at a time: each output equals
    ssm_forward over the whole 17-token sequence at that position."""
    _, tc, p = _block(2)
    x = _x(13, 2, 17, D_MODEL)
    want = tssm.ssm_forward(_tp(p), torch.from_numpy(x), D_MODEL, tc)
    c = tssm.ssm_init_cache(2, D_MODEL, tc, torch.float32)
    y, c = tssm.ssm_prefill(_tp(p), c, torch.from_numpy(x[:, :13]), 13,
                            D_MODEL, tc)
    _close(y, want[:, :13].numpy())
    for t in range(13, 17):
        y, c = tssm.ssm_decode(_tp(p), c, torch.from_numpy(x[:, t:t + 1]),
                               D_MODEL, tc)
        _close(y, want[:, t:t + 1].numpy())


def test_bf16_forward_keeps_the_reference_casts():
    """In bf16 the block keeps the reference's casts (conv and recurrence
    in fp32, the gated norm in bf16): within bf16 rounding of JAX's."""
    jc, tc, p = _block()
    x = _x(14, 1, 16, D_MODEL)
    bf = lambda v: v.astype(jnp.bfloat16) if v.ndim >= 2 else v  # noqa
    jpb = {k: bf(jnp.asarray(v)) for k, v in p.items()}
    tpb = {k: (t.bfloat16() if t.ndim >= 2 else t) for k, t in
           _tp(p).items()}
    want = jssm.ssm_forward(jpb, jnp.asarray(x, jnp.bfloat16), D_MODEL, jc)
    got = tssm.ssm_forward(tpb, torch.from_numpy(x).bfloat16(), D_MODEL, tc)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), tol=2e-2)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
