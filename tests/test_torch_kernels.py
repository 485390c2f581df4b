"""Kernel parity, port against the JAX package: each ported kernel's CPU
path (its plain PyTorch version) against the Pallas kernel run in
interpret mode, on the same inputs made from a seed with numpy.

Tolerances: fp32 throughout. 1e-5 (abs and rel) for attention outputs
and lse — both sides accumulate fp32 sums in a different order; token
indices and the paged-vs-contiguous identity are exact. The flash
backward (the port's autograd against ``jax.grad`` through the Pallas
custom VJP): rtol 1e-4 / atol 1e-5, the JAX package's own bound for its
kernels against its oracle; the plain backward against autograd of an
einsum attention in fp64: 1e-10.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import slot_gather as jsg  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import slot_gather as tsg  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types. A
    test file run earlier in the same process may leave a global
    ``jax.set_mesh`` with explicit axes behind, under which the Pallas
    interpreter's updates fail to type-check."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# flash_attention (forward)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_off", [None, 9, "vector"])
@pytest.mark.parametrize("KV", [4, 1])          # G = 1 and G = 4
@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_matches_pallas(window, KV, q_off):
    rng = np.random.default_rng(0)
    B, Sq, Sk, H, D = 2, 24, 40, 4, 32
    q, k, v = _rand(rng, B, Sq, H, D), _rand(rng, B, Sk, KV, D), \
        _rand(rng, B, Sk, KV, D)
    off = np.array([16, 5], np.int32) if q_off == "vector" else q_off
    want, want_lse = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_off=None if off is None else jnp.asarray(off), window=window,
        interpret=True, return_lse=True)
    got, got_lse = tfa.flash_attention(
        _t(q), _t(k), _t(v), q_off=None if off is None else _t(off),
        window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("Sq,Sk", [(13, 29), (1, 7), (33, 33)])
def test_flash_attention_ragged(Sq, Sk):
    """Lengths that are not tile multiples: JAX pads and masks, the port's
    kernel masks the ragged edge itself."""
    rng = np.random.default_rng(Sq)
    B, H, KV, D = 1, 4, 2, 32
    q, k, v = _rand(rng, B, Sq, H, D), _rand(rng, B, Sk, KV, D), \
        _rand(rng, B, Sk, KV, D)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_off=Sk - Sq, interpret=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), q_off=Sk - Sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_lse_is_logsumexp():
    """lse = logsumexp of the scaled, masked scores of each row."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 6, 2, 32), _rand(rng, 1, 6, 2, 32), \
        _rand(rng, 1, 6, 2, 32)
    _, lse = tfa.flash_attention(_t(q), _t(k), _t(v), return_lse=True)
    s = np.einsum("bqhd,bthd->bhqt", q, k) / np.sqrt(32)
    s = np.where(np.tril(np.ones((6, 6), bool)), s, -np.inf)
    want = np.log(np.exp(s).sum(-1)).transpose(0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# flash_attention backward (dq, dk/dv)
# ---------------------------------------------------------------------------

def _grads(q, k, v, cot, **kw):
    qkv = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*qkv, **kw)
    return torch.autograd.grad((out * _t(cot)).sum(), qkv)


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("H,KV,S", [(4, 2, 24), (4, 4, 30), (4, 1, 24),
                                    (6, 2, 24)])          # G = 2, 1, 4, 3
def test_flash_attention_grads_match_pallas(window, H, KV, S):
    """The JAX package's backward grid (block 8, ragged 30) plus G = 3."""
    rng = np.random.default_rng(window + H + S + KV)
    D = 16
    q, k, v = _rand(rng, 1, S, H, D), _rand(rng, 1, S, KV, D), \
        _rand(rng, 1, S, KV, D)
    cot = _rand(rng, 1, S, H, D)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, window=window, block_q=8,
                                           block_k=8, interpret=True) * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    got = _grads(q, k, v, cot, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _einsum_attention(q, k, v, q_off, window, scale):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qpos = q_off.long()[:, None] + torch.arange(Sq)
    keep = tref._keep(qpos[:, :, None], torch.arange(Sk)[None, None],
                      window)[:, None, None]
    s = torch.einsum("bqkgd,btkd->bkgqt", q.reshape(B, Sq, KV, H // KV, D),
                     k) * scale
    p = torch.softmax(torch.where(keep, s, -1e30), -1)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v).reshape(B, Sq, H, -1)


@pytest.mark.parametrize("shape", [(2, 13, 29, 4, 2, 0, "vector"),
                                   (1, 24, 24, 6, 2, 9, None),
                                   (2, 20, 20, 4, 4, 5, 3)])
def test_flash_bwd_ref_is_the_einsum_gradient(shape):
    """The plain backward (a direct formula) against autograd of an
    einsum attention, in fp64: ragged Sk, a vector q_off, G = 3, window."""
    B, Sq, Sk, H, KV, window, off = shape
    rng = np.random.default_rng(Sq)
    D = 8
    f64 = lambda *s_: torch.from_numpy(rng.standard_normal(s_))
    q, k, v, do = f64(B, Sq, H, D), f64(B, Sk, KV, D), f64(B, Sk, KV, D), \
        f64(B, Sq, H, D)
    q_off = tfa._positions(torch.tensor([Sk - Sq, 0][:B]) if off == "vector"
                           else off, B, "cpu")
    out, lse = tref.flash_attention_ref(q, k, v, q_off, window, 0.3, True)
    got = tref.flash_attention_bwd_ref(q, k, v, out, lse, do, q_off, window,
                                       0.3)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_einsum_attention(*qkv, q_off, window, 0.3),
                               qkv, do)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_flash_attention_gradcheck_fp64():
    """Finite differences through the port's autograd Function (the plain
    versions on the CPU) at G = 3 with a window and a vector q_off."""
    rng = np.random.default_rng(5)
    f64 = lambda *s_: torch.from_numpy(rng.standard_normal(s_)) \
        .requires_grad_(True)
    q, k, v = f64(2, 5, 6, 4), f64(2, 7, 2, 4), f64(2, 7, 2, 4)
    q_off = torch.tensor([2, 1], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, q_off=q_off, window=3),
        (q, k, v))


def test_flash_lse_is_non_differentiable():
    """lse carries no gradient (the reference's stop_gradient): it does not
    require grad, a loss that adds it changes no gradient, and the out
    gradient stays intact."""
    rng = np.random.default_rng(14)
    q = _t(_rand(rng, 1, 16, 4, 16)).requires_grad_(True)
    k, v = _t(_rand(rng, 1, 16, 2, 16)), _t(_rand(rng, 1, 16, 2, 16))
    out, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    (g_out,) = torch.autograd.grad(out.sum(), q, retain_graph=True)
    (g_both,) = torch.autograd.grad(out.sum() + lse.sum(), q)
    assert torch.equal(g_out, g_both) and g_out.abs().max() > 0


def test_cpu_backward_launches_no_kernel():
    K.reset_launches()
    q = torch.zeros(1, 4, 2, 32, requires_grad=True)
    tfa.flash_attention(q, q, q).sum().backward()
    assert K.LAUNCHES == {}


# ---------------------------------------------------------------------------
# split-KV decode, contiguous and paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_k", [8, 16])
@pytest.mark.parametrize("window", [0, 7])
def test_flash_decode_matches_pallas(window, block_k):
    rng = np.random.default_rng(1)
    B, S, H, KV, D = 3, 40, 4, 1, 32
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, KV, D), \
        _rand(rng, B, S, KV, D)
    pos = np.array([0, 17, 39], np.int32)          # per-slot positions
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), window=window, block_k=block_k,
                            interpret=True)
    got = tfa.flash_decode(_t(q), _t(k), _t(v), _t(pos), window=window,
                           block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 9])
def test_flash_decode_paged_matches_pallas_and_contiguous(window):
    """Random tables that map the null page 0 past each slot's position;
    the port equals the Pallas kernel, and equals its own contiguous decode
    on the gathered lanes with block_k = page_size exactly."""
    rng = np.random.default_rng(2)
    B, H, KV, D, ps, NP, P = 3, 4, 2, 32, 8, 5, 12
    q = _rand(rng, B, 1, H, D)
    kp, vp = _rand(rng, P, ps, KV, D), _rand(rng, P, ps, KV, D)
    pos = np.array([3, 21, 39], np.int32)
    tables = rng.integers(1, P, size=(B, NP)).astype(np.int32)
    tables[np.arange(NP)[None] * ps > pos[:, None]] = 0     # null page
    want = jfa.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(tables),
                                  jnp.asarray(pos), page_size=ps,
                                  window=window, interpret=True)
    got = tfa.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(tables), _t(pos),
                                 page_size=ps, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lanes_k = tref.gather_pages(_t(kp), _t(tables))
    lanes_v = tref.gather_pages(_t(vp), _t(tables))
    same = tfa.flash_decode(_t(q), lanes_k, lanes_v, _t(pos), window=window,
                            block_k=ps)
    assert torch.equal(got, same)


def test_combine_drops_neutral_splits():
    """A dead split's neutral partial (NEG_INF, 0, 0) changes nothing."""
    rng = np.random.default_rng(4)
    m, l = _t(_rand(rng, 1, 2, 3, 4)), _t(np.abs(_rand(rng, 1, 2, 3, 4)))
    acc = _t(_rand(rng, 1, 2, 3, 4, 8))
    base = tref.combine_kv_splits(m, l, acc)
    m2 = torch.cat([m, torch.full((1, 2, 1, 4), tref.NEG_INF)], 2)
    l2 = torch.cat([l, torch.zeros(1, 2, 1, 4)], 2)
    a2 = torch.cat([acc, torch.zeros(1, 2, 1, 4, 8)], 2)
    assert torch.equal(tref.combine_kv_splits(m2, l2, a2), base)


# ---------------------------------------------------------------------------
# slot_gather_sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,C,V", [(4, 1, 512), (3, 8, 1000), (2, 8, 1537)])
def test_slot_gather_sample_matches_pallas(S, C, V):
    """C = 1 (decode) and C = 8 (prefill tail); V not a multiple of the
    Pallas kernel's 512 block. Shared noise: indices must be identical."""
    rng = np.random.default_rng(V)
    logits = _rand(rng, S, C, V)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, S)]
    temp = np.array([0.0, 0.7, 1.3, 0.01][:S], np.float32)
    noise = -np.log(-np.log(rng.uniform(1e-20, 1.0, (S, V)))).astype(
        np.float32)
    wg, ws = jsg.slot_gather_sample(jnp.asarray(logits), jnp.asarray(onehot),
                                    jnp.asarray(temp), jnp.asarray(noise),
                                    interpret=True)
    gg, gs = tsg.slot_gather_sample(_t(logits), _t(onehot), _t(temp),
                                    _t(noise))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_slot_gather_sample_ties_first_index():
    """Equal maxima: the first index wins, in both packages."""
    S, C, V = 2, 2, 700
    logits = np.zeros((S, C, V), np.float32)
    logits[:, :, [5, 300, 650]] = 2.0
    onehot = np.array([[1, 0], [0, 1]], np.float32)
    temp = np.ones((S,), np.float32)
    noise = np.zeros((S, V), np.float32)
    wg, ws = jsg.slot_gather_sample(jnp.asarray(logits), jnp.asarray(onehot),
                                    jnp.asarray(temp), jnp.asarray(noise),
                                    interpret=True)
    gg, gs = tsg.slot_gather_sample(_t(logits), _t(onehot), _t(temp),
                                    _t(noise))
    assert gg.tolist() == gs.tolist() == [5, 5]
    assert np.asarray(wg).tolist() == np.asarray(ws).tolist() == [5, 5]


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain version and count no launch."""
    K.reset_launches()
    x = torch.zeros(1, 4, 2, 32)
    tfa.flash_attention(x, x, x)
    tsg.slot_gather_sample(torch.zeros(1, 1, 8), torch.ones(1, 1),
                           torch.ones(1), torch.zeros(1, 8))
    assert K.LAUNCHES == {}
