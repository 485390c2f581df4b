"""Head dim 128 on the CPU, port against the JAX package: the flash
forward (with lse), its gradients (dq, dk, dv), the contiguous and paged
decode, each against the Pallas kernel in interpret mode at G = 1 and
G = 4; and the qwen1.5-4b smoke decoder with its head dim put back to the
full config's 128 (4 heads over 4, QKV bias), parameters carried from
the JAX init by ``bridge.decoder_params_from_jax``.

Tolerances, fp32 throughout: 1e-5 for attention outputs and lse (fp32
sums in another order); gradients rtol 1e-4 / atol 1e-5 (the JAX
package's own bound for its kernels against its oracle); logits 1e-4
through two decoder layers (the differences compound); the decoder loss
1e-4 and its leaf gradients rtol 1e-3 / atol 1e-5, as
``test_torch_lm_train.py`` holds llama's.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import with_attn_impl as j_impl  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import with_attn_impl as t_impl  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import flatten, leaves, unflatten  # noqa: E402

D = 128
TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("KV", [4, 1])               # G = 1 and G = 4
def test_flash_forward_and_lse_match_pallas(KV, window):
    rng = np.random.default_rng(KV + window)
    B, Sq, Sk, H = 2, 24, 40, 4
    q, k, v = _rand(rng, B, Sq, H, D), _rand(rng, B, Sk, KV, D), \
        _rand(rng, B, Sk, KV, D)
    off = np.array([16, 5], np.int32)
    want, want_lse = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off=jnp.asarray(off),
        window=window, interpret=True, return_lse=True)
    got, got_lse = tfa.flash_attention(_t(q), _t(k), _t(v), q_off=_t(off),
                                       window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("KV", [4, 1])
def test_flash_grads_match_pallas(KV):
    """dq, dk, dv through the port's autograd Function against jax.grad
    through the Pallas custom VJP, on its backward grid of 8 x 8 tiles
    over a ragged S = 30 with a window."""
    rng = np.random.default_rng(20 + KV)
    S, H = 30, 4
    q, k, v = _rand(rng, 1, S, H, D), _rand(rng, 1, S, KV, D), \
        _rand(rng, 1, S, KV, D)
    cot = _rand(rng, 1, S, H, D)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, window=9, block_q=8,
                                           block_k=8, interpret=True) * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    qkv = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*qkv, window=9)
    got = torch.autograd.grad((out * _t(cot)).sum(), qkv)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("KV", [4, 1])
def test_flash_decode_matches_pallas(KV):
    rng = np.random.default_rng(30 + KV)
    B, S, H = 3, 40, 4
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, KV, D), \
        _rand(rng, B, S, KV, D)
    pos = np.array([0, 17, 39], np.int32)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), window=7, block_k=16,
                            interpret=True)
    got = tfa.flash_decode(_t(q), _t(k), _t(v), _t(pos), window=7,
                           block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("KV", [4, 1])
def test_flash_decode_paged_matches_pallas(KV):
    """Random tables with the null page past each slot's position: the
    port equals the Pallas kernel, and its own contiguous decode on the
    gathered lanes with block_k = page_size exactly."""
    rng = np.random.default_rng(40 + KV)
    B, H, ps, NP, P = 3, 4, 8, 5, 12
    q = _rand(rng, B, 1, H, D)
    kp, vp = _rand(rng, P, ps, KV, D), _rand(rng, P, ps, KV, D)
    pos = np.array([3, 21, 39], np.int32)
    tables = rng.integers(1, P, size=(B, NP)).astype(np.int32)
    tables[np.arange(NP)[None] * ps > pos[:, None]] = 0
    want = jfa.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(tables),
                                  jnp.asarray(pos), page_size=ps,
                                  interpret=True)
    got = tfa.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(tables), _t(pos),
                                 page_size=ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    same = tfa.flash_decode(_t(q), tref.gather_pages(_t(kp), _t(tables)),
                            tref.gather_pages(_t(vp), _t(tables)), _t(pos),
                            block_k=ps)
    assert torch.equal(got, same)


# ---------------------------------------------------------------------------
# qwen1.5-4b's smoke decoder at head dim 128
# ---------------------------------------------------------------------------

def _qwen_cfg(get_smoke, with_impl):
    """The smoke config (2 layers, d_model 256) at head dim 128, fp32, the
    attention through the flash kernels."""
    c = get_smoke("qwen1.5-4b").with_overrides(dtype="float32", remat=False)
    c = c.with_overrides(attention=dataclasses.replace(c.attention,
                                                       head_dim=D))
    return with_impl(c, "flash")


def _qwen_pair():
    jc, tc = _qwen_cfg(j_smoke, j_impl), _qwen_cfg(t_smoke, t_impl)
    assert tc.attention.qkv_bias and tc.attention.head_dim == D
    jm, tm = j_build(jc), t_build(tc, "cpu")
    jp = jm.init(jax.random.key(0))
    tp = decoder_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jm, jp, tm, tp


def test_qwen_d128_prefill_then_decode_logits():
    """One prefill chunk of 16 tokens, then two decode steps fed the JAX
    side's greedy tokens, on contiguous cache lanes: logits agree."""
    cfg, jm, jp, tm, tp = _qwen_pair()
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 16))
    S = 32
    jc, tc = jm.init_cache(1, S), tm.init_cache(1, S)
    prefill = jax.jit(lambda p, c, t: jm.chunk_prefill(
        p, c, t, jnp.int32(0), jnp.int32(16), seq_len=S, block_tables=None,
        page_size=0))
    decode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, c, {"tokens": t}, pos, S, block_tables=None, page_size=0))
    jl, jc = prefill(jp, jc, jnp.asarray(prompt, jnp.int32))
    tl, tc = tm.chunk_prefill(tp, tc, _t(prompt).long(), 0, 16, seq_len=S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for i in range(2):
        pos = 16 + i
        jl, jc = decode(jp, jc, jnp.asarray([[tok]], jnp.int32),
                        jnp.asarray([pos], jnp.int32))
        tl, tc = tm.decode_step(tp, tc, {"tokens": torch.tensor([[tok]])},
                                torch.tensor([pos]), S)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        tok = int(np.argmax(np.asarray(jl)[0, 0]))


def test_qwen_d128_decoder_loss_and_grads():
    """decoder_loss and every leaf gradient, the attention through the
    flash kernels on both sides (Pallas in interpret mode; the port's
    autograd Function on its plain versions)."""
    cfg, jm, jp, tm, tp = _qwen_pair()
    batch = tsyn.LMTokenSource(cfg.vocab_size, 32).batch(2, 0)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    ls, treedef = flatten(tp)
    ps = [t.requires_grad_(True) for t in ls]
    tl, _ = tm.loss_fn(unflatten(treedef, ps),
                       {n: torch.from_numpy(v) for n, v in batch.items()})
    tg = torch.autograd.grad(tl, ps)
    assert abs(tl.item() - float(jl)) <= 1e-4
    want = leaves(decoder_params_from_jax(jax.tree.map(np.asarray, jg)))
    assert len(tg) == len(want)
    for a, b in zip(tg, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)
