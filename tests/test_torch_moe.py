"""The MoE layer, port against the JAX package at fp32 on the CPU:
``moe_forward`` with capped capacity (tokens dropped), with full
capacity, and with the prefill's ``valid`` mask — the output, the
switch load-balance loss and the gradients of every parameter and of the
input — on the same parameters and inputs made from a seed with numpy.

Tolerances: 1e-5 (abs and rel) for the outputs and the aux loss (fp32
sums in another order), rtol 1e-4 / atol 1e-6 for the gradients (the
same sums, then the backward's). Routing (top-k, each choice's slot in
its expert's buffer, which choices are dropped) is held exactly.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
D = 32
# the smoke DeepSeek-V2-Lite MoE (4 experts of 128, top-2, one shared
# expert of 128), at a d_model of 32
MOE = dict(num_experts=4, top_k=2, expert_dim=128, num_shared_experts=1,
           shared_expert_dim=128)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _params(rng, m):
    E, F = m["num_experts"], m["expert_dim"]
    r = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"router": r(D, E), "wi": r(E, D, F), "wu": r(E, D, F),
         "wd": r(E, F, D)}
    if m.get("num_shared_experts"):
        Fs = m["num_shared_experts"] * m["shared_expert_dim"]
        p["shared"] = {"wi": r(D, Fs), "wu": r(D, Fs), "wd": r(Fs, D)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _run_both(m, B, S, seed, **kw):
    """(jax (y, aux, grads), port (y, aux, grads)) of ``sum(y * cot) +
    aux`` on the same parameters and input; grads of every parameter and
    of x."""
    rng = np.random.default_rng(seed)
    p = _params(rng, m)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = rng.standard_normal((B, S, D)).astype(np.float32)
    valid = kw.pop("valid", None)
    jm, tm = JMoE(**m), TMoE(**m)

    def jf(p, x):
        y, aux = jmoe.moe_forward(p, x, jm, valid=None if valid is None
                                  else jnp.asarray(valid), **kw)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(_tree(p, jnp.asarray),
                                           jnp.asarray(x))
    tp = _tree(p, lambda a: torch.from_numpy(a).requires_grad_(True))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_forward(tp, tx, tm, valid=None if valid is None
                                else torch.from_numpy(valid), **kw)
    flat = [tp[k] if not isinstance(tp[k], dict) else None for k in tp]
    leaves = [t for t in flat if t is not None] + list(tp.get("shared",
                                                              {}).values())
    grads = torch.autograd.grad((ty * torch.from_numpy(cot)).sum() + taux,
                                leaves + [tx], allow_unused=True)
    names = [k for k in tp if not isinstance(tp[k], dict)] + [
        f"shared.{k}" for k in tp.get("shared", {})]
    tgrads = dict(zip(names + ["x"], grads))
    jgrads = {n: jg[0][n] for n in names if "." not in n}
    jgrads.update({f"shared.{k}": v for k, v in jg[0].get("shared",
                                                          {}).items()})
    jgrads["x"] = jg[1]
    return (jy, jaux, jgrads), (ty, taux, tgrads)


def _assert_same(j, t):
    (jy, jaux, jg), (ty, taux, tg) = j, t
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **OUT)
    np.testing.assert_allclose(taux.item(), float(jaux), **OUT)
    assert set(tg) == set(jg)
    for n in jg:
        got = np.zeros_like(np.asarray(jg[n])) if tg[n] is None else \
            tg[n].numpy()
        np.testing.assert_allclose(got, np.asarray(jg[n]), err_msg=n, **GRAD)


def _dropped(m, B, S, seed, capacity_factor):
    """How many (token, choice) pairs the capped buffer drops, from the
    port's own routing (the JAX side routes identically: the test holds
    their outputs equal)."""
    rng = np.random.default_rng(seed)
    p = _params(rng, m)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    probs = torch.softmax(x.reshape(-1, D) @ torch.from_numpy(p["router"]),
                          -1)
    idx = torch.topk(probs, m["top_k"], -1).indices.reshape(-1)
    load = torch.bincount(idx, minlength=m["num_experts"])
    C = tmoe.capacity(B * S, TMoE(**m, capacity_factor=capacity_factor))
    return int((load - C).clamp_min(0).sum())


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_capped_matches_jax(capacity_factor):
    """Training's capped buffer: at 0.5 tokens are dropped (they get only
    the shared expert), at the config's 1.25 few or none."""
    m = dict(MOE, capacity_factor=capacity_factor)
    if capacity_factor < 1:
        assert _dropped(MOE, 2, 24, 1, capacity_factor) > 0
    _assert_same(*_run_both(m, 2, 24, 1))


def test_moe_full_capacity_matches_jax():
    _assert_same(*_run_both(dict(MOE, capacity_factor=0.5), 2, 24, 2,
                            full_capacity=True))


def test_moe_valid_mask_matches_jax():
    """The prefill's pad tail: invalid tokens claim no slot and get only
    the shared expert."""
    valid = np.arange(2 * 16) % 16 < 11
    _assert_same(*_run_both(MOE, 2, 16, 3, full_capacity=True,
                            valid=valid))


def test_moe_without_shared_expert_matches_jax():
    m = dict(MOE, num_shared_experts=0, shared_expert_dim=0, top_k=1)
    _assert_same(*_run_both(m, 1, 20, 4))


@pytest.mark.parametrize("tokens", [3, 40, 4096])
def test_capacity_matches_jax(tokens):
    m = dict(MOE, num_experts=64, top_k=6)
    assert tmoe.capacity(tokens, TMoE(**m)) == jmoe.capacity(tokens,
                                                             JMoE(**m))


def test_full_capacity_output_is_independent_of_the_batch():
    """Drop-free routing: a token's output does not depend on which other
    tokens share the call (the serving engine's contract), while the
    capped buffer's does."""
    rng = np.random.default_rng(5)
    p = _tree(_params(rng, MOE), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((4, 8, D)).astype(np.float32))
    m = TMoE(**dict(MOE, capacity_factor=0.25))
    with torch.no_grad():
        full, _ = tmoe.moe_forward(p, x, m, full_capacity=True)
        alone, _ = tmoe.moe_forward(p, x[3:], m, full_capacity=True)
        # capped: 8 slots an expert over 32 tokens; the last row's tokens
        # come last in each expert's order, so they are the ones dropped
        capped, _ = tmoe.moe_forward(p, x, m)
        capped_alone, _ = tmoe.moe_forward(p, x[3:], m)
    torch.testing.assert_close(alone, full[3:], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(capped_alone, capped[3:], atol=1e-3)


def test_init_moe_tree_matches_jax():
    """Leaf names, shapes and dtypes of ``init_moe`` (the router in fp32
    for a bf16 layer)."""
    jp = jax.eval_shape(lambda: jmoe.init_moe(jax.random.key(0), D,
                                              JMoE(**MOE), jnp.bfloat16))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), D, TMoE(**MOE),
                       torch.bfloat16)
    flat = lambda t, f: {k: (_tree(v, f) if isinstance(v, dict) else f(v))
                         for k, v in t.items()}
    sig = lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1])
    assert flat(tp, sig) == flat(jp, sig)
    assert tp["router"].dtype == torch.float32
