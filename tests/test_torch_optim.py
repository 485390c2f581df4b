"""The update path, port against the JAX package: the ``fused_sgd`` and
``fused_rs_update`` kernels' plain versions against the Pallas kernels in
interpret mode, the optimizers on a fixed tree, and the LR schedules.

Tolerances: fp32 rtol 1e-6 with atol 1e-7 (the two sides may take the
k-way sum or a product in another order, a few fp32 ulps on values of
order 1); the port's fused tail against its own chunk_sum + fused_sgd is
exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import fused_rs_update as jfru  # noqa: E402
from repro.kernels import fused_sgd as jfs  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.kernels import chunk_sum as tcs  # noqa: E402
from repro_torch.kernels import fused_rs_update as tfru  # noqa: E402
from repro_torch.kernels import fused_sgd as tfs  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("n", [1, 4096, 5003])
def test_fused_sgd_matches_pallas(nesterov, n):
    rng = np.random.default_rng(n)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    want = jfs.fused_sgd(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                         0.013, momentum=0.9, nesterov=nesterov,
                         interpret=True)
    got = tfs.fused_sgd(_t(p), _t(g), _t(m), 0.013, 0.9, nesterov)
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def _recv(rng, dtype, k, s):
    if dtype == "int8":
        q = rng.integers(-127, 128, (k, s)).astype(np.int8)
        return q, rng.random(k).astype(np.float32) * 0.01
    x = rng.standard_normal((k, s)).astype(np.float32)
    return x.astype(dtype), None


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
@pytest.mark.parametrize("k,s", [(1, 777), (2, 4096), (4, 2309)])
@pytest.mark.parametrize("microbatches", [1, 3])
def test_fused_rs_update_matches_pallas(dtype, k, s, microbatches):
    rng = np.random.default_rng(k * s)
    recv, scales = _recv(rng, dtype, k, s)
    p, m = (rng.standard_normal(s).astype(np.float32) for _ in range(2))
    mask = (rng.random(s) < 0.6).astype(np.float32)
    scale = 1.0 / (k * microbatches)
    for wd, nesterov in ((5e-4, False), (0.0, True)):
        want = jfru.fused_rs_update(
            jnp.asarray(recv), jnp.asarray(p), jnp.asarray(m),
            jnp.asarray(mask), 0.02, momentum=0.9, nesterov=nesterov,
            scale=scale, weight_decay=wd,
            scales=None if scales is None else jnp.asarray(scales),
            interpret=True)
        got = tfru.fused_rs_update(
            _t(recv), _t(p), _t(m), 0.02, wd_mask=_t(mask), scale=scale,
            momentum=0.9, nesterov=nesterov, weight_decay=wd,
            scales=None if scales is None else _t(scales))
        for a, b in zip(got, want):
            _close(a.numpy(), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_fused_rs_update_equals_chunk_sum_then_fused_sgd(dtype):
    rng = np.random.default_rng(9)
    k, s, wd = 3, 3001, 5e-4
    recv = _t(rng.standard_normal((k, s)).astype(np.float32)).to(dtype)
    p, m = (_t(rng.standard_normal(s).astype(np.float32)) for _ in range(2))
    mask = (torch.arange(s) < 2000).float()
    fused = tfru.fused_rs_update(recv, p, m, 0.02, wd_mask=mask, scale=1 / k,
                                 weight_decay=wd)
    g = tcs.chunk_sum(recv) * (1 / k) + wd * mask * p
    unfused = tfs.fused_sgd(p, g, m, 0.02, 0.9, False)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))


def test_update_kernels_raise_on_mixed_devices():
    cpu, meta = torch.zeros(8), torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tfs.fused_sgd(cpu, meta, cpu, 0.1)
    with pytest.raises(ValueError, match="meta"):
        tfru.fused_rs_update(torch.zeros(2, 8), cpu, cpu, 0.1, wd_mask=meta,
                             weight_decay=1e-4)
    with pytest.raises(ValueError, match="scales"):
        tfru.fused_rs_update(torch.zeros(2, 8, dtype=torch.int8), cpu, cpu,
                             0.1)


# ---------------------------------------------------------------------------
# optimizers on a fixed tree
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "conv": {"w": rng.standard_normal((3, 3, 2, 4)).astype(
                np.float32), "b": rng.standard_normal(4).astype(np.float32)},
            "s": np.float32(rng.standard_normal())}


def _to_t(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a, np.float32)), tree)


def _assert_tree_close(got, want):
    jl = jax.tree.leaves(want)
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close(a, b)


@pytest.mark.parametrize("make", [
    dict(name="sgd", kw=dict(momentum=0.9, weight_decay=5e-4)),
    dict(name="sgd", kw=dict(momentum=0.9, weight_decay=5e-4,
                             nesterov=True)),
    dict(name="sgd_fused", kw=dict(momentum=0.9, weight_decay=5e-4)),
    dict(name="adamw", kw=dict(weight_decay=0.1)),
], ids=["sgd", "sgd-nesterov", "sgd-fused", "adamw"])
def test_optimizer_update_matches_jax(make):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng)
    if make["name"] == "sgd_fused":
        from repro.kernels import ops
        jo = jopt.sgd_momentum(**make["kw"], fused_kernel=ops.fused_sgd)
        to = topt.sgd_momentum(**make["kw"], fused_kernel=tfs.fused_sgd)
    else:
        jo = jopt.get_optimizer(make["name"], **make["kw"])
        to = topt.get_optimizer(make["name"], **make["kw"])
    jp, js = jax.tree.map(jnp.asarray, params), jo.init(params)
    tp, ts = _to_t(params), to.init(_to_t(params))
    for i in range(3):
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, grads), js, 0.05)
        tp, ts = to.update(tp, _to_t(grads), ts, 0.05)
    _assert_tree_close(tp, jp)
    _assert_tree_close(ts["m"], js["m"])


@pytest.mark.parametrize("name", ["sgd", "adamw"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_flat_update_matches_jax(name, with_mask):
    rng = np.random.default_rng(2)
    n = 1037
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    mask = (rng.random(n) < 0.5).astype(np.float32) if with_mask else None
    jo, to = jopt.get_optimizer(name), topt.get_optimizer(name)
    js, ts = jo.flat_init(n), to.flat_init(n)
    jp, tp = jnp.asarray(p), _t(p)
    for _ in range(2):
        jp, js = jo.flat_update(jp, jnp.asarray(g), js, 0.03,
                                None if mask is None else jnp.asarray(mask))
        tp, ts = to.flat_update(tp, _t(g), ts, 0.03,
                                None if mask is None else _t(mask))
    _close(tp.numpy(), jp)
    _close(ts["m"].numpy(), js["m"])


def test_rs_fused_update_hook_matches_jax():
    rng = np.random.default_rng(3)
    k, s = 2, 2050
    recv = rng.standard_normal((k, s)).astype(np.float16)
    p = rng.standard_normal(s).astype(np.float32)
    mask = (np.arange(s) < 1000).astype(np.float32)
    jo, to = jopt.sgd_momentum(), topt.sgd_momentum()
    jp, js = jo.rs_fused_update(jnp.asarray(recv), jnp.asarray(p),
                                jo.flat_init(s), 0.01, jnp.asarray(mask),
                                0.5)
    tp, ts = to.rs_fused_update(_t(recv), _t(p), to.flat_init(s), 0.01,
                                _t(mask), 0.5)
    _close(tp.numpy(), jp)
    _close(ts["m"].numpy(), js["m"])


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant", (0.01,)),
    ("step_decay", (0.01, 7)),
    ("step_decay", (0.1, 3, 0.5)),
    ("poly_decay", (0.02, 50)),
    ("warmup_cosine", (3e-4, 10, 100)),
    ("warmup_cosine", (1e-3, 0, 40, 0.0)),
])
def test_schedule_matches_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 2, 5, 6, 7, 9, 10, 11, 25, 49, 50, 99, 120):
        got = tf(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(jf(step)), rtol=1e-6,
                                   atol=1e-12)
