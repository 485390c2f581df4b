"""AlexNet, port against the JAX package, in fp32 on the CPU: logits, loss
and every gradient from the same parameters (bridged HWIO -> OIHW) and
images, at a smoke size whose pool-5 map is 3x3 (131 px), so the (h, w, c)
order of the features before ``f6`` matters; the LRN on its own; the
full config's parameter count on the ``meta`` device.

Tolerance: rtol 1e-4 with an atol of 1e-4 of each tensor's largest
magnitude (convolutions and matmuls sum in another order on each side;
elements near zero are held to the tensor's scale).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import vision as jvision  # noqa: E402
from repro.models.common import softmax_xent as jxent  # noqa: E402
from repro_torch.bridge import conv_params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models import vision as tvision  # noqa: E402
from repro_torch.models.common import softmax_xent  # noqa: E402


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _hwio_to_oihw(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_smoke("alexnet"), image_size=131)
    tcfg = dataclasses.replace(get_smoke_config("alexnet"), image_size=131)
    rng = np.random.default_rng(0)
    # the reference's shapes, filled from numpy (eager JAX init is slow)
    jp = jax.tree.map(
        lambda l: jnp.asarray(rng.standard_normal(l.shape).astype(
            np.float32) * 0.05), jax.eval_shape(
            lambda k: jvision.init_alexnet(k, jcfg), jax.random.key(0)))
    images = rng.standard_normal((3, 131, 131, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 3).astype(np.int32)
    return jcfg, tcfg, jp, images, labels


def test_pool5_map_is_larger_than_one(setup):
    _, tcfg, jp, _, _ = setup
    assert tvision.feature_side(131) == 3
    assert jp["f6"]["w"].shape == (3 * 3 * 256, 4096)
    assert tvision.feature_side(227) == 6


def test_alexnet_logits_loss_and_grads_match_jax(setup):
    jcfg, tcfg, jp, images, labels = setup
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    want_logits = jvision.conv_predict(jp, batch["images"], jcfg)
    (want_loss, _), want_g = jax.value_and_grad(
        jvision.conv_loss, has_aux=True)(jp, batch, jcfg, None)

    tp = conv_params_from_jax(jax.tree.map(np.asarray, jp))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    _close(tvision.conv_predict(tp, tb["images"], tcfg).detach().numpy(),
           want_logits)
    loss, metrics = tvision.conv_loss(tp, tb, tcfg, None)
    _close(loss.item(), want_loss)
    assert metrics["loss"] is loss and float(metrics["aux"]) == 0.0
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(loss, leaves)
    want_leaves = jax.tree.leaves(want_g)
    assert len(grads) == len(want_leaves) == 16
    for g, w in zip(grads, want_leaves):
        _close(g.numpy(), _hwio_to_oihw(w))


def test_model_registry_conv_family(setup):
    _, tcfg, jp, images, labels = setup
    model = build_model(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v["w"].shape) for k, v in params.items()} == {
        k: tuple(_hwio_to_oihw(v["w"]).shape) for k, v in jp.items()}
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    loss, _ = model.loss_fn(params, batch)
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert model.forward(params, batch).shape == (3, tcfg.num_classes)
    # dropout draws from the generator it is given, and only then
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    l1, _ = model.loss_fn(params, batch, g1)
    l2, _ = model.loss_fn(params, batch, g2)
    assert torch.equal(l1, l2) and not torch.equal(l1, loss)
    with pytest.raises(TypeError, match="Generator"):
        model.init(0)


@pytest.mark.parametrize("C", [1, 3, 5, 8])
def test_lrn_matches_jax_at_the_channel_edges(C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((2, 4, 3, C)) * 30).astype(np.float32)  # NHWC
    want = jvision._lrn(jnp.asarray(x))
    got = tvision.lrn(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6)
    # not torch's LRN with its defaults (alpha / n, k = 1)
    torch_default = torch.nn.functional.local_response_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 5)
    assert not np.allclose(torch_default.permute(0, 2, 3, 1).numpy(),
                           np.asarray(want), rtol=1e-3)


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((5, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (5, 7)).astype(np.int32)
    mask = (rng.random((5, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = jxent(jnp.asarray(logits), jnp.asarray(labels),
                     None if m is None else jnp.asarray(m))
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
        _close(got.item(), want, rtol=1e-6)


def test_full_alexnet_parameter_count_on_meta():
    cfg = get_config("alexnet")
    assert (cfg.image_size, cfg.num_classes) == (227, 1000)
    params = build_model(cfg, "meta").init(None)
    assert count_params(params) == 60_965_224
    assert params["f6"]["w"].shape == (9216, 4096)
    jabs = jax.eval_shape(lambda k: jvision.init_alexnet(k, jget_config(
        "alexnet")), jax.random.key(0))
    assert [tuple(_hwio_to_oihw(np.empty(l.shape)).shape)
            for l in jax.tree.leaves(jabs)] == \
        [tuple(t.shape) for t in jax.tree.leaves(params)]
