"""VGG-16 and GoogLeNet, port against the JAX package, on the CPU.

- From the same parameters (bridged HWIO -> OIHW) and images: VGG-16 at
  the smoke config (96 px, 16 classes); GoogLeNet with both aux heads at
  96 px (aux map 1x1) and at 160 px (aux map 2x2, so the (h, w, c)
  flatten order before each aux ``fc1`` matters).
  - In fp32, as both train: logits and loss, rtol 1e-4 with an atol of
    1e-4 of the largest magnitude.
  - In fp64 on both sides: the loss and every leaf gradient, rtol 1e-6
    with an atol of 1e-6 of each tensor's largest magnitude (the
    reference's ``softmax_xent`` takes its logits in fp32). Not in fp32:
    there the libraries' own convolutions set the error. At 96 px XLA's
    fp32 GoogLeNet gradients lie up to 1.7e-2 of a leaf's scale from
    fp64 (the stem's; oneDNN's lie as far, PyTorch's native kernels
    2.5e-6), and oneDNN's VGG gradients 1.5e-3 (XLA's 5e-6).
- The stem's SAME padding on an even input is XLA's (2, 3), and the
  Inception pool branch's SAME max pool pads with -inf: each checked at
  the edge pixels (rtol 1e-6).
- Tree shapes: the port's init equals the JAX init leaf for leaf at 96,
  160 and 192 px. At 224 px the full parameter counts are pinned:
  VGG-16 138,357,544; GoogLeNet 11,543,272, which is the reference's
  13,378,280 less 2 x 128 x 7 x 1024 (the reference sizes each aux
  ``fc1`` for a 4x4 map that its own forward makes 3x3, and fails there).
- BSP: one spawn of k=2 gloo ranks takes 2 fp32 steps of smoke GoogLeNet
  with ``asa`` and with ``ring``, each rank on its half of each batch,
  against JAX's 1-device ``make_bsp_step`` on the whole batches: losses
  rtol 1e-4; parameters within 2e-2 of each leaf's largest step (the
  fp32 gradient spread above) plus 2 ulp of its largest value.
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
from repro.core import bsp as jbsp  # noqa: E402
from repro.core import exchanger as jex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import vision as jvision  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.bridge import conv_params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models import vision as tvision  # noqa: E402
from test_torch_ranks import CONV_CASES, LR, bsp_worker  # noqa: E402

F64_TOL = 1e-6        # both sides in fp64 but for the reference's
                      # softmax_xent, which takes its logits in fp32
GOOGLENET_224 = 11_543_272
REFERENCE_GOOGLENET = 13_378_280     # the paper's Table 2


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


def _oihw(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _cfgs(arch, size):
    return (dataclasses.replace(jget_smoke(arch), image_size=size),
            dataclasses.replace(get_smoke_config(arch), image_size=size))


def _jax_params(jcfg, seed=0):
    """The reference's tree, filled from numpy at He scale (an eager JAX
    init is slow)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jvision.init_conv(k, jcfg),
                            jax.random.key(0))
    return jax.tree.map(lambda l: (rng.standard_normal(l.shape) * np.sqrt(
        2.0 / np.prod(l.shape[:-1]))).astype(np.float32), shapes)


@pytest.mark.parametrize("arch,size", [("vggnet", 96), ("googlenet", 96),
                                       ("googlenet", 160)])
def test_logits_loss_and_grads_match_jax(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    jp = _jax_params(jcfg)
    rng = np.random.default_rng(size)
    images = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 2).astype(np.int32)
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}

    def ref(p, b):
        return (jax.value_and_grad(jvision.conv_loss, has_aux=True)(
            p, b, jcfg, None), jvision.conv_predict(p, b["images"], jcfg))

    # fp32, as both train: logits and loss
    (((want_loss, _), _), want_logits) = jax.jit(ref)(
        jax.tree.map(jnp.asarray, jp),
        {"images": jnp.asarray(images), "labels": jnp.asarray(labels)})
    tp = conv_params_from_jax(jp)
    _close(tvision.conv_predict(tp, tb["images"], tcfg).numpy(), want_logits)
    loss, metrics = tvision.conv_loss(tp, tb, tcfg, None)
    _close(loss.item(), want_loss)
    assert float(metrics["aux"]) == 0.0

    # fp64: loss and every leaf gradient
    with jax.enable_x64(True):
        ((want_loss, _), want_g), _ = jax.jit(ref)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp),
            {"images": jnp.asarray(images, jnp.float64),
             "labels": jnp.asarray(labels)})
    tp = jax.tree.map(lambda t: t.double().requires_grad_(True), tp)
    loss, _ = tvision.conv_loss(tp, {"images": tb["images"].double(),
                                     "labels": tb["labels"]}, tcfg, None)
    _close(loss.item(), want_loss, rtol=F64_TOL)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(loss, leaves)
    want_leaves = jax.tree.leaves(want_g)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        _close(g.numpy(), _oihw(w), rtol=F64_TOL)
    if arch == "googlenet":
        logits, aux = tvision.googlenet_forward(tp, tb["images"].double(),
                                                train=True)
        assert len(aux) == 2 and aux[0].shape == logits.shape
        assert tvision.googlenet_forward(tp, tb["images"].double())[1] == []
        side = tvision.googlenet_sides(size)["aux"]
        assert jp["aux0_fc1"]["w"].shape == (128 * side * side, 1024)


def test_stem_pads_same_as_xla_on_an_even_input():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 12, 12, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 4)).astype(np.float32)
    want = jvision._conv({"w": jnp.asarray(w), "b": jnp.zeros(4)},
                         jnp.asarray(x), stride=2)
    p = conv_params_from_jax({"w": w, "b": np.zeros(4, np.float32)})
    got = tvision._conv_same(p, torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert tvision._same_pads(224, 7, 2) == (2, 3)
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6)
    # a symmetric pad of 3 gives the same size, shifted by a pixel
    sym = tvision._conv(p, torch.from_numpy(x).permute(0, 3, 1, 2), 2, 3)
    assert sym.shape == got.shape
    assert not np.allclose(sym.numpy(), got.numpy(), rtol=1e-3)


def test_inception_pool_branch_pads_with_minus_infinity():
    # all-negative maps: a zero pad would win the max at every edge pixel
    x = -1.0 - np.random.default_rng(2).random((1, 5, 6, 4)).astype(
        np.float32)
    want = jvision._maxpool(jnp.asarray(x), k=3, s=1, padding="SAME")
    got = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, 1, padding=1)
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6)
    assert (got < 0).all()


@pytest.mark.parametrize("size", [96, 160, 192])
def test_googlenet_trees_equal_the_reference_where_it_trains(size):
    jcfg, tcfg = _cfgs("googlenet", size)
    want = jax.eval_shape(lambda k: jvision.init_conv(k, jcfg),
                          jax.random.key(0))
    got = build_model(tcfg, "meta").init(None)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda l: 0, want))
    assert [tuple(t.shape) for t in jax.tree.leaves(got)] == \
        [_oihw(np.empty(l.shape)).shape for l in jax.tree.leaves(want)]
    # the reference's own forward runs at this size
    jax.eval_shape(lambda p, b: jvision.conv_loss(p, b, jcfg), want,
                   {"images": jax.ShapeDtypeStruct((1, size, size, 3),
                                                   jnp.float32),
                    "labels": jax.ShapeDtypeStruct((1,), jnp.int32)})


def test_full_vgg16_parameter_count_on_meta():
    cfg = get_config("vggnet")
    assert (cfg.image_size, cfg.num_classes) == (224, 1000)
    params = build_model(cfg, "meta").init(None)
    assert count_params(params) == 138_357_544
    assert params["f0"]["w"].shape == (7 * 7 * 512, 4096)
    jabs = jax.eval_shape(lambda k: jvision.init_conv(k, jget_config(
        "vggnet")), jax.random.key(0))
    assert [_oihw(np.empty(l.shape)).shape for l in jax.tree.leaves(jabs)] \
        == [tuple(t.shape) for t in jax.tree.leaves(params)]


def test_full_googlenet_sizes_its_aux_heads_from_its_own_forward():
    cfg = get_config("googlenet")
    assert (cfg.image_size, cfg.num_classes) == (224, 1000)
    assert tvision.googlenet_sides(224) == {"stem": 27, "aux_in": 13,
                                            "aux": 3, "gap": 6}
    params = build_model(cfg, "meta").init(None)
    assert count_params(params) == GOOGLENET_224
    assert params["aux0_fc1"]["w"].shape == (128 * 3 * 3, 1024)
    # the reference's tree: 4x4 aux maps, Table 2's count
    jabs = jax.eval_shape(lambda k: jvision.init_conv(k, jget_config(
        "googlenet")), jax.random.key(0))
    assert sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jabs)) == \
        REFERENCE_GOOGLENET == GOOGLENET_224 + 2 * 128 * (16 - 9) * 1024
    # ...which its own forward cannot take at 224 px
    with pytest.raises(TypeError, match="1152"):
        jax.eval_shape(lambda p, b: jvision.conv_loss(
            p, b, jget_config("googlenet")), jabs,
            {"images": jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32),
             "labels": jax.ShapeDtypeStruct((1,), jnp.int32)})
    # the port's forward takes it (on meta: shapes only)
    logits, aux = tvision.googlenet_forward(
        params, torch.empty(2, 224, 224, 3, device="meta"), train=True)
    assert logits.shape == (2, 1000) and [a.shape for a in aux] == \
        [(2, 1000)] * 2


def test_registry_builds_every_convnet():
    for arch in ("vggnet", "googlenet"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        src = jsyn.ImageSource(cfg.image_size, cfg.num_classes)
        batch = {n: torch.from_numpy(v) for n, v in src.batch(2, 0).items()}
        loss, _ = model.loss_fn(params, batch)
        assert loss.dim() == 0 and torch.isfinite(loss)
        assert model.forward(params, batch).shape == (2, cfg.num_classes)
        again = model.init(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(params), jax.tree.leaves(again)))


# ---------------------------------------------------------------------------
# k = 2 gloo ranks against JAX's one device
# ---------------------------------------------------------------------------

STEPS, GLOBAL_BATCH = 2, 4
# of each leaf's largest step: the fp32 gradients of the two libraries
# differ by up to 1.7e-2 of a leaf's scale (the stem's; see the fp64 note
# at the top), so the two steps may too
STEP_TOL = 2e-2


@pytest.fixture(scope="module")
def googlenet_bsp(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    cfg = jget_smoke("googlenet")
    jp = _jax_params(cfg, seed=3)
    src = jsyn.ImageSource(cfg.image_size, cfg.num_classes)
    batches = [src.batch(GLOBAL_BATCH, i) for i in range(STEPS)]
    out = tmp_path_factory.mktemp("googlenet_bsp")
    torch.save(conv_params_from_jax(jp), out / "init.pt")
    torch.save([{n: torch.from_numpy(v) for n, v in b.items()}
                for b in batches], out / "batches.pt")
    run_ranks(bsp_worker, 2, (str(out), "googlenet", CONV_CASES))
    ports = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    model = dataclasses.replace(
        jbuild(cfg), init=lambda key: jax.tree.map(jnp.asarray, jp),
        loss_fn=lambda p, b, rng=None, unroll=False: jvision.conv_loss(
            p, b, cfg, None))
    opt = jopt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        state = jbsp.init_train_state(model, opt, jax.random.key(0))
        step = jax.jit(jbsp.make_bsp_step(model, opt,
                                          jex.get_exchanger("asa"),
                                          jsched.constant(LR), mesh))
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, b, jax.random.key(i))
            losses.append(float(metrics["loss"]))
    return ports, (jax.tree.map(np.asarray, state["params"]), losses), jp


@pytest.mark.parametrize("name", [c[0] for c in CONV_CASES])
def test_googlenet_two_gloo_ranks_equal_one_jax_device(googlenet_bsp, name):
    ports, (want_params, want_losses), init = googlenet_bsp
    worst = 0.0
    for res in ports:
        got = res[name]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
        for g, w, p0 in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(want_params),
                            jax.tree.leaves(init)):
            w, p0 = _oihw(w), _oihw(p0)
            moved = float(np.abs(w - p0).max())
            ulps = 2.0 ** -21 * float(np.abs(w).max())
            worst = max(worst, float(np.abs(g.numpy() - w).max() - ulps)
                        / moved)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=STEP_TOL * moved + ulps)
    print(f"{name}: max |dp| / max |step| = {worst:.3g}")
    for a, b in zip(jax.tree.leaves(ports[0][name]["params"]),
                    jax.tree.leaves(ports[1][name]["params"])):
        assert torch.equal(a, b)
