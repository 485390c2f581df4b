"""The training slice end to end, port against the JAX package, on the CPU.

- BSP: one spawn of k=2 gloo ranks takes 3 steps of smoke AlexNet (96 px,
  16 classes, dropout off, fp32) in every case below, each rank on its
  half of each batch; JAX's 1-device ``make_bsp_step`` takes the same 3
  steps on the concatenated batches from the same parameters.
  - ``ar``, ``asa``, ``awagd`` and ``asa`` with 2 microbatches: the
    halves' mean gradient is the whole batch's, so only fp32 summation
    order differs: rtol 1e-4 with an atol of 1e-6 of each leaf's scale.
  - ``asa16`` sharded, fused (the ``fused_rs_update`` path) and unfused:
    each rank's gradient is rounded to fp16 on its own (JAX's one device
    rounds the whole batch's), and the parameters come back through an
    fp16 all-gather every step, so an element may land one fp16 rounding
    step away: atol 2^-10 of each bucketed leaf's largest magnitude. The
    small leaves (biases of <= 1024 elements) travel in fp32, but their
    gradients sum many terms of a network whose weights differ by those
    roundings, with cancellation: atol 1e-2 of the leaf's largest
    magnitude. Against JAX's unfused sharded step (JAX holds its own
    fused and unfused paths equal); the port's fused and unfused paths
    are equal bit for bit on the CPU.
- The port's ``train`` (one rank) tracks JAX's ``train`` over a 5-step
  fp32 loss curve on the same batches: rtol 1e-4.
- Copies pinned to their originals: ``TrainPlan``'s validation, the
  synthetic data sources, ``preprocess_images``; ``ParallelLoader``'s
  failure and timeout semantics; the launcher on the CPU.
"""
import dataclasses
import functools
import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import bsp as jbsp  # noqa: E402
from repro.core import exchanger as jex  # noqa: E402
from repro.data import prefetch as jprefetch  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import vision as jvision  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.bridge import conv_params_from_jax  # noqa: E402
from repro_torch.core import bsp as tbsp  # noqa: E402
from repro_torch.core import exchanger as tex  # noqa: E402
from repro_torch.data import prefetch as tprefetch  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from test_torch_ranks import CASES, LR, bsp_worker, port_model  # noqa: E402

STEPS, GLOBAL_BATCH = 3, 4
JAX_REF = {"ar": ("ar", {}), "asa": ("asa", {}), "asa-mb2": ("asa", {}),
           "awagd": ("asa", {"scheme": "awagd"}),
           "asa16-sharded-fused": ("asa16", {"sharded_update": True,
                                             "fuse_rs_update": False}),
           "asa16-sharded": ("asa16", {"sharded_update": True,
                                       "fuse_rs_update": False})}


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _no_dropout(model, loss):
    return dataclasses.replace(model, loss_fn=loss)


@functools.cache
def _init_params():
    """Smoke AlexNet parameters in the reference's layout, from numpy
    (an eager JAX init takes seconds)."""
    cfg = jget_smoke("alexnet")
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: jvision.init_alexnet(k, cfg),
                            jax.random.key(0))
    return jax.tree.map(lambda l: (rng.standard_normal(l.shape) * np.sqrt(
        2.0 / np.prod(l.shape[:-1]))).astype(np.float32), shapes)


def _jax_model():
    cfg = jget_smoke("alexnet")
    model = _no_dropout(jbuild(cfg), lambda p, b, rng=None, unroll=False:
                        jvision.conv_loss(p, b, cfg, None))
    return dataclasses.replace(
        model, init=lambda key: jax.tree.map(jax.numpy.asarray,
                                             _init_params()))


def _batches(n, size=GLOBAL_BATCH):
    cfg = jget_smoke("alexnet")
    src = jsyn.ImageSource(cfg.image_size, cfg.num_classes)
    return [src.batch(size, i) for i in range(n)]


def _oihw(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _assert_params_close(got, want, tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = _oihw(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        scale = float(np.abs(w).max())
        if tol == "fp16":
            small = w.size <= tex._SMALL_LEAF
            np.testing.assert_allclose(
                g, w, rtol=0, atol=(1e-2 if small else 2.0 ** -10) * scale)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# k = 2 gloo ranks against JAX's one device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bsp_runs(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("bsp")
    jp = jax.tree.map(np.asarray, _jax_model().init(jax.random.key(0)))
    torch.save(conv_params_from_jax(jp), out / "init.pt")
    batches = _batches(STEPS)
    torch.save([{n: torch.from_numpy(v) for n, v in b.items()}
                for b in batches], out / "batches.pt")
    run_ranks(bsp_worker, 2, (str(out),))
    ports = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ports, batches


def _jax_run(exname, kw, batches):
    model = _jax_model()
    opt = jopt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        if kw.get("sharded_update"):
            state = jbsp.init_sharded_train_state(model, opt,
                                                  jax.random.key(0), mesh)
        else:
            state = jbsp.init_train_state(model, opt, jax.random.key(0))
        step = jax.jit(jbsp.make_bsp_step(model, opt,
                                          jex.get_exchanger(exname),
                                          jsched.constant(LR), mesh, **kw))
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, b, jax.random.key(i))
            losses.append(float(metrics["loss"]))
    return jax.tree.map(np.asarray, state["params"]), losses


@pytest.fixture(scope="module")
def jax_runs(bsp_runs):
    _, batches = bsp_runs
    out = {}
    for name, _, _, _ in CASES:
        ref = JAX_REF[name]
        key = (ref[0], tuple(sorted(ref[1].items())))
        if key not in out:
            out[key] = _jax_run(ref[0], ref[1], batches)
    return {name: out[(JAX_REF[name][0],
                       tuple(sorted(JAX_REF[name][1].items())))]
            for name, _, _, _ in CASES}


@pytest.mark.parametrize("name,tol", [(c[0], c[3]) for c in CASES],
                         ids=[c[0] for c in CASES])
def test_two_gloo_ranks_equal_one_jax_device(bsp_runs, jax_runs, name, tol):
    ports, _ = bsp_runs
    want_params, want_losses = jax_runs[name]
    for res in ports:
        got = res[name]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
        _assert_params_close(got["params"], want_params, tol)
    # both ranks hold the same replica
    for a, b in zip(jax.tree.leaves(ports[0][name]["params"]),
                    jax.tree.leaves(ports[1][name]["params"])):
        assert torch.equal(a, b)


def test_sharded_fused_and_unfused_agree(bsp_runs):
    ports, _ = bsp_runs
    for res in ports:
        for a, b in zip(jax.tree.leaves(res["asa16-sharded-fused"]["params"]),
                        jax.tree.leaves(res["asa16-sharded"]["params"])):
            assert torch.equal(a, b)


def test_bsp_step_options_are_checked():
    model = port_model({})
    opt, ex = topt.sgd_momentum(), tex.get_exchanger("ar")
    with pytest.raises(ValueError, match="subgd"):
        tbsp.make_bsp_step(model, opt, ex, tsched.constant(LR),
                           scheme="awagd", sharded_update=True)
    with pytest.raises(ValueError, match="fuse_rs_update"):
        tbsp.make_bsp_step(model, opt, ex, tsched.constant(LR),
                           sharded_update=True, fuse_rs_update=True)
    # the overlap, the async and the gspmd plans build and step (their
    # parity is held in test_torch_overlap.py / test_torch_easgd.py /
    # test_torch_gspmd.py); quorum plans are refused by name
    batch = {n: torch.from_numpy(v) for n, v in _batches(1, 2)[0].items()}
    real = port_model(conv_params_from_jax(_init_params()))
    for plan in (tengine.TrainPlan(overlap="buckets", microbatches=2),
                 tengine.TrainPlan(algo="easgd", tau=2),
                 tengine.TrainPlan(algo="asgd"),
                 tengine.TrainPlan(algo="gspmd", mode="zero1"),
                 tengine.TrainPlan(algo="gspmd", mode="ar")):
        eng = tengine.build_engine(plan, real, opt, tsched.constant(LR))
        state = eng.init_state(None)
        for i in range(2):
            state, m = eng.step(state, batch, step_idx=i)
        assert state["step"] == 2 and torch.isfinite(m["loss"])
        assert ("center" in state) == plan.is_async
        # one rank: its shards are the whole leaves; no exchanger, no wire
        assert (eng.specs is not None) == (plan.algo == "gspmd")
        if plan.algo == "gspmd":
            assert eng.wire(state["params"]) is None
    with pytest.raises(ValueError, match="quorum"):
        tengine.build_engine(tengine.TrainPlan(algo="easgd", quorum=1),
                             model, opt, tsched.constant(LR))


def test_shard_wd_mask_marks_matrix_elements_only():
    tree = {"a": torch.zeros(3, 700), "b": torch.zeros(1500),
            "c": torch.zeros(40, 30)}
    plan = tex.make_rs_plan(tree, 3, 1 << 20)
    (b,) = plan.buckets
    full = torch.cat([tbsp.shard_wd_mask(plan, b, r * b.shard_len, "cpu")
                      for r in range(3)])
    want = torch.cat([torch.ones(2100), torch.zeros(1500), torch.ones(1200),
                      torch.zeros(b.padded - 4800)])
    assert torch.equal(full, want)


# ---------------------------------------------------------------------------
# the loop: a 5-step loss curve against JAX's train
# ---------------------------------------------------------------------------

def test_train_loss_curve_tracks_jax(monkeypatch):
    from repro.telemetry import _runtime
    monkeypatch.setattr(_runtime._state.config, "profile", False)
    batches = _batches(5)
    jmodel = _jax_model()
    jopt_ = jopt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    lr_j = jsched.step_decay(0.002, 2)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        _, jrep = jloop.train(jmodel, jopt_, lr_j, mesh, iter(batches),
                              plan=jengine.TrainPlan(exchanger="asa"),
                              num_steps=5, log_every=2,
                              print_fn=lambda *a: None)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    model = port_model(conv_params_from_jax(jp))
    topt_ = topt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    lines = []
    tb = [{n: torch.from_numpy(v) for n, v in b.items()} for b in batches]
    _, rep = tloop.train(model, topt_, tsched.step_decay(0.002, 2), tb,
                         tengine.TrainPlan(exchanger="asa"), num_steps=5,
                         log_every=2, print_fn=lines.append)
    assert rep.steps == 5 and len(rep.losses) == 5
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-4)
    assert lines[0].startswith("step     0") and len(lines) == 3
    reg = rep.metrics
    assert reg["train/steps"].value == 5
    assert reg["train/examples"].value == 5 * GLOBAL_BATCH
    assert reg["train/step_time_s"].count == 4          # first step apart
    for p in ("fwd_bwd", "exchange", "update"):
        assert reg[f"train/{p}_time_s"].count == 4
        assert rep.phase_s[p] > 0
    assert reg["exchange/bytes_wire"].value == 0     # one rank: no wire
    assert rep.first_step_time > 0 and rep.steady_examples_per_s > 0


# ---------------------------------------------------------------------------
# copies pinned to their originals
# ---------------------------------------------------------------------------

PLANS = [dict(), dict(algo="easgd", tau=4), dict(algo="asgd", alpha=0.5),
         dict(algo="easgd", sharded_update=True), dict(tau=2),
         dict(algo="gspmd", exchanger="asa16"), dict(mode="ar"),
         dict(algo="bsp", alpha=0.3), dict(algo="asgd", exchanger="none"),
         dict(quorum=2), dict(algo="easgd", quorum=0), dict(scheme="x"),
         dict(overlap="layers"), dict(algo="nope"), dict(tau=0),
         dict(algo="gspmd", mode="ar"), dict(sharded_update=True,
                                             microbatches=4)]


@pytest.mark.parametrize("kw", PLANS, ids=[str(p) for p in PLANS])
def test_trainplan_validation_is_the_reference(kw):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(**kw))
        except ValueError as e:
            return f"ValueError: {e}"
    assert outcome(tengine.TrainPlan) == outcome(jengine.TrainPlan)


def test_synthetic_sources_are_the_reference(tmp_path):
    for step in (0, 3):
        a = tsyn.ImageSource(35, 7, seed=2).batch(3, step)
        b = jsyn.ImageSource(35, 7, seed=2).batch(3, step)
        assert all(np.array_equal(a[k], b[k]) for k in b)
        a = tsyn.LMTokenSource(50, 9).batch(2, step)
        b = jsyn.LMTokenSource(50, 9).batch(2, step)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    paths = tsyn.materialize_batch_files(tsyn.ImageSource(16, 3), tmp_path,
                                         2, 2)
    assert [os.path.basename(p) for p in paths] == ["batch_00000.npz",
                                                    "batch_00001.npz"]


def test_preprocess_is_the_reference():
    b = jsyn.ImageSource(24, 5).batch(4, 1)
    mean = np.full((24, 24, 3), 0.25, np.float32)
    for train in (True, False):
        for seed in range(4):
            got = tprefetch.preprocess_images(
                b, mean, 16, np.random.default_rng(seed), train)
            want = jprefetch.preprocess_images(
                b, mean, 16, np.random.default_rng(seed), train)
            assert np.array_equal(got["images"], want["images"])


def test_parallel_loader_streams_and_fails_loudly(tmp_path):
    src = tsyn.ImageSource(20, 4)
    files = tsyn.materialize_batch_files(src, tmp_path, 3, 2)
    mean = np.zeros((20, 20, 3), np.float32)
    loader = tprefetch.ParallelLoader(files, image_mean=mean, crop=16,
                                      epochs=2, seed=1)
    got = list(loader)
    assert len(got) == 6 and got[0]["images"].shape == (2, 16, 16, 3)
    assert got[0]["images"].dtype == torch.float32
    assert torch.equal(got[4]["labels"], torch.from_numpy(
        src.batch(2, 1)["labels"]))
    bad = tprefetch.ParallelLoader([files[0], str(tmp_path / "missing.npz")])
    assert bad.get() is not None
    with pytest.raises(tprefetch.LoaderError, match="missing"):
        bad.get()
    with pytest.raises(tprefetch.LoaderError):   # stays failed
        bad.get()
    bad.stop()
    slow = tprefetch.ParallelLoader(files, io_delay_ms=2000, timeout=0.2)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="stalled"):
        slow.get()
    assert time.perf_counter() - t0 < 1.5
    slow.stop()
    assert not slow._thread.is_alive()


@pytest.mark.parametrize("argv,label", [
    (["--algo", "easgd", "--tau", "2"], "easgd tau=2 alpha=0.5 on asa16"),
    (["--overlap", "buckets", "--microbatches", "2"],
     "asa16 overlap=buckets microbatches=2"),
    (["--ranks", "4", "--pods", "2", "--exchanger", "hier16",
      "--sharded-update"], "hier16 sharded on 2 pods"),
], ids=["easgd", "overlap", "hier16"])
def test_launcher_trains_the_other_plans_on_the_cpu(capfd, argv, label):
    from repro_torch.launch import train as launch
    launch.main(["--smoke", "--device", "cpu", "--ranks", "2", "--batch",
                 "4", "--steps", "3", *argv])
    out = capfd.readouterr().out
    assert "done: 3 steps of alexnet" in out and label in out
    assert "nan" not in out


def test_launcher_refuses_pods_that_do_not_split_the_ranks(capsys):
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--ranks", "3", "--pods", "2"])
    assert "pods" in capsys.readouterr().err


def test_launcher_trains_on_the_cpu(capfd):
    from repro_torch.launch import train as launch
    launch.main(["--smoke", "--device", "cpu", "--ranks", "2", "--batch", "2",
                 "--steps", "2", "--exchanger", "asa16",
                 "--sharded-update"])
    out = capfd.readouterr().out
    assert "done: 2 steps of alexnet" in out and "2 ranks (gloo, cpu)" in out
    assert launch.pick_backend(torch.device("cpu"), 2) == "gloo"
