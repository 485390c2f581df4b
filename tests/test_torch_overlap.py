"""``overlap="buckets"``, port against the JAX package, on the CPU.

One spawn of k = 2 gloo ranks takes 3 steps of smoke AlexNet (96 px, 16
classes, dropout off, fp32) in every case of
``test_torch_ranks.OVERLAP_CASES``, each rank on its half of each batch
in 2 microbatches of one image: the overlap on ``asa`` and ``asa16``,
through the fused tail and the unfused one, and the sharded microbatched
step without overlap. JAX's 1-device ``make_bsp_step`` with
``overlap="buckets"`` and 2 microbatches (its unfused tail) takes the
same 3 steps on the whole batches, as ``test_torch_train.py`` holds BSP:
rtol 1e-4 (atol 1e-6 of each leaf's scale) on ``asa``, the fp16 rule on
``asa16``, the losses at rtol 1e-4.

Port only: the overlapped step equals the non-overlapped microbatched
sharded step at fp32 (rtol 1e-4); the overlap's analytic wire (m times
the reduce-scatter bytes) equals the JAX engine's ``_plan_wire``, for
every plan kind; the async all-to-all (``Transport.all_to_all_start``)
equals the synchronous one.
"""
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.core import bsp as jbsp  # noqa: E402
from repro.core import exchanger as jex  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro_torch.bridge import conv_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import exchanger as tex  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from test_torch_ranks import (LR, OVERLAP_CASES, bsp_worker,  # noqa: E402
                              value_tree)
from test_torch_train import (STEPS, _assert_params_close,  # noqa: E402
                              _batches, _jax_model)

JAX_REF = {"asa": ("asa", {}), "asa16": ("asa16", {})}


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("overlap")
    jp = jax.tree.map(np.asarray, _jax_model().init(jax.random.key(0)))
    torch.save(conv_params_from_jax(jp), out / "init.pt")
    batches = _batches(STEPS)
    torch.save([{n: torch.from_numpy(v) for n, v in b.items()}
                for b in batches], out / "batches.pt")
    run_ranks(bsp_worker, 2, (str(out), "alexnet", OVERLAP_CASES))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)], batches


def _jax_overlap(exname, batches):
    model = _jax_model()
    opt = jopt.sgd_momentum(momentum=0.9, weight_decay=5e-4)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        state = jbsp.init_sharded_train_state(model, opt, jax.random.key(0),
                                              mesh)
        step = jax.jit(jbsp.make_bsp_step(
            model, opt, jex.get_exchanger(exname), jsched.constant(LR), mesh,
            overlap="buckets", microbatches=2, fuse_rs_update=False))
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, b, jax.random.key(i))
            losses.append(float(metrics["loss"]))
    return jax.tree.map(np.asarray, state["params"]), losses


@pytest.fixture(scope="module")
def jax_runs(runs):
    _, batches = runs
    return {ex: _jax_overlap(ex, batches) for ex in ("asa", "asa16")}


@pytest.mark.parametrize("name,exname,tol",
                         [(c[0], c[1], c[3]) for c in OVERLAP_CASES],
                         ids=[c[0] for c in OVERLAP_CASES])
def test_overlap_on_two_ranks_equals_one_jax_device(runs, jax_runs, name,
                                                    exname, tol):
    ports, _ = runs
    want_params, want_losses = jax_runs[exname]
    for res in ports:
        got = res[name]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
        _assert_params_close(got["params"], want_params, tol)
    for a, b in zip(jax.tree.leaves(ports[0][name]["params"]),
                    jax.tree.leaves(ports[1][name]["params"])):
        assert torch.equal(a, b)


def test_overlap_equals_the_microbatched_sharded_step(runs):
    ports, _ = runs
    for res in ports:
        for a, b in zip(jax.tree.leaves(res["asa-overlap"]["params"]),
                        jax.tree.leaves(res["asa-mb2-sharded"]["params"])):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6 * scale)


_PLANS = [dict(exchanger="asa16"),
          dict(exchanger="asa16", sharded_update=True),
          dict(exchanger="asa16", overlap="buckets", microbatches=2),
          dict(exchanger="asa8", overlap="buckets", microbatches=4,
               bucket_bytes=1 << 20),
          dict(algo="easgd", exchanger="asa16", tau=4),
          dict(algo="asgd", exchanger="ar", tau=2),
          dict(exchanger="hier16", data_axes=("pod", "data"),
               sharded_update=True),
          dict(exchanger="none")]


@pytest.mark.parametrize("kw", _PLANS, ids=[str(p) for p in _PLANS])
def test_plan_wire_equals_the_jax_engine(kw):
    """The engine's bytes on the wire a step, for smoke AlexNet at k = 2
    on the reduce-scatter axis (JAX reads k off the mesh's last axis)."""
    params = build_model(get_smoke_config("alexnet"), "meta").init(None)
    got = tengine.plan_wire(tengine.TrainPlan(**kw), params, 2)
    mesh = types.SimpleNamespace(shape={"data": 2, "pod": 2})
    want = jengine._plan_wire(jengine.TrainPlan(**kw), _jax_model(), mesh)
    assert got == want


@pytest.mark.parametrize("name", ["asa", "asa16", "asa8"])
def test_async_all_to_all_equals_the_synchronous_one(name):
    """One rank (no process group): the identity, through both routes,
    and ``reduce_scatter_start`` returns what ``reduce_scatter`` does."""
    tree = value_tree(5)
    ex = tex.get_exchanger(name)
    for bb in (0, 16384):
        plan = tex.make_rs_plan(tree, 1, bb)
        for raw in (False, True):
            want, _ = ex.reduce_scatter(tree, plan=plan, raw=raw)
            got = ex.reduce_scatter_start(tree, plan=plan, raw=raw).finish()
            assert sorted(got) == sorted(want)
            for key in want:
                for a, b in zip(got[key], want[key]):
                    assert a.dtype == b.dtype and torch.equal(a, b)
