"""The two-level (``hier``) exchange on the CPU: 4 gloo ranks as 2 pods of
2 (``core.exchanger.make_transport(("pod", "data"), 2)``).

- Every strategy over the two levels (``exchange``, and its halves)
  against the numpy mean of the four ranks' trees, at the reference's
  own tolerances (``tests/test_exchangers.py``: max error over the
  largest magnitude, 1e-6 for ``ar``/``asa``/``ring``/``hier``, 2e-3 for
  ``asa16``/``hier16``, 5e-3 for ``ring16``, 5e-2 for ``asa8``, whose
  int8 falls back to fp16 across pods). The reference's own multipod
  tests do not run here, so the mean is the reference.
- The raw (fused) reduce-scatter is refused by name on two levels, and
  so is ``fuse_rs_update=True``.
- BSP steps of smoke AlexNet, each rank on a quarter of each batch:
  ``hier`` (fp32) and ``hier16`` with the sharded update, against JAX's
  1-device step on the whole batch (``asa`` / ``asa16`` sharded), at
  the tolerances of ``test_torch_train.py``.
- ``wire_summary`` of ``hier``/``hier16`` equals the JAX one (the plan
  over the pod's k), and ``make_transport`` checks its arguments.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import exchanger as jex  # noqa: E402
from repro_torch.bridge import conv_params_from_jax  # noqa: E402
from repro_torch.core import bsp as tbsp  # noqa: E402
from repro_torch.core import exchanger as tex  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from test_torch_ranks import (BUCKET_BYTES, HIER_CASES,  # noqa: E402
                              HIER_STRATEGIES, LR, PODS, hier_worker,
                              port_model, value_tree)
from test_torch_train import (STEPS, _assert_params_close,  # noqa: E402
                              _batches, _jax_model, _jax_run)

K = 4
TOL = {"ar": 1e-6, "asa": 1e-6, "ring": 1e-6, "hier": 1e-6,
       "asa16": 2e-3, "ring16": 5e-3, "hier16": 2e-3, "asa8": 5e-2}
JAX_REF = {"hier": ("asa", {}),
           "hier16-sharded": ("asa16", {"sharded_update": True,
                                        "fuse_rs_update": False})}


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("hier")
    jp = jax.tree.map(np.asarray, _jax_model().init(jax.random.key(0)))
    torch.save(conv_params_from_jax(jp), out / "init.pt")
    batches = _batches(STEPS)
    torch.save([{n: torch.from_numpy(v) for n, v in b.items()}
                for b in batches], out / "batches.pt")
    run_ranks(hier_worker, K, (str(out),))
    return ([torch.load(out / f"hier{r}.pt", weights_only=False)
             for r in range(K)],
            [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(K)], batches)


def test_ranks_form_two_pods(ranks):
    exch, _, _ = ranks
    assert [(r["k"], r["rank"], r["world"]) for r in exch] == [
        (2, 0, (0, 4)), (2, 1, (1, 4)), (2, 0, (2, 4)), (2, 1, (3, 4))]


@pytest.mark.parametrize("name", HIER_STRATEGIES)
def test_two_levels_give_the_mean(ranks, name):
    exch, _, _ = ranks
    trees = [[t.numpy() for t in jax.tree.leaves(value_tree(100 + r))]
             for r in range(K)]
    want = [np.mean(ls, axis=0) for ls in zip(*trees)]
    for res in exch:
        for bb in BUCKET_BYTES:
            for part in ("exchange", "halves"):
                for got, w in zip(res[(name, bb, part)], want):
                    err = np.abs(got - w).max() / (np.abs(w).max() + 1e-9)
                    assert err <= TOL[name], (name, bb, part, err)


def test_raw_reduce_scatter_is_single_level(ranks):
    exch, _, _ = ranks
    for res in exch:
        assert res["raw"] == tex.RAW_SINGLE_LEVEL


def test_fused_tail_is_refused_on_two_levels():
    two = tex.Transport(lead=tex.Transport())
    model = port_model({})
    with pytest.raises(ValueError, match="hier16.*two-level"):
        tbsp.make_bsp_step(model, topt.sgd_momentum(),
                           tex.get_exchanger("hier16"), tsched.constant(LR),
                           two, sharded_update=True, fuse_rs_update=True)
    # the default picks the unfused tail there
    tbsp.make_bsp_step(model, topt.sgd_momentum(),
                       tex.get_exchanger("hier16"), tsched.constant(LR), two,
                       sharded_update=True)


@pytest.fixture(scope="module")
def jax_runs(ranks):
    _, _, batches = ranks
    return {name: _jax_run(ex, kw, batches)
            for name, (ex, kw) in JAX_REF.items()}


@pytest.mark.parametrize("name,tol", [(c[0], c[3]) for c in HIER_CASES],
                         ids=[c[0] for c in HIER_CASES])
def test_four_ranks_on_two_pods_equal_one_jax_device(ranks, jax_runs, name,
                                                     tol):
    _, steps, _ = ranks
    want_params, want_losses = jax_runs[name]
    for res in steps:
        got = res[name]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
        _assert_params_close(got["params"], want_params, tol)
    for res in steps[1:]:
        for a, b in zip(jax.tree.leaves(steps[0][name]["params"]),
                        jax.tree.leaves(res[name]["params"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["hier", "hier16"])
@pytest.mark.parametrize("param_ag", [False, True])
def test_hier_wire_summary_equals_jax(name, param_ag):
    shapes = {"w1": (33, 77), "b1": (1237,), "small": (5,),
              "blocks": [(260, 300), (7,)]}
    is_shape = lambda s: isinstance(s, tuple)   # noqa: E731
    jp = jex.make_rs_plan(jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=is_shape), PODS, 1 << 20)
    tp = tex.make_rs_plan(jax.tree.map(
        lambda s: torch.empty(s, device="meta"), shapes, is_leaf=is_shape),
        PODS, 1 << 20)
    assert tex.wire_summary(tex.get_exchanger(name), tp, param_ag=param_ag) \
        == jex.wire_summary(jex.get_exchanger(name), jp, param_ag=param_ag)


def test_make_transport_checks_its_arguments():
    assert tex.make_transport().lead is None
    one = tex.make_transport(("pod", "data"))      # no process group
    assert (one.k, one.world_k, one.lead) == (1, 1, None)
    tr = tex.Transport()
    assert tex.make_transport(("pod", "data"), 2, tr) is tr
    with pytest.raises(ValueError, match="two data axes"):
        tex.make_transport(("data",), 2)
    with pytest.raises(ValueError, match="one or two levels"):
        tex.make_transport(("a", "b", "c"))
    with pytest.raises(ValueError, match="no process group"):
        tex.make_transport(("pod", "data"), 2)
