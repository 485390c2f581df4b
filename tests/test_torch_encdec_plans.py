"""The encoder-decoder under every training plan, port against the JAX
package, on the CPU.

One spawn of k = 2 gloo ranks (``test_torch_ranks.encdec_plans_worker``)
trains the fp32 smoke SeamlessM4T-v2 backbone (2 + 2 layers, 64 stub
frames; no remat) from the port's init through the training loop under
gspmd ``zero1``, ``easgd`` (tau 1, alpha 0.5) and ``asgd`` (tau 1) on
``asa``, and BSP ``asa`` with the sharded update and plain at k x lr,
each 3 steps of momentum SGD (0.9, weight decay 1e-4) at lr 0.05, each
rank on its half of every global batch of the launcher's
``synthetic_batch`` (frames included). The reference runs the same
plans from the same parameters in a subprocess with 2 forced host
devices: its gspmd engine on one ``Auto`` device on the whole batches,
its ``make_async_step`` on the two (``tests/test_torch_gspmd.py``,
``tests/test_torch_easgd.py``). Held to it: the losses at rtol 1e-5
(gspmd) and 1e-4 (async), the parameters (rank 0's worker for the async
plans) at rtol 1e-4 / atol 1e-6 — the reference's own bounds for its
gspmd against BSP (``tests/test_engine.py``). The port's identities
too: gspmd ``zero1`` equals BSP with the sharded update, and ``asgd``
at tau 1 equals BSP at k x lr, at the same bounds.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_ranks import (PLAN_LR, PLAN_STEPS,  # noqa: E402
                              encdec_plans_worker)

ARCH = "seamless-m4t-large-v2"
K = 2
HERE = Path(__file__).resolve().parent

_JAX_PLANS = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.core import easgd as je
from repro.core.exchanger import get_exchanger
from repro.launch.train import synthetic_batch
from repro.models import build_model
from repro.optim import constant, sgd_momentum
from repro.train import engine as jengine
from repro_torch.bridge import encdec_params_from_jax
from repro_torch.tree import leaves
from test_torch_ranks import PLAN_BATCH, PLAN_LR, PLAN_STEPS

cfg = get_smoke_config("seamless-m4t-large-v2").with_overrides(
    dtype="float32", remat=False)
flat = dict(np.load(sys.argv[1]))
params = {}
for key, v in flat.items():
    d = params
    *path, last = key.split("/")
    for p in path:
        d = d.setdefault(p, {})
    d[last] = jnp.asarray(v)
model = dataclasses.replace(build_model(cfg), init=lambda key: params)
batches = [jax.tree.map(jnp.asarray, synthetic_batch(cfg, 2 * PLAN_BATCH, i,
                                                     16))
           for i in range(PLAN_STEPS)]
opt = sgd_momentum(momentum=0.9, weight_decay=1e-4)
out = {}


def save(name, losses, tree):
    out[f"{name}:losses"] = np.asarray(losses)
    port = encdec_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    for i, leaf in enumerate(leaves(port)):
        out[f"{name}:{i}"] = leaf.numpy()


one = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                    axis_types=(jax.sharding.AxisType.Auto,))
with jax.set_mesh(one):
    eng = jengine.build_engine(jengine.TrainPlan(algo="gspmd", mode="zero1"),
                               model, opt, constant(PLAN_LR), one)
    state, losses = eng.init_state(jax.random.key(0)), []
    for i, b in enumerate(batches):
        state, m = eng.step(state, b, jax.random.key(i), i)
        losses.append(float(m["loss"]))
    save("gspmd", losses, state["params"])
two = jax.make_mesh((2,), ("data",),
                    axis_types=(jax.sharding.AxisType.Auto,))
with jax.set_mesh(two):
    for algo in ("easgd", "asgd"):
        _, sync = je.make_async_step(
            model, opt, get_exchanger("asa"), constant(PLAN_LR), two,
            algo=algo, alpha=0.5 if algo == "easgd" else 1.0)
        sync = jax.jit(sync)
        state = je.init_async_state(model, opt, jax.random.key(0), 2,
                                    mesh=two)
        losses = []
        for i, b in enumerate(batches):
            state, m = sync(state, b, jax.random.key(i))
            losses.append(float(m["loss"]))
        save(algo, losses, jax.tree.map(lambda x: x[0], state["params"]))
np.savez(sys.argv[2], **out)
"""


def _cfg():
    return get_smoke_config(ARCH).with_overrides(dtype="float32",
                                                 remat=False)


def _init():
    return build_model(_cfg(), "cpu").init(0)


def _flat_stacked(params):
    """The reference's tree (``enc``/``dec`` stacked) of the port's
    parameters, flattened to ``a/b/c`` keys."""
    out = {}

    def put(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                put(f"{prefix}{k}/", v)
        else:
            out[prefix[:-1]] = t
    for k, v in params.items():
        if k in ("enc", "dec"):
            put(f"{k}/", _stack(v))
        else:
            out[k] = v.numpy()
    return out


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return np.stack([t.numpy() for t in layers])


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("encdec_plans")
    run_ranks(encdec_plans_worker, K, (str(out), _cfg(), _init()))
    return torch.load(out / "encdec_plans.pt", weights_only=False)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_plans")
    np.savez(d / "params.npz", **_flat_stacked(_init()))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_PLANS,
                           str(d / "params.npz"), str(d / "runs.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "runs.npz"))


def _close_trees(got, want, rtol=1e-4, atol=1e-6):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("plan,rtol", [("gspmd", 1e-5), ("easgd", 1e-4),
                                       ("asgd", 1e-4)])
def test_plan_equals_the_references(port_runs, jax_runs, plan, rtol):
    run = port_runs[plan]
    np.testing.assert_allclose(run["losses"], jax_runs[f"{plan}:losses"],
                               rtol=rtol)
    want = [jax_runs[f"{plan}:{i}"] for i in range(len(run["params"]))]
    moved = max(float(np.abs(w - p.numpy()).max())
                for w, p in zip(want, leaves(_init())))
    assert moved > 1e-3                       # the steps did move them
    _close_trees(run["params"], want)


def test_zero1_equals_bsp_sharded_update(port_runs):
    z, b = port_runs["gspmd"], port_runs["bsp-sharded"]
    np.testing.assert_allclose(z["losses"], b["losses"], rtol=1e-5)
    _close_trees(z["params"], b["params"])


def test_asgd_tau1_equals_bsp_at_k_lr(port_runs):
    a, b = port_runs["asgd"], port_runs["bsp-klr"]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    _close_trees(a["params"], b["params"], rtol=1e-5)
    assert len(a["losses"]) == PLAN_STEPS and PLAN_LR > 0
