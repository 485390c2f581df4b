"""Async training, port against the JAX package, on the CPU.

One spawn of k = 2 gloo ranks (``test_torch_ranks.easgd_worker``) runs a
small classifier (two hidden layers, fp32; two bucketed and three small
leaves) through the port's ``train`` loop with ``easgd`` at tau 1, 2
and 3 (alpha 0.5) and ``asgd`` at tau 2, on ``asa`` and ``asa16``, 5
steps each, momentum SGD 0.9 with weight decay 5e-4. JAX's
``make_async_step`` runs the same plans on 2 forced host devices in a
subprocess (this process keeps one device), the engine's dispatch of
sync against local by ``(step + 1) % tau``. Held to it: each worker's
parameters and momentum and the center, at rtol 1e-4 with an atol of
1e-6 of each leaf's scale on ``asa``, and on ``asa16`` (both sides round
the same deltas to fp16) at the fp16 rule of ``test_torch_train.py``;
the loss of every step at rtol 1e-4, the two workers' mean and each
rank's own report alike (the loop averages local steps' losses over the
workers at each flush, as the reference's ``pmean`` does on every step);
the launcher's printed first and last loss of a 2-rank easgd run, which
are the fleet's.

Port only: ``asgd`` is ``easgd`` at alpha 1 bit for bit; ``asgd`` at tau
1 equals BSP with the learning rate times k to the reference's
tolerance (``tests/test_engine.py``: rel 1e-5, atol 1e-6); a local step
moves no transport counter; a run saved inside a tau window or at its
end and resumed equals the unbroken run bit for bit; the quorum sync
against a numpy model of its rule; ``reshard_async_state`` on numpy
rows.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro_torch.core import easgd  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from test_torch_ranks import (ASYNC_CASES, ASYNC_STEPS,  # noqa: E402
                              easgd_worker, tiny_batches, tiny_model)

K = 2

_JAX_ASYNC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import types
import jax, jax.numpy as jnp, numpy as np
from repro.core import easgd as je
from repro.core.exchanger import get_exchanger
from repro.optim import constant, sgd_momentum
from test_torch_ranks import (ASYNC_CASES, ASYNC_LR, ASYNC_STEPS,
                              tiny_batches, tiny_params)

params = tiny_params()


def loss_fn(p, batch, rng=None, unroll=False):
    h = jax.nn.relu(batch["x"] @ p["w1"] + p["b1"])
    logits = jnp.tanh(h @ p["w2"]) @ p["w3"] + p["b3"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    nll = lse - jnp.take_along_axis(logits, batch["y"][:, None], 1)[:, 0]
    loss = nll.mean()
    return loss, {"loss": loss, "aux": jnp.zeros((), jnp.float32)}


model = types.SimpleNamespace(
    init=lambda key: jax.tree.map(jnp.asarray, params), loss_fn=loss_fn)
mesh = jax.make_mesh((2,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
jax.set_mesh(mesh)
opt = sgd_momentum(momentum=0.9, weight_decay=5e-4)
batches = tiny_batches()
out = {}
for name, kw in ASYNC_CASES:
    local, sync = je.make_async_step(
        model, opt, get_exchanger(kw["exchanger"]), constant(ASYNC_LR), mesh,
        algo=kw["algo"], alpha=0.5 if kw["algo"] == "easgd" else 1.0)
    local, sync = jax.jit(local), jax.jit(sync)
    state = je.init_async_state(model, opt, jax.random.key(0), 2, mesh=mesh)
    losses = []
    for i, b in enumerate(batches):
        fn = sync if (i + 1) % kw["tau"] == 0 else local
        state, m = fn(state, b, jax.random.key(i))
        losses.append(float(m["loss"]))
    out[f"{name}:losses"] = np.asarray(losses)
    for part in ("params", "opt", "center"):
        for i, leaf in enumerate(jax.tree.leaves(state[part])):
            out[f"{name}:{part}:{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("easgd")
    run_ranks(easgd_worker, K, (str(out),))
    return [torch.load(out / f"easgd{r}.pt", weights_only=False)
            for r in range(K)]


@pytest.fixture(scope="module")
def jax_async(tmp_path_factory):
    here = Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("jax_async") / "async.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here)]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_ASYNC, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    if tol == "fp16":
        small = want.size <= 1024
        np.testing.assert_allclose(got, want, rtol=0, atol=(
            1e-2 if small else 2.0 ** -10) * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.parametrize("name", [c[0] for c in ASYNC_CASES])
def test_async_workers_equal_the_jax_plan(ranks, jax_async, name):
    tol = "fp16" if name.endswith("asa16") else "fp32"
    losses = np.mean([r[name]["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(losses, jax_async[f"{name}:losses"],
                               rtol=1e-4)
    for r, res in enumerate(ranks):
        assert res[name]["step"] == ASYNC_STEPS
        for part in ("params", "opt"):
            for i, got in enumerate(res[name][part]):
                _close(got, jax_async[f"{name}:{part}:{i}"][r], tol)
        for i, got in enumerate(res[name]["center"]):
            _close(got, jax_async[f"{name}:center:{i}"], tol)


@pytest.mark.parametrize("name", [c[0] for c in ASYNC_CASES])
def test_each_rank_reports_the_jax_plans_loss(ranks, jax_async, name):
    """Rank 0's own ``report.losses`` (and rank 1's) is the fleet mean on
    local steps too: JAX's ``pmean`` at every step."""
    for res in ranks:
        np.testing.assert_allclose(res[name]["losses"],
                                   jax_async[f"{name}:losses"], rtol=1e-4)
    assert ranks[0][name]["losses"] == ranks[1][name]["losses"]


def test_launcher_prints_the_fleet_loss(capfd):
    """At tau 3, steps 0, 1, 3 and 4 are local: the printed first loss is
    the two workers' mean (7.9451 and 7.1996 on their own), not rank 0's."""
    from repro_torch.launch import train as launch
    launch.main(["--smoke", "--device", "cpu", "--ranks", "2", "--batch",
                 "4", "--steps", "6", "--algo", "easgd", "--tau", "3"])
    out = capfd.readouterr().out
    assert "easgd tau=3" in out and "loss 7.5724 -> 8.8255" in out


def test_asgd_is_easgd_at_alpha_one_bit_for_bit(ranks):
    for res in ranks:
        a, b = res["asgd-tau2-asa"], res["easgd-alpha1-tau2-asa"]
        assert a["losses"] == b["losses"]
        for part in ("params", "opt", "center"):
            for x, y in zip(a[part], b[part]):
                assert np.array_equal(x, y)


def test_asgd_tau1_is_bsp_with_k_times_the_lr(ranks):
    for res in ranks:
        a, b = res["asgd-tau1"], res["bsp-lr-k"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
        for x, y in zip(a["center"], b["params"]):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
        for x, c in zip(a["params"], a["center"]):      # workers snapped
            assert np.array_equal(x, c)


def test_local_steps_move_no_transport_counter(ranks):
    for res in ranks:
        for name, _ in ASYNC_CASES:
            kinds = res[name]["by_kind"]
            if "local" in kinds:
                assert kinds["local"]["steps"] > 0
                for c in ("staged_bytes", "stage_s", "wire_s", "exposed_s"):
                    assert kinds["local"][c] == 0, (name, c)
            assert kinds["sync"]["wire_s"] > 0


@pytest.mark.parametrize("at", [3, 4], ids=["inside-a-window", "at-its-end"])
def test_resume_is_bitwise(ranks, at):
    for res in ranks:
        r = res["resume"]
        got, step, losses = r[at]
        assert step == ASYNC_STEPS and losses == r["full_losses"][at:]
        for part in ("params", "opt", "center"):
            for x, y in zip(got[part], r["full"][part]):
                assert np.array_equal(x, y)


def test_quorum_sync_follows_its_rule(ranks):
    vectors = (((0.5, 0.25), (0.0, 1.0)), ((0.3, 0.6), (0.4, 0.0)),
               ((0.5, 0.5), (1.0, 0.7)))
    for rnd, (absorb, attract) in enumerate(vectors):
        rows = [res["quorum"][rnd] for res in ranks]
        c0 = rows[0]["before"]["center"]
        w = [row["local"]["params"] for row in rows]
        want_c = [c + sum(a * (wi[j] - c) for a, wi in zip(absorb, w))
                  for j, c in enumerate(c0)]
        for r, row in enumerate(rows):
            for j, (got, c) in enumerate(zip(row["after"]["center"],
                                             want_c)):
                np.testing.assert_allclose(got, c, rtol=1e-5, atol=1e-6)
            at = attract[r]
            for j, got in enumerate(row["after"]["params"]):
                if at == 0.0:
                    assert np.array_equal(got, w[r][j])
                elif at == 1.0:
                    assert np.array_equal(got, row["after"]["center"][j])
                else:
                    np.testing.assert_allclose(
                        got, w[r][j] - at * (w[r][j] - want_c[j]),
                        rtol=1e-5, atol=1e-6)


def test_elastic_programs_run_the_quorum_sync_on_one_rank():
    """``build_elastic_programs``: the quorum plan's local and sync steps
    on a group of one (attract 1 snaps the worker to the centre); a BSP
    plan is refused."""
    plan = tengine.TrainPlan(algo="easgd", tau=2, quorum=1)
    progs = tengine.build_elastic_programs(
        plan, tiny_model(), topt.sgd_momentum(), tsched.constant(0.05))
    assert progs.k == 1 and progs.wire(progs.init_state(None)["params"])
    state = progs.init_state(None)
    batch = {n: torch.from_numpy(v) for n, v in tiny_batches(1)[0].items()}
    state, _ = progs.local(state, batch)
    state, m = progs.sync(state, batch, absorb=[0.5], attract=[1.0])
    assert state["step"] == 2 and torch.isfinite(m["loss"])
    for w, c in zip(state["params"].values(), state["center"].values()):
        assert torch.equal(w, c)
    with pytest.raises(ValueError, match="easgd/asgd"):
        tengine.build_elastic_programs(tengine.TrainPlan(), tiny_model(),
                                       topt.sgd_momentum(),
                                       tsched.constant(0.05))


def test_reshard_keeps_survivors_and_starts_joiners_at_the_center():
    rng = np.random.default_rng(3)
    center = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    rows = {"w": rng.standard_normal((3, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((3, 5)).astype(np.float32)}
    mom = {"m": {n: rng.standard_normal(v.shape).astype(np.float32)
                 for n, v in rows.items()}}
    state = {"params": rows, "opt": mom, "center": center, "step": 7}
    opt = topt.sgd_momentum()
    new = easgd.reshard_async_state(state, (10, 11, 12), (12, 10, 99),
                                    opt, k=3)
    for n in rows:
        assert isinstance(new["params"][n], np.ndarray)
        np.testing.assert_array_equal(new["params"][n][0], rows[n][2])
        np.testing.assert_array_equal(new["params"][n][1], rows[n][0])
        np.testing.assert_array_equal(new["params"][n][2], center[n])
        np.testing.assert_array_equal(new["opt"]["m"][n][0],
                                      mom["m"][n][2])
        np.testing.assert_array_equal(new["opt"]["m"][n][2], 0)
    assert new["step"] == 7 and new["center"] is center
    with pytest.raises(ValueError, match="membership"):
        easgd.reshard_async_state(state, (10, 11, 12), (10,), opt, k=2)
    # torch rows stay torch
    tstate = {"params": {n: torch.from_numpy(v) for n, v in rows.items()},
              "opt": {"m": {n: torch.from_numpy(v)
                            for n, v in mom["m"].items()}},
              "center": {n: torch.from_numpy(v) for n, v in center.items()},
              "step": 7}
    tnew = easgd.reshard_async_state(tstate, (10, 11, 12), (11, 5), opt)
    assert torch.equal(tnew["params"]["w"][0], tstate["params"]["w"][1])
    assert torch.equal(tnew["params"]["w"][1], tstate["center"]["w"])
