"""Sharded (GSPMD/FSDP) training, port against the JAX package, on the
CPU.

- The FSDP rule: for every leaf of the smoke llama3.2-1b, qwen1.5-4b,
  deepseek-v2-lite-16b, mamba2-1.3b, AlexNet, minitron-8b,
  mistral-large-123b, llama4-scout-17b-a16e (3-D expert leaves, a shared
  expert), chameleon-34b (qk norms) and hymba-1.5b (meta tokens, SSM
  leaves) trees (the port's leaves, one dict a layer),
  ``dist.sharding.fsdp_dim`` picks the dim where
  ``repro.core.gspmd.fsdp_param_spec`` puts ``data`` on a stand-in mesh
  of k = 2, 4, 8 ranks (``sanitize_spec`` reads only its axis names and
  sizes).
- Shards: ``shard_leaf`` / ``unshard_trees`` round trips at k that does
  not divide a dim (the padding).
- One spawn of k=2 gloo ranks (``test_torch_ranks.gspmd_worker``) on the
  fp32 smoke llama3.2-1b with remat (so each layer's gather runs inside
  ``torch.utils.checkpoint`` and again in its recompute), parameters
  from the JAX init through the bridge, each rank on its half of every
  global batch:
  - gspmd ``zero1`` and ``ar``, momentum SGD and AdamW, 3 steps each,
    against JAX's gspmd engine on one ``Auto`` device on the whole
    batches: losses rtol 1e-5; SGD's parameters rtol 1e-4 / atol 1e-6
    (the reference's own bounds for its gspmd against BSP,
    ``tests/test_engine.py``), AdamW's at ``ADAMW_ATOL``; ``zero1`` and
    ``ar`` agree bit for bit;
  - gspmd ``zero1`` against the port's BSP ``asa`` with the sharded
    update, with either optimizer, at rtol 1e-4 / atol 1e-6;
  - at rest a rank holds only its shard of every parameter and of
    ``m``/``v``, shaped as the rule says;
  - a zero1 AdamW run saved at step 2 and resumed to 4 equals the
    unbroken run bit for bit.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import gspmd as jgspmd  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.core import gspmd as tgspmd  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_ranks import (GSPMD_CASES, GSPMD_LR, GSPMD_RESUME,  # noqa: E402
                              GSPMD_STEPS, gspmd_worker)

VOCAB, SEQ, K = 256, 32, 2
# AdamW divides each gradient element by its own root mean square plus eps
# (1e-8), so an element whose gradient sits at the floor of torch's and
# XLA's fp32 noise moves by up to lr x noise / eps a step. Without any
# sharding the port's BSP step on one rank lies 0.8e-3 to 1.6e-3 from
# JAX's after these 3 steps at lr 0.01 (einsum or flash attention on both
# sides; SGD's lies 7e-8 from it). So AdamW's parameters are held to
# JAX's at a tenth of lr a step, and to the port's BSP (whose gradients
# SGD holds to JAX's) at the reference's bounds.
ADAMW_ATOL = 0.1 * GSPMD_LR["adamw"] * GSPMD_STEPS
RULE_ARCHS = ("llama3.2-1b", "qwen1.5-4b", "deepseek-v2-lite-16b",
              "mamba2-1.3b", "alexnet", "minitron-8b", "mistral-large-123b",
              "llama4-scout-17b-a16e", "chameleon-34b", "hymba-1.5b")


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _cfgs():
    """(JAX, port) smoke llama configs: fp32, remat, 4 heads over 2 KV
    heads, vocab 256."""
    out = []
    for get in (jget_smoke, tget_smoke):
        c = get("llama3.2-1b")
        out.append(c.with_overrides(
            dtype="float32", vocab_size=VOCAB, remat=True,
            attention=dataclasses.replace(c.attention, num_kv_heads=2)))
    return out


@functools.cache
def _jax_params():
    jc, _ = _cfgs()
    return jbuild(jc).init(jax.random.key(0))


def _port_params():
    return decoder_params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                                   "cpu")


def _batches():
    src = tsyn.LMTokenSource(VOCAB, SEQ)
    return [src.batch(4, i) for i in range(GSPMD_RESUME[1])]


# ---------------------------------------------------------------------------
# the FSDP rule
# ---------------------------------------------------------------------------

def _jax_path(names):
    return tuple(jax.tree_util.SequenceKey(int(n)) if n.isdigit()
                 else jax.tree_util.DictKey(n) for n in names)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("arch", RULE_ARCHS)
def test_fsdp_dim_is_the_reference_rule(arch, k):
    model = tbuild(tget_smoke(arch), "meta")
    mesh = types.SimpleNamespace(axis_names=("data",), shape={"data": k})
    n = sharded = 0
    for names, leaf in tgspmd._named_leaves(tgspmd.abstract_params(model)):
        shape = tuple(leaf.shape)
        spec = tuple(jgspmd.fsdp_param_spec(
            _jax_path(names), jax.ShapeDtypeStruct(shape, jnp.float32), mesh))
        want = spec.index("data") if "data" in spec else None
        assert tsharding.fsdp_dim(names, shape, k) == want, (names, shape)
        n += 1
        sharded += want is not None
    assert n > 10 and sharded > n // 2


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_shards_round_trip_with_padding(k):
    g = torch.Generator().manual_seed(k)
    tree = {"a": torch.randn(7, 5, generator=g),
            "b": [torch.randn(11, generator=g), torch.randn(2, 3, 2,
                                                            generator=g)],
            "c": torch.randn((), generator=g)}
    specs = tgspmd.fsdp_shardings(tree, k)
    shards = [tgspmd.shard_tree(tree, specs, r) for r in range(k)]
    for s, x in zip(leaves(specs), leaves(shards[0])):
        assert tuple(x.shape) == s.shard_shape
    back = tgspmd.unshard_trees(shards, specs)
    for a, b in zip(leaves(back), leaves(tree)):
        assert torch.equal(a, b)
    # each element lives on exactly one rank (whole leaves on every rank)
    for i, s in enumerate(leaves(specs)):
        held = sum(leaves(t)[i].numel() for t in shards)
        want = (k * int(np.prod(s.shape)) if s.dim is None
                else k * int(np.prod(s.shard_shape)))
        assert held == want


# ---------------------------------------------------------------------------
# two gloo ranks against JAX's gspmd engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gspmd_runs(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("gspmd")
    _, tc = _cfgs()
    torch.save(_port_params(), out / "init.pt")
    torch.save([{n: torch.from_numpy(v) for n, v in b.items()}
                for b in _batches()], out / "batches.pt")
    run_ranks(gspmd_worker, K, (str(out), tc))
    return [torch.load(out / f"gspmd{r}.pt", weights_only=False)
            for r in range(K)]


def _full(ranks, case):
    return tgspmd.unshard_trees([r[case]["params"] for r in ranks],
                                ranks[0][case]["specs"])


def _jax_gspmd(mode, oname):
    jc, _ = _cfgs()
    params = _jax_params()      # concrete, before eval_shape traces init
    jm = dataclasses.replace(jbuild(jc), init=lambda key: params)
    opt = (jopt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
           if oname == "sgd" else jopt.adamw())
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        eng = jengine.build_engine(jengine.TrainPlan(algo="gspmd", mode=mode),
                                   jm, opt, jsched.constant(GSPMD_LR[oname]),
                                   mesh)
        state = eng.init_state(jax.random.key(0))
        losses = []
        for i, b in enumerate(_batches()[:GSPMD_STEPS]):
            state, metrics = eng.step(state, b, jax.random.key(i), i)
            losses.append(float(metrics["loss"]))
    return losses, leaves(decoder_params_from_jax(
        jax.tree.map(np.asarray, state["params"])))


@pytest.mark.parametrize("case", [c[0] for c in GSPMD_CASES])
def test_two_gloo_ranks_equal_jax_gspmd(gspmd_runs, case):
    _, mode, oname = next(c for c in GSPMD_CASES if c[0] == case)
    losses, want = _jax_gspmd(mode, oname)
    moved = max((a - b).abs().max().item()
                for a, b in zip(want, leaves(_port_params())))
    assert moved > 1e-3                       # the steps did move them
    for r in gspmd_runs:
        np.testing.assert_allclose(r[case]["losses"], losses, rtol=1e-5)
        assert r[case]["step"] == GSPMD_STEPS
    got = leaves(_full(gspmd_runs, case))
    assert len(got) == len(want)
    tol = (dict(rtol=1e-4, atol=1e-6) if oname == "sgd"
           else dict(rtol=0, atol=ADAMW_ATOL))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_zero1_and_ar_agree_bitwise(gspmd_runs, opt):
    """At k = 2 the all-to-all's sum of two rows and the all-reduce's are
    one fp32 addition: the modes differ only in their wire."""
    for r in gspmd_runs:
        assert r[f"zero1-{opt}"]["losses"] == r[f"ar-{opt}"]["losses"]
        z, a_ = r[f"zero1-{opt}"], r[f"ar-{opt}"]
        for a, b in zip(leaves([z["params"], z["opt"]]),
                        leaves([a_["params"], a_["opt"]])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_zero1_equals_bsp_sharded_update(gspmd_runs, opt):
    """The declarative ZeRO-1 and the explicit RS -> update -> AG compute
    the same trajectory (the reference's
    ``test_gspmd_zero1_parity_with_bsp_sharded_update``)."""
    got = leaves(_full(gspmd_runs, f"zero1-{opt}"))
    for r in gspmd_runs:
        bsp = r[f"bsp-{opt}"]
        np.testing.assert_allclose(r[f"zero1-{opt}"]["losses"],
                                   bsp["losses"], rtol=1e-5)
        for a, b in zip(got, leaves(bsp["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)


def test_a_rank_holds_its_shard_at_rest(gspmd_runs):
    """Parameters, m and v: every leaf at the shard shape that
    ``fsdp_state_shardings`` gives the full state, about 1/k of the model
    a rank; AdamW's t whole."""
    n_full = sum(p.numel() for p in leaves(_port_params()))
    _, tc = _cfgs()
    full = tgspmd.abstract_params(tbuild(tc, "meta"))
    for r in gspmd_runs:
        for case, _, oname in GSPMD_CASES:
            opt = (topt.sgd_momentum() if oname == "sgd" else topt.adamw())
            specs = tgspmd.fsdp_state_shardings(
                {"params": full, "opt": opt.init(full)}, K)
            rest = r[case]["rest"]
            assert sorted(rest) == sorted(["params"] + [
                n for n in ("m", "v") if n in specs["opt"]])
            for part, shapes in rest.items():
                tree = specs["params"] if part == "params" else \
                    specs["opt"][part]
                assert shapes == [s.shard_shape for s in leaves(tree)]
            if oname == "adamw":
                assert specs["opt"]["t"].dim is None
                assert r[case]["opt"]["t"].shape == ()
            want = leaves(specs["params"])
            assert [s.shard_shape for s in want] == [
                s.shard_shape for s in leaves(r[case]["specs"])]
            held = sum(int(np.prod(s.shard_shape)) for s in want)
            assert n_full / K <= held <= n_full / K * 1.01
            assert sum(s.dim is not None for s in want) > len(want) // 2


def test_resume_is_bitwise(gspmd_runs):
    for r in gspmd_runs:
        res = r["resume"]
        assert res["steps"] == [GSPMD_RESUME[1], GSPMD_RESUME[0],
                                GSPMD_RESUME[1]]
        assert res["bitwise"]
        full, resumed = res["losses"]
        assert full[GSPMD_RESUME[0]:] == resumed
