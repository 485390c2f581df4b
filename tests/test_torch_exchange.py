"""The exchange, port against the JAX package and against the numpy mean.

- The ``chunk_sum`` and fp16 cast kernels' plain versions against the
  Pallas kernels in interpret mode (sum: fp32 rtol 1e-6; casts: exact,
  bit for bit, at +-65504, past it and at subnormals).
- ``make_rs_plan`` field by field against the JAX package's, and
  ``wire_summary``; a ``pack``/``unpack`` round trip.
- One spawn of k=4 gloo ranks runs every ported strategy on a tree of big
  and small, ragged leaves: ``exchange``, the two halves and ``raw=True``,
  each held to the numpy mean of the four ranks' trees within its wire's
  bound: fp32 1e-6 of the largest magnitude; an fp16 / bf16 wire rounds
  each rank's value and then the mean once each, 2 * 2^-11 / 2 * 2^-8 of
  it; int8 half a quantization step of the row's absmax on each leg,
  absmax / 127 in all.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import exchanger as jex  # noqa: E402
from repro.kernels import chunk_sum as jcs  # noqa: E402
from repro.kernels import quantize as jq  # noqa: E402
from repro_torch.core import exchanger as tex  # noqa: E402
from repro_torch.kernels import chunk_sum as tcs  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from test_torch_ranks import (BUCKET_BYTES, STRATEGIES,  # noqa: E402
                              exchange_worker, map_shapes, value_tree)

K_RANKS = 4


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


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("k,n", [(1, 300), (2, 4096), (8, 5003)])
def test_chunk_sum_matches_pallas(dtype, k, n):
    rng = np.random.default_rng(k + n)
    x = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)).astype(
        dtype)
    want = jcs.chunk_sum(x, interpret=True)
    tx = _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tcs.chunk_sum(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_chunk_sum_keeps_trailing_shape():
    x = torch.arange(24, dtype=torch.float16).reshape(2, 3, 4)
    assert torch.equal(tcs.chunk_sum(x), (x[0].float() + x[1].float()))


SPECIAL = [65504.0, -65504.0, 65519.0, 65520.0, 70000.0, -1e9, 6.1e-5,
           6e-8, 3e-8, 2.98e-8, -5.9e-8, 1e-10, 0.0, -0.0, 1.0 / 3,
           float("inf"), -float("inf")]


@pytest.mark.parametrize("n", [len(SPECIAL), 2048, 3001])
def test_fp16_casts_match_pallas_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 1000).astype(np.float32)
    x[:len(SPECIAL)] = np.array(SPECIAL, np.float32)
    want = np.asarray(jq.quant_fp16(jnp.asarray(x), interpret=True))
    got = tq.quant_fp16(_t(x)).numpy()
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    back = np.asarray(jq.dequant_fp16(jnp.asarray(want), interpret=True))
    got_b = tq.dequant_fp16(_t(want)).numpy()
    np.testing.assert_array_equal(got_b.view(np.uint32),
                                  back.view(np.uint32))


def test_casts_check_dtype_and_devices():
    with pytest.raises(TypeError, match="float32"):
        tq.quant_fp16(torch.zeros(4, dtype=torch.float16))
    with pytest.raises(TypeError, match="float16"):
        tq.dequant_fp16(torch.zeros(4))
    assert tq.quant_fp16(torch.zeros(0)).shape == (0,)
    for fn, x in ((tcs.chunk_sum, torch.zeros(2, 4)), (tq.quant_fp16,
                                                      torch.zeros(4))):
        with pytest.raises(ValueError, match="meta"):
            fn(x.to("meta"))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _plan_tree(kind):
    """Leaves of every plan class: big 2-D/4-D/1-D (some ragged), small."""
    shapes = {"w1": (33, 77), "w2": (77, 40), "b1": (1237,), "small": (5,),
              "norm": (17,), "conv": {"w": (3, 3, 2, 100), "b": (100,)},
              "blocks": [(1500,), (260, 300), (7,)], "a": (128, 1024)}
    if kind == "jax":
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                            shapes, is_leaf=lambda s: isinstance(s, tuple))
    return map_shapes(shapes, lambda s: torch.empty(s, device="meta"))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket_bytes", [0, 1 << 20])
def test_make_rs_plan_equals_jax(k, bucket_bytes):
    jp = jex.make_rs_plan(_plan_tree("jax"), k, bucket_bytes)
    tp = tex.make_rs_plan(_plan_tree("torch"), k, bucket_bytes)
    assert tp.k == jp.k
    assert tp.small == jp.small
    assert tp.shapes == jp.shapes
    assert [str(d).replace("torch.", "") for d in tp.dtypes] == \
        [str(d) for d in jp.dtypes]
    assert [(b.leaves, b.sizes, b.shard_len, b.padded) for b in tp.buckets] \
        == [(b.leaves, b.sizes, b.shard_len, b.padded) for b in jp.buckets]
    if bucket_bytes:
        assert any(len(b.leaves) > 1 for b in tp.buckets)


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("param_ag", [False, True])
def test_wire_summary_equals_jax(name, param_ag):
    jp = jex.make_rs_plan(_plan_tree("jax"), 4, 1 << 20)
    tp = tex.make_rs_plan(_plan_tree("torch"), 4, 1 << 20)
    assert tex.wire_summary(tex.get_exchanger(name), tp, param_ag=param_ag) \
        == jex.wire_summary(jex.get_exchanger(name), jp, param_ag=param_ag)


def test_strategy_names_cover_the_reference():
    assert set(tex.EXCHANGERS) | set(tex.NOT_PORTED) == set(jex.EXCHANGERS)
    for name in tex.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tex.get_exchanger(name)
    assert tex.param_wire_dtype(tex.get_exchanger("asa8")) == torch.float16
    assert tex.param_wire_dtype(tex.get_exchanger("asa")) is None


@pytest.mark.parametrize("bucket_bytes", BUCKET_BYTES)
def test_pack_unpack_round_trip(bucket_bytes):
    tree = value_tree(0)
    tree["half"] = torch.ones(2000, dtype=torch.bfloat16)
    plan = tex.make_rs_plan(tree, 3, bucket_bytes)
    flats, smalls, _ = tex.Exchanger.pack(tree, plan)
    assert [f.shape[0] for f in flats] == [b.padded for b in plan.buckets]
    back = tex.Exchanger.unpack(flats, smalls, plan)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_one_rank_without_a_group_is_the_identity():
    tree = value_tree(1)
    for name in STRATEGIES:
        out = tex.get_exchanger(name).exchange(tree)
        if name in ("ar", "asa"):
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                a.numpy(), b.numpy()), out, tree)


# ---------------------------------------------------------------------------
# k = 4 gloo ranks
# ---------------------------------------------------------------------------

def _bound(name, scale):
    return {"ar": 1e-6, "asa": 1e-6, "asa16": 2 * 2.0 ** -11,
            "asabf16": 2 * 2.0 ** -8, "asa8": 1.0 / 127}[name] * scale


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("exchange")
    run_ranks(exchange_worker, K_RANKS, (str(out),))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(K_RANKS)]


@pytest.mark.parametrize("name", STRATEGIES)
def test_every_strategy_means_over_four_gloo_ranks(four_ranks, name):
    trees = [[t.numpy() for t in jax.tree.leaves(value_tree(100 + r))]
             for r in range(K_RANKS)]
    mean = [np.mean(np.stack(ls), 0) for ls in zip(*trees)]
    scale = max(float(np.abs(np.stack(ls)).max()) for ls in zip(*trees))
    for bb in BUCKET_BYTES:
        for r, res in enumerate(four_ranks):
            if name == "none":
                for got, own in zip(res[(name, bb, "exchange")], trees[r]):
                    np.testing.assert_array_equal(got, own)
                continue
            for part in ("exchange", "halves"):
                for got, want in zip(res[(name, bb, part)], mean):
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=_bound(name, scale))
            # rank r's shard is its 1/k slice of every mean bucket
            plan = tex.make_rs_plan(value_tree(0), K_RANKS, bb)
            flats = tex.Exchanger.pack(_unflat(mean, plan), plan)[0]
            for shard, f, b in zip(res[(name, bb, "shards")], flats,
                                   plan.buckets):
                want = f.numpy()[r * b.shard_len:(r + 1) * b.shard_len]
                np.testing.assert_allclose(shard, want, rtol=0,
                                           atol=_bound(name, scale))
            for raw, f, b in zip(res.get((name, bb, "raw"), []), flats,
                                 plan.buckets):
                want = f.numpy()[r * b.shard_len:(r + 1) * b.shard_len]
                np.testing.assert_allclose(raw, want, rtol=0,
                                           atol=_bound(name, scale))
        if (name, bb, "raw_dtype") in four_ranks[0]:
            assert four_ranks[0][(name, bb, "raw_dtype")] == {
                "asa": "torch.float32", "asa16": "torch.float16",
                "asabf16": "torch.bfloat16", "asa8": "torch.int8"}[name]
        # every rank ends with the same tree
        for res in four_ranks[1:]:
            for a, b in zip(res[(name, bb, "exchange")],
                            four_ranks[0][(name, bb, "exchange")]):
                if name != "none":
                    np.testing.assert_array_equal(a, b)


def _unflat(leaves, plan):
    """numpy leaves in flatten order -> the torch tree of ``plan``."""
    from repro_torch.tree import unflatten
    return unflatten(plan.treedef, [torch.from_numpy(np.asarray(
        l, np.float32)) for l in leaves])
