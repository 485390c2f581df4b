"""The exchange, port against the JAX package and against the numpy mean.

- The ``chunk_sum`` and fp16 cast kernels' plain versions against the
  Pallas kernels in interpret mode (sum: fp32 rtol 1e-6; casts: exact,
  bit for bit, at +-65504, past it and at subnormals). The blockwise
  int8 quantizers likewise, bit for bit, at n in {1, 2048, 5000, 65543}
  with an all-zero block and exact .5 ties (which round half to even).
- ``make_rs_plan`` field by field against the JAX package's, and
  ``wire_summary``; a ``pack``/``unpack`` round trip.
- One spawn of k=4 gloo ranks runs every ported strategy on a tree of big
  and small, ragged leaves: ``exchange``, the two halves and ``raw=True``,
  each held to the numpy mean of the four ranks' trees within its wire's
  bound: fp32 1e-6 of the largest magnitude; an fp16 / bf16 wire rounds
  each rank's value and then the mean once each, 2 * 2^-11 / 2 * 2^-8 of
  it; int8 half a quantization step of the row's absmax on each leg,
  absmax / 127 in all; ``ring`` 1e-6 and ``ring16`` 5e-3, the
  reference's own bounds (``tests/test_exchangers.py``). ``ring16``
  keeps each rank's own shard in fp32 through the all-gather, so there
  the ranks' trees agree to one fp16 rounding (rtol 2^-11), not exactly.
  ``ring``/``ring16`` are also held bit for bit to a numpy model of the
  reference's hop order, rounding to fp16 at every hop, and to the JAX
  package's own ring on a 4-device host mesh (a subprocess).
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
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_ranks import (BUCKET_BYTES, STRATEGIES,  # noqa: E402
                              exchange_worker, int8_input, map_shapes,
                              value_tree)

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
    # the dry run's meta paths: meta outputs of the kernel's shapes and
    # dtypes, no launch; a wrapper with no meta path raises on meta
    assert tcs.chunk_sum(torch.zeros(2, 4).to("meta")).shape == (4,)
    assert tq.quant_fp16(torch.zeros(4).to("meta")).dtype == torch.float16
    with pytest.raises(ValueError, match="meta"):
        tq.quant_int8(torch.zeros(4).to("meta"))
    with pytest.raises(ValueError, match="meta"):
        tq.dequant_int8(torch.zeros(4, dtype=torch.int8).to("meta"),
                        torch.zeros(1).to("meta"))


@pytest.mark.parametrize("n", [1, 2048, 5000, 65536 + 7])
def test_int8_matches_pallas_bit_for_bit(n):
    tx, pos = int8_input(n)
    x = tx.numpy()
    want_q, want_s = (np.asarray(a) for a in jq.quant_int8(
        jnp.asarray(x), interpret=True))
    q, sc = tq.quant_int8(tx)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert sc.shape == (-(-n // 2048),)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    rq, rs = tref.quant_int8_ref(tx)
    assert torch.equal(rq, q) and torch.equal(rs.view(torch.int32),
                                              sc.view(torch.int32))
    if n >= 2 * 2048:                    # the all-zero block
        assert sc[1].item() == np.float32(1e-12) and not q[2048:4096].any()
    if n >= 256:                         # ties round half to even
        assert pos.numel() >= 40
        got = q[pos].int()
        assert torch.equal((tx[pos] / sc[0] - got).abs(),
                           torch.full((pos.numel(),), 0.5))
        assert not (got % 2).any()
    back = np.asarray(jq.dequant_int8(jnp.asarray(want_q),
                                      jnp.asarray(want_s), interpret=True))
    got_b = tq.dequant_int8(q, sc)
    np.testing.assert_array_equal(got_b.numpy().view(np.uint32),
                                  back.view(np.uint32))
    assert torch.equal(tref.dequant_int8_ref(q, sc), got_b)
    # a round trip lands within half a step of each block's scale (plus
    # the fp32 rounding of q * scale and of the tie values themselves)
    err = np.abs(got_b.numpy() - x)
    step = np.repeat(sc.numpy(), 2048)[:n]
    assert (err <= 0.5 * step + 2.0 ** -22 * np.abs(x)).all()


@pytest.mark.parametrize("absmax", [13 * 2.0 ** 18, 9 * 2.0 ** 18])
def test_int8_scale_rounds_once_where_fp64_lands_on_an_fp32_tie(absmax):
    """absmax * fp32(1/127) is exactly an fp32 tie here, and 1e-12 is
    lost in the fp64 sum: the scale must still round as one fma does."""
    x = torch.zeros(3000)
    x[5], x[9], x[2500] = absmax, -absmax / 3, 1.0
    want_q, want_s = (np.asarray(a) for a in jq.quant_int8(
        jnp.asarray(x.numpy()), interpret=True))
    for q, sc in (tq.quant_int8(x), tref.quant_int8_ref(x)):
        np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                      want_s.view(np.uint32))
        np.testing.assert_array_equal(q.numpy(), want_q)


def test_int8_checks_dtype_shape_and_block():
    with pytest.raises(TypeError, match="float32"):
        tq.quant_int8(torch.zeros(4, dtype=torch.float16))
    with pytest.raises(TypeError, match="1-D"):
        tq.quant_int8(torch.zeros(2, 4))
    with pytest.raises(TypeError, match="int8"):
        tq.dequant_int8(torch.zeros(4), torch.ones(1))
    with pytest.raises(ValueError, match="scales"):
        tq.dequant_int8(torch.zeros(4, dtype=torch.int8), torch.ones(2))
    q, sc = tq.quant_int8(torch.zeros(0))
    assert q.shape == (0,) and sc.shape == (0,)
    # the plain versions keep the reference's block_n: at 4, against the
    # Pallas kernels in interpret mode
    x = torch.arange(10, dtype=torch.float32) - 4.5
    q, sc = tref.quant_int8_ref(x, 4)
    want_q, want_s = (np.asarray(a) for a in jq.quant_int8(
        jnp.asarray(x.numpy()), block_n=4, interpret=True))
    assert sc.shape == (3,)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    back = np.asarray(jq.dequant_int8(jnp.asarray(want_q),
                                      jnp.asarray(want_s), block_n=4,
                                      interpret=True))
    np.testing.assert_array_equal(
        tref.dequant_int8_ref(q, sc, 4).numpy().view(np.uint32),
        back.view(np.uint32))
    with pytest.raises(ValueError, match="meta"):
        tq.quant_int8(torch.zeros(4, device="meta"))


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
    assert tex.NOT_PORTED == ()
    for name in jex.EXCHANGERS:      # every strategy runs: kind and wire
        got, want = tex.get_exchanger(name), jex.get_exchanger(name)
        assert got.kind == want.kind
        assert tex._dtype_name(got.transfer_dtype) == str(
            jnp.dtype(want.transfer_dtype or jnp.float32))
    tex.get_exchanger("hier16").exchange(value_tree(0))  # one rank: runs
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


def test_staging_holds_one_pinned_arena_a_role(monkeypatch):
    """The gloo staging buffers of a CUDA tensor's collective: each role's
    shapes are views of one arena that grows to the largest request, so
    the host holds the largest collective a role. Before, one pinned
    buffer a (role, shape, dtype), each rounded up to a power of two and
    kept: minitron-8b's gspmd step (two fp32 gather packs of 524 M values
    and their (2, n) reduce-scatters) held tens of GB a rank, and two
    ranks passed the host's 96 GiB."""
    made = []

    def host_bytes(n):
        made.append(n)
        return torch.zeros(n, dtype=torch.uint8)
    monkeypatch.setattr(tex, "_pinned_bytes", host_bytes)
    tr = tex.Transport()
    a = tr._buf("in", (4, 5), torch.float32)
    b = tr._buf("in", (10,), torch.float16)      # fits: the same arena
    assert a.shape == (4, 5) and b.shape == (10,)
    assert b.dtype == torch.float16 and b.is_contiguous()
    assert b.data_ptr() == a.data_ptr()
    c = tr._buf("in", (3, 100), torch.float32)   # does not fit: grows
    c.fill_(1.5)
    assert tr._buf("in", (2, 100), torch.float32).sum() == 300
    tr._buf("out", (7,), torch.int32)
    tr._buf(("a2a_in", 0), (2, 3), torch.float16)
    tr._buf(("a2a_in", 1), (2, 3), torch.float16)
    assert made == [80, 1200, 28, 12, 12]
    assert sum(t.numel() for t in tr._pinned.values()) == 1200 + 28 + 24


# ---------------------------------------------------------------------------
# k = 4 gloo ranks
# ---------------------------------------------------------------------------

def _bound(name, scale):
    return {"ar": 1e-6, "asa": 1e-6, "asa16": 2 * 2.0 ** -11,
            "asabf16": 2 * 2.0 ** -8, "asa8": 1.0 / 127, "ring": 1e-6,
            "ring16": 5e-3}[name] * scale


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
        # every rank ends with the same tree; ring16's all-gather keeps
        # each rank's own shard in fp32 and rounds the others' to fp16 (as
        # the reference does), so there the ranks differ by that rounding
        for res in four_ranks[1:]:
            for a, b in zip(res[(name, bb, "exchange")],
                            four_ranks[0][(name, bb, "exchange")]):
                if name == "ring16":
                    np.testing.assert_allclose(a, b, rtol=2.0 ** -11,
                                               atol=2.0 ** -25)
                elif name != "none":
                    np.testing.assert_array_equal(a, b)


def _ring_model(name, bb):
    """numpy model of the reference's ring hops (``repro/core/
    exchanger.py:_rs_ring`` / ``_ag_ring``) over the four ranks' trees,
    rounding to fp16 at every hop for ``ring16``: per rank, the shard of
    every bucket and the gathered flat buckets."""
    k = K_RANKS
    plan = tex.make_rs_plan(value_tree(0), k, bb)
    flats = [[f.numpy() for f in tex.Exchanger.pack(value_tree(100 + r),
                                                    plan)[0]]
             for r in range(k)]
    wire = ((lambda a: a.astype(np.float16).astype(np.float32))
            if name == "ring16" else (lambda a: a))
    shards = [[] for _ in range(k)]
    gathered = [[] for _ in range(k)]
    for bi in range(plan.num_buckets):
        x = [flats[r][bi].reshape(k, -1) for r in range(k)]
        acc = [x[i][(i - 1) % k] for i in range(k)]
        for s in range(k - 1):
            sent = [wire(a) for a in acc]
            acc = [sent[(i - 1) % k] + x[i][(i - s - 2) % k]
                   for i in range(k)]
        sh = [a * np.float32(1.0 / k) for a in acc]
        bufs = [np.zeros_like(x[0]) for _ in range(k)]
        for i in range(k):
            bufs[i][i] = sh[i]
            shards[i].append(sh[i])
        cur = sh
        for s in range(1, k):
            cur = [wire(cur[(i - 1) % k]) for i in range(k)]
            for i in range(k):
                bufs[i][(i - s) % k] = cur[i]
        for i in range(k):
            gathered[i].append(bufs[i].reshape(-1))
    return plan, shards, gathered


@pytest.mark.parametrize("name", ["ring", "ring16"])
def test_ring_follows_the_reference_hop_order_bit_for_bit(four_ranks, name):
    for bb in BUCKET_BYTES:
        plan, shards, gathered = _ring_model(name, bb)
        for r, res in enumerate(four_ranks):
            for got, want in zip(res[(name, bb, "shards")], shards[r]):
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
            for part in ("exchange", "halves"):
                for b, flat in zip(plan.buckets, gathered[r]):
                    off = 0
                    for i, n in zip(b.leaves, b.sizes):
                        got = res[(name, bb, part)][i].reshape(-1)
                        np.testing.assert_array_equal(
                            got.view(np.uint32),
                            flat[off:off + n].view(np.uint32))
                        off += n


_JAX_RING = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.exchanger import get_exchanger
from test_torch_ranks import BUCKET_BYTES, value_tree

trees = [jax.tree.map(lambda t: t.numpy(), value_tree(100 + r))
         for r in range(4)]
stacked = jax.tree.map(lambda *ls: np.stack(ls), *trees)
mesh = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
jax.set_mesh(mesh)
out = {}
for name in ("ring", "ring16"):
    ex = get_exchanger(name)
    for bb in BUCKET_BYTES:
        def f(t):
            per = jax.tree.map(lambda v: v[0], t)
            res, plan = ex.reduce_scatter(per, "data", bucket_bytes=bb)
            flats = ex.all_gather(res["shards"], plan, "data")
            return ([s[None] for s in res["shards"]], [v[None] for v in
                    jax.tree.leaves(ex.unpack(flats, res["full"], plan))])
        shards, leaves = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
            axis_names=frozenset({"data"}), check_vma=False))(stacked)
        for r in range(4):
            for i, v in enumerate(shards):
                out[f"{name}:{bb}:shard:{r}:{i}"] = np.asarray(v)[r]
            for i, v in enumerate(leaves):
                out[f"{name}:{bb}:leaf:{r}:{i}"] = np.asarray(v)[r]
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_ring(tmp_path_factory):
    """JAX's ring and ring16 halves on a 4-device host mesh (a subprocess:
    this process keeps one device), over the four ranks' trees."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("jax_ring") / "ring.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here)]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_RING, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name", ["ring", "ring16"])
def test_ring_equals_jax_ring_bit_for_bit(four_ranks, jax_ring, name):
    """Each rank's shard of every bucket, and every bucketed leaf after the
    all-gather (through ``exchange`` and through the halves), equal what
    JAX's ring gives that rank, bit for bit. The small leaves go through
    an all-reduce whose order of summation is the backend's own."""
    for bb in BUCKET_BYTES:
        plan = tex.make_rs_plan(value_tree(0), K_RANKS, bb)
        bucketed = [i for b in plan.buckets for i in b.leaves]
        for r, res in enumerate(four_ranks):
            for bi, got in enumerate(res[(name, bb, "shards")]):
                want = jax_ring[f"{name}:{bb}:shard:{r}:{bi}"]
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
            for part in ("exchange", "halves"):
                for i in bucketed:
                    want = jax_ring[f"{name}:{bb}:leaf:{r}:{i}"]
                    np.testing.assert_array_equal(
                        res[(name, bb, part)][i].view(np.uint32),
                        want.view(np.uint32))


def _unflat(leaves, plan):
    """numpy leaves in flatten order -> the torch tree of ``plan``."""
    from repro_torch.tree import unflatten
    return unflatten(plan.treedef, [torch.from_numpy(np.asarray(
        l, np.float32)) for l in leaves])
