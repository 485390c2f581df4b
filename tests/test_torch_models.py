"""Model parity, port against the JAX package at fp32 on the CPU: the
shared layers, the GQA prefill/decode paths (contiguous and paged, each
through the flash kernels and through the einsum oracles), and the whole
llama3.2-1b smoke decoder with bridged parameters.

Tolerances: 1e-5 for single layers (fp32, sums in another order); 1e-4
for logits through two decoder layers (the differences compound).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.mlp import mlp_forward as j_mlp  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import AttentionConfig as TAttn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.mlp import mlp_forward as t_mlp  # noqa: E402

LAYER = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types. A
    test file run earlier in the same process may leave a global
    ``jax.set_mesh`` with explicit axes behind, under which the Pallas
    interpreter's updates fail to type-check."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# shared layers
# ---------------------------------------------------------------------------

def test_rms_norm_one_plus_scale():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 64), _rand(rng, 64, scale=0.1)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = tcommon.rms_norm(_t(x), _t(scale))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    # zero scales are the identity scaling (1 + 0), not a zeroed output
    ones = tcommon.rms_norm(_t(x), torch.zeros(64))
    assert ones.abs().mean() > 0.5


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_halves(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 4, 32)
    positions = np.array([[0, 1, 2, 3, 500, 1000, 4095]] * 2, np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = tcommon.apply_rope(_t(x), _t(positions), theta)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


def test_mlp_forward_swiglu():
    rng = np.random.default_rng(2)
    p = {"wi": _rand(rng, 32, 48, scale=0.2), "wu": _rand(rng, 32, 48, scale=0.2),
         "wd": _rand(rng, 48, 32, scale=0.2)}
    x = _rand(rng, 2, 3, 32)
    want = j_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = t_mlp({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


# ---------------------------------------------------------------------------
# GQA prefill / decode against a cache, contiguous and paged
# ---------------------------------------------------------------------------

D_MODEL, H, KV, HD, PS = 64, 8, 2, 32, 8     # G = 4


def _attn_setup(seed):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(D_MODEL)
    p = {"wq": _rand(rng, D_MODEL, H, HD, scale=s),
         "wk": _rand(rng, D_MODEL, KV, HD, scale=s),
         "wv": _rand(rng, D_MODEL, KV, HD, scale=s),
         "wo": _rand(rng, H * HD, D_MODEL, scale=1 / np.sqrt(H * HD))}
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=HD, rope_theta=500_000.0)
    return rng, p, JAttn(**kw), TAttn(**kw)


def _caches(rng, layout, B, S):
    """(jax cache, torch cache, jax tables, torch tables) holding random
    earlier rows; paged pools map each slot's lane through a table."""
    if layout == "contiguous":
        k, v = _rand(rng, B, S, KV, HD), _rand(rng, B, S, KV, HD)
        return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                {"k": _t(k), "v": _t(v)}, None, None)
    NP = S // PS
    P = B * NP + 1
    k, v = _rand(rng, P, PS, KV, HD), _rand(rng, P, PS, KV, HD)
    tables = (1 + rng.permutation(B * NP)).reshape(B, NP).astype(np.int32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": _t(k), "v": _t(v)}, jnp.asarray(tables), _t(tables))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_gqa_prefill(impl, layout):
    rng, p, ja, ta = _attn_setup(3)
    B, S, C, pos0, window = 1, 32, 8, 8, 0
    jc, tc, jt, tt = _caches(rng, layout, B, S)
    x = _rand(rng, B, C, D_MODEL)
    positions = (pos0 + np.arange(C, dtype=np.int32))[None]
    jy, jnew = jattn.gqa_prefill({k: jnp.asarray(v) for k, v in p.items()},
                                 jc, jnp.asarray(x), jnp.asarray(positions),
                                 pos0, ja, window, impl=impl, tables=jt,
                                 page_size=PS)
    ty, tnew = tattn.gqa_prefill({k: _t(v) for k, v in p.items()}, tc, _t(x),
                                 _t(positions).long(), pos0, ta, window,
                                 impl=impl, tables=tt, page_size=PS)
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tnew[n]), _np(jnew[n]), **LAYER)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_gqa_decode(impl, layout):
    rng, p, ja, ta = _attn_setup(4)
    B, S, window = 3, 32, 5 if layout == "paged" else 0
    jc, tc, jt, tt = _caches(rng, layout, B, S)
    x = _rand(rng, B, 1, D_MODEL)
    pos = np.array([0, 13, 31], np.int32)
    jy, jnew = jattn.gqa_decode({k: jnp.asarray(v) for k, v in p.items()},
                                jc, jnp.asarray(x), jnp.asarray(pos), ja,
                                window, impl=impl, tables=jt, page_size=PS)
    ty, tnew = tattn.gqa_decode({k: _t(v) for k, v in p.items()}, tc, _t(x),
                                _t(pos).long(), ta, window, impl=impl,
                                tables=tt, page_size=PS)
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tnew[n]), _np(jnew[n]), **LAYER)


def _paths(tree, prefix=""):
    """{dotted path: (shape, dtype name)} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {n: v for k in tree for n, v in
                _paths(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {n: v for i, t in enumerate(tree) for n, v in
                _paths(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_mla_moe_tree_and_count_match_jax():
    """DeepSeek-V2-Lite (MLA + MoE): the port's init builds the tree the
    bridge makes of the JAX package's (every leaf path, shape and dtype;
    the router in fp32), at the smoke config; at full width both count
    the same parameters (16,156,309,504; 1,102,587,904 at 2 layers)."""
    from repro.configs import get_config as j_get
    from repro_torch.configs import get_config as t_get
    from repro_torch.models import count_params, transformer
    jcfg = j_smoke("deepseek-v2-lite-16b").with_overrides(dtype="float32")
    tcfg = t_smoke("deepseek-v2-lite-16b").with_overrides(dtype="float32")
    jshapes = jax.eval_shape(j_build(jcfg).init, jax.random.key(0))
    bridged = decoder_params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jshapes), "cpu")
    mine = t_build(tcfg, "cpu").init(0)
    assert _paths(mine) == _paths(bridged)
    assert mine["layers"][1]["moe"]["router"].dtype == torch.float32
    assert "mlp" in mine["layers"][0] and "moe" in mine["layers"][1]
    assert set(mine["layers"][0]["attn"]) == {"wq", "wdkv", "wkr", "wuk",
                                              "wuv", "wo"}
    for layers, want in ((None, 16_156_309_504), (2, 1_102_587_904)):
        jc, tc = j_get("deepseek-v2-lite-16b"), t_get("deepseek-v2-lite-16b")
        if layers:
            jc, tc = (c.with_overrides(num_layers=layers) for c in (jc, tc))
        shapes = jax.eval_shape(j_build(jc).init, jax.random.key(0))
        n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        n_port = count_params(transformer.init_decoder(None, tc, "meta"))
        assert n_jax == n_port == want


# ---------------------------------------------------------------------------
# the whole smoke decoder through the bridge
# ---------------------------------------------------------------------------

def _bridged(arch="llama3.2-1b"):
    cfg_j = j_smoke(arch).with_overrides(dtype="float32", remat=False)
    cfg_t = t_smoke(arch).with_overrides(dtype="float32", remat=False)
    jm, tm = j_build(cfg_j), t_build(cfg_t, "cpu")
    jp = jm.init(jax.random.key(0))
    tp = decoder_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg_j, jm, jp, tm, tp


def test_bridge_forward_logits():
    cfg, jm, jp, tm, tp = _bridged()
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = tm.forward(tp, {"tokens": _t(tokens).long()})
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_bridge_prefill_then_decode_logits(layout):
    """decoder_prefill over two chunks (the second ragged), then three
    decode steps fed the JAX side's greedy tokens: logits agree."""
    cfg, jm, jp, tm, tp = _bridged()
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 20)
    C, S = 16, 64
    if layout == "paged":
        jc, tc = jm.init_paged_cache(1, PS, S // PS + 1), \
            tm.init_paged_cache(1, PS, S // PS + 1)
        tables = np.arange(1, S // PS + 1, dtype=np.int32)[None]
        jkw = dict(block_tables=jnp.asarray(tables), page_size=PS)
        tkw = dict(block_tables=_t(tables), page_size=PS)
    else:
        jc, tc = jm.init_cache(1, S), tm.init_cache(1, S)
        jkw, tkw = dict(block_tables=None, page_size=0), {}
    # one trace each for the whole loop (positions and lengths are traced)
    prefill = jax.jit(lambda p, c, t, pos0, valid, bt: jm.chunk_prefill(
        p, c, t, pos0, valid, seq_len=S, block_tables=bt,
        page_size=jkw["page_size"]))
    decode = jax.jit(lambda p, c, t, pos, bt: jm.decode_step(
        p, c, {"tokens": t}, pos, S, block_tables=bt,
        page_size=jkw["page_size"]))
    for c in range(0, len(prompt), C):
        chunk = prompt[c:c + C]
        valid = len(chunk)
        chunk = np.pad(chunk, (0, C - valid))[None]
        jl, jc = prefill(jp, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(c),
                         jnp.int32(valid), jkw["block_tables"])
        tl, tc = tm.chunk_prefill(tp, tc, _t(chunk).long(), c, valid,
                                  seq_len=S, **tkw)
        np.testing.assert_allclose(_np(tl)[:, :valid], _np(jl)[:, :valid],
                                   **LOGITS)
    tok = int(np.argmax(_np(jl)[0, valid - 1]))
    for i in range(3):
        pos = len(prompt) + i
        jl, jc = decode(jp, jc, jnp.asarray([[tok]], jnp.int32),
                        jnp.asarray([pos], jnp.int32), jkw["block_tables"])
        tl, tc = tm.decode_step(tp, tc, {"tokens": torch.tensor([[tok]])},
                                torch.tensor([pos]), S, **tkw)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
        tok = int(np.argmax(_np(jl)[0, 0]))
