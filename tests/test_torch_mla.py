"""DeepSeek-V2-Lite's slice, port against the JAX package at fp32 on the
CPU, at the smoke config (d_model 256, 4 heads, latent 64 + rope 16, so
the absorbed layout's Dk 80 / Dv 64 over one KV head; 4 experts of 128,
top-2, one shared expert; the first layer dense, the second MoE):

- the flash forward (out, lse) and its backward (dq, dk, dv) in the MLA
  layout, the port's plain versions against the Pallas kernels in
  interpret mode (KV 1 and 2, windows 0 and 7, a ragged S), and the MLA
  route's padding to the built (Dk, Dv) pairs and its refusals;
- ``mla_forward`` (the absorbed flash path and the naive ``ref`` oracle),
  ``mla_decode`` and ``mla_prefill`` (contiguous and paged caches);
- the smoke decoder with bridged parameters: logits, ``decoder_loss``
  with the MoE aux and every leaf gradient (remat off and on), a prefill
  chunk then 2 decode steps, the engine's greedy tokens against the JAX
  engine, one spawn of 2 gloo ranks against JAX's one-device step, and
  the train launcher once.

Tolerances: 1e-5 (abs and rel) for single layers and kernels (fp32 sums
in another order); 1e-4 for logits and losses through two layers; leaf
gradients rtol 1e-3 / atol 1e-5 (the JAX package's bound for flash
against its einsum oracle); engine tokens exactly.
"""
import dataclasses
import functools
import math
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import with_attn_impl as j_impl  # noqa: E402
from repro.core import bsp as jbsp  # noqa: E402
from repro.core import exchanger as jex  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import with_attn_impl as t_impl  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.transformer import segments  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.tree import flatten, leaves, unflatten  # noqa: E402
from test_torch_ranks import LM_LR, lm_bsp_worker  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
LAYER = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
GRADS = dict(rtol=1e-3, atol=1e-5)
PS = 8          # page size of the paged caches


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
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _cfgs(**kw):
    """(JAX, port) smoke configs in fp32."""
    kw = dict(dict(dtype="float32", remat=False), **kw)
    return tuple(get(ARCH).with_overrides(**kw) for get in (j_smoke, t_smoke))


@functools.cache
def _np_params():
    """The JAX package's parameter tree (``blocks``: one stacked tree per
    segment of same-kind layers) holding the port's init from seed 0, as
    numpy arrays (the JAX init itself takes seconds on the CPU)."""
    _, tc = _cfgs()
    tp = t_build(tc, "cpu").init(0)
    out = {k: v.numpy() for k, v in tp.items() if k != "layers"}
    blocks, li = [], 0
    for _, count in segments(tc):
        seg = tp["layers"][li:li + count]
        li += count
        blocks.append(jax.tree.map(lambda *ls: np.stack([t.numpy()
                                                         for t in ls]),
                                   *seg))
    out["blocks"] = blocks
    return out


def _jax_params():
    return jax.tree.map(jnp.asarray, _np_params())


def _port_params():
    return decoder_params_from_jax(_np_params(), "cpu")


# ---------------------------------------------------------------------------
# the flash kernels in the MLA absorbed layout (Dk 80, Dv 64)
# ---------------------------------------------------------------------------

DK, DV = 80, 64


@pytest.mark.parametrize("KV,window,S", [(1, 0, 24), (1, 7, 21),
                                         (2, 0, 21), (2, 7, 24)])  # 21: ragged
def test_mla_layout_flash_matches_pallas(KV, window, S):
    """out, lse and the gradients of q, k and v (the port's autograd
    Function over its plain forward, dq and dk/dv) against the Pallas
    forward and custom-VJP backward in interpret mode."""
    rng = np.random.default_rng(S + 10 * window + KV)
    B, H = 2, 4
    q, k = _rand(rng, B, S, H, DK), _rand(rng, B, S, KV, DK)
    v, cot = _rand(rng, B, S, KV, DV), _rand(rng, B, S, H, DV)
    scale = 1 / math.sqrt(48)     # MLA's 1/sqrt(nope + rope), not Dk's

    def jf(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, window=window,
                                           sm_scale=scale, block_q=8,
                                           block_k=8, interpret=True) * cot)

    want, want_lse = jax.jit(functools.partial(
        jfa.flash_attention, window=window, sm_scale=scale, interpret=True,
        return_lse=True))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qkv = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = tfa.flash_attention(*qkv, window=window, sm_scale=scale,
                                   return_lse=True)
    assert out.shape == (B, S, H, DV)
    np.testing.assert_allclose(_np(out), np.asarray(want), **LAYER)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), **LAYER)
    tg = torch.autograd.grad((out * _t(cot)).sum(), qkv)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_mla_route_pads_to_a_built_pair_and_refuses_by_name():
    """Dk != Dv or D > 128 take the MLA route, padded to the smallest
    built pair; past (576, 512), or at G > 16, the wrappers refuse by
    name before any kernel; the decode refuses D > 128 naming ROADMAP
    queue 2 (the MLA decode is an einsum)."""
    assert not tfa.mla_route(64, 64) and not tfa.mla_route(128, 128)
    assert tfa.mla_route(80, 64) and tfa.mla_route(192, 192)
    assert tfa.mla_pair("x", 80, 64) == (96, 64)
    assert tfa.mla_pair("x", 576, 512) == (576, 512)
    assert tfa.mla_pair("x", 256, 256) == (576, 512)
    (a, b), (c,) = tfa._pad_to(96, torch.ones(2, 80), torch.ones(3, 96)), \
        tfa._pad_to(64, torch.ones(1, 64))
    assert a.shape == (2, 96) and not a[:, 80:].any() and b.shape == (3, 96)
    assert c.shape == (1, 64)
    z = lambda *s: torch.zeros(*s)
    for dk, dv in ((577, 512), (576, 513)):
        with pytest.raises(NotImplementedError,
                           match=f"Dk={dk}, Dv={dv} are more than"):
            tfa._check_cuda("flash_attention", z(1, 4, 2, dk),
                            z(1, 4, 1, dk), z(1, 4, 1, dv))
    with pytest.raises(NotImplementedError, match="G = 17 > 16, .*MLA"):
        tfa._check_cuda("flash_attention", z(1, 4, 17, DK), z(1, 4, 1, DK),
                        z(1, 4, 1, DV))
    tfa._check_cuda("flash_attention", z(1, 4, 16, 576), z(1, 4, 1, 576),
                    z(1, 4, 1, 512))
    with pytest.raises(NotImplementedError, match="head_dim 192 .*queue 2"):
        tfa._check_cuda("flash_decode", z(1, 1, 2, 192), z(1, 4, 2, 192),
                        z(1, 4, 2, 192), decode=True)
    with pytest.raises(NotImplementedError, match="decode kernels take Dk"):
        tfa._check_cuda("flash_decode", z(1, 1, 2, DK), z(1, 4, 1, DK),
                        z(1, 4, 1, DV), decode=True)


# ---------------------------------------------------------------------------
# the MLA attention layer
# ---------------------------------------------------------------------------

def _mla_setup(seed):
    jc, tc = _cfgs()
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jattn.init_mla(
        jax.random.key(seed), jc, jc.attention, jnp.float32))
    return rng, p, jc.attention, tc.attention, jc.d_model


def _mla_caches(rng, a, layout, B, S):
    """(jax cache, torch cache, jax tables, torch tables) of latent and
    rope-key rows; paged pools map each slot's lane through a table."""
    R, r = a.kv_lora_rank, a.qk_rope_dim
    if layout == "contiguous":
        c = {"ckv": _rand(rng, B, S, R), "kr": _rand(rng, B, S, r)}
        tables = None
    else:
        NP = S // PS
        P = B * NP + 1
        c = {"ckv": _rand(rng, P, PS, R), "kr": _rand(rng, P, PS, r)}
        tables = (1 + rng.permutation(B * NP)).reshape(B, NP).astype(
            np.int32)
    return ({n: jnp.asarray(v) for n, v in c.items()},
            {n: _t(v) for n, v in c.items()},
            None if tables is None else jnp.asarray(tables),
            None if tables is None else _t(tables))


@pytest.mark.parametrize("impl,window", [("flash", 0), ("ref", 0),
                                         ("ref", 5)])
def test_mla_forward_matches_jax(impl, window):
    rng, p, ja, ta, d = _mla_setup(1)
    x = _rand(rng, 2, 20, d)
    positions = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    want = jax.jit(functools.partial(jattn.mla_forward, a=ja, window=window,
                                     impl=impl))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(positions))
    got = tattn.mla_forward({k: _t(v) for k, v in p.items()}, _t(x),
                            _t(positions).long(), ta, window, impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("layout,pos", [("contiguous", "vector"),
                                        ("contiguous", "scalar"),
                                        ("paged", "vector")])
def test_mla_decode_matches_jax(layout, pos):
    rng, p, ja, ta, d = _mla_setup(2)
    B, S, window = 3, 32, 6
    jc, tc, jt, tt = _mla_caches(rng, ja, layout, B, S)
    x = _rand(rng, B, 1, d)
    ps = np.array([0, 13, 31], np.int32) if pos == "vector" else 17
    jy, jnew = jax.jit(functools.partial(jattn.mla_decode, a=ja,
                                         window=window, page_size=PS))(
        jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x), jnp.asarray(ps),
        tables=jt)
    ty, tnew = tattn.mla_decode({k: _t(v) for k, v in p.items()}, tc, _t(x),
                                _t(ps).long(), ta, window, tables=tt,
                                page_size=PS)
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER)
    for n in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tnew[n]), _np(jnew[n]), **LAYER)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mla_prefill_matches_jax(layout):
    rng, p, ja, ta, d = _mla_setup(3)
    B, S, C, pos0, window = 2, 32, 8, 12, 0
    jc, tc, jt, tt = _mla_caches(rng, ja, layout, B, S)
    x = _rand(rng, B, C, d)
    positions = np.broadcast_to(pos0 + np.arange(C, dtype=np.int32), (B, C))
    jy, jnew = jax.jit(functools.partial(jattn.mla_prefill, pos0=pos0, a=ja,
                                         window=window, page_size=PS))(
        jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x),
        jnp.asarray(positions), tables=jt)
    ty, tnew = tattn.mla_prefill({k: _t(v) for k, v in p.items()}, tc, _t(x),
                                 _t(positions).long(), pos0, ta, window,
                                 tables=tt, page_size=PS)
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER)
    for n in ("ckv", "kr"):
        np.testing.assert_allclose(_np(tnew[n]), _np(jnew[n]), **LAYER)


# ---------------------------------------------------------------------------
# the smoke decoder through the bridge
# ---------------------------------------------------------------------------

def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@functools.cache
def _jax_logits(seed):
    """The JAX decoder's logits through its einsum oracle (``ref``; the
    Pallas kernels are held to the port's plain versions above)."""
    jc, _ = _cfgs()
    tokens = _tokens(seed, (2, 24), jc.vocab_size)
    jm = j_build(j_impl(jc, "ref"))
    return tokens, np.asarray(jax.jit(jm.forward)(
        _jax_params(), {"tokens": jnp.asarray(tokens, jnp.int32)}))


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_decoder_logits_match_jax(impl):
    """The absorbed flash path and the naive per-head path both give the
    JAX decoder's logits."""
    _, tc = _cfgs()
    tokens, want = _jax_logits(5)
    got = t_build(t_impl(tc, impl), "cpu").forward(
        _port_params(), {"tokens": _t(tokens).long()})
    np.testing.assert_allclose(_np(got), want, **LOGITS)


@functools.cache
def _jax_loss_and_grads():
    """JAX's (loss, aux, ce, gradient leaves in the port's order) of the
    smoke decoder on one token batch, the attention through the Pallas
    kernels (the same with and without remat: JAX's checkpoint only
    recomputes)."""
    jc, _ = _cfgs()
    jm = j_build(j_impl(jc, "flash"))
    batch = tsyn.LMTokenSource(jc.vocab_size, 24).batch(2, 0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(_jax_params())
    grads = leaves(decoder_params_from_jax(jax.tree.map(np.asarray, jg)))
    return batch, float(jl), float(jmet["aux"]), float(jmet["loss"]), grads


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_loss_aux_and_grads_match_jax(remat):
    """decoder_loss = cross-entropy + the MoE layer's aux, and every leaf
    gradient (the routed experts', the router's and the MLA projections'
    included), the attention through the flash kernels on both sides."""
    batch, jl, jaux, jce, want = _jax_loss_and_grads()
    _, tc = _cfgs(remat=remat)
    tm = t_build(t_impl(tc, "flash"), "cpu")
    ls, treedef = flatten(_port_params())
    ps = [t.requires_grad_(True) for t in ls]
    tl, tmet = tm.loss_fn(unflatten(treedef, ps),
                          {n: torch.from_numpy(v) for n, v in batch.items()})
    tg = torch.autograd.grad(tl, ps)
    aux = tmet["aux"].item()
    assert aux > 0
    np.testing.assert_allclose(aux, jaux, **LAYER)
    np.testing.assert_allclose(tl.item(), jl, **LOGITS)
    np.testing.assert_allclose(tmet["loss"].item(), jce, **LOGITS)
    assert len(tg) == len(want)
    for a, b in zip(tg, want):
        np.testing.assert_allclose(_np(a), _np(b), **GRADS)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_then_two_decode_steps_match_jax(layout):
    """decoder_prefill of a 16-token chunk whose last 5 positions are pad
    (kept out of the MoE routing by ``valid``), then 2 decode steps."""
    jc, tc = _cfgs()
    jm, tm = j_build(jc), t_build(tc, "cpu")
    jp, tp = _jax_params(), _port_params()
    prompt = _tokens(6, 16, jc.vocab_size)
    C, S, valid = 16, 32, 11
    if layout == "paged":
        jcache, tcache = jm.init_paged_cache(1, PS, 5), tm.init_paged_cache(
            1, PS, 5)
        tables = np.arange(1, 5, dtype=np.int32)[None]
        jt, tt = jnp.asarray(tables), _t(tables)
    else:
        jcache, tcache = jm.init_cache(1, S), tm.init_cache(1, S)
        jt = tt = None
    kw_j = dict(seq_len=S, block_tables=jt, page_size=PS if jt is not None
                else 0)
    kw_t = dict(seq_len=S, block_tables=tt, page_size=PS if tt is not None
                else 0)
    prefill = jax.jit(jm.chunk_prefill, static_argnames=("seq_len",
                                                          "page_size"))
    decode = jax.jit(jm.decode_step, static_argnames=("seq_len",
                                                      "page_size"))
    jl, jcache = prefill(jp, jcache, jnp.asarray(prompt[None], jnp.int32), 0,
                         valid, **kw_j)
    tl, tcache = tm.chunk_prefill(tp, tcache, _t(prompt[None]).long(), 0,
                                  valid, **kw_t)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    tok = int(np.argmax(_np(jl)[0, valid - 1]))
    for i in range(2):
        pos = np.array([valid + i], np.int32)
        jl, jcache = decode(jp, jcache, {"tokens": jnp.asarray(
            [[tok]], jnp.int32)}, jnp.asarray(pos), **kw_j)
        tl, tcache = tm.decode_step(tp, tcache, {"tokens": _t([[tok]]).long()},
                                    _t(pos).long(), **kw_t)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
        tok = int(np.argmax(_np(jl)[0, 0]))


# ---------------------------------------------------------------------------
# the engine, BSP on 2 gloo ranks, the launcher
# ---------------------------------------------------------------------------

def _workload(vocab):
    """Four requests over two slots (slots churn); 0 and 3 share a
    16-token head, so the paged pool serves 3 from the prefix cache."""
    rng = np.random.RandomState(1)
    head = rng.randint(0, vocab, 16).tolist()
    prompts = [head + rng.randint(0, vocab, 5).tolist(),
               rng.randint(0, vocab, 12).tolist(),
               rng.randint(0, vocab, 9).tolist(),
               head + rng.randint(0, vocab, 3).tolist()]
    return prompts, [5, 3, 4, 4]


@functools.cache
def _jax_engine_tokens():
    jc, _ = _cfgs()
    prompts, news = _workload(jc.vocab_size)
    eng = JEngine(j_build(jc), _jax_params(), max_slots=2, max_seq=64,
                  prefill_chunk=8, page_size=0)
    rids = [eng.submit(p, m) for p, m in zip(prompts, news)]
    res = eng.run()
    return [res[int(r)] for r in rids]


@pytest.mark.parametrize("page_size", [8, 0])
def test_engine_greedy_matches_jax_engine(page_size):
    _, tc = _cfgs()
    eng = TEngine(t_build(tc, "cpu"), _port_params(), max_slots=2,
                  max_seq=64, prefill_chunk=8, page_size=page_size,
                  fused_sampling=True, device="cpu")
    prompts, news = _workload(tc.vocab_size)
    rids = [eng.submit(p, m) for p, m in zip(prompts, news)]
    res = eng.run()
    assert [res[int(r)] for r in rids] == _jax_engine_tokens()
    if page_size:
        assert eng.allocator.hit_tokens == 16
        eng.allocator.check_consistency()


def test_two_gloo_ranks_equal_one_jax_device_in_two_microbatches(tmp_path):
    """Two ``asa`` steps on k=2 gloo ranks, each on its half of every
    global batch, against JAX's one-device ``make_bsp_step`` over the
    whole batches in 2 microbatches: the MoE routes each rank's (each
    microbatch's) tokens with its own capacity and aux loss, so the
    halves are the same computation on both sides; max |dp| <= 1e-5."""
    from repro_torch.launch.train import run_ranks
    jc, tc = _cfgs()
    torch.save(_port_params(), tmp_path / "init.pt")
    src = tsyn.LMTokenSource(jc.vocab_size, 16)
    batches = [src.batch(4, i) for i in range(2)]
    torch.save([{n: torch.from_numpy(v) for n, v in b.items()}
                for b in batches], tmp_path / "batches.pt")
    run_ranks(lm_bsp_worker, 2, (str(tmp_path), tc))
    ports = [torch.load(tmp_path / f"lm_rank{r}.pt", weights_only=False)
             for r in range(2)]
    jm = dataclasses.replace(j_build(jc), init=lambda key: _jax_params())
    opt = jopt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        state = jbsp.init_train_state(jm, opt, jax.random.key(0))
        step = jax.jit(jbsp.make_bsp_step(jm, opt, jex.get_exchanger("asa"),
                                          jsched.constant(LM_LR), mesh,
                                          microbatches=2))
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, b, jax.random.key(i))
            losses.append(float(metrics["loss"]))
    want = leaves(decoder_params_from_jax(
        jax.tree.map(np.asarray, state["params"])))
    for res in ports:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        dp = max((a - b).abs().max().item()
                 for a, b in zip(leaves(res["params"]), want))
        assert dp <= 1e-5


def test_launcher_trains_deepseek_on_the_cpu(capfd):
    """The train launcher's --arch deepseek-v2-lite-16b --smoke --layers 2
    on 2 gloo ranks (plain kernel versions)."""
    from repro_torch.launch import train as launch
    assert ARCH in launch.TRAIN_ARCHS
    launch.main(["--arch", ARCH, "--smoke", "--layers", "2", "--device",
                 "cpu", "--ranks", "2", "--batch", "2", "--seq", "16",
                 "--steps", "2", "--exchanger", "asa16", "--sharded-update"])
    out = capfd.readouterr().out
    assert f"done: 2 steps of {ARCH}" in out and "tokens/s" in out
    assert os.environ.get("REPRO_ATTN_IMPL", "") == ""


def test_drain_restore_and_the_serve_launcher_on_latent_caches(capfd):
    """The engine's drain -> snapshot -> restore over the MLA latent and
    rope-key pages (greedy tokens equal to an uninterrupted run's), and
    the serve launcher on the smoke model."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import chaos
    _, tc = _cfgs()
    model, params = t_build(tc, "cpu"), _port_params()
    make = lambda: TEngine(model, params, max_slots=2, max_seq=64,  # noqa
                           prefill_chunk=8, page_size=8, device="cpu")
    out = chaos.verify_drain_restore(make, n=4, drain_after=3,
                                     vocab=tc.vocab_size)
    assert out["requeued"]
    launch.main(["--arch", ARCH, "--device", "cpu", "--num-requests", "3",
                 "--max-new", "4", "--fused-sampling", "--no-profile"])
    assert "tok/s" in capfd.readouterr().out
