"""The assigned decoders not held to the JAX package elsewhere, port
against it at fp32 on the CPU, at the smoke configs with parameters
carried by ``bridge.decoder_params_from_jax``:

- minitron-8b and mistral-large-123b, each at its full config's GQA
  group: ``reduced()`` gives every smoke config 4 heads over 4 (G 1), so
  the heads are overridden to 8 over 2 (minitron's G 4) and 12 over 1
  (mistral's G 12) at the smoke head dim 32; the attention through the
  flash kernels on both sides (Pallas in interpret mode, the port's
  plain versions). The reference's init tree crosses the bridge; logits,
  ``decoder_loss`` and every leaf gradient (remat off and on); a
  24-token prefill chunk (5 pad positions) + 2 decode steps, contiguous
  and paged; greedy ``generate`` tokens.
- One spawn of 2 gloo ranks (``test_torch_ranks.archs_worker``), each
  rank on its half of every global batch, 2 momentum-SGD steps:
  - BSP ``asa`` (fp32 wire) with the sharded update on smoke mamba2-1.3b
    and hymba-1.5b (3 layers, so layer 1 slides its 32-key window),
    against JAX's one-device BSP step on the whole batches;
  - gspmd ``zero1`` on smoke llama4-scout (top-1 MoE with a shared
    expert, 16 image embeddings before the tokens) and chameleon-34b
    (qk norms, the image prefix), against the port's own BSP ``asa``
    sharded: each rank routes its own tokens, so the two are the same
    computation in another exchange.

Tolerances: logits and losses 1e-5 of the largest |logit| or of the loss
(fp32, sums in another order, through 2 layers); gradients GRAD_TOL
relative Frobenius error; tokens exactly; the rank runs' losses rtol
1e-5 and parameters rtol 1e-4 / atol 1e-6 (the reference's own bounds
for its gspmd against BSP, ``tests/test_engine.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import with_attn_impl as j_impl  # noqa: E402
from repro.core import bsp as jbsp  # noqa: E402
from repro.core import exchanger as jex  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train.serve import generate as j_generate  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import with_attn_impl as t_impl  # noqa: E402
from repro_torch.core import gspmd as tgspmd  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.transformer import segments  # noqa: E402
from repro_torch.train.serve import generate as t_generate  # noqa: E402
from repro_torch.tree import flatten, leaves, unflatten  # noqa: E402
from test_torch_ranks import ARCHS_LR, ARCHS_STEPS, archs_worker  # noqa: E402

GRAD_TOL = 1e-4
PS = 8           # page size of the paged caches
# arch -> (heads, KV heads) at the smoke head dim: the full config's G
HEADS = {"minitron-8b": (8, 2), "mistral-large-123b": (12, 1)}
# the rank runs: arch -> (smoke overrides, plans)
RANK_ARCHS = {"mamba2-1.3b": ({}, ("bsp",)),
              "hymba-1.5b": (dict(num_layers=3), ("bsp",)),
              "llama4-scout-17b-a16e": ({}, ("zero1", "bsp")),
              "chameleon-34b": ({}, ("zero1", "bsp"))}
K = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke shapes gain nothing from intra-op threads, and the suite's
    workers share the host's cores: one thread a worker for this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types. A
    test file run earlier in the same process may leave a global
    ``jax.set_mesh`` with explicit axes behind."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cfgs(arch, **kw):
    """(JAX, port) smoke configs in fp32 at the full config's G, the
    attention through the flash kernels."""
    H, KV = HEADS[arch]
    out = []
    for get, impl in ((j_smoke, j_impl), (t_smoke, t_impl)):
        c = get(arch)
        c = c.with_overrides(**dict(dict(
            dtype="float32", remat=False, attention=dataclasses.replace(
                c.attention, num_heads=H, num_kv_heads=KV)), **kw))
        out.append(impl(c, "flash"))
    return tuple(out)


@functools.cache
def _np_jax_params(arch):
    jc, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jax.jit(j_build(jc).init)(
        jax.random.key(0)))


def _jax_params(arch):
    return jax.tree.map(jnp.asarray, _np_jax_params(arch))


def _port_params(arch):
    return decoder_params_from_jax(_np_jax_params(arch), "cpu")


def _batch(vocab, seed=0, B=2, S=40, d_model=0, images=0):
    """Tokens and labels (the first 3 positions masked) and, with
    ``images``, random image embeddings before them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][:, :3] = -1
    if images:
        b["image_embeds"] = rng.standard_normal(
            (B, images, d_model)).astype(np.float32)
    return b


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [prefix]


# ---------------------------------------------------------------------------
# minitron-8b and mistral-large-123b against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(HEADS))
def test_smoke_configs_keep_the_full_group(arch):
    """The overrides keep the published G = H / KV at the smoke width, and
    both packages' configs agree."""
    jc, tc = _cfgs(arch)
    full = j_config(arch).attention
    a = tc.attention
    assert a.num_heads // a.num_kv_heads == full.num_heads // full.num_kv_heads
    assert a.head_dim == 32
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_bridge_carries_the_reference_tree(arch):
    """The reference's init crosses the bridge leaf for leaf into the
    port's tree (one dict a layer, the same shapes as the port's own
    init)."""
    _, tc = _cfgs(arch)
    jp = _np_jax_params(arch)
    tp = _port_params(arch)
    mine = t_build(tc, "cpu").init(torch.Generator().manual_seed(0))
    assert [p for p in _paths(tp)] == [p for p in _paths(mine)]
    for a, b in zip(leaves(tp), leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(tp["embed"].numpy(), jp["embed"])
    li = 0
    for seg in jp["blocks"]:
        n = jax.tree.leaves(seg)[0].shape[0]
        for j in range(n):
            for a, b in zip(leaves(tp["layers"][li]),
                            leaves(jax.tree.map(lambda v: v[j], seg))):
                np.testing.assert_array_equal(a.numpy(), b)
            li += 1
    assert li == tc.num_layers


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_logits_match_jax(arch):
    jc, tc = _cfgs(arch)
    b = _batch(jc.vocab_size, 1)
    want = jax.jit(j_build(jc).forward)(_jax_params(arch),
                                        jax.tree.map(jnp.asarray, b))
    got = t_build(tc, "cpu").forward(_port_params(arch), _tb(b))
    assert got.shape == b["tokens"].shape + (tc.vocab_size,)
    _close(got, want)


@functools.cache
def _jax_loss_and_grads(arch):
    jc, _ = _cfgs(arch)
    jm = j_build(jc)
    b = _batch(jc.vocab_size, 2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, b)),
        has_aux=True))(_jax_params(arch))
    return b, float(jl), leaves(decoder_params_from_jax(
        jax.tree.map(np.asarray, jg)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", sorted(HEADS))
def test_decoder_loss_and_grads_match_jax(arch, remat):
    b, jl, want = _jax_loss_and_grads(arch)
    _, tc = _cfgs(arch, remat=remat)
    ls, treedef = flatten(_port_params(arch))
    ps = [t.requires_grad_(True) for t in ls]
    tl, _ = t_build(tc, "cpu").loss_fn(unflatten(treedef, ps), _tb(b))
    tg = torch.autograd.grad(tl, ps)
    _close(tl, np.float32(jl))
    assert len(tg) == len(want)
    names = [".".join(map(str, p)) for p in _paths(_port_params(arch))]
    for name, a, w in zip(names, tg, want):
        assert torch.isfinite(a).all(), name
        assert _rel(a.numpy(), w) <= GRAD_TOL, name


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", sorted(HEADS))
def test_prefill_then_two_decode_steps_match_jax(arch, layout):
    """A 24-token chunk whose last 5 positions are pad, then 2 decode
    steps fed JAX's greedy tokens, in lane 1 of a pool of 2 lanes (paged:
    pages of 8 through a block table): logits against JAX."""
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), t_build(tc, "cpu")
    jp, tp = _jax_params(arch), _port_params(arch)
    prompt = _batch(jc.vocab_size, 5, B=1, S=24)["tokens"]
    S, valid = 48, 19
    if layout == "paged":
        jpool, tpool = jm.init_paged_cache(2, PS, 8), tm.init_paged_cache(
            2, PS, 8)
        tables = np.arange(1, 7, dtype=np.int32)[None]
        jt, tt, ps = jnp.asarray(tables), torch.from_numpy(tables), PS
        jc_, tc_ = jpool, tpool
    else:
        jpool, tpool = jm.init_cache(2, S), tm.init_cache(2, S)
        jt = tt = None
        ps = 0
        lane = lambda pool: [{g: {n: t[:, 1:2] for n, t in d.items()}  # noqa: E731
                              for g, d in seg.items()} for seg in pool]
        jc_, tc_ = lane(jpool), lane(tpool)
    kw = dict(seq_len=S, block_tables=jt, page_size=ps)
    prefill = jax.jit(jm.chunk_prefill, static_argnames=("seq_len",
                                                          "page_size"))
    decode = jax.jit(jm.decode_step, static_argnames=("seq_len",
                                                      "page_size"))
    jl, jc_ = prefill(jp, jc_, jnp.asarray(prompt), 0, valid, **kw)
    tl, tc_ = tm.chunk_prefill(tp, tc_, torch.from_numpy(prompt).long(), 0,
                               valid, seq_len=S, block_tables=tt,
                               page_size=ps)
    _close(tl[:, :valid], np.asarray(jl)[:, :valid])
    tok = int(np.argmax(np.asarray(jl)[0, valid - 1]))
    for i in range(2):
        pos = np.array([valid + i], np.int32)
        jl, jc_ = decode(jp, jc_, {"tokens": jnp.asarray([[tok]], jnp.int32)},
                         jnp.asarray(pos), **kw)
        tl, tc_ = tm.decode_step(tp, tc_, {"tokens": torch.tensor([[tok]])},
                                 torch.from_numpy(pos).long(), seq_len=S,
                                 block_tables=tt, page_size=ps)
        _close(tl, jl)
        tok = int(np.argmax(np.asarray(jl)[0, 0]))
    if layout == "contiguous":       # lane 0 stayed zero
        for seg in tpool:
            assert seg["attn"]["k"][:, 0].abs().max() == 0
            assert seg["attn"]["k"][:, 1].abs().max() > 0


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_generate_matches_jax(arch):
    """Greedy generate (one whole-prompt prefill, then decode steps) on a
    batch of 2: the same tokens as the reference's."""
    jc, tc = _cfgs(arch)
    prompt = _batch(jc.vocab_size, 6, B=2, S=21)["tokens"]
    want = j_generate(j_build(jc), _jax_params(arch), jnp.asarray(prompt),
                      max_new=6, seq_len=27)
    got = t_generate(t_build(tc, "cpu"), _port_params(arch), prompt,
                     max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# two gloo ranks: BSP against JAX's one device, gspmd against BSP
# ---------------------------------------------------------------------------

def _rank_cfg(arch, get=t_smoke):
    kw, _ = RANK_ARCHS[arch]
    return get(arch).with_overrides(dtype="float32", **kw)


@functools.cache
def _rank_init(arch):
    """The port's init from seed 0 (the JAX init is slow here)."""
    return t_build(_rank_cfg(arch), "cpu").init(
        torch.Generator().manual_seed(0))


def _rank_batches(arch):
    c = _rank_cfg(arch)
    images = c.num_image_tokens if c.modality == "vlm" else 0
    return [_batch(c.vocab_size, 10 + i, B=4, d_model=c.d_model,
                   images=images) for i in range(ARCHS_STEPS)]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("archs")
    cases = []
    for arch, (_, plans) in RANK_ARCHS.items():
        torch.save(_rank_init(arch), out / f"{arch}.init.pt")
        torch.save([_tb(b) for b in _rank_batches(arch)],
                   out / f"{arch}.batches.pt")
        cases += [(arch, _rank_cfg(arch), plan) for plan in plans]
    run_ranks(archs_worker, K, (str(out), cases))
    return [torch.load(out / f"archs{r}.pt", weights_only=False)
            for r in range(K)]


def _jax_tree(arch):
    """The port's init restacked into the reference's ``blocks``."""
    tp = _rank_init(arch)
    out = {k: jnp.asarray(v.numpy()) for k, v in tp.items() if k != "layers"}
    blocks, li = [], 0
    for _, count in segments(_rank_cfg(arch)):
        seg = tp["layers"][li:li + count]
        li += count
        blocks.append(jax.tree.map(
            lambda *ls: jnp.asarray(np.stack([t.numpy() for t in ls])),
            *seg))
    out["blocks"] = blocks
    return out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_two_rank_bsp_equals_one_jax_device(rank_runs, arch):
    """BSP asa with the sharded update on two halves of each batch: the
    same losses and SGD parameters as JAX's one-device BSP step on the
    whole batches (the halves' mean gradient is the batch's)."""
    jc = _rank_cfg(arch, j_smoke)
    params = _jax_tree(arch)
    jm = dataclasses.replace(j_build(jc), init=lambda key: params)
    opt = jopt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        state = jbsp.init_train_state(jm, opt, jax.random.key(0))
        step = jax.jit(jbsp.make_bsp_step(jm, opt, jex.get_exchanger("asa"),
                                          jsched.constant(ARCHS_LR), mesh))
        losses = []
        for i, b in enumerate(_rank_batches(arch)):
            state, metrics = step(state, b, jax.random.key(i))
            losses.append(float(metrics["loss"]))
    want = leaves(decoder_params_from_jax(
        jax.tree.map(np.asarray, state["params"])))
    moved = max((a - b).abs().max().item()
                for a, b in zip(want, leaves(_rank_init(arch))))
    assert moved > 1e-3                       # the steps did move them
    for r in rank_runs:
        res = r[f"{arch}-bsp"]
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        got = leaves(res["params"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "chameleon-34b"])
def test_two_rank_gspmd_zero1_equals_bsp_sharded(rank_runs, arch):
    """gspmd zero1 (each layer gathered from its shards, the image prefix
    before the tokens; llama4-scout's 3-D expert leaves sharded) takes the
    trajectory of BSP asa with the sharded update."""
    ranks = [r[f"{arch}-zero1"] for r in rank_runs]
    got = leaves(tgspmd.unshard_trees([r["params"] for r in ranks],
                                      ranks[0]["specs"]))
    moved = max((a - b).abs().max().item()
                for a, b in zip(got, leaves(_rank_init(arch))))
    assert moved > 1e-3
    for r in rank_runs:
        bsp = r[f"{arch}-bsp"]
        np.testing.assert_allclose(r[f"{arch}-zero1"]["losses"],
                                   bsp["losses"], rtol=1e-5)
        want = leaves(bsp["params"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)
    if arch.startswith("llama4"):
        # the routed experts' leaves are sharded on their expert axis
        specs = leaves(ranks[0]["specs"]["layers"][0]["moe"])
        assert any(s.dim is not None and len(s.shape) == 3 for s in specs)
