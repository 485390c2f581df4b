"""The state-space and early-fusion decoders, port against the JAX package
at fp32 on the CPU, at the smoke configs with bridged parameters:

- mamba2-1.3b (SSD blocks alone), hymba-1.5b (attention and SSD side by
  side after 8 meta tokens; cut to 3 layers so the middle one slides its
  32-key window), chameleon-34b and llama4-scout (early fusion: 16 image
  embeddings before the tokens);
- the init trees against the reference's (``jax.eval_shape``), the
  bridge both ways with ``meta``, the refusal of ``encdec`` alone;
- logits (the prefixes stripped), ``decoder_loss`` and every leaf
  gradient (hymba with remat too);
- chunked prefill bitwise equal to one call (logits and every cache
  leaf), a prefill chunk + 2 decode steps against JAX (contiguous, and
  paged with SSM lanes), ``generate`` against JAX's, and the train
  launcher's ``synthetic_batch`` against the reference launcher's.

Tolerances: logits and losses 1e-5 of the largest |logit| (fp32, sums in
another order, through 2-3 layers); gradients 1e-4 relative Frobenius
error; tokens exactly.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train.serve import generate as j_generate  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer import segments  # noqa: E402
from repro_torch.train.serve import generate as t_generate  # noqa: E402
from repro_torch.tree import flatten, leaves, unflatten  # noqa: E402

GRAD_TOL = 1e-4
PS = 8           # page size of the paged caches
# arch -> the smoke config's overrides: hymba at 3 layers (0 and 2 global,
# 1 on a 32-key window)
ARCHS = {"mamba2-1.3b": {}, "hymba-1.5b": dict(num_layers=3),
         "chameleon-34b": {}, "llama4-scout-17b-a16e": {}}


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
    """(JAX, port) smoke configs in fp32."""
    kw = dict(dict(dtype="float32", remat=False), **ARCHS[arch], **kw)
    return tuple(get(arch).with_overrides(**kw) for get in (j_smoke, t_smoke))


@functools.cache
def _np_params(arch):
    """The reference's tree (``blocks``: one stacked tree a segment)
    holding the port's init from seed 0, as numpy arrays."""
    _, tc = _cfgs(arch)
    tp = t_build(tc, "cpu").init(0)
    out = {k: v.numpy() for k, v in tp.items() if k != "layers"}
    blocks, li = [], 0
    for _, count in segments(tc):
        seg = tp["layers"][li:li + count]
        li += count
        blocks.append(jax.tree.map(
            lambda *ls: np.stack([t.numpy() for t in ls]), *seg))
    out["blocks"] = blocks
    return out


def _jax_params(arch):
    return jax.tree.map(jnp.asarray, _np_params(arch))


def _port_params(arch):
    return decoder_params_from_jax(_np_params(arch), "cpu")


def _batch(arch, seed=0, B=2, S=40):
    """Tokens and labels (S 40 passes hymba's 32-key window) and, for a
    VLM, random image embeddings."""
    jc, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][:, :3] = -1                       # masked positions
    if jc.modality == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, jc.num_image_tokens, jc.d_model)).astype(np.float32)
    return b


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# trees and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_tree_is_the_reference_tree(arch):
    """Same leaves, shapes and dtypes as the reference's init (evaluated
    for shapes only), meta and the SSM and fusion leaves included."""
    jc, _ = _cfgs(arch)
    want = jax.eval_shape(lambda: j_build(jc).init(jax.random.key(0)))
    got = _np_params(arch)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_bridge_carries_meta_and_ssm_leaves_both_ways():
    """The reference's own hymba init crosses the bridge leaf for leaf
    (``meta`` as a top-level leaf, each layer's ``ssm``/``fuse_*``), and
    the port's tree restacked crosses back unchanged."""
    jc, tc = _cfgs("hymba-1.5b")
    jp = jax.tree.map(np.asarray, jax.jit(j_build(jc).init)(
        jax.random.key(3)))
    tp = decoder_params_from_jax(jp, "cpu")
    np.testing.assert_array_equal(tp["meta"].numpy(), jp["meta"])
    assert tp["meta"].shape == (tc.num_meta_tokens, tc.d_model)
    li = 0
    for seg in jp["blocks"]:
        n = jax.tree.leaves(seg)[0].shape[0]
        for j in range(n):
            for a, b in zip(leaves(tp["layers"][li]),
                            leaves(jax.tree.map(lambda v: v[j], seg))):
                np.testing.assert_array_equal(a.numpy(), b)
            li += 1
    assert li == tc.num_layers
    back = _port_params("hymba-1.5b")
    for a, b in zip(leaves(back), leaves(ttr.init_decoder(
            torch.Generator().manual_seed(0), tc, "cpu"))):
        assert torch.equal(a, b)


def test_only_the_encdec_family_is_refused():
    """No family is refused any more: every assigned arch builds, the
    encdec one with its encoder prefill and decode step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ASSIGNED_ARCHS
    for arch in ASSIGNED_ARCHS:
        model = t_build(get_config(arch), "meta")
        assert model.loss_fn is not None and model.decode_step is not None
        assert (model.prefill is not None) == (arch == "seamless-m4t-large-v2")


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_match_jax_and_cover_the_tokens(arch):
    jc, tc = _cfgs(arch)
    b = _batch(arch, 1)
    want = jax.jit(j_build(jc).forward)(_jax_params(arch),
                                        jax.tree.map(jnp.asarray, b))
    got = t_build(tc, "cpu").forward(_port_params(arch), _tb(b))
    assert got.shape == b["tokens"].shape + (tc.vocab_size,)
    _close(got, want)


@functools.cache
def _jax_loss_and_grads(arch):
    jc, _ = _cfgs(arch)
    jm = j_build(jc)
    b = _batch(arch, 2)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, b)),
        has_aux=True))(_jax_params(arch))
    return b, float(jl), leaves(decoder_params_from_jax(
        jax.tree.map(np.asarray, jg)))


@pytest.mark.parametrize("arch,remat", [(a, False) for a in sorted(ARCHS)]
                         + [("hymba-1.5b", True)])
def test_decoder_loss_and_grads_match_jax(arch, remat):
    """decoder_loss and every leaf's gradient (meta tokens, the SSM leaves,
    the fusion norms and the MoE's included) through the prefixes."""
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
    if tc.num_meta_tokens:
        assert np.abs(np.asarray(want[names.index("meta")])).max() > 0


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [prefix]


def test_vlm_without_images_is_a_text_decoder():
    """A VLM batch without ``image_embeds`` runs on the tokens alone, as
    the reference's; a text config ignores ``image_embeds``."""
    jc, tc = _cfgs("chameleon-34b")
    b = _batch("chameleon-34b", 3)
    del b["image_embeds"]
    want = jax.jit(j_build(jc).forward)(_jax_params("chameleon-34b"),
                                        jax.tree.map(jnp.asarray, b))
    got = t_build(tc, "cpu").forward(_port_params("chameleon-34b"), _tb(b))
    _close(got, want)


# ---------------------------------------------------------------------------
# prefill, decode, generate
# ---------------------------------------------------------------------------

SERVE_ARCHS = ["mamba2-1.3b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_chunked_prefill_equals_one_call_bitwise(arch):
    """A 40-token prompt in chunks of 16 (SSD chunk 16) against one
    40-token call: the last logits and every cache leaf bit for bit."""
    _, tc = _cfgs(arch)
    model, params = t_build(tc, "cpu"), _port_params(arch)
    total, S0, C = 64, 40, 16
    prompt = torch.from_numpy(_batch(arch, 4, B=1, S=S0)["tokens"]).long()
    cc = model.init_cache(1, total)
    for c in range(0, S0, C):
        sl = prompt[:, c:c + C]
        v = sl.shape[1]
        sl = torch.nn.functional.pad(sl, (0, C - v))
        lg, cc = model.chunk_prefill(params, cc, sl, c, v, seq_len=total)
    cr = model.init_cache(1, total)
    lgr, cr = model.chunk_prefill(params, cr, prompt, 0, S0, seq_len=total)
    assert torch.equal(lg[:, v - 1], lgr[:, -1])
    for a, b in zip(leaves(cc), leaves(cr)):
        if a.ndim == 5 and a.shape[2] == total + tc.num_meta_tokens:
            # attention rows: the single call writes no pad rows
            a, b = a[:, :, :S0], b[:, :, :S0]
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,layout", [("mamba2-1.3b", "contiguous"),
                                         ("mamba2-1.3b", "paged"),
                                         ("hymba-1.5b", "contiguous"),
                                         ("hymba-1.5b", "paged")])
def test_prefill_then_two_decode_steps_match_jax(arch, layout):
    """A 24-token chunk whose last 5 positions are pad, then 2 decode
    steps, from a pool of 2 lanes (the prompt in lane 1): logits and
    every SSM leaf against JAX. Paged: the attention leaves in pages of 8
    through a block table, the SSM lanes one a slot."""
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), t_build(tc, "cpu")
    jp, tp = _jax_params(arch), _port_params(arch)
    prompt = _batch(arch, 5, B=1, S=24)["tokens"]
    C, S, valid = 24, 48, 19
    if layout == "paged":
        jpool, tpool = jm.init_paged_cache(2, PS, 8), tm.init_paged_cache(
            2, PS, 8)
        tables = np.arange(1, 7, dtype=np.int32)[None]
        jt, tt, ps = jnp.asarray(tables), torch.from_numpy(tables), PS
    else:
        jpool, tpool = jm.init_cache(2, S), tm.init_cache(2, S)
        jt = tt = None
        ps = 0

    def lane(pool):         # slot 1 of the slot-granular leaves
        return [{g: {n: (t if g == "attn" and ps else t[:, 1:2])
                     for n, t in d.items()} for g, d in seg.items()}
                for seg in pool]
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
    for jseg, tseg in zip(jc_, tc_):
        if "ssm" in tseg:
            for n in ("conv", "state"):
                _close(tseg["ssm"][n], jseg["ssm"][n])
    # the writes went through the views into lane 1 of the pool; lane 0
    # stayed zero
    for seg in tpool:
        if "ssm" in seg:
            assert seg["ssm"]["state"][:, 1].abs().max() > 0
            assert seg["ssm"]["state"][:, 0].abs().max() == 0


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_generate_matches_jax(arch):
    """Greedy generate (one whole-prompt prefill, then decode steps) on a
    batch of 2, the same tokens as the reference's."""
    jc, tc = _cfgs(arch)
    prompt = _batch(arch, 6, B=2, S=21)["tokens"]
    want = j_generate(j_build(jc), _jax_params(arch), jnp.asarray(prompt),
                      max_new=6, seq_len=27)
    got = t_generate(t_build(tc, "cpu"), _port_params(arch), prompt,
                     max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["chameleon-34b", "hymba-1.5b"])
def test_synthetic_batch_is_the_reference_launchers(arch):
    """The train launcher's batch: the reference launcher's tokens, labels
    and (VLM) zero image embeddings."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    want = jlaunch.synthetic_batch(cfg, 2, 3, seq_len=16)
    got = tlaunch.synthetic_batch(cfg, 2, 3, seq_len=16)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert ("image_embeds" in got) == (cfg.modality == "vlm")
    assert arch in tlaunch.TRAIN_ARCHS


def test_train_launcher_trains_a_vlm_on_the_cpu(capfd):
    """The train launcher's --arch chameleon-34b --smoke: 2 gloo ranks on
    token batches behind 16 zero image embeddings (plain kernel
    versions)."""
    tlaunch.main(["--arch", "chameleon-34b", "--smoke", "--device", "cpu",
                  "--ranks", "2", "--batch", "2", "--seq", "16", "--steps",
                  "2", "--exchanger", "asa16"])
    out = capfd.readouterr().out
    assert "done: 2 steps of chameleon-34b" in out and "tokens/s" in out
