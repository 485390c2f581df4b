"""The encoder-decoder (SeamlessM4T-v2's backbone), port against the JAX
package at fp32 on the CPU, at the smoke config (2 + 2 layers, d_model
256, 4 heads of 32, 64 stub frames, vocab 512, no remat) with the
parameters bridged by ``encdec_params_from_jax``:

- the init tree against the reference's (``jax.eval_shape``) and the
  bridge both ways;
- ``encode``, ``decode_train`` and ``encdec_loss``, and every leaf
  gradient (remat off and on in the port); the decoder's self-attention
  through the flash wrappers against the einsum route inside the port;
- ``prefill_encoder``'s cross K/V and 6 ``decode_step`` logits;
  ``generate``'s tokens (the stepwise path, which never runs the encoder:
  a fault of the reference that the port copies);
- the train launcher's ``frames`` bit for bit, its depth cut, its
  one step under each of the async and sharded plans, one k=2 BSP step
  on gloo equal to k=1, and a smoke run; the serve engine's and
  launcher's refusals.

The JAX side is computed once for the module (one jit each).
Tolerances: 1e-5 of the largest |value| for outputs (fp32, sums in
another order), 1e-4 relative Frobenius error for gradients, tokens and
frames exactly.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.train.serve import generate as j_generate  # noqa: E402
from repro_torch.bridge import encdec_params_from_jax  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import with_attn_impl  # noqa: E402
from repro_torch.core import bsp as tbsp  # noqa: E402
from repro_torch.core.gspmd import abstract_params  # noqa: E402
from repro_torch.core import exchanger as tex  # noqa: E402
from repro_torch.launch import serve as tserve_launch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import count_params  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train.serve import generate as t_generate  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_ranks import LM_LR, lm_bsp_worker  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
GRAD_TOL = 1e-4
K_TOL = 1e-6
PROMPT, NEW = 4, 6        # generate: prompt tokens, new tokens


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


def _cfgs(**kw):
    """(JAX, port) smoke configs in fp32, no remat unless ``kw`` says."""
    kw = {"dtype": "float32", "remat": False, **kw}
    return j_smoke(ARCH).with_overrides(**kw), t_smoke(ARCH).with_overrides(
        **kw)


def _stack(layers):
    return jax.tree.map(lambda *ls: np.stack([t.numpy() for t in ls]),
                        *layers)


def _np_params():
    """The reference's tree (``enc``/``dec`` stacked) holding the port's
    init from seed 0, as numpy arrays (the JAX init is slow here)."""
    _, tc = _cfgs()
    tp = t_build(tc, "cpu").init(0)
    out = {k: v.numpy() for k, v in tp.items() if k not in ("enc", "dec")}
    out["enc"], out["dec"] = _stack(tp["enc"]), _stack(tp["dec"])
    return out


def _np_batch(B=2, S=12, seed=0):
    """Tokens, labels (two masked) and normal stub frames."""
    jc, _ = _cfgs()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
         "frames": rng.standard_normal(
             (B, jc.encoder_seq_len, jc.d_model)).astype(np.float32)}
    b["labels"][:, :2] = -1
    return b


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the forward pieces, the loss and its gradient,
    the encoder prefill and 6 decode steps, and ``generate``."""
    jc, _ = _cfgs()
    with jax.set_mesh(jax.make_mesh((1,), ("unsharded",), axis_types=(
            jax.sharding.AxisType.Auto,))):
        npp = _np_params()
        p = jax.tree.map(jnp.asarray, npp)
        b = _np_batch()
        jm = j_build(jc)

        @jax.jit
        def forward_and_grad(p, b):
            def loss(p):
                enc_out = jenc.encode(p, b["frames"], jc)
                logits = jenc.decode_train(p, b["tokens"], enc_out, jc)
                return jm.loss_fn(p, b)[0], (enc_out, logits)
            (l, (e, lg)), g = jax.value_and_grad(loss, has_aux=True)(p)
            return e, lg, l, g

        enc_out, logits, loss, grads = forward_and_grad(p, b)
        # prefill, then 6 forced decode steps of the batch's tokens
        total = PROMPT + NEW
        cache = jenc.init_encdec_cache(jc, 2, total)
        cache = jax.jit(jm.prefill)(p, b["frames"], cache)
        cross = jax.tree.map(np.asarray, cache["cross"])
        step = jax.jit(lambda p, c, t, i: jm.decode_step(
            p, c, {"tokens": t}, i, seq_len=total))
        steps = []
        for i in range(6):
            lg, cache = step(p, cache, b["tokens"][:, i:i + 1], jnp.int32(i))
            steps.append(np.asarray(lg))
        gen = j_generate(jm, p, jnp.asarray(b["tokens"][:, :PROMPT]),
                         max_new=NEW, seq_len=total)
        return dict(batch=b, enc_out=np.asarray(enc_out),
                    logits=np.asarray(logits), loss=float(loss),
                    grads=jax.tree.map(np.asarray, grads), cross=cross,
                    steps=steps, self_cache=jax.tree.map(np.asarray,
                                                         cache["self"]),
                    generate=np.asarray(gen))


def _port(**kw):
    _, tc = _cfgs(**kw)
    return t_build(tc, "cpu"), encdec_params_from_jax(_np_params(), "cpu")


# ---------------------------------------------------------------------------
# trees and the bridge
# ---------------------------------------------------------------------------

def test_init_tree_is_the_reference_tree():
    """Same leaves, shapes and dtypes as the reference's init (evaluated
    for shapes only); the full config's tree counts ``param_count`` plus
    the second final norm."""
    jc, tc = _cfgs()
    want = jax.eval_shape(lambda: j_build(jc).init(jax.random.key(0)))
    got = _np_params()
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.shape == b.shape and a.dtype == b.dtype
    full = t_config(ARCH)
    n = count_params(abstract_params(t_build(full, "meta")))
    assert full.param_count() == j_config(ARCH).param_count() == 2_034_783_232
    assert n == full.param_count() + full.d_model


def test_bridge_unstacks_both_stacks_and_round_trips():
    """The reference's own init crosses the bridge layer for layer, and
    the port's init restacked crosses back unchanged."""
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, jax.jit(j_build(jc).init)(
        jax.random.key(3)))
    tp = encdec_params_from_jax(jp, "cpu")
    for name, n in (("enc", tc.num_encoder_layers), ("dec", tc.num_layers)):
        assert len(tp[name]) == n
        for j in range(n):
            for a, b in zip(leaves(tp[name][j]),
                            jax.tree.leaves(jax.tree.map(lambda v: v[j],
                                                         jp[name]))):
                np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tp["head"].numpy(), jp["head"])
    for a, b in zip(leaves(encdec_params_from_jax(_np_params(), "cpu")),
                    leaves(tenc.init_encdec(torch.Generator().manual_seed(0),
                                            tc, "cpu"))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

def test_encode_decode_and_loss_match_jax(ref):
    model, p = _port()
    b = _tb(ref["batch"])
    _, tc = _cfgs()
    with torch.no_grad():
        enc_out = tenc.encode(p, b["frames"], tc)
        _close(enc_out, ref["enc_out"])
        _close(tenc.decode_train(p, b["tokens"], enc_out, tc), ref["logits"])
        _close(model.forward(p, b), ref["logits"])
        loss, metrics = model.loss_fn(p, b)
    assert abs(float(loss) - ref["loss"]) <= TOL * abs(ref["loss"])
    assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(ref, remat):
    """Every leaf's gradient, ``embed`` and ``head`` included, within
    1e-4 relative Frobenius error of ``jax.grad``'s (the port with its
    per-layer checkpoint on and off)."""
    model, p = _port(remat=remat)
    p = tree_map(lambda t: t.requires_grad_(True), p)
    loss, _ = model.loss_fn(p, _tb(ref["batch"]))
    loss.backward()
    want = encdec_params_from_jax(ref["grads"], "cpu")
    got, exp = leaves(tree_map(lambda t: t.grad, p)), leaves(want)
    assert len(got) == len(exp) == 4 + 2 * 9 + 2 * 14
    for a, e in zip(got, exp):
        assert _rel(a.numpy(), e.numpy()) <= GRAD_TOL


def test_decoder_self_attention_flash_matches_ref():
    """The decoder's causal self-attention through the flash wrappers (on
    the CPU their plain versions, forward and backward) against the
    einsum route: loss and every gradient (the counterpart of the
    reference's ``test_encdec_decoder_self_attn_flash_vs_ref``)."""
    _, tc = _cfgs()
    b = _tb(_np_batch(B=1, S=10, seed=3))
    out = {}
    for impl in ("ref", "flash"):
        model = t_build(with_attn_impl(tc, impl), "cpu")
        p = tree_map(lambda t: t.requires_grad_(True), model.init(0))
        loss, _ = model.loss_fn(p, b)
        loss.backward()
        out[impl] = (loss.item(), leaves(tree_map(lambda t: t.grad, p)))
    assert abs(out["ref"][0] - out["flash"][0]) < 1e-4
    for a, e in zip(out["flash"][1], out["ref"][1]):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-3,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_jax(ref):
    """``prefill`` writes each layer's cross K/V; then 6 teacher-forced
    ``decode_step`` logits and the self-attention cache they leave."""
    model, p = _port()
    b = _tb(ref["batch"])
    cache = model.init_cache(2, PROMPT + NEW)
    assert model.prefill(p, b["frames"], cache) is cache
    for n in ("k", "v"):
        _close(cache["cross"][n], ref["cross"][n])
    for i, want in enumerate(ref["steps"]):
        logits, cache = model.decode_step(p, cache,
                                          {"tokens": b["tokens"][:, i:i + 1]},
                                          i, seq_len=PROMPT + NEW)
        _close(logits, want)
    for n in ("k", "v"):
        _close(cache["self"][n], ref["self_cache"][n])


def test_generate_matches_jax_from_a_zero_cross_cache(ref):
    """``generate`` takes the stepwise path (no chunked prefill) and gives
    the reference's tokens. Neither runs the encoder: the tokens are the
    ones a decode loop over ``init_cache``'s zero cross K/V gives, while
    the encoder's K/V change the logits."""
    model, p = _port()
    b = _tb(ref["batch"])
    prompt = b["tokens"][:, :PROMPT]
    got = t_generate(model, p, prompt, max_new=NEW)
    np.testing.assert_array_equal(got.numpy(), ref["generate"])
    total = PROMPT + NEW
    zero, filled = model.init_cache(2, total), model.init_cache(2, total)
    model.prefill(p, b["frames"], filled)
    tok, toks, gap = prompt[:, :1], [prompt[:, :1]], 0.0
    for i in range(total - 1):
        lz, zero = model.decode_step(p, zero, {"tokens": tok}, i,
                                     seq_len=total)
        lf, filled = model.decode_step(p, filled, {"tokens": tok}, i,
                                       seq_len=total)
        gap = max(gap, (lz - lf).abs().max().item())
        tok = prompt[:, i + 1:i + 2] if i + 1 < PROMPT else lz.argmax(-1)
        toks.append(tok)
    assert torch.equal(torch.cat(toks, 1), got)
    assert gap > 1e-2


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

def test_launcher_frames_are_the_reference_launchers():
    """``synthetic_batch`` of the full config: the reference launcher's
    tokens, labels and 4096 frames, bit for bit; ``--layers`` cuts both
    stacks."""
    cfg = t_config(ARCH)
    want = jlaunch.synthetic_batch(j_config(ARCH), 1, 5, seq_len=16)
    got = tlaunch.synthetic_batch(cfg, 1, 5, seq_len=16)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    assert got["frames"].shape == (1, 4096, 1024)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    cut = tlaunch.launch_config(dict(arch=ARCH, smoke=False, layers=4))
    assert (cut.num_layers, cut.num_encoder_layers) == (4, 4)
    assert ARCH in tlaunch.TRAIN_ARCHS


@pytest.mark.parametrize("algo", ["easgd", "asgd", "gspmd"])
def test_launcher_trains_encdec_under_every_plan(algo, capfd):
    """The launcher trains the encoder-decoder under every plan (it used
    to refuse all but BSP): one step on 2 gloo ranks, a finite loss."""
    tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--algo",
                  algo, "--ranks", "2", "--batch", "2", "--seq", "16",
                  "--steps", "1"])
    out = capfd.readouterr().out
    done = [ln for ln in out.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and ARCH in done[0], out
    assert (f"gspmd zero1" if algo == "gspmd" else f"{algo} tau=1") in done[0]
    loss = float(done[0].rsplit("loss ", 1)[1].split(" ")[0])
    assert np.isfinite(loss)


def test_sharded_loss_is_refused_by_name():
    model, p = _port()
    with pytest.raises(NotImplementedError, match="encdec"):
        model.loss_fn(p, _tb(_np_batch()), gather=lambda t: t)


def test_two_gloo_ranks_equal_one(tmp_path):
    """One BSP ``asa`` step of the launcher's batch (frames included) on 2
    gloo ranks, each on its half, equals the step of one rank on the
    whole batch (1e-6); the step's loss is the numpy mean of the halves'
    losses."""
    _, tc = _cfgs()
    params = t_build(tc, "cpu").init(0)
    batch = _tb(tlaunch.synthetic_batch(tc, 4, 0, seq_len=16))
    torch.save(params, tmp_path / "init.pt")
    torch.save([batch], tmp_path / "batches.pt")
    tlaunch.run_ranks(lm_bsp_worker, 2, (str(tmp_path), tc))
    ranks = [torch.load(tmp_path / f"lm_rank{r}.pt", weights_only=False)
             for r in range(2)]
    model = dataclasses.replace(t_build(tc, "cpu"), init=lambda gen: tree_map(
        torch.clone, params))
    opt = topt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    step = tbsp.make_bsp_step(model, opt, tex.get_exchanger("asa"),
                              tsched.constant(LM_LR))
    state, metrics = step(tbsp.init_train_state(model, opt, None), batch)
    with torch.no_grad():
        halves = [float(model.loss_fn(params, {n: v[i * 2:(i + 1) * 2]
                                               for n, v in batch.items()})[0])
                  for i in range(2)]
    moved = max((a - b).abs().max().item() for a, b in zip(
        leaves(state["params"]), leaves(params)))
    assert moved > 1e-3
    for r in ranks:
        assert abs(r["losses"][0] - np.mean(halves)) <= K_TOL
        dp = max((a - b).abs().max().item() for a, b in zip(
            leaves(r["params"]), leaves(state["params"])))
        assert dp <= K_TOL
    assert abs(float(metrics["loss"]) - np.mean(halves)) <= K_TOL


def test_train_launcher_trains_encdec_on_the_cpu(capfd):
    """--arch seamless-m4t-large-v2 --smoke: 2 gloo ranks, 64 frames
    before each 16-token sequence (plain kernel versions)."""
    tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--ranks",
                  "2", "--batch", "2", "--seq", "16", "--steps", "2"])
    out = capfd.readouterr().out
    assert f"done: 2 steps of {ARCH}" in out and "tokens/s" in out


# ---------------------------------------------------------------------------
# serving: refused, as in the reference
# ---------------------------------------------------------------------------

def test_serve_engine_and_launcher_refuse_encdec():
    model, p = _port()
    with pytest.raises(ValueError, match="encdec"):
        Engine(model, p, max_slots=2, max_seq=16, device="cpu")
    with pytest.raises(SystemExit, match="encdec"):
        tserve_launch.main(["--arch", ARCH, "--device", "cpu"])
