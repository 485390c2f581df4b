"""The LM-training slice end to end, port against the JAX package, on the
CPU. The model is the smoke llama3.2-1b (2 layers, d_model 256, 4 heads
of 32; here over 2 KV heads, vocab 256), parameters from the JAX init
through the bridge, token batches from ``LMTokenSource``.

- ``decoder_loss`` and every gradient against the JAX ``model.loss_fn``
  in fp32, the attention through the flash kernels on both sides (the
  Pallas custom VJP in interpret mode; the port's autograd Function on
  its plain versions), with remat on and off: loss within 1e-4, leaf
  gradients rtol 1e-3 / atol 1e-5 (the JAX package's own bound for flash
  against its einsum oracle).
- BSP: one spawn of k=2 gloo ranks takes 2 ``asa`` steps, each rank on
  its half of every global batch; JAX's one-device ``make_bsp_step``
  takes the same 2 steps on the whole batches: max |dp| <= 1e-5 (the
  halves' mean gradient is the batch's, so only fp32 summation order
  differs).
- Checkpoints: the on-disk contract in both directions, the fallback
  past a torn or missing latest step, ``keep`` pruning, and save at step
  3 -> resume to 6 equal bit for bit to an unbroken 6-step run.
- ``generate``: greedy tokens equal to the JAX package's (fp32).
- The launcher: BSP with ``--ckpt``/``--resume``, and ``--algo gspmd``
  with AdamW (each rank's shards saved and resumed; ``--exchanger
  asa16`` refused).
- The quickstart recipe (bf16, ``asa``, ``warmup_cosine(0.02, 10, 100)``,
  batch 16 of 64 tokens) for 30 steps: the loss falls as the JAX run's
  does on the same batches, within 2e-2 a step (bf16 rounds in other
  places in the two frameworks).
"""
import dataclasses
import functools
import os
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs.base import with_attn_impl as jwith_impl  # noqa: E402
from repro.core import bsp as jbsp  # noqa: E402
from repro.core import exchanger as jex  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.configs.base import with_attn_impl as twith_impl  # noqa: E402
from repro_torch.data import prefetch as tprefetch  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map, unflatten  # noqa: E402
from test_torch_ranks import LM_LR, lm_bsp_worker  # noqa: E402

VOCAB, SEQ = 256, 32


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _cfgs(**kw):
    """(JAX, port) smoke llama configs: fp32, 4 heads over 2 KV heads."""
    out = []
    for get in (jget_smoke, tget_smoke):
        c = get("llama3.2-1b")
        out.append(c.with_overrides(**{
            "dtype": "float32", "vocab_size": VOCAB,
            "attention": dataclasses.replace(c.attention, num_kv_heads=2),
            **kw}))
    return out


@functools.cache
def _jax_params():
    jc, _ = _cfgs()
    return jbuild(jc).init(jax.random.key(0))


def _port_params():
    return decoder_params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                                   "cpu")


def _batches(n, size, seq=SEQ, vocab=VOCAB):
    src = tsyn.LMTokenSource(vocab, seq)
    return [src.batch(size, i) for i in range(n)]


def _tb(b):
    return {n: torch.from_numpy(v) for n, v in b.items()}


def _with_init(model, params):
    return dataclasses.replace(model,
                               init=lambda *a: tree_map(torch.clone, params))


# ---------------------------------------------------------------------------
# decoder_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_decoder_loss_and_grads_match_jax(remat):
    jc, tc = _cfgs(remat=remat)
    jm = jbuild(jwith_impl(jc, "flash"))
    tm = tbuild(twith_impl(tc, "flash"), "cpu")
    batch = _batches(1, 2)[0]
    jp = _jax_params()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    ls, treedef = flatten(_port_params())
    ps = [t.requires_grad_(True) for t in ls]
    tl, tmet = tm.loss_fn(unflatten(treedef, ps), _tb(batch))
    tg = torch.autograd.grad(tl, ps)
    assert abs(tl.item() - float(jl)) <= 1e-4
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    want = leaves(decoder_params_from_jax(jax.tree.map(np.asarray, jg)))
    assert len(tg) == len(want)
    for a, b in zip(tg, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_masked_labels_are_left_out():
    """labels < 0 drop out of the mean, as in the reference."""
    _, tc = _cfgs()
    tm = tbuild(tc, "cpu")
    tp = _port_params()
    b = _tb(_batches(1, 2)[0])
    masked = dict(b, labels=b["labels"].clone())
    masked["labels"][:, SEQ // 2:] = -1
    half = {n: v[:, :SEQ // 2] for n, v in b.items()}
    with torch.no_grad():
        full_l = tm.loss_fn(tp, masked)[0]
        half_l = tm.loss_fn(tp, half)[0]
    assert abs(full_l.item() - half_l.item()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_microbatches_accumulate_the_batch_gradient(dtype):
    """Two microbatches of a bf16-compute (or fp32) decoder over fp32
    masters take the step of the whole batch: 1e-6 in fp32; in bf16 each
    half rounds its activations on its own, which moves a gradient by
    about 1 % (1.2e-2 of the step here), so 5e-2 of each leaf's step."""
    from repro_torch.core import bsp as tbsp
    from repro_torch.core import exchanger as tex
    _, tc = _cfgs(dtype=dtype)
    tm = _with_init(tbuild(tc, "cpu"), _port_params())
    opt = topt.sgd_momentum(weight_decay=1e-4)
    b = _tb(_batches(1, 4)[0])
    p0 = leaves(_port_params())
    out = []
    for mb in (1, 2):
        step = tbsp.make_bsp_step(tm, opt, tex.get_exchanger("asa"),
                                  tsched.constant(LM_LR), microbatches=mb)
        st, met = step(tbsp.init_train_state(tm, opt, None), b)
        assert all(t.dtype == torch.float32 for t in leaves(st["params"]))
        out.append((leaves(st["params"]), float(met["loss"])))
    (one, l1), (two, l2) = out
    assert abs(l1 - l2) <= (1e-6 if dtype == "float32" else 1e-3)
    for a, b_, p in zip(one, two, p0):
        tol = 1e-6 if dtype == "float32" else 5e-2 * (a - p).abs().max()
        assert (a - b_).abs().max() <= tol


# ---------------------------------------------------------------------------
# k = 2 gloo ranks against JAX's one device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_bsp(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("lmbsp")
    _, tc = _cfgs()
    torch.save(_port_params(), out / "init.pt")
    batches = _batches(2, 4)
    torch.save([_tb(b) for b in batches], out / "batches.pt")
    run_ranks(lm_bsp_worker, 2, (str(out), tc))
    ports = [torch.load(out / f"lm_rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ports, batches


def test_two_gloo_ranks_equal_one_jax_device(lm_bsp):
    ports, batches = lm_bsp
    jc, _ = _cfgs()
    jm = dataclasses.replace(jbuild(jc), init=lambda key: _jax_params())
    opt = jopt.sgd_momentum(momentum=0.9, weight_decay=1e-4)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        state = jbsp.init_train_state(jm, opt, jax.random.key(0))
        step = jax.jit(jbsp.make_bsp_step(jm, opt, jex.get_exchanger("asa"),
                                          jsched.constant(LM_LR), mesh))
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, b, jax.random.key(i))
            losses.append(float(metrics["loss"]))
    want = leaves(decoder_params_from_jax(
        jax.tree.map(np.asarray, state["params"])))
    moved = max((a - b).abs().max().item() for a, b in zip(
        want, leaves(_port_params())))
    assert moved > 1e-3                       # the steps did move them
    for res in ports:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        dp = max((a - b).abs().max().item()
                 for a, b in zip(leaves(res["params"]), want))
        assert dp <= 1e-5
    for a, b in zip(leaves(ports[0]["params"]), leaves(ports[1]["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "layers": [{"b": torch.randn(5, generator=g)
                                   .bfloat16()}]},
            "opt": {"m": [torch.randn(2, generator=g)]}, "step": seed}


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype == y.dtype and torch.equal(x, y)) if torch.is_tensor(x)
        else x == y for x, y in zip(la, lb))


def test_checkpoint_roundtrip_keeps_dtypes_and_step(tmp_path):
    st = _tiny_state(3)
    tckpt.save_checkpoint(str(tmp_path), st, step=3, algo="bsp")
    back, step = tckpt.restore_for_resume(str(tmp_path), _tiny_state(0),
                                          expect_algo="bsp")
    assert step == 3 and _same(back, st)
    assert back["params"]["layers"][0]["b"].dtype == torch.bfloat16
    meta = tckpt.load_meta(str(tmp_path))
    assert meta["file"] == "state-00000003.npz" and "checksum" in meta
    with pytest.raises(ValueError, match="algo mismatch"):
        tckpt.restore_for_resume(str(tmp_path), _tiny_state(0),
                                 expect_algo="easgd")
    with pytest.raises(ValueError, match="layout mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), {"params": {"w": st["params"]
                                                            ["w"]}})


@pytest.mark.parametrize("fault", ["torn", "missing"])
def test_checkpoint_falls_back_past_a_bad_latest(tmp_path, fault):
    for s in (1, 2, 3):
        tckpt.save_checkpoint(str(tmp_path), _tiny_state(s), step=s)
    latest = tmp_path / "state-00000003.npz"
    if fault == "torn":
        latest.write_bytes(latest.read_bytes()[:100])
    else:
        latest.unlink()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        back, step = tckpt.restore_for_resume(str(tmp_path), _tiny_state(0))
        assert tckpt.latest_step(str(tmp_path)) == 2
    assert step == 2 and _same(back, _tiny_state(2))
    assert any("falling back to newest valid step 2" in str(x.message)
               for x in w)


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    for s in range(1, 6):
        tckpt.save_checkpoint(str(tmp_path), _tiny_state(s), step=s, keep=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["meta-00000004.json", "meta-00000005.json", "meta.json",
                     "state-00000004.npz", "state-00000005.npz"]
    assert tckpt.rank_dir("/c", 0, 1) == "/c"
    assert tckpt.rank_dir("/c", 1, 2) == os.path.join("/c", "rank1")


def test_checkpoint_contract_is_the_reference(tmp_path):
    """The port reads what the JAX package wrote (the stacked decoder tree
    through the bridge), and the JAX package reads what the port wrote."""
    jp = _jax_params()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, {"params": jp, "step": jnp.int32(3)}, step=3,
                          algo="bsp")
    # the JAX layout as the port's restore target: the same tree, torch leaves
    like = {"params": jax.tree.map(
        lambda a: torch.from_numpy(np.zeros_like(np.asarray(a))), jp),
        "step": 0}
    stacked, step = tckpt.restore_for_resume(jdir, like, expect_algo="bsp")
    assert step == 3 and tckpt.load_meta(jdir)["algo"] == "bsp"
    got = decoder_params_from_jax(stacked["params"])
    assert _same(got, _port_params())
    tckpt.save_checkpoint(tdir, stacked, step=3, algo="bsp")
    back, step = jckpt.restore_for_resume(
        tdir, {"params": jp, "step": jnp.int32(0)}, expect_algo="bsp")
    assert step == 3
    for a, b in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_equals_the_unbroken_run(tmp_path):
    """Save at step 3, resume to 6: the state equals an unbroken 6-step
    run bit for bit (the resumed run replays the consumed batches)."""
    _, tc = _cfgs()
    tm = _with_init(tbuild(tc, "cpu"), _port_params())
    tb = [_tb(b) for b in _batches(6, 2)]
    opt = topt.sgd_momentum(weight_decay=1e-4)
    lr = tsched.warmup_cosine(0.02, 2, 6)
    plan = tengine.TrainPlan(exchanger="asa")
    run = functools.partial(tloop.train, tm, opt, lr, plan=plan, log_every=0,
                            print_fn=lambda *a: None)
    whole, rep = run(iter(tb), num_steps=6)
    ck = str(tmp_path / "ck")
    _, rep3 = run(iter(tb), num_steps=3, ckpt_path=ck, ckpt_every=3)
    assert tckpt.latest_step(ck) == 3 and rep3.steps == 3
    resumed, rep_r = run(iter(tb), num_steps=6, resume_from=ck)
    assert rep_r.steps == 6 and len(rep_r.losses) == 3
    assert rep_r.losses == rep.losses[3:]
    assert _same(resumed, whole)


# ---------------------------------------------------------------------------
# generate, the quickstart recipe, the loader, the launcher
# ---------------------------------------------------------------------------

def test_generate_greedy_matches_jax():
    jc, tc = _cfgs()
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 5)).astype(
        np.int32)
    want = jserve.generate(jbuild(jc), _jax_params(), jnp.asarray(prompt),
                           max_new=8, seq_len=13)
    got = tserve.generate(tbuild(tc, "cpu"), _port_params(),
                          torch.from_numpy(prompt), max_new=8)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quickstart_recipe_loss_falls_as_jax(monkeypatch):
    from repro.telemetry import _runtime
    monkeypatch.setattr(_runtime._state.config, "profile", False)
    steps = 30
    jc = jget_smoke("llama3.2-1b").with_overrides(vocab_size=256)
    tc = tget_smoke("llama3.2-1b").with_overrides(vocab_size=256)
    jp = jbuild(jc).init(jax.random.key(0))
    jm = dataclasses.replace(jbuild(jc), init=lambda key: jp)
    batches = _batches(steps, 16, seq=64, vocab=256)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        _, jrep = jloop.train(jm, jopt.sgd_momentum(weight_decay=0.0),
                              jsched.warmup_cosine(0.02, 10, 100), mesh,
                              iter(batches),
                              plan=jengine.TrainPlan(exchanger="asa"),
                              num_steps=steps, log_every=10,
                              print_fn=lambda *a: None)
    tm = _with_init(tbuild(tc, "cpu"), decoder_params_from_jax(
        jax.tree.map(np.asarray, jp)))
    _, trep = tloop.train(tm, topt.sgd_momentum(weight_decay=0.0),
                          tsched.warmup_cosine(0.02, 10, 100),
                          [_tb(b) for b in batches],
                          tengine.TrainPlan(exchanger="asa"),
                          num_steps=steps, log_every=10,
                          print_fn=lambda *a: None)
    assert len(trep.losses) == len(jrep.losses) == steps
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=0, atol=2e-2)
    assert trep.losses[-1] < trep.losses[0] - 1.0
    assert trep.metrics["train/tokens"].value == steps * 16 * 64


def test_parallel_loader_passes_token_batches_through(tmp_path):
    src = tsyn.LMTokenSource(50, 9)
    files = tsyn.materialize_batch_files(src, tmp_path, 2, 3)
    got = list(tprefetch.ParallelLoader(files, epochs=2))
    assert len(got) == 4
    for i, b in enumerate(got):
        want = src.batch(3, i % 2)
        for n in ("tokens", "labels"):
            assert b[n].dtype == torch.int32
            assert np.array_equal(b[n].numpy(), want[n])


def test_train_lm_bsp_preset_is_the_example_config():
    """``--preset train_lm_bsp`` builds examples/train_lm_bsp.py's config."""
    from repro_torch.launch import train as launch
    j = jget_config("llama3.2-1b")
    want = j.with_overrides(
        num_layers=6, d_model=768, d_ff=2048, vocab_size=32768,
        attention=j.attention.__class__(num_heads=12, num_kv_heads=4,
                                        head_dim=64),
        tie_embeddings=True, scan_layers=True, remat=False)
    assert dataclasses.asdict(launch.train_lm_bsp_config()) == \
        dataclasses.asdict(want)


def test_launcher_trains_and_resumes_a_decoder_on_the_cpu(tmp_path, capfd):
    from repro_torch.launch import train as launch
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--ranks",
            "2", "--batch", "2", "--seq", "16", "--exchanger", "asa16",
            "--sharded-update"]
    ck = str(tmp_path / "ck")
    launch.main(args + ["--steps", "2", "--ckpt", ck])
    out = capfd.readouterr().out
    assert "done: 2 steps of llama3.2-1b" in out and "tokens/s" in out
    assert sorted(os.listdir(ck)) == ["rank0", "rank1"]
    launch.main(args + ["--steps", "3", "--resume", ck])
    out = capfd.readouterr().out
    assert "done: 3 steps of llama3.2-1b" in out
    assert tckpt.latest_step(tckpt.rank_dir(ck, 1, 2)) == 2


def test_launcher_trains_gspmd_and_resumes_on_the_cpu(tmp_path, capfd):
    """``--algo gspmd`` with AdamW on 2 ranks, saved and resumed (each
    rank its own shards); an exchanger other than asa is refused as the
    reference's TrainPlan refuses it."""
    from repro_torch.launch import train as launch
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--ranks",
            "2", "--batch", "2", "--seq", "16", "--algo", "gspmd", "--mode",
            "zero1", "--optimizer", "adamw", "--lr", "0.01"]
    ck = str(tmp_path / "ck")
    launch.main(args + ["--steps", "2", "--ckpt", ck])
    out = capfd.readouterr().out
    n = sum(t.numel() for t in leaves(tbuild(tget_smoke("llama3.2-1b"),
                                             "meta").init(torch.Generator())))
    assert f"done: 2 steps of llama3.2-1b ({n:,} params)" in out
    assert "gspmd zero1" in out and "tokens/s" in out
    assert sorted(os.listdir(ck)) == ["rank0", "rank1"]
    assert tckpt.load_meta(tckpt.rank_dir(ck, 0, 2))["algo"] == "gspmd"
    launch.main(args + ["--steps", "3", "--resume", ck])
    assert "done: 3 steps of llama3.2-1b" in capfd.readouterr().out
    assert tckpt.latest_step(tckpt.rank_dir(ck, 1, 2)) == 2
    with pytest.raises(SystemExit):
        launch.main(args + ["--steps", "1", "--exchanger", "asa16"])
    assert "exchanger knob does not apply" in capfd.readouterr().err
