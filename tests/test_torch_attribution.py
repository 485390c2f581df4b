"""Per-program attribution on the port (``telemetry.profile`` over
``roofline.analysis.CostMode``) against the JAX package's, on the CPU.

- ``capture`` of a 64x64 fp32 ``x @ x`` counts exactly 2 * 64^3 flops;
  the reference's capture of the same program lies within its own test's
  25 %.
- With the three ``REPRO_PEAK_*`` variables set alike, port and reference
  profiles with equal fields give equal ``roofline()`` and ``gauges()``.
- A capture failure (a counting fault, or the program's own exception)
  is ``profile/capture_errors`` and ``meta["capture_error"]``, and the
  program runs exactly once.
- ``instrument``: the first call is the counted call, run once, its
  output bit for bit an uncounted call's; a counted train step leaves the
  state bit for bit as an uncounted one (smoke llama3.2-1b, fp32).
- ``REPRO_TELEMETRY_PROFILE``'s knob turns profiling off.
- The reference's ``test_train_loop_emits_program_and_compile_gauges``
  and ``test_serve_engine_emits_decode_attribution`` on the port.
- ``train/mfu`` only with ``REPRO_PEAK_FLOPS`` set; ``train/model_flops_s``
  is 6·N·D of the rank's steady tokens a second.
- ``grad_norm``: within 1e-5 (relative) of JAX's ``make_bsp_step(...,
  grad_norm=True)``, subgd and awagd; the loop's ``train/grad_norm``.
- The launcher: ``--no-profile`` writes no ``profile/*`` gauge;
  ``--attn-impl`` picks the route, ``blockwise`` is refused by name.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import telemetry as jtel  # noqa: E402
from repro.telemetry import profile as jprofile  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import constant, sgd_momentum  # noqa: E402
from repro_torch.roofline import analysis as tan  # noqa: E402
from repro_torch.telemetry import profile as tprofile  # noqa: E402
from repro_torch.train.engine import TrainPlan, build_engine  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

VOCAB, SEQ = 256, 32


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' telemetry on and empty, profiling on, the JAX side
    on one device with no sharding in its types."""
    for tel in (jtel, ttel):
        tel.set_enabled(True)
        tel.reset()
        tel.configure(profile=True)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield
    for tel in (jtel, ttel):
        tel.configure(profile=True)
        tel.reset()


# ---------------------------------------------------------------------------
# capture, roofline, gauges
# ---------------------------------------------------------------------------

def test_capture_counts_a_product_exactly():
    x = torch.randn(64, 64)
    prof = tprofile.capture("test/prog", lambda a: a @ a, x, coll_bytes=1e6)
    assert prof is not None and prof.captured
    assert prof.flops == 2 * 64 ** 3
    assert prof.hbm_bytes == 3 * 64 * 64 * 4
    assert prof.coll_bytes == 1e6
    jprof = jprofile.capture("test/prog", jax.jit(lambda a: a @ a),
                             jnp.ones((64, 64), jnp.float32), coll_bytes=1e6)
    assert jprof.flops == pytest.approx(prof.flops, rel=0.25)
    tprofile.observe("test/prog", 0.010)
    tprofile.observe("test/prog", 0.020)
    tprofile.emit()
    reg = ttel.default_registry()
    for q in ("flops", "hbm_bytes", "coll_bytes", "calls", "mean_time_s",
              "achieved_flops_s", "mfu", "hbm_frac", "achieved_coll_bw",
              "coll_frac"):
        assert reg[f"profile/test_prog/{q}"].value is not None
    assert reg["profile/test_prog/mfu"].value == pytest.approx(
        2 * 64 ** 3 / 0.015 / 989e12)


FIELDS = [dict(flops=4.2e13, hbm_bytes=3.1e11, coll_bytes=2.47e9, calls=3,
               total_time_s=15.75),
          dict(flops=5e9, hbm_bytes=2.6e9, coll_bytes=0.0, calls=40,
               total_time_s=1.2),
          dict(flops=0.0, hbm_bytes=6e8, coll_bytes=1.2e9, calls=2,
               total_time_s=4.0)]


@pytest.mark.parametrize("fields", FIELDS)
def test_roofline_and_gauges_equal_the_reference(monkeypatch, fields):
    for var, v in (("REPRO_PEAK_FLOPS", "989e12"),
                   ("REPRO_PEAK_HBM_BW", "3.35e12"),
                   ("REPRO_PEAK_ICI_BW", "450e9")):
        monkeypatch.setenv(var, v)
    t = tprofile.ProgramProfile("train/step", captured=True, **fields)
    j = jprofile.ProgramProfile("train/step", captured=True, **fields)
    assert t.roofline() == j.roofline()
    assert t.gauges() == j.gauges()


def test_capture_failure_is_counted_and_fn_runs_once(monkeypatch):
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    def broken(self, *a, **k):
        raise RuntimeError("no formula for you")

    monkeypatch.setattr(tan.CostMode, "_count", broken)
    assert tprofile.capture("test/broken", fn, torch.ones(3)) is None
    assert calls == [1]
    reg = ttel.default_registry()
    assert reg["profile/capture_errors"].value == 1
    assert "no formula" in tprofile.get("test/broken").meta["capture_error"]
    # through instrument: the output still comes back, from one call
    w = tprofile.instrument("test/broken2", fn)
    assert torch.equal(w(torch.ones(3)), torch.full((3,), 2.0))
    assert calls == [1, 1] and not tprofile.get("test/broken2").captured
    assert reg["profile/capture_errors"].value == 2

    def raises(a):
        calls.append(1)
        raise ValueError("the program's own fault")

    monkeypatch.undo()
    assert tprofile.capture("test/raises", raises, 1) is None
    assert len(calls) == 3 and reg["profile/capture_errors"].value == 3


def test_instrument_counts_the_first_call_and_returns_its_output():
    calls = []
    lin = torch.nn.Linear(16, 16)

    def fn(x, scale=1.0):
        calls.append(1)
        return lin(x) * scale

    x = torch.randn(4, 16)
    want = fn(x, scale=2.0)
    w = tprofile.instrument("train/demo", fn, coll_bytes=64.0)
    got = w(x, scale=2.0)
    assert len(calls) == 2 and torch.equal(got, want)
    prof = tprofile.get("train/demo")
    assert prof.captured and prof.flops == 2 * 4 * 16 * 16
    assert prof.coll_bytes == 64.0 and prof.compile_time_s > 0
    assert torch.equal(w(x, scale=2.0), want) and len(calls) == 3
    assert prof.flops == 2 * 4 * 16 * 16          # later calls: not counted


def _lm(**over):
    cfg = get_smoke_config("llama3.2-1b").with_overrides(
        dtype="float32", vocab_size=VOCAB, **over)
    return cfg, build_model(cfg, "cpu")


def _batches(n, size=2):
    src = tsyn.LMTokenSource(VOCAB, SEQ)
    return [{k: torch.from_numpy(v) for k, v in src.batch(size, i).items()}
            for i in range(n)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke shapes gain nothing from intra-op threads, and the suite's
    workers share the host's cores: one thread a worker for this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_engine(plan, steps=2, arch="llama3.2-1b", **over):
    if arch == "llama3.2-1b" and not over:
        cfg, model = _lm()
        batches = _batches(steps)
    else:
        cfg = get_smoke_config(arch).with_overrides(dtype="float32", **over)
        model = build_model(cfg, "cpu")
        batches = [{n: torch.from_numpy(v) for n, v in
                    tlaunch.synthetic_batch(cfg, 2, i, SEQ).items()}
                   for i in range(steps)]
    eng = build_engine(plan, model, sgd_momentum(), constant(0.01))
    state = eng.init_state(torch.Generator().manual_seed(0))
    out = []
    for i, b in enumerate(batches):
        state, m = eng.step(state, b, step_idx=i)
        out.append(m)
    return state, out


def _dropping_moe(arch):
    """``arch``'s smoke MoE at a capacity factor of 0.25: most (token,
    expert) choices of a 2 x 32-token batch are dropped, so the gather
    back reads the clamped drop row many times."""
    from repro_torch.models.moe import capacity
    m = dataclasses.replace(get_smoke_config(arch).moe, capacity_factor=0.25)
    assert capacity(2 * SEQ, m) * m.num_experts < 2 * SEQ * m.top_k
    return {"moe": m}


BSP, ASA16_SHARDED, GSPMD = (TrainPlan(), TrainPlan(
    exchanger="asa16", sharded_update=True), TrainPlan(algo="gspmd"))
# (arch, plan, config overrides): every family's smoke config under the
# BSP step, and under gspmd, the MoE ones dropping tokens
FAMILY_CASES = {
    "asa": ("llama3.2-1b", BSP, None),
    "asa16_sharded": ("llama3.2-1b", ASA16_SHARDED, None),
    "gspmd-llama3.2-1b": ("llama3.2-1b", GSPMD, None),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", BSP, _dropping_moe),
    "gspmd-deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", GSPMD,
                                   _dropping_moe),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", BSP, _dropping_moe),
    "mamba2-1.3b": ("mamba2-1.3b", BSP, None),
    "gspmd-mamba2-1.3b": ("mamba2-1.3b", GSPMD, None),
    "hymba-1.5b": ("hymba-1.5b", BSP, None),
    "chameleon-34b": ("chameleon-34b", BSP, None),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", BSP, None),
    "alexnet": ("alexnet", BSP, None),
    "gspmd-alexnet": ("alexnet", GSPMD, None),
}


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_counted_train_step_leaves_the_state_bitwise(case):
    arch, plan, over = FAMILY_CASES[case]
    over = over(arch) if over else {}
    counted, m1 = _run_engine(plan, arch=arch, **over)
    assert tprofile.get("train/step").captured
    assert tprofile.get("train/step").flops > 0
    ttel.configure(profile=False)
    plain, m2 = _run_engine(plan, arch=arch, **over)
    for a, b in zip(leaves(counted), leaves(plain)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert [float(m["loss"]) for m in m1] == [float(m["loss"]) for m in m2]


def test_profile_knob_turns_profiling_off():
    ttel.configure(profile=False)
    assert not tprofile.enabled()
    assert tprofile.capture("test/off", lambda a: a + 1, torch.ones(4)) is None
    tprofile.observe("test/off", 1.0)
    w = tprofile.instrument("test/off2", lambda a: a + 1)
    assert torch.equal(w(torch.ones(2)), torch.full((2,), 2.0))
    assert tprofile.get("test/off") is None and tprofile.get("test/off2") is None


# ---------------------------------------------------------------------------
# train and serve integration (the reference's two tests, on the port)
# ---------------------------------------------------------------------------

def _train(n=4, plan=TrainPlan(), log_every=2, **over):
    _, model = _lm(**over)
    return train(model, sgd_momentum(), constant(0.01), _batches(n),
                 plan=plan, num_steps=n, log_every=log_every,
                 print_fn=lambda *a: None)


def test_train_loop_emits_program_and_compile_gauges():
    n = 4
    _train(n)
    tprofile.emit()
    reg = ttel.default_registry()
    assert reg["profile/train_step/flops"].value > 0
    assert reg["profile/train_step/hbm_bytes"].value > 0
    assert reg["profile/train_step/calls"].value == n - 1
    assert reg["profile/train_step/mean_time_s"].value > 0
    assert reg["profile/train_step/mfu"].value > 0
    assert reg["compile/train_step_s"].value > 0
    assert tprofile.get("exchange/rs") is not None
    assert tprofile.get("exchange/rs").captured
    assert reg["profile/exchange_rs/hbm_bytes"].value > 0
    assert reg["profile/exchange_rs/mfu"].value >= 0
    assert reg["compile/exchange_rs_s"].value > 0
    assert tprofile.get("exchange/ag").captured


def test_serve_engine_emits_decode_attribution():
    from repro_torch.serve import Engine
    cfg = get_smoke_config("llama3.2-1b")
    model = build_model(cfg, "cpu")
    eng = Engine(model, model.init(0), max_slots=2, max_seq=64,
                 prefill_chunk=8, device="cpu")
    rng = np.random.RandomState(0)
    for n, new in zip((5, 12, 9, 17), (6, 3, 9, 5)):
        eng.submit(rng.randint(0, cfg.vocab_size, size=n).tolist(), new)
    eng.run()
    tprofile.emit()
    reg = ttel.default_registry()
    assert tprofile.get("serve/decode_step").captured
    assert reg["profile/serve_decode_step/flops"].value > 0
    assert reg["profile/serve_decode_step/mfu"].value > 0
    assert reg["compile/serve_decode_step_s"].value > 0
    assert tprofile.get("serve/prefill_chunk").captured
    assert reg["compile/serve_prefill_chunk_s"].value > 0
    assert eng.trace_counts["decode"] == 1
    assert eng.trace_counts["prefill"] == 1


def test_train_mfu_only_with_peak_flops(monkeypatch):
    monkeypatch.delenv("REPRO_PEAK_FLOPS", raising=False)
    _, rep = _train(2, log_every=1)
    reg = rep.metrics
    assert reg["train/model_flops_s"].value > 0 and "train/mfu" not in reg
    assert "train/device_mem_bytes" not in reg           # the CPU
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "1e12")
    _, rep = _train(2, log_every=1)
    reg = rep.metrics
    assert reg["train/mfu"].value == pytest.approx(
        reg["train/model_flops_s"].value / 1e12)


# ---------------------------------------------------------------------------
# grad_norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["subgd", "awagd"])
def test_grad_norm_matches_jax(scheme):
    from repro.configs import get_smoke_config as jget
    from repro.core import bsp as jbsp
    from repro.core import exchanger as jex
    from repro.models import build_model as jbuild
    from repro.optim import optimizers as jopt
    from repro.optim import schedule as jsched
    from repro_torch.bridge import decoder_params_from_jax
    from repro_torch.core import bsp as tbsp
    from repro_torch.core import exchanger as tex

    jc = jget("llama3.2-1b").with_overrides(dtype="float32",
                                            vocab_size=VOCAB)
    jm = jbuild(jc)
    jstate = jbsp.init_train_state(jm, jopt.sgd_momentum(),
                                   jax.random.key(0))
    b = tsyn.LMTokenSource(VOCAB, SEQ).batch(4, 0)
    jstep = jax.jit(jbsp.make_bsp_step(
        jm, jopt.sgd_momentum(), jex.get_exchanger("asa"),
        jsched.constant(0.01), jax.sharding.get_abstract_mesh(),
        scheme=scheme, grad_norm=True))
    _, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                   jax.random.key(1))
    _, model = _lm()
    tp = decoder_params_from_jax(jax.tree.map(np.asarray,
                                              jstate["params"]), "cpu")
    step = tbsp.make_bsp_step(model, sgd_momentum(),
                              tex.get_exchanger("asa"), constant(0.01),
                              scheme=scheme, grad_norm=True)
    _, m = step({"params": tp, "opt": sgd_momentum().init(tp), "step": 0},
                {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]),
                                                  rel=1e-5)
    assert "grad_sq" not in m


def test_loop_writes_grad_norm_when_the_knob_is_on():
    ttel.configure(grad_norm=True)
    try:
        _, rep = _train(2, log_every=1)
    finally:
        ttel.configure(grad_norm=False)
    assert rep.metrics["train/grad_norm"].value > 0
    _, rep = _train(2, log_every=1)
    assert "train/grad_norm" not in rep.metrics


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_no_profile_writes_no_profile_gauge(tmp_path):
    """One rank through the launcher with ``--no-profile`` and
    ``--attn-impl auto`` (the einsum route on the CPU); with profiling on
    the loop writes ``profile/*`` (the loop test above)."""
    from repro_torch.launch import train as tlaunch
    out = tmp_path / "m.jsonl"
    tlaunch.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                  "--ranks", "1", "--batch", "2", "--seq", "16", "--steps",
                  "2", "--metrics-out", str(out), "--no-profile",
                  "--attn-impl", "auto"])
    names = {json.loads(line).get("name")
             for line in out.read_text().splitlines()}
    assert "train/loss" in names and "train/model_flops_s" in names
    assert not [n for n in names if n and n.startswith(("profile/",
                                                         "compile/"))]


def test_launcher_attn_impl_picks_the_route(capsys):
    from repro_torch.launch import train as tlaunch
    assert tlaunch.attn_impl("auto", "cpu") == "ref"
    assert tlaunch.attn_impl("auto", "cuda:0") == "flash"
    assert tlaunch.attn_impl(None, "cpu") is None
    base = dict(arch="llama3.2-1b", smoke=True, device="cpu")
    for choice, want in (("auto", "ref"), ("ref", "ref"),
                         ("flash", "flash"), (None, "")):
        cfg = tlaunch.launch_config(dict(base, attn_impl=choice))
        assert cfg.attention.attn_impl == want
    conv = tlaunch.launch_config(dict(base, arch="alexnet", attn_impl="ref"))
    assert conv.attention is None
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                      "--attn-impl", "blockwise"])
    assert "ROADMAP queue 1 item 5" in capsys.readouterr().err


def test_bsp_grad_norm_not_on_sharded_path():
    """The reference's rule: the norm exists only where the full reduced
    gradient does (the unsharded paths)."""
    _, model = _lm()
    from repro_torch.core import bsp as tbsp
    from repro_torch.core import exchanger as tex
    opt = sgd_momentum()
    step = tbsp.make_bsp_step(model, opt, tex.get_exchanger("asa"),
                              constant(0.01), sharded_update=True,
                              grad_norm=True)
    state = tbsp.init_sharded_train_state(model, opt,
                                          torch.Generator().manual_seed(0))
    _, m = step(state, _batches(1)[0])
    assert "grad_norm" not in m and "grad_sq" not in m


def test_half_programs_run_alone_and_count_their_wire():
    from repro_torch.core import exchanger as tex
    _, model = _lm()
    params = model.init(torch.Generator().manual_seed(0))
    ex = tex.get_exchanger("asa16")
    rs, ag, grads, shards, plan = tex.half_programs(ex, params)
    assert [tuple(g.shape) for g in leaves(grads)] == [
        tuple(p.shape) for p in leaves(params)]
    assert all(not g.any() for g in leaves(grads))
    assert [s.shape[0] for s in shards] == [b.shard_len for b in plan.buckets]
    res = rs(grads)
    assert set(res) == {"shards", "full"}
    full = ag(shards)
    assert [f.shape[0] for f in full] == [b.padded for b in plan.buckets]
    with pytest.raises(ValueError, match="no halves"):
        tex.half_programs(tex.get_exchanger("none"), params)


@pytest.mark.parametrize("fail_rank", [-1, 1], ids=["built", "one_rank_fails"])
def test_exchange_halves_run_or_are_skipped_on_every_rank(tmp_path,
                                                          fail_rank):
    """The halves are collectives: when building them fails on one rank
    (out of memory, say), every rank skips them together and training
    goes on; only the failing rank counts a capture error."""
    from test_torch_ranks import halves_worker
    tlaunch.run_ranks(halves_worker, 2, (str(tmp_path), fail_rank))
    ranks = [json.loads((tmp_path / f"halves{r}.json").read_text())
             for r in range(2)]
    built = fail_rank < 0
    for r, rk in enumerate(ranks):
        assert rk["counted"] == {"exchange/rs": built, "exchange/ag": built}
        assert rk["errors"] == (1 if r == fail_rank else 0)
        assert len(rk["losses"]) == 2
    assert ranks[0]["losses"] == ranks[1]["losses"]
