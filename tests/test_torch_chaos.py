"""The serve chaos harness, port against the JAX package on the CPU.

``repro_torch.serve.chaos.run_chaos`` on the port's ``Engine`` and
``repro.serve.chaos.run_chaos`` on the JAX engine, over the same bridged
fp32 smoke parameters (``bridge.decoder_params_from_jax``), must return
equal result dicts, digest included: outputs, finish reasons, guardrail
counters and the per-step log (virtual clock, occupancy, brownout level).
The plans: the reference CLI's default at seed 0 and the reference SLO
test's at seed 11, each at its own engine shape, and one under heavy page
pressure that walks the brownout ladder to level 2 and clamps. A snapshot drained by
one package's engine and loaded into the other's must finish to the JAX
oracle's greedy tokens. The copied pure functions (``VirtualClock``,
``make_cost_model``, ``base_workload``, ``_flood_request``) are pinned to
their originals. Everything here is exact.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.fault.inject import FaultPlan as JPlan  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.fault.inject import FaultPlan as TPlan  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import chaos as tchaos  # noqa: E402

ARCH = "llama3.2-1b"
CLI_PLAN = "qflood:6@3,stall:8@6x4,cancel:1@9,pagepress:12@10x8"

# (plan, seed, engine shape, run_chaos arguments)
PLANS = {
    "cli": (CLI_PLAN, 0, dict(max_slots=4, max_queue=16),
            dict(n_base=8, max_steps=300)),
    "slo": ("qflood:4@2,stall:6@4x3,cancel:0@6,pagepress:8@5x4", 11,
            dict(max_slots=3, max_queue=8), dict(n_base=5, max_steps=120)),
    # every free page held from step 0: the queue waits at level 2
    "brownout": ("pagepress:32@0x6,qflood:6@1,stall:6@9x2,cancel:1@10", 5,
                 dict(max_slots=4, max_queue=16),
                 dict(n_base=8, max_steps=200)),
}


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
    """Run the JAX side on one device with no sharding in its types (a
    file run earlier in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


@functools.lru_cache(maxsize=None)
def _models():
    cfg = j_smoke(ARCH).with_overrides(dtype="float32", remat=False)
    jm = j_build(cfg)
    jp = jm.init(jax.random.key(0))
    tm = t_build(t_smoke(ARCH).with_overrides(dtype="float32", remat=False),
                 "cpu")
    tp = decoder_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg.vocab_size, (jm, jp), (tm, tp)


def _factory(side: str, **shape):
    _, (jm, jp), (tm, tp) = _models()
    kw = dict(max_seq=64, prefill_chunk=8, page_size=8,
              shed_policy="reject-no-deadline")
    kw.update(shape)
    if side == "jax":
        return lambda **over: JEngine(jm, jp, **kw, **over)
    return lambda **over: TEngine(tm, tp, device="cpu", **kw, **over)


@functools.lru_cache(maxsize=None)
def _jax_chaos(name):
    spec, seed, shape, run_kw = PLANS[name]
    return jchaos.run_chaos(_factory("jax", **shape),
                            JPlan.from_spec(spec, seed=seed),
                            vocab=_models()[0], max_seq=64, **run_kw)


@pytest.mark.parametrize("name", list(PLANS))
def test_run_chaos_equals_the_jax_engine(name):
    spec, seed, shape, run_kw = PLANS[name]
    want = _jax_chaos(name)
    got = tchaos.run_chaos(_factory("torch", **shape),
                           TPlan.from_spec(spec, seed=seed),
                           vocab=_models()[0], max_seq=64, **run_kw)
    for key in ("results", "reasons", "stats", "log"):
        assert got[key] == want[key], key
    assert got == want
    assert got["decode_compiles"] == 1
    s = got["stats"]
    assert s["finished_total"] == s["submitted"] - s["rejected_at_submit"]


def test_plans_reach_every_guardrail():
    """Between them the plans shed, cancel, miss deadlines, trip the
    watchdog and walk the brownout ladder to level 2 and clamp."""
    res = {n: _jax_chaos(n) for n in PLANS}
    cli = res["cli"]["stats"]
    # the reference CLI's printed counts
    assert (cli["submitted"], cli["shed"], cli["cancelled"],
            cli["deadline_misses"], cli["goodput_tokens"],
            cli["decoded_tokens"], cli["steps"], cli["watchdog_stalls"]) \
        == (14, 3, 1, 6, 38, 48, 18, 1)
    levels = [e["brownout"] for e in res["brownout"]["log"]]
    assert max(levels) == 2 and levels[-1] < 2
    assert res["brownout"]["stats"]["brownout_clamped"] > 0


@functools.lru_cache(maxsize=None)
def _oracle_and_workload():
    reqs = tchaos.base_workload(4, 6, _models()[0])
    assert reqs == jchaos.base_workload(4, 6, _models()[0])
    eng = _factory("jax", max_slots=2)()
    for r in reqs:
        eng.submit(r["tokens"], r["max_new"])
    return reqs, {int(r): list(t) for r, t in eng.run().items()}


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_drain_restore_across_packages(tmp_path, src, dst):
    """A snapshot drained by ``src``'s engine (in-flight and queued work)
    finishes in ``dst``'s to the JAX oracle's greedy tokens."""
    reqs, want = _oracle_and_workload()
    eng = _factory(src, max_slots=2)()
    for r in reqs:
        eng.submit(r["tokens"], r["max_new"])
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "serve.snap")
    snap = eng.drain(path, max_steps=1)
    assert snap["inflight"] and snap["queued"]
    eng2 = _factory(dst, max_slots=2)()
    requeued = eng2.load_snapshot(path)
    assert requeued == [e["rid"] for e in snap["inflight"] + snap["queued"]]
    eng2.run()
    got = {int(r): list(t) for r, t in eng2.sched.results().items()}
    assert got == want


# ---------------------------------------------------------------------------
# the copied pure functions
# ---------------------------------------------------------------------------

def test_virtual_clock_copy():
    for mod in (jchaos, tchaos):
        c = mod.VirtualClock()
        c.advance(0.25)
        c.advance(0.0008)
        with pytest.raises(ValueError):
            c.advance(-1e-9)
        assert c() == 0.25 + 0.0008
    assert tchaos.VirtualClock(3)() == jchaos.VirtualClock(3)() == 3.0


@pytest.mark.parametrize("factor", [1.0, 2.0, 8.0])
def test_cost_model_copy(factor):
    (tc, ts), (jc, js) = tchaos.make_cost_model(), jchaos.make_cost_model()
    ts["stall_factor"] = js["stall_factor"] = factor
    for kind in ("decode", "prefill_chunk", "other"):
        for n in (0, 1, 3, 8):
            assert tc(kind, n) == jc(kind, n)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_workload_copies(seed):
    for vocab, max_seq in ((251, 64), (128_256, 12)):
        assert tchaos.base_workload(seed, 9, vocab, max_seq=max_seq) \
            == jchaos.base_workload(seed, 9, vocab, max_seq=max_seq)
        rt = np.random.default_rng([seed, 3])
        rj = np.random.default_rng([seed, 3])
        for _ in range(20):
            assert tchaos._flood_request(rt, vocab, max_seq=max_seq) \
                == jchaos._flood_request(rj, vocab, max_seq=max_seq)
    plan = "qflood:5@1,qflood:3@4"
    tp, jp = TPlan.from_spec(plan, seed=seed), JPlan.from_spec(plan, seed=seed)
    for te, je in zip(tp.events, jp.events):
        assert tp.event_rng(te).integers(0, 1 << 30, 8).tolist() \
            == jp.event_rng(je).integers(0, 1 << 30, 8).tolist()


def test_digest_copy():
    res = _jax_chaos("slo")
    assert tchaos.digest(res) == jchaos.digest(res) == res["digest"]
