"""The port's serve guardrails on the CPU (counterpart of
``tests/test_serve_slo.py``, at its shapes: 3 slots, ``max_seq`` 64,
prefill chunk 8, page 8, the smoke llama3.2-1b): deadlines and the queue
budget, cancellation, the brownout ladder's hysteresis and clamp, level 1
stopping prefix registration, the stuck-step watchdog on a
``VirtualClock``, drain -> restore bit for bit, the snapshot's crc32,
rids kept for re-queued work, guardrails off (budgets recorded, not
enforced), page accounting under any interleaving, and the fixed-shape
contract: the decode dispatch sees one argument signature under guardrail
churn, and one decode step runs the same aten operations with guardrails
on and off (recorded under a ``TorchDispatchMode``). The brownout ladder
is also driven through the JAX engine's ``_update_brownout`` on the same
occupancy sequence, and must take the same levels and clamps.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.fault.inject import SERVE_KINDS, FaultPlan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import REJECTED_QUEUE_FULL, Engine  # noqa: E402
from repro_torch.serve.chaos import (  # noqa: E402
    VirtualClock, make_cost_model, run_chaos, verify_drain_restore,
    verify_replay)
from repro_torch.serve.engine import BROWNOUT_PATIENCE  # noqa: E402

ARCH = "llama3.2-1b"


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    return cfg, model, model.init(0)


def _engine(**over):
    cfg, model, params = _setup()
    kw = dict(max_slots=3, max_seq=64, prefill_chunk=8, page_size=8,
              device="cpu")
    kw.update(over)
    return Engine(model, params, **kw)


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
    """The JAX engine on one device with no sharding in its types (a file
    run earlier in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


# ---------------------------------------------------------------------------
# rejections, deadlines, cancellation
# ---------------------------------------------------------------------------

def test_rejection_paths_mutate_nothing():
    eng = _engine(max_queue=2, num_pages=10)
    assert eng.submit([1, 2, 3], 4)
    assert eng.submit([4, 5, 6], 4)
    before = eng.allocator.state_digest()
    pend = list(eng.sched.pending)
    r = eng.submit([7, 8, 9], 4)           # queue full
    assert not r and r.status == REJECTED_QUEUE_FULL
    assert eng.allocator.state_digest() == before
    assert list(eng.sched.pending) == pend
    eng.draining = True
    r2 = eng.submit([7, 8], 2)             # draining
    assert not r2 and eng.allocator.state_digest() == before
    eng.draining = False
    assert eng.stats.rejected_queue_full == 2
    eng.run()
    big = _engine(max_slots=2, num_pages=5)        # 4 usable pages
    big.submit([1] * 8, 8)                         # 2 pages
    big.submit([2] * 8, 8)                         # 2 pages
    big.step()
    digest = big.allocator.state_digest()
    assert big.submit([3] * 8, 8).accepted         # queued, cannot admit
    big.step()
    assert big.sched.queue_depth == 1
    tbl, refs, free, held, resv, pfx = big.allocator.state_digest()
    assert (refs, free, held, pfx) == (digest[1], digest[2], digest[3],
                                       digest[5])


def test_never_fits_requests_still_raise():
    with pytest.raises(ValueError, match="cache rows"):
        _engine().submit(list(range(60)), 30)
    with pytest.raises(ValueError, match="pages"):
        _engine(num_pages=4).submit(list(range(30)), 10)


def test_expired_queued_request_is_shed_not_run():
    clock = VirtualClock()
    eng = _engine(clock=clock, cost_model=make_cost_model()[0], max_slots=1)
    a = eng.submit([1, 2, 3], 4)
    b = eng.submit([4, 5, 6], 4, deadline_ms=5.0)
    clock.advance(0.02)
    eng.step()
    assert eng.sched.finish_reasons()[int(b)] == "shed"
    assert eng.sched.results()[int(b)] == []
    eng.run()
    assert eng.sched.finish_reasons()[int(a)] == "stop"
    assert eng.stats.shed == 1 and eng.stats.deadline_misses == 1


def test_queue_budget_max_queue_ms_sheds():
    clock = VirtualClock()
    eng = _engine(clock=clock, cost_model=make_cost_model()[0], max_slots=1)
    eng.submit([1, 2, 3], 8)
    b = eng.submit([4, 5], 4, max_queue_ms=1.0)
    clock.advance(0.01)
    eng.step()
    assert eng.sched.finish_reasons()[int(b)] == "shed"


def test_inflight_past_deadline_cancelled_at_step_boundary():
    clock = VirtualClock()
    eng = _engine(clock=clock, cost_model=make_cost_model()[0])
    r = eng.submit([1, 2, 3, 4], 32, deadline_ms=30.0)
    for _ in range(3):
        eng.step()
    clock.advance(10.0)
    eng.step()
    assert eng.sched.finish_reasons()[int(r)] == "deadline"
    assert 0 < len(eng.sched.results()[int(r)]) < 32
    assert eng.sched.num_active == 0
    eng.allocator.check_consistency()
    assert eng.stats.deadline_misses == 1
    r2 = eng.submit([5, 6], 2)
    eng.run()
    assert eng.sched.finish_reasons()[int(r2)] == "stop"


def test_cold_engine_never_sheds_on_blind_estimate():
    eng = _engine()
    r = eng.submit([1, 2], 2, deadline_ms=60_000.0)
    eng.step()
    assert eng.sched.finish_reasons().get(int(r), "stop") == "stop"


def test_cancel_api_queued_and_inflight():
    eng = _engine(max_slots=1)
    a = eng.submit([1, 2, 3], 16)
    b = eng.submit([4, 5, 6], 4)
    eng.step()
    assert eng.cancel(int(b)) is True
    assert eng.cancel(int(a)) is True
    assert eng.cancel(999) is False
    assert eng.cancel(int(a)) is False
    reasons = eng.sched.finish_reasons()
    assert reasons[int(a)] == "cancel" and reasons[int(b)] == "cancel"
    eng.allocator.check_consistency()
    assert eng.stats.cancelled == 2


# ---------------------------------------------------------------------------
# brownout ladder
# ---------------------------------------------------------------------------

def test_brownout_ladder_hysteresis_and_clamp():
    eng = _engine()
    for _ in range(BROWNOUT_PATIENCE):
        eng._update_brownout(0.90)
    assert eng._brownout_level == 1
    eng._update_brownout(0.40)             # one cool step: still level 1
    assert eng._brownout_level == 1
    for _ in range(2):
        eng._update_brownout(0.40)
    assert eng._brownout_level == 0
    eng.submit([1, 2, 3], 40)
    for _ in range(3):
        eng._update_brownout(0.97)
    assert eng._brownout_level == 2
    assert eng.sched.pending[0].max_new == eng.brownout_max_new
    assert eng.stats.brownout_clamped == 1
    assert eng.stats.brownout_level == 2


OCCUPANCY = (0.9, 0.9, 0.5, 0.9, 0.96, 0.96, 0.96, 0.97, 0.88, 0.7, 0.55,
             0.5, 0.58, 0.99, 0.99, 0.99, 0.2, 0.3, 0.1)


def test_brownout_ladder_equals_the_jax_engine():
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import build_model as j_build
    from repro.serve import Engine as JEngine
    # the ladder is host-side: the JAX engine dispatches nothing here, so
    # it needs no parameters
    je = JEngine(j_build(j_smoke(ARCH)), None, max_slots=3, max_seq=64,
                 prefill_chunk=8, page_size=8)
    te = _engine()
    for eng in (je, te):
        eng.submit([1, 2, 3], 40)
        eng.submit([4, 5], 10)
        eng.submit([6, 7, 8, 9], 30)
    seen = []
    for i, occ in enumerate(OCCUPANCY):
        if i == 9:                         # a late arrival to clamp
            for eng in (je, te):
                eng.submit([3, 3], 50)
        for eng in (je, te):
            eng._update_brownout(occ)
        got = [(e._brownout_level, e._hot, e._cool, e.stats.brownout_clamped,
                [r.max_new for r in e.sched.pending]) for e in (je, te)]
        assert got[0] == got[1], i
        seen.append(got[1][0])
    assert set(seen) == {0, 1, 2}


def test_brownout_level1_disables_prefix_registration():
    eng = _engine()
    eng._brownout_level = 1
    eng.submit([7] * 16, 2)
    eng.run()
    assert len(eng.allocator._entries) == 0
    eng._brownout_level = 0
    eng.submit([7] * 16, 2)
    eng.run()
    assert len(eng.allocator._entries) > 0


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_flags_stalled_step():
    clock = VirtualClock()
    cost, state = make_cost_model()
    eng = _engine(clock=clock, cost_model=cost, watchdog_k=4.0)
    eng.submit([1, 2, 3], 24)
    for _ in range(6):
        eng.step()
    assert eng.stats.watchdog_stalls == 0
    state["stall_factor"] = 50.0           # one wedged dispatch
    eng.step()
    assert eng.stats.watchdog_stalls == 1
    state["stall_factor"] = 1.0
    eng.run()
    assert eng.stats.watchdog_stalls == 1


def test_engine_eviction_accounting_survives_pop():
    eng = _engine()
    eng.submit([1, 2], 2)
    eng.run()
    assert eng.stats.evictions == 1
    eng.sched.pop_finished()
    eng.submit([3, 4], 2)
    eng.run()
    assert eng.stats.evictions == 2


# ---------------------------------------------------------------------------
# page accounting under adversarial interleavings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refcounts_partition_pool_under_interleaving(seed):
    cfg = _setup()[0]
    rng = np.random.RandomState(seed)
    eng = _engine(max_slots=3, num_pages=20)
    shared = rng.randint(0, cfg.vocab_size, 16).tolist()   # 2 full pages
    live = []
    for _ in range(60):
        choice = rng.rand()
        if choice < 0.35:
            tail = rng.randint(0, cfg.vocab_size, rng.randint(1, 6)).tolist()
            prompt = shared + tail if rng.rand() < 0.6 else tail
            r = eng.submit(prompt, int(rng.randint(1, 8)))
            if r:
                live.append(int(r))
        elif choice < 0.5 and live:
            eng.cancel(live.pop(rng.randint(len(live))))
        elif choice < 0.6 and eng.allocator.free:
            eng.allocator.hold_pages(int(rng.randint(1, 3)))
        elif choice < 0.7:
            eng.allocator.release_held()
        else:
            eng.step()
        eng.allocator.check_consistency()
    eng.allocator.release_held()
    eng.run()
    eng.allocator.check_consistency()
    assert eng.trace_counts["decode"] == 1


def test_cancel_releases_pages_exactly_like_finish():
    def run(kill: bool):
        eng = _engine(max_slots=1, prefix_cache=False)
        r = eng.submit([1, 2, 3, 4, 5], 8)
        for _ in range(3):
            eng.step()
        if kill:
            eng.cancel(int(r))
        else:
            eng.run()
        eng.allocator.check_consistency()
        return sorted(eng.allocator.free), eng.allocator.refs.tolist()
    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# drain -> restore
# ---------------------------------------------------------------------------

def test_drain_restore_bit_identical(tmp_path):
    out = verify_drain_restore(_engine, seed=3, n=5, drain_after=2,
                               vocab=_setup()[0].vocab_size,
                               path=str(tmp_path / "serve.snap"))
    assert out["requeued"]


def test_drain_rejects_new_submissions_and_snapshot_crc(tmp_path):
    eng = _engine()
    eng.submit([1, 2, 3], 4)
    eng.submit([4, 5], 3)
    path = str(tmp_path / "s.snap")
    snap = eng.drain(path)
    assert not eng.submit([9, 9], 2)
    assert len(snap["queued"]) == 2 and snap["inflight"] == []
    assert snap["finished"] == []
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    bad = str(tmp_path / "bad.snap")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises((ValueError, KeyError)):
        _engine().load_snapshot(bad)
    ok = _engine()
    ok.load_snapshot(path)
    assert ok.sched.results() == eng.sched.results()
    assert ok.sched._next_rid == eng.sched._next_rid
    with pytest.raises(ValueError, match="fresh engine"):
        ok.load_snapshot(path)


def test_restore_preserves_rids_for_queued_work():
    eng = _engine(max_slots=1)
    a = eng.submit([1, 2, 3], 4)
    b = eng.submit([4, 5, 6], 4)
    eng.step()                             # a in flight, b queued
    snap = eng.drain(max_steps=0)
    eng2 = _engine(max_slots=1)
    assert eng2.load_snapshot(snap) == [int(a), int(b)]
    eng2.run()
    reasons = eng2.sched.finish_reasons()
    assert reasons[int(a)] == "stop" and reasons[int(b)] == "stop"


# ---------------------------------------------------------------------------
# chaos on the port alone
# ---------------------------------------------------------------------------

def test_chaos_refuses_training_kinds():
    assert all(e.kind in SERVE_KINDS for e in FaultPlan.from_spec(
        "qflood:6@3,stall:8@6x4,cancel:1@9,pagepress:12@10x8").events)
    with pytest.raises(ValueError, match="training-side"):
        run_chaos(_engine, FaultPlan.from_spec("kill:0@1"))


def test_chaos_replay_bit_identical():
    plan = FaultPlan.from_spec(
        "qflood:4@2,stall:6@4x3,cancel:0@6,pagepress:8@5x4", seed=11)
    a, b = verify_replay(
        lambda **o: _engine(max_queue=8, shed_policy="reject-no-deadline",
                            **o),
        plan, n_base=5, max_steps=120, vocab=_setup()[0].vocab_size)
    assert a["digest"] == b["digest"] and a["decode_compiles"] == 1
    s = a["stats"]
    assert s["finished_total"] == s["submitted"] - s["rejected_at_submit"]


# ---------------------------------------------------------------------------
# the fixed-shape contract: guardrails change nothing inside a dispatch
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _decode_ops(eng):
    eng.submit([1, 2, 3, 4, 5], 6)
    eng.submit([6, 7], 6)
    eng.step()                             # admit, prefill, first decode
    tokens = torch.zeros((eng.max_slots, 1), dtype=torch.int64)
    pos = torch.tensor(eng.sched.positions(), dtype=torch.int64)
    with _Ops() as rec:
        eng._decode_step(tokens, pos)
    return rec.ops


@pytest.mark.parametrize("fused", [False, True])
def test_decode_ops_identical_guardrails_on_off(fused):
    on = _decode_ops(_engine(max_queue=4, watchdog_k=2.0, guardrails=True,
                             fused_sampling=fused))
    off = _decode_ops(_engine(guardrails=False, fused_sampling=fused))
    assert len(on) > 20 and on == off


def test_decode_compiles_once_under_guardrail_churn():
    clock = VirtualClock()
    eng = _engine(max_queue=4, clock=clock, cost_model=make_cost_model()[0])
    rids = [eng.submit([i + 1, i + 2], 4,
                       deadline_ms=(5.0 if i % 2 else None))
            for i in range(6)]
    eng.step()
    clock.advance(1.0)                     # expire the deadlines
    eng.run()
    eng.cancel(next(int(r) for r in rids if r))
    eng.submit([9, 8, 7], 3)
    eng.run()
    assert eng.trace_counts["decode"] == 1
    assert eng.trace_counts["prefill"] == 1
    assert eng.trace_counts["sample"] == 1


def test_trace_counts_see_a_new_signature():
    """The count is of signatures, so a dispatch with another shape
    shows."""
    eng = _engine()
    eng.submit([1, 2, 3], 2)
    eng.run()
    eng._seen("decode", torch.zeros(eng.max_slots + 1, 1))
    assert eng.trace_counts["decode"] == 2


def test_guardrails_off_records_budgets_without_enforcing():
    clock = VirtualClock()
    eng = _engine(guardrails=False, clock=clock,
                  cost_model=make_cost_model()[0])
    r = eng.submit([1, 2, 3], 6, deadline_ms=1.0)
    clock.advance(1.0)
    eng.run()
    assert eng.sched.finish_reasons()[int(r)] == "stop"   # ran anyway
    assert eng.stats.deadline_misses == 1                 # ...and measured
    assert eng.stats.goodput_tokens == 0


def test_reset_stats_keeps_trace_counts():
    eng = _engine()
    eng.submit([1, 2, 3], 3)
    eng.run()
    counts = eng.trace_counts
    eng.reset_stats()
    assert eng.stats.steps == 0 and eng.trace_counts == counts


# ---------------------------------------------------------------------------
# the launcher's guardrail flags
# ---------------------------------------------------------------------------

def test_launcher_resumes_a_drain_snapshot(tmp_path, capsys):
    from repro_torch.launch import serve as launch
    eng = _engine(max_slots=1)
    eng.submit([1, 2, 3], 4)
    eng.submit([4, 5, 6], 4)
    eng.step()
    path = str(tmp_path / "serve.snap")
    eng.drain(path, max_steps=0)
    launch.main(["--arch", ARCH, "--device", "cpu", "--num-requests", "2",
                 "--max-queue", "8", "--deadline-ms", "60000",
                 "--drain-on-sigterm", path])
    out = capsys.readouterr().out
    assert f"resumed 2 queued requests from {path}" in out
    assert "served 2 requests" in out and "0 shed" in out


def test_launcher_hands_a_fault_plan_to_chaos(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", ARCH, "--device", "cpu", "--num-requests", "5",
                 "--max-slots", "3", "--page-size", "8", "--max-queue", "8",
                 "--shed-policy", "reject-no-deadline", "--seed", "11",
                 "--fault-plan",
                 "qflood:4@2,stall:6@4x3,cancel:0@6,pagepress:8@5x4"])
    out = capsys.readouterr().out
    assert "replay: bit-identical" in out and "decode compiled 1x" in out


def test_engine_is_freed_without_the_cycle_collector():
    """An engine holds its pool and parameters on the card: dropping the
    last reference must free it at once, not at the next cyclic GC."""
    import gc
    import weakref
    eng = _engine()
    eng.submit([1, 2, 3], 3)
    eng.run()
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()
