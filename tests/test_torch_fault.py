"""The fault package's host copies pinned to their originals, and the
elastic checkpoints' membership meta and one-step agreement.

``repro_torch.fault.inject`` and ``repro_torch.fault.membership`` are
copies of the JAX package's modules. Each scripted sequence of
``tests/test_fault.py`` (the spec grammar, seeded plans, per-event
generators, bit flips and checksums, and the membership controller's
quorum, staleness, weights, straggles, kills, joins and slots) runs
against both packages and the two logs must be equal, errors included.
Everything here is exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.fault import inject as jinject  # noqa: E402
from repro.fault import membership as jmember  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.fault import elastic as telastic  # noqa: E402
from repro_torch.fault import inject as tinject  # noqa: E402
from repro_torch.fault import membership as tmember  # noqa: E402


def _try(fn):
    """fn()'s value, or the type and message of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error is the output
        return ("raised", type(e).__name__, str(e))


def _events(plan):
    return [(e.kind, e.worker, e.step, e.rounds, e.factor)
            for e in plan.events]


# ---------------------------------------------------------------------------
# FaultPlan, bit flips, checksums
# ---------------------------------------------------------------------------

SPECS = ["kill:1@9,straggle:2@5x3,corrupt:0@13",
         "kill:3@9,straggle:2@13x2,corrupt:1@21,drop:0@29,join:3@33",
         "slow:1@5x2,drop:0@2,join:4@0",
         "qflood:8@3,stall:4@5x2,cancel:1@9,pagepress:6@2x4",
         "kill:1", "kill:one@2", "explode:0@1", "straggle:0@1x0",
         "slow:0@1", "", " kill:0@1 , ,join:1@2 "]


def _drive_spec(mod, spec):
    plan = _try(lambda: mod.FaultPlan.from_spec(spec, seed=7))
    if plan[0] != "ok":
        return plan
    p = plan[1]
    return [_events(p), p.to_spec(), len(p),
            _events(mod.FaultPlan.from_spec(p.to_spec(), seed=7)),
            [[(e.kind, e.worker) for e in p.events_at(s)]
             for s in range(40)]]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_same_plans_and_errors(spec):
    assert _drive_spec(tinject, spec) == _drive_spec(jinject, spec)


def _drive_events(mod):
    out = []
    for args in (("explode", 0, 1), ("kill", -1, 1), ("straggle", 0, 1, 0),
                 ("slow", 0, 1, 1, 1.0), ("slow", 2, 3, 2, 4.0)):
        ev = _try(lambda: mod.FaultEvent(*args))
        out.append(ev if ev[0] != "ok" else ev[1].to_spec())
    return out


def test_fault_event_validation_same():
    assert _drive_events(tinject) == _drive_events(jinject)


@pytest.mark.parametrize("seed", [0, 3, 4, 11])
def test_random_plans_same(seed):
    kw = dict(num_workers=4, num_steps=50)
    assert _events(tinject.FaultPlan.random(seed, **kw)) == _events(
        jinject.FaultPlan.random(seed, **kw))
    heavy = dict(num_workers=2, num_steps=50, n_events=20, kinds=("kill",))
    assert _events(tinject.FaultPlan.random(seed, **heavy)) == _events(
        jinject.FaultPlan.random(seed, **heavy))


def _drive_flips(mod):
    plan = mod.FaultPlan.from_spec("corrupt:0@3,corrupt:1@7,drop:2@9",
                                   seed=11)
    rng = np.random.default_rng(5)
    arrays = [np.arange(16, dtype=np.float32),
              rng.standard_normal((7, 5)).astype(np.float32),
              np.arange(8, dtype=np.float16),
              rng.integers(0, 255, (33,), dtype=np.uint8),
              np.zeros((0,), np.float32)]
    out = []
    for ev in plan.events:
        out.append(plan.event_rng(ev).integers(0, 1 << 30, 4).tolist())
        for a in arrays:
            f = mod.bitflip(a, plan.event_rng(ev))
            out.append((f.dtype.str, f.shape, f.tobytes(),
                        mod.payload_checksum(f), mod.payload_checksum(a)))
    out.append(mod.payload_checksum(arrays))
    out.append(mod.payload_checksum(tuple(arrays[:2])))
    return out


def test_bitflip_and_checksum_same():
    assert _drive_flips(tinject) == _drive_flips(jinject)


# ---------------------------------------------------------------------------
# MembershipController: the scripted sequences of tests/test_fault.py
# ---------------------------------------------------------------------------

def _snapshot(c, ids=range(10)):
    return (c.workers, c.k, c.quorum_count, c.rounds, c.rejected_joins,
            c.observed_straggles, c.max_staleness(), c.mean_staleness(),
            [(w, c.state_of(w), c.staleness_of(w)) for w in ids])


def _quorum(mod):
    M = mod.MembershipController
    c = M(range(4), alpha=0.5, quorum=3)
    return [c.quorum_count, c.has_quorum([0, 1, 2]), c.has_quorum([0, 1]),
            M(range(4), alpha=0.5).quorum_count,
            M(range(5), alpha=0.5).quorum_count,
            M([7], alpha=0.5).quorum_count]


def _staleness(mod):
    c = mod.MembershipController(range(4), alpha=0.5, quorum=2)
    out = []
    c.commit_round([0, 2, 3])
    out.append(_snapshot(c))
    for _ in range(3):
        c.commit_round([0, 1, 2])
        out.append(_snapshot(c))
    absorb, attract = c.round_weights([0, 1, 3])
    out += [absorb.tobytes(), attract.tobytes(), absorb.dtype.str]
    return out


def _skip(mod):
    c = mod.MembershipController(range(3), alpha=0.5, quorum=3)
    c.skip_round()
    c.skip_round()
    return [_snapshot(c), c.round_weights([0, 1, 2])[0].tobytes()]


def _straggle(mod):
    c = mod.MembershipController(range(3), alpha=0.5, quorum=1)
    out = [c.straggle(1, rounds=2), c.reporting(), _snapshot(c)]
    for _ in range(3):
        c.commit_round(c.reporting())
        out += [c.reporting(), _snapshot(c)]
    out += [c.straggle(99), c.mark_straggling(2, 1), c.mark_straggling(99),
            _snapshot(c)]
    return out


def _kill_join(mod):
    c = mod.MembershipController(range(3), alpha=0.5, num_slots=4)
    out = [c.kill(1), c.kill(1), c.state_of(1), c.reporting(),
           c.request_join(5), c.request_join(5), c.state_of(5), c.workers]
    out.append(c.apply_pending())
    out += [_snapshot(c), c.slot_of(5)]
    # a second join takes the lowest free slot; a third finds none
    out += [c.request_join(7), c.request_join(8), c.kill(0)]
    out.append(c.apply_pending())
    out += [_snapshot(c), [c.slot_of(w) for w in c.workers]]
    return out


def _rejected(mod):
    c = mod.MembershipController(range(2), alpha=0.5, num_slots=2)
    return [c.request_join(9), c.apply_pending(), c.rejected_joins]


def _empty(mod):
    c = mod.MembershipController([0], alpha=0.5)
    c.kill(0)
    return _try(c.apply_pending)


def _validation(mod):
    M = mod.MembershipController
    return [_try(lambda: M([1, 1], alpha=0.5)), _try(lambda: M([], alpha=.5)),
            _try(lambda: M([0], alpha=0.5, quorum=0)),
            _try(lambda: M(range(3), alpha=0.5, num_slots=2))]


def _chaos_fleet(mod):
    """The smoke's chaos schedule through the controller alone, as the
    elastic loop drives it (round weights at every boundary)."""
    inj = jinject if mod is jmember else tinject
    plan = inj.FaultPlan.from_spec(
        "kill:3@9,straggle:2@13x2,corrupt:1@21,drop:0@29,join:3@33")
    c = mod.MembershipController(range(4), alpha=0.5, quorum=2, num_slots=4)
    out, excluded = [], set()
    for i in range(40):
        for ev in plan.events_at(i):
            if ev.kind == "kill":
                out.append(c.kill(ev.worker))
            elif ev.kind == "join":
                out.append(c.request_join(ev.worker))
            elif ev.kind == "straggle":
                out.append(c.straggle(ev.worker, ev.rounds))
            else:
                excluded.add(ev.worker)
        if (i + 1) % 4 == 0:
            rep = c.reporting(exclude=excluded)
            excluded.clear()
            if c.has_quorum(rep):
                out.append((i, rep, c.round_weights(rep)[0].tolist()))
                c.commit_round(rep)
            else:
                c.skip_round()
            out += [c.apply_pending(), _snapshot(c)]
    return out


SEQUENCES = {"quorum": _quorum, "staleness": _staleness, "skip": _skip,
             "straggle": _straggle, "kill_join": _kill_join,
             "rejected": _rejected, "empty": _empty,
             "validation": _validation, "chaos_fleet": _chaos_fleet}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_membership_copy_same_sequence(name):
    drive = SEQUENCES[name]
    assert drive(tmember) == drive(jmember)


# ---------------------------------------------------------------------------
# checkpoints: the membership meta, one step for every worker
# ---------------------------------------------------------------------------

def _state(v):
    return {"params": {"w": torch.full((3, 2), float(v))},
            "opt": {"w": torch.zeros(3, 2)},
            "center": {"w": torch.full((3, 2), -float(v))}, "step": int(v)}


def test_checkpoint_records_the_membership(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), _state(8), step=8, algo="easgd",
                          workers=(2, 0, 1))
    meta = tckpt.load_meta(str(tmp_path))
    assert meta["workers"] == [2, 0, 1] and meta["algo"] == "easgd"
    # the JAX package reads the same meta from the port's files
    assert jckpt.load_meta(str(tmp_path))["workers"] == [2, 0, 1]
    # without workers the meta has none, as the reference's
    tckpt.save_checkpoint(str(tmp_path / "b"), _state(8), step=8)
    assert "workers" not in tckpt.load_meta(str(tmp_path / "b"))
    assert tckpt.valid_steps(str(tmp_path)) == [8]
    assert tckpt.load_meta(str(tmp_path), step=8)["step"] == 8
    with pytest.raises(FileNotFoundError, match="step 9"):
        tckpt.load_meta(str(tmp_path), step=9)


def _save_fleet(root, steps, workers=(0, 1, 2)):
    for s in steps:
        for w in workers:
            tckpt.save_checkpoint(telastic.worker_dir(str(root), w),
                                  _state(s), step=s, algo="easgd",
                                  workers=workers)


def test_resume_point_agrees_on_one_step_after_a_torn_save(tmp_path):
    _save_fleet(tmp_path, (8, 16))
    assert telastic.resume_point(str(tmp_path)) == (16, [0, 1, 2])
    # worker 1's newest save is torn: its own directory falls back to 8,
    # the others' would resume from 16 — every slot takes 8
    torn = tmp_path / "worker1" / "state-00000016.npz"
    torn.write_bytes(torn.read_bytes()[:40])
    with pytest.warns(RuntimeWarning, match="falling back"):
        per_dir = [tckpt.load_meta(telastic.worker_dir(str(tmp_path), w))[
            "step"] for w in (0, 1, 2)]
    assert per_dir == [16, 8, 16]
    assert telastic.resume_point(str(tmp_path)) == (8, [0, 1, 2])
    state, step = tckpt.restore_for_resume(
        telastic.worker_dir(str(tmp_path), 0), _state(0),
        expect_algo="easgd", step=8)
    assert step == 8 and torch.equal(state["params"]["w"],
                                     torch.full((3, 2), 8.0))


def test_resume_point_follows_the_recorded_membership(tmp_path):
    # step 8 by workers (0, 1, 2); step 16 by (0, 2, 3) after a kill and a
    # join: a stale directory of a worker no longer in the fleet does not
    # hold the resume back, a missing one of a recorded worker does
    _save_fleet(tmp_path, (8,))
    _save_fleet(tmp_path, (16,), workers=(0, 2, 3))
    assert telastic.resume_point(str(tmp_path)) == (16, [0, 2, 3])
    for name in ("state-00000016.npz", "meta-00000016.json", "meta.json"):
        (tmp_path / "worker3" / name).unlink()
    assert telastic.resume_point(str(tmp_path)) == (8, [0, 1, 2])
    for w in (0, 1, 2):
        (tmp_path / f"worker{w}" / "state-00000008.npz").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="every recorded worker"):
        telastic.resume_point(str(tmp_path))


def test_row_slice_takes_the_rows_share():
    full = {"tokens": np.arange(24).reshape(12, 2)}
    fn = telastic.row_slice(lambda step, k: full)
    assert [fn(0, 3, r)["tokens"][:, 0].tolist() for r in range(3)] == [
        [0, 2, 4, 6], [8, 10, 12, 14], [16, 18, 20, 22]]
