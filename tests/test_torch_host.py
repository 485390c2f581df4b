"""Host copies pinned to their originals: configs, the page allocator,
the slot scheduler, the metrics registry and the span trace. The port
keeps its own copies of these pure-Python modules (it may not import
``repro``); the same sequence of operations must leave the same state on
both sides. Everything here is exact.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jreg  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro.telemetry import registry as jmetrics  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.telemetry import registry as tmetrics  # noqa: E402


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_lists_the_same_archs():
    assert treg.list_archs() == jreg.list_archs()
    assert treg.ASSIGNED_ARCHS == jreg.ASSIGNED_ARCHS
    assert {n: dataclasses.asdict(s) for n, s in treg.INPUT_SHAPES.items()} \
        == {n: dataclasses.asdict(s) for n, s in jreg.INPUT_SHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_config_copy_equals_original(arch, smoke):
    get_t = treg.get_smoke_config if smoke else treg.get_config
    get_j = jreg.get_smoke_config if smoke else jreg.get_config
    t, j = get_t(arch), get_j(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


# ---------------------------------------------------------------------------
# page allocator + scheduler
# ---------------------------------------------------------------------------

def _drive_allocator(mod):
    """Admissions, first-touch allocation, prefix publication, hits, COW,
    release, LRU eviction and page holding, in one fixed sequence."""
    al = mod.PageAllocator(num_pages=10, page_size=4, max_slots=3,
                           pages_per_slot=4)
    toks = list(range(9))
    log = [al.try_admit(0, toks, 3)]
    for pos in range(0, 12):
        log.append(al.ensure_writable(0, pos))
    al.register_prefix(0, toks)
    log.append(al.try_admit(1, toks[:8], 2))        # full 2-page hit
    log.append(al.ensure_writable(1, 7))            # COW of the shared page
    log.append(al.try_admit(2, [7, 7, 7, 7, 1], 3))
    log.append(al.ensure_writable(2, 0))
    al.release_slot(0)
    al.release_slot(1)
    log.append(al.hold_pages(2))
    log.append(al.try_admit(0, list(range(20, 29)), 4))
    for pos in range(0, 13):
        log.append(al.ensure_writable(0, pos))
    log.append(al.release_held())
    al.check_consistency()
    log += [al.hits, al.lookups, al.hit_tokens, al.cow_copies, al.evictions,
            al.available(), al.occupancy()]
    return al, log


def test_page_allocator_copy_same_state():
    ja, jlog = _drive_allocator(jcache)
    ta, tlog = _drive_allocator(tcache)
    assert tlog == jlog
    assert ta.state_digest() == ja.state_digest()
    np.testing.assert_array_equal(ta.tables, ja.tables)
    assert tcache.hash_prefix_chunk(b"x", [1, 2, 3]) == \
        jcache.hash_prefix_chunk(b"x", [1, 2, 3])


def _drive_scheduler(smod, cmod):
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    al = cmod.PageAllocator(num_pages=9, page_size=4, max_slots=2,
                            pages_per_slot=4)
    s = smod.SlotScheduler(2, 16, allocator=al, max_queue=3,
                           shed_policy="reject-no-deadline", clock=clock)
    SP, RQ = smod.SamplingParams, smod.Request
    out = [s.submit(RQ(tokens=[1, 2, 3, 4, 5], max_new=3)).rid,
           s.submit(RQ(tokens=[1, 2, 3, 4, 9], max_new=2, deadline_ms=9e3)).rid,
           s.submit(RQ(tokens=[6, 7], max_new=4, sampling=SP(0.5, seed=3))).rid,
           s.submit(RQ(tokens=[8], max_new=2)).rid]     # displaces rid 2
    placed = s.admit()
    out.append([(slot, r.rid) for slot, r in placed])
    for slot, _ in placed:
        s.record_first_token(slot, 11 + slot)
    out += [s.positions(), s.feed_tokens()]
    out.append(s.record_step([21, 22]))
    out.append(s.cancel_past_deadline(5.0))
    out.append(s.cancel(3))
    while s.has_work():
        placed = s.admit()
        for slot, _ in placed:
            s.record_first_token(slot, 30 + slot)
        out.append(s.record_step([40, 41]))
    out += [s.results(), s.finish_reasons(), s.finished_total,
            list(s.finish_log)]
    return al, out


def test_slot_scheduler_copy_same_lifecycle():
    ja, jout = _drive_scheduler(jsched, jcache)
    ta, tout = _drive_scheduler(tsched, tcache)
    assert tout == jout
    assert ta.state_digest() == ja.state_digest()


# ---------------------------------------------------------------------------
# telemetry copies
# ---------------------------------------------------------------------------

def test_registry_copy_same_snapshot():
    obs = np.random.default_rng(0).lognormal(-5, 2, 500)

    def fill(mod):
        r = mod.Registry(label="serve")
        r.counter("serve/steps").inc(7)
        r.gauge("serve/occ").set(0.25)
        h = r.histogram("serve/step_time_s")
        for x in obs:
            h.observe(x)
        return r, h

    (jr, jh), (tr, th) = fill(jmetrics), fill(tmetrics)
    assert tr.snapshot(ts=1.0) == jr.snapshot(ts=1.0)
    assert th.percentiles((50, 90, 99)) == jh.percentiles((50, 90, 99))


def test_trace_copy_same_events():
    from repro import telemetry as jtel
    from repro.telemetry import trace as jtrace
    from repro_torch import telemetry as ttel
    from repro_torch.telemetry import trace as ttrace

    def record(tel, mod):
        was = tel.enabled()
        tel.set_enabled(True)
        try:
            mod.reset()
            with mod.span("serve/decode_step", active=3):
                mod.instant("serve/shed", rid=1)
            mod.async_begin("serve/req/queued", 4, prompt=5)
            mod.async_end("serve/req/queued", 4)
            # drop times and thread ids; keep kinds, names, ids, attributes
            return [(ph, n, a) for ph, n, _, _, _, a in mod.events()]
        finally:
            mod.reset()
            tel.set_enabled(was)

    got = record(ttel, ttrace)
    assert len(got) == 4
    assert got == record(jtel, jtrace)
