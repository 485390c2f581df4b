"""Serving the state-space decoders, port against the JAX package on the
CPU with bridged fp32 smoke parameters: the port's ``Engine(device=
"cpu")`` gives each request the greedy tokens ``repro.serve.Engine``
gives it, for mamba2-1.3b (no attention: the slot-granular pool whatever
``page_size`` says) and hymba-1.5b (cut to 3 layers, one on a 32-key
window; paged attention with SSM lanes one a slot, and contiguous), with
fused sampling on and off; slots churn, so lanes are reused. Then the
engine's own invariants: a reused slot returns what a fresh engine
returns, the prefill chunk rounds up to the SSD chunk, the prefix cache
stays off, drain -> restore re-prefills from zeroed lanes; the pool
helpers (``paged_view`` slices the SSM lanes, ``reset_slot_ssm`` zeroes
only them, ``copy_page`` leaves them); and the serve launcher once per
family. Token ids must be equal exactly.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.transformer import segments  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import SamplingParams  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402

LAYERS = {"mamba2-1.3b": 2, "hymba-1.5b": 3}
SHAPE = dict(max_slots=2, max_seq=64, prefill_chunk=8)


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
    ``jax.set_mesh`` with explicit axes behind, under which the JAX
    engine's cache updates trace differently."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _cfgs(arch):
    kw = dict(dtype="float32", remat=False, num_layers=LAYERS[arch])
    return tuple(get(arch).with_overrides(**kw) for get in (j_smoke, t_smoke))


@functools.cache
def _np_params(arch):
    """The reference's tree holding the port's init from seed 0 (numpy)."""
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


def _workload(vocab):
    """Five requests over two slots: prompts of 9-40 tokens (past hymba's
    32-key window and across several prefill chunks) and 3-6 new
    tokens."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, n).tolist() for n in (21, 12, 40, 9, 33)]
    return prompts, [6, 3, 5, 4, 5]


@functools.cache
def _jax_tokens(arch, page_size):
    jc, _ = _cfgs(arch)
    eng = JEngine(j_build(jc), jax.tree.map(jnp.asarray, _np_params(arch)),
                  page_size=page_size, **SHAPE)
    prompts, news = _workload(jc.vocab_size)
    rids = [eng.submit(p, m) for p, m in zip(prompts, news)]
    res = eng.run()
    return [res[int(r)] for r in rids]


def _engine(arch, **kw):
    _, tc = _cfgs(arch)
    return TEngine(t_build(tc, "cpu"),
                   decoder_params_from_jax(_np_params(arch), "cpu"),
                   device="cpu", **dict(SHAPE, **kw))


def _run(eng, prompts, news, sampling=None):
    rids = [eng.submit(p, m, sampling) for p, m in zip(prompts, news)]
    res = eng.run()
    return [res[int(r)] for r in rids]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch,page_size", [("mamba2-1.3b", 8),
                                            ("mamba2-1.3b", 0),
                                            ("hymba-1.5b", 8),
                                            ("hymba-1.5b", 0)])
def test_engine_greedy_matches_jax_engine(arch, page_size, fused):
    want = _jax_tokens(arch, page_size)
    eng = _engine(arch, page_size=page_size, fused_sampling=fused)
    assert _run(eng, *_workload(eng.cfg.vocab_size)) == want
    # mamba2 has no attention to page; hymba pages its attention leaves
    assert eng.paged == (arch == "hymba-1.5b" and page_size > 0)
    assert eng.trace_counts["decode"] == 1
    if eng.allocator is not None:
        assert not eng.allocator.prefix_cache
        assert eng.allocator.hits == 0
        eng.allocator.check_consistency()


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_reused_slot_returns_what_a_fresh_engine_returns(arch):
    """Request 4 runs on a lane that held requests 0-3 (one slot, so every
    request reuses it); it gets the tokens a fresh engine gives it."""
    _, tc = _cfgs(arch)
    prompts, news = _workload(tc.vocab_size)
    one = _engine(arch, max_slots=1, page_size=8)
    got = _run(one, prompts, news)
    fresh = _engine(arch, max_slots=1, page_size=8)
    assert _run(fresh, prompts[4:], news[4:]) == got[4:]
    # and the same as the JAX engine's two-slot run
    assert got == _jax_tokens(arch, 8)


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_prefill_chunk_rounds_up_to_the_ssd_chunk(arch):
    """Chunks of 10 become 16 (the smoke SSD chunk), so chunked prefill
    equals one call bit for bit; max_seq rounds up to a chunk multiple."""
    _, tc = _cfgs(arch)
    eng = _engine(arch, prefill_chunk=10, max_seq=40)
    assert eng.prefill_chunk == 16 == tc.ssm.chunk
    assert eng.max_seq % eng.prefill_chunk == 0 and eng.max_seq >= 40
    jc, _ = _cfgs(arch)
    jeng = JEngine(j_build(jc), jax.tree.map(jnp.asarray, _np_params(arch)),
                   max_slots=1, max_seq=40, prefill_chunk=10)
    assert (eng.prefill_chunk, eng.max_seq) == (jeng.prefill_chunk,
                                                jeng.max_seq)


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_drain_and_restore_reprefill_from_zeroed_lanes(arch):
    """Drain after 3 steps with requests in flight, restore into a fresh
    engine: every request's greedy tokens equal an uninterrupted run's
    (the interrupted ones re-prefill on lanes that held others)."""
    from repro_torch.serve import chaos
    _, tc = _cfgs(arch)
    out = chaos.verify_drain_restore(
        lambda: _engine(arch, page_size=8), n=5, drain_after=3,
        vocab=tc.vocab_size)
    assert out["requeued"]


def test_seeded_sampling_is_layout_free():
    """A temperature request's stream depends on its seed alone: the same
    through hymba's paged and contiguous pools."""
    _, tc = _cfgs("hymba-1.5b")
    prompts, news = _workload(tc.vocab_size)
    sp = SamplingParams(temperature=0.9, seed=7)
    a = _run(_engine("hymba-1.5b", page_size=8), prompts, news, sp)
    b = _run(_engine("hymba-1.5b", page_size=0), prompts, news, sp)
    assert a == b


# ---------------------------------------------------------------------------
# the pool helpers
# ---------------------------------------------------------------------------

def _hymba_pool():
    _, tc = _cfgs("hymba-1.5b")
    pool = t_build(tc, "cpu").init_paged_cache(3, 4, 6)
    for i, (_, t) in enumerate(tcache.leaves_with_path(pool)):
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).reshape(
            t.shape) + i)
    return pool


def test_paged_pool_pages_attention_and_keeps_ssm_lanes():
    _, tc = _cfgs("hymba-1.5b")
    pool = _hymba_pool()
    paths = [p for p, _ in tcache.leaves_with_path(pool)]
    assert {p[1:] for p in paths} == {("attn", "k"), ("attn", "v"),
                                      ("ssm", "conv"), ("ssm", "state")}
    for p, t in tcache.leaves_with_path(pool):
        assert t.shape[1] == (6 if tcache.is_paged_leaf(p) else 3)
    _, mc = _cfgs("mamba2-1.3b")
    assert not any(tcache.is_paged_leaf(p) for p, _ in tcache.leaves_with_path(
        t_build(mc, "cpu").init_paged_cache(3, 4, 6)))
    # paged_view: pages whole, SSM lanes sliced to slot 2 (views)
    view = tcache.paged_view(pool, 2)
    for (p, t), (_, v) in zip(tcache.leaves_with_path(pool),
                              tcache.leaves_with_path(view)):
        if tcache.is_paged_leaf(p):
            assert v is t
        else:
            assert v.shape[1] == 1 and v.data_ptr() == t[:, 2].data_ptr()
    assert tcache.paged_write(pool, 2, view) is pool


def test_reset_slot_ssm_zeroes_only_that_slots_ssm_lanes():
    pool = _hymba_pool()
    before = [t.clone() for t in tcache.leaves(pool)]
    tcache.reset_slot_ssm(pool, 1)
    for (p, t), b in zip(tcache.leaves_with_path(pool), before):
        if tcache.is_paged_leaf(p):
            assert torch.equal(t, b)
        else:
            assert (t[:, 1] == 0).all()
            assert torch.equal(t[:, 0], b[:, 0])
            assert torch.equal(t[:, 2], b[:, 2])


def test_copy_page_leaves_the_ssm_lanes():
    pool = _hymba_pool()
    before = [t.clone() for t in tcache.leaves(pool)]
    tcache.copy_page(pool, 1, 3)
    for (p, t), b in zip(tcache.leaves_with_path(pool), before):
        if tcache.is_paged_leaf(p):
            assert torch.equal(t[:, 1], b[:, 3])
            assert torch.equal(t[:, 2], b[:, 2])
        else:
            assert torch.equal(t, b)


def test_reset_slot_and_slot_view_cover_every_leaf():
    _, tc = _cfgs("hymba-1.5b")
    pool = t_build(tc, "cpu").init_cache(2, 16)
    for t in tcache.leaves(pool):
        t.fill_(1.0)
    view = tcache.slot_view(pool, 0)
    assert all(v.shape[1] == 1 for v in tcache.leaves(view))
    # zeroing through the views clears slot 0's lane of every leaf
    for v in tcache.leaves(view):
        v.zero_()
    for t in tcache.leaves(pool):
        assert (t[:, 0] == 0).all() and (t[:, 1] == 1).all()


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_serve_launcher_on_the_cpu(arch, capfd):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", arch, "--device", "cpu", "--num-requests", "3",
                 "--max-new", "4", "--fused-sampling", "--no-profile"])
    out = capfd.readouterr().out
    assert "tok/s" in out
    assert ("paged cache:" in out) == (arch == "hymba-1.5b")
