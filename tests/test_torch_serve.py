"""The serve slice as a whole, port against the JAX package on the CPU:
sampling with shared noise, and the port's ``Engine(device="cpu")``
giving the same greedy tokens per request as ``repro.serve.Engine`` on
the same prompts and bridged parameters — paged and contiguous pools,
fused sampling on and off, prefix-cache hits (partial and full, with a
copy-on-write). Token ids must be equal exactly; the models run at fp32.
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
from repro.serve import sampling as jsampling  # noqa: E402
from repro_torch.bridge import decoder_params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import SamplingParams  # noqa: E402
from repro_torch.serve import sampling as tsampling  # noqa: E402

ARCH = "llama3.2-1b"


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types. A
    test file run earlier in the same process may leave a global
    ``jax.set_mesh`` with explicit axes behind, under which the JAX
    engine's kernels and cache updates trace differently."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


# ---------------------------------------------------------------------------
# sampling with shared noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filters", [False, True])
def test_sample_tokens_shared_noise(filters):
    rng = np.random.default_rng(0)
    S, V = 4, 300
    logits = rng.standard_normal((S, V)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 40] if filters else [0] * S, np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.9] if filters else [1.0] * S,
                     np.float32)
    noise = -np.log(-np.log(rng.uniform(1e-20, 1, (S, V)))).astype(np.float32)
    want = jsampling.sample_tokens(*map(jnp.asarray, (logits, temp, top_k,
                                                      top_p, noise)))
    got = tsampling.sample_tokens(*map(torch.from_numpy, (logits, temp, top_k,
                                                          top_p, noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

def _workload(vocab):
    """Five requests over two slots (slots churn). Requests 0, 3 and 4
    share a 16-token head; 3 and 4 are admitted after 0 has published it,
    and 4 is the head alone — a full-prompt hit that copies its last page."""
    rng = np.random.RandomState(0)
    head = rng.randint(0, vocab, 16).tolist()
    prompts = [head + rng.randint(0, vocab, 5).tolist(),
               rng.randint(0, vocab, 12).tolist(),
               rng.randint(0, vocab, 9).tolist(),
               head + rng.randint(0, vocab, 3).tolist(),
               head]
    return prompts, [6, 3, 5, 4, 5]


@functools.lru_cache(maxsize=None)
def _jax_reference():
    cfg = j_smoke(ARCH).with_overrides(dtype="float32", remat=False)
    model = j_build(cfg)
    params = model.init(jax.random.key(0))
    prompts, news = _workload(cfg.vocab_size)
    eng = JEngine(model, params, max_slots=2, max_seq=64, prefill_chunk=8,
                  page_size=0)
    rids = [eng.submit(p, m) for p, m in zip(prompts, news)]
    res = eng.run()
    tokens = [res[int(r)] for r in rids]
    return jax.tree.map(np.asarray, params), tokens


def _port_engine(**kw):
    jparams, _ = _jax_reference()
    cfg = t_smoke(ARCH).with_overrides(dtype="float32", remat=False)
    model = t_build(cfg, "cpu")
    params = decoder_params_from_jax(jparams, "cpu")
    return TEngine(model, params, max_slots=2, max_seq=64, prefill_chunk=8,
                   device="cpu", **kw)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("page_size", [8, 0])
def test_engine_greedy_matches_jax_engine(page_size, fused):
    _, want = _jax_reference()
    eng = _port_engine(page_size=page_size, fused_sampling=fused)
    prompts, news = _workload(eng.cfg.vocab_size)
    rids = [eng.submit(p, m) for p, m in zip(prompts, news)]
    res = eng.run()
    assert [res[int(r)] for r in rids] == want
    if page_size:
        al = eng.allocator
        # request 3 hit the head's 2 pages; request 4 hit them in full and
        # re-ran its last token through a copy of the shared last page
        assert al.hit_tokens == 32 and al.cow_copies >= 1
        al.check_consistency()


def test_engine_prefix_hit_skips_prefill():
    """A prefix hit computes only the uncached tail of the prompt."""
    _, want = _jax_reference()
    prompts, news = _workload(t_smoke(ARCH).vocab_size)
    cold = _port_engine(page_size=8, prefix_cache=False)
    warm = _port_engine(page_size=8)
    for eng in (cold, warm):
        rids = [eng.submit(p, m) for p, m in zip(prompts, news)]
        assert [eng.run()[int(r)] for r in rids] == want
    # request 3 skips 16 of 19 prompt tokens, request 4 all but the last
    assert cold.stats.prefill_tokens - warm.stats.prefill_tokens == 16 + 15


def test_engine_temperature_is_seeded_and_layout_free():
    """Sampled streams depend on the request seed alone: the same in a
    paged and a contiguous engine, different for another seed."""
    prompts, news = _workload(t_smoke(ARCH).vocab_size)
    outs = []
    for page_size, seed in [(8, 1), (0, 1), (8, 2)]:
        eng = _port_engine(page_size=page_size, fused_sampling=True)
        sp = SamplingParams(temperature=0.9, seed=seed)
        rids = [eng.submit(p, m, sp) for p, m in zip(prompts, news)]
        res = eng.run()
        outs.append([res[int(r)] for r in rids])
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_engine_queue_bound_and_cancel():
    eng = _port_engine(page_size=8, max_queue=2)
    prompts, _ = _workload(t_smoke(ARCH).vocab_size)
    r0, r1 = eng.submit(prompts[0], 4), eng.submit(prompts[1], 4)
    assert not eng.submit(prompts[2], 4)          # queue full
    assert eng.stats.rejected_queue_full == 1
    assert eng.cancel(r1)
    res = eng.run()
    assert len(res[int(r0)]) == 4 and res[int(r1)] == []
    assert eng.sched.finish_reasons()[int(r1)] == "cancel"
    eng.allocator.check_consistency()


def test_fused_engine_refuses_top_k():
    eng = _port_engine(page_size=8, fused_sampling=True)
    with pytest.raises(ValueError, match="top-k"):
        eng.submit([1, 2, 3], 2, SamplingParams(temperature=1.0, top_k=5))
