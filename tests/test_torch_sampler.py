"""The one-launch sampler's split of the vocab, on the CPU, port against the
JAX package.

- ``sampler_plan``: the slices of a slot's vocab cover [0, V) without
  overlap, start on multiples of 8 entries (a 16-byte boundary of bf16
  logits), number 1 to 16 (one block of the slot's cluster each), and the S
  clusters fit on the card at once.
- A numpy model of ``csrc/slot_gather.cu``'s reduction: the plan's slices,
  each block's entries dealt to its threads in 16-byte units (or single
  entries on the scalar path), each thread's strict first-maximum scan, and
  the (value, index) pairs folded by the kernel's ``better`` order. It
  equals the Pallas kernel in interpret mode, exactly, on ties placed
  across slice boundaries, rows that are all -inf, T = 0, and C = 32 with
  the last row selected. On the card ``tests/test_torch_gpu.py`` holds the
  kernel itself to the plain version on the same kinds of input.
- The wrapper's host side with the CUDA library replaced by a recorder:
  one entry call a sampler call, no scratch argument, one allocation (the
  two outputs), and no device value read.

Indices are compared exactly: the model rounds each product, sum, quotient
and noise addition in fp32 as the kernel does.
"""
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import slot_gather as jsg  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import slot_gather as tsg  # noqa: E402
from test_torch_decode import host_side  # noqa: E402,F401 (a fixture)

SMS = 132                    # an H100's SMs
INT_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [1000, 1537, 128256, 151936])
@pytest.mark.parametrize("S", [1, 8])
def test_sampler_plan_covers_the_vocab_in_aligned_slices(S, V):
    cl, sl = tsg.sampler_plan(S, 1, V, SMS)
    assert 1 <= cl <= tsg.SAMPLER_MAX_CLUSTER
    assert sl % tsg.SAMPLER_VEC == 0
    starts = [r * sl for r in range(cl)]
    ends = [min(V, s + sl) for s in starts]
    assert starts[0] == 0 and ends[-1] == V
    assert all(e == s for e, s in zip(ends, starts[1:]))     # no gap, no overlap
    assert all(s < e for s, e in zip(starts, ends))          # none empty
    assert cl == 1 or S * cl <= SMS * 7 // 8                 # one wave
    assert tsg.sampler_plan(S, 32, V, SMS) == (cl, sl)       # C does not enter


def test_sampler_plan_at_the_serve_shapes():
    """The prefill tail's one slot takes the largest cluster; 8 decode slots
    take clusters of 8, as many as an H100 holds at once."""
    assert tsg.sampler_plan(1, 32, 151936, SMS) == (16, 9496)
    assert tsg.sampler_plan(8, 1, 151936, SMS) == (8, 18992)
    assert tsg.sampler_plan(8, 1, 128256, SMS) == (8, 16032)


# ---------------------------------------------------------------------------
# the kernel's reduction, modelled in numpy, against the Pallas kernel
# ---------------------------------------------------------------------------

def _thread_firsts(vals, idx, width):
    """Each thread's (max, first index of it) over a block's entries, dealt
    in units of ``width`` entries to SAMPLER_THREADS threads in turn; a
    thread that saw only -inf (or nothing) keeps (-inf, INT_MAX)."""
    th = tsg.SAMPLER_THREADS
    n_units = -(-len(vals) // width)
    rounds = -(-n_units // th)
    pad = rounds * th * width - len(vals)
    v = np.concatenate([vals, np.full(pad, -np.inf, np.float32)])
    i = np.concatenate([idx, np.full(pad, INT_MAX, np.int64)])
    # (round, thread, entry) -> (thread, round, entry): each thread's entries
    # in increasing index order
    v = v.reshape(rounds, th, width).transpose(1, 0, 2).reshape(th, -1)
    i = i.reshape(rounds, th, width).transpose(1, 0, 2).reshape(th, -1)
    first = np.argmax(v, axis=1)
    best = v[np.arange(th), first]
    return best, np.where(best > -np.inf, i[np.arange(th), first], INT_MAX)


def _fold(vals, idxs):
    """The ``better`` order: the largest value, the lowest index among
    equal values; INT_MAX (nothing above -inf) gives 0."""
    top = vals.max()
    i = int(idxs[vals == top].min())
    return 0 if i == INT_MAX else i


def _kernel_model(logits, onehot, temp, noise, plan, vec):
    """greedy, sampled of csrc/slot_gather.cu for one plan and load path."""
    S, C, V = logits.shape
    cl, sl = plan
    width = tsg.SAMPLER_VEC if vec else 1
    out = np.zeros((2, S), np.int64)
    for s in range(S):
        t = np.maximum(np.float32(temp[s]), np.float32(1e-6))
        row = np.zeros(V, np.float32)
        for c in np.flatnonzero(onehot[s] != 0):     # rows of weight != 0
            row = row + logits[s, c] * onehot[s, c]  # fp32, rounded per op
        ys = (row, row / t + noise[s])
        for k, y in enumerate(ys):
            pairs = [_thread_firsts(y[r * sl:min(V, (r + 1) * sl)],
                                    np.arange(r * sl, min(V, (r + 1) * sl)),
                                    width)
                     for r in range(cl)]
            out[k, s] = _fold(np.concatenate([p[0] for p in pairs]),
                              np.concatenate([p[1] for p in pairs]))
    return out


def _boundary_ties(S, V, plan, value=3.0):
    """Zeros with ``value`` at both sides of every slice boundary and at
    two entries of one block's different threads."""
    x = np.zeros((S, 1, V), np.float32)
    _, sl = plan
    for b in range(sl, V, sl):
        x[:, 0, [b - 1, b]] = value
    x[:, 0, [min(V - 1, 5 + tsg.SAMPLER_VEC), 5]] = value - 1.0
    return x


def _case(name, sm):
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def gumbel(S, V):
        return -np.log(-np.log(rng.uniform(1e-20, 1.0, (S, V)))).astype(
            np.float32)

    if name.startswith("ties"):
        S, V = 2, int(name.split("_")[1])
        x = _boundary_ties(S, V, tsg.sampler_plan(S, 1, V, sm))
        return x, np.ones((S, 1), np.float32), np.ones(S, np.float32), \
            np.zeros((S, V), np.float32)
    if name.startswith("neg_inf"):
        # (the Pallas kernel pads V to its 512-entry tiles with -1e30 at
        # noise 0, which beats -inf / T only for T > 1: T stays <= 1)
        S, V = 3, int(name.split("_")[2])
        x = rng.standard_normal((S, 1, V)).astype(np.float32)
        x[1] = -np.inf
        x[2, 0, : V // 2] = -np.inf
        return x, np.ones((S, 1), np.float32), \
            np.array([1.0, 0.5, 0.0], np.float32), gumbel(S, V)
    if name == "t_zero":
        S, V = 3, 4100
        x = rng.standard_normal((S, 1, V)).astype(np.float32)
        return x, np.ones((S, 1), np.float32), \
            np.array([0.0, 0.7, 0.0], np.float32), gumbel(S, V)
    if name == "c32_last_row":
        S, C, V = 2, 32, 2000
        x = rng.standard_normal((S, C, V)).astype(np.float32)
        oh = np.zeros((S, C), np.float32)
        oh[0, C - 1] = oh[1, 0] = 1.0
        return x, oh, np.array([0.9, 1.3], np.float32), gumbel(S, V)
    raise KeyError(name)


CASES = ["ties_1537", "ties_4096", "neg_inf_1536", "neg_inf_1537", "t_zero",
         "c32_last_row"]


@pytest.mark.parametrize("sm", [SMS, 8])
@pytest.mark.parametrize("name", CASES)
def test_kernel_model_matches_pallas(name, sm):
    """Both load paths' reductions over the plan's slices (at an H100's SM
    count, and at 8 SMs, which cut the vocab into fewer slices) equal the
    Pallas kernel's indices."""
    logits, onehot, temp, noise = _case(name, sm)
    S, C, V = logits.shape
    wg, ws = jsg.slot_gather_sample(jnp.asarray(logits), jnp.asarray(onehot),
                                    jnp.asarray(temp), jnp.asarray(noise),
                                    interpret=True)
    want = np.stack([np.asarray(wg), np.asarray(ws)])
    plan = tsg.sampler_plan(S, C, V, sm)
    if name.startswith("ties"):
        assert plan[0] > 1 and (want == plan[1] - 1).all()   # first tie wins
    for vec in ([True, False] if V % tsg.SAMPLER_VEC == 0 else [False]):
        np.testing.assert_array_equal(
            _kernel_model(logits, onehot, temp, noise, plan, vec), want,
            err_msg=f"plan {plan}, 16-byte loads {vec}")


# ---------------------------------------------------------------------------
# the wrapper's host side
# ---------------------------------------------------------------------------

@pytest.fixture
def allocations(monkeypatch):
    """Every ``torch.empty`` call, recorded."""
    seen, empty = [], torch.empty

    def counted(*a, **k):
        seen.append((a, k))
        return empty(*a, **k)

    monkeypatch.setattr(torch, "empty", counted)
    return seen


@pytest.mark.parametrize("S,C,V,dtype", [
    (8, 1, 128256, torch.bfloat16),        # llama3.2-1b's decode
    (1, 32, 151936, torch.bfloat16),       # qwen1.5-4b's prefill tail
    (3, 5, 1537, torch.float16),
])
def test_wrapper_host_side_one_call_no_scratch(host_side, allocations, S, C,
                                               V, dtype):
    """The library replaced by a recorder and every tensor read made to
    raise (``host_side``, shared with the decode's tests)."""
    lib = host_side
    lg = torch.zeros(S, C, V, dtype=dtype)
    oh = torch.zeros(S, C)
    T, nz = torch.ones(S), torch.zeros(S, V)
    K.reset_launches()
    greedy, sampled = tsg.slot_gather_sample(lg, oh, T, nz)
    assert [n for n, _ in lib.calls] == ["slot_gather_sample"]
    (_, args), = lib.calls
    assert len(args) == len(
        K.SIGNATURES["slot_gather"]["slot_gather_sample"]) == 13
    # six pointers: the four inputs and the two outputs, no scratch
    assert [a.value for a in args[:6]] == [
        t.data_ptr() for t in (lg, oh, T, nz, greedy, sampled)]
    assert args[6:12] == (S, C, V) + tsg.sampler_plan(S, C, V, SMS) + (
        K.DTYPE_CODE[dtype],)
    # one allocation: greedy and sampled, side by side
    assert len(allocations) == 1
    assert greedy.shape == sampled.shape == (S,)
    assert greedy.dtype == sampled.dtype == torch.int32
    assert K.LAUNCHES == {"slot_gather_sample": 1}
