"""Head dims the kernels are not built for, the decode's chunk plan and its
combine, on the CPU, port against the JAX package.

- ``pad_head_dim``: at D 16, 24, 48 and 96 the flash forward (with lse),
  its backward (dq, dk, dv) and both decodes, fed their plain versions on
  inputs zero-padded to the kernel head dim and sliced back, equal the
  unpadded plain versions and the Pallas kernels in interpret mode. On the
  card the wrappers run the same padding around the CUDA kernels.
- ``decode_plan`` and the decode wrappers' host side (the CUDA library
  replaced by a recorder): the paged and contiguous paths split a lane
  alike, the serve shapes give at least two blocks an SM, and no device
  value is read.
- ``combine_live_splits`` (the plain version of the combine kernel, which
  reads only the chunks that hold a visible key) against the JAX
  package's ``_combine_kv_splits`` on the same partials, the dead chunks
  poisoned on the port's side.

Tolerance 1e-6, fp32 throughout: abs and rel for outputs, lse and the
combine; for dq, dk and dv against jax.grad through the Pallas kernels,
1e-6 of the gradient's largest magnitude (as the GPU tests scale the
backward's bound: the interpreter sums in another order and dq carries
the cancellation of dp - di, up to 1.4e-6 on gradients of magnitude 2-6
here). The padded and unpadded plain versions sum the same products but
for zeros.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
ODD_DIMS = [16, 24, 48, 96]
SMS = 132                    # an H100's SMs


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (an
    earlier test file in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=name,
                               **TOL)


def _close_to_scale(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= TOL["rtol"] * np.abs(b).max(), name


# ---------------------------------------------------------------------------
# head dims padded to the kernels' 32 / 64 / 128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", ODD_DIMS)
def test_kernel_head_dim_pads_up_and_refuses_above_128(D):
    Dp = tfa.kernel_head_dim("x", D)
    assert Dp in tfa.HEAD_DIMS and Dp >= D and Dp - D < Dp // 2 + 1
    x = torch.ones(2, 3, 4, D)
    (xp,) = tfa.pad_head_dim(D, x)
    assert xp.shape == (2, 3, 4, Dp) and torch.equal(xp[..., :D], x)
    assert not xp[..., D:].any()
    for big in (192, 256, 576):
        # above 128 only the decode has no kernel (the forward and backward
        # take the MLA route): the refusal names ROADMAP queue 2
        with pytest.raises(NotImplementedError,
                           match=f"head_dim {big} .*queue 2"):
            tfa.kernel_head_dim("flash_decode", big)


@pytest.mark.parametrize("D", ODD_DIMS)
def test_padded_forward_matches_plain_and_pallas(D):
    rng = np.random.default_rng(D)
    B, Sq, Sk, H, KV, win = 2, 24, 40, 4, 2, 9
    q, k, v = _rand(rng, B, Sq, H, D), _rand(rng, B, Sk, KV, D), \
        _rand(rng, B, Sk, KV, D)
    off = np.array([16, 5], np.int32)
    scale = 1 / math.sqrt(D)
    qp, kp, vp = tfa.pad_head_dim(D, _t(q), _t(k), _t(v))
    got, got_lse = tref.flash_attention_ref(qp, kp, vp, _t(off), win, scale,
                                            True)
    got = got[..., :D]
    plain, plain_lse = tref.flash_attention_ref(_t(q), _t(k), _t(v), _t(off),
                                                win, scale, True)
    want, want_lse = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off=jnp.asarray(off),
        window=win, interpret=True, return_lse=True)
    _close(got, plain, "out vs plain")
    _close(got_lse, plain_lse, "lse vs plain")
    _close(got, want, "out vs pallas")
    _close(got_lse, want_lse, "lse vs pallas")


@pytest.mark.parametrize("D", ODD_DIMS)
def test_padded_backward_matches_plain_and_pallas(D):
    """dq, dk, dv of the padded plain backward (do padded too, di from the
    unpadded out) sliced back, against the unpadded plain backward and
    jax.grad through the Pallas custom VJP (8 x 8 tiles)."""
    rng = np.random.default_rng(100 + D)
    S, H, KV, win = 30, 4, 2, 9
    q, k, v = _rand(rng, 1, S, H, D), _rand(rng, 1, S, KV, D), \
        _rand(rng, 1, S, KV, D)
    cot = _rand(rng, 1, S, H, D)
    scale = 1 / math.sqrt(D)
    off = torch.zeros(1, dtype=torch.int32)
    out, lse = tref.flash_attention_ref(_t(q), _t(k), _t(v), off, win, scale,
                                        True)
    do = _t(cot)
    di = tref.flash_attention_di(out, do)
    qp, kp, vp, dop = tfa.pad_head_dim(D, _t(q), _t(k), _t(v), do)
    dq = tref.flash_attention_dq_ref(qp, kp, vp, lse, dop, di, off, win,
                                     scale)[..., :D]
    dk, dv = (g[..., :D] for g in tref.flash_attention_dkv_ref(
        qp, kp, vp, lse, dop, di, off, win, scale))
    plain = tref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, do,
                                         off, win, scale)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, window=win, block_q=8,
                                           block_k=8, interpret=True) * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    for name, a, b, c in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, want):
        _close(a, b, f"{name} vs plain")
        _close_to_scale(a, c, f"{name} vs pallas")


@pytest.mark.parametrize("D", ODD_DIMS)
def test_padded_decode_matches_plain_and_pallas(D):
    rng = np.random.default_rng(200 + D)
    B, S, H, KV, win, bk = 3, 40, 4, 2, 7, 16
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, KV, D), \
        _rand(rng, B, S, KV, D)
    pos = np.array([0, 17, 39], np.int32)
    scale = 1 / math.sqrt(D)
    qp, kp, vp = tfa.pad_head_dim(D, _t(q), _t(k), _t(v))
    got = tref.flash_decode_ref(qp, kp, vp, _t(pos), win, scale, bk)[..., :D]
    plain = tref.flash_decode_ref(_t(q), _t(k), _t(v), _t(pos), win, scale,
                                  bk)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), window=win, block_k=bk,
                            interpret=True)
    _close(got, plain, "vs plain")
    _close(got, want, "vs pallas")


@pytest.mark.parametrize("D", ODD_DIMS)
def test_padded_paged_decode_matches_plain_and_pallas(D):
    rng = np.random.default_rng(300 + D)
    B, H, KV, ps, NP, P = 3, 4, 1, 8, 5, 12
    q = _rand(rng, B, 1, H, D)
    kp, vp = _rand(rng, P, ps, KV, D), _rand(rng, P, ps, KV, D)
    pos = np.array([3, 21, 39], np.int32)
    tables = rng.integers(1, P, size=(B, NP)).astype(np.int32)
    tables[np.arange(NP)[None] * ps > pos[:, None]] = 0
    scale = 1 / math.sqrt(D)
    qq, kk, vv = tfa.pad_head_dim(D, _t(q), _t(kp), _t(vp))
    got = tref.flash_decode_paged_ref(qq, kk, vv, _t(tables), _t(pos), 0,
                                      scale, ps)[..., :D]
    plain = tref.flash_decode_paged_ref(_t(q), _t(kp), _t(vp), _t(tables),
                                        _t(pos), 0, scale, ps)
    want = jfa.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(tables),
                                  jnp.asarray(pos), page_size=ps,
                                  interpret=True)
    _close(got, plain, "vs plain")
    _close(got, want, "vs pallas")


# ---------------------------------------------------------------------------
# the decode's chunk plan and the wrappers' host side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane_len", [1, 100, 1024, 8192, 100_000])
@pytest.mark.parametrize("page", [8, 16, 128, 512])
def test_decode_plan_covers_the_lane_in_whole_pages(lane_len, page):
    chunk, ns = tfa.decode_plan(lane_len, page, SMS)
    assert chunk % page == 0 and chunk >= tfa.DECODE_MIN_CHUNK
    assert (ns - 1) * chunk < lane_len <= ns * chunk
    assert ns <= max(1, tfa.DECODE_CHUNKS_PER_SM * SMS)


class _Recorder:
    """Stands in for the CUDA library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


class _NoRead(RuntimeError):
    pass


@pytest.fixture
def host_side(monkeypatch):
    """The decode wrappers' CUDA path on CPU tensors, with the library
    replaced by a recorder, an H100's SM count, and every way of reading a
    tensor's value on the host made to raise."""
    lib = _Recorder()
    monkeypatch.setattr(K, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "load", lambda name: lib)
    monkeypatch.setattr(K, "stream_ptr", lambda t: None)
    monkeypatch.setattr(K, "sm_count", lambda index: SMS)

    def no_read(*a, **k):
        raise _NoRead("a tensor's value was read on the host")

    for attr in ("item", "tolist", "__int__", "__bool__", "__float__",
                 "__index__", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, no_read)
    return lib


def _args(lib, entry):
    (args,) = [a for n, a in lib.calls if n == entry]
    return args


# B, H, KV, D, lane length, page size of the serve shapes
SERVE_SHAPES = {"llama3.2-1b": (8, 32, 8, 64, 1024, 16),
                "qwen1.5-4b": (8, 20, 20, 128, 1024, 16)}


@pytest.mark.parametrize("arch", sorted(SERVE_SHAPES))
def test_decode_host_side_splits_paged_and_contiguous_alike(arch, host_side):
    B, H, KV, D, S, ps = SERVE_SHAPES[arch]
    NP = S // ps
    q = torch.zeros(B, 1, H, D, dtype=torch.bfloat16)
    lanes = torch.zeros(B, S, KV, D, dtype=torch.bfloat16)
    pages = torch.zeros(B * NP + 1, ps, KV, D, dtype=torch.bfloat16)
    tables = torch.zeros(B, NP, dtype=torch.int32)
    pos = torch.arange(B, dtype=torch.int32) * 100
    tfa.flash_decode(q, lanes, lanes, pos, block_k=ps)
    tfa.flash_decode_paged(q, pages, pages, tables, pos, page_size=ps)
    splits = [a for n, a in host_side.calls if n == "flash_decode_split"]
    combines = [a for n, a in host_side.calls if n == "flash_decode_combine"]
    assert len(splits) == len(combines) == 2
    # (B, H, KV, D, dtype, S, NP, page, chunk, ns, kv_len, window) after
    # the 8 pointers; S and NP tell the layouts apart
    cont, paged = (a[8:20] for a in splits)
    assert cont[7:] == paged[7:] and cont[:5] == paged[:5]
    assert (cont[5], cont[6], paged[5], paged[6]) == (S, 0, 0, NP)
    chunk, ns = cont[8], cont[9]
    assert (chunk, ns) == tfa.decode_plan(S, ps, SMS)
    assert combines[0][5:] == combines[1][5:]
    blocks = ns * KV * -(-(H // KV) // 8) * B
    assert blocks >= 2 * SMS, blocks


@pytest.mark.parametrize("arch", sorted(SERVE_SHAPES))
def test_decode_default_block_k_gives_two_blocks_an_sm(arch, host_side):
    """The engine's contiguous decode (the default block_k) at the serve
    shapes fills the card as the paged one does."""
    B, H, KV, D, S, _ = SERVE_SHAPES[arch]
    q = torch.zeros(B, 1, H, D, dtype=torch.bfloat16)
    lanes = torch.zeros(B, S, KV, D, dtype=torch.bfloat16)
    tfa.flash_decode(q, lanes, lanes, torch.zeros(B, dtype=torch.int32))
    args = _args(host_side, "flash_decode_split")
    assert args[8 + 9] * KV * B >= 2 * SMS


def test_decode_host_side_pads_odd_head_dims(host_side):
    """D 48 reaches the library as 64, with sm_scale from the true 48."""
    q = torch.zeros(2, 1, 4, 48)
    lanes = torch.zeros(2, 64, 2, 48)
    out = tfa.flash_decode(q, lanes, lanes, torch.zeros(2, dtype=torch.int32))
    args = _args(host_side, "flash_decode_split")
    assert args[8 + 3] == 64 and out.shape == (2, 1, 4, 48)
    assert abs(args[20].value - 1 / math.sqrt(48)) < 1e-7


# ---------------------------------------------------------------------------
# the combine over live chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 150])
def test_combine_live_splits_matches_jax_combine(window):
    """Partials of 6 chunks of 64 keys; the port's side gets NaN in every
    chunk that holds no visible key, the JAX side the neutral partial."""
    rng = np.random.default_rng(7)
    B, KV, ns, G, D, chunk = 4, 2, 6, 3, 16, 64
    kv_len = ns * chunk - 10
    pos = np.array([0, 63, 200, 373], np.int32)
    m = _rand(rng, B, KV, ns, G)
    l = np.abs(_rand(rng, B, KV, ns, G)) + 0.5
    acc = _rand(rng, B, KV, ns, G, D)
    j = np.arange(ns)[None]
    lo = j * chunk
    hi = np.minimum(np.minimum((j + 1) * chunk, pos[:, None] + 1), kv_len)
    if window > 0:
        lo = np.maximum(lo, pos[:, None] - window + 1)
    live = (lo < hi)[:, None, :, None]
    assert live.any() and not live.all()
    jm, jl, ja = (np.where(live, m, tref.NEG_INF), np.where(live, l, 0.0),
                  np.where(live[..., None], acc, 0.0))
    want = jfa._combine_kv_splits(jnp.asarray(jm), jnp.asarray(jl),
                                  jnp.asarray(ja))
    poison = lambda x, lv: _t(np.where(lv, x, np.nan).astype(np.float32))
    tm, tl, ta = poison(m, live), poison(l, live), poison(acc,
                                                          live[..., None])
    got = tref.combine_live_splits(tm, tl, ta, _t(pos), window, chunk, kv_len)
    _close(got, want)
    via = tfa.decode_combine(tm, tl, ta, _t(pos), chunk=chunk, kv_len=kv_len,
                             window=window)
    assert torch.equal(via, got)


def test_combine_live_splits_of_chunk_partials_is_the_decode():
    """The decode's partials over chunks (the plain split at block_k =
    chunk) merged by combine_live_splits equal the plain decode, and the
    Pallas decode at that split."""
    rng = np.random.default_rng(8)
    B, S, H, KV, D, chunk, win = 3, 200, 8, 2, 32, 64, 70
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, KV, D), \
        _rand(rng, B, S, KV, D)
    pos = np.array([5, 130, 199], np.int32)
    scale = 1 / math.sqrt(D)
    m, l, acc = tref.decode_partials_ref(_t(q), _t(k), _t(v), _t(pos), win,
                                         scale, chunk)
    got = tref.combine_live_splits(m, l, acc, _t(pos), win, chunk, S)
    plain = tref.flash_decode_ref(_t(q), _t(k), _t(v), _t(pos), win, scale,
                                  chunk)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), window=win, block_k=chunk,
                            interpret=True)
    assert torch.equal(got, plain.float())
    _close(got, want)
