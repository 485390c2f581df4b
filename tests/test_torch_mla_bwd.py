"""The MLA route's backward on the tensor cores, checked on the CPU:

- the route table: which kernel family a dq or dk/dv call reaches at each
  built (Dk, Dv) pair and at a padded one, in fp32, bf16 and fp16 (the
  wrappers' host side with the CUDA library swapped for a recorder, as in
  ``test_torch_decode.py``), the scratch the wrapper allocates, and the
  refusals past (576, 512) and G 16;
- the dk/dv chunk plan (``mla_dkv_plan``, ``mla_dkv_blocks``): every live
  (key tile, q tile) pair covered exactly once for each part, at windows,
  ragged S, q offsets and G 1, 4 and 16, the blocks ordered heaviest
  first, enough of them to fill the card at the MLA shape;
- a plain-torch model of what the kernels sum (dq over key tiles of 32
  keys; dk/dv over each chunk's q tiles into fp32 partials, then the
  partials in chunk order), with the kernels' cast points (dS to k's and
  q's dtype, P to do's), against JAX's ``_bwd_call`` in interpret mode at
  Dk 96 / Dv 64 over G 4 and at Dk 576 / Dv 512 over G 16, S 32;
- the reduction's plain version: only live chunks are read.

Tolerances: fp32 model vs JAX 1e-5 of each output's largest magnitude
(fp32 sums in another order); bf16 2e-2 (``BWD_TOL`` of the card's
checks: both round dS and P to bf16 per element, but an fp32 dS that
differs in its last bits can round to the neighbouring bf16 value); the
reduction exactly (it adds the same fp32 values in the same order).
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
from repro_torch.kernels import ref  # noqa: E402

SMS = 132          # an H100's SMs, as the plans see them
BWD_TOL = 2e-2


@pytest.fixture(autouse=True)
def _unsharded_jax():
    """Run the JAX side on one device with no sharding in its types (a
    file run earlier in the same process may leave a global mesh)."""
    mesh = jax.make_mesh((1,), ("unsharded",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the CUDA library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def host_side(monkeypatch):
    """The MLA wrappers' CUDA path on CPU tensors with the library replaced
    by a recorder, an H100's SM count, and the float32 ``torch.empty``
    calls (the dk/dv scratch) recorded."""
    lib = _Recorder()
    monkeypatch.setattr(K, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "load", lambda name: lib)
    monkeypatch.setattr(K, "stream_ptr", lambda t: None)
    monkeypatch.setattr(K, "sm_count", lambda index: SMS)
    empty = torch.empty
    lib.scratch = []

    def recorded(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dtype == torch.float32:
            lib.scratch.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", recorded)
    K.reset_launches()
    return lib


def _mla_inputs(dtype, B, S, H, KV, Dk, Dv):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return (z(B, S, H, Dk), z(B, S, KV, Dk), z(B, S, KV, Dv),
            torch.zeros(B, S, H), z(B, S, H, Dv), torch.zeros(B, S, H))


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dims,fp32_pair", [
    ((96, 64), (96, 64)), ((576, 512), (576, 512)),
    ((80, 64), (96, 64)),          # the smoke config's layout, padded
    ((300, 200), (576, 512)),      # padded up to the largest pair
])
def test_route_table(host_side, dtype, dims, fp32_pair):
    """fp32 reaches the CUDA-core kernels at the smallest built pair that
    holds the dims, one launch each; bf16 and fp16 the tensor-core ones at
    (576, 512), dk/dv as the chunks' partials into one fp32 scratch of the
    plan's size, then the reduction. Outputs come back at the true dims."""
    B, S, H, KV = 2, 100, 16, 1
    Dk, Dv = dims
    q, k, v, lse, do, di = _mla_inputs(dtype, B, S, H, KV, Dk, Dv)
    q_off = torch.zeros(B, dtype=torch.int32)
    kw = dict(q_off=q_off, window=0, sm_scale=1 / math.sqrt(Dk))
    dq = tfa.flash_attention_dq(q, k, v, lse, do, di, **kw)
    dk, dv = tfa.flash_attention_dkv(q, k, v, lse, do, di, **kw)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    names = [n for n, _ in host_side.calls]
    calls = dict(host_side.calls)
    # (B, Sq, Sk, H, KV, Dk, Dv, dtype, window) after the pointers
    want = (B, S, S, H, KV) + (fp32_pair if dtype == torch.float32
                               else tfa.MLA_TC_PAIR) + (DTYPE_CODE[dtype], 0)
    assert calls["flash_mla_bwd_dq"][8:17] == want
    dkv = calls["flash_mla_bwd_dkv"]
    assert dkv[9:18] == want
    if dtype == torch.float32:
        assert names == ["flash_mla_bwd_dq", "flash_mla_bwd_dkv"]
        assert dkv[19].value is None and dkv[20] == 0 and dkv[6].value
        assert host_side.scratch == []
        assert K.LAUNCHES == {"flash_attention_mla_dq": 1,
                              "flash_attention_mla_dkv": 1}
        return
    assert names == ["flash_mla_bwd_dq", "flash_mla_bwd_dkv",
                     "flash_mla_dkv_reduce"]
    chunk, n_chunks = tfa.mla_dkv_plan(B, S, S, H, KV, SMS)
    assert dkv[20] == chunk and dkv[19].value and dkv[6].value is None
    red = calls["flash_mla_dkv_reduce"]
    assert red[0].value == dkv[19].value and red[4:] == want + (chunk, None)
    assert host_side.scratch == [n_chunks * B * S * KV * sum(
        tfa.MLA_TC_PAIR)]
    assert K.LAUNCHES == {"flash_attention_mla_dq": 1,
                          "flash_attention_mla_dkv": 1,
                          "flash_attention_mla_dkv_reduce": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_route_refuses_by_name(host_side, dtype):
    """Past Dk 576 / Dv 512, or at G 17, every backward entry raises before
    any kernel, naming what it exceeds."""
    for (Dk, Dv), H, match in (((577, 512), 16, "Dk=577, Dv=512 are more"),
                               ((576, 513), 16, "Dk=576, Dv=513 are more"),
                               ((576, 512), 17, "G = 17 > 16, .*MLA")):
        q, k, v, lse, do, di = _mla_inputs(dtype, 1, 8, H, 1, Dk, Dv)
        kw = dict(q_off=torch.zeros(1, dtype=torch.int32), sm_scale=1.)
        for fn in (tfa.flash_attention_dq, tfa.flash_attention_dkv):
            with pytest.raises(NotImplementedError, match=match):
                fn(q, k, v, lse, do, di, **kw)
    assert host_side.calls == []


# ---------------------------------------------------------------------------
# the dk/dv chunk plan
# ---------------------------------------------------------------------------

def _live_pairs(B, Sq, Sk, H, KV, q_off, window):
    """{(b, h, key tile, q tile)} with at least one visible (query, key)
    pair, by brute force over positions: q tiles of MLA_DKV_ROWS // G
    queries, key tiles of MLA_DKV_KEYS keys."""
    bq = tfa.MLA_DKV_ROWS // (H // KV)
    out = set()
    for b in range(B):
        qp = q_off[b] + np.arange(Sq)[:, None]
        kp = np.arange(Sk)[None, :]
        vis = kp <= qp
        if window > 0:
            vis &= qp - kp < window
        qi, ki = np.nonzero(vis)
        for i, j in set(zip(qi // bq, ki // tfa.MLA_DKV_KEYS)):
            out.update((b, h, int(j), int(i)) for h in range(KV))
    return out


PLAN_CASES = [
    # B, S, H, KV, window, q_off
    (2, 1024, 16, 1, 0, (0, 0)),        # DeepSeek-V2-Lite's training shape
    (2, 200, 16, 1, 0, (0, 0)),
    (1, 200, 16, 1, 50, (9,)),
    (2, 77, 4, 1, 7, (3, 0)),           # G 4, ragged
    (2, 300, 8, 2, 100, (0, 37)),       # G 4 over KV 2
    (1, 129, 1, 1, 0, (0,)),            # G 1
    (1, 130, 1, 1, 33, (64,)),
    (2, 1000, 16, 1, 300, (0, 0)),
]


@pytest.mark.parametrize("B,S,H,KV,window,q_off", PLAN_CASES)
@pytest.mark.parametrize("sms", [SMS, 8])
def test_dkv_plan_covers_every_live_pair_once(B, S, H, KV, window, q_off,
                                              sms):
    """For each part (dk, dv): the blocks' q-tile ranges are disjoint, lie
    within the q tiles, hold every live (key tile, q tile) pair and no
    more than chunk tiles each; the scratch holds n_chunks chunks."""
    chunk, n_chunks = tfa.mla_dkv_plan(B, S, S, H, KV, sms)
    bq = tfa.MLA_DKV_ROWS // (H // KV)
    nq = -(-S // bq)
    assert 1 <= chunk <= nq and (n_chunks - 1) * chunk < nq <= n_chunks * chunk
    assert chunk >= min(nq, tfa.MLA_DKV_MIN_CHUNK)
    blocks = tfa.mla_dkv_blocks(B, S, S, H, KV, q_off, window, chunk)
    live = _live_pairs(B, S, S, H, KV, q_off, window)
    for part in (0, 1):
        covered = []
        for c, p, b, h, j, s_lo, steps in blocks:
            if p == part:
                assert 0 <= c < n_chunks and 1 <= steps <= chunk
                assert 0 <= s_lo and s_lo + steps <= nq
                covered += [(b, h, j, i) for i in range(s_lo, s_lo + steps)]
        assert len(covered) == len(set(covered))
        assert live <= set(covered)
        # the kernel's live range may take a ragged end's tile whose
        # queries see no key: never more than one tile a key tile
        extra = set(covered) - live
        assert len(extra) <= len({x[:3] for x in covered}), extra


@pytest.mark.parametrize("S,H", [(1024, 16), (200, 16), (129, 1), (77, 4)])
def test_dkv_plan_runs_heaviest_first(S, H):
    """Causal at q_off 0: each chunk round runs dk's blocks before dv's,
    each part's blocks in non-increasing work, and no block of a later
    round is heavier than the first block of an earlier one."""
    B, KV = 2, 1
    chunk, _ = tfa.mla_dkv_plan(B, S, S, H, KV, SMS)
    blocks = tfa.mla_dkv_blocks(B, S, S, H, KV, (0, 0), 0, chunk)
    rounds = {}
    for c, part, *_, steps in blocks:
        rounds.setdefault(c, []).append((part, steps))
    first = []
    for c in sorted(rounds):
        parts = [p for p, _ in rounds[c]]
        assert parts == sorted(parts)
        for part in (0, 1):
            work = [w for p, w in rounds[c] if p == part]
            assert work == sorted(work, reverse=True)
        first.append(rounds[c][0][1])
        assert max(w for _, w in rounds[c]) <= min(first)


def test_dkv_plan_fills_the_card_at_the_mla_shape():
    """DeepSeek-V2-Lite's training shape (B 2, S 1024, 16 heads over 1):
    chunks of 63 q tiles, 9 a key tile, 320 live blocks (2.4 an SM), none
    longer than a chunk."""
    chunk, n_chunks = tfa.mla_dkv_plan(2, 1024, 1024, 16, 1, SMS)
    blocks = tfa.mla_dkv_blocks(2, 1024, 1024, 16, 1, (0, 0), 0, chunk)
    assert (chunk, n_chunks, len(blocks)) == (63, 9, 320)
    assert len(blocks) >= 2 * SMS


# ---------------------------------------------------------------------------
# a model of the kernels' sums against the Pallas backward
# ---------------------------------------------------------------------------

def _model_bwd(q, k, v, lse, do, di, q_off, window, scale, chunk):
    """(dq, dk, dv) as the tensor-core kernels sum them, in plain torch:
    p and dS from the plain version's fp32 formulas, dS rounded to k's
    dtype (dq) and q's (dk), P to do's (dv); dq summed over key tiles of
    32 in order; dk/dv over each block's q tiles of MLA_DKV_ROWS rows
    into its chunk's fp32 partial (``mla_dkv_blocks``), the partials then
    summed by the reduction's plain version, dead chunks NaN."""
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    f = lambda t: t.float()  # noqa: E731
    p, ds = ref._bwd_p_ds(q, k, v, lse, do, di, q_off, window, scale)
    ds_k, ds_q, p_v = f(ds.to(k.dtype)), f(ds.to(q.dtype)), f(p.to(do.dtype))
    dq = torch.zeros(B, KV, G, Sq, Dk)
    for k0 in range(0, Sk, 32):
        dq += torch.einsum("bkgqt,btkd->bkgqd", ds_k[..., k0:k0 + 32],
                           f(k[:, k0:k0 + 32]))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dk).to(q.dtype)
    bq = tfa.MLA_DKV_ROWS // G
    n_chunks = -(-(-(-Sq // bq)) // chunk)
    nan = float("nan")
    part = {0: torch.full((n_chunks, B, Sk, KV, Dk), nan),
            1: torch.full((n_chunks, B, Sk, KV, Dv), nan)}
    qg, dog = f(q).reshape(B, Sq, KV, G, Dk), f(do).reshape(B, Sq, KV, G, Dv)
    for c, which, b, h, j, s_lo, steps in tfa.mla_dkv_blocks(
            B, Sq, Sk, H, KV, q_off.tolist(), window, chunk):
        x, y = (ds_q, qg) if which == 0 else (p_v, dog)
        keys = slice(j * 64, min(Sk, j * 64 + 64))
        acc = torch.zeros(keys.stop - keys.start, y.shape[-1])
        for s in range(s_lo, s_lo + steps):
            qs = slice(s * bq, min(Sq, s * bq + bq))
            acc += torch.einsum("gqt,qgd->td", x[b, h, :, qs, keys],
                                y[b, qs, h])
        part[which][c, b, keys, h] = acc
    n_live = torch.tensor([[-(-tfa.mla_dkv_live(
        key // 64, int(q_off[b]), window, -(-Sq // bq), bq)[1] // chunk)
        for key in range(Sk)] for b in range(B)])
    dk, dv = ref.mla_dkv_reduce_ref(part[0], part[1], n_live, k.dtype)
    return dq, dk, dv


def _jax_bwd(q, k, v, out, lse, do, q_off, window, scale, block):
    """JAX's ``_bwd_call`` (the Pallas dq and dk/dv kernels, interpret
    mode) on the same inputs, saved out and lse."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    qo = jnp.asarray(q_off.numpy(), jnp.int32).reshape(-1, 1)
    win = jnp.asarray(window, jnp.int32).reshape(1, 1)
    got = jfa._bwd_call(j(q), j(k), j(v), qo, win, j(out),
                        jnp.asarray(lse.numpy()), j(do), scale, k.shape[1],
                        block, block, True)
    return [torch.tensor(np.asarray(g.astype(jnp.float32))) for g in got]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,q_off", [
    ((2, 40, 8, 2, 96, 64), 7, (0, 5)),     # G 4, a window
    ((2, 40, 4, 1, 96, 64), 0, (3, 0)),     # G 4 over one KV head
    ((1, 32, 16, 1, 576, 512), 0, (0,)),    # DeepSeek-V2-Lite's layout
    ((1, 32, 16, 1, 576, 512), 9, (2,)),
])
@pytest.mark.parametrize("plan_chunk", [True, False])
def test_kernel_sums_match_pallas_bwd(dtype, shape, window, q_off,
                                      plan_chunk):
    """The model of the tensor-core sums (chunks of the plan's size, and of
    2 q tiles: many partials) against JAX's backward in interpret mode."""
    B, S, H, KV, Dk, Dv = shape
    rng = np.random.default_rng(S + Dk + window)
    rn = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    q, k, v, do = rn(B, S, H, Dk), rn(B, S, KV, Dk), rn(B, S, KV, Dv), \
        rn(B, S, H, Dv)
    qo = torch.tensor(q_off, dtype=torch.int32)
    scale = 1 / math.sqrt(Dk)
    out, lse = ref.flash_attention_ref(q, k, v, qo, window, scale, True)
    di = ref.flash_attention_di(out, do)
    chunk = tfa.mla_dkv_plan(B, S, S, H, KV, SMS)[0] if plan_chunk else 2
    got = _model_bwd(q, k, v, lse, do, di, qo, window, scale, chunk)
    want = _jax_bwd(q, k, v, out, lse, do, qo, window, scale, 8)
    tol = 1e-5 if dtype == torch.float32 else BWD_TOL
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == dtype, name
        err = (a.float() - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), (name, err)


def test_reduce_plain_version_reads_only_live_chunks():
    """``mla_dkv_reduce`` on the CPU: each key's live chunks summed in
    order (a numpy loop here), dead chunks (NaN) never read."""
    B, S, H, KV, Dk, Dv, window, chunk = 2, 150, 16, 1, 64, 64, 40, 3
    q_off = torch.tensor([0, 21], dtype=torch.int32)
    bq = tfa.MLA_DKV_ROWS // (H // KV)
    nq = -(-S // bq)
    n_chunks = -(-nq // chunk)
    rows = B * S * KV
    rng = np.random.default_rng(0)
    part = rng.standard_normal((n_chunks, rows * (Dk + Dv))).astype(
        np.float32)
    want = np.zeros((rows, Dk + Dv), np.float32)
    for b in range(B):
        for key in range(S):
            n = -(-tfa.mla_dkv_live(key // 64, int(q_off[b]), window, nq,
                                    bq)[1] // chunk)
            r = b * S + key
            cols = np.r_[r * Dk:(r + 1) * Dk,
                         rows * Dk + r * Dv:rows * Dk + (r + 1) * Dv]
            for c in range(n):
                want[r] += part[c, cols]
            part[n:, cols] = np.nan
    dk, dv = tfa.mla_dkv_reduce(torch.from_numpy(part).reshape(-1), q_off,
                                B=B, Sq=S, Sk=S, H=H, KV=KV, Dk=Dk, Dv=Dv,
                                window=window, chunk=chunk,
                                dtype=torch.float32)
    np.testing.assert_array_equal(dk.reshape(rows, Dk).numpy(),
                                  want[:, :Dk])
    np.testing.assert_array_equal(dv.reshape(rows, Dv).numpy(),
                                  want[:, Dk:])
