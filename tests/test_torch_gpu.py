"""The CUDA kernels on the card, each held to its plain PyTorch version on
the same inputs. Marked ``cuda``; they skip where no GPU is visible and
run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpu.py

Tolerances: fp32 1e-5 (sums in another order); bf16 and fp16 1e-2 on
outputs of magnitude <~ 1 (bf16 eps is 2^-8, and the kernel rounds p per
tile where the plain version rounds it once); sampled indices, two calls
of one kernel, and the paged vs contiguous decode are exact. Head dims
other than 32, 64 and 128 (padded by the wrappers) are held as those
are. The flash backward (dq, dk/dv) against its
plain version: max |d| <= 1e-5 (fp32), 1e-2 (fp16) or 2e-2 (bf16) of
the output's largest magnitude; both round ds and p to the input dtype
per element, but sum them in another order, and ds carries the
cancellation of dp - di. The training kernels (chunk_sum, the fp16
casts, fused_sgd, fused_rs_update) are exact: they add rows in the plain
version's order and round every product and sum on its own (no FMA); so
are the blockwise int8 quantizers. VGG-16 and GoogLeNet on the card
against the CPU in fp32 (TF32 off): logits and loss within 1e-4 of their
scale (the libraries sum in another order). One ``ring16`` exchange of
two ranks sharing the card: the mean within 5e-3 of the values' scale,
the reference's bound. The serve chaos loop on the card: the reference
CLI's counts, bitwise replay and drain -> restore.
"""
import math

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import chunk_sum as cs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_rs_update as fru
from repro_torch.kernels import fused_sgd as fs
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref
from repro_torch.kernels import slot_gather as sg

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rn(g, dev, dtype, *shape):
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [
    # B, Sq, Sk, H, KV, D, window; q_off = (Sk - Sq, 0)
    (2, 37, 53, 4, 1, 32, 0),
    (2, 24, 40, 4, 4, 32, 8),
    (1, 32, 1024, 32, 8, 64, 0),           # the serve chunk, llama3.2-1b
    (2, 45, 45, 12, 4, 64, 9),             # G = 3
    (1, 1000, 1000, 12, 4, 64, 0),
    (1, 32, 1024, 20, 20, 128, 0),         # the serve chunk, qwen1.5-4b
    # the 64-row q tiles and 64-key tiles of the bf16/fp16 kernel: one
    # short of a tile, one past, two past, and ragged
    (2, 63, 63, 8, 1, 128, 0),             # G = 8
    (1, 65, 65, 12, 1, 128, 0),            # G = 12
    (2, 129, 129, 8, 8, 64, 0),            # G = 1
    (1, 1000, 1000, 8, 1, 128, 200),       # G = 8, window 200
    (2, 65, 200, 4, 2, 32, 33),            # Sq < Sk, a chunk at (135, 0)
    (2, 100, 300, 20, 20, 128, 64),        # window on a tile edge
    # the serve chunks of minitron-8b (G 4), llama4-scout (G 5: 12 queries
    # in 60 of a tile's 64 rows) and mistral-large-123b (G 12: 5 in 60)
    (1, 32, 1024, 32, 8, 128, 0),
    (1, 32, 1024, 40, 8, 128, 0),
    (1, 32, 1024, 96, 8, 128, 0),
    (2, 130, 130, 40, 8, 128, 0),          # G = 5, ragged
    (1, 130, 130, 96, 8, 128, 50),         # G = 12, ragged, window 50
])
def test_flash_attention_kernel(dev, dtype, shape):
    B, Sq, Sk, H, KV, D, win = shape
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rn(g, dev, dtype, B, Sq, H, D), _rn(g, dev, dtype, B, Sk, KV, D),
               _rn(g, dev, dtype, B, Sk, KV, D))
    q_off = torch.tensor([Sk - Sq, 0][:B], dtype=torch.int32, device=dev)
    K.reset_launches()
    out, lse = fa.flash_attention(q, k, v, q_off=q_off, window=win,
                                  return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, win,
                                             1 / math.sqrt(D), True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention": 1}
    assert (out.float() - want.float()).abs().max() <= TOL[dtype]
    assert (lse - want_lse).abs().max() <= 1e-4


BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 1e-2}


def _mla_launches(dtype):
    """The launches of one MLA-route forward, dq and dk/dv call: in bf16
    and fp16 the tensor-core dk/dv's reduction too."""
    out = {"flash_attention_mla": 1, "flash_attention_mla_dq": 1,
           "flash_attention_mla_dkv": 1}
    if dtype != torch.float32:
        out["flash_attention_mla_dkv_reduce"] = 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [
    # B, Sq, Sk, H, KV, D, window, q_off
    (2, 37, 53, 4, 4, 32, 0, "vector"),      # G = 1, ragged, q_off (16, 0)
    (2, 45, 45, 12, 4, 64, 9, None),         # G = 3, window 9
    (1, 61, 70, 8, 2, 64, 0, 9),             # G = 4, ragged
    (2, 24, 40, 16, 1, 32, 9, "vector"),     # G = 16, window 9
    (1, 1000, 1000, 12, 4, 64, 0, None),     # G = 3, S = 1000
    # the edges of the 64-row q tiles and 64-key tiles of the bf16/fp16
    # kernels: one short of a tile, one past, two past
    (1, 63, 63, 8, 8, 64, 0, None),          # G = 1
    (2, 65, 65, 4, 2, 32, 0, "vector"),      # G = 2
    (1, 129, 129, 8, 1, 64, 0, None),        # G = 8
    (2, 129, 129, 2, 1, 64, 64, "vector"),   # G = 2, window on a tile edge
    (2, 65, 200, 3, 1, 32, 33, "vector"),    # G = 3, a chunk at (135, 0)
    (2, 63, 129, 4, 1, 64, 0, "vector"),     # G = 4, a chunk at (66, 0)
    (1, 100, 1000, 16, 1, 64, 0, 900),       # G = 16, the last chunk
    (2, 1000, 1000, 8, 1, 32, 129, None),    # G = 8, window 129, D 32
    # head dim 128: two 64-value panels a row
    (2, 65, 65, 4, 4, 128, 0, "vector"),     # G = 1
    (1, 129, 129, 8, 1, 128, 0, None),       # G = 8
    (2, 100, 300, 12, 1, 128, 50, "vector"), # G = 12, window 50
    (1, 1000, 1000, 20, 20, 128, 0, None),   # G = 1, S = 1000
    # the training shapes' groups (minitron-8b 4, llama4-scout 5,
    # mistral-large-123b 12) at D 128, ragged
    (1, 200, 200, 32, 8, 128, 64, None),     # G = 4, window 64
    (2, 70, 130, 40, 8, 128, 0, "vector"),   # G = 5, a chunk at (60, 0)
    (1, 130, 130, 96, 8, 128, 0, None),      # G = 12
])
def test_flash_backward_kernels(dev, dtype, shape):
    B, Sq, Sk, H, KV, D, win, off = shape
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_rn(g, dev, dtype, B, Sq, H, D), _rn(g, dev, dtype, B, Sk, KV, D),
               _rn(g, dev, dtype, B, Sk, KV, D))
    do = _rn(g, dev, dtype, B, Sq, H, D)
    q_off = fa._positions([Sk - Sq, 0][:B] if off == "vector" else off, B, dev)
    scale = 1 / math.sqrt(D)
    out, lse = fa.flash_attention(q, k, v, q_off=q_off, window=win,
                                  return_lse=True)
    K.reset_launches()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=q_off,
                                 window=win, sm_scale=scale)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, q_off, win,
                                       scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention_dq": 1, "flash_attention_dkv": 1}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_is_deterministic(dev, dtype, window, D):
    """dk/dv are summed over the G heads and every q tile inside one block,
    in one order and without atomics, and dq over its key tiles the same
    way: two calls give the same bits."""
    B, S, H, KV = 2, 1000, 16, 4
    g = torch.Generator(device=dev).manual_seed(10)
    q, do = _rn(g, dev, dtype, B, S, H, D), _rn(g, dev, dtype, B, S, H, D)
    k, v = _rn(g, dev, dtype, B, S, KV, D), _rn(g, dev, dtype, B, S, KV, D)
    q_off = fa._positions(0, B, dev)
    out, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    kw = dict(q_off=q_off, window=window, sm_scale=1 / math.sqrt(D))
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_forward_is_deterministic(dev, dtype, D):
    """Each output row is one block's, summed over its key tiles in one
    order: two calls give the same bits, out and lse."""
    B, S, H, KV = 2, 1000, 16, 4
    g = torch.Generator(device=dev).manual_seed(12)
    q = _rn(g, dev, dtype, B, S, H, D)
    k, v = _rn(g, dev, dtype, B, S, KV, D), _rn(g, dev, dtype, B, S, KV, D)
    first = fa.flash_attention(q, k, v, window=300, return_lse=True)
    second = fa.flash_attention(q, k, v, window=300, return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [
    # B, S, H, KV, D, window: G above the fp32 kernels' 16
    (1, 70, 24, 1, 64, 0),                   # G = 24: 2 queries a tile
    (2, 40, 64, 1, 128, 0),                  # G = 64: 1 query a tile
    (2, 50, 48, 2, 32, 7),                   # G = 24, window 7
])
def test_flash_large_groups_on_the_tensor_cores(dev, dtype, shape):
    """bf16/fp16 forward and backward at G up to 64 (a 64-row tile holds
    64 / G queries), against the plain versions."""
    B, S, H, KV, D, win = shape
    g = torch.Generator(device=dev).manual_seed(13)
    q, do = _rn(g, dev, dtype, B, S, H, D), _rn(g, dev, dtype, B, S, H, D)
    k, v = _rn(g, dev, dtype, B, S, KV, D), _rn(g, dev, dtype, B, S, KV, D)
    q_off = fa._positions(0, B, dev)
    scale = 1 / math.sqrt(D)
    out, lse = fa.flash_attention(q, k, v, window=win, return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, win, scale,
                                             True)
    assert (out.float() - want.float()).abs().max() <= TOL[dtype]
    assert (lse - want_lse).abs().max() <= 1e-4
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=q_off,
                                 window=win, sm_scale=scale)
    wantb = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, q_off, win,
                                        scale)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, wantb):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), name


def test_flash_backward_takes_unaligned_views(dev):
    """Contiguous views that start at an odd element (a TMA tensor map
    needs 16-byte alignment) give the same gradients as aligned copies."""
    B, S, H, KV, D = 1, 70, 8, 2, 64
    g = torch.Generator(device=dev).manual_seed(11)
    flat = lambda n: _rn(g, dev, torch.bfloat16, n + 1)[1:]
    q, do = (flat(B * S * H * D).view(B, S, H, D) for _ in range(2))
    k, v = (flat(B * S * KV * D).view(B, S, KV, D) for _ in range(2))
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    kw = dict(q_off=fa._positions(0, B, dev), sm_scale=1 / math.sqrt(D))
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = fa.flash_attention_bwd(*(t.clone() for t in (q, k, v, out, lse,
                                                         do)), **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name


def test_flash_attention_autograd_launches_the_kernels(dev):
    """Gradients through ``flash_attention`` on the card: one forward, one
    dq and one dk/dv launch, and the einsum path's gradients in fp32."""
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(2, 33, 12, 64, generator=g, device=dev),
               torch.randn(2, 33, 4, 64, generator=g, device=dev),
               torch.randn(2, 33, 4, 64, generator=g, device=dev))
    cot = torch.randn(2, 33, 12, 64, generator=g, device=dev)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    K.reset_launches()
    out = fa.flash_attention(*qkv, window=5)
    got = torch.autograd.grad((out * cot).sum(), qkv)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention": 1, "flash_attention_dq": 1,
                          "flash_attention_dkv": 1}
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    pos = torch.arange(33, device=dev)
    keep = (pos[None] <= pos[:, None]) & (pos[:, None] - pos[None] < 5)
    qg = qkv[0].reshape(2, 33, 4, 3, 64)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, qkv[1]) / 8.0
    p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, qkv[2]).reshape(2, 33, 12, 64)
    want = torch.autograd.grad((o * cot).sum(), qkv)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_flash_backward_plain_version_gradcheck(dev):
    """The plain forward and backward, composed as a Function, against
    finite differences in fp64 on the card: G = 3, a window, a ragged
    key length and a vector q_off."""
    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = ref.flash_attention_ref(q, k, v, q_off, 3, 0.25, True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            return ref.flash_attention_bwd_ref(q, k, v, out, lse, do, q_off,
                                               3, 0.25)

    g = torch.Generator(device=dev).manual_seed(10)
    f64 = dict(dtype=torch.float64, device=dev, generator=g)
    q_off = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    q = torch.randn(2, 5, 6, 4, **f64).requires_grad_(True)
    k = torch.randn(2, 7, 2, 4, **f64).requires_grad_(True)
    v = torch.randn(2, 7, 2, 4, **f64).requires_grad_(True)
    assert torch.autograd.gradcheck(PlainFlash.apply, (q, k, v))


# slots, pages of 16 a lane, positions: a short lane, the serve shape (1 K
# lanes at positions 64..1000) and a long lane of 8 K keys (many chunks)
LANES = {"short": (4, 8, [0, 15, 77, 127]),
         "serve": (8, 64, [64, 200, 333, 480, 512, 700, 871, 1000]),
         "long": (8, 512, [0, 511, 1024, 2047, 4095, 5000, 7777, 8191])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("block_k,window", [(8, 0), (16, 7), (512, 0)])
@pytest.mark.parametrize("H,KV,D", [(8, 2, 64), (20, 20, 128), (16, 2, 128),
                                    (12, 1, 128), (16, 1, 64), (96, 8, 128),
                                    (40, 8, 128)])
# G = 4, 1, 8, 12, 16; mistral-large-123b's 12 and llama4-scout's 5
@pytest.mark.parametrize("lane", sorted(LANES))
def test_flash_decode_kernels(dev, dtype, block_k, window, H, KV, D, lane):
    g = torch.Generator(device=dev).manual_seed(1)
    ps = 16
    B, NP, positions = LANES[lane]
    P = B * NP + 1
    q = _rn(g, dev, dtype, B, 1, H, D)
    kp, vp = _rn(g, dev, dtype, P, ps, KV, D), _rn(g, dev, dtype, P, ps, KV, D)
    tables = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, NP).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    scale = 1 / math.sqrt(D)
    K.reset_launches()
    got = fa.flash_decode(q, lk, lv, pos, window=window, block_k=block_k)
    want = ref.flash_decode_ref(q, lk, lv, pos, window, scale, block_k)
    paged = fa.flash_decode_paged(q, kp, vp, tables, pos, page_size=ps,
                                  window=window)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_decode": 1, "flash_decode_paged": 1,
                          "flash_decode_combine": 2}
    assert (got.float() - want.float()).abs().max() <= TOL[dtype]
    assert torch.equal(paged, fa.flash_decode(q, lk, lv, pos, window=window,
                                              block_k=ps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_is_deterministic(dev, dtype, paged):
    """Two calls at the long lane agree bit for bit: the combine merges the
    chunks in order, with no atomics."""
    g = torch.Generator(device=dev).manual_seed(6)
    B, NP, positions = LANES["long"]
    ps, H, KV, D = 16, 32, 8, 64
    P = B * NP + 1
    q = _rn(g, dev, dtype, B, 1, H, D)
    kp, vp = _rn(g, dev, dtype, P, ps, KV, D), _rn(g, dev, dtype, P, ps, KV, D)
    tables = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, NP).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    if paged:
        call = lambda: fa.flash_decode_paged(q, kp, vp, tables, pos,
                                             page_size=ps, window=3000)
    else:
        lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
        call = lambda: fa.flash_decode(q, lk, lv, pos, window=3000)
    assert torch.equal(call(), call())


@pytest.mark.parametrize("window", [0, 150])
def test_decode_combine_kernel_reads_only_live_chunks(dev, window):
    """The combine kernel against its plain version on partials whose dead
    chunks hold NaN (the split kernel does not write them)."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, KV, ns, G, D, chunk = 4, 2, 6, 3, 64, 64
    kv_len = ns * chunk - 10
    pos = torch.tensor([0, 63, 200, 373], dtype=torch.int32, device=dev)
    m = torch.randn(B, KV, ns, G, generator=g, device=dev)
    l = torch.rand(B, KV, ns, G, generator=g, device=dev) + 0.5
    acc = torch.randn(B, KV, ns, G, D, generator=g, device=dev)
    j = torch.arange(ns, device=dev)[None]
    lo = j * chunk
    hi = torch.minimum((j + 1) * chunk, pos[:, None].long() + 1).clamp(
        max=kv_len)
    if window:
        lo = torch.maximum(lo, pos[:, None].long() - window + 1)
    dead = ~(lo < hi)[:, None, :, None]
    m, l = m.masked_fill(dead, float("nan")), l.masked_fill(dead, float("nan"))
    acc = acc.masked_fill(dead[..., None], float("nan"))
    want = ref.combine_live_splits(m, l, acc, pos, window, chunk, kv_len)
    for dtype in (torch.float32, torch.bfloat16):
        K.reset_launches()
        got = fa.decode_combine(m, l, acc, pos, chunk=chunk, kv_len=kv_len,
                                window=window, dtype=dtype)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {"flash_decode_combine": 1}
        assert torch.isfinite(got).all()
        assert (got.float() - want.to(dtype).float()).abs().max() <= TOL[dtype]


def _sampler_inputs(g, dev, dtype, S, C, V, case):
    """Logits, one-hot, temperatures and noise for one sampler case:
    random rows; equal maxima on both sides of every slice boundary of the
    plan (temperature 1, no noise, so both argmaxes tie); a slot whose
    selected row is all -inf and one whose row is half -inf; or logits and
    noise as views whose row start is off a 16-byte boundary."""
    lg = _rn(g, dev, dtype, S, C, V)
    sel = torch.randint(0, C, (S,), generator=g, device=dev)
    oh = torch.nn.functional.one_hot(sel, C).float()
    T = torch.rand(S, generator=g, device=dev) + 0.05
    u = torch.rand(S, V, generator=g, device=dev).clamp_min(1e-30)
    nz = -torch.log(-torch.log(u))
    if case == "ties":
        _, sl = sg.sampler_plan(S, C, V, K.sm_count(0))
        lg = torch.zeros_like(lg)
        for b in range(sl, V, sl):
            lg[..., b - 1:b + 1] = 3.0
        T, nz = torch.ones_like(T), torch.zeros_like(nz)
    elif case == "neg_inf":
        slots = torch.arange(S, device=dev)
        lg[0, sel[0]] = -float("inf")
        lg[slots[1:], sel[1:], : V // 2] = -float("inf")
    elif case == "unaligned":
        lg = torch.empty(lg.numel() + 1, dtype=dtype, device=dev)[1:] \
            .view(S, C, V).copy_(lg)
        nz = torch.empty(nz.numel() + 1, device=dev)[1:].view(S, V).copy_(nz)
    return lg, oh, T, nz


@pytest.mark.parametrize("case", ["random", "ties", "neg_inf", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("S,C,V", [(8, 1, 128256), (1, 32, 128256),
                                   (8, 1, 151936), (1, 32, 151936),
                                   (3, 5, 1000),
                                   (2, 3, 1537),       # V % 8 != 0: scalar loads
                                   (8, 1, 32001),      # hymba-1.5b's vocab:
                                   (1, 128, 32001),    # scalar loads too
                                   (8, 1, 50280),      # mamba2-1.3b's
                                   (8, 1, 256000),     # minitron-8b's,
                                   (1, 32, 256000),    # llama4-scout's,
                                   (8, 1, 202048),     # mistral-large-
                                   (1, 32, 202048),    # 123b's
                                   (8, 1, 32768),
                                   (1, 32, 32768)])
def test_slot_gather_kernel_exact(dev, dtype, S, C, V, case):
    """The one-launch sampler equals the plain version bit for bit, on
    every load path (16-byte and scalar), and two calls agree."""
    g = torch.Generator(device=dev).manual_seed(2)
    lg, oh, T, nz = _sampler_inputs(g, dev, dtype, S, C, V, case)
    K.reset_launches()
    got = sg.slot_gather_sample(lg, oh, T, nz)
    again = sg.slot_gather_sample(lg, oh, T, nz)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"slot_gather_sample": 2}
    want = ref.slot_gather_sample_ref(lg, oh, T, nz)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case == "ties" and sg.sampler_plan(S, C, V, K.sm_count(0))[0] > 1:
        first = sg.sampler_plan(S, C, V, K.sm_count(0))[1] - 1
        assert (got[0] == first).all() and (got[1] == first).all()


@pytest.mark.parametrize("D", [16, 24, 48, 96, 192, 256])
def test_unsupported_head_dim_is_refused_by_name(dev, D):
    """A head dim the kernels are not built for: up to 128 every flash
    entry computes it (padded to the next of 32, 64, 128), and 192 and
    256 the forward and backward compute on the MLA route (padded to
    (576, 512)), each within its tolerance of the plain version, in bf16
    and fp32. The decode above 128 raises NotImplementedError naming the
    dim and ROADMAP queue 2; so does every entry past Dk 576 / Dv 512 or
    G 16 on the MLA route, naming what it exceeds."""
    g = torch.Generator(device=dev).manual_seed(D)
    if D > 128:
        x = torch.zeros(1, 4, 2, D, device=dev, dtype=torch.bfloat16)
        pos = torch.zeros(1, dtype=torch.int32, device=dev)
        refused = f"head_dim {D} .*queue 2"
        with pytest.raises(NotImplementedError, match=refused):
            fa.flash_decode(x[:, :1], x, x, pos)
        with pytest.raises(NotImplementedError, match=refused):
            fa.flash_decode_paged(x[:, :1], x, x,
                                  torch.zeros(1, 1, dtype=torch.int32,
                                              device=dev), pos, page_size=4)
        lse, di = torch.zeros(1, 4, 2, device=dev), torch.zeros(1, 4, 2,
                                                                device=dev)
        for dk, dv in ((577, 512), (576, 513)):
            q, k = (torch.zeros(1, 4, 2, dk, device=dev, dtype=torch.bfloat16)
                    for _ in range(2))
            v = torch.zeros(1, 4, 2, dv, device=dev, dtype=torch.bfloat16)
            do = torch.zeros(1, 4, 2, dv, device=dev, dtype=torch.bfloat16)
            big = f"Dk={dk}, Dv={dv} are more than"
            with pytest.raises(NotImplementedError, match=big):
                fa.flash_attention(q, k, v)
            with pytest.raises(NotImplementedError, match=big):
                fa.flash_attention_dq(q, k, v, lse, do, di, q_off=pos,
                                      sm_scale=1.)
            with pytest.raises(NotImplementedError, match=big):
                fa.flash_attention_dkv(q, k, v, lse, do, di, q_off=pos,
                                       sm_scale=1.)
        q17 = torch.zeros(1, 4, 17, D, device=dev, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="G = 17 > 16.*MLA"):
            fa.flash_attention(q17, x[:, :, :1], x[:, :, :1])
    for dtype in (torch.bfloat16, torch.float32):
        B, S, H, KV, win = 2, 100, 8, 2, 33
        q, k, v = (_rn(g, dev, dtype, B, S, H, D), _rn(g, dev, dtype, B, S, KV, D),
                   _rn(g, dev, dtype, B, S, KV, D))
        do = _rn(g, dev, dtype, B, S, H, D)
        q_off = fa._positions([0, 7], B, dev)
        scale = 1 / math.sqrt(D)
        K.reset_launches()
        out, lse = fa.flash_attention(q, k, v, q_off=q_off, window=win,
                                      return_lse=True)
        want, want_lse = ref.flash_attention_ref(q, k, v, q_off, win, scale,
                                                 True)
        assert out.shape == want.shape and out.is_contiguous()
        assert (out.float() - want.float()).abs().max() <= TOL[dtype]
        assert (lse - want_lse).abs().max() <= 1e-3
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=q_off,
                                       window=win, sm_scale=scale)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, q_off, win,
                                            scale)
        for name, a, b in zip(("dq", "dk", "dv"), grads, wants):
            assert a.shape == b.shape and a.dtype == dtype, name
            err = (a.float() - b.float()).abs().max().item()
            assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), name
        if D > 128:
            torch.cuda.synchronize()
            assert K.LAUNCHES == _mla_launches(dtype)
            continue
        ps, NP = 16, 8
        pos = torch.tensor([5, 127], dtype=torch.int32, device=dev)
        kp, vp = (_rn(g, dev, dtype, B * NP + 1, ps, KV, D) for _ in range(2))
        tables = (torch.randperm(B * NP, generator=g, device=dev) + 1).reshape(
            B, NP).to(torch.int32)
        lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
        got = fa.flash_decode(q[:, :1], lk, lv, pos, window=win)
        want = ref.flash_decode_ref(q[:, :1], lk, lv, pos, win, scale, 128)
        assert (got.float() - want.float()).abs().max() <= TOL[dtype]
        paged = fa.flash_decode_paged(q[:, :1], kp, vp, tables, pos,
                                      page_size=ps, window=win)
        assert torch.equal(paged, fa.flash_decode(q[:, :1], lk, lv, pos,
                                                  window=win, block_k=ps))
        torch.cuda.synchronize()
        assert K.LAUNCHES["flash_attention"] == 1
        assert K.LAUNCHES["flash_attention_dq"] == 1
        assert K.LAUNCHES["flash_attention_dkv"] == 1
        assert K.LAUNCHES["flash_decode_paged"] == 1
        assert K.LAUNCHES["flash_decode"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [
    # B, S, H, KV, Dk, Dv, window, q_off
    (2, 100, 4, 1, 80, 64, 0, (0, 5)),     # the smoke config's layout
    (1, 77, 8, 2, 80, 64, 7, (3, 0)),      # KV 2, window, ragged
    (1, 64, 16, 1, 96, 64, 0, (0, 0)),     # a built pair unpadded
    (1, 200, 16, 1, 576, 512, 0, (0, 0)),  # DeepSeek-V2-Lite, G 16
    (2, 129, 16, 1, 576, 512, 50, (0, 9)),
    (1, 70, 4, 1, 300, 200, 0, (0, 0)),    # padded up to (576, 512)
])
def test_mla_route_kernels(dev, dtype, shape):
    """The MLA-route forward (out, lse), dq and dk/dv against their plain
    versions, each launched once (bf16/fp16: all three on the tensor
    cores, dk/dv's reduction launched once too); two forward and two
    backward calls bitwise equal (no atomics; the chunks' partials summed
    in a fixed order)."""
    B, S, H, KV, Dk, Dv, win, off = shape
    g = torch.Generator(device=dev).manual_seed(S + Dk)
    q, k = _rn(g, dev, dtype, B, S, H, Dk), _rn(g, dev, dtype, B, S, KV, Dk)
    v, do = _rn(g, dev, dtype, B, S, KV, Dv), _rn(g, dev, dtype, B, S, H, Dv)
    q_off = fa._positions(list(off[:B]), B, dev)
    scale = 1 / math.sqrt(Dk)
    K.reset_launches()
    out, lse = fa.flash_attention(q, k, v, q_off=q_off, window=win,
                                  sm_scale=scale, return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, win, scale, True)
    assert out.shape == (B, S, H, Dv) and out.dtype == dtype
    assert (out.float() - want.float()).abs().max() <= TOL[dtype]
    assert (lse - want_lse).abs().max() <= 1e-3
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=q_off,
                                   window=win, sm_scale=scale)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, q_off, win,
                                        scale)
    for name, a, b in zip(("dq", "dk", "dv"), grads, wants):
        assert a.shape == b.shape and a.dtype == dtype, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item(), name
    torch.cuda.synchronize()
    assert K.LAUNCHES == _mla_launches(dtype)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, q_off=q_off,
                                   window=win, sm_scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    out2, lse2 = fa.flash_attention(q, k, v, q_off=q_off, window=win,
                                    sm_scale=scale, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [
    # B, Sq, Sk, H, KV, Dk, Dv, window, q_off
    (2, 1024, 1024, 16, 1, 576, 512, 0, (0, 0)),   # DeepSeek-V2-Lite's
    (2, 1000, 1000, 16, 1, 576, 512, 300, (0, 0)),
    (1, 200, 200, 24, 2, 576, 512, 0, (0,)),       # G 12 over KV 2: spare rows
    (2, 100, 300, 16, 1, 576, 512, 0, (200, 150)), # Sq < Sk, q offsets
    (2, 70, 333, 12, 1, 576, 512, 64, (263, 40)),  # G 12, a window, ragged
    (2, 45, 130, 4, 1, 80, 64, 7, (85, 3)),        # padded, Sq < Sk
])
def test_mla_forward_tensor_cores(dev, dtype, shape):
    """The MLA route's bf16/fp16 forward (``fwd_mla_hopper``) against its
    plain version: out within 1e-2, lse within 1e-3; one launch; two calls
    bitwise equal."""
    B, Sq, Sk, H, KV, Dk, Dv, win, off = shape
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + Dk)
    q, k = _rn(g, dev, dtype, B, Sq, H, Dk), _rn(g, dev, dtype, B, Sk, KV, Dk)
    v = _rn(g, dev, dtype, B, Sk, KV, Dv)
    q_off = fa._positions(list(off), B, dev)
    scale = 1 / math.sqrt(Dk)
    kw = dict(q_off=q_off, window=win, sm_scale=scale, return_lse=True)
    K.reset_launches()
    out, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention_mla": 1}
    want, want_lse = ref.flash_attention_ref(q, k, v, q_off, win, scale, True)
    assert out.shape == (B, Sq, H, Dv) and out.dtype == dtype
    assert (out.float() - want.float()).abs().max() <= TOL[dtype]
    assert (lse - want_lse).abs().max() <= 1e-3
    out2, lse2 = fa.flash_attention(q, k, v, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("window,off", [(0, (0, 0)), (40, (0, 37))])
def test_mla_dkv_reduce_reads_only_live_chunks(dev, window, off):
    """The dk/dv reduction alone, on partials whose dead chunks hold NaN
    (a dead chunk is never written): equal to its plain version bit for
    bit (both sum the live chunks from 0 in chunk order), one launch."""
    B, S, H, KV, Dk, Dv = 2, 300, 16, 1, 576, 512
    q_off = fa._positions(list(off), B, dev)
    bq = fa.MLA_DKV_ROWS // (H // KV)
    nq, rows, chunk = -(-S // bq), B * S * KV, 3
    n = -(-nq // chunk)
    n_live = torch.tensor(
        [[-(-fa.mla_dkv_live(key // fa.MLA_DKV_KEYS, o, window, nq, bq)[1]
            // chunk)
          for key in range(S)] for o in off], device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    part = torch.randn(n, rows * (Dk + Dv), generator=g, device=dev)
    part_k = part[:, :rows * Dk].view(n, B, S, KV, Dk)
    part_v = part[:, rows * Dk:].view(n, B, S, KV, Dv)
    dead = torch.arange(n, device=dev)[:, None, None] >= n_live[None]
    for t in (part_k, part_v):
        t.masked_fill_(dead[..., None, None], float("nan"))
    K.reset_launches()
    got = fa.mla_dkv_reduce(part.reshape(-1), q_off, B=B, Sq=S, Sk=S, H=H,
                            KV=KV, Dk=Dk, Dv=Dv, window=window, chunk=chunk,
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention_mla_dkv_reduce": 1}
    want = ref.mla_dkv_reduce_ref(part_k, part_v, n_live, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.isfinite(a.float()).all() for a in got)


def test_mla_tensor_core_forward_sass(dev):
    """The built forward (bf16, fp16) holds wgmma products (HGMMA) and TMA
    loads (UTMALDG), no atomic, and spills nothing (``ptxas -v``)."""
    import re
    K.build_all(("flash_attention",))
    ops = K.sass_ops("flash_attention", r"fwd_mla_hopper")
    assert len(ops) == 2, sorted(ops)
    assert all(o["HGMMA"] > 0 and o["UTMALDG"] > 0 and o["atomics"] == 0
               for o in ops.values()), ops
    lines = K.build_log("flash_attention").splitlines()
    seen = 0
    for n, line in enumerate(lines):
        if re.search(r"Compiling entry function '\w*fwd_mla_hopper", line):
            props = " ".join(lines[n + 1:n + 4])
            assert "0 bytes spill stores, 0 bytes spill loads" in props, props
            seen += 1
    assert seen == 2


def test_mla_tensor_core_backward_sass(dev):
    """The built dq, dk/dv (bf16, fp16) hold wgmma products (HGMMA) and TMA
    loads (UTMALDG), and no kernel of the MLA backward on the tensor
    cores (the reduction included) holds an atomic."""
    K.build_all(("flash_attention",))
    ops = K.sass_ops("flash_attention",
                     r"bwd_dq_mla_hopper|bwd_dkv_mla_hopper|mla_dkv_reduce")
    products = [n for n in ops if "mla_hopper" in n]
    assert len(ops) == 6 and len(products) == 4, sorted(ops)
    assert all(ops[n]["HGMMA"] > 0 and ops[n]["UTMALDG"] > 0
               for n in products), ops
    assert all(o["atomics"] == 0 for o in ops.values()), ops


def test_mla_forward_and_decoder_on_the_card(dev):
    """The smoke DeepSeek-V2-Lite (MLA + MoE) on the card in fp32: the
    loss and every leaf gradient through the kernels equal the einsum
    attention's within 1e-4 of each leaf's scale, and the three MLA
    kernels launch as remat predicts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import with_attn_impl
    from repro_torch.models import build_model
    from repro_torch.tree import flatten, unflatten
    cfg = get_smoke_config("deepseek-v2-lite-16b").with_overrides(
        dtype="float32", remat=True)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), device=dev,
                           generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    master = build_model(cfg, dev).init(1)
    leaves, treedef = flatten(master)
    out = {}
    for impl in ("flash", "ref"):
        ps = [t.detach().requires_grad_(True) for t in leaves]
        K.reset_launches()
        loss, _ = build_model(with_attn_impl(cfg, impl), dev).loss_fn(
            unflatten(treedef, ps), batch)
        out[impl] = (loss, torch.autograd.grad(loss, ps), dict(K.LAUNCHES))
    L = cfg.num_layers
    assert out["flash"][2] == {"flash_attention_mla": 2 * L,
                               "flash_attention_mla_dq": L,
                               "flash_attention_mla_dkv": L}
    assert out["ref"][2] == {}
    assert abs(out["flash"][0].item() - out["ref"][0].item()) <= 1e-4
    for a, b in zip(out["flash"][1], out["ref"][1]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-6)


def test_group_size_limits_name_the_path(dev):
    """G above 16 runs in bf16/fp16 (tensor cores) and is refused in fp32
    and by the decode; above 64 it is refused everywhere."""
    q = torch.zeros(1, 4, 17, 64, device=dev)
    kv = torch.zeros(1, 4, 1, 64, device=dev)
    with pytest.raises(NotImplementedError, match="G = 17 > 16"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="G = 17 > 16"):
        fa.flash_decode(q[:, :1].bfloat16(), kv.bfloat16(), kv.bfloat16(), 3)
    fa.flash_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
    q65 = torch.zeros(1, 4, 65, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="G = 65 > 64"):
        fa.flash_attention(q65, kv.bfloat16(), kv.bfloat16())


@pytest.mark.parametrize("arch,head_dim", [("llama3.2-1b", None),
                                           ("qwen1.5-4b", 128)])
def test_engine_on_the_card_launches_every_kernel(dev, arch, head_dim):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, SamplingParams
    cfg = get_smoke_config(arch)
    if head_dim:
        cfg = cfg.with_overrides(attention=dataclasses.replace(
            cfg.attention, head_dim=head_dim))
    model = build_model(cfg, dev)
    params = model.init(0)
    for page_size, kernel in ((16, "flash_decode_paged"), (0, "flash_decode")):
        eng = Engine(model, params, max_slots=2, max_seq=64, prefill_chunk=16,
                     page_size=page_size, fused_sampling=True, device=dev)
        K.reset_launches()
        for n in (5, 20, 9):
            eng.submit(list(range(1, n + 1)), 4,
                       SamplingParams(temperature=0.5 * (n % 2), seed=n))
        res = eng.run()
        assert all(len(t) == 4 for t in res.values())
        for name in ("flash_attention", kernel, "slot_gather_sample"):
            assert K.LAUNCHES.get(name, 0) > 0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_chaos_shape(dev, dtype):
    """The serve chaos loop's decode: 4 slots over 64-key lanes in pages of
    8 (one chunk a lane, longer than the lane), 32 heads over 8, D 64."""
    g = torch.Generator(device=dev).manual_seed(21)
    B, NP, ps, H, KV, D = 4, 8, 8, 32, 8, 64
    P = B * NP + 1
    q = _rn(g, dev, dtype, B, 1, H, D)
    kp, vp = _rn(g, dev, dtype, P, ps, KV, D), _rn(g, dev, dtype, P, ps, KV, D)
    tables = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, NP).to(torch.int32)
    pos = torch.tensor([5, 17, 40, 63], dtype=torch.int32, device=dev)
    lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    paged = fa.flash_decode_paged(q, kp, vp, tables, pos, page_size=ps)
    want = ref.flash_decode_paged_ref(q, kp, vp, tables, pos, 0,
                                      1 / math.sqrt(D), ps)
    assert (paged.float() - want.float()).abs().max() <= TOL[dtype]
    assert torch.equal(paged, fa.flash_decode(q, lk, lv, pos, block_k=ps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_hymbas_windowed_shape(dev, dtype):
    """hymba-1.5b's decode on a sliding layer: 8 slots over 2 K lanes in
    pages of 16, positions on both sides of the 1024-key window, 25 heads
    over 5, D 64; and its prefill chunk of 128 queries past the window."""
    g = torch.Generator(device=dev).manual_seed(25)
    B, NP, ps, H, KV, D, W = 8, 128, 16, 25, 5, 64, 1024
    P = B * NP + 1
    q = _rn(g, dev, dtype, B, 1, H, D)
    kp, vp = _rn(g, dev, dtype, P, ps, KV, D), _rn(g, dev, dtype, P, ps, KV, D)
    tables = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, NP).to(torch.int32)
    pos = torch.tensor([100, 700, 1023, 1024, 1100, 1400, 1700, 2047],
                       dtype=torch.int32, device=dev)
    lk, lv = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    scale = 1 / math.sqrt(D)
    K.reset_launches()
    got = fa.flash_decode(q, lk, lv, pos, window=W)
    paged = fa.flash_decode_paged(q, kp, vp, tables, pos, page_size=ps,
                                  window=W)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_decode": 1, "flash_decode_paged": 1,
                          "flash_decode_combine": 2}
    want = ref.flash_decode_ref(q, lk, lv, pos, W, scale, 512)
    assert (got.float() - want.float()).abs().max() <= TOL[dtype]
    assert torch.equal(paged, fa.flash_decode(q, lk, lv, pos, window=W,
                                              block_k=ps))
    # the window changes the answer past position 1023
    full = ref.flash_decode_ref(q, lk, lv, pos, 0, scale, 512)
    assert torch.equal(want[:3], full[:3]) and not torch.equal(want[4:],
                                                               full[4:])
    qc = _rn(g, dev, dtype, 1, 128, H, D)
    q_off = torch.tensor([1280], dtype=torch.int32, device=dev)
    out = fa.flash_attention(qc, lk[:1], lv[:1], q_off=q_off, window=W)
    want = ref.flash_attention_ref(qc, lk[:1], lv[:1], q_off, W, scale)
    assert (out.float() - want.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_engines_on_the_card(dev, arch):
    """The smoke mamba2 (slot-granular, sampler alone) and hymba (paged
    attention + SSM lanes, then contiguous) engines on the card: the
    kernels launch, every request finishes, and a greedy request gives
    the tokens ``generate`` gives it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, SamplingParams
    from repro_torch.train.serve import generate
    cfg = get_smoke_config(arch).with_overrides(num_layers=3, dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(0)
    prompt = list(range(3, 44))
    want = generate(model, params, [prompt], max_new=6)[0, 41:].tolist()
    for page_size in (16, 0):
        eng = Engine(model, params, max_slots=2, max_seq=96, prefill_chunk=16,
                     page_size=page_size, fused_sampling=True, device=dev)
        assert eng.paged == (page_size > 0 and arch == "hymba-1.5b")
        K.reset_launches()
        rid = eng.submit(prompt, 6)
        for n in (5, 20, 9):
            eng.submit(list(range(1, n + 1)), 4,
                       SamplingParams(temperature=0.5, seed=n))
        res = eng.run()
        assert res[int(rid)] == want
        assert all(len(t) in (4, 6) for t in res.values())
        names = {"slot_gather_sample"}
        if arch == "hymba-1.5b":
            names |= {"flash_attention", "flash_decode_combine",
                      "flash_decode_paged" if eng.paged else "flash_decode"}
        assert set(K.LAUNCHES) == names


def test_chaos_on_the_card_replays_and_restores(dev):
    """The serve chaos loop at the reference CLI's plan and engine shape,
    smoke llama3.2-1b with fused sampling: the CLI's counts, one decode
    signature, bitwise replay, drain -> restore bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.fault.inject import FaultPlan
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, chaos
    cfg = get_smoke_config("llama3.2-1b")
    model = build_model(cfg, dev)
    params = model.init(0)

    def make(**over):
        return Engine(model, params, max_slots=4, max_seq=64,
                      prefill_chunk=8, page_size=8, max_queue=16,
                      shed_policy="reject-no-deadline", fused_sampling=True,
                      device=dev, **over)
    plan = FaultPlan.from_spec(
        "qflood:6@3,stall:8@6x4,cancel:1@9,pagepress:12@10x8", seed=0)
    res, _ = chaos.verify_replay(make, plan, n_base=8, max_steps=300,
                                 vocab=cfg.vocab_size, max_seq=64)
    s = res["stats"]
    assert (s["submitted"], s["shed"], s["cancelled"], s["deadline_misses"],
            s["goodput_tokens"], s["decoded_tokens"], s["steps"],
            s["watchdog_stalls"]) == (14, 3, 1, 6, 38, 48, 18, 1)
    assert res["decode_compiles"] == 1
    assert chaos.verify_drain_restore(make, seed=0, vocab=cfg.vocab_size,
                                      max_seq=64)["requeued"]


# ---------------------------------------------------------------------------
# training kernels: exact against their plain versions
# ---------------------------------------------------------------------------

def _offset(t, off):
    """``t`` copied into a buffer at element offset ``off``: a contiguous
    view whose start is off the 16-byte grid when ``off`` is odd."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k,n", [(1, 5), (2, 4096), (3, 1001), (8, 77),
                                 (2, 18_874_371)])
@pytest.mark.parametrize("off", [0, 1])
def test_chunk_sum_kernel_exact(dev, dtype, k, n, off):
    g = torch.Generator(device=dev).manual_seed(3)
    x = _offset(_rn(g, dev, dtype, k, n), off)
    K.reset_launches()
    got = cs.chunk_sum(x)
    want = ref.chunk_sum_ref(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"chunk_sum": 1}
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("n,off", [(1, 0), (4099, 0), (4099, 1),
                                   (37_748_736, 0)])
def test_fp16_casts_exact(dev, n, off):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, generator=g, device=dev) * 300
    special = torch.tensor([65504.0, -65504.0, 65519.0, 65520.0, 1e6, -1e6,
                            6e-8, 3e-8, 2.9e-8, -6e-8, 1e-5, 0.0, -0.0,
                            float("inf"), -float("inf"), float("nan")],
                           device=dev)
    x[:min(n, special.numel())] = special[:n]
    x = _offset(x, off)
    h = qz.quant_fp16(x)
    want = ref.quant_fp16_ref(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(h), nan)
    assert torch.equal(h[~nan].view(torch.int16), want[~nan].view(torch.int16))
    hh = _offset(want, off)
    back = qz.dequant_fp16(hh)
    wb = ref.dequant_fp16_ref(hh)
    nan = torch.isnan(wb)
    assert torch.equal(torch.isnan(back), nan)
    assert torch.equal(back[~nan].view(torch.int32), wb[~nan].view(torch.int32))


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("n,off", [(3, 0), (4097, 0), (4097, 1)])
def test_fused_sgd_kernel_exact(dev, nesterov, n, off):
    g = torch.Generator(device=dev).manual_seed(5)
    p, gr, m = (_offset(torch.randn(n, generator=g, device=dev), off)
                for _ in range(3))
    lr = torch.tensor([0.0125], device=dev)
    got = fs.fused_sgd(p, gr, m, lr, 0.9, nesterov)
    want = ref.fused_sgd_ref(p, gr, m, lr, 0.9, nesterov)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got_f = fs.fused_sgd(p, gr, m, 0.0125, 0.9, nesterov)     # float lr
    assert all(torch.equal(a, b) for a, b in zip(got_f, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("k,s", [(1, 9), (2, 4096), (3, 1001), (4, 5003)])
@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_fused_rs_update_kernel_exact(dev, dtype, k, s, wd):
    g = torch.Generator(device=dev).manual_seed(6)
    if dtype == torch.int8:
        recv = torch.randint(-127, 128, (k, s), generator=g, device=dev).to(
            torch.int8)
        scales = torch.rand(k, generator=g, device=dev) * 0.01
    else:
        recv, scales = _rn(g, dev, dtype, k, s), None
    p, m = torch.randn(s, generator=g, device=dev), torch.randn(
        s, generator=g, device=dev)
    mask = (torch.rand(s, generator=g, device=dev) < 0.5).float()
    for nesterov, scale in ((False, 1.0 / k), (True, 1.0 / (k * 3))):
        K.reset_launches()
        got = fru.fused_rs_update(recv, p, m, 0.01, wd_mask=mask,
                                  scale=scale, momentum=0.9,
                                  nesterov=nesterov, weight_decay=wd,
                                  scales=scales)
        want = ref.fused_rs_update_ref(recv, p, m, mask, 0.01, 0.9, nesterov,
                                       scale, wd, scales)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {"fused_rs_update": 1}
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_fused_rs_update_equals_chunk_sum_then_fused_sgd(dev, dtype):
    """The fused tail against the unfused pipeline of the sharded path:
    chunk_sum, the mean, weight decay on the mask, fused_sgd."""
    g = torch.Generator(device=dev).manual_seed(7)
    k, s, wd = 2, 9437, 5e-4
    recv = _rn(g, dev, dtype, k, s)
    p, m = torch.randn(s, generator=g, device=dev), torch.randn(
        s, generator=g, device=dev)
    mask = (torch.arange(s, device=dev) < 6000).float()
    fused = fru.fused_rs_update(recv, p, m, 0.02, wd_mask=mask, scale=1 / k,
                                momentum=0.9, weight_decay=wd)
    gsum = cs.chunk_sum(recv) * (1 / k) + wd * mask * p
    unfused = fs.fused_sgd(p, gsum, m, 0.02, 0.9, False)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))


def test_training_kernels_raise_on_mixed_devices(dev):
    x = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError, match="cpu"):
        fru.fused_rs_update(x, torch.zeros(8), torch.zeros(8, device=dev),
                            0.1)
    with pytest.raises(ValueError, match="cpu"):
        fs.fused_sgd(torch.zeros(8, device=dev), torch.zeros(8),
                     torch.zeros(8, device=dev), 0.1)


# ---------------------------------------------------------------------------
# blockwise int8, the convnets and the ring on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,off", [(1, 0), (2048, 0), (5000, 0), (5000, 1),
                                   (65536 + 7, 0), (37_748_736, 0)])
def test_int8_kernels_exact(dev, n, off):
    from test_torch_ranks import int8_input
    x = _offset(int8_input(n, dev)[0], off)
    q, sc = qz.quant_int8(x)
    wq, ws = ref.quant_int8_ref(x)
    assert torch.equal(q, wq)
    assert torch.equal(sc.view(torch.int32), ws.view(torch.int32))
    qq = _offset(wq, off)
    back = qz.dequant_int8(qq, ws)
    assert torch.equal(back.view(torch.int32),
                       ref.dequant_int8_ref(qq, ws).view(torch.int32))


@pytest.mark.parametrize("absmax", [13 * 2.0 ** 18, 9 * 2.0 ** 18])
def test_int8_scale_at_an_fp32_tie(dev, absmax):
    """absmax * fp32(1/127) is an fp32 tie: the kernel's fma and the plain
    version's emulation of it must round the same way."""
    x = torch.zeros(3000, device=dev)
    x[5], x[9], x[2500] = absmax, -absmax / 3, 1.0
    q, sc = qz.quant_int8(x)
    wq, ws = ref.quant_int8_ref(x)
    assert torch.equal(q, wq)
    assert torch.equal(sc.view(torch.int32), ws.view(torch.int32))


@pytest.mark.parametrize("arch", ["vggnet", "googlenet"])
def test_convnet_forward_on_the_card_matches_the_cpu(dev, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import ImageSource
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(arch)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = {n: torch.from_numpy(v) for n, v in ImageSource(
        cfg.image_size, cfg.num_classes).batch(4, 0).items()}
    want = build_model(cfg, "cpu").loss_fn(params, batch)[0]
    want_logits = build_model(cfg, "cpu").forward(params, batch)
    gpu = build_model(cfg, dev)
    on = lambda t: tree_map(lambda a: a.to(dev), t)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False       # full fp32
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            got = gpu.loss_fn(on(params), on(batch))[0]
            logits = gpu.forward(on(params), on(batch))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    scale = want_logits.abs().max().item()
    assert (logits.cpu() - want_logits).abs().max().item() <= 1e-4 * scale
    assert abs(got.item() - want.item()) <= 1e-4 * abs(want.item())


def test_ring16_exchange_on_the_card(dev, tmp_path):
    import numpy as np

    from repro_torch.launch.train import run_ranks
    from repro_torch.tree import leaves
    from test_torch_ranks import ring_gpu_worker, value_tree
    run_ranks(ring_gpu_worker, 2, (str(tmp_path),))
    res = [torch.load(tmp_path / f"ring{r}.pt", weights_only=False)
           for r in range(2)]
    trees = [[t.numpy() for t in leaves(value_tree(100 + r))]
             for r in range(2)]
    for r in res:
        for got, a, b in zip(r["leaves"], *trees):
            want = (a + b) / 2
            scale = float(np.abs(np.stack([a, b])).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * scale)
        assert r["launches"]["quant_fp16"] > 0
        assert r["launches"]["quant_fp16"] == r["launches"]["dequant_fp16"]


def test_async_reduce_scatter_on_the_card(dev, tmp_path):
    """The overlap's staged all-to-all (pinned buffers, the helper
    thread, ``async_op`` gloo collectives) equals the synchronous
    reduce-scatter bit for bit on 2 ranks sharing the card."""
    from repro_torch.launch.train import run_ranks
    from test_torch_ranks import async_a2a_gpu_worker
    run_ranks(async_a2a_gpu_worker, 2, (str(tmp_path),))
    for r in range(2):
        res = torch.load(tmp_path / f"a2a{r}.pt", weights_only=False)
        counters = res.pop("counters")
        assert res and all(res.values()), res
        staged, _, wire, exposed = counters
        assert staged > 0 and wire > 0 and exposed >= 0
