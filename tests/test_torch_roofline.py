"""The port's roofline (``repro_torch.roofline.analysis``) against the JAX
package's, on the CPU.

- ``Roofline``, ``model_flops_6nd`` and ``attention_flops_bytes`` are
  copies: the same source, and equal outputs on a grid of causal,
  windowed, ``q_start`` and fwd+bwd shapes (``Roofline`` with both
  modules' peaks set alike).
- ``peaks()``: the H100's with no card, each value overridable, a card
  not in the table refused unless all three variables are set; no TPU
  v5e constant in the port.
- ``CostMode``: a 64x64 product at exactly 2 * 64^3 flops; views and
  ``empty`` move no bytes; ``c10d`` collectives by kind under the
  reference's rule (a gloo group of one made in place, not the default
  group); a copy across devices counted once on its device side and
  itemised by op, dtype, shape and direction; a counting fault leaves
  the op run once; a tiny step counts at
  least 3x its forward; ``kernels.cost`` adds a launch only under a mode.
- A tiny decoder's BSP step (the smoke llama3.2-1b in fp32, 4 x 32
  tokens, ``ref`` attention on both sides, JAX's step unrolled so XLA
  counts every layer): the count is at least 6·N·D and within 5 % of
  XLA's ``cost_analysis`` flops. Measured: 0.985 without remat, 0.986
  with; XLA also counts the elementwise ops (softmax, norms, rope, the
  loss, the SGD update), which the port's rule (``flop_counter``'s
  formulas: products and convolutions) leaves at zero.
- Every hand kernel's cost function at PERF.md §6's shapes gives that
  table's bound (max(bytes / 3.35 TB/s, flops / 989 TFLOP/s)) to the
  digits the table shows (at most 3).
- Every launch site (16) reports its cost function's flops and bytes
  under a ``CostMode``: the wrappers' CUDA path on CPU tensors with the
  library replaced by a recorder (``tests/test_torch_decode.py``'s
  fixture).
"""
import dataclasses
import inspect
import math
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.roofline import analysis as jan  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import chunk_sum as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_rs_update as fru  # noqa: E402
from repro_torch.kernels import fused_sgd as fs  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import slot_gather as sg  # noqa: E402
from repro_torch.roofline import analysis as tan  # noqa: E402

SMS = 132      # an H100 SXM's SMs (the plans' grids)


@pytest.fixture(autouse=True)
def _unsharded_jax():
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        yield


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Roofline", "model_flops_6nd",
                                  "attention_flops_bytes"])
def test_copies_have_the_reference_source(name):
    assert inspect.getsource(getattr(tan, name)) == inspect.getsource(
        getattr(jan, name))


GRID = [dict(batch=b, q_len=q, kv_len=kv, heads=h, kv_heads=kh,
             head_dim_k=dk, head_dim_v=dv, window=w, causal=c, q_start=qs,
             kind=kind, dtype_bytes=es)
        for b, q, kv, h, kh, dk, dv in ((1, 32, 1024, 32, 8, 64, 0),
                                        (2, 1024, 1024, 16, 1, 576, 512),
                                        (3, 100, 300, 12, 4, 48, 48))
        for w in (0, 64) for c in (True, False) for qs in (0, 992)
        for kind in ("fwd", "fwd+bwd") for es in (2, 4)]


@pytest.mark.parametrize("kw", GRID[::3] + [GRID[-1]])
def test_attention_flops_bytes_is_the_reference(kw):
    assert tan.attention_flops_bytes(**kw) == jan.attention_flops_bytes(**kw)


@pytest.mark.parametrize("n,tokens,kind", [(1_235_814_400, 8192, "train"),
                                          (16_156_309_504, 8, "decode"),
                                          (3, 0, "train")])
def test_model_flops_6nd_is_the_reference(n, tokens, kind):
    assert tan.model_flops_6nd(n, tokens, kind) == jan.model_flops_6nd(
        n, tokens, kind)


@pytest.mark.parametrize("args", [(1e12, 1e9, 0.0, 6e11),
                                  (1e9, 5e10, 1e6, 0.0),
                                  (0.0, 0.0, 3e9, 0.0)])
def test_roofline_is_the_reference_at_equal_peaks(monkeypatch, args):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(tan, name, getattr(jan, name))
    f, b, c, m = args
    assert tan.Roofline(f, b, c, model_flops=m).as_dict() == jan.Roofline(
        f, b, c, model_flops=m).as_dict()


# ---------------------------------------------------------------------------
# peaks
# ---------------------------------------------------------------------------

@pytest.fixture
def no_peak_env(monkeypatch):
    for v in tan.PEAK_ENV.values():
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_peaks_default_to_the_h100_without_a_card(no_peak_env):
    no_peak_env.setattr(tan, "_card_name", lambda: None)
    assert tan.peaks() == {"flops": 989e12, "hbm_bw": 3.35e12,
                           "ici_bw": 450e9}
    assert (tan.PEAK_FLOPS, tan.HBM_BW, tan.ICI_BW) == (989e12, 3.35e12,
                                                        450e9)


def test_peaks_of_the_h100_by_name_and_overrides(no_peak_env):
    no_peak_env.setattr(tan, "_card_name", lambda: "NVIDIA H100 80GB HBM3")
    no_peak_env.setenv("REPRO_PEAK_HBM_BW", "2e12")
    no_peak_env.setenv("REPRO_PEAK_FLOPS", "not a number")
    assert tan.peaks() == {"flops": 989e12, "hbm_bw": 2e12, "ici_bw": 450e9}


def test_peaks_refuse_an_unknown_card_unless_all_three_are_set(no_peak_env):
    no_peak_env.setattr(tan, "_card_name", lambda: "NVIDIA A100-SXM4-80GB")
    no_peak_env.setenv("REPRO_PEAK_FLOPS", "312e12")
    with pytest.raises(RuntimeError, match="REPRO_PEAK_FLOPS, "
                       "REPRO_PEAK_HBM_BW, REPRO_PEAK_ICI_BW"):
        tan.peaks()
    no_peak_env.setenv("REPRO_PEAK_HBM_BW", "2.039e12")
    no_peak_env.setenv("REPRO_PEAK_ICI_BW", "300e9")
    assert tan.peaks() == {"flops": 312e12, "hbm_bw": 2.039e12,
                           "ici_bw": 300e9}


def test_no_tpu_constant_in_the_port():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    files = list((root / "src" / "repro_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    for pat in ("197e12", "819e9", "50e9"):
        rx = re.compile(rf"(?<![\d.]){pat}")
        hits = [str(p) for p in files if rx.search(p.read_text())]
        assert not hits, (pat, hits)


# ---------------------------------------------------------------------------
# CostMode
# ---------------------------------------------------------------------------

def test_matmul_counts_exactly_its_flops_and_operand_bytes():
    x = torch.randn(64, 64)
    out, m = tan.count_cost(lambda a: a @ a, x)
    assert torch.equal(out, x @ x)
    assert m.flops == 2 * 64 ** 3
    assert m.hbm_bytes == 3 * 64 * 64 * 4      # two operands, one result
    assert m.errors == 0 and m.kernels == {}


def test_views_and_empty_move_no_bytes():
    x = torch.randn(8, 16)
    _, m = tan.count_cost(lambda a: (a.view(16, 8), a.t(), a.detach(),
                                     torch.empty(1000), a[2:]), x)
    assert m.hbm_bytes == 0 and m.flops == 0
    _, m = tan.count_cost(lambda a: a.expand(4, 8, 16) + 1.0, x)
    # the broadcast operand's rows are read once; the sum is written
    assert m.hbm_bytes == x.numel() * 4 + 4 * x.numel() * 4


def test_copies_across_devices_are_itemised_on_their_device_side():
    host = torch.randn(4, 3)

    def run():
        dev = host.to("meta")                   # to device, once
        dev.copy_(host)                         # again, in place
        scalar = torch.tensor(2.0).to("meta")   # a host scalar: not a copy
        return dev * scalar

    _, m = tan.count_cost(run)
    assert m.host_copy_bytes == 2 * 48
    assert m.host_copies == {
        "aten._to_copy float32[4, 3] to device": {"count": 1, "bytes": 48},
        "aten.copy_ float32[4, 3] to device": {"count": 1, "bytes": 48}}


def test_collectives_by_kind_under_the_reference_rule():
    import torch.distributed as dist
    store = dist.HashStore()
    pg = dist.ProcessGroup(store, 0, 1)
    pg._set_default_backend(dist.ProcessGroup.BackendType.GLOO)
    pg._register_backend(torch.device("cpu"),
                         dist.ProcessGroup.BackendType.GLOO,
                         dist.ProcessGroupGloo(store, 0, 1))
    t = torch.ones(1000)
    out = torch.empty(1000)

    def run():
        pg.allreduce([t]).wait()
        pg.allgather([[out]], [t]).wait()
        pg.broadcast([t]).wait()
        return t * 2

    res, m = tan.count_cost(run)
    assert torch.equal(res, torch.full((1000,), 2.0))
    assert m.collectives.counts == {"all-reduce": 1, "all-gather": 1,
                                    "broadcast": 1}
    assert m.collectives.bytes_by_kind == {"all-reduce": 8000,
                                           "all-gather": 4000,
                                           "broadcast": 4000}
    # the collectives' tensors are not HBM traffic: only t * 2's
    assert m.hbm_bytes == 8000


def test_a_counting_fault_is_counted_and_the_op_still_runs_once(monkeypatch):
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise ValueError("no formula")

    m = tan.CostMode()
    monkeypatch.setitem(m._flops, torch.ops.aten.mm, boom)
    x = torch.randn(4, 4)
    ran = []

    def fn(a):
        ran.append(1)
        return a @ a + a

    with m:
        out = fn(x)
    assert torch.equal(out, x @ x + x) and ran == [1] and calls == [1]
    assert m.errors == 1 and "no formula" in m.first_error
    assert m.hbm_bytes > 0              # the add was still counted


def test_a_step_counts_its_backward_and_recomputation():
    lin = torch.nn.Linear(32, 32)
    x = torch.randn(16, 32, requires_grad=True)

    def f(a):
        return torch.relu(lin(a))

    _, fwd = tan.count_cost(lambda: f(x).sum())
    _, step = tan.count_cost(lambda: f(x).sum().backward())
    _, remat = tan.count_cost(lambda: torch.utils.checkpoint.checkpoint(
        f, x, use_reentrant=False).sum().backward())
    assert step.flops == 3 * fwd.flops
    assert remat.flops == 4 * fwd.flops     # the forward once more


def test_kernel_cost_is_added_only_under_a_mode():
    calls = []

    def work():
        calls.append(1)
        return 10.0, 20.0

    K.cost("chunk_sum", work)
    assert calls == [] and K.cost_sinks == []
    with tan.CostMode() as m:
        K.cost("chunk_sum", work)
        K.cost("chunk_sum", lambda: (1.0, 2.0))
        with tan.CostMode() as inner:
            K.cost("fused_sgd", lambda: (5.0, 6.0))
    assert K.cost_sinks == [] and calls == [1]
    assert m.kernels == {"chunk_sum": {"launches": 2, "flops": 11.0,
                                       "bytes": 22.0}}
    assert (m.flops, m.hbm_bytes) == (11.0, 22.0)
    assert inner.kernels == {"fused_sgd": {"launches": 1, "flops": 5.0,
                                           "bytes": 6.0}}


def test_analyze_has_the_reference_shape_and_zero_memory_on_the_cpu():
    x = torch.randn(32, 32)
    a = tan.analyze(lambda v: v @ v, x, model_flops_per_device=1.0)
    assert set(a) == {"roofline", "collectives", "memory"}
    assert a["roofline"]["flops"] == 2 * 32 ** 3
    assert a["roofline"]["useful_ratio"] == 1.0 / (2 * 32 ** 3)
    assert set(a["roofline"]) == set(jan.Roofline(1, 1, 1).as_dict())
    assert a["memory"] == {"argument_bytes": 0, "output_bytes": 0,
                           "temp_bytes": 0, "peak_bytes": 0}


# ---------------------------------------------------------------------------
# a tiny decoder's step against XLA's count
# ---------------------------------------------------------------------------

STEP_RTOL = 0.05     # measured 0.985-0.986 (module docstring)


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_step_count_against_xla(remat):
    from repro.configs import get_smoke_config as jget
    from repro.configs.base import with_attn_impl as jwith
    from repro.core import bsp as jbsp
    from repro.core import exchanger as jex
    from repro.models import build_model as jbuild
    from repro.optim import optimizers as jopt
    from repro.optim import schedule as jsched
    from repro_torch.bridge import decoder_params_from_jax
    from repro_torch.configs import get_smoke_config as tget
    from repro_torch.configs.base import with_attn_impl as twith
    from repro_torch.core import bsp as tbsp
    from repro_torch.core import exchanger as tex
    from repro_torch.data import synthetic as tsyn
    from repro_torch.models import build_model as tbuild
    from repro_torch.models import count_params
    from repro_torch.optim import optimizers as topt
    from repro_torch.optim import schedule as tsched

    cfgs = []
    for get, wi in ((jget, jwith), (tget, twith)):
        c = get("llama3.2-1b")
        cfgs.append(wi(c.with_overrides(
            dtype="float32", vocab_size=256, remat=remat,
            attention=dataclasses.replace(c.attention, num_kv_heads=2)),
            "ref"))
    jm, tm = jbuild(cfgs[0]), tbuild(cfgs[1], "cpu")
    jstate = jbsp.init_train_state(jm, jopt.sgd_momentum(),
                                   jax.random.key(0))
    tp = decoder_params_from_jax(jax.tree.map(np.asarray,
                                              jstate["params"]), "cpu")
    B, S = 4, 32
    b = tsyn.LMTokenSource(256, S).batch(B, 0)
    jstep = jax.jit(jbsp.make_bsp_step(
        jm, jopt.sgd_momentum(), jex.get_exchanger("asa"),
        jsched.constant(0.01), jax.sharding.get_abstract_mesh(),
        unroll=True))
    ca = jstep.lower(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()},
                     jax.random.key(1)).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    tstep = tbsp.make_bsp_step(tm, topt.sgd_momentum(),
                               tex.get_exchanger("asa"), tsched.constant(0.01))
    state = {"params": tp, "opt": topt.sgd_momentum().init(tp), "step": 0}
    _, m = tan.count_cost(tstep, state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    six_nd = tan.model_flops_6nd(count_params(tp), B * S, "train")
    ratio = m.flops / ca["flops"]
    print(f"remat={remat}: port {m.flops:.6g} flops, XLA {ca['flops']:.6g}, "
          f"ratio {ratio:.4f}, 6ND {six_nd:.6g}")
    assert m.errors == 0
    assert m.flops >= six_nd
    assert abs(ratio - 1) <= STEP_RTOL


# ---------------------------------------------------------------------------
# the hand kernels' cost functions at PERF.md §6's shapes
# ---------------------------------------------------------------------------

def _bound_ms(cost):
    flops, nbytes = cost
    return max(nbytes / 3.35e12, flops / 989e12) * 1e3


def _pos(*v):
    return torch.tensor(v, dtype=torch.int32)


SERVE_POS = _pos(64, 200, 333, 480, 512, 700, 871, 1000)
LONG_POS = _pos(0, 511, 1024, 2047, 4095, 5000, 7777, 8191)
HYMBA_POS = _pos(100, 700, 1023, 1024, 1100, 1400, 1700, 2047)
SEAMLESS_POS = _pos(0, 15, 32, 47)
ZERO2, ZERO4 = _pos(0, 0), _pos(0, 0, 0, 0)


def _att(part, B, Sq, Sk, H, KV, Dk, Dv, q_off, window=0, lse=False):
    return lambda: fa.attention_cost(part, B, Sq, Sk, H, KV, Dk, Dv, q_off,
                                     window, 2, lse)


def _combine(pos, H, D, lane, block_k, window=0):
    chunk, ns = fa.decode_plan(lane, block_k, SMS)
    return lambda: fa.combine_cost(pos, H, D, 2, chunk, ns, window)


def _mla_reduce():
    chunk, _ = fa.mla_dkv_plan(2, 1024, 1024, 16, 1, SMS)
    return fa.mla_reduce_cost(2, 1024, 1024, 16, 1, 576, 512, ZERO2, 0,
                              chunk, 2)


# (row label, cost thunk, the table's bound ms)
TABLE = [
    ("1 serve chunk", _att("fwd", 1, 32, 1024, 32, 8, 64, 64, _pos(992)),
     "0.000704"),
    ("1 gspmd qwen", _att("fwd", 1, 1024, 1024, 20, 20, 128, 128, _pos(0),
                          lse=True), "0.006285"),
    ("1 LM", _att("fwd", 4, 1024, 1024, 32, 8, 64, 64, ZERO4, lse=True),
     "0.01739"),
    ("1 D128 chunk", _att("fwd", 1, 32, 1024, 20, 20, 128, 128, _pos(992)),
     "0.003228"),
    ("1 D128 B2", _att("fwd", 2, 1024, 1024, 20, 20, 128, 128, ZERO2,
                       lse=True), "0.01257"),
    ("1 MLA", _att("fwd", 2, 1024, 1024, 16, 1, 576, 512, ZERO2, lse=True),
     "0.03695"),
    ("1 Hymba chunk", _att("fwd", 1, 128, 2048, 25, 5, 64, 64, _pos(1280),
                           window=1024), "0.000848"),
    ("1 seamless", _att("fwd", 2, 1024, 1024, 16, 16, 64, 64, ZERO2,
                        lse=True), "0.005047"),
    ("2 LM", _att("dq", 4, 1024, 1024, 32, 8, 64, 64, ZERO4), "0.02608"),
    ("2 D128", _att("dq", 2, 1024, 1024, 20, 20, 128, 128, ZERO2),
     "0.01630"),
    ("2 gspmd qwen", _att("dq", 1, 1024, 1024, 20, 20, 128, 128, _pos(0)),
     "0.008151"),
    ("2 MLA", _att("dq", 2, 1024, 1024, 16, 1, 576, 512, ZERO2), "0.05651"),
    ("2 seamless", _att("dq", 2, 1024, 1024, 16, 16, 64, 64, ZERO2),
     "0.006520"),
    ("3 LM", _att("dkv", 4, 1024, 1024, 32, 8, 64, 64, ZERO4), "0.03478"),
    ("3 D128", _att("dkv", 2, 1024, 1024, 20, 20, 128, 128, ZERO2),
     "0.02173"),
    ("3 gspmd qwen", _att("dkv", 1, 1024, 1024, 20, 20, 128, 128, _pos(0)),
     "0.01087"),
    ("3 MLA", _att("dkv", 2, 1024, 1024, 16, 1, 576, 512, ZERO2), "0.07390"),
    ("3 MLA reduction", _mla_reduce, "0.01463"),
    ("3 seamless", _att("dkv", 2, 1024, 1024, 16, 16, 64, 64, ZERO2),
     "0.008694"),
    ("4 serve", lambda: fa.decode_cost(SERVE_POS, 32, 8, 64, 2, 0),
     "0.002568"),
    ("4 D128", lambda: fa.decode_cost(SERVE_POS, 20, 20, 128, 2, 0),
     "0.01276"),
    ("4 8K", lambda: fa.decode_cost(LONG_POS, 32, 8, 64, 2, 0), "0.01754"),
    ("4 Hymba", lambda: fa.decode_cost(HYMBA_POS, 25, 5, 64, 2, 1024),
     "0.002669"),
    ("4 seamless", lambda: fa.decode_cost(SEAMLESS_POS, 16, 16, 64, 2, 0),
     "0.0001247"),
    ("4 combine seamless", _combine(SEAMLESS_POS, 16, 64, 48, 48),
     "0.0000075"),
    ("4 combine Hymba", _combine(HYMBA_POS, 25, 64, 2048, 128, 1024),
     "0.000124"),
    ("5 serve", lambda: fa.decode_cost(SERVE_POS, 32, 8, 64, 2, 0, 16),
     "0.002568"),
    ("5 D128", lambda: fa.decode_cost(SERVE_POS, 20, 20, 128, 2, 0, 16),
     "0.01277"),
    ("5 Hymba", lambda: fa.decode_cost(HYMBA_POS, 25, 5, 64, 2, 1024, 16),
     "0.002670"),
] + [(f"6 {shape}", (lambda s=shape: sg.sampler_cost(*s, 2)), want)
     for shape, want in (((8, 1, 128256), "0.001838"),
                         ((1, 32, 128256), "0.000230"),
                         ((8, 1, 151936), "0.002177"),
                         ((1, 32, 151936), "0.000272"),
                         ((8, 1, 102400), "0.001467"),
                         ((1, 32, 102400), "0.000183"),
                         ((8, 1, 50280), "0.000720"),
                         ((1, 128, 50280), "0.0000902"),
                         ((8, 1, 32001), "0.000459"),
                         ((1, 32, 32001), "0.0000574"),
                         ((1, 128, 32001), "0.0000575"))] + [
    ("7 f6 shard", lambda: cs.chunk_sum_cost(2, 18_874_368, 2), "0.0451"),
    ("7 gspmd llama", lambda: cs.chunk_sum_cost(2, 131_335_168, 4),
     "0.4705"),
    ("7 gspmd qwen", lambda: cs.chunk_sum_cost(2, 194_479_360, 4), "0.6966"),
    ("8 f6", lambda: qz.cast_cost(37_748_736, 4, 2), "0.0676"),
    ("8 seamless", lambda: qz.cast_cost(2 * 131_177_472, 4, 2), "0.4699"),
    ("9 f6", lambda: qz.cast_cost(37_748_736, 2, 4), "0.0676"),
    ("9 seamless", lambda: qz.cast_cost(2 * 131_177_472, 2, 4), "0.4699"),
    ("10 f6", lambda: qz.int8_cost("quant_int8", 37_748_736), "0.05636"),
    ("11 f6", lambda: qz.int8_cost("dequant_int8", 37_748_736), "0.05636"),
    ("12 f6", lambda: fs.fused_sgd_cost(37_748_736), "0.2254"),
    ("12 gspmd llama", lambda: fs.fused_sgd_cost(64128 * 2048), "0.7841"),
    ("12 gspmd qwen", lambda: fs.fused_sgd_cost(75968 * 2560), "1.1611"),
    ("12 seamless", lambda: fs.fused_sgd_cost(1024), "0.0000061"),
    ("13 f6", lambda: fru.fused_rs_update_cost(2, 18_874_368, 2, True,
                                               False), "0.1352"),
    ("13 f6 int8", lambda: fru.fused_rs_update_cost(2, 18_874_368, 1, True,
                                                    True), "0.1240"),
    ("13 seamless", lambda: fru.fused_rs_update_cost(2, 131_177_472, 2,
                                                     True, False), "0.9398"),
]


def _sig(s: str) -> int:
    """Significant digits a table entry shows."""
    return len(s.replace(".", "").lstrip("0"))


@pytest.mark.parametrize("label,cost,want", TABLE, ids=[t[0] for t in TABLE])
def test_cost_function_gives_the_table_bound(label, cost, want):
    got = _bound_ms(cost())
    digits = min(_sig(want), 3)
    assert float(f"{got:.{digits}g}") == float(f"{float(want):.{digits}g}"), \
        (label, got, want)


# ---------------------------------------------------------------------------
# each launch site reports its cost
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the CUDA library: every entry returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def card_path(monkeypatch):
    """The wrappers' CUDA path on CPU tensors, the library a recorder."""
    monkeypatch.setattr(K, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "load", lambda name: _Recorder())
    monkeypatch.setattr(K, "stream_ptr", lambda t: None)
    monkeypatch.setattr(K, "sm_count", lambda index: SMS)


def _rn(*s, dtype=torch.bfloat16):
    return torch.randn(*s, generator=torch.Generator().manual_seed(
        math.prod(s) % 1000)).to(dtype)


def _flash(dtype, Dk, Dv, part):
    B, S, H, KV = 2, 48, 4, 2
    q, k, v = _rn(B, S, H, Dk, dtype=dtype), _rn(B, S, KV, Dk, dtype=dtype), \
        _rn(B, S, KV, Dv, dtype=dtype)
    qo = _pos(0, 5)
    es = q.element_size()
    if part == "fwd":
        want = {("flash_attention_mla" if Dk != Dv else "flash_attention"):
                fa.attention_cost("fwd", B, S, S, H, KV, Dk, Dv, qo, 7, es,
                                  True)}
        return lambda: fa.flash_attention(q, k, v, q_off=qo, window=7,
                                          return_lse=True), want
    lse, di = _rn(B, S, H, dtype=torch.float32), _rn(B, S, H,
                                                    dtype=torch.float32)
    do = _rn(B, S, H, Dv, dtype=dtype)
    kw = dict(q_off=qo, window=7, sm_scale=0.1)
    mla = "_mla" if Dk != Dv else ""
    if part == "dq":
        return (lambda: fa.flash_attention_dq(q, k, v, lse, do, di, **kw),
                {f"flash_attention{mla}_dq": fa.attention_cost(
                    "dq", B, S, S, H, KV, Dk, Dv, qo, 7, es)})
    want = {f"flash_attention{mla}_dkv": fa.attention_cost(
        "dkv", B, S, S, H, KV, Dk, Dv, qo, 7, es)}
    if mla and dtype != torch.float32:        # the tensor-core route
        pk, pv = fa.MLA_TC_PAIR
        chunk, _ = fa.mla_dkv_plan(B, S, S, H, KV, SMS)
        live = fa.mla_live_partials(B, S, S, H, KV, pk, pv, qo, 7, chunk)
        want = {"flash_attention_mla_dkv": fa.attention_cost(
                    "dkv", B, S, S, H, KV, Dk, Dv, qo, 7, es, partials=live),
                "flash_attention_mla_dkv_reduce": fa.mla_reduce_cost(
                    B, S, S, H, KV, pk, pv, qo, 7, chunk, es)}
    return lambda: fa.flash_attention_dkv(q, k, v, lse, do, di, **kw), want


def _decode(paged):
    B, H, KV, D, S, ps = 3, 8, 2, 48, 64, 16
    pos = _pos(0, 20, 63)
    q = _rn(B, 1, H, D)
    chunk, ns = fa.decode_plan(S, ps if paged else 64, SMS)
    want = {"flash_decode_combine": fa.combine_cost(pos, H, D, 2, chunk, ns,
                                                    0)}
    if paged:
        kp, vp = _rn(9, ps, KV, D), _rn(9, ps, KV, D)
        tables = torch.arange(1, 9, dtype=torch.int32)[:8].reshape(
            2, 4).repeat(2, 1)[:B]
        want["flash_decode_paged"] = fa.decode_cost(pos, H, KV, D, 2, 0, ps)
        return lambda: fa.flash_decode_paged(q, kp, vp, tables, pos,
                                             page_size=ps), want
    k, v = _rn(B, S, KV, D), _rn(B, S, KV, D)
    want["flash_decode"] = fa.decode_cost(pos, H, KV, D, 2, 0)
    return lambda: fa.flash_decode(q, k, v, pos), want


def _combine_alone():
    B, KV, ns, G, D = 2, 2, 3, 4, 32
    m, l = _rn(B, KV, ns, G, dtype=torch.float32), _rn(
        B, KV, ns, G, dtype=torch.float32)
    acc = _rn(B, KV, ns, G, D, dtype=torch.float32)
    pos = _pos(100, 300)
    return (lambda: fa.decode_combine(m, l, acc, pos, chunk=128, kv_len=384,
                                      dtype=torch.bfloat16),
            {"flash_decode_combine": fa.combine_cost(pos, KV * G, D, 2, 128,
                                                     ns, 0)})


def _exchange(entry):
    n, k = 5000, 3
    x32, x16 = _rn(n, dtype=torch.float32), _rn(n, dtype=torch.float16)
    if entry == "chunk_sum":
        recv = _rn(k, n, dtype=torch.float16)
        return lambda: cs.chunk_sum(recv), {
            "chunk_sum": cs.chunk_sum_cost(k, n, 2)}
    if entry == "quant_fp16":
        return lambda: qz.quant_fp16(x32), {
            "quant_fp16": qz.cast_cost(n, 4, 2)}
    if entry == "dequant_fp16":
        return lambda: qz.dequant_fp16(x16), {
            "dequant_fp16": qz.cast_cost(n, 2, 4)}
    if entry == "quant_int8":
        return lambda: qz.quant_int8(x32), {
            "quant_int8": qz.int8_cost("quant_int8", n)}
    if entry == "dequant_int8":
        q8 = torch.zeros(n, dtype=torch.int8)
        sc = torch.ones(-(-n // qz.BLOCK_N))
        return lambda: qz.dequant_int8(q8, sc), {
            "dequant_int8": qz.int8_cost("dequant_int8", n)}
    p, g, m = (_rn(n, dtype=torch.float32) for _ in range(3))
    if entry == "fused_sgd":
        return lambda: fs.fused_sgd(p, g, m, 0.01), {
            "fused_sgd": fs.fused_sgd_cost(n)}
    recv = torch.zeros(k, n, dtype=torch.int8)
    return (lambda: fru.fused_rs_update(
        recv, p, m, 0.01, wd_mask=torch.ones(n), weight_decay=1e-4,
        scales=torch.ones(k)),
        {"fused_rs_update": fru.fused_rs_update_cost(k, n, 1, True, True)})


def _sampler():
    S, C, V = 3, 2, 1000
    lg = _rn(S, C, V)
    oh = torch.nn.functional.one_hot(torch.tensor([0, 1, 1]), C).float()
    return (lambda: sg.slot_gather_sample(lg, oh, torch.ones(S),
                                          torch.zeros(S, V)),
            {"slot_gather_sample": sg.sampler_cost(S, C, V, 2)})


SITES = {
    "flash_fwd": lambda: _flash(torch.bfloat16, 48, 48, "fwd"),
    "flash_mla_fwd": lambda: _flash(torch.bfloat16, 80, 64, "fwd"),
    "flash_mla_bwd_dq": lambda: _flash(torch.float32, 80, 64, "dq"),
    "flash_mla_bwd_dkv": lambda: _flash(torch.float32, 80, 64, "dkv"),
    "flash_mla_dkv_reduce": lambda: _flash(torch.bfloat16, 80, 64, "dkv"),
    "flash_bwd_dq": lambda: _flash(torch.bfloat16, 48, 48, "dq"),
    "flash_bwd_dkv": lambda: _flash(torch.bfloat16, 48, 48, "dkv"),
    "flash_decode_split": lambda: _decode(False),
    "flash_decode_split_paged": lambda: _decode(True),
    "flash_decode_combine": _combine_alone,
    "slot_gather_sample": _sampler,
    "chunk_sum": lambda: _exchange("chunk_sum"),
    "quant_fp16": lambda: _exchange("quant_fp16"),
    "dequant_fp16": lambda: _exchange("dequant_fp16"),
    "quant_int8": lambda: _exchange("quant_int8"),
    "dequant_int8": lambda: _exchange("dequant_int8"),
    "fused_sgd": lambda: _exchange("fused_sgd"),
    "fused_rs_update": lambda: _exchange("fused_rs_update"),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_launch_site_reports_its_cost(site, card_path):
    fn, want = SITES[site]()
    K.reset_launches()
    with tan.CostMode() as m:
        fn()
    assert m.errors == 0, m.first_error
    got = {n: (r["flops"], r["bytes"]) for n, r in m.kernels.items()}
    assert got == {n: (float(f), float(b)) for n, (f, b) in want.items()}
    assert all(r["launches"] == K.LAUNCHES[n] == 1
               for n, r in m.kernels.items())
    # no mode, no cost: the same launches report nothing
    K.reset_launches()
    fn()
    assert K.cost_sinks == []
