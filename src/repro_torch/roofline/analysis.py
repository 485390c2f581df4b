"""Roofline analysis of the port's programs (counterpart of
``repro/roofline/analysis.py``).

Terms (per device, NVIDIA H100 SXM constants):
    compute    = flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = coll_bytes / ICI_BW

The reference reads flops and bytes from XLA's ``cost_analysis`` of a
compiled program. An eager PyTorch program has no compiled form, so
:class:`CostMode` counts one run of it instead: a ``TorchDispatchMode``
that sees every aten op the run dispatches (the autograd engine's
backward and ``torch.utils.checkpoint``'s recomputation included) and

- **flops**: of the matrix products and convolutions, by the formulas of
  ``torch.utils.flop_counter`` (elementwise ops count none, where XLA
  counts one a value);
- **bytes**: each op's input plus output tensors on the device, XLA's
  pre-fusion "bytes accessed" rule, which for eager execution is the
  traffic itself. Ops that move no data count none (``empty*``, views,
  ``detach``, aliases, a host number or scalar tensor put on the
  device); an op across host and card (a copy) counts each of its device
  tensors once, and a host scalar tensor an op reads (a fill's value)
  counts as it would on the device;
- **collectives**: ``c10d`` ops and the functional collectives that
  DTensor issues (``_c10d_functional``), by kind, under the reference's
  ``parse_collectives`` rule (the bytes of the result; twice that for an
  all-reduce; the (k-1)/k factor dropped). They never count as HBM bytes.

Tensors on the ``meta`` device count as device tensors, so a dry run
(``launch/dryrun.py``) counts what the same program does on the card. A
DTensor op is counted through the ops on its local shards that DTensor
dispatches (one device's share, with the collectives its redistributions
issue); the fake tensors of its sharding propagation count nothing.

The hand-written kernels launch through ``ctypes``, which no dispatch mode
sees: each launch reports its own work through ``kernels.cost``, and an
active :class:`CostMode` adds it. The ops of other threads are not seen
(dispatch modes are thread-local; the autograd engine's threads inherit
the mode).
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels as K
# the analytic attention cost lives beside the kernels that report it
from repro_torch.kernels.flash_attention import (  # noqa: F401
    attention_flops_bytes)

# NVIDIA H100 SXM (H100 80GB HBM3)
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12         # B/s of HBM3
ICI_BW = 450e9           # B/s of NVLink 4, one direction (card to card)

# peaks by torch.cuda.get_device_name()
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                              "ici_bw": ICI_BW},
}
PEAK_ENV = {"flops": "REPRO_PEAK_FLOPS", "hbm_bw": "REPRO_PEAK_HBM_BW",
            "ici_bw": "REPRO_PEAK_ICI_BW"}


@functools.lru_cache(maxsize=None)
def _card_name() -> str | None:
    return torch.cuda.get_device_name() if torch.cuda.is_available() else None


def peaks() -> dict:
    """The peak model every achieved-vs-peak gauge divides by, in FLOP/s
    and B/s per device: the visible card's (:data:`CARD_PEAKS`; with no
    card, as on a CPU host, the H100's), each overridable through
    ``REPRO_PEAK_FLOPS`` / ``REPRO_PEAK_HBM_BW`` / ``REPRO_PEAK_ICI_BW``.
    A card not in the table raises unless all three are set. The flops
    peak is bf16's on the tensor cores, so an fp32 program's MFU is taken
    against it too, as the reference takes every program's against its
    bf16 peak."""
    def _env(name):
        try:
            v = float(os.environ.get(name, "") or 0)
        except ValueError:
            v = 0.0
        return v if v > 0 else 0.0
    env = {k: _env(v) for k, v in PEAK_ENV.items()}
    if all(env.values()):
        return env
    name = _card_name()
    card = CARD_PEAKS.get(name or "NVIDIA H100 80GB HBM3")
    if card is None:
        raise RuntimeError(
            f"no peak model for the card {name!r}: set "
            f"{', '.join(PEAK_ENV.values())} (FLOP/s, B/s, B/s)")
    return {k: env[k] or card[k] for k in PEAK_ENV}


_SITE = threading.local()


@contextlib.contextmanager
def collective_site(name: str):
    """Within the block, the collectives a :class:`CostMode` counts are
    also added to its ``collectives.bytes_by_site[name]`` (the innermost
    block's name; a backward run after the block is not inside it)."""
    prev = getattr(_SITE, "name", None)
    _SITE.name = name
    try:
        yield
    finally:
        _SITE.name = prev


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    bytes_by_kind: dict = field(default_factory=dict)
    bytes_by_site: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        site = getattr(_SITE, "name", None)
        if site is not None:
            self.bytes_by_site[site] = self.bytes_by_site.get(site,
                                                              0) + nbytes


# functional collective (DTensor's) -> kind; its result is the op's output
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
# c10d op -> the reference's collective kind
_COLL_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter",
}
_aten = torch.ops.aten
# ops that move no data (views are found by their schema; a scalar made
# from a host number is no traffic either)
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten.detach,
               _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
               _aten._reshape_alias, _aten.set_, _aten.resize_,
               _aten.scalar_tensor}


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:     # a build without torch.distributed
        return type("NoDTensor", (), {})
    return DTensor


@functools.lru_cache(maxsize=None)
def _fake_type():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


_COPIES = {_aten.copy_, _aten._to_copy}


def _flop_fns() -> dict:
    from torch.utils.flop_counter import flop_registry
    return dict(flop_registry)


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (a broadcast
    dim's stride 0 reads its row once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts one run of a program (module docstring): ``flops``,
    ``hbm_bytes``, ``collectives`` (a :class:`CollectiveStats`), the hand
    kernels' share in ``kernels`` ({name: {"launches", "flops",
    "bytes"}}, also in the totals), ``host_copy_bytes`` (the share of
    ``hbm_bytes`` of the copies across host and device: the gloo
    transport's staging on a shared card) and ``host_copies`` (the same
    by op, dtype, device-side shape and direction: {name: {"count",
    "bytes"}}), ``bytes_by_op`` (``hbm_bytes``
    by aten op, the kernels under their names), and ``errors`` /
    ``first_error``: ops whose counting failed (each still ran once)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.host_copy_bytes = 0.0
        self.host_copies: dict = {}
        self.bytes_by_op: dict = {}
        self.collectives = CollectiveStats()
        self.kernels: dict = {}
        self.errors = 0
        self.first_error: str | None = None
        self._flops = _flop_fns()

    def __enter__(self):
        K.cost_sinks.append(self)
        try:
            return super().__enter__()
        except BaseException:
            K.cost_sinks.remove(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            K.cost_sinks.remove(self)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One hand-kernel launch's work (``kernels.cost``)."""
        row = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                             "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self._add_bytes(name, nbytes)

    def _add_bytes(self, key: str, nbytes: float) -> None:
        self.hbm_bytes += nbytes
        self.bytes_by_op[key] = self.bytes_by_op.get(key, 0.0) + nbytes

    def _add_host_copy(self, packet, ts, out) -> None:
        nbytes = sum(_tensor_bytes(t) for t in ts)
        self.host_copy_bytes += nbytes
        to_host = isinstance(out, torch.Tensor) and out.device.type == "cpu"
        name = " ".join((str(packet), *(f"{str(t.dtype)[6:]}{list(t.shape)}"
                                        for t in ts),
                         "to host" if to_host else "to device"))
        row = self.host_copies.setdefault(name, {"count": 0, "bytes": 0.0})
        row["count"] += 1
        row["bytes"] += nbytes

    def error(self, what: str, e: BaseException) -> None:
        self.errors += 1
        if self.first_error is None:
            self.first_error = f"{what}: {type(e).__name__}: {e}"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented      # counted as its local shards' ops
        out = func(*args, **kwargs)
        if any(issubclass(t, _fake_type()) for t in types) or isinstance(
                out, _fake_type()):
            return out                 # DTensor's sharding propagation
        try:
            self._count(func, args, kwargs, out)
        except Exception as e:  # noqa: BLE001 — counting never stops a run
            self.error(str(func), e)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace == "_c10d_functional":
            kind = _FUNCTIONAL_KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                nbytes = sum(_tensor_bytes(t) for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor))
                self.collectives.add(kind, 2 * nbytes if kind == "all-reduce"
                                     else nbytes)
            return
        if func.namespace == "c10d":
            kind = _COLL_KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                nbytes = sum(_tensor_bytes(t) for t in tree_leaves(args[0])
                             if isinstance(t, torch.Tensor))
                self.collectives.add(kind, 2 * nbytes if kind == "all-reduce"
                                     else nbytes)
            return
        packet = func.overloadpacket
        fl = self._flops.get(packet)
        if fl is not None:
            self.flops += float(fl(*args, **kwargs, out_val=out))
        if func.is_view or packet in _NO_TRAFFIC:
            return
        ts = [t for t in tree_leaves((args, kwargs, out))
              if isinstance(t, torch.Tensor)]
        if len({t.device.type for t in ts}) > 1:
            if packet in _COPIES and all(t.numel() <= 1 for t in ts):
                return          # a host scalar put on the device
            if any(t.device.type == "cpu" and t.dim() > 0 for t in ts):
                # a copy across host and device: its device side, once
                seen: dict = {}
                for t in ts:
                    if t.device.type != "cpu":
                        seen[id(t)] = t
                ts = list(seen.values())
                self._add_host_copy(packet, ts, out)
            # else a host scalar argument: read once, as on one device
        self._add_bytes(str(packet), sum(_tensor_bytes(t) for t in ts))


# A dispatch mode's __torch_dispatch__ comes wrapped by
# torch._compile._disable_dynamo, whose first call imports torch._dynamo
# to exclude it from tracing: seconds once a process (on an H100 host with
# triton installed, a counted first step took ~9 s more). Nothing of the
# port is compiled, so hand the wrapper its cached result up front.
_raw_dispatch = CostMode.__torch_dispatch__.__wrapped__
setattr(_raw_dispatch, "__dynamo_disable", _raw_dispatch)


def count_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostMode`; returns
    (its output, the mode)."""
    mode = CostMode()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    model_flops: float = 0.0     # analytic 6ND (per device)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def _tensors(tree) -> dict:
    return {id(t): t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def analyze(fn, *args, model_flops_per_device: float = 0.0, **kwargs) -> dict:
    """Full analysis of one run of ``fn(*args, **kwargs)`` (it runs once):
    the reference's ``{"roofline", "collectives", "memory"}``. ``memory``
    is the card's allocator around the run (peak less the arguments'
    bytes is the temporaries'); zeros when no argument lies on the card."""
    ins = _tensors((args, kwargs))
    cuda = [t for t in ins.values() if t.is_cuda]
    if cuda:
        dev = cuda[0].device
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out, mode = count_cost(fn, *args, **kwargs)
    memory = dict.fromkeys(("argument_bytes", "output_bytes", "temp_bytes",
                            "peak_bytes"), 0)
    if cuda:
        torch.cuda.synchronize(dev)
        arg_b = sum(_tensor_bytes(t) for t in cuda)
        out_b = sum(_tensor_bytes(t) for t in _tensors(out).values()
                    if t.is_cuda)
        peak = int(torch.cuda.max_memory_allocated(dev))
        memory = {"argument_bytes": arg_b, "output_bytes": out_b,
                  "temp_bytes": max(peak - arg_b, 0), "peak_bytes": peak}
    rl = Roofline(mode.flops, mode.hbm_bytes, mode.collectives.total_bytes,
                  model_flops=model_flops_per_device)
    return {
        "roofline": rl.as_dict(),
        "collectives": {"counts": mode.collectives.counts,
                        "bytes_by_kind": mode.collectives.bytes_by_kind},
        "memory": memory,
    }


def model_flops_6nd(n_active_params: int, tokens: int, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (fwd only)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
