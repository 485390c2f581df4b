"""The training engine: one ``TrainPlan`` names the algorithm and its
knobs, and ``build_engine`` resolves it (counterpart of
``repro/train/engine.py``).

``TrainPlan`` is a copy of the JAX package's, validation included
(pinned by ``tests/test_torch_train.py``). ``build_engine`` builds the
``bsp`` arm (with ``overlap`` and ``sharded_update``) and the async
``easgd``/``asgd`` arm; ``gspmd`` raises until its slice (ROADMAP queue
1: sharded training), and quorum plans go through
:func:`build_elastic_programs`, which ``fault.elastic.elastic_train``
rebuilds on every membership change. The canonical state is

    {"params": ..., "opt": ..., "step": int}     (+ "center" when async)

with per-bucket flat shards under ``opt`` when ``sharded_update``.
``Engine.step`` takes the global step index: the async arm dispatches
its sync step on every tau-th step and its collective-free local step
otherwise, so a resumed run keeps the unbroken run's tau phase.

``data_axes=("pod", "data")`` runs the exchange in two levels over
``pods`` pods of consecutive ranks (``core.exchanger.make_transport``):
the ``hier``/``hier16`` topology of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.bsp import (init_sharded_train_state, init_train_state,
                                  make_bsp_step)
from repro_torch.core.easgd import init_async_state, make_async_step
from repro_torch.core.exchanger import (Transport, get_exchanger,
                                        make_rs_plan, make_transport,
                                        wire_summary)
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer

ALGOS = ("bsp", "easgd", "asgd", "gspmd")


@dataclass(frozen=True)
class TrainPlan:
    """Declarative selection of a training algorithm + its knobs,
    validated eagerly (see the JAX package's ``TrainPlan`` for the knob
    matrix). ``alpha=None`` resolves to the algo default (0.5 for easgd,
    1 for asgd)."""
    algo: str = "bsp"
    exchanger: str = "asa"
    scheme: str = "subgd"            # bsp: subgd | awagd
    microbatches: int = 1
    bucket_bytes: int = 0
    sharded_update: bool = False
    overlap: str | None = None       # bsp: None | "buckets"
    tau: int = 1                     # easgd/asgd averaging period
    alpha: float | None = None       # easgd elastic coefficient
    mode: str = "zero1"              # gspmd: ar | zero1
    quorum: int | None = None        # elastic: min reporters per round
    data_axes: tuple = ("data",)

    def __post_init__(self):
        object.__setattr__(self, "data_axes", tuple(self.data_axes))
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; known: {ALGOS}")
        if self.scheme not in ("subgd", "awagd"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.mode not in ("ar", "zero1"):
            raise ValueError(f"unknown gspmd mode {self.mode!r}")
        if self.overlap not in (None, "buckets"):
            raise ValueError(f"unknown overlap mode {self.overlap!r}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1 (got {self.tau})")
        if self.algo != "bsp":
            bad = [n for n, v in (("sharded_update", self.sharded_update),
                                  ("overlap", self.overlap),
                                  ("microbatches", self.microbatches > 1),
                                  ("scheme", self.scheme != "subgd"))
                   if v]
            if bad:
                raise ValueError(f"{'/'.join(bad)} are BSP-only knobs "
                                 f"(algo={self.algo!r})")
        if not self.is_async and self.tau != 1:
            raise ValueError(f"tau is an easgd/asgd knob "
                             f"(algo={self.algo!r}); it would be silently "
                             f"ignored")
        if self.algo == "gspmd" and self.exchanger != "asa":
            raise ValueError("gspmd lowers its own collectives from "
                             "sharding constraints; the exchanger knob "
                             "does not apply")
        if self.algo != "gspmd" and self.mode != "zero1":
            raise ValueError(f"mode is a gspmd knob (algo={self.algo!r})")
        if self.alpha is not None:
            if not self.is_async:
                raise ValueError(f"alpha is an async knob "
                                 f"(algo={self.algo!r})")
            if self.algo == "asgd" and self.alpha != 1.0:
                raise ValueError("asgd is pinned to alpha=1 (the center "
                                 "applies the full delta sum); use "
                                 "algo='easgd' for elastic alpha")
        else:
            object.__setattr__(self, "alpha",
                               1.0 if self.algo == "asgd" else 0.5)
        if self.is_async and self.exchanger == "none":
            raise ValueError("async plans need a real exchanger for the "
                             "center traffic (exchanger='none')")
        if self.quorum is not None:
            if not self.is_async:
                raise ValueError(f"quorum is an elastic easgd/asgd knob "
                                 f"(algo={self.algo!r})")
            if self.quorum < 1:
                raise ValueError(f"quorum must be >= 1 (got {self.quorum})")

    @property
    def is_async(self) -> bool:
        return self.algo in ("easgd", "asgd")


def plan_wire(plan: TrainPlan, params, k: int) -> dict | None:
    """Analytic per-rank bytes on the wire of one step of ``plan`` for a
    params tree of these shapes, ``k`` ranks on the reduce-scatter axis
    (the JAX package's ``_plan_wire``); None for ``none``."""
    ex = get_exchanger(plan.exchanger)
    if ex.kind == "none":
        return None
    rsplan = make_rs_plan(params, k, plan.bucket_bytes)
    if plan.is_async:
        # the delta's reduce-scatter and the center's all-gather, every
        # tau-th step
        return wire_summary(ex, rsplan, sync_every=plan.tau)
    ws = wire_summary(ex, rsplan,
                      param_ag=bool(plan.sharded_update or plan.overlap))
    # the overlap exchanges every microbatch's gradient: m times the RS
    per_exchange = plan.microbatches if plan.overlap else 1
    ws["bytes_per_step"] = (ws["rs_bytes"] * per_exchange + ws["ag_bytes"]
                            + ws["small_bytes"])
    return ws


@dataclass(frozen=True)
class Engine:
    """A resolved plan: ``init_state(gen)`` and ``step(state, batch,
    gen=None, timer=None, step_idx=0) -> (state, metrics)`` on this rank
    (``step_idx``: the global step, which picks an async plan's local or
    sync step), and the transport whose staging counters the loop
    reads."""
    plan: TrainPlan
    init_state: Callable[[Any], Any]
    step: Callable[..., Any]
    transport: Transport

    def wire(self, params) -> dict | None:
        """Analytic per-rank bytes on the wire of one step for a params
        tree of these shapes (:func:`plan_wire`); None for ``none``."""
        return plan_wire(self.plan, params, self.transport.k)

    def is_sync(self, step_idx: int) -> bool:
        """Whether step ``step_idx`` exchanges (every step but an async
        plan's local steps)."""
        return (not self.plan.is_async
                or (int(step_idx) + 1) % self.plan.tau == 0)


@dataclass(frozen=True)
class ElasticPrograms:
    """An async plan resolved for one membership: ``local`` and the quorum
    ``sync(state, batch, gen, timer, absorb=..., attract=...)`` (see
    ``core.easgd.make_async_step``), rebuilt by the elastic loop whenever
    the fleet changes."""
    plan: TrainPlan
    transport: Transport
    k: int
    local: Callable
    sync: Callable
    init_state: Callable[[Any], Any]

    def wire(self, params) -> dict | None:
        return plan_wire(self.plan, params, self.transport.k)


def build_elastic_programs(plan: TrainPlan, model: Model,
                           optimizer: Optimizer, lr_fn: Callable, group=None,
                           *, pods: int = 1) -> ElasticPrograms:
    """``build_engine``'s async arm with the quorum sync step, on the
    current membership (``group``)."""
    if not plan.is_async:
        raise ValueError(f"elastic programs are an easgd/asgd feature "
                         f"(algo={plan.algo!r})")
    tr = make_transport(plan.data_axes, pods, group)
    local, sync = make_async_step(
        model, optimizer, get_exchanger(plan.exchanger), lr_fn, tr,
        algo=plan.algo, alpha=plan.alpha, bucket_bytes=plan.bucket_bytes,
        quorum=True)
    return ElasticPrograms(plan, tr, tr.world_k, local, sync,
                           lambda gen: init_async_state(model, optimizer,
                                                        gen))


def build_engine(plan: TrainPlan, model: Model, optimizer: Optimizer,
                 lr_fn: Callable, group=None, *, pods: int = 1) -> Engine:
    """Resolve ``plan`` on the process group ``group`` (None: the default
    group, or one rank when none is initialised; a :class:`Transport` is
    taken as it is). ``pods`` splits the ranks for
    ``data_axes=("pod", "data")``."""
    if plan.quorum is not None:
        raise ValueError(
            "quorum plans are elastic: drive them through "
            "repro_torch.fault.elastic.elastic_train (on "
            "build_elastic_programs); build_engine builds fixed-membership "
            "engines and would silently ignore quorum")
    if plan.algo == "gspmd":
        raise NotImplementedError(
            "algo 'gspmd' is not ported yet (ROADMAP queue 1: sharded "
            "training, core/gspmd.py)")
    ex = get_exchanger(plan.exchanger)
    tr = make_transport(plan.data_axes, pods, group)
    if plan.is_async:
        local, sync = make_async_step(
            model, optimizer, ex, lr_fn, tr, algo=plan.algo,
            alpha=plan.alpha, bucket_bytes=plan.bucket_bytes)

        def astep(state, batch, gen=None, timer=None, step_idx: int = 0):
            fn = sync if engine.is_sync(step_idx) else local
            return fn(state, batch, gen, timer)

        engine = Engine(plan, lambda gen: init_async_state(model, optimizer,
                                                           gen), astep, tr)
        return engine
    sharded = bool(plan.sharded_update or plan.overlap)
    bstep = make_bsp_step(
        model, optimizer, ex, lr_fn, tr, scheme=plan.scheme,
        microbatches=plan.microbatches,
        bucket_bytes=plan.bucket_bytes, sharded_update=plan.sharded_update,
        overlap=plan.overlap)

    def step(state, batch, gen=None, timer=None, step_idx: int = 0):
        return bstep(state, batch, gen, timer)

    def init_state(gen):
        if sharded:
            return init_sharded_train_state(model, optimizer, gen, tr,
                                            bucket_bytes=plan.bucket_bytes)
        return init_train_state(model, optimizer, gen)

    return Engine(plan, init_state, step, tr)
