"""The training engine: one ``TrainPlan`` names the algorithm and its
knobs, and ``build_engine`` resolves it (counterpart of
``repro/train/engine.py``).

``TrainPlan`` is a copy of the JAX package's, validation included
(pinned by ``tests/test_torch_train.py``). Only the ``bsp`` arm is built
here; ``easgd``/``asgd`` and ``gspmd`` raise until their slice (ROADMAP
queue 1: async and sharded training). The canonical state is

    {"params": ..., "opt": ..., "step": int}

with per-bucket flat shards under ``opt`` when ``sharded_update``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.bsp import (init_sharded_train_state, init_train_state,
                                  make_bsp_step)
from repro_torch.core.exchanger import (Transport, get_exchanger,
                                        make_rs_plan, wire_summary)
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


@dataclass(frozen=True)
class Engine:
    """A resolved plan: ``init_state(gen)`` and ``step(state, batch,
    gen=None, timer=None) -> (state, metrics)`` on this rank,
    and the transport whose staging counters the loop reads."""
    plan: TrainPlan
    init_state: Callable[[Any], Any]
    step: Callable[..., Any]
    transport: Transport

    def wire(self, params) -> dict | None:
        """Analytic per-rank bytes on the wire of one step for a params
        tree of these shapes (``wire_summary``); None for ``none``."""
        ex = get_exchanger(self.plan.exchanger)
        if ex.kind == "none":
            return None
        plan = make_rs_plan(params, self.transport.k, self.plan.bucket_bytes)
        return wire_summary(ex, plan, param_ag=self.plan.sharded_update)


def build_engine(plan: TrainPlan, model: Model, optimizer: Optimizer,
                 lr_fn: Callable, group=None) -> Engine:
    """Resolve ``plan`` on the process group ``group`` (None: the default
    group, or one rank when none is initialised)."""
    if plan.algo != "bsp":
        raise NotImplementedError(
            f"algo {plan.algo!r} is not ported yet (ROADMAP queue 1: async "
            f"and sharded training); the port trains bsp")
    ex = get_exchanger(plan.exchanger)
    tr = Transport(group)
    bstep = make_bsp_step(
        model, optimizer, ex, lr_fn, tr, scheme=plan.scheme,
        microbatches=plan.microbatches,
        bucket_bytes=plan.bucket_bytes, sharded_update=plan.sharded_update,
        overlap=plan.overlap)

    def init_state(gen):
        if plan.sharded_update:
            return init_sharded_train_state(model, optimizer, gen, tr,
                                            bucket_bytes=plan.bucket_bytes)
        return init_train_state(model, optimizer, gen)

    return Engine(plan, init_state, bstep, tr)
