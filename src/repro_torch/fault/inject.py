"""Deterministic fault injection: a declarative, seeded ``FaultPlan``
(a copy of ``repro/fault/inject.py``, pinned to it by
``tests/test_torch_fault.py``).

Every chaos run must be exactly reproducible — a flaky chaos test is
worse than no chaos test. A :class:`FaultPlan` is a list of
:class:`FaultEvent` keyed by *global step index*, plus a seed; anything
stochastic inside an event (which bit a corruption flips) draws from a
per-event generator derived from ``(seed, event index)``, so replaying
the same plan against the same run is bit-identical regardless of how
many other events fired.

Event kinds (all take effect through the membership controller /
elastic loop — see DESIGN.md "Fault tolerance & elasticity"):

``kill:W@S``        worker W dies at step S (leaves at the next round
                    boundary; its delta never reports again).
``join:W@S``        worker W joins at step S (admitted at the next round
                    boundary, starting from the center).
``straggle:W@SxD``  worker W misses the next D averaging rounds starting
                    at step S; its delta is absorbed late with
                    staleness-scaled alpha.
``drop:W@S``        worker W's exchange payload for the round containing
                    step S is lost on the wire (absorbed next round,
                    staleness-scaled).
``corrupt:W@S``     worker W's payload for that round is bit-corrupted on
                    the wire; the integrity check (crc32) detects it and
                    the round excludes the payload (equivalent to a drop,
                    plus a detection counter).
``slow:W@SxD``      worker W runs slow (x ``factor``, default 8) for the D
                    rounds starting at step S. Unlike ``straggle`` the
                    membership controller is *not* told — the anomaly
                    detector must discover the straggler from observed
                    per-worker timing and mark it itself. The slowdown is
                    modeled deterministically (the worker's observed step
                    time is the shared measurement times ``factor``), so
                    replay stays bit-identical.

Serve-side kinds (consumed by ``repro_torch.serve.chaos``, where "worker" is
reinterpreted as the event's magnitude knob and "step" is the engine
decode-step index — see DESIGN.md "Serve robustness"):

``qflood:N@S``      N extra requests burst-arrive at step S (prompt
                    lengths/budgets drawn from the per-event generator).
``stall:F@SxD``     decode dispatches run F× slower for the D steps
                    starting at S (modeled through the engine's virtual
                    cost model, so replay stays bit-identical).
``cancel:K@S``      the K-th live request (by rid order; modulo live
                    count) is cancelled at step S.
``pagepress:N@SxD`` N pages are withheld from the allocator's free list
                    at step S and released D steps later — the page-pool
                    squeeze that drives brownout.

The spec grammar above round-trips through :meth:`FaultPlan.from_spec` /
:meth:`FaultPlan.to_spec` — it is what ``--fault-plan`` on the train
launcher (train kinds) and serve launcher (serve kinds) take.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

KINDS = ("kill", "join", "straggle", "drop", "corrupt", "slow",
         # serve-side kinds (repro_torch.serve.chaos)
         "qflood", "stall", "cancel", "pagepress")
SERVE_KINDS = ("qflood", "stall", "cancel", "pagepress")


@dataclass(frozen=True)
class FaultEvent:
    kind: str
    worker: int
    step: int
    # straggle/slow only: how many averaging rounds the fault spans
    rounds: int = 1
    # slow only: multiplier on the worker's observed step time
    factor: float = 8.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.step < 0 or self.worker < 0:
            raise ValueError(f"worker/step must be >= 0 ({self})")
        if self.rounds < 1:
            raise ValueError(f"straggle rounds must be >= 1 ({self})")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slow factor must be > 1 ({self})")

    def to_spec(self) -> str:
        s = f"{self.kind}:{self.worker}@{self.step}"
        if self.kind in ("straggle", "slow", "stall", "pagepress"):
            s += f"x{self.rounds}"
        return s


@dataclass(frozen=True)
class FaultPlan:
    """An ordered, seeded schedule of fault events.

    ``seed`` only feeds the per-event generators (corruption bit choice);
    the *schedule* itself is fully declarative. Two plans with equal
    events and seed replay identically.
    """
    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        evs = tuple(sorted(self.events, key=lambda e: (e.step, e.worker)))
        object.__setattr__(self, "events", evs)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse ``"kill:1@9,straggle:2@5x3,corrupt:0@13"``."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            try:
                kind, rest = part.split(":", 1)
                worker, at = rest.split("@", 1)
                rounds = 1
                if "x" in at:
                    at, d = at.split("x", 1)
                    rounds = int(d)     # straggle/slow duration
                events.append(FaultEvent(kind.strip(), int(worker),
                                         int(at), rounds))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec {part!r} (grammar: kind:worker@step"
                    f"[xrounds], kinds={KINDS}): {e}") from e
        return cls(tuple(events), seed)

    def to_spec(self) -> str:
        return ",".join(e.to_spec() for e in self.events)

    @classmethod
    def random(cls, seed: int, *, num_workers: int, num_steps: int,
               n_events: int = 4, kinds=("kill", "straggle", "drop",
                                         "corrupt")) -> "FaultPlan":
        """A reproducible random chaos schedule: same seed -> same plan.

        Kills are capped at ``num_workers - 1`` so the fleet never
        empties; straggles span 1..3 rounds."""
        rng = np.random.default_rng(seed)
        events, kills = [], 0
        for _ in range(n_events):
            kind = str(rng.choice(kinds))
            if kind == "kill":
                if kills >= num_workers - 1:
                    kind = "drop"
                else:
                    kills += 1
            events.append(FaultEvent(
                kind, int(rng.integers(0, num_workers)),
                int(rng.integers(1, max(2, num_steps - 1))),
                int(rng.integers(1, 4)) if kind == "straggle" else 1))
        return cls(tuple(events), seed)

    # -- queries ------------------------------------------------------------

    def events_at(self, step: int) -> list:
        return [e for e in self.events if e.step == step]

    def event_rng(self, event: FaultEvent) -> np.random.Generator:
        """The per-event generator: keyed by (plan seed, event index) so a
        replay draws identical bits no matter what else fired."""
        idx = self.events.index(event)
        return np.random.default_rng([int(self.seed), idx])

    def __len__(self) -> int:
        return len(self.events)


# ---------------------------------------------------------------------------
# payload integrity: checksum + deterministic corruption
# ---------------------------------------------------------------------------

def payload_checksum(payload) -> int:
    """crc32 over the raw bytes of an array (or list of arrays) — the
    integrity stamp a worker attaches to its exchange payload. crc32
    detects every single-bit error, so a ``corrupt`` injection is always
    caught."""
    if isinstance(payload, (list, tuple)):
        crc = 0
        for a in payload:
            crc = zlib.crc32(np.asarray(a).tobytes(), crc)
        return crc
    return zlib.crc32(np.asarray(payload).tobytes())


def bitflip(arr, rng: np.random.Generator):
    """Flip one deterministic (per ``rng``) bit of ``arr``'s raw bytes —
    the wire-corruption model. Dtype-agnostic (works on bf16 via bytes);
    returns a new array, input untouched."""
    a = np.asarray(arr)
    raw = bytearray(a.tobytes())
    if not raw:
        return a.copy()
    byte = int(rng.integers(0, len(raw)))
    bit = int(rng.integers(0, 8))
    raw[byte] ^= 1 << bit
    return np.frombuffer(bytes(raw), dtype=a.dtype).reshape(a.shape).copy()
