"""The membership controller: who is in the fleet, and at what staleness.

A copy of ``repro/fault/membership.py`` (pinned to it by
``tests/test_torch_fault.py``). Host-side, pure-python state machine —
the elastic loop consults it every step, on every rank alike, and the
step programs only ever see its *outputs*: the per-worker absorb/attract
weight vectors and the (rebuilt-on-change) worker count k.

Worker lifecycle (the GroundHog READY/TRAIN/DONE/EXIT shape, adapted to
round-boundary membership):

    JOINING --admit@boundary--> LIVE --kill--> LEAVING --boundary--> DEAD
                                 |  ^
                         straggle|  | rounds elapse / delta absorbed
                                 v  |
                              STRAGGLING

- Membership changes (kill/join) are *deferred to round boundaries*: the
  replica-stack layout (leading worker dim of extent k) is baked into the
  step programs (the port: the process group), so k only changes where
  the loop rebuilds anyway.
- STRAGGLING workers stay in the stack (they keep taking local steps) but
  do not report at averaging rounds; their staleness accrues.
- **Staleness** of worker i = number of averaging rounds since its delta
  was last absorbed into the center. A reporting worker's delta lands
  with the staleness-scaled coefficient ``alpha / (1 + staleness)`` —
  the late-absorption rule that keeps tau-bounded-staleness semantics:
  a delta that aged s rounds moves the center 1/(1+s) as far.
- **Quorum**: an averaging round proceeds iff at least ``quorum`` live
  workers report (default: majority of the live fleet). Below quorum the
  round degrades to a local step for everyone and staleness accrues.
"""
from __future__ import annotations

import numpy as np


class WorkerState:
    LIVE = "live"
    STRAGGLING = "straggling"
    LEAVING = "leaving"      # killed; drops out at the next round boundary
    JOINING = "joining"      # admitted at the next round boundary
    DEAD = "dead"


class MembershipController:
    """Tracks the live fleet between tau-step rounds.

    ``workers`` (the ordered tuple of live worker ids) defines the row
    order of the engine's replica stacks; ``apply_pending`` is the only
    place that order changes, and it reports the old/new orders so the
    caller can reshard state rows accordingly.
    """

    def __init__(self, worker_ids, *, alpha: float, quorum: int | None = None,
                 num_slots: int | None = None):
        ids = list(worker_ids)
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        if not ids:
            raise ValueError("need at least one worker")
        if quorum is not None and quorum < 1:
            raise ValueError(f"quorum must be >= 1 (got {quorum})")
        self.alpha = float(alpha)
        self._quorum = quorum
        self.num_slots = len(ids) if num_slots is None else int(num_slots)
        if len(ids) > self.num_slots:
            raise ValueError(f"{len(ids)} workers > {self.num_slots} slots")
        self._workers: list[int] = ids            # row order of the stacks
        self._staleness = {w: 0 for w in ids}
        self._straggle = {w: 0 for w in ids}      # rounds left to miss
        self._slots = {w: i for i, w in enumerate(ids)}
        self._pending_leave: list[int] = []
        self._pending_join: list[int] = []
        self.rounds = 0                            # boundaries seen
        self.rejected_joins = 0
        self.observed_straggles = 0   # detection-driven (mark_straggling)

    # -- introspection ------------------------------------------------------

    @property
    def workers(self) -> tuple:
        return tuple(self._workers)

    @property
    def k(self) -> int:
        return len(self._workers)

    @property
    def quorum_count(self) -> int:
        """Explicit quorum, or a majority of the live fleet."""
        if self._quorum is not None:
            return self._quorum
        return self.k // 2 + 1

    def slot_of(self, worker: int) -> int:
        return self._slots[worker]

    def state_of(self, worker: int) -> str:
        if worker in self._pending_join:
            return WorkerState.JOINING
        if worker not in self._workers:
            return WorkerState.DEAD
        if worker in self._pending_leave:
            return WorkerState.LEAVING
        if self._straggle.get(worker, 0) > 0:
            return WorkerState.STRAGGLING
        return WorkerState.LIVE

    def staleness_of(self, worker: int) -> int:
        return self._staleness.get(worker, 0)

    def max_staleness(self) -> int:
        return max(self._staleness.values(), default=0)

    def mean_staleness(self) -> float:
        if not self._staleness:
            return 0.0
        return float(np.mean(list(self._staleness.values())))

    # -- fault/inject entry points ------------------------------------------

    def kill(self, worker: int) -> bool:
        """Worker dies; it leaves the stack at the next round boundary (and
        never reports in the meantime)."""
        if worker not in self._workers or worker in self._pending_leave:
            return False
        self._pending_leave.append(worker)
        return True

    def request_join(self, worker: int) -> bool:
        """Worker asks to join; admitted at the next round boundary if a
        device slot is free then."""
        if worker in self._workers or worker in self._pending_join:
            return False
        self._pending_join.append(worker)
        return True

    def straggle(self, worker: int, rounds: int = 1) -> bool:
        if worker not in self._workers:
            return False
        self._straggle[worker] = max(self._straggle.get(worker, 0),
                                     int(rounds))
        return True

    def mark_straggling(self, worker: int, rounds: int = 1) -> bool:
        """Detection-driven straggle: the anomaly detector *observed* this
        worker running slow (as opposed to an injected/announced
        ``straggle``). Same mechanics — the worker keeps taking local
        steps but skips the next ``rounds`` averaging rounds — tallied
        separately so reports can distinguish announced from discovered
        stragglers."""
        if self.straggle(worker, rounds):
            self.observed_straggles += 1
            return True
        return False

    # -- round protocol -----------------------------------------------------

    def reporting(self, exclude=()) -> list:
        """Who reports this round: live, not straggling, not killed, not in
        ``exclude`` (dropped/corrupted payloads)."""
        ex = set(exclude)
        return [w for w in self._workers
                if w not in ex
                and w not in self._pending_leave
                and self._straggle.get(w, 0) == 0]

    def has_quorum(self, reporting) -> bool:
        return len(reporting) >= self.quorum_count

    def round_weights(self, reporting) -> tuple:
        """Per-worker (absorb, attract) fp32 vectors in stack-row order.

        A reporting worker at staleness s gets ``alpha / (1 + s)`` — the
        late-delta absorption rule; non-reporting rows get 0 (their
        params and the center ignore each other this round). The elastic
        attraction uses the same staleness-scaled coefficient, so a stale
        worker is pulled toward the center exactly as hard as it pushes.
        """
        rep = set(reporting)
        absorb = np.zeros((self.k,), np.float32)
        for i, w in enumerate(self._workers):
            if w in rep:
                absorb[i] = self.alpha / (1.0 + self._staleness[w])
        return absorb, absorb.copy()

    def commit_round(self, reporting):
        """An averaging round ran with ``reporting`` absorbed: their
        staleness resets, everyone else's accrues."""
        rep = set(reporting)
        for w in self._workers:
            self._staleness[w] = 0 if w in rep else self._staleness[w] + 1
        self._end_round()

    def skip_round(self):
        """Below-quorum round: nothing absorbed, everyone's delta ages."""
        for w in self._workers:
            self._staleness[w] += 1
        self._end_round()

    def _end_round(self):
        self.rounds += 1
        for w in self._workers:
            if self._straggle.get(w, 0) > 0:
                self._straggle[w] -= 1

    # -- membership changes (round boundaries only) -------------------------

    def apply_pending(self) -> tuple:
        """Apply deferred leaves/joins; returns ``(old, new, left, joined)``
        worker-id tuples. ``old != new`` iff the caller must rebuild its
        programs and reshard replica-stack rows (survivor rows carry over
        by id; joiners start at the center)."""
        old = tuple(self._workers)
        left = tuple(self._pending_leave)
        for w in left:
            self._workers.remove(w)
            self._slots.pop(w, None)
            self._staleness.pop(w, None)
            self._straggle.pop(w, None)
        self._pending_leave.clear()
        joined = []
        used = set(self._slots.values())
        free = [s for s in range(self.num_slots) if s not in used]
        for w in self._pending_join:
            if not free:
                self.rejected_joins += 1
                continue
            self._slots[w] = free.pop(0)
            self._workers.append(w)
            self._staleness[w] = 0   # starts at the center: delta is fresh
            self._straggle[w] = 0
            joined.append(w)
        self._pending_join.clear()
        if not self._workers:
            raise RuntimeError("membership change emptied the fleet — "
                               "every worker was killed")
        return old, tuple(self._workers), left, tuple(joined)
