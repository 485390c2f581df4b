"""Slot scheduler: FIFO admission, per-slot position/length tracking, and
mid-flight eviction of finished sequences.

A copy of ``repro/serve/scheduler.py`` (pure Python; pinned to the
original by ``tests/test_torch_host.py``). All host-side bookkeeping: the
engine owns the device tensors, the scheduler owns the request lifecycle —

    queued -> (admit) -> prefilling -> decoding -> (finish) -> freed
          \\-> (shed)                           \\-> (cancel) -> freed

A slot is a lane of the engine's fixed-size batch. Freed slots are reused
immediately by the next queued request; the decode step's shapes never
change, only the per-slot position/active vectors the scheduler exports.

SLO guardrails (DESIGN.md "Serve robustness") live at this layer because
they are pure request-lifecycle decisions:

- **Typed admission.** :meth:`submit` returns an :class:`AdmissionResult`
  — ``ACCEPTED`` with the request id, or a rejection
  (``REJECTED_QUEUE_FULL`` under the bounded queue). The result coerces
  to the rid (``int()``, dict key, ``==``), so accepted paths read like
  they always did; malformed or never-fits requests still raise
  ``ValueError`` (a caller bug, not load). Every rejection leaves the
  allocator and queue state untouched.
- **Bounded queue + shedding policy.** ``max_queue > 0`` bounds
  ``pending``; an arrival into a full queue is refused
  (``reject-newest``) or displaces the youngest queued request that
  carries no deadline (``reject-no-deadline``) — the policy knob trades
  arrival fairness against deadline goodput.
- **Cancellation.** :meth:`cancel` (queued or in-flight) and the
  engine-driven deadline cancels route through the same ``_finish`` path
  a natural completion uses, so pages/refcounts are released exactly as
  on finish. Terminal requests carry a ``finish_reason``:
  ``stop | cancel | deadline | shed``.
- **Bounded results + finish events.** ``finished`` keeps the newest
  ``finished_keep`` entries (a long-running server must not grow per
  request); :meth:`pop_finished` is the hand-off API. Accounting reads
  the monotonic ``finished_total`` / ``finish_log`` event stream instead
  of ``len(finished)`` — watermarks survive pops, drains and restores.

The scheduler also stamps the request lifecycle for telemetry: a request
carries ``t_submit``/``t_admit``/``t_prefill_done``/``t_finish``
(``clock`` seconds — ``time.perf_counter`` in production, a virtual
clock in tests), and each phase is exported as an async
span (``serve/req/queued`` -> ``serve/req/prefill`` ->
``serve/req/decode``, keyed by request id) so a ``--trace-out`` Perfetto
file shows every request's queue wait, TTFT and decode tail overlapping
the engine's dispatch spans. All host-side.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.telemetry import trace

# admission statuses (AdmissionResult.status)
ACCEPTED = "accepted"
REJECTED_QUEUE_FULL = "rejected_queue_full"

# terminal finish_reason values
FINISH_STOP = "stop"          # eos / max_new reached
FINISH_CANCEL = "cancel"      # explicit cancel()
FINISH_DEADLINE = "deadline"  # past its deadline (engine-driven cancel)
FINISH_SHED = "shed"          # shed from the queue (never ran)

SHED_POLICIES = ("reject-newest", "reject-no-deadline")


class AdmissionResult:
    """Typed outcome of ``submit``: a status plus the request id.

    Coerces to the rid so accepted results drop into existing call sites
    (``results()[r]``, ``int(r)``, ``r == rid``); ``bool(r)`` answers
    "was it admitted to the queue". Rejections carry ``rid == -1`` and a
    human-readable ``reason``."""

    __slots__ = ("rid", "status", "reason")

    def __init__(self, rid: int, status: str, reason: str = ""):
        self.rid = rid
        self.status = status
        self.reason = reason

    @property
    def accepted(self) -> bool:
        return self.status == ACCEPTED

    def __bool__(self) -> bool:
        return self.accepted

    def __int__(self) -> int:
        return self.rid

    __index__ = __int__

    def __eq__(self, other) -> bool:
        if isinstance(other, AdmissionResult):
            return self.rid == other.rid and self.status == other.status
        if isinstance(other, int):
            return self.rid == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.rid)

    def __repr__(self) -> str:
        if self.accepted:
            return f"AdmissionResult(rid={self.rid})"
        return (f"AdmissionResult({self.status}"
                + (f", {self.reason!r}" if self.reason else "") + ")")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature == 0 is greedy; top_k == 0 and top_p >= 1 disable the
    respective filters. ``seed`` makes the request's sample stream
    deterministic (per-slot PRNG keys are folded from it)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


@dataclass
class Request:
    tokens: list          # prompt token ids
    max_new: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos: int | None = None     # stop token (None: run to max_new)
    rid: int = -1              # assigned by the scheduler at submit
    # SLO budget (milliseconds from submit; None = no deadline)
    deadline_ms: float | None = None
    max_queue_ms: float | None = None
    # lifecycle timestamps (clock seconds; 0.0 = not reached yet)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_prefill_done: float = 0.0    # first token sampled: TTFT endpoint
    t_finish: float = 0.0
    finish_reason: str | None = None   # stop | cancel | deadline | shed

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_submit if self.t_admit else 0.0

    @property
    def ttft(self) -> float:
        """Submit -> first token (queue wait + prefill + first sample)."""
        return (self.t_prefill_done - self.t_submit
                if self.t_prefill_done else 0.0)

    @property
    def deadline_at(self) -> float | None:
        """Absolute clock deadline, or None."""
        if self.deadline_ms is None:
            return None
        return self.t_submit + self.deadline_ms / 1e3

    def within_deadline(self) -> bool:
        """Did the request finish inside its budget? (vacuously true
        without one; false until finished.)"""
        if self.deadline_ms is None:
            return True
        return bool(self.t_finish) and self.t_finish <= self.deadline_at

    def to_state(self) -> dict:
        """Re-submittable host snapshot (drain/restore)."""
        s = self.sampling
        return {"tokens": list(self.tokens), "max_new": int(self.max_new),
                "eos": self.eos, "rid": int(self.rid),
                "deadline_ms": self.deadline_ms,
                "max_queue_ms": self.max_queue_ms,
                "sampling": {"temperature": s.temperature, "top_k": s.top_k,
                             "top_p": s.top_p, "seed": s.seed}}

    @classmethod
    def from_state(cls, d: dict) -> "Request":
        return cls(tokens=list(d["tokens"]), max_new=int(d["max_new"]),
                   sampling=SamplingParams(**d["sampling"]), eos=d["eos"],
                   rid=int(d["rid"]), deadline_ms=d.get("deadline_ms"),
                   max_queue_ms=d.get("max_queue_ms"))


@dataclass
class SlotState:
    """One live request bound to a slot."""
    req: Request
    pos: int = 0               # next cache write index (== tokens decoded)
    generated: list = field(default_factory=list)
    last_token: int = 0        # token to feed at the next decode step
    done: bool = False
    hit_tokens: int = 0        # prompt tokens served by the prefix cache


class SlotScheduler:
    """FIFO over a fixed pool of ``max_slots`` decode lanes.

    With a :class:`~repro_torch.serve.cache.PageAllocator` attached, admission is
    additionally gated on page capacity: the head-of-line request admits
    only when its worst-case page need fits (``try_admit`` reserves it),
    and later requests never jump the queue — strict FIFO keeps admission
    deterministic under memory pressure. Finishing a request releases its
    pages back to the free list (prefix-cached pages survive for future
    hits)."""

    def __init__(self, max_slots: int, max_seq: int, allocator=None, *,
                 max_queue: int = 0, shed_policy: str = "reject-newest",
                 finished_keep: int = 4096, clock=None):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.allocator = allocator
        self.max_queue = max_queue            # 0 = unbounded (legacy)
        self.shed_policy = shed_policy
        self.finished_keep = finished_keep
        self.clock = clock or time.perf_counter
        self.pending: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * max_slots
        self.finished: dict[int, SlotState] = {}
        self._next_rid = 0    # plain int (snapshot/restore needs the value)
        # monotonic accounting (survives pop_finished / drain / restore):
        self.finished_total = 0     # terminal events, any reason
        self.finished_dropped = 0   # results evicted by the retention window
        # event stream the engine drains each step for stats — one entry
        # per terminal request: dict(rid, reason, tokens, within_deadline,
        # had_deadline, slot) — bounded: the engine drains every step
        self.finish_log: deque = deque(maxlen=max(4 * finished_keep, 64))

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> AdmissionResult:
        if not req.tokens:
            raise ValueError("empty prompt")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(req.tokens) + req.max_new > self.max_seq:
            raise ValueError(
                f"request needs {len(req.tokens) + req.max_new} cache rows, "
                f"pool holds {self.max_seq}")
        if self.allocator is not None:
            need = self.allocator.pages_needed(len(req.tokens) + req.max_new)
            if need > self.allocator.num_pages - 1:
                raise ValueError(
                    f"request needs {need} pages, pool holds "
                    f"{self.allocator.num_pages - 1}")
        if self.max_queue and len(self.pending) >= self.max_queue:
            if self.shed_policy == "reject-no-deadline":
                # displace the *youngest* queued request without a
                # deadline; an all-deadline queue falls back to
                # reject-newest. Youngest-first keeps the head (oldest,
                # closest to running) intact.
                victim = next((r for r in reversed(self.pending)
                               if r.deadline_ms is None), None)
                if victim is not None:
                    self.shed_queued(victim)
                    return self._accept(req)
            return AdmissionResult(
                -1, REJECTED_QUEUE_FULL,
                f"queue full ({len(self.pending)}/{self.max_queue})")
        return self._accept(req)

    def _accept(self, req: Request) -> AdmissionResult:
        req.rid = self._next_rid
        self._next_rid += 1
        req.t_submit = self.clock()
        trace.async_begin("serve/req/queued", req.rid,
                          prompt=len(req.tokens), max_new=req.max_new)
        self.pending.append(req)
        return AdmissionResult(req.rid, ACCEPTED)

    def resubmit(self, req: Request) -> None:
        """Drain/restore path: requeue a snapshotted request keeping its
        original rid (results stay keyed identically across the restart).
        Deadlines restart from the re-submit instant."""
        self._next_rid = max(self._next_rid, req.rid + 1)
        req.t_submit = self.clock()
        req.t_admit = req.t_prefill_done = req.t_finish = 0.0
        req.finish_reason = None
        trace.async_begin("serve/req/queued", req.rid,
                          prompt=len(req.tokens), max_new=req.max_new)
        self.pending.append(req)

    # -- admission ----------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def admit(self) -> list[tuple[int, Request]]:
        """Bind queued requests to free slots (FIFO). Returns the new
        (slot, request) pairs; the engine prefill-fills each one."""
        placed = []
        for slot in self.free_slots():
            if not self.pending:
                break
            req = self.pending[0]
            hit = 0
            if self.allocator is not None:
                got = self.allocator.try_admit(slot, req.tokens, req.max_new)
                if got is None:
                    break    # head-of-line blocks until pages free up
                hit = got
            self.pending.popleft()
            req.t_admit = self.clock()
            trace.async_end("serve/req/queued", req.rid)
            trace.async_begin("serve/req/prefill", req.rid, slot=slot,
                              cached=hit)
            self.slots[slot] = SlotState(req=req, pos=len(req.tokens),
                                         last_token=req.tokens[-1],
                                         hit_tokens=hit)
            placed.append((slot, req))
        return placed

    def shed_queued(self, req: Request, reason: str = FINISH_SHED) -> None:
        """Remove a *queued* request (deadline unmeetable / queue budget
        blown). It never held a slot or pages — nothing to release."""
        self.pending.remove(req)
        trace.async_end("serve/req/queued", req.rid)
        self._terminal(req, reason, generated=[], slot=None)

    # -- decode bookkeeping -------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    def has_work(self) -> bool:
        return bool(self.pending) or self.num_active > 0

    def active_mask(self) -> list[bool]:
        return [s is not None for s in self.slots]

    def positions(self) -> list[int]:
        """Per-slot cache write index for the next decode step. Idle slots
        park at 0 — they rewrite (and causally hide) row 0 until reused."""
        return [s.pos if s is not None else 0 for s in self.slots]

    def feed_tokens(self) -> list[int]:
        return [s.last_token if s is not None else 0 for s in self.slots]

    def record_first_token(self, slot: int, token: int) -> None:
        """The prompt's continuation sampled from the prefill logits."""
        st = self.slots[slot]
        st.req.t_prefill_done = self.clock()
        trace.async_end("serve/req/prefill", st.req.rid)
        trace.async_begin("serve/req/decode", st.req.rid, slot=slot)
        self._record(slot, token)

    def record_step(self, tokens) -> list[int]:
        """Fold one decode step's sampled token per slot into the state.
        Advances positions, finishes/evicts, returns freed slots."""
        freed = []
        for slot, st in enumerate(self.slots):
            if st is None or st.done:
                continue
            st.pos += 1          # the step wrote cache row st.pos
            self._record(slot, int(tokens[slot]))
            if self.slots[slot] is None:
                freed.append(slot)
        return freed

    def _record(self, slot: int, token: int) -> None:
        st = self.slots[slot]
        st.generated.append(token)
        st.last_token = token
        req = st.req
        if (len(st.generated) >= req.max_new
                or (req.eos is not None and token == req.eos)):
            self._finish(slot, FINISH_STOP)

    def _finish(self, slot: int, reason: str) -> None:
        """The single terminal path for a slot-bound request — natural
        completion AND cancellation run through here, so pages/refcounts
        are released identically either way."""
        st = self.slots[slot]
        st.done = True
        req = st.req
        req.t_finish = self.clock()
        trace.async_end("serve/req/decode", req.rid,
                        tokens=len(st.generated), reason=reason)
        self.slots[slot] = None    # evict mid-flight; slot reusable
        if self.allocator is not None:
            self.allocator.release_slot(slot)
        self._terminal(req, reason, generated=st.generated, slot=slot,
                       state=st)

    def _terminal(self, req: Request, reason: str, *, generated, slot,
                  state: SlotState | None = None) -> None:
        req.finish_reason = reason
        if not req.t_finish:
            req.t_finish = self.clock()
        if state is None:
            state = SlotState(req=req, generated=list(generated), done=True)
        self.finished[req.rid] = state
        self.finished_total += 1
        self.finish_log.append({
            "rid": req.rid, "reason": reason, "tokens": len(state.generated),
            "within_deadline": req.within_deadline(),
            "had_deadline": req.deadline_ms is not None,
            "slot": slot})
        if self.finished_keep and len(self.finished) > self.finished_keep:
            oldest = next(iter(self.finished))
            del self.finished[oldest]
            self.finished_dropped += 1

    # -- cancellation -------------------------------------------------------

    def cancel(self, rid: int, reason: str = FINISH_CANCEL) -> bool:
        """Cancel a request wherever it is: queued (shed, nothing held) or
        in-flight (slot + pages released exactly as on finish, partial
        output kept). Returns False for unknown/already-finished rids."""
        rid = int(rid)
        for req in self.pending:
            if req.rid == rid:
                self.shed_queued(req, reason)
                return True
        for slot, st in enumerate(self.slots):
            if st is not None and st.req.rid == rid:
                self._finish(slot, reason)
                return True
        return False

    def cancel_past_deadline(self, now: float) -> list[int]:
        """Cancel every in-flight request past its deadline (the engine
        calls this at step boundaries). Returns the cancelled rids."""
        out = []
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            dl = st.req.deadline_at
            if dl is not None and now > dl:
                out.append(st.req.rid)
                self._finish(slot, FINISH_DEADLINE)
        return out

    # -- results ------------------------------------------------------------

    def results(self) -> dict[int, list]:
        return {rid: st.generated for rid, st in self.finished.items()}

    def finish_reasons(self) -> dict[int, str]:
        return {rid: st.req.finish_reason
                for rid, st in self.finished.items()}

    def pop_finished(self) -> dict[int, SlotState]:
        """Hand off (and forget) the finished-results map — the bounded-
        memory consumption API for a long-running server. Accounting is
        unaffected: it reads ``finished_total``/``finish_log``, not this
        map."""
        out = self.finished
        self.finished = {}
        return out
