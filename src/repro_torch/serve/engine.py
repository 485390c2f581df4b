"""Continuous-batching decode engine (counterpart of
``repro/serve/engine.py``).

- **Fixed-slot request pool.** Every decode step sees ``(max_slots, 1)``
  tokens, a ``(max_slots,)`` position vector, the whole cache pool and
  ``(max_slots,)`` sampling vectors. Requests joining or leaving change
  the values in those tensors, never a shape, so a later change can
  capture the step in a CUDA graph.
- **Per-slot positions.** Every lane decodes at its own depth; a freed
  lane is reused by the next queued request.
- **Chunked prefill.** A prompt is written into its slot's cache by
  ``model.chunk_prefill`` in ``prefill_chunk``-token chunks, one model
  call per chunk, attending through ``flash_attention`` with a per-row
  ``q_off``.
- **Paged KV cache (default).** Attention lanes live in a shared pool of
  ``page_size``-token pages routed per slot by block tables; the
  host-side :class:`~repro_torch.serve.cache.PageAllocator` owns the free
  list, refcounts and the hashed prefix cache (hits skip their pages;
  the first write to a shared page copies it). ``page_size=0`` selects
  the contiguous per-slot pool, the parity oracle.
- **SSM families.** Mamba-2's and Hymba's conv/state lanes are
  slot-granular in either pool and are zeroed at admission; the prefill
  chunk is rounded up to a multiple of the SSD chunk (so chunked prefill
  equals a single call bit for bit); a pure-SSM model runs the
  contiguous pool whatever ``page_size`` says, and any SSM family runs
  without the prefix cache (its state is not rebuilt from pages).
- **Sampling.** Greedy/temperature/top-k/top-p per request;
  ``fused_sampling=True`` routes greedy/temperature through the
  ``slot_gather_sample`` kernel.
- **SLO guardrails are host-side only.** Deadline shedding, in-flight
  cancellation, the bounded queue, brownout degradation, the stuck-step
  watchdog and drain/restore all live between dispatches: the decode and
  prefill dispatches run the same operations with guardrails on or off,
  and each sees one argument signature (shapes, dtypes, devices) for the
  engine's lifetime (``trace_counts``, the counterpart of the reference's
  compile-once count; tested). ``serve.chaos`` drives them on a virtual
  clock.

The engine is synchronous: admission and prefill happen between decode
steps, which keeps the loop deterministic and testable.
"""
from __future__ import annotations

import json
import time
import zlib
from collections import deque

import numpy as np
import torch

from repro_torch import default_device, telemetry
from repro_torch.checkpoint.ckpt import _atomic_write
from repro_torch.configs.base import with_attn_impl
from repro_torch.kernels.slot_gather import slot_gather_sample
from repro_torch.models import build_model, cast_params
from repro_torch.models.common import dtype_of
from repro_torch.serve import cache as cache_mod
from repro_torch.serve import sampling as sampling_mod
from repro_torch.serve.scheduler import (AdmissionResult, FINISH_SHED,
                                         REJECTED_QUEUE_FULL, Request,
                                         SamplingParams, SlotScheduler,
                                         SlotState)
from repro_torch.telemetry import anomaly, profile, trace
from repro_torch.telemetry.registry import Registry

STATS_WINDOW = 4096   # decode steps of latency history kept for percentiles
EWMA_ALPHA = 0.2      # step-time EWMA (the watchdog/deadline-estimate base)

# brownout ladder thresholds on page-pool occupancy: sustained occupancy
# >= HI1 enters level 1 (prefix-cache registration off), >= HI2 level 2
# (+ max_new clamp); dropping below LO for the same patience leaves it
BROWNOUT_HI1 = 0.85
BROWNOUT_HI2 = 0.95
BROWNOUT_LO = 0.60
BROWNOUT_PATIENCE = 3

SNAPSHOT_SCHEMA = 1


class EngineStats:
    """Serve statistics on a private, always-live :class:`Registry`
    (the stats work with ``REPRO_TELEMETRY=0``; with telemetry on, the
    engine attaches the registry to the process-wide export stream).

    Beside throughput and latency: shed/cancel/deadline-miss/queue-
    rejection counters, the watchdog's stalls and brownout's clamps, the
    queue-depth and brownout gauges, a goodput counter (tokens of requests
    that finished inside their deadline) and ``step_ewma``, the step-time
    EWMA that the admission estimate and the stuck-step watchdog read."""

    def __init__(self):
        r = self.registry = Registry(label="serve")
        self._prefill_tokens = r.counter("serve/prefill_tokens")
        self._prefill_time = r.counter("serve/prefill_time_s")
        self._decoded_tokens = r.counter("serve/decoded_tokens")
        self._decode_time = r.counter("serve/decode_time_s")
        self._steps = r.counter("serve/decode_steps")
        self._admissions = r.counter("serve/admissions")
        self._evictions = r.counter("serve/evictions")
        self._page_occupancy = r.gauge("serve/page_occupancy")
        self._prefix_hit_rate = r.gauge("serve/prefix_hit_rate")
        self._cow_copies = r.gauge("serve/cow_copies")
        self._shed = r.counter("serve/shed")
        self._cancelled = r.counter("serve/cancelled")
        self._deadline_miss = r.counter("serve/deadline_miss")
        self._rejected_queue_full = r.counter("serve/rejected_queue_full")
        self._watchdog_stalls = r.counter("serve/watchdog_stalls")
        self._brownout_clamped = r.counter("serve/brownout_clamped")
        self._goodput_tokens = r.counter("serve/goodput_tokens")
        self._queue_depth = r.gauge("serve/queue_depth")
        self._brownout_level = r.gauge("serve/brownout_level")
        self._h_step = r.histogram("serve/step_time_s")
        self._h_ttft = r.histogram("serve/ttft_s")
        self._h_queue = r.histogram("serve/queue_wait_s")
        self.step_ewma: float | None = None   # from the second step on
        self.step_times: deque = deque(maxlen=STATS_WINDOW)
        self.step_tokens: deque = deque(maxlen=STATS_WINDOW)
        self.ttfts: deque = deque(maxlen=STATS_WINDOW)
        self.queue_waits: deque = deque(maxlen=STATS_WINDOW)

    # -- recording (engine-internal) ----------------------------------------

    def record_prefill(self, tokens: int, dt: float) -> None:
        self._prefill_tokens.inc(tokens)
        self._prefill_time.inc(dt)

    def record_admission(self, queue_wait: float) -> None:
        self._admissions.inc()
        self._h_queue.observe(queue_wait)
        self.queue_waits.append(queue_wait)

    def record_first_token(self, ttft: float) -> None:
        self._h_ttft.observe(ttft)
        self.ttfts.append(ttft)

    def record_decode(self, n_active: int, dt: float) -> None:
        self._steps.inc()
        self._decode_time.inc(dt)
        self._decoded_tokens.inc(n_active)
        self._h_step.observe(dt)
        self.step_times.append(dt)
        self.step_tokens.append(n_active)
        if self.steps > 1:       # step 1 carries first-call set-up
            self.step_ewma = (dt if self.step_ewma is None
                              else EWMA_ALPHA * dt
                              + (1 - EWMA_ALPHA) * self.step_ewma)

    def record_finish(self, ev: dict) -> None:
        """Fold one scheduler finish-log event into the counters."""
        if ev["slot"] is not None:
            self._evictions.inc()
        reason = ev["reason"]
        if reason == "cancel":
            self._cancelled.inc()
        elif reason == "shed":
            self._shed.inc()
        if ev["had_deadline"]:
            if reason == "stop" and ev["within_deadline"]:
                self._goodput_tokens.inc(ev["tokens"])
            else:
                self._deadline_miss.inc()
        elif reason == "stop":
            self._goodput_tokens.inc(ev["tokens"])

    def record_rejection(self) -> None:
        self._rejected_queue_full.inc()

    def record_watchdog(self) -> None:
        self._watchdog_stalls.inc()

    def record_brownout_clamp(self) -> None:
        self._brownout_clamped.inc()

    def set_queue_depth(self, n: int) -> None:
        self._queue_depth.set(n)

    def set_brownout_level(self, level: int) -> None:
        self._brownout_level.set(level)

    def set_page_stats(self, occupancy: float, hit_rate: float,
                       cow: int) -> None:
        self._page_occupancy.set(occupancy)
        self._prefix_hit_rate.set(hit_rate)
        self._cow_copies.set(cow)

    # -- read surface -------------------------------------------------------

    prefill_tokens = property(lambda s: s._prefill_tokens.value)
    prefill_time = property(lambda s: s._prefill_time.value)
    decoded_tokens = property(lambda s: s._decoded_tokens.value)
    decode_time = property(lambda s: s._decode_time.value)
    steps = property(lambda s: s._steps.value)
    admissions = property(lambda s: s._admissions.value)
    evictions = property(lambda s: s._evictions.value)
    page_occupancy = property(lambda s: s._page_occupancy.value)
    prefix_hit_rate = property(lambda s: s._prefix_hit_rate.value)
    cow_copies = property(lambda s: int(s._cow_copies.value))
    shed = property(lambda s: s._shed.value)
    cancelled = property(lambda s: s._cancelled.value)
    deadline_misses = property(lambda s: s._deadline_miss.value)
    rejected_queue_full = property(lambda s: s._rejected_queue_full.value)
    watchdog_stalls = property(lambda s: s._watchdog_stalls.value)
    brownout_clamped = property(lambda s: s._brownout_clamped.value)
    goodput_tokens = property(lambda s: s._goodput_tokens.value)
    brownout_level = property(lambda s: int(s._brownout_level.value))

    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / max(self.prefill_time, 1e-9)

    def decode_tok_s(self) -> float:
        return self.decoded_tokens / max(self.decode_time, 1e-9)

    def goodput_tok_s(self) -> float:
        return (self.goodput_tokens
                / max(self.decode_time + self.prefill_time, 1e-9))

    def token_latency_percentiles(self, qs=(50, 99)) -> dict:
        """Per-token latency: each live token of a step took its wall time."""
        if not self.step_times:
            return {q: 0.0 for q in qs}
        lats = np.repeat(np.fromiter(self.step_times, np.float64),
                         np.fromiter(self.step_tokens, np.int64))
        return {q: float(np.percentile(lats, q)) for q in qs}

    def ttft_percentiles(self, qs=(50, 99)) -> dict:
        if not self.ttfts:
            return {q: 0.0 for q in qs}
        arr = np.fromiter(self.ttfts, np.float64)
        return {q: float(np.percentile(arr, q)) for q in qs}

    def queue_wait_percentiles(self, qs=(50, 99)) -> dict:
        if not self.queue_waits:
            return {q: 0.0 for q in qs}
        arr = np.fromiter(self.queue_waits, np.float64)
        return {q: float(np.percentile(arr, q)) for q in qs}


def _signature(args) -> tuple:
    """(shape, dtype, device) of every tensor in ``args`` (nested dicts,
    lists and tuples), in order: what a dispatch's operations depend on
    besides tensor values."""
    sig = []

    def rec(x):
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.dtype, x.device))
        elif isinstance(x, dict):
            for v in x.values():
                rec(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                rec(v)

    rec(args)
    del rec                      # break the closure's cycle
    return tuple(sig)


class Engine:
    """Continuous-batching inference engine over a fixed slot pool."""

    def __init__(self, model, params, *, max_slots: int = 8,
                 max_seq: int = 256, prefill_chunk: int = 32,
                 fused_sampling: bool = False, attn_impl: str | None = None,
                 page_size: int = 16, num_pages: int = 0,
                 prefix_cache: bool = True, max_queue: int = 0,
                 shed_policy: str = "reject-newest",
                 watchdog_k: float = 6.0, brownout: bool = True,
                 brownout_max_new: int = 16, finished_keep: int = 4096,
                 guardrails: bool = True, clock=None, cost_model=None,
                 device=None):
        """``device`` defaults to ``cuda`` (raising when no GPU is
        visible); ``device="cpu"`` runs the kernels' plain versions.
        ``params`` are the model's master parameters: the engine keeps a
        copy cast to the compute dtype on ``device``.

        ``page_size`` > 0 runs the paged KV cache over ``num_pages``
        physical pages (0: the worst case, every slot can reach
        ``max_seq``); ``page_size=0`` keeps the contiguous pool.
        ``prefix_cache`` hands shared page-aligned prompt prefixes to new
        requests by refcount.

        SLO guardrails (all host-side): ``max_queue`` bounds the submit
        queue (0 = unbounded) with ``shed_policy`` deciding who loses;
        requests may carry ``deadline_ms``/``max_queue_ms`` budgets
        (hopeless queued requests are shed, in-flight ones past deadline
        cancelled at step boundaries); ``watchdog_k`` flags a decode
        dispatch slower than k x the step-time EWMA; ``brownout``
        degrades service under sustained page-pool pressure (prefix-cache
        registration off, then queued ``max_new`` clamped to
        ``brownout_max_new``). ``guardrails=False`` enforces none of it
        (budgets are still recorded, so goodput is measured).
        ``clock``/``cost_model`` are the seams ``serve.chaos`` drives
        virtual time through (None: the wall clock)."""
        cfg = model.cfg
        if cfg.family != "decoder":
            raise ValueError(f"serve engine supports decoder models, "
                             f"got family={cfg.family!r}")
        self.device = default_device(device)
        if attn_impl:
            cfg = with_attn_impl(cfg, attn_impl)
        if attn_impl or model.device != self.device:
            model = build_model(cfg, self.device)
        if cfg.ssm is not None and prefill_chunk % cfg.ssm.chunk:
            # SSD block boundaries must align across chunked calls for the
            # cache state to match a single-call prefill bitwise
            prefill_chunk += cfg.ssm.chunk - prefill_chunk % cfg.ssm.chunk
        if max_seq % prefill_chunk:
            # every chunk writes a full [pos0, pos0+C) window: round the
            # pool up so the last window never crosses max_seq
            max_seq += prefill_chunk - max_seq % prefill_chunk
        if page_size > 0 and max_seq % page_size:
            max_seq += page_size - max_seq % page_size
        self.model = model
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.fused_sampling = fused_sampling
        self.guardrails = guardrails
        self.watchdog_k = watchdog_k
        self.brownout = brownout and guardrails
        self.brownout_max_new = brownout_max_new
        self._brownout_level = 0
        self._hot = [0, 0]       # consecutive steps above HI1 / HI2
        self._cool = 0           # consecutive steps below LO
        self.draining = False
        self._clock = clock or time.perf_counter
        self._cost_model = cost_model
        # distinct argument signatures each dispatch has seen
        self._sigs = {"prefill": set(), "decode": set(), "sample": set()}
        self.params = cast_params(_to(params, self.device),
                                  dtype_of(cfg.dtype))

        # a pure-SSM family has no sequence-axis leaves to page: it falls
        # back to the slot-granular pool
        self.paged = page_size > 0 and cfg.attention is not None
        self.page_size = page_size if self.paged else 0
        self.allocator = None
        sched_kw = dict(max_queue=max_queue if guardrails else 0,
                        shed_policy=shed_policy,
                        finished_keep=finished_keep, clock=self._clock)
        if self.paged:
            pps = max_seq // page_size
            if num_pages <= 0:
                # worst case + the null page + one spare for a full-hit COW
                num_pages = max_slots * pps + 2
            self.num_pages = num_pages
            self.pool = cache_mod.make_paged_pool(model, max_slots, page_size,
                                                  num_pages)
            # SSM state is not rebuilt from cached pages: no prefix cache
            self.allocator = cache_mod.PageAllocator(
                num_pages, page_size, max_slots, pps,
                prefix_cache=prefix_cache and cfg.ssm is None)
            self.sched = SlotScheduler(max_slots, max_seq,
                                       allocator=self.allocator, **sched_kw)
        else:
            self.num_pages = 0
            self.pool = cache_mod.make_pool(model, max_slots, max_seq)
            self.sched = SlotScheduler(max_slots, max_seq, **sched_kw)
        self.stats = EngineStats()
        if telemetry.enabled():
            telemetry.attach_registry(self.stats.registry)

        # per-slot sampling state (host mirrors, uploaded per dispatch)
        self._temps = np.zeros((max_slots,), np.float32)
        self._top_ks = np.zeros((max_slots,), np.int32)
        self._top_ps = np.ones((max_slots,), np.float32)
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(max_slots)]
        self._zero_noise = torch.zeros((max_slots, cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=self.device)
        self._ones = torch.ones((max_slots, 1), dtype=torch.float32,
                                device=self.device)

        # the first call of each is timed as its compile/* gauge (kernel
        # builds, first allocations); later calls feed profile.observe.
        # They wrap the class's functions, not bound methods: a wrapper
        # held by the engine that held the engine would keep its pool and
        # parameters on the card until the cycle collector ran
        self._prefill = profile.instrument("serve/prefill_chunk",
                                           Engine._prefill_chunk)
        self._decode = profile.instrument("serve/decode_step",
                                          Engine._decode_step)
        self._prefill_warm = False
        self._det_step = anomaly.StreamDetector(
            "serve/step_time", registry=self.stats.registry)

    @property
    def trace_counts(self) -> dict:
        """Distinct argument signatures (every tensor's shape, dtype and
        device) that ``prefill``, ``decode`` and ``sample`` have been
        dispatched with: the counterpart of the reference's jit trace
        counts. Requests joining or leaving must leave ``decode`` at 1."""
        return {k: len(v) for k, v in self._sigs.items()}

    def _seen(self, program: str, *args) -> None:
        self._sigs[program].add(_signature(args))

    # -- device steps -------------------------------------------------------

    def _tensor(self, x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _tables(self):
        """This dispatch's block tables (same shape every time), or None."""
        if self.allocator is None:
            return None
        return self._tensor(self.allocator.tables, torch.int32)

    def _prefill_chunk(self, tokens, slot: int, pos0: int, valid: int):
        """One prompt chunk into one slot's lane (contiguous) or its block
        table's pages (paged). Returns the chunk's logits (1, C, V)."""
        if self.paged:
            view = cache_mod.paged_view(self.pool, slot)
            tables = self._tables()[slot:slot + 1]
            self._seen("prefill", self.params, view, tokens, tables)
            logits, view = self.model.chunk_prefill(
                self.params, view, tokens, pos0, valid, seq_len=self.max_seq,
                block_tables=tables, page_size=self.page_size)
            self.pool = cache_mod.paged_write(self.pool, slot, view)
        else:
            view = cache_mod.slot_view(self.pool, slot)
            self._seen("prefill", self.params, view, tokens)
            logits, view = self.model.chunk_prefill(
                self.params, view, tokens, pos0, valid, seq_len=self.max_seq)
            self.pool = cache_mod.slot_write(self.pool, slot, view)
        return logits

    def _sample_prefill(self, logits, valid: int, slot: int) -> int:
        """Sample the prompt continuation from the last valid prefill row."""
        temp = float(self._temps[slot])
        V = logits.shape[-1]
        noise = (sampling_mod.gumbel_noise(self._gens[slot:slot + 1], V,
                                           self.device)
                 if temp > 0.0 else self._zero_noise[:1])
        t = self._tensor([temp], torch.float32)
        if self.fused_sampling:
            onehot = (torch.arange(logits.shape[1], device=self.device)
                      == valid - 1).float()[None]
            self._seen("sample", logits, onehot, t, noise)
            greedy, sampled = slot_gather_sample(logits, onehot, t, noise)
            return int((greedy if temp <= 0.0 else sampled)[0])
        row = logits[0, valid - 1][None]
        top_k = self._tensor(self._top_ks[slot:slot + 1], torch.int32)
        top_p = self._tensor(self._top_ps[slot:slot + 1], torch.float32)
        self._seen("sample", row, t, top_k, top_p, noise)
        tok = sampling_mod.sample_tokens(row, t, top_k, top_p, noise)
        return int(tok[0])

    def _decode_step(self, tokens, pos):
        """One decode step for the whole slot pool + sampling. Returns the
        sampled token per slot as a host array (the sync point)."""
        tables = self._tables()
        temps = self._tensor(self._temps, torch.float32)
        # all-greedy steps (the default) skip the (S, V) Gumbel draw
        noise = (sampling_mod.gumbel_noise(self._gens, self.cfg.vocab_size,
                                           self.device)
                 if (self._temps > 0.0).any() else self._zero_noise)
        if self.fused_sampling:
            extra = (self._ones,)
        else:
            extra = (self._tensor(self._top_ks, torch.int32),
                     self._tensor(self._top_ps, torch.float32))
        self._seen("decode", self.params, self.pool, tokens, pos, tables,
                   temps, noise, *extra)
        logits, self.pool = self.model.decode_step(
            self.params, self.pool, {"tokens": tokens}, pos,
            seq_len=self.max_seq, block_tables=tables,
            page_size=self.page_size)
        if self.fused_sampling:
            greedy, sampled = slot_gather_sample(logits, self._ones, temps,
                                                 noise)
            tok = torch.where(temps <= 0.0, greedy, sampled)
        else:
            tok = sampling_mod.sample_tokens(logits[:, 0], temps, *extra,
                                             noise)
        return tok.cpu().numpy()

    # -- host loop ----------------------------------------------------------

    def submit(self, tokens, max_new: int,
               sampling: SamplingParams | None = None,
               eos: int | None = None, *,
               deadline_ms: float | None = None,
               max_queue_ms: float | None = None) -> AdmissionResult:
        """Queue a request. Returns an :class:`AdmissionResult` that
        coerces to the request id when accepted; a full bounded queue (or
        a draining engine) rejects with no state changed. Malformed or
        never-fits requests raise ``ValueError``."""
        sampling = sampling or SamplingParams()
        if self.fused_sampling and sampling_mod.needs_full_path(sampling):
            raise ValueError("fused_sampling engine handles greedy/"
                             "temperature only; top-k/top-p need the full "
                             "path (fused_sampling=False)")
        if self.draining:
            self.stats.record_rejection()
            return AdmissionResult(-1, REJECTED_QUEUE_FULL, "engine draining")
        req = Request(tokens=list(map(int, tokens)), max_new=max_new,
                      sampling=sampling, eos=eos, deadline_ms=deadline_ms,
                      max_queue_ms=max_queue_ms)
        res = self.sched.submit(req)
        if not res:
            self.stats.record_rejection()
        self._account_finished()    # a displaced victim (reject-no-deadline)
        self.stats.set_queue_depth(self.sched.queue_depth)
        return res

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is (queued or in flight); its pages
        are released exactly as on a natural finish. False for unknown or
        finished rids."""
        ok = self.sched.cancel(rid)
        if ok:
            self._account_finished()
        return ok

    def _bind_slot(self, slot: int, req: Request) -> None:
        s = req.sampling
        self._temps[slot] = s.temperature
        self._top_ks[slot] = s.top_k
        self._top_ps[slot] = s.top_p
        # a request's sample stream is a function of its seed alone
        self._gens[slot].manual_seed(s.seed)

    def _make_writable(self, slot: int, lo: int, hi: int) -> None:
        """Pages covering rows [lo, hi) of ``slot`` become private before a
        dispatch writes them: first touch allocates, a shared page is
        copied (copy-on-write)."""
        ps = self.page_size
        for j in range(lo // ps, -(-hi // ps)):
            for dst, src in self.allocator.ensure_writable(slot, j * ps):
                self.pool = cache_mod.copy_page(self.pool, dst, src)

    def _prefill_request(self, slot: int, req: Request) -> None:
        self._bind_slot(slot, req)
        toks = np.asarray(req.tokens, np.int64)
        S0, C = len(req.tokens), self.prefill_chunk
        # prefix-cache hits skip their pages; a full-prompt hit re-runs the
        # last prompt token for its logits (its write copies the shared page)
        hit = self.sched.slots[slot].hit_tokens
        start = S0 - 1 if hit >= S0 else hit
        t0 = self._clock()
        with trace.span("serve/prefill", slot=slot, rid=req.rid, tokens=S0,
                        cached=hit):
            if self.cfg.ssm is not None:
                # the SSM conv/state carry across prefill chunks, so a
                # previous occupant's must not leak in; attention rows need
                # no zeroing (stale rows stay causally masked)
                self.pool = cache_mod.reset_slot_ssm(self.pool, slot)
            logits, valid = None, 0
            for c in range(start, S0, C):
                sl = toks[c:c + C]
                valid = len(sl)
                if valid < C:
                    sl = np.pad(sl, (0, C - valid))
                if self.paged:
                    self._make_writable(slot, c, c + valid)
                t_c = self._clock()
                logits = self._prefill(
                    self, self._tensor(sl[None], torch.int64), slot, c,
                    valid)
                if self._cost_model is not None:
                    self._clock.advance(self._cost_model("prefill_chunk", C))
                if self._prefill_warm:
                    profile.observe("serve/prefill_chunk",
                                    self._clock() - t_c)
                else:
                    self._prefill_warm = True
            if self.allocator is not None and self._brownout_level < 1:
                # brownout level >= 1 stops publishing new prefixes: cache
                # holds are the pressure being shed
                self.allocator.register_prefix(slot, toks)
            tok = self._sample_prefill(logits, valid, slot)
        self.stats.record_prefill(S0 - start, self._clock() - t0)
        self.sched.record_first_token(slot, tok)
        self.stats.record_first_token(req.ttft)

    def _account_finished(self) -> None:
        while self.sched.finish_log:
            self.stats.record_finish(self.sched.finish_log.popleft())

    # -- SLO guardrails (all host-side, between dispatches) -----------------

    def _estimate_service_s(self, req: Request) -> float:
        """Admission-time completion estimate from measured rates (prompt
        over the prefill rate + ``max_new`` steps at the step EWMA);
        unmeasured parts count 0, so a cold engine never sheds blind."""
        est = 0.0
        st = self.stats
        if st.prefill_tokens > 0 and st.prefill_time > 0:
            est += len(req.tokens) / st.prefill_tok_s()
        if st.step_ewma is not None:
            est += req.max_new * st.step_ewma
        return est

    def _shed_hopeless(self, now: float) -> None:
        """Shed queued requests whose queue budget is blown or whose
        deadline can no longer be met."""
        for req in list(self.sched.pending):
            over_queue = (req.max_queue_ms is not None
                          and now - req.t_submit > req.max_queue_ms / 1e3)
            dl = req.deadline_at
            hopeless = (dl is not None
                        and now + self._estimate_service_s(req) > dl)
            if over_queue or hopeless:
                self.sched.shed_queued(req, FINISH_SHED)
                trace.instant("serve/shed", rid=req.rid,
                              why="queue_budget" if over_queue
                              else "deadline_unmeetable")

    def _update_brownout(self, occupancy: float) -> None:
        """Walk the brownout ladder on sustained page-pool pressure:
        level 1 stops prefix-cache registration, level 2 also clamps
        queued requests' ``max_new``. Hysteresis: entering needs
        ``BROWNOUT_PATIENCE`` consecutive hot steps, leaving needs as many
        below the low watermark."""
        if occupancy >= BROWNOUT_HI1:
            self._hot[0] += 1
            self._hot[1] = (self._hot[1] + 1 if occupancy >= BROWNOUT_HI2
                            else 0)
            self._cool = 0
        else:
            self._hot = [0, 0]
            self._cool = self._cool + 1 if occupancy < BROWNOUT_LO else 0
        if self._hot[1] >= BROWNOUT_PATIENCE:
            level = 2
        elif self._hot[0] >= BROWNOUT_PATIENCE:
            level = max(self._brownout_level, 1)
        elif self._cool >= BROWNOUT_PATIENCE:
            level = 0
        else:
            level = self._brownout_level
        if level != self._brownout_level:
            trace.instant("serve/brownout", level=level,
                          occupancy=round(occupancy, 3))
        self._brownout_level = level
        self.stats.set_brownout_level(level)
        if level >= 2:
            for req in self.sched.pending:
                if req.max_new > self.brownout_max_new:
                    req.max_new = self.brownout_max_new
                    self.stats.record_brownout_clamp()

    def step(self) -> int:
        """Admit + prefill new requests, run one decode step over the pool.
        Returns the number of live tokens produced."""
        now = self._clock()
        if self.guardrails:
            if not self.draining:
                self._shed_hopeless(now)
            for rid in self.sched.cancel_past_deadline(now):
                trace.instant("serve/deadline_cancel", rid=rid)
        self._account_finished()
        if not self.draining:
            for slot, req in self.sched.admit():
                self.stats.record_admission(req.queue_wait)
                self._prefill_request(slot, req)
        self._account_finished()       # max_new=1/eos at the first token
        n_active = self.sched.num_active
        self.stats.set_queue_depth(self.sched.queue_depth)
        if self.allocator is not None:
            occ = self.allocator.occupancy()
            self.stats.set_page_stats(occ, self.allocator.hit_rate(),
                                      self.allocator.cow_copies)
            if self.brownout:
                self._update_brownout(occ)
        else:
            self.stats.set_page_stats(n_active / self.max_slots, 0.0, 0)
        if n_active == 0:
            return 0
        if self.paged:
            # each live slot writes cache row st.pos: make its page private
            # (idle slots park on the null page)
            for slot, st in enumerate(self.sched.slots):
                if st is not None:
                    self._make_writable(slot, st.pos, st.pos + 1)
        tokens = self._tensor(self.sched.feed_tokens(), torch.int64)[:, None]
        pos = self._tensor(self.sched.positions(), torch.int64)
        ewma_prior = self.stats.step_ewma
        t0 = self._clock()
        with trace.span("serve/decode_step", active=n_active):
            tok = self._decode(self, tokens, pos)
        if self._cost_model is not None:
            self._clock.advance(self._cost_model("decode", n_active))
        dt = self._clock() - t0
        if self.stats.steps > 0:     # step 0 carries first-call set-up
            profile.observe("serve/decode_step", dt)
            self._det_step.observe(dt)
            if (self.guardrails and ewma_prior is not None
                    and dt > self.watchdog_k * ewma_prior):
                # the stuck-step watchdog: this dispatch blew far past the
                # EWMA (a wedged device shows up here before anything else)
                self.stats.record_watchdog()
                trace.instant("serve/watchdog_stall", dt=round(dt, 6),
                              ewma=round(ewma_prior, 6), k=self.watchdog_k)
        self.sched.record_step(tok)
        self._account_finished()
        self.stats.record_decode(n_active, dt)
        return n_active

    def run(self) -> dict:
        """Drive to completion; returns {request id: generated tokens}."""
        while self.sched.has_work():
            self.step()
        return self.sched.results()

    # -- graceful drain + crash-safe restore --------------------------------

    def drain(self, path: str | None = None, *,
              max_steps: int | None = None) -> dict:
        """Graceful drain: stop admitting, finish what is in flight (up to
        ``max_steps`` dispatches), snapshot the host-side request state.
        Queued (and still unfinished in-flight) requests are recorded by
        prompt; a restored engine re-runs them from scratch, which is
        bit-identical for greedy and seeded sampling. ``path`` writes the
        snapshot crash-safely (temp file, fsync, rename) with a crc32, in
        the reference's layout: either package loads the other's."""
        self.draining = True
        steps = 0
        while (self.sched.num_active > 0
               and (max_steps is None or steps < max_steps)):
            self.step()
            steps += 1
        self._account_finished()
        snap = self._snapshot()
        if path is not None:
            payload = json.dumps(snap, sort_keys=True).encode()
            _atomic_write(path, json.dumps(
                {"schema": SNAPSHOT_SCHEMA, "crc": zlib.crc32(payload),
                 "payload": snap}, sort_keys=True).encode())
        trace.instant("serve/drain", steps=steps,
                      queued=len(snap["queued"]),
                      inflight=len(snap["inflight"]))
        return snap

    def _snapshot(self) -> dict:
        sched = self.sched
        return {
            "rid_next": sched._next_rid,
            "queued": [r.to_state() for r in sched.pending],
            "inflight": [st.req.to_state() for st in sched.slots
                         if st is not None],
            "finished": [{"req": st.req.to_state(),
                          "generated": list(st.generated),
                          "reason": st.req.finish_reason}
                         for st in sched.finished.values()],
            "finished_total": sched.finished_total,
            "finished_dropped": sched.finished_dropped,
        }

    def load_snapshot(self, path_or_snap) -> list:
        """Restore a drained engine's unfinished work into this fresh
        engine: finished results come back verbatim, queued and
        interrupted in-flight requests are re-queued under their original
        rids (deadlines restart from now). Returns the re-queued rids. A
        corrupt snapshot file fails its crc32 check and raises."""
        if isinstance(path_or_snap, str):
            with open(path_or_snap, "rb") as f:
                wrapper = json.load(f)
            payload = json.dumps(wrapper["payload"], sort_keys=True).encode()
            if zlib.crc32(payload) != wrapper["crc"]:
                raise ValueError(f"serve snapshot {path_or_snap!r} failed its "
                                 f"crc32 integrity check")
            snap = wrapper["payload"]
        else:
            snap = path_or_snap
        sched = self.sched
        if sched.finished or sched.has_work():
            raise ValueError("load_snapshot needs a fresh engine")
        for ent in snap["finished"]:
            req = Request.from_state(ent["req"])
            req.finish_reason = ent["reason"]
            sched.finished[req.rid] = SlotState(
                req=req, generated=list(ent["generated"]), done=True)
        sched.finished_total = int(snap["finished_total"])
        sched.finished_dropped = int(snap["finished_dropped"])
        sched._next_rid = int(snap["rid_next"])
        requeued = []
        # interrupted in-flight requests re-run from their prompts, ahead
        # of the still-queued tail: the original FIFO order survives
        for ent in snap["inflight"] + snap["queued"]:
            req = Request.from_state(ent)
            sched.resubmit(req)
            requeued.append(req.rid)
        self.stats.set_queue_depth(sched.queue_depth)
        return requeued

    def reset_stats(self) -> None:
        """Zero the timing stats (after a warm-up). ``trace_counts`` is not
        reset: one signature a dispatch holds for the engine's lifetime."""
        telemetry.detach_registry(self.stats.registry)
        self.stats = EngineStats()
        self._det_step = anomaly.StreamDetector(
            "serve/step_time", registry=self.stats.registry)
        if telemetry.enabled():
            telemetry.attach_registry(self.stats.registry)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)
