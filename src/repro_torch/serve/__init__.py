"""``repro_torch.serve`` — the continuous-batching inference engine.

- ``engine``    — :class:`Engine`: admission -> chunked prefill -> batched
                  per-slot decode -> sampling -> eviction loop
- ``scheduler`` — FIFO admission + slot lifecycle (host copy)
- ``cache``     — contiguous and paged KV pools, :class:`PageAllocator`
- ``sampling``  — greedy/temperature/top-k/top-p with per-slot noise
- ``chaos``     — the deterministic serve fault-injection loop (virtual
                  clock, seeded ``FaultPlan``), bit-identical replay and
                  drain -> restore checks
"""
from repro_torch.serve.engine import Engine, EngineStats
from repro_torch.serve.scheduler import (ACCEPTED, AdmissionResult,
                                         FINISH_CANCEL, FINISH_DEADLINE,
                                         FINISH_SHED, FINISH_STOP,
                                         REJECTED_QUEUE_FULL, Request,
                                         SamplingParams, SlotScheduler)

__all__ = ["Engine", "EngineStats", "Request", "SamplingParams",
           "SlotScheduler", "AdmissionResult", "ACCEPTED",
           "REJECTED_QUEUE_FULL", "FINISH_STOP", "FINISH_CANCEL",
           "FINISH_DEADLINE", "FINISH_SHED"]
