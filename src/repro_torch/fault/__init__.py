"""`repro_torch.fault` — elastic fault-tolerant training (counterpart of
``repro.fault``).

- :mod:`repro_torch.fault.membership` — the membership controller:
  live-worker tracking between tau-step rounds, quorum decisions,
  staleness accounting, slot allocation for joiners (a copy).
- :mod:`repro_torch.fault.inject` — a declarative, seeded
  :class:`FaultPlan` (kill / join / straggle / drop / corrupt / slow at
  named steps) so every chaos run is exactly reproducible (a copy).
- :mod:`repro_torch.fault.elastic` — :func:`elastic_train`, the loop that
  drives the engine's quorum-sync programs on the ranks of a process
  group (the slots), re-forms the group on membership change and hands a
  joiner the center.
- :mod:`repro_torch.fault.smoke` — the chaos harness
  (``python -m repro_torch.fault.smoke``).
"""
from repro_torch.fault.inject import (FaultEvent, FaultPlan, bitflip,
                                      payload_checksum)
from repro_torch.fault.membership import MembershipController, WorkerState
from repro_torch.fault.elastic import ElasticReport, Preempted, elastic_train

__all__ = [
    "FaultEvent", "FaultPlan", "bitflip", "payload_checksum",
    "MembershipController", "WorkerState",
    "ElasticReport", "Preempted", "elastic_train",
]
