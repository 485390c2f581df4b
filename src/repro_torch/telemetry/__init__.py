"""Host-side telemetry for the port: the metrics registry and span trace
copied from ``repro.telemetry`` (the pieces the serve engine and its
scheduler use). Default-on; ``REPRO_TELEMETRY=0`` turns span recording
off, as in the JAX package. ``EngineStats`` registries are always live.
"""
from __future__ import annotations

import os

from repro_torch.telemetry import registry, trace

_enabled = [os.environ.get("REPRO_TELEMETRY", "1") not in ("0", "off",
                                                           "false")]


def enabled() -> bool:
    return _enabled[0]


def set_enabled(on: bool) -> None:
    _enabled[0] = bool(on)


__all__ = ["enabled", "set_enabled", "registry", "trace"]
