"""`repro_torch.telemetry` — metrics and span tracing for train, exchange,
fault and serve (counterpart of ``repro.telemetry``, with its export
list).

- a process-local **metrics registry** (counters / gauges / fixed-bucket
  histograms / info labels; bounded memory) with pluggable sinks — JSONL
  file, in-memory (tests), periodic console summary;
- a low-overhead **span API** (``with trace.span("fault/round"):``)
  exporting Chrome-trace/Perfetto JSON;
- one **schema** (versioned, with the host, torch, CUDA and card in its
  run context) that the reference's validators accept;
- step-time **anomaly** detectors and per-program **profile** gauges.

Host-side only: nothing here adds a device sync to a step. Default-on;
``REPRO_TELEMETRY=0`` switches every accessor, the span trace and the
detectors to a shared no-op (:mod:`_runtime` holds the one switch).
Standalone :class:`Registry` instances (``EngineStats``, the train
loop's) are always live.
"""
from repro_torch.telemetry import metrics, registry, trace
from repro_torch.telemetry import anomaly, profile
from repro_torch.telemetry._runtime import (TelemetryConfig, add_sink,
                                            attach_registry, config,
                                            configure, default_registry,
                                            detach_registry, dump_metrics,
                                            enabled, flush, reset,
                                            set_enabled)
from repro_torch.telemetry.registry import (ConsoleSink, Counter, Gauge,
                                            Histogram, Info, JsonlSink,
                                            MemorySink, NOOP, Registry,
                                            TIME_BUCKETS, exp_buckets)
from repro_torch.telemetry.schema import (SCHEMA_VERSION, run_context,
                                          run_record, validate_bench_json,
                                          validate_bench_obj,
                                          validate_metrics_jsonl,
                                          validate_record, validate_trace)

__all__ = [
    "metrics", "trace", "anomaly", "profile",
    "TelemetryConfig", "add_sink", "attach_registry", "config", "configure",
    "default_registry", "detach_registry", "dump_metrics", "enabled",
    "flush", "reset", "set_enabled",
    "ConsoleSink", "Counter", "Gauge", "Histogram", "Info", "JsonlSink",
    "MemorySink", "NOOP", "Registry", "TIME_BUCKETS", "exp_buckets",
    "SCHEMA_VERSION", "run_context", "run_record", "validate_bench_json",
    "validate_bench_obj", "validate_metrics_jsonl", "validate_record",
    "validate_trace",
]
