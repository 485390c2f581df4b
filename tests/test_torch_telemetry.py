"""The telemetry core pinned to the JAX package's: every copied module is
held to its original on the same inputs.

- registry: snapshots of every metric kind, the sinks' records (memory,
  JSONL, console) and the shared no-op;
- schema: the validators on good and broken records, files and BENCH
  objects give the same findings; a metrics JSONL and a Perfetto trace
  written by the port pass the reference's own validators, and the
  reference's pass the port's;
- anomaly: ``StreamDetector`` and ``FleetDetector`` flag the same
  observations of seeded streams;
- profile: the same gauges and summary from the same observations;
  ``capture`` and ``roofline`` refuse by name (no cost model yet);
- the one switch: ``REPRO_TELEMETRY=0`` makes every accessor, the span
  trace and the detectors no-ops;
- the trace's Chrome export, the report and the validate CLI.
Everything is exact but times, pids, thread ids and the run context.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import telemetry as jtel  # noqa: E402
from repro.telemetry import anomaly as janomaly  # noqa: E402
from repro.telemetry import profile as jprofile  # noqa: E402
from repro.telemetry import registry as jregistry  # noqa: E402
from repro.telemetry import report as jreport  # noqa: E402
from repro.telemetry import schema as jschema  # noqa: E402
from repro.telemetry import trace as jtrace  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.telemetry import anomaly as tanomaly  # noqa: E402
from repro_torch.telemetry import profile as tprofile  # noqa: E402
from repro_torch.telemetry import registry as tregistry  # noqa: E402
from repro_torch.telemetry import report as treport  # noqa: E402
from repro_torch.telemetry import schema as tschema  # noqa: E402
from repro_torch.telemetry import trace as ttrace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"jax": (jtel, jregistry, jschema, janomaly, jprofile, jtrace,
                 jreport),
         "port": (ttel, tregistry, tschema, tanomaly, tprofile, ttrace,
                  treport)}


@pytest.fixture(autouse=True)
def _fresh():
    """Each test starts and ends with both packages' telemetry on and
    empty."""
    for tel, *_ in SIDES.values():
        tel.set_enabled(True)
        tel.reset()
        tel.trace.reset()
    yield
    for tel, *_ in SIDES.values():
        tel.set_enabled(True)
        tel.reset()
        tel.trace.reset()


def _fill(reg_mod, label="train"):
    obs = np.random.default_rng(0).lognormal(-5, 2, 300)
    r = reg_mod.Registry(label=label)
    r.counter("train/steps").inc(7)
    r.gauge("train/loss").set(2.5)
    r.info("train/plan", algo="easgd", tau=4, exchanger="asa16")
    h = r.histogram("train/step_time_s")
    for x in obs:
        h.observe(x)
    r.histogram("exchange/bytes", buckets=(1, 10, 100)).observe(50)
    return r


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


# ---------------------------------------------------------------------------
# registry and sinks
# ---------------------------------------------------------------------------

def test_registry_snapshot_every_kind_same():
    j, t = _fill(jregistry), _fill(tregistry)
    assert t.snapshot(ts=2.0) == j.snapshot(ts=2.0)
    assert t.names() == j.names()
    with pytest.raises(TypeError) as te:
        t.gauge("train/steps")
    with pytest.raises(TypeError) as je:
        j.gauge("train/steps")
    assert str(te.value) == str(je.value)


def test_memory_and_console_sinks_same():
    out = {}
    for side, reg_mod in (("jax", jregistry), ("port", tregistry)):
        r = _fill(reg_mod)
        mem, lines = reg_mod.MemorySink(), []
        r.add_sink(mem)
        r.add_sink(reg_mod.ConsoleSink(print_fn=lines.append, every_s=0))
        r.flush(force=True)
        r.counter("train/steps").inc()
        r.close()
        out[side] = ([_strip(s) for s in mem.snapshots], lines)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 2


def test_jsonl_sink_same_records(tmp_path):
    recs = {}
    for side, reg_mod in (("jax", jregistry), ("port", tregistry)):
        path = tmp_path / f"{side}.jsonl"
        r = _fill(reg_mod)
        r.add_sink(reg_mod.JsonlSink(str(path)))
        r.close()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert lines[0]["kind"] == "run"
        recs[side] = _strip(lines[1:])
    assert recs["port"] == recs["jax"]


def test_noop_same_surface():
    for attr in ("kind", "name", "value", "count", "sum", "mean"):
        assert getattr(tregistry.NOOP, attr) == getattr(jregistry.NOOP, attr)
    for reg_mod in (jregistry, tregistry):
        n = reg_mod.NOOP
        n.inc(3), n.set(1.0), n.set(a="b"), n.observe(2.0)
    assert tregistry.NOOP.percentiles((50, 99)) == \
        jregistry.NOOP.percentiles((50, 99))


# ---------------------------------------------------------------------------
# the runtime, the accessors and the one switch
# ---------------------------------------------------------------------------

def _drive_runtime(tel, path):
    from importlib import import_module
    metrics = import_module(tel.__name__ + ".metrics")
    tel.configure(metrics_out=str(path))
    metrics.counter("fault/kills").inc(2)
    metrics.gauge("fault/live_workers").set(3)
    metrics.histogram("train/step_time_s").observe(0.25)
    metrics.info("fault/plan", algo="easgd", quorum=2)
    side = tel.Registry(label="engine")
    side.counter("serve/steps").inc(5)
    tel.attach_registry(side)
    tel.flush(force=True)
    got = [metrics.get("fault/kills").value, metrics.get("nope"),
           tel.enabled(), tel.config().grad_norm]
    tel.detach_registry(side)
    tel.dump_metrics(str(path) + ".dump")
    return got


def test_runtime_and_accessors_same(tmp_path):
    got, files = {}, {}
    for side, (tel, *_) in SIDES.items():
        got[side] = _drive_runtime(tel, tmp_path / f"{side}.jsonl")
        files[side] = [_strip(json.loads(ln) for ln in
                              (tmp_path / f"{side}{ext}").read_text()
                              .splitlines()[1:])
                       for ext in (".jsonl", ".jsonl.dump")]
        tel.reset()
    assert got["port"] == got["jax"]
    assert files["port"] == files["jax"]
    assert any(r.get("name") == "serve/steps" for r in files["port"][0])


def test_disabled_switch_is_one_noop_everywhere():
    code = (
        "import sys\n"
        "from repro_torch import telemetry as t\n"
        "from repro_torch.telemetry import metrics, trace, anomaly, "
        "profile, registry\n"
        "assert not t.enabled()\n"
        "for m in (metrics.counter('a'), metrics.gauge('b'), "
        "metrics.histogram('c'), metrics.info('d', x=1)):\n"
        "    assert m is registry.NOOP\n"
        "with trace.span('x'):\n"
        "    trace.instant('y')\n"
        "assert trace.events() == [] and not trace._enabled()\n"
        "d = anomaly.StreamDetector('s')\n"
        "assert all(not d.observe(v)['spike'] for v in [1.0] * 20 + [1e6])\n"
        "assert anomaly.FleetDetector().observe({0: 1, 1: 1, 2: 99}) == []\n"
        "profile.observe('p', 1.0)\n"
        "assert profile.programs() == {}\n"
        "t.set_enabled(True)\n"
        "assert trace._enabled() and metrics.counter('a') is not "
        "registry.NOOP\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TELEMETRY="0")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_set_enabled_drives_the_trace_too():
    ttel.set_enabled(False)
    assert not ttrace._enabled()
    with ttrace.span("x"):
        pass
    assert ttrace.events() == []
    ttel.set_enabled(True)
    assert ttrace._enabled()


# ---------------------------------------------------------------------------
# schema and validators
# ---------------------------------------------------------------------------

GOOD = [{"schema_version": 1, "kind": "counter", "ts": 1.0, "name": "a",
         "value": 3},
        {"schema_version": 1, "kind": "info", "ts": 1.0, "name": "i",
         "labels": {"x": "y"}},
        {"schema_version": 1, "kind": "histogram", "ts": 1.0, "name": "h",
         "bounds": [1, 2], "counts": [0, 1, 0], "count": 1, "sum": 1.5,
         "min": 1.5, "max": 1.5},
        {"schema_version": 1, "kind": "run", "ts": 1.0,
         "run": {"host": "h", "backend": "cuda"}}]
BAD = [[], {"kind": "counter"}, {"schema_version": 1, "kind": "nope",
                                 "ts": 1},
       {"schema_version": 1, "kind": "gauge", "ts": "x", "name": "",
        "value": "v"},
       {"schema_version": 1, "kind": "histogram", "ts": 1, "name": "h",
        "bounds": [2, 1], "counts": [1, 1], "count": 3},
       {"schema_version": 1, "kind": "histogram", "ts": 1, "name": "h",
        "bounds": ["a"], "counts": [1, 1], "count": 2, "sum": 1, "min": 1,
        "max": 1},
       {"schema_version": 1, "kind": "info", "ts": 1, "name": "i"},
       {"schema_version": 1, "kind": "run", "ts": 1, "run": {"host": "h"}}]


@pytest.mark.parametrize("i", range(len(GOOD) + len(BAD)))
def test_validate_record_same_findings(i):
    rec = (GOOD + BAD)[i]
    got = tschema.validate_record(rec, "r")
    assert got == jschema.validate_record(rec, "r")
    assert (got == []) == (i < len(GOOD))


def test_file_and_bench_validators_same_findings(tmp_path):
    files = {"m_ok.jsonl": "\n".join(json.dumps(r) for r in
                                     [GOOD[3]] + GOOD[:3]),
             "m_bad.jsonl": '{"kind": "counter"}\nnot json\n',
             "m_empty.jsonl": "",
             "t_bad.json": json.dumps({"traceEvents": [
                 {"ph": "e", "name": "q", "id": 1, "pid": 0, "tid": 0,
                  "ts": 0}, {"ph": "Z"}, 5], "otherData": {}}),
             "t_notlist.json": json.dumps({"traceEvents": {}}),
             "b_ok.json": json.dumps({"schema_version": 1, "run": {
                 "backend": "cuda"}, "rows": [{"name": "x",
                                               "us_per_call": 1.0}]}),
             "b_bad.json": json.dumps({"rows": [{"name": "x"}, 3]})}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    for name in files:
        p = str(tmp_path / name)
        fn = {"m": "validate_metrics_jsonl", "t": "validate_trace",
              "b": "validate_bench_json"}[name[0]]
        assert getattr(tschema, fn)(p) == getattr(jschema, fn)(p), name
    assert tschema.validate_bench_obj(5) == jschema.validate_bench_obj(5)


def _write_run(tel, tmp_path, tag):
    """A metrics JSONL and a trace written through one package's
    telemetry."""
    from importlib import import_module
    metrics = import_module(tel.__name__ + ".metrics")
    path = tmp_path / f"{tag}.jsonl"
    tel.configure(metrics_out=str(path))
    metrics.counter("fault/kills").inc()
    metrics.histogram("train/step_time_s").observe(0.1)
    metrics.info("train/plan", algo="easgd")
    with tel.trace.span("fault/round", step=3, k=4):
        tel.trace.instant("fault/kill", worker=3)
    tel.trace.async_begin("serve/req", 7)
    tel.trace.async_end("serve/req", 7)
    tel.flush(force=True)
    trace_path = tel.trace.export(str(tmp_path / f"{tag}.trace.json"))
    return str(path), trace_path


def test_port_files_pass_the_reference_validators(tmp_path):
    m, t = _write_run(ttel, tmp_path, "port")
    assert jschema.validate_metrics_jsonl(m) == []
    assert jschema.validate_trace(t) == []
    run = json.loads(Path(m).read_text().splitlines()[0])["run"]
    assert run["backend"] in ("cpu", "cuda") and "torch" in run
    assert "jax" not in run
    other = json.loads(Path(t).read_text())["otherData"]
    assert other["schema_version"] == 1 and "torch" in other["run"]
    ttel.reset()
    jm, jt = _write_run(jtel, tmp_path, "jax")
    assert tschema.validate_metrics_jsonl(jm) == []
    assert tschema.validate_trace(jt) == []


def test_chrome_export_same_events(tmp_path):
    evs = {}
    for side, (tel, *_) in SIDES.items():
        _, path = _write_run(tel, tmp_path, side)
        evs[side] = [{k: v for k, v in e.items()
                      if k not in ("ts", "dur", "pid", "tid")}
                     for e in json.loads(Path(path).read_text())[
                         "traceEvents"]]
        tel.reset()
    assert evs["port"] == evs["jax"] and len(evs["port"]) == 4


def test_validate_cli_and_report(tmp_path):
    m, t = _write_run(ttel, tmp_path, "port")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ok = subprocess.run([sys.executable, "-m",
                         "repro_torch.telemetry.validate", m, "--trace", t],
                        env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and "OK" in ok.stdout, ok.stderr
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "counter"}\n')
    no = subprocess.run([sys.executable, "-m",
                         "repro_torch.telemetry.validate", str(bad)],
                        env=env, capture_output=True, text=True, timeout=120)
    assert no.returncode == 1 and "problem" in no.stdout
    # the report renders the same page as the reference's but the run
    # section, which names torch where the reference names jax
    strip = lambda md: md.split("## ", 2)[2]
    assert strip(treport.render(m, t)) == strip(jreport.render(m, t))
    assert "- **torch**" in treport.render(m, t)


# ---------------------------------------------------------------------------
# anomaly detectors
# ---------------------------------------------------------------------------

def _stream(seed):
    rng = np.random.default_rng(seed)
    x = list(rng.normal(1.0, 0.02, 200))
    x[50] = 5.0                                    # one spike
    x[120:] = [v * 2.0 for v in x[120:]]           # a sustained shift
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_detector_same_flags(seed):
    outs = {}
    for side, (tel, _, _, anom, *_) in SIDES.items():
        d = anom.StreamDetector("train/step_time")
        outs[side] = ([d.observe(v) for v in _stream(seed)], d.spikes,
                      d.regressions)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] >= 1 and outs["port"][2] >= 1
    assert ttel.metrics.get("anomaly/train_step_time/spikes").value == \
        outs["port"][1]


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_detector_same_flags(seed):
    rng = np.random.default_rng(seed)
    rounds = []
    for i in range(30):
        d = {w: float(rng.normal(1.0, 0.05)) for w in range(4)}
        if i % 7 == 3:
            d[i % 4] *= 8.0                         # a slow worker
        if i % 11 == 5:
            d = {w: 1.0 for w in range(4)} | {2: 8.0}   # ties: MAD 0
        rounds.append(d)
    rounds.append({0: 1.0, 1: 9.0})                 # below min_workers
    outs = {}
    for side, (_, _, _, anom, *_) in SIDES.items():
        for patience in (1, 2):
            f = anom.FleetDetector(patience=patience)
            outs.setdefault(side, []).append(
                ([f.observe(r) for r in rounds], f.flagged_total))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][1] >= 4


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

def _drive_profile(tel, prof):
    for name, times in (("train/local", [0.04, 0.05, 0.045]),
                        ("train/sync", [0.4, 0.5])):
        for s in times:
            prof.observe(name, s)
    prof.compile_time("train/local", 1.25)
    reg = tel.Registry()
    prof.emit(reg)
    return (prof.summary(), reg.snapshot(ts=1.0),
            prof.get("train/sync").gauges(), sorted(prof.programs()),
            tel.metrics.get("compile/train_local_s").value)


def test_profile_gauges_same():
    j = _drive_profile(jtel, jprofile)
    t = _drive_profile(ttel, tprofile)
    assert t == j
    assert t[2]["profile/train_sync/calls"] == 2.0


def test_profile_capture_and_roofline_refuse_by_name():
    with pytest.raises(NotImplementedError, match="roofline slice"):
        tprofile.capture("train/step", lambda x: x, 1)
    tprofile.observe("train/step", 0.1)
    with pytest.raises(NotImplementedError, match="roofline slice"):
        tprofile.get("train/step").roofline()


def test_profile_instrument_times_the_first_call():
    import torch
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale

    w = tprofile.instrument("train/demo", fn, coll_bytes=64.0)
    x = torch.ones(3)
    assert torch.equal(w(x, scale=2.0), x * 2)
    assert torch.equal(w(x), x)
    assert len(calls) == 2 and w.fn is fn
    assert tprofile.get("train/demo").compile_time_s > 0
    assert tprofile.get("train/demo").coll_bytes == 64.0
    assert ttel.metrics.get("compile/train_demo_s").value > 0
