"""The port's step telemetry (`implicitglobalgrid_tpu_torch.utils.telemetry`)
against the JAX package's.

* The cases of the JAX package's ``tests/test_telemetry.py`` that have a
  meaning in the port: the registry's semantics and its disabled mode, the
  event log's schema, rank hint and coordinates, the per-step metrics of
  every model's ``run()`` and the heartbeat, ``T_eff``, `dump_metrics`,
  the Prometheus exposition's edge cases, the rolling SLO windows, a
  concurrent scrape, ``proc.rss_bytes`` and the progress record.
* Across packages: the same sequence of records into both registries gives
  equal `snapshot` values and an equal `prometheus_text`.
* Each model's ``run()`` with telemetry on is bit-identical to
  ``IGG_TELEMETRY=0``, per step and with ``fused_k`` (one group a call,
  the kernel's plain version on the CPU).

Everything runs on the CPU (``device="cpu"``) in float64 at 8^3.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.utils import config as jconfig
from implicitglobalgrid_tpu.utils import telemetry as jtele
from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d, porous_convection3d
from implicitglobalgrid_tpu_torch.utils import config as tconfig
from implicitglobalgrid_tpu_torch.utils import liveplane, tracing
from implicitglobalgrid_tpu_torch.utils import resilience as res
from implicitglobalgrid_tpu_torch.utils import telemetry as tele

NX = 8
KW = dict(quiet=True, device="cpu", dtype=torch.float64)
MODELS = {"diffusion3d": diffusion3d, "acoustic3d": acoustic3d,
          "porous_convection3d": porous_convection3d}
#: (model, run kwargs, nt): per step, and with the fused cadence on a
#: periodic deep-halo block (overlap 2k, one group a call)
RUNS = [
    ("diffusion3d", {}, 3),
    ("acoustic3d", {}, 2),
    ("porous_convection3d", {"npt": 2}, 1),
    ("diffusion3d", dict(fused_k=2, periodx=1, periody=1, periodz=1, overlapx=4,
                         overlapy=4, overlapz=4), 4),
    ("acoustic3d", dict(fused_k=2, periodz=1, overlapx=4, overlapy=4, overlapz=4), 4),
    ("porous_convection3d", dict(npt=4, fused_k=2, periodz=1, overlapx=4, overlapy=4,
                                 overlapz=4), 2),
]


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    tele.reset()
    jtele.reset()
    tracing.reset()
    liveplane.reset()
    res.reset_fault_injector()
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    tele.reset()
    jtele.reset()
    tracing.reset()
    liveplane.reset()


# -- the knobs of the planes ---------------------------------------------------------


@pytest.mark.parametrize("name,env,values", [
    ("trace_ring", "IGG_TRACE_RING", ["0", "16", "-1", "x", ""]),
    ("trace_sample", "IGG_TRACE_SAMPLE", ["0", "0.25", "1", "-0.5", "x"]),
    ("skew_warn", "IGG_SKEW_WARN", ["0", "2.5", "-1", "x"]),
    ("metrics_port", "IGG_METRICS_PORT", ["0", "9100", "-1", "x"]),
    ("metrics_host", "IGG_METRICS_HOST", ["127.0.0.1", "0.0.0.0", ""]),
    ("generation", "IGG_GENERATION", ["0", "3", "-1", "x"]),
    ("watchdog", "IGG_WATCHDOG_S", ["0", "1.5", "-2", "x"]),
])
def test_plane_knobs_parse_like_jax(name, env, values, monkeypatch):
    """The knobs `tracing` and `liveplane` read: the same names, parsing
    and range errors as the JAX package's."""
    for val in values:
        monkeypatch.setenv(env, val)
        outs = []
        for mod in (tconfig, jconfig):
            try:
                outs.append(("ok", getattr(mod, f"{name}_env")()))
            except ValueError as e:
                outs.append(("error", str(e)))
        assert outs[0] == outs[1], (env, val, outs)
    monkeypatch.delenv(env)
    assert getattr(tconfig, f"{name}_env")() is None


# -- registry semantics --------------------------------------------------------------


def test_counter_gauge_histogram_semantics():
    c = tele.counter("t.count")
    c.inc()
    c.inc(4)
    assert tele.counter("t.count") is c and c.value == 5
    g = tele.gauge("t.gauge")
    g.set(2.5)
    g.set(7)
    assert tele.gauge("t.gauge").value == 7.0
    h = tele.histogram("t.hist")
    for v in range(1, 101):
        h.record(float(v))
    s = h.summary()
    assert s["count"] == 100 and s["min"] == 1.0 and s["max"] == 100.0
    assert s["sum"] == pytest.approx(5050.0) and s["mean"] == pytest.approx(50.5)
    assert 40 <= s["p50"] <= 61 and s["p90"] >= s["p50"] and s["p99"] >= s["p90"]
    snap = tele.snapshot()
    assert snap["counters"]["t.count"] == 5 and snap["gauges"]["t.gauge"] == 7.0
    assert snap["histograms"]["t.hist"]["count"] == 100
    assert tele.gauge_value("t.gauge") == 7.0 and tele.gauge_value("t.none") is None


def test_histogram_reservoir_bounded_and_deterministic():
    h = tele.histogram("t.res")
    for v in range(10_000):
        h.record(float(v))
    assert h.count == 10_000 and len(h._samples) == tele.RESERVOIR_SIZE
    h2 = tele.Histogram("t.res2")
    for v in range(10_000):
        h2.record(float(v))
    assert h._samples == h2._samples


def test_disabled_mode_takes_zero_allocation_branch(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    assert not tele.enabled()
    assert tele.counter("t.x") is tele.NOOP and tele.gauge("t.y") is tele.NOOP
    assert tele.histogram("t.z") is tele.NOOP
    tele.NOOP.inc()
    tele.NOOP.set(1.0)
    tele.NOOP.record(1.0)
    assert tele.step_loop("m", bytes_per_step=8) is None
    assert tracing.trace_span("igg.step") is tracing.NOOP_SPAN
    tele.event("t.never", foo=1)
    assert list(tmp_path.iterdir()) == []
    snap = tele.snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {}


def test_disabled_model_run_records_nothing(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    diffusion3d.run(1, NX, NX, NX, **KW)
    snap = tele.snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {}
    assert tracing.span_records() == []


# -- the event log -------------------------------------------------------------------


def test_event_jsonl_schema_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    t0 = time.time()
    tele.event("unit.test", step=3, detail="abc")
    tele.event("unit.test2", nested={"a": 1})
    path = tmp_path / "events.jsonl"
    events = tele.read_events(path)
    assert [e["type"] for e in events] == ["unit.test", "unit.test2"]
    e = events[0]
    assert {"ts", "type", "rank", "pid", "coords"} <= set(e)
    assert t0 <= e["ts"] <= time.time()
    assert e["rank"] == 0 and e["pid"] == os.getpid()
    assert e["step"] == 3 and e["detail"] == "abc" and events[1]["nested"] == {"a": 1}
    tele.event("unit.test3")
    assert len(tele.read_events(path)) == 3


def test_event_coords_tagged_when_grid_up(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tele.event("before.grid")
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    tele.event("with.grid")
    events = tele.read_events(tmp_path / "events.jsonl")
    assert events[0]["coords"] is None
    assert events[-1]["coords"] == list(tigg.get_global_grid().coords)
    # init takes the clock-sync anchor (one process: no barrier)
    (sync,) = [e for e in events if e["type"] == "clock.sync"]
    assert sync["barrier"] is False and sync["uncertainty_s"] == 0.0


def test_event_rank_hint_during_bringup(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tele.set_rank_hint(3)
    tele.event("bringup.retry")
    (e,) = tele.read_events(tmp_path / "events.p3.jsonl")
    assert e["rank"] == 3
    tele.reset()
    tele.event("after.reset")
    (e2,) = tele.read_events(tmp_path / "events.jsonl")
    assert e2["rank"] == 0


def test_event_inside_a_request_context_carries_its_trace_id(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    ctx = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
    with tracing.use_context(ctx):
        tele.event("in.request")
    tele.event("outside")
    a, b = tele.read_events(tmp_path / "events.jsonl")
    assert a["trace_id"] == ctx["trace_id"] and "trace_id" not in b


def test_watchdog_deadline_exceeded_event_and_flight_bundle(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    with res.watchdog(0.05):
        time.sleep(0.12)
    events = tele.read_events(tmp_path / "events.jsonl")
    (e,) = [x for x in events if x["type"] == "watchdog.deadline_exceeded"]
    assert e["elapsed_s"] > e["timeout_s"] == 0.05
    snap = tele.snapshot()
    assert snap["counters"]["resilience.watchdog_deadline_exceeded"] == 1
    (bundle,) = tracing.read_flight_bundles(tmp_path / "flight_0.json")
    assert bundle["reason"] == "watchdog.deadline_exceeded"


def test_event_non_serializable_payload_stringified(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tele.event("odd.payload", obj=object())
    (e,) = tele.read_events(tmp_path / "events.jsonl")
    assert "object object" in e["obj"]


# -- the models' step telemetry --------------------------------------------------------


@pytest.mark.parametrize("model_name,run_kwargs,nt", RUNS)
def test_model_run_emits_per_step_metrics(model_name, run_kwargs, nt):
    MODELS[model_name].run(nt, NX, NX, NX, **KW, **run_kwargs)
    snap = tele.snapshot()
    assert snap["counters"][f"{model_name}.steps"] == nt
    step_s = snap["histograms"][f"{model_name}.step_seconds"]
    assert step_s["count"] == nt and step_s["min"] > 0
    teff = snap["histograms"][f"{model_name}.t_eff_gbs"]
    assert teff["count"] == nt and teff["min"] > 0
    assert snap["gauges"][f"{model_name}.steps_per_s"] > 0
    # one igg.step span per loop call, tagged with the step it ends on
    per_call = run_kwargs.get("fused_k", 1) if model_name != "porous_convection3d" else 1
    steps = [s["args"]["step"] for s in tracing.span_records() if s["name"] == "igg.step"]
    assert steps == list(range(per_call, nt + 1, per_call))
    assert [s["name"] for s in tracing.span_records()].count("igg.run.setup") == 1


def test_heartbeat_line_and_event(monkeypatch, tmp_path, capfd):
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", "1")
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    diffusion3d.run(2, NX, NX, NX, **KW)
    err = capfd.readouterr().err
    assert "[igg.telemetry] diffusion3d step" in err and "T_eff" in err
    events = tele.read_events(tmp_path / "events.jsonl")
    types = [e["type"] for e in events]
    assert types.count("heartbeat") == 2
    assert types[0] == "clock.sync"
    assert types[1] == "run.start" and types[-1] == "run.complete"
    hb = next(e for e in events if e["type"] == "heartbeat")
    assert hb["model"] == "diffusion3d" and hb["t_eff_gbs"] > 0
    assert "skew" not in hb and "serving" not in hb


@pytest.mark.parametrize("hb,want", [(2, [2, 4, 6, 8]), (4, [4, 8]), (3, [4, 6])])
def test_heartbeat_of_a_fused_group_fires_where_it_crosses_the_cadence(
        monkeypatch, tmp_path, hb, want):
    """A call of 2 steps records 2 per-step samples and heartbeats when it
    crossed a multiple of ``IGG_HEARTBEAT_EVERY`` (per step it is the JAX
    loop's ``it % every == 0``)."""
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", str(hb))
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    loop = tele.step_loop("m", bytes_per_step=8, total_steps=8)
    for it in (2, 4, 6, 8):
        loop.on_step(it, 2)
    loop.finish(8)
    events = tele.read_events(tmp_path / "events.jsonl")
    assert [e["step"] for e in events if e["type"] == "heartbeat"] == want
    snap = tele.snapshot()
    assert snap["counters"]["m.steps"] == 8
    assert snap["histograms"]["m.step_seconds"]["count"] == 8
    assert snap["histograms"]["m.t_eff_gbs"]["count"] == 8


def test_teff_bytes_model():
    T = torch.zeros((NX, NX, NX), dtype=torch.float32)
    V = torch.zeros((NX + 1, NX, NX), dtype=torch.float32)
    assert tele.teff_bytes([T]) == 2 * T.numel() * 4 == jtele.teff_bytes([T.numpy()])
    assert tele.teff_bytes([T, V]) == 2 * (T.numel() + V.numel()) * 4


# -- exposition ----------------------------------------------------------------------


def test_dump_metrics_json_and_prometheus(tmp_path):
    tele.counter("d.count").inc(3)
    tele.gauge("d.gauge").set(1.5)
    h = tele.histogram("d.hist")
    for v in (1.0, 2.0, 3.0):
        h.record(v)
    json_path, prom_path = tigg.dump_metrics(tmp_path / "metrics")
    with open(json_path) as f:
        snap = json.load(f)
    assert snap["counters"]["d.count"] == 3 and snap["histograms"]["d.hist"]["count"] == 3
    prom = open(prom_path).read()
    for line in ("# TYPE igg_d_count_total counter", "igg_d_count_total 3",
                 "# TYPE igg_d_gauge gauge", "# TYPE igg_d_hist summary",
                 'igg_d_hist{quantile="0.5"} 2.0', "igg_d_hist_sum 6.0", "igg_d_hist_count 3"):
        assert line in prom
    for line in prom.splitlines():
        name, value = line.rsplit(None, 1)
        assert line.startswith("#") or (name.startswith("igg_") and float(value) == float(value))
    assert tele.dump_metrics(tmp_path / "x.json") == (str(tmp_path / "x.json"),
                                                      str(tmp_path / "x.prom"))


def test_snapshot_is_json_serializable():
    tele.counter("s.c").inc()
    tele.histogram("s.h").record(0.25)
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    assert tigg.telemetry_snapshot is tele.snapshot
    rt = json.loads(json.dumps(tigg.telemetry_snapshot()))
    assert rt["counters"]["s.c"] == 1
    assert rt["coords"] == list(tigg.get_global_grid().coords)


def _parse_prometheus(text: str) -> dict:
    """Minimal text-format (0.0.4) parser (the JAX test's): samples attach
    to the preceding ``# TYPE`` block and must belong to it."""
    out: dict = {}
    current = None
    for line in text.splitlines():
        if not line.strip():
            raise ValueError("blank line in exposition")
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split()
            if name in out:
                raise ValueError(f"duplicate TYPE for {name}")
            out[name] = {"type": mtype, "samples": {}}
            current = name
            continue
        name_labels, value = line.rsplit(None, 1)
        if current is None or not name_labels.startswith(current):
            raise ValueError(f"sample outside its TYPE block: {line!r}")
        out[current]["samples"][name_labels] = float(value)
    return out


def test_prometheus_name_sanitization_edge_cases():
    tele.counter("9starts.with-digit").inc(2)
    tele.gauge("weird-gauge.name-x").set(1.0)
    parsed = _parse_prometheus(tele.prometheus_text())
    assert parsed["igg_9starts_with_digit_total"]["type"] == "counter"
    assert "igg_weird_gauge_name_x" in parsed
    for name in parsed:
        assert re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name), name


def test_prometheus_empty_histogram_exposition():
    tele.histogram("h.empty")
    text = tele.prometheus_text()
    h = _parse_prometheus(text)["igg_h_empty"]
    assert h["type"] == "summary"
    assert h["samples"] == {"igg_h_empty_sum": 0.0, "igg_h_empty_count": 0.0}
    assert "None" not in text


def test_prometheus_roundtrip_against_snapshot():
    tele.counter("rt.count").inc(7)
    tele.gauge("rt.gauge").set(-2.5)
    for v in (1.0, 2.0, 4.0):
        tele.histogram("rt.hist").record(v)
    snap = tele.snapshot()
    parsed = _parse_prometheus(tele.prometheus_text(snap))
    assert parsed["igg_rt_count_total"]["samples"]["igg_rt_count_total"] == 7.0
    assert parsed["igg_rt_gauge"]["samples"]["igg_rt_gauge"] == -2.5
    hs = parsed["igg_rt_hist"]["samples"]
    assert hs["igg_rt_hist_sum"] == 7.0 and hs["igg_rt_hist_count"] == 3.0
    assert hs['igg_rt_hist{quantile="0.5"}'] == snap["histograms"]["rt.hist"]["p50"]
    assert len(parsed) == 3


def _record(mod, seq):
    """Feed one record sequence into ``mod``'s registry (the windows on an
    explicit clock, so both registries see the same window ring)."""
    for kind, name, value, now in seq:
        if kind == "c":
            mod.counter(name).inc(value)
        elif kind == "g":
            mod.gauge(name).set(value)
        else:
            mod.histogram(name).record(value, now=now)


def _sequence(seed: int):
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(int(rng.integers(50, 1500))):
        kind = ("c", "g", "h")[int(rng.integers(3))]
        name = f"{kind}.{('a', 'b-x', '9z')[int(rng.integers(3))]}.{int(rng.integers(3))}"
        value = int(rng.integers(1, 5)) if kind == "c" else float(rng.standard_normal())
        seq.append((kind, name, value, float(i) * 0.25))
    return seq


@pytest.mark.parametrize("seed", range(4))
def test_same_records_give_equal_snapshot_and_exposition_in_both_packages(seed, monkeypatch):
    monkeypatch.setenv("IGG_SLO_WINDOW_S", "10")
    seq = _sequence(seed)
    _record(tele, seq)
    _record(jtele, seq)
    mine, ref = tele.snapshot(), jtele.snapshot()
    for key in ("counters", "gauges"):
        assert mine[key] == ref[key]
    assert set(mine["histograms"]) == set(ref["histograms"])
    for name, s in mine["histograms"].items():
        # the live window summary depends on the reading clock: compare the
        # run-lifetime fields, then both windows on one explicit clock
        r = ref["histograms"][name]
        assert {k: v for k, v in s.items() if k != "window"} == \
            {k: v for k, v in r.items() if k != "window"}
        now = seq[-1][3]
        assert tele.histogram(name).window_summary(now=now) == \
            jtele.histogram(name).window_summary(now=now)
    assert tele.prometheus_text(mine) == jtele.prometheus_text(ref)
    assert tele.prometheus_text(mine) == jtele.prometheus_text(mine)


def test_heartbeat_attaches_skew_and_serving_context(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", "1")
    tele.gauge("skew.step_seconds_max_over_min").set(3.5)
    tele.gauge("skew.slowest_rank").set(1)
    tele.gauge("serving.active_members").set(2)
    tele.gauge("serving.queue_depth").set(4)
    loop = tele.step_loop("m", bytes_per_step=8, total_steps=1)
    loop.on_step(1)
    hb = next(e for e in tele.read_events(tmp_path / "events.jsonl") if e["type"] == "heartbeat")
    assert hb["skew"] == {"step_seconds_max_over_min": 3.5, "slowest_rank": 1.0}
    assert hb["serving"] == {"active_members": 2.0, "queue_depth": 4.0}


# -- rolling SLO windows -------------------------------------------------------------


def test_histogram_rolling_windows(monkeypatch):
    monkeypatch.setenv("IGG_SLO_WINDOW_S", "10")
    h = tele.histogram("w.hist")
    for v in (1.0, 2.0, 3.0):
        h.record(v, now=0.0)
    w = h.window_summary(now=5.0)
    assert w["count"] == 3 and w["window_s"] == 10.0 and w["windows"] == 1 and w["p50"] == 2.0
    h.record(100.0, now=12.0)
    w = h.window_summary(now=12.0)
    assert w["count"] == 4 and w["windows"] == 2 and w["p99"] == 100.0
    assert h.window_summary(now=12.1 + tele.SLO_WINDOWS * 10) is None
    s = h.summary()
    assert s["count"] == 4 and s["max"] == 100.0


def test_window_ring_is_bounded(monkeypatch):
    monkeypatch.setenv("IGG_SLO_WINDOW_S", "1")
    h = tele.histogram("w.ring")
    for i in range(20):
        h.record(float(i), now=float(i))
    assert len(h._win_ring) == tele.SLO_WINDOWS - 1
    w = h.window_summary(now=19.0)
    assert w["count"] == tele.SLO_WINDOWS and w["p50"] == float(19 - tele.SLO_WINDOWS // 2)


def test_windows_absent_until_first_record_and_when_disabled(monkeypatch):
    h = tele.histogram("w.lazy")
    assert h._win_cur is None and h._win_ring is None
    assert h.window_summary() is None and "window" not in h.summary()
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    noop = tele.histogram("w.never")
    assert noop is tele.NOOP
    noop.record(1.0, now=0.0)
    assert "w.never" not in tele.snapshot()["histograms"]


def test_concurrent_scrape_hammer():
    errors = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                snap = tele.snapshot()
                text = tele.prometheus_text(snap)
                for s in snap["histograms"].values():
                    assert s["count"] >= 0
                    if s["count"]:
                        assert s["min"] <= s["max"]
                assert text.endswith("\n")
        except Exception as e:  # pragma: no cover - the failure path
            errors.append(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    h, c, g = tele.histogram("hammer.hist"), tele.counter("hammer.count"), tele.gauge("hammer.g")
    for i in range(3000):
        h.record(float(i % 97))
        c.inc()
        g.set(float(i))
        if i % 500 == 0:
            tele.histogram(f"hammer.h{i}").record(1.0)
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive() and errors == []
    snap = tele.snapshot()
    assert snap["counters"]["hammer.count"] == 3000
    assert snap["histograms"]["hammer.hist"]["count"] == 3000


# -- proc RSS and the progress record --------------------------------------------------


def test_proc_rss_bytes_reads_something():
    rss = tele.proc_rss_bytes()
    assert rss is not None and rss > 10 * 1024 * 1024


def test_heartbeat_publishes_rss_gauge(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", "1")
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    loop = tele.step_loop("m", bytes_per_step=8, total_steps=1)
    loop.on_step(1)
    assert tele.snapshot()["gauges"]["proc.rss_bytes"] > 0


def test_note_progress_roundtrip():
    assert tele.last_progress() is None
    tele.note_progress("m", 0, init=True)
    p = tele.last_progress()
    assert p["init"] and not p["done"] and p["step"] == 0
    tele.note_progress("m", 3)
    p = tele.last_progress()
    assert not p["init"] and p["step"] == 3 and p["age_s"] >= 0
    tele.note_progress("m", 3, done=True)
    assert tele.last_progress()["done"]
    tele.reset()
    assert tele.last_progress() is None


def test_step_loop_progress_lifecycle(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    loop = tele.step_loop("m", total_steps=2)
    assert tele.last_progress()["init"]
    loop.on_step(1)
    p = tele.last_progress()
    assert p["step"] == 1 and not p["init"] and not p["done"]
    loop.finish(2)
    assert tele.last_progress()["done"]


# -- telemetry never changes the result ------------------------------------------------


@pytest.mark.parametrize("model_name,run_kwargs,nt", RUNS)
def test_run_with_telemetry_on_is_bit_identical_to_off(model_name, run_kwargs, nt,
                                                        monkeypatch, tmp_path):
    model = MODELS[model_name]
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    off = model.run(nt, NX, NX, NX, **KW, **run_kwargs)
    assert tele.snapshot()["counters"] == {}
    monkeypatch.delenv("IGG_TELEMETRY")
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", "1")
    on = model.run(nt, NX, NX, NX, **KW, **run_kwargs)
    assert torch.equal(on, off)
    assert tele.snapshot()["counters"][f"{model_name}.steps"] == nt


def test_fused_run_validates_its_cadences():
    with pytest.raises(ValueError, match="multiple of the 2 steps"):
        diffusion3d.run(3, NX, NX, NX, fused_k=2, overlapx=4, overlapy=4, overlapz=4, **KW)
    with pytest.raises(ValueError, match="guard_every=1 must be a multiple"):
        diffusion3d.run(4, NX, NX, NX, fused_k=2, guard_every=1, overlapx=4, overlapy=4,
                        overlapz=4, **KW)
    assert not tigg.grid_is_initialized()
