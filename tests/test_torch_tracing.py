"""The port's spans, merged traces, request traces, skew probe and flight
recorder (`implicitglobalgrid_tpu_torch.utils.tracing`) against the JAX
package's.

* The cases of the JAX package's ``tests/test_tracing.py`` and
  ``tests/test_request_tracing.py`` that have a meaning in the port (the
  ``igg_trace.py`` CLI and the cost-model reconciliation are the JAX
  package's own tools): the span API and its disabled mode, per-rank dumps
  and their merge, `validate_chrome_trace`, the single-process skew probe,
  the flight recorder and open spans, `span_stats`, the ``traceparent``
  codec and sampling, request traces through the port's front door,
  `request_tree`, `critical_path`, the OTLP export (held to the JAX
  package's golden file) and the ring's overflow ledger.
* Under a live capture a span is also a profiler range of its name, with
  the ring on or off, and an exchange names its work once.
* Across packages, on the same inputs: `parse_traceparent` /
  `format_traceparent`, `merge_trace_files` of the same per-rank
  documents, `request_tree` and `critical_path` of the same tree, and
  `validate_otlp`.
* One 2-gloo-rank spawn (`_workers` task ``"tracing"``): the clock sync's
  barrier, `all_ranks_value`, the skew probe and its heartbeat cadence, and
  the two ranks' dumps merged into one valid trace.

Everything runs on the CPU (``device="cpu"``) in float64 at 8^3.
"""

import copy
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.utils import tracing as jtracing
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import diffusion3d
from implicitglobalgrid_tpu_torch.serving import FrontDoor, Request, ServingLoop
from implicitglobalgrid_tpu_torch.utils import liveplane as lp
from implicitglobalgrid_tpu_torch.utils import resilience as res
from implicitglobalgrid_tpu_torch.utils import telemetry as tele
from implicitglobalgrid_tpu_torch.utils import tracing

NX = 8
F64 = torch.float64
KW = dict(quiet=True, device="cpu", dtype=F64)
TID = "ab" * 16
SID = "cd" * 8
GOLDEN = Path(__file__).resolve().parent / "data" / "request_trace_otlp.golden.json"


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    tele.reset()
    tracing.reset()
    lp.reset()
    res.reset_fault_injector()
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    lp.reset()
    tele.reset()
    tracing.reset()


# -- the span API --------------------------------------------------------------------


def test_trace_span_records_nested_spans():
    with tracing.trace_span("outer", kind="test"):
        with tracing.trace_span("inner", step=1):
            pass
    inner, outer = tracing.span_records()
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["args"] == {"step": 1} and outer["args"] == {"kind": "test"}
    assert inner["dur"] >= 0 and outer["dur"] >= inner["dur"]
    assert outer["t0"] <= inner["t0"]
    assert inner["t0"] + inner["dur"] <= outer["t0"] + outer["dur"] + 1e-9
    summary = tracing.span_summary()
    assert summary["inner"]["count"] == 1
    assert summary["outer"]["total_s"] == pytest.approx(outer["dur"])


def test_trace_span_disabled_returns_shared_noop(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert tracing.trace_span("x") is tracing.NOOP_SPAN
    with tracing.trace_span("x", a=1):
        pass
    monkeypatch.setenv("IGG_TELEMETRY", "1")
    monkeypatch.setenv("IGG_TRACE_RING", "0")
    assert tracing.trace_span("y") is tracing.NOOP_SPAN
    monkeypatch.delenv("IGG_TRACE_RING")
    assert tracing.span_records() == []


def test_trace_ring_is_bounded(monkeypatch):
    monkeypatch.setenv("IGG_TRACE_RING", "8")
    for i in range(50):
        with tracing.trace_span("s", i=i):
            pass
    recs = tracing.span_records()
    assert [r["args"]["i"] for r in recs] == list(range(42, 50))


def test_dump_trace_requires_dir_and_enabled(monkeypatch, tmp_path):
    assert tigg.dump_trace() is None
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert tigg.dump_trace(tmp_path) is None


def test_the_instrumented_library_paths_record_their_spans(monkeypatch, tmp_path):
    """The spans the JAX package records on its concrete paths: the
    exchange (and the split exchange), `gather`, and a checkpoint's save
    and restore."""
    tigg.init_global_grid(NX, NX, NX, periodx=1, quiet=True, device="cpu")
    A = torch.rand((NX, NX, NX), dtype=F64)
    tigg.update_halo(A)
    from implicitglobalgrid_tpu_torch.ops import halo

    halo.finish_slab_exchange([A], halo.begin_slab_exchange([A], (0,), width=1))
    tigg.gather(A)
    path = tigg.save_checkpoint(tmp_path, (A,), 3)
    tigg.restore_checkpoint(path, like=(A.clone(),))
    names = [s["name"] for s in tracing.span_records()]
    assert names == ["igg_halo_exchange", "igg_slab_exchange_begin", "igg_slab_exchange_finish",
                     "igg.gather", "igg.checkpoint.save", "igg.checkpoint.restore"]
    assert tracing.span_records()[0]["args"] == {"fields": 1, "width": 1}
    assert tracing.span_records()[4]["args"] == {"step": 3}


# -- per-rank dumps and the merge ------------------------------------------------------


def _rank_doc(rank, *, perf0, wall, spans, barrier=True, uncertainty=1e-4, epoch=1):
    return {
        "schema": tracing.TRACE_SCHEMA, "rank": rank, "pid": 1000 + rank,
        "coords": [rank, 0, 0],
        "clock_sync": {"wall": wall, "perf": perf0, "uncertainty_s": uncertainty,
                       "epoch": epoch, "barrier": barrier},
        "spans": spans,
    }


def _write(tmp_path, doc, name=None):
    path = tmp_path / (name or tracing.trace_filename(doc["rank"]))
    path.write_text(json.dumps(doc))
    return str(path)


def _merge_both(paths, **kw):
    """The port's merge, held equal to the JAX package's on the same files."""
    mine = tracing.merge_trace_files(paths, **kw)
    assert mine == jtracing.merge_trace_files(paths, **kw)
    return mine


def test_merge_aligns_ranks_on_the_barrier_instant(tmp_path):
    f0 = _write(tmp_path, _rank_doc(0, perf0=100.0, wall=1_000_000.0, spans=[
        {"name": "igg.step", "t0": 102.0, "dur": 0.5, "args": {"step": 1}}]))
    f1 = _write(tmp_path, _rank_doc(1, perf0=500.0, wall=1_000_000.4, spans=[
        {"name": "igg.step", "t0": 502.0, "dur": 0.25}]))
    doc = _merge_both([f0, f1])
    assert tracing.validate_chrome_trace(doc) == []
    by_rank = {e["pid"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert by_rank[0]["ts"] == pytest.approx(by_rank[1]["ts"])
    align = doc["otherData"]["clock_alignment"]
    assert align["anchor_rank"] == 0
    assert align["per_rank"]["1"]["barrier_aligned"] is True
    assert align["per_rank"]["1"]["uncertainty_s"] == pytest.approx(1e-4)
    assert {e["pid"] for e in doc["traceEvents"] if e["ph"] == "M"} == {0, 1}


def test_merge_falls_back_to_wall_clock_without_barrier(tmp_path):
    f0 = _write(tmp_path, _rank_doc(0, perf0=10.0, wall=50.0,
                                    spans=[{"name": "a", "t0": 11.0, "dur": 0.1}]))
    f1 = _write(tmp_path, _rank_doc(1, perf0=70.0, wall=53.0, barrier=False,
                                    spans=[{"name": "b", "t0": 71.0, "dur": 0.1}]))
    doc = _merge_both([f0, f1])
    assert doc["otherData"]["clock_alignment"]["per_rank"]["1"]["barrier_aligned"] is False
    spans = {e["pid"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert (spans[1]["ts"] - spans[0]["ts"]) / 1e6 == pytest.approx(3.0)


def test_merge_refuses_mismatched_barrier_anchors(tmp_path):
    f0 = _write(tmp_path, _rank_doc(0, perf0=10.0, wall=1_000_000.0,
                                    spans=[{"name": "a", "t0": 11.0, "dur": 0.1}]))
    stale = _write(tmp_path, _rank_doc(1, perf0=70.0, wall=1_000_500.0,
                                       spans=[{"name": "b", "t0": 71.0, "dur": 0.1}]))
    for mod in (tracing, jtracing):
        with pytest.raises(ValueError, match="different runs/barriers"):
            mod.merge_trace_files([f0, stale])
    _write(tmp_path, _rank_doc(1, perf0=70.0, wall=1_000_000.1, epoch=7, spans=[]))
    with pytest.raises(ValueError, match="different runs/barriers"):
        tracing.merge_trace_files([f0, stale])


def test_merge_rejects_duplicate_ranks_and_bad_schema(tmp_path):
    f0 = _write(tmp_path, _rank_doc(0, perf0=0.0, wall=0.0, spans=[]))
    dup = _write(tmp_path, _rank_doc(0, perf0=0.0, wall=0.0, spans=[]), "dup.json")
    with pytest.raises(ValueError, match="duplicate rank"):
        tracing.merge_trace_files([f0, dup])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 999, "rank": 1, "spans": [], "clock_sync": {}}))
    with pytest.raises(ValueError, match="schema"):
        tracing.merge_trace_files([bad])


@pytest.mark.parametrize("seed", range(3))
def test_merge_of_random_rank_documents_equals_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for rank in range(int(rng.integers(1, 5))):
        perf0 = float(rng.uniform(0, 1000))
        spans = [{"name": str(rng.choice(["igg.step", "igg_halo_exchange", "igg.gather"])),
                  "t0": perf0 + float(rng.uniform(0, 5)), "dur": float(rng.uniform(0, 0.1)),
                  **({"args": {"step": int(i)}} if rng.random() < 0.5 else {})}
                 for i in range(int(rng.integers(0, 12)))]
        paths.append(_write(tmp_path, _rank_doc(
            rank, perf0=perf0, wall=1e6 + float(rng.uniform(0, 1)), spans=spans,
            barrier=bool(rng.random() < 0.8))))
    assert tracing.validate_chrome_trace(_merge_both(paths)) == []


def test_validate_chrome_trace_catches_breakage():
    ok = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 0.0, "dur": 1.0},
        {"ph": "X", "name": "b", "pid": 0, "tid": 0, "ts": 2.0, "dur": 1.0}],
        "otherData": {"clock_alignment": {}}}
    assert tracing.validate_chrome_trace(ok) == []
    nonmono = copy.deepcopy(ok)
    nonmono["traceEvents"].append({"ph": "X", "name": "c", "pid": 0, "tid": 0, "ts": 1.0,
                                   "dur": 0.1})
    assert any("monotonic" in p for p in tracing.validate_chrome_trace(nonmono))
    for bad_ts in (float("nan"), float("inf")):
        doc = copy.deepcopy(ok)
        doc["traceEvents"][1]["ts"] = bad_ts
        assert any("non-finite" in p for p in tracing.validate_chrome_trace(doc))
    bad_dur = copy.deepcopy(ok)
    bad_dur["traceEvents"][1]["dur"] = float("nan")
    assert any("non-finite" in p for p in tracing.validate_chrome_trace(bad_dur))
    assert tracing.validate_chrome_trace({}) == ["traceEvents is missing or not a list"]
    assert any("clock_alignment" in p for p in tracing.validate_chrome_trace({"traceEvents": []}))
    for doc in (ok, nonmono, bad_dur, {}):
        assert tracing.validate_chrome_trace(doc) == jtracing.validate_chrome_trace(doc)


def test_real_run_dump_merges_into_valid_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    state, params = diffusion3d.setup(NX, NX, NX, **KW)
    res.guarded_time_loop(diffusion3d.make_step(params), state, 3, guard=res.RunGuard(),
                          model="diffusion3d", bytes_per_step=tele.teff_bytes(state[:1]))
    path = tigg.dump_trace()
    assert path == str(tmp_path / "trace.p0.json")
    doc = _merge_both([path])
    assert tracing.validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["step"] for e in spans if e["name"] == "igg.step"] == [1, 2, 3]
    # the exchanges of each step nest inside its igg.step span
    assert sum(e["name"] == "igg_halo_exchange" for e in spans) == 3
    sync = json.load(open(path))["clock_sync"]
    assert sync["barrier"] is False and sync["uncertainty_s"] == 0.0


# -- the skew probe --------------------------------------------------------------------


def test_skew_probe_skips_single_process():
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    assert tracing.skew_probe(0.5) is None and tracing.all_ranks_value(0.5) is None
    gauges = tele.snapshot()["gauges"]
    assert "skew.step_seconds_max_over_min" not in gauges and "skew.slowest_rank" not in gauges


def test_skew_probe_without_grid_is_none():
    assert tracing.skew_probe(0.1) is None


def test_two_ranks_clock_sync_skew_probe_and_merged_trace(tmp_path):
    """One 2-gloo-rank spawn: the clock sync took a barrier on both ranks;
    `all_ranks_value` gives every rank both values in block order; the
    probe names rank 1 (0.3 s against 0.1 s) with ratio 3 on both ranks,
    past the default ``IGG_SKEW_WARN`` of 2 (a ``skew.straggler`` event);
    a 4-step run heartbeating every 2 steps runs the probe inside the step
    loop on both ranks together; both ranks' dumps merge into one valid
    Chrome trace with 4 step-tagged ``igg.step`` spans per rank."""
    task = {"kind": "tracing", "nxyz": [NX, NX, NX], "grid": {"dimx": 2},
            "step_s": [0.1, 0.3], "nt": 4, "heartbeat": 2, "inputs": {}}
    out = spawn(task, 2, tmp_path, timeout=240)
    for rank, o in enumerate(out):
        sync = json.loads(o["sync"].tobytes())
        assert sync["barrier"] is True and sync["uncertainty_s"] >= 0
        np.testing.assert_array_equal(o["vals"], np.array([1.0, 2.0]).reshape(2, 1, 1))
        probe = json.loads(o["probe"].tobytes())
        assert probe["ratio"] == pytest.approx(3.0) and probe["slowest_rank"] == 1
        assert probe["slowest_coords"] == [1, 0, 0]
        assert probe["mine_s"] == task["step_s"][rank]
    tele_dir = tmp_path / "tele"
    paths = sorted(str(p) for p in tele_dir.glob("trace.p*.json"))
    assert len(paths) == 2
    doc = tracing.merge_trace_files(paths)
    assert tracing.validate_chrome_trace(doc) == []
    align = doc["otherData"]["clock_alignment"]
    assert align["per_rank"]["1"]["barrier_aligned"] is True
    for pid in (0, 1):
        steps = [e["args"]["step"] for e in doc["traceEvents"]
                 if e["ph"] == "X" and e["pid"] == pid and e["name"] == "igg.step"]
        assert steps == [1, 2, 3, 4]
    # the straggler event of the explicit probe, on both ranks' logs
    for name in ("events.jsonl", "events.p1.jsonl"):
        events = tele.read_events(tele_dir / name)
        assert [e["slowest_rank"] for e in events if e["type"] == "skew.straggler"][:1] == [1]
        assert sum(e["type"] == "heartbeat" for e in events) == (2 if name == "events.jsonl" else 0)


# -- the flight recorder and open spans -------------------------------------------------


def test_guard_trip_dumps_flight_bundle(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    with tracing.trace_span("pre.trip", step=0):
        pass
    T = torch.ones((NX, NX, NX), dtype=F64)
    T[2, 2, 2] = float("nan")
    guard = res.RunGuard(guard_every=1, policy="raise", names=("T",))
    guard.start((T,))
    with pytest.raises(res.GuardError):
        guard.on_step((T,), 1)
    (b,) = tracing.read_flight_bundles(tmp_path / tracing.flight_filename(0))
    assert b["reason"] == "guard.trip"
    assert b["info"]["step"] == 1 and b["info"]["policy"] == "raise"
    assert b["config"]["env"]["IGG_TELEMETRY_DIR"] == str(tmp_path)
    assert b["config"]["grid"]["nprocs"] == 1
    assert b["metrics"]["counters"]["resilience.guard_trips"] == 1
    assert any(s["name"] == "pre.trip" for s in b["spans"])


def test_audit_mismatch_dumps_an_sdc_bundle_with_the_open_step_span(monkeypatch, tmp_path):
    """``bit_flip`` under ``integrity_every=1``: the `IntegrityError` leaves
    a ``reason=sdc`` bundle naming its detector and step, holding the
    ``igg.step`` span still open when the audit raised."""
    from implicitglobalgrid_tpu_torch.integrity import IntegrityError

    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_FAULT_INJECT", "bit_flip:step2:T")
    res.reset_fault_injector()
    state, params = diffusion3d.setup(NX, NX, NX, **KW)
    with pytest.raises(IntegrityError) as e:
        res.guarded_time_loop(diffusion3d.make_step(params), state, 3,
                              guard=res.RunGuard(integrity_every=1, names=("T", "Cp")),
                              model="diffusion3d")
    b = tracing.read_flight_bundles(tmp_path / "flight_0.json")[-1]
    assert b["reason"] == "sdc"
    assert (b["info"]["detector"], b["info"]["step"]) == (e.value.detector, e.value.step) \
        == ("shadow_audit", 2)
    (step,) = [s for s in b["spans"] if s.get("open")]
    assert step["name"] == "igg.step" and step["args"] == {"model": "diffusion3d", "step": 2}


def test_flight_recorder_disabled_or_dirless_is_none(monkeypatch, tmp_path):
    assert tracing.dump_flight_recorder("test") is None
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert tracing.dump_flight_recorder("test") is None
    assert list(tmp_path.iterdir()) == []


def test_flight_recorder_appends_complete_lines(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    p1 = tracing.dump_flight_recorder("first", detail=1)
    p2 = tracing.dump_flight_recorder("second", detail=2)
    assert p1 == p2
    bundles = tracing.read_flight_bundles(p1)
    assert [b["reason"] for b in bundles] == ["first", "second"]
    assert bundles[-1]["info"] == {"detail": 2}
    assert tele.snapshot()["counters"]["resilience.flight_dumps"] == 2


def test_open_spans_tracks_the_executing_stack():
    assert tracing.open_spans() == []
    with tracing.trace_span("outer", step=4):
        with tracing.trace_span("inner"):
            open_ = tracing.open_spans()
            assert [s["name"] for s in open_] == ["outer", "inner"]
            assert all(s["open"] is True and s["dur"] >= 0 for s in open_)
            assert open_[0]["args"] == {"step": 4}
        assert [s["name"] for s in tracing.open_spans()] == ["outer"]
    assert tracing.open_spans() == [] and tracing._open_stacks == {}


def test_crash_inside_span_lands_in_flight_bundle(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    with tracing.trace_span("before.crash"):
        pass
    with pytest.raises(RuntimeError, match="boom"):
        with tracing.trace_span("igg.step", model="m", step=9):
            tracing.dump_flight_recorder("test.crash", step=9)
            raise RuntimeError("boom")
    spans = tracing.read_flight_bundles(tmp_path / tracing.flight_filename(0))[-1]["spans"]
    assert [s["name"] for s in spans if not s.get("open")] == ["before.crash"]
    (open_,) = [s for s in spans if s.get("open")]
    assert open_["name"] == "igg.step" and open_["args"] == {"model": "m", "step": 9}


def test_open_spans_disabled_mode_untouched(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    with tracing.trace_span("x"):
        assert tracing.open_spans() == []


def test_span_stats_aggregates_across_ranks():
    lists = [
        [{"name": "igg.step", "t0": 0.0, "dur": 0.001},
         {"name": "igg.step", "t0": 1.0, "dur": 0.003},
         {"name": "igg.gather", "t0": 2.0, "dur": 0.010},
         {"name": "stuck", "t0": 3.0, "dur": 99.0, "open": True}],
        [{"name": "igg.step", "t0": 0.0, "dur": 0.002}],
    ]
    stats = tracing.span_stats(lists)
    assert stats == jtracing.span_stats(lists)
    assert list(stats) == ["igg.gather", "igg.step"]
    st = stats["igg.step"]
    assert st["count"] == 3 and st["total_s"] == pytest.approx(0.006)
    assert st["p50_s"] == pytest.approx(0.002) and st["p99_s"] == pytest.approx(0.003)
    assert "stuck" not in stats


# -- request traces ----------------------------------------------------------------------

BAD_HEADERS = (None, "", "garbage", "00-short-" + SID + "-01", f"00-{TID}-{'0' * 16}-01",
               f"00-{'0' * 32}-{SID}-01", f"ff-{TID}-{SID}-01", f"zz-{TID}-{SID}-01",
               f"00-{'x' * 32}-{SID}-01")


def test_parse_traceparent_matrix_equals_jax():
    hdr = f"00-{TID}-{SID}-01"
    assert tracing.parse_traceparent(hdr) == {"trace_id": TID, "span_id": SID}
    assert tracing.parse_traceparent(f"  00-{TID.upper()}-{SID}-00  ") == {
        "trace_id": TID, "span_id": SID}
    for h in BAD_HEADERS:
        assert tracing.parse_traceparent(h) is None, h
    for h in (hdr, f"  00-{TID.upper()}-{SID}-00  ", f"01-{TID}-{SID}-01-extra", *BAD_HEADERS):
        assert tracing.parse_traceparent(h) == jtracing.parse_traceparent(h), h
    ctx = {"trace_id": TID, "span_id": SID}
    assert tracing.format_traceparent(ctx) == jtracing.format_traceparent(ctx) == hdr
    for _ in range(20):
        fresh = {"trace_id": tracing.new_trace_id(), "span_id": tracing.new_span_id()}
        assert jtracing.parse_traceparent(tracing.format_traceparent(fresh)) == fresh


def test_trace_span_context_chaining_and_ambient():
    with tracing.trace_span("outer", parent={"trace_id": TID, "span_id": SID}):
        inner_ctx = tracing.current_context()
        assert inner_ctx["trace_id"] == TID and inner_ctx["span_id"] != SID
        with tracing.trace_span("inner"):
            pass
    assert tracing.current_context() is None
    inner, outer = tracing.span_records()
    assert outer["args"]["trace_id"] == TID and outer["args"]["parent_id"] == SID
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    with tracing.use_context({"trace_ids": [TID, "ef" * 16]}):
        with tracing.trace_span("round"):
            pass
    rec = tracing.span_records()[-1]
    assert rec["args"]["trace_ids"] == [TID, "ef" * 16] and "span_id" not in rec["args"]


def _pool(capacity=2):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _, params = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    return ServingLoop(diffusion3d, params, capacity=capacity, steps_per_round=1)


def _door(loop):
    return FrontDoor(loop, port=0, setup_kwargs={"dtype": F64})


def _member(scale=1.0):
    return diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64, ic_scale=scale)[0]


def _http(port, path, doc=None, headers=None):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode() or "{}"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), dict(e.headers)


SUBMIT = {"tenant": "tA", "model": "diffusion3d", "params": {"max_steps": 1}}


def test_sample_zero_is_the_pinned_no_context_path(monkeypatch):
    monkeypatch.setenv("IGG_TRACE_SAMPLE", "0")
    assert tracing.should_sample() is False
    fd = _door(_pool(capacity=1))
    try:
        code, body, hdrs = fd.handle_submit(SUBMIT)
        assert code == 202 and hdrs == {}
        assert fd._requests[body["request_id"]]["trace"] is None
        assert fd.trace_header(body["request_id"]) is None
        assert not [s for s in tracing.span_records() if s["name"].startswith("igg.frontdoor.")]
        code, body, hdrs = fd.handle_submit(SUBMIT, traceparent=f"00-{TID}-{SID}-01")
        got = tracing.parse_traceparent(hdrs["traceparent"])
        assert got["trace_id"] == TID and got["span_id"] != SID
        rec = fd._requests[body["request_id"]]["trace"]
        assert rec["trace_id"] == TID and rec["parent_id"] == SID
    finally:
        fd.close()


def test_telemetry_off_is_pure_passthrough(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert tracing.trace_span("x", parent={"trace_id": TID, "span_id": SID}) \
        is tracing.NOOP_SPAN
    assert tracing.record_span("y", t0=0.0, dur=1.0, parent={"trace_id": TID}) is None
    fd = _door(_pool(capacity=1))
    try:
        hdr = f"00-{TID}-{SID}-01"
        code, body, hdrs = fd.handle_submit(SUBMIT, traceparent=hdr)
        assert code == 202 and hdrs == {"traceparent": hdr}
        assert fd._requests[body["request_id"]]["trace"] is None
        assert tracing.span_records() == []
    finally:
        fd.close()


def _names(ns):
    out = set()
    for n in ns:
        out |= {n["name"]} | _names(n["children"])
    return out


def _own_doc():
    return {"schema": tracing.TRACE_SCHEMA, "rank": 0, "gen": None,
            "dropped": tracing.spans_dropped(), "clock_sync": tracing.clock_sync(),
            "spans": tracing.span_records()}


def test_traceparent_roundtrip_through_loopback_frontdoor():
    fd = _door(_pool(capacity=2))
    try:
        code, body, hdrs = _http(fd.port, "/v1/submit",
                                 {"tenant": "tA", "model": "diffusion3d",
                                  "params": {"max_steps": 2, "ic_scale": 1.1}},
                                 headers={"traceparent": f"00-{TID}-{SID}-01"})
        assert code == 202
        rid = body["request_id"]
        echo = tracing.parse_traceparent(hdrs["traceparent"])
        assert echo["trace_id"] == TID and echo["span_id"] != SID
        assert tele.snapshot()["gauges"]["frontdoor.oldest_submitted_ts"] > 0
        assert fd.serve_rounds(max_rounds=6) == "rounds"
        code, view, hdrs = _http(fd.port, f"/v1/result/{rid}")
        assert view["status"] == "done"
        assert tracing.parse_traceparent(hdrs["traceparent"]) == echo
        assert tele.snapshot()["gauges"]["frontdoor.oldest_submitted_ts"] == 0
        doc = _own_doc()
        tree = tracing.request_tree([doc], TID)
        assert tree == jtracing.request_tree([doc], TID)
        assert not tree["incomplete"]
        (req,) = [r for r in tree["roots"] if r["name"] == "igg.frontdoor.request"]
        assert req["args"]["parent_id"] == SID and req["args"]["span_id"] == echo["span_id"]
        # from the door to the halo exchange, and the port's digest span
        assert {"igg.frontdoor.request", "igg.frontdoor.submit", "igg.frontdoor.admit",
                "igg.serving.admission", "igg.serving.round", "igg_halo_exchange",
                "igg.frontdoor.digest"} <= _names(tree["roots"])
        cp = tracing.critical_path(tree)
        assert cp == jtracing.critical_path(tree)
        assert cp["total_s"] == pytest.approx(req["dur_s"])
        assert sum(v["share"] for v in cp["segments"].values()) == pytest.approx(1.0)
        assert cp["segments"]["rounds"]["s"] > 0 and cp["segments"]["exchange"]["s"] > 0
    finally:
        fd.close()


def test_round_spans_carry_member_context_single_process():
    loop = _pool(capacity=1)
    mem = loop.submit(Request(state=_member(), max_steps=1, tenant="tA",
                              trace={"trace_id": TID, "span_id": SID}))
    assert loop.run(max_rounds=3)[mem].status == "completed"
    rounds = [s for s in tracing.span_records() if s["name"] == "igg.serving.round"
              and tracing._trace_match(s.get("args"), TID)[0]]
    assert rounds
    assert TID in rounds[0]["args"]["trace_ids"]
    assert tracing._trace_match(rounds[0]["args"], TID) == (True, SID)


REQ, SUB, ADM, ADN = "aa" * 8, "bb" * 8, "cc" * 8, "dd" * 8


def _fixture_docs():
    """The JAX test's two dumps of one request: request [0,10], queue-wait
    [0,4] containing admission [0,1], round [4,9] containing a 2 s
    exchange [6,8] — queue_wait 3 / admission 1 / rounds 3 / exchange 2 /
    other 1."""
    door = {
        "schema": tracing.TRACE_SCHEMA, "rank": 0, "pid": 101, "gen": None, "dropped": 0,
        "clock_sync": {"wall": 1000.0, "perf": 100.0, "uncertainty_s": 0.0, "epoch": 1,
                       "barrier": False},
        "spans": [
            {"name": "igg.frontdoor.submit", "t0": 100.0, "dur": 0.5,
             "args": {"trace_id": TID, "span_id": SUB, "parent_id": REQ, "request": "r000000"}},
            {"name": "igg.serving.admission", "t0": 100.0, "dur": 1.0,
             "args": {"trace_id": TID, "span_id": ADN, "parent_id": REQ, "tenant": "tA"}},
            {"name": "igg.frontdoor.admit", "t0": 100.0, "dur": 4.0,
             "args": {"trace_id": TID, "span_id": ADM, "parent_id": REQ, "request": "r000000"}},
            {"name": "igg.frontdoor.request", "t0": 100.0, "dur": 10.0,
             "args": {"trace_id": TID, "span_id": REQ, "request": "r000000", "tenant": "tA",
                      "result": "completed"}},
        ],
    }
    pool = {
        "schema": tracing.TRACE_SCHEMA, "rank": 1, "pid": 202, "gen": 0, "dropped": 0,
        "clock_sync": {"wall": 1000.0, "perf": 500.0, "uncertainty_s": 0.0, "epoch": 1,
                       "barrier": False},
        "spans": [
            {"name": "igg.serving.round", "t0": 504.0, "dur": 5.0,
             "args": {"round": 3, "trace_ids": [TID],
                      "members": [{"member": 0, "slot": 0, "tenant": "tA",
                                   "trace": {"trace_id": TID, "span_id": ADM}}]}},
            {"name": "igg_halo_exchange", "t0": 506.0, "dur": 2.0,
             "args": {"trace_ids": [TID]}},
        ],
    }
    return [door, pool]


def test_request_tree_parenting_across_dumps():
    tree = tracing.request_tree(_fixture_docs(), TID)
    assert tree == jtracing.request_tree(_fixture_docs(), TID)
    assert tree["spans"] == 6 and tree["ranks"] == [0, 1] and tree["gens"] == [0]
    assert tree["dropped"] == 0 and tree["incomplete"] is False
    assert [r["name"] for r in tree["roots"]] == ["igg.frontdoor.request"]
    req = tree["roots"][0]
    assert sorted(c["name"] for c in req["children"]) == [
        "igg.frontdoor.admit", "igg.frontdoor.submit", "igg.serving.admission"]
    adm = next(c for c in req["children"] if c["name"] == "igg.frontdoor.admit")
    assert [c["name"] for c in adm["children"]] == ["igg.serving.round"]
    rnd = adm["children"][0]
    assert [c["name"] for c in rnd["children"]] == ["igg_halo_exchange"]
    assert rnd["t0_unix_s"] == pytest.approx(1004.0)
    empty = tracing.request_tree(_fixture_docs(), "99" * 16)
    assert empty["spans"] == 0 and empty["roots"] == []


def test_critical_path_segment_math():
    tree = tracing.request_tree(_fixture_docs(), TID)
    cp = tracing.critical_path(tree)
    assert cp == jtracing.critical_path(tree)
    assert cp["total_s"] == pytest.approx(10.0)
    assert {k: v["s"] for k, v in cp["segments"].items()} == {
        "queue_wait": pytest.approx(3.0), "admission": pytest.approx(1.0),
        "reroute": pytest.approx(0.0), "checkpoint": pytest.approx(0.0),
        "exchange": pytest.approx(2.0), "rounds": pytest.approx(3.0),
        "other": pytest.approx(1.0)}
    assert cp["segments"]["rounds"]["share"] == pytest.approx(0.3)


def test_request_chrome_trace_of_the_fixture_equals_jax():
    tree = tracing.request_tree(_fixture_docs(), TID)
    doc = tracing.request_chrome_trace(tree)
    assert doc == jtracing.request_chrome_trace(tree)
    assert tracing.validate_chrome_trace(doc) == []
    assert doc["otherData"]["request"]["trace_id"] == TID
    with pytest.raises(ValueError, match="no spans"):
        tracing.request_chrome_trace(tracing.request_tree(_fixture_docs(), "99" * 16))


def _otlp_bytes(mod, docs, **kw):
    out = mod.otlp_trace(docs, **kw)
    assert mod.validate_otlp(out) == []
    return json.dumps(out, sort_keys=True, separators=(",", ":"))


def test_otlp_export_golden_byte_stable():
    """The port's export of the fixture is the JAX package's golden file,
    byte for byte."""
    body = _otlp_bytes(tracing, _fixture_docs())
    assert body == _otlp_bytes(tracing, _fixture_docs())
    assert body == GOLDEN.read_text(encoding="utf-8").rstrip("\n")
    spans = [s for rs in json.loads(body)["resourceSpans"] for ss in rs["scopeSpans"]
             for s in ss["spans"]]
    by_name = {s["name"]: s for s in spans}
    assert len(spans) == 6 and by_name["igg.frontdoor.request"]["kind"] == 2
    assert by_name["igg.frontdoor.admit"]["parentSpanId"] == REQ


def test_otlp_request_slice_and_schema_rejections():
    body = _otlp_bytes(tracing, _fixture_docs(), trace_id=TID)
    assert body == _otlp_bytes(jtracing, _fixture_docs(), trace_id=TID)
    spans = [s for rs in json.loads(body)["resourceSpans"] for ss in rs["scopeSpans"]
             for s in ss["spans"]]
    assert all(s["traceId"] == TID for s in spans)
    assert next(s for s in spans if s["name"] == "igg.serving.round")["parentSpanId"] == ADM
    bad = json.loads(_otlp_bytes(tracing, _fixture_docs()))
    sp = bad["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    sp["traceId"] = "nope"
    sp["endTimeUnixNano"] = "-"
    sp["parentSpanId"] = "zz"
    problems = tracing.validate_otlp(bad)
    assert problems == jtracing.validate_otlp(bad)
    assert any("bad traceId" in p for p in problems)
    assert any("timestamps" in p for p in problems)
    assert tracing.validate_otlp({}) == ["resourceSpans is missing or not a list"]


def test_per_epoch_merge_of_real_restart_dumps(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    paths = []
    for gen, epoch in ((0, 1), (1, 2)):
        monkeypatch.setenv("IGG_GENERATION", str(gen))
        tracing.reset()
        tracing.record_clock_sync(lambda: None, epoch=epoch)
        with tracing.trace_span("igg.serving.round", round=gen, trace_ids=[TID]):
            pass
        p = tigg.dump_trace()
        assert p.endswith(f"trace.g{gen}.p0.json")
        paths.append(p)
    with pytest.raises(ValueError, match="--per-epoch"):
        tracing.merge_trace_files(paths)
    merged = _merge_both(paths, per_epoch=True)
    assert tracing.validate_chrome_trace(merged) == []
    xs = [e for e in merged["traceEvents"] if e["ph"] == "X"]
    assert sorted({e["pid"] for e in xs}) == [0, tracing.EPOCH_PID_STRIDE]
    docs = [tracing._load_rank_trace(p) for p in paths]
    tree = tracing.request_tree(docs, TID)
    assert tree["spans"] == 2 and len(tree["gens"]) == 2


def test_ring_overflow_counts_and_marks_trees_incomplete(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TRACE_RING", "4")
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    for i in range(6):
        with tracing.trace_span("filler", i=i):
            pass
    with tracing.trace_span("igg.serving.round", trace_ids=[TID]):
        pass
    assert tracing.spans_dropped() == 3
    assert tele.snapshot()["counters"]["trace.spans_dropped_total"] == 3
    doc = tracing._load_rank_trace(tigg.dump_trace())
    assert doc["dropped"] == 3
    tree = tracing.request_tree([doc], TID)
    assert tree["spans"] == 1 and tree["dropped"] == 3 and tree["incomplete"] is True


def test_spans_endpoint_filters_by_name_and_request(monkeypatch):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    with tracing.use_context({"trace_id": TID, "span_id": SID}):
        with tracing.trace_span("lp.traced", step=1):
            pass
    with tracing.trace_span("lp.other"):
        pass
    with tracing.trace_span("igg.serving.round", trace_ids=[TID]):
        pass
    port = lp.start_server().port
    assert len(_http(port, "/spans")[1]["spans"]) == 3
    assert sorted(x["name"] for x in _http(port, "/spans?name=lp.")[1]["spans"]) == [
        "lp.other", "lp.traced"]
    assert sorted(x["name"] for x in _http(port, f"/spans?request={TID}")[1]["spans"]) == [
        "igg.serving.round", "lp.traced"]
    assert [x["name"] for x in _http(port, f"/spans?name=round&request={TID}")[1]["spans"]] \
        == ["igg.serving.round"]
    assert _http(port, "/spans?request=" + "99" * 16)[1]["spans"] == []


def test_healthz_reports_oldest_inflight_request_age(monkeypatch):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    tele.gauge("serving.active_members").set(1)
    tele.gauge("frontdoor.oldest_submitted_ts").set(time.time() - 5.0)
    port = lp.start_server().port
    h = _http(port, "/healthz")[1]
    assert 4.0 <= h["serving"]["oldest_request_age_s"] <= 120.0
    tele.gauge("frontdoor.oldest_submitted_ts").set(0)
    assert "oldest_request_age_s" not in _http(port, "/healthz")[1]["serving"]


def test_net_delay_arms_the_next_control_collective(monkeypatch):
    """``net_delay`` arms `arm_collective_delay`; the next host collective
    consumes it once (one process: the next exchange)."""
    slept = []
    monkeypatch.setattr(tracing.time, "sleep", slept.append)
    tracing.arm_collective_delay(0.5)
    tracing.arm_collective_delay(-1.0)  # clamped to no delay
    tigg.init_global_grid(NX, NX, NX, periodx=1, quiet=True, device="cpu")
    A = torch.rand((NX, NX, NX), dtype=F64)
    tigg.update_halo(A)
    assert slept == []
    tracing.arm_collective_delay(0.5)
    tigg.update_halo(A)
    tigg.update_halo(A)
    assert slept == [0.5]


# -- spans under a device-timeline capture -----------------------------------------------


def _ranges(logdir, name):
    from implicitglobalgrid_tpu_torch.utils import profiling as prof

    doc = prof.load_trace(prof.find_trace_files(logdir)[-1])
    return [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("name") == name]


@pytest.mark.parametrize("telemetry", ["1", "0"])
def test_trace_span_opens_a_range_only_under_a_capture(monkeypatch, tmp_path, telemetry):
    monkeypatch.setenv("IGG_TELEMETRY", telemetry)
    with tracing.trace_span("igg.outside"):
        pass
    if telemetry == "0":
        assert tracing.trace_span("igg.outside") is tracing.NOOP_SPAN
    with tigg.profile_trace(tmp_path, device="cpu"):
        with tracing.trace_span("igg.inside", k=1):
            torch.ones(8).add_(1)
    assert len(_ranges(tmp_path, "igg.inside")) == 1
    assert _ranges(tmp_path, "igg.outside") == []
    names = [s["name"] for s in tracing.span_records()]
    assert names == ([] if telemetry == "0" else ["igg.outside", "igg.inside"])


def test_an_exchange_leaves_one_ring_span_and_one_range(tmp_path):
    tigg.init_global_grid(NX, NX, NX, periodx=1, **{k: v for k, v in KW.items() if k != "dtype"})
    A = torch.rand((NX, NX, NX), dtype=F64)
    with tigg.profile_trace(tmp_path, device="cpu"):
        tigg.update_halo(A)
    assert [s["name"] for s in tracing.span_records()] == ["igg_halo_exchange"]
    assert len(_ranges(tmp_path, "igg_halo_exchange")) == 1
