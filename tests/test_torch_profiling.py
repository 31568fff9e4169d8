"""The port's device-timeline profiling (`utils.profiling`) against the JAX
package's.

* The host records agree exactly: the ``IGG_PROFILE`` window grammar and
  its errors, `_union`, `overlap_measure`, `attribution_delta` and both
  render tables on the same interval sets and records.
* A synthetic torch-format trace, the twin of the JAX package's fixture
  (``tests/data/profile_fixture.trace.json.gz``: the same intervals, as
  CUDA kernels, memcpy/memset and NCCL kernels on three streams inside
  ``gpu_user_annotation`` ranges), gives the JAX golden's scope seconds,
  overlap and table.  Further synthetic traces pin the scope rule
  (containment on the op's own stream, innermost range wins) and the
  name vocabulary.
* One real CPU capture of ``diffusion3d.run(device="cpu")`` under
  ``IGG_PROFILE``: meta, events, a parseable trace with ``n_device_ops: 0``
  (a host-only capture is an answer, not an error), the merge with device
  tracks; the degradations (no directory, a window past the run), the
  fire-once contract, the flight bundle's ``profile`` section, the
  command line and `igg.profile_trace`.
* The plain updates' ranges (one a step under a CPU capture, the shared
  null context without one), the capture's anchor range and file, and
  `attach_device_tracks` placing a synthetic rank's ops by the anchor.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.utils import profiling as jprof
from implicitglobalgrid_tpu_torch.utils import profiling as prof
from implicitglobalgrid_tpu_torch.utils import telemetry as tele
from implicitglobalgrid_tpu_torch.utils import tracing

_here = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(_here, "data", "profile_fixture.trace.json.gz")
ENV = ("IGG_TELEMETRY_DIR", "IGG_PROFILE", "IGG_PROFILE_DIR", "IGG_TELEMETRY")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    prof.reset()
    tele.reset()
    yield
    prof.reset()
    tele.reset()
    tracing.reset()
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


# -- window grammar -----------------------------------------------------------


@pytest.mark.parametrize("spec", ["steps:20-40", "steps:5", "steps:3-3"])
def test_parse_profile_window_matches_jax(spec):
    assert prof.parse_profile_window(spec) == jprof.parse_profile_window(spec)


@pytest.mark.parametrize("bad", ["", "steps", "steps:", "steps:0-4", "steps:5-2", "steps:a-b",
                                 "window:2-3", "steps:2-3-4"])
def test_parse_profile_window_rejects_as_jax(bad):
    with pytest.raises(ValueError, match="IGG_PROFILE") as got:
        prof.parse_profile_window(bad)
    with pytest.raises(ValueError) as want:
        jprof.parse_profile_window(bad)
    assert str(got.value) == str(want.value)


def test_maybe_arm_invalid_spec_and_disabled_paths(monkeypatch):
    assert prof.maybe_arm(0) is None
    monkeypatch.setenv("IGG_PROFILE", "steps:banana")
    with pytest.raises(ValueError, match="IGG_PROFILE"):
        prof.maybe_arm(0)
    monkeypatch.setenv("IGG_PROFILE", "steps:2-3")
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert prof.maybe_arm(0) is None


# -- host arithmetic against JAX ----------------------------------------------


def _random_intervals(rng, n):
    a = rng.integers(0, 1000, n).astype(float)
    return [(float(x), float(x + d)) for x, d in zip(a, rng.integers(1, 200, n))]


@pytest.mark.parametrize("seed", range(4))
def test_union_and_intersection_match_jax(seed):
    rng = np.random.default_rng(seed)
    u1, u2 = _random_intervals(rng, 12), _random_intervals(rng, 9)
    assert prof._union(u1) == jprof._union(u1)
    assert prof._union([]) == jprof._union([]) == []
    assert prof._intersection_seconds(prof._union(u1), prof._union(u2)) == \
        jprof._intersection_seconds(jprof._union(u1), jprof._union(u2))


#: the same kind through each package's vocabulary: (torch event, XLA op name)
_KINDS = {
    "collective": ({"cat": "kernel", "name": "ncclDevKernel_SendRecv(ncclDevComm*, unsigned long)"},
                   "collective-permute.1"),
    "kernel": ({"cat": "kernel", "name": "void (anonymous namespace)::fused_pt_kernel<float, 6>"
                                         "(float const*, float*)"}, "fusion.3"),
    "glue": ({"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)"}, "copy.2"),
}


@pytest.mark.parametrize("seed", range(4))
def test_overlap_measure_matches_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for pid in (0, 1):
        for kind, (tev, hlo) in _KINDS.items():
            for a, b in _random_intervals(rng, 5):
                port.append(dict(tev, pid=pid, tid=7, ts=a, dur=b - a, scope=None))
                ref.append({"name": hlo, "hlo_op": hlo, "pid": pid, "tid": 0, "ts": a,
                            "dur": b - a})
    assert [prof.op_kind(o) for o in port] == [jprof.op_kind(o) for o in ref]
    assert prof.overlap_measure(port) == jprof.overlap_measure(ref)
    assert prof.overlap_measure([o for o in port if prof.op_kind(o) != "collective"]) == \
        jprof.overlap_measure([o for o in ref if jprof.op_kind(o) != "collective"])


_RECS = [
    ({"scope_seconds": {"igg_interior_pass": 0.5, "glue": 0.1}, "device_seconds": 0.6,
      "overlap": {"fraction": 0.8}},
     {"scope_seconds": {"igg_interior_pass": 0.5, "glue": 0.4}, "device_seconds": 0.9,
      "overlap": {"fraction": 0.5}}),
    ({"scope_seconds": {"kernels": 0.0123, "igg_halo_exchange": 0.002}, "device_seconds": 0.0143,
      "overlap": {"fraction": None}},
     {"scope_seconds": {"kernels": 0.0101, "glue": 0.0007}, "device_seconds": 0.0108,
      "overlap": {"fraction": None}}),
    ({"scope_seconds": {}, "overlap": {}}, {"scope_seconds": {}, "overlap": {}}),
]


@pytest.mark.parametrize("i", range(len(_RECS)))
def test_delta_and_render_tables_match_jax(i):
    a, b = _RECS[i]
    delta = prof.attribution_delta(a, b)
    assert delta == jprof.attribution_delta(a, b)
    assert prof.render_delta_table(delta) == jprof.render_delta_table(delta)
    for rec in (a, b, dict(a, n_device_ops=3, overlap={"comm_seconds": 1e-3, "fraction": 0.25})):
        assert prof.render_attribution_table(rec) == jprof.render_attribution_table(rec)


# -- synthetic torch-format traces --------------------------------------------

_FUSED = "void (anonymous namespace)::fused_diffusion_kernel<float, 4, false>(float const*, float*)"
_NCCL = "ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)"
_ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
        "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")


def _x(cat, name, tid, ts, dur, pid=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": {"stream": tid}}


def _twin_of_the_jax_fixture():
    """The JAX fixture's device ops at the same times as a torch capture:
    the ring pass on stream 7, the interior on stream 13, NCCL on stream
    21, each inside its ``gpu_user_annotation``; memcpy, memset and an
    elementwise kernel outside every scope, under the loop's
    ``igg_step[...]`` range (not a scope)."""
    return {"traceEvents": [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
        _x("user_annotation", "igg_ring_pass", 1234, -20.0, 5.0, pid=1234),
        _x("cuda_runtime", "cudaLaunchKernel", 1234, -19.0, 3.0, pid=1234),
        _x("gpu_user_annotation", "igg_step[diffusion3d]", 7, 0.0, 1200.0),
        _x("gpu_user_annotation", "igg_ring_pass", 7, 0.0, 100.0),
        _x("kernel", _FUSED, 7, 0.0, 100.0),
        _x("gpu_user_annotation", "igg_interior_pass", 13, 150.0, 500.0),
        _x("kernel", _FUSED, 13, 150.0, 500.0),
        _x("gpu_user_annotation", "igg_slab_exchange_begin", 21, 200.0, 300.0),
        _x("kernel", _NCCL, 21, 200.0, 300.0),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 7, 700.0, 50.0),
        _x("gpu_memset", "Memset (Device)", 7, 760.0, 40.0),
        _x("kernel", _ADD, 7, 820.0, 80.0),
        _x("gpu_user_annotation", "igg_halo_exchange", 21, 1000.0, 100.0),
        _x("kernel", _NCCL, 21, 1000.0, 100.0),
    ]}


def test_twin_of_the_jax_fixture_gives_the_jax_golden():
    rec = prof.attribute_trace(_twin_of_the_jax_fixture())
    want = jprof.attribute_trace(FIXTURE)
    for key in ("n_device_ops", "device_seconds", "scope_seconds", "unattributed_seconds",
                "overlap"):
        assert rec[key] == want[key], key
    assert rec["overlap"]["fraction"] == 0.75
    assert prof.render_attribution_table(rec) == jprof.render_attribution_table(want)
    assert rec["op_seconds"]["kernels"] == {"at::native::vectorized_elementwise_kernel": 8e-05}
    assert rec["op_seconds"]["igg_ring_pass"] == {"fused_diffusion_kernel": 1e-04}
    assert rec["op_seconds"]["glue"] == {"Memcpy DtoD": 5e-05, "Memset": 4e-05}
    # the union: [0, 100], [150, 650], [700, 750], [760, 800], [820, 900], [1000, 1100]
    assert rec["busy_seconds"] == pytest.approx(8.7e-4)


def test_scope_is_the_innermost_containing_range_on_the_ops_stream():
    doc = {"traceEvents": [
        _x("gpu_user_annotation", "igg_ring_pass", 7, 0.0, 500.0),
        _x("gpu_user_annotation", "igg_slab_exchange_begin", 7, 100.0, 50.0),
        _x("gpu_user_annotation", "igg_halo_exchange", 13, 0.0, 1000.0),
        _x("gpu_user_annotation", "igg_interior_pass", 7, 600.0, 10.0),
        _x("kernel", _FUSED, 7, 0.0, 90.0),        # ring pass only
        _x("gpu_memcpy", "Memcpy DtoD", 7, 110.0, 20.0),  # innermost: slab begin
        _x("kernel", _FUSED, 7, 590.0, 30.0),      # straddles interior: not inside
        _x("kernel", _ADD, 7, 700.0, 10.0),        # no range on stream 7 here
        _x("kernel", _ADD, 13, 700.0, 10.0),       # the exchange's range, stream 13
        _x("kernel", _ADD, 7, 600.0, 10.0, pid=1),  # same stream id, other device
    ]}
    ops = prof.device_ops(doc)
    assert [o["scope"] for o in ops] == ["igg_ring_pass", "igg_slab_exchange_begin", None, None,
                                        "igg_halo_exchange", None]
    assert [prof.scope_of(o) for o in ops] == ["igg_ring_pass", "igg_slab_exchange_begin",
                                               "kernels", "kernels", "igg_halo_exchange",
                                               "kernels"]


@pytest.mark.parametrize("event,kind", [
    (_x("kernel", _NCCL, 7, 0, 1), "collective"),
    (_x("kernel", "ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)", 7, 0, 1),
     "collective"),
    (_x("kernel", _FUSED, 7, 0, 1), "kernel"),
    (_x("kernel", "void fused_pt_kernel<float, 6>(float const*)", 7, 0, 1), "kernel"),
    (_x("kernel", _ADD, 7, 0, 1), "kernel"),
    (_x("kernel", "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast"
                  "<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>", 7, 0, 1),
     "glue"),
    (_x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor"
                  "<float>, std::array<char*, 1ul> >", 7, 0, 1), "glue"),
    (_x("kernel", "void (anonymous namespace)::CatArrayBatchedCopy<float>", 7, 0, 1), "glue"),
    (_x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 7, 0, 1), "glue"),
    (_x("gpu_memset", "Memset (Device)", 7, 0, 1), "glue"),
])
def test_op_name_vocabulary(event, kind):
    (op,) = prof.device_ops({"traceEvents": [event]})
    assert prof.op_kind(op) == kind


def test_host_only_trace_is_an_answer_not_an_error():
    doc = {"traceEvents": [
        _x("cpu_op", "aten::add", 1, 0.0, 5.0),
        _x("user_annotation", "igg_halo_exchange", 1, 0.0, 5.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 1.0, 1.0),
    ]}
    rec = prof.attribute_trace(doc)
    assert rec["n_device_ops"] == 0 and rec["scope_seconds"] == {}
    assert rec["overlap"]["fraction"] is None


def test_malformed_trace_raises_valueerror(tmp_path):
    bad = tmp_path / "broken.trace.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError, match="malformed trace JSON"):
        prof.load_trace(bad)
    torn = tmp_path / "torn.trace.json.gz"
    whole = gzip.compress(b'{"traceEvents": []}')
    torn.write_bytes(whole[: len(whole) // 2])
    with pytest.raises(ValueError):
        prof.load_trace(torn)
    other = tmp_path / "other.trace.json"
    other.write_text('{"foo": 1}')
    with pytest.raises(ValueError, match="no traceEvents"):
        prof.load_trace(other)


def test_command_line_attribute_diff_and_finding(tmp_path, capsys):
    path = tmp_path / "twin.trace.json"
    path.write_text(json.dumps(_twin_of_the_jax_fixture()))
    assert prof.main(["attribute", str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["overlap"]["fraction"] == 0.75
    assert prof.main(["diff", str(path), str(path)]) == 0
    table = capsys.readouterr().out
    assert "overlap fraction: A 0.7500 -> B 0.7500" in table
    assert "worst regression" not in table
    bad = tmp_path / "broken.trace.json"
    bad.write_text("{not json")
    assert prof.main(["attribute", str(bad)]) == 1
    finding = json.loads(capsys.readouterr().out)
    assert finding["finding"] == "profile.parse_failed" and "malformed" in finding["error"]
    assert prof.main(["attribute", str(tmp_path / "missing")]) == 2


# -- capture degradations (no profiler session) -------------------------------


def test_capture_without_directory_degrades_to_structured_failure(monkeypatch):
    monkeypatch.setenv("IGG_PROFILE", "steps:1-2")
    cap = prof.maybe_arm(0)
    assert cap is not None and cap.done
    assert tele.snapshot()["counters"].get("profile.capture_failures") == 1
    cap.on_step(1)
    cap.on_step(2)
    cap.close("test")
    assert not prof._capturing


def test_window_past_run_end_never_starts_and_arms_once(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_PROFILE", "steps:50-60")
    cap = prof.maybe_arm(0, steps_per_call=4)
    assert prof.maybe_arm(0) is None  # fire once per process
    for it in range(4, 20, 4):
        cap.on_step(it, 4)
    cap.close("run_complete")
    assert not cap.started and cap.done
    assert prof.find_capture_metas(str(tmp_path)) == []
    prof.reset()
    assert prof.maybe_arm(0) is not None


@pytest.mark.parametrize("window,k,start,calls", [
    ((4, 12), 4, 1, 3),   # the first call (steps 1-4) touches the window
    ((5, 12), 4, 5, 2),
    ((4, 12), 6, 1, 2),
    ((1, 2), 1, 1, 2),
    ((2, 3), 1, 2, 2),
])
def test_fused_calls_cover_the_window(monkeypatch, window, k, start, calls):
    """A loop call of ``k`` steps cannot be split: the capture covers the
    calls that touch the window (spied, no profiler session)."""
    events = []
    cap = prof.ProfileCapture(window, logdir="unused")
    monkeypatch.setattr(cap, "_start", lambda step: (events.append(("start", step)),
                                                    setattr(cap, "started", True)))
    monkeypatch.setattr(cap, "_stop", lambda step, why: (events.append(("stop", step)),
                                                         setattr(cap, "done", True)))
    cap.on_run_start(0, k)
    it = 0
    while it < 24:
        it += k
        cap.on_step(it, k)
    assert events[0] == ("start", start)
    assert events[1][0] == "stop" and (events[1][1] - start + 1) // k == calls


# -- one real capture on the CPU ----------------------------------------------


@pytest.fixture(scope="module")
def captured_run(tmp_path_factory):
    """One windowed capture of ``diffusion3d.run(device="cpu")`` (a profiler
    session costs seconds: the tests below read this run's files)."""
    from implicitglobalgrid_tpu_torch.models import diffusion3d

    tdir = str(tmp_path_factory.mktemp("profile_run"))
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(IGG_TELEMETRY_DIR=tdir, IGG_PROFILE="steps:2-3")
    os.environ.pop("IGG_PROFILE_DIR", None)
    os.environ.pop("IGG_TELEMETRY", None)
    tele.reset()
    tracing.reset()
    prof.reset()
    try:
        T = diffusion3d.run(4, 8, 8, 8, device="cpu", dtype=torch.float64, quiet=True,
                            finalize=False)
        trace_path = tracing.dump_trace(tdir)
        tigg.finalize_global_grid()
        snap = tele.snapshot()
        events = tele.read_events(os.path.join(tdir, "events.jsonl"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        prof.reset()
    return {"tdir": tdir, "host_trace": trace_path, "snapshot": snap, "events": events, "T": T}


def test_windowed_cpu_capture_end_to_end(captured_run):
    metas = prof.find_capture_metas(captured_run["tdir"])
    assert len(metas) == 1 and metas[0].endswith("profile.p0.json")
    meta = json.load(open(metas[0]))
    assert meta["schema"] == prof.PROFILE_SCHEMA and meta["device"] == "cpu"
    assert meta["window"] == [2, 3]
    assert meta["started_at_step"] == 2 and meta["stopped_at_step"] == 3
    assert meta["reason"] == "window"
    assert meta["trace_path"].endswith(".trace.json") and os.path.isfile(meta["trace_path"])
    assert meta["t_stop_perf"] > meta["t_start_perf"]
    doc = prof.load_trace(meta["trace_path"])
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"igg_step[diffusion3d]", "igg_halo_exchange"} <= names  # the ranges opened
    att = meta["attribution"]
    assert att["n_device_ops"] == 0 and att["overlap"]["fraction"] is None
    assert torch.isfinite(captured_run["T"]).all()


def test_capture_events_and_counters(captured_run):
    evs = captured_run["events"]
    types = [e["type"] for e in evs]
    assert "profile.capture_failed" not in types
    start = next(e for e in evs if e["type"] == "profile.start")
    stop = next(e for e in evs if e["type"] == "profile.stop")
    assert start["window"] == [2, 3] and start["step"] == 2
    assert stop["step"] == 3 and stop["reason"] == "window" and stop["overlap_fraction"] is None
    assert captured_run["snapshot"]["counters"].get("profile.captures") == 1
    assert not prof._capturing


def test_merge_with_device_tracks_stays_valid(captured_run):
    doc = tracing.merge_trace_files([captured_run["host_trace"]])
    meta = json.load(open(prof.find_capture_metas(captured_run["tdir"])[0]))
    orphan = dict(meta, rank=7)
    prof.attach_device_tracks(doc, [meta, orphan])
    assert tracing.validate_chrome_trace(doc) == []
    per = doc["otherData"]["device_alignment"]["per_rank"]
    assert per["0"]["n_ops"] == 0 and "no device ops" in per["0"]["note"]
    assert "no host track" in per["7"]["note"]
    stale = dict(meta, wall_start=meta["wall_start"] - 3600.0)
    with pytest.raises(ValueError, match="stale"):
        prof.attach_device_tracks(tracing.merge_trace_files([captured_run["host_trace"]]),
                                  [stale])


def test_attach_device_tracks_of_a_device_capture(captured_run, tmp_path):
    """A meta whose trace holds device ops (the twin trace): the ops land
    on the rank's pid, one tid per stream, tagged with their scope."""
    logdir = tmp_path / "profile.p0"
    logdir.mkdir()
    twin = _twin_of_the_jax_fixture()
    twin["traceEvents"].append(_x("user_annotation", prof.ANCHOR, 1234, -30.0, 4.0, pid=1234))
    (logdir / "igg.p0.1.1.trace.json").write_text(json.dumps(twin))
    meta = json.load(open(prof.find_capture_metas(captured_run["tdir"])[0]))
    meta.update(trace_path="/nonexistent/x.trace.json", logdir="/nonexistent")
    (tmp_path / "profile.p0.json").write_text(json.dumps(meta))
    doc = tracing.merge_trace_files([captured_run["host_trace"]])
    prof.attach_device_tracks(doc, prof.find_capture_metas(tmp_path))
    assert tracing.validate_chrome_trace(doc) == []
    dev = [e for e in doc["traceEvents"] if e.get("ph") == "X" and "igg_scope" in e.get("args", {})]
    assert len(dev) == 7 and {e["pid"] for e in dev} == {0}
    assert {e["tid"] for e in dev} == {prof.DEVICE_TID_BASE + i for i in range(3)}
    assert sorted({e["args"]["igg_scope"] for e in dev}) == [
        "glue", "igg_halo_exchange", "igg_interior_pass", "igg_ring_pass",
        "igg_slab_exchange_begin", "kernels"]
    assert "igg_capture_anchor" in doc["otherData"]["device_alignment"]["note"]
    assert doc["otherData"]["device_alignment"]["per_rank"]["0"]["anchor_error_us"] == 4.0


def test_close_records_last_step_and_flight_bundle(monkeypatch, tmp_path):
    """A window open at scope exit stops with the last completed step, and
    a flight bundle dumped meanwhile records the open capture."""
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_PROFILE", "steps:2-10")
    tigg.init_global_grid(6, 6, 6, quiet=True, device="cpu")
    cap = prof.maybe_arm(0)
    for it in range(1, 4):
        cap.on_step(it)
        with prof.scope("igg_halo_exchange"):
            torch.ones(4).add_(1)
    assert cap.started and prof._capturing
    assert prof.active_capture() == cap.info()
    bundle = tracing.read_flight_bundles(tracing.dump_flight_recorder("test_crash", step=3))[-1]
    assert bundle["profile"]["window"] == [2, 10] and bundle["profile"]["started"] is True
    assert bundle["profile"]["logdir"].endswith("profile.p0")
    prof.close_open_capture("scope_exit")
    meta = json.load(open(tmp_path / "profile.p0.json"))
    assert (meta["started_at_step"], meta["stopped_at_step"], meta["reason"]) == \
        (2, 3, "scope_exit")
    assert prof.active_capture() is None and not prof._capturing
    assert prof.scope("igg_halo_exchange") is prof._NULL


def test_profile_trace_alias_emits_parseable_capture(tmp_path):
    logdir = tmp_path / "alias"
    with tigg.profile_trace(logdir, device="cpu"):
        assert prof._capturing
        with prof.scope("igg_ring_pass"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not prof._capturing
    rec = prof.attribute_capture(logdir)
    assert rec["n_device_ops"] == 0
    doc = prof.load_trace(prof.find_trace_files(logdir)[-1])
    assert "igg_ring_pass" in {e.get("name") for e in doc["traceEvents"]}


# -- the plain updates' ranges and the capture anchor ---------------------------


@pytest.mark.parametrize("model,scope", [("porous_convection3d", "igg_temperature_update"),
                                         ("diffusion3d", "igg_diffusion_update")])
def test_a_plain_step_opens_its_update_range_once_a_step(model, scope, tmp_path):
    import importlib

    mod = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{model}")
    kw = dict(npt=2) if model == "porous_convection3d" else {}
    state, params = mod.setup(8, 8, 8, quiet=True, device="cpu", dtype=torch.float64,
                              periodx=1, **kw)
    step = mod.make_multi_step(params, 3, autotune=False)
    assert prof.scope(scope) is prof._NULL  # no capture live
    state = step(*state)
    with tigg.profile_trace(tmp_path, device="cpu"):
        state = step(*state)
    assert prof.scope(scope) is prof._NULL
    doc = prof.load_trace(prof.find_trace_files(tmp_path)[-1])
    names = [e.get("name") for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert names.count(scope) == 3 and names.count(prof.ANCHOR) == 1
    assert scope in prof.SCOPE_NAMES
    (anchor,) = [p for p in os.listdir(tmp_path) if p.endswith(".anchor.json")]
    rec = json.load(open(tmp_path / anchor))
    assert rec["trace"] == os.path.basename(prof.find_trace_files(tmp_path)[-1])
    assert isinstance(rec["anchor_perf"], float)


def test_attach_device_tracks_places_ops_by_the_anchor(tmp_path):
    """A synthetic rank: the capture's anchor range opens at trace time
    5000 µs (its duration 3 µs) while the host took perf instant 100.0 s
    inside it; a device op 250 µs after the range's start lands within 3
    µs of a host span that started at 100.000250 s."""
    host = {
        "schema": tracing.TRACE_SCHEMA, "rank": 0, "pid": 1000, "coords": [0, 0, 0],
        "clock_sync": {"wall": 1.7e9, "perf": 99.0, "uncertainty_s": 1e-4, "epoch": 1,
                       "barrier": True},
        "spans": [{"name": "marker", "t0": 100.000250, "dur": 1e-5, "args": {}}],
    }
    hpath = tmp_path / tracing.trace_filename(0)
    hpath.write_text(json.dumps(host))
    trace = {"traceEvents": [
        _x("user_annotation", prof.ANCHOR, 1, 5000.0, 3.0, pid=1),
        _x("kernel", _ADD, 7, 5250.0, 20.0),
        _x("kernel", _ADD, 7, 5400.0, 20.0),
    ]}
    tpath = tmp_path / "igg.p0.1.1.trace.json"
    tpath.write_text(json.dumps(trace))
    meta = {"schema": prof.PROFILE_SCHEMA, "rank": 0, "trace_path": str(tpath),
            "anchor_perf": 100.0, "wall_start": 1.7e9 + 1.0, "window": [1, 2]}
    doc = prof.attach_device_tracks(tracing.merge_trace_files([str(hpath)]), [meta])
    assert tracing.validate_chrome_trace(doc) == []
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    marker = next(e for e in xs if e["name"] == "marker")
    dev = sorted((e for e in xs if e["pid"] == 0 and e["tid"] >= prof.DEVICE_TID_BASE),
                 key=lambda e: e["ts"])
    assert len(dev) == 2
    err = doc["otherData"]["device_alignment"]["per_rank"]["0"]["anchor_error_us"]
    assert err == 3.0
    assert abs(dev[0]["ts"] - marker["ts"]) <= err
    assert dev[1]["ts"] - dev[0]["ts"] == pytest.approx(150.0)
    old = dict(meta, anchor_perf=None)
    doc = prof.attach_device_tracks(tracing.merge_trace_files([str(hpath)]), [old])
    assert "device ops omitted" in doc["otherData"]["device_alignment"]["per_rank"]["0"]["note"]
