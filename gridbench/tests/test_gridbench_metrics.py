"""The arithmetic that turns a run's timings and trace into metrics."""

from __future__ import annotations

import math

import pytest

from gridbench import readers, run, spec, trace
from gridbench.layout import Layout


def _window(times, steps_per_call, trace_summary=None):
    return {"calls": len(times), "steps": len(times) * steps_per_call, "total_ms": sum(times),
            "times_ms": times, "setup_s": 1.0, "start_s": 0.0, "peak_warm": 2 * (1 << 30),
            "peak_window": 3 * (1 << 30), "trace": trace_summary, "checks": {}}


def test_step_time_is_the_whole_window_over_all_its_steps():
    times = [6.0] * 99 + [106.0]
    e2e = run.end_to_end(_window(times, 16), 9.5)
    assert e2e["step_ms"] == pytest.approx(sum(times) / 1600)
    assert e2e["peak_mem_gib"] == 2.0 and e2e["setup_s"] == 9.5


def test_the_p95_is_over_every_call_and_a_stall_in_a_few_calls_moves_it():
    steady = [6.0] * 100
    stalled = [6.0] * 94 + [30.0] * 6
    assert run.p95(steady) == pytest.approx(6.0)
    assert run.p95(stalled) > 20.0
    assert run.p95([float(i) for i in range(1, 101)]) == pytest.approx(95.05)


def test_roofline_bytes_count_each_field_once():
    n = 512 ** 3
    cfg = spec.config("diffusion3d-512")
    summary = {"ops": {"void fused_diffusion_kernel<float, 4>(...)": [4, 4 * 1.6e-3]},
               "scoped_s": {}, "busy_s": 1.0, "window_s": 1.0, "idle_gaps": {}}
    ctx = {"config": cfg, "window": _window([6.0], 16, summary)}
    least = 4 * 3 * n * 4 / readers.HBM_BYTES_PER_S
    got = spec.metric("fused_diffusion_roofline").read(ctx)
    assert got == pytest.approx(100 * least / (4 * 1.6e-3))
    assert 25 < got < 35


def test_pt_roofline_counts_the_kernel_chunks_of_a_step():
    assert readers.pt_schedule(12, 6) == (0, [6, 6])
    assert readers.pt_schedule(13, 6) == (1, [6, 6])
    assert readers.pt_schedule(10, 6) == (0, [6, 4])
    cfg = spec.config("porous3d-256")
    n = 256
    faces = 3 * (n + 1) * n * n
    summary = {"ops": {"fused_pt_kernel<float, false>": [2, 2 * 1.62e-3]},
               "scoped_s": {}, "busy_s": 1.0, "window_s": 1.0, "idle_gaps": {}}
    ctx = {"config": cfg, "window": _window([50.0], 1, summary)}
    least = 2 * (3 * n ** 3 + 2 * faces) * 4 / readers.HBM_BYTES_PER_S
    assert spec.metric("fused_pt_roofline").read(ctx) == pytest.approx(100 * least / 3.24e-3)


@pytest.mark.parametrize("cfg_name,traffic,flops", [
    ("diffusion3d-512", "fused", 17), ("diffusion3d-512", "per_step", 17),
    ("porous3d-256", "fused", 29 * 12 + 50)])
def test_step_mfu_counts_the_steps_of_the_window_over_the_global_grid(cfg_name, traffic, flops):
    cfg, traf = spec.config(cfg_name), spec.traffic(traffic)
    lay = Layout.of(spec.grid_of(cfg, traf))
    cells = math.prod(lay.global_shape())
    ctx = {"config": cfg, "traffic": traf, "window": _window([10.0] * 4, 8)}
    got = spec.metric("step_mfu").read(ctx)
    assert got == pytest.approx(100 * 32 * cells * flops / (40e-3 * readers.FP32_FLOPS_PER_S))
    assert 0 < got < 100


def test_a_reader_with_nothing_to_read_returns_nothing():
    summary = {"ops": {}, "scoped_s": {}, "busy_s": 1.0, "window_s": 1.0,
               "idle_gaps": {}}
    ctx = {"config": spec.config("diffusion3d-512"), "window": _window([6.0], 16, summary)}
    assert spec.metric("fused_diffusion_roofline").read(ctx) is None
    assert spec.metric("exchange_ms_per_step").read(ctx) is None


def _ev(name, cat, ts, dur, pid=0, tid=7):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def test_trace_summary_busy_idle_scopes_and_gaps():
    events = [
        _ev(trace.WINDOW, "user_annotation", 100, 50, pid=1, tid=1),
        _ev("aten::add", "cpu_op", 100, 10, pid=1, tid=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 150, 40, pid=1, tid=1),
        _ev("igg_halo_exchange", "gpu_user_annotation", 118, 12),
        _ev("fused_diffusion_kernel", "kernel", 100, 10),
        _ev("Memcpy DtoD", "gpu_memcpy", 120, 5),
        _ev("add_kernel", "kernel", 140, 20),
        _ev("add_kernel", "kernel", 190, 10),
        _ev("before_window", "kernel", 10, 5),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["scoped_s"] == {"igg_halo_exchange": pytest.approx(5e-6)}
    assert s["ops"]["add_kernel"][0] == 2
    assert s["idle_gaps"]["host_idle"] == pytest.approx((10 + 15) * 1e-6)
    assert s["idle_gaps"]["cudaLaunchKernel"] == pytest.approx(30e-6)
    assert readers.idle_percent(s) == pytest.approx(55.0)
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["add_kernel", pytest.approx(30e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
