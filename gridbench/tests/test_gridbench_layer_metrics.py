"""The readers of the program's own spans and counters: the plain updates'
rooflines (``igg_temperature_update``, ``igg_diffusion_update``) and the
exchange's bytes (``halo.payload_bytes``) and bandwidth share, on
hand-built summaries and counters, and the bytes of a CPU run of the
per-step cell against the count from its grid's shapes."""

from __future__ import annotations

import pytest
import torch

from gridbench import run, spec
from gridbench.tests import small
from gridbench.window import WARMUP_CALLS

MIB = 2**20
#: one step's halo bytes at the configurations' real sizes, from the shapes:
#: porous (y periodic) exchanges Pf (256^3), qDx (257 x 256^2), qDy
#: (256 x 257 x 256) and qDz (256^2 x 257) at width 6 twice a step and T at
#: width 1, each on both sides; per_step exchanges T (512^3) at width 1 on
#: both sides of x, y and z
POROUS_STEP_BYTES = 2 * 2 * 6 * 4 * (4 * 256 * 256 + 2 * 256) + 2 * 4 * 256 * 256
PER_STEP_BYTES = 3 * 2 * 4 * 512 * 512


@pytest.fixture(autouse=True)
def _fresh_counters():
    from implicitglobalgrid_tpu_torch.utils import telemetry

    telemetry.reset()
    yield
    telemetry.reset()


def _summary(scoped=None):
    return {"ops": {}, "scoped_s": dict(scoped or {}), "busy_s": 1.0,
            "window_s": 1.0, "idle_gaps": {}}


def _ctx(cell, calls, scoped=None):
    bench = spec.load_benchmark(spec.HERE.parent)
    c = spec.workload(bench, cell)
    cfg, traf = spec.config(c["config"]), spec.traffic(c["traffic"])
    spc = spec.steps_per_call(cfg, traf)
    window = {"calls": calls, "steps": calls * spc, "trace": _summary(scoped)}
    return {"cell": c, "config": cfg, "traffic": traf, "window": window}


def _count(nbytes):
    from implicitglobalgrid_tpu_torch.utils import telemetry

    telemetry.counter("halo.payload_bytes").inc(nbytes)


def test_the_step_byte_counts_are_the_hand_worked_ones():
    assert POROUS_STEP_BYTES == 25_739_264 and POROUS_STEP_BYTES / MIB == 24.546875
    assert PER_STEP_BYTES / MIB == 6.0


def test_t_update_roofline_is_the_least_time_over_the_update_range():
    ctx = _ctx("porous3d-256.fused", 2, {"igg_temperature_update": 16 * 2.94e-3})
    # per step T and three face fields read once, T written once, f32
    nbytes = (2 * 256**3 + 3 * 257 * 256**2) * 4
    assert nbytes == 336_330_752
    got = spec.metric("t_update_roofline").read(ctx)
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 2.94e-3)
    assert 3.4 < got < 3.45


def test_plain_diffusion_roofline_is_the_least_time_over_the_update_range():
    ctx = _ctx("diffusion3d-512.per_step", 10, {"igg_diffusion_update": 10 * 9.35e-3})
    got = spec.metric("plain_diffusion_roofline").read(ctx)
    assert got == pytest.approx(100 * 3 * 512**3 * 4 / 3.35e12 / 9.35e-3)
    assert 5.1 < got < 5.2


@pytest.mark.parametrize("cell,calls,step_bytes", [("porous3d-256.fused", 2, POROUS_STEP_BYTES),
                                                   ("diffusion3d-512.per_step", 10,
                                                    PER_STEP_BYTES)])
def test_exchange_mib_per_step_spreads_the_count_over_every_step_run(cell, calls, step_bytes):
    ctx = _ctx(cell, calls)
    spc = ctx["window"]["steps"] // calls
    _count((WARMUP_CALLS + calls) * spc * step_bytes)
    assert spec.metric("exchange_mib_per_step").read(ctx) == step_bytes / MIB


def test_exchange_roofline_is_twice_the_payload_at_the_hbm_rate_over_the_exchange_time():
    ctx = _ctx("porous3d-256.fused", 2, {"igg_halo_exchange": 16 * 56.8e-6,
                                         "igg_temperature_update": 1.0})
    _count((WARMUP_CALLS + 2) * 8 * POROUS_STEP_BYTES)
    got = spec.metric("exchange_roofline").read(ctx)
    assert got == pytest.approx(100 * 2 * POROUS_STEP_BYTES / 3.35e12 / 56.8e-6)
    assert 26.5 < got < 27.5


@pytest.mark.parametrize("name,scoped,counted", [
    ("t_update_roofline", {"igg_halo_exchange": 1e-3}, True),
    ("plain_diffusion_roofline", {"igg_halo_exchange": 1e-3}, True),
    ("exchange_mib_per_step", {"igg_halo_exchange": 1e-3}, False),
    ("exchange_roofline", {"igg_halo_exchange": 1e-3}, False),
    ("exchange_roofline", {"igg_temperature_update": 1e-3}, True)])
def test_a_reader_without_its_range_or_counter_returns_nothing(name, scoped, counted):
    if counted:
        _count(1000)
    assert spec.metric(name).read(_ctx("porous3d-256.fused", 2, scoped)) is None


def test_a_cpu_run_of_the_per_step_cell_counts_its_grids_halo_planes():
    bench, c, cfg, traf = small.cell("diffusion3d-512.per_step")
    out = run.run_window(cfg, traf, small.args(), torch.device("cpu"))
    ctx = {"cell": c, "config": cfg, "traffic": traf, "window": out}
    nx, ny, nz = cfg["grid"]["block"]
    # periodic x, y and z, overlap 2: one plane a side in each, f32
    step_bytes = 2 * 4 * (ny * nz + nx * nz + nx * ny)
    assert spec.metric("exchange_mib_per_step").read(ctx) == step_bytes / MIB
