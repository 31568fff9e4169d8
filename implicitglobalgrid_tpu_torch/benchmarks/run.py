"""Benchmark harness of the port: T_eff (GB/s per GPU) and weak-scaling
efficiency (the JAX package's ``benchmarks/run.py``, over the port).

One JSON line per config on stdout, with the JAX harness's metric names
and record keys::

    python -m implicitglobalgrid_tpu_torch.benchmarks.run <mode> [--device cuda|cpu] ...

Modes (`MODES`): ``diffusion``, ``acoustic``, ``porous`` (one config
each), ``weak`` (the same block per rank on 1, 2, ... ranks), ``coalesce``
(the coalesced-vs-per-field exchange A/B), ``grad`` (a gradient through the
fused cadence), ``batch`` (members/s of the ensemble cadence over a B
sweep), ``tuned`` (the autotuned against the default config), ``profile``
(a captured device timeline, attributed), ``reconcile`` (the cost model's
report, `analysis.reconcile`) and ``all`` (the first four).  JAX's
``batch_hlo`` reads XLA's optimized HLO, which the port does not have; the
CLI refuses it and names its twin, the ``cost-model`` analyzer's batched
exchange program.

T_eff convention (JAX's, the ParallelStencil/IGG papers'): only the arrays
that must stream once per iteration count, at ``n^3`` cells each: T in+out
for diffusion (``2 n^3`` elements), P, Vx, Vy, Vz in+out for acoustic
(``8 n^3``), Pf and the three fluxes in+out per PT iteration for porous
(``8 n^3``).  The staggered ``+1`` faces are not counted here, unlike
`analysis.reconcile`, which counts the real shapes; both conventions are
JAX's.

Timing (`_time_steps`): two warm-up calls (the first builds or loads the
kernels), then ``reps`` calls of the chunk back to back, with a CUDA event
queued before the first and after each (read after one final
synchronisation), so that a call's time runs from the end of the previous
call; the median per step and the spread.  On the CPU each call
is timed on the host's clock after a synchronisation.  Entry points run on
the card unless ``--device cpu`` (``device="cpu"``) is given.  On the CPU
the ``weak`` and ``coalesce`` modes run their multi-rank points as gloo
ranks (`_workers`): code-path records, not performance numbers, as the JAX
harness says of its CPU mesh.  On one card ``weak`` has one point.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import tempfile
import time

#: The CLI's modes (JAX ``benchmarks/run.py:932-934`` without ``batch_hlo``).
MODES = ("diffusion", "acoustic", "porous", "weak", "coalesce", "grad", "batch",
         "reconcile", "tuned", "profile", "all")
#: JAX's modes that read XLA's HLO, each with why the port has none.
NO_TWIN = {
    "batch_hlo": "it reads XLA's optimized HLO, which the port does not have; the "
                 "structural B-for-the-price-of-1 check is the cost-model analyzer's "
                 "exchange/porous[coalesce=True,batch=4] program (python -m "
                 "implicitglobalgrid_tpu_torch.analysis cost-model)",
}

#: Standard member job length (steps) of the members/s figure (JAX's).
BATCH_JOB_STEPS = 100


def _torch_dtype(dtype):
    import torch

    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=_torch_dtype(dtype)).element_size()


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_steps(step, state, chunk: int, reps: int, warmup: int = 2):
    """``(seconds per step, state, spread)`` of ``step(*state) -> state``
    advancing ``chunk`` steps a call: the median over ``reps`` timed calls
    after ``warmup`` untimed ones (module docstring); ``spread`` holds the
    per-call min / median / max in ms per step (JAX's keys)."""
    import torch

    device = state[0].device
    for _ in range(warmup):
        state = step(*state)
    _sync(device)
    if device.type == "cuda":
        # one event before the first call and one after each: a call's time
        # runs from the end of the previous one, as in a production loop (an
        # event pair around each call alone would also count the device's
        # tail after the host's last launch, which the next call overlaps)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for end in events[1:]:
            state = step(*state)
            end.record()
        _sync(device)
        per = [a.elapsed_time(b) * 1e-3 / chunk for a, b in zip(events, events[1:])]
    else:
        per = []
        for _ in range(reps):
            t0 = time.perf_counter()
            state = step(*state)
            per.append((time.perf_counter() - t0) / chunk)
    t_it = statistics.median(per)
    spread = {"reps": reps, "t_it_ms_min": round(min(per) * 1e3, 4),
              "t_it_ms_med": round(t_it * 1e3, 4), "t_it_ms_max": round(max(per) * 1e3, 4)}
    return t_it, state, spread


def _pipelined_provenance(pipelined, fused_k, model_mod, local_shape, dtype, fused_tile,
                          gg, support_kwargs=None):
    """(metric suffix, extra record) for a ``pipelined`` request (JAX's
    contract): the verdict is the model's own `pipelined_support_error`, so a
    split that fell back is recorded as such; auto records its decision,
    which on the port also needs an x/y partner other than the block itself
    (`models._fused.resolve_pipelined`).  The suffix changes only for an
    explicit ``pipelined=True`` that split."""
    from ..ops.halo import _partner_self, dim_has_halo_activity

    if not fused_k:
        return "", None
    bx, by = fused_tile if fused_tile is not None else (None, None)
    err = model_mod.pipelined_support_error(tuple(local_shape), fused_k, _torch_dtype(dtype),
                                            bx, by, gg=gg, **(support_kwargs or {}))
    if pipelined is None:
        remote = any(dim_has_halo_activity(gg, d) and not _partner_self(gg, d) for d in (0, 1))
        if err is None and not remote:
            err = "every x/y partner is the block itself"
        return "", {"pipelined": "auto-on" if err is None else f"auto-off: {err}"}
    if not pipelined:
        return "", {"pipelined": "off"}
    if err is None:
        return "_piped", {"pipelined": "on"}
    return "", {"pipelined": f"fallback: {err}"}


def _fused_provenance(fused_k, support_error, local_shape, dtype, device):
    """Metric suffix and path of a ``fused_k`` request: ``_fused<k>`` and
    ``"cuda-fused"`` where the kernel runs on the card, ``"cpu-fused-plain"``
    where its wrapper runs the plain version (CPU tensors).  A config the
    kernel does not take raises, as the models do (JAX warns, runs its plain
    cadence and suffixes ``fb``)."""
    if not fused_k:
        return "", None
    err = support_error(tuple(local_shape), fused_k, _torch_dtype(dtype))
    if err is not None:
        raise ValueError(f"fused_k={fused_k}: {err}")
    return f"_fused{fused_k}", "cuda-fused" if device.type == "cuda" else "cpu-fused-plain"


def _grid_kwargs(overlap, period):
    """Setup kwargs of the overlap/period knobs (JAX's); a period axis not
    in 'xyz' raises."""
    kw = {} if overlap is None else dict(overlapx=overlap, overlapy=overlap, overlapz=overlap)
    for ax in period or "":
        if ax not in "xyz":
            raise ValueError(f"--period axes must be from 'xyz', got {period!r}")
        kw[f"period{ax}"] = 1
    return kw


def metric_name(model: str, n: int, dtype: str, *, npt=None, period=None, hide_comm=False,
                fsuf: str = "", psuf: str = "", exchange_every: int = 1) -> str:
    """A config's metric name (JAX's, built inline in each of its benches)."""
    return (f"{model}_{n}_{dtype}" + (f"_npt{npt}" if npt is not None else "")
            + (f"_period{period}" if period else "") + ("_overlap" if hide_comm else "")
            + fsuf + psuf + (f"_xch{exchange_every}" if exchange_every > 1 else ""))


def _emit(name, teff, t_it, extra=None, emit=True):
    """The record (JAX's keys), folded into the telemetry registry, and
    printed as one line unless ``emit=False``."""
    from ..utils import telemetry as _telemetry

    rec = {"metric": name, "value": round(teff, 2), "unit": "GB/s/chip",
           "t_it_ms": round(t_it * 1e3, 4)}
    if extra:
        rec.update(extra)
    _telemetry.gauge(f"bench.{name}.teff_gbs").set(teff)
    _telemetry.histogram("bench.teff_gbs").record(teff)
    _telemetry.histogram("bench.t_it_s").record(t_it)
    if emit:
        print(json.dumps(rec), flush=True)
    return rec


def _fresh_grid():
    from .. import finalize_global_grid, grid_is_initialized

    if grid_is_initialized():
        finalize_global_grid()


def _model_bench(mod, kernel_mod, *, n, chunk, reps, dtype, device, okw, setup_kw,
                 step_kw, fused_k, fused_tile, pipelined, support_kwargs=None):
    """Set up, provenance, time and tear down one model config."""
    from .. import finalize_global_grid, get_global_grid

    _fresh_grid()
    state, params = mod.setup(n, n, n, dtype=_torch_dtype(dtype), quiet=True, device=device,
                              **setup_kw, **okw)
    step = mod.make_multi_step(params, chunk, fused_k=fused_k, fused_tile=fused_tile,
                               pipelined=pipelined, **step_kw)
    gg = get_global_grid()
    fsuf, fpath = _fused_provenance(fused_k, kernel_mod.fused_support_error, state[0].shape,
                                    dtype, state[0].device)
    psuf, prec = _pipelined_provenance(pipelined, fused_k, mod, state[0].shape, dtype,
                                       fused_tile, gg, support_kwargs)
    t_it, state, spread = _time_steps(step, state, chunk, reps)
    finalize_global_grid()
    extra = {"dims": list(gg.dims), "nprocs": gg.nprocs, "spread": spread}
    if fpath:
        extra["path"] = fpath
    if prec:
        extra.update(prec)
    return t_it, extra, fsuf, psuf


def bench_diffusion(n=256, chunk=25, reps=4, dtype="float32", hide_comm=False, emit=True,
                    fused_k=None, fused_tile=None, exchange_every=1, overlap=None,
                    period=None, pipelined=None, device=None):
    """3-D heat diffusion.  ``fused_k``: the temporally blocked kernel (k
    steps per pass over HBM); ``fused_tile=(bx, by)`` its x segment and y
    tile (default: its auto pick)."""
    from ..models import diffusion3d
    from ..ops import fused_stencil

    t_it, extra, fsuf, psuf = _model_bench(
        diffusion3d, fused_stencil, n=n, chunk=chunk, reps=reps, dtype=dtype,
        device=device, okw=_grid_kwargs(overlap, period), setup_kw={"hide_comm": hide_comm},
        step_kw={"exchange_every": exchange_every}, fused_k=fused_k, fused_tile=fused_tile,
        pipelined=pipelined)
    nbytes = 2 * n**3 * _itemsize(dtype)
    return _emit(metric_name("diffusion3d", n, dtype, period=period, hide_comm=hide_comm,
                             fsuf=fsuf, psuf=psuf, exchange_every=exchange_every),
                 nbytes / t_it / 1e9, t_it, extra, emit=emit)


def bench_acoustic(n=192, chunk=25, reps=4, dtype="float32", hide_comm=False, emit=True,
                   exchange_every=1, overlap=None, fused_k=None, fused_tile=None, period=None,
                   pipelined=None, device=None):
    """3-D acoustic staggered leapfrog; ``fused_k``: the staggered kernel."""
    from ..models import acoustic3d
    from ..ops import fused_leapfrog

    t_it, extra, fsuf, psuf = _model_bench(
        acoustic3d, fused_leapfrog, n=n, chunk=chunk, reps=reps, dtype=dtype,
        device=device, okw=_grid_kwargs(overlap, period), setup_kw={"hide_comm": hide_comm},
        step_kw={"exchange_every": exchange_every}, fused_k=fused_k, fused_tile=fused_tile,
        pipelined=pipelined)
    nbytes = 8 * n**3 * _itemsize(dtype)  # P, Vx, Vy, Vz in+out
    return _emit(metric_name("acoustic3d", n, dtype, period=period, hide_comm=hide_comm,
                             fsuf=fsuf, psuf=psuf, exchange_every=exchange_every),
                 nbytes / t_it / 1e9, t_it, extra, emit=emit)


def bench_porous(n=128, chunk=4, reps=3, npt=10, dtype="float32", emit=True,
                 exchange_every=1, overlap=None, fused_k=None, fused_tile=None, period=None,
                 pipelined=None, device=None):
    """Porous convection: ``chunk`` time steps (``chunk * npt`` PT
    iterations) a call; ``fused_k``: the PT kernel (any ``npt``: the ragged
    chunk schedule)."""
    from ..models import porous_convection3d as pc
    from ..ops import fused_pt

    t_step, extra, fsuf, psuf = _model_bench(
        pc, fused_pt, n=n, chunk=chunk, reps=reps, dtype=dtype,
        device=device, okw=_grid_kwargs(overlap, period), setup_kw={"npt": npt},
        step_kw={"exchange_every": exchange_every}, fused_k=fused_k, fused_tile=fused_tile,
        pipelined=pipelined, support_kwargs={"npt": npt})
    t_pt = t_step / npt
    extra = {**extra, "t_pt_ms": round(t_pt * 1e3, 4)}
    nbytes = 8 * n**3 * _itemsize(dtype)  # qDx, qDy, qDz, Pf in+out per PT iteration
    return _emit(metric_name("porous_convection3d", n, dtype, npt=npt, period=period,
                             fsuf=fsuf, psuf=psuf, exchange_every=exchange_every),
                 nbytes / t_pt / 1e9, t_step, extra, emit=emit)


def bench_tuned_vs_default(model="diffusion", n=256, chunk=24, reps=3, dtype="float32", npt=12,
                           overlap=None, period=None, emit=True, device=None):
    """The autotuner's closed loop: the default config's chunk against the
    ``autotune=True`` chunk at one point, ``tuned_speedup = t_default /
    t_tuned``.  The tuned build resolves through the winner cache
    (``IGG_TUNE_CACHE``); ``cache`` says whether it hit or searched."""
    from .. import finalize_global_grid, get_global_grid, tuning
    from ..models import acoustic3d, diffusion3d, porous_convection3d
    from ..utils import telemetry as _tele

    mod, model_name, setup_kw = {
        "diffusion": (diffusion3d, "diffusion3d", {}),
        "acoustic": (acoustic3d, "acoustic3d", {}),
        "porous": (porous_convection3d, "porous_convection3d", {"npt": npt}),
    }[model]
    _fresh_grid()
    dt = _torch_dtype(dtype)
    state, params = mod.setup(n, n, n, dtype=dt, quiet=True, device=device, **setup_kw,
                              **_grid_kwargs(overlap, period))

    def counters():
        return {k: v for k, v in _tele.snapshot().get("counters", {}).items()
                if k.startswith("tune.")}

    before = counters()
    t_def, _, spread_def = _time_steps(mod.make_multi_step(params, chunk), state, chunk, reps)
    step_tuned = mod.make_multi_step(params, chunk, autotune=True)
    after = counters()
    state2, _ = mod.setup(n, n, n, dtype=dt, init_grid=False, **setup_kw)
    t_tun, _, spread_tun = _time_steps(step_tuned, state2, chunk, reps)
    gg = get_global_grid()
    key = tuning.make_key(model_name, gg.nxyz, dt, gg=gg,
                          extra={"npt": int(npt)} if model == "porous" else None, nsteps=chunk)
    entry = tuning.TuneCache().lookup(key)
    finalize_global_grid()
    hits = after.get("tune.cache_hit", 0) - before.get("tune.cache_hit", 0)
    rec = {
        "model": model_name, "n": n, "tuned_speedup": round(t_def / t_tun, 4),
        "t_default_ms": round(t_def * 1e3, 4), "t_tuned_ms": round(t_tun * 1e3, 4),
        "config": entry["config"] if entry else {}, "source": entry["source"] if entry else None,
        "cache": "hit" if hits else "miss",
        "spread": {"default": spread_def, "tuned": spread_tun},
    }
    if emit:
        print(json.dumps({"metric": f"{model_name}_{n}_{dtype}_tuned_vs_default",
                          "value": rec["tuned_speedup"], "unit": "x", **rec}), flush=True)
    return rec


def bench_batch(n=128, chunk=16, reps=3, dtype="float32", B_list=(1, 2, 4, 8), emit=True,
                fused_k=None, fused_tile=None, exchange_every=1, overlap=None, period=None,
                device=None):
    """Ensemble throughput: members/s per GPU over a B sweep of the batched
    diffusion cadence (`make_multi_step(batch=True)`, the serving round's
    step); ``members_per_s = B / (t_step * BATCH_JOB_STEPS) / nprocs``."""
    from .. import finalize_global_grid, get_global_grid
    from ..models import _batched, diffusion3d
    from ..utils import telemetry as _telemetry

    okw = _grid_kwargs(overlap, period)
    sweep, nprocs = {}, 1
    for B in B_list:
        _fresh_grid()
        bstate, params = _batched.batched_setup(diffusion3d, n, n, n, batch=B,
                                                dtype=_torch_dtype(dtype), quiet=True,
                                                device=device, **okw)
        step = diffusion3d.make_multi_step(params, chunk, batch=True, fused_k=fused_k,
                                           fused_tile=fused_tile, exchange_every=exchange_every)
        t_it, _, spread = _time_steps(step, bstate, chunk, reps)
        nprocs = get_global_grid().nprocs
        finalize_global_grid()
        members_per_s = B / (t_it * BATCH_JOB_STEPS) / nprocs
        sweep[f"B{B}"] = {"members_per_s": round(members_per_s, 4),
                          "member_steps_per_s": round(B / t_it / nprocs, 2),
                          "t_step_ms": round(t_it * 1e3, 4), "spread": spread}
        _telemetry.gauge(f"bench.batch.B{B}.members_per_s").set(members_per_s)
    b1 = sweep.get("B1", {}).get("members_per_s") or None
    best_key = max(sweep, key=lambda k: sweep[k]["members_per_s"])
    best = sweep[best_key]["members_per_s"]
    rec = {"metric": f"diffusion3d_batch_{n}_{dtype}", "value": best, "unit": "members/s/chip",
           "members_per_s": best, "best_B": int(best_key[1:]), "job_steps": BATCH_JOB_STEPS,
           "nprocs": nprocs, "sweep": sweep,
           "throughput_multiplier": round(best / b1, 3) if b1 else None}
    if emit:
        print(json.dumps(rec), flush=True)
    return rec


def bench_halo_coalesce(n=32, width=2, reps=3, emit=True, device=None, nprocs=1):
    """Coalesced-vs-per-field exchange A/B on the porous five-field set,
    periodic z, overlap ``2 width``: per variant the hops (merged over the
    ranks as the ``cost-model`` analyzer merges them,
    `analysis.costmodel.hop_payloads`), their payload bytes and the time per
    call.  On one rank every partner is the block itself and nothing is sent
    either way; ``nprocs > 1`` (CPU) runs the variants on that many gloo
    ranks."""
    from ..analysis.costmodel import hop_payloads

    if nprocs > 1:
        recs = _spawn_bench("bench_halo_coalesce", dict(n=n, width=width, reps=reps), nprocs)
        rec = recs[0]
        for variant in ("per_field", "coalesced"):
            hops = hop_payloads(r[variant].pop("sends") for r in recs)[0]
            rec[variant].update(n_collective_permutes=len(hops),
                                payload_bytes_total=sum(hops))
        return _coalesce_finish(rec, emit)
    import torch

    from .. import finalize_global_grid, get_global_grid, init_global_grid, update_halo
    from .._workers import _count_p2p
    from ..analysis.budget import model_fields
    from ..parallel.topology import NDIMS

    _fresh_grid()
    init_global_grid(n, n, n, periodz=1, quiet=True, device=device,
                     **_grid_kwargs(2 * width, None))
    gg = get_global_grid()
    gen = torch.Generator().manual_seed(0)
    fields = [torch.rand(A.shape, generator=gen, dtype=torch.float32).to(gg.device)
              for A in model_fields("porous", n)]
    rec = {"metric": f"halo_coalesce_ab_5field_{n}cube_w{width}", "nfields": len(fields),
           "dims": list(gg.dims)}
    for name, coalesce in (("per_field", False), ("coalesced", True)):
        log = []
        restore = _count_p2p([0] * (2 * NDIMS), log)
        try:
            update_halo(*fields, width=width, coalesce=coalesce)
        finally:
            restore()
        sends = [(call, tag, nbytes) for kind, _, tag, nbytes, call in log if kind == "send"]
        t_call, _, spread = _time_steps(
            lambda *fs, _c=coalesce: update_halo(*fs, width=width, coalesce=_c), fields, 1, reps)
        hops = hop_payloads([sends])[0]
        rec[name] = {"n_collective_permutes": len(hops), "payload_bytes_total": sum(hops),
                     "t_call_ms": round(t_call * 1e3, 4), "spread": spread,
                     "sends": sends}
    finalize_global_grid()
    if gg.nprocs > 1:
        return rec  # a rank of a spawned run: the parent merges the sends
    for name in ("per_field", "coalesced"):
        rec[name].pop("sends")
    return _coalesce_finish(rec, emit)


def _coalesce_finish(rec, emit):
    from ..utils import telemetry as _telemetry

    rec["collectives_ratio"] = round(rec["per_field"]["n_collective_permutes"]
                                     / max(rec["coalesced"]["n_collective_permutes"], 1), 2)
    _telemetry.gauge("bench.halo_coalesce_ab.collectives_ratio").set(rec["collectives_ratio"])
    if emit:
        print(json.dumps(rec), flush=True)
    return rec


def bench_diffusion_grad(n=256, chunk=8, reps=3, dtype="float32", fused_k=4, overlap=None,
                         period=None, emit=True, device=None):
    """Gradient-path record: ``torch.autograd.grad`` through the fused
    cadence against its forward (the backward recomputes the plain cadence
    per group, `ops.overlap.fused_with_plain_grad`)."""
    import torch

    from .. import finalize_global_grid
    from ..models import diffusion3d

    _fresh_grid()
    state, params = diffusion3d.setup(n, n, n, dtype=_torch_dtype(dtype), quiet=True,
                                      device=device, **_grid_kwargs(overlap, period))
    step = diffusion3d.make_multi_step(params, chunk, fused_k=fused_k)
    t_fwd, state, spread_f = _time_steps(step, state, chunk, reps)

    def gstep(T, Cp):
        # diffusion's VJP does not depend on T: the gradient feeds back as
        # the next T, a pure timing loop
        T0 = T.detach().requires_grad_()
        (g,) = torch.autograd.grad(step(T0, Cp)[0].sum(), T0)
        return g, Cp

    t_grad, _, spread_g = _time_steps(gstep, state, chunk, reps)
    finalize_global_grid()
    nbytes = 2 * n**3 * _itemsize(dtype)
    return _emit(
        f"diffusion3d_grad_{n}_{dtype}_fused{fused_k}" + (f"_period{period}" if period else ""),
        nbytes / t_grad / 1e9, t_grad,
        {"t_fwd_ms": round(t_fwd * 1e3, 4), "grad_over_fwd": round(t_grad / t_fwd, 3),
         "spread": spread_g, "fwd_spread": spread_f,
         "note": ("value = A_eff/t of ONE grad step (the fused forward chunk + the plain "
                  "cadence's forward and backward per group)")},
        emit=emit)


def bench_profile_attribution(n=16, steps=6, emit=True, device=None):
    """The measured device timeline: a `utils.profiling.profile_trace`
    capture around a short diffusion run, attributed per scope, with the
    measured overlap of exchanges and kernels."""
    from .. import finalize_global_grid, init_global_grid
    from ..models import diffusion3d
    from ..utils import profiling

    _fresh_grid()
    init_global_grid(n, n, n, quiet=True, device=device)
    logdir = tempfile.mkdtemp(prefix="igg_profile_attr_")
    try:
        state, params = diffusion3d.setup(n, n, n, init_grid=False)
        step = diffusion3d.make_step(params)
        state = step(*state)  # first call outside the window
        _sync(state[0].device)
        with profiling.profile_trace(logdir):
            for _ in range(steps):
                state = step(*state)
                _sync(state[0].device)
        rec = profiling.attribute_capture(logdir)
        profiling.publish_attribution(rec)
    finally:
        finalize_global_grid()
        shutil.rmtree(logdir, ignore_errors=True)
    out = {"metric": "profile_attribution", "value": rec["overlap"]["fraction"],
           "unit": "overlap_fraction", "n": n, "steps": steps,
           "overlap_fraction": rec["overlap"]["fraction"], "scope_seconds": rec["scope_seconds"],
           "overlap": rec["overlap"], "n_device_ops": rec["n_device_ops"],
           "device_seconds": rec["device_seconds"]}
    if emit:
        print(json.dumps(out), flush=True)
    return out


def _spawn_bench(func: str, kwargs: dict, nprocs: int, timeout: float = 300.0) -> list[dict]:
    """``func(**kwargs, device="cpu")`` on ``nprocs`` gloo ranks
    (`_workers`, task kind ``"bench"``); each rank's record."""
    from .. import _workers

    workdir = tempfile.mkdtemp(prefix="igg_bench_")
    try:
        outs = _workers.spawn(dict(kind="bench", func=func, kwargs=kwargs, inputs={}), nprocs,
                              workdir, timeout=timeout)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return [json.loads(bytes(o["record"]).decode()) for o in outs]


def bench_weak_scaling(n=128, chunk=25, reps=4, dtype="float32", hide_comm=False,
                       model="diffusion", npt=10, device=None, emit=True):
    """Weak scaling: the same ``n^3`` block per rank on 1, 2, ... ranks;
    parallel efficiency = t(1) / t(N).  One card: one point (more need a
    rank per card, ROADMAP leftover 3).  CPU: 1 and 2 ranks, the second on
    gloo ranks."""
    import torch

    counts = (1,) if torch.device(device or "cuda").type == "cuda" else (1, 2)
    if model == "porous":
        func, kw = "bench_porous", dict(n=n, chunk=max(chunk // npt, 1), reps=reps, npt=npt,
                                        dtype=dtype)
    else:
        func, kw = "bench_diffusion", dict(n=n, chunk=chunk, reps=reps, dtype=dtype,
                                           hide_comm=hide_comm)
    results = {}
    for c in counts:
        if c == 1:
            rec = globals()[func](emit=False, device=device, **kw)
        else:
            rec = _spawn_bench(func, kw, c)[0]
        results[c] = rec["t_it_ms"]
    base = results[counts[0]]
    effs = {c: round(base / t, 4) for c, t in results.items()}
    rec = {"metric": f"weak_scaling_{model}3d_{n}_{dtype}" + ("_overlap" if hide_comm else ""),
           "value": effs[counts[-1]], "unit": "parallel_efficiency", "per_count": effs}
    if emit:
        print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m implicitglobalgrid_tpu_torch.benchmarks.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("what", nargs="?", default="all", choices=MODES + tuple(NO_TWIN))
    p.add_argument("--model", default="diffusion", choices=["diffusion", "acoustic", "porous"],
                   help="model for the tuned mode (tuned-vs-default A/B)")
    p.add_argument("--batch-sizes", default="1,2,4,8",
                   help="comma-separated B sweep for the batch mode")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--hide-comm", action="store_true")
    p.add_argument("--npt", type=int, default=10)
    p.add_argument("--fused-k", type=int, default=None,
                   help="temporally blocked kernel: k steps per HBM pass")
    p.add_argument("--exchange-every", type=int, default=1,
                   help="slab cadence: w steps per width-w halo exchange "
                        "(needs a deep-halo grid: --overlap >= 2w)")
    p.add_argument("--overlap", type=int, default=None,
                   help="grid overlap in every dimension")
    p.add_argument("--period", default=None, help="periodic dimensions, e.g. 'z' or 'xz'")
    p.add_argument("--pipelined", action="store_true", default=None,
                   help="boundary-first pipelined group schedule (fused_k cadences); omit "
                        "for the models' auto default")
    p.add_argument("--serialized", dest="pipelined", action="store_false",
                   help="force the serialized group schedule")
    p.add_argument("--weak-model", default="diffusion", choices=["diffusion", "porous"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card) or cpu")
    a = p.parse_args(argv)
    if a.what in NO_TWIN:
        p.exit(2, f"{p.prog}: mode {a.what!r} has no twin in the port: {NO_TWIN[a.what]}\n")
    tuned_chunk = 24 if a.chunk is None else a.chunk
    if a.chunk is None:
        a.chunk = 25
    dev = a.device
    kw = dict(chunk=a.chunk, reps=a.reps, dtype=a.dtype, device=dev)
    if a.what in ("diffusion", "all"):
        bench_diffusion(n=a.n or 256, hide_comm=a.hide_comm, fused_k=a.fused_k,
                        exchange_every=a.exchange_every, overlap=a.overlap, period=a.period,
                        pipelined=a.pipelined, **kw)
    if a.what in ("acoustic", "all"):
        bench_acoustic(n=a.n or (256 if a.fused_k else 192), hide_comm=a.hide_comm,
                       fused_k=a.fused_k, exchange_every=a.exchange_every, overlap=a.overlap,
                       period=a.period, pipelined=a.pipelined, **kw)
    if a.what in ("porous", "all"):
        bench_porous(n=a.n or (256 if a.fused_k else 128),
                     chunk=a.chunk if a.what == "porous" else 4, reps=a.reps, npt=a.npt,
                     dtype=a.dtype, fused_k=a.fused_k, exchange_every=a.exchange_every,
                     overlap=a.overlap, period=a.period, pipelined=a.pipelined, device=dev)
    if a.what in ("weak", "all"):
        bench_weak_scaling(n=a.n or 128, chunk=a.chunk, reps=a.reps, dtype=a.dtype,
                           hide_comm=a.hide_comm, model=a.weak_model, npt=a.npt, device=dev)
    if a.what == "coalesce":
        bench_halo_coalesce(n=a.n or 32, reps=a.reps, device=dev,
                            nprocs=2 if dev == "cpu" else 1)
    if a.what == "batch":
        bench_batch(n=a.n or 128, chunk=a.chunk, reps=a.reps, dtype=a.dtype,
                    B_list=tuple(int(b) for b in a.batch_sizes.split(",")), fused_k=a.fused_k,
                    exchange_every=a.exchange_every, overlap=a.overlap, period=a.period,
                    device=dev)
    if a.what == "profile":
        bench_profile_attribution(n=a.n or 16, device=dev)
    if a.what == "reconcile":
        from ..analysis.reconcile import reconcile_report

        print(json.dumps(reconcile_report(source="modeled")), flush=True)
    if a.what == "grad":
        bench_diffusion_grad(n=a.n or 256, chunk=a.chunk, reps=a.reps, dtype=a.dtype,
                             fused_k=a.fused_k or 4, overlap=a.overlap, period=a.period,
                             device=dev)
    if a.what == "tuned":
        bench_tuned_vs_default(model=a.model, n=a.n or 256, chunk=tuned_chunk, reps=a.reps,
                               dtype=a.dtype, npt=a.npt, overlap=a.overlap, period=a.period,
                               device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
