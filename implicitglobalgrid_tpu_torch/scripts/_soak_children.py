"""The soak's child processes (`scripts.soak`): one fresh process per run.

Each ``child_*`` is the port's twin of the JAX soak's child of the same
name.  A child is one rank: one process holds one block on ``--device``
(the JAX child's ``--devices`` CPU mesh has no counterpart — a drill's
topology is its process count).  CPU children run on one intra-op thread:
a fresh process's first threaded float64 `torch.exp` is sometimes wrong
past its first chunk (ROADMAP Queue C), and every soak result is held bit
for bit.  Children on CUDA load the kernel libraries already built under
``_build/`` (hash-keyed, `ops._kernels`), or build them once.

Every child that computes a field writes ``<out>.json`` beside its array:
the kernel launches it made (the wrappers' ``launches`` counts) and the
sha256 of the saved array's bytes.  An injected ``worker_crash`` ends the
process with ``os._exit``, which skips every exit hook, so `child_main`
writes that report on the way out too.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time

def _torch(args):
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    return torch


def _dtype(args):
    """float64 on the CPU (the JAX children's x64), float32 on the card
    (the main path's)."""
    import torch

    return torch.float64 if args.device == "cpu" else torch.float32


def launch_counts() -> dict:
    """The kernel wrappers' ``launches`` counts in this process."""
    from ..ops import fused_leapfrog, fused_pt, fused_stencil

    return {"fused_diffusion_steps": fused_stencil.launches,
            "fused_leapfrog_steps": fused_leapfrog.launches,
            "fused_pt_iterations": fused_pt.launches}


def array_sha256(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def write_report(out: str, arr=None, **extra) -> None:
    """``<out>.json``: the launches so far, the array's sha256 (when one
    was saved) and ``extra``."""
    doc = {"launches": launch_counts(), "ts": time.time(), **extra}
    if arr is not None:
        doc["sha256"] = array_sha256(arr)
    with open(out + ".json", "w") as f:
        json.dump(doc, f)


def _save(args, arr) -> None:
    import numpy as np

    np.save(args.out, arr)
    write_report(args.out, arr)


# ---------------------------------------------------------------------------
# single-process: one guarded diffusion run
# ---------------------------------------------------------------------------


def child_main(args) -> int:
    """The baseline / init_flake / halo_corrupt / worker_crash child: one
    guarded diffusion ``run()`` (NaN/Inf probe with rollback, checkpoints)
    on a one-block grid.  ``--distributed`` brings up a one-rank
    `torch.distributed` group first, through the guarded bring-up
    (`parallel.distributed.init_distributed`: retries, backoff) that the
    init_flake scenario exercises.  With ``--fused-k K`` the loop steps in
    kernel groups of K: the guard probes every group, checkpoints every
    two."""
    _torch(args)
    import numpy as np

    from ..models import diffusion3d
    from ..utils import tracing

    if args.distributed:
        # A one-rank group on an ephemeral rendezvous port.
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(args.port))
    group = args.fused_k or 1
    real_exit = os._exit

    def exit_with_report(status):
        # the injected worker_crash: report the launches, then die hard
        write_report(args.out, crashed=status)
        real_exit(status)

    os._exit = exit_with_report
    T = diffusion3d.run(
        args.steps, args.nx, args.nx, args.nx, quiet=True, device=args.device,
        dtype=_dtype(args), guard_every=group, guard_policy="rollback",
        checkpoint_every=2 * group, checkpoint_dir=args.ckpt_dir,
        fused_k=args.fused_k or None,
    )
    os._exit = real_exit
    tracing.dump_trace()  # this rank's spans, when IGG_TELEMETRY_DIR is set
    arr = T.cpu().numpy()
    if not np.isfinite(arr).all():
        print("SOAK CHILD: non-finite final field", file=sys.stderr)
        return 1
    _save(args, arr)
    print("SOAK CHILD OK", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the 2-rank drills' workers (one rank each; the supervisor sets RANK,
# WORLD_SIZE and the rendezvous)
# ---------------------------------------------------------------------------


def _pair_grid(args):
    """The implicit global grid of the pair and of its one-process twin:
    ``--nproc 2`` = one member of the pair (dims (2,1,1), local
    ``nx^3``); ``--nproc 1`` = the single process spanning the SAME global
    grid (local ``(2*nx-2, nx, nx)``)."""
    if args.nproc > 1:
        return (args.nx, args.nx, args.nx)
    return (2 * args.nx - 2, args.nx, args.nx)


def _bring_up(args, nxyz):
    import implicitglobalgrid_tpu_torch as igg
    from ..utils import resilience

    resilience.arm_watchdog(max(30, args.timeout - 40), exit=True)
    igg.init_global_grid(*nxyz, quiet=(args.pair_id != 0), device=args.device)
    return igg


def child_elastic_main(args) -> int:
    """One worker of the elastic-failover and chaos drills: a guarded
    diffusion loop (checkpoints every two steps) that gathers the final
    de-duplicated field on rank 0.  ``--nproc 1`` is the oracle run, or
    the shrunk restart when ``--ckpt-dir`` points at the pair's
    directory."""
    _torch(args)
    import numpy as np

    from ..models import diffusion3d
    from ..utils import resilience, tracing
    from ..utils.telemetry import teff_bytes

    nxyz = _pair_grid(args)
    igg = _bring_up(args, nxyz)
    if args.expect_resume_step >= 0:
        latest = igg.latest_checkpoint(args.ckpt_dir)
        want = f"step_{args.expect_resume_step:08d}"
        assert latest is not None and latest.endswith(want), (
            f"expected the restart to fall back to the valid {want} "
            f"generation, found {latest!r}"
        )
    state, params = diffusion3d.setup(*nxyz, init_grid=False, dtype=_dtype(args))
    guard = resilience.RunGuard(
        checkpoint_every=2 if args.ckpt_dir else 0,
        checkpoint_dir=args.ckpt_dir or None, names=("T", "Cp"),
    )
    state = resilience.guarded_time_loop(
        diffusion3d.make_step(params), state, args.steps, guard=guard,
        model="diffusion3d", bytes_per_step=teff_bytes(state[:1]),
    )
    dd = igg.gather(diffusion3d.temperature(state), dedup=True, root=0)
    if igg.distributed.process_index() == 0:
        assert dd is not None and np.isfinite(dd).all()
        _save(args, dd)
        igg.dump_metrics(args.out + ".metrics")
    tracing.dump_trace()
    igg.finalize_global_grid()
    print("SOAK CHILD OK", flush=True)
    return 0


def child_sdc_main(args) -> int:
    """One worker of the sdc drill: a guarded diffusion-like run whose
    exchange goes through the host `update_halo` entry, which the
    transport checksums cover (``IGG_INTEGRITY=1``).  The interior update
    is functional on the pre-step values and the halos entering step k
    hold step k-1's committed neighbour planes, so the pair and its
    one-process twin stay bit for bit equal in de-duplicated space."""
    _torch(args)
    import numpy as np

    from ..models import diffusion3d
    from ..utils import resilience
    from ..utils.telemetry import teff_bytes

    nxyz = _pair_grid(args)
    igg = _bring_up(args, nxyz)
    state, _params = diffusion3d.setup(*nxyz, init_grid=False, dtype=_dtype(args))

    @igg.stencil
    def interior(T, Cp):
        avg = (
            T[:-2, 1:-1, 1:-1] + T[2:, 1:-1, 1:-1]
            + T[1:-1, :-2, 1:-1] + T[1:-1, 2:, 1:-1]
            + T[1:-1, 1:-1, :-2] + T[1:-1, 1:-1, 2:]
        ) / 6.0
        mid = T[1:-1, 1:-1, 1:-1]
        T = T.clone()
        T[1:-1, 1:-1, 1:-1] = mid + 0.1 * Cp[1:-1, 1:-1, 1:-1] * (avg - mid)
        return T, Cp

    def step(T, Cp):
        T, Cp = interior(T, Cp)
        return igg.update_halo(T, Cp)  # the host path: the checksummed plane

    guard = resilience.RunGuard(
        checkpoint_every=2 if args.ckpt_dir else 0,
        checkpoint_dir=args.ckpt_dir or None, names=("T", "Cp"),
    )
    state = resilience.guarded_time_loop(
        step, state, args.steps, guard=guard, model="diffusion3d",
        bytes_per_step=teff_bytes(state[:1]),
    )
    dd = igg.gather(diffusion3d.temperature(state), dedup=True, root=0)
    if igg.distributed.process_index() == 0:
        assert dd is not None and np.isfinite(dd).all()
        _save(args, dd)
        # counters the clean-leg acceptance reads: integrity.audits > 0,
        # *_mismatches == 0
        igg.dump_metrics(args.out + ".metrics")
    igg.finalize_global_grid()
    print("SOAK CHILD OK", flush=True)
    return 0


def child_live_main(args) -> int:
    """One worker of the live-plane drill: a member of the pair running
    instrumented diffusion with the scrape server on an ephemeral port.
    The orchestrator injects the stall, scrapes mid-run and verifies."""
    _torch(args)
    from ..models import diffusion3d
    from ..utils import resilience
    from ..utils.telemetry import teff_bytes

    igg = _bring_up(args, (args.nx, args.nx, args.nx))
    state, params = diffusion3d.setup(args.nx, args.nx, args.nx, init_grid=False,
                                      dtype=_dtype(args))
    # No guard cadence: the armed stall alone enables the per-step pipeline,
    # and the live plane rides the telemetry hooks.
    guard = resilience.RunGuard(names=("T", "Cp"))
    state = resilience.guarded_time_loop(
        diffusion3d.make_step(params), state, args.steps, guard=guard,
        model="diffusion3d", bytes_per_step=teff_bytes(state[:1]),
    )
    assert bool(state[0].isfinite().all())
    igg.finalize_global_grid()
    print("SOAK CHILD OK", flush=True)
    return 0


# ---------------------------------------------------------------------------
# serving children
# ---------------------------------------------------------------------------


def _step_kwargs(args) -> dict:
    return {"fused_k": args.fused_k} if args.fused_k else {}


def _round_steps(args) -> int:
    """Steps per serving round of the diffusion pools: one, or one kernel
    group with ``--fused-k``."""
    return args.fused_k or 1


def child_serving_main(args) -> int:
    """The batched-serving smoke: a 2-slot porous `ServingLoop` pool takes
    4 requests, so members admit and retire mid-flight — per-member
    convergence on the PT residual, a step budget, a NaN member evicted
    without touching its batch-mates, a late member in the freed slot.
    Asserts in the child; the orchestrator re-verifies the event schema."""
    _torch(args)
    from ..models import porous_convection3d as porous
    from ..serving import Request, ServingLoop

    import implicitglobalgrid_tpu_torch as igg

    nx, dtype = args.nx, _dtype(args)
    igg.init_global_grid(nx, nx, nx, quiet=True, device=args.device)
    _, params = porous.setup(nx, nx, nx, init_grid=False, npt=3, dtype=dtype)
    loop = ServingLoop(porous, params, capacity=2, steps_per_round=1,
                       step_kwargs=_step_kwargs(args))

    def member(scale):
        s, _ = porous.setup(nx, nx, nx, init_grid=False, npt=3, ic_scale=scale, dtype=dtype)
        return s

    m_conv = loop.submit(Request(state=member(1.0), max_steps=50, tol=1.0, tenant="conv"))
    m_budget = loop.submit(Request(state=member(0.7), max_steps=2, tenant="budget"))
    bad = member(0.5)
    bad_T = bad[0].clone()
    bad_T[(1,) * bad_T.dim()] = float("nan")
    m_bad = loop.submit(Request(state=(bad_T,) + tuple(bad[1:]), max_steps=9, tenant="bad"))
    m_late = loop.submit(Request(state=member(0.9), max_steps=2, tenant="late"))
    results = loop.run(max_rounds=60)
    assert results[m_conv].status == "converged", results[m_conv]
    assert results[m_budget].status == "completed", results[m_budget]
    assert results[m_bad].status == "evicted", results[m_bad]
    assert results[m_late].status == "completed", results[m_late]
    # mid-flight admission: the late member entered a slot after the pool
    # had already retired someone
    assert loop.rounds > 1 and len(results) == 4
    for m, r in results.items():
        if r.state is not None:
            assert all(bool(A.isfinite().all()) for A in r.state), m
    c = igg.telemetry_snapshot()["counters"]
    assert c.get("serving.admitted_total") == 4, c
    assert c.get("serving.retired_total") == 4, c
    assert c.get("serving.evicted_total") == 1, c
    assert c.get("serving.converged_total") == 1, c
    if args.out:
        write_report(args.out, rounds=loop.rounds)
    igg.finalize_global_grid()
    print("SOAK SERVING OK", flush=True)
    return 0


def child_frontdoor_main(args) -> int:
    """One serving process of the frontdoor drill: pool + front door at the
    given rung, optionally elastically resumed from the resize checkpoint.
    Exits 0 on a broadcast shutdown, `RESIZE_STATUS` after writing a
    resize plan — the supervisor relaunches at the plan's topology."""
    _torch(args)
    from ..models import diffusion3d
    from ..serving import (
        RESIZE_STATUS, AutoscalePolicy, Autoscaler, FrontDoor, Rung, ServingLoop,
    )
    from ..utils import tracing

    nxyz = _pair_grid(args)
    igg = _bring_up(args, nxyz)
    dtype = _dtype(args)
    _, params = diffusion3d.setup(*nxyz, init_grid=False, dtype=dtype)
    ladder = [Rung(*(int(x) for x in rung.split(":"))) for rung in args.ladder.split(",")]
    loop = ServingLoop(diffusion3d, params, capacity=args.capacity,
                       steps_per_round=_round_steps(args), step_kwargs=_step_kwargs(args))
    fd = FrontDoor(
        loop, checkpoint_dir=args.ckpt_dir,
        autoscaler=Autoscaler(AutoscalePolicy.from_env(ladder), rung=args.rung),
        setup_kwargs={"dtype": dtype},
    )
    if args.resume:
        assert fd.elastic_resume(), "resume requested but no checkpoint found"
    outcome = fd.serve_rounds(idle_sleep=0.05)
    fd.close()
    tracing.dump_trace()
    igg.finalize_global_grid()
    print(f"SOAK FRONTDOOR CHILD {outcome}", flush=True)
    return RESIZE_STATUS if outcome == "resize" else 0


def child_frontdoor_oracle(args) -> int:
    """The undisturbed fixed-topology oracle: every distinct request spec
    through a plain one-process `ServingLoop` (no HTTP, no resizes), each
    final field's digest dumped — the bit-identity reference of the
    frontdoor and fleet drills."""
    _torch(args)
    from ..models import diffusion3d
    from ..serving import Request, ServingLoop
    from ..serving.frontdoor import state_digest

    import implicitglobalgrid_tpu_torch as igg

    with open(args.specs) as f:
        specs = json.load(f)  # [[ic_scale, max_steps], ...]
    nxyz = (2 * args.nx - 2, args.nx, args.nx)
    dtype = _dtype(args)
    igg.init_global_grid(*nxyz, quiet=True, device=args.device)
    _, params = diffusion3d.setup(*nxyz, init_grid=False, dtype=dtype)
    loop = ServingLoop(diffusion3d, params, capacity=max(2, len(specs)),
                       steps_per_round=_round_steps(args), step_kwargs=_step_kwargs(args))
    members = {}
    for ic, ms in specs:
        state, _ = diffusion3d.setup(*nxyz, init_grid=False, ic_scale=ic, dtype=dtype)
        members[f"{ic}:{ms}"] = loop.submit(Request(state=state, max_steps=int(ms)))
    loop.run(max_rounds=10 * max(ms for _, ms in specs))
    digests = {}
    for key, m in members.items():
        res = loop.results[m]
        assert res.status == "completed", (key, res.status)
        digests[key] = state_digest(res.state)["fields"]
    with open(args.out, "w") as f:
        json.dump(digests, f)
    write_report(args.out)
    igg.finalize_global_grid()
    print("SOAK FRONTDOOR ORACLE OK", flush=True)
    return 0


def child_fleet_pool_main(args) -> int:
    """One fleet pool: a one-process `ServingLoop` behind its own
    `FrontDoor`, spawned, fenced and killed by the fleet controller.
    ``--round-sleep S`` makes every serving round S seconds slower inside
    the measured section, so the rolling ``serving.round_seconds`` p99
    honestly reports the slowness (the canary-rollback leg's bad config).
    Exits 0 on the broadcast shutdown; the controller's SIGKILL is the
    other way out."""
    _torch(args)
    from ..models import diffusion3d
    from ..serving import FrontDoor, ServingLoop
    from ..utils import tracing

    # the oracle child's grid: digest bit-identity is the point
    nxyz = (2 * args.nx - 2, args.nx, args.nx)
    igg = _bring_up(args, nxyz)
    dtype = _dtype(args)
    _, params = diffusion3d.setup(*nxyz, init_grid=False, dtype=dtype)
    loop = ServingLoop(diffusion3d, params, capacity=args.capacity,
                       steps_per_round=_round_steps(args), step_kwargs=_step_kwargs(args))
    if args.round_sleep > 0:
        step = loop._step

        def doctored(*state):
            time.sleep(args.round_sleep)
            return step(*state)

        loop._step = doctored
    # Periodic trace dumps: the chaos SIGKILL takes this process's span
    # ring with it, so the request-tree reconstruction reads the last
    # atomically published trace.g<gen>.p0.json instead.
    stop_dumper = threading.Event()

    def _trace_dumper():
        while not stop_dumper.wait(0.25):
            try:
                tracing.dump_trace()
            except Exception:  # noqa: BLE001 — a dump must never kill serving
                pass

    threading.Thread(target=_trace_dumper, name="igg-trace-dumper", daemon=True).start()
    fd = FrontDoor(loop, setup_kwargs={"dtype": dtype})
    outcome = fd.serve_rounds(idle_sleep=0.02)
    stop_dumper.set()
    tracing.dump_trace()  # final flush: the shutdown path's spans
    fd.close()
    if args.out:
        write_report(args.out, outcome=outcome)
    igg.finalize_global_grid()
    print(f"SOAK FLEET POOL {outcome}", flush=True)
    return 0
