#!/usr/bin/env python
"""Fault-injection soak of the port: diffusion3d under every IGG_FAULT_INJECT fault type.

The port's copy of the JAX package's ``scripts/soak.py``.  It orchestrates
child runs of the flagship model while cycling through the fault-injection
knobs and verifies that every fault is *recovered* — the final field of
each scenario must be bit-identical to a fault-free oracle.  Exits nonzero
on any unrecovered failure::

    python -m implicitglobalgrid_tpu_torch.scripts.soak --quick --device cpu
    python -m implicitglobalgrid_tpu_torch.scripts.soak baseline init_flake \\
        halo_corrupt worker_crash --device cuda --nx 256 --fused-k 4 --steps 16

Scenarios (``--list``), each the JAX scenario of the same name:

* ``baseline`` — no fault; produces the reference field (run before the
  three scenarios that are held against it).
* ``init_flake`` — the first 2 `init_distributed` attempts fail; the
  bounded retry (``IGG_INIT_RETRIES=3``) brings the one-rank process group
  up anyway, result == baseline.
* ``halo_corrupt`` — a NaN lands in the block mid-run; the guard trips and
  ``policy=rollback`` finishes bit-identical.
* ``worker_crash`` — the process hard-exits (status 17) right after a
  checkpoint; the restart against the same checkpoint directory resumes
  and finishes bit-identical.
* ``elastic_failover`` — a supervised 2-rank pair with
  ``worker_crash:stepM:proc1,ckpt_corrupt:stepM``: the supervisor
  relaunches on one rank, falls back past the corrupt generation,
  reshards, and matches the oracle in de-duplicated space; the per-rank
  event timeline, metrics dump, crash flight bundle and merged trace are
  verified too.
* ``serving`` — the batched-serving smoke: porous PT residual
  convergence, a NaN member evicted, late admission, the ``serving.*``
  event schema.
* ``live_plane`` — a 2-rank pair with ephemeral scrape servers; both
  ranks scraped mid-run, one `scripts.igg_top` view, a rank-tagged
  ``alert.step_stall`` from an injected stall.
* ``frontdoor`` — HTTP load through the front door, SLO 429s under a
  stall, elastic scale-up and down (``RESIZE_STATUS`` 19), digests equal
  to the oracle, ``frontdoor_soak.json``.
* ``chaos`` — a seeded storm (crash, stall, net_delay, ckpt_corrupt)
  through `supervisor.RunSupervisor`: restart, then shrink, the event
  order checked, the final field bit-identical.
* ``fleet`` — two pools behind one `fleet.FleetRouter`: one killed and its
  requests rerouted, then an SLO-gated canary promoted and a slow one
  rolled back.
* ``sdc`` — transport, state and checkpoint ``bit_flip``s, each caught by
  its own detector; quarantines, a lineage fallback, a clean leg with zero
  false positives.

``--quick`` runs ``elastic_failover``, ``serving``, ``live_plane``,
``frontdoor``, ``chaos``, ``fleet`` and ``sdc`` at small size (steps and
timeout capped as in JAX); positional scenario names compose with it.

Differences of representation from the JAX soak (ROADMAP Queue C): one
block per process (no ``--devices`` CPU mesh: a drill's topology is its
process count); ``--device`` (default ``cuda``: the children run on the
card unless asked for the CPU; CPU children run on one intra-op thread),
whose fields are float64 on the CPU (the JAX children's x64) and float32
on the card (the main path's); ``--fused-k K`` steps the single-process
scenarios through the Hopper kernels: the diffusion runs in groups of K
(``diffusion3d.run(fused_k=K)``; guard, checkpoint and fault steps count
in whole groups), the serving pools in rounds of K steps and the porous
pool's PT iterations in chunks of up to K — the 2-rank drills step one
step at a time (their faults are keyed to single steps).
``baseline`` may be named positionally.  Supervised children dump
``trace.g<gen>.p<rank>.json``, which the elastic check merges too; the
elastic drill holds its field bit for bit (JAX: within 1e-13).  A 2-rank
drill on ``cuda`` needs two cards (NCCL puts no two ranks on one device)
and raises with fewer: nothing moves to the CPU unasked.
``soak_summary.json`` in the work directory records each scenario's
verdict, wall seconds, saved fields' sha256 and children's kernel
launches; ``<out>.json`` beside each child's array holds its own.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULE = "implicitglobalgrid_tpu_torch.scripts.soak"

CRASH_STATUS = 17   # FaultInjector.CRASH_STATUS
RESIZE_STATUS = 19  # serving.frontdoor.RESIZE_STATUS
SCENARIOS = ("init_flake", "halo_corrupt", "worker_crash",
             "elastic_failover", "serving", "live_plane", "frontdoor",
             "chaos", "fleet", "sdc")
SCENARIO_DESCRIPTIONS = {
    "init_flake": "transient init failure -> bounded retry, result == baseline",
    "halo_corrupt": "injected halo corruption -> guard trip + checkpoint rollback",
    "worker_crash": "mid-run crash -> restart resumes from checkpoint, bit-identical",
    "elastic_failover": "supervised crash -> corrupt-generation fallback -> shrunk-topology restart",
    "serving": "batched serving loop smoke: mid-flight admit/retire, convergence masking",
    "live_plane": "mid-run endpoint scrape + stall alert through the live plane",
    "frontdoor": "HTTP load + stall backpressure + elastic scale-up/down, digests == oracle",
    "chaos": "seeded multi-fault storm through the self-healing supervisor",
    "fleet": "chaos-killed pool re-routed behind one door + SLO-gated canary rollout",
    "sdc": "bit-flip storm: every integrity detector trips, liars quarantined, "
           "poisoned generation skipped, clean leg pins zero false positives",
}
#: the scenarios whose drill runs a 2-rank pair (two cards on ``cuda``)
TWO_RANK = ("elastic_failover", "live_plane", "frontdoor", "chaos", "sdc")
#: the scenarios held against the shared ``baseline`` field
BASELINE_HELD = ("init_flake", "halo_corrupt", "worker_crash")
QUICK = ["elastic_failover", "serving", "live_plane", "frontdoor", "chaos", "fleet", "sdc"]


# ---------------------------------------------------------------------------
# shared by the orchestrator and the drills
# ---------------------------------------------------------------------------


class _Timeout:
    """Stand-in result for a child that outlived --timeout: nonzero rc plus
    whatever output the child produced, so the scenario reports FAIL with
    diagnostics instead of crashing the orchestrator."""

    returncode = -1

    def __init__(self, e: subprocess.TimeoutExpired):
        def text(v):
            return v.decode() if isinstance(v, bytes) else (v or "")

        self.stdout = text(e.stdout)
        self.stderr = text(e.stderr) + f"\n[soak] child timed out after {e.timeout}s and was killed"


def _run_child(cmd, env, timeout):
    try:
        return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return _Timeout(e)


def _report(name: str, ok: bool, detail: str = "") -> bool:
    print(f"[soak] {name:14s} {'PASS' if ok else 'FAIL'}  {detail}".rstrip(), flush=True)
    return ok


def _env(args, env_extra: dict | None = None) -> dict:
    """A child's environment: the caller's, no armed fault, the repo on
    ``PYTHONPATH``, one OpenMP thread on the CPU, then ``env_extra``."""
    env = dict(os.environ)
    for name in ("IGG_FAULT_INJECT", "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_PORT"):
        env.pop(name, None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    return env


def _child_cmd(args, mode: str, *extra) -> list:
    """``python -m ...soak --<mode>`` with the run's device, size and
    kernel group."""
    cmd = [sys.executable, "-m", MODULE, f"--{mode}", "--nx", str(args.nx),
           "--steps", str(args.steps), "--device", args.device, "--timeout", str(args.timeout)]
    if args.fused_k:
        cmd += ["--fused-k", str(args.fused_k)]
    return cmd + [str(x) for x in extra]


def _read_report(out: str) -> dict:
    try:
        with open(out + ".json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _launch_problem(args, reports, kernel: str) -> str | None:
    """On the card with ``--fused-k``, every report must show ``kernel``
    launched: the drill ran through the Hopper kernel, not around it."""
    if args.device != "cuda" or not args.fused_k:
        return None
    counts = [r.get("launches", {}).get(kernel, 0) for r in reports]
    if not counts or min(counts) <= 0:
        return f"{kernel} launches {counts}: the kernel did not run in every child"
    return None


def _launch_note(reports, kernel: str) -> str:
    return f"{kernel} launches {[r.get('launches', {}).get(kernel) for r in reports]}"


def _dump_output(proc) -> None:
    print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)


# ---------------------------------------------------------------------------
# event verifiers (the JAX soak's, on the port's event logs)
# ---------------------------------------------------------------------------


def _events(tele_dir: str):
    """``(events, files)`` of every ``events*.jsonl`` under ``tele_dir``."""
    import glob

    from ..utils.telemetry import read_events

    files = sorted(glob.glob(os.path.join(tele_dir, "events*.jsonl")))
    return [e for f in files for e in read_events(f)], files


def _tagged(events) -> bool:
    return all("rank" in e and isinstance(e.get("ts"), (int, float)) for e in events)


def _in_order(events, milestones, what: str):
    """``(ok, missing-message)``: the milestone predicates hold on events
    in this order (ts-sorted events)."""
    i = 0
    for name, pred in milestones:
        while i < len(events) and not pred(events[i]):
            i += 1
        if i >= len(events):
            seen = sorted({str(e.get("type")) for e in events})
            return False, f"{what} missing '{name}' (in order); saw {seen}"
        i += 1
    return True, ""


def _verify_serving_events(tele_dir: str) -> tuple[bool, str]:
    """The serving event schema: all four event types present, every one
    tagged with member/slot/tenant, and at least one admit AFTER the first
    retirement (the mid-flight slot reuse)."""
    events, files = _events(tele_dir)
    if not files:
        return False, f"no events*.jsonl under {tele_dir}"
    serving = [e for e in events if str(e.get("type", "")).startswith("serving.")]
    kinds = {e["type"] for e in serving}
    need = {"serving.admit", "serving.retire", "serving.converged", "serving.evict"}
    if not need <= kinds:
        return False, f"missing event type(s) {sorted(need - kinds)}"
    for e in serving:
        if any(k not in e for k in ("member", "slot", "tenant")):
            return False, f"event {e['type']} missing member/slot/tenant tags"
    serving.sort(key=lambda e: e["ts"])
    first_retire = next(i for i, e in enumerate(serving) if e["type"] != "serving.admit")
    if not any(e["type"] == "serving.admit" for e in serving[first_retire:]):
        return False, "no mid-flight admission (admit after a retirement)"
    return True, (
        f"{len(serving)} serving events: admit/retire/converged/evict all "
        f"present, mid-flight admission confirmed"
    )


def _verify_elastic_telemetry(tele_dir: str, got_out: str) -> tuple[bool, str]:
    """The elastic drill's machine-readable acceptance: crash, checkpoint
    fallback, elastic reshard and recovery IN ORDER on the per-rank event
    timeline; the restart's metrics dump valid JSON + Prometheus text with
    per-step T_eff; the crash's flight bundle; the merged span dumps a
    valid Chrome trace with the step and restore spans."""
    import glob

    from ..utils import tracing

    events, files = _events(tele_dir)
    if not files:
        return False, f"no events*.jsonl under {tele_dir}"
    if not _tagged(events):
        return False, "event lines missing rank/ts tags"
    events.sort(key=lambda e: e["ts"])
    ok, msg = _in_order(events, (
        ("crash", lambda e: e["type"] == "fault.worker_crash"),
        ("fallback", lambda e: e["type"] == "checkpoint.fallback"),
        ("reshard", lambda e: e["type"] == "checkpoint.restore" and e.get("mode") == "elastic"),
        ("recovery", lambda e: e["type"] == "run.complete"),
    ), "event timeline")
    if not ok:
        return False, msg
    ranks = {e["rank"] for e in events}
    if not {0, 1} <= ranks:
        return False, f"expected rank-tagged events from both ranks, got {ranks}"

    json_path, prom_path = got_out + ".metrics.json", got_out + ".metrics.prom"
    try:
        with open(json_path) as f:
            snap = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"metrics JSON unreadable ({e!r})"
    teff = snap.get("histograms", {}).get("diffusion3d.t_eff_gbs", {})
    if not teff.get("count"):
        return False, f"no per-step T_eff recorded in {json_path}"
    try:
        with open(prom_path) as f:
            prom = f.read()
    except OSError as e:
        return False, f"Prometheus dump unreadable ({e!r})"
    for line in prom.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(None, 1)
        if len(parts) != 2:
            return False, f"malformed Prometheus line {line!r}"
        try:
            float(parts[1])
        except ValueError:
            return False, f"non-numeric Prometheus sample {line!r}"
    if "igg_diffusion3d_t_eff_gbs" not in prom:
        return False, "T_eff summary missing from the Prometheus exposition"

    flight = os.path.join(tele_dir, tracing.flight_filename(1))
    if not os.path.isfile(flight):
        return False, f"no flight-recorder bundle {flight} from the crash"
    bundles = tracing.read_flight_bundles(flight)
    crash_bundles = [b for b in bundles if b.get("reason") == "fault.worker_crash"]
    if not crash_bundles:
        return False, (f"{flight}: no fault.worker_crash bundle "
                       f"(reasons: {[b.get('reason') for b in bundles]})")
    bundle = crash_bundles[-1]
    missing = [k for k in ("metrics", "config", "spans") if k not in bundle]
    if missing:
        return False, f"flight bundle missing section(s) {missing}"
    if bundle.get("rank") != 1:
        return False, f"flight bundle rank {bundle.get('rank')} != 1"

    # a supervised child's dump is generation-suffixed (`tracing.trace_filename`)
    tfiles = sorted(glob.glob(os.path.join(tele_dir, "trace.p*.json"))
                    + glob.glob(os.path.join(tele_dir, "trace.g*.p*.json")))
    if not tfiles:
        return False, f"no trace.p*.json / trace.g*.p*.json span dumps under {tele_dir}"
    try:
        doc = tracing.merge_trace_files(tfiles)
    except (OSError, ValueError) as e:
        return False, f"trace merge failed ({e!r})"
    problems = tracing.validate_chrome_trace(doc)
    if problems:
        return False, f"merged trace invalid: {problems[:3]}"
    span_names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    for need_span in ("igg.step", "igg.checkpoint.restore"):
        if need_span not in span_names:
            return False, f"merged trace lacks '{need_span}' spans (saw {sorted(span_names)})"
    return True, (
        f"{len(events)} events across {len(files)} rank file(s): "
        f"crash -> fallback -> elastic reshard -> recovery in order; "
        f"T_eff over {teff['count']} step(s); crash flight bundle ok; "
        f"merged trace valid ({len(span_names)} span name(s))"
    )


#: fault kinds the chaos drill samples (crash + stall + ckpt_corrupt + net_delay)
CHAOS_DRILL_KINDS = ("worker_crash", "stall", "net_delay", "ckpt_corrupt")
CHAOS_DRILL_RATE = 0.8


def _chaos_pick_seed(steps: int) -> tuple[int, list[str]]:
    """First seed whose deterministic `chaos_schedule` expansion is a
    qualifying storm: exactly TWO crashes (the restart-in-place leg AND
    the strikes-exhausted shrink leg), a stall and a net_delay, and ONE
    ckpt_corrupt at an even step >= 4 with the second crash at that step
    or the next — the newest generation is damaged when the shrunk
    incarnation reads the directory.  Deterministic in ``steps``."""
    from ..utils.resilience import chaos_schedule

    for seed in range(100000):
        specs = chaos_schedule(seed, CHAOS_DRILL_RATE, steps=steps, kinds=CHAOS_DRILL_KINDS)
        by_kind: dict[str, list[int]] = {}
        for s in specs:
            kind, step = s.split(":")
            by_kind.setdefault(kind, []).append(int(step[len("step"):]))
        crashes = sorted(by_kind.get("worker_crash", []))
        if len(crashes) != 2:
            continue
        if not by_kind.get("stall") or not by_kind.get("net_delay"):
            continue
        corrupts = by_kind.get("ckpt_corrupt", [])
        if len(corrupts) != 1 or corrupts[0] % 2 or corrupts[0] < 4:
            continue
        if not corrupts[0] <= crashes[1] <= corrupts[0] + 1:
            continue
        return seed, specs
    raise RuntimeError(
        f"no chaos seed under 100000 satisfies the storm predicate at steps={steps}"
    )


def _verify_chaos_events(tele_dir: str) -> tuple[bool, str]:
    """The chaos drill's acceptance: every storm kind fired, the wedged
    loop was caught live (``alert.step_stall``), and detect -> classify ->
    recover bracket both recovery legs IN ORDER on the merged timeline."""
    events, files = _events(tele_dir)
    if not files:
        return False, f"no events*.jsonl under {tele_dir}"
    if not _tagged(events):
        return False, "event lines missing rank/ts tags"
    events.sort(key=lambda e: e["ts"])
    types = [str(e.get("type")) for e in events]
    missing_kinds = [k for k in CHAOS_DRILL_KINDS if f"fault.{k}" not in types]
    if missing_kinds:
        return False, f"storm kind(s) never fired: {missing_kinds}"
    if "alert.step_stall" not in types:
        return False, ("the injected stall never surfaced as a live alert.step_stall "
                       "(scrape-time rule) on any rank")
    ok, msg = _in_order(events, (
        ("crash #1", lambda e: e["type"] == "fault.worker_crash"),
        ("detect #1", lambda e: e["type"] == "supervisor.detect"),
        ("classify #1", lambda e: e["type"] == "supervisor.classify"),
        ("recover/restart", lambda e: e["type"] == "supervisor.recover"
         and e.get("action") == "restart"),
        ("crash #2", lambda e: e["type"] == "fault.worker_crash"),
        ("detect #2", lambda e: e["type"] == "supervisor.detect"),
        ("classify #2", lambda e: e["type"] == "supervisor.classify"),
        ("recover/shrink", lambda e: e["type"] == "supervisor.recover"
         and e.get("action") == "shrink"),
        ("elastic reshard", lambda e: e["type"] == "checkpoint.restore"
         and e.get("mode") == "elastic"),
        ("recovery", lambda e: e["type"] == "run.complete"),
    ), "chaos timeline")
    if not ok:
        return False, msg
    fallbacks = types.count("checkpoint.fallback")
    gens = sorted({e.get("gen") for e in events if e.get("gen") is not None})
    return True, (
        f"{len(events)} events across {len(files)} file(s): all "
        f"{len(CHAOS_DRILL_KINDS)} storm kinds fired, stall caught live, "
        f"detect->classify->recover in order through restart AND shrink, "
        f"{fallbacks} integrity fallback(s), generations {gens}"
    )


def _verify_sdc_events(tele_dir: str) -> tuple[bool, str]:
    """The sdc drill's acceptance: each bit_flip placement surfaced through
    exactly its intended detector, in order — the transport trip (emitted
    by the RECEIVER, implicating the sender), the shadow-audit trip, the
    lineage fallback past the poisoned generation — and the recovered run
    completed."""
    events, files = _events(tele_dir)
    if not files:
        return False, f"no events*.jsonl under {tele_dir}"
    if not _tagged(events):
        return False, "event lines missing rank/ts tags"
    events.sort(key=lambda e: e["ts"])
    placements = sorted({str(e.get("placement")) for e in events
                         if e["type"] == "fault.bit_flip"})
    if placements != ["ckpt", "state", "transport"]:
        return False, f"expected all three bit_flip placements, saw {placements}"
    transport = [e for e in events if e["type"] == "integrity.transport_mismatch"]
    if not transport:
        return False, "the transport flip never tripped a receiver checksum"
    if any(e.get("implicated_rank") != 0 for e in transport):
        return False, (
            f"transport trip implicated "
            f"{sorted({e.get('implicated_rank') for e in transport})}, "
            f"expected the armed sender rank 0"
        )
    if all(e.get("rank") != 1 for e in transport):
        return False, "no transport trip was emitted by the RECEIVER rank 1"
    ok, msg = _in_order(events, (
        ("transport trip", lambda e: e["type"] == "integrity.transport_mismatch"),
        ("quarantine #1", lambda e: e["type"] == "supervisor.recover"
         and e.get("action") == "quarantine"),
        ("audit trip", lambda e: e["type"] == "integrity.audit_mismatch"),
        ("quarantine #2", lambda e: e["type"] == "supervisor.recover"
         and e.get("action") == "quarantine"),
        ("ckpt flip", lambda e: e["type"] == "fault.bit_flip" and e.get("placement") == "ckpt"),
        ("crash", lambda e: e["type"] == "fault.worker_crash"),
        ("lineage fallback", lambda e: e["type"] == "checkpoint.fallback"),
        ("recovery", lambda e: e["type"] == "run.complete"),
    ), "sdc timeline")
    if not ok:
        return False, msg
    return True, (
        f"{len(events)} events across {len(files)} file(s): transport trip "
        f"(receiver rank 1 implicating sender rank 0) -> quarantine -> "
        f"audit trip -> quarantine -> poisoned generation skipped by "
        f"lineage fallback -> recovery"
    )


# ---------------------------------------------------------------------------
# orchestrator: the single-process scenarios and the serving smoke
# ---------------------------------------------------------------------------


def require_cards(args) -> None:
    """Refuse, before anything runs, a card run this machine cannot hold:
    no CUDA device, or a 2-rank drill with fewer cards than ranks (NCCL
    puts no two ranks on one device).  Nothing moves to the CPU unasked."""
    if args.device != "cuda":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "soak --device cuda: no CUDA device is available; the soak's children "
            "run on the card unless --device cpu asks for the CPU."
        )
    pairs = [s for s in args.scenarios if s in TWO_RANK]
    if pairs and torch.cuda.device_count() < 2:
        raise RuntimeError(
            f"soak --device cuda: the 2-rank drill(s) {pairs} need two CUDA cards "
            f"(one rank per card: NCCL puts no two ranks on one device), and this "
            f"machine has {torch.cuda.device_count()}. Run them on two or more "
            f"cards, or on the CPU with --device cpu."
        )


def _spawn_child(args, scenario: str, env_extra: dict, *, ckpt: str | None = None):
    out = os.path.join(args.workdir, f"{scenario}.npy")
    # the child's events and span dump (`scripts.igg_trace` merges them)
    tele_dir = os.path.join(args.workdir, f"telemetry_{scenario}")
    if ckpt is None:
        ckpt = os.path.join(args.workdir, f"ckpt_{scenario}")
        # a fresh scenario must not resume from a previous soak's
        # checkpoints; the worker_crash restart passes its dir explicitly
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(tele_dir, ignore_errors=True)
    env_extra = {"IGG_TELEMETRY_DIR": tele_dir, **env_extra}
    extra = ["--ckpt-dir", ckpt, "--out", out]
    if env_extra.pop("_distributed", None):
        extra += ["--distributed", "--port", "0"]
    proc = _run_child(_child_cmd(args, "child", *extra), _env(args, env_extra), args.timeout)
    return proc, out, ckpt


def _same(out: str, baseline) -> bool:
    import numpy as np

    try:
        return bool(np.array_equal(np.load(out), baseline))
    except (OSError, ValueError):
        return False


def _group(args) -> int:
    return args.fused_k or 1


def _single(args, scenario: str, baseline, rec: dict) -> bool:
    """init_flake, halo_corrupt or worker_crash, held bit for bit against
    the baseline field; fills ``rec`` (sha256, launches, crash timing)."""
    g = _group(args)
    kernel = "fused_diffusion_steps"
    proc0 = None  # worker_crash's crashed child
    reports = []
    if scenario == "init_flake":
        what, marker = "", None
        env = {"IGG_FAULT_INJECT": "init_flake:2", "IGG_INIT_RETRIES": "3",
               "IGG_INIT_BACKOFF_S": "0.05", "_distributed": "1"}
        proc, out, _ = _spawn_child(args, scenario, env)
    elif scenario == "halo_corrupt":
        what, marker = " (guard tripped + rollback)", "rolling back"
        mid = max(g, (args.steps // 2) // g * g)
        proc, out, _ = _spawn_child(args, scenario, {"IGG_FAULT_INJECT": f"halo_corrupt:step{mid}"})
    else:  # worker_crash, at a checkpointed step (checkpoints every two groups)
        mid = max(2 * g, (args.steps // 2) // (2 * g) * (2 * g))
        proc0, out, ckpt = _spawn_child(args, scenario,
                                        {"IGG_FAULT_INJECT": f"worker_crash:step{mid}:proc0"})
        if proc0.returncode != CRASH_STATUS:
            _dump_output(proc0)
            return _report(scenario, False,
                           f"expected crash rc={CRASH_STATUS}, got {proc0.returncode}")
        reports.append(_read_report(out))  # written on the way out of the crash
        os.remove(out + ".json")
        proc, out, _ = _spawn_child(args, scenario, {}, ckpt=ckpt)
        crash_to_done = time.time() - reports[0].get("ts", float("nan"))
        rec.update(crash_step=mid, crash_to_done_s=crash_to_done)
        what = (f"crash rc={proc0.returncode} -> restart rc={proc.returncode}; crash to done "
                f"{crash_to_done!r} s")
        marker = "resumed from checkpoint"
    reports.append(_read_report(out))
    rec.update(sha256=reports[-1].get("sha256"), launches=[r.get("launches") for r in reports])
    problem = _launch_problem(args, reports, kernel)
    ok = (proc.returncode == 0 and (marker is None or marker in proc.stdout + proc.stderr)
          and _same(out, baseline) and problem is None)
    if proc0 is None:
        what = f"rc={proc.returncode}{what}"
    if not _report(scenario, ok, f"{what}; {problem or _launch_note(reports, kernel)}"):
        _dump_output(proc)
        return False
    return True


def _serving(args, rec: dict) -> bool:
    """The serving smoke's child, then its event schema (and, on the card
    with ``--fused-k``, its PT kernel launches)."""
    tele_dir = os.path.join(args.workdir, "telemetry_serving")
    shutil.rmtree(tele_dir, ignore_errors=True)
    out = os.path.join(args.workdir, "serving")
    env = _env(args, {"IGG_TELEMETRY": "1", "IGG_TELEMETRY_DIR": tele_dir})
    proc = _run_child(_child_cmd(args, "serving-child", "--out", out), env, args.timeout)
    ok = proc.returncode == 0
    detail = f"rc={proc.returncode}"
    reports = [_read_report(out)]
    rec.update(launches=[r.get("launches") for r in reports], rounds=reports[0].get("rounds"))
    if ok:
        ok, detail = _verify_serving_events(tele_dir)
    if ok:
        problem = _launch_problem(args, reports, "fused_pt_iterations")
        ok = problem is None
        detail += f"; {problem or _launch_note(reports, 'fused_pt_iterations')}"
    if not _report("serving", ok, detail):
        _dump_output(proc)
        return False
    return True


def orchestrate(args) -> int:
    import numpy as np

    from . import _soak_drills as drills

    require_cards(args)
    os.makedirs(args.workdir, exist_ok=True)
    failures = 0
    summary: dict = {}
    drill = {
        "elastic_failover": drills.supervise_elastic_failover,
        "live_plane": drills.supervise_live_plane,
        "frontdoor": drills.supervise_frontdoor,
        "chaos": drills.supervise_chaos,
        "fleet": drills.supervise_fleet,
        "sdc": drills.supervise_sdc,
    }

    # the shared baseline, only for the scenarios held against it
    baseline = None
    if any(s in BASELINE_HELD or s == "baseline" for s in args.scenarios):
        t0 = time.perf_counter()
        proc, base_out, _ = _spawn_child(args, "baseline", {})
        reports = [_read_report(base_out)]
        problem = _launch_problem(args, reports, "fused_diffusion_steps")
        summary["baseline"] = {"ok": proc.returncode == 0 and problem is None,
                               "seconds": time.perf_counter() - t0,
                               "sha256": reports[0].get("sha256"),
                               "launches": [r.get("launches") for r in reports]}
        if proc.returncode != 0 or problem:
            _dump_output(proc)
            _report("baseline", False, f"rc={proc.returncode}; {problem}")
            _write_summary(args, summary)
            return 1
        baseline = np.load(base_out)
        _report("baseline", True, f"steps={args.steps} nx={args.nx}; "
                                  f"{_launch_note(reports, 'fused_diffusion_steps')}")

    for scenario in args.scenarios:
        if scenario == "baseline":
            continue
        t0 = time.perf_counter()
        summary[scenario] = {}
        if scenario in drill:
            ok = drill[scenario](args, summary[scenario])
        elif scenario == "serving":
            ok = _serving(args, summary[scenario])
        else:
            ok = _single(args, scenario, baseline, summary[scenario])
        summary[scenario].update(ok=bool(ok), seconds=time.perf_counter() - t0)
        failures += not ok

    _write_summary(args, summary)
    print(f"[soak] {'ALL RECOVERED' if failures == 0 else f'{failures} UNRECOVERED FAILURE(S)'}")
    return 1 if failures else 0


def _write_summary(args, summary: dict) -> None:
    doc = {"device": args.device, "dtype": "float64" if args.device == "cpu" else "float32",
           "nx": args.nx, "steps": args.steps, "fused_k": args.fused_k, "scenarios": summary}
    with open(os.path.join(args.workdir, "soak_summary.json"), "w") as f:
        json.dump(doc, f, indent=1, default=str)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    from . import _soak_children as children

    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}",
                                 description=__doc__.split("\n")[0])
    ap.add_argument(
        "scenario", nargs="*", choices=[[], "baseline", *SCENARIOS],
        help="scenario(s) to run positionally (e.g. `soak chaos --quick`); "
        "default: --scenarios (or every scenario)",
    )
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".soak_torch"))
    ap.add_argument("--scenarios", nargs="+", default=list(SCENARIOS),
                    choices=["baseline", *SCENARIOS])
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the children run (default: the card)")
    ap.add_argument("--fused-k", type=int, default=0, metavar="K",
                    help="step the diffusion runs in kernel groups of K "
                    "(diffusion3d.run(fused_k=K)) and the porous pool's PT "
                    "iterations through the PT kernel")
    ap.add_argument(
        "--quick", action="store_true",
        help="fast smoke path: the elastic_failover, serving, live_plane, "
        "frontdoor, chaos, fleet and sdc drills at small size",
    )
    ap.add_argument("--list", action="store_true",
                    help="list every scenario with a one-line description and exit")
    # child-mode flags
    for flag in ("child", "elastic-child", "sdc-child", "serving-child", "live-child",
                 "frontdoor-child", "frontdoor-oracle", "fleet-pool-child"):
        ap.add_argument(f"--{flag}", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--round-sleep", type=float, default=0.0, help=argparse.SUPPRESS)
    ap.add_argument("--capacity", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--rung", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--resume", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--ladder", default="1:2,2:4", help=argparse.SUPPRESS)
    ap.add_argument("--specs", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--pair-id", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--expect-resume-step", type=int, default=-1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.list:
        for name in SCENARIOS:
            print(f"{name:<18} {SCENARIO_DESCRIPTIONS[name]}")
        return 0
    modes = {
        "elastic_child": children.child_elastic_main,
        "sdc_child": children.child_sdc_main,
        "serving_child": children.child_serving_main,
        "live_child": children.child_live_main,
        "frontdoor_child": children.child_frontdoor_main,
        "frontdoor_oracle": children.child_frontdoor_oracle,
        "fleet_pool_child": children.child_fleet_pool_main,
        "child": children.child_main,
    }
    for mode, fn in modes.items():
        if getattr(args, mode):
            return fn(args)
    if args.scenario:
        # positional selection wins (and composes with --quick's sizing)
        args.scenarios = list(args.scenario)
        if args.quick:
            args.steps = min(args.steps, 6)
            args.timeout = min(args.timeout, 300)
    elif args.quick:
        args.scenarios = list(QUICK)
        args.steps = min(args.steps, 6)
        args.timeout = min(args.timeout, 300)
    if args.fused_k and (args.fused_k < 2 or args.fused_k % 2 or args.steps % args.fused_k):
        ap.error(f"--fused-k {args.fused_k}: the kernel steps in even groups >= 2 "
                 f"that must divide --steps {args.steps}")
    args.workdir = os.path.abspath(args.workdir)
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
