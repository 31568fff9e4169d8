"""Resilience layer: guarded bring-up, numerical guards, fault injection.

The port's counterpart of the JAX package's ``utils/resilience.py``, with
the same names, messages and seeded draws:

* **Guarded bring-up** — `retry_call` / `backoff_schedule` give
  `parallel.distributed.init_distributed` configurable retry with
  exponential backoff + seeded jitter and an overall deadline
  (``IGG_INIT_RETRIES`` / ``IGG_INIT_TIMEOUT_S`` / ``IGG_INIT_BACKOFF_S``);
  `watchdog` dumps all-thread stacks when a collective hangs.
* **Numerical guards** — `check_fields` reduces each field to a finite
  flag per rank, all-reduces the flags as a ``(nfields, *dims)`` one-hot
  and reports the offending *block coordinates*; `RunGuard` applies the
  ``raise`` | ``warn`` | ``rollback`` policy inside the models' time loops
  (``guard_every=N``).
* **Fault injection** — `FaultInjector` parses ``IGG_FAULT_INJECT``
  (``init_flake:N``, ``halo_corrupt:stepN[:blockB]``,
  ``worker_crash:stepN[:procP]``, ``stall:stepN[:procP]``,
  ``net_delay:stepN[:procP]``, ``ckpt_corrupt:stepN[:shardS]``,
  ``ckpt_truncate:stepN[:shardS]``,
  ``bit_flip:stepN[:field|transport|ckpt][:procP]``); several compose
  comma-separated via `FaultSet`, and
  ``chaos:seed=N:rate=R[:steps=M][:kinds=a+b]`` expands into the same
  deterministic storm as in the JAX package (`chaos_schedule`).

One process drives one block here, so where the JAX package writes a NaN
or flips a bit at a global index on every process, the port does it on the
target block's rank only; every rank still takes the same decisions.
Checkpoint/restart lives in `utils.checkpoint`; `RunGuard` drives it.
`guarded_time_loop` records the step telemetry (`utils.telemetry.step_loop`)
and the ``igg.step`` spans, a critical live-plane alert escalates into the
guard (`RunGuard.on_alert`), and a guard trip, an audit mismatch, a blown
watchdog deadline or an injected crash leaves a flight-recorder bundle
(`utils.tracing.dump_flight_recorder`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import os
import random
import sys
import time
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import distributed as _dist
from ..parallel import grid as _grid
from ..parallel.topology import NDIMS
from . import config as _config
from . import profiling as _profiling
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = [
    "GuardError",
    "FieldReport",
    "RunGuard",
    "FaultInjector",
    "FaultSet",
    "backoff_schedule",
    "retry_call",
    "watchdog",
    "check_fields",
    "get_fault_injector",
    "reset_fault_injector",
    "snapshot_state",
    "chaos_schedule",
    "expand_fault_spec",
    "fault_event_matches_spec",
    "guarded_time_loop",
]

# -- Guarded bring-up ---------------------------------------------------------

#: Built-in defaults of the init retry tier (kwarg > ``IGG_*`` env > these).
DEFAULT_INIT_RETRIES = 3
DEFAULT_INIT_TIMEOUT_S = 600.0
DEFAULT_INIT_BACKOFF_S = 1.0
_BACKOFF_CAP_S = 30.0


def backoff_schedule(
    retries: int,
    *,
    base_s: float = DEFAULT_INIT_BACKOFF_S,
    cap_s: float = _BACKOFF_CAP_S,
    jitter: float = 0.5,
    seed: int | None = None,
) -> list[float]:
    """Exponential backoff delays for ``retries`` re-attempts.

    Delay ``i`` is ``min(base * 2**i, cap)`` stretched by a uniform jitter in
    ``[1, 1 + jitter]`` — jitter de-synchronizes thousands of workers
    hammering a rendezvous after a correlated failure, and seeding it makes
    schedules reproducible in tests.  ``seed`` defaults to this process's
    rank; during bring-up `init_distributed` passes ``RANK`` through.
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0 (got {retries})")
    if base_s <= 0 or cap_s <= 0:
        raise ValueError(f"base_s and cap_s must be > 0 (got {base_s}, {cap_s})")
    if jitter < 0:
        raise ValueError(f"jitter must be >= 0 (got {jitter})")
    if seed is None:
        seed = _safe_process_index()
    rng = random.Random(seed)
    return [
        min(base_s * (2.0**i), cap_s) * (1.0 + rng.uniform(0.0, jitter))
        for i in range(retries)
    ]


def _safe_process_index() -> int:
    """Process rank, 0 without a process group."""
    return _dist.process_index()


def retry_call(
    fn: Callable[[], Any],
    *,
    retries: int = DEFAULT_INIT_RETRIES,
    timeout_s: float | None = DEFAULT_INIT_TIMEOUT_S,
    base_backoff_s: float = DEFAULT_INIT_BACKOFF_S,
    jitter: float = 0.5,
    seed: int | None = None,
    describe: str = "operation",
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Call ``fn`` with up to ``retries`` re-attempts under a deadline.

    ``timeout_s`` is an *overall* deadline across attempts: a retry whose
    backoff would cross it is not taken (a hang inside one attempt cannot be
    interrupted from Python — arm `watchdog` for that).  ``on_retry(attempt,
    error, delay)`` observes each failure; the default logs to stderr.
    Raises the last error, annotated with the attempt count and deadline.
    """
    if timeout_s is not None and timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0 (got {timeout_s})")
    delays = backoff_schedule(
        retries, base_s=base_backoff_s, jitter=jitter, seed=seed
    )
    t0 = clock()
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            # Deliberate shutdown is not a flaky bring-up: never retry it.
            raise
        except BaseException as e:
            last = e
            if attempt >= retries:
                break
            delay = delays[attempt]
            elapsed = clock() - t0
            if timeout_s is not None and elapsed + delay > timeout_s:
                raise RuntimeError(
                    f"{describe} failed after {attempt + 1} attempt(s) in "
                    f"{elapsed:.1f}s; the overall deadline "
                    f"(timeout_s={timeout_s}, IGG_INIT_TIMEOUT_S) leaves no "
                    f"room for another retry. Last error: {e!r}"
                ) from e
            _telemetry.event(
                "retry",
                what=describe,
                attempt=attempt + 1,
                of=retries + 1,
                delay_s=delay,
                error=repr(e),
            )
            _telemetry.counter("resilience.retries").inc()
            if on_retry is not None:
                on_retry(attempt, e, delay)
            else:
                print(
                    f"[igg.resilience] {describe} attempt {attempt + 1}/"
                    f"{retries + 1} failed ({e!r}); retrying in {delay:.2f}s",
                    file=sys.stderr,
                    flush=True,
                )
            sleep(delay)
    raise RuntimeError(
        f"{describe} failed after {retries + 1} attempt(s) "
        f"(retries={retries}, IGG_INIT_RETRIES). Last error: {last!r}"
    ) from last


# faulthandler keeps ONE process-wide timer; this stack makes nested
# watchdogs strictest-wins: arming/exiting re-arms with the SMALLEST timeout
# on the stack and the OR of the exit flags, so an inner watchdog with a
# laxer deadline can never weaken the enclosing one.  Each re-arm restarts
# the timer, so an outer deadline can extend by at most one inner scope's
# duration.
_watchdog_stack: list[tuple[float, bool, Any]] = []


def arm_watchdog(timeout_s: float, *, exit: bool = False, file=None) -> None:
    """Arm the stack-dump watchdog for the remaining process lifetime.

    For linear scripts (test workers) where a ``with`` block is awkward;
    pair with `disarm_watchdog` or let it ride until process exit.
    """
    _watchdog_stack.append((float(timeout_s), exit, file))
    _rearm()


def disarm_watchdog() -> None:
    _watchdog_stack.pop() if _watchdog_stack else None
    _rearm()


def _rearm() -> None:
    if not _watchdog_stack:
        faulthandler.cancel_dump_traceback_later()
        return
    # The entry whose deadline will actually fire supplies the dump stream.
    timeout_s, _, file = min(_watchdog_stack, key=lambda e: e[0])
    kwargs = {"exit": any(e for _, e, _ in _watchdog_stack)}
    if file is not None:
        kwargs["file"] = file
    faulthandler.dump_traceback_later(timeout_s, **kwargs)


@contextlib.contextmanager
def watchdog(timeout_s: float | None, *, exit: bool = False, file=None):
    """Dump all-thread stack traces if the enclosed block runs past ``timeout_s``.

    The collective-hang debugging tool: a deadlocked collective (one
    process missing from it) blocks in C++ where Python sees nothing —
    `faulthandler.dump_traceback_later` fires from a watchdog thread and
    shows every thread's stack, and ``exit=True`` also kills the process so
    an orchestrator can restart it.  ``timeout_s=None``/0
    disarms (the ``IGG_WATCHDOG_S``-unset path).  faulthandler keeps one
    process-wide timer, so nesting is strictest-wins: the smallest timeout
    on the watchdog stack is armed and ``exit`` flags OR together — an
    inner watchdog can tighten but never weaken an enclosing one.
    """
    if not timeout_s:
        yield
        return
    arm_watchdog(timeout_s, exit=exit, file=file)
    t0 = time.monotonic()
    try:
        yield
    finally:
        disarm_watchdog()
        elapsed = time.monotonic() - t0
        if elapsed > timeout_s:
            # The block outlived this watchdog's deadline: the closest
            # observable proxy for "the dump fired" (the stderr dump is the
            # ground truth, this event the timeline marker), with this
            # rank's span ring, metrics and config in a flight bundle.
            _telemetry.event(
                "watchdog.deadline_exceeded",
                timeout_s=timeout_s,
                elapsed_s=elapsed,
            )
            _telemetry.counter("resilience.watchdog_deadline_exceeded").inc()
            _tracing.dump_flight_recorder(
                "watchdog.deadline_exceeded", timeout_s=timeout_s, elapsed_s=elapsed,
            )


# -- Numerical guards ---------------------------------------------------------


class GuardError(RuntimeError):
    """A NaN/Inf guard tripped.  Carries the step and the offending blocks."""

    def __init__(self, message: str, *, step: int | None = None, report=None):
        super().__init__(message)
        self.step = step
        self.report = report


@dataclasses.dataclass(frozen=True)
class FieldReport:
    """Result of one `check_fields` probe.

    ``bad_blocks`` maps field name -> tuple of block ``coords`` (Cartesian
    process coordinates, the reference's ``coords``) holding at least one
    non-finite value.  Replicated across processes: every rank sees the
    same report and can take the same policy action.
    """

    names: tuple[str, ...]
    bad_blocks: dict[str, tuple[tuple[int, ...], ...]]

    @property
    def ok(self) -> bool:
        return not self.bad_blocks

    def summary(self) -> str:
        if self.ok:
            return f"all finite ({', '.join(self.names)})"
        parts = [
            f"{name}: block(s) {', '.join(str(c) for c in coords)}"
            for name, coords in self.bad_blocks.items()
        ]
        return "non-finite values in " + "; ".join(parts)


def _block_flags_report(fields, flags, names) -> dict:
    """All-reduce per-field block flags into ``{name: bad block coords}``.

    ``flags`` holds one 0-d tensor per field (nonzero = bad) on the fields'
    device.  Each rank writes its flags into a ``(nfields, *dims)`` int32
    one-hot at its block coordinates and the ranks sum it (`dist.all_reduce`,
    on the card under NCCL), so every rank reads the same report — the JAX
    package's ``psum``.  A field of lower rank than the grid clamps its
    missing coordinates to 0, so the ranks that hold copies of one block
    report it once; a batched field ``(B, *block)`` reports the block.  The
    one read of the result is the probe's only host synchronization.
    """
    gg = _grid.global_grid()
    onehot = torch.zeros((len(flags), *gg.dims), dtype=torch.int32, device=fields[0].device)
    for i, (A, flag) in enumerate(zip(fields, flags)):
        nd = min(A.dim(), NDIMS)
        c = tuple(gg.coords[d] if d < nd and gg.dims[d] > 1 else 0 for d in range(NDIMS))
        onehot[(i, *c)] = flag.to(device=onehot.device, dtype=torch.int32)
    if _dist.process_count() > 1:
        dist.all_reduce(onehot)
    host = onehot.cpu().numpy()
    bad: dict[str, tuple[tuple[int, ...], ...]] = {}
    for i, name in enumerate(names):
        coords = tuple(tuple(int(c) for c in idx) for idx in np.argwhere(host[i]))
        if coords:
            bad[name] = coords
    return bad


def _field_names(names, n: int) -> tuple[str, ...]:
    """The report's field names: ``names``, or ``field0``, ``field1``, ..."""
    if names is None:
        return tuple(f"field{i}" for i in range(n))
    names = tuple(names)
    if len(names) != n:
        raise ValueError(f"names has {len(names)} entries for {n} fields.")
    return names


def nonfinite_flags(A, *, per_member: bool = False):
    """Bool tensor: ``A`` holds a NaN or an Inf; 0-d, or with
    ``per_member`` one flag per index of the leading (ensemble) axis.

    One read of ``A``: a set of values is finite exactly when its minimum
    and maximum are (NaN propagates through both, +Inf is the maximum,
    -Inf the minimum), so one `torch.aminmax` pass decides it and no mask
    the size of the field is written.  Integer and bool fields, which
    cannot hold either, are never flagged."""
    shape = (A.shape[0],) if per_member else ()
    if A.is_complex():
        A = torch.view_as_real(A)
    if not A.is_floating_point() or A.numel() == 0:
        return torch.zeros(shape, dtype=torch.bool, device=A.device)
    lo, hi = torch.aminmax(A.flatten(1), dim=1) if per_member else torch.aminmax(A)
    return ~(torch.isfinite(lo) & torch.isfinite(hi))


def check_fields(*fields, names: Sequence[str] | None = None) -> FieldReport:
    """Probe field(s) for NaN/Inf; report the offending blocks.

    The numerical-guard API (`igg.check_fields`): each rank reduces every
    field of its block to one finite flag on the device, and the ranks
    all-reduce the flags (`_block_flags_report`).  Returns a `FieldReport`
    whose ``bad_blocks`` names the Cartesian ``coords`` of every block
    holding a non-finite value.  Collective: every rank calls it, and
    every rank sees the same report, so the ``rollback`` policy cannot
    diverge across ranks.
    """
    _grid.check_initialized()
    if not fields:
        raise ValueError("check_fields requires at least one field.")
    names = _field_names(names, len(fields))
    flags = [nonfinite_flags(A) for A in fields]
    return FieldReport(names=names, bad_blocks=_block_flags_report(fields, flags, names))


# -- Fault injection ----------------------------------------------------------

FAULT_KINDS = (
    "init_flake",
    "halo_corrupt",
    "worker_crash",
    "stall",
    "net_delay",
    "ckpt_corrupt",
    "ckpt_truncate",
    "bit_flip",
)

#: third spec component's prefix per fault kind (e.g. ``halo_corrupt:step3:block5``)
_TARGET_PREFIX = {
    "halo_corrupt": "block",
    "worker_crash": "proc",
    "stall": "proc",
    "net_delay": "proc",
    "ckpt_corrupt": "shard",
    "ckpt_truncate": "shard",
    "bit_flip": "proc",
}

#: ``bit_flip``'s reserved (non-field-name) placement components
BIT_FLIP_PLACEMENTS = ("transport", "ckpt")

#: kinds the seeded chaos schedule samples from by default (init_flake
#: excluded: it fires during bring-up, outside the per-step storm the
#: schedule models; bit_flip excluded from the DEFAULT draw because it is
#: guard-invisible — a storm that lands one in a run without the integrity
#: plane armed silently falsifies the result instead of exercising recovery.
#: ``kinds=…+bit_flip`` opts a storm in explicitly when ``IGG_INTEGRITY``
#: detectors are armed.)
CHAOS_KINDS = (
    "worker_crash",
    "stall",
    "net_delay",
    "ckpt_corrupt",
    "ckpt_truncate",
    "halo_corrupt",
)

#: chaos-mode defaults (spec grammar: ``chaos:seed=N:rate=R[:steps=M][:kinds=a+b]``)
CHAOS_STEPS_DEFAULT = 16


def chaos_schedule(
    seed: int,
    rate: float,
    *,
    steps: int = CHAOS_STEPS_DEFAULT,
    kinds: Sequence[str] = CHAOS_KINDS,
) -> list[str]:
    """The deterministic randomized fault storm of one chaos spec.

    Samples at most ONE fault per time-loop step (unambiguous
    ``(kind, step)`` identity — what lets a supervisor match ``fault.*``
    events back to the armed schedule and prune fired faults across
    relaunches): for each step ``1..steps``, with probability ``rate`` a
    kind is drawn uniformly from ``kinds``.  Pure function of its
    arguments (`random.Random(seed)`), so a supervisor, a soak run
    and a test all derive the identical storm from the spec alone.
    Targets stay at each kind's default (crash/stall/delay: the last
    process; ckpt damage: shard 0; corruption: block 0).
    """
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"chaos rate must be in [0, 1] (got {rate})")
    if steps < 1:
        raise ValueError(f"chaos steps must be >= 1 (got {steps})")
    bad = [k for k in kinds if k not in FAULT_KINDS or k == "init_flake"]
    if bad:
        raise ValueError(
            f"chaos kinds {bad} not samplable; choose from {CHAOS_KINDS}"
        )
    rng = random.Random(seed)
    out = []
    for step in range(1, steps + 1):
        if rng.random() < rate:
            out.append(f"{rng.choice(list(kinds))}:step{step}")
    return out


def _parse_chaos_spec(spec: str) -> list[str]:
    """``chaos:seed=N:rate=R[:steps=M][:kinds=a+b]`` -> concrete specs."""
    fields: dict[str, str] = {}
    for part in spec.split(":")[1:]:
        key, sep, val = part.partition("=")
        if not sep or key not in ("seed", "rate", "steps", "kinds"):
            raise ValueError(
                f"IGG_FAULT_INJECT: {spec!r} — chaos takes "
                f"'chaos:seed=N:rate=R[:steps=M][:kinds=a+b]' "
                f"(got component {part!r})."
            )
        fields[key] = val
    try:
        seed = int(fields["seed"])
        rate = float(fields["rate"])
        steps = int(fields.get("steps", CHAOS_STEPS_DEFAULT))
    except (KeyError, ValueError):
        raise ValueError(
            f"IGG_FAULT_INJECT: {spec!r} — chaos needs integer seed=, "
            f"decimal rate= (and optional integer steps=)."
        )
    kinds = (
        tuple(fields["kinds"].split("+")) if "kinds" in fields else CHAOS_KINDS
    )
    return chaos_schedule(seed, rate, steps=steps, kinds=kinds)


def expand_fault_spec(spec: str | None) -> list[str]:
    """A comma-separated ``IGG_FAULT_INJECT`` value as CONCRETE per-fault
    specs, ``chaos:`` parts expanded through `chaos_schedule` — the form a
    supervisor arms, prunes (`fault_event_matches_spec`) and re-arms."""
    if not spec:
        return []
    out: list[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("chaos:") or part == "chaos":
            out.extend(_parse_chaos_spec(part))
        else:
            FaultInjector.from_spec(part)  # validate eagerly
            out.append(part)
    return out


def fault_event_matches_spec(events: Sequence[dict], spec: str) -> bool:
    """Did one of these ``fault.*`` event records fire THIS concrete spec?

    The supervisor's cross-incarnation fire-once hygiene: a fault whose
    event is on the timeline is pruned from the next incarnation's
    environment (a crash at step N must not re-crash the restart that
    resumes from the step-N checkpoint).  Identity is ``(kind, step)``
    (`chaos_schedule` guarantees uniqueness); ``init_flake`` matches on
    any firing.
    """
    inj = FaultInjector.from_spec(spec)
    etype = f"fault.{inj.kind}"
    for e in events:
        if e.get("type") != etype:
            continue
        if inj.kind == "init_flake":
            return True
        if e.get("step") == inj.step:
            return True
    return False


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection, armed via ``IGG_FAULT_INJECT``.

    Spec grammar (see docs/robustness.md):

    * ``init_flake:N`` — the first ``N`` `init_distributed` attempts raise
      (simulated coordinator race); attempt ``N+1`` proceeds.  Proves the
      retry/backoff path end to end.
    * ``halo_corrupt:stepN[:blockB]`` — after time-loop step ``N``, a NaN is
      written into an interior cell of block ``B`` (Cartesian rank, default
      0), one cell off the block edge, by the rank that holds the block.
      Proves corruption→guard-trip.
    * ``worker_crash:stepN[:procP]`` — after time-loop step ``N`` (and after
      that step's checkpoint), process ``P`` (default: the last process)
      exits hard with status 17.  Proves crash→restart-from-checkpoint.
    * ``stall:stepN[:procP]`` — after time-loop step ``N``, process ``P``
      (default: the last process) sleeps `STALL_S` seconds before
      continuing — a transient hang, NOT a crash.  On a communicating grid
      every rank's loop wedges with it (the neighbors block in the next
      exchange).
    * ``net_delay:stepN[:procP]`` — after time-loop step ``N``, process
      ``P`` (default: the last process) arms `NET_DELAY_S` seconds of
      latency on its NEXT host collective (`utils.tracing.
      arm_collective_delay`: a sleep before its next halo exchange or
      control collective, whichever comes first): the rank enters it late
      and its peers block with it — a transient network fault that
      recovers on its own.
    * ``ckpt_corrupt:stepN[:shardS]`` — right after the step-``N`` checkpoint
      publishes, a byte of shard file ``S`` (default 0) is flipped WITHOUT
      updating the manifest (process 0 applies it).  Proves the CRC
      verification + generation fallback of `utils.checkpoint`.
    * ``ckpt_truncate:stepN[:shardS]`` — same, but the shard file is
      truncated to half its size (a torn write).
    * ``bit_flip:stepN[:field|transport|ckpt][:procP]`` — silent data
      corruption: ONE mantissa LSB flips, producing a perfectly FINITE
      wrong value that `check_fields` can never see (``halo_corrupt`` is
      its guard-VISIBLE twin — same injection point, NaN payload).  The
      optional placement component picks the detector under test: a FIELD
      NAME (or omitted: field 0) flips an interior cell of the committed
      post-step state — caught only by the shadow-step audit
      (``IGG_INTEGRITY_EVERY``); ``transport`` arms a payload-word flip on
      rank ``P``'s next checksummed halo hop
      (`ops.halo.arm_transport_flip`) — caught by the RECEIVER's transport
      checksum,
      implicating the sender; ``ckpt`` flips one payload byte after the
      lineage digests are taken but before the shard writer runs — CRC
      verifies clean (the bytes on disk are intact), only the lineage
      chain convicts the generation as poisoned-at-save.

    Each fault fires once per injector (a rolled-back or restarted run does
    not re-trip), mirroring how real transient faults behave.  Several
    faults compose as a comma-separated spec (parsed by `FaultSet`), e.g.
    ``worker_crash:step4:proc1,ckpt_corrupt:step4`` — crash AND damaged
    newest generation in one run.
    """

    kind: str | None = None
    step: int | None = None
    target: int | None = None  # halo_corrupt: block rank; worker_crash: process
    count: int = 0  # init_flake: remaining flaky attempts
    fired: bool = False
    #: bit_flip placement: a field NAME, "transport", "ckpt", or None (field 0)
    field: str | None = None

    #: exit status of an injected worker crash (distinct from real crashes)
    CRASH_STATUS = 17

    #: injected-stall duration in seconds (class attr: tests shrink it)
    STALL_S = 6.0

    #: injected host-collective latency in seconds (class attr: tests shrink)
    NET_DELAY_S = 1.5

    def spec(self) -> str:
        """The canonical spec string this injector parses back from (the
        supervisor's arm/prune round-trip)."""
        if self.kind is None:
            return ""
        if self.kind == "init_flake":
            return f"init_flake:{self.count}"
        out = f"{self.kind}:step{self.step}"
        if self.kind == "bit_flip" and self.field is not None:
            out += f":{self.field}"
        if self.target is not None:
            out += f":{_TARGET_PREFIX[self.kind]}{self.target}"
        return out

    @classmethod
    def from_spec(cls, spec: str | None) -> "FaultInjector":
        if not spec:
            return cls()
        parts = spec.split(":")
        kind = parts[0]
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"IGG_FAULT_INJECT: unknown fault kind {kind!r} in {spec!r}; "
                f"accepted kinds: {', '.join(FAULT_KINDS)} (format: "
                f"'init_flake:N' or 'halo_corrupt:stepN[:blockB]' or "
                f"'worker_crash:stepN[:procP]')."
            )
        if kind == "init_flake":
            if len(parts) != 2 or not parts[1].isdigit():
                raise ValueError(
                    f"IGG_FAULT_INJECT: {spec!r} — init_flake takes "
                    f"'init_flake:N' with N a non-negative integer count of "
                    f"attempts to fail."
                )
            return cls(kind=kind, count=int(parts[1]))
        tgt_prefix = _TARGET_PREFIX[kind]
        if kind == "bit_flip":
            if len(parts) not in (2, 3, 4) or not parts[1].startswith("step"):
                raise ValueError(
                    f"IGG_FAULT_INJECT: {spec!r} — bit_flip takes "
                    f"'bit_flip:stepN[:field|transport|ckpt][:procP]' with N "
                    f"the 1-based time-loop step."
                )
            try:
                step = int(parts[1][len("step"):])
            except ValueError:
                raise ValueError(
                    f"IGG_FAULT_INJECT: {spec!r} — step must be an integer, "
                    f"got {parts[1][len('step'):]!r}."
                )
            field = None
            target = None
            for comp in parts[2:]:
                if comp.startswith("proc") and comp[len("proc"):].isdigit():
                    if target is not None:
                        raise ValueError(
                            f"IGG_FAULT_INJECT: {spec!r} — bit_flip takes at "
                            f"most one 'procP' component."
                        )
                    target = int(comp[len("proc"):])
                elif comp.isdigit():
                    # A bare integer is ambiguous (field index? rank?) and
                    # would silently mis-read as a target on the other
                    # kinds' grammar — demand the explicit form.
                    raise ValueError(
                        f"IGG_FAULT_INJECT: {spec!r} — bare integer "
                        f"{comp!r} is not a bit_flip placement; name the "
                        f"FIELD (e.g. ':T'), a reserved placement "
                        f"(':transport' or ':ckpt'), or the target rank as "
                        f"':proc{comp}'."
                    )
                elif field is None:
                    field = comp
                else:
                    raise ValueError(
                        f"IGG_FAULT_INJECT: {spec!r} — bit_flip takes at "
                        f"most one placement component (field name, "
                        f"'transport' or 'ckpt'); got both {field!r} and "
                        f"{comp!r}."
                    )
            return cls(kind=kind, step=step, target=target, field=field)
        if len(parts) not in (2, 3) or not parts[1].startswith("step"):
            raise ValueError(
                f"IGG_FAULT_INJECT: {spec!r} — {kind} takes "
                f"'{kind}:stepN[:{tgt_prefix}P]' with N the 1-based "
                f"time-loop step."
            )
        try:
            step = int(parts[1][len("step"):])
        except ValueError:
            raise ValueError(
                f"IGG_FAULT_INJECT: {spec!r} — step must be an integer, "
                f"got {parts[1][len('step'):]!r}."
            )
        target = None
        if len(parts) == 3:
            if not parts[2].startswith(tgt_prefix):
                what = {
                    "block": "a block rank.",
                    "proc": "a process index.",
                    "shard": "a shard (writer process) index.",
                }[tgt_prefix]
                raise ValueError(
                    f"IGG_FAULT_INJECT: {spec!r} — the third component must "
                    f"be '{tgt_prefix}P' with P " + what
                )
            try:
                target = int(parts[2][len(tgt_prefix):])
            except ValueError:
                raise ValueError(
                    f"IGG_FAULT_INJECT: {spec!r} — {tgt_prefix} must be an "
                    f"integer, got {parts[2][len(tgt_prefix):]!r}."
                )
        return cls(kind=kind, step=step, target=target)

    @property
    def active(self) -> bool:
        return self.kind is not None

    # - init_flake -

    def maybe_flake_init(self) -> None:
        """Raise a simulated coordinator race while flaky attempts remain."""
        if self.kind == "init_flake" and self.count > 0:
            self.count -= 1
            _telemetry.event("fault.init_flake", remaining=self.count)
            raise RuntimeError(
                "IGG_FAULT_INJECT(init_flake): simulated coordinator race "
                f"({self.count} flaky attempt(s) remaining)"
            )


    # - halo_corrupt -

    def maybe_corrupt(self, state: tuple, step: int) -> tuple:
        """After step ``step``: NaN-poison one interior cell of the target
        block (in place, on the rank that holds it)."""
        if self.kind != "halo_corrupt" or self.fired or step != self.step:
            return state
        self.fired = True
        A = self._poison_block(state[0], announce_step=step)
        return (A, *state[1:])

    def _poison_block(self, A, announce_step=None):
        idx, local = _block_interior_index(A, self.target or 0)
        _telemetry.event(
            "fault.halo_corrupt",
            index=list(int(i) for i in idx),
            block=self.target or 0,
            step=announce_step if announce_step is not None else self.step,
        )
        if _safe_process_index() == 0:
            at = "" if announce_step is None else f" after step {announce_step}"
            print(
                f"[igg.resilience] IGG_FAULT_INJECT(halo_corrupt): writing "
                f"NaN into global index {tuple(idx)} (block "
                f"{self.target or 0}){at}",
                file=sys.stderr,
                flush=True,
            )
        if local is not None:
            A[local] = float("nan")
        return A

    def corrupt_halo_hook(self, fields: tuple) -> tuple:
        """`ops.halo` post-exchange hook: poison `update_halo` output.

        Step-agnostic (halo calls carry no step): fires on the first
        exchange after arming.  Installed by `install_halo_fault_hook`.
        The port's model steps call `update_halo` eagerly, so an installed
        hook also sees their exchanges (in the JAX package those are traced
        and never reach the hook).
        """
        if self.kind != "halo_corrupt" or self.fired:
            return fields
        self.fired = True
        return (self._poison_block(fields[0]), *fields[1:])

    # - worker_crash -

    def maybe_crash(self, step: int) -> None:
        """After step ``step``'s guard+checkpoint: hard-exit this process."""
        if self.kind != "worker_crash" or self.fired or step != self.step:
            return  # cheap short-circuit: this runs every step of every loop
        want = self.target if self.target is not None else _last_process_index()
        if _safe_process_index() != want:
            return
        self.fired = True
        # The event line and the flight bundle are each a single O_APPEND
        # os.write: they survive the os._exit below (the crash marker of
        # the timeline).
        _telemetry.event(
            "fault.worker_crash", step=step, status=self.CRASH_STATUS
        )
        _tracing.dump_flight_recorder(
            "fault.worker_crash", step=step, status=self.CRASH_STATUS
        )
        print(
            f"[igg.resilience] IGG_FAULT_INJECT(worker_crash): exiting hard "
            f"after step {step} (status {self.CRASH_STATUS})",
            file=sys.stderr,
            flush=True,
        )
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(self.CRASH_STATUS)

    # - stall -

    def maybe_stall(self, step: int) -> None:
        """After step ``step``: the target process sleeps `STALL_S` seconds.
        The event line lands BEFORE the sleep."""
        if self.kind != "stall" or self.fired or step != self.step:
            return
        want = self.target if self.target is not None else _last_process_index()
        if _safe_process_index() != want:
            return
        self.fired = True
        _telemetry.event("fault.stall", step=step, sleep_s=self.STALL_S)
        print(
            f"[igg.resilience] IGG_FAULT_INJECT(stall): sleeping "
            f"{self.STALL_S}s after step {step}",
            file=sys.stderr,
            flush=True,
        )
        time.sleep(self.STALL_S)

    # - net_delay -

    def maybe_net_delay(self, step: int) -> None:
        """After step ``step``: arm `NET_DELAY_S` of latency on the target
        process's NEXT host collective (`utils.tracing.arm_collective_delay`:
        its next halo exchange or control collective).  A transient network
        fault, not a hang: the delayed rank enters the collective late and
        its peers block with it."""
        if self.kind != "net_delay" or self.fired or step != self.step:
            return
        want = self.target if self.target is not None else _last_process_index()
        if _safe_process_index() != want:
            return
        self.fired = True
        _telemetry.event("fault.net_delay", step=step, delay_s=self.NET_DELAY_S)
        print(
            f"[igg.resilience] IGG_FAULT_INJECT(net_delay): delaying the "
            f"next host collective by {self.NET_DELAY_S}s "
            f"(after step {step})",
            file=sys.stderr,
            flush=True,
        )
        _tracing.arm_collective_delay(self.NET_DELAY_S)

    # - ckpt_corrupt / ckpt_truncate -

    def maybe_damage_checkpoint(self, step_dir: str, step: int) -> None:
        """After the step-``step`` checkpoint published: damage one shard.

        Called by `utils.checkpoint.save_checkpoint` on process 0 right
        after the atomic rename — the manifest already vouches for the
        intact bytes, so the damage is exactly what `verify_checkpoint`
        exists to catch.  ``ckpt_corrupt`` flips one byte mid-file (CRC
        mismatch); ``ckpt_truncate`` halves the file (size mismatch).
        """
        if (
            self.kind not in ("ckpt_corrupt", "ckpt_truncate")
            or self.fired
            or step != self.step
        ):
            return
        self.fired = True
        shard = os.path.join(step_dir, f"shards_p{self.target or 0}.npz")
        size = os.path.getsize(shard)
        if self.kind == "ckpt_truncate":
            os.truncate(shard, size // 2)
            what = f"truncated to {size // 2} of {size} bytes"
        else:
            with open(shard, "r+b") as f:
                f.seek(size // 2)
                byte = f.read(1)
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]))
            what = f"flipped byte at offset {size // 2}"
        _telemetry.event(
            f"fault.{self.kind}", step=step, shard=self.target or 0, what=what
        )
        print(
            f"[igg.resilience] IGG_FAULT_INJECT({self.kind}): {what} in "
            f"{shard} after step {step}",
            file=sys.stderr,
            flush=True,
        )

    # - bit_flip -

    def _bit_flip_armed(self, step: int, placement: str | None) -> bool:
        """Does this injector's bit_flip fire at ``step`` for ``placement``
        (None = the state placement: any non-reserved ``field``)?"""
        if self.kind != "bit_flip" or self.fired or step != self.step:
            return False
        if placement is None:
            return self.field not in BIT_FLIP_PLACEMENTS
        return self.field == placement

    def maybe_bit_flip(self, state: tuple, step: int,
                       names: Sequence[str] | None = None) -> tuple:
        """State placement: after step ``step``, flip ONE mantissa LSB of an
        interior cell of the committed state — a finite wrong value, by
        construction invisible to the NaN/Inf guard (``halo_corrupt`` is the
        guard-visible twin).  Only the shadow-step audit can convict it.
        The target block's rank flips bit 0 of the cell's word in place
        (an integer ``view`` of the field), like `maybe_corrupt`.
        """
        if not self._bit_flip_armed(step, None):
            return state
        fidx = 0
        if self.field is not None:
            if names is None or self.field not in tuple(names):
                have = ", ".join(map(repr, names)) if names else "(unnamed)"
                raise ValueError(
                    f"IGG_FAULT_INJECT(bit_flip): field {self.field!r} does "
                    f"not exist in this run — the guarded state carries "
                    f"{have}. The spec is 'bit_flip:stepN[:field|transport|"
                    f"ckpt][:procP]'; a field component must name one of the "
                    f"run's fields."
                )
            fidx = tuple(names).index(self.field)
        self.fired = True
        A = self._flip_state_cell(state[fidx], step, fidx)
        return (*state[:fidx], A, *state[fidx + 1:])

    def _flip_state_cell(self, A, step: int, fidx: int):
        idx, local = _block_interior_index(A, self.target or 0)
        _telemetry.event(
            "fault.bit_flip", step=step, placement="state",
            field=self.field or f"field{fidx}",
            index=list(int(i) for i in idx), proc=self.target or 0,
        )
        if _safe_process_index() == 0:
            print(
                f"[igg.resilience] IGG_FAULT_INJECT(bit_flip): flipping one "
                f"mantissa bit at global index {tuple(idx)} "
                f"(field {self.field or fidx}, block {self.target or 0}) "
                f"after step {step}",
                file=sys.stderr,
                flush=True,
            )
        if local is not None:
            from ..ops.halo import _WORDS, _as_words

            words = _as_words(A)
            words = words.view(_WORDS[words.element_size()])
            words[local if words.dim() == A.dim() else (*local, 0)] ^= 1
        return A

    def maybe_bit_flip_transport(self, step: int) -> None:
        """Transport placement: arm a payload-word flip on rank ``P``'s next
        checksummed halo hop (`ops.halo.arm_transport_flip`) — the
        arm-on-step / fire-on-next-exchange idiom of ``net_delay``.  Every
        process arms; only rank ``P`` flips its send buffers."""
        if not self._bit_flip_armed(step, "transport"):
            return
        self.fired = True
        from ..ops import halo as _halo

        want = self.target if self.target is not None else 0
        _telemetry.event(
            "fault.bit_flip", step=step, placement="transport", proc=want
        )
        if _safe_process_index() == 0:
            print(
                f"[igg.resilience] IGG_FAULT_INJECT(bit_flip): arming an "
                f"in-flight payload-word flip on rank {want}'s next "
                f"checksummed halo transport (after step {step})",
                file=sys.stderr,
                flush=True,
            )
        _halo.arm_transport_flip(want)

    def maybe_bit_flip_ckpt(self, payload: dict, step: int) -> None:
        """Checkpoint placement: flip one payload byte AFTER the lineage
        digests were taken and BEFORE the shard writer runs
        (`utils.checkpoint.save_checkpoint` calls this between the two).
        The CRC manifest then vouches for the flipped bytes — the file on
        disk is intact — and only the lineage chain convicts the generation
        as poisoned-at-save.  Replaces one payload array of the dict by a
        flipped copy; the writer process ``P`` (default 0) applies it."""
        if not self._bit_flip_armed(step, "ckpt"):
            return
        want = self.target if self.target is not None else 0
        if _safe_process_index() != want:
            return
        self.fired = True
        keys = sorted(k for k in payload if not k.endswith("_shape"))
        if not keys:
            return
        # copy=True: a payload entry of a CPU field is a view of the live
        # tensor
        arr = np.array(payload[keys[0]], copy=True)
        arr.view(np.uint8).reshape(-1)[0] ^= 1
        payload[keys[0]] = arr
        _telemetry.event(
            "fault.bit_flip", step=step, placement="ckpt", key=keys[0],
            proc=want,
        )
        print(
            f"[igg.resilience] IGG_FAULT_INJECT(bit_flip): flipped one "
            f"payload byte of {keys[0]} between digest and write of the "
            f"step-{step} checkpoint",
            file=sys.stderr,
            flush=True,
        )


@dataclasses.dataclass
class FaultSet:
    """Several `FaultInjector`s armed at once (comma-separated spec).

    The process-wide injector `get_fault_injector` returns: every hook
    point (`maybe_flake_init`, `maybe_corrupt`, `maybe_crash`,
    `maybe_damage_checkpoint`, `corrupt_halo_hook`) fans out to each armed
    fault, so e.g. ``worker_crash:step4:proc1,ckpt_corrupt:step4`` crashes
    a worker AND damages the newest checkpoint generation in one run.
    """

    injectors: tuple = ()

    @classmethod
    def from_spec(cls, spec: str | None) -> "FaultSet":
        """Parse a comma-separated spec; ``chaos:seed=N:rate=R[...]`` parts
        expand into their deterministic storm (`chaos_schedule`) first."""
        return cls(
            tuple(
                FaultInjector.from_spec(part)
                for part in expand_fault_spec(spec)
            )
        )

    @property
    def active(self) -> bool:
        return any(i.active for i in self.injectors)

    def maybe_flake_init(self) -> None:
        for i in self.injectors:
            i.maybe_flake_init()

    def maybe_corrupt(self, state: tuple, step: int) -> tuple:
        for i in self.injectors:
            state = i.maybe_corrupt(state, step)
        return state

    def corrupt_halo_hook(self, fields: tuple) -> tuple:
        for i in self.injectors:
            fields = i.corrupt_halo_hook(fields)
        return fields

    def maybe_crash(self, step: int) -> None:
        for i in self.injectors:
            i.maybe_crash(step)

    def maybe_stall(self, step: int) -> None:
        for i in self.injectors:
            i.maybe_stall(step)

    def maybe_net_delay(self, step: int) -> None:
        for i in self.injectors:
            i.maybe_net_delay(step)

    def maybe_bit_flip(self, state: tuple, step: int,
                       names: Sequence[str] | None = None) -> tuple:
        for i in self.injectors:
            state = i.maybe_bit_flip(state, step, names)
        return state

    def maybe_bit_flip_transport(self, step: int) -> None:
        for i in self.injectors:
            i.maybe_bit_flip_transport(step)

    def maybe_bit_flip_ckpt(self, payload: dict, step: int) -> None:
        for i in self.injectors:
            i.maybe_bit_flip_ckpt(payload, step)

    def specs(self) -> list[str]:
        """Canonical per-fault spec strings (the supervisor round-trip)."""
        return [i.spec() for i in self.injectors if i.active]

    def maybe_damage_checkpoint(self, step_dir: str, step: int) -> None:
        for i in self.injectors:
            i.maybe_damage_checkpoint(step_dir, step)


def _last_process_index() -> int:
    return _telemetry.process_count() - 1


def _block_interior_index(A, block_rank: int) -> tuple:
    """``(global_index, local_index)`` of a cell inside block ``block_rank``
    of field ``A``, one cell off the block edge (so frozen boundary rings
    don't mask it and the models' interior updates propagate it).  The
    global index is the JAX package's (block layout, for the messages);
    ``local_index`` indexes this rank's block, None on every other rank.  A
    batched field ``(B, *block)`` is hit in member 0."""
    from ..parallel import topology

    gg = _grid.global_grid()
    if not 0 <= block_rank < gg.nprocs:
        raise ValueError(
            f"IGG_FAULT_INJECT(halo_corrupt): block {block_rank} is out of "
            f"range for this grid ({gg.nprocs} blocks, dims {gg.dims})."
        )
    coords = topology.coords_of_rank(block_rank, gg.dims)
    lead = max(0, A.dim() - NDIMS)
    lsh = tuple(A.shape[lead:])
    cell = tuple(min(1, n - 1) for n in lsh)
    glob = tuple(c * n + j for c, n, j in zip(coords[: len(lsh)], lsh, cell))
    local = (0,) * lead + cell if gg.me == block_rank else None
    return glob, local


_injector: FaultSet | None = None
_injector_spec: str | None = None


def get_fault_injector() -> FaultSet:
    """The process-wide injector for the current ``IGG_FAULT_INJECT`` value
    (a `FaultSet`: the spec may arm several comma-separated faults).

    Cached per spec string so fired/remaining state persists across calls;
    changing the env var re-arms automatically, `reset_fault_injector`
    re-arms explicitly (the pytest fixture path).
    """
    global _injector, _injector_spec
    spec = _config.fault_inject_env()
    if _injector is None or spec != _injector_spec:
        _injector = FaultSet.from_spec(spec)
        _injector_spec = spec
    return _injector


def reset_fault_injector() -> None:
    global _injector, _injector_spec
    _injector = None
    _injector_spec = None


def install_halo_fault_hook() -> None:
    """Wire the active injector into `ops.halo`'s post-exchange hook point
    (`ops.halo.set_post_exchange_hook`)."""
    from ..ops import halo as _halo

    inj = get_fault_injector()
    _halo.set_post_exchange_hook(inj.corrupt_halo_hook if inj.active else None)


# -- Run guard (the models' time-loop hook) -----------------------------------


def snapshot_state(state: tuple) -> tuple:
    """Bit-exact copy of a state tuple in fresh tensors on the same device.

    A plain reference is not enough for rollback or the shadow audit: the
    models' exchanges update their fields in place.
    """
    return tuple(A.clone() for A in state)


#: shared reusable null context of the untraced loop
_NULL_CM = contextlib.nullcontext()


def guarded_time_loop(step_fn, state: tuple, nt: int, *, guard: "RunGuard",
                      model: str | None = None, bytes_per_step: int | None = None,
                      steps_per_call: int = 1) -> tuple:
    """The models' host-side time loop with the guard pipeline attached.

    Resumes from the guard's checkpoint dir when one exists, then advances
    to step ``nt``, running `RunGuard.on_step` after every step (fault
    injection → shadow-step audit at the ``integrity_every`` cadence →
    NaN/Inf guard → checkpoint → crash injection; rollback may rewind the
    loop variable).  Shared by the three models' ``run()`` so the guard
    semantics cannot drift between them.

    ``model`` switches on the per-step telemetry (`utils.telemetry.
    step_loop`): wall time, steps/s and, with ``bytes_per_step`` (the
    solver's must-stream bytes model, `telemetry.teff_bytes`), the built-in
    ``T_eff``, the ``IGG_HEARTBEAT_EVERY`` heartbeat, one ``igg.step`` span
    per call, and the subscription of `RunGuard.on_alert` to the live
    plane's rule engine while the loop runs.  Per-step wall time is the
    loop's host time: the loop never waits for the device on its own (only
    a probe, an audit or a checkpoint reads it), so on the card it is
    amortized, dispatch time until the CUDA queue fills.

    ``steps_per_call``: the steps one ``step_fn`` call advances (a fused
    group); the guard's cadences count steps and must then be multiples of
    it, and step-keyed faults fire at the steps a call ends on.

    With every hook off (``guard.enabled`` False) and ``IGG_TELEMETRY=0``
    (or ``model=None``) the loop is ``step_fn`` and nothing else: no
    snapshot, no probe, no span, no synchronization.
    """
    k = int(steps_per_call)
    if k < 1:
        raise ValueError(f"steps_per_call must be >= 1 (got {steps_per_call})")
    cadences = {"guard_every": guard.guard_every, "checkpoint_every": guard.checkpoint_every,
                "integrity_every": guard.integrity_every}
    for knob, every in cadences.items():
        if every % k:
            raise ValueError(
                f"{knob}={every} must be a multiple of the {k} steps each call "
                f"advances (steps_per_call)."
            )
    state, it = guard.start(state)
    enabled = guard.enabled
    tele = (
        _telemetry.step_loop(model, bytes_per_step=bytes_per_step, start_step=it,
                             total_steps=nt, steps_per_call=k)
        if model is not None
        else None
    )
    if it > nt:
        # A checkpoint past the requested horizon is almost always a stale
        # directory (e.g. a previous longer run): returning it silently
        # would mislabel old physics as this run's result.
        warnings.warn(
            f"resumed checkpoint is at step {it}, past the requested "
            f"nt={nt}; returning the checkpointed state unchanged (stale "
            f"checkpoint_dir?)",
            RuntimeWarning,
            stacklevel=2,
        )
    # While this loop runs, a CRITICAL live-plane alert (a heartbeat tick or
    # a scrape) forces an out-of-cadence guard probe.
    _liveplane = None
    if tele is not None and enabled:
        from . import liveplane as _liveplane

        _liveplane.subscribe(guard.on_alert)
    try:
        while it < nt:
            # One ``igg.step`` host span per call (dispatch + guard
            # pipeline: the wall time step_seconds records), tagged with
            # the step it ends on, and the profiler range ``igg_step[<model>]``
            # around the call while a capture is live.  Untraced loops reuse
            # the shared null context.
            if tele is None:
                span = ann = _NULL_CM
            else:
                span = _tracing.trace_span("igg.step", model=model, step=it + k)
                ann = _profiling.scope(f"igg_step[{model}]")
            with span:
                pre = guard.audit_snapshot(state, it, k) if enabled else None
                with ann:
                    state = step_fn(*state)
                it += k
                if enabled:
                    state, it = guard.on_step(state, it, replay=(step_fn, pre))
            if tele is not None:
                tele.on_step(it, k)
        if tele is not None:
            tele.finish(it)
    finally:
        if _liveplane is not None:
            _liveplane.unsubscribe(guard.on_alert)
        if tele is not None:
            # A capture window still open when the loop exits (a guard
            # trip, an injected fault) stops here, so the bytes already
            # captured land next to the flight bundle.  Never raises.
            _profiling.close_open_capture("scope_exit")
    return state


class RunGuard:
    """Guard, checkpoint and fault injection for a host-side time loop.

    Used by the three models' ``run()`` loops (through
    `guarded_time_loop`)::

        guard = RunGuard(guard_every=10, policy="rollback",
                         checkpoint_every=100, checkpoint_dir="/ckpt",
                         names=("T", "Cp"))
        state, it = guard.start(state)
        while it < nt:
            state = step(*state)
            it += 1
            state, it = guard.on_step(state, it)

    Per step, in order: (1) fault injection (``halo_corrupt``, ``bit_flip``),
    (2) the shadow-step audit every ``integrity_every`` steps
    (``IGG_INTEGRITY_EVERY``): the loop retained a pre-step snapshot
    (`audit_snapshot`), the just-committed step re-executes from it and the
    two results bit-compare (`integrity.audit_fields`) — a mismatch raises
    `integrity.IntegrityError` BEFORE any checkpoint can persist the corrupt
    state, naming the implicated rank(s), (3) the NaN/Inf guard every
    ``guard_every`` steps with the
    ``raise`` | ``warn`` | ``rollback`` policy, (4) checkpoint every
    ``checkpoint_every`` steps (only ever of guard-passed state) followed by
    retention pruning when ``checkpoint_keep`` (``IGG_CHECKPOINT_KEEP``) is
    set — pruning never deletes the only integrity-verified generation,
    (5) fault injection (``worker_crash`` — after the checkpoint, so restart
    resumes exactly at the crash point — ``stall``, ``net_delay``, and the
    ``bit_flip`` transport arming).  Rollback restores the last good
    snapshot (in-memory; the disk checkpoint serves cross-process restart)
    and rewinds ``it``.  A pending CRITICAL live-plane alert (`on_alert`,
    subscribed by `guarded_time_loop`) forces the step-(3) probe out of
    cadence at the next step.

    All knobs resolve kwarg > ``IGG_*`` env > default (the reference's
    configuration tiers); ``IGG_INTEGRITY=0`` force-disables the audit
    cadence regardless of either tier (the pinned zero-overhead switch,
    like ``IGG_TELEMETRY=0``).
    """

    def __init__(
        self,
        *,
        guard_every: int | None = None,
        policy: str | None = None,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_keep: int | None = None,
        names: Sequence[str] | None = None,
        max_rollbacks: int = 3,
        injector: "FaultInjector | FaultSet | None" = None,
        integrity_every: int | None = None,
    ):
        env_ge = _config.guard_every_env()
        env_pol = _config.guard_policy_env()
        env_ce = _config.checkpoint_every_env()
        env_dir = _config.checkpoint_dir_env()
        env_keep = _config.checkpoint_keep_env()
        env_ie = _config.integrity_every_env()
        self.guard_every = int(
            guard_every if guard_every is not None else (env_ge or 0)
        )
        self.policy = policy if policy is not None else (env_pol or "raise")
        self.checkpoint_every = int(
            checkpoint_every if checkpoint_every is not None else (env_ce or 0)
        )
        self.checkpoint_dir = (
            checkpoint_dir if checkpoint_dir is not None else env_dir
        )
        # Retention: keep this many newest generations, pruning the rest
        # after every save (0 = unbounded).  Pruning never deletes the only
        # integrity-verified generation (`checkpoint.prune_checkpoints`).
        self.checkpoint_keep = int(
            checkpoint_keep if checkpoint_keep is not None else (env_keep or 0)
        )
        # Shadow-step audit cadence (docs/robustness.md).  ``IGG_INTEGRITY=0``
        # overrides BOTH tiers to 0: the master switch pins the whole
        # integrity plane to zero overhead, whatever a cadence knob says.
        self.integrity_every = int(
            integrity_every if integrity_every is not None else (env_ie or 0)
        )
        if _config.integrity_enabled_env() is False:
            self.integrity_every = 0
        if self.integrity_every < 0:
            raise ValueError(
                f"integrity_every must be >= 0 (got {self.integrity_every})"
            )
        if self.guard_every < 0:
            raise ValueError(f"guard_every must be >= 0 (got {self.guard_every})")
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0 (got {self.checkpoint_every})"
            )
        if self.checkpoint_keep < 0:
            raise ValueError(
                f"checkpoint_keep must be >= 0 (got {self.checkpoint_keep}; "
                f"0 keeps every generation)"
            )
        if self.policy not in _config.GUARD_POLICIES:
            raise ValueError(
                f"guard policy must be one of "
                f"{', '.join(map(repr, _config.GUARD_POLICIES))}, got {self.policy!r}."
            )
        if self.checkpoint_every and not self.checkpoint_dir:
            raise ValueError(
                "checkpoint_every > 0 requires a checkpoint_dir (kwarg or "
                "IGG_CHECKPOINT_DIR)."
            )
        self.names = tuple(names) if names is not None else None
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0
        self._last_good: tuple | None = None
        self._last_good_step = 0
        self._injector = injector if injector is not None else get_fault_injector()
        # A pending critical live-plane alert staged by `on_alert`; the
        # next `on_step` consumes it as a forced out-of-cadence probe.
        self._alert: dict | None = None

    @property
    def enabled(self) -> bool:
        return bool(
            self.guard_every
            or self.checkpoint_every
            or self.integrity_every
            or self._injector.active
        )

    def start(self, state: tuple) -> tuple:
        """Resume from the latest checkpoint if one exists, else step 0.

        Returns ``(state, start_step)``.  The step-0 state is snapshotted as
        the initial rollback target when the policy needs one.
        """
        it = 0
        if self.checkpoint_dir:
            from . import checkpoint as _ckpt

            latest = _ckpt.latest_checkpoint(self.checkpoint_dir)
            if latest is not None:
                # latest_checkpoint already CRC-verified this generation:
                # don't pay a second full read+CRC pass over every shard.
                state, it, _ = _ckpt.restore_checkpoint(
                    latest, like=state, verify=False
                )
                _telemetry.event("run.resumed", step=it, path=latest)
                _telemetry.counter("resilience.resumes").inc()
                print(
                    f"[igg.resilience] resumed from checkpoint {latest} "
                    f"(step {it})",
                    file=sys.stderr,
                    flush=True,
                )
        if self.policy == "rollback" and self.guard_every:
            self._last_good = snapshot_state(state)
            self._last_good_step = it
        return state, it

    def on_alert(self, alert: dict) -> None:
        """Live-plane subscriber (`utils.liveplane.subscribe`): a CRITICAL
        alert escalates into the guard — the next `on_step` runs the
        NaN/Inf field probe immediately, out of cadence, under the
        configured policy.  Warn-severity alerts stay observability-only.
        One reference assignment (the engine may call from the scrape
        thread)."""
        if alert.get("severity") == "critical":
            self._alert = alert

    def audit_snapshot(self, state: tuple, it: int, steps: int = 1) -> tuple | None:
        """Pre-step state retained for the shadow audit of the call that
        takes step ``it`` to ``it + steps``, or None when that step is
        off-cadence.  Called by the loop BEFORE the step executes; the
        snapshot owns fresh tensors (`snapshot_state`), so the re-execution
        may update it in place."""
        if not self.integrity_every or (it + steps) % self.integrity_every != 0:
            return None
        return snapshot_state(state)

    def on_step(self, state: tuple, it: int, replay=None) -> tuple:
        """Run the per-step guard pipeline; returns ``(state, it)``.

        ``replay``: ``(step_fn, pre_state_or_None)`` from the loop — when the
        retained `audit_snapshot` is present, step ``it`` re-executes from it
        and bit-compares against the committed ``state`` (the shadow-step
        audit).  Injection runs FIRST, so an armed state-placement
        ``bit_flip`` lands in the committed copy and the clean re-execution
        convicts it — the detection matrix's compute-placement leg."""
        state = self._injector.maybe_corrupt(state, it)
        state = self._injector.maybe_bit_flip(state, it, self.names)
        if replay is not None and replay[1] is not None:
            state = self._audit(state, it, replay)
        escalated, self._alert = self._alert, None
        if escalated is not None and _last_process_index() > 0:
            # Several processes: `check_fields` is a collective and an
            # alert is rank-local, so a probe keyed on it would diverge
            # the ranks.  The alert event and the health view carry it.
            escalated = None
        if escalated is not None:
            _telemetry.event(
                "guard.alert_probe", step=it, rule=escalated.get("rule"),
                severity=escalated.get("severity"),
            )
            _telemetry.counter("resilience.alert_probes").inc()
        do_guard = (self.guard_every and it % self.guard_every == 0) or escalated is not None
        do_ckpt = self.checkpoint_every and it % self.checkpoint_every == 0
        # Checkpoints must only ever hold guard-passed state: when guarding
        # is on, a checkpoint step that falls between probe points is probed
        # too (guard_every=3, checkpoint_every=2 must not persist a NaN born
        # at step 2 and first probed at step 3).
        if do_guard or (do_ckpt and self.guard_every):
            report = check_fields(*state, names=self.names)
            if not report.ok:
                state, it = self._trip(state, it, report)
                return state, it  # fresh state: skip checkpoint/crash this round
            if self.policy == "rollback":
                self._last_good = snapshot_state(state)
                self._last_good_step = it
        if do_ckpt:
            from . import checkpoint as _ckpt

            _ckpt.save_checkpoint(self.checkpoint_dir, state, it)
            if self.checkpoint_keep:
                _ckpt.prune_checkpoints(
                    self.checkpoint_dir, keep=self.checkpoint_keep
                )
        self._injector.maybe_crash(it)
        self._injector.maybe_stall(it)
        self._injector.maybe_net_delay(it)
        self._injector.maybe_bit_flip_transport(it)
        return state, it

    def _audit(self, state: tuple, it: int, replay) -> tuple:
        """The shadow-step audit of step ``it`` (docs/robustness.md).

        Re-executes the step from the retained pre-step snapshot and
        bit-compares against the committed result.  The port's kernels and
        plain versions are run-to-run deterministic on healthy hardware, so
        ANY difference is silent data corruption; the verdict is replicated
        (`integrity.audit_fields`), so every rank raises together.  Raises
        BEFORE the checkpoint stage so corrupt state never persists.
        """
        from ..integrity import audit_fields
        from ..integrity.errors import IntegrityError

        step_fn, pre = replay
        redone = step_fn(*pre)
        report = audit_fields(tuple(state), tuple(redone), names=self.names)
        _telemetry.counter("integrity.audits").inc()
        if report.ok:
            return state
        _telemetry.counter("integrity.audit_mismatches").inc()
        _telemetry.event(
            "integrity.audit_mismatch", detector="shadow_audit", step=it,
            report=report.summary(),
            implicated_ranks=list(report.implicated_ranks),
        )
        implicated = (
            report.implicated_ranks[0] if report.implicated_ranks else -1
        )
        _tracing.dump_flight_recorder(
            "sdc", detector="shadow_audit", step=it, implicated_rank=implicated,
            implicated_ranks=list(report.implicated_ranks), report=report.summary(),
        )
        raise IntegrityError(
            f"shadow-step audit mismatch at step {it}: {report.summary()}. "
            f"The committed step and its re-execution from identical inputs "
            f"differ bitwise — silent data corruption on the implicated "
            f"rank(s); quarantine them (restart-in-place re-runs the lying "
            f"core).",
            detector="shadow_audit", implicated_rank=implicated, step=it,
        )

    def _trip(self, state: tuple, it: int, report: FieldReport) -> tuple:
        msg = f"NaN/Inf guard tripped at step {it}: {report.summary()}"
        _telemetry.event(
            "guard.trip", step=it, policy=self.policy, report=report.summary()
        )
        _telemetry.counter("resilience.guard_trips").inc()
        _tracing.dump_flight_recorder(
            "guard.trip", step=it, policy=self.policy, report=report.summary(),
        )
        if self.policy == "raise":
            raise GuardError(msg, step=it, report=report)
        if self.policy == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            return state, it
        # rollback
        if self._last_good is None:
            raise GuardError(
                msg + " — policy='rollback' but no good state was ever "
                "recorded (is guard_every set?)",
                step=it,
                report=report,
            )
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise GuardError(
                msg + f" — giving up after {self.max_rollbacks} rollback(s): "
                "the fault re-occurs deterministically",
                step=it,
                report=report,
            )
        warnings.warn(
            msg + f" — rolling back to step {self._last_good_step}",
            RuntimeWarning,
            stacklevel=3,
        )
        _telemetry.event(
            "guard.rollback", step=it, to_step=self._last_good_step
        )
        _telemetry.counter("resilience.rollbacks").inc()
        return snapshot_state(self._last_good), self._last_good_step
