"""The serving loop: slot pool + request queue over one batched step.

Counterpart of the JAX package's ``serving/loop.py``:

* **Slot pool** — the batched state ``(B, *block)`` per field IS the pool,
  on the grid's device; slot ``k`` holds member ``k``'s block fields (zeros
  when free).  Admission writes a member's state into its slot
  (`models._batched.set_member_state`, in place on the loop's own pool),
  retirement copies it back out (`member_state`): members enter and leave
  mid-flight while the others keep stepping.
* **One step, every member** — each round advances the whole pool through
  ONE batched multi-step (``make_multi_step(..., batch=True)``): one kernel
  launch per group and one exchange per dimension for all B members.
  Members that must not advance (free slots, just-retired members) are
  masked AFTER the step (`select_members`): their state is bit-frozen.  A
  full pool's select is the identity, so it is skipped then.  The step
  must leave its inputs intact (the select keeps the old pool and the
  audit re-runs from it); every cadence does, which
  ``tests/test_torch_serving.py`` pins, and the pool is never written in
  place by a step.
* **Per-member convergence** — the porous PT residual
  (`porous_convection3d.make_batched_residual`) retires member ``k`` when
  its residual drops under ``Request.tol``; diffusion/acoustic members
  retire on their step budget (``Request.max_steps``).
* **Per-member guards** — one batched finite probe per round
  (`check_members_finite`); a non-finite member is rolled back to its last
  good per-slot snapshot (``guard_policy="rollback"``) or evicted
  (``"evict"``, the default).
* **Batched checkpoints** — ``checkpoint_every=N`` rounds writes the whole
  pool plus the slot metadata through `utils.checkpoint.save_checkpoint`,
  in the JAX package's format (slot records keep their trace contexts
  verbatim); a new loop pointed at the same directory resumes mid-flight
  members, and each package resumes the other's pools.

On the card the round synchronises the device once, after the step and
the select, for the ``serving.round_seconds`` histogram; the finite probe
and the residual each read one ``(B,)`` flag vector to the host.

Telemetry: gauges ``serving.active_members``, ``serving.queue_depth``,
``serving.capacity``; counters ``serving.admitted_total``,
``serving.retired_total``, ``serving.converged_total``,
``serving.evicted_total``, ``serving.rollbacks_total``, ``serving.rounds``,
``serving.tenant.<tenant>.steps`` (cardinality-capped); histograms
``serving.round_seconds`` and ``serving.member_t_eff_gbs`` (the member's
must-stream block bytes over the round wall time: per GPU); events
``serving.admit`` / ``retire`` / ``converged`` / ``evict`` / ``rollback``.

Tracing and the live plane: each round is one ``igg.serving.round`` span
carrying every active request's ``trace_id`` (so the exchanges inside it
chain into those requests' trees); construction brings up the per-rank
scrape server (``IGG_METRICS_PORT``); on ``IGG_HEARTBEAT_EVERY`` rounds the
all-ranks skew probe and the live plane's heartbeat tick run, and a
CRITICAL alert escalates into the member guard (`_escalate`).  An audit
mismatch dumps a ``reason=sdc`` flight bundle before `IntegrityError`.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..models import _batched
from ..parallel import grid as _grid
from ..utils import config as _config
from ..utils import liveplane as _liveplane
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing

#: Per-model serving adapter: state field names, which fields the
#: per-member T_eff bytes model counts, and whether the model has a PT
#: residual to mask convergence on.
_MODEL_INFO = {
    "diffusion3d": dict(names=("T", "Cp"), stream=slice(0, 1), residual=False),
    "acoustic3d": dict(names=("P", "Vx", "Vy", "Vz"), stream=slice(0, 4), residual=False),
    "porous_convection3d": dict(
        names=("T", "Pf", "qDx", "qDy", "qDz"), stream=slice(0, 5), residual=True,
    ),
}


@dataclasses.dataclass
class Request:
    """One tenant's simulation request.

    ``state`` is the member's initial state tuple (this rank's block
    fields on the grid's device, matching the loop's model); ``max_steps``
    the retirement budget (>= 1); ``tol`` (models with a residual) retires
    early once the per-member PT residual drops below it.

    Budgets retire at ROUND granularity: the pool advances
    ``steps_per_round`` steps per round for every active member, so a
    member retires at the first round boundary where ``steps >=
    max_steps`` (``MemberResult.steps`` reports the actual count).

    ``trace`` (optional): the request's member-level trace context
    (``{"trace_id", "span_id"}``); it rides the slot and the checkpoint
    slot metadata verbatim.
    """

    state: tuple
    max_steps: int
    tenant: str = "default"
    tol: float | None = None
    trace: dict | None = None


@dataclasses.dataclass
class MemberResult:
    """A retired member: final state + how it ended.

    ``status``: ``"completed"`` (step budget reached), ``"converged"``
    (residual under ``tol``), or ``"evicted"`` (non-finite state; ``state``
    is None — poisoned fields are not handed back).
    """

    member: int
    tenant: str
    status: str
    steps: int
    state: tuple | None
    residual: float | None = None


@dataclasses.dataclass
class _Slot:
    member: int = -1
    tenant: str = ""
    max_steps: int = 0
    tol: float | None = None
    steps: int = 0
    active: bool = False
    snapshot: tuple | None = None
    snapshot_steps: int = 0
    rollbacks: int = 0
    trace: dict | None = None


class ServingLoop:
    """Fixed-capacity batched serving of one model (module docstring).

    ``model`` is a model module (`models.diffusion3d` / `acoustic3d` /
    `porous_convection3d`); ``params`` its `Params` (one physics/numerics
    config per pool — members vary by state).  ``capacity`` defaults to
    ``IGG_BATCH`` (env) else 4; ``steps_per_round`` to
    ``IGG_BATCH_ROUND_STEPS`` else 1.  ``step_kwargs`` pass through to
    ``make_multi_step`` unchanged (``exchange_every``, ``fused_k``, ...: a
    ``steps_per_round`` that is no multiple of ``fused_k`` raises there,
    at construction).  ``guard_policy``: ``"evict"`` | ``"rollback"`` |
    ``"off"``.  ``max_rollbacks`` bounds per-member rollbacks before the
    member is evicted anyway.
    """

    def __init__(
        self,
        model,
        params,
        *,
        capacity: int | None = None,
        steps_per_round: int | None = None,
        guard_policy: str = "evict",
        max_rollbacks: int = 3,
        checkpoint_every: int = 0,
        checkpoint_dir: str | None = None,
        step_kwargs: dict | None = None,
    ):
        name = model.__name__.rsplit(".", 1)[-1]
        if name not in _MODEL_INFO:
            raise ValueError(f"ServingLoop supports {sorted(_MODEL_INFO)}, got {name!r}")
        if guard_policy not in ("evict", "rollback", "off"):
            raise ValueError(
                f"guard_policy must be 'evict', 'rollback' or 'off', got {guard_policy!r}"
            )
        if capacity is None:
            capacity = _config.batch_env() or 4
        if steps_per_round is None:
            steps_per_round = _config.batch_round_steps_env() or 1
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        if steps_per_round < 1:
            raise ValueError(f"steps_per_round must be >= 1 (got {steps_per_round})")
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every > 0 requires a checkpoint_dir")
        self.model = model
        self.model_name = name
        self.info = _MODEL_INFO[name]
        self.params = params
        self.capacity = int(capacity)
        self.steps_per_round = int(steps_per_round)
        self.guard_policy = guard_policy
        self.max_rollbacks = int(max_rollbacks)
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_dir = checkpoint_dir
        # Shadow-step audit cadence (the integrity plane): a batched pool
        # audits ONE sampled member per audited round, re-running the
        # round's step from the retained pre-step pool.  IGG_INTEGRITY=0
        # force-disables, the run guard's pin.
        every = _config.integrity_every_env() or 0
        if _config.integrity_enabled_env() is False:
            every = 0
        self.integrity_every = int(every)
        self.device = _grid.global_grid().device
        self._step = model.make_multi_step(
            params, self.steps_per_round, batch=True, **(step_kwargs or {}),
        )
        self._residual_fn = (
            model.make_batched_residual(params) if self.info["residual"] else None
        )
        self.slots = [_Slot() for _ in range(self.capacity)]
        # (member id, request) pairs awaiting a free slot
        self.queue: collections.deque[tuple[int, Request]] = collections.deque()
        self.results: dict[int, MemberResult] = {}
        # Bounded result retention: members whose result a consumer has
        # read (`mark_consumed`) become prunable under IGG_RESULT_KEEP /
        # IGG_RESULT_TTL_S; unconsumed results are never pruned.
        self._consumed: set[int] = set()
        self._result_ts: dict[int, float] = {}
        self.rounds = 0
        # Graceful drain: slots with index >= drain_above are retiring —
        # no admission there, in-flight members finish normally.
        self.drain_above: int | None = None
        self._next_member = 0
        self._state = None  # built lazily from the first admitted state
        self._blank = None  # zero member state for freed slots
        self._sig = None    # pool field signature: ((block shape, dtype), ...)
        # The live plane: the scrape endpoint is up as soon as the pool
        # exists (no-op unless IGG_METRICS_PORT is set), and the alert
        # stream is polled from this cursor each round.  The cursor starts
        # at the engine's CURRENT seq: alerts fired before this pool existed
        # must not replay as escalations.
        self._alert_seq, _ = _liveplane.alerts_since(float("inf"))
        _liveplane.ensure_server()
        self._publish_gauges()

    # -- pool state -----------------------------------------------------------

    @property
    def active_members(self) -> int:
        return sum(s.active for s in self.slots)

    def _publish_gauges(self) -> None:
        """The one writer of the pool-occupancy gauges (``/healthz``'s
        ``serving`` section; admission and the autoscaler key on them)."""
        _telemetry.gauge("serving.queue_depth").set(len(self.queue))
        _telemetry.gauge("serving.active_members").set(self.active_members)
        _telemetry.gauge("serving.capacity").set(self.capacity)

    def drained(self, capacity: int) -> bool:
        """No member occupies a slot at/above ``capacity`` — the scale-down
        readiness check (`serving.autoscale`)."""
        return all(not s.active for s in self.slots[capacity:])

    def _ensure_pool(self, like_state: tuple) -> None:
        """Build the B-slot pool from the first member's field signature."""
        if self._state is not None:
            return
        self._blank = tuple(torch.zeros_like(A) for A in like_state)
        self._state = _batched.stack_states([self._blank] * self.capacity)
        if self._sig is None:
            # prime() path: the pool's signature comes from the priming
            # state, so the first submit after a resume is validated.
            self._sig = self._state_sig(like_state)

    def _mask(self) -> np.ndarray:
        return np.asarray([s.active for s in self.slots], bool)

    @staticmethod
    def _state_sig(state) -> tuple:
        return tuple((tuple(A.shape), str(A.dtype)) for A in state)

    def _check_signature(self, state) -> None:
        """Reject, AT SUBMIT TIME, a member state that does not match the
        pool's field signature or does not live on the grid's device:
        `set_member_state` zips fields and casts dtypes, and a pool on the
        card never steps a member on the CPU.  The first state seen (first
        submit or `prime`) defines the signature."""
        for A in state:
            if not isinstance(A, torch.Tensor) or A.device != self.device:
                where = A.device if isinstance(A, torch.Tensor) else type(A).__name__
                raise ValueError(
                    f"request state fields must be tensors on the grid's device "
                    f"{self.device}; got {where}."
                )
        sig = self._state_sig(state)
        if self._sig is None:
            nf = len(self.info["names"])
            if len(sig) != nf:
                raise ValueError(
                    f"{self.model_name} state has fields {self.info['names']}; got "
                    f"{len(sig)} field(s)."
                )
            self._sig = sig
            return
        if sig != self._sig:
            raise ValueError(
                f"request state signature {sig} does not match the pool's {self._sig} — "
                f"one pool serves one field signature (same grid, same dtype)."
            )

    # -- admission ------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue one request; returns its member id.  Admission into a free
        slot happens immediately when one is available, else at the next
        round boundary after a retirement frees one.  Invalid requests are
        rejected HERE, before anything is queued or written into the pool."""
        if request.tol is not None and not self.info["residual"]:
            raise ValueError(
                f"{self.model_name} has no PT residual; tol applies to porous members only "
                f"(use max_steps)."
            )
        if int(request.max_steps) < 1:
            raise ValueError(f"max_steps must be >= 1 (got {request.max_steps})")
        self._check_signature(request.state)
        member = self._next_member
        self._next_member += 1
        self.queue.append((member, request))
        self._admit_from_queue()
        return member

    def enqueue_restored(self, member: int, request: Request) -> None:
        """Re-queue a member under its ORIGINAL id (the front door's
        elastic-resume path).  Validation mirrors `submit`; the id counter
        advances past the restored id."""
        if int(request.max_steps) < 1:
            raise ValueError(f"max_steps must be >= 1 (got {request.max_steps})")
        self._check_signature(request.state)
        self._next_member = max(self._next_member, int(member) + 1)
        self.queue.append((int(member), request))
        self._admit_from_queue()

    def adopt(self, rec: dict, state: tuple) -> int:
        """Place a RESTORED member (slot metadata dict from `_serving_meta`,
        state cut out of a restored pool) into the first free non-retiring
        slot, keeping its member id, tenant, step count and budget.  Returns
        the slot index; raises when no slot is free."""
        self._check_signature(tuple(state))
        self._ensure_pool(tuple(state))
        for k, slot in enumerate(self.slots):
            if slot.active or (self.drain_above is not None and k >= self.drain_above):
                continue
            self._state = _batched.set_member_state(self._state, tuple(state), k)
            self.slots[k] = _Slot(
                member=int(rec["member"]), tenant=rec.get("tenant", ""),
                max_steps=int(rec["max_steps"]), tol=rec.get("tol"),
                steps=int(rec.get("steps", 0)), active=True, trace=rec.get("trace"),
            )
            if self.guard_policy == "rollback":
                self.slots[k].snapshot = _batched.member_state(self._state, k)
                self.slots[k].snapshot_steps = self.slots[k].steps
            self._next_member = max(self._next_member, int(rec["member"]) + 1)
            _telemetry.event(
                "serving.admit", member=int(rec["member"]), slot=k,
                tenant=rec.get("tenant", ""), max_steps=int(rec["max_steps"]),
                tol=rec.get("tol"), resumed=True,
            )
            self._publish_gauges()
            return k
        raise RuntimeError(
            f"adopt: no free slot for restored member {rec.get('member')} (capacity "
            f"{self.capacity}, drain_above {self.drain_above}) — drain the pool below the "
            f"target capacity before resizing down."
        )

    def _admit_from_queue(self) -> None:
        for k, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot.active or (self.drain_above is not None and k >= self.drain_above):
                continue  # a retiring slot never admits again
            member, req = self.queue.popleft()
            self._ensure_pool(req.state)
            self._state = _batched.set_member_state(self._state, req.state, k)
            self.slots[k] = _Slot(
                member=member, tenant=req.tenant, max_steps=int(req.max_steps),
                tol=req.tol, active=True, trace=req.trace,
            )
            if self.guard_policy == "rollback":
                self.slots[k].snapshot = _batched.member_state(self._state, k)
                self.slots[k].snapshot_steps = 0
            _telemetry.counter("serving.admitted_total").inc()
            _telemetry.event(
                "serving.admit", member=member, slot=k, tenant=req.tenant,
                max_steps=int(req.max_steps), tol=req.tol,
            )
        self._publish_gauges()

    # -- retirement -----------------------------------------------------------

    def _retire(self, k: int, status: str, residual: float | None = None):
        slot = self.slots[k]
        state = None if status == "evicted" else _batched.member_state(self._state, k)
        self.results[slot.member] = MemberResult(
            member=slot.member, tenant=slot.tenant, status=status, steps=slot.steps,
            state=state, residual=residual,
        )
        self._result_ts[slot.member] = time.monotonic()
        _telemetry.counter("serving.retired_total").inc()
        etype = {"completed": "serving.retire", "converged": "serving.converged",
                 "evicted": "serving.evict"}[status]
        if status == "converged":
            _telemetry.counter("serving.converged_total").inc()
        if status == "evicted":
            _telemetry.counter("serving.evicted_total").inc()
        _telemetry.event(
            etype, member=slot.member, slot=k, tenant=slot.tenant, steps=slot.steps,
            status=status, residual=residual,
        )
        # Blank the freed slot: an idle slot never leaks the retired
        # member's fields into a later snapshot or result.
        self._state = _batched.set_member_state(self._state, self._blank, k)
        self.slots[k] = _Slot()
        self._publish_gauges()
        self._maybe_disarm_convergence()

    def mark_consumed(self, member: int) -> None:
        """Declare ``member``'s result read: it becomes prunable under the
        ``IGG_RESULT_KEEP`` / ``IGG_RESULT_TTL_S`` retention bounds."""
        if member in self.results:
            self._consumed.add(member)

    def _prune_results(self) -> None:
        """Apply the retention bounds to CONSUMED results (round end):
        ``IGG_RESULT_KEEP`` keeps the newest N (0/unset = all),
        ``IGG_RESULT_TTL_S`` drops those older than the bound."""
        keep = _config.result_keep_env() or 0
        ttl = _config.result_ttl_env()
        if not keep and ttl is None:
            return
        consumed = sorted(m for m in self.results if m in self._consumed)
        doomed: list[int] = []
        if ttl is not None:
            now = time.monotonic()
            doomed += [m for m in consumed if now - self._result_ts.get(m, now) > ttl]
        if keep:
            fresh = [m for m in consumed if m not in set(doomed)]
            if len(fresh) > keep:
                doomed += fresh[:-keep]
        for m in doomed:
            del self.results[m]
            self._consumed.discard(m)
            self._result_ts.pop(m, None)
        if doomed:
            _telemetry.counter("serving.results_pruned_total").inc(len(doomed))
            _telemetry.event("serving.results_pruned", members=doomed, kept=len(self.results))

    def _maybe_disarm_convergence(self) -> None:
        if self._residual_fn is not None and not any(
            s.active and s.tol is not None for s in self.slots
        ):
            _telemetry.gauge("serving.pt_residual_watched").set(0)

    # -- the round ------------------------------------------------------------

    def run_round(self) -> None:
        """One serving round: step active members, guard, retire, admit,
        under one ``igg.serving.round`` span."""
        self._admit_from_queue()
        mask = self._mask()
        members = [
            {"member": s.member, "slot": k, "tenant": s.tenant,
             **({"trace": s.trace} if s.trace else {})}
            for k, s in enumerate(self.slots)
            if s.active
        ]
        # The round advances MANY requests at once: the span carries every
        # active request's context (the multi-request form), so anything
        # nested under the round — exchanges, audits, checkpoint saves —
        # inherits the same trace_ids.
        trace_ids = sorted({m["trace"]["trace_id"] for m in members if "trace" in m})
        round_ctx = {"trace_ids": trace_ids} if trace_ids else None
        with _tracing.use_context(round_ctx), _tracing.trace_span(
            "igg.serving.round", round=self.rounds, members=members, queued=len(self.queue),
        ):
            self._round(mask)

    def _round(self, mask: np.ndarray) -> None:
        dt = 0.0
        if self._state is not None and mask.any():
            t0 = time.perf_counter()
            new = self._step(*self._state)
            if self.integrity_every and (self.rounds + 1) % self.integrity_every == 0:
                # Before the select: the audit re-runs from the pre-step pool.
                self._audit_member(new, mask)
            # Masking AFTER the step bit-freezes non-running members; a full
            # pool's select is the identity and is skipped.
            self._state = tuple(new) if mask.all() else _batched.select_members(
                mask, new, self._state)
            if self.device.type == "cuda":  # the round's one device sync
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            _telemetry.histogram("serving.round_seconds").record(dt)
            for slot in self.slots:
                if slot.active:
                    slot.steps += self.steps_per_round
                    _telemetry.tenant_counter(slot.tenant).inc(self.steps_per_round)
            if dt > 0:
                member_bytes = _telemetry.teff_bytes(
                    self._blank[self.info["stream"]]) * self.steps_per_round
                gbs = member_bytes / dt / 1e9
                for slot in self.slots:
                    if slot.active:
                        _telemetry.histogram("serving.member_t_eff_gbs").record(gbs)
            self._guard(mask)
            self._convergence()
        # Step-budget retirement (after the guard: never hand back unguarded
        # state) and back-fill from the queue.
        for k, slot in enumerate(self.slots):
            if slot.active and slot.steps >= slot.max_steps:
                self._retire(k, "completed")
        self.rounds += 1
        _telemetry.counter("serving.rounds").inc()
        if _telemetry.enabled():
            _telemetry.note_progress("serving.round", self.rounds)
            hb = _config.heartbeat_every_env() or 0
            # The gate must be rank-uniform (the probe is a collective):
            # rounds and mask derive from the admit/retire sequence every
            # rank drives identically, never from a locally measured time.
            if hb and self.rounds % hb == 0:
                if mask.any():
                    _tracing.skew_probe(dt / self.steps_per_round)
                # The live-plane tick is strictly local (slo gauges and the
                # anomaly rules, no collective).
                rss = _telemetry.proc_rss_bytes()
                if rss is not None:
                    _telemetry.gauge("proc.rss_bytes").set(rss)
                _liveplane.heartbeat_tick(model="serving")
            # The alert stream: a CRITICAL anomaly escalates into the
            # guard/evict machinery instead of scrolling past.
            self._alert_seq, fresh = _liveplane.alerts_since(self._alert_seq)
            for alert in fresh:
                if alert.get("severity") == "critical":
                    self._escalate(alert)
        if (self.checkpoint_every and self.rounds % self.checkpoint_every == 0
                and self._state is not None):
            self._save_checkpoint()
        self._admit_from_queue()
        self._prune_results()

    def _audit_member(self, new, mask: np.ndarray) -> None:
        """Shadow-step audit of ONE sampled member (integrity plane).

        Re-runs the round's multi-step from the retained pre-step pool and
        bit-compares the sampled member's fields (`integrity.audit_fields`,
        collective).  The sample is round-robin over the active slots keyed
        on the round counter, rank-uniform by construction.  A mismatch is
        recorded (``integrity.audit_mismatch``), dumps the ``reason=sdc``
        flight bundle naming the implicated rank and raises
        `IntegrityError`."""
        active = [k for k, s in enumerate(self.slots) if s.active and mask[k]]
        if not active:
            return
        k = active[self.rounds % len(active)]
        from ..integrity import IntegrityError, audit_fields

        redone = self._step(*self._state)
        report = audit_fields(
            _batched.member_state(tuple(new), k), _batched.member_state(tuple(redone), k),
            names=self.info["names"],
        )
        _telemetry.counter("integrity.audits").inc()
        if report.ok:
            return
        slot = self.slots[k]
        implicated = report.implicated_ranks[0] if report.implicated_ranks else None
        _telemetry.counter("integrity.audit_mismatches").inc()
        _telemetry.event(
            "integrity.audit_mismatch", detector="shadow_audit", round=self.rounds,
            member=slot.member, slot=k, tenant=slot.tenant, fields=list(report.bad_blocks),
            implicated_ranks=list(report.implicated_ranks),
        )
        _tracing.dump_flight_recorder(
            "sdc", detector="shadow_audit", round=self.rounds, member=slot.member, slot=k,
            implicated_rank=implicated, implicated_ranks=list(report.implicated_ranks),
            report=report.summary(),
        )
        raise IntegrityError(
            f"silent data corruption: serving round {self.rounds} member {slot.member} "
            f"(slot {k}) does not bit-reproduce on re-execution — {report.summary()}",
            detector="shadow_audit", implicated_rank=implicated, step=self.rounds,
        )

    def _guard(self, mask: np.ndarray) -> None:
        if self.guard_policy == "off":
            return
        bad = _batched.check_members_finite(self._state)
        for k in np.flatnonzero(bad & mask):
            slot = self.slots[int(k)]
            if (self.guard_policy == "rollback" and slot.snapshot is not None
                    and slot.rollbacks < self.max_rollbacks):
                slot.rollbacks += 1
                self._state = _batched.set_member_state(self._state, slot.snapshot, int(k))
                slot.steps = slot.snapshot_steps
                _telemetry.counter("serving.rollbacks_total").inc()
                _telemetry.event(
                    "serving.rollback", member=slot.member, slot=int(k), tenant=slot.tenant,
                    to_steps=slot.snapshot_steps, rollbacks=slot.rollbacks,
                )
            else:
                self._retire(int(k), "evicted")
        if self.guard_policy == "rollback":
            # Refresh per-slot snapshots from guard-passed state only.
            still = ~_batched.check_members_finite(self._state) if bad.any() else ~bad
            for k, slot in enumerate(self.slots):
                if slot.active and still[k]:
                    slot.snapshot = _batched.member_state(self._state, k)
                    slot.snapshot_steps = slot.steps

    def _escalate(self, alert: dict) -> None:
        """React to one CRITICAL live-plane alert: event always; on
        single-process pools also force an immediate member-finite sweep
        through the evict machinery (a rank-local alert must never mutate
        the SPMD pool state across processes)."""
        _telemetry.counter("serving.alert_escalations").inc()
        _telemetry.event(
            "serving.alert_escalation", rule=alert.get("rule"),
            severity=alert.get("severity"), evidence=alert.get("evidence"),
        )
        if self._state is None or _telemetry.process_count() > 1:
            return
        mask = self._mask()
        if not mask.any():
            return
        if self.guard_policy == "off":
            # the per-round sweep is off: run one forced evict-mode sweep
            bad = _batched.check_members_finite(self._state)
            for k in np.flatnonzero(bad & mask):
                self._retire(int(k), "evicted")
        else:
            self._guard(mask)

    def _convergence(self) -> None:
        if self._residual_fn is None:
            return
        if not any(s.active and s.tol is not None for s in self.slots):
            _telemetry.gauge("serving.pt_residual_watched").set(0)
            return
        res = self._residual_fn(*self._state).cpu().numpy()
        watched = [float(res[k]) for k, slot in enumerate(self.slots)
                   if slot.active and slot.tol is not None]
        if watched:
            _telemetry.gauge("serving.pt_residual_min").set(min(watched))
            _telemetry.gauge("serving.pt_residual_watched").set(len(watched))
        for k, slot in enumerate(self.slots):
            if slot.active and slot.tol is not None and float(res[k]) < slot.tol:
                self._retire(k, "converged", residual=float(res[k]))

    def run(self, max_rounds: int | None = None) -> dict[int, MemberResult]:
        """Drive rounds until the queue and the pool are empty (or
        ``max_rounds`` is hit).  Returns the results map."""
        n = 0
        while (self.queue or self.active_members) and (max_rounds is None or n < max_rounds):
            self.run_round()
            n += 1
        if _telemetry.enabled() and not (self.queue or self.active_members):
            # A drained pool is idle, not stalled.
            _telemetry.note_progress("serving.round", self.rounds, done=True)
        return self.results

    # -- batched checkpointing ------------------------------------------------

    def _serving_meta(self) -> dict:
        return {
            "serving": {
                "model": self.model_name,
                "rounds": self.rounds,
                "next_member": self._next_member,
                "slots": [
                    {"member": s.member, "tenant": s.tenant, "max_steps": s.max_steps,
                     "tol": s.tol, "steps": s.steps, "active": s.active, "trace": s.trace}
                    for s in self.slots
                ],
            }
        }

    def _save_checkpoint(self) -> str:
        from ..utils import checkpoint as _ckpt

        return _ckpt.save_checkpoint(self.checkpoint_dir, self._state, self.rounds,
                                     extra=self._serving_meta())

    def prime(self, like_state: tuple) -> None:
        """Build the (empty) slot pool from one member state's field
        signature WITHOUT admitting anything — the priming step `resume()`
        needs (restore writes into a ``like=`` pool of the right shapes)."""
        self._check_signature(tuple(like_state))
        self._ensure_pool(tuple(like_state))

    def resume(self) -> bool:
        """Restore pool + slot metadata from ``checkpoint_dir`` (strict
        same-topology restore).  Returns True when a checkpoint was found.
        Queue contents are not persisted.  Requires a `prime`-d, still-EMPTY
        pool: resuming over live members would destroy them, so that is
        refused."""
        from ..utils import checkpoint as _ckpt

        latest = _ckpt.latest_checkpoint(self.checkpoint_dir)
        if latest is None:
            return False
        if self._state is None:
            raise RuntimeError(
                "resume() needs the pool built first: call loop.prime(member_state) with one "
                "state of the right signature before resuming."
            )
        if self.active_members or self.queue:
            raise RuntimeError(
                "resume() would overwrite live members: restore into a fresh loop (prime + "
                "resume) before submitting requests."
            )
        meta = _ckpt.checkpoint_meta(latest).get("extra", {}).get("serving", {})
        if meta.get("model") != self.model_name:
            raise ValueError(
                f"checkpoint is a {meta.get('model')!r} pool, this loop serves "
                f"{self.model_name!r}"
            )
        state, rounds, _ = _ckpt.restore_checkpoint(latest, like=self._state, strict=True,
                                                     verify=False)
        self._state = state
        self.rounds = int(rounds)
        self._next_member = int(meta.get("next_member", self._next_member))
        for k, rec in enumerate(meta.get("slots", [])[: self.capacity]):
            self.slots[k] = _Slot(
                member=int(rec["member"]), tenant=rec["tenant"],
                max_steps=int(rec["max_steps"]), tol=rec["tol"], steps=int(rec["steps"]),
                active=bool(rec["active"]), trace=rec.get("trace"),
            )
            if self.guard_policy == "rollback" and self.slots[k].active:
                self.slots[k].snapshot = _batched.member_state(self._state, k)
                self.slots[k].snapshot_steps = self.slots[k].steps
        self._publish_gauges()
        return True
