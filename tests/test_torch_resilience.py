"""The port's resilience layer against the JAX package's.

Ports the cases of the JAX package's ``tests/test_resilience.py`` that have
a meaning in the port — guarded bring-up, `check_fields` and its block
coordinates, the three guard policies, fault injection, `RunGuard` and its
configuration tiers — and holds what both packages compute from the same
inputs equal: backoff schedules, the fault-spec grammar and its seeded
``chaos`` expansion, the environment readers' messages.  Everything here is
exact (schedules, strings, bits); no comparison has a tolerance.  Each test
pins its dtypes and finalizes the port's grid.  The two-rank legs (block
coordinates across ranks, the ``worker_crash`` drill) run in
``tests/test_torch_checkpoint.py``'s shared spawns.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.utils import config as jcfg
from implicitglobalgrid_tpu.utils import resilience as jres
from implicitglobalgrid_tpu_torch.models import _batched
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import halo as thalo
from implicitglobalgrid_tpu_torch.parallel import distributed as tdist
from implicitglobalgrid_tpu_torch.parallel import grid as tgrid
from implicitglobalgrid_tpu_torch.utils import config as tcfg
from implicitglobalgrid_tpu_torch.utils import resilience as res
from implicitglobalgrid_tpu_torch.utils import telemetry as tele

NX = 8
KW = dict(quiet=True, device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    thalo.set_post_exchange_hook(None)
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    res.reset_fault_injector()
    yield
    res.reset_fault_injector()


@pytest.fixture
def fault_injection(monkeypatch):
    """Arm ``IGG_FAULT_INJECT`` for one test (the port's counterpart of the
    JAX package's conftest fixture); ``hook=True`` also wires the injector
    into `update_halo`'s post-exchange hook."""

    def arm(spec, hook=False):
        monkeypatch.setenv("IGG_FAULT_INJECT", spec)
        res.reset_fault_injector()
        if hook:
            res.install_halo_fault_hook()
        return res.get_fault_injector()

    yield arm
    thalo.set_post_exchange_hook(None)
    res.reset_fault_injector()


# -- backoff / retry -------------------------------------------------------------


def test_backoff_schedule_deterministic_and_equal_to_jax():
    a = res.backoff_schedule(6, base_s=0.5, jitter=0.5, seed=123)
    assert a == res.backoff_schedule(6, base_s=0.5, jitter=0.5, seed=123)
    assert a == jres.backoff_schedule(6, base_s=0.5, jitter=0.5, seed=123)
    assert a != res.backoff_schedule(6, base_s=0.5, jitter=0.5, seed=124)
    for i, d in enumerate(a):
        lo = min(0.5 * 2**i, 30.0)
        assert lo <= d <= lo * 1.5
    assert res.backoff_schedule(4, base_s=1.0, jitter=0.0) == [1.0, 2.0, 4.0, 8.0]
    assert res.backoff_schedule(0, base_s=1.0) == []


def test_backoff_schedule_validation():
    with pytest.raises(ValueError, match="retries"):
        res.backoff_schedule(-1)
    with pytest.raises(ValueError, match="base_s"):
        res.backoff_schedule(2, base_s=0)
    with pytest.raises(ValueError, match="jitter"):
        res.backoff_schedule(2, jitter=-1)


def test_retry_call_recovers_and_sleeps_the_schedule():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("rendezvous race")
        return "up"

    out = res.retry_call(flaky, retries=4, base_backoff_s=0.25, jitter=0.5, seed=9,
                         sleep=slept.append, on_retry=lambda *a: None)
    assert out == "up" and len(calls) == 3
    assert slept == res.backoff_schedule(4, base_s=0.25, jitter=0.5, seed=9)[:2]


def test_retry_call_exhaustion_and_deadline():
    with pytest.raises(RuntimeError, match="IGG_INIT_RETRIES"):
        res.retry_call(lambda: (_ for _ in ()).throw(OSError("down")), retries=1,
                       base_backoff_s=0.001, sleep=lambda s: None, on_retry=lambda *a: None)
    t = [0.0]

    def fail():
        t[0] += 10.0
        raise OSError("down")

    with pytest.raises(RuntimeError, match="deadline"):
        res.retry_call(fail, retries=5, timeout_s=12.0, base_backoff_s=4.0, jitter=0.0,
                       sleep=lambda s: None, clock=lambda: t[0], on_retry=lambda *a: None)


@pytest.fixture
def fake_group(monkeypatch):
    """`init_distributed`'s environment, with `init_process_group` replaced
    by a recorder (no group comes up)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    attempts = []
    monkeypatch.setattr(tdist.dist, "init_process_group", lambda *a, **kw: attempts.append(kw))
    yield attempts
    tdist._owns_runtime = False


def test_init_distributed_retries_through_injected_flakes(clean_env, fault_injection,
                                                          fake_group):
    fault_injection("init_flake:2")
    tdist.init_distributed(torch.device("cpu"), retries=3, timeout_s=60, backoff_s=0.001)
    assert len(fake_group) == 1 and tdist.owns_runtime()  # two flakes, then the join


def test_init_distributed_env_tier_precedence(clean_env, monkeypatch, fault_injection,
                                              fake_group):
    monkeypatch.setenv("IGG_INIT_RETRIES", "0")
    monkeypatch.setenv("IGG_INIT_BACKOFF_S", "0.001")
    fault_injection("init_flake:1")
    with pytest.raises(RuntimeError, match="IGG_INIT_RETRIES"):
        tdist.init_distributed(torch.device("cpu"))
    fault_injection("init_flake:1")
    tdist.init_distributed(torch.device("cpu"), retries=1)  # the kwarg beats the env
    assert tdist.owns_runtime()
    with pytest.raises(ValueError, match="timeout_s"):
        tdist._owns_runtime = False
        tdist.init_distributed(torch.device("cpu"), timeout_s=0)


#: (env var, bad value, reader name) — every reader's message is JAX's.
ENV_CASES = [
    ("IGG_INIT_RETRIES", "-3", "init_retries_env"),
    ("IGG_INIT_TIMEOUT_S", "0", "init_timeout_env"),
    ("IGG_INIT_BACKOFF_S", "nope", "init_backoff_env"),
    ("IGG_WATCHDOG_S", "-1", "watchdog_env"),
    ("IGG_GUARD_POLICY", "explode", "guard_policy_env"),
    ("IGG_GUARD_EVERY", "-1", "guard_every_env"),
    ("IGG_CHECKPOINT_EVERY", "x", "checkpoint_every_env"),
    ("IGG_CHECKPOINT_KEEP", "-2", "checkpoint_keep_env"),
    ("IGG_INTEGRITY", "on", "integrity_enabled_env"),
    ("IGG_INTEGRITY_EVERY", "-1", "integrity_every_env"),
    ("IGG_GENERATION", "-1", "generation_env"),
]


@pytest.mark.parametrize("var,bad,reader", ENV_CASES, ids=[c[0] for c in ENV_CASES])
def test_env_readers_match_jax(clean_env, monkeypatch, var, bad, reader):
    with pytest.raises(ValueError) as je:
        monkeypatch.setenv(var, bad)
        getattr(jcfg, reader)()
    with pytest.raises(ValueError) as te:
        getattr(tcfg, reader)()
    assert str(te.value) == str(je.value) and var in str(te.value)
    good = {"IGG_GUARD_POLICY": "rollback", "IGG_INIT_TIMEOUT_S": "2.5",
            "IGG_INIT_BACKOFF_S": "0.5", "IGG_WATCHDOG_S": "0"}.get(var, "3")
    monkeypatch.setenv(var, good)
    assert getattr(tcfg, reader)() == getattr(jcfg, reader)()
    monkeypatch.delenv(var)
    assert getattr(tcfg, reader)() is None
    assert tcfg.GUARD_POLICIES == jcfg.GUARD_POLICIES


def test_string_env_readers(clean_env, monkeypatch):
    for var, reader in (("IGG_CHECKPOINT_DIR", "checkpoint_dir_env"),
                        ("IGG_FAULT_INJECT", "fault_inject_env"),
                        ("IGG_FENCE_DIR", "fence_dir_env")):
        assert getattr(tcfg, reader)() is None
        monkeypatch.setenv(var, "x")
        assert getattr(tcfg, reader)() == getattr(jcfg, reader)() == "x"


def test_watchdog_nesting_rearms_outer_strictest_wins(monkeypatch):
    import faulthandler

    armed = []
    monkeypatch.setattr(faulthandler, "dump_traceback_later",
                        lambda t, **kw: armed.append((t, kw.get("exit", False))))
    monkeypatch.setattr(faulthandler, "cancel_dump_traceback_later", lambda: armed.append(None))
    assert res._watchdog_stack == []
    with res.watchdog(120, exit=True):
        assert armed[-1] == (120.0, True)
        with res.watchdog(600):
            assert armed[-1] == (120.0, True) and len(res._watchdog_stack) == 2
        with res.watchdog(60):
            assert armed[-1] == (60.0, True)
        assert armed[-1] == (120.0, True)
    assert armed[-1] is None and res._watchdog_stack == []
    res.arm_watchdog(90)
    assert armed[-1] == (90.0, False)
    res.disarm_watchdog()
    assert armed[-1] is None and res._watchdog_stack == []
    with res.watchdog(None):
        pass
    assert tigg.watchdog is res.watchdog


# -- numerical guards -------------------------------------------------------------


def test_check_fields_all_finite_and_integer_fields():
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = tigg.ones((NX, NX, NX), dtype=torch.float64)
    report = tigg.check_fields(T, names=("T",))
    assert report.ok and "all finite" in report.summary()
    assert tigg.check_fields(tigg.full((NX, NX, NX), 3, dtype=torch.int32)).ok
    with pytest.raises(ValueError, match="names has 2 entries"):
        tigg.check_fields(T, names=("a", "b"))
    with pytest.raises(ValueError, match="at least one field"):
        tigg.check_fields()


@pytest.mark.parametrize(
    "dtype",
    [torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.complex128,
     torch.int32, torch.bool],
)
def test_nonfinite_flags_equal_the_mask_form(dtype):
    """The one-pass probe that `check_fields` and `check_members_finite`
    share gives the verdict of a full ``isfinite`` mask, per field and per
    member, for NaN, +Inf and -Inf alike."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.standard_normal((4, 3, 5, 6))).to(dtype)
    cases = [A]
    if dtype.is_floating_point or dtype.is_complex:
        for k, bad in enumerate((float("nan"), float("inf"), -float("inf"))):
            B = A.clone()
            B[k + 1, 2, 1, k] = bad
            cases.append(B)
    for B in cases:
        mask = ~torch.isfinite(B)
        assert bool(res.nonfinite_flags(B)) == bool(mask.any())
        assert res.nonfinite_flags(B, per_member=True).tolist() == mask.flatten(1).any(1).tolist()
    assert not bool(res.nonfinite_flags(A[:0]))
    assert res.nonfinite_flags(A[:, :0], per_member=True).tolist() == [False] * 4


def _as_block(coords, dims):
    """Make the one-process grid claim block ``coords`` of ``dims`` (the
    report's coordinates without spawning ranks)."""
    gg = tgrid.global_grid()
    tgrid.set_global_grid(gg.replace(coords=tuple(coords), dims=tuple(dims)))


def test_check_fields_reports_owning_block_coords():
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _as_block((1, 0, 1), (2, 2, 2))
    T = torch.zeros(NX, NX, NX, dtype=torch.float64)
    C = torch.ones(NX, NX, NX, dtype=torch.float32)
    T[1, 1, 1] = float("inf")
    report = tigg.check_fields(T, C, names=("T", "C"))
    assert report.bad_blocks == {"T": ((1, 0, 1),)}
    assert "T: block(s) (1, 0, 1)" in report.summary()


def test_check_fields_lower_rank_and_batched_fields():
    """A 2-D field's missing coordinates clamp to 0 (ranks holding copies
    report one block); a batched field reports the block, not the member."""
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _as_block((0, 1, 1), (2, 2, 2))
    F = torch.zeros(NX, NX, dtype=torch.float64)
    F[1, 1] = float("nan")
    assert tigg.check_fields(F, names=("F",)).bad_blocks == {"F": ((0, 1, 0),)}
    B = torch.zeros(3, NX, NX, NX, dtype=torch.float32)
    B[2, 4, 4, 4] = float("nan")
    assert tigg.check_fields(B, names=("B",)).bad_blocks == {"B": ((0, 1, 1),)}


def test_guard_trips_at_exact_step_with_block_coords(clean_env, fault_injection):
    fault_injection("halo_corrupt:step3")
    with pytest.raises(tigg.GuardError) as ei:
        td.run(6, NX, NX, NX, guard_every=1, guard_policy="raise", **KW)
    assert ei.value.step == 3
    assert "(0, 0, 0)" in str(ei.value) and not ei.value.report.ok
    assert not tigg.grid_is_initialized()  # failed run tore the grid down
    fault_injection("halo_corrupt:step3:block5")
    with pytest.raises(ValueError, match="block 5 is out of range"):
        td.run(6, NX, NX, NX, guard_every=1, **KW)


def test_guard_trips_within_guard_every_steps(clean_env, fault_injection):
    fault_injection("halo_corrupt:step3")
    with pytest.raises(tigg.GuardError) as ei:
        td.run(8, NX, NX, NX, guard_every=2, guard_policy="raise", **KW)
    assert ei.value.step == 4  # injected at 3, first probe after is step 4


def test_checkpoint_step_is_guarded_between_probe_points(clean_env, fault_injection,
                                                          tmp_path):
    fault_injection("halo_corrupt:step2")
    with pytest.raises(tigg.GuardError) as ei:
        td.run(6, NX, NX, NX, guard_every=3, guard_policy="raise", checkpoint_every=2,
               checkpoint_dir=tmp_path, **KW)
    assert ei.value.step == 2
    assert tigg.latest_checkpoint(tmp_path) is None  # nothing poisoned on disk


def test_guard_policy_warn_continues(clean_env, fault_injection):
    fault_injection("halo_corrupt:step2")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        T = td.run(4, NX, NX, NX, guard_every=1, guard_policy="warn", **KW)
    assert any("guard tripped at step 2" in str(x.message) for x in w)
    assert not torch.isfinite(T).all()  # warn lets the NaN spread


@pytest.mark.parametrize("model,kw", [(td, {}), (ta, {}), (tpc, dict(npt=2))],
                         ids=["diffusion", "acoustic", "porous"])
def test_guard_policy_rollback_completes_finite(clean_env, fault_injection, model, kw):
    """The rolled-back run reproduces the fault-free run bit for bit (the
    injector fires once; the rollback replays from the last good state)."""
    fault_injection("halo_corrupt:step3")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        T = model.run(6, NX, NX, NX, guard_every=1, guard_policy="rollback", **KW, **kw)
    assert torch.isfinite(T).all()
    assert any("rolling back to step 2" in str(x.message) for x in w)
    res.reset_fault_injector()
    os.environ.pop("IGG_FAULT_INJECT", None)
    assert torch.equal(T, model.run(6, NX, NX, NX, **KW, **kw))


def test_rollback_gives_up_after_max_rollbacks(clean_env):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")

    def poison(T):
        T = T + 1
        T[2, 2, 2] = float("nan")
        return (T,)

    guard = res.RunGuard(guard_every=1, policy="rollback", names=("T",), max_rollbacks=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(tigg.GuardError, match="giving up after 2 rollback"):
            res.guarded_time_loop(poison, (torch.zeros(4, 4, 4),), 3, guard=guard)
    with pytest.raises(tigg.GuardError, match="no good state"):
        guard = res.RunGuard(guard_every=1, policy="rollback", names=("T",))
        guard._trip((torch.zeros(1),), 1, tigg.FieldReport(("T",), {"T": ((0, 0, 0),)}))


def test_halo_hook_corruption_tripped_by_direct_check(clean_env, fault_injection):
    """The `update_halo` hook point: corruption of a direct call is visible
    to `check_fields`."""
    fault_injection("halo_corrupt:step1", hook=True)
    tigg.init_global_grid(NX, NX, NX, periodx=1, quiet=True, device="cpu")
    T = tigg.update_halo(tigg.ones((NX, NX, NX), dtype=torch.float64))
    report = tigg.check_fields(T, names=("T",))
    assert report.bad_blocks["T"] == ((0, 0, 0),)
    assert torch.isnan(T[1, 1, 1])
    T = tigg.update_halo(tigg.ones((NX, NX, NX), dtype=torch.float64))  # fired once
    assert tigg.check_fields(T).ok


# -- fault injection ----------------------------------------------------------------


SPECS = ["init_flake:2", "halo_corrupt:step3:block5", "worker_crash:step7:proc1",
         "stall:step2", "net_delay:step4:proc0", "ckpt_corrupt:step4",
         "ckpt_truncate:step7:shard1", "bit_flip:step3:T:proc2",
         "bit_flip:step4:transport", "bit_flip:step5:ckpt:proc1", "bit_flip:step6"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_like_jax(spec):
    t, j = res.FaultInjector.from_spec(spec), jres.FaultInjector.from_spec(spec)
    assert (t.kind, t.step, t.target, t.count, t.field) == (j.kind, j.step, j.target,
                                                            j.count, j.field)
    assert t.spec() == j.spec() == spec


BAD_SPECS = ["cosmic_ray:step1", "init_flake:two", "halo_corrupt:12",
             "halo_corrupt:step2:proc1", "halo_corrupt:stepx", "ckpt_corrupt:step2:proc1",
             "bit_flip:step3:2", "bit_flip:step3:T:U", "bit_flip:step3:proc1:proc2",
             "chaos:seed=1", "chaos:seed=1:rate=2", "chaos:seed=1:rate=0.5:color=red"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_raise_jax_messages(spec):
    with pytest.raises(ValueError) as je:
        jres.expand_fault_spec(spec)
    with pytest.raises(ValueError) as te:
        res.expand_fault_spec(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec", ["chaos:seed=7:rate=0.5", "chaos:seed=3:rate=1:steps=9",
                                  "chaos:seed=11:rate=0.4:kinds=stall+bit_flip,init_flake:1"])
def test_chaos_expands_like_jax(spec):
    got = res.expand_fault_spec(spec)
    assert got == jres.expand_fault_spec(spec) and got
    fs = res.FaultSet.from_spec(spec)
    assert fs.specs() == jres.FaultSet.from_spec(spec).specs()
    ev = [{"type": f"fault.{res.FaultInjector.from_spec(got[0]).kind}",
           "step": res.FaultInjector.from_spec(got[0]).step}]
    assert res.fault_event_matches_spec(ev, got[0]) == jres.fault_event_matches_spec(ev, got[0])
    assert res.CHAOS_KINDS == jres.CHAOS_KINDS and res.FAULT_KINDS == jres.FAULT_KINDS


def test_fault_set_and_injector_defaults(clean_env):
    fs = res.FaultSet.from_spec("worker_crash:step4:proc1,ckpt_corrupt:step4")
    assert fs.active and {i.kind for i in fs.injectors} == {"worker_crash", "ckpt_corrupt"}
    assert not res.FaultSet.from_spec(None).active
    assert not res.FaultInjector.from_spec(None).active
    assert res.get_fault_injector() is res.get_fault_injector()


def test_stall_and_net_delay_fire_once_after_their_step(clean_env, fault_injection,
                                                        monkeypatch):
    """``stall`` sleeps on the target process after its step; ``net_delay``
    arms a sleep before this rank's next host collective, here its next
    exchange (one process: the last process is rank 0)."""
    slept = []
    monkeypatch.setattr(res.time, "sleep", slept.append)  # the one time.sleep
    monkeypatch.setattr(res.FaultInjector, "STALL_S", 0.25)
    monkeypatch.setattr(res.FaultInjector, "NET_DELAY_S", 0.5)
    fault_injection("stall:step1,net_delay:step2")
    T = td.run(4, NX, NX, NX, **KW)
    assert slept == [0.25, 0.5]
    res.reset_fault_injector()
    os.environ.pop("IGG_FAULT_INJECT")
    assert torch.equal(T, td.run(4, NX, NX, NX, **KW))


def test_worker_crash_exits_on_the_target_process_only(clean_env, fault_injection,
                                                       monkeypatch):
    exits = []
    monkeypatch.setattr(res.os, "_exit", exits.append)
    inj = fault_injection("worker_crash:step2:proc1")
    inj.maybe_crash(2)  # one process: rank 0 is not proc 1
    assert exits == []
    inj = fault_injection("worker_crash:step2")
    inj.maybe_crash(1)
    inj.maybe_crash(2)
    inj.maybe_crash(2)
    assert exits == [res.FaultInjector.CRASH_STATUS] == [17]


# -- run guard ------------------------------------------------------------------------


def test_runguard_env_tier_precedence(clean_env, monkeypatch, tmp_path):
    g = res.RunGuard()
    assert (g.guard_every, g.policy, g.checkpoint_every, g.integrity_every) == (0, "raise", 0, 0)
    assert not g.enabled
    monkeypatch.setenv("IGG_GUARD_EVERY", "5")
    monkeypatch.setenv("IGG_GUARD_POLICY", "rollback")
    monkeypatch.setenv("IGG_CHECKPOINT_EVERY", "10")
    monkeypatch.setenv("IGG_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_INTEGRITY_EVERY", "4")
    g = res.RunGuard()
    assert (g.guard_every, g.policy, g.checkpoint_every, g.integrity_every) == (
        5, "rollback", 10, 4)
    assert g.checkpoint_dir == str(tmp_path) and g.enabled
    g = res.RunGuard(guard_every=2, policy="warn", checkpoint_every=3,
                     checkpoint_dir=str(tmp_path / "x"), integrity_every=0)
    assert (g.guard_every, g.policy, g.checkpoint_every, g.integrity_every) == (2, "warn", 3, 0)
    assert g.checkpoint_dir == str(tmp_path / "x")


def test_runguard_validation_matches_jax(clean_env):
    for kw in (dict(policy="explode"), dict(checkpoint_every=2), dict(guard_every=-1),
               dict(checkpoint_every=-1), dict(integrity_every=-1), dict(checkpoint_keep=-1)):
        with pytest.raises(ValueError) as je:
            jres.RunGuard(**kw)
        with pytest.raises(ValueError) as te:
            res.RunGuard(**kw)
        assert str(te.value) == str(je.value)


def test_idle_guard_loop_is_the_steps_alone(clean_env, monkeypatch):
    """Every knob off: no snapshot, no probe, no checkpoint scan — the loop
    calls the step and nothing else."""
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    for name in ("snapshot_state", "check_fields"):
        monkeypatch.setattr(res, name, lambda *a, **k: pytest.fail("the idle loop probed"))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: pytest.fail("the idle loop synchronized"))
    calls = []

    def step(A):
        calls.append(1)
        return (A + 1,)

    guard = res.RunGuard()
    assert not guard.enabled
    (A,) = res.guarded_time_loop(step, (torch.zeros(3),), 5, guard=guard)
    assert len(calls) == 5 and torch.equal(A, torch.full((3,), 5.0))


def test_rollback_snapshots_only_guard_passed_state(clean_env):
    """The rollback target is the last PROBED state: with guard_every=2 a
    NaN born at step 3 rolls back to step 2, never to an unprobed step."""
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    seen = []

    def step(A):
        A = A + 1
        if float(A[0]) == 3 and not seen:
            seen.append(1)
            A[1] = float("nan")
        return (A,)

    guard = res.RunGuard(guard_every=2, policy="rollback", names=("A",))
    with pytest.warns(RuntimeWarning, match="rolling back to step 2"):
        (A,) = res.guarded_time_loop(step, (torch.zeros(2),), 6, guard=guard)
    assert torch.equal(A, torch.full((2,), 6.0)) and guard.rollbacks == 1


def test_snapshot_state_owns_fresh_tensors():
    A = torch.arange(4.0)
    (S,) = res.snapshot_state((A,))
    A.add_(1)
    assert torch.equal(S, torch.arange(4.0)) and S.data_ptr() != A.data_ptr()


def test_telemetry_counts_guard_events(clean_env, fault_injection):
    base = tele.snapshot()["counters"].get("resilience.guard_trips", 0)
    fault_injection("halo_corrupt:step1")
    with pytest.raises(tigg.GuardError):
        td.run(2, NX, NX, NX, guard_every=1, **KW)
    assert tele.snapshot()["counters"]["resilience.guard_trips"] == base + 1


def test_telemetry_event_log(clean_env, monkeypatch, tmp_path, fault_injection):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    fault_injection("halo_corrupt:step1")
    with pytest.raises(tigg.GuardError):
        td.run(2, NX, NX, NX, guard_every=1, **KW)
    tele.reset()
    events = tele.read_events(tmp_path / "events.jsonl")
    kinds = [e["type"] for e in events]
    assert kinds == ["clock.sync", "run.start", "fault.halo_corrupt", "guard.trip"]
    assert events[3]["step"] == 1 and events[3]["rank"] == 0
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert tele.counter("x") is tele.NOOP


def test_batched_guard_and_rollback(clean_env, fault_injection):
    """A batched state ``(B, *block)`` goes through the same guard: the
    poisoned member's block trips it, and the rollback replays bit for bit;
    the shadow audit re-executes the batched step bit-identically."""
    (T, Cp), params = _batched.batched_setup(td, NX, NX, NX, batch=2, **KW)
    step = td.make_step(params, batch=True)
    want = res.guarded_time_loop(step, (T.clone(), Cp.clone()), 4, guard=res.RunGuard())
    audits = tele.snapshot()["counters"].get("integrity.audits", 0)
    audited = res.guarded_time_loop(step, (T.clone(), Cp.clone()), 4,
                                    guard=res.RunGuard(integrity_every=2, names=("T", "Cp")))
    assert tele.snapshot()["counters"]["integrity.audits"] == audits + 2
    assert all(torch.equal(g, w) for g, w in zip(audited, want))
    fault_injection("halo_corrupt:step2")
    guard = res.RunGuard(guard_every=1, policy="rollback", names=("T", "Cp"))
    with pytest.warns(RuntimeWarning, match="T: block\\(s\\) \\(0, 0, 0\\)"):
        got = res.guarded_time_loop(step, (T.clone(), Cp.clone()), 4, guard=guard)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
