"""The port's serving loop (`implicitglobalgrid_tpu_torch.serving.loop`)
against the JAX package's and against the port's own standalone runs.

* The JAX package's serving tests (`tests/test_batched_serving.py`) on the
  port's loop: mid-flight admission bit-exact with a standalone run, eviction
  of only the NaN member, rollback then give-up, the porous convergence mask,
  rejection at submit, resume refusing live members, ``tol`` without a
  residual, checkpoint resume mid-flight.
* Against JAX (one device, dims 1x1x1, float64 8^3): the same request
  sequence through both loops, for all three models, gives equal member ids,
  statuses, step counts and retirement rounds, and states within 1e-12 of
  each field's scale (the model tests' tolerance); the porous ``tol`` is
  placed between two rounds' residuals with a margin far above their
  1e-10 agreement.  A JAX pool checkpoint resumes in the port's loop and the
  reverse.
* Every cadence the loop steps with leaves its input pool bit-unchanged
  (the select and the audit rely on it).
* The shadow-step audit: 0 mismatches on a deterministic step, and an
  `IntegrityError` on a step that does not reproduce.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import _batched as jb
from implicitglobalgrid_tpu.models import acoustic3d as ja
from implicitglobalgrid_tpu.models import diffusion3d as jd
from implicitglobalgrid_tpu.models import porous_convection3d as jpc
from implicitglobalgrid_tpu.serving import Request as JRequest
from implicitglobalgrid_tpu.serving import ServingLoop as JServingLoop
from implicitglobalgrid_tpu_torch.models import _batched as tb
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.serving import Request, ServingLoop
from implicitglobalgrid_tpu_torch.utils import telemetry as tele

N = 8
F64 = torch.float64

#: model -> (JAX module, port module, setup kwargs)
MODELS = {
    "diffusion": (jd, td, {}),
    "acoustic": (ja, ta, {}),
    "porous": (jpc, tpc, dict(npt=3)),
}


@pytest.fixture(autouse=True)
def _fresh():
    tele.reset()
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    tele.reset()


def _grid(**kw):
    tigg.init_global_grid(N, N, N, quiet=True, device="cpu", **kw)


def _state(model=td, scale=1.0, **kw):
    return model.setup(N, N, N, init_grid=False, dtype=F64, ic_scale=scale, **kw)[0]


def _mk_loop(model=td, setup_kw=None, **kw):
    _, params = model.setup(N, N, N, init_grid=False, dtype=F64, **(setup_kw or {}))
    return ServingLoop(model, params, **kw), params


def _req(scale, max_steps, tenant="t"):
    return Request(state=_state(td, scale), max_steps=max_steps, tenant=tenant)


# -- the JAX package's serving tests on the port ------------------------------


def test_serving_mid_flight_admit_and_bit_exact_results():
    _grid()
    loop, params = _mk_loop(capacity=2, steps_per_round=2)
    mids = [loop.submit(_req(1.0 + i * 0.1, 4, tenant=f"t{i}")) for i in range(4)]
    res = loop.run(max_rounds=20)
    assert sorted(res) == sorted(mids)
    assert all(r.status == "completed" and r.steps == 4 for r in res.values())
    assert loop.rounds > 2  # members 2 and 3 were admitted mid-flight
    step = td.make_step(params)
    for i, m in enumerate(mids):
        s = _state(td, 1.0 + i * 0.1)
        for _ in range(4):
            s = step(*s)
        for got, want in zip(res[m].state, s):
            assert torch.equal(got, want), f"member {m} differs from its standalone run"
    snap = tele.snapshot()
    assert snap["counters"]["serving.admitted_total"] == 4
    assert snap["histograms"]["serving.round_seconds"]["count"] == loop.rounds
    assert snap["counters"]["serving.tenant.t2.steps"] == 4


def test_serving_evicts_only_the_nan_member():
    _grid()
    loop, _ = _mk_loop(capacity=2, steps_per_round=1)
    good = _req(1.1, 2)
    bad = _req(1.0, 5)
    T = bad.state[0].clone()
    T[2, 2, 2] = float("nan")
    bad.state = (T, bad.state[1])
    m_bad = loop.submit(bad)
    m_good = loop.submit(good)
    res = loop.run(max_rounds=10)
    assert res[m_bad].status == "evicted" and res[m_bad].state is None
    assert res[m_good].status == "completed"
    assert torch.isfinite(res[m_good].state[0]).all()
    assert tele.snapshot()["counters"]["serving.evicted_total"] == 1


def test_serving_rollback_restores_member_then_gives_up():
    _grid()
    loop, _ = _mk_loop(capacity=1, steps_per_round=1, guard_policy="rollback", max_rollbacks=2)
    m = loop.submit(_req(1.0, 3))
    loop.run_round()
    assert loop.slots[0].steps == 1
    snapshot = tuple(A.clone() for A in loop.slots[0].snapshot)
    T = tb.member_field(loop._state[0], 0)
    T[1, 1, 1] = float("nan")
    loop._state = tb.set_member_state(loop._state, (T, tb.member_field(loop._state[1], 0)), 0)
    loop._guard(loop._mask())
    assert loop.slots[0].rollbacks == 1 and loop.slots[0].steps == 1
    assert not tb.check_members_finite(loop._state).any()
    assert all(torch.equal(a, b) for a, b in zip(tb.member_state(loop._state, 0), snapshot))
    res = loop.run(max_rounds=10)
    assert res[m].status == "completed"
    # a fault that re-trips forever is evicted once the rollbacks run out
    loop2, _ = _mk_loop(capacity=1, steps_per_round=1, guard_policy="rollback",
                        max_rollbacks=2)
    m2 = loop2.submit(_req(1.0, 9))
    loop2.run_round()
    for _ in range(3):
        T = tb.member_field(loop2._state[0], 0)
        T[1, 1, 1] = float("nan")
        loop2._state = tb.set_member_state(loop2._state, (T, tb.member_field(loop2._state[1], 0)),
                                           0)
        loop2._guard(loop2._mask())
    assert loop2.results[m2].status == "evicted"
    assert tele.snapshot()["counters"]["serving.rollbacks_total"] == 3


def test_serving_porous_convergence_mask():
    _grid()
    loop, _ = _mk_loop(tpc, dict(npt=3), capacity=2, steps_per_round=1)
    m_c = loop.submit(Request(state=_state(tpc, 1.0, npt=3), max_steps=50, tol=1.0))
    m_b = loop.submit(Request(state=_state(tpc, 0.6, npt=3), max_steps=2))
    res = loop.run(max_rounds=60)
    assert res[m_c].status == "converged"
    assert res[m_c].residual is not None and res[m_c].residual < 1.0
    assert res[m_b].status == "completed" and res[m_b].steps == 2


def test_serving_rejects_mismatched_state_at_submit():
    """A malformed request is rejected AT SUBMIT, never queued or
    half-admitted: wrong field count, wrong dtype, a field that is not a
    tensor on the grid's device."""
    _grid()
    loop, _ = _mk_loop(capacity=1)
    good = _req(1.0, 2)
    loop.submit(good)  # defines the pool signature; occupies the one slot
    with pytest.raises(ValueError, match="field"):
        loop.submit(Request(state=good.state[:1], max_steps=2))
    wrong_dtype = tuple(A.float() for A in good.state)
    with pytest.raises(ValueError, match="signature"):
        loop.submit(Request(state=wrong_dtype, max_steps=2))
    with pytest.raises(ValueError, match="field"):
        loop.submit(Request(state=(), max_steps=2))
    with pytest.raises(ValueError, match="grid's device"):
        loop.submit(Request(state=tuple(A.numpy() for A in good.state), max_steps=2))
    with pytest.raises(ValueError, match="max_steps"):
        loop.submit(Request(state=good.state, max_steps=0))
    assert len(loop.queue) == 0
    res = loop.run(max_rounds=5)  # the good member is unharmed
    assert len(res) == 1 and next(iter(res.values())).status == "completed"


def test_serving_resume_refuses_live_members(tmp_path):
    _grid()
    ck = str(tmp_path / "pool")
    loop, _ = _mk_loop(capacity=1, checkpoint_every=1, checkpoint_dir=ck)
    loop.submit(_req(1.0, 3))
    loop.run_round()
    loop2, _ = _mk_loop(capacity=1, checkpoint_every=1, checkpoint_dir=ck)
    loop2.submit(_req(1.1, 2))  # live member: resume must refuse to clobber it
    with pytest.raises(RuntimeError, match="live members"):
        loop2.resume()
    loop3, _ = _mk_loop(capacity=1, checkpoint_every=1, checkpoint_dir=ck)
    with pytest.raises(RuntimeError, match="prime"):
        loop3.resume()


def test_serving_tol_on_model_without_residual_raises():
    _grid()
    loop, _ = _mk_loop(capacity=1)
    r = _req(1.0, 2)
    r.tol = 0.1
    with pytest.raises(ValueError, match="no PT residual"):
        loop.submit(r)


def test_serving_checkpoint_resume_mid_flight(tmp_path):
    _grid()
    ck = str(tmp_path / "pool")
    loop, _ = _mk_loop(capacity=2, steps_per_round=1, checkpoint_every=1, checkpoint_dir=ck)
    m0 = loop.submit(_req(1.0, 4, tenant="a"))
    m1 = loop.submit(_req(1.2, 4, tenant="b"))
    loop.run_round()
    loop.run_round()
    mid_state = tb.member_state(loop._state, 0)
    loop2, _ = _mk_loop(capacity=2, steps_per_round=1, checkpoint_every=1, checkpoint_dir=ck)
    loop2.prime(mid_state)
    assert loop2.resume()
    assert loop2.rounds == 2 and loop2.active_members == 2
    assert loop2.slots[0].member == m0 and loop2.slots[0].steps == 2
    res = loop2.run(max_rounds=10)
    assert res[m0].status == "completed" and res[m0].steps == 4
    assert res[m1].status == "completed"
    want = loop.run(max_rounds=10)  # the uninterrupted pool
    for m in (m0, m1):
        assert all(torch.equal(a, b) for a, b in zip(res[m].state, want[m].state))


def test_fused_k_must_divide_steps_per_round():
    """``step_kwargs`` pass through unchanged: a round that is no multiple of
    ``fused_k`` raises at construction."""
    tigg.init_global_grid(N, N, N, periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4,
                          overlapz=4, quiet=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of fused_k"):
        _mk_loop(capacity=2, steps_per_round=3, step_kwargs={"fused_k": 2})


# -- the audit ----------------------------------------------------------------


def test_audit_every_round_finds_no_mismatch_and_catches_one(monkeypatch):
    monkeypatch.setenv("IGG_INTEGRITY_EVERY", "1")
    _grid()
    loop, _ = _mk_loop(capacity=2, steps_per_round=2)
    for i in range(3):
        loop.submit(_req(1.0 + 0.1 * i, 4))
    res = loop.run(max_rounds=10)
    assert len(res) == 3
    c = tele.snapshot()["counters"]
    assert c["integrity.audits"] == loop.rounds and "integrity.audit_mismatches" not in c
    # a step that does not reproduce is silent data corruption
    from implicitglobalgrid_tpu_torch.integrity import IntegrityError

    loop2, _ = _mk_loop(capacity=2, steps_per_round=2)
    loop2.submit(_req(1.0, 4))
    calls = []
    honest = loop2._step

    def flaky(*s):
        out = honest(*s)
        calls.append(1)
        if len(calls) == 2:  # the audit's re-run
            out = (out[0] + 1e-9, *out[1:])
        return out

    loop2._step = flaky
    with pytest.raises(IntegrityError, match="silent data corruption"):
        loop2.run_round()
    assert tele.snapshot()["counters"]["integrity.audit_mismatches"] == 1


# -- every cadence leaves its input pool intact ---------------------------------

CADENCES = {
    "diffusion-per-step": (td, {}, {}, 2),
    "diffusion-exchange_every": (td, {}, dict(exchange_every=2), 2),
    "diffusion-fused-serialized": (td, {}, dict(fused_k=2, pipelined=False), 2),
    "diffusion-fused-pipelined": (td, {}, dict(fused_k=2, pipelined=True, fused_tile=(8, 8)), 2),
    "acoustic-per-step": (ta, {}, {}, 2),
    "acoustic-fused": (ta, {}, dict(fused_k=2), 2),
    "porous-per-step": (tpc, dict(npt=3), {}, 1),
    "porous-chunks": (tpc, dict(npt=5), dict(fused_k=2), 1),
    "porous-exchange_every": (tpc, dict(npt=4), dict(exchange_every=2), 1),
}


@pytest.mark.parametrize("cadence", list(CADENCES))
def test_cadence_leaves_input_pool_bit_unchanged(cadence):
    model, setup_kw, step_kw, nsteps = CADENCES[cadence]
    shape = (32, 30, 8) if step_kw.get("pipelined") else (16, 32, 24)
    pool, params = tb.batched_setup(
        model, *shape, batch=3, dtype=F64, device="cpu", quiet=True, periodx=1, periody=1,
        periodz=1, overlapx=4, overlapy=4, overlapz=4, **setup_kw)
    before = tuple(A.clone() for A in pool)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # pipelined=True must admit the split
        out = model.make_multi_step(params, nsteps, batch=True, **step_kw)(*pool)
    for A, B in zip(pool, before):
        assert torch.equal(A, B), f"{cadence} wrote into its input pool"
    assert not torch.equal(out[0], before[0])


# -- against the JAX package's loop ---------------------------------------------


def _jax_grid():
    jigg.init_global_grid(N, N, N, quiet=True, devices=jax.devices()[:1])


def _drive(loop):
    """Run ``loop`` round by round; return {member: retirement round}."""
    retired = {}
    while loop.queue or loop.active_members:
        loop.run_round()
        for m in loop.results:
            retired.setdefault(m, loop.rounds)
        assert loop.rounds < 100
    return retired


def _assert_close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.numpy() - want))) / scale
    assert err <= 1e-12, f"{what}: {err} relative to the field's scale"


def _porous_tol(jparams, scale):
    """A ``tol`` between two rounds' residuals of the member (JAX, one step
    per round): the 7th round's residual is the first under it, by a
    margin far above the packages' 1e-10 residual agreement."""
    res_fn = jpc.make_batched_residual(jparams)
    step = jpc.make_step(jparams, donate=False)
    st = jpc.setup(N, N, N, init_grid=False, dtype=jnp.float64, npt=3, ic_scale=scale)[0]
    r = []
    for _ in range(7):
        st = step(*st)
        r.append(float(res_fn(*jb.stack_states([st]))[0]))
    tol = math.sqrt(min(r[:6]) * r[6])
    assert min(r[:6]) > tol * (1 + 1e-3) and r[6] < tol * (1 - 1e-3)
    return tol


@pytest.mark.parametrize("name", list(MODELS))
def test_port_loop_matches_jax_loop(name):
    jmod, tmod, kw = MODELS[name]
    _jax_grid()
    _, jparams = jmod.setup(N, N, N, init_grid=False, dtype=jnp.float64, **kw)
    spr = 1 if name == "porous" else 2
    specs = [(1.0, 4, None), (1.1, 6, None), (0.9, 2, None), (1.2, 4, None)]
    if name == "porous":
        specs = [(1.0, 50, _porous_tol(jparams, 1.0)), (0.6, 2, None), (0.8, 3, None)]
    jstates = [jmod.setup(N, N, N, init_grid=False, dtype=jnp.float64, ic_scale=s, **kw)[0]
               for s, _, _ in specs]
    jloop = JServingLoop(jmod, jparams, capacity=2, steps_per_round=spr)
    jids = [jloop.submit(JRequest(state=st, max_steps=m, tenant=f"t{i}", tol=tol))
            for i, (st, (_, m, tol)) in enumerate(zip(jstates, specs))]
    jret = _drive(jloop)

    _grid()
    tparams = tmod.params_from(jparams)
    tloop = ServingLoop(tmod, tparams, capacity=2, steps_per_round=spr)
    tids = [tloop.submit(Request(state=tmod.state_from_numpy(*(np.asarray(A) for A in st)),
                                 max_steps=m, tenant=f"t{i}", tol=tol))
            for i, (st, (_, m, tol)) in enumerate(zip(jstates, specs))]
    tret = _drive(tloop)
    assert tids == jids and tret == jret and tloop.rounds == jloop.rounds
    for m in tids:
        j, t = jloop.results[m], tloop.results[m]
        assert (t.status, t.steps, t.tenant) == (j.status, j.steps, j.tenant)
        if j.residual is None:
            assert t.residual is None
        else:
            assert abs(t.residual - j.residual) <= 1e-10 * abs(j.residual)
        for i, (a, b) in enumerate(zip(t.state, j.state)):
            _assert_close(a, b, f"{name} member {m} field {i}")
    if name == "porous":
        assert tloop.results[tids[0]].status == "converged"


def _slot_records(loop):
    return [(s.member, s.tenant, s.max_steps, s.tol, s.steps, s.active) for s in loop.slots]


def test_jax_pool_checkpoint_resumes_in_the_port(tmp_path):
    ck = str(tmp_path / "pool")
    _jax_grid()
    _, jparams = jd.setup(N, N, N, init_grid=False, dtype=jnp.float64)
    jloop = JServingLoop(jd, jparams, capacity=2, steps_per_round=1, checkpoint_every=1,
                         checkpoint_dir=ck)
    for i, (s, m) in enumerate(((1.0, 4), (1.2, 5), (0.9, 3))):
        st = jd.setup(N, N, N, init_grid=False, dtype=jnp.float64, ic_scale=s)[0]
        jloop.submit(JRequest(state=st, max_steps=m, tenant=f"t{i}"))
    jloop.run_round()
    jloop.run_round()
    jpool = [np.asarray(A) for A in jloop._state]

    _grid()
    tloop = ServingLoop(td, td.params_from(jparams), capacity=2, steps_per_round=1)
    tloop.checkpoint_dir = ck
    tloop.prime(_state(td))
    assert tloop.resume()
    assert tloop.rounds == 2 and _slot_records(tloop) == _slot_records(jloop)
    for A, B in zip(tloop._state, jpool):
        np.testing.assert_array_equal(A.numpy(), B)  # the same bytes
    # member 2 was still queued in JAX: queues are the caller's to resubmit
    jres = jloop.run(max_rounds=20)
    tres = tloop.run(max_rounds=20)
    assert sorted(tres) == [0, 1]
    for m in (0, 1):
        assert (tres[m].status, tres[m].steps) == (jres[m].status, jres[m].steps)
        for a, b in zip(tres[m].state, jres[m].state):
            _assert_close(a, b, f"member {m}")


def test_port_pool_checkpoint_resumes_in_jax(tmp_path):
    ck = str(tmp_path / "pool")
    _grid()
    _, tparams = td.setup(N, N, N, init_grid=False, dtype=F64)
    tloop = ServingLoop(td, tparams, capacity=2, steps_per_round=1, checkpoint_every=1,
                        checkpoint_dir=ck)
    for i, (s, m) in enumerate(((1.0, 4), (1.2, 5))):
        tloop.submit(Request(state=_state(td, s), max_steps=m, tenant=f"t{i}"))
    tloop.run_round()
    tloop.run_round()
    tpool = [A.numpy().copy() for A in tloop._state]

    _jax_grid()
    _, jparams = jd.setup(N, N, N, init_grid=False, dtype=jnp.float64)
    jloop = JServingLoop(jd, jparams, capacity=2, steps_per_round=1, checkpoint_dir=ck)
    jloop.prime(jd.setup(N, N, N, init_grid=False, dtype=jnp.float64)[0])
    assert jloop.resume()
    assert jloop.rounds == 2 and _slot_records(jloop) == _slot_records(tloop)
    for A, B in zip(jloop._state, tpool):
        np.testing.assert_array_equal(np.asarray(A), B)
    jres = jloop.run(max_rounds=20)
    tres = tloop.run(max_rounds=20)
    for m in (0, 1):
        assert (tres[m].status, tres[m].steps) == (jres[m].status, jres[m].steps)
        for a, b in zip(tres[m].state, jres[m].state):
            _assert_close(a, b, f"member {m}")


def test_members_of_a_partial_pool_stay_bit_frozen():
    """A free slot next to an active member: the select keeps it bit for
    bit (blank), and the active member equals its standalone run."""
    _grid()
    loop, params = _mk_loop(capacity=3, steps_per_round=2)
    m = loop.submit(_req(1.05, 4))
    loop.run_round()
    for k in (1, 2):
        assert all(not A[k].any() for A in loop._state)
    res = loop.run(max_rounds=5)
    s = _state(td, 1.05)
    for _ in range(4):
        s = td.make_step(params)(*s)
    assert all(torch.equal(a, b) for a, b in zip(res[m].state, s))
    assert dataclasses.asdict(loop.slots[0])["active"] is False
