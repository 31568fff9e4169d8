"""Gradients through the PyTorch port against the JAX package's `jax.grad`.

Counterparts of ``tests/test_autodiff.py``: `torch.autograd.grad` through
the port's steps and cadences equals JAX's gradient of the same loss on the
same inputs, and central differences of the loss.

* The plain cadences are analytic on both sides: float64, 1e-12 relative to
  the gradient's scale (``_close``).  Central differences at interior,
  block-edge, halo and send planes: the loss is quadratic in T, so the
  quotient is exact up to the loss's rounding over ``2 eps``.
* The fused cadences run the kernel's plain version in the forward (CPU
  tensors) and the model's plain groups in the backward
  (`models._fused`); JAX runs its Pallas kernel (interpreter) and its XLA
  twin.  Float32, rtol = atol = 1e-4 of the gradient's scale: the JAX
  tests' tolerance, here relative to the largest entry so that the check
  is not empty for small gradients.
* Two gloo ranks split in x, periodic: the exchange's adjoint moves every
  halo cotangent back to the rank that sent it; the make_step gradient at
  the send planes (6, 4, 4) and (1, 4, 4) matches central differences of
  the loss summed over ranks and JAX's 2-device gradient cut per rank.
  Two spawns: one on 8^3 blocks, one on the pipelined split's blocks.
* The port's own equalities: batched members against their unbatched
  gradients and ``pipelined=True`` against serialized, bit for bit;
  ``hide_comm`` against the plain step within 1e-12.
* The kernels are forward-only: a direct call under grad raises.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import acoustic3d as ja
from implicitglobalgrid_tpu.models import diffusion3d as jd
from implicitglobalgrid_tpu.models import porous_convection3d as jpc
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import _batched as tb
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

NAMES = {td: ("T", "Cp"), ta: ("P", "Vx", "Vy", "Vz"), tpc: ("T", "Pf", "qDx", "qDy", "qDz")}
KIND = {td: "multi_step", ta: "acoustic", tpc: "porous"}


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _close(got, want, rtol=1e-12):
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _tgrad(fn, state, wrt, loss_idx, scale=1.0):
    """`torch.autograd.grad` of ``scale * sum(out[i]**2)`` over ``loss_idx``
    w.r.t. the inputs ``wrt`` (indices), as numpy arrays."""
    leaves = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(state)]
    out = fn(*leaves)
    loss = scale * sum((out[i] ** 2).sum() for i in loss_idx)
    return [g.numpy() for g in torch.autograd.grad(loss, [leaves[i] for i in wrt])]


def _jgrad(fn, state, wrt, loss_idx, scale=1.0):
    def loss(*s):
        out = fn(*s)
        return scale * sum(jnp.sum(out[i] ** 2) for i in loss_idx)

    g = jax.block_until_ready(jax.grad(loss, argnums=tuple(wrt))(*map(jnp.asarray, state)))
    return [np.asarray(a) for a in g]


def _fd(fn, state, i, idx, loss_idx, eps=1e-4):
    """Central difference of ``sum(out[j]**2)`` w.r.t. ``state[i][idx]``."""
    def loss(sign):
        s = [a.clone() for a in state]
        s[i][idx] += sign * eps
        with torch.no_grad():
            out = fn(*s)
            return float(sum((out[j] ** 2).sum() for j in loss_idx))

    return (loss(1) - loss(-1)) / (2 * eps)


def _setup_both(jm, tm, nxyz, dtype, model_kw=None, **grid):
    """The JAX package's one-device initial state (numpy) and params, and
    the port's grid and state on the same configuration.  The JAX grid stays
    up for the caller's JAX cadence; the caller finalizes it."""
    model_kw = model_kw or {}
    jstate, jparams = jm.setup(*nxyz, dtype=dtype, quiet=True, devices=jax.devices()[:1],
                               **model_kw, **grid)
    jstate = [np.asarray(a) for a in jstate]
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **grid)
    return jstate, jparams, tm.state_from_numpy(*jstate)


# -- one rank, the plain cadences, float64 ------------------------------------

def test_grad_through_diffusion_step():
    """make_step (stencil + self exchange, periodic x) against JAX and FD at
    interior, block-edge, halo and send-plane points, w.r.t. T and Cp."""
    jstate, jparams, state = _setup_both(jd, td, (8, 8, 8), jnp.float64, periodx=1)
    want = _jgrad(jd.make_step(jparams, donate=False), jstate, (0, 1), (0,))
    jigg.finalize_global_grid()
    step = td.make_step(td.params_from(jparams))
    got = _tgrad(step, state, (0, 1), (0,))
    for g, w in zip(got, want):
        _close(g, w)
    for i, points in ((0, [(5, 5, 5), (0, 3, 3), (7, 4, 4), (1, 4, 4), (6, 4, 4)]),
                      (1, [(5, 5, 5), (6, 4, 4)])):
        for idx in points:
            np.testing.assert_allclose(got[i][idx], _fd(step, state, i, idx, (0,)), rtol=1e-6,
                                       atol=1e-5, err_msg=str((i, idx)))


def test_grad_through_update_halo_periodic():
    """The self-partner exchange's adjoint: halo cotangents return to the
    interior source planes (FD, and JAX's `stencil`-wrapped exchange).  The
    port differentiates ``update_halo(T.clone())``: a leaf that requires grad
    cannot be exchanged in place."""
    jstate, _, (T, _) = _setup_both(jd, td, (8, 8, 8), jnp.float64, periodx=1)
    want = _jgrad(lambda A: (jigg.stencil(lambda A: jigg.update_halo(A))(A),), jstate[:1], (0,),
                  (0,))[0]
    jigg.finalize_global_grid()

    def exchange(A):
        return (tigg.update_halo(A.clone()),)

    got = _tgrad(exchange, (T,), (0,), (0,))[0]
    _close(got, want)
    for idx in [(1, 4, 4), (6, 4, 4), (0, 4, 4), (7, 7, 7)]:
        np.testing.assert_allclose(got[idx], _fd(exchange, (T,), 0, idx, (0,)), rtol=1e-6,
                                   atol=1e-5, err_msg=str(idx))
    assert got[0, 4, 4] == 0 and got[1, 4, 4] == 2 * 2 * float(T[1, 4, 4])  # 2 copies of plane 1
    leaf = T.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="leaf"):
        tigg.update_halo(leaf)


def test_grad_through_staggered_multi_step():
    """The acoustic per-step cadence, 3 steps, 3-field exchange per step
    (periodic x and z), w.r.t. the initial pressure."""
    kw = dict(periodx=1, periodz=1)
    jstate, jparams, state = _setup_both(ja, ta, (8, 8, 8), jnp.float64, **kw)
    want = _jgrad(ja.make_multi_step(jparams, 3, donate=False), jstate, (0,), (0,))[0]
    jigg.finalize_global_grid()
    multi = ta.make_multi_step(ta.params_from(jparams), 3)
    got = _tgrad(multi, state, (0,), (0,))[0]
    _close(got, want)
    for idx in [(4, 4, 4), (7, 7, 7), (0, 5, 5), (6, 3, 1)]:
        np.testing.assert_allclose(got[idx], _fd(multi, state, 0, idx, (0,)), rtol=1e-6,
                                   atol=1e-5, err_msg=str(idx))


# -- one rank, the fused cadences against JAX's fused gradient, float32 ----------

FUSED = {
    # model: (JAX, port, setup kwargs, nsteps, wrt, loss fields, loss scale)
    "diffusion": (jd, td, dict(periodz=1, overlapz=4), 2, (0, 1), (0,), 1e-6),
    "acoustic": (ja, ta, dict(periodz=1, overlapz=4), 2, (0,), (0,), 1.0),
    # dL/dT reaches the PT fields only through the chunks' buoyancy term.
    "porous": (jpc, tpc, dict(periodx=1, overlapx=4), 1, (0, 1), (1, 2, 3, 4), 1.0),
}


@pytest.mark.parametrize("model", list(FUSED))
def test_grad_through_fused_multi_step_matches_jax(model):
    """make_multi_step(fused_k=2) on a (16, 32, 128) float32 block: the
    port's gradient (kernel forward, plain groups backward) against JAX's
    (Pallas kernel through the interpreter, XLA twin backward) and against
    the port's own ``exchange_every=2`` cadence's gradient."""
    jm, tm, kw, nsteps, wrt, loss_idx, scale = FUSED[model]
    jstate, jparams, state = _setup_both(jm, tm, (16, 32, 128), jnp.float32,
                                         dict(npt=4) if tm is tpc else {}, **kw)
    with pallas_force_interpret():
        jfused = jm.make_multi_step(jparams, nsteps, donate=False, fused_k=2, pipelined=False)
        want = _jgrad(jfused, jstate, wrt, loss_idx, scale)
    jigg.finalize_global_grid()
    params = tm.params_from(jparams)
    kernel = {td: fs, ta: fl, tpc: fp}[tm]
    before = kernel.launches
    got = _tgrad(tm.make_multi_step(params, nsteps, fused_k=2), state, wrt, loss_idx, scale)
    assert kernel.launches == before  # CPU tensors: the plain version, no launch
    plain = _tgrad(tm.make_multi_step(params, nsteps, exchange_every=2), state, wrt, loss_idx,
                   scale)
    for i, g, w, p in zip(wrt, got, want, plain):
        assert np.abs(w).max() > 0, i
        _close(g, w, rtol=1e-4)
        _close(g, p, rtol=1e-4)


# -- two gloo ranks -----------------------------------------------------------------

def _params_json(params):
    pj = {k: v for k, v in params.__dict__.items() if k != "dtype"}
    pj["dtype"] = "float64"
    return pj


def test_two_ranks_make_step_matches_fd_and_jax(tmp_path):
    """dimx=2, periodic x, 8^3 float64 blocks.  Rank 0's gradient at its send
    planes (6, 4, 4) and (1, 4, 4), where half of it comes back from the
    other rank, equals central differences of the loss summed over ranks;
    every block equals JAX's 2-device gradient.  In the same spawn:
    ``hide_comm`` against the plain step, and the acoustic per-step cadence
    against JAX, with as many ``P2POp``s per dimension in the backward as in
    the forward."""
    grid = dict(dimx=2, periodx=1)
    runs, inputs, wants = [], {}, {}
    for jm, tm, pre, nsteps, wrt in ((jd, td, "d", None, (0, 1)), (ja, ta, "a", 3, (0,))):
        jstate, jparams = jm.setup(8, 8, 8, dtype=jnp.float64, quiet=True,
                                   devices=jax.devices()[:2], **grid)
        jstate = [np.asarray(a) for a in jstate]
        assert jstate[0].shape[0] == 16
        fn = (jm.make_step(jparams, donate=False) if nsteps is None
              else jm.make_multi_step(jparams, nsteps, donate=False))
        wants[pre] = _jgrad(fn, jstate, wrt, (0,))
        jigg.finalize_global_grid()
        names = NAMES[tm]
        step = dict(make_step=True) if nsteps is None else dict(nsteps=nsteps)
        base = dict(model=KIND[tm], params=_params_json(tm.params_from(jparams)),
                    wrt=[names[i] for i in wrt], loss=[names[0]], **step)
        fd = [[0, "T", [6, 4, 4]], [0, "T", [1, 4, 4]], [1, "T", [6, 4, 4]], [0, "Cp", [1, 4, 4]]]
        runs.append(dict(base, prefix=pre, **(dict(fd_points=fd) if tm is td else {})))
        runs.append(dict(base, prefix=pre + "h", step=dict(hide_comm=True)))
        for p in (pre, pre + "h"):
            inputs.update({f"{p}{n}": a for n, a in zip(names, jstate)})
    outs = spawn(dict(kind="grad", nxyz=[8, 8, 8], grid=grid, runs=runs, inputs=inputs), 2,
                 tmp_path, timeout=240)
    for rank, out in enumerate(outs):
        for pre, tm, wrt in (("d", td, (0, 1)), ("a", ta, (0,))):
            for i, w in zip(wrt, wants[pre]):
                name = NAMES[tm][i]
                _close(out[f"{pre}d{name}"], w[8 * rank:8 * (rank + 1)])
                _close(out[f"{pre}hd{name}"], out[f"{pre}d{name}"])
            p2p = out[f"{pre}p2p"]
            assert p2p[0] > 0 and p2p[0] == p2p[3] and not p2p[[1, 2, 4, 5]].any(), p2p
        np.testing.assert_allclose(out["dfd"], outs[0]["dfd"])
    got = [outs[0]["ddT"][6, 4, 4], outs[0]["ddT"][1, 4, 4], outs[1]["ddT"][6, 4, 4],
           outs[0]["ddCp"][1, 4, 4]]
    np.testing.assert_allclose(got, outs[0]["dfd"], rtol=1e-6, atol=1e-5)


def test_two_ranks_fused_cadences(tmp_path):
    """dimx=2, periodic x/y/z, overlap 4, (32, 30, 8) float64 blocks (the
    pipelined split's test geometry): per model, ``fused_k=2`` with the
    split forced (``pipelined=True``, tile (8, 8)) gives the serialized
    schedule's gradient bit for bit, and the ``exchange_every=2`` cadence's
    within 1e-12; the gradient crosses ranks in both passes."""
    grid = dict(dimx=2, periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)
    nxyz = (32, 30, 8)
    runs, inputs = [], {}
    # Porous npt=4: both cadences run chunks [2, 2].  Cadences that exchange
    # on other schedules agree on states whose duplicated cells agree, not on
    # every perturbation of one cell, so their gradients differ.
    for tm, kw, nsteps in ((td, {}, 4), (ta, {}, 4), (tpc, dict(npt=4), 1)):
        tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **{**grid, "dimx": 1})
        assert tm.pipelined_support_error(nxyz, 2, torch.float64, 8, 8) is None
        tigg.finalize_global_grid()
        jstate, jparams = {td: jd, ta: ja, tpc: jpc}[tm].setup(
            *nxyz, dtype=jnp.float64, quiet=True, devices=jax.devices()[:2], **kw, **grid)
        jigg.finalize_global_grid()
        names = NAMES[tm]
        pre = names[0] + KIND[tm][0]
        base = dict(model=KIND[tm], params=_params_json(tm.params_from(jparams)), nsteps=nsteps,
                    wrt=list(names[:2]))
        for suffix, step in (("p", dict(fused_k=2, fused_tile=[8, 8], pipelined=True)),
                             ("s", dict(fused_k=2, fused_tile=[8, 8], pipelined=False)),
                             ("e", dict(exchange_every=2))):
            runs.append(dict(base, prefix=pre + suffix, step=step))
            inputs.update({f"{pre}{suffix}{n}": np.asarray(a) for n, a in zip(names, jstate)})
    outs = spawn(dict(kind="grad", nxyz=list(nxyz), grid=grid, runs=runs, inputs=inputs), 2,
                 tmp_path, timeout=240)
    for out in outs:
        for tm in (td, ta, tpc):
            names = NAMES[tm]
            pre = names[0] + KIND[tm][0]
            for name in names[:2]:
                g = out[f"{pre}pd{name}"]
                assert np.array_equal(g, out[f"{pre}sd{name}"]), (pre, name)
                _close(g, out[f"{pre}ed{name}"])
            assert out[f"{pre}pp2p"][3] > 0  # the backward exchanged across ranks


# -- one rank, the port's own equalities ----------------------------------------------

ONE_RANK = {
    # model: (port, setup kwargs, nsteps)
    "diffusion": (td, {}, 4),
    "acoustic": (ta, {}, 4),
    "porous": (tpc, dict(npt=5), 1),
}
PERIODIC4 = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)


@pytest.mark.parametrize("model", list(ONE_RANK))
def test_batched_gradient_per_member_equals_unbatched(model):
    """B = 2 members, fused_k=2: each member's gradient of the summed loss
    equals its unbatched gradient bit for bit."""
    tm, kw, nsteps = ONE_RANK[model]
    state, params = tb.batched_setup(tm, 12, 10, 8, batch=2, dtype=torch.float64, quiet=True,
                                     device="cpu", **kw, **PERIODIC4)
    n = len(state)
    got = _tgrad(tm.make_multi_step(params, nsteps, fused_k=2, batch=True), state, (0, 1),
                 range(n))
    alone = tm.make_multi_step(params, nsteps, fused_k=2)
    for b in range(2):
        want = _tgrad(alone, tb.member_state(state, b), (0, 1), range(n))
        for g, w in zip(got, want):
            assert np.abs(w).max() > 0
            assert np.array_equal(g[b], w), (model, b)


@pytest.mark.parametrize("model", list(ONE_RANK))
def test_pipelined_gradient_equals_serialized(model):
    """The forced split (tile (8, 8) on (32, 30, 8) blocks) against the
    serialized schedule, bit for bit."""
    tm, kw, nsteps = ONE_RANK[model]
    state, params = tm.setup(32, 30, 8, dtype=torch.float64, quiet=True, device="cpu", **kw,
                             **PERIODIC4)
    grads = [_tgrad(tm.make_multi_step(params, nsteps, fused_k=2, fused_tile=(8, 8),
                                       pipelined=p), state, (0, 1), range(len(state)))
             for p in (True, False)]
    for p, s in zip(*grads):
        assert np.array_equal(p, s)


@pytest.mark.parametrize("model", list(ONE_RANK))
def test_hide_comm_gradient_equals_plain_step(model):
    """``hide_comm=True`` (overlapped forward, the exchange's adjoint in the
    backward) against the plain per-step cadence, within 1e-12: the same
    operations, but a field read both inside and outside the overlapped
    update (acoustic P, porous T) sums its cotangents in another order."""
    tm, kw, _ = ONE_RANK[model]
    state, params = tm.setup(12, 10, 8, dtype=torch.float64, quiet=True, device="cpu", **kw,
                             periodx=1, periody=1, periodz=1)
    hidden = tm.Params(**{**params.__dict__, "hide_comm": True})
    grads = [_tgrad(tm.make_multi_step(p, 2), state, (0, 1), range(len(state)))
             for p in (hidden, params)]
    for h, p in zip(*grads):
        assert np.abs(p).max() > 0
        _close(h, p)


def test_direct_kernel_call_under_grad_raises():
    """The kernels are forward-only, on every device: under grad mode an
    input that requires grad raises and points to the model cadences; under
    `torch.no_grad` (as the cadences' forward runs them) the call runs."""
    rng = np.random.default_rng(0)
    cells = [torch.from_numpy(rng.standard_normal((6, 7, 8))) for _ in range(2)]
    faces = [torch.from_numpy(rng.standard_normal(s)) for s in fl.face_shapes((6, 7, 8))]
    calls = [
        (lambda a: fs.fused_diffusion_steps(a[0], a[1].abs() + 1, 2, 0.1, 0.1, 0.1),
         cells),
        (lambda a: fl.fused_leapfrog_steps(*a, 2, 0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0),
         [cells[0], *faces]),
        (lambda a: fp.fused_pt_iterations(*a, 2, 0.5, 10.0, 6.6, 5.0, 1.0, 3e-4),
         [*cells, *faces]),
    ]
    for call, ins in calls:
        leaf = [ins[0].clone().requires_grad_(), *ins[1:]]
        with pytest.raises(ValueError, match="forward-only.*make_multi_step"):
            call(leaf)
        with torch.no_grad():
            call(leaf)
        call(ins)


def test_fused_gradient_needs_no_warning():
    """The fused cadence under grad runs through the plain-grad wrapper
    without falling back (no warning) and keeps the forward's values."""
    state, params = td.setup(12, 10, 8, dtype=torch.float64, quiet=True, device="cpu",
                             **PERIODIC4)
    fused = td.make_multi_step(params, 4, fused_k=2)
    T = state[0].clone().requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, _ = fused(T, state[1])
    assert out.requires_grad and torch.equal(out.detach(), fused(*state)[0])
