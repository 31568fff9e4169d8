"""The port's ensembles (`models._batched`, ``batch=True``) against the JAX
package and against the port's own unbatched runs.

* Against JAX: each member of a batched port step equals the JAX package's
  UNBATCHED step of that member (JAX's batched fused cadence is no oracle:
  ROADMAP Queue C), on one rank with periodic x/y/z (self partners) and on
  two gloo ranks split in x (periodic, and non-periodic with PROC_NULL
  edges).  Tolerances are the model tests': float64 1e-12 relative to the
  field's scale, float32 four ULPs of it, and the fused cadences against the
  JAX kernels through the Pallas interpreter rtol = atol = 2e-5.
* Against the port itself, bit for bit: every cadence (per step,
  ``hide_comm``, ``exchange_every``, ``fused_k`` serialized and forced
  pipelined, porous lead iteration and chunks) batched against each member
  run alone, on one and on two ranks; one 2-rank spawn per configuration
  runs every cadence of the three models.
* The collective budget: the exchange issues as many ``P2POp``s per
  dimension for B = 3 as for B = 1.
* The kernels' batched plain versions equal their 3-D plain versions per
  member, batched subset launches equal ``"all"``; on the card (``cuda``
  marker, skipped here) the batched launch against B single launches.
* The `_batched` API: stack/member/set_member, `select_members`,
  `check_members_finite`, `gather(member=k)`, `make_batched_residual`.
"""

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
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import _batched as tb
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

DT = {np.float32: (jnp.float32, torch.float32), np.float64: (jnp.float64, torch.float64)}

#: model -> (JAX module, port module, worker kind, field names, setup kwargs)
MODELS = {
    "diffusion": (jd, td, "multi_step", ("T", "Cp"), {}),
    "acoustic": (ja, ta, "acoustic", ("P", "Vx", "Vy", "Vz"), {}),
    "porous": (jpc, tpc, "porous", ("T", "Pf", "qDx", "qDy", "qDz"), dict(npt=3)),
}


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _jax_members(jm, nxyz, nb, dtype, ndev=1, **kw):
    """Each member's JAX initial state (numpy, global-block layout) from the
    JAX package's own `batched_setup`, and the shared params."""
    bstate, jparams = jb.batched_setup(jm, *nxyz, batch=nb, dtype=DT[dtype][0], quiet=True,
                                       devices=jax.devices()[:ndev], **kw)
    arrays = [np.asarray(a) for a in bstate]
    return [tuple(a[b] for a in arrays) for b in range(nb)], jparams


def _scale(w):
    return max(float(np.abs(w).max()), 1.0)


def _assert_close(got, want, dtype, what):
    rel = 1e-12 if dtype == np.float64 else 4 * np.finfo(np.float32).eps
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * _scale(want), err_msg=what)


# -- against the JAX package, one rank -----------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", list(MODELS))
def test_make_step_matches_jax_per_member_one_rank(model, dtype):
    """B=3 members, n=8, two `make_step(batch=True)` steps on a periodic
    x/y/z block (every exchange a self copy), member for member against the
    JAX package's unbatched step."""
    jm, tm, _, names, skw = MODELS[model]
    kw = dict(periodx=1, periody=1, periodz=1)
    members, jparams = _jax_members(jm, (8, 8, 8), 3, dtype, **kw, **skw)
    tigg.init_global_grid(8, 8, 8, quiet=True, device="cpu", **kw)
    state = tb.stack_states([tm.state_from_numpy(*m) for m in members])
    step = tm.make_step(tm.params_from(jparams), batch=True)
    for _ in range(2):
        state = step(*state)
    jstep = jm.make_step(jparams, donate=False)
    for b, m in enumerate(members):
        want = tuple(map(jnp.asarray, m))
        for _ in range(2):
            want = jstep(*want)
        for name, g, w in zip(names, state, want):
            assert g.dtype == DT[dtype][1]
            _assert_close(g[b].numpy(), np.asarray(w), dtype, f"{name} member {b}")


@pytest.mark.parametrize("model", list(MODELS))
def test_fused_cadence_matches_jax_kernel_per_member(model):
    """``fused_k=2`` on B=2 batched (16, 32, 128) float32 blocks, periodic in
    x with overlap 4, against the JAX package's unbatched kernel cadence of
    each member (its kernel through the Pallas interpreter), and bit for
    bit against the port's unbatched cadence."""
    jm, tm, _, names, skw = MODELS[model]
    grid = dict(periodx=1, overlapx=4)
    skw = dict(npt=4) if model == "porous" else {}
    nxyz, nt = (16, 32, 128), (1 if model == "porous" else 2)
    members, jparams = _jax_members(jm, nxyz, 2, np.float32, **grid, **skw)
    with pallas_force_interpret():
        step = jm.make_multi_step(jparams, nt, donate=False, fused_k=2, pipelined=False)
        wants = [jax.block_until_ready(step(*map(jnp.asarray, m))) for m in members]
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **grid)
    params = tm.params_from(jparams)
    singles = [tm.state_from_numpy(*m) for m in members]
    got = tm.make_multi_step(params, nt, fused_k=2, pipelined=False, batch=True)(
        *tb.stack_states(singles))
    for b, (single, want) in enumerate(zip(singles, wants)):
        alone = tm.make_multi_step(params, nt, fused_k=2, pipelined=False)(*single)
        for name, g, a, w in zip(names, got, alone, want):
            assert torch.equal(g[b], a), f"{name} member {b}"
            w = np.asarray(w)
            assert float(np.abs(g[b].numpy() - w).max()) / _scale(w) < 2e-5, name


# -- against the port's own unbatched runs, one rank ----------------------------

CADENCES = {
    "per step": dict(),
    "hide_comm": dict(hide_comm=True),
    "exchange_every=2": dict(exchange_every=2),
    "fused_k=2": dict(fused_k=2, pipelined=False),
    "fused_k=2 pipelined": dict(fused_k=2, fused_tile=(8, 8), pipelined=True),
}


def _grid4(**kw):
    return dict(overlapx=4, overlapy=4, overlapz=4, **kw)


@pytest.mark.parametrize("cadence", list(CADENCES))
@pytest.mark.parametrize("model", list(MODELS))
def test_cadences_bitwise_against_unbatched_one_rank(model, cadence):
    """Every cadence, batched (B=3) against each member alone, bit for bit,
    on a periodic x/y/z float64 block (32, 30, 12) (porous npt=5: a lead
    iteration and the chunks [2, 2])."""
    _, tm, _, names, _ = MODELS[model]
    skw = dict(npt=5) if model == "porous" else {}
    nsteps = 1 if model == "porous" else 4
    state, params = tb.batched_setup(tm, 32, 30, 12, batch=3, dtype=torch.float64, quiet=True,
                                     device="cpu", **_grid4(periodx=1, periody=1, periodz=1),
                                     **skw)
    step_kw = dict(CADENCES[cadence])
    params = tm.Params(**{**params.__dict__, "hide_comm": step_kw.pop("hide_comm", False)})
    got = tm.make_multi_step(params, nsteps, batch=True, **step_kw)(*state)
    for b in range(3):
        alone = tm.make_multi_step(params, nsteps, **step_kw)(*tb.member_state(state, b))
        for name, g, a in zip(names, got, alone):
            assert torch.equal(g[b], a), f"{name} member {b}"


def test_make_step_batch_equals_make_multi_step_batch():
    state, params = tb.batched_setup(td, 10, 9, 8, batch=2, dtype=torch.float64, quiet=True,
                                     device="cpu", periodx=1)
    want = td.make_multi_step(params, 2, batch=True)(*state)
    step = td.make_step(params, batch=True)
    got = step(*step(*state))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("model", list(MODELS))
def test_batched_steps_reject_unbatched_fields(model):
    _, tm, _, _, skw = MODELS[model]
    state, params = tm.setup(8, 8, 8, dtype=torch.float64, quiet=True, device="cpu", **skw)
    for fn in (tm.make_step(params, batch=True), tm.make_multi_step(params, 1, batch=True)):
        with pytest.raises(ValueError, match=r"a batched field is \(B, n0, n1, n2\)"):
            fn(*state)
    mixed = (torch.stack([state[0]] * 2), *(torch.stack([a] * 3) for a in state[1:]))
    with pytest.raises(ValueError, match="different numbers of members"):
        tm.make_step(params, batch=True)(*mixed)


# -- two gloo ranks -------------------------------------------------------------

SPAWN_STEPS = [dict(), dict(hide_comm=True), dict(exchange_every=2),
               dict(fused_k=2, pipelined=False),
               dict(fused_k=2, fused_tile=[8, 8], pipelined=True)]


def _params_json(tm, jparams):
    p = tm.params_from(jparams)
    pj = {k: v for k, v in p.__dict__.items() if k != "dtype"}
    pj["dtype"] = "float64"
    return pj


@pytest.mark.parametrize("periodx", [1, 0], ids=["periodic", "non-periodic"])
def test_two_ranks_match_jax_and_unbatched(periodx, tmp_path):
    """Two gloo ranks split in x (``dimx=2``), every model and cadence in one
    spawn, B=3 float64 (32, 30, 12) blocks.  Per member and rank: the
    batched port equals its unbatched port run bit for bit on every cadence,
    and the JAX package's unbatched 2-device run (per step and ``fused_k=2``,
    which JAX runs in float64 as its plain cadence) within 1e-12.  The
    periodic spawn also runs B=1 to hold the P2POp count per dimension to the
    B=3 count; the non-periodic one poisons member 1 on rank 1 only and
    checks that only it is flagged on both ranks."""
    nxyz, nb = (32, 30, 12), 3
    grid = dict(dimx=2, periodx=periodx, **_grid4())
    runs, inputs, wants, porous_params = [], {}, {}, None
    for model, (jm, tm, kind, names, _) in MODELS.items():
        skw = dict(npt=5) if model == "porous" else {}
        nsteps = 1 if model == "porous" else 4
        members, jparams = _jax_members(jm, nxyz, nb, np.float64, ndev=2, **grid, **skw)
        assert jax.numpy.asarray(members[0][0]).shape[0] == 2 * nxyz[0]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # JAX's float64 fused fallback
            for i, step in ((0, {}), (3, dict(fused_k=2, pipelined=False))):
                fn = jm.make_multi_step(jparams, nsteps, donate=False, **step)
                for b, m in enumerate(members):
                    wants[model, i, b] = [np.asarray(a) for a in fn(*map(jnp.asarray, m))]
        jigg.finalize_global_grid()
        pj = _params_json(tm, jparams)
        if model == "porous":
            porous_params = pj
        for pre, count in ((model[0], nb), (model[0] + "1", 1)) if periodx else ((model[0], nb),):
            runs.append(dict(model=kind, params=pj, nsteps=nsteps, batch=count, steps=SPAWN_STEPS,
                             prefix=pre))
            for b in range(count):
                inputs.update({f"{pre}{n}@{b}": a for n, a in zip(names, members[b])})
    task = dict(kind="batched", nxyz=list(nxyz), grid=grid, runs=runs, inputs=inputs)
    if not periodx:
        task["finite_probe"] = dict(rank=1, member=1)
    outs = spawn(task, 2, tmp_path, timeout=240)
    for rank, out in enumerate(outs):
        for model, (_, _, _, names, _) in MODELS.items():
            pre = model[0]
            for i in range(len(SPAWN_STEPS)):
                for b in range(nb):
                    for name in names:
                        got = out[f"{pre}{name}{i}@{b}"]
                        assert np.array_equal(got, out[f"{pre}{name}{i}@{b}u"]), (
                            model, i, b, name, rank)
                        if (model, i, b) in wants:
                            w = dict(zip(names, wants[model, i, b]))[name]
                            n = w.shape[0] // 2  # rank r holds rows [r*n, (r+1)*n)
                            np.testing.assert_allclose(
                                got, w[rank * n:(rank + 1) * n], rtol=1e-12,
                                atol=1e-12 * _scale(w), err_msg=f"{model} {i} {name} {b} {rank}")
                p2p = out[f"{pre}p2p{i}"]
                assert p2p[0] > 0 and p2p[1] == p2p[2] == 0, (model, i, p2p)
                if periodx:
                    assert np.array_equal(p2p, out[f"{pre}1p2p{i}"]), (model, i)
            if model == "porous":
                for i in range(len(SPAWN_STEPS)):
                    assert np.array_equal(out[f"pres{i}"], outs[0][f"pres{i}"])
        if not periodx:
            assert out["finite"].tolist() == [False, True, False]
    # The all-reduced residual: each member's largest block defect of both ranks.
    pp = tpc.Params(**{**porous_params, "dtype": torch.float64})
    for i in range(len(SPAWN_STEPS)):
        local = [_block_residual(out, i, nb, pp) for out in outs]
        np.testing.assert_array_equal(outs[0][f"pres{i}"], np.maximum(*local))


def _block_residual(out, i, nb, params):
    """Each member's ``max |div qD|`` over the interior cells of one rank's
    block, from the spawn's saved fluxes."""
    res = []
    for b in range(nb):
        q = [torch.from_numpy(out[f"p{n}{i}@{b}"]) for n in ("qDx", "qDy", "qDz")]
        res.append(float(tpc._inn(tpc._divergence(*q, params)).abs().max()))
    return np.array(res)


# -- the kernels' batched calls ---------------------------------------------------

LF = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)  # cax, cay, caz, b, idx, idy, idz
PT = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)  # th, idx, idy, idz, ralam, bp
DIFF = (1 / 8.1, 0.5 / 8.1, 0.25 / 8.1)  # cx, cy, cz

#: kernel -> (module, k, call(inputs, k, **launch), plain(inputs, k, **launch))
KERNELS = {
    "fused_diffusion_steps": (fs, 4, lambda ins, k, **kw: (fs.fused_diffusion_steps(
        *ins, k, *DIFF, **kw),), lambda ins, k, **kw: (fs.fused_diffusion_steps_reference(
            *ins, k, *DIFF, **kw),)),
    "fused_leapfrog_steps": (fl, 6, lambda ins, k, **kw: fl.fused_leapfrog_steps(
        *ins, k, *LF, **kw), lambda ins, k, **kw: fl.fused_leapfrog_steps_reference(
            *ins, k, *LF, **kw)),
    "fused_pt_iterations": (fp, 6, lambda ins, k, **kw: fp.fused_pt_iterations(
        *ins, k, *PT, **kw), lambda ins, k, **kw: fp.fused_pt_iterations_reference(
            *ins, k, *PT, **kw)),
}


def _kernel_inputs(name, nb, shape, device="cpu", dtype=torch.float64, seed=0):
    """Seeded numpy inputs of ``nb`` members (cells, then faces)."""
    rng = np.random.default_rng(seed)

    def field(s, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal((nb, *s))).to(device, dtype)

    if name == "fused_diffusion_steps":
        return (field(shape), 1 + field(shape).abs())
    cells = [field(shape) for _ in range(2 if name == "fused_pt_iterations" else 1)]
    return (*cells, *(field(s, 0.1) for s in fl.face_shapes(shape)))


@pytest.mark.parametrize("name", list(KERNELS))
def test_batched_plain_version_equals_each_member(name):
    """The plain version of a batch equals, bit for bit, the plain version
    of each member alone (a ragged block; CPU tensors take the plain path
    of the wrapper, so no launch is counted)."""
    mod, k, call, plain = KERNELS[name]
    ins = _kernel_inputs(name, 3, (13, 15, 14))
    before = mod.launches
    got = call(ins, k)
    assert mod.launches == before
    for b in range(3):
        want = plain(tuple(a[b] for a in ins), k)
        assert all(torch.equal(g[b], w) for g, w in zip(got, want)), b


@pytest.mark.parametrize("sel", ["0", "1", "01"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_batched_subset_launches_equal_all(name, sel):
    """Batched ring + mid (the mid pass writing into the ring pass's
    outputs) equal one batched ``"all"`` call at the same tile, bit for bit,
    ragged last tiles included."""
    mod, k, call, _ = KERNELS[name]
    shape = (37, 45, 70)
    ins = _kernel_inputs(name, 2, shape, seed=1)
    _, by, bz = mod.tile_for(shape, k, 8)
    tile = (10, by, bz)
    want = call(ins, k, tile=tile)
    ring = call(ins, k, tile=tile, tile_sel="ring" + sel)
    got = call(ins, k, tile=tile, tile_sel="mid" + sel, carry_in=ring)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(KERNELS))
def test_batched_kernel_calls_validate(name):
    mod, k, call, _ = KERNELS[name]
    ins = _kernel_inputs(name, 2, (8, 8, 8))
    with pytest.raises(ValueError, match="must|share"):
        call((ins[0][:1], *ins[1:]), k)  # one field with another member count
    with pytest.raises(ValueError, match=r"batch \(B, n0, n1, n2\)"):
        call(tuple(a[None] for a in ins), k)  # rank 5
    with pytest.raises(ValueError, match=r"batch \(B, n0, n1, n2\)"):
        call(tuple(a[:0] for a in ins), k)  # no member
    if name == "fused_leapfrog_steps":
        with pytest.raises(ValueError, match="carry_in must hold"):
            call(ins, k, tile=(2, 2, 8), tile_sel="mid01", carry_in=ins[:1])


def test_launch_grid_limit_counts_members():
    """An ``"all"`` launch folds its members into the x segments (65535 at
    most), a subset launch has one z entry per member."""
    fs.check_grid(65535, (256, 256), (256, 16, 32), "all")
    with pytest.raises(ValueError, match="at most 65535"):
        fs.check_grid(32768, (256, 256), (128, 16, 32), "all")
    fs.check_grid(65535, (256, 256), (64, 16, 32), "ring01")
    with pytest.raises(ValueError, match="at most 65535"):
        fs.check_grid(65536, (256, 256), (64, 16, 32), "mid01")


def test_batched_launch_cuts_fewer_x_segments():
    """The diffusion launch cuts x to fill the card's resident slots with
    the blocks of every member, so a batch takes fewer segments (each
    re-reads its halo planes); the staggered kernels march all of x."""
    shape, k = (256, 256, 256), 4
    assert fs.segments(shape, k, 4, resident=2, sms=132) == 2
    assert fs.segments(shape, k, 4, resident=2, sms=132, nb=4) == 1
    assert fs.segments((128,) * 3, k, 4, resident=2, sms=132) == 4
    assert fs.segments((128,) * 3, k, 4, resident=2, sms=132, nb=2) == 4
    assert fs.segments((128,) * 3, k, 4, resident=2, sms=132, nb=8) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KERNELS))
def test_batched_launch_on_the_card(name):
    """One batched launch against B single launches and against the batched
    plain version, bit for bit (the kernels are built with --fmad=false)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    mod, k, call, plain = KERNELS[name]
    for nb, shape in ((3, (37, 45, 70)), (2, (64, 64, 96))):
        ins = _kernel_inputs(name, nb, shape, device="cuda", dtype=torch.float32)
        before = mod.launches
        got = call(ins, k)
        torch.cuda.synchronize()
        assert mod.launches == before + 1
        for b in range(nb):
            single = call(tuple(a[b] for a in ins), k)
            assert all(torch.equal(g[b], s) for g, s in zip(got, single)), b
        assert all(torch.equal(g, w) for g, w in zip(got, plain(ins, k)))


# -- the _batched API -----------------------------------------------------------


def test_batched_setup_matches_jax_per_member():
    """Member b's initial state is the model's setup at ic_scale 1 +
    b/(8B), as the JAX package's `batched_setup` makes it (ICs within 4 ULPs
    of the field's scale)."""
    for model, (jm, tm, _, names, skw) in MODELS.items():
        members, _ = _jax_members(jm, (10, 9, 8), 3, np.float64, **skw)
        state, _ = tb.batched_setup(tm, 10, 9, 8, batch=3, dtype=torch.float64, quiet=True,
                                    device="cpu", **skw)
        assert tb.batch_size(state) == 3
        jigg.finalize_global_grid()
        for b, m in enumerate(members):
            for name, g, w in zip(names, state, m):
                np.testing.assert_allclose(g[b].numpy(), w, rtol=0,
                                           atol=4 * np.finfo(np.float64).eps * _scale(w),
                                           err_msg=f"{model} {name} {b}")
        tigg.finalize_global_grid()
    with pytest.raises(ValueError, match="batch must be >= 1"):
        tb.batched_setup(td, 8, 8, 8, batch=0, device="cpu")
    with pytest.raises(ValueError, match="ic_scales has 1 entries for batch=2"):
        tb.batched_setup(td, 8, 8, 8, batch=2, ic_scales=[1.0], device="cpu", quiet=True)


def test_stack_member_set_member_round_trip():
    state, params = tb.batched_setup(ta, 8, 7, 6, batch=3, dtype=torch.float64, quiet=True,
                                     device="cpu")
    members = [tb.member_state(state, b) for b in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(tb.stack_states(members), state))
    # A member is a copy: an in-place exchange on it leaves the batch alone.
    before = [a.clone() for a in state]
    tigg.update_halo(*members[1][1:])
    members[1][0].fill_(7.0)
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    new = tuple(torch.full_like(a, float(i)) for i, a in enumerate(members[0]))
    out = tb.set_member_state(state, new, 2)
    assert all(o is s for o, s in zip(out, state))
    assert all(torch.equal(s[2], n) for s, n in zip(state, new))
    assert all(torch.equal(s[:2], b[:2]) for s, b in zip(state, before))
    with pytest.raises(ValueError, match="mixed ranks"):
        tb.stack_fields(state[0][0], state[0])
    with pytest.raises(ValueError, match="different field counts"):
        tb.stack_states([members[0], members[1][:2]])
    with pytest.raises(ValueError, match="needs a batched field"):
        tb.member_field(torch.zeros(4), 0)
    assert tb.batched_stencil(td.make_step, 2) is td.make_step


def test_select_members_keeps_masked_members_bit_frozen():
    state, params = tb.batched_setup(tpc, 8, 8, 8, batch=3, npt=2, dtype=torch.float64,
                                     quiet=True, device="cpu")
    new = tpc.make_step(params, batch=True)(*state)
    got = tb.select_members(np.array([True, False, True]), new, state)
    for g, n, o in zip(got, new, state):
        assert torch.equal(g[0], n[0]) and torch.equal(g[2], n[2])
        assert torch.equal(g[1], o[1])
    with pytest.raises(ValueError, match="mask has shape"):
        tb.select_members([True, False], new, state)


def test_check_members_finite_flags_only_the_poisoned_member():
    state, _ = tb.batched_setup(td, 8, 8, 8, batch=4, dtype=torch.float32, quiet=True,
                                device="cpu")
    assert tb.check_members_finite(state).tolist() == [False] * 4
    state[1][2, 3, 3, 3] = float("inf")
    state[0][0, 0, 0, 0] = float("nan")
    assert tb.check_members_finite(state).tolist() == [True, False, True, False]


def test_gather_member():
    state, params = tb.batched_setup(td, 10, 9, 8, batch=2, dtype=torch.float64, quiet=True,
                                     device="cpu", periodx=1)
    state = td.make_multi_step(params, 2, batch=True)(*state)
    for b in range(2):
        assert np.array_equal(tigg.gather(state[0], member=b), state[0][b].numpy())
    with pytest.raises(ValueError, match="member=k"):
        tigg.gather(state[0])
    with pytest.raises(ValueError, match=r"member must be in \[0, 2\)"):
        tigg.gather(state[0], member=2)
    with pytest.raises(ValueError, match="needs a batched field"):
        tigg.gather(state[0][0], member=0)


def test_batched_residual_matches_jax_per_member():
    """`make_batched_residual` after two batched steps against the JAX
    package's residual of each member's unbatched run (float64, 1e-12
    relative)."""
    members, jparams = _jax_members(jpc, (12, 10, 14), 3, np.float64, periodx=1, overlapx=4,
                                    npt=3)
    jstep = jpc.make_multi_step(jparams, 2, donate=False)
    jres = jax.jit(jpc._pt_residual_block(jparams))
    want = [float(jres(*jstep(*map(jnp.asarray, m)))) for m in members]
    tigg.init_global_grid(12, 10, 14, quiet=True, device="cpu", periodx=1, overlapx=4)
    params = tpc.params_from(jparams)
    state = tb.stack_states([tpc.state_from_numpy(*m) for m in members])
    got = tpc.make_batched_residual(params)(*tpc.make_multi_step(params, 2, batch=True)(*state))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert len(set(want)) == 3  # distinct members
