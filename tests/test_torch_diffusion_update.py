"""`ops.diffusion_update`: the diffusion model's per-step update as one pass.

On the CPU: the op's plain version equals the model's update as it was
written before the kernel (`_pre_change_update`, kept here verbatim) bit for
bit on blocks, batches and `ops.overlap`'s windows; a CPU call counts no
launch; the model's route follows the device, the dtype and autograd, and
its gradients equal the plain ones; a CUDA tensor of a dtype or view the
kernel does not take raises (fake CUDA tensors: nothing reaches a card).

On the card (``cuda`` marker; this file imports no JAX, so it runs there:
``python -m pytest --noconftest -m cuda tests/test_torch_diffusion_update.py``):
the kernel against the plain version, bit for bit, in float32, float64,
bfloat16 and float16, at odd extents, on a batch, on `hide_communication`'s windows, and in
`make_step` on periodic and non-periodic grids; every launch counted.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.ops import diffusion_update as du
from implicitglobalgrid_tpu_torch.ops import overlap as ov
from implicitglobalgrid_tpu_torch.ops.halo import update_halo

COEFFS = (1.0, 0.003, 0.31, 0.27, 0.23)  # lam, dt, dx, dy, dz


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _pre_change_update(T, Cp, lam, dt, dx, dy, dz):
    """`models.diffusion3d._diffusion_update`'s body before the kernel."""
    c = T[..., 1:-1, 1:-1, 1:-1]
    lap = (
        (T[..., 2:, 1:-1, 1:-1] - 2 * c + T[..., :-2, 1:-1, 1:-1]) / (dx * dx)
        + (T[..., 1:-1, 2:, 1:-1] - 2 * c + T[..., 1:-1, :-2, 1:-1]) / (dy * dy)
        + (T[..., 1:-1, 1:-1, 2:] - 2 * c + T[..., 1:-1, 1:-1, :-2]) / (dz * dz)
    )
    delta = torch.div(torch.tensor(dt * lam, dtype=T.dtype),
                      Cp[..., 1:-1, 1:-1, 1:-1]) * lap
    out = T.clone()
    out[..., 1:-1, 1:-1, 1:-1] = c + delta
    return out


def _fields(shape, dtype, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    T = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    Cp = 1 + torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return T, Cp


def _windows(T, Cp, w=2, radius=1):
    """The views `ops.overlap` hands an update: each halo dimension's two
    boundary windows and the interior crop (every dimension exchanging)."""
    lead = T.dim() - 3
    out = []
    for d in range(3):
        a, e = d + lead, w + radius
        out.append((T.narrow(a, 0, e), Cp.narrow(a, 0, e)))
        out.append((T.narrow(a, T.shape[a] - e, e), Cp.narrow(a, Cp.shape[a] - e, e)))
    ti, ci = T, Cp
    for d in range(3):
        ti, ci = ov._crop(ti, d + lead, w - radius), ov._crop(ci, d + lead, w - radius)
    out.append((ti, ci))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["block", "odd block", "batch", "windows", "batch windows"])
def test_plain_version_equals_the_pre_change_update(dtype, case):
    shape = {"block": (16, 12, 10), "odd block": (9, 20, 37), "batch": (3, 11, 9, 13),
             "windows": (12, 10, 14), "batch windows": (2, 12, 10, 14)}[case]
    T, Cp = _fields(shape, dtype)
    pairs = _windows(T, Cp) if "windows" in case else [(T, Cp)]
    for t, cp in pairs:
        got = du.diffusion_update_reference(t, cp, *COEFFS)
        assert torch.equal(got, _pre_change_update(t, cp, *COEFFS))
        assert torch.equal(du.diffusion_update(t, cp, *COEFFS), got)
        assert got.is_contiguous() and got.shape == t.shape
    assert len(pairs) == (7 if "windows" in case else 1)
    assert any(not t.is_contiguous() for t, _ in pairs) == ("windows" in case)


def test_cpu_call_counts_no_launch(monkeypatch):
    monkeypatch.setattr(du, "launches", 0)
    T, Cp = _fields((8, 9, 10), torch.float32)
    du.diffusion_update(T, Cp, *COEFFS)
    (T0, Cp0), params = td.setup(8, 8, 8, periodx=1, dtype=torch.float64, device="cpu",
                                 quiet=True)
    td.make_multi_step(params, 2)(T0, Cp0)
    assert du.launches == 0


def _spy(monkeypatch):
    calls = {"op": 0, "plain": 0, "grad": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(du, "diffusion_update", counted("op", du.diffusion_update))
    monkeypatch.setattr(du, "diffusion_update_reference",
                        counted("plain", du.diffusion_update_reference))
    monkeypatch.setattr(ov._PlainGrad, "apply", counted("grad", ov._PlainGrad.apply))
    return calls


@pytest.mark.parametrize("dtype,grad,want", [
    (torch.float32, False, {"op": 1, "plain": 1, "grad": 0}),   # the op (CPU: its plain version)
    (torch.float64, False, {"op": 1, "plain": 1, "grad": 0}),
    (torch.bfloat16, False, {"op": 1, "plain": 1, "grad": 0}),  # the half types too
    (torch.float16, False, {"op": 1, "plain": 1, "grad": 0}),
    (torch.float64, True, {"op": 1, "plain": 1, "grad": 1}),    # op forward, plain backward
])
def test_route_follows_device_dtype_and_grad(monkeypatch, dtype, grad, want):
    calls = _spy(monkeypatch)
    params = td.Params(lam=1.0, dx=0.3, dy=0.3, dz=0.3, dt=0.002, dtype=dtype)
    T, Cp = _fields((8, 9, 10), torch.float64)
    T, Cp = T.to(dtype).requires_grad_(grad), Cp.to(dtype)
    out = td._diffusion_update(params)(T, Cp)
    assert calls == want
    assert torch.equal(out.detach(), _pre_change_update(T.detach(), Cp, *(
        params.lam, params.dt, params.dx, params.dy, params.dz)))
    if grad:
        (g,) = torch.autograd.grad(out.square().sum(), T)
        assert calls == {"op": 1, "plain": 2, "grad": 1}  # the backward recomputed the plain one
        T2 = T.detach().clone().requires_grad_()
        out2 = _pre_change_update(T2, Cp, params.lam, params.dt, params.dx, params.dy, params.dz)
        (g2,) = torch.autograd.grad(out2.square().sum(), T2)
        assert torch.equal(g, g2)


@pytest.mark.parametrize("cadence", ["make_step", "exchange_every=2", "hide_comm"])
def test_gradients_equal_the_plain_ones(monkeypatch, cadence):
    """Gradients w.r.t. T and Cp through a periodic grid's cadence: the
    routed update (op forward, plain backward) against the pre-change update
    differentiated as it is."""
    kw = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)
    (T, Cp), params = td.setup(10, 12, 9, dtype=torch.float64, device="cpu", quiet=True,
                               hide_comm=cadence == "hide_comm", **kw)

    def grads():
        step = (td.make_multi_step(params, 4, exchange_every=2) if cadence == "exchange_every=2"
                else td.make_step(params))
        t, c = T.clone().requires_grad_(), Cp.clone().requires_grad_()
        t2, c2 = t, c
        for _ in range(1 if cadence == "exchange_every=2" else 3):
            t2, c2 = step(t2, c2)
        return torch.autograd.grad((t2 * t2).sum() + (t2 * c2).sum(), (t, c))

    calls = _spy(monkeypatch)
    routed = grads()
    assert calls["op"] > 0 and calls["grad"] > 0
    monkeypatch.setattr(td, "_diffusion_update", lambda p: lambda t, c: _pre_change_update(
        t, c, p.lam, p.dt, p.dx, p.dy, p.dz))
    plain = grads()
    for a, b in zip(routed, plain):
        assert torch.equal(a, b)


def test_fused_cadence_backward_stays_plain(monkeypatch):
    """The fused cadence's plain steps (its backward) never call the op."""
    kw = dict(periodx=1, overlapx=4, overlapy=4, overlapz=4)
    (T, Cp), params = td.setup(16, 32, 24, dtype=torch.float64, device="cpu", quiet=True, **kw)
    step = td.make_multi_step(params, 4, fused_k=2)
    calls = _spy(monkeypatch)
    t = T.clone().requires_grad_()
    (g,) = torch.autograd.grad(step(t, Cp)[0].square().sum(), t)
    assert calls["op"] == 0 and calls["plain"] > 0 and torch.isfinite(g).all()


def _fake_cuda(shape, dtype=torch.float32, strides=None):
    if strides is None:
        strides = tuple(torch.empty(shape, device="meta").stride())
    return torch.empty_strided(shape, strides, dtype=dtype, device="cuda")


@pytest.mark.parametrize("case,match", [
    ("int32", "not float32, float64, bfloat16 or float16"),
    ("float8", "not float32, float64, bfloat16 or float16"),
    ("z stride", "unit-stride"),
    ("Cp z stride", "unit-stride"),
    ("shape", "share a shape"),
    ("dtype", "share a dtype"),
    ("rank", r"a block is \(n0, n1, n2\)"),
])
def test_cuda_tensor_the_kernel_does_not_take_raises(monkeypatch, case, match):
    """Fake CUDA tensors (shapes, strides and dtypes, no card): the wrapper
    raises before any launch, and never falls back to the plain version."""
    monkeypatch.setattr(du, "launches", 0)
    monkeypatch.setattr(du, "diffusion_update_reference", lambda *a: pytest.fail("fell back"))
    shape = (6, 7, 8)
    with FakeTensorMode():
        T, Cp = _fake_cuda(shape), _fake_cuda(shape)
        if case in ("int32", "float8"):
            dt = torch.int32 if case == "int32" else torch.float8_e4m3fn
            T, Cp = _fake_cuda(shape, dt), _fake_cuda(shape, dt)
        elif case == "z stride":
            T = _fake_cuda(shape, strides=(112, 16, 2))
        elif case == "Cp z stride":
            Cp = _fake_cuda(shape, strides=(112, 16, 2))
        elif case == "shape":
            Cp = _fake_cuda((6, 7, 9))
        elif case == "dtype":
            Cp = _fake_cuda(shape, torch.float64)
        else:
            T, Cp = _fake_cuda((5, 6, 7, 8, 2)), _fake_cuda((5, 6, 7, 8, 2))
        with pytest.raises(ValueError, match=match):
            du.diffusion_update(T, Cp, *COEFFS)
    assert du.launches == 0


def test_views_the_kernel_takes():
    """Every window `ops.overlap` hands the update is unit-stride along z;
    a contiguous float32 block takes 16-byte accesses, a window or an odd z
    extent single cells."""
    T, Cp = _fields((12, 10, 16), torch.float32)
    assert all(du.support_error(t, c) is None for t, c in _windows(T, Cp))
    assert du.vector_width(T, Cp) == 4
    assert du.vector_width(*_windows(T, Cp)[-1]) == 1
    assert du.vector_width(*_fields((12, 10, 15), torch.float32)) == 1
    assert du.vector_width(*_fields((3, 12, 10, 16), torch.float64)) == 2
    assert du.vector_width(*_fields((12, 10, 16), torch.bfloat16)) == 8
    assert du.vector_width(*_fields((12, 10, 12), torch.float16)) == 1


def test_coefficients_round_as_torch_on_the_card():
    """``1 / (dx*dx)`` taken in double precision, then rounded to the dtype
    (on an H100 with torch 2.11 ``(ones / (dx*dx)).item()`` read
    10.405827522277832 for dx = 0.31, where the float32 quotient of the
    float32 operands is 10.405826568603516); ``dt*lam`` rounded to it.
    bfloat16 and float16 take the float32 reciprocals, which torch computes
    them in, and ``dt*lam`` rounded to their own type."""
    ix, iy, iz, s = du.coefficients(torch.float32, *COEFFS)
    assert ix == 10.405827522277832
    assert ix == float(torch.tensor(1 / COEFFS[2] ** 2, dtype=torch.float32))
    assert s == float(torch.tensor(COEFFS[0] * COEFFS[1], dtype=torch.float32))
    assert du.coefficients(torch.float64, *COEFFS) == (
        1 / COEFFS[2] ** 2, 1 / COEFFS[3] ** 2, 1 / COEFFS[4] ** 2, COEFFS[0] * COEFFS[1])
    for half in (torch.bfloat16, torch.float16):
        *inv, s_half = du.coefficients(half, *COEFFS)
        assert inv == [ix, iy, iz]
        assert s_half == float(torch.tensor(COEFFS[0] * COEFFS[1], dtype=half)) != s


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run this file with "
                    "--noconftest -m cuda on one")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((37, 45, 70), torch.float32), ((37, 45, 72), torch.float32),
    ((37, 45, 70), torch.float64), ((9, 20, 37), torch.float32),
    ((5, 3, 300), torch.float32), ((261, 33, 257), torch.float32),
    ((3, 37, 45, 72), torch.float32), ((3, 37, 45, 70), torch.float64),
    ((2, 1, 3), torch.float32),
    ((37, 45, 72), torch.bfloat16), ((37, 45, 70), torch.bfloat16),
    ((3, 37, 45, 264), torch.bfloat16), ((37, 45, 72), torch.float16),
    ((9, 20, 37), torch.float16), ((3, 37, 45, 264), torch.float16),
])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype):
    """Odd extents (one >= 256), a batch of 3, a block with no interior."""
    T, Cp = _fields(shape, dtype, cuda_device)
    before = du.launches
    got = du.diffusion_update(T, Cp, *COEFFS)
    torch.cuda.synchronize()
    assert du.launches == before + 1
    assert torch.equal(got, du.diffusion_update_reference(T, Cp, *COEFFS))
    if T.dim() == 4:
        for b in range(shape[0]):
            assert torch.equal(got[b], du.diffusion_update(T[b], Cp[b], *COEFFS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
def test_cuda_kernel_on_overlap_windows(cuda_device, dtype):
    T, Cp = _fields((2, 40, 36, 64), dtype, cuda_device)
    for t, c in (*_windows(T, Cp), *_windows(T[1], Cp[1])):
        before = du.launches
        got = du.diffusion_update(t, c, *COEFFS)
        assert du.launches == before + 1
        assert torch.equal(got, du.diffusion_update_reference(t, c, *COEFFS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("grid", ["periodic", "non-periodic", "periodic hide_comm"])
def test_cuda_make_step_matches_plain(cuda_device, dtype, grid):
    kw = dict(periodx=1, periody=1, periodz=1) if "periodic" in grid.split() else {}
    (T, Cp), params = td.setup(48, 40, 70, dtype=dtype, device=cuda_device, quiet=True,
                               hide_comm="hide_comm" in grid, **kw)
    plain = td._plain_update(params)
    plain_step = (ov.overlapped(plain, 1, None, lead=0) if params.hide_comm
                  else lambda t, c: update_halo(plain(t, c)))
    step = td.make_step(params)
    t, tp = T, T.clone()
    before = du.launches
    for _ in range(3):
        t, _ = step(t, Cp)
        tp = plain_step(tp, Cp)
    torch.cuda.synchronize()
    assert du.launches == before + 3 * (7 if params.hide_comm else 1)
    assert torch.equal(t, tp)
