"""`ops.temperature_update`: the porous model's temperature update as one pass.

On the CPU: the op's plain version equals the model's update as it was
written before the kernel (`_pre_change_update`, kept here verbatim) bit for
bit on blocks, batches, odd extents and strided views; a CPU call counts no
launch; the model's route follows the device, the dtype and autograd (fake
CUDA tensors: nothing reaches a card), and its gradients equal the plain
ones; a CUDA tensor of a dtype, shape pairing or view the kernel does not
take raises.

On the card (``cuda`` marker; this file imports no JAX, so it runs there:
``python -m pytest --noconftest -m cuda tests/test_torch_temperature_update.py``):
the kernel against the plain version, bit for bit, in float32, float64,
bfloat16 and float16, at odd extents, on a batch, on strided views, and in
`make_multi_step(fused_k=6)` on a periodic-y grid and `make_step` on a
non-periodic one; every launch counted.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tp
from implicitglobalgrid_tpu_torch.ops import overlap as ov
from implicitglobalgrid_tpu_torch.ops import temperature_update as tu

COEFFS = (1e-3, 10.0, 3e-4, 0.31, 0.27, 0.23)  # lam, iphi, dt, dx, dy, dz
HALF = (torch.bfloat16, torch.float16)


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _inn(A):
    return A[..., 1:-1, 1:-1, 1:-1]


def _pre_change_update(T, qDx, qDy, qDz, lam, iphi, dt, dx, dy, dz):
    """`models.porous_convection3d._temperature_update`'s body before the kernel."""
    c = _inn(T)
    lap = (
        (T[..., 2:, 1:-1, 1:-1] - 2 * c + T[..., :-2, 1:-1, 1:-1]) / (dx * dx)
        + (T[..., 1:-1, 2:, 1:-1] - 2 * c + T[..., 1:-1, :-2, 1:-1]) / (dy * dy)
        + (T[..., 1:-1, 1:-1, 2:] - 2 * c + T[..., 1:-1, 1:-1, :-2]) / (dz * dz)
    )
    # Upwind advective derivatives at interior cells from face fluxes.
    qxm, qxp = qDx[..., 1:-2, 1:-1, 1:-1], qDx[..., 2:-1, 1:-1, 1:-1]
    qym, qyp = qDy[..., 1:-1, 1:-2, 1:-1], qDy[..., 1:-1, 2:-1, 1:-1]
    qzm, qzp = qDz[..., 1:-1, 1:-1, 1:-2], qDz[..., 1:-1, 1:-1, 2:-1]
    adv = (
        qxm.clamp_min(0.0) * ((c - T[..., :-2, 1:-1, 1:-1]) / dx)
        + qxp.clamp_max(0.0) * ((T[..., 2:, 1:-1, 1:-1] - c) / dx)
        + qym.clamp_min(0.0) * ((c - T[..., 1:-1, :-2, 1:-1]) / dy)
        + qyp.clamp_max(0.0) * ((T[..., 1:-1, 2:, 1:-1] - c) / dy)
        + qzm.clamp_min(0.0) * ((c - T[..., 1:-1, 1:-1, :-2]) / dz)
        + qzp.clamp_max(0.0) * ((T[..., 1:-1, 1:-1, 2:] - c) / dz)
    )
    delta = dt * (lam * lap - iphi * adv)
    T = T.clone()
    _inn(T).add_(delta)
    return T


def _face_shapes(shape):
    *lead, n0, n1, n2 = shape
    return [(*lead, n0 + 1, n1, n2), (*lead, n0, n1 + 1, n2), (*lead, n0, n1, n2 + 1)]


def _fields(shape, dtype, device="cpu", seed=0):
    """T ~ N(0, 1) and fluxes ~ N(0, 10) of both signs, so every upwind
    branch is taken."""
    gen = torch.Generator(device=device).manual_seed(seed)
    T = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return (T, *(10 * torch.randn(s, generator=gen, device=device, dtype=dtype)
                 for s in _face_shapes(shape)))


def _views(fields):
    """Strided views of every field: a window cut in x, y and z (z offset
    by one cell, so no row is 16-byte aligned) and one cut in x and y only."""
    T = fields[0]
    lead = T.dim() - 3
    out = []
    for z0 in (1, 0):
        cut = []
        for a in fields:
            for d in range(3):
                a = a.narrow(lead + d, 1 if d < 2 else z0, a.shape[lead + d] - 3)
            cut.append(a)
        out.append(tuple(cut))
    return out


def _ring(A):
    return torch.cat([A.select(d, i).flatten() for d in range(A.dim() - 3, A.dim())
                      for i in (0, -1)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["block", "odd block", "batch", "views", "batch views"])
def test_plain_version_equals_the_pre_change_update(dtype, case):
    shape = {"block": (16, 12, 10), "odd block": (9, 20, 37), "batch": (3, 11, 9, 13),
             "views": (12, 10, 14), "batch views": (3, 12, 10, 14)}[case]
    fields = _fields(shape, dtype)
    sets = _views(fields) if "views" in case else [fields]
    for f in sets:
        got = tu.temperature_update_reference(*f, *COEFFS)
        assert torch.equal(got, _pre_change_update(*f, *COEFFS))
        assert torch.equal(tu.temperature_update(*f, *COEFFS), got)
        assert got.shape == f[0].shape and torch.equal(_ring(got), _ring(f[0]))
        assert not torch.equal(_inn(got), _inn(f[0]))
    assert any(not a.is_contiguous() for f in sets for a in f) == ("views" in case)


def test_cpu_call_counts_no_launch(monkeypatch):
    monkeypatch.setattr(tu, "launches", 0)
    tu.temperature_update(*_fields((8, 9, 10), torch.float32), *COEFFS)
    state, params = tp.setup(8, 8, 8, npt=2, periodx=1, dtype=torch.float64, device="cpu",
                             quiet=True)
    tp.make_multi_step(params, 2, autotune=False)(*state)
    assert tu.launches == 0


def _params(dtype):
    return tp.Params(lam_T=1e-3, phi=0.1, dx=0.31, dy=0.27, dz=0.23, dt=3e-4, dtype=dtype)


def _model_coeffs(p):
    return (p.lam_T, 1.0 / p.phi, p.dt, p.dx, p.dy, p.dz)


def _spy(monkeypatch):
    calls = {"op": 0, "plain": 0, "grad": 0, "launch": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tu, "temperature_update", counted("op", tu.temperature_update))
    monkeypatch.setattr(tu, "temperature_update_reference",
                        counted("plain", tu.temperature_update_reference))
    monkeypatch.setattr(ov._PlainGrad, "apply", counted("grad", ov._PlainGrad.apply))
    monkeypatch.setattr(tu, "_launch", counted("launch", lambda *a: None))
    return calls


@pytest.mark.parametrize("dtype,grad,want", [
    (torch.float32, False, {"op": 1, "plain": 1, "grad": 0, "launch": 0}),  # CPU: the plain one
    (torch.float64, False, {"op": 1, "plain": 1, "grad": 0, "launch": 0}),
    (torch.bfloat16, False, {"op": 1, "plain": 1, "grad": 0, "launch": 0}),
    (torch.float16, False, {"op": 1, "plain": 1, "grad": 0, "launch": 0}),
    (torch.float64, True, {"op": 1, "plain": 1, "grad": 1, "launch": 0}),  # op fwd, plain bwd
])
def test_route_follows_device_dtype_and_grad_on_the_cpu(monkeypatch, dtype, grad, want):
    calls = _spy(monkeypatch)
    params = _params(dtype)
    T, *q = (a.to(dtype) for a in _fields((8, 9, 10), torch.float64))
    T.requires_grad_(grad)
    out = tp._temperature_update(params)(T, *q)
    assert calls == want
    assert torch.equal(out.detach(), _pre_change_update(T.detach(), *q, *_model_coeffs(params)))
    if grad:
        (g,) = torch.autograd.grad(out.square().sum(), T)
        assert calls["plain"] == 2  # the backward recomputed the plain version
        T2 = T.detach().clone().requires_grad_()
        (g2,) = torch.autograd.grad(
            _pre_change_update(T2, *q, *_model_coeffs(params)).square().sum(), T2)
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("grad", [False, True])
def test_route_of_a_cuda_tensor_is_the_kernel(monkeypatch, dtype, grad):
    """Fake CUDA tensors (no card): every dtype the kernel takes reaches one
    launch and never the plain version; under autograd the kernel is the
    forward of `fused_with_plain_grad` (its forward stands in for
    `_PlainGrad.apply`: autograd cannot record fake CUDA tensors without a
    card)."""
    calls = _spy(monkeypatch)

    def forward(fast, plain, *inputs):
        calls["grad"] += 1
        with torch.no_grad():
            return tuple(fast(*inputs))

    monkeypatch.setattr(ov._PlainGrad, "apply", forward)
    monkeypatch.setattr(tu, "launches", 0)
    with FakeTensorMode():
        T, *q = (torch.empty(s, dtype=dtype, device="cuda")
                 for s in [(6, 7, 8), *_face_shapes((6, 7, 8))])
        T.requires_grad_(grad)
        out = tp._temperature_update(_params(dtype))(T, *q)
        assert out.device.type == "cuda" and out.dtype == dtype and out.shape == T.shape
    assert calls == {"op": 1, "plain": 0, "grad": int(grad), "launch": 1}
    assert tu.launches == 1


@pytest.mark.parametrize("cadence", ["make_step", "fused_k=2"])
def test_gradients_equal_the_plain_ones(monkeypatch, cadence):
    """Gradients w.r.t. every state field through a periodic grid's cadence:
    the routed update (op forward, plain backward) against the pre-change
    update differentiated as it is."""
    kw = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)
    state, params = tp.setup(12, 10, 8, npt=5, dtype=torch.float64, device="cpu", quiet=True,
                             **kw)

    def grads():
        step = (tp.make_step(params) if cadence == "make_step"
                else tp.make_multi_step(params, 2, fused_k=2, autotune=False))
        s0 = [a.clone().requires_grad_() for a in state]
        s = s0
        for _ in range(2 if cadence == "make_step" else 1):
            s = step(*s)
        loss = sum((a * a).sum() for a in s) + (s[0] * s[4][..., 1:]).sum()
        return torch.autograd.grad(loss, s0)

    calls = _spy(monkeypatch)
    routed = grads()
    assert calls["op"] == 2 and calls["grad"] >= 2
    monkeypatch.setattr(tp, "_temperature_update", lambda p: lambda *f: _pre_change_update(
        *f, *_model_coeffs(p)))
    plain = grads()
    for a, b in zip(routed, plain):
        assert a.abs().max() > 0
        assert torch.equal(a, b)


def _fake_cuda(shape, dtype=torch.float32, strides=None):
    if strides is None:
        strides = tuple(torch.empty(shape, device="meta").stride())
    return torch.empty_strided(shape, strides, dtype=dtype, device="cuda")


@pytest.mark.parametrize("case,match", [
    ("int32", "not float32, float64, bfloat16 or float16"),
    ("float8", "not float32, float64, bfloat16 or float16"),
    ("T z stride", "T's z axis must be unit-stride"),
    ("qDz z stride", "qDz's z axis must be unit-stride"),
    ("qDx unstaggered", r"qDx of T \(6, 7, 8\) must be \(7, 7, 8\)"),
    ("qDy staggered in x", r"qDy of T \(6, 7, 8\) must be \(6, 8, 8\)"),
    ("qDz unstaggered", r"qDz of T \(6, 7, 8\) must be \(6, 7, 9\)"),
    ("batch of another size", r"qDx of T \(2, 6, 7, 8\) must be \(2, 7, 7, 8\)"),
    ("dtype", "T and qDy must share a dtype"),
    ("rank", r"a block is \(n0, n1, n2\)"),
])
def test_cuda_tensor_the_kernel_does_not_take_raises(monkeypatch, case, match):
    """Fake CUDA tensors (shapes, strides and dtypes, no card): the wrapper
    raises before any launch, and never falls back to the plain version."""
    monkeypatch.setattr(tu, "launches", 0)
    monkeypatch.setattr(tu, "temperature_update_reference", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(tu, "_launch", lambda *a: pytest.fail("launched"))
    shape = (6, 7, 8)
    with FakeTensorMode():
        f = [_fake_cuda(s) for s in [shape, *_face_shapes(shape)]]
        if case in ("int32", "float8"):
            dt = torch.int32 if case == "int32" else torch.float8_e4m3fn
            f = [_fake_cuda(a.shape, dt) for a in f]
        elif case == "T z stride":
            f[0] = _fake_cuda(shape, strides=(112, 16, 2))
        elif case == "qDz z stride":
            f[3] = _fake_cuda((6, 7, 9), strides=(126, 18, 2))
        elif case == "qDx unstaggered":
            f[1] = _fake_cuda(shape)
        elif case == "qDy staggered in x":
            f[2] = _fake_cuda((7, 7, 8))
        elif case == "qDz unstaggered":
            f[3] = _fake_cuda(shape)
        elif case == "batch of another size":
            f = [_fake_cuda((2, *shape)), *(_fake_cuda((3, *s)) for s in _face_shapes(shape))]
        elif case == "dtype":
            f[2] = _fake_cuda((6, 8, 8), torch.float64)
        else:
            f = [_fake_cuda((5, *a.shape, 2)) for a in f]
        with pytest.raises(ValueError, match=match):
            tu.temperature_update(*f, *COEFFS)
    assert tu.launches == 0


def test_views_the_kernel_takes():
    """Every strided view with a unit-stride z is taken; a contiguous
    float32 block takes 16-byte accesses (qDz, whose rows are n2 + 1 long,
    is not asked), an offset window or an odd z extent single cells."""
    f = _fields((12, 10, 16), torch.float32)
    assert all(tu.support_error(*v) is None for v in (f, *_views(f)))
    assert tu.vector_width(*f[:3]) == 4
    assert tu.vector_width(*_views(f)[0][:3]) == 1
    assert tu.vector_width(*_fields((12, 10, 15), torch.float32)[:3]) == 1
    assert tu.vector_width(*_fields((3, 12, 10, 16), torch.float64)[:3]) == 2
    assert tu.vector_width(*_fields((12, 10, 16), torch.bfloat16)[:3]) == 8
    assert tu.vector_width(*_fields((12, 10, 12), torch.float16)[:3]) == 1


def test_coefficients_round_as_torch_on_the_card():
    """``1 / (dx*dx)`` and ``1 / dx`` taken in double precision, then
    rounded to the type torch computes the dtype in (float32 for bfloat16
    and float16), as torch's CUDA division by a Python scalar multiplies by
    that reciprocal; lam, iphi and dt rounded to that type, as a Python
    scalar multiplier is (`ops.diffusion_update.coefficients` measured the
    reciprocal on an H100)."""
    lam, iphi, dt, dx, dy, dz = COEFFS
    want = (*(1 / (d * d) for d in (dx, dy, dz)), *(1 / d for d in (dx, dy, dz)), lam, iphi, dt)
    assert tu.coefficients(torch.float64, *COEFFS) == want
    f32 = tu.coefficients(torch.float32, *COEFFS)
    assert f32 == tuple(float(torch.tensor(v, dtype=torch.float32)) for v in want)
    assert f32[0] == 10.405827522277832 and f32 != want
    for half in HALF:
        assert tu.coefficients(half, *COEFFS) == f32


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run this file with "
                    "--noconftest -m cuda on one")
    return torch.device("cuda", 0)


def _launch_matches(fields):
    before = tu.launches
    got = tu.temperature_update(*fields, *COEFFS)
    torch.cuda.synchronize()
    assert tu.launches == before + 1
    want = tu.temperature_update_reference(*fields, *COEFFS)
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((37, 45, 70), torch.float32), ((37, 45, 72), torch.float32),
    ((37, 45, 70), torch.float64), ((37, 45, 72), torch.float64),
    ((9, 20, 37), torch.float32), ((5, 3, 300), torch.float32),
    ((261, 33, 257), torch.float32), ((3, 37, 45, 72), torch.float32),
    ((3, 37, 45, 70), torch.float64), ((2, 1, 3), torch.float32),
    ((37, 45, 72), torch.bfloat16), ((37, 45, 70), torch.bfloat16),
    ((3, 37, 45, 264), torch.bfloat16), ((37, 45, 72), torch.float16),
    ((9, 20, 37), torch.float16), ((3, 37, 45, 264), torch.float16),
])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype):
    """Odd extents (one >= 256), a batch of 3, a block with no interior."""
    fields = _fields(shape, dtype, cuda_device)
    got = _launch_matches(fields)
    if len(shape) == 4:
        for b in range(shape[0]):
            assert torch.equal(got[b], tu.temperature_update(*(a[b] for a in fields), *COEFFS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
def test_cuda_kernel_on_strided_views(cuda_device, dtype):
    fields = _fields((2, 40, 36, 64), dtype, cuda_device)
    for f in (*_views(fields), *_views([a[1] for a in fields])):
        assert any(not a.is_contiguous() for a in f)
        _launch_matches(f)


def _plain_update(params):
    coeffs = _model_coeffs(params)
    return lambda *f: tu.temperature_update_reference(*f, *coeffs)


@pytest.mark.cuda
@pytest.mark.parametrize("cadence,dtype", [
    ("fused_k=6 periodic y", torch.float32), ("fused_k=6 periodic y", torch.float64),
    *(("make_step non-periodic", dt) for dt in (torch.float32, torch.float64, *HALF)),
])
def test_cuda_cadence_matches_plain(cuda_device, monkeypatch, cadence, dtype):
    """The model's cadence with the kernel against the same cadence built on
    the plain update, bit for bit; one launch a step.  The fused cadence's
    PT kernel takes float32 and float64 only."""
    fused = cadence.startswith("fused")
    kw = (dict(periody=1, overlapx=14, overlapy=14, overlapz=14) if fused else {})
    state, params = tp.setup(40, 48, 70, npt=12, dtype=dtype, device=cuda_device, quiet=True,
                             **kw)
    nsteps = 3

    def run():
        step = (tp.make_multi_step(params, nsteps, fused_k=6, autotune=False) if fused
                else tp.make_step(params))
        s = state
        for _ in range(1 if fused else nsteps):
            s = step(*s)
        torch.cuda.synchronize()
        return s

    before = tu.launches
    got = run()
    assert tu.launches == before + nsteps
    monkeypatch.setattr(tp, "_temperature_update", _plain_update)
    want = run()
    assert tu.launches == before + nsteps
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], state[0])
