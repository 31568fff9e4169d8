#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`implicitglobalgrid_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (every check raises; the script exits non-zero on the first failure
and then prints no result line):

1. The card's name and power limit (``nvidia-smi``) and the ``nvcc`` build
   of every kernel source, one ``nvcc`` per source, all started together,
   with their times and ``-Xptxas -v`` reports.
2. Each kernel against its plain PyTorch version on the card, on seeded
   random inputs at 256^3: ``fused_diffusion_steps`` in float32 for
   k = 2, 4, 8 and float64 for k = 4; ``fused_leapfrog_steps`` and
   ``fused_pt_iterations`` (random read-only T) in float32 for k = 2, 4, 6
   and float64 for k = 4; and at the x-marching kernels' ragged edges:
   (37, 45, 70) in float32 for k = 2, 6 (staggered) or 4 (diffusion), 8 and
   float64 for k = 4, a block smaller than one window (12, 12, 12) at k = 6
   (staggered) or 4 (diffusion), an x extent shorter than the plane rings
   (5, 64, 96) at k = 4, and for the diffusion kernel an odd z window
   (9, 20, 37) at k = 4.  Tolerance: bit-exact (the
   kernels are built with ``--fmad=false`` and round like their plain
   versions); the frozen outer ring (diffusion) and frozen boundary faces
   (staggered kernels) are checked bit-exact separately, P/Pf must change on
   the array boundary, and T must come back unchanged.
3. Diffusion main path, 256^3 float32 local block, periodic in x, y and z
   with overlap 8: ``diffusion3d.setup`` ->
   ``make_multi_step(nsteps=16, fused_k=4)`` (kernel launches + width-4
   self-neighbour slab exchanges), held against the plain cadence
   ``make_multi_step(nsteps=16, exchange_every=4)`` on the card
   (rtol = atol = 1e-5, the JAX package's fused-vs-XLA tolerance: the
   kernel folds the constants differently).
4. Diffusion 512^3 float32, non-periodic: ``make_multi_step(nsteps=8,
   fused_k=4)``, finite, 2 launches, matched to the plain cadence; then
   ``gather`` of the final field to rank 0 (block layout).
5. Acoustic main path, the JAX package's benchmark config: 256^3 float32,
   periodic in z, overlap 12, ``acoustic3d.make_multi_step(24, fused_k=6)``
   (4 launches) against ``exchange_every=6`` (rtol = atol = 2e-5, the JAX
   package's kernel-vs-XLA tolerance); then 256^3 non-periodic, the kernel
   alone, against the per-step cadence.
6. Porous main path, the JAX package's benchmark config: 256^3 float32,
   npt=12, periodic in z, overlap 14, ``porous_convection3d.make_multi_step(2,
   fused_k=6)`` (2 launches per step) against ``exchange_every=6``
   (max |diff| / max(scale, 1) < 2e-5 per field); then the ragged npt=10
   (chunks [6, 4]), non-periodic, against the same plain cadence.

Before the timing lines of phases 3, 5 and 6, each x-marching kernel's
tile, shared memory per block and resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at 256^3 float32 and
the main path's k; phase 3 also times the width-4 exchange of T.
Every main path runs with every launch count set to 0 just before it and
read just after.  Then one JSON line with every kernel's launches, error and
times (kernel, plain version, bound from the card's published HBM rate and
float32 peak), and as the last line ``{"ok": true, "device": {...}}``.
Every time is taken with CUDA events after a warm-up and printed beside the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: Floating-point operations per cell and step (iteration) of each kernel's
#: update, counted from its source.  Diffusion: 3 axes x [2*v, -, +, *c] +
#: 2 adds + lap*minv + v+ (and one reciprocal per cell per launch).
#: Leapfrog: 3 faces x [-, *, -] + div [3 -, 3 *, 2 +] + [*, -].  PT:
#: x and y faces [-, *, -, *, +], z faces [-, *, +, *, *, +, -, *, +],
#: div as leapfrog.
FLOPS_PER_CELL_STEP = {"fused_diffusion_steps": 16, "fused_leapfrog_steps": 19,
                       "fused_pt_iterations": 29}
#: Each kernel's CUDA source and the TPU kernel it replaces.
KERNELS = {
    "fused_diffusion_steps": ("fused_diffusion", "implicitglobalgrid_tpu/ops/pallas_stencil.py:241"),
    "fused_leapfrog_steps": ("fused_leapfrog", "implicitglobalgrid_tpu/ops/pallas_leapfrog.py:230"),
    "fused_pt_iterations": ("fused_pt", "implicitglobalgrid_tpu/ops/pallas_pt.py:131"),
}
SOURCES = tuple(src for src, _ in KERNELS.values())


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ring_equal(torch, out, inp) -> bool:
    return all(
        torch.equal(out.select(d, i), inp.select(d, i))
        for d in range(3)
        for i in (0, out.shape[d] - 1)
    )


def boundary_moved(torch, out, inp) -> bool:
    return all(not torch.equal(out.select(d, 0), inp.select(d, 0)) for d in range(3))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the float32 peak, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def nbytes(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def main() -> None:
    if not (ROOT / "implicitglobalgrid_tpu_torch" / "__init__.py").is_file():
        fail(f"{ROOT} holds no implicitglobalgrid_tpu_torch package: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d, porous_convection3d
    from implicitglobalgrid_tpu_torch.ops import _kernels
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
    from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
    from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

    modules = {"fused_diffusion_steps": fs, "fused_leapfrog_steps": fl,
               "fused_pt_iterations": fp}

    def reset_counts():
        for m in modules.values():
            m.launches = 0

    def counts():
        return {name: m.launches for name, m in modules.items()}

    # -- Phase 1: the card, and the builds ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for f in [pool.submit(_kernels.build, s) for s in SOURCES]:
            f.result()
    for s in SOURCES:
        _kernels.load(s)
        print(f"phase 1: {s}.cu nvcc {_kernels.build_seconds.get(s, 0.0):.2f} s")
        print(_kernels.build_logs.get(s, "(library already built)").strip())
    print(f"phase 1: built+loaded {len(SOURCES)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- Phase 2: every kernel vs its plain version at 256^3 -------------------
    n = 256
    shape = (n, n, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = dict.fromkeys(modules, 0.0)

    def compare(name, fn, ref, ins, k, dtype, frozen, where="256^3"):
        """One launch against the plain version, bit for bit."""
        before = modules[name].launches
        out = fn(*ins, k)
        torch.cuda.synchronize()
        if modules[name].launches != before + 1:
            fail(f"{name}: launch counter did not advance")
        want = ref(*ins, k)
        out = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(out, want))
        checks = frozen(out)
        print(f"phase 2: {name} {str(dtype)[6:]} k={k} {where}: max|kernel-plain| = {err!r} "
              f"(tolerance 0: bit-exact), {checks}")
        if err != 0.0 or not all(checks.values()):
            fail(f"{name} disagrees with its plain version ({dtype}, k={k}): {err!r}, {checks}")
        max_err[name] = max(max_err[name], err)

    cx, cy, cz = 1 / 8.1, 0.5 / 8.1, 0.25 / 8.1
    f32, f64 = torch.float32, torch.float64
    for sh, dtype, k in (*((shape, dt, k) for dt, k in ((f32, 2), (f32, 4), (f32, 8), (f64, 4))),
                         ((37, 45, 70), f32, 2), ((37, 45, 70), f32, 4), ((37, 45, 70), f32, 8),
                         ((37, 45, 70), f64, 4), ((12, 12, 12), f32, 4), ((5, 64, 96), f32, 4),
                         ((9, 20, 37), f32, 4)):
        T = torch.randn(sh, generator=gen, device=dev, dtype=dtype)
        Cp = 1 + torch.rand(sh, generator=gen, device=dev, dtype=dtype)
        compare("fused_diffusion_steps",
                lambda T, Cp, k: fs.fused_diffusion_steps(T, Cp, k, cx, cy, cz),
                lambda T, Cp, k: fs.fused_diffusion_steps_reference(T, Cp, k, cx, cy, cz),
                (T, Cp), k, dtype, lambda out: {"ring bit-exact": ring_equal(torch, out[0], T)},
                "256^3" if sh == shape else str(sh))
        del T, Cp

    lf = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)  # cax, cay, caz, b, idx, idy, idz
    pt = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)  # th, idx, idy, idz, ralam, bp
    ragged = ((37, 45, 70), f32, 2), ((37, 45, 70), f32, 6), ((37, 45, 70), f32, 8), \
        ((37, 45, 70), f64, 4), ((12, 12, 12), f32, 6), ((5, 64, 96), f32, 4)
    for sh, dtype, k in (*((shape, dt, k) for dt, k in ((f32, 2), (f32, 4), (f32, 6), (f64, 4))),
                         *ragged):
        where = "256^3" if sh == shape else str(sh)
        cells = [torch.randn(sh, generator=gen, device=dev, dtype=dtype) for _ in range(2)]
        faces = [0.1 * torch.randn(s, generator=gen, device=dev, dtype=dtype)
                 for s in fl.face_shapes(sh)]

        def staggered_checks(out, first, *, T=None):
            checks = {
                "faces bit-exact": all(ring_equal(torch, o, a) for o, a in zip(out[1:], faces)),
                f"{first} moved on the boundary": boundary_moved(torch, out[0], cells[1]),
            }
            if T is not None:
                checks["T unchanged"] = torch.equal(cells[0], T)
            return checks

        compare("fused_leapfrog_steps",
                lambda *a: fl.fused_leapfrog_steps(*a[:-1], a[-1], *lf),
                lambda *a: fl.fused_leapfrog_steps_reference(*a[:-1], a[-1], *lf),
                (cells[1], *faces), k, dtype, lambda out: staggered_checks(out, "P"), where)
        T0 = cells[0].clone()
        compare("fused_pt_iterations",
                lambda *a: fp.fused_pt_iterations(*a[:-1], a[-1], *pt),
                lambda *a: fp.fused_pt_iterations_reference(*a[:-1], a[-1], *pt),
                (*cells, *faces), k, dtype, lambda out: staggered_checks(out, "Pf", T=T0), where)
        del cells, faces, T0

    records = {}

    def plan(name, mod, k, blocks, tile=None):
        """An x-marching kernel's launch plan at 256^3 float32 (``mod``: its
        wrapper module; ``blocks``: resident blocks per SM)."""
        tile = tile or mod.tile_for(shape, k, 4)
        print(f"{name}: tile (bx, by, bz) = {tile}, grid {mod.grid(shape, tile)}, "
              f"{mod.window_bytes(shape, k, tile, 4)} B shared memory per block, "
              f"{blocks} resident blocks per SM "
              f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs) {card}")

    def record(name, launches, ms, plain_ms, bound_ms, bound_by):
        """The kernel's line of the JSON record (no PyTorch call computes the
        same function, so no library time)."""
        src, tpu = KERNELS[name]
        records[name] = {
            "name": name, "route": "cuda", "source": f"implicitglobalgrid_tpu_torch/csrc/{src}.cu",
            "replaces": tpu, "launches": launches, "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }

    # -- Phase 3: diffusion main path, 256^3 periodic, overlap 8 --------------
    (T0, Cp), params = diffusion3d.setup(
        n, n, n, periodx=1, periody=1, periodz=1, overlapx=8, overlapy=8,
        overlapz=8, dtype=torch.float32, quiet=True,
    )
    nsteps, k = 16, 4
    fused = diffusion3d.make_multi_step(params, nsteps, fused_k=k)
    plain = diffusion3d.make_multi_step(params, nsteps, exchange_every=k)
    fused(T0, Cp)  # warm-up (allocator)
    torch.cuda.synchronize()
    reset_counts()
    T_f, _ = fused(T0, Cp)
    torch.cuda.synchronize()
    diffusion_counts = counts()
    if diffusion_counts["fused_diffusion_steps"] != nsteps // k:
        fail(f"diffusion main path launched {diffusion_counts}, expected {nsteps // k} diffusion")
    T_p, _ = plain(T0, Cp)
    torch.cuda.synchronize()
    if not torch.isfinite(T_f).all():
        fail("diffusion main path produced non-finite values")
    torch.testing.assert_close(T_f, T_p, rtol=1e-5, atol=1e-5)
    main_err = float((T_f - T_p).abs().max())
    print(f"phase 3: diffusion 256^3 f32 periodic, 16 steps fused_k=4: launches {diffusion_counts}; "
          f"max|fused-plain cadence| = {main_err!r} (rtol=atol=1e-5)")

    c3 = [params.dt * params.lam / (d * d) for d in (params.dx, params.dy, params.dz)]
    out = fs.fused_diffusion_steps(T0, Cp, k, *c3)
    ref = fs.fused_diffusion_steps_reference(T0, Cp, k, *c3)
    max_err["fused_diffusion_steps"] = max(max_err["fused_diffusion_steps"],
                                           float((out - ref).abs().max()))
    plan("phase 3: fused_diffusion_steps", fs, k, fs.resident_blocks(shape, k, 4),
         fs.launch_tile(shape, k, 4, dev))
    kernel_ms = cuda_ms(torch, lambda: fs.fused_diffusion_steps(T0, Cp, k, *c3), reps=20)
    plain_ms = cuda_ms(torch, lambda: fs.fused_diffusion_steps_reference(T0, Cp, k, *c3), reps=3)
    bound_ms, bound_by = bound(nbytes(T0, Cp, T0),
                               k * (n - 2) ** 3 * FLOPS_PER_CELL_STEP["fused_diffusion_steps"]
                               + n**3)
    step_ms = cuda_ms(torch, lambda: fused(T0, Cp), reps=5) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain(T0, Cp), reps=2, warmup=1) / nsteps
    teff = 2 * nbytes(T0) / (step_ms * 1e-3) / 1e9
    plain_teff = 2 * nbytes(T0) / (plain_step_ms * 1e-3) / 1e9
    buf = T0.clone()
    exchange_ms = cuda_ms(torch, lambda: igg.update_halo(buf, width=k), reps=10)
    del buf
    copy_src = torch.empty(256 * 2**20, dtype=torch.float32, device=dev)
    copy_dst = torch.empty_like(copy_src)
    copy_ms = cuda_ms(torch, lambda: copy_dst.copy_(copy_src), reps=10)
    copy_gbs = 2 * copy_src.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del copy_src, copy_dst
    print(f"phase 3: fused_diffusion_steps 256^3 f32 k=4: {kernel_ms!r} ms/launch, plain version "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
    print(f"phase 3: fused_k=4 {step_ms!r} ms/step, T_eff {teff!r} GB/s; plain cadence "
          f"{plain_step_ms!r} ms/step, T_eff {plain_teff!r} GB/s {card}")
    print(f"phase 3: width-4 exchange of T (periodic x, y, z): {exchange_ms!r} ms (one per 4 "
          f"steps) {card}")
    print(f"phase 3: device-to-device copy of 1 GiB: {copy_gbs!r} GB/s (read+write) {card}")
    record("fused_diffusion_steps", diffusion_counts["fused_diffusion_steps"], kernel_ms,
           plain_ms, bound_ms, bound_by)
    igg.finalize_global_grid()
    del T0, Cp, T_f, T_p, out, ref

    # -- Phase 4: diffusion 512^3 non-periodic, and gather ---------------------
    n4, nsteps4 = 512, 8
    (T0, Cp), params = diffusion3d.setup(n4, n4, n4, dtype=torch.float32, quiet=True)
    fused4 = diffusion3d.make_multi_step(params, nsteps4, fused_k=k)
    reset_counts()
    T_f, _ = fused4(T0, Cp)
    torch.cuda.synchronize()
    if counts()["fused_diffusion_steps"] != nsteps4 // k:
        fail(f"512^3 run launched {counts()}, expected {nsteps4 // k} diffusion")
    if not torch.isfinite(T_f).all():
        fail("512^3 run produced non-finite values")
    T_p, _ = diffusion3d.make_multi_step(params, nsteps4)(T0, Cp)
    torch.testing.assert_close(T_f, T_p, rtol=1e-5, atol=1e-5)
    err4 = float((T_f - T_p).abs().max())
    del T_p
    step4_ms = cuda_ms(torch, lambda: fused4(T0, Cp), reps=3, warmup=1) / nsteps4
    teff4 = 2 * n4**3 * 4 / (step4_ms * 1e-3) / 1e9
    print(f"phase 4: diffusion 512^3 f32 non-periodic, 8 steps fused_k=4: {nsteps4 // k} "
          f"launches, max|fused-plain| = {err4!r}; {step4_ms!r} ms/step, T_eff {teff4!r} GB/s "
          f"{card}")
    gg = igg.get_global_grid()
    G = igg.gather(T_f)
    want = tuple(d * s for d, s in zip(gg.dims, T_f.shape))
    if G is None or G.shape != want:
        fail(f"gather returned {None if G is None else G.shape}, expected {want}")
    if not (G == T_f.cpu().numpy()).all():
        fail("gathered field differs from the block")
    print(f"phase 4: gather -> {G.shape} {G.dtype}")
    igg.finalize_global_grid()
    del T0, Cp, T_f, G

    # -- Phase 5: acoustic main path, 256^3 periodic z, overlap 12 -------------
    ov = dict(overlapx=12, overlapy=12, overlapz=12)
    state, params = acoustic3d.setup(n, n, n, periodz=1, dtype=torch.float32, quiet=True, **ov)
    nsteps, k = 24, 6
    fused = acoustic3d.make_multi_step(params, nsteps, fused_k=k)
    plain = acoustic3d.make_multi_step(params, nsteps, exchange_every=k)
    fused(*state)  # warm-up (allocator)
    torch.cuda.synchronize()
    reset_counts()
    got = fused(*state)
    torch.cuda.synchronize()
    acoustic_counts = counts()
    if acoustic_counts["fused_leapfrog_steps"] != nsteps // k:
        fail(f"acoustic main path launched {acoustic_counts}, expected {nsteps // k} leapfrog")
    want = plain(*state)
    torch.cuda.synchronize()
    for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
        if not torch.isfinite(g).all():
            fail(f"acoustic main path produced non-finite {name}")
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=lambda m: f"{name}: {m}")
    ac_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"phase 5: acoustic 256^3 f32 periodic z overlap 12, 24 steps fused_k=6: launches "
          f"{acoustic_counts}; max|fused-plain cadence| = {ac_err!r} (rtol=atol=2e-5)")
    co = (*(params.dt / params.rho / d for d in (params.dx, params.dy, params.dz)),
          params.dt * params.K, *(1.0 / d for d in (params.dx, params.dy, params.dz)))
    out = fl.fused_leapfrog_steps(*state, k, *co)
    ref = fl.fused_leapfrog_steps_reference(*state, k, *co)
    max_err["fused_leapfrog_steps"] = max(
        max_err["fused_leapfrog_steps"], *(float((a - b).abs().max()) for a, b in zip(out, ref)))
    plan("phase 5: fused_leapfrog_steps", fl, k, fl.resident_blocks("fused_leapfrog", shape, k, 4))
    kernel_ms = cuda_ms(torch, lambda: fl.fused_leapfrog_steps(*state, k, *co), reps=20)
    plain_ms = cuda_ms(torch, lambda: fl.fused_leapfrog_steps_reference(*state, k, *co), reps=3)
    bound_ms, bound_by = bound(2 * nbytes(*state),
                               k * n**3 * FLOPS_PER_CELL_STEP["fused_leapfrog_steps"])
    step_ms = cuda_ms(torch, lambda: fused(*state), reps=3) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain(*state), reps=2, warmup=1) / nsteps
    teff = 2 * nbytes(*state) / (step_ms * 1e-3) / 1e9
    plain_teff = 2 * nbytes(*state) / (plain_step_ms * 1e-3) / 1e9
    bufs = [a.clone() for a in state]
    exchange_ms = cuda_ms(torch, lambda: igg.update_halo(*bufs, width=k), reps=10)
    del bufs
    print(f"phase 5: fused_leapfrog_steps 256^3 f32 k=6: {kernel_ms!r} ms/launch, plain version "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
    print(f"phase 5: width-6 exchange of the 4 fields (periodic z): {exchange_ms!r} ms {card}")
    print(f"phase 5: acoustic fused_k=6 {step_ms!r} ms/step, T_eff {teff!r} GB/s; plain cadence "
          f"exchange_every=6 {plain_step_ms!r} ms/step, T_eff {plain_teff!r} GB/s {card}")
    record("fused_leapfrog_steps", acoustic_counts["fused_leapfrog_steps"], kernel_ms, plain_ms,
           bound_ms, bound_by)
    igg.finalize_global_grid()
    del state, got, want, out, ref

    state, params = acoustic3d.setup(n, n, n, dtype=torch.float32, quiet=True)
    fused = acoustic3d.make_multi_step(params, nsteps, fused_k=k)
    reset_counts()
    got = fused(*state)
    torch.cuda.synchronize()
    if counts()["fused_leapfrog_steps"] != nsteps // k:
        fail(f"non-periodic acoustic run launched {counts()}, expected {nsteps // k} leapfrog")
    want = acoustic3d.make_multi_step(params, nsteps)(*state)
    for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=lambda m: f"{name}: {m}")
    alone_ms = cuda_ms(torch, lambda: fused(*state), reps=3) / nsteps
    print(f"phase 5: acoustic 256^3 f32 non-periodic (kernel alone), 24 steps fused_k=6: "
          f"{nsteps // k} launches, max|fused-per-step cadence| = "
          f"{max(float((g - w).abs().max()) for g, w in zip(got, want))!r}; {alone_ms!r} ms/step, "
          f"T_eff {2 * nbytes(*state) / (alone_ms * 1e-3) / 1e9!r} GB/s {card}")
    igg.finalize_global_grid()
    del state, got, want

    # -- Phase 6: porous main path, 256^3, npt=12 periodic z and npt=10 -------
    def porous_run(npt, grid_kwargs, label, main):
        state, params = porous_convection3d.setup(n, n, n, npt=npt, dtype=torch.float32,
                                                  quiet=True, **grid_kwargs)
        nsteps, w = 2, 6
        fused = porous_convection3d.make_multi_step(params, nsteps, fused_k=w)
        plain = porous_convection3d.make_multi_step(params, nsteps, exchange_every=w)
        fused(*state)  # warm-up (allocator)
        torch.cuda.synchronize()
        reset_counts()
        got = fused(*state)
        torch.cuda.synchronize()
        c = counts()
        chunks = porous_convection3d._pt_schedule(npt, w)[1]
        if c["fused_pt_iterations"] != 2 * nsteps:
            fail(f"porous {label} launched {c}, expected 2 PT launches per step")
        want = plain(*state)
        torch.cuda.synchronize()
        errs = {}
        for name, g, wv in zip(("T", "Pf", "qDx", "qDy", "qDz"), got, want):
            if not torch.isfinite(g).all():
                fail(f"porous {label} produced non-finite {name}")
            errs[name] = float((g - wv).abs().max()) / max(float(wv.abs().max()), 1.0)
            if not errs[name] < 2e-5:
                fail(f"porous {label}: {name} max|fused-plain|/max(scale,1) = {errs[name]!r}")
        step_ms = cuda_ms(torch, lambda: fused(*state), reps=3, warmup=1) / nsteps
        plain_step_ms = cuda_ms(torch, lambda: plain(*state), reps=2, warmup=1) / nsteps
        teff = 2 * nbytes(*state) / (step_ms * 1e-3) / 1e9
        pt_gbs = 2 * nbytes(*state[1:]) / (step_ms / npt * 1e-3) / 1e9
        print(f"phase 6: porous {label}, 2 steps fused_k=6 (chunks {chunks}): launches {c}; "
              f"max|fused-plain cadence|/max(scale,1) = {max(errs.values())!r} (< 2e-5)")
        print(f"phase 6: porous {label}: {step_ms!r} ms/step, {step_ms / npt!r} ms/PT iteration, "
              f"T_eff {teff!r} GB/s, PT-loop {pt_gbs!r} GB/s (4 PT fields in+out per iteration); "
              f"plain cadence exchange_every=6 {plain_step_ms!r} ms/step {card}")
        if main:
            T, *s = state
            p = params
            co = (p.theta_q, 1.0 / p.dx, 1.0 / p.dy, 1.0 / p.dz, p.Ra * p.lam_T, p.beta_p)
            out = fp.fused_pt_iterations(T, *s, w, *co)
            ref = fp.fused_pt_iterations_reference(T, *s, w, *co)
            max_err["fused_pt_iterations"] = max(
                max_err["fused_pt_iterations"],
                *(float((a - b).abs().max()) for a, b in zip(out, ref)))
            plan("phase 6: fused_pt_iterations", fl, w, fl.resident_blocks("fused_pt", shape, w, 4))
            kernel_ms = cuda_ms(torch, lambda: fp.fused_pt_iterations(T, *s, w, *co), reps=20)
            plain_ms = cuda_ms(torch, lambda: fp.fused_pt_iterations_reference(T, *s, w, *co),
                               reps=3)
            bound_ms, bound_by = bound(nbytes(*state) + nbytes(*s),
                                       w * n**3 * FLOPS_PER_CELL_STEP["fused_pt_iterations"])
            print(f"phase 6: fused_pt_iterations 256^3 f32 k=6: {kernel_ms!r} ms/launch, plain "
                  f"version {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
            t_update = porous_convection3d._temperature_update(params)
            t_ms = cuda_ms(torch, lambda: t_update(T, *s[1:]), reps=5)
            bufs = [a.clone() for a in s]
            exchange_ms = cuda_ms(torch, lambda: igg.update_halo(*bufs, width=w), reps=10)
            t_exchange_ms = cuda_ms(torch, lambda: igg.update_halo(bufs[0]), reps=10)
            del bufs
            print(f"phase 6: per step: T update (plain torch) {t_ms!r} ms; width-6 exchange of "
                  f"the 4 PT fields {exchange_ms!r} ms (2 per step); width-1 exchange of one "
                  f"cell field (T's) {t_exchange_ms!r} ms {card}")
            record("fused_pt_iterations", c["fused_pt_iterations"], kernel_ms, plain_ms,
                   bound_ms, bound_by)
        igg.finalize_global_grid()

    porous_run(12, dict(periodz=1, overlapx=14, overlapy=14, overlapz=14),
               "256^3 f32 npt=12 periodic z overlap 14", main=True)
    porous_run(10, {}, "256^3 f32 npt=10 non-periodic", main=False)

    print(json.dumps({"kernels": [records[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
