#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`implicitglobalgrid_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (every check raises; the script exits non-zero on the first failure
and then prints no result line):

1. The card's name and power limit (``nvidia-smi``) and the ``nvcc`` build
   of every kernel source of the main path, with its time and the
   ``-Xptxas -v`` report.
2. Each kernel against its plain PyTorch version on the card, on seeded
   random inputs at 256^3: ``fused_diffusion_steps`` in float32 for
   k = 2, 4, 8 and float64 for k = 4.  Tolerance: bit-exact (the kernel is
   built with ``--fmad=false`` and rounds like the plain version); the
   frozen outer ring is checked bit-exact separately.
3. The main path, one process, 256^3 float32 local block, periodic in x, y
   and z with overlap 8: ``diffusion3d.setup`` ->
   ``make_multi_step(nsteps=16, fused_k=4)`` (kernel launches + width-4
   self-neighbour slab exchanges), held against the plain cadence
   ``make_multi_step(nsteps=16, exchange_every=4)`` on the card
   (rtol = atol = 1e-5, the JAX package's fused-vs-XLA tolerance: the
   kernel folds the constants differently).  Launch counts are reset just
   before and read just after the fused run.
4. 512^3 float32, non-periodic: ``make_multi_step(nsteps=8, fused_k=4)``,
   finite, 2 launches, matched to the plain cadence.
5. ``gather`` of the final field to rank 0 (block layout).

Then one JSON line with every kernel's launches, error and times (kernel,
plain version, bound from the card's published HBM rate and float32 peak),
and as the last line ``{"ok": true, "device": {...}}``.  Every time is taken
with CUDA events after a warm-up and printed beside the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: Floating-point operations per cell and step of the diffusion update
#: (3 axes x [2*v, -, +, *c] + 2 adds + lap*minv + v+), and one reciprocal
#: per cell per launch.
FLOPS_PER_CELL_STEP = 16


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


def main() -> None:
    if not (ROOT / "implicitglobalgrid_tpu_torch" / "__init__.py").is_file():
        fail(f"{ROOT} holds no implicitglobalgrid_tpu_torch package: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.ops import _kernels
    from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

    # -- Phase 1: the card, and the build -----------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.load("fused_diffusion")
    print(f"phase 1: built+loaded fused_diffusion.cu in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_kernels.build_seconds.get('fused_diffusion', 0.0):.2f} s)")
    print(_kernels.build_logs.get("fused_diffusion", "(library already built)").strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- Phase 2: kernel vs plain version at 256^3 ----------------------------
    n = 256
    shape = (n, n, n)
    cx, cy, cz = 1 / 8.1, 0.5 / 8.1, 0.25 / 8.1
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for dtype, k in ((torch.float32, 2), (torch.float32, 4), (torch.float32, 8), (torch.float64, 4)):
        T = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        Cp = 1 + torch.rand(shape, generator=gen, device=dev, dtype=dtype)
        before = fs.launches
        out = fs.fused_diffusion_steps(T, Cp, k, cx, cy, cz)
        torch.cuda.synchronize()
        if fs.launches != before + 1:
            fail(f"launch counter did not advance ({before} -> {fs.launches})")
        ref = fs.fused_diffusion_steps_reference(T, Cp, k, cx, cy, cz)
        err = float((out - ref).abs().max())
        ring = ring_equal(torch, out, T)
        print(f"phase 2: {str(dtype)[6:]} k={k} 256^3: max|kernel-plain| = {err!r} "
              f"(tolerance 0: bit-exact), ring bit-exact: {ring}")
        if err != 0.0 or not ring:
            fail(f"kernel disagrees with its plain version ({dtype}, k={k}): {err!r}, ring {ring}")
        max_err = max(max_err, err)
        del T, Cp, out, ref

    # -- Phase 3: the main path, 256^3 periodic, overlap 8 -------------------
    (T0, Cp), params = diffusion3d.setup(
        n, n, n, periodx=1, periody=1, periodz=1, overlapx=8, overlapy=8,
        overlapz=8, dtype=torch.float32, quiet=True,
    )
    nsteps, k = 16, 4
    fused = diffusion3d.make_multi_step(params, nsteps, fused_k=k)
    plain = diffusion3d.make_multi_step(params, nsteps, exchange_every=k)
    fused(T0, Cp)  # warm-up (allocator)
    torch.cuda.synchronize()
    fs.launches = 0
    T_f, _ = fused(T0, Cp)
    torch.cuda.synchronize()
    main_launches = fs.launches
    if main_launches != nsteps // k:
        fail(f"main path launched the kernel {main_launches} times, expected {nsteps // k}")
    T_p, _ = plain(T0, Cp)
    torch.cuda.synchronize()
    if not torch.isfinite(T_f).all():
        fail("main path produced non-finite values")
    torch.testing.assert_close(T_f, T_p, rtol=1e-5, atol=1e-5)
    main_err = float((T_f - T_p).abs().max())
    print(f"phase 3: main path 256^3 f32 periodic, 16 steps fused_k=4: {main_launches} kernel "
          f"launches; max|fused-plain cadence| = {main_err!r} (rtol=atol=1e-5)")

    c3 = [params.dt * params.lam / (d * d) for d in (params.dx, params.dy, params.dz)]
    out = fs.fused_diffusion_steps(T0, Cp, k, *c3)
    ref = fs.fused_diffusion_steps_reference(T0, Cp, k, *c3)
    max_err = max(max_err, float((out - ref).abs().max()))
    kernel_ms = cuda_ms(torch, lambda: fs.fused_diffusion_steps(T0, Cp, k, *c3), reps=20)
    plain_ms = cuda_ms(torch, lambda: fs.fused_diffusion_steps_reference(T0, Cp, k, *c3), reps=3)
    cells = n**3
    bytes_bound_ms = 3 * cells * 4 / HBM_BYTES_PER_S * 1e3
    ops_bound_ms = (k * (n - 2) ** 3 * FLOPS_PER_CELL_STEP + cells) / FP32_FLOPS * 1e3
    bound_ms = max(bytes_bound_ms, ops_bound_ms)
    bound_by = "bytes" if bytes_bound_ms >= ops_bound_ms else "operations"
    step_ms = cuda_ms(torch, lambda: fused(T0, Cp), reps=5) / nsteps
    plain_step_ms = cuda_ms(torch, lambda: plain(T0, Cp), reps=2, warmup=1) / nsteps
    teff = 2 * cells * 4 / (step_ms * 1e-3) / 1e9
    plain_teff = 2 * cells * 4 / (plain_step_ms * 1e-3) / 1e9
    copy_src = torch.empty(256 * 2**20, dtype=torch.float32, device=dev)
    copy_dst = torch.empty_like(copy_src)
    copy_ms = cuda_ms(torch, lambda: copy_dst.copy_(copy_src), reps=10)
    copy_gbs = 2 * copy_src.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del copy_src, copy_dst
    print(f"phase 3: kernel 256^3 f32 k=4: {kernel_ms!r} ms/launch, plain version "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {card}")
    print(f"phase 3: fused_k=4 {step_ms!r} ms/step, T_eff {teff!r} GB/s; plain cadence "
          f"{plain_step_ms!r} ms/step, T_eff {plain_teff!r} GB/s {card}")
    print(f"phase 3: device-to-device copy of 1 GiB: {copy_gbs!r} GB/s (read+write) {card}")
    igg.finalize_global_grid()
    del T0, Cp, T_f, T_p, out, ref

    # -- Phase 4: 512^3 non-periodic ------------------------------------------
    n4, nsteps4 = 512, 8
    (T0, Cp), params = diffusion3d.setup(n4, n4, n4, dtype=torch.float32, quiet=True)
    fused4 = diffusion3d.make_multi_step(params, nsteps4, fused_k=k)
    fs.launches = 0
    T_f, _ = fused4(T0, Cp)
    torch.cuda.synchronize()
    if fs.launches != nsteps4 // k:
        fail(f"512^3 run launched {fs.launches} kernels, expected {nsteps4 // k}")
    if not torch.isfinite(T_f).all():
        fail("512^3 run produced non-finite values")
    T_p, _ = diffusion3d.make_multi_step(params, nsteps4)(T0, Cp)
    torch.testing.assert_close(T_f, T_p, rtol=1e-5, atol=1e-5)
    err4 = float((T_f - T_p).abs().max())
    del T_p
    step4_ms = cuda_ms(torch, lambda: fused4(T0, Cp), reps=3, warmup=1) / nsteps4
    teff4 = 2 * n4**3 * 4 / (step4_ms * 1e-3) / 1e9
    print(f"phase 4: 512^3 f32 non-periodic, 8 steps fused_k=4: {nsteps4 // k} launches, "
          f"max|fused-plain| = {err4!r}; {step4_ms!r} ms/step, T_eff {teff4!r} GB/s {card}")

    # -- Phase 5: gather ------------------------------------------------------
    gg = igg.get_global_grid()
    G = igg.gather(T_f)
    want = tuple(d * s for d, s in zip(gg.dims, T_f.shape))
    if G is None or G.shape != want:
        fail(f"gather returned {None if G is None else G.shape}, expected {want}")
    if not (G == T_f.cpu().numpy()).all():
        fail("gathered field differs from the block")
    print(f"phase 5: gather -> {G.shape} {G.dtype}")
    igg.finalize_global_grid()

    kernels = [{
        "name": "fused_diffusion_steps",
        "route": "cuda",
        "source": "implicitglobalgrid_tpu_torch/csrc/fused_diffusion.cu",
        "replaces": "implicitglobalgrid_tpu/ops/pallas_stencil.py:241",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
