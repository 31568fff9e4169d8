#!/usr/bin/env python3
"""Where the time of the three x-marching kernels goes, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_kernel_split.py [DIR ...]

Builds, next to the committed ``fused_leapfrog.cu``, ``fused_pt.cu`` and
``fused_diffusion.cu``, copies of them whose ``staggered.cuh`` and
``fused_diffusion.cu`` are edited as text:

* ``no-loads``: the ``cp.async`` plane loads are never issued (the rings
  keep whatever shared memory held), so the time is the stepping's;
* ``no-stepping``: the updates store nothing, so the compiler drops their
  arithmetic and shared-memory reads; what is left is loads, barriers, the
  diffusion kernel's pass-through of its register queues and level planes,
  and the stores of the owned tile;

and one more copy for each ``DIR`` given (a folder holding another
``staggered.cuh``, ``fused_leapfrog.cu``, ``fused_pt.cu`` or
``fused_diffusion.cu``; a file it lacks is the committed one).  Every
variant is timed at 256^3 float32 in turns (each list of variants forward,
then backward) with CUDA events: the staggered kernels at k = 6 and 4, the
diffusion kernel at k = 4 with the committed wrapper's launch tile.  The
committed kernels and each ``DIR`` are first checked against the plain
versions (bit-exact).  The variants without loads or stepping compute
garbage by design.  Prints the card's name and power limit first; exits
non-zero without a card, on a mismatch, or when an edit no longer finds
its text in the source.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("fused_leapfrog", "fused_pt", "fused_diffusion")
FILES = ("staggered.cuh", *(f"{s}.cu" for s in SOURCES))
LF = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)  # cax, cay, caz, b, idx, idy, idz
PT = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)  # th, idx, idy, idz, ralam, bp
DIFF = (1 / 8.1, 0.5 / 8.1, 0.25 / 8.1)  # cx, cy, cz

NO_LOADS = [("__pipeline_memcpy_async(", "if (0) __pipeline_memcpy_async(")]
#: The text edits of each variant, per source file.
EDITS = {
    "no-loads": {"staggered.cuh": NO_LOADS, "fused_diffusion.cu": NO_LOADS},
    "no-stepping": {
        "staggered.cuh": [(f"{a} = {v};", f"if (s < 0) {a} = {v};")
                          for a, v in (("Vx[c]", "nx"), ("Vy[c]", "ny"), ("Vz[c]", "nz"),
                                       ("P[c]", "p"))],
        "fused_diffusion.cu": [("if (x_on && s <=", "if (s < 0 && x_on && s <=")],
    },
}


def fail(msg: str) -> None:
    print(f"chip_kernel_split: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def edited(text: str, file: str, what: str) -> str:
    """``file``'s text with the edits of variant ``what``."""
    for old, new in EDITS[what].get(file, ()):
        if old not in text:
            fail(f"{what}: '{old}' is not in {file} any more; update this script")
        text = text.replace(old, new)
    return text


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from implicitglobalgrid_tpu_torch.ops import _kernels
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
    from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
    from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    csrc = _kernels.CSRC
    committed = {f: (csrc / f).read_text() for f in FILES}
    variants = {"committed": committed}
    for what in EDITS:
        variants[what] = {f: edited(text, f, what) for f, text in committed.items()}
    for d in map(Path, sys.argv[1:]):
        variants[d.name] = {f: (d / f).read_text() if (d / f).exists() else text
                            for f, text in committed.items()}

    build = Path(tempfile.mkdtemp(prefix="igg_split_"))
    try:
        procs = {}
        for name, files in variants.items():
            out = build / name
            out.mkdir()
            for f, text in files.items():
                (out / f).write_text(text)
            for s in SOURCES:
                procs[name, s] = subprocess.Popen(
                    [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(out / f"{s}.so"),
                     str(out / f"{s}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        for (name, s), p in procs.items():
            log = p.communicate()[0]
            if p.returncode != 0:
                fail(f"nvcc failed for {name}/{s}.cu:\n{log}")
            regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
            print(f"{name}/{s}.cu: {'; '.join(regs)}")
        run(torch, fl, fp, fs, build, list(variants))
    finally:
        shutil.rmtree(build, ignore_errors=True)


def run(torch, fl, fp, fs, build: Path, names: list[str]) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (256, 256, 256)
    fsig = [ctypes.c_int] * 5  # members, n0, n1, n2, k
    checked = [n for n in names if n not in ("no-loads", "no-stepping")]

    def ms(fn, reps=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for k in (6, 4):
        P, *V = (torch.randn(s, generator=gen, device=dev) for s in (shape, *fl.face_shapes(shape)))
        T = torch.randn(shape, generator=gen, device=dev)
        outs = [torch.empty_like(a) for a in (P, *V)]
        want = {"fused_leapfrog": fl.fused_leapfrog_steps_reference(P, *V, k, *LF),
                "fused_pt": fp.fused_pt_iterations_reference(T, P, *V, k, *PT)}
        tile = fl.tile_for(shape, k, 4)
        stream = torch.cuda.current_stream().cuda_stream
        for name in names + names[::-1]:
            times = []
            for s, co, ins in (("fused_leapfrog", LF, (P, *V)), ("fused_pt", PT, (T, P, *V))):
                fn = getattr(ctypes.CDLL(str(build / name / f"{s}.so")), f"igg_{s}_f32")
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * (len(ins) + 4) + fsig
                               + [ctypes.c_float] * len(co) + [ctypes.c_int] * 4 + [ctypes.c_void_p])

                def launch(fn=fn, co=co, ins=ins):
                    code = fn(*(a.data_ptr() for a in (*ins, *outs)), 1, *shape, k, *co, *tile, 0,
                              stream)
                    if code != 0:
                        fail(f"{name}/{s}: CUDA error {code}")

                launch()
                torch.cuda.synchronize()
                if name in checked and not all(torch.equal(a, b) for a, b in zip(outs, want[s])):
                    fail(f"{name}/{s} k={k} disagrees with the plain version")
                times.append(ms(launch))
            print(f"256^3 f32 k={k} tile {tile} {name}: fused_leapfrog_steps {times[0]!r} ms, "
                  f"fused_pt_iterations {times[1]!r} ms")

    k = 4
    T = torch.randn(shape, generator=gen, device=dev)
    Cp = 1 + torch.rand(shape, generator=gen, device=dev)
    out = torch.empty_like(T)
    want = fs.fused_diffusion_steps_reference(T, Cp, k, *DIFF)
    tile = fs.launch_tile(shape, k, 4, dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name in names + names[::-1]:
        fn = getattr(ctypes.CDLL(str(build / name / "fused_diffusion.so")), "igg_fused_diffusion_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + fsig + [ctypes.c_float] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])

        def launch(fn=fn):
            code = fn(T.data_ptr(), Cp.data_ptr(), out.data_ptr(), 1, *shape, k, *DIFF, *tile, 0,
                      stream)
            if code != 0:
                fail(f"{name}/fused_diffusion: CUDA error {code}")

        launch()
        torch.cuda.synchronize()
        if name in checked and not torch.equal(out, want):
            fail(f"{name}/fused_diffusion k={k} disagrees with the plain version")
        print(f"256^3 f32 k={k} tile {tile} {name}: fused_diffusion_steps {ms(launch)!r} ms")


if __name__ == "__main__":
    main()
