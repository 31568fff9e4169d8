#!/usr/bin/env python3
"""The three models' ``run()`` on one CUDA card, telemetry off and on, from
two checkouts in turns.

    python3 chip_run_turns.py PARENT_DIR CHANGE_DIR [--rounds 2]

Runs ``--one`` in a fresh process per turn, alternating the checkouts
(A, B, B, A per round), and prints each turn's JSON line and a summary:
per model and checkout, min, median and max milliseconds of one ``run()``
(CUDA events around the call; 256^3 float32 at the main-path configs,
``chip_smoke.MAIN_RUNS`` of this script's own directory, the same for both
checkouts), five off/on pairs per turn, and the range of the per-process
medians beside the spread within one process.
For a checkout that has ``utils.profiling.scope`` (the ``record_function``
ranges, null while no capture is live) it also counts the ``scope()``
calls of one ``run()`` and times one idle ``scope()`` on the host.  The
card's name and power limit head the output.

    python3 chip_run_turns.py --one DIR

times one checkout in this process.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import MAIN_RUNS  # noqa: E402


def one(root: str, pairs: int = 5) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_run_turns: no CUDA card")
    from implicitglobalgrid_tpu_torch.ops import _kernels

    for src in ("fused_diffusion", "fused_leapfrog", "fused_pt"):
        _kernels.build(src)
        _kernels.load(src)
    n, f32 = 256, torch.float32

    def ms(fn, reps=2):
        fn()  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": os.path.abspath(root)}
    for name, r in MAIN_RUNS.items():
        model = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{name}")
        kw, nt = r["kw"], r["nt"]

        def call():
            return model.run(nt, n, n, n, dtype=f32, quiet=True, **kw)

        off, on = [], []
        for _ in range(pairs):
            os.environ["IGG_TELEMETRY"] = "0"
            off.append(ms(call))
            del os.environ["IGG_TELEMETRY"]
            on.append(ms(call))
        out[name] = {"off": off, "on": on}
    try:
        from implicitglobalgrid_tpu_torch.utils import profiling
    except ImportError:  # a checkout from before the device timeline
        return out
    real, calls = profiling.scope, []

    def counting(label):
        calls.append(label)
        return real(label)

    profiling.scope = counting  # the call sites look it up on the module
    try:
        for name, r in MAIN_RUNS.items():
            model = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{name}")
            calls.clear()
            model.run(r["nt"], n, n, n, dtype=f32, quiet=True, **r["kw"])
            out[name]["scope_calls"] = len(calls)
    finally:
        profiling.scope = real
    reps = 200_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with profiling.scope(f"igg_step[{name}]"):
            pass
    out["scope_us"] = (time.perf_counter() - t0) / reps * 1e6
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 2
    a, b = argv[0], argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    rows = []
    for root in [a, b, b, a] * rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    for model in MAIN_RUNS:
        for root in (a, b):
            for mode in ("off", "on"):
                v = [x for r in rows if r["tree"] == os.path.abspath(root) for x in r[model][mode]]
                per = [statistics.median(r[model][mode]) for r in rows
                       if r["tree"] == os.path.abspath(root)]
                print(f"{model} {root} telemetry {mode}: {len(v)} runs, min {min(v)!r} ms, "
                      f"median {statistics.median(v)!r} ms, max {max(v)!r} ms; per-process "
                      f"medians {min(per)!r}-{max(per)!r} ms")
    for root in (a, b):
        mine = [r for r in rows if r["tree"] == os.path.abspath(root) and "scope_us" in r]
        if mine:
            us = [r["scope_us"] for r in mine]
            print(f"{root}: idle scope() {min(us)!r}-{max(us)!r} us a call; calls per run() "
                  f"{ {m: mine[0][m]['scope_calls'] for m in MAIN_RUNS} }")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
