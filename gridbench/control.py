"""The readings that a cell's limits are set from, in one process on one GPU:

    python3 -m gridbench.control --workload <cell> --seeds 1,2,... --control-seeds 3 --seconds 2

Each seed runs the cell at its own size (its grid, its call, its start and
sampled checks, a short window) for the program's readings.  The control is
the plain reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place on the same inputs; the
first ``--control-seeds`` seeds read it.  A sound limit lies above every
program reading and below every control reading.  One JSON line per seed,
then one with the largest program and the smallest control reading of each
check.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import run, spec
from .window import Window


def lower_precision(ref, dtype=torch.bfloat16):
    """The reference's call computed in ``dtype``, returned as float32."""

    def advance(cfg, state, p, call, wrap):
        low = {k: v.to(dtype) for k, v in state.items()}
        return {k: v.float() for k, v in ref.advance(cfg, low, p, call, wrap).items()}

    return advance


def readings(cfg, traf, seed: int, seconds: float, control: bool, device) -> dict:
    w = Window(cfg, traf, seed, device)
    w.run(spec.window_calls(cfg, traf, seconds))
    out = {"seed": seed, "program": w.checks()}
    if control:
        out["control"] = w.checks(advance=lower_precision(w.ref))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gridbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    _, cell, cfg, traf = run.cell_spec(Path.cwd(), args.workload)
    if not torch.cuda.is_available():
        run.fail("torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    lows, highs = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = readings(cfg, traf, seed, args.seconds, i < args.control_seeds, device)
        for k, v in rec["program"].items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in rec.get("control", {}).items():
            highs[k] = min(highs.get(k, float("inf")), v)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"workload": cell["name"], "device": torch.cuda.get_device_name(0),
                      "program_max": lows, "control_min": highs,
                      "banned": run.banned_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
