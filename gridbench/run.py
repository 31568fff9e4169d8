"""gridbench: the benchmark of implicitglobalgrid_tpu_torch.

Runs one cell once on one GPU and prints one JSON line:

    python3 -m gridbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiler trace of the
window.  ``correct`` holds the checks against the plain reference; each
number compared is printed beside its limit, last on standard error and
under the result's last key, ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import spec  # noqa: E402

#: top-level module names that the process may not hold once the window
#: has closed
BANNED = ("jax", "jaxlib", "flax", "implicitglobalgrid_tpu")
GIB = float(1 << 30)


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def fail(msg: str, code: int = 2):
    print(f"gridbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m gridbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_spec(root: Path, name: str):
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, name)
    return bench, cell, spec.config(cell["config"]), spec.traffic(cell["traffic"])


# -- the run ------------------------------------------------------------------


def run_window(cfg, traf, args, device, wrap_call=None) -> dict:
    """The cell's set-up and window, then the checks."""
    import torch

    from .window import Window

    torch.set_num_threads(2)
    w = Window(cfg, traf, args.seed, device, trace_on=bool(args.trace), wrap_call=wrap_call)
    out = w.run(spec.window_calls(cfg, traf, args.seconds, trace=bool(args.trace)))
    out["checks"] = w.checks()
    return out


# -- the result line ----------------------------------------------------------


def setup_seconds(out: dict) -> float:
    """Start of this process to the window: imports, grid bring-up, inputs,
    warm-up."""
    return out["start_s"] - T_START + out["setup_s"]


def p95(values):
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def end_to_end(out: dict, setup_s: float) -> dict:
    """Every end-to-end quantity the benchmark knows; the caller keeps the
    ones the cell reports."""
    return {"setup_s": setup_s, "peak_mem_gib": out["peak_warm"] / GIB,
            "step_ms": out["total_ms"] / out["steps"], "chunk_ms_p95": p95(out["times_ms"])}


def per_layer(bench, cell, cfg, traf, out: dict) -> dict:
    metrics = {}
    ctx = {"cell": cell, "config": cfg, "traffic": traf, "window": out}
    for m in bench["per_layer"]:
        if not spec.applies(m, cell["name"]):
            continue
        value = spec.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def result(bench, cell, cfg, traf, args, out: dict, setup_s: float, device: dict):
    from . import trace

    checks = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in out["checks"].items()}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    line = {"correct": failed == 0, "attempted": out["calls"], "failed": failed}
    if args.trace:
        line["metrics"] = per_layer(bench, cell, cfg, traf, out)
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["device"] = device
        line["breakdown"] = trace.breakdown(out["trace"])
    else:
        e2e = end_to_end(out, setup_s)
        line["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"] if spec.applies(m, cell["name"])
        }
        line["device"] = device
    line["checks"] = checks
    return line


def device_block(out: dict) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": max(out["peak_warm"], out["peak_window"])}


def report(line: dict) -> None:
    """Print the checks and the line, unless the process holds a module
    that no run may load: the result has been built, every metric read."""
    found = banned_modules()
    if found:
        fail(f"modules that no run may load were loaded: {', '.join(found)}", 1)
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    bench, cell, cfg, traf = cell_spec(Path.cwd(), args.workload)
    chips = int(cell["chips"])
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this benchmark needs a CUDA card")
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} GPUs; {torch.cuda.device_count()} are visible")
    if chips != 1:
        fail(f"the cell asks for {chips} GPUs; this harness runs cells on one GPU")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_window(cfg, traf, args, device)
    line = result(bench, cell, cfg, traf, args, out, setup_seconds(out), device_block(out))
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
