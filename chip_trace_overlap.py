#!/usr/bin/env python3
"""Where the time of the overlap schedules goes, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_trace_overlap.py [OUT_DIR]

At 256^3 float32, periodic in x, y and z, one rank, it runs

* one diffusion group (``fused_k=4``, overlap 8) and one acoustic group
  (``fused_k=6``, overlap 12), each on the pipelined schedule
  (``pipelined=True``) and on the serialized one (``pipelined=False``);
* one diffusion step with ``hide_comm=True`` and one without;

checks that each pair agrees bit for bit, and prints for each schedule:

* ``host``: the host's enqueue time per call (wall clock, the card idle at
  the start of each call);
* ``device``: the card's time per call (CUDA events, calls back to back);
* from a torch.profiler trace of three calls (the card synchronized between
  them), per call: the device operations and the host's CUDA runtime calls,
  the device's busy time (the union of its operations on all streams) over
  its span (first start to last end), the idle share of that span, the lag
  of the device's last end behind the host's return, and per stream its
  operations, busy time and the time it overlapped each other stream.

The per-stream timelines of the middle traced call and the Chrome traces go
to ``OUT_DIR`` (default ``overlap_traces``).  Prints the card's name and power
limit first; exits non-zero without a card or when a pair differs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
N = 256
CALLS = 3


def fail(msg: str) -> None:
    print(f"chip_trace_overlap: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def host_ms(torch, fn, reps: int = 10) -> float:
    """Mean wall milliseconds for the host to return from ``fn``, the card
    idle at the start of each call."""
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        total += time.perf_counter() - t
    torch.cuda.synchronize()
    return total / reps * 1e3


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` on the card, back to back."""
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


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def overlap_us(a, b) -> float:
    """Time during which some interval of ``a`` and some of ``b`` both run."""
    return union_us(a) + union_us(b) - union_us(a + b)


def short(name: str) -> str:
    name = name.removeprefix("void ")
    return name.split("<")[0].split("(")[0][-48:]


def trace(torch, fn, label: str, out: Path):
    """Trace ``CALLS`` calls of ``fn``; returns per-call summaries and the
    middle call's per-stream timeline (text)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(CALLS):
            with record_function(f"call{i}"):
                fn()
            torch.cuda.synchronize()
    path = out / f"trace_{label}.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    calls = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("call")), key=lambda e: e["ts"])
    if len(calls) != CALLS:
        fail(f"{label}: {len(calls)} call annotations in the trace, expected {CALLS}")
    summaries, timeline = [], ""
    for i, c in enumerate(calls):
        lo = c["ts"]
        hi = calls[i + 1]["ts"] if i + 1 < CALLS else float("inf")
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and lo <= e["ts"] < hi]
        host_end = c["ts"] + c["dur"]
        rt = [e for e in events
              if e.get("cat", "").startswith("cuda_") and lo <= e["ts"] < host_end]
        s = {"device_ops": len(dev), "runtime_calls": len(rt)}
        if dev:
            iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
            start, end = min(a for a, _ in iv), max(b for _, b in iv)
            busy = union_us(iv)
            s.update(busy_ms=busy / 1e3, span_ms=(end - start) / 1e3,
                     idle_share=1 - busy / (end - start), host_ms=c["dur"] / 1e3,
                     first_op_after_host_start_ms=(start - lo) / 1e3,
                     device_end_after_host_return_ms=(end - host_end) / 1e3)
            streams: dict = {}
            for e in dev:
                streams.setdefault(e.get("args", {}).get("stream", "?"), []).append(e)
            s["streams"] = {}
            for sid, evs in streams.items():
                siv = [(e["ts"], e["ts"] + e["dur"]) for e in evs]
                s["streams"][str(sid)] = {
                    "ops": len(evs), "busy_ms": union_us(siv) / 1e3,
                    "first_ms": (min(a for a, _ in siv) - start) / 1e3,
                    "last_end_ms": (max(b for _, b in siv) - start) / 1e3,
                    "overlap_ms": {
                        str(o): overlap_us(siv, [(x["ts"], x["ts"] + x["dur"]) for x in oe]) / 1e3
                        for o, oe in streams.items() if o != sid
                    },
                }
            if i == CALLS // 2:
                lines = [f"== {label}: call {i}, device span {(end - start) / 1e3!r} ms, host "
                         f"{c['dur'] / 1e3!r} ms =="]
                for sid, evs in sorted(streams.items(), key=lambda kv: str(kv[0])):
                    lines.append(f"stream {sid}:")
                    lines += [f"  {(e['ts'] - start) / 1e3:9.4f} +{e['dur'] / 1e3:8.4f} ms  "
                              f"{short(e['name'])}" for e in sorted(evs, key=lambda e: e["ts"])]
                rnames: dict = {}
                for e in rt:
                    rnames[e["name"]] = rnames.get(e["name"], 0) + 1
                lines.append(f"runtime calls: {json.dumps(rnames, sort_keys=True)}")
                timeline = "\n".join(lines) + "\n"
        summaries.append(s)
    return summaries, timeline


def main() -> None:
    if not (ROOT / "implicitglobalgrid_tpu_torch" / "__init__.py").is_file():
        fail(f"{ROOT} holds no implicitglobalgrid_tpu_torch package: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import acoustic3d, diffusion3d
    from implicitglobalgrid_tpu_torch.ops import _kernels

    out = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "overlap_traces"
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_kernels.build, s) for s in ("fused_diffusion", "fused_leapfrog")]:
            f.result()

    f32 = torch.float32
    periodic = dict(periodx=1, periody=1, periodz=1)
    ov = lambda o: dict(overlapx=o, overlapy=o, overlapz=o)  # noqa: E731
    timelines = []

    def compare(label, a_label, a, b_label, b, state):
        ra, rb = a(*state), b(*state)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(ra, rb)):
            fail(f"{label}: {a_label} differs from {b_label}")
        for name, fn in ((a_label, a), (b_label, b)):
            summaries, timeline = trace(torch, lambda: fn(*state), f"{label}_{name}", out)
            timelines.append(timeline)
            mid = summaries[CALLS // 2]
            print(f"{label} {name}: host {host_ms(torch, lambda: fn(*state))!r} ms/call, device "
                  f"{device_ms(torch, lambda: fn(*state))!r} ms/call {card}")
            print(f"{label} {name}: traced call {CALLS // 2}: {json.dumps(mid, sort_keys=True)}")

    state, params = diffusion3d.setup(N, N, N, dtype=f32, quiet=True, **periodic, **ov(8))
    compare("diffusion_group", "pipelined",
            diffusion3d.make_multi_step(params, 4, fused_k=4, pipelined=True),
            "serialized", diffusion3d.make_multi_step(params, 4, fused_k=4, pipelined=False),
            state)
    igg.finalize_global_grid()

    state, params = acoustic3d.setup(N, N, N, dtype=f32, quiet=True, **periodic, **ov(12))
    compare("acoustic_group", "pipelined",
            acoustic3d.make_multi_step(params, 6, fused_k=6, pipelined=True),
            "serialized", acoustic3d.make_multi_step(params, 6, fused_k=6, pipelined=False),
            state)
    igg.finalize_global_grid()

    state, params = diffusion3d.setup(N, N, N, dtype=f32, quiet=True, hide_comm=True,
                                      **periodic, **ov(8))
    plain = diffusion3d.Params(**{**params.__dict__, "hide_comm": False})
    compare("diffusion_step", "hide_comm", diffusion3d.make_step(params), "plain",
            diffusion3d.make_step(plain), state)
    igg.finalize_global_grid()

    (out / "trace_overlap.txt").write_text("".join(timelines))
    print(f"timelines: {out / 'trace_overlap.txt'}; traces: {out}/trace_*.json")


if __name__ == "__main__":
    main()
