"""Benchmark: 3-D heat diffusion effective memory throughput (T_eff) per
GPU, the JAX package's root ``bench.py`` over the port.

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"extras"}``::

    python -m implicitglobalgrid_tpu_torch.benchmarks.bench [batch] [--out PATH | --no-record]
        [--device cuda|cpu] [--n N]

The headline is the faster of the two diffusion paths at the headline
block (``n^3`` float32, non-periodic, default ``n = 256`` on the card):
the plain cadence and the temporally blocked kernel (``fused_k=4``).  The
extras carry the JAX record's configs under its names (their sizes scale
with ``n``: 512³ is ``2n``), each run through `benchmarks.run`.  Extras
that read XLA's HLO or compile for a TPU topology cannot exist here and say
so as ``{"skipped": why}``; an extra that raises records ``{"error": ...}``
and the run goes on.  ``extras.perf_gate`` is `analysis.perf.gate_summary`
of the fresh record against the newest committed ``BENCH_H100_r<NN>.json``
(JAX's hook): the verdict rides in the record and never sinks it.  The
record's ``device`` block names the card it ran on (``name`` and
``power_limit_w`` as ``nvidia-smi`` gives them, the torch and CUDA
versions; ``{"name": "cpu"}`` on the CPU): the gate compares records of
one card and power limit only.

T_eff follows the reference community's convention (JAX's docstring): the
step must stream T in and out, ``A_eff = 2 n^3 sizeof(dtype)``, ``T_eff =
A_eff / t_it``; temporal blocking lets it exceed the copy rate.  Baseline:
the reference's optimized version, 154 GB/s per P100 (JAX ``bench.py:25-29``);
``vs_baseline`` = T_eff / 154.

``efficiency`` joins the cost model's report (`analysis.reconcile`,
``source="modeled"``) with this record's FUSED T_eff per model: the port's
modeled bytes are the kernels', so the kernels' T_eff is their measure
(JAX joins its XLA-path T_eff).

Record file: besides stdout, the record is written atomically (temp file +
``os.replace``) as the next ``BENCH_H100_r<NN>.json`` at the repo root, never
``BENCH_r<N>.json``: the JAX perf gate reads that trajectory as TPU rounds.
``--out PATH`` names the file, ``--no-record`` writes none.  On the CPU
(``--device cpu``) the default ``n`` is 32: a code-path record, not a
performance number.  These records are the harness's own, separate from
a ``BENCHMARK.json`` benchmark's cells.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..analysis import perf
from ..analysis.core import REPO_ROOT as ROOT  # where an automatic record is written
from . import run as _bench

BASELINE_TEFF_GBS = 154.0  # the reference's optimized version, per P100

#: Extras the port cannot produce, with why (never a number).
SKIPPED = {
    "weak_scaling_aot_proxy_256chip": (
        "an ahead-of-time compile of XLA's program for a 256-chip TPU topology; the port "
        "compiles CUDA kernels, not programs, and one card has no mesh (ROADMAP leftover 3)"),
    "weak_scaling_aot_proxy_256chip_pipelined": (
        "an ahead-of-time compile of XLA's pipelined program for a 256-chip TPU topology "
        "(see weak_scaling_aot_proxy_256chip)"),
    "batch_hlo_ab": (
        "reads the collective-permutes of XLA's optimized HLO; the port's twin is the "
        "cost-model analyzer's exchange/porous[coalesce=True,batch=4] program"),
}

def record_path(root: str | None = None) -> str:
    """The next ``BENCH_H100_r<NN>.json`` under ``root`` (default: the
    repo root)."""
    root = root or ROOT
    return os.path.join(root, perf.record_name(perf.next_round(root)))


def _write_round_record(record: dict, out: str | None = "auto") -> str | None:
    """Write ``record`` atomically (``out``: ``"auto"`` = `record_path`, a
    path, or None / empty = nothing)."""
    from ..utils.telemetry import atomic_write_json

    if not out:
        return None
    out = record_path() if out == "auto" else out
    atomic_write_json(out, record, indent=1)
    print(f"[bench] record written atomically to {out}", file=sys.stderr)
    return out


def device_block(device) -> dict:
    """The card the record ran on: ``name`` and ``power_limit_w`` as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (the limit in watts), and the torch and CUDA versions;
    ``{"name": "cpu"}`` for a CPU run."""
    import subprocess

    import torch

    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return {"name": "cpu"}
    index = device.index if device.index is not None else torch.cuda.current_device()
    block = {"name": torch.cuda.get_device_name(index), "power_limit_w": None,
             "torch": torch.__version__, "cuda": torch.version.cuda}
    # nvidia-smi counts every card; CUDA counts the visible ones
    visible = [v.strip() for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    smi_id = visible[index] if index < len(visible) else str(index)
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={smi_id}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
        name, limit = (part.strip() for part in line.splitlines()[0].rsplit(",", 1))
        block["name"] = name
        block["power_limit_w"] = float(limit.removesuffix("W").strip())
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass  # no nvidia-smi: the name from torch, the limit unknown
    return block


def _perf_gate(record: dict) -> dict:
    """`analysis.perf.gate_summary` of ``record`` against the newest
    committed round; an exception is recorded, never raised."""
    try:
        return perf.gate_summary(record, ROOT)
    except Exception as e:  # noqa: BLE001 — never let the gate sink the record
        return {"error": f"{type(e).__name__}: {e}"}


def _post(port: int, path: str, doc: dict, headers=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(doc).encode(),
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=30)


def _door(n: int, capacity: int, device):
    """A capacity-``capacity`` diffusion pool behind a loopback door."""
    import torch

    from .. import init_global_grid
    from ..models import diffusion3d
    from ..serving import FrontDoor, ServingLoop

    _bench._fresh_grid()
    init_global_grid(n, n, n, quiet=True, device=device)
    _, params = diffusion3d.setup(n, n, n, init_grid=False, dtype=torch.float32)
    loop = ServingLoop(diffusion3d, params, capacity=capacity, steps_per_round=1)
    return loop, FrontDoor(loop, port=0, host="127.0.0.1",
                           setup_kwargs={"dtype": torch.float32})


def _frontdoor_serving_record(n=32, requests=6, max_steps=8, capacity=2, device=None):
    """Submit-to-result latency and round throughput through the HTTP
    front door (loopback, ephemeral port; JAX's record)."""
    from .. import finalize_global_grid

    loop, fd = _door(n, capacity, device)
    try:
        t0 = time.perf_counter()
        rids = []
        for i in range(requests):
            with _post(fd.port, "/v1/submit", {
                    "tenant": f"t{i % 3}",
                    "params": {"max_steps": max_steps, "ic_scale": 1.0 + i / 16.0}}) as r:
                rids.append(json.load(r)["request_id"])
        # one round at a time, stopping the clock at the last retirement
        budget = requests * max_steps + 8
        while budget > 0 and not all(
                (fd.result_view(rid) or {}).get("status") == "done" for rid in rids):
            fd.serve_rounds(max_rounds=1)
            budget -= 1
        elapsed = time.perf_counter() - t0
        lats = []
        for rid in rids:
            view = fd.result_view(rid)
            if not view or view.get("status") != "done":
                raise RuntimeError(f"request {rid} never completed: {view}")
            lats.append(view["latency_s"])
        lats.sort()
        p50 = lats[len(lats) // 2]
        p99 = lats[min(len(lats) - 1, round(0.99 * (len(lats) - 1)))]
        return {
            "n": n, "requests": requests, "capacity": capacity, "max_steps": max_steps,
            "rounds": loop.rounds, "rounds_per_s": round(loop.rounds / elapsed, 3),
            "result_p50_per_s": round(1.0 / p50, 4), "result_p99_per_s": round(1.0 / p99, 4),
            "submit_to_result_p50_s": round(p50, 4), "submit_to_result_p99_s": round(p99, 4),
            "note": ("loopback HTTP through serving.FrontDoor; latency includes queue wait "
                     "(requests > capacity by design)"),
        }
    finally:
        fd.close()
        finalize_global_grid()


def _request_trace_record(n=32, max_steps=6, capacity=2, device=None):
    """One traced request through the loopback door (an inbound W3C
    ``traceparent`` accepted and echoed), its causal tree rebuilt from the
    span ring and its latency split per segment (JAX's record)."""
    from .. import finalize_global_grid
    from ..utils import tracing as _tracing

    if not _tracing.enabled():
        return {"skipped": "tracing disabled (IGG_TELEMETRY/IGG_TRACE_RING)"}
    _, fd = _door(n, capacity, device)
    try:
        inbound = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        with _post(fd.port, "/v1/submit", {"tenant": "trace", "params": {
                "max_steps": max_steps}}, headers={"traceparent": inbound}) as r:
            rid = json.load(r)["request_id"]
            echoed = r.headers.get("traceparent")
        budget = max_steps + 8
        while budget > 0 and (fd.result_view(rid) or {}).get("status") != "done":
            fd.serve_rounds(max_rounds=1)
            budget -= 1
        view = fd.result_view(rid)
        if not view or view.get("status") != "done":
            raise RuntimeError(f"traced request never completed: {view}")
        ctx = _tracing.parse_traceparent(echoed)
        if ctx is None or ctx["trace_id"] != "ab" * 16:
            raise RuntimeError(f"traceparent did not round-trip: {echoed!r}")
        doc = {"schema": _tracing.TRACE_SCHEMA, "rank": 0, "gen": None,
               "dropped": _tracing.spans_dropped(), "clock_sync": _tracing.clock_sync(),
               "spans": _tracing.span_records()}
        tree = _tracing.request_tree([doc], ctx["trace_id"])
        cp = _tracing.critical_path(tree)
        rec = {"trace_id": ctx["trace_id"], "spans": tree["spans"],
               "incomplete": tree["incomplete"], "latency_s": round(view["latency_s"], 4),
               "total_s": round(cp["total_s"], 4)}
        for seg, v in cp["segments"].items():
            rec[f"{seg}_share"] = round(v["share"], 4)
            rec[f"{seg}_s"] = round(v["s"], 6)
        return rec
    finally:
        fd.close()
        finalize_global_grid()


def _batch_extra(rec):
    """The ensemble record's projection (JAX's ``_batch_extra``)."""
    return {k: rec[k] for k in ("members_per_s", "best_B", "job_steps",
                                "throughput_multiplier", "sweep")}


def _fused_record(r):
    rec = {"teff": r["value"], "t_it_ms": r["t_it_ms"], "path": r.get("path"),
           "spread": r.get("spread")}
    if "pipelined" in r:
        rec["pipelined"] = r["pipelined"]
    return rec


def efficiency(extras: dict) -> dict:
    """The cost model's report joined with the record's fused T_eff per
    model (and the captured overlap fraction, where one was measured)."""
    from ..analysis.reconcile import join_measured, reconcile_report

    report = reconcile_report(source="modeled")
    measured = {
        "diffusion": extras.get("diffusion_pallas_fused4", {}).get("teff"),
        "acoustic": extras.get("acoustic_256_pallas_fused6", {}).get("teff"),
        "porous": extras.get("porous_256_pallas_fused", {}).get("teff"),
    }
    frac = extras.get("profile_attribution", {}).get("overlap_fraction")
    return join_measured(report, measured, {"diffusion": frac} if frac is not None else None)


def _telemetry_extra() -> dict:
    from .. import telemetry_snapshot
    from ..utils.liveplane import get_engine, slo_view
    from ..utils.tracing import span_summary

    snap = telemetry_snapshot()
    return {"counters": snap["counters"], "gauges": snap["gauges"],
            "histograms": snap["histograms"], "spans": span_summary(),
            "slo_windows": slo_view(snap), "alerts": get_engine().recent_alerts()}


def _configs(n: int, device) -> dict:
    """The extras that run a config: name -> zero-argument function (JAX
    ``bench.py:360-780``, sizes relative to the headline ``n``)."""
    B = _bench
    kw = dict(dtype="float32", emit=False, device=device)

    def diffusion(**k):
        return _fused_record(B.bench_diffusion(**{"n": n, "chunk": 24, "reps": 3, **kw, **k}))

    def acoustic(**k):
        return _fused_record(B.bench_acoustic(**{"n": n, "chunk": 24, "reps": 3, **kw, **k}))

    def porous(**k):
        r = B.bench_porous(**{"n": n, "chunk": 2, "reps": 3, "npt": 12, **kw, **k})
        return {**_fused_record(r), "t_pt_ms": r.get("t_pt_ms")}

    def update_halo_in_place():
        import torch

        from .. import finalize_global_grid, get_global_grid, init_global_grid, update_halo

        B._fresh_grid()
        init_global_grid(n, n, n, periodz=1, quiet=True, device=device)
        T = torch.ones((n, n, n), dtype=torch.float32, device=get_global_grid().device)
        t_it, _, spread = B._time_steps(lambda T: (update_halo(T),), (T,), 1, 3)
        finalize_global_grid()
        return {"in_place": {"t_call_ms": round(t_it * 1e3, 4), "spread": spread},
                "note": ("the port's update_halo writes the halo planes in place (JAX's "
                         "donate_on); there is no donate knob")}

    def porous_fused():
        r12 = B.bench_porous(n=n, chunk=2, reps=3, npt=12, fused_k=6, **kw)
        r10 = B.bench_porous(n=n, chunk=2, reps=3, npt=10, fused_k=6, **kw)
        return {**_fused_record(r12), "t_pt_ms": r12.get("t_pt_ms"),
                "npt12_w6": {"teff": r12["value"], "t_pt_ms": r12.get("t_pt_ms")},
                "npt10_w6_ragged": {"teff": r10["value"], "t_pt_ms": r10.get("t_pt_ms")}}

    def ab(fn, **k):
        return {"serialized": fn(pipelined=False, **k), "pipelined": fn(pipelined=True, **k)}

    def plain(fn, **k):
        r = fn(**k, **kw)
        return {"teff": r["value"], "t_it_ms": r["t_it_ms"]}

    def grad():
        r = B.bench_diffusion_grad(n=n, chunk=8, reps=3, fused_k=4, **kw)
        return {"teff_grad": r["value"], "t_grad_ms": r["t_it_ms"], "t_fwd_ms": r["t_fwd_ms"],
                "grad_over_fwd": r["grad_over_fwd"]}

    def tuned():
        out = {}
        for label, k in (("diffusion", dict(model="diffusion", n=n, chunk=24)),
                         ("acoustic", dict(model="acoustic", n=n, chunk=24)),
                         ("porous", dict(model="porous", n=n, chunk=2, npt=12))):
            try:
                out[label] = B.bench_tuned_vs_default(reps=3, emit=False, device=device, **k)
            except Exception as e:  # one model's A/B must not sink the rest
                out[label] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def coalesce():
        rec = B.bench_halo_coalesce(n=32, reps=2, emit=False, nprocs=2)
        rec["note"] = ("two gloo ranks on the CPU: the hop counts and payloads are structural; "
                       "t_call_ms is a code-path record, not performance")
        return rec

    def weak():
        rec = B.bench_weak_scaling(n=16, chunk=4, reps=2, device="cpu", emit=False)
        rec["note"] = ("gloo ranks on the CPU: a CODE-PATH record, the efficiency ratio is NOT "
                       "a performance number")
        return rec

    def profile():
        rec = B.bench_profile_attribution(n=16, emit=False, device=device)
        rec["note"] = ("a torch.profiler capture of a 16^3 diffusion run on this device; on the "
                       "CPU it holds no device ops")
        return rec

    return {
        "update_halo_donate": update_halo_in_place,
        "diffusion_pallas_fused4": lambda: diffusion(reps=5, fused_k=4),
        "diffusion_512_pallas_fused4": lambda: diffusion(n=2 * n, fused_k=4),
        "diffusion_xla_overlap": lambda: {**plain(B.bench_diffusion, n=n, chunk=24, reps=3,
                                                  hide_comm=True),
                                          "note": "1 GPU: no neighbours, delta vs plain is "
                                                  "scheduling noise"},
        "acoustic": lambda: plain(B.bench_acoustic, n=3 * n // 4, chunk=25, reps=3),
        "acoustic_overlap": lambda: plain(B.bench_acoustic, n=3 * n // 4, chunk=25, reps=3,
                                          hide_comm=True),
        "acoustic_256_pallas_fused6": lambda: acoustic(fused_k=6),
        "porous_pt": lambda: (lambda r: {"teff": r["value"], "t_pt_ms": r.get("t_pt_ms")})(
            B.bench_porous(n=5 * n // 8, chunk=4, reps=3, npt=10, **kw)),
        "porous_256_pallas_fused": porous_fused,
        "diffusion_periodz_pallas_fused4": lambda: diffusion(fused_k=4, overlap=8, period="z"),
        "acoustic_periodz_pallas_fused6": lambda: acoustic(fused_k=6, overlap=12, period="z"),
        "porous_periodz_pallas_fused6": lambda: porous(fused_k=6, overlap=14, period="z"),
        "diffusion_periodz_pipelined_ab": lambda: ab(diffusion, fused_k=4, overlap=8,
                                                     period="z"),
        "acoustic_periodz_pipelined_ab": lambda: ab(acoustic, fused_k=6, overlap=12, period="z"),
        "porous_periodz_pipelined_ab": lambda: ab(porous, fused_k=6, overlap=14, period="z"),
        "diffusion_periodxz_pipelined_ab": lambda: ab(diffusion, fused_k=4, overlap=8,
                                                      period="xz"),
        "acoustic_periodxz_pipelined_ab": lambda: ab(acoustic, fused_k=6, overlap=12,
                                                     period="xz"),
        "porous_periodxz_pipelined_ab": lambda: ab(porous, fused_k=6, overlap=14, period="xz"),
        "halo_coalesce_ab": coalesce,
        "diffusion_grad_fused4": grad,
        "tuned_vs_default": tuned,
        "weak_scaling_codepath": weak,
        "batch_ensemble": lambda: _batch_extra(B.bench_batch(n=n // 2, chunk=16, reps=3,
                                                             emit=False, device=device)),
        "frontdoor_serving": lambda: _frontdoor_serving_record(device=device),
        "request_trace": lambda: _request_trace_record(device=device),
        "profile_attribution": profile,
    }


def default_n(device) -> int:
    """The headline block edge: 256 on the card, 32 on the CPU."""
    return 32 if str(device).startswith("cpu") else 256


def main(out: str | None = None, device=None, n: int | None = None) -> dict:
    """The headline record (printed as one line; written to ``out``)."""
    n = n or default_n(device)
    rec = _bench.bench_diffusion(n=n, chunk=24, reps=5, dtype="float32", emit=False,
                                 device=device)
    extras = {"diffusion_xla": {"teff": rec["value"], "t_it_ms": rec["t_it_ms"]}}

    def extra(name, fn):
        # per-config isolation: one failing config must not sink the others
        try:
            extras[name] = fn()
        except Exception as e:  # noqa: BLE001 — recorded, the run goes on
            extras[name] = {"error": f"{type(e).__name__}: {e}"}

    for name, fn in _configs(n, device).items():
        extra(name, fn)
    for name, why in SKIPPED.items():
        extras[name] = {"skipped": why}
    extra("efficiency", lambda: efficiency(extras))
    extra("telemetry", _telemetry_extra)
    best = rec["value"]
    extras["headline_path"] = "plain"
    fused = extras.get("diffusion_pallas_fused4", {})
    if fused.get("teff", 0.0) > best:
        best = fused["teff"]
        extras["headline_path"] = ("cuda_fused4" if fused.get("path") == "cuda-fused"
                                   else "cpu_fused4_plain")
    metric = f"diffusion3d_{n}_float32_teff"
    dev = device_block(device)
    extras["perf_gate"] = _perf_gate({"metric": metric, "value": best, "extras": extras,
                                      "device": dev})
    record = {"metric": metric, "value": best, "unit": "GB/s/chip",
              "vs_baseline": round(best / BASELINE_TEFF_GBS, 3), "extras": extras,
              "device": dev}
    print(json.dumps(record), flush=True)
    _write_round_record(record, out)
    return record


def main_batch(out: str | None = None, device=None, n: int | None = None) -> dict:
    """``bench batch``: the ensemble record alone (members/s over a B
    sweep at ``n/2``)."""
    n = n or default_n(device)
    rec = _bench.bench_batch(n=n // 2, chunk=16, reps=3, emit=False, device=device)
    extras = {"batch_ensemble": _batch_extra(rec),
              "batch_hlo_ab": {"skipped": SKIPPED["batch_hlo_ab"]}}
    dev = device_block(device)
    # no "value" and no "metric" on purpose (JAX's): this record's headline
    # is members/s, the committed rounds' GB/s — only the namespaced
    # members_per_s extras are comparable across rounds
    extras["perf_gate"] = _perf_gate({"extras": extras, "device": dev})
    record = {"metric": "diffusion3d_batch_members_per_s", "value": rec["members_per_s"],
              "unit": "members/s/chip", "extras": extras, "device": dev}
    print(json.dumps(record), flush=True)
    _write_round_record(record, out)
    return record


def parse_args(argv):
    """``(mode, out, device, n)`` of the command line."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m implicitglobalgrid_tpu_torch.benchmarks.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default=None, choices=["batch"],
                   help="batch: the ensemble record alone (default: the headline record)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--out", default="auto", help="record path (default: the next "
                   "BENCH_H100_r<NN>.json at the repo root)")
    g.add_argument("--no-record", dest="out", action="store_const", const=None,
                   help="write no record file")
    p.add_argument("--device", default="cuda", help="cuda (default: the card) or cpu")
    p.add_argument("--n", type=int, default=None,
                   help="headline block edge (default 256 on the card, 32 on the CPU)")
    a = p.parse_args(argv)
    return a.mode, a.out, a.device, a.n


if __name__ == "__main__":
    mode, out, device, n = parse_args(sys.argv[1:])
    if mode == "batch":
        main_batch(out, device, n)
    else:
        main(out, device, n)
