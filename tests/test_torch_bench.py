"""The port's benchmark harness (`implicitglobalgrid_tpu_torch.benchmarks`)
against the JAX package's ``benchmarks/run.py`` and ``bench.py``.

The CLI's modes are JAX's (read from its source with `ast`) but
``batch_hlo``, which the CLI refuses by name.  With the timer stubbed on
both sides, each bench gives JAX's metric name, provenance and record keys
for the same arguments (models, ``fused_k``, periods, ``pipelined``,
``exchange_every``, ``hide_comm``); `_emit` gives JAX's record; T_eff is
JAX's arithmetic.  On the CPU (``device="cpu"``) each model's fused config
runs its kernels' plain versions and says so; ``weak`` on two gloo ranks
gives one record; the coalesced-vs-per-field A/B on two gloo ranks counts
the hops and payloads the field shapes give; the bench twin prints one
JSON line with the ``efficiency`` join and, under ``--no-record``, writes
nothing, and its record files are never named ``BENCH_r<N>.json``.  Every
record names its device (``nvidia-smi``'s card name and power limit on the
card, ``{"name": "cpu"}`` here) and carries the perf gate's verdict against
the committed ``BENCH_H100_r<NN>.json`` records (the batch record on its
members/s only).
"""

import ast
import importlib.util
import json
import os
import re
import warnings

import jax
import pytest

from _time_limit import time_limit
import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu_torch.benchmarks import bench as tbench
from implicitglobalgrid_tpu_torch.benchmarks import run as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 150
SPREAD = {"reps": 1, "t_it_ms_min": 1.0, "t_it_ms_med": 1.0, "t_it_ms_max": 1.0}


@pytest.fixture(autouse=True)
def _limit_and_finalize():
    """Hard limit of each test (a hang fails it); no grid outlives it."""
    with time_limit(LIMIT_S):
        yield
    for igg in (tigg, jigg):
        if igg.grid_is_initialized():
            igg.finalize_global_grid()


@pytest.fixture(scope="module")
def jrun():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_run", os.path.join(REPO, "benchmarks", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_modes_are_jax_s_but_batch_hlo(capsys):
    tree = ast.parse(open(os.path.join(REPO, "benchmarks", "run.py"), encoding="utf-8").read())
    jax_modes = next(
        ast.literal_eval(kw.value) for node in ast.walk(tree) if isinstance(node, ast.Call)
        and node.args and isinstance(node.args[0], ast.Constant) and node.args[0].value == "what"
        for kw in node.keywords if kw.arg == "choices")
    assert set(trun.MODES) == set(jax_modes) - {"batch_hlo"}
    assert set(trun.NO_TWIN) == {"batch_hlo"}
    with pytest.raises(SystemExit) as e:
        trun.main(["batch_hlo", "--device", "cpu"])
    assert e.value.code == 2
    assert "no twin in the port" in capsys.readouterr().err


#: (bench, kwargs) run by both packages with the timer stubbed.
NAMED = [
    ("bench_diffusion", {}),
    ("bench_diffusion", dict(fused_k=4)),
    ("bench_diffusion", dict(fused_k=4, overlap=8, period="xz", pipelined=True)),
    ("bench_diffusion", dict(exchange_every=2, overlap=4, period="z")),
    ("bench_diffusion", dict(hide_comm=True)),
    ("bench_acoustic", dict(fused_k=6, overlap=12, period="z")),
    ("bench_acoustic", dict(fused_k=6, overlap=12, period="xz", pipelined=False)),
    ("bench_porous", dict(npt=12, fused_k=6, overlap=14, period="z")),
    ("bench_porous", dict(npt=10, exchange_every=2, overlap=4)),
    ("bench_porous", dict(npt=12, fused_k=6, overlap=14, period="xz", pipelined=True)),
]


@pytest.mark.parametrize("fn,kw", NAMED)
def test_metric_names_and_records_equal_jax(jrun, monkeypatch, fn, kw):
    """At 128^3 (inside both kernels' envelopes), one device."""
    monkeypatch.setattr(jrun, "_time_steps", lambda step, state, chunk, reps: (
        2e-3, state, SPREAD))
    monkeypatch.setattr(trun, "_time_steps", lambda step, state, chunk, reps, warmup=2: (
        2e-3, state, SPREAD))
    chunk = 2 if fn == "bench_porous" else 24
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jrun, fn)(n=128, chunk=chunk, emit=False, devices=jax.devices()[:1], **kw)
        got = getattr(trun, fn)(n=128, chunk=chunk, emit=False, device="cpu", **kw)
    assert got["metric"] == want["metric"]
    assert set(got) == set(want)
    assert got.get("pipelined") == want.get("pipelined")
    assert (got.get("path"), want.get("path")) in ((None, None),
                                                   ("cpu-fused-plain", "pallas-fused"))
    # T_eff: JAX's convention and arithmetic on the same timer
    assert (got["value"], got["t_it_ms"]) == (want["value"], want["t_it_ms"])


def test_emit_equals_jax_and_folds_into_telemetry(jrun, capsys):
    extra = {"dims": [1, 1, 1], "nprocs": 1, "spread": SPREAD}
    got = trun._emit("diffusion3d_64_float32", 123.456, 1.5e-3, extra)
    line = capsys.readouterr().out.strip()
    want = jrun._emit("diffusion3d_64_float32", 123.456, 1.5e-3, extra, emit=False)
    assert got == want == json.loads(line)
    assert tigg.telemetry_snapshot()["gauges"]["bench.diffusion3d_64_float32.teff_gbs"] == \
        123.456
    assert trun.metric_name("porous_convection3d", 256, "float32", npt=12, period="z",
                            fsuf="_fused6", psuf="_piped", exchange_every=6) == \
        "porous_convection3d_256_float32_npt12_periodz_fused6_piped_xch6"


@pytest.mark.parametrize("fn,kw", [("bench_diffusion", {}), ("bench_acoustic", {}),
                                   ("bench_porous", {"npt": 4})])
def test_cpu_runs_the_fused_configs_on_the_plain_kernels(fn, kw):
    rec = getattr(trun, fn)(n=16, chunk=2, reps=2, fused_k=2, emit=False, device="cpu", **kw)
    assert rec["path"] == "cpu-fused-plain" and rec["metric"].endswith("_fused2")
    assert rec["value"] > 0 and rec["spread"]["reps"] == 2
    with pytest.raises(ValueError, match="fused_k=3"):
        getattr(trun, fn)(n=16, chunk=3, reps=1, fused_k=3, emit=False, device="cpu", **kw)


def test_weak_on_two_gloo_ranks_gives_one_record(capsys):
    rec = trun.bench_weak_scaling(n=8, chunk=2, reps=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(rec))
    assert rec["metric"] == "weak_scaling_diffusion3d_8_float32"
    assert set(rec["per_count"]) == {1, 2} and rec["per_count"][1] == 1.0
    assert rec["value"] == rec["per_count"][2] > 0


def test_coalesce_ab_on_two_gloo_ranks_pins_hops_and_payloads():
    """Two ranks split x (non-periodic), z periodic on one rank: only x
    sends.  Per field one hop per side, a ``width``-plane slab of the
    field's (y, z) extent; coalesced, one hop per side carrying all five."""
    from implicitglobalgrid_tpu_torch.analysis.budget import model_fields

    n, width = 16, 2
    rec = trun.bench_halo_coalesce(n=n, width=width, reps=2, emit=False, nprocs=2)
    assert rec["metric"] == f"halo_coalesce_ab_5field_{n}cube_w{width}"
    assert rec["dims"] == [2, 1, 1] and rec["nfields"] == 5
    slabs = [width * A.shape[1] * A.shape[2] * 4 for A in model_fields("porous", n)]
    assert sorted(slabs) == [2048, 2048, 2048, 2176, 2176]
    per_field, coalesced = rec["per_field"], rec["coalesced"]
    assert per_field["n_collective_permutes"] == 2 * len(slabs) == 10
    assert coalesced["n_collective_permutes"] == 2
    assert per_field["payload_bytes_total"] == coalesced["payload_bytes_total"] == \
        2 * sum(slabs) == 20992
    assert rec["collectives_ratio"] == 5.0
    assert "sends" not in per_field and "sends" not in coalesced


def test_bench_twin_prints_one_line_with_the_efficiency_join_and_writes_nothing(
        tmp_path, monkeypatch, capsys):
    before = sorted(os.listdir(REPO))
    monkeypatch.setenv("IGG_TUNE_CACHE", str(tmp_path / "tune"))
    fused = ("diffusion_pallas_fused4", "acoustic_256_pallas_fused6", "porous_256_pallas_fused")
    configs = tbench._configs
    monkeypatch.setattr(tbench, "_configs", lambda n, device: {
        name: fn for name, fn in configs(n, device).items() if name in fused})
    mode, out, device, n = tbench.parse_args(["--device", "cpu", "--n", "16", "--no-record"])
    rec = tbench.main(out, device, n)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(rec))
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extras", "device"}
    assert rec["device"] == {"name": "cpu"}
    assert rec["metric"] == "diffusion3d_16_float32_teff"
    assert rec["vs_baseline"] == round(rec["value"] / tbench.BASELINE_TEFF_GBS, 3)
    extras = rec["extras"]
    assert not [k for k, v in extras.items() if isinstance(v, dict) and "error" in v]
    assert {k for k, v in extras.items() if isinstance(v, dict) and "skipped" in v} == set(
        tbench.SKIPPED)
    assert all(extras[k] == {"skipped": why} for k, why in tbench.SKIPPED.items())
    # the gate's verdict against the committed H100 records: a CPU record is
    # another device, so nothing is compared
    gate = extras["perf_gate"]
    assert gate["ok"] is True and gate["checked"] == 0
    assert gate["note"].startswith("device-mismatch: device name 'cpu'")
    eff = extras["efficiency"]["models"]
    for model, extra in (("diffusion", "diffusion_pallas_fused4"),
                         ("acoustic", "acoustic_256_pallas_fused6"),
                         ("porous", "porous_256_pallas_fused")):
        assert eff[model]["measured_teff_gbs"] == extras[extra]["teff"]
        assert eff[model]["modeled_actual_gbs"] == round(
            extras[extra]["teff"] / eff[model]["achieved_fraction"], 3)
    assert sorted(os.listdir(REPO)) == before  # --no-record: nothing written


def test_record_files_are_never_named_like_the_tpu_rounds(tmp_path, monkeypatch):
    assert tbench.parse_args([])[1] == "auto"
    assert tbench.parse_args(["--no-record"])[1] is None
    assert tbench.parse_args(["batch", "--out", "x.json", "--device", "cpu"])[:3] == (
        "batch", "x.json", "cpu")
    for name in ("BENCH_r07.json", "BENCH_H100_r03.json"):
        (tmp_path / name).write_text("{}")
    path = tbench.record_path(str(tmp_path))
    assert os.path.basename(path) == "BENCH_H100_r04.json"
    assert not re.fullmatch(r"BENCH_r\d+\.json", os.path.basename(path))
    assert not re.fullmatch(r"BENCH_r\d+\.json", os.path.basename(tbench.record_path()))
    assert tbench._write_round_record({"value": 1}, None) is None
    out = tmp_path / "rec.json"
    assert tbench._write_round_record({"value": 1}, str(out)) == str(out)
    assert json.loads(out.read_text()) == {"value": 1}
    monkeypatch.setattr(tbench, "ROOT", str(tmp_path))
    assert tbench._write_round_record({"value": 2}, "auto").endswith("BENCH_H100_r04.json")


def test_device_block_reads_the_card_from_nvidia_smi(monkeypatch):
    import subprocess

    import torch

    assert tbench.device_block("cpu") == {"name": "cpu"}
    calls = []

    def smi(argv, **kw):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")

    monkeypatch.setattr(subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    block = tbench.device_block("cuda")
    assert block == {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
                     "torch": torch.__version__, "cuda": torch.version.cuda}
    assert calls == [["nvidia-smi", "--id=3", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]

    def missing(argv, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert tbench.device_block("cuda:0")["power_limit_w"] is None


def test_batch_record_gates_its_members_per_s_only(tmp_path, monkeypatch, capsys):
    rec = {"members_per_s": 60.0, "best_B": 8, "job_steps": 100, "throughput_multiplier": 2.0,
           "sweep": {"B1": {"members_per_s": 30.0}, "B8": {"members_per_s": 60.0}}}
    monkeypatch.setattr(trun, "bench_batch", lambda **kw: rec)
    monkeypatch.setattr(tbench, "ROOT", str(tmp_path))
    ref = {"metric": "diffusion3d_32_float32_teff", "value": 5.0, "device": {"name": "cpu"},
           "extras": {"batch_ensemble": {"members_per_s": 100.0,
                                         "sweep": {"B1": {"members_per_s": 30.0}}}}}
    (tmp_path / "BENCH_H100_r01.json").write_text(json.dumps(ref))
    out = tbench.main_batch(None, "cpu", 16)
    assert json.loads(capsys.readouterr().out) == out and out["device"] == {"name": "cpu"}
    gate = out["extras"]["perf_gate"]
    # no headline: only the namespaced members/s are compared, and the best
    # B's 40% drop is a regression the record carries (it is not raised)
    assert gate["checked"] == 2 and gate["missing"] == ["headline"] and not gate["ok"]
    assert [r["metric"] for r in gate["regressions"]] == ["batch_ensemble.members_per_s"]
    assert out["extras"]["batch_hlo_ab"] == {"skipped": tbench.SKIPPED["batch_hlo_ab"]}
    assert "perf_gate" not in tbench.SKIPPED
