"""The port's soak (`implicitglobalgrid_tpu_torch.scripts.soak`) against the
JAX package's ``scripts/soak.py``: its scenario list, constants and chaos
seed pick, its four event verifiers on the same event logs, and its
baseline field against JAX's ``diffusion3d.run``; plus the device rules.

* ``--list``, ``SCENARIOS``, ``SCENARIO_DESCRIPTIONS``, the exit statuses
  and ``_chaos_pick_seed`` equal JAX's (the JAX script is loaded from its
  file with `importlib`: its top level imports only the standard library).
* The serving, elastic, chaos and sdc verifiers give JAX's verdict, message
  for message, on event logs built from a seed: a passing log and doctored
  ones (a missing fallback, events out of order, a false positive, an
  untagged line, a missing section).  One documented difference: a
  supervised child's span dump is ``trace.g<gen>.p<rank>.json``
  (`utils.tracing.trace_filename`), which JAX's elastic verifier does not
  glob (ROADMAP Queue C); the port's does.
* The soak's baseline child equals JAX's ``diffusion3d.run`` with the JAX
  child's arguments at the same global size (8^3, one block), in float64,
  within 1e-12 relative.
* ``--device cuda`` without a card, or a 2-rank drill with one card, raises
  before anything runs; ``--fused-k`` must be even and divide ``--steps``.
"""

import contextlib
import importlib.util
import io
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from implicitglobalgrid_tpu_torch.scripts import soak

REPO = Path(__file__).resolve().parent.parent


def _load_jax_soak():
    spec = importlib.util.spec_from_file_location("jax_soak", REPO / "scripts" / "soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JSOAK = _load_jax_soak()


def test_list_and_constants_equal_jax(monkeypatch):
    assert soak.SCENARIOS == JSOAK.SCENARIOS
    assert soak.SCENARIO_DESCRIPTIONS == JSOAK.SCENARIO_DESCRIPTIONS
    assert (soak.CRASH_STATUS, soak.RESIZE_STATUS) == (JSOAK.CRASH_STATUS, JSOAK.RESIZE_STATUS)
    assert (soak.CHAOS_DRILL_KINDS, soak.CHAOS_DRILL_RATE) == (JSOAK.CHAOS_DRILL_KINDS,
                                                               JSOAK.CHAOS_DRILL_RATE)
    assert soak.QUICK == ["elastic_failover", "serving", "live_plane", "frontdoor", "chaos",
                          "fleet", "sdc"]
    monkeypatch.setattr(sys, "argv", ["soak.py", "--list"])  # JAX's main reads sys.argv
    outs = []
    for run in (lambda: soak.main(["--list"]), JSOAK.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run() == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 10


@pytest.mark.parametrize("steps", [6, 8, 12])
def test_chaos_seed_pick_equals_jax(steps):
    assert soak._chaos_pick_seed(steps) == JSOAK._chaos_pick_seed(steps)


# -- the event verifiers ---------------------------------------------------------------


class _Log:
    """Per-rank JSONL event logs with seeded, strictly increasing times."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.t = 1_700_000_000.0
        self.events = []

    def add(self, etype, rank=0, **kw):
        self.t += 0.01 + self.rng.random() * 0.2
        self.events.append({"ts": self.t, "rank": rank, "type": etype, **kw})

    def write(self, d: Path):
        d.mkdir(parents=True, exist_ok=True)
        by_rank = {}
        for e in self.events:
            by_rank.setdefault(e.get("rank", 0), []).append(e)
        for rank, evs in by_rank.items():
            name = "events.jsonl" if rank == 0 else f"events.p{rank}.jsonl"
            with open(d / name, "w") as f:
                for e in evs:
                    f.write(json.dumps(e) + "\n")
        return str(d)


def _both_verdicts(port_fn, jax_fn, *args):
    got, want = port_fn(*args), jax_fn(*args)
    assert got == want
    return got


def _serving_log(seed, doctor=None):
    log = _Log(seed)
    tags = lambda m: {"member": m, "slot": m % 2, "tenant": f"t{m}"}  # noqa: E731
    seq = [("serving.admit", 0), ("serving.admit", 1), ("serving.retire", 1),
           ("serving.converged", 0), ("serving.retire", 0), ("serving.admit", 2),
           ("serving.evict", 2), ("serving.admit", 3), ("serving.retire", 3)]
    if doctor == "no_midflight_admit":
        seq = [s for s in seq if s[0] != "serving.admit"]
        seq = [("serving.admit", m) for m in range(4)] + seq
    if doctor == "missing_evict":
        seq = [s for s in seq if s[0] != "serving.evict"]
    for etype, m in seq:
        kw = tags(m)
        if doctor == "untagged" and etype == "serving.converged":
            kw.pop("slot")
        log.add(etype, **kw)
    return log


@pytest.mark.parametrize("doctor", [None, "missing_evict", "untagged", "no_midflight_admit",
                                    "empty"])
def test_serving_verifier_equals_jax(tmp_path, doctor):
    d = tmp_path / "tele"
    if doctor == "empty":
        d.mkdir()
    else:
        _serving_log(7, doctor).write(d)
    ok, _ = _both_verdicts(soak._verify_serving_events, JSOAK._verify_serving_events, str(d))
    assert ok is (doctor is None)


def _chaos_log(seed, doctor=None):
    log = _Log(seed)
    seq = [
        ("fault.stall", 1, {"step": 2}), ("alert.step_stall", 1, {"rule": "step_stall"}),
        ("fault.worker_crash", 1, {"step": 3}), ("supervisor.detect", 0, {}),
        ("supervisor.classify", 0, {"kind": "crash"}),
        ("supervisor.recover", 0, {"action": "restart"}),
        ("checkpoint.restore", 0, {"mode": "same"}), ("fault.ckpt_corrupt", 0, {"step": 4}),
        ("fault.worker_crash", 1, {"step": 5}), ("supervisor.detect", 0, {}),
        ("supervisor.classify", 0, {"kind": "crash"}),
        ("supervisor.recover", 0, {"action": "shrink"}), ("checkpoint.fallback", 0, {}),
        ("checkpoint.restore", 0, {"mode": "elastic"}), ("fault.net_delay", 0, {"step": 6}),
        ("run.complete", 0, {}),
    ]
    if doctor == "shrink_before_restart":
        i, j = 5, 11
        seq[i], seq[j] = seq[j], seq[i]
    if doctor == "stall_not_caught":
        seq = [s for s in seq if s[0] != "alert.step_stall"]
    if doctor == "no_net_delay":
        seq = [s for s in seq if s[0] != "fault.net_delay"]
    for n, (etype, rank, kw) in enumerate(seq):
        log.add(etype, rank=rank, gen=0 if n < 7 else 1, **kw)
    if doctor == "untagged":
        log.events[3].pop("rank")
    return log


@pytest.mark.parametrize("doctor", [None, "shrink_before_restart", "stall_not_caught",
                                    "no_net_delay", "untagged"])
def test_chaos_verifier_equals_jax(tmp_path, doctor):
    d = _chaos_log(11, doctor).write(tmp_path / "tele")
    ok, _ = _both_verdicts(soak._verify_chaos_events, JSOAK._verify_chaos_events, d)
    assert ok is (doctor is None)


def _sdc_log(seed, doctor=None):
    log = _Log(seed)
    seq = [
        ("fault.bit_flip", 0, {"placement": "transport", "step": 2}),
        ("integrity.transport_mismatch", 1, {"implicated_rank": 0}),
        ("supervisor.recover", 0, {"action": "quarantine"}),
        ("fault.bit_flip", 0, {"placement": "state", "step": 4}),
        ("integrity.audit_mismatch", 0, {"implicated_ranks": [0]}),
        ("supervisor.recover", 0, {"action": "quarantine"}),
        ("fault.bit_flip", 0, {"placement": "ckpt", "step": 6}),
        ("fault.worker_crash", 0, {"step": 7}),
        ("checkpoint.fallback", 0, {}),
        ("run.complete", 0, {}),
    ]
    if doctor == "no_fallback":
        seq = [s for s in seq if s[0] != "checkpoint.fallback"]
    if doctor == "false_positive":  # the trip implicates an honest rank
        seq[1] = ("integrity.transport_mismatch", 1, {"implicated_rank": 1})
    if doctor == "audit_before_quarantine":
        seq[2], seq[4] = seq[4], seq[2]
    if doctor == "missing_placement":
        seq = [s for s in seq if s[2].get("placement") != "ckpt"]
    if doctor == "sender_reports":  # the trip from the sender, not the receiver
        seq[1] = ("integrity.transport_mismatch", 0, {"implicated_rank": 0})
    for etype, rank, kw in seq:
        log.add(etype, rank=rank, **kw)
    return log


@pytest.mark.parametrize("doctor", [None, "no_fallback", "false_positive",
                                    "audit_before_quarantine", "missing_placement",
                                    "sender_reports"])
def test_sdc_verifier_equals_jax(tmp_path, doctor):
    d = _sdc_log(13, doctor).write(tmp_path / "tele")
    ok, _ = _both_verdicts(soak._verify_sdc_events, JSOAK._verify_sdc_events, d)
    assert ok is (doctor is None)


def _elastic_run(tmp_path, seed, doctor=None, trace_names=("trace.p0.json", "trace.p1.json")):
    """The elastic drill's evidence: per-rank events, the restart's metrics
    dump, rank 1's crash flight bundle and the span dumps."""
    log = _Log(seed)
    seq = [("run.start", 0, {}), ("run.start", 1, {}),
           ("fault.worker_crash", 1, {"step": 4}), ("checkpoint.fallback", 0, {}),
           ("checkpoint.restore", 0, {"mode": "elastic"}), ("run.complete", 0, {})]
    if doctor == "no_fallback":
        seq = [s for s in seq if s[0] != "checkpoint.fallback"]
    if doctor == "restore_before_crash":
        seq[2], seq[4] = seq[4], seq[2]
    for etype, rank, kw in seq:
        log.add(etype, rank=rank, **kw)
    tele = tmp_path / "tele"
    log.write(tele)
    got_out = str(tmp_path / "resumed.npy")
    with open(got_out + ".metrics.json", "w") as f:
        json.dump({"histograms": {"diffusion3d.t_eff_gbs": {"count": 4, "p50": 1.5}}}, f)
    prom = "# TYPE igg_diffusion3d_t_eff_gbs summary\nigg_diffusion3d_t_eff_gbs_count 4\n"
    if doctor == "bad_prom":
        prom += "igg_diffusion3d_steps_total four\n"
    Path(got_out + ".metrics.prom").write_text(prom)
    bundle = {"reason": "fault.worker_crash", "rank": 0 if doctor == "bundle_rank" else 1,
              "metrics": {}, "config": {}, "spans": []}
    (tele / "flight_1.json").write_text(json.dumps(bundle) + "\n")
    for rank, name in enumerate(trace_names):
        (tele / name).write_text(json.dumps({
            "schema": 1, "rank": rank, "pid": 10 + rank, "coords": [rank, 0, 0],
            "gen": None, "dropped": 0,
            "clock_sync": {"wall": 1000.0, "perf": 5.0 * rank, "uncertainty_s": 1e-4,
                           "epoch": 1, "barrier": True},
            "spans": [{"name": "igg.step", "t0": 5.0 * rank + 1, "dur": 0.1, "args": {}},
                      {"name": "igg.checkpoint.restore", "t0": 5.0 * rank + 2, "dur": 0.2,
                       "args": {}}],
        }))
    return str(tele), got_out


@pytest.mark.parametrize("doctor", [None, "no_fallback", "restore_before_crash", "bad_prom",
                                    "bundle_rank"])
def test_elastic_verifier_equals_jax(tmp_path, doctor):
    args = _elastic_run(tmp_path, 17, doctor)
    ok, _ = _both_verdicts(soak._verify_elastic_telemetry, JSOAK._verify_elastic_telemetry,
                           *args)
    assert ok is (doctor is None)


def test_elastic_verifier_reads_generation_suffixed_dumps(tmp_path):
    """The one logged difference: a supervised restart dumps
    ``trace.g<gen>.p<rank>.json``; the port's verifier merges it, JAX's
    finds no ``trace.p*.json`` (ROADMAP Queue C)."""
    tele, got_out = _elastic_run(tmp_path, 19, trace_names=("trace.g1.p0.json",))
    assert soak._verify_elastic_telemetry(tele, got_out)[0] is True
    ok, msg = JSOAK._verify_elastic_telemetry(tele, got_out)
    assert ok is False and "no trace.p*.json span dumps" in msg


# -- the baseline against JAX's run ------------------------------------------------------


def test_soak_baseline_equals_jax_run(tmp_path):
    import jax

    from implicitglobalgrid_tpu.models import diffusion3d as jd

    proc = subprocess.run(
        [sys.executable, "-m", soak.MODULE, "baseline", "--device", "cpu", "--workdir",
         str(tmp_path / "soak")],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(tmp_path / "soak" / "baseline.npy")
    summary = json.loads((tmp_path / "soak" / "soak_summary.json").read_text())
    assert summary["dtype"] == "float64" and summary["scenarios"]["baseline"]["ok"]
    # the JAX child's arguments (scripts/soak.py child_main) on one device
    want = np.asarray(jd.run(8, 8, 8, 8, quiet=True, guard_every=1, guard_policy="rollback",
                             checkpoint_every=2, checkpoint_dir=str(tmp_path / "jck"),
                             devices=jax.devices()[:1]))
    assert got.shape == want.shape == (8, 8, 8) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


# -- the device rules -----------------------------------------------------------------


def _args(**kw):
    base = dict(device="cuda", scenarios=["baseline"], fused_k=0)
    return type("Args", (), {**base, **kw})()


def test_cuda_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        soak.require_cards(_args())
    soak.require_cards(_args(device="cpu", scenarios=list(soak.SCENARIOS)))  # no check


@pytest.mark.parametrize("cards", [1, 2])
def test_two_rank_drills_need_two_cards(monkeypatch, cards):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    single = ["baseline", "init_flake", "halo_corrupt", "worker_crash", "serving", "fleet"]
    soak.require_cards(_args(scenarios=single))  # one card holds every single-rank drill
    for drill in soak.TWO_RANK:
        if cards >= 2:
            soak.require_cards(_args(scenarios=[drill]))
        else:
            with pytest.raises(RuntimeError, match=f"2-rank drill.*{drill}.*two CUDA cards"):
                soak.require_cards(_args(scenarios=["baseline", drill]))


def test_orchestrator_refuses_before_running_anything(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="two CUDA cards"):
        soak.main(["baseline", "chaos", "--device", "cuda", "--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("argv", [["--fused-k", "3"], ["--fused-k", "4", "--steps", "6"],
                                  ["--fused-k", "1"]])
def test_fused_k_must_be_even_and_divide_steps(argv, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        soak.main(["baseline", "--device", "cpu", "--workdir", str(tmp_path), *argv])
    assert e.value.code == 2 and "--fused-k" in capsys.readouterr().err
