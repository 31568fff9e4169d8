"""The port's soak (`implicitglobalgrid_tpu_torch.scripts.soak`): the
single-process scenarios on the CPU, each run as a user runs it.

Each scenario runs as ``python -m implicitglobalgrid_tpu_torch.scripts.soak
<scenario> --device cpu --quick`` at the JAX soak's defaults (``--nx 8``,
``--quick``'s caps: 6 steps, 300 s per child) and must print its ``PASS``
line and ``ALL RECOVERED`` and exit 0: the recovered fields bit-identical
to their oracles (the baseline's saved array for init_flake, halo_corrupt
and worker_crash; the digests of an undisturbed pool for fleet), the
serving event schema.  The same single-process scenarios also run in
kernel groups (``--fused-k 2``: the kernels' plain versions on the CPU).
Each run has a hard limit (`_soak_run.run_soak`).  The 2-rank drills are
in ``tests/test_torch_soak_pairs.py``.
"""

import json

import pytest

from _soak_run import run_soak


@pytest.mark.parametrize("scenario", ["init_flake", "halo_corrupt", "worker_crash", "serving",
                                      "fleet"])
def test_single_process_scenario_passes_on_the_cpu(tmp_path, scenario):
    rc, out = run_soak([scenario, "--device", "cpu", "--quick"], tmp_path, limit=240)
    assert rc == 0 and f"[soak] {scenario:14s} PASS" in out and "ALL RECOVERED" in out, out
    summary = json.loads((tmp_path / "soak_summary.json").read_text())
    assert summary["device"] == "cpu" and summary["dtype"] == "float64"
    rec = summary["scenarios"][scenario]
    assert rec["ok"] is True
    if scenario in ("init_flake", "halo_corrupt", "worker_crash"):
        assert rec["sha256"] == summary["scenarios"]["baseline"]["sha256"]


def test_single_process_scenarios_in_kernel_groups(tmp_path):
    """``--fused-k 2``: the diffusion runs step in groups of 2 (guard every
    group, checkpoints every two, faults on group ends), the serving pool's
    PT iterations in chunks; every recovered field is still the
    baseline's."""
    rc, out = run_soak(["baseline", "init_flake", "halo_corrupt", "worker_crash", "serving",
                        "--device", "cpu", "--fused-k", "2", "--steps", "8"], tmp_path,
                       limit=240)
    assert rc == 0 and "ALL RECOVERED" in out, out
    scen = json.loads((tmp_path / "soak_summary.json").read_text())["scenarios"]
    assert all(r["ok"] for r in scen.values()) and len(scen) == 5
    assert {scen[s]["sha256"] for s in ("baseline", "init_flake", "halo_corrupt",
                                        "worker_crash")} == {scen["baseline"]["sha256"]}
    assert scen["worker_crash"]["crash_step"] == 4
