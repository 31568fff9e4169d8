"""The port's soak (`implicitglobalgrid_tpu_torch.scripts.soak`): the five
2-rank drills on the CPU (gloo pairs under `supervisor.RunSupervisor`).

Each drill runs as ``python -m implicitglobalgrid_tpu_torch.scripts.soak
<scenario> --device cpu --quick`` at the JAX soak's defaults and must
print its ``PASS`` line and ``ALL RECOVERED`` and exit 0: elastic_failover
(shrunk restart past a corrupt generation, bit for bit with the oracle in
de-duplicated space, the event timeline, metrics, flight bundle and merged
trace), live_plane (both ranks scraped mid-run, the igg_top view, a
rank-tagged stall alert), frontdoor (429s under a stall, scale up and down,
digests equal to the oracle), chaos (restart then shrink under a seeded
storm, bit for bit, the event order) and sdc (each bit flip caught by its
detector, quarantines, the lineage fallback, bit for bit, zero false
positives).  On the card these drills need two GPUs (ROADMAP leftover 3).
Each run has a hard limit (`_soak_run.run_soak`).
"""

import json

import pytest

from _soak_run import run_soak


@pytest.mark.parametrize("scenario", ["elastic_failover", "live_plane", "frontdoor", "chaos",
                                      "sdc"])
def test_two_rank_drill_passes_on_the_cpu(tmp_path, scenario):
    rc, out = run_soak([scenario, "--device", "cpu", "--quick"], tmp_path, limit=300)
    label = "elastic" if scenario == "elastic_failover" else scenario
    assert rc == 0 and f"[soak] {label:14s} PASS" in out and "ALL RECOVERED" in out, out
    rec = json.loads((tmp_path / "soak_summary.json").read_text())["scenarios"][scenario]
    assert rec["ok"] is True
    if scenario in ("elastic_failover", "chaos", "sdc"):
        assert "bit-identical" in out or "max |err| 0.0" in out
