"""The port's reconcile report and cost model against the JAX package's.

Reconcile (`analysis.reconcile`): the iterations and the must-stream bytes
(bytes, global shape, dtype, field count) of each cadence config equal
JAX's `reconcile` number for number (JAX on the conftest's CPU devices, the
port as rank 0 of a simulated 2-rank grid); `join_measured` gives JAX's
output on the same report and measurements; the report's keys are JAX's.

Cost model (`analysis.costmodel`, the ``cost-model`` analyzer): the porous
coalesced exchange and its B=4 twin hop exactly as JAX's committed
``cost_baseline.json`` says (6 hops of 1344 B; 6 of 5376 B); per field, one
hop per field per side; the diffusion cadences hop as JAX's; the staggered
cadences hop differently by design, and both numbers are pinned here
(ROADMAP Queue C); the committed baseline is clean, a baseline with one hop
fewer is caught, and ``refresh cost`` refuses a change without a
justification.  The kernels' modeled bytes per launch at 256^3 are at least
the bytes ``chip_smoke.py`` bounds them by (each tensor moved once).
"""

import json
import os

import pytest
import torch

from _time_limit import time_limit
from implicitglobalgrid_tpu.analysis import reconcile as jrec
from implicitglobalgrid_tpu_torch.analysis import costmodel
from implicitglobalgrid_tpu_torch.analysis import reconcile as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BASELINE = os.path.join(REPO, "implicitglobalgrid_tpu", "analysis", "cost_baseline.json")
LIMIT_S = 120


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(LIMIT_S):
        yield


@pytest.fixture(scope="module")
def census():
    got, problems = costmodel.cost_census()
    assert problems == []
    return got


@pytest.fixture(scope="module")
def reports():
    """The port's and JAX's baseline reports, each taken once."""
    return (trec.reconcile_report(source="baseline"),
            jrec.reconcile_report(source="baseline"))


def jax_metrics(name):
    with open(JAX_BASELINE, encoding="utf-8") as f:
        return json.load(f)["programs"][name]["metrics"]


# -- reconcile ---------------------------------------------------------------------

@pytest.mark.parametrize("model", ["diffusion", "acoustic", "porous"])
def test_iterations_and_stream_bytes_equal_jax(reports, model):
    want = reports[1]["models"][model]  # JAX's model_stream_bytes and iterations
    assert trec.model_iterations(model) == jrec.model_iterations(model) == want["iterations"]
    assert trec.cadence_program(model) == jrec.cadence_program(model) == want["program"]
    got = trec.model_stream_bytes(model)
    assert got == {k: want[k] for k in ("stream_bytes", "global_shape", "dtype", "fields")}


def test_join_measured_equals_jax():
    report = {"source": "modeled", "note": "n", "models": {
        "diffusion": {"achieved_fraction": 0.75, "stream_bytes": 10},
        "acoustic": {"achieved_fraction": 1.2},
        "porous": {"achieved_fraction": None, "note": "absent"}}}
    for measured, overlap in (({"diffusion": 2100.5, "acoustic": 1500.0, "porous": 300.0},
                               {"diffusion": 0.25}),
                              ({"diffusion": 2100.5}, None), ({}, {"porous": 0.5})):
        assert trec.join_measured(report, measured, overlap) == \
            jrec.join_measured(report, measured, overlap)


def test_report_keys_equal_jax(reports):
    got, want = reports
    assert set(got) == set(want) and got["source"] == "baseline"
    assert set(got["models"]) == set(want["models"]) == set(trec.MODELS)
    for model in trec.MODELS:
        assert set(got["models"][model]) == set(want["models"][model]), model
        assert got["models"][model]["achieved_fraction"] > 0
    assert "temporal blocking" in got["note"] and "bench sizes" in got["note"]
    with pytest.raises(ValueError, match="modeled"):
        trec.reconcile_report(source="compiled")


def test_modeled_report_reads_the_census_and_equals_the_baseline(census, reports, monkeypatch):
    asked = []
    monkeypatch.setattr(costmodel, "cost_census", lambda programs: (
        asked.append(list(programs)) or {p: census[p] for p in programs}, []))
    got = trec.reconcile_report(source="modeled")
    assert asked == [[trec.cadence_program(m) for m in trec.MODELS]]
    for model in trec.MODELS:
        ba = census[trec.cadence_program(model)]["bytes_accessed"]
        assert got["models"][model]["bytes_accessed"] == ba
        assert abs(ba - reports[0]["models"][model]["bytes_accessed"]) <= 0.02 * ba
        assert got["models"][model]["achieved_fraction"] == round(
            got["models"][model]["stream_bytes"] * got["models"][model]["iterations"] / ba, 6)


# -- the cost model ------------------------------------------------------------------

@pytest.mark.parametrize("name", [costmodel.EXCHANGE_PROGRAM, costmodel.BATCHED_EXCHANGE_PROGRAM,
                                  "cadence/diffusion[pipelined=True]",
                                  costmodel.BATCHED_CADENCE_PROGRAM])
def test_hops_equal_jax_committed_baseline(census, name):
    want = jax_metrics(name)
    got = census[name]
    assert got["collective_permutes"] == want["collective_permutes"]
    assert got["collective_payload_bytes"] == want["collective_payload_bytes"]
    assert len(set(got["collective_hop_bytes"])) == 1


def test_exchange_hops_pinned(census):
    assert census[costmodel.EXCHANGE_PROGRAM]["collective_hop_bytes"] == [1344] * 6
    assert census[costmodel.BATCHED_EXCHANGE_PROGRAM]["collective_hop_bytes"] == [5376] * 6
    for name in (costmodel.EXCHANGE_PROGRAM, costmodel.BATCHED_EXCHANGE_PROGRAM):
        assert census[name]["kernel_launches"] == 0


def test_per_field_exchange_hops_once_per_field_and_side():
    got, problems = costmodel.exchange_program(coalesce=False)
    assert problems == []
    # 5 fields x 3 dimensions x 2 sides, the same bytes in all
    assert got["collective_permutes"] == 30
    assert got["collective_payload_bytes"] == 8064
    assert sorted(set(got["collective_hop_bytes"])) == [256, 288]


#: The staggered cadences' hops, port against JAX (a difference of
#: representation, ROADMAP Queue C): JAX's programs move the TPU layout (faces
#: padded by `pad_faces`, the z-active cadence's patch arrays) in two hops per
#: direction and group; the port moves the real n+1 faces, coalesced.
STAGGERED = {
    "acoustic": {"port": (4, 529408, [132352] * 4), "jax": (8, 1114112)},
    "porous": {"port": (16, 1389056, [16384] * 4 + [66176] * 4 + [132352] * 8),
               "jax": (24, 2558464)},
}


@pytest.mark.parametrize("model", sorted(STAGGERED))
def test_staggered_cadence_hops_pinned_beside_jax(census, model):
    name = f"cadence/{model}[pipelined=True]"
    want = jax_metrics(name)
    assert (want["collective_permutes"], want["collective_payload_bytes"]) == \
        STAGGERED[model]["jax"]
    got = census[name]
    assert (got["collective_permutes"], got["collective_payload_bytes"],
            got["collective_hop_bytes"]) == STAGGERED[model]["port"]
    assert got["pipelined_split"] == 1


def test_cadence_launches(census):
    # nt/k groups, each a ring and a mid launch; porous: 2 steps of chunks [2, 2]
    assert [census[f"cadence/{m}[pipelined=True]"]["kernel_launches"]
            for m in ("diffusion", "acoustic", "porous")] == [4, 4, 8]
    assert census[costmodel.BATCHED_CADENCE_PROGRAM]["kernel_launches"] == 0


def test_analyzer_clean_and_a_doctored_baseline_caught(census, tmp_path):
    base = costmodel.load_baseline()
    assert costmodel.compare_census(census, base) == []
    doctored = json.loads(json.dumps(base))
    m = doctored["programs"][costmodel.EXCHANGE_PROGRAM]["metrics"]
    m["collective_permutes"] -= 1
    m["collective_hop_bytes"] = m["collective_hop_bytes"][1:]
    found = costmodel.compare_census(census, doctored)
    assert sorted(f.anchor for f in found) == ["collective_hop_bytes", "collective_permutes"]
    assert all(f.code == "cost-regression" and f.severity == "ERROR" for f in found)
    # the modeled bytes within their band pass, outside it fail
    doctored = json.loads(json.dumps(base))
    ba = doctored["programs"][costmodel.EXCHANGE_PROGRAM]["metrics"]
    ba["bytes_accessed"] = int(ba["bytes_accessed"] * 1.01)
    assert costmodel.compare_census(census, doctored) == []
    ba["bytes_accessed"] = int(ba["bytes_accessed"] * 1.05)
    assert [f.anchor for f in costmodel.compare_census(census, doctored)] == ["bytes_accessed"]
    path = tmp_path / "unjustified.json"
    doctored["programs"][costmodel.EXCHANGE_PROGRAM]["justifications"]["bytes_accessed"] = " "
    path.write_text(json.dumps(doctored))
    with pytest.raises(ValueError, match="unjustified"):
        costmodel.load_baseline(str(path))


def test_refresh_cost_refuses_without_a_justification(census, tmp_path, monkeypatch, capsys):
    from implicitglobalgrid_tpu_torch.analysis.__main__ import main

    fresh = json.loads(json.dumps(census))
    monkeypatch.setattr(costmodel, "cost_census",
                        lambda *a, **k: (json.loads(json.dumps(fresh)), []))
    out = tmp_path / "cost_baseline.json"
    assert main(["refresh", "cost", "--out", str(out)]) == 1  # new metrics need a note
    assert not out.exists()
    assert main(["refresh", "cost", "--dry-run", "--out", str(out)]) == 0
    assert main(["refresh", "cost", "--out", str(out), "--justify-all", "fixture: pin"]) == 0
    doc = costmodel.load_baseline(str(out))
    assert doc["programs"] == {k: {"metrics": v, "justifications": dict.fromkeys(v, "fixture: pin")}
                               for k, v in census.items()}
    assert main(["refresh", "cost", "--out", str(out)]) == 0  # unchanged
    assert "nothing to refresh" in capsys.readouterr().out
    fresh[costmodel.EXCHANGE_PROGRAM]["collective_permutes"] = 7
    key = f"{costmodel.EXCHANGE_PROGRAM}::collective_permutes"
    assert main(["refresh", "cost", "--out", str(out)]) == 1
    assert main(["refresh", "cost", "--out", str(out), "--justify", f"{key}=fixture: +1"]) == 0
    doc = costmodel.load_baseline(str(out))
    assert doc["programs"][costmodel.EXCHANGE_PROGRAM]["metrics"]["collective_permutes"] == 7
    assert doc["programs"][costmodel.EXCHANGE_PROGRAM]["justifications"][
        "collective_permutes"] == "fixture: +1"


@pytest.mark.parametrize("model,k", [("diffusion3d", 4), ("acoustic3d", 6),
                                     ("porous_convection3d", 6)])
def test_modeled_bytes_are_at_least_the_bound_bytes(model, k):
    """`tuning.space.modeled_cost` counts the window re-reads (the traffic
    model); ``chip_smoke.py``'s bound counts each tensor once (the least
    traffic).  Per launch at 256^3 float32, the first is never below the
    second."""
    from implicitglobalgrid_tpu_torch.tuning import space

    n, size = 256, 4
    cell, faces = n**3, 3 * n * n * (n + 1)
    bound = {"diffusion3d": 3 * cell,                        # T, Cp in, T out
             "acoustic3d": 2 * (cell + faces),               # P, V in and out
             "porous_convection3d": cell + 2 * (cell + faces)}[model] * size
    modeled = space.modeled_cost(model, (n, n, n), torch.float32, {"fused_k": k},
                                 device="cpu", faces=True)["bytes_per_step"] * k
    assert modeled >= bound
    cells_only = space.modeled_cost(model, (n, n, n), torch.float32, {"fused_k": k},
                                    device="cpu")["bytes_per_step"]
    assert modeled >= cells_only * k  # the faces add to the cell count
