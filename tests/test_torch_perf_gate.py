"""The port's perf-regression gate (`implicitglobalgrid_tpu_torch.analysis.perf`
and ``python -m implicitglobalgrid_tpu_torch.scripts.check_perf``) against
the JAX package's `analysis.perf` and ``scripts/check_perf.py``.

Records are built from a numpy seed (nested ``teff``, ``teff_grad``,
``members_per_s``, ``rounds_per_s``, the inverse latencies,
``tuned_speedup``, the report-only keys, error-bearing and non-numeric
extras) and written under both names, ``BENCH_r<NN>.json`` (which only the
JAX gate reads) and ``BENCH_H100_r<NN>.json`` (which only the port's
reads), with truncated and wrapped variants.  On the same inputs: record
discovery, `gate_metrics`, `reported_metrics`, `compare_metrics` (the
one-sided band, waivers, round-scoped waivers, stale-waiver tracking),
`gate_summary` and the registry pass's findings equal JAX's; `load_waivers`
refuses what JAX's refuses; the two CLIs exit alike.  The port's one
adaptation is pinned on its side: records of another card, power limit or
headline metric are not compared.  The committed ``BENCH_H100_r01/r02``
pass the gate.  Host functions only: no device, no spawn.
"""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest

from implicitglobalgrid_tpu.analysis import perf as jperf
from implicitglobalgrid_tpu_torch.analysis import core as tcore
from implicitglobalgrid_tpu_torch.analysis import perf as tperf
from implicitglobalgrid_tpu_torch.scripts import check_perf as tcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}


def _jax_check_perf():
    spec = importlib.util.spec_from_file_location(
        "jax_check_perf", os.path.join(REPO, "scripts", "check_perf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jcheck = _jax_check_perf()


def _record(rng, scale=1.0, drop=()):
    """One bench record: every gated and reported key at some depth, extras
    that must contribute nothing, and ``drop`` extras left out."""
    u = lambda lo, hi: round(float(rng.uniform(lo, hi)) * scale, 4)  # noqa: E731
    extras = {
        "diffusion_xla": {"teff": u(80, 120), "t_it_ms": u(1, 2)},
        "diffusion_pallas_fused4": {"teff": u(2000, 2500), "t_it_ms": 0.06,
                                    "path": "cuda-fused"},
        "porous_256_pallas_fused": {"teff": u(900, 1100), "path": "cuda-fused",
                                    "npt12_w6": {"teff": u(900, 1100), "t_pt_ms": 0.5},
                                    "npt10_w6_ragged": {"teff": u(800, 1000)}},
        "diffusion_grad_fused4": {"teff_grad": u(20, 40), "t_grad_ms": 4.0},
        "batch_ensemble": {"members_per_s": u(50, 70), "throughput_multiplier": 2.5,
                           "sweep": {f"B{b}": {"members_per_s": u(10, 70), "t_step_ms": 1.0}
                                     for b in (1, 2, 4, 8)}},
        "frontdoor_serving": {"rounds_per_s": u(100, 130), "result_p50_per_s": u(5, 8),
                              "result_p99_per_s": u(5, 8), "submit_to_result_p50_s": 0.15,
                              "submit_to_result_p99_s": 0.16},
        "tuned_vs_default": {m: {"tuned_speedup": u(1, 16), "t_default_ms": 1.2}
                             for m in ("diffusion", "acoustic", "porous")},
        "efficiency": {"models": {"diffusion": {"achieved_fraction": u(0.5, 1.0)}}},
        "request_trace": {f"{s}_share": u(0, 1) for s in ("queue_wait", "rounds", "other")},
        "profile_attribution": {"overlap_fraction": u(0, 1)},
        "broken": {"error": "ValueError: boom"},
        "skipped_one": {"skipped": "why"},
        "stringy": {"teff": "fast", "members_per_s": None},
        "zero": {"teff": 0.0},
        "headline_path": "cuda_fused4",
    }
    for name in drop:
        extras.pop(name)
    return {"metric": "diffusion3d_256_float32_teff", "value": u(2000, 2500),
            "unit": "GB/s/chip", "extras": extras, "device": dict(H100)}


def _trajectory(seed, n=3):
    rng = np.random.default_rng(seed)
    return [_record(rng, scale=float(rng.uniform(0.8, 1.05)),
                    drop=("diffusion_grad_fused4",) if i == n - 1 and seed % 2 else ())
            for i in range(n)]


def _write(tmp_path, round_n, doc, raw=None):
    """``doc`` (or the text ``raw``) under both packages' round names."""
    for name in (f"BENCH_r{round_n:02d}.json", f"BENCH_H100_r{round_n:02d}.json"):
        (tmp_path / name).write_text(raw if raw is not None else json.dumps(doc))


def _as_jax(name):
    return name.replace("BENCH_H100_r", "BENCH_r")


SEEDS = [0, 1, 2, 3, 4, 5]


# -- discovery --------------------------------------------------------------------


def test_record_discovery_equals_jax(tmp_path):
    recs = _trajectory(7, n=4)
    _write(tmp_path, 1, None, raw='{"n": 1, "tail": "trunc')
    _write(tmp_path, 2, {"n": 2, "parsed": recs[0], "tail": ""})
    _write(tmp_path, 3, {"n": 3, "tail": "log noise " + json.dumps(recs[1]) + " exited 0\n"})
    _write(tmp_path, 4, recs[2])
    _write(tmp_path, 5, None, raw=json.dumps({"n": 5, "tail": 'noise {"metric": "m", "va'}))
    _write(tmp_path, 12, recs[3])
    (tmp_path / "BENCH_H100_notes.json").write_text("{}")
    got, skipped = tperf.load_bench_records(str(tmp_path))
    want, jskipped = jperf.load_bench_records(str(tmp_path))
    assert got == want and [r for r, _ in got] == [2, 3, 4, 12]
    assert [_as_jax(s) for s in skipped] == jskipped == ["BENCH_r01.json", "BENCH_r05.json"]
    for name in sorted(os.listdir(tmp_path)):
        assert tperf.parse_bench_file(str(tmp_path / name)) == \
            jperf.parse_bench_file(str(tmp_path / name))


def test_the_port_never_reads_the_tpu_rounds(tmp_path):
    rec = _trajectory(0, n=1)[0]
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(rec))
    assert tperf.load_bench_records(str(tmp_path)) == ([], [])
    assert tperf.gate_summary(rec, str(tmp_path))["note"] == \
        "no committed BENCH records to compare"
    ours = [r for r, _ in tperf.load_bench_records(REPO)[0]]
    theirs = [r for r, _ in jperf.load_bench_records(REPO)[0]]
    assert ours[:2] == [1, 2] and theirs == [2, 3, 4]
    assert tperf.record_name(7) == "BENCH_H100_r07.json"
    assert tperf.next_round(str(tmp_path)) == 1 and tperf.next_round(REPO) == ours[-1] + 1


# -- flattening and comparison ------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_gate_and_reported_metrics_equal_jax(seed):
    for rec in _trajectory(seed):
        assert tperf.gate_metrics(rec) == jperf.gate_metrics(rec)
        assert tperf.reported_metrics(rec) == jperf.reported_metrics(rec)
        assert "broken" not in json.dumps(list(tperf.gate_metrics(rec)))
    assert tperf.GATED_KEYS == jperf.GATED_KEYS
    assert tperf.REPORTED_KEYS == jperf.REPORTED_KEYS
    assert tperf.DEFAULT_TOL == jperf.DEFAULT_TOL == 0.15


def _waivers(rng, metrics):
    """A few waivers over ``metrics``: any-round, round-scoped, bounded."""
    out = []
    for m in rng.choice(sorted(metrics), size=4, replace=False):
        w = {"metric": str(m), "justification": f"measured dip of {m}"}
        if rng.random() < 0.5:
            w["max_drop"] = round(float(rng.uniform(0.1, 0.5)), 3)
        if rng.random() < 0.5:
            w["rounds"] = [int(rng.integers(1, 4))]
        out.append(w)
    out.append(dict(out[0], justification="a same-metric twin", rounds=[9]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tol", [0.05, 0.15, 0.3])
def test_compare_metrics_equals_jax(seed, tol):
    rng = np.random.default_rng(100 + seed)
    ref, cand = _trajectory(seed, n=2)
    rm, cm = tperf.gate_metrics(ref), tperf.gate_metrics(cand)
    waivers = _waivers(rng, rm)
    for cand_round in (None, 1, 2, 3, 9):
        for w in ([], waivers):
            got = tperf.compare_metrics(cm, rm, tol=tol, waivers=w, candidate_round=cand_round)
            assert got == jperf.compare_metrics(cm, rm, tol=tol, waivers=w,
                                                candidate_round=cand_round)
            # stale-waiver tracking is per entry (the CLIs' computation)
            used = {x["waiver_index"] for x in got["waived"]}
            assert all(0 <= i < len(w) for i in used)
    one_sided = tperf.compare_metrics({"a.teff": 500.0}, {"a.teff": 100.0}, waivers=[])
    assert one_sided["regressions"] == [] and one_sided["checked"] == 1


def test_stale_waivers_tracked_per_entry_as_jax():
    cand, ref = {"a.teff": 50.0}, {"a.teff": 100.0}
    live = {"metric": "a.teff", "justification": "covers round 9", "rounds": [9]}
    dead = {"metric": "a.teff", "justification": "covered round 3 only", "rounds": [3]}
    for mod in (tperf, jperf):
        cmp = mod.compare_metrics(cand, ref, waivers=[dead, live], candidate_round=9)
        assert [w["waiver_index"] for w in cmp["waived"]] == [1]
        cmp = mod.compare_metrics(cand, ref, waivers=[dead, live], candidate_round=None)
        assert cmp["waived"] == [] and len(cmp["regressions"]) == 1


@pytest.mark.parametrize("doc", [
    {"waivers": [{"metric": "a.teff", "justification": " "}]},
    {"waivers": [{"metric": "a.teff"}]},
    {"waivers": [{"metric": "", "justification": "why"}]},
    {"waivers": [{"justification": "why"}]},
    {"waivers": [{"metric": "a.teff", "justification": "ok"},
                 {"metric": "b.teff", "justification": None}]},
    {"waivers": [{"metric": "a.teff", "justification": "measured", "max_drop": 0.2}]},
    {"_comment": ["nothing else"]},
    "absent",
])
def test_load_waivers_refuses_what_jax_refuses(tmp_path, doc):
    path = tmp_path / "waivers.json"
    if doc != "absent":
        path.write_text(json.dumps(doc))
    results = []
    for mod in (tperf, jperf):
        try:
            results.append(("ok", mod.load_waivers(str(path))))
        except ValueError as e:
            results.append(("refused", str(e)))
    assert results[0] == results[1]


def test_shipped_waiver_file_is_well_formed():
    for w in tperf.load_waivers():
        assert w["justification"].strip() and w["metric"].strip()
        assert 0 < float(w.get("max_drop", 1.0)) <= 1.0
    assert tperf.PERF_WAIVERS.endswith(os.path.join("implicitglobalgrid_tpu_torch", "analysis",
                                                    "perf_waivers.json"))


# -- gate_summary and the registry pass -----------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_gate_summary_equals_jax(tmp_path, seed):
    recs = _trajectory(seed)
    for i, rec in enumerate(recs[:-1], start=1):
        _write(tmp_path, i, rec)
    _write(tmp_path, 9, None, raw='{"n": 9, "tail": "trunc')
    fresh = recs[-1]
    doctored = copy.deepcopy(fresh)
    doctored["value"] *= 0.5
    doctored["extras"]["tuned_vs_default"]["diffusion"]["tuned_speedup"] *= 0.5
    for cand in (fresh, doctored, {"extras": fresh["extras"], "device": fresh["device"]}):
        got = tperf.gate_summary(copy.deepcopy(cand), str(tmp_path))
        want = jperf.gate_summary(copy.deepcopy(cand), str(tmp_path))
        assert got == {**want, "skipped_records": ["BENCH_H100_r09.json"]}
        assert want["skipped_records"] == ["BENCH_r09.json"]
    bad = tperf.gate_summary(doctored, str(tmp_path))
    assert not bad["ok"] and {"headline", "tuned_vs_default.diffusion.tuned_speedup"} <= {
        r["metric"] for r in bad["regressions"]}
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tperf.gate_summary(fresh, str(empty)) == jperf.gate_summary(fresh, str(empty))


class _Ctx:
    def __init__(self, root):
        self.repo_root = str(root)


def _finding_view(findings):
    return [(f.analyzer, f.code, f.severity, _as_jax(f.symbol), f.anchor,
             _as_jax(f.message)) for f in findings]


@pytest.mark.parametrize("case", ["clean", "regression", "vanished", "unparseable", "one"])
def test_registry_pass_equals_jax(tmp_path, case):
    rng = np.random.default_rng(42)
    prev = _record(rng)
    cand = copy.deepcopy(prev)
    if case == "regression":
        cand["extras"]["diffusion_pallas_fused4"]["teff"] *= 0.5
        cand["extras"]["frontdoor_serving"]["result_p99_per_s"] *= 0.7
    if case == "vanished":
        cand["extras"].pop("diffusion_grad_fused4")
    if case != "one":
        _write(tmp_path, 1, prev)
    _write(tmp_path, 2, cand)
    if case == "unparseable":
        _write(tmp_path, 3, None, raw='{"n": 3, "tail": "trunc')
    got, want = tperf.run(_Ctx(tmp_path)), jperf.run(_Ctx(tmp_path))
    assert _finding_view(got) == _finding_view(want)
    # the same analyzer, code, symbol and anchor: the same baseline fingerprint
    assert [f.fingerprint for f in got if f.code != "unparseable-record"] == \
        [f.fingerprint for f in want if f.code != "unparseable-record"]
    codes = {"clean": [], "one": [], "unparseable": ["unparseable-record"],
             "regression": ["perf-regression", "perf-regression"],
             "vanished": ["metric-vanished"]}[case]
    assert [f.code for f in got] == codes


# -- the port's adaptation: another card or headline metric ----------------------------


@pytest.mark.parametrize("edit,code", [
    (lambda r: r["device"].update(power_limit_w=500.0), "device-mismatch"),
    (lambda r: r["device"].update(name="NVIDIA A100-SXM4-80GB"), "device-mismatch"),
    (lambda r: r.update(device={"name": "cpu"}), "device-mismatch"),
    (lambda r: r.pop("device"), "device-mismatch"),
    (lambda r: r.update(metric="diffusion3d_32_float32_teff"), "metric-mismatch"),
])
def test_records_of_another_card_or_metric_are_not_compared(tmp_path, edit, code):
    rng = np.random.default_rng(5)
    ref = _record(rng)
    cand = copy.deepcopy(ref)
    cand["value"] *= 0.1  # a drop that would fail if it were compared
    edit(cand)
    assert tperf.comparability_error(cand, ref)[0] == code
    _write(tmp_path, 1, ref)
    verdict = tperf.gate_summary(cand, str(tmp_path))
    assert verdict["ok"] is True and verdict["checked"] == 0
    assert verdict["note"].startswith(code) and "BENCH_H100_r01.json" in verdict["note"]
    _write(tmp_path, 2, cand)
    (finding,) = tperf.run(_Ctx(tmp_path))
    assert (finding.code, finding.severity, finding.symbol) == (code, "ERROR", "r02")
    p = tmp_path / "cand.json"
    p.write_text(json.dumps(cand))
    assert tcheck.main(["-c", str(p), "--against", str(tmp_path / "BENCH_H100_r01.json")]) == 2
    # a record with no headline metric (the batch record's gate input) and the
    # same card is compared on what it has
    assert tperf.comparability_error({"extras": {}, "device": dict(H100)}, ref) is None


# -- the CLIs ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["within", "regression", "garbage", "missing", "bad-waivers",
                                  "stale", "stale-strict", "waived", "json"])
def test_cli_exit_codes_equal_jax(tmp_path, case, capsys):
    rng = np.random.default_rng(11)
    ref = _record(rng)
    cand = copy.deepcopy(ref)
    cand["value"] *= 0.95 if case == "within" else 0.6
    if case not in ("within", "regression", "waived", "json"):
        cand["value"] = ref["value"]
    waivers = {"waivers": []}
    if case in ("stale", "stale-strict"):
        waivers = {"waivers": [{"metric": "no.such.teff", "justification": "left over"}]}
    if case == "waived":
        waivers = {"waivers": [{"metric": "headline", "justification": "measured",
                                "max_drop": 0.5}]}
    if case == "bad-waivers":
        waivers = {"waivers": [{"metric": "m", "justification": ""}]}
    (tmp_path / "w.json").write_text(json.dumps(waivers))
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    cpath = tmp_path / "cand.json"
    if case == "garbage":
        cpath.write_text(json.dumps({"no": "record"}))
    elif case != "missing":
        cpath.write_text(json.dumps(cand))
    argv = ["-c", str(cpath), "--against", str(tmp_path / "ref.json"),
            "--waivers", str(tmp_path / "w.json")]
    argv += {"stale-strict": ["--strict-waivers"], "json": ["--json"]}.get(case, [])
    got = tcheck.main(argv)
    ours = capsys.readouterr()
    assert got == jcheck.main(argv)
    theirs = capsys.readouterr()
    assert got == {"within": 0, "regression": 1, "garbage": 2, "missing": 2, "bad-waivers": 2,
                   "stale": 0, "stale-strict": 1, "waived": 0, "json": 1}[case]
    # each CLI also lists the unparseable records of its own trajectory
    if case == "json":
        a, b = json.loads(ours.out), json.loads(theirs.out)
        assert a.pop("skipped_records") == []
        b.pop("skipped_records")
        assert a == b
    elif case in ("within", "regression", "waived", "stale", "stale-strict"):
        def lines(out):
            return [ln for ln in out.splitlines()[:-1] if not ln.endswith("record, skipped")]

        assert lines(ours.out) == lines(theirs.out)


# -- the committed H100 records ----------------------------------------------------------


def test_committed_h100_records_pass_the_gate(capsys):
    records, skipped = tperf.load_bench_records(REPO)
    assert skipped == [] and [r for r, _ in records][:2] == [1, 2]
    for _, rec in records:
        assert rec["device"]["name"].startswith("NVIDIA H100")
        assert rec["device"]["power_limit_w"] > 0
        assert rec["extras"]["diffusion_pallas_fused4"]["path"] == "cuda-fused"
    assert tperf.run(tcore.Context()) == []
    report = tcore.run(["bench-regression"], baseline=None)
    assert report.ran == ["bench-regression"] and report.findings == []
    assert tcheck.main([]) == 0
    assert "check_perf: OK" in capsys.readouterr().out
    assert tcore.select_for_paths(["BENCH_H100_r03.json"]) == ["bench-regression"]
    assert tcore.select_for_paths(["BENCH_r06.json"]) == []
