"""The port's static-analysis suite (`implicitglobalgrid_tpu_torch.analysis`)
against the JAX package's `analysis`.

Held against JAX on the same inputs: `Finding` fingerprints and `Report`
exit codes and JSON; the SARIF export (apart from the tool's name, against
JAX's golden file too); the divergence detector's verdicts; knob-decl's
findings on one fixture tree.  Port twins of JAX `tests/test_static_analysis.py`
and `tests/test_tuning.py`: the rank-guard pass fires and stays quiet on
torch fixtures; the real host-plan censuses are clean and a seeded
rank-keyed tune lookup is caught; tune-cache-valid fires on seeded defects
and is clean on the committed layer; the baseline's runner; and the port's
own tree runs clean with every analyzer and no stale suppression, in
process and through ``python -m implicitglobalgrid_tpu_torch.analysis``.
Host functions only: nothing here needs a device or a Pallas interpreter.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from implicitglobalgrid_tpu.analysis import collectives as JC
from implicitglobalgrid_tpu.analysis import core as jcore
from implicitglobalgrid_tpu.analysis import knobs as jknobs
from implicitglobalgrid_tpu.analysis import sarif as jsarif
from implicitglobalgrid_tpu.analysis.ir import RankCensus as JRankCensus
from implicitglobalgrid_tpu_torch import analysis as tanalysis
from implicitglobalgrid_tpu_torch import tuning as tt
from implicitglobalgrid_tpu_torch.analysis import collectives as TC
from implicitglobalgrid_tpu_torch.analysis import core as tcore
from implicitglobalgrid_tpu_torch.analysis import knobs as tknobs
from implicitglobalgrid_tpu_torch.analysis import sarif as tsarif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture_ctx(tmp_path, sources: dict) -> tcore.Context:
    """A Context whose package root is a throwaway package built from
    ``{relative path: source}``."""
    pkg = tmp_path / "fixture_pkg"
    for rel, src in sources.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tcore.Context(repo_root=str(tmp_path), package_root=str(pkg))


# -- framework against JAX ------------------------------------------------------

_FINDINGS = [
    dict(analyzer="collective-consistency", code="rank-guarded-collective",
         severity="CRITICAL", message="m", path="pkg/ops/halo.py", line=12, symbol="f",
         anchor="all_reduce", fix_hint="h"),
    dict(analyzer="knob-decl", code="undeclared-knob", severity="ERROR", message="m2",
         path="pkg/x.py", symbol="IGG_X", anchor="declare"),
    dict(analyzer="tune-cache-valid", code="stale-schema", severity="WARNING", message="m3",
         symbol="e.json", anchor="schema"),
    dict(analyzer="a", code="c", severity="INFO", message="m4"),
]


def test_findings_and_reports_equal_jax():
    for kw in _FINDINGS:
        t, j = tcore.Finding(**kw), jcore.Finding(**kw)
        assert t.fingerprint == j.fingerprint and t.to_dict() == j.to_dict()
        assert t.location == j.location
    moved = tcore.Finding(**{**_FINDINGS[0], "message": "reworded", "line": 99})
    assert moved.fingerprint == tcore.Finding(**_FINDINGS[0]).fingerprint
    with pytest.raises(ValueError, match="severity"):
        tcore.Finding(analyzer="a", code="c", severity="FATAL", message="m")
    for subset in ([], [0], [1], [2], [3], [2, 3], [0, 1, 2, 3]):
        for errors in ({}, {"a": "boom"}):
            tr = tcore.Report(findings=[tcore.Finding(**_FINDINGS[i]) for i in subset],
                              ran=["a"], errors=errors)
            jr = jcore.Report(findings=[jcore.Finding(**_FINDINGS[i]) for i in subset],
                              ran=["a"], errors=errors)
            for strict in (False, True):
                assert tr.exit_code(strict=strict) == jr.exit_code(strict=strict)
            assert tr.to_json() == jr.to_json() and tr.counts() == jr.counts()
    assert tcore.SEVERITIES == jcore.SEVERITIES and tcore.FAILING == jcore.FAILING


def _sarif_fixture_report(core):
    """JAX's SARIF fixture report (`tests/test_static_analysis.py`)."""
    dropper = core.Finding(
        analyzer="grad-soundness", code="cotangent-dropper", severity="CRITICAL",
        message="fixture: bitcast on the tangent path",
        path="implicitglobalgrid_tpu/ops/halo.py", line=12,
        symbol="exchange/porous", anchor="bitcast[f32]",
        fix_hint="wrap the transport in jax.custom_vjp",
    )
    cost = core.Finding(
        analyzer="hlo-cost", code="cost-regression", severity="ERROR",
        message="fixture: payload bytes doubled",
        symbol="exchange/porous[coalesce=True]", anchor="collective_payload_bytes",
    )
    suppressed = core.Finding(
        analyzer="knob-binding", code="env-read-in-trace", severity="WARNING",
        message="fixture: traced knob read", path="implicitglobalgrid_tpu/ops/halo.py",
        symbol="f", anchor="IGG_FIXTURE",
    )
    return core.Report(
        findings=[cost, dropper],
        suppressed=[(suppressed, "documented per-call contract")],
        ran=["grad-soundness", "hlo-cost", "knob-binding"],
        skipped=["knob-decl"],
    )


def test_sarif_equals_jax_apart_from_the_tool_name():
    got = tsarif.report_to_sarif(_sarif_fixture_report(tcore))
    want = jsarif.report_to_sarif(_sarif_fixture_report(jcore))
    assert got["runs"][0]["tool"]["driver"].pop("name") == tsarif.TOOL_NAME == "igg-lint-torch"
    assert want["runs"][0]["tool"]["driver"].pop("name") == "igg-lint"
    assert got == want
    with open(os.path.join(REPO, "tests", "data", "igg_lint_golden.sarif"),
              encoding="utf-8") as f:
        golden = json.load(f)
    golden["runs"][0]["tool"]["driver"].pop("name")
    assert got == golden


# -- collective-consistency: the rank-guard pass ----------------------------------

_GUARDED = """
    import torch.distributed as dist

    def exchange(x, rank):
        if rank == 0:
            dist.all_reduce(x)
        return x
"""

_CLEAN = """
    import torch.distributed as dist

    def exchange(x, rank):
        dist.all_reduce(x)            # every rank, unconditionally
        if rank == 0:
            x = x * 2                 # rank-dependent HOST math is fine
        if x.ndim == 3:
            dist.broadcast(x, src=0)  # a non-rank predicate is fine
        return x
"""


def test_rank_guard_pass_fires_on_guarded_collective(tmp_path):
    found = TC.ast_findings(_fixture_ctx(tmp_path, {"mod.py": _GUARDED}))
    assert [f.code for f in found] == ["rank-guarded-collective"]
    f = found[0]
    assert f.severity == "CRITICAL" and f.symbol == "exchange"
    assert f.anchor == "all_reduce" and "rank" in f.message


def test_rank_guard_pass_quiet_on_unconditional_collective(tmp_path):
    assert TC.ast_findings(_fixture_ctx(tmp_path, {"mod.py": _CLEAN})) == []


@pytest.mark.parametrize("src,anchor,term", [
    ("""
        import torch.distributed as dist

        def exchange(x, rank):
            if rank != 0:
                return x
            return dist.all_reduce(x)
     """, "all_reduce", "rank"),
    ("""
        def f(x, gg):
            return broadcast_control(x) if gg.coords[0] == 0 else x
     """, "broadcast_control", "coords"),
    ("""
        import torch.distributed as dist

        def f(A):
            while dist.get_rank() > 0:
                update_halo(A)
     """, "update_halo", "get_rank"),
    ("""
        import torch.distributed as dist

        def f(bufs, me):
            for b in bufs:
                if me == 1:
                    continue
                dist.isend(b, 1)
     """, "isend", "me"),
])
def test_rank_guard_pass_sees_early_exits_ternaries_and_calls(tmp_path, src, anchor, term):
    found = TC.ast_findings(_fixture_ctx(tmp_path, {"m.py": src}))
    assert [(f.code, f.anchor) for f in found] == [("rank-guarded-collective", anchor)]
    assert term in found[0].message


def test_rank_guard_pass_quiet_on_a_non_rank_early_exit(tmp_path):
    src = """
        import torch.distributed as dist

        def exchange(x):
            if x.ndim != 3:
                return x
            return dist.all_reduce(x)
    """
    assert TC.ast_findings(_fixture_ctx(tmp_path, {"q.py": src})) == []


# -- collective-consistency: the divergence detector --------------------------------

_SEQUENCES = [
    {0: (("a", 1), ("b", 2)), 1: (("a", 1), ("b", 2))},
    {0: (("a", 1), ("b", 2)), 1: (("a", 1), ("c", 2)), 2: (("a", 1),)},
    {0: (("a", 1),), 1: (("a", 1), ("b", 2))},
    {"r0": (), "r1": (("x",),)},
    {},
]


@pytest.mark.parametrize("seqs", _SEQUENCES)
def test_divergence_detector_gives_jax_verdicts(seqs):
    got = TC.check_rank_consistency(TC.RankCensus(name="host/x", sequences=seqs))
    want = JC.check_rank_consistency(JRankCensus(name="host/x", sequences=seqs))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


def test_host_plan_censuses_clean_and_a_rank_keyed_tune_lookup_caught():
    ctx = tcore.Context()
    names = [c.name for p in TC.CENSUS_PROVIDERS for c in p(ctx)]
    assert any(n.startswith("host/tune_resolve") for n in names)
    for prefix in ("host/supervisor_recovery", "host/fleet_plan", "host/integrity_plan"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert TC.host_plan_findings(ctx) == []
    # the tuner whose ranks each trust their own disk: rank 1's local hit
    # skips the measurement collectives rank 0 enters
    divergent = TC.RankCensus(
        name="host/tune_resolve[rank-keyed-lookup]",
        sequences={0: tt.control_plan(is_root=True, hit=False, n_measured=3),
                   1: tt.control_plan(is_root=False, hit=True, n_measured=0)},
    )
    (f,) = TC.check_rank_consistency(divergent)
    assert f.code == "rank-divergent-sequence" and f.severity == "CRITICAL"
    assert "hangs the fabric" in f.message
    # a registered provider feeds the same pipeline (the seeded fixture way)
    TC.register_census_provider(lambda ctx: [divergent])
    try:
        assert [f.code for f in TC.host_plan_findings(ctx)] == ["rank-divergent-sequence"]
    finally:
        TC.CENSUS_PROVIDERS.pop()


# -- knob-decl -------------------------------------------------------------------


def test_knob_decl_gives_jax_findings_on_one_fixture_tree(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "utils").mkdir(parents=True)
    (pkg / "utils" / "config.py").write_text('"""``IGG_A`` documented here."""\nIGG_A = 1\n'
                                             'IGG_C = 3\n')
    (pkg / "a.py").write_text('import os\nos.environ.get("IGG_A")\nos.environ.get("IGG_B")\n')
    (pkg / "b.py").write_text('K = "IGG_C"  # and IGG_B again\n')
    (tmp_path / "usage.md").write_text("| `IGG_B` | documented |\n")
    args = dict(repo=str(tmp_path), package=str(pkg), config=str(pkg / "utils" / "config.py"),
                usage=str(tmp_path / "usage.md"))
    got, want = tknobs.knob_decl_findings(**args), jknobs.knob_decl_findings(**args)
    assert [(f.code, f.symbol, f.path, f.fingerprint) for f in got] == \
        [(f.code, f.symbol, f.path, f.fingerprint) for f in want]
    assert {(f.code, f.symbol) for f in got} == {
        ("undeclared-knob", "IGG_B"), ("undocumented-knob", "IGG_A"),
        ("undocumented-knob", "IGG_C")}
    # the port's own documentation is config.py's docstring: IGG_A only
    got = tknobs.knob_decl_findings(**{**args, "usage": args["config"]})
    assert {(f.code, f.symbol) for f in got} == {
        ("undeclared-knob", "IGG_B"), ("undocumented-knob", "IGG_B"),
        ("undocumented-knob", "IGG_C")}


def test_knob_decl_clean_on_the_ports_tree():
    assert tknobs.run_knob_decl(tcore.Context()) == []
    refs = tknobs.referenced_knobs(REPO, os.path.join(REPO, "implicitglobalgrid_tpu_torch"),
                                   os.path.join(REPO, "implicitglobalgrid_tpu_torch", "utils",
                                                "config.py"))
    assert {"IGG_AUTOTUNE", "IGG_TUNE_CACHE", "IGG_TUNE_TOPK", "IGG_TUNE_STEPS"} <= set(refs)


# -- tune-cache-valid -----------------------------------------------------------------


def test_tune_cache_valid_fires_on_seeded_defects(tmp_path):
    from implicitglobalgrid_tpu_torch.analysis.tunecache import cache_findings

    d = str(tmp_path)
    key = tt.make_key("diffusion3d", (256, 256, 256), "float32", backend="cuda", topology="t")
    good = tt.new_entry(key, {"fused_k": 4}, source="test")
    doc = json.loads(json.dumps(good))
    doc["schema_version"] = 0
    json.dump(doc, open(os.path.join(d, tt.entry_filename(key)), "w"))  # stale schema
    open(os.path.join(d, "broken.json"), "w").write("{nope")  # corrupt
    # inadmissible: schema-valid and correctly filed, but no bz fits by=100
    key512 = tt.make_key("diffusion3d", (512, 512, 512), "float32", backend="cuda",
                         topology="t")
    bad = tt.new_entry(key512, {"fused_k": 4, "fused_tile": [100, 100]}, source="test")
    json.dump(bad, open(os.path.join(d, tt.entry_filename(key512)), "w"))
    json.dump(good, open(os.path.join(d, "drifted.json"), "w"))  # key drift
    found = cache_findings(d)
    assert sorted(f.code for f in found) == ["entry-corrupt", "inadmissible-config",
                                             "key-drift", "stale-schema"]
    assert all(f.severity == "ERROR" for f in found)
    # the diffusion cadence takes no coalesce; a porous key needs its npt
    assert tt.admissibility_error(key, {"coalesce": False})
    pkey = tt.make_key("porous_convection3d", (64, 64, 64), "float32", backend="cuda",
                       topology="t")
    assert "npt" in tt.admissibility_error(pkey, {"fused_k": 6})
    assert tt.admissibility_error({**pkey, "extra": {"npt": 12}}, {"fused_k": 6}) is None


def test_committed_seed_layer_is_clean_and_registered():
    from implicitglobalgrid_tpu_torch.analysis.tunecache import run

    assert "tune-cache-valid" in tanalysis.available_analyzers()
    assert run(tcore.Context()) == []
    for _path, doc in tt.TuneCache(primary=tt.SEED_DIR, fallbacks=()).entries():
        key, config = tt.validate_entry(doc)
        assert key["backend"] == "cuda" and doc["measured"]["t_step_s"] > 0


# -- the runner and the port's own tree ------------------------------------------


def test_runner_folds_findings_through_the_baseline(tmp_path, monkeypatch):
    mod = tmp_path / "igg_torch_fake_pass.py"
    mod.write_text(textwrap.dedent("""
        from implicitglobalgrid_tpu_torch.analysis.core import Finding

        def run(ctx):
            yield Finding(analyzer="fake", code="seeded", severity="ERROR",
                          message="seeded finding", symbol="s", anchor="a")
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    spec = tcore.AnalyzerSpec(name="fake", module="igg_torch_fake_pass", func="run",
                              title="fixture", paths=("implicitglobalgrid_tpu_torch/ops/**",))
    monkeypatch.setattr(tcore, "REGISTRY", {"fake": spec})
    report = tcore.run(baseline=None)
    assert report.exit_code() == 1 and report.ran == ["fake"]
    fp = report.findings[0].fingerprint
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [
        {"fingerprint": fp, "justification": "fixture contract"},
        {"fingerprint": "stale0000", "justification": "matches nothing"}]}))
    report = tcore.run(baseline=str(base))
    assert report.exit_code() == 0 and report.stale_suppressions == ["stale0000"]
    assert tcore.run(changed_paths=["README.md"], baseline=None).ran == []
    assert tcore.select_for_paths(["implicitglobalgrid_tpu_torch/ops/halo.py"]) == ["fake"]
    base.write_text(json.dumps({"suppressions": [{"fingerprint": fp, "justification": " "}]}))
    with pytest.raises(ValueError, match="justification"):
        tcore.Baseline.load(str(base))


def test_full_suite_runs_clean():
    report = tanalysis.run()
    assert report.findings == [] and not report.errors, report.human()
    assert report.ran == list(tcore.REGISTRY) == [
        "collective-consistency", "knob-decl", "tune-cache-valid"]
    assert report.stale_suppressions == [] and report.exit_code(strict=True) == 0
    for entry in tcore.Baseline.load(tanalysis.DEFAULT_BASELINE).suppressions.values():
        assert len(entry["justification"]) > 40  # a reason, not a mute
    assert tcore.select_for_paths(["implicitglobalgrid_tpu_torch/analysis/core.py"]) == \
        list(tcore.REGISTRY)
    assert tcore.select_for_paths(["implicitglobalgrid_tpu_torch/tuning/entries/x.json"]) == [
        "collective-consistency", "knob-decl", "tune-cache-valid"]


def test_cli_runs_clean_and_writes_sarif(tmp_path):
    sarif = tmp_path / "out.sarif"
    out = subprocess.run(
        [sys.executable, "-m", "implicitglobalgrid_tpu_torch.analysis", "--sarif", str(sarif)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "3 analyzer(s) ran — clean" in out.stdout
    doc = json.loads(sarif.read_text())
    assert doc["runs"][0]["tool"]["driver"]["name"] == "igg-lint-torch"
    assert doc["runs"][0]["results"] == []
    from implicitglobalgrid_tpu_torch.analysis.__main__ import main

    assert main(["--list"]) == 0
    with pytest.raises(SystemExit):
        main(["no-such-analyzer"])
