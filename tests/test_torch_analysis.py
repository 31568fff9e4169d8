"""The port's static-analysis suite (`implicitglobalgrid_tpu_torch.analysis`)
against the JAX package's `analysis`.

Held against JAX on the same inputs: `Finding` fingerprints and `Report`
exit codes and JSON; the SARIF export (apart from the tool's name, against
JAX's golden file too); the divergence detector's verdicts; knob-decl's
findings on one fixture tree; the gather-plan census and the collective
budget table.  The six twins of the JAX passes (stream-aliasing,
overlap-independence, collective-budget, perm-validity, grad-soundness,
ptxas-budget) each catch a seeded positive and are clean on the tree;
ptxas-budget's parser and comparison run on a recorded ``-Xptxas -v``
report, and it reports itself skipped where nothing was built (the seventh,
cost-model, has its own file, ``tests/test_torch_reconcile.py``).  Port
twins of JAX `tests/test_static_analysis.py`
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
    for prefix in ("host/supervisor_recovery", "host/fleet_plan", "host/integrity_plan",
                   "host/gather_chunked"):
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
        assert key["backend"] == "cuda"
        # a bench seed keeps its T_eff (JAX's porous seeds carry no step
        # time: the bench records none per npt); any other entry its step time
        if doc["source"].startswith("seed:bench_h100_"):
            assert doc["measured"]["teff_gbs"] > 0
        else:
            assert doc["measured"]["t_step_s"] > 0


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
    assert list(tcore.REGISTRY) == [
        "collective-consistency", "knob-decl", "tune-cache-valid", "stream-aliasing",
        "overlap-independence", "collective-budget", "perm-validity", "grad-soundness",
        "cost-model", "ptxas-budget", "bench-regression"]
    # without a kernel build (no nvcc) ptxas-budget skips itself, never "clean"
    assert report.ran == [n for n in tcore.REGISTRY if n not in report.skipped]
    assert sorted(report.ran + report.skipped) == sorted(tcore.REGISTRY)
    assert report.skipped in ([], ["ptxas-budget"])
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
    assert "10 analyzer(s) ran, 1 skipped — clean" in out.stdout
    assert "SKIPPED  analyzer ptxas-budget: no nvcc build report" in out.stdout
    doc = json.loads(sarif.read_text())
    assert doc["runs"][0]["tool"]["driver"]["name"] == "igg-lint-torch"
    assert doc["runs"][0]["results"] == []
    from implicitglobalgrid_tpu_torch.analysis.__main__ import main

    assert main(["--list"]) == 0
    with pytest.raises(SystemExit):
        main(["no-such-analyzer"])


# -- the twins of the JAX passes (leftover 12) -----------------------------------

def test_gather_plan_census_equals_jax():
    ctx = tcore.Context()
    got = {c.name: c.sequences for c in TC.gather_plan_censuses(ctx)}
    want = {c.name: c.sequences for c in JC.gather_plan_censuses(None)}
    assert got == want and len(got) == 4
    assert [f for c in TC.gather_plan_censuses(ctx) for f in TC.check_rank_consistency(c)] == []


def _source(obj):
    import inspect

    return inspect.getsource(obj)


_RECORD = "            for t in (*c, *b_out):\n                t.record_stream(mid)\n"
_WAIT = "            mid.wait_stream(main)\n"
_LAUNCH_STREAM = "stream = torch.cuda.current_stream(T.device).cuda_stream"


@pytest.mark.parametrize("rel,edit,want", [
    ("models/_fused.py", lambda s: s.replace(_RECORD, ""),
     [("missing-record-stream", "mid:b_out"), ("missing-record-stream", "mid:c")]),
    ("models/_fused.py", lambda s: s.replace(_WAIT, ""), [("unordered-stream-launch", "mid")]),
    ("ops/halo.py", lambda s: s.replace("        for A in fields:\n            A.record_stream(comm)\n",
                                        ""),
     [("missing-record-stream", "comm:fields")]),
    ("ops/fused_stencil.py", lambda s: s.replace(_LAUNCH_STREAM, "stream = side.cuda_stream"),
     [("carry-in-off-stream", "carry_in")]),
])
def test_stream_aliasing_catches_seeded_fixtures(tmp_path, rel, edit, want):
    from implicitglobalgrid_tpu_torch.analysis import aliasing

    src = open(os.path.join(REPO, "implicitglobalgrid_tpu_torch", rel)).read()
    bad = edit(src)
    assert bad != src
    clean = aliasing.run(_fixture_ctx(tmp_path / "a", {rel: src}))
    found = aliasing.run(_fixture_ctx(tmp_path / "b", {rel: bad}))
    assert clean == []
    assert [(f.code, f.anchor) for f in found] == want
    assert all(f.severity == "ERROR" and f.path.endswith(rel) for f in found)


def test_stream_aliasing_clean_on_the_tree():
    from implicitglobalgrid_tpu_torch.analysis import aliasing

    assert aliasing.run(tcore.Context()) == []


def _pipelined_variant(edit):
    from implicitglobalgrid_tpu_torch.models import _fused

    src = textwrap.dedent(_source(_fused.run_pipelined_group_schedule))
    bad = edit(src)
    assert bad != src
    ns = dict(_fused.__dict__)
    exec(compile(bad, "<fixture>", "exec"), ns)
    return ns["run_pipelined_group_schedule"]


_BEGIN = ("            pend = begin_slab_exchange(b_out, (0, 1), width=width, lead=lead, "
          "coalesce=coalesce)\n")


@pytest.mark.parametrize("edit,codes", [
    # a stray wait of the mid stream after the exchange began
    (lambda s: s.replace(_BEGIN + "            main.wait_stream(mid)\n",
                         "            main.wait_stream(mid)\n").replace(
        _RECORD, _RECORD + _BEGIN + _WAIT),
     ["mid-waits-for-exchange", "mid-waits-for-ring"] * 2),
    # the compute stream never joins the mid pass before the planes land
    (lambda s: s.replace("            main.wait_stream(mid)\n", ""), ["finish-before-join"] * 2),
    # the mid pass forks before the group's input is ready
    (lambda s: s.replace(_WAIT, "", 1), ["mid-before-input"] * 2),
])
def test_overlap_independence_catches_seeded_schedules(edit, codes):
    from implicitglobalgrid_tpu_torch.analysis import overlap

    found = overlap.overlap_findings(_pipelined_variant(edit))
    assert [f.code for f in found] == codes
    assert [f.anchor.split("@")[1] for f in found] == [str(1 + i * 2 // len(codes))
                                                     for i in range(len(codes))]


def test_overlap_independence_clean_and_its_recording():
    from implicitglobalgrid_tpu_torch.analysis import overlap
    from implicitglobalgrid_tpu_torch.models import _fused

    assert overlap.run(None) == []
    rec = overlap.drive(_fused.run_pipelined_group_schedule, groups=1)
    ops = [(label, stream) for label, stream, _ in rec.ops if not label.startswith("record")]
    assert ops == [("input", "main"), ("ring", "main"), ("mid", "mid"), ("exchange", "main"),
                   ("finish", "main")]
    assert {label for label, stream, _ in rec.ops if label.startswith("record")} == {
        "record f0", "record f1", "record ring0", "record ring1"}


def test_collective_budget_table_is_jax_s_and_the_tree_is_clean():
    from implicitglobalgrid_tpu.analysis import budget as jbudget
    from implicitglobalgrid_tpu_torch.analysis import budget

    assert budget.BUDGET_PAIRS == jbudget.BUDGET_PAIRS
    assert budget.BATCHED_CENSUS_B == jbudget.BATCHED_CENSUS_B
    assert budget.run(None) == []


def test_collective_budget_catches_per_field_hops(monkeypatch):
    from implicitglobalgrid_tpu_torch.analysis import budget
    from implicitglobalgrid_tpu_torch.ops import halo

    # the coalesced exchange forced to one message per field
    monkeypatch.setattr(halo, "resolve_coalesce", lambda coalesce: False)
    found = budget.run(None)
    assert sorted({f.code for f in found}) == ["budget-exceeded"]
    assert [f.symbol for f in found] == [f"{m}/dim{d}" for m in ("acoustic", "porous")
                                         for d in range(3)]
    assert [f.anchor for f in found] == ["16"] * 3 + ["20"] * 3


def test_perm_validity_clean_and_a_duplicated_target_caught():
    from implicitglobalgrid_tpu_torch.analysis import perms
    from implicitglobalgrid_tpu_torch.parallel import topology

    assert perms.run(None) == []
    census = perms.message_census((3, 1, 1), (1, 0, 0))
    assert sorted(census) == [(0, 0), (0, 1)]
    assert sorted(r for kind, r, _ in census[(0, 0)] if kind == "send") == [0, 1, 2]

    def duplicated(coords, dims, periods, disp=1):
        table = topology.neighbors_table(coords, dims, periods, disp)
        if coords[0] == 2:
            table[0, 0] = 0  # rank 2's lower partner: rank 0, already rank 1's
        return table

    found = perms.perm_findings(perms.message_census((3, 1, 1), (0, 0, 0), table=duplicated),
                                "fixture", 3)
    assert [(f.code, f.anchor) for f in found] == [
        ("malformed-permute", "dim0-tag0-perm"), ("unmatched-message", "dim0-tag0-match"),
        ("unmatched-message", "dim0-tag1-match")]
    assert all(f.severity == "CRITICAL" for f in found)


def test_grad_soundness_clean_on_every_entry():
    from implicitglobalgrid_tpu_torch.analysis import gradflow

    names = [name for name, _, _ in gradflow.grad_entries()]
    assert len(names) == 6 and gradflow.run(None) == []


def test_grad_soundness_catches_a_detached_exchange_and_input(monkeypatch):
    from implicitglobalgrid_tpu_torch.analysis import gradflow
    from implicitglobalgrid_tpu_torch.ops import halo

    entry = next(iter(gradflow.grad_entries()))

    def detached(fields, width, lead, coalesce, col=None):
        # the received planes land as constants: no _Exchange, no adjoint
        halo._exchange_fields(fields, width, lead, coalesce, col)
        return tuple(fields)

    with monkeypatch.context() as m:
        m.setattr(halo, "_exchange", detached)
        (f,) = gradflow.grad_findings([entry])
    assert (f.code, f.severity, f.symbol) == (
        "cotangent-sink", "CRITICAL", "exchange/diffusion[coalesce=True]")

    def cut(build):
        def fixture():
            fn, inputs = build()
            return (lambda *x: fn(x[0].detach() * 1, *x[1:])), inputs
        return fixture

    name, grid, build = list(gradflow.grad_entries())[1]  # acoustic: P, Vx, Vy, Vz
    found = gradflow.grad_findings([(name, grid, cut(build))])
    assert [(f.code, f.anchor) for f in found] == [("detached-input", "input0")]


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4c9cabed_11_fused_pt_cu_3000687615fused_pt_kernelIdLb1EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__4c9cabed_11_fused_pt_cu_3000687615fused_pt_kernelIdLb1EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compile time = 175.507 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4c9cabed_11_fused_pt_cu_3000687615fused_pt_kernelIdLb0EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__4c9cabed_11_fused_pt_cu_3000687615fused_pt_kernelIdLb0EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compile time = 165.116 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4c9cabed_11_fused_pt_cu_3000687615fused_pt_kernelIfLb1EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__4c9cabed_11_fused_pt_cu_3000687615fused_pt_kernelIfLb1EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compile time = 187.409 ms
"""
"""The fused_pt.cu part of a chip_smoke.py phase 1 log (NVIDIA H100 80GB
HBM3), three of its four entries."""

_PT_D1 = "_ZN15fused_pt_kernelIdLb1EEEvPKT_S3_S3_S3_PS1_S4_S4_S4_iiiiNS_2PtIS1_EEiiii"


def test_ptxas_parser_on_a_recorded_report():
    from implicitglobalgrid_tpu_torch.analysis import ptxas

    got = ptxas.parse_report(_PTXAS_LOG)
    assert list(got) == [_PT_D1, _PT_D1.replace("IdLb1", "IdLb0"),
                         _PT_D1.replace("IdLb1", "IfLb1")]
    assert got[_PT_D1] == {"registers": 128, "spill_stores": 0, "spill_loads": 0,
                           "stack_bytes": 0, "smem_bytes": 0}
    assert got[_PT_D1.replace("IdLb1", "IdLb0")]["registers"] == 127
    spilled = ptxas.parse_report(_PTXAS_LOG.replace(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\nptxas info    : "
        "Used 127 registers, used 1 barriers",
        "16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\nptxas info    : "
        "Used 255 registers, used 1 barriers, 1024 bytes smem"))
    assert spilled[_PT_D1.replace("IdLb1", "IdLb0")] == {
        "registers": 255, "spill_stores": 8, "spill_loads": 12, "stack_bytes": 16,
        "smem_bytes": 1024}
    # the committed baseline holds these entries with these numbers
    base = ptxas.load_baseline()
    assert {k: base["kernels"]["fused_pt"][k] for k in got} == got
    assert sorted(base["kernels"]) == ptxas.sources() == [
        "diffusion_update", "fused_diffusion", "fused_leapfrog", "fused_pt", "temperature_update"]
    assert all(len(base["justifications"][f"{s}::{e}"]) > 40
               for s, es in base["kernels"].items() for e in es)


@pytest.mark.parametrize("edit,want", [
    (lambda c: c, []),
    (lambda c: {**c, _PT_D1: {**c[_PT_D1], "registers": 136}}, [("registers-change", _PT_D1)]),
    (lambda c: {**c, _PT_D1: {**c[_PT_D1], "spill_stores": 4}}, [("spill-change", _PT_D1)]),
    (lambda c: {k: v for k, v in c.items() if k != _PT_D1}, [("entry-lost", _PT_D1)]),
    (lambda c: {**c, "_ZN15new_kernel": dict(c[_PT_D1])}, [("entry-unbaselined",
                                                            "_ZN15new_kernel")]),
])
def test_ptxas_comparison_is_exact(edit, want):
    from implicitglobalgrid_tpu_torch.analysis import ptxas

    base = {"version": 1, "kernels": {"fused_pt": ptxas.parse_report(_PTXAS_LOG)}}
    found = ptxas.compare({"fused_pt": edit(ptxas.parse_report(_PTXAS_LOG))}, base)
    assert [(f.code, f.symbol.split("::")[1]) for f in found] == want
    assert all(f.severity == "ERROR" for f in found)


def test_ptxas_budget_skips_without_a_build_and_refresh_keeps_the_contract(
        tmp_path, monkeypatch, capsys):
    from implicitglobalgrid_tpu_torch.analysis import ptxas
    from implicitglobalgrid_tpu_torch.analysis.__main__ import main
    from implicitglobalgrid_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "build_log", lambda name: None)
    report = tcore.run(["ptxas-budget"], baseline=None)
    assert report.ran == [] and report.skipped == ["ptxas-budget"] and report.exit_code() == 0
    assert "no nvcc build report" in report.stats["ptxas-budget"]["skipped"]
    assert "SKIPPED  analyzer ptxas-budget" in report.human()
    # refresh: built reports stand in for nvcc's
    monkeypatch.setattr(_kernels, "build", lambda name: None)
    monkeypatch.setattr(_kernels, "build_log", lambda name: _PTXAS_LOG.replace(
        "fused_pt", name) if name == "fused_pt" else "")
    out = tmp_path / "ptxas_baseline.json"
    assert main(["refresh", "--out", str(out)]) == 1  # new entries need a justification
    assert not out.exists()
    assert main(["refresh", "--dry-run", "--out", str(out)]) == 0
    assert main(["refresh", "--out", str(out), "--justify-all", "fixture: first pin"]) == 0
    doc = json.loads(out.read_text())
    assert doc["kernels"]["fused_pt"] == ptxas.parse_report(_PTXAS_LOG)
    assert set(doc["justifications"].values()) == {"fixture: first pin"}
    assert main(["refresh", "--out", str(out)]) == 0  # unchanged: nothing to justify
    assert "nothing to refresh" in capsys.readouterr().out
    key = f"fused_pt::{_PT_D1}"
    monkeypatch.setattr(_kernels, "build_log", lambda name: _PTXAS_LOG.replace(
        "Used 128 registers", "Used 130 registers", 1) if name == "fused_pt" else "")
    assert main(["refresh", "--out", str(out)]) == 1
    assert main(["refresh", "--out", str(out), "--justify", f"{key}=fixture: +2"]) == 0
    doc = json.loads(out.read_text())
    assert doc["kernels"]["fused_pt"][_PT_D1]["registers"] == 130
    assert doc["justifications"][key] == "fixture: +2"
