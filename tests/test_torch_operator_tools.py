"""The port's trace CLI and cluster view (`implicitglobalgrid_tpu_torch.scripts.igg_trace`,
`.igg_top`) against the JAX package's ``scripts/igg_trace.py`` and
``scripts/igg_top.py`` on the same inputs, and the kernel build's
temporary-file hygiene (`ops._kernels.build`).

* igg_trace: ``merge`` (files, a directory, ``--per-epoch``, refusals),
  ``validate`` (clean and broken), ``summarize``, ``request`` (tree,
  critical path, ``-o`` and ``--otlp`` files, an unknown id) and
  ``export``: the same exit codes, standard output and written documents.
* igg_top: one view over two fixed ranks served on loopback (expositions
  and health documents), one unreachable endpoint, ``--prom`` and
  ``--json``: the same exit codes, output and merged exposition; the pure
  functions on the same inputs.
* ``_kernels.build`` with ``nvcc`` missing, failing or succeeding leaves no
  temporary file in its build directory.

The JAX scripts are loaded from their files with `importlib`.
"""

import contextlib
import importlib.util
import io
import json
import stat
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from implicitglobalgrid_tpu_torch.ops import _kernels
from implicitglobalgrid_tpu_torch.scripts import igg_top, igg_trace
from implicitglobalgrid_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parent.parent
TID = "ab" * 16
REQ, SUB, ADM, ADN = "aa" * 8, "bb" * 8, "cc" * 8, "dd" * 8


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTRACE = _load_script("igg_trace")
JTOP = _load_script("igg_top")


def _cli(main, argv):
    """``(exit code, stdout, stderr)`` of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv_of, tmp_path):
    """Run the port's and the JAX CLI on ``argv_of(out_dir)``; every output
    path goes into its own directory, so written files compare too."""
    res = {}
    for tag, mod in (("port", igg_trace), ("jax", JTRACE)):
        d = tmp_path / f"out_{tag}"
        d.mkdir(exist_ok=True)
        rc, out, err = _cli(mod.main, argv_of(d))
        res[tag] = (rc, out.replace(str(d), "OUT"), err.replace(str(d), "OUT"),
                    {p.name: p.read_bytes() for p in sorted(d.iterdir())})
    return res["port"], res["jax"]


# -- igg_trace -------------------------------------------------------------------------


def _rank_doc(rank, *, perf0, wall, spans, barrier=True, epoch=1, gen=None):
    return {
        "schema": tracing.TRACE_SCHEMA, "rank": rank, "pid": 1000 + rank, "gen": gen,
        "dropped": 0, "coords": [rank, 0, 0],
        "clock_sync": {"wall": wall, "perf": perf0, "uncertainty_s": 1e-4, "epoch": epoch,
                       "barrier": barrier},
        "spans": spans,
    }


def _step_spans(t0, n, seed):
    import random

    rng = random.Random(seed)
    return [{"name": name, "t0": t0 + i + rng.random() * 0.1, "dur": 0.01 + rng.random() * 0.2,
             "args": {"step": i + 1}}
            for i in range(n) for name in ("igg.step", "igg_halo_exchange")]


def _write(d, doc, name=None):
    d.mkdir(parents=True, exist_ok=True)
    path = d / (name or tracing.trace_filename(doc["rank"], generation=doc.get("gen")))
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture
def run_dir(tmp_path):
    d = tmp_path / "run"
    _write(d, _rank_doc(0, perf0=100.0, wall=1_000_000.0, spans=_step_spans(101.0, 4, 0)))
    _write(d, _rank_doc(1, perf0=50.0, wall=1_000_000.02, spans=_step_spans(51.0, 4, 1)))
    return d


@pytest.mark.parametrize("case", ["dir", "files", "stdout", "per_epoch", "mismatched", "empty"])
def test_igg_trace_merge_equals_jax(tmp_path, run_dir, case):
    if case == "per_epoch":
        for gen in (0, 1):
            _write(run_dir, _rank_doc(0, perf0=10.0 * gen, wall=2e6 + gen, epoch=gen + 2,
                                      gen=gen, spans=_step_spans(10.0 * gen + 1, 2, gen)))
    if case == "mismatched":
        _write(run_dir, _rank_doc(1, perf0=50.0, wall=1_000_100.0, spans=_step_spans(51, 2, 2)))
    if case == "empty":
        (tmp_path / "empty").mkdir()
    inputs = {"dir": [str(run_dir)], "stdout": [str(run_dir)], "per_epoch": [str(run_dir)],
              "files": sorted(str(p) for p in run_dir.glob("trace.p*.json")),
              "mismatched": [str(run_dir)], "empty": [str(tmp_path / "empty")]}[case]
    extra = ["--per-epoch"] if case == "per_epoch" else []

    def argv(d):
        return ["merge", *inputs, *extra, "-o", "-" if case == "stdout" else str(d / "m.json")]

    port, jax = _both(argv, tmp_path)
    assert port == jax
    assert port[0] == {"dir": 0, "files": 0, "stdout": 0, "per_epoch": 0, "mismatched": 2,
                       "empty": 2}[case]
    if port[0] == 0:
        doc = json.loads(port[3]["m.json"] if case != "stdout" else port[1])
        assert tracing.validate_chrome_trace(doc) == []


def test_igg_trace_validate_equals_jax(tmp_path, run_dir):
    merged = tmp_path / "merged.json"
    assert _cli(igg_trace.main, ["merge", str(run_dir), "-o", str(merged)])[0] == 0
    broken = tmp_path / "broken.json"
    doc = json.loads(merged.read_text())
    doc["traceEvents"][0].pop("ph")
    doc["traceEvents"][1]["dur"] = -1
    broken.write_text(json.dumps(doc))
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    for path, want in ((merged, 0), (broken, 1), (garbage, 2), (tmp_path / "missing", 2)):
        port, jax = _both(lambda d: ["validate", str(path)], tmp_path)
        assert port == jax and port[0] == want, path.name


def test_igg_trace_summarize_equals_jax(tmp_path, run_dir):
    for extra in ([], ["--json"]):
        port, jax = _both(lambda d: ["summarize", str(run_dir), *extra], tmp_path)
        assert port == jax and port[0] == 0
    assert "igg.step" in port[1]


def _fixture_dir(tmp_path):
    """Two dumps of one request (the door's, the pool's): the fixture of
    ``tests/test_torch_tracing.py``."""
    door = _rank_doc(0, perf0=100.0, wall=1000.0, barrier=False, spans=[
        {"name": "igg.frontdoor.submit", "t0": 100.0, "dur": 0.5,
         "args": {"trace_id": TID, "span_id": SUB, "parent_id": REQ, "request": "r000000"}},
        {"name": "igg.serving.admission", "t0": 100.0, "dur": 1.0,
         "args": {"trace_id": TID, "span_id": ADN, "parent_id": REQ, "tenant": "tA"}},
        {"name": "igg.frontdoor.admit", "t0": 100.0, "dur": 4.0,
         "args": {"trace_id": TID, "span_id": ADM, "parent_id": REQ, "request": "r000000"}},
        {"name": "igg.frontdoor.request", "t0": 100.0, "dur": 10.0,
         "args": {"trace_id": TID, "span_id": REQ, "request": "r000000", "tenant": "tA",
                  "result": "completed"}},
    ])
    pool = _rank_doc(1, perf0=500.0, wall=1000.0, barrier=False, gen=0, spans=[
        {"name": "igg.serving.round", "t0": 504.0, "dur": 5.0,
         "args": {"round": 3, "trace_ids": [TID],
                  "members": [{"member": 0, "slot": 0, "tenant": "tA",
                               "trace": {"trace_id": TID, "span_id": ADM}}]}},
        {"name": "igg_halo_exchange", "t0": 506.0, "dur": 2.0, "args": {"trace_ids": [TID]}},
    ])
    d = tmp_path / "req"
    _write(d, door)
    _write(d, pool)
    return d


@pytest.mark.parametrize("trace_id", [TID, "99" * 16])
def test_igg_trace_request_equals_jax(tmp_path, trace_id):
    d = _fixture_dir(tmp_path)
    port, jax = _both(lambda o: ["request", trace_id, str(d), "-o", str(o / "view.json"),
                                 "--otlp", str(o / "req.otlp.json")], tmp_path)
    assert port == jax
    if trace_id == TID:
        assert port[0] == 0 and set(port[3]) == {"view.json", "req.otlp.json"}
        assert "critical path: total 10000.000ms" in port[1]
    else:
        assert port[0] == 2 and not port[3]


@pytest.mark.parametrize("trace_id", [None, TID])
def test_igg_trace_export_equals_jax(tmp_path, trace_id):
    d = _fixture_dir(tmp_path)
    extra = [] if trace_id is None else ["--trace-id", trace_id]
    port, jax = _both(lambda o: ["export", str(d), "--otlp", "-o", str(o / "spans.json"),
                                 *extra], tmp_path)
    assert port == jax and port[0] == 0
    assert tracing.validate_otlp(json.loads(port[3]["spans.json"])) == []
    stdout = _both(lambda o: ["export", str(d), *extra], tmp_path)
    assert stdout[0] == stdout[1] and stdout[0][0] == 0


# -- igg_top ---------------------------------------------------------------------------


PROM = {
    0: "# TYPE igg_diffusion3d_steps_total counter\nigg_diffusion3d_steps_total 12\n"
       "# TYPE igg_halo_bytes gauge\nigg_halo_bytes{dim=\"x\"} 4096\n",
    1: "# TYPE igg_diffusion3d_steps_total counter\nigg_diffusion3d_steps_total 11\n"
       "# TYPE igg_frontdoor_rejected_slo counter\nigg_frontdoor_rejected_slo 3\n",
}
HEALTH = {
    0: {"rank": 0, "ok": True, "coords": [0, 0, 0], "last_step": {"step": 12, "age_s": 0.25},
        "slo": {"slo.diffusion3d.step_seconds": {"p50": 0.0012, "p99": 0.0031},
                "slo.diffusion3d.t_eff_gbs": {"p50": 812.5}},
        "skew": {"step_seconds_max_over_min": 1.07}, "alerts": {"active": []}},
    1: {"rank": 1, "ok": False, "coords": [1, 0, 0], "last_step": {"step": 11, "age_s": 3.5},
        "slo": {"slo.serving.round_seconds": {"p50": 0.002, "p99": 0.009}},
        "serving": {"queue_depth": 4, "active_members": 2, "capacity": 4,
                    "oldest_request_age_s": 1.5},
        "frontdoor": {"admitted_total": 30, "rejected_total": 10,
                      "tenants": {"tA": {"rejected": 2}, "tB": {"rejected": 8}}},
        "alerts": {"active": [{"rule": "step_stall", "severity": "critical"}]}},
}


@pytest.fixture
def ranks():
    """Two loopback endpoints serving the fixed rank documents."""
    servers = []
    for rank in (0, 1):
        class Handler(BaseHTTPRequestHandler):
            r = rank

            def do_GET(self):  # noqa: N802
                body = (json.dumps(HEALTH[self.r]) if self.path == "/healthz"
                        else PROM[self.r]).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    yield [f"127.0.0.1:{s.server_address[1]}" for s in servers]
    for s in servers:
        s.shutdown()
        s.server_close()


def _dead_endpoint():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.mark.parametrize("case", ["two_ranks", "dir", "unreachable", "no_endpoints"])
def test_igg_top_one_view_equals_jax(tmp_path, monkeypatch, ranks, case):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")
    endpoints = list(ranks)
    if case == "unreachable":
        endpoints.append(_dead_endpoint())
    args = {"two_ranks": endpoints, "unreachable": [*endpoints, "--retries", "0"],
            "no_endpoints": [], "dir": ["--dir", str(tmp_path / "tele")]}[case]
    if case == "dir":
        (tmp_path / "tele").mkdir()
        for rank, ep in enumerate(ranks):
            host, port = ep.split(":")
            (tmp_path / "tele" / f"liveplane.p{rank}.json").write_text(
                json.dumps({"rank": rank, "host": host, "port": int(port)}))
    got = {}
    for tag, mod in (("port", igg_top), ("jax", JTOP)):
        prom = tmp_path / f"{tag}.prom"
        extra = [] if case == "no_endpoints" else ["--prom", str(prom), "--json"]
        rc, out, err = _cli(mod.main, [*args, *extra])
        got[tag] = (rc, out, err.replace(str(prom), "PROM"),
                    prom.read_text() if prom.exists() else None)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"two_ranks": 0, "dir": 0, "unreachable": 1, "no_endpoints": 2}[case]
    if case == "two_ranks":
        assert 'rank="1"' in got["port"][3] and "step_stall(critical)" in got["port"][1]


def test_igg_top_functions_equal_jax():
    assert igg_top.merge_expositions(PROM) == JTOP.merge_expositions(PROM)
    rows = igg_top.summary_rows(HEALTH)
    assert rows == JTOP.summary_rows(HEALTH)
    assert igg_top.render_table(rows) == JTOP.render_table(rows)
    assert len(rows) == 2 and rows[1]["reject"] == "25%(tB)" and rows[1]["members"] == "2/4"


# -- the kernel build leaves no temporary file -----------------------------------------


@pytest.fixture(autouse=True)
def _private_build_records(monkeypatch):
    """A build here must not leave its (fake) report in the module's
    records, where other tests of the process would read it."""
    monkeypatch.setattr(_kernels, "build_logs", {})
    monkeypatch.setattr(_kernels, "build_seconds", {})


def _listing(d: Path):
    return sorted(p.name for p in d.iterdir()) if d.exists() else None


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


@pytest.mark.parametrize("build_dir_exists", [False, True])
def test_build_without_nvcc_leaves_the_build_dir_as_it_was(tmp_path, monkeypatch,
                                                           build_dir_exists):
    build = tmp_path / "_build"
    if build_dir_exists:
        build.mkdir()
        (build / "libother_0123.so").write_bytes(b"x")
    before = _listing(build)
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build("fused_diffusion")
    assert _listing(build) == before


def test_failing_nvcc_leaves_no_temporary_file(tmp_path, monkeypatch):
    build = tmp_path / "_build"
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    monkeypatch.setattr(_kernels, "nvcc_path",
                        lambda: _fake_nvcc(tmp_path, "echo 'error: no card' >&2\nexit 3\n"))
    with pytest.raises(RuntimeError, match=r"nvcc failed to build fused_pt.cu \(exit 3\)"):
        _kernels.build("fused_pt")
    assert _listing(build) == []


def test_succeeding_build_publishes_only_the_library_and_its_log(tmp_path, monkeypatch):
    build = tmp_path / "_build"
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    # the fake compiler writes its -o argument and a ptxas-like report
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo lib > "$2"\necho "ptxas info : Used 40 registers"\n')
    monkeypatch.setattr(_kernels, "nvcc_path", lambda: nvcc)
    out = _kernels.build("fused_leapfrog")
    assert out == _kernels.library_path("fused_leapfrog")
    assert _listing(build) == sorted([out.name, out.with_suffix(".log").name])
    assert "40 registers" in out.with_suffix(".log").read_text()
    assert _kernels.build("fused_leapfrog") == out  # built once: the hash names it
