"""Device-timeline profiling: windowed capture, per-scope attribution,
measured comm/compute overlap, cross-run drift diffing.

The port's copy of the JAX package's ``utils/profiling.py`` over
`torch.profiler` in place of `jax.profiler`.

* **Capture.** ``IGG_PROFILE=steps:A-B`` arms a `torch.profiler.profile`
  session around time-loop steps A..B of the next instrumented run
  (`ProfileCapture`, armed by `telemetry._StepLoop` through `maybe_arm`).
  The activities are the CPU, plus CUDA when the grid's device is a CUDA
  device.  The device is synchronised at both edges of the window, so the
  capture holds exactly the window's device work.  Output is per rank:
  the Chrome trace ``profile.p<rank>/igg.p<rank>.<pid>.<ns>.trace.json``
  under ``IGG_PROFILE_DIR`` (else ``IGG_TELEMETRY_DIR``) and the capture
  meta ``profile.p<rank>.json`` (window, the host perf instants of its
  edges and of the capture's anchor, trace path, attribution).  Every
  failure (no directory, a start, stop or export error, an unparseable
  trace) becomes one structured ``profile.capture_failed`` event and the
  run goes on; a window still open when the guarded loop exits (a guard
  trip, an injected crash) is stopped by its exit path
  (`close_open_capture`), so the bytes already captured land.
* **Scopes.** The port opens `torch.profiler.record_function` ranges named
  as the JAX package's ``named_scope``s (`SCOPE_NAMES`: the exchanges in
  `ops.halo`, the ring and interior passes in `models._fused`), the plain
  updates ``igg_temperature_update`` (porous) and ``igg_diffusion_update``,
  and ``igg_step[<model>]`` around each guarded-loop call, only while a
  capture is live (`scope`: one module bool read otherwise).  A
  `tracing.trace_span` opens a range of its own name too while a capture is
  live, so the exchanges name their work once, as ring spans.  The
  profiler turns a range into ``gpu_user_annotation`` events on each CUDA
  stream it launched work on, spanning that work.  Every capture opens one
  ``igg_capture_anchor`` range (`ANCHOR`) right after the profiler starts
  (behind one ``igg_capture_anchor_warmup`` range, which takes the
  session's set-up out of the anchor's duration) and takes the host
  ``perf_counter`` instant inside it: the windowed capture's meta records
  it as ``anchor_perf``, `profile_trace` writes it beside the trace
  (``<trace stem>.anchor.json``).
* **Attribution.** `device_ops` keeps the device work of a torch Chrome
  trace: the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events
  (`DEVICE_CATEGORIES`).  An op belongs to a scope when a
  ``gpu_user_annotation`` range of that name CONTAINS it on its own stream
  (same pid and tid); the innermost such range wins (`scope_of`).  Ops
  outside every scope fall into the ``collectives`` / ``kernels`` /
  ``glue`` buckets of `op_kind`'s name vocabulary.  The measured overlap
  fraction is |union(collective) ∩ union(kernel)| / |union(collective)| per
  device, ``None`` when the capture holds no collective (every one-card
  capture).
* **Join and diff.** `attach_device_tracks` adds each rank's device ops to
  `tracing.merge_trace_files` output on the rank's pid, placed by the
  capture's anchor range (its trace ``ts`` against its ``perf_counter``
  instant), to within the anchor's own duration; `attribution_delta`
  names the scope a cross-run regression went to.  ``python -m
  implicitglobalgrid_tpu_torch.utils.profiling attribute|diff`` is the
  command line (`main`).

Module scope imports only the standard library and the port's `config` and
`telemetry`; torch is reached inside the capture, so the parser and the
diff run anywhere.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from typing import Any, Sequence

from . import config as _config
from . import telemetry as _telemetry

__all__ = [
    "SCOPE_NAMES",
    "ANCHOR",
    "parse_profile_window",
    "ProfileCapture",
    "maybe_arm",
    "active_capture",
    "close_open_capture",
    "profile_trace",
    "scope",
    "profile_meta_filename",
    "load_trace",
    "find_trace_files",
    "device_ops",
    "capture_anchor",
    "attribute_trace",
    "attribute_capture",
    "attribution_delta",
    "render_attribution_table",
    "render_delta_table",
    "publish_attribution",
    "attach_device_tracks",
    "find_capture_metas",
    "resolve_trace_path",
    "reset",
]

#: capture meta / attribution record schema version
PROFILE_SCHEMA = 1

#: The scope namespace, the JAX package's ``named_scope`` names: device ops
#: inside a range of one of these names attribute to it.
SCOPE_NAMES = (
    "igg_ring_pass",
    "igg_interior_pass",
    "igg_slab_exchange_begin",
    "igg_slab_exchange_finish",
    "igg_halo_exchange",
    "igg_temperature_update",
    "igg_diffusion_update",
)

#: The range every capture opens right after the profiler starts: its
#: ``ts`` on the trace's clock and the host ``perf_counter`` instant taken
#: inside it tie the two clocks together (`attach_device_tracks`).
ANCHOR = "igg_capture_anchor"

#: Chrome-trace categories of device work in a torch capture.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: category of a record-function range's extent on a CUDA stream
ANNOTATION_CATEGORY = "gpu_user_annotation"

#: The op-name vocabulary (the counterpart of the JAX package's
#: `hlo_analysis.classify_op_name`, which reads XLA op names): a kernel
#: whose name holds one of `COLLECTIVE_MARKS` moves data between devices;
#: memcpy and memset events and the kernels whose names hold one of
#: `GLUE_MARKS` (torch's copy and fill kernels, what a strided slab copy
#: runs) are glue; every other kernel is compute (the port's
#: ``fused_*_kernel``s and torch's elementwise kernels, the counterparts of
#: XLA's fusions).  Matched lower-case.
COLLECTIVE_MARKS = ("nccl",)
GLUE_MARKS = ("copy", "fill")

#: µs of slack in the containment test (the exporter rounds to ns)
_CONTAIN_TOL_US = 0.01


def profile_meta_filename(rank: int) -> str:
    return f"profile.p{rank}.json"


# -- window spec --------------------------------------------------------------


def parse_profile_window(spec: str) -> tuple[int, int]:
    """``IGG_PROFILE`` grammar -> ``(start_step, stop_step)``, 1-based
    inclusive.

    ``steps:A-B`` captures time-loop steps A..B; ``steps:N`` is shorthand
    for ``steps:1-N``.  Error messages follow the config contract (name
    the variable, the accepted format and the obtained value).
    """
    err = ValueError(
        f"Environment variable IGG_PROFILE must be 'steps:A-B' or "
        f"'steps:N' (1-based inclusive time-loop steps, e.g. "
        f"'steps:20-40'), got {spec!r}."
    )
    head, sep, rng = spec.partition(":")
    if head != "steps" or not sep or not rng:
        raise err
    lo, dash, hi = rng.partition("-")
    try:
        a = int(lo)
        b = int(hi) if dash else a
        if not dash:
            a = 1
    except ValueError:
        raise err from None
    if a < 1 or b < a:
        raise err
    return a, b


# -- capture ------------------------------------------------------------------

#: True while a profiler session of this module is live: the record-function
#: ranges of `scope` open only then.
_capturing = False
_NULL = contextlib.nullcontext()


def scope(name: str):
    """A `torch.profiler.record_function` range named ``name`` while a
    capture is live, else a shared null context (one bool read)."""
    if not _capturing:
        return _NULL
    import torch

    return torch.profiler.record_function(name)


def _grid_device():
    from ..parallel import grid as _grid

    return _grid.global_grid().device if _grid.grid_is_initialized() else None


def _resolve_device(device):
    """The device a capture traces: ``device``, else the grid's, else CUDA
    (raising without a CUDA device, like `init_global_grid`)."""
    import torch

    if device is None:
        device = _grid_device()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "profile capture: no grid is initialised and no CUDA device is "
                "available; pass device='cpu' to capture host work only."
            )
        device = "cuda"
    return torch.device(device)


class _Session:
    """One `torch.profiler.profile` session on ``device`` (CPU activity,
    plus CUDA on a CUDA device), synchronised at both edges."""

    def __init__(self, device, **kwargs):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.device = torch.device(device)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, **kwargs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        """Start the profiler, then open the `ANCHOR` range and take the
        host instant inside it (``anchor_perf``)."""
        global _capturing
        import torch

        self._sync()
        self._prof.start()
        _capturing = True
        # The first range of a session pays its set-up (about 0.1 ms on
        # the card's host, and a millisecond the first time in a process):
        # a range before the anchor takes that out of the anchor's error.
        with torch.profiler.record_function(ANCHOR + "_warmup"):
            pass
        with torch.profiler.record_function(ANCHOR):
            self.anchor_perf = time.perf_counter()

    def stop(self, logdir: str, rank: int) -> tuple[str, float]:
        """Drain the device, stop, then export the Chrome trace into
        ``logdir``: its path, and the host perf instant the device had
        drained (the window's end)."""
        global _capturing
        _capturing = False
        self._sync()
        drained = time.perf_counter()
        self._prof.stop()
        path = os.path.join(
            logdir, f"igg.p{rank}.{os.getpid()}.{time.time_ns()}.trace.json"
        )
        self._prof.export_chrome_trace(path)
        return path, drained

    def abort(self) -> None:
        global _capturing
        _capturing = False
        try:
            self._prof.stop()
        except Exception:
            pass


class ProfileCapture:
    """One armed windowed device capture for this process's current run.

    Driven by the step pipeline (`telemetry._StepLoop`): `on_step(it,
    steps)` is called after every loop call (``steps`` steps ending on step
    ``it``) and starts or stops the profiler at the window's edges.  A
    fused loop call cannot be split, so a capture covers the calls that
    touch the window.  Every failure emits a structured
    ``profile.capture_failed`` event and disarms the capture.
    """

    def __init__(self, window: tuple[int, int], *, logdir: str | None = None,
                 rank: int | None = None):
        self.window = (int(window[0]), int(window[1]))
        self.rank = _telemetry._proc_index() if rank is None else rank
        if logdir is None:
            base = _config.profile_dir_env() or _config.telemetry_dir_env()
            logdir = (
                os.path.join(base, f"profile.p{self.rank}") if base else None
            )
        self.logdir = logdir
        self.started = False
        self.done = False
        self.started_at_step: int | None = None
        self.last_step: int | None = None
        self.t_start_perf: float | None = None
        self.wall_start: float | None = None
        self.meta_path: str | None = None
        self._session: _Session | None = None

    # - lifecycle -

    def _fail(self, stage: str, error: Exception | str) -> None:
        self.done = True
        if self._session is not None:
            # best-effort teardown so a later capture can start
            self._session.abort()
            self._session = None
        self.started = False
        _telemetry.event(
            "profile.capture_failed",
            stage=stage,
            window=list(self.window),
            logdir=self.logdir,
            error=str(error),
        )
        _telemetry.counter("profile.capture_failures").inc()

    def _start(self, step: int) -> None:
        if self.logdir is None:
            self._fail(
                "start",
                "no capture directory (set IGG_PROFILE_DIR or "
                "IGG_TELEMETRY_DIR)",
            )
            return
        try:
            os.makedirs(self.logdir, exist_ok=True)
            self._session = _Session(_resolve_device(None))
            self._session.start()
        except Exception as e:
            self._fail("start", e)
            return
        # the window's start: the profiler is live from here
        self.t_start_perf = time.perf_counter()
        self.wall_start = time.time()
        self.started = True
        self.started_at_step = step
        _telemetry.event(
            "profile.start",
            step=step,
            window=list(self.window),
            logdir=self.logdir,
        )

    def _stop(self, step: int, reason: str) -> None:
        self.done = True
        if not self.started:
            return
        self.started = False
        session, self._session = self._session, None
        try:
            trace, t_stop_perf = session.stop(self.logdir, self.rank)
        except Exception as e:
            self._session = session
            self._fail("stop", e)
            return
        # ``t_stop_perf``: the window's end, when the device had drained
        # (before the profiler's stop and export).
        meta: dict[str, Any] = {
            "schema": PROFILE_SCHEMA,
            "rank": self.rank,
            "pid": os.getpid(),
            "window": list(self.window),
            "started_at_step": self.started_at_step,
            "stopped_at_step": step,
            "reason": reason,
            "logdir": self.logdir,
            "t_start_perf": self.t_start_perf,
            "t_stop_perf": t_stop_perf,
            "anchor_perf": session.anchor_perf,
            "wall_start": self.wall_start,
            "wall_stop": time.time(),
            "device": str(session.device),
        }
        if not os.path.isfile(trace):
            meta["trace_path"] = None
            meta["attribution"] = {"error": "the profiler exported no trace file"}
            self._write_meta(meta)
            self._fail("locate", meta["attribution"]["error"])
            return
        meta["trace_path"] = trace
        try:
            attribution = attribute_trace(trace)
        except (OSError, ValueError) as e:
            attribution = {"error": f"{type(e).__name__}: {e}"}
            _telemetry.event(
                "profile.capture_failed",
                stage="attribute",
                window=list(self.window),
                error=attribution["error"],
            )
            _telemetry.counter("profile.capture_failures").inc()
        meta["attribution"] = attribution
        if "error" not in attribution:
            publish_attribution(attribution)
        self._write_meta(meta)
        _telemetry.counter("profile.captures").inc()
        _telemetry.event(
            "profile.stop",
            step=step,
            window=list(self.window),
            reason=reason,
            trace=meta["trace_path"],
            meta=self.meta_path,
            overlap_fraction=(
                attribution.get("overlap", {}).get("fraction")
                if "error" not in attribution
                else None
            ),
        )

    def _write_meta(self, meta: dict) -> None:
        # The meta lands where `find_capture_metas` looks: the telemetry
        # dir, else the capture base dir (logdir's parent: logdir is the
        # per-rank profile.p<rank>/ subdir).
        directory = _config.telemetry_dir_env() or (
            os.path.dirname(self.logdir) if self.logdir else None
        )
        if not directory:
            return
        try:
            self.meta_path = _telemetry.atomic_write_json(
                os.path.join(directory, profile_meta_filename(self.rank)),
                meta,
                indent=1,
            )
        except OSError:
            self.meta_path = None

    # - step pipeline hooks -

    def _touches(self, first: int, last: int) -> bool:
        a, b = self.window
        return first <= b and last >= a

    def on_run_start(self, start_step: int, steps_per_call: int = 1) -> None:
        """Arm-time hook: when the first call (steps ``start_step + 1`` ..
        ``start_step + steps_per_call``) touches the window, the capture
        starts now (a resumed run may start inside it)."""
        if not self.done and self._touches(start_step + 1,
                                           start_step + steps_per_call):
            self._start(start_step + 1)

    def on_step(self, it: int, steps: int = 1) -> None:
        """Post-call hook from the instrumented loop: a call of ``steps``
        steps ended on step ``it``; the next call is taken to advance as
        many."""
        self.last_step = it
        if self.done:
            return
        a, b = self.window
        if self.started:
            if it >= b:
                self._stop(it, "window")
        elif self._touches(it + 1, it + steps):
            self._start(it + 1)
        elif it + 1 > b:
            self.done = True  # window passed before the run reached it

    def close(self, reason: str) -> None:
        """Scope-exit stop (the guarded loop's exit path and
        `_StepLoop.finish`): a window still open when the run ends stops
        cleanly so the captured bytes land.  The recorded stop step is the
        last completed step the pipeline reported (the start step when the
        run died before any step finished)."""
        if self.started and not self.done:
            step = (
                self.last_step
                if self.last_step is not None
                else (self.started_at_step or 0)
            )
            self._stop(step, reason)
        else:
            self.done = True

    def info(self) -> dict:
        """The in-flight description a flight-recorder bundle wants."""
        return {
            "window": list(self.window),
            "logdir": self.logdir,
            "started": self.started,
            "started_at_step": self.started_at_step,
            "done": self.done,
        }


_active: ProfileCapture | None = None


def maybe_arm(start_step: int = 0, steps_per_call: int = 1) -> ProfileCapture | None:
    """Arm a windowed capture for this run when ``IGG_PROFILE`` says so.

    Called from the step pipeline (`telemetry._StepLoop.__init__`).
    Returns None when the knob is unset or telemetry is off.  Fires once
    per process (the next instrumented run; `reset` re-arms).  An invalid
    spec raises (the config error contract).
    """
    global _active
    spec = _config.profile_env()
    if not spec or not _telemetry.enabled():
        return None
    if _active is not None:
        return None
    window = parse_profile_window(spec)
    cap = ProfileCapture(window)
    _active = cap
    cap.on_run_start(start_step, steps_per_call)
    return cap


def active_capture() -> dict | None:
    """The open capture window's description, or None: what
    `tracing.dump_flight_recorder` bundles."""
    if _active is not None and _active.started and not _active.done:
        return _active.info()
    return None


def close_open_capture(reason: str = "scope_exit") -> None:
    """Stop any open window (the guarded loop's exit path).  Idempotent and
    never raises: it runs inside ``finally`` blocks."""
    try:
        if _active is not None:
            _active.close(reason)
    except Exception:
        pass


def reset() -> None:
    """Drop the armed capture, stopping a live one (test hook)."""
    global _active
    if _active is not None and _active._session is not None:
        _active._session.abort()
    _active = None


@contextlib.contextmanager
def profile_trace(logdir, *, device=None, **kwargs):
    """Record a `torch.profiler` capture of the enclosed block into
    ``logdir`` (the one manual capture; ``igg.profile_trace`` is an alias)::

        with igg.profile_trace("/tmp/igg-trace"):
            for _ in range(20):
                state = step(*state)
        rec = profiling.attribute_capture("/tmp/igg-trace")

    ``device``: the device traced, by default the grid's (CUDA without a
    grid); ``kwargs`` go to `torch.profiler.profile`.  The windowed capture
    (``IGG_PROFILE=steps:A-B``) needs no code change and writes the
    per-rank meta the tooling discovers.  Beside the trace goes
    ``<trace stem>.anchor.json``: the host instant taken inside the
    capture's `ANCHOR` range (``anchor_perf``) and the trace's file name.
    """
    logdir = os.fspath(logdir)
    os.makedirs(logdir, exist_ok=True)
    session = _Session(_resolve_device(device), **kwargs)
    session.start()
    try:
        yield
    except BaseException:
        session.abort()
        raise
    path, _ = session.stop(logdir, _telemetry._proc_index())
    _telemetry.atomic_write_json(
        path.removesuffix(".trace.json") + ".anchor.json",
        {"schema": PROFILE_SCHEMA, "anchor_perf": session.anchor_perf,
         "trace": os.path.basename(path)},
    )


# -- trace parsing ------------------------------------------------------------


def load_trace(path: str | os.PathLike) -> dict:
    """One Chrome-trace JSON document from ``path`` (gzip by suffix).

    Raises ValueError on malformed or truncated input.
    """
    path = os.fspath(path)
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, EOFError) as e:
        raise ValueError(f"{path}: unreadable trace ({e})") from e
    except ValueError as e:
        raise ValueError(f"{path}: malformed trace JSON ({e})") from e
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        raise ValueError(
            f"{path}: not a Chrome trace (no traceEvents list)."
        )
    return doc


def find_trace_files(logdir: str | os.PathLike) -> list[str]:
    """The ``*.trace.json`` (and ``*.trace.json.gz``) files under a capture
    dir, oldest first."""
    logdir = os.fspath(logdir)
    hits = glob.glob(
        os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True
    )
    hits += glob.glob(os.path.join(logdir, "*.trace.json"))
    return sorted(set(hits), key=lambda p: (os.path.getmtime(p), p))


def op_label(name: str) -> str:
    """A device op's short name: no return type, anonymous namespace,
    template arguments or parameters (``void (anonymous
    namespace)::fused_pt_kernel<float, 6>(...)`` -> ``fused_pt_kernel``;
    ``Memcpy DtoD (Device -> Device)`` -> ``Memcpy DtoD``)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("(", "<"):
        head = name.split(sep, 1)[0]
        if head.strip():
            name = head
    return name.strip()


def _intervals(events) -> dict:
    """``{(pid, tid): [(ts, end, dur, name), ...]}`` of annotation events."""
    out: dict = {}
    for e in events:
        ts, dur = float(e["ts"]), float(e["dur"])
        out.setdefault((e.get("pid", 0), e.get("tid", 0)), []).append(
            (ts, ts + dur, dur, e["name"])
        )
    return out


def _innermost_scope(annotations: list, ts: float, end: float) -> str | None:
    best = None
    for a, b, dur, name in annotations:
        if a - _CONTAIN_TOL_US <= ts and end <= b + _CONTAIN_TOL_US:
            if best is None or dur < best[0]:
                best = (dur, name)
    return best[1] if best else None


def device_ops(doc: dict) -> list[dict]:
    """The device ops of a torch capture: complete (``X``) events of a
    `DEVICE_CATEGORIES` category, as ``{name, cat, pid, tid, ts, dur,
    scope}`` dicts (µs; ``pid`` the device, ``tid`` the stream).  ``scope``
    is the innermost `SCOPE_NAMES` ``gpu_user_annotation`` range that
    contains the op on its stream, else None."""
    ops, annotations = [], []
    for e in doc.get("traceEvents", []):
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            continue
        cat = e.get("cat")
        if cat == ANNOTATION_CATEGORY and e.get("name") in SCOPE_NAMES:
            annotations.append(e)
        elif cat in DEVICE_CATEGORIES:
            ops.append(
                {
                    "name": e.get("name", cat),
                    "cat": cat,
                    "pid": e.get("pid", 0),
                    "tid": e.get("tid", 0),
                    "ts": float(ts),
                    "dur": float(dur),
                }
            )
    tracks = _intervals(annotations)
    for op in ops:
        op["scope"] = _innermost_scope(
            tracks.get((op["pid"], op["tid"]), ()), op["ts"], op["ts"] + op["dur"]
        )
    return ops


def capture_anchor(doc: dict) -> tuple[float, float] | None:
    """``(ts, dur)`` in µs of the capture's `ANCHOR` range on the trace's
    clock, or None for a trace without one."""
    for e in doc.get("traceEvents", []):
        if isinstance(e, dict) and e.get("ph") == "X" and e.get("name") == ANCHOR:
            return float(e["ts"]), float(e.get("dur", 0.0))
    return None


def op_kind(op: dict) -> str:
    """``collective`` | ``kernel`` | ``glue`` of one device op, by the name
    vocabulary (`COLLECTIVE_MARKS`, `GLUE_MARKS`); scope membership does
    not change what the op is."""
    if op.get("cat", "kernel") != "kernel":
        return "glue"
    name = op["name"].lower()
    if any(m in name for m in COLLECTIVE_MARKS):
        return "collective"
    if any(m in name for m in GLUE_MARKS):
        return "glue"
    return "kernel"


def scope_of(op: dict) -> str:
    """Attribution bucket of one device op: its `SCOPE_NAMES` scope (the
    innermost containing ``gpu_user_annotation`` range on its stream, see
    `device_ops`), else the `op_kind` bucket (``collectives`` /
    ``kernels`` / ``glue``)."""
    if op.get("scope"):
        return op["scope"]
    return {"collective": "collectives", "kernel": "kernels"}.get(
        op_kind(op), "glue"
    )


# -- interval arithmetic (overlap measure) ------------------------------------


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for a, b in intervals[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _intersection_seconds(u1, u2) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(u1) and j < len(u2):
        a = max(u1[i][0], u2[j][0])
        b = min(u1[i][1], u2[j][1])
        if b > a:
            total += b - a
        if u1[i][1] < u2[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_measure(ops: Sequence[dict]) -> dict:
    """The measured comm/compute overlap of one capture's device ops.

    Per device (pid): union the collective intervals and the kernel
    intervals, intersect the two unions, sum across devices.
    ``fraction = overlapped / comm``; None when the capture holds no
    collective (absence is meaningful, never 0.0).
    """
    by_pid: dict[Any, dict[str, list]] = {}
    for op in ops:
        kind = op_kind(op)
        if kind == "glue":
            continue
        iv = (op["ts"], op["ts"] + op["dur"])
        by_pid.setdefault(op["pid"], {"collective": [], "kernel": []})[
            kind
        ].append(iv)
    comm = compute = overlapped = 0.0
    for tracks in by_pid.values():
        u_comm = _union(tracks["collective"])
        u_kern = _union(tracks["kernel"])
        comm += sum(b - a for a, b in u_comm)
        compute += sum(b - a for a, b in u_kern)
        overlapped += _intersection_seconds(u_comm, u_kern)
    return {
        "comm_seconds": comm * 1e-6,
        "compute_seconds": compute * 1e-6,
        "overlapped_seconds": overlapped * 1e-6,
        "fraction": round(overlapped / comm, 6) if comm > 0 else None,
    }


def busy_seconds(ops: Sequence[dict]) -> float:
    """Seconds in which any device op of ``ops`` ran: the union of their
    intervals per device, summed over devices (one card: the time the
    card was busy)."""
    by_pid: dict[Any, list] = {}
    for op in ops:
        by_pid.setdefault(op["pid"], []).append((op["ts"], op["ts"] + op["dur"]))
    return sum(b - a for iv in by_pid.values() for a, b in _union(iv)) * 1e-6


# -- attribution --------------------------------------------------------------


def attribute_ops(ops: Sequence[dict]) -> dict:
    """Per-scope device-time attribution over parsed device ops.

    Beside the JAX package's keys: ``op_seconds``, each bucket's seconds
    per op (`op_label`), and ``busy_seconds`` (`busy_seconds`)."""
    scope_s: dict[str, float] = {}
    op_s: dict[str, dict[str, float]] = {}
    for op in ops:
        bucket = scope_of(op)
        scope_s[bucket] = scope_s.get(bucket, 0.0) + op["dur"]
        per = op_s.setdefault(bucket, {})
        label = op_label(op["name"])
        per[label] = per.get(label, 0.0) + op["dur"]
    scope_seconds = {
        name: round(us * 1e-6, 9) for name, us in sorted(scope_s.items())
    }
    total = round(sum(op["dur"] for op in ops) * 1e-6, 9)
    return {
        "schema": PROFILE_SCHEMA,
        "n_device_ops": len(ops),
        "device_seconds": total,
        "scope_seconds": scope_seconds,
        "unattributed_seconds": scope_seconds.get("glue", 0.0),
        "overlap": overlap_measure(ops),
        "busy_seconds": round(busy_seconds(ops), 9),
        "op_seconds": {
            bucket: {k: round(v * 1e-6, 9) for k, v in sorted(per.items())}
            for bucket, per in sorted(op_s.items())
        },
    }


def attribute_trace(trace: str | os.PathLike | dict) -> dict:
    """Full attribution record of one capture (path or loaded doc).

    Raises ValueError on malformed input; a valid trace with zero device
    ops returns a record saying so (``n_device_ops: 0``): a host-only
    capture is an answer, not an error.
    """
    doc = trace if isinstance(trace, dict) else load_trace(trace)
    rec = attribute_ops(device_ops(doc))
    if not isinstance(trace, dict):
        rec["trace"] = os.fspath(trace)
    return rec


def attribute_capture(logdir: str | os.PathLike) -> dict:
    """Attribute the newest trace under a capture dir."""
    traces = find_trace_files(logdir)
    if not traces:
        raise ValueError(
            f"{os.fspath(logdir)}: no *.trace.json capture found "
            f"(run with IGG_PROFILE / profile_trace first)."
        )
    return attribute_trace(traces[-1])


def publish_attribution(rec: dict) -> None:
    """Land an attribution record on the metrics registry:
    ``profile.scope_seconds.<scope>`` gauges plus
    ``profile.overlap_fraction`` (set only when measured)."""
    for name, seconds in rec.get("scope_seconds", {}).items():
        _telemetry.gauge(f"profile.scope_seconds.{name}").set(seconds)
    frac = rec.get("overlap", {}).get("fraction")
    if frac is not None:
        _telemetry.gauge("profile.overlap_fraction").set(frac)


# -- cross-run diffing --------------------------------------------------------


def attribution_delta(a: dict, b: dict) -> dict:
    """Attribute the drift between two attribution records (run A -> B).

    Per scope: seconds in each run and the delta (positive = B spends
    more); ``worst`` names the scope that grew the most.  The overlap
    fractions ride along.
    """
    scopes = sorted(
        set(a.get("scope_seconds", {})) | set(b.get("scope_seconds", {}))
    )
    table = {}
    worst, worst_delta = None, 0.0
    for s in scopes:
        sa = float(a.get("scope_seconds", {}).get(s, 0.0))
        sb = float(b.get("scope_seconds", {}).get(s, 0.0))
        delta = round(sb - sa, 9)
        table[s] = {"a_s": sa, "b_s": sb, "delta_s": delta}
        if delta > worst_delta:
            worst, worst_delta = s, delta
    return {
        "schema": PROFILE_SCHEMA,
        "scopes": table,
        "device_seconds": {
            "a": a.get("device_seconds"),
            "b": b.get("device_seconds"),
        },
        "overlap_fraction": {
            "a": a.get("overlap", {}).get("fraction"),
            "b": b.get("overlap", {}).get("fraction"),
        },
        "worst": worst,
        "worst_delta_s": round(worst_delta, 9),
    }


def render_attribution_table(rec: dict) -> str:
    """Fixed-width per-scope table (the JAX package's format)."""
    head = f"{'scope':<28} {'device_ms':>12} {'share':>7}"
    lines = [head, "-" * len(head)]
    total = rec.get("device_seconds") or 0.0
    for name, sec in rec.get("scope_seconds", {}).items():
        share = (sec / total) if total else 0.0
        lines.append(f"{name:<28} {sec * 1e3:>12.3f} {share:>6.1%}")
    lines.append("-" * len(head))
    lines.append(
        f"{'total':<28} {total * 1e3:>12.3f} {'':>7} "
        f"({rec.get('n_device_ops', 0)} device op(s))"
    )
    ov = rec.get("overlap", {})
    frac = ov.get("fraction")
    lines.append(
        "overlap: comm "
        f"{(ov.get('comm_seconds') or 0.0) * 1e3:.3f} ms, compute "
        f"{(ov.get('compute_seconds') or 0.0) * 1e3:.3f} ms, overlapped "
        f"{(ov.get('overlapped_seconds') or 0.0) * 1e3:.3f} ms -> fraction "
        + (f"{frac:.4f}" if frac is not None else "n/a (no collectives)")
    )
    return "\n".join(lines)


def render_delta_table(delta: dict) -> str:
    """Fixed-width cross-run drift table (the JAX package's format)."""
    head = f"{'scope':<28} {'A_ms':>10} {'B_ms':>10} {'delta_ms':>10}"
    lines = [head, "-" * len(head)]
    for name, row in delta.get("scopes", {}).items():
        lines.append(
            f"{name:<28} {row['a_s'] * 1e3:>10.3f} "
            f"{row['b_s'] * 1e3:>10.3f} {row['delta_s'] * 1e3:>+10.3f}"
        )
    ov = delta.get("overlap_fraction", {})

    def _f(v):
        return f"{v:.4f}" if isinstance(v, (int, float)) else "n/a"

    lines.append(
        f"overlap fraction: A {_f(ov.get('a'))} -> B {_f(ov.get('b'))}"
    )
    if delta.get("worst"):
        lines.append(
            f"worst regression: {delta['worst']} "
            f"(+{delta['worst_delta_s'] * 1e3:.3f} ms)"
        )
    return "\n".join(lines)


# -- merged-timeline join -----------------------------------------------------


def find_capture_metas(directory: str | os.PathLike) -> list[str]:
    """The per-rank capture meta files (``profile.p<rank>.json``) in a
    telemetry/run directory."""
    return sorted(
        glob.glob(os.path.join(os.fspath(directory), "profile.p*.json"))
    )


def resolve_trace_path(meta: dict, meta_dir: str | None = None) -> str | None:
    """The capture's trace file, surviving archived or copied run dirs:
    the recorded absolute path, else the meta's own ``profile.p<rank>/``,
    else the recorded logdir (None when none holds a trace)."""
    path = meta.get("trace_path")
    if path and os.path.isfile(path):
        return path
    if meta_dir is not None and meta.get("rank") is not None:
        traces = find_trace_files(
            os.path.join(os.fspath(meta_dir), f"profile.p{meta['rank']}")
        )
        if traces:
            return traces[-1]
    if meta.get("logdir"):
        traces = find_trace_files(meta["logdir"])
        if traces:
            return traces[-1]
    return None


#: tid base for attached device tracks (host spans sit on tid 0)
DEVICE_TID_BASE = 10_000

#: max seconds a capture meta's wall_start may predate the merged
#: timeline's per-rank clock-sync anchor before `attach_device_tracks`
#: refuses it as stale (a previous run's leftover in a reused directory)
STALE_META_TOL_S = 2.0


def attach_device_tracks(
    doc: dict, metas: Sequence[str | os.PathLike | dict]
) -> dict:
    """Add per-rank device tracks to a merged host timeline (in place).

    ``doc`` is `tracing.merge_trace_files` output; ``metas`` are capture
    meta files (or loaded dicts) from the same run's ranks.  Each rank's
    device ops land on its host track's pid (tids ``DEVICE_TID_BASE + k``,
    one per device stream), placed by the capture's `ANCHOR` range: an op
    ``d`` µs after the range's start on the trace's clock lands ``d`` µs
    after the host instant taken inside it (the meta's ``anchor_perf``),
    riding the host track's barrier offset.  The instant lies inside the
    range, so the placement is exact to within the range's duration,
    recorded per rank as ``anchor_error_us`` in
    ``otherData.device_alignment``.  A capture without the anchor (an
    older meta or trace) has its ops omitted, with a note.  Device events
    carry ``args.cat`` (their trace category) and ``args.igg_scope``.  The
    result still passes `tracing.validate_chrome_trace`.
    """
    alignment = doc.get("otherData", {}).get("clock_alignment")
    if alignment is None:
        raise ValueError(
            "attach_device_tracks needs merge_trace_files output "
            "(otherData.clock_alignment missing)."
        )
    base_us = float(alignment.get("ts_zero_offset_s", 0.0)) * 1e6
    dev_align: dict[str, Any] = {
        "note": (
            "device tracks are placed by each capture's igg_capture_anchor "
            "range against the host instant taken inside it "
            "(profile.p<rank>.json anchor_perf); the error is the range's "
            "duration (per rank: anchor_error_us), ON TOP of the host "
            "clock_alignment uncertainty."
        ),
        "per_rank": {},
    }
    events = doc["traceEvents"]
    # Validate every meta before touching the doc, so a raising check can
    # never leave the caller holding a partially mutated timeline.
    plans: list[tuple[dict, dict, str | None, list]] = []
    for meta_in in metas:
        if isinstance(meta_in, dict):
            meta, meta_dir = meta_in, None
        else:
            with open(os.fspath(meta_in), encoding="utf-8") as f:
                meta = json.load(f)
            meta_dir = os.path.dirname(os.path.abspath(os.fspath(meta_in)))
        if meta.get("schema") != PROFILE_SCHEMA:
            raise ValueError(
                f"capture meta {meta_in}: unsupported schema "
                f"{meta.get('schema')!r} (expected {PROFILE_SCHEMA})."
            )
        rank = meta["rank"]
        per = alignment.get("per_rank", {}).get(str(rank))
        if per is None:
            # A crashed rank can leave a capture meta with no host dump:
            # degrade per rank instead of refusing the whole merge.
            dev_align["per_rank"][str(rank)] = {
                "trace": None,
                "n_ops": 0,
                "note": (
                    "no host track for this rank in the merged trace "
                    "(crashed before dump_trace?) — device ops omitted"
                ),
            }
            continue
        sync_wall = per.get("wall_at_sync_unix_s")
        wall_start = meta.get("wall_start")
        if (
            sync_wall is not None
            and wall_start is not None
            and wall_start < sync_wall - STALE_META_TOL_S
        ):
            raise ValueError(
                f"capture meta for rank {rank} predates the merged "
                f"timeline's clock sync by "
                f"{sync_wall - wall_start:.1f}s — a stale "
                f"profile.p{rank}.json from a previous run in a reused "
                f"telemetry dir looks exactly like this: delete it, or "
                f"re-run the capture alongside the current trace dumps."
            )
        trace_path = resolve_trace_path(meta, meta_dir)
        trace = load_trace(trace_path) if trace_path else None
        plans.append((meta, per, trace_path,
                      device_ops(trace) if trace else [],
                      capture_anchor(trace) if trace else None))
    for meta, per, trace_path, ops, anchor in plans:
        rank = meta["rank"]
        entry: dict[str, Any] = {"trace": trace_path, "n_ops": 0}
        dev_align["per_rank"][str(rank)] = entry
        if not trace_path:
            entry["note"] = "no device trace captured"
            continue
        if not ops:
            entry["note"] = "capture holds no device ops"
            continue
        if anchor is None or meta.get("anchor_perf") is None:
            entry["note"] = (
                f"capture holds no {ANCHOR} range or its meta no anchor_perf "
                "(an older capture): device ops omitted"
            )
            continue
        t0, entry["anchor_error_us"] = anchor
        anchor_us = (
            (meta["anchor_perf"] + per["offset_s"]) * 1e6 - base_us
        )
        tids = sorted({(op["pid"], op["tid"]) for op in ops}, key=str)
        tid_map = {t: DEVICE_TID_BASE + i for i, t in enumerate(tids)}
        for t in tids:
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": rank,
                    "tid": tid_map[t],
                    "args": {"name": f"device {t[0]} stream {t[1]}"},
                }
            )
        for op in ops:
            events.append(
                {
                    "ph": "X",
                    "name": op["name"],
                    "pid": rank,
                    "tid": tid_map[(op["pid"], op["tid"])],
                    "ts": anchor_us + (op["ts"] - t0),
                    "dur": op["dur"],
                    "args": {"cat": op["cat"], "igg_scope": scope_of(op)},
                }
            )
        entry["n_ops"] = len(ops)
        entry["anchor_perf"] = meta["anchor_perf"]
        entry["window"] = meta.get("window")
    # Re-base: the validator refuses negative timestamps, and a device op
    # may align before the earliest host span.
    xs = [e["ts"] for e in events if e.get("ph") == "X"]
    if xs:
        shift = -min(min(xs), 0.0)
        if shift > 0:
            for e in events:
                if e.get("ph") == "X":
                    e["ts"] += shift
            alignment["ts_zero_offset_s"] = (
                float(alignment.get("ts_zero_offset_s", 0.0)) - shift / 1e6
            )
    events.sort(key=lambda e: (str(e["pid"]), e.get("ts", -1.0)))
    doc["otherData"]["device_alignment"] = dev_align
    return doc


# -- command line -------------------------------------------------------------


def _attribute_target(target: str) -> dict:
    """Attribution record of one command-line target: a trace file, a
    capture dir, or a run dir with capture metas (ranks rolled up)."""
    if os.path.isfile(target):
        return attribute_trace(target)
    if not os.path.isdir(target):
        raise FileNotFoundError(f"{target}: no such file or directory")
    metas = find_capture_metas(target)
    if not metas:
        return attribute_capture(target)
    ranks, merged = {}, []
    for path in metas:
        with open(path, encoding="utf-8") as f:
            meta = json.load(f)
        trace = resolve_trace_path(meta, os.path.dirname(os.path.abspath(path)))
        if not trace:
            ranks[str(meta.get("rank"))] = {"error": "capture recorded no trace file"}
            continue
        ops = device_ops(load_trace(trace))
        for op in ops:  # distinct pids per rank keep the overlap per device
            op["pid"] = (meta.get("rank"), op["pid"])
        merged.extend(ops)
        ranks[str(meta.get("rank"))] = attribute_ops(ops)
    rec = attribute_ops(merged)
    rec["per_rank"] = ranks
    rec["trace"] = target
    return rec


def main(argv=None) -> int:
    """``attribute TARGET [--json]`` prints a capture's scope table;
    ``diff A B [--json]`` names the scope a drift went to.  A malformed
    trace is one JSON finding on stdout and exit 1; a missing target exit
    2."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m implicitglobalgrid_tpu_torch.utils.profiling",
        description="Attribute or diff device-timeline captures.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    at = sub.add_parser("attribute", help="per-scope device-time attribution")
    at.add_argument("target", help="trace file, capture dir, or run dir with profile.p*.json")
    at.add_argument("--json", action="store_true")
    df = sub.add_parser("diff", help="attribute the drift between two captures")
    df.add_argument("a")
    df.add_argument("b")
    df.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    recs = []
    for target in ((args.target,) if args.cmd == "attribute" else (args.a, args.b)):
        try:
            recs.append(_attribute_target(target))
        except FileNotFoundError as e:
            print(f"profiling: {e}", file=sys.stderr)
            return 2
        except (OSError, ValueError) as e:
            print(json.dumps({"finding": "profile.parse_failed", "target": target,
                              "error": f"{type(e).__name__}: {e}"}))
            return 1
    if args.cmd == "attribute":
        print(json.dumps(recs[0]) if args.json else render_attribution_table(recs[0]))
    else:
        delta = attribution_delta(*recs)
        print(json.dumps(delta) if args.json else render_delta_table(delta))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
