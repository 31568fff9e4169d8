"""Overlap-independence analyzer (``overlap-independence``), the twin of
the JAX package's ``analysis/overlap.py``.

In JAX the pass proves on the traced program that the pipelined schedule's
interior kernel does not depend on the group's permutes.  The port's
schedule (`models._fused.run_pipelined_group_schedule`) is CUDA streams: the
mid pass runs on a second stream that waits only for the group's input,
the exchange starts from the ring pass, and the compute stream joins both
before the received planes land.  One stray wait serializes it silently;
one missing join races.  Nothing on one GPU shows either (phase 13b of
``chip_smoke.py`` sees no overlap fraction there: every partner is the
block itself).

So this pass drives the real schedule on the CPU under a recording shim of
the stream API: its ``torch.cuda`` stand-in hands out recording streams and
records ``wait_stream``, ``record_stream`` and the ``torch.cuda.stream``
context, with the schedule's own code rebound to it; the ring pass, the mid pass and the exchange's begin and finish
are recording stand-ins too.  Each recorded operation gets the set of
operations it is ordered after (its stream's earlier work and everything
its stream waited for), and per group the pass requires:

* the mid pass is ordered after the group's input (``mid-before-input``);
* the mid pass is ordered after neither the exchange (``mid-waits-for-
  exchange``) nor the ring pass (``mid-waits-for-ring``): either wait
  serializes the overlap;
* the finish, which writes the received planes, is ordered after the mid
  pass and the exchange (``finish-before-join``).
"""

from __future__ import annotations

import contextlib
import types

from .core import Context, Finding

ANALYZER = "overlap-independence"


class _Recording:
    """The operations of one driven schedule, each with what it is ordered
    after."""

    def __init__(self):
        self.ops = []  # (label, stream name, frozenset of earlier op indices)
        self.main = _Stream(self, "main")
        self.current = self.main

    def op(self, label: str):
        s = self.current
        self.ops.append((label, s.name, frozenset(s.after)))
        s.after.add(len(self.ops) - 1)


class _Stream:
    def __init__(self, rec, name):
        self.rec, self.name, self.after = rec, name, set()

    def wait_stream(self, other):
        self.after |= other.after


class _Tensor:
    """A field of the driven schedule: a CUDA tensor to the schedule."""

    is_cuda = True
    device = "cuda:0"

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def record_stream(self, stream):
        self.rec.ops.append((f"record {self.name}", stream.name, frozenset()))


def _shim(rec):
    @contextlib.contextmanager
    def stream(s):
        prev, rec.current = rec.current, s
        try:
            yield
        finally:
            rec.current = prev

    cuda = types.SimpleNamespace(current_stream=lambda device=None: rec.main, stream=stream)
    return types.SimpleNamespace(cuda=cuda)


def drive(schedule, groups: int = 2, fields: int = 2) -> _Recording:
    """Run ``schedule`` (`run_pipelined_group_schedule`'s signature) for
    ``groups`` groups under the shim; returns the recording."""
    rec = _Recording()
    mid = _Stream(rec, "mid")

    def boundary(ki, c):
        rec.op("ring")
        return tuple(_Tensor(rec, f"ring{i}") for i in range(len(c)))

    def interior(ki, c, b_out):
        rec.op("mid")
        return b_out

    def begin(b_out, dims, **kw):
        rec.op("exchange")
        return "pend"

    def finish(out, pend):
        rec.op("finish")
        return out

    globs = dict(schedule.__globals__)
    globs.update(torch=_shim(rec), _mid_stream=lambda device: mid,
                 begin_slab_exchange=begin, finish_slab_exchange=finish,
                 exchange_dims=lambda A, dims, **kw: rec.op("z exchange"))
    fn = types.FunctionType(schedule.__code__, globs, schedule.__name__,
                            schedule.__defaults__, schedule.__closure__)
    fn.__kwdefaults__ = schedule.__kwdefaults__
    rec.op("input")
    fn([2] * groups, boundary, interior, tuple(_Tensor(rec, f"f{i}") for i in range(fields)),
       width=2)
    return rec


def overlap_findings(schedule=None) -> list[Finding]:
    """Findings of the pipelined group schedule (default: the port's)."""
    if schedule is None:
        from ..models import _fused

        schedule = _fused.run_pipelined_group_schedule
    rec = drive(schedule)
    name = f"{schedule.__module__}.{schedule.__qualname__}"
    out = []

    def finding(code, severity, group, message):
        out.append(Finding(analyzer=ANALYZER, code=code, severity=severity,
                           message=f"group {group}: {message}", symbol=name,
                           anchor=f"{code}@{group}"))

    labels = [label for label, _, _ in rec.ops]
    inputs = [i for i, lab in enumerate(labels) if lab in ("input", "finish", "z exchange")]
    group = 0
    for i, (label, stream, after) in enumerate(rec.ops):
        if label == "ring":
            group += 1
            start = max(j for j in inputs if j < i)
            ring, exch, mid_op = i, None, None
        elif label == "exchange":
            exch = i
        elif label == "mid":
            if stream == "main":
                finding("mid-on-compute-stream", "ERROR", group,
                        "the mid pass runs on the compute stream: nothing overlaps.")
            if start not in after:
                finding("mid-before-input", "CRITICAL", group,
                        "the mid pass is not ordered after the group's input: it may read "
                        "fields the previous group still writes.")
            if exch is not None and exch in after:
                finding("mid-waits-for-exchange", "ERROR", group,
                        "the mid pass waits for the group's exchange: the exchange and the "
                        "mid pass run one after the other.")
            if ring in after:
                finding("mid-waits-for-ring", "ERROR", group,
                        "the mid pass waits for the ring pass: the passes run one after "
                        "the other, and the exchange starts no earlier.")
            mid_op = i
        elif label == "finish":
            if mid_op is None or mid_op not in after or exch is None or exch not in after:
                finding("finish-before-join", "CRITICAL", group,
                        "the received planes land before the compute stream joined the mid "
                        "pass and the exchange: the mid pass may overwrite them, or the "
                        "planes are not there yet.")
    if group == 0:
        out.append(Finding(analyzer=ANALYZER, code="census-broken", severity="ERROR",
                           message="the driven schedule ran no ring pass.", symbol=name,
                           anchor="no-groups"))
    return out


def run(ctx: Context) -> list[Finding]:
    return overlap_findings()
