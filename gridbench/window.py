"""One run's window: set-up, then a timed window of a fixed number of
calls, and after it the checks of what the window produced against the
plain reference.

Set-up makes the inputs from the seed on the device, warms the cell's own
call on them, reads the peak memory of that warm-up, and makes the inputs
again for the window.  The window times every call with CUDA events, each
from the end of the one before.  It keeps device copies of the first call's
output (its input is the benchmark's) and of one call drawn from the seed,
with that call's input; after the window they go to the host, and the
program's state is freed.  The host keeps the traffic's ``queued_calls``
calls enqueued ahead of the card (one unless it says more): before it
enqueues a call it waits for the end of the call that many and one before,
so the card always has the next call queued and the host never runs further
ahead.
"""

from __future__ import annotations

import contextlib
import random
import sys
import tempfile
import time

import torch

from . import spec, trace
from .layout import Layout, take
from .program import Program


#: calls of the cell's own shapes before the window: the first builds the
#: kernels and sizes the tile, the rest fill the allocator's cache
WARMUP_CALLS = 3


def sample_index(seed: int, calls: int) -> int:
    """The call after the first whose input and output are checked: drawn
    from the seed, never the first (which the start check covers)."""
    return random.Random(int(seed) * 1009).randrange(1, calls)


class Window:
    def __init__(self, cfg: dict, traf: dict, seed: int, device, trace_on: bool = False,
                 wrap_call=None):
        self.cfg, self.traf, self.seed = cfg, traf, int(seed)
        self.device = torch.device(device)
        self.trace_on = trace_on
        self.wrap_call = wrap_call  # tests plant faults here
        self.ref = spec.reference(cfg["program"]["module"])
        self.spc = spec.steps_per_call(cfg, traf)
        self.queued = spec.queued_calls(cfg, traf)
        self.layout = Layout.of(spec.grid_of(cfg, traf))
        self.kept = None

    def inputs(self) -> dict:
        """The block of the benchmark's inputs: made over the global grid and
        cut to the block, so both sides see the same values."""
        full = self.ref.initial(self.cfg, self.layout, self.seed, self.device,
                                getattr(torch, self.cfg["dtype"]))
        return {k: take(v, self.layout.block_index(self.ref.STAGGER[k], self.device))
                for k, v in full.items()}

    def run(self, calls: int) -> dict:
        t0 = time.perf_counter()
        lay, dev = self.layout, self.device
        grid = {"block": lay.block, "overlaps": lay.overlaps, "periods": lay.periods}
        prog = Program(self.cfg, grid, self.spc, spec.options(self.cfg, self.traf), dev)
        marks = [("grid", time.perf_counter())]
        call = prog.call if self.wrap_call is None else self.wrap_call(prog)

        state = prog.state(self.inputs())
        self._sync()
        marks.append(("inputs", time.perf_counter()))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(WARMUP_CALLS):
            state = call(state)
        self._sync()
        peak_warm = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        marks.append(("warm-up", time.perf_counter()))
        del state
        state = prog.state(self.inputs())
        self._sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sample = sample_index(self.seed, calls)
        evolving = [prog.state_names.index(k) for k in self.ref.EVOLVING]
        # the checks' copies, allocated before the window
        keep = {w: [torch.empty_like(state[j]) for j in evolving]
                for w in ("start_out", "sample_in", "sample_out")}
        setup_s = time.perf_counter() - t0
        marks.append(("inputs again", t0 + setup_s))
        parts = ", ".join(f"{k} {b - a:.3f}" for (k, b), (_, a) in
                          zip(marks, [("", t0)] + marks[:-1]))
        print(f"gridbench: set-up {setup_s:.3f} s: {parts}", file=sys.stderr, flush=True)

        def copy(which, s):
            for b, j in zip(keep[which], evolving):
                b.copy_(s[j])

        timer = _Timer(dev, calls)
        tmp = tempfile.TemporaryDirectory(prefix="gridbench-trace-") if self.trace_on else None
        with (prog.profile(tmp.name) if tmp else contextlib.nullcontext()):
            with (torch.profiler.record_function(trace.WINDOW) if tmp else contextlib.nullcontext()):
                timer.mark(0)
                for c in range(calls):
                    if c > self.queued:
                        timer.wait(c - self.queued)  # the end of call c - queued - 1
                    if c == sample:
                        copy("sample_in", state)
                    state = call(state)
                    if c == 0:
                        copy("start_out", state)
                    if c == sample:
                        copy("sample_out", state)
                    timer.mark(c + 1)
            self._sync()
        times = timer.times()
        peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            st = torch.cuda.memory_stats(dev)
            print(f"gridbench: window {sum(times) / (calls * self.spc):.5f} ms/step; allocator: "
                  f"reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB, retries "
                  f"{st.get('num_alloc_retries', 0)}, device frees {st.get('num_device_free', 0)}",
                  file=sys.stderr, flush=True)
        summary = None
        if tmp:
            summary = trace.summarize(trace.load_events(tmp.name))
            tmp.cleanup()
        del state

        # what the checks need, to the host; the sampled input over the
        # global grid
        names = list(self.ref.EVOLVING)
        self.kept = {
            "start_out": {k: v.cpu() for k, v in zip(names, keep.pop("start_out"))},
            "sample_out": {k: v.cpu() for k, v in zip(names, keep.pop("sample_out"))},
            "sample_in": self._global(dict(zip(names, keep.pop("sample_in")))),
        }
        prog.finalize()
        return {
            "start_s": t0, "calls": calls, "steps": calls * self.spc, "total_ms": sum(times),
            "times_ms": times, "setup_s": setup_s, "peak_warm": peak_warm,
            "peak_window": peak_window, "trace": summary,
        }

    def _global(self, block: dict) -> dict:
        """The fields over the global grid, from the block."""
        lay, out = self.layout, {}
        for k, v in block.items():
            shape = tuple(g + s for g, s in zip(lay.global_shape(), lay.stagger(self.ref.STAGGER[k])))
            G = torch.empty(shape, dtype=v.dtype, device=v.device)
            ix, iy, iz = lay.block_index(self.ref.STAGGER[k], v.device)
            G[ix[:, None, None], iy[None, :, None], iz[None, None, :]] = v
            out[k] = G.cpu()
        return out

    # -- checks -------------------------------------------------------------
    def checks(self, advance=None) -> dict:
        """The window's start and sample outputs against the reference (or,
        for the control, ``advance`` put in its place): the largest relative
        gap over the evolving fields."""
        return {w: self._check(w, advance) for w in ("start", "sample")}

    def _check(self, which: str, advance=None) -> float:
        lay, dev = self.layout, self.device
        wrap = tuple(bool(p) for p in lay.periods)
        p = self.ref.params(self.cfg, lay)
        state = self.ref.initial(self.cfg, lay, self.seed, dev, torch.float32)
        if which == "sample":
            state.update({k: v.to(dev) for k, v in self.kept["sample_in"].items()})
        call = {"steps": self.spc}
        want = self.ref.advance(self.cfg, dict(state), p, call, wrap)
        if advance is None:
            got = self.kept[f"{which}_out"]
        else:
            got = advance(self.cfg, dict(state), p, call, wrap)
        worst = 0.0
        for k in self.ref.EVOLVING:
            idx = lay.block_index(self.ref.STAGGER[k], dev)
            ref = take(want[k], idx).to(torch.float64)
            g = (got[k] if advance is None else take(got[k], idx)).to(dev, torch.float64)
            scale = float(ref.abs().max()) or 1.0
            gap = float((g - ref).abs().max()) / scale
            worst = max(worst, gap if gap == gap else float("inf"))
        return worst

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _Timer:
    """CUDA events after every call (host clock on the CPU, for tests)."""

    def __init__(self, device, calls: int):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
        else:
            self.t = [0.0] * (calls + 1)

    def mark(self, i: int) -> None:
        if self.cuda:
            self.ev[i].record()
        else:
            self.t[i] = time.perf_counter()

    def wait(self, i: int) -> None:
        """Wait until the device has reached mark ``i``."""
        if self.cuda:
            self.ev[i].synchronize()

    def times(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.ev, self.ev[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.t, self.t[1:])]
