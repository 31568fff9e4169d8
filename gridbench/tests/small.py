"""Small CPU versions of the benchmark's cells, and the faults the tests
plant under the timed path."""

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from gridbench import run, spec

def cell(name: str):
    """``(bench, cell, cfg, traf)`` of a cell, its configuration cut to its
    ``cpu_block``, a block that one run of a few calls covers on the CPU
    (the overlaps and kernel depths stay the configuration's)."""
    bench = spec.load_benchmark(spec.HERE.parent)
    c = spec.workload(bench, name)
    cfg = copy.deepcopy(spec.config(c["config"]))
    traf = copy.deepcopy(spec.traffic(c["traffic"]))
    cfg["grid"]["block"] = list(cfg["cpu_block"])
    cfg["nominal_ms_per_step"] = {traf["name"]: 1.0}
    traf.pop("nominal_ms_per_step", None)
    return bench, c, cfg, traf


def faults(name: str) -> list[str]:
    """The faults a cell can have: one rank exchanges halos only with
    itself, so only where the cell's grid has a periodic dimension."""
    _, _, cfg, traf = cell(name)
    periodic = any(spec.grid_of(cfg, traf)["periods"])
    return ["unchanged", "altered", "exchange"] if periodic else ["unchanged", "altered"]


def args(seed=2**31 + 7, seconds=0.06, trace=0):
    return SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


def one_run(name: str, fault=None, seed=2**31 + 7):
    """One whole CPU run of a cell, with ``fault`` planted; the result line
    the benchmark would print, and the window's record."""
    bench, c, cfg, traf = cell(name)
    a = args(seed)
    with planted(fault) as wrap:
        out = run.run_window(cfg, traf, a, torch.device("cpu"), wrap_call=wrap)
    return run.result(bench, c, cfg, traf, a, out, run.setup_seconds(out),
                      {"platform": "gpu"}), out


class planted:
    """A fault under the timed path: ``unchanged`` (the call returns its
    state as it came), ``altered`` (one value of the state's first field
    changed where the call produces it), ``exchange`` (no halo exchange
    writes what it received, self copies included)."""

    def __init__(self, fault):
        self.fault = fault
        self.saved = None

    def __enter__(self):
        if self.fault == "exchange":
            from implicitglobalgrid_tpu_torch.ops import halo

            self.saved = halo._write_planes
            halo._write_planes = lambda *a, **k: None
            return None
        if self.fault == "unchanged":
            return lambda prog: (lambda state: tuple(state))
        if self.fault == "altered":
            def wrap(prog):
                def call(state):
                    out = list(prog.call(state))
                    T = out[0].clone()
                    T.view(-1)[T.numel() // 2 + 3] += 1.0
                    out[0] = T
                    return tuple(out)
                return call
            return wrap
        if self.fault is not None:
            raise ValueError(self.fault)
        return None

    def __exit__(self, *exc):
        if self.saved is not None:
            from implicitglobalgrid_tpu_torch.ops import halo

            halo._write_planes = self.saved
        return False
