"""The system under test: a model of ``implicitglobalgrid_tpu_torch`` on a
one-rank grid, driven through the library's public entry points
(``init_global_grid`` by way of the model's ``setup``,
``make_multi_step``, ``finalize_global_grid``, ``profile_trace``).  The
configuration names the model module and the keys of its ``physics`` that
the model's ``setup`` takes; the traffic names the options of its
``make_multi_step``."""

from __future__ import annotations

import importlib

import torch


def _port():
    import implicitglobalgrid_tpu_torch as igg

    return igg


class Program:
    """One grid and one call: ``call(state) -> state``, ``nsteps`` time
    steps through the model's ``make_multi_step`` with ``options``."""

    def __init__(self, cfg: dict, grid: dict, nsteps: int, options: dict, device):
        prog = cfg["program"]
        self.model = importlib.import_module(f"implicitglobalgrid_tpu_torch.models.{prog['module']}")
        self.state_names = tuple(prog["state"])
        kw = {k: cfg["physics"][k] for k in prog["setup_keys"]}
        for d, ax in enumerate("xyz"):
            kw[f"dim{ax}"] = 1
            kw[f"period{ax}"] = grid["periods"][d]
            kw[f"overlap{ax}"] = grid["overlaps"][d]
        _, self.params = self.model.setup(*grid["block"], dtype=getattr(torch, cfg["dtype"]),
                                          device=device, quiet=True, **kw)
        self.step = self.model.make_multi_step(self.params, nsteps, **{"autotune": False, **options})

    def state(self, fields: dict) -> tuple:
        return tuple(fields[k] for k in self.state_names)

    def call(self, state: tuple) -> tuple:
        return tuple(self.step(*state))

    @staticmethod
    def finalize() -> None:
        _port().finalize_global_grid()

    @staticmethod
    def profile(logdir):
        return _port().profile_trace(logdir)
