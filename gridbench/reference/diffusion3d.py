"""Plain reference of 3-D heat diffusion with variable heat capacity
(ImplicitGlobalGrid.jl's ``examples/diffusion3D_multigpu_CuArrays_novis.jl``),
on the global grid, and the benchmark's inputs for it.

    T += dt * lam * lap(T) / Cp      on every cell that is not a boundary cell

A non-periodic dimension's first and last global cells stay as they were;
a periodic dimension wraps.  Plain torch on whole arrays; imports nothing of
the program.
"""

from __future__ import annotations

import torch

from ..layout import Layout, seeded_slabs


def params(cfg: dict, layout: Layout) -> dict:
    """The scalars of the run, worked out from the configuration."""
    ph = cfg["physics"]
    g = layout.global_shape()
    dx, dy, dz = (ph[k] / (n - 1) for k, n in zip(("lx", "ly", "lz"), g))
    dt = min(dx * dx, dy * dy, dz * dz) * ph["cp_min"] / ph["lam"] / 8.1
    return {"lam": ph["lam"], "dx": dx, "dy": dy, "dz": dz, "dt": dt}


def initial(cfg: dict, layout: Layout, seed: int, device, dtype=torch.float32) -> dict:
    """``{"T", "Cp"}`` over the global grid: the example's two Gaussian
    anomalies, with seeded noise on T and a seeded positive factor on Cp,
    drawn on the device (`layout.seeded_slabs`)."""
    ph, ini = cfg["physics"], cfg["init"]
    p = params(cfg, layout)
    lx, ly, lz = ph["lx"], ph["ly"], ph["lz"]
    cells = layout.global_shape()
    idx = [torch.arange(n, device=device, dtype=torch.float32) for n in cells]
    Y = (idx[1] * p["dy"]).reshape(1, -1, 1)
    Z = (idx[2] * p["dz"]).reshape(1, 1, -1)
    T = torch.empty(cells, dtype=dtype, device=device)
    Cp = torch.empty(cells, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def x_of(xs):
        return (idx[0][xs] * p["dx"]).reshape(-1, 1, 1)

    for xs, noise in seeded_slabs(gen, cells, device, torch.randn):
        X = x_of(xs)
        t = 100 * torch.exp(
            -(((X - lx / 2) / 2) ** 2) - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 3.0) / 2) ** 2
        ) + 50 * torch.exp(
            -(((X - lx / 2) / 2) ** 2) - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 1.5) / 2) ** 2
        )
        T[xs] = t + ini["t_noise"] * noise
    for xs, u in seeded_slabs(gen, cells, device, torch.rand):
        X = x_of(xs)
        cp = ph["cp_min"] + (
            5 * torch.exp(-((X - lx / 1.5) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
            + 5 * torch.exp(-((X - lx / 3.0) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
        )
        Cp[xs] = cp * (1 + ini["cp_noise"] * u)
    return {"T": T, "Cp": Cp}


def steps(state: dict, p: dict, nsteps: int, wrap) -> dict:
    """``nsteps`` explicit steps of T on the global grid; ``wrap[d]``:
    dimension ``d`` is periodic.  In a non-periodic dimension the first and
    last cells keep their values."""
    T, Cp = state["T"], state["Cp"]
    inv = [1.0 / (h * h) for h in (p["dx"], p["dy"], p["dz"])]
    mask = torch.ones(T.shape, dtype=torch.bool, device=T.device)
    for d in range(3):
        if not wrap[d]:
            mask.narrow(d, 0, 1).fill_(False)
            mask.narrow(d, T.shape[d] - 1, 1).fill_(False)
    coef = (p["dt"] * p["lam"]) / Cp
    for _ in range(nsteps):
        lap = torch.zeros_like(T)
        for d in range(3):
            lap += (torch.roll(T, 1, d) + torch.roll(T, -1, d) - 2 * T) * inv[d]
        T = torch.where(mask, T + coef * lap, T)
    return {"T": T, "Cp": Cp}


#: the fields a call advances, in the program's state order
EVOLVING = ("T",)
#: one more entry than cells along a dimension, per field
STAGGER = {"T": (0, 0, 0), "Cp": (0, 0, 0)}


def flops_per_cell_step(cfg: dict) -> int:
    """Floating-point operations of one step at one cell, as written in
    `steps`: the three second differences (5 each), ``coef * lap`` and the
    update."""
    return 17


def advance(cfg: dict, state: dict, p: dict, call: dict, wrap) -> dict:
    """One call of the traffic: ``call["steps"]`` time steps."""
    return steps(state, p, call["steps"], wrap)
