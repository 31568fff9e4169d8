"""Plain reference of 3-D porous convection (Darcy flow with Boussinesq
buoyancy, temperature advection-diffusion, pseudo-transient pressure
relaxation; Raess et al. 2022, GMD 15, 5757), on the global grid, and the
benchmark's inputs for it.

Cells hold T and Pf; the Darcy fluxes live on faces (face ``j`` between
cells ``j-1`` and ``j``).  A time step is ``npt`` relaxations

    qD += theta * (-grad(Pf) + Ra*lam_T*avg_z(T) e_z - qD)   (inner faces)
    Pf -= beta * div(qD)                                       (all cells)

then one upwind advection-diffusion step of T on inner cells:

    T += dt * (lam_T*lap(T) - (1/phi) * sum_d [q-(>0) dT/dd back + q+(<0) dT/dd fwd])

In a non-periodic dimension the first and last faces (no-flow walls) and the
first and last cells of T keep their values, and so do the fluxes along the
walls (faces of a boundary cell in another dimension); a periodic dimension
wraps.  Plain torch on whole arrays; imports nothing of the program.
"""

from __future__ import annotations

import torch

from ..layout import Layout, seeded_slabs


def params(cfg: dict, layout: Layout) -> dict:
    """The scalars of the run, worked out from the configuration."""
    ph = cfg["physics"]
    g = layout.global_shape()
    dx, dy, dz = (ph[k] / (n - 1) for k, n in zip(("lx", "ly", "lz"), g))
    ra, dT, phi, theta = ph["Ra"], ph["dT"], ph["phi"], ph["theta_q"]
    lam = 1.0 / ra
    dmin = min(dx, dy, dz)
    dt = min(dmin ** 2 / lam / 8.1, phi * dmin / (3.0 * ra * lam * dT))
    k2 = 4.0 * (1.0 / dx ** 2 + 1.0 / dy ** 2 + 1.0 / dz ** 2)
    return {"dx": dx, "dy": dy, "dz": dz, "dt": dt, "lam": lam, "phi": phi,
            "theta": theta, "beta": 0.9 * 2.0 / (theta * k2), "buoy": ra * lam,
            "npt": int(ph["npt"])}


#: the fields a call advances, in the program's state order
EVOLVING = ("T", "Pf", "qDx", "qDy", "qDz")
#: one more entry than cells along a dimension, per field (a periodic
#: dimension has as many faces as cells)
STAGGER = {"T": (0, 0, 0), "Pf": (0, 0, 0), "qDx": (1, 0, 0), "qDy": (0, 1, 0),
           "qDz": (0, 0, 1)}


def initial(cfg: dict, layout: Layout, seed: int, device, dtype=torch.float32) -> dict:
    """The fields over the global grid: T a linear profile, hot bottom to
    cold top, with a central Gaussian anomaly and seeded noise drawn on the
    device (`layout.seeded_slabs`); Pf and the fluxes zero."""
    ph, ini = cfg["physics"], cfg["init"]
    p = params(cfg, layout)
    lx, ly, lz, dT = ph["lx"], ph["ly"], ph["lz"], ph["dT"]
    cells = layout.global_shape()
    idx = [torch.arange(n, device=device, dtype=torch.float32) for n in cells]
    Y = (idx[1] * p["dy"]).reshape(1, -1, 1)
    Z = (idx[2] * p["dz"]).reshape(1, 1, -1)
    T = torch.empty(cells, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for xs, noise in seeded_slabs(gen, cells, device, torch.randn):
        X = (idx[0][xs] * p["dx"]).reshape(-1, 1, 1)
        prof = dT / 2 - dT * Z / lz
        pert = 0.1 * dT * torch.exp(
            -(((X - lx / 2) / 0.1) ** 2) - ((Y - ly / 2) / 0.1) ** 2 - ((Z - lz / 2) / 0.1) ** 2
        )
        T[xs] = prof + pert + ini["t_noise"] * dT * noise
    out = {"T": T, "Pf": torch.zeros(cells, dtype=dtype, device=device)}
    for name in ("qDx", "qDy", "qDz"):
        shape = tuple(n + s for n, s in zip(cells, layout.stagger(STAGGER[name])))
        out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def _edges(shape, d: int, device, wrap: bool):
    """A mask over ``shape`` that is False on the first and last entries
    along ``d`` unless the dimension wraps."""
    m = torch.ones(shape, dtype=torch.bool, device=device)
    if not wrap:
        m.narrow(d, 0, 1).fill_(False)
        m.narrow(d, shape[d] - 1, 1).fill_(False)
    return m


def _face_grad(A, d: int, h: float, wrap: bool):
    """(A[j] - A[j-1]) / h on the faces along ``d`` (the wall faces of a
    non-periodic dimension read 0 and are masked by the caller)."""
    if wrap:
        return (A - torch.roll(A, 1, d)) / h
    inner = (A.narrow(d, 1, A.shape[d] - 1) - A.narrow(d, 0, A.shape[d] - 1)) / h
    z = torch.zeros_like(A.narrow(d, 0, 1))
    return torch.cat([z, inner, z], d)


def _face_avg(A, d: int, wrap: bool):
    if wrap:
        return 0.5 * (A + torch.roll(A, 1, d))
    inner = 0.5 * (A.narrow(d, 1, A.shape[d] - 1) + A.narrow(d, 0, A.shape[d] - 1))
    z = torch.zeros_like(A.narrow(d, 0, 1))
    return torch.cat([z, inner, z], d)


def _upper(q, d: int, wrap: bool):
    """The face above each cell along ``d``."""
    return torch.roll(q, -1, d) if wrap else q.narrow(d, 1, q.shape[d] - 1)


def _lower(q, d: int, wrap: bool):
    return q if wrap else q.narrow(d, 0, q.shape[d] - 1)


def steps(state: dict, p: dict, nsteps: int, wrap) -> dict:
    """``nsteps`` time steps on the global grid; ``wrap[d]``: dimension
    ``d`` is periodic."""
    T, Pf = state["T"], state["Pf"]
    q = [state["qDx"], state["qDy"], state["qDz"]]
    h = (p["dx"], p["dy"], p["dz"])
    dev = T.device
    cell_inner = torch.ones(T.shape, dtype=torch.bool, device=dev)
    for d in range(3):
        cell_inner &= _edges(T.shape, d, dev, wrap[d])
    # Fluxes move on faces away from the walls, and off the boundary cells
    # of the other two dimensions.
    face_mask = []
    for d in range(3):
        m = _edges(q[d].shape, d, dev, wrap[d])
        for e in range(3):
            if e != d:
                m &= _edges(q[d].shape, e, dev, wrap[e])
        face_mask.append(m)
    th, beta = p["theta"], p["beta"]
    for _ in range(nsteps):
        for _ in range(p["npt"]):
            for d in range(3):
                f = -_face_grad(Pf, d, h[d], wrap[d])
                if d == 2:
                    f = f + p["buoy"] * _face_avg(T, d, wrap[d])
                q[d] = torch.where(face_mask[d], q[d] + th * (f - q[d]), q[d])
            div = sum((_upper(q[d], d, wrap[d]) - _lower(q[d], d, wrap[d])) / h[d]
                      for d in range(3))
            Pf = Pf - beta * div
        lap = torch.zeros_like(T)
        adv = torch.zeros_like(T)
        for d in range(3):
            back, fwd = torch.roll(T, 1, d), torch.roll(T, -1, d)
            lap += (back + fwd - 2 * T) / (h[d] * h[d])
            adv += (_lower(q[d], d, wrap[d]).clamp_min(0.0) * ((T - back) / h[d])
                    + _upper(q[d], d, wrap[d]).clamp_max(0.0) * ((fwd - T) / h[d]))
        T = torch.where(cell_inner, T + p["dt"] * (p["lam"] * lap - adv / p["phi"]), T)
    return {"T": T, "Pf": Pf, "qDx": q[0], "qDy": q[1], "qDz": q[2]}


def flops_per_cell_step(cfg: dict) -> int:
    """Floating-point operations of one time step at one cell, as written
    in `steps`: 29 a relaxation (the fused kernel's count: three flux
    updates and the divergence), and 50 for the temperature update (15 for
    the Laplacian, 10 a dimension for the upwind advection, 5 to combine)."""
    return 29 * int(cfg["physics"]["npt"]) + 50


def advance(cfg: dict, state: dict, p: dict, call: dict, wrap) -> dict:
    """One call of the traffic: ``call["steps"]`` time steps."""
    return steps(state, p, call["steps"], wrap)
