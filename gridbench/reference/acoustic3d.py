"""Plain reference of 3-D acoustic waves by staggered-grid velocity-pressure
FDTD (explicit leapfrog; ParallelStencil.jl's multi-XPU acoustic miniapp,
``miniapps/acoustic_waves_multixpu``), on the global grid, and the
benchmark's inputs for it.

P lives at cell centres, Vx, Vy and Vz on the faces of their own axis (face
``j`` between cells ``j-1`` and ``j``).  A step is

    V -= dt/rho * grad(P)     on inner faces
    P -= dt*K * div(V)        on every cell, from the new V

In a non-periodic dimension the first and last faces (rigid walls) keep
their values, and so do the faces along the walls (the faces of a boundary
cell of another dimension); a periodic dimension wraps.  Plain torch on
whole arrays; imports nothing of the program.

Departures from the miniapp: the constants are the program model's (K 1,
rho 1, a 10 x 10 x 10 box, dt = min(dx, dy, dz)/c/2), the pressure pulse is
the program model's Gaussian, and the inputs carry seeded noise on every
field; the configuration's ``assumed`` says why.
"""

from __future__ import annotations

import torch

from ..layout import Layout, seeded_slabs

#: the fields a call advances, in the program's state order
EVOLVING = ("P", "Vx", "Vy", "Vz")
#: one more entry than cells along a dimension, per field (a periodic
#: dimension has as many faces as cells)
STAGGER = {"P": (0, 0, 0), "Vx": (1, 0, 0), "Vy": (0, 1, 0), "Vz": (0, 0, 1)}


def params(cfg: dict, layout: Layout) -> dict:
    """The scalars of the run, worked out from the configuration."""
    ph = cfg["physics"]
    g = layout.global_shape()
    dx, dy, dz = (ph[k] / (n - 1) for k, n in zip(("lx", "ly", "lz"), g))
    c = (ph["K"] / ph["rho"]) ** 0.5
    return {"K": ph["K"], "rho": ph["rho"], "dx": dx, "dy": dy, "dz": dz,
            "dt": min(dx, dy, dz) / c / 2.0}


def initial(cfg: dict, layout: Layout, seed: int, device, dtype=torch.float32) -> dict:
    """The fields over the global grid: P a Gaussian pulse of 100 at the
    centre of the box with seeded noise, the velocities seeded noise, all
    drawn on the device (`layout.seeded_slabs`)."""
    ph, ini = cfg["physics"], cfg["init"]
    p = params(cfg, layout)
    lx, ly, lz = ph["lx"], ph["ly"], ph["lz"]
    cells = layout.global_shape()
    idx = [torch.arange(n, device=device, dtype=torch.float32) for n in cells]
    Y = (idx[1] * p["dy"]).reshape(1, -1, 1)
    Z = (idx[2] * p["dz"]).reshape(1, 1, -1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    P = torch.empty(cells, dtype=dtype, device=device)
    for xs, noise in seeded_slabs(gen, cells, device, torch.randn):
        X = (idx[0][xs] * p["dx"]).reshape(-1, 1, 1)
        pulse = 100 * torch.exp(-((X - lx / 2) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 2) ** 2)
        P[xs] = pulse + ini["p_noise"] * noise
    out = {"P": P}
    for name in ("Vx", "Vy", "Vz"):
        shape = tuple(n + s for n, s in zip(cells, layout.stagger(STAGGER[name])))
        V = torch.empty(shape, dtype=dtype, device=device)
        for xs, noise in seeded_slabs(gen, shape, device, torch.randn):
            V[xs] = ini["v_noise"] * noise
        out[name] = V
    return out


def _edges(shape, d: int, device, wrap: bool):
    """A mask over ``shape`` that is False on the first and last entries
    along ``d`` unless the dimension wraps."""
    m = torch.ones(shape, dtype=torch.bool, device=device)
    if not wrap:
        m.narrow(d, 0, 1).fill_(False)
        m.narrow(d, shape[d] - 1, 1).fill_(False)
    return m


def _face_diff(A, d: int, wrap: bool):
    """A[j] - A[j-1] on the faces along ``d`` (the wall faces of a
    non-periodic dimension read 0 and are masked by the caller)."""
    if wrap:
        return A - torch.roll(A, 1, d)
    inner = A.narrow(d, 1, A.shape[d] - 1) - A.narrow(d, 0, A.shape[d] - 1)
    z = torch.zeros_like(A.narrow(d, 0, 1))
    return torch.cat([z, inner, z], d)


def _cell_diff(V, d: int, wrap: bool):
    """The face above each cell along ``d`` less the face below it."""
    if wrap:
        return torch.roll(V, -1, d) - V
    return V.narrow(d, 1, V.shape[d] - 1) - V.narrow(d, 0, V.shape[d] - 1)


def steps(state: dict, p: dict, nsteps: int, wrap) -> dict:
    """``nsteps`` leapfrog steps on the global grid; ``wrap[d]``: dimension
    ``d`` is periodic."""
    # float32 stays float32 on the card: no TF32 anywhere in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = state["P"]
    V = [state["Vx"], state["Vy"], state["Vz"]]
    h = (p["dx"], p["dy"], p["dz"])
    # Velocities move on faces away from the walls, and off the boundary
    # cells of the other two dimensions.
    face_mask = []
    for d in range(3):
        m = torch.ones(V[d].shape, dtype=torch.bool, device=P.device)
        for e in range(3):
            m &= _edges(V[d].shape, e, P.device, wrap[e])
        face_mask.append(m)
    a = [p["dt"] / (p["rho"] * hd) for hd in h]
    b = p["dt"] * p["K"]
    for _ in range(nsteps):
        for d in range(3):
            V[d] = torch.where(face_mask[d], V[d] - a[d] * _face_diff(P, d, wrap[d]), V[d])
        div = sum(_cell_diff(V[d], d, wrap[d]) / h[d] for d in range(3))
        P = P - b * div
    return {"P": P, "Vx": V[0], "Vy": V[1], "Vz": V[2]}


def flops_per_cell_step(cfg: dict) -> int:
    """Floating-point operations of one step at one cell, as written in
    `steps`: a difference, a scaling and a subtraction for each of the three
    velocities (9), and for the pressure three differences, three divisions,
    two additions, the scaling and the subtraction (10)."""
    return 19


def advance(cfg: dict, state: dict, p: dict, call: dict, wrap) -> dict:
    """One call of the traffic: ``call["steps"]`` time steps."""
    return steps(state, p, call["steps"], wrap)
