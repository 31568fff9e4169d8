"""Candidate enumeration + the static cost-model prior of the autotuner.

Counterpart of the JAX package's ``tuning/space.py``.  The search space is
every performance knob the model entry points already expose as kwargs —
``fused_k`` (with tile candidates from each Hopper kernel's neighbourhood
of its auto pick, `tile_ladder`), ``exchange_every``, ``pipelined`` (where
the ring/interior split is admissible), ``coalesce`` (multi-field cadences
only) — enumerated at one ``(model, local size, dtype, topology, batch)``
point.  A tuned config is therefore a PURE SUBSTITUTION of existing
kwargs: it changes the *schedule* of a run, never its results.
Model-config parameters that change numerics — the porous ``npt`` — are
part of the cache KEY, never of the searched space.

The prior, per candidate:

* **shared memory per block vs the Hopper ladder** — each kernel module's
  ``fused_support_error`` (k, extents, dtype) and its tile check
  (``tile_fits``/``check_tile``: the block's plane rings within
  ``_SMEM_PER_BLOCK``, the window plane within the threads' slots) reject
  a candidate before it can reach measurement;
* **modeled HBM bytes** — the x-marching wavefront's traffic per step:
  each field read once through its window planes (the owned ``(by, bz)``
  tile plus ``k`` cells a side, `window_plane`) and, per x segment, ``k``
  recomputed planes past each interior end, divided by the temporal
  blocking depth;
* **collective count** — hops per step (amortized by the slab cadence,
  combined by coalescing) breaks ties with a nominal per-hop latency.

The nominal constants (`RANK_BW_BYTES_PER_S`, the H100 SXM HBM3 rate, and
`RANK_HOP_SECONDS`) only ORDER candidates — the measured short runs decide
the winner — so their absolute calibration is deliberately unimportant.

The port's ``fused_tile=(bx, by)`` is the kernel's x segment and y tile
(``bz`` the first ladder ``bz`` that fits beside ``by``); JAX's is a TPU
(x, y) block tile under its VMEM ladder.
"""

from __future__ import annotations

import importlib

import torch

#: Nominal ranking constants (H100 SXM HBM3 rate, a nominal hop latency;
#: ordering-only, see module doc).
RANK_BW_BYTES_PER_S = 3.35e12
RANK_HOP_SECONDS = 1e-5

#: The only fields a tuned config may carry — each one an existing
#: ``make_multi_step`` kwarg (pure substitution; the diffusion cadence
#: exchanges one field and takes no ``coalesce``, and its space never sets
#: one).
CONFIG_FIELDS = ("fused_k", "fused_tile", "exchange_every", "pipelined",
                 "coalesce")

#: Per-model enumeration facts: the kernel module behind ``fused_k``, the
#: streamed-field census of the roofline model (fields read+written / read
#: only per unit step), whether the cadence exchanges >= 2 fields (the
#: ``coalesce`` knob is definitionally multi-field), and the tile-split
#: stagger of the pipelined gate.
MODELS = {
    "diffusion3d": dict(
        kernel="implicitglobalgrid_tpu_torch.ops.fused_stencil",
        module="implicitglobalgrid_tpu_torch.models.diffusion3d",
        fields_rw=1, fields_ro=1, exchanged_fields=1, stagger=0,
    ),
    "acoustic3d": dict(
        kernel="implicitglobalgrid_tpu_torch.ops.fused_leapfrog",
        module="implicitglobalgrid_tpu_torch.models.acoustic3d",
        fields_rw=4, fields_ro=0, exchanged_fields=4, stagger=1,
    ),
    "porous_convection3d": dict(
        kernel="implicitglobalgrid_tpu_torch.ops.fused_pt",
        module="implicitglobalgrid_tpu_torch.models.porous_convection3d",
        fields_rw=4, fields_ro=1, exchanged_fields=4, stagger=1,
    ),
}

#: Temporal-blocking depths probed per point (the kernels' envelope admits
#: even k in [2, 8]; ``exchange_every`` reuses the shallow rungs).
K_LADDER = (2, 4, 6, 8)
EXCHANGE_LADDER = (2, 4)

#: Explicit tiles enumerated per k beyond the auto pick: the kernel's own
#: neighbourhood (`tile_ladder`), deduplicated against the auto pick,
#: capped to keep the space measurable.
TILES_PER_K = 2


def kernel_module(model: str):
    return importlib.import_module(MODELS[model]["kernel"])


def model_module(model: str):
    return importlib.import_module(MODELS[model]["module"])


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a torch dtype: a torch dtype, or a name such as
    ``"float32"`` (a cache key's) or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype)).removeprefix("torch.")
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"{dtype!r} names no torch dtype")
    return got


def itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _active_dims(gg):
    from ..ops.halo import dim_has_halo_activity

    if gg is None:
        return ()
    return tuple(d for d in range(3) if dim_has_halo_activity(gg, d))


def _deep_halo_ok(w: int, gg, active) -> bool:
    return all(gg.overlaps[d] >= 2 * w for d in active)


def _device(gg, device):
    if device is not None:
        return torch.device(device)
    return gg.device if gg is not None else torch.device("cpu")


def launch_tile(model: str, shape, k: int, dtype, tile=None, device=None):
    """The kernel's ``(bx, by, bz)`` for a candidate's ``fused_tile=(bx,
    by)`` (``bz`` from the ladder beside ``by``), or its auto pick on
    ``device`` (`default_tile`; the card's occupancy on CUDA)."""
    mod, size = kernel_module(model), itemsize(dtype)
    if tile is None:
        return tuple(mod.default_tile(shape, k, size, torch.device(device or "cpu")))
    bx, by = (int(b) for b in tile)
    bz = mod.tile_for(shape, k, size, by=by)[2]
    return mod.check_tile(shape, k, (bx, by, bz), size)


def tile_ladder(model: str, shape, k: int, dtype, device=None):
    """``(auto, tiles)``: the auto pick's ``(bx, by)`` on ``device`` and
    up to `TILES_PER_K` explicit ``(bx, by)`` candidates around it.

    The neighbourhood: the auto ``by`` with twice and half as many x
    segments (the staggered kernels' auto pick marches all of x in one
    segment, so this is where they get cut), then the kernel's other ladder
    ``by`` values at the auto x segment.  Each is filtered by the module's
    own tile check (shared memory, slots) and deduplicated against the
    auto pick.  On CUDA the auto pick reads the card's occupancy, so the
    list is a function of the card model and the shared geometry — the
    same on every rank of a job.
    """
    shape = tuple(int(x) for x in shape)
    mod = kernel_module(model)
    bx0, by0, _ = launch_tile(model, shape, k, dtype, device=device)
    segs = -(-shape[0] // bx0)
    wanted = [(-(-shape[0] // s), by0) for s in (2 * segs, segs // 2) if s >= 1]
    wanted += [(bx0, by) for by, _ in mod._TILES]
    out = []
    for t in wanted:
        if t == (bx0, by0) or t in out:
            continue
        try:
            launch_tile(model, shape, k, dtype, t)
        except ValueError:
            continue
        out.append(t)
        if len(out) >= TILES_PER_K:
            break
    return (bx0, by0), out


def modeled_cost(model: str, shape, dtype, config: dict, *, gg=None,
                 npt: int | None = None, device=None, faces: bool = False) -> dict:
    """The static prior of one candidate: modeled HBM ``bytes_per_step``
    (per time step — per PT iteration for porous, times ``npt``), the
    kernel's shared memory per block ``smem_bytes`` (0 for a plain-torch
    cadence), and ``collectives_per_step``.

    The kernels' traffic model of the port, shared by the tuner's ranking
    and the cost model (`analysis.costmodel`, `analysis.reconcile`).  Every
    field counts ``shape``'s cells; ``faces=True`` counts each staggered
    field at its ``n+1`` face shape instead (the real arrays; the ranking
    does not need it)."""
    facts = MODELS[model]
    n0, n1, n2 = shape
    vol = n0 * n1 * n2
    size = itemsize(dtype)
    rw = [vol] * facts["fields_rw"]
    if faces and facts["stagger"]:
        rw[1:] = [vol // shape[a] * (shape[a] + 1) for a in range(3)]
    rw, ro = sum(rw), vol * facts["fields_ro"]
    # npt scales the porous traffic linearly; it is constant across the
    # candidates of one point, so ranking survives an unknown (None) npt
    iters = (int(npt) if model == "porous_convection3d" and npt is not None
             else 1)
    k = config.get("fused_k")
    w = k or config.get("exchange_every", 1) or 1
    smem = 0
    if k:
        mod = kernel_module(model)
        tile = launch_tile(model, shape, k, dtype, config.get("fused_tile"),
                           _device(gg, device))
        ey, ez = mod.window_plane(shape, k, tile)
        # each x segment recomputes k planes past each of its interior ends
        xs = (n0 + 2 * k * (-(-n0 // tile[0]) - 1)) / n0
        redundancy = xs * (ey * ez) / float(min(tile[1], n1) * min(tile[2], n2))
        # One windowed read + one owned write per field per k steps.
        bytes_per = (rw * (1 + redundancy) + ro * redundancy) * size / k
        smem = int(mod.window_bytes(shape, k, tile, size))
    else:
        bytes_per = (2 * rw + ro) * size
    active = _active_dims(gg)
    if active:
        nf = facts["exchanged_fields"]
        per_exchange = 2 * len(active) * (
            nf if config.get("coalesce") is False or nf < 2 else 1
        )
        coll = per_exchange / float(w)
    else:
        coll = 0.0
    return {
        "bytes_per_step": round(bytes_per * iters, 2),
        "smem_bytes": smem,
        "collectives_per_step": round(coll * iters, 4),
    }


def modeled_seconds(modeled: dict) -> float:
    """The ranking proxy (ordering-only, see module doc)."""
    return (
        modeled["bytes_per_step"] / RANK_BW_BYTES_PER_S
        + modeled["collectives_per_step"] * RANK_HOP_SECONDS
    )


def candidate_space(model: str, shape, dtype, *, nsteps: int, gg=None,
                    npt: int | None = None, device=None):
    """``(candidates, rejected)`` for one tuning point, deterministic order.

    ``candidates``: admissible ``{"config", "modeled"}`` dicts, the default
    (empty) config always FIRST — it is always measured, so the winner can
    never be worse than what the caller would have run untuned.
    ``rejected``: configs the prior refused with the reason (kernel
    envelope, divisibility, deep-halo precondition) — the dry-run table's
    left half and the ``tune.candidates_pruned`` census.  Tiles are planned
    for ``device`` (default: the grid's, else the CPU).
    """
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; tunable: {sorted(MODELS)}")
    shape = tuple(int(x) for x in shape)
    dtype = torch_dtype(dtype)
    device = _device(gg, device)
    facts = MODELS[model]
    active = _active_dims(gg)
    porous = model == "porous_convection3d"
    kmod = kernel_module(model)

    bases: list[dict] = [{}]
    rejected: list[dict] = []

    def _steps_ok(w: int) -> str | None:
        if porous:
            # the PT cadence chunks npt, not nsteps (`_pt_schedule`)
            if npt is not None and w > int(npt):
                return f"w={w} exceeds npt={npt}: no PT chunk to amortize"
            return None
        if nsteps % w != 0:
            return f"nsteps={nsteps} is not a multiple of {w}"
        return None

    # -- exchange_every rungs (slab cadence without the kernel) -----------
    for w in EXCHANGE_LADDER:
        cfg = {"exchange_every": w}
        if not active:
            rejected.append({"config": cfg, "error": "no halo activity: "
                             "nothing to amortize"})
            continue
        err = _steps_ok(w)
        if err is None and not _deep_halo_ok(w, gg, active):
            err = f"deep-halo precondition overlap >= {2 * w} not met"
        if err:
            rejected.append({"config": cfg, "error": err})
            continue
        bases.append(cfg)

    # -- fused_k x tile ladder x pipelined --------------------------------
    for k in K_LADDER:
        err = _steps_ok(k)
        if err is None and porous and npt is not None:
            from ..models.porous_convection3d import _pt_schedule

            if not _pt_schedule(int(npt), k)[1]:
                err = f"npt={npt} leaves no even kernel chunk at w={k}"
        if err is None and active and not _deep_halo_ok(k, gg, active):
            err = f"deep-halo precondition overlap >= {2 * k} not met"
        if err is None:
            # the envelope gate: even k in [2, 8], extents, dtype — the
            # same check the kernel call raises on
            err = kmod.fused_support_error(shape, k, dtype)
        if err is None:
            try:  # the auto tile must fit shared memory and the slots
                launch_tile(model, shape, k, dtype, device=device)
            except ValueError as e:
                err = str(e)
        if err:
            rejected.append({"config": {"fused_k": k}, "error": err})
            continue
        _auto, tiles = tile_ladder(model, shape, k, dtype, device)
        for tile in [None] + tiles:
            cfg = {"fused_k": k}
            if tile is not None:
                cfg["fused_tile"] = list(tile)
            bx, by = tile if tile is not None else (None, None)
            split_err = _split_error(model, shape, k, dtype, bx, by, gg,
                                     npt=npt, device=device)
            if split_err is None:
                bases.append({**cfg, "pipelined": False})
                bases.append({**cfg, "pipelined": True})
            else:
                bases.append(cfg)

    # -- coalesce twins (multi-field cadences on communicating grids) -----
    out = list(bases)
    if facts["exchanged_fields"] >= 2 and active:
        out += [{**cfg, "coalesce": False} for cfg in bases]

    candidates = [
        {"config": cfg,
         "modeled": modeled_cost(model, shape, dtype, cfg, gg=gg, npt=npt,
                                 device=device)}
        for cfg in out
    ]
    return candidates, rejected


def _split_error(model, shape, k, dtype, bx, by, gg, npt=None, device=None):
    """Why the ring/interior pipelined split cannot run, or None — the
    model's own gate (`models.*.pipelined_support_error`)."""
    mod = model_module(model)
    kw = {"npt": npt} if model == "porous_convection3d" else {}
    try:
        return mod.pipelined_support_error(shape, k, dtype, bx, by, gg=gg,
                                           device=device, **kw)
    except Exception as e:  # a gate crash must reject, not sink the sweep
        return f"{type(e).__name__}: {e}"


def prune(candidates, topk: int, *, smem_budget_bytes: int | None = None):
    """Cost-model pruning: ``(survivors, cut)``.

    The default config (index 0) ALWAYS survives; the rest rank by
    `modeled_seconds` and the best ``topk - 1`` join it.  An explicit
    ``smem_budget_bytes`` additionally refuses candidates whose modeled
    shared memory per block exceeds it — the enumeration's tile check
    already enforces the kernel's limit, this parameter lets callers (and
    the pruning-correctness test) tighten it on injected candidates.
    ``cut`` lists the refused candidates with reasons: a candidate over
    the budget must NEVER reach measurement.
    """
    if not candidates:
        return [], []
    if topk < 1:
        raise ValueError(f"topk must be >= 1 (got {topk})")
    default, rest = candidates[0], candidates[1:]
    cut = []
    kept = []
    for c in rest:
        if (
            smem_budget_bytes is not None
            and c["modeled"].get("smem_bytes", 0) > smem_budget_bytes
        ):
            cut.append({**c, "error": (
                f"modeled shared memory {c['modeled']['smem_bytes']} B per "
                f"block exceeds the budget {smem_budget_bytes} B")})
        else:
            kept.append(c)
    ranked = sorted(kept, key=lambda c: modeled_seconds(c["modeled"]))
    survivors = [default] + ranked[: max(0, topk - 1)]
    cut += [{**c, "error": "ranked below topk by the modeled prior"}
            for c in ranked[max(0, topk - 1):]]
    return survivors, cut
