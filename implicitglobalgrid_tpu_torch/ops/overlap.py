"""Communication/computation overlap: `hide_communication` and the tile split.

Counterpart of the JAX package's ``ops/overlap.py``.  The reference hides
its halo exchange behind the interior update with high-priority CUDA streams
(``update_halo.jl``) and ParallelStencil's ``@hide_communication``: compute
the boundary slabs first, start the exchange, compute the interior while the
exchange is in flight.  The port does exactly that, eagerly, with streams:

* `hide_communication` wraps a per-block stencil update so that the boundary
  slabs are computed first, the slab exchange starts from them on the
  communication stream (`ops.halo.begin_slab_exchange`), the interior is
  computed on the compute stream meanwhile, and the received planes land last
  (`ops.halo.finish_slab_exchange`).  It equals ``update_halo(*update_fn(
  *fields))`` bit for bit: every output point is computed by the same
  elementwise operations, only on a cropped window.
* The tile split of the fused kernels (``TILE_SELS`` and the maps below) cuts
  a kernel launch into a ring pass over the tiles that own the x/y slab
  exchange's send planes and a mid pass over the rest; the pipelined group
  schedule (`models._fused`) starts the exchange from the ring pass.  The CUDA
  kernels mirror `tile_subset_map` (``csrc/staggered.cuh``: ``subset_tile``),
  with the same selector codes.

Contract for ``update_fn``: a pure, translation-invariant stencil update of
its field arguments (output element ``i`` depends on input elements
``i-radius .. i+radius``), returning the new field(s) with the same shapes.
It is called on cropped windows of the blocks, so it must not hard-code
sizes, and on ``meta`` tensors to learn its output shapes, once per input
shapes and dtypes.  A batched (ensemble) update (`overlapped` with ``lead
= 1``, the models' ``batch=True``) takes ``(B, *block)`` fields and is
written with ``...`` slices, so that grid dimension ``d`` is its axis ``d +
lead``.
"""

from __future__ import annotations

import torch

from ..parallel import grid as _grid
from ..parallel.topology import NDIMS
from ..utils import profiling as _profiling
from . import halo as _halo

#: Valid tile-subset selectors: "all", or ring/mid over the split dims —
#: "0" (x-edge segments), "1" (y-edge tiles), "01" (the full ring).  A
#: selector's index is its code in the CUDA kernels.
TILE_SELS = ("all", "ring0", "mid0", "ring1", "mid1", "ring01", "mid01")


def tile_subset_count(sel: str, ncx: int, ncy: int) -> int:
    """Number of tiles in subset ``sel`` of an ``(ncx, ncy)`` tile grid."""
    if sel == "all":
        return ncx * ncy
    if sel == "ring0":
        return 2 * ncy
    if sel == "mid0":
        return (ncx - 2) * ncy
    if sel == "ring1":
        return 2 * ncx
    if sel == "mid1":
        return ncx * (ncy - 2)
    if sel == "ring01":
        return 2 * ncy + 2 * (ncx - 2)
    if sel == "mid01":
        return (ncx - 2) * (ncy - 2)
    raise ValueError(f"unknown tile subset {sel!r}; one of {TILE_SELS}")


def tile_subset_map(sel: str, ncx: int, ncy: int):
    """Index map for subset ``sel``: ``t_of(i) -> flat tile index``.

    ``i`` iterates ``[0, tile_subset_count(sel, ...))``; the flat index is
    ``ix * ncy + iy`` (x segment ``ix``, y tile ``iy``).  Python ints only:
    ``csrc/staggered.cuh``'s ``subset_tile`` is the kernels' copy.
    """
    if sel == "all":
        return lambda i: i
    if sel == "ring0":
        # x-edge segments: ix=0 then ix=ncx-1, all iy.
        return lambda i: i if i < ncy else (ncx - 1) * ncy + (i - ncy)
    if sel == "mid0":
        return lambda i: ncy + i
    if sel == "ring1":
        # y-edge tiles: alternating iy=0 / iy=ncy-1 per ix.
        return lambda i: (i // 2) * ncy + (i % 2) * (ncy - 1)
    if sel == "mid1":
        return lambda i: (i // (ncy - 2)) * ncy + 1 + i % (ncy - 2)
    if sel == "ring01":
        # the full ring: both x-edge segments, then the two y-edge tiles of
        # the interior x range (alternating iy=0 / iy=ncy-1).
        def t_of(i):
            if i < ncy:
                return i
            if i < 2 * ncy:
                return (ncx - 1) * ncy + (i - ncy)
            j = i - 2 * ncy
            return (1 + j // 2) * ncy + (j % 2) * (ncy - 1)

        return t_of
    if sel == "mid01":
        return lambda i: (1 + i // (ncy - 2)) * ncy + 1 + i % (ncy - 2)
    raise ValueError(f"unknown tile subset {sel!r}; one of {TILE_SELS}")


def tile_grid(n01, tile) -> tuple[int, int]:
    """``(ncx, ncy)``: x segments and y tiles of a block's ``(n0, n1)`` at the
    tile ``(bx, by, ...)``; the last of each may be ragged (the kernels'
    ``Axis::make`` clips it)."""
    return -(-n01[0] // tile[0]), -(-n01[1] // tile[1])


def tile_split_error(shape, k: int, width: int, bx: int, by: int, H: int,
                     active_dims, *, ox: int, oy: int) -> str | None:
    """Why the ring/mid tile split cannot pipeline this config, or None.

    The port's geometry: an x "tile" is an x segment of ``bx`` planes (the
    kernels' ``blockIdx.z``), a y tile ``by`` rows, and ``H`` is the window
    halo beyond the owned tile (``k`` in every kernel: ``Axis::make``).  The
    last segment (tile) may be ragged: it owns ``n0 - (ncx-1)*bx`` planes.
    ``active_dims``: the x/y grid dimensions with halo activity (subset of
    ``(0, 1)``).  ``ox``/``oy``: the largest shape-aware overlap of any
    exchanged field along x/y (grid overlap, +1 for staggered fields: the
    staggered kernels' one extra face read).  Conditions, per active dim,
    with ``L`` the smaller of the first and the last tile's owned extent:

    * at least 3 tiles (a ring needs two edges plus a non-empty interior);
    * the slab exchange's send and keep planes (indices ``< o`` from either
      edge) lie inside the ring tiles' owned planes: ``ox <= L`` (at the top
      of a staggered field one plane stricter than it needs: the top tile
      also owns face ``n``);
    * the interior tiles' windows stay clear of the ``width`` outermost
      planes, the planes the slab exchange refreshes: ``L >= k + width``
      along x, ``L >= H + width`` along y.

    Both passes also need >= 2 tiles (the JAX kernels' double-buffered DMA
    drain needs it; kept so both packages admit the same splits).
    """
    n0, n1 = shape[0], shape[1]
    if not active_dims:
        return "no x/y halo activity: nothing for the interior pass to overlap"
    ncx, ncy = tile_grid((n0, n1), (bx, by))
    if 0 in active_dims:
        lx = min(bx, n0 - (ncx - 1) * bx)
        if ncx < 3:
            return f"x split needs >= 3 x segments (ncx={ncx} at bx={bx})"
        if ox > lx:
            return (
                f"x send/keep planes reach past the ring segments: overlap "
                f"{ox} > {lx} (bx={bx}, last segment {n0 - (ncx - 1) * bx})"
            )
        if lx < k + width:
            return (
                f"interior windows reach the refreshed x planes: segment "
                f"{lx} < k+width={k + width}"
            )
    if 1 in active_dims:
        ly = min(by, n1 - (ncy - 1) * by)
        if ncy < 3:
            return f"y split needs >= 3 y-tiles (ncy={ncy} at by={by})"
        if oy > ly:
            return (
                f"y send/keep planes reach past the ring tiles: overlap "
                f"{oy} > {ly} (by={by}, last tile {n1 - (ncy - 1) * by})"
            )
        if ly < H + width:
            return (
                f"interior windows reach the refreshed y planes: tile {ly} < "
                f"H+width={H + width}"
            )
    sel = tile_split_sel(active_dims)
    for kind in ("ring", "mid"):
        if tile_subset_count(kind + sel, ncx, ncy) < 2:
            return f"{kind}{sel} has < 2 tiles (ncx={ncx}, ncy={ncy})"
    return None


def tile_split_sel(active_dims) -> str:
    """The ring/mid selector suffix for the given active x/y dims."""
    return "".join(str(d) for d in sorted(active_dims))


def check_tile_subset(tile_sel: str, carry_in, n01, tile, outs_like):
    """Validate a tile-subset launch request (shared by the three kernels).

    ``n01``: a member block's ``(n0, n1)``.  ``outs_like``: tensors shaped
    like the launch's outputs, batched or not (what a ``mid*``
    ``carry_in`` must match).  Returns ``carry_in`` as a tuple, or None for
    a launch that allocates its outputs.
    """
    if tile_sel == "all":
        if carry_in is not None:
            raise ValueError("carry_in is only for 'mid*' tile-subset launches")
        return None
    if tile_sel not in TILE_SELS:
        raise ValueError(f"tile_sel {tile_sel!r} must be one of {TILE_SELS}")
    ncx, ncy = tile_grid(n01, tile)
    n = tile_subset_count(tile_sel, ncx, ncy)
    if n < 2:
        # The models gate admissibility through `tile_split_error`, so
        # reaching this is a caller bug.
        raise ValueError(
            f"tile subset {tile_sel!r} has {n} tiles on the ({ncx},{ncy}) "
            "tile grid; a subset launch needs >= 2"
        )
    if tile_sel.startswith("mid"):
        if carry_in is None:
            raise ValueError(
                "a 'mid*' launch needs carry_in: the matching 'ring*' "
                "launch's output tensor(s) to write the combined result into"
            )
        carry = tuple(carry_in) if isinstance(carry_in, (tuple, list)) else (carry_in,)
        if len(carry) != len(outs_like):
            raise ValueError(
                f"carry_in must hold the ring launch's {len(outs_like)} output(s); "
                f"got {len(carry)}"
            )
        for c, o in zip(carry, outs_like):
            if ((c.shape, c.dtype, c.device) != (o.shape, o.dtype, o.device)
                    or not c.is_contiguous()):
                raise ValueError(
                    f"carry_in tensor {tuple(c.shape)} {c.dtype} on {c.device} does not "
                    f"match the launch's output {tuple(o.shape)} {o.dtype} on {o.device}"
                )
        return carry
    if carry_in is not None:
        raise ValueError("carry_in is only for 'mid*' tile-subset launches")
    return None


def copy_subset(full, tile_sel: str, carry_in, n01, tile):
    """The plain versions' subset launch: the owned regions of the subset's
    tiles copied from ``full`` (the whole launch's outputs, batched or
    not; ``n01`` is a member block's) into ``carry_in`` or into fresh
    tensors (unset elsewhere, as the kernel leaves them).  Every z tile
    belongs to every subset, and a field one longer than the cells along x
    or y (a face field) takes its top face with the tile that reaches the
    block's top there."""
    outs = carry_in if carry_in is not None else tuple(torch.empty_like(a) for a in full)
    ncx, ncy = tile_grid(n01, tile)
    t_of = tile_subset_map(tile_sel, ncx, ncy)
    for i in range(tile_subset_count(tile_sel, ncx, ncy)):
        ix, iy = divmod(t_of(i), ncy)
        x0, y0 = ix * tile[0], iy * tile[1]
        x1, y1 = min(x0 + tile[0], n01[0]), min(y0 + tile[1], n01[1])
        for src, dst in zip(full, outs):
            xe = x1 + (src.shape[-3] - n01[0] if x1 == n01[0] else 0)
            ye = y1 + (src.shape[-2] - n01[1] if y1 == n01[1] else 0)
            dst[..., x0:xe, y0:ye, :].copy_(src[..., x0:xe, y0:ye, :])
    return tuple(outs)


def hide_communication(update_fn=None, *, radius: int = 1, exchange=None):
    """Wrap ``update_fn`` so its halo update overlaps its interior computation.

    ``exchange`` optionally lists which outputs get a halo update (default:
    every output that has a halo).  Equal, bit for bit, to
    ``update_halo(*update_fn(*fields))`` (``update_halo`` of the exchanged
    outputs); the outputs are new tensors.  Under autograd the forward is
    the overlapped update and the backward that of
    ``update_halo(*update_fn(*fields))`` (`fused_with_plain_grad`).
    """
    if update_fn is None:
        return lambda f: hide_communication(f, radius=radius, exchange=exchange)
    return overlapped(update_fn, radius, exchange, lead=0)


def overlapped(update_fn, radius: int, exchange, *, lead: int, coalesce=None):
    """`hide_communication`'s wrapper for fields with ``lead`` leading
    ensemble axes (0, or 1 for a batch: `models._batched`); ``coalesce`` as
    in `ops.halo.update_halo`."""
    # (single output?, [(shape, dtype)] of the outputs) per input signature:
    # the meta pass costs milliseconds of host time, so it runs once each.
    outputs: dict = {}

    def wrapped(*fields):
        single, out_meta, exchange_idx = _output_plan(update_fn, fields, exchange, outputs, lead)
        if not _halo.needs_grad(fields):
            out = _overlapped_update(update_fn, fields, radius, out_meta, exchange_idx, lead,
                                     coalesce)
        else:
            def plain(*f):
                out = list(_as_tuple(update_fn(*f)))
                ex = _halo.exchange([out[i] for i in exchange_idx], lead=lead, coalesce=coalesce)
                for i, A in zip(exchange_idx, ex):
                    out[i] = A
                return tuple(out)

            # The wrapper saves its inputs for the backward; copies keep them
            # from later in-place writes (porous exchanges the fluxes it
            # reads here once its PT loop ends).
            out = fused_with_plain_grad(
                lambda *f: _overlapped_update(update_fn, f, radius, out_meta, exchange_idx, lead,
                                              coalesce),
                plain)(*(f.clone() for f in fields))
        return out[0] if single else out

    wrapped.__wrapped__ = update_fn
    return wrapped


class _PlainGrad(torch.autograd.Function):
    """`fused_with_plain_grad`'s function: ``fast`` forward, ``plain``
    backward."""

    @staticmethod
    def forward(ctx, fast, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return tuple(fast(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad(), _halo.uncounted():
            out = ctx.plain(*inputs)
        live = [(o, g) for o, g in zip(out, grads) if o.requires_grad]
        wrt = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in live], wrt, [g for _, g in live],
                                       allow_unused=True) if live else [None] * len(wrt))
        return (None, None, *(next(got) if x.requires_grad else None for x in inputs))


def check_forward_only(what: str, tensors) -> None:
    """Raise `ValueError` for a kernel call that autograd would have to
    record: the kernels are forward-only, as the JAX package's Pallas
    kernels are, on every device (the plain versions that CPU tensors run
    would differentiate, the CUDA kernels not)."""
    if _halo.needs_grad(tensors):
        raise ValueError(
            f"{what} is forward-only and has no backward; its inputs require grad under "
            "grad mode. Differentiate a model cadence instead (make_multi_step(..., "
            "fused_k=k)): it runs the kernel in the forward and the plain cadence's "
            "groups in the backward (models._fused, fused_with_plain_grad), or call "
            "the kernel under torch.no_grad()."
        )


def fused_with_plain_grad(fast, plain):
    """``fast`` in the forward, the gradient of ``plain`` in the backward:
    the port's counterpart of the JAX package's ``fused_with_xla_grad``.

    ``fast(*inputs)`` and ``plain(*inputs)`` return tuples of tensors that
    agree up to rounding: a hand-written kernel group (the kernels are
    forward-only, as in JAX) or an overlapped update, and the plain torch
    code of the same steps and exchanges.  The forward runs ``fast`` under
    `torch.no_grad` and saves only the inputs; the backward recomputes
    ``plain`` on detached copies of them and returns `torch.autograd.grad`
    of it (rematerialization: one plain forward per backward, whose
    exchanges `ops.halo` does not count again: `uncounted`).  Every input
    that carries a gradient must be an argument, never a closure: what the
    functions close over is a constant to autograd.
    """
    return lambda *inputs: _PlainGrad.apply(fast, plain, *inputs)


def _routed_update(fast, plain, name: str):
    """A model's per-step update on a hand-written kernel: ``fast(*fields)``
    (the kernel's wrapper) inside the profiler range ``name``; under
    autograd (`ops.halo.needs_grad`) the same forward with ``plain``'s
    gradient (`fused_with_plain_grad`), its backward recomputing ``plain``
    inside the range too."""
    def scoped_plain(*fields):
        with _profiling.scope(name):
            return (plain(*fields),)

    with_grad = fused_with_plain_grad(lambda *f: (fast(*f),), scoped_plain)

    def update(*fields):
        with _profiling.scope(name):
            if _halo.needs_grad(fields):
                return with_grad(*fields)[0]
            return fast(*fields)

    return update


def _halo_dims(shapes, gg) -> list[int]:
    """Dimensions in which any of ``shapes`` exchanges a halo."""
    return [
        d for d in range(NDIMS)
        if _halo.dim_has_halo_activity(gg, d)
        and any(d < len(s) and _halo.ol(d, shape=s, gg=gg) >= 2 for s in shapes)
    ]


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _output_plan(update_fn, fields, exchange, outputs, lead):
    """``(single output?, [(shape, dtype)] of the outputs, indices of the
    exchanged outputs)`` of ``update_fn`` on ``fields`` (the meta pass runs
    once per input signature, cached in ``outputs``)."""
    gg = _grid.global_grid()
    key = tuple((tuple(f.shape), f.dtype) for f in fields)
    if key not in outputs:
        meta_out = update_fn(*(torch.empty_like(f, device="meta") for f in fields))
        outputs[key] = (isinstance(meta_out, torch.Tensor),
                        [(tuple(a.shape), a.dtype) for a in _as_tuple(meta_out)])
    single, out_meta = outputs[key]
    if exchange is not None:
        return single, out_meta, list(exchange)
    # Block shapes (a batched output's member's): grid dim d is axis d + lead.
    return single, out_meta, [
        i for i, (shape, _) in enumerate(out_meta)
        if any(_halo.ol(d, shape=shape[lead:], gg=gg) >= 2 for d in range(len(shape) - lead))
    ]


def _overlapped_update(update_fn, fields, radius, out_meta, exchange_idx, lead, coalesce):
    """The overlapped update (steps 1-4 below); returns the outputs as a
    tuple."""
    gg = _grid.global_grid()
    fields = tuple(fields)
    out_shapes = [shape[lead:] for shape, _ in out_meta]
    hdims = _halo_dims([out_shapes[i] for i in exchange_idx], gg)
    if not hdims:
        return _as_tuple(update_fn(*fields))

    # Slab width per halo dim: wide enough to contain every exchanged field's
    # send plane (index ol-1 / n-ol).
    W = {
        d: max(_halo.ol(d, shape=out_shapes[i], gg=gg) for i in exchange_idx
               if d < len(out_shapes[i]))
        for d in hdims
    }
    for d, w in W.items():
        for s in out_shapes:
            if d < len(s) and s[d] < 2 * w:
                raise ValueError(
                    f"hide_communication: local size {s[d]} in dimension {d} is too "
                    f"small for boundary-slab width {w}; use plain update_halo."
                )
        if radius > w:
            raise ValueError(
                f"hide_communication: stencil radius {radius} exceeds the boundary-"
                f"slab width {w} in dimension {d}."
            )

    # -- 1. boundary slabs of the new state (one pair per halo dim), written
    # straight into the outputs.  Input windows start at a common index
    # (edge-aligned) and each field's window also holds its stagger excess
    # over the smallest field, so cross-field index relations (Vx[1:] -
    # Vx[:-1] against P) hold on the windows as on the whole blocks.
    outs = [torch.empty(shape, dtype=dtype, device=fields[0].device) for shape, dtype in out_meta]
    for d in hdims:
        w, a = W[d], d + lead
        n_min = min(f.shape[a] for f in fields if a < f.dim())
        for lo in (True, False):
            win = []
            for f in fields:
                if a >= f.dim():
                    win.append(f)
                    continue
                e = min(w + radius + (f.shape[a] - n_min), f.shape[a])
                win.append(f.narrow(a, 0, e) if lo else f.narrow(a, f.shape[a] - e, e))
            for o, r in zip(outs, _as_tuple(update_fn(*win))):
                if a >= o.dim():
                    continue
                if lo:
                    o.narrow(a, 0, w).copy_(r.narrow(a, 0, w))
                else:
                    o.narrow(a, o.shape[a] - w, w).copy_(r.narrow(a, r.shape[a] - w, w))

    # -- 2. the exchange starts from the slabs (it reads only the send
    # planes, which lie inside them) on the communication stream.
    ex = [outs[i] for i in exchange_idx]
    pend = _halo.begin_slab_exchange(ex, hdims, width=1, lead=lead, coalesce=coalesce)

    # -- 3. the interior, on the compute stream meanwhile.
    int_in = list(fields)
    for d in hdims:
        int_in = [_crop(f, d + lead, W[d] - radius) for f in int_in]
    for o, r in zip(outs, _as_tuple(update_fn(*int_in))):
        dst, src = o, r
        for d in hdims:
            dst = _crop(dst, d + lead, W[d])
            src = _crop(src, d + lead, radius)
        dst.copy_(src)

    # -- 4. the received planes land on the assembled outputs.
    _halo.finish_slab_exchange(ex, pend)
    return tuple(outs)


def _crop(x, a: int, m: int):
    """``x`` without ``m`` planes at each end of tensor axis ``a``."""
    return x if a >= x.dim() else x.narrow(a, m, x.shape[a] - 2 * m)
