"""Batched (ensemble) execution: B independent simulations in one step.

Counterpart of the JAX package's ``models/_batched.py``.  Many users each
run a small or medium independent simulation; per-GPU throughput for that
workload comes from advancing B members together.  A batched field is
``(B, *block)`` on this rank's device: every rank holds all B members of ITS
block, on the same grid.  Members are independent problems: per-member
physics stays in per-member fields (each member carries its own Cp or
state), scalar `Params` are shared.

Where JAX gets the ensemble from ``jax.vmap``, the port writes the batch
axis out:

* the models' plain updates use ``...`` slices and negative dims, so one
  code path serves a block and a batch of blocks;
* the three CUDA kernels take a batch in one launch (the members fold into
  the launch grid: ``csrc/staggered.cuh``);
* the exchange (`update_halo` here, `ops.halo.exchange` with ``lead = 1``)
  moves each field's slab of all B members in ONE send/receive pair per side
  and dimension, so the collective budget does not grow with B (JAX's
  ``ppermute`` batching rule carries the batch inside the same hop).

Bit-exactness contract: a batched step equals, member for member and bit
for bit, B independent unbatched steps (``tests/test_torch_batched.py`` on
one and two gloo ranks; ``chip_smoke.py`` phase 8 on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import halo as _halo
from ..parallel import grid as _grid
from ..parallel.topology import NDIMS
from ..utils import resilience as _resilience


def batch_size(state) -> int:
    """The ensemble size B of a batched state tuple (leading-axis extent)."""
    leaf = state[0] if isinstance(state, (tuple, list)) else state
    return int(leaf.shape[0])


def batched_stencil(block_step, nfields: int, *, donate_argnums=()):
    """`igg.stencil` for a batched block step over ``nfields`` batched fields:
    ``block_step`` unchanged.  In the JAX package this vmaps a per-member
    step over the ensemble axis; the port's steps take the batch axis as it
    is (written with ``...`` slices), and every process already holds its own
    block, so there is nothing to map."""
    return block_step


def member_shape(A) -> tuple[int, ...]:
    """A batched field's block shape ``A.shape[1:]``; raises unless ``A`` is
    a batch ``(B, *block)`` of 3-D blocks (rank NDIMS + 1, B >= 1)."""
    if A.dim() != NDIMS + 1 or A.shape[0] < 1:
        raise ValueError(
            f"a batched field is (B, n0, n1, n2) with B >= 1 (rank {NDIMS + 1}); got shape "
            f"{tuple(A.shape)}"
        )
    return tuple(A.shape[1:])


def check_batched(fields) -> int:
    """Validate a batched state's fields (`member_shape`, one B for all);
    returns B."""
    for A in fields:
        member_shape(A)
    sizes = {A.shape[0] for A in fields}
    if len(sizes) != 1:
        raise ValueError(f"the batched fields hold different numbers of members: {sorted(sizes)}")
    return sizes.pop()


def update_halo(*fields, width: int = 1, coalesce: bool | None = None):
    """`ops.halo.update_halo` for batched fields: every member's halo planes
    in place, each dimension one send/receive pair per side and field (or,
    coalesced, per dtype word width) for all B members.  Returns the field
    for one argument, a tuple for several; differentiable like the
    unbatched exchange."""
    _grid.check_initialized()
    gg = _grid.global_grid()
    if not fields:
        raise ValueError("update_halo requires at least one field.")
    if width < 1:
        raise ValueError(f"width must be >= 1 (got {width})")
    check_batched(fields)
    _halo._validate_fields(fields, gg, [member_shape(A) for A in fields])
    out = _halo.exchange(fields, width=width, lead=1, coalesce=coalesce)
    return out[0] if len(out) == 1 else out


def stack_fields(*fields):
    """Stack B same-shaped block fields into one batched field ``(B, ...)``
    (on their device; the inverse of `member_field`)."""
    _grid.check_initialized()
    if not fields:
        raise ValueError("stack_fields requires at least one field.")
    ndims = tuple(f.dim() for f in fields)
    if len(set(ndims)) != 1:
        raise ValueError(f"stack_fields: mixed ranks {ndims}")
    return torch.stack(fields)


def stack_states(states):
    """Stack B state tuples (one per member) into one batched state tuple."""
    states = [tuple(s) for s in states]
    nf = len(states[0])
    if any(len(s) != nf for s in states):
        raise ValueError("stack_states: members have different field counts")
    return tuple(stack_fields(*(s[i] for s in states)) for i in range(nf))


def member_field(A, k: int):
    """Member ``k``'s block field out of a batched field: a copy (JAX's
    arrays are immutable, so an in-place `update_halo` on a member must never
    write into the batch)."""
    _grid.check_initialized()
    if A.dim() < 2:
        raise ValueError(f"member_field needs a batched field, got rank {A.dim()}")
    return A[k].clone()


def member_state(state, k: int):
    """Member ``k``'s state tuple out of a batched state tuple (copies)."""
    return tuple(member_field(A, k) for A in state)


def set_member_state(batched, state, k: int):
    """Write single-member ``state`` into slot ``k`` of ``batched`` in place
    (the serving pool's admit; cast to the batch's dtype) and return the
    batched tuple."""
    _grid.check_initialized()
    for B, A in zip(batched, state):
        B[k].copy_(A)
    return tuple(batched)


def _max_over_ranks(flags):
    """Elementwise max of a per-rank vector over every rank: one
    all-reduce, whatever B."""
    gg = _grid.global_grid()
    if gg.nprocs > 1:
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    return flags


def check_members_finite(state) -> np.ndarray:
    """Per-member NaN/Inf probe of a batched state: boolean ``(B,)`` array,
    True where the member holds a non-finite value in any field on any rank.
    One all-reduce of a ``(B,)`` flag vector, so member k's fault never
    taints the verdict on member j, and every rank takes the same one.
    Each field is read once (`utils.resilience.nonfinite_flags`; the
    serving loop probes its whole pool every round)."""
    _grid.check_initialized()
    nb = check_batched(state)
    bad = torch.zeros(nb, dtype=torch.int32, device=state[0].device)
    for A in state:
        flags = _resilience.nonfinite_flags(A, per_member=True)
        bad = torch.maximum(bad, flags.to(torch.int32))
    return _max_over_ranks(bad).cpu().numpy() > 0


def select_members(mask, new_state, old_state):
    """Per-member select over batched state tuples: member ``b`` takes
    ``new_state`` where ``mask[b]`` is True, else keeps ``old_state`` bit
    for bit.  ``mask`` is a length-B boolean array (host or device)."""
    _grid.check_initialized()
    nb = check_batched(new_state)
    m = torch.as_tensor(np.asarray(mask, dtype=bool), device=new_state[0].device)
    if m.shape != (nb,):
        raise ValueError(f"mask has shape {tuple(m.shape)} for {nb} members")
    return tuple(
        torch.where(m.view((-1,) + (1,) * (N.dim() - 1)), N, O)
        for N, O in zip(new_state, old_state)
    )


def batched_setup(model, nx: int, ny: int, nz: int, *, batch: int,
                  ic_scales=None, init_grid: bool = True, **kw):
    """Grid + B-member batched initial state for one model module.

    ``model`` is one of `models.diffusion3d` / `acoustic3d` /
    `porous_convection3d` (any module with ``setup(..., ic_scale=...)``).
    Member ``b`` gets the model's standard initial condition with its
    perturbation scaled by ``ic_scales[b]`` (default ``1 + b/(8*batch)`` —
    distinct members, same smooth physics), so a batched run is directly
    comparable to B independent runs of ``setup(..., ic_scale=s_b)``.
    Returns ``(batched_state, params)``; `Params` are shared (same grid,
    same dt) by construction.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1 (got {batch})")
    if ic_scales is None:
        ic_scales = [1.0 + b / (8.0 * batch) for b in range(batch)]
    if len(ic_scales) != batch:
        raise ValueError(f"ic_scales has {len(ic_scales)} entries for batch={batch}")
    states = []
    params = None
    for b, scale in enumerate(ic_scales):
        state, params = model.setup(nx, ny, nz, ic_scale=float(scale),
                                    init_grid=(init_grid and b == 0), **kw)
        states.append(state)
    return stack_states(states), params


def checked(step, batch: bool):
    """``step`` itself, or with ``batch`` a step that first checks that its
    fields are one batch (`check_batched`): a 3-D field handed to a batched
    step would otherwise be read as a batch of 2-D blocks."""
    if not batch:
        return step

    def batched_step(*fields):
        check_batched(fields)
        return step(*fields)

    return batched_step
