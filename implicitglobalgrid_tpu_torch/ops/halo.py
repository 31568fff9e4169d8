"""Halo exchange: refresh each block's halo planes from its neighbours.

Semantics (0-based indices), as in the reference's `update_halo!`:

* Per dimension, my planes ``[o-w, o)`` refresh my lower neighbour's top
  planes ``[n-w, n)``, and my planes ``[n-o, n-o+w)`` refresh my upper
  neighbour's bottom planes ``[0, w)``; ``w = 1`` is the reference's
  exchange, ``w > 1`` the deep-halo slab exchange that licenses ``w``
  stencil steps between exchanges (needs ``ol >= 2w``).
* Dimensions run in sequence (x, then y, then z): the dim-``d`` slabs are
  cut from the array the dim-``d-1`` exchange already updated, so corners
  are right.
* The overlap is shape-aware: ``ol(d, A) = overlaps[d] + (size(A,d) -
  nxyz[d])``, so staggered ``n+1`` fields exchange the right planes; a
  dimension with ``ol < 2`` has no halo and is skipped.
* A non-periodic edge (PROC_NULL neighbour) keeps its old planes.
* When a block is its own partner (periodic with one block in a dimension)
  the exchange is a local copy.

Fields are updated IN PLACE (the reference's mutating API); `update_halo`
also returns them, like the JAX package's functional call.  The transport is
`torch.distributed.batch_isend_irecv` over contiguous send/receive slabs;
received slabs are written back with ``copy_``.

A batched (ensemble) field ``(B, *block)`` exchanges with grid dimension
``d`` on tensor axis ``d + lead`` (``lead = 1``; `models._batched` is its
entry): each slab carries all B members, so a dimension still moves each
field in one send/receive pair per side, whatever B.

`begin_slab_exchange` / `finish_slab_exchange` split the same exchange in
two for the overlap schedules (`ops.overlap.hide_communication`, the
pipelined group schedule of `models._fused`): ``begin`` starts it on a
high-priority communication stream (the reference's max-priority halo
streams) from the planes a field already holds, ``finish`` makes the
compute stream wait for it and writes the received planes.

Coalescing (JAX ``_coalesced_permute``): when two or more fields permute a
dimension, their send slabs pack into one buffer per dtype word width (a
byte-exact reinterpretation as same-width integers, `_flat_words`), so a
dimension issues ONE send/receive pair per side and width group instead of
one per field.  Bit-identical to the per-field transport; ``coalesce=False``
or ``IGG_COALESCE=0`` restores it.

Autodiff: with grad mode on and a field that requires grad, the exchange
runs as `_Exchange`, a `torch.autograd.Function` whose backward is the
exchange's adjoint across ranks: each received halo's cotangent goes back
to the rank that sent it and is added into its send planes (JAX gets the
same from ``ppermute``'s transpose and ``_packed_transport``'s custom VJP).
Every rank must run the backward, with the same exchanges in the same
order as the forward (NCCL matches messages by order).  The exchange stays
in place, so a field that is a leaf requiring grad cannot be exchanged
(torch refuses in-place writes to such a leaf): exchange
``update_halo(A.clone())``, or the output of an update.

Instrumentation: each exchange call is one host span of the JAX package's
name (``igg_halo_exchange``, ``igg_slab_exchange_begin`` / ``_finish``,
`utils.tracing.trace_span`), which is also a profiler range of that name
while a capture is live.  The `utils.telemetry` counter
``halo.payload_bytes`` counts the bytes of every width-``w`` slab written
into a halo (self copies and received slabs alike), computed on the host
from the shapes, once per exchange call: the planes the grid's widths,
overlaps, periods and staggering call for, whatever the transport packs or
sends.  The adjoint exchange, and the exchanges a backward recomputes
(`uncounted`), do not count.

Transport checksums (``IGG_INTEGRITY=1``, `integrity.transport`): every
exchange runs under a `TransportCollector`; every group then packs to the
word view, singletons and self-partner hops included, and each wire buffer
carries one XOR-fold checksum word that the receiver verifies.  A mismatch
raises `IntegrityError` on the receiver, naming the sender.  Unset or 0,
the exchange and its messages are exactly the unchecked ones.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..integrity import transport as _itransport
from ..parallel import grid as _grid
from ..parallel.topology import NDIMS, PROC_NULL
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing
from ..utils.config import coalesce_env, integrity_enabled_env

#: Armed ``bit_flip:…:transport`` target rank, consumed by the next
#: checksummed exchange (`arm_transport_flip`).
_transport_flip: int | None = None

#: Post-exchange hook of `update_halo` (`set_post_exchange_hook`).
_post_exchange_hook = None

#: False while a backward recomputes a forward (`uncounted`).
_counting = True


def _count_payload(nbytes: int) -> None:
    """One ``halo.payload_bytes`` increment for one exchange call."""
    if nbytes and _counting:
        _telemetry.counter("halo.payload_bytes").inc(nbytes)


@contextlib.contextmanager
def uncounted():
    """Exchanges inside this context add nothing to ``halo.payload_bytes``:
    the forward a backward recomputes (`ops.overlap.fused_with_plain_grad`)
    is not a second exchange of the run."""
    global _counting
    saved, _counting = _counting, False
    try:
        yield
    finally:
        _counting = saved


def arm_transport_flip(proc: int) -> None:
    """Arm a one-shot in-flight payload-word flip on rank ``proc``'s next
    checksummed exchange (the ``bit_flip`` fault kind's transport
    placement): its first hop XORs bit 0 of payload word 0 of the send
    buffers after the checksum fold.  Every rank consumes the arming at its
    next checksummed exchange; nothing happens unless ``IGG_INTEGRITY=1``."""
    global _transport_flip
    _transport_flip = int(proc)


def _take_transport_flip() -> int | None:
    global _transport_flip
    proc, _transport_flip = _transport_flip, None
    return proc


def set_post_exchange_hook(fn):
    """Install ``fn(fields_tuple) -> fields_tuple`` on the output of every
    `update_halo` (None removes it); returns the previous hook.  The fault
    harness poisons exchanged fields here
    (`utils.resilience.install_halo_fault_hook`)."""
    global _post_exchange_hook
    prev = _post_exchange_hook
    _post_exchange_hook = fn
    return prev


def local_shape(A, gg=None) -> tuple[int, ...]:
    """Per-block (local) shape of a field: a field IS its local block."""
    return tuple(A.shape)


def ol(dim: int, A=None, shape: Sequence[int] | None = None, gg=None) -> int:
    """Shape-aware overlap of a field in ``dim``."""
    if gg is None:
        gg = _grid.global_grid()
    if shape is None:
        shape = local_shape(A)
    size_d = shape[dim] if dim < len(shape) else 1
    return gg.overlaps[dim] + (size_d - gg.nxyz[dim])


def halosize(dim: int, A, gg=None) -> tuple[int, ...]:
    """Shape of one halo plane of ``A`` in ``dim``."""
    shp = local_shape(A)
    if len(shp) > 1:
        return tuple(s for i, s in enumerate(shp) if i != dim)
    return (1,)


def _validate_fields(fields, gg, shapes=None) -> None:
    """Reject fields with no halo, duplicates, and fields off the grid's
    device.  Mixed dtypes are valid (every field has its own buffers).
    ``shapes``: the fields' block shapes (default: their whole shapes; a
    batched field's are its members')."""
    if shapes is None:
        shapes = [local_shape(A) for A in fields]
    no_halo = [
        i
        for i, shp in enumerate(shapes)
        if all(ol(d, shape=shp, gg=gg) < 2 for d in range(len(shp)))
    ]
    if len(no_halo) > 1:
        pos = ", ".join(str(i + 1) for i in no_halo[:-1]) + f" and {no_halo[-1] + 1}"
        raise ValueError(f"The fields at positions {pos} have no halo; remove them from the call.")
    elif no_halo:
        raise ValueError(
            f"The field at position {no_halo[0] + 1} has no halo; remove it from the call."
        )
    dup = [
        (i, j)
        for i in range(len(fields))
        for j in range(i + 1, len(fields))
        if fields[i] is fields[j]
    ]
    if dup:
        i, j = dup[0]
        raise ValueError(
            f"The field at position {j + 1} is a duplicate of the one at the "
            f"position {i + 1}; remove the duplicate from the call."
        )
    for i, A in enumerate(fields):
        if A.device != gg.device:
            raise ValueError(
                f"The field at position {i + 1} lives on {A.device}, but the "
                f"grid's device is {gg.device}."
            )


def dim_has_halo_activity(gg, d: int) -> bool:
    """Whether dimension ``d`` exchanges anything at all on this grid:
    periodic dimensions always have partners (possibly self); non-periodic
    ones only when a distance-``disp`` shift stays on the grid."""
    if gg.periods[d]:
        return True
    return abs(int(gg.disp)) < gg.dims[d]


def require_deep_halo(w: int, gg=None, *, what: str = "exchange_every") -> None:
    """Validate that every dimension with halo activity has ``overlap >= 2w``
    (the sent slab planes must lie at distance >= ``w`` from the block
    edge, where ``w`` stencil steps are still exact)."""
    if gg is None:
        gg = _grid.global_grid()
    shallow = [
        d
        for d in range(NDIMS)
        if dim_has_halo_activity(gg, d) and gg.overlaps[d] < 2 * w
    ]
    if shallow:
        raise ValueError(
            f"{what}={w} on a communicating grid needs a deep halo: overlap >= "
            f"{2 * w} in every dimension with halo activity, but dims {shallow} "
            f"have overlaps {[gg.overlaps[d] for d in shallow]} (grid dims="
            f"{gg.dims}, periods={gg.periods}). Re-init with overlap"
            f"{'/'.join('xyz'[d] for d in shallow)}={2 * w}, or use the "
            "per-step exchange."
        )


def _partner_self(gg, d: int) -> bool:
    """Every block its own distance-``disp`` partner along ``d``?"""
    nd = gg.dims[d]
    disp = int(gg.disp)
    return (disp % nd == 0) if bool(gg.periods[d]) else (disp == 0)


def _patch_slab(slab, d: int, start: int, width: int, received, shp, lead: int = 0):
    """A copy of a dim-``d`` slab with its earlier-dim halo strips replaced
    by the received values: the sequential-dimension corner carry-over at
    slab granularity (JAX ``ops/halo.py::_patch_slab``).

    ``slab`` was cut from the field at planes ``[start, start+width)`` along
    ``d``; ``received`` maps each already-exchanged dim ``d2 < d`` to its
    ``(lo, hi)`` receive slabs (full field extent along ``d``; None on a
    side with no partner, whose planes keep their values); ``shp`` is the
    field's block shape, and grid dimension ``d`` is tensor axis ``d +
    lead``.  The result equals the slab cut from the array that the earlier
    dims' exchange already updated.
    """
    slab = slab.clone(memory_format=torch.contiguous_format)
    for d2, (lo2, hi2) in received.items():
        for recv, at in ((lo2, 0), (hi2, None)):
            if recv is None:
                continue
            w2 = recv.shape[d2 + lead]
            at = shp[d2] - w2 if at is None else at
            slab.narrow(d2 + lead, at, w2).copy_(recv.narrow(d + lead, start, width))
    return slab


def _slab_parts(A, d: int, gg, width: int = 1, received=None, lead: int = 0):
    """The slabs a ``d``-exchange of ``A`` involves.

    Returns ``None`` when the dimension exchanges nothing for this field,
    ``("self", src_lo, src_hi)`` on the self-partner path (the values for
    planes ``[0, w)`` and ``[n-w, n)``), or ``("permute", send_lo,
    send_hi)``: the slab for my lower partner's top planes and the one for
    my upper partner's bottom planes.  Without ``received`` the slabs are
    views of ``A``; with it (`begin_slab_exchange`), copies patched by
    `_patch_slab`.  ``lead``: leading ensemble axes of ``A`` (grid
    dimension ``d`` is tensor axis ``d + lead``).
    """
    shp = tuple(A.shape[lead:])
    if d >= len(shp):
        return None  # grid validation forces dims[d]==1, period 0 here
    o = ol(d, shape=shp, gg=gg)
    if o < 2:
        return None  # no halo in this dimension
    n = shp[d]
    if not dim_has_halo_activity(gg, d):
        return None
    if o < 2 * width:
        raise ValueError(
            f"update_halo(width={width}) needs overlap >= {2 * width} in "
            f"dimension {d}; this field has ol={o}. Re-init the grid with "
            f"overlap{'xyz'[d]}={2 * width} (deep halo) or use width=1."
        )

    def slab(start):
        s = A.narrow(d + lead, start, width)
        if received is None:
            return s
        return _patch_slab(s, d, start, width, received, shp, lead)

    if _partner_self(gg, d):
        return ("self", slab(n - o), slab(o - width))
    return ("permute", slab(o - width), slab(n - o))



#: Tag offset of the adjoint's messages: the forward tags a dim-``d`` message
#: ``2d`` (to the lower partner) or ``2d+1`` (to the upper one), the backward
#: ``ADJOINT_TAG + 2d`` or ``ADJOINT_TAG + 2d + 1``, so under gloo a rank
#: that starts its backward never matches a neighbour's forward message.
ADJOINT_TAG = 2 * NDIMS


def _issue_permute(d: int, gg, send_lo, send_hi, tag0: int = 0):
    """Start the exchange of two slabs with the distance-``disp`` partners
    along ``d``; returns ``(requests, recv_lo, recv_hi)``: the receive
    buffers for planes ``[0, w)`` and ``[n-w, n)`` (None on a side with no
    partner, PROC_NULL, whose planes keep their values).

    Message order is fixed so that both NCCL (which matches point-to-point
    messages between a pair of ranks in issue order) and gloo (which matches
    by tag) pair them right when both partners are the same rank (``dims[d]
    == 2``, periodic): every rank issues its sends as (to-lower, to-upper)
    and its receives as (from-upper, from-lower); what I send to my lower
    partner is what that partner receives from ITS upper partner.  Under
    NCCL, the requests' ``wait()`` makes the current stream wait.  ``tag0``:
    0 for the exchange, `ADJOINT_TAG` for its adjoint, which sends the same
    way (a cotangent goes back to the lower partner as ``send_lo``).
    """
    lower, upper = int(gg.neighbors[0, d]), int(gg.neighbors[1, d])
    tag_to_lower, tag_to_upper = tag0 + 2 * d, tag0 + 2 * d + 1
    ops = []
    recv_lo = recv_hi = None
    if lower != PROC_NULL:
        ops.append(dist.P2POp(dist.isend, send_lo.contiguous(), lower, tag=tag_to_lower))
    if upper != PROC_NULL:
        ops.append(dist.P2POp(dist.isend, send_hi.contiguous(), upper, tag=tag_to_upper))
    if upper != PROC_NULL:
        recv_hi = torch.empty_like(send_lo, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, recv_hi, upper, tag=tag_to_lower))
    if lower != PROC_NULL:
        recv_lo = torch.empty_like(send_hi, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, recv_lo, lower, tag=tag_to_upper))
    return (dist.batch_isend_irecv(ops) if ops else []), recv_lo, recv_hi


#: Integer word type of each transport word width in bytes.
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _as_words(x):
    """``x`` as the elements the transport moves: bool as uint8, complex as
    its real and imaginary float words (JAX ``_flat_words``)."""
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    return torch.view_as_real(x) if x.is_complex() else x


def _word_width(dtype) -> int:
    """Transport word size in bytes (complex splits into two float words)."""
    return dtype.itemsize // 2 if dtype.is_complex else dtype.itemsize


def _flat_words(x):
    """``x`` flattened to its same-width integer words, byte-exactly."""
    w = _as_words(x)
    return w.contiguous().reshape(-1).view(_WORDS[w.element_size()])


def _from_words(buf, shape, dtype):
    """Invert `_flat_words`: words back to a tensor of ``shape``/``dtype``."""
    if dtype.is_complex:
        return torch.view_as_complex(buf.view(dtype.to_real()).reshape(*shape, 2))
    return buf.view(dtype).reshape(shape)


def resolve_coalesce(coalesce):
    """``coalesce`` itself, or for None the ``IGG_COALESCE`` default (unset:
    on; JAX ``_default_coalesce``), read per call."""
    if coalesce is not None:
        return bool(coalesce)
    env = coalesce_env()
    return True if env is None else env


def _self_transport(d: int, gg, send_lo, send_hi, tag0: int = 0):
    """`_issue_permute` of a block that is its own partner along ``d``: what
    I send to my lower partner (me) lands as my upper receive."""
    return [], send_hi, send_lo


def _verify_landed(recv_lo, recv_hi, like):
    """Split the landed wire buffers of one checksummed hop into payloads
    and a ``(2,)`` mismatch flag (lo, hi; False where no partner sent),
    folding both sides in one stack."""
    recvs = [recv_lo, recv_hi]
    sides = [i for i, r in enumerate(recvs) if r is not None]
    bad = torch.zeros(2, dtype=torch.bool, device=like.device)
    if sides:
        payloads, bad[sides] = _itransport.split_and_verify(torch.stack([recvs[i] for i in sides]))
        for row, i in enumerate(sides):
            recvs[i] = payloads[row]
    return recvs[0], recvs[1], bad


def _permute_fields(d: int, gg, sends, coalesce, tag0: int = 0, col=None,
                    issue=_issue_permute):
    """Per-field ``(recv_lo, recv_hi)`` of a dim-``d`` permute of the slab
    pairs ``sends`` (one ``(send_lo, send_hi)`` per field).

    With two or more fields and ``coalesce`` (`resolve_coalesce`), the slabs pack into one buffer
    per word width (`_flat_words`, in field order) and each width group
    moves in ONE `_issue_permute`; a group with one member is sent as it is.
    Every rank forms the same groups in the same order, and the groups go
    one after another, so messages pair up under NCCL's order matching and
    gloo's tags alike.  The received words are the sent words, so the result
    equals the per-field transport bit for bit.

    With a `integrity.transport.TransportCollector` ``col`` (the
    checksummed exchange's) every group packs (singletons too), each wire
    buffer carries its checksum word (`append_checksum`), and the landed
    buffers are verified (`split_and_verify`) with the flags recorded on
    ``col``.  ``issue``: the transport (`_self_transport` for self-partner
    hops, which only the checksummed exchange routes here).
    """
    if not sends:
        return []
    pack = col is not None or (len(sends) > 1 and resolve_coalesce(coalesce))
    groups: dict = {}
    for j, (lo, _) in enumerate(sends):
        key = _word_width(lo.dtype) if pack else j
        groups.setdefault(key, []).append(j)
    out: list = [None] * len(sends)
    for key, idxs in groups.items():
        if len(idxs) == 1 and col is None:
            (j,) = idxs
            reqs, lo, hi = issue(d, gg, *sends[j], tag0)
            for req in reqs:
                req.wait()
            out[j] = (lo, hi)
            continue
        bufs = [torch.cat([_flat_words(sends[j][side]) for j in idxs]) for side in (0, 1)]
        if col is not None:
            # Both sides' wire buffers in one stack: one fold for the two.
            wire = _itransport.append_checksum(torch.stack(bufs))
            if col.take_flip() == gg.me:
                wire[:, 0] ^= 1
            bufs = [wire[0], wire[1]]
        reqs, recv_lo, recv_hi = issue(d, gg, *bufs, tag0)
        for req in reqs:
            req.wait()
        if col is not None:
            recv_lo, recv_hi, bad = _verify_landed(recv_lo, recv_hi, bufs[0])
            col.record(dim=d, width=key, fields=idxs, bad=bad)
        off = 0
        for j in idxs:
            like = sends[j][0]
            size = _as_words(like).numel()
            out[j] = tuple(
                None if r is None else _from_words(r[off:off + size], like.shape, like.dtype)
                for r in (recv_lo, recv_hi)
            )
            off += size
    return out


def _write_planes(A, d: int, width: int, lo, hi, lead: int = 0) -> None:
    """Write received ``lo``/``hi`` slabs into ``A``'s planes ``[0, w)`` and
    ``[n-w, n)`` along grid dimension ``d`` (tensor axis ``d + lead``; a
    None side keeps its planes)."""
    a = d + lead
    if hi is not None:
        A.narrow(a, A.shape[a] - width, width).copy_(hi)
    if lo is not None:
        A.narrow(a, 0, width).copy_(lo)


def _exchange_dim(fields, d: int, gg, width: int, lead: int, coalesce, col=None) -> int:
    """The dim-``d`` exchange of ``fields``, in place; checksummed under
    the collector ``col`` (self-partner hops included).  Returns the bytes
    of the halo slabs it writes."""
    permuting, sends = [], []
    sides = 2 if _partner_self(gg, d) else sum(
        int(gg.neighbors[s, d]) != PROC_NULL for s in (0, 1))
    nbytes = 0
    for A in fields:
        p = _slab_parts(A, d, gg, width, lead=lead)
        if p is None:
            continue
        nbytes += sides * width * A.numel() // A.shape[d + lead] * A.element_size()
        if p[0] == "permute":
            permuting.append(A)
            sends.append(p[1:])
        elif col is None:
            # Source and target slabs are disjoint (ol >= 2w), so both copies
            # read pre-exchange values.
            _write_planes(A, d, width, p[1], p[2], lead)
        else:
            permuting.append(A)
            # A self-partner hop sends (to-lower, to-upper) = (src_hi, src_lo).
            sends.append((p[2], p[1]))
    if not permuting:
        return nbytes
    issue = _self_transport if col is not None and _partner_self(gg, d) else _issue_permute
    for A, (lo, hi) in zip(permuting, _permute_fields(d, gg, sends, coalesce, col=col,
                                                      issue=issue)):
        _write_planes(A, d, width, lo, hi, lead)
    return nbytes


def _adjoint_dim(grads, d: int, gg, width: int, lead: int, coalesce) -> None:
    """The adjoint of `_exchange_dim` on the cotangents ``grads``, in place.

    A halo plane's cotangent moves back to where its value came from and is
    zeroed where a partner (or the block itself) wrote it; a PROC_NULL side
    keeps it, since its planes kept their values.  The sender adds what it
    receives into its send planes ``[o-w, o)`` (from its lower partner's
    top planes) and ``[n-o, n-o+w)`` (from its upper partner's bottom
    planes).  Packed like the forward, one message per side and width group.
    """
    a = d + lead
    permuting, sends = [], []
    for G in grads:
        p = _slab_parts(G, d, gg, width, lead=lead)
        if p is None:
            continue
        n, o = G.shape[a], ol(d, shape=G.shape[lead:], gg=gg)
        if p[0] == "self":
            glo, ghi = (G.narrow(a, at, width).clone() for at in (0, n - width))
            _zero_planes(G, a, width, True, True)
            G.narrow(a, n - o, width).add_(glo)
            G.narrow(a, o - width, width).add_(ghi)
        else:
            permuting.append((G, n, o))
            sends.append((G.narrow(a, 0, width), G.narrow(a, n - width, width)))
    lower, upper = (int(gg.neighbors[s, d]) != PROC_NULL for s in (0, 1))
    recvs = _permute_fields(d, gg, sends, coalesce, ADJOINT_TAG)
    for (G, n, o), (from_lower, from_upper) in zip(permuting, recvs):
        _zero_planes(G, a, width, lower, upper)
        if from_lower is not None:
            G.narrow(a, o - width, width).add_(from_lower)
        if from_upper is not None:
            G.narrow(a, n - o, width).add_(from_upper)


def _exchange_fields(fields, width: int, lead: int, coalesce, col=None) -> None:
    """Every dimension's exchange of ``fields`` in sequence, in place."""
    gg = _grid.global_grid()
    _count_payload(sum(_exchange_dim(fields, d, gg, width, lead, coalesce, col)
                       for d in range(NDIMS)))


def _zero_planes(G, a: int, width: int, lo: bool, hi: bool) -> None:
    if lo:
        G.narrow(a, 0, width).zero_()
    if hi:
        G.narrow(a, G.shape[a] - width, width).zero_()


def needs_grad(tensors) -> bool:
    """Grad mode is on and some tensor requires grad: the exchange (and the
    fused cadences) must record for autograd."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Exchange(torch.autograd.Function):
    """The exchange of ``fields`` in place, with its adjoint as backward."""

    @staticmethod
    def forward(ctx, width, lead, coalesce, col, *fields):
        _exchange_fields(fields, width, lead, coalesce, col)
        ctx.mark_dirty(*fields)
        ctx.args = (width, lead, coalesce)
        return fields

    @staticmethod
    def backward(ctx, *grads):
        width, lead, coalesce = ctx.args
        gg = _grid.global_grid()
        grads = [g.clone(memory_format=torch.contiguous_format) for g in grads]
        for d in reversed(range(NDIMS)):
            _adjoint_dim(grads, d, gg, width, lead, coalesce)
        return (None, None, None, None, *grads)


def exchange_dims(A, dims, *, width: int = 1, lead: int = 0):
    """Exchange one field along the given dimensions only, in place (the
    pipelined schedule's z exchange after the x/y halves; no autograd)."""
    gg = _grid.global_grid()
    _count_payload(sum(_exchange_dim((A,), d, gg, width, lead, False) for d in dims))
    return A


def exchange(fields, *, width: int = 1, lead: int = 0, coalesce=None) -> tuple:
    """The exchange of validated ``fields`` in place: dimensions in
    sequence, every field per dimension (`update_halo`'s body; the
    ensemble's through `models._batched.update_halo`, ``lead = 1``).
    Returns the fields; under autograd (`needs_grad`) they carry the
    exchange's adjoint (`_Exchange`).  An armed ``net_delay``
    (`utils.tracing.arm_collective_delay`) sleeps first; with
    ``IGG_INTEGRITY=1`` the exchange runs checksummed under a
    `TransportCollector` and its flags are read once at the end
    (`_check_transport_flags`).  The exchange is one ``igg_halo_exchange``
    host span (the JAX package's name), and a profiler range of that name
    while a capture is live."""
    if _tracing._collective_delay:
        _tracing._consume_collective_delay()
    with _tracing.trace_span("igg_halo_exchange", fields=len(fields), width=width):
        if integrity_enabled_env() is not True:
            return _exchange(fields, width, lead, coalesce)
        col = _itransport.TransportCollector(flip_proc=_take_transport_flip())
        with _itransport.use_collector(col):
            out = _exchange(fields, width, lead, coalesce, col)
        _check_transport_flags(_grid.global_grid(), col)
        return out


def _exchange(fields, width, lead, coalesce, col=None) -> tuple:
    if needs_grad(fields):
        # Resolved once, so that the backward packs as the forward did.
        return _Exchange.apply(width, lead, resolve_coalesce(coalesce), col, *fields)
    _exchange_fields(fields, width, lead, coalesce, col)
    return tuple(fields)


def _check_transport_flags(gg, col) -> None:
    """Rank-local verdict of one checksummed exchange: one read of the
    recorded flags; the first nonzero names a hop whose landed payload
    contradicts its checksum word, and the SENDER (my partner on that side,
    `neighbors_table`) is implicated.  Raises locally and never drives a
    collective (JAX ``ops/halo._check_transport_flags``)."""
    from ..integrity.errors import IntegrityError

    flags = col.stacked_flags()
    if flags is None:
        return
    host = flags.cpu().numpy()
    if not host.any():
        return
    hop, side = (int(i) for i in np.argwhere(host)[0])
    rec = col.records[hop]
    dim = rec["dim"]
    # flag column 0 = the lo receive (sent by my LOWER partner), 1 = hi
    direction = "lo" if side == 0 else "hi"
    sender = int(gg.neighbors[side, dim])
    fields = tuple(rec["fields"])
    coords = tuple(int(c) for c in gg.coords)
    _telemetry.counter("integrity.transport_mismatches").inc()
    _telemetry.event(
        "integrity.transport_mismatch", detector="transport_checksum",
        dim=dim, direction=direction, fields=list(fields), block=list(coords),
        implicated_rank=sender,
    )
    _tracing.dump_flight_recorder(
        "sdc", detector="transport_checksum", implicated_rank=sender, dim=dim,
        direction=direction, fields=list(fields), block=list(coords),
    )
    raise IntegrityError(
        f"halo transport checksum mismatch: dim {dim} ({direction} "
        f"receive) at block {coords} — the landed payload contradicts "
        f"its checksum word; implicating sender rank {sender}. A finite "
        f"bit flip in flight passes every NaN guard; quarantine the "
        f"implicated device, do not restart in place.",
        detector="transport_checksum", implicated_rank=sender,
        dim=dim, direction=direction, fields=fields,
    )


#: High-priority communication stream per CUDA device (`_comm_stream`).
_comm_streams: dict = {}


def _comm_stream(device):
    if device not in _comm_streams:
        _comm_streams[device] = torch.cuda.Stream(device, priority=-1)
    return _comm_streams[device]


def begin_slab_exchange(fields, dims, *, width: int, lead: int = 0, coalesce=None):
    """Start the slab exchange of ``fields`` along ``dims`` WITHOUT writing
    the received planes back; returns one pend list per field for
    `finish_slab_exchange`.

    The early-exchange entry of the overlap schedules: it reads only the
    send planes of each field (``[o-w, o)`` and ``[n-o, n-o+w)``), so other
    planes may still be being written while it runs.  Sequential-dimension
    corner semantics hold at slab granularity: each dim-``d`` send slab is
    patched with the dims ``< d`` receive strips of THIS call
    (`_patch_slab`), exactly the values a serialized per-dim exchange would
    have cut.  On CUDA tensors the whole exchange runs on the device's
    communication stream after it waited for the work enqueued so far on
    the current stream, so every dim-``d`` receive is ordered before the
    dim-``d+1`` patch on that stream, never on the host; the tensors stay
    on the device.  ``lead``: the fields' leading ensemble axes;
    ``coalesce`` as in `update_halo`.  No autograd: the schedules that call
    it carry their own (`ops.overlap.fused_with_plain_grad`).
    """
    with _tracing.trace_span("igg_slab_exchange_begin", fields=len(fields)):
        return _begin_slab_exchange(fields, dims, width, lead, coalesce)


def _begin_slab_exchange(fields, dims, width, lead, coalesce):
    gg = _grid.global_grid()
    pends = [[] for _ in fields]
    received = [{} for _ in fields]
    cuda = fields[0].is_cuda
    comm = None
    if cuda:
        comm = _comm_stream(fields[0].device)
        comm.wait_stream(torch.cuda.current_stream(fields[0].device))
        for A in fields:
            A.record_stream(comm)
    with torch.cuda.stream(comm):  # no-op for CPU tensors (comm is None)
        for d in dims:
            permuting, sends = [], []
            for i, A in enumerate(fields):
                p = _slab_parts(A, d, gg, width, received=received[i], lead=lead)
                if p is None:
                    continue
                if p[0] == "self":
                    received[i][d] = (p[1], p[2])
                else:
                    permuting.append(i)
                    sends.append(p[1:])
            for i, lo_hi in zip(permuting, _permute_fields(d, gg, sends, coalesce)):
                received[i][d] = lo_hi
            for i in range(len(fields)):
                if d in received[i]:
                    pends[i].append((d, width, lead, *received[i][d]))
    return pends


def finish_slab_exchange(fields, pends):
    """Apply `begin_slab_exchange`'s received slabs to ``fields`` in place.

    ``fields`` may be later tensors than the ones ``begin`` saw (the
    pipelined schedule finishes on the combined ring+mid output) as long as
    they hold the same owned values.  On CUDA the current stream first waits
    for the communication stream.  Returns the fields.
    """
    with _tracing.trace_span("igg_slab_exchange_finish", fields=len(fields)):
        if fields and fields[0].is_cuda:
            main = torch.cuda.current_stream(fields[0].device)
            main.wait_stream(_comm_stream(fields[0].device))
            for pend in pends:
                for *_, lo, hi in pend:
                    for t in (lo, hi):
                        if t is not None:
                            t.record_stream(main)
        for A, pend in zip(fields, pends):
            for d, width, lead, lo, hi in pend:
                _write_planes(A, d, width, lo, hi, lead)
        _count_payload(sum(t.numel() * t.element_size()
                           for pend in pends for *_, lo, hi in pend
                           for t in (lo, hi) if t is not None))
    return tuple(fields)


def update_halo_padded_faces(C, Axp, Ayp, Azp, *, width: int = 1, dims=None, coalesce=None):
    """Slab-exchange a cell field and three face fields held in the
    `ops.fused_leapfrog.pad_faces` layout, in place; returns the four.

    The JAX package's entry for the TPU kernels' padded layout.  The slab
    planes are those of the real ``n+1`` faces: the exchange runs on
    `ops.fused_leapfrog.unpad_faces`' views, so the received planes are
    written through into the padded arrays.  Owned results are bit for bit
    those of unpad -> `update_halo` -> pad; the junk tail past the real
    faces is left as it was (the layout forbids reading it).  ``dims``:
    exchange these dimensions only (default all, in order); ``coalesce`` as
    in `update_halo`.  The Hopper kernels read the real face arrays, so
    nothing in the port calls this.
    """
    from .fused_leapfrog import unpad_faces

    _grid.check_initialized()
    gg = _grid.global_grid()
    if width < 1:
        raise ValueError(f"width must be >= 1 (got {width})")
    fields = (C, *unpad_faces(Axp, Ayp, Azp))
    _validate_fields(fields, gg)
    _count_payload(sum(_exchange_dim(fields, d, gg, width, 0, coalesce)
                       for d in (range(NDIMS) if dims is None else dims)))
    return C, Axp, Ayp, Azp


def update_halo(*fields, width: int = 1, coalesce: bool | None = None):
    """Update the halo planes of the given field(s) in place.

    Returns the field for one argument, a tuple for several (the JAX
    package's functional signature; the tensors themselves were updated).
    ``width``: halo planes refreshed per side (default 1); ``width=w`` on a
    deep-halo grid (``overlap >= 2w``) refreshes ``w`` planes per exchange,
    licensing ``w`` stencil steps between exchanges.  ``coalesce`` (None:
    ``IGG_COALESCE``, default on): where two or more fields permute a
    dimension, one send/receive pair per side and dtype word width carries
    them all; ``False`` sends each field on its own.  Bit-identical either
    way.

    Differentiable: under grad mode the returned tensors carry the
    exchange's adjoint across ranks (every rank must then run the backward).
    A leaf that requires grad cannot be updated in place; pass
    ``A.clone()``.
    """
    _grid.check_initialized()
    gg = _grid.global_grid()
    if not fields:
        raise ValueError("update_halo requires at least one field.")
    if width < 1:
        raise ValueError(f"width must be >= 1 (got {width})")
    _validate_fields(fields, gg)
    out = exchange(fields, width=width, coalesce=coalesce)
    if _post_exchange_hook is not None:
        out = tuple(_post_exchange_hook(tuple(out)))
    return out[0] if len(out) == 1 else out
