"""Transport checksums for the halo exchange's packed wire buffers.

The exchange (`ops.halo._permute_fields`) packs every same-width field
slab of one (dimension, direction) hop into a single integer-word buffer.
While a `TransportCollector` is active (`ops.halo.exchange` installs one
when ``IGG_INTEGRITY=1``), the sender appends one extra word, the XOR fold
of the payload words, to that same buffer; the receiver recomputes the fold
over the landed payload and compares it with the landed checksum word.
Both sides evaluate the same function of data they already hold, so the
hop count is unchanged and each wire buffer grows by one word.

The fold runs over the word view (`ops.halo._flat_words`), so ``-0.0`` and
NaN payload bits are covered: a flipped mantissa bit is still a finite
float.  An XOR fold misses only flips of the same bit in an even number of
words.  torch has no XOR reduction, so `fold_words` folds by halving (about
log2(n) small elementwise launches, for a hop's two buffers at once); the
JAX package folds with ``lax.reduce`` in XLA, so neither side has a
hand-written kernel here.

The mismatch flags stay on the device while the exchange runs; the entry
reads them once at its end (`ops.halo._check_transport_flags`), a
rank-local verdict that raises `IntegrityError` naming the sender and
never drives a collective.  The port's counterpart of the JAX package's
``integrity/transport.py``.
"""

from __future__ import annotations

import contextlib

import torch

from .errors import IntegrityError

__all__ = [
    "IntegrityError",
    "TransportCollector",
    "active_collector",
    "use_collector",
    "fold_words",
    "append_checksum",
    "split_and_verify",
]


class TransportCollector:
    """What one checksummed exchange recorded.

    ``records`` — one ``{"dim", "width", "fields"}`` per checksummed hop
    (a buffer pair of one dimension and word width, in issue order;
    ``fields``: positions of the fields packed into it); ``flags`` — the
    matching ``(2,)`` bool tensors, mismatch of the lo and the hi receive
    (False on a side with no partner).  ``flip_proc`` — an armed in-flight
    flip (`ops.halo.arm_transport_flip`): the first checksummed hop XORs
    bit 0 of payload word 0 of that rank's send buffers, after the
    checksum fold.
    """

    def __init__(self, flip_proc: int | None = None):
        self.records: list[dict] = []
        self.flags: list = []
        self.flip_proc = flip_proc

    def record(self, *, dim, width, fields, bad) -> None:
        self.records.append({"dim": int(dim), "width": int(width), "fields": tuple(fields)})
        self.flags.append(bad)

    def take_flip(self) -> int | None:
        """Consume the armed in-flight flip target (first hop only)."""
        proc, self.flip_proc = self.flip_proc, None
        return proc

    def stacked_flags(self):
        """The flags as one ``(nrecords, 2)`` bool tensor, or None when
        nothing was recorded."""
        return torch.stack(self.flags) if self.flags else None


_active: TransportCollector | None = None


def active_collector() -> TransportCollector | None:
    """The collector of the checksummed exchange in progress, or None
    (`ops.halo.exchange` installs it and hands it down the exchange)."""
    return _active


@contextlib.contextmanager
def use_collector(col: TransportCollector):
    global _active
    prev = _active
    _active = col
    try:
        yield col
    finally:
        _active = prev


def fold_words(buf):
    """XOR fold of integer words along the last axis (a 1-D buffer folds to
    one 0-d word, a stack of buffers to one word each): the halves are
    xored until one word is left, an odd length padded with 0 (xor's
    identity) first.  Stacking the buffers of a hop's two sides folds both
    in the same launches."""
    if buf.shape[-1] == 0:
        return buf.new_zeros(buf.shape[:-1])
    while buf.shape[-1] > 1:
        if buf.shape[-1] % 2:
            buf = torch.cat([buf, buf.new_zeros((*buf.shape[:-1], 1))], dim=-1)
        half = buf.shape[-1] // 2
        buf = torch.bitwise_xor(buf[..., :half], buf[..., half:])
    return buf[..., 0]


def append_checksum(buf):
    """``payload ++ [fold(payload)]`` along the last axis — the wire form
    of a hop buffer (or of a stack of them)."""
    return torch.cat([buf, fold_words(buf).unsqueeze(-1)], dim=-1)


def split_and_verify(recv):
    """Landed hop buffer(s) -> ``(payload, mismatch)``; ``mismatch`` is a
    bool tensor (0-d for one buffer): the fold recomputed over the landed
    payload differs from the landed checksum word."""
    payload, chk = recv[..., :-1], recv[..., -1]
    return payload, fold_words(payload) != chk
