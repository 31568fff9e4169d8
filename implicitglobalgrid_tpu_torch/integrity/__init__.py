"""Silent-data-corruption integrity plane of the port.

The counterpart of the JAX package's ``integrity`` package, imported by its
path (``implicitglobalgrid_tpu_torch.integrity``) and kept out of the
top-level ``__all__``, as there:

* `transport` — per-hop XOR-fold checksum words riding the packed halo
  wire buffers; the receiver recomputes over the landed slab and a
  mismatch raises `IntegrityError` implicating the SENDER.  Armed by
  ``IGG_INTEGRITY=1``; no extra collective, hop count unchanged.
* `audit` — the shadow-step audit: at the ``IGG_INTEGRITY_EVERY`` cadence
  the guarded time loop re-executes the just-committed step from a
  pre-step snapshot and bit-compares (all-reduced verdict) — catches
  wrong COMPUTE, which no transport checksum can.
* `lineage` — rolling per-field digest chains in the checkpoint manifest:
  `verify_checkpoint` tells "shard damaged on disk" (CRC) from "state was
  already corrupt when saved" (CRC clean, lineage mismatch).
* `plan` — the rank-uniformity contract of the plane's collectives.

The ``bit_flip`` fault kind (`utils.resilience`) proves every detector by
injection.
"""

from .audit import AuditReport, audit_fields
from .errors import IntegrityError
from .lineage import (
    block_digest,
    chain_field_digests,
    field_digests_from_blocks,
    lineage_problem,
    read_prev_chain,
    stream_npz_block_digests,
)
from .plan import integrity_plan
from .transport import (
    TransportCollector,
    active_collector,
    append_checksum,
    fold_words,
    split_and_verify,
    use_collector,
)

__all__ = [
    "AuditReport",
    "IntegrityError",
    "TransportCollector",
    "active_collector",
    "append_checksum",
    "audit_fields",
    "block_digest",
    "chain_field_digests",
    "field_digests_from_blocks",
    "fold_words",
    "integrity_plan",
    "lineage_problem",
    "read_prev_chain",
    "split_and_verify",
    "stream_npz_block_digests",
    "use_collector",
]
