"""Lineage digests: a rolling per-field digest chain over checkpoint bytes.

The at-rest detector of the integrity plane.  `utils.checkpoint` already
CRCs every shard *file* — which vouches for the bytes as written, not for
the state that produced them.  A lineage digest closes that gap: at save
time every process hashes each stored block's payload bytes (the dedup-
space uint8 serialization, hashed from the LIVE arrays before the npz
writer touches them) into per-block sha256 digests that ride the CRC
sidecar; rank 0 folds them into per-field digests and chains each against
the previous generation's chain entry::

    digest_f  = sha256( sorted per-block digests of field f )
    chain_f   = sha256( prev_chain_f + digest_f )     (genesis: digest_f)

`verify_checkpoint` recomputes the per-block digests by STREAMING the npz
members in bounded chunks (never materializing a shard) and can tell two
corruption classes apart:

* CRC mismatch, lineage whatever  -> shard damaged ON DISK (bit rot, torn
  write) — the pre-existing class;
* CRC clean, lineage mismatch    -> the written bytes never matched the
  live state: the state was already corrupt (or was corrupted in the
  writer path) WHEN SAVED — a poisoned generation that
  `latest_checkpoint`'s fallback must walk past, because restoring it
  would resurrect the corruption the run just escaped.

Chain entries reset to genesis when the previous generation's lineage is
absent or has a different field count (elastic topology changes re-shard
blocks but preserve fields; a field-set change is a different run).

The port's copy of the JAX package's ``integrity/lineage.py``: the same
bytes give the same digests in both packages, so a checkpoint written by
either verifies in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile

import numpy as np

__all__ = [
    "block_digest",
    "field_digests_from_blocks",
    "chain_field_digests",
    "stream_npz_block_digests",
    "lineage_problem",
    "read_prev_chain",
]

#: bounded read size of the streaming verifier (bytes)
STREAM_CHUNK = 1 << 20


def block_digest(payload: np.ndarray) -> str:
    """sha256 hex of one stored block's payload bytes (dedup-space uint8
    serialization).  Zero-copy: hashes the buffer via memoryview."""
    return hashlib.sha256(memoryview(np.ascontiguousarray(payload))).hexdigest()


def field_digests_from_blocks(blocks: dict, nfields: int) -> list[str]:
    """Fold per-block digests into one digest per field.

    ``blocks`` maps payload keys (``f<i>_o<offsets>``) to sha256 hex.  The
    fold is over ``key=digest`` lines sorted by key — deterministic for
    any process count and block assignment, so a 2-proc save and its
    4-proc elastic re-save of the SAME state produce different block maps
    but the same per-field digest only when the serialized bytes agree
    blockwise (block boundaries move with the topology, so cross-topology
    equality is not promised — the chain resets on such transitions).
    """
    per_field = [hashlib.sha256() for _ in range(nfields)]
    for key in sorted(blocks):
        try:
            idx = int(key.split("_", 1)[0][1:])
        except (ValueError, IndexError):
            continue
        if 0 <= idx < nfields:
            per_field[idx].update(f"{key}={blocks[key]}\n".encode())
    return [h.hexdigest() for h in per_field]


def chain_field_digests(field_digests: list[str],
                        prev_chain: list[str] | None) -> list[str]:
    """Roll the per-field digest chain forward one generation."""
    if prev_chain is None or len(prev_chain) != len(field_digests):
        prev_chain = [""] * len(field_digests)  # genesis / topology reset
    return [
        hashlib.sha256((prev + cur).encode()).hexdigest()
        for prev, cur in zip(prev_chain, field_digests)
    ]


def _stream_member_digest(f) -> str:
    """sha256 hex of one npy member's payload bytes, header skipped,
    read in `STREAM_CHUNK` slices (never the whole member at once)."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        np.lib.format.read_array_header_1_0(f)
    else:
        np.lib.format.read_array_header_2_0(f)
    h = hashlib.sha256()
    while True:
        chunk = f.read(STREAM_CHUNK)
        if not chunk:
            break
        h.update(chunk)
    return h.hexdigest()


def stream_npz_block_digests(path: str) -> dict:
    """Per-block payload digests of one shard file, streamed.

    Opens the npz as a zip and pipes each payload member (``f<i>_o…``,
    shape sidecars skipped) through sha256 in `STREAM_CHUNK` reads —
    bounded memory however large the shard.
    """
    out: dict = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            key = name[:-4] if name.endswith(".npy") else name
            if key.endswith("_shape") or not key.startswith("f"):
                continue
            with zf.open(name) as f:
                out[key] = _stream_member_digest(f)
    return out


def lineage_problem(step_dir: str, meta: dict) -> str | None:
    """Why this generation's stored bytes contradict its lineage, or None.

    Recomputes every shard's per-block digests (streaming) and folds them
    into per-field digests compared against the manifest's ``lineage``
    section.  Only called after the CRC pass succeeded, so a mismatch here
    means the CRC-clean file bytes never matched the live state that was
    being saved — the poisoned-at-save class (module docstring).  Metas
    without a ``lineage`` section (older generations) verify as clean.
    """
    lineage = meta.get("lineage")
    if not lineage:
        return None
    want = [f.get("digest") for f in lineage.get("fields", ())]
    nfields = len(want)
    if not nfields:
        return None
    blocks: dict = {}
    try:
        # ``shards`` maps shard FILENAME -> {"bytes", "crc32"} (the
        # format-2 manifest shape); only the names matter here.
        for fname in meta.get("shards", ()) or ():
            path = os.path.join(step_dir, fname)
            blocks.update(stream_npz_block_digests(path))
    except (OSError, zipfile.BadZipFile, ValueError, KeyError) as e:
        return f"lineage recompute failed: {e}"
    got = field_digests_from_blocks(blocks, nfields)
    bad = [
        i for i, (w, g) in enumerate(zip(want, got)) if w is not None and w != g
    ]
    if bad:
        names = meta.get("fields") or []
        label = ", ".join(
            str(names[i].get("name") or f"field{i}") if i < len(names) and
            isinstance(names[i], dict) else f"field{i}"
            for i in bad
        )
        return (
            f"lineage mismatch (state was already corrupt when saved) in "
            f"{label}: stored bytes do not reproduce the manifest's "
            f"per-field digest chain"
        )
    return None


def read_prev_chain(prev_meta_path: str | None, nfields: int) -> list[str] | None:
    """The previous generation's chain entries, or None (genesis)."""
    if not prev_meta_path or not os.path.exists(prev_meta_path):
        return None
    try:
        with open(prev_meta_path) as f:
            prev = json.load(f)
        chain = [
            f.get("chain", "") for f in prev.get("lineage", {}).get("fields", ())
        ]
    except (OSError, ValueError):
        return None
    if len(chain) != nfields:
        return None
    return chain
