"""Checkpoint/restart for the port's fields, in the JAX package's format.

Each process writes only its own block of every field (halos included) plus
one small JSON manifest; the de-duplicated global array is never built on
the fast path.  The on-disk format is the JAX package's
(``utils/checkpoint.py``) byte for byte, so each package restores the
other's checkpoints::

    <dir>/step_00000012/
        shards_p0.npz      per process: raw block bytes + block offsets
        shards_p1.npz
        meta.json          manifest: grid topology, per-shard CRC32s and
                           sizes, lineage digests; written LAST inside a
                           hidden ``.step_*.tmp`` directory that is renamed
                           to ``step_*`` once complete

A block is stored as its raw bytes (``f{i}_o{x}_{y}_{z}``, a uint8 vector)
and its shape (``…_shape``); the offsets are the block's position in the
global-block layout (`ops.gather`), ``coords[d] * local_shape[d]``, and a
field's ``global_shape`` is ``dims * local_shape``.  A batched field ``(B,
*block)`` keeps offset 0 on its member axis.  The dtype is numpy's name
(``"float32"``) or ``"bfloat16"``, which the port maps to
``torch.bfloat16`` without numpy, so every dtype round-trips bit-exactly.

Integrity (format 2): the manifest carries per-shard CRC32s and byte
counts; `verify_checkpoint` replays them and the lineage digests
(`integrity.lineage`, hashed from the host copy of each block before any
byte hits disk), and `latest_checkpoint` falls back generation by
generation to the newest one that passes.  Format 1 (pre-manifest) stays
readable.

Elastic restore: any ``(nxyz, dims, overlaps, periods)`` implying the same
``nxyz_g`` describes the same grid, so `restore_checkpoint` accepts any
admissible target topology: each rank assembles one field's de-duplicated
global array at a time from every shard file (`ops.gather.assemble_dedup`)
and cuts its own block out of it.  One process runs one block here while a
JAX process may hold several, so a checkpoint written by one package and
read by the other takes this path in both directions, bit-exactly.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import shutil
import sys
import zlib
from typing import Sequence

import numpy as np
import torch

from ..integrity import lineage as _lineage
from ..parallel import distributed as _dist
from ..parallel import grid as _grid
from ..parallel.topology import NDIMS
from . import config as _config
from . import telemetry as _telemetry
from . import tracing as _tracing

FORMAT_VERSION = 2
#: formats this build can restore (1 = pre-manifest, no integrity data)
READABLE_FORMATS = (1, 2)
_META = "meta.json"

#: keys of `GlobalGrid.checkpoint_meta` the same-topology fast path must
#: match (``device_type`` is informational: a CPU-written checkpoint
#: restores on the card).  An elastic restore only needs admissibility
#: (`parallel.grid.elastic_topology_error`).
_MATCH_KEYS = ("dims", "nxyz", "nxyz_g", "overlaps", "periods", "disp", "nprocs")


def _step_dirname(step: int) -> str:
    return f"step_{step:08d}"


def _tmp_dirname(step: int) -> str:
    # Dot-prefixed: never matches the `step_*` scan.
    return f".{_step_dirname(step)}.tmp"


def _shard_name(pid: int) -> str:
    return f"shards_p{pid}.npz"


def _dtype_to_str(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``"bfloat16"`` for bfloat16)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=dtype).numpy().dtype.name


def _dtype_from_str(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    try:
        return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype
    except TypeError:
        raise ValueError(
            f"Checkpoint field dtype {name!r} has no torch counterpart."
        ) from None


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(buf, crc)


def _lead(A) -> int:
    """Leading non-grid axes of a field (a batch's member axis)."""
    return max(0, A.dim() - NDIMS)


def _block_offsets(A, gg) -> tuple[int, ...]:
    lead = _lead(A)
    return (0,) * lead + tuple(
        gg.coords[d] * A.shape[lead + d] for d in range(A.dim() - lead)
    )


def _global_shape(A, gg) -> tuple[int, ...]:
    lead = _lead(A)
    return tuple(A.shape[:lead]) + tuple(
        gg.dims[d] * A.shape[lead + d] for d in range(A.dim() - lead)
    )


def _host_bytes(A) -> np.ndarray:
    """The block's bytes as a flat uint8 numpy vector (one device-to-host
    copy; a view of the tensor for a CPU field)."""
    A = A.detach().contiguous()
    return A.reshape(-1).view(torch.uint8).cpu().numpy()


def save_checkpoint(
    directory: str | os.PathLike,
    state: Sequence,
    step: int,
    *,
    extra: dict | None = None,
) -> str:
    """Write a checkpoint of ``state`` (a sequence of this rank's field
    blocks).

    Collective: every process must call it (each writes its own shard
    file; a barrier orders the manifest after all shard files; process 0
    renames the staged directory into place, and a second barrier
    guarantees the returned path is published on every process).  Returns
    the step directory path.  Each block is copied to the host once; its
    lineage digest is hashed from that copy before the writer runs.
    Refused (`supervisor.generation.FenceError`) on a superseded
    incarnation.
    """
    with _tracing.trace_span("igg.checkpoint.save", step=step):
        return _save_checkpoint(directory, state, step, extra=extra)


def _save_checkpoint(directory, state: Sequence, step: int, *, extra: dict | None) -> str:
    from ..supervisor import generation as _generation
    from . import resilience as _res

    _generation.check_fence("checkpoint.save")
    _grid.check_initialized()
    gg = _grid.global_grid()
    state = tuple(state)
    if not state:
        raise ValueError("save_checkpoint requires a non-empty state.")
    step = int(step)
    if step < 0:
        raise ValueError(f"step must be >= 0 (got {step})")

    pid = _dist.process_index()
    directory = os.fspath(directory)
    step_dir = os.path.join(directory, _step_dirname(step))
    tmp_dir = os.path.join(directory, _tmp_dirname(step))
    os.makedirs(tmp_dir, exist_ok=True)

    payload: dict[str, np.ndarray] = {}
    fields_meta = []
    for i, A in enumerate(state):
        if not isinstance(A, torch.Tensor):
            raise TypeError(
                f"save_checkpoint: state[{i}] is {type(A).__name__}, expected "
                f"a torch.Tensor block."
            )
        fields_meta.append(
            {"global_shape": list(_global_shape(A, gg)), "dtype": _dtype_to_str(A.dtype)}
        )
        key = "f%d_o%s" % (i, "_".join(map(str, _block_offsets(A, gg))))
        payload[key] = _host_bytes(A)
        payload[key + "_shape"] = np.asarray(tuple(A.shape), dtype=np.int64)

    # Lineage digests from the host copies, BEFORE the writer (or the
    # ``bit_flip:…:ckpt`` injection below) touches them: the digest vouches
    # for the state being saved, the CRC for the bytes as written.
    block_digests = {
        key: _lineage.block_digest(buf)
        for key, buf in payload.items()
        if not key.endswith("_shape")
    }
    _res.get_fault_injector().maybe_bit_flip_ckpt(payload, step)

    shard_path = os.path.join(tmp_dir, _shard_name(pid))
    tmp = shard_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, shard_path)
    # Sidecar: how process 0 learns every shard's integrity record without a
    # data collective (the checkpoint directory is the shared medium).
    sidecar = {
        "file": _shard_name(pid),
        "bytes": os.path.getsize(shard_path),
        "crc32": _crc32_file(shard_path),
        "blocks": block_digests,
    }
    _telemetry.atomic_write_json(shard_path + ".crc.json", sidecar, fsync=False)

    _dist.sync_all_processes(gg.device)
    if pid == 0:
        shards: dict[str, dict] = {}
        all_blocks: dict[str, str] = {}
        for p in range(_dist.process_count()):
            sc_path = os.path.join(tmp_dir, _shard_name(p) + ".crc.json")
            try:
                with open(sc_path) as f:
                    rec = json.load(f)
            except (OSError, ValueError) as e:
                raise RuntimeError(
                    f"save_checkpoint: process {p}'s integrity sidecar "
                    f"{sc_path} is unreadable after the barrier ({e!r}); is "
                    f"the checkpoint directory shared by all processes?"
                ) from e
            shards[rec["file"]] = {"bytes": rec["bytes"], "crc32": rec["crc32"]}
            all_blocks.update(rec.get("blocks") or {})
        # Roll the lineage chain forward from the newest OLDER generation.
        prev_meta_path = prev_step = None
        for s, p in reversed(checkpoint_steps(directory)):
            if s < step:
                prev_meta_path, prev_step = os.path.join(p, _META), s
                break
        field_digests = _lineage.field_digests_from_blocks(all_blocks, len(state))
        chain = _lineage.chain_field_digests(
            field_digests, _lineage.read_prev_chain(prev_meta_path, len(state))
        )
        meta = {
            "format": FORMAT_VERSION,
            "step": step,
            "nfields": len(state),
            "fields": fields_meta,
            "grid": gg.checkpoint_meta(),
            "process_count": int(_dist.process_count()),
            "shards": shards,
            "lineage": {
                "fields": [{"digest": d, "chain": c} for d, c in zip(field_digests, chain)],
                "blocks": all_blocks,
                "prev_step": prev_step,
            },
            "extra": extra or {},
        }
        gen = _config.generation_env()
        if gen is not None:
            meta["generation"] = gen
        _telemetry.atomic_write_json(
            os.path.join(tmp_dir, _META), meta, fsync=False, indent=1
        )
        for sc in _glob.glob(os.path.join(tmp_dir, "*.crc.json")):
            try:
                os.remove(sc)
            except OSError:
                pass
        # Atomic publish; a same-step generation (a rolled-back rerun) is
        # replaced.
        shutil.rmtree(step_dir, ignore_errors=True)
        os.rename(tmp_dir, step_dir)
        _res.get_fault_injector().maybe_damage_checkpoint(step_dir, step)
    _dist.sync_all_processes(gg.device)
    _telemetry.event("checkpoint.saved", step=step, path=step_dir,
                     shard_bytes=sidecar["bytes"])
    _telemetry.counter("checkpoint.saves").inc()
    _telemetry.counter("checkpoint.shard_bytes").inc(sidecar["bytes"])
    return step_dir


def checkpoint_steps(directory: str | os.PathLike) -> list[tuple[int, str]]:
    """All published checkpoint generations under ``directory``, sorted by
    step ascending, as ``(step, path)`` pairs.  Published = the ``step_*``
    rename happened and ``meta.json`` is present; integrity is NOT checked
    here (see `verify_checkpoint` / `latest_checkpoint`)."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        path = os.path.join(directory, name)
        if not os.path.isfile(os.path.join(path, _META)):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        out.append((step, path))
    out.sort()
    return out


def verify_checkpoint(path: str | os.PathLike) -> str | None:
    """Why checkpoint ``path`` fails integrity verification, or None.

    Format 2: every manifest-listed shard file must exist with the recorded
    byte count and CRC32 (truncation, corruption); then the lineage digests
    are replayed, streamed in bounded chunks: a CRC-clean generation whose
    bytes do not reproduce the per-field digests was already corrupt WHEN
    SAVED.  Format 1 predates the manifest: the completion marker is the
    only check.
    """
    path = os.fspath(path)
    meta_path = os.path.join(path, _META)
    if not os.path.isfile(meta_path):
        return f"no completion marker ({_META})"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        return f"unreadable {_META} ({e})"
    fmt = meta.get("format")
    if fmt not in READABLE_FORMATS:
        return f"unknown checkpoint format {fmt!r} (this build reads {READABLE_FORMATS})"
    shards = meta.get("shards")
    if shards is None:
        return None  # format 1: no integrity data to replay
    for fname, rec in shards.items():
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            return f"missing shard file {fname}"
        size = os.path.getsize(fpath)
        if size != rec["bytes"]:
            return (
                f"shard {fname} truncated: {size} bytes on disk vs "
                f"{rec['bytes']} in the manifest"
            )
        crc = _crc32_file(fpath)
        if crc != rec["crc32"]:
            return (
                f"shard {fname} corrupt: CRC32 {crc:#010x} on disk vs "
                f"{rec['crc32']:#010x} in the manifest"
            )
    return _lineage.lineage_problem(path, meta)


def latest_checkpoint(directory: str | os.PathLike, *, verify: bool = True) -> str | None:
    """Newest VALID checkpoint directory under ``directory``, or None.

    Walks generations newest-first: a generation failing
    `verify_checkpoint` is reported to stderr and SKIPPED, falling back to
    the next older one.  ``verify=False`` returns the newest published
    generation unchecked.  A verifying walk sets the
    ``checkpoint.fallback_depth`` gauge (generations skipped).
    """
    skipped = 0
    for step, path in reversed(checkpoint_steps(directory)):
        if not verify:
            return path
        problem = verify_checkpoint(path)
        if problem is None:
            _telemetry.gauge("checkpoint.fallback_depth").set(skipped)
            if skipped:
                _telemetry.event("checkpoint.fallback_depth", depth=skipped, path=path)
            return path
        skipped += 1
        _telemetry.event("checkpoint.fallback", path=path, problem=problem)
        _telemetry.counter("checkpoint.fallbacks").inc()
        print(
            f"[igg.checkpoint] skipping invalid checkpoint {path}: {problem} "
            f"(falling back to the previous generation)",
            file=sys.stderr,
            flush=True,
        )
    return None


def checkpoint_meta(path: str | os.PathLike) -> dict:
    """Read a checkpoint's ``meta.json`` (raises if incomplete/missing)."""
    meta_path = os.path.join(os.fspath(path), _META)
    try:
        with open(meta_path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"No complete checkpoint at {os.fspath(path)!r} (missing "
            f"{_META}; was the save interrupted?)."
        ) from None


def restore_checkpoint(
    path: str | os.PathLike,
    *,
    like: Sequence | None = None,
    strict: bool = False,
    verify: bool = True,
) -> tuple[tuple, int, dict]:
    """Restore ``(state, step, extra)`` from a checkpoint directory.

    Requires an initialized grid.  When the current topology matches the
    save exactly (dims, local sizes, overlaps, periods, process count),
    each process reads only its own shard file.  Otherwise the ELASTIC
    path runs (unless ``strict=True``): the target topology must be
    admissible (same implied ``nxyz_g`` and periodicity,
    `parallel.grid.elastic_topology_error`), and each rank assembles every
    field's de-duplicated global array from all shard files and cuts its
    own block out of it.  Both paths are bit-exact: every restored cell is
    a byte copy of its owning saved block's cell.

    ``verify=True`` (default) replays the manifest first; a damaged
    checkpoint raises instead of restoring garbage (`latest_checkpoint`
    falls back to the newest valid generation).  ``like``: this rank's
    blocks to restore INTO — each is checked for shape and written with one
    ``copy_`` on its device, and the returned state is ``like``'s tensors;
    without it, new tensors on the grid's device are returned.
    """
    with _tracing.trace_span("igg.checkpoint.restore", path=os.fspath(path)):
        return _restore_checkpoint(path, like=like, strict=strict, verify=verify)


def _restore_checkpoint(path, *, like: Sequence | None, strict: bool,
                        verify: bool) -> tuple[tuple, int, dict]:
    _grid.check_initialized()
    gg = _grid.global_grid()
    path = os.fspath(path)
    meta = checkpoint_meta(path)
    if meta.get("format") not in READABLE_FORMATS:
        raise ValueError(
            f"Checkpoint {path!r} has format {meta.get('format')!r}; this "
            f"build reads formats {READABLE_FORMATS}."
        )
    if verify:
        problem = verify_checkpoint(path)
        if problem is not None:
            _telemetry.event("checkpoint.verify_failed", path=path, problem=problem)
            raise ValueError(
                f"Checkpoint {path!r} failed integrity verification: "
                f"{problem}. Use latest_checkpoint() to fall back to the "
                f"newest valid generation."
            )
    saved_grid = meta["grid"]
    current = gg.checkpoint_meta()
    mismatch = [k for k in _MATCH_KEYS if saved_grid.get(k) != current[k]]
    pid = _dist.process_index()
    same_procs = meta["process_count"] == _dist.process_count()
    shard_path = os.path.join(path, _shard_name(pid))
    if like is not None:
        like = tuple(like)
        if len(like) != meta["nfields"]:
            raise ValueError(
                f"Checkpoint {path!r} holds {meta['nfields']} field(s) but "
                f"`like` has {len(like)}."
            )

    if strict:
        if mismatch:
            detail = ", ".join(
                f"{k}: checkpoint {saved_grid.get(k)} vs current {current[k]}"
                for k in mismatch
            )
            raise ValueError(
                f"Checkpoint {path!r} was written for a different grid "
                f"topology ({detail}). Re-init the global grid with the same "
                f"local sizes and dims to restore it (or drop strict=True "
                f"for an elastic restore)."
            )
        if not same_procs:
            raise ValueError(
                f"Checkpoint {path!r} was written by {meta['process_count']} "
                f"process(es) but this job runs {_dist.process_count()}; restart "
                f"with the same process count (or drop strict=True for an "
                f"elastic restore)."
            )
    if not mismatch and same_procs and os.path.isfile(shard_path):
        try:
            blocks = _restore_same_topology(path, meta, gg, pid)
            mode = "same_topology"
        except KeyError:
            # Same topology and process count but another rank-to-block
            # layout: strict keeps the error, the elastic path reassembles.
            if strict:
                raise
            blocks, mode = _restore_elastic(path, meta, gg), "elastic"
    elif strict:
        raise FileNotFoundError(
            f"Checkpoint {path!r} has no shard file for process {pid} "
            f"({shard_path}); it was written by a different process layout."
        )
    else:
        blocks, mode = _restore_elastic(path, meta, gg), "elastic"
    state = _to_device(blocks, meta, gg, like)
    event = dict(mode=mode, step=int(meta["step"]), path=path)
    if mode == "elastic":
        event.update(saved_dims=list(saved_grid["dims"]), current_dims=list(gg.dims))
        _telemetry.counter("checkpoint.elastic_restores").inc()
    _telemetry.event("checkpoint.restore", **event)
    _telemetry.counter("checkpoint.restores").inc()
    return state, int(meta["step"]), meta.get("extra", {})


def _to_device(blocks, meta, gg, like) -> tuple:
    """This rank's host blocks (uint8 numpy, shape, dtype name) as tensors
    on the grid's device — into ``like`` when given."""
    state = []
    for i, (raw, shape, dtype_name) in enumerate(blocks):
        t = torch.from_numpy(np.ascontiguousarray(raw)).view(
            _dtype_from_str(dtype_name)).reshape(shape)
        if like is None:
            state.append(t.to(gg.device))
            continue
        if tuple(like[i].shape) != tuple(shape):
            raise ValueError(
                f"Checkpoint field {i} restores to local shape {tuple(shape)} on "
                f"this grid but `like[{i}]` has {tuple(like[i].shape)}."
            )
        if like[i].dtype != t.dtype:
            raise ValueError(
                f"Checkpoint field {i} has dtype {t.dtype} but `like[{i}]` has "
                f"{like[i].dtype}."
            )
        like[i].copy_(t)
        state.append(like[i])
    return tuple(state)


def _restore_same_topology(path, meta, gg, pid) -> list:
    """The fast path: this process reads only its own shard file."""
    blocks = []
    with np.load(os.path.join(path, _shard_name(pid))) as npz:
        for i, fmeta in enumerate(meta["fields"]):
            gshape = tuple(fmeta["global_shape"])
            nd = len(gshape)
            lead = max(0, nd - NDIMS)
            grid_nd = nd - lead
            bshape = gshape[:lead] + tuple(gshape[lead + d] // gg.dims[d] for d in range(grid_nd))
            starts = (0,) * lead + tuple(gg.coords[d] * bshape[lead + d] for d in range(grid_nd))
            key = f"f{i}_o" + "_".join(map(str, starts))
            if key not in npz.files:
                raise KeyError(
                    f"Checkpoint {path!r} shard file for process {pid} has "
                    f"no block at offsets {starts} for field {i}; the "
                    f"rank-to-block layout changed since the save."
                )
            shape = tuple(int(s) for s in npz[key + "_shape"])
            blocks.append((npz[key], shape, fmeta["dtype"]))
    return blocks


def _saved_shard_files(path: str, meta: dict) -> list[str]:
    """Every shard file of a checkpoint (manifest-driven for format 2, so
    stray files from crashed earlier attempts cannot pollute an assembly)."""
    shards = meta.get("shards")
    if shards is not None:
        return [os.path.join(path, name) for name in sorted(shards)]
    return sorted(_glob.glob(os.path.join(path, "shards_p*.npz")))


def _restore_elastic(path, meta, gg) -> list:
    """Reshard-on-restore: per field, reassemble the de-duplicated global
    array from the saved blocks of every shard file and cut this rank's
    block out of it (wrapping modulo ``nxyz_g`` in periodic dimensions)."""
    from ..ops import gather as _gather
    from ..parallel.grid import elastic_topology_error

    saved_grid = meta["grid"]
    err = elastic_topology_error(saved_grid, gg.checkpoint_meta())
    if err is not None:
        raise ValueError(
            f"Checkpoint {path!r} cannot be elastically restored on the "
            f"current grid: {err}."
        )
    files = _saved_shard_files(path, meta)
    if not files:
        raise FileNotFoundError(f"Checkpoint {path!r} has no shard files to reassemble from.")
    npzs = [np.load(p) for p in files]
    nxyz_s = tuple(saved_grid["nxyz"])
    over_s = tuple(saved_grid["overlaps"])
    periods = tuple(saved_grid["periods"])
    out = []
    try:
        for i, fmeta in enumerate(meta["fields"]):
            gshape = tuple(fmeta["global_shape"])
            dtype_name = fmeta["dtype"]
            dtype = _dtype_from_str(dtype_name)
            prefix = f"f{i}_o"
            blocks: dict[tuple[int, ...], np.ndarray] = {}
            bshape = None
            for npz in npzs:
                for key in npz.files:
                    if not key.startswith(prefix) or key.endswith("_shape"):
                        continue
                    starts = tuple(int(s) for s in key[len(prefix):].split("_"))
                    shape = tuple(int(s) for s in npz[key + "_shape"])
                    if bshape is None:
                        bshape = shape
                    elif shape != bshape:
                        raise ValueError(
                            f"Checkpoint {path!r} field {i} has blocks of "
                            f"differing shapes ({bshape} vs {shape}); cannot "
                            f"reassemble."
                        )
                    coords = tuple(s // b for s, b in zip(starts, shape))
                    if coords in blocks:
                        continue  # a copy of a block another rank also wrote
                    blocks[coords] = _host_view(npz[key], dtype).reshape(shape)
            if not blocks:
                raise ValueError(f"Checkpoint {path!r} holds no blocks for field {i}.")
            ndim = len(gshape)
            lead = max(0, ndim - len(nxyz_s))
            nxyz_tf = bshape[:lead] + tuple(gg.nxyz)
            nxyz_sf = bshape[:lead] + nxyz_s
            # Target local shape: the field keeps its stagger offset
            # relative to the grid's local size.
            tshape = tuple(nxyz_tf[d] + (bshape[d] - nxyz_sf[d]) for d in range(ndim))
            if bshape == gshape and tshape == bshape:
                # One block per dimension saved and restored: the block IS
                # the field (its halos kept as saved).
                out.append((_raw(blocks[(0,) * ndim]), bshape, dtype_name))
                continue
            nblocks = tuple(g // b for g, b in zip(gshape, bshape))
            if len(blocks) != int(np.prod(nblocks)):
                raise ValueError(
                    f"Checkpoint {path!r} field {i}: expected "
                    f"{int(np.prod(nblocks))} blocks ({nblocks} per dim), found "
                    f"{len(blocks)} across {len(npzs)} shard file(s); the "
                    f"checkpoint is incomplete."
                )
            # Leading (batch) axes are degenerate grid dims: one block,
            # overlap 0, aperiodic.
            if lead and bshape[:lead] != gshape[:lead]:
                raise ValueError(
                    f"Checkpoint {path!r} field {i}: leading axis extents "
                    f"{bshape[:lead]} per block vs {gshape[:lead]} global — "
                    f"only UNSHARDED leading (batch) axes are elastically "
                    f"restorable."
                )
            over_sf = (0,) * lead + over_s
            periods_f = (0,) * lead + periods
            over_tf = (0,) * lead + tuple(gg.overlaps)
            dims_tf = (1,) * lead + tuple(gg.dims)
            coords_tf = (0,) * lead + tuple(gg.coords)
            ols_s = tuple(bshape[d] - (nxyz_sf[d] - over_sf[d]) for d in range(ndim))
            if any(o < 0 for o in ols_s):
                raise ValueError(
                    f"Checkpoint {path!r} field {i} (local shape {bshape}) does "
                    f"not follow the halo size convention (negative overlap "
                    f"{ols_s}); elastic restore cannot reassemble it."
                )
            glens = tuple(
                _gather.dedup_length(nblocks[d], bshape[d], ols_s[d], bool(periods_f[d]))
                for d in range(ndim)
            )
            glob = _gather.assemble_dedup(blocks, bshape, nblocks, ols_s, periods_f[:ndim],
                                          blocks[next(iter(blocks))].dtype)
            ols_t = tuple(tshape[d] - (nxyz_tf[d] - over_tf[d]) for d in range(ndim))
            if any(o < 0 for o in ols_t) or any(s < 1 for s in tshape):
                raise ValueError(
                    f"Checkpoint {path!r} field {i}: target local shape {tshape} "
                    f"(overlaps {ols_t}) is not realizable on the current grid."
                )
            glens_t = tuple(
                _gather.dedup_length(dims_tf[d], tshape[d], ols_t[d], bool(periods_f[d]))
                for d in range(ndim)
            )
            if glens_t != glens:
                raise ValueError(
                    f"Checkpoint {path!r} field {i}: de-duplicated global extent "
                    f"{glens} under the save does not match {glens_t} under the "
                    f"current grid."
                )
            idxs = [
                _gather.dedup_indices(coords_tf[d], 0, tshape[d], tshape[d], ols_t[d], glens[d])
                for d in range(ndim)
            ]
            out.append((_raw(glob[np.ix_(*idxs)]), tshape, dtype_name))
            del glob
    finally:
        for npz in npzs:
            npz.close()
    return out


def _host_view(raw: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Stored uint8 bytes as opaque numpy elements of the field's width: the
    reassembly only moves bytes, so every dtype (bfloat16 included) takes
    the same path."""
    return raw.view(np.dtype((np.void, dtype.itemsize)))


def _raw(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def prune_checkpoints(
    directory: str | os.PathLike, *, keep: int = 2, protect_valid: bool = True
) -> list[str]:
    """Delete all but the newest ``keep`` checkpoints (process 0 only; other
    ranks no-op).  Returns the removed paths.

    ``protect_valid`` (default): pruning refuses to delete the only
    integrity-verified generation — if none of the ``keep`` newest pass
    `verify_checkpoint`, the newest VALID older generation is retained too.
    """
    if keep < 1:
        raise ValueError(f"keep must be >= 1 (got {keep})")
    if _dist.process_index() != 0:
        return []
    complete = checkpoint_steps(directory)
    doomed = complete[:-keep]
    if protect_valid and doomed:
        kept = complete[-keep:]
        if not any(verify_checkpoint(p) is None for _, p in reversed(kept)):
            for entry in reversed(doomed):
                if verify_checkpoint(entry[1]) is None:
                    doomed.remove(entry)
                    print(
                        f"[igg.checkpoint] prune: keeping {entry[1]} — it is "
                        f"the only generation passing integrity verification",
                        file=sys.stderr,
                        flush=True,
                    )
                    break
    removed = []
    for _, path in doomed:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    if removed:
        _telemetry.event("checkpoint.prune", removed=removed, keep=keep)
        _telemetry.counter("checkpoint.prunes").inc(len(removed))
    return removed
