"""The versioned, schema-checked on-disk winner table of the autotuner.

Counterpart of the JAX package's ``tuning/cache.py``: the same schema,
keys, digests and file names, so an entry written by either package
validates in the other.  One JSON file per ``(backend, topology, model,
size, dtype, batch[, extra])`` key, written atomically
(`utils.telemetry.atomic_write_json`: a temp file + ``os.replace``, so a
crash mid-search can never leave a half-written entry that poisons every
later lookup).  A cache hit is ZERO search cost: no candidate is built or
measured.

Layers: lookups read the PRIMARY directory (``IGG_TUNE_CACHE`` env, else
``~/.cache/implicitglobalgrid_tpu_torch/tune``) first and fall back to the
committed SEED layer (`SEED_DIR`, shipped in the package: winners measured
on the card by ``python -m implicitglobalgrid_tpu_torch.tuning sweep``).
Writes always go to the primary layer.  The key's ``backend`` is the grid
device's type (``"cuda"`` or ``"cpu"``), so an entry measured on a TPU is
never served here.

Refusal is the schema's job: a version mismatch, a corrupt file, a key
drift or an unknown config field makes the lookup a MISS (counted by
``tune.cache_miss``), never a crash and never a silently-applied stale
config.  The committed seed layer is additionally gated by the
``tune-cache-valid`` analyzer (`analysis.tunecache`).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import time

from .space import CONFIG_FIELDS, K_LADDER, MODELS

#: Bump on any incompatible change to the entry layout; readers REFUSE
#: other versions (a stale-schema entry is a finding, not a config).
SCHEMA_VERSION = 1

#: The committed seed layer, shipped next to this module.
SEED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "entries")


def schedule_class(model: str, nsteps: int | None) -> str:
    """The nsteps-derived cadence-admissibility class of a key.

    The winner table deliberately omits ``nsteps`` itself (a winner should
    serve every chunk size that can run it), but the ladder's admissible
    subset ``{w : nsteps % w == 0}`` IS schedule-relevant: keying on the
    CLASS makes two chunk sizes share a winner exactly when they admit the
    same candidates.  Porous cadences chunk ``npt``, not ``nsteps`` (one
    class); ``None`` = an nsteps-agnostic key (``any``).
    """
    if model == "porous_convection3d":
        return "npt"
    if nsteps is None:
        return "any"
    ws = [w for w in K_LADDER if nsteps % w == 0]
    return "w" + ".".join(str(w) for w in ws) if ws else "none"


def default_cache_dir() -> str:
    """``IGG_TUNE_CACHE`` env, else the per-user cache directory."""
    from ..utils.config import tune_cache_env

    env = tune_cache_env()
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "implicitglobalgrid_tpu_torch", "tune"
    )


def topology_string(gg) -> str:
    """Canonical topology component of the key — every rank derives the
    identical string from the shared grid geometry (dims, periods,
    overlaps, process count), never from rank identity."""
    return (
        f"dims={'x'.join(str(d) for d in gg.dims)};"
        f"periods={''.join(str(p) for p in gg.periods)};"
        f"overlaps={'x'.join(str(o) for o in gg.overlaps)};"
        f"nprocs={gg.nprocs}"
    )


def dtype_name(dtype) -> str:
    """The key's dtype string (``"float32"``): a torch dtype's name
    without its ``torch.`` prefix, else numpy's name for ``dtype``."""
    import torch

    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    import numpy as np

    return str(np.dtype(dtype))


def make_key(model: str, shape, dtype, *, batch: int = 0, gg=None,
             backend: str | None = None, topology: str | None = None,
             extra: dict | None = None, nsteps: int | None = None) -> dict:
    """The canonical cache key of one tuning point.

    ``batch=0`` = the unbatched cadence; ``>= 1`` = the ensemble cadence
    (the model hook keys the FLAG as 1).  ``backend`` defaults to the grid
    device's type.  ``extra`` carries model-config fields that change
    NUMERICS and therefore key rather than tune (porous ``npt``).
    ``nsteps`` contributes only its cadence-admissibility CLASS
    (`schedule_class`), so chunk sizes with identical ladders share one
    winner.
    """
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; tunable: {sorted(MODELS)}")
    if (backend is None or topology is None) and gg is None:
        from ..parallel.grid import global_grid

        gg = global_grid()
    if backend is None:
        backend = gg.device.type
    if topology is None:
        topology = topology_string(gg)
    return {
        "backend": str(backend),
        "topology": str(topology),
        "model": str(model),
        "size": [int(x) for x in shape],
        "dtype": dtype_name(dtype),
        "batch": int(batch),
        "schedule": schedule_class(model, nsteps),
        "extra": {str(k): extra[k] for k in sorted(extra)} if extra else {},
    }


def key_digest(key: dict) -> str:
    return hashlib.sha1(
        json.dumps(key, sort_keys=True).encode()
    ).hexdigest()[:10]


def entry_filename(key: dict) -> str:
    n0, n1, n2 = key["size"]
    b = f"_b{key['batch']}" if key["batch"] else ""
    return (
        f"{key['model']}_{n0}x{n1}x{n2}_{key['dtype']}{b}_"
        f"{key_digest(key)}.json"
    )


def new_entry(key: dict, config: dict, *, source: str = "search",
              modeled: dict | None = None, measured: dict | None = None,
              tuner: dict | None = None) -> dict:
    """A schema-complete entry (validated before it is returned — a writer
    can never persist what a reader would refuse)."""
    doc = {
        "schema_version": SCHEMA_VERSION,
        "key": key,
        "config": config,
        "modeled": modeled,
        "measured": measured,
        "source": source,
        "created_unix": round(time.time(), 3),
    }
    if tuner is not None:
        doc["tuner"] = tuner
    validate_entry(doc)
    return doc


def validate_entry(doc) -> tuple[dict, dict]:
    """``(key, config)`` of a schema-valid entry; `ValueError` otherwise.

    Validation is strictly structural (version, key fields, config fields
    and types) — whether the config is ADMISSIBLE on the current ladder is
    `admissibility_error`'s question (the analyzer asks both)."""
    if not isinstance(doc, dict):
        raise ValueError("entry is not a JSON object")
    v = doc.get("schema_version")
    if v != SCHEMA_VERSION:
        raise ValueError(
            f"schema version {v!r} is not the supported {SCHEMA_VERSION} — "
            f"refusing the entry (re-run the search or re-seed)"
        )
    key = doc.get("key")
    if not isinstance(key, dict):
        raise ValueError("entry has no key object")
    for field, typ in (("backend", str), ("topology", str), ("model", str),
                       ("dtype", str), ("batch", int), ("schedule", str)):
        if not isinstance(key.get(field), typ):
            raise ValueError(f"key.{field} missing or not a {typ.__name__}")
    size = key.get("size")
    if (
        not isinstance(size, list) or len(size) != 3
        or not all(isinstance(x, int) and x > 0 for x in size)
    ):
        raise ValueError(f"key.size must be 3 positive ints, got {size!r}")
    if key["model"] not in MODELS:
        raise ValueError(f"key.model {key['model']!r} is not a tunable model")
    config = doc.get("config")
    if not isinstance(config, dict):
        raise ValueError("entry has no config object")
    unknown = sorted(set(config) - set(CONFIG_FIELDS))
    if unknown:
        raise ValueError(
            f"config field(s) {unknown} are not tunable kwargs "
            f"{CONFIG_FIELDS} — a tuned config must be a pure substitution "
            f"of existing kwargs"
        )
    k = config.get("fused_k")
    if k is not None and (not isinstance(k, int) or k < 2 or k % 2 or k > 8):
        raise ValueError(f"config.fused_k={k!r} outside the even [2, 8] ladder")
    tile = config.get("fused_tile")
    if tile is not None:
        if (
            not isinstance(tile, (list, tuple)) or len(tile) != 2
            or not all(isinstance(x, int) and x > 0 for x in tile)
        ):
            raise ValueError(f"config.fused_tile={tile!r} must be 2 positive ints")
        if k is None:
            raise ValueError("config.fused_tile without fused_k")
    w = config.get("exchange_every")
    if w is not None and (not isinstance(w, int) or w < 1):
        raise ValueError(f"config.exchange_every={w!r} must be an int >= 1")
    for flag in ("pipelined", "coalesce"):
        if flag in config and not isinstance(config[flag], (bool, type(None))):
            raise ValueError(f"config.{flag}={config[flag]!r} must be bool/None")
    if not (doc.get("source") or "").strip():
        raise ValueError("entry has no source (provenance is mandatory)")
    return key, config


def admissibility_error(key: dict, config: dict) -> str | None:
    """Why the entry's config is not currently admissible, or None.

    The analyzer's second gate: ``fused_k`` must clear the kernel's
    envelope for the keyed size and dtype, the tile (given, or the ladder's
    first that fits) the kernel's shared-memory and slot checks, a porous
    width the PT schedule, and a ``coalesce`` only a multi-field cadence
    (the diffusion cadence takes none)."""
    from . import space as _space

    model = key["model"]
    shape = tuple(key["size"])
    if "coalesce" in config and MODELS[model]["exchanged_fields"] < 2:
        return f"{model} exchanges one field and takes no coalesce"
    k = config.get("fused_k")
    if k is None:
        return None
    try:
        dtype = _space.torch_dtype(key["dtype"])
    except ValueError as e:
        return str(e)
    err = _space.kernel_module(model).fused_support_error(shape, k, dtype)
    tile = config.get("fused_tile")
    if err is None:
        try:
            _space.launch_tile(model, shape, k, dtype, tile)
        except ValueError as e:
            err = str(e)
    if err is not None:
        return f"fused_k={k} tile={tile}: {err}"
    if model == "porous_convection3d":
        from ..models.porous_convection3d import _pt_schedule

        npt = key.get("extra", {}).get("npt")
        if npt is None:
            return "porous entry without key.extra.npt (npt keys, not tunes)"
        if not _pt_schedule(int(npt), k)[1]:
            return f"npt={npt} leaves no even kernel chunk at w={k}"
    return None


class TuneCache:
    """The layered winner table (see module docstring).

    ``primary=None`` resolves `default_cache_dir` per call, so a test (or
    rank) flipping ``IGG_TUNE_CACHE`` is honored without rebuilding."""

    def __init__(self, primary: str | None = None, fallbacks=None):
        self._primary = primary
        self.fallbacks = tuple(
            fallbacks if fallbacks is not None else (SEED_DIR,)
        )
        self.last_refusal: str | None = None

    @property
    def primary(self) -> str:
        return self._primary or default_cache_dir()

    def _layers(self):
        return (self.primary,) + self.fallbacks

    def path_for(self, key: dict, layer: str | None = None) -> str:
        return os.path.join(layer or self.primary, entry_filename(key))

    def lookup(self, key: dict) -> dict | None:
        """The entry for ``key`` from the first layer that holds a VALID
        one; None on miss.  Refusals (corrupt file, schema mismatch, key
        drift) are recorded on ``last_refusal`` and fall through to the
        next layer — a bad entry degrades to the default config, never to
        a crash."""
        self.last_refusal = None
        for layer in self._layers():
            path = self.path_for(key, layer)
            if not os.path.exists(path):
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
            except ValueError as e:
                self.last_refusal = f"{path}: corrupt JSON ({e})"
                continue
            except OSError as e:
                # unreadable (permissions, stale NFS handle, a directory
                # squatting on the name): the never-crash contract says
                # degrade to the next layer / the default config
                self.last_refusal = f"{path}: unreadable ({e})"
                continue
            try:
                got_key, _config = validate_entry(doc)
            except ValueError as e:
                self.last_refusal = f"{path}: {e}"
                continue
            if got_key != key:
                self.last_refusal = (
                    f"{path}: key drift — the file's key is not the "
                    f"looked-up key (digest collision or a hand edit)"
                )
                continue
            return doc
        return None

    def store(self, key: dict, entry: dict) -> str:
        """Atomically publish ``entry`` into the primary layer."""
        validate_entry(entry)
        from ..utils.telemetry import atomic_write_json

        os.makedirs(self.primary, exist_ok=True)
        path = self.path_for(key)
        atomic_write_json(path, entry, indent=1)
        return path

    def entries(self):
        """Every (path, doc-or-None) across the layers, primary first —
        ``None`` doc = unparseable file (the CLI's ``show`` lists both)."""
        out = []
        seen = set()
        for layer in self._layers():
            for path in sorted(glob.glob(os.path.join(layer, "*.json"))):
                name = os.path.basename(path)
                if name in seen:
                    continue  # primary shadows the seed layer
                seen.add(name)
                try:
                    with open(path, encoding="utf-8") as f:
                        out.append((path, json.load(f)))
                except (OSError, ValueError):
                    out.append((path, None))
        return out

    def clear(self) -> int:
        """Delete the PRIMARY layer's entries (the committed seed layer is
        repo content — ``clear`` never touches it)."""
        n = 0
        for path in glob.glob(os.path.join(self.primary, "*.json")):
            os.remove(path)
            n += 1
        return n


# -- offline seeding from the committed H100 bench records --------------------

#: Which bench extras seed which keys (JAX's five rows, under the names the
#: port's bench keeps).  Each row: the dotted extras path of a measured
#: teff, the tuning point `benchmarks.bench` ran it at (a one-card grid,
#: the default overlaps, no periodicity) and the config it ran.  Only
#: extras that ran the kernel on the card (``path == "cuda-fused"``) seed: a
#: ``cpu-fused-plain`` record measured the kernels' plain versions.
SEEDABLE = (
    # "nsteps" = the chunk the bench ran (24 for the diffusion and
    # acoustic fused configs): it keys only through its admissibility
    # CLASS (`schedule_class`; 24 admits the whole even ladder)
    {"path": "diffusion_pallas_fused4", "model": "diffusion3d",
     "size": (256, 256, 256), "dtype": "float32", "nsteps": 24,
     "config": {"fused_k": 4}, "extra": None},
    # JAX's row carries its TPU tile; the port's bench runs the kernel's
    # own tile pick at 512^3 (`ops.fused_stencil.launch_tile`)
    {"path": "diffusion_512_pallas_fused4", "model": "diffusion3d",
     "size": (512, 512, 512), "dtype": "float32", "nsteps": 24,
     "config": {"fused_k": 4}, "extra": None},
    {"path": "acoustic_256_pallas_fused6", "model": "acoustic3d",
     "size": (256, 256, 256), "dtype": "float32", "nsteps": 24,
     "config": {"fused_k": 6}, "extra": None},
    {"path": "porous_256_pallas_fused.npt12_w6", "model": "porous_convection3d",
     "size": (256, 256, 256), "dtype": "float32",
     "config": {"fused_k": 6}, "extra": {"npt": 12},
     "provenance_from": "porous_256_pallas_fused"},
    {"path": "porous_256_pallas_fused.npt10_w6_ragged",
     "model": "porous_convection3d",
     "size": (256, 256, 256), "dtype": "float32",
     "config": {"fused_k": 6}, "extra": {"npt": 10},
     "provenance_from": "porous_256_pallas_fused"},
)

#: The bench's one-card topology: `benchmarks.bench` builds each fused
#: config's grid with the default overlaps and no periodicity (pinned
#: against the grids it builds in ``tests/test_torch_tuning.py``).
BENCH_TOPOLOGY = "dims=1x1x1;periods=000;overlaps=2x2x2;nprocs=1"

#: The headline metric of a bench record run at the sizes `SEEDABLE` keys
#: (the bench scales its extras with ``--n``; a record at another n seeds
#: nothing).
BENCH_METRIC = "diffusion3d_256_float32_teff"


def _extras_get(extras: dict, dotted: str):
    node = extras
    for part in dotted.split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node


def seed_from_bench(repo_root: str, cache: TuneCache | None = None, *,
                    write: bool = True):
    """Ingest the committed ``BENCH_H100_r<NN>.json`` records into seed
    entries, under the ``cuda`` backend (only a ``cuda-fused`` extra seeds).

    The NEWEST round carrying each seedable extra wins; provenance
    (``source: seed:bench_h100_rNN``) is recorded per entry, so a reader
    knows the winner is a measured bench config, not a local search.  A
    record whose headline metric is not `BENCH_METRIC`, or whose card or
    power limit is not the newest such record's, seeds nothing.  Returns
    the entry list; ``write=False`` = dry run.
    """
    from ..analysis.perf import comparability_error, load_bench_records

    cache = cache or TuneCache()
    records = [(n, rec) for n, rec in load_bench_records(repo_root)[0]
               if rec.get("metric") == BENCH_METRIC]
    records = [(n, rec) for n, rec in records
               if comparability_error(rec, records[-1][1]) is None]
    out = []
    for row in SEEDABLE:
        seeded = None
        for round_n, rec in records:  # ascending: the last hit is newest
            node = _extras_get(rec.get("extras", {}), row["path"])
            if not isinstance(node, dict):
                continue
            teff = node.get("teff")
            prov = node
            if "provenance_from" in row:
                prov = _extras_get(rec.get("extras", {}),
                                   row["provenance_from"]) or {}
            if not isinstance(teff, (int, float)):
                continue
            if prov.get("path") != "cuda-fused":
                continue  # the plain versions' number, not this config's
            seeded = (round_n, float(teff), node.get("t_it_ms"))
        if seeded is None:
            continue
        round_n, teff, t_it_ms = seeded
        key = make_key(
            row["model"], row["size"], row["dtype"], batch=0,
            backend="cuda", topology=BENCH_TOPOLOGY, extra=row["extra"],
            nsteps=row.get("nsteps"),
        )
        entry = new_entry(
            key, dict(row["config"]),
            source=f"seed:bench_h100_r{round_n:02d}",
            measured={
                "teff_gbs": teff,
                "t_step_s": (t_it_ms / 1e3) if isinstance(
                    t_it_ms, (int, float)) else None,
                "steps": None,
            },
        )
        if write:
            cache.store(key, entry)
        out.append(entry)
    return out
