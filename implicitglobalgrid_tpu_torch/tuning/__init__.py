"""Autotuned kernel & schedule configs (the JAX package's ``tuning``).

Per-card tuned launch configs: a cost-model-pruned search over the
schedule kwargs the models already expose (``fused_k``, the Hopper
kernels' ``fused_tile`` ladder, ``exchange_every``, ``pipelined``,
``coalesce``), measured on the card, with a versioned on-disk winner table
so the search runs ONCE per (backend, topology, model, size, dtype, batch)
point:

* `space` — candidate enumeration + the static prior (shared memory per
  block and slots from each kernel's tile check, modeled HBM bytes of the
  x-marching wavefront, collective counts);
* `cache` — the schema-checked atomic winner table (``IGG_TUNE_CACHE``
  primary layer + the committed seed layer `cache.SEED_DIR`);
* `search` — measurement, the SPMD-consistent rank-0-decides/broadcast
  resolve, and the ``make_multi_step`` hook behind ``autotune=`` /
  ``IGG_AUTOTUNE``.

CLI: ``python -m implicitglobalgrid_tpu_torch.tuning
sweep|show|seed|clear``.  Gate: the ``tune-cache-valid`` analyzer
(`analysis.tunecache`) over the committed seed layer.  `seed_from_bench`
(JAX's) ingests the hand-picked configs the committed
``BENCH_H100_r<NN>.json`` records measured on the card into seed entries
(``source: seed:bench_h100_rNN``).
"""

from .cache import (  # noqa: F401
    BENCH_METRIC,
    BENCH_TOPOLOGY,
    SCHEMA_VERSION,
    SEEDABLE,
    SEED_DIR,
    TuneCache,
    admissibility_error,
    default_cache_dir,
    entry_filename,
    key_digest,
    make_key,
    new_entry,
    schedule_class,
    seed_from_bench,
    topology_string,
    validate_entry,
)
from .search import (  # noqa: F401
    apply_tuned_config,
    autotune_requested,
    control_plan,
    measure_candidate,
    project_config,
    resolve_tuned_config,
)
from .space import (  # noqa: F401
    CONFIG_FIELDS,
    MODELS,
    candidate_space,
    modeled_cost,
    modeled_seconds,
    prune,
    tile_ladder,
)
