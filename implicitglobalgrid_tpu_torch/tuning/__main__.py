"""The autotuner's operator CLI (the JAX package's ``scripts/igg_tune.py``).

Subcommands over the versioned winner table (`implicitglobalgrid_tpu_torch.
tuning`):

``sweep``
    Run one search at an explicit (model, size, dtype[, npt]) point on the
    grid's device (the card unless ``--device cpu``): enumerate the
    admissible config space, prune it with the static cost-model prior,
    measure the survivors, persist the winner.  ``--dry-run`` stops after
    pruning and prints the candidate table (modeled columns only — nothing
    is built or measured); without it the table carries the measured
    column too.

``show``
    List the cache entries across both layers (primary + the committed
    seed layer), with config, provenance and measured numbers.

``seed``
    Ingest the committed ``BENCH_H100_r<NN>.json`` records into seed
    entries (the hand-picked configs the bench measured on the card, with
    ``source: seed:bench_h100_rNN`` provenance) — written to the primary
    layer, or to ``--cache DIR`` (the committed seed layer is
    ``implicitglobalgrid_tpu_torch/tuning/entries``).

``clear``
    Delete the PRIMARY layer's entries (the committed seed layer is repo
    content and is never touched).

Examples::

    python -m implicitglobalgrid_tpu_torch.tuning sweep --model diffusion3d --n 256 --nsteps 16 --dry-run
    python -m implicitglobalgrid_tpu_torch.tuning sweep --model porous_convection3d --n 256 --npt 12 --nsteps 2
    python -m implicitglobalgrid_tpu_torch.tuning show --json
    python -m implicitglobalgrid_tpu_torch.tuning seed --dry-run
    python -m implicitglobalgrid_tpu_torch.tuning clear

Exit code: 0 = success, 1 = the requested point produced no admissible
candidate beyond the default, 2 = setup/environment failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cache(args):
    from . import TuneCache

    return TuneCache(primary=args.cache) if args.cache else TuneCache()


def cmd_sweep(args) -> int:
    from .. import finalize_global_grid, get_global_grid, grid_is_initialized
    from . import make_key
    from . import search as _search
    from . import space as _space

    if args.topk:
        os.environ["IGG_TUNE_TOPK"] = str(args.topk)
    n = args.n
    dtype = _space.torch_dtype(args.dtype)
    model = args.model
    module = _space.model_module(model)
    setup_kw = {"npt": args.npt} if model == "porous_convection3d" else {}
    grid_kw = {}
    if args.overlap:
        grid_kw.update(overlapx=args.overlap, overlapy=args.overlap,
                       overlapz=args.overlap)
    for ax in args.period or "":
        if ax not in "xyz":
            raise ValueError(
                f"--period axes must be from 'xyz', got {args.period!r}")
        grid_kw[f"period{ax}"] = 1
    if args.device:
        grid_kw["device"] = args.device
    if grid_is_initialized():
        finalize_global_grid()
    _state, params = module.setup(n, n, n, dtype=dtype, quiet=True,
                                  **setup_kw, **grid_kw)
    del _state
    try:
        gg = get_global_grid()
        extra = ({"npt": int(args.npt)}
                 if model == "porous_convection3d" else None)
        key = make_key(model, gg.nxyz, dtype, gg=gg, extra=extra,
                       nsteps=args.nsteps)
        # the table's rows come from the same pure functions the resolve
        # runs; the search itself (measure/decide/persist) goes THROUGH
        # `resolve_tuned_config`, so the CLI can never write an entry the
        # library path would shape differently
        candidates, rejected = _space.candidate_space(
            model, gg.nxyz, dtype, nsteps=args.nsteps, gg=gg,
            npt=(extra or {}).get("npt"),
        )
        survivors, cut = _space.prune(candidates, _search._topk())
        measured = {}
        winner = None
        path = None
        if not args.dry_run and len(survivors) > 1:
            cache = _cache(args)

            def measure(cfg):
                t = _search._measure_model(module, params, args.nsteps, 0,
                                           dict(cfg))
                measured[json.dumps(cfg, sort_keys=True)] = t
                return t

            winner = _search.resolve_tuned_config(
                model, gg.nxyz, dtype, nsteps=args.nsteps, gg=gg,
                extra=extra, cache=cache, measure=measure,
            )
            path = cache.path_for(key)
    finally:
        finalize_global_grid()

    rows = []
    for cand in survivors:
        ck = json.dumps(cand["config"], sort_keys=True)
        rows.append({**cand, "status": "measured" if measured else "survivor",
                     "t_chunk_s": measured.get(ck)})
    rows += [{**c, "status": "pruned"} for c in cut]
    rows += [{"config": c["config"], "modeled": None, "status": "rejected",
              "error": c["error"]} for c in rejected]
    doc = {"key": key, "dry_run": bool(args.dry_run), "winner": winner,
           "rows": rows}
    if path is not None:
        doc["cache_path"] = path
    if winner is not None and not measured:
        doc["note"] = ("cache hit: the stored winner was applied without "
                       "re-measuring — `clear` first to force a fresh search")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(f"tuning sweep: {model} {key['size']} {key['dtype']} on "
              f"{key['backend']} ({key['topology']})")
        print(f"{'config':48s} {'modeled GB/step':>15s} {'coll/step':>10s} "
              f"{'smem KiB':>9s} {'measured s':>11s}  status")
        for r in rows:
            m = r.get("modeled") or {}
            t = r.get("t_chunk_s")
            smem = m.get("smem_bytes", 0)
            print(f"{json.dumps(r['config']):48s} "
                  f"{(m.get('bytes_per_step', 0) / 1e9):15.3f} "
                  f"{m.get('collectives_per_step', 0):10.2f} "
                  f"{(f'{smem / 1024:.1f}' if smem else '-'):>9s} "
                  f"{('%.6f' % t) if t is not None else '-':>11s}  "
                  f"{r['status']}"
                  + (f" ({r['error']})" if r.get("error") else ""))
        if winner is not None:
            print(f"winner: {json.dumps(winner)} -> {doc['cache_path']}")
            if doc.get("note"):
                print(f"({doc['note']})")
        elif args.dry_run:
            print("(dry run: nothing measured, nothing persisted)")
        else:
            print("(degenerate point: nothing admissible beyond the "
                  "default — nothing measured, nothing persisted)")
    # exit 1 = a degenerate tuning point: nothing admissible beyond the
    # default survived the prior (dry or measured alike)
    return 0 if len(survivors) > 1 else 1


def cmd_show(args) -> int:
    from . import validate_entry

    entries = _cache(args).entries()
    if args.json:
        print(json.dumps(
            [{"path": p, "entry": doc} for p, doc in entries],
            indent=2, sort_keys=True,
        ))
        return 0
    if not entries:
        print("tuning: no cache entries (primary "
              f"{_cache(args).primary} and seed layer are empty)")
        return 0
    for path, doc in entries:
        if doc is None:
            print(f"{os.path.basename(path)}: UNPARSEABLE")
            continue
        try:
            key, config = validate_entry(doc)
        except ValueError as e:
            print(f"{os.path.basename(path)}: INVALID ({e})")
            continue
        meas = doc.get("measured") or {}
        t_step = meas.get("t_step_s")
        print(f"{key['model']:22s} {'x'.join(str(s) for s in key['size']):>13s} "
              f"{key['dtype']:8s} {key['backend']:5s} "
              f"{json.dumps(config):48s} {doc['source']:18s}"
              + (f" {t_step * 1e3:.4f} ms/step" if t_step else ""))
    return 0


def cmd_seed(args) -> int:
    from ..analysis.core import REPO_ROOT
    from . import seed_from_bench

    entries = seed_from_bench(REPO_ROOT, _cache(args), write=not args.dry_run)
    if args.json:
        print(json.dumps(entries, indent=2, sort_keys=True))
    else:
        for e in entries:
            print(f"seeded {e['key']['model']} {e['key']['size']} "
                  f"{json.dumps(e['config'])} from {e['source']}"
                  + (" (dry run)" if args.dry_run else ""))
        if not entries:
            print("tuning seed: no seedable extras in the committed "
                  "BENCH_H100 records")
    return 0


def cmd_clear(args) -> int:
    n = _cache(args).clear()
    print(f"tuning: removed {n} entr{'y' if n == 1 else 'ies'} from "
          f"{_cache(args).primary}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m implicitglobalgrid_tpu_torch.tuning",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sweep", help="search one tuning point")
    ps.add_argument("--model", required=True,
                    choices=["diffusion3d", "acoustic3d",
                             "porous_convection3d"])
    ps.add_argument("--n", type=int, required=True, help="local cube size")
    ps.add_argument("--nsteps", type=int, default=8,
                    help="steps per chunk the cadence is tuned for")
    ps.add_argument("--dtype", default="float32")
    ps.add_argument("--npt", type=int, default=12,
                    help="porous PT iterations (key component, not tuned)")
    ps.add_argument("--overlap", type=int, default=None)
    ps.add_argument("--period", default=None,
                    help="periodic dims, e.g. 'z' (one-card self-neighbour)")
    ps.add_argument("--device", default=None,
                    help="the grid's device (default: the CUDA card)")
    ps.add_argument("--topk", type=int, default=None,
                    help="override IGG_TUNE_TOPK for this sweep")
    ps.add_argument("--dry-run", action="store_true",
                    help="print the pruned candidate table, measure nothing")
    ps.add_argument("--json", action="store_true")
    ps.add_argument("--cache", default=None, help="primary cache dir")
    ps.set_defaults(fn=cmd_sweep)

    for name, fn, hlp in (("show", cmd_show, "list cache entries"),
                          ("clear", cmd_clear, "delete primary entries")):
        px = sub.add_parser(name, help=hlp)
        px.add_argument("--json", action="store_true")
        px.add_argument("--cache", default=None)
        px.set_defaults(fn=fn)

    pd = sub.add_parser("seed", help="ingest BENCH_H100_r*.json configs")
    pd.add_argument("--dry-run", action="store_true")
    pd.add_argument("--json", action="store_true")
    pd.add_argument("--cache", default=None)
    pd.set_defaults(fn=cmd_seed)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"tuning: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
