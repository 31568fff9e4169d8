"""The port's autotuner (`implicitglobalgrid_tpu_torch.tuning`) against the
JAX package's `tuning`.

Held against JAX on the same inputs: keys, digests, file names and
schedule classes; `validate_entry`'s verdicts and messages; entries written
by either package validate in the other; `project_config`, `control_plan`
and the tile-free part of `candidate_space` on the same grid geometry.
Port twins of the JAX suite (`tests/test_tuning.py`): the cache's round
trip, refusals and atomic publish; the shared-memory prune never reaches
measurement; the search is deterministic and the second call hits; a
degenerate point is never stored; an incompatible hit searches again
without overwriting; explicit kwargs and ``hide_comm`` skip the search; the
tuned config gives the default's result for the three models; the CLI.
One 2-rank gloo spawn (`_workers` task ``"tuning"``): rank 1 holds a
different local entry, both ranks apply rank 0's winner, only rank 0
writes.  Every cache lives under ``tmp_path`` (``IGG_TUNE_CACHE``).
"""

import json
import os

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu import tuning as jt
from implicitglobalgrid_tpu.tuning import search as jsearch
from implicitglobalgrid_tpu_torch import tuning as tt
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.tuning import search as tsearch
from implicitglobalgrid_tpu_torch.utils import telemetry as tele

F64 = torch.float64


@pytest.fixture(autouse=True)
def _fresh():
    tele.reset()
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    tele.reset()


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A fresh primary cache dir (env-wired) with NO seed fallback."""
    d = str(tmp_path / "tunecache")
    monkeypatch.setenv("IGG_TUNE_CACHE", d)
    return tt.TuneCache(primary=d, fallbacks=())


def _tune_counters():
    return {k: v for k, v in tele.snapshot()["counters"].items() if k.startswith("tune.")}


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


# -- keys, schema and plans against JAX ---------------------------------------

_KEYS = [
    ("diffusion3d", (256, 256, 256), "float32", 0, None, 24),
    ("diffusion3d", (256, 256, 256), "float64", 1, None, 16),
    ("diffusion3d", (128, 256, 64), "float32", 0, None, None),
    ("diffusion3d", (16, 16, 16), "float32", 0, None, 5),
    ("acoustic3d", (256, 256, 256), "float32", 0, None, 24),
    ("acoustic3d", (37, 45, 70), "float64", 4, None, 12),
    ("porous_convection3d", (256, 256, 256), "float32", 0, {"npt": 12}, 2),
    ("porous_convection3d", (256, 256, 256), "float32", 0, {"npt": 10}, 7),
]


@pytest.mark.parametrize("model,shape,dtype,batch,extra,nsteps", _KEYS)
@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_keys_digests_and_filenames_equal_jax(model, shape, dtype, batch, extra, nsteps,
                                              backend):
    kw = dict(batch=batch, backend=backend, topology="dims=1x1x1;periods=001;"
              "overlaps=12x12x12;nprocs=1", extra=extra, nsteps=nsteps)
    tk, jk = tt.make_key(model, shape, dtype, **kw), jt.make_key(model, shape, dtype, **kw)
    assert tk == jk
    assert tt.make_key(model, shape, getattr(torch, dtype), **kw) == jk  # a torch dtype
    assert tt.key_digest(tk) == jt.key_digest(jk)
    assert tt.entry_filename(tk) == jt.entry_filename(jk)
    assert tt.schedule_class(model, nsteps) == jt.schedule_class(model, nsteps)


def test_key_backend_and_topology_come_from_the_grid():
    tigg.init_global_grid(8, 8, 8, periodz=1, overlapx=4, overlapy=4, overlapz=4, quiet=True,
                          device="cpu")
    gg = tigg.get_global_grid()
    key = tt.make_key("diffusion3d", gg.nxyz, F64, nsteps=4)
    assert key["backend"] == "cpu"  # the grid device's type: a TPU entry never serves
    assert key["topology"] == "dims=1x1x1;periods=001;overlaps=4x4x4;nprocs=1"
    with pytest.raises(ValueError, match="unknown model") as e:
        tt.make_key("nope", (8, 8, 8), "float32", backend="cpu", topology="t")
    with pytest.raises(ValueError) as ej:
        jt.make_key("nope", (8, 8, 8), "float32", backend="cpu", topology="t")
    assert str(e.value) == str(ej.value)


def _good(pkg):
    key = pkg.make_key("diffusion3d", (16, 16, 16), "float32", backend="cpu", topology="t")
    return pkg.new_entry(key, {"fused_k": 4, "fused_tile": [32, 64]})


#: JAX `tests/test_tuning.py::test_validate_entry_contract`'s refusals, each
#: a case, plus the structural ones its schema spells out.
_REFUSALS = {
    "schema": lambda d: d.update(schema_version=99),
    "unknown-field": lambda d: d["config"].update(npt=12),
    "odd-k": lambda d: d["config"].update(fused_k=3),
    "tile-type": lambda d: d["config"].update(fused_tile="big"),
    "no-source": lambda d: d.update(source=""),
    "size": lambda d: d["key"].update(size=[0, 1, 2]),
    "tile-without-k": lambda d: d["config"].pop("fused_k"),
    "model": lambda d: d["key"].update(model="nope"),
    "backend-type": lambda d: d["key"].update(backend=3),
    "exchange-every": lambda d: d["config"].update(exchange_every=0),
    "flag-type": lambda d: d["config"].update(pipelined="yes"),
    "no-key": lambda d: d.pop("key"),
    "not-object": lambda d: d.clear(),
    None: lambda d: None,  # the good entry: accepted by both
}


@pytest.mark.parametrize("case", list(_REFUSALS), ids=lambda c: c or "accepted")
def test_validate_entry_verdicts_and_messages_equal_jax(case):
    doc = json.loads(json.dumps(_good(tt)))
    _REFUSALS[case](doc)
    if case == "not-object":
        doc = []
    verdicts = []
    for pkg in (tt, jt):
        try:
            verdicts.append(("ok", pkg.validate_entry(doc)))
        except ValueError as e:
            verdicts.append(("refused", str(e)))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0] == ("ok" if case is None else "refused")


def test_entries_written_by_either_package_validate_in_the_other(tmp_path):
    for writer, reader in ((tt, jt), (jt, tt)):
        d = str(tmp_path / writer.__name__)
        key = writer.make_key("acoustic3d", (256, 256, 256), "float32", backend="cuda",
                              topology="t", nsteps=24)
        entry = writer.new_entry(key, {"fused_k": 6, "fused_tile": [128, 16],
                                       "coalesce": False}, source="search",
                                 measured={"t_step_s": 2e-4, "teff_gbs": None, "steps": 24})
        path = writer.TuneCache(primary=d, fallbacks=()).store(key, entry)
        assert os.path.basename(path) == reader.entry_filename(key)
        got = reader.TuneCache(primary=d, fallbacks=()).lookup(key)
        assert got is not None and reader.validate_entry(got) == (key, entry["config"])


def test_project_config_and_control_plan_equal_jax():
    cfgs = [{"fused_k": 4, "fused_tile": [32, 64], "pipelined": True, "coalesce": False},
            {"exchange_every": 4}, {"fused_k": 6}, {}]
    for model in tt.MODELS:
        for cfg in cfgs:
            for nsteps in (4, 6, 7, 8, 24):
                assert tsearch.project_config(model, cfg, nsteps) == \
                    jsearch.project_config(model, cfg, nsteps)
    for is_root in (True, False):
        for hit in (True, False):
            for n in (0, 1, 3):
                assert tt.control_plan(is_root, hit, n) == jt.control_plan(is_root, hit, n)


#: Rejection reasons that are geometry rules both packages share (the
#: kernel envelopes differ: TPU VMEM and lane tiles against Hopper shared
#: memory and slots).
_RUNG_REASONS = ("no halo activity", "nsteps=", "deep-halo", "w=", "npt=")


def _tile_free(cands, rejected):
    cfgs = [c["config"] for c in cands if "fused_tile" not in c["config"]]
    rej = [r for r in rejected if r["error"].startswith(_RUNG_REASONS)]
    return cfgs, rej


@pytest.mark.parametrize("model,grid,nsteps,npt", [
    ("diffusion3d", dict(periodz=1, overlapx=4, overlapy=4, overlapz=4), 4, None),
    ("diffusion3d", dict(), 8, None),
    ("acoustic3d", dict(periodx=1, overlapx=6, overlapy=6, overlapz=6), 12, None),
    ("porous_convection3d", dict(periodz=1, overlapx=4, overlapy=4, overlapz=4), 2, 4),
])
def test_candidate_space_tile_free_part_equals_jax(model, grid, nsteps, npt):
    import jax

    shape = (16, 16, 128)
    jigg.init_global_grid(*shape, quiet=True, devices=jax.devices()[:1], **grid)
    try:
        jc, jr = jt.candidate_space(model, shape, 4, nsteps=nsteps,
                                    gg=jigg.get_global_grid(), npt=npt)
    finally:
        jigg.finalize_global_grid()
    tigg.init_global_grid(*shape, quiet=True, device="cpu", **grid)
    tc, tr = tt.candidate_space(model, shape, torch.float32, nsteps=nsteps,
                                gg=tigg.get_global_grid(), npt=npt)
    jcfg, jrej = _tile_free(jc, jr)
    tcfg, trej = _tile_free(tc, tr)
    assert trej == jrej and jrej
    # every config JAX admits the port admits, in JAX's order; the port's
    # kernels may take ks the TPU envelope refuses
    assert [c for c in tcfg if c in jcfg] == jcfg
    assert [c for c in tcfg if "fused_k" not in c] == [c for c in jcfg if "fused_k" not in c]
    assert tcfg[0] == {} and tc[0]["modeled"]["smem_bytes"] == 0


def test_tile_ladder_is_the_kernels_neighbourhood():
    # diffusion 256^3 on the CPU: the auto pick marches all of x
    auto, tiles = tt.tile_ladder("diffusion3d", (256, 256, 256), 4, torch.float32)
    assert auto == (256, 16) and tiles == [(128, 16), (256, 8)]
    # the staggered kernels: cutting x is the first rung
    auto, tiles = tt.tile_ladder("acoustic3d", (256, 256, 256), 6, torch.float32)
    assert auto == (256, 16) and tiles == [(128, 16), (256, 8)]
    from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl

    for bx, by in tiles:
        bz = fl.tile_for((256, 256, 256), 6, 4, by=by)[2]
        assert fl.tile_fits((256, 256, 256), 6, (bx, by, bz), 4)
    # f64 k=8 fits fewer rungs; every tile still passes the module's check
    auto, tiles = tt.tile_ladder("porous_convection3d", (64, 64, 64), 8, F64)
    assert len(tiles) <= tt.space.TILES_PER_K and auto not in tiles


# -- the prior ------------------------------------------------------------------


def test_smem_prune_never_measures(tune_cache):
    tigg.init_global_grid(16, 16, 16, periodx=1, periody=1, periodz=1, overlapx=4,
                          overlapy=4, overlapz=4, quiet=True, device="cpu")
    gg = tigg.get_global_grid()
    cands, rejected = tt.candidate_space("diffusion3d", gg.nxyz, F64, nsteps=4, gg=gg)
    assert cands[0]["config"] == {}
    big = [c for c in cands if c["modeled"]["smem_bytes"] > 1024]
    assert big, "expected kernel candidates with a modeled shared memory"
    fused = next(c for c in cands if c["config"].get("fused_k") == 2)
    assert fused["modeled"]["bytes_per_step"] < cands[0]["modeled"]["bytes_per_step"] * 2
    survivors, cut = tt.prune(cands, topk=99, smem_budget_bytes=1024)
    assert not [c for c in survivors if c["modeled"]["smem_bytes"] > 1024]
    assert all("shared memory" in c["error"] for c in cut if c["modeled"]["smem_bytes"] > 1024)
    # and through the resolve: an over-budget candidate never reaches measure
    measured = []
    orig = tt.space.prune
    try:
        tt.space.prune = lambda c, k: orig(c, k, smem_budget_bytes=1024)
        tt.resolve_tuned_config("diffusion3d", gg.nxyz, F64, nsteps=4, gg=gg,
                                cache=tune_cache,
                                measure=lambda cfg: measured.append(cfg) or 1.0)
    finally:
        tt.space.prune = orig
    assert measured and all(c not in measured for c in (b["config"] for b in big))
    # topk: the default always survives, the rest rank by the prior
    survivors, _ = tt.prune(cands, topk=3)
    assert len(survivors) == 3 and survivors[0]["config"] == {}
    ranked = [tt.modeled_seconds(c["modeled"]) for c in survivors[1:]]
    assert ranked == sorted(ranked)
    with pytest.raises(ValueError, match="topk"):
        tt.prune(cands, topk=0)


# -- the cache ------------------------------------------------------------------


def test_cache_roundtrip_refusals_and_atomicity(tune_cache):
    key = tt.make_key("diffusion3d", (16, 16, 16), "float32", backend="cpu", topology="t")
    entry = tt.new_entry(key, {"exchange_every": 2}, source="test")
    path = tune_cache.store(key, entry)
    assert not os.path.exists(path + ".tmp")  # atomic publish, no debris
    assert tune_cache.lookup(key)["config"] == {"exchange_every": 2}
    doc = json.load(open(path))
    doc["schema_version"] = tt.SCHEMA_VERSION + 1
    json.dump(doc, open(path, "w"))
    assert tune_cache.lookup(key) is None and "schema version" in tune_cache.last_refusal
    with open(path, "w") as f:
        f.write('{"schema_version": 1, "key": {tru')
    assert tune_cache.lookup(key) is None and "corrupt" in tune_cache.last_refusal
    other = tt.make_key("diffusion3d", (32, 32, 32), "float32", backend="cpu", topology="t")
    tune_cache.store(key, entry)
    os.replace(path, tune_cache.path_for(other))
    assert tune_cache.lookup(other) is None and "key drift" in tune_cache.last_refusal
    layered = tt.TuneCache(primary=tune_cache.primary + ".empty",
                           fallbacks=(tune_cache.primary,))
    tune_cache.store(key, entry)
    assert layered.lookup(key)["config"] == {"exchange_every": 2}
    assert tune_cache.clear() >= 1 and tune_cache.lookup(key) is None
    # a directory squatting on the name reads as a miss, and lists as None
    os.makedirs(tune_cache.path_for(key))
    assert tune_cache.lookup(key) is None and "unreadable" in tune_cache.last_refusal
    assert [doc for _p, doc in tune_cache.entries()] == [None]


def test_default_cache_dir_is_the_ports(monkeypatch):
    monkeypatch.delenv("IGG_TUNE_CACHE", raising=False)
    assert tt.default_cache_dir().endswith(
        os.path.join(".cache", "implicitglobalgrid_tpu_torch", "tune"))
    assert tt.SEED_DIR.endswith(os.path.join("implicitglobalgrid_tpu_torch", "tuning",
                                             "entries"))


# -- the resolve ------------------------------------------------------------------


def _grid16(**kw):
    tigg.init_global_grid(16, 16, 16, overlapx=4, overlapy=4, overlapz=4, quiet=True,
                          device="cpu", **kw)
    return tigg.get_global_grid()


def _stub(calls, fast=None):
    """A deterministic measure: ``fast`` (default: any ``exchange_every=2``
    config) takes 0.25 s, the rest 1 s."""
    def measure(cfg):
        calls.append(json.dumps(cfg, sort_keys=True))
        hit = cfg == fast if fast is not None else cfg.get("exchange_every") == 2
        return 0.25 if hit else 1.0

    return measure


def _last_survivor(gg, nsteps):
    cands, _ = tt.candidate_space("diffusion3d", gg.nxyz, "float32", nsteps=nsteps, gg=gg)
    return tt.prune(cands, tsearch._topk())[0][-1]["config"]


def test_search_deterministic_and_second_call_hits(tune_cache):
    from implicitglobalgrid_tpu_torch.utils.tracing import span_summary

    gg = _grid16(periodx=1, periody=1, periodz=1)
    fast = _last_survivor(gg, 4)
    calls = []
    before = _tune_counters()
    cfg1 = tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                   cache=tune_cache, measure=_stub(calls, fast))
    first = list(calls)
    assert cfg1 == fast and len(first) == 4  # IGG_TUNE_TOPK's default
    tune_cache.clear()
    calls.clear()
    assert tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                   cache=tune_cache, measure=_stub(calls, fast)) == cfg1
    assert calls == first  # same order
    calls.clear()
    assert tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                   cache=tune_cache, measure=_stub(calls, fast)) == cfg1
    after = _tune_counters()
    assert calls == []
    assert _delta(before, after, "tune.cache_hit") == 1
    assert _delta(before, after, "tune.candidates_measured") == 2 * len(first)
    assert _delta(before, after, "tune.cache_miss") == 2
    assert _delta(before, after, "tune.candidates_pruned") > 0
    entry = tune_cache.lookup(tt.make_key("diffusion3d", gg.nxyz, "float32", gg=gg, nsteps=4))
    assert entry["source"] == "search" and entry["tuner"]["measured"] == len(first)
    assert entry["key"]["backend"] == "cpu"
    assert "igg.tune" in span_summary()


def test_degenerate_point_is_never_persisted(tune_cache):
    gg = _grid16()  # no halo activity: nothing to amortize; nsteps=5 admits no k
    calls = []
    assert tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=5, gg=gg,
                                   cache=tune_cache, measure=_stub(calls)) == {}
    assert calls == []
    assert not os.path.isdir(tune_cache.primary) or os.listdir(tune_cache.primary) == []
    # a cadence-admissible nsteps (its own schedule class) still searches
    assert tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                   cache=tune_cache, measure=_stub(calls)) is not None
    assert calls


def test_incompatible_hit_researches_without_overwriting(tune_cache):
    gg = _grid16(periodx=1, periody=1, periodz=1)
    key = tt.make_key("diffusion3d", gg.nxyz, "float32", gg=gg, nsteps=4)
    tune_cache.store(key, tt.new_entry(key, {"fused_k": 6}, source="hand-seed"))
    fast = _last_survivor(gg, 4)
    calls = []
    cfg = tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                  cache=tune_cache, measure=_stub(calls, fast))
    assert cfg == fast and calls  # searched, not projected
    assert tune_cache.lookup(key)["config"] == {"fused_k": 6}  # no thrash
    assert tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                   cache=tune_cache, allow_search=False) == {}
    with pytest.raises(ValueError, match="no measure callable"):
        tune_cache.clear()
        tt.resolve_tuned_config("diffusion3d", gg.nxyz, "float32", nsteps=4, gg=gg,
                                cache=tune_cache)


def test_explicit_kwargs_and_hide_comm_skip_the_search(tune_cache):
    gg = _grid16(periodx=1, periody=1, periodz=1)
    key = tt.make_key("diffusion3d", gg.nxyz, F64, gg=gg, nsteps=4)
    tune_cache.store(key, tt.new_entry(key, {"exchange_every": 4}, source="test"))
    (T, Cp), params = td.setup(16, 16, 16, init_grid=False, dtype=F64)
    kwargs = dict(fused_k=None, fused_tile=None, exchange_every=2, pipelined=None,
                  coalesce=None)
    assert tsearch.apply_tuned_config("diffusion3d", td, params, 4, dict(kwargs)) == kwargs
    assert torch.equal(td.make_multi_step(params, 6, exchange_every=2, autotune=True)(T, Cp)[0],
                       td.make_multi_step(params, 6, exchange_every=2)(T, Cp)[0])
    tigg.finalize_global_grid()
    tune_cache.clear()
    (T, Cp), params = td.setup(16, 16, 16, hide_comm=True, overlapx=4, overlapy=4,
                               overlapz=4, dtype=F64, quiet=True, device="cpu")
    out, _ = td.make_multi_step(params, 4, autotune=True)(T, Cp)
    assert out.shape == T.shape
    assert not os.path.isdir(tune_cache.primary) or os.listdir(tune_cache.primary) == []


def test_autotune_env_knob(tune_cache, monkeypatch):
    assert tsearch.autotune_requested(None) is False
    monkeypatch.setenv("IGG_AUTOTUNE", "1")
    assert tsearch.autotune_requested(None) is True and not tsearch.autotune_requested(False)
    monkeypatch.setenv("IGG_TUNE_TOPK", "0")
    with pytest.raises(ValueError, match="IGG_TUNE_TOPK"):
        tsearch._topk()


# -- a tuned config changes the schedule, never the result -------------------------

#: JAX's `_ORACLE` at 16^3 (its decomposed 8-device grid is one periodic
#: block here, its whole overlap made consistent first: the initial
#: fields' periodic images differ by ULPs of their coordinates, and the two
#: cadences refresh different duplicated planes): the cached config is a
#: nontrivial schedule change (slab cadence; the acoustic row also flips
#: the coalesce lever).
_ORACLE = (
    (td, "diffusion3d", {}, {"exchange_every": 2}, 4),
    (ta, "acoustic3d", {}, {"exchange_every": 2, "coalesce": False}, 4),
    (tpc, "porous_convection3d", {"npt": 4}, {"exchange_every": 2}, 2),
)


@pytest.mark.parametrize("module,name,setup_kw,config,nsteps", _ORACLE,
                         ids=[r[1] for r in _ORACLE])
def test_tuned_config_bit_identical_to_default(module, name, setup_kw, config, nsteps,
                                               tune_cache):
    grid = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)

    def run(**mk):
        state, params = module.setup(16, 16, 16, dtype=F64, quiet=True, device="cpu",
                                     **setup_kw, **grid)
        tigg.update_halo(*state, width=2)
        out = module.make_multi_step(params, nsteps, **mk)(*state)
        key = tt.make_key(name, (16, 16, 16), F64, gg=tigg.get_global_grid(), nsteps=nsteps,
                          extra={"npt": setup_kw["npt"]} if "npt" in setup_kw else None)
        tigg.finalize_global_grid()
        return out, key

    ref, key = run()
    tune_cache.store(key, tt.new_entry(key, config, source="test"))
    tuned, _ = run(autotune=True)
    for a, b in zip(tuned, ref):
        assert torch.equal(a, b)
    assert tune_cache.lookup(key)["source"] == "test"  # served, not searched


# -- two ranks: rank 0 decides ------------------------------------------------------


def test_two_ranks_apply_rank0s_winner_which_only_rank0_writes(tmp_path):
    from implicitglobalgrid_tpu_torch._workers import spawn

    local = {"fused_k": 2, "fused_tile": [3, 3]}  # a config no search yields
    task = dict(kind="tuning", nxyz=[16, 16, 16], nsteps=4, local_rank=1, local_config=local,
                grid=dict(dimx=2, periodx=1, overlapx=4, overlapy=4, overlapz=4),
                env=dict(IGG_TUNE_TOPK="2", IGG_TUNE_STEPS="1"), inputs={})
    outs = spawn(task, 2, tmp_path, timeout=180)
    configs = [json.loads(o["config"].tobytes()) for o in outs]
    caches = [json.loads(o["cache"].tobytes()) for o in outs]
    assert configs[0] == configs[1]
    (entry,) = caches[0].values()  # rank 0 stored its winner ...
    applied = {k: v for k, v in configs[0].items() if v != tsearch._KWARG_DEFAULTS[k]}
    assert entry["source"] == "search" and entry["config"] == applied
    (own,) = caches[1].values()  # ... rank 1's own entry is untouched and unused
    assert own["source"] == "rank-local" and own["config"] == local != applied
    assert entry["key"] == own["key"]
    for o in outs:
        np.testing.assert_allclose(o["T"], o["T_default"], rtol=1e-12, atol=1e-12)


# -- the CLI ------------------------------------------------------------------------


def test_cli_sweep_show_clear(tmp_path, monkeypatch, capsys):
    from implicitglobalgrid_tpu_torch.tuning.__main__ import main

    monkeypatch.setenv("IGG_TUNE_CACHE", str(tmp_path / "unused"))
    monkeypatch.setenv("IGG_TUNE_STEPS", "1")
    base = ["sweep", "--model", "diffusion3d", "--n", "8", "--nsteps", "2", "--overlap", "4",
            "--period", "xyz", "--device", "cpu", "--json", "--cache", str(tmp_path)]
    assert main(base + ["--dry-run"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["dry_run"] is True and out["winner"] is None
    assert out["rows"][0]["config"] == {} and "survivor" in {r["status"] for r in out["rows"]}
    assert os.listdir(tmp_path) == [] and not tigg.grid_is_initialized()
    assert main(base + ["--topk", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["winner"] is not None
    assert any(r.get("t_chunk_s") for r in out["rows"] if r["status"] == "measured")
    (name,) = os.listdir(tmp_path)
    assert name.startswith("diffusion3d_8x8x8_float32")
    assert main(["show", "--cache", str(tmp_path)]) == 0
    assert "search" in capsys.readouterr().out
    assert main(["clear", "--cache", str(tmp_path)]) == 0
    assert os.listdir(tmp_path) == []
    # a degenerate point exits 1; a point with no card exits 2
    assert main(["sweep", "--model", "diffusion3d", "--n", "8", "--nsteps", "5",
                 "--device", "cpu", "--dry-run", "--cache", str(tmp_path)]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["sweep", "--model", "diffusion3d", "--n", "8", "--dry-run",
                 "--cache", str(tmp_path)]) == 2


# -- seeding from the committed H100 bench records ------------------------------------


def _bench_record(path, rng):
    """A bench record carrying every seedable extra, under the given kernel
    path (the port's ``cuda-fused``, JAX's ``pallas-fused``)."""
    u = lambda: round(float(rng.uniform(500, 2500)), 2)  # noqa: E731
    return {"metric": "diffusion3d_256_float32_teff", "value": u(), "extras": {
        "diffusion_pallas_fused4": {"teff": u(), "t_it_ms": 0.0566, "path": path},
        "diffusion_512_pallas_fused4": {"teff": u(), "t_it_ms": 0.42, "path": path},
        "acoustic_256_pallas_fused6": {"teff": u(), "t_it_ms": 0.2138, "path": path},
        "porous_256_pallas_fused": {"teff": u(), "t_it_ms": 6.23, "path": path,
                                    "npt12_w6": {"teff": u(), "t_pt_ms": 0.5},
                                    "npt10_w6_ragged": {"teff": u(), "t_pt_ms": 0.57}},
    }}


def test_seed_from_bench_gives_jax_s_entries(tmp_path):
    rng = np.random.default_rng(17)
    for round_n in (3, 4):
        rec = _bench_record("cuda-fused", rng)
        (tmp_path / f"BENCH_H100_r{round_n:02d}.json").write_text(json.dumps(rec))
        jrec = json.loads(json.dumps(rec).replace('"cuda-fused"', '"pallas-fused"'))
        (tmp_path / f"BENCH_r{round_n:02d}.json").write_text(json.dumps(jrec))
    ours = tt.seed_from_bench(str(tmp_path), tt.TuneCache(str(tmp_path / "t"), fallbacks=()))
    theirs = jt.seed_from_bench(str(tmp_path), jt.TuneCache(str(tmp_path / "j"), fallbacks=()),
                                write=False)
    assert len(ours) == len(theirs) == len(tt.SEEDABLE) == 5
    # the port's bench reaches every extra through the same path as JAX's
    assert [r["path"] for r in tt.SEEDABLE] == [r["path"] for r in jt.cache.SEEDABLE]
    # the one-card bench topology is JAX's string too (pinned below against
    # the grids the port's bench builds)
    assert tt.BENCH_TOPOLOGY == jt.cache.BENCH_TOPOLOGY
    for mine, jax_e, row in zip(ours, theirs, tt.SEEDABLE):
        assert mine["key"] == {**jax_e["key"], "backend": "cuda"} and jax_e["key"]["backend"] == "tpu"
        assert mine["measured"] == jax_e["measured"] and mine["modeled"] is None
        assert mine["source"] == "seed:bench_h100_r04" and jax_e["source"] == "seed:bench_r04"
        # JAX's 512^3 row runs its TPU tile; the port's bench runs the kernel's own pick
        want = {k: v for k, v in jax_e["config"].items() if k != "fused_tile"}
        assert mine["config"] == want == row["config"]
        assert tt.admissibility_error(mine["key"], mine["config"]) is None
    assert sorted(os.listdir(tmp_path / "t")) == sorted(tt.entry_filename(e["key"]) for e in ours)
    # the porous rows read the t_it_ms of their own node: none (JAX's too)
    assert [e["measured"]["t_step_s"] is None for e in ours] == [False, False, False, True, True]


def test_cpu_records_seed_nothing(tmp_path):
    rng = np.random.default_rng(3)
    for n, path in ((1, "cuda-fused"), (2, "cpu-fused-plain")):
        (tmp_path / f"BENCH_H100_r{n:02d}.json").write_text(
            json.dumps(_bench_record(path, rng)))
    cache = tt.TuneCache(str(tmp_path / "t"), fallbacks=())
    # the newest round carrying an extra wins only where it ran the kernel
    assert {e["source"] for e in tt.seed_from_bench(str(tmp_path), cache)} == {
        "seed:bench_h100_r01"}
    os.remove(tmp_path / "BENCH_H100_r01.json")
    assert tt.seed_from_bench(str(tmp_path), cache, write=False) == []
    # the TPU rounds are never read
    (tmp_path / "BENCH_r05.json").write_text(json.dumps(_bench_record("cuda-fused", rng)))
    assert tt.seed_from_bench(str(tmp_path), cache, write=False) == []


def test_records_of_another_size_or_card_seed_nothing(tmp_path):
    rng = np.random.default_rng(5)
    h100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
    for n, metric, device in ((1, tt.BENCH_METRIC, h100),
                              (2, tt.BENCH_METRIC, {**h100, "power_limit_w": 500.0}),
                              (3, "diffusion3d_64_float32_teff", h100)):
        rec = {**_bench_record("cuda-fused", rng), "metric": metric, "device": device}
        (tmp_path / f"BENCH_H100_r{n:02d}.json").write_text(json.dumps(rec))
    cache = tt.TuneCache(str(tmp_path / "t"), fallbacks=())
    # r03 (another --n) is not read; r01 is another power limit than r02, the newest
    assert {e["source"] for e in tt.seed_from_bench(str(tmp_path), cache, write=False)} == {
        "seed:bench_h100_r02"}
    os.remove(tmp_path / "BENCH_H100_r02.json")
    assert {e["source"] for e in tt.seed_from_bench(str(tmp_path), cache, write=False)} == {
        "seed:bench_h100_r01"}
    os.remove(tmp_path / "BENCH_H100_r01.json")
    assert tt.seed_from_bench(str(tmp_path), cache, write=False) == []


def test_bench_topology_is_the_grid_the_bench_builds(monkeypatch):
    from implicitglobalgrid_tpu_torch.benchmarks import bench as tbench
    from implicitglobalgrid_tpu_torch.benchmarks import run as trun
    from implicitglobalgrid_tpu_torch.parallel.grid import global_grid

    seen = []

    def timed(step, state, chunk, reps, warmup=2):
        seen.append((global_grid().nxyz, tt.topology_string(global_grid())))
        return 1e-3, state, {}

    monkeypatch.setattr(trun, "_time_steps", timed)
    configs = tbench._configs(8, "cpu")
    for name in dict.fromkeys(row["path"].split(".")[0] for row in tt.SEEDABLE):
        configs[name]()
    assert len(seen) == 5  # the two porous rows' configs run in one extra
    assert {topo for _, topo in seen} == {tt.BENCH_TOPOLOGY}
    assert [nxyz for nxyz, _ in seen] == [(8, 8, 8), (16, 16, 16), (8, 8, 8), (8, 8, 8),
                                          (8, 8, 8)]


def test_cli_seed_dry_run_matches_committed(tmp_path, capsys):
    from implicitglobalgrid_tpu_torch.tuning.__main__ import main

    assert main(["seed", "--dry-run", "--json", "--cache", str(tmp_path)]) == 0
    entries = json.loads(capsys.readouterr().out)
    assert os.listdir(tmp_path) == []  # a dry run writes nothing
    assert len(entries) == len(tt.SEEDABLE)
    assert all(e["source"].startswith("seed:bench_h100_r") for e in entries)
    committed = {tt.entry_filename(doc["key"]): doc
                 for _, doc in tt.TuneCache(tt.SEED_DIR, fallbacks=()).entries()
                 if doc["source"].startswith("seed:bench_h100_")}
    assert sorted(committed) == sorted(tt.entry_filename(e["key"]) for e in entries)
    for e in entries:
        doc = committed[tt.entry_filename(e["key"])]
        assert {k: v for k, v in doc.items() if k != "created_unix"} == \
            {k: v for k, v in e.items() if k != "created_unix"}
        assert tt.admissibility_error(e["key"], e["config"]) is None
    assert main(["seed", "--cache", str(tmp_path)]) == 0
    assert "seeded diffusion3d [512, 512, 512]" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == sorted(committed)
