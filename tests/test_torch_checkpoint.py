"""The port's checkpoints against the JAX package's, and elastic restore.

Checkpoints are byte copies, so every comparison here is bit-exact
(``tobytes`` or ``torch.equal`` on the word view), with no tolerance:

* the on-disk format is shared: a checkpoint that JAX writes on two devices
  restores in the port on two gloo ranks, one the port writes on two ranks
  restores in JAX, and both at one block in one process (the same-topology
  path); the manifests' lineage digests agree;
* elastic restore in the port: saved on ``dims=(2,1,1)``, restored on one
  rank and on ``dims=(1,2,1)``, a periodic dimension and a batched field
  included, compared in de-duplicated space (`gather(dedup=True)`, itself
  held against JAX's);
* the JAX package's ``tests/test_resilience.py`` and
  ``tests/test_checkpoint_elastic.py`` checkpoint cases that have a
  meaning in the port (CRC manifest, fallback, prune, legacy format 1,
  fault-injected damage);
* a two-rank ``worker_crash`` drill: rank 1 exits after the step-4
  checkpoint, and the relaunch resumes and ends equal to an uninterrupted
  run.

The two-rank legs share three gloo spawns (one module fixture).  Every test
pins its dtypes and finalizes both grids.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.utils import checkpoint as jck
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.ops import gather as tgather
from implicitglobalgrid_tpu_torch.parallel import grid as tgrid
from implicitglobalgrid_tpu_torch.utils import checkpoint as tck
from implicitglobalgrid_tpu_torch.utils import resilience as tres

NX = 8
NLOC = (8, 6, 5)  # local block; two ranks split in x, y periodic
GRID = dict(dimx=2, periody=1)
PERIODS = (0, 1, 0)


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    tres.reset_fault_injector()
    yield
    tres.reset_fault_injector()


@pytest.fixture
def fault_injection(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("IGG_FAULT_INJECT", spec)
        tres.reset_fault_injector()
        return tres.get_fault_injector()

    yield arm
    tres.reset_fault_injector()


def _words(A):
    A = A.contiguous()
    return A.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        A.element_size()])


def _layout(G, dims, nloc, ols, periods):
    """The global-block layout (``dims * nloc``) of the de-duplicated array
    ``G``: block ``c``'s local cell ``j`` is ``G[(c*(n-ol) + j) % len]``, so
    overlapping cells agree (a halo-consistent state)."""
    out = np.empty(tuple(d * n for d, n in zip(dims, nloc)), G.dtype)
    for c in np.ndindex(*dims):
        idx = [(c[d] * (nloc[d] - ols[d]) + np.arange(nloc[d])) % G.shape[d] for d in range(3)]
        out[tuple(slice(c[d] * nloc[d], (c[d] + 1) * nloc[d]) for d in range(3))] = \
            G[np.ix_(*idx)]
    return out


def _data():
    """De-duplicated fields of the (2,1,1) grid: T (14,4,5) f64, the
    x-staggered Vx (15,4,5) f32 and two members of a batched field."""
    rng = np.random.default_rng(12)
    G = {"T": rng.standard_normal((14, 4, 5)),
         "Vx": rng.standard_normal((15, 4, 5)).astype(np.float32),
         "B@0": rng.standard_normal((14, 4, 5)), "B@1": rng.standard_normal((14, 4, 5))}
    ols = {"T": (2, 2, 2), "Vx": (3, 2, 2), "B@0": (2, 2, 2), "B@1": (2, 2, 2)}
    shapes = {"T": NLOC, "Vx": (9, 6, 5), "B@0": NLOC, "B@1": NLOC}
    lay = {k: _layout(G[k], (2, 1, 1), shapes[k], ols[k], PERIODS) for k in G}
    return G, lay


def _jax_field(arr):
    gg = jigg.get_global_grid()
    return jax.device_put(arr, NamedSharding(gg.mesh, P(*jigg.AXIS_NAMES[: arr.ndim])))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX saves on two devices; then three two-rank spawns: S1 restores it,
    saves for JAX and for the elastic legs, gathers, probes and runs the
    uninterrupted reference; S2 crashes rank 1 after the step-4 checkpoint;
    S3 resumes that run and restores the elastic save on dims (1,2,1)."""
    base = tmp_path_factory.mktemp("two_ranks")
    G, lay = _data()
    jigg.init_global_grid(*NLOC, quiet=True, devices=jax.devices()[:2], **GRID)
    jdir = str(base / "jax")
    jck.save_checkpoint(jdir, (_jax_field(lay["T"]), _jax_field(lay["Vx"])), 3)
    jigg.finalize_global_grid()
    fields = dict(fields=["T", "Vx"], shapes=[list(NLOC), [9, 6, 5]])
    batched = dict(fields=["T", "Vx", "B"], shapes=[list(NLOC), [9, 6, 5], list(NLOC)],
                   batched={"B": 2})
    run_kw = dict(args=[6, *NLOC], kw=dict(GRID))
    crash_dir = str(base / "crash")
    s1 = spawn(dict(kind="resilience", inputs=lay, actions=[
        dict(do="grid", nxyz=list(NLOC), grid=GRID),
        dict(do="restore", path=jdir + "/step_00000003", prefix="j"),
        dict(do="save", path=str(base / "port"), step=5, **fields),
        dict(do="save", path=str(base / "elastic"), step=7, **batched),
        dict(do="gather", prefix="g", **batched),
        dict(do="check", rank=1, prefix="c", fields=["T"], shapes=[list(NLOC)]),
        dict(do="audit", rank=1, prefix="a", fields=["T"], shapes=[list(NLOC)]),
        dict(do="transport", rank=1, prefix="x", **fields),
        dict(do="run", prefix="ref", **run_kw),
    ]), 2, base / "s1", timeout=240)
    crash_kw = dict(GRID, checkpoint_every=2, checkpoint_dir=crash_dir)
    with pytest.raises(RuntimeError) as crash:
        spawn(dict(kind="resilience", inputs=lay, actions=[
            dict(do="run", args=[6, *NLOC], kw=crash_kw,
                 env={"IGG_FAULT_INJECT": "worker_crash:step4:proc1"}),
        ]), 2, base / "s2", timeout=240)
    latest_after_crash = tck.latest_checkpoint(crash_dir)
    s3 = spawn(dict(kind="resilience", inputs=lay, actions=[
        dict(do="run", prefix="res", args=[6, *NLOC], kw=crash_kw),
        dict(do="grid", nxyz=[14, 4, 5], grid=dict(dimy=2, periody=1)),
        dict(do="restore", path=str(base / "elastic" / "step_00000007"), prefix="e",
             gather=True),
    ]), 2, base / "s3", timeout=240)
    return dict(base=base, G=G, lay=lay, jdir=jdir, s1=s1, s3=s3, crash=str(crash.value),
                latest_after_crash=latest_after_crash,
                s3_log=(base / "s3" / "rank1.log").read_text())


# -- cross-package: the shared on-disk format ----------------------------------


def test_jax_checkpoint_restores_in_port_on_two_ranks(two_ranks):
    lay = two_ranks["lay"]
    for r, out in enumerate(two_ranks["s1"]):
        assert out["j0"].tobytes() == lay["T"][r * 8:(r + 1) * 8].tobytes()
        assert out["j1"].tobytes() == lay["Vx"][r * 9:(r + 1) * 9].tobytes()
        assert out["j1"].dtype == np.float32


def test_port_checkpoint_restores_in_jax_on_two_devices(two_ranks):
    lay = two_ranks["lay"]
    jigg.init_global_grid(*NLOC, quiet=True, devices=jax.devices()[:2], **GRID)
    (T, Vx), step, _ = jck.restore_checkpoint(str(two_ranks["base"] / "port" / "step_00000005"))
    assert step == 5
    assert np.asarray(T).tobytes() == lay["T"].tobytes()
    assert np.asarray(Vx).tobytes() == lay["Vx"].tobytes()
    assert np.asarray(Vx).dtype == np.float32


def test_lineage_digests_agree_between_packages(two_ranks):
    """Same bytes, same keys: the two-device JAX save (one shard file) and
    the two-rank port save (two shard files) record the same per-block and
    per-field digests; each package verifies the other's manifest."""
    jmeta = jck.checkpoint_meta(two_ranks["jdir"] + "/step_00000003")
    pdir = str(two_ranks["base"] / "port" / "step_00000005")
    tmeta = tck.checkpoint_meta(pdir)
    assert jmeta["lineage"]["blocks"] == tmeta["lineage"]["blocks"]
    assert jmeta["lineage"]["fields"] == tmeta["lineage"]["fields"]
    assert set(tmeta["shards"]) == {"shards_p0.npz", "shards_p1.npz"}
    assert set(jmeta["shards"]) == {"shards_p0.npz"}
    assert tmeta["grid"] == {**jmeta["grid"], "device_type": "cpu"}
    assert tmeta["fields"] == jmeta["fields"]
    assert (jmeta["process_count"], tmeta["process_count"]) == (1, 2)
    assert jck.verify_checkpoint(pdir) is None
    assert tck.verify_checkpoint(two_ranks["jdir"] + "/step_00000003") is None


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_one_block_cross_package_round_trip(tmp_path, dtype):
    """One block, one process: the same-topology path both ways, on data
    that is NOT halo-consistent (the fast path copies blocks verbatim)."""
    import ml_dtypes

    npdt = np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.dtype(dtype)
    tdt = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(3)
    A = rng.standard_normal((NX, NX, NX)).astype(npdt)
    V = rng.standard_normal((NX + 1, NX, NX)).astype(npdt)
    jigg.init_global_grid(NX, NX, NX, quiet=True, devices=jax.devices()[:1])
    jpath = jck.save_checkpoint(tmp_path / "j", (jnp.asarray(A), jnp.asarray(V)), 2)
    jigg.finalize_global_grid()
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    like = (torch.zeros(A.shape, dtype=tdt), torch.zeros(V.shape, dtype=tdt))
    got, step, _ = tigg.restore_checkpoint(jpath, like=like)
    assert step == 2 and got[0] is like[0] and got[1] is like[1]
    for g, w in zip(got, (A, V)):
        assert _words(g).numpy().tobytes() == w.tobytes()
    tpath = tigg.save_checkpoint(tmp_path / "t", got, 4)
    tigg.finalize_global_grid()
    jigg.init_global_grid(NX, NX, NX, quiet=True, devices=jax.devices()[:1])
    (a, v), step, _ = jck.restore_checkpoint(tpath)
    assert step == 4 and np.asarray(a).dtype == npdt
    assert np.asarray(a).tobytes() == A.tobytes() and np.asarray(v).tobytes() == V.tobytes()
    jl, tl = jck.checkpoint_meta(jpath)["lineage"], tck.checkpoint_meta(tpath)["lineage"]
    assert jl["blocks"] == tl["blocks"] and jl["fields"] == tl["fields"]


def test_gather_dedup_matches_jax(two_ranks):
    """`gather(dedup=True)` on one rank and on two equals JAX's on the same
    blocks (and the de-duplicated array the blocks were cut from)."""
    G, lay = two_ranks["G"], two_ranks["lay"]
    root = two_ranks["s1"][0]
    assert "gT" not in two_ranks["s1"][1]  # only the root returns the array
    jigg.init_global_grid(*NLOC, quiet=True, devices=jax.devices()[:2], **GRID)
    for name in ("T", "Vx"):
        want = jigg.gather(_jax_field(lay[name]), dedup=True)
        assert root["g" + name].tobytes() == want.tobytes() == G[name].tobytes()
    for m in (0, 1):
        assert root[f"gB@{m}"].tobytes() == G[f"B@{m}"].tobytes()
    jigg.finalize_global_grid()
    rng = np.random.default_rng(5)
    A = rng.standard_normal((NX, NX - 1, NX))
    jigg.init_global_grid(NX, NX - 1, NX, periodz=1, quiet=True, devices=jax.devices()[:1])
    tigg.init_global_grid(NX, NX - 1, NX, periodz=1, quiet=True, device="cpu")
    want = jigg.gather(jnp.asarray(A), dedup=True)
    got = tigg.gather(torch.from_numpy(A), dedup=True)
    assert got.shape == want.shape == (NX, NX - 1, NX - 2) == tgather.dedup_shape(A)
    assert got.tobytes() == want.tobytes()
    buf = np.zeros_like(got)
    assert tigg.gather(torch.from_numpy(A), buf, dedup=True) is None
    assert buf.tobytes() == got.tobytes()


# -- elastic restore in the port ------------------------------------------------


def test_elastic_restore_on_dims_121(two_ranks):
    """Saved on dims (2,1,1), restored on (1,2,1): the periodic y splits in
    two blocks of 4; T, the staggered Vx and both members of the batched
    field come back bit-exact in de-duplicated space."""
    G = two_ranks["G"]
    root = two_ranks["s3"][0]
    assert root["e0"].shape == (14, 4, 5) and root["e1"].shape == (15, 4, 5)
    assert root["e2"].shape == (2, 14, 4, 5)
    assert root["eg0"].tobytes() == G["T"].tobytes()
    assert root["eg1"].tobytes() == G["Vx"].tobytes()
    for m in (0, 1):
        assert root[f"eg2@{m}"].tobytes() == G[f"B@{m}"].tobytes()


def test_elastic_restore_on_one_rank(two_ranks):
    G = two_ranks["G"]
    tigg.init_global_grid(14, 6, 5, periody=1, quiet=True, device="cpu")
    path = str(two_ranks["base"] / "elastic" / "step_00000007")
    (T, Vx, B), step, _ = tigg.restore_checkpoint(path)
    assert step == 7 and T.shape == (14, 6, 5) and B.shape == (2, 14, 6, 5)
    assert tigg.gather(T, dedup=True).tobytes() == G["T"].tobytes()
    assert tigg.gather(Vx, dedup=True).tobytes() == G["Vx"].tobytes()
    for m in (0, 1):
        assert tigg.gather(B, dedup=True, member=m).tobytes() == G[f"B@{m}"].tobytes()
    # the restored halos are consistent: an exchange is a bitwise no-op
    assert torch.equal(tigg.update_halo(T.clone()), T)
    with pytest.raises(ValueError, match="different grid topology"):
        tigg.restore_checkpoint(path, strict=True)


def test_elastic_restore_rejects_another_global_grid(two_ranks):
    path = str(two_ranks["base"] / "elastic" / "step_00000007")
    tigg.init_global_grid(12, 6, 5, periody=1, quiet=True, device="cpu")
    with pytest.raises(ValueError, match="cannot be elastically restored"):
        tigg.restore_checkpoint(path)
    tigg.finalize_global_grid()
    tigg.init_global_grid(14, 6, 5, quiet=True, device="cpu")  # y not periodic
    with pytest.raises(ValueError, match="periods"):
        tigg.restore_checkpoint(path)


def test_elastic_topology_error_matches_jax():
    from implicitglobalgrid_tpu.parallel import grid as jgrid

    saved = dict(nxyz=[8, 8, 8], dims=[2, 2, 2], overlaps=[2, 2, 2],
                 periods=[0, 0, 0], nxyz_g=[14, 14, 14])
    ok = dict(nxyz=[5, 14, 8], dims=[4, 1, 2], overlaps=[2, 2, 2], periods=[0, 0, 0])
    assert tgrid.elastic_topology_error(saved, ok) is None
    for bad in (dict(ok, nxyz=[6, 14, 8]), dict(ok, periods=[1, 0, 0])):
        err = tgrid.elastic_topology_error(saved, bad)
        assert err is not None and err == jgrid.elastic_topology_error(saved, bad)


def test_checkpoint_meta_keys_match_jax():
    jigg.init_global_grid(NX, NX, NX, quiet=True, devices=jax.devices()[:1])
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    jm, tm = jigg.get_global_grid().checkpoint_meta(), tigg.get_global_grid().checkpoint_meta()
    assert tm == {**jm, "device_type": "cpu"}


# -- the two-rank grid checks that ride the first spawn --------------------------


def test_check_fields_and_audit_report_rank_1s_block(two_ranks):
    for out in two_ranks["s1"]:
        assert out["cbad"].tolist() == [[1, 0, 0]]  # every rank reads the same report
        assert out["aranks"].tolist() == [1]


def test_transport_checksum_implicates_the_sender_across_ranks(two_ranks):
    """Rank 1 flips its send buffers: rank 0 (its receiver) raises naming
    rank 1; rank 1 received clean words from rank 0."""
    r0, r1 = two_ranks["s1"]
    assert bool(r0["xsame"]) and bool(r1["xsame"])
    assert r0["xflip"].tolist() == [1, 1]
    assert r1["xflip"].tolist() == [0, -2]


# -- the two-rank worker_crash drill ---------------------------------------------


def test_worker_crash_then_resume_equals_uninterrupted(two_ranks):
    assert "17" in two_ranks["crash"] and "worker_crash" in two_ranks["crash"]
    assert two_ranks["latest_after_crash"].endswith("step_00000004")
    assert "resumed from checkpoint" in two_ranks["s3_log"]
    for ref, res in zip(two_ranks["s1"], two_ranks["s3"]):
        assert res["resT"].tobytes() == ref["refT"].tobytes()


# -- single-process cases of the JAX package's checkpoint tests ------------------


def _coord_state(dtype=torch.float64):
    T = tigg.zeros((NX, NX, NX), dtype=dtype)
    X, Y, Z = tigg.coord_fields(T, (0.37, 0.11, 0.53))
    return (X * 1.3 + Y * 0.7 + Z * 0.11).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_checkpoint_roundtrip_bit_exact(tmp_path, dtype):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state(dtype)
    V = torch.full((NX + 1, NX, NX), -0.0, dtype=dtype)
    path = tigg.save_checkpoint(tmp_path, (T, V), 12, extra={"model": "t"})
    got, step, extra = tigg.restore_checkpoint(path)
    assert step == 12 and extra == {"model": "t"}
    for a, b in zip(got, (T, V)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert torch.equal(_words(a), _words(b))  # -0.0 included


def test_restore_like_checks_shape_and_dtype(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state()
    path = tigg.save_checkpoint(tmp_path, (T,), 1)
    with pytest.raises(ValueError, match="local shape"):
        tigg.restore_checkpoint(path, like=(torch.zeros(NX, NX, NX + 1, dtype=T.dtype),))
    with pytest.raises(ValueError, match="dtype"):
        tigg.restore_checkpoint(path, like=(torch.zeros(NX, NX, NX),))
    with pytest.raises(ValueError, match="holds 1 field"):
        tigg.restore_checkpoint(path, like=(T, T))


def test_latest_checkpoint_ignores_incomplete(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = tigg.ones((NX, NX, NX))
    p2 = tigg.save_checkpoint(tmp_path, (T,), 2)
    p5 = tigg.save_checkpoint(tmp_path, (T,), 5)
    assert tigg.latest_checkpoint(tmp_path) == p5
    os.remove(os.path.join(p5, "meta.json"))
    assert tigg.latest_checkpoint(tmp_path) == p2
    assert tigg.latest_checkpoint(tmp_path / "nowhere") is None


def test_checkpoint_prune_keeps_newest(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = tigg.ones((NX, NX, NX))
    for s in (1, 2, 3):
        tigg.save_checkpoint(tmp_path, (T,), s)
    removed = tigg.prune_checkpoints(tmp_path, keep=2)
    assert [os.path.basename(r) for r in removed] == ["step_00000001"]
    assert tigg.latest_checkpoint(tmp_path).endswith("step_00000003")
    with pytest.raises(ValueError, match="keep"):
        tigg.prune_checkpoints(tmp_path, keep=0)


def test_restore_rejects_wrong_overlap(tmp_path):
    # Periodic x: one block implies nxyz_g = nx - overlap, so the overlap
    # changes the global grid (non-periodic, one block is any overlap's).
    tigg.init_global_grid(NX, NX, NX, periodx=1, quiet=True, device="cpu")
    path = tigg.save_checkpoint(tmp_path, (tigg.ones((NX, NX, NX)),), 3)
    tigg.finalize_global_grid()
    tigg.init_global_grid(NX, NX, NX, periodx=1, overlapx=4, overlapy=4, overlapz=4,
                          quiet=True, device="cpu")
    with pytest.raises(ValueError, match="overlaps"):
        tigg.restore_checkpoint(path)


def test_manifest_records_every_shard_crc(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    path = tigg.save_checkpoint(tmp_path, (_coord_state(),), 3)
    meta = tck.checkpoint_meta(path)
    assert meta["format"] == tck.FORMAT_VERSION == jck.FORMAT_VERSION
    assert tck.READABLE_FORMATS == jck.READABLE_FORMATS
    assert set(meta["shards"]) == {"shards_p0.npz"}
    rec = meta["shards"]["shards_p0.npz"]
    shard = os.path.join(path, "shards_p0.npz")
    assert rec["bytes"] == os.path.getsize(shard)
    assert rec["crc32"] == tck._crc32_file(shard) == jck._crc32_file(shard)
    assert tigg.verify_checkpoint(path) is None
    assert [n for n in os.listdir(os.path.dirname(path)) if n.startswith(".")] == []
    assert not [n for n in os.listdir(path) if n.endswith(".crc.json")]
    assert sorted(np.load(shard).files) == ["f0_o0_0_0", "f0_o0_0_0_shape"]


def test_verify_detects_corruption_and_truncation(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    path = tigg.save_checkpoint(tmp_path, (_coord_state(),), 3)
    shard = os.path.join(path, "shards_p0.npz")
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    assert "corrupt" in tigg.verify_checkpoint(path)
    with pytest.raises(ValueError, match="integrity"):
        tigg.restore_checkpoint(path)
    os.truncate(shard, size // 2)
    assert "truncated" in tigg.verify_checkpoint(path)
    os.remove(shard)
    assert "missing" in tigg.verify_checkpoint(path)


def test_latest_checkpoint_falls_back_to_newest_valid(tmp_path, capfd):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state()
    p2, p4 = (tigg.save_checkpoint(tmp_path, (T,), s) for s in (2, 4))
    shard = os.path.join(p4, "shards_p0.npz")
    os.truncate(shard, os.path.getsize(shard) // 2)
    assert tigg.latest_checkpoint(tmp_path) == p2
    assert "skipping invalid checkpoint" in capfd.readouterr().err
    assert tigg.latest_checkpoint(tmp_path, verify=False) == p4
    shard2 = os.path.join(p2, "shards_p0.npz")
    os.truncate(shard2, os.path.getsize(shard2) // 2)
    assert tigg.latest_checkpoint(tmp_path) is None


def test_legacy_format1_checkpoint_still_restores(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state()
    path = tigg.save_checkpoint(tmp_path, (T,), 3)
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["format"] = 1
    del meta["shards"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert tigg.verify_checkpoint(path) is None
    (got,), step, _ = tigg.restore_checkpoint(path)
    assert step == 3 and torch.equal(got, T)
    meta["format"] = 3
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert "unknown checkpoint format" in tigg.verify_checkpoint(path)


def test_prune_refuses_to_delete_only_valid_generation(tmp_path):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state()
    p2, p4 = (tigg.save_checkpoint(tmp_path, (T,), s) for s in (2, 4))
    shard = os.path.join(p4, "shards_p0.npz")
    os.truncate(shard, os.path.getsize(shard) // 2)
    assert tigg.prune_checkpoints(tmp_path, keep=1) == []
    assert tigg.latest_checkpoint(tmp_path) == p2
    assert tigg.prune_checkpoints(tmp_path, keep=1, protect_valid=False) == [p2]
    assert tigg.latest_checkpoint(tmp_path) is None


def test_fault_injected_ckpt_corrupt_proves_fallback(tmp_path, clean_env, fault_injection):
    """``ckpt_corrupt`` damages the step-4 generation right after it
    publishes; a resumed run falls back to step 2 and still ends
    bit-identical to the fault-free run."""
    kw = dict(quiet=True, device="cpu", dtype=torch.float64)
    fault_injection("ckpt_corrupt:step4")
    td.run(4, NX, NX, NX, checkpoint_every=2, checkpoint_dir=tmp_path, **kw)
    assert "corrupt" in tigg.verify_checkpoint(os.path.join(str(tmp_path), "step_00000004"))
    assert tigg.latest_checkpoint(tmp_path).endswith("step_00000002")
    tres.reset_fault_injector()
    os.environ.pop("IGG_FAULT_INJECT", None)
    T_res = td.run(6, NX, NX, NX, checkpoint_every=2, checkpoint_dir=tmp_path, **kw)
    T_full = td.run(6, NX, NX, NX, **kw)
    assert torch.equal(T_res, T_full)


def test_fault_injected_ckpt_truncate(tmp_path, clean_env, fault_injection):
    fault_injection("ckpt_truncate:step2")
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state()
    p2 = tigg.save_checkpoint(tmp_path, (T,), 2)
    assert "truncated" in tigg.verify_checkpoint(p2)
    p4 = tigg.save_checkpoint(tmp_path, (T,), 4)  # fires once
    assert tigg.verify_checkpoint(p4) is None
    assert tigg.latest_checkpoint(tmp_path) == p4


def test_model_checkpoint_resume_bit_identical(tmp_path, clean_env):
    kw = dict(quiet=True, device="cpu", dtype=torch.float64)
    T_full = td.run(6, NX, NX, NX, **kw)
    td.run(4, NX, NX, NX, checkpoint_every=2, checkpoint_dir=tmp_path, **kw)
    assert tigg.latest_checkpoint(tmp_path).endswith("step_00000004")
    T_res = td.run(6, NX, NX, NX, checkpoint_every=2, checkpoint_dir=tmp_path, **kw)
    assert torch.equal(T_res, T_full)
    with pytest.warns(RuntimeWarning, match="past the requested"):
        T_old = td.run(3, NX, NX, NX, checkpoint_dir=tmp_path, **kw)
    assert torch.equal(T_old, T_full)  # the step-6 state, returned unchanged


def test_runguard_checkpoint_keep_env_and_kwarg(tmp_path, clean_env, monkeypatch):
    monkeypatch.setenv("IGG_CHECKPOINT_KEEP", "2")
    g = tres.RunGuard(checkpoint_every=1, checkpoint_dir=str(tmp_path))
    assert g.checkpoint_keep == 2
    g = tres.RunGuard(checkpoint_every=1, checkpoint_dir=str(tmp_path), checkpoint_keep=3)
    assert g.checkpoint_keep == 3
    with pytest.raises(ValueError, match="checkpoint_keep"):
        tres.RunGuard(checkpoint_keep=-1)
    monkeypatch.delenv("IGG_CHECKPOINT_KEEP")
    td.run(6, NX, NX, NX, checkpoint_every=1, checkpoint_dir=tmp_path, checkpoint_keep=2,
           quiet=True, device="cpu", dtype=torch.float64)
    assert [s for s, _ in tck.checkpoint_steps(tmp_path)] == [5, 6]


def test_generation_fence_refuses_a_superseded_save(tmp_path, clean_env, monkeypatch):
    from implicitglobalgrid_tpu_torch.supervisor import generation

    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = _coord_state()
    monkeypatch.setenv("IGG_GENERATION", "3")
    monkeypatch.setenv("IGG_FENCE_DIR", str(tmp_path))
    path = tigg.save_checkpoint(tmp_path / "ck", (T,), 1)  # no fence file yet
    assert tck.checkpoint_meta(path)["generation"] == 3
    (tmp_path / "generation.json").write_text(json.dumps({"generation": 4}))
    with pytest.raises(generation.FenceError, match="superseded") as e:
        tigg.save_checkpoint(tmp_path / "ck", (T,), 2)
    assert (e.value.generation, e.value.authoritative) == (3, 4)
    assert [s for s, _ in tck.checkpoint_steps(tmp_path / "ck")] == [1]


def test_owned_range_and_dedup_helpers_match_jax():
    from implicitglobalgrid_tpu.ops import gather as jgather

    for nb, s, ol in [(2, 8, 2), (4, 5, 2), (3, 9, 3), (1, 8, 2)]:
        for periodic in (False, True):
            G = tgather.dedup_length(nb, s, ol, periodic)
            assert G == jgather.dedup_length(nb, s, ol, periodic)
            cover = []
            for c in range(nb):
                a, b = tgather.owned_range(c, nb, s, ol, periodic)
                assert (a, b) == jgather.owned_range(c, nb, s, ol, periodic)
                cover += list(tgather.dedup_indices(c, a, b, s, ol, G))
            assert sorted(cover) == list(range(G))
    with pytest.raises(ValueError, match="negative overlap"):
        tgather.owned_range(0, 2, 4, -1, False)
