"""The port's `gather` against the JAX package's: the chunked plan.

Twins of the JAX package's ``tests/test_gather.py`` chunked cases and
``tests/test_telemetry.py``'s gather folds.  Gather is a byte copy, so every
comparison is bit-exact (``tobytes``), with no tolerance:

* `collective_plan` equals JAX's over a sweep of ``dims`` and ``batch``;
* one process: the forced chunked path equals the local path and JAX's
  `gather` (``-0.0`` and complex signed zeros kept, five dtypes, 2-D and
  staggered fields, ``dedup``), the stats are JAX's, they are reset at the
  start of a call, and an ``A_global`` error is raised after the chunks;
* three gloo ranks (one spawn, two grids): ``IGG_GATHER_BATCH`` 1, 2 and 8
  equal the global-block input and JAX's chunked gather on three devices,
  with JAX's stats on the root; at most ``batch`` blocks of receive buffers
  alive on the root at once and no host bytes on the other ranks; dtypes,
  a staggered field, ``dedup``, a non-default root, a filled ``A_global``,
  an ``A_global`` size error raised on the root after every rank finished
  its sends, and a 2-D field on a z-split grid (taken from the ranks at z
  coordinate 0, as JAX's replicated field is);
* the ``gather.*`` telemetry family, as JAX folds it.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import _batched as jbatched
from implicitglobalgrid_tpu.ops import gather as jgather
from implicitglobalgrid_tpu.utils import telemetry as jtele
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.ops import gather as tgather
from implicitglobalgrid_tpu_torch.utils import telemetry as ttele

NLOC = (6, 5, 4)
DTYPES = ["float16", "float32", "float64", "int16", "complex64"]


@pytest.fixture(autouse=True)
def _finalize_grids(monkeypatch):
    monkeypatch.delenv("IGG_GATHER_BATCH", raising=False)
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    if jigg.grid_is_initialized():
        jigg.finalize_global_grid()


def _values(shape, dtype, seed):
    """Seeded values of ``dtype`` with signed zeros in them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 100
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    a = a.astype(dtype)
    a.reshape(-1)[::7] = -0.0 if np.dtype(dtype).kind != "c" else complex(-0.0, -0.0)
    return a


def _jax_field(arr):
    gg = jigg.get_global_grid()
    return jax.device_put(arr, NamedSharding(gg.mesh, P(*jigg.AXIS_NAMES[: arr.ndim])))


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(1,), (3,), (2, 2), (2, 2, 2), (4, 2, 1), (3, 1, 5)])
def test_collective_plan_equals_jax(dims):
    for batch in (-1, 0, 1, 2, 3, 7, 8, 64):
        want = jgather.collective_plan(dims, batch)
        assert tgather.collective_plan(dims, batch) == want
        assert tgather.collective_plan(dims, batch, is_root=True) == want


@pytest.mark.parametrize("env,want", [(None, 8), ("3", 3), ("0", 1), ("-4", 1)])
def test_batch_size_knob_is_jax_s(monkeypatch, env, want):
    if env is not None:
        monkeypatch.setenv("IGG_GATHER_BATCH", env)
    assert tgather._gather_batch_size() == jgather._gather_batch_size() == want


# -- one process -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_equals_local_and_jax_on_one_process(dtype):
    A = _values(NLOC, dtype, 1)
    jigg.init_global_grid(*NLOC, quiet=True, devices=jax.devices()[:1])
    want = jigg.gather(_jax_field(A), _force_chunked=True)
    jstats = dict(jgather.last_gather_stats)
    tigg.init_global_grid(*NLOC, quiet=True, device="cpu")
    local = tigg.gather(torch.from_numpy(A))
    assert tgather.last_gather_stats["path"] == "local"
    got = tigg.gather(torch.from_numpy(A), _force_chunked=True)
    assert tgather.last_gather_stats == jstats
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert got.tobytes() == local.tobytes() == want.tobytes() == A.tobytes()


@pytest.mark.parametrize("shape", [(6, 5), (7, 5, 4), (6, 6, 4)])
def test_chunked_2d_staggered_and_dedup_on_one_process(shape):
    A = _values(shape, "float64", 2)
    jigg.init_global_grid(*NLOC, periody=1, quiet=True, devices=jax.devices()[:1])
    tigg.init_global_grid(*NLOC, periody=1, quiet=True, device="cpu")
    for dedup in (False, True):
        want = jigg.gather(_jax_field(A), dedup=dedup)
        got = tigg.gather(torch.from_numpy(A), dedup=dedup, _force_chunked=True)
        assert tgather.last_gather_stats["path"] == "chunked"
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
        buf = np.zeros(want.size, want.dtype)
        assert tigg.gather(torch.from_numpy(A), buf, dedup=dedup, _force_chunked=True) is None
        assert buf.tobytes() == want.tobytes()


def test_size_and_dtype_errors_raised_after_the_chunks():
    tigg.init_global_grid(*NLOC, quiet=True, device="cpu")
    jigg.init_global_grid(*NLOC, quiet=True, devices=jax.devices()[:1])
    A = np.ones(NLOC)
    for force in (False, True):
        with pytest.raises(ValueError, match="nprocs"):
            tigg.gather(torch.from_numpy(A), np.zeros(3), _force_chunked=force)
        with pytest.raises(ValueError, match="dtype"):
            tigg.gather(torch.from_numpy(A), np.zeros(A.size, np.float32), _force_chunked=force)
    with pytest.raises(ValueError, match="nprocs"):
        jigg.gather(_jax_field(A), np.zeros(3), _force_chunked=True)
    # the chunks all ran before the raise, and nothing reached the host
    assert tgather.last_gather_stats == {**jgather.last_gather_stats, "host_bytes": 0} == {
        "path": "chunked", "host_bytes": 0, "fetches": 1, "blocks": 1, "batch": 1,
        "block_bytes": A.nbytes}


def test_stats_reset_at_call_start():
    tigg.init_global_grid(*NLOC, quiet=True, device="cpu")
    A = torch.ones(NLOC)
    assert tigg.gather(A) is not None and tgather.last_gather_stats is not None
    with pytest.raises(ValueError, match="root must be a valid process index"):
        tigg.gather(A, root=99)
    assert tgather.last_gather_stats is None


def test_gather_registry_fold_is_jax_s(monkeypatch):
    monkeypatch.delenv("IGG_TELEMETRY", raising=False)
    snaps = []
    for igg, tele, kw in ((jigg, jtele, dict(devices=jax.devices()[:1])),
                          (tigg, ttele, dict(device="cpu"))):
        tele.reset()
        igg.init_global_grid(8, 8, 8, quiet=True, **kw)
        A = np.zeros((8, 8, 8), np.float32)
        A = _jax_field(A) if igg is jigg else torch.from_numpy(A)
        got = igg.gather(A)
        igg.gather(A, _force_chunked=True)
        igg.gather(A[None] if igg is tigg else jbatched.stack_fields(A, A), member=0)
        counters = tele.snapshot()["counters"]
        snaps.append({k: v for k, v in counters.items() if k.startswith("gather.")})
        assert got.nbytes == 8**3 * 4
        igg.finalize_global_grid()
    assert snaps[1] == snaps[0] == {
        "gather.calls": 3, "gather.calls.local": 2, "gather.calls.chunked": 1,
        "gather.fetches": 1, "gather.host_bytes": 3 * 8**3 * 4, "gather.member_calls": 1}
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    ttele.reset()
    tigg.init_global_grid(8, 8, 8, quiet=True, device="cpu")
    tigg.gather(torch.zeros(8, 8, 8))
    assert ttele.snapshot()["counters"] == {}
    assert tgather.last_gather_stats["path"] == "local"


# -- three gloo ranks ------------------------------------------------------------

NR = 3
VX = (NLOC[0] + 1, *NLOC[1:])


def _inputs():
    g = lambda shape, dt, seed: _values(tuple(NR * s if d == 0 else s  # noqa: E731
                                              for d, s in enumerate(shape)), dt, seed)
    ins = {f"A_{dt}": g(NLOC, dt, 10 + i) for i, dt in enumerate(DTYPES)}
    ins["Vx"] = g(VX, "float32", 20)
    ins["F2"] = _values(NLOC[:2], "float64", 21)
    return ins


def _gathers():
    """(key, spec) of grid 0 (dims (3,1,1), periodic y)."""
    size = NR * int(np.prod(NLOC))
    out = [(f"b{b}", dict(name="A_float64", shape=NLOC, batch=b)) for b in (1, 2, 8)]
    out += [(f"d_{dt}", dict(name=f"A_{dt}", shape=NLOC, batch=2)) for dt in DTYPES[:-1] + ["complex64"]]
    out += [("vx", dict(name="Vx", shape=VX, batch=2)),
            ("dedup", dict(name="A_float64", shape=NLOC, dedup=True)),
            ("dedup_vx", dict(name="Vx", shape=VX, dedup=True, batch=1)),
            ("root2", dict(name="A_float32", shape=NLOC, root=2, batch=1)),
            ("out", dict(name="A_float64", shape=NLOC, out=True, out_size=size,
                         out_dtype="float64")),
            ("bad", dict(name="A_float64", shape=NLOC, out=True, out_size=size - 1,
                         out_dtype="float64", root=1))]
    return out


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    ins = _inputs()
    gathers = [dict(key=k, **spec) for k, spec in _gathers()]
    f2 = [dict(key="f2", name="F2", shape=NLOC[:2], offset_by_rank=True, batch=1)]
    task = {"kind": "gather", "inputs": ins, "grids": [
        {"nxyz": list(NLOC), "grid": {"dimx": NR, "periody": 1}, "gathers": gathers},
        {"nxyz": list(NLOC), "grid": {"dimz": NR}, "gathers": f2}]}
    return ins, spawn(task, NR, tmp_path_factory.mktemp("gather"), timeout=180)


def _stats(out, key):
    return json.loads(out[f"{key}_stats"].tobytes())


def test_three_ranks_chunked_equals_jax_and_holds_the_bound(three_ranks):
    ins, outs = three_ranks
    jigg.init_global_grid(*NLOC, dimx=NR, periody=1, quiet=True, devices=jax.devices()[:NR])
    block = int(np.prod(NLOC)) * 8
    for b, peak in ((1, 1), (2, 1), (8, 2)):
        key = f"b{b}"
        A = ins["A_float64"]
        want = jigg.gather(_jax_field(A), _force_chunked=True)
        jax_env_stats = dict(jgather.last_gather_stats, batch=min(8, NR), fetches=1)
        assert outs[0][key].tobytes() == want.tobytes() == A.tobytes()
        got = _stats(outs[0], key)
        assert got == {"path": "chunked", "host_bytes": NR * block, "fetches": -(-NR // b),
                       "blocks": NR, "batch": min(b, NR), "block_bytes": block}
        if b == 8:  # JAX's default batch
            assert got == jax_env_stats
        # the root holds at most one chunk of other ranks' blocks at once
        assert int(outs[0][f"{key}_peak"]) == peak * block <= b * block
        for r in (1, 2):
            assert key not in outs[r]
            assert _stats(outs[r], key) == {**got, "host_bytes": 0}
            assert int(outs[r][f"{key}_peak"]) == 0


def test_three_ranks_dtypes_staggered_dedup_root_and_out(three_ranks):
    ins, outs = three_ranks
    jigg.init_global_grid(*NLOC, dimx=NR, periody=1, quiet=True, devices=jax.devices()[:NR])
    for dt in DTYPES:
        got = outs[0][f"d_{dt}"]
        assert got.dtype == np.dtype(dt)
        assert got.tobytes() == jigg.gather(_jax_field(ins[f"A_{dt}"])).tobytes()
    assert outs[0]["vx"].tobytes() == ins["Vx"].tobytes()
    assert outs[0]["vx"].tobytes() == jigg.gather(_jax_field(ins["Vx"])).tobytes()
    for key, name in (("dedup", "A_float64"), ("dedup_vx", "Vx")):
        want = jigg.gather(_jax_field(ins[name]), dedup=True)
        assert outs[0][key].shape == want.shape and outs[0][key].tobytes() == want.tobytes()
    assert "root2" not in outs[0] and outs[2]["root2"].tobytes() == ins["A_float32"].tobytes()
    assert _stats(outs[0], "root2")["host_bytes"] == 0
    assert outs[0]["out"].tobytes() == ins["A_float64"].tobytes()


def test_three_ranks_size_error_raised_after_the_chunks(three_ranks):
    _, outs = three_ranks
    assert "nprocs" in outs[1]["bad_err"].tobytes().decode()
    for r in range(NR):
        stats = _stats(outs[r], "bad")
        # every rank walked every chunk; the root (1) assembled nothing
        assert stats["blocks"] == NR and stats["fetches"] == 1 and stats["host_bytes"] == 0
        assert "bad" not in outs[r] and (r == 1) == ("bad_err" in outs[r])


def test_three_ranks_2d_field_on_a_z_split_grid(three_ranks):
    ins, outs = three_ranks
    jigg.init_global_grid(*NLOC, dimz=NR, quiet=True, devices=jax.devices()[:NR])
    want = jigg.gather(_jax_field(ins["F2"]), _force_chunked=True)
    # rank r's block is F2 + r: the source is the rank at z coordinate 0
    assert outs[0]["f2"].tobytes() == want.tobytes() == ins["F2"].tobytes()
    assert _stats(outs[0], "f2")["blocks"] == 1
