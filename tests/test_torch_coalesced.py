"""The port's coalesced halo exchange against its per-field exchange and JAX.

Counterpart of ``tests/test_coalesced_halo.py``.  Coalescing packs the send
slabs of every field that permutes a dimension into one buffer per dtype
word width (``ops.halo._flat_words``), so a dimension moves ONE
send/receive pair per side and width group.  Held here:

* the packing is a byte-exact reinterpretation (NaN payloads, -0.0, every
  dtype), and ``IGG_COALESCE`` parses like the JAX package's;
* on one rank (self partners: nothing packs) and on two gloo ranks split in
  x, the coalesced exchange, `begin/finish_slab_exchange` included, equals
  the per-field one and JAX's bit for bit, for mixed float64/float32 fields
  and for the staggered field set; ``IGG_COALESCE=0`` equals
  ``coalesce=False``;
* ``P2POp``s per dimension: 2 per side per width group, in the forward and
  in the backward (per field without coalescing);
* the coalesced gradient equals the per-field gradient exactly, and central
  differences at send and halo planes (JAX ``test_coalesced_halo.py:424``);
* acoustic and porous cadences with ``coalesce=True`` against JAX's
  ``coalesce=True`` cadences on two ranks (float64, 1e-12).

All two-rank cases run in one spawn.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import acoustic3d as ja
from implicitglobalgrid_tpu.models import porous_convection3d as jpc
from implicitglobalgrid_tpu.utils.config import coalesce_env as jax_coalesce_env
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import halo as th


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def unique(shape, dtype, offset=0):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float64) + 1 + offset).reshape(shape).astype(dtype)


def _jax_update(fields, width, coalesce=True):
    from jax.sharding import NamedSharding, PartitionSpec as P

    gg = jigg.get_global_grid()
    arrs = [jax.device_put(f, NamedSharding(gg.mesh, P(*jigg.AXIS_NAMES[: f.ndim])))
            for f in fields]
    out = jigg.update_halo(*arrs, width=width, coalesce=coalesce)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                                   torch.int32, torch.bool, torch.complex64, torch.complex128])
def test_word_packing_is_byte_exact(dtype):
    """`_flat_words` -> `_from_words` returns the same bytes; words are as
    wide as JAX's (complex splits into two float words)."""
    raw = torch.from_numpy(np.random.default_rng(0).integers(0, 256, 6 * 5 * 2 * 16,
                                                             dtype=np.uint8))
    if dtype == torch.bool:
        x = (raw[:60] % 2).bool().reshape(6, 5, 2)
    else:
        x = raw[: 60 * dtype.itemsize].view(dtype).reshape(6, 5, 2)
    if dtype.is_floating_point:
        x.view(-1)[:2] = torch.tensor([float("nan"), -0.0], dtype=dtype)
    words = th._flat_words(x[:, 1:4])  # a strided slab
    assert words.dim() == 1 and words.element_size() == th._word_width(dtype)
    back = th._from_words(words, x[:, 1:4].shape, dtype)
    assert back.dtype == dtype
    assert torch.equal(back.reshape(-1).view(torch.uint8),
                       x[:, 1:4].contiguous().reshape(-1).view(torch.uint8))


def test_igg_coalesce_parses_like_jax(monkeypatch):
    for val, want in (("0", False), ("1", True), ("7", True), ("", True)):
        monkeypatch.setenv("IGG_COALESCE", val)
        assert th.resolve_coalesce(None) is want
        assert th.resolve_coalesce(False) is False
        jax_val = jax_coalesce_env()
        assert (True if jax_val is None else jax_val) is want
    monkeypatch.delenv("IGG_COALESCE")
    assert th.resolve_coalesce(None) is True
    monkeypatch.setenv("IGG_COALESCE", "x")
    with pytest.raises(ValueError, match="IGG_COALESCE"):
        th.resolve_coalesce(None)


ONE_RANK = [
    # (local shape, field shapes, dtypes, width, grid kwargs)
    ((6, 6, 6), [(6, 6, 6), (7, 6, 6), (6, 6, 7)], [np.float64, np.float32, np.float64], 1,
     dict(periodx=1, periody=1, periodz=1)),
    ((9, 9, 9), [(9, 9, 9), (10, 9, 9), (9, 10, 9), (9, 9, 10)], [np.float32] * 4, 2,
     dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)),
]


@pytest.mark.parametrize("nxyz,shapes,dtypes,width,kw", ONE_RANK)
def test_coalesced_exchange_one_rank(nxyz, shapes, dtypes, width, kw, monkeypatch):
    """One rank, self partners: coalesce on, off and ``IGG_COALESCE=0``
    equal JAX's coalesced exchange bit for bit, `begin/finish` too."""
    jigg.init_global_grid(*nxyz, quiet=True, devices=jax.devices()[:1], **kw)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    fields = [unique(s, dt, offset=1000 * i) for i, (s, dt) in enumerate(zip(shapes, dtypes))]
    want = _jax_update(fields, width)
    for coalesce, env in ((True, None), (False, None), (None, "0")):
        if env is not None:
            monkeypatch.setenv("IGG_COALESCE", env)
        got = tigg.update_halo(*(torch.from_numpy(f.copy()) for f in fields), width=width,
                               coalesce=coalesce)
        split = [torch.from_numpy(f.copy()) for f in fields]
        th.finish_slab_exchange(split, th.begin_slab_exchange(split, range(3), width=width,
                                                              coalesce=coalesce))
        for g, s, w in zip(got, split, want):
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(s.numpy(), w)


def _params_json(params):
    pj = {k: v for k, v in params.__dict__.items() if k != "dtype"}
    pj["dtype"] = "float64"
    return pj


def test_coalesced_exchange_two_ranks(tmp_path):
    """dimx=2, periodic x and z, overlap 4: one spawn for every case."""
    nxyz = (8, 8, 8)
    grid = dict(dimx=2, periodx=1, periodz=1, overlapx=4, overlapz=4)
    jigg.init_global_grid(*nxyz, quiet=True, devices=jax.devices()[:2], **grid)
    gg = jigg.get_global_grid()

    def globe(shapes, dtypes, offset):
        return [unique(tuple(gg.dims[d] * s[d] for d in range(3)), dt, offset=offset + 10**5 * i)
                for i, (s, dt) in enumerate(zip(shapes, dtypes))]

    sets = {
        # prefix: (local shapes, dtypes, width); f64 + f32 + f64: two width groups
        "m": ([(8, 8, 8), (9, 8, 8), (8, 8, 9)], [np.float64, np.float32, np.float64], 1),
        # the staggered set at a deep halo: one width group
        "s": ([(8, 8, 8), (9, 8, 8), (8, 9, 8), (8, 8, 9)], [np.float64] * 4, 2),
    }
    runs, inputs, wants = [], {}, {}
    for pre, (shapes, dtypes, width) in sets.items():
        fields = globe(shapes, dtypes, offset=0)
        wants[pre] = _jax_update(fields, width)
        names = [f"F{i}" for i in range(len(shapes))]
        base = dict(model="halo", fields=names, shapes=[list(s) for s in shapes], width=width,
                    split=True, wrt=names)
        for suffix, extra in (("c", dict(coalesce=True)), ("p", dict(coalesce=False)),
                              ("e", dict(env={"IGG_COALESCE": "0"}))):
            # The loss is quadratic in every value, so a large step is exact
            # up to the loss's rounding.
            fd = dict(fd_points=[[0, "F0", [3, 4, 4]], [0, "F0", [4, 4, 4]], [0, "F0", [0, 4, 4]],
                                 [1, "F2", [3, 4, 4]]], eps=16.0) if pre + suffix == "mc" else {}
            runs.append(dict(base, prefix=pre + suffix, **extra, **fd))
            inputs.update({f"{pre}{suffix}{n}": f for n, f in zip(names, fields)})
    jigg.finalize_global_grid()

    # The staggered cadences with coalesce=True against JAX's.
    cadences = {
        "A": (ja, ta, {}, 2, [dict(), dict(exchange_every=2), dict(fused_k=2)]),
        "Q": (jpc, tpc, dict(npt=4), 1, [dict(), dict(exchange_every=2), dict(fused_k=2)]),
    }
    for pre, (jm, tm, kw, nsteps, steps) in cadences.items():
        jstate, jparams = jm.setup(*nxyz, dtype=jnp.float64, quiet=True,
                                   devices=jax.devices()[:2], **kw, **grid)
        jstate = [np.asarray(a) for a in jstate]
        names = {ta: ("P", "Vx", "Vy", "Vz"), tpc: ("T", "Pf", "qDx", "qDy", "qDz")}[tm]
        for i, step in enumerate(steps):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # JAX's float64 fused fallback
                fn = jm.make_multi_step(jparams, nsteps, donate=False, coalesce=True, **step)
                wants[pre, i] = [np.asarray(a) for a in fn(*map(jnp.asarray, jstate))]
            runs.append(dict(model={ta: "acoustic", tpc: "porous"}[tm], prefix=f"{pre}{i}",
                             params=_params_json(tm.params_from(jparams)), nsteps=nsteps,
                             step=dict(step, coalesce=True), wrt=[names[0]]))
            inputs.update({f"{pre}{i}{n}": a for n, a in zip(names, jstate)})
        jigg.finalize_global_grid()

    outs = spawn(dict(kind="grad", nxyz=list(nxyz), grid=grid, runs=runs, inputs=inputs), 2,
                 tmp_path, timeout=240)
    for rank, out in enumerate(outs):
        for pre, (shapes, _, _) in sets.items():
            names = [f"F{i}" for i in range(len(shapes))]
            for i, (name, s) in enumerate(zip(names, shapes)):
                block = wants[pre][i][rank * s[0]:(rank + 1) * s[0]]
                for suffix in "cpe":
                    np.testing.assert_array_equal(out[f"{pre}{suffix}{name}"], block)
                    np.testing.assert_array_equal(out[f"{pre}{suffix}{name}_split"], block)
                dc = out[f"{pre}cd{name}"]
                assert np.abs(dc).max() > 0
                assert np.array_equal(dc, out[f"{pre}pd{name}"]), (pre, name)
                assert np.array_equal(dc, out[f"{pre}ed{name}"]), (pre, name)
            groups = len({dt for dt in sets[pre][1]})
            for suffix, msgs in (("c", groups), ("p", len(shapes)), ("e", len(shapes))):
                # x: 2 per side (a send and a receive) per message, forward and
                # backward; y has no halo activity, z's partner is the block.
                assert out[f"{pre}{suffix}p2p"].tolist() == [4 * msgs, 0, 0, 4 * msgs, 0, 0]
                assert out[f"{pre}{suffix}p2p_split"].tolist() == [4 * msgs, 0, 0, 0, 0, 0]
        np.testing.assert_allclose(out["mcfd"], outs[0]["mcfd"])
        for pre, (_, tm, _, _, steps) in cadences.items():
            names = {ta: ("P", "Vx", "Vy", "Vz"), tpc: ("T", "Pf", "qDx", "qDy", "qDz")}[tm]
            for i in range(len(steps)):
                for name, w in zip(names, wants[pre, i]):
                    h = w.shape[0] // 2  # rank r holds rows [r*h, (r+1)*h)
                    scale = max(float(np.abs(w).max()), 1.0)
                    np.testing.assert_allclose(out[f"{pre}{i}{name}"], w[rank * h:(rank + 1) * h],
                                               rtol=1e-12, atol=1e-12 * scale,
                                               err_msg=f"{pre} {i} {name} {rank}")
    got = [outs[0]["mcdF0"][3, 4, 4], outs[0]["mcdF0"][4, 4, 4], outs[0]["mcdF0"][0, 4, 4],
           outs[1]["mcdF2"][3, 4, 4]]
    assert got[2] == 0  # a halo plane: its value is overwritten
    np.testing.assert_allclose(got, outs[0]["mcfd"], rtol=1e-6, atol=1e-4)
