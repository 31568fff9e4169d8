"""The port's integrity plane against the JAX package's.

Ports the cases of the JAX package's ``tests/test_integrity.py`` that have
a meaning in the port:

* transport checksums: the XOR fold equals JAX's on the same words; a
  checksummed exchange is bit-identical to the unchecked one (self-partner
  hops included, which the port checksums too), an armed in-flight flip
  trips the receiver naming the sender, and ``IGG_INTEGRITY`` unset or 0
  leaves the exchange untouched;
* the shadow-step audit: healthy re-execution is bit-identical for the
  three models, serialized and pipelined with ``fused_k`` (the kernels'
  plain versions here; the kernels themselves in ``chip_smoke.py`` phase
  10b), and a finite ``bit_flip`` is caught at its step;
* lineage digests: equal to JAX's for the same bytes, and a generation
  poisoned between digest and write is walked past;
* ``integrity_plan`` equals JAX's.

Audits, checksums and digests compare bits, so every comparison here is
exact.  The two-rank legs (a flip implicating rank 1, the audit's
implicated rank) run in ``tests/test_torch_checkpoint.py``'s spawns.
"""

import json
import os
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu import integrity as jint
from implicitglobalgrid_tpu.integrity import lineage as jlineage
from implicitglobalgrid_tpu_torch import integrity
from implicitglobalgrid_tpu_torch.integrity import IntegrityError, lineage
from implicitglobalgrid_tpu_torch.models import _fused
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import halo as thalo
from implicitglobalgrid_tpu_torch.utils import checkpoint as tck
from implicitglobalgrid_tpu_torch.utils import resilience
from implicitglobalgrid_tpu_torch.utils import telemetry as tele
from implicitglobalgrid_tpu_torch.utils.resilience import (
    FaultInjector,
    RunGuard,
    guarded_time_loop,
)


def _counter(name: str) -> int:
    return tele.snapshot()["counters"].get(name, 0)


@pytest.fixture(autouse=True)
def _finalize_torch_grid(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    resilience.reset_fault_injector()
    yield
    resilience.reset_fault_injector()
    thalo._take_transport_flip()
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


@pytest.fixture
def fault_injection(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("IGG_FAULT_INJECT", spec)
        resilience.reset_fault_injector()
        return resilience.get_fault_injector()

    return arm


# --- transport checksum primitives ------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 37, 64, 1000])
def test_fold_words_equals_jax(n):
    words = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
    got = integrity.fold_words(torch.from_numpy(words.view(np.int32)))
    want = np.asarray(jint.fold_words(jnp.asarray(words)))
    assert got.shape == () and np.int32(got.item()).view(np.uint32) == want
    want64 = np.bitwise_xor.reduce(words.astype(np.uint64) << 7) if n else np.uint64(0)
    got64 = integrity.fold_words(torch.from_numpy((words.astype(np.uint64) << 7).view(np.int64)))
    assert np.int64(got64.item()).view(np.uint64) == want64


def test_fold_words_xor_round_trip():
    words = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2**32, 37, dtype=np.uint32).view(np.int32))
    wire = integrity.append_checksum(words)
    assert wire.shape == (38,)
    payload, bad = integrity.split_and_verify(wire)
    assert torch.equal(payload, words) and not bool(bad)
    for pos in (0, 17, 37):  # payload head, middle, the checksum word
        flipped = wire.clone()
        flipped[pos] ^= 1
        _, bad = integrity.split_and_verify(flipped)
        assert bool(bad), f"flip at word {pos} not caught"
    assert int(integrity.fold_words(words[:0])) == 0


def test_checksum_covers_nan_and_negative_zero_bits():
    a = torch.from_numpy(np.array([np.nan, -0.0, 1.0]).view(np.int64))
    b = torch.from_numpy(np.array([np.nan, +0.0, 1.0]).view(np.int64))
    assert int(integrity.fold_words(a)) != int(integrity.fold_words(b))


# --- transport checksums in the exchange ------------------------------------


def _grid_and_fields(periods=(1, 1, 0)):
    tigg.init_global_grid(12, 12, 12, periodx=periods[0], periody=periods[1],
                          periodz=periods[2], quiet=True, device="cpu")
    rng = np.random.default_rng(1)
    T = torch.from_numpy(rng.standard_normal((12, 12, 12)))
    C = torch.from_numpy(rng.standard_normal((12, 12, 12)).astype(np.float32))
    return T, C


def test_transport_checksum_clean_exchange_bit_identical(monkeypatch):
    T, C = _grid_and_fields()
    want = tigg.update_halo(T.clone(), C.clone())
    monkeypatch.setenv("IGG_INTEGRITY", "1")
    hops = []
    real = thalo._check_transport_flags
    monkeypatch.setattr(thalo, "_check_transport_flags",
                        lambda gg, col: hops.append(list(col.records)) or real(gg, col))
    got = tigg.update_halo(T.clone(), C.clone())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # one checksummed buffer pair per (dimension, word width): the two
    # self-partner dims x and y, f64 and f32 each; z is not periodic
    assert [(r["dim"], r["width"], r["fields"]) for r in hops[0]] == [
        (0, 8, (0,)), (0, 4, (1,)), (1, 8, (0,)), (1, 4, (1,))]


def test_transport_checksum_trips_receiver_and_implicates_sender(monkeypatch):
    monkeypatch.setenv("IGG_INTEGRITY", "1")
    T, C = _grid_and_fields()
    base = _counter("integrity.transport_mismatches")
    thalo.arm_transport_flip(0)
    with pytest.raises(IntegrityError) as ei:
        tigg.update_halo(T.clone(), C.clone())
    err = ei.value
    assert err.detector == "transport_checksum"
    assert err.implicated_rank == 0  # one rank: the block is its own sender
    assert (err.dim, err.direction, err.fields) == (0, "lo", (0,))
    assert _counter("integrity.transport_mismatches") == base + 1
    # the flip was consumed: the next exchange is clean
    want = tigg.update_halo(T.clone(), C.clone())
    monkeypatch.setenv("IGG_INTEGRITY", "0")
    assert all(torch.equal(g, w) for g, w in zip(want, tigg.update_halo(T.clone(), C.clone())))


def test_transport_checksum_single_field_routes_packed(monkeypatch):
    monkeypatch.setenv("IGG_INTEGRITY", "1")
    T, _ = _grid_and_fields()
    want = T.clone()
    monkeypatch.setenv("IGG_INTEGRITY", "0")
    tigg.update_halo(want)
    monkeypatch.setenv("IGG_INTEGRITY", "1")
    assert torch.equal(tigg.update_halo(T.clone()), want)
    thalo.arm_transport_flip(0)
    with pytest.raises(IntegrityError):
        tigg.update_halo(T.clone())
    thalo.arm_transport_flip(3)  # another rank's flip: nothing flips here
    assert torch.equal(tigg.update_halo(T.clone()), want)


@pytest.mark.parametrize("setting", [None, "0"])
def test_integrity_off_leaves_the_exchange_alone(monkeypatch, setting):
    """``IGG_INTEGRITY`` unset or 0: no collector, no checksum; 0 also pins
    the audit cadence to 0 whatever ``IGG_INTEGRITY_EVERY`` says, unset
    honors it (the tri-state contract)."""
    if setting is not None:
        monkeypatch.setenv("IGG_INTEGRITY", setting)
    monkeypatch.setenv("IGG_INTEGRITY_EVERY", "3")
    monkeypatch.setattr(integrity.transport, "TransportCollector",
                        lambda *a, **k: pytest.fail("a collector was made"))
    T, C = _grid_and_fields()
    tigg.update_halo(T, C)
    guard = RunGuard()
    assert guard.integrity_every == (0 if setting == "0" else 3)
    assert guard.enabled is (setting is None)


# --- shadow-step audit -------------------------------------------------------

#: (model, field names, setup kwargs, nsteps per call, fused_k)
_MATRIX = {
    "diffusion": (td, ("T", "Cp"), {}, 4),
    "acoustic": (ta, ("P", "Vx", "Vy", "Vz"), {}, 4),
    "porous": (tpc, ("T", "Pf", "qDx", "qDy", "qDz"), dict(npt=5), 1),
}


@pytest.mark.parametrize("name", list(_MATRIX))
@pytest.mark.parametrize("pipelined", [False, True], ids=["serialized", "pipelined"])
def test_shadow_audit_healthy_bit_identical(name, pipelined, monkeypatch):
    """At ``integrity_every=1`` every committed step re-executes and
    bit-compares: healthy runs re-execute bit-identically for the three
    models' fused cadences, serialized and pipelined (forced on one rank,
    as ``tests/test_torch_pipelined.py`` does)."""
    model, names, kw, nsteps = _MATRIX[name]
    grid = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)
    state, params = model.setup(32, 30, 8, dtype=torch.float32, quiet=True, device="cpu",
                                **grid, **kw)
    groups = []
    real = _fused.run_pipelined_group_schedule
    monkeypatch.setattr(_fused, "run_pipelined_group_schedule",
                        lambda chunks, *a, **k: groups.extend(chunks) or real(chunks, *a, **k))
    step = model.make_multi_step(params, nsteps, fused_k=2, fused_tile=(8, 8),
                                 pipelined=pipelined)
    base = _counter("integrity.audits")
    guard = RunGuard(integrity_every=1, names=names)
    out = guarded_time_loop(step, state, 2, guard=guard)
    assert _counter("integrity.audits") == base + 2
    assert bool(groups) is pipelined
    assert all(torch.isfinite(A).all() for A in out)


def test_shadow_audit_catches_state_bit_flip(fault_injection):
    """One flipped bit in the committed post-step state — finite, invisible
    to the NaN/Inf guard — trips the audit at its step, before the
    checkpoint stage."""
    state, params = td.setup(12, 12, 12, dtype=torch.float64, quiet=True, device="cpu")
    fault_injection("bit_flip:step2:T")
    guard = RunGuard(integrity_every=1, names=("T", "Cp"))
    base = _counter("integrity.audit_mismatches")
    with pytest.raises(IntegrityError) as ei:
        guarded_time_loop(td.make_step(params), state, 4, guard=guard)
    assert ei.value.detector == "shadow_audit" and ei.value.step == 2
    assert ei.value.implicated_rank == 0
    assert "T: block(s) (0, 0, 0)" in str(ei.value)
    assert _counter("integrity.audit_mismatches") == base + 1


def test_shadow_audit_guard_invisible_without_integrity(fault_injection):
    state, params = td.setup(12, 12, 12, dtype=torch.float64, quiet=True, device="cpu")
    clean = guarded_time_loop(td.make_step(params), tuple(A.clone() for A in state), 3,
                              guard=RunGuard())
    fault_injection("bit_flip:step2:Cp")
    guard = RunGuard(guard_every=1, policy="raise", names=("T", "Cp"))
    assert guard.integrity_every == 0
    out = guarded_time_loop(td.make_step(params), state, 3, guard=guard)
    assert all(torch.isfinite(A).all() for A in out)  # corrupt but finite
    assert not torch.equal(out[1], clean[1])
    diff = (out[1].view(torch.int64) ^ clean[1].view(torch.int64)).nonzero().tolist()
    assert diff == [[1, 1, 1]]  # exactly bit 0 of the cell one off the edge


def test_audit_fields_word_compare():
    tigg.init_global_grid(8, 8, 8, quiet=True, device="cpu")
    A = torch.full((8, 8, 8), float("nan"))
    B = A.clone()
    assert integrity.audit_fields((A,), (B,)).ok  # NaN == NaN bitwise
    B.view(torch.int32)[3, 3, 3] ^= 1 << 22  # another NaN payload
    report = integrity.audit_fields((A,), (B,), names=("A",))
    assert not report.ok and report.implicated_ranks == (0,)
    assert "re-execution differs bitwise in A" in report.summary()
    with pytest.raises(ValueError, match="re-execution 2"):
        integrity.audit_fields((A,), (A, B))
    with pytest.raises(ValueError, match="committed but"):
        integrity.audit_fields((A,), (B.double(),))


# --- bit_flip fault grammar ----------------------------------------------------


def test_bit_flip_rejects_nonexistent_field():
    state, _ = td.setup(12, 12, 12, dtype=torch.float64, quiet=True, device="cpu")
    inj = FaultInjector.from_spec("bit_flip:step1:Temperature")
    with pytest.raises(ValueError) as ei:
        inj.maybe_bit_flip(tuple(state), 1, names=("T", "Cp"))
    msg = str(ei.value)
    assert "Temperature" in msg and "'T'" in msg and "'Cp'" in msg


def test_bit_flip_not_in_default_chaos_kinds():
    assert "bit_flip" in resilience.FAULT_KINDS
    assert "bit_flip" not in resilience.CHAOS_KINDS
    doc = FaultInjector.__doc__
    assert "bit_flip" in doc and "halo_corrupt" in doc and "guard" in doc.lower()


def test_bit_flip_transport_placement_arms_the_next_exchange(fault_injection, monkeypatch):
    monkeypatch.setenv("IGG_INTEGRITY", "1")
    T, C = _grid_and_fields()
    inj = fault_injection("bit_flip:step3:transport")
    inj.maybe_bit_flip_transport(2)
    tigg.update_halo(T.clone(), C.clone())  # not armed yet
    inj.maybe_bit_flip_transport(3)
    with pytest.raises(IntegrityError, match="implicating sender rank 0"):
        tigg.update_halo(T.clone(), C.clone())


# --- lineage digests -----------------------------------------------------------


def test_lineage_helpers_equal_jax():
    rng = np.random.default_rng(2)
    raws = {f"f{i}_o{j}_0_0": np.frombuffer(rng.bytes(64 + j), np.uint8)
            for i in range(2) for j in range(3)}
    blocks = {k: lineage.block_digest(v) for k, v in raws.items()}
    assert blocks == {k: jlineage.block_digest(v) for k, v in raws.items()}
    fd = lineage.field_digests_from_blocks(blocks, 2)
    assert fd == jlineage.field_digests_from_blocks(blocks, 2)
    assert lineage.chain_field_digests(fd, None) == jlineage.chain_field_digests(fd, None)
    assert lineage.chain_field_digests(fd, fd) == jlineage.chain_field_digests(fd, fd)


def test_lineage_chains_and_detects_poisoned_generation(tmp_path, fault_injection):
    tigg.init_global_grid(12, 12, 12, quiet=True, device="cpu")
    T = torch.full((12, 12, 12), 1.5, dtype=torch.float64)
    C = torch.ones(12, 12, 12, dtype=torch.float32)
    d = str(tmp_path / "ck")
    p4 = tck.save_checkpoint(d, (T, C), 4)
    assert tck.verify_checkpoint(p4) is None
    lin4 = tck.checkpoint_meta(p4)["lineage"]
    assert len(lin4["fields"]) == 2 and lin4["prev_step"] is None
    p6 = tck.save_checkpoint(d, (T, C), 6)
    lin6 = tck.checkpoint_meta(p6)["lineage"]
    assert lin6["prev_step"] == 4
    assert lin6["fields"][0]["digest"] == lin4["fields"][0]["digest"]
    assert lin6["fields"][0]["chain"] != lin4["fields"][0]["chain"]
    fault_injection("bit_flip:step8:ckpt")
    p8 = tck.save_checkpoint(d, (T, C), 8)
    assert "already corrupt when saved" in tck.verify_checkpoint(p8)
    assert torch.equal(T, torch.full((12, 12, 12), 1.5, dtype=torch.float64))  # live state intact
    best = tck.latest_checkpoint(d)
    assert best.endswith("step_00000006")
    with pytest.raises(ValueError, match="already corrupt"):
        tck.restore_checkpoint(p8)
    state, step, _ = tck.restore_checkpoint(best)
    assert step == 6 and torch.equal(state[0], T)


def test_lineage_ignores_legacy_meta(tmp_path):
    tigg.init_global_grid(12, 12, 12, quiet=True, device="cpu")
    p = tck.save_checkpoint(str(tmp_path / "ck"), (torch.ones(12, 12, 12),), 1)
    meta_path = os.path.join(p, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["lineage"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert tck.verify_checkpoint(p) is None


def test_streaming_verifier_memory_bounded(tmp_path):
    big = np.random.default_rng(0).random((4, 1 << 20))  # 32 MiB payload
    path = str(tmp_path / "shards_p0.npz")
    np.savez(path, f0_o0_0_0=big.view(np.uint8).reshape(-1),
             f0_o0_0_0_shape=np.asarray(big.shape))
    del big
    tracemalloc.start()
    digests = lineage.stream_npz_block_digests(path)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert set(digests) == {"f0_o0_0_0"}
    assert peak < 8 * lineage.STREAM_CHUNK
    assert digests == jlineage.stream_npz_block_digests(path)
    assert digests["f0_o0_0_0"] == lineage.block_digest(np.load(path)["f0_o0_0_0"])


# --- rank-uniformity plan --------------------------------------------------------


@pytest.mark.parametrize("checksums", [False, True])
@pytest.mark.parametrize("audit_every,step", [(0, 5), (5, 5), (5, 6)])
def test_integrity_plan_equals_jax(checksums, audit_every, step):
    from implicitglobalgrid_tpu.integrity.plan import integrity_plan as jplan

    for is_root in (True, False):
        got = integrity.integrity_plan(is_root, checksums=checksums, audit_every=audit_every,
                                       step=step, exchange_dims=3)
        assert got == jplan(is_root, checksums=checksums, audit_every=audit_every, step=step,
                            exchange_dims=3)
    assert len(got) == 3 + (audit_every and step % audit_every == 0)


def test_integrity_is_a_subpackage_outside_all():
    import implicitglobalgrid_tpu as jigg

    assert "integrity" not in tigg.__all__ and "integrity" not in jigg.__all__
    assert set(integrity.__all__) == set(jint.__all__)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert integrity.IntegrityError("x", detector="d").fields == ()
