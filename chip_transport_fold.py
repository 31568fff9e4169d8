#!/usr/bin/env python3
"""Two layouts of the transport checksum's XOR fold, timed in turns on one
CUDA card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_transport_fold.py

With ``IGG_INTEGRITY=1`` every hop of the halo exchange (one wire buffer
per side) carries the XOR fold of its payload words, computed by the
sender and again by the receiver (`integrity.transport`).  torch has no
XOR reduction, so a fold is about log2(n) halving launches.  Two layouts
of a hop's fold work:

* ``per-buffer``: each side's buffer is folded on its own (sender: two
  ``append_checksum``; receiver: two ``split_and_verify``, the flags
  written into a ``(2,)`` tensor);
* ``stacked``: the two sides' buffers are stacked and folded together
  (sender: one ``append_checksum`` of the stack; receiver: the landed
  buffers stacked again, one ``split_and_verify``).

Both run over the three hops of ``update_halo(T, Cp)`` at the diffusion
main path's config (256^3 float32, periodic x/y/z, overlap 8; one block,
so every hop is the block's own, T and Cp packed into one 131,072-word
buffer per side), after a check that both give back the payload, raise no
flag, and flag a flipped word.  Then the whole exchange, checked
(``IGG_INTEGRITY=1``, the committed layout) and unchecked, in turns.
Every time is a CUDA-event mean over 20 calls after a warm-up; five rounds
alternate the two variants (A B, then B A).  Prints the card's name and
power limit first; exits non-zero without a card or on a wrong result.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS, REPS = 5, 20


def fail(msg: str) -> None:
    print(f"chip_transport_fold: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int = REPS, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(torch, a, b) -> tuple[list, list]:
    """``ROUNDS`` readings of each of ``a`` and ``b``, alternating which
    goes first."""
    ta, tb = [], []
    for r in range(ROUNDS):
        for fn, out in ((a, ta), (b, tb)) if r % 2 == 0 else ((b, tb), (a, ta)):
            out.append(cuda_ms(torch, fn))
    return ta, tb


def main() -> None:
    if not (ROOT / "implicitglobalgrid_tpu_torch" / "__init__.py").is_file():
        fail(f"{ROOT} holds no implicitglobalgrid_tpu_torch package: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.integrity import transport as tr
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.ops import halo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    n = 256
    (T, Cp), _ = diffusion3d.setup(n, n, n, periodx=1, periody=1, periodz=1, overlapx=8,
                                   overlapy=8, overlapz=8, dtype=torch.float32, quiet=True)
    gg = igg.global_grid()
    # The wire payloads of the three self-partner hops: T and Cp packed per
    # side, (to-lower, to-upper) = (src_hi, src_lo).
    hops = []
    for d in range(3):
        parts = [halo._slab_parts(A, d, gg, 1) for A in (T, Cp)]
        hops.append(tuple(torch.cat([halo._flat_words(p[2 - side]) for p in parts])
                          for side in (0, 1)))

    def per_buffer(flip=False):
        out = []
        for lo, hi in hops:
            wire = [tr.append_checksum(b) for b in (lo, hi)]
            if flip:
                wire[0][0] ^= 1
            recvs, bad = [wire[1], wire[0]], torch.zeros(2, dtype=torch.bool, device=lo.device)
            for i in (0, 1):
                recvs[i], bad[i] = tr.split_and_verify(recvs[i])
            out.append((recvs, bad))
        return out

    def stacked(flip=False):
        out = []
        for lo, hi in hops:
            wire = tr.append_checksum(torch.stack([lo, hi]))
            if flip:
                wire[:, 0] ^= 1
            payload, bad = tr.split_and_verify(torch.stack([wire[1], wire[0]]))
            out.append(([payload[0], payload[1]], bad))
        return out

    for name, fn in (("per-buffer", per_buffer), ("stacked", stacked)):
        good = all(torch.equal(r[0], hi) and torch.equal(r[1], lo) and not bool(bad.any())
                   for (r, bad), (lo, hi) in zip(fn(), hops))
        caught = all(bool(bad.any()) for _, bad in fn(flip=True))
        print(f"{name}: payloads and flags {'right' if good else 'WRONG'}; a flipped word "
              f"{'flagged' if caught else 'MISSED'} on every hop")
        if not (good and caught):
            fail(f"the {name} fold is wrong")
    words = hops[0][0].numel()
    ta, tb = in_turns(torch, per_buffer, stacked)
    print(f"fold work of one exchange's 3 hops ({words} words per side), ms, in turns: "
          f"per-buffer {ta!r}, stacked {tb!r} {card}")

    want = halo.update_halo(T.clone(), Cp.clone())
    os.environ["IGG_INTEGRITY"] = "1"
    got = halo.update_halo(T.clone(), Cp.clone())
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("the checked exchange differs from the unchecked one")

    def checked():
        os.environ["IGG_INTEGRITY"] = "1"
        halo.update_halo(T, Cp)

    def unchecked():
        os.environ["IGG_INTEGRITY"] = "0"
        halo.update_halo(T, Cp)

    tc, tu = in_turns(torch, checked, unchecked)
    print(f"update_halo(T, Cp) 256^3 f32 periodic x/y/z, ms, in turns: checked {tc!r}, "
          f"unchecked {tu!r} {card}")
    igg.finalize_global_grid()


if __name__ == "__main__":
    main()
