"""The port's acoustic model against the benchmark's plain reference
(``gridbench/reference/acoustic3d.py``), on seeded noisy fields at the
configuration's CPU block on the CPU in float64, through the benchmark
suite's own comparison (``_against_the_program``): every cadence of
``make_multi_step`` must give the reference's fields to 1e-12 of each
field's scale (rounding only: the two write the same update in a different
order)."""

import functools

import pytest

from gridbench import spec
from gridbench.tests.test_gridbench_reference import _against_the_program
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta

Z12 = {"periods": [0, 0, 1], "overlaps": [12, 12, 12]}


@pytest.mark.parametrize("grid_kw,fused_k,every", [
    (Z12, None, None),
    (Z12, None, 6),
    (Z12, 6, None),
    ({"periods": [0, 0, 0], "overlaps": [12, 12, 12]}, 6, None),
    ({"periods": [1, 0, 0], "overlaps": [12, 12, 12]}, 6, None),
], ids=["per_step-z", "exchange_every6-z", "fused_k6-z", "fused_k6-walls", "fused_k6-x"])
def test_make_multi_step_agrees_with_the_plain_reference(grid_kw, fused_k, every, monkeypatch):
    if every:
        # the comparison passes make_multi_step fused_k alone: bind the cadence
        monkeypatch.setattr(ta, "make_multi_step",
                            functools.partial(ta.make_multi_step, exchange_every=every))
    block = spec.config("acoustic3d-512")["cpu_block"]
    _against_the_program("acoustic3d-512", "acoustic3d", block, grid_kw, fused_k, 12)
