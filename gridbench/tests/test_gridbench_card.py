"""One short run of each one-GPU cell on the card, through the command
that BENCHMARK.json names (skipped without a card)."""

from __future__ import annotations

import json
import subprocess

import pytest

from gridbench import spec

ROOT = spec.HERE.parent
BENCH = spec.load_benchmark(ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [w for w in BENCH["workloads"] if w["chips"] == 1],
                         ids=lambda w: w["name"])
def test_a_short_run_on_the_card_is_correct(w):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run python -m pytest gridbench/tests on one")
    out = subprocess.run([*BENCH["command"], "--workload", w["name"], "--seed", str(2**31 + 5),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
