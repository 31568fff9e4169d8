"""Operator tools of the port: the counterparts of the repo's ``scripts/``.

Each module keeps its JAX script's name and command line and runs as
``python -m implicitglobalgrid_tpu_torch.scripts.<name>``:

* `soak` — the fault-injection soak: ten scenarios through fault
  injection, the guarded loop, checkpoints, the supervisor, the integrity
  plane, serving, the front door, the live plane and the fleet, each
  recovered result held bit for bit against a fault-free oracle;
* `igg_trace` — merge, validate, summarize and export per-rank span dumps;
* `igg_top` — one cluster view over the ranks' live-plane endpoints.
* `check_perf` — the perf-regression gate over the committed
  ``BENCH_H100_r<NN>.json`` bench records (`analysis.perf`).

They import torch and this package only.
"""
