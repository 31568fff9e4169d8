"""The port's benchmark harness: `run` (one JSON line per config) and
`bench` (the one-line headline record), the JAX package's
``benchmarks/run.py`` and root ``bench.py`` over the port."""
