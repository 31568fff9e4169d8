"""gridbench: the benchmark of implicitglobalgrid_tpu_torch (see README.md)."""
