"""`stencil` — a pass-through decorator.

In the JAX package `stencil` maps a per-block step over the device mesh.  In
the port every process already holds exactly its own block, so a step written
for one block runs as it is; the decorator stays so that solvers written
against the JAX API (``@igg.stencil`` / ``@igg.stencil(donate_argnums=...)``)
port line for line.  The mapping options are accepted and have nothing to
act on.
"""

from __future__ import annotations


def stencil(fn=None, *, in_specs=None, out_specs=None, donate_argnums=()):
    """Return ``fn`` unchanged (usable bare or with the JAX keyword set)."""
    if fn is None:
        return lambda f: f
    return fn
