"""Solvers built on the grid (this slice: 3-D diffusion)."""
