"""Halo exchange, gather, the stencil decorator and the CUDA kernels."""
