"""Ops of the port: peaks, crops, grids and the hand-written CUDA kernels."""
