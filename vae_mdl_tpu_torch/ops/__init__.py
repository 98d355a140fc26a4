"""Numerical primitives and the hand-written kernels."""
