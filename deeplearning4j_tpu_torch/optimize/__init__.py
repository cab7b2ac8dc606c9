"""Optimization: training listeners and the flat solvers."""
