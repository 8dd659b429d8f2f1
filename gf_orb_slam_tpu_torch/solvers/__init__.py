"""Solvers: pose-only Levenberg–Marquardt."""
