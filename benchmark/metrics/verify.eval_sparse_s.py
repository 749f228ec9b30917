"""Span ``eval_sparse_polys`` within the verify calls (the NIZK verifier
evaluates A, B and C at the proof's (rx, ry) itself,
``r1cs/shape.py::multi_evaluate``), mean a verify."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "verify_spans", "eval_sparse_polys")
