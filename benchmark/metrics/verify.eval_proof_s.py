"""Span ``verify_eval_proof`` (the SNARK verifier's check of Spark's
eval proof against the commitment, ``api.py::SNARK.verify`` ->
``r1cs/commit.py``), mean a verify."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "verify_spans", "verify_eval_proof")
