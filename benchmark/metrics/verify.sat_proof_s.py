"""Span ``verify_sat_proof`` (the SNARK verifier's check of the R1CS
proof, ``api.py::SNARK.verify`` -> ``r1cs/proof.py``), mean a verify."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "verify_spans", "verify_sat_proof")
