"""Span ``prove_sc_phase_one`` (``r1cs/proof.py``), mean a proof."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "prove_spans", "prove_sc_phase_one")
