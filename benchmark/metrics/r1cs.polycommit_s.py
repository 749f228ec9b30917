"""Span ``polycommit`` (the witness commitment, ``r1cs/proof.py`` ->
``poly/commit.py``), mean a proof."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "prove_spans", "polycommit")
