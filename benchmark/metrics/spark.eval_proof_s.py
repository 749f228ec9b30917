"""Span ``R1CSEvalProof::prove`` (Spark, ``r1cs/commit.py`` ->
``protocols/spark.py``), mean a proof."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "prove_spans", "R1CSEvalProof::prove")
