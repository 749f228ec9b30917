"""Blocking device-to-host fetches a proof (``utils/rt.py``'s
``fetches``), mean a proof."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "prove_fetches")
