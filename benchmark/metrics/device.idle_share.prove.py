"""The share of the prove calls' time in which no kernel, copy or set
ran on the card (``torch.profiler``), in percent.  The traced run's
spans synchronise the card at their ends, which adds idle time at each
span boundary."""
from benchmark.readers import idle_share


def read(run):
    return idle_share(run, "bench::prove")
