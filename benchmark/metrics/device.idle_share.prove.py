"""The share of the prove calls' time in which no kernel, copy or set
ran on the card (``torch.profiler``), in percent.  The traced run's
spans synchronise the card at their ends, which adds idle time at each
span boundary."""


def read(run):
    if run.trace is None or not len(run.trace.dev):
        return None
    span = run.trace.span_s("bench::prove")
    if span <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s("bench::prove") / span)
