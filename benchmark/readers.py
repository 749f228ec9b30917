"""Helpers of the per-layer metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

B1_KERNELS = ("msm_windows_kernel", "msm_tree_kernel", "msm_horner_kernel")
B2_KERNELS = ("fold_evals_kernel",)


def mean_of(run, field: str, key: str | None = None):
    """Mean over the window's requests of ``request[field]`` (or of
    ``request[field][key]``); None where no request has it."""
    vals = []
    for r in run.requests:
        v = r.get(field)
        if key is not None and v is not None:
            v = v.get(key)
        if v is not None:
            vals.append(v)
    return sum(vals) / len(vals) if vals else None


def kernel_s(run, names) -> float:
    """Device seconds, within the prove calls, of the kernels whose name
    holds one of ``names``."""
    return run.trace.kernel_s("bench::prove",
                              lambda n: any(k in n for k in names))


def roofline(run, least_s: float, names):
    """The least time's share of the kernels' device time, in percent;
    None where the trace holds none of them."""
    if run.trace is None:
        return None
    spent = kernel_s(run, names)
    if spent <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / spent


def idle_share(run, rng: str):
    """The share of the ranges ``rng`` in which no kernel, copy or set
    ran on the card, in percent; None where the trace holds no device
    activity or no such range."""
    if run.trace is None or not len(run.trace.dev):
        return None
    span = run.trace.span_s(rng)
    if span <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(rng) / span)
