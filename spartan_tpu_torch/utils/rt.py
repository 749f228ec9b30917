"""Host<->device round-trip counters.

Every blocking device->host fetch on the prover path funnels through
``ff.fq.decode_to_ints`` (round evals, final claims, evaluations), so
the fetches per phase and the time the host stalled on them are
measured there.  ``utils.timer.Timer`` prints the per-phase delta when
profiling is on
(SPARTAN_TPU_PROFILE=1); otherwise the cost is two float adds per
fetch.
"""

from __future__ import annotations

fetches: int = 0
stall_s: float = 0.0


def record(dt: float) -> None:
    """One blocking fetch took ``dt`` seconds (dispatch + queued device
    work + transfer — the full stall the host round loop experienced)."""
    global fetches, stall_s
    fetches += 1
    stall_s += dt


def snapshot() -> tuple[int, float]:
    return fetches, stall_s
