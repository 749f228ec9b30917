"""Host<->device round-trip counters.

Every blocking device->host fetch on the prover path funnels through
``ff.fq.decode_to_ints`` (round evals, final claims, evaluations) or
``fetch`` (the bullet rounds' packed results, the encoding of Cx), so
the fetches per phase and the time the host stalled on them are
measured there.  ``utils.timer.Timer`` prints the per-phase delta when
profiling is on
(SPARTAN_TPU_PROFILE=1); otherwise the cost is two float adds per
fetch.

``encoded`` counts the field elements that ``ff.fq.encode_ints``
Montgomery-maps on the host (python ints, one at a time): short vectors
and scalars only, where a long table goes up canonical and is mapped on
its device.
"""

from __future__ import annotations

import time

fetches: int = 0
stall_s: float = 0.0
encoded: int = 0


def record(dt: float) -> None:
    """One blocking fetch took ``dt`` seconds (dispatch + queued device
    work + transfer — the full stall the host round loop experienced)."""
    global fetches, stall_s
    fetches += 1
    stall_s += dt


def count_encoded(n: int) -> None:
    """``n`` more field elements Montgomery-mapped on the host."""
    global encoded
    encoded += n


def snapshot() -> tuple[int, float]:
    return fetches, stall_s


def fetch(t):
    """``t`` copied to the host as a numpy array: one blocking fetch,
    counted and timed like ``ff.fq.decode_to_ints``'s (the device
    prover's one fetch a phase)."""
    t0 = time.perf_counter()
    out = t.detach().cpu().numpy()
    record(time.perf_counter() - t0)
    return out
