"""Hierarchical profiling timers (reference src/timer.rs): nested,
colored-less, enabled via SPARTAN_TPU_PROFILE=1 (the analogue of the
reference's `profile` cargo feature); no-ops otherwise.

Under profiling, ``stop`` first waits for queued CUDA work, so a phase's
time includes its device work; without it nothing synchronises.  The
last elapsed time of each label is kept in ``records`` either way, and
the sum over its spans in ``totals`` (for spans that repeat within a
phase; a caller clears it where its count starts)."""

from __future__ import annotations

import os
import time

_ENABLED = os.environ.get("SPARTAN_TPU_PROFILE", "0") not in ("", "0")
_DEPTH = 0

records: dict[str, float] = {}
totals: dict[str, float] = {}


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    def __init__(self, label: str):
        global _DEPTH
        self.label = label
        if _ENABLED:
            from . import rt

            _sync()
            self._rt0 = rt.snapshot()
            print(f"{'  ' * _DEPTH}* {label}")
            _DEPTH += 1
        self.start = time.perf_counter()

    def stop(self) -> float:
        global _DEPTH
        if _ENABLED:
            _sync()
        elapsed = time.perf_counter() - self.start
        records[self.label] = elapsed
        totals[self.label] = totals.get(self.label, 0.0) + elapsed
        if _ENABLED:
            from . import rt

            _DEPTH -= 1
            f1, s1 = rt.snapshot()
            df, ds = f1 - self._rt0[0], s1 - self._rt0[1]
            extra = (f"  [{df} fetch{'es' if df != 1 else ''}, "
                     f"{ds:.3f}s stalled]") if df else ""
            print(f"{'  ' * _DEPTH}* {self.label} "
                  f"{elapsed * 1000:.3f}ms{extra}")
        return elapsed

    @staticmethod
    def print_msg(msg: str) -> None:
        if _ENABLED:
            print(f"{'  ' * _DEPTH}* {msg}")
