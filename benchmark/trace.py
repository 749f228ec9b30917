"""Reduction of a ``torch.profiler`` trace, in memory, to what the
per-layer metrics and the result line read.

Device activity is every kernel, copy and set on the card, not the
annotations the profiler mirrors onto the device's timeline.  The
benchmark marks its own ranges on the host with ``record_function``:
``bench::window`` around the traced part of the window, and
``bench::<step>`` (``encode``, ``prove``, ``verify``) around each step
of a request."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

HOST_IDLE = "(no torch op: host Python)"


def _annotation(e) -> bool:
    """A range that the profiler mirrors onto the device's timeline."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of (start, end) rows."""
    iv = iv.reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    last = np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


def _overlap_each(iv: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """For each row of ``iv``, its overlap with the disjoint ``ranges``."""
    out = np.zeros(len(iv), dtype=np.int64)
    for lo, hi in ranges:
        out += np.clip(np.minimum(iv[:, 1], hi) - np.maximum(iv[:, 0], lo),
                       0, None)
    return out


class Trace:
    def __init__(self, events):
        dev, dev_id, names = [], [], {}
        cpu, cpu_names, ranges = [], [], defaultdict(list)
        for e in events:
            name = e.name()
            s = e.start_ns()
            iv = (s, s + e.duration_ns())
            if str(e.device_type()).endswith("CPU"):
                if name.startswith("bench::"):
                    ranges[name].append(iv)
                else:
                    cpu.append(iv)
                    cpu_names.append(name)
                continue
            if name.startswith("bench::") or _annotation(e):
                continue
            dev.append(iv)
            dev_id.append(names.setdefault(name, len(names)))
        self.names = list(names)
        self.dev = np.array(dev, dtype=np.int64).reshape(-1, 2)
        self.dev_id = np.array(dev_id, dtype=np.int64)
        self.dev_union = _union(self.dev)
        cpu = np.array(cpu, dtype=np.int64).reshape(-1, 2)
        order = np.argsort(cpu[:, 0], kind="stable")
        self.cpu = cpu[order]
        self.cpu_names = [cpu_names[i] for i in order]
        self.ranges = {k: _union(np.array(v, dtype=np.int64))
                       for k, v in ranges.items()}

    def _range(self, rng: str) -> np.ndarray:
        return self.ranges.get(rng, np.zeros((0, 2), dtype=np.int64))

    def span_s(self, rng: str) -> float:
        r = self._range(rng)
        return float((r[:, 1] - r[:, 0]).sum()) / 1e9

    def busy_s(self, rng: str) -> float:
        """Seconds within the ranges ``rng`` in which the card ran
        anything."""
        return float(_overlap_each(self.dev_union,
                                   self._range(rng)).sum()) / 1e9

    def device_s_by_name(self, rng: str) -> dict:
        """Device seconds by kernel name within the ranges ``rng``."""
        ov = _overlap_each(self.dev, self._range(rng))
        tot = np.bincount(self.dev_id, weights=ov, minlength=len(self.names))
        return {n: float(t) / 1e9 for n, t in zip(self.names, tot) if t}

    def kernel_s(self, rng: str, match) -> float:
        return sum(s for n, s in self.device_s_by_name(rng).items()
                   if match(n))

    def top_device_ops(self, rng: str, k: int = 10) -> list:
        top = sorted(self.device_s_by_name(rng).items(),
                     key=lambda kv: -kv[1])[:k]
        return [[n[:200], s] for n, s in top]

    def idle_by_host(self, rng: str, k: int = 10) -> list:
        """The card's idle seconds within the ranges ``rng``, summed by
        what the host was doing in the middle of each gap: the innermost
        torch op then running, or none."""
        gaps = []
        for lo, hi in self._range(rng):
            busy = self.dev_union[(self.dev_union[:, 1] > lo)
                                  & (self.dev_union[:, 0] < hi)]
            edges = np.r_[lo, np.clip(busy, lo, hi).reshape(-1), hi]
            a, b = edges[0::2], edges[1::2]
            keep = b > a
            gaps.append(np.stack([a[keep], b[keep]], axis=1))
        if not gaps:
            return []
        gaps = np.concatenate(gaps)
        starts, ends = self.cpu[:, 0].tolist(), self.cpu[:, 1].tolist()
        parent = [-1] * len(starts)
        stack = []
        for i in range(len(starts)):
            while stack and ends[stack[-1]] <= starts[i]:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
            stack.append(i)
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        idx = np.searchsorted(self.cpu[:, 0], mids, side="right") - 1
        by = defaultdict(int)
        for (a, b), m, j in zip(gaps.tolist(), mids.tolist(), idx.tolist()):
            while j >= 0 and ends[j] < m:
                j = parent[j]
            by[HOST_IDLE if j < 0 else self.cpu_names[j]] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], v / 1e9] for n, v in top]
