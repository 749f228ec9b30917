"""Univariate round polynomials (degree 2/3) — host side.

These are 3-4 scalars per sumcheck round; interpolation from
evaluations at {0,1,2,3} mirrors reference unipoly.rs:22-110, with the
same compressed wire form (linear term dropped, recovered from the
round claim via G(0)+G(1)=e).
"""

from __future__ import annotations

from ..core.field import Q

_INV2 = pow(2, -1, Q)
_INV6 = pow(6, -1, Q)


class UniPoly:
    """Coefficients low-to-high: [c, b, a] or [d, c, b, a]."""

    def __init__(self, coeffs: list[int]):
        self.coeffs = [c % Q for c in coeffs]

    @staticmethod
    def from_evals(evals: list[int]) -> "UniPoly":
        assert len(evals) in (3, 4)
        if len(evals) == 3:
            e0, e1, e2 = (e % Q for e in evals)
            c = e0
            a = _INV2 * (e2 - 2 * e1 + c) % Q
            b = (e1 - c - a) % Q
            return UniPoly([c, b, a])
        e0, e1, e2, e3 = (e % Q for e in evals)
        d = e0
        a = _INV6 * (e3 - 3 * e2 + 3 * e1 - e0) % Q
        b = _INV2 * (2 * e0 - 5 * e1 + 4 * e2 - e3) % Q
        c = (e1 - d - a - b) % Q
        return UniPoly([d, c, b, a])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % Q

    def evaluate(self, r: int) -> int:
        acc, power = self.coeffs[0], r % Q
        for c in self.coeffs[1:]:
            acc = (acc + power * c) % Q
            power = power * r % Q
        return acc

    def compress(self) -> list[int]:
        """Drop the linear term (unipoly.rs:92-98)."""
        return [self.coeffs[0]] + self.coeffs[2:]

    @staticmethod
    def decompress(compressed: list[int], hint: int) -> "UniPoly":
        """unipoly.rs:98-110: linear = hint - 2*const - higher terms."""
        linear = (hint - 2 * compressed[0] - sum(compressed[1:])) % Q
        return UniPoly([compressed[0], linear] + list(compressed[1:]))

    def append_to_transcript(self, label: bytes, transcript) -> None:
        """unipoly.rs:113-121 wire order."""
        transcript.append_message(label, b"UniPoly_begin")
        for c in self.coeffs:
            transcript.append_scalar(b"coeff", c)
        transcript.append_message(label, b"UniPoly_end")
