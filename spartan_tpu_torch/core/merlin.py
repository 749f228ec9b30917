"""merlin transcript (Fiat-Shamir), byte-compatible with the merlin crate
the reference uses (src/transcript.rs), plus the Spartan-specific helper
schedule (append_scalar / append_point / challenge_scalar /
challenge_vector with the exact label protocol of transcript.rs:5-63).
"""

from __future__ import annotations

import os
import struct

from .field import Q, from_bytes_wide, to_bytes
from .strobe import make_strobe

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    """merlin::Transcript."""

    def __init__(self, label: bytes):
        self.strobe = make_strobe(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)

    # ------------------------------------------------------------------
    # Spartan's ProofTranscript extension (reference transcript.rs:5-37)
    # ------------------------------------------------------------------

    def append_protocol_name(self, protocol_name: bytes) -> None:
        self.append_message(b"protocol-name", protocol_name)

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.append_message(label, to_bytes(scalar % Q))

    def append_point(self, label: bytes, point_bytes: bytes) -> None:
        assert len(point_bytes) == 32
        self.append_message(label, point_bytes)

    def append_scalar_vector(self, label: bytes, scalars) -> None:
        """[Scalar]::append_to_transcript (transcript.rs:50-57)."""
        self.append_message(label, b"begin_append_vector")
        for s in scalars:
            self.append_scalar(label, int(s))
        self.append_message(label, b"end_append_vector")

    def challenge_scalar(self, label: bytes) -> int:
        return from_bytes_wide(self.challenge_bytes(label, 64), Q)

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        return [self.challenge_scalar(label) for _ in range(n)]


class RandomTape:
    """Prover-private randomness tape (reference src/random.rs:6-28):
    a merlin transcript seeded with one random scalar; all blinds are
    challenge_scalar draws from it."""

    def __init__(self, name: bytes, seed: int | None = None):
        self.tape = Transcript(name)
        if seed is None:
            seed = from_bytes_wide(os.urandom(64), Q)
        self.tape.append_scalar(b"init_randomness", seed % Q)

    def random_scalar(self, label: bytes) -> int:
        return self.tape.challenge_scalar(label)

    def random_vector(self, label: bytes, n: int) -> list[int]:
        return self.tape.challenge_vector(label, n)
