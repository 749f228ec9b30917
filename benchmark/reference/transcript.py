"""Merlin transcript (STROBE-128 over Keccak-f[1600]) in plain Python,
with Spartan's label schedule (``transcript.rs``): byte for byte what the
merlin crate computes."""

from __future__ import annotations

import struct

from .field import Q

_MASK = (1 << 64) - 1
_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# rotation offsets r[x][y], lane (x, y) at index x + 5 y
_ROT = ((0, 36, 3, 41, 18), (1, 44, 10, 45, 2), (62, 6, 43, 15, 61),
        (28, 55, 25, 21, 56), (27, 20, 39, 8, 14))


def _unrolled_source() -> str:
    """Keccak-f[1600] with every lane a local: one round's theta, rho,
    pi, chi written out, in a loop over the 24 round constants."""
    ind = "        "
    out = ["def keccak_f(lanes):",
           "    (" + ", ".join(f"a{i}" for i in range(25)) + ",) = lanes",
           "    for rc in RC:"]
    for x in range(5):
        out.append(ind + f"c{x} = a{x} ^ a{x + 5} ^ a{x + 10} ^ a{x + 15} "
                   f"^ a{x + 20}")
    for x in range(5):
        lo, hi = (x - 1) % 5, (x + 1) % 5
        out.append(ind + f"d{x} = c{lo} ^ (((c{hi} << 1) | (c{hi} >> 63)) "
                   "& M)")
    for x in range(5):
        for y in range(5):
            out.append(ind + f"a{x + 5 * y} ^= d{x}")
    for x in range(5):
        for y in range(5):
            r, dst = _ROT[x][y], y + 5 * ((2 * x + 3 * y) % 5)
            src = f"a{x + 5 * y}"
            out.append(ind + (f"b{dst} = {src}" if r == 0 else
                              f"b{dst} = (({src} << {r}) | ({src} >> "
                              f"{64 - r})) & M"))
    for y in range(5):
        for x in range(5):
            i, j, k = x + 5 * y, (x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y
            out.append(ind + f"a{i} = b{i} ^ (~b{j} & b{k})")
    out.append(ind + "a0 ^= rc")
    out.append("    return (" + ", ".join(f"a{i}" for i in range(25)) + ")")
    return "\n".join(out)


_KECCAK = None


def keccak_f(lanes: tuple) -> tuple:
    """The permutation on 25 64-bit lanes (lane x + 5 y)."""
    global _KECCAK
    if _KECCAK is None:
        scope = {"RC": _RC, "M": _MASK}
        exec(compile(_unrolled_source(), "<keccak_f>", "exec"), scope)
        _KECCAK = scope["keccak_f"]
    return _KECCAK(lanes)


_R = 166  # STROBE-128 rate as merlin sets it
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_M = 1, 2, 4, 16


class Strobe:
    """The subset of STROBE-128 that merlin uses (meta-AD, AD, PRF)."""

    __slots__ = ("st", "pos", "pos_begin", "flags")

    def __init__(self, label: bytes | None):
        if label is None:
            return
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.st = st
        self._permute()
        self.pos = self.pos_begin = self.flags = 0
        self.meta_ad(label, False)

    @staticmethod
    def from_state(st: bytes, pos: int, pos_begin: int,
                   flags: int) -> "Strobe":
        s = Strobe(None)
        s.st, s.pos, s.pos_begin, s.flags = bytearray(st), pos, pos_begin, \
            flags
        return s

    def copy(self) -> "Strobe":
        return Strobe.from_state(self.st, self.pos, self.pos_begin,
                                 self.flags)

    def _permute(self) -> None:
        lanes = keccak_f(struct.unpack("<25Q", self.st))
        self.st[:] = struct.pack("<25Q", *lanes)

    def _run_f(self) -> None:
        self.st[self.pos] ^= self.pos_begin
        self.st[self.pos + 1] ^= 0x04
        self.st[_R + 1] ^= 0x80
        self._permute()
        self.pos = self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        i, n = 0, len(data)
        while i < n:
            k = min(_R - self.pos, n - i)
            a = int.from_bytes(self.st[self.pos:self.pos + k], "little")
            b = int.from_bytes(data[i:i + k], "little")
            self.st[self.pos:self.pos + k] = (a ^ b).to_bytes(k, "little")
            self.pos += k
            i += k
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            k = min(_R - self.pos, n - len(out))
            out += self.st[self.pos:self.pos + k]
            self.st[self.pos:self.pos + k] = bytes(k)
            self.pos += k
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin(self, flags: int, more: bool) -> None:
        if more:
            if self.flags != flags:
                raise ValueError("STROBE: continued op with other flags")
            return
        old = self.pos_begin
        self.pos_begin = self.pos + 1
        self.flags = flags
        self._absorb(bytes([old, flags]))
        if flags & _FLAG_C and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._begin(_FLAG_I | _FLAG_A | _FLAG_C, False)
        return self._squeeze(n)


class Transcript:
    """merlin::Transcript with Spartan's ProofTranscript methods."""

    __slots__ = ("s",)

    def __init__(self, label: bytes | None, strobe: Strobe | None = None):
        if strobe is not None:
            self.s = strobe
            return
        self.s = Strobe(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def copy(self) -> "Transcript":
        return Transcript(None, self.s.copy())

    def append_message(self, label: bytes, msg: bytes) -> None:
        self.s.meta_ad(label, False)
        self.s.meta_ad(struct.pack("<I", len(msg)), True)
        self.s.ad(msg, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    def append_protocol_name(self, name: bytes) -> None:
        self.append_message(b"protocol-name", name)

    def append_scalar(self, label: bytes, x: int) -> None:
        self.append_message(label, (x % Q).to_bytes(32, "little"))

    def append_scalars(self, label: bytes, xs) -> None:
        self.append_message(label, b"begin_append_vector")
        for x in xs:
            self.append_scalar(label, x)
        self.append_message(label, b"end_append_vector")

    def append_point(self, label: bytes, enc: bytes) -> None:
        if len(enc) != 32:
            raise ValueError("a compressed point has 32 bytes")
        self.append_message(label, enc)

    def challenge_scalar(self, label: bytes) -> int:
        self.s.meta_ad(label, False)
        self.s.meta_ad(struct.pack("<I", 64), True)
        return int.from_bytes(self.s.prf(64), "little") % Q

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        return [self.challenge_scalar(label) for _ in range(n)]


def random_tape_scalars(seed: int, label: bytes, n: int) -> list[int]:
    """The first ``n`` draws under ``label`` of the prover's random tape
    (``random.rs``): a transcript ``b"proof"`` seeded with one scalar."""
    t = Transcript(b"proof")
    t.append_scalar(b"init_randomness", seed % Q)
    return t.challenge_vector(label, n)
