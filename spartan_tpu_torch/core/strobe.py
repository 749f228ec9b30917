"""STROBE-128 duplex construction, restricted to the subset merlin uses
(meta-AD / AD / PRF / KEY).  Byte-compatible with the `strobe-rs`-derived
mini-STROBE embedded in the merlin crate, which the reference links
against (reference Cargo.toml -> merlin; src/transcript.rs).
"""

from __future__ import annotations

from .keccak import keccak_f1600_bytes

# STROBE-128 sponge rate (merlin strobe.rs: STROBE_R = 166).
STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class _Strobe128Native:
    """ctypes shim over the C++ STROBE (native/host_crypto.cpp); the
    203-byte state buffer (200-byte sponge + pos/pos_begin/flags) lives
    in Python so transcripts stay copyable."""

    __slots__ = ("buf",)

    def __init__(self, protocol_label: bytes):
        import ctypes

        from .. import native

        self.buf = bytearray(203)
        cbuf = (ctypes.c_char * 203).from_buffer(self.buf)
        native.get_lib().spartan_strobe_init(
            cbuf, protocol_label, len(protocol_label))

    def _op(self, name: str, data: bytes, more: bool) -> None:
        import ctypes

        from .. import native

        cbuf = (ctypes.c_char * 203).from_buffer(self.buf)
        getattr(native.get_lib(), name)(
            cbuf, bytes(data), len(data), 1 if more else 0)

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._op("spartan_strobe_meta_ad", data, more)

    def ad(self, data: bytes, more: bool) -> None:
        self._op("spartan_strobe_ad", data, more)

    def key(self, data: bytes, more: bool) -> None:
        self._op("spartan_strobe_key", data, more)

    def prf(self, n: int, more: bool) -> bytes:
        import ctypes

        from .. import native

        cbuf = (ctypes.c_char * 203).from_buffer(self.buf)
        out = ctypes.create_string_buffer(n)
        native.get_lib().spartan_strobe_prf(cbuf, out, n, 1 if more else 0)
        return out.raw


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals ---------------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "flag mismatch on more=True"
            return
        assert flags & FLAG_T == 0, "transport flags unsupported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        # Force a flush if C or K requested and the sponge isn't fresh.
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    # -- public (merlin subset) --------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


def make_strobe(protocol_label: bytes):
    """Factory: native STROBE when the C++ library is available, else the
    pure-Python sponge above (byte-identical output either way)."""
    from .. import native

    if native.available():
        return _Strobe128Native(protocol_label)
    return Strobe128(protocol_label)
