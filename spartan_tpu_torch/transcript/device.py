"""Device-resident merlin transcript (the JAX package's
``transcript/device.py``): the STROBE-128 sponge state lives on the
device, so a round on the device could absorb its commitments and
squeeze its challenge with no fetch.  No prover path uses it: the
port's prover keeps its transcript on the host (``core.merlin``), and
the JAX package's device-resident prover, its one user there, is not
ported.

Every label and length in Spartan's transcript schedule is known on the
host; only scalar and point values are data.  So ``pos``, ``pos_begin``
and ``cur_flags`` stay Python ints, and the state is a ``(200,)`` uint8
tensor.  Absorbs are lazy: the constant bytes of a block (labels,
lengths, op headers, STROBE's padding) gather in a 200-byte host mask,
the device bytes as (tensor, offset) segments, and one ``strobe_step``
applies them and permutes when the block is full or a squeeze needs it.
``strobe_step`` is kernel K3 (``csrc/keccak.cu``) on the card and
``strobe_step_plain`` on the CPU; the state is updated in place.
A squeeze copies its bytes out and zeroes them by XORing the copy back
in at the next step.

Byte-compatible with ``core.merlin.Transcript`` (same proofs, same
verifier); ``from_host``/``to_host`` move the state across to either
strobe form (native ``buf``, Python ``state``/``pos``/...).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..device import resolve
from ..ff import fq, limb
from ..utils import rt

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_M = 1 << 4
FLAG_K = 1 << 5

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"
MAX_SEGS = 16  # device segments a step takes (csrc/keccak.cu)

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT_XY = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
           [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
# combined rho + pi: output lane y + 5((2x + 3y) mod 5) is input lane
# x + 5y rotated left by _ROT_XY[x][y]
_SRC = [0] * 25
_ROTN = [0] * 25
for _x in range(5):
    for _y in range(5):
        _SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _ROTN[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT_XY[_x][_y]
_M32 = 0xFFFFFFFF


def _rol64(lo: torch.Tensor, hi: torch.Tensor, n: torch.Tensor):
    """Rotate 64-bit lanes held as 32-bit halves in int64 left by n
    (0..63, broadcast)."""
    swap = n >= 32
    lo_, hi_ = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    k = torch.where(swap, n - 32, n)
    # a half shifted right by 32 is 0, so k = 0 needs no special case
    new_lo = ((lo_ << k) & _M32) | (hi_ >> (32 - k))
    new_hi = ((hi_ << k) & _M32) | (lo_ >> (32 - k))
    return new_lo, new_hi


def keccak_f1600_plain(lo: torch.Tensor, hi: torch.Tensor):
    """keccak-f[1600] on (..., 25) lanes, lane = hi << 32 | lo, each half
    in an int64 (CPU torch has no shifts on uint32), as the JAX
    package's ``keccak_f1600_device`` holds them in two uint32 arrays."""
    dev = lo.device
    src = torch.tensor(_SRC, device=dev)
    rotn = torch.tensor(_ROTN, dtype=torch.int64, device=dev)
    one = torch.ones(5, dtype=torch.int64, device=dev)
    for rc in _RC:
        l5, h5 = lo.unflatten(-1, (5, 5)), hi.unflatten(-1, (5, 5))
        clo = l5[..., 0, :] ^ l5[..., 1, :] ^ l5[..., 2, :] ^ l5[..., 3, :] \
            ^ l5[..., 4, :]
        chi = h5[..., 0, :] ^ h5[..., 1, :] ^ h5[..., 2, :] ^ h5[..., 3, :] \
            ^ h5[..., 4, :]
        rlo, rhi = _rol64(clo.roll(-1, -1), chi.roll(-1, -1), one)
        dlo = clo.roll(1, -1) ^ rlo
        dhi = chi.roll(1, -1) ^ rhi
        lo = (l5 ^ dlo.unsqueeze(-2)).flatten(-2)
        hi = (h5 ^ dhi.unsqueeze(-2)).flatten(-2)
        blo, bhi = _rol64(lo[..., src], hi[..., src], rotn)
        b5l, b5h = blo.unflatten(-1, (5, 5)), bhi.unflatten(-1, (5, 5))
        lo = (b5l ^ (~b5l.roll(-1, -1) & b5l.roll(-2, -1))).flatten(-2)
        hi = (b5h ^ (~b5h.roll(-1, -1) & b5h.roll(-2, -1))).flatten(-2)
        lo = lo.clone()
        hi = hi.clone()
        lo[..., 0] ^= rc & _M32
        hi[..., 0] ^= rc >> 32
    return lo, hi


def permute_bytes_plain(state: torch.Tensor) -> torch.Tensor:
    """(..., 200) uint8 -> the permuted states (plain keccak)."""
    b = state.to(torch.int64).unflatten(-1, (25, 8))
    sh = torch.arange(0, 32, 8, device=state.device)
    lo = (b[..., :4] << sh).sum(-1)
    hi = (b[..., 4:] << sh).sum(-1)
    lo, hi = keccak_f1600_plain(lo, hi)
    out = torch.cat([(lo.unsqueeze(-1) >> sh) & 0xFF,
                     (hi.unsqueeze(-1) >> sh) & 0xFF], dim=-1)
    return out.flatten(-2).to(torch.uint8)


# ---------------------------------------------------------------------------
# Kernel K3: one STROBE step (absorb the pending bytes, permute)
# ---------------------------------------------------------------------------

class _Mask(ctypes.Structure):
    _fields_ = [("b", ctypes.c_uint8 * 200)]


class _Seg(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_int),
                ("len", ctypes.c_int)]


class _Segs(ctypes.Structure):
    _fields_ = [("s", _Seg * MAX_SEGS), ("n", ctypes.c_int)]


def _declare(lib) -> None:
    lib.strobe_step_launch.argtypes = [ctypes.c_void_p, _Mask, _Segs,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.strobe_step_launch.restype = ctypes.c_int


def strobe_step_plain(state: torch.Tensor, mask: bytes | None,
                      segs: list, permute: bool) -> None:
    """The plain PyTorch version of kernel K3, in place on ``state``
    ((200,) uint8, or a batch (..., 200) given the same bytes): XOR
    ``mask`` (200 host bytes) and each (bytes, offset) of ``segs``, then
    permute if ``permute``.  Its calls on CUDA tensors are counted in
    ``cuda_calls``: the main path makes none."""
    if state.is_cuda:
        strobe_step_plain.cuda_calls += 1
    if mask is not None:
        state ^= torch.tensor(list(mask), dtype=torch.uint8,
                              device=state.device)
    for seg, off in segs:
        state[..., off:off + seg.shape[0]] ^= seg
    if permute:
        state.copy_(permute_bytes_plain(state))


strobe_step_plain.cuda_calls = 0


def _check_step(state, segs) -> None:
    if state.shape != (200,) or state.dtype != torch.uint8:
        raise ValueError(f"strobe_step: state must be (200,) uint8, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if len(segs) > MAX_SEGS:
        raise ValueError(f"strobe_step: at most {MAX_SEGS} segments")
    spans = []
    for seg, off in segs:
        end = off + seg.shape[0]
        if (seg.dim() != 1 or seg.dtype != torch.uint8
                or seg.device != state.device or not seg.is_contiguous()
                or off < 0 or end > 200):
            raise ValueError("strobe_step: segments must be contiguous "
                             "uint8 vectors inside the state, on its device")
        spans.append((off, end))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("strobe_step: segments must not overlap")


def strobe_step(state: torch.Tensor, mask: bytes | None, segs: list,
                permute: bool) -> None:
    """Kernel K3 on the card, its plain version on the CPU (in place)."""
    _check_step(state, segs)
    dev = state.device
    if dev.type == "cpu":
        return strobe_step_plain(state, mask, segs, permute)
    if dev.type != "cuda":
        raise ValueError(f"strobe_step: unsupported device {dev}")
    lib = _build.load("keccak", _declare)
    m = _Mask() if mask is None else _Mask.from_buffer_copy(mask)
    s = _Segs((_Seg * MAX_SEGS)(*[_Seg(seg.data_ptr(), off, seg.shape[0])
                                  for seg, off in segs]), len(segs))
    rc = lib.strobe_step_launch(state.data_ptr(), m, s, int(permute),
                                _build.stream_handle(dev))
    strobe_step.launches += 1
    _build.check(rc, "strobe_step")


strobe_step.launches = 0


# ---------------------------------------------------------------------------
# Scalars <-> bytes on the device
# ---------------------------------------------------------------------------

def scalar_to_bytes32(x_mont: torch.Tensor) -> torch.Tensor:
    """(..., 8) Montgomery scalars -> (..., 32) uint8 canonical
    little-endian bytes, on the device."""
    return fq.from_mont(x_mont).contiguous().view(torch.uint8)


def bytes64_to_scalar_mont(b: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 -> (..., 8) Montgomery form of int(b) mod q
    (from_bytes_wide, transcript.rs:26-30).  With b = lo + 2^256 hi,
    mont(lo, R^2) + mont(hi, R^3) = b R mod q."""
    w = b.to(torch.int64).unflatten(-1, (32, 2))
    w = (w[..., 0] | (w[..., 1] << 8)).unflatten(-1, (2, 16))  # lo, hi
    dev = b.device
    r23 = torch.stack([limb.const16(fq.R2_INT, dev),
                       limb.const16(fq.R3_INT, dev)])
    x = fq.mul16(w, r23)  # both products in one call
    return limb.pack(fq.add16(x[..., 0, :], x[..., 1, :]))


# ---------------------------------------------------------------------------
# The transcript
# ---------------------------------------------------------------------------

class DeviceTranscript:
    """merlin transcript with its sponge on the device.  The API mirrors
    ``core.merlin.Transcript``, but message payloads may be device byte
    tensors, scalars are ``(8,)`` Montgomery tensors and challenges come
    back as such."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags", "_mask", "_segs")

    def __init__(self, label: bytes | None, device=None, _state=None,
                 _pos: int = 0, _pos_begin: int = 0, _flags: int = 0):
        self._mask = bytearray(200)
        self._segs: list = []
        self.pos, self.pos_begin, self.cur_flags = _pos, _pos_begin, _flags
        if _state is not None:
            self.state = _state
            return
        self.state = torch.zeros(200, dtype=torch.uint8,
                                 device=resolve(device))
        self._mask[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        self._mask[6:18] = b"STROBEv1.0.2"
        self._flush(True)
        self._meta_ad(MERLIN_PROTOCOL_LABEL, False)
        self.append_message(b"dom-sep", label)

    # -- state across boundaries --------------------------------------

    def pack(self):
        self._flush(False)
        return self.state, (self.pos, self.pos_begin, self.cur_flags)

    @staticmethod
    def unpack(state, meta) -> "DeviceTranscript":
        pos, pos_begin, flags = meta
        return DeviceTranscript(None, _state=state, _pos=pos,
                                _pos_begin=pos_begin, _flags=flags)

    @staticmethod
    def host_state(t) -> tuple[bytes, int, int, int]:
        """(state, pos, pos_begin, cur_flags) of a host
        ``core.merlin.Transcript``, native or Python strobe."""
        s = t.strobe
        if hasattr(s, "buf"):  # native
            raw = bytes(s.buf)
            return raw[:200], raw[200], raw[201], raw[202]
        return bytes(s.state), s.pos, s.pos_begin, s.cur_flags

    @staticmethod
    def from_host(t, device=None) -> "DeviceTranscript":
        """A host ``core.merlin.Transcript`` lifted onto ``device`` (one
        upload)."""
        state, pos, pos_begin, flags = DeviceTranscript.host_state(t)
        arr = torch.tensor(list(state), dtype=torch.uint8,
                           device=resolve(device))
        return DeviceTranscript(None, _state=arr, _pos=pos,
                                _pos_begin=pos_begin, _flags=flags)

    def state_words(self) -> torch.Tensor:
        """The state as (50,) int32, pending bytes applied: to be fetched
        with other results and given to ``write_host``."""
        self._flush(False)
        return self.state.view(torch.int32)

    def write_host(self, t, state: bytes) -> None:
        """Write ``state`` (this transcript's 200 fetched bytes) and the
        positions into a host Transcript ``t``."""
        s = t.strobe
        if hasattr(s, "buf"):
            s.buf[:200] = state
            s.buf[200] = self.pos
            s.buf[201] = self.pos_begin
            s.buf[202] = self.cur_flags
        else:
            s.state = bytearray(state)
            s.pos = self.pos
            s.pos_begin = self.pos_begin
            s.cur_flags = self.cur_flags

    def to_host(self, t) -> None:
        """Write this transcript back into a host Transcript (one
        fetch)."""
        self.write_host(t, rt.fetch(self.state_words()).tobytes())

    # -- strobe internals (positions on the host, data on the device) ----

    def _flush(self, permute: bool) -> None:
        if not permute and not self._segs and not any(self._mask):
            return
        strobe_step(self.state, self._mask if any(self._mask) else None,
                    self._segs, permute)
        self._mask = bytearray(200)
        self._segs = []

    def _xor(self, off: int, data) -> None:
        if isinstance(data, (bytes, bytearray)):
            for i, byte in enumerate(data):
                self._mask[off + i] ^= byte
            return
        if len(self._segs) == MAX_SEGS:
            self._flush(False)
        self._segs.append((data, off))

    def _run_f(self) -> None:
        self._mask[self.pos] ^= self.pos_begin
        self._mask[self.pos + 1] ^= 0x04
        self._mask[STROBE_R + 1] ^= 0x80
        self._flush(True)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data) -> None:
        """data: host bytes or a (n,) uint8 device tensor."""
        n = len(data) if isinstance(data, (bytes, bytearray)) \
            else int(data.shape[0])
        i = 0
        while i < n:
            take = min(n - i, STROBE_R - self.pos)
            self._xor(self.pos, data[i:i + take])
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> torch.Tensor:
        self._flush(False)
        out = []
        got = 0
        while got < n:
            take = min(n - got, STROBE_R - self.pos)
            seg = self.state[self.pos:self.pos + take].clone()
            out.append(seg)
            self._xor(self.pos, seg)  # zeroes the squeezed bytes
            self.pos += take
            got += take
            if self.pos == STROBE_R:
                self._run_f()
        return torch.cat(out) if len(out) > 1 else out[0]

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    def _meta_ad(self, data, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def _ad(self, data, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def _prf(self, n: int, more: bool) -> torch.Tensor:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    # -- merlin + Spartan schedule (transcript.rs:5-63) ------------------

    def append_message(self, label: bytes, message) -> None:
        """message: host bytes or a (n,) uint8 device tensor."""
        mlen = len(message) if isinstance(message, (bytes, bytearray)) \
            else int(message.shape[0])
        self._meta_ad(label, False)
        self._meta_ad(mlen.to_bytes(4, "little"), True)
        self._ad(message, False)

    def append_protocol_name(self, name: bytes) -> None:
        self.append_message(b"protocol-name", name)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, x.to_bytes(8, "little"))

    def append_scalar(self, label: bytes, x_mont: torch.Tensor) -> None:
        """x_mont: (8,) Montgomery scalar on the device."""
        self.append_message(label, scalar_to_bytes32(x_mont))

    def append_point(self, label: bytes, point) -> None:
        """point: a compressed point, (32,) uint8 on the device or 32
        host bytes."""
        self.append_message(label, point)

    def append_scalar_vector(self, label: bytes, xs_mont: torch.Tensor
                             ) -> None:
        """(k, 8) Montgomery scalars ([Scalar]::append_to_transcript,
        transcript.rs:50-57); their bytes in one conversion."""
        rows = scalar_to_bytes32(xs_mont)
        self.append_message(label, b"begin_append_vector")
        for i in range(rows.shape[0]):
            self.append_message(label, rows[i])
        self.append_message(label, b"end_append_vector")

    def challenge_bytes(self, label: bytes, n: int) -> torch.Tensor:
        self._meta_ad(label, False)
        self._meta_ad(n.to_bytes(4, "little"), True)
        return self._prf(n, False)

    def challenge_scalar(self, label: bytes) -> torch.Tensor:
        """-> (8,) Montgomery form of the challenge."""
        return bytes64_to_scalar_mont(self.challenge_bytes(label, 64))

    def challenge_vector(self, label: bytes, n: int) -> list:
        return [self.challenge_scalar(label) for _ in range(n)]
