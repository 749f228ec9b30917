"""ristretto255 encoding of device point batches (RFC 9496 ENCODE).

Compression runs on the host through the native batch encoder: the
canonical coordinates come off the device as X|Y|Z|T 32-byte blobs,
which is the native library's point layout.  Without the native library
each point is encoded by the Python core.
"""

from __future__ import annotations

import ctypes

from .. import native
from ..core import edwards as host_ed
from ..core import ristretto as host_ri
from .edwards import PointArray, stack


def compress_to_bytes(p: PointArray) -> list[bytes]:
    """Batch ENCODE: PointArray (...,) with canonical coordinates ->
    list of 32-byte encodings (flattened batch order)."""
    s = stack(p).reshape(-1, 4, 8).cpu()
    n = s.shape[0]
    blobs = s.numpy().astype("<i4").tobytes()
    lib = native.get_lib()
    if lib is not None:
        out = ctypes.create_string_buffer(32 * n)
        lib.spartan_ristretto_encode_batch(blobs, n, out)
        raw = out.raw
        return [raw[32 * i:32 * i + 32] for i in range(n)]
    return [host_ri.encode(host_ed.Point._from_blob(blobs[128 * i:128 * i + 128]))
            for i in range(n)]

