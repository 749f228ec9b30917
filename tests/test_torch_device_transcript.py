"""The port's device transcript and device point encoding
(``spartan_tpu_torch/transcript/device.py``, ``curve/ristretto.py``) on
the CPU, through their plain versions, against the host merlin
transcript, python-int oracles and the JAX package.

* The plain keccak-f[1600] against ``core/keccak.py`` on 32 random
  states and against JAX ``keccak_f1600_device`` on one (its output
  recorded in ``tests/golden/port/transcript-keccak.npz``).
* ``DeviceTranscript`` against ``core.merlin.Transcript``: one script of
  every operation (a scalar vector long enough to cross the 166-byte
  rate included) gives equal challenges and an equal final state;
  ``from_host``/``to_host`` round-trip with the native and the Python
  strobe.
* The plain ``compress`` against ``core/ristretto.encode`` on random
  points, the identity and points of each branch (``rotate`` and the
  negative-``y`` fix), and against JAX ``curve/ristretto.compress`` on
  four points (recorded in ``tests/golden/port/transcript-compress.npz``).
* The new field helpers against python ints, and kernel B2's plain
  version with a device-form challenge equal to the int form.
"""

import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from golden.port.record import load
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch import interop
from spartan_tpu_torch.core import edwards as hed
from spartan_tpu_torch.core import field as F
from spartan_tpu_torch.core import merlin, strobe
from spartan_tpu_torch.core import ristretto as hri
from spartan_tpu_torch.core.field import P25519 as P
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.keccak import keccak_f1600_bytes
from spartan_tpu_torch.curve import edwards as ed
from spartan_tpu_torch.curve import ristretto as dri
from spartan_tpu_torch.ff import fp25519 as fp
from spartan_tpu_torch.ff import fq
from spartan_tpu_torch.ff import round_kernel as rk
from spartan_tpu_torch.transcript import device as dt


def _host_permute(state: bytes) -> bytes:
    st = bytearray(state)
    keccak_f1600_bytes(st)
    return bytes(st)


@pytest.mark.parametrize("seed", range(4))
def test_keccak_plain_against_host(seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 256, (8, 200), dtype=np.uint8)
    got = dt.permute_bytes_plain(torch.from_numpy(states)).numpy()
    for s, g in zip(states, got):
        assert g.tobytes() == _host_permute(s.tobytes())


def _keccak_lanes():
    """One random state as (25,) uint32 low and high lane halves
    (``record.py`` reads it too)."""
    rng = np.random.default_rng(7)
    lanes = rng.integers(0, 1 << 63, 25, dtype=np.uint64)
    lo = (lanes & 0xFFFFFFFF).astype(np.uint32)
    hi = (lanes >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def test_keccak_plain_against_jax():
    lo, hi = _keccak_lanes()
    jax_keccak = load("transcript-keccak")
    jlo, jhi = jax_keccak["lo"], jax_keccak["hi"]
    plo, phi = dt.keccak_f1600_plain(torch.from_numpy(lo.astype(np.int64)),
                                     torch.from_numpy(hi.astype(np.int64)))
    assert plo.tolist() == np.asarray(jlo).astype(np.int64).tolist()
    assert phi.tolist() == np.asarray(jhi).astype(np.int64).tolist()


def test_strobe_step_plain():
    rng = np.random.default_rng(3)
    state = rng.integers(0, 256, 200, dtype=np.uint8)
    mask = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    seg = rng.integers(0, 256, 40, dtype=np.uint8)
    want = bytearray(a ^ b for a, b in zip(state.tobytes(), mask))
    for i, b in enumerate(seg.tobytes()):
        want[30 + i] ^= b
    st = torch.from_numpy(state.copy())
    dt.strobe_step(st, mask, [(torch.from_numpy(seg), 30)], False)
    assert st.numpy().tobytes() == bytes(want)
    dt.strobe_step(st, None, [], True)
    assert st.numpy().tobytes() == _host_permute(bytes(want))


@pytest.mark.parametrize("spans", [[(30, 8), (37, 4)], [(0, 200), (199, 1)],
                                   [(64, 32), (8, 8), (70, 1)]])
def test_strobe_step_rejects_overlapping_segments(spans):
    """K3's contract: no two segments of a step share a byte (the kernel
    XORs them in with no sync between segments).  ``strobe_step`` raises
    on overlapping segments, whatever their order, and takes adjacent
    ones."""
    state = torch.zeros(200, dtype=torch.uint8)
    segs = [(torch.ones(n, dtype=torch.uint8), off) for off, n in spans]
    with pytest.raises(ValueError, match="overlap"):
        dt.strobe_step(state, None, segs, False)
    assert not state.any()
    adjacent = [(torch.ones(8, dtype=torch.uint8), off) for off in (0, 8)]
    dt.strobe_step(state, None, adjacent, False)
    assert state[:16].tolist() == [1] * 16


def _ints(t):
    return fq.decode_to_ints(t.reshape(-1, 8))


def _script(host, dev, rng):
    """Every transcript operation, on both; returns (host, device)
    challenges."""
    xs = [rng.randrange(Q) for _ in range(12)]  # 12 x 32 B crosses 166 B
    pt = bytes(rng.randrange(256) for _ in range(32))
    pt_dev = torch.tensor(list(pt), dtype=torch.uint8)
    out_h, out_d = [], []
    host.append_protocol_name(b"device transcript test")
    dev.append_protocol_name(b"device transcript test")
    host.append_u64(b"n", 2 ** 40 + 3)
    dev.append_u64(b"n", 2 ** 40 + 3)
    host.append_message(b"msg", b"a message of some length" * 3)
    dev.append_message(b"msg", b"a message of some length" * 3)
    host.append_scalar(b"s", xs[0])
    dev.append_scalar(b"s", fq.mont_limbs(xs[0]))
    host.append_point(b"p", pt)
    dev.append_point(b"p", pt_dev)
    out_h.append(host.challenge_scalar(b"c0"))
    out_d += _ints(dev.challenge_scalar(b"c0"))
    host.append_scalar_vector(b"a", xs)
    dev.append_scalar_vector(b"a", fq.encode_ints(xs))
    host.append_scalar_vector(b"short", xs[:3])
    dev.append_scalar_vector(b"short", fq.encode_ints(xs[:3]))
    out_h += host.challenge_vector(b"v", 3)
    out_d += [_ints(c)[0] for c in dev.challenge_vector(b"v", 3)]
    out_h.append(host.challenge_bytes(b"b", 200))
    out_d.append(dev.challenge_bytes(b"b", 200).numpy().tobytes())
    return out_h, out_d


def _host_transcript(kind, monkeypatch, label=b"t"):
    if kind == "python":
        monkeypatch.setattr(merlin, "make_strobe", strobe.Strobe128)
    t = merlin.Transcript(label)
    assert hasattr(t.strobe, "buf") == (kind == "native")
    return t


@pytest.mark.parametrize("kind", ["native", "python"])
def test_device_transcript_against_host(kind, monkeypatch):
    from spartan_tpu_torch import native

    if kind == "native" and not native.available():
        pytest.skip("the native host library did not build here")
    host = _host_transcript(kind, monkeypatch)
    dev = dt.DeviceTranscript(b"t", device="cpu")
    assert dt.DeviceTranscript.host_state(host)[0] == \
        dev.state_words().numpy().tobytes()
    out_h, out_d = _script(host, dev, random.Random(5))
    assert out_h == out_d
    assert dt.DeviceTranscript.host_state(host) == (
        dev.state_words().numpy().tobytes(), dev.pos, dev.pos_begin,
        dev.cur_flags)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_from_host_to_host_round_trip(kind, monkeypatch):
    from spartan_tpu_torch import native

    if kind == "native" and not native.available():
        pytest.skip("the native host library did not build here")
    host = _host_transcript(kind, monkeypatch)
    host.append_message(b"m", b"before")
    dev = dt.DeviceTranscript.from_host(host, device="cpu")
    state, meta = dev.pack()
    dev = dt.DeviceTranscript.unpack(state, meta)
    ref = _host_transcript(kind, monkeypatch)
    ref.append_message(b"m", b"before")
    out_h, out_d = _script(ref, dev, random.Random(9))
    assert out_h == out_d
    back = _host_transcript(kind, monkeypatch, b"other")
    dev.to_host(back)
    assert (back.challenge_scalar(b"after")
            == ref.challenge_scalar(b"after"))


def test_scalar_bytes_on_device():
    rng = random.Random(2)
    xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(5)]
    got = dt.scalar_to_bytes32(fq.encode_ints(xs)).numpy()
    assert [bytes(r) for r in got] == [F.to_bytes(x) for x in xs]
    wide = [bytes(rng.randrange(256) for _ in range(64)) for _ in range(6)]
    wide.append(b"\xff" * 64)
    b = torch.tensor([list(w) for w in wide], dtype=torch.uint8)
    assert _ints(dt.bytes64_to_scalar_mont(b)) == [
        F.from_bytes_wide(w, Q) for w in wide]


def test_fq_neg_square():
    rng = random.Random(4)
    xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(5)]
    a = fq.encode_ints(xs)
    assert _ints(fq.neg(a)) == [(-x) % Q for x in xs]
    assert _ints(fq.square(a)) == [x * x % Q for x in xs]


def test_fp_helpers():
    rng = random.Random(6)
    xs = [0, 1, P - 1, 2] + [rng.randrange(P) for _ in range(6)]
    a = fp.encode_ints(xs)
    assert fp.decode_to_ints(fp.square(a)) == [x * x % P for x in xs]
    assert fp.decode_to_ints(fp.neg(a)) == [(-x) % P for x in xs]
    assert fp.decode_to_ints(fp.pow_fixed(a, 2 ** 252 - 3)) == [
        pow(x, 2 ** 252 - 3, P) for x in xs]
    assert fp.is_negative(a).tolist() == [F.is_negative(x) for x in xs]
    assert fp.decode_to_ints(fp.ct_abs(a)) == [F.ct_abs(x) for x in xs]
    vs = [1, 0] + [rng.randrange(P) for _ in range(8)]
    ok, r = fp.sqrt_ratio_m1(a, fp.encode_ints(vs))
    want = [F.sqrt_ratio_m1(u, v) for u, v in zip(xs, vs)]
    assert ok.tolist() == [w[0] for w in want]
    assert fp.decode_to_ints(r) == [w[1] for w in want]


def _branches(pt):
    """(rotate, y flipped) of ENCODE at this representative."""
    X, Y, Z, T = pt.X, pt.Y, pt.Z, pt.T
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, inv = F.sqrt_ratio_m1(1, u1 * u2 * u2 % P)
    z_inv = inv * u1 % P * (inv * u2 % P) % P * T % P
    rotate = F.is_negative(T * z_inv % P)
    x = Y * F.SQRT_M1 % P if rotate else X
    return rotate, F.is_negative(x * z_inv % P)


def _points():
    """Random multiples of the basepoint with projective Z != 1, the
    identity, and at least one point of each (rotate, flip) branch."""
    rng = random.Random(8)
    pts, seen = [hed.Point.identity()], set()
    while len(pts) < 12 or len(seen) < 4:
        p = hed.BASEPOINT.mul(rng.randrange(1, Q)).add(hed.BASEPOINT)
        seen.add(_branches(p))
        pts.append(p)
    return pts


def test_compress_plain_against_host():
    pts = _points()
    s = dri.compress(ed.from_host(pts, "cpu"))
    assert [bytes(r) for r in s.view(torch.uint8).numpy()] == [
        hri.encode(p) for p in pts]


def test_compress_against_jax():
    port = ed.from_host(_points()[:4], "cpu")
    want = interop.fq_from_jax(load("transcript-compress")["s"])
    assert torch.equal(dri.compress(port), want)


@pytest.mark.parametrize("ntab", [2, 3, 4])
@pytest.mark.parametrize("mode", ["fold_evals", "fold"])
def test_fold_evals_device_r(ntab, mode):
    g = torch.Generator().manual_seed(ntab)
    shape = (3, 16) if ntab == 3 else (16,)
    tabs = [fq.encode_ints(torch.randint(0, 1 << 62, shape + (1,),
                                         generator=g).flatten().tolist())
            .reshape(*shape, 8) for _ in range(ntab)]
    r = (7 ** 77) % Q
    want_t, want_e = rk.fold_evals(tabs, r, mode)
    got_t, got_e = rk.fold_evals(tabs, fq.mont_limbs(r), mode)
    assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
    assert (got_e is None and want_e is None) or torch.equal(got_e, want_e)
