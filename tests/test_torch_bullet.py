"""The bullet reduction's device rounds and the device dot-product-log
of the port, on the CPU through the kernels' plain versions.

* Kernel K6's plain version (``ff/bullet_kernel.py``) in each mode
  against python ints: the cross products and scalar rows, the fold by
  u (given as Montgomery words and as 64 challenge bytes) with u^-1 and
  blind_fin, the head's r and blind_Gamma, the tail's z1 and z2.
* ``BulletReductionProof.prove`` with every round on the device
  (``DEVICE_MIN`` of the CPU set to 1) against the JAX package's
  ``BulletReductionProof.prove`` on its host path at n = 8 and 16, with
  the same transcript and blinds: equal ``L_vec``, ``R_vec``, ``a_hat``,
  ``b_hat``, ``g_hat``, ``Gamma_hat``, ``blind_fin`` and final
  transcript state.
* ``DotProductProofLog.prove``, with its bullet rounds on the host (the
  default on the CPU) and on the device, against the JAX package's
  ``DotProductProofLog.prove`` on its host path with the inputs of
  ``tests/test_device_prover.py``'s dot-product-log test (n = 16, tape
  seed 31): equal bytes and ``post`` challenge, and the proof verifies.

The JAX package's side of both is recorded in
``tests/golden/port/bullet-*.npz`` (``record.py``).
"""

import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch import serialize as ser
from spartan_tpu_torch.commitments import MultiCommitGens
from spartan_tpu_torch.core import edwards as hed
from spartan_tpu_torch.core import ristretto as hri
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import RandomTape, Transcript
from spartan_tpu_torch.ff import fq, limb
from spartan_tpu_torch.ff.bullet_kernel import bullet_step
from spartan_tpu_torch.protocols import bullet
from spartan_tpu_torch.protocols.dotproduct_log import DotProductProofLog
from spartan_tpu_torch.protocols.sigma import DotProductProofGens

R = 1 << 256


def _mont(xs):
    return limb.ints_to_limbs([x * R % Q for x in xs])


def _ints(t, mont=True):
    vals = limb.limbs_to_ints(t)
    return [v * pow(R, -1, Q) % Q for v in vals] if mont else vals


def _wide(b: bytes) -> int:
    return int.from_bytes(b, "little") % Q


@pytest.mark.parametrize("mode", ["cross", "fold_words", "fold_bytes",
                                  "head", "tail"])
def test_bullet_step_plain_equals_python_ints(mode):
    rng = random.Random(7)
    m = 5
    a, b = ([rng.randrange(Q) for _ in range(2 * m)] for _ in range(2))
    a[0], b[1] = Q - 1, 0
    bl = [rng.randrange(Q) for _ in range(2)]
    chal = bytes(rng.randrange(256) for _ in range(64))
    if mode == "cross":
        rows = bullet_step("cross", _mont(a), _mont(b), _mont(bl))
        cl = sum(x * y for x, y in zip(a[:m], b[m:])) % Q
        cr = sum(x * y for x, y in zip(a[m:], b[:m])) % Q
        assert _ints(rows, mont=False) == (a[:m] + [cl, bl[0]]
                                           + a[m:] + [cr, bl[1]])
    elif mode.startswith("fold"):
        u = rng.randrange(1, Q) if mode == "fold_words" else _wide(chal)
        u_arg = (_mont([u])[0] if mode == "fold_words"
                 else torch.tensor(list(chal), dtype=torch.uint8))
        bf0 = rng.randrange(Q)
        bf = _mont([bf0])[0].clone()
        a2, b2, gsc = bullet_step("fold", _mont(a), _mont(b), u_arg,
                                  _mont(bl), bf)
        ui = pow(u, -1, Q)
        assert _ints(a2) == [(u * x + ui * y) % Q
                             for x, y in zip(a[:m], a[m:])]
        assert _ints(b2) == [(ui * x + u * y) % Q
                             for x, y in zip(b[:m], b[m:])]
        assert _ints(gsc, mont=False) == [ui, u] * m
        assert _ints(bf[None]) == [(bf0 + bl[0] * u * u + bl[1] * ui * ui)
                                   % Q]
    elif mode == "head":
        bx, by = rng.randrange(Q), rng.randrange(Q)
        out = bullet_step("head", torch.tensor(list(chal), dtype=torch.uint8),
                          _mont([bx])[0], _mont([by])[0])
        r = _wide(chal)
        assert _ints(out[:1], mont=False) == [r]
        assert _ints(out[1:]) == [(bx + r * by) % Q]
    else:
        xh, ah, bfin, d, rd, rb = (rng.randrange(Q) for _ in range(6))
        out = bullet_step("tail", torch.tensor(list(chal), dtype=torch.uint8),
                          _mont([xh])[0], _mont([ah])[0], _mont([bfin])[0],
                          _mont([d, rd, rb]))
        c = _wide(chal)
        assert _ints(out) == [(d + c * xh * ah) % Q,
                              (ah * (c * bfin + rb) + rd) % Q]


def test_bullet_step_checks_arguments():
    a = _mont([1, 2, 3, 4])
    with pytest.raises(ValueError):
        bullet_step("cross", a[:3], a[:3], a[:2])  # odd size
    with pytest.raises(ValueError):
        bullet_step("fold", a, a, a[0][:4], a[:2], a[0].clone())
    with pytest.raises(ValueError):
        bullet_step("nope", a)


def _rounds_inputs(n):
    """a, b, the blinds, Q and the gens' label of a bullet reduction of
    n entries (``record.py`` reads them too)."""
    rng = np.random.default_rng(n)
    a_i = [int(v) for v in rng.integers(0, 1 << 62, size=n)]
    b_i = [int(v) for v in rng.integers(0, 1 << 62, size=n)]
    lg_n = n.bit_length() - 1
    blinds = [(int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 62)))
              for _ in range(lg_n)]
    return a_i, b_i, blinds, hed.BASEPOINT.mul(987654321), b"bullet test gens"


def _blobs(a):
    return [r.tobytes() for r in a]


@pytest.mark.parametrize("n", [8, 16])
def test_device_rounds_equal_jax_host_path(n, monkeypatch):
    monkeypatch.setitem(bullet.DEVICE_MIN, "cpu", 1)
    a_i, b_i, blinds, q_pt, label = _rounds_inputs(n)
    jax_proof = load(f"bullet-rounds-{n}")

    t = Transcript(b"bullet")
    (proof, gamma, a_hat, b_hat, g_hat, bf) = bullet.BulletReductionProof.prove(
        t, q_pt, MultiCommitGens(n, label), fq.encode_ints(a_i),
        fq.encode_ints(b_i), 4242, blinds)
    assert (proof.L_vec, proof.R_vec) == (_blobs(jax_proof["L_vec"]),
                                          _blobs(jax_proof["R_vec"]))
    assert [a_hat, b_hat, bf] == to_ints(jax_proof["scalars"])
    assert hri.encode(g_hat) == jax_proof["g_hat"].tobytes()
    assert hri.encode(gamma) == jax_proof["gamma"].tobytes()
    assert t.challenge_scalar(b"post") == to_ints(jax_proof["post"])
    assert len(proof.L_vec) == len(blinds)


def _dplog_inputs():
    """n, x, a and y = <x, a> of the dot-product-log (``record.py``
    reads them too)."""
    n = 16
    rng = np.random.default_rng(21)
    x_ints = [int(v) for v in rng.integers(1, 1 << 60, size=n)]
    a_ints = [int(v) for v in rng.integers(1, 1 << 60, size=n)]
    return n, x_ints, a_ints, sum(a * b for a, b in zip(x_ints, a_ints)) % Q


@pytest.mark.parametrize("device_rounds", [False, True],
                         ids=["default_device_min", "device_min_1"])
def test_dotproduct_log_equals_jax_host_path(device_rounds, monkeypatch):
    if device_rounds:
        monkeypatch.setitem(bullet.DEVICE_MIN, "cpu", 1)
    n, x_ints, a_ints, y = _dplog_inputs()
    jax_proof = load("bullet-dplog")

    gens = DotProductProofGens(n, b"dplog test")
    t = Transcript(b"dplog")
    proof, cx, cy = DotProductProofLog.prove(
        gens, t, RandomTape(b"tape", seed=31), fq.encode_ints(x_ints), 555,
        fq.encode_ints(a_ints), a_ints, y, 777)
    assert (cx, cy) == (jax_proof["cx"].tobytes(), jax_proof["cy"].tobytes())
    w = ser.Writer()
    ser._w_dotproduct_log(w, proof)
    assert w.getvalue() == jax_proof["proof"].tobytes()
    assert t.challenge_scalar(b"post") == to_ints(jax_proof["post"])
    proof.verify(n, gens, Transcript(b"dplog"), a_ints, cx, cy)
