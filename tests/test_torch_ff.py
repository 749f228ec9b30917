"""The port's field layer (``spartan_tpu_torch.ff``) against the JAX
package's python-int field (``spartan_tpu.core.field``) and its limb
layout.

Values include the edge cases 0, 1, q-1, p-1, p and the lazy 2^256 - 1;
everything is exact integer arithmetic, so every comparison is equality.
"""

import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.core.field import P25519 as P
from spartan_tpu.core.field import Q
from spartan_tpu.ff import fq as jfq
from spartan_tpu.ff import limb as jlimb
from spartan_tpu_torch import interop
from spartan_tpu_torch.ff import fp25519 as fp
from spartan_tpu_torch.ff import fq, limb

R = 1 << 256
M = R - 1
R_INV = pow(R, -1, Q)


def _scalars(seed, n=200):
    rng = random.Random(seed)
    return [0, 1, Q - 1, 2, Q - 2] + [rng.randrange(Q) for _ in range(n)]


def test_limb_pack_roundtrip():
    rng = random.Random(1)
    xs = [0, 1, M, P, Q] + [rng.randrange(R) for _ in range(100)]
    t = limb.ints_to_limbs(xs)
    assert t.dtype == torch.int32 and t.shape == (len(xs), 8)
    assert limb.limbs_to_ints(t) == xs
    assert limb.limbs_to_ints(limb.pack(limb.unpack(t))) == xs
    assert limb.to_int16(limb.unpack(t)) == xs


def test_interop_reinterprets_jax_limbs():
    """The JAX package's (n, 16) 16-bit limbs and the port's (n, 8)
    int32 words are the same bytes."""
    xs = _scalars(2, 50) + [M]
    j = jlimb.ints_to_limbs(xs)  # numpy (n, 16) uint32
    t = interop.fq_from_jax(j)
    assert limb.limbs_to_ints(t) == xs
    np.testing.assert_array_equal(interop.fq_to_jax(t), j)
    # a Montgomery table made by the JAX package's host encoder
    m = interop.fq_from_jax(jfq.encode_ints_mont(xs[:-1]))
    assert fq.decode_to_ints(m) == [x % Q for x in xs[:-1]]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_fq_binary_ops(op):
    xs, ys = _scalars(3), list(reversed(_scalars(4)))
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y}[op]
    got = fq.decode_to_ints(getattr(fq, op)(a, b))
    assert got == [ref(x, y) % Q for x, y in zip(xs, ys)]


def test_fq_mont_maps():
    xs = _scalars(5)
    c = limb.ints_to_limbs(xs)
    assert limb.limbs_to_ints(fq.to_mont(c)) == [x * R % Q for x in xs]
    assert limb.limbs_to_ints(fq.from_mont(fq.to_mont(c))) == xs
    assert limb.limbs_to_ints(fq.from_mont(c)) == [x * R_INV % Q for x in xs]


def test_fq_sums_and_reduce_wide():
    xs, ys = _scalars(6), _scalars(7)
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    assert fq.decode_to_ints(fq.sum_mod(a)[None]) == [sum(xs) % Q]
    assert fq.decode_to_ints(fq.dot_mod(a, b)[None]) == [
        sum(x * y for x, y in zip(xs, ys)) % Q]
    rng = random.Random(8)
    w = [0, (1 << 512) - 1, Q, Q * Q] + [rng.randrange(1 << 512)
                                          for _ in range(60)]
    got = limb.limbs_to_ints(fq.reduce_wide(limb.from_int16(w, n=32)))
    assert got == [x % Q for x in w]


@pytest.mark.parametrize("op", ["mul", "add", "sub", "to_mont",
                                "from_mont", "dot0", "dot1"])
def test_fq_in_pieces(monkeypatch, op):
    """With pieces of 7 elements, the storage-layout operations and the
    dot product along either axis (broadcast, as bound_L and Spark's
    batched evaluation call it) still equal python ints."""
    monkeypatch.setattr(fq, "CHUNK", 7)
    xs, ys = _scalars(11, n=35), _scalars(12, n=35)  # 40 each
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    if op in ("dot0", "dot1"):
        M_ = a.reshape(5, 8, 8)  # M_[i][j] = xs[8 i + j]
        if op == "dot0":  # sum_i ys[i] M_[i, j], ys[i] broadcast over j
            got = fq.dot_mod(M_, b[:5, None, :], dim=0)
            want = [sum(ys[i] * xs[8 * i + j] for i in range(5)) % Q
                    for j in range(8)]
        else:  # sum_j M_[i, j] ys[j], ys broadcast over i
            got = fq.dot_mod(M_, b[:8], dim=1)
            want = [sum(xs[8 * i + j] * ys[j] for j in range(8)) % Q
                    for i in range(5)]
        assert fq.decode_to_ints(got) == want
        return
    if op in ("to_mont", "from_mont"):
        c = limb.ints_to_limbs(xs)
        got = limb.limbs_to_ints(getattr(fq, op)(c))
        f = R if op == "to_mont" else R_INV
        assert got == [x * f % Q for x in xs]
        return
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y}[op]
    assert fq.decode_to_ints(getattr(fq, op)(a, b)) == [
        ref(x, y) % Q for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", ["mul16", "add16", "sub16"])
def test_fp_lazy_ops(op):
    """Lazy mod-p ops keep every limb below 2^16 + 64 and the residue
    exact, for loose inputs up to 2^256 - 1 and chained twice."""
    rng = random.Random(9)
    ps = [0, 1, P - 1, P, M, 19, 38] + [rng.randrange(R) for _ in range(150)]
    qs = [M, M, P - 1, P - 1, M, 0, M] + [rng.randrange(R) for _ in range(150)]
    ref = {"mul16": lambda x, y: x * y, "add16": lambda x, y: x + y,
           "sub16": lambda x, y: x - y}[op]
    f = getattr(fp, op)
    out = f(limb.from_int16(ps), limb.from_int16(qs))
    assert int(out.min()) >= 0 and int(out.max()) < (1 << 16) + 64
    assert [v % P for v in limb.to_int16(out)] == [
        ref(x, y) % P for x, y in zip(ps, qs)]
    out2 = f(out, out)
    assert int(out2.max()) < (1 << 16) + 64
    firsts = [ref(x, y) for x, y in zip(ps, qs)]
    assert limb.to_int16(fp.canonical16(out2)) == [
        ref(v, v) % P for v in firsts]


def test_fp_storage_ops_canonical():
    rng = random.Random(10)
    xs = [0, 1, P - 1] + [rng.randrange(P) for _ in range(50)]
    ys = [P - 1, 0, P - 1] + [rng.randrange(P) for _ in range(50)]
    a, b = fp.encode_ints(xs), fp.encode_ints(ys)
    assert fp.decode_to_ints(fp.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert fp.decode_to_ints(fp.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert fp.decode_to_ints(fp.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    lazy = limb.ints_to_limbs([M, P, P + 5, 2 * P + 37])
    assert fp.decode_to_ints(fp.reduce_canonical(lazy)) == [
        M % P, 0, 5, 37 % P]
